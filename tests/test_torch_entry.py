"""The port's entry points (rtw_tpu_torch.entry) on the CPU: `entry()`'s
forward step against __graft_entry__.entry()'s on the same pixels, and
`dryrun_multichip(2)` over two gloo ranks."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as J
from rtw_tpu_torch import entry as T

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)


def test_entry_matches_reference():
    """Cornell 64x64, 1 spp, depth 6, sample 0 of every pixel: the port's
    radiance within 1e-4 of the reference's on every pixel."""
    fn, (pix,) = T.entry(device="cpu")
    got = fn(pix).numpy()
    jfn, jargs = J.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert got.shape == want.shape == (64 * 64, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.entry()


def test_dryrun_multichip_two_ranks():
    res = T.dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in res] == [0, 1]
    (a,), (b,) = (r["steps"] for r in res)
    assert a["shape"] == [8, 16, 3]
    assert a["loss"] == b["loss"] and np.isfinite(a["loss"])
