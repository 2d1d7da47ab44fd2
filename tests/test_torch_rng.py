"""The port's fast RNG against rtw_tpu.utils.rng: draws must be bit-equal,
so a port render traces the same samples as a reference render."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rtw_tpu.utils import rng as JR
from rtw_tpu_torch.utils import rng as TR

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

N = 4096


def _u32(rng, n=N):
    return rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def test_pcg_hash_bit_equal():
    x = _u32(np.random.default_rng(1))
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(JR.pcg_hash(jnp.asarray(x)))
    got = TR.pcg_hash(_t(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 9, 12345, 2 ** 32 - 1])
def test_pixel_sample_hash_bit_equal(seed):
    rng = np.random.default_rng(seed % 1000)
    pix = rng.integers(0, 800 * 800, N).astype(np.int32)
    smp = rng.integers(0, 1000, N).astype(np.int32)
    want = np.asarray(JR.pixel_sample_hash(JR.base_key(seed),
                                           jnp.asarray(pix),
                                           jnp.asarray(smp)))
    got = TR.pixel_sample_hash(seed, _t(pix), _t(smp)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # a scalar sample index keys the same stream
    want0 = np.asarray(JR.pixel_sample_hash(JR.base_key(seed),
                                            jnp.asarray(pix), 7))
    got0 = TR.pixel_sample_hash(seed, _t(pix), 7).numpy()
    np.testing.assert_array_equal(got0, want0.astype(np.int64))


@pytest.mark.parametrize("n_slots", [8, 10])
def test_bounce_uniforms_bit_equal(n_slots):
    rng = np.random.default_rng(n_slots)
    keys = _u32(rng)
    bounce = rng.integers(0, 21, N).astype(np.int32)
    want = np.asarray(JR.bounce_uniforms(jnp.asarray(keys),
                                         jnp.asarray(bounce), n_slots))
    got = TR.bounce_uniforms(_t(keys), _t(bounce), n_slots).numpy()
    assert got.dtype == np.float32 and got.shape == (n_slots, N)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # scalar bounce
    want1 = np.asarray(JR.bounce_uniforms(jnp.asarray(keys), 3, n_slots))
    got1 = TR.bounce_uniforms(_t(keys), 3, n_slots).numpy()
    np.testing.assert_array_equal(got1.view(np.uint32),
                                  want1.view(np.uint32))


def test_camera_uniforms_bit_equal():
    keys = _u32(np.random.default_rng(3))
    want = np.asarray(JR.camera_uniforms(jnp.asarray(keys)))
    got = TR.camera_uniforms(_t(keys)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_path_hash_base_matches_key_data():
    for seed in (0, 1, 9, 2 ** 31, 2 ** 32 - 1):
        kd = np.asarray(jax.random.key_data(jax.random.key(seed)))
        assert kd.tolist() == [seed >> 32, seed & 0xFFFFFFFF]
        want = int(JR.pcg_hash(jnp.uint32(kd[0])
                               + JR.pcg_hash(jnp.uint32(kd[-1]))))
        assert TR.path_hash_base(seed) == want


@pytest.mark.parametrize("seed", [0x314759, 0x6314759, 1])
def test_xorshift32_sequences_equal(seed):
    a, b = JR.XorShift32(seed), TR.XorShift32(seed)
    assert [a.randf() for _ in range(2000)] == [b.randf() for _ in range(2000)]
    assert int(a.state) == int(b.state)


@pytest.mark.parametrize("impl", ["tea", "threefry"])
def test_other_rngs_raise(impl):
    keys = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        TR.bounce_uniforms(keys, 1, 8, impl)
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        TR.make_path_keys(0, keys, 0, impl)
