"""The port's plain scene intersection against rtw_tpu.ops.intersect on the
same random rays: winners and occlusion equal, t / point / normal within
rtol 1e-5, atol 1e-4 (the two libraries' float32 sqrt and division may
differ in the last bit)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu.ops import intersect as JI
from rtw_tpu.ops.vec import Vec3 as JV
import rtw_tpu_torch as rtt
from rtw_tpu_torch.ops import intersect as TI
from rtw_tpu_torch.ops.vec import Vec3 as TV

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

N = 4096
# per scene: (origin box lo, hi) inside which rays start
BOUNDS = {0: (0.0, 555.0), 5: (-2.0, 2.0)}


def _rays(sid):
    rng = np.random.default_rng(100 + sid)
    lo, hi = BOUNDS[sid]
    o = rng.uniform(lo, hi, (3, N)).astype(np.float32)
    d = rng.normal(size=(3, N)).astype(np.float32)
    d *= rng.uniform(0.5, 2.0, N).astype(np.float32)     # non-unit, like
    tmax = np.where(rng.uniform(size=N) < 0.25,          # camera rays
                    rng.uniform(1.0, 300.0, N), 1e27).astype(np.float32)
    return o, d, tmax


def _jv(a):
    return JV(*(jnp.asarray(c) for c in a))


def _tv(a):
    return TV(*(torch.as_tensor(c) for c in a))


@pytest.mark.parametrize("sid", [0, 5])
def test_intersect_scene_matches_reference(sid):
    o, d, tmax = _rays(sid)
    js = rt.build_scene(sid, 64, 48)
    ts = rtt.build_scene(sid, 64, 48, device="cpu")
    zeros = jnp.zeros(N, jnp.float32)
    want = jax.jit(lambda o_, d_, tm: JI.intersect_scene(
        js, o_, d_, 1e-6, tm, zeros, zeros[None]))(_jv(o), _jv(d),
                                                   jnp.asarray(tmax))
    got = TI.intersect_scene(ts, _tv(o), _tv(d), 1e-6, torch.as_tensor(tmax))

    prim = got.prim_idx.numpy()
    np.testing.assert_array_equal(prim, np.asarray(want.prim_idx))
    hit = prim >= 0
    assert 0.2 < hit.mean() <= 1.0
    np.testing.assert_array_equal(got.mat_id.numpy(), np.asarray(want.mat_id))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-5, atol=1e-4)
    for g, w in ((got.point, want.point), (got.normal, want.normal)):
        np.testing.assert_allclose(np.stack([c.numpy() for c in g]),
                                   np.stack([np.asarray(c) for c in w]),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("sid", [0, 5])
def test_occluded_matches_reference(sid):
    o, d, tmax = _rays(sid)
    tmax = np.where(np.arange(N) % 3 == 0, -1e30, tmax).astype(np.float32)
    js = rt.build_scene(sid, 64, 48)
    ts = rtt.build_scene(sid, 64, 48, device="cpu")
    zeros = jnp.zeros(N, jnp.float32)
    want = jax.jit(lambda o_, d_, tm: JI.occluded(
        js, o_, d_, 5e-5, tm, zeros, zeros[None]))(_jv(o), _jv(d),
                                                   jnp.asarray(tmax))
    got = TI.occluded(ts, _tv(o), _tv(d), 5e-5, torch.as_tensor(tmax))
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.1 < want.mean() < 0.9


@pytest.mark.parametrize("sid,what", [(3, "volume"), (4, "volume")])
def test_unported_prim_types_raise(sid, what):
    ts = rtt.build_scene(sid, 16, 16, device="cpu")
    o = TV(*torch.zeros(3, 4))
    with pytest.raises(NotImplementedError, match=what):
        TI.intersect_scene(ts, o, o, 1e-6, 1e27, torch.zeros(4))
