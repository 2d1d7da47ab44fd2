"""The split tier's trace and occlusion queries of the port against
rtw_tpu's jnp sweep on the same random rays (the recipe of
tests/test_trace_kernel.py), with a random shutter time per ray so scene
1's moving spheres move, and random free-flight uniforms per ray and
volume slot so scenes 3 and 4's volumes sample.

`trace_plain` and `occluded_plain` are what the CUDA kernels of
csrc/trace_kernel.cu are held against on the card (chip_smoke.py); here
they are held against `intersect_scene` + `gather_shade` and `occluded`.
Tolerances: winners, shading records and occlusion equal (shade floats
to 1e-6); t within rtol 2e-4; point, normal and uv within atol/rtol
1e-4.  The port's plain sphere test fuses its multiply-adds as the
reference's compiled CPU code does (intersect.fma) and takes correctly
rounded square roots (vec.sqrt); measured here, t agrees to 2.2e-5
relative, the rest to 5.2e-4 of a Cornell-sized coordinate.  On scenes 3
and 4 the reference's approximate CPU log (ROADMAP "Faults found") moves
a free-flight distance by an ulp on ~14% of volume tests; winners and
occlusion are held equal on >= 99.9% of lanes (measured: 100%) and the
other fields on the lanes whose winner agrees."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu.ops import intersect as JI
from rtw_tpu.ops.shading import gather_shade as j_gather_shade
from rtw_tpu.ops.vec import Vec3 as JV
import rtw_tpu_torch as rtt
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.ops.vec import Vec3 as TV

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

N = 4096
# per scene: (origin spread, origin centre) of the random rays
RAYS = {0: (277.0, (277.5, 277.5, 277.5)), 1: (13.0, (0.0, 1.0, 0.0)),
        2: (13.0, (0.0, 1.0, 0.0)), 5: (4.0, (0.0, 1.0, 1.0)),
        3: (277.0, (277.5, 277.5, 277.5)), 4: (350.0, (250.0, 280.0, 280.0))}
# share of lanes whose winner or occlusion must equal the reference's
EQUAL_SHARE = {0: 1.0, 1: 1.0, 2: 1.0, 5: 1.0, 3: 0.999, 4: 0.999}
SHADE_F32 = ("fuzz", "eta", "scale")
SHADE_I32 = ("mat_type", "tex_type", "image_id")


def _rays(sid, n_vol=1):
    rng = np.random.default_rng(7 + sid)
    scale, shift = RAYS[sid]
    o = (rng.uniform(-1, 1, (N, 3)) * scale + shift).astype(np.float32).T
    d = rng.normal(size=(N, 3)).astype(np.float32).T
    time = rng.uniform(0.0, 1.0, N).astype(np.float32)
    vol_u = rng.uniform(size=(max(n_vol, 1), N)).astype(np.float32)
    return np.ascontiguousarray(o), np.ascontiguousarray(d), time, vol_u


def _jv(a):
    return JV(*(jnp.asarray(c) for c in a))


def _tv(a):
    return TV(*(torch.as_tensor(c) for c in a))


def _np(v):
    return np.stack([np.asarray(c) for c in v])


@pytest.mark.parametrize("sid", [0, 1, 2, 5, 3, 4])
def test_trace_plain_matches_reference(sid):
    js, ts = rt.build_scene(sid, 64, 48), rtt.build_scene(sid, 64, 48,
                                                         device="cpu")
    o, d, time, vol_u = _rays(sid, js.n_vol)

    def ref(o_, d_, t_, v_):
        h = JI.intersect_scene(js, o_, d_, 1e-6, 1e27, t_, v_)
        return h, j_gather_shade(js, h.prim_idx, h.prim_idx >= 0)

    want, wshade = jax.jit(ref)(_jv(o), _jv(d), jnp.asarray(time),
                                jnp.asarray(vol_u))
    got, gshade = TK.trace_plain(ts, _tv(o), _tv(d), 1e-6, 1e27,
                                 torch.as_tensor(time),
                                 torch.as_tensor(vol_u))

    prim = got.prim_idx.numpy()
    same = prim == np.asarray(want.prim_idx)
    assert same.mean() >= EQUAL_SHARE[sid]
    hit = (prim >= 0) & same
    assert 0.2 < hit.mean() <= 1.0
    np.testing.assert_array_equal(got.mat_id.numpy()[same],
                                  np.asarray(want.mat_id)[same])
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=2e-4)
    for g, w in ((got.point, want.point), (got.normal, want.normal),
                 ((got.u, got.v), (want.u, want.v))):
        np.testing.assert_allclose(_np(g)[:, hit], _np(w)[:, hit],
                                   rtol=1e-4, atol=1e-4)
    for f in SHADE_I32:
        np.testing.assert_array_equal(getattr(gshade, f).numpy()[same],
                                      np.asarray(getattr(wshade, f))[same],
                                      f)
    for f in SHADE_F32:
        np.testing.assert_allclose(getattr(gshade, f).numpy()[same],
                                   np.asarray(getattr(wshade, f))[same],
                                   atol=1e-6)
    for f in ("rgb", "odd", "even"):
        np.testing.assert_allclose(_np(getattr(gshade, f))[:, same],
                                   _np(getattr(wshade, f))[:, same],
                                   atol=1e-6)


@pytest.mark.parametrize("sid", [0, 1, 2, 5, 3, 4])
def test_occluded_plain_matches_reference(sid):
    tmax = np.where(np.arange(N) % 5 == 0, -1e30, 1e4).astype(np.float32)
    js, ts = rt.build_scene(sid, 64, 48), rtt.build_scene(sid, 64, 48,
                                                         device="cpu")
    o, d, time, vol_u = _rays(sid, js.n_vol)
    want = jax.jit(lambda o_, d_, tm, t_, v_: JI.occluded(
        js, o_, d_, 1e-4, tm, t_, v_))(_jv(o), _jv(d), jnp.asarray(tmax),
                                       jnp.asarray(time), jnp.asarray(vol_u))
    got = TK.occluded_plain(ts, _tv(o), _tv(d), 1e-4, torch.as_tensor(tmax),
                            torch.as_tensor(time), torch.as_tensor(vol_u))
    want = np.asarray(want)
    assert (got.numpy() == want).mean() >= EQUAL_SHARE[sid]
    assert 0.1 < want.mean() < 0.9
    assert not want[::5].any()          # tmax = -1e30: never occluded
    assert not got.numpy()[::5].any()


@pytest.mark.parametrize("query", ["trace", "occluded_kernel"])
def test_wrappers_run_the_plain_version_on_cpu(query):
    """On CPU tensors each wrapper is its plain version, and no kernel
    launch is counted."""
    sid = 3
    o, d, time, vol_u = _rays(sid, 2)
    ts = rtt.build_scene(sid, 64, 48, device="cpu")
    args = (ts, _tv(o), _tv(d), 1e-4, 1e4, torch.as_tensor(time),
            torch.as_tensor(vol_u))
    before = (TK.trace_launches, TK.occluded_launches)
    got = getattr(TK, query)(*args)
    plain = (TK.trace_plain if query == "trace" else TK.occluded_plain)(*args)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(plain)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (TK.trace_launches, TK.occluded_launches) == before


def test_kernel_launch_refuses_cpu_tensors_and_volumes():
    """The launch path refuses CPU tensors; the tables carry what the
    kernels need for volumes: the per-prim volume slot."""
    ts = rtt.build_scene(1, 16, 16, device="cpu")
    o = TV(*torch.zeros(3, 8))
    vol_u = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        TK._launch_inputs(ts, o, o, 1e-6, 1e27, 0.0, vol_u, None)
    tables = TK.split_tables(ts)
    assert tuple(tables.props.shape) == (640, 25)
    assert tuple(tables.plan.shape) == (2, TK.PLAN_COLS)
    assert tuple(tables.aabbs.shape) == (10, 8)
    assert not (tables.vol_slot >= 0).any()
    vol = TK.split_tables(rtt.build_scene(4, 16, 16, device="cpu"))
    assert vol.vol_slot.dtype == torch.int32
    assert vol.vol_slot.tolist() == [
        -1] * 1040 + [1, 0] + [-1] * (vol.props.shape[0] - 1042)
