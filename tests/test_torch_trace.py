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
from rtw_tpu.models import scene as JS
from rtw_tpu.models.builder import SceneBuilder as JSceneBuilder
from rtw_tpu.ops import intersect as JI
from rtw_tpu.ops.shading import gather_shade as j_gather_shade
from rtw_tpu.ops.vec import Vec3 as JV
import rtw_tpu_torch as rtt
from chip_smoke import TWIN_CROSS, TWIN_INSIDE, tie_rays, tie_scene
from rtw_tpu_torch.models import scene as TS
from rtw_tpu_torch.models.builder import SceneBuilder as TSceneBuilder
from rtw_tpu_torch.ops import intersect as TI
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.ops.vec import Vec3 as TV
from rtw_tpu_torch.utils import kernels

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
    counts = kernels.launches
    before = (counts["rtw_trace"], counts["rtw_occluded"])
    got = getattr(TK, query)(*args)
    plain = (TK.trace_plain if query == "trace" else TK.occluded_plain)(*args)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(plain)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (counts["rtw_trace"], counts["rtw_occluded"]) == before


def test_kernel_launch_refuses_cpu_tensors_and_volumes():
    """The launch path refuses CPU tensors; the tables carry what the
    kernels need for volumes: the per-prim volume slot."""
    ts = rtt.build_scene(1, 16, 16, device="cpu")
    o = TV(*torch.zeros(3, 8))
    vol_u = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        TK._launch("rtw_trace", ts, o, o, 1e-6, 1e27, 0.0, vol_u, None)
    tables = TK.split_tables(ts)
    assert tuple(tables.props.shape) == (640, 25)
    assert tuple(tables.plan.shape) == (2, TK.PLAN_COLS)
    assert tuple(tables.aabbs.shape) == (10, 8)
    assert not (tables.vol_slot >= 0).any()
    vol = TK.split_tables(rtt.build_scene(4, 16, 16, device="cpu"))
    assert vol.vol_slot.dtype == torch.int32
    assert vol.vol_slot.tolist() == [
        -1] * 1040 + [1, 0] + [-1] * (vol.props.shape[0] - 1042)


# ---- ties, and the CUDA kernel's warp-shared sweep emulated in torch ----

def test_tie_scene_lays_the_twins_across_and_inside_a_block():
    ts = tie_scene(TSceneBuilder, TS)
    start, count, size, ptype, axis, xform, block = ts.chunk_plan[0]
    assert (ptype, count, block) == (0, 128, 64)
    p = ts.prims.params.numpy()
    for (c, r), rows in ((TWIN_CROSS, [63, 64]), (TWIN_INSIDE, [65, 66])):
        at = np.nonzero((p[:, :3] == np.float32(c)).all(1)
                        & (p[:, 3] == np.float32(r)))[0]
        assert (at - start).tolist() == rows
    assert ts.prims.material_id[start + 63] != ts.prims.material_id[
        start + 64]


def test_trace_plain_matches_reference_on_ties():
    """Every lane's winner, payload and shading record on the tie scene
    equal the reference's: the lowest row of equal t wins, across and
    inside a block, and for coincident rects and boxes."""
    js = tie_scene(JSceneBuilder, JS)
    ts = tie_scene(TSceneBuilder, TS)
    o, d, tmax = tie_rays(N)
    time = np.zeros(N, np.float32)
    vol_u = np.full((1, N), 0.5, np.float32)

    def ref(o_, d_, tm, t_, v_):
        h = JI.intersect_scene(js, o_, d_, 1e-6, tm, t_, v_)
        return h, j_gather_shade(js, h.prim_idx, h.prim_idx >= 0)

    want, wshade = jax.jit(ref)(_jv(o), _jv(d), jnp.asarray(tmax),
                                jnp.asarray(time), jnp.asarray(vol_u))
    got, gshade = TK.trace_plain(ts, _tv(o), _tv(d), 1e-6,
                                 torch.as_tensor(tmax),
                                 torch.as_tensor(time),
                                 torch.as_tensor(vol_u))
    prim = got.prim_idx.numpy()
    np.testing.assert_array_equal(prim, np.asarray(want.prim_idx))
    start = ts.chunk_plan[0][0]
    for row in (63, 65):           # the twins' lower rows win every tie
        assert (prim == start + row).sum() > 50
        assert not (prim == start + row + 1).any()
    hit = prim >= 0
    np.testing.assert_array_equal(got.mat_id.numpy(), np.asarray(want.mat_id))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=2e-4)
    for g, w in ((got.point, want.point), (got.normal, want.normal),
                 ((got.u, got.v), (want.u, want.v))):
        np.testing.assert_allclose(_np(g)[:, hit], _np(w)[:, hit],
                                   rtol=1e-4, atol=1e-4)
    for f in SHADE_I32:
        np.testing.assert_array_equal(getattr(gshade, f).numpy(),
                                      np.asarray(getattr(wshade, f)), f)
    for f in (*SHADE_F32, "rgb", "odd", "even"):
        np.testing.assert_allclose(_np(getattr(gshade, f)),
                                   _np(getattr(wshade, f)), atol=1e-6)


def _warp_sweep(t_mat, b0):
    """The CUDA kernel's shared sweep of one block for every lane's ray:
    row r goes to warp lane r % 32, which keeps its first row of least t
    (strict `<` from BIG); the butterfly (xor 16, 8, 4, 2, 1) reduces (t,
    row) to the lexicographic minimum.  Returns (t, row) [N] each, after
    checking that all 32 lanes end with the same pair."""
    rows, n = t_mat.shape
    lt = torch.full((32, n), TI.BIG)
    lr = torch.full((32, n), 2 ** 31 - 1, dtype=torch.int64)
    for r in range(rows):
        k = r % 32
        take = t_mat[r] < lt[k]
        lt[k] = torch.where(take, t_mat[r], lt[k])
        lr[k] = torch.where(take, b0 + r, lr[k])
    for off in (16, 8, 4, 2, 1):
        other = torch.arange(32) ^ off
        t2, r2 = lt[other], lr[other]
        take = (t2 < lt) | ((t2 == lt) & (r2 < lr))
        lt, lr = torch.where(take, t2, lt), torch.where(take, r2, lr)
    assert bool((lt == lt[0]).all()) and bool((lr == lr[0]).all())
    return lt[0], lr[0]


def _warp_shared_trace(scene, tables, o, d, tmin, tmax, time, vol_u):
    """(best t, winning row) [N] of each ray under the CUDA kernel's
    schedule: each ray's walk (csrc/geometry.cuh::WalkCursor: the blocks of
    each group in order, a node tested where it begins, a node or block
    culled by box_active against the ray's best t so far) and, for every
    block it reaches, `_warp_sweep`; the owner takes the block's pair when
    its t beats the best."""
    n = o.x.shape[0]
    tmax = torch.as_tensor(tmax, dtype=torch.float32).expand(n)
    best_t = torch.full((n,), TI.BIG)
    best_row = torch.full((n,), -1, dtype=torch.int64)
    inv = [1.0 / torch.where(c == 0.0, 1e-30, c) for c in d]
    prims = scene.prims

    def active(row):
        ab = tables.aabbs[row]
        near = torch.full((n,), -TI.BIG)
        far = torch.full((n,), TI.BIG)
        for ax in range(3):
            t0 = (ab[ax] - o[ax]) * inv[ax]
            t1 = (ab[3 + ax] - o[ax]) * inv[ax]
            near = torch.maximum(near, torch.minimum(t0, t1))
            far = torch.minimum(far, torch.maximum(t0, t1))
        return ((far >= torch.clamp_min(near, tmin)) & (near < tmax)
                & (near < best_t))

    for entry, hr in zip(scene.chunk_plan, tables.layout):
        start, count, size, ptype, axis, xform, block = entry
        levels, first, n_blocks = hr[:3]
        inside = [torch.ones(n, dtype=torch.bool)] * (levels + 2)
        for b in range(n_blocks):
            for lv in range(levels, 0, -1):
                if b % TK.WALK_FAN ** lv == 0:
                    inside[lv] = inside[lv + 1] & active(
                        hr[TK.H_LEVEL0 + lv] + b // TK.WALK_FAN ** lv)
            reach = inside[1] & active(first + b)
            if not bool(reach.any()):
                continue
            b0 = start + b * block
            rows = min(block, start + count - b0)
            sl = slice(b0, b0 + rows)
            t_mat = TI._block_t(ptype, axis, xform, prims.params[sl],
                                prims.w2o[sl], prims.vol_slot[sl], o, d,
                                tmin, tmax, time, vol_u,
                                torch.ones(rows, dtype=torch.bool))
            t, row = _warp_sweep(t_mat, b0)
            take = reach & (t < best_t)
            best_t = torch.where(take, t, best_t)
            best_row = torch.where(take, row, best_row)
    return best_t, best_row


def _assert_warp_shared_equals_plain(scene, o, d, tmax, time, vol_u):
    tables = TK.split_tables(scene)
    args = (_tv(o), _tv(d), 1e-6, torch.as_tensor(tmax),
            torch.as_tensor(time), torch.as_tensor(vol_u))
    t, row = _warp_shared_trace(scene, tables, *args)
    hit, _ = TK.trace_plain(scene, *args)
    assert torch.equal(row, hit.prim_idx)
    assert torch.equal(t, hit.t)
    assert 0.1 < float((row >= 0).float().mean()) < 1.0


@pytest.mark.parametrize("sid", [0, 1, 2, 5, 3, 4, "ties"])
def test_warp_shared_sweep_gives_the_plain_winner(sid):
    """The kernel's schedule, emulated, picks trace_plain's winner and t on
    every lane of scenes 0-5 and the tie scene."""
    if sid == "ties":
        scene = tie_scene(TSceneBuilder, TS)
        o, d, tmax = tie_rays(N, 5)
        n_vol = 1
    else:
        scene = rtt.build_scene(sid, 64, 48, device="cpu")
        o, d, _, _ = _rays(sid)
        n_vol = scene.n_vol
        tmax = np.where(np.arange(N) % 8 == 7, -1e30, 1e27).astype(
            np.float32)
    rng = np.random.default_rng(17)
    time = rng.uniform(0.0, 1.0, N).astype(np.float32)
    vol_u = rng.uniform(size=(max(n_vol, 1), N)).astype(np.float32)
    _assert_warp_shared_equals_plain(scene, o, d, tmax, time, vol_u)


def test_warp_shared_sweep_gives_the_plain_winner_on_the_walked_field(
        monkeypatch):
    """The same on tests/test_torch_scale.py's 2500-sphere field, walked
    with the threshold at 32 blocks: two full nodes and a ragged one."""
    from rtw_tpu_torch.models.registry import build_stress_scene

    monkeypatch.setattr(TK, "TWO_LEVEL_MIN", 32)
    scene = build_stress_scene(2500, device="cpu")
    assert [r[TK.H_LEVELS] for r in TK.split_tables(scene).layout] == [1]
    rng = np.random.default_rng(19)
    o = (rng.uniform(-1, 1, (3, N)) * 250.0).astype(np.float32)
    d = rng.normal(size=(3, N)).astype(np.float32)
    tmax = np.where(np.arange(N) % 8 == 7, -1e30, 1e27).astype(np.float32)
    _assert_warp_shared_equals_plain(scene, o, d, tmax,
                                     np.zeros(N, np.float32),
                                     np.full((1, N), 0.5, np.float32))


# ---- the any-hit kernel's warp-shared schedule, emulated in torch ----

def _occl_own_sweep_min():
    """occluded_kernel's threshold, read from its source."""
    import re
    from pathlib import Path

    src = (Path(TK.__file__).parent.parent / "csrc" / "trace_kernel.cu")
    return int(re.search(r"kOcclOwnSweepMin = (\d+);",
                         src.read_text()).group(1))


def _warp_any_hit(scene, tables, o, d, tmin, tmax, time, vol_u, own_min):
    """(occluded [N], branch counts) under the CUDA kernel's schedule
    (csrc/geometry.cuh::warp_any_hit), one 32-lane warp per 32 rays: each
    step every lane's WalkCursor tests its next candidate (the nodes that
    begin there, highest level first, then the block; bound BIG, so no cull
    by earlier hits); the warp ballots the lanes whose block passed; with
    `own_min` of them or more each sweeps its own block to its first hit,
    else the warp sweeps each pending lane's block in lane order, lane k
    testing rows b0 + k + 32 m on the owner's ray in round m, the ballot of
    a round's hits ending the block; an occluded lane is done.  Lanes past
    N and dead lanes (tmax <= tmin) are done from the start and stay in
    every ballot."""
    n = o.x.shape[0]
    n_pad = -(-n // 32) * 32
    tmax = torch.as_tensor(tmax, dtype=torch.float32).expand(n)
    o, d = ([torch.nn.functional.pad(c, (0, n_pad - n)) for c in v]
            for v in (o, d))
    tmax_p = torch.nn.functional.pad(tmax, (0, n_pad - n), value=-TI.BIG)
    inv = [1.0 / torch.where(c == 0.0, 1e-30, c) for c in d]
    plan = scene.chunk_plan
    n_entries = len(plan)
    hier = torch.tensor([list(r) for r in tables.layout])
    rounds = -(-max(e[6] for e in plan) // 32)
    # hits[g, k, i]: row k of the g-th block (all groups in plan order) hit
    # by ray i, on ray i's own shutter time and volume uniforms; rows past
    # a group's count are padding and never hit
    hits, first_g = [], []
    for entry in plan:
        start, count, size, ptype, axis, xform, blk = entry
        first_g.append(len(hits))
        for b0 in range(start, start + size, blk):
            rows = max(0, min(blk, start + count - b0))
            sl = slice(b0, b0 + rows)
            t = TI._block_t(ptype, axis, xform, scene.prims.params[sl],
                            scene.prims.w2o[sl], scene.prims.vol_slot[sl],
                            TV(*(c[:n] for c in o)), TV(*(c[:n] for c in d)),
                            tmin, tmax, time, vol_u,
                            torch.ones(rows, dtype=torch.bool))
            h = torch.zeros(32 * rounds, n_pad, dtype=torch.bool)
            h[:rows, :n] = t < TI.BIG
            hits.append(h)
    hits = torch.stack(hits)
    first_g = torch.tensor(first_g)
    rows_of = torch.tensor([max(0, min(e[6], e[0] + e[1] - b0))
                            for e in plan
                            for b0 in range(e[0], e[0] + e[2], e[6])])

    def box_active(row):                      # per lane, bound BIG
        ab = tables.aabbs[row]                # [n_pad, 8]
        near = torch.full((n_pad,), -TI.BIG)
        far = torch.full((n_pad,), TI.BIG)
        for ax in range(3):
            t0 = (ab[:, ax] - o[ax]) * inv[ax]
            t1 = (ab[:, 3 + ax] - o[ax]) * inv[ax]
            near = torch.maximum(near, torch.minimum(t0, t1))
            far = torch.minimum(far, torch.maximum(t0, t1))
        return ((far >= torch.clamp_min(near, tmin)) & (near < tmax_p)
                & (near < TI.BIG))

    lane_ids = torch.arange(n_pad)
    e = torch.where((lane_ids < n) & (tmax_p > tmin), 0, n_entries)
    b = torch.zeros(n_pad, dtype=torch.int64)
    occ = torch.zeros(n_pad, dtype=torch.bool)
    counts = {"steps": 0, "own": 0, "shared": 0, "rounds": 0}
    while True:
        # ---- WalkCursor::step of every lane
        while True:                           # past exhausted groups
            ec = e.clamp(max=n_entries - 1)
            past = (e < n_entries) & (b >= hier[ec, TK.H_BLOCKS])
            if not bool(past.any()):
                break
            e, b = torch.where(past, e + 1, e), torch.where(past, 0, b)
        walking = e < n_entries
        ec = e.clamp(max=n_entries - 1)
        levels = hier[ec, TK.H_LEVELS]
        skip = torch.zeros(n_pad, dtype=torch.int64)
        for lv in range(int(hier[:, TK.H_LEVELS].max()), 0, -1):
            span = TK.WALK_FAN ** lv
            here = walking & (levels >= lv) & (b % span == 0) & (skip == 0)
            row = hier[ec, TK.H_LEVEL0 + lv].clamp(min=0) + b // span
            row = torch.where(here, row, 0)
            skip = torch.where(here & ~box_active(row), span, skip)
        passed = box_active(torch.where(walking, hier[ec, TK.H_FIRST] + b, 0))
        blk = torch.where(walking & (skip == 0) & passed, b, -1)
        blk = torch.where(walking, blk, -2)
        b = torch.where(walking, b + torch.where(skip > 0, skip, 1), b)
        if not bool((blk != -2).any()):
            break
        counts["steps"] += 1
        g = first_g[ec] + blk.clamp(min=0)    # the lane's block, if pending
        # ---- the ballot and the sweeps, warp by warp
        pend = (blk >= 0).view(-1, 32)
        own = pend.sum(1, keepdim=True) >= own_min
        mine = (own & pend).view(-1)
        counts["own"] += int(mine.sum())
        occ |= mine & hits[g, :, lane_ids].any(1)
        shared = ~own & pend                  # [warps, 32]
        for j in range(32):                   # lowest pending lane first
            wj = torch.nonzero(shared[:, j])[:, 0]
            if wj.numel() == 0:
                continue
            counts["shared"] += wj.numel()
            owner = wj * 32 + j
            go = g[owner]
            hit = torch.zeros(wj.numel(), dtype=torch.bool)
            for m in range(rounds):           # 32-row rounds
                k = torch.arange(32) + 32 * m
                live = ~hit & (32 * m < rows_of[go])
                counts["rounds"] += int(live.sum())
                mine_k = (hits[go[:, None], k[None, :], owner[:, None]]
                          & (k[None, :] < rows_of[go][:, None]))
                hit |= live & mine_k.any(1)   # the round's ballot
            occ[owner] |= hit
        e = torch.where(occ, n_entries, e)    # answered: done
    return occ[:n], counts


def _shadow_inputs(sid):
    """(scene, o, d, tmax, time, vol_u) of N shadow queries: on a scene
    with a light, from _rays' origins toward random points of the light
    (unit direction, tmax 0.999 of the distance); else random directions
    with random finite tmax; every 8th lane dead (tmax -1e30).  "ties": the
    tie scene's rays with random finite tmax."""
    rng = np.random.default_rng(23)
    if sid == "ties":
        scene = tie_scene(TSceneBuilder, TS)
        o, d, tmax = tie_rays(N, 5)
        tmax = np.where(tmax < 0, tmax, rng.uniform(0.0, 300.0, N))
        n_vol = 1
    else:
        scene = rtt.build_scene(sid, 64, 48, device="cpu")
        o, d, _, _ = _rays(sid)
        n_vol = scene.n_vol
        if scene.num_lights:
            lt = scene.lights
            a, c = rng.uniform(size=(2, N, 1))
            target = (lt.position[0].numpy() + a * lt.vec_u[0].numpy()
                      + c * lt.vec_v[0].numpy()).T
            ray = target - o
            dist = np.linalg.norm(ray, axis=0)
            d = ray / dist
            tmax = 0.999 * dist
        else:
            tmax = rng.uniform(0.0, 2.0 * RAYS[sid][0], N)
    tmax = np.where(np.arange(N) % 8 == 7, -1e30, tmax)
    time = rng.uniform(0.0, 1.0, N).astype(np.float32)
    vol_u = rng.uniform(size=(max(n_vol, 1), N)).astype(np.float32)
    return (scene, np.ascontiguousarray(o, np.float32),
            np.ascontiguousarray(d, np.float32), tmax.astype(np.float32),
            time, vol_u)


def _assert_warp_any_hit_equals_plain(scene, o, d, tmax, time, vol_u):
    tables = TK.split_tables(scene)
    args = (_tv(o), _tv(d), 1e-4, torch.as_tensor(tmax),
            torch.as_tensor(time), torch.as_tensor(vol_u))
    want = TK.occluded_plain(scene, *args)
    for own_min in (1, 33, _occl_own_sweep_min()):
        got, counts = _warp_any_hit(scene, tables, *args, own_min)
        assert torch.equal(got, want), own_min
    assert 0.02 < float(want.float().mean()) < 0.98
    assert not bool(want[7::8].any())         # dead lanes: never occluded
    return counts


@pytest.mark.parametrize("sid", [0, 1, 2, 5, 3, 4, "ties"])
def test_warp_shared_any_hit_gives_the_plain_answer(sid):
    """The any-hit kernel's schedule, emulated, equals occluded_plain on
    every lane of scenes 0-5 (shadow rays toward the light where there is
    one) and the tie scene, at the kernel's threshold, with every block
    swept alone (1) and with every block shared (33)."""
    counts = _assert_warp_any_hit_equals_plain(*_shadow_inputs(sid))
    assert counts["shared"] > 0


def test_warp_shared_any_hit_gives_the_plain_answer_on_the_walked_field(
        monkeypatch):
    """The same on the walked 2500-sphere field (threshold 32 blocks: two
    full nodes and a ragged one), where the kernel's threshold sends some
    steps to each lane's own sweep."""
    from rtw_tpu_torch.models.registry import build_stress_scene

    monkeypatch.setattr(TK, "TWO_LEVEL_MIN", 32)
    scene = build_stress_scene(2500, device="cpu")
    assert [r[TK.H_LEVELS] for r in TK.split_tables(scene).layout] == [1]
    rng = np.random.default_rng(29)
    o = (rng.uniform(-1, 1, (3, N)) * 250.0).astype(np.float32)
    d = rng.normal(size=(3, N)).astype(np.float32)
    tmax = np.where(np.arange(N) % 8 == 7, -1e30,
                    rng.uniform(0.0, 700.0, N)).astype(np.float32)
    counts = _assert_warp_any_hit_equals_plain(
        scene, o, d, tmax, np.zeros(N, np.float32),
        np.full((1, N), 0.5, np.float32))
    assert counts["shared"] > 0 and counts["own"] > 0
