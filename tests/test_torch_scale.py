"""The scale tier of the port against rtw_tpu on the CPU: the stress field
of tools/stress_scale.py and the mixed plan of tests/test_trace_kernel.py,
the hierarchy table over a plan group's blocks (`augment_aabbs`) against the
reference's super rows, the plain sweeps against the reference's two-level
Pallas walk in interpret mode, `reachable_blocks` (the plain reading of the
table, which the CUDA walk of csrc/geometry.cuh::walk_blocks is held
against on the card by chip_smoke.py) against the plain sweep's hits, the
megakernel's plain twin on a two-level scene, and a render of the field.

The two-level thresholds are lowered on both sides (the reference's
`_TWO_LEVEL_MIN`, the port's `TWO_LEVEL_MIN`) so that a 2500-sphere field of
40 blocks is walked: two full nodes and a ragged one of 8."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import rtw_tpu as rt
from rtw_tpu.ops import mega_kernel as JMK
from rtw_tpu.ops import trace_kernel as JTK
from rtw_tpu.ops.vec import Vec3 as JV
from rtw_tpu.utils import rng as JR
import rtw_tpu_torch as rtt
import rtw_tpu_torch.models.scene as TS
from rtw_tpu_torch.models.builder import SceneBuilder
from rtw_tpu_torch.models.registry import build_stress_scene
from rtw_tpu_torch.ops import intersect as TI
from rtw_tpu_torch.ops import mega_kernel as TMK
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.ops.vec import Vec3 as TV
from tests.test_torch_mega import _assert_carry_close
from tests.test_torch_scene import _assert_same, _leaves
from tests.test_trace_kernel import _mixed_big_scene as j_mixed_big_scene
from tests.test_walker_fuzz import _fuzz_scene as j_fuzz_scene
from tools.stress_scale import build_stress_scene as j_build_stress_scene

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

FIELD = 2500
N = 1024                 # the reference kernels' tile


def _mixed_big_scene():
    """tests/test_trace_kernel.py::_mixed_big_scene with the port's
    builder: a walked sphere group beside flat box, rect and volume
    groups."""
    b = SceneBuilder()
    rng = np.random.default_rng(7)
    mat = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
    for _ in range(2500):
        b.sphere(rng.uniform(-200, 200, 3), rng.uniform(1.0, 5.0), mat)
    for _ in range(200):
        lo = rng.uniform(-200, 200, 3)
        b.box(lo, lo + rng.uniform(2.0, 10.0, 3), mat)
    for _ in range(4):
        a0, b0 = rng.uniform(-200, 180, 2)
        b.rect(a0, a0 + 20, b0, b0 + 20, rng.uniform(-200, 200), False,
               TS.AXIS_Y, mat)
    b.volume_sphere((0.0, 0.0, 100.0), 30.0, 0.05,
                    b.isotropic(b.constant_texture((1.0, 1.0, 1.0))))
    b.set_camera(lookfrom=(0, 0, -500), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov=40.0, aspect=1.0, aperture=0.0, focus_dist=10.0)
    return b.build()


def _fuzz_scene(seed: int):
    """tests/test_walker_fuzz.py::_fuzz_scene with the port's builder, from
    the same draws."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = b.lambertian(b.constant_texture((0.6, 0.6, 0.6)))
    metal = b.metal(b.constant_texture((0.9, 0.8, 0.6)), 0.1)
    n_sph = 64 * int(rng.integers(3, 9)) + int(rng.integers(-1, 2))
    for _ in range(n_sph):
        c = rng.uniform(-120, 120, 3)
        b.sphere(c, rng.uniform(1.0, 5.0), mat if rng.random() < 0.7
                 else metal)
    n_box = 64 * int(rng.integers(3, 7)) + int(rng.integers(-1, 2))
    for _ in range(n_box):
        lo = rng.uniform(-120, 120, 3)
        b.box(lo, lo + rng.uniform(2.0, 8.0, 3), mat)
    for _ in range(int(rng.integers(190, 260))):
        a0, b0 = rng.uniform(-120, 110, 2)
        b.rect(a0, a0 + rng.uniform(3, 12), b0, b0 + rng.uniform(3, 12),
               rng.uniform(-120, 120), False, int(rng.integers(0, 3)), mat)
    b.set_camera(lookfrom=(0, 0, -300), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov=40.0, aspect=1.0, aperture=0.0, focus_dist=10.0)
    return b.build()


SCENES = {
    "field": (lambda: build_stress_scene(FIELD, device="cpu"),
              lambda: j_build_stress_scene(FIELD)),
    "mixed": (_mixed_big_scene, j_mixed_big_scene),
}


def _rays(seed, scale=250.0):
    """tests/test_trace_kernel.py's random rays: origins within +-scale,
    normal directions, as [3, N] float32 planes."""
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-1, 1, (N, 3)) * scale).astype(np.float32).T
    d = rng.normal(size=(N, 3)).astype(np.float32).T
    return np.ascontiguousarray(o), np.ascontiguousarray(d)


def _tv(a):
    return TV(*(torch.as_tensor(c) for c in a))


def _jv(a):
    return JV(*(jnp.asarray(c) for c in a))


@pytest.mark.parametrize("name", ["field", "mixed", "fuzz11", "fuzz23",
                                  "fuzz47"])
def test_scale_scenes_equal_reference(name):
    """(a) Every array, the chunk plan and the block AABBs of the port's
    builds equal the JAX builder's."""
    if name.startswith("fuzz"):
        got, ref = _fuzz_scene(int(name[4:])), j_fuzz_scene(int(name[4:]))
    else:
        got, ref = (f() for f in SCENES[name])
    _assert_same(_leaves(got, lambda t: t.numpy()), _leaves(ref, np.asarray))
    for k in TS.STATIC_FIELDS:
        assert getattr(got, k) == getattr(ref, k), k


@pytest.mark.parametrize("name", ["field", "mixed"])
def test_level_one_equals_reference_supers(name, monkeypatch):
    """(b) With both thresholds at 32 the block rows and level 1 of the
    port's table are the reference's augmented table without its guard
    tail, bit for bit."""
    monkeypatch.setattr(JTK, "_TWO_LEVEL_MIN", 32)
    monkeypatch.setattr(TK, "TWO_LEVEL_MIN", 32)
    ts, js = (f() for f in SCENES[name])
    want = np.asarray(JTK.augment_aabbs(js))
    got, hier = TK.augment_aabbs(ts)
    assert got.shape[0] == want.shape[0] - JTK._GROUP
    np.testing.assert_array_equal(got.numpy(), want[:got.shape[0]])
    walked = [r for r in hier if r[TK.H_LEVELS]]
    assert [r[TK.H_LEVELS] for r in walked] == [1]      # the sphere group
    first = sum(e[2] // e[6] for e in ts.chunk_plan)
    assert walked[0][TK.H_LEVEL0 + 1] == first
    assert walked[0][TK.H_BLOCKS] == 40                  # 2 nodes and a half
    assert list(JTK._super_offsets(js.chunk_plan).values()) == [first]


def test_upper_nodes_are_the_union_of_their_children(monkeypatch):
    """(b) Three levels over the field built with 8 prims a block (313
    blocks -> 20 -> 2 nodes): each node is the min / max of its children,
    the ragged last node of the children there are; a group under the
    threshold stays flat."""
    monkeypatch.setattr(TK, "TWO_LEVEL_MIN", 32)
    ts = build_stress_scene(FIELD, device="cpu", chunk_size=8)
    tables = TK.split_tables(ts)
    (levels, first, count, r1, r2, *_), = tables.layout
    assert tables.hier.tolist() == tables.layout
    assert (levels, first, count, r1, r2) == (2, 0, 313, 313, 333)
    assert tables.aabbs.shape == (313 + 20 + 2, 8) and tables.n_blocks == 313
    ab = tables.aabbs.numpy()
    for lo, n_lo, hi, n_hi in ((0, 313, 313, 20), (313, 20, 333, 2)):
        for j in range(n_hi):
            kids = ab[lo + 16 * j:lo + min(16 * j + 16, n_lo)]
            np.testing.assert_array_equal(ab[hi + j, 0:3],
                                          kids[:, 0:3].min(axis=0))
            np.testing.assert_array_equal(ab[hi + j, 3:6],
                                          kids[:, 3:6].max(axis=0))
            assert not ab[hi + j, 6:].any()
    monkeypatch.setattr(TK, "TWO_LEVEL_MIN", 314)
    flat = TK.split_tables(ts)
    assert flat.aabbs.shape == (313, 8)
    assert flat.layout == [[0, 0, 313, 0, 0, 0, 0]]


@pytest.mark.parametrize("name,seed", [("field", 13), ("mixed", 21)])
def test_plain_sweeps_match_reference_two_level_walk(name, seed, monkeypatch):
    """(c) `trace_plain` / `occluded_plain` on 1024 random rays against the
    reference's Pallas kernels in interpret mode with their two-level walk
    compiled in: winners and occlusion equal on every lane, t within rtol
    2e-4 (tests/test_trace_kernel.py's tolerances)."""
    monkeypatch.setattr(JTK, "_TWO_LEVEL_MIN", 32)
    ts, js = (f() for f in SCENES[name])
    assert any(JTK._two_level(e) for e in js.chunk_plan)
    o, d = _rays(seed)
    tm = np.zeros(N, np.float32)
    vu = np.full((1, N), 0.5, np.float32)
    with pltpu.force_tpu_interpret_mode():
        h_k, _ = JTK.trace_pallas(js, _jv(o), _jv(d), 1e-6, 1e27,
                                  jnp.asarray(tm), jnp.asarray(vu))
        occ_k = JTK.occluded_pallas(js, _jv(o), _jv(d), 1e-4, 1e4,
                                    jnp.asarray(tm), jnp.asarray(vu))
    args = (torch.as_tensor(tm), torch.as_tensor(vu))
    hit, _ = TK.trace(ts, _tv(o), _tv(d), 1e-6, 1e27, *args)
    occ = TK.occluded_kernel(ts, _tv(o), _tv(d), 1e-4, 1e4, *args)
    prim = hit.prim_idx.numpy()
    np.testing.assert_array_equal(prim, np.asarray(h_k.prim_idx))
    assert (prim >= 0).sum() > 100
    np.testing.assert_allclose(hit.t.numpy()[prim >= 0],
                               np.asarray(h_k.t)[prim >= 0], rtol=2e-4)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_k))


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_reachable_blocks_hold_every_hit(seed, monkeypatch):
    """(d) On the fuzz plans of tests/test_walker_fuzz.py with the
    threshold at 4 (the sphere and box groups walked, beside flat rect
    groups), `reachable_blocks` holds the block
    of every winner and every block in which a ray hits anything: the cull
    never drops a hit."""
    monkeypatch.setattr(TK, "TWO_LEVEL_MIN", 4)
    ts = _fuzz_scene(seed)
    tables = TK.split_tables(ts)
    levels = [r[TK.H_LEVELS] for r in tables.layout]
    assert 1 in levels and 0 in levels
    o, d = _rays(seed + 1, 150.0)
    o, d = _tv(o), _tv(d)
    time = torch.zeros(N)
    vol_u = torch.full((1, N), 0.5)
    reach = TK.reachable_blocks(tables, o, d, 1e-6, 1e27)
    assert reach.shape == (tables.n_blocks, N)
    assert 0.0 < reach.float().mean() < 0.5          # it does cull
    hit, _ = TK.trace_plain(ts, o, d, 1e-6, 1e27, time, vol_u)
    won = hit.prim_idx >= 0
    assert won.sum() > 100
    blocks = TK.prim_blocks(ts)[hit.prim_idx.clamp_min(0)]
    assert bool(reach[blocks, torch.arange(N)][won].all())
    bid = 0
    for entry in ts.chunk_plan:
        for _, t_mat in TI._block_ts(ts, entry, o, d, 1e-6, 1e27, time,
                                     vol_u):
            any_hit = (t_mat < TI.BIG).any(dim=0)
            assert bool(reach[bid][any_hit].all()), (entry, bid)
            bid += 1
    assert bid == tables.n_blocks


def test_mega_step_plain_on_two_level_scene(monkeypatch):
    """(e) backend="mega" forced on the 2500-sphere field against the
    reference's megakernel in interpret mode with its two-level walk (the
    set-up of tests/test_mega.py): two successive steps, each from the
    reference's carry.  i32 rows and ray counts equal in both.

    Step 1 regenerates every lane, and the two cameras differ by an ulp in
    a direction (XLA contracts a + b*c, ROADMAP "Faults found").  On this
    field that ulp is worth ~1e-5 of t: the spheres are small (r 1-5) and
    300-700 units away, so the quadratic's b^2 - ac cancels four digits,
    and the normal (point - centre) / r carries the shift into the
    scattered direction.  Measured: 97.75% of lanes within atol/rtol 2e-4
    (hit points within 0.0075); held at >= 97%, every value within 2e-4 of
    the field's extent.  Step 2 starts from the same rays on both sides and
    is held to test_mega_step_plain_matches_pallas_kernel's tolerances
    (measured: every lane, max 1.8e-7)."""
    monkeypatch.setattr(JTK, "_TWO_LEVEL_MIN", 32)
    monkeypatch.setattr(TK, "TWO_LEVEL_MIN", 32)
    ts, js = (f() for f in SCENES["field"])
    assert any(JTK._two_level(e) for e in js.chunk_plan)
    cfg = rtt.RenderConfig(nx=32, ny=32, spp=1, max_depth=2, backend="mega")
    jcfg = rt.RenderConfig(**dataclasses.asdict(cfg))
    n = JMK.TILE
    sf = jnp.zeros((JMK.NF, n), jnp.float32).at[JMK.F_PPDF, :].set(1.0)
    si = jnp.zeros((JMK.NI, n), jnp.int32)
    si = si.at[JMK.I_PIXEL, :].set(jnp.arange(n, dtype=jnp.int32)
                                   % cfg.num_pixels)
    parf, pari = JMK.mega_params(js, JR.base_key(0), jcfg)
    pari = pari.at[0, JMK.PI_SEND].set(1)
    params = TMK.mega_params(ts, 0, cfg, 1)
    assert params.c_params.n_nodes == 3 and params.c_params.walk == 1
    assert params.c_params.tables_shared == 0      # 256 KB of props
    extent = float(ts.block_aabbs[:, :6].abs().max())
    for step in (1, 2):
        with pltpu.force_tpu_interpret_mode():
            j_sf, j_si, j_rays = JMK.mega_step(js, jcfg, sf, si, parf, pari)
        rays = torch.zeros(1, dtype=torch.int64)
        t_sf, t_si = TMK.mega_step(ts, cfg, torch.tensor(np.asarray(sf)),
                                   torch.tensor(np.asarray(si)), params,
                                   rays)
        np.testing.assert_array_equal(t_si.numpy(), np.asarray(j_si))
        assert int(rays) == int(np.asarray(j_rays).sum()) > 0
        got, want = t_sf.numpy(), np.asarray(j_sf)
        if step == 1:
            close = np.abs(got - want) <= 2e-4 + 2e-4 * np.abs(want)
            assert close.all(axis=0).mean() >= 0.97
            np.testing.assert_allclose(got, want, rtol=2e-4,
                                       atol=2e-4 * extent)
        else:
            _assert_carry_close(got, want, extent, "step 2")
        sf, si = j_sf, j_si


@pytest.mark.parametrize("scheduler", ["queue", "regen"])
def test_render_of_the_field_matches_reference(scheduler):
    """(f) The slice as a whole: the 2500-sphere field at 32x32, 2 spp,
    depth 4 through the port's plain queue and regen schedulers against
    `rtw_tpu.render` with backend="jnp": equal ray counts, >= 99.9% of
    pixels within 1e-4 and the rest within 1e-3.  Measured: 1023 of 1024
    pixels, the last off by 7.7e-4 in two channels: the reference's
    approximate CPU rsqrt moves a scattered direction by an ulp (ROADMAP
    "Faults found"), which this field's small distant spheres amplify as in
    test_mega_step_plain_on_two_level_scene."""
    ts, js = (f() for f in SCENES["field"])
    cfg = rtt.RenderConfig(nx=32, ny=32, spp=2, max_depth=4, backend="jnp",
                           scheduler=scheduler)
    m_ref, m_got = {}, {}
    want = np.asarray(rt.render(js, rt.RenderConfig(
        **dataclasses.asdict(cfg)), metrics=m_ref))
    got = rtt.render(ts, cfg, metrics=m_got).numpy()
    assert m_got["rays"] == m_ref["rays"]
    assert np.isfinite(got).all() and got.mean() > 0.1
    close = (np.abs(got - want) <= 1e-4 + 1e-4 * np.abs(want)).all(axis=-1)
    assert close.mean() >= 0.999
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_launch_checks_refuse_tables_that_do_not_fit_the_plan(monkeypatch):
    """(g) `check_tables`, which every launch runs on its inputs, raises on
    a table whose shape does not fit the plan; a plan that needs more
    levels than the kernel walks raises when the table is built."""
    monkeypatch.setattr(TK, "TWO_LEVEL_MIN", 32)
    ts = build_stress_scene(FIELD, device="cpu")
    tables = TK.split_tables(ts)
    TK.check_tables(ts, tables)
    for bad in (dataclasses.replace(tables, aabbs=tables.aabbs[:-1]),
                dataclasses.replace(tables, aabbs=tables.aabbs[:40]),
                dataclasses.replace(tables, hier=tables.hier[:, :-1]),
                dataclasses.replace(tables, props=tables.props[:-1]),
                dataclasses.replace(tables, vol_slot=tables.vol_slot[1:]),
                dataclasses.replace(tables, n_blocks=43)):
        with pytest.raises(ValueError):
            TK.check_tables(ts, bad)
    monkeypatch.setattr(TK, "TWO_LEVEL_MIN", 10 ** 9)
    TK.check_tables(ts, tables)      # a table carries its own level counts
    flat = [[0, 0, 40, 0, 0, 0, 0]]
    with pytest.raises(ValueError, match="aabbs"):
        TK.check_tables(ts, dataclasses.replace(tables, layout=flat))
    with pytest.raises(ValueError, match="hier rows"):
        TK.check_tables(ts, dataclasses.replace(
            tables, layout=[[1, 0, 40, 41, 0, 0, 0]]))
    big = dataclasses.replace(ts, chunk_plan=(
        (0, 2 ** 27, 2 ** 27, TS.PRIM_SPHERE, 0, False, 64),))
    monkeypatch.setattr(TK, "TWO_LEVEL_MIN", 128)
    with pytest.raises(ValueError, match="levels"):
        TK.hier_layout(big.chunk_plan)   # 2M blocks: five levels of 16
    o = TV(*torch.zeros(3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        TK._launch_inputs(ts, o, o, 1e-6, 1e27, 0.0, torch.zeros(1, 8),
                          tables)
