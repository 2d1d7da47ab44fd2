"""The megakernel's plain twin and the port's schedulers against rtw_tpu.

`mega_step_plain` is held against the reference's Pallas megakernel run
in interpret mode (as tests/test_mega.py runs it), step by step from the
same carry, in its regenerating and its hybrid mode; the port's
`trace_wavefront_mega` against the reference's `trace_wavefront_regen`,
and its `trace_wavefront_qmega` against the reference's
`trace_wavefront_queue`.  The CUDA kernel itself is held against the plain
twin on the card by chip_smoke.py (phases 3, 4, 12 and 13)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import rtw_tpu as rt
from rtw_tpu.integrator import trace_wavefront_queue as j_queue
from rtw_tpu.integrator import trace_wavefront_regen as j_regen
from rtw_tpu.ops import mega_kernel as JMK
from rtw_tpu.utils import rng as JR
import rtw_tpu_torch as rtt
from chip_smoke import furnace_cavity
from rtw_tpu_torch import integrator as TI
from rtw_tpu_torch.ops import mega_kernel as TMK

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

NX, NY = 48, 24           # tests/test_mega.py's configuration
TOL = 2e-4


def _cfg(sid, **kw):
    return rtt.RenderConfig(nx=NX, ny=NY, spp=3, max_depth=6, scene_id=sid,
                            seed=9, **kw)


def _assert_carry_close(got, want, extent, msg):
    """f32 carry rows: every row of >= 99.9% of the lanes within atol/rtol
    2e-4, and every value within 2e-4 of the scene's extent.  XLA's CPU
    code contracts a + b*c into one FMA where torch rounds twice; a 1-ulp
    difference in a camera direction then moves a grazing hit point by up
    to ~1e-5 of the ray length (measured: 0.0073 in one of 34816 values,
    a ceiling hit at z = 15 on Cornell)."""
    close = np.abs(got - want) <= TOL + TOL * np.abs(want)
    assert close.all(axis=0).mean() >= 0.999, msg
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * extent,
                               err_msg=msg)


@pytest.mark.parametrize("sid", [0, 3])
def test_mega_step_plain_matches_pallas_kernel(sid):
    """Scenes 0 and 3 (volumes: the free-flight rows after the fixed
    slots), 1152 lanes padded to 2048 as the reference pads them, four
    successive steps, each started from the reference's carry."""
    _check_steps(_cfg(sid), 4)


def test_mega_step_plain_without_bsdf_weight_matches_pallas_kernel():
    """Cornell with mis_bsdf_weight=False (the kernel's one-sided MIS):
    two steps, the second with light hits of BSDF-sampled rays."""
    _check_steps(_cfg(0, mis_bsdf_weight=False), 2)


def _check_steps(cfg, steps):
    """`steps` successive plain steps against the reference kernel in
    interpret mode, each from the reference's carry."""
    sid = cfg.scene_id
    jcfg = rt.RenderConfig(**dataclasses.asdict(cfg))
    js = rt.build_scene(sid, NX, NY)
    ts = rtt.build_scene(sid, NX, NY, device="cpu")
    n, n_pad = cfg.num_pixels, 2 * JMK.TILE
    s_end = cfg.spp

    sf = jnp.zeros((JMK.NF, n_pad), jnp.float32).at[JMK.F_PPDF].set(1.0)
    si = jnp.zeros((JMK.NI, n_pad), jnp.int32)
    si = si.at[JMK.I_PIXEL, :n].set(jnp.arange(n, dtype=jnp.int32))
    si = si.at[JMK.I_SAMPLE, n:].set(s_end)      # pad lanes never regenerate
    parf, pari = JMK.mega_params(js, JR.base_key(cfg.seed), jcfg)
    pari = pari.at[0, JMK.PI_SEND].set(s_end)
    params = TMK.mega_params(ts, cfg.seed, cfg, s_end)
    np.testing.assert_array_equal(params.parf, np.asarray(parf)[0])
    extent = float(ts.block_aabbs[:, :6].abs().max())
    launches = TMK.launches

    with pltpu.force_tpu_interpret_mode():
        step = jax.jit(lambda a, b: JMK.mega_step(js, jcfg, a, b, parf,
                                                  pari))
        for it in range(steps):
            j_sf, j_si, j_rays = step(sf, si)
            rays = torch.zeros(1, dtype=torch.int64)
            t_sf, t_si = TMK.mega_step(ts, cfg, torch.tensor(np.asarray(sf)),
                                       torch.tensor(np.asarray(si)), params,
                                       rays)
            np.testing.assert_array_equal(t_si.numpy(), np.asarray(j_si),
                                          err_msg=f"step {it}")
            _assert_carry_close(t_sf.numpy(), np.asarray(j_sf), extent,
                                f"step {it}")
            assert int(rays) == int(np.asarray(j_rays).sum())
            sf, si = j_sf, j_si
    assert TMK.launches == launches   # CPU tensors never reach the kernel


def test_mega_step_plain_hybrid_matches_pallas_kernel():
    """The hybrid mode (TPU kernel D) on scene 0: 2048 lanes of camera rays
    (every lane real), four successive steps against the reference's
    `mega_step(..., hybrid=True)` in interpret mode, each from the
    reference's carry; lanes that finish stay dead with their depth."""
    from rtw_tpu.integrator import generate_camera_rays as j_camera

    sid = 0
    cfg = _cfg(sid)
    jcfg = rt.RenderConfig(**dataclasses.asdict(cfg))
    js = rt.build_scene(sid, NX, NY)
    ts = rtt.build_scene(sid, NX, NY, device="cpu")
    n = 2 * JMK.TILE
    key = JR.base_key(cfg.seed)
    pix = jnp.arange(n, dtype=jnp.int32) % cfg.num_pixels
    smp = jnp.arange(n, dtype=jnp.int32) // cfg.num_pixels
    path = j_camera(js, jcfg, pix, JR.make_path_keys(key, pix, smp, "fast"))
    zero = jnp.zeros(n, jnp.float32)
    sf = jnp.stack([*path.origin, *path.direction, *path.throughput,
                    *path.radiance, zero, zero, zero, path.time,
                    path.prev_pdf])
    si = jnp.stack([jnp.ones(n, jnp.int32), jnp.zeros(n, jnp.int32),
                    jnp.zeros(n, jnp.int32), smp, pix])
    parf, pari = JMK.mega_params(js, key, jcfg)
    params = TMK.mega_params(ts, cfg.seed, cfg, cfg.spp)
    extent = float(ts.block_aabbs[:, :6].abs().max())

    with pltpu.force_tpu_interpret_mode():
        step = jax.jit(lambda a, b: JMK.mega_step(js, jcfg, a, b, parf, pari,
                                                  hybrid=True))
        for it in range(4):
            j_sf, j_si, j_rays = step(sf, si)
            rays = torch.zeros(1, dtype=torch.int64)
            t_sf, t_si = TMK.mega_step(ts, cfg, torch.tensor(np.asarray(sf)),
                                       torch.tensor(np.asarray(si)), params,
                                       rays, hybrid=True)
            np.testing.assert_array_equal(t_si.numpy(), np.asarray(j_si),
                                          err_msg=f"step {it}")
            _assert_carry_close(t_sf.numpy(), np.asarray(j_sf), extent,
                                f"step {it}")
            assert int(rays) == int(np.asarray(j_rays).sum())
            sf, si = j_sf, j_si
    alive = np.asarray(si)[JMK.I_ALIVE] > 0
    assert 0.0 < alive.mean() < 1.0     # some paths ended, some run on


@pytest.mark.parametrize("sid", [0, 1])
def test_trace_wavefront_qmega_matches_reference_queue(sid):
    """The port's qmega scheduler (plain hybrid steps + the queue's flush)
    against the reference's jnp work queue at 2048 lanes, a multiple of
    the reference kernel's tile, where the two flush rules agree (the
    reference's counts its padded lanes): the same samples, so equal ray
    counts and every value within 1e-4."""
    nx, ny = 64, 32
    cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=3, max_depth=6, scene_id=sid,
                           seed=5)
    jcfg = rt.RenderConfig(**dataclasses.asdict(cfg))
    js = rt.build_scene(sid, nx, ny)
    ts = rtt.build_scene(sid, nx, ny, device="cpu")
    pix = np.arange(cfg.num_pixels, dtype=np.int32)
    ref, ref_rays, _ = jax.jit(lambda: j_queue(
        js, jcfg, jnp.asarray(pix), JR.base_key(cfg.seed), 0, cfg.spp))()
    launches = TMK.hybrid_launches
    got, rays, _ = TI.trace_wavefront_qmega(ts, cfg, torch.as_tensor(pix),
                                            cfg.seed, 0, cfg.spp)
    assert TMK.hybrid_launches == launches  # the CPU runs the plain twin
    a = np.stack([np.asarray(c) for c in ref])
    b = np.stack([c.numpy() for c in got])
    assert np.isfinite(b).all()
    assert int(rays) == pytest.approx(float(ref_rays), rel=1e-6)
    np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sid", [0, 3, 5])
def test_trace_wavefront_mega_matches_reference_regen(sid):
    cfg = _cfg(sid)
    jcfg = rt.RenderConfig(**dataclasses.asdict(cfg))
    js = rt.build_scene(sid, NX, NY)
    ts = rtt.build_scene(sid, NX, NY, device="cpu")
    pix = np.arange(cfg.num_pixels, dtype=np.int32)
    ref, ref_rays, _ = jax.jit(lambda: j_regen(
        js, jcfg, jnp.asarray(pix), JR.base_key(cfg.seed), 0, cfg.spp))()
    got, rays, _ = TI.trace_wavefront_mega(ts, cfg, torch.as_tensor(pix),
                                           cfg.seed, 0, cfg.spp)
    a = np.stack([np.asarray(c) for c in ref])
    b = np.stack([c.numpy() for c in got])
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=TOL, rtol=TOL)
    assert int(rays) == pytest.approx(float(ref_rays), rel=1e-6)


# The options outside the megakernel's envelope: it draws only the fast
# hash, computes only NEE + MIS and counts nothing (the reference's gate).
OUTSIDE_THE_KERNEL = [("rng", "threefry"), ("rng", "tea"),
                      ("estimator", "book"), ("bounce_stats", True)]


@pytest.mark.parametrize("field,value", [*OUTSIDE_THE_KERNEL,
                                         ("differentiable", True)])
def test_gate_refuses_unported_options(field, value):
    """A forced megakernel (backend="mega", scheduler "mega" or "qmega",
    `mega_params`) refuses each option with ValueError naming it, as
    the reference's `_validate_mega` does, and "auto" renders it on the
    plain path; `differentiable` (ported: gradients) stays outside the
    kernel's envelope, as in the reference."""
    ts = rtt.build_scene(0, 8, 8, device="cpu")
    cfg = dataclasses.replace(rtt.RenderConfig(nx=8, ny=8, spp=1), **{
        field: value})
    forced = [dataclasses.replace(cfg, backend="mega"),
              dataclasses.replace(cfg, scheduler="mega"),
              dataclasses.replace(cfg, scheduler="qmega")]
    for c in forced:
        with pytest.raises(ValueError, match=field):
            rtt.render(ts, c)
    with pytest.raises(ValueError, match=field):
        TMK.mega_params(ts, 0, cfg, 1)
    img = rtt.render(ts, cfg)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())


def test_gate_selection_on_cpu():
    ts = rtt.build_scene(0, 8, 8, device="cpu")
    cfg = rtt.RenderConfig(nx=8, ny=8, spp=1)
    assert not TI._mega_backend(cfg, ts)          # CPU auto: plain regen
    assert TI._mega_backend(dataclasses.replace(cfg, backend="mega"), ts)
    assert not TI._mega_backend(dataclasses.replace(cfg, backend="jnp"), ts)
    with pytest.raises(ValueError, match="scheduler"):
        TI.trace_wavefront(ts, dataclasses.replace(
            cfg, backend="mega", scheduler="queue"),
            torch.arange(64), 0, 0, 1)
    with pytest.raises(ValueError, match="noise/image"):
        TI._mega_backend(dataclasses.replace(cfg, backend="mega"),
                         rtt.build_scene(2, 8, 8, device="cpu"))
    for sid in (2, 4):        # qmega keeps the megakernel's envelope
        with pytest.raises(ValueError, match="noise/image"):
            rtt.render(rtt.build_scene(sid, 8, 8, device="cpu"),
                       dataclasses.replace(cfg, scheduler="qmega"))


def test_mega_step_checks_its_inputs():
    ts = rtt.build_scene(0, 8, 8, device="cpu")
    cfg = rtt.RenderConfig(nx=8, ny=8, spp=1)
    params = TMK.mega_params(ts, 0, cfg, 1)
    assert params.c_params.kdim == 49 and params.c_params.n_props == 40
    assert params.c_params.n_entries == 5
    sf, si = TMK.init_carry(torch.arange(64, dtype=torch.int32), 0)
    rays = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(TypeError):
        TMK._check_tensors(sf, si.to(torch.int64), params, rays)
    with pytest.raises(ValueError):
        TMK._check_tensors(sf[:, :10], si, params, rays)
    with pytest.raises(ValueError):
        TMK._check_tensors(sf.t().contiguous().t(), si, params, rays)
    with pytest.raises(ValueError):
        TMK.mega_step(ts, cfg, sf.to("meta"), si, params, rays)



def _small_marble():
    """A scene of 2 prims with a Perlin-marble texture: below the split
    tier, outside the megakernel's envelope."""
    from rtw_tpu_torch.models.builder import SceneBuilder

    b = SceneBuilder()
    b.sphere((0.0, 0.0, 0.0), 1.0, b.lambertian(b.noise_texture(4.0)))
    b.sphere((0.0, -101.0, 0.0), 100.0,
             b.lambertian(b.constant_texture((0.5, 0.5, 0.5))))
    b.set_camera((0, 0, 4.0), (0, 0, 0), (0, 1, 0), 40, 1.0, 0.0, 1.0)
    return b.build()


@pytest.fixture
def on_cuda(monkeypatch):
    """Every Scene reports its device as cuda (the dispatcher's view of a
    scene on the card); no tensor moves."""
    from rtw_tpu_torch.models import scene as TS

    monkeypatch.setattr(TS.Scene, "device",
                        property(lambda self: torch.device("cuda")))


GATE_SCENES = {"cornell": lambda: rtt.build_scene(0, 8, 8, device="cpu"),
               "cavity": furnace_cavity,
               "scene2": lambda: rtt.build_scene(2, 8, 8, device="cpu"),
               "marble": _small_marble}


@pytest.mark.parametrize("name,auto", [("cornell", True), ("cavity", False),
                                       ("scene2", False), ("marble", False)])
def test_auto_gate_follows_the_reference_on_the_card(name, auto, on_cuda):
    """tests/test_mega.py's gating on a CUDA scene: "auto" takes the
    megakernel inside its envelope and nowhere else (more lights,
    noise or image textures, 128 prims or more), as the reference's
    predicate does on its TPU; outside it, a scene below the split tier
    runs the regen sweep and one at or above it the queue."""
    scene = GATE_SCENES[name]()
    assert scene.device.type == "cuda"
    cfg = rtt.RenderConfig(nx=8, ny=8, spp=1)
    assert TI._mega_backend(cfg, scene) is auto
    assert TI._split_backend(cfg, scene) is (name == "scene2")
    for off in ("jnp", "pallas"):
        assert not TI._mega_backend(dataclasses.replace(cfg, backend=off),
                                    scene)


@pytest.mark.parametrize("name,match", [("cavity", "num_lights=6"),
                                        ("scene2", "noise/image"),
                                        ("marble", "noise/image")])
def test_forced_mega_still_refuses_outside_the_envelope(name, match,
                                                        on_cuda):
    scene = GATE_SCENES[name]()
    cfg = rtt.RenderConfig(nx=8, ny=8, spp=1)
    with pytest.raises(ValueError, match=match):
        TI._mega_backend(dataclasses.replace(cfg, backend="mega"), scene)
    for sched in ("mega", "qmega"):
        with pytest.raises(ValueError, match=match):
            TI.trace_wavefront(scene, dataclasses.replace(
                cfg, scheduler=sched), torch.arange(64), 0, 0, 1)


@pytest.mark.parametrize("name", ["cornell", "cavity", "marble"])
def test_auto_gate_still_raises_on_unported_options(name, on_cuda):
    """On a CUDA scene below the split tier "auto" keeps every option
    outside the kernel's envelope off the megakernel (the regen sweep),
    and forced mega and qmega raise ValueError naming it; since gradients
    are ported, `differentiable` is one of them, and nothing raises
    NotImplementedError."""
    scene = GATE_SCENES[name]()
    base = rtt.RenderConfig(nx=8, ny=8, spp=1)
    for field, value in [*OUTSIDE_THE_KERNEL, ("differentiable", True)]:
        cfg = dataclasses.replace(base, **{field: value})
        assert not TI._mega_backend(cfg, scene)
        assert not TI._split_backend(cfg, scene)
        with pytest.raises(ValueError, match=field):
            TI._mega_backend(dataclasses.replace(cfg, backend="mega"), scene)
        for sched in ("mega", "qmega"):
            with pytest.raises(ValueError, match=field):
                TI.trace_wavefront(scene, dataclasses.replace(
                    cfg, scheduler=sched), torch.arange(64), 0, 0, 1)


def test_warp_shared_walk_gives_the_hybrid_step_winner(monkeypatch):
    """D's nearest hit on the card is the trace kernel's warp-shared walk
    (csrc/geometry.cuh::warp_nearest_hit).  Its schedule, emulated
    (tests/test_torch_trace.py::_warp_shared_trace), picks the plain hybrid
    step's winner and t on every live lane of scene 1's carry after three
    qmega iterations (plain hybrid steps and the queue's flush), on the
    rays, tmax and uniforms that step traces; dead lanes miss."""
    from test_torch_trace import _warp_shared_trace
    from rtw_tpu_torch.ops import trace_kernel as TK

    class _Traced(Exception):
        pass

    calls = []

    def record(*args):
        hit = intersect(*args)
        calls.append((args, hit))
        if len(calls) == 4:
            raise _Traced
        return hit

    intersect = TMK.intersect_scene
    monkeypatch.setattr(TMK, "intersect_scene", record)
    cfg = rtt.RenderConfig(nx=64, ny=32, spp=3, max_depth=6, scene_id=1,
                           seed=5)
    ts = rtt.build_scene(1, cfg.nx, cfg.ny, device="cpu")
    assert TK.split_tables(ts).n_blocks > TMK.STRAIGHT_MAX_BLOCKS  # walked
    with pytest.raises(_Traced):
        TI.trace_wavefront_qmega(ts, cfg, torch.arange(cfg.num_pixels),
                                 cfg.seed, 0, cfg.spp)
    (scene, o, d, tmin, tmax, time, vol_u), want = calls[-1]
    live = tmax > tmin
    assert 0.2 < float(live.float().mean()) < 1.0
    assert not bool((want.prim_idx[~live] >= 0).any())
    t, row = _warp_shared_trace(
        scene, TK.split_tables(scene), type(o)(*(c[live] for c in o)),
        type(d)(*(c[live] for c in d)), tmin, tmax[live], time[live],
        vol_u[:, live])
    assert torch.equal(row, want.prim_idx[live])
    assert torch.equal(t, want.t[live])
