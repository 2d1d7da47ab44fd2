"""The rest of render()'s option surface against rtw_tpu on the CPU:
`rng="tea"` / `"threefry"`, `estimator="book"`, `mis_bsdf_weight=False`,
the reference's estimator scenes on the port's SceneBuilder, and the
wavefront counters of `bounce_stats` / `occupancy_trace`.

Renders go through both packages' `render` with the same config (the
reference on CPU JAX, its jnp sweep), on the regen and queue schedulers,
and are held at >= 99.9% of pixels within 1e-4 and equal rays; the
counters' metrics must be equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu import integrator as JI
from rtw_tpu.models import scene as JS
from rtw_tpu.models.builder import SceneBuilder as JB
from rtw_tpu.utils import rng as JR
import rtw_tpu_torch as rtt
from rtw_tpu_torch import integrator as TI
from rtw_tpu_torch.ops import intersect as TX
from rtw_tpu_torch.utils import rng as TR
from rtw_tpu_torch.models import scene as TS
from rtw_tpu_torch.models.builder import SceneBuilder as TB

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

NX = NY = 16

COUNTER_METRICS = ("rays_by_depth", "wavefront_iterations", "mean_occupancy",
                   "occupancy_by_iter")


def _both(js, ts, ray_slack=0, **kw):
    """Render (js, ts) with the same config through each package; returns
    (reference image, port image, reference metrics, port metrics) after
    the pixel and ray checks."""
    mj, mt = {}, {}
    want = np.asarray(rt.render(js, rt.RenderConfig(**kw), metrics=mj))
    got = rtt.render(ts, rtt.RenderConfig(**kw), metrics=mt).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    close = (np.abs(got - want) <= 1e-4 + 1e-4 * np.abs(want)).all(-1)
    assert close.mean() >= 0.999, (close.mean(), np.abs(got - want).max())
    assert abs(mt["rays"] - mj["rays"]) <= ray_slack, (mt["rays"], mj["rays"])
    return want, got, mj, mt


def _registered(sid, nx=NX, ny=NY):
    return rt.build_scene(sid, nx, ny), rtt.build_scene(sid, nx, ny,
                                                        device="cpu")


@pytest.mark.parametrize("sid,rng,scheduler,seed", [
    (0, "tea", "regen", 0), (0, "tea", "queue", 7), (5, "tea", "regen", 7),
    (5, "tea", "queue", 0), (0, "threefry", "regen", 7),
    (0, "threefry", "queue", 0), (5, "threefry", "regen", 0),
    (5, "threefry", "queue", 7)])
def test_other_streams_render_like_the_reference(sid, rng, scheduler, seed):
    """Scenes 0 and 5, 16x16, 4 spp, depth 8.  Under tea a seed below 2^32
    draws seed 0's stream (the reference's quirk): the port's image at
    seed 7 is its image at seed 0."""
    js, ts = _registered(sid)
    kw = dict(nx=NX, ny=NY, spp=4, max_depth=8, scene_id=sid, seed=seed,
              rng=rng, scheduler=scheduler, backend="jnp")
    _, got, _, _ = _both(js, ts, **kw)
    if rng == "tea" and seed:
        again = rtt.render(ts, rtt.RenderConfig(**{**kw, "seed": 0}))
        np.testing.assert_array_equal(got, again.numpy())


# Rays each book render may trace more or fewer than the reference's.
# Scene 2 traces one ray fewer (2583 of 2584) at seed 0: one path's
# Russian-roulette draw sits within f32 rounding of its continuation
# probability, after a grazing hit on the r = 1000 ground sphere.
# test_book_ray_difference_is_one_rr_draw_on_the_edge traces that path on
# both sides and in float64.  Scene 0 traces equal rays.
BOOK_RAY_SLACK = {0: 0, 2: 1}


@pytest.mark.parametrize("sid", [0, 2])
@pytest.mark.parametrize("scheduler", ["regen", "queue"])
def test_book_renders_like_the_reference(sid, scheduler):
    """The mixture estimator on scenes 0 (Cornell: one light) and 2 (the
    marble and the earth map under a light), 16x16, 4 spp, depth 8."""
    js, ts = _registered(sid)
    want, got, mj, mt = _both(
        js, ts, BOOK_RAY_SLACK[sid], nx=NX, ny=NY, spp=4, max_depth=8,
        scene_id=sid, estimator="book", scheduler=scheduler, backend="jnp")
    # no shadow rays: fewer rays than the NEE estimator traces
    m_mis = {}
    rtt.render(ts, rtt.RenderConfig(nx=NX, ny=NY, spp=4, max_depth=8,
                                    scene_id=sid, scheduler=scheduler),
               metrics=m_mis)
    assert mt["rays"] < m_mis["rays"]


def _record_rr(monkeypatch, module, out):
    """Wrap `module.bounce_core` to record, at each bounce, the winner prim,
    the Russian-roulette draw and, from a second call with RR off, the
    continuation probability and whether the path goes on before RR."""
    core = module.bounce_core

    def wrapped(env, U, depth, alive, *rest):
        pre = core(env._replace(rr_start_depth=1 << 30), U, depth, alive,
                   *rest)
        out.update(prim=rest[-1], u_rr=U[TR.U_RR],
                   p_cont=pre.throughput.max_component(), goes_on=pre.alive)
        return core(env, U, depth, alive, *rest)

    monkeypatch.setattr(module, "bounce_core", wrapped)


def _as_f64(x):
    """A scene or path state with every float32 tensor in float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.dtype == torch.float32 else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _as_f64(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if hasattr(x, "_fields"):
        return type(x)(*(_as_f64(v) for v in x))
    return x


def test_book_ray_difference_is_one_rr_draw_on_the_edge(monkeypatch):
    """BOOK_RAY_SLACK's one ray, traced: test_book_renders_like_the_
    reference's scene-2 paths (every pixel and sample, seed 0) stepped
    bounce by bounce through both packages' bounce_step from bit-equal
    camera rays.  Where one side's path ends and the other's goes on, the
    winner prim and everything before Russian roulette agree, and the two
    continuation probabilities straddle the draw within 1e-3 of each
    other: a rounding of the hit, not of the estimator.  The port in
    float64 (exact fused multiply-adds) from the same camera ray lands
    further from each side than the sides are from each other, so f32
    rounding at the hit covers the gap.  The rays each side counts are its
    render's."""
    js, ts = _registered(2)
    kw = dict(nx=NX, ny=NY, spp=4, max_depth=8, scene_id=2,
              estimator="book", backend="jnp")
    jc, tc = rt.RenderConfig(**kw), rtt.RenderConfig(**kw)
    mj, mt = {}, {}
    rt.render(js, jc, metrics=mj)
    rtt.render(ts, tc, metrics=mt)

    npix = NX * NY
    pix = np.tile(np.arange(npix), 4)
    smp = np.repeat(np.arange(4), npix)
    jkeys = JR.make_path_keys(JR.base_key(0), jnp.asarray(pix, jnp.int32),
                              jnp.asarray(smp, jnp.int32))
    tkeys = TR.make_path_keys(0, torch.as_tensor(pix), torch.as_tensor(smp))
    rj, rtor = {}, {}
    _record_rr(monkeypatch, JI, rj)
    _record_rr(monkeypatch, TI, rtor)
    jstep = jax.jit(lambda k, s, b: (JI.bounce_step(js, jc, k, s, b),
                                     dict(rj)))
    sj = jax.jit(lambda k: JI.generate_camera_rays(
        js, jc, jnp.asarray(pix, jnp.int32), k))(jkeys)
    st = TI.generate_camera_rays(ts, tc, torch.as_tensor(pix), tkeys)
    for a, b in ((sj.origin, st.origin), (sj.direction, st.direction)):
        for cj, ct in zip(a, b):
            np.testing.assert_array_equal(np.asarray(cj), ct.numpy())

    s64 = _as_f64(st)
    ts64 = _as_f64(ts)
    r64 = {}
    n = pix.size
    parted = np.zeros(n, bool)
    rays_t = 0
    edges = []
    for bounce in range(kw["max_depth"]):
        alive_in = np.asarray(sj.alive) & st.alive.numpy() & ~parted
        sj, cj = jstep(jkeys, sj, jnp.full((n,), bounce, jnp.int32))
        depth = torch.full((n,), bounce, dtype=torch.int64)
        st, rays_lane = TI.bounce_step(ts, tc, tkeys, st, depth)
        rays_t += int(rays_lane.sum())
        ct = dict(rtor)
        with monkeypatch.context() as m:
            m.setattr(TX, "fma", lambda x, y, z: x * y + z)
            m.setattr(TI, "fma", TX.fma)
            s64, _ = TI.bounce_step(ts64, tc, tkeys, s64, depth)
        c64 = dict(rtor)
        flip = alive_in & (np.asarray(sj.alive) != st.alive.numpy())
        for lane in np.flatnonzero(flip):
            prim = int(ct["prim"][lane])
            assert int(cj["prim"][lane]) == prim == int(c64["prim"][lane])
            assert bool(cj["goes_on"][lane]) and bool(ct["goes_on"][lane])
            assert bounce >= tc.rr_start_depth
            u = float(ct["u_rr"][lane])
            assert float(cj["u_rr"][lane]) == u
            pj = float(cj["p_cont"][lane])
            pt = float(ct["p_cont"][lane])
            p64 = float(c64["p_cont"][lane])
            assert min(pj, pt) < u <= max(pj, pt)
            assert abs(pj - pt) <= 1e-3 * u, (pj, pt, u)
            assert min(abs(p64 - pj), abs(p64 - pt)) > abs(pj - pt), (
                pj, pt, p64)
            edges.append((lane, bounce, prim))
        parted |= flip
    rays_j = int(sj.ray_count)
    assert rays_j == mj["rays"] and rays_t == mt["rays"]
    assert len(edges) == 1, edges
    assert abs(rays_j - rays_t) <= BOOK_RAY_SLACK[2]
    assert all(prim == 0 for _, _, prim in edges)    # the ground sphere


def test_mis_bsdf_weight_off_renders_like_the_reference():
    """Cornell with the BSDF-side MIS weight off (the reference's
    one-sided parity mode), regen, 16x16, 8 spp, depth 8."""
    js, ts = _registered(0)
    kw = dict(nx=NX, ny=NY, spp=8, max_depth=8, scene_id=0,
              mis_bsdf_weight=False)
    _, got, _, _ = _both(js, ts, **kw)
    on = rtt.render(ts, rtt.RenderConfig(**{**kw, "mis_bsdf_weight": True}))
    assert not np.array_equal(got, on.numpy())    # the flag is read


# ---------------------------------------------------------------------------
# tests/test_integrator.py's estimator scenes, built by both packages'
# SceneBuilder from one function

CAVITY_L = 0.7


def _floor_and_camera(b, S):
    grey = b.lambertian(b.constant_texture((0.7, 0.7, 0.7)))
    b.rect(-8, 8, -8, 8, 0.0, False, S.AXIS_Y, grey)
    return lambda: b.set_camera((0, 0.5, 0), (0, 0.0, 0), (1, 0, 0), 60,
                                1.0, 0.0, 0.5)


def _two_lights(B, S):
    """test_mis_unbiased_two_lights: a tiny decoy light at row 0, a large
    close ceiling light at row 1."""
    b = B()
    camera = _floor_and_camera(b, S)
    em_t = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
    b.rect(7.0, 7.1, 7.0, 7.1, 4.0, True, S.AXIS_Y, em_t)
    b.add_light(position=(7.0, 4.0, 7.0), vec_u=(0.1, 0.0, 0.0),
                vec_v=(0.0, 0.0, 0.1), emission=(1.0, 1.0, 1.0))
    em_b = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
    b.rect(-4.0, 4.0, -4.0, 4.0, 1.5, True, S.AXIS_Y, em_b)
    b.add_light(position=(-4.0, 1.5, -4.0), vec_u=(8.0, 0.0, 0.0),
                vec_v=(0.0, 0.0, 8.0), emission=(1.0, 1.0, 1.0))
    camera()
    return b.build()


def _unregistered_emissive(B, S):
    """test_mis_unbiased_unregistered_emissive_single_light: one registered
    light and an emissive panel never passed to add_light."""
    b = B()
    camera = _floor_and_camera(b, S)
    em_r = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
    b.rect(5.0, 6.0, 5.0, 6.0, 3.0, True, S.AXIS_Y, em_r)
    b.add_light(position=(5.0, 3.0, 5.0), vec_u=(1.0, 0.0, 0.0),
                vec_v=(0.0, 0.0, 1.0), emission=(1.0, 1.0, 1.0))
    em_u = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
    b.rect(-4.0, 4.0, -4.0, 4.0, 1.5, True, S.AXIS_Y, em_u)
    camera()
    return b.build()


def _coplanar_lights(B, S):
    """test_mis_unbiased_coplanar_adjacent_lights: two lights sharing an
    edge."""
    b = B()
    camera = _floor_and_camera(b, S)
    for x0, x1 in [(-4.0, 0.0), (0.0, 4.0)]:
        em = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
        b.rect(x0, x1, -4.0, 4.0, 1.5, True, S.AXIS_Y, em)
        b.add_light(position=(x0, 1.5, -4.0), vec_u=(x1 - x0, 0.0, 0.0),
                    vec_v=(0.0, 0.0, 8.0), emission=(1.0, 1.0, 1.0))
    camera()
    return b.build()


def _cavity(B, S):
    """test_furnace_cavity_exact: an albedo-1 sphere inside six walls, each
    emitting CAVITY_L and each a registered light."""
    b = B()
    lt = b.constant_texture((CAVITY_L,) * 3)
    lm = b.diffuse_light(lt)
    b.sphere((0.0, 0.0, 0.0), 1.0,
             b.lambertian(b.constant_texture((1.0, 1.0, 1.0))))
    h = 5.0
    for axis in (S.AXIS_Z, S.AXIS_Y, S.AXIS_X):    # normals face inward
        b.rect(-h, h, -h, h, -h, False, axis, lm)
        b.rect(-h, h, -h, h, h, True, axis, lm)
    for axis, k, u, v in [(2, -h, (2 * h, 0, 0), (0, 2 * h, 0)),
                          (2, h, (2 * h, 0, 0), (0, 2 * h, 0)),
                          (1, -h, (2 * h, 0, 0), (0, 0, 2 * h)),
                          (1, h, (2 * h, 0, 0), (0, 0, 2 * h)),
                          (0, -h, (0, 2 * h, 0), (0, 0, 2 * h)),
                          (0, h, (0, 2 * h, 0), (0, 0, 2 * h))]:
        pos = [-h, -h, -h]
        pos[axis] = k
        b.add_light(tuple(pos), u, v, (CAVITY_L,) * 3, tex=lt)
    b.set_camera((0, 0, 4.0), (0, 0, 0), (0, 1, 0), 40, 1.0, 0.0, 1.0)
    return b.build()


ESTIMATOR_SCENES = {"two_lights": (_two_lights, 11),
                    "unregistered_emissive": (_unregistered_emissive, 31),
                    "coplanar_lights": (_coplanar_lights, 21),
                    "cavity": (_cavity, 3)}


@pytest.mark.parametrize("name", list(ESTIMATOR_SCENES))
def test_estimator_scenes_render_like_the_reference(name):
    """Each scene at 16x16, 8 spp, depth 6, the seed of its reference test,
    on both packages' regen sweep; the cavity's wall pixels end at exactly
    CAVITY_L."""
    build, seed = ESTIMATOR_SCENES[name]
    js, ts = build(JB, JS), build(TB, TS)
    assert ts.num_lights == js.num_lights
    assert ts.emissives_unregistered == js.emissives_unregistered
    _, got, _, _ = _both(js, ts, nx=NX, ny=NY, spp=8, max_depth=6,
                         seed=seed)
    if name == "cavity":
        walls = np.concatenate([got[:2].reshape(-1, 3),
                                got[-2:].reshape(-1, 3)])
        np.testing.assert_allclose(walls, CAVITY_L, atol=1e-5)


# ---------------------------------------------------------------------------
# The wavefront counters


def _metrics(scene, **kw):
    m = {}
    img = rtt.render(scene, rtt.RenderConfig(**kw), metrics=m)
    return img, m


def test_counters_match_the_reference_on_regen():
    """tests/test_integrator.py::test_bounce_stats_metrics's render (scene
    5, 40x24, 4 spp, depth 8): every counter metric equal to the
    reference's, the image equal to the one without counters, and the
    counters-only mode without the occupancy curve."""
    js, ts = _registered(5, 40, 24)
    kw = dict(nx=40, ny=24, spp=4, max_depth=8, scene_id=5,
              bounce_stats=True, occupancy_trace=True)
    _, _, mj, mt = _both(js, ts, **kw)
    for k in COUNTER_METRICS:
        assert mt[k] == mj[k], k
    rbd = mt["rays_by_depth"]
    assert len(rbd) == 8 and rbd[0] == 4 * 40 * 24
    assert mt["occupancy_by_iter"][0] == 1.0

    img, m = _metrics(ts, **kw)
    off, m_off = _metrics(ts, **{**kw, "bounce_stats": False,
                                 "occupancy_trace": False})
    assert torch.equal(img, off) and m["rays"] == m_off["rays"]
    assert not any(k in m_off for k in COUNTER_METRICS)
    only, mc = _metrics(ts, **{**kw, "occupancy_trace": False})
    assert torch.equal(only, off)
    assert mc["occupancy_by_iter"] == []
    for k in ("rays_by_depth", "wavefront_iterations", "mean_occupancy"):
        assert mc[k] == m[k], k


def test_counters_match_the_reference_on_the_queue():
    """Scene 1 (528 prims) on the work queue, 24x16, 4 spp, depth 8:
    lengths recorded at the flush."""
    js, ts = _registered(1, 24, 16)
    kw = dict(nx=24, ny=16, spp=4, max_depth=8, scene_id=1,
              scheduler="queue", backend="jnp", bounce_stats=True,
              occupancy_trace=True)
    _, got, mj, mt = _both(js, ts, **kw)
    for k in COUNTER_METRICS:
        assert mt[k] == mj[k], k
    off = rtt.render(ts, rtt.RenderConfig(**{**kw, "bounce_stats": False}))
    np.testing.assert_array_equal(got, off.numpy())


def test_queue_counters_skip_the_iterations_past_the_end(monkeypatch):
    """The card reads the queue's termination test once per 8 iterations
    and runs up to 7 past the end; forced to do so on the CPU, the
    counters and the image equal those of a read every iteration."""
    ts = rtt.build_scene(1, 24, 16, device="cpu")
    kw = dict(nx=24, ny=16, spp=2, max_depth=8, scene_id=1,
              scheduler="queue", bounce_stats=True, occupancy_trace=True)
    img1, m1 = _metrics(ts, **kw)
    monkeypatch.setattr(TI, "_check_every", lambda device: 8)
    img8, m8 = _metrics(ts, **kw)
    assert torch.equal(img1, img8) and m1["rays"] == m8["rays"]
    for k in COUNTER_METRICS:
        assert m8[k] == m1[k], k
    assert m1["wavefront_iterations"] % 8 != 0    # some ran past the end


def test_counters_add_over_tiles_and_chunks():
    """Two pixel batches and two spp chunks count what one batch and one
    chunk counts, but for the iterations: each call runs its own, and the
    occupancy is a share of the batch."""
    ts = rtt.build_scene(5, 16, 16, device="cpu")
    kw = dict(nx=16, ny=16, spp=4, max_depth=8, scene_id=5,
              bounce_stats=True)
    one, m1 = _metrics(ts, **kw)
    split, m2 = _metrics(ts, **kw, ray_batch=128, spp_chunk=2)
    torch.testing.assert_close(split, one, rtol=1e-6, atol=1e-6)
    assert m2["rays_by_depth"] == m1["rays_by_depth"]
    assert m2["wavefront_iterations"] > m1["wavefront_iterations"]
    assert 0.0 < m2["mean_occupancy"] <= 1.0
