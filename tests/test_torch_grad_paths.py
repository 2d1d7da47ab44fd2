"""The port's gradient path on its own, and its gates.

- The reference's own checks of tests/test_diff.py, on the port: albedo,
  emission and camera gradients against central finite differences (its
  eps and rtol), the chunked gradient against the whole-batch one (rtol
  2e-4, atol 1e-6) and remat against no remat (rtol 1e-4, atol 1e-7),
  finite non-zero gradients on all six scenes (24x24, depth 3), and
  gradient descent recovering the albedo.
- The reeval branch (split="plain") against the plain branch on every
  scene: the same gradients (rtol 1e-5, atol 1e-8).
- `intersect.reeval_hit` from `trace_plain`'s winners against
  `intersect_scene` on tests/test_torch_trace.py's rays, the tie scene and
  Cornell's transformed box included: t, point, normal and uv equal, and
  t's gradient with respect to the rays equal.
- F2, the undetached sphere uv: at a sphere's pole the camera gradient is
  finite, the uv carries no gradient, and both match the reference's.
- The gates: `unported` is empty; render(differentiable=True) renders as
  the reference's does; the kernel wrappers refuse a tensor that requires
  grad under grad mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu import diff as JD
from rtw_tpu.models import scene as JS
from rtw_tpu.models.builder import SceneBuilder as JB
from rtw_tpu.ops import intersect as JI
from rtw_tpu.ops.vec import Vec3 as JV
from rtw_tpu.utils import rng as JR
import rtw_tpu_torch as rtt
from chip_smoke import tie_rays, tie_scene
from rtw_tpu_torch import diff as TD
from rtw_tpu_torch import integrator as TI
from rtw_tpu_torch.models import scene as TS
from rtw_tpu_torch.models.builder import ASSET_DIR, SceneBuilder as TB
from rtw_tpu_torch.ops import intersect as TX
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.ops.vec import Vec3 as TV

from tests.test_torch_diff import (assert_grads_close, leaf, leaf_names,
                                   simple_scene)
from tests.test_torch_trace import _rays

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

CFG = rtt.RenderConfig(nx=12, ny=12, spp=1, max_depth=4, differentiable=True)
N_SAMPLES = 3
PIX = torch.arange(CFG.num_pixels)


@pytest.fixture(scope="module")
def scene():
    return simple_scene(TB, TS)


def _set_tex(row, ch):
    return (lambda p: p["tex_color"][row, ch],
            lambda p, v: {**p, "tex_color": p["tex_color"].index_put(
                (torch.tensor(row), torch.tensor(ch)), v)})


def test_albedo_gradient_matches_fd(scene):
    """The ground's red albedo (texture row 0, channel 0)."""
    a, n = TD.finite_difference_check(scene, CFG, PIX, 7, N_SAMPLES,
                                      _set_tex(0, 0), eps=1e-2)
    assert np.isfinite(a) and n != 0.0
    np.testing.assert_allclose(a, n, rtol=2e-2)


def test_emission_gradient_matches_fd(scene):
    """The light's green emission (its texture row, tied to its light
    row): more emission, more radiance."""
    a, n = TD.finite_difference_check(scene, CFG, PIX, 7, N_SAMPLES,
                                      _set_tex(scene.light_tex[0], 1),
                                      eps=1e-2)
    assert np.isfinite(a) and n != 0.0 and a > 0
    np.testing.assert_allclose(a, n, rtol=2e-2)


def test_camera_gradient_matches_fd():
    """tests/test_diff.py's smooth camera configuration: direct light on a
    frame-filling ground, d/d lower_left.x (a pan)."""
    b = TB()
    ground = b.lambertian(b.constant_texture((0.6, 0.5, 0.4)))
    lt = b.constant_texture((5.0, 5.0, 5.0))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, ground)
    b.rect(5.0, 25.0, -10.0, 10.0, 12.0, True, TS.AXIS_Y, b.diffuse_light(lt))
    b.add_light((5.0, 12.0, -10.0), (20.0, 0.0, 0.0), (0.0, 0.0, 20.0),
                (5.0, 5.0, 5.0), tex=lt)
    b.set_camera((0, 5.0, 0), (0, 0, 0), (0, 0, -1), 45, 1.0, 0.0, 1.0)
    cfg = dataclasses.replace(CFG, max_depth=1)

    def put(p, v):
        cam = p["camera"]
        ll = torch.cat([v.reshape(1), cam.lower_left[1:]])
        return {**p, "camera": dataclasses.replace(cam, lower_left=ll)}

    a, n = TD.finite_difference_check(
        b.build(), cfg, PIX, 7, N_SAMPLES,
        (lambda p: p["camera"].lower_left[0], put), eps=5e-3)
    assert np.isfinite(a) and n != 0.0
    np.testing.assert_allclose(a, n, rtol=5e-2)


def _grads_close(a, b, rtol, atol):
    for name in leaf_names(a):
        torch.testing.assert_close(leaf(b, name), leaf(a, name), rtol=rtol,
                                   atol=atol, msg=name)


def test_chunked_grad_matches_monolithic(scene):
    """make_loss_and_grad_chunked (2-sample chunks, remat) against the
    whole batch, 4 samples."""
    target = torch.zeros((CFG.num_pixels, 3))
    params = TD.extract_params(scene)
    lm, gm = TD.make_loss_and_grad(scene, CFG, 4)(params, target, PIX, 3)
    lc, gc = TD.make_loss_and_grad_chunked(scene, CFG, 4, 2)(
        params, target, PIX, 3)
    np.testing.assert_allclose(float(lc), float(lm), rtol=1e-5)
    _grads_close(gm, gc, rtol=2e-4, atol=1e-6)


def test_remat_matches_no_remat(scene):
    """Checkpointed bounces recompute the same samples and winners: the
    same loss and gradients."""
    target = torch.zeros((CFG.num_pixels, 3))
    params = TD.extract_params(scene)
    l1, g1 = TD.make_loss_and_grad(scene, CFG, 2)(params, target, PIX, 5)
    l2, g2 = TD.make_loss_and_grad(
        scene, dataclasses.replace(CFG, remat=False), 2)(params, target,
                                                          PIX, 5)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    _grads_close(g2, g1, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("sid", [0, 1, 2, 3, 4, 5])
def test_gradients_finite_all_scenes(sid):
    """Every scene's loss and gradients finite and the texture colours'
    non-zero (24x24, depth 3, 2 samples): no NaN cotangent from a masked
    lane reaches the camera's gradient through the lane sum."""
    cfg = rtt.RenderConfig(nx=24, ny=24, spp=1, max_depth=3,
                           differentiable=True, backend="jnp", scene_id=sid)
    sc = rtt.build_scene(sid, 24, 24, device="cpu")
    loss, g = TD.make_loss_and_grad(sc, cfg, 2)(
        TD.extract_params(sc), torch.zeros((cfg.num_pixels, 3)),
        torch.arange(cfg.num_pixels), 3)
    assert np.isfinite(float(loss))
    for name in leaf_names(g):
        assert bool(torch.isfinite(leaf(g, name)).all()), name
    assert float(g["tex_color"].abs().sum()) > 0


def test_gradient_descent_recovers_albedo(scene):
    """Perturb the ball's albedo, descend on the MSE to the original
    render: the loss halves."""
    params = TD.extract_params(scene)
    with torch.no_grad():
        target = TD.render_for_grad(params, scene, CFG, PIX, 11, 2)
    params["tex_color"][1] = torch.tensor([0.8, 0.1, 0.9])
    fn = TD.make_loss_and_grad(scene, CFG, 2)
    l0 = None
    for _ in range(12):
        loss, g = fn(params, target, PIX, 11)
        l0 = float(loss) if l0 is None else l0
        params = {**params, "tex_color": params["tex_color"]
                  - 40.0 * g["tex_color"]}
    assert float(loss) < 0.5 * l0


@pytest.mark.parametrize("sid", [0, 1, 2, 3, 4, 5])
def test_reeval_branch_gradient_equals_plain_branch(sid):
    """split="plain" (the winner without gradients, then reeval_hit)
    against the plain sweep differentiated directly: reeval recomputes the
    winner's t with the same arithmetic, so the gradients agree to
    rounding (16x16, depth 3, 2 samples)."""
    cfg = rtt.RenderConfig(nx=16, ny=16, spp=1, max_depth=3,
                           differentiable=True, backend="jnp", scene_id=sid)
    sc = rtt.build_scene(sid, 16, 16, device="cpu")
    args = (TD.extract_params(sc), torch.zeros((cfg.num_pixels, 3)),
            torch.arange(cfg.num_pixels), 9)
    l1, g1 = TD.make_loss_and_grad(sc, cfg, 2)(*args)
    l2, g2 = TD.make_loss_and_grad(sc, cfg, 2, split="plain")(*args)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    _grads_close(g1, g2, rtol=1e-5, atol=1e-8)


# ---- reeval_hit against intersect_scene ---------------------------------

def _reeval_inputs(which):
    """(scene, o, d, tmax, time, vol_u) as tensors: tests/test_torch_trace.py's
    random rays on a registered scene, or the tie scene's rays."""
    if which == "ties":
        o, d, tmax = tie_rays(2048)
        n = o.shape[1]
        return (tie_scene(TB, TS), *(TV(*map(torch.as_tensor, a))
                                     for a in (o, d)),
                torch.as_tensor(tmax), torch.zeros(n),
                torch.full((1, n), 0.5))
    sc = rtt.build_scene(which, 64, 48, device="cpu")
    o, d, time, vol_u = _rays(which, sc.n_vol)
    return (sc, TV(*map(torch.as_tensor, o)), TV(*map(torch.as_tensor, d)),
            torch.full((o.shape[1],), 1e27), torch.as_tensor(time),
            torch.as_tensor(vol_u))


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4, 5, "ties"])
def test_reeval_hit_matches_intersect_scene(which):
    """From trace_plain's winners (taken without gradients), reeval_hit
    gives intersect_scene's t, point, normal and uv on every lane (scene 0
    holds Cornell's transformed box, scenes 3 and 4 volumes, scene 1
    moving spheres; the tie scene equal spheres and coincident rects and
    boxes), and d t / d origin equal to intersect_scene's.  The winner
    from the no-grad query carries no gradient."""
    sc, o, d, tmax, time, vol_u = _reeval_inputs(which)
    o = TV(*(c.clone().requires_grad_() for c in o))
    with torch.no_grad():
        k_hit, _ = TK.trace_plain(sc, o, d, 1e-6, tmax, time, vol_u)
    assert not k_hit.t.requires_grad and not k_hit.point.x.requires_grad
    want = TX.intersect_scene(sc, o, d, 1e-6, tmax, time, vol_u)
    got = TX.reeval_hit(sc, k_hit.prim_idx, o, d, 1e-6, 1e27, time, vol_u,
                        t_hint=k_hit.t)
    hit = want.prim_idx >= 0
    assert float(hit.float().mean()) > 0.2     # scene 4's fog: every ray
    assert torch.equal(got.prim_idx, want.prim_idx)
    assert torch.equal(got.mat_id, want.mat_id)
    assert torch.equal(got.t, want.t)
    for g, w in ((got.point, want.point), (got.normal, want.normal),
                 ((got.u, got.v), (want.u, want.v))):
        for a, b in zip(g, w):
            torch.testing.assert_close(a[hit], b[hit], rtol=0, atol=0)
    sel = torch.where(hit, got.t, 0.0).sum()
    ref = torch.where(hit, want.t, 0.0).sum()
    for a, b in zip(torch.autograd.grad(sel, list(o)),
                    torch.autograd.grad(ref, list(o))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_reeval_hit_takes_the_hint_where_it_misses():
    """A winner the re-evaluation misses (here: tmax below the kernel's
    t) takes the kernel's t, detached, so the payload never sees BIG."""
    sc, o, d, tmax, time, vol_u = _reeval_inputs(0)
    with torch.no_grad():
        k_hit, _ = TK.trace_plain(sc, o, d, 1e-6, tmax, time, vol_u)
    d = TV(*(c.clone().requires_grad_() for c in d))
    got = TX.reeval_hit(sc, k_hit.prim_idx, o, d, 1e-6, 1e-3, time, vol_u,
                        t_hint=k_hit.t)
    hit = k_hit.prim_idx >= 0
    assert torch.equal(got.t[hit], k_hit.t[hit])
    assert bool(torch.isfinite(got.point.x).all())
    (g,) = torch.autograd.grad(got.t.sum(), [d.x], allow_unused=True)
    assert g is None or not bool(g[hit].any())


# ---- F2: the sphere's uv carries no gradient ------------------------------

def _pole_scenes():
    """(reference, port) scenes: an earth-mapped unit sphere at the origin
    under a light off to the side, and a camera whose every ray goes
    straight down from (0, 5, 0) onto the north pole (its frustum vectors
    are zero), so each hit's normal is (0, 1, 0) exactly."""
    out = []
    for builder, smod in ((JB, JS), (TB, TS)):
        b = builder()
        earth = b.lambertian(b.image_texture(f"{ASSET_DIR}/earthmap.jpg"))
        lt = b.constant_texture((4.0, 4.0, 4.0))
        b.sphere((0.0, 0.0, 0.0), 1.0, earth)
        b.rect(2.0, 4.0, -1.0, 1.0, 3.0, True, smod.AXIS_Y,
               b.diffuse_light(lt))          # beside the camera's rays
        b.add_light((2.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0),
                    (4.0, 4.0, 4.0), tex=lt)
        b.set_camera((0, 5.0, 0), (0, 0, 0), (0, 0, -1), 40, 1.0, 0.0, 1.0)
        sc = b.build()
        xp = jnp if builder is JB else torch
        zero = xp.zeros(3, dtype=xp.float32)
        cam = dataclasses.replace(
            sc.camera, lower_left=xp.asarray([0.0, 4.0, 0.0],
                                             dtype=xp.float32),
            horizontal=zero, vertical=zero)
        out.append(dataclasses.replace(sc, camera=cam))
    return out


def test_sphere_uv_carries_no_gradient_at_the_pole():
    """A ray straight down onto a sphere's pole: the hit's uv carries no
    gradient (the reference detaches the normal before atan2 / asin), and
    d (point + u + v) / d origin is finite and the reference's."""
    js, ts = _pole_scenes()
    jd = JV(*(jnp.asarray([x], jnp.float32) for x in (0.0, -1.0, 0.0)))

    @jax.jit
    @jax.grad
    def ref_grad(oo):
        h = JI.intersect_scene(js, JV(*oo), jd, 1e-6, 1e27,
                               jnp.zeros(1), jnp.zeros((1, 1)))
        return (h.point.x + h.point.y + h.point.z + h.u + h.v).sum()

    o = TV(*(torch.tensor([x], requires_grad=True)
             for x in (0.0, 5.0, 0.0)))
    d = TV(*(torch.tensor([x]) for x in (0.0, -1.0, 0.0)))
    args = (1e-6, 1e27, torch.zeros(1), torch.zeros((1, 1)))
    for hit in (TX.intersect_scene(ts, o, d, *args),
                TX.reeval_hit(ts, torch.tensor([0]), o, d, *args)):
        assert float(hit.normal.y[0].detach()) == 1.0
        for g in torch.autograd.grad((hit.u + hit.v).sum(), list(o),
                                     retain_graph=True, allow_unused=True):
            assert g is None or not bool(g.any())
        loss = sum(hit.point) + hit.u + hit.v
        got = torch.autograd.grad(loss.sum(), list(o))
        want = ref_grad(tuple(jnp.asarray(c.detach().numpy()) for c in o))
        for a, b in zip(got, want):
            assert bool(torch.isfinite(a).all())
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_camera_gradient_is_finite_at_the_pole():
    """Every primary ray hits the earth-mapped sphere at its pole, where
    the bilinear fetch (tex_filter="rgb8") weighs its texels by u and v:
    the loss's camera and texture gradients are finite and the
    reference's (rtol 1e-3, atol 1e-5; 4x4, depth 2, 2 samples).  With an
    undetached normal, asin's backward at n.y = 1 made them NaN."""
    js, ts = _pole_scenes()
    kw = dict(nx=4, ny=4, spp=1, max_depth=2, differentiable=True,
              backend="jnp", tex_filter="rgb8")
    target = np.zeros((16, 3), np.float32)
    pix = np.arange(16, dtype=np.int32)
    lw, gw = JD.make_loss_and_grad(js, rt.RenderConfig(**kw), 2)(
        JD.extract_params(js), jnp.asarray(target), jnp.asarray(pix),
        JR.base_key(1))
    lg, gg = TD.make_loss_and_grad(ts, rtt.RenderConfig(**kw), 2)(
        TD.extract_params(ts), torch.as_tensor(target), torch.as_tensor(pix),
        1)
    np.testing.assert_allclose(float(lg), float(lw), rtol=1e-5)
    assert_grads_close(gw, gg)
    assert float(gg["camera"].origin.abs().sum()) > 0


# ---- gates ----------------------------------------------------------------

def test_every_option_is_ported():
    assert TI.unported(dataclasses.replace(CFG, differentiable=True)) == []


@pytest.mark.parametrize("scheduler", ["regen", "queue"])
def test_differentiable_render_matches_reference(scheduler):
    """render(differentiable=True) on the CPU (the plain sweep, as the
    reference's jnp sweep) against the reference's render with the same
    flag: every pixel within 1e-4 and equal rays (scene 0, 16x16, 2 spp,
    depth 4)."""
    kw = dict(nx=16, ny=16, spp=2, max_depth=4, scene_id=0,
              differentiable=True, scheduler=scheduler)
    mj, mt = {}, {}
    want = np.asarray(rt.render(rt.build_scene(0, 16, 16),
                                rt.RenderConfig(**kw), metrics=mj))
    got = rtt.render(rtt.build_scene(0, 16, 16, device="cpu"),
                     rtt.RenderConfig(**kw), metrics=mt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert mt["rays"] == mj["rays"]


def test_kernel_wrappers_refuse_tensors_that_require_grad():
    """B's and C's wrappers and the tables refuse an input that requires
    grad while grad mode is on (a kernel would drop its gradient), on the
    CPU through the check the CUDA path runs; under torch.no_grad() they
    run."""
    sc = rtt.build_scene(0, 8, 8, device="cpu")
    o, d, time, vol_u = (torch.as_tensor(a) for a in _rays(0))
    o, d = TV(*o), TV(*d)
    args = (1e-6, 1e27, time, vol_u)
    live = TV(o.x.clone().requires_grad_(), o.y, o.z)
    for query in (TK.trace, TK.occluded_kernel):
        with pytest.raises(ValueError, match="requires grad"):
            query(sc, live, d, *args)
        with torch.no_grad():
            query(sc, live, d, *args)
    grad_scene = dataclasses.replace(sc, textures=dataclasses.replace(
        sc.textures, color=sc.textures.color.clone().requires_grad_()))
    with pytest.raises(ValueError, match="textures.color"):
        TK.split_tables(grad_scene)
    with pytest.raises(ValueError, match="textures.color"):
        TK.trace(grad_scene, o, d, *args)
    tables = TK.split_tables(sc)
    TK.trace(grad_scene, o, d, *args, tables)      # the tables are detached
    with torch.no_grad():
        TK.split_tables(grad_scene)
