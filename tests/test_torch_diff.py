"""The port's gradients against rtw_tpu's on the same inputs: loss and every
gradient leaf (tex_color and each camera field) of
`rtw_tpu_torch.diff.make_loss_and_grad` against
`rtw_tpu.diff.make_loss_and_grad`, at tests/test_diff.py's sizes (12x12,
depth 4, 3 samples).

- The plain branch (the port's plain sweep, differentiated by autograd)
  against the reference's `backend="jnp"`, on test_diff.py's simple scene
  and on the registered scenes 0 (transforms, dielectric, metal), 2
  (marble, the earth map) and 3 (volumes).
- The reeval branch (the winner from B's plain version `trace_plain`
  without gradients, then `intersect.reeval_hit`) against the reference's
  `backend="pallas"` gradient in Pallas interpret mode, on scene 0 with
  remat off, as tests/test_diff.py::test_pallas_grad_matches_jnp runs it.

Tolerance: rtol 1e-3 and atol 1e-5 per leaf (measured: 2.4e-1 of it at
worst, on scene 2), the loss within rtol 1e-5.  A pixel whose path parts
from the reference's by an amplified ulp has no comparable gradient: on
scene 2 the gradients are compared on the pixels whose forward image
agrees with the reference's within 1e-4, all but pixel 102 (`PARTED`),
whose first sample ends in a grazing hit on the r = 1000 ground sphere
(test_parted_pixel_is_a_grazing_hit_on_the_ground_sphere; ROADMAP "Faults
found").  The other scenes are compared on every pixel."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu import diff as JD
from rtw_tpu.integrator import trace_paths as j_trace_paths
from rtw_tpu.models import scene as JS
from rtw_tpu.models.builder import SceneBuilder as JB
from rtw_tpu.utils import rng as JR
import rtw_tpu_torch as rtt
from rtw_tpu_torch import diff as TD
from rtw_tpu_torch import integrator as TI
from rtw_tpu_torch.models import scene as TS
from rtw_tpu_torch.models.builder import SceneBuilder as TB
from rtw_tpu_torch.ops import trace_kernel as TK

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

NX = NY = 12
DEPTH = 4
N_SAMPLES = 3
SEED = 7
RTOL, ATOL = 1e-3, 1e-5      # per gradient leaf
LOSS_RTOL = 1e-5
IMAGE_TOL = 1e-4             # a pixel's forward agreement (abs and rel)
# The pixels whose forward image parts from the reference's, per scene.
PARTED = {"simple": [], 0: [], 2: [102], 3: []}


def simple_scene(builder, scene_mod):
    """tests/test_diff.py's lambertian + light scene, built with either
    package's SceneBuilder: albedo products, NEE emission, BSDF-side
    emission and camera geometry all carry gradient."""
    b = builder()
    ground = b.lambertian(b.constant_texture((0.6, 0.5, 0.4)))
    ball = b.lambertian(b.constant_texture((0.3, 0.6, 0.2)))
    lt = b.constant_texture((5.0, 5.0, 5.0))
    b.sphere((0.0, -100.5, -3.0), 100.0, ground)
    b.sphere((0.0, 0.0, -3.0), 0.5, ball)
    b.rect(-1.0, 1.0, -1.0, 1.0, 3.0, True, scene_mod.AXIS_Y,
           b.diffuse_light(lt))
    b.add_light((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0),
                (5.0, 5.0, 5.0), tex=lt)
    b.set_camera((0, 0.3, 0), (0, 0, -3), (0, 1, 0), 45, 1.0, 0.0, 1.0)
    return b.build()


def scenes(name, nx=NX, ny=NY):
    """(reference scene, port scene on the CPU) of `name`: "simple" or a
    registered scene id."""
    if name == "simple":
        return simple_scene(JB, JS), simple_scene(TB, TS)
    return (rt.build_scene(name, nx, ny),
            rtt.build_scene(name, nx, ny, device="cpu"))


def leaf_names(params):
    return ["tex_color"] + [f.name for f in
                            dataclasses.fields(params["camera"])]


def leaf(params, name):
    return (params["tex_color"] if name == "tex_color"
            else getattr(params["camera"], name))


def assert_grads_close(want, got, rtol=RTOL, atol=ATOL):
    """Every leaf of the port's gradient `got` finite and within rtol /
    atol of the reference's `want`."""
    for name in leaf_names(got):
        g = leaf(got, name).numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(leaf(want, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def _cfg_kw(name, **kw):
    return dict(nx=NX, ny=NY, spp=1, max_depth=DEPTH, differentiable=True,
                backend="jnp", scene_id=0 if name == "simple" else name,
                **kw)


def _parted(js, ts, kw, pix):
    """The pixels of `pix` whose forward image (render_for_grad, the loss's
    image) differs from the reference's by more than IMAGE_TOL."""
    want = np.asarray(jax.jit(lambda p: JD.render_for_grad(
        p, js, rt.RenderConfig(**kw), jnp.asarray(pix), JR.base_key(SEED),
        N_SAMPLES))(JD.extract_params(js)))
    got = TD.render_for_grad(TD.extract_params(ts), ts,
                             rtt.RenderConfig(**kw), torch.as_tensor(pix),
                             SEED, N_SAMPLES).numpy()
    assert np.isfinite(got).all()
    close = (np.abs(got - want) <= IMAGE_TOL
             + IMAGE_TOL * np.abs(want)).all(-1)
    return pix[~close].tolist()


@pytest.mark.parametrize("name", ["simple", 0, 2, 3])
def test_plain_branch_gradient_matches_reference(name):
    """The loss and each gradient leaf against the reference's jnp
    gradient: on every pixel, or on scene 2 on the pixels whose forward
    image agrees (PARTED)."""
    js, ts = scenes(name)
    kw = _cfg_kw(name)
    pix = np.arange(NX * NY, dtype=np.int32)
    if PARTED[name]:
        assert _parted(js, ts, kw, pix) == PARTED[name]
        pix = np.setdiff1d(pix, PARTED[name]).astype(np.int32)
    target = np.zeros((pix.size, 3), np.float32)
    lw, gw = JD.make_loss_and_grad(js, rt.RenderConfig(**kw), N_SAMPLES)(
        JD.extract_params(js), jnp.asarray(target), jnp.asarray(pix),
        JR.base_key(SEED))
    lg, gg = TD.make_loss_and_grad(ts, rtt.RenderConfig(**kw), N_SAMPLES)(
        TD.extract_params(ts), torch.as_tensor(target),
        torch.as_tensor(pix), SEED)
    np.testing.assert_allclose(float(lg), float(lw), rtol=LOSS_RTOL)
    assert_grads_close(gw, gg)
    assert float(gg["tex_color"].abs().sum()) > 0
    assert float(gg["camera"].lower_left.abs().sum()) > 0


def test_parted_pixel_is_a_grazing_hit_on_the_ground_sphere(monkeypatch):
    """Scene 2's parted pixel (PARTED): its sample 0 glances off the
    r = 1000 ground sphere at its last bounce, |cos| < 0.05 between the ray
    and the normal, where t moves by more than 1000 per unit of the
    camera's lower_left.x: the ulps that part the two packages' hit points
    (the quadratic's cancellation at r = 1000) move its radiance by more
    than IMAGE_TOL, and its camera gradient with it.  The lane's other
    samples agree."""
    (pixel,) = PARTED[2]
    js, ts = scenes(2)
    kw = _cfg_kw(2, remat=False)
    hits = []
    plain = TK.trace_plain

    def record(scene, o, d, *args):
        hit, shade = plain(scene, o, d, *args)
        hits.append((d, hit))
        return hit, shade

    monkeypatch.setattr(TK, "trace_plain", record)
    params = TD.extract_params(ts)
    ll = params["camera"].lower_left.clone().requires_grad_()
    params["camera"] = dataclasses.replace(params["camera"], lower_left=ll)
    out = []
    for s in range(N_SAMPLES):
        hits.clear()
        rad = TI.trace_paths(TD.apply_params(ts, params),
                             rtt.RenderConfig(**kw), torch.tensor([pixel]),
                             s, SEED)[0]
        out.append(rad)
        if s == 0:
            d, last = hits[-1]
            assert int(last.prim_idx[0]) == 0          # the ground sphere
            assert float(ts.prims.params[0, 3]) == 1000.0
            d_len = float(sum(c[0] * c[0] for c in d).sqrt().detach())
            cos = float(sum(n[0] * c[0] for n, c in zip(last.normal, d))
                        .detach())
            assert abs(cos / d_len) < 0.05
            dt = torch.autograd.grad(last.t[0], ll, retain_graph=True)[0]
            assert abs(float(dt[0])) > 1e3
    ref = jax.jit(lambda s: j_trace_paths(
        js, rt.RenderConfig(**kw), jnp.asarray([pixel], jnp.int32), s,
        JR.base_key(SEED))[0])
    want = np.stack([np.asarray(ref(s)) for s in range(N_SAMPLES)])
    got = torch.stack(out).detach().numpy()
    close = (np.abs(got - want) <= IMAGE_TOL + IMAGE_TOL * np.abs(want))
    assert not close[0].all()
    assert close[1:].all()


def test_reeval_branch_gradient_matches_reference_pallas():
    """The reeval branch (split="plain": the winner from `trace_plain`
    without gradients, recomputed by reeval_hit; the visibility from
    `occluded_plain`, detached) against the reference's backend="pallas"
    gradient (its kernels in interpret mode under stop_gradient, then its
    reeval_hit), scene 0 with remat off, 2 samples, seed 13."""
    from jax.experimental.pallas import tpu as pltpu

    js, ts = scenes(0)
    kw = _cfg_kw(0, remat=False)
    pix = np.arange(NX * NY, dtype=np.int32)
    target = np.zeros((pix.size, 3), np.float32)
    with pltpu.force_tpu_interpret_mode():
        lw, gw = JD.make_loss_and_grad(
            js, rt.RenderConfig(**{**kw, "backend": "pallas"}), 2)(
            JD.extract_params(js), jnp.asarray(target), jnp.asarray(pix),
            JR.base_key(13))
    lg, gg = TD.make_loss_and_grad(ts, rtt.RenderConfig(**kw), 2,
                                   split="plain")(
        TD.extract_params(ts), torch.as_tensor(target), torch.as_tensor(pix),
        13)
    np.testing.assert_allclose(float(lg), float(lw), rtol=LOSS_RTOL)
    assert_grads_close(gw, gg)
