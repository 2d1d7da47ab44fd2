"""The plain gradient of one loss-and-gradient step: the benchmark's
reference for a gradient call, in plain torch autograd (float32, TF32 off)
through this package's own paths, on this package's own scenes.

The step: the image of `n_samples` samples a pixel, at every pixel of the
image, with the step's seed, under the parameters {"tex_color": [T, 3],
"camera": {field: tensor}}; the loss, the mean squared error against a
target [P, 3]; its gradient with respect to every parameter.

The gradient semantics are those `rtw_tpu_torch/diff.py` states:

- discrete decisions carry no gradient: the winning primitive (the plain
  nearest-hit sweep picks it under no_grad, and `intersect.reeval_hit`
  recomputes the winner's t and payload with gradients), the dielectric
  branch, Russian roulette and the light picked (comparisons of fixed
  uniforms), and the shadow ray's visibility (the any-hit sweep runs under
  no_grad on detached rays);
- the pixel jitter is reparameterised: the camera's uniforms are fixed
  numbers and each ray is a function of the camera's fields;
- the sphere's uv is computed from a detached normal
  (`intersect._sphere_uv`), so the uv carries no gradient;
- light emission is tied to its texture row through `scene.light_tex`:
  each tied light row's emission is that row of `tex_color` (`apply`).

Computed in blocks of pixels so that it fits: pass 1 traces the whole image
without gradients, giving the loss and the cotangent 2 (img - target) /
(3 P n_samples); pass 2 traces each block again with autograd and adds its
vector-Jacobian product against the block's cotangent.

`round_to` runs the control: the same step with the carried state rounded
to that dtype after the camera and every bounce, and each pixel's sample
sum rounded, as `paths.render_pixels` rounds it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from . import intersect as I
from . import paths
from . import rng as R
from . import scene as S
from .bounce import PathState, bounce_core, scene_env
from .intersect import BIG
from .shading import gather_shade, resolve_albedo, tex_row
from .vec import Vec3

CAMERA_FIELDS = tuple(f.name for f in dataclasses.fields(S.Camera))


def params_of(scene: S.Scene) -> dict:
    """The differentiable parameters of `scene`, detached copies:
    {"tex_color": [T, 3], "camera": {field: tensor}}."""
    cam = scene.camera
    return {"tex_color": scene.textures.color.detach().clone(),
            "camera": {f: getattr(cam, f).detach().clone()
                       for f in CAMERA_FIELDS}}


def apply(scene: S.Scene, params: dict) -> S.Scene:
    """`scene` with `params` in place, out of place; each light row tied
    to a texture row (`light_tex`) emits that row's colour."""
    tex = params["tex_color"]
    emission = scene.lights.emission
    tied = [(i, row) for i, row in enumerate(scene.light_tex) if row >= 0]
    if tied:
        dev = emission.device
        emission = emission.index_copy(
            0, torch.tensor([i for i, _ in tied], device=dev),
            tex[torch.tensor([row for _, row in tied], device=dev)])
    return dataclasses.replace(
        scene, textures=dataclasses.replace(scene.textures, color=tex),
        lights=dataclasses.replace(scene.lights, emission=emission),
        camera=dataclasses.replace(scene.camera, **params["camera"]))


def _detached(v: Vec3) -> Vec3:
    return Vec3(*(c.detach() for c in v))


def _occlude(scene, cfg, time, occ_u, shadow_org, ldir_u, occ_tmax, want):
    """The shadow query: a detached decision."""
    del want
    with torch.no_grad():
        return I.occluded(scene, _detached(shadow_org), _detached(ldir_u),
                          cfg.shadow_eps, occ_tmax.detach(), time.detach(),
                          occ_u)


def bounce(scene: S.Scene, cfg, path_keys, state: PathState,
           depth: int) -> PathState:
    """`paths.bounce` with the winner picked without gradients and
    recomputed with them, and the shadow query detached."""
    nv = max(scene.n_vol, 1)
    row = tex_row(scene, cfg)
    n_slots = R.NUM_FIXED_SLOTS + 2 * nv + (1 if row >= 0 else 0)
    U = R.bounce_uniforms(path_keys, depth + 1, n_slots, cfg.rng)
    vol_u = U[R.NUM_FIXED_SLOTS: R.NUM_FIXED_SLOTS + nv]
    occ_u = U[R.NUM_FIXED_SLOTS + nv: R.NUM_FIXED_SLOTS + 2 * nv]
    tex_u = U[row] if row >= 0 else None
    o, d = state.origin, state.direction
    tmax_lane = torch.where(state.alive, float(np.float32(cfg.t_max)), -BIG)
    with torch.no_grad():
        won = I.intersect_scene(scene, _detached(o), _detached(d), cfg.t_min,
                                tmax_lane, state.time.detach(), vol_u)
    hit = I.reeval_hit(scene, won.prim_idx, o, d, cfg.t_min, cfg.t_max,
                       state.time, vol_u, t_hint=won.t)
    shade = gather_shade(scene, hit.prim_idx, hit.prim_idx >= 0)
    albedo = resolve_albedo(scene, shade, hit.point, hit.u, hit.v,
                            cfg.tex_filter, cfg.tex_tile_gate, tex_u)
    env = scene_env(scene, cfg, functools.partial(
        _occlude, scene, cfg, state.time, occ_u))
    res = bounce_core(env, U, depth, state.alive, o, d, state.time,
                      state.throughput, state.radiance, state.prev_pdf,
                      state.prev_diffuse, hit.prim_idx < 0, hit.point,
                      hit.normal, shade.mat_type, shade.fuzz, shade.eta,
                      albedo, hit.prim_idx)
    return PathState(origin=res.origin, direction=res.direction,
                     throughput=res.throughput, radiance=res.radiance,
                     alive=res.alive, time=state.time, prev_pdf=res.prev_pdf,
                     prev_diffuse=res.prev_diffuse)


def trace(scene: S.Scene, cfg, seed: int, pixel_idx, sample: int,
          round_to=None):
    """Radiance [N, 3] of sample `sample` of each pixel in `pixel_idx`
    (int64 [N]) rendered with `seed`, NaN and inf scrubbed to 0: the
    values of `paths.trace_samples`, differentiable."""
    smp = torch.full_like(pixel_idx, sample)
    keys = paths.path_keys(cfg, seed, pixel_idx, smp)
    state = paths.camera_rays(scene, cfg, pixel_idx, keys)
    if round_to is not None:
        state = paths._rounded(state, round_to)
    for depth in range(cfg.max_depth):
        if not bool(state.alive.any()):
            break
        state = bounce(scene, cfg, keys, state, depth)
        if round_to is not None:
            state = paths._rounded(state, round_to)
    rad = torch.stack([torch.where(torch.isfinite(c), c, 0.0)
                       for c in state.radiance], dim=1)
    if round_to is not None:
        rad = rad.to(round_to).to(torch.float32)
    return rad


def sample_sum(scene, cfg, seed, pixel_idx, n_samples, round_to=None):
    """The sum [N, 3] of samples 0 .. n_samples - 1 of each pixel."""
    acc = trace(scene, cfg, seed, pixel_idx, 0, round_to)
    for s in range(1, n_samples):
        acc = acc + trace(scene, cfg, seed, pixel_idx, s, round_to)
    if round_to is not None:
        acc = acc.to(round_to).to(torch.float32)
    return acc


@contextlib.contextmanager
def _no_tf32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def loss_and_grad(scene: S.Scene, cfg, params: dict, target, seed: int,
                  n_samples: int = 1, round_to=None,
                  lanes_per_block: int = 1 << 17):
    """(loss, grads) of one step at every pixel: the loss a float32 scalar
    tensor, the grads in `params`' structure (zeros where a parameter has
    no path to the image)."""
    npix = cfg.nx * cfg.ny
    dev = scene.device
    per_block = max(1, lanes_per_block // n_samples)
    starts = range(0, npix, per_block)
    blocks = [torch.arange(b, min(b + per_block, npix), dtype=torch.int64,
                           device=dev) for b in starts]
    n = float(np.float32(n_samples))
    with _no_tf32():
        with torch.no_grad():
            sc = apply(scene, params)
            img = torch.cat([sample_sum(sc, cfg, seed, pix, n_samples,
                                        round_to) for pix in blocks]) / n
            loss = torch.mean((img - target) ** 2)
            cot = 2.0 * (img - target) / float(np.float32(npix * 3
                                                          * n_samples))
        leaves = [params["tex_color"].detach().requires_grad_()] + [
            params["camera"][f].detach().requires_grad_()
            for f in CAMERA_FIELDS]
        p = {"tex_color": leaves[0],
             "camera": dict(zip(CAMERA_FIELDS, leaves[1:]))}
        total = [torch.zeros_like(t) for t in leaves]
        for b0, pix in zip(starts, blocks):
            part = sample_sum(apply(scene, p), cfg, seed, pix, n_samples,
                              round_to)
            g = torch.autograd.grad(part, leaves,
                                    grad_outputs=cot[b0:b0 + pix.shape[0]],
                                    allow_unused=True)
            total = [t if gi is None else t + gi for t, gi in zip(total, g)]
    return loss, {"tex_color": total[0],
                  "camera": dict(zip(CAMERA_FIELDS, total[1:]))}
