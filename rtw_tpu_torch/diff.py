"""Differentiable rendering (port of rtw_tpu/diff.py): gradients of a
rendered image with respect to the texture colours (albedo and emission)
and the camera.

Detached sampling, as in the reference: every discrete decision (the
winning prim, the dielectric branch, Russian roulette, the light picked,
the shadow ray's visibility) is a comparison that carries no gradient, so
torch autograd through `integrator.trace_paths` (cfg.differentiable=True)
gives the reparameterised path gradient.  Gradients flow

- to the texture colours: the attenuation and emission products along each
  path and the NEE emission term;
- to the camera: frustum vectors -> ray directions -> hit points ->
  shading geometry (the pixel jitter is reparameterised, so the camera's
  gradients are smooth),

and visibility edges carry none (no edge sampling: the reference's scope).
On the split tier the kernels pick the winners under torch.no_grad() and
`intersect.reeval_hit` recomputes them with gradients.

Emission appears twice in a scene (the lights table for NEE, the texture
colour for hits); `Scene.light_tex` ties the light rows to their texture
rows, so one parameter drives both halves of the estimator.

Parameters are {"tex_color": [T, 3] tensor, "camera": Camera}; every
function takes them as tensors on the scene's device (the card unless the
scene was built on the CPU) and never modifies them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtw_tpu_torch.integrator import trace_paths
from rtw_tpu_torch.models import scene as S


def extract_params(scene: S.Scene) -> dict:
    """The differentiable parameters: {"tex_color": the texture colours,
    "camera": the Camera}, each a detached copy (a leaf tensor)."""
    cam = scene.camera
    return {"tex_color": scene.textures.color.detach().clone(),
            "camera": dataclasses.replace(cam, **{
                f.name: getattr(cam, f.name).detach().clone()
                for f in dataclasses.fields(cam)})}


def _leaves(params: dict) -> list:
    """The parameters' tensors in a fixed order: tex_color, then the
    camera's fields."""
    cam = params["camera"]
    return [params["tex_color"]] + [getattr(cam, f.name)
                                    for f in dataclasses.fields(cam)]


def _unflatten(params: dict, leaves) -> dict:
    """`params`' structure with `leaves` (in `_leaves`' order) in place."""
    cam = params["camera"]
    names = [f.name for f in dataclasses.fields(cam)]
    return {"tex_color": leaves[0],
            "camera": dataclasses.replace(cam, **dict(zip(names,
                                                          leaves[1:])))}


def apply_params(scene: S.Scene, params: dict) -> S.Scene:
    """The scene with `params` installed, out of place; the emission of each
    light row tied to a texture row (`light_tex`) is that row's colour."""
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
        camera=params["camera"])


def _sample_sum(scene: S.Scene, cfg, pixel_idx, seed: int, s0: int,
                n: int, split=None):
    """Sum of samples s0 .. s0 + n - 1 of each pixel: [N, 3]."""
    acc = torch.zeros((pixel_idx.shape[0], 3), dtype=torch.float32,
                      device=scene.device)
    for i in range(n):
        acc = acc + trace_paths(scene, cfg, pixel_idx, s0 + i, seed, split)
    return acc


def render_for_grad(params: dict, scene: S.Scene, cfg, pixel_idx, seed: int,
                    n_samples: int, split=None):
    """The differentiable estimator: the mean radiance of `n_samples`
    samples of each pixel in `pixel_idx`, [N, 3].  cfg.differentiable must
    be True for gradients to be right.  `split`: the split tier's mode
    (integrator.bounce_step; None: chosen by the backend)."""
    sc = apply_params(scene, params)
    return (_sample_sum(sc, cfg, pixel_idx, seed, 0, n_samples, split)
            / float(np.float32(n_samples)))


def _check_cfg(cfg) -> None:
    if not cfg.differentiable:
        raise ValueError("cfg.differentiable must be True for gradients")


def _with_grad(params: dict):
    """(leaf tensors that require grad, params built on them)."""
    leaves = [t.detach().requires_grad_() for t in _leaves(params)]
    return leaves, _unflatten(params, leaves)


def _grads(out, leaves, params: dict, grad_outputs=None) -> dict:
    """d out / d leaves in `params`' structure (zeros for an unused leaf)."""
    g = torch.autograd.grad(out, leaves, grad_outputs=grad_outputs,
                            allow_unused=True)
    return _unflatten(params, [torch.zeros_like(t) if gi is None else gi
                               for t, gi in zip(leaves, g)])


def _tree_add(a: dict, b: dict) -> dict:
    return _unflatten(a, [x + y for x, y in zip(_leaves(a), _leaves(b))])


def make_loss_and_grad(scene: S.Scene, cfg, n_samples: int, split=None):
    """fn(params, target, pixel_idx, seed) -> (loss, grads): the mean
    squared error of `render_for_grad` against `target` [N, 3] and its
    gradient, in params' structure."""
    _check_cfg(cfg)

    def fn(params, target, pixel_idx, seed):
        leaves, p = _with_grad(params)
        img = render_for_grad(p, scene, cfg, pixel_idx, seed, n_samples,
                              split)
        loss = torch.mean((img - target) ** 2)
        return loss.detach(), _grads(loss, leaves, params)

    return fn


def make_loss_and_grad_chunked(scene: S.Scene, cfg, n_samples: int,
                               spp_chunk: int, split=None):
    """The loss and gradient of `make_loss_and_grad` with memory constant
    in n_samples: samples in chunks of `spp_chunk`, one backward per chunk
    (with cfg.remat, each chunk's bounces are checkpointed too).

    The MSE couples samples only through the mean image, so
        dL/dp = sum over chunks of vjp(chunk sum)(cot) / n_samples,
    cot = 2 (img - target) / (N pixels * 3).  Pass 1 sums the image under
    torch.no_grad(); pass 2 renders each chunk again with autograd and
    runs its backward against the fixed cotangent.  Peak memory is one
    chunk's backward; the cost, one more forward per chunk.

    Returns fn(params, target, pixel_idx, seed) -> (loss, grads)."""
    _check_cfg(cfg)
    chunks, s0 = [], 0
    while s0 < n_samples:
        chunks.append((s0, min(spp_chunk, n_samples - s0)))
        s0 += chunks[-1][1]

    def fn(params, target, pixel_idx, seed):
        n = pixel_idx.shape[0]
        with torch.no_grad():
            sc = apply_params(scene, params)
            img = torch.zeros((n, 3), dtype=torch.float32,
                              device=scene.device)
            for c0, ns in chunks:
                img = img + _sample_sum(sc, cfg, pixel_idx, seed, c0, ns,
                                        split)
            img = img / float(np.float32(n_samples))
            loss = torch.mean((img - target) ** 2)
            cot = 2.0 * (img - target) / float(np.float32(n * 3 * n_samples))
        grads = None
        for c0, ns in chunks:
            leaves, p = _with_grad(params)
            part = _sample_sum(apply_params(scene, p), cfg, pixel_idx, seed,
                               c0, ns, split)
            g = _grads(part, leaves, params, grad_outputs=cot)
            grads = g if grads is None else _tree_add(grads, g)
        return loss, grads

    return fn


def finite_difference_check(scene: S.Scene, cfg, pixel_idx, seed: int,
                            n_samples: int, select, eps=1e-3):
    """(analytic, numeric): the gradient of the summed estimator with
    respect to one scalar parameter, by autograd and by central finite
    differences of the same estimator (the same samples), for tests.
    `select` is (get, put): get(params) -> scalar tensor, put(params, v) ->
    params with that scalar replaced by v."""
    get, put = select
    params = extract_params(scene)

    def scalar(v):
        return render_for_grad(put(params, v), scene, cfg, pixel_idx, seed,
                               n_samples).sum()

    v0 = get(params).detach()
    v = v0.clone().requires_grad_()
    analytic = torch.autograd.grad(scalar(v), v)[0]
    with torch.no_grad():
        numeric = (scalar(v0 + eps) - scalar(v0 - eps)) / (2 * eps)
    return float(analytic), float(numeric)
