"""Post-process denoiser: edge-avoiding à-trous wavelet filtering (port of
rtw_tpu/denoise.py).

The reference's classical, clearly non-parity replacement for the OptiX
LDR denoiser of the CUDA original: the edge-avoiding à-trous transform of
Dammertz et al. (HPG 2010), guided by a first-hit G-buffer (albedo and
shading normal) from `primary_features`, one deterministic
centre-of-pixel camera ray per pixel.  The filter is plain torch on
[H, W] planes on the image's device (the reference has no kernel here).

`primary_features` finds its hits with the split tier's trace query
(ops/trace_kernel.trace) on the scene's tables: on a CUDA scene that is
one launch of kernel B, on a CPU scene its plain version, the reference's
`intersect_scene` sweep.  The albedo comes from the winner's shading
record through `shading.resolve_albedo`, with the reference's
deterministic bilinear RGB8 image fetch.
"""

from __future__ import annotations

import numpy as np
import torch

from rtw_tpu_torch.models import scene as S
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.ops import vec as V
from rtw_tpu_torch.ops.shading import resolve_albedo
from rtw_tpu_torch.ops.vec import Vec3

# 5-tap B3-spline: the à-trous generating kernel
_B3 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def primary_features(scene: S.Scene, cfg):
    """First-hit G-buffer: (albedo [H,W,3], normal [H,W,3], hit [H,W]) on
    the scene's device.

    Centre-of-pixel rays, no lens offset, shutter mid-time, volume
    free-flight uniform 0.5: deterministic."""
    n = cfg.num_pixels
    dev = scene.device
    cam = scene.camera
    pixel_idx = torch.arange(n, dtype=torch.int32, device=dev)
    x = (pixel_idx % cfg.nx).to(torch.float32)
    y = (pixel_idx // cfg.nx).to(torch.float32)
    s = (x + 0.5) / float(np.float32(cfg.nx))
    t = (y + 0.5) / float(np.float32(cfg.ny))

    origin = V.v3(cam.origin)
    direction = (V.v3(cam.lower_left) + V.v3(cam.horizontal) * s
                 + V.v3(cam.vertical) * t - origin)
    origin = Vec3(*(c.expand(n).contiguous() for c in origin))
    time = torch.full((n,), float(0.5 * float(cam.time0 + cam.time1)),
                      dtype=torch.float32, device=dev)
    tmax = torch.full((n,), float(np.float32(cfg.t_max)),
                      dtype=torch.float32, device=dev)
    vol_u = torch.full((max(scene.n_vol, 1), n), 0.5, dtype=torch.float32,
                       device=dev)

    with torch.no_grad():
        hit, shade = TK.trace(scene, origin, direction, cfg.t_min, tmax,
                              time, vol_u)
        albedo = resolve_albedo(scene, shade, hit.point, hit.u, hit.v,
                                tex_filter="rgb8")
    mask = hit.prim_idx >= 0
    alb = V.where(mask, albedo, V.ones(n, dev)).stack().reshape(
        cfg.ny, cfg.nx, 3)
    nrm = V.where(mask, hit.normal, V.zeros(n, dev)).stack().reshape(
        cfg.ny, cfg.nx, 3)
    return alb, nrm, mask.reshape(cfg.ny, cfg.nx)


def _shift(img, dy: int, dx: int):
    """Edge-clamped shift: out[y, x] = img[clamp(y+dy), clamp(x+dx)]."""
    h, w = img.shape[0], img.shape[1]
    rows = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[rows][:, cols]


def atrous(img, albedo=None, normal=None, iterations: int = 5,
           sigma_color: float = 0.5, sigma_albedo: float = 0.13,
           sigma_normal: float = 0.25):
    """Edge-avoiding à-trous wavelet filter (Dammertz et al. 2010).

    img: [H, W, 3] (a tensor, or an array put on the CPU).  Optional
    guidance buffers from `primary_features`.  Each iteration applies the
    5x5 B3 kernel with holes (step 2^i) weighted by colour, albedo and
    normal similarity; the colour sigma halves per iteration, as in the
    paper.  The colour distance is Weber-normalised (relative to the local
    brightness) so HDR fireflies don't disable the filter around
    themselves."""
    img = torch.as_tensor(img, dtype=torch.float32)
    albedo = None if albedo is None else torch.as_tensor(
        albedo, dtype=torch.float32, device=img.device)
    normal = None if normal is None else torch.as_tensor(
        normal, dtype=torch.float32, device=img.device)
    out = img
    sc = sigma_color
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=torch.float32,
                           device=out.device)
        inv_2sc2 = 1.0 / (2.0 * sc * sc)
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                h = float(_B3[ky] * _B3[kx])
                c = _shift(out, dy, dx)
                scale = torch.sum(out + c, dim=-1, keepdim=True) + 1e-2
                d2 = (torch.sum((out - c) ** 2, dim=-1, keepdim=True)
                      / (scale * scale))
                w = h * torch.exp(-d2 * inv_2sc2)
                if albedo is not None:
                    da = torch.sum((albedo - _shift(albedo, dy, dx)) ** 2,
                                   dim=-1, keepdim=True)
                    w = w * torch.exp(-da / (2.0 * sigma_albedo ** 2))
                if normal is not None:
                    dn = torch.sum((normal - _shift(normal, dy, dx)) ** 2,
                                   dim=-1, keepdim=True)
                    w = w * torch.exp(-dn / (2.0 * sigma_normal ** 2))
                acc = acc + w * c
                wsum = wsum + w
        out = acc / torch.clamp_min(wsum, 1e-8)
        sc = sc * 0.5
    return out


def denoise(img, scene: S.Scene = None, cfg=None, iterations: int = 5,
            mode: str = "ldr", gamma: float = 2.0):
    """Denoise a render; with (scene, cfg) the first-hit G-buffer guides the
    edge-stopping functions (recommended).

    mode="ldr" (default) filters in display space (clamp + gamma), the
    LDR semantics of the reference's denoiser position; the returned
    image is display-space in [0, 1] (encode it with `to_srgb8` at gamma
    1).  mode="hdr" filters the linear radiance and returns linear
    values."""
    alb = nrm = None
    if scene is not None and cfg is not None:
        alb, nrm, _ = primary_features(scene, cfg)
    img = torch.as_tensor(img, dtype=torch.float32)
    if mode == "ldr":
        disp = torch.clamp(img, 0.0, 1.0) ** (1.0 / gamma)
        return atrous(disp, albedo=alb, normal=nrm, iterations=iterations)
    if mode == "hdr":
        return atrous(img, albedo=alb, normal=nrm, iterations=iterations)
    raise ValueError(f"mode must be 'ldr' or 'hdr', got {mode!r}")
