"""The plain denoiser: the first-hit G-buffer and the edge-avoiding
à-trous wavelet filter (Dammertz et al., HPG 2010), in plain torch, as
the benchmark's reference for a denoised frame.

What it computes for a linear image [ny, nx, 3] (row 0 at the bottom):

- the G-buffer: one ray a pixel through the pixel's centre (no lens
  offset), at the shutter's mid-time, every volume's free-flight uniform
  0.5; its first hit by the plain sweep over every primitive
  (`intersect.intersect_scene`); the albedo from the winner's shading
  record with the bilinear RGB8 image fetch; a miss gives albedo 1 and
  normal 0;
- the display image: the linear image clamped to [0, 1], raised to
  1 / gamma (the reference viewer's LDR position);
- `iterations` passes; pass i takes the 5x5 B3-spline taps 2^i pixels
  apart, their rows and columns clamped to the image, each weighted by
  the tap's B3 product and by exp(-d / (2 sigma^2)) for three distances:
  the colour's, Weber-normalised (|c - c'|^2 over (sum(c + c') + 0.01)^2,
  sigma 0.5 halved each pass), the albedo's (|a - a'|^2, sigma 0.13) and
  the normal's (|n - n'|^2, sigma 0.25); the weighted mean (the weights'
  sum held above 1e-8) is the next image.

`round_to` runs the control: the display image and each pass's image
rounded to that dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from . import intersect as I
from . import vec as V
from .shading import gather_shade, resolve_albedo
from .vec import Vec3

# the B3-spline's 5 taps
B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
SIGMA_COLOR = 0.5
SIGMA_ALBEDO = 0.13
SIGMA_NORMAL = 0.25


def gbuffer(scene, cfg):
    """(albedo [ny, nx, 3], normal [ny, nx, 3], the hit primitive [ny, nx],
    -1 where the ray misses) on the scene's device."""
    n = cfg.nx * cfg.ny
    dev = scene.device
    cam = scene.camera
    pix = torch.arange(n, device=dev)
    s = ((pix % cfg.nx).to(torch.float32) + 0.5) / float(np.float32(cfg.nx))
    t = ((pix // cfg.nx).to(torch.float32) + 0.5) / float(np.float32(cfg.ny))
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
    hit = I.intersect_scene(scene, origin, direction, cfg.t_min, tmax, time,
                            vol_u)
    mask = hit.prim_idx >= 0
    shade = gather_shade(scene, hit.prim_idx, mask)
    albedo = resolve_albedo(scene, shade, hit.point, hit.u, hit.v, "rgb8")
    albedo = V.where(mask, albedo, V.ones(n, dev)).stack()
    normal = V.where(mask, hit.normal, V.zeros(n, dev)).stack()
    shape = (cfg.ny, cfg.nx)
    return (albedo.reshape(*shape, 3), normal.reshape(*shape, 3),
            hit.prim_idx.reshape(shape))


def _clamped(n: int, step: int, device) -> list:
    """The 5 taps' indices along an axis of n, `step` apart, clamped."""
    at = torch.arange(n, device=device)
    return [torch.clamp(at + (k - 2) * step, 0, n - 1) for k in range(5)]


def _sq_dist(a, b):
    return ((a - b) ** 2).sum(dim=-1, keepdim=True)


def atrous(img, albedo, normal, iterations: int, round_to=None):
    """The filtered [H, W, 3] image of `img` (float32 [H, W, 3]) guided by
    `albedo` and `normal` (float32 [H, W, 3] each)."""
    h, w = img.shape[0], img.shape[1]
    out = img
    sigma = SIGMA_COLOR
    for it in range(iterations):
        rows = _clamped(h, 1 << it, img.device)
        cols = _clamped(w, 1 << it, img.device)
        acc = torch.zeros_like(out)
        wsum = torch.zeros_like(out[..., :1])
        for ky in range(5):
            for kx in range(5):
                def tap(x):
                    return x[rows[ky]][:, cols[kx]]
                c = tap(out)
                weber = (out + c).sum(dim=-1, keepdim=True) + 1e-2
                d_col = _sq_dist(out, c) / (weber * weber)
                wgt = (B3[ky] * B3[kx]
                       * torch.exp(-d_col / (2.0 * sigma * sigma))
                       * torch.exp(-_sq_dist(albedo, tap(albedo))
                                   / (2.0 * SIGMA_ALBEDO ** 2))
                       * torch.exp(-_sq_dist(normal, tap(normal))
                                   / (2.0 * SIGMA_NORMAL ** 2)))
                acc = acc + wgt * c
                wsum = wsum + wgt
        out = acc / torch.clamp_min(wsum, 1e-8)
        if round_to is not None:
            out = out.to(round_to).to(torch.float32)
        sigma *= 0.5
    return out


def denoise(img, albedo, normal, gamma: float, iterations: int,
            round_to=None):
    """The denoised display image of the linear image `img` ([H, W, 3])
    with its G-buffer's `albedo` and `normal`."""
    disp = torch.clamp(img, 0.0, 1.0) ** (1.0 / gamma)
    if round_to is not None:
        disp = disp.to(round_to).to(torch.float32)
    return atrous(disp, albedo, normal, iterations, round_to)
