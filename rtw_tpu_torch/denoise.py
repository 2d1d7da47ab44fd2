"""Post-process denoiser: edge-avoiding à-trous wavelet filtering (port of
rtw_tpu/denoise.py).

The reference's classical, clearly non-parity replacement for the OptiX
LDR denoiser of the CUDA original: the edge-avoiding à-trous transform of
Dammertz et al. (HPG 2010), guided by a first-hit G-buffer (albedo and
shading normal) from `primary_features`, one deterministic
centre-of-pixel camera ray per pixel.

The filter runs one pass per iteration.  On CUDA tensors each pass is one
launch of the hand-written kernel `csrc/denoise_kernel.cu` (`atrous_pass`,
through `LIB`, a utils/kernels.Library), made inside the dispatcher
operation `rtw_tpu_torch::atrous_pass` so that a profiler ties the kernel
to an operation; on CPU tensors it is its plain twin
`atrous_pass_plain`, torch on [H, W] planes, the reference's jitted jnp
pass written out.

`primary_features` finds its hits with the split tier's trace query
(ops/trace_kernel.trace) on the scene's tables: on a CUDA scene that is
one launch of kernel B, on a CPU scene its plain version, the reference's
`intersect_scene` sweep.  The albedo comes from the winner's shading
record through `shading.resolve_albedo`, with the reference's
deterministic bilinear RGB8 image fetch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rtw_tpu_torch.models import scene as S
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.ops import vec as V
from rtw_tpu_torch.ops.shading import resolve_albedo
from rtw_tpu_torch.ops.vec import Vec3
from rtw_tpu_torch.utils import kernels

# 5-tap B3-spline: the à-trous generating kernel
_B3 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0

# csrc/denoise_kernel.cu's C interface: img, albedo, normal (either may be
# null), out, h, w, step and the three float scalars
_F = ctypes.c_float
LIB = kernels.Library("denoise_kernel", {
    "rtw_atrous": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [_F] * 3})
# The registration of the dispatcher operation around each launch, made by
# `_atrous_op()` at the first launch and kept for the process's life.
_ops: torch.library.Library | None = None


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


def atrous_pass_plain(img, albedo, normal, step: int, sc: float,
                      sigma_albedo: float, sigma_normal: float):
    """One à-trous pass in plain torch: the 5x5 B3 kernel with holes `step`
    over `img` [H, W, 3], each tap weighted by the Weber-normalised colour
    distance (sigma `sc`) and, where given, the albedo and normal
    distances.  The contract of `csrc/denoise_kernel.cu`."""
    acc = torch.zeros_like(img)
    wsum = torch.zeros(img.shape[:2] + (1,), dtype=torch.float32,
                       device=img.device)
    inv_2sc2 = 1.0 / (2.0 * sc * sc)
    for ky in range(5):
        for kx in range(5):
            dy = (ky - 2) * step
            dx = (kx - 2) * step
            h = float(_B3[ky] * _B3[kx])
            c = _shift(img, dy, dx)
            scale = torch.sum(img + c, dim=-1, keepdim=True) + 1e-2
            d2 = (torch.sum((img - c) ** 2, dim=-1, keepdim=True)
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
    return acc / torch.clamp_min(wsum, 1e-8)


def atrous_pass(img, albedo, normal, step: int, sc: float,
                sigma_albedo: float, sigma_normal: float):
    """One pass of `atrous_pass_plain`'s contract through
    `csrc/denoise_kernel.cu` on CUDA tensors: one launch on the current
    stream into a new tensor (a pass's output is freed two passes on, so
    the caching allocator hands the passes two buffers in turn), inside
    the dispatcher operation `rtw_tpu_torch::atrous_pass`, so that a
    profiler links the launch to an operation as it does torch's own.
    Raises on anything the kernel does not take."""
    if not torch.is_tensor(img) or img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"atrous: img must be an [H, W, 3] tensor, got "
                         f"{getattr(img, 'shape', type(img))}")
    dev, shape = img.device, tuple(img.shape)
    kernels.check("atrous", dev, [
        (name, t, torch.float32, shape) for name, t in (
            ("img", img), ("albedo", albedo), ("normal", normal))
        if t is not None])
    if dev.type != "cuda":
        raise ValueError(f"atrous: the image is on {dev}; the kernel takes "
                         f"CUDA tensors (atrous_pass_plain is the CPU's)")
    # the f32 scalars torch's kernels take from the plain pass's Python
    # floats; the kernel divides by the last two as torch's CUDA division by
    # a scalar does, through the float reciprocal
    f32 = [float(np.float32(v)) for v in (1.0 / (2.0 * sc * sc),
                                          2.0 * sigma_albedo ** 2,
                                          2.0 * sigma_normal ** 2)]
    return _atrous_op()(img, albedo, normal, step, *f32)


def _launch(img, albedo, normal, step, inv_2sc2, two_sa2, two_sn2):
    """The CUDA kernel of `rtw_tpu_torch::atrous_pass`: one launch of
    `rtw_atrous` on planes `atrous_pass` has checked."""
    out = torch.empty_like(img)
    LIB.launch("rtw_atrous", img.device, img.data_ptr(),
               None if albedo is None else albedo.data_ptr(),
               None if normal is None else normal.data_ptr(), out.data_ptr(),
               img.shape[0], img.shape[1], step, inv_2sc2, two_sa2, two_sn2)
    return out


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
    themselves.

    The planes are taken as contiguous float32 on the image's device.  On
    the CPU each iteration is `atrous_pass_plain`; on CUDA each is one
    launch of `csrc/denoise_kernel.cu` (`atrous_pass`)."""
    img = torch.as_tensor(img, dtype=torch.float32).contiguous()
    albedo, normal = (None if g is None else torch.as_tensor(
        g, dtype=torch.float32, device=img.device).contiguous()
        for g in (albedo, normal))
    one_pass = atrous_pass_plain if img.device.type == "cpu" else atrous_pass
    out, sc = img, sigma_color
    for it in range(iterations):
        out = one_pass(out, albedo, normal, 1 << it, sc, sigma_albedo,
                       sigma_normal)
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


def _atrous_op():
    """`torch.ops.rtw_tpu_torch.atrous_pass`, defined at first use with
    `_launch` as its CUDA kernel (it has no other)."""
    global _ops
    if _ops is None:
        ops = torch.library.Library("rtw_tpu_torch", "FRAGMENT")
        ops.define("atrous_pass(Tensor img, Tensor? albedo, Tensor? normal, "
                   "int step, float inv_2sc2, float two_sa2, float two_sn2)"
                   " -> Tensor")
        ops.impl("atrous_pass", _launch, "CUDA")
        _ops = ops
    return torch.ops.rtw_tpu_torch.atrous_pass
