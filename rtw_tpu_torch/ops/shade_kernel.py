"""The split tier's bounce step in two hand-written CUDA kernels around the
shadow query: E (`shade`) after the trace kernel B and F (`finish`) after
the occlusion kernel C (csrc/shade_kernel.cu).

Neither replaces a Pallas kernel: together with B and C they are the
counterpart of the XLA fusion that runs the reference's `bounce_step`
(rtw_tpu/integrator.py:212) inside `jit`, where the port ran the same
physics as ~1100 eager torch launches an iteration.

- E reads B's output rows (`trace_kernel.trace_rows`), the path state, the
  bounce's uniform block `U` and the scene's `ShadeTables`, and computes
  per lane what `resolve_albedo` and `bounce_core` compute with
  `env.occlude` None: the albedo of every texture kind and filter, the sky
  on a miss, every material, the book mixture, the MIS weight of a light
  hit, the NEE set-up over the scene's lights, the advance and Russian
  roulette.  It writes the next state (the radiance before NEE), the
  shadow ray and each lane's NEE term `thr * nee`.
- F adds the NEE term where the shadow query was active and C found no
  occluder (`bounce.finish_nee`).

The plain versions (`shade_plain`, `finish_plain`) are those functions
themselves, planes in and planes out, so the kernels are held against the
same code the torch glue runs.  On CPU tensors the wrappers run them; on
CUDA tensors they launch the kernel or raise.  The gradient path never
reaches them (integrator.bounce_step): E has no backward.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from rtw_tpu_torch.models import scene as S
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.ops.bounce import (BounceResult, PathState, bounce_core,
                                      check_estimator, finish_nee, scene_env,
                                      single_light)
from rtw_tpu_torch.ops.shading import resolve_albedo, tex_row
from rtw_tpu_torch.ops.vec import Vec3
from rtw_tpu_torch.utils import kernels
from rtw_tpu_torch.utils import rng as R

# E's float output rows: origin, direction, throughput, radiance before
# NEE, prev_pdf, then (where the bounce has NEE) the shadow ray's origin,
# direction and tmax and the NEE term; bool rows: alive, prev_diffuse.
O_ORG, O_DIR, O_THR, O_RAD, O_PPDF = 0, 3, 6, 9, 12
O_SORG, O_SDIR, O_STMAX, O_NEE = 13, 16, 19, 20
OUT_F32 = 23
OB_ALIVE, OB_PREVD = 0, 1
# Columns of the light table: position, vec_u, vec_v, emission, area,
# normal (the scene's Lights rows).
L_POS, L_U, L_V, L_EMIT, L_AREA, L_NRM = 0, 3, 6, 9, 12, 13
LIGHT_COLS = 16
# Columns of the image table: height, width, first word in the atlas.
IMAGE_COLS = 3
# csrc/shade_kernel.cu's filter ids; any other name is the RGB8 bilinear
# fetch, as in shading._image_eval
FILTERS = {"stoch565": 0, "rgb565": 1, "nearest565": 2}
FILTER_RGB8 = 3

# Launches of each CUDA kernel since import (or since a caller reset them).
shade_launches = 0
finish_launches = 0
# The bound kernel library, loaded by `library()` at the first launch.
_lib: ctypes.CDLL | None = None


@dataclasses.dataclass
class ShadeTables:
    """The scene's tables E reads, on the scene's device, built once per
    render (`shade_tables`): the light rows, each prim's light row (-1: no
    light), the image rows and the two atlases as int32 words, and the sky
    gate as a Python float."""

    lights: torch.Tensor      # float32 [max(L, 1), LIGHT_COLS]
    light_row: torch.Tensor   # int32 [P]
    images: torch.Tensor      # int32 [max(n_images, 1), IMAGE_COLS]
    atlas8: torch.Tensor      # int32 [max(words, 1)]: 0x00BBGGRR texels
    atlas565: torch.Tensor    # int32 [max(words, 1)]: RGB565 pairs
    sky: float


def _words(packed, dev):
    """An atlas's uint32 words as an int32 tensor of at least one word."""
    w = packed.reshape(-1).view(torch.int32)
    return (w if w.numel() else torch.zeros(1, dtype=torch.int32,
                                            device=dev)).contiguous()


def shade_tables(scene: S.Scene) -> ShadeTables:
    """E's tables, built from the scene (one host read: the sky gate)."""
    dev = scene.device
    lt = scene.lights
    with torch.no_grad():
        rows = torch.cat([lt.position, lt.vec_u, lt.vec_v, lt.emission,
                          lt.area.reshape(-1, 1), lt.normal], dim=1)
        tex = scene.textures
        images = torch.stack([tex.image_dims[:, 0], tex.image_dims[:, 1],
                              tex.image_offset], dim=1)
    if rows.shape[0] == 0:
        rows = torch.zeros((1, LIGHT_COLS), dtype=torch.float32, device=dev)
    if images.shape[0] == 0:
        images = torch.zeros((1, IMAGE_COLS), dtype=torch.int32, device=dev)
    return ShadeTables(
        lights=rows.to(torch.float32).detach().contiguous(),
        light_row=scene.prims.light_row_p.to(torch.int32).contiguous(),
        images=images.to(torch.int32).contiguous(),
        atlas8=_words(tex.images_packed, dev),
        atlas565=_words(tex.images_packed565, dev),
        sky=float(scene.sky_light))


def has_nee(scene: S.Scene, cfg) -> bool:
    """Whether `bounce_core` runs NEE for this render (`BounceEnv.nee`)."""
    return scene_env(scene, cfg).nee


def shade_plain(scene: S.Scene, cfg, of, oi, state: PathState, depth,
                U) -> BounceResult:
    """E's contract in plain torch: `resolve_albedo` and `bounce_core` (its
    shadow query deferred) on B's rows `of`, `oi`, the path state, the
    bounce's depth (an int or [N] plane) and uniforms U [n_slots, N].
    Returns the next state (the radiance before NEE) and, where the bounce
    has NEE (`has_nee`), the shadow ray and each lane's NEE term."""
    hit, shade = TK._unpack_hit(of, oi)
    row = tex_row(scene, cfg)
    albedo = resolve_albedo(scene, shade, hit.point, hit.u, hit.v,
                            cfg.tex_filter, cfg.tex_tile_gate,
                            U[row] if row >= 0 else None)
    return bounce_core(scene_env(scene, cfg), U, depth, state.alive,
                       state.origin, state.direction, state.time,
                       state.throughput, state.radiance, state.prev_pdf,
                       state.prev_diffuse,
                       hit.prim_idx < 0, hit.point, hit.normal,
                       shade.mat_type, shade.fuzz, shade.eta, albedo,
                       hit.prim_idx)


# F's contract in plain torch
finish_plain = finish_nee


class _CShadeParams(ctypes.Structure):
    """E's by-value parameters (ShadeParams in csrc/shade_kernel.cu; every
    member is 4 bytes, so no padding)."""

    _fields_ = [("sky", ctypes.c_float), ("n_lights", ctypes.c_int32),
                ("mat_present", ctypes.c_int32),
                ("tex_present", ctypes.c_int32),
                ("tex_filter", ctypes.c_int32), ("book", ctypes.c_int32),
                ("nee", ctypes.c_int32), ("mis_weight", ctypes.c_int32),
                ("single_light", ctypes.c_int32),
                ("rr_start", ctypes.c_int32), ("tex_row", ctypes.c_int32)]


_P = ctypes.c_void_p


class _CShadeIO(ctypes.Structure):
    """E's planes (ShadeIO in csrc/shade_kernel.cu): one pointer each."""

    _fields_ = [("of", _P), ("oi", _P), ("org", _P * 3), ("dir", _P * 3),
                ("thr", _P * 3), ("rad", _P * 3), ("alive", _P),
                ("prev_pdf", _P), ("prevd", _P), ("depth", _P), ("u", _P),
                ("lights", _P), ("light_row", _P), ("images", _P),
                ("atlas8", _P), ("atlas565", _P), ("out_f", _P),
                ("out_b", _P), ("out_rays", _P)]


class _CFinishIO(ctypes.Structure):
    """F's planes (FinishIO in csrc/shade_kernel.cu)."""

    _fields_ = [("rad", _P * 3), ("nee", _P * 3), ("tmax", _P),
                ("occluded", _P), ("out", _P)]


def _check(who: str, dev, n: int, planes) -> None:
    """Each (name, tensor, dtype, shape or None for [n]) on `dev`, of its
    dtype and shape, contiguous; raise otherwise."""
    for name, t, dtype, shape in planes:
        if not torch.is_tensor(t):
            raise TypeError(f"{who}: {name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{who}: {name} is on {t.device}, the lanes on "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"{who}: {name} has dtype {t.dtype}, needs "
                            f"{dtype}")
        want = (n,) if shape is None else shape
        if want is not ... and tuple(t.shape) != want:
            raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                             f"needs {want}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


def _depth_plane(depth, n: int, dev):
    """The bounce's depth as an int64 [N] plane."""
    if torch.is_tensor(depth):
        return depth
    return torch.full((n,), int(depth), dtype=torch.int64, device=dev)


def _params(scene: S.Scene, cfg, env, tables: ShadeTables):
    """E's parameters: the branches `bounce_core` takes (the flags of its
    BounceEnv `env`) and the scene's presence bits."""
    p = _CShadeParams()
    p.sky = tables.sky
    p.n_lights = env.num_lights
    p.mat_present = sum(1 << m for m, on in enumerate(env.mat_present) if on)
    p.tex_present = sum(1 << t for t, on in enumerate(scene.tex_present)
                        if on)
    p.tex_filter = FILTERS.get(cfg.tex_filter, FILTER_RGB8)
    p.book = int(env.book)
    p.nee = int(env.nee)
    p.mis_weight = int(env.mis_weight)
    p.single_light = int(single_light(scene))
    p.rr_start = env.rr_start_depth
    p.tex_row = tex_row(scene, cfg)
    return p


def _call(fn, dev, *args):
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           f"{lib.rtw_shade_error_string(err).decode()} "
                           f"({err})")


def shade(scene: S.Scene, cfg, tables: ShadeTables | None, of, oi,
          state: PathState, depth, U) -> BounceResult:
    """E: the contract of `shade_plain`.  CPU tensors run `shade_plain`;
    CUDA tensors launch the kernel or raise.  `tables`: the scene's
    `ShadeTables`, built here when None."""
    global shade_launches
    check_estimator(cfg.estimator)
    TK.refuse_grad("shade", of=of, U=U, origin=state.origin,
                   direction=state.direction, throughput=state.throughput,
                   radiance=state.radiance, prev_pdf=state.prev_pdf)
    dev = of.device
    if dev.type == "cpu":
        return shade_plain(scene, cfg, of, oi, state, depth, U)
    if tables is None:
        tables = shade_tables(scene)
    n = of.shape[1]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    depth = _depth_plane(depth, n, dev)
    planes = [("of", of, f32, (TK.HIT_F32, n)), ("oi", oi, i32,
                                                   (TK.HIT_I32, n)),
              ("alive", state.alive, b8, None),
              ("prev_pdf", state.prev_pdf, f32, None),
              ("prev_diffuse", state.prev_diffuse, b8, None),
              ("depth", depth, torch.int64, None),
              ("U", U, f32, (U.shape[0], n)),
              ("lights", tables.lights, f32, ...),
              ("light_row", tables.light_row, i32, ...),
              ("images", tables.images, i32, ...),
              ("atlas8", tables.atlas8, i32, ...),
              ("atlas565", tables.atlas565, i32, ...)]
    for name in ("origin", "direction", "throughput", "radiance"):
        planes += [(f"{name}.{c}", t, f32, None)
                   for c, t in zip("xyz", getattr(state, name))]
    _check("shade", dev, n, planes)
    if U.shape[0] < R.NUM_FIXED_SLOTS or tex_row(scene, cfg) >= U.shape[0]:
        raise ValueError(f"shade: U has {U.shape[0]} rows, the bounce reads "
                         f"{max(R.NUM_FIXED_SLOTS, tex_row(scene, cfg) + 1)}")
    out_f = torch.empty((OUT_F32, n), dtype=f32, device=dev)
    out_b = torch.empty((2, n), dtype=b8, device=dev)
    out_r = torch.empty(n, dtype=i32, device=dev)
    io = _CShadeIO()
    io.of, io.oi = of.data_ptr(), oi.data_ptr()
    for field, v in (("org", state.origin), ("dir", state.direction),
                     ("thr", state.throughput), ("rad", state.radiance)):
        getattr(io, field)[:] = [c.data_ptr() for c in v]
    io.alive, io.prev_pdf = state.alive.data_ptr(), state.prev_pdf.data_ptr()
    io.prevd, io.depth = state.prev_diffuse.data_ptr(), depth.data_ptr()
    io.u = U.data_ptr()
    io.lights, io.light_row = (tables.lights.data_ptr(),
                               tables.light_row.data_ptr())
    io.images = tables.images.data_ptr()
    io.atlas8, io.atlas565 = (tables.atlas8.data_ptr(),
                              tables.atlas565.data_ptr())
    io.out_f, io.out_b, io.out_rays = (out_f.data_ptr(), out_b.data_ptr(),
                                       out_r.data_ptr())
    env = scene_env(scene, cfg)
    _call("rtw_shade", dev, io, n, _params(scene, cfg, env, tables))
    shade_launches += 1
    nee = env.nee
    rows, flags = out_f.unbind(0), out_b.unbind(0)

    def v3(r):
        return Vec3(*rows[r:r + 3]) if r < O_SORG or nee else None
    return BounceResult(origin=v3(O_ORG), direction=v3(O_DIR),
                        throughput=v3(O_THR), radiance=v3(O_RAD),
                        alive=flags[OB_ALIVE], prev_pdf=rows[O_PPDF],
                        prev_diffuse=flags[OB_PREVD], rays_lane=out_r,
                        shadow_org=v3(O_SORG), shadow_dir=v3(O_SDIR),
                        shadow_tmax=rows[O_STMAX] if nee else None,
                        nee=v3(O_NEE))


def finish(radiance: Vec3, nee: Vec3, shadow_tmax, occluded) -> Vec3:
    """F: the contract of `finish_plain`.  CPU tensors run `finish_plain`;
    CUDA tensors launch the kernel or raise."""
    global finish_launches
    TK.refuse_grad("finish", radiance=radiance, nee=nee,
                   shadow_tmax=shadow_tmax)
    dev = shadow_tmax.device
    if dev.type == "cpu":
        return finish_plain(radiance, nee, shadow_tmax, occluded)
    n = shadow_tmax.shape[0]
    f32 = torch.float32
    _check("finish", dev, n,
           [*((f"radiance.{c}", t, f32, None)
              for c, t in zip("xyz", radiance)),
            *((f"nee.{c}", t, f32, None) for c, t in zip("xyz", nee)),
            ("shadow_tmax", shadow_tmax, f32, None),
            ("occluded", occluded, torch.bool, None)])
    out = torch.empty((3, n), dtype=f32, device=dev)
    io = _CFinishIO()
    io.rad[:] = [c.data_ptr() for c in radiance]
    io.nee[:] = [c.data_ptr() for c in nee]
    io.tmax, io.occluded = shadow_tmax.data_ptr(), occluded.data_ptr()
    io.out = out.data_ptr()
    _call("rtw_shade_finish", dev, io, n)
    finish_launches += 1
    return Vec3(out[0], out[1], out[2])


def library() -> ctypes.CDLL:
    """csrc/shade_kernel.cu, built at first use and bound to its C
    interface."""
    global _lib
    if _lib is not None:
        return _lib
    lib = kernels.load("shade_kernel")
    lib.rtw_shade.restype = ctypes.c_int
    lib.rtw_shade.argtypes = [_CShadeIO, ctypes.c_int, _CShadeParams,
                              ctypes.c_void_p]
    lib.rtw_shade_finish.restype = ctypes.c_int
    lib.rtw_shade_finish.argtypes = [_CFinishIO, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.rtw_shade_error_string.restype = ctypes.c_char_p
    lib.rtw_shade_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib
