"""The split tier's trace and occlusion kernels (port of the host side of
rtw_tpu/ops/trace_kernel.py: `trace_pallas`, `occluded_pallas` and the
props table).

`trace` is the nearest-hit query with its shading record and `occluded_kernel`
the any-hit shadow query.  On CUDA tensors each launches its hand-written
kernel of csrc/trace_kernel.cu (built by utils/kernels.py) on the current
stream; on CPU tensors each runs its plain version, `trace_plain`
(intersect_scene + gather_shade) or `occluded_plain`.  There is no
fallback: a CUDA tensor gets the kernel or an error.  Volumes read their
free-flight uniforms from `vol_u` [max(n_vol, 1), N] (the shadow ray's own
rows for the occlusion query), row `max(vol_slot, 0)` of each volume prim.

The props layout and `build_props` are the reference's; the megakernel
(csrc/mega_kernel.cu) reads the same table.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from rtw_tpu_torch.models import scene as S
from rtw_tpu_torch.ops import intersect as I
from rtw_tpu_torch.ops.shading import ShadeRec, gather_shade
from rtw_tpu_torch.ops.vec import Vec3
from rtw_tpu_torch.utils import kernels

# Props-table column layout (float32 matrix [P, K])
P9 = list(range(9))
MAT, FUZZ, ETA, TEXT, SCALE, IMG = 9, 10, 11, 12, 13, 14
RGB = (15, 16, 17)
ODD = (18, 19, 20)
EVEN = (21, 22, 23)
MID = 24               # material row id (Materials table index)
KBASE = 25
W2O = KBASE            # +12 when any_xform
O2W = KBASE + 12

PLAN_COLS = 7          # (start, count, size, ptype, axis, has_xform, block)
# Rows of the trace kernel's outputs: f32 (t, point, normal, u, v, fuzz,
# eta, scale, rgb, odd, even) and i32 (prim, mat_type, tex_type, image_id,
# mat_id), the reference's `_write_hit` layout.
HIT_F32 = 21
HIT_I32 = 5

# Launches of each CUDA kernel since import (or since a caller reset them).
trace_launches = 0
occluded_launches = 0
# The bound kernel library, loaded by `library()` at the first launch.
_lib: ctypes.CDLL | None = None


def build_props(scene: S.Scene, any_xform: bool):
    """The [P, K] float32 per-prim property matrix (K = 25, or 49 with the
    w2o and o2w transforms), on the scene's device."""
    pr = scene.prims
    f32 = torch.float32
    cols = [pr.params[:, k] for k in P9]
    cols += [pr.mat_type_p.to(f32), pr.fuzz_p, pr.eta_p,
             pr.tex_type_p.to(f32), pr.scale_p, pr.image_id_p.to(f32)]
    col = scene.textures.color
    cols += [col[:, k][pr.tex_idx] for k in range(3)]
    cols += [col[:, k][pr.odd_idx] for k in range(3)]
    cols += [col[:, k][pr.even_idx] for k in range(3)]
    cols += [pr.material_id.to(f32)]
    if any_xform:
        cols += [pr.w2o[:, i, j] for i in range(3) for j in range(4)]
        cols += [pr.o2w[:, i, j] for i in range(3) for j in range(4)]
    return torch.stack(cols, dim=1).contiguous()


def check_plan(scene: S.Scene) -> None:
    """Every plan entry must be a prim type the kernels implement (all six;
    csrc/geometry.cuh::prim_t)."""
    for e in scene.chunk_plan:
        I.check_prim_type(e[3])


class _CTraceParams(ctypes.Structure):
    """The kernels' by-value parameter struct (TraceParams in
    csrc/trace_kernel.cu; every member is 4 bytes, so no padding)."""

    _fields_ = [("tmin", ctypes.c_float), ("n_entries", ctypes.c_int32),
                ("n_blocks", ctypes.c_int32), ("kdim", ctypes.c_int32)]


@dataclasses.dataclass
class SplitTables:
    """The scene's tables both kernels read, on the scene's device: the
    props table, the chunk plan, the block AABBs [B, 8] and the per-prim
    volume slot.  A render builds them once (`split_tables`) and passes
    them to every launch."""

    props: torch.Tensor       # float32 [P, K]
    plan: torch.Tensor        # int32 [E, PLAN_COLS]
    aabbs: torch.Tensor       # float32 [B, 8]
    vol_slot: torch.Tensor    # int32 [P]; -1 off volumes


def plan_table(scene: S.Scene):
    """The chunk plan as an int32 [E, PLAN_COLS] tensor on the scene's
    device."""
    return torch.tensor([list(map(int, e)) for e in scene.chunk_plan],
                        dtype=torch.int32, device=scene.device)


def split_tables(scene: S.Scene) -> SplitTables:
    check_plan(scene)
    props = build_props(scene, any(e[5] for e in scene.chunk_plan))
    plan = plan_table(scene)
    aabbs = scene.block_aabbs.to(torch.float32).contiguous()
    n_blocks = sum(e[2] // e[6] for e in scene.chunk_plan)
    if aabbs.shape != (n_blocks, 8):
        raise ValueError(f"block_aabbs has shape {tuple(aabbs.shape)}, the "
                         f"plan has {n_blocks} blocks")
    return SplitTables(props=props, plan=plan, aabbs=aabbs,
                       vol_slot=scene.prims.vol_slot.to(torch.int32)
                       .contiguous())


def trace_plain(scene: S.Scene, o: Vec3, d: Vec3, tmin, tmax, time, vol_u):
    """Nearest hit and shading record in plain torch: (Hit, ShadeRec)."""
    hit = I.intersect_scene(scene, o, d, tmin, tmax, time, vol_u)
    return hit, gather_shade(scene, hit.prim_idx, hit.prim_idx >= 0)


def occluded_plain(scene: S.Scene, o: Vec3, d: Vec3, tmin, tmax, time,
                   vol_u):
    """Any hit in (tmin, tmax), plain torch: bool [N]."""
    return I.occluded(scene, o, d, tmin, tmax, time, vol_u)


def _plane(x, n: int, dev):
    """A scalar or [N] tensor as a float32 [N] plane."""
    if torch.is_tensor(x):
        return x.to(torch.float32).expand(n)
    return torch.full((n,), float(x), dtype=torch.float32, device=dev)


def _launch_inputs(scene, o: Vec3, d: Vec3, tmin, tmax, time, vol_u,
                   tables):
    """(rays [8, N], tables, params) checked for the kernels, with the
    volume uniforms: CUDA, float32/int32, contiguous, shapes that agree."""
    dev = o.x.device
    if dev.type != "cuda":
        raise ValueError(f"the split-tier kernels run on CUDA tensors, not "
                         f"{dev}")
    n = o.x.shape[0]
    if tables is None:
        tables = split_tables(scene)
    rays = torch.stack([*(c.to(torch.float32) for c in (*o, *d)),
                        _plane(time, n, dev), _plane(tmax, n, dev)])
    for name, t, dtype, shape in (
            ("rays", rays, torch.float32, (8, n)),
            ("props", tables.props, torch.float32, tuple(tables.props.shape)),
            ("plan", tables.plan, torch.int32,
             (len(scene.chunk_plan), PLAN_COLS)),
            ("aabbs", tables.aabbs, torch.float32,
             tuple(tables.aabbs.shape)),
            ("vol_slot", tables.vol_slot, torch.int32,
             (tables.props.shape[0],)),
            ("vol_u", vol_u, torch.float32, (max(scene.n_vol, 1), n))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the rays on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, needs {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, needs "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p = _CTraceParams()
    p.tmin = float(tmin)
    p.n_entries = len(scene.chunk_plan)
    p.n_blocks = tables.aabbs.shape[0]
    p.kdim = tables.props.shape[1]
    return rays, tables, p


def _call(fn, dev, *args):
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           f"{lib.rtw_error_string(err).decode()} ({err})")


def trace(scene: S.Scene, o: Vec3, d: Vec3, tmin, tmax, time, vol_u,
          tables: SplitTables | None = None):
    """Nearest hit of each ray over the whole scene and the winner's
    shading record: (Hit, ShadeRec), the contract of `trace_plain`.  `tmax`
    and `time` are scalars or [N] planes.  CPU tensors run `trace_plain`;
    CUDA tensors launch the kernel or raise."""
    global trace_launches
    check_plan(scene)
    if o.x.device.type == "cpu":
        return trace_plain(scene, o, d, tmin, tmax, time, vol_u)
    rays, tables, p = _launch_inputs(scene, o, d, tmin, tmax, time, vol_u,
                                     tables)
    n = rays.shape[1]
    of = torch.empty((HIT_F32, n), dtype=torch.float32, device=rays.device)
    oi = torch.empty((HIT_I32, n), dtype=torch.int32, device=rays.device)
    _call("rtw_trace", rays.device, rays.data_ptr(), vol_u.data_ptr(),
          tables.props.data_ptr(), tables.plan.data_ptr(),
          tables.aabbs.data_ptr(), tables.vol_slot.data_ptr(), of.data_ptr(),
          oi.data_ptr(), n, p)
    trace_launches += 1
    return _unpack_hit(of, oi)


def _unpack_hit(of, oi):
    """(Hit, ShadeRec) views of the kernel's output rows."""
    hit = I.Hit(t=of[0], prim_idx=oi[0].to(torch.int64), mat_id=oi[4],
                point=Vec3(of[1], of[2], of[3]),
                normal=Vec3(of[4], of[5], of[6]), u=of[7], v=of[8])
    shade = ShadeRec(mat_type=oi[1], fuzz=of[9], eta=of[10], tex_type=oi[2],
                     scale=of[11], image_id=oi[3],
                     rgb=Vec3(of[12], of[13], of[14]),
                     odd=Vec3(of[15], of[16], of[17]),
                     even=Vec3(of[18], of[19], of[20]))
    return hit, shade


def occluded_kernel(scene: S.Scene, o: Vec3, d: Vec3, tmin, tmax, time,
                    vol_u, tables: SplitTables | None = None):
    """Any hit in (tmin, tmax) per ray: bool [N], the contract of
    `occluded_plain`.  A lane with tmax <= tmin (a dead lane) is never
    occluded.  CPU tensors run `occluded_plain`; CUDA tensors launch the
    kernel or raise."""
    global occluded_launches
    check_plan(scene)
    if o.x.device.type == "cpu":
        return occluded_plain(scene, o, d, tmin, tmax, time, vol_u)
    rays, tables, p = _launch_inputs(scene, o, d, tmin, tmax, time, vol_u,
                                     tables)
    n = rays.shape[1]
    out = torch.empty(n, dtype=torch.bool, device=rays.device)
    _call("rtw_occluded", rays.device, rays.data_ptr(), vol_u.data_ptr(),
          tables.props.data_ptr(), tables.plan.data_ptr(),
          tables.aabbs.data_ptr(), tables.vol_slot.data_ptr(),
          out.data_ptr(), n, p)
    occluded_launches += 1
    return out


def library() -> ctypes.CDLL:
    """csrc/trace_kernel.cu, built at first use and bound to its C
    interface."""
    global _lib
    if _lib is not None:
        return _lib
    lib = kernels.load("trace_kernel")
    ptrs = [ctypes.c_void_p] * 8
    lib.rtw_trace.restype = ctypes.c_int
    lib.rtw_trace.argtypes = ptrs + [ctypes.c_int, _CTraceParams,
                                     ctypes.c_void_p]
    lib.rtw_occluded.restype = ctypes.c_int
    lib.rtw_occluded.argtypes = ptrs[:7] + [ctypes.c_int, _CTraceParams,
                                            ctypes.c_void_p]
    lib.rtw_error_string.restype = ctypes.c_char_p
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib
