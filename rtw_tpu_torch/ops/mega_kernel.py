"""Whole-bounce megakernel (port of rtw_tpu/ops/mega_kernel.py, TPU kernel A
at its pallas_call :387, and D, its hybrid mode at :437).

`mega_trace` renders a pixel batch over an spp chunk in one persistent
launch: each thread of csrc/mega_kernel.cu::mega_trace_kernel holds one
lane's path in registers and runs the lane step (path hash, camera-ray
regeneration of a finished path, the fast-RNG bounce uniforms: the
`NUM_FIXED_SLOTS` estimator slots, then a main-ray and a shadow-ray
free-flight row per volume slot; nearest hit, checker albedo,
`bounce_core` with single-light NEE + MIS and the any-hit shadow test,
Russian roulette, NaN scrub and sample accumulation) until the lane has
run all its samples; then it writes the lane's accumulated radiance and
pulls the next lane index from a device counter.  `mega_trace_plain` is
the same function in plain torch: `mega_step_plain` until no lane is busy.

`mega_step` runs one iteration of that step on a carry in global memory
(csrc/mega_kernel.cu::mega_kernel): `hybrid=True` is the reference's
queue-scheduled mode (TPU kernel D, driven by
`integrator.trace_wavefront_qmega`): no regeneration and no accumulation,
a dead lane's depth frozen, the flush left to the caller.  Its plain twin
is `mega_step_plain`, on the same carry layout.

What bounded the per-iteration design (one `mega_step` launch per
wavefront iteration, the render's former main path): the carry's bytes
and the launches.  Each launch read and wrote 17 f32 + 5 i32 rows of carry
(~176 B a lane: 0.034 ms at 640k lanes, 43% of the Cornell kernel's time),
staged the tables in each of its 5000 blocks, and the host loop paid 5920
launches and a termination read every 8 at 1000 spp.  What the persistent
design does about it: the path stays in registers, the tables are staged
once per resident block, and there is one launch and no host loop; the
image and the ray count equal the loop's bit for bit (every draw is keyed
by pixel, sample and depth, and one thread adds a lane's samples in sample
order).  What bounds it now: the operations of the sweeps and the shading
under divergence, and the tail (`trace_tail`): once the lane counter runs
dry, each thread finishes at most one lane while its SM empties.

On CUDA tensors the wrappers launch the hand-written kernels (built by
utils/kernels.py); on CPU tensors they run the plain versions.  There is no
fallback: a CUDA tensor gets the kernel or an error.

The kernel's envelope is the reference's (`integrator._validate_mega`):
fast RNG, at most one light, constant/checker textures, every prim type,
no gradients, estimator "mis", no `bounce_stats`; "auto" takes it below
128 prims.  `mega_params` validates it, so no caller can hand the kernel
a render it does not compute.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from rtw_tpu_torch.integrator import _validate_mega, bounce_env
from rtw_tpu_torch.models import scene as S
from rtw_tpu_torch.ops import sampling as sm
from rtw_tpu_torch.ops.bounce import bounce_core
from rtw_tpu_torch.ops import vec as V
from rtw_tpu_torch.ops.intersect import BIG, intersect_scene
from rtw_tpu_torch.ops.shading import gather_shade, resolve_albedo
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.ops.vec import Vec3
from rtw_tpu_torch.utils import kernels
from rtw_tpu_torch.utils import rng as R

# --- carry layout (the reference's) ----------------------------------------
# f32 rows [NF, N]
F_ORG = 0        # 3: ray origin
F_DIR = 3        # 3: ray direction
F_THR = 6        # 3: throughput
F_RAD = 9        # 3: path radiance
F_ACC = 12       # 3: accumulated radiance of finished samples
F_TIME = 15      # shutter time
F_PPDF = 16      # previous-bounce bsdf pdf (MIS carry)
NF = 17
# i32 rows [NI, N]
I_ALIVE = 0
I_PREVD = 1      # previous bounce was diffuse (MIS carry)
I_DEPTH = 2
I_SAMPLE = 3
I_PIXEL = 4
NI = 5

# --- float parameter layout (the reference's SMEM row; here the first
# member of the kernel's by-value parameter struct) -------------------------
PF_CAM_ORG = 0       # 3
PF_LL = 3            # 3 lower_left
PF_HOR = 6           # 3 horizontal
PF_VERT = 9          # 3 vertical
PF_CU = 12           # 3 camera u basis
PF_CV = 15           # 3 camera v basis
PF_LENS = 18
PF_T0 = 19
PF_T1 = 20
PF_SKY = 21
PF_LPOS = 22         # 3
PF_LU = 25           # 3
PF_LV = 28           # 3
PF_LEMIT = 31        # 3
PF_LAREA = 34
PF_LNRM = 35         # 3
PF = 40

# The kernel keeps the props table, the volume slots and the block AABBs in
# shared memory while they fit this many bytes together with what is always
# there (the upper nodes, the plan, the hier rows): two thread blocks an SM.
# A larger scene reads the three from global memory.
TABLES_SHARED_MAX = 100 * 1024
# The reference's `_use_block_culls`: a scene of at most this many blocks
# runs the straight-line sweep, without the blocks' box tests; a larger one
# walks its blocks (csrc/geometry.cuh::walk_blocks).
STRAIGHT_MAX_BLOCKS = 8

# Launches of the CUDA kernels since import (or since a caller reset them):
# the per-iteration step in regenerating mode and in hybrid mode (TPU
# kernel D), and the persistent render (TPU kernel A on the render path).
launches = 0
hybrid_launches = 0
trace_launches = 0
# The last persistent launch: its resident grid (`TRACE_INFO` keys) and its
# scratch tensor on the card (lane counter and clock stamps; `trace_tail`).
last_trace: dict = {}
TRACE_INFO = ("blocks_per_sm", "sms", "grid", "block", "registers",
              "local_bytes")
# The bound kernel library, loaded by `library()` at the first launch.
_lib: ctypes.CDLL | None = None


class _CParams(ctypes.Structure):
    """The kernel's by-value parameter struct (MegaParams in
    csrc/mega_kernel.cu; every member is 4 bytes, so no padding)."""

    _fields_ = [
        ("f", ctypes.c_float * PF),
        ("inv_nx", ctypes.c_float),
        ("inv_ny", ctypes.c_float),
        ("tmin", ctypes.c_float),
        ("tmax", ctypes.c_float),
        ("shadow_eps", ctypes.c_float),
        ("h0", ctypes.c_uint32),
        ("s_end", ctypes.c_int32),
        ("nx", ctypes.c_int32),
        ("ny", ctypes.c_int32),
        ("rr_start", ctypes.c_int32),
        ("max_depth", ctypes.c_int32),
        ("n_entries", ctypes.c_int32),
        ("n_props", ctypes.c_int32),
        ("kdim", ctypes.c_int32),
        ("num_lights", ctypes.c_int32),
        ("mat_present", ctypes.c_int32),
        ("checker", ctypes.c_int32),
        ("mis_bsdf_weight", ctypes.c_int32),
        ("n_vol", ctypes.c_int32),
        ("n_blocks", ctypes.c_int32),
        ("n_nodes", ctypes.c_int32),
        ("walk", ctypes.c_int32),
        ("tables_shared", ctypes.c_int32),
        ("s0", ctypes.c_int32),
    ]


@dataclasses.dataclass
class MegaParams:
    """Everything one render's launches share: the float row `parf`, the
    path-hash base `h0` (one uint32), the samples [s0, s_end), the volume
    slot count `n_vol` (max(scene.n_vol, 1)), the scene's tables (the
    split kernels' `SplitTables`: props, plan, AABB table with its
    hierarchy, hier rows, volume slots, on the scene's device), and the
    kernel's parameter struct built from them."""

    parf: np.ndarray          # float32 [PF]
    h0: int
    s0: int
    s_end: int
    n_vol: int
    tables: TK.SplitTables
    c_params: _CParams


def mega_params(scene: S.Scene, seed: int, cfg, s_end: int,
                s0: int = 0) -> MegaParams:
    """Validate the envelope (`_validate_mega`: ValueError for a render
    the kernel does not compute) and assemble the launch parameters for
    the samples [s0, s_end).  The camera and light rows reach the host in
    one copy."""
    _validate_mega(cfg, scene)
    cam = scene.camera
    lt = scene.lights

    parf = np.zeros(PF, np.float32)
    parts = [cam.origin, cam.lower_left, cam.horizontal, cam.vertical,
             cam.u, cam.v, cam.lens_radius, cam.time0, cam.time1,
             scene.sky_light, lt.position[0], lt.vec_u[0], lt.vec_v[0],
             lt.emission[0], lt.area[0], lt.normal[0]]
    vals = torch.cat([p.detach().to(torch.float32).reshape(-1)
                      for p in parts]).cpu().numpy()
    parf[:vals.size] = vals

    tables = TK.split_tables(scene)
    h0 = R.path_hash_base(seed)
    c = _CParams()
    c.f[:] = parf.tolist()
    c.inv_nx = float(np.float32(1.0 / cfg.nx))
    c.inv_ny = float(np.float32(1.0 / cfg.ny))
    c.tmin = cfg.t_min
    c.tmax = cfg.t_max
    c.shadow_eps = cfg.shadow_eps
    c.h0 = h0
    c.s_end = s_end
    c.nx, c.ny = cfg.nx, cfg.ny
    c.rr_start = cfg.rr_start_depth
    c.max_depth = cfg.max_depth
    c.n_entries = len(scene.chunk_plan)
    c.n_props, c.kdim = tables.props.shape
    c.num_lights = scene.num_lights
    c.mat_present = sum(1 << m for m, on in enumerate(scene.mat_present)
                        if on)
    c.checker = int(bool(scene.tex_present[S.TEX_CHECKER]))
    c.mis_bsdf_weight = int(bool(cfg.mis_bsdf_weight))
    c.n_vol = max(scene.n_vol, 1)
    c.n_blocks = tables.n_blocks
    c.n_nodes = tables.aabbs.shape[0] - tables.n_blocks
    c.walk = int(tables.n_blocks > STRAIGHT_MAX_BLOCKS)
    always, joined = table_bytes(c)
    c.tables_shared = int(always + joined <= TABLES_SHARED_MAX)
    c.s0 = s0
    return MegaParams(parf=parf, h0=h0, s0=s0, s_end=s_end, n_vol=c.n_vol,
                      tables=tables, c_params=c)


def table_bytes(c: _CParams) -> tuple[int, int]:
    """(bytes the kernel always keeps in shared memory, bytes of the tables
    that join them when they fit): csrc/mega_kernel.cu::smem_bytes."""
    always = 4 * (8 * c.n_nodes + c.n_entries * (TK.PLAN_COLS + TK.HIER_COLS))
    joined = 4 * (c.n_props * (c.kdim + 1) + 8 * c.n_blocks)
    return always, joined


def init_carry(pixel_idx, s0: int):
    """The carry before the first iteration: every lane dead with its
    sample cursor at s0, so the first launch regenerates it."""
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    sf = torch.zeros((NF, n), dtype=torch.float32, device=dev)
    sf[F_PPDF] = 1.0
    si = torch.zeros((NI, n), dtype=torch.int32, device=dev)
    si[I_SAMPLE] = s0
    si[I_PIXEL] = pixel_idx.to(torch.int32)
    return sf, si


def _scrub(x):
    """Zero NaN, inf and |x| >= 3e37 (the reference kernel's scrub)."""
    ok = (x == x) & (x.abs() < float(np.float32(3.0e37)))
    return torch.where(ok, x, 0.0)


def mega_step_plain(scene: S.Scene, cfg, sf, si, params: MegaParams, rays,
                    hybrid=False):
    """One wavefront iteration in plain torch.  Returns (sf', si') and adds
    the rays traced (camera + bounce + NEE queries) into `rays` (int64).
    `hybrid`: the queue-scheduled mode (see the module docstring)."""
    pf = [float(v) for v in params.parf]

    def pv(base):
        return Vec3(pf[base], pf[base + 1], pf[base + 2])

    pixel = si[I_PIXEL].to(torch.int64)
    sample = si[I_SAMPLE].to(torch.int64)
    depth = si[I_DEPTH].to(torch.int64)
    alive = si[I_ALIVE] > 0
    prev_diffuse = si[I_PREVD] > 0
    org = Vec3(sf[F_ORG], sf[F_ORG + 1], sf[F_ORG + 2])
    dirn = Vec3(sf[F_DIR], sf[F_DIR + 1], sf[F_DIR + 2])
    thr = Vec3(sf[F_THR], sf[F_THR + 1], sf[F_THR + 2])
    rad = Vec3(sf[F_RAD], sf[F_RAD + 1], sf[F_RAD + 2])
    acc = Vec3(sf[F_ACC], sf[F_ACC + 1], sf[F_ACC + 2])
    time = sf[F_TIME]
    prev_pdf = sf[F_PPDF]

    pk = R.pcg_hash(R.pcg_hash(sample + params.h0) + pixel)

    # ---- regeneration of finished lanes (none in hybrid mode) ------------
    if not hybrid:
        regen = ~alive & (sample < params.s_end)
        x_pix = (pixel % cfg.nx).to(torch.float32)
        y_pix = (pixel // cfg.nx).to(torch.float32)
        cu = R.camera_uniforms(pk)
        s_img = (x_pix + cu[0]) * float(np.float32(1.0 / cfg.nx))
        t_img = (y_pix + cu[1]) * float(np.float32(1.0 / cfg.ny))
        rdx, rdy = sm.unit_disk(cu[2], cu[3])
        lens = pf[PF_LENS]
        forg = (pv(PF_CAM_ORG) + pv(PF_CU) * (lens * rdx)
                + pv(PF_CV) * (lens * rdy))
        fdir = pv(PF_LL) + pv(PF_HOR) * s_img + pv(PF_VERT) * t_img - forg
        ftime = pf[PF_T0] + cu[4] * (pf[PF_T1] - pf[PF_T0])
        n = pixel.shape[0]
        ones = torch.ones(n, dtype=torch.float32, device=sf.device)
        zeros = torch.zeros_like(ones)
        org = V.where(regen, forg, org)
        dirn = V.where(regen, fdir, dirn)
        thr = V.where(regen, Vec3(ones, ones, ones), thr)
        rad = V.where(regen, Vec3(zeros, zeros, zeros), rad)
        time = torch.where(regen, ftime, time)
        prev_pdf = torch.where(regen, 1.0, prev_pdf)
        prev_diffuse = prev_diffuse & ~regen
        depth = torch.where(regen, 0, depth)
        alive = alive | regen

    # ---- bounce uniforms, trace, shade, one bounce -----------------------
    nv = params.n_vol
    U = R.bounce_uniforms(pk, depth + 1, R.NUM_FIXED_SLOTS + 2 * nv)
    vol_u = U[R.NUM_FIXED_SLOTS: R.NUM_FIXED_SLOTS + nv]
    occ_u = U[R.NUM_FIXED_SLOTS + nv:]
    tmax_lane = torch.where(alive, float(np.float32(cfg.t_max)), -BIG)
    hit = intersect_scene(scene, org, dirn, cfg.t_min, tmax_lane, time,
                          vol_u)
    hit_mask = hit.prim_idx >= 0
    shade = gather_shade(scene, hit.prim_idx, hit_mask)
    albedo = resolve_albedo(scene, shade, hit.point, hit.u, hit.v)
    res = bounce_core(bounce_env(scene, cfg, time, occ_u), U, depth, alive,
                      org, dirn, time, thr, rad, prev_pdf, prev_diffuse,
                      ~hit_mask, hit.point, hit.normal, shade.mat_type,
                      shade.fuzz, shade.eta, albedo, hit.prim_idx)

    # ---- finish / accumulate (hybrid: the flush outside does both) -------
    depth = torch.where(alive, depth + 1, depth) if hybrid else depth + 1
    finished = alive & (~res.alive | (depth >= cfg.max_depth))
    if not hybrid:
        rad_s = Vec3(*(_scrub(c) for c in res.radiance))
        acc = V.where(finished, acc + rad_s, acc)
        sample = torch.where(finished, sample + 1, sample)
    alive_out = res.alive & ~finished
    rays += res.rays_lane.sum(dtype=torch.int64)

    sf2 = torch.stack([*res.origin, *res.direction, *res.throughput,
                       *res.radiance, *acc, time, res.prev_pdf])
    si2 = torch.stack([r.to(torch.int32) for r in (
        alive_out, res.prev_diffuse, depth, sample, pixel)])
    return sf2, si2


def _check(named, params: MegaParams, device) -> None:
    """Device, dtype, shape and contiguity of each (name, tensor, dtype,
    shape) in `named` and of the scene's tables, and the tables' shared
    memory against a block's."""
    c, tb = params.c_params, params.tables
    for name, t, dtype, shape in (*named,
            ("props", tb.props, torch.float32, (c.n_props, c.kdim)),
            ("plan", tb.plan, torch.int32, (c.n_entries, TK.PLAN_COLS)),
            ("aabbs", tb.aabbs, torch.float32, (c.n_blocks + c.n_nodes, 8)),
            ("hier", tb.hier, torch.int32, (c.n_entries, TK.HIER_COLS)),
            ("vol_slot", tb.vol_slot, torch.int32, (c.n_props,))):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the lanes on "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, needs {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, needs "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    always, joined = table_bytes(c)
    need = always + (joined if c.tables_shared else 0)
    if need > TK.SMEM_MAX:
        raise ValueError(f"the kernel's tables take {need} bytes of shared "
                         f"memory, a block has {TK.SMEM_MAX}")


def _check_tensors(sf, si, params: MegaParams, rays) -> int:
    n = sf.shape[-1]
    _check((("sf", sf, torch.float32, (NF, n)),
            ("si", si, torch.int32, (NI, n)),
            ("rays", rays, torch.int64, (1,))), params, sf.device)
    return n


def mega_step(scene: S.Scene, cfg, sf, si, params: MegaParams, rays,
              hybrid=False):
    """One whole wavefront iteration.  Returns (sf', si') and adds this
    iteration's ray count into the int64 [1] tensor `rays`.  `hybrid`: the
    queue-scheduled mode (TPU kernel D).

    CPU tensors run `mega_step_plain`; CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise."""
    global launches, hybrid_launches
    if sf.device.type == "cpu":
        return mega_step_plain(scene, cfg, sf, si, params, rays, hybrid)
    if sf.device.type != "cuda":
        raise ValueError(f"mega_step runs on CPU or CUDA tensors, not "
                         f"{sf.device}")
    n = _check_tensors(sf, si, params, rays)
    osf = torch.empty_like(sf)
    osi = torch.empty_like(si)
    lib = library()
    tb = params.tables
    with torch.cuda.device(sf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rtw_mega_step(sf.data_ptr(), si.data_ptr(),
                                tb.props.data_ptr(), tb.plan.data_ptr(),
                                tb.aabbs.data_ptr(), tb.hier.data_ptr(),
                                tb.vol_slot.data_ptr(), osf.data_ptr(),
                                osi.data_ptr(), rays.data_ptr(), n,
                                int(bool(hybrid)), params.c_params, stream)
    if err != 0:
        raise RuntimeError(f"mega_step kernel launch failed: "
                           f"{lib.rtw_error_string(err).decode()} ({err})")
    if hybrid:
        hybrid_launches += 1
    else:
        launches += 1
    return osf, osi


def mega_trace_plain(scene: S.Scene, cfg, pixel_idx, params: MegaParams,
                     rays):
    """`mega_trace` in plain torch: from the carry of `init_carry`,
    `mega_step_plain` until no lane is alive or has samples left.  Returns
    the accumulated radiance, float32 [3, N]."""
    sf, si = init_carry(pixel_idx, params.s0)
    while bool(((si[I_ALIVE] > 0) | (si[I_SAMPLE] < params.s_end)).any()):
        sf, si = mega_step_plain(scene, cfg, sf, si, params, rays)
    return sf[F_ACC:F_ACC + 3]


def mega_trace(scene: S.Scene, cfg, pixel_idx, params: MegaParams, rays):
    """Every lane of `pixel_idx` (int32 [N], one pixel a lane) over the
    samples [params.s0, params.s_end): returns the accumulated radiance,
    float32 [3, N], and adds the rays traced into the int64 [1] tensor
    `rays`.

    CPU tensors run `mega_trace_plain`; CUDA tensors make one launch of the
    persistent kernel on the current stream (no synchronisation) or
    raise."""
    global trace_launches
    if pixel_idx.device.type == "cpu":
        return mega_trace_plain(scene, cfg, pixel_idx, params, rays)
    if pixel_idx.device.type != "cuda":
        raise ValueError(f"mega_trace runs on CPU or CUDA tensors, not "
                         f"{pixel_idx.device}")
    n = pixel_idx.shape[0]
    _check((("pixel_idx", pixel_idx, torch.int32, (n,)),
            ("rays", rays, torch.int64, (1,))), params, pixel_idx.device)
    acc = torch.empty((3, n), dtype=torch.float32, device=pixel_idx.device)
    scratch = torch.zeros(4, dtype=torch.int64, device=pixel_idx.device)
    info = (ctypes.c_int * len(TRACE_INFO))()
    lib = library()
    tb = params.tables
    with torch.cuda.device(pixel_idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rtw_mega_trace(pixel_idx.data_ptr(), tb.props.data_ptr(),
                                 tb.plan.data_ptr(), tb.aabbs.data_ptr(),
                                 tb.hier.data_ptr(), tb.vol_slot.data_ptr(),
                                 acc.data_ptr(), rays.data_ptr(),
                                 scratch.data_ptr(), n, params.c_params,
                                 stream, info)
    if err != 0:
        raise RuntimeError(f"mega_trace kernel launch failed: "
                           f"{lib.rtw_error_string(err).decode()} ({err})")
    trace_launches += 1
    last_trace.clear()
    last_trace.update(zip(TRACE_INFO, info), scratch=scratch)
    return acc


def trace_tail(scratch) -> dict:
    """The clock stamps of a persistent launch's scratch (`last_trace`'s),
    read after the launch has ended: `kernel_ms` from the first block's
    start to the last warp's exit, `tail_ms` from the moment the lane
    counter ran dry (every lane handed out) to that exit."""
    s = [int(v) for v in scratch.cpu()]
    start, dry, end = ~s[1] & (2 ** 64 - 1), s[2], s[3]
    return {"kernel_ms": (end - start) * 1e-6, "tail_ms": (end - dry) * 1e-6}


def library() -> ctypes.CDLL:
    """csrc/mega_kernel.cu, built at first use and bound to its C
    interface."""
    global _lib
    if _lib is not None:
        return _lib
    lib = kernels.load("mega_kernel")
    lib.rtw_mega_step.restype = ctypes.c_int
    lib.rtw_mega_step.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_int, _CParams, ctypes.c_void_p]
    lib.rtw_mega_trace.restype = ctypes.c_int
    lib.rtw_mega_trace.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int, _CParams, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int)]
    lib.rtw_error_string.restype = ctypes.c_char_p
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib
