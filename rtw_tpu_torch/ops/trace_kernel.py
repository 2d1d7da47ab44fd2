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

Plan groups of `TWO_LEVEL_MIN` blocks or more get a hierarchy over their
block AABBs (`augment_aabbs`: levels of 16, appended to the AABB table),
which the kernels walk per ray (csrc/geometry.cuh::walk_blocks).  The plain
versions stay the full sweep; `reachable_blocks` is the table's plain
reading, for the tests.
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
# The hierarchy over a plan group's blocks (the reference's two-level
# supers, `_GROUP` and `_TWO_LEVEL_MIN`, generalised to levels of 16): a
# group of at least TWO_LEVEL_MIN blocks gets one node per WALK_FAN
# consecutive nodes of the level below (level 0: its blocks), level on level
# until at most WALK_FAN nodes are left.  Tests lower the threshold on small
# scenes; it is read when the tables are built.
WALK_SHIFT = 4
WALK_FAN = 1 << WALK_SHIFT
TWO_LEVEL_MIN = 128
MAX_LEVELS = 4
# Columns of the per-group `hier` table: the number of levels (0: a flat
# group), the group's first row and its row count in the block AABBs, and
# the table row of the first node of each level 1..MAX_LEVELS.
H_LEVELS, H_FIRST, H_BLOCKS, H_LEVEL0 = 0, 1, 2, 2
HIER_COLS = 3 + MAX_LEVELS
# The kernels keep the upper nodes, the plan and `hier` in shared memory
# (csrc/trace_kernel.cu: at most the card's 227 KB a block).
SMEM_MAX = 232448
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
                ("n_blocks", ctypes.c_int32), ("n_nodes", ctypes.c_int32),
                ("kdim", ctypes.c_int32)]


@dataclasses.dataclass
class SplitTables:
    """The scene's tables both kernels read, on the scene's device: the
    props table, the chunk plan, the AABB table (the `n_blocks` block rows,
    then the hierarchy's upper nodes: `augment_aabbs`), the per-group `hier`
    rows that index it (`layout`: the same rows as Python ints, for the
    launch checks), and the per-prim volume slot.  A render builds them
    once (`split_tables`) and passes them to every launch."""

    props: torch.Tensor       # float32 [P, K]
    plan: torch.Tensor        # int32 [E, PLAN_COLS]
    aabbs: torch.Tensor       # float32 [n_blocks + n_nodes, 8]
    hier: torch.Tensor        # int32 [E, HIER_COLS]
    vol_slot: torch.Tensor    # int32 [P]; -1 off volumes
    n_blocks: int
    layout: list[list[int]]   # hier on the host


def plan_table(scene: S.Scene):
    """The chunk plan as an int32 [E, PLAN_COLS] tensor on the scene's
    device."""
    return torch.tensor([list(map(int, e)) for e in scene.chunk_plan],
                        dtype=torch.int32, device=scene.device)


def _walked(entry) -> bool:
    """Whether a plan group gets a hierarchy: TWO_LEVEL_MIN blocks or more
    of a type other than a volume (the reference's `_two_level`; a volume
    group is a handful of prims)."""
    return (entry[3] not in I.VOLUME_PRIMS
            and entry[2] // entry[6] >= TWO_LEVEL_MIN)


def _level_counts(entry, levels: int | None = None) -> list[int]:
    """The node counts of a plan group's levels 1, 2, ...: as many levels
    as `levels` says, or (None) as the threshold gives the group: none for
    a flat group, else levels until at most WALK_FAN nodes are left."""
    out, n = [], entry[2] // entry[6]
    while (len(out) < levels if levels is not None else
           _walked(entry) and (not out or n > WALK_FAN)):
        n = -(-n // WALK_FAN)
        out.append(n)
    return out


def hier_layout(chunk_plan, levels=None) -> list[list[int]]:
    """The `hier` rows of a chunk plan, as Python ints, with each group's
    level count from `levels` or (None) from the threshold.  The upper
    nodes follow the block rows level by level: level 1 of every walked
    group in plan order (the reference's super rows, `_super_offsets`),
    then level 2 of every group that has one, and so on."""
    counts = [_level_counts(e, None if levels is None else levels[g])
              for g, e in enumerate(chunk_plan)]
    if any(len(c) > MAX_LEVELS for c in counts):
        raise ValueError(f"a plan group needs more than {MAX_LEVELS} levels "
                         f"of {WALK_FAN} over its blocks")
    rows, first = [], 0
    for e, c in zip(chunk_plan, counts):
        rows.append([len(c), first, e[2] // e[6]] + [0] * MAX_LEVELS)
        first += e[2] // e[6]
    row = first
    for level in range(MAX_LEVELS):
        for r, c in zip(rows, counts):
            if len(c) > level:
                r[H_LEVEL0 + level + 1] = row
                row += c[level]
    return rows


def _level_up(nodes):
    """One node per WALK_FAN consecutive rows of `nodes` [n, 8]: the union
    of their boxes (float min / max, so a node's box holds each child's
    exactly); the ragged last node takes the rows there are."""
    n, cols = nodes.shape
    pad = -n % WALK_FAN
    if pad:
        inv = nodes.new_zeros((pad, cols))
        inv[:, 0:3] = I.BIG
        inv[:, 3:6] = -I.BIG
        nodes = torch.cat([nodes, inv])
    g = nodes.reshape(-1, WALK_FAN, cols)
    up = nodes.new_zeros((g.shape[0], cols))
    up[:, 0:3] = g[:, :, 0:3].amin(dim=1)
    up[:, 3:6] = g[:, :, 3:6].amax(dim=1)
    return up


def augment_aabbs(scene: S.Scene):
    """(AABB table, hier rows): the scene's block AABBs [n_blocks, 8] with
    the upper nodes of every walked group appended in `hier_layout`'s order
    (float32, on the scene's device), and the `hier` rows as Python ints.
    Level 1 is bit-equal to the reference's super rows; there is no guard
    tail: the walk masks a ragged last node by its child count."""
    ab = scene.block_aabbs.to(torch.float32)
    layout = hier_layout(scene.chunk_plan)
    below = [ab[r[H_FIRST]:r[H_FIRST] + r[H_BLOCKS]] for r in layout]
    parts = [ab]
    for level in range(1, MAX_LEVELS + 1):
        for g, r in enumerate(layout):
            if r[H_LEVELS] >= level:
                below[g] = _level_up(below[g])
                parts.append(below[g])
    return torch.cat(parts).contiguous(), layout


def check_tables(scene: S.Scene, tables: SplitTables) -> None:
    """The tables' shapes and the hier rows against the plan: what the
    kernels index without a bounds check.  Host-side only (no device
    read).  Raises ValueError on a table that does not fit."""
    plan = scene.chunk_plan
    n_rows = tables.props.shape[0]
    if n_rows < max(e[0] + e[2] for e in plan):
        raise ValueError(f"props has {n_rows} rows, the plan reads "
                         f"{max(e[0] + e[2] for e in plan)}")
    n_blocks = sum(e[2] // e[6] for e in plan)
    if tables.n_blocks != n_blocks:
        raise ValueError(f"n_blocks is {tables.n_blocks}, the plan has "
                         f"{n_blocks} blocks")
    if (len(tables.layout) != len(plan) or tables.layout != hier_layout(
            plan, [r[H_LEVELS] for r in tables.layout])):
        raise ValueError(f"the hier rows {tables.layout} do not lay the "
                         "plan's blocks out")
    n_nodes = sum(sum(_level_counts(e, r[H_LEVELS]))
                  for e, r in zip(plan, tables.layout))
    for name, t, shape in (
            ("plan", tables.plan, (len(plan), PLAN_COLS)),
            ("aabbs", tables.aabbs, (n_blocks + n_nodes, 8)),
            ("hier", tables.hier, (len(plan), HIER_COLS)),
            ("vol_slot", tables.vol_slot, (n_rows,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the plan "
                             f"needs {shape}")
    smem = 4 * (8 * n_nodes + len(plan) * (PLAN_COLS + HIER_COLS))
    if smem > SMEM_MAX:
        raise ValueError(f"the upper nodes and the plan take {smem} bytes "
                         f"of shared memory, the kernels have {SMEM_MAX}")


def refuse_grad(who: str, **tensors) -> None:
    """Raise ValueError if grad mode is on and one of `tensors` (tensors or
    Vec3s) requires grad: a kernel reads raw pointers, so it would drop
    that gradient silently.  The gradient path runs the kernels under
    torch.no_grad() on detached inputs (integrator.bounce_step)."""
    if not torch.is_grad_enabled():
        return
    for name, t in tensors.items():
        for c in (t if isinstance(t, Vec3) else (t,)):
            if torch.is_tensor(c) and c.requires_grad:
                raise ValueError(
                    f"{who}: {name} requires grad; the kernel would drop "
                    "its gradient (call it under torch.no_grad() on "
                    "detached inputs)")


def _scene_tensors(scene: S.Scene) -> dict:
    """The scene's tensors that the tables are built from."""
    pr = scene.prims
    return {**{f"prims.{f.name}": getattr(pr, f.name)
               for f in dataclasses.fields(pr)},
            "textures.color": scene.textures.color,
            "block_aabbs": scene.block_aabbs}


def split_tables(scene: S.Scene) -> SplitTables:
    """The tables of both kernels (SplitTables), built from the scene; a
    scene tensor that requires grad under grad mode is refused
    (`refuse_grad`)."""
    refuse_grad("split_tables", **_scene_tensors(scene))
    check_plan(scene)
    props = build_props(scene, any(e[5] for e in scene.chunk_plan))
    aabbs, layout = augment_aabbs(scene)
    tables = SplitTables(props=props, plan=plan_table(scene), aabbs=aabbs,
                         hier=torch.tensor(layout, dtype=torch.int32,
                                           device=scene.device),
                         n_blocks=sum(r[H_BLOCKS] for r in layout),
                         layout=layout,
                         vol_slot=scene.prims.vol_slot.to(torch.int32)
                         .contiguous())
    check_tables(scene, tables)
    return tables


def _slab_pass(boxes, o: Vec3, d: Vec3, tmin, tmax):
    """[R, N] bool: the kernels' slab test of each box [R, 8] against each
    ray, without a best t (csrc/geometry.cuh::box_active)."""
    near = far = None
    for ax in range(3):
        inv = 1.0 / torch.where(d[ax] == 0.0, 1e-30, d[ax])
        t0 = (boxes[:, ax, None] - o[ax]) * inv
        t1 = (boxes[:, 3 + ax, None] - o[ax]) * inv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    return (far >= torch.clamp_min(near, tmin)) & (near < tmax)


def reachable_blocks(tables: SplitTables, o: Vec3, d: Vec3, tmin, tmax):
    """bool [n_blocks, N]: whether the walk can reach each block for each
    ray: the block's own slab test and every ancestor's pass in (tmin,
    tmax).  The plain reading of the hierarchy table: the tests hold the
    table and the cull's conservativeness against it; no render calls it."""
    ok = _slab_pass(tables.aabbs, o, d, tmin, tmax)
    reach = ok[:tables.n_blocks].clone()
    for levels, first, count, *rows in tables.layout:
        b = torch.arange(count, device=ok.device)
        for level in range(1, levels + 1):
            reach[first:first + count] &= ok[
                rows[level - 1] + (b >> (WALK_SHIFT * level))]
    return reach


def prim_blocks(scene: S.Scene):
    """int64 [P]: the block AABB row of each props row."""
    out, first = [], 0
    for start, count, size, ptype, axis, xform, block in scene.chunk_plan:
        out.append(first + torch.arange(size) // block)
        first += size // block
    return torch.cat(out).to(scene.device)


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
    volume uniforms: CUDA, float32/int32, contiguous, shapes that agree
    with each other and with the plan (`check_tables`)."""
    dev = o.x.device
    if dev.type != "cuda":
        raise ValueError(f"the split-tier kernels run on CUDA tensors, not "
                         f"{dev}")
    n = o.x.shape[0]
    if tables is None:
        tables = split_tables(scene)
    rays = torch.stack([*(c.to(torch.float32) for c in (*o, *d)),
                        _plane(time, n, dev), _plane(tmax, n, dev)])
    check_tables(scene, tables)
    for name, t, dtype, shape in (
            ("rays", rays, torch.float32, (8, n)),
            ("props", tables.props, torch.float32, None),
            ("plan", tables.plan, torch.int32, None),
            ("aabbs", tables.aabbs, torch.float32, None),
            ("hier", tables.hier, torch.int32, None),
            ("vol_slot", tables.vol_slot, torch.int32, None),
            ("vol_u", vol_u, torch.float32, (max(scene.n_vol, 1), n))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the rays on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, needs {dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, needs "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p = _CTraceParams()
    p.tmin = float(tmin)
    p.n_entries = len(scene.chunk_plan)
    p.n_blocks = tables.n_blocks
    p.n_nodes = tables.aabbs.shape[0] - tables.n_blocks
    p.kdim = tables.props.shape[1]
    return rays, tables, p


def _refuse_grad_inputs(who, scene, o, d, tmax, time, vol_u, tables):
    """`refuse_grad` over a query's rays, uniforms and tables (the scene's
    tensors when the tables are still to be built), on either device: the
    plain version a CPU tensor runs takes what the kernel would take."""
    tabs = ({"tables.props": tables.props, "tables.aabbs": tables.aabbs}
            if tables is not None else _scene_tensors(scene))
    refuse_grad(who, o=o, d=d, tmax=tmax, time=time, vol_u=vol_u, **tabs)


def _call(fn, dev, *args):
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           f"{lib.rtw_error_string(err).decode()} ({err})")


def trace_rows(scene: S.Scene, o: Vec3, d: Vec3, tmin, tmax, time, vol_u,
               tables: SplitTables | None = None):
    """Nearest hit and shading record as the kernel writes them: (of, oi),
    float32 [HIT_F32, N] and int32 [HIT_I32, N] rows (`_unpack_hit` reads
    them).  CPU tensors run `trace_plain` and pack its result into the same
    rows; CUDA tensors launch the kernel or raise."""
    global trace_launches
    check_plan(scene)
    _refuse_grad_inputs("trace", scene, o, d, tmax, time, vol_u, tables)
    if o.x.device.type == "cpu":
        return _pack_hit(*trace_plain(scene, o, d, tmin, tmax, time, vol_u))
    rays, tables, p = _launch_inputs(scene, o, d, tmin, tmax, time, vol_u,
                                     tables)
    n = rays.shape[1]
    of = torch.empty((HIT_F32, n), dtype=torch.float32, device=rays.device)
    oi = torch.empty((HIT_I32, n), dtype=torch.int32, device=rays.device)
    _call("rtw_trace", rays.device, rays.data_ptr(), vol_u.data_ptr(),
          tables.props.data_ptr(), tables.plan.data_ptr(),
          tables.aabbs.data_ptr(), tables.hier.data_ptr(),
          tables.vol_slot.data_ptr(), of.data_ptr(), oi.data_ptr(), n, p)
    trace_launches += 1
    return of, oi


def trace(scene: S.Scene, o: Vec3, d: Vec3, tmin, tmax, time, vol_u,
          tables: SplitTables | None = None):
    """Nearest hit of each ray over the whole scene and the winner's
    shading record: (Hit, ShadeRec), the contract of `trace_plain`, read
    from `trace_rows`.  `tmax` and `time` are scalars or [N] planes."""
    return _unpack_hit(*trace_rows(scene, o, d, tmin, tmax, time, vol_u,
                                   tables))


def _pack_hit(hit, shade):
    """The kernel's output rows (of, oi) of a (Hit, ShadeRec)."""
    of = torch.stack([hit.t, *hit.point, *hit.normal, hit.u, hit.v,
                      shade.fuzz, shade.eta, shade.scale, *shade.rgb,
                      *shade.odd, *shade.even]).to(torch.float32)
    oi = torch.stack([c.to(torch.int32) for c in (
        hit.prim_idx, shade.mat_type, shade.tex_type, shade.image_id,
        hit.mat_id)])
    return of, oi


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
    _refuse_grad_inputs("occluded_kernel", scene, o, d, tmax, time, vol_u,
                        tables)
    if o.x.device.type == "cpu":
        return occluded_plain(scene, o, d, tmin, tmax, time, vol_u)
    rays, tables, p = _launch_inputs(scene, o, d, tmin, tmax, time, vol_u,
                                     tables)
    n = rays.shape[1]
    out = torch.empty(n, dtype=torch.bool, device=rays.device)
    _call("rtw_occluded", rays.device, rays.data_ptr(), vol_u.data_ptr(),
          tables.props.data_ptr(), tables.plan.data_ptr(),
          tables.aabbs.data_ptr(), tables.hier.data_ptr(),
          tables.vol_slot.data_ptr(), out.data_ptr(), n, p)
    occluded_launches += 1
    return out


def library() -> ctypes.CDLL:
    """csrc/trace_kernel.cu, built at first use and bound to its C
    interface."""
    global _lib
    if _lib is not None:
        return _lib
    lib = kernels.load("trace_kernel")
    ptrs = [ctypes.c_void_p] * 9
    lib.rtw_trace.restype = ctypes.c_int
    lib.rtw_trace.argtypes = ptrs + [ctypes.c_int, _CTraceParams,
                                     ctypes.c_void_p]
    lib.rtw_occluded.restype = ctypes.c_int
    lib.rtw_occluded.argtypes = ptrs[:8] + [ctypes.c_int, _CTraceParams,
                                            ctypes.c_void_p]
    lib.rtw_error_string.restype = ctypes.c_char_p
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib
