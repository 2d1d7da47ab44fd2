"""Plain torch scene intersection (port of rtw_tpu/ops/intersect.py).

The same chunked sweep as the reference: each statically typed block of C
primitives yields a [C, N] t-matrix, and a running (t, prim) argmin is
merged block by block (lowest index wins ties, as the reference's argmin
and strict `<` merge do).  The winner's payload is computed once per ray
from its group's static type.

This is the plain version that the CPU tests hold against the reference
and that the CUDA kernels (csrc/mega_kernel.cu, csrc/trace_kernel.cu) are
held against on the card.  Moving spheres read the per-ray shutter `time`;
uv is the reference's exact spherical, rect and per-face box map.  Volume
spheres and boxes read one pre-drawn free-flight uniform per (ray, volume
slot) from `vol_u` [max(n_vol, 1), N], and reject a sample past the far
boundary, as the reference does.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from . import scene as S
from . import vec as V
from .vec import Vec3
from .sampling import safe_sqrt

BIG = float(np.float32(1e30))

PRIM_TYPES = (S.PRIM_SPHERE, S.PRIM_RECT, S.PRIM_MOVING_SPHERE,
              S.PRIM_VOLUME_SPHERE, S.PRIM_VOLUME_BOX, S.PRIM_BOX)
VOLUME_PRIMS = (S.PRIM_VOLUME_SPHERE, S.PRIM_VOLUME_BOX)


def check_prim_type(ptype: int) -> None:
    if ptype not in PRIM_TYPES:
        raise ValueError(f"unknown prim type {ptype}")


class Hit(NamedTuple):
    """Per-ray nearest-hit record; SoA planes."""

    t: Any          # [N] float32; BIG means miss
    prim_idx: Any   # [N] int64; -1 = miss
    mat_id: Any     # [N] int32
    point: Vec3
    normal: Vec3
    u: Any          # [N] texture u
    v: Any          # [N] texture v


def _col(params, i):
    """[C, 9] chunk param table -> [C, 1] broadcast column.  A list of 9
    per-ray [N] planes (the winner re-evaluation, `reeval_hit`) passes
    plane i through: the same test then runs one prim per ray."""
    if isinstance(params, (list, tuple)):
        return params[i]
    return params[:, i:i + 1]


def fma(x, y, z):
    """x * y + z rounded once, as a fused multiply-add rounds it: the f32
    product is exact in float64, so only the sum rounds (in float64, then
    to f32; the two roundings differ from one only on ties, ~2^-29 of
    inputs)."""
    return (x.double() * y.double() + z.double()).float()


def _fdot(u: Vec3, w: Vec3):
    """u . w with the reference's fused multiply-adds: XLA's CPU code
    computes x*x' + y*y' + z*z' as fma(z, z', fma(x, x', y*y'))."""
    return fma(u.z, w.z, fma(u.x, w.x, u.y * w.y))


def _sphere_roots(o: Vec3, d: Vec3, center: Vec3, radius):
    """The quadratic's roots, fused as the reference's compiled CPU code
    fuses it.  Fusion matters here: where b*b and a*c, or |oc|^2 and r^2,
    cancel (the r = 1000 ground sphere of scenes 1 and 2), the ulps the
    fused multiply-adds save become ~1e-4 of t."""
    oc = o - center
    a = _fdot(d, d)
    b = _fdot(oc, d)
    c = _fdot(oc, oc) - radius * radius
    disc = fma(b, b, -(a * c))
    valid = disc >= 0.0
    sq = safe_sqrt(disc)
    inv_a = 1.0 / a
    return (-b - sq) * inv_a, (-b + sq) * inv_a, valid


def _in_window(t, tmin, tmax):
    return (t > tmin) & (t < tmax)


def _nearer_root(t1, t2, valid, tmin, tmax):
    t = torch.where(_in_window(t1, tmin, tmax), t1,
                    torch.where(_in_window(t2, tmin, tmax), t2, BIG))
    return torch.where(valid, t, BIG)


def sphere_t(params, o, d, tmin, tmax):
    center = Vec3(_col(params, 0), _col(params, 1), _col(params, 2))
    return _nearer_root(*_sphere_roots(o, d, center, _col(params, 3)),
                        tmin, tmax)


def _moving_center(c0: Vec3, c1: Vec3, t0, t1, time) -> Vec3:
    """Center lerped by the ray's shutter time (the reference's
    moving_sphere_t and _payload), c0 + (c1 - c0) * frac fused as the
    reference's compiled code fuses it."""
    span = t1 - t0
    frac = torch.where(span == 0.0, 0.0,
                       (time - t0) / torch.where(span == 0.0, 1.0, span))
    return Vec3(*(fma(b - a, frac, a) for a, b in zip(c0, c1)))


def moving_sphere_t(params, o, d, tmin, tmax, time):
    center = _moving_center(
        Vec3(_col(params, 0), _col(params, 1), _col(params, 2)),
        Vec3(_col(params, 4), _col(params, 5), _col(params, 6)),
        _col(params, 7), _col(params, 8), time)
    return _nearer_root(*_sphere_roots(o, d, center, _col(params, 3)),
                        tmin, tmax)


_AXIS_OTHERS = {S.AXIS_X: (1, 2), S.AXIS_Y: (0, 2), S.AXIS_Z: (0, 1)}


def _nonzero(x):
    return torch.where(x == 0.0, 1e-30, x)


def rect_t(params, o: Vec3, d: Vec3, tmin, tmax, axis: int):
    """Axis-aligned rect plane-slab test."""
    a0, a1, b0, b1, k = (_col(params, i) for i in range(5))
    ia, ib = _AXIS_OTHERS[axis]
    t = (k - o[axis]) / _nonzero(d[axis])
    pa = o[ia] + t * d[ia]
    pb = o[ib] + t * d[ib]
    inside = (pa >= a0) & (pa <= a1) & (pb >= b0) & (pb <= b1)
    return torch.where(inside & _in_window(t, tmin, tmax), t, BIG)


def _box_roots(o: Vec3, d: Vec3, bmin: Vec3, bmax: Vec3):
    near = torch.full_like(o.x + d.x, -BIG)
    far = torch.full_like(near, BIG)
    for ax in range(3):
        inv = 1.0 / _nonzero(d[ax])
        t0 = (bmin[ax] - o[ax]) * inv
        t1 = (bmax[ax] - o[ax]) * inv
        near = torch.maximum(near, torch.minimum(t0, t1))
        far = torch.minimum(far, torch.maximum(t0, t1))
    return near, far


def box_t(params, o, d, tmin, tmax):
    """Solid axis-aligned box via one slab test."""
    bmin = Vec3(_col(params, 0), _col(params, 1), _col(params, 2))
    bmax = Vec3(_col(params, 3), _col(params, 4), _col(params, 5))
    near, far = _box_roots(o, d, bmin, bmax)
    t = torch.where(_in_window(near, tmin, tmax), near,
                    torch.where(_in_window(far, tmin, tmax), far, BIG))
    return torch.where(near <= far, t, BIG)


def _volume_t(near, far, valid, density, u, tmin, tmax, d_len):
    """Free-flight sample inside the boundary (near, far): the reference's
    _volume_t, a sample beyond the far boundary misses.  The density guard
    keeps pad rows (density 0) finite."""
    h1 = torch.clamp_min(torch.clamp_min(near, tmin), 0.0)
    h2 = torch.minimum(far, torch.as_tensor(tmax, dtype=far.dtype,
                                            device=far.device))
    dist_inside = (h2 - h1) * d_len
    flight = (-(1.0 / torch.clamp_min(density, 1e-20))
              * torch.log(torch.clamp_min(u, 1e-30)))
    ok = valid & (h1 < h2) & (flight <= dist_inside)
    return torch.where(ok, h1 + flight / d_len, BIG)


def _ray_length(d: Vec3):
    """|d|, with d . d fused as the sphere test fuses it."""
    return V.sqrt(torch.clamp_min(_fdot(d, d), 1e-30))


def volume_sphere_t(params, o, d, tmin, tmax, u):
    center = Vec3(_col(params, 0), _col(params, 1), _col(params, 2))
    t1, t2, valid = _sphere_roots(o, d, center, _col(params, 3))
    return _volume_t(t1, t2, valid, _col(params, 4), u, tmin, tmax,
                     _ray_length(d))


def volume_box_t(params, o, d, tmin, tmax, u):
    bmin = Vec3(_col(params, 0), _col(params, 1), _col(params, 2))
    bmax = Vec3(_col(params, 3), _col(params, 4), _col(params, 5))
    near, far = _box_roots(o, d, bmin, bmax)
    return _volume_t(near, far, near <= far, _col(params, 6), u, tmin, tmax,
                     _ray_length(d))


def _ray_point(o: Vec3, d: Vec3, t) -> Vec3:
    """o + d * t, fused as the reference's compiled CPU code fuses it."""
    return Vec3(*(fma(dc, t, oc) for oc, dc in zip(o, d)))


def _box_payload(p9, o: Vec3, d: Vec3, t, tmin):
    """Hit point, outward face normal and per-face uv of the box prim: Z
    faces map (x, y), Y faces (x, z), X faces (y, z)."""
    point = _ray_point(o, d, t)
    bmin = [p9[0], p9[1], p9[2]]
    bmax = [p9[3], p9[4], p9[5]]
    tns, tfs = [], []
    for ax in range(3):
        inv = 1.0 / _nonzero(d[ax])
        t0 = (bmin[ax] - o[ax]) * inv
        t1 = (bmax[ax] - o[ax]) * inv
        tns.append(torch.minimum(t0, t1))
        tfs.append(torch.maximum(t0, t1))
    near = torch.maximum(torch.maximum(tns[0], tns[1]), tns[2])
    entry = near > tmin
    sel = []
    for ax in range(3):
        is_near = tns[ax] >= torch.maximum(tns[(ax + 1) % 3],
                                           tns[(ax + 2) % 3])
        is_far = tfs[ax] <= torch.minimum(tfs[(ax + 1) % 3],
                                          tfs[(ax + 2) % 3])
        sel.append((entry & is_near) | (~entry & is_far))
    sel[1] = sel[1] & ~sel[0]
    sel[2] = sel[2] & ~sel[0] & ~sel[1]
    comps = []
    for ax in range(3):
        d_sign = torch.where(d[ax] >= 0.0, 1.0, -1.0)
        n_sign = torch.where(entry, -d_sign, d_sign)
        comps.append(torch.where(sel[ax], n_sign, 0.0))
    uu = vv = torch.zeros_like(t)
    for ax, (ia, ib) in ((0, (1, 2)), (1, (0, 2)), (2, (0, 1))):
        fu = (point[ia] - bmin[ia]) / torch.clamp_min(bmax[ia] - bmin[ia],
                                                      1e-20)
        fv = (point[ib] - bmin[ib]) / torch.clamp_min(bmax[ib] - bmin[ib],
                                                      1e-20)
        uu = torch.where(sel[ax], fu, uu)
        vv = torch.where(sel[ax], fv, vv)
    return point, Vec3(*comps), uu, vv


def _sphere_uv(n: Vec3):
    """Spherical uv from the unit normal (the reference's _sphere_uv, with
    the exact atan2 and asin).

    Detached from autograd, as the reference detaches it: at a pole
    (n = (0, +-1, 0)) the backward of asin is inf and that of atan2(0, 0)
    NaN, and a NaN reaches every shared gradient (the camera's) through
    the lane sum even where the cotangent arriving here is zero.  Texture
    coordinates carry no gradient in the reference's scope (its diff.py);
    gradients through the hit point still flow."""
    n = Vec3(*(c.detach() for c in n))
    phi = torch.atan2(n.z, n.x)
    theta = torch.asin(torch.clamp(n.y, -1.0, 1.0))
    u = 1.0 - (phi + np.pi) / (2.0 * np.pi)
    v = (theta + np.pi / 2.0) / np.pi
    return u, v


def _payload(ptype: int, axis: int, p9, o: Vec3, d: Vec3, t, time, tmin):
    """World-or-object-space (point, normal, u, v) for one gathered prim per
    ray; p9: list of 9 [N] param planes."""
    check_prim_type(ptype)
    if ptype == S.PRIM_BOX:
        return _box_payload(p9, o, d, t, tmin)
    point = _ray_point(o, d, t)
    if ptype in VOLUME_PRIMS:        # a constant +X normal and zero uv
        zero = torch.zeros_like(t)
        return point, Vec3(torch.ones_like(t), zero, zero), zero, zero
    if ptype in (S.PRIM_SPHERE, S.PRIM_MOVING_SPHERE):
        center = Vec3(p9[0], p9[1], p9[2])
        if ptype == S.PRIM_MOVING_SPHERE:
            center = _moving_center(center, Vec3(p9[4], p9[5], p9[6]),
                                    p9[7], p9[8], time)
        r_safe = torch.where(p9[3].abs() > 1e-20, p9[3], 1.0)
        normal = (point - center) * (1.0 / r_safe)
        return (point, normal, *_sphere_uv(normal))
    ia, ib = _AXIS_OTHERS[axis]
    zero = torch.zeros_like(t)
    sign = torch.where(p9[6] > 0.5, -1.0, 1.0)
    comps = [zero, zero, zero]
    comps[axis] = sign
    u = (point[ia] - p9[0]) / torch.clamp_min(p9[1] - p9[0], 1e-20)
    v = (point[ib] - p9[2]) / torch.clamp_min(p9[3] - p9[2], 1e-20)
    return point, Vec3(*comps), u, v


def _chunk_mat(m):
    """[C, 3, 4] affine batch -> nested [C, 1] columns for vec.affine_*."""
    return [[m[:, i, j:j + 1] for j in range(4)] for i in range(3)]


def _xform_rays(w2o, o: Vec3, d: Vec3):
    """Object-space rays per prim: Vec3 of [C, N] planes."""
    m = _chunk_mat(w2o)
    return V.affine_point(m, o), V.affine_vec(m, d)


def _block_t(ptype, axis, has_xform, params, w2o, slots, o, d, tmin, tmax,
             time, vol_u, valid):
    """t-matrix [C, N] for one block of C same-typed primitives; `slots`
    [C] are the rows' volume slots (-1 off volumes)."""
    check_prim_type(ptype)
    if has_xform:
        o, d = _xform_rays(w2o, o, d)
    if ptype == S.PRIM_SPHERE:
        t = sphere_t(params, o, d, tmin, tmax)
    elif ptype == S.PRIM_MOVING_SPHERE:
        t = moving_sphere_t(params, o, d, tmin, tmax, time)
    elif ptype == S.PRIM_RECT:
        t = rect_t(params, o, d, tmin, tmax, axis)
    elif ptype == S.PRIM_BOX:
        t = box_t(params, o, d, tmin, tmax)
    else:
        u = vol_u[torch.clamp_min(slots, 0).long()]          # [C, N]
        fn = (volume_sphere_t if ptype == S.PRIM_VOLUME_SPHERE
              else volume_box_t)
        t = fn(params, o, d, tmin, tmax, u)
    return torch.where(valid[:, None], t, BIG)


def _block_ts(scene, entry, o, d, tmin, tmax, time, vol_u):
    """(first row, [C, N] t-matrix) of each block of one group: the
    reference's scan over fixed-size blocks as a Python loop."""
    start, count, size, ptype, axis, has_xform, block = entry
    prims = scene.prims
    for b0 in range(start, start + size, block):
        c = min(block, start + size - b0)
        valid = torch.arange(b0 - start, b0 - start + c,
                             device=prims.params.device) < count
        yield b0, _block_t(ptype, axis, has_xform, prims.params[b0:b0 + c],
                           prims.w2o[b0:b0 + c], prims.vol_slot[b0:b0 + c],
                           o, d, tmin, tmax, time, vol_u, valid)


def intersect_scene(scene, o: Vec3, d: Vec3, tmin, tmax, time,
                    vol_u) -> Hit:
    """Nearest hit of each ray against every primitive.  `tmax` is a scalar
    or a per-lane [N] tensor; `time` the per-lane [N] shutter time (only
    moving spheres read it); `vol_u` the [max(n_vol, 1), N] free-flight
    uniforms (only volumes read them); t is in units of |d|."""
    n = o.x.shape[0]
    dev = o.x.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for entry in scene.chunk_plan:
        for b0, t_mat in _block_ts(scene, entry, o, d, tmin, tmax, time,
                                   vol_u):
            c_t, c_arg = torch.min(t_mat, dim=0)
            better = c_t < best_t
            best_t = torch.where(better, c_t, best_t)
            best_prim = torch.where(better, b0 + c_arg, best_prim)

    prims = scene.prims
    hit_mask = best_prim >= 0
    safe_prim = torch.clamp_min(best_prim, 0)
    t_pay = torch.where(hit_mask, best_t, 0.0)
    p9 = [prims.params[:, k][safe_prim] for k in range(S.NUM_PRIM_PARAMS)]
    point, normal, u, v = _winner_payload(scene, safe_prim, hit_mask, p9, o,
                                          d, t_pay, time, tmin)
    mat_id = torch.where(hit_mask, prims.material_id[safe_prim], 0)
    return Hit(t=best_t, prim_idx=best_prim, mat_id=mat_id, point=point,
               normal=normal, u=u, v=v)


def _gather_xform(prims, idx):
    """The world->object and object->world transforms of each ray's
    winning prim, as nested [3][4] lists of [N] planes."""
    w2o = [[prims.w2o[:, i, j][idx] for j in range(4)] for i in range(3)]
    o2w = [[prims.o2w[:, i, j][idx] for j in range(4)] for i in range(3)]
    return w2o, o2w


def _winner_payload(scene, safe_prim, hit_mask, p9, o: Vec3, d: Vec3, t_pay,
                    time, tmin):
    """(point, unit normal, u, v) for per-ray winners: one statically typed
    payload per chunk-plan group, selected by the group owning the winner.
    Shared by intersect_scene and reeval_hit."""
    n = t_pay.shape[0]
    prims = scene.prims
    if any(e[5] for e in scene.chunk_plan):
        w2o_g, o2w_g = _gather_xform(prims, safe_prim)
        o_x, d_x = V.affine_point(w2o_g, o), V.affine_vec(w2o_g, d)

    zero = torch.zeros(n, dtype=torch.float32, device=t_pay.device)
    point = Vec3(zero, zero, zero)
    normal = Vec3(zero, zero, zero)
    uu = vv = zero
    for start, count, size, ptype, axis, has_xform, _ in scene.chunk_plan:
        in_group = hit_mask & (safe_prim >= start) & (safe_prim < start + size)
        o_sel, d_sel = (o_x, d_x) if has_xform else (o, d)
        g_point, g_normal, g_u, g_v = _payload(ptype, axis, p9, o_sel, d_sel,
                                               t_pay, time, tmin)
        if has_xform:
            g_point = V.affine_point(o2w_g, g_point)
            # normal transforms with (W2O)^T
            g_normal = Vec3(
                w2o_g[0][0] * g_normal.x + w2o_g[1][0] * g_normal.y
                + w2o_g[2][0] * g_normal.z,
                w2o_g[0][1] * g_normal.x + w2o_g[1][1] * g_normal.y
                + w2o_g[2][1] * g_normal.z,
                w2o_g[0][2] * g_normal.x + w2o_g[1][2] * g_normal.y
                + w2o_g[2][2] * g_normal.z,
            )
        point = V.where(in_group, g_point, point)
        normal = V.where(in_group, g_normal, normal)
        uu = torch.where(in_group, g_u, uu)
        vv = torch.where(in_group, g_v, vv)
    return point, normal.normalized(), uu, vv


def reeval_hit(scene, prim_idx, o: Vec3, d: Vec3, tmin, tmax, time, vol_u,
               t_hint=None) -> Hit:
    """The hit record of a detached winner, recomputed with gradients (the
    reference's reeval_hit).

    The gradient path takes each ray's winner `prim_idx` from the split
    kernel, run without gradients: the winner is a piecewise-constant
    decision, as intersect_scene's argmin is.  This recomputes t and the
    payload of just that prim per ray in plain torch, so t carries the
    gradients of the ray and the payload those of t, as through
    intersect_scene.

    `t_hint`: the kernel's t, used detached only where the re-evaluation
    misses a winner the kernel accepted (a root within an ulp of the
    window's edge), so the payload never sees BIG."""
    n = o.x.shape[0]
    prims = scene.prims
    hit_mask = prim_idx >= 0
    sp = torch.clamp_min(prim_idx, 0)
    p9 = [prims.params[:, k][sp] for k in range(S.NUM_PRIM_PARAMS)]
    if scene.n_vol > 0:
        slots = torch.clamp_min(prims.vol_slot[sp], 0).long()
        u_sel = vol_u.gather(0, slots[None, :])[0]
    else:
        u_sel = torch.zeros(n, dtype=torch.float32, device=o.x.device)
    if any(e[5] for e in scene.chunk_plan):
        w2o_g, _ = _gather_xform(prims, sp)
        o_t, d_t = V.affine_point(w2o_g, o), V.affine_vec(w2o_g, d)

    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=o.x.device).expand(n)
    t_re = torch.zeros(n, dtype=torch.float32, device=o.x.device)
    for start, count, size, ptype, axis, has_xform, _ in scene.chunk_plan:
        check_prim_type(ptype)
        in_group = hit_mask & (sp >= start) & (sp < start + size)
        o_sel, d_sel = (o_t, d_t) if has_xform else (o, d)
        if ptype == S.PRIM_SPHERE:
            t_g = sphere_t(p9, o_sel, d_sel, tmin, tmax)
        elif ptype == S.PRIM_MOVING_SPHERE:
            t_g = moving_sphere_t(p9, o_sel, d_sel, tmin, tmax, time)
        elif ptype == S.PRIM_RECT:
            t_g = rect_t(p9, o_sel, d_sel, tmin, tmax, axis)
        elif ptype == S.PRIM_BOX:
            t_g = box_t(p9, o_sel, d_sel, tmin, tmax)
        else:
            fn = (volume_sphere_t if ptype == S.PRIM_VOLUME_SPHERE
                  else volume_box_t)
            t_g = fn(p9, o_sel, d_sel, tmin, tmax, u_sel)
        t_re = torch.where(in_group, t_g, t_re)

    if t_hint is not None:
        t_re = torch.where(t_re < BIG * 0.5, t_re, t_hint.detach())
    t_pay = torch.where(hit_mask, t_re, 0.0)
    point, normal, u, v = _winner_payload(scene, sp, hit_mask, p9, o, d,
                                          t_pay, time, tmin)
    mat_id = torch.where(hit_mask, prims.material_id[sp], 0)
    return Hit(t=torch.where(hit_mask, t_re, BIG), prim_idx=prim_idx,
               mat_id=mat_id, point=point, normal=normal, u=u, v=v)


def occluded(scene, o: Vec3, d: Vec3, tmin, tmax, time, vol_u):
    """Boolean shadow query: any hit in (tmin, tmax)?  Volumes take part
    stochastically through the shadow ray's own uniforms `vol_u`."""
    occ = torch.zeros(o.x.shape[0], dtype=torch.bool, device=o.x.device)
    for entry in scene.chunk_plan:
        for _, t_mat in _block_ts(scene, entry, o, d, tmin, tmax, time,
                                  vol_u):
            occ = occ | (t_mat < BIG).any(dim=0)
    return occ
