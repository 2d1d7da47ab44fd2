"""Host-side scene construction (port of rtw_tpu/models/builder.py).

Numpy up to the freeze, exactly as the reference, so a port scene and a
reference scene are built from the same arrays.  Only the freeze differs:
`torch.as_tensor` replaces `jnp.asarray`, and `Scene.to(device)` moves the
result.  See the reference module for the transform pre-baking and static
chunk planning.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from . import scene as S

ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets")


def pack_rgb8(img_u8: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] -> 0x00BBGGRR uint32 (texture atlas layout)."""
    flat = np.ascontiguousarray(img_u8, np.uint8).reshape(-1, 3)
    flat = flat.astype(np.uint32)
    return (flat[:, 0] | (flat[:, 1] << 8)
            | (flat[:, 2] << 16)).reshape(img_u8.shape[:-1])


# --------------------------------------------------------------------------
# Transforms (ioTransform.h:15-131; row-major 4x4, applied right-to-left:
# T @ R means rotate first then translate, matching `transf = translate(...);
# transf *= rotateY(...)` in ioScene.h:546-548)
# --------------------------------------------------------------------------

def translate(offset) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = offset
    return m


def _rot(axis: int, deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float64)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    if axis == 1:  # rotateY sign convention (ioTransform.h:105-116)
        m[i, j] = s
        m[j, i] = -s
    else:
        m[i, j] = -s
        m[j, i] = s
    return m


def rotate_x(deg: float) -> np.ndarray:
    return _rot(0, deg)


def rotate_y(deg: float) -> np.ndarray:
    return _rot(1, deg)


def rotate_z(deg: float) -> np.ndarray:
    return _rot(2, deg)


def scale(sx, sy, sz) -> np.ndarray:
    return np.diag([sx, sy, sz, 1.0]).astype(np.float64)


def _is_rigid(m: np.ndarray) -> bool:
    r = m[:3, :3]
    return bool(np.allclose(r @ r.T, np.eye(3), atol=1e-5))


def _pack565_pairs(im: np.ndarray) -> np.ndarray:
    """uint8 [h, w, 3] -> uint32 [h, w]: RGB565 of texel(x, y) in the low
    half-word, RGB565 of texel(min(x+1, w-1), y) in the high half-word
    (clamp addressing baked into the pairing).  See Textures.images_packed565."""
    r = np.round(im[..., 0].astype(np.float32) / 255.0 * 31).astype(np.uint32)
    g = np.round(im[..., 1].astype(np.float32) / 255.0 * 63).astype(np.uint32)
    b = np.round(im[..., 2].astype(np.float32) / 255.0 * 31).astype(np.uint32)
    v = (r << np.uint32(11)) | (g << np.uint32(5)) | b
    right = np.concatenate([v[:, 1:], v[:, -1:]], axis=1)
    return (v | (right << np.uint32(16))).astype(np.uint32)


def _rect_corners_world(p: "_Prim") -> Optional[np.ndarray]:
    """World-space corners [4, 3] of a rect primitive (None for non-rects)."""
    if p.ptype != S.PRIM_RECT:
        return None
    q = p.params.astype(np.float64)
    a0, a1, b0, b1, k = q[0], q[1], q[2], q[3], q[4]
    axis = int(q[5])
    ia, ib = [(1, 2), (0, 2), (0, 1)][axis]
    corners = np.zeros((4, 3))
    for ci, (a, bb) in enumerate([(a0, b0), (a1, b0), (a0, b1), (a1, b1)]):
        c = np.zeros(3)
        c[axis] = k
        c[ia] = a
        c[ib] = bb
        corners[ci] = c
    if p.transform is not None:
        h = np.concatenate([corners, np.ones((4, 1))], axis=1)
        corners = (p.transform @ h.T).T[:, :3]
    return corners


def _quad_square_overlap(a: np.ndarray, b: np.ndarray,
                         eps: float = 1e-3) -> bool:
    """Whether the convex quad with in-plane corner coords (a[i], b[i])
    (corner order of _rect_corners_world: (a0,b0),(a1,b0),(a0,b1),(a1,b1))
    overlaps the INTERIOR of the unit square by more than `eps`, via the
    separating-axis test.  Boundary-touching (adjacent coplanar lights)
    and diagonally-offset rotated quads both report False."""
    quad = np.stack([a, b], axis=1)[[0, 1, 3, 2]]      # winding order
    sq = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    for poly in (quad, sq):
        for i in range(4):
            e = poly[(i + 1) % 4] - poly[i]
            nrm = np.array([-e[1], e[0]])
            ln = float(np.hypot(*nrm))
            if ln < 1e-12:
                continue
            nrm = nrm / ln
            p = quad @ nrm
            q = sq @ nrm
            if p.max() <= q.min() + eps or q.max() <= p.min() + eps:
                return False
    return True


def _match_lights_to_prims(prims: list["_Prim"], mat_type: list[int],
                           lights: list[dict]) -> list[int]:
    """Per-prim light row (-1 if none): which Lights row each emissive rect
    primitive realizes.  A prim matches light row l when its corners, mapped
    into the light parallelogram's (u, v) frame, lie WITHIN the unit square
    (containment, not equality: a light may be realized by several prims
    tiling it) — with slack along the light normal, because reference
    scenes deliberately offset the light geometry off the sampled plane
    (Cornell: rect prim at k=554.9, LightDefinition at y=554,
    ioScene.h:534/605-612 — SURVEY §7.4 quirk 15).  A prim only PARTLY
    overlapping a light (hanging outside it) is REJECTED at build time: a
    light_row for it would mis-weight hits outside the light, while -1
    would double-count hits inside (NEE samples the area, then the BSDF
    sample takes full weight) — correctness needs a per-hit containment
    test nothing in the reference requires, so the build fails loudly
    instead of silently biasing either way.  A registered light that no
    prim realizes gets the same treatment: NEE then illuminates from
    geometry that cannot occlude/emit consistently, and a tolerance
    failure in this matcher would otherwise be invisible."""
    rows = []
    matched = [0] * len(lights)
    for pi, p in enumerate(prims):
        row = -1
        if mat_type[p.material] == S.MAT_DIFFUSE_LIGHT:
            corners = _rect_corners_world(p)
            if corners is not None:
                for li, l in enumerate(lights):
                    u, v, n = l["vec_u"], l["vec_v"], l["normal"]
                    rel = corners - l["position"][None, :]
                    # slack along the normal: 2% of the light's linear size
                    off = np.abs(rel @ n)
                    if off.max() > 0.02 * np.sqrt(l["area"]):
                        continue
                    # in-plane coordinates via the Gram system
                    uu, vv_, uv = u @ u, v @ v, u @ v
                    det = uu * vv_ - uv * uv
                    if det <= 1e-20:
                        continue
                    ru = rel @ u
                    rv = rel @ v
                    a = (ru * vv_ - rv * uv) / det
                    bb = (rv * uu - ru * uv) / det
                    inside = ((a > -1e-3) & (a < 1 + 1e-3)
                              & (bb > -1e-3) & (bb < 1 + 1e-3))
                    if inside.all():
                        row = li
                        matched[li] += 1
                        break
                    # coplanar but straddling the light's boundary: no
                    # light_row assignment is unbiased (see docstring).
                    # True convex-polygon INTERIOR overlap (separating-axis
                    # test, not a corner bounding box — a rotated coplanar
                    # rect diagonally off the light's corner must NOT be
                    # rejected); an adjacent prim touching the boundary
                    # overlaps by <= eps and passes.
                    if _quad_square_overlap(a, bb):
                        raise ValueError(
                            f"emissive prim {pi} partially overlaps "
                            f"registered light {li} (in-plane coords a="
                            f"[{a.min():.4f},{a.max():.4f}] b="
                            f"[{bb.min():.4f},{bb.max():.4f}] vs the unit "
                            "square): no light_row assignment gives an "
                            "unbiased MIS weight for such an arrangement. "
                            "Align the prim with the light, or register "
                            "the prim's own rectangle as the light.")
        rows.append(row)
    for li, l in enumerate(lights):
        if matched[li] == 0:
            import warnings

            warnings.warn(
                f"registered light {li} (position {l['position']}) matched "
                "no emissive primitive — NEE will sample it but BSDF-side "
                "hits cannot identify it, overcounting its contribution. "
                "Check the light geometry against its emissive prim "
                "(normal offset tolerance is 2% of sqrt(area)).",
                stacklevel=3)
    return rows


def _prim_aabb(p: "_Prim") -> tuple[np.ndarray, np.ndarray]:
    """Conservative world-space AABB of one primitive (for the trace
    kernels' per-tile block culling).  Object-space bounds are pushed
    through the instance transform corner-wise."""
    q = p.params.astype(np.float64)
    if p.ptype in (S.PRIM_SPHERE, S.PRIM_VOLUME_SPHERE):
        lo, hi = q[0:3] - q[3], q[0:3] + q[3]
    elif p.ptype == S.PRIM_MOVING_SPHERE:
        lo = np.minimum(q[0:3], q[4:7]) - q[3]
        hi = np.maximum(q[0:3], q[4:7]) + q[3]
    elif p.ptype == S.PRIM_RECT:
        axis = int(q[5])
        ia, ib = [(1, 2), (0, 2), (0, 1)][axis]
        lo = np.empty(3)
        hi = np.empty(3)
        lo[axis] = hi[axis] = q[4]
        lo[ia], hi[ia] = q[0], q[1]
        lo[ib], hi[ib] = q[2], q[3]
    elif p.ptype in (S.PRIM_VOLUME_BOX, S.PRIM_BOX):
        lo, hi = q[0:3], q[3:6]
    else:  # pragma: no cover
        raise ValueError(p.ptype)
    if p.transform is not None:
        xs = [lo[0], hi[0]]
        ys = [lo[1], hi[1]]
        zs = [lo[2], hi[2]]
        pts = np.array([(x, y, z, 1.0) for x in xs for y in ys for z in zs])
        world = (p.transform @ pts.T).T[:, :3]
        lo, hi = world.min(axis=0), world.max(axis=0)
    eps = 1e-3 + 1e-5 * np.maximum(np.abs(lo), np.abs(hi))
    return (lo - eps).astype(np.float32), (hi + eps).astype(np.float32)


# --------------------------------------------------------------------------
# Builder
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Prim:
    ptype: int
    params: np.ndarray        # [9]
    material: int
    transform: Optional[np.ndarray]   # 4x4 object->world or None
    axis: int = 0             # rect axis


class SceneBuilder:
    def __init__(self):
        self._prims: list[_Prim] = []
        self._mat_type: list[int] = []
        self._mat_tex: list[int] = []
        self._mat_fuzz: list[float] = []
        self._mat_eta: list[float] = []
        self._tex_rows: list[dict] = []
        self._images: list[np.ndarray] = []
        self._lights: list[dict] = []
        self._camera: Optional[S.Camera] = None

    # --- textures (ioTexture.h) ------------------------------------------
    def _add_tex(self, **kw) -> int:
        row = dict(tex_type=S.TEX_NULL, color=(0.0, 0.0, 0.0), odd=0, even=0,
                   scale=1.0, image_id=-1)
        row.update(kw)
        self._tex_rows.append(row)
        return len(self._tex_rows) - 1

    def constant_texture(self, color) -> int:
        return self._add_tex(tex_type=S.TEX_CONSTANT, color=tuple(color))

    def null_texture(self) -> int:
        return self._add_tex(tex_type=S.TEX_NULL)

    def checker_texture(self, odd: int, even: int) -> int:
        for child in (odd, even):
            if self._tex_rows[child]["tex_type"] == S.TEX_CHECKER:
                raise ValueError("checker children must be non-checker textures")
        return self._add_tex(tex_type=S.TEX_CHECKER, odd=odd, even=even)

    def noise_texture(self, scale: float) -> int:
        """Perlin-marble texture (gradients are hash-derived at shade time,
        ops/textures.py:_lattice_gradient — no tables)."""
        return self._add_tex(tex_type=S.TEX_NOISE, scale=scale)

    def image_texture(self, path: str) -> int:
        from PIL import Image

        img = Image.open(path).convert("RGB")
        arr = np.asarray(img, dtype=np.uint8)
        # store with row 0 at v=0 (image bottom), matching the reference's
        # row flip at load (ioTexture.h:252-275) + normalized-v fetch
        arr = arr[::-1].copy()
        self._images.append(arr)
        return self._add_tex(tex_type=S.TEX_IMAGE, image_id=len(self._images) - 1)

    # --- materials (material/io*.h) --------------------------------------
    def _add_mat(self, mtype, tex, fuzz=0.0, eta=1.0) -> int:
        self._mat_type.append(mtype)
        self._mat_tex.append(tex)
        self._mat_fuzz.append(fuzz)
        self._mat_eta.append(eta)
        return len(self._mat_type) - 1

    def lambertian(self, tex: int) -> int:
        return self._add_mat(S.MAT_LAMBERTIAN, tex)

    def metal(self, tex: int, fuzz: float) -> int:
        # fuzz clamped to 1 (ioMetalMaterial.h:34-38)
        return self._add_mat(S.MAT_METAL, tex, fuzz=min(fuzz, 1.0))

    def dielectric(self, eta: float) -> int:
        return self._add_mat(S.MAT_DIELECTRIC, self.null_texture(), eta=eta)

    def diffuse_light(self, tex: int) -> int:
        return self._add_mat(S.MAT_DIFFUSE_LIGHT, tex)

    def isotropic(self, tex: int) -> int:
        return self._add_mat(S.MAT_ISOTROPIC, tex)

    def normal_material(self) -> int:
        return self._add_mat(S.MAT_NORMAL, self.null_texture())

    # --- geometry (geometry/io*.h) ---------------------------------------
    def _params(self, *vals) -> np.ndarray:
        p = np.zeros(S.NUM_PRIM_PARAMS, np.float32)
        p[: len(vals)] = vals
        return p

    def sphere(self, center, radius, material: int, transform=None):
        center = np.asarray(center, np.float64)
        if transform is not None and _is_rigid(transform):
            center = (transform[:3, :3] @ center) + transform[:3, 3]
            transform = None
        self._prims.append(_Prim(S.PRIM_SPHERE,
                                 self._params(*center, radius), material, transform))

    def moving_sphere(self, c0, c1, radius, t0, t1, material: int, transform=None):
        c0 = np.asarray(c0, np.float64)
        c1 = np.asarray(c1, np.float64)
        if transform is not None and _is_rigid(transform):
            c0 = (transform[:3, :3] @ c0) + transform[:3, 3]
            c1 = (transform[:3, :3] @ c1) + transform[:3, 3]
            transform = None
        self._prims.append(_Prim(S.PRIM_MOVING_SPHERE,
                                 self._params(*c0, radius, *c1, t0, t1),
                                 material, transform))

    def rect(self, a0, a1, b0, b1, k, flip: bool, axis: int, material: int,
             transform=None):
        """Axis-aligned rect (ioAARect.h). axis in {AXIS_X, AXIS_Y, AXIS_Z};
        (a, b) are the two non-`axis` coordinates in ascending axis order."""
        self._prims.append(_Prim(S.PRIM_RECT,
                                 self._params(a0, a1, b0, b1, k, axis, 1.0 if flip else 0.0),
                                 material, transform, axis=axis))

    def box(self, bmin, bmax, material: int, transform=None):
        """Solid axis-aligned box — ONE slab-test primitive where the
        reference composes 6 AARects (ioGeometryGroup.h:27-41 createBox).
        Identical hits, outward normals and per-face uv (ops/intersect.box_t
        / _box_payload); 1/6 the primitive count matters because the trace
        sweep cost is linear in live primitives (TNW-final: 2400 ground
        rects -> 400 boxes)."""
        self._prims.append(_Prim(S.PRIM_BOX,
                                 self._params(*bmin, *bmax), material,
                                 transform))

    def box_rects(self, bmin, bmax, material: int, transform=None):
        """Axis-aligned box from 6 rects, in the exact order/flip layout of
        ioGeometryGroup.h createBox (outward normals: flip at min faces).
        Kept as the reference composite for equivalence tests against the
        PRIM_BOX collapse."""
        x0, y0, z0 = bmin
        x1, y1, z1 = bmax
        self.rect(x0, x1, y0, y1, z0, True, S.AXIS_Z, material, transform)
        self.rect(x0, x1, y0, y1, z1, False, S.AXIS_Z, material, transform)
        self.rect(x0, x1, z0, z1, y0, True, S.AXIS_Y, material, transform)
        self.rect(x0, x1, z0, z1, y1, False, S.AXIS_Y, material, transform)
        self.rect(y0, y1, z0, z1, x0, True, S.AXIS_X, material, transform)
        self.rect(y0, y1, z0, z1, x1, False, S.AXIS_X, material, transform)

    def volume_sphere(self, center, radius, density, material: int, transform=None):
        center = np.asarray(center, np.float64)
        if transform is not None and _is_rigid(transform):
            center = (transform[:3, :3] @ center) + transform[:3, 3]
            transform = None
        self._prims.append(_Prim(S.PRIM_VOLUME_SPHERE,
                                 self._params(*center, radius, density),
                                 material, transform))

    def volume_box(self, bmin, bmax, density, material: int, transform=None):
        self._prims.append(_Prim(S.PRIM_VOLUME_BOX,
                                 self._params(*bmin, *bmax, density),
                                 material, transform))

    # --- lights (LightDefinition, raydata.cuh:31-48) ----------------------
    def add_light(self, position, vec_u, vec_v, emission, tex: int = -1):
        """`tex` optionally names the texture row backing the light's
        emission so NEE and BSDF-side emission share one differentiable
        parameter (see diff.py)."""
        u = np.asarray(vec_u, np.float64)
        v = np.asarray(vec_v, np.float64)
        n = np.cross(u, v)
        area = float(np.linalg.norm(n))
        self._lights.append(dict(position=np.asarray(position, np.float64),
                                 vec_u=u, vec_v=v,
                                 emission=np.asarray(emission, np.float64),
                                 area=area, normal=n / max(area, 1e-30),
                                 tex=tex))

    # --- camera -----------------------------------------------------------
    def set_camera(self, lookfrom, lookat, vup, vfov, aspect, aperture,
                   focus_dist, t0=0.0, t1=0.0):
        self._camera = S.make_camera(lookfrom, lookat, vup, vfov, aspect,
                                     aperture, focus_dist, t0, t1)

    # --- build ------------------------------------------------------------
    def build(self, chunk_size: int = 64) -> S.Scene:
        """Freeze into a Scene of CPU tensors (`Scene.to` moves it).

        `chunk_size`: primitives per block for groups larger than one block.
        64 (not 256): blocks are the culling granule of the kernels' per-ray
        walk (csrc/geometry.cuh::walk_blocks, over the hierarchy of
        ops/trace_kernel.augment_aabbs): finer blocks mean tighter AABBs
        and more skippable work, while a block's own slab test is small
        next to its 64 prim tests."""
        T = torch.as_tensor

        if self._camera is None:
            raise ValueError("scene has no camera")
        if not self._prims:
            raise ValueError("scene has no geometry")

        # assign volume slots (order = declaration order)
        n_vol = 0
        vol_slots = {}
        for i, p in enumerate(self._prims):
            if p.ptype in (S.PRIM_VOLUME_SPHERE, S.PRIM_VOLUME_BOX):
                vol_slots[i] = n_vol
                n_vol += 1

        # group by (ptype, axis-for-rects, has_transform)
        def key(i):
            p = self._prims[i]
            return (p.ptype, p.axis if p.ptype == S.PRIM_RECT else 0,
                    p.transform is not None)

        order = sorted(range(len(self._prims)), key=key)
        groups: list[tuple] = []
        for i in order:
            k = key(i)
            if groups and groups[-1][0] == k:
                groups[-1][1].append(i)
            else:
                groups.append((k, [i]))

        # Morton-order primitives inside each group so fixed-size blocks are
        # spatially compact: the trace kernels cull whole blocks per ray
        # tile by AABB, which only pays off if a block's prims are neighbors
        # in space, not in scene-construction order.
        def morton(i: int) -> int:
            lo, hi = _prim_aabb(self._prims[i])
            c = (lo + hi) * 0.5
            q = np.clip((c - scene_lo) / scene_ext, 0.0, 1.0)
            q = (q * 1023.0).astype(np.uint32)

            def spread(x):
                x = (x | (x << 16)) & 0x030000FF
                x = (x | (x << 8)) & 0x0300F00F
                x = (x | (x << 4)) & 0x030C30C3
                x = (x | (x << 2)) & 0x09249249
                return x

            return int(spread(q[0]) | (spread(q[1]) << 1)
                       | (spread(q[2]) << 2))

        all_lo = np.stack([_prim_aabb(p)[0] for p in self._prims])
        all_hi = np.stack([_prim_aabb(p)[1] for p in self._prims])
        scene_lo = all_lo.min(axis=0)
        scene_ext = np.maximum(all_hi.max(axis=0) - scene_lo, 1e-6)
        groups = [(k, sorted(idxs, key=morton)) for k, idxs in groups]

        light_rows = _match_lights_to_prims(self._prims, self._mat_type,
                                            self._lights)
        ptype_arr, params_arr, mat_arr, o2w_arr, w2o_arr, slot_arr = [], [], [], [], [], []
        lrow_arr = []
        aabb_lo, aabb_hi = [], []
        chunk_plan = []
        cursor = 0
        pad_param = np.zeros(S.NUM_PRIM_PARAMS, np.float32)

        for (ptype, axis, has_xform), idxs in groups:
            count = len(idxs)
            if count > chunk_size:
                # large group: scanned in fixed blocks (see ops/intersect.py)
                block = chunk_size
                size = -(-count // block) * block
            else:
                # small group: one padded VPU-friendly block
                block = max(8, -(-count // 8) * 8)
                size = block
            chunk_plan.append((cursor, count, size, ptype, axis, has_xform,
                               block))
            for i in idxs:
                p = self._prims[i]
                ptype_arr.append(p.ptype)
                params_arr.append(p.params)
                mat_arr.append(p.material)
                m = p.transform if p.transform is not None else np.eye(4)
                o2w_arr.append(m[:3].astype(np.float32))
                w2o_arr.append(np.linalg.inv(m)[:3].astype(np.float32))
                slot_arr.append(vol_slots.get(i, -1))
                lrow_arr.append(light_rows[i])
                lo, hi = _prim_aabb(p)
                aabb_lo.append(lo)
                aabb_hi.append(hi)
            for _ in range(size - count):
                ptype_arr.append(ptype)
                params_arr.append(pad_param)
                mat_arr.append(0)
                o2w_arr.append(S.IDENTITY_3X4)
                w2o_arr.append(S.IDENTITY_3X4)
                slot_arr.append(-1)
                lrow_arr.append(-1)
                aabb_lo.append(np.full(3, np.inf, np.float32))
                aabb_hi.append(np.full(3, -np.inf, np.float32))
            cursor += size

        # per-block world AABBs in the trace kernels' block enumeration order
        lo_np = np.stack(aabb_lo)
        hi_np = np.stack(aabb_hi)
        blocks = []
        for (start, count, size, ptype, axis, has_xform, block) in chunk_plan:
            for b0 in range(start, start + size, block):
                b1 = min(b0 + block, start + size)
                blo = lo_np[b0:b1].min(axis=0)
                bhi = hi_np[b0:b1].max(axis=0)
                row = np.zeros(8, np.float32)
                row[0:3] = blo
                row[3:6] = bhi
                blocks.append(row)
        block_aabbs = np.stack(blocks) if blocks else np.zeros((1, 8), np.float32)

        # flattened per-prim shading record (see Primitives docstring)
        mat_np = np.array(mat_arr, np.int32)
        m_type = np.array(self._mat_type, np.int32)
        m_tex = np.array(self._mat_tex, np.int32)
        m_fuzz = np.array(self._mat_fuzz, np.float32)
        m_eta = np.array(self._mat_eta, np.float32)
        t_type = np.array([r["tex_type"] for r in self._tex_rows], np.int32)
        t_scale = np.array([r["scale"] for r in self._tex_rows], np.float32)
        t_img = np.array([r["image_id"] for r in self._tex_rows], np.int32)
        t_odd = np.array([r["odd"] for r in self._tex_rows], np.int32)
        t_even = np.array([r["even"] for r in self._tex_rows], np.int32)
        p_tex = m_tex[mat_np]

        prims = S.Primitives(
            prim_type=T(np.array(ptype_arr, np.int32)),
            params=T(np.stack(params_arr)),
            material_id=T(mat_np),
            o2w=T(np.stack(o2w_arr)),
            w2o=T(np.stack(w2o_arr)),
            vol_slot=T(np.array(slot_arr, np.int32)),
            mat_type_p=T(m_type[mat_np]),
            tex_type_p=T(t_type[p_tex]),
            fuzz_p=T(m_fuzz[mat_np]),
            eta_p=T(m_eta[mat_np]),
            scale_p=T(t_scale[p_tex]),
            image_id_p=T(np.maximum(t_img[p_tex], 0)),
            tex_idx=T(p_tex),
            odd_idx=T(np.maximum(t_odd[p_tex], 0)),
            even_idx=T(np.maximum(t_even[p_tex], 0)),
            light_row_p=T(np.array(lrow_arr, np.int32)),
        )

        materials = S.Materials(
            mat_type=T(np.array(self._mat_type, np.int32)),
            albedo_tex=T(np.array(self._mat_tex, np.int32)),
            fuzz=T(np.array(self._mat_fuzz, np.float32)),
            eta=T(np.array(self._mat_eta, np.float32)),
        )

        if self._images:
            dims = np.zeros((len(self._images), 2), np.int32)
            offsets = np.zeros(len(self._images), np.int32)
            chunks = []
            chunks565 = []
            cur = 0
            for i, im in enumerate(self._images):
                h, w = im.shape[0], im.shape[1]
                dims[i] = (h, w)
                offsets[i] = cur
                chunks.append(pack_rgb8(im).reshape(-1))
                chunks565.append(_pack565_pairs(im).reshape(-1))
                cur += h * w
            atlas = np.concatenate(chunks)
            atlas565 = np.concatenate(chunks565)
        else:
            atlas = np.zeros(1, np.uint32)
            atlas565 = np.zeros(1, np.uint32)
            offsets = np.zeros(1, np.int32)
            dims = np.ones((1, 2), np.int32)

        textures = S.Textures(
            tex_type=T(np.array([r["tex_type"] for r in self._tex_rows], np.int32)),
            color=T(np.array([r["color"] for r in self._tex_rows], np.float32)),
            odd=T(np.array([r["odd"] for r in self._tex_rows], np.int32)),
            even=T(np.array([r["even"] for r in self._tex_rows], np.int32)),
            scale=T(np.array([r["scale"] for r in self._tex_rows], np.float32)),
            image_id=T(np.array([r["image_id"] for r in self._tex_rows], np.int32)),
            images_packed=T(atlas),
            images_packed565=T(atlas565),
            image_offset=T(offsets),
            image_dims=T(dims),
        )

        if self._lights:
            lights = S.Lights(
                position=T(np.stack([l["position"] for l in self._lights]).astype(np.float32)),
                vec_u=T(np.stack([l["vec_u"] for l in self._lights]).astype(np.float32)),
                vec_v=T(np.stack([l["vec_v"] for l in self._lights]).astype(np.float32)),
                emission=T(np.stack([l["emission"] for l in self._lights]).astype(np.float32)),
                area=T(np.array([l["area"] for l in self._lights], np.float32)),
                normal=T(np.stack([l["normal"] for l in self._lights]).astype(np.float32)),
            )
        else:  # one dummy row so shapes stay static; masked out via count=0
            z3 = T(np.zeros((1, 3), np.float32))
            lights = S.Lights(position=z3, vec_u=z3, vec_v=z3, emission=z3,
                              area=T(np.ones((1,), np.float32)), normal=z3)

        emissives_unregistered = bool(self._lights) and any(
            self._mat_type[p.material] == S.MAT_DIFFUSE_LIGHT
            and light_rows[i] < 0
            for i, p in enumerate(self._prims))

        mat_present = tuple(k in set(self._mat_type) for k in range(6))
        tex_kinds = {r["tex_type"] for r in self._tex_rows}
        tex_present = tuple(k in tex_kinds for k in range(5))

        scene = S.Scene(
            prims=prims,
            materials=materials,
            textures=textures,
            lights=lights,
            camera=self._camera,
            sky_light=T(np.float32(0.0 if self._lights else 1.0)),
            n_vol=n_vol,
            chunk_plan=tuple(chunk_plan),
            num_lights=len(self._lights),
            light_tex=tuple(l["tex"] for l in self._lights),
            mat_present=mat_present,
            tex_present=tex_present,
            vol_slots_static=tuple(slot_arr),
            emissives_unregistered=emissives_unregistered,
            block_aabbs=T(block_aabbs),
        )
        return scene
