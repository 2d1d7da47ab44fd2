"""Scene data model: dataclasses of tensors (port of rtw_tpu/models/scene.py).

The reference's pytrees become plain dataclasses whose fields are tensors on
one device; `.to(device)` moves a whole scene.  Static fields (the chunk
plan, presence flags, light count) stay Python values, as they were the
reference's static aux data.  `scene_from_numpy` rebuilds a port scene from
a reference scene's arrays, so a test can feed both packages the same scene.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# --- Primitive types (prim_type values) ------------------------------------
PRIM_SPHERE = 0          # params: cx cy cz r
PRIM_RECT = 1            # params: a0 a1 b0 b1 k axis flip
PRIM_MOVING_SPHERE = 2   # params: cx cy cz r cx1 cy1 cz1 t0 t1
PRIM_VOLUME_SPHERE = 3   # params: cx cy cz r density
PRIM_VOLUME_BOX = 4      # params: minx miny minz maxx maxy maxz density
PRIM_BOX = 5             # params: minx miny minz maxx maxy maxz
NUM_PRIM_PARAMS = 9

AXIS_X = 0
AXIS_Y = 1
AXIS_Z = 2

# --- Material types (mat_type values) ---------------------------------------
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4
MAT_NORMAL = 5

# --- Texture types (tex_type values) ----------------------------------------
TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_NOISE = 2
TEX_IMAGE = 3
TEX_NULL = 4

IDENTITY_3X4 = np.array(
    [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]], dtype=np.float32
)


class _Tensors:
    """`.to(device)` for a dataclass whose fields are all tensors."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class Primitives(_Tensors):
    """Unified primitive SoA: [P] rows, transforms default to identity, plus
    the per-prim flattened shading record (see the reference's docstring)."""

    prim_type: Any      # int32 [P]
    params: Any         # float32 [P, NUM_PRIM_PARAMS]
    material_id: Any    # int32 [P]
    o2w: Any            # float32 [P, 3, 4] object -> world
    w2o: Any            # float32 [P, 3, 4] world -> object
    vol_slot: Any       # int32 [P]; volume prims' free-flight slot, else -1
    mat_type_p: Any     # int32 [P]   MAT_*
    tex_type_p: Any     # int32 [P]   TEX_* of the albedo texture
    fuzz_p: Any         # float32 [P] metal fuzz
    eta_p: Any          # float32 [P] dielectric eta
    scale_p: Any        # float32 [P] noise scale
    image_id_p: Any     # int32 [P]   image index (0 if none)
    tex_idx: Any        # int32 [P]   row in Textures.color
    odd_idx: Any        # int32 [P]   checker odd child row (0 if none)
    even_idx: Any       # int32 [P]   checker even child row
    light_row_p: Any    # int32 [P]   Lights row this prim realizes, or -1


@dataclasses.dataclass
class Materials(_Tensors):
    mat_type: Any       # int32 [M]
    albedo_tex: Any     # int32 [M]
    fuzz: Any           # float32 [M]
    eta: Any            # float32 [M]


@dataclasses.dataclass
class Textures(_Tensors):
    tex_type: Any       # int32 [T]
    color: Any          # float32 [T, 3]
    odd: Any            # int32 [T]
    even: Any           # int32 [T]
    scale: Any          # float32 [T]
    image_id: Any       # int32 [T]
    images_packed: Any  # uint32 [sum(h*w)]  0x00BBGGRR texels
    images_packed565: Any  # uint32 [sum(h*w)] RGB565 pairs
    image_offset: Any   # int32 [n_images]
    image_dims: Any     # int32 [n_images, 2] (h, w)


@dataclasses.dataclass
class Lights(_Tensors):
    """Parallelogram area lights."""

    position: Any       # float32 [L, 3]
    vec_u: Any          # float32 [L, 3]
    vec_v: Any          # float32 [L, 3]
    emission: Any       # float32 [L, 3]
    area: Any           # float32 [L]
    normal: Any         # float32 [L, 3]


@dataclasses.dataclass
class Camera(_Tensors):
    """Thin-lens camera frustum."""

    origin: Any         # float32 [3]
    lower_left: Any     # float32 [3]
    horizontal: Any     # float32 [3]
    vertical: Any       # float32 [3]
    u: Any              # float32 [3]
    v: Any              # float32 [3]
    w: Any              # float32 [3]
    lens_radius: Any    # float32 scalar
    time0: Any          # float32 scalar
    time1: Any          # float32 scalar


def make_camera(lookfrom, lookat, vup, vfov_deg, aspect, aperture, focus_dist,
                t0=0.0, t1=0.0) -> Camera:
    """Build the frustum exactly as ioPerspectiveCamera does, in float32 with
    the reference's operation order."""
    f32 = torch.float32
    lookfrom = torch.as_tensor(lookfrom, dtype=f32)
    lookat = torch.as_tensor(lookat, dtype=f32)
    vup = torch.as_tensor(vup, dtype=f32)

    def norm(a):
        return torch.sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2])

    w = lookfrom - lookat
    w = w / norm(w)
    u = torch.linalg.cross(vup, w)
    u = u / norm(u)
    v = torch.linalg.cross(w, u)

    theta = torch.tensor(vfov_deg, dtype=f32) * (np.pi / 180.0)
    half_h = torch.tan(theta / 2.0)
    half_w = aspect * half_h

    lower_left = (lookfrom - half_w * focus_dist * u
                  - half_h * focus_dist * v - focus_dist * w)
    horizontal = 2.0 * half_w * focus_dist * u
    vertical = 2.0 * half_h * focus_dist * v

    return Camera(
        origin=lookfrom,
        lower_left=lower_left,
        horizontal=horizontal,
        vertical=vertical,
        u=u, v=v, w=w,
        lens_radius=torch.tensor(aperture, dtype=f32) / 2.0,
        time0=torch.tensor(t0, dtype=f32),
        time1=torch.tensor(t1, dtype=f32),
    )


@dataclasses.dataclass
class Scene:
    """Everything the integrator needs.  Tensor fields live on one device;
    the rest is static (see the reference's Scene for each field)."""

    prims: Primitives
    materials: Materials
    textures: Textures
    lights: Lights
    camera: Camera
    sky_light: Any      # float32 scalar (0.0 or 1.0)
    block_aabbs: Any    # float32 [n_blocks, 8]
    n_vol: int
    # (start, count, padded_size, prim_type, rect_axis, has_transform, block)
    chunk_plan: tuple = ()
    num_lights: int = 0
    light_tex: tuple = ()
    mat_present: tuple = (True,) * 6
    tex_present: tuple = (True,) * 5
    vol_slots_static: tuple = ()
    emissives_unregistered: bool = False

    @property
    def device(self) -> torch.device:
        return self.block_aabbs.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self, prims=self.prims.to(device),
            materials=self.materials.to(device),
            textures=self.textures.to(device),
            lights=self.lights.to(device), camera=self.camera.to(device),
            sky_light=self.sky_light.to(device),
            block_aabbs=self.block_aabbs.to(device))


_GROUPS = {"prims": Primitives, "materials": Materials,
           "textures": Textures, "lights": Lights, "camera": Camera}
STATIC_FIELDS = ("n_vol", "chunk_plan", "num_lights", "light_tex",
                 "mat_present", "tex_present", "vol_slots_static",
                 "emissives_unregistered")


def scene_device(device, who: str) -> torch.device:
    """`device` as a torch.device, refused when it is CUDA and there is no
    card: an entry point that builds a scene never builds it on the CPU in
    the card's place."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to "
                           "build the scene on the CPU")
    return device


def scene_from_numpy(arrays: dict, static: dict, device="cuda") -> Scene:
    """A port Scene from a reference scene's state, its tensors on `device`:
    the card unless the caller asks for the CPU (without a card the default
    raises).

    `arrays`: every tensor leaf as a numpy array keyed by field path
    ("prims.params", "camera.origin", "sky_light", "block_aabbs", ...);
    `static`: the static fields named in STATIC_FIELDS.  Raises KeyError on
    a missing entry, so a partial state cannot build a partial scene."""
    device = scene_device(device, "scene_from_numpy")

    def t(key):
        return torch.tensor(np.asarray(arrays[key]), device=device)

    groups = {
        name: cls(**{f.name: t(f"{name}.{f.name}")
                     for f in dataclasses.fields(cls)})
        for name, cls in _GROUPS.items()}
    return Scene(**groups, sky_light=t("sky_light"),
                 block_aabbs=t("block_aabbs"),
                 **{k: static[k] for k in STATIC_FIELDS})
