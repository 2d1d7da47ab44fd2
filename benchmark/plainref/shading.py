"""Shading-record resolution (port of rtw_tpu/ops/shading.py).

`gather_shade` builds the winner's flattened material/texture record with
per-prim gathers (the split tier's trace kernel writes the same record);
`resolve_albedo` applies the procedural texture kinds: checker, Perlin
marble and the image atlas under `tex_filter`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from . import scene as S
from . import vec as V
from .textures import (_image_bilinear, _image_bilinear_565,
                                        _image_nearest_565, _image_stoch_565,
                                        turbulence)
from .vec import Vec3
from . import rng as R


class ShadeRec(NamedTuple):
    """Per-ray shading record of the winning primitive."""

    mat_type: Any    # [N] int32
    fuzz: Any        # [N] f32
    eta: Any         # [N] f32
    tex_type: Any    # [N] int32
    scale: Any       # [N] f32 noise scale
    image_id: Any    # [N] int32
    rgb: Vec3        # constant/albedo texture color
    odd: Vec3        # checker odd color
    even: Vec3       # checker even color


def gather_shade(scene: S.Scene, prim_idx, hit_mask) -> ShadeRec:
    """ShadeRec via per-prim column gathers through Textures.color."""
    pr = scene.prims
    sp = torch.clamp_min(prim_idx, 0)
    col = scene.textures.color

    def color_via(idx_col):
        rows = idx_col[sp]
        return Vec3(col[:, 0][rows], col[:, 1][rows], col[:, 2][rows])

    return ShadeRec(
        mat_type=torch.where(hit_mask, pr.mat_type_p[sp], 0),
        fuzz=pr.fuzz_p[sp],
        eta=pr.eta_p[sp],
        tex_type=pr.tex_type_p[sp],
        scale=pr.scale_p[sp],
        image_id=pr.image_id_p[sp],
        rgb=color_via(pr.tex_idx),
        odd=color_via(pr.odd_idx),
        even=color_via(pr.even_idx),
    )


def _noise_eval(scene: S.Scene, scale, p: Vec3) -> Vec3:
    """Marble: 0.5 * (1 + sin(scale * z + 5 * turbulence(scale * p)))."""
    m = 0.5 * (1.0 + torch.sin(scale * p.z
                               + 5.0 * turbulence(scene.textures, p * scale)))
    return Vec3(m, m, m)


def _image_eval(scene: S.Scene, image_id, u, v, tex_filter, tex_u=None):
    """Atlas fetch for every lane under `tex_filter` ("stoch565" draws its
    row from the lane's dedicated uniform `tex_u`)."""
    if tex_filter == "stoch565":
        return _image_stoch_565(scene.textures, image_id, u, v, tex_u)
    fetch = {"rgb565": _image_bilinear_565,
             "nearest565": _image_nearest_565}.get(tex_filter,
                                                   _image_bilinear)
    return fetch(scene.textures, image_id, u, v)


def tex_row(scene: S.Scene, cfg) -> int:
    """The row of a bounce's uniforms that "stoch565" draws its texel row
    from, or -1.  Stochastic texture filtering draws from a dedicated
    trailing slot: slot streams are independent by index, so appending it
    leaves every estimator draw as it was."""
    if cfg.tex_filter == "stoch565" and scene.tex_present[S.TEX_IMAGE]:
        return R.NUM_FIXED_SLOTS + 2 * max(scene.n_vol, 1)
    return -1


def resolve_albedo(scene: S.Scene, shade: ShadeRec, p: Vec3, u, v,
                   tex_filter: str = "rgb565", tex_tile_gate: bool = True,
                   tex_u=None) -> Vec3:
    """Final albedo: the constant color, the checker's child color
    (book-correct sines product), the marble value or the atlas texel.

    Each texture kind present in the scene is evaluated for every lane and
    selected per lane.  The reference skips a kind under `lax.cond` when no
    lane needs it, and gates the atlas fetch per 1024-lane tile
    (`tex_tile_gate`); both only skip work whose result the select
    discards, so the port, which would pay a host sync per test, evaluates
    every lane and accepts `tex_tile_gate` as a no-op."""
    del tex_tile_gate
    present = scene.tex_present
    albedo = shade.rgb
    if present[S.TEX_CHECKER]:
        sines = (torch.sin(10.0 * p.x) * torch.sin(10.0 * p.y)
                 * torch.sin(10.0 * p.z))
        checker = V.where(sines < 0.0, shade.odd, shade.even)
        albedo = V.where(shade.tex_type == S.TEX_CHECKER, checker, albedo)
    if present[S.TEX_NOISE]:
        albedo = V.where(shade.tex_type == S.TEX_NOISE,
                         _noise_eval(scene, shade.scale, p), albedo)
    if present[S.TEX_IMAGE]:
        albedo = V.where(shade.tex_type == S.TEX_IMAGE,
                         _image_eval(scene, shade.image_id, u, v, tex_filter,
                                     tex_u), albedo)
    return albedo
