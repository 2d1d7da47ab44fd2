"""Shading-record resolution (port of rtw_tpu/ops/shading.py).

`gather_shade` builds the winner's flattened material/texture record with
per-prim gathers; `resolve_albedo` applies the procedural texture kinds.
Constant and checker textures are ported; noise and image textures raise
(ROADMAP item 8).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from rtw_tpu_torch.models import scene as S
from rtw_tpu_torch.ops import vec as V
from rtw_tpu_torch.ops.vec import Vec3


class ShadeRec(NamedTuple):
    """Per-ray shading record of the winning primitive."""

    mat_type: Any    # [N] int32
    fuzz: Any        # [N] f32
    eta: Any         # [N] f32
    tex_type: Any    # [N] int32
    rgb: Vec3        # constant/albedo texture color
    odd: Vec3        # checker odd color
    even: Vec3       # checker even color


def check_textures(scene: S.Scene) -> None:
    if scene.tex_present[S.TEX_NOISE] or scene.tex_present[S.TEX_IMAGE]:
        raise NotImplementedError(
            "noise and image textures are not ported yet (ROADMAP item 8)")


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
        rgb=color_via(pr.tex_idx),
        odd=color_via(pr.odd_idx),
        even=color_via(pr.even_idx),
    )


def resolve_albedo(scene: S.Scene, shade: ShadeRec, p: Vec3) -> Vec3:
    """Final albedo: the constant color, or the checker's child color
    (book-correct sines product)."""
    check_textures(scene)
    albedo = shade.rgb
    if scene.tex_present[S.TEX_CHECKER]:
        sines = (torch.sin(10.0 * p.x) * torch.sin(10.0 * p.y)
                 * torch.sin(10.0 * p.z))
        checker = V.where(sines < 0.0, shade.odd, shade.even)
        albedo = V.where(shade.tex_type == S.TEX_CHECKER, checker, albedo)
    return albedo
