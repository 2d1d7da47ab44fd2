"""Per-prim property table read by the megakernel (port of the props layout
and `build_props` of rtw_tpu/ops/trace_kernel.py).

The reference's trace kernels (its queue 2 items B and C: `trace_pallas`,
`occluded_pallas`) are not ported yet (ROADMAP items 7 and 8).  Their
nearest-hit and any-hit sweeps, for the straight-line plans of the
megakernel's envelope, are device functions in csrc/mega_kernel.cu.
"""

from __future__ import annotations

import torch

from rtw_tpu_torch.models import scene as S

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
