"""Scene-2 parity archaeology on the port (the counterpart of
tools/scene2_archaeology.py).

docs/PARITY.md explains scene 2's low SSIM against the reference's render
by the reference's own NEE divergence (QUIRKS #16): its PDF tree samples
the phantom rect {3,5, 2.3,6, z=-2} (ioScene.h:125) instead of the actual
light rect {3,5, 1,3}.  This tool renders the three hypotheses at the
parity workload and writes a 4-panel strip (live-code render | reference
render | y=10 sky-light variant | phantom-NEE light row) with each one's
SSIM against the reference.  The reference panel is the right half of the
committed docs/parity/scene2_vs_ref.png (tools/compare_reference_torch.py),
so the renders are 400 px wide.

Run:  python tools/scene2_archaeology_torch.py [--spp 200] [--denoise]
          [--out PATH]
Writes docs/torch/parity/scene2_archaeology[_denoised].png, prints one JSON
line, then the card's name and power limit as nvidia-smi gives them.
Needs a CUDA device.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools.compare_reference_torch import (  # noqa: E402
    COMMITTED_WIDTH, OUT_DIR, display_render, reference_image)

VARIANTS = ("live", "sky_y10", "phantom_nee")


def phantom_lights(device):
    """The NEE light row on the reference's phantom rect, emitting the
    live light's 16 (tools/scene2_archaeology.py:86-92): the builder would
    rightly refuse it as a light that only partly overlaps its rect."""
    import torch

    from rtw_tpu_torch.models.scene import Lights

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return Lights(position=t([[3.0, 2.3, -2.0]]),
                  vec_u=t([[2.0, 0.0, 0.0]]), vec_v=t([[0.0, 3.7, 0.0]]),
                  emission=t([[16.0, 16.0, 16.0]]), area=t([2.0 * 3.7]),
                  normal=t([[0.0, 0.0, 1.0]]))


def variant_scene(variant: str, aspect: float, device):
    """Scene 2 under one hypothesis, on `device`."""
    from rtw_tpu_torch.models import registry
    from rtw_tpu_torch.models.scene import scene_device

    device = scene_device(device, "scene2_archaeology")
    if variant == "phantom_nee":
        scene = registry.in_one_weekend_light(aspect).to(device)
        return dataclasses.replace(scene, lights=phantom_lights(device))
    return registry.in_one_weekend_light(aspect,
                                         light_variant=variant).to(device)


def archaeology(spp: int = 200, denoise: bool = False, device="cuda"):
    """The three variants rendered on `device` (the card unless the
    caller asks for the CPU; without CUDA the default raises) at the
    reference panel's size, depth 20.  Returns ({variant: SSIM against the
    reference}, the strip live | reference | sky_y10 | phantom_nee)."""
    from rtw_tpu_torch import RenderConfig
    from rtw_tpu_torch.models.scene import scene_device
    from rtw_tpu_torch.utils.image import ssim

    device = scene_device(device, "scene2_archaeology")
    ref = reference_image(2, COMMITTED_WIDTH)
    ny, nx = ref.shape[:2]
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=20, scene_id=2)
    renders = {}
    for v in VARIANTS:
        img = display_render(variant_scene(v, nx / ny, device), cfg,
                             denoise)
        if not np.isfinite(img).all():
            raise RuntimeError(f"scene 2 {v}: non-finite render")
        renders[v] = img
    scores = {v: ssim(img, ref) for v, img in renders.items()}
    strip = np.concatenate([renders["live"], ref, renders["sky_y10"],
                            renders["phantom_nee"]], axis=1)
    return scores, strip


def main(argv=None) -> int:
    from PIL import Image

    from rtw_tpu_torch.utils.profiling import card_line

    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=200)
    ap.add_argument("--denoise", action="store_true",
                    help="score denoise(render) against the reference "
                         "render (which IS denoiser output)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = os.path.join(OUT_DIR, "scene2_archaeology%s.png" % (
            "_denoised" if args.denoise else ""))
    scores, strip = archaeology(args.spp, args.denoise)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    Image.fromarray(np.rint(strip * 255).astype(np.uint8)).save(args.out)
    print(json.dumps({
        "ssim_live_vs_ref": scores["live"],
        "ssim_y10_variant_vs_ref": scores["sky_y10"],
        "ssim_phantom_nee_vs_ref": scores["phantom_nee"],
        "strip": args.out, "denoised": bool(args.denoise), "spp": args.spp,
        "strip_order": "live | reference | y10-variant | phantom-NEE",
        "best_match": max(scores, key=scores.get),
    }), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
