"""Reference-image comparison of the port's renders (the counterpart of
tools/compare_reference.py).

Renders each scene at the aspect of the reference's committed render and
reports SSIM and mean absolute error against that render at the same size:
structural goldens, not per-pixel ones (docs/PARITY.md says why).

The reference's full-size renders are not in this repository.  By default
the reference image is the right half of the committed
docs/parity/scene{N}_vs_ref.png: the reference's render, LANCZOS-downscaled
by tools/compare_reference.py to its default 400 px width.  So the port
renders at 400 px and that half's height, and any other --width is
refused; --ref-dir reads the original renders instead and resizes them as
the reference tool does.  The left half of the same committed file is the
JAX package's own render on a TPU (200 spp; with --denoise, the left half
of scene{N}_vs_ref_denoised.png, 1000 spp denoised): each line also scores
the port's render against it (`ssim_vs_tpu`, `mae_vs_tpu`).

Run:  python tools/compare_reference_torch.py [-s SID ...] [--spp 200]
          [--max-depth 20] [--denoise] [--out-dir docs/torch/parity]
Writes side-by-side PNGs (left: the port's render, right: the reference's)
to --out-dir, prints one JSON line per scene, then the card's name and
power limit as nvidia-smi gives them.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PARITY_DIR = os.path.normpath(os.path.join(ROOT, "docs", "parity"))
OUT_DIR = os.path.normpath(os.path.join(ROOT, "docs", "torch", "parity"))
COMMITTED_WIDTH = 400

# scene id -> (reference render, note)
REFERENCE_IMAGES = {
    0: ("rol-optix-final-alum_10k.png",
        "Rest-of-Life final (Cornell + aluminum box + glass sphere), 10k spp"),
    1: ("IOW-OptiX-final.png", "IOW final with moving spheres"),
    2: ("TNW-Optix-lighting-IOW-final.png", "IOW + rect light scene"),
    4: ("TNW-Optix-final.png", "The Next Week final"),
}


def committed_halves(sid: int, denoised: bool = False):
    """(left, right) halves of docs/parity/scene{sid}_vs_ref[_denoised].png
    as float [h, 400, 3] in [0, 1]: the JAX package's render and the
    reference's."""
    from PIL import Image

    tag = "_denoised" if denoised else ""
    img = np.asarray(Image.open(os.path.join(
        PARITY_DIR, f"scene{sid}_vs_ref{tag}.png")).convert("RGB"),
        np.float32) / 255.0
    w = img.shape[1] // 2
    return img[:, :w], img[:, w:]


def reference_image(sid: int, width: int = COMMITTED_WIDTH,
                    ref_dir: str | None = None):
    """The reference's render of scene `sid`, float [h, width, 3] in
    [0, 1]: from `ref_dir` resized as tools/compare_reference.py resizes
    it, else the committed right half (only at its 400 px)."""
    if ref_dir is None:
        if width != COMMITTED_WIDTH:
            raise ValueError(f"the committed reference halves are "
                             f"{COMMITTED_WIDTH} px wide; --width {width} "
                             "needs --ref-dir")
        return committed_halves(sid)[1]
    from PIL import Image

    ref = Image.open(os.path.join(ref_dir, REFERENCE_IMAGES[sid][0])
                     ).convert("RGB")
    rw, rh = ref.size
    ny = max(8, round(width * rh / rw))
    return np.asarray(ref.resize((width, ny), Image.LANCZOS),
                      np.float32) / 255.0


def display_render(scene, cfg, denoise: bool = False):
    """A render as a display-space float [ny, nx, 3] image in [0, 1], top
    row first: the gamma-encoded uint8 image, or with `denoise` the
    à-trous denoiser's LDR output of the linear render."""
    from rtw_tpu_torch import render, render_image

    if denoise:
        from rtw_tpu_torch.denoise import denoise as atrous_denoise

        disp = atrous_denoise(render(scene, cfg), scene, cfg, mode="ldr",
                              gamma=cfg.gamma)
        return np.clip(disp.cpu().numpy(), 0.0, 1.0)[::-1]
    return np.asarray(render_image(scene, cfg), np.float32) / 255.0


def compare_scene(sid: int, spp: int = 200, max_depth: int = 20,
                  denoise: bool = False, device="cuda",
                  width: int = COMMITTED_WIDTH, ref_dir: str | None = None):
    """Scene `sid` rendered on `device` (the card unless the caller asks
    for the CPU; without CUDA the default raises) at the reference image's
    size, scored against it.  Returns (the JSON line's dict, the
    side-by-side float image)."""
    from rtw_tpu_torch import RenderConfig, build_scene
    from rtw_tpu_torch.models.scene import scene_device
    from rtw_tpu_torch.utils.image import ssim

    device = scene_device(device, "compare_reference")
    ref = reference_image(sid, width, ref_dir)
    ny, nx = ref.shape[:2]
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=max_depth,
                       scene_id=sid)
    ours = display_render(build_scene(sid, nx, ny, device=device), cfg,
                          denoise)
    if not np.isfinite(ours).all():
        raise RuntimeError(f"scene {sid}: non-finite render")
    fname, note = REFERENCE_IMAGES[sid]
    out = {"scene": sid, "reference": fname, "denoised": bool(denoise),
           "ssim": ssim(ours, ref),
           "mae": float(np.abs(ours - ref).mean()), "note": note}
    if ref_dir is None:
        tpu = committed_halves(sid, denoise)[0]
        out["ssim_vs_tpu"] = ssim(ours, tpu)
        out["mae_vs_tpu"] = float(np.abs(ours - tpu).mean())
    return out, np.concatenate([ours, ref], axis=1)


def main(argv=None) -> int:
    from PIL import Image

    from rtw_tpu_torch.utils.profiling import card_line

    ap = argparse.ArgumentParser()
    ap.add_argument("-s", "--scenes", type=int, nargs="*",
                    default=sorted(REFERENCE_IMAGES))
    ap.add_argument("--width", type=int, default=COMMITTED_WIDTH)
    ap.add_argument("--spp", type=int, default=200)
    ap.add_argument("--max-depth", type=int, default=20)
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--ref-dir", default=None,
                    help="the reference's full-size renders (the reference "
                         "tool's REF_DIR); default: the committed halves")
    ap.add_argument("--denoise", action="store_true",
                    help="score denoise(ours) against the reference — the "
                         "like-for-like comparison (the reference PNGs ARE "
                         "denoiser output)")
    args = ap.parse_args(argv)
    if args.ref_dir is None and args.width != COMMITTED_WIDTH:
        ap.error(f"--width must be {COMMITTED_WIDTH} without --ref-dir")

    os.makedirs(args.out_dir, exist_ok=True)
    tag = "_denoised" if args.denoise else ""
    for sid in args.scenes:
        out, side = compare_scene(sid, args.spp, args.max_depth,
                                  args.denoise, width=args.width,
                                  ref_dir=args.ref_dir)
        Image.fromarray(np.rint(side * 255).astype(np.uint8)).save(
            os.path.join(args.out_dir, f"scene{sid}_vs_ref{tag}.png"))
        print(json.dumps({**out, "spp": args.spp}), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
