"""Scale probe of the port: Mrays/s against primitive count on one CUDA card.

The counterpart of tools/stress_scale.py for rtw_tpu_torch: the same
N-sphere fields (`rtw_tpu_torch.models.registry.build_stress_scene`: seed
5, centres uniform in the 400-unit cube, radii 1-5, camera at (0, 0, -500),
vfov 40), rendered through `render` with `scheduler="auto"` (the work queue
with the CUDA trace kernel), with the per-ray block hierarchy (the default)
or with the flat per-block scan.

Usage:
  python tools/stress_scale_torch.py                 # sweep, hierarchy
  python tools/stress_scale_torch.py --flat          # the flat block scan
  python tools/stress_scale_torch.py --counts 16384 262144
Writes one JSON line per count to stdout (the best of three renders after a
warm-up with the identical config), then the card's name and power limit as
nvidia-smi gives them.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--flat", action="store_true",
                    help="disable the block hierarchy (flat per-block scan)")
    ap.add_argument("--counts", type=int, nargs="*",
                    default=[4096, 16384, 65536])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("stress_scale_torch: no CUDA device", file=sys.stderr)
        return 1

    from rtw_tpu_torch import RenderConfig, render
    from rtw_tpu_torch.models.registry import build_stress_scene
    from rtw_tpu_torch.ops import trace_kernel as TK
    from rtw_tpu_torch.utils.profiling import card_line

    if args.flat:
        TK.TWO_LEVEL_MIN = 10 ** 9     # read when a render builds its tables

    for n in args.counts:
        t0 = time.time()
        scene = build_stress_scene(n)
        build_s = time.time() - t0
        walked = any(TK._walked(e) for e in scene.chunk_plan)
        cfg = RenderConfig(nx=args.size, ny=args.size, spp=args.spp,
                           max_depth=8, scene_id=0)
        render(scene, cfg)               # warm-up: builds the kernels
        best = None
        for _ in range(3):
            m = {}
            render(scene, cfg, metrics=m)
            best = m if best is None or m["mrays_per_sec"] > best[
                "mrays_per_sec"] else best
        print(json.dumps({
            "n_prims": n,
            "mode": "hierarchy" if walked else "flat",
            "mrays_per_sec": round(best["mrays_per_sec"], 3),
            "wall_seconds": round(best["wall_seconds"], 3),
            "build_seconds": round(build_s, 1),
        }), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
