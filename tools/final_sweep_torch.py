"""End-of-round measurement sweep of the port on one CUDA card (the
counterpart of tools/final_sweep.py): every scene of
tools/bench_scenes_torch.py (best of 3), then the stated Cornell 800x800
1000-spp headline (bench.py's workload, depth 20).

Usage: python tools/final_sweep_torch.py [scene_id ...]
Prints one JSON line per measurement, then the card's name and power
limit as nvidia-smi gives them.  Needs a CUDA device.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools.bench_scenes_torch import WORKLOADS, bench_scene  # noqa: E402


def headline(device="cuda"):
    """Metrics of Cornell 800x800, 1000 spp, depth 20 on `device` (the
    card unless the caller asks for the CPU; without CUDA the default
    raises), after a warm-up render with the identical config."""
    import torch

    from rtw_tpu_torch import RenderConfig, build_scene, render

    cfg = RenderConfig(nx=800, ny=800, spp=1000, max_depth=20, scene_id=0)
    scene = build_scene(0, 800, 800, device=device)
    render(scene, cfg)
    m = {}
    img = render(scene, cfg, metrics=m)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("the headline render is not finite")
    return m


def main(argv=None) -> int:
    from rtw_tpu_torch.utils.profiling import card_line

    argv = sys.argv[1:] if argv is None else argv
    only = [int(a) for a in argv] or None
    for sid in sorted(WORKLOADS):
        if only and sid not in only:
            continue
        m = bench_scene(sid)
        print(json.dumps({"scene": sid, "mrays": m["mrays_per_sec"],
                          "msamples": m["samples_per_sec"] / 1e6}),
              flush=True)

    if not only or 0 in only:
        m = headline()
        print(json.dumps({"headline": "cornell_800x800_1000spp",
                          "mrays": m["mrays_per_sec"],
                          "msamples": m["samples_per_sec"] / 1e6,
                          "wall_s": m["wall_seconds"]}), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
