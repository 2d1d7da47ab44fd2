"""Record the port's wavefront occupancy on the card (the counterpart of
tools/occupancy_report.py).

Renders the big scenes with cfg.bounce_stats and cfg.occupancy_trace
under both schedulers ("queue": the work queue with the trace and
occlusion kernels; "regen": the regenerating sweep, which with the
counters on runs the plain torch sweep) and writes per-scene wavefront
iterations, mean occupancy, the rays-by-depth histogram and the
occupancy-by-iteration curve, with the card's name and power limit.

Usage: python tools/occupancy_report_torch.py [scene_id ...] [--out PATH]
  (default: scenes 1 2 4, docs/torch/occupancy.json).  One JSON line per
  scene and scheduler, then the card's line.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

WORKLOADS = {1: (800, 400, 16), 2: (800, 400, 16), 4: (800, 400, 8)}
OUT = os.path.join(os.path.dirname(__file__), "..", "docs", "torch",
                   "occupancy.json")
SCHEDULERS = ("queue", "regen")


def scene_entry(sid, nx, ny, spp, max_depth=20, device="cuda"):
    """{scheduler: the counters' metrics} of scene `sid` at nx x ny, `spp`
    samples, on `device` (the card unless the caller asks for the CPU;
    without CUDA the default raises), each after a warm-up render with
    the identical config."""
    import torch

    from rtw_tpu_torch import RenderConfig, build_scene, render

    scene = build_scene(sid, nx, ny, device=device)
    entry = {}
    for sched in SCHEDULERS:
        cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=max_depth,
                           scene_id=sid, scheduler=sched, bounce_stats=True,
                           occupancy_trace=True)
        render(scene, cfg)                   # warm-up, identical config
        m = {}
        img = render(scene, cfg, metrics=m)
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"scene {sid} {sched}: non-finite image")
        entry[sched] = {
            "mrays_per_sec": m["mrays_per_sec"],
            "wavefront_iterations": m["wavefront_iterations"],
            "mean_occupancy": round(m["mean_occupancy"], 3),
            "rays_by_depth": [round(x) for x in m["rays_by_depth"]],
            "occupancy_by_iter": [round(x, 3)
                                  for x in m["occupancy_by_iter"]],
        }
    return entry


def main(argv=None) -> int:
    from rtw_tpu_torch.utils.profiling import card_line

    ap = argparse.ArgumentParser()
    ap.add_argument("scenes", type=int, nargs="*",
                    default=sorted(WORKLOADS))
    ap.add_argument("--out", default=os.path.normpath(OUT))
    args = ap.parse_args(argv)
    card = card_line()
    report = {"card": card}
    for sid in args.scenes:
        nx, ny, spp = WORKLOADS[sid]
        entry = scene_entry(sid, nx, ny, spp)
        for sched, e in entry.items():
            print(json.dumps({"scene": sid, "scheduler": sched,
                              "iters": e["wavefront_iterations"],
                              "mean_occ": e["mean_occupancy"],
                              "mrays": e["mrays_per_sec"]}), flush=True)
        report[str(sid)] = {"workload": [nx, ny, spp], **entry}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
