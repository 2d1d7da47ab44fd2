"""Per-scene throughput of the port on one CUDA card (the counterpart of
tools/bench_scenes.py).

The same workloads (the BASELINE.md all-scenes table), depth 20, through
`render` with `scheduler="auto"`: scenes 0, 3 and 5 run the persistent
megakernel (A), scenes 1, 2 and 4 the work queue with the trace and
occlusion kernels (B, C).  Each config renders once for warm-up (it builds
the kernels), then REPS times; the best is reported.

Usage: python tools/bench_scenes_torch.py [scene_id ...] [key=value ...]
  (default: all scenes; key=value overrides a RenderConfig field, e.g.
  scheduler=qmega).  One JSON line per scene, then the card's name and
  power limit as nvidia-smi gives them.  Needs a CUDA device.
"""

import ast
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# scene_id -> (nx, ny, spp)
WORKLOADS = {
    0: (800, 800, 64),
    1: (800, 400, 16),
    2: (800, 400, 16),
    3: (400, 400, 32),
    4: (800, 400, 8),
    5: (400, 224, 64),
}


REPS = 3   # timed repeats; report the best (the host's launch rate varies)


def bench_scene(sid: int, overrides: dict | None = None, device="cuda",
                reps: int = REPS):
    """The best-of-`reps` metrics of scene `sid`'s workload on `device`
    (the card unless the caller asks for the CPU; without CUDA the default
    raises), after a warm-up render with the identical config."""
    import torch

    from rtw_tpu_torch import RenderConfig, build_scene, render

    nx, ny, spp = WORKLOADS[sid]
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=20, scene_id=sid,
                       **(overrides or {}))
    scene = build_scene(sid, nx, ny, device=device)
    render(scene, cfg)                       # warm-up (identical config)
    best = None
    for _ in range(reps):
        metrics = {}
        img = render(scene, cfg, metrics=metrics)
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"scene {sid}: non-finite image")
        if best is None or metrics["mrays_per_sec"] > best["mrays_per_sec"]:
            best = metrics
    return best


def _coerce(v: str):
    """k=v override values arrive as strings; RenderConfig fields are typed
    (int/float/bool/str), so parse literals where possible."""
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def main(argv=None) -> int:
    from rtw_tpu_torch.utils.profiling import card_line

    argv = sys.argv[1:] if argv is None else argv
    overrides = {}
    ids = []
    for a in argv:
        if "=" in a:
            k, v = a.split("=", 1)
            overrides[k] = _coerce(v)
        else:
            ids.append(int(a))
    ids = ids or sorted(WORKLOADS)
    for sid in ids:
        m = bench_scene(sid, overrides or None)
        print(json.dumps({
            "scene": sid, **overrides,
            "mrays_per_sec": m["mrays_per_sec"],
            "msamples_per_sec": m["samples_per_sec"] / 1e6,
            "wall_seconds": m["wall_seconds"],
        }), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
