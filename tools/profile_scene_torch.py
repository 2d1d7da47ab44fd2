"""Per-kernel time decomposition of one scene's render on the card (the
counterpart of tools/profile_scene.py).

Captures a torch.profiler trace of a warm render
(`rtw_tpu_torch.utils.profiling.trace`, a Chrome trace `trace_<pid>.json`),
reads its device events (complete events of category kernel, gpu_memcpy
or gpu_memset) and sums their durations by a coarse bucket map keyed on
the port's kernel names: the megakernel's persistent launch and its step,
the split tier's trace, occlusion, shading and finishing kernels (B, C, E,
F), and torch's own glue kernels.  Anything unmatched lands in `other`,
so the buckets sum to the device total.  The idle time is the render's
wall less the time the card was busy (the union of its events).

Run: python tools/profile_scene_torch.py 4 [--spp 8] [--width 800]
     [--overrides k=v ...]
Prints one JSON line (bucket -> device ms of the traced render), then the
card's name and power limit as nvidia-smi gives them.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

BUCKETS = (
    # (bucket, substrings matched against the lower-cased kernel name, the
    # first bucket that matches wins): mega_trace_kernel contains
    # trace_kernel, and index_put contains index, so their buckets come
    # first
    ("mega_trace", ("mega_trace_kernel",)),
    ("mega_step", ("mega_kernel",)),
    ("trace_kernel", ("trace_kernel",)),
    ("occl_kernel", ("occluded_kernel",)),
    ("shade_kernel", ("shade_kernel",)),
    ("shade_finish", ("shade_finish_kernel",)),
    ("scatter", ("scatter", "index_put")),
    ("gather", ("gather", "index")),
    ("scan", ("scan", "cumsum")),
    ("sort", ("sort", "radix")),
    ("reduce", ("reduce",)),
    ("copy", ("copy", "memcpy", "memset")),
    ("elementwise", ("elementwise",)),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def bucket_of(name: str) -> str:
    low = name.lower()
    for b, keys in BUCKETS:
        if any(k in low for k in keys):
            return b
    return "other"


def device_events(trace: dict) -> list[tuple[str, float, float]]:
    """(name, start us, duration us) of each device event of a Chrome
    trace."""
    return [(ev.get("name", ""), float(ev.get("ts", 0.0)),
             float(ev.get("dur", 0.0)))
            for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]


def busy_us(events) -> float:
    """The time covered by at least one event (their union)."""
    total, end = 0.0, float("-inf")
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


def breakdown(events, wall_ms: float, top: int = 12) -> dict:
    """device_ms by bucket, device_total_ms, top_ops_ms (the `top` kernel
    names by time), busy_ms and idle_ms (the wall less the busy time), all
    in ms."""
    agg: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for name, _, dur in events:
        b = bucket_of(name)
        agg[b] = agg.get(b, 0.0) + dur / 1e3
        by_name[name] = by_name.get(name, 0.0) + dur / 1e3
    busy = busy_us(events) / 1e3
    return {
        "device_ms": dict(sorted(agg.items(), key=lambda kv: -kv[1])),
        "device_total_ms": sum(dur for _, _, dur in events) / 1e3,
        "top_ops_ms": dict(sorted(by_name.items(),
                                  key=lambda kv: -kv[1])[:top]),
        "busy_ms": busy,
        "idle_ms": wall_ms - busy,
    }


def profile_scene(sid: int, spp: int = 0, width: int = 0,
                  overrides: dict | None = None, device="cuda") -> dict:
    """Scene `sid` at its tools/bench_scenes_torch.py workload (`spp` and
    `width` replace the workload's where non-zero; the height keeps its
    aspect), depth 20, on `device` (the card; without CUDA it raises):
    one warm-up render, then one render under the profiler.  Returns the
    reference tool's fields with `breakdown`'s."""
    from rtw_tpu_torch import RenderConfig, build_scene, render
    from rtw_tpu_torch.models.scene import scene_device
    from rtw_tpu_torch.utils.profiling import trace
    from tools.bench_scenes_torch import WORKLOADS

    device = scene_device(device, "profile_scene")
    if device.type != "cuda":
        raise RuntimeError("profile_scene reads the card's events: it needs "
                           "a CUDA device")
    nx, ny, wspp = WORKLOADS[sid]
    if width:
        nx, ny = width, max(8, round(width * ny / nx))
    spp = spp or wspp
    ov = dict(overrides or {})
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=20, scene_id=sid,
                       **ov)
    scene = build_scene(sid, nx, ny, device=device)
    render(scene, cfg)            # warm-up: builds the kernels
    log_dir = tempfile.mkdtemp(prefix="rtwprof_")
    try:
        with trace(log_dir):
            m = {}
            render(scene, cfg, metrics=m)
        with open(os.path.join(log_dir, f"trace_{os.getpid()}.json")) as f:
            tr = json.load(f)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    events = device_events(tr)
    if not events:
        raise RuntimeError("the trace holds no device event")
    return {"scene": sid, "nx": nx, "ny": ny, "spp": spp, **ov,
            "mrays_per_sec": m["mrays_per_sec"],
            "wall_ms": m["wall_seconds"] * 1e3,
            **breakdown(events, m["wall_seconds"] * 1e3)}


def main(argv=None) -> int:
    from rtw_tpu_torch.utils.profiling import card_line
    from tools.bench_scenes_torch import _coerce

    ap = argparse.ArgumentParser()
    ap.add_argument("scene", type=int)
    ap.add_argument("--spp", type=int, default=0, help="0 = workload table")
    ap.add_argument("--width", type=int, default=0,
                    help="0 = workload table")
    ap.add_argument("--overrides", nargs="*", default=[])
    args = ap.parse_args(argv)
    ov = {}
    for a in args.overrides:
        k, v = a.split("=", 1)
        ov[k] = _coerce(v)
    print(json.dumps(profile_scene(args.scene, args.spp, args.width, ov)),
          flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
