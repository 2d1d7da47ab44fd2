"""Tracing, phase timers and device memory (port of
rtw_tpu/utils/profiling.py on torch.profiler).

- `trace(dir)`: context manager around `torch.profiler.profile` (CPU
  activity, and CUDA where the card is present): writes a Chrome/Perfetto
  trace of everything inside into `dir` (view it in ui.perfetto.dev or
  chrome://tracing).
- `annotate(name)`: `torch.profiler.record_function`, a named range for a
  host-side phase (scene build, checkpoint IO) inside a capture.
- `Phases`: wall-clock phase timers for the metrics sidecar, each phase
  ended by `torch.cuda.synchronize()` when CUDA is in use, so a phase's
  time includes the card work it queued.
- `device_memory()`: live and peak bytes the caching allocator holds on
  each local card, and its capacity; `{}` on the CPU.
- `card_line()`: the first card's name and power limit, as `nvidia-smi`
  gives them, the line every measurement is printed beside.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into `log_dir`
    as `trace_<pid>.json` (Chrome trace format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """Named host-side range, visible in captured traces."""
    return torch.profiler.record_function(name)


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class Phases:
    """Device-synced wall-clock phase timers.

    >>> ph = Phases()
    >>> with ph("scene_build"): scene = build_scene(...)
    >>> with ph("render"): img = render(scene, cfg)
    >>> ph.as_dict()   # {'scene_build_s': ..., 'render_s': ...}
    """

    def __init__(self):
        self._times: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if _cuda_in_use():
                torch.cuda.synchronize()
            self._times[name] = (self._times.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def as_dict(self) -> dict:
        return {f"{k}_s": round(v, 4) for k, v in self._times.items()}


def device_memory() -> dict:
    """{card index: bytes_in_use, peak_bytes_in_use, bytes_limit} for each
    local CUDA card (the caching allocator's allocated bytes, current and
    peak, and the card's total memory); {} without CUDA."""
    out = {}
    if not _cuda_in_use():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[str(i)] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def write_metrics(path: str, metrics: dict, phases: "Phases | None" = None):
    """JSON metrics sidecar (render stats + phase timers + card memory),
    the reference's layout."""
    doc = dict(metrics)
    if phases is not None:
        doc.update(phases.as_dict())
    mem = device_memory()
    if mem:
        doc["device_memory"] = mem
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, default=float)
