"""Tracing, program spans, phase timers and device memory (port of
rtw_tpu/utils/profiling.py on torch.profiler).

- `span(name)`: a context manager that records one program span (name,
  start, end, the enclosing span, the `render` call it belongs to).
  `spans()` returns the recorded spans, `calls(n)` those of the last n
  `render` calls, `clear()` empties the buffer.
- `trace(dir)`: context manager around `torch.profiler.profile` (CPU
  activity, and CUDA where the card is present): writes a Chrome/Perfetto
  trace of everything inside into `dir` (view it in ui.perfetto.dev or
  chrome://tracing), with the spans recorded inside it as one more track.
- `Phases`: wall-clock phase timers for the metrics sidecar, each phase
  ended by `torch.cuda.synchronize()` when CUDA is in use, so a phase's
  time includes the card work it queued.
- `device_memory()`: live and peak bytes the caching allocator holds on
  each local card, and its capacity; `{}` on the CPU.
- `card_line()`: the first card's name and power limit, as `nvidia-smi`
  gives them, the line every measurement is printed beside.

The spans:

- Switch: a span records only while a torch.profiler capture is active
  (`trace`, the benchmark's traced slice, any `torch.profiler.profile`).
  Otherwise `span` returns one shared no-op context, and a span site costs
  the check and an empty `with`.
- Clock: `time.time_ns()`, on which the profiler stamps its host events
  and onto which it converts its device events, so a span can be laid
  over a capture's kernels and idle gaps directly.  On the H100 the two
  agreed within microseconds in a process's first capture; a process's
  later captures were seen with the device events 1-28 ms off (PERF.md
  §7).
- Not profiler ranges: a `record_function` range that encloses kernels is
  mirrored on the card's timeline as a device event, and would count as
  device work in a capture; spans stay out of the profiler.
- Bounded: the last `SPAN_CAP` spans are kept in memory.
- Device values: `defer(key, fn)` on a span stores `fn`, which `spans()`
  calls, after the capture, never inside the traced work (the megakernel's
  clock stamps stay on the card until then).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import re
import shutil
import subprocess
import threading
import time

import torch

SPAN_CAP = 1 << 20
# the chrome trace's track of the program spans
TRACK = "rtw_tpu_torch spans"

_capturing = torch._C._autograd._profiler_enabled
_ring: collections.deque = collections.deque(maxlen=SPAN_CAP)
_ids = itertools.count(1)


class _Open(threading.local):
    """The spans open on this thread, innermost last."""

    def __init__(self):
        self.stack = []


_open = _Open()


class Span:
    """One recorded span: `name`; `start_ns` and `end_ns` on
    `time.time_ns()`'s clock; `id`; `parent`, the id of the span it opened
    inside (None at the top); `call`, the id of the `render` span it
    belongs to (its own for a `render` span; None outside a render);
    `values`, what its deferred reads gave (`spans()`)."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "call",
                 "values", "_deferred")

    def __init__(self, name: str):
        self.name = name
        self.id = next(_ids)
        self.values = {}
        self._deferred = None

    def __enter__(self):
        stack = _open.stack
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        self.call = (self.id if self.name == "render"
                     else up.call if up is not None else None)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _open.stack.pop()
        _ring.append(self)

    def defer(self, key: str, fn) -> None:
        """Store `fn()` under `values[key]` when `spans()` is called."""
        self._deferred = (self._deferred or []) + [(key, fn)]


class _Off:
    """The span of a site while no capture is active: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def defer(self, key: str, fn) -> None:
        pass


_OFF = _Off()


def span(name: str):
    """A context manager recording the span `name` while a torch.profiler
    capture is active, and the shared no-op otherwise."""
    if not _capturing():
        return _OFF
    return Span(name)


def spans() -> list[Span]:
    """The recorded spans, by start time, their deferred reads made (call
    it after the capture: a read may copy from the card)."""
    out = sorted(_ring, key=lambda s: (s.start_ns, s.id))
    for s in out:
        if s._deferred:
            for key, fn in s._deferred:
                s.values[key] = fn()
            s._deferred = None
    return out


def calls(n: int) -> list[list[Span]]:
    """The spans of the last `n` recorded `render` calls, oldest first:
    one list per call, its `render` span first."""
    if n <= 0:
        return []
    every = spans()
    roots = [s for s in every if s.name == "render"][-n:]
    by_call = {r.id: [r] for r in roots}
    for s in every:
        if s.call in by_call and s.id != s.call:
            by_call[s.call].append(s)
    return [by_call[r.id] for r in roots]


def clear() -> None:
    """Forget every recorded span."""
    _ring.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into `log_dir`
    as `trace_<pid>.json` (Chrome trace format), the spans recorded inside
    it on a track of their own."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    _add_track(path, spans())


_EVENTS = re.compile(rb'"traceEvents"\s*:\s*\[')
_BASE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


def _add_track(path: str, recorded: list[Span]) -> None:
    """Insert `recorded` at the head of the Chrome trace's event array as
    complete events of the track `TRACK`, on the trace's time base (its
    `baseTimeNanoseconds`, written before the array); the rest of the file
    is copied as it is."""
    if not recorded:
        return
    tmp = path + ".tmp"
    with open(path, "rb") as src:
        head = b""
        while not (m := _EVENTS.search(head)):
            chunk = src.read(1 << 16)
            if not chunk:
                raise ValueError(f"{path} holds no traceEvents array")
            head += chunk
        base = _BASE.search(head, 0, m.start())
        base_ns = int(base.group(1)) if base else 0
        events = [{"ph": "M", "name": "process_name", "pid": TRACK,
                   "tid": 0, "args": {"name": TRACK}}]
        events += [{"ph": "X", "cat": "program_span", "name": s.name,
                    "pid": TRACK, "tid": 0,
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"id": s.id, "parent": s.parent,
                             "call": s.call, **s.values}}
                   for s in recorded]
        with open(tmp, "wb") as dst:
            dst.write(head[:m.end()])
            for e in events:
                dst.write(json.dumps(e, default=float).encode() + b",\n")
            dst.write(head[m.end():])
            shutil.copyfileobj(src, dst)
    os.replace(tmp, path)


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
