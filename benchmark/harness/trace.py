"""The traced slice of a `--trace 1` run: a few renders under
torch.profiler, reduced in memory to what the per-layer metrics read.

No trace file is written.  From the profiler's raw events the slice keeps:
each device operation (kernel, copy, set) with its name, start and end;
the host operations with theirs.  From them:

- `busy_s`: the union of the device operations' intervals;
- `window_s`: the host clock around the traced renders, each ended by a
  device sync;
- `device_s(pattern)`: the summed time of the device operations whose
  name matches a regular expression (a kernel's name, as the program
  gives it);
- `device_ops`: the summed time of each device operation's name;
- `idle_by_host`: each gap between device operations, named by the
  innermost host operation that covers its middle ("host python" where
  none does), summed by name;
- `backward_s`: the summed time of the device operations launched from
  inside torch autograd's backward: each device operation is matched to
  its launch through the profiler's correlation ids (the runtime call
  that launched it, or else the host operation it is linked to), and the
  launch lies inside an `autograd::engine::evaluate_function` host event;
  None where the slice holds no such event (no backward ran).
"""

from __future__ import annotations

import bisect
import re
import time

import torch

NAME_CHARS = 120
# prefixes that every kernel of a namespace shares, cut from the names
NAME_NOISE = ("void ", "at::native::", "(anonymous namespace)::", "std::")
# host events looked at back from a gap's middle for the innermost cover
SCAN_BACK = 64
# the host event of one node of autograd's backward
BACKWARD = "autograd::engine::evaluate_function"


def _events(prof):
    """From the profiler's raw events, in one pass: (device [(start_ns,
    end_ns, name)], host [(start_ns, end_ns, name)], the backward's
    arguments).  The backward's: (device [(correlation id, linked
    correlation id, seconds)], launches {correlation id: start_ns}, host
    operations {correlation id: start_ns}, backward [(start_ns, end_ns,
    name)]).  A host event linked to an operation (linked id above 0) is
    a runtime or driver call, and its correlation id is that of the
    device operations it launched; the others are operations."""
    dev, host = [], []
    corr, launches, ops, back = [], {}, {}, []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        dur = e.duration_ns()
        if e.device_type() == cuda:
            corr.append((e.correlation_id(), e.linked_correlation_id(),
                         dur * 1e-9))
            if dur > 0:
                dev.append((start, start + dur, e.name()))
            continue
        name = e.name()
        if dur > 0:
            host.append((start, start + dur, name))
        if e.linked_correlation_id() > 0:
            launches[e.correlation_id()] = start
        else:
            ops[e.correlation_id()] = start
            if name.startswith(BACKWARD):
                back.append((start, start + dur, name))
    dev.sort()
    host.sort()
    return dev, host, (corr, launches, ops, back)


def backward_s(dev, launches, ops, back):
    """The seconds of the device operations `dev` whose launch (the
    launch with their correlation id, or else the host operation their
    linked id names) lies inside one of the `back` intervals; None without
    a backward interval or a device operation."""
    if not back or not dev:
        return None
    merged = _union(sorted(back))
    starts = [s for s, _ in merged]
    total = 0.0
    for corr, linked, seconds in dev:
        at = launches.get(corr, ops.get(linked))
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= merged[i][1]:
            total += seconds
    return total


def _union(intervals):
    """Merged [(start, end)] of intervals sorted by start."""
    out = []
    for s, e, _ in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Slice:
    """The reduced profile of `renders` renders."""

    def __init__(self, prof, window_s: float, renders: int, samples: int):
        self.window_s = window_s
        self.renders = renders
        self.samples = samples
        self.device, host, backward = _events(prof)
        merged = _union(self.device)
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        self.n_device_ops = len(self.device)
        self.device_ops = {}
        for s, e, name in self.device:
            key = short_name(name)
            self.device_ops[key] = self.device_ops.get(key, 0.0) + (
                e - s) * 1e-9
        self.idle_by_host = _label_gaps(merged, host)
        self.backward_s = backward_s(*backward)

    def device_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum((e - s) * 1e-9 for s, e, name in self.device
                   if rx.search(name))

    def breakdown(self, n: int = 10) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(self.device_ops),
                "idle_gaps": top(self.idle_by_host)}


def short_name(name: str) -> str:
    """A device or host operation's name without the namespaces every
    kernel shares, cut to NAME_CHARS."""
    for noise in NAME_NOISE:
        name = name.replace(noise, "")
    return name[:NAME_CHARS]


def _label_gaps(merged, host) -> dict:
    """Seconds of the gaps between device intervals, by the innermost
    host operation covering each gap's middle."""
    starts = [h[0] for h in host]
    out = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        # host events sorted by start: scan back over those that started
        # before the middle; the innermost is the latest-starting cover
        for j in range(i - 1, max(-1, i - 1 - SCAN_BACK), -1):
            s, e, name = host[j]
            if e >= mid:
                best = name
                break
        key = ("host " + short_name(best)) if best else "host python"
        out[key] = out.get(key, 0.0) + (b - a) * 1e-9
    return out


def profile_calls(call, n: int, samples_per_call: int) -> Slice:
    """Profile `n` calls of `call(i)`, each of which ends in a device
    sync; CPU and CUDA activities."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            call(i)
        window = time.perf_counter() - t0
    return Slice(prof, window, n, n * samples_per_call)
