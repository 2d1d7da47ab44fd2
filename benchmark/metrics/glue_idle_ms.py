"""glue_idle_ms: the card's idle time under the split tier's host glue,
from the program's spans laid over the traced slice's device operations,
in ms a render: the stretches of the traced calls' `queue.iteration`
spans outside their `kernel.*` spans (the wrappers) that no device
operation covers (the union of the profiler's device intervals), summed,
over the traced calls.

The spans and the slice share the profiler's host clock
(`time.time_ns()`).  The program's span recorder is read where the
harness loaded it (`sys.modules`).  None without a traced slice or
without spans."""

import bisect
import sys

from harness.trace import _union


def _minus(a, b, cuts):
    """The pieces of [a, b) outside the sorted, disjoint `cuts`."""
    out = []
    for s, e in cuts:
        if e <= a or s >= b:
            continue
        if s > a:
            out.append((a, s))
        a = max(a, e)
    if a < b:
        out.append((a, b))
    return out


def _covered(busy, starts, a, b):
    """The length of [a, b) that the merged `busy` intervals cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0
    while i < len(busy) and busy[i][0] < b:
        got += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return got


def read(run):
    prof = sys.modules.get("rtw_tpu_torch.utils.profiling")
    if run.slice is None or not hasattr(prof, "calls"):
        return None
    calls = prof.calls(run.slice.renders)
    if not calls:
        return None
    busy = _union(run.slice.device)
    starts = [s for s, _ in busy]
    idle = 0
    for c in calls:
        wrappers = _union(sorted((s.start_ns, s.end_ns, s.name) for s in c
                                 if s.name.startswith("kernel.")))
        for s in c:
            if s.name != "queue.iteration":
                continue
            for a, b in _minus(s.start_ns, s.end_ns, wrappers):
                idle += (b - a) - _covered(busy, starts, a, b)
    return 1e-6 * idle / len(calls)
