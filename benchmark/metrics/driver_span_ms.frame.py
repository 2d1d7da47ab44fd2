"""driver_span_ms.frame: render.py's own time in a call, from the
program's spans, in ms: the mean over the traced calls of the `render`
span's duration less its `sched.*` children (the wavefront schedulers)
and its `render.wait` spans (the host blocked on the card: the ray
count's read at the end, and the permutation's copy from pageable memory
in the assembly, which waits for the render's kernels); in the 1-spp
frame cell.

The program's span recorder is read where the harness loaded it
(`sys.modules`): a metric module imports nothing of the program.  None
without a traced slice or without spans (a program that records none)."""

import sys


def read(run):
    prof = sys.modules.get("rtw_tpu_torch.utils.profiling")
    if run.slice is None or not hasattr(prof, "calls"):
        return None
    calls = prof.calls(run.slice.renders)
    if not calls:
        return None
    own = 0
    for c in calls:
        r = c[0]
        inner = sum(s.end_ns - s.start_ns for s in c
                    if s.name == "render.wait"
                    or (s.parent == r.id and s.name.startswith("sched.")))
        own += r.end_ns - r.start_ns - inner
    return 1e-6 * own / len(calls)
