"""Arithmetic that more than one metric reader shares."""

from __future__ import annotations

import sys


def driver_host_ms(run):
    """Mean over the window's calls of (the call's wall time - the
    render's own `wall_seconds`), in ms."""
    if not run.calls:
        return None
    return 1e3 * sum(c.wall_s - c.program_wall_s
                     for c in run.calls) / len(run.calls)


def kernel_s(run, pattern: str):
    """Device seconds of the traced slice's operations whose name matches
    `pattern`, or None without a slice."""
    if run.slice is None:
        return None
    return run.slice.device_s(pattern)


def step_spans(run, pick):
    """The program's spans of a gradient run's traced steps (outside any
    `render`, inside `run.span_ns`) for which `pick(span)` holds, or None
    without such a run or such spans.  The span recorder is read where
    the harness loaded it (`sys.modules`)."""
    prof = sys.modules.get("rtw_tpu_torch.utils.profiling")
    window = getattr(run, "span_ns", None)
    if run.slice is None or window is None or not hasattr(prof, "spans"):
        return None
    t0, t1 = window
    got = [s for s in prof.spans() if s.call is None and pick(s)
           and t0 <= s.start_ns and s.end_ns <= t1]
    return got or None
