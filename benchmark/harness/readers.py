"""Arithmetic that more than one metric reader shares."""

from __future__ import annotations


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
