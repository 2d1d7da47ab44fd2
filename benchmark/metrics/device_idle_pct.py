"""device_idle_pct: the share of the traced calls' host-clock window in
which no device operation runs (the union of the profiler's device
intervals), in %."""


def read(run):
    if run.slice is None or run.slice.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)
