"""frame_ms_p95: the 95th percentile of every call's wall time in the
window, in ms (host clock from the call to `render()` until its image is
synced on the device)."""

import statistics


def read(run):
    walls = [c.wall_s * 1e3 for c in run.calls]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=100, method="inclusive")[94]
