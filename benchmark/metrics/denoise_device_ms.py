"""denoise_device_ms: the device ms of a traced denoised frame spent in
operations launched inside the benchmark's `bench.denoise` marker (the
program's `denoise()`: the G-buffer's trace, the albedo, the à-trous
passes), matched through the profiler's correlation ids
(`harness/trace.Slice.marked`), over the traced calls.  None without a
traced slice or where nothing ran inside the marker."""

from harness.denoised import MARKER


def read(run):
    got = getattr(run.slice, "marked", {}).get(MARKER)
    if not got or got[0] <= 0:
        return None
    return 1e3 * got[0] / run.slice.renders
