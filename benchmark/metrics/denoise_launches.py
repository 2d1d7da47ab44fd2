"""denoise_launches: the device operations (kernels, copies, sets) of a
traced denoised frame launched inside the benchmark's `bench.denoise`
marker (`harness/trace.Slice.marked`), over the traced calls.  None
without a traced slice or where nothing ran inside the marker."""

from harness.denoised import MARKER


def read(run):
    got = getattr(run.slice, "marked", {}).get(MARKER)
    if not got or got[1] == 0:
        return None
    return got[1] / run.slice.renders
