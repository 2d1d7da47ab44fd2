"""mega_roofline: the bound of the traced calls' whole-render work
(`harness/work.render_bound_s`) over the device time of the megakernel
(`mega_trace_kernel`), in %."""

from harness import work
from harness.readers import kernel_s

KERNEL = r"\bmega_trace_kernel\b"


def read(run):
    t = kernel_s(run, KERNEL)
    if not t or run.counts is None:
        return None
    w = work.scaled(run.counts, run.slice.samples)
    return 100.0 * work.render_bound_s(w, run.n_pixels, run.slice.renders) / t
