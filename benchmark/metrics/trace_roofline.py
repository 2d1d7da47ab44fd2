"""trace_roofline: the bound of the traced calls' ray queries
(`harness/work.query_bound_s`) over the device time of the split tier's
trace and occlusion kernels (`trace_kernel`, `occluded_kernel`) together,
in %."""

from harness import work
from harness.readers import kernel_s

KERNELS = r"\b(trace_kernel|occluded_kernel)\b"


def read(run):
    t = kernel_s(run, KERNELS)
    if not t or run.counts is None:
        return None
    w = work.scaled(run.counts, run.slice.samples)
    return 100.0 * work.query_bound_s(w, run.n_vol) / t
