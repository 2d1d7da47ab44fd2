"""wrapper_host_us.grad: the host time of a kernel wrapper call in a
gradient step, from the program's spans, in us: the mean duration of the
traced steps' `kernel.*` spans (B's `trace` and C's `occluded_kernel` in
the split tier's gradient branch: the checks, the launch parameters and
the launch, not the kernel's run).  None without a gradient run's traced
steps or without such spans."""

from harness import readers


def read(run):
    got = readers.step_spans(run, lambda s: s.name.startswith("kernel."))
    if got is None:
        return None
    return 1e-3 * sum(s.end_ns - s.start_ns for s in got) / len(got)
