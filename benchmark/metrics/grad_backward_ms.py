"""grad_backward_ms: the device ms of a traced gradient step spent in
operations launched from inside torch autograd's backward (remat's
recompute of each bounce included), over the traced steps
(`harness/trace.Slice.backward_s`).  None without a traced slice or
where no backward ran."""


def read(run):
    if run.slice is None or run.slice.backward_s is None:
        return None
    return 1e3 * run.slice.backward_s / run.slice.renders
