"""wrapper_host_us: the host time of a kernel wrapper call, from the
program's spans, in us: the mean duration of the traced calls' `kernel.*`
spans (`trace_rows`, `shade`, `occluded_kernel`, `finish`: the checks,
the launch parameters and the launch, not the kernel's run).

The program's span recorder is read where the harness loaded it
(`sys.modules`).  None without a traced slice or without such spans."""

import sys


def read(run):
    prof = sys.modules.get("rtw_tpu_torch.utils.profiling")
    if run.slice is None or not hasattr(prof, "calls"):
        return None
    took = [s.end_ns - s.start_ns for c in prof.calls(run.slice.renders)
            for s in c if s.name.startswith("kernel.")]
    if not took:
        return None
    return 1e-3 * sum(took) / len(took)
