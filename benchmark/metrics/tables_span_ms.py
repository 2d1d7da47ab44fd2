"""tables_span_ms: the per-call tables from the program's spans, in ms:
the mean over the traced calls of their summed `tables` spans
(`mega_params` whole: the split tables, the camera and light rows' copy
to the host, the launch struct; the split tier's `_render_tables`).

The program's span recorder is read where the harness loaded it
(`sys.modules`).  None without a traced slice or without spans."""

import sys


def read(run):
    prof = sys.modules.get("rtw_tpu_torch.utils.profiling")
    if run.slice is None or not hasattr(prof, "calls"):
        return None
    calls = prof.calls(run.slice.renders)
    if not calls:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for c in calls for s in c
                      if s.name == "tables") / len(calls)
