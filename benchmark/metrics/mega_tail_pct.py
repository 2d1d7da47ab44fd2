"""mega_tail_pct: the megakernel's tail, from its own clock stamps, in %:
over the traced calls' `mega.launch` spans, 100 x the summed (last warp's
exit - the moment the lane counter ran dry) over the summed (exit - the
first block's start), as `ops/mega_kernel.trace_tail` decodes the
launch's `%globaltimer` stamps (the span's `tail` value).

The program's span recorder is read where the harness loaded it
(`sys.modules`).  None without a traced slice or without such spans."""

import sys


def read(run):
    prof = sys.modules.get("rtw_tpu_torch.utils.profiling")
    if run.slice is None or not hasattr(prof, "calls"):
        return None
    tails = [s.values["tail"] for c in prof.calls(run.slice.renders)
             for s in c if s.name == "mega.launch" and "tail" in s.values]
    kernel = sum(t["kernel_ms"] for t in tails)
    if kernel <= 0:
        return None
    return 100.0 * sum(t["tail_ms"] for t in tails) / kernel
