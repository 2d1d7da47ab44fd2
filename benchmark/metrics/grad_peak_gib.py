"""grad_peak_gib: the device's peak allocated memory at the window's close
(`torch.cuda.max_memory_allocated()`), in GiB, in a gradient cell: the
program's, since the run resets the peak once the benchmark has made its
inputs (`harness/grad.py`).  None off the card or outside a gradient
run."""


def read(run):
    peak = getattr(run, "peak_bytes", 0)
    return peak / 2 ** 30 if peak else None
