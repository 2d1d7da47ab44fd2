"""denoise_roofline: the bound of a frame's denoise
(`harness/work.denoise_bound_s`: the G-buffer's ray a pixel, the à-trous
passes' taps; counted from the cell's image, the harness's passes and the plain
G-buffer's first hits, never from the program) over the device time
launched inside the `bench.denoise` marker a frame, in %."""

from harness import work
from harness.denoised import ITERATIONS, MARKER


def read(run):
    got = getattr(run.slice, "marked", {}).get(MARKER)
    hits = getattr(run, "gbuffer_hits", None)
    if not got or got[0] <= 0 or hits is None:
        return None
    bound = work.denoise_bound_s(hits, run.n_pixels, ITERATIONS)
    return 100.0 * bound * run.slice.renders / got[0]
