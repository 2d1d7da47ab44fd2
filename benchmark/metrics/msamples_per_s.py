"""msamples_per_s: every pixel sample the window's calls asked for
(nx * ny * spp each, counted by the benchmark), in millions, over the
whole window (the first call's start to the last image's sync)."""


def read(run):
    return len(run.calls) * run.samples_per_call / run.window_s / 1e6
