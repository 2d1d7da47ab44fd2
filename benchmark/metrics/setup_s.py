"""setup_s: the start of the process to the start of the window: the
imports, the CUDA context, the kernels' load (and build, in a checkout's
first run), the scene, the pixel samples and the warm-up calls."""


def read(run):
    return run.setup_s
