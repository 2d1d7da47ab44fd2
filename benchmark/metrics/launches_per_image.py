"""launches_per_image: the device operations (kernels, copies, sets) of
the traced calls, over the traced calls."""


def read(run):
    if run.slice is None or run.slice.n_device_ops == 0:
        return None
    return run.slice.n_device_ops / run.slice.renders
