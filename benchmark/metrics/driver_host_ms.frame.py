"""driver_host_ms.frame: the driver's per-call set-up outside the render
loop, in ms: the mean over the window's calls of (the call's wall time -
the render's own `wall_seconds` span); in the 1-spp frame cell."""

from harness.readers import driver_host_ms as read  # noqa: F401
