"""driver_host_ms.image: as driver_host_ms.frame, in the cells of whole
images (many samples a call)."""

from harness.readers import driver_host_ms as read  # noqa: F401
