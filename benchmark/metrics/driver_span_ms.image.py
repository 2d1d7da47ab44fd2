"""driver_span_ms.image: as driver_span_ms.frame, in the cells of whole
images (many samples a call)."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   "driver_span_ms.frame.py"))["read"]
