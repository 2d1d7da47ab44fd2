"""device_idle_pct.denoised: as device_idle_pct, in the denoised-frame
cell, where it moves the frame times."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   "device_idle_pct.py"))["read"]
