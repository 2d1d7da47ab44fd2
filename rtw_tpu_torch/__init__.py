"""rtw_tpu_torch — the PyTorch + CUDA port of rtw_tpu for one NVIDIA H100.

The same scenes, RenderConfig and fast-RNG sample streams as `rtw_tpu`
(the JAX reference, which this package never imports).  On a CUDA scene
the main path runs one hand-written CUDA megakernel launch per wavefront
iteration (ops/mega_kernel.py, csrc/mega_kernel.cu); every kernel has a
plain torch twin, which is what runs on CPU tensors.

Package layout:
  models/   scene data model, builder, the six registered scenes
  ops/      vectors, sampling, intersection, shading, the bounce estimator,
            the megakernel wrapper and its props table
  csrc/     CUDA sources, built with nvcc at first use (utils/kernels.py)
  utils/    config, RNG, kernel builder
"""

from rtw_tpu_torch.utils.config import RenderConfig
from rtw_tpu_torch.render import render, render_image
from rtw_tpu_torch.models.registry import build_scene, SCENE_NAMES

__all__ = [
    "RenderConfig",
    "render",
    "render_image",
    "build_scene",
    "SCENE_NAMES",
]
