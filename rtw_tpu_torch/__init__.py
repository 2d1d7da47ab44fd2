"""rtw_tpu_torch — the PyTorch + CUDA port of rtw_tpu for one NVIDIA H100.

The same scenes, RenderConfig and sample streams as `rtw_tpu`
(the JAX reference, which this package never imports).  Scenes are built
on the card unless the caller asks for the CPU.  On a CUDA scene below 128
prims a render inside the megakernel's envelope runs one launch of the
hand-written persistent CUDA megakernel per pixel batch and spp chunk
(ops/mega_kernel.py, csrc/mega_kernel.cu), and one outside it the plain
regen sweep; from 128 prims up a render runs the work queue with the CUDA
trace and occlusion kernels (ops/trace_kernel.py, csrc/trace_kernel.cu).
Every kernel has a plain torch version, which is what runs on CPU
tensors.

Package layout:
  models/   scene data model, builder, the six registered scenes
  ops/      vectors, sampling, intersection, textures, shading, the bounce
            estimator, the kernel wrappers and their props table
  csrc/     CUDA sources, built with nvcc at first use (utils/kernels.py)
  parallel/ sharded renders and gradients over torch.distributed ranks
            (mesh.py), the local rank launcher (worker.py)
  utils/    config, RNG streams, checkpoint, building the kernels, image
            output, profiling
  denoise.py  the à-trous denoiser and its first-hit G-buffer
  cli.py      the command line (python -m rtw_tpu_torch.cli)
  entry.py    the entry points: entry(), dryrun_multichip(n)
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
