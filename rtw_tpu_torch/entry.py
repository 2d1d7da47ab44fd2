"""Entry points of the port (the counterpart of __graft_entry__.py).

entry() -> (fn, example_args): the forward step of the flagship path, one
`trace_paths` sample of every pixel of the Cornell box at 64x64, depth 6.

dryrun_multichip(n): the multi-rank step on n local ranks
(parallel/worker.py): pixel- and sample-sharded renders, the sharded
gradient with its all-reduced leaves, and a sharded render on the split
tier's queue, all on tiny shapes; every result must be finite.  On the
CPU the ranks run gloo; with a card they render on it (NCCL when each
rank has a card of its own, else gloo with host-staged collectives).

Both run on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def entry(device="cuda"):
    from rtw_tpu_torch import RenderConfig, build_scene
    from rtw_tpu_torch.integrator import trace_paths

    cfg = RenderConfig(nx=64, ny=64, spp=1, max_depth=6, scene_id=0)
    scene = build_scene(0, cfg.nx, cfg.ny, device=device)
    pixel_idx = torch.arange(cfg.num_pixels, dtype=torch.int32,
                             device=scene.device)

    def fn(pixel_idx):
        return trace_paths(scene, cfg, pixel_idx, 0, 0)

    return fn, (pixel_idx,)


def dryrun_rank(mesh) -> dict:
    """One rank's share of `dryrun_multichip` on `mesh`; raises unless
    every image, loss and gradient leaf is finite.  Returns the shapes and
    the loss."""
    from rtw_tpu_torch import RenderConfig, build_scene
    from rtw_tpu_torch import diff as D
    from rtw_tpu_torch.parallel.mesh import grad_sharded, render_sharded

    n = mesh.world
    # tiny shapes; the pixel count divides any world size
    cfg = RenderConfig(nx=8 * n, ny=8, spp=n, max_depth=3, scene_id=0,
                       differentiable=True)
    scene = build_scene(0, cfg.nx, cfg.ny, device=mesh.device)

    # forward, both sharding strategies
    img_p = render_sharded(scene, cfg, mesh, 0, mode="pixels")
    img_s = render_sharded(scene, cfg, mesh, 0, mode="samples")
    for img in (img_p, img_s):
        assert tuple(img.shape) == (cfg.ny, cfg.nx, 3)
        assert bool(torch.isfinite(img).all())

    # the training step: sharded backward + gradient all-reduce
    params = D.extract_params(scene)
    target = torch.zeros((cfg.ny, cfg.nx, 3), device=mesh.device)
    loss, grads = grad_sharded(scene, cfg, mesh, params, target, 0,
                               n_samples=1)
    assert np.isfinite(float(loss))
    leaves = D._leaves(grads)
    assert leaves and all(bool(torch.isfinite(g).all()) for g in leaves)

    # the split tier's configuration: the queue, with kernels B, E, C and
    # F on the card (their plain versions on the CPU)
    cfg_k = dataclasses.replace(
        cfg, differentiable=False, scheduler="queue",
        backend="pallas" if mesh.device.type == "cuda" else "auto")
    img_k = render_sharded(scene, cfg_k, mesh, 0, mode="pixels")
    assert tuple(img_k.shape) == (cfg.ny, cfg.nx, 3)
    assert bool(torch.isfinite(img_k).all())
    return {"shape": list(img_p.shape), "loss": float(loss)}


def dryrun_multichip(n_devices: int, device="cuda") -> list[dict]:
    """`dryrun_rank` on `n_devices` local ranks; each rank's result."""
    from rtw_tpu_torch.models import scene as S
    from rtw_tpu_torch.parallel import worker

    device = S.scene_device(device, "dryrun_multichip").type
    if device == "cuda":
        from rtw_tpu_torch.utils import kernels

        kernels.build_all(["mega_kernel", "trace_kernel",  # once, here
                           "shade_kernel"])
    return worker.launch([{"kind": "dryrun"}], n_devices, device=device)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape))
    dryrun_multichip(max(torch.cuda.device_count(), 2))
    print("dryrun ok")
