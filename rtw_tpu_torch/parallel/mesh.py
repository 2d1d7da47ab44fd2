"""Sharded rendering over ranks (port of rtw_tpu/parallel/mesh.py on
torch.distributed).

One process is one rank; the reference's "device of a 1-D mesh" is a rank
here, and `Mesh` is the rank's record: its rank, the world size, the
process group and the device it renders on.  Two sharding strategies, the
reference's:

- **pixel sharding**: each rank owns a contiguous slab of the
  tile-ordered lanes (`render.tile_permutation`) and traces it end to end
  on its own device; the scene is replicated, and the only collectives
  are the all-gather of the slabs (at each checkpoint and at the end) and
  the sum of the ray counts.
- **sample sharding**: every rank renders the whole frame at spp / world
  samples (rank r draws samples r * spp / world + ...) and the chunk sums
  are all-reduced.

Every draw is keyed by (pixel, sample) only (utils/rng.py), so both give
the single-process image: bit-equal in pixel mode under the regen and
megakernel schedulers (each lane adds its samples in a fixed order), to
float reassociation under the work queue and in sample mode.

`grad_sharded` splits the pixels the same way, runs each rank's backward
and all-reduces the loss and every gradient leaf.

Backends: NCCL where each rank has a card of its own, gloo otherwise (the
CPU, or ranks that share one card: NCCL refuses two ranks on one device).
On gloo every collective goes through a host copy (`.cpu()` before it,
back to the device after): the code never relies on gloo's CUDA paths.
Every collective of this module is one of `all_gather_rows` and
`all_reduce_sum`, and every rank enters each one: a checkpoint is
gathered by all ranks before rank 0 alone writes it (the reference found
that a collective entered by rank 0 alone deadlocks, mesh.py:174-178).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import sys as _sys
import time as _time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from rtw_tpu_torch import diff as D
from rtw_tpu_torch.integrator import trace_paths_counted, trace_wavefront
from rtw_tpu_torch.render import tile_permutation
from rtw_tpu_torch.utils import checkpoint as ckpt

# How long a collective waits for its peers before it raises, in every job
# (the CLI's under torchrun, the worker's ranks): a dead peer ends the job
# in minutes, not torch's default half hour.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the job: `group` is None for a single process
    (world 1, no collective), `backend` "nccl", "gloo" or None with it."""

    rank: int
    world: int
    group: Any
    device: torch.device
    backend: str | None


def _local_rank(process_id: int) -> int:
    return int(os.environ.get("LOCAL_RANK", process_id))


def default_backend(num_processes: int) -> str:
    """NCCL when each local rank has a card of its own, gloo otherwise."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None):
    """Start the process group of a multi-process job (torch.distributed
    over TCP); a no-op for one process.  Without arguments the job is read
    from torchrun's environment (WORLD_SIZE, RANK, MASTER_ADDR,
    MASTER_PORT) when it is set.  `backend` defaults to
    `default_backend`; under NCCL the rank's card becomes the current
    device.  Every collective waits at most COLLECTIVE_TIMEOUT."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
        if coordinator_address is None:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = default_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(process_id)
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=COLLECTIVE_TIMEOUT)


def make_mesh(group=None, device=None) -> Mesh:
    """The calling rank's Mesh over `group` (default: the initialised
    process group; world 1 when there is none).  `device`: where the rank
    renders, by default its card (under NCCL the current device, else
    local rank modulo the cards: ranks beyond the cards share them);
    pass "cpu" to render on the CPU."""
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        backend = dist.get_backend(group)
    else:
        group, rank, world, backend = None, 0, 1, None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' "
                               "to render on the CPU")
        index = (torch.cuda.current_device() if backend == "nccl"
                 else _local_rank(rank) % torch.cuda.device_count())
        device = torch.device("cuda", index)
    return Mesh(rank=rank, world=world, group=group,
                device=torch.device(device), backend=backend)


def _wire(t, mesh: Mesh):
    """The copy of `t` a collective reads and writes: on the host under
    gloo, on the rank's card under NCCL."""
    t = t.detach()
    return t.cpu().clone() if mesh.backend == "gloo" else t.contiguous().clone()


def all_gather_rows(t, mesh: Mesh):
    """The ranks' `t` (equal shapes) concatenated along dim 0, in rank
    order, on `t`'s device.  World 1 without a group: `t` itself."""
    if mesh.group is None:
        return t
    buf = _wire(t, mesh)
    parts = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts).to(t.device)


def all_reduce_sum(t, mesh: Mesh):
    """The sum of the ranks' `t`, on `t`'s device.  World 1 without a
    group: `t` itself."""
    if mesh.group is None:
        return t
    buf = _wire(t, mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(t.device)


def _pad_to(n: int, m: int) -> int:
    return math.ceil(n / m) * m


def shard_pixels(cfg, world: int, rank: int) -> np.ndarray:
    """int32 [padded / world]: the pixel of each lane of `rank`'s slab in
    pixel mode, the tile-ordered lanes padded to a multiple of `world`
    with pixel 0 (a padded lane traces pixel 0; its rays count, its sum is
    dropped)."""
    npix = cfg.num_pixels
    padded = _pad_to(npix, world)
    lanes = np.zeros(padded, np.int32)
    lanes[:npix] = tile_permutation(cfg.nx, cfg.ny)
    per = padded // world
    return lanes[rank * per:(rank + 1) * per]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _metrics(metrics, elapsed, npix, spp, world, n_paths, rays):
    if metrics is not None:
        metrics.update(
            wall_seconds=elapsed, pixels=npix, spp=spp, devices=world,
            paths=n_paths, rays=rays,
            samples_per_sec=n_paths / max(elapsed, 1e-9),
            mrays_per_sec=rays / max(elapsed, 1e-9) / 1e6,
        )


def render_sharded(scene, cfg, mesh: Mesh, seed: int | None = None,
                   mode: str = "pixels", metrics: dict | None = None,
                   verbose: bool = False,
                   checkpoint_path: str | None = None,
                   checkpoint_every: int = 0):
    """Sharded render; returns the whole linear [ny, nx, 3] image on every
    rank, on the scene's device.  `seed` defaults to cfg.seed.

    mode="pixels": a slab of lanes per rank.  mode="samples": the whole
    frame per rank at spp / world samples, summed; raises ValueError when
    spp does not divide.

    Both modes accumulate in the spp chunks of cfg.resolved_spp_chunk(),
    so the pixel-mode image is bit-equal to `render`'s under the regen and
    megakernel schedulers.  With `checkpoint_path` the accumulator is
    saved by rank 0 every `checkpoint_every` samples (every chunk when 0)
    and at the end, and resumed from (utils/checkpoint.py); sample mode
    stores each rank's samples done.  `metrics` gets render's keys and
    `devices` (the world size); rays are every rank's, in int64."""
    if seed is None:
        seed = cfg.seed
    world, rank = mesh.world, mesh.rank
    dev = scene.device
    npix = cfg.num_pixels
    chunk = cfg.resolved_spp_chunk()
    rays = torch.zeros(1, dtype=torch.int64, device=dev)   # this call's

    if mode == "pixels":
        slab = torch.as_tensor(shard_pixels(cfg, world, rank), device=dev)
        per = slab.shape[0]
        acc = torch.zeros((per, 3), dtype=torch.float32, device=dev)
        rays0 = spp_done = 0
        if checkpoint_path is not None:
            state = ckpt.load(checkpoint_path, cfg)
            if state is not None:
                acc_np, rays0, spp_done = state
                full = np.zeros((per * world, 3), np.float32)
                full[:acc_np.shape[0]] = acc_np
                acc = torch.as_tensor(full[rank * per:(rank + 1) * per],
                                      device=dev)
                if verbose:
                    print(f"INFO: resumed at {spp_done}/{cfg.spp} spp",
                          file=_sys.stderr, flush=True)

        _sync(dev)
        t_start = _time.perf_counter()
        s0 = last_save = spp_done
        while s0 < cfg.spp:
            ns = min(chunk, cfg.spp - s0)
            a, r, _ = trace_wavefront(scene, cfg, slab, seed, s0, ns)
            acc = acc + a.stack()
            rays += r
            s0 += ns
            if verbose:
                _sync(dev)
                print(f"INFO: {s0}/{cfg.spp} spp done", file=_sys.stderr,
                      flush=True)
            if checkpoint_path is not None and (
                    s0 >= cfg.spp or checkpoint_every <= 0
                    or s0 - last_save >= checkpoint_every):
                # every rank enters both collectives; rank 0 alone writes
                lanes = all_gather_rows(acc, mesh)[:npix]
                total = rays0 + int(all_reduce_sum(rays, mesh).item())
                if rank == 0:
                    ckpt.save(checkpoint_path, cfg, lanes.cpu().numpy(),
                              total, s0)
                last_save = s0
        lanes = all_gather_rows(acc, mesh)[:npix]
        total = rays0 + int(all_reduce_sum(rays, mesh).item())  # syncs
        elapsed = _time.perf_counter() - t_start
        img = torch.empty_like(lanes)
        img[torch.as_tensor(tile_permutation(cfg.nx, cfg.ny),
                            dtype=torch.int64, device=dev)] = lanes
        img = img / float(np.float32(cfg.spp))
        _metrics(metrics, elapsed, npix, cfg.spp, world,
                 npix * (cfg.spp - spp_done), total)
        return img.reshape(cfg.ny, cfg.nx, 3)

    if mode == "samples":
        if cfg.spp % world != 0:
            raise ValueError(f"spp={cfg.spp} not divisible by {world} "
                             "devices")
        local_spp = cfg.spp // world
        pixel_idx = torch.arange(npix, dtype=torch.int32, device=dev)
        local_chunk = min(max(1, chunk), local_spp)
        acc = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
        rays0 = done = 0          # samples accumulated per rank
        if checkpoint_path is not None:
            state = ckpt.load(checkpoint_path, cfg)
            if state is not None:
                acc_np, rays0, done = state
                acc = torch.as_tensor(acc_np, device=dev)
                if verbose:
                    print(f"INFO: resumed at {done}/{local_spp} "
                          "spp-per-device", file=_sys.stderr, flush=True)

        _sync(dev)
        t_start = _time.perf_counter()
        s0 = last_save = done
        while s0 < local_spp:
            ns = min(local_chunk, local_spp - s0)
            a, r, _ = trace_wavefront(scene, cfg, pixel_idx, seed,
                                      rank * local_spp + s0, ns)
            acc = acc + all_reduce_sum(a.stack(), mesh)
            rays += r
            s0 += ns
            if verbose:
                _sync(dev)
                print(f"INFO: {s0 * world}/{cfg.spp} spp done",
                      file=_sys.stderr, flush=True)
            if checkpoint_path is not None and (
                    s0 >= local_spp or checkpoint_every <= 0
                    or (s0 - last_save) * world >= checkpoint_every):
                # the accumulator is replicated; the ray sum is a collective
                # every rank enters before rank 0 writes
                total = rays0 + int(all_reduce_sum(rays, mesh).item())
                if rank == 0:
                    ckpt.save(checkpoint_path, cfg, acc.cpu().numpy(), total,
                              s0)
                last_save = s0
        total = rays0 + int(all_reduce_sum(rays, mesh).item())  # syncs
        elapsed = _time.perf_counter() - t_start
        img = acc / float(np.float32(cfg.spp))
        _metrics(metrics, elapsed, npix, cfg.spp, world,
                 npix * (cfg.spp - done * world), total)
        return img.reshape(cfg.ny, cfg.nx, 3)

    raise ValueError(f"unknown mode {mode!r}")


def grad_slab(cfg, world: int, rank: int, target, device):
    """(pixel ids int32 [L], target [L, 3], weight [L, 1]) of `rank`'s
    slab of a sharded gradient: the pixels in order, padded to a multiple
    of `world` with pixel 0 at weight 0."""
    npix = cfg.num_pixels
    padded = _pad_to(npix, world)
    per = padded // world
    lo, hi = rank * per, (rank + 1) * per
    pix = torch.zeros(padded, dtype=torch.int32)
    pix[:npix] = torch.arange(npix, dtype=torch.int32)
    weight = torch.zeros((padded, 1), dtype=torch.float32)
    weight[:npix] = 1.0
    tgt = torch.zeros((padded, 3), dtype=torch.float32)
    tgt[:npix] = torch.as_tensor(np.asarray(
        target.detach().cpu() if torch.is_tensor(target) else target,
        np.float32)).reshape(-1, 3)
    return tuple(t[lo:hi].to(device) for t in (pix, tgt, weight))


def grad_local(scene, cfg, params, pix, tgt, weight, npix: int, seed: int,
               n_samples: int):
    """One rank's (loss, grads) over its slab: the squared error weighted
    by `weight`, over the *global* pixel count npix * 3, so the ranks'
    sums are the single-process estimator's; torch autograd through
    `trace_paths_counted`."""
    leaves, p = D._with_grad(params)
    sc = D.apply_params(scene, p)
    acc = torch.zeros((pix.shape[0], 3), dtype=torch.float32,
                      device=scene.device)
    for i in range(n_samples):
        rad, _ = trace_paths_counted(sc, cfg, pix, i, seed)
        acc = acc + rad.stack()
    img = acc / float(np.float32(n_samples))
    loss = (torch.sum(weight * (img - tgt) ** 2)
            / float(np.float32(npix * 3)))
    return loss.detach(), D._grads(loss, leaves, params)


def grad_sharded(scene, cfg, mesh: Mesh, params, target, seed: int,
                 n_samples: int):
    """Data-sharded differentiable render: pixels split across the ranks,
    each rank's backward on its own device, the loss and every gradient
    leaf all-reduced (sum).  `target`: the [ny, nx, 3] (or [npix, 3])
    image the squared error is taken against.  Returns (loss, grads) on
    every rank, grads in `params`' structure on the scene's device."""
    pix, tgt, weight = grad_slab(cfg, mesh.world, mesh.rank, target,
                                 scene.device)
    loss, grads = grad_local(scene, cfg, params, pix, tgt, weight,
                             cfg.num_pixels, seed, n_samples)
    loss = all_reduce_sum(loss.reshape(1), mesh)[0]
    leaves = [all_reduce_sum(g, mesh) for g in D._leaves(grads)]
    return loss, D._unflatten(grads, leaves)
