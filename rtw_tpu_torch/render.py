"""Top-level render driver (port of rtw_tpu/render.py): spp accumulation,
ray batches, checkpoint and resume, image assembly, and the metrics of the
wavefront counters (cfg.bounce_stats).

The render runs on its scene's device.
"""

from __future__ import annotations

import math
import sys as _sys
import time as _time

import numpy as np
import torch

from rtw_tpu_torch.integrator import stats_add, stats_zero, trace_wavefront
from rtw_tpu_torch.utils import checkpoint as ckpt
from rtw_tpu_torch.utils import profiling as P


def tile_permutation(nx: int, ny: int, tile: int = 32) -> np.ndarray:
    """Pixel visit order that groups tile x tile image tiles into contiguous
    lane runs (the reference's lane layout; lane i renders pixel perm[i]).
    Pure relabeling: per-pixel estimates are keyed by logical pixel id."""
    y, x = np.mgrid[0:ny, 0:nx]
    y, x = y.ravel(), x.ravel()
    perm = np.lexsort((x % tile, y % tile, x // tile, y // tile))
    return perm.astype(np.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render(scene, cfg, seed: int | None = None, verbose: bool = False,
           metrics: dict | None = None, checkpoint_path: str | None = None,
           checkpoint_every: int = 0):
    """Render and return the linear [ny, nx, 3] float32 image (row 0 at the
    bottom), on the scene's device.  `seed` defaults to cfg.seed.

    With `checkpoint_path` the accumulator is saved whenever at least
    `checkpoint_every` samples have accrued since the last save (every spp
    chunk when 0) and at the end, and a file saved for the same config is
    resumed from (utils/checkpoint.py): the image is bit-equal to an
    uninterrupted render's.

    `metrics` receives wall_seconds (host clock around work that ends in a
    device sync), pixels, spp, paths (those rendered by this call), rays
    (camera + bounce + NEE queries, counted in int64, a resumed file's
    included), samples_per_sec and mrays_per_sec; with cfg.bounce_stats
    also rays_by_depth, wavefront_iterations, mean_occupancy and
    occupancy_by_iter (empty unless cfg.occupancy_trace), counted by this
    call.

    Under a torch.profiler capture the call records its spans
    (utils/profiling.py): `render` around the whole call, `render.setup`,
    a `sched.*` span for each scheduler call, `render.assemble`, and
    `render.wait` around each place the host waits for the card (the
    permutation's copy inside the assembly, the ray count's read that
    ends `wall_seconds`)."""
    with P.span("render"):
        if seed is None:
            seed = cfg.seed
        dev = scene.device

        with P.span("render.setup"):
            npix = cfg.num_pixels
            batch = cfg.resolved_ray_batch()
            chunk = cfg.resolved_spp_chunk(
                checkpointing=checkpoint_path is not None)
            n_tiles = math.ceil(npix / batch)
            pad = n_tiles * batch - npix
            perm = tile_permutation(cfg.nx, cfg.ny)
            pixel_idx = torch.as_tensor(
                np.concatenate([perm, np.zeros(pad, np.int32)]), device=dev)
            accums = [torch.zeros((batch, 3), dtype=torch.float32, device=dev)
                      for _ in range(n_tiles)]
            rays = torch.zeros(1, dtype=torch.int64, device=dev)
            stats = (stats_zero(cfg.max_depth, cfg.occupancy_trace, dev)
                     if cfg.bounce_stats else ())
            spp_done = 0
            if checkpoint_path is not None:
                state = ckpt.load(checkpoint_path, cfg)
                if state is not None:
                    acc_np, rays0, spp_done = state
                    per = np.zeros((n_tiles * batch, 3), np.float32)
                    per[:acc_np.shape[0]] = acc_np
                    accums = list(torch.as_tensor(per, device=dev).split(
                        batch))
                    rays += rays0
                    if verbose:
                        print(f"INFO: resumed at {spp_done}/{cfg.spp} spp",
                              file=_sys.stderr, flush=True)

        _sync(dev)
        t_start = _time.perf_counter()
        s0 = last_save = spp_done
        while s0 < cfg.spp:
            ns = min(chunk, cfg.spp - s0)
            for ti in range(n_tiles):
                tile_pix = pixel_idx[ti * batch:(ti + 1) * batch]
                acc_v, r, st = trace_wavefront(scene, cfg, tile_pix, seed,
                                               s0, ns)
                accums[ti] = accums[ti] + acc_v.stack()
                rays += r
                if stats:
                    stats = stats_add(stats, st)
            s0 += ns
            if verbose:
                _sync(dev)
                print(f"INFO: {s0}/{cfg.spp} spp done", file=_sys.stderr,
                      flush=True)
            # not an exact-multiple test: spp chunks need not divide
            # checkpoint_every
            if checkpoint_path is not None and (
                    s0 >= cfg.spp or checkpoint_every <= 0
                    or s0 - last_save >= checkpoint_every):
                acc_np = torch.cat(accums)[:npix].cpu().numpy()
                ckpt.save(checkpoint_path, cfg, acc_np, int(rays.item()), s0)
                last_save = s0

        with P.span("render.assemble"):
            lanes = torch.cat(accums, dim=0)[:npix]
            img = torch.empty_like(lanes)
            with P.span("render.wait"):
                # the permutation's copy from pageable host memory: the
                # host waits for the card's queue (the render's kernels)
                img[torch.as_tensor(perm, dtype=torch.int64,
                                    device=dev)] = lanes
            img = img / float(np.float32(cfg.spp))
        with P.span("render.wait"):
            total_rays = int(rays.item())          # syncs the device
        elapsed = _time.perf_counter() - t_start

        if metrics is not None:
            n_paths = npix * (cfg.spp - spp_done)
            metrics.update(
                wall_seconds=elapsed,
                pixels=npix,
                spp=cfg.spp,
                paths=n_paths,
                rays=total_rays,
                samples_per_sec=n_paths / max(elapsed, 1e-9),
                mrays_per_sec=total_rays / max(elapsed, 1e-9) / 1e6,
            )
            if stats:
                metrics.update(_stats_metrics(stats, batch))
        return img.reshape(cfg.ny, cfg.nx, 3)


def _stats_metrics(stats, batch: int) -> dict:
    """The reference's metrics of the counters, from their exact int64
    values (the reference's float32 sums equal them while exact)."""
    st = [t.cpu().numpy() for t in stats]
    len_hist, iters, alive_sum, occ_sum, occ_cnt = st
    # rays_by_depth[d]: paths that traced a ray at depth d, the paths of
    # every length L > d
    tail = np.cumsum(len_hist[::-1])[::-1]
    return dict(
        rays_by_depth=[float(x) for x in tail[1:]],
        wavefront_iterations=float(iters[0]),
        mean_occupancy=float(alive_sum[0]) / max(float(iters[0]) * batch,
                                                 1.0),
        occupancy_by_iter=[float(np.float32(s) / np.float32(c)) / batch
                           for s, c in zip(occ_sum, occ_cnt) if c >= 1],
    )


def to_srgb8(linear_img, gamma: float = 2.0) -> np.ndarray:
    """Clamp + gamma -> uint8, top row first (the reference's numpy
    formula, rtw_tpu/utils/native.py:115-116)."""
    if torch.is_tensor(linear_img):
        linear_img = linear_img.detach().cpu().numpy()
    linear = np.ascontiguousarray(linear_img, np.float32)
    img = (np.clip(linear, 0.0, 1.0) ** (1.0 / gamma) * 255.99).astype(
        np.uint8)
    return img[::-1]


def render_image(scene, cfg, seed=None, verbose=False, metrics=None):
    """Render to a gamma-corrected uint8 [ny, nx, 3] image (top row first)."""
    return to_srgb8(render(scene, cfg, seed, verbose, metrics), cfg.gamma)
