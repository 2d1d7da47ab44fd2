"""Top-level render driver (port of rtw_tpu/render.py): spp accumulation,
ray batches, image assembly.

The render runs on its scene's device.  Checkpointing (ROADMAP item 13) and
the wavefront counters of `bounce_stats` (ROADMAP item 11) raise.
"""

from __future__ import annotations

import math
import sys as _sys
import time as _time

import numpy as np
import torch

from rtw_tpu_torch.integrator import trace_wavefront


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

    `metrics` receives wall_seconds (host clock around work that ends in a
    device sync), pixels, spp, paths, rays (camera + bounce + NEE queries,
    counted in int64), samples_per_sec and mrays_per_sec."""
    if checkpoint_path is not None or checkpoint_every:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP item 13)")
    if cfg.bounce_stats or cfg.occupancy_trace:
        raise NotImplementedError(
            "bounce_stats/occupancy_trace are not ported yet (ROADMAP item "
            "11)")
    if seed is None:
        seed = cfg.seed
    dev = scene.device

    npix = cfg.num_pixels
    batch = cfg.resolved_ray_batch()
    chunk = cfg.resolved_spp_chunk(checkpointing=False)
    n_tiles = math.ceil(npix / batch)
    pad = n_tiles * batch - npix
    perm = tile_permutation(cfg.nx, cfg.ny)
    pixel_idx = torch.as_tensor(
        np.concatenate([perm, np.zeros(pad, np.int32)]), device=dev)
    accums = [torch.zeros((batch, 3), dtype=torch.float32, device=dev)
              for _ in range(n_tiles)]
    rays = torch.zeros(1, dtype=torch.int64, device=dev)

    _sync(dev)
    t_start = _time.perf_counter()
    s0 = 0
    while s0 < cfg.spp:
        ns = min(chunk, cfg.spp - s0)
        for ti in range(n_tiles):
            tile_pix = pixel_idx[ti * batch:(ti + 1) * batch]
            acc_v, r, _ = trace_wavefront(scene, cfg, tile_pix, seed, s0, ns)
            accums[ti] = accums[ti] + acc_v.stack()
            rays += r
        s0 += ns
        if verbose:
            _sync(dev)
            print(f"INFO: {s0}/{cfg.spp} spp done", file=_sys.stderr,
                  flush=True)

    lanes = torch.cat(accums, dim=0)[:npix]
    img = torch.empty_like(lanes)
    img[torch.as_tensor(perm, dtype=torch.int64, device=dev)] = lanes
    img = img / float(np.float32(cfg.spp))
    total_rays = int(rays.item())          # syncs the device
    elapsed = _time.perf_counter() - t_start

    if metrics is not None:
        n_paths = npix * cfg.spp
        metrics.update(
            wall_seconds=elapsed,
            pixels=npix,
            spp=cfg.spp,
            paths=n_paths,
            rays=total_rays,
            samples_per_sec=n_paths / max(elapsed, 1e-9),
            mrays_per_sec=total_rays / max(elapsed, 1e-9) / 1e6,
        )
    return img.reshape(cfg.ny, cfg.nx, 3)


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
