"""Accumulator checkpoint and resume (the port's copy of
`rtw_tpu.utils.checkpoint`, with its semantics).

A render with a checkpoint path saves (radiance sum in lane order, rays,
samples done, config fingerprint) as it goes, and resumes from a saved
file whose fingerprint matches its config: every draw is keyed by
(pixel, sample), so the resumed render continues the same sample stream
and ends bit-equal to an uninterrupted one.  A missing file or another
config's file means "start fresh".  The ray count is the port's int64.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


def _fingerprint(cfg) -> str:
    d = dataclasses.asdict(cfg)
    # the accumulator is stored in lane order: a change of the lane-to-pixel
    # map (render.tile_permutation) must reject older files, not resume them
    # scrambled
    d["_pixel_layout"] = "tile32"
    return json.dumps(d, sort_keys=True)


def save(path: str, cfg, accum: np.ndarray, rays: int,
         spp_done: int) -> None:
    """Write the state to `path` through a temporary file and an atomic
    replace, so a reader never sees half a file."""
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        accum=np.asarray(accum, np.float32),
        rays=np.int64(rays),
        spp_done=np.int64(spp_done),
        fingerprint=np.bytes_(_fingerprint(cfg).encode()),
    )
    # np.savez appends .npz
    src = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(src, path)


def load(path: str, cfg):
    """(accum, rays, spp_done), or None when the file is absent or was
    saved for another config."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if bytes(z["fingerprint"]).decode() != _fingerprint(cfg):
            return None
        return np.asarray(z["accum"]), int(z["rays"]), int(z["spp_done"])
