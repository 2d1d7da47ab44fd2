"""Whether the window's renders are correct: the program's pixels against
the plain reference's.

During the window every call keeps its image's values at its drawn pixels
(`traffic.pixel_samples`).  Once the window has closed and the program's
state is freed, the judged calls (`traffic.checked_calls`) are rendered
again by the plain reference (`plainref.paths.render_pixels`) at the same
pixels, with the same seed, samples and depth, and compared.

The numbers compared, over every judged pixel and channel:

- `rel_l1`: the summed |program - reference| over the summed |reference|;
- `off_share`: the share of judged pixels with a channel off by more than
  `PIXEL_ATOL + PIXEL_RTOL * |reference|` (the goldens' float
  reassociation tolerance);
- `nonfinite`: program values that are NaN or infinite (limit 0).

A path that takes another branch on a rounding difference traces another
path from there on, so a few pixels differ on any sound run; a lower
precision, a lost sample or a misplaced pixel moves most of them.  The
limits of a cell are in `cells/<cell>.json`, with the readings they were
set from.
"""

from __future__ import annotations

import dataclasses

import torch

PIXEL_ATOL = 1e-4
PIXEL_RTOL = 1e-4
NUMBERS = ("rel_l1", "off_share", "nonfinite")


@dataclasses.dataclass
class Kept:
    """One call's kept pixels: the render seed, the pixel ids (int64 [P])
    and the program's values there ([P, 3] float32)."""

    seed: int
    pixels: torch.Tensor
    values: torch.Tensor


def compare(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The compared numbers of program values `got` against reference
    values `ref` (both [P, 3] float32 on one device)."""
    finite = torch.isfinite(got)
    g = torch.where(finite, got, 0.0).double()
    r = ref.double()
    diff = (g - r).abs()
    off = (diff > PIXEL_ATOL + PIXEL_RTOL * r.abs()).any(dim=1) | (
        ~finite).any(dim=1)
    return {"rel_l1": float(diff.sum() / r.abs().sum().clamp_min(1e-30)),
            "off_share": float(off.double().mean()),
            "nonfinite": int((~finite).sum())}


def reference_values(ref_scene, ref_cfg, kept: list, counts=None,
                     round_to=None) -> torch.Tensor:
    """The reference's values at every kept call's pixels, stacked, all
    calls' lanes traced together (each pixel with its call's seed)."""
    from plainref import paths

    dev = ref_scene.device
    pixels = torch.cat([k.pixels.to(dev) for k in kept])
    seeds = torch.cat([torch.full(k.pixels.shape, k.seed, dtype=torch.int64,
                                  device=dev) for k in kept])
    return paths.render_pixels(ref_scene, ref_cfg, seeds, pixels,
                               counts=counts, round_to=round_to)


def judge(numbers: dict, limits: dict, names=NUMBERS) -> bool:
    """Every number of `names` within its limit (each cell gives every
    limit)."""
    return all(numbers[k] <= limits[k] for k in names)


def report_lines(numbers: dict, limits: dict, names=NUMBERS) -> list[str]:
    return [f"check {k} {numbers[k]!r} limit {limits[k]!r}"
            for k in names]
