"""Image output: P3 PPM (stdout-compatible with the reference's printPPM,
Director.cpp:1010-1031) and PNG via PIL, and the SSIM score (the port's
copy of `rtw_tpu.utils.image`: numpy and PIL only, the same bytes).

Copied, not imported: importing anything under `rtw_tpu` runs its package
`__init__`, which imports JAX."""


from __future__ import annotations

import sys

import numpy as np


def write_ppm(img_u8: np.ndarray, stream=None) -> None:
    """Write a top-row-first uint8 [H, W, 3] image as P3 PPM.

    Matches the reference byte format: header `P3\\n<W> <H>\\n255\\n` then one
    `r g b` triple per line (printPPM emits space-separated ints; the
    reference iterates bottom-up over a bottom-origin buffer which equals
    top-down over a top-origin image)."""
    if stream is None:
        stream = sys.stdout
    h, w, _ = img_u8.shape
    out = [f"P3\n{w} {h}\n255\n"]
    flat = img_u8.reshape(-1, 3)
    out.extend(f"{r} {g} {b}\n" for r, g, b in flat)
    stream.write("".join(out))


def write_png(img_u8: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(img_u8).save(path)


def write_image(img_u8: np.ndarray, path: str | None) -> None:
    """path=None or '-' -> PPM on stdout (reference behavior); *.ppm -> PPM
    file; otherwise PIL by extension."""
    if path is None or path == "-":
        write_ppm(img_u8)
    elif path.endswith(".ppm"):
        with open(path, "w") as f:
            write_ppm(img_u8, f)
    else:
        write_png(img_u8, path)


def ssim(a: np.ndarray, b: np.ndarray, win: int = 8) -> float:
    """Mean structural similarity between two [H, W, 3] float images in
    [0, 1] (uniform win x win windows, standard SSIM constants).

    Used by the reference-image comparison harness (tools/compare_reference)
    to score our renders against the reference's committed renders
    (RestOfLife/assets/img/) as *structural* goldens — per-pixel equality is
    not meaningful across different RNG streams, spp and the reference's
    NN denoiser."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        a = a.mean(axis=-1)
        b = b.mean(axis=-1)
    h, w = a.shape
    hh, ww = h // win * win, w // win * win
    # non-overlapping windows: [H/win, W/win, win*win]
    blocks = (lambda x: x[:hh, :ww].reshape(hh // win, win, ww // win, win)
              .transpose(0, 2, 1, 3).reshape(hh // win, ww // win, -1))
    ab, bb = blocks(a), blocks(b)
    mu_a = ab.mean(-1)
    mu_b = bb.mean(-1)
    va = ab.var(-1)
    vb = bb.var(-1)
    cov = (ab * bb).mean(-1) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))
    return float(s.mean())
