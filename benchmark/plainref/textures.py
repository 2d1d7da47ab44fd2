"""Procedural and image textures (port of rtw_tpu/ops/textures.py).

Plain torch: in the reference these run outside every Pallas kernel too.
Hash-gradient Perlin noise and 7-octave turbulence, and the four fetches
from the packed image atlas (`Textures.images_packed`, 0x00BBGGRR texels,
and `Textures.images_packed565`, RGB565 pairs).  torch has no uint32
shifts on the CPU, so the atlas words are read through an int32 view and
unpacked as int64, and the lattice hash runs on int64 holding uint32
values, as utils/rng.py does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scene as S
from .vec import Vec3
from .rng import MASK32, pcg_hash, to_unit


def _lattice_gradient(ix, iy, iz) -> Vec3:
    """Unit gradient at an integer lattice point from chained pcg_hash (the
    reference's hash lattice; `pcg_hash` wraps negative ids to uint32)."""
    h = pcg_hash(ix + pcg_hash(iy + pcg_hash(iz)))
    gx = to_unit(h) * 2.0 - 1.0
    gy = to_unit(pcg_hash(h + 1)) * 2.0 - 1.0
    gz = to_unit(pcg_hash(h + 2)) * 2.0 - 1.0
    inv = torch.rsqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    return Vec3(gx * inv, gy * inv, gz * inv)


# lattice corners in the reference's loop order (di outer, dk inner)
_CORNERS = [(di, dj, dk) for di in range(2) for dj in range(2)
            for dk in range(2)]


def perlin_noise(tex: S.Textures, p: Vec3):
    """Trilinear gradient Perlin noise of planes of any shape; `tex` is
    accepted for the reference's signature (the gradients are hashed, not
    tabled).  The eight corners are computed as one [8, ...] batch, each
    element as the reference computes it, and summed in the reference's
    corner order."""
    del tex
    fx, fy, fz = torch.floor(p.x), torch.floor(p.y), torch.floor(p.z)
    ux, uy, uz = p.x - fx, p.y - fy, p.z - fz
    i, j, k = (f.to(torch.int64) for f in (fx, fy, fz))

    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)

    corner = torch.tensor(_CORNERS, device=p.x.device).T.reshape(
        (3, 8) + (1,) * p.x.dim())
    di, dj, dk = corner
    g = _lattice_gradient(i + di, j + dj, k + dk)
    wx = torch.where(di == 1, sx, 1.0 - sx)
    wy = torch.where(dj == 1, sy, 1.0 - sy)
    wz = torch.where(dk == 1, sz, 1.0 - sz)
    dot = g.x * (ux - di) + g.y * (uy - dj) + g.z * (uz - dk)
    terms = (wx * wy * wz) * dot
    accum = torch.zeros_like(p.x)
    for term in terms:
        accum = accum + term
    return accum


def turbulence(tex: S.Textures, p: Vec3, octaves: int = 7):
    """|sum of `octaves` octaves of Perlin noise|, halving the weight and
    doubling the frequency each octave.  The octaves are one batch: p * 2^o
    is exact, as the reference's repeated doubling is."""
    freq = torch.tensor([2.0 ** o for o in range(octaves)],
                        device=p.x.device).reshape((octaves,)
                                                   + (1,) * p.x.dim())
    noise = perlin_noise(tex, p * freq)
    accum = torch.zeros_like(p.x)
    weight = 1.0
    for o in range(octaves):
        accum = accum + weight * noise[o]
        weight *= 0.5
    return accum.abs()


def _image_geometry(tex: S.Textures, image_id):
    """Per-lane (h, w, offset) of each lane's image, int64."""
    dims = tex.image_dims.to(torch.int64)
    off = tex.image_offset.to(torch.int64)
    idx = image_id.to(torch.int64)
    return dims[:, 0][idx], dims[:, 1][idx], off[idx]


def _texels(packed, idx):
    """uint32 atlas words at int64 flat indices, as int64."""
    return packed.view(torch.int32)[idx].to(torch.int64) & MASK32


def _clamp(x, lo: int, hi):
    """Clamp an int64 plane to [lo, hi] with a per-lane upper bound."""
    return torch.minimum(torch.clamp_min(x, lo), hi)


_INV255 = float(np.float32(1.0 / 255.0))
_INV31 = float(np.float32(1.0 / 31.0))
_INV63 = float(np.float32(1.0 / 63.0))


def _unpack565(half) -> Vec3:
    return Vec3(((half >> 11) & 31).to(torch.float32) * _INV31,
                ((half >> 5) & 63).to(torch.float32) * _INV63,
                (half & 31).to(torch.float32) * _INV31)


def _image_bilinear(tex: S.Textures, image_id, u, v) -> Vec3:
    """Normalized-coordinate bilinear fetch from the RGB8 atlas with clamp
    addressing: four texels per lane."""
    h_i, w_i, off = _image_geometry(tex, image_id)
    x = u * w_i.to(torch.float32) - 0.5
    y = v * h_i.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def fetch(xi, yi) -> Vec3:
        xi = _clamp(xi, 0, w_i - 1)
        yi = _clamp(yi, 0, h_i - 1)
        bits = _texels(tex.images_packed, off + yi * w_i + xi)
        return Vec3((bits & 0xFF).to(torch.float32) * _INV255,
                    ((bits >> 8) & 0xFF).to(torch.float32) * _INV255,
                    ((bits >> 16) & 0xFF).to(torch.float32) * _INV255)

    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    c00 = fetch(x0i, y0i)
    c10 = fetch(x0i + 1, y0i)
    c01 = fetch(x0i, y0i + 1)
    c11 = fetch(x0i + 1, y0i + 1)
    cx0 = c00 + (c10 - c00) * fx
    cx1 = c01 + (c11 - c01) * fx
    return cx0 + (cx1 - cx0) * fy


def _fetch565_coords(tex: S.Textures, image_id, u, v):
    """(h, w, offset, x blend, y blend, clamped x0, y0 int) of the RGB565
    pair fetches: left of column 0 both taps are texel 0, so the x blend
    weight is zeroed there."""
    h_i, w_i, off = _image_geometry(tex, image_id)
    x = u * w_i.to(torch.float32) - 0.5
    y = v * h_i.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.where(x0 < 0.0, 0.0, x - x0)
    fy = y - y0
    x0i = _clamp(x0.to(torch.int64), 0, w_i - 1)
    return h_i, w_i, off, fx, fy, x0i, y0.to(torch.int64)


def _image_bilinear_565(tex: S.Textures, image_id, u, v) -> Vec3:
    """Bilinear fetch from the RGB565 pair atlas: two words per lane (rows
    y0 and y0+1; each word holds texels x0 and x0+1)."""
    h_i, w_i, off, fx, fy, x0i, y0i = _fetch565_coords(tex, image_id, u, v)

    def fetch_pair(yi):
        yi = _clamp(yi, 0, h_i - 1)
        bits = _texels(tex.images_packed565, off + yi * w_i + x0i)
        return _unpack565(bits & 0xFFFF), _unpack565(bits >> 16)

    c00, c10 = fetch_pair(y0i)
    c01, c11 = fetch_pair(y0i + 1)
    cx0 = c00 + (c10 - c00) * fx
    cx1 = c01 + (c11 - c01) * fx
    return cx0 + (cx1 - cx0) * fy


def _image_stoch_565(tex: S.Textures, image_id, u, v, xi) -> Vec3:
    """Stochastic bilinear fetch from the RGB565 pair atlas: one word per
    lane, its row y0 or y0+1 drawn by the bilinear weight with the lane's
    own uniform `xi`, so E[fetch] is the `_image_bilinear_565` value."""
    h_i, w_i, off, fx, fy, x0i, y0i = _fetch565_coords(tex, image_id, u, v)
    yi = _clamp(y0i + (xi < fy).to(torch.int64), 0, h_i - 1)
    bits = _texels(tex.images_packed565, off + yi * w_i + x0i)
    c0 = _unpack565(bits & 0xFFFF)
    c1 = _unpack565(bits >> 16)
    return c0 + (c1 - c0) * fx


def _image_nearest_565(tex: S.Textures, image_id, u, v) -> Vec3:
    """Nearest-texel fetch from the RGB565 pair atlas (the low word of the
    pair is texel xi)."""
    h_i, w_i, off = _image_geometry(tex, image_id)
    xi = _clamp((u * w_i.to(torch.float32)).to(torch.int64), 0, w_i - 1)
    yi = _clamp((v * h_i.to(torch.float32)).to(torch.int64), 0, h_i - 1)
    bits = _texels(tex.images_packed565, off + yi * w_i + xi)
    return _unpack565(bits & 0xFFFF)
