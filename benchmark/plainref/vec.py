"""Structure-of-arrays 3-vectors over torch tensors (port of rtw_tpu/ops/vec.py).

`Vec3` holds three `[N]` tensors, one per component, the reference's
layout: the ray axis stays the contiguous one, which is what a CUDA kernel
reading the same planes wants for coalesced loads.  Operation order is the
reference's, term by term, so float32 results round the same way.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


def sqrt(x):
    """float32 square root, correctly rounded on every device: torch's CPU
    kernel can miss by an ulp where XLA and CUDA's sqrtf round correctly,
    so the root is taken in float64 and rounded once to float32."""
    return torch.sqrt(x.double()).float()


class Vec3(NamedTuple):
    x: Any
    y: Any
    z: Any

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self):
        return self.dot(self)

    def length(self):
        return sqrt(torch.clamp_min(self.norm2(), 1e-30))

    def normalized(self) -> "Vec3":
        return self * (1.0 / self.length())

    def max_component(self):
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def abs(self) -> "Vec3":
        return Vec3(self.x.abs(), self.y.abs(), self.z.abs())

    def stack(self):
        """To an [N, 3] tensor (boundary use only)."""
        return torch.stack([self.x, self.y, self.z], dim=-1)


def v3(a) -> Vec3:
    """Vec3 from an [..., 3] tensor."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def zeros(n: int, device=None) -> Vec3:
    z = torch.zeros(n, dtype=torch.float32, device=device)
    return Vec3(z, z, z)


def ones(n: int, device=None) -> Vec3:
    o = torch.ones(n, dtype=torch.float32, device=device)
    return Vec3(o, o, o)


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """Component-wise select by a [N] bool mask."""
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror reflection; expects unit inputs."""
    return d - n * (2.0 * d.dot(n))


def gather_rows(arr, idx) -> Vec3:
    """Vec3 from rows of an [R, 3] table gathered by int [N] indices; a
    one-row table broadcasts its row."""
    if arr.shape[0] == 1:
        n = idx.shape
        return Vec3(arr[0, 0].expand(n), arr[0, 1].expand(n),
                    arr[0, 2].expand(n))
    return Vec3(arr[:, 0][idx], arr[:, 1][idx], arr[:, 2][idx])


def affine_point(m, p: Vec3) -> Vec3:
    """Apply a [3][4] affine (entries: scalars or broadcastable tensors)."""
    return Vec3(
        m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3],
        m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3],
        m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3],
    )


def affine_vec(m, v: Vec3) -> Vec3:
    return Vec3(
        m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
        m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
        m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z,
    )
