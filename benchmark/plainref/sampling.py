"""Sampling primitives and shading math on SoA wavefronts (port of
rtw_tpu/ops/sampling.py).

One departure: torch has no `cbrt`, so `unit_ball` takes the cube root as
`x.pow(1/3)` on `x >= 1e-30 > 0` where the reference calls `jnp.cbrt`.  The
two agree to a few ulp; the CUDA kernel uses `cbrtf`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import vec as V
from .vec import Vec3

PI = float(np.float32(np.pi))
INV_PI = float(np.float32(1.0 / np.pi))
TWO_PI = float(np.float32(2.0) * np.float32(np.pi))


def safe_sqrt(x, eps=1e-20):
    return V.sqrt(torch.clamp_min(x, eps))


def power_heuristic(a, b):
    """MIS power heuristic, beta=2."""
    t = a * a
    return t / torch.clamp_min(t + b * b, 1e-20)


def build_onb(n: Vec3):
    """Orthonormal basis (u, v, w) with w = normalize(n)."""
    w = n.normalized()
    big_x = w.x.abs() > 0.9
    one = torch.ones_like(w.x)
    zero = torch.zeros_like(w.x)
    a = Vec3(torch.where(big_x, zero, one), torch.where(big_x, one, zero),
             zero)
    v = w.cross(a).normalized()
    u = w.cross(v)
    return u, v, w


def onb_local(u: Vec3, v: Vec3, w: Vec3, a: Vec3) -> Vec3:
    return u * a.x + v * a.y + w * a.z


def cosine_direction(u1, u2) -> Vec3:
    """Cosine-weighted hemisphere direction in ONB-local coords; pdf = z/pi."""
    phi = TWO_PI * u1
    sr2 = safe_sqrt(u2)
    return Vec3(torch.cos(phi) * sr2, torch.sin(phi) * sr2,
                safe_sqrt(1.0 - u2))


def unit_disk(u1, u2):
    """Polar disk sample: a = u1*2*pi, (sin a, cos a) * sqrt(u2)."""
    a = u1 * 2.0 * PI
    r = safe_sqrt(u2)
    return torch.sin(a) * r, torch.cos(a) * r


def sphere_surface(u1, u2) -> Vec3:
    """Uniform direction on the unit sphere."""
    z = 1.0 - 2.0 * u1
    r = safe_sqrt(1.0 - z * z)
    phi = TWO_PI * u2
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def unit_ball(u1, u2, u3) -> Vec3:
    """Uniform point in the unit ball; cube root as pow(1/3) (see module
    docstring)."""
    return sphere_surface(u1, u2) * torch.clamp_min(u3, 1e-30).pow(1.0 / 3.0)


def fresnel_schlick(cos_theta_i, eta_i, eta_t):
    """Schlick reflectance; m**5 multiplied as the reference's integer_pow
    lowers it, m * ((m*m)*(m*m))."""
    r0 = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r0 * r0
    m = torch.clamp(1.0 - cos_theta_i, 0.0, 1.0)
    m2 = m * m
    return r0 + (1.0 - r0) * (m * (m2 * m2))


def offset_point(point: Vec3, normal: Vec3, out_dir: Vec3, eps=1e-4) -> Vec3:
    """Scale-aware self-intersection offset along the geometric normal
    toward the side the outgoing ray leaves on."""
    scale = eps * torch.clamp_min(point.abs().max_component(), 1.0)
    side = torch.sign(normal.dot(out_dir))
    return point + normal * (scale * side)
