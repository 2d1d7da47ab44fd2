"""Random-number discipline (port of rtw_tpu/utils/rng.py, fast path).

Device side: the stateless pcg_hash streams keyed by (seed, pixel, sample,
bounce, slot), bit for bit the reference's, so a port render draws the same
samples as a reference render.  torch on the CPU has no uint32 shifts, so
the hash works on int64 tensors holding uint32 values, masked with
`& 0xFFFFFFFF` where the reference's uint32 arithmetic wraps; every product
stays below 2^63.  The CUDA kernel (csrc/mega_kernel.cu) computes the same
hash in native uint32.

The reference keys the hash on `jax.random.key_data(key(seed))`, which is
`(seed >> 32, seed & 0xFFFFFFFF)`: `path_hash_base` takes that pair.

Host side: the reference scene RNG `XorShift32`, bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch

U_SCATTER_0 = 0        # material scatter draw 1
U_SCATTER_1 = 1        # material scatter draw 2
U_SCATTER_2 = 2        # material scatter draw 3 (unit-ball radius)
U_DIELECTRIC = 3       # reflect-vs-refract proposal
U_LIGHT_SELECT = 4     # uniform light index
U_LIGHT_A = 5          # point-on-light u
U_LIGHT_B = 6          # point-on-light v
U_RR = 7               # russian roulette
NUM_FIXED_SLOTS = 8

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9                           # 2^32 / phi
CAM_OFF = (0x0CA4 * 0x9E3779B9) & MASK32      # camera-draw stream offset

_IMPL_TODO = {"tea": "ROADMAP item 11 (rng='tea')",
              "threefry": "ROADMAP item 11 (rng='threefry')"}


def check_impl(impl: str) -> None:
    """Raise for RNG implementations the port does not have yet."""
    if impl == "fast":
        return
    if impl in _IMPL_TODO:
        raise NotImplementedError(
            f"rng={impl!r} is not ported yet: {_IMPL_TODO[impl]}")
    raise ValueError(f"unknown rng impl {impl!r}")


def pcg_hash(x):
    """pcg_hash on an int64 tensor of uint32 values (result < 2^32)."""
    x = x & MASK32
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def to_unit(bits):
    """uint32 (in int64) -> float32 in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * float(np.float32(1.0 / (1 << 24)))


def path_hash_base(seed: int) -> int:
    """h0 = pcg(kd[0] + pcg(kd[-1])) with kd = key_data(key(seed))."""
    if seed < 0:
        raise ValueError("seed must be non-negative")
    kd0, kd1 = (seed >> 32) & MASK32, seed & MASK32
    inner = pcg_hash(torch.tensor(kd1, dtype=torch.int64))
    return int(pcg_hash(inner + kd0))


def pixel_sample_hash(seed: int, pixel_idx, sample_idx):
    """Per-path hash state (int64 [N] of uint32 values)."""
    h0 = path_hash_base(seed)
    if not torch.is_tensor(sample_idx):
        sample_idx = torch.tensor(sample_idx, dtype=torch.int64,
                                  device=pixel_idx.device)
    h1 = pcg_hash(sample_idx.to(torch.int64) + h0)
    return pcg_hash(h1 + pixel_idx.to(torch.int64))


def make_path_keys(seed: int, pixel_idx, sample_idx, impl: str = "fast"):
    check_impl(impl)
    return pixel_sample_hash(seed, pixel_idx, sample_idx)


def _slot_rows(h, n_slots: int):
    """Uniform k of stream h for k < n_slots, as one [n_slots, N] batch:
    to_unit(pcg(pcg(h + k + 1)))."""
    k = torch.arange(1, n_slots + 1, device=h.device).reshape(-1, 1)
    return to_unit(pcg_hash(pcg_hash(h + k)))


def bounce_uniforms(path_keys, bounce, n_slots: int, impl: str = "fast"):
    """The per-bounce uniform block: float32 [n_slots, N] in [0, 1).
    `bounce` is a scalar or a per-lane [N] tensor."""
    check_impl(impl)
    if torch.is_tensor(bounce):
        bounce = bounce.to(torch.int64)
    hb = pcg_hash(path_keys + ((bounce * GOLDEN) & MASK32))
    return _slot_rows(hb, n_slots)


def camera_uniforms(path_keys, impl: str = "fast"):
    """Draws consumed before the bounce loop: jitter s,t; lens u1,u2; time.
    Returns float32 [5, N]."""
    check_impl(impl)
    hc = pcg_hash(path_keys + CAM_OFF)
    return _slot_rows(hc, 5)


class XorShift32:
    """Reference host RNG: xorshift32 + float mapping of lib/random.cuh:22-38."""

    def __init__(self, seed: int):
        if seed == 0:
            raise ValueError("xorshift32 state must be nonzero")
        self.state = np.uint32(seed)

    def next_u32(self) -> int:
        s = int(self.state)
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        self.state = np.uint32(s)
        return s

    def randf(self) -> float:
        # float32(u32)/2^32 can round to 1.0; the reference then returns the
        # int 0x3F7FFFFF converted to float (random.cuh:34-37), reproduced.
        u = self.next_u32()
        rnd = np.float32(np.float32(u) / np.float32(4294967296.0))
        if rnd != np.float32(1.0):
            return float(rnd)
        return float(0x3F7FFFFF)
