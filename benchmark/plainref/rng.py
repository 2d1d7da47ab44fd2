"""Random-number discipline (port of rtw_tpu/utils/rng.py).

Device side: three streams keyed by (seed, pixel, sample, bounce, slot),
each bit for bit the reference's, so a port render draws the same samples
as a reference render of the same `cfg.rng`:

- "fast": the stateless pcg_hash chain.  The CUDA megakernel
  (csrc/mega_kernel.cu) computes it in native uint32; it is the only
  stream the megakernel draws.
- "tea": the reference's tea<16> path state, a tea<8> substream per
  bounce, then sequential LCG draws, one per slot.
- "threefry": jax.random's threefry2x32 `fold_in` / `uniform`, with the
  bit layout of jax 0.9.0 under `jax_threefry_partitionable=True`
  (`threefry_bits`).  Its path keys are a key pair per lane, int64 [2, N].

torch on the CPU has no uint32 shifts, so every stream works on int64
tensors holding uint32 values, masked with `& 0xFFFFFFFF` where the
reference's uint32 arithmetic wraps; every product stays below 2^63.

The reference keys its streams on `jax.random.key_data(key(seed))`, which
is `(seed >> 32, seed & 0xFFFFFFFF)`: `key_data` returns that pair.

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

IMPLS = ("fast", "tea", "threefry")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown rng impl {impl!r}")


def key_data(seed: int) -> tuple[int, int]:
    """`jax.random.key_data(jax.random.key(seed))`: (high, low) words."""
    if seed < 0:
        raise ValueError("seed must be non-negative")
    return (seed >> 32) & MASK32, seed & MASK32


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
    kd0, kd1 = key_data(seed)
    inner = pcg_hash(torch.tensor(kd1, dtype=torch.int64))
    return int(pcg_hash(inner + kd0))


def _as_index(x, device):
    """A scalar or tensor index as an int64 tensor."""
    if torch.is_tensor(x):
        return x.to(torch.int64)
    return torch.tensor(x, dtype=torch.int64, device=device)


def pixel_sample_hash(seed: int, pixel_idx, sample_idx):
    """Per-path hash state (int64 [N] of uint32 values)."""
    h0 = path_hash_base(seed)
    h1 = pcg_hash(_as_index(sample_idx, pixel_idx.device) + h0)
    return pcg_hash(h1 + pixel_idx.to(torch.int64))


# ---------------------------------------------------------------------------
# "tea": the OptiX SDK's tea<N> and LCG (the reference's generator family)
# ---------------------------------------------------------------------------

def tea(v0, v1, rounds: int = 16):
    """Tiny Encryption Algorithm hash of two uint32 words (tea<rounds>);
    `v1` is a tensor or an int, broadcast against `v0`."""
    v0 = v0 & MASK32
    v1 = (v1 & MASK32) + torch.zeros_like(v0)
    s = 0
    for _ in range(rounds):
        s = (s + GOLDEN) & MASK32
        v0 = (v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + s)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & MASK32
        v1 = (v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + s)
                    ^ ((v0 >> 5) + 0x7E95761E))) & MASK32
    return v0


def _lcg_draws(state, k: int):
    """k sequential LCG draws (state = 1664525 * state + 1013904223; value:
    the low 24 bits / 2^24), float32 [k, N]."""
    rows = []
    for _ in range(k):
        state = (state * 1664525 + 1013904223) & MASK32
        rows.append((state & 0x00FFFFFF).to(torch.float32)
                    * float(np.float32(1.0 / 16777216.0)))
    return torch.stack(rows)


def _tea_path_state(seed: int, pixel_idx, sample_idx):
    """tea<16>(pixel, sample + key_data[0]).  The reference adds the HIGH
    word of the key (`key_data(key)[0]`), which is 0 for every seed below
    2^32: all such seeds draw the same tea stream.  A property of the
    reference, reproduced bit for bit."""
    s = _as_index(sample_idx, pixel_idx.device) + key_data(seed)[0]
    return tea(pixel_idx.to(torch.int64), s)


# ---------------------------------------------------------------------------
# "threefry": jax.random's threefry2x32 (jax 0.9.0,
# jax_threefry_partitionable=True)
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds: the key (k0, k1) applied to the counter
    pair (x0, x1); every argument a tensor or an int, broadcast together.
    Returns the output pair."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def fold_in(keys, data):
    """`jax.random.fold_in`: threefry2x32(key, (0, data)).  `keys` is int64
    [2, ...] (the key pair on the first axis); returns the same layout."""
    x0, x1 = threefry2x32(keys[0], keys[1], 0, data & MASK32)
    return torch.stack(torch.broadcast_tensors(x0, x1))


def threefry_bits(keys, n: int):
    """`jax.random.bits(key, (n,))` per key of `keys` (int64 [2, N]):
    draw i is x0 ^ x1 of threefry2x32(key, (0, i)), so it does not depend
    on n.  Returns int64 [n, N] of uint32 values."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(-1, 1)
    x0, x1 = threefry2x32(keys[0], keys[1], 0, i)
    return x0 ^ x1


def bits_to_unit(bits):
    """`jax.random.uniform`'s float step: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def _threefry_path_keys(seed: int, pixel_idx, sample_idx):
    """fold_in(fold_in(key(seed), sample), pixel): int64 [2, N]."""
    kd = torch.tensor(key_data(seed), dtype=torch.int64,
                      device=pixel_idx.device).reshape(2, 1)
    k = fold_in(kd, _as_index(sample_idx, pixel_idx.device))
    return fold_in(k, pixel_idx.to(torch.int64))


# ---------------------------------------------------------------------------
# The streams' interface
# ---------------------------------------------------------------------------

def make_path_keys(seed: int, pixel_idx, sample_idx, impl: str = "fast"):
    """Per-path RNG state: an int64 [N] hash plane ("fast", "tea") or the
    threefry key pairs, int64 [2, N].  `sample_idx`: a scalar or [N]."""
    _check_impl(impl)
    if impl == "tea":
        return _tea_path_state(seed, pixel_idx, sample_idx)
    if impl == "threefry":
        return _threefry_path_keys(seed, pixel_idx, sample_idx)
    return pixel_sample_hash(seed, pixel_idx, sample_idx)


def _slot_rows(h, n_slots: int):
    """Uniform k of stream h for k < n_slots, as one [n_slots, N] batch:
    to_unit(pcg(pcg(h + k + 1)))."""
    k = torch.arange(1, n_slots + 1, device=h.device).reshape(-1, 1)
    return to_unit(pcg_hash(pcg_hash(h + k)))


def bounce_uniforms(path_keys, bounce, n_slots: int, impl: str = "fast"):
    """The per-bounce uniform block: float32 [n_slots, N] in [0, 1).
    `bounce` is a scalar or a per-lane [N] tensor."""
    _check_impl(impl)
    if torch.is_tensor(bounce):
        bounce = bounce.to(torch.int64)
    if impl == "tea":
        # the caller passes bounce + 1 already; the reference's substream
        # adds 1 again
        return _lcg_draws(tea(path_keys, bounce + 1, rounds=8), n_slots)
    if impl == "threefry":
        return bits_to_unit(threefry_bits(fold_in(path_keys, bounce),
                                          n_slots))
    hb = pcg_hash(path_keys + ((bounce * GOLDEN) & MASK32))
    return _slot_rows(hb, n_slots)


def camera_uniforms(path_keys, impl: str = "fast"):
    """Draws consumed before the bounce loop: jitter s,t; lens u1,u2; time.
    Returns float32 [5, N]."""
    _check_impl(impl)
    if impl == "tea":
        return _lcg_draws(path_keys, 5)
    if impl == "threefry":
        return bits_to_unit(threefry_bits(fold_in(path_keys, 0x0CA4), 5))
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
