"""The one traffic generator: a closed loop of calls, each call's inputs
drawn from the run's seed.

A mix (`traffic/<name>.json`) gives the parameters:

- `call`: what each call is: `"render"` (the default, a mix without the
  key), a `render()` of the image; `"grad_step"`, a loss-and-gradient
  step and its update, whose further keys `harness/grad.py` lists (it
  takes `warmup_calls`, `max_calls`, `check` and `trace_renders` as
  below, `check.renders` judged steps with no `pixels`);
- `spp`: samples per pixel of every call;
- `options`: further `RenderConfig` fields of every call (for example
  `{"rng": "tea"}`), the same for the program and the reference;
- `warmup_calls`: calls made before the window, with the identical
  configuration, counted as set-up;
- `max_calls`: the most calls a window may hold (their pixel samples are
  drawn before the window); a window that would hold more ends there;
- `check`: `renders` calls of the window, drawn from the seed once it has
  closed, are judged, each at `pixels` pixels drawn from the seed;
- `trace_renders`: the calls that a `--trace 1` run profiles after the
  window.

Call k of a run with seed s renders with seed `call_seed(s, k)`: every call
a fresh seed, the same calls for the same s.  The configuration file gives
the scene, the image size and the depth.
"""

from __future__ import annotations

import numpy as np

SEED_BITS = 40          # a run seed up to 2^40 (seeds beyond 2^31 occur)
CALL_BITS = 20          # calls per run below 2^20
CALLS = ("render", "grad_step")


def call_kind(mix: dict) -> str:
    """The mix's `call` (`"render"` where it gives none)."""
    kind = mix.get("call", "render")
    if kind not in CALLS:
        raise ValueError(f"unknown call {kind!r} (have {CALLS})")
    return kind


def call_seed(seed: int, k: int) -> int:
    """The render seed of call k (k = 0, 1, ... counts warm-up calls
    first): distinct for distinct (seed, k), non-negative, below 2^62."""
    if seed < 0 or seed >= 1 << SEED_BITS:
        raise ValueError(f"seed {seed} outside [0, 2^{SEED_BITS})")
    if not 0 <= k < 1 << CALL_BITS:
        raise ValueError(f"call {k} outside [0, 2^{CALL_BITS})")
    return (seed << CALL_BITS) | k


def render_fields(config: dict, traffic: dict) -> dict:
    """The `RenderConfig` fields of every call of the cell (the seed is
    passed per call)."""
    return dict(nx=int(config["nx"]), ny=int(config["ny"]),
                spp=int(traffic["spp"]),
                max_depth=int(config["max_depth"]),
                scene_id=int(config["scene_id"]),
                **traffic.get("options", {}))


def pixel_samples(seed: int, n_calls: int, n_pixels: int,
                  per_call: int) -> np.ndarray:
    """int64 [n_calls, per_call]: the pixels whose values each call keeps
    for the check, uniform over the image (drawn with replacement)."""
    rng = np.random.default_rng([seed, 1])
    return rng.integers(0, n_pixels, (n_calls, per_call), dtype=np.int64)


def checked_calls(seed: int, n_done: int, n_check: int) -> list[int]:
    """Which of the window's `n_done` calls (0-based, in order) are
    judged: `n_check` of them drawn from the seed, the last one among
    them."""
    if n_done <= 0:
        return []
    rng = np.random.default_rng([seed, 2])
    rest = rng.permutation(n_done - 1)[:max(0, n_check - 1)]
    return sorted({n_done - 1, *(int(i) for i in rest)})
