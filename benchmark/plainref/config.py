"""Render configuration (the port's copy of `rtw_tpu.utils.config`).

Copied, not imported: importing anything under `rtw_tpu` runs its package
`__init__`, which imports JAX, and the port must run where JAX is absent.
Fields, defaults and checks are the reference's, so one config value means
the same render in both packages.  The reference file carries the history
of each option.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of one render (hashable, like the reference's)."""

    nx: int = 1200                # image width
    ny: int = 600                 # image height
    spp: int = 20                 # samples per pixel
    max_depth: int = 20           # bounce limit
    seed: int = 0                 # RNG stream seed
    scene_id: int = 4             # default scene

    # Estimator switches -----------------------------------------------------
    # True: BSDF-sampled rays that hit a light are MIS-weighted (unbiased);
    # False: reference parity (only the NEE side carries the MIS weight).
    mis_bsdf_weight: bool = True
    # "mis": NEE shadow rays + power-heuristic MIS; "book": the books'
    # 0.5/0.5 cosine/light mixture (regen and the queue only: outside the
    # megakernel's envelope).
    estimator: str = "mis"
    rr_start_depth: int = 2       # Russian roulette start depth

    # Execution shape --------------------------------------------------------
    ray_batch: int = 0            # pixels per wavefront batch; 0 = whole image
    spp_chunk: int = 0            # samples per step; 0 = auto

    # "auto" | "mega" | "jnp" | "pallas".  On a CUDA scene "auto" selects the
    # hand-written megakernel (ops/mega_kernel.py) below 128 prims and the
    # split-tier trace and occlusion kernels (ops/trace_kernel.py, forced by
    # "pallas") from 128 prims up; "jnp" is the plain torch path.
    backend: str = "auto"

    # Image-texture filtering: "stoch565" | "rgb565" | "nearest565" | "rgb8".
    tex_filter: str = "stoch565"
    tex_tile_gate: bool = True    # a TPU mechanism; accepted as a no-op

    # "auto" | "regen" | "mega" | "queue" | "qmega" (qmega: ROADMAP queue 2
    # item D).
    scheduler: str = "auto"
    flush_denom: int = 2          # queue scheduler flush policy
    # The reference's arithmetic pixel decode (a TPU mechanism: Mosaic has
    # no per-lane gather); accepted as a no-op, the queue gathers.
    pixel_layout: str = "generic"

    # "fast" (pcg_hash) | "tea" | "threefry", each bit-exact with the
    # reference (utils/rng.py); only "fast" runs in the megakernel.
    rng: str = "fast"

    # Wavefront counters (regen and the queue; render's metrics).
    bounce_stats: bool = False
    occupancy_trace: bool = False

    # Differentiability: trace_paths runs exactly max_depth bounces for
    # autograd, the split kernels pick winners without gradients (diff.py);
    # remat checkpoints each bounce.  A render with it takes regen or the
    # queue, never the megakernel.
    differentiable: bool = False
    remat: bool = True

    # Misc -------------------------------------------------------------------
    gamma: float = 2.0            # output gamma
    t_min: float = 1e-6           # ray epsilon
    t_max: float = 1e27           # effectively RT_DEFAULT_MAX
    shadow_eps: float = 5.0e-5    # occlusion ray epsilon

    def __post_init__(self):
        if self.nx <= 0 or self.ny <= 0:
            raise ValueError(f"bad image size {self.nx}x{self.ny}")
        if self.spp <= 0:
            raise ValueError("spp must be positive")
        if self.max_depth <= 0:
            raise ValueError("max_depth must be positive")

    @property
    def num_pixels(self) -> int:
        return self.nx * self.ny

    def resolved_ray_batch(self) -> int:
        n = self.ray_batch
        if n <= 0 or n > self.num_pixels:
            return self.num_pixels
        return n

    def resolved_spp_chunk(self, checkpointing: bool = True) -> int:
        if self.spp_chunk > 0:
            return min(self.spp_chunk, self.spp)
        # auto: the whole request in one chunk unless a checkpoint needs the
        # step to be interruptible (then ~256M paths per step); the same rule
        # as the reference, so chunk boundaries (and sums) agree.
        batch = max(1, self.resolved_ray_batch())
        if checkpointing:
            per = max(1, 256_000_000 // batch)
        else:
            per = max(1, 2_000_000_000 // batch)
        return min(per, self.spp)
