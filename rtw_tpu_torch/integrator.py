"""Wavefront path-tracing integrator (port of rtw_tpu/integrator.py).

Four executors of the same estimator, all drawing the reference's sample
streams (so all trace the same paths): regen and the queue draw any
`cfg.rng` and run either `cfg.estimator`; the two megakernel executors
draw the fast chain and run NEE + MIS:

- `trace_wavefront_regen`: each lane owns one pixel and regenerates its
  next sample when its path ends; every bounce is `bounce_step`.
- `trace_wavefront_queue`: the split tier's global work queue: a lane that
  finishes claims the next unclaimed (pixel, sample) item.  `bounce_step`
  runs the bounce as the split tier's kernels when `_split_backend` holds
  (a CUDA scene of 128 or more prims): the trace kernel B, the shading
  kernel E, the occlusion kernel C and the finishing kernel F
  (ops/trace_kernel, ops/shade_kernel).
- `trace_wavefront_mega`: `mega_kernel.mega_trace`, the whole pixel batch
  and spp chunk in one launch of the hand-written persistent CUDA
  megakernel on a CUDA scene (its plain twin on a CPU scene).
- `trace_wavefront_qmega` (`scheduler="qmega"`, opt-in): the work queue
  with the whole bounce in one launch of the megakernel's hybrid mode.

`trace_wavefront` dispatches: `scheduler="auto"` on a CUDA scene picks the
megakernel below 128 prims when the scene is inside its envelope, the
plain regen sweep below 128 prims when it is not (the reference's jnp
sweep there), and the queue with the split kernels at 128 prims and
above, as the reference does on its TPU; a CPU scene runs the plain regen
path.  A render outside the megakernel's envelope (`_mega_problems`:
`rng` other than "fast", `estimator="book"`, `bounce_stats`,
`differentiable`, or the scene) never takes it: "auto" picks regen or the
queue, and a forced megakernel raises ValueError, as the reference's gate
does.  Nothing falls back silently to the plain path on the card in place
of a kernel.

Gradients (`cfg.differentiable`): `trace_paths` traces one sample per
pixel through exactly `cfg.max_depth` bounces, for torch autograd
(diff.py).  On the split tier `bounce_step` takes each ray's winner from
kernel B, run under torch.no_grad() on detached inputs (E and F have no
backward: the shading stays torch, for autograd), and
`intersect.reeval_hit` recomputes that winner's t and payload with
gradients; kernel C's visibility is a detached bool.  Below the split tier
autograd differentiates the plain sweep itself.  Neither kernel is ever
differentiated: the winner and the visibility are piecewise-constant
decisions, as in the reference.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from rtw_tpu_torch.models import scene as S
from rtw_tpu_torch.ops import sampling as sm
from rtw_tpu_torch.ops import vec as V
from rtw_tpu_torch.ops.vec import Vec3
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.ops import intersect as I
from rtw_tpu_torch.ops import shade_kernel as SK
from rtw_tpu_torch.ops.bounce import (BounceEnv, PathState, bounce_core,
                                      scene_env)
from rtw_tpu_torch.ops.intersect import BIG, fma
from rtw_tpu_torch.ops.shading import gather_shade, resolve_albedo, tex_row
from rtw_tpu_torch.utils import profiling as P
from rtw_tpu_torch.utils import rng as R

# Scenes at or above this many prims run the split-tier kernels (the
# reference's integrator._pallas_backend); the megakernel's auto envelope
# stops below it.
SPLIT_TIER_PRIMS = 128

# The card's loops (trace_wavefront_queue, _qmega) read their
# termination test once per this many iterations: each read is a host sync,
# and an iteration past the end is exact (it changes nothing a result
# reads; the counters mask it).
_CHECK_EVERY = 8


def _check_every(device) -> int:
    """Iterations per termination read: `_CHECK_EVERY` on the card, 1 on
    the CPU, where a read costs nothing."""
    return _CHECK_EVERY if device.type == "cuda" else 1


def generate_camera_rays(scene: S.Scene, cfg, pixel_idx, path_keys) -> PathState:
    """Thin-lens primary rays."""
    cam = scene.camera
    u = R.camera_uniforms(path_keys, cfg.rng)          # [5, N]
    sx = (pixel_idx % cfg.nx).to(torch.float32) + u[0]
    sy = (pixel_idx // cfg.nx).to(torch.float32) + u[1]

    rdx, rdy = sm.unit_disk(u[2], u[3])
    rdx = cam.lens_radius * rdx
    rdy = cam.lens_radius * rdy
    origin = V.v3(cam.origin) + V.v3(cam.u) * rdx + V.v3(cam.v) * rdy
    # lower_left + horizontal * (sx / nx) + vertical * (sy / ny) - origin,
    # rounded as the reference's compiled CPU code rounds it: the division
    # by the image size becomes a product with the f32 reciprocal, folded
    # into the camera vector, and the two products are fused into the sums
    inv_nx = float(np.float32(1.0 / cfg.nx))
    inv_ny = float(np.float32(1.0 / cfg.ny))
    direction = Vec3(*(
        fma(sy, vv * inv_ny, fma(sx, hh * inv_nx, ll)) - oo
        for ll, hh, vv, oo in zip(V.v3(cam.lower_left), V.v3(cam.horizontal),
                                  V.v3(cam.vertical), origin)))
    time = cam.time0 + u[4] * (cam.time1 - cam.time0)

    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    return PathState(
        origin=origin,
        direction=direction,
        throughput=V.ones(n, dev),
        radiance=V.zeros(n, dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        time=time,
        prev_pdf=torch.ones(n, dtype=torch.float32, device=dev),
        prev_diffuse=torch.zeros(n, dtype=torch.bool, device=dev),
    )


# The split tier's modes of `bounce_step`: "kernels" runs the bounce as
# kernels B, E, C and F (`TK.trace_rows`, `SK.shade`, `TK.occluded_kernel`,
# `SK.finish`; their plain versions on CPU tensors), nothing in torch
# between them but the uniform draw; a gradient render keeps B and C with
# the torch glue there, as "glue" does.  "glue" runs B and C with the
# shading in plain torch between them (the path before E and F, kept for
# timing the two in turns); "plain" runs the plain versions of B and C on
# any device (`TK.trace_plain`, `TK.occluded_plain`): the twin the card's
# gradient path is held against, and that path on the CPU.
SPLIT_MODES = ("kernels", "glue", "plain")


def _split_mode(cfg, scene, split):
    """The split tier's mode of a bounce: `split` if given (one of
    SPLIT_MODES), else "kernels" where `_split_backend` holds and None (the
    plain sweep, no split tier) where it does not."""
    if split is None:
        return "kernels" if _split_backend(cfg, scene) else None
    if split not in SPLIT_MODES:
        raise ValueError(f"unknown split mode {split!r}")
    return split


def _split_tables(cfg, scene: S.Scene):
    """The split kernels' tables.  A gradient render builds them without
    gradients: the kernels only pick winners and visibility there, so the
    scene's tensors may require grad."""
    if cfg.differentiable:
        with torch.no_grad():
            return TK.split_tables(scene)
    return TK.split_tables(scene)


def _detached(*args):
    """The arguments with every tensor and Vec3 detached."""
    return tuple(Vec3(*(c.detach() for c in a)) if isinstance(a, Vec3)
                 else a.detach() if torch.is_tensor(a) else a for a in args)


def _split_query(kernel, plain, mode, scene, tables, cfg, *args):
    """One split-tier query: `kernel` (with the tables) in modes "kernels"
    and "glue", its `plain` version in mode "plain".  A gradient render
    runs it under torch.no_grad() on detached inputs (the reference's
    stop_gradient): its answer is a detached decision."""
    def run(*a):
        return kernel(scene, *a, tables) if mode != "plain" else plain(
            scene, *a)
    if not cfg.differentiable:
        return run(*args)
    with torch.no_grad():
        return run(*_detached(*args))


def _occlude(scene: S.Scene, cfg, mode, tables, time, occ_u,
             shadow_org, ldir_u, occ_tmax, want):
    """BounceEnv.occlude: the shadow query through the split tier's `mode`
    (None: the plain sweep), with `occ_u`, the volumes' shadow-ray
    free-flight uniforms.  `want` is implied by occ_tmax (-BIG on lanes
    that do not want the query).  The visibility is a bool: it carries no
    gradient."""
    del want
    args = (shadow_org, ldir_u, cfg.shadow_eps, occ_tmax, time, occ_u)
    if mode is None:
        return TK.occluded_plain(scene, *args)
    return _split_query(TK.occluded_kernel, TK.occluded_plain, mode, scene,
                        tables, cfg, *args)


def bounce_env(scene: S.Scene, cfg, time, occ_u, mode=None,
               tables=None) -> BounceEnv:
    """The BounceEnv of `bounce_step` (and of the megakernel's plain twin):
    `time` and `occ_u` are bound into the occlusion query, which goes
    through the split tier in `mode` (None: the plain sweep)."""
    return scene_env(scene, cfg, functools.partial(
        _occlude, scene, cfg, mode, tables, time, occ_u))


def _shade_mode(cfg, mode) -> bool:
    """Whether a bounce in split mode `mode` runs kernels E and F: mode
    "kernels" outside the gradient path (E has no backward)."""
    return mode == "kernels" and not cfg.differentiable


def bounce_step(scene: S.Scene, cfg, path_keys, state: PathState, bounce,
                tables=None, split=None, shade_tables=None):
    """One wavefront bounce: trace, shade, NEE, RR.  Returns
    (new state, [N] int32 rays traced per lane).  `tables`: the scene's
    split-kernel tables (`_split_tables`), built once per render by the
    caller; built here when None.  `split`: the split tier's mode
    (`_split_mode`; None: chosen by `_split_backend`).  `shade_tables`:
    E's tables (`SK.shade_tables`) where the mode runs E, likewise."""
    mode = _split_mode(cfg, scene, split)
    if mode and tables is None:
        tables = _split_tables(cfg, scene)
    nv = max(scene.n_vol, 1)
    row = tex_row(scene, cfg)
    n_slots = R.NUM_FIXED_SLOTS + 2 * nv + (1 if row >= 0 else 0)
    with P.span("bounce.draw"):
        U = R.bounce_uniforms(path_keys, bounce + 1, n_slots, cfg.rng)
    vol_u = U[R.NUM_FIXED_SLOTS: R.NUM_FIXED_SLOTS + nv]
    occ_u = U[R.NUM_FIXED_SLOTS + nv: R.NUM_FIXED_SLOTS + 2 * nv]
    tex_u = U[row] if row >= 0 else None

    o, d = state.origin, state.direction
    # dead lanes get tmax = -BIG: a forced miss, masked by alive below
    tmax_lane = torch.where(state.alive, float(np.float32(cfg.t_max)), -BIG)
    if _shade_mode(cfg, mode):
        of, oi = TK.trace_rows(scene, o, d, cfg.t_min, tmax_lane, state.time,
                               vol_u, tables)
        out = SK.shade(scene, cfg, shade_tables, of, oi, state, bounce, U)
        radiance = out.radiance
        if out.nee is not None:
            occluded = TK.occluded_kernel(
                scene, out.shadow_org, out.shadow_dir, cfg.shadow_eps,
                out.shadow_tmax, state.time, occ_u, tables)
            radiance = SK.finish(radiance, out.nee, out.shadow_tmax,
                                 occluded)
        return PathState(origin=out.origin, direction=out.direction,
                         throughput=out.throughput, radiance=radiance,
                         alive=out.alive, time=state.time,
                         prev_pdf=out.prev_pdf,
                         prev_diffuse=out.prev_diffuse), out.rays_lane
    if mode:
        hit, shade = _split_query(TK.trace, TK.trace_plain, mode, scene,
                                  tables, cfg, o, d, cfg.t_min, tmax_lane,
                                  state.time, vol_u)
        if cfg.differentiable:
            # the kernel's winner is a detached decision: its t and payload
            # are recomputed with gradients, and the shading record is
            # gathered from the live scene so texture-colour gradients flow
            # (the kernel's record holds colours copied into its tables)
            hit = I.reeval_hit(scene, hit.prim_idx, o, d, cfg.t_min,
                               cfg.t_max, state.time, vol_u, t_hint=hit.t)
            shade = gather_shade(scene, hit.prim_idx, hit.prim_idx >= 0)
    else:
        hit, shade = TK.trace_plain(scene, o, d, cfg.t_min, tmax_lane,
                                    state.time, vol_u)
    albedo = resolve_albedo(scene, shade, hit.point, hit.u, hit.v,
                            cfg.tex_filter, cfg.tex_tile_gate, tex_u)

    env = bounce_env(scene, cfg, state.time, occ_u, mode, tables)
    res = bounce_core(env, U, bounce, state.alive, o, d, state.time,
                      state.throughput, state.radiance, state.prev_pdf,
                      state.prev_diffuse, hit.prim_idx < 0, hit.point,
                      hit.normal, shade.mat_type, shade.fuzz, shade.eta,
                      albedo, hit.prim_idx)
    return PathState(origin=res.origin, direction=res.direction,
                     throughput=res.throughput, radiance=res.radiance,
                     alive=res.alive, time=state.time,
                     prev_pdf=res.prev_pdf,
                     prev_diffuse=res.prev_diffuse), res.rays_lane


def _render_tables(cfg, scene, split):
    """(split tables, E's tables) of a render in split mode `split`
    (`_split_mode`), each None where the mode does not read it."""
    with P.span("tables"):
        mode = _split_mode(cfg, scene, split)
        if not mode:
            return None, None
        return (_split_tables(cfg, scene),
                SK.shade_tables(scene) if _shade_mode(cfg, mode) else None)


# Length of the iteration-occupancy trace (cfg.occupancy_trace); later
# iterations add into its last entry, as in the reference.
OCC_TRACE_CAP = 512


class WavefrontStats(NamedTuple):
    """The wavefront counters of cfg.bounce_stats (the reference's), int64
    on the scene's device: exact, and summed without atomics on floats.
    They add across tiles and spp chunks (`stats_add`).

    `len_hist[L]` counts finished paths of length L bounces (bin 0 unused),
    recorded when a path finishes (regen) or is flushed (queue); render
    derives the rays traced at each depth from it."""

    len_hist: Any      # [max_depth + 1]
    iters: Any         # [1]: wavefront iterations run
    alive_sum: Any     # [1]: alive lanes summed over iterations
    occ_sum: Any       # [OCC_TRACE_CAP] (or [0]): alive lanes at iteration i
    occ_cnt: Any       # [OCC_TRACE_CAP] (or [0]): iterations at index i


def stats_zero(max_depth: int, trace: bool, device) -> WavefrontStats:
    cap = OCC_TRACE_CAP if trace else 0

    def z(n):
        return torch.zeros(n, dtype=torch.int64, device=device)
    return WavefrontStats(len_hist=z(max_depth + 1), iters=z(1),
                          alive_sum=z(1), occ_sum=z(cap), occ_cnt=z(cap))


def stats_add(a: WavefrontStats, b: WavefrontStats) -> WavefrontStats:
    return WavefrontStats(*(x + y for x, y in zip(a, b)))


def _stats_update(st: WavefrontStats, alive, live=None) -> None:
    """Count one wavefront iteration in place: its alive lanes and, when
    the occupancy trace is on, the lanes at its index.  `live` (a [1] bool
    tensor, default true) is whether the iteration counts: the reference
    counts only iterations its loop condition admits, and the card's queue
    runs some past the end (`_CHECK_EVERY`); those have no alive lane, so
    only the iteration counts need the mask."""
    n_alive = alive.sum(dtype=torch.int64).reshape(1)
    one = 1 if live is None else live.to(torch.int64)
    if st.occ_sum.numel():
        ti = torch.clamp_max(st.iters, OCC_TRACE_CAP - 1)
        st.occ_sum.index_add_(0, ti, n_alive)
        st.occ_cnt.index_add_(0, ti, torch.ones_like(n_alive) * one)
    st.iters.add_(one)
    st.alive_sum.add_(n_alive)


def _stats_record_lengths(st: WavefrontStats, finished, length,
                          max_depth: int) -> None:
    """Add the lengths of the paths in `finished` to the histogram in
    place (the other lanes add 0 into bin 0)."""
    idx = torch.where(finished, torch.clamp_max(length, max_depth), 0)
    st.len_hist.index_add_(0, idx, finished.to(torch.int64))


def _nan_to_zero(x):
    """nan_to_num(nan=0, posinf=0, neginf=0)."""
    return torch.where(torch.isfinite(x), x, 0.0)


def trace_paths_counted(scene: S.Scene, cfg, pixel_idx, sample_idx,
                        seed: int, split=None):
    """Trace sample `sample_idx` (a scalar or [N]) of each pixel in
    `pixel_idx`.  Returns (radiance Vec3 of [N] planes, NaN and inf
    scrubbed; rays traced, an int64 [1] tensor on the scene's device).

    With cfg.differentiable the loop runs exactly cfg.max_depth bounces
    (the reference's lax.scan: a dead lane's bounce changes nothing), for
    torch autograd; with cfg.remat each bounce is checkpointed
    (torch.utils.checkpoint, non-reentrant), so the backward keeps only the
    PathState between bounces and recomputes each bounce once.  The
    recomputation draws the same samples (every draw is a keyed hash of
    (pixel, sample, bounce, slot), no generator state) and picks the same
    winners (the kernels are deterministic).  Without it the loop exits
    once every path is dead.  `split`: the split tier's mode
    (`bounce_step`)."""
    dev = scene.device
    pixel_idx = torch.as_tensor(pixel_idx, device=dev).to(torch.int64)
    path_keys = R.make_path_keys(seed, pixel_idx, sample_idx, cfg.rng)
    state = generate_camera_rays(scene, cfg, pixel_idx, path_keys)
    tables, stables = _render_tables(cfg, scene, split)
    rays = torch.zeros(1, dtype=torch.int64, device=dev)

    def step(st, bounce):
        return bounce_step(scene, cfg, path_keys, st, bounce, tables, split,
                           stables)

    for bounce in range(cfg.max_depth):
        if not cfg.differentiable and not bool(state.alive.any()):
            break
        if cfg.differentiable and cfg.remat and torch.is_grad_enabled():
            state, rays_lane = torch.utils.checkpoint.checkpoint(
                step, state, bounce, use_reentrant=False,
                preserve_rng_state=False)
        else:
            state, rays_lane = step(state, bounce)
        rays += rays_lane.sum(dtype=torch.int64)
    return Vec3(*(_nan_to_zero(c) for c in state.radiance)), rays


def trace_paths(scene: S.Scene, cfg, pixel_idx, sample_idx, seed: int,
                split=None):
    """As trace_paths_counted, the radiance as an [N, 3] tensor."""
    rad, _ = trace_paths_counted(scene, cfg, pixel_idx, sample_idx, seed,
                                 split)
    return rad.stack()


def unported(cfg) -> list[str]:
    """What this render needs that the port does not have yet, each with
    its ROADMAP item: nothing since gradients landed (item 12), so every
    RenderConfig option renders."""
    del cfg
    return []


def _mega_problems(cfg, scene) -> list[str]:
    """What puts a render outside the megakernel's envelope (the
    reference's `_validate_mega`): the kernel draws only the fast hash,
    computes only NEE + MIS with one light, counts nothing, has no
    gradients and fetches no noise or image texture."""
    problems = []
    if cfg.differentiable:
        problems.append("differentiable=True (no in-kernel gradients)")
    if cfg.bounce_stats:
        problems.append("bounce_stats=True (no in-kernel counters)")
    if cfg.rng != "fast":
        problems.append(f"rng={cfg.rng!r} (only 'fast' is drawn in-kernel)")
    if cfg.estimator != "mis":
        problems.append(f"estimator={cfg.estimator!r} (only the NEE+MIS "
                        "estimator is implemented in-kernel)")
    if scene.num_lights > 1:
        problems.append(f"num_lights={scene.num_lights} (kernel NEE is "
                        "single-light)")
    if scene.emissives_unregistered:
        problems.append("unregistered emissive prims (kernel MIS "
                        "attributes all emissive hits to light row 0)")
    if scene.tex_present[S.TEX_NOISE] or scene.tex_present[S.TEX_IMAGE]:
        problems.append("noise/image textures (no in-kernel atlas fetch)")
    return problems


def _validate_mega(cfg, scene):
    """The megakernel's feature envelope, checked loudly: a render the
    kernel does not compute (`_mega_problems`) raises ValueError."""
    problems = _mega_problems(cfg, scene)
    if problems:
        raise ValueError("backend='mega' unsupported for this render: "
                         + "; ".join(problems))


def _n_prims(scene) -> int:
    return sum(e[1] for e in scene.chunk_plan)


def _mega_backend(cfg, scene) -> bool:
    """Whether the render runs the megakernel scheduler: forced by
    backend="mega" (inside the envelope, or it raises), or chosen by "auto"
    for a CUDA scene below the split tier that is inside the envelope, as
    the reference's predicate chooses it.  Under "auto" a render the kernel
    does not compute (`_mega_problems`: a config option or the scene) runs
    `_split_backend`'s choice, the regen sweep below 128 prims, as the
    reference runs its jnp sweep there.  CPU scenes run the plain regen
    path under "auto", as the reference does on its CPU."""
    if cfg.backend == "mega":
        _validate_mega(cfg, scene)
        return True
    if cfg.backend != "auto":
        return False
    if scene.device.type != "cuda" or _n_prims(scene) >= SPLIT_TIER_PRIMS:
        return False
    return not _mega_problems(cfg, scene)


def _split_backend(cfg, scene) -> bool:
    """Whether `bounce_step` traces through the split-tier kernels
    (ops/trace_kernel): forced by backend="pallas" (a CUDA scene only),
    refused by "jnp", chosen by "auto" for a CUDA scene of 128 or more
    prims (the reference's _pallas_backend)."""
    if cfg.backend == "pallas":
        if scene.device.type != "cuda":
            raise ValueError(f"backend='pallas' runs the split-tier CUDA "
                             f"kernels; the scene is on {scene.device}")
        return True
    if cfg.backend != "auto":
        return False
    return (scene.device.type == "cuda"
            and _n_prims(scene) >= SPLIT_TIER_PRIMS)


def trace_wavefront(scene: S.Scene, cfg, pixel_idx, seed: int, s0: int,
                    n_samples: int):
    """Dispatch to the configured wavefront scheduler (cfg.scheduler).
    Returns (accum Vec3 of [N], rays as an int64 [1] tensor, stats: a
    WavefrontStats with cfg.bounce_stats, else ())."""
    sched = cfg.scheduler
    if cfg.backend not in ("auto", "mega", "jnp", "pallas"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.backend == "mega" and sched not in ("auto", "mega"):
        raise ValueError(
            f"backend='mega' requires scheduler 'auto' or 'mega', got "
            f"{cfg.scheduler!r}")
    if sched == "auto":
        if _mega_backend(cfg, scene):
            sched = "mega"
        else:
            sched = "queue" if _split_backend(cfg, scene) else "regen"
    elif sched not in ("mega", "regen", "queue", "qmega"):
        raise ValueError(f"unknown scheduler {cfg.scheduler!r}")
    if sched == "qmega":
        _validate_mega(cfg, scene)     # the megakernel's envelope
    run = {"qmega": trace_wavefront_qmega, "mega": trace_wavefront_mega,
           "queue": trace_wavefront_queue,
           "regen": trace_wavefront_regen}[sched]
    with P.span("sched." + sched):
        return run(scene, cfg, pixel_idx, seed, s0, n_samples)


def trace_wavefront_mega(scene: S.Scene, cfg, pixel_idx, seed: int, s0: int,
                         n_samples: int):
    """Regenerating wavefront with every lane's whole path in the
    megakernel: one `mega_kernel.mega_trace` call for the pixel batch and
    the samples [s0, s0 + n_samples).  On the card that is one launch of
    the persistent kernel, with no host loop and no termination read; the
    set-up before it (the tables, the launch parameters) copies between
    host and device.  Rays are counted on the device in int64."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    params = MK.mega_params(scene, seed, cfg, s0 + n_samples, s0)
    pixel_idx = pixel_idx.to(device=scene.device, dtype=torch.int32)
    rays = torch.zeros(1, dtype=torch.int64, device=scene.device)
    acc = MK.mega_trace(scene, cfg, pixel_idx.contiguous(), params, rays)
    return Vec3(acc[0], acc[1], acc[2]), rays, ()


def trace_wavefront_regen(scene: S.Scene, cfg, pixel_idx, seed: int, s0: int,
                          n_samples: int, split=None):
    """Persistent wavefront with ray regeneration, plain torch: each lane
    starts its next sample (same pixel, sample cursor + 1) the moment its
    path ends.  Every draw is keyed by (pixel, sample, bounce, slot), so the
    image matches the reference's regen scheduler.  The reference's drain
    tail compaction is compiled out on its plain path too, and is not
    ported.  `split`: the split tier's mode of every bounce (`bounce_step`;
    "glue" times the path before kernels E and F).  Returns (accum Vec3 of
    [N], rays int64 [1], stats: a WavefrontStats with cfg.bounce_stats,
    else ())."""
    tables, stables = _render_tables(cfg, scene, split)
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    sample = torch.full((n,), s0, dtype=torch.int64, device=dev)
    path_keys = R.make_path_keys(seed, pixel_idx, sample, cfg.rng)
    path = generate_camera_rays(scene, cfg, pixel_idx, path_keys)
    s_end = s0 + n_samples
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    accum = V.zeros(n, dev)
    rays = torch.zeros(1, dtype=torch.int64, device=dev)
    stats = (stats_zero(cfg.max_depth, cfg.occupancy_trace, dev)
             if cfg.bounce_stats else ())

    while bool(path.alive.any()):
        if stats:
            _stats_update(stats, path.alive)
        st, rays_lane = bounce_step(scene, cfg, path_keys, path, depth,
                                    tables, split, stables)
        rays += rays_lane.sum(dtype=torch.int64)
        depth = depth + 1
        finished = path.alive & (~st.alive | (depth >= cfg.max_depth))
        if stats:
            _stats_record_lengths(stats, finished, depth, cfg.max_depth)
        rad = Vec3(*(_nan_to_zero(c) for c in st.radiance))
        accum = V.where(finished, accum + rad, accum)
        sample = torch.where(finished, sample + 1, sample)
        regen = finished & (sample < s_end)

        new_keys = R.make_path_keys(seed, pixel_idx, sample, cfg.rng)
        fresh = generate_camera_rays(scene, cfg, pixel_idx, new_keys)
        path = PathState(
            origin=V.where(regen, fresh.origin, st.origin),
            direction=V.where(regen, fresh.direction, st.direction),
            throughput=V.where(regen, fresh.throughput, st.throughput),
            radiance=V.where(finished, fresh.radiance, st.radiance),
            alive=torch.where(finished, regen, st.alive),
            time=torch.where(regen, fresh.time, st.time),
            prev_pdf=torch.where(regen, fresh.prev_pdf, st.prev_pdf),
            prev_diffuse=torch.where(regen, fresh.prev_diffuse,
                                     st.prev_diffuse),
        )
        path_keys = torch.where(regen, new_keys, path_keys)
        depth = torch.where(regen, 0, depth)
    return accum, rays, stats


def trace_wavefront_queue(scene: S.Scene, cfg, pixel_idx, seed: int, s0: int,
                          n_samples: int, split=None):
    """Persistent wavefront with a global work queue.

    Items are (pixel, sample) pairs, sample-major: item i is
    (pixel_idx[i mod N], s0 + i div N).  Lane i starts on item i; a lane
    whose path ends turns pending, and at a flush every pending lane adds
    its sample into its accum column and claims item `cursor + rank` (rank:
    its place among the pending lanes), so the wavefront stays full until
    the queue drains.  The draws are keyed by (pixel, sample), so the
    samples are the regen scheduler's; per-pixel sums are added in claim
    order.

    The flush (`_queue_flush`) is decided on the device and applied
    through masks, so the loop makes no host sync per iteration and claims
    exactly the reference's items in the reference's order; an iteration
    without a flush leaves every carry value as it was.  The termination
    test (some lane alive or pending) is
    read once per `_CHECK_EVERY` iterations on the card (every iteration on
    the CPU, where a read costs nothing); the iterations past the end find
    no lane alive or pending, trace no ray and flush nothing.

    With cfg.bounce_stats the counters are updated on the device, masked
    by the termination test, so the card's iterations past the end count
    nothing and its counters equal the CPU's.

    `split`: the split tier's mode of every bounce (`bounce_step`; "glue"
    times the path before kernels E and F).

    Returns (accum Vec3 of [N] positional sums, rays int64 [1], stats: a
    WavefrontStats with cfg.bounce_stats, else ())."""
    tables, stables = _render_tables(cfg, scene, split)
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    i64 = torch.int64
    pixel_idx = pixel_idx.to(i64)
    n_items = n * n_samples
    sample = torch.full((n,), s0, dtype=i64, device=dev)
    path_keys = R.make_path_keys(seed, pixel_idx, sample, cfg.rng)
    path = generate_camera_rays(scene, cfg, pixel_idx, path_keys)
    depth = torch.zeros(n, dtype=i64, device=dev)
    item_pos = torch.arange(n, dtype=i64, device=dev)
    pixel = pixel_idx
    pending = torch.zeros(n, dtype=torch.bool, device=dev)
    # three distinct planes: the flush adds into them in place
    accum = Vec3(*(torch.zeros(n, dtype=torch.float32, device=dev)
                   for _ in range(3)))
    rays = torch.zeros(1, dtype=i64, device=dev)
    cursor = torch.full((1,), n, dtype=i64, device=dev)
    check_every = _check_every(dev)
    stats = (stats_zero(cfg.max_depth, cfg.occupancy_trace, dev)
             if cfg.bounce_stats else ())

    while True:
        for _ in range(check_every):
            with P.span("queue.iteration"):
                if stats:
                    live = (path.alive.any() | pending.any()).reshape(1)
                    _stats_update(stats, path.alive, live)
                st, rays_lane = bounce_step(scene, cfg, path_keys, path,
                                            depth, tables, split, stables)
                rays += rays_lane.sum(dtype=i64)
                # pending lanes keep their final depth
                depth = torch.where(path.alive, depth + 1, depth)
                finished = path.alive & (~st.alive
                                         | (depth >= cfg.max_depth))
                pending = pending | finished
                running = st.alive & ~finished
                path = st._replace(alive=running)

                with P.span("queue.flush"):
                    pend, have, item_pos, q_sample, q_pixel, cursor = (
                        _queue_flush(pending, running, path.radiance, accum,
                                     item_pos, cursor, pixel_idx, s0,
                                     n_items, cfg.flush_denom))
                if stats:
                    # a flushed lane's depth froze at its path's length
                    _stats_record_lengths(stats, pend, depth, cfg.max_depth)
                with P.span("queue.regen"):
                    sample = torch.where(have, q_sample, sample)
                    pixel = torch.where(have, q_pixel, pixel)
                    new_keys = R.make_path_keys(seed, pixel, sample, cfg.rng)
                    fresh = generate_camera_rays(scene, cfg, pixel, new_keys)
                    path = PathState(
                        origin=V.where(have, fresh.origin, path.origin),
                        direction=V.where(have, fresh.direction,
                                          path.direction),
                        throughput=V.where(have, fresh.throughput,
                                           path.throughput),
                        radiance=V.where(pend, fresh.radiance,
                                         path.radiance),
                        alive=path.alive | have,
                        time=torch.where(have, fresh.time, path.time),
                        prev_pdf=torch.where(have, fresh.prev_pdf,
                                             path.prev_pdf),
                        prev_diffuse=torch.where(have, fresh.prev_diffuse,
                                                 path.prev_diffuse),
                    )
                    path_keys = torch.where(have, new_keys, path_keys)
                    depth = torch.where(have, 0, depth)
                    pending = pending & ~pend
        with P.span("queue.wait"):
            more = bool((path.alive.any() | pending.any()))
        if not more:
            break
    return accum, rays, stats


def _queue_flush(pending, running, radiance: Vec3, accum: Vec3, item_pos,
                 cursor, pixel_idx, s0: int, n_items: int, flush_denom: int):
    """The work queue's flush, decided on the device and applied through
    masks (no host sync).  It flushes when pending * flush_denom >= N, or
    when no lane runs and some are pending (flush_denom 0: every
    iteration); then every pending lane (`pend`) adds its radiance, NaN and
    inf scrubbed, into its item's accum column in place, and claims item
    `cursor + rank` (rank: its place among the pending lanes) while items
    are left (`have`).  Returns (pend, have, item_pos, claimed sample,
    claimed pixel, cursor); the claimed planes are meaningful where
    `have`."""
    n = pending.shape[0]
    i64 = torch.int64
    if flush_denom <= 0:
        pend = pending
    else:
        n_pend = pending.sum(dtype=i64)
        n_run = running.sum(dtype=i64)
        do_flush = ((n_pend * flush_denom >= n)
                    | ((n_run == 0) & (n_pend > 0)))
        pend = pending & do_flush
    for a, r in zip(accum, radiance):
        a.index_add_(0, item_pos, torch.where(pend, _nan_to_zero(r), 0.0))
    fin = pend.to(i64)
    new_item = cursor + torch.cumsum(fin, 0) - 1
    have = pend & (new_item < n_items)
    q = new_item // n
    item_pos = torch.where(have, new_item - q * n, item_pos)
    claimed = pixel_idx[torch.clamp_max(item_pos, n - 1)]
    return pend, have, item_pos, s0 + q, claimed, cursor + fin.sum()


def qmega_carry(scene: S.Scene, cfg, pixel_idx, seed: int, s0: int):
    """The hybrid mode's carry (sf, si) before its first launch: every lane
    of `pixel_idx` (int64 [N]) alive on its camera ray of sample s0."""
    dev = scene.device
    n = pixel_idx.shape[0]
    sample = torch.full((n,), s0, dtype=torch.int64, device=dev)
    path = generate_camera_rays(
        scene, cfg, pixel_idx, R.make_path_keys(seed, pixel_idx, sample,
                                                cfg.rng))
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    sf = torch.stack([*path.origin, *path.direction, *path.throughput,
                      *path.radiance, zero, zero, zero, path.time,
                      path.prev_pdf])
    izero = torch.zeros(n, dtype=torch.int32, device=dev)
    si = torch.stack([izero + 1, izero, izero, sample.to(torch.int32),
                      pixel_idx.to(torch.int32)])
    return sf, si


def trace_wavefront_qmega(scene: S.Scene, cfg, pixel_idx, seed: int, s0: int,
                          n_samples: int):
    """The work queue with the whole bounce in one launch: the megakernel's
    hybrid mode (`mega_kernel.mega_step(..., hybrid=True)`, TPU kernel D)
    advances every live path (trace, shade, NEE, RR) and leaves a finished
    one dead with its radiance; claiming, the sample scatter and camera-ray
    generation stay in torch behind the queue's flush (`_queue_flush`).
    It draws the samples of `trace_wavefront_queue` and claims them in the
    same order.  The reference pads the lanes to its kernel's tile and
    counts the padded lanes in its flush rule; the port does not pad, so
    the two flush alike where the lane count is a multiple of that tile.
    The termination test is read as in `trace_wavefront_queue`.

    Returns (accum Vec3 of [N] positional sums, rays int64 [1], ())."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    dev = scene.device
    i64 = torch.int64
    pixel_idx = pixel_idx.to(device=dev, dtype=i64)
    n = pixel_idx.shape[0]
    n_items = n * n_samples
    sf, si = qmega_carry(scene, cfg, pixel_idx, seed, s0)
    params = MK.mega_params(scene, seed, cfg, s0 + n_samples)
    pending = torch.zeros(n, dtype=torch.bool, device=dev)
    item_pos = torch.arange(n, dtype=i64, device=dev)
    accum = Vec3(*(torch.zeros(n, dtype=torch.float32, device=dev)
                   for _ in range(3)))
    rays = torch.zeros(1, dtype=i64, device=dev)
    cursor = torch.full((1,), n, dtype=i64, device=dev)
    check_every = _check_every(dev)

    while True:
        for _ in range(check_every):
            prev_alive = si[MK.I_ALIVE] > 0
            sf, si = MK.mega_step(scene, cfg, sf, si, params, rays,
                                  hybrid=True)
            running = si[MK.I_ALIVE] > 0
            pending = pending | (prev_alive & ~running)
            rad = Vec3(*sf[MK.F_RAD:MK.F_RAD + 3])
            pend, have, item_pos, q_sample, q_pixel, cursor = _queue_flush(
                pending, running, rad, accum, item_pos, cursor, pixel_idx,
                s0, n_items, cfg.flush_denom)

            # the step's outputs are fresh tensors: update them in place
            smp = torch.where(have, q_sample, si[MK.I_SAMPLE].to(i64))
            pix = torch.where(have, q_pixel, si[MK.I_PIXEL].to(i64))
            fresh = generate_camera_rays(
                scene, cfg, pix, R.make_path_keys(seed, pix, smp, cfg.rng))
            cam = torch.stack([*fresh.origin, *fresh.direction])
            sf[MK.F_ORG:MK.F_DIR + 3] = torch.where(
                have, cam, sf[MK.F_ORG:MK.F_DIR + 3])
            sf[MK.F_THR:MK.F_THR + 3] = torch.where(
                have, 1.0, sf[MK.F_THR:MK.F_THR + 3])
            # every flushed lane's radiance resets, claimed or not, so an
            # unclaimed lane cannot be added twice by a later flush
            sf[MK.F_RAD:MK.F_RAD + 3] = torch.where(
                pend, 0.0, sf[MK.F_RAD:MK.F_RAD + 3])
            sf[MK.F_TIME] = torch.where(have, fresh.time, sf[MK.F_TIME])
            sf[MK.F_PPDF] = torch.where(have, 1.0, sf[MK.F_PPDF])
            si[MK.I_ALIVE] = torch.where(have, 1, si[MK.I_ALIVE])
            si[MK.I_PREVD] = torch.where(have, 0, si[MK.I_PREVD])
            si[MK.I_DEPTH] = torch.where(have, 0, si[MK.I_DEPTH])
            si[MK.I_SAMPLE] = smp.to(torch.int32)
            si[MK.I_PIXEL] = pix.to(torch.int32)
            pending = pending & ~pend
        if not bool(((si[MK.I_ALIVE] > 0).any() | pending.any())):
            break
    return accum, rays, ()
