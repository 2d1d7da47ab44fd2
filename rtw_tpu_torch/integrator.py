"""Wavefront path-tracing integrator (port of rtw_tpu/integrator.py).

Two executors of the same estimator, both drawing the reference's fast-RNG
chain (so both trace the same paths):

- `trace_wavefront_regen`: the plain path.  Each lane owns one pixel and
  regenerates its next sample when its path ends; every bounce is a chain
  of torch ops (`bounce_step`).  It runs on the CPU and, when asked for by
  `scheduler="regen"`, on a CUDA scene.
- `trace_wavefront_mega`: a loop of `mega_kernel.mega_step` launches, one
  whole wavefront iteration each; on a CUDA scene that is the hand-written
  CUDA megakernel.  It is the main path: `scheduler="auto"` picks it for a
  CUDA scene inside the kernel's envelope.

`trace_wavefront` dispatches.  What is not ported raises
NotImplementedError naming its ROADMAP item; nothing falls back silently
to the plain path on the card in place of an unported kernel.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from rtw_tpu_torch.models import scene as S
from rtw_tpu_torch.ops import sampling as sm
from rtw_tpu_torch.ops import vec as V
from rtw_tpu_torch.ops.vec import Vec3
from rtw_tpu_torch.ops.bounce import BounceEnv, bounce_core
from rtw_tpu_torch.ops.intersect import (BIG, check_prim_type,
                                         intersect_scene, occluded)
from rtw_tpu_torch.ops.shading import (check_textures, gather_shade,
                                       resolve_albedo)
from rtw_tpu_torch.utils import rng as R

# Scenes at or above this many prims run the split-tier kernels B and C in
# the reference (integrator._pallas_backend); the megakernel's envelope
# stops below it.
SPLIT_TIER_PRIMS = 128

# trace_wavefront_mega reads its termination test once per this many
# launches: each read is a host sync, and a launch past the end is harmless.
_CHECK_EVERY = 8


class PathState(NamedTuple):
    """SoA wavefront state."""

    origin: Vec3
    direction: Vec3
    throughput: Vec3
    radiance: Vec3
    alive: Any         # [N] bool
    time: Any          # [N] shutter gather time
    prev_pdf: Any      # [N] bsdf pdf of the previous diffuse bounce
    prev_diffuse: Any  # [N] bool


def generate_camera_rays(scene: S.Scene, cfg, pixel_idx, path_keys) -> PathState:
    """Thin-lens primary rays."""
    cam = scene.camera
    u = R.camera_uniforms(path_keys, cfg.rng)          # [5, N]
    x = (pixel_idx % cfg.nx).to(torch.float32)
    y = (pixel_idx // cfg.nx).to(torch.float32)
    s = (x + u[0]) / float(cfg.nx)
    t = (y + u[1]) / float(cfg.ny)

    rdx, rdy = sm.unit_disk(u[2], u[3])
    rdx = cam.lens_radius * rdx
    rdy = cam.lens_radius * rdy
    origin = V.v3(cam.origin) + V.v3(cam.u) * rdx + V.v3(cam.v) * rdy
    direction = (V.v3(cam.lower_left) + V.v3(cam.horizontal) * s
                 + V.v3(cam.vertical) * t - origin)
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


def _light_pdf_at(scene: S.Scene, origin: Vec3, point: Vec3, dir_unit: Vec3,
                  prim_idx, mask):
    """Solid-angle pdf of NEE having sampled the direction that hit a light
    at `point`, for the MIS weight of BSDF-sampled light hits.  One-sided:
    a hit on a light's back side gets pdf 0 (the reference's 8820107 fix),
    because NEE never samples it."""
    lights = scene.lights
    L = max(scene.num_lights, 1)
    d = point - origin
    dist2 = torch.where(mask, d.dot(d), 1.0)

    if L == 1 and not scene.emissives_unregistered:
        ln = V.v3(lights.normal[0])
        area = lights.area[0]
        cos_t = -dir_unit.dot(ln)
        sel = mask & (cos_t > 1e-6)
        pdf = dist2 / (area * torch.where(sel, cos_t, 1.0)) / float(L)
        return torch.where(sel, pdf, 0.0)

    row = scene.prims.light_row_p[torch.clamp_min(prim_idx, 0)]
    row = torch.where(mask & (prim_idx >= 0), row, -1)
    r = torch.clamp_min(row, 0)
    area = lights.area[r]
    ln = V.gather_rows(lights.normal, r)
    cos_t = -dir_unit.dot(ln)
    sel = (row >= 0) & (cos_t > 1e-6)
    pdf = dist2 / (torch.where(sel, area * cos_t, 1.0) * float(L))
    return torch.where(sel, pdf, 0.0)


def _pick_light(scene: S.Scene, u_sel, ua, ub):
    """Uniform selection among the scene's Lights rows."""
    lights = scene.lights
    L = scene.num_lights
    li = (torch.zeros_like(u_sel, dtype=torch.int64) if L == 1 else
          torch.clamp((u_sel * L).to(torch.int64), 0, L - 1))
    l_area = lights.area[0] if L == 1 else lights.area[li]
    lpos = (V.gather_rows(lights.position, li)
            + V.gather_rows(lights.vec_u, li) * ua
            + V.gather_rows(lights.vec_v, li) * ub)
    return (lpos, l_area, V.gather_rows(lights.normal, li),
            V.gather_rows(lights.emission, li))


def _occlude(scene: S.Scene, cfg, shadow_org, ldir_u, occ_tmax, want):
    del want  # the plain sweep tests every lane; occ_tmax masks the rest
    return occluded(scene, shadow_org, ldir_u, cfg.shadow_eps, occ_tmax)


def bounce_env(scene: S.Scene, cfg) -> BounceEnv:
    """The plain executor's BounceEnv (also the megakernel's plain twin's)."""
    return BounceEnv(
        mat_present=scene.mat_present,
        num_lights=scene.num_lights,
        mis_bsdf_weight=cfg.mis_bsdf_weight,
        rr_start_depth=cfg.rr_start_depth,
        sky_gate=scene.sky_light,
        unit_ball=sm.unit_ball,
        light_pdf_at=functools.partial(_light_pdf_at, scene),
        pick_light=functools.partial(_pick_light, scene),
        occlude=functools.partial(_occlude, scene, cfg),
        estimator=cfg.estimator,
    )


def bounce_step(scene: S.Scene, cfg, path_keys, state: PathState, bounce):
    """One wavefront bounce: trace, shade, NEE, RR.  Returns
    (new state, [N] int32 rays issued per lane)."""
    n_slots = R.NUM_FIXED_SLOTS + 2 * max(scene.n_vol, 1)
    U = R.bounce_uniforms(path_keys, bounce + 1, n_slots, cfg.rng)

    o, d = state.origin, state.direction
    # dead lanes get tmax = -BIG: a forced miss, masked by alive below
    tmax_lane = torch.where(state.alive, float(np.float32(cfg.t_max)), -BIG)
    hit = intersect_scene(scene, o, d, cfg.t_min, tmax_lane)
    shade = gather_shade(scene, hit.prim_idx, hit.prim_idx >= 0)
    albedo = resolve_albedo(scene, shade, hit.point)

    res = bounce_core(bounce_env(scene, cfg), U, bounce, state.alive, o, d,
                      state.throughput, state.radiance, state.prev_pdf,
                      state.prev_diffuse, hit.prim_idx < 0, hit.point,
                      hit.normal, shade.mat_type, shade.fuzz, shade.eta,
                      albedo, hit.prim_idx)
    return PathState(origin=res.origin, direction=res.direction,
                     throughput=res.throughput, radiance=res.radiance,
                     alive=res.alive, time=state.time,
                     prev_pdf=res.prev_pdf,
                     prev_diffuse=res.prev_diffuse), res.rays_lane


def _nan_to_zero(x):
    """nan_to_num(nan=0, posinf=0, neginf=0)."""
    return torch.where(torch.isfinite(x), x, 0.0)


def unported(cfg, scene) -> list[str]:
    """What this render needs that the port does not have yet, each with
    its ROADMAP item; empty when every piece of the render is ported."""
    out = []
    if cfg.differentiable:
        out.append("differentiable=True (ROADMAP item 12)")
    if cfg.bounce_stats or cfg.occupancy_trace:
        out.append("bounce_stats/occupancy_trace (ROADMAP item 11)")
    if cfg.rng != "fast":
        out.append(f"rng={cfg.rng!r} (ROADMAP item 11)")
    if cfg.estimator != "mis":
        out.append(f"estimator={cfg.estimator!r} (ROADMAP item 11)")
    for e in scene.chunk_plan:
        try:
            check_prim_type(e[3])
        except NotImplementedError as err:
            out.append(str(err))
    try:
        check_textures(scene)
    except NotImplementedError as err:
        out.append(str(err))
    return out


def _raise_unported(cfg, scene) -> None:
    todo = unported(cfg, scene)
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def _validate_mega(cfg, scene):
    """The megakernel's feature envelope, checked loudly: what the port has
    not ported raises NotImplementedError, and a scene the kernel can never
    take (more than one light, unregistered emissives) raises ValueError."""
    _raise_unported(cfg, scene)
    problems = []
    if scene.num_lights > 1:
        problems.append(f"num_lights={scene.num_lights} (kernel NEE is "
                        "single-light)")
    if scene.emissives_unregistered:
        problems.append("unregistered emissive prims (kernel MIS "
                        "attributes all emissive hits to light row 0)")
    if problems:
        raise ValueError("backend='mega' unsupported for this render: "
                         + "; ".join(problems))
    n_prims = sum(e[1] for e in scene.chunk_plan)
    if n_prims >= SPLIT_TIER_PRIMS:
        raise NotImplementedError(
            f"{n_prims} prims: scenes at or above {SPLIT_TIER_PRIMS} prims "
            "run the split-tier trace and occlusion kernels (ROADMAP items "
            "7 and 8; queue 2 items B and C), not ported yet")


def _mega_backend(cfg, scene) -> bool:
    """Whether the render runs the megakernel scheduler: forced by
    backend="mega", or chosen by "auto" for a CUDA scene (which must then
    be inside the envelope: an unported kernel raises rather than the plain
    path running on the card in its place).  CPU scenes run the plain
    regen path under "auto", as the reference does on its CPU."""
    if cfg.backend == "mega":
        _validate_mega(cfg, scene)
        return True
    if cfg.backend != "auto":
        return False
    if scene.device.type != "cuda":
        return False
    _validate_mega(cfg, scene)
    return True


def trace_wavefront(scene: S.Scene, cfg, pixel_idx, seed: int, s0: int,
                    n_samples: int):
    """Dispatch to the configured wavefront scheduler (cfg.scheduler).
    Returns (accum Vec3 of [N], rays as an int64 [1] tensor, stats=())."""
    sched = cfg.scheduler
    if cfg.backend not in ("auto", "mega", "jnp", "pallas"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.backend == "pallas":
        raise NotImplementedError(
            "backend='pallas' (the split-tier kernels) is not ported yet "
            "(ROADMAP items 7 and 8)")
    if cfg.backend == "mega" and sched not in ("auto", "mega"):
        raise ValueError(
            f"backend='mega' requires scheduler 'auto' or 'mega', got "
            f"{cfg.scheduler!r}")
    if sched in ("queue", "qmega"):
        item = ("ROADMAP item 7" if sched == "queue"
                else "ROADMAP queue 2 item D")
        raise NotImplementedError(
            f"scheduler={sched!r} is not ported yet ({item})")
    if sched == "auto":
        sched = "mega" if _mega_backend(cfg, scene) else "regen"
    elif sched not in ("mega", "regen"):
        raise ValueError(f"unknown scheduler {cfg.scheduler!r}")
    n_prims = sum(e[1] for e in scene.chunk_plan)
    if (sched == "regen" and scene.device.type == "cuda"
            and n_prims >= SPLIT_TIER_PRIMS):
        raise NotImplementedError(
            f"{n_prims} prims on the card: the reference traces these with "
            "its split-tier kernels (ROADMAP items 7 and 8; queue 2 items B "
            "and C), not ported yet")
    if sched == "mega":
        return trace_wavefront_mega(scene, cfg, pixel_idx, seed, s0,
                                    n_samples)
    return trace_wavefront_regen(scene, cfg, pixel_idx, seed, s0, n_samples)


def trace_wavefront_mega(scene: S.Scene, cfg, pixel_idx, seed: int, s0: int,
                         n_samples: int):
    """Regenerating wavefront with the whole iteration in one launch
    (ops/mega_kernel.mega_step), driven by a host loop.

    The termination test (some lane alive, or some sample cursor short of
    s_end) is read on the host once every `_CHECK_EVERY` launches: one sync
    per check.  That is exact: a launch after every lane is finished
    changes nothing but the dead lanes' depth, which regeneration resets.
    Rays are counted on the device in int64."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    s_end = s0 + n_samples
    sf, si = MK.init_carry(pixel_idx.to(scene.device), s0)
    params = MK.mega_params(scene, seed, cfg, s_end)
    rays = torch.zeros(1, dtype=torch.int64, device=scene.device)
    while True:
        for _ in range(_CHECK_EVERY):
            sf, si = MK.mega_step(scene, cfg, sf, si, params, rays)
        busy = (si[MK.I_ALIVE] > 0) | (si[MK.I_SAMPLE] < s_end)
        if not bool(busy.any()):
            break
    accum = Vec3(sf[MK.F_ACC], sf[MK.F_ACC + 1], sf[MK.F_ACC + 2])
    return accum, rays, ()


def trace_wavefront_regen(scene: S.Scene, cfg, pixel_idx, seed: int, s0: int,
                          n_samples: int):
    """Persistent wavefront with ray regeneration, plain torch: each lane
    starts its next sample (same pixel, sample cursor + 1) the moment its
    path ends.  Every draw is keyed by (pixel, sample, bounce, slot), so the
    image matches the reference's regen scheduler.  The reference's drain
    tail compaction is compiled out on its plain path too, and is not
    ported."""
    _raise_unported(cfg, scene)
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    sample = torch.full((n,), s0, dtype=torch.int64, device=dev)
    path_keys = R.make_path_keys(seed, pixel_idx, sample, cfg.rng)
    path = generate_camera_rays(scene, cfg, pixel_idx, path_keys)
    s_end = s0 + n_samples
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    accum = V.zeros(n, dev)
    rays = torch.zeros(1, dtype=torch.int64, device=dev)

    while bool(path.alive.any()):
        st, rays_lane = bounce_step(scene, cfg, path_keys, path, depth)
        rays += rays_lane.sum(dtype=torch.int64)
        depth = depth + 1
        finished = path.alive & (~st.alive | (depth >= cfg.max_depth))
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
    return accum, rays, ()
