"""The estimator physics of one bounce (port of rtw_tpu/ops/bounce.py).

`bounce_core` is the plain definition: the integrator's plain path and the
megakernel's plain twin both call it, and csrc/mega_kernel.cu computes the
same steps per lane in the same order.  Every material is evaluated for
every lane and selected per lane, as in the reference, so each plane rounds
exactly as the reference's does.

The scene's light helpers and `scene_env` (a scene's BounceEnv, the
shadow query left to the caller) live here too: the integrator and kernel
E's wrapper (ops/shade_kernel.py) both build on them.

Two estimators, as in the reference: "mis" (NEE shadow rays +
power-heuristic MIS) and "book" (the books' 0.5/0.5 cosine/light mixture
for the next ray, with no shadow rays and no MIS).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from . import scene as S
from . import sampling as sm
from . import vec as V
from .intersect import BIG
from .vec import Vec3
from . import rng as R


def check_estimator(estimator: str) -> None:
    if estimator not in ("mis", "book"):
        raise ValueError(f"unknown estimator {estimator!r}")


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


class BounceEnv(NamedTuple):
    """Execution-environment accessors injected by each bounce executor (see
    the reference's BounceEnv for each signature)."""

    mat_present: tuple            # static MAT_* presence flags
    num_lights: int
    mis_bsdf_weight: bool
    rr_start_depth: int
    sky_gate: Any                 # scalar: sky_light (0.0 / 1.0)
    unit_ball: Callable[..., Vec3]
    light_pdf_at: Optional[Callable[..., Any]]
    pick_light: Optional[Callable[..., Any]]
    occlude: Optional[Callable[..., Any]]
    estimator: str = "mis"
    # (origin, dir_unit, mask) -> (1/L) * sum over lights of the solid-angle
    # pdf of dir_unit hitting that light, with no occlusion: the mixture's
    # light pdf ("book" only)
    light_pdf_dir: Optional[Callable[..., Any]] = None

    # The bounce's static branches, decided here once for `bounce_core` and
    # for kernel E's parameters (ops/shade_kernel.py)
    @property
    def book(self) -> bool:
        """The lambertian scatter is the books' mixture."""
        return self.estimator == "book" and self.num_lights > 0

    @property
    def nee(self) -> bool:
        """The bounce samples a light with a shadow ray."""
        return (self.num_lights > 0 and not self.book
                and bool(self.mat_present[S.MAT_LAMBERTIAN]))

    @property
    def mis_weight(self) -> bool:
        """A BSDF-sampled light hit is MIS-weighted against NEE."""
        return self.mis_bsdf_weight and self.num_lights > 0 and not self.book


class BounceResult(NamedTuple):
    origin: Vec3
    direction: Vec3
    throughput: Vec3
    radiance: Vec3
    alive: Any            # [N] bool: path still tracing after this bounce
    prev_pdf: Any
    prev_diffuse: Any     # [N] bool
    rays_lane: Any        # [N] int32: traversal queries this lane issued
    # The NEE shadow query and its contribution, where the bounce has NEE
    # (else None): the shadow ray's origin, unit direction and tmax (-BIG
    # on lanes with no query), and each lane's term thr * nee.  With
    # `env.occlude` None the query is left to the caller, and `radiance`
    # is the radiance before NEE: `finish_nee` adds the term.
    shadow_org: Optional[Vec3] = None
    shadow_dir: Optional[Vec3] = None
    shadow_tmax: Any = None
    nee: Optional[Vec3] = None


# ----- the scene's lights (the reference's integrator.py:124,173,298) -----

def single_light(scene: S.Scene) -> bool:
    """`light_pdf_at`'s shortcut: one light row, and every emissive prim is
    registered as that light, so a light hit needs no per-prim row."""
    return max(scene.num_lights, 1) == 1 and not scene.emissives_unregistered


def light_pdf_at(scene: S.Scene, origin: Vec3, point: Vec3, dir_unit: Vec3,
                 prim_idx, mask):
    """Solid-angle pdf of NEE having sampled the direction that hit a light
    at `point`, for the MIS weight of BSDF-sampled light hits.  One-sided:
    a hit on a light's back side gets pdf 0 (the reference's 8820107 fix),
    because NEE never samples it."""
    lights = scene.lights
    L = max(scene.num_lights, 1)
    d = point - origin
    dist2 = torch.where(mask, d.dot(d), 1.0)

    if single_light(scene):
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


def light_pdf_dir(scene: S.Scene, origin: Vec3, dir_unit: Vec3, mask):
    """(1/L) * sum over lights of the solid-angle pdf of `dir_unit` from
    `origin` hitting that light: the books' hittable_pdf::value, a
    geometric parallelogram test with no scene occlusion, for the "book"
    mixture's pdf.  L unrolled tests of scalar light rows."""
    lights = scene.lights
    L = scene.num_lights
    total = torch.zeros_like(origin.x)
    for li in range(L):
        q = V.v3(lights.position[li])
        eu = V.v3(lights.vec_u[li])
        ev = V.v3(lights.vec_v[li])
        ln = V.v3(lights.normal[li])
        area = lights.area[li]
        denom = dir_unit.dot(ln)
        ok = denom.abs() > 1e-8
        denom_s = torch.where(ok, denom, 1.0)
        t = (q - origin).dot(ln) / denom_s
        ok = ok & (t > 1e-4)
        w = origin + dir_unit * t - q
        uu = eu.dot(eu)
        vv = ev.dot(ev)
        uv = eu.dot(ev)
        det = uu * vv - uv * uv
        wu = w.dot(eu)
        wv = w.dot(ev)
        a = (wu * vv - wv * uv) / det
        b = (wv * uu - wu * uv) / det
        ok = ok & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
        pdf_l = torch.where(
            ok & mask,
            t * t / (area * torch.clamp_min(denom.abs(), 1e-8)), 0.0)
        total = total + pdf_l
    return total / float(max(L, 1))


def pick_light(scene: S.Scene, u_sel, ua, ub):
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


def scene_env(scene: S.Scene, cfg, occlude=None) -> BounceEnv:
    """The BounceEnv of a bounce on `scene` under `cfg`, with the shadow
    query `occlude` (None: deferred to the caller, see BounceResult)."""
    return BounceEnv(
        mat_present=scene.mat_present,
        num_lights=scene.num_lights,
        mis_bsdf_weight=cfg.mis_bsdf_weight,
        rr_start_depth=cfg.rr_start_depth,
        sky_gate=scene.sky_light,
        unit_ball=sm.unit_ball,
        light_pdf_at=functools.partial(light_pdf_at, scene),
        pick_light=functools.partial(pick_light, scene),
        occlude=occlude,
        estimator=cfg.estimator,
        light_pdf_dir=functools.partial(light_pdf_dir, scene),
    )


def finish_nee(radiance: Vec3, nee: Vec3, shadow_tmax, occluded) -> Vec3:
    """The radiance after NEE: `radiance + nee` where the lane's shadow
    query was active (tmax above -BIG) and found no occluder, rounded as
    `bounce_core`'s own add."""
    return V.where((shadow_tmax > -BIG) & ~occluded, radiance + nee,
                   radiance)


def bounce_core(env: BounceEnv, U, depth, alive, o: Vec3, d: Vec3, time,
                thr: Vec3, rad: Vec3, prev_pdf, prev_diffuse,
                miss, point: Vec3, nrm: Vec3, mat_type, fuzz, eta,
                albedo: Vec3, prim_idx) -> BounceResult:
    """One wavefront bounce after the trace: miss shade, material scatter,
    NEE + MIS, advance, Russian roulette.  U: [n_slots, N] uniforms indexed
    by utils.rng slot ids; all other planes [N].  `time` is in the
    reference's signature; the executors bind it into `env.occlude`.  With
    `env.occlude` None the shadow query is deferred: the result carries it
    and the radiance before NEE (BounceResult)."""
    del time
    check_estimator(env.estimator)
    n = mat_type.shape[0]
    dev = mat_type.device
    hit_alive = alive & ~miss
    rays_lane = alive.to(torch.int32)
    radiance = rad

    # ----- miss: sky gradient or black ------------------------------------
    d_unit = d.normalized()
    sky_t = 0.5 * (d_unit.y + 1.0)
    sky = Vec3((1.0 - 0.5 * sky_t) * env.sky_gate,
               (1.0 - 0.3 * sky_t) * env.sky_gate,
               torch.ones_like(sky_t) * env.sky_gate)
    radiance = V.where(alive & miss, radiance + thr * sky, radiance)

    mp = env.mat_present
    false_n = torch.zeros(n, dtype=torch.bool, device=dev)
    zero3 = V.zeros(n, dev)
    ones3 = V.ones(n, dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)

    def is_mat(m):
        return (mat_type == m) if mp[m] else false_n

    is_lamb = is_mat(S.MAT_LAMBERTIAN)
    is_metal = is_mat(S.MAT_METAL)
    is_diel = is_mat(S.MAT_DIELECTRIC)
    is_light = is_mat(S.MAT_DIFFUSE_LIGHT)
    is_iso = is_mat(S.MAT_ISOTROPIC)
    is_norm = is_mat(S.MAT_NORMAL)

    scatter_dir = d_unit  # placeholder for lanes that terminate anyway
    attenuation = albedo
    cancel = false_n
    terminate = false_n

    # ----- lambertian: cosine-hemisphere scatter --------------------------
    if mp[S.MAT_LAMBERTIAN] and env.book:
        # the books' mixture: the next ray itself from 0.5 cosine + 0.5
        # light-area sampling, the reflectance weighted by
        # scattering_pdf / mixture_pdf
        ou, ov, ow = sm.build_onb(nrm)
        local = sm.cosine_direction(U[R.U_SCATTER_0], U[R.U_SCATTER_1])
        cos_dir = sm.onb_local(ou, ov, ow, local).normalized()
        lpos, _, _, _ = env.pick_light(
            U[R.U_LIGHT_SELECT], U[R.U_LIGHT_A], U[R.U_LIGHT_B])
        ldir = lpos - point
        ldir_u = ldir * (1.0 / torch.clamp_min(ldir.length(), 1e-12))
        take_light = U[R.U_DIELECTRIC] < 0.5     # a slot lambertian skips
        lamb_dir = V.where(take_light, ldir_u, cos_dir)
        cos_pdf = torch.clamp_min(nrm.dot(lamb_dir), 0.0) * sm.INV_PI
        lgt_pdf = env.light_pdf_dir(point, lamb_dir, hit_alive & is_lamb)
        lamb_pdf = 0.5 * cos_pdf + 0.5 * lgt_pdf
        lamb_cancel = (lamb_pdf <= 0.0) | (cos_pdf <= 0.0)
        pdf_safe = torch.where(lamb_cancel, 1.0, lamb_pdf)
        w_mix = torch.where(lamb_cancel, 0.0, cos_pdf / pdf_safe)
        attenuation = V.where(is_lamb, albedo * w_mix, attenuation)
        scatter_dir = V.where(is_lamb, lamb_dir, scatter_dir)
        cancel = cancel | (is_lamb & lamb_cancel)
    elif mp[S.MAT_LAMBERTIAN]:
        ou, ov, ow = sm.build_onb(nrm)
        local = sm.cosine_direction(U[R.U_SCATTER_0], U[R.U_SCATTER_1])
        lamb_dir = sm.onb_local(ou, ov, ow, local).normalized()
        lamb_pdf = local.z * sm.INV_PI
        lamb_scatter_pdf = nrm.dot(lamb_dir) * sm.INV_PI
        lamb_cancel = (lamb_pdf <= 0.0) | (lamb_scatter_pdf <= 0.0)
        scatter_dir = V.where(is_lamb, lamb_dir, scatter_dir)
        cancel = cancel | (is_lamb & lamb_cancel)
    else:
        lamb_pdf = ones

    # ----- metal: fuzzy mirror --------------------------------------------
    if mp[S.MAT_METAL]:
        refl = V.reflect(d_unit, nrm)
        fuzz_vec = env.unit_ball(U[R.U_SCATTER_0], U[R.U_SCATTER_1],
                                 U[R.U_SCATTER_2])
        metal_dir = (refl + fuzz_vec * fuzz).normalized()
        metal_cancel = metal_dir.dot(nrm) <= 0.0
        scatter_dir = V.where(is_metal, metal_dir, scatter_dir)
        cancel = cancel | (is_metal & metal_cancel)

    # ----- dielectric: Snell + Schlick ------------------------------------
    if mp[S.MAT_DIELECTRIC]:
        outside = d_unit.dot(nrm) < 0.0
        ln = V.where(outside, nrm, -nrm)
        eta_i = torch.where(outside, 1.0, eta)
        eta_t = torch.where(outside, eta, 1.0)
        ratio = eta_i / eta_t
        cos_i = torch.clamp_max((-d_unit).dot(ln), 1.0)
        sin_i = sm.safe_sqrt(1.0 - cos_i * cos_i)
        tir = ratio * sin_i > 1.0
        reflect_prob = sm.fresnel_schlick(cos_i, eta_i, eta_t)
        do_reflect = tir | (U[R.U_DIELECTRIC] < reflect_prob)
        sin_t = torch.clamp_max(ratio * sin_i, 1.0)
        cos_t = sm.safe_sqrt(1.0 - sin_t * sin_t)
        refr_dir = (d_unit + ln * cos_i) * ratio - ln * cos_t
        diel_dir = V.where(do_reflect, V.reflect(d_unit, ln), refr_dir)
        scatter_dir = V.where(is_diel, diel_dir, scatter_dir)
        attenuation = V.where(is_diel, ones3, attenuation)

    # ----- isotropic: uniform sphere scatter ------------------------------
    if mp[S.MAT_ISOTROPIC]:
        iso_dir = sm.sphere_surface(U[R.U_SCATTER_0], U[R.U_SCATTER_1])
        scatter_dir = V.where(is_iso, iso_dir, scatter_dir)

    # ----- diffuse light: one-sided emission, terminate -------------------
    if mp[S.MAT_DIFFUSE_LIGHT]:
        facing = nrm.dot(d_unit) < 0.0
        emitted = V.where(facing, albedo, zero3)
        if env.mis_weight:
            w_mask = hit_alive & is_light & prev_diffuse
            lp = env.light_pdf_at(o, point, d_unit, prim_idx, w_mask)
            prev_safe = torch.where(w_mask, prev_pdf, 1.0)
            w_bsdf = torch.where(w_mask, sm.power_heuristic(prev_safe, lp),
                                 1.0)
        else:
            w_bsdf = ones
        radiance = V.where(hit_alive & is_light,
                           radiance + thr * emitted * w_bsdf, radiance)
        attenuation = V.where(is_light, zero3, attenuation)
        terminate = terminate | is_light

    # ----- normal-debug: terminate with normal color ----------------------
    if mp[S.MAT_NORMAL]:
        radiance = V.where(hit_alive & is_norm,
                           radiance + thr * (nrm * 0.5 + 0.5), radiance)
        attenuation = V.where(is_norm, zero3, attenuation)
        terminate = terminate | is_norm

    terminate = terminate | cancel

    # ----- next-event estimation (none under "book": light sampling is the
    # scatter) --------------------------------------------------------------
    if env.nee:
        lpos, l_area, l_nrm, l_emission = env.pick_light(
            U[R.U_LIGHT_SELECT], U[R.U_LIGHT_A], U[R.U_LIGHT_B])
        ldir = lpos - point
        ldist = ldir.length()
        ldir_u = ldir * (1.0 / torch.clamp_min(ldist, 1e-12))
        costa = (-ldir_u).dot(l_nrm)
        l_valid = (ldist > 1e-6) & (costa > 1e-6)
        costa_safe = torch.where(l_valid, costa, 1.0)
        # selection-inclusive pdf (uniform 1/L light x uniform area)
        l_pdf = torch.where(
            l_valid,
            ldist * ldist / (float(env.num_lights) * l_area * costa_safe),
            0.0)
        bsdf_pdf = torch.clamp_min(ldir_u.dot(nrm), 0.0) * sm.INV_PI

        nee_active = (hit_alive & is_lamb & ~cancel
                      & l_valid & (bsdf_pdf > 0.0))
        rays_lane = rays_lane + nee_active.to(torch.int32)
        shadow_org = sm.offset_point(point, nrm, ldir_u)
        occ_tmax = torch.where(nee_active, ldist * float(np.float32(0.999)),
                               -BIG)
        l_pdf_safe = torch.where(nee_active, l_pdf, 1.0)
        bsdf_safe = torch.where(nee_active, bsdf_pdf, 1.0)
        w_nee = sm.power_heuristic(l_pdf_safe, bsdf_safe)
        nee_s = (w_nee * torch.clamp_min(ldir_u.dot(nrm), 0.0) * sm.INV_PI
                 / l_pdf_safe)
        nee_term = thr * (albedo * l_emission * nee_s)
        shadow = dict(shadow_org=shadow_org, shadow_dir=ldir_u,
                      shadow_tmax=occ_tmax, nee=nee_term)
        if env.occlude is not None:
            shadowed = env.occlude(shadow_org, ldir_u, occ_tmax, nee_active)
            radiance = finish_nee(radiance, nee_term, occ_tmax, shadowed)
    else:
        shadow = {}

    # ----- advance ---------------------------------------------------------
    new_alive = hit_alive & ~terminate
    next_org = V.where(is_iso, point,
                       sm.offset_point(point, nrm, scatter_dir))
    origin = V.where(hit_alive, next_org, o)
    direction = V.where(new_alive, scatter_dir, d)
    throughput = V.where(new_alive, thr * attenuation, thr)

    # ----- russian roulette ------------------------------------------------
    rr_on = depth >= env.rr_start_depth
    p_cont = throughput.max_component()
    kill = U[R.U_RR] > p_cont
    alive_out = new_alive & ~(rr_on & kill)
    rr_scale = torch.where(rr_on & ~kill & new_alive,
                           1.0 / torch.clamp_min(p_cont, 1e-12), 1.0)
    throughput = throughput * rr_scale

    prev_pdf = torch.where(new_alive & is_lamb, lamb_pdf, prev_pdf)
    prev_diffuse = (new_alive & is_lamb) | (~new_alive & prev_diffuse)

    return BounceResult(origin=origin, direction=direction,
                        throughput=throughput, radiance=radiance,
                        alive=alive_out, prev_pdf=prev_pdf,
                        prev_diffuse=prev_diffuse, rays_lane=rays_lane,
                        **shadow)
