"""One path per (pixel, sample) lane, in plain torch: the benchmark's
reference render of chosen pixels.

Each lane draws the "fast" stream keyed by (seed, pixel, sample, bounce,
slot), so the reference traces the samples the program is asked to trace,
whatever order or schedule the program traces them in.  A lane is traced
until its path ends or reaches `cfg.max_depth` bounces; each bounce is a
nearest-hit sweep over every primitive (`intersect.intersect_scene`), the
shading record, the albedo, and `bounce.bounce_core` with its shadow query
answered by the plain any-hit sweep (`intersect.occluded`).  A pixel's
value is the float32 sum of its samples' radiance (NaN and inf scrubbed
to 0 per sample) divided by the float32 sample count, as the program's
image is.

`round_to` runs the control: the same paths with the carried state (ray
origin, direction, throughput, radiance) and each sample's radiance
rounded to that dtype after the camera and after every bounce.

`Counts` collects what the paths did, on the lanes' device: the camera
rays, the rays traced at each bounce, the hits by primitive kind and by
material, and the shadow queries.  `harness/work.py` scales them to the
image for the bound of a render.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import intersect as I
from . import rng as R
from . import sampling as sm
from . import scene as S
from . import vec as V
from .bounce import PathState, bounce_core, scene_env
from .intersect import BIG, fma
from .shading import gather_shade, resolve_albedo, tex_row
from .vec import Vec3

N_PRIM_KINDS = 6
N_MAT_KINDS = 6


class Counts:
    """Counters of the reference's paths (int64 on `device`)."""

    def __init__(self, device):
        def z(n=1):
            return torch.zeros(n, dtype=torch.int64, device=device)
        self.paths = z()
        self.traced = z()
        self.shadow = z()
        self.hits_by_prim = z(N_PRIM_KINDS)
        self.hits_by_mat = z(N_MAT_KINDS)

    def as_dict(self) -> dict:
        """The counts as Python ints and lists of ints."""
        return {"paths": int(self.paths), "traced": int(self.traced),
                "shadow": int(self.shadow),
                "hits_by_prim": [int(x) for x in self.hits_by_prim],
                "hits_by_mat": [int(x) for x in self.hits_by_mat]}


def camera_rays(scene: S.Scene, cfg, pixel_idx, path_keys) -> PathState:
    """Thin-lens primary rays, rounded as the reference's compiled code
    rounds them (the division by the image size a product with the f32
    reciprocal, folded into the camera vector; the products fused)."""
    cam = scene.camera
    u = R.camera_uniforms(path_keys, cfg.rng)
    sx = (pixel_idx % cfg.nx).to(torch.float32) + u[0]
    sy = (pixel_idx // cfg.nx).to(torch.float32) + u[1]
    rdx, rdy = sm.unit_disk(u[2], u[3])
    rdx = cam.lens_radius * rdx
    rdy = cam.lens_radius * rdy
    origin = V.v3(cam.origin) + V.v3(cam.u) * rdx + V.v3(cam.v) * rdy
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
        origin=origin, direction=direction, throughput=V.ones(n, dev),
        radiance=V.zeros(n, dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev), time=time,
        prev_pdf=torch.ones(n, dtype=torch.float32, device=dev),
        prev_diffuse=torch.zeros(n, dtype=torch.bool, device=dev))


def _occlude(scene, cfg, time, occ_u, shadow_org, ldir_u, occ_tmax, want):
    del want
    return I.occluded(scene, shadow_org, ldir_u, cfg.shadow_eps, occ_tmax,
                      time, occ_u)


def bounce(scene: S.Scene, cfg, path_keys, state: PathState, depth: int,
           counts: Counts | None = None) -> PathState:
    """One bounce of every lane: trace, shade, NEE with its shadow query,
    Russian roulette."""
    nv = max(scene.n_vol, 1)
    row = tex_row(scene, cfg)
    n_slots = R.NUM_FIXED_SLOTS + 2 * nv + (1 if row >= 0 else 0)
    U = R.bounce_uniforms(path_keys, depth + 1, n_slots, cfg.rng)
    vol_u = U[R.NUM_FIXED_SLOTS: R.NUM_FIXED_SLOTS + nv]
    occ_u = U[R.NUM_FIXED_SLOTS + nv: R.NUM_FIXED_SLOTS + 2 * nv]
    tex_u = U[row] if row >= 0 else None
    o, d = state.origin, state.direction
    tmax_lane = torch.where(state.alive, float(np.float32(cfg.t_max)), -BIG)
    hit = I.intersect_scene(scene, o, d, cfg.t_min, tmax_lane, state.time,
                            vol_u)
    shade = gather_shade(scene, hit.prim_idx, hit.prim_idx >= 0)
    albedo = resolve_albedo(scene, shade, hit.point, hit.u, hit.v,
                            cfg.tex_filter, cfg.tex_tile_gate, tex_u)
    env = scene_env(scene, cfg, functools.partial(
        _occlude, scene, cfg, state.time, occ_u))
    res = bounce_core(env, U, depth, state.alive, o, d, state.time,
                      state.throughput, state.radiance, state.prev_pdf,
                      state.prev_diffuse, hit.prim_idx < 0, hit.point,
                      hit.normal, shade.mat_type, shade.fuzz, shade.eta,
                      albedo, hit.prim_idx)
    if counts is not None:
        hit_alive = state.alive & (hit.prim_idx >= 0)
        safe = torch.clamp_min(hit.prim_idx, 0)
        kind = scene.prims.prim_type[safe].to(torch.int64)
        counts.traced += state.alive.sum(dtype=torch.int64)
        counts.shadow += (res.rays_lane.to(torch.int64)
                          - state.alive.to(torch.int64)).sum()
        counts.hits_by_prim += torch.bincount(
            kind[hit_alive], minlength=N_PRIM_KINDS)[:N_PRIM_KINDS]
        counts.hits_by_mat += torch.bincount(
            shade.mat_type.to(torch.int64)[hit_alive],
            minlength=N_MAT_KINDS)[:N_MAT_KINDS]
    return PathState(origin=res.origin, direction=res.direction,
                     throughput=res.throughput, radiance=res.radiance,
                     alive=res.alive, time=state.time, prev_pdf=res.prev_pdf,
                     prev_diffuse=res.prev_diffuse)


def _rounded(state: PathState, dtype) -> PathState:
    def r(v):
        return Vec3(*(c.to(dtype).to(torch.float32) for c in v))
    return state._replace(origin=r(state.origin),
                          direction=r(state.direction),
                          throughput=r(state.throughput),
                          radiance=r(state.radiance))


def path_keys(cfg, seeds, pixel_idx, sample_idx):
    """Each lane's path key for its own seed (`seeds`: an int, or int64
    [N] per lane): the "fast" stream's hash computed per lane, the same
    function as `rng.pixel_sample_hash`; the other streams by seed."""
    if not torch.is_tensor(seeds):
        return R.make_path_keys(seeds, pixel_idx, sample_idx, cfg.rng)
    if cfg.rng == "fast":
        inner = R.pcg_hash(seeds & R.MASK32)
        h0 = R.pcg_hash(inner + ((seeds >> 32) & R.MASK32))
        return R.pcg_hash(R.pcg_hash(sample_idx + h0) + pixel_idx)
    keys = None
    for s in torch.unique(seeds).tolist():
        m = seeds == s
        k = R.make_path_keys(int(s), pixel_idx[m], sample_idx[m], cfg.rng)
        if keys is None:
            keys = torch.zeros((*k.shape[:-1], seeds.shape[0]),
                               dtype=k.dtype, device=k.device)
        keys[..., m] = k
    return keys


def trace_samples(scene: S.Scene, cfg, seed, pixel_idx, sample_idx,
                  counts: Counts | None = None, round_to=None):
    """Radiance [N, 3] of sample `sample_idx[i]` of pixel `pixel_idx[i]`
    (int64 [N] each) rendered with `seed` (an int, or int64 [N] per
    lane), NaN and inf scrubbed to 0."""
    keys = path_keys(cfg, seed, pixel_idx, sample_idx)
    state = camera_rays(scene, cfg, pixel_idx, keys)
    if round_to is not None:
        state = _rounded(state, round_to)
    if counts is not None:
        counts.paths += pixel_idx.shape[0]
    for depth in range(cfg.max_depth):
        if not bool(state.alive.any()):
            break
        state = bounce(scene, cfg, keys, state, depth, counts)
        if round_to is not None:
            state = _rounded(state, round_to)
    rad = torch.stack([torch.where(torch.isfinite(c), c, 0.0)
                       for c in state.radiance], dim=1)
    if round_to is not None:
        rad = rad.to(round_to).to(torch.float32)
    return rad


def render_pixels(scene: S.Scene, cfg, seed, pixels, counts=None,
                  round_to=None, lanes_per_block: int = 1 << 20):
    """The image value [P, 3] of each pixel in `pixels` (int64 [P], on the
    scene's device) of a `cfg.spp`-sample render with `seed` (an int, or
    int64 [P]: each pixel's render seed): the mean of its samples.  The
    lanes go in blocks of whole pixels, at most `lanes_per_block` (or one
    pixel's samples) a block."""
    spp = cfg.spp
    per_block = max(1, lanes_per_block // spp)
    out = []
    for b0 in range(0, pixels.shape[0], per_block):
        pix = pixels[b0:b0 + per_block]
        lane_pix = pix.repeat_interleave(spp)
        lane_seed = (seed[b0:b0 + per_block].repeat_interleave(spp)
                     if torch.is_tensor(seed) else seed)
        lane_smp = torch.arange(spp, dtype=torch.int64,
                                device=pix.device).repeat(pix.shape[0])
        rad = trace_samples(scene, cfg, lane_seed, lane_pix, lane_smp,
                            counts, round_to)
        acc = rad.reshape(pix.shape[0], spp, 3).sum(dim=1)
        if round_to is not None:
            acc = acc.to(round_to).to(torch.float32)
        out.append(acc / float(np.float32(spp)))
    return torch.cat(out)
