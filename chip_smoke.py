#!/usr/bin/env python3
"""Chip smoke test of the rtw_tpu_torch port on one CUDA card.

    python3 chip_smoke.py [--spp N] [--profile]

Builds the CUDA kernels from the checkout's sources (one nvcc per source,
all at once) and holds each against its plain torch version on the card.
Then it drives the port's paths through `render`:

- the megakernel path: the Cornell box, 800x800, depth 20, `--spp`
  samples (default 64; `--spp 1000` is bench.py's workload), and scene 3
  (volumes) at tools/bench_scenes.py's 400x400, 32 spp, depth 20;
- the split tier: scenes 1, 2 (800x400, 16 spp, depth 20) and 4 (800x400,
  8 spp, depth 20) on the work queue with the trace and occlusion kernels;
- scheduler="qmega": scene 1 at 800x400, 16 spp, depth 20 on the work
  queue with the megakernel's hybrid mode;

and checks that each path launched its kernels.  `--profile` adds a
torch.profiler breakdown of one scene-2 and one scene-4 render.  Each
phase prints one line; any failure raises, so the run exits non-zero and
prints no result.  With no CUDA device it exits 1.

The line before the last is `nvidia-smi`'s name and power limit of the
card; before it, one JSON object has an entry for each kernel on each
path, with that path's own launch count; the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

BENCH_NX = BENCH_NY = 800
BENCH_DEPTH = 20
# tools/bench_scenes.py's workloads: scene -> (nx, ny, spp)
SCENE3_WORKLOAD = (400, 400, 32)
SPLIT_WORKLOADS = {1: (800, 400, 16), 2: (800, 400, 16), 4: (800, 400, 8)}
QMEGA_SCENE = 1
SPLIT_LANES = 800 * 400
# the card's published peaks (NVIDIA's data sheet, H100 SXM at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations of one prim test by prim type (intersect.py's arithmetic:
# sphere 0 quadratic, moving sphere 2 = centre lerp + quadratic, rect 1
# plane, box 5 slab; the volume sphere 3 and volume box 4 are the sphere's
# quadratic or the box's slab plus _volume_t's 40: |d| 7, the boundary
# clamps 5, the flight 5 with its log at ~20, the test and t 3), of the
# world->object transform of a ray, of a block's AABB slab test, and of the
# winner's payload (point, normal, uv, with atan2 and asin at ~20
# operations each)
PRIM_FLOPS = {0: 30, 2: 42, 1: 14, 5: 33, 3: 70, 4: 73}
XFORM_FLOPS = 33
SLAB_FLOPS = 33
PAYLOAD_FLOPS = 100
# scene -> (lo, hi) of the random ray origins of phase 6
SPLIT_BOXES = {0: ((0.0, 0.0, 0.0), (555.0, 555.0, 555.0)),
               1: ((-13.0, 0.0, -13.0), (13.0, 3.0, 13.0)),
               2: ((-13.0, 0.0, -13.0), (13.0, 3.0, 13.0)),
               5: ((-2.0, -0.5, -2.0), (2.0, 1.5, 1.0)),
               # the union of the block AABBs, without scene 4's radius-500
               # fog and its ground boxes' outer reach
               3: ((0.0, 0.0, 0.0), (555.0, 555.0, 555.0)),
               4: ((-100.0, 0.0, -25.0), (600.0, 555.0, 600.0))}


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                          check=True)
    return proc.stdout.strip()


def _fmt(v) -> str:
    return "[" + ", ".join(f"{x:.5f}" for x in v) + "]"


def card_line() -> str:
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]


def phase_device():
    from rtw_tpu_torch.utils import kernels

    nvcc = _run([kernels.nvcc_path(), "--version"]).splitlines()[-1]
    print(f"[1 device] {card_line()} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {nvcc}", flush=True)


def phase_build():
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.ops import trace_kernel as TK
    from rtw_tpu_torch.utils import kernels

    t0 = time.perf_counter()
    kernels.build_all(["mega_kernel", "trace_kernel"])
    MK.library()
    TK.library()
    secs = time.perf_counter() - t0
    for name in ("mega_kernel", "trace_kernel"):
        regs = kernels.ptxas_summary(name).replace("\n", " | ")
        print(f"[2 build] {name}.cu (nvcc "
              f"{kernels.build_seconds.get(name, 0.0):.2f} s); ptxas: {regs}",
              flush=True)
    print(f"[2 build] both built in parallel and loaded in {secs:.2f} s",
          flush=True)


def _carry_after(scene, cfg, steps):
    """(params, sf, si) after `steps` kernel iterations from the start."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    pix = torch.arange(cfg.num_pixels, dtype=torch.int32, device="cuda")
    sf, si = MK.init_carry(pix, 0)
    params = MK.mega_params(scene, cfg.seed, cfg, cfg.spp)
    rays = torch.zeros(1, dtype=torch.int64, device="cuda")
    for _ in range(steps):
        sf, si = MK.mega_step(scene, cfg, sf, si, params, rays)
    return params, sf, si


# A lane traces at most this many queries per iteration (bounce + NEE
# shadow ray), so lanes that took another path bound the ray-count gap.
RAYS_PER_LANE = 2


def _compare_step(label, scene, cfg, params, sf, si, tol=1e-3,
                  min_equal=0.999, hybrid=False):
    """One kernel step against one plain step from the same carry (in
    hybrid mode with `hybrid`).  i32 rows equal on >= 99.9% of lanes, f32
    rows within atol/rtol 1e-3 on those lanes, ray counts equal up to the
    lanes that differ: libm differences (cbrtf vs powf, sinf vs torch's sin)
    and near-tie winner flips may move a few lanes onto another path.
    Returns (max abs diff, report)."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    rk = torch.zeros(1, dtype=torch.int64, device="cuda")
    rp = torch.zeros_like(rk)
    k_sf, k_si = MK.mega_step(scene, cfg, sf, si, params, rk, hybrid)
    p_sf, p_si = MK.mega_step_plain(scene, cfg, sf, si, params, rp, hybrid)
    torch.cuda.synchronize()
    same = (k_si == p_si).all(dim=0)
    n_diff = int((~same).sum())
    frac = 1.0 - n_diff / same.numel()
    err = (k_sf - p_sf).abs()[:, same]
    bound = tol + tol * p_sf.abs()[:, same]
    max_err = float(err.max()) if err.numel() else 0.0
    ray_gap = abs(int(rk) - int(rp))
    report = (f"{label}: lanes equal {frac:.6f} ({n_diff} differ), f32 max "
              f"abs diff {max_err:.3e}, rays {int(rk)} vs {int(rp)}")
    if not bool(torch.isfinite(k_sf).all()):
        raise AssertionError(f"{report}: non-finite kernel carry")
    if frac < min_equal:
        raise AssertionError(f"{report}: i32 rows equal on fewer than "
                             f"{min_equal} of lanes")
    if not bool((err <= bound).all()):
        raise AssertionError(f"{report}: f32 rows beyond atol/rtol {tol}")
    if ray_gap > RAYS_PER_LANE * n_diff:
        raise AssertionError(f"{report}: ray counts differ by more than "
                             f"{RAYS_PER_LANE} per differing lane")
    return max_err, report


def phase_one_step():
    """Kernel step against plain step at 64x48, carry after 3 steps."""
    import rtw_tpu_torch as rtt

    worst = 0.0
    parts = []
    for sid in (0, 5, 3):
        cfg = rtt.RenderConfig(nx=64, ny=48, spp=4, max_depth=10,
                               scene_id=sid)
        scene = rtt.build_scene(sid, cfg.nx, cfg.ny, device="cuda")
        params, sf, si = _carry_after(scene, cfg, 3)
        err, report = _compare_step(f"scene {sid}", scene, cfg, params, sf,
                                    si)
        worst = max(worst, err)
        parts.append(report)
    print("[3 one step] " + "; ".join(parts), flush=True)
    return worst


@contextlib.contextmanager
def _plain_mega():
    """`mega_step` replaced by its plain twin while the block runs: the same
    scheduler on the same carry, each step in plain torch on the card."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    kernel = MK.mega_step
    MK.mega_step = (lambda scene, cfg, sf, si, params, rays, hybrid=False:
                    MK.mega_step_plain(scene, cfg, sf, si, params, rays,
                                       hybrid))
    try:
        yield
    finally:
        MK.mega_step = kernel


def phase_small_render():
    """Kernel render (auto) against the same render with the plain twin on
    the card, 128x128, 16 spp, depth 10: channel means within rtol 0.02 /
    atol 0.003, rays within 0.5%; scene 3 (volumes) equal rays and every
    pixel within 1e-4."""
    import rtw_tpu_torch as rtt

    parts = []
    for sid in (0, 5, 3):
        cfg = rtt.RenderConfig(nx=128, ny=128, spp=16, max_depth=10,
                               scene_id=sid)
        scene = rtt.build_scene(sid, cfg.nx, cfg.ny, device="cuda")
        mk, mp = {}, {}
        img_k = rtt.render(scene, cfg, metrics=mk)
        with _plain_mega():
            img_p = rtt.render(scene, cfg, metrics=mp)
        if not bool(torch.isfinite(img_k).all()):
            raise AssertionError(f"scene {sid}: non-finite kernel image")
        mean_k = img_k.reshape(-1, 3).mean(0).cpu().numpy()
        mean_p = img_p.reshape(-1, 3).mean(0).cpu().numpy()
        np.testing.assert_allclose(mean_k, mean_p, rtol=0.02, atol=0.003)
        rel = abs(mk["rays"] - mp["rays"]) / mp["rays"]
        if rel > 0.005:
            raise AssertionError(f"scene {sid}: rays {mk['rays']} vs "
                                 f"{mp['rays']}")
        px = float(((img_k - img_p).abs() <= 1e-4 + 1e-4 * img_p.abs())
                   .all(-1).float().mean())
        report = (f"scene {sid}: means {_fmt(mean_k)} vs {_fmt(mean_p)}, "
                  f"rays {mk['rays']} vs {mp['rays']}, pixels within 1e-4: "
                  f"{px:.4f}")
        if sid == 3 and (mk["rays"] != mp["rays"] or px < 1.0):
            raise AssertionError(f"{report}: scene 3 needs equal rays and "
                                 "every pixel within 1e-4")
        parts.append(report)
    print("[4 small render] " + "; ".join(parts), flush=True)


def _time_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _turns(kernel, plain):
    """(kernel ms, plain ms, report): CUDA-event times in turns, plain,
    kernel, kernel, plain, each the mean of its reps."""
    plain(), kernel()
    p1 = _time_ms(plain, 5)
    k1 = _time_ms(kernel, 50)
    k2 = _time_ms(kernel, 50)
    p2 = _time_ms(plain, 5)
    return ((k1 + k2) / 2, (p1 + p2) / 2,
            f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")


def _mega_bound(scene, sf, si):
    """Bound of one megakernel step: the carry read and written once (17
    f32 + 5 i32 rows each way), or the f32 work of the alive lanes: the
    nearest-hit sweep over every prim, the shadow ray's where the scene has
    a light, and ~300 operations of shading."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    n = sf.shape[1]
    n_alive = int((si[MK.I_ALIVE] > 0).sum())
    sweep = sum(e[1] * PRIM_FLOPS[e[3]] + e[1] * XFORM_FLOPS * e[5]
                for e in scene.chunk_plan)
    sweeps = 1 + (scene.num_lights > 0)
    return _bound(2 * (MK.NF + MK.NI) * 4 * n,
                  n_alive * (sweeps * sweep + 300))


def _mega_path(label, sid, nx, ny, spp):
    """A megakernel path through `render` (warm-up with the identical
    config, then timed with the launch count set to 0 just before it), then
    kernel against plain at its width and depth from one mid-render carry
    (after 10 iterations) and the per-iteration step times from that
    carry."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import mega_kernel as MK

    cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                           scene_id=sid)
    scene = rtt.build_scene(sid, nx, ny, device="cuda")
    rtt.render(scene, cfg)                    # warm-up, identical config
    m = {}
    MK.launches = 0
    img = rtt.render(scene, cfg, metrics=m)
    launches = MK.launches
    if launches <= 0:
        raise AssertionError(f"{label}: no mega_step kernel launched")
    if tuple(img.shape) != (cfg.ny, cfg.nx, 3):
        raise AssertionError(f"{label}: image has shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: non-finite image")
    mean = img.reshape(-1, 3).mean(0).cpu().numpy()
    print(f"[{label}] scene {sid} {nx}x{ny} spp {spp} depth "
          f"{cfg.max_depth}: {m['wall_seconds']:.3f} s, {m['rays']} rays, "
          f"{m['mrays_per_sec']:.2f} Mrays/s, {launches} launches, mean "
          f"{_fmt(mean)} on {card_line()}", flush=True)

    params, sf, si = _carry_after(scene, cfg, 10)
    err, report = _compare_step(f"scene {sid} {cfg.num_pixels} lanes, carry "
                                f"after 10 iterations", scene, cfg, params,
                                sf, si)
    print(f"[{label} step check] {report}", flush=True)
    rays = torch.zeros(1, dtype=torch.int64, device="cuda")
    ms, plain_ms, times = _turns(
        lambda: MK.mega_step(scene, cfg, sf, si, params, rays),
        lambda: MK.mega_step_plain(scene, cfg, sf, si, params, rays))
    bound = _mega_bound(scene, sf, si)
    print(f"[{label} step times] {cfg.num_pixels} lanes, carry after 10 "
          f"iterations: {times} per iteration; bound {bound[0]:.4f} ms "
          f"({bound[1]}); wall per launch "
          f"{m['wall_seconds'] * 1e3 / launches:.4f} ms", flush=True)
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None)


def phase_main(spp: int):
    """The main path: the Cornell box at 800x800, depth 20."""
    return _mega_path("5 main path", 0, BENCH_NX, BENCH_NY, spp)


def phase_scene3():
    """Scene 3 (a volume sphere and a transformed volume box, sky, no
    light) on the megakernel path at bench_scenes' workload."""
    return _mega_path("11 scene 3 path", 3, *SCENE3_WORKLOAD)


def _bound(n_bytes, n_flops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over its memory rate and the f32 operations
    over its peak f32 rate."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_f = n_flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _split_work(scene, o, d, tmin, tmax, time, vol_u, nearest):
    """f32 operations the split kernel needs for these rays, counted by
    replaying its traversal in plain torch.  Only live lanes (tmax > tmin)
    count: a dead lane's answer (a miss, not occluded) needs no test.  Each
    live lane's slab test of each block it reaches, the prim tests of the
    blocks it cannot cull (the nearest-hit cull tightens with the best t so
    far; an any-hit lane stops at its first hit), and the payload of each
    lane that hits."""
    from rtw_tpu_torch.ops import intersect as I

    n = o.x.shape[0]
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=o.x.device).expand(n)
    live = tmax > tmin
    best = torch.full((n,), I.BIG, device=o.x.device)
    pending = live.clone()
    inv = [1.0 / torch.where(c == 0.0, 1e-30, c) for c in d]
    flops = 0
    bid = 0
    for entry in scene.chunk_plan:
        start, count, size, ptype, axis, xform, block = entry
        per = PRIM_FLOPS[ptype] + XFORM_FLOPS * int(xform)
        for b0, t_mat in I._block_ts(scene, entry, o, d, tmin, tmax, time,
                                     vol_u):
            ab = scene.block_aabbs[bid]
            near = torch.full_like(best, -I.BIG)
            far = torch.full_like(best, I.BIG)
            for ax in range(3):
                t0 = (ab[ax] - o[ax]) * inv[ax]
                t1 = (ab[3 + ax] - o[ax]) * inv[ax]
                near = torch.maximum(near, torch.minimum(t0, t1))
                far = torch.minimum(far, torch.maximum(t0, t1))
            active = ((far >= torch.clamp_min(near, tmin)) & (near < tmax)
                      & live)
            rows = min(block, start + count - b0)
            hits = t_mat[:rows] < I.BIG
            if nearest:
                flops += SLAB_FLOPS * int(live.sum())
                active &= near < best
                flops += per * rows * int(active.sum())
                best = torch.minimum(best, torch.where(
                    active, t_mat.min(dim=0).values, I.BIG))
            else:
                flops += SLAB_FLOPS * int(pending.sum())
                active &= pending
                first = torch.where(hits.any(0), hits.int().argmax(0) + 1,
                                    rows)
                flops += per * int(first[active].sum())
                pending &= ~(active & hits.any(0))
            bid += 1
    if nearest:
        flops += PAYLOAD_FLOPS * int((best < I.BIG).sum())
    return flops


def _split_bound(scene, tables, args, nearest):
    """Bound of one launch: each ray's 32 B in and its 104 B (trace) or 1 B
    (occluded) out, the tables read once; the operations of _split_work."""
    n = args[0].x.shape[0]
    n_bytes = (32 + (104 if nearest else 1)) * n + sum(
        t.numel() * t.element_size()
        for t in (tables.props, tables.plan, tables.aabbs))
    return _bound(n_bytes, _split_work(scene, *args, nearest))


def _split_rays(sid, scene, n, seed):
    """n rays on the card: half of them camera rays of an 800x400 frame at
    random pixels and samples, half from random origins in the scene's box
    in random directions; random shutter times in [0, 1)."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.integrator import generate_camera_rays
    from rtw_tpu_torch.ops.vec import Vec3
    from rtw_tpu_torch.utils import rng as R

    g = torch.Generator(device="cuda").manual_seed(seed)
    half = n // 2
    cfg = rtt.RenderConfig(nx=800, ny=400, scene_id=sid)
    pix = torch.randint(0, cfg.num_pixels, (half,), generator=g,
                        device="cuda")
    smp = torch.randint(0, 16, (half,), generator=g, device="cuda")
    cam = generate_camera_rays(scene, cfg, pix, R.make_path_keys(0, pix, smp))
    lo, hi = (torch.tensor(v, device="cuda") for v in SPLIT_BOXES[sid])
    org = lo[:, None] + (hi - lo)[:, None] * torch.rand(
        (3, n - half), generator=g, device="cuda")
    dirs = torch.randn((3, n - half), generator=g, device="cuda")
    o = Vec3(*(torch.cat([c, r]) for c, r in zip(cam.origin, org)))
    d = Vec3(*(torch.cat([c, r]) for c, r in zip(cam.direction, dirs)))
    time = torch.rand(n, generator=g, device="cuda")
    return o, d, time, float((hi - lo).norm())


def _compare_trace(label, scene, tables, args, tol=1e-4, min_equal=0.999):
    """Kernel B against trace_plain on the same rays: prim_idx equal on >=
    99.9% of lanes; t, point, normal, uv and the shade fields within
    atol/rtol `tol` on those lanes (integer fields equal).  Returns (max abs
    diff, report)."""
    from rtw_tpu_torch.ops import trace_kernel as TK

    kh, ks = TK.trace(scene, *args, tables)
    ph, ps = TK.trace_plain(scene, *args)
    torch.cuda.synchronize()

    def f32(h, s):
        return torch.stack([h.t, *h.point, *h.normal, h.u, h.v, s.fuzz, s.eta,
                            s.scale, *s.rgb, *s.odd, *s.even])

    def i32(h, s):
        return torch.stack([h.mat_id, s.mat_type, s.tex_type, s.image_id])

    same = kh.prim_idx == ph.prim_idx
    n_diff = int((~same).sum())
    frac = 1.0 - n_diff / same.numel()
    kf, pf = f32(kh, ks), f32(ph, ps)
    err = (kf - pf).abs()[:, same]
    max_err = float(err.max()) if err.numel() else 0.0
    hit = float((ph.prim_idx >= 0).float().mean())
    report = (f"{label}: prim_idx equal {frac:.6f} ({n_diff} differ), hit "
              f"{hit:.3f}, f32 max abs diff {max_err:.3e}")
    if n_diff:
        idx = torch.nonzero(~same)[:4, 0].tolist()
        report += "; differing lanes " + ", ".join(
            f"{i}: prim {int(kh.prim_idx[i])}/{int(ph.prim_idx[i])} t "
            f"{float(kh.t[i]):.6g}/{float(ph.t[i]):.6g}" for i in idx)
    if not bool(torch.isfinite(kf).all()):
        raise AssertionError(f"{report}: non-finite kernel output")
    if frac < min_equal:
        raise AssertionError(f"{report}: prim_idx equal on fewer than "
                             f"{min_equal} of lanes")
    if not bool((err <= tol + tol * pf.abs()[:, same]).all()):
        raise AssertionError(f"{report}: fields beyond atol/rtol {tol}")
    if not bool((i32(kh, ks) == i32(ph, ps))[:, same].all()):
        raise AssertionError(f"{report}: integer shade fields differ")
    return max_err, report


def _compare_occluded(label, scene, tables, args, min_equal=0.999):
    """Kernel C against occluded_plain: equal on >= 99.9% of lanes.
    Returns (max abs diff of the 0/1 planes, report)."""
    from rtw_tpu_torch.ops import trace_kernel as TK

    k = TK.occluded_kernel(scene, *args, tables)
    p = TK.occluded_plain(scene, *args)
    torch.cuda.synchronize()
    n_diff = int((k != p).sum())
    frac = 1.0 - n_diff / k.numel()
    report = (f"{label}: occluded equal {frac:.6f} ({n_diff} differ), "
              f"occluded share {float(p.float().mean()):.3f}")
    if n_diff:
        report += "; differing lanes " + str(
            torch.nonzero(k != p)[:4, 0].tolist())
    if frac < min_equal:
        raise AssertionError(f"{report}: equal on fewer than {min_equal} "
                             "of lanes")
    return float(n_diff > 0), report


def phase_split_kernels():
    """Kernels B and C against their plain versions on scenes 0, 1, 2, 5, 3
    and 4 (scene 0 for the transformed box, 3 and 4 for the volumes), 320k
    rays each, with random volume uniforms in [0, 1) (the trace's rows and
    the shadow ray's own); every 8th lane is dead (tmax = -BIG)."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import trace_kernel as TK
    from rtw_tpu_torch.ops.intersect import BIG

    worst = {"trace": 0.0, "occluded": 0.0}
    for sid in (0, 1, 2, 5, 3, 4):
        scene = rtt.build_scene(sid, 800, 400, device="cuda")
        tables = TK.split_tables(scene)
        o, d, time, extent = _split_rays(sid, scene, SPLIT_LANES, 100 + sid)
        g = torch.Generator(device="cuda").manual_seed(200 + sid)
        vol_u, occ_u = torch.rand((2, max(scene.n_vol, 1), SPLIT_LANES),
                                  generator=g, device="cuda")
        lane = torch.arange(SPLIT_LANES, device="cuda")
        dead = lane % 8 == 7
        tmax = torch.where(dead, -BIG, 1e27)
        err, rep = _compare_trace(f"B scene {sid}", scene, tables,
                                  (o, d, 1e-6, tmax, time, vol_u))
        worst["trace"] = max(worst["trace"], err)
        print(f"[6 split kernels] {rep}", flush=True)
        occ_tmax = torch.where(dead, -BIG, extent * torch.rand(
            SPLIT_LANES, generator=g, device="cuda"))
        err, rep = _compare_occluded(f"C scene {sid}", scene, tables,
                                     (o, d, 5e-5, occ_tmax, time, occ_u))
        worst["occluded"] = max(worst["occluded"], err)
        print(f"[6 split kernels] {rep}", flush=True)
    return worst


def phase_split_small_render():
    """Scenes 1, 2 and 4 at 128x128, 8 spp, depth 10: `auto` (the queue
    with kernels B and C) against the plain queue (backend="jnp") on the
    card.  Rays equal up to 2 per bounce of a differing pixel's paths, >=
    99.9% of pixels within 1e-4, channel means within rtol 0.02 / atol
    0.003."""
    import dataclasses

    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import trace_kernel as TK

    parts = []
    for sid in (1, 2, 4):
        cfg = rtt.RenderConfig(nx=128, ny=128, spp=8, max_depth=10,
                               scene_id=sid)
        scene = rtt.build_scene(sid, cfg.nx, cfg.ny, device="cuda")
        mk, mp = {}, {}
        n0 = TK.trace_launches
        img_k = rtt.render(scene, cfg, metrics=mk)
        if TK.trace_launches == n0:
            raise AssertionError(f"scene {sid}: auto launched no trace "
                                 "kernel")
        img_p = rtt.render(scene, dataclasses.replace(
            cfg, backend="jnp", scheduler="queue"), metrics=mp)
        if not bool(torch.isfinite(img_k).all()):
            raise AssertionError(f"scene {sid}: non-finite kernel image")
        mean_k = img_k.reshape(-1, 3).mean(0).cpu().numpy()
        mean_p = img_p.reshape(-1, 3).mean(0).cpu().numpy()
        np.testing.assert_allclose(mean_k, mean_p, rtol=0.02, atol=0.003)
        close = ((img_k - img_p).abs() <= 1e-4 + 1e-4 * img_p.abs()).all(-1)
        px = float(close.float().mean())
        n_bad = int((~close).sum())
        gap = abs(mk["rays"] - mp["rays"])
        report = (f"scene {sid}: means {_fmt(mean_k)} vs {_fmt(mean_p)}, "
                  f"rays {mk['rays']} vs {mp['rays']}, pixels within 1e-4: "
                  f"{px:.5f} ({n_bad} outside)")
        if px < 0.999:
            raise AssertionError(f"{report}: fewer than 99.9% of pixels")
        if gap > RAYS_PER_LANE * cfg.max_depth * cfg.spp * n_bad:
            raise AssertionError(f"{report}: ray counts differ by more than "
                                 "the differing pixels' paths can trace")
        parts.append(report)
    print("[7 split small render] " + "; ".join(parts), flush=True)


def phase_split_main():
    """The split tier through `render` at full width: scenes 1, 2 and 4 at
    bench_scenes' workloads, each a path of its own: warm-up with the
    identical config, then the timed render with the launch counts set to
    0 just before it and read just after.  Returns {scene: (trace
    launches, occlusion launches, metrics)}."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import trace_kernel as TK

    counts = {}
    for sid, (nx, ny, spp) in SPLIT_WORKLOADS.items():
        cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                               scene_id=sid)
        scene = rtt.build_scene(sid, nx, ny)       # the default: the card
        rtt.render(scene, cfg)                     # warm-up
        m = {}
        TK.trace_launches = TK.occluded_launches = 0
        img = rtt.render(scene, cfg, metrics=m)
        nt, no = TK.trace_launches, TK.occluded_launches
        if nt <= 0:
            raise AssertionError(f"scene {sid}: the split path launched no "
                                 "trace kernel")
        if scene.num_lights > 0 and no <= 0:
            raise AssertionError(f"scene {sid}: the split path launched no "
                                 "occlusion kernel")
        if tuple(img.shape) != (ny, nx, 3) or not bool(
                torch.isfinite(img).all()):
            raise AssertionError(f"scene {sid}: bad image {tuple(img.shape)}")
        counts[sid] = (nt, no, m)
        mean = img.reshape(-1, 3).mean(0).cpu().numpy()
        print(f"[8 split main path] scene {sid} {nx}x{ny} spp {spp} depth "
              f"{cfg.max_depth}: {m['wall_seconds']:.3f} s, {m['rays']} "
              f"rays, {m['mrays_per_sec']:.2f} Mrays/s, {nt} iterations, "
              f"launches trace {nt} occluded {no}, mean {_fmt(mean)} on "
              f"{card_line()}", flush=True)
    return counts


class _Captured(Exception):
    """Ends a render once every wrapped launch has been recorded."""


def _capture(cfg, wrappers, call=10):
    """{name: arguments} of the `call`-th call of each wrapper, one
    (module, attribute) per name, in a full-width render with `cfg` (the
    queue's wavefront is full then); the render stops there."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops.vec import Vec3

    scene = rtt.build_scene(cfg.scene_id, cfg.nx, cfg.ny)
    got = {}

    def keep(x):
        if isinstance(x, Vec3):
            return Vec3(*(c.clone() for c in x))
        return x.clone() if torch.is_tensor(x) else x

    def recorder(name, fn):
        count = [0]

        def call_it(*args, **kw):
            count[0] += 1
            if count[0] == call:
                got[name] = (tuple(keep(a) for a in args),
                             {k: keep(v) for k, v in kw.items()})
                if len(got) == len(wrappers):
                    raise _Captured
            return fn(*args, **kw)
        return call_it

    orig = {name: getattr(mod, attr)
            for name, (mod, attr) in wrappers.items()}
    for name, (mod, attr) in wrappers.items():
        setattr(mod, attr, recorder(name, orig[name]))
    try:
        rtt.render(scene, cfg)
    except _Captured:
        pass
    finally:
        for name, (mod, attr) in wrappers.items():
            setattr(mod, attr, orig[name])
    return got


def _without_volumes(scene):
    """The scene with its volume groups (and their block AABBs) taken out
    of the chunk plan: the trace kernel's time on it, at the same rays,
    less its time on the whole scene, is the volume tests' share."""
    import dataclasses

    from rtw_tpu_torch.ops.intersect import VOLUME_PRIMS

    plan, rows, bid = [], [], 0
    for e in scene.chunk_plan:
        n_blocks = e[2] // e[6]
        if e[3] not in VOLUME_PRIMS:
            plan.append(e)
            rows += range(bid, bid + n_blocks)
        bid += n_blocks
    return dataclasses.replace(scene, chunk_plan=tuple(plan),
                               block_aabbs=scene.block_aabbs[rows])


def phase_split_step_times():
    """B and C at each split path's shapes: the inputs of the 10th launch
    of a full-width render of scenes 1 (B), 2 and 4 (B and C), 320k lanes,
    kernel against plain, then CUDA-event times in turns: plain, kernel,
    kernel, plain.  On scene 4, B also at the same rays without the volume
    groups, for the volume tests' share.  Returns {(name, scene): row}."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import trace_kernel as TK

    out = {}
    for sid, (nx, ny, spp) in SPLIT_WORKLOADS.items():
        cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                               scene_id=sid)
        wrappers = {"trace": (TK, "trace")}
        if sid != 1:                      # scene 1 has no light: no NEE
            wrappers["occluded"] = (TK, "occluded_kernel")
        got = _capture(cfg, wrappers)
        for name, kern, plain, nearest in (
                ("trace", TK.trace, TK.trace_plain, True),
                ("occluded", TK.occluded_kernel, TK.occluded_plain, False)):
            if name not in got:
                continue
            (scene, *args, tables), _ = got[name]
            args = tuple(args)
            cmp = _compare_trace if nearest else _compare_occluded
            err, rep = cmp(f"{name} scene {sid} at launch 10", scene, tables,
                           args)
            print(f"[9 split step check] {rep}", flush=True)
            ms, plain_ms, times = _turns(
                lambda: kern(scene, *args, tables),
                lambda: plain(scene, *args))
            bound = _split_bound(scene, tables, args, nearest)
            n = args[0].x.shape[0]
            live = int((args[3] > args[2]).sum())
            print(f"[9 split step times] {name} scene {sid}: {n} lanes "
                  f"({live} live), {times}; bound {bound[0]:.4f} ms "
                  f"({bound[1]})", flush=True)
            if nearest and scene.n_vol:
                bare = _without_volumes(scene)
                bare_tables = TK.split_tables(bare)

                def whole():
                    kern(scene, *args, tables)

                def without():
                    kern(bare, *args, bare_tables)

                w1, b1, b2, w2 = (_time_ms(f, 50) for f in
                                  (whole, without, without, whole))
                share = 1.0 - (b1 + b2) / (w1 + w2)
                print(f"[9 split step times] trace scene {sid}, same rays: "
                      f"{w1:.4f}/{w2:.4f} ms with its volume groups, "
                      f"{b1:.4f}/{b2:.4f} ms without; the volume tests' "
                      f"share of B {share:.3f}", flush=True)
            out[name, sid] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound[0], bound_by=bound[1],
                                  library_ms=None)
    return out


def phase_hybrid_step():
    """D against its plain version: one hybrid step from the carry of the
    10th hybrid launch of a full-width qmega render, on scene 0 (800x800,
    the main path's lanes) and scene 1 (800x400), with `_compare_step`'s
    test; then D's step times at scene 1's carry, in turns.  Returns D's
    row of the kernels line, without its launches."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import mega_kernel as MK

    worst = 0.0
    for sid, (nx, ny, spp) in ((0, (BENCH_NX, BENCH_NY, 64)),
                               (QMEGA_SCENE, SPLIT_WORKLOADS[QMEGA_SCENE])):
        cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                               scene_id=sid, scheduler="qmega")
        (scene, cfg, sf, si, params, _), _ = _capture(
            cfg, {"mega_step": (MK, "mega_step")})["mega_step"]
        err, report = _compare_step(
            f"scene {sid} {sf.shape[1]} lanes, carry of hybrid launch 10",
            scene, cfg, params, sf, si, hybrid=True)
        worst = max(worst, err)
        print(f"[12 hybrid step check] {report}", flush=True)
    rays = torch.zeros(1, dtype=torch.int64, device="cuda")
    ms, plain_ms, times = _turns(
        lambda: MK.mega_step(scene, cfg, sf, si, params, rays, hybrid=True),
        lambda: MK.mega_step_plain(scene, cfg, sf, si, params, rays,
                                   hybrid=True))
    bound = _mega_bound(scene, sf, si)
    print(f"[12 hybrid step times] scene {QMEGA_SCENE} {sf.shape[1]} lanes, "
          f"carry of hybrid launch 10: {times}; bound {bound[0]:.4f} ms "
          f"({bound[1]})", flush=True)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None)


def phase_qmega_small():
    """scheduler="qmega" on scene 1 at 128x128, 8 spp, depth 10: the
    hybrid kernel against the same render with the plain twin on the card:
    equal rays and every pixel within 1e-4."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import mega_kernel as MK

    cfg = rtt.RenderConfig(nx=128, ny=128, spp=8, max_depth=10,
                           scene_id=QMEGA_SCENE, scheduler="qmega")
    scene = rtt.build_scene(QMEGA_SCENE, cfg.nx, cfg.ny)
    mk, mp = {}, {}
    n0 = MK.hybrid_launches
    img_k = rtt.render(scene, cfg, metrics=mk)
    if MK.hybrid_launches == n0:
        raise AssertionError("qmega launched no hybrid mega_step kernel")
    with _plain_mega():
        img_p = rtt.render(scene, cfg, metrics=mp)
    if not bool(torch.isfinite(img_k).all()):
        raise AssertionError("qmega: non-finite kernel image")
    close = ((img_k - img_p).abs() <= 1e-4 + 1e-4 * img_p.abs()).all(-1)
    px = float(close.float().mean())
    report = (f"scene {QMEGA_SCENE} 128x128 spp 8: rays {mk['rays']} vs "
              f"{mp['rays']}, pixels within 1e-4: {px:.5f} "
              f"({int((~close).sum())} outside)")
    if mk["rays"] != mp["rays"] or px < 1.0:
        raise AssertionError(f"{report}: needs equal rays and every pixel")
    print(f"[13 qmega small render] {report}", flush=True)


def phase_qmega_main(queue):
    """scheduler="qmega" through `render` on scene 1 at bench_scenes'
    workload (800x400, 16 spp, depth 20): warm-up with the identical
    config, then timed with the hybrid launch count set to 0 just before it
    and read just after, beside the queue's figure for the same workload
    (`queue`: phase 8's metrics, this run).  Returns the launch count."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import mega_kernel as MK

    nx, ny, spp = SPLIT_WORKLOADS[QMEGA_SCENE]
    cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                           scene_id=QMEGA_SCENE, scheduler="qmega")
    scene = rtt.build_scene(QMEGA_SCENE, nx, ny)
    rtt.render(scene, cfg)                      # warm-up
    m = {}
    MK.hybrid_launches = 0
    img = rtt.render(scene, cfg, metrics=m)
    launches = MK.hybrid_launches
    if launches <= 0:
        raise AssertionError("the qmega path launched no hybrid kernel")
    if tuple(img.shape) != (ny, nx, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"qmega: bad image {tuple(img.shape)}")
    mean = img.reshape(-1, 3).mean(0).cpu().numpy()
    print(f"[14 qmega path] scene {QMEGA_SCENE} {nx}x{ny} spp {spp} depth "
          f"{cfg.max_depth}: {m['wall_seconds']:.3f} s, {m['rays']} rays, "
          f"{m['mrays_per_sec']:.2f} Mrays/s, {launches} hybrid launches, "
          f"mean {_fmt(mean)}; the queue with B (phase 8): "
          f"{queue['wall_seconds']:.3f} s, {queue['rays']} rays, "
          f"{queue['mrays_per_sec']:.2f} Mrays/s on {card_line()}",
          flush=True)
    return launches


def phase_profile(sid):
    """torch.profiler over one full-width render of split-tier scene `sid`:
    device time of kernels B and C, of the torch glue (every other kernel),
    and the idle remainder, as shares of the wall."""
    import rtw_tpu_torch as rtt
    from torch.profiler import ProfilerActivity, profile

    nx, ny, spp = SPLIT_WORKLOADS[sid]
    cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                           scene_id=sid)
    scene = rtt.build_scene(sid, nx, ny)
    rtt.render(scene, cfg)
    m = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rtt.render(scene, cfg, metrics=m)
    us = {"trace_kernel": 0.0, "occluded_kernel": 0.0, "glue": 0.0}
    n_glue = 0
    for r in prof.key_averages():
        if not str(r.device_type).endswith("CUDA"):
            continue
        t = getattr(r, "self_device_time_total", None)
        if t is None:
            t = r.self_cuda_time_total
        key = next((k for k in ("trace_kernel", "occluded_kernel")
                    if k in r.key), "glue")
        us[key] += t
        n_glue += r.count if key == "glue" else 0
    wall_us = m["wall_seconds"] * 1e6
    busy = sum(us.values())
    shares = ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / wall_us:.1f}%)"
                       for k, v in us.items())
    print(f"[10 profile] scene {sid} {nx}x{ny} spp {spp}: wall "
          f"{wall_us / 1e3:.2f} ms, {m['mrays_per_sec']:.2f} Mrays/s under "
          f"the profiler; {shares}; glue kernels {n_glue}; idle "
          f"{(wall_us - busy) / 1e3:.2f} ms "
          f"({100 * (wall_us - busy) / wall_us:.1f}%)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=64,
                    help="main-path samples per pixel (1000 = bench.py)")
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler breakdowns of a scene-2 and a scene-4 render")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - t_start:.1f} s in all)", flush=True)
        return out

    timed(phase_device)
    timed(phase_build)
    small_err = timed(phase_one_step)
    timed(phase_small_render)
    mega = timed(phase_main, args.spp)
    mega["max_abs_err"] = max(small_err, mega["max_abs_err"])
    scene3 = timed(phase_scene3)
    scene3["max_abs_err"] = max(small_err, scene3["max_abs_err"])
    split_err = timed(phase_split_kernels)
    timed(phase_split_small_render)
    counts = timed(phase_split_main)
    steps = timed(phase_split_step_times)
    hybrid = timed(phase_hybrid_step)
    timed(phase_qmega_small)
    hybrid["launches"] = timed(phase_qmega_main, counts[QMEGA_SCENE][2])
    if args.profile:
        for sid in (2, 4):
            timed(phase_profile, sid)

    # one entry per kernel and path: `launches` is that path's own count
    mega_src = "rtw_tpu_torch/csrc/mega_kernel.cu"
    rows = [("mega_step", "cornell", mega_src,
             "rtw_tpu/ops/mega_kernel.py:387", mega),
            ("mega_step", "scene3", mega_src,
             "rtw_tpu/ops/mega_kernel.py:387", scene3),
            ("mega_step_hybrid", f"scene{QMEGA_SCENE}", mega_src,
             "rtw_tpu/ops/mega_kernel.py:437", hybrid)]
    for (name, sid), v in steps.items():
        v["launches"] = counts[sid][0 if name == "trace" else 1]
        v["max_abs_err"] = max(split_err[name], v["max_abs_err"])
        rep = ("rtw_tpu/ops/trace_kernel.py:918" if name == "trace" else
               "rtw_tpu/ops/trace_kernel.py:1114")
        rows.append((name, f"scene{sid}",
                     "rtw_tpu_torch/csrc/trace_kernel.cu", rep, v))
    print(json.dumps({"kernels": [
        {"name": name, "path": path, "route": "cuda", "source": src,
         "replaces": rep,
         **{k: v[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms")}}
        for name, path, src, rep, v in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
