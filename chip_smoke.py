#!/usr/bin/env python3
"""Chip smoke test of the rtw_tpu_torch port on one CUDA card.

    python3 chip_smoke.py [--spp N] [--profile]

Builds the CUDA kernels from the checkout's sources (one nvcc per source,
all at once; the report names each kernel's registers and spills) and
holds each against its plain torch version on the card.  Then it drives
the port's paths through `render`:

- the megakernel path, one persistent `mega_trace` launch per render: the
  Cornell box, 800x800, depth 20, `--spp` samples (default 64; `--spp
  1000` is bench.py's workload), scene 5 at tools/bench_scenes.py's
  400x224, 64 spp, and scene 3 (volumes) at its 400x400, 32 spp, depth 20.
  Each is rendered twice, by the persistent kernel and by the
  per-iteration kernel loop it replaced (`_loop_trace`, a host loop of
  `mega_step` launches): images equal bit for bit and rays equal; both
  timed in turns, the persistent kernel's grid, registers and tail, and
  its plain twin once at the same inputs; on Cornell also the card time a
  traced ray beside that of an all-lambertian copy (divergence);
- the split tier: scenes 1, 2 (800x400, 16 spp, depth 20) and 4 (800x400,
  8 spp, depth 20) on the work queue with the trace and occlusion kernels
  (B, C) and the shading and finishing kernels (E, F) of the bounce step:
  one E launch per B launch and one F per C launch on every split path;
  E and F against their plain versions at the 10th launch's inputs of
  scenes 1, 2 and 4, also under "book", the MIS weight off and the other
  texture filters, and on the furnace cavity (6 lights); the three
  scenes rendered with E and F, with their Mrays/s; the regeneration
  kernel R against the queue's torch merge at scene 4's 1200x600 lanes,
  bit-equal on every plane, timed with no lane and every lane claimed,
  and one R launch per iteration and per queue call on every split path;
- scheduler="qmega": scene 1 at 800x400, 16 spp, depth 20 on the work
  queue with the megakernel's hybrid mode;
- the scale tier: the stress fields of tools/stress_scale_torch.py (16384,
  65536 and 262144 spheres, 512x512, 4 spp, depth 8) on the work queue
  with the trace kernel walking the block hierarchy, the 16384 and 65536
  fields with the flat block scan beside it, the 65536 field with a light
  (the occlusion kernel), and the 16384 field with backend="mega" (the
  persistent kernel, against the loop as above) and scheduler="qmega";
- the rest of render()'s option surface on the split tier: scene 2 at
  800x400, 16 spp, depth 20 with rng="tea", rng="threefry" and
  estimator="book", and scene 1 with bounce_stats and occupancy_trace,
  each beside the fast, mis, counter-free render of its scene in turns;
- resume on the megakernel path: Cornell at 800x800, 16 spp in chunks of
  4, stopped after its second save and resumed, bit-equal to a whole
  render in two `mega_trace` launches, and the kernel held against its
  plain twin at the first resumed chunk's inputs;
- the gradient path (rtw_tpu_torch.diff): the demo scene of
  `python -m rtw_tpu_torch.grad_demo` at 200x200, 8 spp, depth 8 with
  backend="pallas", one chunked loss-and-grad call on B and C against the
  same branch on their plain versions and against the plain branch, with
  the launches per call explained; the demo's 12 descent steps (the loss
  must fall 10x) and the peak memory of three gradient variants; scene 2
  at 800x400, 1 spp, depth 20, one gradient step against its plain twin,
  with its gradient Mrays/s; render(differentiable=True) of scene 2
  through the queue against differentiable=False;
- sharding (rtw_tpu_torch.parallel): Cornell at 800x800, 64 spp, depth 20
  through `render_sharded` on one NCCL rank in this process, pixel mode
  bit-equal to `render` and sample mode within 1e-5; two ranks sharing
  the card on gloo (rtw_tpu_torch.parallel.worker, one process each):
  scene 2 at 800x400, 16 spp on the queue with B and C in each rank,
  within 1e-5 of the one-rank render, Cornell in sample mode, and a
  Cornell render killed after its first checkpoint and resumed bit-equal;
  `grad_sharded` of the demo scene on two ranks with B and C against one
  rank's `make_loss_and_grad`;
- the denoiser and the command line: `primary_features` on scene 4 at
  800x400 (one launch of B) against the same G-buffer through
  `trace_plain`, `denoise` in ldr and hdr, and `cli.main` on scene 0 at
  800x800, 16 spp: with its defaults (one `mega_trace` launch, the PNG
  equal to `render`'s) and with --denoise, --metrics-json and
  --profile-dir (the regen sweep through R, and one launch of B);
  `entry()` and `dryrun_multichip(2)`;
- the tools (tools/*_torch.py) through their functions at reduced sizes:
  kernel_check's cases (but the 131072 field), bench_scenes on scene 5,
  profile_scene on scene 2 at 4 spp, occupancy_report on scene 1 at
  200x100, compare_reference on scene 0 at 400x400, 16 spp,
  scene2_archaeology at 8 spp and exp_sortcost;

and checks that each path launched its kernels.  Beside them: the trace
and occlusion kernels on a scene of tied prims (equal spheres across and
inside a block, coincident rects and boxes) against their plain versions
on every lane; the furnace cavity (6 lights, outside the megakernel's
envelope) through scheduler="auto", which must render on the plain regen
sweep with no kernel launched but the regeneration R and meet
tests/test_integrator.py's furnace bounds; Cornell with estimator="book"
and with rng="tea" through "auto", outside the megakernel's envelope: no
kernel launched but R under "book", and a forced megakernel refused; per launch, each kernel's time beside the one read before its warps shared
their sweeps (PERF.md) and, for the split kernels and the hybrid step's
nearest hit, the per-warp spread of the work their lanes need (the
busiest lane's against the mean lane's, from the replay of the walk that
gives the bound).
`--profile` adds a torch.profiler breakdown of one Cornell (at `--spp`),
one scene-2, one scene-4 and one 65536-sphere field render (B, C, E and F
apart from the glue, and the glue's kernels an iteration), and every
other split path (the fields, the lit field, tea, threefry, book and the
counters) with E and F.  Each phase
prints one line; any failure raises, so the run exits non-zero and
prints no result.  With no CUDA device it exits 1.

The line before the last is `nvidia-smi`'s name and power limit of the
card; before it, one JSON object has an entry for each kernel on each
path, with that path's own launch count; the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from rtw_tpu_torch.utils.profiling import card_line

BENCH_NX = BENCH_NY = 800
BENCH_DEPTH = 20
# tools/bench_scenes.py's workloads: scene -> (nx, ny, spp)
SCENE3_WORKLOAD = (400, 400, 32)
SCENE5_WORKLOAD = (400, 224, 64)
SPLIT_WORKLOADS = {1: (800, 400, 16), 2: (800, 400, 16), 4: (800, 400, 8)}
QMEGA_SCENE = 1
# the rest of render()'s option surface on the split tier: (path, scene,
# options), each at its scene's SPLIT_WORKLOADS entry, depth 20
OPTION_PATHS = (("tea", 2, {"rng": "tea"}),
                ("threefry", 2, {"rng": "threefry"}),
                ("book", 2, {"estimator": "book"}),
                ("stats", 1, {"bounce_stats": True, "occupancy_trace": True}))
COUNTER_METRICS = ("rays_by_depth", "wavefront_iterations", "mean_occupancy",
                   "occupancy_by_iter")
# resume on the megakernel path: Cornell at (nx, ny, spp), in chunks of
# RESUME_CHUNK samples, a save after each, stopped after the second save
RESUME_WORKLOAD = (800, 800, 16)
RESUME_CHUNK = 4
SPLIT_LANES = 800 * 400
# the scale tier: tools/stress_scale.py's workload on the stress fields
FIELDS = (16384, 65536, 262144)
FIELD_WORKLOAD = (512, 512, 4)
FIELD_DEPTH = 8
SMALL_FIELD = 2500        # walked with the threshold lowered to 32 blocks
LIT_FIELD = 65536
MEGA_FIELD = 16384
# rays of the kernel-against-plain phase at each size (the plain sweep
# makes a [64, N] matrix per block: 4096 blocks at 262144 spheres)
FIELD_RAYS = {2500: 262144, 16384: 262144, 65536: 131072, 262144: 32768}
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


# the tie scene's twin pairs: (centre, radius) of two equal spheres at rows
# 63 and 64 of the sphere group (across the boundary of its 64-row blocks)
# and of two at rows 65 and 66 (inside its second block)
TWIN_CROSS = ((50.0, 50.0, 50.0), 6.0)
TWIN_INSIDE = ((70.0, 70.0, 70.0), 4.0)


def tie_scene(builder, scene_mod):
    """Coincident and duplicated prims, built with `builder` (either
    package's SceneBuilder) from the same calls.  The sphere group's
    Morton order puts 63 spheres below the twins (every coordinate lower),
    then the twin pair TWIN_CROSS (different materials: a tie whose winner
    shows in the shading record), then TWIN_INSIDE (exact duplicates),
    then 61 spheres above: 128 rows, two blocks.  Two coincident rects of
    different materials and two duplicated boxes form small groups."""
    b = builder()
    grey = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
    red = b.lambertian(b.constant_texture((0.9, 0.1, 0.1)))
    gold = b.metal(b.constant_texture((0.8, 0.6, 0.2)), 0.3)
    rng = np.random.default_rng(11)
    for c in rng.uniform(2.0, 30.0, (63, 3)):
        b.sphere(c, 1.0, grey)
    b.sphere(TWIN_CROSS[0], TWIN_CROSS[1], red)
    b.sphere(TWIN_CROSS[0], TWIN_CROSS[1], gold)
    b.sphere(TWIN_INSIDE[0], TWIN_INSIDE[1], grey)
    b.sphere(TWIN_INSIDE[0], TWIN_INSIDE[1], grey)
    for c in rng.uniform(80.0, 98.0, (61, 3)):
        b.sphere(c, 1.0, grey)
    b.rect(0.0, 100.0, 0.0, 100.0, -2.0, False, scene_mod.AXIS_Y, red)
    b.rect(0.0, 100.0, 0.0, 100.0, -2.0, False, scene_mod.AXIS_Y, gold)
    b.box((20.0, 40.0, 70.0), (30.0, 50.0, 80.0), red)
    b.box((20.0, 40.0, 70.0), (30.0, 50.0, 80.0), gold)
    b.set_camera((50.0, 50.0, -150.0), (50.0, 50.0, 50.0), (0, 1, 0), 40.0,
                 1.0, 0.0, 1.0)
    return b.build()


def tie_rays(n, seed=3):
    """Rays from random origins around the tie scene: a quarter each aimed
    at the two twin pairs and an eighth each at the boxes and (from above)
    at the floor rects, with jitter, and a quarter in random directions;
    every 8th lane dead (tmax -1e30).  Float32 (o [3, n], d [3, n], tmax
    [n])."""
    rng = np.random.default_rng(seed)
    q, e = n // 4, n // 8
    o = rng.uniform(-60.0, 160.0, (n, 3))
    o[2 * q + e:3 * q, 1] = np.abs(o[2 * q + e:3 * q, 1]) + 1.0
    targets = np.concatenate([
        np.tile(TWIN_CROSS[0], (q, 1)), np.tile(TWIN_INSIDE[0], (q, 1)),
        np.tile((25.0, 45.0, 75.0), (e, 1)),
        rng.uniform(0.0, 100.0, (q - e, 3)) * (1, 0, 1) + (0, -2, 0)])
    d = np.concatenate([targets + rng.normal(0.0, 2.0, targets.shape)
                        - o[:3 * q], rng.normal(size=(n - 3 * q, 3))])
    tmax = np.where(np.arange(n) % 8 == 7, -1e30, 1e27)
    return tuple(np.ascontiguousarray(a.T.astype(np.float32))
                 for a in (o, d, tmax))


CAVITY_L = 0.7


def furnace_cavity():
    """tests/test_integrator.py::test_furnace_cavity_exact's scene with the
    port's builder, on the CPU: an albedo-1 sphere inside six walls that
    each emit CAVITY_L and are each a registered light (7 prims, 6
    lights: outside the megakernel's envelope)."""
    from rtw_tpu_torch.models import scene as TS
    from rtw_tpu_torch.models.builder import SceneBuilder

    b = SceneBuilder()
    lt = b.constant_texture((CAVITY_L,) * 3)
    lm = b.diffuse_light(lt)
    b.sphere((0.0, 0.0, 0.0), 1.0,
             b.lambertian(b.constant_texture((1.0, 1.0, 1.0))))
    h = 5.0
    for axis in (TS.AXIS_Z, TS.AXIS_Y, TS.AXIS_X):   # normals face inward
        b.rect(-h, h, -h, h, -h, False, axis, lm)
        b.rect(-h, h, -h, h, h, True, axis, lm)
    for axis, k, u, v in [(2, -h, (2 * h, 0, 0), (0, 2 * h, 0)),
                          (2, h, (2 * h, 0, 0), (0, 2 * h, 0)),
                          (1, -h, (2 * h, 0, 0), (0, 0, 2 * h)),
                          (1, h, (2 * h, 0, 0), (0, 0, 2 * h)),
                          (0, -h, (0, 2 * h, 0), (0, 0, 2 * h)),
                          (0, h, (0, 2 * h, 0), (0, 0, 2 * h))]:
        pos = [-h, -h, -h]
        pos[axis] = k
        b.add_light(tuple(pos), u, v, (CAVITY_L,) * 3, tex=lt)
    b.set_camera((0, 0, 4.0), (0, 0, 0), (0, 1, 0), 40, 1.0, 0.0, 1.0)
    return b.build()


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                          check=True)
    return proc.stdout.strip()


def _fmt(v) -> str:
    return "[" + ", ".join(f"{x:.5f}" for x in v) + "]"


def phase_device():
    from rtw_tpu_torch.utils import kernels

    nvcc = _run([kernels.nvcc_path(), "--version"]).splitlines()[-1]
    print(f"[1 device] {card_line()} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {nvcc}", flush=True)


def phase_build():
    from rtw_tpu_torch import denoise as DN
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.ops import shade_kernel as SK
    from rtw_tpu_torch.ops import trace_kernel as TK
    from rtw_tpu_torch.utils import kernels

    names = ("mega_kernel", "trace_kernel", "shade_kernel", "denoise_kernel")
    t0 = time.perf_counter()
    kernels.build_all(list(names))
    for lib in (MK.LIB, TK.LIB, SK.LIB, DN.LIB):
        lib.load()
    secs = time.perf_counter() - t0
    for name in names:
        regs = kernels.ptxas_summary(name).replace("\n", " | ")
        print(f"[2 build] {name}.cu (nvcc "
              f"{kernels.build_seconds.get(name, 0.0):.2f} s); ptxas: {regs}",
              flush=True)
    print(f"[2 build] all {len(names)} built in parallel and loaded in "
          f"{secs:.2f} s", flush=True)


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

    parts = []
    for sid in (0, 5, 3):
        cfg = rtt.RenderConfig(nx=64, ny=48, spp=4, max_depth=10,
                               scene_id=sid)
        scene = rtt.build_scene(sid, cfg.nx, cfg.ny, device="cuda")
        params, sf, si = _carry_after(scene, cfg, 3)
        parts.append(_compare_step(f"scene {sid}", scene, cfg, params, sf,
                                   si)[1])
    print("[3 one step] " + "; ".join(parts), flush=True)


@contextlib.contextmanager
def _plain_mega():
    """`mega_trace` and `mega_step` replaced by their plain twins while the
    block runs: the same schedulers on the same inputs, in plain torch on
    the card."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    kernels = MK.mega_trace, MK.mega_step
    MK.mega_trace = MK.mega_trace_plain
    MK.mega_step = (lambda scene, cfg, sf, si, params, rays, hybrid=False:
                    MK.mega_step_plain(scene, cfg, sf, si, params, rays,
                                       hybrid))
    try:
        yield
    finally:
        MK.mega_trace, MK.mega_step = kernels


def _loop_trace(scene, cfg, pixel_idx, seed, s0, n_samples, probe=None):
    """The per-iteration design of the megakernel path, as
    `integrator.trace_wavefront_mega` ran it before the persistent kernel:
    a host loop of `mega_step` launches (one wavefront iteration each) from
    `init_carry`, with the termination test read once every 8 launches.
    Same return as `trace_wavefront_mega`.  `probe` (a dict, untimed runs
    only) receives the steps run, the lanes each step traced (alive or
    regenerated) summed over the steps, and the carry after 10 steps (or
    before the last, in a shorter render) and the rays traced."""
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.ops.vec import Vec3

    s_end = s0 + n_samples
    sf, si = MK.init_carry(pixel_idx.to(scene.device), s0)
    params = MK.mega_params(scene, seed, cfg, s_end, s0)
    rays = torch.zeros(1, dtype=torch.int64, device=scene.device)
    traced = torch.zeros((), dtype=torch.int64, device=scene.device)
    active = torch.zeros((), dtype=torch.int64, device=scene.device)
    steps = 0
    while True:
        for _ in range(8):
            if probe is not None:
                tracing = (si[MK.I_ALIVE] > 0) | (si[MK.I_SAMPLE] < s_end)
                traced += tracing.sum()
                active += tracing.any()
                if steps <= 10:        # the carry after 10 steps
                    probe["carry"] = (params, sf.clone(), si.clone())
            sf, si = MK.mega_step(scene, cfg, sf, si, params, rays)
            steps += 1
        busy = (si[MK.I_ALIVE] > 0) | (si[MK.I_SAMPLE] < s_end)
        if not bool(busy.any()):
            break
    if probe is not None:      # steps: those with a lane to trace
        probe.update(steps=int(active), traced=int(traced), rays=int(rays))
    return Vec3(sf[MK.F_ACC], sf[MK.F_ACC + 1], sf[MK.F_ACC + 2]), rays, ()


@contextlib.contextmanager
def _per_iteration():
    """`integrator.trace_wavefront_mega` replaced by `_loop_trace` while the
    block runs: `render` then drives the per-iteration kernel loop."""
    from rtw_tpu_torch import integrator as TI

    persistent = TI.trace_wavefront_mega
    TI.trace_wavefront_mega = _loop_trace
    try:
        yield
    finally:
        TI.trace_wavefront_mega = persistent


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


def _turns(kernel, plain, plain_reps=5, kernel_reps=50):
    """(kernel ms, plain ms, report): CUDA-event times in turns, plain,
    kernel, kernel, plain, each the mean of its reps.  A plain version that
    takes seconds (the scale tier's sweeps) gets one rep a turn, after a
    caller's own first call of it."""
    kernel()
    if plain_reps > 1:
        plain()
    p1 = _time_ms(plain, plain_reps)
    k1 = _time_ms(kernel, kernel_reps)
    k2 = _time_ms(kernel, kernel_reps)
    p2 = _time_ms(plain, plain_reps)
    return ((k1 + k2) / 2, (p1 + p2) / 2,
            f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")


def _mega_bound(scene, sf, si, params, walk_only=False):
    """Bound of one megakernel step: the carry read and written once (17
    f32 + 5 i32 rows each way), or the f32 work of the alive lanes: the
    nearest-hit sweep, the shadow ray's where the scene has a light, and
    ~300 operations of shading.  A scene of at most 8 blocks is swept
    whole; above that the nearest-hit sweep is the walk's own count on the
    carry's rays (`_split_work`), and a shadow sweep counts nothing (no
    culled path here has a light; less work keeps the bound a bound).
    Returns (ms, "bytes" or "operations", the walk's per-lane counts or
    None); `walk_only`: that walk's operations alone, an int."""
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.ops.intersect import BIG
    from rtw_tpu_torch.ops.vec import Vec3

    n = sf.shape[1]
    alive = si[MK.I_ALIVE] > 0
    n_alive = int(alive.sum())
    n_bytes = 2 * (MK.NF + MK.NI) * 4 * n
    if not params.c_params.walk:
        sweep = sum(e[1] * PRIM_FLOPS[e[3]] + e[1] * XFORM_FLOPS * e[5]
                    for e in scene.chunk_plan)
        sweeps = 1 + (scene.num_lights > 0)
        return (*_bound(n_bytes, n_alive * (sweeps * sweep + 300)), None)
    walk, lanes = _split_work(
        scene, params.tables, Vec3(*sf[MK.F_ORG:MK.F_ORG + 3]),
        Vec3(*sf[MK.F_DIR:MK.F_DIR + 3]), params.c_params.tmin,
        torch.where(alive, params.c_params.tmax, -BIG), sf[MK.F_TIME],
        torch.zeros((params.n_vol, n), device=sf.device), True)
    if walk_only:
        return walk
    return (*_bound(n_bytes, walk + 300 * n_alive), lanes)


def _trace_calls(cfg):
    """`trace_wavefront_mega` calls of one render: spp chunks x pixel
    batches (render.py)."""
    chunk = cfg.resolved_spp_chunk(checkpointing=False)
    return (-(-cfg.spp // chunk)) * (-(-cfg.num_pixels
                                       // cfg.resolved_ray_batch()))


def _render_counted(scene, cfg):
    """`render` after a warm-up with the identical config, the megakernel's
    launch counts set to 0 just before it and read just after.  Returns
    (image, metrics, {counter: launches}): `trace` the persistent kernel's,
    `step` the per-iteration step's (either mode)."""
    import rtw_tpu_torch as rtt

    rtt.render(scene, cfg)
    m = {}
    _reset_launches()
    img = rtt.render(scene, cfg, metrics=m)
    launched = _launch_counts()
    counts = dict(trace=launched["mega_trace"], step=launched["mega_step"])
    if tuple(img.shape) != (cfg.ny, cfg.nx, 3):
        raise AssertionError(f"image has shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite image")
    return img, m, counts


def _trace_bound(scene, params, probe, grid, n):
    """Bound of one persistent launch: bytes, the pixel ids in (4 B a lane),
    the radiance out (12 B a lane) and the tables once per block (those
    read from global memory once more); operations, the f32 work of the
    per-iteration loop's run on the same lanes: one sweep for each ray it
    traced (camera, bounce and NEE shadow rays alike) and ~300 of shading
    for each lane a step traced (alive or regenerated).  A walked scene's
    sweep is the walk's own count (`_split_work`) on the carry after 10
    steps, times the steps (no walked path here has a light)."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    c = params.c_params
    always, joined = MK.table_bytes(c)
    n_bytes = 16 * n + grid * (always + (joined if c.tables_shared else 0))
    n_bytes += 0 if c.tables_shared else joined
    if not c.walk:
        sweep = sum(e[1] * PRIM_FLOPS[e[3]] + e[1] * XFORM_FLOPS * e[5]
                    for e in scene.chunk_plan)
        return _bound(n_bytes, probe["rays"] * sweep + 300 * probe["traced"])
    _, sf, si = probe["carry"]
    walk_flops = _mega_bound(scene, sf, si, params, walk_only=True)
    return _bound(n_bytes, walk_flops * probe["steps"]
                  + 300 * probe["traced"])


# the kernels line's keys that `_against_twin` measures
TWIN_KEYS = ("max_abs_err", "plain_ms", "bound_ms", "bound_by")


def _against_twin(scene, cfg, pix, params, s0, n_samples):
    """`mega_trace` against its plain twin `mega_trace_plain` on the same
    inputs (the samples [s0, s0 + n_samples) of `pix`): every lane but
    0.1% within 1e-4 a sample, channel means within rtol 0.02 / atol
    0.003, rays within 0.5%; the twin timed once with CUDA events; the
    bound from the per-iteration loop's run on the same lanes
    (`_trace_bound`).  Returns {"max_abs_err": a lane's max abs diff a
    sample, "plain_ms", "bound_ms", "bound_by", "report", "carry": the
    loop's carry after 10 iterations}."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    rk = torch.zeros(1, dtype=torch.int64, device="cuda")
    rp = torch.zeros_like(rk)
    acc_k = MK.mega_trace(scene, cfg, pix, params, rk)
    grid = MK.last_trace["grid"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    acc_p = MK.mega_trace_plain(scene, cfg, pix, params, rp)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    mk, mp = (a.mean(1).cpu().numpy() / n_samples for a in (acc_k, acc_p))
    diff = (acc_k - acc_p).abs()
    share = float((diff <= 1e-4 * (n_samples + acc_p.abs())).all(0)
                  .float().mean())
    err = float(diff.max()) / n_samples        # a lane's pixel value
    report = (f"mega_trace vs mega_trace_plain, {pix.shape[0]} lanes, "
              f"samples {s0}-{s0 + n_samples - 1}: means {_fmt(mk)} vs "
              f"{_fmt(mp)}, rays {int(rk)} vs {int(rp)}, lanes within 1e-4 a "
              f"sample {share:.6f}, max abs diff a lane {err:.3e} a sample; "
              f"plain {plain_ms:.1f} ms")
    if share < 0.999:
        raise AssertionError(f"{report}: fewer than 0.999 of the lanes within "
                             "1e-4 a sample")
    np.testing.assert_allclose(mk, mp, rtol=0.02, atol=0.003,
                               err_msg=report)
    if abs(int(rk) - int(rp)) > 0.005 * int(rp):
        raise AssertionError(f"{report}: rays beyond 0.5%")

    probe = {}
    _loop_trace(scene, cfg, pix, cfg.seed, s0, n_samples, probe)
    bound = _trace_bound(scene, params, probe, grid, pix.shape[0])
    report += (f"; bound {bound[0]:.4f} ms ({bound[1]}; {probe['traced']} "
               f"lane-steps in {probe['steps']} steps)")
    return dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], report=report, carry=probe["carry"])


def _mega_path(label, scene, cfg, path):
    """A megakernel path through `render` at its full width, twice: the
    persistent kernel (one `mega_trace` launch per `trace_wavefront_mega`
    call, no `mega_step` launch) and the per-iteration loop
    (`_per_iteration`), each warmed up with the identical config and counted
    from 0; images equal bit for bit and rays equal.  Then the whole
    `trace_wavefront_mega` call of each design in turns (loop, persistent,
    persistent, loop) with CUDA events; the persistent kernel's grid,
    registers and tail; the plain twin `mega_trace_plain` once on the same
    inputs (every lane but 0.1% within 1e-4 a sample, channel means within
    rtol 0.02 / atol 0.003, rays within 0.5%); the bound.  Then one
    `mega_step` against the plain step at the carry after 10 iterations,
    and its step times.  Returns {"mega_trace": row, "mega_step": times}:
    the kernels line's `mega_trace` row, and the step's figures for the
    phase lines (no render path launches `mega_step` in regenerating
    mode)."""
    from rtw_tpu_torch import integrator as TI
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.render import tile_permutation

    head = (f"{path} {cfg.nx}x{cfg.ny} spp {cfg.spp} depth "
            f"{cfg.max_depth}")
    img, m, counts = _render_counted(scene, cfg)
    calls = _trace_calls(cfg)
    if counts["trace"] != calls or counts["step"]:
        raise AssertionError(f"{label} {head}: launches {counts}, expected "
                             f"{calls} mega_trace and no mega_step")
    info = {k: MK.last_trace[k] for k in MK.TRACE_INFO}
    tail = MK.trace_tail(MK.last_trace["scratch"])
    with _per_iteration():
        img_l, m_l, counts_l = _render_counted(scene, cfg)
    if counts_l["step"] <= 0 or counts_l["trace"]:
        raise AssertionError(f"{label} {head}: the loop's launches "
                             f"{counts_l}")
    same = bool(torch.equal(img, img_l))
    mean = img.reshape(-1, 3).mean(0).cpu().numpy()
    print(f"[{label}] {head}: persistent {m['wall_seconds']:.4f} s, "
          f"{m['rays']} rays, {m['mrays_per_sec']:.2f} Mrays/s, "
          f"{counts['trace']} mega_trace launches; per-iteration loop "
          f"{m_l['wall_seconds']:.4f} s, {m_l['rays']} rays, "
          f"{m_l['mrays_per_sec']:.2f} Mrays/s, {counts_l['step']} mega_step "
          f"launches; images bit-equal {same}; mean {_fmt(mean)} on "
          f"{card_line()}", flush=True)
    if not same or m["rays"] != m_l["rays"]:
        raise AssertionError(f"{label} {head}: the persistent render and the "
                             "loop differ")

    pix = torch.as_tensor(tile_permutation(cfg.nx, cfg.ny), device="cuda")
    if calls != 1:
        raise AssertionError(f"{label}: timed as one call, render makes "
                             f"{calls}")

    def persistent():
        TI.trace_wavefront_mega(scene, cfg, pix, cfg.seed, 0, cfg.spp)

    def loop():
        _loop_trace(scene, cfg, pix, cfg.seed, 0, cfg.spp)

    l1, p1, p2, l2 = (_time_ms(f, 3) for f in (loop, persistent, persistent,
                                               loop))
    warps = info["blocks_per_sm"] * info["block"] // 32
    print(f"[{label} times] {head}, trace_wavefront_mega per call: "
          f"persistent {p1:.4f}/{p2:.4f} ms, per-iteration loop "
          f"{l1:.4f}/{l2:.4f} ms; grid {info['grid']} blocks of "
          f"{info['block']} ({info['blocks_per_sm']} an SM on "
          f"{info['sms']} SMs: {warps} resident warps an SM), "
          f"{info['registers']} registers, {info['local_bytes']} B local a "
          f"thread; tail {tail['tail_ms']:.4f} ms of {tail['kernel_ms']:.4f}"
          f" ms ({100 * tail['tail_ms'] / tail['kernel_ms']:.1f}%)",
          flush=True)

    params = MK.mega_params(scene, cfg.seed, cfg, cfg.spp)
    twin = _against_twin(scene, cfg, pix, params, 0, cfg.spp)
    print(f"[{label} check] {twin['report']}", flush=True)
    trace_row = dict(launches=counts["trace"], ms=(p1 + p2) / 2,
                     library_ms=None, loop_ms=(l1 + l2) / 2,
                     loop_launches=counts_l["step"],
                     mrays_per_sec=m["mrays_per_sec"],
                     loop_mrays_per_sec=m_l["mrays_per_sec"],
                     **{k: twin[k] for k in TWIN_KEYS})

    c_params, sf, si = twin["carry"]
    _, report = _compare_step(f"{path} {sf.shape[1]} lanes, carry after "
                                f"10 iterations", scene, cfg, c_params, sf,
                                si, min_equal=1.0 if c_params.c_params.walk
                                else 0.999)
    print(f"[{label} step check] {report}", flush=True)
    rays = torch.zeros(1, dtype=torch.int64, device="cuda")
    slow = bool(c_params.c_params.walk)        # a plain step of a second
    ms, step_plain_ms, times = _turns(
        lambda: MK.mega_step(scene, cfg, sf, si, c_params, rays),
        lambda: MK.mega_step_plain(scene, cfg, sf, si, c_params, rays),
        plain_reps=1 if slow else 5, kernel_reps=20 if slow else 50)
    sbound = _mega_bound(scene, sf, si, c_params)
    print(f"[{label} step times] {sf.shape[1]} lanes, carry after 10 "
          f"iterations: {times} per iteration; bound {sbound[0]:.4f} ms "
          f"({sbound[1]})", flush=True)
    return {"mega_trace": trace_row, "mega_step": dict(ms=ms)}


def _lambertian(scene):
    """The scene with every prim's material lambertian and every albedo
    clamped to [0, 1]: the same geometry, light and camera (built here, not
    registered)."""
    prims = dataclasses.replace(
        scene.prims, mat_type_p=torch.zeros_like(scene.prims.mat_type_p))
    tex = dataclasses.replace(scene.textures,
                              color=scene.textures.color.clamp(0.0, 1.0))
    return dataclasses.replace(scene, prims=prims, textures=tex,
                               mat_present=(True,) + (False,) * 5)


def _divergence(label, scene, cfg):
    """A first measure of what the material branches' divergence costs the
    persistent kernel: one `trace_wavefront_mega` call on the scene and on
    its all-lambertian copy (`_lambertian`) in turns (scene, copy, copy,
    scene; CUDA events around each call), as card time per traced ray.
    The copy traces more shadow rays a path: not the same work."""
    from rtw_tpu_torch import integrator as TI
    from rtw_tpu_torch.render import tile_permutation

    pix = torch.as_tensor(tile_permutation(cfg.nx, cfg.ny), device="cuda")
    scenes = {"scene": scene, "lambertian": _lambertian(scene)}

    def call(k):
        return TI.trace_wavefront_mega(scenes[k], cfg, pix, cfg.seed, 0,
                                       cfg.spp)[1]

    rays = {k: int(call(k)) for k in scenes}
    ns = {k: [] for k in scenes}
    for k in ("scene", "lambertian", "lambertian", "scene"):
        ns[k].append(1e6 * _time_ms(lambda: call(k), 1) / rays[k])
    less = 1.0 - sum(ns["lambertian"]) / sum(ns["scene"])
    print(f"[{label} divergence] {cfg.nx}x{cfg.ny} spp {cfg.spp}, card time "
          f"a traced ray: the scene {ns['scene'][0]:.5f}/{ns['scene'][1]:.5f}"
          f" ns ({rays['scene']} rays), every material lambertian "
          f"{ns['lambertian'][0]:.5f}/{ns['lambertian'][1]:.5f} ns "
          f"({rays['lambertian']} rays): {100 * less:.1f}% less on "
          f"{card_line()}", flush=True)


def phase_main(spp: int):
    """The main path: the Cornell box at 800x800, depth 20; then its
    divergence measure."""
    import rtw_tpu_torch as rtt

    cfg = rtt.RenderConfig(nx=BENCH_NX, ny=BENCH_NY, spp=spp,
                           max_depth=BENCH_DEPTH, scene_id=0)
    scene = rtt.build_scene(0, cfg.nx, cfg.ny)
    out = _mega_path("5 main path", scene, cfg, "scene 0")
    _divergence("5 main path", scene, cfg)
    return out


def phase_scene3():
    """Scene 3 (a volume sphere and a transformed volume box, sky, no
    light) on the megakernel path at bench_scenes' workload."""
    import rtw_tpu_torch as rtt

    nx, ny, spp = SCENE3_WORKLOAD
    cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                           scene_id=3)
    return _mega_path("11 scene 3 path", rtt.build_scene(3, nx, ny), cfg,
                      "scene 3")


def phase_scene5():
    """Scene 5 (three spheres on a ground sphere: glass, lambertian, metal;
    sky, no light) on the megakernel path at bench_scenes' workload."""
    import rtw_tpu_torch as rtt

    nx, ny, spp = SCENE5_WORKLOAD
    cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                           scene_id=5)
    return _mega_path("11 scene 5 path", rtt.build_scene(5, nx, ny), cfg,
                      "scene 5")


def _bound(n_bytes, n_flops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over its memory rate and the f32 operations
    over its peak f32 rate."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_f = n_flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _split_work(scene, tables, o, d, tmin, tmax, time, vol_u, nearest):
    """(f32 operations, per-lane counts): what the split kernel needs for
    these rays, counted by replaying its walk (csrc/geometry.cuh) in plain
    torch.  Only live lanes (tmax > tmin) count: a dead lane's answer (a
    miss, not occluded) needs no test.  Each lane's slab test of each upper
    node and each block it reaches, the prim tests of the blocks it cannot
    cull (the nearest-hit cull tightens with the best t so far; an any-hit
    lane stops at its first hit), and the payload of each lane that hits.
    A group under the hierarchy's threshold has no upper nodes: every
    walking lane tests every block's box, as before the hierarchy.  The
    per-lane counts (int64 [N] each): "tests" (prim tests), "sweeps"
    (blocks swept) and "slabs" (slab tests), for `_warp_spread`."""
    from rtw_tpu_torch.ops import intersect as I
    from rtw_tpu_torch.ops.vec import Vec3

    n = o.x.shape[0]
    dev = o.x.device
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(n)
    time = torch.as_tensor(time, dtype=torch.float32, device=dev).expand(n)
    live = tmax > tmin
    best = torch.full((n,), I.BIG, device=dev)
    walking = live.clone()            # any-hit: lanes without a hit so far
    inv = [1.0 / torch.where(c == 0.0, 1e-30, c) for c in d]
    flops = torch.zeros((), dtype=torch.int64, device=dev)
    lanes = {k: torch.zeros(n, dtype=torch.int64, device=dev)
             for k in ("tests", "sweeps", "slabs")}
    prims = scene.prims

    def box_ok(row):
        ab = tables.aabbs[row]
        near = torch.full_like(best, -I.BIG)
        far = torch.full_like(best, I.BIG)
        for ax in range(3):
            t0 = (ab[ax] - o[ax]) * inv[ax]
            t1 = (ab[3 + ax] - o[ax]) * inv[ax]
            near = torch.maximum(near, torch.minimum(t0, t1))
            far = torch.minimum(far, torch.maximum(t0, t1))
        ok = (far >= torch.clamp_min(near, tmin)) & (near < tmax)
        return ok & (near < best) if nearest else ok

    for entry, hr in zip(scene.chunk_plan, tables.layout):
        start, count, size, ptype, axis, xform, block = entry
        levels, first, n_blocks = hr[:3]
        per = PRIM_FLOPS[ptype] + XFORM_FLOPS * int(xform)
        inside = [None] * (levels + 2)    # lanes inside the node of a level
        for b in range(n_blocks):
            inside[levels + 1] = walking
            for lv in range(levels, 0, -1):
                if b % (16 ** lv) == 0:   # a node of this level begins here
                    came = inside[lv + 1] & walking
                    lanes["slabs"] += came
                    inside[lv] = came & box_ok(hr[2 + lv] + b // 16 ** lv)
            came = inside[1] & walking
            lanes["slabs"] += came
            idx = torch.nonzero(came & box_ok(first + b))[:, 0]
            if idx.numel() == 0:
                continue
            b0 = start + b * block
            rows = min(block, start + count - b0)
            sl = slice(b0, b0 + rows)
            t_mat = I._block_t(
                ptype, axis, xform, prims.params[sl], prims.w2o[sl],
                prims.vol_slot[sl], Vec3(*(c[idx] for c in o)),
                Vec3(*(c[idx] for c in d)), tmin, tmax[idx], time[idx],
                vol_u[:, idx],
                torch.ones(rows, dtype=torch.bool, device=dev))
            lanes["sweeps"][idx] += 1
            if nearest:
                lanes["tests"][idx] += rows
                flops += per * rows * idx.numel()
                best[idx] = torch.minimum(best[idx], t_mat.min(dim=0).values)
            else:
                hits = t_mat < I.BIG
                hit = hits.any(0)
                tested = torch.where(hit, hits.int().argmax(0) + 1, rows)
                lanes["tests"][idx] += tested
                flops += per * tested.sum()
                walking[idx[hit]] = False
    flops += SLAB_FLOPS * lanes["slabs"].sum()
    if nearest:
        flops += PAYLOAD_FLOPS * (best < I.BIG).sum()
    return int(flops), lanes


def _warp_spread(counts):
    """(busiest, mean): a per-lane count summed over 32-lane warps, each
    warp taking its busiest lane's count or its mean lane's (lanes past N
    count 0, as the kernel's idle threads)."""
    per_warp = torch.nn.functional.pad(counts, (0, -counts.numel() % 32))
    per_warp = per_warp.view(-1, 32).double()
    return (float(per_warp.max(1).values.sum()),
            float(per_warp.mean(1).sum()))


def _divergence_report(lanes):
    """The replay's per-warp spread: prim tests, block sweeps and slab
    tests of the busiest and of the mean lane, summed over warps."""
    parts = []
    for k in ("tests", "sweeps", "slabs"):
        busy, mean = _warp_spread(lanes[k])
        parts.append(f"{k} busiest {busy:.0f} mean {mean:.1f} "
                     f"(x{busy / max(mean, 1e-9):.3f})")
    return "per warp, summed: " + ", ".join(parts)


def _split_bound(scene, tables, args, nearest):
    """(bound ms, "bytes" or "operations", per-lane counts) of one launch:
    each ray's 32 B in and its 104 B (trace) or 1 B (occluded) out, the
    tables read once; the operations of _split_work."""
    n = args[0].x.shape[0]
    n_bytes = (32 + (104 if nearest else 1)) * n + sum(
        t.numel() * t.element_size()
        for t in (tables.props, tables.plan, tables.aabbs))
    flops, lanes = _split_work(scene, tables, *args, nearest)
    return (*_bound(n_bytes, flops), lanes)


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
    the shadow ray's own); every 8th lane is dead (tmax = -BIG).  Then both
    on the tie scene, on every lane."""
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
    scene, tables, args = _tie_inputs()
    err, rep = _compare_trace("B tie scene", scene, tables, args,
                              min_equal=1.0)
    worst["trace"] = max(worst["trace"], err)
    print(f"[6 split kernels] {rep}", flush=True)
    # C on the same rays with finite shadow lengths (the dead lanes stay)
    o, d, _, tmax, time_, vol_u = args
    g = torch.Generator(device="cuda").manual_seed(206)
    occ_tmax = torch.where(tmax < 0, -BIG, 300.0 * torch.rand(
        SPLIT_LANES, generator=g, device="cuda"))
    err, rep = _compare_occluded("C tie scene", scene, tables,
                                 (o, d, 5e-5, occ_tmax, time_, vol_u),
                                 min_equal=1.0)
    worst["occluded"] = max(worst["occluded"], err)
    print(f"[6 split kernels] {rep}", flush=True)
    return worst


def _tie_inputs():
    """(scene, tables, trace arguments) of the tie scene on the card, the
    SPLIT_LANES rays of `tie_rays`."""
    from rtw_tpu_torch.models import scene as TS
    from rtw_tpu_torch.models.builder import SceneBuilder
    from rtw_tpu_torch.ops import trace_kernel as TK
    from rtw_tpu_torch.ops.vec import Vec3

    n = SPLIT_LANES
    scene = tie_scene(SceneBuilder, TS).to("cuda")
    o, d, tmax = (torch.as_tensor(a, device="cuda") for a in tie_rays(n))
    return scene, TK.split_tables(scene), (
        Vec3(*o), Vec3(*d), 1e-6, tmax, torch.zeros(n, device="cuda"),
        torch.full((1, n), 0.5, device="cuda"))


def phase_cavity():
    """The furnace cavity (7 prims, 6 lights: outside the megakernel's
    envelope) through `render` with scheduler="auto" on the card, at
    test_furnace_cavity_exact's 24x24, 256 spp, depth 24: the plain regen
    sweep, with no megakernel, trace or occlusion launch counted (its
    regeneration is R's: launched), and that
    test's assertions on the image: the albedo-1 sphere's mean within 2%
    of the walls' radiance L and each of its pixels within 12%, the wall
    pixels at L within 1e-5."""
    import rtw_tpu_torch as rtt

    scene = furnace_cavity().to("cuda")
    cfg = rtt.RenderConfig(nx=24, ny=24, spp=256, max_depth=24, seed=3)
    _reset_launches()
    m = {}
    img = rtt.render(scene, cfg, metrics=m)
    launched = _launch_counts()
    if launched["regen"] <= 0 or any(v for k, v in launched.items()
                                     if k != "regen"):
        raise AssertionError(f"cavity: auto launched kernels {launched}")
    img = img.cpu().numpy()
    sphere_px = img[9:15, 9:15]
    wall_px = np.concatenate([img[:2].reshape(-1, 3),
                              img[-2:].reshape(-1, 3)])
    report = (f"cavity 24x24 spp 256 depth 24 through auto on the card: "
              f"launches {launched}, {m['rays']} rays, sphere mean "
              f"{sphere_px.mean():.5f} (L {CAVITY_L}), worst sphere pixel "
              f"off by {np.abs(sphere_px - CAVITY_L).max():.5f}, wall "
              f"pixels off by at most {np.abs(wall_px - CAVITY_L).max():.2e}")
    if (abs(sphere_px.mean() - CAVITY_L) >= 0.02 * CAVITY_L
            or not np.all(np.abs(sphere_px - CAVITY_L) < 0.12 * CAVITY_L)
            or not np.allclose(wall_px, CAVITY_L, rtol=1e-7, atol=1e-5)):
        raise AssertionError(f"{report}: outside the furnace test's bounds")
    print(f"[22 cavity] {report}", flush=True)


def phase_split_small_render():
    """Scenes 1, 2 and 4 at 128x128, 8 spp, depth 10: `auto` (the queue
    with kernels B and C) against the plain queue (backend="jnp") on the
    card.  Rays equal up to 2 per bounce of a differing pixel's paths, >=
    99.9% of pixels within 1e-4, channel means within rtol 0.02 / atol
    0.003."""
    import dataclasses

    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import shade_kernel as SK

    parts = []
    for sid in (1, 2, 4):
        cfg = rtt.RenderConfig(nx=128, ny=128, spp=8, max_depth=10,
                               scene_id=sid)
        scene = rtt.build_scene(sid, cfg.nx, cfg.ny, device="cuda")
        mk, mp = {}, {}
        _reset_launches()
        img_k = rtt.render(scene, cfg, metrics=mk)
        _check_shade_launches(f"scene {sid} 128x128", _launch_counts(),
                              SK.has_nee(scene, cfg))
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
    0 just before it and read just after: one E launch per B launch, one
    F per C launch, and one R launch per B launch and per queue call.
    Returns {scene: (trace launches, occlusion launches, metrics, {kernel:
    launches})}."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import shade_kernel as SK

    counts = {}
    for sid, (nx, ny, spp) in SPLIT_WORKLOADS.items():
        cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                               scene_id=sid)
        scene = rtt.build_scene(sid, nx, ny)       # the default: the card
        rtt.render(scene, cfg)                     # warm-up
        m = {}
        _reset_launches()
        img = rtt.render(scene, cfg, metrics=m)
        launched = _launch_counts()
        nt, no = launched["trace"], launched["occluded"]
        if nt <= 0:
            raise AssertionError(f"scene {sid}: the split path launched no "
                                 "trace kernel")
        if scene.num_lights > 0 and no <= 0:
            raise AssertionError(f"scene {sid}: the split path launched no "
                                 "occlusion kernel")
        if tuple(img.shape) != (ny, nx, 3) or not bool(
                torch.isfinite(img).all()):
            raise AssertionError(f"scene {sid}: bad image {tuple(img.shape)}")
        _check_shade_launches(f"scene {sid}", launched,
                              SK.has_nee(scene, cfg))
        if launched["regen"] != nt + _trace_calls(cfg):
            raise AssertionError(f"scene {sid}: {launched['regen']} R "
                                 f"launches, not one an iteration ({nt}) "
                                 f"and one a call ({_trace_calls(cfg)})")
        counts[sid] = (nt, no, m, launched)
        mean = img.reshape(-1, 3).mean(0).cpu().numpy()
        print(f"[8 split main path] scene {sid} {nx}x{ny} spp {spp} depth "
              f"{cfg.max_depth}: {m['wall_seconds']:.3f} s, {m['rays']} "
              f"rays, {m['mrays_per_sec']:.2f} Mrays/s, {nt} iterations, "
              f"launches {launched}, mean {_fmt(mean)} on "
              f"{card_line()}", flush=True)
    return counts


class _Captured(Exception):
    """Ends a render once every wrapped launch has been recorded."""


def _capture(cfg, wrappers, call=10, scene=None, run=None):
    """{name: arguments} of the `call`-th call of each wrapper, one
    (module, attribute) per name, in a full-width render with `cfg` (the
    queue's wavefront is full then) of `scene` (default: the registered
    scene cfg.scene_id), or in `run()` when given; the run stops there."""
    import rtw_tpu_torch as rtt

    if scene is None and run is None:
        scene = rtt.build_scene(cfg.scene_id, cfg.nx, cfg.ny)
    got = {}

    def keep(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):   # Vec3, PathState
            return type(x)(*(keep(c) for c in x))
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
        if run is None:
            rtt.render(scene, cfg)
        else:
            run()
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


def _split_step(tag, label, name, captured, call=10, **check):
    """One split kernel (`name`: "trace" or "occluded") at the inputs of
    its `call`-th launch (`captured`; the tables the wrapper builds when
    the call passed none): kernel against plain (`check`: _compare_trace's
    or _compare_occluded's limits), CUDA-event times in turns, and the
    bound.  Returns the kernel's row of the kernels line, without its
    launches."""
    from rtw_tpu_torch.ops import trace_kernel as TK

    nearest = name == "trace"
    kern, plain = ((TK.trace, TK.trace_plain) if nearest else
                   (TK.occluded_kernel, TK.occluded_plain))
    (scene, *args), kw = captured
    tables = (args[6:] or [kw.get("tables")])[0]
    if tables is None:
        tables = TK.split_tables(scene)
    args = tuple(args[:6])
    cmp = _compare_trace if nearest else _compare_occluded
    err, rep = cmp(f"{name} {label} at launch {call}", scene, tables, args,
                   **check)
    print(f"[{tag} step check] {rep}", flush=True)
    slow = tables.n_blocks > 64           # a plain sweep of seconds
    ms, plain_ms, times = _turns(
        lambda: kern(scene, *args, tables), lambda: plain(scene, *args),
        plain_reps=1 if slow else 5, kernel_reps=20 if slow else 50)
    bound = _split_bound(scene, tables, args, nearest)
    n = args[0].x.shape[0]
    live = int(torch.as_tensor(args[3] > args[2]).expand(n).sum())
    print(f"[{tag} step times] {name} {label}: {n} lanes ({live} live), "
          f"{times}; bound {bound[0]:.4f} ms ({bound[1]}); "
          f"{_divergence_report(bound[2])}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=None)


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
        wrappers = {"trace": (TK, "trace_rows")}
        if sid != 1:                      # scene 1 has no light: no NEE
            wrappers["occluded"] = (TK, "occluded_kernel")
        got = _capture(cfg, wrappers)
        for name in got:
            out[name, sid] = _split_step("9 split", f"scene {sid}", name,
                                         got[name])
        (scene, *args, tables), _ = got["trace"]
        if scene.n_vol:
            bare = _without_volumes(scene)
            bare_tables = TK.split_tables(bare)

            def whole():
                TK.trace(scene, *args, tables)

            def without():
                TK.trace(bare, *args, bare_tables)

            w1, b1, b2, w2 = (_time_ms(f, 50) for f in
                              (whole, without, without, whole))
            share = 1.0 - (b1 + b2) / (w1 + w2)
            print(f"[9 split step times] trace scene {sid}, same rays: "
                  f"{w1:.4f}/{w2:.4f} ms with its volume groups, "
                  f"{b1:.4f}/{b2:.4f} ms without; the volume tests' "
                  f"share of B {share:.3f}", flush=True)
    return out


# Kernels E and F (csrc/shade_kernel.cu) against their plain versions:
# the integer and bool planes (alive, rays_lane, prev_diffuse, the shadow
# query's activity) equal on at least SHADE_MIN_EQUAL of the lanes, every
# float plane within SHADE_RTOL / SHADE_ATOL on the lanes where those agree
# (the shadow ray and the NEE term on the lanes whose query is active)
SHADE_MIN_EQUAL = 0.999
SHADE_RTOL, SHADE_ATOL = 1e-4, 1e-6
# f32 operations of E a lane, a lower bound (integer hashing, compares and
# selects are not counted; a libm call counts one): every alive lane's
# direction normalisation and sky, a hit lane's scatter, advance and
# Russian roulette, a lambertian lane's NEE set-up, one light of the book
# mixture's pdf, the marble (7 octaves x 8 lattice corners of ~30) and an
# atlas fetch
SHADE_ALIVE_FLOPS = 20
SHADE_HIT_FLOPS = 120
SHADE_NEE_FLOPS = 70
BOOK_LIGHT_FLOPS = 45
MARBLE_FLOPS = 7 * 8 * 30 + 20
IMAGE_FLOPS = 40


def _shade_bound(scene, cfg, tables, args, plain):
    """E's bound at these inputs (of, oi, state, depth, U): the bytes each
    lane loads where csrc/shade_kernel.cu loads them, by the lane's branch
    (every lane: its prim id and the state; a hit lane: B's point, normal,
    material and texture ids, then its texture's rows, its material's U
    rows, the estimator's), each output row written once; and the f32
    operations of this data's lanes (the SHADE_* counts).  `plain`:
    shade_plain's result at `args`; `tables`: the scene's ShadeTables.  A
    word a lane may skip is left out, so
    the bytes are a lower bound: the U rows of NEE are counted on the lanes
    whose shadow query is active, the depth and RR uniform on the lanes
    that survive, a dielectric's uniform (unread under total internal
    reflection) nowhere; the light, light-row and image tables (at most a
    few hundred bytes) are left out, and the atlas words are counted per
    image lane up to the atlas's size."""
    from rtw_tpu_torch.models import scene as TS
    from rtw_tpu_torch.ops import shade_kernel as SK
    from rtw_tpu_torch.ops.bounce import scene_env
    from rtw_tpu_torch.ops.intersect import BIG
    from rtw_tpu_torch.ops.shading import tex_row

    of, oi, state, depth, U = args
    env = scene_env(scene, cfg)
    n = of.shape[1]
    hit = state.alive & (oi[0] >= 0)

    def lanes(m):
        return int(m.sum())

    def texture(t):
        return (hit & (oi[2] == t) if scene.tex_present[t]
                else torch.zeros_like(hit))
    checker, marble, image = (texture(t) for t in (
        TS.TEX_CHECKER, TS.TEX_NOISE, TS.TEX_IMAGE))

    def material(m):
        return (hit & (oi[1] == m) if env.mat_present[m]
                else torch.zeros_like(hit))
    lamb, metal, diel, iso = (material(m) for m in (
        TS.MAT_LAMBERTIAN, TS.MAT_METAL, TS.MAT_DIELECTRIC,
        TS.MAT_ISOTROPIC))
    query = (plain.shadow_tmax > -BIG if env.nee
             else torch.zeros_like(hit))
    words = {"stoch565": 1, "nearest565": 1, "rgb565": 2}.get(cfg.tex_filter,
                                                               4)
    n_image = lanes(image)
    n_bytes = (n * (4 + 12 * 4 + 1 + 1 + 4)           # prim id, the state
               + lanes(hit) * (6 * 4 + 2 * 4)          # point, normal, ids
               + lanes(hit & ~(checker | marble | image)) * 12   # rgb
               + lanes(checker) * 12 + lanes(marble) * 4
               + n_image * (2 * 4 + 4 + 4 * (tex_row(scene, cfg) >= 0))
               + min(n_image * words, (tables.atlas8 if words == 4 else
                                       tables.atlas565).numel()) * 4
               + lanes(lamb) * (2 + 4 * env.book) * 4   # scatter (+ book)
               + lanes(query) * 3 * 4                   # the light pick
               + lanes(metal) * (4 + 3 * 4) + lanes(diel) * 4
               + lanes(iso) * 2 * 4
               + lanes(plain.alive) * (8 + 4)           # depth, RR uniform
               + n * ((SK.O_SORG + (SK.OUT_F32 - SK.O_SORG) * env.nee) * 4
                      + 2 + 4))
    flops = (lanes(state.alive) * SHADE_ALIVE_FLOPS
             + lanes(hit) * SHADE_HIT_FLOPS
             + lanes(lamb) * (SHADE_NEE_FLOPS * env.nee
                              + BOOK_LIGHT_FLOPS * scene.num_lights
                              * env.book)
             + lanes(marble) * MARBLE_FLOPS + n_image * IMAGE_FLOPS)
    return _bound(n_bytes, flops)


def _compare_shade(label, scene, cfg, tables, args,
                   min_equal=SHADE_MIN_EQUAL, need=None):
    """Kernel E against shade_plain on the same inputs (SHADE_MIN_EQUAL,
    SHADE_RTOL, SHADE_ATOL).  Raises where no lane is alive, and where a
    lane mask of `need(plain result)` ({branch: [N] bool}: the lanes that
    take a branch the check is there for) holds on no lane.  Returns (max
    abs diff of the float planes on the agreeing lanes, report: each
    discrete plane's equal share, the bit-equal share of the lanes, the
    worst lane)."""
    from rtw_tpu_torch.ops import shade_kernel as SK
    from rtw_tpu_torch.ops.intersect import BIG

    k = SK.shade(scene, cfg, tables, *args)
    p = SK.shade_plain(scene, cfg, *args)
    torch.cuda.synchronize()
    alive_in = int(args[2].alive.sum())
    taken = {name: int(m.sum()) for name, m in (need(p) if need else
                                                {}).items()}
    if not alive_in or 0 in taken.values():
        raise AssertionError(
            f"{label}: {alive_in} lanes alive, lanes by branch {taken}: "
            f"nothing to hold E against on a branch")
    disc = {"alive": (k.alive, p.alive),
            "rays_lane": (k.rays_lane, p.rays_lane),
            "prev_diffuse": (k.prev_diffuse, p.prev_diffuse)}
    nee = p.nee is not None
    if nee:
        disc["query"] = (k.shadow_tmax > -BIG, p.shadow_tmax > -BIG)
    agree = torch.ones_like(p.alive)
    shares = {}
    for name, (a, b) in disc.items():
        shares[name] = float((a == b).float().mean())
        agree &= a == b

    def rows(o, names):
        return torch.stack([c for f in names for c in (
            getattr(o, f) if isinstance(getattr(o, f), tuple)
            else (getattr(o, f),))])
    state_f = ("origin", "direction", "throughput", "radiance", "prev_pdf")
    planes = [(rows(k, state_f), rows(p, state_f), agree)]
    if nee:
        active = agree & (p.shadow_tmax > -BIG)
        nee_f = ("shadow_org", "shadow_dir", "shadow_tmax", "nee")
        planes.append((rows(k, nee_f), rows(p, nee_f), active))
    err, bad, bit = 0.0, torch.zeros_like(agree), agree.clone()
    worst = (0.0, None)
    for kf, pf, lanes in planes:
        diff = (kf - pf).abs()
        ok = torch.isclose(kf, pf, rtol=SHADE_RTOL, atol=SHADE_ATOL,
                           equal_nan=True) | ~lanes
        bad |= ~ok.all(0)
        same = (kf == pf) | (torch.isnan(kf) & torch.isnan(pf)) | ~lanes
        bit &= same.all(0)
        d = torch.where(lanes & torch.isfinite(diff), diff, 0.0)
        if d.numel():
            err = max(err, float(d.max()))
            rel = d / (SHADE_ATOL + SHADE_RTOL * pf.abs())
            if float(rel.max()) > worst[0]:
                r, lane = divmod(int(rel.argmax()), rel.shape[1])
                worst = (float(rel.max()),
                         f"lane {lane} row {r}: {float(kf[r, lane]):.9g} / "
                         f"{float(pf[r, lane]):.9g}")
    n = p.alive.numel()
    report = (f"{label}: {n} lanes ({alive_in} alive"
              + "".join(f", {v} {k_}" for k_, v in taken.items())
              + "); equal "
              + ", ".join(f"{k_} {v:.6f}" for k_, v in shares.items())
              + f"; bit-equal lanes {float(bit.float().mean()):.6f}; float "
              f"max abs diff {err:.3e} on the agreeing lanes, worst lane "
              f"{worst[1] or 'none'} ({worst[0]:.3g} of its tolerance)")
    if min(shares.values()) < min_equal:
        raise AssertionError(f"{report}: a discrete plane equal on fewer "
                             f"than {min_equal} of the lanes")
    if bool(bad.any()):
        raise AssertionError(f"{report}: {int(bad.sum())} agreeing lanes "
                             f"beyond rtol {SHADE_RTOL} / atol {SHADE_ATOL}")
    return err, report


def _compare_finish(label, args):
    """Kernel F against finish_plain: every lane equal (the same add).
    Returns (max abs diff, report)."""
    from rtw_tpu_torch.ops import shade_kernel as SK

    k = torch.stack(list(SK.finish(*args)))
    p = torch.stack(list(SK.finish_plain(*args)))
    torch.cuda.synchronize()
    same = (k == p) | (torch.isnan(k) & torch.isnan(p))
    err = float(torch.where(same, 0.0, (k - p).abs()).max())
    report = (f"{label}: {p.shape[1]} lanes, equal "
              f"{float(same.all(0).float().mean()):.6f}, max abs diff "
              f"{err:.3e}")
    if not bool(same.all()):
        raise AssertionError(f"{report}: F differs from finish_plain")
    return err, report


def _device_ms(fn, kernel, reps=20):
    """The device time of one launch of `kernel` (a substring of its name)
    in `fn()`, the mean over `reps` calls under torch.profiler: the
    kernel's own duration, without the wrapper's host work that CUDA
    events around back-to-back calls also time when the kernel is shorter
    than it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for r in prof.key_averages():
        if kernel in r.key and str(r.device_type).endswith("CUDA"):
            t = getattr(r, "self_device_time_total", None)
            us += r.self_cuda_time_total if t is None else t
    return us / reps / 1e3


def _shade_steps(tag, label, got, device=False):
    """E's (and, where `got` has it, F's) rows of the kernels line at the
    captured inputs of their launch: against plain, CUDA-event times in
    turns (plain, kernel, kernel, plain), the bound.  Returns {"shade":
    row, "shade_finish": row}, without launches."""
    from rtw_tpu_torch.ops import shade_kernel as SK

    rows = {}
    (scene, cfg, tables, *args), _ = got["shade"]
    if tables is None:
        tables = SK.shade_tables(scene, cfg)
    err, rep = _compare_shade(f"shade {label}", scene, cfg, tables, args)
    print(f"[{tag} step check] {rep}", flush=True)
    ms, plain_ms, times = _turns(
        lambda: SK.shade(scene, cfg, tables, *args),
        lambda: SK.shade_plain(scene, cfg, *args))
    bound = _shade_bound(scene, cfg, tables, args,
                         SK.shade_plain(scene, cfg, *args))
    rows["shade"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=None)
    if device:
        rows["shade"]["device_ms"] = _device_ms(
            lambda: SK.shade(scene, cfg, tables, *args), "shade_kernel")
        times += f", the kernel alone {rows['shade']['device_ms']:.4f} ms"
    print(f"[{tag} step times] shade {label}: {times}; bound "
          f"{bound[0]:.4f} ms ({bound[1]})", flush=True)
    if "shade_finish" in got:
        fargs, _ = got["shade_finish"]
        err, rep = _compare_finish(f"shade_finish {label}", fargs)
        print(f"[{tag} step check] {rep}", flush=True)
        ms, plain_ms, times = _turns(lambda: SK.finish(*fargs),
                                     lambda: SK.finish_plain(*fargs))
        n = fargs[2].shape[0]
        bound = _bound(n * (7 * 4 + 1 + 3 * 4), 3 * n)
        rows["shade_finish"] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound[0],
                                    bound_by=bound[1], library_ms=None)
        if device:
            rows["shade_finish"]["device_ms"] = _device_ms(
                lambda: SK.finish(*fargs), "shade_finish_kernel")
            times += (f", the kernel alone "
                      f"{rows['shade_finish']['device_ms']:.4f} ms")
        print(f"[{tag} step times] shade_finish {label}: {times}; bound "
              f"{bound[0]:.4f} ms ({bound[1]})", flush=True)
    return rows


def _shade_wrappers(scene, cfg):
    """The wrappers of E and, where the render has NEE, F, for `_capture`."""
    from rtw_tpu_torch.ops import shade_kernel as SK

    wrappers = {"shade": (SK, "shade")}
    if SK.has_nee(scene, cfg):
        wrappers["shade_finish"] = (SK, "finish")
    return wrappers


def _cavity_inputs(cfg, bounces):
    """E's inputs on the furnace cavity (6 lights) at 128x128 after
    `bounces` plain bounces: (scene, (of, oi, state, depth, U)), B's rows
    from the trace kernel."""
    from rtw_tpu_torch import integrator as TI
    from rtw_tpu_torch.ops import trace_kernel as TK
    from rtw_tpu_torch.ops.intersect import BIG
    from rtw_tpu_torch.utils import rng as R

    scene = furnace_cavity().to("cuda")
    pix = torch.arange(cfg.num_pixels, device="cuda")
    keys = R.make_path_keys(cfg.seed, pix, 0, cfg.rng)
    state = TI.generate_camera_rays(scene, cfg, pix, keys)
    depth = torch.zeros_like(pix)
    for _ in range(bounces):
        state, _ = TI.bounce_step(scene, cfg, keys, state, depth,
                                  split="plain")
        depth = depth + 1
    nv = max(scene.n_vol, 1)
    U = R.bounce_uniforms(keys, depth + 1, R.NUM_FIXED_SLOTS + 2 * nv,
                          cfg.rng)
    tmax = torch.where(state.alive, cfg.t_max, -BIG)
    of, oi = TK.trace_rows(scene, state.origin, state.direction, cfg.t_min,
                           tmax, state.time, U[R.NUM_FIXED_SLOTS:][:nv])
    return scene, (of, oi, state, depth, U)


def _cavity_branches(scene, cfg, args, bounces):
    """need(plain result) for `_compare_shade` on the cavity's inputs: the
    lanes of each multi-light branch.  At the camera rays (0 bounces) the
    sphere's lanes pick a light among the 6: under "mis" for NEE (and some
    query is active), under "book" for the mixture's light-sampled
    direction, whose pdf sums over the 6.  After one bounce the lanes that
    scattered off the sphere hit a wall with prev_diffuse set: under "mis"
    the MIS weight's pdf through the wall's light row (light_pdf_at's
    general branch)."""
    from rtw_tpu_torch.models import scene as TS
    from rtw_tpu_torch.ops.intersect import BIG
    from rtw_tpu_torch.utils import rng as R

    _, oi, state, _, U = args
    hit = state.alive & (oi[0] >= 0)
    L = scene.num_lights
    if bounces:
        wall = hit & (oi[1] == TS.MAT_DIFFUSE_LIGHT) & state.prev_diffuse
        return lambda p: {"wall hits after a diffuse bounce": wall}
    lamb = hit & (oi[1] == TS.MAT_LAMBERTIAN)
    pick = torch.clamp((U[R.U_LIGHT_SELECT] * L).to(torch.int64), 0, L - 1)
    if cfg.estimator == "book":
        lamb = lamb & (U[R.U_DIELECTRIC] < 0.5)
        return lambda p: {f"aimed at light {li}": lamb & (pick == li)
                          for li in range(L)}
    return lambda p: {"shadow queries": p.shadow_tmax > -BIG,
                      **{f"picks of light {li}": lamb & (pick == li)
                         for li in range(L)}}


def phase_shade_steps():
    """Kernels E and F at the split paths' shapes: the inputs of the 10th
    launch of a full-width render of scenes 1, 2 and 4 (320k lanes), E
    against shade_plain and F against finish_plain (SHADE_MIN_EQUAL,
    SHADE_RTOL, SHADE_ATOL), both timed in turns, with their bounds.  At
    the same inputs E also under the options it covers: estimator="book",
    mis_bsdf_weight=False and, on the atlas scenes, the filters rgb565,
    nearest565 and rgb8; and on the furnace cavity (6 lights), E under
    "mis" and "book" at the camera rays and after one bounce, each
    required to take the multi-light branches (`_cavity_branches`).
    Returns {scene: {kernel: row}}."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.models import scene as TS
    from rtw_tpu_torch.ops import shade_kernel as SK

    out = {}
    for sid, (nx, ny, spp) in SPLIT_WORKLOADS.items():
        cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                               scene_id=sid)
        scene = rtt.build_scene(sid, nx, ny)
        got = _capture(cfg, _shade_wrappers(scene, cfg), scene=scene)
        out[sid] = _shade_steps("36 shade", f"scene {sid}", got,
                                device=True)
        (_, _, tables, *args), _ = got["shade"]
        variants = [dict(estimator="book"), dict(mis_bsdf_weight=False)]
        if scene.tex_present[TS.TEX_IMAGE]:
            variants += [dict(tex_filter=f)
                         for f in ("rgb565", "nearest565", "rgb8")]
        for opts in variants:
            vcfg = dataclasses.replace(cfg, **opts)
            _, rep = _compare_shade(f"shade scene {sid} {opts}", scene, vcfg,
                                    SK.shade_tables(scene, vcfg), args)
            print(f"[36 shade options] {rep}", flush=True)
    for est in ("mis", "book"):
        cfg = rtt.RenderConfig(nx=128, ny=128, spp=1, max_depth=24,
                               estimator=est)
        for bounces in (0, 1):
            scene, args = _cavity_inputs(cfg, bounces)
            _, rep = _compare_shade(
                f"shade cavity {est} after {bounces} bounces", scene, cfg,
                SK.shade_tables(scene, cfg), args,
                need=_cavity_branches(scene, cfg, args, bounces))
            print(f"[36 shade options] {rep}", flush=True)
    return out


def _launch_counts():
    """{kernel: launches} of every kernel since `_reset_launches`
    (`worker.launch_counts`; mega_step counts both of its modes)."""
    from rtw_tpu_torch.parallel import worker

    return worker.launch_counts()


def _reset_launches():
    from rtw_tpu_torch.utils import kernels

    kernels.launches.clear()


@contextlib.contextmanager
def _hybrid_launches(box):
    """Inside, box["mega_step_hybrid"] grows by the kernel launches of the
    hybrid calls of `mega_step` (the library counts both modes under
    one entry point)."""
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.utils import kernels

    real = MK.mega_step

    def step(*a, **kw):
        n0 = kernels.launches["rtw_mega_step"]
        out = real(*a, **kw)
        if kw.get("hybrid", a[6] if len(a) > 6 else False):
            box["mega_step_hybrid"] += kernels.launches["rtw_mega_step"] - n0
        return out
    MK.mega_step = step
    try:
        yield
    finally:
        MK.mega_step = real


def _check_shade_launches(label, counts, nee=None):
    """One E launch per B launch, one F launch per C launch, and (`nee`
    given) C, so F, at every B launch where the render has NEE, at none
    where it has not (no lights, or "book")."""
    nt, no = counts["trace"], counts["occluded"]
    ns, nf = counts["shade"], counts["shade_finish"]
    if ns != nt or nf != no or nt <= 0 or (
            nee is not None and no != (nt if nee else 0)):
        raise AssertionError(f"{label}: launches trace {nt} occluded {no} "
                             f"shade {ns} shade_finish {nf} (NEE {nee}): "
                             "not one E per B and one F per C")


def _shade_render(tag, label, scene, cfg):
    """One split path through `render` with E and F after a warm-up,
    launch counts from 0: one E launch per B launch and one F per C
    launch, a finite image.  Returns its metrics."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import shade_kernel as SK

    rtt.render(scene, cfg)
    m = {}
    _reset_launches()
    img = rtt.render(scene, cfg, metrics=m)
    counts = _launch_counts()
    label = f"{label} {cfg.nx}x{cfg.ny} spp {cfg.spp}"
    _check_shade_launches(label, counts, SK.has_nee(scene, cfg))
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: non-finite image")
    print(f"[{tag}] {label}: E+F {m['mrays_per_sec']:.2f} Mrays/s "
          f"({m['wall_seconds']:.3f} s), rays {m['rays']}; launches "
          f"{counts} on {card_line()}", flush=True)
    return m


# Kernel R (`SK.regen`) at the final cell's frame: scene 4, 1200x600 lanes
REGEN_SCENE, REGEN_NX, REGEN_NY = 4, 1200, 600
REGEN_SEED = 2**33 + 12345
REGEN_MASKS = ("empty", "full", "random", "disjoint")
# bytes a lane: with no lane claimed, the two masks read; with every lane
# claimed, flushed and pending, the masks and the claimed (sample, pixel)
# read (18) and the 75 B of new planes written
REGEN_BYTES_NONE = 2
REGEN_BYTES_FULL = 18 + 75


def regen_carry(cfg, n, masks, seed=0, device="cuda"):
    """A queue iteration's carry at R's launch over `n` lanes, made with
    numpy from `seed`: random planes (no pending lane alive), the claimed
    (sample, pixel), and the flush's masks `have` and `pend` of kind
    `masks`: "empty" (no flush), "full" (every lane flushed and claimed),
    "random" (`have` a part of `pend`), "disjoint" (the two apart)."""
    from rtw_tpu_torch.ops.bounce import PathState
    from rtw_tpu_torch.ops.vec import Vec3

    g = np.random.default_rng(seed)

    def f():
        return torch.as_tensor(g.standard_normal(n).astype(np.float32),
                               device=device)

    def b(p):
        return torch.as_tensor(g.random(n) < p, device=device)

    def i(lo, hi):
        return torch.as_tensor(g.integers(lo, hi, n), dtype=torch.int64,
                               device=device)
    npix = cfg.nx * cfg.ny
    if masks == "empty":
        have = pend = torch.zeros(n, dtype=torch.bool, device=device)
    elif masks == "full":
        have = pend = torch.ones(n, dtype=torch.bool, device=device)
    elif masks == "random":
        pend = b(0.5)
        have = pend & b(0.8)
    elif masks == "disjoint":
        have = b(0.3)
        pend = ~have & b(0.5)
    else:
        raise ValueError(f"unknown masks {masks!r}")
    pending = pend | b(0.2)
    path = PathState(origin=Vec3(f(), f(), f()), direction=Vec3(f(), f(), f()),
                     throughput=Vec3(f(), f(), f()),
                     radiance=Vec3(f(), f(), f()), alive=b(0.7) & ~pending,
                     time=f(), prev_pdf=f(), prev_diffuse=b(0.5))
    return dict(path=path, keys=i(0, 1 << 32), depth=i(0, 21),
                sample=i(0, 20), pixel=i(0, npix), q_sample=i(0, 20),
                q_pixel=i(0, npix), have=have, pend=pend, pending=pending)


def regen_plain(scene, cfg, seed, c, queue=True):
    """The torch merge R stands for, on carry `c` (`regen_carry`): the work
    queue's (`queue`: the claimed (sample, pixel) taken where `have`, the
    alive plane `alive | have`, `pending & ~pend`) or the regen
    scheduler's (the lane's own (sample, pixel); alive
    `where(pend, have, alive)`).  Returns the planes as `regen_planes`."""
    from rtw_tpu_torch import integrator as TI

    have, pend, path = c["have"], c["pend"], c["path"]
    if queue:
        sample = torch.where(have, c["q_sample"], c["sample"])
        pixel = torch.where(have, c["q_pixel"], c["pixel"])
        alive, pending = path.alive | have, c["pending"] & ~pend
    else:
        sample, pixel = c["sample"], c["pixel"]
        alive, pending = torch.where(pend, have, path.alive), c["pending"]
    path, keys, depth = TI._regenerate(scene, cfg, seed, pixel, sample, path,
                                       c["keys"], c["depth"], have, pend,
                                       alive)
    return regen_planes(dict(c, path=path, keys=keys, depth=depth,
                             sample=sample, pixel=pixel, pending=pending))


def _cloned(x):
    """A tensor, or a (named) tuple of them, copied."""
    if isinstance(x, tuple):
        return type(x)(*(_cloned(y) for y in x))
    return x.clone()


def regen_launch(rp, c, queue=True):
    """R once on a copy of carry `c`, as the work queue (`queue`: the
    claimed pair, the pending plane) or the regen scheduler (the lane's
    own pair, the alive plane `alive & ~pend`) launches it.  Returns the
    planes as `regen_planes`."""
    from rtw_tpu_torch.ops import shade_kernel as SK

    c = {k: _cloned(v) for k, v in c.items()}
    path = c["path"]
    if queue:
        SK.regen(rp, c["have"], c["pend"], path, c["keys"], c["depth"],
                 c["q_sample"], c["q_pixel"], c["pending"])
    else:
        path = path._replace(alive=path.alive & ~c["pend"])
        SK.regen(rp, c["have"], c["pend"], path, c["keys"], c["depth"],
                 c["sample"], c["pixel"])
    return regen_planes(dict(c, path=path))


def regen_planes(c):
    """{name: plane} of the planes R writes, each float plane as its bits
    (int32)."""
    path = c["path"]
    out = {}
    for name, v in path._asdict().items():
        for tag, t in (zip("xyz", v) if isinstance(v, tuple) else [("", v)]):
            key = f"{name}.{tag}" if tag else name
            out[key] = t.view(torch.int32) if t.is_floating_point() else t
    for name in ("keys", "depth", "pending"):
        out[name] = c[name]
    return out


def regen_mismatch(got, want):
    """The planes of `got` whose values or bits differ from `want`'s."""
    return [k for k in want if not torch.equal(got[k], want[k])]


def phase_regen():
    """Kernel R (`SK.regen`) against the torch merge it replaces
    (`integrator._regenerate` with the queue's selects, `regen_plain`) at
    scene 4's 1200x600 = 720,000 lanes: the queue's launch with `have` /
    `pend` empty, full, random and disjoint, and the regen scheduler's
    launch, every plane bit-equal; R timed with no lane and with every
    lane claimed, a call in turns with the torch merge (CUDA events) and
    the kernel alone (torch.profiler), beside R's byte bound.  Returns the
    kernels line's row, less its launches (the scene-4 render
    of `phase_split_main` gives them)."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import shade_kernel as SK

    cfg = rtt.RenderConfig(nx=REGEN_NX, ny=REGEN_NY, spp=20,
                           max_depth=BENCH_DEPTH, scene_id=REGEN_SCENE)
    scene = rtt.build_scene(REGEN_SCENE, REGEN_NX, REGEN_NY)
    rp = SK.regen_params(scene, cfg, REGEN_SEED)
    n = REGEN_NX * REGEN_NY
    parts, bad = [], []
    for masks in REGEN_MASKS:
        c = regen_carry(cfg, n, masks, seed=len(parts))
        for queue in (True, False) if masks != "disjoint" else (True,):
            off = regen_mismatch(regen_launch(rp, c, queue),
                                 regen_plain(scene, cfg, REGEN_SEED, c,
                                             queue))
            kind = "queue" if queue else "regen"
            parts.append(f"{masks} ({kind}): {int(c['have'].sum())} claimed,"
                         f" planes off {off or 'none'}")
            bad += off
    torch.cuda.synchronize()
    full, none = (regen_carry(cfg, n, m, seed=9) for m in ("full", "empty"))

    def launch(c):
        return lambda: SK.regen(rp, c["have"], c["pend"], c["path"],
                                c["keys"], c["depth"], c["q_sample"],
                                c["q_pixel"], c["pending"])
    plain = regen_carry(cfg, n, "full", seed=9)
    ms, plain_ms, turns = _turns(
        launch(full), lambda: regen_plain(scene, cfg, REGEN_SEED, plain))
    ms_none = _time_ms(launch(none), 50)
    # the kernel alone: back to back, the events above also time the
    # wrapper's host work, which is longer than the kernel
    device_ms = _device_ms(launch(full), "regen_kernel")
    device_ms_none = _device_ms(launch(none), "regen_kernel")
    bound = 1e3 * n * REGEN_BYTES_FULL / HBM_BYTES_PER_S
    bound_none = 1e3 * n * REGEN_BYTES_NONE / HBM_BYTES_PER_S
    report = (f"R against the torch merge at scene {REGEN_SCENE}'s "
              f"{REGEN_NX}x{REGEN_NY} = {n} lanes: {'; '.join(parts)}; every "
              f"lane claimed {ms:.4f} ms a call, the kernel alone "
              f"{device_ms:.4f} ms, plain {plain_ms:.3f} ms ({turns}), bound "
              f"{bound:.4f} ms (bytes); no lane claimed {ms_none:.4f} ms a "
              f"call, the kernel alone {device_ms_none:.4f} ms, bound "
              f"{bound_none:.5f} ms")
    print(f"[38 regen] {report} on {card_line()}", flush=True)
    if bad:
        raise AssertionError(report)
    return dict(max_abs_err=0.0, ms=ms, ms_none=ms_none, device_ms=device_ms,
                device_ms_none=device_ms_none, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes")


def phase_shade_renders(every_path=False):
    """Scenes 1, 2 and 4 at bench_scenes' workloads with E and F
    (`_shade_render`); with `every_path` (--profile) also the other split
    paths of phases 18, 19 and 23: the 16384- and 65536-sphere fields, the
    lit field, and scene 2 with tea, threefry and book and scene 1 with
    the counters.  Returns {path: metrics}."""
    import rtw_tpu_torch as rtt

    out = {}
    for sid, (nx, ny, spp) in SPLIT_WORKLOADS.items():
        cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                               scene_id=sid)
        out[f"scene{sid}"] = _shade_render(
            "37 shade renders", f"scene {sid}",
            rtt.build_scene(sid, nx, ny), cfg)
    if not every_path:
        return out
    for n, lit in ((FIELDS[0], False), (FIELDS[1], False), (LIT_FIELD, True)):
        path = f"field{n}{'lit' if lit else ''}"
        out[path] = _shade_render("37 shade renders", path,
                                 _field(n, lit)[0], _field_cfg())
    for path, sid, opts in OPTION_PATHS:
        nx, ny, spp = SPLIT_WORKLOADS[sid]
        cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                               scene_id=sid, **opts)
        out[f"scene{sid}{path}"] = _shade_render(
            "37 shade renders", f"scene {sid} {path}",
            rtt.build_scene(sid, nx, ny), cfg)
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
    bound = _mega_bound(scene, sf, si, params)
    print(f"[12 hybrid step times] scene {QMEGA_SCENE} {sf.shape[1]} lanes "
          f"({int((si[MK.I_ALIVE] > 0).sum())} live), carry of hybrid launch "
          f"10: {times}; bound {bound[0]:.4f} ms ({bound[1]}); nearest hit, "
          f"{_divergence_report(bound[2])}", flush=True)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None)


def phase_qmega_small():
    """scheduler="qmega" on scene 1 at 128x128, 8 spp, depth 10: the
    hybrid kernel against the same render with the plain twin on the card:
    equal rays and every pixel within 1e-4."""
    import rtw_tpu_torch as rtt

    cfg = rtt.RenderConfig(nx=128, ny=128, spp=8, max_depth=10,
                           scene_id=QMEGA_SCENE, scheduler="qmega")
    scene = rtt.build_scene(QMEGA_SCENE, cfg.nx, cfg.ny)
    mk, mp = {}, {}
    n0 = _launch_counts()["mega_step"]
    img_k = rtt.render(scene, cfg, metrics=mk)
    if _launch_counts()["mega_step"] == n0:
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
    (`queue`: phase 8's metrics, this run).  Returns (launch count,
    metrics)."""
    import rtw_tpu_torch as rtt

    nx, ny, spp = SPLIT_WORKLOADS[QMEGA_SCENE]
    cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                           scene_id=QMEGA_SCENE, scheduler="qmega")
    scene = rtt.build_scene(QMEGA_SCENE, nx, ny)
    rtt.render(scene, cfg)                      # warm-up
    m = {}
    _reset_launches()
    img = rtt.render(scene, cfg, metrics=m)
    launches = _launch_counts()["mega_step"]
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
    return launches, m


@functools.lru_cache(maxsize=None)
def _field(n, light=False):
    """(scene, build seconds): the n-sphere stress field on the card, built
    once a run."""
    from rtw_tpu_torch.models.registry import build_stress_scene

    t0 = time.perf_counter()
    scene = build_stress_scene(n, light=light)
    torch.cuda.synchronize()
    return scene, time.perf_counter() - t0


@contextlib.contextmanager
def _threshold(blocks):
    """The hierarchy's threshold (ops/trace_kernel.TWO_LEVEL_MIN) set to
    `blocks` while the block runs; every render and `split_tables` call in
    it builds its tables under it.  None leaves it as it is."""
    from rtw_tpu_torch.ops import trace_kernel as TK

    kept = TK.TWO_LEVEL_MIN
    if blocks is not None:
        TK.TWO_LEVEL_MIN = blocks
    try:
        yield
    finally:
        TK.TWO_LEVEL_MIN = kept


def _field_threshold(n):
    """The 2500-sphere field (40 blocks) is walked with the threshold at 32:
    two full nodes and a ragged one."""
    return _threshold(32 if n == SMALL_FIELD else None)


def _field_cfg(**kw):
    import rtw_tpu_torch as rtt

    nx, ny, spp = FIELD_WORKLOAD
    return rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=FIELD_DEPTH,
                            scene_id=0, **kw)


def phase_table():
    """The hierarchy tables of the 2500-, 16384-, 65536- and 262144-sphere
    fields, built on the card: scene build seconds, table build seconds,
    blocks and nodes per level."""
    from rtw_tpu_torch.ops import trace_kernel as TK

    for n in (SMALL_FIELD, *FIELDS):
        scene, build_s = _field(n)
        with _field_threshold(n):
            t0 = time.perf_counter()
            tables = TK.split_tables(scene)
            torch.cuda.synchronize()
            table_s = time.perf_counter() - t0
            levels = [TK._level_counts(e) for e in scene.chunk_plan]
        if not any(levels):
            raise AssertionError(f"{n} spheres: no group is walked")
        print(f"[15 table] {n} spheres: scene built in {build_s:.2f} s, "
              f"tables in {table_s:.4f} s; {tables.n_blocks} blocks, nodes "
              f"per level {levels}, AABB table "
              f"{tuple(tables.aabbs.shape)}, props "
              f"{tables.props.numel() * 4 / 2 ** 20:.2f} MiB", flush=True)


def phase_scale_kernels():
    """B and C against their plain versions at scale: random rays (origins
    within +-250, normal directions), every 8th lane dead, on the four
    fields; winners and occlusion equal on every lane, fields within 1e-4,
    and every winner's block reachable by `reachable_blocks`.  Returns the
    worst max abs diff per kernel."""
    from rtw_tpu_torch.ops import trace_kernel as TK
    from rtw_tpu_torch.ops.intersect import BIG
    from rtw_tpu_torch.ops.vec import Vec3

    worst = {"trace": 0.0, "occluded": 0.0}
    for n in (SMALL_FIELD, *FIELDS):
        scene, _ = _field(n)
        rays = FIELD_RAYS[n]
        g = torch.Generator(device="cuda").manual_seed(300 + n)
        o = Vec3(*(500.0 * torch.rand((3, rays), generator=g, device="cuda")
                   - 250.0))
        d = Vec3(*torch.randn((3, rays), generator=g, device="cuda"))
        time_ = torch.zeros(rays, device="cuda")
        vol_u = torch.full((1, rays), 0.5, device="cuda")
        dead = torch.arange(rays, device="cuda") % 8 == 7
        tmax = torch.where(dead, -BIG, 1e27)
        occ_tmax = torch.where(dead, -BIG, 700.0 * torch.rand(
            rays, generator=g, device="cuda"))
        with _field_threshold(n):
            tables = TK.split_tables(scene)
        err, rep = _compare_trace(f"B {n} spheres, {rays} rays", scene,
                                  tables, (o, d, 1e-6, tmax, time_, vol_u),
                                  min_equal=1.0)
        worst["trace"] = max(worst["trace"], err)
        print(f"[16 scale kernels] {rep}", flush=True)
        err, rep = _compare_occluded(
            f"C {n} spheres, {rays} rays", scene, tables,
            (o, d, 5e-5, occ_tmax, time_, vol_u), min_equal=1.0)
        worst["occluded"] = max(worst["occluded"], err)
        print(f"[16 scale kernels] {rep}", flush=True)
        hit, _ = TK.trace(scene, o, d, 1e-6, tmax, time_, vol_u, tables)
        won = hit.prim_idx >= 0
        reach = TK.reachable_blocks(tables, o, d, 1e-6, tmax)
        blocks = TK.prim_blocks(scene)[hit.prim_idx.clamp_min(0)]
        held = reach[blocks, torch.arange(rays, device="cuda")]
        if not bool(held[won].all()):
            raise AssertionError(f"{n} spheres: {int((won & ~held).sum())} "
                                 "winners lie in blocks the walk cannot "
                                 "reach")
        print(f"[16 scale kernels] {n} spheres: every winner's block "
              f"({int(won.sum())} hits) is reachable; the walk can reach "
              f"{float(reach.float().mean()):.4f} of the (block, ray) pairs",
              flush=True)
    return worst


def _mega_step_row(label, scene, cfg, params, sf, si, hybrid,
                   tag="17 mega at scale", traced=None):
    """One megakernel step against its plain twin at a carry (every lane
    equal), then its times in turns and its bound on the rays it traces:
    the carry's alive lanes, or `traced`'s (sf, si) where the step makes
    them (a regenerating step from dead lanes traces the camera rays it
    regenerates).  The kernel's row of the kernels line, without its
    launches."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    err, report = _compare_step(label, scene, cfg, params, sf, si,
                                min_equal=1.0, hybrid=hybrid)
    print(f"[{tag}] {report}", flush=True)
    rays = torch.zeros(1, dtype=torch.int64, device="cuda")
    ms, plain_ms, times = _turns(
        lambda: MK.mega_step(scene, cfg, sf, si, params, rays, hybrid),
        lambda: MK.mega_step_plain(scene, cfg, sf, si, params, rays, hybrid),
        plain_reps=1, kernel_reps=20)
    bound = _mega_bound(scene, *(traced or (sf, si)), params)
    spread = ("" if bound[2] is None else
              f"; nearest hit, {_divergence_report(bound[2])}")
    print(f"[{tag}] {label}: {times}; bound {bound[0]:.4f} ms "
          f"({bound[1]}); tables "
          f"{'shared' if params.c_params.tables_shared else 'global'}"
          f"{spread}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=None)


def phase_mega_scale():
    """A and D at scale.  On the 2500-sphere field (threshold 32) one step
    of each against its plain twin.  On the 16384-sphere field A is a
    megakernel path (`_mega_path`, backend="mega") and D a path through
    `render` (scheduler="qmega", `_render_counted`), both at 512x512, 4
    spp, depth 8; then D's step against the twin at the carry of the 10th
    hybrid launch, times and bound.  Returns {"mega_trace": row,
    "mega_step": times, "mega_step_hybrid": row}."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    scene, _ = _field(SMALL_FIELD)
    for hybrid in (False, True):
        name = "mega_step_hybrid" if hybrid else "mega_step"
        cfg = (_field_cfg(scheduler="qmega") if hybrid else
               _field_cfg(backend="mega"))
        with _field_threshold(SMALL_FIELD):
            if hybrid:
                (_, _, sf, si, params, _), _ = _capture(
                    cfg, {"mega_step": (MK, "mega_step")},
                    scene=scene)["mega_step"]
            else:
                params, sf, si = _carry_after(scene, cfg, 10)
            if not any(r[0] for r in params.tables.layout):
                raise AssertionError(f"{SMALL_FIELD} spheres: no group is "
                                     "walked")
            label = (f"{name} {SMALL_FIELD} spheres, {sf.shape[1]} lanes, "
                     f"carry {'of hybrid launch' if hybrid else 'after'} 10")
            _, report = _compare_step(label, scene, cfg, params, sf, si,
                                      min_equal=1.0, hybrid=hybrid)
            print(f"[17 mega at scale] {report}", flush=True)

    scene, _ = _field(MEGA_FIELD)
    out = _mega_path("17 mega at scale", scene, _field_cfg(backend="mega"),
                     f"{MEGA_FIELD} spheres")
    cfg = _field_cfg(scheduler="qmega")
    img, m, counts = _render_counted(scene, cfg)
    launches = counts["step"]             # every step of qmega is hybrid
    if launches <= 0:
        raise AssertionError(f"qmega on {MEGA_FIELD} spheres launched no "
                             "hybrid kernel")
    print(f"[17 mega at scale] mega_step_hybrid path, {MEGA_FIELD} spheres "
          f"{cfg.nx}x{cfg.ny} spp {cfg.spp} depth {cfg.max_depth}: "
          f"{m['wall_seconds']:.3f} s, {m['rays']} rays, "
          f"{m['mrays_per_sec']:.2f} Mrays/s, {launches} launches, mean "
          f"{_fmt(img.reshape(-1, 3).mean(0).cpu().numpy())} on "
          f"{card_line()}", flush=True)
    (_, _, sf, si, params, _), _ = _capture(
        cfg, {"mega_step": (MK, "mega_step")}, scene=scene)["mega_step"]
    out["mega_step_hybrid"] = _mega_step_row(
        f"mega_step_hybrid {MEGA_FIELD} spheres, {sf.shape[1]} lanes, carry "
        f"of hybrid launch 10", scene, cfg, params, sf, si, True)
    out["mega_step_hybrid"]["launches"] = launches
    return out


def _field_render(tag, label, scene, cfg, need_occluded=False):
    """One path through `render`: warm-up with the identical config, then
    the timed render with the split kernels' launch counts set to 0 just
    before it and read just after (one E launch per B launch, one F per
    C launch).  Returns (trace launches, occlusion launches, metrics,
    {kernel: launches})."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import shade_kernel as SK

    rtt.render(scene, cfg)                     # warm-up
    m = {}
    _reset_launches()
    img = rtt.render(scene, cfg, metrics=m)
    launched = _launch_counts()
    nt, no = launched["trace"], launched["occluded"]
    if nt <= 0 or (need_occluded and no <= 0):
        raise AssertionError(f"{label}: launches trace {nt} occluded {no}")
    _check_shade_launches(label, launched, SK.has_nee(scene, cfg))
    if tuple(img.shape) != (cfg.ny, cfg.nx, 3) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError(f"{label}: bad image {tuple(img.shape)}")
    mean = img.reshape(-1, 3).mean(0).cpu().numpy()
    print(f"[{tag}] {label} {cfg.nx}x{cfg.ny} spp {cfg.spp} depth "
          f"{cfg.max_depth}: {m['wall_seconds']:.3f} s, {m['rays']} rays, "
          f"{m['mrays_per_sec']:.2f} Mrays/s, {nt} iterations, launches "
          f"{launched}, mean {_fmt(mean)} on {card_line()}",
          flush=True)
    return nt, no, m, launched


def _against_plain_queue(tag, label, scene, cfg):
    """`auto` (the queue with kernels B and C) against the plain queue
    (backend="jnp") on the card: equal rays, every pixel within 1e-4, and
    with cfg.bounce_stats equal counters."""
    import dataclasses

    import rtw_tpu_torch as rtt

    mk, mp = {}, {}
    n0 = _launch_counts()["trace"]
    img_k = rtt.render(scene, cfg, metrics=mk)
    if _launch_counts()["trace"] == n0:
        raise AssertionError(f"{label}: auto launched no trace kernel")
    img_p = rtt.render(scene, dataclasses.replace(
        cfg, backend="jnp", scheduler="queue"), metrics=mp)
    close = ((img_k - img_p).abs() <= 1e-4 + 1e-4 * img_p.abs()).all(-1)
    report = (f"{label} {cfg.nx}x{cfg.ny} spp {cfg.spp} depth "
              f"{cfg.max_depth}: rays {mk['rays']} vs {mp['rays']}, pixels "
              f"within 1e-4: {float(close.float().mean()):.5f} "
              f"({int((~close).sum())} outside)")
    if (mk["rays"] != mp["rays"] or not bool(close.all())
            or not bool(torch.isfinite(img_k).all())):
        raise AssertionError(f"{report}: needs equal rays and every pixel")
    if cfg.bounce_stats:
        differ = [k for k in COUNTER_METRICS if mk[k] != mp[k]]
        report += (f", counters equal ({mk['wavefront_iterations']:.0f} "
                   f"iterations, mean occupancy {mk['mean_occupancy']:.4f})")
        if differ:
            raise AssertionError(f"{report}: counters differ: {differ}")
    print(f"[{tag}] {report}", flush=True)


def phase_scale_path():
    """The scale path: `render` of the 16384-, 65536- and 262144-sphere
    fields at tools/stress_scale.py's 512x512, 4 spp, depth 8 with
    scheduler="auto" (the work queue with B walking the hierarchy), and of
    the 16384 and 65536 fields with the flat block scan (the threshold
    raised, the tool's --flat) in the same call; one 128x128 render of the
    16384 field against the plain queue.  Returns {n: (trace launches,
    occlusion launches, metrics)} of the walked renders."""
    import rtw_tpu_torch as rtt

    counts = {}
    for n in FIELDS:
        scene, _ = _field(n)
        counts[n] = _field_render("18 scale path", f"{n} spheres, walk",
                                  scene, _field_cfg())
        if n <= 65536:
            with _threshold(10 ** 9):
                _field_render("18 scale path", f"{n} spheres, flat scan",
                              scene, _field_cfg())
    cfg = rtt.RenderConfig(nx=128, ny=128, spp=4, max_depth=FIELD_DEPTH,
                           scene_id=0)
    _against_plain_queue("18 scale path", f"{FIELDS[0]} spheres",
                         _field(FIELDS[0])[0], cfg)
    return counts


def phase_lit_path():
    """C on a path: the 65536-sphere field with one light above it, through
    `render` at 512x512, 4 spp, depth 8, and one 128x128 render (2 spp)
    against the plain queue.  Returns (trace launches, occlusion launches,
    metrics)."""
    import rtw_tpu_torch as rtt

    scene, build_s = _field(LIT_FIELD, True)
    print(f"[19 lit path] {LIT_FIELD} spheres and a light: built in "
          f"{build_s:.2f} s, plan {scene.chunk_plan}", flush=True)
    counts = _field_render("19 lit path", f"{LIT_FIELD} spheres, lit", scene,
                           _field_cfg(), need_occluded=True)
    cfg = rtt.RenderConfig(nx=128, ny=128, spp=2, max_depth=FIELD_DEPTH,
                           scene_id=0)
    _against_plain_queue("19 lit path", f"{LIT_FIELD} spheres, lit", scene,
                         cfg)
    return counts


def phase_scale_step_times():
    """B on the three fields and B and C on the lit field at the inputs of
    the 10th launch of their 512x512 renders: kernel against plain (every
    lane equal), times in turns (the plain sweep once a turn), bound; B
    also with the flat block scan (the threshold raised) on the same rays.
    E (and F on the lit field) at the same launch (`_shade_steps`).
    Returns {(name, path): row}."""
    from rtw_tpu_torch.ops import trace_kernel as TK

    out = {}
    for n in FIELDS:
        field = _field(n)[0]
        got = _capture(_field_cfg(), {"trace": (TK, "trace_rows"),
                                      **_shade_wrappers(field, _field_cfg())},
                       scene=field)
        out["trace", f"field{n}"] = _split_step(
            "20 scale", f"{n} spheres", "trace", got["trace"], min_equal=1.0)
        for name, row in _shade_steps("20 scale", f"{n} spheres",
                                      got).items():
            out[name, f"field{n}"] = row
        (scene, *args, tables), _ = got["trace"]
        with _threshold(10 ** 9):
            flat_tables = TK.split_tables(scene)
        flat = TK.trace(scene, *args, flat_tables)[0]
        if not bool((flat.prim_idx == TK.trace(scene, *args, tables)[0]
                     .prim_idx).all()):
            raise AssertionError(f"{n} spheres: the flat scan and the walk "
                                 "disagree on a winner")

        def walk():
            TK.trace(scene, *args, tables)

        def scan():
            TK.trace(scene, *args, flat_tables)

        w1, f1, f2, w2 = (_time_ms(f, 20) for f in (walk, scan, scan, walk))
        print(f"[20 scale step times] trace {n} spheres, same rays: "
              f"{w1:.4f}/{w2:.4f} ms walking the hierarchy, "
              f"{f1:.4f}/{f2:.4f} ms with the flat block scan", flush=True)
    lit = _field(LIT_FIELD, True)[0]
    got = _capture(_field_cfg(), {"trace": (TK, "trace_rows"),
                                  "occluded": (TK, "occluded_kernel"),
                                  **_shade_wrappers(lit, _field_cfg())},
                   scene=lit)
    for name in ("trace", "occluded"):
        out[name, f"field{LIT_FIELD}lit"] = _split_step(
            "20 scale", f"{LIT_FIELD} spheres, lit", name, got[name],
            min_equal=1.0)
    for name, row in _shade_steps("20 scale", f"{LIT_FIELD} spheres, lit",
                                  got).items():
        out[name, f"field{LIT_FIELD}lit"] = row
    return out


def phase_profile(label, scene, cfg,
                  kernel_names=("trace_kernel", "occluded_kernel",
                                "shade_kernel", "shade_finish_kernel")):
    """torch.profiler over one full-width render: device time of the
    named kernels (default B, C, E and F; each name matched as a
    substring of the kernel's, none of the four inside another), of the
    torch glue (every other kernel, copy and set) and its launches per
    wavefront iteration (B's launches), and the idle remainder, as shares
    of the wall."""
    import rtw_tpu_torch as rtt
    from torch.profiler import ProfilerActivity, profile

    rtt.render(scene, cfg)
    m = {}
    _reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rtt.render(scene, cfg, metrics=m)
    iters = _launch_counts()["trace"]
    us = dict.fromkeys((*kernel_names, "glue"), 0.0)
    n_glue = 0
    for r in prof.key_averages():
        if not str(r.device_type).endswith("CUDA"):
            continue
        t = getattr(r, "self_device_time_total", None)
        if t is None:
            t = r.self_cuda_time_total
        key = next((k for k in kernel_names if k in r.key), "glue")
        us[key] += t
        n_glue += r.count if key == "glue" else 0
    wall_us = m["wall_seconds"] * 1e6
    busy = sum(us.values())
    shares = ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / wall_us:.1f}%)"
                       for k, v in us.items())
    per_iter = (f" ({n_glue / iters:.1f} an iteration over {iters})"
                if iters else "")
    print(f"[10 profile] {label} {cfg.nx}x{cfg.ny} spp {cfg.spp}: wall "
          f"{wall_us / 1e3:.2f} ms, {m['mrays_per_sec']:.2f} Mrays/s under "
          f"the profiler; {shares}; glue kernels {n_glue}{per_iter}; idle "
          f"{(wall_us - busy) / 1e3:.2f} ms "
          f"({100 * (wall_us - busy) / wall_us:.1f}%) on {card_line()}",
          flush=True)


def phase_profiles(spp):
    """`--profile`: the Cornell main path at `spp` (the persistent
    megakernel), scenes 2 and 4 at their split workloads and the
    65536-sphere field at the scale path's."""
    import rtw_tpu_torch as rtt

    phase_profile("scene 0", rtt.build_scene(0, BENCH_NX, BENCH_NY),
                  rtt.RenderConfig(nx=BENCH_NX, ny=BENCH_NY, spp=spp,
                                   max_depth=BENCH_DEPTH, scene_id=0),
                  ("mega_trace_kernel",))
    for sid in (2, 4):
        nx, ny, spp = SPLIT_WORKLOADS[sid]
        phase_profile(f"scene {sid}", rtt.build_scene(sid, nx, ny),
                      rtt.RenderConfig(nx=nx, ny=ny, spp=spp,
                                       max_depth=BENCH_DEPTH, scene_id=sid))
    phase_profile(f"{FIELDS[1]} spheres", _field(FIELDS[1])[0], _field_cfg())


def phase_options():
    """The option surface on the split tier (OPTION_PATHS): scene 2 at
    800x400, 16 spp, depth 20 with rng="tea", rng="threefry" and
    estimator="book", and scene 1 with the counters.  For each path:
    warm-ups, then renders in turns, the fast, mis, counter-free render of
    the same scene (F) and the path's (O): F, O, O, F, with B's and C's
    launch counts set to 0 just before the first O and read just after (C
    and F run where NEE does: not under "book", not on scene 1; E at every
    B launch); B, C, E and F against plain at the inputs of the path's
    10th launch, with times and bound;
    a 128x128, 8 spp, depth 10 render of the path against the plain queue
    on the card (`_against_plain_queue`).  Returns {(kernel, path): row}."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import trace_kernel as TK

    out = {}
    for path, sid, opts in OPTION_PATHS:
        nx, ny, spp = SPLIT_WORKLOADS[sid]
        fast = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                                scene_id=sid)
        cfg = dataclasses.replace(fast, **opts)
        scene = rtt.build_scene(sid, nx, ny)
        label = f"scene {sid} {path}"
        nee = scene.num_lights > 0 and cfg.estimator == "mis"
        rtt.render(scene, cfg)                     # warm-ups
        rtt.render(scene, fast)
        f1, o1, o2, f2 = {}, {}, {}, {}
        rtt.render(scene, fast, metrics=f1)
        _reset_launches()
        img = rtt.render(scene, cfg, metrics=o1)
        launched = _launch_counts()
        nt, no = launched["trace"], launched["occluded"]
        rtt.render(scene, cfg, metrics=o2)
        rtt.render(scene, fast, metrics=f2)
        _check_shade_launches(label, launched, nee)
        if tuple(img.shape) != (ny, nx, 3) or not bool(
                torch.isfinite(img).all()):
            raise AssertionError(f"{label}: bad image {tuple(img.shape)}")
        if o1["rays"] != o2["rays"]:
            raise AssertionError(f"{label}: rays {o1['rays']} then "
                                 f"{o2['rays']}")
        counters = ""
        if cfg.bounce_stats:
            if any(o1[k] != o2[k] for k in COUNTER_METRICS) or (
                    o1["rays_by_depth"][0] != nx * ny * spp):
                raise AssertionError(f"{label}: counters differ between "
                                     "renders or miss the camera rays")
            counters = (f", {o1['wavefront_iterations']:.0f} iterations at "
                        f"mean occupancy {o1['mean_occupancy']:.4f}, "
                        f"{len(o1['occupancy_by_iter'])} traced")
        mean = img.reshape(-1, 3).mean(0).cpu().numpy()
        print(f"[23 options path] {label} {nx}x{ny} spp {spp} depth "
              f"{cfg.max_depth}: {o1['rays']} rays, "
              f"{o1['mrays_per_sec']:.2f} / {o2['mrays_per_sec']:.2f} "
              f"Mrays/s ({o1['wall_seconds']:.3f} / {o2['wall_seconds']:.3f}"
              f" s) beside the fast path's {f1['mrays_per_sec']:.2f} / "
              f"{f2['mrays_per_sec']:.2f} ({f1['rays']} rays); launches "
              f"{launched}{counters}, mean {_fmt(mean)} on "
              f"{card_line()}", flush=True)
        wrappers = {"trace": (TK, "trace_rows"),
                    **_shade_wrappers(scene, cfg)}
        if nee:
            wrappers["occluded"] = (TK, "occluded_kernel")
        got = _capture(cfg, wrappers, scene=scene)
        rows = {name: _split_step("23 options", label, name, got[name])
                for name in ("trace", "occluded") if name in got}
        rows.update(_shade_steps("23 options", label, got))
        for name, row in rows.items():
            out[name, f"scene{sid}{path}"] = dict(row,
                                                  launches=launched[name])
        small = dataclasses.replace(cfg, nx=128, ny=128, spp=8, max_depth=10)
        _against_plain_queue("23 options small render", label,
                             rtt.build_scene(sid, 128, 128), small)
    return out


def phase_options_off_the_megakernel():
    """Cornell at 200x200, 4 spp, depth 20 with estimator="book" and with
    rng="tea" under "auto": outside the megakernel's envelope, so the plain
    regen sweep renders it and no kernel launches (A, its step, D, B, C)
    but R, which regenerates the fast stream ("book") and not "tea"; a
    finite image.  Forced backend="mega" with "book" raises ValueError."""
    import rtw_tpu_torch as rtt

    scene = rtt.build_scene(0, 200, 200)
    parts = []
    for opts in ({"estimator": "book"}, {"rng": "tea"}):
        cfg = rtt.RenderConfig(nx=200, ny=200, spp=4, max_depth=BENCH_DEPTH,
                               scene_id=0, **opts)
        before = _launch_counts()
        m = {}
        img = rtt.render(scene, cfg, metrics=m)
        after = _launch_counts()
        grew = {k for k in after if after[k] != before[k]}
        if grew != ({"regen"} if cfg.rng == "fast" else set()):
            raise AssertionError(f"Cornell {opts}: kernels launched "
                                 f"{before} -> {after}")
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"Cornell {opts}: non-finite image")
        mean = img.reshape(-1, 3).mean(0).cpu().numpy()
        parts.append(f"{opts}: launched {sorted(grew) or 'none'}, "
                     f"{m['rays']} rays, "
                     f"{m['wall_seconds']:.3f} s, mean {_fmt(mean)}")
    try:
        rtt.render(scene, rtt.RenderConfig(nx=200, ny=200, spp=4,
                                           scene_id=0, estimator="book",
                                           backend="mega"))
    except ValueError as e:
        parts.append(f"forced mega with book: ValueError ({e})")
    else:
        raise AssertionError("forced mega with estimator='book' rendered")
    print("[24 options off the megakernel] Cornell 200x200 spp 4: "
          + "; ".join(parts), flush=True)


def phase_resume():
    """Resume on the megakernel path: Cornell at RESUME_WORKLOAD, depth
    20, spp_chunk and checkpoint_every RESUME_CHUNK, rendered once whole
    and once stopped after its second save (the save raises then), then
    resumed: the resumed image bit-equal to the whole render's, the rays
    equal, `paths` the resumed samples', and the resumed call exactly the
    remaining chunks' `mega_trace` launches, each timed with CUDA events.
    Then A against its plain twin at the first resumed chunk's inputs
    (`_against_twin`).  The files go under build/ and are removed.
    Returns the kernels line's `mega_trace` row for this path."""
    import os

    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.render import tile_permutation
    from rtw_tpu_torch.utils import checkpoint as ckpt

    nx, ny, spp = RESUME_WORKLOAD
    cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH,
                           scene_id=0, spp_chunk=RESUME_CHUNK)
    scene = rtt.build_scene(0, nx, ny)
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_checkpoints")
    os.makedirs(folder, exist_ok=True)
    whole_path, path = (os.path.join(folder, f) for f in ("whole.npz",
                                                          "stopped.npz"))
    for f in (whole_path, path):
        if os.path.exists(f):
            os.remove(f)
    kw = dict(checkpoint_every=RESUME_CHUNK)
    m_whole = {}
    whole = rtt.render(scene, cfg, metrics=m_whole,
                       checkpoint_path=whole_path, **kw)

    class Stopped(Exception):
        pass

    real_save, saved = ckpt.save, []

    def save(*a):
        real_save(*a)
        saved.append(a[-1])
        if len(saved) == 2:
            raise Stopped
    ckpt.save = save
    try:
        rtt.render(scene, cfg, checkpoint_path=path, **kw)
        raise AssertionError("the stopped render did not stop")
    except Stopped:
        pass
    finally:
        ckpt.save = real_save

    real_trace, times = MK.mega_trace, []

    def timed_trace(*a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_trace(*a)
        end.record()
        times.append((start, end))
        return out
    MK.mega_trace = timed_trace
    _reset_launches()
    m = {}
    try:
        resumed = rtt.render(scene, cfg, metrics=m, checkpoint_path=path,
                             **kw)
    finally:
        MK.mega_trace = real_trace
    launches = _launch_counts()["mega_trace"]
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in times]
    for f in (whole_path, path):
        os.remove(f)
    done = saved[-1]
    want = (spp - done) // RESUME_CHUNK
    report = (f"Cornell {nx}x{ny} spp {spp} in chunks of {RESUME_CHUNK}: "
              f"stopped after the saves at {saved} spp, resumed with "
              f"{launches} mega_trace launches ({', '.join(f'{t:.3f}' for t in ms)}"
              f" ms), rays {m['rays']} vs {m_whole['rays']}, paths "
              f"{m['paths']}, image bit-equal {bool(torch.equal(resumed, whole))}")
    if (launches != want or not torch.equal(resumed, whole)
            or m["rays"] != m_whole["rays"]
            or m["paths"] != nx * ny * (spp - done)):
        raise AssertionError(report)
    print(f"[25 resume] {report} on {card_line()}", flush=True)
    pix = torch.as_tensor(tile_permutation(nx, ny), device="cuda")
    params = MK.mega_params(scene, cfg.seed, cfg, done + RESUME_CHUNK, done)
    twin = _against_twin(scene, cfg, pix, params, done, RESUME_CHUNK)
    print(f"[25 resume check] {twin['report']}", flush=True)
    return dict(launches=launches, ms=sum(ms) / len(ms), library_ms=None,
                **{k: twin[k] for k in TWIN_KEYS})


# The gradient path (diff.py, integrator.trace_paths): the demo scene of
# rtw_tpu_torch.grad_demo at its defaults (200x200, 8 spp in chunks of 2,
# depth 8, remat) with backend="pallas", and scene 2 at 800x400, 1 spp,
# depth 20, one chunk, remat, under "auto" (at least 128 prims: B and C).
GRAD_DEMO = (200, 8, 2, 8)            # size, spp, chunk, depth
GRAD_SCENE2 = (800, 400, 20)          # nx, ny, depth
GRAD_SEED = 11
# two branches that pick the same winners give the same gradient leaves
# to this tolerance (tests/test_torch_diff.py's against the reference)
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
# render(differentiable=True) against differentiable=False on the queue:
# the hit point comes from reeval_hit's t, not B's, which may differ by
# ulps; a path whose hit moves by an ulp can part at a grazing hit or a
# Russian-roulette draw on the edge (ROADMAP "Faults found": one path in
# 1024 at PR 9's book render), so the share of pixels within 1e-4 and the
# relative gap in rays are held at these
GRAD_QUEUE_PIXELS = 0.999
GRAD_QUEUE_RAYS = 1e-4


def _grad_leaves(g):
    """[(name, tensor)] of a gradient dict: tex_color, then the camera's
    fields."""
    cam = g["camera"]
    return [("tex_color", g["tex_color"])] + [
        (f.name, getattr(cam, f.name)) for f in dataclasses.fields(cam)]


def _grad_diff(label, want, got):
    """(max abs diff, report) of two gradient dicts; raises unless every
    leaf of `got` is finite and within GRAD_RTOL / GRAD_ATOL of `want`."""
    worst, max_abs = 0.0, 0.0
    for (name, a), (_, b) in zip(_grad_leaves(want), _grad_leaves(got)):
        if not bool(torch.isfinite(b).all()):
            raise AssertionError(f"{label}: non-finite {name} gradient")
        diff = (a - b).abs()
        max_abs = max(max_abs, float(diff.max()))
        worst = max(worst, float((diff / (GRAD_ATOL + GRAD_RTOL * a.abs()))
                                 .max()))
    report = (f"{label}: max abs diff {max_abs:.3e}, {worst:.4f} of the "
              f"tolerance (rtol {GRAD_RTOL}, atol {GRAD_ATOL})")
    if worst > 1.0:
        raise AssertionError(f"{report}: beyond the tolerance")
    return max_abs, report


def _grad_step(scene, cfg, n_samples, chunk, split=None, target=None):
    """One chunked loss-and-grad call of `scene` at `cfg` on every pixel:
    {loss, grads, wall (s), trace and occluded launches, peak (MB above
    the allocation at its start)}; the launch counts set to 0 just before
    it and read just after."""
    from rtw_tpu_torch import diff as TD

    fn = TD.make_loss_and_grad_chunked(scene, cfg, n_samples, chunk, split)
    pix = torch.arange(cfg.num_pixels, device="cuda")
    if target is None:
        target = torch.zeros((cfg.num_pixels, 3), device="cuda")
    params = TD.extract_params(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _reset_launches()
    t0 = time.perf_counter()
    loss, grads = fn(params, target, pix, GRAD_SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _launch_counts()
    out = dict(loss=float(loss), grads=grads, wall=wall,
               trace=launched["trace"], occluded=launched["occluded"],
               peak_mb=(torch.cuda.max_memory_allocated() - before) / 1e6)
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"non-finite loss {out['loss']}")
    return out


def _forward_seconds(scene, cfg, n_samples):
    """(seconds, rays): one forward of every pixel's n_samples samples
    under torch.no_grad() (pass 1 of the chunked gradient), its rays
    counted on the device."""
    from rtw_tpu_torch.integrator import trace_paths_counted

    pix = torch.arange(cfg.num_pixels, device="cuda")
    rays = torch.zeros(1, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for s in range(n_samples):
            rays += trace_paths_counted(scene, cfg, pix, s, GRAD_SEED)[1]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, int(rays.item())


def _reeval_ulps(tag, label, captured, t_max):
    """The share of hit lanes whose reeval_hit t differs from B's t by
    more than one ulp of B's t, at B's captured launch inputs."""
    from rtw_tpu_torch.ops import intersect as I
    from rtw_tpu_torch.ops import trace_kernel as TK

    (scene, o, d, tmin, tmax, time_, vol_u, tables), _ = captured
    k_hit, _ = TK.trace(scene, o, d, tmin, tmax, time_, vol_u, tables)
    re = I.reeval_hit(scene, k_hit.prim_idx, o, d, tmin, t_max, time_,
                      vol_u, t_hint=k_hit.t)
    hit = k_hit.prim_idx >= 0
    ulp = torch.nextafter(k_hit.t, torch.full_like(k_hit.t, I.BIG)) - k_hit.t
    far = ((re.t - k_hit.t).abs() > ulp) & hit
    rel = ((re.t - k_hit.t).abs() / k_hit.t.abs().clamp_min(1e-30))[hit]
    share = float(far.sum()) / max(int(hit.sum()), 1)
    print(f"[{tag}] {label}: reeval_hit's t beyond one ulp of B's on "
          f"{int(far.sum())} of {int(hit.sum())} hit lanes ({share:.6f}), "
          f"max relative diff {float(rel.max()) if rel.numel() else 0.0:.3e}"
          f" on {card_line()}", flush=True)
    return share


def _split_rows(tag, label, run, launches, names=("trace", "occluded"),
                call=10):
    """The split tier's rows of the kernels line for a path: each of
    `names` (B "trace", C "occluded", E "shade", F "shade_finish") at the
    inputs of its `call`-th launch in `run()`, against plain, timed in
    turns, with its bound; `launches`: {name: the path's counted
    launches}.  Returns (rows, the captured calls)."""
    from rtw_tpu_torch.ops import shade_kernel as SK
    from rtw_tpu_torch.ops import trace_kernel as TK

    wrappers = {"trace": (TK, "trace_rows"),
                "occluded": (TK, "occluded_kernel"),
                "shade": (SK, "shade"), "shade_finish": (SK, "finish")}
    got = _capture(None, {k: wrappers[k] for k in names}, call=call,
                   run=run)
    rows = {name: _split_step(tag, label, name, got[name], call=call)
            for name in names if name in ("trace", "occluded")}
    if "shade" in names:
        rows.update(_shade_steps(tag, label, got))
    return {name: dict(row, launches=launches[name])
            for name, row in rows.items()}, got


def _grad_kernel_rows(tag, label, cfg, run, launches):
    """B's and C's rows for a gradient path (`run()`: a loss-and-grad
    call; `launches`: (trace, occluded) of the path's counted call), and
    the reeval ulp share."""
    rows, got = _split_rows(tag, label, run,
                            dict(zip(("trace", "occluded"), launches)))
    _reeval_ulps(tag, label, got["trace"], cfg.t_max)
    return rows


def phase_grad_kernels():
    """The gradient path's kernels at the demo's full width: the demo
    scene (grad_demo.demo_scene) at 200x200, 8 spp, depth 8, chunks of 2,
    remat, backend="pallas" (B and C on 40000 lanes), one chunked
    loss-and-grad call three ways: the reeval branch on B and C, the same
    branch on their plain versions (split="plain"), and the plain branch
    (backend="jnp"); the gradients must agree.  B's and C's launches per
    call: 3 passes (pass 1, pass 2's forward, its remat recompute) x depth
    x samples.  Then B and C at their 10th launch against plain, timed,
    with their bound, and reeval_hit's t against B's.  Also the forward
    alone (pass 1) and the step without remat, for the forward's share
    and the recompute's cost.  Returns {name: row}."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch import diff as TD
    from rtw_tpu_torch.grad_demo import demo_scene

    size, spp, chunk, depth = GRAD_DEMO
    cfg = rtt.RenderConfig(nx=size, ny=size, spp=spp, max_depth=depth,
                           differentiable=True, backend="pallas")
    scene = demo_scene(1.0)
    _grad_step(scene, cfg, spp, chunk)                       # warm-up
    k = _grad_step(scene, cfg, spp, chunk)
    p = _grad_step(scene, cfg, spp, chunk, split="plain")
    j = _grad_step(scene, dataclasses.replace(cfg, backend="jnp"), spp,
                   chunk)
    expect = 3 * depth * spp
    if k["trace"] != expect or k["occluded"] != expect:
        raise AssertionError(f"graddemo: launches trace {k['trace']} "
                             f"occluded {k['occluded']}, expected {expect}")
    if p["trace"] or p["occluded"] or j["trace"] or j["occluded"]:
        raise AssertionError("graddemo: the plain branches launched a "
                             "kernel")
    err_p, rep_p = _grad_diff("kernels vs plain twin", p["grads"],
                              k["grads"])
    _, rep_j = _grad_diff("kernels vs jnp branch", j["grads"], k["grads"])
    fwd, rays = _forward_seconds(scene, cfg, spp)
    nr = _grad_step(scene, dataclasses.replace(cfg, remat=False), spp,
                    chunk)
    # the recompute draws the same keyed samples and B picks the same
    # winners: remat changes no gradient
    _, rep_r = _grad_diff("remat vs no remat", nr["grads"], k["grads"])
    print(f"[26 gradient kernels] graddemo {size}x{size} spp {spp} chunk "
          f"{chunk} depth {depth} remat: loss {k['loss']:.6e} (plain twin "
          f"{p['loss']:.6e}, jnp {j['loss']:.6e}); launches per "
          f"loss-and-grad trace {k['trace']} occluded {k['occluded']} = 3 "
          f"passes (pass 1, pass 2's forward, its remat recompute) x depth "
          f"{depth} x {spp} samples ({spp // chunk} chunks of {chunk}); "
          f"{rep_p}; {rep_j}; {rep_r}; wall {k['wall']:.3f} s (plain twin "
          f"{p['wall']:.3f}, jnp {j['wall']:.3f}, no remat {nr['wall']:.3f});"
          f" the forward alone (pass 1) {fwd:.3f} s, {rays} rays, "
          f"{fwd / k['wall']:.3f} of the step; peak {k['peak_mb']:.1f} MB "
          f"(no remat {nr['peak_mb']:.1f}) on {card_line()}", flush=True)
    rows = _grad_kernel_rows(
        "26 gradient kernels", "graddemo", cfg,
        lambda: TD.make_loss_and_grad_chunked(scene, cfg, spp, chunk)(
            TD.extract_params(scene),
            torch.zeros((cfg.num_pixels, 3), device="cuda"),
            torch.arange(cfg.num_pixels, device="cuda"), GRAD_SEED),
        (k["trace"], k["occluded"]))
    for row in rows.values():
        row["max_abs_err"] = max(row["max_abs_err"], err_p)
    return rows


def phase_grad_demo():
    """The trainer: `python -m rtw_tpu_torch.grad_demo --backend pallas
    --mem-variants` in this process, its defaults otherwise (200x200, 8
    spp in chunks of 2, depth 8, 12 steps, lr 0.6).  The loss must fall at
    least 10x and every channel of the ball's albedo end nearer the truth
    than its perturbed start."""
    from rtw_tpu_torch import grad_demo

    r = grad_demo.run(["--backend", "pallas", "--mem-variants"])
    start, got, want = (np.asarray(r[k]) for k in (
        "ball_albedo_start", "ball_albedo_recovered", "ball_albedo_true"))
    print(f"[27 gradient trainer] grad_demo --backend pallas: loss "
          f"{r['loss_first']:.4e} -> {r['loss_last']:.4e} "
          f"({r['loss_first'] / max(r['loss_last'], 1e-30):.1f}x) in "
          f"{r['steps']} steps, {r['wall_seconds']:.3f} s warm "
          f"({r['wall_seconds'] / r['steps']:.3f} s a step), albedo "
          f"{_fmt(got)} (true {_fmt(want)}, start {_fmt(start)}); peak "
          f"{r['peak_hbm_mb']:.1f} MB over the steps; one loss-and-grad "
          f"call: chunk 2 + remat {r['peak_hbm_mb_chunk_remat']:.1f} MB "
          f"{r['seconds_chunk_remat']:.3f} s, full 8 spp + remat "
          f"{r['peak_hbm_mb_full_remat']:.1f} MB "
          f"{r['seconds_full_remat']:.3f} s, full 8 spp without remat "
          f"{r['peak_hbm_mb_full_noremat']:.1f} MB "
          f"{r['seconds_full_noremat']:.3f} s on {card_line()}", flush=True)
    if not r["loss_last"] * 10 <= r["loss_first"]:
        raise AssertionError("grad_demo: the loss fell less than 10x")
    if not bool((np.abs(got - want) < np.abs(start - want)).all()):
        raise AssertionError("grad_demo: a channel ended no nearer the "
                             "truth than its start")
    return r


def phase_grad_scene2():
    """Scene 2 at 800x400, 1 spp, depth 20 (B and C under "auto"): one
    chunked loss-and-grad step with remat, its launches (3 x 20), wall,
    peak memory and gradient Mrays/s (the rays of one forward of the
    frame over the step's wall); finite loss and gradients, a non-zero
    tex_color gradient; the same step on the plain twins (split="plain")
    on the full frame must give the same gradients.  Then B and C at their
    10th launch.  Returns {name: row}."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch import diff as TD

    nx, ny, depth = GRAD_SCENE2
    cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=1, max_depth=depth,
                           scene_id=2, differentiable=True)
    scene = rtt.build_scene(2, nx, ny)
    _grad_step(scene, cfg, 1, 1)                             # warm-up
    k = _grad_step(scene, cfg, 1, 1)
    if k["trace"] != 3 * depth or k["occluded"] != 3 * depth:
        raise AssertionError(f"scene2grad: launches trace {k['trace']} "
                             f"occluded {k['occluded']}, expected "
                             f"{3 * depth}")
    tex_sum = float(k["grads"]["tex_color"].abs().sum())
    if not tex_sum > 0:
        raise AssertionError("scene2grad: zero tex_color gradient")
    fwd, rays = _forward_seconds(scene, cfg, 1)
    p = _grad_step(scene, cfg, 1, 1, split="plain")
    err, rep = _grad_diff("kernels vs plain twin, full frame", p["grads"],
                          k["grads"])
    print(f"[28 gradient scene 2] {nx}x{ny} spp 1 depth {depth} remat: loss "
          f"{k['loss']:.6e} (plain twin {p['loss']:.6e}); launches trace "
          f"{k['trace']} occluded {k['occluded']} (3 passes x depth "
          f"{depth}); wall {k['wall']:.3f} s (plain twin {p['wall']:.3f}); "
          f"forward {fwd:.3f} s, {rays} rays ({fwd / k['wall']:.3f} of the "
          f"step); gradient {rays / k['wall'] / 1e6:.2f} Mrays/s; peak "
          f"{k['peak_mb']:.1f} MB; every gradient leaf finite, tex_color "
          f"|g| summed {tex_sum:.6e}; {rep} on {card_line()}", flush=True)
    rows = _grad_kernel_rows(
        "28 gradient scene 2", "scene2grad", cfg,
        lambda: TD.make_loss_and_grad_chunked(scene, cfg, 1, 1)(
            TD.extract_params(scene),
            torch.zeros((cfg.num_pixels, 3), device="cuda"),
            torch.arange(cfg.num_pixels, device="cuda"), GRAD_SEED),
        (k["trace"], k["occluded"]))
    for row in rows.values():
        row["max_abs_err"] = max(row["max_abs_err"], err)
    return rows


def phase_grad_queue():
    """render(differentiable=True) of scene 2 at 128x128, 16 spp, depth 20
    through the queue (the reeval branch on B and C) against the same
    render with differentiable=False (B's own hit record): reeval's t can
    differ from B's by ulps, so a path may part; rays within
    GRAD_QUEUE_RAYS and pixels within 1e-4 on GRAD_QUEUE_PIXELS of the
    frame."""
    import rtw_tpu_torch as rtt

    cfg = rtt.RenderConfig(nx=128, ny=128, spp=16, max_depth=BENCH_DEPTH,
                           scene_id=2, differentiable=True)
    scene = rtt.build_scene(2, 128, 128)
    md, mf = {}, {}
    n0 = _launch_counts()["trace"]
    img_d = rtt.render(scene, cfg, metrics=md)
    if _launch_counts()["trace"] == n0:
        raise AssertionError("queue parity: no trace kernel launched")
    img_f = rtt.render(scene, dataclasses.replace(cfg, differentiable=False),
                       metrics=mf)
    close = ((img_d - img_f).abs() <= 1e-4 + 1e-4 * img_f.abs()).all(-1)
    share = float(close.float().mean())
    drays = abs(md["rays"] - mf["rays"]) / mf["rays"]
    print(f"[29 gradient queue parity] scene 2 128x128 spp 16 depth "
          f"{cfg.max_depth}, queue: rays {md['rays']} (differentiable) vs "
          f"{mf['rays']} ({drays:.2e} apart), pixels within 1e-4 {share:.5f}"
          f" ({int((~close).sum())} outside, max abs diff "
          f"{float((img_d - img_f).abs().max()):.3e}), wall "
          f"{md['wall_seconds']:.3f} / {mf['wall_seconds']:.3f} s on "
          f"{card_line()}", flush=True)
    if (not bool(torch.isfinite(img_d).all()) or share < GRAD_QUEUE_PIXELS
            or drays > GRAD_QUEUE_RAYS):
        raise AssertionError("queue parity: beyond the tolerance")


# Sharding, the denoiser and the CLI (rtw_tpu_torch.parallel, denoise.py,
# cli.py, entry.py).  One rank renders on NCCL in this process; two ranks
# (rtw_tpu_torch.parallel.worker, one process each) share the one card
# through gloo with host-staged collectives: NCCL refuses two ranks on one
# device.  Their kernels time-slice the card, so a two-rank time is no
# speed figure.
SHARD_SPP = 64                          # Cornell 800x800, depth 20
SHARD_SCENE2 = (800, 400, 16)           # scene 2's split workload
SHARD_RESUME = (800, 800, 16, 4)        # Cornell: nx, ny, spp, spp_chunk
SHARD_GRAD = (200, 2, 8)                # the demo scene: size, spp, depth
# a sharded gradient against one rank's (tests/test_parallel.py's)
GRAD_SHARD_RTOL, GRAD_SHARD_ATOL = 1e-4, 1e-6
DENOISE_SCENE4 = (800, 400)
CLI_WORKLOAD = (0, 800, 800, 16)        # scene, dx, dy, ns


def _build_folder(name):
    """An empty folder of this name under build/ (which git ignores)."""
    import os

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", name)
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    return folder


def _timed_mega_trace(fn):
    """(fn(), [ms of each mega_trace call in it]): CUDA events around each
    call of the wrapper."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    real, times = MK.mega_trace, []

    def timed(*a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a)
        end.record()
        times.append((start, end))
        return out
    MK.mega_trace = timed
    try:
        out = fn()
    finally:
        MK.mega_trace = real
    torch.cuda.synchronize()
    return out, [s.elapsed_time(e) for s, e in times]


def phase_sharded_one_rank(mega, main_spp):
    """render_sharded on one rank over NCCL (a process group of world 1 in
    this process, so every collective runs): Cornell 800x800, SHARD_SPP
    spp, depth 20.  Pixel mode bit-equal to `render` with equal rays, in
    one `mega_trace` launch (timed with CUDA events); sample mode within
    1e-5.  The row's plain time, bound and error are phase 5's twin when
    it ran at SHARD_SPP (the slab is the same lanes, the launch the same
    inputs), else measured here.  Returns (row, (image, scene, cfg))."""
    import torch.distributed as dist

    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.parallel import mesh as PM
    from rtw_tpu_torch.parallel import worker
    from rtw_tpu_torch.render import tile_permutation

    cfg = rtt.RenderConfig(nx=BENCH_NX, ny=BENCH_NY, spp=SHARD_SPP,
                           max_depth=BENCH_DEPTH, scene_id=0)
    scene = rtt.build_scene(0, cfg.nx, cfg.ny)
    ref, m_ref, _ = _render_counted(scene, cfg)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{worker.free_port()}",
        world_size=1, rank=0, timeout=PM.COLLECTIVE_TIMEOUT)
    try:
        mesh = PM.make_mesh()
        if (mesh.backend, mesh.world, mesh.group is None) != ("nccl", 1,
                                                             False):
            raise AssertionError(f"not a one-rank NCCL mesh: {mesh}")
        PM.render_sharded(scene, cfg, mesh)                  # warm-up
        m, m_s = {}, {}
        (img, launches), ms = _timed_mega_trace(lambda: worker.counted(
            lambda: PM.render_sharded(scene, cfg, mesh, metrics=m)))
        img_s, launches_s = worker.counted(lambda: PM.render_sharded(
            scene, cfg, mesh, mode="samples", metrics=m_s))
    finally:
        dist.destroy_process_group()
    same = bool(torch.equal(img, ref))
    diff_s = float((img_s - ref).abs().max())
    close_s = bool(torch.allclose(img_s, ref, atol=1e-5, rtol=1e-5))
    report = (f"Cornell {cfg.nx}x{cfg.ny} spp {cfg.spp} depth "
              f"{cfg.max_depth} on one NCCL rank: pixels {m['wall_seconds']:.4f}"
              f" s, {m['rays']} rays, {m['mrays_per_sec']:.2f} Mrays/s, "
              f"{launches['mega_trace']} mega_trace launches "
              f"({', '.join(f'{t:.3f}' for t in ms)} ms), bit-equal to "
              f"render {same} (render {m_ref['wall_seconds']:.4f} s, "
              f"{m_ref['rays']} rays, {m_ref['mrays_per_sec']:.2f} Mrays/s);"
              f" samples {m_s['wall_seconds']:.4f} s, {m_s['mrays_per_sec']:.2f}"
              f" Mrays/s, {launches_s['mega_trace']} launches, max abs diff "
              f"{diff_s:.3e}")
    print(f"[30 sharded, one rank] {report} on {card_line()}", flush=True)
    if (not same or not close_s or m["rays"] != m_ref["rays"]
            or launches["mega_trace"] != 1 or launches_s["mega_trace"] != 1
            or m["devices"] != 1):
        raise AssertionError(report)
    pix = torch.as_tensor(tile_permutation(cfg.nx, cfg.ny), device="cuda")
    if not np.array_equal(PM.shard_pixels(cfg, 1, 0), pix.cpu().numpy()):
        raise AssertionError("the one-rank slab is not render's lanes")
    if main_spp == SHARD_SPP:
        twin = mega["mega_trace"]
    else:
        twin = _against_twin(scene, cfg, pix,
                             MK.mega_params(scene, cfg.seed, cfg, cfg.spp),
                             0, cfg.spp)
        print(f"[30 sharded, one rank check] {twin['report']}", flush=True)
    row = dict(launches=launches["mega_trace"], ms=sum(ms) / len(ms),
               library_ms=None, **{k: twin[k] for k in TWIN_KEYS})
    return row, (ref, scene, cfg)


def _rank_launches(results, step, names):
    """{name: [launches of each rank]} of one step of a job."""
    return {n: [r["steps"][step]["launches"][n] for r in results]
            for n in names}


def _preempted(step, path):
    """Start a checkpointing job of two ranks whose rank 0 pauses after
    each save, and kill every rank as soon as the first checkpoint
    exists."""
    import os

    from rtw_tpu_torch.parallel import worker

    procs = worker.spawn([dict(step, pause_after_save=60.0)], 2,
                         backend="gloo")
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(path):
            if any(p.poll() is not None for p, _ in procs):
                raise AssertionError("a rank ended before the first "
                                     "checkpoint")
            if time.monotonic() > deadline:
                raise AssertionError("no checkpoint within 300 s")
            time.sleep(0.05)
    finally:
        worker.stop(procs)


def phase_sharded_two_ranks(cornell):
    """Two ranks sharing the card on gloo (worker.launch): scene 2 at
    800x400, 16 spp, depth 20 in pixel mode on the queue with B and C,
    within 1e-5 of the one-rank render, with B and C launched in each rank
    (the timed render after a warm-up in each rank); Cornell in sample
    mode within 1e-5 of `render`'s image; then a two-rank Cornell render at
    16 spp in chunks of 4 killed after its first checkpoint and relaunched:
    bit-equal to an uninterrupted render.  Then B, C, E and F at the
    inputs of their 10th launch in rank 0's slab.  Returns {name: row}."""
    import os

    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.integrator import trace_wavefront
    from rtw_tpu_torch.parallel import mesh as PM
    from rtw_tpu_torch.parallel import worker
    from rtw_tpu_torch.utils import checkpoint as ckpt

    folder = _build_folder("chip_smoke_sharded")
    nx, ny, spp = SHARD_SCENE2
    kw2 = dict(nx=nx, ny=ny, spp=spp, max_depth=BENCH_DEPTH, scene_id=2)
    ref, _, cfg0 = cornell
    kw0 = dict(nx=cfg0.nx, ny=cfg0.ny, spp=cfg0.spp,
               max_depth=cfg0.max_depth, scene_id=0)
    out2, out0 = (os.path.join(folder, f) for f in ("scene2.npy",
                                                    "cornell.npy"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = worker.launch([{"kind": "render", "cfg": kw2},
                         {"kind": "render", "cfg": kw2, "out": out2},
                         {"kind": "render", "cfg": kw0, "mode": "samples",
                          "out": out0}], 2, backend="gloo")
    job_s = time.perf_counter() - t0
    split = _rank_launches(res, 1, ("trace", "occluded", "shade",
                                    "shade_finish"))
    mega = _rank_launches(res, 2, ("mega_trace",))["mega_trace"]
    walls = [r["steps"][1]["metrics"]["wall_seconds"] for r in res]
    for rank in range(2):
        _check_shade_launches(f"scene 2 rank {rank}",
                              {k: v[rank] for k, v in split.items()}, True)

    cfg = rtt.RenderConfig(**kw2)
    scene = rtt.build_scene(2, nx, ny)
    rtt.render(scene, cfg)                               # warm-up
    m_one = {}
    one = rtt.render(scene, cfg, metrics=m_one)
    img2 = torch.as_tensor(np.load(out2), device="cuda")
    close = ((img2 - one).abs() <= 1e-5 + 1e-5 * one.abs()).all(-1)
    img0 = torch.as_tensor(np.load(out0), device="cuda")
    close0 = bool(torch.allclose(img0, ref, atol=1e-5, rtol=1e-5))
    m2 = res[0]["steps"][1]["metrics"]
    report = (f"scene 2 {nx}x{ny} spp {spp}: two ranks (gloo, one card) "
              f"{', '.join(f'{w:.3f}' for w in walls)} s each, {m2['rays']} "
              f"rays, one rank {m_one['wall_seconds']:.3f} s, {m_one['rays']} "
              f"rays; launches per rank trace {split['trace']} occluded "
              f"{split['occluded']} shade {split['shade']} shade_finish "
              f"{split['shade_finish']}; pixels within 1e-5 "
              f"{float(close.float().mean()):.6f} (max abs diff "
              f"{float((img2 - one).abs().max()):.3e}); Cornell samples: "
              f"mega_trace per rank {mega}, max abs diff "
              f"{float((img0 - ref).abs().max()):.3e}; job {job_s:.1f} s")
    print(f"[31 sharded, two ranks] {report} on {card_line()}", flush=True)
    if (not bool(close.all()) or not close0
            or min(split["trace"] + split["occluded"] + mega) <= 0
            or any(r["device"] != "cuda:0" or r["backend"] != "gloo"
                   for r in res)):
        raise AssertionError(report)

    rnx, rny, rspp, rchunk = SHARD_RESUME
    kwr = dict(nx=rnx, ny=rny, spp=rspp, max_depth=BENCH_DEPTH, scene_id=0,
               spp_chunk=rchunk)
    path, out = (os.path.join(folder, f) for f in ("resume.npz",
                                                   "resumed.npy"))
    step = {"kind": "render", "cfg": kwr, "checkpoint": path,
            "checkpoint_every": rchunk, "out": out}
    _preempted(step, path)
    state = ckpt.load(path, rtt.RenderConfig(**kwr))
    if state is None or not 0 < state[2] < rspp or os.path.exists(out):
        raise AssertionError(f"preempted job: state {state and state[1:]}")
    resumed = worker.launch([step], 2, backend="gloo")
    whole = rtt.render(rtt.build_scene(0, rnx, rny), rtt.RenderConfig(**kwr))
    same = bool(np.array_equal(np.load(out), whole.cpu().numpy()))
    r0 = resumed[0]["steps"][0]
    report = (f"Cornell {rnx}x{rny} spp {rspp} in chunks of {rchunk} on two "
              f"ranks, killed after the checkpoint at {state[2]} spp, "
              f"resumed: paths {r0['metrics']['paths']}, saves {r0['saves']},"
              f" mega_trace per rank "
              f"{_rank_launches(resumed, 0, ('mega_trace',))['mega_trace']}, "
              f"bit-equal to an uninterrupted render {same}")
    print(f"[31 sharded resume] {report}", flush=True)
    if not same or r0["metrics"]["paths"] != rnx * rny * (rspp - state[2]):
        raise AssertionError(report)
    shutil.rmtree(folder)

    slab = torch.as_tensor(PM.shard_pixels(cfg, 2, 0), device="cuda")
    rows, _ = _split_rows(
        "31 sharded", "scene 2 rank 0 slab",
        lambda: trace_wavefront(scene, cfg, slab, cfg.seed, 0, cfg.spp),
        {name: sum(v) for name, v in split.items()},
        ("trace", "occluded", "shade", "shade_finish"))
    for name, row in rows.items():
        row["launches_by_rank"] = split[name]
    return rows


def phase_sharded_grad():
    """grad_sharded on two ranks sharing the card (gloo) on grad_demo's
    scene at 200x200, 2 spp, depth 8 with backend="pallas" (B and C),
    against one rank's diff.make_loss_and_grad: the loss within rtol
    1e-5, each leaf within GRAD_SHARD_RTOL / GRAD_SHARD_ATOL.  Then B and
    C at their 10th launch in rank 0's slab (`mesh.grad_local`).  Returns
    {name: row}."""
    import os

    import rtw_tpu_torch as rtt
    from rtw_tpu_torch import diff as TD
    from rtw_tpu_torch.grad_demo import demo_scene
    from rtw_tpu_torch.parallel import mesh as PM
    from rtw_tpu_torch.parallel import worker

    folder = _build_folder("chip_smoke_grad")
    size, spp, depth = SHARD_GRAD
    kw = dict(nx=size, ny=size, spp=spp, max_depth=depth,
              differentiable=True, backend="pallas")
    out = os.path.join(folder, "grad.npz")
    step = {"kind": "grad", "scene": "demo", "cfg": kw, "n_samples": spp,
            "seed": GRAD_SEED}
    res = worker.launch([step, dict(step, out=out)], 2,   # warm-up, counted
                        backend="gloo")
    split = _rank_launches(res, 1, ("trace", "occluded"))
    cfg = rtt.RenderConfig(**kw)
    scene = demo_scene(1.0)
    params = TD.extract_params(scene)
    npix = cfg.num_pixels
    target = torch.zeros((npix, 3), device="cuda")
    fn = TD.make_loss_and_grad(scene, cfg, spp)
    pix = torch.arange(npix, device="cuda")
    fn(params, target, pix, GRAD_SEED)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = fn(params, target, pix, GRAD_SEED)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    worst, max_abs = 0.0, 0.0
    with np.load(out) as z:
        loss2 = float(z["loss"])
        for i, (name, a) in enumerate(_grad_leaves(grads)):
            a = a.cpu().numpy()
            b = z[f"g{i}"]
            if not np.isfinite(b).all():
                raise AssertionError(f"non-finite sharded {name} gradient")
            diff = np.abs(a - b)
            max_abs = max(max_abs, float(diff.max()))
            worst = max(worst, float((diff / (GRAD_SHARD_ATOL
                                              + GRAD_SHARD_RTOL * np.abs(a)))
                                     .max()))
    shutil.rmtree(folder)
    rel = abs(loss2 - float(loss)) / abs(float(loss))
    secs = ", ".join(f"{r['steps'][1]['seconds']:.3f}" for r in res)
    report = (f"graddemo {size}x{size} spp {spp} depth {depth}, "
              f"backend=pallas: two ranks (gloo, one card) loss {loss2:.6e} "
              f"in {secs} s, one rank {float(loss):.6e} in {one_s:.3f} s (relative "
              f"diff {rel:.2e}); leaves max abs diff {max_abs:.3e}, {worst:.4f}"
              f" of the tolerance (rtol {GRAD_SHARD_RTOL}, atol "
              f"{GRAD_SHARD_ATOL}); launches per rank trace {split['trace']} "
              f"occluded {split['occluded']}")
    print(f"[32 sharded gradient] {report} on {card_line()}", flush=True)
    if (rel > 1e-5 or worst > 1.0
            or min(split["trace"] + split["occluded"]) <= 0):
        raise AssertionError(report)
    slab = PM.grad_slab(cfg, 2, 0, target, "cuda")
    rows = _grad_kernel_rows(
        "32 sharded gradient", "graddemo rank 0 slab", cfg,
        lambda: PM.grad_local(scene, cfg, params, *slab, npix, GRAD_SEED,
                              spp),
        (sum(split["trace"]), sum(split["occluded"])))
    for name in rows:
        rows[name]["launches_by_rank"] = split[name]
    return rows


def _launched_once(counts, name):
    """True when kernel `name` launched once and no other kernel did."""
    return counts[name] == 1 and not any(
        v for k, v in counts.items() if k != name)


ATROUS_PASSES = 5
ATROUS_TOL = 1e-5


def _atrous_passes(img, scene, cfg):
    """The à-trous kernel against its plain twin on the Cornell frame and
    its G-buffer, in ldr and hdr: each pass at the plain chain's input,
    every value within ATROUS_TOL absolute + relative; one pass of each
    (step 1) timed in turns with CUDA events beside the pass's bound.
    Returns the kernels line's row, less its launches (the counted
    `denoise` of `phase_denoise_cli` gives them)."""
    from rtw_tpu_torch import denoise as DN

    alb, nrm, _ = DN.primary_features(scene, cfg)
    sig = dict(sigma_albedo=0.13, sigma_normal=0.25)
    worst, off, n = 0.0, 0, 0
    for mode, x in (("ldr", torch.clamp(img, 0.0, 1.0) ** (1.0 / cfg.gamma)),
                    ("hdr", img.contiguous())):
        plain, sc = x, 0.5
        for it in range(ATROUS_PASSES):
            got = DN.atrous_pass(plain, alb, nrm, 1 << it, sc, **sig)
            plain = DN.atrous_pass_plain(plain, alb, nrm, 1 << it, sc, **sig)
            diff = (got - plain).abs()
            worst = max(worst, float(diff.max()))
            off += int((diff > ATROUS_TOL + ATROUS_TOL * plain.abs()).any(
                dim=-1).sum())
            n += plain.shape[0] * plain.shape[1]
            sc *= 0.5
    npix = img.shape[0] * img.shape[1]
    # harness/work.py's count: 48 f32 operations a tap, 25 taps a pixel;
    # the image and both guidance planes read once, the output written
    ops, nbytes = npix * 25 * 48, npix * 4 * 12
    bound = 1e3 * max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)
    ms, plain_ms, turns = _turns(
        lambda: DN.atrous_pass(x, alb, nrm, 1, 0.5, **sig),
        lambda: DN.atrous_pass_plain(x, alb, nrm, 1, 0.5, **sig))
    # the five passes of a frame back to back, timed with events: a pass's
    # event time matches the kernel's traced duration, so the wrapper's
    # host work hides under it
    frame_ms = _time_ms(lambda: DN.atrous(x, alb, nrm,
                                          iterations=ATROUS_PASSES), 20)
    report = (f"atrous kernel against atrous_pass_plain at {img.shape[1]}x"
              f"{img.shape[0]}, ldr and hdr, {ATROUS_PASSES} passes each: max "
              f"abs diff {worst:.3e}, {n - off} of {n} pixel-passes within "
              f"{ATROUS_TOL:g} abs + rel; one pass (step 1, hdr) {ms:.4f} ms,"
              f" plain {plain_ms:.3f} ms ({turns}), the {ATROUS_PASSES} "
              f"passes {frame_ms:.4f} ms; bound {bound:.4f} ms a pass "
              f"(operations)")
    print(f"[33 denoiser] {report} on {card_line()}", flush=True)
    if off:
        raise AssertionError(report)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="operations")


def phase_denoise_cli(cornell):
    """The denoiser and the CLI.  `primary_features` on scene 4 at 800x400
    (one launch of B) against the same G-buffer through `trace_plain` on
    the card: the hit mask equal, albedo and normal within 1e-4 on every
    lane; B at that launch's inputs against plain on every lane, timed.
    The à-trous kernel against `atrous_pass_plain` on the Cornell image
    and its G-buffer (`_atrous_passes`), then `denoise` of the image in
    ldr and hdr, timed, each one B launch and 5 à-trous launches.  Then
    `cli.main` in this process twice on scene 0 at 800x800, 16 spp.  With
    its defaults (-o plain.png): one `mega_trace` launch and no other,
    timed with CUDA events; the PNG equal to `to_srgb8(render(...))` at the
    same settings; A at that launch's inputs against its plain twin.  With
    --denoise --metrics-json --profile-dir -o out.png: the render is the
    regen sweep (the sidecar's counters are outside A's envelope), the
    G-buffer one launch of B and the filter 5 of the à-trous kernel, and
    no other; the PNG decodes, the metrics hold mrays_per_sec and
    device_memory, the trace exists; B at the G-buffer's inputs against
    plain on every lane.  Returns {path: {kernel: row}}."""
    import os

    import rtw_tpu_torch as rtt
    from rtw_tpu_torch import cli
    from rtw_tpu_torch import denoise as DN
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.ops import trace_kernel as TK
    from rtw_tpu_torch.parallel import worker
    from rtw_tpu_torch.render import tile_permutation, to_srgb8
    from PIL import Image

    nx, ny = DENOISE_SCENE4
    cfg4 = rtt.RenderConfig(nx=nx, ny=ny, scene_id=4)
    scene4 = rtt.build_scene(4, nx, ny)
    DN.primary_features(scene4, cfg4)                       # warm-up
    feats, launches = worker.counted(lambda: DN.primary_features(scene4,
                                                                 cfg4))
    real = TK.trace
    TK.trace = lambda scene, *a: TK.trace_plain(scene, *a[:6])
    try:
        plain = DN.primary_features(scene4, cfg4)
    finally:
        TK.trace = real
    errs = [float((a - b).abs().max()) for a, b in zip(feats[:2], plain[:2])]
    within = all(bool((a - b).abs().le(1e-4 + 1e-4 * b.abs()).all())
                 for a, b in zip(feats[:2], plain[:2]))
    same_mask = bool(torch.equal(feats[2], plain[2]))
    report = (f"primary_features scene 4 {nx}x{ny}: {launches['trace']} "
              f"trace launch, hit share {float(feats[2].float().mean()):.4f};"
              f" against trace_plain: mask equal {same_mask}, albedo / "
              f"normal max abs diff {errs[0]:.3e} / {errs[1]:.3e}")
    print(f"[33 denoiser] {report} on {card_line()}", flush=True)
    if launches["trace"] != 1 or not same_mask or not within:
        raise AssertionError(report)
    got = _capture(cfg4, {"trace": (TK, "trace")}, call=1,
                   run=lambda: DN.primary_features(scene4, cfg4))
    row = _split_step("33 denoiser", "scene 4 G-buffer", "trace",
                      got["trace"], call=1, min_equal=1.0)
    row["launches"] = launches["trace"]

    img, scene0, cfg0 = cornell
    atrous_row = _atrous_passes(img, scene0, cfg0)
    times = {}
    for mode in ("ldr", "hdr"):
        DN.denoise(img, scene0, cfg0, mode=mode)            # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts = worker.counted(lambda: DN.denoise(img, scene0, cfg0,
                                                        mode=mode))
        torch.cuda.synchronize()
        times[mode] = 1e3 * (time.perf_counter() - t0)
        if tuple(out.shape) != tuple(img.shape) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"denoise {mode}: bad output")
        if counts["atrous"] != ATROUS_PASSES or counts["trace"] != 1:
            raise AssertionError(f"denoise {mode}: launches {counts}")
        atrous_row["launches"] = counts["atrous"]
    print(f"[33 denoiser] denoise Cornell {cfg0.nx}x{cfg0.ny} (G-buffer + "
          f"{ATROUS_PASSES} a-trous passes, {ATROUS_PASSES} atrous and 1 "
          f"trace launches each): ldr {times['ldr']:.2f} ms, hdr "
          f"{times['hdr']:.2f} ms on {card_line()}", flush=True)

    folder = _build_folder("chip_smoke_cli")
    sid, dx, dy, ns = CLI_WORKLOAD
    base = ["-s", str(sid), "-dx", str(dx), "-dy", str(dy), "-ns", str(ns)]
    # the CLI's RenderConfig and scene at its defaults
    cfg = rtt.RenderConfig(nx=dx, ny=dy, spp=ns, max_depth=20, seed=0,
                           scene_id=sid, scheduler="auto", estimator="mis",
                           mis_bsdf_weight=True)
    scene = rtt.build_scene(sid, dx, dy, dof="reference")

    png0 = os.path.join(folder, "plain.png")
    (rc0, mega_launches), ms = _timed_mega_trace(lambda: worker.counted(
        lambda: cli.main(base + ["-o", png0])))
    with Image.open(png0) as im:
        got0 = np.asarray(im)
    want0 = to_srgb8(rtt.render(scene, cfg), cfg.gamma)
    same0 = bool(np.array_equal(got0, want0))
    report = (f"cli.main({' '.join(base)} -o plain.png): exit {rc0}, "
              f"launches {mega_launches} ({', '.join(f'{t:.3f}' for t in ms)}"
              f" ms), png equal to to_srgb8(render) {same0}")
    print(f"[33 cli] {report}", flush=True)
    if (rc0 != 0 or not _launched_once(mega_launches, "mega_trace")
            or not same0):
        raise AssertionError(report)
    pix = torch.as_tensor(tile_permutation(dx, dy), device="cuda")
    twin = _against_twin(scene, cfg, pix,
                         MK.mega_params(scene, cfg.seed, cfg, cfg.spp), 0,
                         cfg.spp)
    print(f"[33 cli check] {twin['report']}", flush=True)
    rows = {"cornellcli": {"mega_trace": dict(
        launches=mega_launches["mega_trace"], ms=sum(ms) / len(ms),
        library_ms=None, **{k: twin[k] for k in TWIN_KEYS})}}

    png, mj, prof = (os.path.join(folder, f) for f in ("out.png", "m.json",
                                                       "prof"))
    argv = base + ["--denoise", "--metrics-json", mj, "--profile-dir", prof,
                   "-o", png]
    t0 = time.perf_counter()
    rc, cli_launches = worker.counted(lambda: cli.main(argv))
    wall = time.perf_counter() - t0
    with Image.open(png) as im:
        pixels = np.asarray(im)
    with open(mj) as f:
        doc = json.load(f)
    traces = [os.path.join(prof, f) for f in os.listdir(prof)]
    report = (f"cli.main({' '.join(base)} --denoise --metrics-json "
              f"--profile-dir -o out.png): exit {rc} in {wall:.1f} s, png "
              f"{pixels.shape} {pixels.dtype}, render {doc.get('render_s')} s"
              f" under the profiler, {doc.get('mrays_per_sec', 0):.2f} "
              f"Mrays/s, device_memory {doc.get('device_memory')}, traces "
              f"{[os.path.getsize(t) for t in traces]} B, launches "
              f"{cli_launches}")
    print(f"[33 cli] {report}", flush=True)
    shutil.rmtree(folder)
    if (rc != 0 or pixels.shape != (dy, dx, 3) or "mrays_per_sec" not in doc
            or not doc.get("device_memory") or len(traces) != 1
            or cli_launches["atrous"] != ATROUS_PASSES
            or cli_launches["regen"] <= 0
            or not _launched_once(dict(cli_launches, atrous=0, regen=0),
                                  "trace")):
        raise AssertionError(report)
    got = _capture(cfg, {"trace": (TK, "trace")}, call=1,
                   run=lambda: DN.primary_features(scene, cfg))
    b_row = _split_step("33 cli", "Cornell G-buffer", "trace", got["trace"],
                        call=1, min_equal=1.0)
    b_row["launches"] = cli_launches["trace"]
    rows["cornellclidenoise"] = {"trace": b_row}
    rows["scene4denoise"] = {"trace": row}
    rows["cornelldenoise"] = {"atrous": atrous_row}
    return rows


def phase_entry():
    """entry() on the card (Cornell 64x64, 1 spp, depth 6: finite radiance
    of every pixel), then dryrun_multichip(2): two ranks sharing the card
    (gloo), both sharding modes, the sharded gradient and the queue on B
    and C, every result finite."""
    from rtw_tpu_torch import entry as E

    fn, args = E.entry()
    out = fn(*args)
    torch.cuda.synchronize()
    if tuple(out.shape) != (64 * 64, 3) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"entry: bad output {tuple(out.shape)}")
    t0 = time.perf_counter()
    res = E.dryrun_multichip(2)
    print(f"[34 entry] entry(): {tuple(out.shape)} on {out.device}, mean "
          f"{_fmt(out.mean(0).cpu().numpy())}; dryrun_multichip(2): "
          f"{[r['steps'][0] for r in res]} on {[r['device'] for r in res]} "
          f"({res[0]['backend']}) in {time.perf_counter() - t0:.1f} s",
          flush=True)


def _tool_mega_row(label, run, launches, ms):
    """A's row of the kernels line for a tool's path: `mega_trace` at the
    inputs of its first launch in `run()` against its plain twin
    (`_against_twin`); `launches` and `ms` (CUDA-event times of each
    launch) from the path's counted run."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    got = _capture(None, {"mega_trace": (MK, "mega_trace")}, call=1,
                   run=run)
    (scene, cfg, pix, params, _), _ = got["mega_trace"]
    twin = _against_twin(scene, cfg, pix, params, params.s0,
                         params.s_end - params.s0)
    print(f"[35 tools check] {label}: {twin['report']}", flush=True)
    return {"mega_trace": dict(launches=launches["mega_trace"],
                               ms=sum(ms) / len(ms), library_ms=None,
                               **{k: twin[k] for k in TWIN_KEYS})}


def phase_tools():
    """The tools of tools/*_torch.py through their functions, at reduced
    sizes: kernel_check's cases but the 131072 field (B, C, A's and D's
    steps against plain; every case must pass), bench_scenes on scene 5
    with one repeat, profile_scene on scene 2 at 4 spp (its buckets must
    sum to the device total, B's and C's non-zero), occupancy_report on
    scene 1 at 200x100, 4 spp, compare_reference on scene 0 at 400x400, 16
    spp, scene2_archaeology at 8 spp and exp_sortcost once.  Each tool's
    launches are counted from 0: a tool whose path has a kernel must have
    launched it, and one E per B and one F per C.  Then each kernel of
    each tool's path at that path's own inputs against plain, timed, with
    its bound: B, C and both steps at kernel_check's 16384-sphere case, A
    at bench_scenes' and compare_reference's launch, B, C, E and F at the
    10th launch of profile_scene's render, B and E at occupancy_report's,
    and B, C, E and F at the phantom-NEE variant's in
    scene2_archaeology.  Returns {path: {kernel: row}}."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import mega_kernel as MK
    from tools import bench_scenes_torch as BS
    from tools import compare_reference_torch as CR
    from tools import exp_sortcost_torch as ES
    from tools import kernel_check_torch as KC
    from tools import occupancy_report_torch as OR
    from tools import profile_scene_torch as PS
    from tools import scene2_archaeology_torch as SA

    def run(tool, need, fn, *args, **kw):
        _reset_launches()
        hybrid = {"mega_step_hybrid": 0}
        t0 = time.perf_counter()
        with _hybrid_launches(hybrid):
            out, ms = _timed_mega_trace(lambda: fn(*args, **kw))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {**_launch_counts(), **hybrid}
        counts["mega_step"] -= hybrid["mega_step_hybrid"]
        missing = [k for k in need if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{tool}: no launch of {missing} "
                                 f"({counts})")
        launched = ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        return (out, f"{secs:.1f} s, launches: {launched or 'none'}",
                counts, ms)

    rows = {}
    cases = [c for c in KC.CASES if c[1] != 131072]
    reports, how, counts, _ = run(
        "kernel_check", ("trace", "occluded", "mega_step",
                         "mega_step_hybrid"), KC.run_cases, cases)
    bad = [r["scene"] for r in reports if not r["pass"]]
    if bad:
        raise AssertionError(f"kernel_check: cases failing {bad}: "
                             f"{json.dumps(reports)}")
    print(f"[35 tools] kernel_check ({how}): " + "; ".join(
        f"{r['scene']} pass, {r['winner_near_tie_flips']} near-tie flips, "
        f"bit-equal lanes {r['lanes_bit_equal']}" for r in reports),
        flush=True)
    label, src, scale, shift, steps = next(c for c in cases
                                           if c[1] == MEGA_FIELD)
    field = KC.build_case_scene(src)

    def case():
        KC.check_case(label, field, scale, shift, steps)
    kc = _split_rows("35 tools", f"kernel_check {label}", case, counts,
                     call=1)[0]
    # the field's steps: the regenerating step is its first launch of
    # mega_step, from dead lanes, so it traces the camera rays of sample 0
    # that the hybrid step's carry holds alive; the hybrid step its second
    camera = KC.step_inputs(field, True)[2:]
    for key, call in (("mega_step", 1), ("mega_step_hybrid", 2)):
        got = _capture(None, {key: (MK, "mega_step")}, call=call, run=case)
        (scene, cfg, sf, si, params, _, hybrid), _ = got[key]
        kc[key] = dict(_mega_step_row(
            f"kernel_check {label} {key}", scene, cfg, params, sf, si,
            hybrid, tag="35 tools", traced=None if hybrid else camera),
            launches=counts[key])
    rows["kernelcheck"] = kc

    m, how, counts, ms = run("bench_scenes", ("mega_trace",),
                             BS.bench_scene, 5, reps=1)
    print(f"[35 tools] bench_scenes scene 5 ({how}): "
          f"{m['mrays_per_sec']:.2f} Mrays/s, {m['wall_seconds']:.4f} s",
          flush=True)
    rows["bench5"] = _tool_mega_row(
        "bench_scenes scene 5", lambda: BS.bench_scene(5, reps=1), counts,
        ms)

    prof, how, counts, _ = run("profile_scene", ("trace", "occluded"),
                               PS.profile_scene, 2, spp=4)
    buckets = prof["device_ms"]
    if abs(sum(buckets.values()) - prof["device_total_ms"]) > (
            1e-6 * prof["device_total_ms"]):
        raise AssertionError(f"profile_scene: buckets {buckets} do not sum "
                             f"to {prof['device_total_ms']} ms")
    if not all(buckets.get(b, 0) > 0 for b in ("trace_kernel", "occl_kernel",
                                                 "shade_kernel",
                                                 "shade_finish")):
        raise AssertionError(f"profile_scene: no B, C, E or F time in "
                             f"{buckets}")
    print(f"[35 tools] profile_scene scene 2 {prof['nx']}x{prof['ny']} spp "
          f"{prof['spp']} ({how}): wall {prof['wall_ms']:.2f} ms, device "
          f"{prof['device_total_ms']:.2f} ms, idle {prof['idle_ms']:.2f} ms; "
          + ", ".join(f"{k} {v:.2f}" for k, v in buckets.items()),
          flush=True)
    _check_shade_launches("profile_scene", counts, True)
    rows["profile2"] = _split_rows(
        "35 tools", "profile_scene scene 2",
        lambda: PS.profile_scene(2, spp=4), counts,
        ("trace", "occluded", "shade", "shade_finish"))[0]

    entry, how, counts, _ = run("occupancy_report", ("trace",),
                                OR.scene_entry, 1, 200, 100, 4)
    for sched, e in entry.items():
        if e["rays_by_depth"][0] != 200 * 100 * 4:
            raise AssertionError(f"occupancy_report {sched}: depth-0 rays "
                                 f"{e['rays_by_depth'][0]}, not 80000")
    print(f"[35 tools] occupancy_report scene 1 200x100 spp 4 ({how}): " +
          "; ".join(f"{k} {e['wavefront_iterations']:.0f} iterations, mean "
                    f"occupancy {e['mean_occupancy']}"
                    for k, e in entry.items()), flush=True)
    _check_shade_launches("occupancy_report", counts, False)
    rows["occupancy1"] = _split_rows(
        "35 tools", "occupancy_report scene 1",
        lambda: OR.scene_entry(1, 200, 100, 4), counts,
        ("trace", "shade"))[0]

    (out, _), how, counts, ms = run("compare_reference", ("mega_trace",),
                                    CR.compare_scene, 0, spp=16)
    print(f"[35 tools] compare_reference scene 0 400x400 spp 16 ({how}): "
          f"ssim {out['ssim']:.4f}, mae {out['mae']:.4f}; against the TPU "
          f"half: ssim {out['ssim_vs_tpu']:.4f}, mae "
          f"{out['mae_vs_tpu']:.4f}", flush=True)
    rows["compare0"] = _tool_mega_row(
        "compare_reference scene 0", lambda: CR.compare_scene(0, spp=16),
        counts, ms)

    (scores, _), how, counts, _ = run("scene2_archaeology",
                                      ("trace", "occluded"),
                                      SA.archaeology, 8)
    print(f"[35 tools] scene2_archaeology spp 8 ({how}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in scores.items()), flush=True)
    # the phantom-NEE variant as archaeology() renders it
    ny, nx = CR.reference_image(2, CR.COMMITTED_WIDTH).shape[:2]
    cfg2 = rtt.RenderConfig(nx=nx, ny=ny, spp=8, max_depth=20, scene_id=2)
    phantom = SA.variant_scene("phantom_nee", nx / ny, "cuda")
    _check_shade_launches("scene2_archaeology", counts)
    rows["archaeology2"] = _split_rows(
        "35 tools", "scene2_archaeology phantom_nee",
        lambda: CR.display_render(phantom, cfg2), counts,
        ("trace", "occluded", "shade", "shade_finish"))[0]

    times, how, _, _ = run("exp_sortcost", (), ES.run)
    if not all(0 < v < float("inf") for v in times.values()):
        raise AssertionError(f"exp_sortcost: times {times}")
    print(f"[35 tools] exp_sortcost N {ES.N} ({how}): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in times.items()) + f" on {card_line()}",
        flush=True)
    return rows


# The same figures as read on an NVIDIA H100 80GB HBM3 at 700.00 W while
# the split kernels and the hybrid step's nearest hit swept each block with
# one thread a ray (PERF.md), printed beside this run's.
BEFORE_SHARED_SWEEP = {
    "A cornell ms": "0.1073-0.1105", "A scene3 ms": "0.0316-0.0357",
    "B scene1 ms": "0.3403-0.3491", "B scene2 ms": "0.2588-0.2656",
    "B scene4 ms": "0.5647-0.5661", "B field16384 ms": "2.00-2.01",
    "B field65536 ms": "2.17-2.19", "B field262144 ms": "4.63",
    "B field65536lit ms": "2.34-2.35", "C scene2 ms": "0.2092-0.2185",
    "C scene4 ms": "0.3933-0.3956", "C field65536lit ms": "1.46-1.48",
    "D scene1 ms": "0.6199-0.6235", "D field16384 ms": "2.29-2.32",
    "cornell 64 spp Mrays/s": "8086-8992", "scene3 Mrays/s": "3337-3481",
    "scene1 Mrays/s": "14-36", "scene2 Mrays/s": "11-16",
    "scene4 Mrays/s": "9-12", "scene1 qmega Mrays/s": "28-76"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=64,
                    help="main-path samples per pixel (1000 = bench.py)")
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler breakdowns of a Cornell, a "
                         "scene-2, a scene-4 and a 65536-sphere field "
                         "render, and every split path with E and F")
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
    timed(phase_one_step)
    timed(phase_small_render)
    mega = timed(phase_main, args.spp)
    scene5 = timed(phase_scene5)
    scene3 = timed(phase_scene3)
    split_err = timed(phase_split_kernels)
    timed(phase_split_small_render)
    timed(phase_cavity)
    counts = timed(phase_split_main)
    steps = timed(phase_split_step_times)
    shade_steps = timed(phase_shade_steps)
    timed(phase_shade_renders)
    regen = timed(phase_regen)
    hybrid = timed(phase_hybrid_step)
    timed(phase_qmega_small)
    hybrid["launches"], qmega = timed(phase_qmega_main,
                                      counts[QMEGA_SCENE][2])
    timed(phase_table)
    scale_err = timed(phase_scale_kernels)
    mega_scale = timed(phase_mega_scale)
    field_counts = timed(phase_scale_path)
    field_counts[f"{LIT_FIELD}lit"] = timed(phase_lit_path)
    scale_steps = timed(phase_scale_step_times)
    option_steps = timed(phase_options)
    timed(phase_options_off_the_megakernel)
    resume = timed(phase_resume)
    grad_rows = {"graddemo": timed(phase_grad_kernels)}
    timed(phase_grad_demo)
    grad_rows["scene2grad"] = timed(phase_grad_scene2)
    timed(phase_grad_queue)
    sharded, cornell = timed(phase_sharded_one_rank, mega, args.spp)
    sharded2 = timed(phase_sharded_two_ranks, cornell)
    grad_rows["graddemosharded2"] = timed(phase_sharded_grad)
    cli_rows = timed(phase_denoise_cli, cornell)
    timed(phase_entry)
    tool_rows = timed(phase_tools)
    if args.profile:
        timed(phase_profiles, args.spp)
        timed(phase_shade_renders, True)

    now = {"A cornell ms": mega["mega_step"]["ms"],
           "A scene3 ms": scene3["mega_step"]["ms"],
           "D scene1 ms": hybrid["ms"],
           f"D field{MEGA_FIELD} ms": mega_scale["mega_step_hybrid"]["ms"],
           f"cornell {args.spp} spp Mrays/s":
               mega["mega_trace"]["mrays_per_sec"],
           "scene3 Mrays/s": scene3["mega_trace"]["mrays_per_sec"],
           "scene1 qmega Mrays/s": qmega["mrays_per_sec"]}
    for (name, path), v in [*steps.items(), *scale_steps.items()]:
        if name not in ("trace", "occluded"):
            continue
        path = f"scene{path}" if isinstance(path, int) else path
        now[f"{'B' if name == 'trace' else 'C'} {path} ms"] = v["ms"]
    for sid, (_, _, m, _) in counts.items():
        now[f"scene{sid} Mrays/s"] = m["mrays_per_sec"]
    print("[21 beside the one-thread sweep] " + "; ".join(
        f"{k} {v:.4f} (before: {BEFORE_SHARED_SWEEP.get(k, 'not read')})"
        for k, v in now.items()) + f" on {card_line()}", flush=True)

    # one entry per kernel and path: `launches` is that path's own count; a
    # mega_trace row also carries the per-iteration loop's call time and
    # launches from the same run (`loop_ms`, `loop_launches`), E's and F's
    # rows of scenes 1, 2 and 4 the kernel's own device time (`device_ms`)
    mega_src = "rtw_tpu_torch/csrc/mega_kernel.cu"
    rows = [("mega_trace", path, mega_src, "rtw_tpu/ops/mega_kernel.py:387",
             v["mega_trace"])
            for path, v in (("cornell", mega), ("scene5", scene5),
                            ("scene3", scene3),
                            (f"field{MEGA_FIELD}", mega_scale),
                            ("cornellresume", {"mega_trace": resume}),
                            ("cornellsharded", {"mega_trace": sharded}),
                            ("cornellcli", cli_rows["cornellcli"]),
                            ("bench5", tool_rows["bench5"]),
                            ("compare0", tool_rows["compare0"]))]
    rows += [("mega_step_hybrid", f"scene{QMEGA_SCENE}", mega_src,
              "rtw_tpu/ops/mega_kernel.py:437", hybrid),
             ("mega_step_hybrid", f"field{MEGA_FIELD}", mega_src,
              "rtw_tpu/ops/mega_kernel.py:437",
              mega_scale["mega_step_hybrid"]),
             ("mega_step", "kernelcheck", mega_src,
              "rtw_tpu/ops/mega_kernel.py:387",
              tool_rows["kernelcheck"]["mega_step"]),
             ("mega_step_hybrid", "kernelcheck", mega_src,
              "rtw_tpu/ops/mega_kernel.py:437",
              tool_rows["kernelcheck"]["mega_step_hybrid"])]
    def field_count(path):
        key = path[len("field"):]
        return field_counts[key if key.endswith("lit") else int(key)]
    bc = ("trace", "occluded")
    split = [(name, f"scene{sid}", v, counts[sid], split_err[name])
             for (name, sid), v in steps.items()]
    split += [(name, path, v, field_count(path), scale_err[name])
              for (name, path), v in scale_steps.items() if name in bc]
    for name, path, v, count, err in split:
        v["launches"] = count[3][name]
        v["max_abs_err"] = max(err, v["max_abs_err"])
    # E and F: each path's own launches, its row at its own 10th launch
    shade = [(name, f"scene{sid}", dict(v, launches=counts[sid][3][name]))
             for sid, r in shade_steps.items() for name, v in r.items()]
    shade += [(name, path, dict(v, launches=field_count(path)[3][name]))
              for (name, path), v in scale_steps.items() if name not in bc]
    grad_steps = [(name, path, v) for path, r in grad_rows.items()
                  for name, v in r.items()]
    grad_steps += [(name, "scene2sharded2", v) for name, v in sharded2.items()]
    grad_steps += [("trace", path, cli_rows[path]["trace"])
                   for path in ("scene4denoise", "cornellclidenoise")]
    # no pallas_call: the reference's filter is jitted jnp
    rows.append(("atrous", "cornelldenoise",
                 "rtw_tpu_torch/csrc/denoise_kernel.cu",
                 "rtw_tpu/denoise.py:atrous",
                 cli_rows["cornelldenoise"]["atrous"]))
    # no pallas_call: R stands for the XLA fusion of the reference's
    # regeneration inside its jitted queue loop
    rows.append(("regen", f"scene{REGEN_SCENE}",
                 "rtw_tpu_torch/csrc/shade_kernel.cu",
                 "rtw_tpu/integrator.py:trace_wavefront_queue",
                 dict(regen, launches=counts[REGEN_SCENE][3]["regen"])))
    grad_steps += [(name, path, v) for path in ("kernelcheck", "profile2",
                                                "occupancy1", "archaeology2")
                   for name, v in tool_rows[path].items()
                   if name in (*bc, "shade", "shade_finish")]
    for name, path, v, *_ in split + [(name, path, v) for (name, path), v
                                      in option_steps.items()] + grad_steps \
            + shade:
        if name in bc:
            src = "rtw_tpu_torch/csrc/trace_kernel.cu"
            rep = ("rtw_tpu/ops/trace_kernel.py:918" if name == "trace" else
                   "rtw_tpu/ops/trace_kernel.py:1114")
        else:
            # no pallas_call: E and F stand for the XLA fusion of the
            # reference's jitted bounce_step
            src = "rtw_tpu_torch/csrc/shade_kernel.cu"
            rep = "rtw_tpu/integrator.py:212"
        rows.append((name, path, src, rep, v))
    print(json.dumps({"kernels": [
        {"name": name, "path": path, "route": "cuda", "source": src,
         "replaces": rep,
         **{k: v[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms",
                              "loop_ms", "loop_launches",
                              "launches_by_rank", "device_ms", "ms_none",
                              "device_ms_none") if k in v}}
        for name, path, src, rep, v in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
