#!/usr/bin/env python3
"""Chip smoke test of the rtw_tpu_torch port on one CUDA card.

    python3 chip_smoke.py [--spp N]

Builds the CUDA kernels from the checkout's sources, holds each against its
plain torch twin on the card, then drives the port's main path (Cornell box,
800x800, depth 20, `--spp` samples, default 64; `--spp 1000` is bench.py's
workload) through `render`, and checks that the path launched the kernel.
Each phase prints one line; any failure raises, so the run exits non-zero
and prints no result.  With no CUDA device it exits 1.

The line before the last is `nvidia-smi`'s name and power limit of the
card; before it, one JSON object describes each kernel of the path; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

BENCH_NX = BENCH_NY = 800
BENCH_DEPTH = 20


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
    from rtw_tpu_torch.utils import kernels

    t0 = time.perf_counter()
    MK.library()
    secs = time.perf_counter() - t0
    regs = kernels.ptxas_summary("mega_kernel").replace("\n", " | ")
    print(f"[2 build] mega_kernel.cu built and loaded in {secs:.2f} s "
          f"(nvcc {kernels.build_seconds.get('mega_kernel', 0.0):.2f} s); "
          f"ptxas: {regs}", flush=True)


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
                  min_equal=0.999):
    """One kernel step against one plain step from the same carry.  i32
    rows equal on >= 99.9% of lanes, f32 rows within atol/rtol 1e-3 on those
    lanes, ray counts equal up to the lanes that differ: libm differences
    (cbrtf vs powf, sinf vs torch's sin) and near-tie winner flips may move
    a few lanes onto another path.  Returns (max abs diff, report)."""
    from rtw_tpu_torch.ops import mega_kernel as MK

    rk = torch.zeros(1, dtype=torch.int64, device="cuda")
    rp = torch.zeros_like(rk)
    k_sf, k_si = MK.mega_step(scene, cfg, sf, si, params, rk)
    p_sf, p_si = MK.mega_step_plain(scene, cfg, sf, si, params, rp)
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
    for sid in (0, 5):
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


def phase_small_render():
    """Kernel render (auto) against the plain regen path on the card."""
    import dataclasses

    import rtw_tpu_torch as rtt

    parts = []
    for sid in (0, 5):
        cfg = rtt.RenderConfig(nx=128, ny=128, spp=16, max_depth=10,
                               scene_id=sid)
        scene = rtt.build_scene(sid, cfg.nx, cfg.ny, device="cuda")
        mk, mp = {}, {}
        img_k = rtt.render(scene, cfg, metrics=mk)
        img_p = rtt.render(scene, dataclasses.replace(cfg, scheduler="regen"),
                           metrics=mp)
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
        parts.append(f"scene {sid}: means {_fmt(mean_k)} vs {_fmt(mean_p)}, "
                     f"rays {mk['rays']} vs {mp['rays']}, pixels within "
                     f"1e-4: {px:.4f}")
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


def phase_main(spp: int):
    """The main path through `render`, then the step times at its width."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.ops import mega_kernel as MK

    cfg = rtt.RenderConfig(nx=BENCH_NX, ny=BENCH_NY, spp=spp,
                           max_depth=BENCH_DEPTH, scene_id=0)
    scene = rtt.build_scene(0, cfg.nx, cfg.ny, device="cuda")
    rtt.render(scene, cfg)                    # warm-up, identical config
    m = {}
    MK.launches = 0
    img = rtt.render(scene, cfg, metrics=m)
    launches = MK.launches
    if launches <= 0:
        raise AssertionError("the main path launched no mega_step kernel")
    if tuple(img.shape) != (cfg.ny, cfg.nx, 3):
        raise AssertionError(f"main-path image has shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite main-path image")
    mean = img.reshape(-1, 3).mean(0).cpu().numpy()
    print(f"[5 main path] Cornell {cfg.nx}x{cfg.ny} spp {spp} depth "
          f"{cfg.max_depth}: {m['wall_seconds']:.3f} s, {m['rays']} rays, "
          f"{m['mrays_per_sec']:.2f} Mrays/s, {launches} launches, mean "
          f"{_fmt(mean)} on {card_line()}", flush=True)

    # kernel against plain at the main path's width and depth (640k lanes,
    # max_depth 20) from one mid-render carry, then the per-iteration step
    # times from that carry, in turns: plain, kernel, kernel, plain
    params, sf, si = _carry_after(scene, cfg, 10)
    err, report = _compare_step(f"Cornell {cfg.num_pixels} lanes, carry "
                                f"after 10 iterations", scene, cfg, params,
                                sf, si)
    print(f"[5 main-path step check] {report}", flush=True)
    rays = torch.zeros(1, dtype=torch.int64, device="cuda")

    def kernel():
        MK.mega_step(scene, cfg, sf, si, params, rays)

    def plain():
        MK.mega_step_plain(scene, cfg, sf, si, params, rays)

    plain(), kernel()
    p1 = _time_ms(plain, 5)
    k1 = _time_ms(kernel, 50)
    k2 = _time_ms(kernel, 50)
    p2 = _time_ms(plain, 5)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    per_launch = m["wall_seconds"] * 1e3 / launches
    print(f"[5 step times] {cfg.num_pixels} lanes, carry after 10 "
          f"iterations: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/"
          f"{p2:.4f} ms per iteration; main-path wall per launch "
          f"{per_launch:.4f} ms", flush=True)
    return launches, ms, plain_ms, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=64,
                    help="main-path samples per pixel (1000 = bench.py)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_device()
    phase_build()
    small_err = phase_one_step()
    phase_small_render()
    launches, ms, plain_ms, main_err = phase_main(args.spp)
    max_err = max(small_err, main_err)

    print(json.dumps({"kernels": [{
        "name": "mega_step",
        "route": "cuda",
        "source": "rtw_tpu_torch/csrc/mega_kernel.cu",
        "replaces": "rtw_tpu/ops/mega_kernel.py:387",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
