"""Command-line interface (port of rtw_tpu/cli.py).

The reference's flags, defaults, choices and clamp ranges (dx 320-3840, dy
200-2240, ns 1-10240; a scene outside 0-5 exits 1).  It renders on the
card unless `--cpu` is given.

    python -m rtw_tpu_torch.cli -s 0 -dx 600 -dy 600 -ns 1000 -o cornell.png

`--sharded` renders over the ranks of a torch.distributed job
(parallel/mesh.py), started from torchrun's environment when it is set:

    torchrun --nproc-per-node 2 -m rtw_tpu_torch.cli --cpu --sharded ...

rank 0 alone writes the image and the metrics.  `-g` is the counterpart
of the reference's `jax_debug_nans`: torch has no forward NaN trap, so it
turns on autograd's anomaly mode and raises FloatingPointError when the
linear image holds a non-finite value, before it is denoised or encoded.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time


def _clamp(v, lo, hi, name):
    if v < lo or v > hi:
        c = min(max(v, lo), hi)
        print(f"WARNING: {name}={v} out of [{lo},{hi}], clamped to {c}",
              file=sys.stderr)
        return c
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rtw_tpu_torch",
        description="Differentiable path tracer on one NVIDIA H100, the "
                    "PyTorch + CUDA port of rtw_tpu (Ray Tracing in One "
                    "Weekend series)")
    p.add_argument("-s", "--scene", type=int, default=4,
                   help="scene id 0-5 (default 4, TNW final)")
    p.add_argument("-ns", "--samples", type=int, default=20,
                   help="samples per pixel (default 20)")
    p.add_argument("-dx", "--width", type=int, default=1200)
    p.add_argument("-dy", "--height", type=int, default=600)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-g", "--debug", action="store_true",
                   help="debug mode: autograd anomaly mode, and an error "
                        "on any non-finite value in the linear image "
                        "before it is denoised or encoded")
    p.add_argument("-o", "--output", default="-",
                   help="output path (.png/.ppm) or '-' for PPM on stdout")
    p.add_argument("--max-depth", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dof", choices=["reference", "book"], default="reference",
                   help="depth of field: 'reference' = off (parity with the "
                        "reference, which never wires the lens radius), "
                        "'book' = literal scene apertures")
    p.add_argument("--estimator", choices=["mis", "reference", "book"],
                   default="mis",
                   help="'mis': NEE + MIS-weighted BSDF light hits "
                        "(unbiased, lowest variance); 'reference': NEE with "
                        "unweighted BSDF light hits, parity with the CUDA "
                        "ref; 'book': the books' literal 0.5/0.5 "
                        "cosine/light mixture (no shadow rays)")
    p.add_argument("--checkpoint", default=None,
                   help="accumulator checkpoint path (resume if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N samples (0: every spp chunk)")
    p.add_argument("--sharded", action="store_true",
                   help="shard pixels over the ranks of a torch.distributed "
                        "job (torchrun's environment; one rank without it)")
    p.add_argument("--denoise", action="store_true",
                   help="edge-avoiding a-trous post-filter guided by a "
                        "first-hit G-buffer (classical analog of the "
                        "reference's OptiX LDR denoiser; non-parity)")
    p.add_argument("--metrics-json", default=None,
                   help="write render metrics JSON next to the image")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the render into "
                        "this directory (Chrome trace; view with Perfetto)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (default: the card)")
    p.add_argument("--scheduler",
                   choices=["auto", "queue", "regen", "mega", "qmega"],
                   default="auto",
                   help="wavefront scheduler: global work-queue (fast on "
                        "uneven scenes), per-lane regeneration (bitwise "
                        "batch/mesh-shape-invariant), whole-bounce "
                        "megakernel, or the queue+megakernel hybrid; "
                        "auto picks per scene")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # reference clamp ranges (main.cpp:21-27)
    nx = _clamp(args.width, 320, 3840, "dx")
    ny = _clamp(args.height, 200, 2240, "dy")
    ns = _clamp(args.samples, 1, 10240, "ns")
    if not 0 <= args.scene <= 5:
        print(f"ERROR: Scene {args.scene} unknown.", file=sys.stderr)
        return 1

    import torch

    from rtw_tpu_torch import RenderConfig, build_scene
    from rtw_tpu_torch.models.registry import SCENE_NAMES
    from rtw_tpu_torch.render import render, to_srgb8
    from rtw_tpu_torch.utils.image import write_image
    from rtw_tpu_torch.utils.profiling import Phases, trace, write_metrics

    cfg = RenderConfig(nx=nx, ny=ny, spp=ns, max_depth=args.max_depth,
                       seed=args.seed, scene_id=args.scene,
                       scheduler=args.scheduler,
                       estimator=("book" if args.estimator == "book"
                                  else "mis"),
                       mis_bsdf_weight=(args.estimator != "reference"),
                       # metrics sidecar requested -> collect the per-bounce
                       # wavefront counters too (single-process render path)
                       bounce_stats=bool(args.metrics_json
                                         and not args.sharded))
    if args.verbose:
        print(f"INFO: {nx}x{ny}, {ns} spp, scene {args.scene}: "
              f"{SCENE_NAMES[args.scene]}", file=sys.stderr)

    device = "cpu" if args.cpu else "cuda"
    mesh = None
    if args.sharded:
        from rtw_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                                 render_sharded)

        init_distributed(backend="gloo" if args.cpu else None)
        mesh = make_mesh(device="cpu" if args.cpu else None)
        device = mesh.device
    anomaly = (torch.autograd.detect_anomaly() if args.debug
               else contextlib.nullcontext())

    phases = Phases()
    prof = (trace(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    t0 = time.time()
    with phases("scene_build"):
        scene = build_scene(args.scene, nx, ny, dof=args.dof, device=device)
    metrics: dict = {}
    with anomaly, prof, phases("render"):
        if mesh is not None:
            img = render_sharded(scene, cfg, mesh, metrics=metrics,
                                 verbose=args.verbose,
                                 checkpoint_path=args.checkpoint,
                                 checkpoint_every=args.checkpoint_every)
        else:
            img = render(scene, cfg, verbose=args.verbose, metrics=metrics,
                         checkpoint_path=args.checkpoint,
                         checkpoint_every=args.checkpoint_every)
    elapsed = time.time() - t0
    if args.verbose:
        print(f"INFO: Took {elapsed:.1f} seconds", file=sys.stderr)
    if args.debug and not bool(torch.isfinite(img).all()):
        raise FloatingPointError("non-finite value in the linear image")

    if mesh is None or mesh.rank == 0:
        if args.denoise:
            from rtw_tpu_torch.denoise import denoise

            disp = denoise(img, scene, cfg, gamma=cfg.gamma)  # display-space
            out8 = to_srgb8(disp, gamma=1.0)
        else:
            out8 = to_srgb8(img, cfg.gamma)
        write_image(out8, args.output)
        if args.metrics_json:
            write_metrics(args.metrics_json, metrics, phases)
    if mesh is not None and mesh.group is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
