"""Inverse rendering on the port (the counterpart of tools/grad_demo.py).

Renders a target image of the differentiable demo scene, perturbs the
ball's albedo and recovers it by gradient descent at 200x200 px with the
spp-chunked gradient (diff.make_loss_and_grad_chunked), each chunk's
bounces checkpointed (cfg.remat).  Reports each step's loss, the wall time
of the steps and the peak memory the card allocated.

    python -m rtw_tpu_torch.grad_demo [--size 200] [--spp 8] [--chunk 2]
        [--steps 12] [--lr 0.6] [--no-remat] [--backend auto]
        [--device cuda] [--mem-variants]

`--backend pallas` runs the split tier's kernels B and C for each ray's
winner and visibility (`--backend auto` takes them only at 128 prims or
more; the demo scene has 4).  Peak memory is the card's
(torch.cuda.max_memory_allocated) above what was allocated when the steps
began.  `--mem-variants` adds the peak memory and the wall time of one
loss-and-grad call for three variants: the chunked gradient with remat,
the whole spp at once with remat, and the whole spp without it.  Prints
one JSON line to stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

BALL_ROW = 1        # the ball's texture row in the demo scene
SEED = 11


def demo_scene(aspect: float, device="cuda"):
    """A lambertian ball on a lambertian ground under one area light; the
    scene is built on `device`."""
    from rtw_tpu_torch.models import scene as S
    from rtw_tpu_torch.models.builder import SceneBuilder

    device = S.scene_device(device, "demo_scene")
    b = SceneBuilder()
    ground = b.lambertian(b.constant_texture((0.6, 0.5, 0.4)))
    ball = b.lambertian(b.constant_texture((0.3, 0.6, 0.2)))
    lt = b.constant_texture((5.0, 5.0, 5.0))
    b.sphere((0.0, -100.5, -3.0), 100.0, ground)
    b.sphere((0.0, 0.0, -3.0), 0.5, ball)
    b.rect(-1.0, 1.0, -1.0, 1.0, 3.0, True, S.AXIS_Y, b.diffuse_light(lt))
    b.add_light((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0),
                (5.0, 5.0, 5.0), tex=lt)
    b.set_camera((0, 0.3, 0), (0, 0, -3), (0, 1, 0), 45, aspect, 0.0, 1.0)
    return b.build().to(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=200)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=2)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--lr", type=float, default=0.6)
    ap.add_argument("--no-remat", action="store_true",
                    help="no checkpointing of the bounces")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "jnp", "pallas"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mem-variants", action="store_true",
                    help="also the peak memory of one loss-and-grad call "
                         "for chunk + remat, whole spp + remat and whole "
                         "spp without remat (the card only)")
    return ap.parse_args(argv)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_mb(device, fn):
    """(MB, seconds) of fn(): the card's peak allocated memory above what
    was allocated when fn started (the call's working memory; None on the
    CPU, which has no such counter), and its wall time."""
    _sync(device)
    before = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    secs = time.perf_counter() - t0
    if device.type != "cuda":
        return None, secs
    return (torch.cuda.max_memory_allocated(device) - before) / 1e6, secs


def run(argv=None) -> dict:
    """The demo; returns the JSON record it prints."""
    import rtw_tpu_torch as rtt
    from rtw_tpu_torch.diff import (extract_params, make_loss_and_grad,
                                    make_loss_and_grad_chunked,
                                    render_for_grad)

    args = parse_args(argv)
    n = args.size
    cfg = rtt.RenderConfig(nx=n, ny=n, spp=args.spp, max_depth=8,
                           differentiable=True, remat=not args.no_remat,
                           backend=args.backend)
    scene = demo_scene(1.0, args.device)
    dev = scene.device
    pix = torch.arange(cfg.num_pixels, device=dev)
    true_params = extract_params(scene)
    with torch.no_grad():
        target = render_for_grad(true_params, scene, cfg, pix, SEED,
                                 args.spp)

    params = extract_params(scene)
    params["tex_color"][BALL_ROW] = torch.tensor([0.85, 0.15, 0.75])
    start = params["tex_color"][BALL_ROW].clone()
    loss_grad = make_loss_and_grad_chunked(scene, cfg, args.spp, args.chunk)
    loss_grad(params, target, pix, SEED)               # warm-up
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    losses = []
    for step in range(args.steps):
        loss, grads = loss_grad(params, target, pix, SEED)
        # normalised descent on the ball's row only (the perturbed one: a
        # step on the whole table would clip the light's emission of 5 to
        # 1); normalised because the gradient's scale grows with the pixel
        # count, and the demo's claim is its direction
        g = grads["tex_color"][BALL_ROW]
        lr = args.lr * (0.88 ** max(0, step - 8))   # decay near the optimum
        params["tex_color"][BALL_ROW] = torch.clamp(
            params["tex_color"][BALL_ROW] - lr * g / (g.abs().max() + 1e-20),
            0.0, 1.0)
        losses.append(float(loss))
        print(f"step {step}: loss {losses[-1]:.3e}", file=sys.stderr,
              flush=True)
    _sync(dev)
    wall = time.perf_counter() - t0
    peak = ((torch.cuda.max_memory_allocated(dev) - before) / 1e6
            if dev.type == "cuda" else None)

    mem = {}
    if args.mem_variants:
        zero = torch.zeros_like(target)
        whole = dataclasses.replace(cfg, remat=True)
        for name, fn in (
                ("chunk_remat", make_loss_and_grad_chunked(
                    scene, whole, args.spp, args.chunk)),
                ("full_remat", make_loss_and_grad(scene, whole, args.spp)),
                ("full_noremat", make_loss_and_grad(
                    scene, dataclasses.replace(cfg, remat=False),
                    args.spp))):
            mb, secs = _peak_mb(dev, lambda: fn(true_params, zero, pix, SEED))
            mem[f"peak_hbm_mb_{name}"] = mb
            mem[f"seconds_{name}"] = secs

    got = params["tex_color"][BALL_ROW].cpu()
    want = true_params["tex_color"][BALL_ROW].cpu()
    return {
        **mem,
        "size": n, "spp": args.spp, "spp_chunk": args.chunk,
        "remat": not args.no_remat, "backend": args.backend,
        "steps": args.steps,
        "loss_first": losses[0], "loss_last": losses[-1],
        "ball_albedo_start": start.cpu().tolist(),
        "ball_albedo_recovered": got.tolist(),
        "ball_albedo_true": want.tolist(),
        "max_abs_err": float((got - want).abs().max()),
        "wall_seconds": wall,
        "peak_hbm_mb": peak,
    }


def main(argv=None) -> int:
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
