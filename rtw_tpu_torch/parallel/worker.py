"""Run a sharded job as n local ranks, one process each.

    python -m rtw_tpu_torch.parallel.worker --rank R --world N --port P
        [--backend gloo|nccl] [--device cpu|cuda] STEPS_JSON

is one rank; `launch` (or `spawn` and `collect`) starts all n of them as
subprocesses on a free localhost port and reads each rank's result.  A
rank joins the process group (mesh.init_distributed; none for one rank),
runs its steps in order and prints one JSON line, its last line of output:
{"rank", "world", "backend", "device", "steps": [one result per step]}.

Steps (a JSON list; paths absolute):
- {"kind": "render", "scene": id or "demo", "cfg": {RenderConfig fields},
  "mode": "pixels"|"samples", "checkpoint": path, "checkpoint_every": k,
  "out": path.npy, "pause_after_save": s}: `render_sharded`; rank 0 saves
  the image to `out` and, with `pause_after_save`, sleeps that long after
  each checkpoint it writes (a window in which to stop the job).  Result:
  the metrics, the checkpoint saves rank 0 made, the launches.
- {"kind": "grad", "scene", "cfg", "n_samples", "seed", "out": path.npz}:
  `grad_sharded` against a zero target; rank 0 saves the loss and the
  gradient leaves.  Result: the loss, the launches.
- {"kind": "dryrun"}: entry.dryrun_rank, the multi-rank dry run.

"launches" counts each kernel's launches in the step's sharded call, set
to 0 just before it and read just after.  On the CPU each rank runs one
torch thread.  The ranks never import JAX or `rtw_tpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(steps: list, world: int, device: str = "cuda",
          backend: str | None = None) -> list:
    """Start `world` ranks running `steps` (not waited for): a list of
    (Popen, output file)."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "rtw_tpu_torch.parallel.worker",
           "--world", str(world), "--port", str(port), "--device", device]
    if backend is not None:
        cmd += ["--backend", backend]
    procs = []
    for rank in range(world):
        out = tempfile.TemporaryFile()
        procs.append((subprocess.Popen(
            cmd + ["--rank", str(rank), json.dumps(steps)], cwd=_ROOT,
            env=env, stdout=out, stderr=subprocess.STDOUT), out))
    return procs


def _output(out) -> str:
    out.seek(0)
    return out.read().decode(errors="replace")


def stop(procs) -> None:
    """Kill every rank still running and reap it."""
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
    for p, _ in procs:
        p.wait()


def collect(procs, timeout: float = 600.0) -> list[dict]:
    """Wait for every rank; each rank's result (its last JSON line).
    Raises RuntimeError, with the rank's output, when a rank fails or the
    job outlasts `timeout` (every rank is killed then)."""
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        stop(procs)
        raise RuntimeError("sharded job timed out:\n" + "\n".join(
            _output(o)[-3000:] for _, o in procs))
    results = []
    for rank, (p, out) in enumerate(procs):
        text = _output(out)
        out.close()
        if p.returncode != 0:
            stop(procs)
            raise RuntimeError(f"rank {rank} exited {p.returncode}:\n"
                               f"{text[-4000:]}")
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        results.append(json.loads(lines[-1]))
    return results


def launch(steps: list, world: int, device: str = "cuda",
           backend: str | None = None, timeout: float = 600.0) -> list[dict]:
    """Run `steps` on `world` ranks and return each rank's result, in rank
    order (`timeout`: `collect`'s)."""
    return collect(spawn(steps, world, device, backend), timeout)


# ---------------------------------------------------------------- the rank


def _counters() -> dict:
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.ops import shade_kernel as SK
    from rtw_tpu_torch.ops import trace_kernel as TK

    return {"mega_trace": (MK, "trace_launches"), "mega_step":
            (MK, "launches"), "hybrid": (MK, "hybrid_launches"),
            "trace": (TK, "trace_launches"),
            "occluded": (TK, "occluded_launches"),
            "shade": (SK, "shade_launches"),
            "shade_finish": (SK, "finish_launches")}


def counted(fn):
    """(fn(), {kernel: launches in the call}): every launch count set to 0
    just before the call and read just after."""
    counters = _counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    out = fn()
    return out, {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def _scene(spec, cfg, device):
    from rtw_tpu_torch import build_scene
    from rtw_tpu_torch.grad_demo import demo_scene

    if spec == "demo":
        return demo_scene(cfg.nx / cfg.ny, device=device)
    return build_scene(int(spec), cfg.nx, cfg.ny, device=device)


def _render_step(step, mesh):
    from rtw_tpu_torch import RenderConfig
    from rtw_tpu_torch.parallel.mesh import render_sharded
    from rtw_tpu_torch.utils import checkpoint as ckpt

    cfg = RenderConfig(**step["cfg"])
    scene = _scene(step.get("scene", cfg.scene_id), cfg, mesh.device)
    saves, real_save = [], ckpt.save
    pause = float(step.get("pause_after_save", 0.0))

    def save(*a):
        real_save(*a)
        saves.append(int(a[-1]))
        time.sleep(pause)
    ckpt.save = save
    metrics = {}
    try:
        img, launches = counted(lambda: render_sharded(
            scene, cfg, mesh, mode=step.get("mode", "pixels"),
            metrics=metrics, checkpoint_path=step.get("checkpoint"),
            checkpoint_every=int(step.get("checkpoint_every", 0))))
    finally:
        ckpt.save = real_save
    if mesh.rank == 0 and step.get("out"):
        np.save(step["out"], img.cpu().numpy())
    return {"metrics": metrics, "saves": saves, "launches": launches,
            "finite": bool(torch.isfinite(img).all())}


def _grad_step(step, mesh):
    from rtw_tpu_torch import RenderConfig
    from rtw_tpu_torch import diff as D
    from rtw_tpu_torch.parallel.mesh import grad_sharded

    cfg = RenderConfig(**step["cfg"])
    scene = _scene(step.get("scene", cfg.scene_id), cfg, mesh.device)
    params = D.extract_params(scene)
    target = torch.zeros((cfg.ny, cfg.nx, 3), device=mesh.device)
    t0 = time.perf_counter()
    (loss, grads), launches = counted(lambda: grad_sharded(
        scene, cfg, mesh, params, target, int(step.get("seed", 0)),
        int(step["n_samples"])))
    seconds = time.perf_counter() - t0
    leaves = {f"g{i}": g.cpu().numpy() for i, g in enumerate(D._leaves(grads))}
    if mesh.rank == 0 and step.get("out"):
        np.savez(step["out"], loss=np.float32(float(loss)), **leaves)
    return {"loss": float(loss), "launches": launches, "seconds": seconds,
            "finite": bool(np.isfinite(float(loss)) and all(
                np.isfinite(v).all() for v in leaves.values()))}


def _run_step(step, mesh):
    kind = step["kind"]
    if kind == "render":
        return _render_step(step, mesh)
    if kind == "grad":
        return _grad_step(step, mesh)
    if kind == "dryrun":
        from rtw_tpu_torch.entry import dryrun_rank

        return dryrun_rank(mesh)
    raise ValueError(f"unknown step kind {kind!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("steps", help="the steps, a JSON list")
    a = ap.parse_args(argv)
    if a.device == "cpu":
        torch.set_num_threads(1)
    import torch.distributed as dist

    from rtw_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(f"127.0.0.1:{a.port}", a.world, a.rank, a.backend)
    mesh = make_mesh(device="cpu" if a.device == "cpu" else None)
    results = [_run_step(step, mesh) for step in json.loads(a.steps)]
    print(json.dumps({"rank": mesh.rank, "world": mesh.world,
                      "backend": mesh.backend, "device": str(mesh.device),
                      "steps": results}), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
