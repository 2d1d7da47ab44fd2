"""The gradient call: a closed loop of loss-and-gradient steps of the
program's `diff.make_loss_and_grad_chunked`, each followed by the fit's
update of one texture row, judged against the plain gradient
(`plainref/grad.py`).

A mix with `"call": "grad_step"` gives:

- `n_samples`, `spp_chunk`: the samples per pixel of a step, and of each
  of its chunks (one backward a chunk);
- `fit`: the descent on the configuration's `fit_row` of `tex_color`:
  `start`, the row's colour in the start parameters (the other rows and
  the camera are the scene's); `lr`, `decay`, `decay_after`: step k
  (counted from the first warm-up step) moves the row by
  lr * decay ** max(0, k - decay_after) * grad / max|grad| (the row's
  gradient, normalised), clipped to [0, 1]; the camera and the other rows
  stay where they are (their gradients are still judged);
- `warmup_calls`, `max_calls`, `check.renders` (the steps judged),
  `trace_renders`, as a render mix gives them.

The configuration gives the scene, the image, the depth, `differentiable`,
`remat` and `fit_row`.  Every step takes every pixel of the image, with a
seed of its own (`traffic.call_seed`).

The order of a run:

1. set-up: import the program, build its scene; the benchmark's inputs
   from its own plain reference, never from the program: the start
   parameters (the reference scene's, the fitted row set to `start`) and
   the target (the reference's render of the unperturbed scene at
   `n_samples`, with a seed off the run's seed that no step draws); their
   seconds are the reference's and are taken out of `setup_s`; the
   device's peak is then reset, so it is the program's; the step
   function; the warm-up steps;
2. the window: steps back to back, each the program's call, the update
   and a device sync, for `--seconds`; every step keeps its seed, its
   parameters before the step, its loss and its gradients (on the host);
3. `grad_peak_gib`'s reading: the device's peak at the window's close;
4. with `--trace 1`, more steps under the profiler;
5. `memory_peak_bytes`, then the program's state is freed;
6. the judged steps computed again by the plain gradient from their kept
   parameters, target and seed, and compared;
7. the metrics and the result line (`drive.result_line`).

The numbers compared, on each judged step (the worst step counts):

- `loss_rel_err`: |program's loss - reference's| / |reference's|;
- `tex_grad_rel_l1`: the summed |program - reference| of the `tex_color`
  gradient over its summed |reference|;
- `cam_grad_rel_l1`: the same over the camera's fields together (their
  scale is not the colours');
- `nonfinite`: non-finite entries in the losses and gradients of every
  step of the window (limit 0).
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from harness import drive, traffic
from harness import trace as tr

NUMBERS = ("loss_rel_err", "tex_grad_rel_l1", "cam_grad_rel_l1",
           "nonfinite")
# the plain gradient's lanes a block: the cell's whole image of 8 spp in
# one block (~20 GB on the card at scene 2's depth 20), a third of the
# time of the reference's default blocks
REF_LANES = 1 << 19


@dataclasses.dataclass
class Step:
    """One window step as kept: its seed, the parameters before it, its
    loss and its gradients, on the host ({"tex_color": [T, 3], "camera":
    {field: tensor}} each)."""

    seed: int
    params: dict
    loss: float
    grads: dict


@dataclasses.dataclass
class GradCall:
    wall_s: float            # host clock: the call to the update's sync


@dataclasses.dataclass
class GradRun(drive.Run):
    peak_bytes: int = 0      # the device's peak at the window's close
    # time.time_ns() before and after the traced steps (the program's
    # spans of those steps lie inside), or None without a trace
    span_ns: tuple | None = None


def grad_fields(config: dict, traffic_mix: dict) -> dict:
    """The `RenderConfig` fields of every step (the seed is passed per
    step)."""
    return dict(nx=int(config["nx"]), ny=int(config["ny"]),
                spp=int(traffic_mix["n_samples"]),
                max_depth=int(config["max_depth"]),
                scene_id=int(config["scene_id"]),
                differentiable=bool(config["differentiable"]),
                remat=bool(config["remat"]),
                **traffic_mix.get("options", {}))


def target_seed(seed: int) -> int:
    """The target's render seed: the run's last call seed, which no step
    reaches (a window holds at most `max_calls` steps)."""
    return traffic.call_seed(seed, (1 << traffic.CALL_BITS) - 1)


def update(tex, grad, row: int, k: int, fit: dict):
    """`tex` after step k's descent on `row` (the mix's `fit`), out of
    place."""
    lr = float(fit["lr"]) * float(fit["decay"]) ** max(
        0, k - int(fit["decay_after"]))
    g = grad[row]
    new = tex.clone()
    new[row] = torch.clamp(tex[row] - lr * g / (g.abs().max() + 1e-20),
                           0.0, 1.0)
    return new


def make_program_step(scene, cfg, n_samples: int, spp_chunk: int):
    from rtw_tpu_torch import diff

    return diff.make_loss_and_grad_chunked(scene, cfg, n_samples=n_samples,
                                           spp_chunk=spp_chunk)


def _inputs(fields, fit_row, tcfg, seed, device):
    """(start parameters, target) from the benchmark's plain reference."""
    from plainref import config as ref_config
    from plainref import grad as ref_grad
    from plainref import paths, registry

    cfg = ref_config.RenderConfig(**fields)
    ref_scene = registry.build_scene(cfg.scene_id, cfg.nx, cfg.ny,
                                     device=device)
    target = paths.render_pixels(
        ref_scene, cfg, target_seed(seed),
        torch.arange(cfg.nx * cfg.ny, dtype=torch.int64, device=device))
    params = ref_grad.params_of(ref_scene)
    params["tex_color"][fit_row] = torch.tensor(
        tcfg["fit"]["start"], dtype=torch.float32, device=device)
    return params, target


def _to_program(params: dict, scene) -> dict:
    """The benchmark's parameters in the program's structure (its Camera)
    on its scene's device."""
    dev = scene.device
    tex = params["tex_color"].to(dev)
    if tex.shape != scene.textures.color.shape:
        raise ValueError(f"the program's scene has tex_color "
                         f"{tuple(scene.textures.color.shape)}, the "
                         f"benchmark's {tuple(tex.shape)}")
    return {"tex_color": tex,
            "camera": dataclasses.replace(scene.camera, **{
                f: t.to(dev) for f, t in params["camera"].items()})}


def _host(tree: dict) -> dict:
    """A program's parameters or gradients as host tensors, the camera's
    fields by name."""
    cam = tree["camera"]
    return {"tex_color": tree["tex_color"].detach().cpu(),
            "camera": {f.name: getattr(cam, f.name).detach().cpu()
                       for f in dataclasses.fields(cam)}}


def _rel_l1(got, ref) -> float:
    g = torch.cat([x.reshape(-1) for x in got]).double()
    r = torch.cat([x.reshape(-1) for x in ref]).double()
    g = torch.where(torch.isfinite(g), g, 0.0)
    return float((g - r).abs().sum() / r.abs().sum().clamp_min(1e-30))


def _nonfinite(steps) -> int:
    n = 0
    for s in steps:
        vals = [torch.as_tensor(s.loss), s.grads["tex_color"],
                *s.grads["camera"].values()]
        n += sum(int((~torch.isfinite(v)).sum()) for v in vals)
    return n


def compare(got: list, ref: list, every: list) -> dict:
    """The numbers of program steps `got` against reference steps `ref`
    (both [Step], one per judged step, on the host); `nonfinite` counts
    over `every` step of the window."""
    loss, tex, cam = [], [], []
    for g, r in zip(got, ref):
        lg = g.loss if np.isfinite(g.loss) else 0.0
        loss.append(abs(lg - r.loss) / max(abs(r.loss), 1e-30))
        tex.append(_rel_l1([g.grads["tex_color"]], [r.grads["tex_color"]]))
        names = sorted(r.grads["camera"])
        cam.append(_rel_l1([g.grads["camera"][f] for f in names],
                           [r.grads["camera"][f] for f in names]))
    return {"loss_rel_err": max(loss), "tex_grad_rel_l1": max(tex),
            "cam_grad_rel_l1": max(cam), "nonfinite": _nonfinite(every)}


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", make_step=None, fields=None,
             control=None, log=sys.stderr) -> dict:
    """One run of a gradient mix (the cards already looked for); as
    `drive.run_cell`.  `make_step(scene, cfg, n_samples, spp_chunk)`
    replaces the program's `diff.make_loss_and_grad_chunked` (tests plant
    faults there); `control` (a dtype) also judges the plain gradient
    computed in it, under `control_checks`."""
    import rtw_tpu_torch as rtt

    make_step = make_step or make_program_step
    tcfg = cell.traffic
    fields = fields or grad_fields(cell.config, tcfg)
    cfg = rtt.RenderConfig(**fields)
    scene = rtt.build_scene(cfg.scene_id, cfg.nx, cfg.ny, device=device)
    npix = cfg.nx * cfg.ny
    n_samples, row = int(tcfg["n_samples"]), int(cell.config["fit_row"])
    t_in = time.perf_counter()
    ref_params, target = _inputs(fields, row, tcfg, seed, device)
    inputs_s = time.perf_counter() - t_in
    params = _to_program(ref_params, scene)
    target = target.to(scene.device)
    del ref_params
    gc.collect()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    fn = make_step(scene, cfg, n_samples, int(tcfg["spp_chunk"]))
    pixel_idx = torch.arange(npix, dtype=torch.int64, device=scene.device)

    def step(k, params):
        s = traffic.call_seed(seed, k)
        loss, grads = fn(params, target, pixel_idx, s)
        new = {"tex_color": update(params["tex_color"], grads["tex_color"],
                                   row, k, tcfg["fit"]),
               "camera": params["camera"]}
        drive._sync(device)
        return s, loss, grads, new

    k = 0
    for _ in range(int(tcfg["warmup_calls"])):
        params = step(k, params)[3]
        k += 1
    max_calls = int(tcfg["max_calls"])
    before = _host(params)

    calls, kept = [], []
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start - inputs_s
    t_end = t_w0
    while len(calls) < max_calls:
        t0 = time.perf_counter()
        s, loss, grads, params = step(k, params)
        t_end = time.perf_counter()
        calls.append(GradCall(t_end - t0))
        kept.append(Step(s, before, float(loss), _host(grads)))
        before = _host(params)
        del loss, grads
        k += 1
        if t_end - t_w0 >= seconds:
            break
    window_s = t_end - t_w0
    run = GradRun(cell=cell, setup_s=setup_s, window_s=window_s,
                  calls=calls, samples_per_call=npix * n_samples,
                  n_pixels=npix,
                  peak_bytes=(int(torch.cuda.max_memory_allocated())
                              if on_card else 0))
    if trace:
        t0_ns = time.time_ns()
        run.slice = _profile(step, k, params, int(tcfg["trace_renders"]),
                             run.samples_per_call)
        run.span_ns = (t0_ns, time.time_ns())
    dev_info = drive.device_info(cell, on_card, run.slice)
    print(f"info {cell.name}: {len(calls)} steps in {window_s!r} s, loss "
          f"{kept[0].loss!r} -> {kept[-1].loss!r}, setup {setup_s!r} s "
          f"(the benchmark's inputs, {inputs_s!r} s, not in it), peak at "
          f"the window's close {run.peak_bytes} B", file=log, flush=True)

    del scene, fn, params, pixel_idx, step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers, control_numbers = _judge(cell, fields, seed, kept, target,
                                      device, control)
    judged = len(traffic.checked_calls(seed, len(kept),
                                       int(tcfg["check"]["renders"])))
    print(f"info {cell.name}: the reference's check took "
          f"{time.perf_counter() - t_ref!r} s over {judged} judged steps",
          file=log, flush=True)
    return drive.result_line(cell, run, trace, numbers, NUMBERS,
                             control_numbers, dev_info, log)


def _profile(step, k: int, params: dict, n: int, samples: int):
    """The traced slice of steps k .. k + n - 1, the loop going on from
    `params`."""
    state = {"params": params}

    def one(i):
        state["params"] = step(k + i, state["params"])[3]
    return tr.profile_calls(one, n, samples)


def _judge(cell, fields, seed, kept, target, device, control):
    """(numbers, the control's numbers or None)."""
    from plainref import config as ref_config
    from plainref import grad as ref_grad
    from plainref import registry

    ref_cfg = ref_config.RenderConfig(**fields)
    ref_scene = registry.build_scene(ref_cfg.scene_id, ref_cfg.nx,
                                     ref_cfg.ny, device=device)
    target = target.to(ref_scene.device)
    n_samples = int(cell.traffic["n_samples"])
    judged = [kept[i] for i in traffic.checked_calls(
        seed, len(kept), int(cell.traffic["check"]["renders"]))]

    def reference(round_to=None):
        out = []
        for j in judged:
            params = {"tex_color": j.params["tex_color"].to(ref_scene.device),
                      "camera": {f: t.to(ref_scene.device)
                                 for f, t in j.params["camera"].items()}}
            loss, grads = ref_grad.loss_and_grad(
                ref_scene, ref_cfg, params, target, j.seed, n_samples,
                round_to=round_to, lanes_per_block=REF_LANES)
            out.append(Step(j.seed, j.params, float(loss), {
                "tex_color": grads["tex_color"].cpu(),
                "camera": {f: t.cpu() for f, t in grads["camera"].items()}}))
        return out

    ref = reference()
    numbers = compare(judged, ref, kept)
    control_numbers = None
    if control is not None:
        ctl = reference(control)
        control_numbers = compare(ctl, ref, ctl)
    return numbers, control_numbers
