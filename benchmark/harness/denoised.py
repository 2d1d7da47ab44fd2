"""The denoised-frame call: each call a `render()` of the frame and the
program's denoiser over it (`denoise.denoise` in "ldr" mode: its first-hit
G-buffer guiding the edge-avoiding à-trous filter in display space), as
the reference's viewer denoises every frame; judged against the plain
reference's frame, G-buffer and à-trous (`plainref/denoise.py`).

A mix with `"call": "render_denoised"` gives `spp`, `warmup_calls`,
`max_calls`, `check` (`renders` judged calls, `pixels` kept a call) and
`trace_renders`, as a render mix gives them (`harness/traffic.py`).  The
denoiser runs `ITERATIONS` à-trous passes, the program's default and the
count the reference's viewer is ported with.

The order of a run, as a render run's (`harness/drive.py`):

1. set-up: import the program, build the cell's scene, draw the pixel
   samples, make the warm-up calls;
2. the window: calls back to back, each `render()`, then `denoise()`
   inside the benchmark's profiler marker `bench.denoise`, then a device
   sync; a call's wall is the host clock from before `render()` to after
   the sync; every call keeps its denoised values at its drawn pixels,
   and nothing else;
3. with `--trace 1`, `trace_renders` more calls under the profiler;
4. `memory_peak_bytes`, then the program's state is freed;
5. the check: each judged call's whole frame rendered again by the plain
   reference from the call's seed (`plainref.paths.render_pixels` over
   every pixel), denoised by the plain G-buffer and à-trous, and compared
   with the kept values (`check.compare`: `rel_l1`, `off_share`,
   `nonfinite`);
6. the metrics and the result line (`drive.result_line`).
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time

import torch

from harness import check, drive, traffic
from harness import trace as tr

MARKER = "bench.denoise"
ITERATIONS = 5


@dataclasses.dataclass
class DenoisedRun(drive.Run):
    # the plain G-buffer's first hits by primitive kind, which the
    # denoiser's bound counts (`work.denoise_bound_s`); set by the check
    gbuffer_hits: list | None = None


def program_denoise(img, scene, cfg, iterations: int = ITERATIONS):
    """The program's denoiser as the reference's viewer runs it."""
    from rtw_tpu_torch import denoise

    return denoise.denoise(img, scene, cfg, iterations=iterations,
                           mode="ldr", gamma=cfg.gamma)


def _frame_stats(calls) -> str:
    """The window's frame walls: quartiles, extremes, and the frames over
    1.5x the median (their index, wall ms and the render's own ms)."""
    walls = sorted(c.wall_s * 1e3 for c in calls)
    med = statistics.median(walls)
    q = statistics.quantiles(walls, n=4) if len(walls) > 1 else [med] * 3
    slow = [(i, round(c.wall_s * 1e3, 3), round(c.program_wall_s * 1e3, 3))
            for i, c in enumerate(calls) if c.wall_s * 1e3 > 1.5 * med]
    return (f"frame ms quartiles {q[0]!r} {q[1]!r} {q[2]!r}, min "
            f"{walls[0]!r}, max {walls[-1]!r}, {len(slow)} over 1.5x the "
            f"median {slow[:8]}")


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", render=None, denoise=None, fields=None,
             control=None, log=sys.stderr) -> dict:
    """One run of a denoised-frame mix (the cards already looked for); as
    `drive.run_cell`.  `render` and `denoise(img, scene, cfg)`
    replace the program's (tests plant faults there)."""
    import rtw_tpu_torch as rtt

    render = render or rtt.render
    denoise = denoise or program_denoise
    tcfg = cell.traffic
    fields = fields or traffic.render_fields(cell.config, tcfg)
    cfg = rtt.RenderConfig(**fields)
    scene = rtt.build_scene(cfg.scene_id, cfg.nx, cfg.ny, device=device)
    npix = cfg.nx * cfg.ny
    max_calls = int(tcfg["max_calls"])
    pool = torch.as_tensor(traffic.pixel_samples(
        seed, max_calls, npix, int(tcfg["check"]["pixels"])), device=device)

    def call(k, metrics=None):
        img = render(scene, cfg, seed=traffic.call_seed(seed, k),
                     metrics=metrics)
        with torch.profiler.record_function(MARKER):
            out = denoise(img, scene, cfg)
        drive._sync(device)
        return out

    k = 0
    for _ in range(int(tcfg["warmup_calls"])):
        call(k)
        k += 1

    calls, kept = [], []
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    t_end = t_w0
    while len(calls) < max_calls:
        m = {}
        t0 = time.perf_counter()
        out = call(k, m)
        t_end = time.perf_counter()
        calls.append(drive.Call(t_end - t0, m["wall_seconds"], m["rays"]))
        idx = pool[len(kept)]
        kept.append(check.Kept(traffic.call_seed(seed, k), idx,
                               out.reshape(-1, 3)[idx]))
        del out
        k += 1
        if t_end - t_w0 >= seconds:
            break
    window_s = t_end - t_w0
    run = DenoisedRun(cell=cell, setup_s=setup_s, window_s=window_s,
                      calls=calls, samples_per_call=npix * cfg.spp,
                      n_pixels=npix)
    if trace:
        base = k
        run.slice = tr.profile_calls(lambda i: call(base + i),
                                     int(tcfg["trace_renders"]),
                                     run.samples_per_call)
    on_card = torch.device(device).type == "cuda"
    dev_info = drive.device_info(cell, on_card, run.slice)
    print(f"info {cell.name}: {len(calls)} calls in {window_s!r} s, "
          f"{_frame_stats(calls)}, setup {setup_s!r} s", file=log,
          flush=True)

    del scene, pool, call
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers, control_numbers, run.gbuffer_hits = _judge(
        cell, fields, seed, kept, device, control)
    judged = len(traffic.checked_calls(seed, len(kept),
                                       int(tcfg["check"]["renders"])))
    print(f"info {cell.name}: the reference's check took "
          f"{time.perf_counter() - t_ref!r} s over {judged} judged frames",
          file=log, flush=True)
    return drive.result_line(cell, run, trace, numbers, check.NUMBERS,
                             control_numbers, dev_info, log)


def _judge(cell, fields, seed, kept, device, control):
    """(numbers, the control's numbers or None, the plain G-buffer's first
    hits by primitive kind)."""
    from plainref import config as ref_config
    from plainref import denoise as ref_denoise
    from plainref import paths, registry

    ref_cfg = ref_config.RenderConfig(**fields)
    ref_scene = registry.build_scene(ref_cfg.scene_id, ref_cfg.nx,
                                     ref_cfg.ny, device=device)
    dev = ref_scene.device
    judged = [kept[i] for i in traffic.checked_calls(
        seed, len(kept), int(cell.traffic["check"]["renders"]))]
    albedo, normal, prim = ref_denoise.gbuffer(ref_scene, ref_cfg)
    every = torch.arange(ref_cfg.nx * ref_cfg.ny, dtype=torch.int64,
                         device=dev)

    def reference(round_to=None):
        out = []
        for j in judged:
            img = paths.render_pixels(ref_scene, ref_cfg, j.seed, every,
                                      round_to=round_to)
            frame = ref_denoise.denoise(
                img.reshape(ref_cfg.ny, ref_cfg.nx, 3), albedo, normal,
                ref_cfg.gamma, ITERATIONS, round_to)
            out.append(frame.reshape(-1, 3)[j.pixels.to(dev)])
        return torch.cat(out)

    ref = reference()
    got = torch.cat([j.values.to(dev) for j in judged]).float()
    numbers = check.compare(got, ref)
    control_numbers = None
    if control is not None:
        control_numbers = check.compare(reference(control), ref)
    hit = prim >= 0
    kinds = ref_scene.prims.prim_type[prim[hit]].to(torch.int64)
    hits = torch.bincount(kinds, minlength=paths.N_PRIM_KINDS)
    return numbers, control_numbers, [int(x) for x in
                                      hits[:paths.N_PRIM_KINDS]]
