"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

The mix's `call` picks the run: a render mix's is below; a gradient mix's
(`"call": "grad_step"`) is `harness/grad.py`'s, in the same order.  The
order of a render run:

1. the look for the cards the cell asks for (no card: exit non-zero, no
   result);
2. set-up: import the program, build the cell's scene, draw the pixel
   samples, make the mix's warm-up calls with the identical configuration;
3. the window: calls back to back, each `render()` and a device sync, for
   `--seconds` (the call in progress at the close finishes); every call
   keeps its image's values at its drawn pixels;
4. with `--trace 1`, a few more calls under the profiler;
5. the peak device memory, then the program's state is freed;
6. the judged calls rendered again by the plain reference, compared;
7. the metrics, each read by its own module, and the result line.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import torch

from harness import check, spec, traffic
from harness import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "rtw_tpu")


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    compared whole (`rtw_tpu_torch` is not `rtw_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Call:
    wall_s: float            # host clock: the call to its image's sync
    program_wall_s: float    # the render's own `wall_seconds`
    rays: int                # the program's ray count


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: spec.Cell
    setup_s: float
    window_s: float
    calls: list
    samples_per_call: int
    n_pixels: int
    n_vol: int = 0
    slice: tr.Slice | None = None
    counts: dict | None = None       # the reference's, per its paths


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _check_device(cell: spec.Cell) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: this benchmark "
                       "measures the card and never the CPU")
    if torch.cuda.device_count() < cell.chips:
        raise NoDevice(f"{torch.cuda.device_count()} card(s), the cell asks "
                       f"for {cell.chips}")


def device_info(cell: spec.Cell, on_card: bool, slice_) -> dict:
    """The result line's `device`: the peak is read now."""
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                  if on_card else 0)}
    if slice_ is not None:
        info.update(busy_s=slice_.busy_s, window_s=slice_.window_s)
    return info


def read_metrics(cell: spec.Cell, run: Run, trace: bool) -> dict:
    """The cell's end-to-end metrics (`--trace 0`) or per-layer metrics
    (`--trace 1`), each by its reader; a metric whose reader finds nothing
    is left out."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m.name, cell.root)(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    return metrics


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", render=None,
             fields: dict | None = None, control=None,
             log=sys.stderr, make_step=None) -> dict:
    """One run; returns the result dict (the line's keys, `checks` last).
    `render` replaces the program's `render` (tests plant faults there);
    `fields` replaces the cell's `RenderConfig` fields (tests run small);
    `control` (a dtype) also judges the reference computed in it at the
    same pixels, under `control_checks` (the calibration's, never a
    benchmark run's).  A gradient mix's run is `harness/grad.py`'s, with
    `make_step` in place of the program's step function."""
    if torch.device(device).type == "cuda":
        _check_device(cell)
    if traffic.call_kind(cell.traffic) == "grad_step":
        from harness import grad

        return grad.run_cell(cell, seed, seconds, trace, t_start, device,
                             make_step=make_step, fields=fields,
                             control=control, log=log)
    import rtw_tpu_torch as rtt

    render = render or rtt.render
    fields = fields or traffic.render_fields(cell.config, cell.traffic)
    cfg = rtt.RenderConfig(**fields)
    scene = rtt.build_scene(cfg.scene_id, cfg.nx, cfg.ny, device=device)
    npix = cfg.nx * cfg.ny
    tcfg = cell.traffic
    max_calls = int(tcfg["max_calls"])
    pool = torch.as_tensor(traffic.pixel_samples(
        seed, max_calls, npix, int(tcfg["check"]["pixels"])), device=device)
    k = 0
    for _ in range(int(tcfg["warmup_calls"])):
        render(scene, cfg, seed=traffic.call_seed(seed, k))
        _sync(device)
        k += 1

    calls, kept = [], []
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    t_end = t_w0
    while len(calls) < max_calls:
        s = traffic.call_seed(seed, k)
        m = {}
        t0 = time.perf_counter()
        img = render(scene, cfg, seed=s, metrics=m)
        _sync(device)
        t_end = time.perf_counter()
        calls.append(Call(t_end - t0, m["wall_seconds"], m["rays"]))
        idx = pool[len(kept)]
        kept.append(check.Kept(s, idx, img.reshape(-1, 3)[idx]))
        del img
        k += 1
        if t_end - t_w0 >= seconds:
            break
    window_s = t_end - t_w0
    run = Run(cell=cell, setup_s=setup_s, window_s=window_s,
              calls=calls, samples_per_call=npix * cfg.spp, n_pixels=npix)
    if trace:
        base = k

        def one(i):
            render(scene, cfg, seed=traffic.call_seed(seed, base + i))
            _sync(device)
        run.slice = tr.profile_calls(one, int(tcfg["trace_renders"]),
                                     run.samples_per_call)
    on_card = torch.device(device).type == "cuda"
    dev_info = device_info(cell, on_card, run.slice)
    rays = sum(c.rays for c in calls)
    print(f"info {cell.name}: {len(calls)} calls in {window_s!r} s, "
          f"program rays {rays} ({rays / window_s / 1e6!r} Mrays/s over "
          f"the window), setup {setup_s!r} s", file=log, flush=True)

    del scene, pool
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers, control_numbers, counts, run.n_vol = _judge(
        cell, fields, seed, kept, device, control)
    print(f"info {cell.name}: the reference's check took "
          f"{time.perf_counter() - t_ref!r} s over "
          f"{counts['paths']} paths", file=log, flush=True)
    run.counts = counts
    return result_line(cell, run, trace, numbers, check.NUMBERS,
                       control_numbers, dev_info, log)


def result_line(cell: spec.Cell, run: Run, trace: bool, numbers: dict,
                names: tuple, control_numbers, dev_info: dict,
                log=sys.stderr) -> dict:
    """The result dict of a run of either call, `checks` last: the
    numbers `names` against the cell's limits, also printed as the last
    lines of `log`."""
    limits = {k: float(v) for k, v in cell.notes["limits"].items()}
    result = {"correct": check.judge(numbers, limits, names),
              "attempted": len(run.calls), "failed": 0,
              "metrics": read_metrics(cell, run, trace), "device": dev_info}
    if run.slice is not None:
        result["breakdown"] = run.slice.breakdown()
    if control_numbers is not None:
        result["control_checks"] = control_numbers
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in names}
    for line in check.report_lines(numbers, limits, names):
        print(line, file=log, flush=True)
    return result


def _judge(cell, fields, seed, kept, device, control):
    """(numbers, control's numbers or None, the reference's counts, the
    scene's volume count)."""
    from plainref import config as ref_config
    from plainref import paths, registry

    ref_cfg = ref_config.RenderConfig(**fields)
    ref_scene = registry.build_scene(ref_cfg.scene_id, ref_cfg.nx,
                                     ref_cfg.ny, device=device)
    judged = [kept[i] for i in traffic.checked_calls(
        seed, len(kept), int(cell.traffic["check"]["renders"]))]
    got = torch.cat([j.values for j in judged]).float()
    counts = paths.Counts(ref_scene.device)
    ref = check.reference_values(ref_scene, ref_cfg, judged, counts)
    numbers = check.compare(got.to(ref.device), ref)
    control_numbers = None
    if control is not None:
        ctl = check.reference_values(ref_scene, ref_cfg, judged,
                                     round_to=control)
        control_numbers = check.compare(ctl, ref)
    return numbers, control_numbers, counts.as_dict(), ref_scene.n_vol


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          t_start)
    except NoDevice as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 3
    found = forbidden_modules()        # after the window and the check
    if found:
        print(f"refused: loaded {found}", file=sys.stderr, flush=True)
        return 4
    print(json.dumps(result), flush=True)
    return 0
