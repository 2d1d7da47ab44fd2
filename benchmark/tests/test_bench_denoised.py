"""The denoised-frame call (`harness/denoised.py`) and its plain reference
(`plainref/denoise.py`), on the CPU at a size a test run holds.

- the plain à-trous and G-buffer agree with the program's
  (`rtw_tpu_torch.denoise`), which only a test may import beside them;
- a sound run of the call is correct; the control and each fault the
  cell can have are not: the reference in bfloat16 in the program's
  place; a call that returns the previous frame (its state unchanged);
  half of the frame's pixels left out (filled from the other half); the
  frame written upside down (an answer altered where it is produced);
  one à-trous pass fewer; the albedo's guidance dropped; the denoised
  frame shifted by one pixel.  The cell runs on one card, so no fault of
  an exchange between cards applies;
- the marker's launches are found in a trace, and the mirror of the
  marker on the device's timeline is no device work;
- the denoiser's readers and bound;
- the cells that were there keep their metrics.
"""

import dataclasses
import io
import time
import types

import numpy as np
import pytest
import torch

import rtw_tpu_torch as rtt
from rtw_tpu_torch import denoise as D

from harness import denoised, drive, spec, work
from harness import trace as tr
# the render cells' control and half-frame fault, the same underneath
from test_bench_checks import _control as _control_render
from test_bench_checks import _half

CELL = "cornell-frame-1spp-denoised"
SMALL = dict(nx=32, ny=32, spp=1, max_depth=8, scene_id=0)
SEED = 2 ** 33 + 29


def _planes(seed, h=40, w=36):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand(h, w, 3, generator=g) * 1.5
    albedo = torch.rand(h, w, 3, generator=g)
    normal = torch.nn.functional.normalize(
        torch.randn(h, w, 3, generator=g), dim=-1)
    return img, albedo, normal


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_atrous_matches_the_programs(seed):
    from plainref import denoise as ref

    img, albedo, normal = _planes(seed)
    want = D.atrous(img, albedo=albedo, normal=normal, iterations=5)
    got = ref.atrous(img, albedo, normal, 5)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    # the display transform and the passes together
    lin = img * 2.0 - 0.25
    want = D.atrous(torch.clamp(lin, 0.0, 1.0) ** 0.5, albedo=albedo,
                    normal=normal, iterations=5)
    got = ref.denoise(lin, albedo, normal, 2.0, 5)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)


def test_plain_gbuffer_matches_primary_features():
    from plainref import config, denoise as ref, registry

    cfg = rtt.RenderConfig(**SMALL)
    scene = rtt.build_scene(0, cfg.nx, cfg.ny, device="cpu")
    alb, nrm, mask = D.primary_features(scene, cfg)
    rcfg = config.RenderConfig(**SMALL)
    rscene = registry.build_scene(0, rcfg.nx, rcfg.ny, device="cpu")
    ralb, rnrm, prim = ref.gbuffer(rscene, rcfg)
    assert torch.equal(prim >= 0, mask)
    assert torch.allclose(ralb, alb, rtol=0, atol=1e-4)
    assert torch.allclose(rnrm, nrm, rtol=0, atol=1e-4)
    assert mask.any() and (~mask).sum() < mask.numel()


# ---- the check: a sound run, the control and the faults -------------------

def _control_denoise(img, scene, cfg):
    from plainref import config, denoise as ref, registry

    rcfg = config.RenderConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
    rscene = registry.build_scene(cfg.scene_id, cfg.nx, cfg.ny,
                                  device="cpu")
    albedo, normal, _ = ref.gbuffer(rscene, rcfg)
    return ref.denoise(img, albedo, normal, cfg.gamma, denoised.ITERATIONS,
                       round_to=torch.bfloat16)


class _Stale:
    def __init__(self):
        self.last = None

    def __call__(self, img, scene, cfg):
        out = denoised.program_denoise(img, scene, cfg)
        prev = self.last if self.last is not None else out
        self.last = out
        return prev


def _altered(img, scene, cfg):
    return denoised.program_denoise(img, scene, cfg).flip(0)


def _one_pass_fewer(img, scene, cfg):
    return denoised.program_denoise(img, scene, cfg,
                                    denoised.ITERATIONS - 1)


def _no_albedo(img, scene, cfg):
    _, normal, _ = D.primary_features(scene, cfg)
    disp = torch.clamp(img, 0.0, 1.0) ** (1.0 / cfg.gamma)
    return D.atrous(disp, albedo=None, normal=normal,
                    iterations=denoised.ITERATIONS)


def _shifted(img, scene, cfg):
    out = denoised.program_denoise(img, scene, cfg)
    return torch.roll(out, 1, dims=1)


# (render, denoise) in the program's place
FAULTS = {
    "control": lambda: (_control_render, _control_denoise),
    "stale": lambda: (None, _Stale()),
    "half": lambda: (_half, None),
    "altered": lambda: (None, _altered),
    "one-pass-fewer": lambda: (None, _one_pass_fewer),
    "albedo-dropped": lambda: (None, _no_albedo),
    "shifted": lambda: (None, _shifted),
}


def _cell():
    c = spec.load_cell(CELL)
    c.traffic = dict(c.traffic, max_calls=3, warmup_calls=1,
                     check=dict(c.traffic["check"], pixels=256))
    return c


def _run(render=None, denoise=None, trace=False):
    return denoised.run_cell(_cell(), SEED, 3600.0, trace,
                             time.perf_counter(), device="cpu",
                             render=render, denoise=denoise, fields=SMALL,
                             log=io.StringIO())


def test_sound_run_is_correct():
    """Through the harness's dispatch, as a benchmark run goes."""
    r = drive.run_cell(_cell(), SEED, 3600.0, False, time.perf_counter(),
                       device="cpu", fields=SMALL, log=io.StringIO())
    assert r["correct"], r["checks"]
    assert r["attempted"] == 3
    assert list(r)[-1] == "checks"
    assert list(r["checks"]) == ["rel_l1", "off_share", "nonfinite"]
    assert set(r["metrics"]) == {"frame_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_control_and_faults_are_not_correct(fault):
    render, denoise = FAULTS[fault]()
    r = _run(render, denoise)
    assert not r["correct"], (fault, r["checks"])


def test_a_traced_run_on_the_cpu_reads_no_device_metric():
    """Without device operations the denoiser's readers find nothing, and
    the idle share is not made up; the render's own span, which the
    program records on any device, is read."""
    r = _run(trace=True)
    assert r["correct"]
    assert list(r["metrics"]) == ["driver_span_ms.frame"]
    assert r["metrics"]["driver_span_ms.frame"]["value"] > 0
    assert "busy_s" in r["device"] and "breakdown" in r


# ---- the trace's marker -----------------------------------------------------

class _Event:
    def __init__(self, name, start, dur, cuda, corr=0, linked=0):
        self._v = (name, start, dur, cuda, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_marker_launches_are_counted_and_its_mirror_is_no_work():
    """Kernels launched inside `bench.denoise` count to it; one launched
    outside does not; the marker's mirror on the device's timeline is
    neither a device operation nor busy time."""
    ev = [
        _Event("bench.denoise", 100, 100, False, corr=50),
        _Event("cudaLaunchKernel", 110, 5, False, corr=1, linked=9),
        _Event("cudaLaunchKernel", 150, 5, False, corr=2, linked=9),
        _Event("cudaLaunchKernel", 300, 5, False, corr=3, linked=9),
        _Event("k_in_a", 120, 10, True, corr=1),
        _Event("k_in_b", 160, 30, True, corr=2),
        _Event("k_out", 310, 20, True, corr=3),
        _Event("bench.denoise", 115, 80, True, corr=0),
    ]
    s = tr.Slice(_prof(ev), window_s=1e-6, renders=1, samples=1)
    assert s.marked == {"bench.denoise": (pytest.approx(40e-9), 2)}
    assert s.n_device_ops == 3
    assert s.busy_s == pytest.approx(60e-9)
    assert s.backward_s is None
    assert "bench.denoise" not in s.device_ops


def test_markers_are_found_in_a_profile():
    """`record_function` records the marker as the host range the slice
    looks for."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(denoised.MARKER):
            torch.ones(8).sin()
    _, host, _ = tr._events(prof)
    assert any(name == denoised.MARKER for *_, name in host)


# ---- the readers and the bound ----------------------------------------------

def _traced(marked, hits=(0, 900, 0, 0, 0, 0), renders=4):
    c = spec.load_cell(CELL)
    run = denoised.DenoisedRun(cell=c, setup_s=1.0, window_s=2.0, calls=[],
                               samples_per_call=1024, n_pixels=1024,
                               gbuffer_hits=list(hits))
    run.slice = types.SimpleNamespace(marked=marked, renders=renders,
                                      busy_s=0.5, window_s=2.0)
    return run


def test_denoise_readers():
    run = _traced({denoised.MARKER: (0.1, 400)})
    read = spec.metric_reader
    assert read("denoise_device_ms")(run) == pytest.approx(25.0)
    assert read("denoise_launches")(run) == pytest.approx(100.0)
    bound = work.denoise_bound_s([0, 900, 0, 0, 0, 0], 1024, 5)
    assert read("denoise_roofline")(run) == pytest.approx(
        100.0 * bound / 0.025)
    assert read("device_idle_pct.denoised")(run) == pytest.approx(75.0)
    for name in ("denoise_device_ms", "denoise_launches",
                 "denoise_roofline"):
        assert read(name)(_traced({})) is None
        untraced = _traced({})
        untraced.slice = None
        assert read(name)(untraced) is None


def test_frame_p95_is_the_walls_95th_percentile():
    c = spec.load_cell(CELL)
    walls = [0.010 * (i + 1) for i in range(100)]
    run = drive.Run(cell=c, setup_s=1.0, window_s=5.05,
                    calls=[drive.Call(w, w, 1) for w in walls[::-1]],
                    samples_per_call=1, n_pixels=1)
    assert spec.metric_reader("frame_ms_p95")(run) == pytest.approx(
        float(np.percentile(np.array(walls) * 1e3, 95)))


def test_denoise_bound_counts_the_inputs_only():
    """Operations bound it at the cell's size: the passes' taps at every
    pixel, the G-buffer's ray a pixel and its hits' tests; the frame read
    once and written once."""
    n, it = 640_000, 5
    hits = [0, 600_000, 0, 0, 0, 40_000]
    ops = n * (work.GBUFFER_RAY_OPS + work.DISPLAY_OPS + it * (
        work.ATROUS_TAPS * work.ATROUS_TAP_OPS + work.ATROUS_PASS_OPS))
    ops += 600_000 * (work.PRIM_TEST_OPS[1] + work.HIT_OPS)
    ops += 40_000 * (work.PRIM_TEST_OPS[5] + work.HIT_OPS)
    assert work.denoise_bound_s(hits, n, it) == pytest.approx(
        ops / work.F32_OPS_PER_S)
    assert ops / work.F32_OPS_PER_S > 2 * n * work.PIXEL_BYTES / \
        work.HBM_BYTES_PER_S
    assert work.denoise_bound_s(hits, n, 4) < work.denoise_bound_s(
        hits, n, 5)


# ---- the cells that were there ----------------------------------------------

KEPT = {
    "cornell-1000spp": (
        {"msamples_per_s", "setup_s"},
        {"driver_host_ms.image", "mega_roofline", "device_idle_pct",
         "driver_span_ms.image", "tables_span_ms", "mega_tail_pct"}),
    "final-1200x600-20spp": (
        {"msamples_per_s", "setup_s"},
        {"driver_host_ms.image", "launches_per_image", "trace_roofline",
         "device_idle_pct", "driver_span_ms.image", "tables_span_ms",
         "glue_idle_ms", "wrapper_host_us"}),
    "cornell-frame-1spp": (
        {"msamples_per_s", "frame_ms_p95", "setup_s"},
        {"driver_host_ms.frame", "mega_roofline", "device_idle_pct",
         "driver_span_ms.frame", "tables_span_ms", "mega_tail_pct"}),
    "scene2-grad-8spp": (
        {"msamples_per_s", "setup_s", "grad_peak_gib"},
        {"launches_per_image", "device_idle_pct", "tables_span_ms.grad",
         "wrapper_host_us.grad", "grad_backward_ms"}),
}


@pytest.mark.parametrize("cell", sorted(KEPT))
def test_the_cells_that_were_there_keep_their_metrics(cell):
    c = spec.load_cell(cell)
    e2e, layer = KEPT[cell]
    assert {m.name for m in c.end_to_end} == e2e
    assert {m.name for m in c.per_layer} == layer


@pytest.mark.parametrize("cell", ["cornell-frame-1spp", "cornell-1000spp"])
def test_a_render_cells_result_line_keeps_its_metric_names(cell):
    """A run of a render cell on the CPU at a small size prints every
    end-to-end metric it printed before the denoised call came."""
    c = spec.load_cell(cell)
    c.traffic = dict(c.traffic, max_calls=3, warmup_calls=1,
                     check=dict(c.traffic["check"], pixels=16))
    fields = dict(nx=16, ny=12, spp=1, max_depth=4, scene_id=0)
    r = drive.run_cell(c, SEED, 3600.0, False, time.perf_counter(),
                       device="cpu", fields=fields, log=io.StringIO())
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == KEPT[cell][0]
