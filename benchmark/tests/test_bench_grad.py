"""The gradient call and its plain reference (`harness/grad.py`,
`plainref/grad.py`), on the CPU at a size a test run holds.

- The plain gradient against the program's `diff.make_loss_and_grad_chunked`
  on scene 2 (24x12, depth 4, 1 spp, the split tier's "plain" mode: the
  program's reeval branch with B's and C's plain versions).
- Central finite differences of the plain estimator itself, so that the
  reference is checked apart from the program.
- The reference's forward equals `paths.render_pixels` bit for bit.
- The check separates: a sound run of the cell is correct; the control
  and each planted fault are not.
- The fit's update, the start and the target.
- The traced slice's backward time, the new readers (the backward time,
  the peak, and the traced steps' spans), and the no-JAX rule.
"""

import dataclasses
import io
import json
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import rtw_tpu_torch as rtt
from rtw_tpu_torch import diff

from harness import drive, grad, spec
from harness import trace as tr
from plainref import config, paths, registry
from plainref import grad as ref_grad

from conftest import ROOT

# Several workers share the cores: one intra-op thread each keeps torch's
# thread pools from oversubscribing them.
torch.set_num_threads(1)

CELL = "scene2-grad-8spp"
SMALL = dict(nx=24, ny=12, spp=1, max_depth=4, scene_id=2,
             differentiable=True, remat=True)
SEED = 2 ** 33 + 17


def _inputs(fields, seed=SEED):
    c = spec.load_cell(CELL)
    return grad._inputs(fields, int(c.config["fit_row"]), c.traffic, seed,
                        "cpu")


@pytest.mark.parametrize("n_samples,chunk", [(1, 1), (4, 2)])
def test_plain_gradient_matches_the_program(n_samples, chunk):
    """The loss and every gradient leaf of the program's chunked step
    (the reeval branch, split="plain"; one chunk, and the mix's shape of
    several chunks of two samples) against the plain gradient, in blocks
    of pixels.  Tolerance: rtol 1e-6 on the loss, 1e-5 on each leaf's
    rel_l1.  Both sides run the same float32 arithmetic on the same paths
    (the plain modules are copies); only the order of the gradient sums
    differs: the reference adds its blocks' products, the program its
    chunks', and each gather's backward adds its rows in its own order.
    Measured: loss equal, leaves within ~1e-7."""
    cfg = rtt.RenderConfig(**SMALL)
    scene = rtt.build_scene(2, cfg.nx, cfg.ny, device="cpu")
    params, target = _inputs(SMALL)
    fn = diff.make_loss_and_grad_chunked(scene, cfg, n_samples, chunk,
                                         split="plain")
    pix = torch.arange(cfg.nx * cfg.ny)
    loss, g = fn(grad._to_program(params, scene), target, pix, 11)
    rcfg = config.RenderConfig(**SMALL)
    rscene = registry.build_scene(2, cfg.nx, cfg.ny, device="cpu")
    rloss, rg = ref_grad.loss_and_grad(rscene, rcfg, params, target, 11,
                                       n_samples, lanes_per_block=400)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-6)
    got = grad._host(g)
    assert float(rg["tex_color"].abs().sum()) > 0
    assert grad._rel_l1([got["tex_color"]], [rg["tex_color"]]) <= 1e-5
    for f in ref_grad.CAMERA_FIELDS:
        r = rg["camera"][f]
        if float(r.abs().sum()) > 0:
            assert grad._rel_l1([got["camera"][f]], [r]) <= 1e-5, f
        else:
            assert float(got["camera"][f].abs().sum()) == 0, f
    assert float(sum(rg["camera"][f].abs().sum()
                     for f in ref_grad.CAMERA_FIELDS)) > 0


def _sum_and_fd(sid, nx, ny, depth, select, eps=1e-3):
    """(analytic, finite difference) of the summed plain estimator over
    the pixels whose central differences at eps and eps / 2 agree (within
    1% and 1e-3): a pixel whose path takes another branch within +-eps
    jumps, and its two differences differ.  Also the share kept."""
    cfg = config.RenderConfig(nx=nx, ny=ny, spp=1, max_depth=depth,
                              scene_id=sid, differentiable=True)
    scene = registry.build_scene(sid, nx, ny, device="cpu")
    p0 = ref_grad.params_of(scene)
    pix = torch.arange(nx * ny)
    get, put = select

    def image(v):
        q = {"tex_color": p0["tex_color"].clone(),
             "camera": {k: t.clone() for k, t in p0["camera"].items()}}
        put(q, v)
        with torch.no_grad():
            return ref_grad.sample_sum(ref_grad.apply(scene, q), cfg, 7,
                                       pix, 1).double()

    v0 = float(get(p0))
    fd1 = (image(v0 + eps) - image(v0 - eps)) / (2 * eps)
    fd2 = (image(v0 + eps / 2) - image(v0 - eps / 2)) / eps
    keep = ((fd1 - fd2).abs() <= 1e-2 * fd1.abs() + 1e-3).all(dim=1)
    mask = keep[:, None].expand(-1, 3).float()
    v = torch.tensor(v0, requires_grad=True)
    q = {"tex_color": p0["tex_color"].clone(),
         "camera": {k: t.clone() for k, t in p0["camera"].items()}}
    put(q, v)
    out = ref_grad.sample_sum(ref_grad.apply(scene, q), cfg, 7, pix, 1)
    (a,) = torch.autograd.grad(out, v, grad_outputs=mask)
    return float(a), float((fd1 * mask).sum()), float(keep.double().mean())


def _tex(row, ch):
    def put(q, v):
        q["tex_color"] = q["tex_color"].index_put(
            (torch.tensor([row]), torch.tensor([ch])), v.reshape(1)
            if torch.is_tensor(v) else torch.tensor([v]))
    return (lambda p: p["tex_color"][row, ch], put)


def _cam(field, i):
    def put(q, v):
        q["camera"][field] = q["camera"][field].index_put(
            (torch.tensor([i]),), v.reshape(1) if torch.is_tensor(v)
            else torch.tensor([v]))
    return (lambda p: p["camera"][field][i], put)


@pytest.mark.parametrize("sid,nx,ny,select,rtol", [
    # scene 2's light row: the emission tied to it (NEE and the hit side)
    (2, 24, 12, _tex(4, 0), 1e-3),
    # the Cornell box's white walls (row 2)
    (0, 24, 24, _tex(2, 1), 1e-3),
    # the Cornell box's camera: the frustum's vertical extent
    (0, 24, 24, _cam("vertical", 1), 2e-2),
], ids=["scene2-light-row", "cornell-white-row", "cornell-vertical"])
def test_plain_gradient_matches_finite_differences(sid, nx, ny, select,
                                                   rtol):
    """Central differences (eps 1e-3, depth 3) of the plain estimator,
    summed over the image, against its autograd gradient.  A colour
    enters each path as a polynomial: rtol 1e-3 covers float32 rounding
    over 2 eps.  A camera field moves hit points, normals and shadow rays,
    so the difference also carries the curvature over +-eps and the small
    jumps the 1% agreement lets through: rtol 2e-2 (measured 0.08%).
    Most pixels are kept."""
    a, fd, kept = _sum_and_fd(sid, nx, ny, 3, select)
    assert kept >= 0.6
    assert a != 0.0
    np.testing.assert_allclose(a, fd, rtol=rtol)


@pytest.mark.parametrize("sid", [0, 2, 4])
def test_reference_forward_equals_render_pixels(sid):
    """The gradient reference's trace (winners picked without gradients,
    `reeval_hit`, the detached shadow query) gives `render_pixels`'
    values bit for bit at fixed seeds, so no cell's reference drifts."""
    cfg = config.RenderConfig(nx=20, ny=10, spp=1, max_depth=6,
                              scene_id=sid, differentiable=True)
    scene = registry.build_scene(sid, cfg.nx, cfg.ny, device="cpu")
    pix = torch.arange(0, 200, 3, dtype=torch.int64)
    for seed in (5, 2 ** 33 + 1):
        want = paths.render_pixels(scene, cfg, seed, pix)
        with torch.no_grad():
            got = ref_grad.sample_sum(scene, cfg, seed, pix, 1)
        assert torch.equal(got, want), (sid, seed)
        assert float(want.abs().sum()) > 0


# ---- the check separates ---------------------------------------------------

def _scaled(scene, cfg, n, c):
    fn = grad.make_program_step(scene, cfg, n, c)

    def step(params, target, pixel_idx, seed):
        loss, g = fn(params, target, pixel_idx, seed)
        cam = g["camera"]
        return loss, {"tex_color": g["tex_color"] * 1.01,
                      "camera": dataclasses.replace(cam, **{
                          f.name: getattr(cam, f.name) * 1.01
                          for f in dataclasses.fields(cam)})}
    return step


def _untied(scene, cfg, n, c):
    """The light rows' emission no longer tied to their texture rows."""
    untied = dataclasses.replace(scene,
                                 light_tex=(-1,) * len(scene.light_tex))
    return grad.make_program_step(untied, cfg, n, c)


def _dropping(keep):
    def make(scene, cfg, n, c):
        fn = grad.make_program_step(scene, cfg, n, c)

        def step(params, target, pixel_idx, seed):
            k = keep(pixel_idx.shape[0])
            return fn(params, target[:k], pixel_idx[:k], seed)
        return step
    return make


def _stale(scene, cfg, n, c):
    fn = grad.make_program_step(scene, cfg, n, c)
    last = []

    def step(params, target, pixel_idx, seed):
        out = fn(params, target, pixel_idx, seed)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return step


def _control(scene, cfg, n, c):
    """The plain gradient computed with bfloat16 state, in the program's
    place."""
    rcfg = config.RenderConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
    rscene = registry.build_scene(cfg.scene_id, cfg.nx, cfg.ny, device="cpu")

    def step(params, target, pixel_idx, seed):
        p = grad._host(params)
        loss, g = ref_grad.loss_and_grad(rscene, rcfg, p, target, seed, n,
                                         round_to=torch.bfloat16)
        return loss, {"tex_color": g["tex_color"],
                      "camera": dataclasses.replace(params["camera"],
                                                    **g["camera"])}
    return step


FAULTS = {
    "control": _control,
    "scaled-1.01": _scaled,
    "light-tie-broken": _untied,
    "one-sample-dropped": _dropping(lambda n: n - 1),
    "half-left-out": _dropping(lambda n: n // 2),
    "stale": _stale,
}


def _run(make_step=None, seed=SEED, fit_light=False):
    """A run of the cell at SMALL, its mix cut to 4 samples in chunks of
    2 (the chunk loop kept) and 3 steps.  `fit_light`: the fit is on the
    light's texture row, from (1, 1, 1) in place of its 16: the one row
    whose tie to an emission shows in the image."""
    c = spec.load_cell(CELL)
    c.traffic = dict(c.traffic, n_samples=4, spp_chunk=2, max_calls=3,
                     warmup_calls=1)
    if fit_light:
        scene = registry.build_scene(2, SMALL["nx"], SMALL["ny"],
                                     device="cpu")
        c.config = dict(c.config, fit_row=scene.light_tex[0])
        c.traffic["fit"] = dict(c.traffic["fit"], start=[1.0, 1.0, 1.0])
    return drive.run_cell(c, seed, 0.0, False, time.perf_counter(),
                          device="cpu", fields=SMALL, make_step=make_step,
                          log=io.StringIO())


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert list(r["checks"]) == list(grad.NUMBERS)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_control_and_faults_are_not_correct(fault):
    """Each fault read where it can show.  The light's tie: in the cell's
    own fit the light's row keeps the emission it was built with, so a
    broken tie moves only the light row's share of its gradient through
    the lights' sampling (measured 9.5e-4 of the colours' rel_l1 here);
    it is read with the light's row fitted from another colour, where the
    image itself depends on the tie."""
    r = _run(FAULTS[fault], fit_light=fault == "light-tie-broken")
    assert not r["correct"], (fault, r["checks"])


def test_sound_run_fitting_the_light_is_correct():
    r = _run(fit_light=True)
    assert r["correct"], r["checks"]


# ---- trace, readers, imports -----------------------------------------------

def test_backward_time_follows_each_launch():
    """A device operation counts where its launch (by correlation id, or
    else the operation it is linked to) lies inside a backward node."""
    dev = [(1, 10, 1.0), (2, 11, 2.0), (3, 0, 4.0), (4, 12, 8.0),
           (5, 13, 16.0)]
    launches = {1: 5, 2: 50, 5: 30}
    ops = {12: 15, 11: 0, 13: 1}
    back = [(0, 20, "a"), (10, 12, "b"), (40, 60, "c")]
    assert tr.backward_s(dev, launches, ops, back) == 11.0
    assert tr.backward_s(dev, launches, ops, []) is None
    assert tr.backward_s([], launches, ops, back) is None


def test_backward_nodes_are_found_in_a_profile():
    """torch's backward records its nodes as the host events the slice
    looks for."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.autograd.grad((x * 2).sin().sum(), x)
    _, _, (_, _, _, back) = tr._events(prof)
    assert any("SinBackward0" in name for *_, name in back)


def test_grad_readers_find_nothing_outside_a_gradient_run():
    c = spec.load_cell("cornell-1000spp")
    run = drive.Run(cell=c, setup_s=1.0, window_s=2.0, calls=[],
                    samples_per_call=1, n_pixels=1)
    assert spec.metric_reader("grad_peak_gib")(run) is None
    assert spec.metric_reader("grad_backward_ms")(run) is None
    run = grad.GradRun(cell=c, setup_s=1.0, window_s=2.0, calls=[],
                       samples_per_call=1, n_pixels=1, peak_bytes=3 << 29)
    assert spec.metric_reader("grad_peak_gib")(run) == 1.5


def test_start_and_target_are_the_benchmarks():
    """The start parameters are the plain scene's with the fitted row set
    to the mix's start colour; the target is the plain reference's render
    of the unperturbed scene at the target's seed; both repeat for a
    seed, and the target changes with it."""
    c = spec.load_cell(CELL)
    row = int(c.config["fit_row"])
    p1, t1 = _inputs(SMALL)
    p2, t2 = _inputs(SMALL)
    assert torch.equal(p1["tex_color"], p2["tex_color"])
    assert torch.equal(t1, t2)
    scene = registry.build_scene(2, 24, 12, device="cpu")
    base = ref_grad.params_of(scene)
    want = base["tex_color"].clone()
    want[row] = torch.tensor(c.traffic["fit"]["start"])
    assert torch.equal(p1["tex_color"], want)
    assert not torch.equal(base["tex_color"][row], want[row])
    for f in ref_grad.CAMERA_FIELDS:
        assert torch.equal(p1["camera"][f], base["camera"][f]), f
    cfg = config.RenderConfig(**SMALL)
    assert torch.equal(t1, paths.render_pixels(
        scene, cfg, grad.target_seed(SEED), torch.arange(24 * 12)))
    assert float(t1.abs().sum()) > 0
    _, t3 = _inputs(SMALL, SEED + 1)
    assert not torch.equal(t1, t3)


def test_update_descends_on_the_fitted_row_alone():
    """Step k moves the fitted row by the decayed rate times its
    normalised gradient, clipped to [0, 1]; no other row moves."""
    fit = {"lr": 0.6, "decay": 0.88, "decay_after": 8}
    tex = torch.tensor([[0.5, 0.5, 0.5], [0.2, 0.9, 0.05], [16.0, 16, 16]])
    g = torch.tensor([[1.0, 1, 1], [2.0, -4.0, 1.0], [5.0, 5, 5]])
    for k, lr in ((0, 0.6), (8, 0.6), (10, 0.6 * 0.88 ** 2)):
        new = grad.update(tex, g, 1, k, fit)
        want = torch.clamp(tex[1] - lr * g[1] / 4.0, 0.0, 1.0)
        torch.testing.assert_close(new[1], want, rtol=0, atol=1e-7)
        assert torch.equal(new[0], tex[0]) and torch.equal(new[2], tex[2])
    assert float(grad.update(tex, g, 1, 0, fit)[1, 1]) == 1.0
    assert float(grad.update(tex, g, 1, 0, fit)[1, 2]) == 0.0


def _step_span(name, start, end, call=None):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end,
                                 call=call)


@pytest.fixture
def recorder(monkeypatch):
    """Plant a program recorder whose `spans()` gives what the test
    sets."""
    fake = types.ModuleType("rtw_tpu_torch.utils.profiling")
    fake.recorded = []
    fake.spans = lambda: list(fake.recorded)
    monkeypatch.setitem(sys.modules, "rtw_tpu_torch.utils.profiling", fake)
    return fake


def _grad_run(span_ns, steps=2):
    run = grad.GradRun(cell=spec.load_cell(CELL), setup_s=1.0,
                       window_s=2.0, calls=[], samples_per_call=1,
                       n_pixels=1, span_ns=span_ns)
    run.slice = types.SimpleNamespace(renders=steps)
    return run


def test_step_span_readers(recorder):
    """`tables_span_ms.grad` sums the traced steps' `tables` spans over
    the steps; `wrapper_host_us.grad` averages their `kernel.*` spans.
    Spans of a render, or outside the traced steps, are not theirs."""
    ms = 1_000_000
    recorder.recorded = [
        _step_span("tables", 0, 9 * ms),                  # before the steps
        _step_span("tables", 10 * ms, 13 * ms),
        _step_span("kernel.trace", 14 * ms, 14 * ms + 200_000),
        _step_span("kernel.occluded", 15 * ms, 15 * ms + 100_000),
        _step_span("tables", 20 * ms, 21 * ms),
        _step_span("kernel.trace", 22 * ms, 23 * ms, call=7),  # a render's
        _step_span("tables", 22 * ms, 30 * ms, call=7),
        _step_span("tables", 50 * ms, 51 * ms),           # after the steps
    ]
    run = _grad_run((10 * ms, 40 * ms))
    read = spec.metric_reader
    assert read("tables_span_ms.grad")(run) == pytest.approx(2.0)
    assert read("wrapper_host_us.grad")(run) == pytest.approx(150.0)
    recorder.recorded = [_step_span("queue.wait", 11 * ms, 12 * ms)]
    assert read("tables_span_ms.grad")(run) is None
    assert read("wrapper_host_us.grad")(run) is None


def test_step_span_readers_find_nothing_outside_a_traced_gradient_run(
        recorder):
    recorder.recorded = [_step_span("tables", 1, 2),
                         _step_span("kernel.trace", 1, 2)]
    names = ("tables_span_ms.grad", "wrapper_host_us.grad")
    for name in names:
        assert spec.metric_reader(name)(_grad_run(None)) is None
    run = _grad_run((0, 10))
    run.slice = None
    c = spec.load_cell("final-1200x600-20spp")
    render_run = drive.Run(cell=c, setup_s=1.0, window_s=2.0, calls=[],
                           samples_per_call=1, n_pixels=1)
    render_run.slice = types.SimpleNamespace(renders=1)
    for name in names:
        assert spec.metric_reader(name)(run) is None
        assert spec.metric_reader(name)(render_run) is None


PROBE = r"""
import sys, json
sys.path[:0] = ["benchmark", "."]
import torch
import rtw_tpu_torch, rtw_tpu_torch.diff
from harness import drive, grad, trace
import plainref.grad
print(json.dumps({"forbidden": drive.forbidden_modules()}))
"""


def test_gradient_call_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["forbidden"] == []
