"""The port's program spans (rtw_tpu_torch/utils/profiling.py): recorded
only under a torch.profiler capture, on the profiler's host clock, in the
tree the benchmark's span metrics read, without changing a render; the
kernel wrappers' spans on their CPU branches; `trace(dir)`'s program
track.  All on the CPU at a few dozen pixels."""

import collections
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rtw_tpu_torch as rtt
from rtw_tpu_torch import integrator as TI
from rtw_tpu_torch.utils import profiling as P
from rtw_tpu_torch.utils import rng as TR

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

# (span, its parent's name) in a render through each scheduler; the queue
# render runs the split tier's "kernels" mode, whose wrappers take their
# CPU branches here (A's `mega.launch` is the card's only)
QUEUE_TREE = {
    ("render", None), ("render.setup", "render"),
    ("render.pixels", "render.setup"),
    ("sched.queue", "render"), ("tables", "sched.queue"),
    ("queue.iteration", "sched.queue"), ("bounce.draw", "queue.iteration"),
    ("kernel.trace", "queue.iteration"), ("kernel.shade", "queue.iteration"),
    ("kernel.occluded", "queue.iteration"),
    ("kernel.finish", "queue.iteration"), ("queue.flush", "queue.iteration"),
    ("queue.regen", "queue.iteration"), ("queue.wait", "sched.queue"),
    ("render.assemble", "render"), ("render.wait", "render")}
MEGA_TREE = {
    ("render", None), ("render.setup", "render"),
    ("render.pixels", "render.setup"), ("sched.mega", "render"),
    ("tables", "sched.mega"), ("render.assemble", "render"),
    ("render.wait", "render")}


@pytest.fixture(autouse=True)
def empty_buffer():
    P.clear()
    yield
    P.clear()


def _queue_render(monkeypatch):
    """(scene, cfg) of scene 2 (one light: NEE, so C and F run) on the
    queue, with the split tier's kernels mode on the CPU."""
    monkeypatch.setattr(TI, "_split_backend", lambda cfg, scene: True)
    scene = rtt.build_scene(2, 16, 8, device="cpu")
    return scene, rtt.RenderConfig(nx=16, ny=8, spp=2, max_depth=4,
                                   scene_id=2, scheduler="queue")


def _mega_render():
    scene = rtt.build_scene(0, 16, 16, device="cpu")
    return scene, rtt.RenderConfig(nx=16, ny=16, spp=2, max_depth=4,
                                   scene_id=0, backend="mega")


def _captured(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _tree(call):
    by_id = {s.id: s for s in call}
    return {(s.name, by_id[s.parent].name if s.parent in by_id else None)
            for s in call}


def test_without_a_capture_nothing_is_recorded(monkeypatch):
    scene, cfg = _queue_render(monkeypatch)
    rtt.render(scene, cfg)
    with P.span("outside"):
        pass
    assert P.spans() == []


@pytest.mark.parametrize("path", ["queue", "mega"])
def test_a_render_records_the_span_tree(monkeypatch, path):
    scene, cfg = (_queue_render(monkeypatch) if path == "queue"
                  else _mega_render())
    _captured(lambda: [rtt.render(scene, cfg) for _ in range(2)])
    calls = P.calls(5)
    assert len(calls) == 2
    for call in calls:
        root = call[0]
        assert root.name == "render" and root.parent is None
        assert all(s.call == root.id for s in call)
        assert _tree(call) == (QUEUE_TREE if path == "queue" else MEGA_TREE)
        for s in call:
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert calls[0][0].id != calls[1][0].id
    assert len(P.spans()) == sum(len(c) for c in calls)
    assert [c[0].id for c in P.calls(1)] == [calls[1][0].id]
    assert P.calls(0) == []


def test_spans_are_on_the_profilers_host_clock():
    a = torch.ones(4096)

    def body():
        with P.span("outer"):
            return a + a
    _, prof = _captured(body)
    (outer,) = P.spans()
    adds = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::add"]
    assert len(adds) == 1
    start = adds[0].start_ns()
    assert outer.start_ns <= start <= start + adds[0].duration_ns() \
        <= outer.end_ns


def test_spans_leave_the_image_and_rays_as_they_are(monkeypatch):
    scene, cfg = _queue_render(monkeypatch)
    off = {}
    img_off = rtt.render(scene, cfg, metrics=off)
    on = {}
    img_on, _ = _captured(lambda: rtt.render(scene, cfg, metrics=on))
    assert P.spans()
    assert torch.equal(img_off, img_on)
    assert off["rays"] == on["rays"]


def test_the_wrappers_record_their_spans_on_the_cpu():
    """One bounce of the kernels mode outside a render: each wrapper's
    span, on its CPU branch, with no parent and no call."""
    scene = rtt.build_scene(2, 8, 4, device="cpu")
    cfg = rtt.RenderConfig(nx=8, ny=4, spp=1, scene_id=2)
    pix = torch.arange(32)
    keys = TR.make_path_keys(cfg.seed, pix, 0, cfg.rng)
    state = TI.generate_camera_rays(scene, cfg, pix, keys)
    depth = torch.zeros(32, dtype=torch.int64)
    _captured(lambda: TI.bounce_step(scene, cfg, keys, state, depth,
                                     split="kernels"))
    got = collections.Counter(s.name for s in P.spans())
    assert got == {"bounce.draw": 1, "kernel.trace": 1, "kernel.shade": 1,
                   "kernel.occluded": 1, "kernel.finish": 1}
    assert all(s.parent is None and s.call is None for s in P.spans())


def test_deferred_values_are_read_by_spans_and_the_buffer_is_bounded(
        monkeypatch):
    reads = []

    def value():
        reads.append(1)
        return {"kernel_ms": 2.0, "tail_ms": 0.5}

    def body():
        with P.span("mega.launch") as sp:
            sp.defer("tail", value)
    _captured(body)
    assert reads == []
    (s,) = P.spans()
    assert reads == [1] and s.values == {"tail": {"kernel_ms": 2.0,
                                                  "tail_ms": 0.5}}
    P.spans()
    assert reads == [1]
    P.span("off").defer("tail", value)          # the no-op: nothing kept
    monkeypatch.setattr(P, "_ring", collections.deque(maxlen=4))

    def six():
        for i in range(6):
            with P.span(f"s{i}"):
                pass
    _captured(six)
    assert [s.name for s in P.spans()] == ["s2", "s3", "s4", "s5"]


def test_trace_writes_the_program_track(tmp_path):
    scene, cfg = _mega_render()

    def before():
        with P.span("before"):
            pass
    _captured(before)
    assert P.spans()                 # trace() starts with an empty buffer
    with P.trace(str(tmp_path)):
        rtt.render(scene, cfg)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        doc = json.load(f)
    track = [e for e in doc["traceEvents"] if e.get("pid") == P.TRACK]
    spans = [e for e in track if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {n for n, _ in MEGA_TREE}
    (render,) = [e for e in spans if e["name"] == "render"]
    # the track sits on the trace's own time base: the render's span
    # covers the operations the profiler recorded inside it
    ops = [e for e in doc["traceEvents"] if e.get("ph") == "X"
           and e.get("pid") != P.TRACK and e["name"].startswith("aten::")]
    assert ops
    for e in ops:
        assert render["ts"] - 1 <= e["ts"]
        assert e["ts"] + e["dur"] <= render["ts"] + render["dur"] + 1
