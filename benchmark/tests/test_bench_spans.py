"""The readers of the program's spans (`metrics/driver_span_ms.*`,
`tables_span_ms`, `glue_idle_ms`, `wrapper_host_us`, `mega_tail_pct`) on a
synthetic run: hand-made spans over a fake traced slice, their arithmetic
(the idle intersection included), the last renders taken, and None where
the program records no span."""

import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from harness import drive, spec

RECORDER = "rtw_tpu_torch.utils.profiling"
READERS = ("driver_span_ms.frame", "driver_span_ms.image", "tables_span_ms",
           "glue_idle_ms", "wrapper_host_us", "mega_tail_pct")
MS = 1_000_000                         # ns


def _span(name, start, end, sid, parent, call, **values):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end,
                                 id=sid, parent=parent, call=call,
                                 values=values)


def _call(base, rid):
    """One queue render at `base` ms, ids from `rid`: render 0-100 ms;
    setup 0-10; sched.queue 10-90 with tables 10-15, an iteration 20-60
    (a trace wrapper 25-30, the flush 40-45) and the wait 60-70; the
    assemble 90-92 with a wait 90-91 in it; the wait 92-100."""
    at = base * MS

    def s(name, a, b, k, parent, **v):
        return _span(name, at + a * MS, at + b * MS, rid + k,
                     None if parent is None else rid + parent, rid, **v)
    return [s("render", 0, 100, 0, None), s("render.setup", 0, 10, 1, 0),
            s("sched.queue", 10, 90, 2, 0), s("tables", 10, 15, 3, 2),
            s("queue.iteration", 20, 60, 4, 2),
            s("kernel.trace", 25, 30, 5, 4), s("queue.flush", 40, 45, 6, 4),
            s("queue.wait", 60, 70, 7, 2), s("render.assemble", 90, 92, 8, 0),
            s("render.wait", 90, 91, 10, 8), s("render.wait", 92, 100, 9, 0)]


def _mega_call(base, rid, kernel_ms, tail_ms):
    at = base * MS
    return [_span("render", at, at + 50 * MS, rid, None, rid),
            _span("sched.mega", at + 10 * MS, at + 40 * MS, rid + 1, rid,
                  rid),
            _span("mega.launch", at + 20 * MS, at + 21 * MS, rid + 2,
                  rid + 1, rid,
                  tail={"kernel_ms": kernel_ms, "tail_ms": tail_ms})]


def _run(calls, device=(), renders=None):
    c = spec.load_cell("final-1200x600-20spp")
    run = drive.Run(cell=c, setup_s=1.0, window_s=2.0, calls=[],
                    samples_per_call=1, n_pixels=1)
    run.slice = types.SimpleNamespace(
        device=sorted(device),
        renders=len(calls) if renders is None else renders)
    return run


@pytest.fixture
def recorder(monkeypatch):
    """Plant a program recorder whose `calls(n)` gives the last n of the
    calls the test sets."""
    fake = types.ModuleType(RECORDER)
    fake.recorded = []
    fake.calls = lambda n: fake.recorded[-n:] if n > 0 else []
    monkeypatch.setitem(sys.modules, RECORDER, fake)
    return fake


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_readers_find_nothing_without_spans(monkeypatch, recorder):
    run = _run([_call(0, 1)])
    for name in READERS:                      # a recorder with no span
        assert _read(name, run) is None, name
    recorder.recorded = [_call(0, 1)]
    run.slice = None                          # no traced slice
    for name in READERS:
        assert _read(name, run) is None, name
    run = _run([_call(0, 1)])
    monkeypatch.setitem(sys.modules, RECORDER, types.ModuleType(RECORDER))
    for name in READERS:                      # a program without spans
        assert _read(name, run) is None, name
    monkeypatch.delitem(sys.modules, RECORDER)
    for name in READERS:                      # the program not loaded
        assert _read(name, run) is None, name


@pytest.mark.parametrize("name", ["driver_span_ms.frame",
                                  "driver_span_ms.image"])
def test_driver_span_is_render_less_schedulers_and_wait(recorder, name):
    recorder.recorded = [_call(0, 1), _call(200, 101)]
    # 100 ms - sched.queue 80 - the waits 8 and 1 = 11 ms a call
    assert _read(name, _run(recorder.recorded)) == pytest.approx(11.0)


def test_tables_span_sums_a_calls_tables(recorder):
    one, two = _call(0, 1), _call(200, 101)
    two.append(_span("tables", 200 * MS + 80 * MS, 200 * MS + 83 * MS, 120,
                     102, 101))
    recorder.recorded = [one, two]
    assert _read("tables_span_ms", _run(recorder.recorded)) == \
        pytest.approx((5 + 8) / 2)


def test_glue_idle_is_device_idle_in_iterations_outside_wrappers(recorder):
    recorder.recorded = [_call(0, 1), _call(200, 101)]
    # call 1's iteration 20-60 less its wrapper 25-30: 20-25 and 30-60;
    # busy 0-22 and 50-55 (and busy across the wrapper, which counts for
    # nothing): idle 3 + 25 ms.  Call 2 at 200: busy 215-235 over its
    # pieces 220-225, 230-260: idle 0 + 25 ms.
    device = [(0, 22 * MS, "k"), (26 * MS, 29 * MS, "k"),
              (50 * MS, 55 * MS, "k"), (215 * MS, 235 * MS, "k")]
    run = _run(recorder.recorded, device)
    assert _read("glue_idle_ms", run) == pytest.approx((28 + 25) / 2)
    run = _run(recorder.recorded)             # a card idle throughout
    assert _read("glue_idle_ms", run) == pytest.approx(35.0)


def test_wrapper_host_us_is_the_mean_wrapper_span(recorder):
    one = _call(0, 1)
    one.append(_span("kernel.shade", 31 * MS, 31 * MS + 2000, 11, 5, 1))
    recorder.recorded = [one]
    assert _read("wrapper_host_us", _run(recorder.recorded)) == \
        pytest.approx((5000 + 2) / 2)


def test_mega_tail_is_a_ratio_of_sums_over_the_last_renders(recorder):
    recorder.recorded = [_mega_call(0, 1, 1000.0, 900.0),
                         _mega_call(100, 11, 300.0, 60.0),
                         _mega_call(200, 21, 100.0, 10.0)]
    # the slice traced the last two renders: (60 + 10) / (300 + 100)
    run = _run(recorder.recorded, renders=2)
    assert _read("mega_tail_pct", run) == pytest.approx(17.5)
    assert _read("driver_span_ms.frame", run) == pytest.approx(20.0)


def test_readers_read_the_programs_recorder_after_a_capture():
    """Through the program's own recorder: spans recorded under a CPU
    capture, the last render taken."""
    from rtw_tpu_torch.utils import profiling as P

    P.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with P.span("render"):
                with P.span("render.setup"):
                    torch.ones(8).sum()
                with P.span("sched.mega"):
                    with P.span("tables"):
                        pass
                    with P.span("mega.launch") as sp:
                        sp.defer("tail", lambda: {"kernel_ms": 4.0,
                                                  "tail_ms": 1.0})
                with P.span("render.wait"):
                    pass
    run = _run([None], renders=1)
    try:
        assert _read("mega_tail_pct", run) == pytest.approx(25.0)
        last = P.calls(1)[0]
        assert _read("tables_span_ms", run) == pytest.approx(
            1e-6 * sum(s.end_ns - s.start_ns for s in last
                       if s.name == "tables"))
        assert 0 < _read("driver_span_ms.frame", run) < 1e-6 * (
            last[0].end_ns - last[0].start_ns)
        assert _read("wrapper_host_us", run) is None
        assert _read("glue_idle_ms", run) == 0.0
    finally:
        P.clear()
