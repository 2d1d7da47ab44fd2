"""The harness is driven by data: a new configuration, mix, cell or metric
is new files and entries; `BENCHMARK.json` keeps to the contract's
characters and sizes; the cells' files parse."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from harness import spec, traffic
from harness import trace as tr

from conftest import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATHLIKE = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def _tree_digest(root):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(root)):
        if "__pycache__" in d:
            continue
        for name in sorted(files):
            p = os.path.join(d, name)
            h.update(p[len(root):].encode())
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == KEYS["top"]
    assert len(json.dumps(b)) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(_line(w)
                                                for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATHLIKE.match(p) and ".." not in p and not p.startswith("/")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            extra = {"workloads"} if group in ("end_to_end",
                                               "per_layer") else set()
            assert KEYS[group] <= set(e) <= KEYS[group] | extra, e
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    assert len(names) == len(set(names))
    configs = {c["name"] for c in b["configs"]}
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for c in b["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in b["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_a_full_check_fits_with_24_cells():
    rs = _bench()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_loads(cell):
    """Each cell's configuration, mix and notes parse, give a render
    configuration, report setup_s, another end-to-end metric and a
    per-layer metric, and every metric has its reader.  A render cell's
    configuration changes and assumes nothing; a gradient cell's lists in
    its file the keys `BENCHMARK.json` says it changed, and what it
    assumed; each cell's limits are those of its call's check (a denoised
    frame's are a render's)."""
    import plainref.config
    from harness import check, grad

    c = spec.load_cell(cell)
    entry = {e["name"]: e for e in _bench()["configs"]}[
        {w["name"]: w for w in _bench()["workloads"]}[cell]["config"]]
    if traffic.call_kind(c.traffic) in ("render", "render_denoised"):
        fields = traffic.render_fields(c.config, c.traffic)
        assert c.config["reduced"] == [] and c.config["assumed"] == []
        numbers = check.NUMBERS
    else:
        fields = grad.grad_fields(c.config, c.traffic)
        assert fields["differentiable"] and c.config["assumed"]
        assert set(c.config["reduced"]) <= set(c.config)
        numbers = grad.NUMBERS
    plainref.config.RenderConfig(**fields)
    assert c.config["reduced"] == entry["reduced"]
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m.name))
    assert set(c.notes["limits"]) >= set(numbers)
    assert c.notes["limits"]["nonfinite"] == 0
    for key in ("why", "seeds", "window"):
        assert key in c.notes, key


def _report(bench: dict, metric: str, cell: str) -> None:
    """Add `cell` to the cells that `metric` lists, as a later cell's
    entry does."""
    m = {e["name"]: e for e in bench["end_to_end"] + bench["per_layer"]}
    m[metric]["workloads"].append(cell)


def test_new_config_mix_cell_and_metric_are_only_files(tmp_path):
    """A throwaway configuration, mix, cell and per-layer metric added as
    files and entries to a copy: the harness finds them, and no file that
    was there changes."""
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_copy = os.path.join(root, "benchmark")
    before = _tree_digest(bench_copy)

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "throwaway", "source": "https://example.org",
                         "file": "benchmark/configs/throwaway.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "throwaway-cell", "config": "throwaway",
                           "traffic": "throwaway-mix", "chips": 1,
                           "why": "a test"})
    _report(b, "msamples_per_s", "throwaway-cell")
    b["per_layer"].append({"name": "throwaway_ms.x", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "driver (render.py)",
                           "moves": "msamples_per_s",
                           "workloads": ["throwaway-cell"]})
    files = {
        "configs/throwaway.json": {"name": "throwaway", "scene_id": 5,
                                   "nx": 16, "ny": 8, "max_depth": 4,
                                   "reduced": [], "assumed": []},
        "traffic/throwaway-mix.json": {"spp": 3, "options": {"rng": "tea"},
                                       "warmup_calls": 1, "max_calls": 4,
                                       "check": {"renders": 1, "pixels": 8},
                                       "trace_renders": 1},
        "cells/throwaway-cell.json": {"why": "a test", "seeds": [],
                                      "window": "none",
                                      "limits": {"rel_l1": 0.5,
                                                 "off_share": 0.5,
                                                 "nonfinite": 0}},
    }
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    for rel, doc in files.items():
        with open(os.path.join(bench_copy, rel), "w") as f:
            json.dump(doc, f)
    with open(os.path.join(bench_copy, "metrics", "throwaway_ms.x.py"),
              "w") as f:
        f.write("def read(run):\n    return 42.0 + len(run.calls)\n")

    c = spec.load_cell("throwaway-cell", root=root)
    assert traffic.render_fields(c.config, c.traffic) == dict(
        nx=16, ny=8, spp=3, max_depth=4, scene_id=5, rng="tea")
    assert [m.name for m in c.per_layer] == ["throwaway_ms.x"]
    assert {m.name for m in c.end_to_end} == {"msamples_per_s", "setup_s"}

    # a traced run of the new cell on the CPU reads the new metric
    import io
    import time

    from harness import drive

    r = drive.run_cell(c, 77, 0.0, True, time.perf_counter(), device="cpu",
                       log=io.StringIO())
    assert r["correct"] and r["attempted"] == 1
    assert r["metrics"] == {"throwaway_ms.x": {"value": 43.0, "unit": "ms"}}
    # the old cells load unchanged beside it
    for w in _bench()["workloads"]:
        old = spec.load_cell(w["name"], root=root)
        assert "throwaway_ms.x" not in {m.name for m in old.per_layer}
    for rel in files:
        os.remove(os.path.join(bench_copy, rel))
    os.remove(os.path.join(bench_copy, "metrics", "throwaway_ms.x.py"))
    assert _tree_digest(bench_copy) == before


def test_new_gradient_mix_is_only_files(tmp_path):
    """A throwaway gradient configuration, mix and cell added as files and
    entries to a copy: the harness runs the gradient call from them, and
    no file that was there changes."""
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_copy = os.path.join(root, "benchmark")
    before = _tree_digest(bench_copy)

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "throwaway", "source": "https://example.org",
                         "file": "benchmark/configs/throwaway.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "throwaway-grad", "config": "throwaway",
                           "traffic": "throwaway-grad-mix", "chips": 1,
                           "why": "a test"})
    _report(b, "msamples_per_s", "throwaway-grad")
    files = {
        "configs/throwaway.json": {"name": "throwaway", "scene_id": 5,
                                   "nx": 12, "ny": 8, "max_depth": 3,
                                   "differentiable": True, "remat": True,
                                   "fit_row": 1, "reduced": [],
                                   "assumed": ["a test"]},
        "traffic/throwaway-grad-mix.json": {
            "call": "grad_step", "n_samples": 2, "spp_chunk": 1,
            "fit": {"start": [0.1, 0.2, 0.3], "lr": 0.5, "decay": 0.9,
                    "decay_after": 0},
            "warmup_calls": 1, "max_calls": 2, "check": {"renders": 1},
            "trace_renders": 1},
        "cells/throwaway-grad.json": {
            "why": "a test", "seeds": [], "window": "none",
            "limits": {"loss_rel_err": 1e-4, "tex_grad_rel_l1": 1e-3,
                       "cam_grad_rel_l1": 1e-3, "nonfinite": 0}},
    }
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    for rel, doc in files.items():
        with open(os.path.join(bench_copy, rel), "w") as f:
            json.dump(doc, f)

    import io
    import time

    from harness import drive

    c = spec.load_cell("throwaway-grad", root=root)
    r = drive.run_cell(c, 78, 0.0, False, time.perf_counter(), device="cpu",
                       log=io.StringIO())
    assert r["correct"] and r["attempted"] == 1, r["checks"]
    assert set(r["metrics"]) == {"msamples_per_s", "setup_s"}
    assert list(r["checks"]) == ["loss_rel_err", "tex_grad_rel_l1",
                                 "cam_grad_rel_l1", "nonfinite"]
    for rel in files:
        os.remove(os.path.join(bench_copy, rel))
    assert _tree_digest(bench_copy) == before


def test_call_seeds_are_distinct_and_take_large_seeds():
    s = 2 ** 31 + 12345
    seeds = {traffic.call_seed(s, k) for k in range(1000)}
    assert len(seeds) == 1000 and min(seeds) > 0 and max(seeds) < 2 ** 62
    assert traffic.call_seed(s, 3) != traffic.call_seed(s + 1, 3)
    a = traffic.pixel_samples(s, 5, 640000, 64)
    assert (a == traffic.pixel_samples(s, 5, 640000, 64)).all()
    assert a.shape == (5, 64) and a.min() >= 0 and a.max() < 640000
    assert traffic.checked_calls(s, 10, 4) == traffic.checked_calls(s, 10, 4)
    assert 9 in traffic.checked_calls(s, 10, 4)
    assert traffic.checked_calls(s, 2, 4) == [0, 1]


def test_trace_reduction_union_and_gaps():
    """Overlapping device intervals merge; each gap is named by the
    innermost host operation over its middle."""
    dev = [(0, 10, "k1"), (5, 20, "k2"), (30, 40, "k1"), (100, 110, "k3")]
    host = [(0, 200, "render"), (22, 28, "aten::copy_"),
            (50, 90, "cudaStreamSynchronize")]
    merged = tr._union(dev)
    assert merged == [[0, 20], [30, 40], [100, 110]]
    gaps = tr._label_gaps(merged, host)
    assert gaps == pytest.approx({"host aten::copy_": 10e-9,
                                  "host cudaStreamSynchronize": 60e-9})


def test_readers_find_nothing_without_a_trace():
    from harness import drive

    c = spec.load_cell("cornell-1000spp")
    run = drive.Run(cell=c, setup_s=1.0, window_s=2.0,
                    calls=[drive.Call(0.5, 0.4, 10)] * 4,
                    samples_per_call=1000, n_pixels=100)
    assert spec.metric_reader("msamples_per_s")(run) == pytest.approx(
        4 * 1000 / 2.0 / 1e6)
    assert spec.metric_reader("driver_host_ms.image")(run) == pytest.approx(
        100.0)
    for name in ("mega_roofline", "trace_roofline", "device_idle_pct",
                 "launches_per_image"):
        assert spec.metric_reader(name)(run) is None


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    """A short run of the frame cell on the card prints a correct result
    with every end-to-end metric."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cornell-frame-1spp", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"msamples_per_s", "frame_ms_p95",
                                   "setup_s"}
