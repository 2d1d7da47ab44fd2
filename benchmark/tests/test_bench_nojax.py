"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; without a card a run refuses to measure."""

import json
import subprocess
import sys

from conftest import ROOT

PROBE = r"""
import sys, json
sys.path[:0] = ["benchmark", "."]
import torch
import rtw_tpu_torch, rtw_tpu_torch.render, rtw_tpu_torch.integrator
from harness import check, drive, readers, spec, trace, traffic, work
import plainref.paths, plainref.registry
for m in spec.load_benchmark()["end_to_end"] + spec.load_benchmark()["per_layer"]:
    spec.metric_reader(m["name"])
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"tops": tops, "forbidden": drive.forbidden_modules()}))
"""


def test_harness_reference_and_program_load_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    for name in ("jax", "jaxlib", "flax", "rtw_tpu"):
        assert name not in got["tops"]
    assert "rtw_tpu_torch" in got["tops"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    from harness import drive

    monkeypatch.setitem(sys.modules, "rtw_tpu_torch_extra", sys)
    assert "rtw_tpu" not in drive.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rtw_tpu.utils", sys)
    assert "rtw_tpu" in drive.forbidden_modules()


def test_without_a_card_the_run_refuses():
    """The cell's command on this CPU: exit 3, no result line, nothing
    measured."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cornell-frame-1spp", "--seed", "5", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": ROOT})
    try:
        import torch
        has_card = torch.cuda.is_available()
    except ImportError:
        has_card = False
    if has_card:
        return
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "refused" in out.stderr
