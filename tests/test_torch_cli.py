"""The port's command line (rtw_tpu_torch.cli), image output and metrics
sidecar against the reference's (rtw_tpu.cli, rtw_tpu.utils.image,
rtw_tpu.utils.profiling).

- The parser: every flag, default and choice, so each argv parses to the
  reference's namespace; `_clamp`'s warnings and the scene check.
- utils/image.py: the same PPM bytes and SSIM.
- One `main` of each package on the same argv (scene 5, 320x200, 1 spp,
  depth 3, regen, on the CPU): the uint8 images within 1 level (measured:
  every pixel equal).
- `--denoise`, `--metrics-json` and `--profile-dir` write their files;
  `-g` raises on a non-finite linear image."""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from rtw_tpu import cli as JC
from rtw_tpu.utils import image as JI
from rtw_tpu_torch import cli as TC
from rtw_tpu_torch.utils import image as TI
from rtw_tpu_torch.utils import profiling as TP

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

ARGVS = [
    [],
    ["-s", "0", "-ns", "1000", "-dx", "600", "-dy", "600", "-o", "c.png"],
    ["-s", "2", "-v", "-g", "--max-depth", "8", "--seed", "3", "--dof",
     "book", "--estimator", "reference", "--checkpoint", "ck.npz",
     "--checkpoint-every", "16", "--sharded", "--denoise", "--metrics-json",
     "m.json", "--profile-dir", "prof", "--cpu", "--scheduler", "qmega"],
    ["--scene", "5", "--samples", "7", "--width", "400", "--height", "224",
     "--verbose", "--debug", "--output", "-", "--estimator", "book",
     "--scheduler", "regen"],
    ["--estimator", "mis", "--scheduler", "mega", "--dof", "reference"],
    ["-s", "1", "--scheduler", "queue"],
]
MAIN_ARGV = ["--cpu", "-s", "5", "-dx", "320", "-dy", "200", "-ns", "1",
             "--max-depth", "3", "--scheduler", "regen"]


@pytest.mark.parametrize("argv", ARGVS)
def test_parser_matches_reference(argv):
    assert (vars(TC.build_parser().parse_args(argv))
            == vars(JC.build_parser().parse_args(argv)))


@pytest.mark.parametrize("argv", [["--scheduler", "fast"],
                                  ["--estimator", "nee"], ["--dof", "x"]])
def test_parser_refuses_what_the_reference_refuses(argv):
    for parser in (TC.build_parser(), JC.build_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(argv)


@pytest.mark.parametrize("v, lo, hi", [(100, 320, 3840), (5000, 320, 3840),
                                       (0, 1, 10240), (20000, 1, 10240),
                                       (640, 320, 3840)])
def test_clamp_matches_reference(capsys, v, lo, hi):
    got = TC._clamp(v, lo, hi, "dx")
    got_err = capsys.readouterr().err
    assert got == JC._clamp(v, lo, hi, "dx")
    assert got_err == capsys.readouterr().err
    assert ("WARNING" in got_err) == (not lo <= v <= hi)


def test_unknown_scene_exits_1(capsys):
    assert TC.main(["-s", "6", "--cpu"]) == 1
    port_err = capsys.readouterr().err
    assert JC.main(["-s", "6", "--cpu"]) == 1
    assert port_err == capsys.readouterr().err == "ERROR: Scene 6 unknown.\n"


@pytest.fixture(scope="module")
def u8():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)


def test_ppm_bytes_match_reference(u8, tmp_path):
    a, b = io.StringIO(), io.StringIO()
    TI.write_ppm(u8, a)
    JI.write_ppm(u8, b)
    assert a.getvalue() == b.getvalue()
    TI.write_image(u8, str(tmp_path / "t.ppm"))
    JI.write_image(u8, str(tmp_path / "j.ppm"))
    assert ((tmp_path / "t.ppm").read_bytes()
            == (tmp_path / "j.ppm").read_bytes())


def test_png_round_trip(u8, tmp_path):
    TI.write_image(u8, str(tmp_path / "t.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  u8)


def test_ssim_matches_reference():
    rng = np.random.default_rng(1)
    a = rng.random((40, 56, 3))
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0.0, 1.0)
    assert TI.ssim(a, b) == JI.ssim(a, b)
    assert TI.ssim(a, a) == pytest.approx(1.0)


def test_write_metrics_layout(tmp_path):
    ph = TP.Phases()
    with ph("render"):
        pass
    with ph("render"):
        pass
    path = str(tmp_path / "m.json")
    TP.write_metrics(path, {"rays": 3, "mrays_per_sec": np.float32(1.5)}, ph)
    doc = json.load(open(path))
    assert set(doc) == {"rays", "mrays_per_sec", "render_s"}
    assert doc["rays"] == 3 and doc["mrays_per_sec"] == 1.5
    assert TP.device_memory() == {}          # no card in use


def test_main_matches_reference(tmp_path):
    t, j = str(tmp_path / "t.ppm"), str(tmp_path / "j.ppm")
    assert TC.main(MAIN_ARGV + ["-o", t]) == 0
    assert JC.main(MAIN_ARGV + ["-o", j]) == 0
    assert open(t).readline() == open(j).readline() == "P3\n"
    a = np.asarray(Image.open(t)).astype(int)
    b = np.asarray(Image.open(j)).astype(int)
    assert a.shape == b.shape == (200, 320, 3)
    assert np.abs(a - b).max() <= 1
    # measured: every pixel equal
    assert int((a != b).any(-1).sum()) == 0


def test_main_writes_denoised_png_metrics_and_trace(tmp_path):
    out, m, prof = (str(tmp_path / n) for n in ("d.png", "m.json", "prof"))
    assert TC.main(MAIN_ARGV + ["--denoise", "--metrics-json", m,
                                "--profile-dir", prof, "-o", out]) == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (200, 320, 3) and img.dtype == np.uint8
    doc = json.load(open(m))
    for key in ("rays", "mrays_per_sec", "wall_seconds", "rays_by_depth",
                "wavefront_iterations", "scene_build_s", "render_s"):
        assert key in doc, key
    assert doc["rays"] > 0
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert json.load(open(os.path.join(prof, traces[0])))["traceEvents"]


def test_debug_raises_on_a_non_finite_image(monkeypatch, tmp_path):
    TR = sys.modules["rtw_tpu_torch.render"]
    real = TR.render

    def nan_render(*a, **kw):
        img = real(*a, **kw)
        img[0, 0, 0] = float("nan")
        return img
    monkeypatch.setattr(TR, "render", nan_render)
    argv = MAIN_ARGV + ["-o", str(tmp_path / "x.ppm")]
    with pytest.raises(FloatingPointError, match="non-finite"):
        TC.main(argv + ["-g"])
    assert TC.main(argv) == 0           # without -g the image is written
