"""Guard the port's committed evidence from the card (the counterpart of
tests/test_parity.py).

docs/torch/parity/scene{N}_vs_ref[_denoised].png are side-by-side images
(left: the port's render on an H100, right: the reference's render, the
right half of docs/parity/scene{N}_vs_ref.png) written by
tools/compare_reference_torch.py; docs/torch/kernel_check.json is
tools/kernel_check_torch.py's report.  This file re-scores the committed
pairs with the same SSIM, against floors at the committed pairs' own
SSIM less a margin of 0.05 (tests/test_parity.py's margins
are 0.053-0.063), scores the port's left halves against the JAX package's
committed TPU renders the same way, and checks that the kernel report
holds all eight cases and passes."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from rtw_tpu_torch.utils.image import ssim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_DIR = os.path.join(REPO, "docs", "torch")
PARITY_DIR = os.path.join(TORCH_DIR, "parity")
JAX_PARITY_DIR = os.path.join(REPO, "docs", "parity")
MARGIN = 0.05

# SSIM of the committed pairs as this file scores them: the port against
# the reference's render, and against the JAX package's TPU render (the
# same samples: 200 spp, and 1000 spp denoised).  The PNGs hold the render
# rounded to 8 bits; the tool scores its float render, so its figures
# (PERF.md) differ from these by up to 0.001
SSIM_MEASURED = {0: 0.5427, 1: 0.5310, 2: 0.4453, 4: 0.3525}
SSIM_MEASURED_DENOISED = {0: 0.8383, 1: 0.5434, 2: 0.4485, 4: 0.4985}
SSIM_VS_TPU = {0: 1.0, 1: 0.9999, 2: 0.9966, 4: 0.9997}
SSIM_VS_TPU_DENOISED = {0: 0.9989, 1: 0.9992, 2: 0.9971, 4: 0.9986}
KERNEL_CHECK_CASES = 8


def _halves(path):
    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    w = img.shape[1] // 2
    return img[:, :w], img[:, w:]


@pytest.mark.parametrize("tag,floors", [("", SSIM_MEASURED),
                                        ("_denoised",
                                         SSIM_MEASURED_DENOISED)])
@pytest.mark.parametrize("sid", [0, 1, 2, 4])
def test_committed_parity_pair(sid, tag, floors):
    ours, ref = _halves(os.path.join(PARITY_DIR,
                                     f"scene{sid}_vs_ref{tag}.png"))
    _, want_ref = _halves(os.path.join(JAX_PARITY_DIR,
                                       f"scene{sid}_vs_ref{tag}.png"))
    np.testing.assert_array_equal(ref, want_ref)
    s = ssim(ours, ref)
    assert s >= floors[sid] - MARGIN, (
        f"scene {sid}{tag}: SSIM {s:.4f} below the floor "
        f"{floors[sid] - MARGIN:.4f}: docs/torch/parity no longer matches")


@pytest.mark.parametrize("tag,floors", [("", SSIM_VS_TPU),
                                        ("_denoised", SSIM_VS_TPU_DENOISED)])
@pytest.mark.parametrize("sid", [0, 1, 2, 4])
def test_port_render_against_the_tpu_render(sid, tag, floors):
    ours, _ = _halves(os.path.join(PARITY_DIR,
                                   f"scene{sid}_vs_ref{tag}.png"))
    tpu, _ = _halves(os.path.join(JAX_PARITY_DIR,
                                  f"scene{sid}_vs_ref{tag}.png"))
    assert ours.shape == tpu.shape
    s = ssim(ours, tpu)
    assert s >= floors[sid] - MARGIN, (sid, tag, s)


def test_archaeology_strip_holds_the_reference_panel():
    strip = np.asarray(Image.open(os.path.join(
        PARITY_DIR, "scene2_archaeology.png")).convert("RGB"))
    _, ref = _halves(os.path.join(JAX_PARITY_DIR, "scene2_vs_ref.png"))
    assert strip.shape == (133, 1600, 3)
    np.testing.assert_array_equal(strip[:, 400:800] / np.float32(255.0),
                                  ref)


def test_kernel_check_report_passes_on_every_case():
    with open(os.path.join(TORCH_DIR, "kernel_check.json")) as f:
        rep = json.load(f)
    assert rep["backend"] == "cuda" and "H100" in rep["card"]
    assert len(rep["cases"]) == KERNEL_CHECK_CASES
    assert rep["all_pass"] is True
    for case in rep["cases"]:
        assert case["pass"] is True, case["scene"]
        assert case["prim_idx_mismatches"] == 0, case["scene"]
        assert set(case["lanes_bit_equal"]) >= {"trace", "occluded"}
    steps = {name for c in rep["cases"] for name in c["lanes_bit_equal"]}
    assert steps == {"trace", "occluded", "mega_step", "mega_step_hybrid"}


def test_occupancy_report_holds_each_scene_and_scheduler():
    with open(os.path.join(TORCH_DIR, "occupancy.json")) as f:
        rep = json.load(f)
    assert "H100" in rep["card"]
    for sid, (nx, ny, spp) in {"1": (800, 400, 16), "2": (800, 400, 16),
                               "4": (800, 400, 8)}.items():
        assert rep[sid]["workload"] == [nx, ny, spp]
        for sched in ("queue", "regen"):
            e = rep[sid][sched]
            assert e["rays_by_depth"][0] == nx * ny * spp
            assert 0.0 < e["mean_occupancy"] <= 1.0
            assert len(e["occupancy_by_iter"]) == e["wavefront_iterations"]
