"""Whole renders of the port against the reference goldens, and the port's
independence from JAX."""

import importlib
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtw_tpu.render import tile_permutation as j_tile_permutation
from rtw_tpu.render import to_srgb8 as j_to_srgb8
import rtw_tpu_torch as rtt
from rtw_tpu_torch import integrator as TI
from rtw_tpu_torch.integrator import decode_tile_pixel
from rtw_tpu_torch.render import lane_pixels, tile_permutation, to_srgb8

from tests.test_goldens import CFG, EXPECTED, GOLDEN_DIR

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

# the module: the package's `render` attribute is the function
TRN = importlib.import_module("rtw_tpu_torch.render")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# Scenes 1, 2 and 4: the share of pixels within the goldens' 1e-4.  The
# reference's compiled CPU code computes 1/sqrt with an approximate rsqrt
# (right to the ulp on ~89% of inputs) in every normalisation of its
# shading; scenes 1 and 2 (small spheres over an r = 1000 ground sphere)
# can amplify such an ulp until a path goes elsewhere: measured 99.90%
# (scene 1, 3 pixels) and 99.97% (scene 2, 1 pixel) within 1e-4.  Scene 4
# (a cluster of 1000 small spheres, glass, a dense volume and the fog)
# amplifies more: 99.32% (21 pixels, up to 0.017 off), the same 21 with the
# reference's approximate log in place of torch's (ROADMAP "Faults
# found").
GOLDEN_PIXEL_SHARE = {1: 0.999, 2: 0.999, 4: 0.99}


@pytest.mark.parametrize("sid", [0, 1, 2, 3, 4, 5])
def test_render_matches_goldens(sid):
    """The golden config (64x48, 32 spp, depth 10, seed 0, regen) through
    the port's plain path: every pixel within the goldens' rtol/atol 1e-4
    on scenes 0, 3 and 5 (measured: max abs diff 6.1e-6, 1.2e-7 on scene
    3); on scenes 1, 2 and 4 the pixel share of GOLDEN_PIXEL_SHARE within
    it, and the channel means within 1e-3 of the golden image's."""
    cfg = rtt.RenderConfig(scene_id=sid, **CFG)
    m = {}
    img = rtt.render(rtt.build_scene(sid, cfg.nx, cfg.ny, device="cpu"), cfg,
                     metrics=m)
    img = img.numpy()
    assert img.shape == (cfg.ny, cfg.nx, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img.reshape(-1, 3).mean(axis=0),
                               EXPECTED[sid], rtol=0.02, atol=0.003)
    with np.load(os.path.join(GOLDEN_DIR, f"scene{sid}.npz")) as z:
        ref = z["img"]
    if sid in GOLDEN_PIXEL_SHARE:
        close = (np.abs(img - ref) <= 1e-4 + 1e-4 * np.abs(ref)).all(-1)
        assert close.mean() >= GOLDEN_PIXEL_SHARE[sid]
        np.testing.assert_allclose(img.reshape(-1, 3).mean(0),
                                   ref.reshape(-1, 3).mean(0), atol=1e-3)
    else:
        np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-4)
    assert m["paths"] == cfg.num_pixels * cfg.spp
    assert m["rays"] > m["paths"]


@pytest.mark.parametrize("sid", [0, 3, 5])
def test_mega_scheduler_renders_the_same_image(sid):
    """The megakernel's plain twin draws the same samples as the regen path:
    the same ray count and the same image to float rounding."""
    cfg = rtt.RenderConfig(nx=32, ny=24, spp=4, max_depth=8, scene_id=sid)
    scene = rtt.build_scene(sid, cfg.nx, cfg.ny, device="cpu")
    ma, mb = {}, {}
    a = rtt.render(scene, cfg, metrics=ma)
    b = rtt.render(scene, rtt.RenderConfig(**{**cfg.__dict__,
                                              "scheduler": "mega"}),
                   metrics=mb)
    assert ma["rays"] == mb["rays"]
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_build_scene_defaults_to_the_card():
    """No device asked for: the scene goes to CUDA, and without a card
    that raises instead of building on the CPU."""
    if torch.cuda.is_available():
        assert rtt.build_scene(5, 8, 8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rtt.build_scene(5, 8, 8)


def test_tile_permutation_and_srgb_match_reference():
    np.testing.assert_array_equal(tile_permutation(70, 45),
                                  j_tile_permutation(70, 45))
    lin = np.random.default_rng(0).uniform(-0.2, 1.5, (45, 70, 3))
    lin = lin.astype(np.float32)
    want = (np.clip(lin, 0.0, 1.0) ** 0.5 * 255.99).astype(np.uint8)[::-1]
    got = to_srgb8(torch.as_tensor(lin), 2.0)
    np.testing.assert_array_equal(got, want)
    ref = j_to_srgb8(lin, 2.0)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("nx,ny", [(64, 64), (96, 32), (100, 56), (80, 48),
                                   (50, 40), (1200, 600), (33, 35),
                                   (800, 800), (37, 53)])
def test_decode_tile_pixel_matches_the_reference_permutation(nx, ny):
    """The closed form is the reference's lexsort, partial edge tiles
    included, in int32."""
    got = decode_tile_pixel(torch.arange(nx * ny, dtype=torch.int32), nx, ny)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), j_tile_permutation(nx, ny))


def test_lane_pixels_pad_the_last_batch_with_pixel_0():
    """render()'s lane map at a ray batch that does not divide the image:
    the permutation on the image's lanes, pixel 0 on the padding."""
    cfg = rtt.RenderConfig(nx=70, ny=45, ray_batch=1000)
    npix, batch = cfg.num_pixels, cfg.resolved_ray_batch()
    n_lanes = math.ceil(npix / batch) * batch
    assert n_lanes > npix
    pix = lane_pixels(cfg.nx, cfg.ny, n_lanes, torch.device("cpu"))
    assert pix.dtype == torch.int32 and pix.shape == (n_lanes,)
    np.testing.assert_array_equal(pix[:npix].numpy(),
                                  j_tile_permutation(cfg.nx, cfg.ny))
    assert (pix[npix:] == 0).all()


def _render_by_host_permutation(scene, cfg):
    """render()'s loop and assembly with the lane map taken from the numpy
    permutation and scattered through it, as before the closed form."""
    npix, batch = cfg.num_pixels, cfg.resolved_ray_batch()
    n_tiles = math.ceil(npix / batch)
    perm = tile_permutation(cfg.nx, cfg.ny)
    pix = torch.as_tensor(np.concatenate(
        [perm, np.zeros(n_tiles * batch - npix, np.int32)]))
    chunk = cfg.resolved_spp_chunk(checkpointing=False)
    accums = [torch.zeros((batch, 3)) for _ in range(n_tiles)]
    for s0 in range(0, cfg.spp, chunk):
        for ti in range(n_tiles):
            acc, _, _ = TI.trace_wavefront(
                scene, cfg, pix[ti * batch:(ti + 1) * batch], cfg.seed, s0,
                min(chunk, cfg.spp - s0))
            accums[ti] = accums[ti] + acc.stack()
    img = torch.empty((npix, 3))
    img[torch.as_tensor(perm, dtype=torch.int64)] = torch.cat(accums)[:npix]
    return (img / float(np.float32(cfg.spp))).reshape(cfg.ny, cfg.nx, 3)


@pytest.mark.parametrize("path", ["mega", "queue"])
def test_render_takes_no_host_permutation(monkeypatch, path):
    """render() never calls the numpy sort, and its image is bit-equal to
    the one assembled through it; several padded batches, two chunks."""
    if path == "queue":
        monkeypatch.setattr(TI, "_split_backend", lambda cfg, scene: True)
        sid, nx, ny, opts = 2, 16, 8, dict(scheduler="queue", ray_batch=48)
    else:
        sid, nx, ny, opts = 0, 16, 16, dict(backend="mega", ray_batch=96)
    scene = rtt.build_scene(sid, nx, ny, device="cpu")
    cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=2, spp_chunk=1, max_depth=4,
                           scene_id=sid, **opts)
    want = _render_by_host_permutation(scene, cfg)

    def refuse(*args, **kwargs):
        raise AssertionError("render() sorted the permutation on the host")
    monkeypatch.setattr(TRN, "tile_permutation", refuse)
    got = rtt.render(scene, cfg)
    assert torch.equal(got, want)


def test_render_image_is_the_encoded_render():
    cfg = rtt.RenderConfig(nx=16, ny=8, spp=2, max_depth=4, scene_id=5)
    scene = rtt.build_scene(5, 16, 8, device="cpu")
    img = rtt.render_image(scene, cfg)
    assert img.shape == (8, 16, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, to_srgb8(rtt.render(scene, cfg)))


def test_import_pulls_in_no_jax():
    code = ("import sys, rtw_tpu_torch, rtw_tpu_torch.ops.mega_kernel, "
            "rtw_tpu_torch.ops.trace_kernel, rtw_tpu_torch.ops.textures, "
            "rtw_tpu_torch.ops.shade_kernel, "
            "rtw_tpu_torch.integrator, rtw_tpu_torch.utils.kernels, "
            "rtw_tpu_torch.diff, rtw_tpu_torch.grad_demo, "
            "rtw_tpu_torch.utils.image, rtw_tpu_torch.utils.profiling, "
            "rtw_tpu_torch.parallel.mesh, rtw_tpu_torch.parallel.worker, "
            "rtw_tpu_torch.denoise, rtw_tpu_torch.cli, rtw_tpu_torch.entry; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'rtw_tpu.')) or m == 'rtw_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
