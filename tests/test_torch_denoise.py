"""The port's denoiser (rtw_tpu_torch.denoise) against rtw_tpu.denoise on
the same inputs, and tests/test_denoise.py's four properties on the
port's own renders.

- `atrous` on the CPU (`atrous_pass_plain` chained pass by pass with the
  halving colour sigma) for 1 to 5 passes, guided and not, at 24x32 and
  at 7x5 (smaller than the largest step's reach, 2 * 16), and `denoise`
  (ldr and hdr) on the same random image: within 1e-5 of the reference
  (measured: 6e-7 at worst).  The CPU path launches no kernel and takes
  float64 and strided planes; the kernel's wrapper refuses what it does
  not take before it looks for a card, and its dispatcher operation has
  no CPU kernel (the kernel itself: tests/test_torch_denoise_cuda.py, on
  the card).
- `primary_features` on scenes 0, 3 and 4 at the goldens' 64x48: albedo
  and normal within 1e-4 (measured: 7.3e-5 at worst, a normal of scene 4),
  the hit mask equal.  The port finds its hits with ops/trace_kernel.trace,
  which on CPU tensors is the reference's intersect_scene sweep.
- The properties at test_denoise.py's 80x80, 4 spp noisy frame; the
  converged frame is 64 spp, not 256, to keep the file short on the CPU
  (its own noise counts against the filter: a harder test)."""

import numpy as np
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu import denoise as JD
import rtw_tpu_torch as rtt
from rtw_tpu_torch import denoise as DN
from rtw_tpu_torch.utils import kernels
from rtw_tpu_torch.denoise import (atrous, atrous_pass, denoise,
                                   primary_features)

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

TOL = 1e-5
FEATURE_TOL = 1e-4


def _planes(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 2.0).astype(np.float32)
    alb = rng.random((h, w, 3)).astype(np.float32)
    nrm = rng.standard_normal((h, w, 3)).astype(np.float32)
    return img, alb, nrm


@pytest.fixture(scope="module")
def inputs():
    return _planes(24, 32)


@pytest.mark.parametrize("size", [(24, 32), (7, 5)])
@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("iterations", [1, 2, 3, 4, 5])
def test_atrous_matches_reference(size, guided, iterations):
    img, alb, nrm = _planes(*size)
    kw = dict(albedo=alb, normal=nrm) if guided else {}
    want = np.asarray(JD.atrous(img, iterations=iterations, **kw))
    got = atrous(torch.as_tensor(img), iterations=iterations,
                 **{k: torch.as_tensor(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_cpu_atrous_launches_no_kernel(inputs):
    img, alb, nrm = (torch.as_tensor(x) for x in inputs)
    kernels.launches.clear()
    atrous(img, albedo=alb, normal=nrm, iterations=5)
    denoise(img, mode="hdr")
    assert kernels.launches["rtw_atrous"] == 0


def test_cpu_atrous_converts_its_planes(inputs):
    img, alb, nrm = (torch.as_tensor(x) for x in inputs)
    want = atrous(img, albedo=alb, normal=nrm, iterations=3)
    got = atrous(img.double().permute(2, 0, 1).contiguous().permute(1, 2, 0),
                 albedo=alb.numpy(), normal=nrm.double(), iterations=3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_atrous_op_has_only_a_cuda_kernel(inputs):
    op = DN._atrous_op()
    assert DN._atrous_op() is op          # defined once a process
    assert str(op.default._schema).startswith("rtw_tpu_torch::atrous_pass(")
    img = torch.as_tensor(inputs[0])
    with pytest.raises(NotImplementedError, match="'CPU' backend"):
        op(img, None, None, 1, 2.0, 1.0, 1.0)


@pytest.mark.parametrize("fault", ["float64", "strided", "shape", "device",
                                   "rank"])
def test_atrous_pass_refuses(inputs, fault):
    img, alb, nrm = (torch.as_tensor(x) for x in inputs)
    kw = dict(albedo=alb, normal=nrm)
    if fault == "float64":
        img, err = img.double(), TypeError
    elif fault == "strided":
        kw["normal"], err = nrm.transpose(0, 1).contiguous().transpose(
            0, 1), ValueError
    elif fault == "shape":
        kw["albedo"], err = alb[:-1].contiguous(), ValueError
    elif fault == "device":
        err = ValueError       # CPU planes: the kernel takes CUDA tensors
    else:
        img, err = img.reshape(-1, 3), ValueError
    kernels.launches.clear()
    with pytest.raises(err):
        atrous_pass(img, step=1, sc=0.5, sigma_albedo=0.13,
                    sigma_normal=0.25, **kw)
    assert kernels.launches["rtw_atrous"] == 0


@pytest.mark.parametrize("mode", ["ldr", "hdr"])
def test_denoise_matches_reference(inputs, mode):
    img = inputs[0]
    want = np.asarray(JD.denoise(img, mode=mode))
    got = denoise(torch.as_tensor(img), mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_denoise_rejects_unknown_mode(inputs):
    with pytest.raises(ValueError, match="'ldr' or 'hdr'"):
        denoise(torch.as_tensor(inputs[0]), mode="log")


@pytest.mark.parametrize("sid", [0, 3, 4])
def test_primary_features_match_reference(sid):
    nx, ny = 64, 48
    want = [np.asarray(x) for x in JD.primary_features(
        rt.build_scene(sid, nx, ny), rt.RenderConfig(nx=nx, ny=ny,
                                                     scene_id=sid))]
    got = [x.numpy() for x in primary_features(
        rtt.build_scene(sid, nx, ny, device="cpu"),
        rtt.RenderConfig(nx=nx, ny=ny, scene_id=sid))]
    for w, g in zip(want[:2], got[:2]):
        assert g.shape == (ny, nx, 3) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=FEATURE_TOL, rtol=FEATURE_TOL)
    np.testing.assert_array_equal(got[2], want[2])


# ------------------------------------------- test_denoise.py's properties


@pytest.fixture(scope="module")
def cornell_pair():
    cfg = rtt.RenderConfig(nx=80, ny=80, spp=4, max_depth=8, scene_id=0)
    scene = rtt.build_scene(0, 80, 80, device="cpu")
    noisy = rtt.render(scene, cfg).numpy()
    ref = rtt.render(scene, rtt.RenderConfig(nx=80, ny=80, spp=64,
                                             max_depth=8, scene_id=0,
                                             seed=1)).numpy()
    return scene, cfg, noisy, ref


def _disp(img, gamma=2.0):
    return np.clip(img, 0.0, 1.0) ** (1.0 / gamma)


def test_denoise_reduces_error(cornell_pair):
    scene, cfg, noisy, ref = cornell_pair
    dn = denoise(torch.as_tensor(noisy), scene, cfg).numpy()  # display space
    ref_d = _disp(ref)
    mse_noisy = ((_disp(noisy) - ref_d) ** 2).mean()
    mse_dn = ((dn - ref_d) ** 2).mean()
    assert mse_dn < mse_noisy / 1.25, (mse_noisy, mse_dn)


def test_denoise_preserves_edges(cornell_pair):
    scene, cfg, noisy, _ = cornell_pair
    dn = denoise(torch.as_tensor(noisy), scene, cfg).numpy()
    # the red/green wall split must survive: column-wise hue contrast
    # between the left and right borders stays strong after filtering
    left_g = dn[20:60, 2:8, 1].mean()
    left_r = dn[20:60, 2:8, 0].mean()
    right_r = dn[20:60, -8:-2, 0].mean()
    right_g = dn[20:60, -8:-2, 1].mean()
    assert left_g > left_r * 1.3       # green wall stays green
    assert right_r > right_g * 1.3     # red wall stays red


def test_features_shapes(cornell_pair):
    scene, cfg, _, _ = cornell_pair
    alb, nrm, mask = primary_features(scene, cfg)
    assert alb.shape == (cfg.ny, cfg.nx, 3)
    assert nrm.shape == (cfg.ny, cfg.nx, 3)
    assert mask.shape == (cfg.ny, cfg.nx)
    assert 0.5 < float(mask.float().mean()) <= 1.0   # closed box: mostly hits
    assert bool(torch.isfinite(alb).all())


def test_atrous_identity_on_flat():
    # a constant image is a fixed point (weights normalize out)
    img = torch.full((32, 32, 3), 0.25)
    out = atrous(img, iterations=3)
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-5)
