"""The à-trous kernel (csrc/denoise_kernel.cu) on the card, against its plain
twin `atrous_pass_plain` on the same card.  Marked `cuda`: each test skips
without a card, and the file imports nothing of JAX, so that it runs on the
machine with the card:

    python3 -m pytest --noconftest -q tests/test_torch_denoise_cuda.py

- Each pass of the kernel against the plain pass at the same input (the
  plain chain's), and the five passes of `atrous` against the plain chain,
  within 1e-5 absolute + 1e-5 relative on every pixel: ldr and hdr,
  guided and unguided, at the Cornell 800x800 G-buffer and 1-spp frame
  and at 24x32, 7x5 and 1x1.  The two differ by the order of torch's
  channel sums and nothing else (`-fmad=false`, the same `expf`).
- `kernels.launches["rtw_atrous"]` grows by `iterations` a call of `atrous`.
- The wrapper `atrous_pass` refuses float64, non-contiguous and
  mismatched planes on the card, and launches nothing then; `atrous`
  converts them (float64, a strided view, guidance on the CPU) and gives
  what it gives on contiguous float32 planes.
- Under torch.profiler each launch is linked to its dispatcher operation
  `rtw_tpu_torch::atrous_pass`.
"""

import numpy as np
import pytest
import torch

import rtw_tpu_torch as rtt
from rtw_tpu_torch import denoise as DN
from rtw_tpu_torch.utils import kernels

pytestmark = pytest.mark.cuda

TOL = 1e-5
SIGMAS = dict(sigma_albedo=0.13, sigma_normal=0.25)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _random(h, w, mode, card, seed=0):
    """(image, albedo, normal) on the card: an HDR image with fireflies,
    put in display space for ldr as `denoise` does."""
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)) * 2.0
    img[rng.random((h, w)) < 0.02] *= 50.0
    alb = rng.random((h, w, 3))
    nrm = rng.standard_normal((h, w, 3))
    img, alb, nrm = (torch.as_tensor(x, dtype=torch.float32, device=card)
                     for x in (img, alb, nrm))
    if mode == "ldr":
        img = torch.clamp(img, 0.0, 1.0) ** 0.5
    return img, alb, nrm


@pytest.fixture(scope="module")
def cornell(card):
    """The Cornell box's 1-spp frame and G-buffer at 800x800."""
    cfg = rtt.RenderConfig(nx=800, ny=800, spp=1, max_depth=20, scene_id=0)
    scene = rtt.build_scene(0, cfg.nx, cfg.ny)
    img = rtt.render(scene, cfg)
    alb, nrm, _ = DN.primary_features(scene, cfg)
    return img.contiguous(), alb.contiguous(), nrm.contiguous()


def _inputs(size, mode, card, cornell_frame):
    if size == "cornell":
        img, alb, nrm = cornell_frame
        if mode == "ldr":
            img = torch.clamp(img, 0.0, 1.0) ** 0.5
        return img, alb, nrm
    return _random(*size, mode, card)


def _assert_close(got, want, what):
    bad = (got - want).abs() > TOL + TOL * want.abs()
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} of {want.numel()} values off, max abs "
        f"diff {float((got - want).abs().max()):.3e}")


@pytest.mark.parametrize("size", ["cornell", (24, 32), (7, 5), (1, 1)])
@pytest.mark.parametrize("guided", [True, False])
@pytest.mark.parametrize("mode", ["ldr", "hdr"])
def test_kernel_matches_plain(card, request, size, guided, mode):
    frame = request.getfixturevalue("cornell") if size == "cornell" else None
    img, alb, nrm = _inputs(size, mode, card, frame)
    g = (alb, nrm) if guided else (None, None)
    plain, sc = img, 0.5
    for it in range(5):
        got = DN.atrous_pass(plain, *g, 1 << it, sc, **SIGMAS)
        plain = DN.atrous_pass_plain(plain, *g, 1 << it, sc, **SIGMAS)
        _assert_close(got, plain, f"pass {it}")
        sc *= 0.5
    whole = DN.atrous(img, *g, iterations=5)
    torch.cuda.synchronize()
    _assert_close(whole, plain, "atrous")
    assert bool(torch.isfinite(whole).all())


@pytest.mark.parametrize("iterations", [1, 3, 5])
def test_launches_count_the_passes(card, iterations):
    img, alb, nrm = _random(24, 32, "hdr", card)
    kernels.launches.clear()
    DN.atrous(img, alb, nrm, iterations=iterations)
    DN.atrous(img, iterations=iterations)
    assert kernels.launches["rtw_atrous"] == 2 * iterations


@pytest.mark.parametrize("fault", ["float64", "strided", "shape", "cpu"])
def test_wrapper_refuses(card, fault):
    img, alb, nrm = _random(24, 32, "hdr", card)
    if fault == "float64":
        img, err = img.double(), TypeError
    elif fault == "strided":
        nrm, err = nrm.transpose(0, 1).contiguous().transpose(0, 1), \
            ValueError
    elif fault == "shape":
        alb, err = alb[:, :-1].contiguous(), ValueError
    else:
        alb, err = alb.cpu(), ValueError
    kernels.launches.clear()
    with pytest.raises(err):
        DN.atrous_pass(img, alb, nrm, 1, 0.5, **SIGMAS)
    assert kernels.launches["rtw_atrous"] == 0


@pytest.mark.parametrize("form", ["float64", "strided", "cpu_guidance"])
def test_atrous_takes_what_it_can_convert(card, form):
    img, alb, nrm = _random(24, 32, "hdr", card)
    want = DN.atrous(img, alb, nrm, iterations=3)
    if form == "float64":
        img = img.double()
    elif form == "strided":                 # an HWC view of a CHW tensor
        img = img.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    else:
        alb, nrm = alb.cpu(), nrm.cpu()
    kernels.launches.clear()
    got = DN.atrous(img, alb, nrm, iterations=3)
    assert kernels.launches["rtw_atrous"] == 3
    assert got.dtype == torch.float32 and got.device == want.device
    _assert_close(got, want, form)


def test_profiler_ties_each_launch_to_its_operation(card):
    """Each launch's runtime call is linked to the dispatcher operation
    `rtw_tpu_torch::atrous_pass`, as torch's own launches are to theirs,
    so that a trace attributes the kernel to the ranges around it."""
    from torch.profiler import ProfilerActivity, profile

    img, alb, nrm = _random(64, 64, "hdr", card)
    DN.atrous(img, alb, nrm, iterations=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        DN.atrous(img, alb, nrm, iterations=5)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events
               if e.device_type() == cuda and "atrous_kernel" in e.name()]
    host = [e for e in events if e.device_type() != cuda]
    launches = {e.correlation_id(): e for e in host
                if e.linked_correlation_id() > 0}
    # the operations' own ids (a host event that is no operation, such as
    # the profiler's buffer requests, may carry one of them too)
    op_ids = {e.correlation_id() for e in host
              if e.name() == "rtw_tpu_torch::atrous_pass"
              and e.linked_correlation_id() == 0}
    assert len(kernels) == 5 and len(op_ids) == 5, (
        [k.name() for k in kernels], op_ids)
    for k in kernels:
        launch = launches.get(k.correlation_id())
        assert launch is not None, (
            f"{k.name()}: no linked launch (correlation id "
            f"{k.correlation_id()}, linked {k.linked_correlation_id()})")
        assert launch.linked_correlation_id() in op_ids, (
            f"{launch.name()} linked to {launch.linked_correlation_id()}, "
            f"not to an atrous_pass operation {op_ids}")
