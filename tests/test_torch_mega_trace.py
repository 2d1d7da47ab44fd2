"""The persistent megakernel's schedule, held on its plain twin.

`mega_trace` renders each lane's whole path in one thread of one launch:
a thread steps its lane until the lane has run all its samples, writes the
lane's radiance and pulls the next lane index.  Its plain twin
`mega_trace_plain` is held here against the per-iteration loop it replaces
(init_carry, `mega_step_plain` launches, a termination read every 8) and
against an emulation of the pull schedule; that lanes are independent (a
permuted order or a split into two calls gives the same sums, bit for
bit) is what lets the kernel hand lanes to threads in any order.  The
reference side: `test_torch_mega.py` holds `trace_wavefront_mega` against
rtw_tpu's regen scheduler and the plain step against the Pallas kernel.
The CUDA kernel itself is held against the per-iteration kernel loop, bit
for bit, by chip_smoke.py on the card."""

import numpy as np
import pytest
import torch

import rtw_tpu_torch as rtt
from rtw_tpu_torch import integrator as TI
from rtw_tpu_torch.ops import mega_kernel as TMK
from rtw_tpu_torch.utils import kernels

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

NX, NY = 48, 24           # tests/test_mega.py's configuration


def _cfg(sid):
    return rtt.RenderConfig(nx=NX, ny=NY, spp=3, max_depth=6, scene_id=sid,
                            seed=9)


def _setup(sid, s0=0):
    cfg = _cfg(sid)
    scene = rtt.build_scene(sid, NX, NY, device="cpu")
    params = TMK.mega_params(scene, cfg.seed, cfg, s0 + cfg.spp, s0)
    return cfg, scene, params


def _loop(scene, cfg, pixel_idx, params):
    """The per-iteration design as trace_wavefront_mega drove it: from
    init_carry, 8 steps between termination reads.  Returns (acc [3, N],
    rays)."""
    sf, si = TMK.init_carry(pixel_idx, params.s0)
    rays = torch.zeros(1, dtype=torch.int64)
    while True:
        for _ in range(8):
            sf, si = TMK.mega_step_plain(scene, cfg, sf, si, params, rays)
        busy = (si[TMK.I_ALIVE] > 0) | (si[TMK.I_SAMPLE] < params.s_end)
        if not bool(busy.any()):
            return sf[TMK.F_ACC:TMK.F_ACC + 3], int(rays)


def _trace(scene, cfg, pixel_idx, params):
    rays = torch.zeros(1, dtype=torch.int64)
    acc = TMK.mega_trace(scene, cfg, pixel_idx, params, rays)
    return acc, int(rays)


@pytest.mark.parametrize("sid", [0, 3, 5])
def test_mega_trace_plain_equals_the_iteration_loop(sid):
    cfg, scene, params = _setup(sid)
    pix = torch.arange(cfg.num_pixels, dtype=torch.int32)
    want, want_rays = _loop(scene, cfg, pix, params)
    got, rays = _trace(scene, cfg, pix, params)
    assert got.shape == (3, cfg.num_pixels) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert rays == want_rays
    assert float(got.sum()) > 0.0


def test_mega_trace_plain_starts_at_s0():
    """A later spp chunk: samples [2, 5) of each lane equal the loop's."""
    cfg, scene, params = _setup(0, s0=2)
    pix = torch.arange(cfg.num_pixels, dtype=torch.int32)
    want, want_rays = _loop(scene, cfg, pix, params)
    got, rays = _trace(scene, cfg, pix, params)
    assert torch.equal(got, want) and rays == want_rays


@pytest.mark.parametrize("order", ["permuted", "split"])
def test_lanes_are_independent(order):
    """A lane's sums depend on its pixel only: the lanes in a permuted
    order, or in two calls, give the whole call's sums bit for bit."""
    cfg, scene, params = _setup(0)
    n = cfg.num_pixels
    pix = torch.as_tensor(np.random.default_rng(3).permutation(n)
                          .astype(np.int32))
    want, want_rays = _trace(scene, cfg, pix, params)
    if order == "permuted":
        perm = torch.as_tensor(np.random.default_rng(4).permutation(n))
        got, rays = _trace(scene, cfg, pix[perm], params)
        assert torch.equal(got, want[:, perm])
    else:
        cut = 437
        a, ra = _trace(scene, cfg, pix[:cut], params)
        b, rb = _trace(scene, cfg, pix[cut:], params)
        got, rays = torch.cat([a, b], dim=1), ra + rb
        assert torch.equal(got, want)
    assert rays == want_rays


def test_pull_schedule_emulation():
    """The kernel's schedule, emulated: 5 "threads" over 37 lanes, thread g
    starting on lane g.  Each step advances every thread's lane by one
    `mega_step_plain`; a thread whose lane has run all its samples writes
    the lane's sums and takes the next index from a counter (an idle
    thread holds a finished lane, which a step does not change but for its
    depth).  The sums and the rays equal one call over the 37 lanes."""
    cfg, scene, params = _setup(5)
    lanes = torch.as_tensor(np.random.default_rng(7).choice(
        cfg.num_pixels, 37, replace=False).astype(np.int32))
    n_threads = 5
    want, want_rays = _trace(scene, cfg, lanes, params)

    sf, si = TMK.init_carry(lanes[:n_threads], params.s0)
    owner = list(range(n_threads))        # the lane each thread holds
    counter = n_threads
    out = torch.full((3, lanes.shape[0]), float("nan"))
    rays = torch.zeros(1, dtype=torch.int64)
    while any(i is not None for i in owner):
        for g in range(n_threads):
            done = (int(si[TMK.I_ALIVE, g]) == 0
                    and int(si[TMK.I_SAMPLE, g]) >= params.s_end)
            if owner[g] is None or not done:
                continue
            out[:, owner[g]] = sf[TMK.F_ACC:TMK.F_ACC + 3, g]
            owner[g] = counter if counter < lanes.shape[0] else None
            counter += 1
            if owner[g] is not None:
                f, i = TMK.init_carry(lanes[owner[g]:owner[g] + 1],
                                      params.s0)
                sf[:, g], si[:, g] = f[:, 0], i[:, 0]
        sf, si = TMK.mega_step_plain(scene, cfg, sf, si, params, rays)
    assert torch.equal(out, want)
    assert int(rays) == want_rays


def test_trace_wavefront_mega_on_cpu_launches_nothing():
    cfg, scene, _ = _setup(0)
    before = dict(kernels.launches)
    acc, rays, stats = TI.trace_wavefront_mega(
        scene, cfg, torch.arange(cfg.num_pixels), cfg.seed, 0, cfg.spp)
    assert dict(kernels.launches) == before
    assert acc.x.shape == (cfg.num_pixels,) and stats == ()
    assert int(rays) > cfg.num_pixels * cfg.spp


def test_mega_trace_checks_its_inputs():
    cfg, scene, params = _setup(0)
    """A non-CPU tensor goes to the launch path, whose checks run before
    the library is built: the meta device stands in for the card."""
    pix = torch.arange(64, dtype=torch.int32, device="meta")
    rays = torch.zeros(1, dtype=torch.int64, device="meta")
    with pytest.raises(TypeError, match="pixel_idx"):
        TMK.mega_trace(scene, cfg, pix.long(), params, rays)
    with pytest.raises(ValueError, match="pixel_idx"):
        TMK.mega_trace(scene, cfg, torch.arange(
            128, dtype=torch.int32, device="meta")[::2], params, rays)
    with pytest.raises(ValueError, match="rays"):
        TMK.mega_trace(scene, cfg, pix, params,
                       torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="tables are on cpu"):
        TMK.mega_trace(scene, cfg, pix, params, rays)
