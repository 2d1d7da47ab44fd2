"""The work queue's regeneration kernel R (`ops/shade_kernel.regen`,
csrc/shade_kernel.cu::regen_kernel) on the card, against the torch merge it
replaces (`integrator._regenerate`) on the same card.  Marked `cuda`: each
test skips without a card, and the file imports nothing of JAX, so that it
runs on the machine with the card:

    python3 -m pytest --noconftest -q tests/test_torch_regen_cuda.py

- R against the torch merge at a carry of random planes on scenes 1, 2
  (thin lens) and 4 (shutter, moving sphere, volumes), framed with the
  book's apertures, over 5,141 lanes (not a multiple of the 256-thread
  block): the queue's launch with `have` / `pend` empty, full, random and
  disjoint, and the regen scheduler's launch, bit-equal on every plane.
- A scene-4 queue render and a scene-1 regen render through R, bit-equal
  (image and rays) to the same renders with the torch merge forced;
  `kernels.launches["rtw_regen"]` is one a queue iteration plus one a
  call.  The renders run under torch's deterministic algorithms: the
  queue's flush adds two lanes' samples into one accumulator column
  (`index_add_`) with float atomics in an order of the card's choosing
  otherwise, so two queue renders differ in the last bits of a few pixels
  whatever merges them.
"""

import dataclasses

import pytest
import torch

import chip_smoke as CS
import rtw_tpu_torch as rtt
from rtw_tpu_torch import integrator as TI
from rtw_tpu_torch.ops import shade_kernel as SK
from rtw_tpu_torch.utils import kernels

pytestmark = pytest.mark.cuda

NX, NY = 97, 53
SEED = 2**33 + 7


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("sid", [1, 2, 4])
@pytest.mark.parametrize("masks", CS.REGEN_MASKS)
def test_kernel_equals_the_torch_merge(card, sid, masks):
    scene = rtt.build_scene(sid, NX, NY, dof="book")
    assert float(scene.camera.lens_radius) > 0
    cfg = rtt.RenderConfig(nx=NX, ny=NY, spp=4, scene_id=sid)
    rp = SK.regen_params(scene, cfg, SEED)
    c = CS.regen_carry(cfg, NX * NY, masks, seed=sid)
    kinds = (True, False) if masks != "disjoint" else (True,)
    for queue in kinds:
        got = CS.regen_launch(rp, c, queue)
        want = CS.regen_plain(scene, cfg, SEED, c, queue)
        assert CS.regen_mismatch(got, want) == [], (sid, masks, queue)


def _render(sid, cfg, plain):
    """(image, metrics, R launches, {"steps": bounce steps, "calls":
    scheduler calls}) of a render after a warm-up; `plain`: the torch merge
    forced."""
    counts = {"steps": 0, "calls": 0}
    real_step, real_first = TI.bounce_step, TI._first_paths

    def step(*a, **k):
        counts["steps"] += 1
        return real_step(*a, **k)

    def first(*a, **k):
        counts["calls"] += 1
        return real_first(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        if plain:
            mp.setattr(TI, "_regen_kernel", lambda cfg, device: False)
        scene = rtt.build_scene(sid, cfg.nx, cfg.ny, dof="book")
        rtt.render(scene, cfg)
        mp.setattr(TI, "bounce_step", step)
        mp.setattr(TI, "_first_paths", first)
        kernels.launches.clear()
        m = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            img = rtt.render(scene, cfg, metrics=m)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return img, m, kernels.launches["rtw_regen"], counts


@pytest.mark.parametrize("sid,sched", [(4, "queue"), (1, "regen")])
def test_render_through_the_kernel_equals_the_torch_merge(card, sid, sched):
    cfg = rtt.RenderConfig(nx=96, ny=48, spp=4, max_depth=20, scene_id=sid,
                           scheduler=sched)
    img_p, m_p, launched_p, _ = _render(sid, cfg, True)
    img_k, m_k, launched_k, counts = _render(sid, cfg, False)
    assert launched_p == 0
    assert counts["calls"] == 1
    assert launched_k == counts["steps"] + counts["calls"]
    assert m_k["rays"] == m_p["rays"]
    assert torch.equal(img_k.view(torch.int32), img_p.view(torch.int32))


def test_gradient_and_other_streams_keep_the_torch_merge(card):
    """tea, threefry and a differentiable render regenerate in torch on the
    card: no R launch."""
    scene = rtt.build_scene(4, 48, 24)
    for opts in ({"rng": "tea"}, {"rng": "threefry"},
                 {"differentiable": True}):
        cfg = dataclasses.replace(
            rtt.RenderConfig(nx=48, ny=24, spp=2, max_depth=6, scene_id=4,
                             scheduler="queue"), **opts)
        kernels.launches.clear()
        with torch.no_grad():
            rtt.render(scene, cfg)
        assert kernels.launches["rtw_regen"] == 0, opts
