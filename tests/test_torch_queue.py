"""The port's work-queue scheduler against rtw_tpu's.

The lanes' pixel layout (`tile_permutation`, which the queue gathers
through) equal to the reference's, with and without partial edge tiles.
Whole queue renders of scenes 1, 2 and 4 (32x24, 4 spp, depth 8) through
the port's plain path against `rtw_tpu.render` with scheduler="queue",
backend="jnp", at flush_denom 0 (flush every iteration) and 2 (the default
deferred flush).  The two draw the same samples and trace the same paths:
ray counts equal, and every pixel within atol/rtol 1e-4 (measured: max abs
diff 3.1e-5 on scene 1, 6.4e-5 on scene 2)."""

import dataclasses

import numpy as np
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu.render import tile_permutation as j_tile_permutation
import rtw_tpu_torch as rtt
from rtw_tpu_torch import integrator as TI
from rtw_tpu_torch.render import tile_permutation

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)


@pytest.mark.parametrize("nx,ny", [(64, 48), (70, 45), (33, 31), (32, 32)])
def test_queue_lane_pixels_match_reference(nx, ny):
    """The queue claims item i's pixel by gathering pixel_idx, which
    render builds from tile_permutation: equal to the reference's lane
    layout, with and without partial edge tiles, and a permutation."""
    perm = tile_permutation(nx, ny)
    np.testing.assert_array_equal(perm, j_tile_permutation(nx, ny))
    np.testing.assert_array_equal(np.sort(perm), np.arange(nx * ny))


@pytest.mark.parametrize("sid", [1, 2, 4])
@pytest.mark.parametrize("flush_denom", [0, 2])
def test_queue_render_matches_reference(sid, flush_denom):
    kw = dict(nx=32, ny=24, spp=4, max_depth=8, scene_id=sid,
              scheduler="queue", backend="jnp", flush_denom=flush_denom)
    mj, mt = {}, {}
    want = np.asarray(rt.render(rt.build_scene(sid, 32, 24),
                                rt.RenderConfig(**kw), metrics=mj))
    got = rtt.render(rtt.build_scene(sid, 32, 24, device="cpu"),
                     rtt.RenderConfig(**kw), metrics=mt).numpy()
    assert np.isfinite(got).all()
    assert mt["rays"] == mj["rays"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_queue_and_regen_draw_the_same_samples():
    """Queue and regen trace the same (pixel, sample) paths: equal ray
    counts, and the image equal up to the queue's order of summation."""
    cfg = rtt.RenderConfig(nx=24, ny=16, spp=3, max_depth=6, scene_id=1)
    scene = rtt.build_scene(1, 24, 16, device="cpu")
    mq, mr = {}, {}
    q = rtt.render(scene, dataclasses.replace(cfg, scheduler="queue"),
                   metrics=mq)
    r = rtt.render(scene, dataclasses.replace(cfg, scheduler="regen"),
                   metrics=mr)
    assert mq["rays"] == mr["rays"]
    torch.testing.assert_close(q, r, rtol=1e-5, atol=1e-6)


def test_split_backend_selection():
    """auto takes the split kernels for a CUDA scene of >= 128 prims only;
    "pallas" on a CPU scene is refused, "jnp" never takes them."""
    cfg = rtt.RenderConfig(nx=8, ny=8, spp=1)
    s1 = rtt.build_scene(1, 8, 8, device="cpu")
    assert not TI._split_backend(cfg, s1)                  # CPU scene
    assert not TI._split_backend(dataclasses.replace(cfg, backend="jnp"), s1)
    with pytest.raises(ValueError, match="pallas"):
        TI._split_backend(dataclasses.replace(cfg, backend="pallas"), s1)
    with pytest.raises(ValueError, match="pallas"):
        rtt.render(s1, dataclasses.replace(cfg, backend="pallas"))
    assert TI._n_prims(s1) == 528 >= TI.SPLIT_TIER_PRIMS
    assert TI._n_prims(rtt.build_scene(0, 8, 8, device="cpu")) == 8
