"""Multi-process rendering of the port: tests/test_distributed.py's three
jobs on local gloo ranks started by rtw_tpu_torch.parallel.worker (one
torch thread each).  Scene 5, 32x24, depth 6, the plain regen sweep,
pixel-sharded over 2 and over 4 ranks, must give the single-process
render bit for bit: every draw is keyed by (pixel, sample), so the rank
layout cannot change the estimator.  The third job is stopped by SIGKILL
once its first checkpoint exists and relaunched with the same arguments:
it resumes and ends bit-exact to an uninterrupted render."""

import os
import signal
import time

import numpy as np
import pytest
import torch

import rtw_tpu_torch as rtt
from rtw_tpu_torch.parallel import worker
from rtw_tpu_torch.utils import checkpoint as ckpt

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)


def _cfg(spp=4, spp_chunk=0):
    return dict(nx=32, ny=24, spp=spp, max_depth=6, scene_id=5,
                backend="jnp", scheduler="regen", spp_chunk=spp_chunk)


def _single_image(**kw):
    cfg = rtt.RenderConfig(**_cfg(**kw))
    return rtt.render(rtt.build_scene(5, cfg.nx, cfg.ny, device="cpu"),
                      cfg).numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_rank_render_matches_single(tmp_path, world):
    out = str(tmp_path / "img.npy")
    res = worker.launch([{"kind": "render", "cfg": _cfg(), "out": out}],
                        world, device="cpu", timeout=300)
    assert [r["rank"] for r in res] == list(range(world))
    assert all(r["world"] == world and r["backend"] == "gloo" for r in res)
    np.testing.assert_array_equal(np.load(out), _single_image())


def test_preempt_resume_bitexact(tmp_path):
    """SIGKILL rank 1 of a checkpointing 2-rank render the moment its first
    checkpoint lands (rank 0 pauses after each save, so the job cannot end
    first), and rank 0 at once (a gloo peer of a dead rank would wait in its
    next collective until the timeout); relaunch the job with the same
    arguments: it resumes from the checkpoint and ends bit-exact to an
    uninterrupted single-process render."""
    out = str(tmp_path / "img.npy")
    path = str(tmp_path / "ckpt.npz")
    spp = 8          # spp_chunk=1: 8 chunks, a checkpoint after each
    step = {"kind": "render", "cfg": _cfg(spp, 1), "out": out,
            "checkpoint": path, "checkpoint_every": 1}
    procs = worker.spawn([dict(step, pause_after_save=2.0)], 2,
                         device="cpu")
    deadline = time.time() + 120
    while not os.path.exists(path) and time.time() < deadline:
        assert all(p.poll() is None for p, _ in procs), "a rank died"
        time.sleep(0.02)
    preempted = all(p.poll() is None for p, _ in procs)
    procs[1][0].send_signal(signal.SIGKILL)
    worker.stop(procs)
    assert preempted, "the job ended before it could be preempted"
    assert not os.path.exists(out), "the preempted job wrote an image"
    state = ckpt.load(path, rtt.RenderConfig(**_cfg(spp, 1)))
    assert state is not None and 1 <= state[2] < spp

    res = worker.launch([step], 2, device="cpu", timeout=300)
    resumed = res[0]["steps"][0]
    assert resumed["metrics"]["paths"] == 32 * 24 * (spp - state[2])
    assert resumed["saves"] == list(range(state[2] + 1, spp + 1))
    np.testing.assert_array_equal(np.load(out),
                                  _single_image(spp=spp, spp_chunk=1))
