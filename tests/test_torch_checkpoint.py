"""Checkpoint and resume (rtw_tpu_torch/utils/checkpoint.py and render's
resume loop) against rtw_tpu's semantics: a render stopped after a save
and resumed is bit-equal to an uninterrupted one, with equal rays; a file
saved for another config is ignored; `paths` counts only the samples
rendered after the resume; the fingerprint is the reference's."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu.utils import checkpoint as JC
import rtw_tpu_torch as rtt
from rtw_tpu_torch.utils import checkpoint as TC

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)


class _Stopped(Exception):
    pass


def _stop_after(monkeypatch, n_saves):
    """Make the render raise right after its n-th save, as a preempted
    render would stop; returns the list of samples done at each save."""
    done = []
    real = TC.save

    def save(path, cfg, accum, rays, spp_done):
        real(path, cfg, accum, rays, spp_done)
        done.append(spp_done)
        if len(done) == n_saves:
            raise _Stopped
    monkeypatch.setattr(TC, "save", save)
    return done


@pytest.mark.parametrize("sid,scheduler", [(5, "regen"), (1, "queue")])
def test_resumed_render_is_bit_equal(sid, scheduler, tmp_path, monkeypatch):
    """Scene 5 on regen and scene 1 on the queue, 16x16, 6 spp in chunks
    of 2, a save every 2 samples, stopped after the first save."""
    ts = rtt.build_scene(sid, 16, 16, device="cpu")
    cfg = rtt.RenderConfig(nx=16, ny=16, spp=6, max_depth=8, scene_id=sid,
                           scheduler=scheduler, spp_chunk=2)
    m_full = {}
    full = rtt.render(ts, cfg, metrics=m_full,
                      checkpoint_path=str(tmp_path / "full.npz"),
                      checkpoint_every=2)

    path = str(tmp_path / "stopped.npz")
    done = _stop_after(monkeypatch, 1)
    with pytest.raises(_Stopped):
        rtt.render(ts, cfg, checkpoint_path=path, checkpoint_every=2)
    assert done == [2] and os.path.exists(path)
    monkeypatch.undo()

    m = {}
    resumed = rtt.render(ts, cfg, metrics=m, checkpoint_path=path,
                         checkpoint_every=2)
    assert torch.equal(resumed, full)
    assert m["rays"] == m_full["rays"]
    assert m["paths"] == 16 * 16 * (6 - 2)
    assert m_full["paths"] == 16 * 16 * 6
    # the finished file holds the whole render
    acc, rays, spp_done = TC.load(path, cfg)
    assert spp_done == 6 and rays == m["rays"]
    assert not os.path.exists(path + ".tmp.npz")


def test_checkpoint_of_another_config_is_ignored(tmp_path):
    ts = rtt.build_scene(5, 16, 16, device="cpu")
    cfg = rtt.RenderConfig(nx=16, ny=16, spp=4, max_depth=8, scene_id=5,
                           spp_chunk=2)
    path = str(tmp_path / "c.npz")
    rtt.render(ts, dataclasses.replace(cfg, seed=3), checkpoint_path=path)
    assert TC.load(path, cfg) is None
    m, m_fresh = {}, {}
    img = rtt.render(ts, cfg, metrics=m, checkpoint_path=path)
    fresh = rtt.render(ts, cfg, metrics=m_fresh)
    assert torch.equal(img, fresh)
    assert m["rays"] == m_fresh["rays"] and m["paths"] == 16 * 16 * 4
    assert TC.load(path, cfg)[2] == 4     # now saved for this config


@pytest.mark.parametrize("every,want", [(0, [2, 4, 6, 7]), (3, [4, 7]),
                                        (2, [2, 4, 6, 7])])
def test_saves_follow_the_reference_rule(every, want, tmp_path,
                                         monkeypatch):
    """A save whenever at least `checkpoint_every` samples accrued since
    the last one (every chunk when 0) and at the end: 7 spp in chunks of
    2."""
    ts = rtt.build_scene(5, 8, 8, device="cpu")
    cfg = rtt.RenderConfig(nx=8, ny=8, spp=7, max_depth=4, scene_id=5,
                           spp_chunk=2)
    done = _stop_after(monkeypatch, 0)
    rtt.render(ts, cfg, checkpoint_path=str(tmp_path / "c.npz"),
               checkpoint_every=every)
    assert done == want


def test_fingerprint_and_file_match_the_reference(tmp_path):
    """The same config fingerprints alike in both packages, and a file the
    port saved loads in the reference (rays as a float there)."""
    cfg = rtt.RenderConfig(nx=8, ny=4, spp=3, rng="tea", estimator="book",
                           bounce_stats=True)
    jcfg = rt.RenderConfig(**dataclasses.asdict(cfg))
    assert TC._fingerprint(cfg) == JC._fingerprint(jcfg)
    acc = np.random.default_rng(0).random((32, 3)).astype(np.float32)
    path = str(tmp_path / "c.npz")
    TC.save(path, cfg, acc, 2 ** 40 + 1, 2)
    got = TC.load(path, cfg)
    np.testing.assert_array_equal(got[0], acc)
    assert got[1:] == (2 ** 40 + 1, 2)
    j_acc, j_rays, j_done = JC.load(path, jcfg)
    np.testing.assert_array_equal(j_acc, acc)
    assert (j_rays, j_done) == (float(2 ** 40 + 1), 2)
    assert TC.load(str(tmp_path / "absent.npz"), cfg) is None
