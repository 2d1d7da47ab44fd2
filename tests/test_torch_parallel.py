"""Sharded rendering of the port (rtw_tpu_torch.parallel.mesh) on spawned
gloo ranks on the CPU, tests/test_parallel.py's cases at its shapes
(scene 5, 40x16, 8 spp, depth 4, regen), and against the reference's
`rtw_tpu.parallel.mesh` on a 2-device CPU mesh on the same inputs.

One job per world size (2, 3 and 4 ranks, started together) runs every
sharded case its tests read (parallel/worker.py); each rank runs one torch
thread.  Pixel sharding must give `render`'s image bit for bit under
regen (each lane adds its samples in a fixed order); sample sharding and
the work queue reassociate per-pixel sums, so they are held within 1e-5.
Against the reference: images within rtol / atol 1e-4
(test_torch_render.py's), the loss within rtol 1e-5 and each gradient
leaf within rtol 1e-3, atol 1e-5 (test_torch_diff.py's)."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu.diff import extract_params as j_extract_params
from rtw_tpu.parallel import mesh as JM
from rtw_tpu.utils import rng as JR
import rtw_tpu_torch as rtt
from rtw_tpu_torch import diff as TD
from rtw_tpu_torch.models import scene as TS
from rtw_tpu_torch.parallel import mesh as TM
from rtw_tpu_torch.parallel import worker
from rtw_tpu_torch.utils import checkpoint as ckpt

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

SMALL = dict(nx=40, ny=16, spp=8, max_depth=4, scene_id=5, scheduler="regen")
GRAD = dict(nx=40, ny=16, spp=2, max_depth=3, scene_id=5,
            differentiable=True)
ODD = dict(GRAD, nx=42, ny=3)       # 126 pixels: divides neither 4 nor 8
CHUNKED = dict(nx=40, ny=16, spp=8, max_depth=4, scene_id=5, spp_chunk=2)
WORLDS = (2, 3, 4)
N_SAMPLES = 2
SEED = 0


def _steps(world, d):
    """The sharded cases of one world size; outputs under folder `d`."""
    out = lambda name: os.path.join(d, name)   # noqa: E731
    steps = [
        {"kind": "render", "cfg": SMALL, "out": out("pixels.npy")},
        {"kind": "render", "cfg": dict(SMALL, scheduler="queue"),
         "out": out("queue.npy")},
        {"kind": "grad", "cfg": GRAD, "n_samples": N_SAMPLES, "seed": SEED,
         "out": out("grad.npz")},
        {"kind": "grad", "cfg": ODD, "n_samples": N_SAMPLES, "seed": SEED,
         "out": out("grad_odd.npz")},
    ]
    if SMALL["spp"] % world == 0:
        steps.append({"kind": "render", "cfg": SMALL, "mode": "samples",
                      "out": out("samples.npy")})
    if world == 4:
        # resume a checkpoint of the first 4 spp (written before the job)
        steps += [{"kind": "render", "cfg": CHUNKED,
                   "out": out("whole.npy")},
                  {"kind": "render", "cfg": CHUNKED,
                   "checkpoint": out("resume.ckpt"),
                   "out": out("resumed.npy")}]
    if world == 2:
        steps.append({"kind": "render", "cfg": CHUNKED,
                      "checkpoint": out("odd.ckpt"), "checkpoint_every": 3})
    return steps


def _half_checkpoint(path):
    """A checkpoint of CHUNKED's first 4 spp under CHUNKED's fingerprint
    (tests/test_parallel.py's "preempted" run): a 4-spp render with the
    same chunks, saved as the 8-spp config's."""
    cfg = rtt.RenderConfig(**CHUNKED)
    half = dataclasses.replace(cfg, spp=4)
    scene = rtt.build_scene(5, cfg.nx, cfg.ny, device="cpu")
    hp = path + ".half"
    TM.render_sharded(scene, half, TM.make_mesh(device="cpu"),
                      checkpoint_path=hp)
    st = ckpt.load(hp, half)
    assert st is not None and st[2] == 4
    ckpt.save(path, cfg, *st)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{world: (folder, each rank's result)}: the three jobs, started
    together."""
    procs = {}
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp(f"world{world}"))
        if world == 4:
            _half_checkpoint(os.path.join(d, "resume.ckpt"))
        procs[world] = (d, worker.spawn(_steps(world, d), world,
                                        device="cpu"))
    return {world: (d, worker.collect(p, timeout=300))
            for world, (d, p) in procs.items()}


def _load(jobs, world, name):
    return np.load(os.path.join(jobs[world][0], name))


def _step(jobs, world, rank, index):
    return jobs[world][1][rank]["steps"][index]


@pytest.fixture(scope="module")
def single():
    """The port's single-process render of SMALL, regen and queue."""
    scene = rtt.build_scene(5, SMALL["nx"], SMALL["ny"], device="cpu")
    cfg = rtt.RenderConfig(**SMALL)
    return (rtt.render(scene, cfg).numpy(),
            rtt.render(scene, dataclasses.replace(cfg, scheduler="queue"))
            .numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_pixel_sharding_bit_identical(jobs, single, world):
    np.testing.assert_array_equal(_load(jobs, world, "pixels.npy"),
                                  single[0])
    for r in jobs[world][1]:
        assert r["backend"] == "gloo" and r["world"] == world
        assert _step(jobs, world, r["rank"], 0)["finite"]


def test_mesh_shape_invariance(jobs):
    img2 = _load(jobs, 2, "pixels.npy")
    for world in WORLDS[1:]:
        np.testing.assert_array_equal(_load(jobs, world, "pixels.npy"),
                                      img2)


@pytest.mark.parametrize("world", (2, 4))
def test_sample_sharding_matches(jobs, single, world):
    np.testing.assert_allclose(_load(jobs, world, "samples.npy"), single[0],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_queue_scheduler_mesh_allclose(jobs, single, world):
    """The work queue's sharded image against the regen render and the
    queue's single-process render: the same samples, sums reassociated in
    claim order."""
    img = _load(jobs, world, "queue.npy")
    for ref in single:
        np.testing.assert_allclose(img, ref, atol=1e-5, rtol=1e-5)


def test_sample_sharding_metrics(jobs):
    for world in (2, 4):
        for rank in range(world):
            m = _step(jobs, world, rank, 4)["metrics"]
            assert m["devices"] == world and m["rays"] > 0
            assert m["paths"] == 40 * 16 * 8
        m = _step(jobs, world, 0, 0)["metrics"]
        assert m["rays"] == _step(jobs, world, 1, 0)["metrics"]["rays"]


def test_samples_mode_raises_when_spp_does_not_divide():
    """spp 8 over 3 ranks: refused before any collective."""
    cfg = rtt.RenderConfig(**SMALL)
    scene = rtt.build_scene(5, cfg.nx, cfg.ny, device="cpu")
    mesh = dataclasses.replace(TM.make_mesh(device="cpu"), world=3)
    with pytest.raises(ValueError, match="not divisible by 3"):
        TM.render_sharded(scene, cfg, mesh, mode="samples")


def _leaves_np(grads):
    return [g.numpy() for g in TD._leaves(grads)]


def _grad_single(kw):
    """grad_sharded on one rank (no process group) and
    diff.make_loss_and_grad on the same pixels."""
    cfg = rtt.RenderConfig(**kw)
    scene = rtt.build_scene(5, cfg.nx, cfg.ny, device="cpu")
    params = TD.extract_params(scene)
    target = torch.zeros((cfg.ny, cfg.nx, 3))
    one = TM.grad_sharded(scene, cfg, TM.make_mesh(device="cpu"), params,
                          target, SEED, N_SAMPLES)
    direct = TD.make_loss_and_grad(scene, cfg, N_SAMPLES)(
        params, target.reshape(-1, 3), torch.arange(cfg.num_pixels), SEED)
    return one, direct


@pytest.fixture(scope="module")
def grad_single():
    return {"grad": _grad_single(GRAD), "grad_odd": _grad_single(ODD)}


@pytest.mark.parametrize("name", ["grad", "grad_odd"])
def test_grad_sharded_one_rank_matches_make_loss_and_grad(grad_single,
                                                          name):
    (l1, g1), (ld, gd) = grad_single[name]
    np.testing.assert_allclose(float(l1), float(ld), rtol=1e-5)
    for a, b in zip(_leaves_np(g1), _leaves_np(gd)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["grad", "grad_odd"])
def test_grad_sharded_matches_single_rank(jobs, grad_single, world, name):
    """The all-reduced loss and leaves of `world` ranks against one rank's
    (the odd pixel count: padded lanes carry weight 0)."""
    (l1, g1), _ = grad_single[name]
    with np.load(os.path.join(jobs[world][0], f"{name}.npz")) as z:
        np.testing.assert_allclose(float(z["loss"]), float(l1), rtol=1e-5)
        for i, a in enumerate(_leaves_np(g1)):
            np.testing.assert_allclose(z[f"g{i}"], a, atol=1e-6, rtol=1e-4)
    index = 2 if name == "grad" else 3
    losses = {_step(jobs, world, r, index)["loss"] for r in range(world)}
    assert len(losses) == 1                # every rank holds the sum


def test_sharded_checkpoint_resume(jobs):
    """Resuming 4 ranks from a checkpoint of the first 4 spp gives the
    bit-exact image of an uninterrupted sharded run, tracing only the
    remaining samples."""
    np.testing.assert_array_equal(_load(jobs, 4, "resumed.npy"),
                                  _load(jobs, 4, "whole.npy"))
    m = _step(jobs, 4, 0, 6)["metrics"]
    assert m["paths"] == 40 * 16 * 4
    assert _step(jobs, 4, 0, 6)["saves"] == [6, 8]


def test_checkpoint_every_non_divisible(jobs):
    """checkpoint_every=3 over chunks of 2: rank 0 saves at 4 and at the
    end (>= 3 samples since the last save, not an exact multiple); the
    other ranks enter the gathers and write nothing."""
    assert _step(jobs, 2, 0, 5)["saves"] == [4, 8]
    assert _step(jobs, 2, 1, 5)["saves"] == []
    st = ckpt.load(os.path.join(jobs[2][0], "odd.ckpt"),
                   rtt.RenderConfig(**CHUNKED))
    assert st is not None and st[2] == 8


# ---------------------------------------------------- against the reference


@pytest.fixture(scope="module")
def reference_images():
    cfg = rt.RenderConfig(**SMALL)
    scene = rt.build_scene(5, cfg.nx, cfg.ny)
    mesh = JM.make_mesh(jax.devices()[:2])
    return {mode: np.asarray(JM.render_sharded(scene, cfg, mesh,
                                               mode=mode))
            for mode in ("pixels", "samples")}


@pytest.mark.parametrize("mode", ["pixels", "samples"])
def test_two_rank_images_match_reference(jobs, reference_images, mode):
    np.testing.assert_allclose(_load(jobs, 2, f"{mode}.npy"),
                               reference_images[mode], rtol=1e-4, atol=1e-4)


def test_grad_sharded_matches_reference(jobs):
    """The two-rank loss and gradient against the reference's
    grad_sharded on a 2-device mesh (key = base_key(SEED))."""
    cfg = rt.RenderConfig(**GRAD)
    scene = rt.build_scene(5, cfg.nx, cfg.ny)
    params = j_extract_params(scene)
    target = np.zeros((cfg.ny, cfg.nx, 3), np.float32)
    loss, grads = JM.grad_sharded(scene, cfg,
                                  JM.make_mesh(jax.devices()[:2]), params,
                                  target, JR.base_key(SEED), N_SAMPLES)
    want = [grads["tex_color"]] + [getattr(grads["camera"], f.name)
                                   for f in dataclasses.fields(TS.Camera)]
    with np.load(os.path.join(jobs[2][0], "grad.npz")) as z:
        np.testing.assert_allclose(float(z["loss"]), float(loss), rtol=1e-5)
        for i, w in enumerate(want):
            g = z[f"g{i}"]
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3,
                                       atol=1e-5)
