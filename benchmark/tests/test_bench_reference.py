"""The frozen plain reference against the committed goldens, and the work
counts independent of the program's tables."""

import ast
import os

import numpy as np
import pytest
import torch

from plainref import config, paths, registry

from conftest import BENCH_DIR, ROOT

# the goldens' render: tests/test_goldens.py's CFG
GOLDEN = dict(nx=64, ny=48, spp=32, max_depth=10, seed=0)


def _golden(sid):
    with np.load(os.path.join(ROOT, "tests", "goldens",
                              f"scene{sid}.npz")) as z:
        return z["img"].reshape(-1, 3)


@pytest.mark.parametrize("sid", [0, 4])
def test_pixels_match_the_goldens(sid):
    """48 pixels drawn from a seed, rendered by the reference at the
    goldens' configuration: each within the goldens' 1e-4."""
    cfg = config.RenderConfig(scene_id=sid, **GOLDEN)
    scene = registry.build_scene(sid, cfg.nx, cfg.ny, device="cpu")
    pix = torch.as_tensor(np.random.default_rng(7).choice(
        cfg.nx * cfg.ny, 48, replace=False), dtype=torch.int64)
    got = paths.render_pixels(scene, cfg, cfg.seed, pix).numpy()
    np.testing.assert_allclose(got, _golden(sid)[pix.numpy()], rtol=1e-4,
                               atol=1e-4)


def test_bf16_control_departs_from_the_goldens():
    """The control (state rounded to bfloat16) traces other paths."""
    cfg = config.RenderConfig(scene_id=0, **GOLDEN)
    scene = registry.build_scene(0, cfg.nx, cfg.ny, device="cpu")
    pix = torch.arange(0, cfg.nx * cfg.ny, 97, dtype=torch.int64)
    got = paths.render_pixels(scene, cfg, cfg.seed, pix,
                              round_to=torch.bfloat16).numpy()
    ref = _golden(0)[pix.numpy()]
    assert np.abs(got - ref).sum() / np.abs(ref).sum() > 0.05


def _counts_and_bounds():
    from harness import work

    cfg = config.RenderConfig(nx=40, ny=30, spp=4, max_depth=8, scene_id=4)
    scene = registry.build_scene(4, cfg.nx, cfg.ny, device="cpu")
    counts = paths.Counts("cpu")
    paths.render_pixels(scene, cfg, 123, torch.arange(0, 1200, 7),
                        counts=counts)
    c = counts.as_dict()
    w = work.scaled(c, 1200 * 20)
    return c, work.render_bound_s(w, 1200, 1), work.query_bound_s(
        w, scene.n_vol)


def test_work_counts_ignore_the_programs_tables(monkeypatch):
    """The counts and bounds are the same with the program's scene
    builder and split tables broken: nothing in them reads the program."""
    first = _counts_and_bounds()
    import rtw_tpu_torch.models.builder as PB
    import rtw_tpu_torch.ops.trace_kernel as TK

    def broken(*a, **k):
        raise AssertionError("the work counts read the program")
    monkeypatch.setattr(TK, "split_tables", broken)
    monkeypatch.setattr(PB.SceneBuilder, "build", broken)
    second = _counts_and_bounds()
    assert first == second
    c, mega, query = first
    assert c["paths"] == len(range(0, 1200, 7)) * 4
    assert c["traced"] >= c["paths"] and sum(c["hits_by_prim"]) > 0
    assert mega > 0 and query > 0


def test_benchmark_imports_nothing_of_the_program_outside_the_harness():
    """No module of plainref imports the program or the JAX package; the
    metric readers and work counts import neither."""
    bad = ("rtw_tpu", "rtw_tpu_torch", "jax", "jaxlib", "flax")
    for sub in ("plainref", "metrics"):
        d = os.path.join(BENCH_DIR, sub)
        for name in os.listdir(d):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(d, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                for m in mods:
                    assert m.split(".")[0] not in bad, (sub, name, m)


@pytest.mark.parametrize("stream", ["fast", "tea", "threefry"])
def test_per_lane_seeds_draw_each_seeds_stream(stream):
    """Lanes of several renders traced together draw what each render's
    own seed draws."""
    cfg = config.RenderConfig(rng=stream)
    seeds = [2 ** 40 + 3, 5, 2 ** 33 + 1]
    pix = torch.arange(30, dtype=torch.int64) * 977
    smp = torch.arange(30, dtype=torch.int64) % 7
    lane_seed = torch.tensor(seeds, dtype=torch.int64).repeat_interleave(10)
    got = paths.path_keys(cfg, lane_seed, pix, smp)
    for i, s in enumerate(seeds):
        sl = slice(10 * i, 10 * i + 10)
        want = paths.path_keys(cfg, s, pix[sl], smp[sl])
        assert torch.equal(got[..., sl], want)
