"""The correctness check separates: a sound run is correct, the control
and each fault a cell can have are not.

Each case drives the rest of a run on the CPU (the look for the card
skipped) at a size a test run holds, with the program's `render` as it
is or broken underneath:

- `control`: the plain reference computed in bfloat16 in the program's
  place;
- `stale`: a call that returns the previous call's image (its state
  unchanged);
- `half`: half of the batch left out (the samples past the first half,
  the mean taken over the rest; for a 1-sample frame, the second half of
  the pixels, filled from the first);
- `altered`: the image written upside down (row 0 at the top), an
  answer altered where it is produced.

The cells run on one card, so no fault of an exchange between cards
applies.
"""

import dataclasses
import io
import time

import pytest
import torch

import rtw_tpu_torch as rtt

from harness import drive, spec

SMALL = {
    "cornell-1000spp": dict(nx=24, ny=20, spp=6, max_depth=8, scene_id=0),
    "cornell-frame-1spp": dict(nx=24, ny=20, spp=1, max_depth=8,
                               scene_id=0),
    "final-1200x600-20spp": dict(nx=20, ny=10, spp=4, max_depth=6,
                                 scene_id=4),
}


def _control(scene, cfg, seed=None, metrics=None):
    from plainref import config, paths, registry

    rcfg = config.RenderConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
    rscene = registry.build_scene(cfg.scene_id, cfg.nx, cfg.ny,
                                  device="cpu")
    t0 = time.perf_counter()
    img = paths.render_pixels(rscene, rcfg, seed,
                              torch.arange(cfg.nx * cfg.ny),
                              round_to=torch.bfloat16)
    if metrics is not None:
        metrics.update(wall_seconds=time.perf_counter() - t0, rays=0)
    return img.reshape(cfg.ny, cfg.nx, 3)


class _Stale:
    def __init__(self):
        self.last = None

    def __call__(self, scene, cfg, seed=None, metrics=None):
        img = rtt.render(scene, cfg, seed=seed, metrics=metrics)
        out = self.last if self.last is not None else img
        self.last = img
        return out


def _half(scene, cfg, seed=None, metrics=None):
    if cfg.spp >= 2:
        return rtt.render(scene, dataclasses.replace(cfg, spp=cfg.spp // 2),
                          seed=seed, metrics=metrics)
    img = rtt.render(scene, cfg, seed=seed, metrics=metrics).reshape(-1, 3)
    n = img.shape[0]
    img[n - n // 2:] = img[:n // 2]
    return img.reshape(cfg.ny, cfg.nx, 3)


def _altered(scene, cfg, seed=None, metrics=None):
    img = rtt.render(scene, cfg, seed=seed, metrics=metrics)
    return img.flip(0)


FAULTS = {"control": lambda: _control, "stale": _Stale,
          "half": lambda: _half, "altered": lambda: _altered}


def _run(cell, render=None):
    c = spec.load_cell(cell)
    c.traffic = dict(c.traffic, max_calls=3, warmup_calls=1,
                     check=dict(c.traffic["check"], pixels=64))
    return drive.run_cell(c, 2 ** 33 + 17, 0.0, False, time.perf_counter(),
                          device="cpu", render=render, fields=SMALL[cell],
                          log=io.StringIO())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_and_faults_are_not_correct(cell, fault):
    r = _run(cell, FAULTS[fault]())
    assert not r["correct"], (fault, r["checks"])
