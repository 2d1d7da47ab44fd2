"""The work queue's regeneration kernel R (`ops/shade_kernel.regen`) on the
CPU, where it never runs (tests/test_torch_regen_cuda.py holds it against
`integrator._regenerate` on the card):

- the choice, made once a render: R on CUDA tensors, the fast stream and
  off the gradient path; CPU tensors, "tea", "threefry" and
  `differentiable` regenerate in torch (`_regenerate`);
- both schedulers on the CPU regenerate through `_regenerate` and launch
  no R;
- the wrapper refuses CPU tensors, and mis-typed, mis-shaped, strided or
  misplaced planes, naming the plane, before anything is built (the meta
  device stands in for the card);
- R's parameters are the camera's, scaled as `generate_camera_rays`
  scales them, and its source's structs are the wrapper's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import rtw_tpu_torch as rtt
from rtw_tpu_torch import integrator as TI
from rtw_tpu_torch.ops import shade_kernel as SK
from rtw_tpu_torch.ops.bounce import PathState
from rtw_tpu_torch.ops.vec import Vec3
from rtw_tpu_torch.utils import kernels
from rtw_tpu_torch.utils import rng as R

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "rtw_tpu_torch" / "csrc"
SRC = (CSRC / "shade_kernel.cu").read_text()
CUDA = torch.device("cuda")
CPU = torch.device("cpu")


@pytest.mark.parametrize("device,opts,want", [
    (CUDA, {}, True),
    (CPU, {}, False),
    (CUDA, {"rng": "tea"}, False),
    (CUDA, {"rng": "threefry"}, False),
    (CUDA, {"differentiable": True}, False),
], ids=["cuda-fast", "cpu", "tea", "threefry", "differentiable"])
def test_the_choice_of_r(device, opts, want):
    cfg = rtt.RenderConfig(nx=8, ny=8, spp=1, **opts)
    assert TI._regen_kernel(cfg, device) is want


@pytest.mark.parametrize("sched", ["queue", "regen"])
def test_cpu_schedulers_regenerate_in_torch(sched, monkeypatch):
    """A CPU render merges through `_regenerate` every iteration, launches
    no R and builds no R parameters."""
    def refuse(*a, **k):
        raise AssertionError("R reached from a CPU render")
    calls = []
    real = TI._regenerate

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(SK, "regen", refuse)
    monkeypatch.setattr(SK, "regen_params", refuse)
    monkeypatch.setattr(TI, "_regenerate", counted)
    kernels.launches.clear()
    cfg = rtt.RenderConfig(nx=12, ny=8, spp=2, max_depth=4, scene_id=1,
                           scheduler=sched)
    img = rtt.render(rtt.build_scene(1, 12, 8, device="cpu"), cfg)
    assert bool(torch.isfinite(img).all())
    assert len(calls) > 0
    assert kernels.launches["rtw_regen"] == 0


N = 37


def _carry(device="meta"):
    """Planes of R's launch on `device`: (claim, reset, state, keys, depth,
    sample, pixel, pending)."""
    def f():
        return torch.zeros(N, dtype=torch.float32, device=device)

    def b():
        return torch.zeros(N, dtype=torch.bool, device=device)

    def i():
        return torch.zeros(N, dtype=torch.int64, device=device)
    state = PathState(origin=Vec3(f(), f(), f()),
                      direction=Vec3(f(), f(), f()),
                      throughput=Vec3(f(), f(), f()),
                      radiance=Vec3(f(), f(), f()), alive=b(), time=f(),
                      prev_pdf=f(), prev_diffuse=b())
    return dict(claim=b(), reset=b(), state=state, keys=i(), depth=i(),
                sample=i(), pixel=i(), pending=b())


def _launch(c):
    SK.regen(SK._CRegenParams(), c["claim"], c["reset"], c["state"],
             c["keys"], c["depth"], c["sample"], c["pixel"], c["pending"])


def test_wrapper_refuses_cpu_tensors():
    """The wrapper only launches: CPU tensors are refused, nothing is built
    or counted."""
    kernels.launches.clear()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _launch(_carry("cpu"))
    assert kernels.launches["rtw_regen"] == 0
    assert SK.LIB._dll is None


def _wide():
    return torch.empty((N, 2), device="meta")[:, 0]


# (fault, the carry's change, exception, the plane named)
FAULTS = [
    ("dtype", lambda c: dict(c, depth=c["depth"].int()), TypeError, "depth"),
    ("float_dtype", lambda c: dict(c, state=c["state"]._replace(
        time=c["state"].time.double())), TypeError, "time"),
    ("shape", lambda c: dict(c, keys=c["keys"][1:]), ValueError, "keys"),
    ("strides", lambda c: dict(c, state=c["state"]._replace(
        radiance=Vec3(_wide(), *c["state"].radiance[1:]))), ValueError,
     "radiance.x"),
    ("device", lambda c: dict(c, pixel=torch.zeros(N, dtype=torch.int64)),
     ValueError, "pixel"),
    ("bool_mask", lambda c: dict(c, claim=c["claim"].to(torch.uint8)),
     TypeError, "claim"),
    ("pending", lambda c: dict(c, pending=c["pending"][:-1]), ValueError,
     "pending"),
]


@pytest.mark.parametrize("fault,change,err,plane", FAULTS,
                         ids=[f[0] for f in FAULTS])
def test_wrapper_refuses_bad_planes_naming_them(fault, change, err, plane):
    kernels.launches.clear()
    with pytest.raises(err, match=rf"^regen: {re.escape(plane)} "):
        _launch(change(_carry()))
    assert kernels.launches["rtw_regen"] == 0


def test_good_planes_reach_the_launch():
    """Planes that pass every check go on to the launch, which refuses a
    device that is not a card."""
    with pytest.raises(ValueError, match="rtw_regen: the kernel runs on "
                                         "CUDA tensors, not meta"):
        _launch(_carry())


@pytest.mark.parametrize("sid,nx,ny", [(1, 97, 53), (2, 1200, 600),
                                       (4, 40, 20)])
def test_regen_params_are_the_cameras(sid, nx, ny):
    """R's parameters: the camera's rows, `horizontal` and `vertical` times
    the f32 reciprocals of nx and ny in f32, the shutter t0 and t1 - t0 in
    f32, h0 of the seed, nx."""
    scene = rtt.build_scene(sid, nx, ny, device="cpu", dof="book")
    cfg = rtt.RenderConfig(nx=nx, ny=ny, spp=1, scene_id=sid)
    seed = 2**34 + 99
    p = SK.regen_params(scene, cfg, seed)
    cam = scene.camera
    f32 = np.float32

    def row(t):
        return np.asarray(t, dtype=f32)
    for field, want in (("org", cam.origin), ("cam_u", cam.u),
                        ("cam_v", cam.v), ("ll", cam.lower_left)):
        np.testing.assert_array_equal(np.asarray(getattr(p, field),
                                                 dtype=f32), row(want))
    inv_nx = float(np.float32(1.0 / nx))
    inv_ny = float(np.float32(1.0 / ny))
    np.testing.assert_array_equal(np.asarray(p.hor, dtype=f32),
                                  row(cam.horizontal * inv_nx))
    np.testing.assert_array_equal(np.asarray(p.vert, dtype=f32),
                                  row(cam.vertical * inv_ny))
    assert f32(p.lens) == row(cam.lens_radius) and p.lens > 0
    assert f32(p.t0) == row(cam.time0)
    assert f32(p.dt) == row(cam.time1 - cam.time0)
    assert p.h0 == R.path_hash_base(seed) and p.nx == nx


def _members(struct):
    body = re.search(rf"struct {struct} {{(.*?)}};", SRC, re.S).group(1)
    return [m for line in re.sub(r"//.*", "", body).split(";")
            for m in re.findall(r"(\w+)(?:\[3\])?\s*$", line.strip())]


@pytest.mark.parametrize("struct,cls", [("RegenParams", SK._CRegenParams),
                                        ("RegenIO", SK._CRegenIO)])
def test_source_structs_are_the_wrappers(struct, cls):
    assert _members(struct) == [f[0] for f in cls._fields_]


def test_source_stream_offsets_are_the_streams():
    """The header's stream offsets are utils/rng's."""
    hdr = (CSRC / "rng.cuh").read_text()
    for name in ("GOLDEN", "CAM_OFF"):
        m = re.search(rf"{name} = (0x[0-9A-F]+)u", hdr)
        assert m and int(m.group(1), 16) == getattr(R, name), name


def test_first_paths_without_r_are_the_camera_rays():
    """`_first_paths` without R's parameters: `make_path_keys` and
    `generate_camera_rays` of every lane, depth 0."""
    scene = rtt.build_scene(2, 16, 8, device="cpu", dof="book")
    cfg = rtt.RenderConfig(nx=16, ny=8, spp=2, scene_id=2)
    pixel = torch.arange(128, dtype=torch.int64)
    sample = torch.full((128,), 1, dtype=torch.int64)
    path, keys, depth = TI._first_paths(scene, cfg, 5, pixel, sample, None)
    want_keys = R.make_path_keys(5, pixel, sample)
    want = TI.generate_camera_rays(scene, cfg, pixel, want_keys)
    assert torch.equal(keys, want_keys) and not bool(depth.any())
    for a, b in zip(path, want):
        a = torch.stack(list(a)) if isinstance(a, Vec3) else a
        b = torch.stack(list(b)) if isinstance(b, Vec3) else b
        assert torch.equal(a, b)
