"""Scene construction in the port against rtw_tpu: every array and every
static field of the six registered scenes must be equal."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu.ops import trace_kernel as JTK
import rtw_tpu_torch as rtt
from rtw_tpu_torch.models import scene as TS
from rtw_tpu_torch.ops import trace_kernel as TTK

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

NX, NY = 64, 48
GROUPS = ("prims", "materials", "textures", "lights", "camera")


def _leaves(scene, to_np):
    """{field path: numpy array} of a scene of either package."""
    out = {}
    for g in GROUPS:
        grp = getattr(scene, g)
        for f in dataclasses.fields(grp):
            out[f"{g}.{f.name}"] = to_np(getattr(grp, f.name))
    out["sky_light"] = to_np(scene.sky_light)
    out["block_aabbs"] = to_np(scene.block_aabbs)
    return out


def _jax_state(scene):
    arrays = _leaves(scene, np.asarray)
    static = {k: getattr(scene, k) for k in TS.STATIC_FIELDS}
    return arrays, static


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("sid", range(6))
def test_build_scene_equals_reference(sid):
    ref = rt.build_scene(sid, NX, NY)
    got = rtt.build_scene(sid, NX, NY, device="cpu")
    _assert_same(_leaves(got, lambda t: t.numpy()), _jax_state(ref)[0])
    for k in TS.STATIC_FIELDS:
        assert getattr(got, k) == getattr(ref, k), k
    assert got.device == torch.device("cpu")


@pytest.mark.parametrize("sid", [0, 5])
def test_scene_from_numpy_matches_port_build(sid):
    arrays, static = _jax_state(rt.build_scene(sid, NX, NY))
    carried = TS.scene_from_numpy(arrays, static, device="cpu")
    own = rtt.build_scene(sid, NX, NY, device="cpu")
    _assert_same(_leaves(carried, lambda t: t.numpy()),
                 _leaves(own, lambda t: t.numpy()))
    for k in TS.STATIC_FIELDS:
        assert getattr(carried, k) == getattr(own, k)
    with pytest.raises(KeyError):
        del arrays["prims.params"]
        TS.scene_from_numpy(arrays, static, device="cpu")


def test_scene_from_numpy_defaults_to_the_card():
    """No device asked for: the carried scene goes to CUDA, and without a
    card that raises instead of building on the CPU."""
    arrays, static = _jax_state(rt.build_scene(5, NX, NY))
    if torch.cuda.is_available():
        assert TS.scene_from_numpy(arrays, static).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.scene_from_numpy(arrays, static)


@pytest.mark.parametrize("sid,any_xform", [(0, True), (0, False),
                                           (5, False)])
def test_build_props_equals_reference(sid, any_xform):
    want = np.asarray(JTK.build_props(rt.build_scene(sid, NX, NY),
                                      any_xform))
    got = TTK.build_props(rtt.build_scene(sid, NX, NY, device="cpu"),
                          any_xform).numpy()
    assert got.shape == want.shape == (40 if sid == 0 else 8,
                                       49 if any_xform else 25)
    np.testing.assert_array_equal(got, want)


def test_dof_book_and_bad_inputs():
    ref = rt.build_scene(0, NX, NY, dof="book")
    got = rtt.build_scene(0, NX, NY, dof="book", device="cpu")
    assert float(got.camera.lens_radius) == float(ref.camera.lens_radius) == 0.5
    with pytest.raises(ValueError):
        rtt.build_scene(6, NX, NY, device="cpu")
    with pytest.raises(ValueError):
        rtt.build_scene(0, NX, NY, dof="thin", device="cpu")


def test_make_camera_equals_reference():
    from rtw_tpu.models import scene as JS

    args = ((478, 278, -600), (278, 278, 0), (0, 1, 0), 40.0, 1.25, 0.1,
            10.0, 0.0, 1.0)
    ref, got = JS.make_camera(*args), TS.make_camera(*args)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)
    assert jnp.asarray(ref.w).dtype == jnp.float32
