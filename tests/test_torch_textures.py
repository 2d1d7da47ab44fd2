"""The port's textures against rtw_tpu.ops.textures and
rtw_tpu.ops.shading.resolve_albedo on the same random points, uv and
uniforms, with scene 2's atlas (the earth map): Perlin noise, turbulence
and the bilinear fetches within rtol 1e-5 (rsqrt, sin and the float
blends may differ in the last bit), the nearest-texel RGB565 fetch (an
exact unpack) equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu.ops import shading as JSH
from rtw_tpu.ops import textures as JT
from rtw_tpu.ops.vec import Vec3 as JV
import rtw_tpu_torch as rtt
from rtw_tpu_torch.ops import shading as TSH
from rtw_tpu_torch.ops import textures as TT
from rtw_tpu_torch.ops.vec import Vec3 as TV

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

N = 4096


def _np(v):
    return np.stack([np.asarray(c) for c in v])


@pytest.fixture(scope="module")
def scenes():
    return rt.build_scene(2, 64, 48), rtt.build_scene(2, 64, 48,
                                                      device="cpu")


def test_perlin_and_turbulence_match_reference(scenes):
    js, ts = scenes
    rng = np.random.default_rng(11)
    p = rng.uniform(-40.0, 40.0, (3, N)).astype(np.float32)
    for j_fn, t_fn in ((JT.perlin_noise, TT.perlin_noise),
                       (JT.turbulence, TT.turbulence)):
        want = np.asarray(jax.jit(lambda q: j_fn(js.textures, JV(*q)))(p))
        got = t_fn(ts.textures, TV(*torch.as_tensor(p))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert np.abs(want).max() > 0.3


@pytest.mark.parametrize("name", ["_image_bilinear", "_image_bilinear_565",
                                  "_image_stoch_565", "_image_nearest_565"])
def test_atlas_fetches_match_reference(scenes, name):
    js, ts = scenes
    rng = np.random.default_rng(12)
    u = rng.uniform(-0.1, 1.1, N).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, N).astype(np.float32)
    xi = rng.uniform(size=N).astype(np.float32)
    img = np.zeros(N, np.int32)
    extra = (xi,) if name == "_image_stoch_565" else ()
    want = _np(jax.jit(lambda *a: getattr(JT, name)(js.textures, *a))(
        img, u, v, *extra))
    got = _np(getattr(TT, name)(ts.textures,
                                *(torch.as_tensor(a) for a in (img, u, v,
                                                               *extra))))
    if name == "_image_nearest_565":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert 0.05 < want.mean() < 0.95


@pytest.mark.parametrize("tex_filter", ["stoch565", "rgb565", "nearest565",
                                        "rgb8"])
def test_resolve_albedo_matches_reference(scenes, tex_filter):
    """Scene 2's shade records at reference hits of random rays: marble on
    the ground sphere, the earth map, constant colours."""
    js, ts = scenes
    rng = np.random.default_rng(13)
    o = (rng.uniform(-1, 1, (3, N)) * 13.0
         + np.array([[0.0], [1.0], [0.0]])).astype(np.float32)
    d = rng.normal(size=(3, N)).astype(np.float32)
    xi = rng.uniform(size=N).astype(np.float32)
    zeros = jnp.zeros(N, jnp.float32)
    hit = jax.jit(lambda o_, d_: rt.ops.intersect.intersect_scene(
        js, JV(*o_), JV(*d_), 1e-6, 1e27, zeros, zeros[None]))(o, d)
    shade = JSH.gather_shade(js, hit.prim_idx, hit.prim_idx >= 0)
    want = _np(jax.jit(lambda: JSH.resolve_albedo(
        js, shade, hit.point, hit.u, hit.v, tex_filter, True,
        jnp.asarray(xi)))())

    def tv(x):
        return torch.tensor(np.asarray(x))

    t_shade = TSH.ShadeRec(*(TV(*map(tv, f)) if isinstance(f, tuple)
                             else tv(f) for f in shade))
    got = _np(TSH.resolve_albedo(ts, t_shade, TV(*map(tv, hit.point)),
                                 tv(hit.u), tv(hit.v), tex_filter, True,
                                 torch.as_tensor(xi)))
    ttype = np.asarray(shade.tex_type)[np.asarray(hit.prim_idx) >= 0]
    assert {0, 2, 3} <= set(ttype.tolist())   # constant, noise, image
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
