"""The port's RNG streams against rtw_tpu.utils.rng: "fast", "tea" and
"threefry" draws must be bit-equal, so a port render traces the same
samples as a reference render of the same `cfg.rng`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rtw_tpu.utils import rng as JR
from rtw_tpu_torch.utils import rng as TR

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

N = 4096


def _u32(rng, n=N):
    return rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def test_pcg_hash_bit_equal():
    x = _u32(np.random.default_rng(1))
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(JR.pcg_hash(jnp.asarray(x)))
    got = TR.pcg_hash(_t(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 9, 12345, 2 ** 32 - 1])
def test_pixel_sample_hash_bit_equal(seed):
    rng = np.random.default_rng(seed % 1000)
    pix = rng.integers(0, 800 * 800, N).astype(np.int32)
    smp = rng.integers(0, 1000, N).astype(np.int32)
    want = np.asarray(JR.pixel_sample_hash(JR.base_key(seed),
                                           jnp.asarray(pix),
                                           jnp.asarray(smp)))
    got = TR.pixel_sample_hash(seed, _t(pix), _t(smp)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # a scalar sample index keys the same stream
    want0 = np.asarray(JR.pixel_sample_hash(JR.base_key(seed),
                                            jnp.asarray(pix), 7))
    got0 = TR.pixel_sample_hash(seed, _t(pix), 7).numpy()
    np.testing.assert_array_equal(got0, want0.astype(np.int64))


@pytest.mark.parametrize("n_slots", [8, 10])
def test_bounce_uniforms_bit_equal(n_slots):
    rng = np.random.default_rng(n_slots)
    keys = _u32(rng)
    bounce = rng.integers(0, 21, N).astype(np.int32)
    want = np.asarray(JR.bounce_uniforms(jnp.asarray(keys),
                                         jnp.asarray(bounce), n_slots))
    got = TR.bounce_uniforms(_t(keys), _t(bounce), n_slots).numpy()
    assert got.dtype == np.float32 and got.shape == (n_slots, N)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # scalar bounce
    want1 = np.asarray(JR.bounce_uniforms(jnp.asarray(keys), 3, n_slots))
    got1 = TR.bounce_uniforms(_t(keys), 3, n_slots).numpy()
    np.testing.assert_array_equal(got1.view(np.uint32),
                                  want1.view(np.uint32))


def test_camera_uniforms_bit_equal():
    keys = _u32(np.random.default_rng(3))
    want = np.asarray(JR.camera_uniforms(jnp.asarray(keys)))
    got = TR.camera_uniforms(_t(keys)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_path_hash_base_matches_key_data():
    for seed in (0, 1, 9, 2 ** 31, 2 ** 32 - 1):
        kd = np.asarray(jax.random.key_data(jax.random.key(seed)))
        assert kd.tolist() == [seed >> 32, seed & 0xFFFFFFFF]
        want = int(JR.pcg_hash(jnp.uint32(kd[0])
                               + JR.pcg_hash(jnp.uint32(kd[-1]))))
        assert TR.path_hash_base(seed) == want


@pytest.mark.parametrize("seed", [0x314759, 0x6314759, 1])
def test_xorshift32_sequences_equal(seed):
    a, b = JR.XorShift32(seed), TR.XorShift32(seed)
    assert [a.randf() for _ in range(2000)] == [b.randf() for _ in range(2000)]
    assert int(a.state) == int(b.state)


def test_threefry_bit_layout_is_pinned():
    """The port's threefry reproduces jax 0.9.0 under
    jax_threefry_partitionable=True; another layout draws other bits."""
    assert jax.__version__ == "0.9.0"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("rounds", [8, 16])
def test_tea_bit_equal(rounds):
    rng = np.random.default_rng(rounds)
    v0, v1 = _u32(rng), _u32(rng)
    v0[:3] = [0, 0xFFFFFFFF, 1]
    v1[:3] = [0, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(JR.tea(jnp.asarray(v0), jnp.asarray(v1), rounds))
    got = TR.tea(_t(v0), _t(v1), rounds).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_threefry2x32_fold_in_and_uniform_bit_equal():
    """threefry2x32 against jax's own on random keys and counters;
    fold_in against jax.random.fold_in; bits and uniform against
    jax.random.bits and jax.random.uniform, whose draw i is the same for
    every n."""
    from jax._src import prng

    rng = np.random.default_rng(5)
    k, x = _u32(rng, 2), _u32(rng, 2 * N)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x)))
    k0, k1 = (torch.tensor(int(v)) for v in k)
    y0, y1 = TR.threefry2x32(k0, k1, _t(x[:N]), _t(x[N:]))
    np.testing.assert_array_equal(torch.cat([y0, y1]).numpy(),
                                  want.astype(np.int64))

    for seed in (0, 7, 2 ** 32 - 1):
        key = JR.base_key(seed)
        kd = torch.tensor(TR.key_data(seed)).reshape(2, 1)
        assert kd.flatten().tolist() == np.asarray(
            jax.random.key_data(key)).tolist()
        for d in (0, 5, 0x0CA4, 2 ** 31 + 3):
            want = np.asarray(jax.random.key_data(jax.random.fold_in(key,
                                                                     d)))
            got = TR.fold_in(kd, torch.tensor(d)).flatten().numpy()
            np.testing.assert_array_equal(got, want.astype(np.int64))
        for n in (1, 5, 13):
            bits = TR.threefry_bits(kd, n)[:, 0].numpy()
            np.testing.assert_array_equal(
                bits, np.asarray(jax.random.bits(key, (n,))).astype(np.int64))
            u = TR.bits_to_unit(TR.threefry_bits(kd, n))[:, 0].numpy()
            want_u = np.asarray(jax.random.uniform(key, (n,), jnp.float32))
            np.testing.assert_array_equal(u.view(np.uint32),
                                          want_u.view(np.uint32))


def _path_keys(impl, seed, pix, smp):
    jk = JR.make_path_keys(JR.base_key(seed), jnp.asarray(pix),
                           jnp.asarray(smp) if np.ndim(smp) else smp, impl)
    tk = TR.make_path_keys(seed, _t(pix), _t(smp) if np.ndim(smp) else smp,
                           impl)
    return jk, tk


def _key_plane(jk):
    """The reference's path keys as the port lays them out: a uint32
    plane, or threefry key data as [2, N]."""
    if jnp.issubdtype(jk.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(jk)).T.astype(np.int64)
    return np.asarray(jk).astype(np.int64)


@pytest.mark.parametrize("impl", ["tea", "threefry"])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_make_path_keys_bit_equal(impl, seed):
    """Per-lane and scalar sample indices."""
    rng = np.random.default_rng(seed % 1000)
    pix = rng.integers(0, 800 * 800, N).astype(np.int32)
    smp = rng.integers(0, 1000, N).astype(np.int32)
    for s in (smp, 7):
        jk, tk = _path_keys(impl, seed, pix, s)
        np.testing.assert_array_equal(tk.numpy(), _key_plane(jk))


def test_tea_stream_ignores_seeds_below_2_32():
    """The reference keys tea on the key's high word, 0 below 2^32: seeds
    0 and 7 draw one tea stream in both packages."""
    pix = np.arange(64, dtype=np.int32)
    j0, t0 = _path_keys("tea", 0, pix, 3)
    j7, t7 = _path_keys("tea", 7, pix, 3)
    np.testing.assert_array_equal(np.asarray(j0), np.asarray(j7))
    assert torch.equal(t0, t7)
    assert not torch.equal(t0, _path_keys("tea", 2 ** 32, pix, 3)[1])


@pytest.mark.parametrize("impl", ["tea", "threefry"])
@pytest.mark.parametrize("n_slots", [8, 11, 13])
def test_bounce_uniforms_other_streams_bit_equal(impl, n_slots):
    """Per-lane and scalar bounce, on path keys of random (pixel,
    sample)."""
    rng = np.random.default_rng(n_slots)
    pix = rng.integers(0, 800 * 800, N).astype(np.int32)
    smp = rng.integers(0, 1000, N).astype(np.int32)
    jk, tk = _path_keys(impl, 3, pix, smp)
    bounce = rng.integers(0, 21, N).astype(np.int32)
    for jb, tb in ((jnp.asarray(bounce), _t(bounce)), (3, 3)):
        want = np.asarray(JR.bounce_uniforms(jk, jb, n_slots, impl))
        got = TR.bounce_uniforms(tk, tb, n_slots, impl).numpy()
        assert got.dtype == np.float32 and got.shape == (n_slots, N)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("impl", ["tea", "threefry"])
def test_camera_uniforms_other_streams_bit_equal(impl):
    rng = np.random.default_rng(4)
    pix = rng.integers(0, 800 * 800, N).astype(np.int32)
    smp = rng.integers(0, 1000, N).astype(np.int32)
    jk, tk = _path_keys(impl, 0, pix, smp)
    want = np.asarray(JR.camera_uniforms(jk, impl))
    got = TR.camera_uniforms(tk, impl).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_unknown_rng_raises():
    keys = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="unknown rng"):
        TR.bounce_uniforms(keys, 1, 8, "mt19937")
    with pytest.raises(ValueError, match="unknown rng"):
        TR.make_path_keys(0, keys, 0, "mt19937")
