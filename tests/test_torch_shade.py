"""Kernels E and F of the split tier's bounce step
(rtw_tpu_torch/ops/shade_kernel.py, csrc/shade_kernel.cu) on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there); here the wrappers run the plain versions,
so these tests hold:

- (a) `bounce_step` in the split modes "kernels" (B, E, C, F through
  their wrappers), "glue" (B and C with the torch glue) and "plain" equal
  bit for bit on every output plane, on scenes 0-5 under both estimators,
  the three streams, the four texture filters and the MIS weight off;
- (b) the "kernels" mode against the reference's `bounce_step` on CPU
  JAX (its jnp sweep) from bit-equal camera rays, three bounces: equal
  rays and the discrete planes on >= 99.9% of the lanes, as
  tests/test_torch_options.py and tests/test_torch_queue.py hold renders;
  the float planes of a lane within 1e-4 on >= 99% of the lanes where
  those agree and within 1e-3 on all of them.  A lane is not a pixel:
  the options test's 99.9% of pixels within 1e-4 averages samples, while
  one lane at its third bounce carries the plain port's f32 drift from
  the reference's fused arithmetic (up to 6e-4 on 1-3 of 384 lanes of
  scenes 1 and 2; "kernels" equals "plain" bit for bit, (a));
- (c) `ShadeTables` read back against the scene's tensors;
- (d) the wrappers' refusals (grad inputs, mixed devices, dtypes,
  non-contiguous planes), and that the gradient path never reaches E;
- the CUDA source's layouts (output rows, light columns, filter ids, the
  parameter structs) against the wrapper's.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtw_tpu as rt
from rtw_tpu import integrator as JI
from rtw_tpu.utils import rng as JR
import rtw_tpu_torch as rtt
from rtw_tpu_torch import integrator as TI
from rtw_tpu_torch.models import scene as TS
from rtw_tpu_torch.ops import shade_kernel as SK
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.ops.vec import Vec3
from rtw_tpu_torch.utils import rng as TR

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NX, NY = 24, 16
BOUNCES = 2

# (a): every scene under each of these; the filters on the atlas scenes
CASES = {"mis": {}, "book": dict(estimator="book"), "tea": dict(rng="tea"),
         "threefry": dict(rng="threefry"),
         "mis_weight_off": dict(mis_bsdf_weight=False)}
FILTERS = ("rgb565", "nearest565", "rgb8")
MODE_CASES = ([(sid, name, opts) for sid in range(6)
               for name, opts in CASES.items()]
              + [(sid, f, dict(tex_filter=f)) for sid in (2, 4)
                 for f in FILTERS])


def _start(sid, **opts):
    """(scene, cfg, path keys, camera state, depth) of a NX x NY frame."""
    scene = rtt.build_scene(sid, NX, NY, device="cpu")
    cfg = rtt.RenderConfig(nx=NX, ny=NY, spp=1, scene_id=sid, **opts)
    pix = torch.arange(NX * NY)
    keys = TR.make_path_keys(cfg.seed, pix, 0, cfg.rng)
    state = TI.generate_camera_rays(scene, cfg, pix, keys)
    return scene, cfg, keys, state, torch.zeros(NX * NY, dtype=torch.int64)


def _planes(state, rays):
    return [*state.origin, *state.direction, *state.throughput,
            *state.radiance, state.alive, state.time, state.prev_pdf,
            state.prev_diffuse, rays]


@pytest.mark.parametrize("sid,case,opts", MODE_CASES,
                         ids=[f"{s}-{c}" for s, c, _ in MODE_CASES])
def test_kernel_mode_equals_glue_and_plain(sid, case, opts):
    scene, cfg, keys, state, depth = _start(sid, **opts)
    for _ in range(BOUNCES):
        outs = {m: TI.bounce_step(scene, cfg, keys, state, depth, split=m)
                for m in TI.SPLIT_MODES}
        want = _planes(*outs["plain"])
        for mode in ("kernels", "glue"):
            for i, (a, b) in enumerate(zip(_planes(*outs[mode]), want)):
                torch.testing.assert_close(
                    a, b, rtol=0, atol=0, equal_nan=True,
                    msg=lambda m, i=i, mode=mode: f"{mode} plane {i}: {m}")
        state, depth = outs["kernels"][0], depth + 1
    assert bool(state.alive.any())


# (b): one config per scene (each costs a compile of the reference's step)
JAX_CASES = [(0, dict(estimator="book", rng="tea")),
             (1, dict(rng="threefry")), (2, {}), (3, dict(rng="tea")),
             (4, dict(rng="threefry", tex_filter="rgb565",
                      mis_bsdf_weight=False)),
             (5, {})]


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("sid,opts", JAX_CASES,
                         ids=[str(s) for s, _ in JAX_CASES])
def test_kernel_mode_steps_like_the_reference(sid, opts):
    scene, cfg, keys, st, depth = _start(sid, **opts)
    js = rt.build_scene(sid, NX, NY)
    jc = rt.RenderConfig(nx=NX, ny=NY, spp=1, scene_id=sid, backend="jnp",
                         **opts)
    pix = jnp.arange(NX * NY, dtype=jnp.int32)
    jkeys = JR.make_path_keys(JR.base_key(cfg.seed), pix,
                              jnp.zeros_like(pix), jc.rng)
    # jitted, as the port's camera rounds as the compiled reference does
    sj = jax.jit(lambda k: JI.generate_camera_rays(js, jc, pix, k))(jkeys)
    for a, b in ((sj.origin, st.origin), (sj.direction, st.direction)):
        for cj, ct in zip(a, b):
            np.testing.assert_array_equal(_np(cj), ct.numpy())
    jstep = jax.jit(lambda k, s, b: JI.bounce_step(js, jc, k, s, b))
    for bounce in range(3):
        rays_j0 = float(sj.ray_count)
        sj = jstep(jkeys, sj, jnp.full((NX * NY,), bounce, jnp.int32))
        st, rays = TI.bounce_step(scene, cfg, keys, st, depth,
                                  split="kernels")
        depth = depth + 1
        assert int(rays.sum()) == round(float(sj.ray_count) - rays_j0)
        agree = np.ones(NX * NY, bool)
        for name in ("alive", "prev_diffuse"):
            same = _np(getattr(sj, name)) == getattr(st, name).numpy()
            assert same.mean() >= 0.999, (bounce, name, same.mean())
            agree &= same
        got = np.stack([c.numpy() for c in _planes(st, rays)[:12]]
                       + [st.prev_pdf.numpy()])
        want = np.stack([_np(c) for f in ("origin", "direction",
                                          "throughput", "radiance")
                         for c in getattr(sj, f)] + [_np(sj.prev_pdf)])
        close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(0)
        assert close[agree].mean() >= 0.99, (
            bounce, np.abs(got - want)[:, agree].max())
        assert np.isclose(got, want, rtol=1e-3, atol=1e-3)[:, agree].all(), (
            bounce, np.abs(got - want)[:, agree].max())


# (c)
@pytest.mark.parametrize("sid", [1, 2, 4])
def test_shade_tables_read_back(sid):
    scene = rtt.build_scene(sid, 8, 8, device="cpu")
    tb = SK.shade_tables(scene)
    lt = scene.lights
    want = [(SK.L_POS, lt.position), (SK.L_U, lt.vec_u), (SK.L_V, lt.vec_v),
            (SK.L_EMIT, lt.emission), (SK.L_NRM, lt.normal)]
    assert tb.lights.shape == (max(scene.num_lights, 1), SK.LIGHT_COLS)
    for col, t in want:
        assert torch.equal(tb.lights[:, col:col + 3], t)
    assert torch.equal(tb.lights[:, SK.L_AREA], lt.area)
    assert torch.equal(tb.light_row, scene.prims.light_row_p)
    tex = scene.textures
    assert torch.equal(tb.images[:, 0:2], tex.image_dims)
    assert torch.equal(tb.images[:, 2], tex.image_offset)
    for words, packed in ((tb.atlas8, tex.images_packed),
                          (tb.atlas565, tex.images_packed565)):
        assert words.dtype == torch.int32
        assert torch.equal(words, packed.view(torch.int32))
    assert tb.sky == float(scene.sky_light)
    assert all(t.is_contiguous() for t in (tb.lights, tb.light_row,
                                           tb.images, tb.atlas8,
                                           tb.atlas565))


def test_shade_tables_of_many_lights():
    import chip_smoke

    scene = chip_smoke.furnace_cavity()
    tb = SK.shade_tables(scene)
    assert tb.lights.shape == (6, SK.LIGHT_COLS)
    assert torch.equal(tb.lights[:, SK.L_EMIT:SK.L_EMIT + 3],
                       scene.lights.emission)
    rows = tb.light_row[tb.light_row >= 0]
    assert sorted(rows.tolist()) == list(range(6))


# (d)
def _inputs(sid=2):
    """E's arguments at bounce 1 of scene `sid`, and F's."""
    scene, cfg, keys, state, depth = _start(sid)
    state, _ = TI.bounce_step(scene, cfg, keys, state, depth, split="plain")
    depth = depth + 1
    nv = max(scene.n_vol, 1)
    U = TR.bounce_uniforms(keys, depth + 1, TR.NUM_FIXED_SLOTS + 2 * nv + 1,
                           cfg.rng)
    tmax = torch.where(state.alive, cfg.t_max, -1e30)
    of, oi = TK.trace_rows(scene, state.origin, state.direction, cfg.t_min,
                           tmax, state.time, U[TR.NUM_FIXED_SLOTS:][:nv])
    out = SK.shade(scene, cfg, None, of, oi, state, depth, U)
    occ = torch.zeros(NX * NY, dtype=torch.bool)
    return scene, cfg, [of, oi, state, depth, U], [
        out.radiance, out.nee, out.shadow_tmax, occ]


def test_cpu_wrappers_are_the_plain_versions():
    scene, cfg, e, f = _inputs()
    got = SK.shade(scene, cfg, None, *e)
    want = SK.shade_plain(scene, cfg, *e)
    for a, b in zip(got, want):
        a = torch.stack(list(a)) if isinstance(a, Vec3) else a
        b = torch.stack(list(b)) if isinstance(b, Vec3) else b
        assert torch.equal(a, b)
    assert torch.equal(torch.stack(list(SK.finish(*f))),
                       torch.stack(list(SK.finish_plain(*f))))
    # the shadow query of a lane without one is never added
    inactive = f[2] <= -1e30
    fin = SK.finish(f[0], f[1], f[2], torch.zeros_like(f[3]))
    assert inactive.any() and bool((~inactive).any())
    for a, b in zip(fin, f[0]):
        assert torch.equal(a[inactive], b[inactive])


def test_wrappers_refuse_grad_inputs():
    scene, cfg, e, f = _inputs()
    state = e[2]
    leaf = state.throughput.x.clone().requires_grad_(True)
    bad = state._replace(throughput=Vec3(leaf, *state.throughput[1:]))
    with pytest.raises(ValueError, match="requires grad"):
        SK.shade(scene, cfg, None, e[0], e[1], bad, e[3], e[4])
    with pytest.raises(ValueError, match="requires grad"):
        SK.finish(Vec3(leaf, *f[0][1:]), *f[1:])
    with torch.no_grad():                    # as the kernels are run
        SK.shade(scene, cfg, None, e[0], e[1], bad, e[3], e[4])


def _meta(x):
    if isinstance(x, tuple):
        return type(x)(*(_meta(c) for c in x))
    return x.to("meta") if torch.is_tensor(x) else x


@pytest.mark.parametrize("fault", ["device", "dtype", "contiguous"])
def test_wrappers_refuse_bad_planes(fault):
    """A non-CPU tensor goes to the kernel's launch path, whose checks run
    before the library is built: the meta device stands in for the card."""
    scene, cfg, e, f = _inputs()
    of, oi, state, depth, U = (_meta(x) for x in e)
    rad, nee, tmax, occ = (_meta(x) for x in f)
    if fault == "device":
        state = state._replace(prev_pdf=e[2].prev_pdf)          # on the CPU
        nee = Vec3(f[1].x, *nee[1:])
        err = ValueError
    elif fault == "dtype":
        U = U.double()
        tmax = tmax.double()
        err = TypeError
    else:
        wide = torch.empty((NX * NY, 2), device="meta")
        state = state._replace(prev_pdf=wide[:, 0])
        rad = Vec3(wide[:, 1], *rad[1:])
        err = ValueError
    with pytest.raises(err, match={"device": "is on", "dtype": "dtype",
                                   "contiguous": "contiguous"}[fault]):
        SK.shade(scene, cfg, SK.shade_tables(scene), of, oi, state, depth, U)
    with pytest.raises(err):
        SK.finish(rad, nee, tmax, occ)


def test_gradient_path_never_reaches_e(monkeypatch):
    """A differentiable bounce in the "kernels" mode keeps B and C with the
    torch glue (E has no backward), and equals the "glue" mode."""
    def refuse(*a, **k):
        raise AssertionError("E launched on the gradient path")
    monkeypatch.setattr(SK, "shade", refuse)
    monkeypatch.setattr(SK, "finish", refuse)
    scene, cfg, keys, state, depth = _start(2)
    cfg = dataclasses.replace(cfg, differentiable=True)
    k = TI.bounce_step(scene, cfg, keys, state, depth, split="kernels")
    g = TI.bounce_step(scene, cfg, keys, state, depth, split="glue")
    for a, b in zip(_planes(*k), _planes(*g)):
        assert torch.equal(a, b)


# the CUDA source's layouts against the wrapper's
SRC = (REPO / "rtw_tpu_torch" / "csrc" / "shade_kernel.cu").read_text()


def _constants(names):
    out = {}
    for name in names:
        m = re.search(rf"\b{name} = (\d+)", SRC)
        assert m, name
        out[name] = int(m.group(1))
    return out


def test_source_layouts_match_the_wrapper():
    names = ("O_ORG", "O_DIR", "O_THR", "O_RAD", "O_PPDF", "O_SORG",
             "O_SDIR", "O_STMAX", "O_NEE", "OB_ALIVE", "OB_PREVD", "L_POS",
             "L_U", "L_V", "L_EMIT", "L_AREA", "L_NRM", "LIGHT_COLS")
    assert _constants(names) == {n: getattr(SK, n) for n in names}
    filters = _constants(("FILTER_STOCH565", "FILTER_RGB565",
                          "FILTER_NEAREST565"))
    assert filters == {f"FILTER_{k.upper()}": v
                       for k, v in SK.FILTERS.items()}
    assert SK.FILTER_RGB8 not in SK.FILTERS.values()
    hit = _constants(("H_POINT", "H_NORMAL", "H_U", "H_V", "H_FUZZ",
                      "H_ETA", "H_SCALE", "H_RGB", "H_ODD", "H_EVEN",
                      "HI_PRIM", "HI_MAT", "HI_TEX", "HI_IMG"))
    assert hit == {"H_POINT": 1, "H_NORMAL": 4, "H_U": 7, "H_V": 8,
                   "H_FUZZ": 9, "H_ETA": 10, "H_SCALE": 11, "H_RGB": 12,
                   "H_ODD": 15, "H_EVEN": 18, "HI_PRIM": 0, "HI_MAT": 1,
                   "HI_TEX": 2, "HI_IMG": 3}
    # B's rows as TK._unpack_hit reads them
    of = torch.arange(TK.HIT_F32, dtype=torch.float32).reshape(-1, 1)
    oi = torch.arange(TK.HIT_I32, dtype=torch.int32).reshape(-1, 1)
    h, s = TK._unpack_hit(of, oi)
    assert (int(h.point.x), int(h.normal.x), int(h.u), int(h.v),
            int(s.fuzz), int(s.eta), int(s.scale), int(s.rgb.x),
            int(s.odd.x), int(s.even.x)) == (1, 4, 7, 8, 9, 10, 11, 12, 15,
                                             18)
    assert (int(h.prim_idx), int(s.mat_type), int(s.tex_type),
            int(s.image_id)) == (0, 1, 2, 3)
    # the structs' members in the wrapper's order
    for struct, cls in (("ShadeParams", SK._CShadeParams),
                        ("ShadeIO", SK._CShadeIO),
                        ("FinishIO", SK._CFinishIO)):
        body = re.search(rf"struct {struct} {{(.*?)}};", SRC, re.S).group(1)
        members = [m for line in re.sub(r"//.*", "", body).split(";")
                   for m in re.findall(r"(\w+)(?:\[3\])?\s*$", line.strip())]
        assert members == [f[0] for f in cls._fields_], struct
