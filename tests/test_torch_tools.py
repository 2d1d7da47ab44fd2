"""The port's tools (tools/*_torch.py) against the reference's tools on the
CPU, at small sizes.

- kernel_check: the port's plain side on the reference tool's numpy rays
  equals the reference tool's jnp side (`intersect_scene`, `occluded`,
  `gather_shade`, as tools/kernel_check.py:34-52 calls them) on scenes 0
  and 5 and a 256-sphere field, at tests/test_torch_trace.py's tolerances
  (winners, hit counts, occlusion and integer shade fields equal; t within
  rtol 2e-4; point, normal and uv within atol/rtol 1e-4, on the field
  tests/test_torch_scale.py's 2e-4, of its extent for points; rgb, fuzz
  and eta within 1e-6); its report passes with the plain functions standing in for
  the kernels and fails on one moved winner;
- bench_scenes: the same workloads and override parsing;
- profile_scene: the bucket map on a synthetic Chrome trace that names
  each bucket's kernel, the buckets summing to the device total;
- occupancy_report: the counters of scene 1 on both schedulers equal the
  reference `render`'s;
- compare_reference: the committed halves it scores against, and its SSIM
  of them equal to tests/test_parity.py's;
- scene2_archaeology: the phantom light row equals the reference tool's;
- exp_sortcost: the sort key equals a numpy formula of the reference's;
- every tool raises without CUDA when no device is given, and importing
  them pulls in neither JAX nor the JAX package.
"""

import ast
import glob
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rtw_tpu as rt
from rtw_tpu.models.scene import Lights as JLights
from rtw_tpu.ops.intersect import intersect_scene, occluded
from rtw_tpu.ops.shading import gather_shade
from rtw_tpu.ops.vec import v3
from rtw_tpu.utils.image import ssim as j_ssim
import rtw_tpu_torch as rtt
from rtw_tpu_torch.models.registry import build_stress_scene
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.utils.image import ssim as t_ssim
from tools import bench_scenes as j_bench
from tools import bench_scenes_torch as BS
from tools import compare_reference_torch as CR
from tools import exp_sortcost_torch as ES
from tools import kernel_check_torch as KC
from tools import occupancy_report_torch as OR
from tools import profile_scene_torch as PS
from tools import scene2_archaeology_torch as SA
from tools.stress_scale import build_stress_scene as j_build_stress_scene

# The suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's thread pools from oversubscribing them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SMALL = 512
FIELD = 256


def _scenes(src):
    """(reference scene, port scene on the CPU) of a kernel_check source."""
    if src == FIELD:
        return (j_build_stress_scene(FIELD),
                build_stress_scene(FIELD, device="cpu"))
    return (rt.build_scene(src, KC.SIZE, KC.SIZE),
            rtt.build_scene(src, KC.SIZE, KC.SIZE, device="cpu"))


def _case(src):
    """(scale, shift) of a kernel_check case: the tool's, or the fields'
    for the 256-sphere field."""
    for _, s, scale, shift, _ in KC.CASES:
        if s == src or (src == FIELD and s == 16384):
            return scale, shift
    raise KeyError(src)


def _reference_side(js, rays):
    """tools/kernel_check.py's jnp side on the same numpy rays."""
    o, d, vu = rays
    n = o.shape[0]
    O, D = v3(jnp.asarray(o)), v3(jnp.asarray(d))
    tm = jnp.zeros((n,), jnp.float32)
    vu = jnp.asarray(vu)

    @jax.jit
    def both():
        h = intersect_scene(js, O, D, 1e-6, 1e27, tm, vu)
        s = gather_shade(js, h.prim_idx, h.prim_idx >= 0)
        return h, s, occluded(js, O, D, 1e-4, 1e4, tm, vu)

    h, s, occ = jax.tree_util.tree_map(np.asarray, both())
    return {"prim_idx": h.prim_idx, "t": h.t, "mat_id": h.mat_id,
            "point": np.stack(h.point), "normal": np.stack(h.normal),
            "u": h.u, "v": h.v, "mat_type": s.mat_type, "fuzz": s.fuzz,
            "eta": s.eta, "rgb": np.stack(s.rgb), "occluded": occ}


@pytest.mark.parametrize("src", [0, 5, FIELD])
def test_kernel_check_plain_side_matches_the_reference_tool(src):
    js, ts = _scenes(src)
    scale, shift = _case(src)
    rays = KC.make_rays(N_SMALL, KC.SEED, scale, shift, ts.n_vol)
    want = _reference_side(js, rays)
    got = KC.queries(ts, rays, TK.trace_plain, TK.occluded_plain)
    np.testing.assert_array_equal(got["prim_idx"], want["prim_idx"])
    hit = want["prim_idx"] >= 0
    assert int((got["prim_idx"] >= 0).sum()) == int(hit.sum()) > 0
    np.testing.assert_array_equal(got["occluded"], want["occluded"])
    for f in ("mat_id", "mat_type"):
        np.testing.assert_array_equal(got[f][hit], want[f][hit], f)
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=2e-4)
    # tests/test_torch_scale.py's on the field: its spheres are small and
    # hundreds of units away, so the quadratic's b^2 - ac cancels four
    # digits and an ulp of t moves a hit point by ~1e-3 (measured: 1.0e-3,
    # normal 1.6e-4)
    tol = 2e-4 if src == FIELD else 1e-4
    extent = float(ts.block_aabbs[:, :6].abs().max()) if src == FIELD else 1
    for f in ("point", "normal", "u", "v"):
        np.testing.assert_allclose(
            got[f][..., hit], want[f][..., hit], rtol=tol,
            atol=tol * extent if f == "point" else tol, err_msg=f)
    for f in ("rgb", "fuzz", "eta"):
        np.testing.assert_allclose(got[f][..., hit], want[f][..., hit],
                                   atol=1e-6, err_msg=f)


def _moved_winner(trace):
    """`trace` with one hit lane's winner moved to another prim at twice
    its distance: a fault, not a near tie."""
    def moved(scene, *args):
        hit, shade = trace(scene, *args)
        lane = int(torch.nonzero(hit.prim_idx >= 0)[0, 0])
        prim = hit.prim_idx.clone()
        prim[lane] = (prim[lane] + 1) % scene.prims.params.shape[0]
        t = hit.t.clone()
        t[lane] = 2.0 * t[lane]
        return hit._replace(prim_idx=prim, t=t), shade
    return moved


@pytest.mark.parametrize("case", ["scene0_cornell", "scene5_three_spheres"])
def test_kernel_check_report_passes_on_plain_and_fails_on_a_moved_winner(
        case):
    label, src, scale, shift, steps = next(c for c in KC.CASES
                                           if c[0] == case)
    scene = rtt.build_scene(src, KC.SIZE, KC.SIZE, device="cpu")
    plain = KC.plain_kernels()
    rep = KC.check_case(label, scene, scale, shift, steps, plain, n=N_SMALL)
    assert rep["pass"] and rep["prim_idx_mismatches"] == 0
    assert rep["lanes_bit_equal"] == {"trace": N_SMALL, "occluded": N_SMALL,
                                      "mega_step": KC.SIZE * KC.SIZE}
    assert rep["mega_step"]["pass"] and rep["mega_step"]["rays"] > 0
    assert rep["not_bit_equal"] == {"trace": {}, "occluded": {}}
    broken = plain._replace(trace=_moved_winner(plain.trace))
    rep = KC.check_case(label, scene, scale, shift, (), broken, n=N_SMALL)
    assert not rep["pass"]
    assert rep["prim_idx_mismatches"] == 1
    assert rep["winner_near_tie_flips"] == 0
    assert rep["lanes_bit_equal"]["trace"] == N_SMALL - 1
    assert rep["not_bit_equal"]["trace"] == {"prim_idx": 1, "t": 1}


def test_kernel_check_names_the_megakernel_rows():
    from rtw_tpu_torch.ops import mega_kernel as MK

    assert len(KC.SF_ROWS) == MK.NF and len(KC.SI_ROWS) == MK.NI
    for name, row in (("org_x", MK.F_ORG), ("dir_x", MK.F_DIR),
                      ("thr_x", MK.F_THR), ("rad_x", MK.F_RAD),
                      ("acc_x", MK.F_ACC), ("time", MK.F_TIME),
                      ("prev_pdf", MK.F_PPDF)):
        assert KC.SF_ROWS[row] == name
    for name, row in (("alive", MK.I_ALIVE), ("prev_diffuse", MK.I_PREVD),
                      ("depth", MK.I_DEPTH), ("sample", MK.I_SAMPLE),
                      ("pixel", MK.I_PIXEL)):
        assert KC.SI_ROWS[row] == name


def test_kernel_check_hybrid_step_from_the_queue_carry():
    """D's step on scene 1 (plain on both sides) from the queue's first
    carry: every lane alive and traced once, each a camera ray."""
    label, src, scale, shift, steps = KC.CASES[1]
    assert steps == ("mega_step_hybrid",)
    scene = rtt.build_scene(src, KC.SIZE, KC.SIZE, device="cpu")
    rep = KC.check_case(label, scene, scale, shift, steps,
                        KC.plain_kernels(), n=N_SMALL)
    step = rep["mega_step_hybrid"]
    assert rep["pass"] and step["pass"]
    assert step["lanes_bit_equal"] == step["n_lanes"] == KC.SIZE * KC.SIZE
    assert step["rays"] == KC.SIZE * KC.SIZE      # no light: no NEE ray


def test_kernel_check_cases_are_the_reference_tools():
    src = open(os.path.join(REPO, "tools", "kernel_check.py")).read()
    tree = ast.parse(src)
    want = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Tuple) and len(node.elts) == 4 and \
                isinstance(node.elts[0], ast.Constant) and \
                isinstance(node.elts[0].value, str):
            want.append((node.elts[0].value, ast.literal_eval(node.elts[2]),
                         ast.literal_eval(node.elts[3])))
    got = [(label, scale, shift) for label, _, scale, shift, _ in KC.CASES]
    assert len(got) == len(want) == 8
    for (gl, gs, gsh), (wl, ws, wsh) in zip(got, want):
        assert gs == ws and tuple(gsh) == tuple(wsh)
        assert gl == wl or (gl, wl) == ("stress_131072",
                                        "stress_131072_streamed")


def test_bench_scenes_keeps_the_reference_workloads_and_overrides():
    assert BS.WORKLOADS == j_bench.WORKLOADS
    assert BS.REPS == j_bench.REPS
    for v in ("4", "0.5", "True", "tea"):
        assert BS._coerce(v) == j_bench._coerce(v)
        assert type(BS._coerce(v)) is type(j_bench._coerce(v))


# one kernel name per bucket, as the card's profiler names them
SYNTHETIC = (
    ("void mega_trace_kernel<true>(int const*, float const*)", "mega_trace"),
    ("void mega_kernel<false, true>(float const*, int const*)", "mega_step"),
    ("trace_kernel(float const*, float const*, float const*)",
     "trace_kernel"),
    ("occluded_kernel(float const*, float const*)", "occl_kernel"),
    ("(anonymous namespace)::shade_kernel(ShadeIO, int, ShadeParams)",
     "shade_kernel"),
    ("(anonymous namespace)::shade_finish_kernel(FinishIO, int)",
     "shade_finish"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 4>", "scatter"),
    ("void at::native::index_put_kernel_impl<float>", "scatter"),
    ("void at::native::gather_kernel<float>", "gather"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather"),
    ("void cub::DeviceScanKernel<int>", "scan"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel", "sort"),
    ("void at::native::reduce_kernel<512, 1>", "reduce"),
    ("Memcpy DtoH (Device -> Pinned)", "copy"),
    ("Memset (Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, float>",
     "elementwise"),
    ("void some_other_kernel<float>", "other"),
)


def test_profile_scene_buckets_on_a_synthetic_trace():
    events, cats = [], {"Memcpy": "gpu_memcpy", "Memset": "gpu_memset"}
    for i, (name, _) in enumerate(SYNTHETIC):
        events.append({"ph": "X", "cat": cats.get(name.split()[0], "kernel"),
                       "name": name, "pid": 0, "tid": 7, "ts": 200.0 * i,
                       "dur": 10.0 * (i + 1)})
    # host events and metadata are not device time
    events += [{"ph": "X", "cat": "cpu_op", "name": "aten::index",
                "ts": 0.0, "dur": 5000.0},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": 0.0, "dur": 3.0},
               {"ph": "M", "name": "process_name", "pid": 0,
                "args": {"name": "GPU 0"}}]
    trace = json.loads(json.dumps({"traceEvents": events}))
    for name, bucket in SYNTHETIC:
        assert PS.bucket_of(name) == bucket, name
    dev = PS.device_events(trace)
    assert len(dev) == len(SYNTHETIC)
    out = PS.breakdown(dev, wall_ms=2.0)
    want = {}
    for i, (_, bucket) in enumerate(SYNTHETIC):
        want[bucket] = want.get(bucket, 0.0) + 10.0 * (i + 1) / 1e3
    assert out["device_ms"].keys() == want.keys()
    for k, v in want.items():
        assert out["device_ms"][k] == pytest.approx(v, rel=1e-12)
    total = sum(10.0 * (i + 1) for i in range(len(SYNTHETIC))) / 1e3
    assert sum(out["device_ms"].values()) == pytest.approx(total, rel=1e-12)
    assert out["device_total_ms"] == pytest.approx(total, rel=1e-12)
    # the events do not overlap: busy is their sum, idle the rest
    assert out["busy_ms"] == pytest.approx(total, rel=1e-12)
    assert out["idle_ms"] == pytest.approx(2.0 - total, rel=1e-12)
    assert len(out["top_ops_ms"]) == 12


def test_profile_scene_busy_time_is_the_union_of_overlapping_events():
    events = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0),
              ("d", 31.0, 1.0)]
    assert PS.busy_us(events) == 20.0


def test_occupancy_report_matches_the_reference_render():
    """Scene 1 at 32x16, 4 spp, depth 4 on both schedulers: the tool's
    entry equals the reference render's counters, rounded as the tool
    rounds them."""
    got = OR.scene_entry(1, 32, 16, 4, max_depth=4, device="cpu")
    js = rt.build_scene(1, 32, 16)
    for sched in OR.SCHEDULERS:
        m = {}
        rt.render(js, rt.RenderConfig(nx=32, ny=16, spp=4, max_depth=4,
                                      scene_id=1, scheduler=sched,
                                      bounce_stats=True,
                                      occupancy_trace=True), metrics=m)
        e = got[sched]
        assert e["wavefront_iterations"] == m["wavefront_iterations"]
        assert e["rays_by_depth"] == [round(x) for x in m["rays_by_depth"]]
        assert e["occupancy_by_iter"] == [round(x, 3)
                                          for x in m["occupancy_by_iter"]]
        assert e["mean_occupancy"] == round(m["mean_occupancy"], 3)
        assert e["rays_by_depth"][0] == 32 * 16 * 4


COMMITTED_SIZES = {0: (400, 400), 1: (400, 200), 2: (400, 133), 4: (400, 112)}


@pytest.mark.parametrize("sid", sorted(COMMITTED_SIZES))
def test_compare_reference_scores_the_committed_halves(sid):
    left, right = CR.committed_halves(sid)
    w, h = COMMITTED_SIZES[sid]
    assert right.shape == left.shape == (h, w, 3)
    np.testing.assert_array_equal(CR.reference_image(sid), right)
    # tests/test_parity.py's score of the same pair
    img = np.asarray(Image.open(os.path.join(
        REPO, "docs", "parity", f"scene{sid}_vs_ref.png")).convert("RGB"),
        np.float32) / 255.0
    half = img.shape[1] // 2
    want = j_ssim(img[:, :half], img[:, half:])
    assert abs(t_ssim(left, right) - want) <= 1e-12
    with pytest.raises(ValueError, match="--ref-dir"):
        CR.reference_image(sid, width=800)


def test_archaeology_reference_panel_is_the_committed_strips():
    strip = np.asarray(Image.open(os.path.join(
        REPO, "docs", "parity", "scene2_archaeology.png")).convert("RGB"),
        np.float32) / 255.0
    np.testing.assert_array_equal(CR.reference_image(2), strip[:, 400:800])


def _reference_phantom():
    """The phantom light row of tools/scene2_archaeology.py, evaluated
    from its source."""
    tree = ast.parse(open(os.path.join(REPO, "tools",
                                       "scene2_archaeology.py")).read())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "phantom")
    expr = ast.Expression(node.value)
    return eval(compile(expr, "scene2_archaeology.py", "eval"),
                {"Lights": JLights, "jnp": jnp})


def test_archaeology_phantom_light_row_is_the_reference_tools():
    want = _reference_phantom()
    got = SA.phantom_lights("cpu")
    for f in ("position", "vec_u", "vec_v", "emission", "area", "normal"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
        assert getattr(got, f).dtype == torch.float32
    scene = SA.variant_scene("phantom_nee", 3.0, "cpu")
    live = SA.variant_scene("live", 3.0, "cpu")
    assert scene.num_lights == live.num_lights == 1
    torch.testing.assert_close(scene.prims.params, live.prims.params,
                               rtol=0, atol=0)


def test_exp_sortcost_key_is_the_reference_formula():
    _, _, o, d = ES.inputs("cpu")
    on = [x.numpy() for x in o]
    dn = [x.numpy() for x in d]
    # tools/exp_sortcost.py:36-44 in numpy, float32 throughout
    oct_ = ((dn[0] < 0).astype(np.int32) + 2 * (dn[1] < 0).astype(np.int32)
            + 4 * (dn[2] < 0).astype(np.int32))
    cell = np.zeros(ES.N, np.int32)
    for ax in range(3):
        q = np.clip(((on[ax] + np.float32(10.0)) * np.float32(4.0 / 20.0))
                    .astype(np.int32), 0, 3)
        cell = cell * 4 + q
    want = cell * 8 + oct_
    got = ES.keyfn(o, d).numpy()
    np.testing.assert_array_equal(got, want)
    perm = ES.sort_iota(ES.keyfn(o, d))
    assert bool((ES.keyfn(o, d)[perm].diff() >= 0).all())
    planes = ES.full(o, d, [torch.arange(ES.N)])
    torch.testing.assert_close(planes[0], perm)


NO_DEVICE = (
    (KC, "run_cases", ()), (BS, "bench_scene", (5,)),
    (PS, "profile_scene", (2,)), (OR, "scene_entry", (1, 32, 16, 4)),
    (CR, "compare_scene", (0,)), (SA, "archaeology", ()),
    (ES, "run", ()),
)


@pytest.mark.parametrize("mod,fn,args", NO_DEVICE,
                         ids=[f"{m.__name__}.{f}" for m, f, _ in NO_DEVICE])
def test_each_tool_raises_without_cuda(monkeypatch, mod, fn, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(mod, fn)(*args)


def test_final_sweep_headline_raises_without_cuda(monkeypatch):
    mod = importlib.import_module("tools.final_sweep_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.headline()


def test_tools_import_no_jax():
    names = sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(REPO, "tools", "*_torch.py")))
    assert len(names) >= 9
    code = ("import sys; " + "; ".join(f"import tools.{n}" for n in names)
            + "; bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'rtw_tpu.')) or m == 'rtw_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
