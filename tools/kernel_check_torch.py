"""On-card kernel-equivalence artifact of the port (the counterpart of
tools/kernel_check.py).

For scenes 0-5 (built at 64x64) and the 16384- and 131072-sphere stress
fields, the reference tool's comparison on its own rays (numpy
`default_rng(7)`, 4096 rays, origins `uniform(-1, 1) * scale + shift`,
directions `normal`, time 0, volume uniforms in [0.05, 0.95)): the split
kernels B (`trace_kernel.trace`, nearest hit in (1e-6, 1e27)) and C
(`trace_kernel.occluded_kernel`, any hit in (1e-4, 1e4)) against the
port's plain sweep (`trace_plain`, `occluded_plain`).  Where a case is
inside the megakernel's envelope (scenes 0, 3, 5, the 16384 field), A's
step (`mega_step`) against `mega_step_plain` for one wavefront step from
fresh camera rays at 64x64; where the hybrid mode runs (scene 1, the
16384 field), D's step (`mega_step(..., hybrid=True)`) the same way from
the queue's first carry.

Each case keeps the reference tool's report and pass rule (near-tie
winner flips counted apart and bounded, every other field's deviation on
the lanes whose winner agrees), and adds `lanes_bit_equal` for each
kernel, the lanes whose whole output equals the plain version's bit for
bit, and `not_bit_equal`, the lanes on which each field (each carry row
of a step) differs.

Run:  python tools/kernel_check_torch.py [out.json]
(default docs/torch/kernel_check.json).  Prints one JSON line per case,
writes the report, then prints the card's name and power limit.  Needs a
CUDA device; exits 1 if a case fails.
"""

import collections
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "..", "docs", "torch",
                   "kernel_check.json")

# (label, scene id or stress-field size, ray scale, ray shift, steps):
# the reference tool's cases; the port has no props streaming, so its
# 131072 field is the walk with its props in global memory
CASES = (
    ("scene0_cornell", 0, 600.0, (278.0, 278.0, -400.0), ("mega_step",)),
    ("scene1_moving_spheres", 1, 12.0, (0.0, 2.0, 0.0),
     ("mega_step_hybrid",)),
    ("scene2_iow_light", 2, 12.0, (0.0, 2.0, 0.0), ()),
    ("scene3_volumes", 3, 600.0, (278.0, 278.0, -400.0), ("mega_step",)),
    ("scene4_tnw_final", 4, 600.0, (278.0, 278.0, -400.0), ()),
    ("scene5_three_spheres", 5, 4.0, (0.0, 1.0, 1.0), ("mega_step",)),
    ("stress_16384_two_level", 16384, 250.0, (0.0, 0.0, 0.0),
     ("mega_step", "mega_step_hybrid")),
    ("stress_131072", 131072, 250.0, (0.0, 0.0, 0.0), ()),
)
SIZE = 64               # scenes and the megakernel steps at 64x64
N_RAYS = 4096
SEED = 7

# a megakernel step: i32 rows equal on this share of lanes, f32 rows within
# atol/rtol STEP_TOL there, and the ray counts apart by at most
# RAYS_PER_LANE a differing lane (chip_smoke.py's `_compare_step` rule)
STEP_EQUAL = 0.999
STEP_TOL = 1e-3
RAYS_PER_LANE = 2

# the megakernel's carry rows (ops/mega_kernel.py: F_* and I_*)
SF_ROWS = tuple(f"{name}_{c}" for name in ("org", "dir", "thr", "rad", "acc")
                for c in "xyz") + ("time", "prev_pdf")
SI_ROWS = ("alive", "prev_diffuse", "depth", "sample", "pixel")

Kernels = collections.namedtuple("Kernels", "trace occluded mega_step")


def cuda_kernels() -> Kernels:
    """The kernel side: B, C and the megakernel's step, launched on CUDA
    tensors."""
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.ops import trace_kernel as TK

    return Kernels(TK.trace, TK.occluded_kernel, MK.mega_step)


def plain_kernels() -> Kernels:
    """The reference side: the plain sweeps and the plain step."""
    from rtw_tpu_torch.ops import mega_kernel as MK
    from rtw_tpu_torch.ops import trace_kernel as TK

    return Kernels(TK.trace_plain, TK.occluded_plain, MK.mega_step_plain)


def build_case_scene(src, device="cuda"):
    """Scene `src` (an id of the registry) at SIZE x SIZE, or the `src`-
    sphere stress field, on `device`."""
    from rtw_tpu_torch import SCENE_NAMES, build_scene
    from rtw_tpu_torch.models.registry import build_stress_scene

    if src in SCENE_NAMES:
        return build_scene(src, SIZE, SIZE, device=device)
    return build_stress_scene(src, device=device)


def make_rays(n, seed, scale, shift, n_vol):
    """The reference tool's rays in numpy: origins [n, 3], directions
    [n, 3] (float32) and volume uniforms [max(n_vol, 1), n], drawn in its
    order."""
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-1, 1, (n, 3)) * scale + np.asarray(shift)).astype(
        np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    vu = rng.uniform(0.05, 0.95, (max(n_vol, 1), n)).astype(np.float32)
    return o, d, vu


HIT_FIELDS = ("t", "mat_id", "u", "v")
SHADE_FIELDS = ("mat_type", "fuzz", "eta", "tex_type", "scale", "image_id")
VEC_FIELDS = ("point", "normal", "rgb", "odd", "even")


def queries(scene, rays, trace, occluded):
    """Nearest hit (tmin 1e-6, tmax 1e27) and shadow test (1e-4, 1e4) of
    `rays` at time 0 through `trace` and `occluded`: a dict of numpy
    arrays, one per field of the hit and shading records ([3, n] for a
    vector) and "prim_idx", "occluded"."""
    import torch

    from rtw_tpu_torch.ops.vec import Vec3

    dev = scene.device
    o, d, vu = rays
    O, D = (Vec3(*torch.as_tensor(np.ascontiguousarray(a.T), device=dev))
            for a in (o, d))
    vu = torch.as_tensor(vu, device=dev)
    tm = torch.zeros(o.shape[0], dtype=torch.float32, device=dev)
    hit, shade = trace(scene, O, D, 1e-6, 1e27, tm, vu)
    occ = occluded(scene, O, D, 1e-4, 1e4, tm, vu)
    out = {"prim_idx": hit.prim_idx, "occluded": occ}
    for f in HIT_FIELDS:
        out[f] = getattr(hit, f)
    for f in SHADE_FIELDS:
        out[f] = getattr(shade, f)
    for f in VEC_FIELDS:
        rec = hit if f in ("point", "normal") else shade
        out[f] = torch.stack(list(getattr(rec, f)))
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def _bits(a):
    """An array's lanes as comparable integers (f32 bit patterns, so NaN
    equals NaN), lanes last."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a.astype(np.int64)


def _bit_equal(ref, ker, fields):
    """(lanes on which every field of `fields` equals bit for bit, {field:
    lanes on which it does not} for the fields that differ somewhere)."""
    same = np.ones(np.asarray(ref[fields[0]]).shape[-1], bool)
    differ = {}
    for f in fields:
        eq = _bits(ref[f]) == _bits(ker[f])
        eq = eq.all(axis=0) if eq.ndim == 2 else eq
        if not eq.all():
            differ[f] = int((~eq).sum())
        same &= eq
    return int(same.sum()), differ


def compare(label, ref, ker):
    """The reference tool's report and pass rule (tools/kernel_check.py:
    55-107) for two `queries` results, with `lanes_bit_equal` for B and C
    and, in `not_bit_equal`, the lanes on which each field differs."""
    hit = ref["prim_idx"] >= 0
    nh = max(int(hit.sum()), 1)
    # a winner flip with both t within 0.1% is fp-indeterminate geometry;
    # one with materially different t is a fault
    mism = ref["prim_idx"] != ker["prim_idx"]
    tie = mism & (np.abs(ref["t"] - ker["t"])
                  <= 1e-3 * np.maximum(np.abs(ref["t"]), 1e-3))
    real_mism = mism & ~tie
    agree = hit & ~mism

    def rel(f):
        if not agree.any():
            return 0.0
        a, b = ref[f][agree], ker[f][agree]
        return float((np.abs(a - b) / np.maximum(np.abs(a), 1e-6)).max())

    def absd(f):
        if not agree.any():
            return 0.0
        return float(np.abs(ref[f][..., agree] - ker[f][..., agree]).max())

    rep = {
        "scene": label,
        "n_rays": int(hit.size),
        "n_hits": int(hit.sum()),
        "winner_near_tie_flips": int(tie.sum()),
        "prim_idx_mismatches": int(real_mism.sum()),
        "mat_id_mismatches": int((ref["mat_id"] != ker["mat_id"])[agree]
                                 .sum()),
        "mat_type_mismatches": int(
            (ref["mat_type"] != ker["mat_type"])[agree].sum()),
        "occluded_mismatches": int((ref["occluded"] != ker["occluded"])
                                   .sum()),
        "t_max_rel": rel("t"),
        "point_max_abs": absd("point"),
        "normal_max_abs": absd("normal"),
        "uv_max_abs": max(absd("u"), absd("v")),
        "rgb_max_abs": absd("rgb"),
        "fuzz_eta_max_abs": max(absd("fuzz"), absd("eta")),
    }
    bits = {"trace": _bit_equal(ref, ker, ("prim_idx", *HIT_FIELDS,
                                           *SHADE_FIELDS, *VEC_FIELDS)),
            "occluded": _bit_equal(ref, ker, ("occluded",))}
    rep["lanes_bit_equal"] = {k: v[0] for k, v in bits.items()}
    rep["not_bit_equal"] = {k: v[1] for k, v in bits.items()}
    # near-tie flips are reported but bounded (<= 1% of hits), not failed
    rep["pass"] = bool(
        rep["prim_idx_mismatches"] == 0 and rep["mat_id_mismatches"] == 0
        and rep["mat_type_mismatches"] == 0
        and rep["occluded_mismatches"] <= 0.01 * nh
        and rep["winner_near_tie_flips"] <= 0.01 * nh
        and rep["t_max_rel"] < 2e-4 and rep["normal_max_abs"] < 1e-3
        and rep["uv_max_abs"] < 2e-3 and rep["rgb_max_abs"] < 1e-5)
    return rep


def step_inputs(scene, hybrid, size=SIZE):
    """(cfg, params, sf, si) of one megakernel step from fresh camera rays
    at size x size: the regenerating mode's first carry (every lane dead,
    so the step regenerates it), or the hybrid mode's (every lane alive on
    its camera ray of sample 0)."""
    import torch

    from rtw_tpu_torch import RenderConfig
    from rtw_tpu_torch.integrator import qmega_carry
    from rtw_tpu_torch.ops import mega_kernel as MK

    cfg = RenderConfig(nx=size, ny=size, spp=1, max_depth=20)
    pix = torch.arange(size * size, dtype=torch.int32, device=scene.device)
    if hybrid:
        sf, si = qmega_carry(scene, cfg, pix.to(torch.int64), cfg.seed, 0)
    else:
        sf, si = MK.init_carry(pix, 0)
    return cfg, MK.mega_params(scene, cfg.seed, cfg, cfg.spp), sf, si


def check_step(scene, hybrid, step, plain_step):
    """One megakernel step through `step` against `plain_step` at
    `step_inputs`: lanes, lanes bit-equal, i32 lane mismatches, the f32
    rows' largest deviation on the other lanes, both ray counts, pass."""
    import torch

    cfg, params, sf, si = step_inputs(scene, hybrid)
    rays = [torch.zeros(1, dtype=torch.int64, device=sf.device)
            for _ in range(2)]
    k_sf, k_si = step(scene, cfg, sf, si, params, rays[0], hybrid)
    p_sf, p_si = plain_step(scene, cfg, sf, si, params, rays[1], hybrid)
    k_sf, k_si, p_sf, p_si = (t.cpu().numpy()
                              for t in (k_sf, k_si, p_sf, p_si))
    rk, rp = (int(r.item()) for r in rays)
    same = (k_si == p_si).all(axis=0)
    n_diff = int((~same).sum())
    err = np.abs(k_sf - p_sf)[:, same]
    bound = STEP_TOL + STEP_TOL * np.abs(p_sf)[:, same]
    n_bit, differ = _bit_equal(
        dict(zip(SF_ROWS + SI_ROWS, (*p_sf, *p_si))),
        dict(zip(SF_ROWS + SI_ROWS, (*k_sf, *k_si))), SF_ROWS + SI_ROWS)
    rep = {
        "n_lanes": int(same.size),
        "lanes_bit_equal": n_bit,
        "not_bit_equal": differ,
        "i32_lane_mismatches": n_diff,
        "f32_max_abs": float(err.max()) if err.size else 0.0,
        "rays": rk,
        "rays_plain": rp,
    }
    rep["pass"] = bool(
        np.isfinite(k_sf).all() and n_diff <= (1 - STEP_EQUAL) * same.size
        and (err <= bound).all()
        and abs(rk - rp) <= RAYS_PER_LANE * n_diff)
    return rep


def check_case(label, scene, scale, shift, steps=(), kernels=None,
               n=N_RAYS, seed=SEED):
    """One case: B and C (`kernels`, default the CUDA kernels) against the
    plain sweep on the reference tool's rays, then each step named in
    `steps` ("mega_step", "mega_step_hybrid") against the plain step."""
    kernels = kernels or cuda_kernels()
    plain = plain_kernels()
    rays = make_rays(n, seed, scale, shift, scene.n_vol)
    rep = compare(label, queries(scene, rays, plain.trace, plain.occluded),
                  queries(scene, rays, kernels.trace, kernels.occluded))
    for name in steps:
        rep[name] = check_step(scene, name == "mega_step_hybrid",
                               kernels.mega_step, plain.mega_step)
        rep["lanes_bit_equal"][name] = rep[name]["lanes_bit_equal"]
        rep["pass"] = rep["pass"] and rep[name]["pass"]
    return rep


def run_cases(cases=CASES, device="cuda", kernels=None, verbose=False):
    """Every case on `device` (the card unless the caller asks for the
    CPU; without CUDA the default raises): a list of reports."""
    from rtw_tpu_torch.models.scene import scene_device

    device = scene_device(device, "kernel_check")
    reports = []
    for label, src, scale, shift, steps in cases:
        rep = check_case(label, build_case_scene(src, device), scale, shift,
                         steps, kernels)
        if verbose:
            print(json.dumps(rep), flush=True)
        reports.append(rep)
    return reports


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    from rtw_tpu_torch.utils.profiling import card_line

    reports = run_cases(verbose=True)
    out = {"backend": "cuda", "card": card_line(),
           "all_pass": all(r["pass"] for r in reports), "cases": reports}
    path = argv[0] if argv else os.path.normpath(OUT)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}; all_pass={out['all_pass']}", file=sys.stderr)
    print(out["card"], flush=True)
    return 0 if out["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
