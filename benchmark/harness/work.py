"""The least time the card could take for a render's work: the bounds of
the roofline shares.

Counted from the cell's inputs (the image, the samples, the scene's
volume count) and from what the plain reference's paths did on its
checked pixels (`plainref.paths.Counts`), scaled to the image.  Nothing
here reads the program's tables, tree, launch count or kernel structure,
so the count stays the same whatever implements the render.

A bound is the larger of bytes over the HBM rate and f32 operations over
the f32 rate (NVIDIA's data sheet, H100 SXM, dense, at its 700 W limit).
Each input byte counts once and each output byte once.  The operations
are floors that hold for any acceleration structure: a ray that hits is
tested against at least its winner, and a ray that misses needs no test
(a structure may cull the whole scene); the draws and the shading
arithmetic are those the fixed estimator asks of each outcome.  So a
faster program never reads above 100%, and the shares read low.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations of one ray-primitive test by primitive kind (sphere,
# rect, moving sphere, volume sphere, volume box, box): the quadratic, the
# plane, the centre's lerp and the quadratic, the boundary test plus the
# free flight (|d|, clamps, log), the slabs
PRIM_TEST_OPS = (30, 14, 42, 70, 73, 33)
# the winner's point and unit normal
HIT_OPS = 16
# one uniform: two hashes of ~8 integer operations and the float step
DRAW_OPS = 19
# by material kind (lambertian, metal, dielectric, diffuse light,
# isotropic, normal): (draws, shading operations): the scatter direction
# and its pdf, the fuzzed mirror, Snell and Schlick, the emission, the
# sphere direction, the normal colour
MAT_WORK = ((2, 60), (3, 40), (1, 60), (0, 10), (2, 30), (0, 10))
# a path's camera ray: its key (two hashes), five draws, the thin lens
CAMERA_OPS = 16 + 5 * DRAW_OPS + 40
# a shadow query's light sample: three draws, the direction, the two pdfs,
# the MIS weight and the NEE term
SHADOW_OPS = 3 * DRAW_OPS + 50
# a query as an interface, whatever the layout: the ray (origin,
# direction, tmax, time: 8 floats) and its volume uniforms in; the
# nearest hit (t, primitive, u, v, normal: 7 words) or one visibility
# byte out
RAY_BYTES = 32
HIT_BYTES = 28
VISIBILITY_BYTES = 1
PIXEL_BYTES = 12


def scaled(counts: dict, samples: int) -> dict:
    """The reference's counts per path, times `samples` paths."""
    per = samples / max(counts["paths"], 1)
    return {"paths": samples, "traced": counts["traced"] * per,
            "shadow": counts["shadow"] * per,
            "hits_by_prim": [x * per for x in counts["hits_by_prim"]],
            "hits_by_mat": [x * per for x in counts["hits_by_mat"]]}


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def render_ops(w: dict) -> float:
    """The floor of the f32 operations of the paths `w` (`scaled`)."""
    ops = w["paths"] * CAMERA_OPS + w["shadow"] * SHADOW_OPS
    ops += sum(n * t for n, t in zip(w["hits_by_prim"], PRIM_TEST_OPS))
    ops += sum(w["hits_by_prim"]) * HIT_OPS
    ops += sum(n * (d * DRAW_OPS + s)
               for n, (d, s) in zip(w["hits_by_mat"], MAT_WORK))
    return ops


def render_bound_s(w: dict, n_pixels: int, renders: int) -> float:
    """A whole render's bound (the megakernel's work): the paths' floor
    operations, the image written once per render."""
    return bound_s(renders * n_pixels * PIXEL_BYTES, render_ops(w))


def query_bound_s(w: dict, n_vol: int) -> float:
    """The bound of the paths' ray queries alone (the split tier's trace
    and occlusion kernels): each query's ray in and answer out, and each
    hit's test of its winner."""
    ray_in = RAY_BYTES + 4 * max(n_vol, 1)
    n_bytes = (w["traced"] * (ray_in + HIT_BYTES)
               + w["shadow"] * (ray_in + VISIBILITY_BYTES))
    ops = sum(n * (t + HIT_OPS)
              for n, t in zip(w["hits_by_prim"], PRIM_TEST_OPS))
    return bound_s(n_bytes, ops)


# The denoised frame's filter (`plainref/denoise.py`): f32 operations of
# one à-trous tap at one pixel: the Weber scale (sum of both colours, 6),
# the colour distance over its square (10), its weight (the exponent,
# the exponential, the B3 product: 3), the albedo's and the normal's
# distance, exponential and product (11 each), the weighted colour and
# the weight accumulated (7)
ATROUS_TAP_OPS = 48
ATROUS_TAPS = 25
# a pass's weighted mean (3 divisions) at each pixel; the display
# transform before the first (a clamp and a power a channel)
ATROUS_PASS_OPS = 3
DISPLAY_OPS = 9
# a centre-of-pixel ray: s, t and the direction
GBUFFER_RAY_OPS = 19


def denoise_bound_s(hits_by_prim, n_pixels: int, iterations: int) -> float:
    """The bound of one frame's denoise: the first-hit G-buffer (a ray a
    pixel, each hit tested against its winner) and `iterations` à-trous
    passes of every tap at every pixel; the linear frame read once and
    the denoised frame written once."""
    ops = n_pixels * (GBUFFER_RAY_OPS + DISPLAY_OPS + iterations * (
        ATROUS_TAPS * ATROUS_TAP_OPS + ATROUS_PASS_OPS))
    ops += sum(n * (t + HIT_OPS) for n, t in zip(hits_by_prim,
                                                 PRIM_TEST_OPS))
    return bound_s(2 * n_pixels * PIXEL_BYTES, ops)
