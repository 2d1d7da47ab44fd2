// Device geometry shared by the CUDA kernels of this package: float3-style
// vectors, the 3x4 affine transforms of the props table, the primitive
// t-tests of rtw_tpu/ops/intersect.py for all six prim types (`prim_t`, and
// `sweep_rows` over a plan group's rows), the per-ray walk over a plan
// group's block hierarchy (`walk_blocks`, and `WalkCursor`, the same walk
// one candidate block at a time), the warp-shared walks on the cursor
// (`warp_nearest_hit`, `warp_any_hit`) and the winner's payload
// (`hit_payload`).
// Every expression follows the plain torch version's order of operations
// term by term, and the kernels are built with -fmad=false, so kernel and
// plain version round alike; the fused multiply-adds are explicit (fmaf),
// where the plain version fuses them too (intersect.fma: the reference's
// compiled CPU code fuses them).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace rtw {

constexpr float BIG = 1e30f;
constexpr float PI_F = 3.1415927410125732f;        // float32(pi)
constexpr float TWO_PI_F = 6.2831854820251465f;    // float32(2 pi)
constexpr float HALF_PI_F = 1.5707963705062866f;   // float32(pi / 2)

// prim types (rtw_tpu_torch/models/scene.py)
constexpr int PRIM_SPHERE = 0, PRIM_RECT = 1, PRIM_MOVING_SPHERE = 2,
              PRIM_VOLUME_SPHERE = 3, PRIM_VOLUME_BOX = 4, PRIM_BOX = 5;
// props columns (rtw_tpu_torch/ops/trace_kernel.py)
constexpr int C_MAT = 9, C_FUZZ = 10, C_ETA = 11, C_TEXT = 12, C_SCALE = 13,
              C_IMG = 14, C_RGB = 15, C_ODD = 18, C_EVEN = 21, C_MID = 24,
              C_W2O = 25, C_O2W = 37;
constexpr int PLAN_COLS = 7;   // start, count, size, ptype, axis, xform, block
constexpr int AABB_COLS = 8;   // lo xyz, hi xyz, 2 unused
// the per-group hierarchy rows (rtw_tpu_torch/ops/trace_kernel.py `hier`):
// levels, first block row, block count, then the table row of the first node
// of level L at column H_LEVEL0 + L
constexpr int WALK_SHIFT = 4;  // 16 children a node
constexpr int H_LEVELS = 0, H_FIRST = 1, H_BLOCKS = 2, H_LEVEL0 = 2,
              HIER_COLS = 7;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float length(V3 a) {
  return sqrtf(fmaxf(dot(a, a), 1e-30f));
}
__device__ __forceinline__ V3 normalized(V3 a) {
  return a * (1.0f / length(a));
}
__device__ __forceinline__ float max_component(V3 a) {
  return fmaxf(a.x, fmaxf(a.y, a.z));
}
__device__ __forceinline__ float comp(V3 a, int ax) {
  return ax == 0 ? a.x : (ax == 1 ? a.y : a.z);
}
__device__ __forceinline__ V3 load3(const float* p) {
  return {p[0], p[1], p[2]};
}
__device__ __forceinline__ float safe_sqrt(float x) {
  return sqrtf(fmaxf(x, 1e-20f));
}
// m: a row-major 3x4 affine
__device__ __forceinline__ V3 affine_point(const float* m, V3 p) {
  return {m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
          m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
          m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]};
}
__device__ __forceinline__ V3 affine_vec(const float* m, V3 v) {
  return {m[0] * v.x + m[1] * v.y + m[2] * v.z,
          m[4] * v.x + m[5] * v.y + m[6] * v.z,
          m[8] * v.x + m[9] * v.y + m[10] * v.z};
}
// normals transform with the transpose of the world->object matrix w
__device__ __forceinline__ V3 transpose_vec(const float* w, V3 n) {
  return {w[0] * n.x + w[4] * n.y + w[8] * n.z,
          w[1] * n.x + w[5] * n.y + w[9] * n.z,
          w[2] * n.x + w[6] * n.y + w[10] * n.z};
}
__device__ __forceinline__ float nonzero(float x) {
  return x == 0.0f ? 1e-30f : x;
}

// ---- primitive tests (rtw_tpu/ops/intersect.py) ---------------------------
__device__ __forceinline__ bool in_window(float t, float tmin, float tmax) {
  return t > tmin && t < tmax;
}

// u . w fused as intersect._fdot: fma(z, z', fma(x, x', y * y'))
__device__ __forceinline__ float fdot(V3 u, V3 w) {
  return fmaf(u.z, w.z, fmaf(u.x, w.x, u.y * w.y));
}

// o + d * t fused as intersect._ray_point
__device__ __forceinline__ V3 ray_point(V3 o, V3 d, float t) {
  return {fmaf(d.x, t, o.x), fmaf(d.y, t, o.y), fmaf(d.z, t, o.z)};
}

// intersect._sphere_roots, fused as there: whether the roots are real and,
// if they are, both roots (most tests miss: they stop before the root and
// the division)
__device__ __forceinline__ bool sphere_roots(V3 center, float radius, V3 o,
                                             V3 d, float* t1, float* t2) {
  V3 oc = o - center;
  float a = fdot(d, d);
  float b = fdot(oc, d);
  float c = fdot(oc, oc) - radius * radius;
  float disc = fmaf(b, b, -(a * c));
  if (!(disc >= 0.0f)) return false;
  float sq = safe_sqrt(disc);
  float inv_a = 1.0f / a;
  *t1 = (-b - sq) * inv_a;
  *t2 = (-b + sq) * inv_a;
  return true;
}

__device__ __forceinline__ float sphere_hit(V3 center, float radius, V3 o,
                                            V3 d, float tmin, float tmax) {
  float t1, t2;
  if (!sphere_roots(center, radius, o, d, &t1, &t2)) return BIG;
  return in_window(t1, tmin, tmax) ? t1
                                   : (in_window(t2, tmin, tmax) ? t2 : BIG);
}

// c0 + (c1 - c0) * frac, fused as intersect._moving_center
__device__ __forceinline__ V3 moving_center(const float* pr, float time) {
  float span = pr[8] - pr[7];
  float frac = span == 0.0f ? 0.0f : (time - pr[7]) / span;
  return {fmaf(pr[4] - pr[0], frac, pr[0]), fmaf(pr[5] - pr[1], frac, pr[1]),
          fmaf(pr[6] - pr[2], frac, pr[2])};
}

__device__ __forceinline__ float sphere_t(const float* pr, V3 o, V3 d,
                                          float tmin, float tmax) {
  return sphere_hit(load3(pr), pr[3], o, d, tmin, tmax);
}

__device__ float rect_t(const float* pr, int axis, V3 o, V3 d, float tmin,
                        float tmax) {
  int ia = axis == 0 ? 1 : 0;
  int ib = axis == 2 ? 1 : 2;
  float t = (pr[4] - comp(o, axis)) / nonzero(comp(d, axis));
  float pa = comp(o, ia) + t * comp(d, ia);
  float pb = comp(o, ib) + t * comp(d, ib);
  bool inside = pa >= pr[0] && pa <= pr[1] && pb >= pr[2] && pb <= pr[3];
  return inside && in_window(t, tmin, tmax) ? t : BIG;
}

// slab test of the box lo = b[0:3], hi = b[3:6] over the whole line
__device__ __forceinline__ void slab(const float* b, V3 o, V3 d, float* near,
                                     float* far) {
  float nr = -BIG, fr = BIG;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float inv = 1.0f / nonzero(comp(d, ax));
    float t0 = (b[ax] - comp(o, ax)) * inv;
    float t1 = (b[3 + ax] - comp(o, ax)) * inv;
    nr = fmaxf(nr, fminf(t0, t1));
    fr = fminf(fr, fmaxf(t0, t1));
  }
  *near = nr;
  *far = fr;
}

__device__ float box_t(const float* pr, V3 o, V3 d, float tmin, float tmax) {
  float near, far;
  slab(pr, o, d, &near, &far);
  if (!(near <= far)) return BIG;
  return in_window(near, tmin, tmax) ? near
                                     : (in_window(far, tmin, tmax) ? far : BIG);
}

// intersect._volume_t: a free-flight sample inside the boundary (near, far)
// from the uniform u, missed when it lands past the far boundary; the
// density guard keeps pad rows finite.  logf here and torch's CUDA log call
// the same libm function.
__device__ __forceinline__ float volume_t(float near, float far,
                                          float density, float u, float tmin,
                                          float tmax, float d_len) {
  float h1 = fmaxf(fmaxf(near, tmin), 0.0f);
  float h2 = fminf(far, tmax);
  float dist_inside = (h2 - h1) * d_len;
  float flight = -(1.0f / fmaxf(density, 1e-20f)) * logf(fmaxf(u, 1e-30f));
  if (!(h1 < h2 && flight <= dist_inside)) return BIG;
  return h1 + flight / d_len;
}

// |d| with d . d fused (intersect._ray_length)
__device__ __forceinline__ float ray_length(V3 d) {
  return sqrtf(fmaxf(fdot(d, d), 1e-30f));
}

__device__ __forceinline__ float volume_sphere_t(const float* pr, V3 o, V3 d,
                                                 float tmin, float tmax,
                                                 float u) {
  float t1, t2;
  if (!sphere_roots(load3(pr), pr[3], o, d, &t1, &t2)) return BIG;
  return volume_t(t1, t2, pr[4], u, tmin, tmax, ray_length(d));
}

__device__ __forceinline__ float volume_box_t(const float* pr, V3 o, V3 d,
                                              float tmin, float tmax,
                                              float u) {
  float near, far;
  slab(pr, o, d, &near, &far);
  if (!(near <= far)) return BIG;
  return volume_t(near, far, pr[6], u, tmin, tmax, ray_length(d));
}

__device__ __forceinline__ bool is_volume(int ptype) {
  return ptype == PRIM_VOLUME_SPHERE || ptype == PRIM_VOLUME_BOX;
}

// The t of props row `pr`, a prim of type kType, in (tmin, tmax), or BIG.
// `time` is the ray's shutter time (moving spheres); `u` the row's
// free-flight uniform (volumes).
template <int kType>
__device__ __forceinline__ float prim_t(const float* pr, int axis, bool xform,
                                        V3 o, V3 d, float time, float tmin,
                                        float tmax, float u) {
  if (xform) {
    o = affine_point(pr + C_W2O, o);
    d = affine_vec(pr + C_W2O, d);
  }
  if constexpr (kType == PRIM_SPHERE) {
    return sphere_t(pr, o, d, tmin, tmax);
  } else if constexpr (kType == PRIM_MOVING_SPHERE) {
    return sphere_hit(moving_center(pr, time), pr[3], o, d, tmin, tmax);
  } else if constexpr (kType == PRIM_RECT) {
    return rect_t(pr, axis, o, d, tmin, tmax);
  } else if constexpr (kType == PRIM_VOLUME_SPHERE) {
    return volume_sphere_t(pr, o, d, tmin, tmax, u);
  } else if constexpr (kType == PRIM_VOLUME_BOX) {
    return volume_box_t(pr, o, d, tmin, tmax, u);
  } else {
    return box_t(pr, o, d, tmin, tmax);
  }
}

template <int kType, int kStep, class RowU, class Visit>
__device__ __forceinline__ bool sweep_typed(const float* props, int kdim,
                                            int r0, int r1, int axis,
                                            bool xform, V3 o, V3 d,
                                            float time, float tmin,
                                            float tmax, RowU row_u,
                                            Visit visit) {
  for (int r = r0; r < r1; r += kStep) {
    float u = 0.0f;
    if constexpr (kType == PRIM_VOLUME_SPHERE || kType == PRIM_VOLUME_BOX)
      u = row_u(r);
    if (visit(r, prim_t<kType>(props + r * kdim, axis, xform, o, d, time,
                               tmin, tmax, u)))
      return true;
  }
  return false;
}

// Rows r0, r0 + kStep, ... below r1 of one plan group of type `ptype`,
// tested in row order: visit(r, t) gets each row's t and returns true to
// end the sweep (then sweep_rows returns true).  The loop is instantiated
// per type, as the reference's statically typed chunks are, so a group's
// rows run one straight-line test; row_u(r), the fetch of a volume row's
// free-flight uniform, is called for volume rows only.  kStep 32 is one
// lane's share of a block that its warp sweeps together.
template <int kStep = 1, class RowU, class Visit>
__device__ __forceinline__ bool sweep_rows(int ptype, const float* props,
                                           int kdim, int r0, int r1,
                                           int axis, bool xform, V3 o, V3 d,
                                           float time, float tmin,
                                           float tmax, RowU row_u,
                                           Visit visit) {
  switch (ptype) {
    case PRIM_SPHERE:
      return sweep_typed<PRIM_SPHERE, kStep>(props, kdim, r0, r1, axis,
                                             xform, o, d, time, tmin, tmax,
                                             row_u, visit);
    case PRIM_MOVING_SPHERE:
      return sweep_typed<PRIM_MOVING_SPHERE, kStep>(
          props, kdim, r0, r1, axis, xform, o, d, time, tmin, tmax, row_u,
          visit);
    case PRIM_RECT:
      return sweep_typed<PRIM_RECT, kStep>(props, kdim, r0, r1, axis, xform,
                                           o, d, time, tmin, tmax, row_u,
                                           visit);
    case PRIM_VOLUME_SPHERE:
      return sweep_typed<PRIM_VOLUME_SPHERE, kStep>(
          props, kdim, r0, r1, axis, xform, o, d, time, tmin, tmax, row_u,
          visit);
    case PRIM_VOLUME_BOX:
      return sweep_typed<PRIM_VOLUME_BOX, kStep>(
          props, kdim, r0, r1, axis, xform, o, d, time, tmin, tmax, row_u,
          visit);
    default:
      return sweep_typed<PRIM_BOX, kStep>(props, kdim, r0, r1, axis, xform,
                                          o, d, time, tmin, tmax, row_u,
                                          visit);
  }
}

// 1 / d per axis, with slab's rule for a zero component
__device__ __forceinline__ V3 inverse_dir(V3 d) {
  return {1.0f / nonzero(d.x), 1.0f / nonzero(d.y), 1.0f / nonzero(d.z)};
}

// The reference's _block_active: the world AABB `ab` can hold a hit in
// (tmin, tmax) nearer than `best_t`; `inv` is inverse_dir(d), so the test is
// slab's arithmetic without its divisions.  One rule for blocks and for
// every level above them.
__device__ __forceinline__ bool box_active(const float* ab, V3 o, V3 inv,
                                           float tmin, float tmax,
                                           float best_t) {
  float near = -BIG, far = BIG;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float t0 = (ab[ax] - comp(o, ax)) * comp(inv, ax);
    float t1 = (ab[3 + ax] - comp(o, ax)) * comp(inv, ax);
    near = fmaxf(near, fminf(t0, t1));
    far = fminf(far, fmaxf(t0, t1));
  }
  return far >= fmaxf(near, tmin) && near < tmax && near < best_t;
}

// One ray's walk over the blocks of one plan group, depth first over the
// group's hierarchy in index order (replaces the traversal of
// rtw_tpu/ops/trace_kernel.py::_walk_group; the table is
// rtw_tpu_torch/ops/trace_kernel.py::augment_aabbs).  `blocks` holds the
// block AABBs of the whole scene, `nodes` the upper nodes, whose row 0 is
// table row `node_base`; `hr` is the group's hier row.  Node j of level L
// spans blocks [j << 4L, (j + 1) << 4L) of the group; the ragged last node
// is cut by the group's block count.  A node or block is entered only if
// box_active passes against bound(), the caller's best t so far (BIG for
// an any-hit query); visit(b) sweeps block b of the group and returns true
// to end the walk (then walk_blocks returns true).
//
// The walk keeps no stack: at block b it tests the nodes that begin at b,
// from the highest such level down (their ancestors were entered on the way
// here), and a node that fails moves b past its span.  Index order with a
// strict `<` against bound() keeps the plain sweep's winner bit for bit: a
// later block can only win with a smaller t, and a skipped box holds no hit
// below the bound.  A parent's box is the float min / max of its children's
// and the slab arithmetic is monotone, so a parent never fails where a
// child would pass.  A flat group (levels 0) is the block loop alone.
template <class Bound, class Visit>
__device__ __forceinline__ bool walk_blocks(const float* blocks,
                                            const float* nodes,
                                            int node_base, const int* hr,
                                            V3 o, V3 d, float tmin,
                                            float tmax, Bound bound,
                                            Visit visit) {
  const int levels = hr[H_LEVELS], n_blocks = hr[H_BLOCKS];
  const float* ab = blocks + hr[H_FIRST] * AABB_COLS;
  const V3 inv = inverse_dir(d);
  for (int b = 0; b < n_blocks; ++b) {
    if (levels > 0 && (b & ((1 << WALK_SHIFT) - 1)) == 0) {
      // nodes begin only at multiples of 16: the highest level first
      int skip = 0;
      for (int lv = levels; lv >= 1 && skip == 0; --lv) {
        int shift = WALK_SHIFT * lv;
        if (b & ((1 << shift) - 1)) continue;   // no node of lv begins here
        int row = hr[H_LEVEL0 + lv] - node_base + (b >> shift);
        if (!box_active(nodes + row * AABB_COLS, o, inv, tmin, tmax,
                        bound()))
          skip = 1 << shift;
      }
      if (skip) {
        b += skip - 1;
        continue;
      }
    }
    if (box_active(ab + b * AABB_COLS, o, inv, tmin, tmax, bound()) &&
        visit(b))
      return true;
  }
  return false;
}

// What WalkCursor::step returns when the candidate it tested (or the node
// span it skipped) holds no block for the ray, and when every plan group is
// done.
constexpr int kWalkMiss = -1, kWalkDone = -2;

// walk_blocks over every plan group in plan order, one candidate block a
// call, for a caller that interleaves the walk with other work (the
// nearest-hit kernel's warp-shared sweeps): the plan entry and the next
// block of its group to consider.  step(bound) tests that block against
// `bound`, after the node tests that begin at it (a failed node skips its
// span, as in walk_blocks), moves past it, and returns its index in its
// group (the entry is `e`) if it passes, else kWalkMiss, or kWalkDone.
// Called with the caller's best t after each block's sweep, it tests
// exactly walk_blocks' nodes and blocks, in walk_blocks' order.
struct WalkCursor {
  int e, b;

  __device__ __forceinline__ int step(const float* blocks,
                                      const float* nodes, int node_base,
                                      const int* hier, int n_entries, V3 o,
                                      V3 inv, float tmin, float tmax,
                                      float bound) {
    for (; e < n_entries; ++e, b = 0) {
      const int* hr = hier + e * HIER_COLS;
      const int levels = hr[H_LEVELS];
      if (b >= hr[H_BLOCKS]) continue;
      const int at = b;
      if (levels > 0 && (at & ((1 << WALK_SHIFT) - 1)) == 0) {
        int skip = 0;     // as walk_blocks: the highest level first
        for (int lv = levels; lv >= 1 && skip == 0; --lv) {
          int shift = WALK_SHIFT * lv;
          if (at & ((1 << shift) - 1)) continue;
          int row = hr[H_LEVEL0 + lv] - node_base + (at >> shift);
          if (!box_active(nodes + row * AABB_COLS, o, inv, tmin, tmax,
                          bound))
            skip = 1 << shift;
        }
        if (skip) {
          b = at + skip;
          return kWalkMiss;
        }
      }
      b = at + 1;
      return box_active(blocks + (hr[H_FIRST] + at) * AABB_COLS, o, inv,
                        tmin, tmax, bound)
                 ? at
                 : kWalkMiss;
    }
    return kWalkDone;
  }
};

// ---- the warp-shared walk (the kernels B, C and D's nearest hit) ----------
//
// Every lane of a warp walks its own ray with a WalkCursor, one candidate
// block a step, so the lanes walk in step; the warp ballots the lanes whose
// candidate passed.  With kOwnSweepMin such lanes or more each sweeps its
// own block, all of them at once, as one thread a ray does.  Below that the
// warp sweeps each pending lane's block together, lowest lane first: the
// owner's ray, entry and block go to every lane by shuffles, and lane k tests
// rows b0 + k, b0 + k + 32, ... of it.  Threads without a ray (past the
// launch's lanes, dead lanes, lanes already answered) start or end with a
// done cursor and still take part in every ballot and shuffle, with the full
// mask.  The caller supplies where the tables live (SweepTables), a lane's
// tmax, and how a volume row's free-flight uniform is fetched for a ray:
// row_u(r, key) with the lane's `key`, and key_of(j), lane j's key on every
// lane (called by the whole warp), for the shared sweeps.

constexpr unsigned kFullMask = 0xffffffffu;

// What a warp-shared walk reads, in shared or global memory as the caller
// staged it: the props table [P, kdim], the block AABBs, the upper nodes
// (row 0 is table row n_blocks), the plan and the hier rows.
struct SweepTables {
  const float* props;
  const float* blocks;
  const float* nodes;
  const int* plan;
  const int* hier;
  int n_entries, n_blocks, kdim;
};

// (t, row) of every lane of the warp reduced to the lexicographic minimum,
// on every lane: the smallest t, and the lowest row among equal t.  Every
// t is below BIG or exactly BIG (no NaN), so the order is total and the
// butterfly gives every lane the same pair.
__device__ __forceinline__ void warp_min(float* t, int* row) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float t2 = __shfl_xor_sync(kFullMask, *t, off);
    int r2 = __shfl_xor_sync(kFullMask, *row, off);
    if (t2 < *t || (t2 == *t && r2 < *row)) {
      *t = t2;
      *row = r2;
    }
  }
}

__device__ __forceinline__ V3 shfl3(V3 v, int lane) {
  return {__shfl_sync(kFullMask, v.x, lane), __shfl_sync(kFullMask, v.y, lane),
          __shfl_sync(kFullMask, v.z, lane)};
}

// Nearest hit: (best t, best row) of the lane's ray over the groups in plan
// order, or (BIG, -1).  The plain sweep's winner is the first row, in plan
// and row order, that reaches the least t over the rows the walk does not
// cull: rows rise with plan entry and block, so that is the lexicographic
// minimum of (t, row), which warp_min computes block by block, and the owner
// takes it if its t beats the lane's best.  Each cursor culls against its
// own lane's best t after each of its blocks, exactly as the one-thread walk
// does, so the same blocks are swept and the winner is the same row.  An own
// sweep keeps rows in order with a strict `<`, as one thread a ray does.
template <int kOwnSweepMin, class Key, class KeyOf, class RowU>
__device__ __forceinline__ void warp_nearest_hit(
    const SweepTables& tb, bool live, V3 o, V3 d, float time, float tmin,
    float tmax, Key key, KeyOf key_of, RowU row_u, float* best_t,
    int* best_row) {
  const int lane = threadIdx.x & 31;
  const V3 inv = inverse_dir(d);
  float bt = BIG;
  int bi = -1;
  WalkCursor cur = {live ? 0 : tb.n_entries, 0};
  for (;;) {
    // every lane walks one candidate block; the warp leaves when all are
    // done, and sweeps the blocks that passed
    const int blk = cur.step(tb.blocks, tb.nodes, tb.n_blocks, tb.hier,
                             tb.n_entries, o, inv, tmin, tmax, bt);
    if (!__any_sync(kFullMask, blk != kWalkDone)) break;
    unsigned todo = __ballot_sync(kFullMask, blk >= 0);
    if (todo == 0) continue;
    if (__popc(todo) >= kOwnSweepMin) {
      // a nearly full warp: each pending lane sweeps its own block
      if (blk >= 0) {
        const int* en = tb.plan + cur.e * PLAN_COLS;
        int b0 = en[0] + blk * en[6];
        sweep_rows(en[3], tb.props, tb.kdim, b0,
                   min(b0 + en[6], en[0] + en[1]), en[4], en[5] != 0, o, d,
                   time, tmin, tmax, [&](int r) { return row_u(r, key); },
                   [&](int r, float t) {
                     if (t < bt) {
                       bt = t;
                       bi = r;
                     }
                     return false;
                   });
      }
    } else {
      // the warp sweeps each pending lane's block together, lowest lane
      // first: lane k tests rows b0 + k, b0 + k + 32, ... of lane j's block
      // on lane j's ray
      do {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const V3 oj = shfl3(o, j), dj = shfl3(d, j);
        const float time_j = __shfl_sync(kFullMask, time, j);
        const float tmax_j = __shfl_sync(kFullMask, tmax, j);
        const int e = __shfl_sync(kFullMask, cur.e, j);
        const int b = __shfl_sync(kFullMask, blk, j);
        const Key key_j = key_of(j);
        const int* en = tb.plan + e * PLAN_COLS;
        const int b0 = en[0] + b * en[6];
        const int b1 = min(b0 + en[6], en[0] + en[1]);  // past count: padding
        float t = BIG;
        int row = INT_MAX;
        sweep_rows<32>(
            en[3], tb.props, tb.kdim, b0 + lane, b1, en[4], en[5] != 0, oj,
            dj, time_j, tmin, tmax_j,
            [&](int r) { return row_u(r, key_j); },
            [&](int r, float tr) {
              if (tr < t) {        // rows rise: the lowest row of equal t
                t = tr;
                row = r;
              }
              return false;
            });
        warp_min(&t, &row);
        if (lane == j && t < bt) {
          bt = t;
          bi = row;
        }
      } while (todo);
    }
  }
  *best_t = bt;
  *best_row = bi;
}

// Any hit of the lane's ray in (tmin, tmax).  Each cursor walks with the
// bound BIG, so it culls the same nodes and blocks whatever was found
// before, and the answer is the OR over the rows of those blocks: any order
// of sweeping gives walk_blocks' answer.  An own sweep stops at its first
// hit, as one thread a ray does; a shared sweep goes a 32-row round at a
// time (lane k tests row b0 + k + 32 m in round m) and ballots the round's
// hits, ending the block at the first round that has one.  A lane that is
// occluded is done.
template <int kOwnSweepMin, class Key, class KeyOf, class RowU>
__device__ __forceinline__ bool warp_any_hit(const SweepTables& tb, bool live,
                                             V3 o, V3 d, float time,
                                             float tmin, float tmax, Key key,
                                             KeyOf key_of, RowU row_u) {
  const int lane = threadIdx.x & 31;
  const V3 inv = inverse_dir(d);
  bool occ = false;
  WalkCursor cur = {live ? 0 : tb.n_entries, 0};
  for (;;) {
    const int blk = cur.step(tb.blocks, tb.nodes, tb.n_blocks, tb.hier,
                             tb.n_entries, o, inv, tmin, tmax, BIG);
    if (!__any_sync(kFullMask, blk != kWalkDone)) break;
    unsigned todo = __ballot_sync(kFullMask, blk >= 0);
    if (todo == 0) continue;
    if (__popc(todo) >= kOwnSweepMin) {
      if (blk >= 0) {
        const int* en = tb.plan + cur.e * PLAN_COLS;
        int b0 = en[0] + blk * en[6];
        occ = sweep_rows(en[3], tb.props, tb.kdim, b0,
                         min(b0 + en[6], en[0] + en[1]), en[4], en[5] != 0, o,
                         d, time, tmin, tmax,
                         [&](int r) { return row_u(r, key); },
                         [](int, float t) { return t < BIG; });
      }
    } else {
      do {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const V3 oj = shfl3(o, j), dj = shfl3(d, j);
        const float time_j = __shfl_sync(kFullMask, time, j);
        const float tmax_j = __shfl_sync(kFullMask, tmax, j);
        const int e = __shfl_sync(kFullMask, cur.e, j);
        const int b = __shfl_sync(kFullMask, blk, j);
        const Key key_j = key_of(j);
        const int* en = tb.plan + e * PLAN_COLS;
        const int b0 = en[0] + b * en[6];
        const int b1 = min(b0 + en[6], en[0] + en[1]);  // past count: padding
        bool hit = false;
        for (int base = b0; base < b1 && !hit; base += 32) {  // warp-uniform
          // one row a lane: base + lane, if it is below b1
          const bool mine = sweep_rows<32>(
              en[3], tb.props, tb.kdim, base + lane, min(base + 32, b1),
              en[4], en[5] != 0, oj, dj, time_j, tmin, tmax_j,
              [&](int r) { return row_u(r, key_j); },
              [](int, float t) { return t < BIG; });
          hit = __any_sync(kFullMask, mine);
        }
        if (lane == j) occ = hit;
      } while (todo);
    }
    if (occ) cur.e = tb.n_entries;      // answered: the lane is done
  }
  return occ;
}

// The face of box `pr` that a hit at the entry (or, from inside, the exit)
// crosses, and its outward normal (intersect._box_payload): returns the
// face axis, or -1 when no axis attains the bound (normal 0).
__device__ int box_face(const float* pr, V3 o, V3 d, float tmin,
                        V3* normal) {
  float tns[3], tfs[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float inv = 1.0f / nonzero(comp(d, ax));
    float t0 = (pr[ax] - comp(o, ax)) * inv;
    float t1 = (pr[3 + ax] - comp(o, ax)) * inv;
    tns[ax] = fminf(t0, t1);
    tfs[ax] = fmaxf(t0, t1);
  }
  float near = fmaxf(fmaxf(tns[0], tns[1]), tns[2]);
  bool entry = near > tmin;
  int face = -1;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    bool is_near = tns[ax] >= fmaxf(tns[(ax + 1) % 3], tns[(ax + 2) % 3]);
    bool is_far = tfs[ax] <= fminf(tfs[(ax + 1) % 3], tfs[(ax + 2) % 3]);
    if (face < 0 && ((entry && is_near) || (!entry && is_far))) face = ax;
  }
  float n3[3] = {0.0f, 0.0f, 0.0f};
  if (face >= 0) {
    float d_sign = comp(d, face) >= 0.0f ? 1.0f : -1.0f;
    n3[face] = entry ? -d_sign : d_sign;
  }
  *normal = {n3[0], n3[1], n3[2]};
  return face;
}

// Exact spherical uv from the unit normal (intersect._sphere_uv).
__device__ __forceinline__ void sphere_uv(V3 n, float* u, float* v) {
  float phi = atan2f(n.z, n.x);
  float theta = asinf(fminf(fmaxf(n.y, -1.0f), 1.0f));
  *u = 1.0f - (phi + PI_F) / TWO_PI_F;
  *v = (theta + HALF_PI_F) / PI_F;
}

// (type, rect axis, has transform) of the plan group that holds `row`
__device__ __forceinline__ void group_of(const int* plan, int n_entries,
                                         int row, int* ptype, int* axis,
                                         bool* xform) {
  *ptype = 0;
  *axis = 0;
  *xform = false;
  for (int e = 0; e < n_entries; ++e) {
    const int* en = plan + e * PLAN_COLS;
    if (row >= en[0] && row < en[0] + en[2]) {
      *ptype = en[3];
      *axis = en[4];
      *xform = en[5] != 0;
    }
  }
}

// The winner's payload (intersect._winner_payload): world point, unit
// normal and, with kUV, uv of props row `pr` hit at t.  Volumes: a constant
// +X normal (transformed as any normal) and zero uv.
template <bool kUV>
__device__ void hit_payload(const float* pr, int ptype, int axis, bool xform,
                            V3 o, V3 d, float t, float time, float tmin,
                            V3* point_out, V3* normal_out, float* u_out,
                            float* v_out) {
  if (xform) {
    o = affine_point(pr + C_W2O, o);
    d = affine_vec(pr + C_W2O, d);
  }
  V3 point = ray_point(o, d, t);
  V3 normal = {0.0f, 0.0f, 0.0f};
  float u = 0.0f, v = 0.0f;
  if (ptype == PRIM_SPHERE || ptype == PRIM_MOVING_SPHERE) {
    V3 center = ptype == PRIM_MOVING_SPHERE ? moving_center(pr, time)
                                            : load3(pr);
    float r_safe = fabsf(pr[3]) > 1e-20f ? pr[3] : 1.0f;
    normal = (point - center) * (1.0f / r_safe);
    if (kUV) sphere_uv(normal, &u, &v);
  } else if (ptype == PRIM_RECT) {
    int ia = axis == 0 ? 1 : 0;
    int ib = axis == 2 ? 1 : 2;
    float sign = pr[6] > 0.5f ? -1.0f : 1.0f;
    normal = {axis == 0 ? sign : 0.0f, axis == 1 ? sign : 0.0f,
              axis == 2 ? sign : 0.0f};
    if (kUV) {
      u = (comp(point, ia) - pr[0]) / fmaxf(pr[1] - pr[0], 1e-20f);
      v = (comp(point, ib) - pr[2]) / fmaxf(pr[3] - pr[2], 1e-20f);
    }
  } else if (is_volume(ptype)) {
    normal = {1.0f, 0.0f, 0.0f};
  } else {
    int face = box_face(pr, o, d, tmin, &normal);
    if (kUV && face >= 0) {   // Z faces map (x, y), Y faces (x, z), X (y, z)
      int ia = face == 0 ? 1 : 0;
      int ib = face == 2 ? 1 : 2;
      u = (comp(point, ia) - pr[ia]) / fmaxf(pr[3 + ia] - pr[ia], 1e-20f);
      v = (comp(point, ib) - pr[ib]) / fmaxf(pr[3 + ib] - pr[ib], 1e-20f);
    }
  }
  if (xform) {
    point = affine_point(pr + C_O2W, point);
    normal = transpose_vec(pr + C_W2O, normal);
  }
  *point_out = point;
  *normal_out = normalized(normal);
  *u_out = u;
  *v_out = v;
}

}  // namespace rtw
