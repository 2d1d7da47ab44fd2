// Split-tier nearest-hit and any-hit kernels for Hopper (sm_90a), one
// thread per ray.
//
// `trace_kernel` replaces rtw_tpu/ops/trace_kernel.py::_kernel_body ->
// _nearest_hit (launched by the pallas_call of _make_tracer.run): the
// nearest hit of each ray over the whole scene, its payload (world point,
// unit normal, uv) and the winner's shading record.  `occluded_kernel`
// replaces ::_occl_body -> _occl_sweep / _dyn_occl (the pallas_call of
// _make_occluder.run): an any-hit shadow test in (tmin, tmax) per ray.  Prim
// types: sphere, moving sphere (centre at the ray's shutter time), axis
// rect and box, each with or without the 3x4 world->object transform.
// Volumes are not here (the wrapper refuses a plan that holds them).  The
// plain versions are rtw_tpu_torch/ops/trace_kernel.py::trace_plain and
// ::occluded_plain; with -fmad=false and the same explicit fused
// multiply-adds the two round alike apart from libm (atan2f and asinf here,
// torch's there).
//
// Traversal: the scene's blocks in index order, each skipped when its world
// AABB slab test shows that the ray cannot reach it inside (tmin, tmax), or
// (nearest hit) not before the best t so far: the reference's _block_active
// cull.  Inside a block the rows are tested in order with a strict `<`, so
// the lowest index wins a tie, exactly the plain sweep's winner.  The TPU's
// front-to-back tile walk (_walk_group) and its two-level supers exist to
// cull whole 1024-ray tiles; here each ray culls for itself.  The sweep
// keeps only (best t, best row) and reads the winner's props row once after
// it (the TPU's one-hot winner fetch exists only because Mosaic has no
// per-lane gather).  The any-hit thread returns at its first hit.
//
// What bounds it on this card: not memory.  A ray reads 32 B (o, d, time,
// tmax) and writes 104 B (21 f32 + 5 i32 rows) or 1 B; the props table
// (scene 1: 640 rows x 25 floats, 64 KB) stays in L1/L2 and is read as
// warp-wide broadcasts when the lanes of a warp test the same block.  The
// cost is the prim tests of the blocks each ray cannot cull, under
// divergence (lanes of a warp cull different blocks).  A BVH per ray and
// the props table in shared memory are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "geometry.cuh"

using namespace rtw;

namespace {

constexpr int kBlock = 128;

// props columns (rtw_tpu_torch/ops/trace_kernel.py)
constexpr int C_MAT = 9, C_FUZZ = 10, C_ETA = 11, C_TEXT = 12, C_SCALE = 13,
              C_IMG = 14, C_RGB = 15, C_ODD = 18, C_EVEN = 21, C_MID = 24,
              C_W2O = 25, C_O2W = 37;
constexpr int PLAN_COLS = 7;   // start, count, size, ptype, axis, xform, block
constexpr int AABB_COLS = 8;   // lo xyz, hi xyz, 2 unused

constexpr int PRIM_SPHERE = 0, PRIM_RECT = 1, PRIM_MOVING_SPHERE = 2,
              PRIM_BOX = 5;

// output rows (rtw_tpu_torch/ops/trace_kernel.py HIT_F32 / HIT_I32)
constexpr int H_T = 0, H_POINT = 1, H_NORMAL = 4, H_U = 7, H_V = 8,
              H_FUZZ = 9, H_ETA = 10, H_SCALE = 11, H_RGB = 12, H_ODD = 15,
              H_EVEN = 18;
constexpr int HI_PRIM = 0, HI_MAT = 1, HI_TEX = 2, HI_IMG = 3, HI_MID = 4;

}  // namespace

// By-value launch parameters; mirrors _CTraceParams in
// rtw_tpu_torch/ops/trace_kernel.py (all members 4 bytes, no padding).
struct TraceParams {
  float tmin;
  int n_entries, n_blocks, kdim;
};

namespace {

// c0 + (c1 - c0) * frac, fused as intersect._moving_center
__device__ __forceinline__ V3 moving_center(const float* pr, float time) {
  float span = pr[8] - pr[7];
  float frac = span == 0.0f ? 0.0f : (time - pr[7]) / span;
  return {fmaf(pr[4] - pr[0], frac, pr[0]), fmaf(pr[5] - pr[1], frac, pr[1]),
          fmaf(pr[6] - pr[2], frac, pr[2])};
}

__device__ __forceinline__ float prim_t(const float* pr, int ptype, int axis,
                                        bool xform, V3 o, V3 d, float time,
                                        float tmin, float tmax) {
  if (xform) {
    o = affine_point(pr + C_W2O, o);
    d = affine_vec(pr + C_W2O, d);
  }
  if (ptype == PRIM_SPHERE) return sphere_t(pr, o, d, tmin, tmax);
  if (ptype == PRIM_MOVING_SPHERE)
    return sphere_hit(moving_center(pr, time), pr[3], o, d, tmin, tmax);
  if (ptype == PRIM_RECT) return rect_t(pr, axis, o, d, tmin, tmax);
  return box_t(pr, o, d, tmin, tmax);
}

// _block_active: the block's world AABB can hold a hit in (tmin, tmax)
// nearer than `best_t`
__device__ __forceinline__ bool block_active(const float* ab, V3 o, V3 d,
                                             float tmin, float tmax,
                                             float best_t) {
  float near, far;
  slab(ab, o, d, &near, &far);
  return far >= fmaxf(near, tmin) && near < tmax && near < best_t;
}

struct Ray {
  V3 o, d;
  float time, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int i, int n) {
  return {{rays[0 * n + i], rays[1 * n + i], rays[2 * n + i]},
          {rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]},
          rays[6 * n + i],
          rays[7 * n + i]};
}

// The block AABBs and the chunk plan into shared memory.
__device__ __forceinline__ void stage(const float* aabbs, const int* plan,
                                      const TraceParams& p, float* s_ab,
                                      int* s_plan) {
  for (int k = threadIdx.x; k < p.n_blocks * AABB_COLS; k += blockDim.x)
    s_ab[k] = aabbs[k];
  for (int k = threadIdx.x; k < p.n_entries * PLAN_COLS; k += blockDim.x)
    s_plan[k] = plan[k];
  __syncthreads();
}

// Exact spherical uv from the unit normal (intersect._sphere_uv).
__device__ __forceinline__ void sphere_uv(V3 n, float* u, float* v) {
  float phi = atan2f(n.z, n.x);
  float theta = asinf(fminf(fmaxf(n.y, -1.0f), 1.0f));
  *u = 1.0f - (phi + PI_F) / TWO_PI_F;
  *v = (theta + HALF_PI_F) / PI_F;
}

__global__ void __launch_bounds__(kBlock)
    trace_kernel(const float* __restrict__ rays,
                 const float* __restrict__ props, const int* __restrict__ plan,
                 const float* __restrict__ aabbs, float* __restrict__ of,
                 int* __restrict__ oi, int n, TraceParams p) {
  extern __shared__ float smem[];
  float* s_ab = smem;
  int* s_plan = reinterpret_cast<int*>(smem + p.n_blocks * AABB_COLS);
  stage(aabbs, plan, p, s_ab, s_plan);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray ray = load_ray(rays, i, n);

  // ---- nearest hit: (best t, best row) over the blocks in index order ----
  float bt = BIG;
  int bi = -1, bid = 0;
  for (int e = 0; e < p.n_entries; ++e) {
    const int* en = s_plan + e * PLAN_COLS;
    int start = en[0], end = en[0] + en[1], size = en[2], ptype = en[3],
        axis = en[4], block = en[6];
    bool xform = en[5] != 0;
    for (int b0 = start; b0 < start + size; b0 += block, ++bid) {
      if (!block_active(s_ab + bid * AABB_COLS, ray.o, ray.d, p.tmin,
                        ray.tmax, bt))
        continue;
      int b1 = min(b0 + block, end);   // rows past `count` are padding
      for (int r = b0; r < b1; ++r) {
        float t = prim_t(props + r * p.kdim, ptype, axis, xform, ray.o,
                         ray.d, ray.time, p.tmin, ray.tmax);
        if (t < bt) {
          bt = t;
          bi = r;
        }
      }
    }
  }

  // ---- payload of the winner (intersect._winner_payload) ----------------
  V3 point = {0.0f, 0.0f, 0.0f}, normal = {0.0f, 0.0f, 0.0f};
  float u = 0.0f, v = 0.0f;
  // a miss reads row 0's shading record, as the plain gather does
  const float* pr = props + max(bi, 0) * p.kdim;
  if (bi >= 0) {
    int ptype = 0, axis = 0;
    bool xform = false;
    for (int e = 0; e < p.n_entries; ++e) {
      const int* en = s_plan + e * PLAN_COLS;
      if (bi >= en[0] && bi < en[0] + en[2]) {
        ptype = en[3];
        axis = en[4];
        xform = en[5] != 0;
      }
    }
    V3 o = ray.o, d = ray.d;
    if (xform) {
      o = affine_point(pr + C_W2O, o);
      d = affine_vec(pr + C_W2O, d);
    }
    point = ray_point(o, d, bt);
    if (ptype == PRIM_SPHERE || ptype == PRIM_MOVING_SPHERE) {
      V3 center = ptype == PRIM_MOVING_SPHERE ? moving_center(pr, ray.time)
                                              : load3(pr);
      float r_safe = fabsf(pr[3]) > 1e-20f ? pr[3] : 1.0f;
      normal = (point - center) * (1.0f / r_safe);
      sphere_uv(normal, &u, &v);
    } else if (ptype == PRIM_RECT) {
      int ia = axis == 0 ? 1 : 0;
      int ib = axis == 2 ? 1 : 2;
      float sign = pr[6] > 0.5f ? -1.0f : 1.0f;
      normal = {axis == 0 ? sign : 0.0f, axis == 1 ? sign : 0.0f,
                axis == 2 ? sign : 0.0f};
      u = (comp(point, ia) - pr[0]) / fmaxf(pr[1] - pr[0], 1e-20f);
      v = (comp(point, ib) - pr[2]) / fmaxf(pr[3] - pr[2], 1e-20f);
    } else {
      int face = box_face(pr, o, d, p.tmin, &normal);
      if (face >= 0) {   // Z faces map (x, y), Y faces (x, z), X (y, z)
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
    normal = normalized(normal);
  }

  of[H_T * n + i] = bt;
  of[(H_POINT + 0) * n + i] = point.x;
  of[(H_POINT + 1) * n + i] = point.y;
  of[(H_POINT + 2) * n + i] = point.z;
  of[(H_NORMAL + 0) * n + i] = normal.x;
  of[(H_NORMAL + 1) * n + i] = normal.y;
  of[(H_NORMAL + 2) * n + i] = normal.z;
  of[H_U * n + i] = u;
  of[H_V * n + i] = v;
  of[H_FUZZ * n + i] = pr[C_FUZZ];
  of[H_ETA * n + i] = pr[C_ETA];
  of[H_SCALE * n + i] = pr[C_SCALE];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    of[(H_RGB + k) * n + i] = pr[C_RGB + k];
    of[(H_ODD + k) * n + i] = pr[C_ODD + k];
    of[(H_EVEN + k) * n + i] = pr[C_EVEN + k];
  }
  oi[HI_PRIM * n + i] = bi;
  oi[HI_MAT * n + i] = bi >= 0 ? (int)pr[C_MAT] : 0;
  oi[HI_TEX * n + i] = (int)pr[C_TEXT];
  oi[HI_IMG * n + i] = (int)pr[C_IMG];
  oi[HI_MID * n + i] = bi >= 0 ? (int)pr[C_MID] : 0;
}

__global__ void __launch_bounds__(kBlock)
    occluded_kernel(const float* __restrict__ rays,
                    const float* __restrict__ props,
                    const int* __restrict__ plan,
                    const float* __restrict__ aabbs,
                    uint8_t* __restrict__ out, int n, TraceParams p) {
  extern __shared__ float smem[];
  float* s_ab = smem;
  int* s_plan = reinterpret_cast<int*>(smem + p.n_blocks * AABB_COLS);
  stage(aabbs, plan, p, s_ab, s_plan);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray ray = load_ray(rays, i, n);

  bool occ = false;
  int bid = 0;
  for (int e = 0; e < p.n_entries && !occ; ++e) {
    const int* en = s_plan + e * PLAN_COLS;
    int start = en[0], end = en[0] + en[1], size = en[2], ptype = en[3],
        axis = en[4], block = en[6];
    bool xform = en[5] != 0;
    for (int b0 = start; b0 < start + size && !occ; b0 += block, ++bid) {
      if (!block_active(s_ab + bid * AABB_COLS, ray.o, ray.d, p.tmin,
                        ray.tmax, BIG))
        continue;
      int b1 = min(b0 + block, end);
      for (int r = b0; r < b1; ++r) {
        if (prim_t(props + r * p.kdim, ptype, axis, xform, ray.o, ray.d,
                   ray.time, p.tmin, ray.tmax) < BIG) {
          occ = true;   // first hit: the lane leaves
          break;
        }
      }
    }
  }
  out[i] = occ ? 1 : 0;
}

size_t smem_bytes(const TraceParams& p) {
  return sizeof(float) * (size_t)p.n_blocks * AABB_COLS +
         sizeof(int) * (size_t)p.n_entries * PLAN_COLS;
}

}  // namespace

// One launch of each kernel on `stream`.  Each returns cudaGetLastError()
// after the launch (0 on success); a refused launch never runs and must not
// pass silently.
extern "C" int rtw_trace(const float* rays, const float* props,
                         const int* plan, const float* aabbs, float* of,
                         int* oi, int n, TraceParams p, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kBlock - 1) / kBlock;
  trace_kernel<<<blocks, kBlock, smem_bytes(p), (cudaStream_t)stream>>>(
      rays, props, plan, aabbs, of, oi, n, p);
  return (int)cudaGetLastError();
}

extern "C" int rtw_occluded(const float* rays, const float* props,
                            const int* plan, const float* aabbs,
                            uint8_t* out, int n, TraceParams p,
                            void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kBlock - 1) / kBlock;
  occluded_kernel<<<blocks, kBlock, smem_bytes(p), (cudaStream_t)stream>>>(
      rays, props, plan, aabbs, out, n, p);
  return (int)cudaGetLastError();
}

extern "C" const char* rtw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
