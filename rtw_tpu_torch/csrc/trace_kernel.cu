// Split-tier nearest-hit and any-hit kernels for Hopper (sm_90a), one
// thread per ray.
//
// `trace_kernel` replaces rtw_tpu/ops/trace_kernel.py::_kernel_body ->
// _nearest_hit (launched by the pallas_call of _make_tracer.run): the
// nearest hit of each ray over the whole scene, its payload (world point,
// unit normal, uv) and the winner's shading record.  `occluded_kernel`
// replaces ::_occl_body -> _occl_sweep / _dyn_occl (the pallas_call of
// _make_occluder.run): an any-hit shadow test in (tmin, tmax) per ray.  Prim
// types: all six of csrc/geometry.cuh::prim_t (sphere, moving sphere at the
// ray's shutter time, axis rect, box, volume sphere and volume box), each
// with or without the 3x4 world->object transform.  A volume row reads its
// free-flight uniform from the wrapper's [max(n_vol, 1), N] rows, row
// max(vol_slot, 0) (the reference's _block_test); the occlusion query gets
// the shadow ray's own rows.  The plain versions are
// rtw_tpu_torch/ops/trace_kernel.py::trace_plain and ::occluded_plain; with
// -fmad=false and the same explicit fused multiply-adds the two round alike
// apart from libm (atan2f, asinf and logf here, torch's there).
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
// divergence (lanes of a warp cull different blocks).  A volume's t is
// never before its boundary's entry, so the cull stays exact for volumes;
// scene 4's radius-500 fog covers the scene, so its block is never culled
// and every ray pays one log per fog row.  A BVH per ray and the props
// table in shared memory are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "geometry.cuh"

using namespace rtw;

namespace {

constexpr int kBlock = 128;
constexpr int AABB_COLS = 8;   // lo xyz, hi xyz, 2 unused

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

__global__ void __launch_bounds__(kBlock)
    trace_kernel(const float* __restrict__ rays,
                 const float* __restrict__ vol_u,
                 const float* __restrict__ props, const int* __restrict__ plan,
                 const float* __restrict__ aabbs,
                 const int* __restrict__ vol_slot, float* __restrict__ of,
                 int* __restrict__ oi, int n, TraceParams p) {
  extern __shared__ float smem[];
  float* s_ab = smem;
  int* s_plan = reinterpret_cast<int*>(smem + p.n_blocks * AABB_COLS);
  stage(aabbs, plan, p, s_ab, s_plan);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray ray = load_ray(rays, i, n);
  // a volume row's free-flight uniform: row max(vol_slot, 0) of vol_u
  auto row_u = [&](int r) { return vol_u[max(vol_slot[r], 0) * n + i]; };

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
      sweep_rows(ptype, props, p.kdim, b0, b1, axis, xform, ray.o, ray.d,
                 ray.time, p.tmin, ray.tmax, row_u,
                 [&](int r, float t) {
                   if (t < bt) {
                     bt = t;
                     bi = r;
                   }
                   return false;
                 });
    }
  }

  // ---- payload of the winner (intersect._winner_payload) ----------------
  V3 point = {0.0f, 0.0f, 0.0f}, normal = {0.0f, 0.0f, 0.0f};
  float u = 0.0f, v = 0.0f;
  // a miss reads row 0's shading record, as the plain gather does
  const float* pr = props + max(bi, 0) * p.kdim;
  if (bi >= 0) {
    int ptype, axis;
    bool xform;
    group_of(s_plan, p.n_entries, bi, &ptype, &axis, &xform);
    hit_payload<true>(pr, ptype, axis, xform, ray.o, ray.d, bt, ray.time,
                      p.tmin, &point, &normal, &u, &v);
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
                    const float* __restrict__ vol_u,
                    const float* __restrict__ props,
                    const int* __restrict__ plan,
                    const float* __restrict__ aabbs,
                    const int* __restrict__ vol_slot,
                    uint8_t* __restrict__ out, int n, TraceParams p) {
  extern __shared__ float smem[];
  float* s_ab = smem;
  int* s_plan = reinterpret_cast<int*>(smem + p.n_blocks * AABB_COLS);
  stage(aabbs, plan, p, s_ab, s_plan);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray ray = load_ray(rays, i, n);
  auto row_u = [&](int r) { return vol_u[max(vol_slot[r], 0) * n + i]; };

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
      // first hit: the lane leaves
      occ = sweep_rows(ptype, props, p.kdim, b0, b1, axis, xform, ray.o,
                       ray.d, ray.time, p.tmin, ray.tmax, row_u,
                       [](int, float t) { return t < BIG; });
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
extern "C" int rtw_trace(const float* rays, const float* vol_u,
                         const float* props, const int* plan,
                         const float* aabbs, const int* vol_slot, float* of,
                         int* oi, int n, TraceParams p, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kBlock - 1) / kBlock;
  trace_kernel<<<blocks, kBlock, smem_bytes(p), (cudaStream_t)stream>>>(
      rays, vol_u, props, plan, aabbs, vol_slot, of, oi, n, p);
  return (int)cudaGetLastError();
}

extern "C" int rtw_occluded(const float* rays, const float* vol_u,
                            const float* props, const int* plan,
                            const float* aabbs, const int* vol_slot,
                            uint8_t* out, int n, TraceParams p,
                            void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kBlock - 1) / kBlock;
  occluded_kernel<<<blocks, kBlock, smem_bytes(p), (cudaStream_t)stream>>>(
      rays, vol_u, props, plan, aabbs, vol_slot, out, n, p);
  return (int)cudaGetLastError();
}

extern "C" const char* rtw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
