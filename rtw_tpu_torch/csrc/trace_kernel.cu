// Split-tier nearest-hit and any-hit kernels for Hopper (sm_90a), one
// thread per ray, whose warps share their sweeps.
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
// max(vol_slot, 0) (the reference's _block_test), in the column of the ray
// that owns the block (a shared sweep's lane tests another lane's ray); the
// occlusion query gets the shadow ray's own rows.  The plain versions are
// rtw_tpu_torch/ops/trace_kernel.py::trace_plain and ::occluded_plain; with
// -fmad=false and the same explicit fused multiply-adds the two round alike
// apart from libm (atan2f, asinf and logf here, torch's there).
//
// Traversal: per ray, each plan group's blocks in index order through the
// walk of csrc/geometry.cuh, a candidate block a step (WalkCursor).  A
// block is skipped when its world AABB slab test shows that the ray cannot
// reach it inside (tmin, tmax), or (nearest hit) not before the best t so
// far: the reference's _block_active cull.  A group of TWO_LEVEL_MIN blocks
// or more (ops/trace_kernel.py) has a hierarchy of levels of 16 over its
// blocks, and a node that fails the same test takes its whole span with
// it: what the reference's two-level _walk_group and its supers do for a
// 1024-ray tile, each ray here does for itself, over as many levels as the
// group needs.
//
// Both kernels are geometry.cuh's warp-shared walk (warp_nearest_hit,
// warp_any_hit): each step every lane tests its walk's next candidate (the
// node tests that begin there, then the block's own box), so the lanes walk
// in step; the warp ballots the lanes whose block passed and, below a
// threshold, sweeps each such block together (lane k tests rows b0 + k,
// b0 + k + 32, ... on the owner's ray), at or above it each lane sweeps its
// own.  The nearest hit reduces (t, row) to the lexicographic minimum, the
// plain sweep's winner, and each lane culls on its own best t; the any-hit
// walk culls on nothing but (tmin, tmax), so its answer is the OR over the
// rows of the blocks it reaches, in any order, and a shared sweep ends at
// the first 32-row round with a hit.  The sweep keeps only (best t, best
// row) and reads the winner's props row once after it (the TPU's one-hot
// winner fetch exists only because Mosaic has no per-lane gather).  An
// any-hit lane whose tmax <= tmin can pass no prim test: it starts done.
//
// What bounds it on this card: not memory.  A ray reads 32 B (o, d, time,
// tmax) and writes 104 B (21 f32 + 5 i32 rows) or 1 B; the props table
// (scene 1: 640 rows x 25 floats, 64 KB; 262144 spheres: 26 MB, inside the
// 50 MB L2) is read as warp-wide broadcasts, or (a shared sweep) as 32
// consecutive rows.  The cost is the slab tests of the walk and the prim
// tests of the blocks each ray cannot cull, under divergence: lanes of a
// warp reach different numbers of blocks (the busiest lane of a warp needs
// 1.7-4.4x the prim tests of the mean lane at the paths' captured inputs
// for the nearest hit, 6.7-8.0x for the any-hit query, whose lanes are
// mostly dead or stop early; chip_smoke.py's replay), and one thread a ray
// sweeps as long as the busiest lane.  Shared sweeps cost the warp the
// mean lane's tests plus the shuffles, a pending block at a time.  The walk cuts the slab tests from
// one per block to 16 per node entered; SceneBuilder's Morton order makes
// consecutive blocks neighbours, so a node's box is tight.  The step of
// one candidate and kOwnSweepMin = 20 come from two sweeps on an NVIDIA
// H100 80GB HBM3 (700.00 W) at the captured inputs of the split and scale
// paths (PERF.md): thresholds of 1 to 33 (never), with each lane walking on
// to its next passing block before the ballot, then thresholds of 12, 20
// and 28 with 1, 2, 4, 16 or any number of candidates a step.  One
// candidate and 20 had the least time summed over the seven paths.
// Walking on to the next block let the lanes drift apart (a flat
// 4096-block group ran 4.5x slower than one thread a ray); in the first
// sweep, sharing every block was 3-64% slower than 20, sweeping every
// block alone 23-74%.  kOcclOwnSweepMin = 16 comes from a third sweep, of
// 1, 4, 8, 12, 16, 20, 24 and 33, at the any-hit launch's captured inputs
// of scenes 2 and 4 and the lit 65536-sphere field on the same card: 16
// had the least summed time (0.562 ms; 12: 0.580, 20: 0.572; every block
// alone 1.996, every block shared 0.789; the one-thread walk 2.056).  The
// walk's slab tests stay per lane.  A volume's t
// is never before its boundary's entry, so the cull stays exact for
// volumes (their groups stay flat); scene 4's radius-500 fog covers the
// scene, so its block is never culled and every ray pays one log per fog
// row.
//
// Shared memory: the upper nodes, the plan and the hier rows always (272
// nodes, 8.7 KB, at 262144 spheres); the block AABBs too while they fit
// kBlocksSharedMax (16 KB, 512 blocks), else they are read from global
// memory through the L1/L2 (4096 blocks are 128 KB: staging them per
// 128-thread block would cost more than the walk reads).  Above 48 KB the
// launch opts in to large dynamic shared memory.  A front-to-back child
// order and the props table in shared memory are later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "geometry.cuh"

using namespace rtw;

namespace {

constexpr int kBlock = 128;
// When at least this many lanes of a warp have a block to sweep at one step,
// each sweeps its own, as one thread a ray does; below it the warp sweeps
// them one by one together: trace_kernel, occluded_kernel (the sweeps above)
constexpr int kOwnSweepMin = 20;
constexpr int kOcclOwnSweepMin = 16;
// block AABBs are staged in shared memory up to this many bytes
constexpr int kBlocksSharedMax = 16 * 1024;

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
  int n_entries, n_blocks, n_nodes, kdim;
};

namespace {

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

// Stage the tables in dynamic shared memory: [nodes][blocks, if
// kBlocksShared][plan][hier].  `aabbs` is the augmented table: n_blocks
// block rows, then n_nodes upper rows.  The walk reads the props from
// global memory.
template <bool kBlocksShared>
__device__ __forceinline__ SweepTables stage(const float* props,
                                             const float* aabbs,
                                             const int* plan, const int* hier,
                                             const TraceParams& p,
                                             float* smem) {
  const int n_nd = p.n_nodes * AABB_COLS, n_bl = p.n_blocks * AABB_COLS;
  float* s_nodes = smem;
  float* s_blocks = smem + n_nd;
  int* s_plan =
      reinterpret_cast<int*>(s_blocks + (kBlocksShared ? n_bl : 0));
  int* s_hier = s_plan + p.n_entries * PLAN_COLS;
  for (int k = threadIdx.x; k < n_nd; k += blockDim.x)
    s_nodes[k] = aabbs[n_bl + k];
  if (kBlocksShared)
    for (int k = threadIdx.x; k < n_bl; k += blockDim.x)
      s_blocks[k] = aabbs[k];
  for (int k = threadIdx.x; k < p.n_entries * PLAN_COLS; k += blockDim.x)
    s_plan[k] = plan[k];
  for (int k = threadIdx.x; k < p.n_entries * HIER_COLS; k += blockDim.x)
    s_hier[k] = hier[k];
  __syncthreads();
  return {props, kBlocksShared ? s_blocks : aabbs, s_nodes, s_plan, s_hier,
          p.n_entries, p.n_blocks, p.kdim};
}

template <bool kBlocksShared>
__global__ void __launch_bounds__(kBlock)
    trace_kernel(const float* __restrict__ rays,
                 const float* __restrict__ vol_u,
                 const float* __restrict__ props, const int* __restrict__ plan,
                 const float* __restrict__ aabbs,
                 const int* __restrict__ hier,
                 const int* __restrict__ vol_slot, float* __restrict__ of,
                 int* __restrict__ oi, int n, TraceParams p) {
  extern __shared__ float smem[];
  const SweepTables tb = stage<kBlocksShared>(props, aabbs, plan, hier, p,
                                              smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // Threads past n stay to the end: every lane of a warp takes part in
  // each ballot and shuffle; they have no ray and no block.
  const bool valid = i < n;
  Ray ray = {};
  if (valid) ray = load_ray(rays, i, n);

  // ---- nearest hit: (best t, best row) over the groups in plan order ----
  float bt;
  int bi;
  warp_nearest_hit<kOwnSweepMin>(
      tb, valid, ray.o, ray.d, ray.time, p.tmin, ray.tmax, i,
      [&](int j) { return i - lane + j; },   // lane j's ray index
      [&](int r, int ray_i) {
        return vol_u[max(vol_slot[r], 0) * n + ray_i];
      },
      &bt, &bi);
  if (!valid) return;

  // ---- payload of the winner (intersect._winner_payload) ----------------
  V3 point = {0.0f, 0.0f, 0.0f}, normal = {0.0f, 0.0f, 0.0f};
  float u = 0.0f, v = 0.0f;
  // a miss reads row 0's shading record, as the plain gather does
  const float* pr = props + max(bi, 0) * p.kdim;
  if (bi >= 0) {
    int ptype, axis;
    bool xform;
    group_of(tb.plan, p.n_entries, bi, &ptype, &axis, &xform);
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

template <bool kBlocksShared>
__global__ void __launch_bounds__(kBlock)
    occluded_kernel(const float* __restrict__ rays,
                    const float* __restrict__ vol_u,
                    const float* __restrict__ props,
                    const int* __restrict__ plan,
                    const float* __restrict__ aabbs,
                    const int* __restrict__ hier,
                    const int* __restrict__ vol_slot,
                    uint8_t* __restrict__ out, int n, TraceParams p) {
  extern __shared__ float smem[];
  const SweepTables tb = stage<kBlocksShared>(props, aabbs, plan, hier, p,
                                              smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // Threads past n stay to the end, as in trace_kernel; a dead lane (tmax
  // <= tmin: no prim test can pass) starts done.
  const bool valid = i < n;
  Ray ray = {};
  if (valid) ray = load_ray(rays, i, n);
  const bool occ = warp_any_hit<kOcclOwnSweepMin>(
      tb, valid && ray.tmax > p.tmin, ray.o, ray.d, ray.time, p.tmin, ray.tmax, i,
      [&](int j) { return i - lane + j; },   // lane j's ray index
      [&](int r, int ray_i) {
        return vol_u[max(vol_slot[r], 0) * n + ray_i];
      });
  if (valid) out[i] = occ ? 1 : 0;
}

bool blocks_shared(const TraceParams& p) {
  return sizeof(float) * (size_t)p.n_blocks * AABB_COLS <= kBlocksSharedMax;
}

size_t smem_bytes(const TraceParams& p) {
  size_t rows = (size_t)p.n_nodes + (blocks_shared(p) ? p.n_blocks : 0);
  return sizeof(float) * rows * AABB_COLS +
         sizeof(int) * (size_t)p.n_entries * (PLAN_COLS + HIER_COLS);
}

// Launch `kernel` with its dynamic shared memory, opted in above 48 KB.
// Returns cudaGetLastError() after the launch (0 on success); a refused
// launch never runs and must not pass silently.
template <class Kernel, class... Args>
int launch(Kernel kernel, int n, const TraceParams& p, cudaStream_t stream,
           Args... args) {
  size_t smem = smem_bytes(p);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = (n + kBlock - 1) / kBlock;
  kernel<<<blocks, kBlock, smem, stream>>>(args..., n, p);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of each kernel on `stream`; each returns `launch`'s code.
extern "C" int rtw_trace(const float* rays, const float* vol_u,
                         const float* props, const int* plan,
                         const float* aabbs, const int* hier,
                         const int* vol_slot, float* of, int* oi, int n,
                         TraceParams p, void* stream) {
  if (n <= 0) return 0;
  auto kernel = blocks_shared(p) ? trace_kernel<true> : trace_kernel<false>;
  return launch(kernel, n, p, (cudaStream_t)stream, rays, vol_u, props, plan,
                aabbs, hier, vol_slot, of, oi);
}

extern "C" int rtw_occluded(const float* rays, const float* vol_u,
                            const float* props, const int* plan,
                            const float* aabbs, const int* hier,
                            const int* vol_slot, uint8_t* out, int n,
                            TraceParams p, void* stream) {
  if (n <= 0) return 0;
  auto kernel =
      blocks_shared(p) ? occluded_kernel<true> : occluded_kernel<false>;
  return launch(kernel, n, p, (cudaStream_t)stream, rays, vol_u, props, plan,
                aabbs, hier, vol_slot, out);
}

extern "C" const char* rtw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
