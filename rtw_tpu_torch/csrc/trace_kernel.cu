// Split-tier nearest-hit and any-hit kernels for Hopper (sm_90a), one
// thread per ray; the nearest-hit kernel's warps share their sweeps.
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
// Traversal: per ray, each plan group's blocks in index order through the
// walk of csrc/geometry.cuh (walk_blocks for the any-hit kernel; the same
// walk a candidate block at a time, WalkCursor, for the nearest hit).  A
// block is skipped when its world AABB slab test shows that the ray cannot
// reach it inside (tmin, tmax), or (nearest hit) not before the best t so
// far: the reference's _block_active cull.  A group of TWO_LEVEL_MIN blocks
// or more (ops/trace_kernel.py) has a hierarchy of levels of 16 over its
// blocks, and a node that fails the same test takes its whole span with
// it: what the reference's two-level _walk_group and its supers do for a
// 1024-ray tile, each ray here does for itself, over as many levels as the
// group needs.  The any-hit thread sweeps each block it reaches and returns
// at its first hit.
//
// The nearest hit sweeps a block with the whole warp.  At each step every
// lane tests its walk's next candidate block (WalkCursor::step: the node
// tests that begin there, then the block's own box), so the lanes walk in
// step; the warp ballots the lanes whose block passed and, for each in turn
// (lowest lane first), broadcasts that lane's ray and block; lane k tests
// rows b0 + k, b0 + k + 32, ... and keeps the first row of its least t; the
// warp reduces (t, row) to the lexicographic minimum, and the owning lane
// takes it if its t beats the lane's best.  The plain sweep's winner is the
// first row, in plan and row order, that reaches the least t over the rows
// the walk does not cull: rows rise with plan entry and block, so that is
// the lexicographic minimum of (t, row), which the reduction computes block
// by block; each lane's cursor culls against its own best t after each of
// its blocks, exactly as the one-thread walk did, so the same blocks are
// swept and the winner is the same row, its payload the same bits.  A step
// with kOwnSweepMin passing lanes or more has little to gain from sharing
// (each shared block costs the warp ~21 shuffles and the ballot on top of
// its rows): there each of those lanes sweeps its own block, in row order
// with a strict `<`, as one thread a ray does, all of them at once.  The
// sweep keeps only (best t, best row) and reads the winner's props row once
// after it (the TPU's one-hot winner fetch exists only because Mosaic has
// no per-lane gather).
//
// What bounds it on this card: not memory.  A ray reads 32 B (o, d, time,
// tmax) and writes 104 B (21 f32 + 5 i32 rows) or 1 B; the props table
// (scene 1: 640 rows x 25 floats, 64 KB; 262144 spheres: 26 MB, inside the
// 50 MB L2) is read as warp-wide broadcasts, or (a shared sweep) as 32
// consecutive rows.  The cost is the slab tests of the walk and the prim
// tests of the blocks each ray cannot cull, under divergence: lanes of a
// warp reach different numbers of blocks (the busiest lane of a warp needs
// 1.7-4.4x the prim tests of the mean lane at the paths' captured inputs,
// chip_smoke.py's replay), and one thread a ray sweeps as long as the
// busiest lane.  Shared sweeps cost the warp the mean lane's tests plus the
// shuffles, a pending block at a time.  The walk cuts the slab tests from
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
// block alone 23-74%.  The walk's slab tests stay per lane.  A volume's t
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
constexpr unsigned kFullMask = 0xffffffffu;
// trace_kernel: when at least this many lanes of a warp have a block to
// sweep at one step, each sweeps its own, as one thread a ray does; below
// it the warp sweeps them one by one together
constexpr int kOwnSweepMin = 20;
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

// What the walk reads: the block AABBs (shared or global), the upper nodes,
// the plan and the hier rows (shared).
struct Tables {
  const float* blocks;
  const float* nodes;
  const int* plan;
  const int* hier;
};

// Stage the tables in dynamic shared memory: [nodes][blocks, if
// kBlocksShared][plan][hier].  `aabbs` is the augmented table: n_blocks
// block rows, then n_nodes upper rows.
template <bool kBlocksShared>
__device__ __forceinline__ Tables stage(const float* aabbs, const int* plan,
                                        const int* hier,
                                        const TraceParams& p, float* smem) {
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
  return {kBlocksShared ? s_blocks : aabbs, s_nodes, s_plan, s_hier};
}

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
  Tables tb = stage<kBlocksShared>(aabbs, plan, hier, p, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // Threads past n stay to the end: every lane of a warp takes part in
  // each ballot and shuffle; they have no ray and no block.
  const bool valid = i < n;
  Ray ray = {};
  if (valid) ray = load_ray(rays, i, n);
  const V3 inv = inverse_dir(ray.d);

  // ---- nearest hit: (best t, best row) over the groups in plan order ----
  float bt = BIG;
  int bi = -1;
  WalkCursor cur = {valid ? 0 : p.n_entries, 0};
  for (;;) {
    // every lane walks one candidate block; the warp leaves when all are
    // done, and sweeps the blocks that passed
    const int blk = cur.step(tb.blocks, tb.nodes, p.n_blocks, tb.hier,
                             p.n_entries, ray.o, inv, p.tmin, ray.tmax, bt);
    if (!__any_sync(kFullMask, blk != kWalkDone)) break;
    unsigned todo = __ballot_sync(kFullMask, blk >= 0);
    if (todo == 0) continue;
    if (__popc(todo) >= kOwnSweepMin) {
      // a nearly full warp: each pending lane sweeps its own block
      if (blk >= 0) {
        const int* en = tb.plan + cur.e * PLAN_COLS;
        int b0 = en[0] + blk * en[6];
        sweep_rows(en[3], props, p.kdim, b0, min(b0 + en[6], en[0] + en[1]),
                   en[4], en[5] != 0, ray.o, ray.d, ray.time, p.tmin,
                   ray.tmax,
                   [&](int r) { return vol_u[max(vol_slot[r], 0) * n + i]; },
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
        const V3 o = shfl3(ray.o, j), d = shfl3(ray.d, j);
        const float time = __shfl_sync(kFullMask, ray.time, j);
        const float tmax = __shfl_sync(kFullMask, ray.tmax, j);
        const int e = __shfl_sync(kFullMask, cur.e, j);
        const int b = __shfl_sync(kFullMask, blk, j);
        const int owner = i - lane + j;      // lane j's ray index
        const int* en = tb.plan + e * PLAN_COLS;
        const int b0 = en[0] + b * en[6];
        const int b1 = min(b0 + en[6], en[0] + en[1]);  // past count: padding
        float t = BIG;
        int row = INT_MAX;
        sweep_rows<32>(
            en[3], props, p.kdim, b0 + lane, b1, en[4], en[5] != 0, o, d,
            time, p.tmin, tmax,
            [&](int r) { return vol_u[max(vol_slot[r], 0) * n + owner]; },
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
  Tables tb = stage<kBlocksShared>(aabbs, plan, hier, p, smem);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray ray = load_ray(rays, i, n);
  auto row_u = [&](int r) { return vol_u[max(vol_slot[r], 0) * n + i]; };

  bool occ = false;
  for (int e = 0; e < p.n_entries && !occ; ++e) {
    const int* en = tb.plan + e * PLAN_COLS;
    int start = en[0], end = en[0] + en[1], ptype = en[3], axis = en[4],
        block = en[6];
    bool xform = en[5] != 0;
    // first hit: the lane leaves
    occ = walk_blocks(
        tb.blocks, tb.nodes, p.n_blocks, tb.hier + e * HIER_COLS, ray.o,
        ray.d, p.tmin, ray.tmax, [] { return BIG; },
        [&](int b) {
          int b0 = start + b * block;
          return sweep_rows(ptype, props, p.kdim, b0, min(b0 + block, end),
                            axis, xform, ray.o, ray.d, ray.time, p.tmin,
                            ray.tmax, row_u,
                            [](int, float t) { return t < BIG; });
        });
  }
  out[i] = occ ? 1 : 0;
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
