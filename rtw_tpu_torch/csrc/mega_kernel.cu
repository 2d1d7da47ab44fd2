// Whole-bounce megakernel for Hopper (sm_90a), in two launch shapes over
// one lane-step body: `mega_trace_kernel`, one persistent launch per render
// (a pixel batch and an spp chunk) whose threads each hold one lane's path
// in registers, and `mega_kernel`, one wavefront iteration per launch on a
// carry in global memory (TPU kernel D's hybrid mode, and the step that
// chip_smoke.py holds against the plain twin).
//
// Replaces rtw_tpu/ops/mega_kernel.py::_mega_body (launched by the
// pallas_call of _make_mega.run), with the straight-line nearest-hit sweep
// rtw_tpu/ops/trace_kernel.py::_nearest_hit and any-hit sweep ::_occl_sweep
// inlined, as there, over all six prim types (csrc/geometry.cuh::prim_t),
// both through the per-ray block walk of csrc/geometry.cuh::walk_blocks.
// The template flag kHybrid is the same pallas_call with hybrid=True
// (mega_kernel.py:437, TPU kernel D, the queue-scheduled mode driven by
// rtw_tpu_torch/integrator.py::trace_wavefront_qmega): no regeneration, no
// accumulation, a dead lane's depth frozen; the queue's flush stays outside.
// Per lane: path hash, thin-lens regeneration of a finished lane, the
// fast-RNG bounce uniforms, nearest hit, checker albedo,
// rtw_tpu/ops/bounce.py::bounce_core (lambertian, metal, dielectric,
// isotropic, diffuse light, normal; single-light NEE + power-heuristic MIS
// with an early-exit shadow test), Russian roulette, NaN scrub and sample
// accumulation.  A volume row's free-flight uniform is drawn in the thread
// when the sweep meets the row: slot NUM_FIXED_SLOTS + max(vol_slot, 0) of
// the bounce's stream for the main ray, NUM_FIXED_SLOTS + n_vol + slot for
// the shadow ray, which is bit for bit the plain twin's uniform row, with
// no [2 n_vol, N] scratch (the TPU kernel's VMEM rows).  The plain torch
// twin is rtw_tpu_torch/ops/mega_kernel.py::mega_step_plain (one iteration)
// and ::mega_trace_plain (its loop until no lane is busy); every float
// operation here follows its order term by term, and the library is built
// with -fmad=false, so the two round alike apart from libm (cbrtf here,
// powf there; sinf/cosf/logf/sqrtf as torch's CUDA kernels call them).
//
// What bounded the per-iteration design on this card: the carry and the
// launches.  A launch ran one iteration of every lane: it read 17 f32 + 5
// i32 rows of carry and wrote them back (~176 B a lane, 113 MB at 640k
// lanes, 0.034 ms at 3.35 TB/s: 43% of the Cornell kernel's time at 1000
// spp), every one of its 5000 blocks staged the tables behind a barrier,
// the grid ran in ~6.3 waves with a ragged last one, and the host loop
// paid 5920 launches and a termination read every 8 (10.5% of the wall
// idle, 2.3% in the reads: PERF.md's profile).  Every lane was
// scheduled until the slowest finished, so late launches ran mostly dead
// warps.
//
// What the persistent design does about it: a thread's next iteration is
// the same code on the same values in the same lane, so the path never
// leaves the registers.  The grid is what stays resident (the occupancy
// calculator's blocks per SM, times the SMs); each block stages its tables
// once; thread g starts on lane g and, when its lane has run all its
// samples, writes the lane's 3 accumulated floats and pulls the next lane
// index from a device counter (lanes in index order, so a warp starts on
// 32 neighbouring pixels of a tile row).  Global memory sees 4 B of pixel
// id in and 12 B out per lane, one counter atomic per lane and one
// ray-count atomic per warp.  Every draw is keyed by (pixel, sample,
// depth) and one thread adds a lane's samples in sample order, so image
// and ray count equal the per-iteration loop's bit for bit.  The unit of
// work is a whole lane (splitting a pixel's samples would reorder its sum),
// so the cost is a tail: once the counter runs dry each thread finishes at
// most one lane while its SM empties.  The kernel stamps the device clock
// at its start, when the counter runs dry and at each warp's exit, so the
// tail is measured (ops/mega_kernel.py::trace_tail).
//
// What bounds it now: operations under divergence.  The sweeps (8 Cornell
// prims, twice with the shadow ray) and the shading run per lane under
// register pressure; the lanes of a warp take different material branches,
// miss or hit, and regenerate at different iterations, so a warp runs the
// union of its lanes' branches; and the tail.  In hybrid mode on a scene of
// hundreds of prims or more the sweeps dominate.  Tensor cores, wgmma and
// TMA have no work here: there is no matrix product and the tables are at
// most ~100 KB, staged once per resident block.
//
// The sweeps: both walk each plan group's blocks as the split kernels do
// (walk_blocks: the reference's _block_active cull per block, and for groups
// of TWO_LEVEL_MIN blocks or more the hierarchy of
// ops/trace_kernel.py::augment_aabbs, which the reference's megakernel
// passes to the same _nearest_hit / _occl_sweep); a scene of at most 8
// blocks (Cornell, scenes 3 and 5) keeps the straight-line sweep without
// box tests, the reference's _use_block_culls rule.  The sweep keeps only
// (best t, best index) live and reads the winner's props row once after
// the loop (the TPU's masked-accumulate and one-hot-matmul winner fetch
// exist only because Mosaic has no per-lane gather); each group's row loop
// is instantiated for its prim type; the any-hit test returns at its first
// hit; dead lanes skip the bounce; the material branches are real
// branches, not the TPU's evaluate-all-and-select.  The per-iteration
// kernel's carry rows keep the reference's [rows, N] layout, so each row
// access is coalesced.
//
// D's nearest hit over more than 8 blocks (scene 1, the fields) is the
// split trace kernel's warp-shared walk (geometry.cuh::warp_nearest_hit):
// each lane walks a candidate block a step and the warp sweeps the pending
// blocks together below kHybridOwnSweepMin of them, so a warp no longer
// waits for its busiest lane's sweeps.  It needs the whole warp at one point
// of control flow, so it runs before the alive branch, dead lanes and the
// threads past the carry's lanes with a done cursor; a shared sweep draws a
// volume row's uniform from the owner's bounce hash, which the warp
// shuffles with the ray.  Its winner is the per-lane walk's, row for row.
// Every other instantiation (A, and D over at most 8 blocks) keeps the
// per-lane sweeps; D's shadow test stays per lane too.
//
// Shared memory: the upper nodes, the plan and the hier rows always.  The
// props table, the volume slots and the block AABBs join them, read as
// warp-wide broadcasts, while everything together fits TABLES_SHARED_MAX of
// ops/mega_kernel.py (100 KB: two blocks an SM; Cornell 40 x 49 floats, 7.8
// KB; scene 1 640 x 25, 64 KB); a larger scene (2560 rows x 25 floats are
// 256 KB, over the card's 227 KB a block) reads those three from global
// memory through the L1/L2 instead of failing at launch.
// MegaParams::tables_shared carries the wrapper's decision, one byte count.
// Sorting lanes by material would take the path out of the registers
// again; it is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "geometry.cuh"
#include "rng.cuh"

using namespace rtw;

namespace {

constexpr int kBlock = 128;

// The persistent kernel's threads a block and its __launch_bounds__ minimum
// of blocks an SM.  256 threads, at least 4 blocks an SM (64 registers a
// thread, 32 resident warps an SM) was the fastest of 128/none, 128/8,
// 256/none and 256/4 on Cornell at 1000 spp (305.0/306.3 ms a render
// against 310.8/310.6 for 128/none, which holds 72 registers and 28 warps)
// and faster than 128/none on scene 3 (2.82-3.13 ms against 3.13-3.25) and
// the 16384-sphere field (42.7-43.2 against 49.7-49.9; 128/none's walk
// instantiation needs 94 registers, 20 warps), on an NVIDIA H100 80GB HBM3
// at 700.00 W (PERF.md).
constexpr int kTraceBlock = 256;
constexpr int kTraceMinBlocks = 4;
// D's walking nearest hit: when at least this many lanes of a warp have a
// block to sweep at one step each sweeps its own, else the warp sweeps them
// one by one together (csrc/geometry.cuh::warp_nearest_hit).  16 had the
// least summed time of 1, 8, 12, 16, 20, 24 and 33 at the hybrid launch's
// captured carries of scene 1 and the 16384-sphere field on an NVIDIA H100
// 80GB HBM3 at 700.00 W (1.382 ms; 12: 1.412, 20: 1.408; every block alone
// 2.863, every block shared 1.773; the one-thread walk 2.911; PERF.md).
constexpr int kHybridOwnSweepMin = 16;

// carry layout (rtw_tpu_torch/ops/mega_kernel.py)
constexpr int F_ORG = 0, F_DIR = 3, F_THR = 6, F_RAD = 9, F_ACC = 12,
              F_TIME = 15, F_PPDF = 16;
constexpr int I_ALIVE = 0, I_PREVD = 1, I_DEPTH = 2, I_SAMPLE = 3,
              I_PIXEL = 4;

// float parameter layout
constexpr int PF = 40;
constexpr int PF_CAM_ORG = 0, PF_LL = 3, PF_HOR = 6, PF_VERT = 9, PF_CU = 12,
              PF_CV = 15, PF_LENS = 18, PF_T0 = 19, PF_T1 = 20, PF_SKY = 21,
              PF_LPOS = 22, PF_LU = 25, PF_LV = 28, PF_LEMIT = 31,
              PF_LAREA = 34, PF_LNRM = 35;

constexpr int MAT_LAMBERTIAN = 0, MAT_METAL = 1, MAT_DIELECTRIC = 2,
              MAT_DIFFUSE_LIGHT = 3, MAT_ISOTROPIC = 4, MAT_NORMAL = 5;
constexpr int TEX_CHECKER = 1;
constexpr int U_SCATTER_0 = 0, U_SCATTER_1 = 1, U_SCATTER_2 = 2,
              U_DIELECTRIC = 3, U_LIGHT_A = 5, U_LIGHT_B = 6, U_RR = 7,
              NUM_FIXED_SLOTS = 8;

constexpr float INV_PI_F = 0.31830987334251404f;   // float32(1/pi)

}  // namespace

// The kernel's by-value parameters; mirrors _CParams in
// rtw_tpu_torch/ops/mega_kernel.py (all members 4 bytes, no padding).
struct MegaParams {
  float f[PF];
  float inv_nx, inv_ny, tmin, tmax, shadow_eps;
  uint32_t h0;
  int s_end, nx, ny, rr_start, max_depth;
  int n_entries, n_props, kdim;
  int num_lights, mat_present, checker, mis_bsdf_weight;
  int n_vol;   // max(scene.n_vol, 1): volume uniform rows per ray
  int n_blocks, n_nodes;   // rows of the AABB table: blocks, upper nodes
  int walk;                // walk the blocks with culls (more than 8 blocks)
  int tables_shared;       // props, volume slots and block AABBs in smem
  int s0;                  // first sample of a fresh lane (mega_trace)
};

namespace {

__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  return d - n * (2.0f * dot(d, n));
}
__device__ __forceinline__ float power_heuristic(float a, float b) {
  float t = a * a;
  return t / fmaxf(t + b * b, 1e-20f);
}
__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ V3 offset_point(V3 point, V3 normal, V3 out_dir) {
  float scale = 1e-4f * fmaxf(1.0f, max_component(
      {fabsf(point.x), fabsf(point.y), fabsf(point.z)}));
  float side = signf(dot(normal, out_dir));
  return point + normal * (scale * side);
}

// ---- fast RNG (rtw_tpu/utils/rng.py pcg_hash streams; rng.cuh) ----------
__device__ __forceinline__ float slot_u(uint32_t h, int slot) {
  return to_unit(pcg(pcg(h + (uint32_t)(slot + 1))));
}

// ---- sampling --------------------------------------------------------------
__device__ __forceinline__ V3 sphere_surface(float u1, float u2) {
  float z = 1.0f - 2.0f * u1;
  float r = safe_sqrt(1.0f - z * z);
  float phi = TWO_PI_F * u2;
  return {r * cosf(phi), r * sinf(phi), z};
}

// The free-flight uniform of props row r from the bounce stream hb: slot
// NUM_FIXED_SLOTS + base + max(vol_slot[r], 0), base 0 for the main ray and
// n_vol for the shadow ray (sweep_rows draws it for volume rows only).
__device__ __forceinline__ float row_u(const int* vol_slot, int r,
                                       uint32_t hb, int base) {
  return slot_u(hb, NUM_FIXED_SLOTS + base + max(vol_slot[r], 0));
}

// The scene's tables as a lane reads them: props, volume slots and block
// AABBs in shared or global memory, the upper nodes, the plan and the hier
// rows in shared memory.
struct Tables {
  const float* props;
  const int* vol_slot;
  const float* blocks;
  const float* nodes;
  const int* plan;
  const int* hier;
};

// Nearest hit over every real (unpadded) prim: the groups in plan order,
// strict < in row order, so the lowest index wins a tie, as the reference's
// argmin + strict merge.  With kWalk each group's blocks go through
// walk_blocks; without it (a scene of at most 8 blocks) each group's rows
// are swept straight through.  Rows past a group's `count` (pads: density 0
// and slot -1 on volumes) are never candidates.
template <bool kWalk>
__device__ int nearest_hit(const Tables& tb, const MegaParams& p, V3 o, V3 d,
                           float time, uint32_t hb, float* best_t) {
  float bt = BIG;
  int bi = -1;
  for (int e = 0; e < p.n_entries; ++e) {
    const int* en = tb.plan + e * PLAN_COLS;
    int start = en[0], end = en[0] + en[1], ptype = en[3], axis = en[4],
        block = en[6];
    bool xform = en[5] != 0;
    auto sweep = [&](int r0, int r1) {
      sweep_rows(ptype, tb.props, p.kdim, r0, r1, axis, xform, o, d, time,
                 p.tmin, p.tmax,
                 [&](int r) { return row_u(tb.vol_slot, r, hb, 0); },
                 [&](int r, float t) {
                   if (t < bt) {
                     bt = t;
                     bi = r;
                   }
                   return false;
                 });
      return false;
    };
    if constexpr (kWalk)
      walk_blocks(tb.blocks, tb.nodes, p.n_blocks, tb.hier + e * HIER_COLS, o,
                  d, p.tmin, p.tmax, [&] { return bt; }, [&](int b) {
                    int b0 = start + b * block;
                    return sweep(b0, min(b0 + block, end));
                  });
    else
      sweep(start, end);
  }
  *best_t = bt;
  return bi;
}

// Any hit in (tmin, tmax) of the shadow ray: returns at the first one.
template <bool kWalk>
__device__ bool occluded(const Tables& tb, const MegaParams& p, V3 o, V3 d,
                         float time, uint32_t hb, float tmin, float tmax) {
  for (int e = 0; e < p.n_entries; ++e) {
    const int* en = tb.plan + e * PLAN_COLS;
    int start = en[0], end = en[0] + en[1], ptype = en[3], axis = en[4],
        block = en[6];
    bool xform = en[5] != 0;
    auto sweep = [&](int r0, int r1) {
      return sweep_rows(
          ptype, tb.props, p.kdim, r0, r1, axis, xform, o, d, time, tmin,
          tmax, [&](int r) { return row_u(tb.vol_slot, r, hb, p.n_vol); },
          [](int, float t) { return t < BIG; });
    };
    bool hit;
    if constexpr (kWalk)
      hit = walk_blocks(tb.blocks, tb.nodes, p.n_blocks,
                        tb.hier + e * HIER_COLS, o, d, tmin, tmax,
                        [] { return BIG; }, [&](int b) {
                          int b0 = start + b * block;
                          return sweep(b0, min(b0 + block, end));
                        });
    else
      hit = sweep(start, end);
    if (hit) return true;
  }
  return false;
}

__device__ __forceinline__ float scrub(float x) {
  return (x == x && fabsf(x) < 3.0e37f) ? x : 0.0f;
}

// One lane's path: the carry's rows, held in registers.
struct Lane {
  V3 org, dir, thr, rad, acc;
  float time, prev_pdf;
  bool alive, prevd;
  int depth, sample, pixel;
};

// Lane i of the carry [rows, n].
__device__ __forceinline__ Lane load_lane(int i, int n,
                                          const float* __restrict__ sf,
                                          const int* __restrict__ si) {
  Lane l;
  l.org = {sf[(F_ORG + 0) * n + i], sf[(F_ORG + 1) * n + i],
           sf[(F_ORG + 2) * n + i]};
  l.dir = {sf[(F_DIR + 0) * n + i], sf[(F_DIR + 1) * n + i],
           sf[(F_DIR + 2) * n + i]};
  l.thr = {sf[(F_THR + 0) * n + i], sf[(F_THR + 1) * n + i],
           sf[(F_THR + 2) * n + i]};
  l.rad = {sf[(F_RAD + 0) * n + i], sf[(F_RAD + 1) * n + i],
           sf[(F_RAD + 2) * n + i]};
  l.acc = {sf[(F_ACC + 0) * n + i], sf[(F_ACC + 1) * n + i],
           sf[(F_ACC + 2) * n + i]};
  l.time = sf[F_TIME * n + i];
  l.prev_pdf = sf[F_PPDF * n + i];
  l.alive = si[I_ALIVE * n + i] > 0;
  l.prevd = si[I_PREVD * n + i] > 0;
  l.depth = si[I_DEPTH * n + i];
  l.sample = si[I_SAMPLE * n + i];
  l.pixel = si[I_PIXEL * n + i];
  return l;
}

__device__ __forceinline__ void store_lane(int i, int n, const Lane& l,
                                           float* __restrict__ osf,
                                           int* __restrict__ osi) {
  osf[(F_ORG + 0) * n + i] = l.org.x;
  osf[(F_ORG + 1) * n + i] = l.org.y;
  osf[(F_ORG + 2) * n + i] = l.org.z;
  osf[(F_DIR + 0) * n + i] = l.dir.x;
  osf[(F_DIR + 1) * n + i] = l.dir.y;
  osf[(F_DIR + 2) * n + i] = l.dir.z;
  osf[(F_THR + 0) * n + i] = l.thr.x;
  osf[(F_THR + 1) * n + i] = l.thr.y;
  osf[(F_THR + 2) * n + i] = l.thr.z;
  osf[(F_RAD + 0) * n + i] = l.rad.x;
  osf[(F_RAD + 1) * n + i] = l.rad.y;
  osf[(F_RAD + 2) * n + i] = l.rad.z;
  osf[(F_ACC + 0) * n + i] = l.acc.x;
  osf[(F_ACC + 1) * n + i] = l.acc.y;
  osf[(F_ACC + 2) * n + i] = l.acc.z;
  osf[F_TIME * n + i] = l.time;
  osf[F_PPDF * n + i] = l.prev_pdf;
  osi[I_ALIVE * n + i] = l.alive ? 1 : 0;
  osi[I_PREVD * n + i] = l.prevd ? 1 : 0;
  osi[I_DEPTH * n + i] = l.depth;
  osi[I_SAMPLE * n + i] = l.sample;
  osi[I_PIXEL * n + i] = l.pixel;
}

// A lane before its first iteration (ops/mega_kernel.py::init_carry): dead,
// its sample cursor at s0, so the first step regenerates it.
__device__ __forceinline__ Lane fresh_lane(int pixel, int s0) {
  Lane l;
  l.org = l.dir = l.thr = l.rad = l.acc = {0.0f, 0.0f, 0.0f};
  l.time = 0.0f;
  l.prev_pdf = 1.0f;
  l.alive = l.prevd = false;
  l.depth = 0;
  l.sample = s0;
  l.pixel = pixel;
  return l;
}

// One wavefront iteration of a lane, on registers only; returns the rays it
// traced.
template <bool kHybrid, bool kWalk>
__device__ __forceinline__ unsigned lane_step(Lane& lane, const Tables& tb,
                                              const MegaParams& p) {
  const float* f = p.f;
  V3 org = lane.org, dir = lane.dir, thr = lane.thr, rad = lane.rad,
     acc = lane.acc;
  float time = lane.time;
  float prev_pdf = lane.prev_pdf;
  bool alive = lane.alive;
  bool prevd = lane.prevd;
  int depth = lane.depth;
  int sample = lane.sample;
  int pixel = lane.pixel;

  uint32_t pk = pcg(pcg(p.h0 + (uint32_t)sample) + (uint32_t)pixel);
  unsigned rays = 0;

  // ---- regeneration: thin-lens camera ray for the lane's next sample ----
  if (!kHybrid && !alive && sample < p.s_end) {
    uint32_t hc = pcg(pk + CAM_OFF);
    float cu0 = slot_u(hc, 0), cu1 = slot_u(hc, 1), cu2 = slot_u(hc, 2),
          cu3 = slot_u(hc, 3), cu4 = slot_u(hc, 4);
    float s_img = ((float)(pixel % p.nx) + cu0) * p.inv_nx;
    float t_img = ((float)(pixel / p.nx) + cu1) * p.inv_ny;
    float a = cu2 * 2.0f * PI_F;
    float r = safe_sqrt(cu3);
    float rdx = sinf(a) * r, rdy = cosf(a) * r;
    float lens = f[PF_LENS];
    org = load3(f + PF_CAM_ORG) + load3(f + PF_CU) * (lens * rdx) +
          load3(f + PF_CV) * (lens * rdy);
    dir = load3(f + PF_LL) + load3(f + PF_HOR) * s_img +
          load3(f + PF_VERT) * t_img - org;
    time = f[PF_T0] + cu4 * (f[PF_T1] - f[PF_T0]);
    thr = {1.0f, 1.0f, 1.0f};
    rad = {0.0f, 0.0f, 0.0f};
    prev_pdf = 1.0f;
    prevd = false;
    depth = 0;
    alive = true;
  }

  // D walking (the hybrid mode over more than 8 blocks): the warp's shared
  // nearest hit, which every thread of the warp enters, dead lanes with a
  // done cursor; a volume row's uniform comes from the owner's bounce hash
  float shared_t = BIG;
  int shared_bi = -1;
  if constexpr (kHybrid && kWalk) {
    const uint32_t hb = pcg(pk + (uint32_t)(depth + 1) * GOLDEN);
    warp_nearest_hit<kHybridOwnSweepMin>(
        {tb.props, tb.blocks, tb.nodes, tb.plan, tb.hier, p.n_entries,
         p.n_blocks, p.kdim},
        alive, org, dir, time, p.tmin, p.tmax, hb,
        [&](int j) { return __shfl_sync(kFullMask, hb, j); },
        [&](int r, uint32_t h) { return row_u(tb.vol_slot, r, h, 0); },
        &shared_t, &shared_bi);
  }

  bool still = false;
  if (alive) {
    rays = 1;
    uint32_t hb = pcg(pk + (uint32_t)(depth + 1) * GOLDEN);
    float best_t;
    int bi;
    if constexpr (kHybrid && kWalk) {
      best_t = shared_t;
      bi = shared_bi;
    } else {
      bi = nearest_hit<kWalk>(tb, p, org, dir, time, hb, &best_t);
    }
    bool hit = bi >= 0;
    V3 du = normalized(dir);

    if (!hit) {
      // sky gradient, gated by the scene's sky flag
      float sky_t = 0.5f * (du.y + 1.0f);
      float g = f[PF_SKY];
      V3 sky = {(1.0f - 0.5f * sky_t) * g, (1.0f - 0.3f * sky_t) * g,
                1.0f * g};
      rad = rad + thr * sky;
    } else {
      const float* pr = tb.props + bi * p.kdim;
      int ptype, axis;
      bool xform;
      group_of(tb.plan, p.n_entries, bi, &ptype, &axis, &xform);
      V3 point, nrm;
      float uu, vv;
      hit_payload<false>(pr, ptype, axis, xform, org, dir, best_t, time,
                         p.tmin, &point, &nrm, &uu, &vv);
      int mat = (int)pr[C_MAT];
      V3 albedo = load3(pr + C_RGB);
      if (p.checker && (int)pr[C_TEXT] == TEX_CHECKER) {
        float sines = sinf(10.0f * point.x) * sinf(10.0f * point.y) *
                      sinf(10.0f * point.z);
        albedo = sines < 0.0f ? load3(pr + C_ODD) : load3(pr + C_EVEN);
      }
      int mp = p.mat_present;
      bool is_lamb = (mp >> MAT_LAMBERTIAN & 1) && mat == MAT_LAMBERTIAN;
      bool is_iso = (mp >> MAT_ISOTROPIC & 1) && mat == MAT_ISOTROPIC;

      V3 scatter = du;
      V3 att = albedo;
      bool cancel = false, terminate = false;
      float lamb_pdf = 1.0f;

      if (is_lamb) {
        V3 w = normalized(nrm);
        bool big_x = fabsf(w.x) > 0.9f;
        V3 av = {big_x ? 0.0f : 1.0f, big_x ? 1.0f : 0.0f, 0.0f};
        V3 v = normalized(cross(w, av));
        V3 u = cross(w, v);
        float u1 = slot_u(hb, U_SCATTER_0), u2 = slot_u(hb, U_SCATTER_1);
        float phi = TWO_PI_F * u1;
        float sr2 = safe_sqrt(u2);
        V3 local = {cosf(phi) * sr2, sinf(phi) * sr2, safe_sqrt(1.0f - u2)};
        V3 ldir = normalized(u * local.x + v * local.y + w * local.z);
        lamb_pdf = local.z * INV_PI_F;
        float scatter_pdf = dot(nrm, ldir) * INV_PI_F;
        cancel = lamb_pdf <= 0.0f || scatter_pdf <= 0.0f;
        scatter = ldir;
      } else if ((mp >> MAT_METAL & 1) && mat == MAT_METAL) {
        V3 refl = reflect(du, nrm);
        V3 ball = sphere_surface(slot_u(hb, U_SCATTER_0),
                                 slot_u(hb, U_SCATTER_1)) *
                  cbrtf(fmaxf(slot_u(hb, U_SCATTER_2), 1e-30f));
        V3 mdir = normalized(refl + ball * pr[C_FUZZ]);
        cancel = dot(mdir, nrm) <= 0.0f;
        scatter = mdir;
      } else if ((mp >> MAT_DIELECTRIC & 1) && mat == MAT_DIELECTRIC) {
        float eta = pr[C_ETA];
        bool outside = dot(du, nrm) < 0.0f;
        V3 ln = outside ? nrm : -nrm;
        float eta_i = outside ? 1.0f : eta;
        float eta_t = outside ? eta : 1.0f;
        float ratio = eta_i / eta_t;
        float cos_i = fminf(dot(-du, ln), 1.0f);
        float sin_i = safe_sqrt(1.0f - cos_i * cos_i);
        bool tir = ratio * sin_i > 1.0f;
        float r0 = (eta_i - eta_t) / (eta_i + eta_t);
        r0 = r0 * r0;
        float m = fminf(fmaxf(1.0f - cos_i, 0.0f), 1.0f);
        float m2 = m * m;
        float reflect_prob = r0 + (1.0f - r0) * (m * (m2 * m2));
        bool do_reflect = tir || slot_u(hb, U_DIELECTRIC) < reflect_prob;
        if (do_reflect) {
          scatter = reflect(du, ln);
        } else {
          float sin_t = fminf(ratio * sin_i, 1.0f);
          float cos_t = safe_sqrt(1.0f - sin_t * sin_t);
          scatter = (du + ln * cos_i) * ratio - ln * cos_t;
        }
        att = {1.0f, 1.0f, 1.0f};
      } else if (is_iso) {
        scatter = sphere_surface(slot_u(hb, U_SCATTER_0),
                                 slot_u(hb, U_SCATTER_1));
      } else if ((mp >> MAT_DIFFUSE_LIGHT & 1) && mat == MAT_DIFFUSE_LIGHT) {
        bool facing = dot(nrm, du) < 0.0f;
        V3 emitted = facing ? albedo : V3{0.0f, 0.0f, 0.0f};
        float w_bsdf = 1.0f;
        if (p.mis_bsdf_weight && p.num_lights > 0 && prevd) {
          // one-sided solid-angle pdf of NEE sampling this direction
          V3 dv = point - org;
          float dist2 = dot(dv, dv);
          float cos_t2 = -dot(du, load3(f + PF_LNRM));
          float lp = cos_t2 > 1e-6f ? dist2 / (f[PF_LAREA] * cos_t2) : 0.0f;
          w_bsdf = power_heuristic(prev_pdf, lp);
        }
        rad = rad + thr * emitted * w_bsdf;
        att = {0.0f, 0.0f, 0.0f};
        terminate = true;
      } else if ((mp >> MAT_NORMAL & 1) && mat == MAT_NORMAL) {
        rad = rad + thr * (nrm * 0.5f + V3{0.5f, 0.5f, 0.5f});
        att = {0.0f, 0.0f, 0.0f};
        terminate = true;
      }
      terminate = terminate || cancel;

      // ---- next-event estimation toward the scene's one light -----------
      if (p.num_lights > 0 && is_lamb && !cancel) {
        V3 lpos = load3(f + PF_LPOS) +
                  load3(f + PF_LU) * slot_u(hb, U_LIGHT_A) +
                  load3(f + PF_LV) * slot_u(hb, U_LIGHT_B);
        V3 ldir = lpos - point;
        float ldist = length(ldir);
        V3 ldir_u = ldir * (1.0f / fmaxf(ldist, 1e-12f));
        float costa = dot(-ldir_u, load3(f + PF_LNRM));
        float bsdf_pdf = fmaxf(dot(ldir_u, nrm), 0.0f) * INV_PI_F;
        if (ldist > 1e-6f && costa > 1e-6f && bsdf_pdf > 0.0f) {
          rays += 1;
          float l_pdf = ldist * ldist /
                        ((float)p.num_lights * f[PF_LAREA] * costa);
          V3 shadow_org = offset_point(point, nrm, ldir_u);
          bool shadowed = occluded<kWalk>(tb, p, shadow_org, ldir_u, time,
                                          hb, p.shadow_eps, ldist * 0.999f);
          float w_nee = power_heuristic(l_pdf, bsdf_pdf);
          float nee_s =
              w_nee * fmaxf(dot(ldir_u, nrm), 0.0f) * INV_PI_F / l_pdf;
          V3 nee = albedo * load3(f + PF_LEMIT) * nee_s;
          if (!shadowed) rad = rad + thr * nee;
        }
      }

      // ---- advance and Russian roulette ----------------------------------
      bool new_alive = !terminate;
      org = is_iso ? point : offset_point(point, nrm, scatter);
      if (new_alive) {
        dir = scatter;
        thr = thr * att;
        float p_cont = max_component(thr);
        bool rr_on = depth >= p.rr_start;
        bool kill = slot_u(hb, U_RR) > p_cont;
        still = !(rr_on && kill);
        if (rr_on && !kill) thr = thr * (1.0f / fmaxf(p_cont, 1e-12f));
        if (is_lamb) prev_pdf = lamb_pdf;
      }
      prevd = new_alive ? is_lamb : prevd;
    }

    // ---- finish: accumulate the completed sample (hybrid: the queue's
    // flush outside the kernel banks it) --------------------------------
    depth += 1;
    bool finished = !still || depth >= p.max_depth;
    if (!kHybrid && finished) {
      acc = acc + V3{scrub(rad.x), scrub(rad.y), scrub(rad.z)};
      sample += 1;
    }
    still = still && !finished;
  } else if (!kHybrid) {
    depth += 1;   // a dead lane's iteration changes only its depth
  }               // (hybrid: a dead lane keeps its path's length)

  lane.org = org;
  lane.dir = dir;
  lane.thr = thr;
  lane.rad = rad;
  lane.acc = acc;
  lane.time = time;
  lane.prev_pdf = prev_pdf;
  lane.alive = still;
  lane.prevd = prevd;
  lane.depth = depth;
  lane.sample = sample;
  return rays;
}

// Stage the tables in dynamic shared memory: [nodes][props and block AABBs,
// if kShared][plan][hier][volume slots, if kShared].  `aabbs` is the
// augmented table: n_blocks block rows, then n_nodes upper rows.  Without
// kWalk no sweep reads the boxes or the hier rows: they are not copied.
template <bool kShared, bool kWalk>
__device__ __forceinline__ Tables stage(const float* props, const int* plan,
                                        const float* aabbs, const int* hier,
                                        const int* vol_slot,
                                        const MegaParams& p, float* smem) {
  const int n_nd = p.n_nodes * AABB_COLS, n_bl = p.n_blocks * AABB_COLS,
            n_pr = p.n_props * p.kdim;
  float* s_nodes = smem;
  float* s_props = s_nodes + n_nd;
  float* s_blocks = s_props + (kShared ? n_pr : 0);
  int* s_plan = reinterpret_cast<int*>(s_blocks + (kShared ? n_bl : 0));
  int* s_hier = s_plan + p.n_entries * PLAN_COLS;
  int* s_slot = s_hier + p.n_entries * HIER_COLS;
  for (int k = threadIdx.x; k < p.n_entries * PLAN_COLS; k += blockDim.x)
    s_plan[k] = plan[k];
  if (kWalk) {
    for (int k = threadIdx.x; k < n_nd; k += blockDim.x)
      s_nodes[k] = aabbs[n_bl + k];
    for (int k = threadIdx.x; k < p.n_entries * HIER_COLS; k += blockDim.x)
      s_hier[k] = hier[k];
  }
  if (kShared) {
    for (int k = threadIdx.x; k < n_pr; k += blockDim.x)
      s_props[k] = props[k];
    if (kWalk)
      for (int k = threadIdx.x; k < n_bl; k += blockDim.x)
        s_blocks[k] = aabbs[k];
    for (int k = threadIdx.x; k < p.n_props; k += blockDim.x)
      s_slot[k] = vol_slot[k];
  }
  __syncthreads();
  if (kShared) return {s_props, s_slot, s_blocks, s_nodes, s_plan, s_hier};
  return {props, vol_slot, aabbs, s_nodes, s_plan, s_hier};
}

// One wavefront iteration per launch: load -> step -> store.
template <bool kHybrid, bool kShared, bool kWalk>
__global__ void __launch_bounds__(kBlock)
    mega_kernel(const float* __restrict__ sf, const int* __restrict__ si,
                const float* __restrict__ props, const int* __restrict__ plan,
                const float* __restrict__ aabbs, const int* __restrict__ hier,
                const int* __restrict__ vol_slot, float* __restrict__ osf,
                int* __restrict__ osi, unsigned long long* __restrict__ rays,
                int n, MegaParams p) {
  extern __shared__ float smem[];
  Tables tb =
      stage<kShared, kWalk>(props, plan, aabbs, hier, vol_slot, p, smem);

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned r = 0;
  if constexpr (kHybrid && kWalk) {
    // the warp-shared nearest hit needs every thread of the warp: a thread
    // past n steps a dead lane (it traces nothing) and stores nothing
    Lane lane = i < n ? load_lane(i, n, sf, si) : fresh_lane(0, 0);
    r = lane_step<kHybrid, kWalk>(lane, tb, p);
    if (i < n) store_lane(i, n, lane, osf, osi);
  } else if (i < n) {
    Lane lane = load_lane(i, n, sf, si);
    r = lane_step<kHybrid, kWalk>(lane, tb, p);
    store_lane(i, n, lane, osf, osi);
  }
  // every thread of the (full) block reaches here: warp sum, one atomic
  r = __reduce_add_sync(0xffffffffu, r);
  if ((threadIdx.x & 31) == 0 && r != 0)
    atomicAdd(rays, (unsigned long long)r);
}

__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The persistent kernel's scratch (int64 [4], zeroed by the wrapper): the
// lane counter, then the device clock (ns) at the first block's start
// (stored inverted, so one atomicMax over zeroed memory takes the minimum),
// when the counter ran dry (lane n drawn), and at the last warp's exit.
constexpr int S_NEXT = 0, S_START_INV = 1, S_DRY = 2, S_END = 3;

// One launch per render: each thread holds one lane's path in registers and
// steps it while it is alive or has samples left; then it writes the lane's
// accumulated radiance (acc [3, n]) and pulls the next lane index.  One
// loop, one step per trip: a thread that changes lanes does so between two
// steps, so the warp reconverges at every step.
template <bool kShared, bool kWalk>
__global__ void __launch_bounds__(kTraceBlock, kTraceMinBlocks)
    mega_trace_kernel(const int* __restrict__ pixel_idx,
                      const float* __restrict__ props,
                      const int* __restrict__ plan,
                      const float* __restrict__ aabbs,
                      const int* __restrict__ hier,
                      const int* __restrict__ vol_slot,
                      float* __restrict__ acc,
                      unsigned long long* __restrict__ rays,
                      unsigned long long* __restrict__ scratch, int n,
                      MegaParams p) {
  extern __shared__ float smem[];
  Tables tb =
      stage<kShared, kWalk>(props, plan, aabbs, hier, vol_slot, p, smem);
  if (threadIdx.x == 0) atomicMax(scratch + S_START_INV, ~clock_ns());

  const int stride = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == n) scratch[S_DRY] = clock_ns();    // fewer lanes than threads
  unsigned long long r = 0;
  Lane lane;
  if (i < n) lane = fresh_lane(pixel_idx[i], p.s0);
  while (i < n) {
    if (!lane.alive && lane.sample >= p.s_end) {     // the lane is done
      acc[i] = lane.acc.x;
      acc[n + i] = lane.acc.y;
      acc[2 * n + i] = lane.acc.z;
      i = stride + (int)atomicAdd(scratch + S_NEXT, 1ull);
      if (i == n) scratch[S_DRY] = clock_ns();
      if (i >= n) break;
      lane = fresh_lane(pixel_idx[i], p.s0);
    }
    r += lane_step<false, kWalk>(lane, tb, p);
  }
  // every thread of the (full) block reaches here: warp sum, one atomic
  for (int off = 16; off > 0; off >>= 1)
    r += __shfl_xor_sync(0xffffffffu, r, off);
  if ((threadIdx.x & 31) == 0) {
    if (r != 0) atomicAdd(rays, r);
    atomicMax(scratch + S_END, clock_ns());
  }
}

// Bytes of the tables: those always in shared memory, and those that join
// them when p.tables_shared (ops/mega_kernel.py decides by the same sum
// against TABLES_SHARED_MAX).
size_t smem_bytes(const MegaParams& p) {
  size_t words = (size_t)p.n_nodes * AABB_COLS +
                 (size_t)p.n_entries * (PLAN_COLS + HIER_COLS);
  if (p.tables_shared)
    words += (size_t)p.n_props * (p.kdim + 1) + (size_t)p.n_blocks * AABB_COLS;
  return 4 * words;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool kHybrid, bool kShared, bool kWalk>
int launch(const float* sf, const int* si, const float* props,
           const int* plan, const float* aabbs, const int* hier,
           const int* vol_slot, float* osf, int* osi,
           unsigned long long* rays, int n, const MegaParams& p,
           cudaStream_t stream) {
  size_t smem = smem_bytes(p);
  cudaError_t e = allow_smem(mega_kernel<kHybrid, kShared, kWalk>, smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + kBlock - 1) / kBlock;
  mega_kernel<kHybrid, kShared, kWalk><<<blocks, kBlock, smem, stream>>>(
      sf, si, props, plan, aabbs, hier, vol_slot, osf, osi, rays, n, p);
  return (int)cudaGetLastError();
}

// The resident grid of one persistent instantiation: blocks an SM from the
// occupancy calculator at this dynamic shared memory, and the SM count,
// computed once for each (device, shared memory) the instantiation meets.
struct Residency {
  int device = -1;
  size_t smem = 0;
  int blocks_per_sm = 0, sms = 0, regs = 0, local_bytes = 0;
};

template <bool kShared, bool kWalk>
cudaError_t residency(size_t smem, Residency* out) {
  static Residency cached;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (cached.device != dev || cached.smem != smem) {
    auto kernel = mega_trace_kernel<kShared, kWalk>;
    Residency r;
    r.device = dev;
    r.smem = smem;
    if ((e = allow_smem(kernel, smem)) != cudaSuccess) return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &r.blocks_per_sm, kernel, kTraceBlock, smem)) != cudaSuccess)
      return e;
    if ((e = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return e;
    r.regs = attr.numRegs;
    r.local_bytes = (int)attr.localSizeBytes;
    if (r.blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
    cached = r;
  }
  *out = cached;
  return cudaSuccess;
}

template <bool kShared, bool kWalk>
int launch_trace(const int* pixel_idx, const float* props, const int* plan,
                 const float* aabbs, const int* hier, const int* vol_slot,
                 float* acc, unsigned long long* rays,
                 unsigned long long* scratch, int n, const MegaParams& p,
                 cudaStream_t stream, int* info) {
  size_t smem = smem_bytes(p);
  Residency r;
  cudaError_t e = residency<kShared, kWalk>(smem, &r);
  if (e != cudaSuccess) return (int)e;
  long long resident = (long long)r.blocks_per_sm * r.sms;
  long long needed = (n + kTraceBlock - 1) / kTraceBlock;
  int grid = (int)(resident < needed ? resident : needed);
  info[0] = r.blocks_per_sm;
  info[1] = r.sms;
  info[2] = grid;
  info[3] = kTraceBlock;
  info[4] = r.regs;
  info[5] = r.local_bytes;
  mega_trace_kernel<kShared, kWalk><<<grid, kTraceBlock, smem, stream>>>(
      pixel_idx, props, plan, aabbs, hier, vol_slot, acc, rays, scratch, n,
      p);
  return (int)cudaGetLastError();
}

}  // namespace

// One mega_step on `stream`, in hybrid mode (TPU kernel D) when `hybrid` is
// nonzero.  Returns cudaGetLastError() after the launch (0 on success); a
// refused launch never runs and must not pass silently.
extern "C" int rtw_mega_step(const float* sf, const int* si,
                             const float* props, const int* plan,
                             const float* aabbs, const int* hier,
                             const int* vol_slot, float* osf, int* osi,
                             unsigned long long* rays, int n, int hybrid,
                             MegaParams p, void* stream) {
  if (n <= 0) return 0;
  // one instantiation per (hybrid, tables shared, walk)
  using Launch = decltype(&launch<false, false, false>);
  const Launch table[8] = {
      launch<false, false, false>, launch<false, false, true>,
      launch<false, true, false>,  launch<false, true, true>,
      launch<true, false, false>,  launch<true, false, true>,
      launch<true, true, false>,   launch<true, true, true>};
  auto fn = table[(hybrid ? 4 : 0) + (p.tables_shared ? 2 : 0) +
                  (p.walk ? 1 : 0)];
  return fn(sf, si, props, plan, aabbs, hier, vol_slot, osf, osi, rays, n, p,
            (cudaStream_t)stream);
}

// One persistent mega_trace launch on `stream`: every lane of pixel_idx [n]
// from sample p.s0 to p.s_end, its radiance sum into acc [3, n], its rays
// into `rays`; `scratch` int64 [4] zeroed.  info[6] receives blocks an SM,
// SMs, grid, threads a block, registers and local (spill) bytes a thread.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rtw_mega_trace(const int* pixel_idx, const float* props,
                              const int* plan, const float* aabbs,
                              const int* hier, const int* vol_slot,
                              float* acc, unsigned long long* rays,
                              unsigned long long* scratch, int n,
                              MegaParams p, int* info, void* stream) {
  if (n <= 0) return 0;
  // one instantiation per (tables shared, walk)
  using Launch = decltype(&launch_trace<false, false>);
  const Launch table[4] = {launch_trace<false, false>,
                           launch_trace<false, true>,
                           launch_trace<true, false>,
                           launch_trace<true, true>};
  auto fn = table[(p.tables_shared ? 2 : 0) + (p.walk ? 1 : 0)];
  return fn(pixel_idx, props, plan, aabbs, hier, vol_slot, acc, rays, scratch,
            n, p, (cudaStream_t)stream, info);
}

extern "C" const char* rtw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
