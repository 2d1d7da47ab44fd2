// The split tier's bounce step for Hopper (sm_90a), one thread per lane:
// `shade_kernel` (E), launched between the trace kernel B and the
// occlusion kernel C of csrc/trace_kernel.cu, and `shade_finish_kernel`
// (F), launched after C.
//
// Neither replaces a pallas_call.  With B and C they are the counterpart
// of the XLA fusion that runs the reference's bounce_step
// (rtw_tpu/integrator.py:212) under jit: the RNG slot rows (read here from
// the wrapper's uniform block U), resolve_albedo (rtw_tpu/ops/shading.py:147:
// checker, the Perlin marble of textures.py:44,76 and the atlas fetches of
// textures.py:115-241), bounce_core (rtw_tpu/ops/bounce.py:92) and the
// light helpers (integrator.py:124,173,298).  The plain versions are
// rtw_tpu_torch/ops/shade_kernel.py::shade_plain (resolve_albedo +
// bounce_core with the shadow query deferred) and ::finish_plain
// (bounce.finish_nee).  Every float operation follows the plain code's
// order term by term, and the library is built with -fmad=false, so the
// two round alike apart from libm, which is the one torch's CUDA kernels
// call: sinf, cosf, powf (the unit ball's cube root, `pow(1/3)` there),
// rsqrtf (the lattice gradient), sqrtf.  Where torch divides by a Python
// scalar on the card it multiplies by the scalar's float reciprocal
// (the book mixture's 1/L), and so does this code.
//
// E evaluates only the branch a lane takes (the plain code evaluates every
// material and texture kind on every lane and selects), which gives each
// lane the selected branch's value: the planes E writes are the plain
// code's on every lane where a plane is meaningful.  Two exceptions, both
// masked by every reader: the shadow ray and the NEE term of a lane with
// no shadow query (tmax -BIG: C does not test it, F adds nothing) are
// zero here.
//
// What bounds it on this card: bytes at first sight, operations in fact.
// A lane reads B's 26 rows, 17 state planes, at most 9 rows of U and (on
// an image texture) one to four atlas words, and writes 23 float rows, 2
// bool rows and one int row: ~260 B a lane, 0.025 ms at 320k lanes and
// 3.35 TB/s.  The marble costs 7 octaves x 8 lattice corners x 3 chained
// pcg hashes and an rsqrtf, ~2000 integer and float operations a lane,
// which on scene 2's or 4's marble lanes dominates; the lanes of a warp
// take different materials and textures, so a warp runs the union of its
// lanes' branches.  A simple kernel that is right comes first: no shared
// memory (the light rows are a few broadcast reads), no sorting by
// material.
//
// F is a pass over 7 float and 1 bool rows in, 3 out: bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "geometry.cuh"

using namespace rtw;

namespace {

constexpr int kBlock = 256;

// B's output rows (rtw_tpu_torch/ops/trace_kernel.py HIT_F32 / HIT_I32)
constexpr int H_POINT = 1, H_NORMAL = 4, H_U = 7, H_V = 8, H_FUZZ = 9,
              H_ETA = 10, H_SCALE = 11, H_RGB = 12, H_ODD = 15, H_EVEN = 18;
constexpr int HI_PRIM = 0, HI_MAT = 1, HI_TEX = 2, HI_IMG = 3;
// E's output rows (rtw_tpu_torch/ops/shade_kernel.py)
constexpr int O_ORG = 0, O_DIR = 3, O_THR = 6, O_RAD = 9, O_PPDF = 12,
              O_SORG = 13, O_SDIR = 16, O_STMAX = 19, O_NEE = 20;
constexpr int OB_ALIVE = 0, OB_PREVD = 1;
// light table columns
constexpr int L_POS = 0, L_U = 3, L_V = 6, L_EMIT = 9, L_AREA = 12,
              L_NRM = 13, LIGHT_COLS = 16;

constexpr int MAT_LAMBERTIAN = 0, MAT_METAL = 1, MAT_DIELECTRIC = 2,
              MAT_DIFFUSE_LIGHT = 3, MAT_ISOTROPIC = 4, MAT_NORMAL = 5;
constexpr int TEX_CHECKER = 1, TEX_NOISE = 2, TEX_IMAGE = 3;
constexpr int FILTER_STOCH565 = 0, FILTER_RGB565 = 1, FILTER_NEAREST565 = 2;
constexpr int U_SCATTER_0 = 0, U_SCATTER_1 = 1, U_SCATTER_2 = 2,
              U_DIELECTRIC = 3, U_LIGHT_SELECT = 4, U_LIGHT_A = 5,
              U_LIGHT_B = 6, U_RR = 7;

constexpr float INV_PI_F = 0.31830987334251404f;    // float32(1/pi)
constexpr float INV255_F = 0.003921568859368563f;   // float32(1/255)
constexpr float INV31_F = 0.032258063554763794f;    // float32(1/31)
constexpr float INV63_F = 0.01587301678955555f;     // float32(1/63)
constexpr float THIRD_F = 0.3333333432674408f;      // float32(1/3)
constexpr float SHADOW_SCALE_F = 0.9990000128746033f;   // float32(0.999)

}  // namespace

// By-value parameters; mirrors _CShadeParams in
// rtw_tpu_torch/ops/shade_kernel.py (all members 4 bytes, no padding).
struct ShadeParams {
  float sky;
  int n_lights;       // scene.num_lights
  int mat_present;    // bit m: MAT m is in the scene
  int tex_present;    // bit t: TEX t is in the scene
  int tex_filter;     // FILTER_*, else the RGB8 bilinear fetch
  int book;           // estimator "book" with a light
  int nee;            // the NEE block: a light, lambertian, not book
  int mis_weight;     // MIS weight of a BSDF-sampled light hit
  int single_light;   // _light_pdf_at's one-light shortcut
  int rr_start;
  int tex_row;        // U row of stoch565's texel-row draw, or -1
};

// E's planes; mirrors _CShadeIO (pointers only).
struct ShadeIO {
  const float* of;
  const int* oi;
  const float* org[3];
  const float* dir[3];
  const float* thr[3];
  const float* rad[3];
  const bool* alive;
  const float* prev_pdf;
  const bool* prevd;
  const long long* depth;
  const float* u;
  const float* lights;
  const int* light_row;
  const int* images;
  const uint32_t* atlas8;
  const uint32_t* atlas565;
  float* out_f;
  bool* out_b;
  int* out_rays;
};

// F's planes; mirrors _CFinishIO.
struct FinishIO {
  const float* rad[3];
  const float* nee[3];
  const float* tmax;
  const bool* occluded;
  float* out;
};

namespace {

__device__ __forceinline__ V3 load_plane3(const float* const* p, int i) {
  return {p[0][i], p[1][i], p[2][i]};
}
__device__ __forceinline__ V3 load_rows3(const float* base, int row, int i,
                                         int n) {
  return {base[row * n + i], base[(row + 1) * n + i],
          base[(row + 2) * n + i]};
}
__device__ __forceinline__ void store_rows3(float* base, int row, int i,
                                            int n, V3 v) {
  base[row * n + i] = v.x;
  base[(row + 1) * n + i] = v.y;
  base[(row + 2) * n + i] = v.z;
}
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
  float scale = 1e-4f * fmaxf(max_component({fabsf(point.x), fabsf(point.y),
                                             fabsf(point.z)}),
                              1.0f);
  float side = signf(dot(normal, out_dir));
  return point + normal * (scale * side);
}
// sampling.sphere_surface
__device__ __forceinline__ V3 sphere_surface(float u1, float u2) {
  float z = 1.0f - 2.0f * u1;
  float r = safe_sqrt(1.0f - z * z);
  float phi = TWO_PI_F * u2;
  return {r * cosf(phi), r * sinf(phi), z};
}

// ---- the lattice hash (utils/rng.py pcg_hash, native uint32) -------------
__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8u) * (1.0f / 16777216.0f);
}
// A float lattice coordinate (an integer value) as the plain code's int64,
// wrapped to uint32 as pcg_hash wraps it: negative ids wrap mod 2^32.
__device__ __forceinline__ uint32_t lattice_id(float f) {
  return (uint32_t)(unsigned long long)(long long)f;
}

// textures.perlin_noise at one point: the eight corners in the plain
// code's order (di outer, dk inner), each term added to a running sum from 0
__device__ float perlin(float px, float py, float pz) {
  float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  float ux = px - fx, uy = py - fy, uz = pz - fz;
  uint32_t i = lattice_id(fx), j = lattice_id(fy), k = lattice_id(fz);
  float sx = ux * ux * (3.0f - 2.0f * ux);
  float sy = uy * uy * (3.0f - 2.0f * uy);
  float sz = uz * uz * (3.0f - 2.0f * uz);
  float accum = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t di = c >> 2, dj = (c >> 1) & 1, dk = c & 1;
    uint32_t h = pcg(i + di + pcg(j + dj + pcg(k + dk)));
    float gx = to_unit(h) * 2.0f - 1.0f;
    float gy = to_unit(pcg(h + 1u)) * 2.0f - 1.0f;
    float gz = to_unit(pcg(h + 2u)) * 2.0f - 1.0f;
    float inv = rsqrtf(gx * gx + gy * gy + gz * gz + 1e-12f);
    gx = gx * inv;
    gy = gy * inv;
    gz = gz * inv;
    float wx = di ? sx : 1.0f - sx;
    float wy = dj ? sy : 1.0f - sy;
    float wz = dk ? sz : 1.0f - sz;
    float d = gx * (ux - (float)di) + gy * (uy - (float)dj) +
              gz * (uz - (float)dk);
    accum = accum + (wx * wy * wz) * d;
  }
  return accum;
}

// textures.turbulence: |sum of 7 octaves|, p * 2^o exact
__device__ float turbulence(V3 p) {
  float accum = 0.0f, weight = 1.0f, freq = 1.0f;
  for (int o = 0; o < 7; ++o) {
    accum = accum + weight * perlin(p.x * freq, p.y * freq, p.z * freq);
    weight *= 0.5f;
    freq *= 2.0f;
  }
  return fabsf(accum);
}

// ---- the atlas (textures._image_*) ----------------------------------------
__device__ __forceinline__ long long clampll(long long x, long long hi) {
  return min(max(x, 0LL), hi);
}
__device__ __forceinline__ V3 unpack565(uint32_t half) {
  return {(float)((half >> 11) & 31u) * INV31_F,
          (float)((half >> 5) & 63u) * INV63_F,
          (float)(half & 31u) * INV31_F};
}
__device__ __forceinline__ V3 lerp(V3 a, V3 b, float t) {
  return a + (b - a) * t;
}

struct Image {
  long long h, w, off;
};

__device__ __forceinline__ Image image_of(const int* images, int id) {
  return {images[id * 3 + 0], images[id * 3 + 1], images[id * 3 + 2]};
}

__device__ V3 image_rgb8(const uint32_t* atlas, Image im, float u, float v) {
  float x = u * (float)im.w - 0.5f;
  float y = v * (float)im.h - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  long long x0i = (long long)x0, y0i = (long long)y0;
  auto fetch = [&](long long xi, long long yi) -> V3 {
    xi = clampll(xi, im.w - 1);
    yi = clampll(yi, im.h - 1);
    uint32_t bits = atlas[im.off + yi * im.w + xi];
    return {(float)(bits & 0xFFu) * INV255_F,
            (float)((bits >> 8) & 0xFFu) * INV255_F,
            (float)((bits >> 16) & 0xFFu) * INV255_F};
  };
  V3 c00 = fetch(x0i, y0i), c10 = fetch(x0i + 1, y0i);
  V3 c01 = fetch(x0i, y0i + 1), c11 = fetch(x0i + 1, y0i + 1);
  return lerp(lerp(c00, c10, fx), lerp(c01, c11, fx), fy);
}

// textures._fetch565_coords
struct Coords565 {
  float fx, fy;
  long long x0, y0;
};

__device__ __forceinline__ Coords565 coords565(Image im, float u, float v) {
  float x = u * (float)im.w - 0.5f;
  float y = v * (float)im.h - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  return {x0 < 0.0f ? 0.0f : x - x0, y - y0,
          clampll((long long)x0, im.w - 1), (long long)y0};
}

__device__ V3 image_565(const uint32_t* atlas, Image im, float u, float v,
                        int filter, float xi) {
  if (filter == FILTER_NEAREST565) {
    long long x = clampll((long long)(u * (float)im.w), im.w - 1);
    long long y = clampll((long long)(v * (float)im.h), im.h - 1);
    return unpack565(atlas[im.off + y * im.w + x] & 0xFFFFu);
  }
  Coords565 c = coords565(im, u, v);
  if (filter == FILTER_STOCH565) {
    long long y = clampll(c.y0 + (xi < c.fy ? 1 : 0), im.h - 1);
    uint32_t bits = atlas[im.off + y * im.w + c.x0];
    return lerp(unpack565(bits & 0xFFFFu), unpack565(bits >> 16), c.fx);
  }
  uint32_t b0 = atlas[im.off + clampll(c.y0, im.h - 1) * im.w + c.x0];
  uint32_t b1 = atlas[im.off + clampll(c.y0 + 1, im.h - 1) * im.w + c.x0];
  V3 cx0 = lerp(unpack565(b0 & 0xFFFFu), unpack565(b0 >> 16), c.fx);
  V3 cx1 = lerp(unpack565(b1 & 0xFFFFu), unpack565(b1 >> 16), c.fx);
  return lerp(cx0, cx1, c.fy);
}

// ---- lights (integrator._pick_light, _light_pdf_dir, _light_pdf_at) -------
struct Light {
  V3 pos, eu, ev, emit, nrm;
  float area;
};

__device__ __forceinline__ Light light_of(const float* lights, int li) {
  const float* r = lights + li * LIGHT_COLS;
  return {load3(r + L_POS), load3(r + L_U), load3(r + L_V),
          load3(r + L_EMIT), load3(r + L_NRM), r[L_AREA]};
}

__device__ __forceinline__ int pick_index(float u_sel, int n_lights) {
  if (n_lights == 1) return 0;
  long long li = (long long)(u_sel * (float)n_lights);
  return (int)min(max(li, 0LL), (long long)(n_lights - 1));
}

// (1/L) * sum over the lights of the solid-angle pdf of dir_unit from
// origin hitting the light (no occlusion): the book mixture's light pdf
__device__ float light_pdf_dir(const float* lights, int n_lights, V3 origin,
                               V3 dir_unit) {
  float total = 0.0f;
  for (int li = 0; li < n_lights; ++li) {
    Light l = light_of(lights, li);
    float denom = dot(dir_unit, l.nrm);
    bool ok = fabsf(denom) > 1e-8f;
    float denom_s = ok ? denom : 1.0f;
    float t = dot(l.pos - origin, l.nrm) / denom_s;
    ok = ok && t > 1e-4f;
    V3 w = origin + dir_unit * t - l.pos;
    float uu = dot(l.eu, l.eu), vv = dot(l.ev, l.ev), uv = dot(l.eu, l.ev);
    float det = uu * vv - uv * uv;
    float wu = dot(w, l.eu), wv = dot(w, l.ev);
    float a = (wu * vv - wv * uv) / det;
    float b = (wv * uu - wu * uv) / det;
    ok = ok && a >= 0.0f && a <= 1.0f && b >= 0.0f && b <= 1.0f;
    float pdf_l = ok ? t * t / (l.area * fmaxf(fabsf(denom), 1e-8f)) : 0.0f;
    total = total + pdf_l;
  }
  // torch divides a CUDA tensor by a Python scalar as a product with the
  // scalar's float reciprocal
  return total * (1.0f / (float)max(n_lights, 1));
}

// The one-sided solid-angle pdf of NEE having sampled the direction that
// hit a light at `point` (the lane's w_mask holds)
__device__ float light_pdf_at(const ShadeParams& p, const float* lights,
                              const int* light_row, V3 origin, V3 point,
                              V3 dir_unit, int prim) {
  V3 d = point - origin;
  float dist2 = dot(d, d);
  float L = (float)max(p.n_lights, 1);
  if (p.single_light) {
    Light l = light_of(lights, 0);
    float cos_t = -dot(dir_unit, l.nrm);
    bool sel = cos_t > 1e-6f;
    float pdf = dist2 / (l.area * (sel ? cos_t : 1.0f)) * (1.0f / L);
    return sel ? pdf : 0.0f;
  }
  int row = light_row[max(prim, 0)];
  if (prim < 0) row = -1;
  Light l = light_of(lights, max(row, 0));
  float cos_t = -dot(dir_unit, l.nrm);
  bool sel = row >= 0 && cos_t > 1e-6f;
  float pdf = dist2 / ((sel ? l.area * cos_t : 1.0f) * L);
  return sel ? pdf : 0.0f;
}

__global__ void __launch_bounds__(kBlock)
    shade_kernel(ShadeIO io, int n, ShadeParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  auto U = [&](int slot) { return io.u[slot * n + i]; };

  V3 o = load_plane3(io.org, i), d = load_plane3(io.dir, i);
  V3 thr = load_plane3(io.thr, i), rad = load_plane3(io.rad, i);
  const bool alive = io.alive[i];
  const bool prevd = io.prevd[i];
  const float prev_pdf = io.prev_pdf[i];
  const int prim = io.oi[HI_PRIM * n + i];
  const bool hit_alive = alive && prim >= 0;
  int rays = alive ? 1 : 0;

  const V3 du = normalized(d);
  if (alive && prim < 0) {
    // ---- miss: sky gradient or black ------------------------------------
    float sky_t = 0.5f * (du.y + 1.0f);
    V3 sky = {(1.0f - 0.5f * sky_t) * p.sky, (1.0f - 0.3f * sky_t) * p.sky,
              1.0f * p.sky};
    rad = rad + thr * sky;
  }

  V3 org_out = o, dir_out = d, thr_out = thr;
  bool alive_out = false, prevd_out = prevd;
  float ppdf_out = prev_pdf;
  V3 s_org = {0.0f, 0.0f, 0.0f}, s_dir = {0.0f, 0.0f, 0.0f},
     nee_term = {0.0f, 0.0f, 0.0f};
  float s_tmax = -BIG;

  if (hit_alive) {
    const float* of = io.of;
    V3 point = load_rows3(of, H_POINT, i, n);
    V3 nrm = load_rows3(of, H_NORMAL, i, n);
    const int mat = io.oi[HI_MAT * n + i];
    const int tex = io.oi[HI_TEX * n + i];

    // ---- resolve_albedo -------------------------------------------------
    V3 albedo = load_rows3(of, H_RGB, i, n);
    if ((p.tex_present >> TEX_CHECKER & 1) && tex == TEX_CHECKER) {
      float sines = sinf(10.0f * point.x) * sinf(10.0f * point.y) *
                    sinf(10.0f * point.z);
      albedo = sines < 0.0f ? load_rows3(of, H_ODD, i, n)
                            : load_rows3(of, H_EVEN, i, n);
    } else if ((p.tex_present >> TEX_NOISE & 1) && tex == TEX_NOISE) {
      float scale = of[H_SCALE * n + i];
      float turb = turbulence(point * scale);
      float m = 0.5f * (1.0f + sinf(scale * point.z + 5.0f * turb));
      albedo = {m, m, m};
    } else if ((p.tex_present >> TEX_IMAGE & 1) && tex == TEX_IMAGE) {
      Image im = image_of(io.images, io.oi[HI_IMG * n + i]);
      float u = of[H_U * n + i], v = of[H_V * n + i];
      if (p.tex_filter <= FILTER_NEAREST565)
        albedo = image_565(io.atlas565, im, u, v, p.tex_filter,
                           p.tex_row >= 0 ? U(p.tex_row) : 0.0f);
      else
        albedo = image_rgb8(io.atlas8, im, u, v);
    }

    // ---- bounce_core's materials ---------------------------------------
    const int mp = p.mat_present;
    const bool is_lamb = (mp >> MAT_LAMBERTIAN & 1) && mat == MAT_LAMBERTIAN;
    const bool is_iso = (mp >> MAT_ISOTROPIC & 1) && mat == MAT_ISOTROPIC;
    V3 scatter = du, att = albedo;
    bool cancel = false, terminate = false;
    float lamb_pdf = 1.0f;

    if (is_lamb) {
      // build_onb, cosine_direction, onb_local
      V3 w = normalized(nrm);
      bool big_x = fabsf(w.x) > 0.9f;
      V3 a = {big_x ? 0.0f : 1.0f, big_x ? 1.0f : 0.0f, 0.0f};
      V3 v = normalized(cross(w, a));
      V3 u = cross(w, v);
      float phi = TWO_PI_F * U(U_SCATTER_0);
      float sr2 = safe_sqrt(U(U_SCATTER_1));
      V3 local = {cosf(phi) * sr2, sinf(phi) * sr2,
                  safe_sqrt(1.0f - U(U_SCATTER_1))};
      V3 cos_dir = normalized(u * local.x + v * local.y + w * local.z);
      if (p.book) {
        // the books' mixture: 0.5 cosine + 0.5 light-area sampling
        Light l = light_of(io.lights, pick_index(U(U_LIGHT_SELECT),
                                                 p.n_lights));
        V3 lpos = l.pos + l.eu * U(U_LIGHT_A) + l.ev * U(U_LIGHT_B);
        V3 ldir = lpos - point;
        V3 ldir_u = ldir * (1.0f / fmaxf(length(ldir), 1e-12f));
        V3 lamb_dir = U(U_DIELECTRIC) < 0.5f ? ldir_u : cos_dir;
        float cos_pdf = fmaxf(dot(nrm, lamb_dir), 0.0f) * INV_PI_F;
        float lgt_pdf = light_pdf_dir(io.lights, p.n_lights, point,
                                      lamb_dir);
        lamb_pdf = 0.5f * cos_pdf + 0.5f * lgt_pdf;
        bool lamb_cancel = lamb_pdf <= 0.0f || cos_pdf <= 0.0f;
        float pdf_safe = lamb_cancel ? 1.0f : lamb_pdf;
        float w_mix = lamb_cancel ? 0.0f : cos_pdf / pdf_safe;
        att = albedo * w_mix;
        scatter = lamb_dir;
        cancel = lamb_cancel;
      } else {
        lamb_pdf = local.z * INV_PI_F;
        float scatter_pdf = dot(nrm, cos_dir) * INV_PI_F;
        cancel = lamb_pdf <= 0.0f || scatter_pdf <= 0.0f;
        scatter = cos_dir;
      }
    } else if ((mp >> MAT_METAL & 1) && mat == MAT_METAL) {
      V3 refl = reflect(du, nrm);
      V3 ball = sphere_surface(U(U_SCATTER_0), U(U_SCATTER_1)) *
                powf(fmaxf(U(U_SCATTER_2), 1e-30f), THIRD_F);
      V3 mdir = normalized(refl + ball * of[H_FUZZ * n + i]);
      cancel = dot(mdir, nrm) <= 0.0f;
      scatter = mdir;
    } else if ((mp >> MAT_DIELECTRIC & 1) && mat == MAT_DIELECTRIC) {
      float eta = of[H_ETA * n + i];
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
      bool do_reflect = tir || U(U_DIELECTRIC) < reflect_prob;
      if (do_reflect) {
        scatter = reflect(du, ln);
      } else {
        float sin_t = fminf(ratio * sin_i, 1.0f);
        float cos_t = safe_sqrt(1.0f - sin_t * sin_t);
        scatter = (du + ln * cos_i) * ratio - ln * cos_t;
      }
      att = {1.0f, 1.0f, 1.0f};
    } else if (is_iso) {
      scatter = sphere_surface(U(U_SCATTER_0), U(U_SCATTER_1));
    } else if ((mp >> MAT_DIFFUSE_LIGHT & 1) && mat == MAT_DIFFUSE_LIGHT) {
      bool facing = dot(nrm, du) < 0.0f;
      V3 emitted = facing ? albedo : V3{0.0f, 0.0f, 0.0f};
      float w_bsdf = 1.0f;
      if (p.mis_weight && prevd) {
        float lp = light_pdf_at(p, io.lights, io.light_row, o, point, du,
                                prim);
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

    // ---- next-event estimation set-up (C and F finish it) ----------------
    if (p.nee && is_lamb && !cancel) {
      Light l = light_of(io.lights, pick_index(U(U_LIGHT_SELECT),
                                               p.n_lights));
      V3 lpos = l.pos + l.eu * U(U_LIGHT_A) + l.ev * U(U_LIGHT_B);
      V3 ldir = lpos - point;
      float ldist = length(ldir);
      V3 ldir_u = ldir * (1.0f / fmaxf(ldist, 1e-12f));
      float costa = dot(-ldir_u, l.nrm);
      bool l_valid = ldist > 1e-6f && costa > 1e-6f;
      float bsdf_pdf = fmaxf(dot(ldir_u, nrm), 0.0f) * INV_PI_F;
      if (l_valid && bsdf_pdf > 0.0f) {
        rays += 1;
        float l_pdf = ldist * ldist /
                      ((float)p.n_lights * l.area * costa);
        float w_nee = power_heuristic(l_pdf, bsdf_pdf);
        float nee_s =
            w_nee * fmaxf(dot(ldir_u, nrm), 0.0f) * INV_PI_F / l_pdf;
        nee_term = thr * (albedo * l.emit * nee_s);
        s_org = offset_point(point, nrm, ldir_u);
        s_dir = ldir_u;
        s_tmax = ldist * SHADOW_SCALE_F;
      }
    }

    // ---- advance and Russian roulette ----------------------------------
    const bool new_alive = !terminate;
    org_out = is_iso ? point : offset_point(point, nrm, scatter);
    if (new_alive) {
      dir_out = scatter;
      thr_out = thr * att;
      float p_cont = max_component(thr_out);
      bool rr_on = io.depth[i] >= (long long)p.rr_start;
      bool kill = U(U_RR) > p_cont;
      alive_out = !(rr_on && kill);
      if (rr_on && !kill) thr_out = thr_out * (1.0f / fmaxf(p_cont, 1e-12f));
      if (is_lamb) ppdf_out = lamb_pdf;
    }
    prevd_out = new_alive ? is_lamb : prevd;
  }

  float* of = io.out_f;
  store_rows3(of, O_ORG, i, n, org_out);
  store_rows3(of, O_DIR, i, n, dir_out);
  store_rows3(of, O_THR, i, n, thr_out);
  store_rows3(of, O_RAD, i, n, rad);
  of[O_PPDF * n + i] = ppdf_out;
  if (p.nee) {
    store_rows3(of, O_SORG, i, n, s_org);
    store_rows3(of, O_SDIR, i, n, s_dir);
    of[O_STMAX * n + i] = s_tmax;
    store_rows3(of, O_NEE, i, n, nee_term);
  }
  io.out_b[OB_ALIVE * n + i] = alive_out;
  io.out_b[OB_PREVD * n + i] = prevd_out;
  io.out_rays[i] = rays;
}

__global__ void __launch_bounds__(kBlock)
    shade_finish_kernel(FinishIO io, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool add = io.tmax[i] > -BIG && !io.occluded[i];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float r = io.rad[c][i];
    io.out[c * n + i] = add ? r + io.nee[c][i] : r;
  }
}

}  // namespace

// One launch of each kernel on `stream`; each returns cudaGetLastError()
// after the launch (0 on success): a refused launch never runs and must
// not pass silently.
extern "C" int rtw_shade(ShadeIO io, int n, ShadeParams p, void* stream) {
  if (n <= 0) return 0;
  shade_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                 (cudaStream_t)stream>>>(io, n, p);
  return (int)cudaGetLastError();
}

extern "C" int rtw_shade_finish(FinishIO io, int n, void* stream) {
  if (n <= 0) return 0;
  shade_finish_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                        (cudaStream_t)stream>>>(io, n);
  return (int)cudaGetLastError();
}

extern "C" const char* rtw_shade_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
