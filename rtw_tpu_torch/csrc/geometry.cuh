// Device geometry shared by the CUDA kernels of this package: float3-style
// vectors, the 3x4 affine transforms of the props table and the primitive
// t-tests of rtw_tpu/ops/intersect.py.  Every expression follows the plain
// torch version's order of operations term by term, and the kernels are
// built with -fmad=false, so kernel and plain version round alike; the
// fused multiply-adds are explicit (fmaf), where the plain version fuses
// them too (intersect.fma: the reference's compiled CPU code fuses them).

#pragma once

#include <cuda_runtime.h>

namespace rtw {

constexpr float BIG = 1e30f;
constexpr float PI_F = 3.1415927410125732f;        // float32(pi)
constexpr float TWO_PI_F = 6.2831854820251465f;    // float32(2 pi)
constexpr float HALF_PI_F = 1.5707963705062866f;   // float32(pi / 2)

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

// intersect._sphere_roots, fused as there
__device__ __forceinline__ float sphere_hit(V3 center, float radius, V3 o,
                                            V3 d, float tmin, float tmax) {
  V3 oc = o - center;
  float a = fdot(d, d);
  float b = fdot(oc, d);
  float c = fdot(oc, oc) - radius * radius;
  float disc = fmaf(b, b, -(a * c));
  if (!(disc >= 0.0f)) return BIG;
  float sq = safe_sqrt(disc);
  float inv_a = 1.0f / a;
  float t1 = (-b - sq) * inv_a;
  float t2 = (-b + sq) * inv_a;
  return in_window(t1, tmin, tmax) ? t1
                                   : (in_window(t2, tmin, tmax) ? t2 : BIG);
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

}  // namespace rtw
