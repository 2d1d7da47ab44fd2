// One pass of the denoiser's edge-avoiding à-trous filter (Dammertz et al.
// 2010) for Hopper (sm_90a), one thread per pixel: `atrous_kernel`.
//
// It replaces no pallas_call: the reference's filter (rtw_tpu/denoise.py::
// atrous) is jitted jnp that XLA fuses, and the port ran each pass as
// ~1,330 eager torch launches (25 taps x three edge-clamped gathers, the
// Weber distance, the exps and the sums).  The plain version is
// rtw_tpu_torch/denoise.py::atrous_pass_plain, one pass, and the kernel
// computes it term by term: the 25 taps of the B3 5x5 kernel with holes
// (step 2^i) in its order (ky outer, kx inner), each neighbour at
// (clamp(y + dy, 0, h - 1), clamp(x + dx, 0, w - 1)), clamped duplicates at
// the border counted; the Weber scale ((o + c) summed + 0.01), the squared
// colour distance over scale * scale, h * expf(-d2 * inv_2sc2), then times
// expf(-da * (1 / div_albedo)) and expf(-dn * (1 / div_normal)), where torch
// divides by a Python scalar on the card by multiplying with its float
// reciprocal, and so does this code; acc += w * c, wsum += w; at the end
// acc / max(wsum, 1e-8) (NaN kept, as torch's clamp_min keeps it).  The
// channel sums run (x0 + x1) + x2.  The library is built with -fmad=false,
// so each product and sum is rounded on its own, as torch's separate
// kernels round them; expf is the libm call torch's exp makes.  The two
// differ by the order of torch's channel reductions: a few ulps.
//
// A pass reads the previous pass whole (pass i + 1 reads pass i up to
// 2 * 2^(i + 1) pixels away, across the image), so a frame is one launch a
// pass; five launches a frame cost five host issues, and a grid-wide
// barrier would buy nothing.
//
// What bounds it on this card: operations.  A pixel's 25 taps cost ~48 f32
// operations each (harness/work.denoise_bound_s counts them) plus three
// expf of ~10 instructions each: at 800x800, ~11.5 us a pass at 67
// TFLOP/s, against 7.7 MB in and 7.7 MB out (~4.6 us at 3.35 TB/s).  The
// taps' loads (9 floats a tap, 225 a pixel) are what could bound it
// instead, so the design keeps them in L1: 32x8 blocks of threads, whose
// neighbouring taps at steps 1 to 8 fall on the lines the block's other
// threads read; the colour and the two guidance planes (23 MB at 800x800)
// stay in the 50 MB L2 across the five passes.  The centre pixel's colour,
// albedo and normal stay in registers, the five clamped columns are
// computed once a pixel, and the guided and unguided forms are separate
// instantiations, so no tap branches.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// _B3[ky] * _B3[kx] of the B3 spline (1, 4, 6, 4, 1) / 16, exact in f32
__constant__ float kTap[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + b) + c;
}

// sum over the channels of (p - q)^2
__device__ __forceinline__ float dist2(const float p[3],
                                       const float* __restrict__ q) {
  const float e0 = p[0] - __ldg(q), e1 = p[1] - __ldg(q + 1),
              e2 = p[2] - __ldg(q + 2);
  return sum3(e0 * e0, e1 * e1, e2 * e2);
}

template <bool kAlbedo, bool kNormal>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    atrous_kernel(const float* __restrict__ img,
                  const float* __restrict__ albedo,
                  const float* __restrict__ normal, float* __restrict__ out,
                  int h, int w, int step, float inv_2sc2, float inv_albedo,
                  float inv_normal) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t centre = ((size_t)y * w + x) * 3;
  float o[3], a[3], n[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = __ldg(img + centre + k);
    if (kAlbedo) a[k] = __ldg(albedo + centre + k);
    if (kNormal) n[k] = __ldg(normal + centre + k);
  }
  int cols[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    cols[k] = min(max(x + (k - 2) * step, 0), w - 1);

  float acc[3] = {0.0f, 0.0f, 0.0f};
  float wsum = 0.0f;
#pragma unroll
  for (int ky = 0; ky < 5; ++ky) {
    const size_t row = (size_t)min(max(y + (ky - 2) * step, 0), h - 1) * w;
#pragma unroll
    for (int kx = 0; kx < 5; ++kx) {
      const size_t q = (row + cols[kx]) * 3;
      const float c0 = __ldg(img + q), c1 = __ldg(img + q + 1),
                  c2 = __ldg(img + q + 2);
      const float scale = sum3(o[0] + c0, o[1] + c1, o[2] + c2) + 0.01f;
      const float e0 = o[0] - c0, e1 = o[1] - c1, e2 = o[2] - c2;
      const float d2 = sum3(e0 * e0, e1 * e1, e2 * e2) / (scale * scale);
      float wt = (kTap[ky] * kTap[kx]) * expf(-d2 * inv_2sc2);
      if (kAlbedo) wt = wt * expf(-dist2(a, albedo + q) * inv_albedo);
      if (kNormal) wt = wt * expf(-dist2(n, normal + q) * inv_normal);
      acc[0] = acc[0] + wt * c0;
      acc[1] = acc[1] + wt * c1;
      acc[2] = acc[2] + wt * c2;
      wsum = wsum + wt;
    }
  }
  const float den = wsum < 1e-8f ? 1e-8f : wsum;
  for (int k = 0; k < 3; ++k) out[centre + k] = acc[k] / den;
}

template <bool kAlbedo, bool kNormal>
int launch(const float* img, const float* albedo, const float* normal,
           float* out, int h, int w, int step, float inv_2sc2,
           float inv_albedo, float inv_normal, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  atrous_kernel<kAlbedo, kNormal><<<grid, block, 0, stream>>>(
      img, albedo, normal, out, h, w, step, inv_2sc2, inv_albedo,
      inv_normal);
  return (int)cudaGetLastError();
}

}  // namespace

// One pass over an [h, w, 3] float image (and [h, w, 3] guidance planes,
// each may be null: that term is left out), written to `out`, which must
// not alias `img`.  div_albedo and div_normal are the f32 divisors
// 2 sigma^2 torch would use; inv_2sc2 the f32 of 1 / (2 sc^2).
extern "C" int rtw_atrous(const float* img, const float* albedo,
                          const float* normal, float* out, int h, int w,
                          int step, float inv_2sc2, float div_albedo,
                          float div_normal, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const float inv_albedo = 1.0f / div_albedo;
  const float inv_normal = 1.0f / div_normal;
  auto s = (cudaStream_t)stream;
  if (albedo && normal)
    return launch<true, true>(img, albedo, normal, out, h, w, step, inv_2sc2,
                              inv_albedo, inv_normal, s);
  if (albedo)
    return launch<true, false>(img, albedo, normal, out, h, w, step,
                               inv_2sc2, inv_albedo, inv_normal, s);
  if (normal)
    return launch<false, true>(img, albedo, normal, out, h, w, step,
                               inv_2sc2, inv_albedo, inv_normal, s);
  return launch<false, false>(img, albedo, normal, out, h, w, step, inv_2sc2,
                              inv_albedo, inv_normal, s);
}

extern "C" const char* rtw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
