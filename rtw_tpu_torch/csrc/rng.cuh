// The fast random stream of rtw_tpu_torch/utils/rng.py in native uint32,
// shared by the kernels that draw it: `pcg` is `pcg_hash`, `to_unit` the
// top 24 bits as a float in [0, 1), and the two stream offsets.  The plain
// code holds the same uint32 values in int64 and masks where uint32 wraps.

#pragma once

#include <stdint.h>

namespace rtw {

constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t CAM_OFF = 0xF53EA684u;   // 0x0CA4 * GOLDEN mod 2^32

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8u) * (1.0f / 16777216.0f);
}

}  // namespace rtw
