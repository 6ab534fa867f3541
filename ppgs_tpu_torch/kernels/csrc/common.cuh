// Shared helpers of the encoder kernels: bf16 rounding, GELU, LayerNorm
// rows and warp reductions. Header-only; every kernel source includes it
// and is compiled on its own (see ppgs_tpu_torch/kernels/__init__.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace ppgs {

using bf16 = __nv_bfloat16;

constexpr float LN_EPS = 1e-5f;
constexpr float NEG_INF = -1e30f;   // the JAX kernels' mask fill

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// Round to bf16 and back: the TPU kernels' cast to the compute dtype.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// tanh-approximate GELU in fp32 (jax.nn.gelu(approximate=True), the w2v2
// bf16 path's activation).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// LayerNorm of one C-wide float32 row spread over a warp, C/32 values per
// lane (lane owns columns lane*C/32 .. lane*C/32 + C/32 - 1); two-pass
// moments in fp32 as the JAX kernels compute them. Writes the row to out
// and, for the training backward, the normalised row to n and 1/std to
// *rstd when they are not null. C % 128 == 0.
template <int C>
__device__ __forceinline__ void layer_norm_row(float v[C / 32],
                                               const float* gamma,
                                               const float* beta, float* out,
                                               float* n = nullptr,
                                               float* rstd = nullptr) {
  constexpr int VPL = C / 32;
  static_assert(VPL % 4 == 0, "a lane's columns are written as float4");
  const int lane = threadIdx.x % 32, c0 = lane * VPL;
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < VPL; ++e) sum += v[e];
  const float mean = warp_sum(sum) * (1.f / C);
  float sq = 0.f;
#pragma unroll
  for (int e = 0; e < VPL; ++e) {
    v[e] -= mean;
    sq += v[e] * v[e];
  }
  const float inv = rsqrtf(warp_sum(sq) * (1.f / C) + LN_EPS);
#pragma unroll
  for (int e = 0; e < VPL; e += 4) {
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[e + j] *= inv;
      o[j] = v[e + j] * gamma[c0 + e + j] + beta[c0 + e + j];
    }
    *reinterpret_cast<float4*>(out + c0 + e) =
        make_float4(o[0], o[1], o[2], o[3]);
    if (n)
      *reinterpret_cast<float4*>(n + c0 + e) =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  }
  if (rstd && lane == 0) *rstd = inv;
}

}  // namespace ppgs
