// Shared helpers of the encoder kernels: bf16 tile loads into shared
// memory and warp reductions. Header-only; every kernel source includes it
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

// Copy a ROWS x COLS bf16 tile from global memory (row stride ld elements)
// into shared memory (row stride sld), 16 bytes per thread and step. Rows at
// or past row_limit read as zeros. COLS % 8 == 0; g, ld and sld keep every
// row 16-byte aligned.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile_bf16(bf16* s, int sld, const bf16* g,
                                               long long ld, int row_limit) {
  constexpr int PER_ROW = COLS / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < row_limit) v = *reinterpret_cast<const uint4*>(g + r * ld + c);
    *reinterpret_cast<uint4*>(s + r * sld + c) = v;
  }
}

// The same from a float32 tile, rounded to bf16 on the way (the TPU
// kernels' x.astype(compute_dtype) before a product); 16 bytes read per
// thread and step.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile_f32_as_bf16(bf16* s, int sld,
                                                      const float* g,
                                                      long long ld,
                                                      int row_limit) {
  constexpr int PER_ROW = COLS / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < row_limit) v = *reinterpret_cast<const float4*>(g + r * ld + c);
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(s + r * sld + c);
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// LayerNorm of one 256-wide float32 row spread over a warp, 8 values per
// lane (lane owns columns lane*8 .. lane*8+7); two-pass moments in fp32 as
// the JAX kernels compute them. Writes the row to out and, for the training
// backward, the normalised row to n and 1/std to *rstd when they are not
// null.
__device__ __forceinline__ void layer_norm_row256(float v[8],
                                                  const float* gamma,
                                                  const float* beta,
                                                  float* out,
                                                  float* n = nullptr,
                                                  float* rstd = nullptr) {
  const int lane = threadIdx.x % 32, c0 = lane * 8;
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) sum += v[e];
  const float mean = warp_sum(sum) * (1.f / 256.f);
  float sq = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] -= mean;
    sq += v[e] * v[e];
  }
  const float inv = rsqrtf(warp_sum(sq) * (1.f / 256.f) + LN_EPS);
  float o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] *= inv;
    o[e] = v[e] * gamma[c0 + e] + beta[c0 + e];
  }
  float4* dst = reinterpret_cast<float4*>(out + c0);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
  if (n) {
    float4* dn = reinterpret_cast<float4*>(n + c0);
    dn[0] = make_float4(v[0], v[1], v[2], v[3]);
    dn[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  if (rstd && lane == 0) *rstd = inv;
}

}  // namespace ppgs
