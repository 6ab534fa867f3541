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
