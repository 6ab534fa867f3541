// K4 ffn_residual_ln: out = LN2(res + relu(bf16(x) @ W1 + b1) @ W2 + b2),
// C = 256, any F % 128 == 0.
//
// Replaces two TPU kernels, which differ in one rounding point:
// - the FFN half of ppgs_tpu/ops/encoder_layer_kernel.py _layer_body
//   (round_input = 0): h = relu(bf16(bf16(x@W1) + bf16(b1))), and the
//   residual res is the fp32 x;
// - ppgs_tpu/ops/fused_ffn.py _kernel (ffn_residual_layernorm,
//   round_input = 1): h = bf16(relu(x@W1 + b1)) in fp32, and the residual
//   is x rounded to bf16, since that kernel takes a bf16 x.
// Products take bf16 operands and accumulate in fp32; LN statistics fp32.
//
// Bound on an H100 at the main path's shape (M = 64,000, F = 2048):
// 134 GFLOP against 131 MB moved, so bound by the tensor cores (~136 us).
// The design keeps the (M, F) hidden out of memory: a block owns 64 whole
// rows and walks F in 128-wide chunks; each chunk of h lives in shared
// memory as bf16 and feeds the second product at once, whose (64, 256)
// sum stays in registers until the LayerNorm epilogue. W1 and W2 (2 MB)
// stream through shared memory per block from L2. Plain wmma with
// synchronous loads: right first, fast later.

#include "common.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int C = 256, BM = 64, FC = 128, THREADS = 256;
constexpr int A_LD = C + 8;     // bf16(x) tile, 64 x 256
constexpr int H_LD = FC + 8;    // bf16 hidden chunk, 64 x 128
constexpr int W_LD1 = FC + 8;   // W1 chunk, 64 x 128
constexpr int W_LD2 = C + 8;    // W2 chunk, 32 x 256
constexpr int HF_LD = FC + 4;   // fp32 hidden chunk before bias + relu
constexpr int Y_LD = C + 4;     // fp32 epilogue tile, 64 x 256

constexpr int OFF_A = 0;
constexpr int OFF_H = OFF_A + BM * A_LD * 2;
constexpr int W_BYTES1 = 64 * W_LD1 * 2, W_BYTES2 = 32 * W_LD2 * 2;
constexpr int OFF_W = OFF_H + BM * H_LD * 2;
constexpr int OFF_HF = OFF_W + (W_BYTES1 > W_BYTES2 ? W_BYTES1 : W_BYTES2);
constexpr int SMEM = OFF_HF + BM * HF_LD * 4;
static_assert(BM * Y_LD * 4 <= OFF_HF, "epilogue tile overlaps the hidden");
static_assert(OFF_H % 128 == 0 && OFF_W % 128 == 0 && OFF_HF % 128 == 0,
              "shared-memory regions must stay aligned");

__global__ void __launch_bounds__(THREADS)
ffn_ln_kernel(const float* __restrict__ x, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ out, int M,
              int F, int round_input) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem + OFF_A);
  bf16* sH = reinterpret_cast<bf16*>(smem + OFF_H);
  bf16* sW = reinterpret_cast<bf16*>(smem + OFF_W);
  float* sHf = reinterpret_cast<float*>(smem + OFF_HF);
  float* sY = reinterpret_cast<float*>(smem);

  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, M - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 2) * 16;    // the warp's 16 rows
  const int wc1 = (warp % 2) * 64;   // its 64 hidden columns of a chunk
  const int wc2 = (warp % 2) * 128;  // its 128 output columns

  ppgs::load_tile_f32_as_bf16<BM, C, THREADS>(
      sA, A_LD, x + (long long)row0 * C, C, rows);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(y[j], 0.f);

  for (int f0 = 0; f0 < F; f0 += FC) {
    // h = bf16(x) @ W1[:, f0:f0+128], K = 256 in four 64-deep steps
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(h[j], 0.f);
    for (int k0 = 0; k0 < C; k0 += 64) {
      __syncthreads();
      ppgs::load_tile_bf16<64, FC, THREADS>(
          sW, W_LD1, w1 + (long long)k0 * F + f0, F, 64);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 64; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sA + wr * A_LD + k0 + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, sW + kk * W_LD1 + wc1 + j * 16, W_LD1);
          wmma::mma_sync(h[j], fa, fb, h[j]);
        }
      }
    }
    // Bias + ReLU + bf16 on the warp's own 16 x 64 piece of the chunk
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sHf + wr * HF_LD + wc1 + j * 16, h[j], HF_LD,
                              wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * 64; i += 32) {
      const int r = wr + i / 64, c = wc1 + i % 64;
      const float acc = sHf[r * HF_LD + c];
      const float bias = b1[f0 + c];
      const float v = round_input
                          ? acc + bias
                          : ppgs::round_bf16(ppgs::round_bf16(acc) +
                                             ppgs::round_bf16(bias));
      sH[r * H_LD + c] = __float2bfloat16(fmaxf(v, 0.f));
    }
    // y += h @ W2[f0:f0+128, :], K = 128 in four 32-deep steps; the first
    // barrier also publishes both warps' halves of sH
    for (int k0 = 0; k0 < FC; k0 += 32) {
      __syncthreads();
      ppgs::load_tile_bf16<32, C, THREADS>(
          sW, W_LD2, w2 + (long long)(f0 + k0) * C, C, 32);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sH + wr * H_LD + k0 + kk, H_LD);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, sW + kk * W_LD2 + wc2 + j * 16, W_LD2);
          wmma::mma_sync(y[j], fa, fb, y[j]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wmma::store_matrix_sync(sY + wr * Y_LD + wc2 + j * 16, y[j], Y_LD,
                            wmma::mem_row_major);
  __syncthreads();

  // Epilogue: each warp normalises 8 whole rows, 8 columns per lane
  const int c0 = lane * 8;
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    if (r >= rows) break;
    const long long g = (long long)(row0 + r) * C + c0;
    const float4 x0 = *reinterpret_cast<const float4*>(x + g);
    const float4 x1 = *reinterpret_cast<const float4*>(x + g + 4);
    const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float res = round_input ? ppgs::round_bf16(xs[e]) : xs[e];
      v[e] = res + sY[r * Y_LD + c0 + e] + b2[c0 + e];
    }
    ppgs::layer_norm_row256(v, gamma, beta, out + (long long)(row0 + r) * C);
  }
}

}  // namespace

// x (M, 256) fp32, w1 (256, F) bf16, b1 (F) fp32, w2 (F, 256) bf16,
// b2/gamma/beta (256) fp32 -> out (M, 256) fp32. F % 128 == 0.
extern "C" int ppgs_ffn_ln(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* gamma,
                           const void* beta, void* out, int M, int F,
                           int round_input, void* stream) {
  // Above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      ffn_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M > 0) {
    ffn_ln_kernel<<<(M + BM - 1) / BM, THREADS, SMEM,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(out), M, F,
        round_input);
  }
  return static_cast<int>(cudaGetLastError());
}
