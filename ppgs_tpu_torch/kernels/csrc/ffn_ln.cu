// K4 ffn_residual_ln: out = LN2(res + drop_y(drop_h(relu(bf16(x) @ W1 + b1))
// @ W2 + b2)), C = 256, any F % 128 == 0; and, for an FFN that ends without
// the LayerNorm, y = drop_y(drop_h(relu(x @ W1 + b1)) @ W2 + b2) in bf16.
//
// Replaces four TPU kernels' FFNs, which differ in their rounding points:
// - the FFN half of ppgs_tpu/ops/encoder_layer_kernel.py _layer_body
//   (round_input = 0): h = relu(bf16(bf16(x@W1) + bf16(b1))), and the
//   residual res is the fp32 x;
// - ppgs_tpu/ops/fused_ffn.py _kernel (ffn_residual_layernorm,
//   round_input = 1): h = bf16(relu(x@W1 + b1)) in fp32, and the residual
//   is x rounded to bf16, since that kernel takes a bf16 x;
// - the FFN half of ppgs_tpu/ops/encoder_layer_train.py _fwd_compute
//   (round_input = 0, the dropout sites on): hd = keep_h ? bf16(h *
//   bf16(1 / (1 - rate))) : 0, y0 = fp32 dot + fp32 b2, out = LN2(x +
//   (keep_y ? y0 / (1 - rate) : 0)), saving the normalised rows and 1/std
//   for the backward;
// - ppgs_tpu/ops/fused_ffn.py ffn_train's forward (bf16 x, y_out): the same
//   hd, y = bf16(bf16(dot) + bf16(b2)), and the output
//   keep_y ? bf16(y * bf16(1 / (1 - rate))) : 0 in bf16, no LayerNorm.
// Products take bf16 operands and accumulate in fp32; LN statistics fp32.
// The dropout masks are the Philox stream of philox.cuh.
//
// Bound on an H100 at the main path's shape (M = 64,000, F = 2048):
// 134 GFLOP against 131 MB moved, so bound by the tensor cores (~136 us);
// at the training shape (M = 131,072) 275 GFLOP (~0.28 ms).
// The design keeps the (M, F) hidden out of memory: a block owns 64 whole
// rows and walks F in 128-wide chunks; each chunk of h lives in shared
// memory as bf16 and feeds the second product at once, whose (64, 256)
// sum stays in registers until the epilogue. W1 and W2 (2 MB) stream
// through shared memory per block from L2. Plain wmma with synchronous
// loads: right first, fast later.

#include "common.cuh"
#include "philox.cuh"

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

__device__ __forceinline__ void load_rows(bf16* s, const float* g, int rows) {
  ppgs::load_tile_f32_as_bf16<BM, C, THREADS>(s, A_LD, g, C, rows);
}
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, int rows) {
  ppgs::load_tile_bf16<BM, C, THREADS>(s, A_LD, g, C, rows);
}

// TX = float: the LayerNorm epilogue (out, and n_out/rstd unless null);
// TX = bf16: the bf16 output y_out.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
ffn_ln_kernel(const TX* __restrict__ x, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ out,
              float* __restrict__ n_out, float* __restrict__ rstd,
              bf16* __restrict__ y_out, int M, int F, int round_input,
              ppgs::Dropout drop_h, ppgs::Dropout drop_y) {
  constexpr bool LN = sizeof(TX) == 4;
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
  const float scale_h = ppgs::round_bf16(drop_h.scale);
  ppgs::KeepStream keep_h(drop_h), keep_y(drop_y);

  load_rows(sA, x + (long long)row0 * C, rows);

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
    // Bias + ReLU (+ dropout) + bf16 on the warp's own 16 x 64 piece of the
    // chunk, 4 consecutive columns per lane and step: one Philox draw
    // covers them, and the float4 reads of a quarter warp hit 32 banks
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sHf + wr * HF_LD + wc1 + j * 16, h[j], HF_LD,
                              wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * 16; i += 32) {
      const int r = wr + i / 16, c = wc1 + (i % 16) * 4;
      const float4 acc4 = *reinterpret_cast<const float4*>(sHf + r * HF_LD + c);
      const float acc[4] = {acc4.x, acc4.y, acc4.z, acc4.w};
      const unsigned long long base =
          (unsigned long long)(row0 + r) * F + f0 + c;
      __align__(8) bf16 h4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bias = b1[f0 + c + e];
        float v = fmaxf(round_input
                            ? acc[e] + bias
                            : ppgs::round_bf16(ppgs::round_bf16(acc[e]) +
                                               ppgs::round_bf16(bias)),
                        0.f);
        if (drop_h.threshold)
          v = (row0 + r < M && keep_h.keep(base + e))
                  ? ppgs::round_bf16(v * scale_h) : 0.f;
        h4[e] = __float2bfloat16(v);
      }
      *reinterpret_cast<uint2*>(sH + r * H_LD + c) =
          *reinterpret_cast<const uint2*>(h4);
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

  // Epilogue: each warp takes 8 whole rows, 8 columns per lane
  const int c0 = lane * 8;
  const float scale_y = LN ? drop_y.scale : ppgs::round_bf16(drop_y.scale);
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    if (r >= rows) break;
    const long long row = row0 + r, g = row * C + c0;
    float v[8];
    if constexpr (LN) {
      const float4 x0 = *reinterpret_cast<const float4*>(x + g);
      const float4 x1 = *reinterpret_cast<const float4*>(x + g + 4);
      const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float acc = sY[r * Y_LD + c0 + e];
        if (drop_y.threshold) {
          v[e] = xs[e] + (keep_y.keep(g + e) ? (acc + b2[c0 + e]) * scale_y
                                             : 0.f);
        } else {
          const float res = round_input ? ppgs::round_bf16(xs[e]) : xs[e];
          v[e] = res + acc + b2[c0 + e];
        }
      }
      ppgs::layer_norm_row256(v, gamma, beta, out + row * C,
                              n_out ? n_out + row * C : nullptr,
                              rstd ? rstd + row : nullptr);
    } else {
      __align__(16) bf16 o8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y0 = ppgs::round_bf16(
            ppgs::round_bf16(sY[r * Y_LD + c0 + e]) +
            ppgs::round_bf16(b2[c0 + e]));
        v[e] = drop_y.threshold
                   ? (keep_y.keep(g + e) ? ppgs::round_bf16(y0 * scale_y)
                                         : 0.f)
                   : y0;
        o8[e] = __float2bfloat16(v[e]);
      }
      *reinterpret_cast<uint4*>(y_out + g) =
          *reinterpret_cast<const uint4*>(o8);
    }
  }
}

}  // namespace

// x (M, 256), w1 (256, F) bf16, b1 (F) fp32, w2 (F, 256) bf16, b2 (256)
// fp32; F % 128 == 0. With y_out null: x fp32, gamma/beta (256) fp32 ->
// out (M, 256) fp32, and n_out (M, 256) and rstd (M) fp32 unless null.
// With y_out: x bf16 -> y_out (M, 256) bf16 (round_input, gamma, beta, out,
// n_out and rstd unused). The hidden's dropout site is (seed, site_h), the
// output's (seed, site_y); threshold 0 turns both off.
extern "C" int ppgs_ffn_ln(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* gamma,
                           const void* beta, void* out, void* n_out,
                           void* rstd, void* y_out, int M, int F,
                           int round_input, unsigned seed_lo,
                           unsigned seed_hi, unsigned site_h, unsigned site_y,
                           unsigned threshold, float scale, void* stream) {
  auto kln = ffn_ln_kernel<float>;
  auto kbf16 = ffn_ln_kernel<bf16>;
  // Above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      y_out ? reinterpret_cast<const void*>(kbf16)
            : reinterpret_cast<const void*>(kln),
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M > 0) {
    const ppgs::Dropout dh =
        ppgs::make_dropout(seed_lo, seed_hi, site_h, threshold, scale);
    const ppgs::Dropout dy =
        ppgs::make_dropout(seed_lo, seed_hi, site_y, threshold, scale);
    const unsigned blocks = (M + BM - 1) / BM;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (y_out)
      kbf16<<<blocks, THREADS, SMEM, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
          static_cast<const float*>(b1), static_cast<const bf16*>(w2),
          static_cast<const float*>(b2), nullptr, nullptr, nullptr, nullptr,
          nullptr, static_cast<bf16*>(y_out), M, F, 0, dh, dy);
    else
      kln<<<blocks, THREADS, SMEM, s>>>(
          static_cast<const float*>(x), static_cast<const bf16*>(w1),
          static_cast<const float*>(b1), static_cast<const bf16*>(w2),
          static_cast<const float*>(b2), static_cast<const float*>(gamma),
          static_cast<const float*>(beta), static_cast<float*>(out),
          static_cast<float*>(n_out), static_cast<float*>(rstd), nullptr, M,
          F, round_input, dh, dy);
  }
  return static_cast<int>(cudaGetLastError());
}
