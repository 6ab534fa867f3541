// K4 ffn_residual_ln: out = LN2(res + drop_y(drop_h(act(bf16(x) @ W1 + b1))
// @ W2 + b2)), C = 256, 512 or 768, any F % 128 == 0, act ReLU or the
// tanh-approximate GELU; and, for an FFN that ends without the LayerNorm
// (C = 256, ReLU), y = drop_y(drop_h(relu(x @ W1 + b1)) @ W2 + b2) in bf16.
//
// Replaces four TPU kernels' FFNs, which differ in their rounding points:
// - the FFN half of ppgs_tpu/ops/encoder_layer_kernel.py _layer_body
//   (round_input = 0): h = act(bf16(bf16(x@W1) + bf16(b1))), and the
//   residual res is the fp32 x; act is ReLU for the PPG transformer
//   (encoder_stack; C = 256 mel, C = 512 w2v2fb) and GELU for the
//   wav2vec2 trunk (encoder_stack_streamed, activation='gelu', C = 768,
//   F = 3072);
// - ppgs_tpu/ops/fused_ffn.py _kernel (ffn_residual_layernorm,
//   round_input = 1): h = bf16(relu(x@W1 + b1)) in fp32, and the residual
//   is x rounded to bf16, since that kernel takes a bf16 x (the per-layer
//   path past 1024 frames: C = 256 mel, C = 512 w2v2fb);
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
// at the training shape (M = 131,072) 275 GFLOP (~0.28 ms); the w2v2fb
// head (M = 64,000, C = 512) 268 GFLOP (~0.27 ms) and the wav2vec2 trunk
// (M = 25,600, C = 768, F = 3072) 242 GFLOP (~0.24 ms), both bound by the
// tensor cores.
// The design keeps the (M, F) hidden out of memory: a block owns BM whole
// rows and walks F in 128-wide chunks; each chunk of h lives in shared
// memory as bf16 and feeds the second product at once, whose (BM, C) sum
// stays in registers until the epilogue. That sum is what limits the rows
// a block can own: at C = 768 a (64, C) fp32 sum is 196 KB, 192 registers
// a thread over 256 threads, which cannot fit beside the operands. So
// C = 256 keeps 64 rows (8 warps as 4 x 2, 128 output columns each, as
// before), and C = 512 and 768 take 32 rows (8 warps as 2 x 4, C/4 output
// columns each: at most 12 accumulator fragments, 96 registers). The
// weights stream through shared memory per block from L2. Shared memory:
// 100 KB at C = 256, 90 KB at C = 512, 122 KB at C = 768. Plain wmma with
// synchronous loads: right first, fast later.

#include "common.cuh"
#include "philox.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int FC = 128, THREADS = 256;
constexpr int H_LD = FC + 8;    // bf16 hidden chunk, BM x 128
constexpr int W_LD1 = FC + 8;   // W1 chunk, 64 x 128
constexpr int HF_LD = FC + 4;   // fp32 hidden chunk before bias + act
enum Act { RELU = 0, GELU = 1 };

// The tiling and shared-memory plan of the instance for width C
template <int C>
struct Plan {
  static constexpr int BM = C == 256 ? 64 : 32;   // rows per block
  static constexpr int RG = BM / 16;              // warp row groups
  static constexpr int CG = 8 / RG;               // warp column groups
  static constexpr int HW = FC / CG;              // a warp's hidden columns
  static constexpr int OW = C / CG;               // a warp's output columns
  static constexpr int A_LD = C + 8;    // bf16(x) tile, BM x C
  static constexpr int W_LD2 = C + 8;   // W2 chunk, 32 x C
  static constexpr int Y_LD = C + 4;    // fp32 epilogue tile, BM x C
  static constexpr int OFF_A = 0;
  static constexpr int OFF_H = OFF_A + BM * A_LD * 2;
  static constexpr int W_BYTES1 = 64 * W_LD1 * 2, W_BYTES2 = 32 * W_LD2 * 2;
  static constexpr int OFF_W = OFF_H + BM * H_LD * 2;
  static constexpr int OFF_HF =
      OFF_W + (W_BYTES1 > W_BYTES2 ? W_BYTES1 : W_BYTES2);
  static constexpr int SMEM = OFF_HF + BM * HF_LD * 4;
  static_assert(BM * Y_LD * 4 <= OFF_HF, "epilogue tile overlaps the hidden");
  static_assert(OFF_H % 128 == 0 && OFF_W % 128 == 0 && OFF_HF % 128 == 0,
                "shared-memory regions must stay aligned");
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

template <int C, int BM>
__device__ __forceinline__ void load_rows(bf16* s, const float* g, int rows) {
  ppgs::load_tile_f32_as_bf16<BM, C, THREADS>(s, C + 8, g, C, rows);
}
template <int C, int BM>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, int rows) {
  ppgs::load_tile_bf16<BM, C, THREADS>(s, C + 8, g, C, rows);
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  return ACT == GELU ? ppgs::gelu_tanh(v) : fmaxf(v, 0.f);
}

// TX = float: the LayerNorm epilogue (out, and n_out/rstd unless null);
// TX = bf16: the bf16 output y_out.
template <typename TX, int C, int ACT>
__global__ void __launch_bounds__(THREADS)
ffn_ln_kernel(const TX* __restrict__ x, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ out,
              float* __restrict__ n_out, float* __restrict__ rstd,
              bf16* __restrict__ y_out, int M, int F, int round_input,
              ppgs::Dropout drop_h, ppgs::Dropout drop_y) {
  using P = Plan<C>;
  constexpr int BM = P::BM, CG = P::CG, HW = P::HW, OW = P::OW;
  constexpr int A_LD = P::A_LD, W_LD2 = P::W_LD2, Y_LD = P::Y_LD;
  constexpr bool LN = sizeof(TX) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem + P::OFF_A);
  bf16* sH = reinterpret_cast<bf16*>(smem + P::OFF_H);
  bf16* sW = reinterpret_cast<bf16*>(smem + P::OFF_W);
  float* sHf = reinterpret_cast<float*>(smem + P::OFF_HF);
  float* sY = reinterpret_cast<float*>(smem);

  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, M - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / CG) * 16;   // the warp's 16 rows
  const int wc1 = (warp % CG) * HW;  // its hidden columns of a chunk
  const int wc2 = (warp % CG) * OW;  // its output columns
  const float scale_h = ppgs::round_bf16(drop_h.scale);
  ppgs::KeepStream keep_h(drop_h), keep_y(drop_y);

  load_rows<C, BM>(sA, x + (long long)row0 * C, rows);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> y[OW / 16];
#pragma unroll
  for (int j = 0; j < OW / 16; ++j) wmma::fill_fragment(y[j], 0.f);

  for (int f0 = 0; f0 < F; f0 += FC) {
    // h = bf16(x) @ W1[:, f0:f0+128], K = C in 64-deep steps
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> h[HW / 16];
#pragma unroll
    for (int j = 0; j < HW / 16; ++j) wmma::fill_fragment(h[j], 0.f);
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
        for (int j = 0; j < HW / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, sW + kk * W_LD1 + wc1 + j * 16, W_LD1);
          wmma::mma_sync(h[j], fa, fb, h[j]);
        }
      }
    }
    // Bias + activation (+ dropout) + bf16 on the warp's own 16 x HW piece
    // of the chunk, 4 consecutive columns per lane and step: one Philox
    // draw covers them, and the float4 reads of a quarter warp hit 32 banks
#pragma unroll
    for (int j = 0; j < HW / 16; ++j)
      wmma::store_matrix_sync(sHf + wr * HF_LD + wc1 + j * 16, h[j], HF_LD,
                              wmma::mem_row_major);
    __syncwarp();
    constexpr int GROUPS = HW / 4;     // float4 groups in a row's piece
    for (int i = lane; i < 16 * GROUPS; i += 32) {
      const int r = wr + i / GROUPS, c = wc1 + (i % GROUPS) * 4;
      const float4 acc4 = *reinterpret_cast<const float4*>(sHf + r * HF_LD + c);
      const float acc[4] = {acc4.x, acc4.y, acc4.z, acc4.w};
      const unsigned long long base =
          (unsigned long long)(row0 + r) * F + f0 + c;
      __align__(8) bf16 h4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bias = b1[f0 + c + e];
        float v = activate<ACT>(
            round_input ? acc[e] + bias
                        : ppgs::round_bf16(ppgs::round_bf16(acc[e]) +
                                           ppgs::round_bf16(bias)));
        if (drop_h.threshold)
          v = (row0 + r < M && keep_h.keep(base + e))
                  ? ppgs::round_bf16(v * scale_h) : 0.f;
        h4[e] = __float2bfloat16(v);
      }
      *reinterpret_cast<uint2*>(sH + r * H_LD + c) =
          *reinterpret_cast<const uint2*>(h4);
    }
    // y += h @ W2[f0:f0+128, :], K = 128 in four 32-deep steps; the first
    // barrier also publishes every warp's piece of sH
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
        for (int j = 0; j < OW / 16; ++j) {
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
  for (int j = 0; j < OW / 16; ++j)
    wmma::store_matrix_sync(sY + wr * Y_LD + wc2 + j * 16, y[j], Y_LD,
                            wmma::mem_row_major);
  __syncthreads();

  // Epilogue: each warp takes BM/8 whole rows, C/32 columns per lane
  constexpr int VPL = C / 32, RPW = BM / 8;
  const int c0 = lane * VPL;
  const float scale_y = LN ? drop_y.scale : ppgs::round_bf16(drop_y.scale);
  for (int r = warp * RPW; r < warp * RPW + RPW; ++r) {
    if (r >= rows) break;
    const long long row = row0 + r, g = row * C + c0;
    float v[VPL];
    if constexpr (LN) {
#pragma unroll
      for (int e4 = 0; e4 < VPL; e4 += 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(x + g + e4);
        const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e4 + j;
          const float acc = sY[r * Y_LD + c0 + e];
          if (drop_y.threshold) {
            v[e] = xs[j] + (keep_y.keep(g + e)
                                ? (acc + b2[c0 + e]) * scale_y : 0.f);
          } else {
            const float res = round_input ? ppgs::round_bf16(xs[j]) : xs[j];
            v[e] = res + acc + b2[c0 + e];
          }
        }
      }
      ppgs::layer_norm_row<C>(v, gamma, beta, out + row * C,
                              n_out ? n_out + row * C : nullptr,
                              rstd ? rstd + row : nullptr);
    } else {
#pragma unroll
      for (int e8 = 0; e8 < VPL; e8 += 8) {
        __align__(16) bf16 o8[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int e = e8 + j;
          const float y0 = ppgs::round_bf16(
              ppgs::round_bf16(sY[r * Y_LD + c0 + e]) +
              ppgs::round_bf16(b2[c0 + e]));
          v[e] = drop_y.threshold
                     ? (keep_y.keep(g + e) ? ppgs::round_bf16(y0 * scale_y)
                                           : 0.f)
                     : y0;
          o8[j] = __float2bfloat16(v[e]);
        }
        *reinterpret_cast<uint4*>(y_out + g + e8) =
            *reinterpret_cast<const uint4*>(o8);
      }
    }
  }
}

template <typename TX, int C, int ACT>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* gamma, const void* beta, void* out,
           void* n_out, void* rstd, void* y_out, int M, int F,
           int round_input, ppgs::Dropout dh, ppgs::Dropout dy,
           cudaStream_t stream) {
  using P = Plan<C>;
  auto kernel = ffn_ln_kernel<TX, C, ACT>;
  // Above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M > 0)
    kernel<<<(M + P::BM - 1) / P::BM, THREADS, P::SMEM, stream>>>(
        static_cast<const TX*>(x), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(out),
        static_cast<float*>(n_out), static_cast<float*>(rstd),
        static_cast<bf16*>(y_out), M, F, round_input, dh, dy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, C), w1 (C, F) bf16, b1 (F) fp32, w2 (F, C) bf16, b2 (C) fp32;
// F % 128 == 0; act 0 = ReLU, 1 = tanh-GELU. With y_out null: x fp32,
// gamma/beta (C) fp32 -> out (M, C) fp32, and n_out (M, C) and rstd (M)
// fp32 unless null; (C, act) is (256, ReLU), (512, ReLU) or (768, GELU),
// the widths of the models. With y_out (C = 256, ReLU): x
// bf16 -> y_out (M, 256) bf16 (round_input, gamma, beta, out, n_out and
// rstd unused). The hidden's dropout site is (seed, site_h), the output's
// (seed, site_y); threshold 0 turns both off. Any other (C, act) returns
// cudaErrorInvalidValue.
extern "C" int ppgs_ffn_ln(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* gamma,
                           const void* beta, void* out, void* n_out,
                           void* rstd, void* y_out, int M, int F, int C,
                           int act, int round_input, unsigned seed_lo,
                           unsigned seed_hi, unsigned site_h, unsigned site_y,
                           unsigned threshold, float scale, void* stream) {
  const ppgs::Dropout dh =
      ppgs::make_dropout(seed_lo, seed_hi, site_h, threshold, scale);
  const ppgs::Dropout dy =
      ppgs::make_dropout(seed_lo, seed_hi, site_y, threshold, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_out)
    return C == 256 && act == RELU
               ? launch<bf16, 256, RELU>(x, w1, b1, w2, b2, nullptr, nullptr,
                                         nullptr, nullptr, nullptr, y_out, M,
                                         F, 0, dh, dy, s)
               : static_cast<int>(cudaErrorInvalidValue);
#define PPGS_FFN_LN(CW, ACT)                                               \
  if (C == CW && act == ACT)                                               \
    return launch<float, CW, ACT>(x, w1, b1, w2, b2, gamma, beta, out,    \
                                  n_out, rstd, nullptr, M, F, round_input, \
                                  dh, dy, s);
  PPGS_FFN_LN(256, RELU)    // mel
  PPGS_FFN_LN(512, RELU)    // the w2v2fb / w2v2fc head
  PPGS_FFN_LN(768, GELU)    // the wav2vec2 trunk
#undef PPGS_FFN_LN
  return static_cast<int>(cudaErrorInvalidValue);
}
