// K3 out_proj_residual_ln: out = LN1(x + drop(a @ Wo + bo)), C = 256, 512
// or 768 (one template instance each).
//
// Replaces: the per-head output projection and the first LayerNorm inside
// ppgs_tpu/ops/encoder_layer_kernel.py _layer_body
// (`acc += dot(oh, wo[sl])`; `r = _ln(x32 + acc + bo, g1, be1)`), run per
// layer by encoder_stack's _stack_kernel; and, with the keep_sa dropout
// site on, the same step of ppgs_tpu/ops/encoder_layer_train.py
// _fwd_compute (`od = keep_sa ? o1 / (1 - rate) : 0`, `r = LN1(x + od)`),
// where it also saves the normalised rows and 1/std for the backward.
//
// Rounding follows the TPU kernel: the attention output a is bf16 (the
// TPU rounds each head's output to the compute dtype before its product),
// the product accumulates in fp32, the fp32 residual is added without
// rounding, and the LayerNorm statistics are fp32 (two-pass).
//
// Bound on an H100 at the main path's shape (M = 64,000 rows): 164 MB moved
// (bf16 a, fp32 x in, fp32 out) against 8.4 GFLOP, so memory bound
// (~49 us); at the training shape (M = 131,072) with the statistics
// saved, 0.47 GB (~0.14 ms); the w2v2 trunk (M = 25,600, C = 768) and the
// w2v2fb head (M = 64,000, C = 512) are memory bound too. The design gives
// one block whole rows (32 of them) so the LayerNorm runs in the epilogue
// and the pre-norm sum never reaches memory; Wo (up to 1.2 MB) stays in
// L2. Eight warps split a 32 x C tile as 2 x 4, 16 rows by C/4 columns
// each (at most 12 accumulator fragments a warp). The Wo tile (64 x C) and
// the fp32 epilogue tile (32 x C) take up to 99 KB at C = 768, past the
// 48 KB of static shared memory, so the tile is dynamic shared memory.
// Plain wmma with synchronous loads.

#include "common.cuh"
#include "philox.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int BM = 32, BK = 64, THREADS = 256;
constexpr int A_LD = BK + 8;

template <int C>
struct Plan {
  static constexpr int B_LD = C + 8;
  static constexpr int Y_LD = C + 4;
  static constexpr int OPERANDS = (BM * A_LD + BK * B_LD) * 2;
  static constexpr int EPILOGUE = BM * Y_LD * 4;
  static constexpr int SMEM = OPERANDS > EPILOGUE ? OPERANDS : EPILOGUE;
};

template <int C>
__global__ void __launch_bounds__(THREADS)
out_proj_ln_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ x,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ out,
                   float* __restrict__ n_out, float* __restrict__ rstd, int M,
                   ppgs::Dropout drop) {
  constexpr int B_LD = Plan<C>::B_LD, Y_LD = Plan<C>::Y_LD;
  constexpr int WN = C / 4, NF = WN / 16;   // a warp's columns, fragments
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + BM * A_LD;
  float* sY = reinterpret_cast<float*>(smem);

  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, M - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 4) * 16;   // the warp's 16 rows
  const int wc = (warp % 4) * WN;   // and C/4 columns

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < C; k0 += BK) {
    __syncthreads();
    ppgs::load_tile_bf16<BM, BK, THREADS>(
        sA, A_LD, a + (long long)row0 * C + k0, C, rows);
    ppgs::load_tile_bf16<BK, C, THREADS>(
        sB, B_LD, w + (long long)k0 * C, C, BK);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sA + wr * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sB + kk * B_LD + wc + j * 16, B_LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(sY + wr * Y_LD + wc + j * 16, acc[j], Y_LD,
                            wmma::mem_row_major);
  __syncthreads();

  // Epilogue: each warp normalises 4 whole rows, C/32 columns per lane
  constexpr int VPL = C / 32;
  const int c0 = lane * VPL;
  ppgs::KeepStream keep(drop);
  for (int r = warp * 4; r < warp * 4 + 4; ++r) {
    if (r >= rows) break;
    const long long g = (long long)(row0 + r) * C + c0;
    float v[VPL];
#pragma unroll
    for (int e4 = 0; e4 < VPL; e4 += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(x + g + e4);
      const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e4 + j;
        const float acc = sY[r * Y_LD + c0 + e];
        v[e] = drop.threshold
                   ? xs[j] + (keep.keep(g + e)
                                  ? (acc + bias[c0 + e]) * drop.scale
                                  : 0.f)
                   : xs[j] + acc + bias[c0 + e];
      }
    }
    const long long row = row0 + r;
    ppgs::layer_norm_row<C>(v, gamma, beta, out + row * C,
                            n_out ? n_out + row * C : nullptr,
                            rstd ? rstd + row : nullptr);
  }
}

template <int C>
int launch(const void* a, const void* w, const void* bias, const void* x,
           const void* gamma, const void* beta, void* out, void* n_out,
           void* rstd, int M, ppgs::Dropout drop, cudaStream_t stream) {
  constexpr int SMEM = Plan<C>::SMEM;
  // Above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      out_proj_ln_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M > 0) {
    out_proj_ln_kernel<C><<<(M + BM - 1) / BM, THREADS, SMEM, stream>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(x),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<float*>(out), static_cast<float*>(n_out),
        static_cast<float*>(rstd), M, drop);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, C) bf16, w (C, C) bf16, bias/gamma/beta (C) fp32, x (M, C) fp32 ->
// out (M, C) fp32, and n_out (M, C) and rstd (M) fp32 unless null; C is
// 256, 512 or 768 (any other returns cudaErrorInvalidValue). The dropout
// site (threshold 0: off) drops a @ w + bias.
extern "C" int ppgs_out_proj_ln(const void* a, const void* w, const void* bias,
                                const void* x, const void* gamma,
                                const void* beta, void* out, void* n_out,
                                void* rstd, int M, int C, unsigned seed_lo,
                                unsigned seed_hi, unsigned site,
                                unsigned threshold, float scale,
                                void* stream) {
  const ppgs::Dropout drop =
      ppgs::make_dropout(seed_lo, seed_hi, site, threshold, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 256:
      return launch<256>(a, w, bias, x, gamma, beta, out, n_out, rstd, M,
                         drop, s);
    case 512:
      return launch<512>(a, w, bias, x, gamma, beta, out, n_out, rstd, M,
                         drop, s);
    case 768:
      return launch<768>(a, w, bias, x, gamma, beta, out, n_out, rstd, M,
                         drop, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
