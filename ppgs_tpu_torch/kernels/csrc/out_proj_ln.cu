// K3 out_proj_residual_ln: out = LN1(x + a @ Wo + bo), C = 256.
//
// Replaces: the per-head output projection and the first LayerNorm inside
// ppgs_tpu/ops/encoder_layer_kernel.py _layer_body
// (`acc += dot(oh, wo[sl])`; `r = _ln(x32 + acc + bo, g1, be1)`), run per
// layer by encoder_stack's _stack_kernel.
//
// Rounding follows the TPU kernel: the attention output a is bf16 (the
// TPU rounds each head's output to the compute dtype before its product),
// the product accumulates in fp32, the fp32 residual is added without
// rounding, and the LayerNorm statistics are fp32 (two-pass).
//
// Bound on an H100 at the main path's shape (M = 64,000 rows): 164 MB moved
// (bf16 a, fp32 x in, fp32 out) against 8.4 GFLOP, so memory bound
// (~49 us). The design gives one block whole 256-wide rows (32 of them) so
// the LayerNorm runs in the epilogue and the pre-norm sum never reaches
// memory; Wo (128 KB) stays in L2. Plain wmma with synchronous loads.

#include "common.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int C = 256, BM = 32, BK = 64, THREADS = 256;
constexpr int A_LD = BK + 8;
constexpr int B_LD = C + 8;
constexpr int Y_LD = C + 4;
constexpr int SMEM_OPERANDS = (BM * A_LD + BK * B_LD) * 2;
constexpr int SMEM_EPILOGUE = BM * Y_LD * 4;
constexpr int SMEM = SMEM_OPERANDS > SMEM_EPILOGUE ? SMEM_OPERANDS
                                                   : SMEM_EPILOGUE;

__global__ void __launch_bounds__(THREADS)
out_proj_ln_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ x,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ out,
                   int M) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + BM * A_LD;
  float* sY = reinterpret_cast<float*>(smem);

  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, M - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 4) * 16;   // the warp's 16 rows
  const int wc = (warp % 4) * 64;   // and 64 columns

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

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
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sB + kk * B_LD + wc + j * 16, B_LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(sY + wr * Y_LD + wc + j * 16, acc[j], Y_LD,
                            wmma::mem_row_major);
  __syncthreads();

  // Epilogue: each warp normalises 4 whole rows, 8 columns per lane
  const int c0 = lane * 8;
  for (int r = warp * 4; r < warp * 4 + 4; ++r) {
    if (r >= rows) break;
    const long long g = (long long)(row0 + r) * C + c0;
    const float4 x0 = *reinterpret_cast<const float4*>(x + g);
    const float4 x1 = *reinterpret_cast<const float4*>(x + g + 4);
    const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = xs[e] + sY[r * Y_LD + c0 + e] + bias[c0 + e];
    ppgs::layer_norm_row256(v, gamma, beta, out + (long long)(row0 + r) * C);
  }
}

}  // namespace

// a (M, 256) bf16, w (256, 256) bf16, bias/gamma/beta (256) fp32,
// x (M, 256) fp32 -> out (M, 256) fp32.
extern "C" int ppgs_out_proj_ln(const void* a, const void* w, const void* bias,
                                const void* x, const void* gamma,
                                const void* beta, void* out, int M,
                                void* stream) {
  if (M > 0) {
    out_proj_ln_kernel<<<(M + BM - 1) / BM, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(x),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<float*>(out), M);
  }
  return static_cast<int>(cudaGetLastError());
}
