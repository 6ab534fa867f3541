// K1 qkv_proj: out = bf16(bf16(x) @ W + b), the fused QKV projection of one
// encoder layer.
//
// Replaces: the QKV product inside ppgs_tpu/ops/encoder_layer_kernel.py
// _layer_body (`qkv = dot_cd(xc, wqkv, bqkv)`), run per layer by
// encoder_stack's _stack_kernel. The softmax scale times log2(e) is folded
// into the q third of W and b on the host, as encoder_stack does.
//
// Rounding follows the TPU kernel: the fp32 residual x is rounded to bf16
// as it is loaded, products accumulate in fp32, the sum is rounded to bf16
// before the bf16 bias is added (dot_cd), and the result is bf16.
//
// Bound on an H100 at the main path's shape (M = 64,000 rows, K = 256,
// N = 768): 164 MB moved (fp32 x in, bf16 out) against 25 GFLOP, so memory
// bound (~49 us). The design reads x once, in 64-row tiles, converting it
// in the load; W (384 KB) stays in L2 and is re-read per tile. It is a
// plain wmma (bf16 16x16x16, fp32 accumulate) tile with synchronous loads:
// right first, fast later (wgmma and TMA are for a later change).

#include "common.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int BM = 64, BN = 128, BK = 64, THREADS = 256;
constexpr int A_LD = BK + 8;   // bf16 row strides padded by 16 bytes
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;   // fp32 epilogue tile
constexpr int SMEM_OPERANDS = (BM * A_LD + BK * B_LD) * 2;
constexpr int SMEM_EPILOGUE = BM * C_LD * 4;
constexpr int SMEM = SMEM_OPERANDS > SMEM_EPILOGUE ? SMEM_OPERANDS
                                                   : SMEM_EPILOGUE;

__global__ void __launch_bounds__(THREADS)
qkv_proj_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, bf16* __restrict__ out,
                int M, int K, int N) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + BM * A_LD;
  float* sC = reinterpret_cast<float*>(smem);

  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int rows = min(BM, M - row0);
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 16;   // the warp's 16 rows
  const int wc = (warp % 2) * 64;   // and 64 columns

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    ppgs::load_tile_f32_as_bf16<BM, BK, THREADS>(
        sA, A_LD, x + (long long)row0 * K + k0, K, rows);
    ppgs::load_tile_bf16<BK, BN, THREADS>(
        sB, B_LD, w + (long long)k0 * N + col0, N, BK);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sA + wr * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sB + kk * B_LD + wc + j * 16, B_LD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(sC + wr * C_LD + wc + j * 16, acc[j], C_LD,
                            wmma::mem_row_major);
  __syncthreads();

  // Epilogue, 8 columns (16 bytes of output) per thread and step
  for (int i = threadIdx.x; i < BM * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    if (r >= rows) continue;
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = __float2bfloat16(ppgs::round_bf16(sC[r * C_LD + c + e]) +
                              ppgs::round_bf16(bias[col0 + c + e]));
    *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * N + col0 + c) =
        *reinterpret_cast<const uint4*>(o);
  }
}

}  // namespace

// x (M, K) fp32, w (K, N) bf16, b (N) fp32 -> out (M, N) bf16.
// K % 64 == 0 and N % 128 == 0 (checked by the Python wrapper).
extern "C" int ppgs_qkv_proj(const void* x, const void* w, const void* b,
                             void* out, int M, int K, int N, void* stream) {
  if (M > 0) {
    dim3 grid((M + BM - 1) / BM, N / BN);
    qkv_proj_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const bf16*>(w),
        static_cast<const float*>(b), static_cast<bf16*>(out), M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
