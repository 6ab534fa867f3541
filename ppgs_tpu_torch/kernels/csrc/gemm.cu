// A bf16 matrix product with fp32 accumulation and transpose flags, for
// the products of the training layer's backward that are not inside
// another kernel: the data gradients through the attention projections
// (da = do Wo^T, dx += dqkv Wqkv^T) and the weight gradients
// (dWo = a^T do, dWqkv = x^T dqkv, dW1 = r^T dh, dW2 = hd^T dy).
//
// Replaces: the `dot(..., w*t_ref)` and `dotT(...)` products of
// ppgs_tpu/ops/encoder_layer_train.py _bwd_kernel and the dw1/dw2 products
// of ppgs_tpu/ops/fused_ffn.py _ffn_train_bwd_kernel. The TPU kernels sum
// the weight gradients over their sequential grid into revisited output
// blocks; here a weight gradient is a product whose depth is all M rows
// (131,072 at the training shape) with a small output (at most 2048 x 256),
// so it splits the depth over blockIdx.z, each split writing fp32 partial
// sums, and colsum (layer_train.cu) adds the partials in a fixed order:
// deterministic, no atomics.
//
// C[m, n] = sum_k A(m, k) B(k, n) with A(m, k) = a[m, k] (ta = 0) or
// a[k, m] (ta = 1), B(k, n) = b[k, n] (tb = 0) or b[n, k] (tb = 1); A may
// be fp32, rounded to bf16 as it is read (the TPU's x.astype(cd)). The
// epilogue writes fp32 (plus an fp32 residual, where given) and/or bf16.
// Taken shapes: ta = 0, tb = 1 (data gradients; K % 32 == 0, N % 128 ==
// 0, any M) and ta = 1, tb = 0 (weight gradients; M % 64 == 0, N % 128
// == 0, any K).
//
// Bound on an H100: every product here is 2 x 131,072 x 256 x (256 to
// 2048) FLOP = 17-137 GFLOP on inputs of 64-512 MB, near the card's ridge;
// this plain wmma tile with synchronous loads is right first, not fast.

#include "common.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int BM = 64, BN = 128, BK = 32, THREADS = 256;
constexpr int C_LD = BN + 4;
constexpr int SMEM = BM * C_LD * 4;   // the epilogue tile, over the operands

template <int ROWS, int COLS>
__device__ __forceinline__ void load_a(bf16* s, int sld, const bf16* g,
                                       long long ld, int limit) {
  ppgs::load_tile_bf16<ROWS, COLS, THREADS>(s, sld, g, ld, limit);
}
template <int ROWS, int COLS>
__device__ __forceinline__ void load_a(bf16* s, int sld, const float* g,
                                       long long ld, int limit) {
  ppgs::load_tile_f32_as_bf16<ROWS, COLS, THREADS>(s, sld, g, ld, limit);
}

template <bool TA, bool TB, typename TAType>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const TAType* __restrict__ a, long long lda,
            const bf16* __restrict__ b, long long ldb, float* __restrict__ out32,
            bf16* __restrict__ out16, const float* __restrict__ residual,
            long long ldc, int M, int N, int K, int k_chunk) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  constexpr int A_LD = TA ? BM + 8 : BK + 8;   // [BK][BM] or [BM][BK]
  constexpr int B_LD = TB ? BK + 8 : BN + 8;   // [BN][BK] or [BK][BN]
  constexpr int A_BYTES = (TA ? BK * A_LD : BM * A_LD) * 2;
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + ((A_BYTES + 127) / 128) * 128);
  float* sC = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 16, wc = (warp % 2) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    if (TA)   // rows k0.. of a (K x M), columns m0..m0+64
      load_a<BK, BM>(sA, A_LD, a + (long long)k0 * lda + m0, lda, k_end - k0);
    else      // rows m0.. of a (M x K), columns k0..k0+32
      load_a<BM, BK>(sA, A_LD, a + (long long)m0 * lda + k0, lda, M - m0);
    if (TB)   // rows n0.. of b (N x K), columns k0..k0+32
      ppgs::load_tile_bf16<BN, BK, THREADS>(
          sB, B_LD, b + (long long)n0 * ldb + k0, ldb, N - n0);
    else      // rows k0.. of b (K x N), columns n0..n0+128
      ppgs::load_tile_bf16<BK, BN, THREADS>(
          sB, B_LD, b + (long long)k0 * ldb + n0, ldb, k_end - k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      if (TA) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, sA + kk * A_LD + wr, A_LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, sB + kk * B_LD + wc + j * 16, B_LD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      } else {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sA + wr * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              fb;
          wmma::load_matrix_sync(fb, sB + (wc + j * 16) * B_LD + kk, B_LD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(sC + wr * C_LD + wc + j * 16, acc[j], C_LD,
                            wmma::mem_row_major);
  __syncthreads();

  // Epilogue, 8 columns per thread and step; split z writes its own
  // (M, N) slab of partial sums
  const long long slab = (long long)blockIdx.z * M * ldc;
  for (int i = threadIdx.x; i < BM * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    if (m0 + r >= M) continue;
    const long long g = (long long)(m0 + r) * ldc + n0 + c;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = sC[r * C_LD + c + e] + (residual ? residual[g + e] : 0.f);
    if (out32) {
      float4* d = reinterpret_cast<float4*>(out32 + slab + g);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    if (out16) {
      __align__(16) bf16 o8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o8[e] = __float2bfloat16(v[e]);
      *reinterpret_cast<uint4*>(out16 + g) = *reinterpret_cast<const uint4*>(o8);
    }
  }
}

}  // namespace

// C (M, N) = op(a) op(b); see the header for the layouts. a_is_f32: a is
// fp32 (rounded to bf16 as read; ta = 1 only). out32 (fp32, with `splits`
// slabs of (M, N) partials when splits > 1) and/or out16 (bf16, splits ==
// 1), row stride ldc; residual (M, N) fp32 added when not null
// (splits == 1).
extern "C" int ppgs_gemm(const void* a, int a_is_f32, int ta, long long lda,
                         const void* b, int tb, long long ldb, void* out32,
                         void* out16, const void* residual, long long ldc,
                         int M, int N, int K, int splits, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_chunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  dim3 grid((M + BM - 1) / BM, N / BN, splits);
  float* o32 = static_cast<float*>(out32);
  bf16* o16 = static_cast<bf16*>(out16);
  const float* res = static_cast<const float*>(residual);
  const bf16* bb = static_cast<const bf16*>(b);
  if (!ta && tb && !a_is_f32)
    gemm_kernel<false, true, bf16><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(a), lda, bb, ldb, o32, o16, res, ldc, M, N,
        K, k_chunk);
  else if (ta && !tb && !a_is_f32)
    gemm_kernel<true, false, bf16><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(a), lda, bb, ldb, o32, o16, res, ldc, M, N,
        K, k_chunk);
  else if (ta && !tb && a_is_f32)
    gemm_kernel<true, false, float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), lda, bb, ldb, o32, o16, res, ldc, M, N,
        K, k_chunk);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
