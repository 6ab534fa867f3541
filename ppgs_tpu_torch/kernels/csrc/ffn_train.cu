// The FFN's training backward, C = 256, F % 128 == 0; the forward is K4
// (ffn_ln.cu) with its dropout sites on.
//
// Replaces: the backward of ppgs_tpu/ops/fused_ffn.py ffn_train
// (_ffn_train_bwd_kernel) and the FFN half of the backward of
// ppgs_tpu/ops/encoder_layer_train.py (_bwd_kernel after LN2).
//
// The backward takes dy already masked and rounded (bf16; the LayerNorm
// backward or the dropout replay before it makes it) and, per block of 64
// rows and 128-wide chunk of F: recomputes h = relu(bf16(bf16(x W1) +
// bf16(b1))), regenerates keep_h, dhd = keep_h ? (dy W2^T) / (1 - rate) : 0,
// dh = h > 0 ? dhd : 0, and accumulates dx += bf16(dh) W1^T. It writes
// hd = keep_h ? bf16(h * bf16(1 / (1 - rate))) : 0 and bf16(dh) (M x F,
// bf16) for the weight-gradient products dW2 = hd^T dy and dW1 = x^T
// bf16(dh), which run as GEMMs (gemm.cu): those reduce over all M rows,
// which the TPU kernel accumulates across its sequential grid and Hopper's
// parallel blocks cannot. db1's per-block column partials of the fp32 dh
// are written here and summed by colsum.
//
// Bound on an H100 at the training shape (M = 131,072, F = 2048): the
// function's three products, 6 x M x 256 x 2048 = 412 GFLOP (~0.42 ms),
// against 0.47 GB of inputs and dx: bound by the tensor cores. The hd and
// dh round trip (1.07 GB written here, read by the GEMMs) is the cost of
// splitting the weight gradients out. Plain wmma with synchronous loads:
// right first.

#include "common.cuh"
#include "philox.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int C = 256, BM = 64, FC = 128, THREADS = 256;
constexpr int A_LD = C + 8;     // bf16 64 x 256 tiles (x, dy)
constexpr int H_LD = FC + 8;    // bf16 64 x 128 chunk
constexpr int HF_LD = FC + 4;   // fp32 64 x 128 chunk
constexpr int Y_LD = C + 4;     // fp32 64 x 256 epilogue

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void load_rows(bf16* s, const float* g, int rows) {
  ppgs::load_tile_f32_as_bf16<BM, C, THREADS>(s, A_LD, g, C, rows);
}
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, int rows) {
  ppgs::load_tile_bf16<BM, C, THREADS>(s, A_LD, g, C, rows);
}

// out(16 x 64 per warp, fp32 in shared memory) = a(64 x 256) W1[:, f0:+128]
// for the warp's rows wr and hidden columns wc; W1 streams through sW in
// 64-deep slices.
__device__ __forceinline__ void hidden_chunk(const bf16* sA, bf16* sW,
                                             const bf16* w1, int F, int f0,
                                             int wr, int wc, float* out) {
  FragC h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(h[j], 0.f);
  for (int k0 = 0; k0 < C; k0 += 64) {
    __syncthreads();
    ppgs::load_tile_bf16<64, FC, THREADS>(sW, H_LD,
                                          w1 + (long long)k0 * F + f0, F, 64);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, sA + wr * A_LD + k0 + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, sW + kk * H_LD + wc + j * 16, H_LD);
        wmma::mma_sync(h[j], fa, fb, h[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(out + wr * HF_LD + wc + j * 16, h[j], HF_LD,
                            wmma::mem_row_major);
}

// --------------------------------------------------------------- backward

constexpr int BW_X = 0;
constexpr int BW_DY = BW_X + BM * A_LD * 2;
constexpr int BW_DH = BW_DY + BM * A_LD * 2;
constexpr int BW_W = BW_DH + BM * H_LD * 2;
constexpr int BW_W_BYTES = 256 * 40 * 2;       // the largest W slice
constexpr int BW_HF = BW_W + BW_W_BYTES;
constexpr int BW_DF = BW_HF + BM * HF_LD * 4;
constexpr int BW_SMEM = BW_DF + BM * HF_LD * 4;
static_assert(64 * H_LD * 2 <= BW_W_BYTES && 128 * 72 * 2 <= BW_W_BYTES,
              "W slices overflow their buffer");
static_assert(BM * Y_LD * 4 <= 2 * BM * HF_LD * 4, "epilogue overflows");
static_assert(BW_W % 128 == 0 && BW_HF % 128 == 0 && BW_DF % 128 == 0,
              "shared-memory regions must stay aligned");

template <typename TX, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_kernel(const TX* __restrict__ x, const bf16* __restrict__ dy,
               const bf16* __restrict__ w1, const float* __restrict__ b1,
               const bf16* __restrict__ w2, const float* __restrict__ residual,
               float* __restrict__ dx32, bf16* __restrict__ dx16,
               bf16* __restrict__ hd_out, bf16* __restrict__ dh_out,
               float* __restrict__ db1_partial, int M, int F,
               ppgs::Dropout drop_h) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem + BW_X);
  bf16* sDY = reinterpret_cast<bf16*>(smem + BW_DY);
  bf16* sDH = reinterpret_cast<bf16*>(smem + BW_DH);
  bf16* sW = reinterpret_cast<bf16*>(smem + BW_W);
  float* sHf = reinterpret_cast<float*>(smem + BW_HF);
  float* sDf = reinterpret_cast<float*>(smem + BW_DF);
  float* sY = sHf;                      // epilogue, over sHf and sDf

  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, M - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 2) * 16, wc1 = (warp % 2) * 64, wc2 = (warp % 2) * 128;
  const float scale_h = ppgs::round_bf16(drop_h.scale);
  ppgs::KeepStream keep_h(drop_h);

  load_rows(sX, x + (long long)row0 * C, rows);
  load_rows(sDY, dy + (long long)row0 * C, rows);

  FragC acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int f0 = 0; f0 < F; f0 += FC) {
    // h = x W1[:, chunk] (recomputed)
    hidden_chunk(sX, sW, w1, F, f0, wr, wc1, sHf);
    // dhd = dy W2[chunk, :]^T, 64 deep at a time: the slice is W2's rows
    // f0..f0+128 and columns k0..k0+64, read as a column-major B
    {
      FragC d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(d[j], 0.f);
      for (int k0 = 0; k0 < C; k0 += 64) {
        __syncthreads();
        ppgs::load_tile_bf16<FC, 64, THREADS>(
            sW, 72, w2 + (long long)f0 * C + k0, C, FC);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < 64; kk += 16) {
          FragA fa;
          wmma::load_matrix_sync(fa, sDY + wr * A_LD + k0 + kk, A_LD);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragBc fb;
            wmma::load_matrix_sync(fb, sW + (wc1 + j * 16) * 72 + kk, 72);
            wmma::mma_sync(d[j], fa, fb, d[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(sDf + wr * HF_LD + wc1 + j * 16, d[j], HF_LD,
                                wmma::mem_row_major);
    }
    __syncwarp();
    // Elementwise on the warp's 16 x 64 piece: lane owns 32 consecutive
    // columns of one row
    {
      const int r = wr + lane / 2, c_first = wc1 + (lane % 2) * 32;
      const bool live = row0 + r < M;
      const unsigned long long base =
          (unsigned long long)(row0 + r) * F + f0;
      bf16* hd_row = hd_out + (unsigned long long)(row0 + r) * F + f0;
      bf16* dh_row = dh_out + (unsigned long long)(row0 + r) * F + f0;
      for (int c = c_first; c < c_first + 32; c += 8) {
        __align__(16) bf16 hd8[8], dh8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int cc = c + e;
          const float h = fmaxf(
              ppgs::round_bf16(ppgs::round_bf16(sHf[r * HF_LD + cc]) +
                               ppgs::round_bf16(b1[f0 + cc])), 0.f);
          float dhd = sDf[r * HF_LD + cc], hd = h;
          if (drop_h.threshold) {
            const bool kept = live && keep_h.keep(base + cc);
            hd = kept ? ppgs::round_bf16(h * scale_h) : 0.f;
            dhd = kept ? dhd * drop_h.scale : 0.f;
          }
          const float dh = (live && h > 0.f) ? dhd : 0.f;
          sDf[r * HF_LD + cc] = dh;                 // for db1
          dh8[e] = __float2bfloat16(dh);
          hd8[e] = __float2bfloat16(hd);
          sDH[r * H_LD + cc] = dh8[e];
        }
        if (live) {
          *reinterpret_cast<uint4*>(hd_row + c) =
              *reinterpret_cast<const uint4*>(hd8);
          *reinterpret_cast<uint4*>(dh_row + c) =
              *reinterpret_cast<const uint4*>(dh8);
        }
      }
    }
    __syncthreads();
    // db1 partials: column sums of the fp32 dh over the block's rows
    if (threadIdx.x < FC) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += sDf[r * HF_LD + threadIdx.x];
      db1_partial[(long long)blockIdx.x * F + f0 + threadIdx.x] = s;
    }
    // dx += bf16(dh) W1[:, chunk]^T, 32 deep at a time: the slice is W1's
    // rows 0..256 and columns f0+k0..+32, read as a column-major B
    for (int k0 = 0; k0 < FC; k0 += 32) {
      __syncthreads();
      ppgs::load_tile_bf16<C, 32, THREADS>(sW, 40, w1 + f0 + k0, F, C);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, sDH + wr * H_LD + k0 + kk, H_LD);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          FragBc fb;
          wmma::load_matrix_sync(fb, sW + (wc2 + j * 16) * 40 + kk, 40);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wmma::store_matrix_sync(sY + wr * Y_LD + wc2 + j * 16, acc[j], Y_LD,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * C / 8; i += THREADS) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    if (r >= rows) continue;
    const long long g = (long long)(row0 + r) * C + c;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = sY[r * Y_LD + c + e] + (RESIDUAL ? residual[g + e] : 0.f);
    if (dx32) {
      float4* d = reinterpret_cast<float4*>(dx32 + g);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    if (dx16) {
      __align__(16) bf16 o8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o8[e] = __float2bfloat16(v[e]);
      *reinterpret_cast<uint4*>(dx16 + g) = *reinterpret_cast<const uint4*>(o8);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Backward. x (M, 256): fp32 (x_is_f32 = 1, rounded to bf16 as read) or
// bf16; dy (M, 256) bf16, masked and rounded; residual (M, 256) fp32 added
// to dx, or null. dx32 (fp32) and/or dx16 (bf16) (M, 256); hd_out, dh_out
// (M, F) bf16; db1_partial (ceil(M/64), F) fp32.
extern "C" int ppgs_ffn_train_bwd(
    const void* x, int x_is_f32, const void* dy, const void* w1,
    const void* b1, const void* w2, const void* residual, void* dx32,
    void* dx16, void* hd_out, void* dh_out, void* db1_partial, int M, int F,
    unsigned seed_lo, unsigned seed_hi, unsigned site_h, unsigned threshold,
    float scale, void* stream) {
  auto k_f32 = ffn_bwd_kernel<float, true>;
  auto k_bf16 = ffn_bwd_kernel<bf16, false>;
  cudaError_t err =
      x_is_f32 ? allow_smem(k_f32, BW_SMEM) : allow_smem(k_bf16, BW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M > 0) {
    const ppgs::Dropout dh =
        ppgs::make_dropout(seed_lo, seed_hi, site_h, threshold, scale);
    const unsigned blocks = (M + BM - 1) / BM;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_f32)
      k_f32<<<blocks, THREADS, BW_SMEM, s>>>(
          static_cast<const float*>(x), static_cast<const bf16*>(dy),
          static_cast<const bf16*>(w1), static_cast<const float*>(b1),
          static_cast<const bf16*>(w2), static_cast<const float*>(residual),
          static_cast<float*>(dx32), static_cast<bf16*>(dx16),
          static_cast<bf16*>(hd_out), static_cast<bf16*>(dh_out),
          static_cast<float*>(db1_partial), M, F, dh);
    else
      k_bf16<<<blocks, THREADS, BW_SMEM, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
          static_cast<const bf16*>(w1), static_cast<const float*>(b1),
          static_cast<const bf16*>(w2), nullptr, static_cast<float*>(dx32),
          static_cast<bf16*>(dx16), static_cast<bf16*>(hd_out),
          static_cast<bf16*>(dh_out), static_cast<float*>(db1_partial), M, F,
          dh);
  }
  return static_cast<int>(cudaGetLastError());
}
