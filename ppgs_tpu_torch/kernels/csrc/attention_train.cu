// Attention for training: masked multi-head attention with dropout on the
// normalised probabilities, its backward, and the row products the
// backward needs; d_head = 128, read in place from (B, T, C) layouts.
//
// Replaces: ppgs_tpu/ops/flash_attention.py flash_attention_train
// (_train_fwd_kernel, _train_bwd_kernel) and the attention inside
// ppgs_tpu/ops/encoder_layer_train.py (_fwd_compute's per-head loop and
// _bwd_kernel's attention backward).
//
// Forward (one block per (64 query rows, head, window); four warps of 16
// rows), in two passes over the key tiles, so that the probabilities are
// normalised before they are rounded to bf16, as the TPU kernels round
// them: pass 1 takes the row max m and sum l of the scaled fp32 scores
// (the key and causal masks applied first) online; pass 2 recomputes the
// scores and feeds pd = keep ? exp2(s - lse) / (1 - rate) : 0, rounded to
// bf16, to the PV product, with the keep bit per (window, head, query,
// key) from the Philox stream (philox.cuh). It writes o (bf16, and fp32
// where asked: the whole-layer backward takes rowsum(da * a) with the fp32
// a) and lse = m + log2(l) per row, in log2 units (0 for a row with no
// valid key, which gives o = 0).
//
// Backward, two kernels that recompute the probabilities from lse, so no
// (T, T) tensor reaches memory: dq walks the key tiles of its 64 query
// rows; dk/dv walks the query tiles of its 64 key rows. Both regenerate the
// same keep bits. With pn = exp2(s - lse) (masked), pd = keep ? pn/(1-rate)
// : 0, gp = keep ? (dO V^T)/(1-rate) : 0 and ds = pn (gp - d_row):
// dq = bf16(ds * sm_scale) K, dk = bf16(ds * sm_scale)^T Q,
// dv = bf16(pd)^T dO, all accumulated in fp32 (the JAX kernels' rounding
// points). d_row is given: rowsum(dO * O) per head, from row_dot below.
//
// Bound on an H100 at the training shape (256 windows x T = 512, 2 heads):
// forward 2 x 256 x 2 x 512^2 x 128 x 2 = 69 GFLOP (~70 us), backward
// 2.5x that (~175 us), against ~0.2 GB moved each way: bound by the tensor
// cores. These are right-first kernels: wmma 16x16x16 with synchronous
// tile loads, scores through shared memory, the forward's scores computed
// twice, one Philox call per four keys in the forward and the dq pass and
// one per element in the dk/dv pass.

#include "common.cuh"
#include "philox.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int D = 128, BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int LD = D + 8;        // bf16 128-wide tiles
constexpr int S_LD = BKV + 4;    // fp32 16 x 64 per warp
constexpr int P_LD = BKV + 8;    // bf16 16 x 64 per warp
constexpr int O_LD = D + 4;      // fp32 128-wide rows
constexpr int TILE = BQ * LD * 2;              // one bf16 64 x 128 tile
constexpr int WS = WARPS * 16 * S_LD * 4;      // per-warp fp32 scores
constexpr int WP = WARPS * 16 * P_LD * 2;      // per-warp bf16 probabilities

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out(16 x 64, fp32) = a(16 x 128) b(64 x 128)^T for one warp
__device__ __forceinline__ void rows_times_tile_t(const bf16* a,
                                                  const bf16* b, float* out) {
  FragC s[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(s[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, LD);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragBc fb;
      wmma::load_matrix_sync(fb, b + n * 16 * LD + kk, LD);
      wmma::mma_sync(s[n], fa, fb, s[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(out + n * 16, s[n], S_LD, wmma::mem_row_major);
}

// acc(16 x 128, fp32 in shared memory) += p(16 x 64) v(64 x 128)
__device__ __forceinline__ void accumulate_pv(float* acc, const bf16* p,
                                              const bf16* v) {
  FragC o[8];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    wmma::load_matrix_sync(o[n], acc + n * 16, O_LD, wmma::mem_row_major);
#pragma unroll
  for (int kk = 0; kk < BKV; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + kk, P_LD);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      FragB fb;
      wmma::load_matrix_sync(fb, v + kk * LD + n * 16, LD);
      wmma::mma_sync(o[n], fa, fb, o[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
    wmma::store_matrix_sync(acc + n * 16, o[n], O_LD, wmma::mem_row_major);
}

// Write 64 columns of an fp32 row, times mul, to bf16 and/or fp32 outputs
// (either may be null), 8 columns at a time.
__device__ __forceinline__ void write_row64(const float* src, float mul,
                                            bf16* dst16, float* dst32) {
  for (int c = 0; c < 64; c += 8) {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = src[c + e] * mul;
    if (dst16) {
      __align__(16) bf16 o8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o8[e] = __float2bfloat16(o[e]);
      *reinterpret_cast<uint4*>(dst16 + c) = *reinterpret_cast<const uint4*>(o8);
    }
    if (dst32) {
      float4* d = reinterpret_cast<float4*>(dst32 + c);
      d[0] = make_float4(o[0], o[1], o[2], o[3]);
      d[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
  }
}

// ---------------------------------------------------------------- forward

constexpr int F_Q = 0, F_K = F_Q + TILE, F_V = F_K + TILE, F_S = F_V + TILE;
constexpr int F_P = F_S + WS;
constexpr int F_VALID = F_P + WP;
constexpr int F_SMEM = F_VALID + BKV;
static_assert(2 * TILE >= WARPS * 16 * O_LD * 4, "output staging overflows");

__global__ void __launch_bounds__(THREADS)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, long long rs,
           const uint8_t* __restrict__ mask, bf16* __restrict__ out,
           float* __restrict__ out32, long long out_stride,
           float* __restrict__ lse, int T, int H, float scale_log2, int causal,
           ppgs::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + F_Q);
  bf16* sK = reinterpret_cast<bf16*>(smem + F_K);
  bf16* sV = reinterpret_cast<bf16*>(smem + F_V);
  uint8_t* s_valid = smem + F_VALID;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sS = reinterpret_cast<float*>(smem + F_S) + warp * 16 * S_LD;
  bf16* sP = reinterpret_cast<bf16*>(smem + F_P) + warp * 16 * P_LD;

  // Lanes 2r and 2r+1 own query row r of the warp's 16, 32 score columns
  // and 64 output columns each
  const int row = lane / 2, half = lane % 2;
  const int qrow = q0 + warp * 16 + row;
  const long long head = (long long)h * D, batch_row = (long long)b * T;
  const unsigned long long bh_row =
      ((unsigned long long)(b * H + h) * T + qrow) * T;
  ppgs::KeepStream stream(drop);

  ppgs::load_tile_bf16<BQ, D, THREADS>(
      sQ, LD, q + (batch_row + q0) * rs + head, rs, min(BQ, T - q0));
  int n_tiles = (T + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);
  float* srow = sS + row * S_LD + half * 32;

  // Pass 1: the row max m and sum l of exp2(s - m), online over key tiles
  float m = ppgs::NEG_INF, l = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    ppgs::load_tile_bf16<BKV, D, THREADS>(
        sK, LD, k + (batch_row + k0) * rs + head, rs, min(BKV, T - k0));
    for (int i = threadIdx.x; i < BKV; i += THREADS)
      s_valid[i] = (k0 + i < T) ? mask[batch_row + k0 + i] : 0;
    __syncthreads();
    rows_times_tile_t(sQ + warp * 16 * LD, sK, sS);
    __syncwarp();
    float tile_max = ppgs::NEG_INF;
    for (int c = 0; c < 32; ++c) {
      const int key = k0 + half * 32 + c;
      const bool ok = s_valid[half * 32 + c] && (!causal || key <= qrow);
      const float sc = ok ? srow[c] * scale_log2 : ppgs::NEG_INF;
      srow[c] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    float psum = 0.f;
    for (int c = 0; c < 32; ++c)
      psum += srow[c] > 0.5f * ppgs::NEG_INF ? exp2f(srow[c] - m_new) : 0.f;
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * exp2f(m - m_new) + psum;
    m = m_new;
  }
  const float row_lse = l > 0.f ? m + log2f(l) : 0.f;

  // Pass 2: o = sum_k bf16(keep ? exp2(s - lse) / (1 - rate) : 0) v_k
  FragC acc[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    ppgs::load_tile_bf16<BKV, D, THREADS>(
        sK, LD, k + (batch_row + k0) * rs + head, rs, min(BKV, T - k0));
    ppgs::load_tile_bf16<BKV, D, THREADS>(
        sV, LD, v + (batch_row + k0) * rs + head, rs, min(BKV, T - k0));
    for (int i = threadIdx.x; i < BKV; i += THREADS)
      s_valid[i] = (k0 + i < T) ? mask[batch_row + k0 + i] : 0;
    __syncthreads();
    rows_times_tile_t(sQ + warp * 16 * LD, sK, sS);
    __syncwarp();
    bf16* prow = sP + row * P_LD + half * 32;
    for (int c = 0; c < 32; ++c) {
      const int key = k0 + half * 32 + c;
      const bool ok = qrow < T && s_valid[half * 32 + c] &&
                      (!causal || key <= qrow);
      float pd = ok ? exp2f(srow[c] * scale_log2 - row_lse) : 0.f;
      if (drop.threshold)
        pd = (ok && stream.keep(bh_row + key)) ? pd * drop.scale : 0.f;
      prow[c] = __float2bfloat16(pd);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, sP + kk, P_LD);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        FragB fb;
        wmma::load_matrix_sync(fb, sV + kk * LD + n * 16, LD);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }
  __syncthreads();
  float* sOut = reinterpret_cast<float*>(smem + F_K) + warp * 16 * O_LD;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    wmma::store_matrix_sync(sOut + n * 16, acc[n], O_LD, wmma::mem_row_major);
  __syncwarp();
  if (qrow < T) {
    const long long o = (batch_row + qrow) * out_stride + head + half * 64;
    write_row64(sOut + row * O_LD + half * 64, 1.f, out + o,
                out32 ? out32 + o : nullptr);
    if (half == 0) lse[(long long)(b * H + h) * T + qrow] = row_lse;
  }
}

// ------------------------------------------------------- backward: dq pass

constexpr int Q_Q = 0, Q_DO = Q_Q + TILE, Q_K = Q_DO + TILE, Q_V = Q_K + TILE;
constexpr int Q_S = Q_V + TILE, Q_DP = Q_S + WS, Q_DS = Q_DP + WS;
constexpr int Q_ROWS = Q_DS + WP;                  // lse, d_row: 2 x 64 fp32
constexpr int Q_VALID = Q_ROWS + 2 * BQ * 4;
constexpr int Q_SMEM = Q_VALID + BKV;
static_assert(2 * TILE >= WARPS * 16 * O_LD * 4, "dq staging overflows");

__global__ void __launch_bounds__(THREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, long long rs,
          const uint8_t* __restrict__ mask, const float* __restrict__ lse,
          const bf16* __restrict__ dout, long long do_stride,
          const float* __restrict__ d_row, bf16* __restrict__ dq16,
          float* __restrict__ dq32, long long dq_stride, int T, int H,
          float scale_log2, float sm_scale, int causal, ppgs::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + Q_Q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + Q_DO);
  bf16* sK = reinterpret_cast<bf16*>(smem + Q_K);
  bf16* sV = reinterpret_cast<bf16*>(smem + Q_V);
  float* s_lse = reinterpret_cast<float*>(smem + Q_ROWS);
  float* s_drow = s_lse + BQ;
  uint8_t* s_valid = smem + Q_VALID;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sS = reinterpret_cast<float*>(smem + Q_S) + warp * 16 * S_LD;
  float* sDP = reinterpret_cast<float*>(smem + Q_DP) + warp * 16 * S_LD;
  bf16* sDS = reinterpret_cast<bf16*>(smem + Q_DS) + warp * 16 * P_LD;

  const int row = lane / 2, half = lane % 2;
  const int lrow = warp * 16 + row, qrow = q0 + lrow;
  const long long head = (long long)h * D, batch_row = (long long)b * T;
  const long long bh = (long long)(b * H + h) * T;
  const unsigned long long bh_row = ((unsigned long long)bh + qrow) * T;
  ppgs::KeepStream stream(drop);

  const int rows = min(BQ, T - q0);
  ppgs::load_tile_bf16<BQ, D, THREADS>(
      sQ, LD, q + (batch_row + q0) * rs + head, rs, rows);
  ppgs::load_tile_bf16<BQ, D, THREADS>(
      sDO, LD, dout + (batch_row + q0) * do_stride + head, do_stride, rows);
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    s_lse[i] = i < rows ? lse[bh + q0 + i] : 0.f;
    s_drow[i] = i < rows ? d_row[bh + q0 + i] : 0.f;
  }

  FragC acc[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) wmma::fill_fragment(acc[n], 0.f);

  int n_tiles = (T + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    ppgs::load_tile_bf16<BKV, D, THREADS>(
        sK, LD, k + (batch_row + k0) * rs + head, rs, min(BKV, T - k0));
    ppgs::load_tile_bf16<BKV, D, THREADS>(
        sV, LD, v + (batch_row + k0) * rs + head, rs, min(BKV, T - k0));
    for (int i = threadIdx.x; i < BKV; i += THREADS)
      s_valid[i] = (k0 + i < T) ? mask[batch_row + k0 + i] : 0;
    __syncthreads();

    rows_times_tile_t(sQ + warp * 16 * LD, sK, sS);
    rows_times_tile_t(sDO + warp * 16 * LD, sV, sDP);
    __syncwarp();

    const float lse_r = s_lse[lrow], drow_r = s_drow[lrow];
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c, key = k0 + col;
      const bool ok = qrow < T && s_valid[col] && (!causal || key <= qrow);
      const float pn =
          ok ? exp2f(sS[row * S_LD + col] * scale_log2 - lse_r) : 0.f;
      float gp = sDP[row * S_LD + col];
      if (drop.threshold)
        gp = (ok && stream.keep(bh_row + key)) ? gp * drop.scale : 0.f;
      sDS[row * P_LD + col] = __float2bfloat16(pn * (gp - drow_r) * sm_scale);
    }
    __syncwarp();

    // dq += ds K
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, sDS + kk, P_LD);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        FragB fb;
        wmma::load_matrix_sync(fb, sK + kk * LD + n * 16, LD);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }
  __syncthreads();
  float* sOut = reinterpret_cast<float*>(smem + Q_K) + warp * 16 * O_LD;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    wmma::store_matrix_sync(sOut + n * 16, acc[n], O_LD, wmma::mem_row_major);
  __syncwarp();
  if (qrow < T) {
    const long long o = (batch_row + qrow) * dq_stride + head + half * 64;
    write_row64(sOut + row * O_LD + half * 64, 1.f, dq16 ? dq16 + o : nullptr,
                dq32 ? dq32 + o : nullptr);
  }
}

// -------------------------------------------------- backward: dk, dv pass

constexpr int K_K = 0, K_V = K_K + TILE, K_Q = K_V + TILE, K_DO = K_Q + TILE;
constexpr int K_S = K_DO + TILE, K_DP = K_S + WS, K_P = K_DP + WS;
constexpr int K_DS = K_P + WP, K_DK = K_DS + WP;
constexpr int K_DV = K_DK + BKV * O_LD * 4;
constexpr int K_ROWS = K_DV + BKV * O_LD * 4;      // lse, d_row of the q tile
constexpr int K_VALID = K_ROWS + 2 * BQ * 4;
constexpr int K_SMEM = K_VALID + BKV;

__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, long long rs,
            const uint8_t* __restrict__ mask, const float* __restrict__ lse,
            const bf16* __restrict__ dout, long long do_stride,
            const float* __restrict__ d_row, bf16* __restrict__ dk16,
            float* __restrict__ dk32, bf16* __restrict__ dv16,
            float* __restrict__ dv32, long long dkv_stride, int T, int H,
            float scale_log2, float sm_scale, int causal, ppgs::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + K_K);
  bf16* sV = reinterpret_cast<bf16*>(smem + K_V);
  bf16* sQ = reinterpret_cast<bf16*>(smem + K_Q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + K_DO);
  float* s_lse = reinterpret_cast<float*>(smem + K_ROWS);
  float* s_drow = s_lse + BQ;
  uint8_t* s_valid = smem + K_VALID;

  const int k0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sS = reinterpret_cast<float*>(smem + K_S) + warp * 16 * S_LD;
  float* sDP = reinterpret_cast<float*>(smem + K_DP) + warp * 16 * S_LD;
  bf16* sP = reinterpret_cast<bf16*>(smem + K_P) + warp * 16 * P_LD;
  bf16* sDS = reinterpret_cast<bf16*>(smem + K_DS) + warp * 16 * P_LD;
  float* sDK = reinterpret_cast<float*>(smem + K_DK) + warp * 16 * O_LD;
  float* sDV = reinterpret_cast<float*>(smem + K_DV) + warp * 16 * O_LD;

  // Lanes 2r and 2r+1 own key row r of the warp's 16 and 32 query columns
  const int row = lane / 2, half = lane % 2;
  const int lrow = warp * 16 + row, key = k0 + lrow;
  const long long head = (long long)h * D, batch_row = (long long)b * T;
  const long long bh = (long long)(b * H + h) * T;
  ppgs::KeepStream stream(drop);

  const int rows = min(BKV, T - k0);
  ppgs::load_tile_bf16<BKV, D, THREADS>(
      sK, LD, k + (batch_row + k0) * rs + head, rs, rows);
  ppgs::load_tile_bf16<BKV, D, THREADS>(
      sV, LD, v + (batch_row + k0) * rs + head, rs, rows);
  for (int i = threadIdx.x; i < BKV; i += THREADS)
    s_valid[i] = i < rows ? mask[batch_row + k0 + i] : 0;
  for (int i = threadIdx.x; i < BKV * O_LD; i += THREADS) {
    reinterpret_cast<float*>(smem + K_DK)[i] = 0.f;
    reinterpret_cast<float*>(smem + K_DV)[i] = 0.f;
  }

  const int n_tiles = (T + BQ - 1) / BQ;
  const int first = causal ? k0 / BQ : 0;   // earlier queries see no key here
  for (int t = first; t < n_tiles; ++t) {
    const int q0 = t * BQ, qrows = min(BQ, T - q0);
    __syncthreads();
    ppgs::load_tile_bf16<BQ, D, THREADS>(
        sQ, LD, q + (batch_row + q0) * rs + head, rs, qrows);
    ppgs::load_tile_bf16<BQ, D, THREADS>(
        sDO, LD, dout + (batch_row + q0) * do_stride + head, do_stride,
        qrows);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      s_lse[i] = i < qrows ? lse[bh + q0 + i] : 0.f;
      s_drow[i] = i < qrows ? d_row[bh + q0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = K Q^T and dp^T = V dO^T for the warp's 16 keys
    rows_times_tile_t(sK + warp * 16 * LD, sQ, sS);
    rows_times_tile_t(sV + warp * 16 * LD, sDO, sDP);
    __syncwarp();

    const bool key_ok = key < T && s_valid[lrow];
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c, qi = q0 + col;
      const bool ok = key_ok && qi < T && (!causal || key <= qi);
      const float pn =
          ok ? exp2f(sS[row * S_LD + col] * scale_log2 - s_lse[col]) : 0.f;
      float gp = sDP[row * S_LD + col], pd = pn;
      if (drop.threshold) {
        const bool kept =
            ok && stream.keep(((unsigned long long)bh + qi) * T + key);
        gp = kept ? gp * drop.scale : 0.f;
        pd = kept ? pn * drop.scale : 0.f;
      }
      sP[row * P_LD + col] = __float2bfloat16(pd);
      sDS[row * P_LD + col] =
          __float2bfloat16(pn * (gp - s_drow[col]) * sm_scale);
    }
    __syncwarp();

    accumulate_pv(sDV, sP, sDO);    // dv += pd^T dO
    accumulate_pv(sDK, sDS, sQ);    // dk += ds^T Q
    __syncwarp();
  }

  if (key < T) {
    const long long o = (batch_row + key) * dkv_stride + head + half * 64;
    write_row64(sDK + row * O_LD + half * 64, 1.f, dk16 ? dk16 + o : nullptr,
                dk32 ? dk32 + o : nullptr);
    write_row64(sDV + row * O_LD + half * 64, 1.f, dv16 ? dv16 + o : nullptr,
                dv32 ? dv32 + o : nullptr);
  }
}

// ------------------------------------------------------------- row_dot

// out[(b*H + h)*T + t] = sum_d x[row, h*128 + d] y[row, h*128 + d]: one
// warp per (row, head), four columns per lane.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T_>
__global__ void __launch_bounds__(256)
row_dot_kernel(const T_* __restrict__ x, long long ldx,
               const T_* __restrict__ y, long long ldy,
               float* __restrict__ out, long long rows, int T, int H) {
  const long long pair = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= rows * H) return;
  const long long r = pair / H;
  const int h = static_cast<int>(pair % H);
  const T_* xr = x + r * ldx + h * D + lane * 4;
  const T_* yr = y + r * ldy + h * D + lane * 4;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) s += to_float(xr[e]) * to_float(yr[e]);
  s = ppgs::warp_sum(s);
  if (lane == 0) {
    const long long b = r / T, t = r % T;
    out[(b * H + h) * T + t] = s;
  }
}

}  // namespace

// q, k, v: bf16 (B, T, H*128) views with row stride rs; mask (B, T) bytes;
// out (B, T, H*128) bf16 and out32 (same layout, fp32, or null) with row
// stride out_stride; lse (B, H, T) fp32. scale_log2 = log2(e)/sqrt(d).
extern "C" int ppgs_attention_train_fwd(
    const void* q, const void* k, const void* v, long long rs,
    const void* mask, void* out, void* out32, long long out_stride,
    void* lse, int B, int T, int H, float scale_log2, int causal,
    unsigned seed_lo, unsigned seed_hi, unsigned site, unsigned threshold,
    float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && T > 0) {
    dim3 grid((T + BQ - 1) / BQ, H, B);
    fwd_kernel<<<grid, THREADS, F_SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), rs, static_cast<const uint8_t*>(mask),
        static_cast<bf16*>(out), static_cast<float*>(out32), out_stride,
        static_cast<float*>(lse), T, H, scale_log2, causal,
        ppgs::make_dropout(seed_lo, seed_hi, site, threshold, scale));
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward: dout (B, T, H*128) bf16 with row stride do_stride, d_row
// (B, H, T) fp32; dq, dk, dv written as bf16 and/or fp32 (null skips) with
// row stride dq_stride (dq) and dkv_stride (dk, dv).
extern "C" int ppgs_attention_train_bwd(
    const void* q, const void* k, const void* v, long long rs,
    const void* mask, const void* lse, const void* dout, long long do_stride,
    const void* d_row, void* dq16, void* dq32, void* dk16, void* dk32,
    void* dv16, void* dv32, long long d_stride, int B, int T, int H,
    float scale_log2, float sm_scale, int causal, unsigned seed_lo,
    unsigned seed_hi, unsigned site, unsigned threshold, float scale,
    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && T > 0) {
    const ppgs::Dropout d =
        ppgs::make_dropout(seed_lo, seed_hi, site, threshold, scale);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    dim3 grid((T + BQ - 1) / BQ, H, B);
    dq_kernel<<<grid, THREADS, Q_SMEM, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), rs, static_cast<const uint8_t*>(mask),
        static_cast<const float*>(lse), static_cast<const bf16*>(dout),
        do_stride, static_cast<const float*>(d_row), static_cast<bf16*>(dq16),
        static_cast<float*>(dq32), d_stride, T, H, scale_log2, sm_scale,
        causal, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv_kernel<<<grid, THREADS, K_SMEM, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), rs, static_cast<const uint8_t*>(mask),
        static_cast<const float*>(lse), static_cast<const bf16*>(dout),
        do_stride, static_cast<const float*>(d_row), static_cast<bf16*>(dk16),
        static_cast<float*>(dk32), static_cast<bf16*>(dv16),
        static_cast<float*>(dv32), d_stride, T, H, scale_log2, sm_scale,
        causal, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (B, H, T) fp32 = per-head row sums of x * y over (B*T, H*128) rows
// with strides ldx, ldy; is_f32: both fp32, else both bf16.
extern "C" int ppgs_row_dot(const void* x, long long ldx, const void* y,
                            long long ldy, void* out, int B, int T, int H,
                            int is_f32, void* stream) {
  const long long rows = (long long)B * T;
  if (rows > 0) {
    const unsigned blocks = static_cast<unsigned>((rows * H + 7) / 8);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_f32)
      row_dot_kernel<float><<<blocks, 256, 0, s>>>(
          static_cast<const float*>(x), ldx, static_cast<const float*>(y),
          ldy, static_cast<float*>(out), rows, T, H);
    else
      row_dot_kernel<bf16><<<blocks, 256, 0, s>>>(
          static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(y), ldy,
          static_cast<float*>(out), rows, T, H);
  }
  return static_cast<int>(cudaGetLastError());
}
