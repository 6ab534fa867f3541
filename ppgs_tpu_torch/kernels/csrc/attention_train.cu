// Attention for training: masked multi-head attention with dropout on the
// normalised probabilities, and the row products its backward needs;
// d_head = 128, read in place from (B, T, C) layouts. The backward itself
// is attention_train_bwd.cu.
//
// Replaces: ppgs_tpu/ops/flash_attention.py flash_attention_train
// (_train_fwd_kernel) and the attention inside
// ppgs_tpu/ops/encoder_layer_train.py (_fwd_compute's per-head loop).
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
// valid key, which gives o = 0). With dropout it also writes the keep bits
// it drew, a 32-bit word per row and 32 keys (a lane's run of keys), so
// that the backward reads them instead of drawing them again (16.8 MB a
// layer at the training shape, kept from the forward to the backward).
// row_dot gives the backward's d_row = rowsum(dO * O) per head.
//
// Bound on an H100 at the training shape (256 windows x T = 512, 2 heads):
// 2 x 256 x 2 x 512^2 x 128 x 2 = 69 GFLOP (~70 us) against ~0.2 GB
// moved. A right-first kernel: wmma 16x16x16 with synchronous tile loads,
// scores through shared memory, the scores computed twice, one Philox call
// per four keys.

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
           float* __restrict__ lse, uint32_t* __restrict__ keep_out, int T,
           int H, float scale_log2, int causal, ppgs::Dropout drop) {
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
  const int n_keys = (T + BKV - 1) / BKV;   // the window's key tiles
  int n_tiles = n_keys;
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
    uint32_t kept = 0u;   // bit c: key k0 + half * 32 + c valid and kept
    for (int c = 0; c < 32; ++c) {
      const int key = k0 + half * 32 + c;
      const bool ok = qrow < T && s_valid[half * 32 + c] &&
                      (!causal || key <= qrow);
      float pd = ok ? exp2f(srow[c] * scale_log2 - row_lse) : 0.f;
      if (drop.threshold) {
        const bool keep = ok && stream.keep(bh_row + key);
        pd = keep ? pd * drop.scale : 0.f;
        kept |= static_cast<uint32_t>(keep) << c;
      }
      prow[c] = __float2bfloat16(pd);
    }
    if (keep_out && qrow < T)
      keep_out[((long long)(b * H + h) * T + qrow) * (2 * n_keys) +
               k0 / 32 + half] = kept;
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
// stride out_stride; lse (B, H, T) fp32; keep (B, H, T, 2 ceil(T / 64))
// uint32, the keep bits for the backward (bit k of word w of a query row:
// key 32 w + k valid and kept; words of tiles past the causal diagonal are
// not written), or null. scale_log2 = log2(e)/sqrt(d).
extern "C" int ppgs_attention_train_fwd(
    const void* q, const void* k, const void* v, long long rs,
    const void* mask, void* out, void* out32, long long out_stride,
    void* lse, void* keep, int B, int T, int H, float scale_log2, int causal,
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
        static_cast<float*>(lse), static_cast<uint32_t*>(keep), T, H,
        scale_log2, causal,
        ppgs::make_dropout(seed_lo, seed_hi, site, threshold, scale));
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
