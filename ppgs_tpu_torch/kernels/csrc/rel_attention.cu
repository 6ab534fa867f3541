// B8 rel_attention: the conformer's relative-position attention,
// softmax((q_u k^T + shift(bd)) / sqrt(d_k)) v with a key mask, the
// position term bd read in place from its zero-column-padded buffer.
//
// Replaces: ppgs_tpu/ops/flash_attention.py fused_attention_bias (kernel
// _fused_kernel_bias), which models/conformer.py runs in each of the 16
// blocks of the bottleneck frontend (bf16, T <= 2048).
//
// The function is the TPU kernel's, in its order: logits = (q_u.k in fp32 +
// bias in fp32) * sm_scale; masked keys -1e30; the row max clamped at
// -1e29; p = exp(logits - max), 0 at masked keys; the denominator clamped
// at 1e-30; p / denom rounded to bf16 BEFORE the PV product (K2 scales by
// 1/l after it). A wholly masked row gives 0.
//
// The shift (the legacy ESPnet rel_shift). Head (b, h)'s bias is the
// (T, T + 1) product q_v . [0; pos]^T viewed as (T + 1, T): shifted
// element (i, j) is element (i + 1) * T + j of that buffer, its [1:] row
// slice. The kernel reads those addresses; no shifted tensor exists.
//
// The heads. d_k = 36 fits neither the 16-deep MMA step nor 16-byte
// loads: head h starts 72 h bytes into a 288-byte row. The kernel reads
// q, k and v in place with 8-byte loads (4 bf16; any d_k % 4 == 0 up to
// 64) and zero-pads each head to 64 columns in shared memory, as the TPU
// pads to 64 lanes. The wrapper packs nothing: a padded copy of q, k and v
// would add their bytes twice to a kernel bound by bytes. sm_scale uses the
// true d_k.
//
// Design (right first, not fast): one block per (batch b, head h, 64-query
// tile), four warps of 16 query rows, 64-key tiles, wmma 16x16x16. Since
// p is normalised before PV, the softmax takes two passes over the keys:
// pass 1 computes each row's max and denominator online; pass 2 recomputes
// the logits, rounds p / denom to bf16 and accumulates PV in registers.
// Each warp walks its 16 rows one at a time, 32 lanes over 64 keys, so the
// bias row is read coalesced (any T: no alignment is assumed) and each
// row's max and sum are warp reductions. Any T works (the last tiles are
// masked); the TPU kernel needs T % 8 == 0.
//
// Bound on an H100 at 64 x 8 s (B = 64, T = 800, H = 4, d_k = 36), per
// launch: the bias, 64 * 4 * 801 * 800 * 2 = 328 MB, plus q, k, v and out,
// 59 MB, over 3.35 TB/s is 0.116 ms; the products, 2.4e10 FLOP, take
// 0.024 ms at 989 TFLOP/s: bound by bytes. Pass 2 reads each bias tile
// again; a block's 64 bias rows (102 KB at T = 800) were read in pass 1 a
// few microseconds before, so most of that second read comes from L2.
// The redesign (ROADMAP.md) computes bd inside the kernel from q_v and the
// shared pos (H x T x 36), so that the 328 MB are never written or read.
//
// Shared memory: Q, K and V tiles of 64 x 72 bf16 (27 KB), per warp 16 x
// 68 fp32 scores and 16 x 72 bf16 probabilities: 53 KB.

#include "common.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int DP = 64;             // heads zero-padded to 64 columns
constexpr int QKV_LD = DP + 8;     // bf16 Q/K/V tiles
constexpr int S_LD = BKV + 4;      // fp32 scores, per warp 16 x 64
constexpr int P_LD = BKV + 8;      // bf16 probabilities, per warp 16 x 64
constexpr float MAX_FLOOR = -1e29f;  // the TPU kernel's row-max clamp
constexpr float DENOM_FLOOR = 1e-30f;

constexpr int OFF_Q = 0;
constexpr int OFF_K = OFF_Q + BQ * QKV_LD * 2;
constexpr int OFF_V = OFF_K + BKV * QKV_LD * 2;
constexpr int OFF_S = OFF_V + BKV * QKV_LD * 2;
constexpr int OFF_P = OFF_S + WARPS * 16 * S_LD * 4;
constexpr int OFF_VALID = OFF_P + WARPS * 16 * P_LD * 2;
constexpr int SMEM = OFF_VALID + BKV;
static_assert(OFF_K % 128 == 0 && OFF_V % 128 == 0 && OFF_S % 128 == 0 &&
                  OFF_P % 128 == 0 && OFF_VALID % 128 == 0,
              "shared-memory regions must stay aligned");

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

// ROWS x d bf16 from global memory (row stride ld elements, rows 8-byte
// aligned) into a shared tile of row stride QKV_LD, 4 values per thread
// and step. Rows at or past row_limit read as zeros; columns d .. DP - 1
// are not touched (they are zeroed once, at the start).
template <int ROWS>
__device__ __forceinline__ void load_heads(bf16* s, const bf16* g,
                                           long long ld, int d,
                                           int row_limit) {
  const int per_row = d / 4;
  for (int i = threadIdx.x; i < ROWS * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * 4;
    uint2 v = make_uint2(0u, 0u);
    if (r < row_limit) v = *reinterpret_cast<const uint2*>(g + r * ld + c);
    *reinterpret_cast<uint2*>(s + r * QKV_LD + c) = v;
  }
}

// The K and V tiles of keys [k0, k0 + 64) and their mask bytes
__device__ __forceinline__ void load_keys(bf16* sK, bf16* sV,
                                          uint8_t* s_valid, const bf16* k,
                                          const bf16* v, long long kv_rs,
                                          const uint8_t* mask,
                                          long long batch_row, long long head,
                                          int k0, int T, int d, bool with_v) {
  const int limit = min(BKV, T - k0);
  load_heads<BKV>(sK, k + (batch_row + k0) * kv_rs + head, kv_rs, d, limit);
  if (with_v)
    load_heads<BKV>(sV, v + (batch_row + k0) * kv_rs + head, kv_rs, d, limit);
  for (int i = threadIdx.x; i < BKV; i += THREADS)
    s_valid[i] = (i < limit) ? mask[batch_row + k0 + i] : 0;
}

// S = Q K^T for the warp's 16 query rows against the 64 keys of the tile,
// over the first kd (d rounded up to 16) columns of the padded heads
__device__ __forceinline__ void scores(const bf16* sQ, const bf16* sK,
                                       float* sS, int warp, int kd) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(s[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    if (kk >= kd) break;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, sQ + warp * 16 * QKV_LD + kk, QKV_LD);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, sK + n * 16 * QKV_LD + kk, QKV_LD);
      wmma::mma_sync(s[n], fa, fb, s[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(sS + n * 16, s[n], S_LD, wmma::mem_row_major);
}

__global__ void __launch_bounds__(THREADS)
rel_attention_kernel(const bf16* __restrict__ q, long long q_rs,
                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                     long long kv_rs, const bf16* __restrict__ bias,
                     const uint8_t* __restrict__ mask,
                     bf16* __restrict__ out, long long out_rs, int T, int H,
                     int d, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + OFF_Q);
  bf16* sK = reinterpret_cast<bf16*>(smem + OFF_K);
  bf16* sV = reinterpret_cast<bf16*>(smem + OFF_V);
  uint8_t* s_valid = smem + OFF_VALID;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sS = reinterpret_cast<float*>(smem + OFF_S) + warp * 16 * S_LD;
  bf16* sP = reinterpret_cast<bf16*>(smem + OFF_P) + warp * 16 * P_LD;
  const long long head = (long long)h * d;
  const long long batch_row = (long long)b * T;
  // Row i of the shifted bias of head (b, h): row i + 1 of its (T + 1, T)
  // buffer
  const bf16* bias_head = bias + ((long long)(b * H + h) * (T + 1) + 1) * T;
  const int kd = (d + 15) / 16 * 16;
  const int n_tiles = (T + BKV - 1) / BKV;

  // Zero the Q, K and V tiles once: the head padding stays zero
  for (int i = threadIdx.x; i < (OFF_S - OFF_Q) / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem + OFF_Q)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  load_heads<BQ>(sQ, q + (batch_row + q0) * q_rs + head, q_rs, d,
                 min(BQ, T - q0));

  // The logits of row r of the warp at keys lane and lane + 32 of the tile
  // starting at k0 (-1e30 where masked, past T, or for a row past T)
  auto logits = [&](int r, int k0, float& s0, float& s1, bool& ok0,
                    bool& ok1) {
    const int qrow = q0 + warp * 16 + r;
    ok0 = qrow < T && s_valid[lane];
    ok1 = qrow < T && s_valid[lane + 32];
    const float* srow = sS + r * S_LD;
    const bf16* brow = bias_head + (long long)qrow * T + k0;
    s0 = ok0 ? (srow[lane] + __bfloat162float(brow[lane])) * sm_scale
             : ppgs::NEG_INF;
    s1 = ok1 ? (srow[lane + 32] + __bfloat162float(brow[lane + 32])) *
                   sm_scale
             : ppgs::NEG_INF;
  };

  // Pass 1: each row's max (from the -1e29 floor) and denominator, online
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = MAX_FLOOR;
    l[r] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    load_keys(sK, sV, s_valid, k, v, kv_rs, mask, batch_row, head, k0, T, d,
              false);
    __syncthreads();
    scores(sQ, sK, sS, warp, kd);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float s0, s1;
      bool ok0, ok1;
      logits(r, k0, s0, s1, ok0, ok1);
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      float p = (ok0 ? expf(s0 - m_new) : 0.f) + (ok1 ? expf(s1 - m_new) : 0.f);
      l[r] = l[r] * expf(m[r] - m_new) + ppgs::warp_sum(p);
      m[r] = m_new;
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) l[r] = fmaxf(l[r], DENOM_FLOOR);

  // Pass 2: p / denom in bf16, O = P V accumulated in registers
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[DP / 16];
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) wmma::fill_fragment(o[n], 0.f);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    load_keys(sK, sV, s_valid, k, v, kv_rs, mask, batch_row, head, k0, T, d,
              true);
    __syncthreads();
    scores(sQ, sK, sS, warp, kd);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float s0, s1;
      bool ok0, ok1;
      logits(r, k0, s0, s1, ok0, ok1);
      const float p0 = ok0 ? expf(s0 - m[r]) : 0.f;
      const float p1 = ok1 ? expf(s1 - m[r]) : 0.f;
      sP[r * P_LD + lane] = __float2bfloat16(p0 / l[r]);
      sP[r * P_LD + lane + 32] = __float2bfloat16(p1 / l[r]);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sP + kk, P_LD);
#pragma unroll
      for (int n = 0; n < DP / 16; ++n) {
        if (n * 16 >= kd) break;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sV + kk * QKV_LD + n * 16, QKV_LD);
        wmma::mma_sync(o[n], fa, fb, o[n]);
      }
    }
    __syncwarp();
  }

  // The warp's 16 output rows through its score buffer, 4 bf16 a lane
#pragma unroll
  for (int n = 0; n < DP / 16; ++n)
    wmma::store_matrix_sync(sS + n * 16, o[n], S_LD, wmma::mem_row_major);
  __syncwarp();
  const int c = lane * 4;
  for (int r = 0; r < 16; ++r) {
    const int qrow = q0 + warp * 16 + r;
    if (qrow >= T || c >= d) continue;
    const float* orow = sS + r * S_LD + c;
    __align__(8) bf16 o4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o4[e] = __float2bfloat16(orow[e]);
    *reinterpret_cast<uint2*>(out + (batch_row + qrow) * out_rs + head + c) =
        *reinterpret_cast<const uint2*>(o4);
  }
}

}  // namespace

// q: bf16 (B, T, H*d) with row stride q_rs elements; k, v: the same with
// row stride kv_rs (views of one buffer are fine); every row 8-byte
// aligned. bias: bf16 (B, H, T + 1, T) contiguous, the zero-column-padded
// unshifted position term. mask: (B, T) bytes, nonzero = valid key. out:
// bf16 (B, T, ...) with row stride out_rs. d % 4 == 0 and d <= 64, else
// cudaErrorInvalidValue.
extern "C" int ppgs_rel_attention(const void* q, long long q_rs,
                                  const void* k, const void* v,
                                  long long kv_rs, const void* bias,
                                  const void* mask, void* out,
                                  long long out_rs, int B, int T, int H,
                                  int d, float sm_scale, void* stream) {
  if (d < 4 || d > DP || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && T > 0) {
    dim3 grid((T + BQ - 1) / BQ, H, B);
    rel_attention_kernel<<<grid, THREADS, SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), q_rs, static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), kv_rs, static_cast<const bf16*>(bias),
        static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
        out_rs, T, H, d, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
