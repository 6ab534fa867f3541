// K2 attention: masked multi-head attention with an online softmax, read in
// place from the model's (B, T, C) activation layout, d_head = 64, 128 or
// 256 (one template instance each).
//
// Replaces: ppgs_tpu/ops/flash_attention.py _fused_kernel (T <= 1024) and
// _flash_kernel (T > 1024) for d_head = 128 and 256, _fused_kernel_packed
// (d_head < 128: wav2vec2's 12 heads of 64, which the TPU packs two to a
// 128-lane block; here each head is a block of its own, so nothing needs
// packing), and the per-head attention inside
// ppgs_tpu/ops/encoder_layer_kernel.py _layer_body (encoder_stack, and
// encoder_stack_streamed's 12 x 64 trunk layers).
//
// One block per (window b, head h, 64-row query tile); four warps, 16 query
// rows each. The block walks the keys in 64-row tiles: S = Q K^T in fp32,
// the key mask (and the causal mask) applied BEFORE the row max, as
// flash_attention and the XLA path do; p = exp2(S * scale_log2 - m) in fp32;
// p rounded to bf16 for the PV product, the row sum kept from the fp32 p;
// O rescaled by exp2(m_old - m_new) per tile; finally O / l, with a row sum
// of 0 (a wholly masked row or window) giving exactly 0. q, k and v are read
// through a row stride, so the fused (B, T, 3C) QKV buffer needs no split
// and no head transpose; any T works (the last tiles are masked), so the
// T = 500 windows need no pad to 512.
//
// Where this rounds differently from the TPU kernels: encoder_stack's bf16
// softmax takes the row max over all keys and exponentiates in bf16, and
// _fused_kernel(_packed) normalises p before the PV product; here exp2 is
// fp32, the max is over valid keys, and the 1/l scale comes after the
// product (as in _flash_kernel). All differ by bf16 rounding only.
//
// Shared memory per block: Q, K and V tiles of 64 x (D + 8) bf16, per warp
// 16 x 68 fp32 scores, 16 x 72 bf16 probabilities and a 16 x (D + 4) fp32
// running output: 70 KB at D = 64, 119 KB at D = 128, 195 KB at D = 256
// (of the 227 KB a block may have). The running output lives in shared
// memory because wmma fragments have no documented element layout, so the
// per-row rescale is done there; the PV product walks it in 128-column
// chunks, so a warp never holds more than 8 accumulator fragments.
//
// Bound on an H100 at the main paths' shapes: mel (128 windows x T = 500,
// 2 heads of 128) 32.8 GFLOP against 131 MB moved (q, k, v in, output out,
// bf16), memory bound (~39 us); the w2v2 trunk (64 x 400, 12 heads of 64)
// and the w2v2fb head (128 x 500, 2 heads of 256) likewise bound by their
// bytes. Each block reads its Q tile once and every K/V tile of its head
// once; scores never leave the SM. The shared-memory traffic of the running
// output and the synchronous loads make this a right-first kernel, not a
// fast one.

#include "common.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int S_LD = BKV + 4;    // fp32 scores, per warp 16 x 64
constexpr int P_LD = BKV + 8;    // bf16 probabilities, per warp 16 x 64

// The shared-memory plan of the instance for head width D
template <int D>
struct Plan {
  static constexpr int QKV_LD = D + 8;    // bf16 Q/K/V tiles
  static constexpr int O_LD = D + 4;      // fp32 running output, 16 x D
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + BQ * QKV_LD * 2;
  static constexpr int OFF_V = OFF_K + BKV * QKV_LD * 2;
  static constexpr int OFF_S = OFF_V + BKV * QKV_LD * 2;
  static constexpr int OFF_P = OFF_S + WARPS * 16 * S_LD * 4;
  static constexpr int OFF_O = OFF_P + WARPS * 16 * P_LD * 2;
  static constexpr int OFF_VALID = OFF_O + WARPS * 16 * O_LD * 4;  // key mask
  static constexpr int SMEM = OFF_VALID + BKV;
  static_assert(OFF_K % 128 == 0 && OFF_V % 128 == 0 && OFF_S % 128 == 0 &&
                    OFF_P % 128 == 0 && OFF_O % 128 == 0 &&
                    OFF_VALID % 128 == 0,
                "shared-memory regions must stay aligned");
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long long rs,
                 const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                 long long out_stride, int T, float scale_log2, int causal) {
  using P = Plan<D>;
  constexpr int QKV_LD = P::QKV_LD, O_LD = P::O_LD, HALF = D / 2;
  constexpr int OC = D < 128 ? D : 128;   // output columns per PV pass
  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* s_valid = smem + P::OFF_VALID;
  bf16* sQ = reinterpret_cast<bf16*>(smem + P::OFF_Q);
  bf16* sK = reinterpret_cast<bf16*>(smem + P::OFF_K);
  bf16* sV = reinterpret_cast<bf16*>(smem + P::OFF_V);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sS = reinterpret_cast<float*>(smem + P::OFF_S) + warp * 16 * S_LD;
  bf16* sP = reinterpret_cast<bf16*>(smem + P::OFF_P) + warp * 16 * P_LD;
  float* sO = reinterpret_cast<float*>(smem + P::OFF_O) + warp * 16 * O_LD;

  // Lanes 2r and 2r+1 own query row r of the warp's 16; each half of the
  // pair owns 32 score columns and D / 2 output columns of that row.
  const int row = lane / 2, half = lane % 2;
  const int qrow = q0 + warp * 16 + row;
  const long long head = (long long)h * D;
  const long long batch_row = (long long)b * T;

  ppgs::load_tile_bf16<BQ, D, THREADS>(
      sQ, QKV_LD, q + (batch_row + q0) * rs + head, rs, min(BQ, T - q0));
  float* orow = sO + row * O_LD + half * HALF;
  for (int c = 0; c < HALF; ++c) orow[c] = 0.f;

  float m = ppgs::NEG_INF, l = 0.f;
  int n_tiles = (T + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    ppgs::load_tile_bf16<BKV, D, THREADS>(
        sK, QKV_LD, k + (batch_row + k0) * rs + head, rs, min(BKV, T - k0));
    ppgs::load_tile_bf16<BKV, D, THREADS>(
        sV, QKV_LD, v + (batch_row + k0) * rs + head, rs, min(BKV, T - k0));
    for (int i = threadIdx.x; i < BKV; i += THREADS)
      s_valid[i] = (k0 + i < T) ? mask[batch_row + k0 + i] : 0;
    __syncthreads();

    // S = Q K^T for the warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) wmma::fill_fragment(s[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sQ + warp * 16 * QKV_LD + kk, QKV_LD);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              fb;
          wmma::load_matrix_sync(fb, sK + n * 16 * QKV_LD + kk, QKV_LD);
          wmma::mma_sync(s[n], fa, fb, s[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(sS + n * 16, s[n], S_LD, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax on this lane's 32 columns of its row
    float* srow = sS + row * S_LD + half * 32;
    uint32_t valid = 0u;
    float tile_max = ppgs::NEG_INF;
    for (int c = 0; c < 32; ++c) {
      const int key = k0 + half * 32 + c;
      const bool ok = s_valid[half * 32 + c] && (!causal || key <= qrow);
      const float sc = ok ? srow[c] * scale_log2 : ppgs::NEG_INF;
      srow[c] = sc;
      valid |= (ok ? 1u : 0u) << c;
      tile_max = fmaxf(tile_max, sc);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    const float corr = exp2f(m - m_new);
    float psum = 0.f;
    bf16* prow = sP + row * P_LD + half * 32;
    for (int c = 0; c < 32; ++c) {
      const float p = ((valid >> c) & 1u) ? exp2f(srow[c] - m_new) : 0.f;
      psum += p;
      prow[c] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
    for (int c = 0; c < HALF; ++c) orow[c] *= corr;
    __syncwarp();

    // O += P V, in passes of OC output columns
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += OC) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[OC / 16];
#pragma unroll
      for (int n = 0; n < OC / 16; ++n)
        wmma::load_matrix_sync(o[n], sO + c0 + n * 16, O_LD,
                               wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sP + kk, P_LD);
#pragma unroll
        for (int n = 0; n < OC / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, sV + kk * QKV_LD + c0 + n * 16, QKV_LD);
          wmma::mma_sync(o[n], fa, fb, o[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < OC / 16; ++n)
        wmma::store_matrix_sync(sO + c0 + n * 16, o[n], O_LD,
                                wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qrow < T) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* dst = out + (batch_row + qrow) * out_stride + head + half * HALF;
    for (int c = 0; c < HALF; c += 8) {
      __align__(16) bf16 o8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o8[e] = __float2bfloat16(orow[c + e] * inv);
      *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(o8);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, long long rs,
           const void* mask, void* out, long long out_stride, int B, int T,
           int H, float scale_log2, int causal, cudaStream_t stream) {
  constexpr int SMEM = Plan<D>::SMEM;
  // Above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && T > 0) {
    dim3 grid((T + BQ - 1) / BQ, H, B);
    attention_kernel<D><<<grid, THREADS, SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), rs, static_cast<const uint8_t*>(mask),
        static_cast<bf16*>(out), out_stride, T, scale_log2, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16 (B, T, H*d_head) views with row stride rs elements (3C for
// the fused QKV buffer); mask (B, T) bytes, nonzero = valid key;
// out (B, T, ...) bf16 with row stride out_stride. scale_log2 multiplies
// the fp32 scores before exp2 (1 when the scale is folded into q).
// d_head is 64, 128 or 256; any other returns cudaErrorInvalidValue.
extern "C" int ppgs_attention(const void* q, const void* k, const void* v,
                              long long rs, const void* mask, void* out,
                              long long out_stride, int B, int T, int H,
                              int d_head, float scale_log2, int causal,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_head) {
    case 64:
      return launch<64>(q, k, v, rs, mask, out, out_stride, B, T, H,
                        scale_log2, causal, s);
    case 128:
      return launch<128>(q, k, v, rs, mask, out, out_stride, B, T, H,
                         scale_log2, causal, s);
    case 256:
      return launch<256>(q, k, v, rs, mask, out, out_stride, B, T, H,
                         scale_log2, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
