// The row-wise pieces of the training layer's backward, C = 256: the
// LayerNorm backward with a dropout epilogue, and a deterministic column
// sum. (The forward's out-projection + dropout + LN1 is K3, out_proj_ln.cu.)
//
// Replaces, in ppgs_tpu/ops/encoder_layer_train.py: the LN2 and LN1
// backward of _bwd_kernel (`_ln_bwd`, dgamma, dbeta) with the dropout
// replays that follow them (keep_y before the FFN backward, keep_sa before
// the attention backward), and the bias gradients, which the TPU kernel
// accumulates across its sequential grid into revisited output blocks
// (`dbo_ref[...] += ...`). Hopper blocks run in no order, so every
// reduction over rows here writes per-block partial sums and a second pass
// (colsum) adds them in a fixed order: the sums are the same from run to
// run.
//
// Bounds on an H100 at the training shape (M = 131,072 rows): each kernel
// moves 2-4 (M, 256) fp32 arrays (0.13 GB each) for at most 0.3 GFLOP, so
// both are memory bound (~0.1-0.15 ms); the designs read each input once.

#include "common.cuh"
#include "philox.cuh"

using ppgs::bf16;

namespace {

constexpr int C = 256, THREADS = 256;

// ------------------------------- LayerNorm backward + dropout, per row

constexpr int LB_ROWS = 64;   // rows per block: 8 warps x 8 rows

template <typename TG>
__device__ __forceinline__ void load8(const TG* p, float v[8]);

template <>
__device__ __forceinline__ void load8<float>(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <>
__device__ __forceinline__ void load8<bf16>(const bf16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}

// For each row: dz = LNbackward(g) (or dz = g without n), then
// masked = keep ? dz / (1 - rate) : 0. Writes dz (fp32, if asked) and
// bf16(masked) (if asked), and per-block column partials
// [sum g*n | sum g | sum masked] (3 x 256 per block).
template <typename TG>
__global__ void __launch_bounds__(THREADS)
ln_dropout_bwd_kernel(const TG* __restrict__ g, const float* __restrict__ n,
                      const float* __restrict__ rstd,
                      const float* __restrict__ gamma,
                      float* __restrict__ dz_out, bf16* __restrict__ masked_out,
                      float* __restrict__ partial, int M, ppgs::Dropout drop) {
  __shared__ float s_part[THREADS / 32][3 * C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c0 = lane * 8;
  float acc_gn[8] = {}, acc_g[8] = {}, acc_m[8] = {};
  ppgs::KeepStream stream(drop);
  const int row_first = blockIdx.x * LB_ROWS + warp * (LB_ROWS / 8);
  for (int i = 0; i < LB_ROWS / 8; ++i) {
    const int r = row_first + i;
    if (r >= M) break;
    const long long base = (long long)r * C + c0;
    float gv[8], dz[8];
    load8<TG>(g + base, gv);
    if (n) {
      float nv[8], dyg[8], s1 = 0.f, s2 = 0.f;
      load8<float>(n + base, nv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dyg[e] = gv[e] * gamma[c0 + e];
        s1 += dyg[e];
        s2 += dyg[e] * nv[e];
        acc_gn[e] += gv[e] * nv[e];
      }
      const float m1 = ppgs::warp_sum(s1) * (1.f / 256.f);
      const float m2 = ppgs::warp_sum(s2) * (1.f / 256.f);
      const float s = rstd[r];
#pragma unroll
      for (int e = 0; e < 8; ++e) dz[e] = (dyg[e] - m1 - nv[e] * m2) * s;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dz[e] = gv[e];
    }
    __align__(16) bf16 mc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc_g[e] += gv[e];
      const float m = drop.threshold
                          ? (stream.keep(base + e) ? dz[e] * drop.scale : 0.f)
                          : dz[e];
      acc_m[e] += m;
      mc[e] = __float2bfloat16(m);
    }
    if (dz_out) {
      float4* d = reinterpret_cast<float4*>(dz_out + base);
      d[0] = make_float4(dz[0], dz[1], dz[2], dz[3]);
      d[1] = make_float4(dz[4], dz[5], dz[6], dz[7]);
    }
    if (masked_out)
      *reinterpret_cast<uint4*>(masked_out + base) =
          *reinterpret_cast<const uint4*>(mc);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s_part[warp][c0 + e] = acc_gn[e];
    s_part[warp][C + c0 + e] = acc_g[e];
    s_part[warp][2 * C + c0 + e] = acc_m[e];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * C; j += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += s_part[w][j];
    partial[(long long)blockIdx.x * 3 * C + j] = s;
  }
}

// ------------------------------------------------------------ colsum

// out[j] = sum over rows r0 <= r < r1 of in[r, j], one thread per column,
// rows taken in order.
__global__ void __launch_bounds__(256)
colsum_kernel(const float* __restrict__ in, long long R, long long N,
              long long chunk, float* __restrict__ out, int round_bf16) {
  const long long j = (long long)blockIdx.x * 256 + threadIdx.x;
  if (j >= N) return;
  const long long r0 = (long long)blockIdx.y * chunk;
  const long long r1 = min(R, r0 + chunk);
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += in[r * N + j];
  out[(long long)blockIdx.y * N + j] = round_bf16 ? ppgs::round_bf16(s) : s;
}

}  // namespace

// g (M, 256) fp32 (g_is_bf16 = 0) or bf16; n (M, 256) and rstd (M) fp32,
// or n = null for no LayerNorm; gamma (256). dz_out (M, 256) fp32 or null,
// masked_out (M, 256) bf16 or null; partial (ceil(M/64), 3, 256) fp32.
extern "C" int ppgs_ln_dropout_bwd(
    const void* g, int g_is_bf16, const void* n, const void* rstd,
    const void* gamma, void* dz_out, void* masked_out, void* partial, int M,
    unsigned seed_lo, unsigned seed_hi, unsigned site, unsigned threshold,
    float scale, void* stream) {
  if (M > 0) {
    const ppgs::Dropout d =
        ppgs::make_dropout(seed_lo, seed_hi, site, threshold, scale);
    const unsigned blocks = (M + LB_ROWS - 1) / LB_ROWS;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (g_is_bf16)
      ln_dropout_bwd_kernel<bf16><<<blocks, THREADS, 0, s>>>(
          static_cast<const bf16*>(g), static_cast<const float*>(n),
          static_cast<const float*>(rstd), static_cast<const float*>(gamma),
          static_cast<float*>(dz_out), static_cast<bf16*>(masked_out),
          static_cast<float*>(partial), M, d);
    else
      ln_dropout_bwd_kernel<float><<<blocks, THREADS, 0, s>>>(
          static_cast<const float*>(g), static_cast<const float*>(n),
          static_cast<const float*>(rstd), static_cast<const float*>(gamma),
          static_cast<float*>(dz_out), static_cast<bf16*>(masked_out),
          static_cast<float*>(partial), M, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (N) = column sums of in (R, N) fp32, rounded to bf16 (and kept in
// fp32) when round_bf16. splits > 1 first sums `splits` row ranges of
// ceil(R / splits) rows into scratch (splits, N), then those in order.
extern "C" int ppgs_colsum(const void* in, long long R, long long N,
                           int splits, void* scratch, void* out,
                           int round_bf16, void* stream) {
  if (N > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned col_blocks = static_cast<unsigned>((N + 255) / 256);
    if (splits > 1) {
      const long long chunk = (R + splits - 1) / splits;
      colsum_kernel<<<dim3(col_blocks, splits), 256, 0, s>>>(
          static_cast<const float*>(in), R, N, chunk,
          static_cast<float*>(scratch), 0);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      colsum_kernel<<<dim3(col_blocks, 1), 256, 0, s>>>(
          static_cast<const float*>(scratch), splits, N, splits,
          static_cast<float*>(out), round_bf16);
    } else {
      colsum_kernel<<<dim3(col_blocks, 1), 256, 0, s>>>(
          static_cast<const float*>(in), R, N, R > 0 ? R : 1,
          static_cast<float*>(out), round_bf16);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
