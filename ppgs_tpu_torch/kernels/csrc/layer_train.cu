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
// colsum's largest launch, dbqkv's (M, 768) fp32 (403 MB), is 0.120 ms at
// 3.35 TB/s. So that the loads keep the memory busy, its first pass splits
// the rows into enough ranges that the blocks fill one wave of 132 SMs x 8
// blocks (ops/backward.py colsum_plan: 352 at that shape), each thread
// reads 16 bytes a row and keeps four rows in flight; its second pass
// spreads the splits' partial sums over blocks of 32 columns x 32 row
// lanes, not one block per 256 columns.

#include <type_traits>

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

// out[col0 ..] = column sums of rows r0 <= r < r1 of in (R, N), r0 = y
// chunk, r1 = min(R, r0 + chunk) (y = blockIdx.y: one split). A block
// takes UNITS units of VEC columns (VEC 4: one 16-byte load a row) in
// LANES row lanes of UNITS threads: lane l sums rows r0 + l, r0 + l +
// LANES, ... into 4 accumulators in turn (four loads in flight), added as
// (a0 + a1) + (a2 + a3); then the lanes' sums are added in lane order
// (one lane: written as they are). The order is fixed, so the sums are the
// same from run to run.
template <int VEC, int UNITS, int LANES>
__global__ void __launch_bounds__(UNITS * LANES)
colsum_kernel(const float* __restrict__ in, long long R, long long N,
              long long chunk, float* __restrict__ out, int round_bf16) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  constexpr int COLS = UNITS * VEC;
  const int unit = threadIdx.x % UNITS, lane = threadIdx.x / UNITS;
  const long long col0 = static_cast<long long>(blockIdx.x) * COLS;
  const long long col = col0 + static_cast<long long>(unit) * VEC;
  const long long r0 = static_cast<long long>(blockIdx.y) * chunk;
  const long long rows = min(R, r0 + chunk) - r0;
  float acc[4][VEC] = {};
  if (col < N) {
    const int n = rows > lane ? static_cast<int>((rows - lane + LANES - 1) /
                                                 LANES)
                              : 0;
    const V* p = reinterpret_cast<const V*>(in + (r0 + lane) * N + col);
    const long long step = LANES * N / VEC;   // in V elements
    auto add = [&](float (&a)[VEC], const V& v) {
      const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] += f[e];
    };
    int i = 0;
#pragma unroll 2
    for (; i + 4 <= n; i += 4) {
      const V v0 = p[0], v1 = p[step], v2 = p[2 * step], v3 = p[3 * step];
      add(acc[0], v0);
      add(acc[1], v1);
      add(acc[2], v2);
      add(acc[3], v3);
      p += 4 * step;
    }
    // the last n % 4 rows, to accumulators 0, 1, 2 in turn
    if (i < n) add(acc[0], p[0]);
    if (i + 1 < n) add(acc[1], p[step]);
    if (i + 2 < n) add(acc[2], p[2 * step]);
  }
  if constexpr (LANES == 1) {
    if (col >= N) return;
    float s[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s[e] = (acc[0][e] + acc[1][e]) + (acc[2][e] + acc[3][e]);
      if (round_bf16) s[e] = ppgs::round_bf16(s[e]);
    }
    *reinterpret_cast<V*>(out + blockIdx.y * N + col) =
        *reinterpret_cast<const V*>(s);
  } else {
    __shared__ float part[LANES][COLS];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      part[lane][unit * VEC + e] = (acc[0][e] + acc[1][e]) +
                                   (acc[2][e] + acc[3][e]);
    __syncthreads();
    for (int j = threadIdx.x; j < COLS; j += UNITS * LANES) {
      if (col0 + j >= N) break;
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < LANES; ++l) s += part[l][j];
      out[blockIdx.y * N + col0 + j] = round_bf16 ? ppgs::round_bf16(s) : s;
    }
  }
}

// One pass over `splits` ranges of `chunk` rows: 256 threads a block in 1,
// 2 or 4 row lanes (each lane at least 8 rows) or, for the second pass
// (wide false), 8 units in 32 row lanes
template <int VEC, int UNITS, int LANES>
cudaError_t colsum_launch(const float* in, long long R, long long N,
                          long long chunk, int splits, float* out,
                          int round_bf16, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(
      (N + UNITS * VEC - 1) / (UNITS * VEC));
  colsum_kernel<VEC, UNITS, LANES><<<dim3(blocks, splits), UNITS * LANES, 0,
                                     s>>>(in, R, N, chunk, out, round_bf16);
  return cudaGetLastError();
}

// The first pass's row lanes: 4 from LANES4_ROWS rows a split, 2 from
// LANES2_ROWS, else 1 (scripts/torch_mel_probe.py times other choices)
constexpr long long LANES4_ROWS = 32, LANES2_ROWS = 16;

template <int VEC>
cudaError_t colsum_pass(const float* in, long long R, long long N,
                        long long chunk, int splits, float* out,
                        int round_bf16, bool wide, cudaStream_t s) {
  if (!wide)
    return colsum_launch<VEC, 8, 32>(in, R, N, chunk, splits, out,
                                     round_bf16, s);
  if (chunk >= LANES4_ROWS)
    return colsum_launch<VEC, 64, 4>(in, R, N, chunk, splits, out,
                                     round_bf16, s);
  if (chunk >= LANES2_ROWS)
    return colsum_launch<VEC, 128, 2>(in, R, N, chunk, splits, out,
                                      round_bf16, s);
  return colsum_launch<VEC, 256, 1>(in, R, N, chunk, splits, out,
                                    round_bf16, s);
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
// fp32) when round_bf16. splits and chunk: the caller's plan
// (ops/backward.py colsum_plan), `splits` row ranges of `chunk` rows, none
// empty (but the one of R = 0), the last ending at R; splits > 1 first
// sums each range into scratch (splits, N), then those in split order.
// 16-byte loads where N % 4 == 0 and every pointer is 16-byte aligned.
extern "C" int ppgs_colsum(const void* in, long long R, long long N,
                           int splits, long long chunk, void* scratch,
                           void* out, int round_bf16, void* stream) {
  if (R < 0 || N < 0 || splits < 1 || chunk < 1 ||
      (R > 0 && (splits - 1) * chunk >= R) || splits * chunk < R ||
      (splits > 1 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(in);
  float* part = static_cast<float*>(splits > 1 ? scratch : out);
  const bool vec =
      N % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(scratch)) & 15) == 0;
  const int first_round = splits > 1 ? 0 : round_bf16;
  cudaError_t err =
      vec ? colsum_pass<4>(x, R, N, chunk, splits, part, first_round, true, s)
          : colsum_pass<1>(x, R, N, chunk, splits, part, first_round, true, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  float* y = static_cast<float*>(out);
  err = vec ? colsum_pass<4>(part, splits, N, splits, 1, y, round_bf16,
                             false, s)
            : colsum_pass<1>(part, splits, N, splits, 1, y, round_bf16,
                             false, s);
  return static_cast<int>(err);
}
