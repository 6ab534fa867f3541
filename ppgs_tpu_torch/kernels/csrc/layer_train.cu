// The row-wise pieces of the training layer's backward: the LayerNorm
// backward with a dropout epilogue at any C % 128 == 0 from 128 to 2048 (a
// template instance each at C = 256, 512 and 768, where a warp takes a row;
// one kernel with the row split over warps at the others), and a
// deterministic column sum. (The forward's out-projection + dropout + LN1
// is K3, out_proj_ln.cu.)
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
// moves 2-4 (M, 256) fp32 arrays (0.13 GB each; twice that at C = 512) for
// at most 0.3 GFLOP (0.6), so both are memory bound (~0.1-0.15 ms; ~0.2-0.3
// at 512); the designs read each input once. ln_dropout_bwd at C = 512: a
// lane takes 16 columns of a row, 128 registers a thread and 48 KB of
// static shared memory for the block's partial sums (at 256: 94-100 and
// 24 KB), no spills. At C = 768 a lane takes 24 columns, and the block's
// three partial sums (72 KB at once, past the 48 KB a block may declare
// statically) meet in 24 KB one after another.
// At the other widths (128, 384, 640, 896, 1024, ..., 2048) a lane holding
// C / 32 columns of a row would need 4 C / 32 registers for the row and 3
// C / 32 for the sums (448 at 2048), so the row is split over warps
// instead (ln_dropout_bwd_split_kernel): pieces of 128 columns, 4 a lane,
// P = C / 128 of them; a block of 8 warps takes R = max(1, 8 / P) rows at
// once, W = 8 / R warps a row, each warp the same one or two pieces of
// every row it takes (so that its column sums stay in 24 registers at
// most); the row's two sums meet in shared memory, added in warp order,
// behind one barrier a round of rows (double-buffered). Right first, not
// yet timed against another split; bound by bytes as the others are
// (0.1423 ms at C = 256 on the training shape, x C / 256).
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

constexpr int THREADS = 256;

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
// [sum g*n | sum g | sum masked] (3 x C per block). A warp takes a row at
// a time, a lane 8 columns of each 256 (H = C / 256 pieces: element 8 k + e
// of a lane is column 256 k + 8 lane + e)
template <typename TG, int C>
__global__ void __launch_bounds__(THREADS)
ln_dropout_bwd_kernel(const TG* __restrict__ g, const float* __restrict__ n,
                      const float* __restrict__ rstd,
                      const float* __restrict__ gamma,
                      float* __restrict__ dz_out, bf16* __restrict__ masked_out,
                      float* __restrict__ partial, int M, ppgs::Dropout drop) {
  constexpr int H = C / 256, V = 8 * H;   // a lane's pieces and columns
  // The warps' partial sums meet in shared memory, all three at once up to
  // C = 512, one at a time past it (static shared memory is 48 KB a block)
  constexpr int ROUNDS = C > 512 ? 3 : 1, PER = 3 / ROUNDS;
  __shared__ float s_part[THREADS / 32][PER * C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c0 = lane * 8;
  float acc_gn[V] = {}, acc_g[V] = {}, acc_m[V] = {};
  ppgs::KeepStream stream(drop);
  const int row_first = blockIdx.x * LB_ROWS + warp * (LB_ROWS / 8);
  for (int i = 0; i < LB_ROWS / 8; ++i) {
    const int r = row_first + i;
    if (r >= M) break;
    const long long base = (long long)r * C + c0;
    float gv[V], dz[V];
#pragma unroll
    for (int k = 0; k < H; ++k) load8<TG>(g + base + 256 * k, gv + 8 * k);
    if (n) {
      float nv[V], dyg[V], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < H; ++k)
        load8<float>(n + base + 256 * k, nv + 8 * k);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        dyg[e] = gv[e] * gamma[c0 + 256 * (e / 8) + e % 8];
        s1 += dyg[e];
        s2 += dyg[e] * nv[e];
        acc_gn[e] += gv[e] * nv[e];
      }
      const float m1 = ppgs::warp_sum(s1) * (1.f / C);
      const float m2 = ppgs::warp_sum(s2) * (1.f / C);
      const float s = rstd[r];
#pragma unroll
      for (int e = 0; e < V; ++e) dz[e] = (dyg[e] - m1 - nv[e] * m2) * s;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dz[e] = gv[e];
    }
    __align__(16) bf16 mc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc_g[e] += gv[e];
      const long long index = base + 256 * (e / 8) + e % 8;
      const float m = drop.threshold
                          ? (stream.keep(index) ? dz[e] * drop.scale : 0.f)
                          : dz[e];
      acc_m[e] += m;
      mc[e] = __float2bfloat16(m);
    }
#pragma unroll
    for (int k = 0; k < H; ++k) {
      if (dz_out) {
        float4* d = reinterpret_cast<float4*>(dz_out + base + 256 * k);
        d[0] = make_float4(dz[8 * k], dz[8 * k + 1], dz[8 * k + 2],
                           dz[8 * k + 3]);
        d[1] = make_float4(dz[8 * k + 4], dz[8 * k + 5], dz[8 * k + 6],
                           dz[8 * k + 7]);
      }
      if (masked_out)
        *reinterpret_cast<uint4*>(masked_out + base + 256 * k) =
            *reinterpret_cast<const uint4*>(mc + 8 * k);
    }
  }
#pragma unroll
  for (int round = 0; round < ROUNDS; ++round) {
    if (round) __syncthreads();   // the last round's sums are read
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int col = c0 + 256 * (e / 8) + e % 8;
      const float sums[3] = {acc_gn[e], acc_g[e], acc_m[e]};
#pragma unroll
      for (int q = 0; q < 3; ++q)
        if (q / PER == round) s_part[warp][(q % PER) * C + col] = sums[q];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < PER * C; j += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) s += s_part[w][j];
      partial[(long long)blockIdx.x * 3 * C + round * PER * C + j] = s;
    }
  }
}

// The same function at every other C (the note at the top): pieces of 128
// columns (4 a lane: element 4 i + e of a lane is column 128 piece_i + 4
// lane + e), W warps a row, R rows a round; PPW, the pieces a warp takes
// (1, or 2 past C = 1024)
constexpr int SPLIT_MAX_C = 2048;

template <typename TG>
__device__ __forceinline__ void load4(const TG* p, float v[4]);

template <>
__device__ __forceinline__ void load4<float>(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

template <>
__device__ __forceinline__ void load4<bf16>(const bf16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = __bfloat162float(h[e]);
}

template <typename TG, int PPW>
__global__ void __launch_bounds__(THREADS)
ln_dropout_bwd_split_kernel(const TG* __restrict__ g,
                            const float* __restrict__ n,
                            const float* __restrict__ rstd,
                            const float* __restrict__ gamma,
                            float* __restrict__ dz_out,
                            bf16* __restrict__ masked_out,
                            float* __restrict__ partial, int M, int C,
                            ppgs::Dropout drop) {
  constexpr int V = 4 * PPW, WARPS = THREADS / 32;
  const int P = C / 128;
  const int R = P >= WARPS ? 1 : WARPS / P;       // rows a round
  const int W = WARPS / R;                        // warps a row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / W, wr = warp % W;       // the row, the warp in it
  const bool active = slot < R;                   // R W may be under 8
  // the warp's pieces: wr, wr + W (the second only past P = W)
  int col[PPW];
  bool own[PPW];
#pragma unroll
  for (int i = 0; i < PPW; ++i) {
    const int piece = wr + i * W;
    own[i] = active && piece < P;
    col[i] = 128 * piece + 4 * lane;
  }
  // [2 buffers][R rows][W warps][2 sums], and the column sums by row slot
  __shared__ float s_row[2][WARPS][2];
  __shared__ float s_part[3 * SPLIT_MAX_C];
  float acc_gn[V] = {}, acc_g[V] = {}, acc_m[V] = {};
  const int row0 = blockIdx.x * LB_ROWS;
  const int rounds = LB_ROWS / R;
  for (int k = 0; k < rounds; ++k) {
    const int r = row0 + k * R + slot;
    const bool live = active && r < M;
    const long long base = static_cast<long long>(r) * C;
    float gv[V], nv[V], dyg[V];
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      if (!(live && own[i])) {
#pragma unroll
        for (int e = 0; e < 4; ++e) gv[4 * i + e] = nv[4 * i + e] = 0.f;
        continue;
      }
      load4<TG>(g + base + col[i], gv + 4 * i);
      if (n) load4<float>(n + base + col[i], nv + 4 * i);
    }
    float s1 = 0.f, s2 = 0.f;
    if (n) {
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * i + e;
          dyg[j] = own[i] ? gv[j] * gamma[col[i] + e] : 0.f;
          s1 += dyg[j];
          s2 += dyg[j] * nv[j];
        }
      }
      s1 = ppgs::warp_sum(s1);
      s2 = ppgs::warp_sum(s2);
      float* sums = s_row[k & 1][warp];
      if (lane == 0) sums[0] = s1, sums[1] = s2;
      __syncthreads();    // a round's sums; the buffer is reused two on
      s1 = s2 = 0.f;
      for (int w = 0; w < W && active; ++w) {
        s1 += s_row[k & 1][slot * W + w][0];
        s2 += s_row[k & 1][slot * W + w][1];
      }
    }
    if (!live) continue;
    const float m1 = s1 * (1.f / C), m2 = s2 * (1.f / C);
    const float inv = n ? rstd[r] : 0.f;
    ppgs::KeepStream stream(drop);
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      if (!own[i]) continue;
      float dz[4], m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * i + e;
        dz[e] = n ? (dyg[j] - m1 - nv[j] * m2) * inv : gv[j];
        if (n) acc_gn[j] += gv[j] * nv[j];
        acc_g[j] += gv[j];
        m[e] = drop.threshold
                   ? (stream.keep(base + col[i] + e) ? dz[e] * drop.scale
                                                     : 0.f)
                   : dz[e];
        acc_m[j] += m[e];
      }
      if (dz_out)
        *reinterpret_cast<float4*>(dz_out + base + col[i]) =
            make_float4(dz[0], dz[1], dz[2], dz[3]);
      if (masked_out) {
        __align__(8) bf16 mc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) mc[e] = __float2bfloat16(m[e]);
        *reinterpret_cast<uint2*>(masked_out + base + col[i]) =
            *reinterpret_cast<const uint2*>(mc);
      }
    }
  }
  // The block's partial sums [g n | g | masked], R row slots added in slot
  // order, one slot at a time through s_part
  for (int q = 0; q < R; ++q) {
    __syncthreads();
    if (slot == q && active) {
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        if (!own[i]) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * i + e, c = col[i] + e;
          const float sums[3] = {acc_gn[j], acc_g[j], acc_m[j]};
#pragma unroll
          for (int u = 0; u < 3; ++u)
            s_part[u * C + c] = q ? s_part[u * C + c] + sums[u] : sums[u];
        }
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * C; j += THREADS)
    partial[static_cast<long long>(blockIdx.x) * 3 * C + j] = s_part[j];
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

template <int C>
void launch_ln_dropout_bwd(const void* g, int g_is_bf16, const void* n,
                           const void* rstd, const void* gamma, void* dz_out,
                           void* masked_out, void* partial, int M,
                           const ppgs::Dropout& d, cudaStream_t s) {
  const unsigned blocks = (M + LB_ROWS - 1) / LB_ROWS;
  const float* nf = static_cast<const float*>(n);
  const float* rf = static_cast<const float*>(rstd);
  const float* gf = static_cast<const float*>(gamma);
  float* dz = static_cast<float*>(dz_out);
  bf16* mo = static_cast<bf16*>(masked_out);
  float* p = static_cast<float*>(partial);
  if (g_is_bf16)
    ln_dropout_bwd_kernel<bf16, C><<<blocks, THREADS, 0, s>>>(
        static_cast<const bf16*>(g), nf, rf, gf, dz, mo, p, M, d);
  else
    ln_dropout_bwd_kernel<float, C><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(g), nf, rf, gf, dz, mo, p, M, d);
}

template <int PPW>
void launch_ln_dropout_bwd_split(const void* g, int g_is_bf16, const void* n,
                                 const void* rstd, const void* gamma,
                                 void* dz_out, void* masked_out,
                                 void* partial, int M, int C,
                                 const ppgs::Dropout& d, cudaStream_t s) {
  const unsigned blocks = (M + LB_ROWS - 1) / LB_ROWS;
  const float* nf = static_cast<const float*>(n);
  const float* rf = static_cast<const float*>(rstd);
  const float* gf = static_cast<const float*>(gamma);
  float* dz = static_cast<float*>(dz_out);
  bf16* mo = static_cast<bf16*>(masked_out);
  float* p = static_cast<float*>(partial);
  if (g_is_bf16)
    ln_dropout_bwd_split_kernel<bf16, PPW><<<blocks, THREADS, 0, s>>>(
        static_cast<const bf16*>(g), nf, rf, gf, dz, mo, p, M, C, d);
  else
    ln_dropout_bwd_split_kernel<float, PPW><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(g), nf, rf, gf, dz, mo, p, M, C, d);
}

}  // namespace

// g (M, C) fp32 (g_is_bf16 = 0) or bf16, C % 128 == 0 from 128 to 2048; n
// (M, C) and rstd (M) fp32, or n = null for no LayerNorm; gamma (C). dz_out
// (M, C) fp32 or null, masked_out (M, C) bf16 or null; partial
// (ceil(M/64), 3, C) fp32. Any other C returns cudaErrorInvalidValue.
extern "C" int ppgs_ln_dropout_bwd(
    const void* g, int g_is_bf16, const void* n, const void* rstd,
    const void* gamma, void* dz_out, void* masked_out, void* partial, int M,
    int C, unsigned seed_lo, unsigned seed_hi, unsigned site,
    unsigned threshold, float scale, void* stream) {
  if (C % 128 || C < 128 || C > SPLIT_MAX_C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0) {
    const ppgs::Dropout d =
        ppgs::make_dropout(seed_lo, seed_hi, site, threshold, scale);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C == 768)
      launch_ln_dropout_bwd<768>(g, g_is_bf16, n, rstd, gamma, dz_out,
                                 masked_out, partial, M, d, s);
    else if (C == 512)
      launch_ln_dropout_bwd<512>(g, g_is_bf16, n, rstd, gamma, dz_out,
                                 masked_out, partial, M, d, s);
    else if (C == 256)
      launch_ln_dropout_bwd<256>(g, g_is_bf16, n, rstd, gamma, dz_out,
                                 masked_out, partial, M, d, s);
    else if (C <= 1024)      // P <= 8 pieces: one a warp
      launch_ln_dropout_bwd_split<1>(g, g_is_bf16, n, rstd, gamma, dz_out,
                                     masked_out, partial, M, C, d, s);
    else
      launch_ln_dropout_bwd_split<2>(g, g_is_bf16, n, rstd, gamma, dz_out,
                                     masked_out, partial, M, C, d, s);
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
