// B10: the wav2vec2 feature extractor's conv chain (7 VALID convs of 512
// channels, k = (10,3,3,3,3,2,2), s = (5,2,2,2,2,2,2), GroupNorm(512, 512)
// after conv 0, tanh-GELU after each conv), bf16 stream, fp32 statistics.
//
// Replaces: ppgs_tpu/ops/conv_stack.py feature_encoder_stack, its
// _stats_kernel (conv 0's per-channel sum and sum of squares over every
// conv-0 frame) and _stack_kernel (conv 0 -> GroupNorm -> GELU -> the six
// strided convs with GELU, per time tile, all in VMEM).
//
// The TPU kernel runs the whole chain per time tile with every
// intermediate in VMEM, and writes its strided convs as a "lane fold" (a
// Mosaic workaround for strided sublane slices). Neither carries over: at
// 128 final frames a tile's conv-1 input alone is 8,207 rows x 512
// channels (8.4 MB), far past the 227 KB a Hopper block may have, and
// strided reads cost nothing special here. So:
//
// - conv_stats_kernel: the statistics need no conv-0 output. With p_f
//   frame f's patch (k0 <= 16 samples), sum_f x_c = w_c . A and sum_f x_c^2
//   = w_c^T G w_c, A = sum_f p_f and G = sum_f p_f p_f^T (the patches'
//   Gram matrix, 16 x 16 zero past k0): a block per (4608 frames,
//   utterance) sums A and G in fp64 on the fp64 tensor cores (exact bf16
//   products, ~1e-16 sums), and the last block of an utterance (an atomic
//   ticket) adds the partials in tile order and contracts them with w0 in
//   fp64, each statistic rounded once to fp32: the same from run to run.
// - conv0_gelu_kernel: conv 1's input, bf16(gelu(GN(conv 0))), to device
//   memory (1.68 GB at 64 x 8 s; the library path stores it too): a block
//   (one warpgroup) per 128 frames of an utterance, conv 0 as one k16
//   wgmma a 64 x 64 step from A fragments made of the audio in registers
//   and W0 resident in shared memory, the GroupNorm folded into one FMA,
//   a fast GELU that keeps tanhf's bf16 (gelu_pair's guard), and TMA
//   stores.
// - conv_gelu_kernel: one strided conv as an implicit GEMM on wgmma + TMA
//   (hopper.cuh), GELU and the bf16 rounding in its epilogue. For a
//   row-major (T_in, C) input the taps of output row t are input rows
//   s*t .. s*t + k - 1, so the conv is a product of depth k*C against the
//   JAX weight (k, C_in, C_out) read as (k*C_in, C_out). Convs 1-6 all
//   take it; conv 1 (the first form) on conv0_gelu's output.
//
// Rounding follows the TPU kernel: the audio and the weights are bf16,
// products accumulate in fp32, the GroupNorm is fp32 with var = E[x^2] -
// mean^2 from the statistics pass (summed in fp64 here, in fp32 there),
// GELU is fp32 (conv 1's input tanhf's, each conv's output by an ex2/rcp
// form of the same function, gelu_out), and every conv output is rounded
// to bf16.
//
// Bound on an H100 (989 TFLOP/s bf16, 67 fp64, 3.35 TB/s) at 64 x 8 s
// (128,080 samples), every conv by operations: conv 1 1.29 TFLOP (conv 0
// adds 17 GFLOP), 1.3205 ms; conv 2 0.6517; convs 3-6 0.326, 0.163, 0.054,
// 0.027. The bytes (the audio in, each conv's bf16 input and output once)
// come to ~0.4 ms for the chain; conv0_gelu's 1.68 GB out take 0.5061 ms
// more; conv_stats reads the 16.4 MB of audio, 0.0049 ms (its fp64
// products, 0.21 GFLOP, take less; forming conv 0, as the direct route
// did, counts 0.0170 ms of operations).
//
// conv_stats' design. A block stages its samples in shared memory by
// 16-byte loads. A warp takes groups of 8 frames: lane 4g + t holds taps g
// and 8 + g of frames t and t + 4, which are at once A (16 taps x 8
// frames) and B (8 frames x taps 0-7, or 8-15) of m16n8k8 fp64 products:
// D0 = G[0..15][0..7] gives rows 0-7 of G by symmetry; D1 = G[..][8..15]
// is summed where k0 and s0 > 8. Otherwise rows 8.. come from rows 8 -
// s0..: shifting every frame by one stride drops frame 0's term and adds
// frame T0's, so G[p][q] = G[p - s0][q - s0] + a(s0 T0 + p - s0) a(s0 T0 +
// q - s0) - a(p - s0) a(q - s0). The last block contracts G with w0 by
// m16n8k8 products too (V = G W, sq_c = sum_p W[p][c] V[p][c]). What
// bounds it (PERF.md §6): the products (~35 TFLOP/s of fp64, 16 x 8
// a frame where (10, 5) needs 5 x 10), the staging, and the last block's
// tail.
//
// conv0_gelu's design. Step (row group r, eighth q): one wgmma.m64n64k16
// RS, A's fragments (row r, tap k -> sample s0 r + k, zero past k0 and
// T0) made once per row group straight from the audio (no im2col), B =
// W0's columns 64 q.. (16 x 512 bf16, taps past k0 zero-filled by its TMA
// load, 128-byte swizzled, MN-major); the epilogue x * (rstd gamma) +
// (beta - mean rstd gamma) from a per-block table, the GELU pair by pair
// by gelu_fast (one ex2.approx and one rcp.approx) with the guard: where
// the fast value lies within a margin of a bf16 rounding midpoint (the two
// forms' error bounds, twice over) the lane marks the pair and makes it by
// tanhf after the step's loop, so that the output is tanhf's bf16 bit for
// bit; bf16 words into a 64 x 64 stage, stored by TMA through a (512, T0,
// B) map. 7 blocks an SM (72 registers): the epilogue's issue rate bounds
// it, above the grid storing zeros (~0.57 ms); conv 0 by FMAs in tap order
// (a variant in scripts/torch_conv_probe.py) measured 2.4 times slower
// (PERF.md §6).
//
// conv_gelu's design. A block computes 128 output rows x 256 of the 512
// columns (grid: 2 column halves a row tile, the halves adjacent so that a
// row tile's input is read from memory once); rows stay inside one
// utterance, so each utterance's last tile is ragged. Two consumer
// warpgroups of 64 rows each issue wgmma.m64n256k16 with fp32 sums in
// registers (128 a thread); the depth is walked in steps of one tap's 64
// input channels (step i: tap i % k, channels 64 (i / k)..), A and W's 64
// rows x 256 columns (four 64-column boxes, MN-major as stored) by TMA. A
// needs no im2col: tap j has its own 3-D tensor map (512 channels, T_out
// rows s*512 apart, B utterances) based at x + j*512, so its rows do not
// overlap and boxes past T_out read zeros. One producer thread keeps a
// ring of 4 stages (A 16 KB + W 32 KB) in flight from a warp of its own,
// as qkv_proj.cu does. The epilogue applies GELU to the sums, rounds them
// to bf16, stages each warpgroup's 64 x 256 as four 128-byte-swizzled
// boxes where the ring was and writes them by TMA stores through a (512,
// T_out, B) map, which clips the ragged tile. The loads bound it (a walk
// without the products takes ~70% of its time, PERF.md).
//
// Why conv 1's input is stored, not made inside the product (the TPU's
// way): made per block, it costs ~35 instructions an element on the CUDA
// cores (tanhf most of them), and a block can spare one warpgroup for it
// (a fourth would cap every thread at 128 registers, less than the sums
// need: ptxas sets the launch's cap for all code, setmaxnreg or not). The
// two folds measured ran slower than conv0_gelu plus the plain form, bound
// by making the operand; W shared by TMA multicast across clusters of two
// row tiles measured a tie with one block a tile. Neither is kept (their
// designs and times: PERF.md).
// A wait on a barrier that lasts seconds traps (a launch error) rather
// than hanging the card.

#include "hopper.cuh"

using ppgs::bf16;
using namespace ppgs::hopper;

namespace {

constexpr int C = 512;                 // the stack's channels
constexpr int MAX_K0 = 16;             // conv 0 taps (the TPU's PATCH_LANES)
constexpr float GN_EPS = 1e-5f;

// ---------------------------------------------------------------- stats

constexpr int STATS_FRAMES = 4608;     // conv-0 frames a stats block, at most
constexpr int STATS_SAMPLES = 24576;   // samples a block stages, at most
constexpr int STATS_WARPS = 8;
constexpr int STATS_K = 8;             // frames a product takes
constexpr int GRAM = MAX_K0 * MAX_K0 + MAX_K0;   // a partial: G, then A

// A stats block's frames: as many as STATS_FRAMES and STATS_SAMPLES allow
__host__ __device__ constexpr int stats_frames(int s0) {
  return (STATS_SAMPLES - MAX_K0) / s0 + 1 < STATS_FRAMES
             ? (STATS_SAMPLES - MAX_K0) / s0 + 1
             : STATS_FRAMES;
}

// d (16 x 8 fp64) += a (16 x 8) b (8 x 8) on the fp64 tensor cores: lane
// 4g + t holds a[g][t], a[g + 8][t], a[g][t + 4], a[g + 8][t + 4],
// b[t][g], b[t + 4][g], d[g][2t .. 2t + 1] and d[g + 8][2t .. 2t + 1]
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double a2, double a3, double b0,
                                     double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

__device__ __forceinline__ double f64(unsigned short bits) {
  return static_cast<double>(__uint_as_float(static_cast<uint32_t>(bits)
                                             << 16));
}

// The statistics of conv 0 through the patches' Gram matrix: with p_f the
// patch of frame f (samples s0 f .. s0 f + k0 - 1), x_c(f) = w_c . p_f, so
// sum_f x_c = w_c . A and sum_f x_c^2 = w_c^T G w_c with A = sum_f p_f and
// G = sum_f p_f p_f^T. A block stages the samples of up to STATS_FRAMES
// frames of one utterance in shared memory and sums A and G over them in
// fp64 (bf16 products are exact in fp64, so the sums are exact to ~1e-16
// relative); the last block of an utterance (an atomic ticket) adds the
// partials in tile order and contracts them with w0, so the statistics
// are the same from run to run.
__global__ void __launch_bounds__(STATS_WARPS * 32, 3)
conv_stats_kernel(const bf16* __restrict__ audio, long long S,
                  const bf16* __restrict__ w0, int k0, int s0, int T0,
                  int tiles, double* __restrict__ partial,
                  float* __restrict__ sums, unsigned* __restrict__ tickets) {
  extern __shared__ uint4 stage_raw[];
  __shared__ double red[STATS_WARPS][GRAM];
  __shared__ double total[GRAM];
  __shared__ bool last;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* a = audio + b * S;
  const int frames = stats_frames(s0), f_begin = tile * frames;
  const int nf = min(frames, T0 - f_begin);
  const int n = s0 * (nf - 1) + k0;
  // The block's samples into shared memory: 16-byte loads from the first
  // 16-byte aligned address on (`samples` placed so that they land
  // aligned), the head and tail sample by sample
  const unsigned short* src = reinterpret_cast<const unsigned short*>(a) +
                              static_cast<long long>(s0) * f_begin;
  const int head =
      static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) /
      2;
  unsigned short* samples =
      reinterpret_cast<unsigned short*>(stage_raw) + (8 - head) % 8;
  const int body = max(0, (n - head) / 8);
#pragma unroll 4
  for (int i = threadIdx.x; i < body; i += STATS_WARPS * 32)
    reinterpret_cast<uint4*>(samples + head)[i] =
        reinterpret_cast<const uint4*>(src + head)[i];
  if (threadIdx.x < min(head, n)) samples[threadIdx.x] = src[threadIdx.x];
  for (int i = head + 8 * body + threadIdx.x; i < n; i += STATS_WARPS * 32)
    samples[i] = src[i];
  __syncthreads();

  // A warp takes groups of STATS_K frames, STATS_K STATS_WARPS apart: lane
  // 4g + t holds taps g and 8 + g of frames t and t + 4, at once A (the
  // patches transposed, 16 taps x 8 frames) and B (8 frames x taps 0-7,
  // or 8-15) of m16n8k8 products. D0 = G[0..15][0..7]
  // gives rows 0-7 of G (G is symmetric); D1 = G[0..15][8..15], rows 8-15,
  // is summed only where they do not come from rows - s0 (below). Two sets
  // of sums (even and odd groups).
  const bool high = k0 > 8, base_high = high && s0 > 8;
  double d0[2][4] = {}, d1[2][4] = {};
  double s_lo = 0.0, s_hi = 0.0;
  auto sample = [&](int f, int p) {
    return p < k0 && f < nf ? f64(samples[s0 * f + p]) : 0.0;
  };
  for (int f0 = STATS_K * warp + t; f0 - t < nf;
       f0 += 2 * STATS_K * STATS_WARPS) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = f0 + STATS_K * STATS_WARPS * i;
      const double x = sample(f, g), y = sample(f, 8 + g);
      const double x4 = sample(f + 4, g), y4 = sample(f + 4, 8 + g);
      dmma(d0[i], x, y, x4, y4, x, x4);
      if (base_high) dmma(d1[i], x, y, x4, y4, y, y4);
      s_lo += x + x4;
      s_hi += y + y4;
    }
  }
  // A over the frames of the quad
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s_lo += __shfl_xor_sync(0xffffffffu, s_lo, o);
    s_hi += __shfl_xor_sync(0xffffffffu, s_hi, o);
  }
  double* mine = red[warp];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = 2 * t + e;
    mine[c * MAX_K0 + g] = d0[0][e] + d0[1][e];              // G[c][g]
    mine[c * MAX_K0 + 8 + g] = d0[0][2 + e] + d0[1][2 + e];  // G[c][8 + g]
    mine[(8 + g) * MAX_K0 + c] = 0.0;                        // below
    mine[(8 + g) * MAX_K0 + 8 + c] = d1[0][2 + e] + d1[1][2 + e];
  }
  if (t == 0) {
    mine[MAX_K0 * MAX_K0 + g] = s_lo;
    mine[MAX_K0 * MAX_K0 + 8 + g] = s_hi;
  }
  __syncthreads();
  double* block = partial + (static_cast<long long>(b) * tiles + tile) * GRAM;
  for (int j = threadIdx.x; j < GRAM; j += STATS_WARPS * 32) {
    double v = 0.0;
    for (int w = 0; w < STATS_WARPS; ++w) v += red[w][j];
    block[j] = v;
  }

  // The last block of utterance b adds the partials in tile order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + b, 1u) == tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Its loads all at once: w0 (k0 x 512 bf16) into shared memory over
  // `red`, the partials (eight tiles' in flight), and the samples of rows
  // p >= 8 without D1, which come from row p' = p - m s0 < 8: shifting
  // every frame by one stride drops frame 0's term and adds frame T0's,
  // G[p][q] = G[p - s0][q - s0] + a(s0 T0 + p - s0) a(s0 T0 + q - s0)
  //           - a(p - s0) a(q - s0)
  unsigned short* w_sm = reinterpret_cast<unsigned short*>(&red[0][0]);
  for (int j = threadIdx.x; j < k0 * C / 8; j += STATS_WARPS * 32)
    reinterpret_cast<uint4*>(w_sm)[j] = reinterpret_cast<const uint4*>(w0)[j];
  const int p = threadIdx.x / MAX_K0, q = threadIdx.x % MAX_K0;
  const bool derived = high && !base_high && p >= 8 && p <= q && q < k0;
  const int m = derived ? (p - 8) / s0 + 1 : 0;
  double shift = 0.0;     // the first and last frames' terms
  if (derived) {
    const auto at = [&](long long k) {
      return f64(__bfloat16_as_ushort(a[k]));
    };
    const long long end = static_cast<long long>(s0) * T0;
    for (int j = 1; j <= m; ++j)
      shift += at(end + p - j * s0) * at(end + q - j * s0) -
               at(p - j * s0) * at(q - j * s0);
  }
  const double* all = partial + static_cast<long long>(b) * tiles * GRAM;
  for (int j = threadIdx.x; j < GRAM; j += STATS_WARPS * 32) {
    double v = 0.0;
    for (int k = 0; k < tiles; k += 8) {
      double part[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        part[u] = k + u < tiles ? __ldcg(all + (k + u) * GRAM + j) : 0.0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k + u < tiles) v += part[u];
    }
    total[j] = v;
  }
  __syncthreads();
  if (high && !base_high) {
    const double v =
        derived ? total[(p - m * s0) * MAX_K0 + q - m * s0] + shift : 0.0;
    __syncthreads();
    if (p >= 8) total[threadIdx.x] = v;
    __syncthreads();
  }
  // G's lower triangle from its upper one
  if (p > q) total[threadIdx.x] = total[q * MAX_K0 + p];
  __syncthreads();
  // sum_c = w_c . A and sq_c = w_c^T G w_c in fp64, each rounded once to
  // fp32: V = G W by m16n8k8 products, 8 channels a warp at a time (W =
  // w0 zero past k0), then sq_c = sum_p W[p][c] V[p][c] over the lanes'
  // rows
  static_assert(STATS_WARPS * 32 == MAX_K0 * MAX_K0, "a thread an entry");
  const auto weight = [&](int p, int c) {
    return p < k0 ? f64(w_sm[p * C + c]) : 0.0;
  };
  double ga[2][4];        // G's k-steps (columns 0-7, 8-15) as A fragments
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      ga[k][u] = total[(g + 8 * (u & 1)) * MAX_K0 + 8 * k + t + 4 * (u >> 1)];
  const double a_g = total[MAX_K0 * MAX_K0 + g];
  const double a_g8 = total[MAX_K0 * MAX_K0 + 8 + g];
  for (int c0 = 8 * warp; c0 < C; c0 += 8 * STATS_WARPS) {
    double v[4] = {};     // V[g][c0 + 2t + i], V[g + 8][c0 + 2t + i]
#pragma unroll
    for (int k = 0; k < 2; ++k)
      dmma(v, ga[k][0], ga[k][1], ga[k][2], ga[k][3],
            weight(8 * k + t, c0 + g), weight(8 * k + t + 4, c0 + g));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c0 + 2 * t + i;
      const double w_lo = weight(g, c), w_hi = weight(8 + g, c);
      double sum = fma(w_lo, a_g, w_hi * a_g8);
      double sq = fma(w_lo, v[i], w_hi * v[2 + i]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {     // over g
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      if (g == 0) {
        sums[b * 2 * C + c] = static_cast<float>(sum);
        sums[b * 2 * C + C + c] = static_cast<float>(sq);
      }
    }
  }
  if (threadIdx.x == 0) tickets[b] = 0u;
}

// ---------------------------------------------------------------- convs

constexpr int MAX_K = 3;               // conv_gelu's taps
constexpr int BK = 64;                 // input channels of a tap tile
constexpr int CHUNKS = C / BK;         // 64-channel chunks of a tap
constexpr int BOX = 64 * 128;          // 64 rows of 128 bytes
// false: a loads-only walk (no products); false: the epilogue's GELU by
// tanhf (scripts/torch_conv_probe.py times each)
constexpr bool LIVE = true;
constexpr bool FAST_GELU = true;

// The epilogue's tanh-approximate GELU, 0.5 x (1 + tanh(u)) with u =
// sqrt(2 / pi) (x + 0.044715 x^3), as x / (1 + 2^z), z = -2 log2(e) u: one
// ex2.approx and one rcp.approx (relative error ~1e-6) where tanhf takes
// ~20 instructions. It rounds a share of the outputs one bf16 ulp apart
// from tanhf's (PERF.md). Conv 1's input (conv0_gelu_kernel) keeps
// tanhf's bf16 (gelu_pair's guard): there a rounding apart passes through
// the next conv's sums.
__device__ __forceinline__ float gelu_fast(float x) {
  constexpr float K0 = -2.f * 1.4426950408889634f * 0.7978845608028654f;
  constexpr float K1 = K0 * 0.044715f;
  return __fdividef(x, 1.f + exp2_approx(x * fmaf(K1, x * x, K0)));
}
__device__ __forceinline__ float gelu_out(float x) {
  return FAST_GELU ? gelu_fast(x) : ppgs::gelu_tanh(x);
}

// bf16(gelu(acc)) of a consumer warpgroup's 64 x 256 sums, staged as four
// 64 x 64 boxes at `stage` and stored by TMA at (col0.., row, window) of
// `map_out`, which clips rows past T; `lead`: the warpgroup's thread 0
__device__ __forceinline__ void store_out(float (&acc)[128],
                                          unsigned char* stage,
                                          const CUtensorMap* map_out,
                                          int col0, int row, int window,
                                          int c, bool lead, int T) {
  // hopper.cuh's stage_bf16 with GELU applied a pair at a time, so that
  // each pair's registers are free once it is staged (GELU over all 128
  // sums first spilled at 168 registers)
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, at = (16 * warp + g) * 128 + 4 * t;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    unsigned char* p = stage + (j / 8) * BOX + at + (((j % 8) ^ g) << 4);
    *reinterpret_cast<uint32_t*>(p) =
        pack_bf16(gelu_out(acc[4 * j]), gelu_out(acc[4 * j + 1]));
    *reinterpret_cast<uint32_t*>(p + 8 * 128) =
        pack_bf16(gelu_out(acc[4 * j + 2]), gelu_out(acc[4 * j + 3]));
  }
  auto box = [&](int n) { return stage + n * BOX; };
  store_boxes(map_out, 4, 64, box, col0, row, window, c, lead, T);
}

// ---- the plain form: A and W by TMA

constexpr int BM = 128, BN = 256;      // a block's rows and columns
constexpr int STAGES = 4;
constexpr int A_TILE = BM * BK * 2;    // 128 rows x 64 channels, K-major
constexpr int W_TILE = BK * BN * 2;    // 64 depth rows x 256 columns
constexpr int STAGE = A_TILE + W_TILE;
constexpr int PLAIN_BARS = STAGES * STAGE;
constexpr int PLAIN_SMEM = PLAIN_BARS + 128 + 1024;

// x (B, T_in, C) bf16 through tap j's map map_aj (rows s*C apart, based at
// tap j's first row); w (k*C, C) through map_w in 64 x 64 boxes; out (C,
// T_out, B) through map_out in 64 x 64 boxes. tiles: row tiles an
// utterance. Block x computes column half x % 2 of row tile x / 2 (the
// tiles of all utterances in a row): a row tile's two halves are adjacent,
// so that its input is read from memory once.
__global__ void __launch_bounds__(288, 1)
conv_gelu_kernel(const __grid_constant__ CUtensorMap map_a0,
                 const __grid_constant__ CUtensorMap map_a1,
                 const __grid_constant__ CUtensorMap map_a2,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_out, int k,
                 int T_out, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + PLAIN_BARS);
  uint64_t* empty = full + STAGES;
  const int col0 = (blockIdx.x % 2) * BN, tile = blockIdx.x / 2;
  const int b = tile / tiles, t0 = (tile % tiles) * BM;
  const int steps = k * CHUNKS;        // step i: tap i % k, chunk i / k

  // every consumer warp frees a stage
  if (threadIdx.x == 0) mbar_init_ring(full, empty, STAGES, 8);
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer warp: one thread keeps the ring of (A, W) stages full
    if (threadIdx.x == 256) {
      for (int i = 0; i < steps; ++i) {
        const int st = i % STAGES, tap = i % k, depth = tap * C + i / k * BK;
        if (i >= STAGES)
          mbar_wait(smem_addr(empty + st), (i / STAGES - 1) & 1);
        const uint32_t bar = smem_addr(full + st);
        mbar_expect_tx(bar, STAGE);
        unsigned char* dst = sm + st * STAGE;
        tma_load_3d(dst, tap == 0 ? &map_a0 : tap == 1 ? &map_a1 : &map_a2,
                    i / k * BK, t0, b, bar);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          tma_load(dst + A_TILE + q * BOX, &map_w, col0 + q * 64, depth, bar);
      }
    }
    return;
  }
  // Consumers: warpgroup c owns rows 64c .. 64c + 63 of the tile
  const int c = threadIdx.x / 128, lane = threadIdx.x % 32;
  const uint32_t base = smem_addr(sm);
  float acc[BN / 2];
  zero(acc);
  for (int i = 0; i < steps; ++i) {
    const int st = i % STAGES;
    mbar_wait(smem_addr(full + st), (i / STAGES) & 1);
    const uint32_t a_addr = base + st * STAGE + c * 64 * 128;
    const uint32_t b_addr = base + st * STAGE + A_TILE;
    fence_regs(acc);
    wgmma_fence();
    if (LIVE) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<BN, 0, 1>(acc, sw128_desc(a_addr + kk * 32, 16, 1024),
                           sw128_desc(b_addr + kk * 2048, BOX, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();      // the previous step's products are done
    fence_regs(acc);
    if (i > 0 && lane == 0) mbar_arrive(smem_addr(empty + (i - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  // The epilogue's boxes take the ring's first 64 KB once every consumer's
  // products are done (every stage loaded was waited for)
  bar_sync(3, 256);
  store_out(acc, sm + c * 4 * BOX, &map_out, col0, t0 + 64 * c, b, c,
            threadIdx.x % 128 == 0, T_out);
}

// ---- the first form's operand: conv 0, the GroupNorm and GELU

constexpr int C0_FRAMES = 128;         // conv-0 frames a block: 2 row groups
constexpr int C0_COLS = 64;            // columns a step (an eighth of C)
constexpr int W0_BOX = 16 * 128;       // 16 taps x 64 columns of W0, bf16
constexpr int C0_BOXES = C0_COLS / 64;
constexpr int C0_STAGE = C0_BOXES * BOX;   // a step's 64-row bf16 outputs
constexpr int C0_OUT = (C / 64) * W0_BOX;          // W0's 8 boxes first
constexpr int C0_GN = C0_OUT + C0_STAGE;           // the output stage
constexpr int C0_BAR = C0_GN + (C / 2) * 16;       // the GroupNorm's table
constexpr int C0_SMEM = C0_BAR + 8 + 1024;         // + 1024-byte alignment
// false: the grid stores zeros (scripts/torch_conv_probe.py times it)
constexpr bool CONV0_LIVE = true;

// The guard's margin about gelu_fast(x), in units of 2^-24: |tanhf form -
// fast form| <= 6 |x| + 12 |fast| (PERF.md, ops/conv_stack.py GELU_ERR_*),
// taken twice over
constexpr float GUARD_ABS = 12.f / 16777216.f;
constexpr float GUARD_REL = 24.f / 16777216.f;

// bf16(gelu_fast(x0)), bf16(gelu_fast(x1)) as a pair (x0 in the low
// half), and in `unsafe` the halves that may not be tanhf's bf16: where
// the value f lies within the margin m of a bf16 rounding midpoint (f - m
// and f + m round apart; where they round alike, tanhf's value, within m
// of f, rounds alike too)
__device__ __forceinline__ uint32_t gelu_pair(float x0, float x1,
                                              uint32_t& unsafe) {
  const float f0 = gelu_fast(x0), f1 = gelu_fast(x1);
  const float m0 = fmaf(GUARD_ABS, fabsf(x0), GUARD_REL * fabsf(f0));
  const float m1 = fmaf(GUARD_ABS, fabsf(x1), GUARD_REL * fabsf(f1));
  const uint32_t hi = pack_bf16(f0 + m0, f1 + m1);
  unsafe = hi ^ pack_bf16(f0 - m0, f1 - m1);
  return hi;
}

// A thread's four sums of column group j (acc[4j .. 4j + 3]) for a j in
// [LO, HI) known only at run time, by a binary search on j, without
// moving acc to local memory
template <int LO, int HI, int N>
__device__ __forceinline__ float4 sums_of(const float (&acc)[N], int j) {
  if constexpr (HI - LO == 1) {
    return make_float4(acc[4 * LO], acc[4 * LO + 1], acc[4 * LO + 2],
                       acc[4 * LO + 3]);
  } else {
    constexpr int MID = (LO + HI) / 2;
    return j < MID ? sums_of<LO, MID>(acc, j) : sums_of<MID, HI>(acc, j);
  }
}

struct First {            // the GroupNorm of conv 0: conv 1's input
  const float* sums;      // (B, 2, C): sum and sum of squares of conv 0
  const float* gamma;     // (C) GroupNorm scale
  const float* beta;      // (C) GroupNorm shift
  int k0, s0, T0;
  long long S;            // samples per utterance
};

// act (B, T0, C) bf16 = bf16(gelu(GN(conv 0 of the audio))): a block (one
// warpgroup) per C0_FRAMES frames of an utterance, in steps of 64 rows x
// C0_COLS columns. Conv 0 is one k16 wgmma a step: A (row r, tap k ->
// sample s0 r + k, zero past k0) built in registers from the audio, W0 (16
// x 512, taps past k0 zero-filled by TMA) resident in shared memory. The
// epilogue: GN as one FMA per sum, x (rstd gamma) + (beta - mean rstd
// gamma), from the statistics (var = E[x^2] - mean^2), then gelu_pair into
// the stage (the pairs its guard leaves to tanhf made at the end of the
// step), stored by TMA through a (C, T0, B) map that clips rows past T0.
__global__ void __launch_bounds__(128, 7)
conv0_gelu_kernel(const __grid_constant__ CUtensorMap map_w0,
                  const __grid_constant__ CUtensorMap map_out,
                  const bf16* __restrict__ audio, First f,
                  unsigned long long* __restrict__ guarded) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned, indexed from the shared array so that its loads
  // and stores stay shared ones
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + C0_BAR);
  float4* gn = reinterpret_cast<float4*>(sm + C0_GN);
  const int row0 = blockIdx.x * C0_FRAMES, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool lead = threadIdx.x == 0;
  if (lead) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(smem_addr(bar), (C / 64) * W0_BOX);
    for (int n = 0; n < C / 64; ++n)
      tma_load(sm + n * W0_BOX, &map_w0, 64 * n, 0, smem_addr(bar));
  }
  // A of each row group: register h + 2 kk holds row g + 8 h of the warp's
  // 16, taps 2t + 8 kk and 2t + 8 kk + 1 (the low half)
  const bf16* src = audio + b * f.S;
  auto sample = [&](int r, int k) -> uint32_t {
    return r < f.T0 && k < f.k0
               ? __bfloat16_as_ushort(src[static_cast<long long>(f.s0) * r + k])
               : 0u;
  };
  uint32_t a[C0_FRAMES / 64][4];
#pragma unroll
  for (int rg = 0; rg < C0_FRAMES / 64; ++rg)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r = row0 + 64 * rg + 16 * warp + g + 8 * h;
        const int k = 2 * t + 8 * kk;
        a[rg][h + 2 * kk] = sample(r, k) | sample(r, k + 1) << 16;
      }
  // The GroupNorm of each channel pair (2i, 2i + 1): (scale 2i, scale
  // 2i + 1, shift 2i, shift 2i + 1)
  const float frames = static_cast<float>(f.T0);
  for (int i = threadIdx.x; i < C / 2; i += 128) {
    float sc[2], sh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 2 * i + e;
      const float* sums = f.sums + b * 2 * C + c;
      const float mean = sums[0] / frames;
      const float rstd = rsqrtf(sums[C] / frames - mean * mean + GN_EPS);
      sc[e] = rstd * f.gamma[c];
      sh[e] = f.beta[c] - mean * sc[e];
    }
    gn[i] = make_float4(sc[0], sc[1], sh[0], sh[1]);
  }
  __syncthreads();
  mbar_wait(smem_addr(bar), 0);

  const uint32_t w0_addr = smem_addr(sm);
  const int at = (16 * warp + g) * 128 + 4 * t;
  float acc[C0_COLS / 2];
  unsigned taken = 0;     // the lane's outputs by tanhf
#pragma unroll
  for (int rg = 0; rg < C0_FRAMES / 64; ++rg) {
    const int row = row0 + 64 * rg;
    if (row >= f.T0) break;
    // bit 2j + h of `bad` below is row r + 8h: rows past T0, which the TMA
    // store clips, take no tanhf and are not counted
    const int r = row + 16 * warp + g;
    const uint32_t live = (r < f.T0 ? 0x55555555u : 0u) |
                          (r + 8 < f.T0 ? 0xaaaaaaaau : 0u);
#pragma unroll 1
    for (int q = 0; q < C / C0_COLS; ++q) {
      // conv 0 of rows row .. row + 63, columns C0_COLS q ..
      wgmma_fence();
      wgmma_rs<C0_COLS>(
          acc, a[rg],
          sw128_desc(w0_addr + C0_BOXES * q * W0_BOX, W0_BOX, 1024), false);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      // The last step's stores have read the stage (one stage, so that 7
      // blocks fit an SM: two, 5 blocks, measured slower)
      unsigned char* stage = sm + C0_OUT;
      if (lead) bulk_wait_read();
      __syncthreads();
      uint32_t bad = 0;   // bit 2j + h: pair (j, h) left to tanhf
#pragma unroll
      for (int j = 0; j < C0_COLS / 8; ++j) {
        const float4 n = gn[C0_COLS / 2 * q + 4 * j + t];
        const int word_at = (j / 8) * BOX + at + (((j % 8) ^ g) << 4);
        uint32_t unsafe_top, unsafe_low;
        uint32_t top = gelu_pair(fmaf(acc[4 * j], n.x, n.z),
                                 fmaf(acc[4 * j + 1], n.y, n.w), unsafe_top);
        uint32_t low = gelu_pair(fmaf(acc[4 * j + 2], n.x, n.z),
                                 fmaf(acc[4 * j + 3], n.y, n.w), unsafe_low);
        if (!CONV0_LIVE) top = low = 0u;
        *reinterpret_cast<uint32_t*>(stage + word_at) = top;
        *reinterpret_cast<uint32_t*>(stage + word_at + 8 * 128) = low;
        bad |= (unsafe_top ? 1u << 2 * j : 0u) |
               (unsafe_low ? 2u << 2 * j : 0u);
      }
      bad &= live;
      // The pairs left to tanhf, a lane its own after the unrolled loop
      // (inline copies of tanhf in it, or a queue that branches a pair,
      // measured slower: PERF.md §6)
      if (CONV0_LIVE) {
        while (bad) {
          const int bit = __ffs(bad) - 1, j = bit >> 1, h = bit & 1;
          bad &= bad - 1;
          const float4 v = sums_of<0, C0_COLS / 8>(acc, j);
          const float4 n = gn[C0_COLS / 2 * q + 4 * j + t];
          *reinterpret_cast<uint32_t*>(
              stage + (j / 8) * BOX + at + (((j % 8) ^ g) << 4) +
              h * 8 * 128) =
              pack_bf16(ppgs::gelu_tanh(fmaf(h ? v.z : v.x, n.x, n.z)),
                        ppgs::gelu_tanh(fmaf(h ? v.w : v.y, n.y, n.w)));
          taken += 2;
        }
      }
      // This step's stores go while the next step's product runs
      fence_async_smem();
      __syncthreads();
      if (lead) {
        for (int n = 0; n < C0_BOXES; ++n)
          tma_store_3d(&map_out, C0_COLS * q + 64 * n, row, b,
                       stage + n * BOX);
        bulk_commit();
      }
    }
  }
  if (lead) bulk_wait_read();
  if (guarded) {
    taken = __reduce_add_sync(0xffffffffu, taken);
    if (lane == 0 && taken) atomicAdd(guarded, taken);
  }
}

}  // namespace

// audio (B, S) bf16, w0 (k0, 512) bf16, k0 <= 16; T0 = (S - k0) / s0 + 1
// conv-0 frames in tiles = ceil(T0 / stats_frames(s0)) blocks per
// utterance (the caller's plan, ops/conv_stack.py conv_stats_plan; another
// value is refused); partial (B, tiles, 272) fp64 scratch; tickets (B)
// zeroed uint32 (left zeroed) -> sums (B, 2, 512) fp32: each channel's sum
// and sum of squares of conv 0 over all T0 frames.
extern "C" int ppgs_conv_stats(const void* audio, long long S, const void* w0,
                               int k0, int s0, int T0, int B, int tiles,
                               void* partial, void* sums, void* tickets,
                               void* stream) {
  if (k0 > MAX_K0 || k0 < 1 || s0 < 1 || T0 < 0 || B < 0 ||
      tiles != (T0 + stats_frames(s0) - 1) / stats_frames(s0) ||
      (T0 > 0 && static_cast<long long>(s0) * (T0 - 1) + k0 > S))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && T0 > 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        conv_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        STATS_SAMPLES * 2 + 16);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int smem = (s0 * (stats_frames(s0) - 1) + MAX_K0) * 2 + 16;
    conv_stats_kernel<<<dim3(tiles, B), STATS_WARPS * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(audio), S, static_cast<const bf16*>(w0), k0,
        s0, T0, tiles, static_cast<double*>(partial),
        static_cast<float*>(sums), static_cast<unsigned*>(tickets));
  }
  return static_cast<int>(cudaGetLastError());
}

// conv 1's input: act (B, T0, 512) bf16 = bf16(gelu(GroupNorm(conv 0)))
// of the bf16 audio (B, S), conv 0 with w0 (k0, 512) bf16 (k0 <= 16) and
// stride s0 (T0 = (S - k0) / s0 + 1 frames), normalised with sums (from
// ppgs_conv_stats), gamma and beta (512) fp32; act and w0 16-byte
// aligned. tiles and window: the caller's plan (ops/conv_stack.py
// conv0_gelu_plan), ceil(T0 / 128) blocks an utterance and s0 * 127 + k0
// samples a block; any other values are refused. guarded: null, or an
// int64 to which the outputs whose GELU took tanhf (the guard) are added.
extern "C" int ppgs_conv0_gelu(const void* audio, long long S, const void* w0,
                               int k0, int s0, int T0, int B, int tiles,
                               int window, const void* sums,
                               const void* gamma, const void* beta,
                               void* act, void* guarded, void* stream) {
  if (k0 < 1 || k0 > MAX_K0 || s0 < 1 || T0 < 0 || B < 0 ||
      tiles != (T0 + C0_FRAMES - 1) / C0_FRAMES ||
      window != s0 * (C0_FRAMES - 1) + k0 ||
      (T0 > 0 && static_cast<long long>(s0) * (T0 - 1) + k0 > S))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T0 == 0) return static_cast<int>(cudaGetLastError());
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv0_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C0_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap mw, mo;
  if (!encode(&mw, w0, false, k0, C, C, 64, 16) ||
      !encode_3d(&mo, act, C, T0, B, C, static_cast<long long>(T0) * C, 64,
                 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const First f{static_cast<const float*>(sums),
                static_cast<const float*>(gamma),
                static_cast<const float*>(beta), k0, s0, T0, S};
  conv0_gelu_kernel<<<dim3(tiles, B), 128, C0_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      mw, mo, static_cast<const bf16*>(audio), f,
      static_cast<unsigned long long*>(guarded));
  return static_cast<int>(cudaGetLastError());
}

// One strided conv with GELU: out (B, T_out, 512) bf16 = bf16(gelu(x * w))
// with x (B, T_in, 512) bf16, x_batch = T_in * 512, w (k*512, 512) bf16
// (the (k, C_in, C_out) weight), k <= 3, stride s and s * (T_out - 1) + k
// <= T_in; every pointer 16-byte aligned. tiles and blocks: the caller's
// plan (ops/conv_stack.py conv_gelu_plan), ceil(T_out / 128) row tiles an
// utterance and 2 * tiles * B blocks; any other values are refused.
extern "C" int ppgs_conv_gelu(const void* x, long long x_batch, const void* w,
                              int k, int s, int T_out, int B, int tiles,
                              int blocks, void* out, void* stream) {
  if (k < 1 || k > MAX_K || s < 1 || T_out < 0 || B < 0 ||
      tiles != (T_out + BM - 1) / BM || blocks != 2 * tiles * B)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T_out == 0) return static_cast<int>(cudaGetLastError());
  if (x_batch < (static_cast<long long>(s) * (T_out - 1) + k) * C)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PLAIN_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // Tap j of row t: input row s t + j, a map of its own
  CUtensorMap ma[MAX_K], mw, mo;
  for (int j = 0; j < MAX_K; ++j)
    if (!encode_3d(&ma[j], static_cast<const bf16*>(x) + (j < k ? j : 0) * C,
                   C, T_out, B, static_cast<long long>(s) * C, x_batch, BK,
                   BM))
      return static_cast<int>(cudaErrorInvalidValue);
  if (!encode(&mw, w, false, static_cast<long long>(k) * C, C, C, 64, BK) ||
      !encode_3d(&mo, out, C, T_out, B, C, static_cast<long long>(T_out) * C,
                 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  conv_gelu_kernel<<<blocks, 288, PLAIN_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(
      ma[0], ma[1], ma[2], mw, mo, k, T_out, tiles);
  return static_cast<int>(cudaGetLastError());
}
