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
// - conv_stats_kernel: one block per (256 conv-0 frames, utterance), one
//   thread per channel; conv 0 (k0 <= 16 taps) in fp32 on the CUDA cores
//   from the bf16 audio in shared memory; per-block partial sums, and the
//   last block of an utterance (an atomic ticket) adds the partials in
//   tile order, so the statistics are the same from run to run.
// - conv0_gelu_kernel: conv 1's input, bf16(gelu(GN(conv 0))), to device
//   memory (1.68 GB at 64 x 8 s; the library path stores it too): a block
//   per 128 frames of an utterance, a thread per pair of channels, conv 0
//   by FMAs from a sliding window of samples in registers.
// - conv_gelu_kernel: one strided conv as an implicit GEMM on wgmma + TMA
//   (hopper.cuh), GELU and the bf16 rounding in its epilogue. For a
//   row-major (T_in, C) input the taps of output row t are input rows
//   s*t .. s*t + k - 1, so the conv is a product of depth k*C against the
//   JAX weight (k, C_in, C_out) read as (k*C_in, C_out). Convs 1-6 all
//   take it; conv 1 (the first form) on conv0_gelu's output.
//
// Rounding follows the TPU kernel: the audio and the weights are bf16,
// products accumulate in fp32, the GroupNorm is fp32 with var = E[x^2] -
// mean^2 from the statistics pass, GELU is fp32 (conv 1's input by tanhf,
// each conv's output by an ex2/rcp form of the same function, gelu_out),
// and every conv output is rounded to bf16.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s) at 64 x 8 s (128,080
// samples), every conv by operations: conv 1 1.29 TFLOP (conv 0 adds 17
// GFLOP), 1.3205 ms; conv 2 0.6517; convs 3-6 0.326, 0.163, 0.054, 0.027.
// The bytes (the audio in, each conv's bf16 input and output once) come to
// ~0.4 ms for the chain; conv0_gelu's 1.68 GB out take 0.50 ms more.
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

constexpr int STATS_FRAMES = 256;      // conv-0 frames per stats block

__global__ void __launch_bounds__(C)
conv_stats_kernel(const bf16* __restrict__ audio, long long S,
                  const bf16* __restrict__ w0, int k0, int s0, int T0,
                  int tiles, float* __restrict__ partial,
                  float* __restrict__ sums, unsigned* __restrict__ tickets) {
  extern __shared__ float s_audio[];
  __shared__ bool last;
  const int tile = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const int f0 = tile * STATS_FRAMES;
  const int nf = min(STATS_FRAMES, T0 - f0);
  const long long a0 = (long long)s0 * f0;
  const int n_samples = s0 * (nf - 1) + k0;
  const bf16* src = audio + b * S + a0;
  for (int i = threadIdx.x; i < n_samples; i += C)
    s_audio[i] = __bfloat162float(src[i]);
  float w[MAX_K0];
#pragma unroll
  for (int p = 0; p < MAX_K0; ++p)
    w[p] = p < k0 ? __bfloat162float(w0[p * C + c]) : 0.f;
  __syncthreads();

  float sum = 0.f, sq = 0.f;
  for (int f = 0; f < nf; ++f) {
    const float* a = s_audio + s0 * f;
    float x = 0.f;
#pragma unroll
    for (int p = 0; p < MAX_K0; ++p)
      if (p < k0) x = fmaf(a[p], w[p], x);
    sum += x;
    sq = fmaf(x, x, sq);
  }
  float* mine = partial + ((long long)b * tiles + tile) * 2 * C;
  mine[c] = sum;
  mine[C + c] = sq;

  // The last block of utterance b adds the partials in tile order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + b, 1u) == tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float total = 0.f, total_sq = 0.f;
  const float* all = partial + (long long)b * tiles * 2 * C;
  for (int t = 0; t < tiles; ++t) {
    total += __ldcg(all + t * 2 * C + c);
    total_sq += __ldcg(all + t * 2 * C + C + c);
  }
  sums[b * 2 * C + c] = total;
  sums[b * 2 * C + C + c] = total_sq;
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
// from tanhf's (PERF.md). Conv 1's input (conv0_gelu_kernel) keeps tanhf:
// there a rounding apart passes through the next conv's sums.
__device__ __forceinline__ float gelu_out(float x) {
  if (!FAST_GELU) return ppgs::gelu_tanh(x);
  constexpr float K0 = -2.f * 1.4426950408889634f * 0.7978845608028654f;
  constexpr float K1 = K0 * 0.044715f;
  return __fdividef(x, 1.f + exp2_approx(x * fmaf(K1, x * x, K0)));
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

constexpr int C0_FRAMES = 128;          // conv-0 frames a block
constexpr int C0_PAD = 16;              // samples read past the window

struct First {            // conv 0 + GroupNorm: conv 1's input
  const bf16* w0;         // (k0, C) bf16
  const float* sums;      // (B, 2, C): sum and sum of squares of conv 0
  const float* gamma;     // (C) GroupNorm scale
  const float* beta;      // (C) GroupNorm shift
  int k0, s0, T0;
  long long S;            // samples per utterance
};

// act (B, T0, C) bf16 = bf16(gelu(GN(conv 0 of the audio))): a block per
// C0_FRAMES frames of an utterance, a thread per pair of channels (a warp
// writes 128 contiguous bytes of a frame); the block's samples in shared
// memory as fp32, conv 0 in fp32 by FMAs in tap order (conv_stats_kernel's
// sums), the GroupNorm and GELU (tanhf) in fp32. For wav2vec2's k0 = 10,
// s0 = 5 a thread keeps a sliding window of samples in registers and
// reads 5 new ones a frame.
template <int K0, int S0>
__device__ __forceinline__ void conv0_frames(const float* win,
                                             const First& f, int ch,
                                             const float (&mean)[2],
                                             const float (&rstd)[2],
                                             const float (&g)[2],
                                             const float (&be)[2], int nf,
                                             bf16* dst) {
  const int k0 = K0 ? K0 : f.k0, s0 = S0 ? S0 : f.s0;
  constexpr int TAPS = K0 ? K0 : MAX_K0;
  float w[2][TAPS];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int q = 0; q < TAPS; ++q)
      w[e][q] = q < k0 ? __bfloat162float(f.w0[q * C + ch + e]) : 0.f;
  auto put = [&](int u, float x0, float x1) {
    *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(u) * C) =
        pack_bf16(ppgs::gelu_tanh((x0 - mean[0]) * rstd[0] * g[0] + be[0]),
                  ppgs::gelu_tanh((x1 - mean[1]) * rstd[1] * g[1] + be[1]));
  };
  if constexpr (K0 == 10 && S0 == 5) {
    // frames u and u + 1 from samples 5u .. 5u + 14
    float x[15];
#pragma unroll
    for (int q = 0; q < 15; ++q) x[q] = win[q];
    for (int u = 0; u < nf; u += 2) {
      float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
      for (int q = 0; q < 10; ++q) {
        a0 = fmaf(x[q], w[0][q], a0);
        a1 = fmaf(x[q], w[1][q], a1);
        b0 = fmaf(x[q + 5], w[0][q], b0);
        b1 = fmaf(x[q + 5], w[1][q], b1);
      }
      put(u, a0, a1);
      if (u + 1 < nf) put(u + 1, b0, b1);
#pragma unroll
      for (int q = 0; q < 5; ++q) x[q] = x[q + 10];
#pragma unroll
      for (int q = 0; q < 10; ++q) x[q + 5] = win[5 * u + 15 + q];
    }
  } else {
    for (int u = 0; u < nf; ++u) {
      const float* a = win + s0 * u;
      float x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int q = 0; q < TAPS; ++q)
        if (q < k0) {
          x0 = fmaf(a[q], w[0][q], x0);
          x1 = fmaf(a[q], w[1][q], x1);
        }
      put(u, x0, x1);
    }
  }
}

__global__ void __launch_bounds__(C / 2)
conv0_gelu_kernel(const bf16* __restrict__ audio, First f,
                  bf16* __restrict__ act) {
  extern __shared__ float win[];
  const int f0 = blockIdx.x * C0_FRAMES, b = blockIdx.y;
  const int ch = 2 * threadIdx.x;
  const int nf = min(C0_FRAMES, f.T0 - f0);
  const long long a0 = static_cast<long long>(f.s0) * f0;
  const int n = f.s0 * (nf - 1) + f.k0 + C0_PAD;
  const bf16* src = audio + b * f.S;
  for (int i = threadIdx.x; i < n; i += C / 2)
    win[i] = a0 + i < f.S ? __bfloat162float(src[a0 + i]) : 0.f;
  // Per-channel GroupNorm from the statistics (groups = channels)
  float mean[2], rstd[2], g[2], be[2];
  const float frames = static_cast<float>(f.T0);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float* sums = f.sums + b * 2 * C + ch + e;
    mean[e] = sums[0] / frames;
    rstd[e] = rsqrtf(sums[C] / frames - mean[e] * mean[e] + GN_EPS);
    g[e] = f.gamma[ch + e];
    be[e] = f.beta[ch + e];
  }
  __syncthreads();
  bf16* dst = act + (static_cast<long long>(b) * f.T0 + f0) * C + ch;
  if (f.k0 == 10 && f.s0 == 5)
    conv0_frames<10, 5>(win, f, ch, mean, rstd, g, be, nf, dst);
  else
    conv0_frames<0, 0>(win, f, ch, mean, rstd, g, be, nf, dst);
}

}  // namespace

// audio (B, S) bf16, w0 (k0, 512) bf16, k0 <= 16; T0 = (S - k0) / s0 + 1
// conv-0 frames in tiles = ceil(T0 / 256) blocks per utterance; partial
// (B, tiles, 2, 512) fp32 scratch; tickets (B) zeroed uint32 (left zeroed)
// -> sums (B, 2, 512) fp32: each channel's sum and sum of squares of conv
// 0 over all T0 frames.
extern "C" int ppgs_conv_stats(const void* audio, long long S, const void* w0,
                               int k0, int s0, int T0, int B, void* partial,
                               void* sums, void* tickets, void* stream) {
  if (k0 > MAX_K0 || k0 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && T0 > 0) {
    const int tiles = (T0 + STATS_FRAMES - 1) / STATS_FRAMES;
    const int smem = (s0 * (STATS_FRAMES - 1) + k0) * 4;
    conv_stats_kernel<<<dim3(tiles, B), C, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(audio), S, static_cast<const bf16*>(w0), k0,
        s0, T0, tiles, static_cast<float*>(partial), static_cast<float*>(sums),
        static_cast<unsigned*>(tickets));
  }
  return static_cast<int>(cudaGetLastError());
}

// conv 1's input: act (B, T0, 512) bf16 = bf16(gelu(GroupNorm(conv 0)))
// of the bf16 audio (B, S), conv 0 with w0 (k0, 512) bf16 (k0 <= 16) and
// stride s0 (T0 = (S - k0) / s0 + 1 frames), normalised with sums (from
// ppgs_conv_stats), gamma and beta (512) fp32. tiles and window: the
// caller's plan (ops/conv_stack.py conv0_gelu_plan), ceil(T0 / 128) blocks
// an utterance and s0 * 127 + k0 samples a block; any other values, or a
// window past the shared memory, are refused.
extern "C" int ppgs_conv0_gelu(const void* audio, long long S, const void* w0,
                               int k0, int s0, int T0, int B, int tiles,
                               int window, const void* sums,
                               const void* gamma, const void* beta,
                               void* act, void* stream) {
  const int smem = (window + C0_PAD) * 4;
  if (k0 < 1 || k0 > MAX_K0 || s0 < 1 || T0 < 0 || B < 0 ||
      tiles != (T0 + C0_FRAMES - 1) / C0_FRAMES ||
      window != s0 * (C0_FRAMES - 1) + k0 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && T0 > 0) {
    const First f{static_cast<const bf16*>(w0),
                  static_cast<const float*>(sums),
                  static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), k0, s0, T0, S};
    conv0_gelu_kernel<<<dim3(tiles, B), C / 2, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(audio), f, static_cast<bf16*>(act));
  }
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
