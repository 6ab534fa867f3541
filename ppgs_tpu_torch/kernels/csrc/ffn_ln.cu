// K4 ffn_residual_ln: out = LN2(res + drop_y(drop_h(act(bf16(x) @ W1 + b1))
// @ W2 + b2)), with ReLU or the tanh-approximate GELU at any C % 128 == 0
// from 128 to 2048 and any F % 128 == 0 (the train forms, with the
// dropout on or the normalised rows saved, at every such C with ReLU);
// and, for an FFN that ends without the LayerNorm (the same widths, ReLU),
// y = drop_y(drop_h(relu(x @ W1 + b1)) @ W2 + b2) in bf16.
//
// Replaces four TPU kernels' FFNs, which differ in their rounding points:
// - the FFN half of ppgs_tpu/ops/encoder_layer_kernel.py _layer_body
//   (round_input = 0): h = act(bf16(bf16(x@W1) + bf16(b1))), and the
//   residual res is the fp32 x; act is ReLU for the PPG transformer
//   (encoder_stack; C = 256 mel, C = 512 w2v2fb, and C = 768, a width the
//   JAX package's kernels take that no registered config has) and GELU
//   for the wav2vec2 trunk (encoder_stack_streamed, activation='gelu', C
//   = 768, F = 3072);
// - ppgs_tpu/ops/fused_ffn.py _kernel (ffn_residual_layernorm,
//   round_input = 1): h = bf16(relu(x@W1 + b1)) in fp32, and the residual
//   is x rounded to bf16, since that kernel takes a bf16 x (the per-layer
//   path past 1024 frames: C = 256 mel, C = 512 w2v2fb, C = 768);
// - the FFN half of ppgs_tpu/ops/encoder_layer_train.py _fwd_compute
//   (round_input = 0, the dropout sites on): hd = keep_h ? bf16(h *
//   bf16(1 / (1 - rate))) : 0, y0 = fp32 dot + fp32 b2, out = LN2(x +
//   (keep_y ? y0 / (1 - rate) : 0)), saving the normalised rows and 1/std
//   for the backward;
// - ppgs_tpu/ops/fused_ffn.py ffn_train's forward (bf16 x, y_out): the same
//   hd, y = bf16(bf16(dot) + bf16(b2)), and the output
//   keep_y ? bf16(y * bf16(1 / (1 - rate))) : 0 in bf16, no LayerNorm.
// Products take bf16 operands and accumulate in fp32; LN statistics fp32.
// The dropout masks are the Philox stream of philox.cuh, keyed by the flat
// index of the element, so they do not depend on the tiling.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 4 M C F operations, so
// every width is bound by the tensor cores: the mel shape (M = 64,000,
// C = 256, F = 2048) 134 GFLOP, ~0.136 ms; the w2v2fb head (C = 512) 268
// GFLOP, ~0.27 ms; the wav2vec2 trunk (M = 25,600, C = 768, F = 3072) 242
// GFLOP, ~0.24 ms; the training shape (M = 131,072) 275 GFLOP, ~0.28 ms,
// and at the w2v2fb head's width (C = 512) 550 GFLOP, ~0.56 ms; C = 768
// with ReLU (F = 2048) 403 GFLOP at the mel shape, ~0.41 ms, and 825 GFLOP
// at the training shape, ~0.83 ms; wav2vec2-large's trunk (M = 25,600, C =
// 1024, F = 4096, GELU) 429 GFLOP, ~0.43 ms.
//
// Design, on the wgmma + TMA building blocks of hopper.cuh (as gemm.cu): a
// producer (a warpgroup of its own, or at C = 256 one consumer thread)
// keeps a ring of stages in flight with TMA (128-byte swizzle, full and
// empty mbarriers); two consumer warpgroups each own 64 rows of a 128-row
// block and issue wgmma.mma_async with fp32 accumulators in registers.
// What decides the form is the (rows x C) fp32
// sum of the second product, which a kernel that keeps the hidden on chip
// holds in registers for its whole walk over F:
// - C = 256 with ReLU, one kernel (ffn_fused_kernel): 128 rows fit, 128
//   accumulator registers a consumer thread, beside the hidden chunk's 32
//   and its 16 bf16 fragments; see the kernel's note. Every weight byte
//   brought on chip serves the block's 128 rows, and the hidden never
//   leaves the SM.
// - every other (C, act), C = 128 and 384 to 2048, two launches: 128 rows
//   of C = 512 or 768 would need 256 KB or 384 KB of sum against the SM's
//   256 KB of registers, so a fused block could own
//   only 64 rows (a weight byte serving 64 rows unless a cluster
//   multicast each stage) and would have to share each hidden chunk
//   between warpgroups through shared memory. Instead:
//   1. ffn_hidden_kernel: h = drop_h(act(x W1 + b1)) in bf16, (M, F), a
//      128 x 256 tile a block (128 x 128 where F % 256 != 0); an fp32 x is
//      TMA'd as it is, and each consumer thread reads its m64k16 fragment
//      from the swizzled tile and rounds it to bf16 (the RS form); a bf16
//      x (ffn_train's form) is the SS form's K-major A; W1 as stored
//      (MN-major). Bias, activation, dropout and the rounding are applied
//      to the accumulators in registers. x streams through the ring with
//      W1 (C / 64 depth steps), so no C is too wide for it; at C = 2048 a
//      tile re-reads its 128 rows of x from L2 once for each 256 columns
//      of F. The train forms at C = 512 (the hidden's keep words written)
//      take hidden_train_kernel instead, below.
//   2. ffn_out_kernel: y = h W2 + b2 on 128 x 256 tiles (h K-major, W2
//      MN-major), then either ffn_train's bf16 y (y_out, no LayerNorm: a
//      block a tile, the last 128 columns wide where C % 256 == 128) or
//      the residual, drop_y and the LayerNorm from the
//      accumulators. A row spans ceil(C / 256) blocks: they are one
//      thread-block cluster along C and trade each row's partial sums
//      (the sum, then the centred sum of squares) through distributed
//      shared memory, each adding the ranks' sums in rank order, so that
//      every block normalises with the same mean and 1/std. Where C % 256
//      == 128 the last block's tile has 128 columns (residual_ln.cuh: W2's
//      two boxes past C are not loaded, their sums kept at 0 and
//      unstored), in instances of their own (NARROW for inference and
//      y_out, NARROW_TRAIN with the dropout and the saved rows in that
//      tile's copy of the epilogue).
//      At C = 128 the cluster is that one block: the fused
//      kernel's 256 columns are its template's (and its activation ReLU),
//      and the two launches take any C.
//   Both launches use 128-row tiles, so every weight byte brought on chip
//   serves 128 rows; the hidden's round trip through memory costs 2 M F x
//   2 bytes, 0.16 ms at the w2v2fb head's shape and 0.09 ms at the
//   trunk's on 3.35 TB/s, against the products' 0.24-0.27 ms bound.
// The dropout masks: a Philox draw covers 4 consecutive columns, and the
// accumulator layout gives a thread 2 adjacent columns of each 8-column
// group for two rows (g and g + 8), so lanes t and t ^ 1 share a group:
// each draws the group of its own row (g for even t, g + 8 for odd) and
// they trade the two words the other needs, one draw per 4 elements. The
// train forms (C = 256 in the fused kernel, every other C in the
// hidden's launch) also write the hidden's keep bits for the backward
// (ffn_train.cu), which then draws none: int32 words of shape (M, F / 32),
// bit k of word w for column 32 w + k; in the fused kernel and in
// ffn_hidden_kernel a quad's four lanes OR their bits into a row's words
// and each stores one (their WORDS instances; the inference instances are
// compiled without it). At every C but 256 and 512 the train forms'
// hidden launch is ffn_hidden_kernel, the inference instance's form with
// the words written, x streamed over C / 64 depth steps: the persistent
// hidden_train_kernel below holds a row block's x resident, 192 KB at 768
// of a block's 227, which would leave no room for its ring; a right-first
// form, not yet timed against another.
//
// The C = 512 train forms' hidden launch (hidden_train_kernel; fp32 x with
// the LayerNorm's launch after it, B4's form, or bf16 x with the y_out
// launch, ffn_train's). What the probes showed of the two-launch form
// (scripts/torch_ffn_fwd_probe.py on an H100, the training shape 131,072
// x 512, F = 2048): its hidden launch took 1.19-1.32 ms, of which a walk
// without the epilogue took 0.37-0.47 and the Philox draws, issued in the
// epilogue after the products, 0.28; every 128 x 256 tile fetched its x
// again (8 times a row block) beside W1, and nothing overlapped a tile's
// epilogue. The design here:
// - a persistent grid (a block an SM) walks units of 128 rows x 128
//   hidden columns in contiguous ranges, row block by row block (K1's
//   walk, qkv_proj.cu): a row block's x is staged once, rounded to bf16,
//   into 128 KB of resident slabs (the RS form's bits: the same bf16
//   values in the same k16 order), and W1 streams past it in 16 KB items
//   through a ring of four slots, kept full by a producer warp;
// - two consumer warpgroups (64 rows each) issue SS m64n128k16 products
//   from the resident x; the epilogue stages the unit's h in two swizzled
//   boxes a warpgroup and writes them by TMA stores, which drain while the
//   next unit's products run;
// - the keep bits are drawn by three warps of their own (the producer's
//   warpgroup), a unit ahead of the consumers: 8 Philox calls a word, two
//   words in flight a thread, stored straight into the keep words; a
//   consumer reads its rows' four words of a unit before the unit's
//   products (they arrive meanwhile). A pair of barriers keeps the draws
//   at most a unit ahead.
// Every output (h, the keep words, and through the output launch out, the
// normalised rows and 1/std or y_out) is the two-launch form's bit for
// bit. The probe's variants of this kernel: a loads-only walk (LIVE: no
// products, no draws) 0.37-0.41 ms, a walk without the draws (PHILOX)
// 0.55-0.61, without the epilogue (EPILOGUE) about the draws' time; the
// whole 0.85-0.99. The draws add about 0.3 ms wherever they run, as they
// did in the epilogue: the multiplies of Philox and the products' walk
// do not overlap on this card. Tried and dropped (each timed against
// this form in one call): the draws inside the main loop between a step's
// products and its wait (0.92-0.95 ms), setmaxnreg for the consumers
// (ptxas keeps the launch's 168-register cap for all code), seven draw
// warps in a fourth warpgroup (0.85-0.90, with 300 bytes of spills at 128
// registers), a Philox group a thread with shuffles in place of words
// (1.05), h staged in the ring's last two slots so that the ring holds
// six (0.95: the stream is no faster with more slots in flight), and W1
// shared by a two-block cluster through TMA multicast (0.93-0.99).
// The output launch keeps PR 7's form. Its B4 form takes 0.84-0.90 ms, of
// which the LayerNorm epilogue, run in lockstep waves at one block an SM,
// is 0.62 (a walk without it 0.25; without the residual reads 0.78,
// without the normalised rows' stores 0.74, without the output dropout's
// draws 0.85). Tried and dropped: the residual brought by TMA into the
// slots that the last depth steps free, and out and then n written over
// it and stored by TMA, so that a block's writes drain behind the next
// block's products (0.96 ms; 1.14 with the per-pair addresses kept in
// registers, 750 bytes of spills); and, for the y_out form, y staged in
// the idle ring and stored by TMA (no faster: 0.50).
// Rows past M: TMA fills zeros, and no row >= M is written.

#include <type_traits>

#include "residual_ln.cuh"

using ppgs::bf16;
using namespace ppgs::hopper;
using namespace ppgs::residual_ln;

namespace {

constexpr int THREADS = 384;              // producer warpgroup + 2 consumers
// The probes' switches (scripts/torch_ffn_fwd_probe.py): the new
// hidden launch's products, both launches' epilogues, the keep bits' draws
constexpr bool LIVE = true;
constexpr bool EPILOGUE = true;
constexpr bool PHILOX = true;
enum Act { RELU = 0, GELU = 1 };

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  return ACT == GELU ? ppgs::gelu_tanh(v) : fmaxf(v, 0.f);
}

// Store a thread's bf16 pairs (r0, col..col+1) and (r1, col..col+1) with
// 8-byte stores: lanes t and t ^ 1 trade halves so that an even t holds 4
// columns of row r0, an odd t 4 columns of row r1
__device__ __forceinline__ void store_bf16(bf16* out, long long ld,
                                           long long r0, long long r1,
                                           int col, int t, uint32_t u0,
                                           uint32_t u1, int M) {
  const uint32_t got = __shfl_xor_sync(0xffffffffu, (t & 1) ? u0 : u1, 1);
  const long long row = (t & 1) ? r1 : r0;
  if (row < M) {
    const uint2 o = (t & 1) ? make_uint2(got, u1) : make_uint2(u0, got);
    *reinterpret_cast<uint2*>(out + row * ld + col - 2 * (t & 1)) = o;
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 pair(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}

// Zero the halves of a bf16 pair whose keep bit is off
__device__ __forceinline__ uint32_t keep_pair(uint32_t p, bool k0, bool k1) {
  return p & ((k0 ? 0x0000FFFFu : 0u) | (k1 ? 0xFFFF0000u : 0u));
}

// The hidden's bias, activation, dropout and bf16 rounding on a thread's
// four accumulators of 8-column group c8 of the (rows, F) hidden (v[e]:
// row r0 or r1 by e / 2, column c8 + 2t + e % 2; bias: b1 at those two
// columns; keep: their keep bits, keep4's), returned as the bf16 pairs of
// rows r0 (p0) and r1 (p1). With
// ROUND = 0 (round_input 0) the sum is bf16(bf16(acc) + bf16(b1)): one
// bf16x2 add of the rounded pairs, exactly that; ReLU and the dropout
// scale (bf16 times bf16, rounded) stay in bf16x2 too, so that a pair costs
// one conversion. GELU, and ROUND = 1, work in fp32 and round once at the
// end.
template <int ACT, bool ROUND>
__device__ __forceinline__ void hidden4(uint32_t& p0, uint32_t& p1,
                                        const float (&v)[4], float2 bias,
                                        const bool (&keep)[4],
                                        const ppgs::Dropout& drop) {
  if constexpr (ACT == RELU && !ROUND) {
    const __nv_bfloat162 b = pair(bias.x, bias.y), zero = pair(0.f, 0.f);
    __nv_bfloat162 h0 = __hmax2(__hadd2(pair(v[0], v[1]), b), zero);
    __nv_bfloat162 h1 = __hmax2(__hadd2(pair(v[2], v[3]), b), zero);
    if (drop.threshold) {
      const float sc = ppgs::round_bf16(drop.scale);
      h0 = __hmul2(h0, pair(sc, sc));
      h1 = __hmul2(h1, pair(sc, sc));
    }
    p0 = keep_pair(bits(h0), keep[0], keep[1]);
    p1 = keep_pair(bits(h1), keep[2], keep[3]);
    return;
  }
  float w[4];
  if constexpr (ROUND) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = activate<ACT>(v[e] + ((e & 1) ? bias.y : bias.x));
  } else {
    const __nv_bfloat162 b = pair(bias.x, bias.y);
    const float2 s0 = __bfloat1622float2(__hadd2(pair(v[0], v[1]), b));
    const float2 s1 = __bfloat1622float2(__hadd2(pair(v[2], v[3]), b));
    w[0] = activate<ACT>(s0.x), w[1] = activate<ACT>(s0.y);
    w[2] = activate<ACT>(s1.x), w[3] = activate<ACT>(s1.y);
  }
  if (drop.threshold) {
    const float sc = ppgs::round_bf16(drop.scale);
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] *= sc;
  }
  p0 = keep_pair(bits(pair(w[0], w[1])), keep[0], keep[1]);
  p1 = keep_pair(bits(pair(w[2], w[3])), keep[2], keep[3]);
}

// Add the keep bits of a thread's 8-column group j of a 64-column chunk
// to its rows' two words (w[0]: row r0, w[1]: row r1)
__device__ __forceinline__ void add_keep_bits(uint32_t (&w)[2][2], int j,
                                              int t, const bool (&keep)[4]) {
  const int shift = 8 * (j % 4) + 2 * t;
  w[0][j / 4] |= (uint32_t(keep[0]) | uint32_t(keep[1]) << 1) << shift;
  w[1][j / 4] |= (uint32_t(keep[2]) | uint32_t(keep[3]) << 1) << shift;
}

// A 64-column chunk's keep words of rows r0 and r1 (w from
// add_keep_bits), ORed over the quad; lane t stores word t % 2 of row r0
// (t < 2) or r1 at column word `word0` of the (M, F / 32) words
__device__ __forceinline__ void store_keep_words(uint32_t (&w)[2][2],
                                                 uint32_t* words, long long r0,
                                                 long long r1, int M, int F,
                                                 int word0, int t) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t& u = w[e / 2][e % 2];
    u |= __shfl_xor_sync(0xffffffffu, u, 1);
    u |= __shfl_xor_sync(0xffffffffu, u, 2);
  }
  const long long row = t < 2 ? r0 : r1;
  const uint32_t word = t == 0 ? w[0][0] : t == 1 ? w[0][1]
                      : t == 2 ? w[1][0] : w[1][1];
  if (row < M) words[row * (F / 32) + word0 + (t % 2)] = word;
}

// The y_out form's epilogue: drop_y(bf16(bf16(acc) + bf16(b2))) in bf16
// (a bf16x2 add of the rounded pairs; the dropout scale in bf16x2), on the
// tile's first `groups` 8-column groups (a literal in each caller's copy)
__device__ __forceinline__ void store_y_out(const float (&acc)[128],
                                            const float* b2, bf16* y_out,
                                            int M, int C, int n0,
                                            long long r0, long long r1, int t,
                                            const ppgs::Dropout& drop,
                                            int groups = 32) {
  const float sc = ppgs::round_bf16(drop.scale);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j >= groups) continue;
    const int col = n0 + 8 * j + 2 * t;
    const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
    const __nv_bfloat162 b = pair(bias.x, bias.y);
    __nv_bfloat162 y0 = __hadd2(pair(acc[4 * j], acc[4 * j + 1]), b);
    __nv_bfloat162 y1 = __hadd2(pair(acc[4 * j + 2], acc[4 * j + 3]), b);
    bool keep[4] = {true, true, true, true};
    if (drop.threshold) {
      keep4(drop, r0, r1, C, n0 + 8 * j, t, keep);
      y0 = __hmul2(y0, pair(sc, sc));
      y1 = __hmul2(y1, pair(sc, sc));
    }
    store_bf16(y_out, C, r0, r1, col, t, keep_pair(bits(y0), keep[0], keep[1]),
               keep_pair(bits(y1), keep[2], keep[3]), M);
  }
}

// Every C but 256, launch 1 of the inference forms (and of the train
// forms at rate 0, and at every C but 512 at any rate): h (M, F) bf16 =
// drop_h(act(x W1 + b1)), a BM x BN tile a block; X_F32: x fp32 (rounded
// in the RS form), else bf16; WORDS: the hidden's keep words written to
// `words` too
template <int BN, int ACT, bool ROUND, bool X_F32, bool WORDS = false>
__global__ void __launch_bounds__(THREADS, 1)
ffn_hidden_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w1,
                  const float* __restrict__ b1, bf16* __restrict__ h,
                  uint32_t* __restrict__ words, int M, int F, int C,
                  ppgs::Dropout drop) {
  using R = Ring<X_F32, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_ring(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) mbar_init_ring(full, empty, R::STAGES, 8);
  __syncthreads();
  if (wg == 0) {
    if (threadIdx.x == 0)
      produce<X_F32, BN>(&map_x, &map_w1, ring, full, empty, C / BK, m0,
                         n0);
    return;
  }
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[BN / 2];
  consume<X_F32, BN>(acc, ring, full, empty, C / BK, c, warp, lane);

  // Register 4j + e holds row g + 8 (e / 2) of the warp's 16, column
  // 8j + 2t + e % 2 of the tile
  const int g = lane >> 2, t = lane & 3;
  const long long r0 = m0 + 64 * c + 16 * warp + g, r1 = r0 + 8;
  // b1 in batches of 8 groups (a 64-column chunk: two keep words a row),
  // loaded together ahead of their use
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += 8) {
    float2 bias[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      bias[i] = *reinterpret_cast<const float2*>(b1 + n0 + 8 * (j0 + i) +
                                                 2 * t);
    uint32_t w[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = j0 + i;
      const float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                          acc[4 * j + 3]};
      bool keep[4] = {true, true, true, true};
      if (drop.threshold) keep4(drop, r0, r1, F, n0 + 8 * j, t, keep);
      uint32_t p0, p1;
      hidden4<ACT, ROUND>(p0, p1, v, bias[i], keep, drop);
      if constexpr (WORDS) add_keep_bits(w, i, t, keep);
      store_bf16(h, F, r0, r1, n0 + 8 * j + 2 * t, t, p0, p1, M);
    }
    if constexpr (WORDS)
      store_keep_words(w, words, r0, r1, M, F, (n0 + 8 * j0) / 32, t);
  }
}

// Every C but 256, launch 2: y = h W2 + b2 on a BM x 256 tile a block (the
// last 128 x 128 where C % 256 == 128: the NARROW and NARROW_TRAIN
// instances), then (LN) out = LN2(res + drop_y(y)) over the cluster's
// ceil(C / 256) blocks, with the normalised rows and 1/std where n_out and
// rstd are not null, or (!LN, one block a cluster) ffn_train's y_out =
// drop_y(bf16(bf16(y) + bf16(b2)))
enum Tiles { WIDE = 0, NARROW = 1, NARROW_TRAIN = 2 };

template <bool LN, int TILES = WIDE>
__global__ void __launch_bounds__(THREADS, 1)
ffn_out_kernel(const __grid_constant__ CUtensorMap map_h,
               const __grid_constant__ CUtensorMap map_w2,
               const float* __restrict__ x, const float* __restrict__ b2,
               const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ out,
               float* __restrict__ n_out, float* __restrict__ rstd,
               bf16* __restrict__ y_out, int M, int F, int C,
               int round_input, ppgs::Dropout drop) {
  using R = Ring<false, OUT_BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_ring(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  float* sums = reinterpret_cast<float*>(empty + R::STAGES);   // [2][BM]
  const int n0 = blockIdx.x * OUT_BN, m0 = blockIdx.y * BM;
  const int wg = threadIdx.x / 128;
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = 64 * c + 16 * warp + g;            // the tile's rows
  const long long r0 = m0 + lr0;

  if (threadIdx.x == 0) mbar_init_ring(full, empty, R::STAGES, 8);
  __syncthreads();
  float acc[OUT_BN / 2];
  if (wg == 0) {
    if (threadIdx.x == 0)
      produce<false, OUT_BN>(&map_h, &map_w2, ring, full, empty, F / BK, m0,
                             n0, ln_groups(C, n0) / 8);
    if constexpr (!LN) return;
  } else {
    consume<false, OUT_BN>(acc, ring, full, empty, F / BK, c, warp, lane);
  }
  if constexpr (!LN) {
    if constexpr (EPILOGUE) {
      if (TILES == WIDE || ln_groups(C, n0) == OUT_BN / 8)
        store_y_out(acc, b2, y_out, M, C, n0, r0, r0 + 8, t, drop);
      else
        store_y_out(acc, b2, y_out, M, C, n0, r0, r0 + 8, t, drop,
                    OUT_BN / 16);
    }
    return;
  }
  __syncwarp();   // the producer's warp meets the cluster barriers whole

  // Every thread of every block of the cluster takes part in the
  // epilogue's barriers; the producer warpgroup has nothing else to do. A
  // block of 256 columns, or in the NARROW instances the last of 128, each
  // copy with its column count known to the compiler. The second copy cost
  // the first 18% (scripts/torch_layer_width_probe.py), so only the widths
  // C % 256 == 128 take the instances that have it, and the inference one
  // compiles the narrow copy without the dropout and the saved rows
  if constexpr (EPILOGUE) {
    if (TILES == WIDE || ln_groups(C, n0) == OUT_BN / 8)
      residual_ln(acc, wg != 0, sums, x, b2, gamma, beta, out, n_out, rstd,
                  M, C, n0, lr0, r0, t, round_input, drop, blockIdx.x == 0,
                  OUT_BN / 8);
    else if constexpr (TILES == NARROW_TRAIN)
      residual_ln(acc, wg != 0, sums, x, b2, gamma, beta, out, n_out, rstd,
                  M, C, n0, lr0, r0, t, round_input, drop, blockIdx.x == 0,
                  OUT_BN / 16);
    else
      residual_ln(acc, wg != 0, sums, x, b2, gamma, beta, out, nullptr,
                  nullptr, M, C, n0, lr0, r0, t, round_input,
                  ppgs::Dropout{}, blockIdx.x == 0, OUT_BN / 16);
  }
  cg::this_cluster().sync();   // no block leaves while a peer reads its sums
}

// C = 512's train forms (the hidden's keep words written), launch 1:
// hidden_train_kernel, persistent, x resident, the keep bits drawn by
// warps of their own (see the note at the top). A unit is 128 rows x 128
// hidden columns.
constexpr int UM = 128, UN = 128;
constexpr int DK = 64;                      // depth of a W1 item
constexpr int SLOT = DK * UN * 2;           // a W1 item, or a box of x: 16 KB
constexpr int OBOX = 64 * 128;              // a 64 x 64 bf16 box of h, 8 KB
constexpr int TRAIN_C = 512;
// Two consumer warpgroups and a third: its first warp keeps the ring
// full, its other three draw the keep bits
constexpr int HT_THREADS = 3 * 128;
constexpr int DRAW_WARPS = 3;
constexpr int SMEM_MAX = 232448;

template <bool X_F32>
struct HPlan {
  static constexpr int STEPS = TRAIN_C / DK;          // W1 items a unit
  static constexpr int SLAB = UM * 128;               // 64 columns of x, bf16
  static constexpr int X_BYTES = STEPS * SLAB;        // x, resident: 128 KB
  static constexpr int XPER = X_F32 ? 2 : 1;          // x boxes a depth step
  static constexpr int OUT_BYTES = 2 * 2 * OBOX;      // two boxes a warpgroup
  // the ring takes what is left, less 1024 bytes of alignment slack and
  // 256 for its barriers
  static constexpr int STAGES =
      (SMEM_MAX - 1280 - X_BYTES - OUT_BYTES) / SLOT;
  // the ring's full and empty barriers, the keep words' ready and
  // consumed barriers
  static constexpr int SMEM =
      X_BYTES + OUT_BYTES + STAGES * (SLOT + 16) + 16 + 1024;
  static_assert(STAGES >= 2 && STAGES * 16 <= 256 && SMEM <= SMEM_MAX,
                "the plan does not fit a block's shared memory");
};

// A block's units [u0, u1) of `units` (row block u / nt, column tile u %
// nt), the ranges balanced to one unit; odd blocks walk theirs backwards,
// so that two that share a row block at their ends read its x at about
// the same time (from L2 once). ops/fused_ffn.py hidden_walk replays it.
struct HWalk {
  int u0, u1, nt;
  bool back;
  __device__ HWalk(int units, int nt_) : nt(nt_) {
    const long long b = blockIdx.x, g = gridDim.x;
    u0 = static_cast<int>(b * units / g);
    u1 = static_cast<int>((b + 1) * units / g);
    back = (b & 1) != 0;
  }
  __device__ int count() const { return u1 - u0; }
  __device__ int at(int i) const { return back ? u1 - 1 - i : u0 + i; }
  __device__ int row(int i) const { return at(i) / nt; }
  __device__ int col(int i) const { return at(i) % nt * UN; }
  // the unit starts a row block: its x comes through the ring first
  __device__ bool first(int i) const {
    return i == 0 || row(i) != row(i - 1);
  }
};

// Consumer warpgroup c's rows of a box of x into slab `slab` of the
// resident x: an fp32 box (32 columns a row) rounded to bf16 into half h
// of the slab, or a bf16 box (64 columns) copied; both in the 128-byte
// swizzle (the 16-byte chunk q of row r at q ^ (r & 7)) that TMA writes
// and wgmma reads. fp32: thread i of the warpgroup takes row 64c + i % 64,
// chunks i / 64 and i / 64 + 2, eight rows a phase (conflict-free); bf16:
// 16-byte chunks in order
template <bool X_F32>
__device__ __forceinline__ void stage_x(const unsigned char* box,
                                        unsigned char* slab, int h, int c) {
  const int i = threadIdx.x % 128;
  if constexpr (X_F32) {
    const int row = 64 * c + i % 64, sw = row & 7;
    const unsigned char* src = box + row * 128;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = i / 64 + 2 * e;              // bf16 chunk of the half
      const float4 v0 =
          *reinterpret_cast<const float4*>(src + (((2 * q) ^ sw) << 4));
      const float4 v1 =
          *reinterpret_cast<const float4*>(src + (((2 * q + 1) ^ sw) << 4));
      *reinterpret_cast<uint4*>(slab + row * 128 +
                                (((4 * h + q) ^ sw) << 4)) =
          make_uint4(bits(pair(v0.x, v0.y)), bits(pair(v0.z, v0.w)),
                     bits(pair(v1.x, v1.y)), bits(pair(v1.z, v1.w)));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (64 * c * 8 + i + 128 * e) * 16;
      *reinterpret_cast<uint4*>(slab + at) =
          *reinterpret_cast<const uint4*>(box + at);
    }
  }
}

// Each consumer warp frees a slot
__device__ __forceinline__ void release_slot(uint64_t* empty, int s,
                                             int lane) {
  if (lane == 0) mbar_arrive(smem_addr(empty + s));
}

// Consumer warpgroup c's products of one unit into acc; FIRST: the unit
// starts a row block, and the x of each depth step arrives just before its
// W1 item
template <bool X_F32, bool FIRST>
__device__ __forceinline__ void hidden_mainloop(
    float (&acc)[UN / 2], unsigned char* xs, unsigned char* ring,
    uint64_t* full, uint64_t* empty, int& it, int c, int lane) {
  using P = HPlan<X_F32>;
  const uint32_t x_addr = smem_addr(xs) + c * 64 * 128;
#pragma unroll
  for (int e = 0; e < UN / 2; ++e) acc[e] = 0.f;
  int prev = 0;
#pragma unroll
  for (int k = 0; k < P::STEPS; ++k) {
    if constexpr (FIRST) {
      // Free the last W1 item first and each x slot as soon as it is read
      if (k > 0) {
        wgmma_wait<0>();
        fence_regs(acc);
        release_slot(empty, prev, lane);
      }
#pragma unroll
      for (int h = 0; h < P::XPER; ++h, ++it) {
        const int s = it % P::STAGES;
        mbar_wait(smem_addr(full + s), (it / P::STAGES) & 1);
        stage_x<X_F32>(ring + s * SLOT, xs + k * P::SLAB, h, c);
        fence_async_smem();     // the writes, for wgmma's reads
        bar_sync(1 + c, 128);
        release_slot(empty, s, lane);
      }
    }
    const int s = it % P::STAGES;
    mbar_wait(smem_addr(full + s), (it / P::STAGES) & 1);
    const uint32_t b_addr = smem_addr(ring + s * SLOT);
    fence_regs(acc);
    wgmma_fence();
    if constexpr (LIVE) {
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        // A K-major (32 bytes of each 128-byte row a k16 step), B MN-major
        // (16 depth rows of 128 bytes a step, the two 64-column boxes SLOT
        // / 2 apart)
        wgmma_ss<UN, 0, 1>(acc,
                           sw128_desc(x_addr + k * P::SLAB + kk * 32, 16,
                                      1024),
                           sw128_desc(b_addr + kk * 2048, SLOT / 2, 1024));
    }
    wgmma_commit();
    if constexpr (!FIRST) {
      wgmma_wait<1>();          // the previous step's products are done
      fence_regs(acc);
      if (k > 0) release_slot(empty, prev, lane);
    }
    prev = s;
    ++it;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release_slot(empty, prev, lane);
}

// h (M, F) bf16 = drop_h(relu(bf16(bf16(x W1) + bf16(b1)))) and its keep
// words, C = 512; X_F32: x fp32 (B4's form), else bf16 (ffn_train's)
template <bool X_F32>
__global__ void __launch_bounds__(HT_THREADS, 1)
hidden_train_kernel(const __grid_constant__ CUtensorMap map_w1,
                    const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_h,
                    const float* __restrict__ b1,
                    uint32_t* __restrict__ words, int M, int F,
                    ppgs::Dropout drop) {
  using P = HPlan<X_F32>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs = aligned_ring(smem_raw);
  unsigned char* staging = xs + P::X_BYTES;
  unsigned char* ring = staging + P::OUT_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::STAGES * SLOT);
  uint64_t* empty = full + P::STAGES;
  uint64_t* ready = empty + P::STAGES;    // a unit's keep words written
  uint64_t* consumed = ready + 1;         // and read by every consumer warp

  const int nt = F / UN, wpr = F / 32;
  const bool drawn = LIVE && PHILOX && drop.threshold && words;
  const HWalk walk((M + UM - 1) / UM * nt, nt);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(ready, DRAW_WARPS);
    mbar_init(consumed, 8);
    mbar_init_ring(full, empty, P::STAGES, 8);   // every consumer warp frees
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      // Producer: the ring's items in the order the consumers walk them
      int it = 0;
      auto slot = [&]() {
        const int s = it % P::STAGES, round = it / P::STAGES;
        if (round > 0) mbar_wait(smem_addr(empty + s), (round - 1) & 1);
        mbar_expect_tx(smem_addr(full + s), SLOT);
        ++it;
        return s;
      };
      for (int i = 0; i < walk.count(); ++i) {
        const int m0 = walk.row(i) * UM, n0 = walk.col(i);
        const bool first = walk.first(i);
        for (int k = 0; k < P::STEPS; ++k) {
          if (first) {
#pragma unroll
            for (int h = 0; h < P::XPER; ++h) {
              const int s = slot();
              tma_load(ring + s * SLOT, &map_x,
                       X_F32 ? (2 * k + h) * 32 : k * DK, m0,
                       smem_addr(full + s));
            }
          }
          const int s = slot();
          unsigned char* dst = ring + s * SLOT;
          tma_load(dst, &map_w1, n0, k * DK, smem_addr(full + s));
          tma_load(dst + SLOT / 2, &map_w1, n0 + 64, k * DK,
                   smem_addr(full + s));
        }
      }
    }
  } else if (warp > 8) {
    // The keep bits, while the consumers' products run: each unit's words
    // (four a row, 32 columns of 8 Philox groups each) into `words`, then
    // `ready`; no further than one unit ahead of the consumers' reads
    // (which come before the unit's products), so that a wait on `ready`
    // never meets a later phase of the same parity
    const int tid = threadIdx.x - 9 * 32;
    for (int i = 0; i < walk.count(); ++i) {
      const int m0 = walk.row(i) * UM, n0 = walk.col(i);
      if (drawn) {
        // two words in flight a thread (16 Philox calls), so that the
        // multiplies' latency is hidden
#pragma unroll 2
        for (int n = 0; n < (UM * (UN / 32) + DRAW_WARPS * 32 - 1) /
                                (DRAW_WARPS * 32); ++n) {
          const int w = tid + n * DRAW_WARPS * 32;
          const long long row = m0 + w / (UN / 32);
          const int q = w % (UN / 32);
          if (w >= UM * (UN / 32) || row >= M) continue;
          const unsigned long long g0 =
              static_cast<unsigned long long>(row * F + n0 + 32 * q) >> 2;
          uint32_t word = 0u;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const unsigned long long gr = g0 + e;
            const uint4 r = ppgs::philox4x32_10(
                make_uint4(static_cast<uint32_t>(gr),
                           static_cast<uint32_t>(gr >> 32), drop.site, 0u),
                drop.seed_lo, drop.seed_hi);
            word |= (uint32_t(r.x >= drop.threshold) |
                     uint32_t(r.y >= drop.threshold) << 1 |
                     uint32_t(r.z >= drop.threshold) << 2 |
                     uint32_t(r.w >= drop.threshold) << 3)
                    << (4 * e);
          }
          words[row * wpr + n0 / 32 + q] = word;
        }
      }
      __threadfence_block();
      __syncwarp();
      if (i > 0) mbar_wait(smem_addr(consumed), (i - 1) & 1);
      if (lane == 0) mbar_arrive(smem_addr(ready));
    }
  } else {
    // Consumers: warpgroup c owns rows 64c..64c+63 of the block's. A
    // thread holds rows lr and lr + 8, columns 8j + 2t and 8j + 2t + 1
    // (j < 16), of its warp's 16 rows
    const int c = warp / 4, g = lane >> 2, t = lane & 3;
    const int lr = 16 * (warp % 4) + g;
    const bool lead = threadIdx.x % 128 == 0;
    unsigned char* stg = staging + c * 2 * OBOX;
    float acc[UN / 2];
    int it = 0;
    for (int i = 0; i < walk.count(); ++i) {
      const int n0 = walk.col(i);
      const int wg_row = walk.row(i) * UM + 64 * c;
      const long long r0 = wg_row + lr, r1 = r0 + 8;
      // The unit's keep words of rows r0 and r1 (all kept with the dropout
      // off), read before its products so that they arrive meanwhile: bit
      // 8 (j % 4) + 2t + e of word j / 4 for register 4j + e
      mbar_wait(smem_addr(ready), i & 1);
      uint4 kw0 = make_uint4(~0u, ~0u, ~0u, ~0u), kw1 = kw0;
      if (drawn) {
        if (r0 < M)
          kw0 = __ldcg(reinterpret_cast<const uint4*>(words + r0 * wpr) +
                       n0 / 128);
        if (r1 < M)
          kw1 = __ldcg(reinterpret_cast<const uint4*>(words + r1 * wpr) +
                       n0 / 128);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(consumed));
      if (walk.first(i))
        hidden_mainloop<X_F32, true>(acc, xs, ring, full, empty, it, c,
                                     lane);
      else
        hidden_mainloop<X_F32, false>(acc, xs, ring, full, empty, it, c,
                                      lane);
      if constexpr (!EPILOGUE) {
        // the products' sums stay live, so that they are not taken out
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < UN / 2; ++e) sum += acc[e];
        if (sum == -1.2345e-30f && words) words[0] = kw0.x ^ kw1.y;
        continue;
      }
      // Epilogue: bias, ReLU, dropout and the bf16 rounding into the
      // warpgroup's two boxes, swizzled as TMA reads them (conflict-free),
      // then a TMA store a box, which writes no row past M; the last
      // unit's stores have read the boxes by then
      if (lead) bulk_wait_read();
      bar_sync(1 + c, 128);
#pragma unroll
      for (int j = 0; j < UN / 8; ++j) {
        const float2 bias = __ldg(reinterpret_cast<const float2*>(
            b1 + n0 + 8 * j + 2 * t));
        const int at_bit = 8 * (j % 4) + 2 * t;
        const uint32_t a0 = (j / 4 == 0 ? kw0.x : j / 4 == 1 ? kw0.y
                             : j / 4 == 2 ? kw0.z : kw0.w) >> at_bit;
        const uint32_t a1 = (j / 4 == 0 ? kw1.x : j / 4 == 1 ? kw1.y
                             : j / 4 == 2 ? kw1.z : kw1.w) >> at_bit;
        const bool keep[4] = {(a0 & 1u) != 0, (a0 & 2u) != 0,
                              (a1 & 1u) != 0, (a1 & 2u) != 0};
        const float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                            acc[4 * j + 3]};
        uint32_t p0, p1;
        hidden4<RELU, false>(p0, p1, v, bias, keep, drop);
        unsigned char* at =
            stg + (j / 8) * OBOX + lr * 128 + (((j % 8) ^ g) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(at) = p0;
        *reinterpret_cast<uint32_t*>(at + 8 * 128) = p1;   // (lr + 8) & 7 == g
      }
      fence_async_smem();
      bar_sync(1 + c, 128);
      if (lead && wg_row < M) {
        tma_store(&map_h, n0, wg_row, stg);
        tma_store(&map_h, n0 + 64, wg_row, stg + OBOX);
        bulk_commit();
      }
    }
    if (lead) bulk_wait_read();
  }
}

// Launch hidden_train_kernel on a persistent grid: as many blocks as the
// card holds at once (one an SM), none without a unit
template <bool X_F32>
int launch_hidden_train(const CUtensorMap& mw1, const CUtensorMap& mx,
                        const CUtensorMap& mh, const float* b1,
                        uint32_t* words, int M, int F, ppgs::Dropout dh,
                        cudaStream_t s) {
  int dev = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&blocks, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = static_cast<long long>((M + UM - 1) / UM) *
                          (F / UN);
  return launch(hidden_train_kernel<X_F32>, HT_THREADS, HPlan<X_F32>::SMEM,
                dim3(static_cast<unsigned>(units < blocks ? units : blocks)),
                1, s, mw1, mx, mh, b1, words, M, F, dh);
}

// C = 256, one launch: the hidden stays on chip. A block owns BM = 128
// rows: x's tile, rounded to bf16, stays in shared memory (64 KB, K-major,
// swizzled as TMA would), and the block walks F in 64-column chunks, W1's
// chunk (256 x 64) and W2's (64 x 256) arriving by TMA in a 2-stage ring.
// Per chunk, each warpgroup (64 rows): h = x W1_f by m64n64k16 (SS); bias,
// ReLU, dropout and the bf16 rounding on h's accumulators, which are then
// the A fragments of y += h W2_f by m64n256k16 (RS: the accumulators of
// two adjacent 8-column groups are a k16 A fragment); the next chunk's
// first product is issued before the second one is waited for. y (64 x
// 256 fp32) stays in registers, 128 a thread, beside h's 32 and the
// fragments' 16: more than the 168 that a block of 288 or 384 threads
// leaves a thread (a sub-partition of the SM holds a quarter of its
// registers and three of nine warps), where ptxas spilled. So the block is
// the two warpgroups alone, 256 threads of up to 255 registers; thread 0
// fills the ring and thread LOADER refills it, chunk f + 2's stage as soon
// as both warpgroups have released chunk f's. A stage also brings the
// chunk's 64 values of b1 (a bulk copy), so that the bias reads are shared
// memory loads issued together: read from global memory, one by one
// between the epilogue's steps, they cost as much as the two products. The
// last chunk is peeled from the loop, so that no branch separates a
// chunk's second product from the next chunk's first: with the barrier
// wait's loop between them, ptxas waited for every wgmma in flight there
// (WARPGROUP.DEPBAR in the SASS), and the two products ran in turn.
constexpr int FC = 64;                      // the fused form's hidden chunk
constexpr int FUSED_C = 256;
constexpr int FUSED_THREADS = 256;
constexpr int LOADER = 128;                 // the thread that refills the ring
struct Fused {
  static constexpr int X_BYTES = BM * FUSED_C * 2;     // 4 atoms of 64 columns
  static constexpr int W1_BYTES = FUSED_C * FC * 2;    // one 64-column box
  static constexpr int W2_BYTES = FC * FUSED_C * 2;    // four 64-column boxes
  static constexpr int B1_BYTES = FC * 4;              // the chunk's b1
  static constexpr int LOADED = W1_BYTES + W2_BYTES + B1_BYTES;
  static constexpr int STAGE = W1_BYTES + W2_BYTES + 1024;   // 1024-aligned
  static constexpr int STAGES = 2;
  static constexpr int SMEM = X_BYTES + STAGES * STAGE + 2 * STAGES * 8
                              + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// h (the warpgroup's 64 rows x 64) = x W1_f: 16 m64n64k16 steps, x K-major
// (32 bytes of a 128-byte row a step, an atom every 4), W1_f MN-major
__device__ __forceinline__ void issue_hidden(float (&h)[32], uint32_t xs,
                                             uint32_t w1) {
#pragma unroll
  for (int i = 0; i < 32; ++i) h[i] = 0.f;
  fence_regs(h);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < FUSED_C / 16; ++k)
    wgmma_ss<64, 0, 1>(
        h, sw128_desc(xs + (k / 4) * (BM * 128) + (k % 4) * 32, 16, 1024),
        sw128_desc(w1 + k * 2048, BOX_BYTES, 1024));
  wgmma_commit();
}

// LN: x fp32 -> out (and n_out, rstd); !LN: x bf16 -> y_out. ROUND:
// round_input. WORDS: write the hidden's keep words to `words`
template <bool LN, bool ROUND, bool WORDS>
__global__ void __launch_bounds__(FUSED_THREADS, 1)
ffn_fused_kernel(const __grid_constant__ CUtensorMap map_w1,
                 const __grid_constant__ CUtensorMap map_w2,
                 const void* __restrict__ xv, const float* __restrict__ b1,
                 const float* __restrict__ b2,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, float* __restrict__ out,
                 float* __restrict__ n_out, float* __restrict__ rstd,
                 bf16* __restrict__ y_out, uint32_t* __restrict__ words,
                 int M, int F, ppgs::Dropout drop_h, ppgs::Dropout drop_y) {
  using P = Fused;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs = aligned_ring(smem_raw);
  unsigned char* ring = xs + P::X_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::STAGES * P::STAGE);
  uint64_t* empty = full + P::STAGES;
  const int m0 = blockIdx.x * BM;
  const int chunks = F / FC;

  // Load chunk f's W1, W2 and b1 pieces into stage f % 2
  auto load = [&](int f) {
    const int s = f % P::STAGES;
    const uint32_t bar = smem_addr(full + s);
    mbar_expect_tx(bar, P::LOADED);
    unsigned char* w1s = ring + s * P::STAGE;
    tma_load(w1s, &map_w1, f * FC, 0, bar);
#pragma unroll
    for (int j = 0; j < FUSED_C / 64; ++j)
      tma_load(w1s + P::W1_BYTES + j * BOX_BYTES, &map_w2, j * 64, f * FC,
               bar);
    bulk_load(w1s + P::W1_BYTES + P::W2_BYTES, b1 + f * FC, P::B1_BYTES,
              bar);
  };
  if (threadIdx.x == 0) {
    mbar_init_ring(full, empty, P::STAGES, 8);
    for (int f = 0; f < P::STAGES && f < chunks; ++f) load(f);
  }
  __syncthreads();

  const int c = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const long long r0 = m0 + 64 * c + 16 * warp + g, r1 = r0 + 8;
  using TX = typename std::conditional<LN, float, bf16>::type;
  const TX* x = static_cast<const TX*>(xv);

  // The warpgroup's rows of x, for the async proxy (wgmma) to read
  stage_rows<BM, FUSED_C>(xs, x, m0 + 64 * c, 64 * c, M, threadIdx.x % 128);
  fence_async_smem();
  bar_sync(1 + c, 128);

  const uint32_t xs_addr = smem_addr(xs) + c * 64 * 128;
  const uint32_t ring_addr = smem_addr(ring);
  float y[128], h[32];
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < 128; ++i) y[i] = 0.f;
  // h -> the second product's A fragments: a[k] holds hidden columns
  // 16k..16k+15, groups j = 2k (registers 0, 1) and 2k + 1 (2, 3)
  auto fragments = [&](int f) {
    const float* sb = reinterpret_cast<const float*>(
        ring + (f % P::STAGES) * P::STAGE + P::W1_BYTES + P::W2_BYTES);
    float2 bias[FC / 8];
#pragma unroll
    for (int j = 0; j < FC / 8; ++j)
      bias[j] = *reinterpret_cast<const float2*>(sb + 8 * j + 2 * t);
    // The chunk's keep bits as the words of rows r0 and r1: FC = 64
    // columns, two words a row, a thread's bits of group j at 8 (j % 4) +
    // 2t of word j / 4
    uint32_t w[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
    for (int j = 0; j < FC / 8; ++j) {
      const float v[4] = {h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3]};
      bool keep[4] = {true, true, true, true};
      if (drop_h.threshold) keep4(drop_h, r0, r1, F, f * FC + 8 * j, t, keep);
      hidden4<RELU, ROUND>(a[j / 2][2 * (j % 2)], a[j / 2][2 * (j % 2) + 1],
                           v, bias[j], keep, drop_h);
      if constexpr (WORDS) add_keep_bits(w, j, t, keep);
    }
    if constexpr (WORDS)
      store_keep_words(w, words, r0, r1, M, F, f * (FC / 32), t);
  };
  // y += h W2_f
  auto issue_out = [&](int f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) fence_regs(a[k]);
    fence_regs(y);
    wgmma_fence();
    const uint32_t w2 =
        ring_addr + (f % P::STAGES) * P::STAGE + P::W1_BYTES;
#pragma unroll
    for (int k = 0; k < FC / 16; ++k)
      wgmma_rs<256>(y, a[k], sw128_desc(w2 + k * 2048, BOX_BYTES, 1024));
    wgmma_commit();
  };
  // Chunk f's second product is done: its stage goes back to the ring
  auto release = [&](int f) {
    fence_regs(y);
#pragma unroll
    for (int k = 0; k < 4; ++k) fence_regs(a[k]);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(empty + f % P::STAGES));
  };

  mbar_wait(smem_addr(full), 0);
  issue_hidden(h, xs_addr, ring_addr);
  wgmma_wait<0>();
  fence_regs(h);
  // The last chunk is peeled, so that no branch separates a chunk's second
  // product from the next chunk's first and the two run side by side
  for (int f = 0; f + 1 < chunks; ++f) {
    const int s1 = (f + 1) % P::STAGES;
    fragments(f);
    mbar_wait(smem_addr(full + s1), ((f + 1) / P::STAGES) & 1);
    issue_out(f);
    issue_hidden(h, xs_addr, ring_addr + s1 * P::STAGE);
    wgmma_wait<1>();
    release(f);
    wgmma_wait<0>();
    fence_regs(h);
    if (threadIdx.x == LOADER && f + P::STAGES < chunks) {
      mbar_wait(smem_addr(empty + f % P::STAGES), (f / P::STAGES) & 1);
      load(f + P::STAGES);
    }
    __syncwarp();
  }
  fragments(chunks - 1);
  issue_out(chunks - 1);
  wgmma_wait<0>();
  release(chunks - 1);

  if constexpr (LN) {
    float s0, s1, q0, q1;
    residual_rows(y, x, b2, M, FUSED_C, 0, r0, r1, t, ROUND, drop_y, s0,
                  s1);
    center_rows(y, s0 * (1.f / FUSED_C), s1 * (1.f / FUSED_C), q0, q1);
    const float inv0 = rsqrtf(q0 * (1.f / FUSED_C) + ppgs::LN_EPS);
    const float inv1 = rsqrtf(q1 * (1.f / FUSED_C) + ppgs::LN_EPS);
    store_ln(y, inv0, inv1, gamma, beta, out, n_out, M, FUSED_C, 0, r0, r1,
             t);
    if (rstd && t == 0) {
      if (r0 < M) rstd[r0] = inv0;
      if (r1 < M) rstd[r1] = inv1;
    }
  } else {
    store_y_out(y, b2, y_out, M, FUSED_C, 0, r0, r1, t, drop_y);
  }
}

template <int ACT, bool ROUND, bool X_F32 = true, bool WORDS = false>
int launch_hidden(const CUtensorMap& mx, const CUtensorMap& mw1,
                  const float* b1, bf16* h, uint32_t* words, int M, int F,
                  int C, ppgs::Dropout dh, int m_tiles, cudaStream_t s) {
  if (F % 256 == 0)
    return launch(ffn_hidden_kernel<256, ACT, ROUND, X_F32, WORDS>, THREADS,
                  Ring<X_F32, 256>::SMEM, dim3(F / 256, m_tiles), 1, s, mx,
                  mw1, b1, h, words, M, F, C, dh);
  return launch(ffn_hidden_kernel<128, ACT, ROUND, X_F32, WORDS>, THREADS,
                Ring<X_F32, 128>::SMEM, dim3(F / 128, m_tiles), 1, s, mx,
                mw1, b1, h, words, M, F, C, dh);
}

template <bool LN, bool ROUND, bool WORDS = false>
int launch_fused(const CUtensorMap& mw1, const CUtensorMap& mw2,
                 const void* x, const float* b1, const float* b2,
                 const float* g, const float* be, float* o, float* n,
                 float* rs, bf16* y_out, uint32_t* words, int M, int F,
                 ppgs::Dropout dh, ppgs::Dropout dy, int m_tiles,
                 cudaStream_t s) {
  return launch(ffn_fused_kernel<LN, ROUND, WORDS>, FUSED_THREADS,
                Fused::SMEM, dim3(m_tiles), 1, s, mw1, mw2, x, b1, b2, g, be,
                o, n, rs, y_out, words, M, F, dh, dy);
}

}  // namespace

// x (M, C), w1 (C, F) bf16, b1 (F) fp32, w2 (F, C) bf16, b2 (C) fp32, h
// (M, F) bf16 scratch for the hidden at every C but 256 (unused, may be
// null, at C = 256); F % 128 == 0; act 0 = ReLU, 1 = tanh-GELU. With y_out
// null: x fp32, gamma/beta (C) fp32 -> out (M, C) fp32, and n_out (M, C)
// and rstd (M) fp32 unless null; C % 128 == 0 and 128 <= C <= 2048, with
// ReLU for the train forms (n_out, rstd, keep_out or the dropout on). With
// y_out (the same C, ReLU, round_input 0): x bf16 -> y_out (M, C) bf16
// (gamma, beta, out, n_out and rstd unused). The hidden's dropout site is (seed, site_h), the
// output's (seed, site_y); threshold 0 turns both off. keep_out (M, F /
// 32) int32, or null: the hidden's keep words (the train forms: ReLU,
// round_input 0, threshold != 0). One kernel at C = 256, two on the
// stream (the hidden's, then the output's) at every other C. Any other
// (C, act), or keep_out where it cannot be written, returns
// cudaErrorInvalidValue.
extern "C" int ppgs_ffn_ln(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* gamma,
                           const void* beta, void* out, void* n_out,
                           void* rstd, void* y_out, void* h, void* keep_out,
                           int M, int F, int C, int act, int round_input,
                           unsigned seed_lo, unsigned seed_hi,
                           unsigned site_h, unsigned site_y,
                           unsigned threshold, float scale, void* stream) {
  // the fused kernel is ReLU's; GELU at C = 256 takes the two launches
  const bool ln = y_out == nullptr, fused = C == FUSED_C && act == RELU;
  const bool train = n_out || rstd || keep_out || threshold;
  const bool width_ok =
      C % 128 == 0 && C >= 128 && C <= MAX_C &&
      (ln ? (act == RELU || act == GELU) && (!train || act == RELU)
          : act == RELU && !round_input);
  const int m_tiles = (M + BM - 1) / BM;
  if (!width_ok || F <= 0 || F % 128 || m_tiles > 65535 || (!fused && !h) ||
      reinterpret_cast<uintptr_t>(b1) % 16 ||
      (keep_out && (act != RELU || round_input || !threshold)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  const ppgs::Dropout dh =
      ppgs::make_dropout(seed_lo, seed_hi, site_h, threshold, scale);
  const ppgs::Dropout dy =
      ppgs::make_dropout(seed_lo, seed_hi, site_y, threshold, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* o = static_cast<float*>(out);
  float* n = static_cast<float*>(n_out);
  float* rs = static_cast<float*>(rstd);
  CUtensorMap mw1, mw2;
  if (fused) {
    // W1 in 64-column chunks of all 256 rows, W2 in 64 x 64 boxes
    if (!encode(&mw1, w1, false, C, F, F, 64, FUSED_C) ||
        !encode(&mw2, w2, false, F, C, C, 64, FC))
      return static_cast<int>(cudaErrorInvalidValue);
    bf16* y = static_cast<bf16*>(y_out);
    uint32_t* words = static_cast<uint32_t*>(keep_out);
    if (words)
      return ln ? launch_fused<true, false, true>(mw1, mw2, x, b1f, b2f, g,
                                                  be, o, n, rs, y, words, M,
                                                  F, dh, dy, m_tiles, s)
                : launch_fused<false, false, true>(mw1, mw2, x, b1f, b2f, g,
                                                   be, o, n, rs, y, words, M,
                                                   F, dh, dy, m_tiles, s);
    if (!ln)
      return launch_fused<false, false>(mw1, mw2, x, b1f, b2f, g, be, o, n,
                                        rs, y, nullptr, M, F, dh, dy,
                                        m_tiles, s);
    return round_input
               ? launch_fused<true, true>(mw1, mw2, x, b1f, b2f, g, be, o, n,
                                          rs, y, nullptr, M, F, dh, dy,
                                          m_tiles, s)
               : launch_fused<true, false>(mw1, mw2, x, b1f, b2f, g, be, o,
                                           n, rs, y, nullptr, M, F, dh, dy,
                                           m_tiles, s);
  }
  // x: fp32 in two 32-column boxes a depth step (the LayerNorm forms),
  // bf16 in one of 64 (y_out)
  CUtensorMap mx, mh;
  if (!encode(&mx, x, ln, M, C, C, ln ? 32 : 64, BM) ||
      !encode(&mw1, w1, false, C, F, F, 64, BK) ||
      !encode(&mh, h, false, M, F, F, 64, BM) ||
      !encode(&mw2, w2, false, F, C, C, 64, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  bf16* hb = static_cast<bf16*>(h);
  uint32_t* words = static_cast<uint32_t*>(keep_out);
  // The train forms' hidden launch: persistent at C = 512 (h stored by TMA
  // in boxes of 64 rows), the inference form's at the others with its words
  const bool persistent = words && C == TRAIN_C;
  CUtensorMap mhs;
  if (persistent && !encode(&mhs, h, false, M, F, F, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (persistent)
    err = ln ? launch_hidden_train<true>(mw1, mx, mhs, b1f, words, M, F,
                                         dh, s)
             : launch_hidden_train<false>(mw1, mx, mhs, b1f, words, M, F, dh,
                                          s);
  else if (words)
    err = ln ? launch_hidden<RELU, false, true, true>(mx, mw1, b1f, hb, words,
                                                      M, F, C, dh, m_tiles, s)
             : launch_hidden<RELU, false, false, true>(mx, mw1, b1f, hb,
                                                       words, M, F, C, dh,
                                                       m_tiles, s);
  else if (!ln)
    err = launch_hidden<RELU, false, false>(mx, mw1, b1f, hb, nullptr, M, F,
                                            C, dh, m_tiles, s);
  else if (act == GELU)
    err = round_input ? launch_hidden<GELU, true>(mx, mw1, b1f, hb, nullptr,
                                                  M, F, C, dh, m_tiles, s)
                      : launch_hidden<GELU, false>(mx, mw1, b1f, hb, nullptr,
                                                   M, F, C, dh, m_tiles, s);
  else
    err = round_input ? launch_hidden<RELU, true>(mx, mw1, b1f, hb, nullptr,
                                                  M, F, C, dh, m_tiles, s)
                      : launch_hidden<RELU, false>(mx, mw1, b1f, hb, nullptr,
                                                   M, F, C, dh, m_tiles, s);
  if (err) return err;
  const float* xf = static_cast<const float*>(x);
  bf16* yb = static_cast<bf16*>(y_out);
  if (!ln)
    return launch(C % OUT_BN ? ffn_out_kernel<false, NARROW>
                             : ffn_out_kernel<false>,
                  THREADS, Ring<false, OUT_BN>::SMEM,
                  dim3(ln_ranks(C), m_tiles), 1, s, mh, mw2, xf, b2f, g, be,
                  o, n, rs, yb, M, F, C, round_input, dy);
  const auto out_kernel = C % OUT_BN == 0 ? ffn_out_kernel<true>
                          : train         ? ffn_out_kernel<true, NARROW_TRAIN>
                                          : ffn_out_kernel<true, NARROW>;
  return launch(out_kernel, THREADS, Ring<false, OUT_BN>::SMEM,
                dim3(ln_ranks(C), m_tiles), ln_ranks(C), s, mh, mw2, xf, b2f,
                g, be, o, n, rs, yb, M, F, C, round_input, dy);
}
