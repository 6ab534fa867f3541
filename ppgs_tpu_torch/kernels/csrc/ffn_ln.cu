// K4 ffn_residual_ln: out = LN2(res + drop_y(drop_h(act(bf16(x) @ W1 + b1))
// @ W2 + b2)), C = 256, 512 or 768, any F % 128 == 0, act ReLU or the
// tanh-approximate GELU; and, for an FFN that ends without the LayerNorm
// (C = 256 or 512, ReLU), y = drop_y(drop_h(relu(x @ W1 + b1)) @ W2 + b2) in
// bf16.
//
// Replaces four TPU kernels' FFNs, which differ in their rounding points:
// - the FFN half of ppgs_tpu/ops/encoder_layer_kernel.py _layer_body
//   (round_input = 0): h = act(bf16(bf16(x@W1) + bf16(b1))), and the
//   residual res is the fp32 x; act is ReLU for the PPG transformer
//   (encoder_stack; C = 256 mel, C = 512 w2v2fb) and GELU for the
//   wav2vec2 trunk (encoder_stack_streamed, activation='gelu', C = 768,
//   F = 3072);
// - ppgs_tpu/ops/fused_ffn.py _kernel (ffn_residual_layernorm,
//   round_input = 1): h = bf16(relu(x@W1 + b1)) in fp32, and the residual
//   is x rounded to bf16, since that kernel takes a bf16 x (the per-layer
//   path past 1024 frames: C = 256 mel, C = 512 w2v2fb);
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
// and at the w2v2fb head's width (C = 512) 550 GFLOP, ~0.56 ms.
//
// Design, on the wgmma + TMA building blocks of hopper.cuh (as gemm.cu): a
// producer (a warpgroup of its own, or at C = 256 one consumer thread)
// keeps a ring of stages in flight with TMA (128-byte swizzle, full and
// empty mbarriers); two consumer warpgroups each own 64 rows of a 128-row
// block and issue wgmma.mma_async with fp32 accumulators in registers.
// What decides the form is the (rows x C) fp32
// sum of the second product, which a kernel that keeps the hidden on chip
// holds in registers for its whole walk over F:
// - C = 256, one kernel (ffn_fused_kernel): 128 rows fit, 128 accumulator
//   registers a consumer thread, beside the hidden chunk's 32 and its 16
//   bf16 fragments; see the kernel's note. Every weight byte brought on
//   chip serves the block's 128 rows, and the hidden never leaves the SM.
// - C = 512 and 768, two launches: 128 rows would need 256 KB or 384 KB of
//   sum against the SM's 256 KB of registers, so a fused block could own
//   only 64 rows (a weight byte serving 64 rows unless a cluster
//   multicast each stage) and would have to share each hidden chunk
//   between warpgroups through shared memory. Instead:
//   1. ffn_hidden_kernel: h = drop_h(act(x W1 + b1)) in bf16, (M, F), a
//      128 x 256 tile a block (128 x 128 where F % 256 != 0); an fp32 x is
//      TMA'd as it is, and each consumer thread reads its m64k16 fragment
//      from the swizzled tile and rounds it to bf16 (the RS form); a bf16
//      x (ffn_train's form) is the SS form's K-major A; W1 as stored
//      (MN-major). Bias, activation, dropout and the rounding are applied
//      to the accumulators in registers; the train forms also write the
//      hidden's keep words here (WORDS).
//   2. ffn_out_kernel: y = h W2 + b2 on 128 x 256 tiles (h K-major, W2
//      MN-major), then either ffn_train's bf16 y (y_out, no LayerNorm: a
//      block a tile) or the residual, drop_y and the LayerNorm from the
//      accumulators. A row spans C / 256 blocks: they are one
//      thread-block cluster along C and trade each row's partial sums
//      (the sum, then the centred sum of squares) through distributed
//      shared memory, each adding the ranks' sums in rank order, so that
//      every block normalises with the same mean and 1/std.
//   Both launches use 128-row tiles, so every weight byte brought on chip
//   serves 128 rows; the hidden's round trip through memory costs 2 M F x
//   2 bytes, 0.16 ms at the w2v2fb head's shape and 0.09 ms at the
//   trunk's on 3.35 TB/s, against the products' 0.24-0.27 ms bound.
// The dropout masks: a Philox draw covers 4 consecutive columns, and the
// accumulator layout gives a thread 2 adjacent columns of each 8-column
// group for two rows (g and g + 8), so lanes t and t ^ 1 share a group:
// each draws the group of its own row (g for even t, g + 8 for odd) and
// they trade the two words the other needs, one draw per 4 elements. The
// train forms (C = 256 in the fused kernel, C = 512 in the hidden's
// launch) also write the hidden's keep bits for the backward
// (ffn_train.cu), which then draws none: int32 words of shape (M, F / 32),
// bit k of word w for column 32 w + k; a quad's four lanes OR their bits
// into a row's words and each stores one (the WORDS instances; the
// inference instances are compiled without it). The hidden launch's train
// instances (fp32 x with the words, bf16 x with and without them) take
// 113-168 registers a thread and the output launch's y_out form 168, as
// the others, with no spills; the bf16-x hidden's ring holds four 48 KB
// stages (194 KB), the fp32-x one three of 64 KB.
// Rows past M: TMA fills zeros, and no row >= M is written.

#include <type_traits>

#include "residual_ln.cuh"

using ppgs::bf16;
using namespace ppgs::hopper;
using namespace ppgs::residual_ln;

namespace {

constexpr int THREADS = 384;              // producer warpgroup + 2 consumers
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
// (a bf16x2 add of the rounded pairs; the dropout scale in bf16x2)
__device__ __forceinline__ void store_y_out(const float (&acc)[128],
                                            const float* b2, bf16* y_out,
                                            int M, int C, int n0,
                                            long long r0, long long r1, int t,
                                            const ppgs::Dropout& drop) {
  const float sc = ppgs::round_bf16(drop.scale);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
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

// C = 512 and 768, launch 1: h (M, F) bf16 = drop_h(act(x W1 + b1)), a
// BM x BN tile a block; X_F32: x fp32 (rounded in the RS form), else bf16;
// WORDS: write the hidden's keep words to `words`
template <int BN, int ACT, bool ROUND, bool X_F32, bool WORDS>
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
  // b1 in batches of 8 groups, loaded together ahead of their use
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += 8) {
    float2 bias[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      bias[i] = *reinterpret_cast<const float2*>(b1 + n0 + 8 * (j0 + i) +
                                                 2 * t);
    // The batch's 64 columns: two keep words a row
    uint32_t w[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = j0 + i;
      const float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                          acc[4 * j + 3]};
      bool keep[4] = {true, true, true, true};
      if (drop.threshold) keep4(drop, r0, r1, F, n0 + 8 * j, t, keep);
      if constexpr (WORDS) add_keep_bits(w, i, t, keep);
      uint32_t p0, p1;
      hidden4<ACT, ROUND>(p0, p1, v, bias[i], keep, drop);
      store_bf16(h, F, r0, r1, n0 + 8 * j + 2 * t, t, p0, p1, M);
    }
    if constexpr (WORDS)
      store_keep_words(w, words, r0, r1, M, F, (n0 + 8 * j0) / 32, t);
  }
}

// C = 512 and 768, launch 2: y = h W2 + b2 on a BM x 256 tile a block, then
// (LN) out = LN2(res + drop_y(y)) over the cluster's C / 256 blocks, with
// the normalised rows and 1/std where n_out and rstd are not null, or (!LN,
// one block a cluster) ffn_train's y_out = drop_y(bf16(bf16(y) + bf16(b2)))
template <bool LN>
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
                             n0);
    if constexpr (!LN) return;
  } else {
    consume<false, OUT_BN>(acc, ring, full, empty, F / BK, c, warp, lane);
  }
  if constexpr (!LN) {
    store_y_out(acc, b2, y_out, M, C, n0, r0, r0 + 8, t, drop);
    return;
  }
  __syncwarp();   // the producer's warp meets the cluster barriers whole

  // Every thread of every block of the cluster takes part in the
  // epilogue's barriers; the producer warpgroup has nothing else to do
  residual_ln(acc, wg != 0, sums, x, b2, gamma, beta, out, n_out, rstd, M, C,
              n0, lr0, r0, t, round_input, drop, blockIdx.x == 0);
  cg::this_cluster().sync();   // no block leaves while a peer reads its sums
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
// (M, F) bf16 scratch for the hidden at C = 512 and 768 (unused, may be
// null, at C = 256); F % 128 == 0; act 0 = ReLU, 1 = tanh-GELU. With y_out
// null: x fp32, gamma/beta (C) fp32 -> out (M, C) fp32, and n_out (M, C)
// and rstd (M) fp32 unless null; (C, act) is (256, ReLU), (512, ReLU) or
// (768, GELU), the widths of the models. With y_out (C = 256 or 512,
// ReLU, round_input 0): x bf16 -> y_out (M, C) bf16 (gamma, beta, out,
// n_out and rstd unused). The hidden's dropout site is (seed, site_h), the
// output's (seed, site_y); threshold 0 turns both off. keep_out (M, F /
// 32) int32, or null: the hidden's keep words (the train forms: ReLU,
// round_input 0, threshold != 0). One kernel at C = 256, two on the
// stream (the hidden's, then the output's) at 512 and 768. Any other (C,
// act), or keep_out where it cannot be written, returns
// cudaErrorInvalidValue.
extern "C" int ppgs_ffn_ln(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* gamma,
                           const void* beta, void* out, void* n_out,
                           void* rstd, void* y_out, void* h, void* keep_out,
                           int M, int F, int C, int act, int round_input,
                           unsigned seed_lo, unsigned seed_hi,
                           unsigned site_h, unsigned site_y,
                           unsigned threshold, float scale, void* stream) {
  const bool ln = y_out == nullptr, fused = C == FUSED_C;
  const bool width_ok =
      ln ? (C == 256 && act == RELU) || (C == 512 && act == RELU) ||
               (C == 768 && act == GELU)
         : (C == 256 || C == 512) && act == RELU && !round_input;
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
  int err;
  if (!ln)
    err = words ? launch_hidden<RELU, false, false, true>(
                      mx, mw1, b1f, hb, words, M, F, C, dh, m_tiles, s)
                : launch_hidden<RELU, false, false>(mx, mw1, b1f, hb, words,
                                                    M, F, C, dh, m_tiles, s);
  else if (words)
    err = launch_hidden<RELU, false, true, true>(mx, mw1, b1f, hb, words, M,
                                                 F, C, dh, m_tiles, s);
  else if (act == GELU)
    err = round_input ? launch_hidden<GELU, true>(mx, mw1, b1f, hb, words, M,
                                                  F, C, dh, m_tiles, s)
                      : launch_hidden<GELU, false>(mx, mw1, b1f, hb, words,
                                                   M, F, C, dh, m_tiles, s);
  else
    err = round_input ? launch_hidden<RELU, true>(mx, mw1, b1f, hb, words, M,
                                                  F, C, dh, m_tiles, s)
                      : launch_hidden<RELU, false>(mx, mw1, b1f, hb, words,
                                                   M, F, C, dh, m_tiles, s);
  if (err) return err;
  const float* xf = static_cast<const float*>(x);
  bf16* yb = static_cast<bf16*>(y_out);
  if (!ln)
    return launch(ffn_out_kernel<false>, THREADS, Ring<false, OUT_BN>::SMEM,
                  dim3(C / OUT_BN, m_tiles), 1, s, mh, mw2, xf, b2f, g, be,
                  o, n, rs, yb, M, F, C, round_input, dy);
  return launch(ffn_out_kernel<true>, THREADS, Ring<false, OUT_BN>::SMEM,
                dim3(C / OUT_BN, m_tiles), C / OUT_BN, s, mh, mw2, xf, b2f, g,
                be, o, n, rs, yb, M, F, C, round_input, dy);
}
