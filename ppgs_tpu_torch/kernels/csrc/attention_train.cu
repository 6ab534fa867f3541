// Attention for training: masked multi-head attention with dropout on the
// normalised probabilities (the forward), and the row products its
// backward needs (row_dot); read in place from (B, T, C) layouts, d_head =
// 128 (the mel model) or 256 (the w2v2fb and w2v2fc heads), one template
// instance each, and any d_head % 128 == 0 from 384 to 2048 through the
// wide route (fwd_wide_kernel, below). The backward itself is
// attention_train_bwd.cu.
//
// Replaces: ppgs_tpu/ops/flash_attention.py flash_attention_train
// (_train_fwd_kernel, pallas_call at :576) and the attention forward
// inside ppgs_tpu/ops/encoder_layer_train.py (_fwd_compute's per-head
// loop, pallas_call at :471).
//
// The function and its rounding points (those of the JAX kernels and of
// the plain version, ops/flash_attention.py attention_train_fwd_reference):
// s = q.k in fp32 times scale_log2, the key mask and the causal mask
// applied before the row max; lse = m + log2(l) per row in log2 units (0
// on a row with no valid key, whose o is then 0); p is normalised BEFORE it
// is rounded, pn = exp2(s - lse) in fp32 over the valid keys, pd = keep ?
// pn / (1 - rate) : 0 rounded to bf16 for the PV product, summed in fp32.
// Outputs: o in bf16 (the fp32 sum rounded), o in fp32 where asked (the
// whole-layer backward takes rowsum(da * a) with it), lse (B, H, T), and
// with dropout the keep words: bit k of word w of a query row is key 32 w
// + k, valid and kept, 2 ceil(T / 64) words a row (0 where no pair is
// valid), which attention_train_bwd reads instead of drawing the bits
// again. The keep bit of a pair is Philox4x32-10 over the flat index
// (bh T + q) T + key (philox.cuh). T <= 1024 (the train paths' limit).
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s) at the training shape
// (256 windows x T = 512, 2 heads of 128, ragged: about 3/4 of the pairs
// valid): the two products over the valid pairs, 4 x pairs x 128 = 0.05
// TFLOP (0.05 ms), against 0.42 GB moved (q, k, v in; o in bf16 and fp32,
// lse and 16.8 MB of keep words out): 0.125 ms, bound by the bytes. On
// the card the integer work of the keep bits comes next: one Philox call
// (10 rounds of two 32-bit multiplies, high and low) per group of four
// pairs, about 25 M calls a launch.
//
// At d_head 256 (the w2v2fb head: 256 windows x T = 512, 2 heads of 256)
// the two products are 4 x pairs x 256 = 0.10 TFLOP (0.10 ms) against
// 0.82 GB moved: 0.245 ms, bound by the bytes.
//
// Design: K2's (attention.cu) on the blocks of hopper.cuh. One block per
// (128 query rows, head, window); WGS = 2 consumer warpgroups of 64 rows,
// 256 threads, two blocks an SM at d_head 128 (ptxas then keeps a thread to
// 128 registers and spills a few bytes) and one at 256, as K2 holds it: O
// is 64 x 256 fp32 a warpgroup, 128 registers a thread beside S's 32 and
// the fragments' 16, and Q (64 KB) with two 64 KB stages and the keep
// words fills 209 KB of shared memory (ptxas: 194, 235 and 251 registers
// a thread without dropout, with it, and with it at T % 4 != 0; no
// spills). Q arrives once by TMA; K, and in the
// second pass K and V, arrive as 64-key tiles through 3-D tensor maps (d,
// T, window: a head's columns through the fused-QKV row stride, zeros past
// T) into a ring of two 32 KB stages with full and empty mbarriers: thread
// 0 fills it, and the last of the block's warps to release a stage refills
// it. The stage sequence is fixed, so both warpgroups walk every slot in
// order: the K tiles two to a stage (its K and V halves), then the (K, V)
// tiles.
// - The block first reads its window's mask once, as one 64-bit word a key
//   tile in shared memory; the tiles past the window's last valid key (and,
//   under causal, past the block's last row) are not loaded, and a tile
//   whose keys are all masked for a warpgroup is skipped by it: a wholly
//   masked window loads nothing and writes zeros.
// - Pass 1, per tile and warpgroup: S = Q K^T by m64n64k16 SS wgmma into
//   registers, then the masks and the online row max m and sum l.
// - Pass 2: S again (the same products, so the same bits); while the
//   tensor cores run, the keep bits of the tile (below); then pd packed
//   straight from S's accumulators into the RS A fragments of O += Pd V
//   (V the MN-major B operand), O (64 x 128 fp32) in registers.
// - The keep bits, drawn with no call wasted. A thread holds rows g and g
//   + 8 and keys 8j + 2t, 8j + 2t + 1 of a tile, so lanes t = 0, 1 of a
//   quad share the group of keys 8j .. 8j + 3 in both rows and lanes 2, 3
//   the group 8j + 4 .. 8j + 7: the even lane of a pair draws row g's
//   group, the odd lane row g + 8's, and one shuffle a tile hands each its
//   two bits of the other row (one call per four pairs). Where T % 4 != 0
//   a group crosses a row's end and does not line up with the keys: that
//   instance draws each pair's group itself (a call per one or two pairs;
//   it spills, and serves odd windows only). The bits become a row's two
//   words of the tile by two shuffles a word, masked with the key mask and
//   the causal diagonal, and wait in shared memory (128 rows x 2 ceil(T /
//   64) words): pass 2 reads its own bits from there, the epilogue the
//   words.
// - The epilogue: lse; the keep words by coalesced 8-byte stores of the
//   warpgroup's rows; o staged, swizzled, in the warpgroup's rows of the Q
//   tile and written by TMA stores of whole 128-byte rows (none past T):
//   the fp32 copy in two halves of 64 columns, then the bf16.
//
// What bounds it on the card (scripts/torch_attention_fwd_probe.py, which
// builds the variants named here beside this source and times them; the
// forward's findings in PERF.md section 6). A walk that loads every tile
// and writes the outputs but computes nothing takes about 1.25x the byte
// bound and 45% of the kernel's time; the products and the softmax bring
// it to two thirds, and the keep bits take the last third: Philox's 40
// multiplies a call are integer work that the S product hides only in
// part. Tried and dropped: drawing the bits in pass 1 (about 5% slower:
// pass 1's product is too short to hide them), one K tile a stage in pass
// 1 (2-5% slower with the dropout off), one block of 4 warpgroups (256
// rows, half the L2 stream of K and V; no faster, with 2 or 3 stages: the
// stream is not the limit), 3 or 4 stages with one block an SM (16-23%
// slower: no second block overlaps a block's prologue and epilogue).
//
// At d_head 256 (one block an SM) the probe's loads-only walk takes
// 0.31-0.33 ms, 1.3x the byte bound; the products and the softmax add
// about 0.17 ms and the keep bits 0.10, as if nothing overlapped. There
// the keep bits are drawn in pass 1 (DRAW256_IN_PASS2), under its two
// tiles' products: 1-2% faster than in pass 2, the same bits. Each of
// these kept the bits and was no faster (probe, dropout 0.1, device ms
// against the pass-2 form's 0.586-0.595 in the same call): blocks 2i and
// 2i + 1 a cluster sharing each K and V tile by TMA multicast with a ring
// of four single tiles (0.631); blocks of 64 rows, two an SM, in such
// pairs (0.632; one an SM 0.962); pass 1 with two tiles' scores in flight
// (0.661: ptxas serialised the products, C7514); pass 1's product from Q
// in registers (0.598); the two warpgroups' score products in turns
// through named barriers (0.698); o staged all at once in the idle ring
// with one wait (0.621); and a ring of four single tiles with pass 1
// pipelined and pass 2 issuing tile i + 1's scores before tile i's PV
// (1.056 with the dropout, 0.593 without against 0.484).

#include "attention_wide.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"
#include "residual_ln.cuh"

using namespace ppgs::hopper;
using ppgs::bf16;

namespace {

constexpr int WGS = 2;              // consumer warpgroups a block
constexpr int BQ = 64 * WGS, BKV = 64;   // query rows a block, keys a tile
constexpr int THREADS = 128 * WGS, WARPS = THREADS / 32;
constexpr int ATOM = 64;            // bf16 columns of a 128-byte swizzle atom
constexpr int MAX_T = 1024;         // keys a window at most
constexpr int MAX_TILES = MAX_T / BKV;
// The plan's choices, each timed against its alternative (see above)
constexpr bool DRAW_IN_PASS2 = true;   // which pass draws the keep bits
constexpr bool DRAW256_IN_PASS2 = false;   // and at d_head 256
constexpr int PASS1_TILES = 2;         // K tiles a stage holds in pass 1
static_assert(PASS1_TILES == 1 || PASS1_TILES == 2, "a stage holds 2 tiles");

// The shared-memory plan of the forward for head width D: Q, the ring,
// the key tiles' mask words, full[], empty[], the Q barrier and the release
// counters, then the keep words (BQ rows of `words`), and slack to align Q
// to 1024 bytes
template <int D>
struct Plan {
  static constexpr int STAGES = 2;
  static constexpr int BLOCKS = D == 256 ? 1 : 4 / WGS;   // blocks an SM
  static constexpr bool DRAW2 = D == 256 ? DRAW256_IN_PASS2 : DRAW_IN_PASS2;
  static constexpr int ATOMS = D / ATOM;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int STAGE = 2 * KV_BYTES;       // K, then V
  static constexpr int VALID = Q_BYTES + STAGES * STAGE;
  static constexpr int BARS = VALID + MAX_TILES * 8;
  static constexpr int KEEP = BARS + ((2 * STAGES + 1) * 8 + STAGES * 4 + 15)
                                         / 16 * 16;
  static constexpr int smem(int words) { return KEEP + BQ * words * 4 + 1024; }
};
template <int D>
constexpr bool plan_fits() {
  return Plan<D>::smem(2 * MAX_TILES) <= 232448 &&
         Plan<D>::BLOCKS * (Plan<D>::smem(16) + 1024) <= 233472;
}
static_assert(plan_fits<128>() && plan_fits<256>(),
              "more shared memory than a block may have, or at T = 512 the "
              "blocks an SM should hold do not fit");

constexpr float MINUS_INF = -__builtin_huge_valf();

// The keep bits of a thread's 32 pairs of the key tile at k0: bit 2j + e of
// b0 (b1) for register 4j + e (4j + 2 + e), row r0 (r1), key k0 + 8j + 2t +
// e % 2. base0, base1: the flat index of (r0, key 0) and (r1, key 0).
// ALIGNED (T % 4 == 0): the even lane of a pair draws row r0's group of
// four keys, the odd lane row r1's, and one shuffle swaps the halves
template <bool ALIGNED>
__device__ __forceinline__ void keep_bits(const ppgs::Dropout& d,
                                          unsigned long long base0,
                                          unsigned long long base1, int k0,
                                          int t, uint32_t& b0, uint32_t& b1) {
  if constexpr (ALIGNED) {
    const bool odd = t & 1;
    const unsigned long long group =
        ((odd ? base1 : base0) + k0 + 4 * (t >> 1)) >> 2;
    uint32_t own = 0u, send = 0u;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      const unsigned long long n = group + 2 * j;
      const uint4 w = ppgs::philox4x32_10(
          make_uint4(static_cast<uint32_t>(n), static_cast<uint32_t>(n >> 32),
                     d.site, 0u),
          d.seed_lo, d.seed_hi);
      const uint32_t lo = (w.x >= d.threshold) | (w.y >= d.threshold) << 1;
      const uint32_t hi = (w.z >= d.threshold) | (w.w >= d.threshold) << 1;
      own |= (odd ? hi : lo) << (2 * j);
      send |= (odd ? lo : hi) << (2 * j);
    }
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, 1);
    b0 = odd ? got : own;
    b1 = odd ? own : got;
  } else {
    ppgs::KeepStream s0(d), s1(d);
    b0 = b1 = 0u;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        b0 |= static_cast<uint32_t>(s0.keep(base0 + key)) << (2 * j + e);
        b1 |= static_cast<uint32_t>(s1.keep(base1 + key)) << (2 * j + e);
      }
  }
}

// A row's 64 keep bits of a tile (bit k: key k0 + k) from the quad's
// 16-bit shares (bit 2j + e of lane t: key 8j + 2t + e)
__device__ __forceinline__ uint64_t quad_word(uint32_t bits, int t) {
  uint64_t w = 0;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
    w |= static_cast<uint64_t>((bits >> (2 * j)) & 3u) << (8 * j);
  w <<= 2 * t;
  uint32_t lo = static_cast<uint32_t>(w), hi = static_cast<uint32_t>(w >> 32);
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    lo |= __shfl_xor_sync(0xffffffffu, lo, x);
    hi |= __shfl_xor_sync(0xffffffffu, hi, x);
  }
  return lo | static_cast<uint64_t>(hi) << 32;
}

// The keys of a tile at k0 not above the causal diagonal of row r
__device__ __forceinline__ uint64_t below_diagonal(int r, int k0) {
  const int d = r - k0;
  return d < 0 ? 0ull : d >= BKV - 1 ? ~0ull : (2ull << d) - 1;
}

// S (64 x 64 fp32) += the warpgroup's Q rows times a K tile's keys, both
// K-major over d: 32 bytes of a 128-byte row a step, the next 64 columns
// one atom on
template <int D>
__device__ __forceinline__ void scores(float (&sc)[BKV / 2], uint32_t q_addr,
                                       uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BKV, 0, 0>(
        sc, sw128_desc(q_addr + (kk / 4) * (BQ * 128) + (kk % 4) * 32, 16,
                       1024),
        sw128_desc(k_addr + (kk / 4) * (BKV * 128) + (kk % 4) * 32, 16,
                   1024));
}

// The keep bits of key tile i into rows r0, r1's words (keep0[i],
// keep1[i], by lanes t = 0 and 1 of the quad): the valid pairs only
template <bool ALIGNED>
__device__ __forceinline__ void draw_keep(const ppgs::Dropout& d,
                                          unsigned long long base0,
                                          unsigned long long base1, int r0,
                                          int r1, int t, int causal, int i,
                                          uint64_t valid, uint2* keep0,
                                          uint2* keep1) {
  const int k0 = i * BKV;
  uint32_t b0, b1;
  keep_bits<ALIGNED>(d, base0, base1, k0, t, b0, b1);
  const uint64_t w0 = quad_word(b0, t) & valid &
                      (causal ? below_diagonal(r0, k0) : ~0ull);
  const uint64_t w1 = quad_word(b1, t) & valid &
                      (causal ? below_diagonal(r1, k0) : ~0ull);
  if (t == 0) keep0[i] = make_uint2(static_cast<uint32_t>(w0),
                                    static_cast<uint32_t>(w0 >> 32));
  if (t == 1) keep1[i] = make_uint2(static_cast<uint32_t>(w1),
                                    static_cast<uint32_t>(w1 >> 32));
}

// Pass 1 on one tile's S (64 x 64 fp32, a thread's rows r0 and r1 = r0 +
// 8 of the warp's 16 from warp_row): the key mask `valid` (bit k for key
// k0 + k) and the causal one where the tile reaches past the diagonal of
// one of the warp's rows, masked scores -inf; then the row max m and the
// sum l of exp2(s - m), online over the tiles
__device__ __forceinline__ void row_stats(float (&sc)[BKV / 2],
                                          uint64_t valid, int k0,
                                          int warp_row, int r0, int r1,
                                          int t, int causal,
                                          float scale_log2, float& m0,
                                          float& m1, float& l0, float& l1) {
  if (valid != ~0ull || (causal && k0 + BKV - 1 > warp_row)) {
    const uint64_t bits = valid >> (2 * t);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        const bool ok = (bits >> (8 * j + e)) & 1u;
        if (!ok || (causal && key > r0)) sc[4 * j + e] = MINUS_INF;
        if (!ok || (causal && key > r1)) sc[4 * j + 2 + e] = MINUS_INF;
      }
  }
  float x0 = MINUS_INF, x1 = MINUS_INF;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  const float n0 = fmaxf(m0, quad_max(x0) * scale_log2);
  const float n1 = fmaxf(m1, quad_max(x1) * scale_log2);
  // A row with no valid key yet keeps m = -inf: subtract 0 instead, so
  // that its terms and its correction are exp2(-inf) = 0, not NaN
  const float u0 = n0 == MINUS_INF ? 0.f : n0;
  const float u1 = n1 == MINUS_INF ? 0.f : n1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    ps0 += exp2_approx(fmaf(sc[4 * j], scale_log2, -u0)) +
           exp2_approx(fmaf(sc[4 * j + 1], scale_log2, -u0));
    ps1 += exp2_approx(fmaf(sc[4 * j + 2], scale_log2, -u1)) +
           exp2_approx(fmaf(sc[4 * j + 3], scale_log2, -u1));
  }
  l0 = l0 * exp2_approx(m0 - u0) + ps0;
  l1 = l1 * exp2_approx(m1 - u1) + ps1;
  m0 = n0, m1 = n1;
}

// Pass 2's pd of group j of a tile (an accumulator's registers 4j .. 4j
// + 3, s: keys 8j + 2t and 8j + 2t + 1 of row r0, then of row r1) as two
// bf16 pairs, row r0's then row r1's. full_tile: no key of the tile is
// masked for the warp's rows; bits: the tile's valid keys shifted to this
// lane's. DROP: kw0 and kw1 are rows r0 and r1's keep words of the tile,
// shifted to this lane's keys (they hold the masks too)
template <bool DROP>
__device__ __forceinline__ uint2 pd_group(float4 s, int j, bool full_tile,
                                          uint64_t bits, int k0, int r0,
                                          int r1, int t, int causal,
                                          float scale_log2, float lse0,
                                          float lse1, uint64_t kw0,
                                          uint64_t kw1, float drop_scale) {
  const float sv[4] = {s.x, s.y, s.z, s.w};
  float p[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float pn =
        exp2_approx(fmaf(sv[e], scale_log2, e < 2 ? -lse0 : -lse1));
    const int shift = 8 * j + e % 2;
    if constexpr (DROP) {
      const bool keep = ((e < 2 ? kw0 : kw1) >> shift) & 1u;
      p[e] = keep ? pn * drop_scale : 0.f;
    } else {
      const int key = k0 + 8 * j + 2 * t + e % 2;
      const int row = e < 2 ? r0 : r1;
      const bool ok = full_tile || (((bits >> shift) & 1u) &&
                                    !(causal && key > row));
      p[e] = ok ? pn : 0.f;
    }
  }
  return make_uint2(pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]));
}

// Whether a tile at k0 has no masked key for the warp's rows (from
// warp_row), and its valid keys shifted to this lane's (pd_group's)
__device__ __forceinline__ bool full_tile_of(uint64_t valid, int k0,
                                             int warp_row, int causal) {
  return valid == ~0ull && !(causal && k0 + BKV - 1 > warp_row);
}

// Pass 2's pd of one tile, packed into the A fragments of O += Pd V: a[k]
// holds keys 16k .. 16k + 15, groups j = 2k (registers 0, 1) and 2k + 1
// (2, 3); as pd_group
template <bool DROP>
__device__ __forceinline__ void pd_frags(
    const float (&sc)[BKV / 2], uint32_t (&a)[BKV / 16][4], uint64_t valid,
    int k0, int warp_row, int r0, int r1, int t, int causal,
    float scale_log2, float lse0, float lse1, uint64_t kw0, uint64_t kw1,
    float drop_scale) {
  const bool full_tile = full_tile_of(valid, k0, warp_row, causal);
  const uint64_t bits = valid >> (2 * t);
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    const uint2 u = pd_group<DROP>(
        make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]),
        j, full_tile, bits, k0, r0, r1, t, causal, scale_log2, lse0, lse1,
        kw0, kw1, drop_scale);
    a[j / 2][2 * (j % 2)] = u.x;
    a[j / 2][2 * (j % 2) + 1] = u.y;
  }
}

// DROP: dropout on (threshold != 0), keep_out its words; ALIGNED: T % 4 ==
// 0 (see keep_bits)
template <int D, bool DROP, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, Plan<D>::BLOCKS)
fwd_kernel(const __grid_constant__ CUtensorMap map_q,
           const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v,
           const __grid_constant__ CUtensorMap map_o16,
           const __grid_constant__ CUtensorMap map_o32,
           const uint8_t* __restrict__ mask, float* __restrict__ lse,
           uint32_t* __restrict__ keep_out, int T, int H, float scale_log2,
           int causal, ppgs::Dropout drop, int want32) {
  using P = Plan<D>;
  constexpr int STAGES = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = sq + P::Q_BYTES;
  uint64_t* tile_valid = reinterpret_cast<uint64_t*>(sq + P::VALID);
  uint64_t* full = reinterpret_cast<uint64_t*>(sq + P::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;
  int* released = reinterpret_cast<int*>(q_bar + 1);
  uint32_t* skeep = reinterpret_cast<uint32_t*>(sq + P::KEEP);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int col0 = h * D;
  const long long row_base = static_cast<long long>(b * H + h) * T;
  const int key_tiles = (T + BKV - 1) / BKV, words = 2 * key_tiles;
  const int warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint8_t* mrow = mask + static_cast<long long>(b) * T;

  // The window's valid keys, a word a key tile (bit k: key 64 i + k), and
  // the keep words zeroed
  for (int i = warp_id; i < key_tiles; i += WARPS) {
    const int key = i * BKV + lane;
    const uint64_t bits =
        __ballot_sync(0xffffffffu, key < T && mrow[key] != 0) |
        static_cast<uint64_t>(
            __ballot_sync(0xffffffffu, key + 32 < T && mrow[key + 32] != 0))
            << 32;
    if (lane == 0) tile_valid[i] = bits;
  }
  if constexpr (DROP)
    for (int i = threadIdx.x; i < BQ * words; i += THREADS) skeep[i] = 0u;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    mbar_init_ring(full, empty, STAGES, WARPS);   // every warp releases
    for (int s = 0; s < STAGES; ++s) released[s] = 0;
  }
  __syncthreads();
  // The key tiles walked: up to the window's last valid key, and under
  // causal up to the block's last row; twice, K alone then K and V
  int tiles = 0;
  for (int i = 0; i < key_tiles; ++i)
    if (tile_valid[i]) tiles = i + 1;
  if (causal) tiles = min(tiles, (min(q0 + BQ, T) - 1) / BKV + 1);
  const int groups = (tiles + PASS1_TILES - 1) / PASS1_TILES;
  const int items = groups + tiles;

  // Item n of the ring into stage n % STAGES: the K of key tiles
  // PASS1_TILES n onwards, in the stage's K and V halves; from n = groups
  // on, tile n - groups' K and V
  auto load = [&](int n) {
    const int s = n % STAGES;
    const uint32_t bar = smem_addr(full + s);
    unsigned char* st = ring + s * P::STAGE;
    const int i = n < groups ? PASS1_TILES * n : n - groups;
    const int ks = n < groups ? min(PASS1_TILES, tiles - i) : 1;
    mbar_expect_tx(bar, n < groups ? ks * P::KV_BYTES : P::STAGE);
    for (int u = 0; u < ks; ++u)
#pragma unroll
      for (int j = 0; j < P::ATOMS; ++j)
        tma_load_3d(st + u * P::KV_BYTES + j * BKV * 128, &map_k,
                    col0 + j * ATOM, (i + u) * BKV, b, bar);
    if (n >= groups)
#pragma unroll
      for (int j = 0; j < P::ATOMS; ++j)
        tma_load_3d(st + P::KV_BYTES + j * BKV * 128, &map_v,
                    col0 + j * ATOM, i * BKV, b, bar);
  };
  if (threadIdx.x == 0 && tiles > 0) {
    const uint32_t qb = smem_addr(q_bar);
    mbar_expect_tx(qb, P::Q_BYTES);
#pragma unroll
    for (int j = 0; j < P::ATOMS; ++j)
      tma_load_3d(sq + j * BQ * 128, &map_q, col0 + j * ATOM, q0, b, qb);
    for (int n = 0; n < STAGES && n < items; ++n) load(n);
  }
  // A warp is done with item n's stage; the last of the warps to release
  // it refills it
  auto release = [&](int n) {
    const int s = n % STAGES;
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(smem_addr(empty + s));
      if (n + STAGES < items &&
          atomicAdd(released + s, 1) % WARPS == WARPS - 1) {
        mbar_wait(smem_addr(empty + s), (n / STAGES) & 1);
        load(n + STAGES);
      }
    }
    __syncwarp();
  };

  // Warpgroup c owns the block's rows 64c .. 64c + 63; a thread rows r0, r1
  const int c = threadIdx.x / 128, warp = warp_id % 4;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row = q0 + 64 * c, warp_row = wg_row + 16 * warp;
  const int r0 = warp_row + g, r1 = r0 + 8;
  // Its tiles: under causal, up to the one holding its last row's diagonal
  const int wg_tiles =
      wg_row >= T ? 0 : causal ? min(tiles, (wg_row + 63) / BKV + 1) : tiles;
  const uint32_t q_addr = smem_addr(sq) + c * 64 * 128;
  const uint32_t ring_addr = smem_addr(ring);
  const unsigned long long base0 =
      static_cast<unsigned long long>(row_base + r0) * T;
  const unsigned long long base1 = base0 + 8ull * T;
  // Rows r0, r1's keep words, two a tile, in shared memory
  uint2* keep0 = reinterpret_cast<uint2*>(skeep + (r0 - q0) * words);
  uint2* keep1 = reinterpret_cast<uint2*>(skeep + (r1 - q0) * words);

  // The keep bits of tile i into rows r0, r1's words: the valid pairs only
  auto draw = [&](int i, uint64_t valid) {
    draw_keep<ALIGNED>(drop, base0, base1, r0, r1, t, causal, i, valid,
                       keep0, keep1);
  };

  if (tiles > 0) mbar_wait(smem_addr(q_bar), 0);

  // Pass 1 on key tile i, its K at k_addr: the row max m and sum l of
  // exp2(s - m), online over the tiles
  float m0 = MINUS_INF, m1 = MINUS_INF, l0 = 0.f, l1 = 0.f;
  auto pass1 = [&](int i, uint32_t k_addr) {
    const int k0 = i * BKV;
    const uint64_t valid = tile_valid[i];
    const bool live = i < wg_tiles && valid != 0;
    if (!live) return;
    float sc[BKV / 2];
    zero(sc);
    wgmma_fence();
    scores<D>(sc, q_addr, k_addr);
    wgmma_commit();
    if constexpr (DROP && !P::DRAW2) draw(i, valid);
    wgmma_wait<0>();
    fence_regs(sc);
    row_stats(sc, valid, k0, warp_row, r0, r1, t, causal, scale_log2, m0,
              m1, l0, l1);
  };
  for (int n = 0; n < groups; ++n) {
    const int s = n % STAGES;
    mbar_wait(smem_addr(full + s), (n / STAGES) & 1);
#pragma unroll
    for (int u = 0; u < PASS1_TILES; ++u)
      if (PASS1_TILES * n + u < tiles)
        pass1(PASS1_TILES * n + u,
              ring_addr + s * P::STAGE + u * P::KV_BYTES);
    release(n);
  }
  l0 = quad_sum(l0), l1 = quad_sum(l1);
  const float lse0 = l0 > 0.f ? m0 + log2f(l0) : 0.f;
  const float lse1 = l1 > 0.f ? m1 + log2f(l1) : 0.f;

  // Pass 2: o = sum over keys of bf16(keep ? exp2(s - lse) / (1 - rate) :
  // 0) v
  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  for (int i = 0; i < tiles; ++i) {
    const int n = groups + i, s = n % STAGES, k0 = i * BKV;
    const uint64_t valid = tile_valid[i];
    const bool live = i < wg_tiles && valid != 0;
    mbar_wait(smem_addr(full + s), (n / STAGES) & 1);
    if (live) {
      const uint32_t k_addr = ring_addr + s * P::STAGE;
      const uint32_t v_addr = k_addr + P::KV_BYTES;
      float sc[BKV / 2];
      zero(sc);
      wgmma_fence();
      scores<D>(sc, q_addr, k_addr);
      wgmma_commit();
      if constexpr (DROP && P::DRAW2) draw(i, valid);
      __syncwarp();
      // rows r0, r1's keep bits of the tile, shifted to this lane's keys
      uint64_t kw0 = ~0ull, kw1 = ~0ull;
      if constexpr (DROP) {
        const uint2 a0 = keep0[i], a1 = keep1[i];
        kw0 = (a0.x | static_cast<uint64_t>(a0.y) << 32) >> (2 * t);
        kw1 = (a1.x | static_cast<uint64_t>(a1.y) << 32) >> (2 * t);
      }
      wgmma_wait<0>();
      fence_regs(sc);
      uint32_t a[BKV / 16][4];
      pd_frags<DROP>(sc, a, valid, k0, warp_row, r0, r1, t, causal,
                     scale_log2, lse0, lse1, kw0, kw1, drop.scale);

#pragma unroll
      for (int k = 0; k < BKV / 16; ++k) fence_regs(a[k]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BKV / 16; ++k)
        wgmma_rs<D>(o, a[k], sw128_desc(v_addr + k * 2048, BKV * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int k = 0; k < BKV / 16; ++k) fence_regs(a[k]);
    }
    release(n);
  }

  // The epilogue: lse, the keep words of the warpgroup's rows, then o out
  // of its rows of the Q tile (its last product is done, and the other
  // warpgroup reads only its own rows)
  if (t == 0) {
    if (r0 < T) lse[row_base + r0] = lse0;
    if (r1 < T) lse[row_base + r1] = lse1;
  }
  if constexpr (DROP) {
    bar_sync(1 + c, 128);
    const int n = max(0, min(64, T - wg_row)) * words / 2;
    const uint2* src = reinterpret_cast<const uint2*>(skeep + 64 * c * words);
    uint2* dst = reinterpret_cast<uint2*>(keep_out + (row_base + wg_row) *
                                                         words);
    for (int e = threadIdx.x % 128; e < n; e += 128) dst[e] = src[e];
  }
  auto box = [&](int n) { return sq + n * (BQ * 128) + c * 64 * 128; };
  const bool lead = threadIdx.x % 128 == 0;
  if (want32) {
    stage_f32<D, 0, D / 16>(o, box, warp, g, t);
    store_boxes(&map_o32, P::ATOMS, 32, box, col0, wg_row, b, c, lead, T);
    stage_f32<D, D / 16, D / 8>(o, box, warp, g, t);
    store_boxes(&map_o32, P::ATOMS, 32, box, col0 + D / 2, wg_row, b, c,
                lead, T);
  }
  stage_bf16<D>(o, box, warp, g, t);
  store_boxes(&map_o16, P::ATOMS, ATOM, box, col0, wg_row, b, c, lead, T);
}

template <int D, bool DROP, bool ALIGNED>
int launch_fwd(const CUtensorMap* maps, const void* mask, void* lse,
               void* keep, int B, int T, int H, float scale_log2, int causal,
               const ppgs::Dropout& drop, int want32, cudaStream_t stream) {
  using P = Plan<D>;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_kernel<D, DROP, ALIGNED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem(2 * MAX_TILES));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int smem = P::smem(DROP ? 2 * ((T + BKV - 1) / BKV) : 0);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  fwd_kernel<D, DROP, ALIGNED><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const uint8_t*>(mask), static_cast<float*>(lse),
      static_cast<uint32_t*>(keep), T, H, scale_log2, causal, drop, want32);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ wide route

namespace wide = ppgs::wide;

// The forward at d_head % 128 == 0 from 384 to 2048 (attention_wide.cuh):
// a cluster of wide::ranks(d) blocks owns 128 query rows of a head, rank
// r the head's columns from 256 r on (256, or 128 in a last rank). The
// rank's Q columns of the block's rows stay in shared memory; a ring of
// one K item (the key tile's rank columns) serves both passes, and one of
// one V item pass 2; the ranks' partial S add up through the cluster sum
// once a tile and pass, so S's products are done twice a head, as the
// instances do. Every rank draws the keep bits of its 128 rows (the same
// Philox bits: the index does not depend on the rank) in pass 1, while
// its peers' partials come in and before O takes its registers; in pass
// 2 the owner of each slot of S turns its sums into pd (pd_group) and the
// ranks gather pd in bf16 (Exchange::get_packed). Rank 0 writes lse and
// the keep words. O is 64 x 256 fp32 a warpgroup in registers, staged at
// the end over the resident Q. Q, the two items, the two 32 KB exchange
// buffers and the keep words (16 KB at T = 1024): one block an SM.
struct WidePlan {
  static constexpr int Q_BYTES = BQ * wide::RANK_COLS * 2;
  static constexpr int ITEM = BKV * wide::RANK_COLS * 2;
  static constexpr int K_RING = Q_BYTES, V_RING = K_RING + ITEM;
  static constexpr int PARTIALS = V_RING + ITEM;
  static constexpr int VALID = PARTIALS + 2 * wide::PARTIAL;
  static constexpr int BARS = VALID + MAX_TILES * 8;
  static constexpr int V_BARS = BARS + wide::Ring::bytes(1);
  static constexpr int Q_BAR = V_BARS + wide::Ring::bytes(1);
  static constexpr int KEEP = (Q_BAR + 8 + 15) / 16 * 16;
  static constexpr int smem(int words) { return KEEP + BQ * words * 4 + 1024; }
  static_assert(2 * 64 * wide::RANK_COLS * 2 <= Q_BYTES,
                "O's staging does not fit");
};
static_assert(WidePlan::smem(2 * MAX_TILES) <= 232448,
              "more shared memory than a block may have");

template <bool DROP, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 1)
fwd_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_o16,
                const __grid_constant__ CUtensorMap map_o32,
                const uint8_t* __restrict__ mask, float* __restrict__ lse,
                uint32_t* __restrict__ keep_out, int T, int H, int D,
                float scale_log2, int causal, ppgs::Dropout drop,
                int want32) {
  using P = WidePlan;
  constexpr int RC = wide::RANK_COLS, SLOTS = wide::SLOTS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = wide::aligned_smem(smem_raw);
  uint64_t* tile_valid = reinterpret_cast<uint64_t*>(base + P::VALID);
  wide::Ring kring = wide::Ring::make(base, P::K_RING, P::BARS, 1, P::ITEM);
  wide::Ring vring = wide::Ring::make(base, P::V_RING, P::V_BARS, 1, P::ITEM);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + P::Q_BAR);
  uint32_t* skeep = reinterpret_cast<uint32_t*>(base + P::KEEP);

  // Block `rank` of the cluster of (q tile, head h, window b) along x: its
  // columns col_r .. col_r + W - 1 of the head's
  const int ranks = wide::ranks(D), rank = blockIdx.x % ranks;
  const wide::Exchange ex{base + P::PARTIALS, ranks, rank};
  const int W = wide::rank_cols(D, rank), NA = W / wide::ATOM;
  const int q0 = (blockIdx.x / ranks) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int col_r = h * D + rank * RC;
  const long long row_base = static_cast<long long>(b * H + h) * T;
  const int key_tiles = (T + BKV - 1) / BKV, words = 2 * key_tiles;
  const int warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint8_t* mrow = mask + static_cast<long long>(b) * T;

  // The window's valid keys, a word a key tile, and the keep words zeroed
  for (int i = warp_id; i < key_tiles; i += WARPS) {
    const int key = i * BKV + lane;
    const uint64_t bits =
        __ballot_sync(0xffffffffu, key < T && mrow[key] != 0) |
        static_cast<uint64_t>(
            __ballot_sync(0xffffffffu, key + 32 < T && mrow[key + 32] != 0))
            << 32;
    if (lane == 0) tile_valid[i] = bits;
  }
  if constexpr (DROP)
    for (int i = threadIdx.x; i < BQ * words; i += THREADS) skeep[i] = 0u;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);      // published by the rings' init fence
    kring.init();
    vring.init();
  }
  __syncthreads();
  // The key tiles walked, the same in every rank of the cluster: K items
  // 0 .. tiles - 1 in pass 1 and tiles .. 2 tiles - 1 in pass 2, V items
  // 0 .. tiles - 1
  int tiles = 0;
  for (int i = 0; i < key_tiles; ++i)
    if (tile_valid[i]) tiles = i + 1;
  if (causal) tiles = min(tiles, (min(q0 + BQ, T) - 1) / BKV + 1);
  kring.items = 2 * tiles;
  vring.items = tiles;
  // Key tile i's K (or V) columns of the rank into item n of a ring
  auto loader = [&](const wide::Ring& ring, const CUtensorMap* map) {
    return [&ring, map, W, NA, col_r, b, tiles](int n) {
      const int i = n < tiles ? n : n - tiles;
      unsigned char* slot = ring.at(n);
      const uint32_t bar = ring.bar(n);
      mbar_expect_tx(bar, W * BKV * 2);
      for (int a = 0; a < NA; ++a)
        tma_load_3d(slot + a * wide::TILE_CHUNK, map, col_r + a * wide::ATOM,
                    i * BKV, b, bar);
    };
  };
  auto load_k = loader(kring, &map_k);
  auto load_v = loader(vring, &map_v);
  if (threadIdx.x == 0 && tiles > 0) {
    const uint32_t qb = smem_addr(q_bar);
    mbar_expect_tx(qb, NA * wide::ROW_CHUNK);
    for (int a = 0; a < NA; ++a)
      tma_load_3d(base + a * wide::ROW_CHUNK, &map_q, col_r + a * wide::ATOM,
                  q0, b, qb);
    load_k(0);
    load_v(0);
  }

  const int c = threadIdx.x / 128, warp = warp_id % 4;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row = q0 + 64 * c, warp_row = wg_row + 16 * warp;
  const int r0 = warp_row + g, r1 = r0 + 8;
  const int wg_tiles =
      wg_row >= T ? 0 : causal ? min(tiles, (wg_row + 63) / BKV + 1) : tiles;
  const uint32_t q_addr = smem_addr(base) + c * 64 * 128;
  const unsigned long long base0 =
      static_cast<unsigned long long>(row_base + r0) * T;
  const unsigned long long base1 = base0 + 8ull * T;
  uint2* keep0 = reinterpret_cast<uint2*>(skeep + (r0 - q0) * words);
  uint2* keep1 = reinterpret_cast<uint2*>(skeep + (r1 - q0) * words);
  if (tiles > 0) mbar_wait(smem_addr(q_bar), 0);

  // Pass 1: the row max m and sum l, online over the tiles; the keep bits
  // drawn while the peers' partials come in
  float m0 = MINUS_INF, m1 = MINUS_INF, l0 = 0.f, l1 = 0.f;
  for (int i = 0; i < tiles; ++i) {
    const int k0 = i * BKV;
    const uint64_t valid = tile_valid[i];
    const bool live = i < wg_tiles && valid != 0;
    float sc[BKV / 2];
    wide::scores_resident(sc, q_addr, kring, i, NA, live, lane, load_k);
    ex.put(sc, i, live);
    if (DROP && live)
      draw_keep<ALIGNED>(drop, base0, base1, r0, r1, t, causal, i, valid,
                         keep0, keep1);
    ex.get(sc, i, live);
    if (live)
      row_stats(sc, valid, k0, warp_row, r0, r1, t, causal, scale_log2, m0,
                m1, l0, l1);
  }
  l0 = quad_sum(l0), l1 = quad_sum(l1);
  const float lse0 = l0 > 0.f ? m0 + log2f(l0) : 0.f;
  const float lse1 = l1 > 0.f ? m1 + log2f(l1) : 0.f;
  __syncwarp();   // the quads' keep words of pass 1, read in pass 2

  // Pass 2: o = sum over keys of bf16(keep ? exp2(s - lse) / (1 - rate) :
  // 0) v, over the rank's columns (where it has 128, the other 128 of the
  // m64n256 product read stale bytes of the V slot and are not stored)
  float o[RC / 2];
#pragma unroll
  for (int e = 0; e < RC / 2; ++e) o[e] = 0.f;
  for (int i = 0; i < tiles; ++i) {
    const int k0 = i * BKV;
    const uint64_t valid = tile_valid[i];
    const bool live = i < wg_tiles && valid != 0;
    float sc[BKV / 2];
    wide::scores_resident(sc, q_addr, kring, tiles + i, NA, live, lane,
                          load_k);
    // rows r0, r1's keep bits of the tile, shifted to this lane's keys
    uint64_t kw0 = ~0ull, kw1 = ~0ull;
    if constexpr (DROP) {
      const uint2 a0 = keep0[i], a1 = keep1[i];
      kw0 = (a0.x | static_cast<uint64_t>(a0.y) << 32) >> (2 * t);
      kw1 = (a1.x | static_cast<uint64_t>(a1.y) << 32) >> (2 * t);
    }
    const bool full_tile = full_tile_of(valid, k0, warp_row, causal);
    const uint64_t bits = valid >> (2 * t);
    uint2 u[SLOTS];
    ex.put(sc, tiles + i, live);
    ex.get_packed(u, tiles + i, live, [&](int j, float4 s) {
      return pd_group<DROP>(s, j, full_tile, bits, k0, r0, r1, t, causal,
                            scale_log2, lse0, lse1, kw0, kw1, drop.scale);
    });
    uint32_t a[BKV / 16][4];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      a[j / 2][2 * (j % 2)] = u[j].x;
      a[j / 2][2 * (j % 2) + 1] = u[j].y;
    }
    vring.wait(i);
    if (live) {
      const uint32_t v_addr = smem_addr(vring.at(i));
#pragma unroll
      for (int k = 0; k < BKV / 16; ++k) fence_regs(a[k]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BKV / 16; ++k)
        wgmma_rs<RC>(o, a[k], sw128_desc(v_addr + k * 2048, BKV * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int k = 0; k < BKV / 16; ++k) fence_regs(a[k]);
    }
    vring.release(i, lane, load_v);
  }
  // Every item is consumed once both warpgroups are here, and no peer
  // reads this block's buffers once the cluster is
  wide::cluster_sync();

  // The epilogue: rank 0 writes lse and the keep words; o leaves through
  // the resident Q's space, the rank's W columns
  if (rank == 0 && t == 0) {
    if (r0 < T) lse[row_base + r0] = lse0;
    if (r1 < T) lse[row_base + r1] = lse1;
  }
  if (DROP && rank == 0) {
    const int n = max(0, min(64, T - wg_row)) * words / 2;
    const uint2* src = reinterpret_cast<const uint2*>(skeep + 64 * c * words);
    uint2* dst =
        reinterpret_cast<uint2*>(keep_out + (row_base + wg_row) * words);
    for (int e = threadIdx.x % 128; e < n; e += 128) dst[e] = src[e];
  }
  auto box = [&](int n) { return base + c * 32768 + n * wide::TILE_CHUNK; };
  const bool lead = threadIdx.x % 128 == 0;
  if (want32) {
    stage_f32<RC, 0, RC / 16>(o, box, warp, g, t);
    store_boxes(&map_o32, 4, 32, box, col_r, wg_row, b, c, lead, T);
    if (W == RC) {
      stage_f32<RC, RC / 16, RC / 8>(o, box, warp, g, t);
      store_boxes(&map_o32, 4, 32, box, col_r + RC / 2, wg_row, b, c, lead,
                  T);
    }
  }
  stage_bf16<RC>(o, box, warp, g, t);
  store_boxes(&map_o16, NA, wide::ATOM, box, col_r, wg_row, b, c, lead, T);
}

template <bool DROP, bool ALIGNED>
int launch_fwd_wide(const CUtensorMap* maps, const void* mask, void* lse,
                    void* keep, int B, int T, int H, int D, float scale_log2,
                    int causal, const ppgs::Dropout& drop, int want32,
                    cudaStream_t stream) {
  const int smem = WidePlan::smem(DROP ? 2 * ((T + BKV - 1) / BKV) : 0);
  const int ranks = wide::ranks(D);
  const dim3 grid(ranks * ((T + BQ - 1) / BQ), H, B);
  return ppgs::residual_ln::launch(
      fwd_wide_kernel<DROP, ALIGNED>, THREADS, smem, grid, ranks, stream,
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const uint8_t*>(mask), static_cast<float*>(lse),
      static_cast<uint32_t*>(keep), T, H, D, scale_log2, causal, drop,
      want32);
}

// ------------------------------------------------------------- row_dot

// out[(b*H + h)*T + t] = sum_d x[row, h*D + d] y[row, h*D + d]: one warp
// per (row, head); D = 256: eight contiguous columns a lane; D = 0: d
// given at run time, four columns a lane 128 apart (coalesced at any
// width; at d = 128 a lane's four are contiguous)
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T_, int D>
__global__ void __launch_bounds__(256)
row_dot_kernel(const T_* __restrict__ x, long long ldx,
               const T_* __restrict__ y, long long ldy,
               float* __restrict__ out, long long rows, int T, int H,
               int d) {
  const long long pair = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= rows * H) return;
  const long long r = pair / H;
  const int h = static_cast<int>(pair % H);
  float s = 0.f;
  if constexpr (D == 0) {
    const T_* xr = x + r * ldx + h * d;
    const T_* yr = y + r * ldy + h * d;
    for (int c = 4 * lane; c < d; c += 128)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s += to_float(xr[c + e]) * to_float(yr[c + e]);
  } else {
    constexpr int PER_LANE = D / 32;
    const T_* xr = x + r * ldx + h * D + lane * PER_LANE;
    const T_* yr = y + r * ldy + h * D + lane * PER_LANE;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e)
      s += to_float(xr[e]) * to_float(yr[e]);
  }
  s = ppgs::warp_sum(s);
  if (lane == 0) {
    const long long b = r / T, t = r % T;
    out[(b * H + h) * T + t] = s;
  }
}

template <typename T_>
cudaError_t launch_row_dot(const void* x, long long ldx, const void* y,
                           long long ldy, void* out, long long rows, int T,
                           int H, int d, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((rows * H + 7) / 8);
  const T_* xs = static_cast<const T_*>(x);
  const T_* ys = static_cast<const T_*>(y);
  float* o = static_cast<float*>(out);
  if (d == 256)
    row_dot_kernel<T_, 256><<<blocks, 256, 0, s>>>(xs, ldx, ys, ldy, o, rows,
                                                   T, H, d);
  else
    row_dot_kernel<T_, 0><<<blocks, 256, 0, s>>>(xs, ldx, ys, ldy, o, rows,
                                                 T, H, d);
  return cudaGetLastError();
}

// D: the instance (128 or 256), or 0 for the wide route at d
template <int D>
int launch_width(const void* q, const void* k, const void* v, long long rs,
                 const void* mask, void* out, void* out32, long long os,
                 void* lse, void* keep, int B, int T, int H, int d,
                 float scale_log2, int causal, const ppgs::Dropout& drop,
                 cudaStream_t s) {
  // (columns, T, window) views: q in boxes of 128 rows, k and v of 64, the
  // outputs in boxes of 64 rows of 128 bytes
  const long long cols = static_cast<long long>(H) * d;
  CUtensorMap maps[5] = {};
  if (!encode_3d(&maps[0], q, cols, T, B, rs, T * rs, ATOM, BQ) ||
      !encode_3d(&maps[1], k, cols, T, B, rs, T * rs, ATOM, BKV) ||
      !encode_3d(&maps[2], v, cols, T, B, rs, T * rs, ATOM, BKV) ||
      !encode_3d(&maps[3], out, cols, T, B, os, T * os, ATOM, 64) ||
      (out32 && !encode_3d(&maps[4], out32, cols, T, B, os, T * os, 32, 64,
                           true)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int want32 = out32 != nullptr;
  if constexpr (D == 0) {
    if (!drop.threshold)
      return launch_fwd_wide<false, true>(maps, mask, lse, keep, B, T, H, d,
                                          scale_log2, causal, drop, want32,
                                          s);
    if (T % 4 == 0)
      return launch_fwd_wide<true, true>(maps, mask, lse, keep, B, T, H, d,
                                         scale_log2, causal, drop, want32, s);
    return launch_fwd_wide<true, false>(maps, mask, lse, keep, B, T, H, d,
                                        scale_log2, causal, drop, want32, s);
  } else {
    if (!drop.threshold)
      return launch_fwd<D, false, true>(maps, mask, lse, keep, B, T, H,
                                        scale_log2, causal, drop, want32, s);
    if (T % 4 == 0)
      return launch_fwd<D, true, true>(maps, mask, lse, keep, B, T, H,
                                       scale_log2, causal, drop, want32, s);
    return launch_fwd<D, true, false>(maps, mask, lse, keep, B, T, H,
                                      scale_log2, causal, drop, want32, s);
  }
}

}  // namespace

// q, k, v: bf16 (B, T, H*d) views with row stride rs, d = d_head 128 or
// 256, or d % 128 == 0 from 384 to 2048 (the wide route); mask (B, T)
// bytes, nonzero = valid key; out (B, T, H*d) bf16 and
// out32 (the same layout in fp32, or null) with row stride out_stride; lse
// (B, H, T) fp32; keep (B, H, T, 2 ceil(T / 64)) uint32, the keep bits for
// the backward (bit k of word w of a query row: key 32 w + k valid and
// kept), needed when the dropout is on (threshold != 0). scale_log2 =
// log2(e)/sqrt(d). TMA: 16-byte aligned bases, rs and out_stride
// multiples of 8 elements. T <= 1024 and d as above; any other returns
// cudaErrorInvalidValue.
extern "C" int ppgs_attention_train_fwd(
    const void* q, const void* k, const void* v, long long rs,
    const void* mask, void* out, void* out32, long long out_stride,
    void* lse, void* keep, int B, int T, int H, int d, float scale_log2,
    int causal, unsigned seed_lo, unsigned seed_hi, unsigned site,
    unsigned threshold, float scale, void* stream) {
  const ppgs::Dropout drop =
      ppgs::make_dropout(seed_lo, seed_hi, site, threshold, scale);
  if (T > MAX_T || (drop.threshold && !keep) ||
      (d != 128 && d != 256 && !wide::takes(d)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 256)
    return launch_width<256>(q, k, v, rs, mask, out, out32, out_stride, lse,
                             keep, B, T, H, d, scale_log2, causal, drop, s);
  if (d == 128)
    return launch_width<128>(q, k, v, rs, mask, out, out32, out_stride, lse,
                             keep, B, T, H, d, scale_log2, causal, drop, s);
  return launch_width<0>(q, k, v, rs, mask, out, out32, out_stride, lse,
                         keep, B, T, H, d, scale_log2, causal, drop, s);
}

// out (B, H, T) fp32 = per-head row sums of x * y over (B*T, H*d) rows
// with strides ldx, ldy, d % 128 == 0 up to 2048; is_f32: both fp32, else
// both bf16.
extern "C" int ppgs_row_dot(const void* x, long long ldx, const void* y,
                            long long ldy, void* out, int B, int T, int H,
                            int d, int is_f32, void* stream) {
  if (d % 128 || d <= 0 || d > wide::MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)B * T;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_f32 ? launch_row_dot<float>(x, ldx, y, ldy, out, rows, T, H, d, s)
             : launch_row_dot<bf16>(x, ldx, y, ldy, out, rows, T, H, d, s));
}
