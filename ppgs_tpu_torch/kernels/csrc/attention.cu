// K2 attention: masked multi-head attention with an online softmax, read in
// place from the model's (B, T, C) activation layout, d_head = 16, 32, 64,
// 128 or 256 (one template instance each), and any d_head % 128 == 0 from
// 384 to 2048 through the wide route (wide_kernel, below).
//
// Replaces: ppgs_tpu/ops/flash_attention.py _fused_kernel (T <= 1024) and
// _flash_kernel (T > 1024) for d_head % 128 == 0, _fused_kernel_packed
// (d_head < 128: wav2vec2's 12 heads of 64, which the TPU packs 128 /
// d_head to a 128-lane block; here each head is a block of its own, so
// nothing needs packing), and the per-head attention inside
// ppgs_tpu/ops/encoder_layer_kernel.py _layer_body (encoder_stack, and
// encoder_stack_streamed's trunk layers at d_head 16, 32, 64 or 128).
//
// The function: S = Q K^T in fp32; the key mask (and the causal mask)
// applied BEFORE the row max, as flash_attention and the XLA path do;
// p = exp2(S * scale_log2 - m) in fp32; p rounded to bf16 for the PV
// product, the row sum kept from the fp32 p; O rescaled by exp2(m_old -
// m_new) per key tile; finally O / l, with a row sum of 0 (a wholly masked
// row or window) giving exactly 0. q, k and v are read through a row
// stride, so the fused (B, T, 3C) QKV buffer needs no split and no head
// transpose; any T works (TMA reads zeros past T, and keys past T are
// masked), so the T = 500 windows need no pad to 512. The mask is any
// (B, T) bool.
//
// Where this rounds differently from the TPU kernels: encoder_stack's bf16
// softmax takes the row max over all keys and exponentiates in bf16, and
// _fused_kernel(_packed) normalises p before the PV product; here exp2 is
// fp32 (ex2.approx, relative error ~2^-22, denormal p flushed to 0), the
// max is over valid keys, and the 1/l scale comes after the product (as in
// _flash_kernel). All differ by bf16 rounding only.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s) at the main paths'
// shapes: mel and bottleneck heads (128 windows x T = 500, 2 heads of 128)
// 31 GFLOP against 131 MB moved (q, k, v in, output out, bf16), ~0.039 ms;
// the w2v2 trunk (64 x 400, 12 heads of 64) and the w2v2fb head (128 x
// 500, 2 heads of 256) likewise near their bytes. The softmax's exp2 runs
// on the SM's 16 special-function units a clock: at d_head 64 it costs
// about what the two products cost.
//
// Design (Hopper: wgmma + TMA, on the blocks of hopper.cuh). One block per
// (128-row query tile, head, window); two consumer warpgroups own 64 query
// rows each, 256 threads (a ninth warp would cap a thread at 168 registers,
// and at d_head 256 a thread holds 128 accumulators of O, 32 of S and 16 of
// P's fragments). Q's tile arrives once by TMA; the K and V tiles of 64
// keys by TMA into a ring of STAGES stages with full and empty mbarriers:
// thread 0 fills the ring, and the last of the eight warps to release a
// stage (a shared counter elects it) refills it, so neither warpgroup waits
// for the other. A 3-D tensor map (d, T, window) per operand reads a
// head's columns through the row stride and zero-fills rows past T.
// Per key tile and warpgroup:
// - S (64 x 64 fp32, 32 registers a thread) = Q K^T by m64n64k16 wgmma
//   with both operands K-major (d_head contiguous) from the 128-byte
//   swizzled tiles; a k-step advances 32 bytes in a swizzle atom of 64
//   columns, and every four steps to the next atom;
// - the masks and the online softmax on the accumulator layout: a thread
//   owns rows g and g + 8 of its warp's 16 and columns 8j + 2t, 8j + 2t +
//   1; the row max is reduced over the quad with two shuffles, the row sum
//   is kept per thread and reduced once at the end. The key mask of a tile
//   is one 64-bit ballot of the mask bytes (two per lane, fetched a tile
//   ahead), so it can be any (B, T) bool; masked scores are -inf and give
//   p = 0 exactly;
// - O (64 x d_head fp32 in registers for the whole walk) is rescaled in
//   registers, and O += P V by m64n{d}k16 wgmma with A from registers: the
//   bf16 pairs of p, packed straight from S's accumulators, are the m64k16
//   A fragments (no shuffle), and V is the MN-major B operand (keys x
//   d_head, d_head contiguous).
// A tile whose keys are all masked for a warpgroup (the mask, the window's
// end, or the causal diagonal) is exact to skip (its p are 0): the
// warpgroup releases it unread, and a wholly masked window computes
// nothing. Tiles past the block's last row are not loaded when causal.
// Shared memory: Q 128 x d (16, 32, 64 KB), a stage 2 x 64 x d (16, 32,
// 64 KB). What bounds the kernel on the card is the K and V stream (each
// 64-key tile is read from L2 by every query tile of its head), not the
// products or the exp2: on an H100 a variant that only loads and releases
// the tiles took more than half of the whole kernel's time at every width.
// So an SM holds as many bytes in flight as fit: two blocks at d_head 64
// (3 stages, 64 KB each) and 128 (2 stages, 96 KB each; ptxas then keeps a
// thread to 128 registers and spills a few bytes, and the pair still ran
// faster than one block of 3 or 5 stages), one at 256 (2 stages, 192 KB).
// The output is normalised in registers, staged as bf16 in the
// warpgroup's rows of the Q tile and written by TMA stores of whole
// 128-byte rows (none past T); stores straight from the accumulator layout
// write 16 bytes of each of 16 rows per warp instruction, and in a variant
// that only streams the tiles they took a third of its time.
//
// Not taken: issuing tile i + 1's S before tile i's P V, so that the
// softmax overlaps the tensor cores inside a warpgroup. ptxas serialised
// the wgmma groups around the softmax's branches (its C7518 "wgmma
// serialized ... in divergent path"), and that form ran slower than this
// one at every width; the two warpgroups of a block already overlap one's
// softmax with the other's products.
//
// d_head 32 and 16 (a wav2vec2 trunk re-headed to 24 or 48 heads; the JAX
// rule takes any 128 % d_head == 0): the same kernel on operand rows of 64
// or 32 bytes, TMA boxes and wgmma descriptors with the 64- or 32-byte
// swizzle (an atom is then the head's own width), one or two k16 steps of
// S and an m64n32 or m64n16 PV product. d_head 8 and less would need rows
// narrower than a TMA box's 16 bytes: not ported (ROADMAP.md).
//
// d_head 384 to 2048 (the PPG transformer widened with its default two
// heads: C = 768 to 2048 give d_head 384 to 1024): the wide route of
// attention_wide.cuh, which forms S once a head. A cluster of ceil(d_head
// / 256) blocks owns 128 query rows of a head, rank r the head's columns
// from 256 r on (128 in a last rank where d_head % 256 == 128). A rank
// keeps its Q columns of the block's rows in shared memory (64 KB) and
// streams the key tiles' K and V columns (32 KB items); per tile each
// warpgroup forms its partial S by the same m64n64k16 steps as above, the
// ranks' partials add up through distributed shared memory
// (wide::Exchange), so every rank holds the same S and the instances' own
// softmax (softmax_tile) gives each the same p, and O += P V on the
// rank's V columns (m64n256k16, O 64 x 256 fp32 in registers: 128 a
// thread) runs during the next tile's cluster sum. Each of the head's Q,
// K and V columns is read by one rank. Q, a K item, two V items and the
// two 32 KB exchange buffers: one block an SM. O is staged over Q at the
// end and written by TMA stores. (A block per output slice would form S
// again in every slice: d_head / 256 times the score products.)

#include "attention_wide.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "residual_ln.cuh"

using namespace ppgs::hopper;

namespace {

constexpr int BQ = 128, BKV = 64;   // query rows a block, keys a tile
constexpr int THREADS = 256;        // two consumer warpgroups

// The shared-memory plan of the instance for head width D
template <int D>
struct Plan {
  // Bytes a row of a swizzle atom holds: 128 (64 columns) from d_head 64,
  // the head's own 64 or 32 bytes at d_head 32 or 16
  static constexpr int SW = D >= 64 ? 128 : 2 * D;
  static constexpr int ATOM_COLS = SW / 2, ATOMS = D / ATOM_COLS;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr int STAGES = D == 64 ? 3 : D < 64 ? 4 : 2;
  static constexpr int BLOCKS = D == 256 ? 1 : 2;  // blocks an SM holds
  static constexpr int Q_BYTES = BQ * D * 2;       // ATOMS atoms of BQ rows
  static constexpr int KV_BYTES = BKV * D * 2;     // ATOMS atoms of BKV rows
  static constexpr int STAGE = 2 * KV_BYTES;       // K, then V
  static constexpr int BARS = Q_BYTES + STAGES * STAGE;
  // Q, the ring, full[], empty[], the Q barrier, the release counters, and
  // slack to align Q to 1024 bytes
  static constexpr int SMEM = BARS + (2 * STAGES + 1) * 8 + STAGES * 4 + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472,
                "the blocks an SM should hold do not fit its shared memory");
};

constexpr float MINUS_INF = -__builtin_huge_valf();

// The masks and the online softmax of one 64-key tile at k0 on S's
// accumulator (a thread's rows r0 = warp_row + g and r1 = r0 + 8): the key
// mask `valid` (bit k for key k0 + k) and the causal one where the tile
// reaches past the diagonal of one of the warp's rows, masked scores -inf;
// then the row max m and sum l (m in the log2-scaled units of the scores),
// p = exp2(s scale_log2 - m) packed as bf16 into P's A fragments (a[k]
// holds keys 16k..16k+15, groups j = 2k in registers 0, 1 and 2k + 1 in
// 2, 3), and O's correction exp2(m_old - m_new) per row
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BKV / 2], uint32_t (&a)[BKV / 16][4], uint64_t valid, int k0,
    int warp_row, int r0, int r1, int t, int causal, float scale_log2,
    float& m0, float& m1, float& l0, float& l1, float& corr0,
    float& corr1) {
  if (valid != ~0ull || (causal && k0 + BKV - 1 > warp_row)) {
    const uint64_t bits = valid >> (2 * t);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        const bool ok = (bits >> (8 * j + e)) & 1u;
        if (!ok || (causal && key > r0)) sc[4 * j + e] = MINUS_INF;
        if (!ok || (causal && key > r1)) sc[4 * j + 2 + e] = MINUS_INF;
      }
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
  // that its p and its correction are exp2(-inf) = 0, not NaN
  const float u0 = n0 == MINUS_INF ? 0.f : n0;
  const float u1 = n1 == MINUS_INF ? 0.f : n1;
  corr0 = exp2_approx(m0 - u0), corr1 = exp2_approx(m1 - u1);
  m0 = n0, m1 = n1;
  // p in fp32 for the row sums, its bf16 pairs as P's A fragments
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    const float p0 = exp2_approx(fmaf(sc[4 * j], scale_log2, -u0));
    const float p1 = exp2_approx(fmaf(sc[4 * j + 1], scale_log2, -u0));
    const float p2 = exp2_approx(fmaf(sc[4 * j + 2], scale_log2, -u1));
    const float p3 = exp2_approx(fmaf(sc[4 * j + 3], scale_log2, -u1));
    ps0 += p0 + p1;
    ps1 += p2 + p3;
    a[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
    a[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
  }
  l0 = l0 * corr0 + ps0;
  l1 = l1 * corr1 + ps1;
}

// O (64 x N fp32, N / 2 a thread) rescaled by its rows' corrections
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N / 2], float corr0,
                                        float corr1) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    o[4 * j] *= corr0, o[4 * j + 1] *= corr0;
    o[4 * j + 2] *= corr1, o[4 * j + 3] *= corr1;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, Plan<D>::BLOCKS)
attention_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_out,
                 const uint8_t* __restrict__ mask, int T, float scale_log2,
                 int causal) {
  using P = Plan<D>;
  constexpr int STAGES = P::STAGES, ATOMS = P::ATOMS, SW = P::SW;
  constexpr int AC = P::ATOM_COLS, KPA = SW / 32;   // k16 steps an atom
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = sq + P::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sq + P::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;
  int* released = reinterpret_cast<int*>(q_bar + 1);

  const int q0 = blockIdx.x * BQ, b = blockIdx.z, col0 = blockIdx.y * D;
  // The key tiles: all of the window's, or up to the block's last row's
  int tiles = (T + BKV - 1) / BKV;
  if (causal) tiles = min(tiles, (min(q0 + BQ, T) - 1) / BKV + 1);

  // Tile i's K and V into stage i % STAGES
  auto load = [&](int i) {
    const int s = i % STAGES;
    const uint32_t bar = smem_addr(full + s);
    mbar_expect_tx(bar, P::STAGE);
    unsigned char* ks = ring + s * P::STAGE;
#pragma unroll
    for (int j = 0; j < ATOMS; ++j) {
      tma_load_3d(ks + j * BKV * SW, &map_k, col0 + j * AC, i * BKV, b,
                  bar);
      tma_load_3d(ks + P::KV_BYTES + j * BKV * SW, &map_v, col0 + j * AC,
                  i * BKV, b, bar);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    mbar_init_ring(full, empty, STAGES, 8);    // 8 consumer warps release
    for (int s = 0; s < STAGES; ++s) released[s] = 0;
    const uint32_t qb = smem_addr(q_bar);
    mbar_expect_tx(qb, P::Q_BYTES);
#pragma unroll
    for (int j = 0; j < ATOMS; ++j)
      tma_load_3d(sq + j * BQ * SW, &map_q, col0 + j * AC, q0, b, qb);
    for (int i = 0; i < STAGES && i < tiles; ++i) load(i);
  }
  __syncthreads();

  // Warpgroup c owns the tile's rows 64c..64c+63; register 4j + e of an
  // accumulator holds row g + 8 (e / 2) of the warp's 16, column 8j + 2t +
  // e % 2
  const int c = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wg_row = q0 + 64 * c, warp_row = wg_row + 16 * warp;
  const int r0 = warp_row + g, r1 = r0 + 8;
  const uint8_t* mrow = mask + static_cast<long long>(b) * T;
  const uint32_t q_addr = smem_addr(sq) + c * 64 * SW;
  const uint32_t ring_addr = smem_addr(ring);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = MINUS_INF, m1 = MINUS_INF, l0 = 0.f, l1 = 0.f;

  // This lane's mask bytes of a tile (keys + lane and + 32 + lane), read a
  // tile ahead of their use
  int nb0, nb1;
  auto fetch = [&](int i) {
    const int key = i * BKV + lane;
    nb0 = key < T ? mrow[key] : 0;
    nb1 = key + 32 < T ? mrow[key + 32] : 0;
  };
  fetch(0);
  mbar_wait(smem_addr(q_bar), 0);

  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES, k0 = i * BKV;
    // The tile's valid keys, bit k for key k0 + k (the same in every warp)
    const uint64_t valid =
        __ballot_sync(0xffffffffu, nb0 != 0) |
        (static_cast<uint64_t>(__ballot_sync(0xffffffffu, nb1 != 0)) << 32);
    if (i + 1 < tiles) fetch(i + 1);
    const bool live =
        valid != 0 && wg_row < T && !(causal && k0 > wg_row + 63);
    mbar_wait(smem_addr(full + s), (i / STAGES) & 1);
    if (live) {
      const uint32_t k_addr = ring_addr + s * P::STAGE;
      const uint32_t v_addr = k_addr + P::KV_BYTES;
      // S = Q K^T: both K-major, 32 bytes of an SW-byte row a step
      float sc[BKV / 2];
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) sc[e] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BKV, 0, 0>(
            sc,
            sw_desc<SW>(q_addr + (kk / KPA) * (BQ * SW) + (kk % KPA) * 32, 16,
                        8 * SW),
            sw_desc<SW>(k_addr + (kk / KPA) * (BKV * SW) + (kk % KPA) * 32,
                        16, 8 * SW));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      uint32_t a[BKV / 16][4];
      float corr0, corr1;
      softmax_tile(sc, a, valid, k0, warp_row, r0, r1, t, causal,
                   scale_log2, m0, m1, l0, l1, corr0, corr1);
      rescale<D>(o, corr0, corr1);

      // O += P V: V MN-major, 16 key rows of SW bytes a step, the next
      // atom (BKV x SW bytes) on
#pragma unroll
      for (int k = 0; k < BKV / 16; ++k) fence_regs(a[k]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BKV / 16; ++k)
        wgmma_rs<D>(o, a[k],
                    sw_desc<SW>(v_addr + k * 16 * SW, BKV * SW, 8 * SW));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int k = 0; k < BKV / 16; ++k) fence_regs(a[k]);
    }

    // Release the stage; the last of the eight warps to do so refills it
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(smem_addr(empty + s));
      if (i + STAGES < tiles && atomicAdd(released + s, 1) % 8 == 7) {
        mbar_wait(smem_addr(empty + s), (i / STAGES) & 1);
        load(i + STAGES);
      }
    }
    __syncwarp();
  }

  // O / l in bf16 into the warpgroup's own rows of the Q tile (its last
  // product is done, and the other warpgroup reads only its rows), swizzled
  // as TMA reads them (the 16-byte chunk q of row r at q ^ (r & 7) in a
  // 128-byte row, q ^ ((r >> 1) & 3) in a 64-byte one, q ^ ((r >> 2) & 1)
  // in a 32-byte one: conflict-free), then one TMA store per atom, which
  // writes no row past T
  constexpr int CH = SW / 16, SH = SW == 128 ? 0 : SW == 64 ? 1 : 2;
  l0 = quad_sum(l0), l1 = quad_sum(l1);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  unsigned char* so = sq + c * 64 * SW;
  const int lr0 = 16 * warp + g;            // row of the warpgroup's 64
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* row0 = so + (j / CH) * (BQ * SW) + lr0 * SW + 4 * t;
    // lr0 + 8 has the same swizzle bits as lr0
    const int chunk = ((j % CH) ^ ((g >> SH) & (CH - 1))) << 4;
    *reinterpret_cast<uint32_t*>(row0 + chunk) =
        pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(row0 + 8 * SW + chunk) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  fence_async_smem();
  bar_sync(1 + c, 128);
  if (threadIdx.x % 128 == 0 && wg_row < T) {
#pragma unroll
    for (int j = 0; j < ATOMS; ++j)
      tma_store_3d(&map_out, col0 + j * AC, wg_row, b, so + j * (BQ * SW));
    bulk_commit();
    bulk_wait_read();
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, long long rs,
           const void* mask, void* out, long long out_stride, int B, int T,
           int H, float scale_log2, int causal, cudaStream_t stream) {
  using P = Plan<D>;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (B <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
  // (columns, T, window) views of q, k, v (rows rs apart, windows T rs)
  // and of out (rows out_stride apart)
  const long long cols = static_cast<long long>(H) * D, ld2 = T * rs;
  constexpr int AC = P::ATOM_COLS;
  constexpr CUtensorMapSwizzle SWZ = P::SWIZZLE;
  CUtensorMap mq, mk, mv, mo;
  if (!encode_3d(&mq, q, cols, T, B, rs, ld2, AC, BQ, false, SWZ) ||
      !encode_3d(&mk, k, cols, T, B, rs, ld2, AC, BKV, false, SWZ) ||
      !encode_3d(&mv, v, cols, T, B, rs, ld2, AC, BKV, false, SWZ) ||
      !encode_3d(&mo, out, cols, T, B, out_stride, T * out_stride, AC, 64,
                 false, SWZ))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((T + BQ - 1) / BQ, H, B);
  attention_kernel<D><<<grid, THREADS, P::SMEM, stream>>>(
      mq, mk, mv, mo, static_cast<const uint8_t*>(mask), T, scale_log2,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ wide route

namespace wide = ppgs::wide;

// The wide route's shared memory: the rank's Q columns of the block's
// 128 rows (NA atoms, resident), a ring of one K item (the key tile's
// rank columns, NA atoms of 64 rows) and a ring of two V items (the
// same of V: a tile's P V is done during the next tile's cluster sum),
// the cluster sum's two buffers, each ring's full[], empty[] and release
// counters, the Q barrier, and slack to align
struct WidePlan {
  static constexpr int Q_BYTES = BQ * wide::RANK_COLS * 2;
  static constexpr int ITEM = BKV * wide::RANK_COLS * 2;
  static constexpr int K_STAGES = 1, V_STAGES = 2;
  static constexpr int K_RING = Q_BYTES, V_RING = K_RING + K_STAGES * ITEM;
  static constexpr int PARTIALS = V_RING + V_STAGES * ITEM;
  static constexpr int BARS = PARTIALS + 2 * wide::PARTIAL;
  static constexpr int V_BARS = BARS + wide::Ring::bytes(K_STAGES);
  static constexpr int Q_BAR = V_BARS + wide::Ring::bytes(V_STAGES);
  static constexpr int SMEM = Q_BAR + 8 + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
  static_assert(2 * 64 * wide::RANK_COLS * 2 <= Q_BYTES,
                "O's staging does not fit");
};

__global__ void __launch_bounds__(THREADS, 1)
wide_kernel(const __grid_constant__ CUtensorMap map_q,
            const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v,
            const __grid_constant__ CUtensorMap map_out,
            const uint8_t* __restrict__ mask, int T, int D,
            float scale_log2, int causal) {
  using P = WidePlan;
  constexpr int RC = wide::RANK_COLS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = wide::aligned_smem(smem_raw);
  wide::Ring kring =
      wide::Ring::make(base, P::K_RING, P::BARS, P::K_STAGES, P::ITEM);
  wide::Ring vring =
      wide::Ring::make(base, P::V_RING, P::V_BARS, P::V_STAGES, P::ITEM);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + P::Q_BAR);

  // Block `rank` of the cluster of (q tile, head, window b) along x: its
  // columns col_r .. col_r + W - 1 of the head's col_h .. col_h + D - 1
  const int ranks = wide::ranks(D), rank = blockIdx.x % ranks;
  const wide::Exchange ex{base + P::PARTIALS, ranks, rank};
  const int W = wide::rank_cols(D, rank), NA = W / wide::ATOM;
  const int q0 = (blockIdx.x / ranks) * BQ, b = blockIdx.z;
  const int col_r = blockIdx.y * D + rank * RC;
  int tiles = (T + BKV - 1) / BKV;
  if (causal) tiles = min(tiles, (min(q0 + BQ, T) - 1) / BKV + 1);
  kring.items = vring.items = tiles;
  // Key tile i's K (or V) columns of the rank into item i of a ring
  auto tile_loader = [&](const wide::Ring& ring, const CUtensorMap* map) {
    return [&ring, map, W, NA, col_r, b](int i) {
      unsigned char* slot = ring.at(i);
      const uint32_t bar = ring.bar(i);
      mbar_expect_tx(bar, W * BKV * 2);
      for (int a = 0; a < NA; ++a)
        tma_load_3d(slot + a * wide::TILE_CHUNK, map, col_r + a * wide::ATOM,
                    i * BKV, b, bar);
    };
  };
  auto load_k = tile_loader(kring, &map_k);
  auto load_v = tile_loader(vring, &map_v);
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);      // published by the rings' init fence
    kring.init();
    vring.init();
    const uint32_t qb = smem_addr(q_bar);
    mbar_expect_tx(qb, NA * wide::ROW_CHUNK);
    for (int a = 0; a < NA; ++a)
      tma_load_3d(base + a * wide::ROW_CHUNK, &map_q, col_r + a * wide::ATOM,
                  q0, b, qb);
    for (int i = 0; i < P::K_STAGES && i < tiles; ++i) load_k(i);
    for (int i = 0; i < P::V_STAGES && i < tiles; ++i) load_v(i);
  }
  __syncthreads();

  // Warpgroup c owns the tile's rows 64c..64c+63, as in attention_kernel
  const int c = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wg_row = q0 + 64 * c, warp_row = wg_row + 16 * warp;
  const int r0 = warp_row + g, r1 = r0 + 8;
  const uint8_t* mrow = mask + static_cast<long long>(b) * T;
  const uint32_t q_addr = smem_addr(base) + c * 64 * 128;

  // O over the rank's columns; where it has 128, the other 128 of the
  // m64n256 product read stale bytes of the V slot and are not stored
  float o[RC / 2];
#pragma unroll
  for (int i = 0; i < RC / 2; ++i) o[i] = 0.f;
  float m0 = MINUS_INF, m1 = MINUS_INF, l0 = 0.f, l1 = 0.f;
  int nb0, nb1;
  auto fetch = [&](int i) {
    const int key = i * BKV + lane;
    nb0 = key < T ? mrow[key] : 0;
    nb1 = key + 32 < T ? mrow[key + 32] : 0;
  };
  fetch(0);
  mbar_wait(smem_addr(q_bar), 0);

  // O += P V of a tile over the rank's columns, its V item at v_addr (MN-
  // major, atoms of 64 keys): issued, then waited for
  uint32_t a[BKV / 16][4];
  auto pv_issue = [&](uint32_t v_addr) {
#pragma unroll
    for (int k = 0; k < BKV / 16; ++k) fence_regs(a[k]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BKV / 16; ++k)
      wgmma_rs<RC>(o, a[k], sw128_desc(v_addr + k * 2048, BKV * 128, 1024));
    wgmma_commit();
  };
  auto pv_finish = [&] {
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int k = 0; k < BKV / 16; ++k) fence_regs(a[k]);
  };

  // Tile i's P V is done in tile i + 1, while the cluster sums its S
  bool pending = false;
  for (int i = 0; i < tiles; ++i) {
    const int k0 = i * BKV;
    const uint64_t valid =
        __ballot_sync(0xffffffffu, nb0 != 0) |
        (static_cast<uint64_t>(__ballot_sync(0xffffffffu, nb1 != 0)) << 32);
    if (i + 1 < tiles) fetch(i + 1);
    // The same in every rank of the cluster
    const bool live =
        valid != 0 && wg_row < T && !(causal && k0 > wg_row + 63);
    // The rank's partial S, then S over the head
    float sc[BKV / 2];
    wide::scores_resident(sc, q_addr, kring, i, NA, live, lane, load_k);
    ex.put(sc, i, live);
    if (i > 0) vring.wait(i - 1);
    if (pending) pv_issue(smem_addr(vring.at(i - 1)));
    ex.get(sc, i, live);
    if (pending) pv_finish();
    if (i > 0) vring.release(i - 1, lane, load_v);
    if (live) {
      float corr0, corr1;
      softmax_tile(sc, a, valid, k0, warp_row, r0, r1, t, causal,
                   scale_log2, m0, m1, l0, l1, corr0, corr1);
      rescale<RC>(o, corr0, corr1);
    }
    pending = live;
  }
  if (tiles > 0) {
    vring.wait(tiles - 1);
    if (pending) {
      pv_issue(smem_addr(vring.at(tiles - 1)));
      pv_finish();
    }
    vring.release(tiles - 1, lane, load_v);
  }
  // Every item is consumed once both warpgroups are here, and no peer
  // reads this block's buffers once the cluster is
  wide::cluster_sync();

  // O / l, staged in bf16 over the resident Q and written by TMA stores of
  // the rank's W columns, none past T
  l0 = quad_sum(l0), l1 = quad_sum(l1);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  rescale<RC>(o, inv0, inv1);
  auto box = [&](int n) {
    return base + (c * (RC / wide::ATOM) + n) * wide::TILE_CHUNK;
  };
  stage_bf16<RC>(o, box, warp, g, t);
  store_boxes(&map_out, NA, wide::ATOM, box, col_r, wg_row, b, c,
              threadIdx.x % 128 == 0, T);
}

int launch_wide(const void* q, const void* k, const void* v, long long rs,
                const void* mask, void* out, long long out_stride, int B,
                int T, int H, int D, float scale_log2, int causal,
                cudaStream_t stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
  // q and k in boxes of one 64-column atom of 128 and 64 rows, v and out
  // of 64 rows
  const long long cols = static_cast<long long>(H) * D, ld2 = T * rs;
  CUtensorMap mq, mk, mv, mo;
  if (!encode_3d(&mq, q, cols, T, B, rs, ld2, wide::ATOM, BQ) ||
      !encode_3d(&mk, k, cols, T, B, rs, ld2, wide::ATOM, BKV) ||
      !encode_3d(&mv, v, cols, T, B, rs, ld2, wide::ATOM, BKV) ||
      !encode_3d(&mo, out, cols, T, B, out_stride, T * out_stride,
                 wide::ATOM, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ranks = wide::ranks(D);
  const dim3 grid(ranks * ((T + BQ - 1) / BQ), H, B);
  return ppgs::residual_ln::launch(wide_kernel, THREADS, WidePlan::SMEM, grid,
                                   ranks, stream, mq, mk, mv, mo,
                                   static_cast<const uint8_t*>(mask), T, D,
                                   scale_log2, causal);
}

}  // namespace

// q, k, v: bf16 (B, T, H*d_head) views with row stride rs elements (3C for
// the fused QKV buffer; rs % 8 == 0 and 16-byte aligned bases, for TMA);
// mask (B, T) bytes, nonzero = valid key; out (B, T, ...) bf16 with row
// stride out_stride (16-byte aligned, out_stride % 8 == 0). scale_log2
// multiplies the fp32 scores before exp2 (1 when the scale is folded into
// q). d_head is 16, 32, 64, 128 or 256, or d_head % 128 == 0 from 384 to
// 2048 (the wide route); any other returns cudaErrorInvalidValue.
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
    case 32:
      return launch<32>(q, k, v, rs, mask, out, out_stride, B, T, H,
                        scale_log2, causal, s);
    case 16:
      return launch<16>(q, k, v, rs, mask, out, out_stride, B, T, H,
                        scale_log2, causal, s);
    default:
      if (!wide::takes(d_head)) return static_cast<int>(cudaErrorInvalidValue);
      return launch_wide(q, k, v, rs, mask, out, out_stride, B, T, H, d_head,
                         scale_log2, causal, s);
  }
}
