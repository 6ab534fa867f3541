// The backward of attention for training (masked multi-head attention with
// dropout on the normalised probabilities), read in place from (B, T, C)
// layouts: two deterministic kernels, a dq pass and a dk/dv pass, on
// wgmma + TMA (the blocks of hopper.cuh). d_head = 128 (the mel model) or
// 256 (the w2v2fb and w2v2fc heads), one template instance each.
//
// Replaces: ppgs_tpu/ops/flash_attention.py _train_bwd_kernel (the
// backward of flash_attention_train, pallas_call at :625) and the
// attention backward inside ppgs_tpu/ops/encoder_layer_train.py
// _bwd_kernel.
//
// The function and its rounding points (those of the JAX kernel and of
// the plain version, ops/flash_attention.py attention_train_bwd_reference):
// with s the fp32 scores q.k, the key mask and the causal mask,
//   pn = exp2(s * scale_log2 - lse)  over the valid keys, else 0,
//   pd = keep ? pn / (1 - rate) : 0,  gp = keep ? (dO V^T) / (1 - rate) : 0,
//   ds = pn (gp - d_row),
//   dq = bf16(ds * sm_scale) K,  dk = bf16(ds * sm_scale)^T Q,
//   dv = bf16(pd)^T dO,  each summed in fp32,
// written as bf16 and/or fp32 through the (B, T, 3C) strides given. lse is
// the forward's, in log2 units (0 on a row with no valid key); d_row =
// rowsum(dO * O) per head (row_dot in attention_train.cu). The keep bits
// are the ones the forward drew (Philox4x32-10 over the flat index (bh T +
// q) T + key, philox.cuh) and wrote, a 32-bit word per query row and 32
// keys; the backward draws none.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s) at the training shape
// (256 windows x T = 512, 2 heads of 128, ragged: about 3/4 of the pairs
// valid): the five products over the valid pairs, 10 x pairs x 128 =
// 0.13 TFLOP (0.13 ms), against 0.875 GB moved (q, k, v, dO in; dq, dk, dv
// out in bf16 and fp32): 0.26 ms, bound by the bytes. The design
// recomputes S and dP in both passes (14 instead of 10 x pairs x 128
// operations): the dq pass could add its dq to fp32 atomics, whose order,
// and so the result, changes from run to run, or write per-key-block dq
// partials, about 0.5 GB more at this shape. Two calls on the same inputs
// give the same bits. At d_head 256 (the w2v2fb head, 256 windows x T =
// 512, 2 heads of 256) the five products are 10 x pairs x 256 = 0.26
// TFLOP (0.26 ms) against 1.75 GB moved: 0.52 ms, bound by the bytes.
//
// Design. Both kernels are K2's (attention.cu) on the same operand forms:
// one block per (128 rows, head, window), two consumer warpgroups of 64
// rows, 256 threads and one block an SM (ptxas: 164 and 175 registers a
// thread in the dq pass, 239 and 247 in the dk/dv pass, without and with
// dropout; no spills). A block's own rows arrive once by TMA and stay;
// the other side streams past in 64-row tiles through a ring of STAGES
// stages with full and empty mbarriers: thread 0 fills it, and the last of
// the eight warps to release a stage refills it. 3-D tensor maps (d, T,
// window) read a head's columns through the row stride and zero-fill rows
// past T; every row and key past T is also masked by index (with lse = 0
// a zero row would give pn = 1).
// - dq pass: Q and dO of 128 queries resident; K and V tiles stream. Per
//   tile and warpgroup S = Q K^T and dP = dO V^T by SS wgmma (both operands
//   K-major) into registers; ds, rounded to bf16, is packed from the
//   accumulators straight into RS A fragments for dQ += dS K, K the
//   MN-major B operand
//   (K2's P V). Tiles past the window's last valid key are not loaded; a
//   tile whose keys are all masked for a warpgroup (the mask, or above the
//   causal diagonal) is skipped; a wholly masked window writes zeros.
// - dk/dv pass: K and V of 128 keys resident; Q and dO tiles stream. S^T =
//   K Q^T and dP^T = V dO^T (SS), then pd and ds packed into RS fragments
//   for dV += Pd^T dO and dK += dS^T Q, dO and Q the MN-major B operands;
//   dK and dV (128 fp32 a thread) stay in registers for the whole walk.
//   Every query tile is walked (queries are not masked, only keys), from
//   the diagonal under causal; a warpgroup whose 64 keys are all masked
//   skips its products, and a block with no valid key loads nothing and
//   writes zeros. lse, d_row and the keep words of a query tile reach each
//   warp through a slot of its own, fetched a tile ahead (any T: no TMA
//   alignment needed).
// - d_head 256 (the w2v2fb head): the dq pass is the same, whole: dQ of 64
//   x 256 fp32 a warpgroup (128 registers) beside S and dP, 234 and 244
//   registers a thread, no spills. Q and dO (128 KB) leave room for three
//   32 KB slots, not two stages of K and V: K tiles take two slots by
//   parity and V tiles one, dP is issued before S, and V's slot is
//   refilled with the next tile's V once dP is done, while S, ds and dQ
//   run (230 KB of shared memory). dK and dV of 64 x 256 fp32 would be
//   256 registers a thread, so the dk/dv pass splits the products instead
//   of the output's columns (dkdv_split_kernel): a block owns 64 keys;
//   warpgroup 1 computes S^T = K Q^T, pn and pd, and dV += Pd^T dO;
//   warpgroup 0 computes dP^T = V dO^T, reads pn from a 16 KB tile that
//   warpgroup 1 writes (named barriers both ways), and dK += dS^T Q. Each
//   product is issued once (a 128-column half a block, as before, issued
//   S and dP twice: 1.5x the products, and streamed every Q/dO tile twice).
//   K and V of 64 keys (64 KB) leave room for two 64 KB stages of Q and
//   dO; dK and dV are staged for their TMA stores in the ring (fp32) and
//   the K and V tiles (bf16), both forms stored at once. 215 KB of
//   shared memory; ptxas 241 and 251 registers, no spills. Both passes'
//   outputs equal the half-split form's bit for bit (the same k16 steps in
//   the same order). Measured on an H100 (scripts/
//   torch_attention_bwd_probe.py, PERF.md section 6): dq 0.50 ms and dk/dv
//   0.81 (0.89 and 1.09 split by halves), their loads-only walks 0.36 and
//   0.56: the stream takes most of each.
// - The keep bits come from the forward: the dq pass reads a row's two
//   words of a key tile, a tile ahead, with the mask bytes; the dk/dv pass
//   the word holding its warp's 16 keys for each of the tile's 64 queries,
//   through the same slot as lse. Drawing them again here cost the dq
//   pass about a third of its time, and the dk/dv pass, whose transposed
//   layout puts a group of four keys in four lanes of a column of quads,
//   about as much (PERF.md, section 6).
// - Outputs: each warpgroup stages its 64 rows, swizzled, in its own rows
//   of the resident tiles (its last product is done, and the other
//   warpgroup reads only its own rows) and writes them by TMA stores of
//   whole 128-byte rows (none past T): fp32 in boxes of 32 columns, bf16 in
//   boxes of 64, one output at a time where they do not fit together.

#include "common.cuh"
#include "hopper.cuh"

using namespace ppgs::hopper;

namespace {

constexpr int ROWS = 128;      // a block's own rows: queries (dq), keys (dk/dv)
constexpr int TILE = 64;       // rows of a streamed tile
constexpr int THREADS = 256;   // two consumer warpgroups
constexpr int ATOM = 64;       // bf16 columns of a 128-byte swizzle atom

template <int D>
struct Plan {
  static constexpr int ATOMS = D / ATOM;
  static constexpr int RES = ROWS * D * 2;       // a resident operand
  static constexpr int OPND = TILE * D * 2;      // a streamed operand
  // d_head 128: stages of two tiles (K and V, or Q and dO); 256 (the dq
  // pass only): slots of one tile, two for K and one for V
  static constexpr bool SPLIT = D > 128;
  static constexpr int STAGE = SPLIT ? OPND : 2 * OPND;
  static constexpr int STAGES = SPLIT ? 3 : 4;
  static constexpr int RING = 2 * RES;
  static constexpr int ROWV = RING + STAGES * STAGE;   // 8 warps' slots
  static constexpr int BARS = ROWV + (SPLIT ? 0 : 8 * 3 * TILE * 4);
  // full[], empty[], the resident operands' barrier, the release counters,
  // the last valid key, and slack to align to 1024 bytes
  static constexpr int SMEM =
      BARS + (2 * STAGES + 1) * 8 + STAGES * 4 + 8 + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// What the two passes share: the shared-memory plan, the ring and its
// release, and the epilogue
template <int D>
struct Block {
  using P = Plan<D>;
  unsigned char* res;     // two resident operands, RES bytes each
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* res_bar;
  int* released;
  int* last_key;

  __device__ __forceinline__ explicit Block(unsigned char* raw) {
    res = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    ring = res + P::RING;
    full = reinterpret_cast<uint64_t*>(res + P::BARS);
    empty = full + P::STAGES;
    res_bar = empty + P::STAGES;
    released = reinterpret_cast<int*>(res_bar + 1);
    last_key = released + P::STAGES;
  }

  // Thread 0: the barriers (eight consumer warps release a stage)
  __device__ __forceinline__ void init() {
    mbar_init(res_bar, 1);
    mbar_init_ring(full, empty, P::STAGES, 8);
    for (int s = 0; s < P::STAGES; ++s) released[s] = 0;
  }

  // Thread 0: the block's 128 rows of two operands into the resident tiles
  __device__ __forceinline__ void load_resident(const CUtensorMap* a,
                                                const CUtensorMap* b,
                                                int col0, int row0,
                                                int window) {
    const uint32_t bar = smem_addr(res_bar);
    mbar_expect_tx(bar, 2 * P::RES);
#pragma unroll
    for (int j = 0; j < P::ATOMS; ++j)
#pragma unroll
      for (int h = 0; h < ROWS / TILE; ++h) {
        const int off = j * ROWS * 128 + h * TILE * 128;
        tma_load_3d(res + off, a, col0 + j * ATOM, row0 + h * TILE, window,
                    bar);
        tma_load_3d(res + P::RES + off, b, col0 + j * ATOM, row0 + h * TILE,
                    window, bar);
      }
  }

  // Tile i (rows row0..row0 + 63 of two operands) into stage i % STAGES
  __device__ __forceinline__ void load_stage(int i, const CUtensorMap* a,
                                             const CUtensorMap* b, int col0,
                                             int row0, int window) {
    const int s = i % P::STAGES;
    const uint32_t bar = smem_addr(full + s);
    mbar_expect_tx(bar, P::STAGE);
    unsigned char* st = ring + s * P::STAGE;
#pragma unroll
    for (int j = 0; j < P::ATOMS; ++j) {
      tma_load_3d(st + j * TILE * 128, a, col0 + j * ATOM, row0, window, bar);
      tma_load_3d(st + P::OPND + j * TILE * 128, b, col0 + j * ATOM, row0,
                  window, bar);
    }
  }

  // Thread 0: rows row0..row0 + 63 of one operand into slot s (SPLIT)
  __device__ __forceinline__ void load_slot(int s, const CUtensorMap* a,
                                            int col0, int row0, int window) {
    const uint32_t bar = smem_addr(full + s);
    mbar_expect_tx(bar, P::OPND);
    unsigned char* st = ring + s * P::STAGE;
#pragma unroll
    for (int j = 0; j < P::ATOMS; ++j)
      tma_load_3d(st + j * TILE * 128, a, col0 + j * ATOM, row0, window, bar);
  }

  // A warp is done with the round-th fill of slot s; when `more`, the last
  // of the eight warps to release it waits for the others and returns true
  // (its lane 0), to refill it
  __device__ __forceinline__ bool release_slot(int s, int round, bool more,
                                               int lane) {
    bool refill = false;
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(smem_addr(empty + s));
      if (more && atomicAdd(released + s, 1) % 8 == 7) {
        mbar_wait(smem_addr(empty + s), round & 1);
        refill = true;
      }
    }
    return refill;
  }

  // A warp is done with tile i's stage; the last of the eight warps to
  // release it refills it with tile i + STAGES (returns true for that lane
  // 0, which then calls load_stage)
  __device__ __forceinline__ bool release(int i, int tiles, int lane) {
    return release_slot(i % P::STAGES, i / P::STAGES, i + P::STAGES < tiles,
                        lane);
  }

  // Warpgroup c's 8 KB chunks of the resident tiles: its 64 rows of each
  // atom of each operand, 2 x ATOMS of them
  __device__ __forceinline__ unsigned char* chunk(int c, int n) const {
    return res + (n / P::ATOMS) * P::RES + (n % P::ATOMS) * ROWS * 128 +
           c * TILE * 128;
  }
};

// The S-like product of one warpgroup: acc (64 x 64, zeroed before the
// wgmma fence) += A (its 64 rows of a resident tile of RES_ROWS) B^T (a
// streamed tile), both K-major over d
template <int D, int RES_ROWS = ROWS>
__device__ __forceinline__ void rows_by_tile(float (&acc)[TILE / 2],
                                             uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<TILE, 0, 0>(
        acc,
        sw128_desc(a + (kk / 4) * (RES_ROWS * 128) + (kk % 4) * 32, 16, 1024),
        sw128_desc(b + (kk / 4) * (TILE * 128) + (kk % 4) * 32, 16, 1024));
}

// acc (64 x D) += frag (64 x 64, bf16 A fragments) B (a streamed tile, 64
// rows x D, the MN-major B operand): 16 rows of 128 bytes a step, the next
// 64 columns one atom on
template <int D>
__device__ __forceinline__ void frag_by_tile(float (&acc)[D / 2],
                                             uint32_t (&frag)[TILE / 16][4],
                                             uint32_t b) {
#pragma unroll
  for (int k = 0; k < TILE / 16; ++k)
    wgmma_rs<D>(acc, frag[k], sw128_desc(b + k * 2048, TILE * 128, 1024));
}

// --------------------------------------------------------------- dq pass

// DROP: apply the forward's keep bits, keep_in (rows of 2 ceil(T / 64)
// uint32; bit k of word w: key 32 w + k kept), scaled by drop_scale
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap map_q,
          const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v,
          const __grid_constant__ CUtensorMap map_do,
          const __grid_constant__ CUtensorMap map_dq16,
          const __grid_constant__ CUtensorMap map_dq32,
          const uint8_t* __restrict__ mask, const float* __restrict__ lse,
          const float* __restrict__ d_row,
          const uint32_t* __restrict__ keep_in, int T, int H,
          float scale_log2, float sm_scale, int causal, float drop_scale,
          int want16, int want32) {
  using P = Plan<D>;
  extern __shared__ unsigned char smem_raw[];
  Block<D> blk(smem_raw);
  const int q0 = blockIdx.x * ROWS, b = blockIdx.z, h = blockIdx.y;
  const int col0 = h * D, bh = b * H + h;
  const uint8_t* mrow = mask + static_cast<long long>(b) * T;

  // The window's last valid key: the tiles past it are not loaded
  if (threadIdx.x == 0) {
    blk.init();
    *blk.last_key = -1;
  }
  __syncthreads();
  int last = -1;
  for (int i = threadIdx.x; i < T; i += THREADS)
    if (mrow[i]) last = i;
  last = __reduce_max_sync(0xffffffffu, last);
  if (threadIdx.x % 32 == 0 && last >= 0) atomicMax(blk.last_key, last);
  __syncthreads();
  int tiles = (*blk.last_key + TILE) / TILE;
  if (causal) tiles = min(tiles, (min(q0 + ROWS, T) - 1) / TILE + 1);

  auto load = [&](int i) {
    blk.load_stage(i, &map_k, &map_v, col0, i * TILE, b);
  };
  if (threadIdx.x == 0 && tiles > 0) {
    blk.load_resident(&map_q, &map_do, col0, q0, b);
    if constexpr (P::SPLIT) {
      // K tiles into slots 0 and 1 by parity, V tiles into slot 2
      for (int i = 0; i < 2 && i < tiles; ++i)
        blk.load_slot(i, &map_k, col0, i * TILE, b);
      blk.load_slot(2, &map_v, col0, 0, b);
    } else {
      for (int i = 0; i < P::STAGES && i < tiles; ++i) load(i);
    }
  }

  // Warpgroup c owns queries 64c..64c+63 of the block; a thread rows r0,
  // r1 and columns 8j + 2t + {0, 1} of the accumulators
  const int c = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wg_row = q0 + 64 * c;
  const int r0 = wg_row + 16 * warp + g, r1 = r0 + 8;
  const long long row_base = static_cast<long long>(bh) * T;
  const int keep_words = 2 * ((T + TILE - 1) / TILE);
  const float lse0 = r0 < T ? lse[row_base + r0] : 0.f;
  const float lse1 = r1 < T ? lse[row_base + r1] : 0.f;
  const float drow0 = r0 < T ? d_row[row_base + r0] : 0.f;
  const float drow1 = r1 < T ? d_row[row_base + r1] : 0.f;
  const uint32_t q_addr = smem_addr(blk.res) + c * TILE * 128;
  const uint32_t do_addr = q_addr + P::RES;
  const uint32_t ring_addr = smem_addr(blk.ring);

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  // This lane's mask bytes of a tile (keys + lane and + 32 + lane) and
  // the keep words of its rows r0, r1 there, read a tile ahead of their use
  int nb0 = 0, nb1 = 0;
  uint2 nk0 = make_uint2(0u, 0u), nk1 = nk0;
  auto fetch = [&](int i) {
    const int key = i * TILE + lane;
    nb0 = key < T ? mrow[key] : 0;
    nb1 = key + 32 < T ? mrow[key + 32] : 0;
    if constexpr (DROP) {
      const uint2* kw = reinterpret_cast<const uint2*>(
          keep_in + (row_base + r0) * keep_words) + i;
      nk0 = r0 < T ? kw[0] : make_uint2(0u, 0u);
      nk1 = r1 < T ? kw[4 * keep_words] : make_uint2(0u, 0u);
    }
  };
  if (tiles > 0) {
    fetch(0);
    mbar_wait(smem_addr(blk.res_bar), 0);
  }

  // ds = pn (gp - d_row), rounded with sm_scale into the A fragments of
  // dQ += dS K from the tile's S and dP: a[k] holds keys 16k..16k+15,
  // groups j = 2k (registers 0, 1) and 2k + 1 (2, 3)
  auto ds_frags = [&](const float (&sc)[TILE / 2],
                      const float (&dp)[TILE / 2], uint32_t (&a)[TILE / 16][4],
                      uint64_t valid, int k0, uint2 kw0, uint2 kw1) {
    const bool full_tile = valid == ~0ull && r1 < T &&
                           !(causal && k0 + TILE - 1 > wg_row + 16 * warp);
    const uint64_t bits = valid >> (2 * t);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1, key = k0 + 8 * j + 2 * t + e % 2;
        const bool ok = full_tile ||
                        (((bits >> (8 * j + e % 2)) & 1u) && row < T &&
                         !(causal && key > row));
        const float pn =
            ok ? exp2_approx(fmaf(sc[4 * j + e], scale_log2,
                                  e < 2 ? -lse0 : -lse1))
               : 0.f;
        float gp = dp[4 * j + e];
        if constexpr (DROP) {
          const uint2 w = e < 2 ? kw0 : kw1;
          const bool keep =
              ((j < 4 ? w.x : w.y) >> (8 * (j % 4) + 2 * t + e % 2)) & 1u;
          gp = keep ? gp * drop_scale : 0.f;
        }
        v[e] = pn * (gp - (e < 2 ? drow0 : drow1)) * sm_scale;
      }
      a[j / 2][2 * (j % 2)] = pack_bf16(v[0], v[1]);
      a[j / 2][2 * (j % 2) + 1] = pack_bf16(v[2], v[3]);
    }
  };
  // dQ += dS K (K the tile at k_addr)
  auto dq_product = [&](uint32_t (&a)[TILE / 16][4], uint32_t k_addr) {
#pragma unroll
    for (int k = 0; k < TILE / 16; ++k) fence_regs(a[k]);
    fence_regs(dq);
    wgmma_fence();
    frag_by_tile<D>(dq, a, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
#pragma unroll
    for (int k = 0; k < TILE / 16; ++k) fence_regs(a[k]);
  };

  for (int i = 0; i < tiles; ++i) {
    const int k0 = i * TILE;
    // The tile's valid keys, bit k for key k0 + k (the same in every warp)
    const uint64_t valid =
        __ballot_sync(0xffffffffu, nb0 != 0) |
        (static_cast<uint64_t>(__ballot_sync(0xffffffffu, nb1 != 0)) << 32);
    const uint2 kw0 = nk0, kw1 = nk1;
    if (i + 1 < tiles) fetch(i + 1);
    const bool live =
        valid != 0 && wg_row < T && !(causal && k0 > wg_row + 63);
    if constexpr (P::SPLIT) {
      // dP first, so that the V slot is refilled with tile i + 1 while S,
      // ds and dQ run; the K slot of tile i with tile i + 2 after dQ
      const int ks = i & 1;
      const uint32_t k_addr = ring_addr + ks * P::STAGE;
      const uint32_t v_addr = ring_addr + 2 * P::STAGE;
      mbar_wait(smem_addr(blk.full + ks), (i >> 1) & 1);
      mbar_wait(smem_addr(blk.full + 2), i & 1);
      float sc[TILE / 2], dp[TILE / 2];
      if (live) {
        zero(sc);
        zero(dp);
        wgmma_fence();
        rows_by_tile<D>(dp, do_addr, v_addr);
        wgmma_commit();
        rows_by_tile<D>(sc, q_addr, k_addr);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dp);
      }
      if (blk.release_slot(2, i, i + 1 < tiles, lane))
        blk.load_slot(2, &map_v, col0, (i + 1) * TILE, b);
      __syncwarp();
      if (live) {
        wgmma_wait<0>();
        fence_regs(sc);
        uint32_t a[TILE / 16][4];
        ds_frags(sc, dp, a, valid, k0, kw0, kw1);
        dq_product(a, k_addr);
      }
      if (blk.release_slot(ks, i >> 1, i + 2 < tiles, lane))
        blk.load_slot(ks, &map_k, col0, (i + 2) * TILE, b);
      __syncwarp();
    } else {
      const int s = i % P::STAGES;
      mbar_wait(smem_addr(blk.full + s), (i / P::STAGES) & 1);
      if (live) {
        const uint32_t k_addr = ring_addr + s * P::STAGE;
        const uint32_t v_addr = k_addr + P::OPND;
        float sc[TILE / 2], dp[TILE / 2];
        zero(sc);
        zero(dp);
        wgmma_fence();
        rows_by_tile<D>(sc, q_addr, k_addr);
        rows_by_tile<D>(dp, do_addr, v_addr);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        uint32_t a[TILE / 16][4];
        ds_frags(sc, dp, a, valid, k0, kw0, kw1);
        dq_product(a, k_addr);
      }
      if (blk.release(i, tiles, lane)) load(i + P::STAGES);
      __syncwarp();
    }
  }

  // dq out of the warpgroup's rows of the Q and dO tiles; at d_head 256
  // the bf16 form at once out of the ring, free once both warpgroups are
  // done
  auto box = [&](int n) { return blk.chunk(c, n); };
  const bool lead = threadIdx.x % 128 == 0;
  if constexpr (P::SPLIT) {
    __syncthreads();
    auto box16 = [&](int n) { return blk.ring + c * 32768 + n * 8192; };
    if (want32) stage_f32<D>(dq, box, warp, g, t);
    if (want16) stage_bf16<D>(dq, box16, warp, g, t);
    fence_async_smem();
    bar_sync(1 + c, 128);
    if (lead && wg_row < T) {
      if (want32)
        for (int n = 0; n < D / 32; ++n)
          tma_store_3d(&map_dq32, col0 + 32 * n, wg_row, b, box(n));
      if (want16)
        for (int n = 0; n < D / 64; ++n)
          tma_store_3d(&map_dq16, col0 + 64 * n, wg_row, b, box16(n));
      bulk_commit();
      bulk_wait_read();   // the staging outlives its stores
    }
  } else {
    if (want32) {
      stage_f32<D>(dq, box, warp, g, t);
      store_boxes(&map_dq32, D / 32, 32, box, col0, wg_row, b, c, lead, T);
    }
    if (want16) {
      stage_bf16<D>(dq, box, warp, g, t);
      store_boxes(&map_dq16, D / 64, 64, box, col0, wg_row, b, c, lead, T);
    }
  }
}

// ---------------------------------------------------------- dk, dv pass

// DROP: apply the forward's keep bits, keep_in, as dq_kernel does
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
            const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v,
            const __grid_constant__ CUtensorMap map_do,
            const __grid_constant__ CUtensorMap map_dk16,
            const __grid_constant__ CUtensorMap map_dk32,
            const __grid_constant__ CUtensorMap map_dv16,
            const __grid_constant__ CUtensorMap map_dv32,
            const uint8_t* __restrict__ mask, const float* __restrict__ lse,
            const float* __restrict__ d_row,
            const uint32_t* __restrict__ keep_in, int T, int H,
            float scale_log2, float sm_scale, int causal, float drop_scale,
            int want16, int want32) {
  using P = Plan<D>;
  extern __shared__ unsigned char smem_raw[];
  Block<D> blk(smem_raw);
  const int k0b = blockIdx.x * ROWS, b = blockIdx.z, h = blockIdx.y;
  const int col0 = h * D, bh = b * H + h;
  const uint8_t* mrow = mask + static_cast<long long>(b) * T;

  // Warpgroup c owns keys wg_key..wg_key+63; a thread key rows kr0, kr1
  // and query columns 8j + 2t + {0, 1} of the accumulators
  const int c = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wg_key = k0b + 64 * c, warp_key = wg_key + 16 * warp;
  const int kr0 = warp_key + g, kr1 = kr0 + 8;
  // The warpgroup's valid keys, bit k for key wg_key + k
  const int m0 = wg_key + lane, m1 = m0 + 32;
  const uint64_t kvalid =
      __ballot_sync(0xffffffffu, m0 < T && mrow[m0] != 0) |
      (static_cast<uint64_t>(
           __ballot_sync(0xffffffffu, m1 < T && mrow[m1] != 0))
       << 32);
  const bool kv0 = (kvalid >> (16 * warp + g)) & 1u;
  const bool kv1 = (kvalid >> (16 * warp + g + 8)) & 1u;

  if (threadIdx.x == 0) blk.init();
  // A block with no valid key loads nothing and writes zeros
  const int first = causal ? k0b / TILE : 0;
  const int tiles =
      __syncthreads_or(kvalid != 0) ? (T + TILE - 1) / TILE - first : 0;

  auto load = [&](int i) {
    blk.load_stage(i, &map_q, &map_do, col0, (first + i) * TILE, b);
  };
  if (threadIdx.x == 0 && tiles > 0) {
    blk.load_resident(&map_k, &map_v, col0, k0b, b);
    for (int i = 0; i < P::STAGES && i < tiles; ++i) load(i);
  }

  const uint32_t k_addr = smem_addr(blk.res) + c * TILE * 128;
  const uint32_t v_addr = k_addr + P::RES;
  const uint32_t ring_addr = smem_addr(blk.ring);
  const long long row_base = static_cast<long long>(bh) * T;
  // The warp's slot: lse of the tile's 64 queries, their d_row, and the
  // keep word of each holding the warp's 16 keys (bits key % 32)
  float* slot = reinterpret_cast<float*>(blk.res + P::ROWV) +
                (threadIdx.x / 32) * 3 * TILE;
  uint32_t* slot_keep = reinterpret_cast<uint32_t*>(slot + 2 * TILE);
  const int keep_words = 2 * ((T + TILE - 1) / TILE);
  const int keep_shift = (warp_key & 16) + g;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = 0.f, dv[i] = 0.f;

  // This lane's lse, d_row and keep words of a tile (queries + 2 lane, + 2
  // lane + 1), read a tile ahead of their use. A row holds the words of
  // 64 ceil(T / 64) keys: where that count is odd, warpgroup 1 of the last
  // block holds keys past them (none valid) and reads no word, which would
  // lie past the row (past the buffer, for the last row)
  const bool keys_in_row = warp_key / 32 < keep_words;
  float nl0 = 0.f, nl1 = 0.f, nd0 = 0.f, nd1 = 0.f;
  uint32_t nk0 = 0u, nk1 = 0u;
  auto fetch = [&](int i) {
    const int qi = (first + i) * TILE + 2 * lane;
    nl0 = qi < T ? lse[row_base + qi] : 0.f;
    nd0 = qi < T ? d_row[row_base + qi] : 0.f;
    nl1 = qi + 1 < T ? lse[row_base + qi + 1] : 0.f;
    nd1 = qi + 1 < T ? d_row[row_base + qi + 1] : 0.f;
    if constexpr (DROP) {
      const uint32_t* kw = keep_in + (row_base + qi) * keep_words +
                           warp_key / 32;
      nk0 = keys_in_row && qi < T ? kw[0] : 0u;
      nk1 = keys_in_row && qi + 1 < T ? kw[keep_words] : 0u;
    }
  };
  if (tiles > 0) {
    fetch(0);
    mbar_wait(smem_addr(blk.res_bar), 0);
  }

  for (int i = 0; i < tiles; ++i) {
    const int s = i % P::STAGES, q0 = (first + i) * TILE;
    *reinterpret_cast<float2*>(slot + 2 * lane) = make_float2(nl0, nl1);
    *reinterpret_cast<float2*>(slot + TILE + 2 * lane) =
        make_float2(nd0, nd1);
    if constexpr (DROP)
      *reinterpret_cast<uint2*>(slot_keep + 2 * lane) = make_uint2(nk0, nk1);
    __syncwarp();
    if (i + 1 < tiles) fetch(i + 1);
    const bool live = kvalid != 0 && !(causal && q0 + TILE - 1 < wg_key);
    mbar_wait(smem_addr(blk.full + s), (i / P::STAGES) & 1);
    if (live) {
      const uint32_t q_addr = ring_addr + s * P::STAGE;
      const uint32_t do_addr = q_addr + P::OPND;
      float sc[TILE / 2], dp[TILE / 2];
      zero(sc);
      zero(dp);
      wgmma_fence();
      rows_by_tile<D>(sc, k_addr, q_addr);
      rows_by_tile<D>(dp, v_addr, do_addr);
      wgmma_commit();

      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // pd and ds into the A fragments of dV += Pd^T dO and dK += dS^T Q
      const bool full_tile = kv0 && kv1 && q0 + TILE <= T &&
                             !(causal && warp_key + 15 > q0);
      uint32_t apd[TILE / 16][4], ads[TILE / 16][4];
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(slot + 8 * j + 2 * t);
        const float2 d2 =
            *reinterpret_cast<const float2*>(slot + TILE + 8 * j + 2 * t);
        uint2 k2 = make_uint2(~0u, ~0u);
        if constexpr (DROP)
          k2 = *reinterpret_cast<const uint2*>(slot_keep + 8 * j + 2 * t);
        float pv[4], sv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + 8 * j + 2 * t + e % 2;
          const int key = e < 2 ? kr0 : kr1;
          const bool ok = full_tile || ((e < 2 ? kv0 : kv1) && qi < T &&
                                        !(causal && key > qi));
          const float l = e % 2 ? l2.y : l2.x, dr = e % 2 ? d2.y : d2.x;
          const float pn =
              ok ? exp2_approx(fmaf(sc[4 * j + e], scale_log2, -l)) : 0.f;
          float gp = dp[4 * j + e], pd = pn;
          if constexpr (DROP) {
            const bool keep =
                ((e % 2 ? k2.y : k2.x) >> (keep_shift + 8 * (e / 2))) & 1u;
            gp = keep ? gp * drop_scale : 0.f;
            pd = keep ? pn * drop_scale : 0.f;
          }
          pv[e] = pd;
          sv[e] = pn * (gp - dr) * sm_scale;
        }
        apd[j / 2][2 * (j % 2)] = pack_bf16(pv[0], pv[1]);
        apd[j / 2][2 * (j % 2) + 1] = pack_bf16(pv[2], pv[3]);
        ads[j / 2][2 * (j % 2)] = pack_bf16(sv[0], sv[1]);
        ads[j / 2][2 * (j % 2) + 1] = pack_bf16(sv[2], sv[3]);
      }

#pragma unroll
      for (int k = 0; k < TILE / 16; ++k) {
        fence_regs(apd[k]);
        fence_regs(ads[k]);
      }
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      frag_by_tile<D>(dv, apd, do_addr);
      frag_by_tile<D>(dk, ads, q_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int k = 0; k < TILE / 16; ++k) {
        fence_regs(apd[k]);
        fence_regs(ads[k]);
      }
    }
    if (blk.release(i, tiles, lane)) load(i + P::STAGES);
    __syncwarp();
  }

  // dk and dv out of the warpgroup's rows of the K and V tiles: fp32 one at
  // a time (each fills them), bf16 both at once
  auto box = [&](int n) { return blk.chunk(c, n); };
  auto box_v = [&](int n) { return blk.chunk(c, P::ATOMS + n); };
  const bool lead = threadIdx.x % 128 == 0;
  if (want32) {
    stage_f32<D>(dk, box, warp, g, t);
    store_boxes(&map_dk32, D / 32, 32, box, col0, wg_key, b, c, lead, T);
    stage_f32<D>(dv, box, warp, g, t);
    store_boxes(&map_dv32, D / 32, 32, box, col0, wg_key, b, c, lead, T);
  }
  if (want16) {
    stage_bf16<D>(dk, box, warp, g, t);
    stage_bf16<D>(dv, box_v, warp, g, t);
    fence_async_smem();
    bar_sync(1 + c, 128);
    if (lead && wg_key < T) {
      for (int n = 0; n < D / ATOM; ++n) {
        tma_store_3d(&map_dk16, col0 + n * ATOM, wg_key, b, box(n));
        tma_store_3d(&map_dv16, col0 + n * ATOM, wg_key, b, box_v(n));
      }
      bulk_commit();
      bulk_wait_read();
    }
  }
}

// ------------------------------------------- dk, dv pass at d_head 256

// Shared memory of the d_head 256 dk/dv pass: K and V of 64 keys
// resident, a ring of Q/dO tiles, the pn tile handed from the dV side to
// the dK side (32 fp32 a thread), and each warp's slot as dkdv_kernel's
struct Split {
  static constexpr int D = 256, ATOMS = D / ATOM;
  static constexpr int RES = TILE * D * 2;        // K or V: 32 KB
  static constexpr int OPND = TILE * D * 2;       // Q or dO tile
  static constexpr int STAGE = 2 * OPND;
  static constexpr int STAGES = 2;
  static constexpr int RING = 2 * RES;
  static constexpr int PN = RING + STAGES * STAGE;
  static constexpr int ROWV = PN + 128 * (TILE / 2) * 4;
  static constexpr int BARS = ROWV + 8 * 3 * TILE * 4;
  // full[], empty[], the resident operands' barrier, the release counters
  static constexpr int SMEM =
      BARS + (2 * STAGES + 1) * 8 + STAGES * 4 + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// Named barriers of the split pass (1 and 2 are store_boxes'): the pn
// tile written by the dV side (PN_FULL) and read by the dK side (PN_FREE)
constexpr int PN_FULL = 3, PN_FREE = 4;

// The dk/dv pass at d_head 256: a block owns 64 keys, and its two
// warpgroups split the products instead of the output's columns:
// warpgroup 1 computes S^T = K Q^T, pn and pd, and dV += Pd^T dO (64 x 256
// fp32, 128 registers a thread); warpgroup 0 computes dP^T = V dO^T, takes
// pn from warpgroup 1 through shared memory, and dK += dS^T Q. Each product
// is issued once.
template <bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_split_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_do,
                  const __grid_constant__ CUtensorMap map_dk16,
                  const __grid_constant__ CUtensorMap map_dk32,
                  const __grid_constant__ CUtensorMap map_dv16,
                  const __grid_constant__ CUtensorMap map_dv32,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ lse,
                  const float* __restrict__ d_row,
                  const uint32_t* __restrict__ keep_in, int T, int H,
                  float scale_log2, float sm_scale, int causal,
                  float drop_scale, int want16, int want32) {
  using P = Split;
  constexpr int D = P::D, STAGES = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* res = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = res + P::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(res + P::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* res_bar = empty + STAGES;
  int* released = reinterpret_cast<int*>(res_bar + 1);
  const int k0b = blockIdx.x * TILE, b = blockIdx.z, h = blockIdx.y;
  const int col0 = h * D, bh = b * H + h;
  const uint8_t* mrow = mask + static_cast<long long>(b) * T;

  // Warpgroup c (0: dK, 1: dV) over the block's 64 keys; a thread key rows
  // kr0, kr1 and query columns 8j + 2t + {0, 1} of the S-like tiles
  const int c = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int warp_key = k0b + 16 * warp;
  const int kr0 = warp_key + g, kr1 = kr0 + 8;
  // The block's valid keys, bit k for key k0b + k
  const int m0 = k0b + lane, m1 = m0 + 32;
  const uint64_t kvalid =
      __ballot_sync(0xffffffffu, m0 < T && mrow[m0] != 0) |
      (static_cast<uint64_t>(
           __ballot_sync(0xffffffffu, m1 < T && mrow[m1] != 0))
       << 32);
  const bool kv0 = (kvalid >> (16 * warp + g)) & 1u;
  const bool kv1 = (kvalid >> (16 * warp + g + 8)) & 1u;

  if (threadIdx.x == 0) {
    mbar_init(res_bar, 1);
    mbar_init_ring(full, empty, STAGES, 8);
    for (int s = 0; s < STAGES; ++s) released[s] = 0;
  }
  __syncthreads();
  // A block with no valid key loads nothing and writes zeros
  const int first = causal ? k0b / TILE : 0;
  const int tiles = kvalid != 0 ? (T + TILE - 1) / TILE - first : 0;

  // Tile i (queries (first + i) * 64..) of Q and dO into stage i % STAGES
  auto load = [&](int i) {
    const int s = i % STAGES;
    const uint32_t bar = smem_addr(full + s);
    mbar_expect_tx(bar, P::STAGE);
    unsigned char* st = ring + s * P::STAGE;
#pragma unroll
    for (int j = 0; j < P::ATOMS; ++j) {
      tma_load_3d(st + j * TILE * 128, &map_q, col0 + j * ATOM,
                  (first + i) * TILE, b, bar);
      tma_load_3d(st + P::OPND + j * TILE * 128, &map_do, col0 + j * ATOM,
                  (first + i) * TILE, b, bar);
    }
  };
  if (threadIdx.x == 0 && tiles > 0) {
    const uint32_t bar = smem_addr(res_bar);
    mbar_expect_tx(bar, 2 * P::RES);
#pragma unroll
    for (int j = 0; j < P::ATOMS; ++j) {
      tma_load_3d(res + j * TILE * 128, &map_k, col0 + j * ATOM, k0b, b, bar);
      tma_load_3d(res + P::RES + j * TILE * 128, &map_v, col0 + j * ATOM, k0b,
                  b, bar);
    }
    for (int i = 0; i < STAGES && i < tiles; ++i) load(i);
  }

  // The dV side multiplies K, the dK side V
  const uint32_t kv_addr = smem_addr(res) + (c == 1 ? 0 : P::RES);
  const uint32_t ring_addr = smem_addr(ring);
  const long long row_base = static_cast<long long>(bh) * T;
  float* slot = reinterpret_cast<float*>(res + P::ROWV) +
                (threadIdx.x / 32) * 3 * TILE;
  uint32_t* slot_keep = reinterpret_cast<uint32_t*>(slot + 2 * TILE);
  const int keep_words = 2 * ((T + TILE - 1) / TILE);
  const int keep_shift = (warp_key & 16) + g;
  // The pn tile: value i of thread x at pn_buf[i * 128 + x]
  float* pn_buf = reinterpret_cast<float*>(res + P::PN) + threadIdx.x % 128;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  float nl0 = 0.f, nl1 = 0.f, nd0 = 0.f, nd1 = 0.f;
  uint32_t nk0 = 0u, nk1 = 0u;
  auto fetch = [&](int i) {
    const int qi = (first + i) * TILE + 2 * lane;
    nl0 = qi < T ? lse[row_base + qi] : 0.f;
    nd0 = qi < T ? d_row[row_base + qi] : 0.f;
    nl1 = qi + 1 < T ? lse[row_base + qi + 1] : 0.f;
    nd1 = qi + 1 < T ? d_row[row_base + qi + 1] : 0.f;
    if constexpr (DROP) {
      const uint32_t* kw = keep_in + (row_base + qi) * keep_words +
                           warp_key / 32;
      nk0 = qi < T ? kw[0] : 0u;
      nk1 = qi + 1 < T ? kw[keep_words] : 0u;
    }
  };
  if (tiles > 0) {
    fetch(0);
    mbar_wait(smem_addr(res_bar), 0);
  }

  bool handed = false;        // the dV side has written a pn tile
  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES, q0 = (first + i) * TILE;
    *reinterpret_cast<float2*>(slot + 2 * lane) = make_float2(nl0, nl1);
    *reinterpret_cast<float2*>(slot + TILE + 2 * lane) =
        make_float2(nd0, nd1);
    if constexpr (DROP)
      *reinterpret_cast<uint2*>(slot_keep + 2 * lane) = make_uint2(nk0, nk1);
    __syncwarp();
    if (i + 1 < tiles) fetch(i + 1);
    // The same for both warpgroups: they own the same keys
    const bool live = !(causal && q0 + TILE - 1 < k0b);
    mbar_wait(smem_addr(full + s), (i / STAGES) & 1);
    if (live) {
      const uint32_t q_addr = ring_addr + s * P::STAGE;
      const uint32_t do_addr = q_addr + P::OPND;
      float sl[TILE / 2];
      zero(sl);
      wgmma_fence();
      // S^T = K Q^T (dV side) or dP^T = V dO^T (dK side)
      rows_by_tile<D, TILE>(sl, kv_addr, c == 1 ? q_addr : do_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sl);

      const bool full_tile = kv0 && kv1 && q0 + TILE <= T &&
                             !(causal && warp_key + 15 > q0);
      uint32_t frag[TILE / 16][4];
      if (c == 1) {
        // pn, handed to the dK side, and pd into the A fragments of dV +=
        // Pd^T dO
        if (handed) bar_sync(PN_FREE, 256);
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(slot + 8 * j + 2 * t);
          uint2 k2 = make_uint2(~0u, ~0u);
          if constexpr (DROP)
            k2 = *reinterpret_cast<const uint2*>(slot_keep + 8 * j + 2 * t);
          float pv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + 8 * j + 2 * t + e % 2;
            const int key = e < 2 ? kr0 : kr1;
            const bool ok = full_tile || ((e < 2 ? kv0 : kv1) && qi < T &&
                                          !(causal && key > qi));
            const float l = e % 2 ? l2.y : l2.x;
            const float pn =
                ok ? exp2_approx(fmaf(sl[4 * j + e], scale_log2, -l)) : 0.f;
            float pd = pn;
            if constexpr (DROP) {
              const bool keep =
                  ((e % 2 ? k2.y : k2.x) >> (keep_shift + 8 * (e / 2))) & 1u;
              pd = keep ? pn * drop_scale : 0.f;
            }
            pn_buf[(4 * j + e) * 128] = pn;
            pv[e] = pd;
          }
          frag[j / 2][2 * (j % 2)] = pack_bf16(pv[0], pv[1]);
          frag[j / 2][2 * (j % 2) + 1] = pack_bf16(pv[2], pv[3]);
        }
        bar_arrive(PN_FULL, 256);
        handed = true;
      } else {
        // ds = pn (gp - d_row), rounded with sm_scale, into the A
        // fragments of dK += dS^T Q
        bar_sync(PN_FULL, 256);
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(slot + TILE + 8 * j + 2 * t);
          uint2 k2 = make_uint2(~0u, ~0u);
          if constexpr (DROP)
            k2 = *reinterpret_cast<const uint2*>(slot_keep + 8 * j + 2 * t);
          float sv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dr = e % 2 ? d2.y : d2.x;
            const float pn = pn_buf[(4 * j + e) * 128];
            float gp = sl[4 * j + e];
            if constexpr (DROP) {
              const bool keep =
                  ((e % 2 ? k2.y : k2.x) >> (keep_shift + 8 * (e / 2))) & 1u;
              gp = keep ? gp * drop_scale : 0.f;
            }
            sv[e] = pn * (gp - dr) * sm_scale;
          }
          frag[j / 2][2 * (j % 2)] = pack_bf16(sv[0], sv[1]);
          frag[j / 2][2 * (j % 2) + 1] = pack_bf16(sv[2], sv[3]);
        }
        if (i + 1 < tiles) bar_arrive(PN_FREE, 256);
      }

#pragma unroll
      for (int k = 0; k < TILE / 16; ++k) fence_regs(frag[k]);
      fence_regs(acc);
      wgmma_fence();
      frag_by_tile<D>(acc, frag, c == 1 ? do_addr : q_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < TILE / 16; ++k) fence_regs(frag[k]);
    }
    // The last of the eight warps to release a stage refills it
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

  // dK (warpgroup 0) or dV (1) out by TMA stores of both forms at once:
  // fp32 boxes of 32 columns from the ring's first 64 KB or next, bf16
  // boxes of 64 from the K or V tile
  __syncthreads();
  auto box32 = [&](int n) { return ring + c * 65536 + n * 8192; };
  auto box16 = [&](int n) { return res + c * P::RES + n * 8192; };
  if (want32) stage_f32<D>(acc, box32, warp, g, t);
  if (want16) stage_bf16<D>(acc, box16, warp, g, t);
  fence_async_smem();
  bar_sync(1 + c, 128);
  if (threadIdx.x % 128 == 0 && k0b < T) {
    const CUtensorMap* out32 = c == 0 ? &map_dk32 : &map_dv32;
    const CUtensorMap* out16 = c == 0 ? &map_dk16 : &map_dv16;
    if (want32)
      for (int n = 0; n < D / 32; ++n)
        tma_store_3d(out32, col0 + 32 * n, k0b, b, box32(n));
    if (want16)
      for (int n = 0; n < D / 64; ++n)
        tma_store_3d(out16, col0 + 64 * n, k0b, b, box16(n));
    bulk_commit();
    bulk_wait_read();   // the staging outlives its stores
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, bool DROP>
int launch(const CUtensorMap* in, const CUtensorMap* out, const void* mask,
           const void* lse, const void* keep, const void* d_row, int B,
           int T, int H, float scale_log2, float sm_scale, int causal,
           float drop_scale, int want16, int want32, cudaStream_t stream) {
  using P = Plan<D>;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once
  static const cudaError_t attr_q = allow_smem(dq_kernel<D, DROP>, P::SMEM);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  const dim3 grid((T + ROWS - 1) / ROWS, H, B);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(d_row);
  const uint32_t* bits = static_cast<const uint32_t*>(keep);
  dq_kernel<D, DROP><<<grid, THREADS, P::SMEM, stream>>>(
      in[0], in[1], in[2], in[3], out[0], out[1], m, l, d, bits, T, H,
      scale_log2, sm_scale, causal, drop_scale, want16, want32);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (D == 256) {
    static const cudaError_t attr_k =
        allow_smem(dkdv_split_kernel<DROP>, Split::SMEM);
    if (attr_k != cudaSuccess) return static_cast<int>(attr_k);
    dkdv_split_kernel<DROP>
        <<<dim3((T + TILE - 1) / TILE, H, B), THREADS, Split::SMEM, stream>>>(
            in[0], in[1], in[2], in[3], out[2], out[3], out[4], out[5], m, l,
            d, bits, T, H, scale_log2, sm_scale, causal, drop_scale, want16,
            want32);
  } else {
    static const cudaError_t attr_k =
        allow_smem(dkdv_kernel<D, DROP>, P::SMEM);
    if (attr_k != cudaSuccess) return static_cast<int>(attr_k);
    dkdv_kernel<D, DROP><<<grid, THREADS, P::SMEM, stream>>>(
        in[0], in[1], in[2], in[3], out[2], out[3], out[4], out[5], m, l, d,
        bits, T, H, scale_log2, sm_scale, causal, drop_scale, want16, want32);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_width(const void* q, const void* k, const void* v, long long rs,
                 const void* mask, const void* lse, const void* keep,
                 const void* dout, long long do_stride, const void* d_row,
                 void* const (&outs)[6], long long d_stride, int B, int T,
                 int H, float scale_log2, float sm_scale, int causal,
                 float drop_scale, cudaStream_t s) {
  // (columns, T, window) views: the inputs in 64 x 64 boxes, the outputs
  // in boxes of 64 rows of 128 bytes
  const long long cols = static_cast<long long>(H) * D;
  CUtensorMap in[4], out[6] = {};
  const void* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const long long ld = i == 3 ? do_stride : rs;
    if (!encode_3d(&in[i], bases[i], cols, T, B, ld, T * ld, ATOM, TILE))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 6; ++i) {
    const bool f32 = i % 2 == 1;
    if (outs[i] && !encode_3d(&out[i], outs[i], cols, T, B, d_stride,
                              T * d_stride, f32 ? 32 : ATOM, TILE, f32))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int want16 = outs[0] != nullptr, want32 = outs[1] != nullptr;
  if (keep)
    return launch<D, true>(in, out, mask, lse, keep, d_row, B, T, H,
                           scale_log2, sm_scale, causal, drop_scale, want16,
                           want32, s);
  return launch<D, false>(in, out, mask, lse, keep, d_row, B, T, H,
                          scale_log2, sm_scale, causal, drop_scale, want16,
                          want32, s);
}

}  // namespace

// q, k, v: bf16 (B, T, H*d) views with row stride rs, d = d_head 128 or
// 256; mask (B, T) bytes, nonzero = valid key; lse and d_row (B, H, T)
// fp32; keep: the forward's keep bits, B x H x T x 2 ceil(T / 64) uint32
// (ppgs_attention_train_fwd), or null when the dropout is off; drop_scale
// = 1 / (1 - rate); dout (B, T, H*d) bf16 with row stride do_stride; dq,
// dk, dv written as bf16 and/or fp32 (null skips; dq16, dk16, dv16 all
// null or none, likewise the fp32 ones) with row stride d_stride. TMA:
// 16-byte aligned bases, rs, do_stride and d_stride multiples of 8
// elements. Any other d returns cudaErrorInvalidValue.
extern "C" int ppgs_attention_train_bwd(
    const void* q, const void* k, const void* v, long long rs,
    const void* mask, const void* lse, const void* keep, const void* dout,
    long long do_stride, const void* d_row, void* dq16, void* dq32,
    void* dk16, void* dk32, void* dv16, void* dv32, long long d_stride,
    int B, int T, int H, int d, float scale_log2, float sm_scale,
    int causal, float drop_scale, void* stream) {
  if (d != 128 && d != 256) return static_cast<int>(cudaErrorInvalidValue);
  void* const outs[6] = {dq16, dq32, dk16, dk32, dv16, dv32};
  const bool want16 = dq16 != nullptr, want32 = dq32 != nullptr;
  if ((dk16 != nullptr) != want16 || (dv16 != nullptr) != want16 ||
      (dk32 != nullptr) != want32 || (dv32 != nullptr) != want32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 256
             ? launch_width<256>(q, k, v, rs, mask, lse, keep, dout,
                                 do_stride, d_row, outs, d_stride, B, T, H,
                                 scale_log2, sm_scale, causal, drop_scale, s)
             : launch_width<128>(q, k, v, rs, mask, lse, keep, dout,
                                 do_stride, d_row, outs, d_stride, B, T, H,
                                 scale_log2, sm_scale, causal, drop_scale, s);
}
