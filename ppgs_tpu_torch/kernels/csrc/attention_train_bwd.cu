// The backward of attention for training (masked multi-head attention with
// dropout on the normalised probabilities), read in place from (B, T, C)
// layouts: two deterministic kernels, a dq pass and a dk/dv pass, on
// wgmma + TMA (the blocks of hopper.cuh). d_head = 128, the port's only
// train width; the kernels are templated on it.
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
// give the same bits.
//
// Design. Both kernels are K2's (attention.cu) on the same operand forms:
// one block per (128 rows, head, window), two consumer warpgroups of 64
// rows, 256 threads and one block an SM (ptxas: 160 and 171 registers a
// thread in the dq pass, 239 and 247 in the dk/dv pass, without and with
// dropout; no spills). A block's own rows arrive once by TMA and stay; the other
// side streams past in 64-row tiles through a ring of STAGES stages with
// full and empty mbarriers: thread 0 fills it, and the last of the eight
// warps to release a stage refills it. 3-D tensor maps (d, T, window)
// read a head's columns through the row stride and zero-fill rows past T;
// every row and key past T is also masked by index (with lse = 0 a zero
// row would give pn = 1).
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
  static constexpr int STAGE = 2 * OPND;
  static constexpr int STAGES = 4;
  static constexpr int RING = 2 * RES;
  static constexpr int ROWV = RING + STAGES * STAGE;   // 8 warps' slots
  static constexpr int BARS = ROWV + 8 * 3 * TILE * 4;
  // full[], empty[], the resident operands' barrier, the release counters,
  // the last valid key, and slack to align to 1024 bytes
  static constexpr int SMEM =
      BARS + (2 * STAGES + 1) * 8 + STAGES * 4 + 8 + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}

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

  // A warp is done with tile i's stage; the last of the eight warps to
  // release it refills it with tile i + STAGES (returns true for that lane
  // 0, which then calls load_stage)
  __device__ __forceinline__ bool release(int i, int tiles, int lane) {
    const int s = i % P::STAGES;
    bool refill = false;
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(smem_addr(empty + s));
      if (i + P::STAGES < tiles && atomicAdd(released + s, 1) % 8 == 7) {
        mbar_wait(smem_addr(empty + s), (i / P::STAGES) & 1);
        refill = true;
      }
    }
    return refill;
  }

  // Warpgroup c's 8 KB chunks of the resident tiles: its 64 rows of each
  // atom of each operand, 2 x ATOMS of them
  __device__ __forceinline__ unsigned char* chunk(int c, int n) const {
    return res + (n / P::ATOMS) * P::RES + (n % P::ATOMS) * ROWS * 128 +
           c * TILE * 128;
  }
};

// Stage a 64 x D fp32 accumulator (register 4j + e: row g + 8 (e / 2) of
// the warp's 16, column 8j + 2t + e % 2) as D / 32 boxes of 64 rows x 32
// fp32 columns, 128-byte swizzled (the 16-byte chunk q of row r at q ^ (r
// & 7)), box n at box(n)
template <int D, typename Box>
__device__ __forceinline__ void stage_f32(const float (&acc)[D / 2],
                                          Box box, int warp, int g, int t) {
  const int row = (16 * warp + g) * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* p = box(j / 4) + row +
                       (((2 * (j % 4) + (t >> 1)) ^ g) << 4) + 8 * (t & 1);
    *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(p + 8 * 128) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The same in bf16, D / 64 boxes of 64 rows x 64 columns
template <int D, typename Box>
__device__ __forceinline__ void stage_bf16(const float (&acc)[D / 2],
                                           Box box, int warp, int g, int t) {
  const int row = (16 * warp + g) * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* p = box(j / 8) + row + (((j % 8) ^ g) << 4) + 4 * t;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(p + 8 * 128) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Publish a warpgroup's staged boxes and write them by TMA stores at
// (col0 + n * width, row, window); the shared memory is free again on
// return. wg_lead: the warpgroup's thread 0
template <typename Box>
__device__ __forceinline__ void store_boxes(const CUtensorMap* map, int n,
                                            int width, Box box, int col0,
                                            int row, int window, int c,
                                            bool wg_lead, int T) {
  fence_async_smem();
  bar_sync(1 + c, 128);
  if (wg_lead && row < T) {
    for (int i = 0; i < n; ++i)
      tma_store_3d(map, col0 + i * width, row, window, box(i));
    bulk_commit();
    bulk_wait_read();
  }
  bar_sync(1 + c, 128);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
  fence_regs(r);
}

// The S-like product of one warpgroup: acc (64 x 64, zeroed before the
// wgmma fence) += A (its 64 resident rows) B^T (a streamed tile), both
// K-major over d
template <int D>
__device__ __forceinline__ void rows_by_tile(float (&acc)[TILE / 2],
                                             uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<TILE, 0, 0>(
        acc, sw128_desc(a + (kk / 4) * (ROWS * 128) + (kk % 4) * 32, 16, 1024),
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
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
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
    for (int i = 0; i < P::STAGES && i < tiles; ++i) load(i);
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

  for (int i = 0; i < tiles; ++i) {
    const int s = i % P::STAGES, k0 = i * TILE;
    // The tile's valid keys, bit k for key k0 + k (the same in every warp)
    const uint64_t valid =
        __ballot_sync(0xffffffffu, nb0 != 0) |
        (static_cast<uint64_t>(__ballot_sync(0xffffffffu, nb1 != 0)) << 32);
    const uint2 kw0 = nk0, kw1 = nk1;
    if (i + 1 < tiles) fetch(i + 1);
    const bool live =
        valid != 0 && wg_row < T && !(causal && k0 > wg_row + 63);
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

      // ds = pn (gp - d_row), rounded with sm_scale into the A fragments of
      // dQ += dS K: a[k] holds keys 16k..16k+15, groups j = 2k (registers
      // 0, 1) and 2k + 1 (2, 3)
      const bool full_tile = valid == ~0ull && r1 < T &&
                             !(causal && k0 + TILE - 1 > wg_row + 16 * warp);
      const uint64_t bits = valid >> (2 * t);
      uint32_t a[TILE / 16][4];
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
    }
    if (blk.release(i, tiles, lane)) load(i + P::STAGES);
    __syncwarp();
  }

  // dq out of the warpgroup's rows of the Q and dO tiles
  auto box = [&](int n) { return blk.chunk(c, n); };
  const bool lead = threadIdx.x % 128 == 0;
  if (want32) {
    stage_f32<D>(dq, box, warp, g, t);
    store_boxes(&map_dq32, D / 32, 32, box, col0, wg_row, b, c, lead, T);
  }
  if (want16) {
    stage_bf16<D>(dq, box, warp, g, t);
    store_boxes(&map_dq16, D / 64, 64, box, col0, wg_row, b, c, lead, T);
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
  const int k0b = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
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
  // lane + 1), read a tile ahead of their use
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
      for (int n = 0; n < P::ATOMS; ++n) {
        tma_store_3d(&map_dk16, col0 + n * ATOM, wg_key, b, box(n));
        tma_store_3d(&map_dv16, col0 + n * ATOM, wg_key, b, box_v(n));
      }
      bulk_commit();
      bulk_wait_read();
    }
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
  static const cudaError_t attr_k = allow_smem(dkdv_kernel<D, DROP>, P::SMEM);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  if (attr_k != cudaSuccess) return static_cast<int>(attr_k);
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
  dkdv_kernel<D, DROP><<<grid, THREADS, P::SMEM, stream>>>(
      in[0], in[1], in[2], in[3], out[2], out[3], out[4], out[5], m, l, d,
      bits, T, H, scale_log2, sm_scale, causal, drop_scale, want16, want32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16 (B, T, H*128) views with row stride rs; mask (B, T) bytes,
// nonzero = valid key; lse and d_row (B, H, T) fp32; keep: the forward's
// keep bits, B x H x T x 2 ceil(T / 64) uint32 (ppgs_attention_train_fwd),
// or null when the dropout is off; drop_scale = 1 / (1 - rate); dout (B,
// T, H*128) bf16 with row stride do_stride; dq, dk, dv written as bf16
// and/or fp32 (null skips; dq16, dk16, dv16 all null or none, likewise
// the fp32 ones) with row stride d_stride. TMA: 16-byte aligned bases, rs,
// do_stride and d_stride multiples of 8 elements.
extern "C" int ppgs_attention_train_bwd(
    const void* q, const void* k, const void* v, long long rs,
    const void* mask, const void* lse, const void* keep, const void* dout,
    long long do_stride, const void* d_row, void* dq16, void* dq32,
    void* dk16, void* dk32, void* dv16, void* dv32, long long d_stride,
    int B, int T, int H, float scale_log2, float sm_scale, int causal,
    float drop_scale, void* stream) {
  constexpr int D = 128;
  if (B <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
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
  void* outs[6] = {dq16, dq32, dk16, dk32, dv16, dv32};
  for (int i = 0; i < 6; ++i) {
    const bool f32 = i % 2 == 1;
    if (outs[i] && !encode_3d(&out[i], outs[i], cols, T, B, d_stride,
                              T * d_stride, f32 ? 32 : ATOM, TILE, f32))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int want16 = dq16 != nullptr, want32 = dq32 != nullptr;
  if ((dk16 != nullptr) != want16 || (dv16 != nullptr) != want16 ||
      (dk32 != nullptr) != want32 || (dv32 != nullptr) != want32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep)
    return launch<D, true>(in, out, mask, lse, keep, d_row, B, T, H,
                           scale_log2, sm_scale, causal, drop_scale, want16,
                           want32, s);
  return launch<D, false>(in, out, mask, lse, keep, d_row, B, T, H,
                          scale_log2, sm_scale, causal, drop_scale, want16,
                          want32, s);
}
