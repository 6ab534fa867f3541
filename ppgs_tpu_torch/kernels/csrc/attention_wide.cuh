// What the attention kernels' wide-head routes share (attention.cu,
// attention_train.cu, attention_train_bwd.cu): d_head % 128 == 0 from 384
// to 2048, known at run time.
//
// Why a route of its own. The kernels at d_head 64 to 256 keep a block's
// own rows whole in shared memory (Q, or K and V) and stream whole-width
// tiles of the other side, with a 64 x d_head fp32 accumulator a
// warpgroup in registers. At d_head 384 Q alone is 96 KB and a stage of
// K and V 96 KB more, past the 227 KB a block may have, and a 64 x 384
// accumulator is 192 registers a thread. So the wide routes split d_head
// over blocks.
//
// The forward kernels (K2's wide_kernel, attention_train.cu's
// fwd_wide_kernel) form S once a head: a thread-block cluster of
// ranks(d) = ceil(d / 256) blocks (at most 8, the portable cluster) owns
// 128 query rows of a head, and rank r owns the head's columns [256 r,
// 256 r + rank_cols(d, r)) of Q, K, V and O: 256, or 128 for the last
// rank where d % 256 == 128. A rank keeps its Q columns of the block's
// rows in shared memory and streams the key tiles' K and V columns
// through rings of whole items (scores_resident); per key tile it forms
// the partial S_r = Q_r K_r^T (128 x 64 fp32), and the Exchange adds the
// ranks' partials through distributed shared memory in rank order, so
// that every rank holds the same bits of S and so the same p and keep
// bits; then O_r += P V_r (O 64 x 256 fp32 a warpgroup in registers).
// Each of the head's Q, K and V columns is read by one rank, and S's
// products are done once a head (twice in the train forward's two
// passes), where a block per output slice formed S again for every
// slice.
//
// The backward (attention_train_bwd.cu) is still a block per 128-column
// slice of the outputs forming S and dP over the whole head: the
// score-like products take their k-loop over d_head as a walk of
// 64-column items (scores), each item of the ring holding one 64-column
// atom of the 128 rows of the block's side and of the 64 rows of the
// streamed tile (24 KB), so nothing of the block's side stays resident
// and no TMA box is wider than 64 columns.
//
// Every block walks the same sequence of items of a ring, so both
// warpgroups walk every slot in order; the last of the eight warps to
// release a slot refills it (the blocks' other kernels' ring). A
// warpgroup waits for and releases the items of a tile it skips.
#pragma once

#include "hopper.cuh"

namespace ppgs {
namespace wide {

using namespace ppgs::hopper;

constexpr int ROWS = 128;     // a block's own rows: two warpgroups of 64
constexpr int TILE = 64;      // rows of a streamed tile
constexpr int THREADS = 256;
constexpr int ATOM = 64;      // bf16 columns of a 128-byte swizzle atom
constexpr int ROW_CHUNK = ROWS * ATOM * 2;    // 128 rows of an atom: 16 KB
constexpr int TILE_CHUNK = TILE * ATOM * 2;   // 64 rows of an atom: 8 KB
constexpr int MAX_D = 2048;
constexpr int RANK_COLS = 256;  // a rank's columns (the last may have 128)
constexpr int PARTIAL = ROWS * TILE * 4;      // a partial S, fp32: 32 KB

// The head widths of the wide routes
__host__ __device__ constexpr bool takes(int d) {
  return d % 128 == 0 && d >= 384 && d <= MAX_D;
}

// The forward's rank plan: the cluster's blocks at head width d, and the
// columns rank r owns from 256 r on
__host__ __device__ constexpr int ranks(int d) {
  return (d + RANK_COLS - 1) / RANK_COLS;
}
__host__ __device__ constexpr int rank_cols(int d, int r) {
  return d - RANK_COLS * r < RANK_COLS ? d - RANK_COLS * r : RANK_COLS;
}

// A ring of `stages` slots of `stage` bytes at `base` that walks `items`
// items, item n in slot n % stages, with its full and empty barriers and
// release counters
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int* released;
  int stages, stage, items;

  // The bytes of a ring's full[], empty[] and release counters, and a ring
  // of `stages` slots at byte `slots` of `base`, those at byte `bars`
  __host__ __device__ static constexpr int bytes(int stages) {
    return (20 * stages + 7) / 8 * 8;
  }
  __device__ __forceinline__ static Ring make(unsigned char* base,
                                              int slots, int bars,
                                              int stages, int stage) {
    uint64_t* full = reinterpret_cast<uint64_t*>(base + bars);
    return Ring{base + slots, full, full + stages,
                reinterpret_cast<int*>(full + 2 * stages), stages, stage, 0};
  }

  // Thread 0: the barriers (eight consumer warps release a slot)
  __device__ __forceinline__ void init() const {
    mbar_init_ring(full, empty, stages, 8);
    for (int s = 0; s < stages; ++s) released[s] = 0;
  }
  __device__ __forceinline__ unsigned char* at(int n) const {
    return base + (n % stages) * stage;
  }
  // The barrier that item n's loads report to
  __device__ __forceinline__ uint32_t bar(int n) const {
    return smem_addr(full + n % stages);
  }
  __device__ __forceinline__ void wait(int n) const {
    mbar_wait(smem_addr(full + n % stages), (n / stages) & 1);
  }
  // This warp is done with item n; the last of the eight warps to release
  // its slot refills it with item n + stages (``load``, by its lane 0)
  template <typename Load>
  __device__ __forceinline__ void release(int n, int lane,
                                          Load& load) const {
    const int s = n % stages;
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(smem_addr(empty + s));
      if (n + stages < items && atomicAdd(released + s, 1) % 8 == 7) {
        mbar_wait(smem_addr(empty + s), (n / stages) & 1);
        load(n + stages);
      }
    }
    __syncwarp();
  }
};

// acc (64 x 64 fp32) = the sum over items n0 .. n0 + nc - 1 of the
// warpgroup's 64 rows of the atom at offset a of the item's slot times
// the 64 rows of the atom at offset b, transposed (both K-major over
// d_head: 32 bytes of a 128-byte row a k16 step). One item's products
// overlap the wait for the next, and a slot is released once its
// products are done. live false: the items are waited for and released.
template <typename Load>
__device__ __forceinline__ void scores(float (&acc)[TILE / 2],
                                       const Ring& ring, int n0, int nc,
                                       uint32_t a, uint32_t b, bool live,
                                       int lane, Load& load) {
  if (!live) {
    for (int j = 0; j < nc; ++j) {
      ring.wait(n0 + j);
      ring.release(n0 + j, lane, load);
    }
    return;
  }
  zero(acc);
  for (int j = 0; j < nc; ++j) {
    ring.wait(n0 + j);
    const uint32_t slot = smem_addr(ring.at(n0 + j));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ATOM / 16; ++kk)
      wgmma_ss<TILE, 0, 0>(acc, sw128_desc(slot + a + kk * 32, 16, 1024),
                           sw128_desc(slot + b + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();          // item j - 1's products are done
    if (j > 0) ring.release(n0 + j - 1, lane, load);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(n0 + nc - 1, lane, load);
}

// 16 bytes at the shared-memory address `addr` of block `rank` of the
// cluster (its own through the local window), and 16 bytes stored there in
// this block
__device__ __forceinline__ float4 ld_rank(uint32_t addr, int rank, int me) {
  float4 v;
  if (rank == me) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(addr) : "memory");
  } else {
    asm volatile(
        "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %4, %5;\n"
        " ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [ra];\n}\n"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "r"(addr), "r"(rank) : "memory");
  }
  return v;
}
__device__ __forceinline__ void st_shared(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};"
               ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
// The same for 8 bytes
__device__ __forceinline__ uint2 ld_rank2(uint32_t addr, int rank, int me) {
  uint2 v;
  if (rank == me) {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  } else {
    asm volatile(
        "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %2, %3;\n"
        " ld.shared::cluster.v2.u32 {%0, %1}, [ra];\n}\n"
        : "=r"(v.x), "=r"(v.y) : "r"(addr), "r"(rank) : "memory");
  }
  return v;
}
__device__ __forceinline__ void st_shared2(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};"
               ::"r"(addr), "r"(v.x), "r"(v.y) : "memory");
}

// acc (64 x 64 fp32) = the warpgroup's 64 rows of a resident operand at
// q (na atoms of ROWS rows, ROW_CHUNK apart) times the TILE rows of item
// n of `ring` (na atoms, TILE_CHUNK apart), transposed; the item is
// waited for and released (its products done). live false: the item is
// waited for and released.
template <typename Load>
__device__ __forceinline__ void scores_resident(float (&acc)[TILE / 2],
                                                uint32_t q, const Ring& ring,
                                                int n, int na, bool live,
                                                int lane, Load& load) {
  ring.wait(n);
  if (live) {
    const uint32_t k = smem_addr(ring.at(n));
    zero(acc);
    wgmma_fence();
    for (int j = 0; j < na; ++j)
#pragma unroll
      for (int kk = 0; kk < ATOM / 16; ++kk)
        wgmma_ss<TILE, 0, 0>(
            acc, sw128_desc(q + j * ROW_CHUNK + kk * 32, 16, 1024),
            sw128_desc(k + j * TILE_CHUNK + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  ring.release(n, lane, load);
}

// The two halves of cluster_sync: this thread arrives (releasing its
// writes to the cluster), and waits for every thread of the cluster to
// have arrived (acquiring theirs)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The cluster sum: S over the whole head, the same bits in every rank.
// Per exchange x (a key tile's S; the exchanges count on through a
// kernel), a thread's 32 values of its rank's partial S (over the rank's
// columns) go to buffer x % 2 of the block (two of PARTIAL bytes, SLOTS
// float4 at stride THREADS: conflict-free), and the cluster meets. Two
// ranks then add the other's partial to their own (p0 + p1 is p1 + p0;
// get_packed reduces and gathers at two ranks too).
// More ranks reduce and gather: rank r adds its share of the slots,
// [SLOTS r / ranks, SLOTS (r + 1) / ranks), over the ranks' buffers in
// rank order into its own buffer, the cluster meets again, and every
// rank gathers the sums from their owners; each sum is added once, so
// every rank holds the same bits, and 2 (ranks - 1) / ranks of a partial
// crosses the cluster a block, not ranks - 1 of it (every rank reading
// every partial ran 1.22x slower at 4 ranks, 0.91x at 2). A thread reads
// only its own slots (its own block's through the local window). Every
// thread of the cluster calls put, then get, once an exchange, with
// nothing between them that waits for a peer (sc keeps the partial in
// between); `live`: the thread's warpgroup formed sc (a tile a warpgroup
// skips is skipped by the same warpgroup of every rank). Two buffers let
// a buffer be written again two exchanges on: a peer's last reads of
// exchange x come before it arrives in exchange x + 1, whose first
// meeting comes before exchange x + 2's writes. The cluster meets once
// more before a block exits (no block leaves while a peer reads it).
constexpr int SLOTS = TILE / 8;
constexpr int MAX_RANKS = MAX_D / RANK_COLS;

struct Exchange {
  unsigned char* buffers;   // two of PARTIAL bytes
  int ranks, rank;

  // This thread's slot k of exchange x's buffer
  __device__ __forceinline__ uint32_t slot(int x, int k) const {
    return smem_addr(buffers + (x & 1) * PARTIAL) + (k * THREADS +
                                                     threadIdx.x) * 16;
  }

  __device__ __forceinline__ void put(const float (&sc)[TILE / 2], int x,
                                      bool live) const {
    if (live) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k)
        st_shared(slot(x, k), make_float4(sc[4 * k], sc[4 * k + 1],
                                          sc[4 * k + 2], sc[4 * k + 3]));
    }
    cluster_arrive();
  }

  // The first of rank r's share of the slots (r = ranks: SLOTS)
  __device__ __forceinline__ int first(int r) const {
    return SLOTS * r / ranks;
  }
  // This rank's share of exchange x's slots, each summed over the ranks
  // in rank order (their loads in flight together) and handed to
  // store(k, sum)
  template <typename Store>
  __device__ __forceinline__ void reduce(int x, Store store) const {
    const int k0 = first(rank), n = first(rank + 1) - k0;
#pragma unroll
    for (int j = 0; j < SLOTS / 2; ++j) {
      if (j >= n) break;
      float4 v[MAX_RANKS];
#pragma unroll
      for (int r = 0; r < MAX_RANKS; ++r)
        if (r < ranks) v[r] = ld_rank(slot(x, k0 + j), r, rank);
      float4 acc = v[0];
#pragma unroll
      for (int r = 1; r < MAX_RANKS; ++r)
        if (r < ranks) {
          acc.x += v[r].x, acc.y += v[r].y;
          acc.z += v[r].z, acc.w += v[r].w;
        }
      store(k0 + j, acc);
    }
  }
  // The rank whose share holds slot k
  __device__ __forceinline__ int owner(int k) const {
    return (ranks * (k + 1) - 1) / SLOTS;
  }

  __device__ __forceinline__ void get(float (&sc)[TILE / 2], int x,
                                      bool live) const {
    cluster_wait();
    if (ranks == 2) {
      if (live) {
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          const float4 v = ld_rank(slot(x, k), rank ^ 1, rank);
          sc[4 * k] += v.x, sc[4 * k + 1] += v.y;
          sc[4 * k + 2] += v.z, sc[4 * k + 3] += v.w;
        }
      }
      return;
    }
    if (live)
      reduce(x, [&](int k, float4 v) { st_shared(slot(x, k), v); });
    cluster_arrive();
    cluster_wait();
    if (live) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const float4 v = ld_rank(slot(x, k), owner(k), rank);
        sc[4 * k] = v.x, sc[4 * k + 1] = v.y;
        sc[4 * k + 2] = v.z, sc[4 * k + 3] = v.w;
      }
    }
  }

  // As get for a caller that needs S's slots only through f(k, slot's
  // four sums) -> 8 bytes (two bf16 pairs, into out[k]): at any count of
  // ranks the owner of a slot applies f to its sums and every rank
  // gathers the results, 8 bytes a slot; f runs once a value in the
  // cluster. sc may be overwritten from put on
  template <typename F>
  __device__ __forceinline__ void get_packed(uint2 (&out)[SLOTS], int x,
                                             bool live, F f) const {
    cluster_wait();
    if (live)
      reduce(x, [&](int k, float4 v) { st_shared2(slot(x, k), f(k, v)); });
    cluster_arrive();
    cluster_wait();
    if (live) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k)
        out[k] = ld_rank2(slot(x, k), owner(k), rank);
    }
  }
};

// The first byte of a block's dynamic shared memory, 1024-byte aligned
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

}  // namespace wide
}  // namespace ppgs
