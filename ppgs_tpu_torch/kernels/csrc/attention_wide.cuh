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
// in both places:
// - the score-like products (S = Q K^T, dP = dO V^T and their transposes)
//   take their k-loop over d_head as a walk of 64-column items: each item
//   of the ring holds one 64-column atom of the 128 rows of the block's
//   side and of the 64 rows of the streamed tile (24 KB), so nothing of
//   the block's side stays resident and no TMA box is wider than 64
//   columns;
// - the outputs' columns are split over the grid: a block owns a slice
//   of DS columns (128, or 256 where d_head % 256 == 0 for the inference
//   kernel), and forms S (and dP) over the whole of d_head for itself. A
//   head of d_head / DS slices does that many times the score products;
//   the PV-like products are done once. This is the simple form: the
//   slices of a head could share one S through shared memory in a later
//   design.
// Every block walks the same sequence of items, so both warpgroups walk
// every slot in order; the last of the eight warps to release a slot
// refills it (the blocks' other kernels' ring). A warpgroup waits for and
// releases the items of a tile it skips.
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

// The head widths of the wide routes
__host__ __device__ constexpr bool takes(int d) {
  return d % 128 == 0 && d >= 384 && d <= MAX_D;
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

// The first byte of a block's dynamic shared memory, 1024-byte aligned
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

}  // namespace wide
}  // namespace ppgs
