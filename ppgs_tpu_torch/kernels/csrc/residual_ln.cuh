// The product-then-LayerNorm building blocks that K3 (out_proj_ln.cu) and
// K4's output launch (ffn_ln.cu ffn_out_kernel) share: a TMA ring of
// (A, B) stages for consumer warpgroups of 64 rows each, its producer and
// consumers, and the epilogue out = LN(res + drop(acc + bias)) on tiles of
// up to 128 rows x 256 columns whose rows a thread-block cluster of
// ceil(C / 256) blocks holds together, trading each row's partial sums
// through distributed shared memory. Any C % 128 == 0 up to 2048: where C %
// 256 == 128 the last block's tile holds 128 columns, the others 256; its
// other 128 are masked (its W boxes past C are not loaded, and the
// epilogue keeps them at 0, out of the sums, and unstored). Eight ranks of
// 256 columns are the portable cluster's most, so 2048 is the widest C.
// Header-only; sm_90a.
//
// An m64n256 accumulator holds, in register 4j + e, row g + 8 (e / 2) of
// the warp's 16 rows and column 8j + 2t + e % 2 (lane = 4g + t).
#pragma once

#include <cooperative_groups.h>
#include <mutex>

#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace ppgs {
namespace residual_ln {

namespace cg = cooperative_groups;
using namespace ppgs::hopper;

constexpr int BM = 128, BK = 64;          // block tile rows, depth step
constexpr int RING_BYTES = 192 * 1024;    // the stages' shared memory
constexpr int BOX_BYTES = 8192;           // 64 rows of 128 bytes
constexpr int OUT_BN = 256;               // a LayerNorm tile's columns
constexpr int MAX_C = 8 * OUT_BN;         // the cluster's 8 ranks

// The blocks of a row's cluster, and the 8-column groups of rank n0 / 256's
// tile that fall inside C (32, or 16 in a last tile of 128 columns)
__host__ __device__ __forceinline__ int ln_ranks(int C) {
  return (C + OUT_BN - 1) / OUT_BN;
}
__host__ __device__ __forceinline__ int ln_groups(int C, int n0) {
  return (C - n0 < OUT_BN ? C - n0 : OUT_BN) / 8;
}
// The products of `consume` (a probe's loads-only walk sets it false)
constexpr bool RING_LIVE = true;

// A stage: A (BM rows, K-major, 128-byte rows: one bf16 box of 64 depth
// columns or two fp32 boxes of 32) and B (64 depth rows, MN-major, BN / 64
// boxes of 64 columns); as many stages as BYTES hold
template <bool A_F32, int BN, int BYTES = RING_BYTES>
struct Ring {
  static constexpr int A_BYTES = BM * BK * (A_F32 ? 4 : 2);
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = BYTES / STAGE;          // 3, 4 or 6
  // the ring, its barriers, the LayerNorm's row sums (2 x BM fp32), and
  // slack to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 2 * BM * 4
                              + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

__device__ __forceinline__ unsigned char* aligned_ring(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// Producer (one thread): keep the ring full for `steps` depth steps of the
// (m0, n0) tile, B's first `b_boxes` boxes of 64 columns (the others, past
// the array's last column, are left unloaded)
template <bool A_F32, int BN>
__device__ __forceinline__ void produce(const CUtensorMap* map_a,
                                        const CUtensorMap* map_b,
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int steps, int m0,
                                        int n0, int b_boxes = BN / 64) {
  using R = Ring<A_F32, BN>;
  for (int i = 0; i < steps; ++i) {
    const int s = i % R::STAGES, round = i / R::STAGES;
    if (round > 0) mbar_wait(smem_addr(empty + s), (round - 1) & 1);
    const uint32_t bar = smem_addr(full + s);
    mbar_expect_tx(bar, R::A_BYTES + b_boxes * BOX_BYTES);
    unsigned char* sa = ring + s * R::STAGE;
    unsigned char* sb = sa + R::A_BYTES;
    const int k = i * BK;
    tma_load(sa, map_a, k, m0, bar);
    if (A_F32) tma_load(sa + BM * 128, map_a, k + 32, m0, bar);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      if (j < b_boxes) tma_load(sb + j * BOX_BYTES, map_b, n0 + j * 64, k, bar);
  }
}

// One consumer thread's m64k16 A fragment of depth step kk from an fp32
// K-major stage (two boxes of BM rows x 32 depth columns, 128-byte
// swizzle: the 16-byte chunk q of row r sits at chunk q ^ (r & 7)),
// rounded to bf16: registers {a0 a1}, {a2 a3}, {a4 a5}, {a6 a7} of the
// fragment are (row g, depth 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..) of the warp's 16 rows. Conflict-free: the 8 rows of
// a read hit 8 different chunks.
__device__ __forceinline__ void f32_fragment(uint32_t (&a)[4],
                                             const float* stage, int c,
                                             int warp, int lane, int kk) {
  const int g = lane >> 2, t = lane & 3;
  const float* box = stage + (kk >> 1) * (BM * 32);
#pragma unroll
  for (int q = 0; q < 2; ++q) {       // depth 2t.. or 2t + 8..
    const int k = 16 * (kk & 1) + 8 * q + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {     // row g or g + 8
      const int row = 64 * c + 16 * warp + 8 * h + g;
      const float2 v = *reinterpret_cast<const float2*>(
          box + row * 32 + (((k >> 2) ^ (row & 7)) << 2) + (k & 3));
      __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);
      a[2 * q + h] = *reinterpret_cast<uint32_t*>(&p);
    }
  }
}

struct NoRefill {
  __device__ __forceinline__ void operator()(int) const {}
};

// Consumer warpgroup c: acc (its 64 rows x BN) = A B over `steps` stages
// of ring R. In the bf16 form every stage is given back once its products
// are done, and refill(i) is called after step i - 1's stage is (with i =
// steps after the last): where a consumer thread refills the ring (refill
// reconverges its warp)
template <bool A_F32, int BN, typename R = Ring<A_F32, BN>,
          typename Refill = NoRefill>
__device__ __forceinline__ void consume(float (&acc)[BN / 2],
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int steps, int c,
                                        int warp, int lane,
                                        Refill refill = {}) {
  const auto release = [&](int s) {
    if (lane == 0) mbar_arrive(smem_addr(empty + s));
  };
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % R::STAGES;
    mbar_wait(smem_addr(full + s), (i / R::STAGES) & 1);
    unsigned char* sa = ring + s * R::STAGE;
    const uint32_t a_addr = smem_addr(sa), b_addr = a_addr + R::A_BYTES;
    if constexpr (A_F32) {
      // One depth step's fragment a product, the next one's loaded while
      // it runs: two fragments live (registers are the limit)
      uint32_t frag[2][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        f32_fragment(frag[kk & 1], reinterpret_cast<const float*>(sa), c,
                     warp, lane, kk);
        fence_regs(acc);
        wgmma_fence();
        if constexpr (RING_LIVE)
          wgmma_rs<BN>(acc, frag[kk & 1],
                       sw128_desc(b_addr + kk * 2048, BOX_BYTES, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's product, and its fragment
        fence_regs(frag[(kk + 1) & 1]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(frag[0]);
      fence_regs(frag[1]);
      __syncwarp();
      release(s);
    } else {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // A K-major (32 bytes of each 128-byte row a step), B MN-major (16
        // depth rows of 128 bytes a step)
        if constexpr (RING_LIVE) wgmma_ss<BN, 0, 1>(
            acc, sw128_desc(a_addr + c * 64 * 128 + kk * 32, 16, 1024),
            sw128_desc(b_addr + kk * 2048, BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait<1>();    // the previous step's products are done
      fence_regs(acc);
      if (i > 0) release((i - 1) % R::STAGES);
      refill(i);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (!A_F32) {
    __syncwarp();
    release((steps - 1) % R::STAGES);
    refill(steps);
  }
}

// Keep bits of a thread's four accumulators of 8-column group c8:
// (r0, col), (r0, col + 1), (r1, col), (r1, col + 1), col = c8 + 2t, in an
// (rows, ld) array. Lanes t and t ^ 1 share the Philox group of columns
// c8 + 4 (t / 2)..: each draws its own row's (r0 for even t, r1 for odd)
// and hands its partner the two words the partner needs.
__device__ __forceinline__ void keep4(const ppgs::Dropout& d, long long r0,
                                      long long r1, long long ld, int c8,
                                      int t, bool (&keep)[4]) {
  const bool odd = t & 1;
  const unsigned long long group = static_cast<unsigned long long>(
      (odd ? r1 : r0) * ld + c8 + 4 * (t >> 1)) >> 2;
  const uint4 w = ppgs::philox4x32_10(
      make_uint4(static_cast<uint32_t>(group),
                 static_cast<uint32_t>(group >> 32), d.site, 0u),
      d.seed_lo, d.seed_hi);
  const uint32_t own0 = odd ? w.z : w.x, own1 = odd ? w.w : w.y;
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  keep[0] = (odd ? got0 : own0) >= d.threshold;
  keep[1] = (odd ? got1 : own1) >= d.threshold;
  keep[2] = (odd ? own0 : got0) >= d.threshold;
  keep[3] = (odd ? own1 : got1) >= d.threshold;
}

// The LayerNorm epilogue on a thread's 64 x 256 accumulators (rows r0,
// r1; columns n0 + 8j + 2t + e % 2 of the (M, C) output), in three steps
// around the reduction of the row sums; only the tile's first `groups`
// 8-column groups lie inside C (ln_groups), the others are kept at 0 and
// never stored:
// acc := res + drop(acc + bias), res(j) the residual's (r0, col), (r0,
// col + 1), (r1, col), (r1, col + 1), col = n0 + 8j + 2t; returns the row
// sums over the tile's columns
template <typename Res>
__device__ __forceinline__ void residual_sums(
    float (&acc)[128], Res res, const float* bias, int C, int n0,
    long long r0, long long r1, int t, int round_input,
    const ppgs::Dropout& drop, float& s0, float& s1, int groups = 32) {
  s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j >= groups) {       // past C: a warp-uniform branch
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] = 0.f;
      continue;
    }
    const float2 b = *reinterpret_cast<const float2*>(bias + n0 + 8 * j +
                                                      2 * t);
    const float4 r = res(j);
    const float xs[4] = {r.x, r.y, r.z, r.w};
    bool keep[4] = {true, true, true, true};
    if (drop.threshold) keep4(drop, r0, r1, C, n0 + 8 * j, t, keep);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = acc[4 * j + e], be = (e & 1) ? b.y : b.x;
      acc[4 * j + e] =
          drop.threshold
              ? xs[e] + (keep[e] ? (a + be) * drop.scale : 0.f)
              : (round_input ? ppgs::round_bf16(xs[e]) : xs[e]) + a + be;
    }
    s0 += acc[4 * j] + acc[4 * j + 1];
    s1 += acc[4 * j + 2] + acc[4 * j + 3];
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
}

// The same with the residual read from x (M, C) in global memory, 0 past
// row M
__device__ __forceinline__ void residual_rows(
    float (&acc)[128], const float* x, const float* bias, int M, int C,
    int n0, long long r0, long long r1, int t, int round_input,
    const ppgs::Dropout& drop, float& s0, float& s1, int groups = 32) {
  const auto res = [&](int j) {
    const int col = n0 + 8 * j + 2 * t;
    float2 x0 = make_float2(0.f, 0.f), x1 = x0;
    if (r0 < M) x0 = *reinterpret_cast<const float2*>(x + r0 * C + col);
    if (r1 < M) x1 = *reinterpret_cast<const float2*>(x + r1 * C + col);
    return make_float4(x0.x, x0.y, x1.x, x1.y);
  };
  residual_sums(acc, res, bias, C, n0, r0, r1, t, round_input, drop, s0,
                s1, groups);
}

// acc -= the row's mean in the first `groups` 8-column groups (the others
// stay 0); returns the centred rows' sums of squares
__device__ __forceinline__ void center_rows(float (&acc)[128], float mean0,
                                            float mean1, float& q0,
                                            float& q1, int groups = 32) {
  q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j >= groups) continue;
    acc[4 * j] -= mean0, acc[4 * j + 1] -= mean0;
    acc[4 * j + 2] -= mean1, acc[4 * j + 3] -= mean1;
    q0 += acc[4 * j] * acc[4 * j] + acc[4 * j + 1] * acc[4 * j + 1];
    q1 += acc[4 * j + 2] * acc[4 * j + 2] + acc[4 * j + 3] * acc[4 * j + 3];
  }
  q0 = quad_sum(q0);
  q1 = quad_sum(q1);
}

// out = acc / std * gamma + beta, and n_out = acc / std unless null, in
// the first `groups` 8-column groups
__device__ __forceinline__ void store_ln(const float (&acc)[128], float inv0,
                                         float inv1, const float* gamma,
                                         const float* beta, float* out,
                                         float* n_out, int M, int C, int n0,
                                         long long r0, long long r1, int t,
                                         int groups = 32) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j >= groups) continue;
    const int col = n0 + 8 * j + 2 * t;
    const float2 gm = *reinterpret_cast<const float2*>(gamma + col);
    const float2 bt = *reinterpret_cast<const float2*>(beta + col);
    const float2 n0v = make_float2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    const float2 n1v = make_float2(acc[4 * j + 2] * inv1,
                                   acc[4 * j + 3] * inv1);
    if (r0 < M) {
      *reinterpret_cast<float2*>(out + r0 * C + col) =
          make_float2(n0v.x * gm.x + bt.x, n0v.y * gm.y + bt.y);
      if (n_out) *reinterpret_cast<float2*>(n_out + r0 * C + col) = n0v;
    }
    if (r1 < M) {
      *reinterpret_cast<float2*>(out + r1 * C + col) =
          make_float2(n1v.x * gm.x + bt.x, n1v.y * gm.y + bt.y);
      if (n_out) *reinterpret_cast<float2*>(n_out + r1 * C + col) = n1v;
    }
  }
}

// The LayerNorm statistics of the tile's rows, whose C columns the
// cluster's ln_ranks(C) blocks hold, 256 each (the last 128 where C % 256
// == 128; its `groups` say so): residual(s0, s1) turns acc into
// the residual sums and returns the sums of rows lr0 and lr0 + 8 of the
// tile over this block's columns (run in the first barrier's block: apart
// from it, K4's output launch spilled at its 168 registers); then acc is
// centred, and done(inv0, inv1) is called with the rows' 1/std. Each block
// adds the ranks' sums in rank order, so that all normalise with the same
// mean and 1/std. Every thread of every block of the cluster calls it
// (the block's row sums, 2 x BM fp32 in `sums`, are read through
// distributed shared memory between two cluster barriers); `active`
// threads hold accumulators. The cluster's blocks must meet once more
// before they exit, so that none leaves while a peer reads its sums.
template <typename Residual, typename Done>
__device__ __forceinline__ void layer_norm_rows(float (&acc)[128],
                                                bool active, float* sums,
                                                int C, int lr0, int t,
                                                Residual residual, Done done,
                                                int groups = 32) {
  const int ranks = ln_ranks(C);
  const float inv_c = 1.f / C;
  const auto sync = [ranks] {
    if (ranks > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  const auto peer = [ranks, sums](int r) -> const float* {
    return ranks > 1 ? cg::this_cluster().map_shared_rank(sums, r) : sums;
  };
  if (active) {
    float s0, s1;
    residual(s0, s1);
    if (t == 0) sums[lr0] = s0, sums[lr0 + 8] = s1;
  }
  sync();
  if (active) {
    float mean0 = 0.f, mean1 = 0.f;
    for (int r = 0; r < ranks; ++r) {
      mean0 += peer(r)[lr0];
      mean1 += peer(r)[lr0 + 8];
    }
    float q0, q1;
    center_rows(acc, mean0 * inv_c, mean1 * inv_c, q0, q1, groups);
    if (t == 0) sums[BM + lr0] = q0, sums[BM + lr0 + 8] = q1;
  }
  sync();
  if (active) {
    float var0 = 0.f, var1 = 0.f;
    for (int r = 0; r < ranks; ++r) {
      var0 += peer(r)[BM + lr0];
      var1 += peer(r)[BM + lr0 + 8];
    }
    done(rsqrtf(var0 * inv_c + ppgs::LN_EPS),
         rsqrtf(var1 * inv_c + ppgs::LN_EPS));
  }
}

// out = LN(res + drop(acc + bias)) * gamma + beta on the tile's rows r0
// and r0 + 8, res read from x in global memory (residual_rows); with
// n_out and rstd not null, the normalised rows and 1/std too (rstd by the
// block with `rank_zero`); as layer_norm_rows. `groups` is ln_groups(C,
// n0): a caller at a thread's register cap passes it as a literal in each
// branch of a test, so that each inlined copy knows its columns (a value
// known only at run time cost K4's output launch 1.4 KB of spills a
// thread)
__device__ __forceinline__ void residual_ln(
    float (&acc)[128], bool active, float* sums, const float* x,
    const float* bias, const float* gamma, const float* beta, float* out,
    float* n_out, float* rstd, int M, int C, int n0, int lr0, long long r0,
    int t, int round_input, const ppgs::Dropout& drop, bool rank_zero,
    int groups) {
  const long long r1 = r0 + 8;
  layer_norm_rows(acc, active, sums, C, lr0, t,
                  [&](float& s0, float& s1) {
                    residual_rows(acc, x, bias, M, C, n0, r0, r1, t,
                                  round_input, drop, s0, s1, groups);
                  },
                  [&](float inv0, float inv1) {
                    store_ln(acc, inv0, inv1, gamma, beta, out, n_out, M, C,
                             n0, r0, r1, t, groups);
                    if (rstd && rank_zero && t == 0) {
                      if (r0 < M) rstd[r0] = inv0;
                      if (r1 < M) rstd[r1] = inv1;
                    }
                  },
                  groups);
}

// Whether the card can hold a cluster of `cfg` at all
// (cudaOccupancyMaxActiveClusters): cudaSuccess, or
// cudaErrorLaunchOutOfResources. The answer is kept for each kernel,
// block size and cluster size, as the most shared memory at which one fit
// (so a kernel whose shared memory grows with T asks again only above it)
inline cudaError_t cluster_fits(const void* kernel,
                                const cudaLaunchConfig_t& cfg) {
  struct Fit {
    const void* kernel;
    unsigned threads, cluster;
    size_t smem;
  };
  static std::mutex lock;
  static Fit fits[64];
  static int known = 0;
  const unsigned threads = cfg.blockDim.x;
  const unsigned cluster = cfg.attrs[0].val.clusterDim.x;
  std::lock_guard<std::mutex> hold(lock);
  Fit* fit = nullptr;
  for (int i = 0; i < known; ++i)
    if (fits[i].kernel == kernel && fits[i].threads == threads &&
        fits[i].cluster == cluster)
      fit = fits + i;
  if (fit && cfg.dynamicSmemBytes <= fit->smem) return cudaSuccess;
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  if (!fit && known < 64) {
    fit = fits + known++;
    *fit = Fit{kernel, threads, cluster, 0};
  }
  if (fit) fit->smem = cfg.dynamicSmemBytes;
  return cudaSuccess;
}

// Launch `kernel` on a grid of clusters of `cluster` blocks (along x); a
// cluster the card cannot hold returns cudaErrorLaunchOutOfResources, the
// launch not made
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int threads, int smem, dim3 grid,
           unsigned cluster, cudaStream_t s, Args... args) {
  // Above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cluster_fits(reinterpret_cast<const void*>(kernel), cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace residual_ln
}  // namespace ppgs
