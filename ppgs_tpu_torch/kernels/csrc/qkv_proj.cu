// K1 qkv_proj: out = bf16(bf16(bf16(x) @ W) + bf16(b)), the fused QKV
// projection of one encoder layer, at (K, N) = (256, 768), (512, 1536) and
// (768, 2304) (one template instance each).
//
// Replaces: the QKV product inside ppgs_tpu/ops/encoder_layer_kernel.py
// _layer_body (`qkv = dot_cd(xc, wqkv, bqkv)`), run per layer by
// encoder_stack (pallas_call :330; the mel model, the bottleneck head and
// the w2v2fb head) and encoder_stack_streamed (pallas_call :496; the
// wav2vec2 trunk), and the forward QKV product of
// ppgs_tpu/ops/encoder_layer_train.py (the training layer, unfolded
// weights). The softmax scale times log2(e) is folded into the q third of
// W and b on the host, as encoder_stack does.
//
// Rounding follows the TPU kernel: the fp32 residual x is rounded to bf16
// (nearest even) as it is read, products accumulate in fp32, the sum is
// rounded to bf16 before the bf16 bias is added (dot_cd), and the result
// is bf16, (M, N) contiguous: K2 and the train attention read q, k and v
// as views of it.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s), counting fp32 x in and
// bf16 out once: mel (M = 64,000, K = 256) 164 MB against 25 GFLOP, 0.049
// ms by bytes; the training shape (M = 131,072, K = 256) 336 MB, 0.100 ms
// by bytes; the w2v2fb head (64,000, 512) 101 GFLOP, 0.102 ms by
// operations; the wav2vec2 trunk (25,600, 768) 91 GFLOP, 0.092 ms by
// operations.
//
// Design (Hopper: wgmma + TMA on the blocks of hopper.cuh). A tile that
// streams both operands re-reads each of them per output tile: with 128 x
// 256 tiles, x (fp32, so twice its bf16 bytes) N / 256 times and W M / 128
// times, 2.4-7x the bytes of the bound through L2. So x stays resident:
// - a persistent grid (as many blocks, or clusters, as the card holds)
//   walks units of 128 rows x 128 columns in contiguous ranges, row block
//   by row block, so each row block's x is converted once and reused for
//   every column tile of W; the ranges are balanced to one unit, and odd
//   ranges are walked backwards, so that two sharing a row block at their
//   ends read it at about the same time (from L2 once);
// - a producer warp keeps a ring of 16 KB slots in flight by TMA, in the
//   order the consumers walk them: each unit's W items (64 depth rows x
//   128 columns, two 64-column boxes, MN-major as stored) and, before each
//   W item of a row block's first unit, the matching 64 columns of the
//   block's x in fp32 (rows past M zero-filled);
// - consumer warpgroups own 64 rows each. A warpgroup rounds its rows of
//   an x slot to bf16 into the resident x (K / 64 slabs, K-major in the
//   128-byte swizzle that wgmma reads; its own rows only, so no other
//   warpgroup waits on it), then issues SS wgmma.m64n128k16 (A from the
//   resident x, B from the W item), fp32 accumulators in registers (64 a
//   thread); every consumer warp releases every slot, so the ring has one
//   consumer and keeps its order (a ring whose consumers skip each other's
//   slots lets a wait alias an older phase of the slot's barrier);
// - the epilogue rounds the sum, adds the bf16 bias (an fp32 load,
//   L1-resident), stages the warpgroup's 64 x 128 tile in two swizzled
//   64-column boxes and writes them by TMA stores that clip at M,
//   asynchronously (stores from registers stalled the mainloop under the
//   memory's back-pressure and cost up to half the kernel's time).
// Shared memory sets the plan: x takes K / 64 slabs of 128 x 64 bf16 (64
// and 128 KB at K = 256 and 512: blocks of 128 rows, two warpgroups, and 8
// and 4 ring slots). At K = 768, 128 rows of x (192 KB) would leave two
// slots and no boxes, and the W stream stalled; so a block holds 64 rows
// (96 KB, one warpgroup, 7 slots) and a cluster of two blocks shares each
// W item, each block loading one of its two boxes by TMA multicast into
// both: W crosses L2 once per 128 rows, as at the other widths.
// What holds it back: the W stream's round trip through the ring (its
// slots in flight, not L2's rate, set its pace), most at K = 768; a
// block's first unit of each row block waits on its x, a step at a time;
// the warpgroups' epilogues idle the tensor cores (at K = 768 the block's
// only warpgroup); the last units leave SMs idle. A wait on a barrier that
// lasts seconds traps (a launch error) rather than hanging the card.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;
using ppgs::bf16;
using namespace ppgs::hopper;

namespace {

constexpr int UM = 128, BN = 128;      // a unit: rows x columns
constexpr int BK = 64;                 // depth of a W item
constexpr int SLOT = BK * BN * 2;      // a ring slot: a W item, or x in fp32
constexpr int BOX = 64 * 128;          // a 64 x 64 bf16 output box, 8 KB
constexpr int SMEM_MAX = 232448;

// Per width: a block's rows of each unit, and the blocks of a cluster that
// share each W item (each loads a part and multicasts it to all)
template <int K>
struct Plan;
template <>
struct Plan<256> {
  static constexpr int BM = 128, CLUSTER = 1;
};
template <>
struct Plan<512> {
  static constexpr int BM = 128, CLUSTER = 1;
};
template <>
struct Plan<768> {
  static constexpr int BM = 64, CLUSTER = 2;
};

template <int K>
struct Layout {
  static constexpr int BM = Plan<K>::BM, CLUSTER = Plan<K>::CLUSTER;
  static_assert(BM * CLUSTER == UM, "a unit's rows are its blocks' rows");
  static constexpr int WGS = BM / 64;               // consumer warpgroups
  static constexpr int THREADS = 128 * WGS + 32;    // and a producer warp
  static constexpr int N = 3 * K, NT = N / BN, STEPS = K / BK;
  static constexpr int SLAB = BM * 128;   // 64 columns of x in bf16
  static constexpr int X_BOX = BM * 128;  // 32 columns of x in fp32
  static constexpr int XBOXES = SLOT / X_BOX;       // x boxes a slot
  static constexpr int XPER = 2 / XBOXES;           // x slots a W item
  static constexpr int X_BYTES = STEPS * SLAB;
  static constexpr int OUT_BYTES = WGS * 2 * BOX;   // two boxes a warpgroup
  // the ring takes what is left, less 1024 bytes of alignment slack and
  // 256 for its barriers
  static constexpr int STAGES =
      (SMEM_MAX - 1280 - X_BYTES - OUT_BYTES) / SLOT;
  static constexpr int SMEM = X_BYTES + OUT_BYTES + STAGES * (SLOT + 16) +
                              1024;
  static_assert(STAGES >= 2 && STAGES * 16 <= 256 && SMEM <= SMEM_MAX,
                "the plan does not fit a block's shared memory");
};

// The cluster's units [u0, u1), walked forwards by even clusters and
// backwards by odd ones; unit u is row block u / NT, column tile u % NT
template <int K>
struct Walk {
  int u0, u1;
  bool back;
  __device__ explicit Walk(int units) {
    constexpr int C = Layout<K>::CLUSTER;
    const long long b = blockIdx.x / C, g = gridDim.x / C;
    u0 = static_cast<int>(b * units / g);
    u1 = static_cast<int>((b + 1) * units / g);
    back = (b & 1) != 0;
  }
  __device__ int count() const { return u1 - u0; }
  __device__ int at(int i) const { return back ? u1 - 1 - i : u0 + i; }
  __device__ int row(int i) const { return at(i) / Layout<K>::NT; }
  __device__ int col(int i) const { return at(i) % Layout<K>::NT * BN; }
  // the unit starts a row block: its x comes through the ring too
  __device__ bool first(int i) const { return i == 0 || row(i) != row(i - 1); }
};

__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}

// bf16(bf16(a) + bf16(b)) for a pair: the bf16 add of the rounded pairs
__device__ __forceinline__ uint32_t add_bias(float a0, float a1,
                                             uint32_t b) {
  __nv_bfloat162 s = __hadd2(__floats2bfloat162_rn(a0, a1),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&s);
}

// Consumer warpgroup c's rows of an x box (32 fp32 columns a row,
// 128-byte swizzle: the 16-byte chunk q of row r at q ^ (r & 7)) rounded
// to bf16 into half h of a resident slab (chunks 4h..4h+3 of each 128-byte
// row, the same swizzle); thread i of the warpgroup takes row 64c + i %
// 64, chunks i / 64 and i / 64 + 2: eight rows a phase, conflict-free
__device__ __forceinline__ void convert(const unsigned char* box,
                                        unsigned char* slab, int h, int c) {
  const int i = threadIdx.x % 128, row = 64 * c + i % 64, sw = row & 7;
  const unsigned char* src = box + row * 128;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = i / 64 + 2 * e;              // bf16 chunk of the half
    const float4 v0 =
        *reinterpret_cast<const float4*>(src + (((2 * q) ^ sw) << 4));
    const float4 v1 =
        *reinterpret_cast<const float4*>(src + (((2 * q + 1) ^ sw) << 4));
    *reinterpret_cast<uint4*>(slab + row * 128 + (((4 * h + q) ^ sw) << 4)) =
        make_uint4(pack(v0.x, v0.y), pack(v0.z, v0.w), pack(v1.x, v1.y),
                   pack(v1.z, v1.w));
  }
}

// Free a slot: each consumer warp tells its block's barrier and, in a
// cluster, the other blocks' (whose producers load into this block too)
template <int K>
__device__ __forceinline__ void release(uint64_t* empty, int s, int lane) {
  if (lane != 0) return;
  const uint32_t bar = smem_addr(empty + s);
  mbar_arrive(bar);
  if constexpr (Layout<K>::CLUSTER > 1) {
    const uint32_t me = cg::this_cluster().block_rank();
#pragma unroll
    for (uint32_t r = 0; r < Layout<K>::CLUSTER; ++r)
      if (r != me) mbar_arrive_remote(bar, r);
  }
}

// Consumer warpgroup c's products of one unit into acc; FIRST: the unit
// starts a row block, and the 64 columns of x of each depth step arrive
// just before its W item
template <int K, bool FIRST>
__device__ __forceinline__ void mainloop(float (&acc)[BN / 2],
                                         unsigned char* xs,
                                         unsigned char* ring, uint64_t* full,
                                         uint64_t* empty, int& it, int c,
                                         int lane) {
  using L = Layout<K>;
  const uint32_t x_addr = smem_addr(xs) + c * 64 * 128;
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  int prev = 0;
#pragma unroll
  for (int k = 0; k < L::STEPS; ++k) {
    if constexpr (FIRST) {
      // Free the last W item first and each x slot as soon as it is read:
      // a ring of two slots holds one item at a time here
      if (k > 0) {
        wgmma_wait<0>();
        fence_regs(acc);
        release<K>(empty, prev, lane);
      }
#pragma unroll
      for (int h = 0; h < L::XPER; ++h, ++it) {
        const int s = it % L::STAGES;
        mbar_wait(smem_addr(full + s), (it / L::STAGES) & 1);
#pragma unroll
        for (int b = 0; b < L::XBOXES; ++b)
          convert(ring + s * SLOT + b * L::X_BOX, xs + k * L::SLAB,
                  h * L::XBOXES + b, c);
        fence_async_smem();     // the writes, for wgmma's reads
        bar_sync(1 + c, 128);
        release<K>(empty, s, lane);
      }
    }
    const int s = it % L::STAGES;
    mbar_wait(smem_addr(full + s), (it / L::STAGES) & 1);
    const uint32_t b_addr = smem_addr(ring + s * SLOT);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // A K-major (32 bytes of each 128-byte row a k16 step), B MN-major
      // (16 depth rows of 128 bytes a step, the two 64-column boxes SLOT
      // / 2 apart)
      wgmma_ss<BN, 0, 1>(acc,
                         sw128_desc(x_addr + k * L::SLAB + kk * 32, 16, 1024),
                         sw128_desc(b_addr + kk * 2048, SLOT / 2, 1024));
    wgmma_commit();
    if constexpr (!FIRST) {
      wgmma_wait<1>();          // the previous step's products are done
      fence_regs(acc);
      if (k > 0) release<K>(empty, prev, lane);
    }
    prev = s;
    ++it;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release<K>(empty, prev, lane);
}

template <int K>
__global__ void __launch_bounds__(Layout<K>::THREADS, 1)
qkv_proj_kernel(const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_out,
                const float* __restrict__ bias, int M) {
  using L = Layout<K>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* staging = xs + L::X_BYTES;
  unsigned char* ring = staging + L::OUT_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::STAGES * SLOT);
  uint64_t* empty = full + L::STAGES;

  const Walk<K> walk((M + UM - 1) / UM * L::NT);
  const int rank = L::CLUSTER > 1 ? cg::this_cluster().block_rank() : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const auto sync_all = [] {
    if constexpr (L::CLUSTER > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };

  if (threadIdx.x == 0)   // every consumer warp of the cluster frees a slot
    mbar_init_ring(full, empty, L::STAGES, 4 * L::WGS * L::CLUSTER);
  sync_all();

  if (warp == 4 * L::WGS) {
    if (lane == 0) {
      // Producer: the ring's items in the order the consumers walk them;
      // in a cluster, this block's 64 columns of each W item go to every
      // block (and the others' to this one)
      int it = 0;
      auto slot = [&]() {
        const int s = it % L::STAGES, round = it / L::STAGES;
        if (round > 0) mbar_wait(smem_addr(empty + s), (round - 1) & 1);
        mbar_expect_tx(smem_addr(full + s), SLOT);
        ++it;
        return s;
      };
      for (int i = 0; i < walk.count(); ++i) {
        const int m0 = walk.row(i) * UM + rank * L::BM, n0 = walk.col(i);
        const bool first = walk.first(i);
        for (int k = 0; k < L::STEPS; ++k) {
          if (first) {
#pragma unroll
            for (int h = 0; h < L::XPER; ++h) {
              const int s = slot();
#pragma unroll
              for (int b = 0; b < L::XBOXES; ++b)
                tma_load(ring + s * SLOT + b * L::X_BOX, &map_x,
                         ((k * L::XPER + h) * L::XBOXES + b) * 32, m0,
                         smem_addr(full + s));
            }
          }
          const int s = slot();
          unsigned char* dst = ring + s * SLOT;
          if constexpr (L::CLUSTER > 1) {
            tma_load_multicast(dst + rank * (SLOT / 2), &map_w,
                               n0 + 64 * rank, k * BK, smem_addr(full + s),
                               (1u << L::CLUSTER) - 1);
          } else {
            tma_load(dst, &map_w, n0, k * BK, smem_addr(full + s));
            tma_load(dst + SLOT / 2, &map_w, n0 + 64, k * BK,
                     smem_addr(full + s));
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns rows 64c..64c+63 of the block's. A
    // thread holds rows lr and lr + 8, columns 8j + 2t and 8j + 2t + 1
    // (j < 16), of its warp's 16 rows
    const int c = warp / 4, g = lane >> 2, t = lane & 3;
    const int lr = 16 * (warp % 4) + g;
    const bool lead = threadIdx.x % 128 == 0;
    unsigned char* stg = staging + c * 2 * BOX;
    float acc[BN / 2];
    int it = 0;
    for (int i = 0; i < walk.count(); ++i) {
      const int n0 = walk.col(i);
      if (walk.first(i))
        mainloop<K, true>(acc, xs, ring, full, empty, it, c, lane);
      else
        mainloop<K, false>(acc, xs, ring, full, empty, it, c, lane);
      // Epilogue: bf16(bf16(acc) + bf16(b)) into the warpgroup's two
      // boxes, swizzled as TMA reads them (the 16-byte chunk q of row r at
      // q ^ (r & 7): conflict-free), then a TMA store a box, which writes
      // no row past M; the last unit's stores have read the boxes by then
      if (lead) bulk_wait_read();
      bar_sync(1 + c, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(
            bias + n0 + 8 * j + 2 * t));
        const uint32_t bb = pack(b.x, b.y);
        unsigned char* at =
            stg + (j / 8) * BOX + lr * 128 + (((j % 8) ^ g) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(at) =
            add_bias(acc[4 * j], acc[4 * j + 1], bb);
        *reinterpret_cast<uint32_t*>(at + 8 * 128) =   // (lr + 8) & 7 == g
            add_bias(acc[4 * j + 2], acc[4 * j + 3], bb);
      }
      fence_async_smem();
      bar_sync(1 + c, 128);
      const int wg_row = walk.row(i) * UM + rank * L::BM + 64 * c;
      if (lead && wg_row < M) {
        tma_store(&map_out, n0, wg_row, stg);
        tma_store(&map_out, n0 + 64, wg_row, stg + BOX);
        bulk_commit();
      }
    }
    if (lead) bulk_wait_read();
  }
  // No block leaves while another of its cluster may still load into it
  // or free its slots; the producer's warp meets the barrier whole
  __syncwarp();
  sync_all();
}

template <int K>
int launch(const void* x, const void* w, const void* b, void* out, int M,
           cudaStream_t stream) {
  using L = Layout<K>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qkv_proj_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap map_w, map_x, map_out;
  if (!encode(&map_w, w, false, K, L::N, L::N, 64, BK) ||
      !encode(&map_x, x, true, M, K, K, 32, L::BM) ||
      !encode(&map_out, out, false, M, L::N, L::N, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = L::CLUSTER;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  // A persistent grid: as many clusters as the card holds at once
  cfg.gridDim = dim3(L::CLUSTER);
  static int clusters = 0;
  if (clusters <= 0) {
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &clusters, qkv_proj_kernel<K>, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int units = (M + UM - 1) / UM * L::NT;
  cfg.gridDim = dim3((units < clusters ? units : clusters) * L::CLUSTER);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, qkv_proj_kernel<K>, map_w, map_x, map_out,
      static_cast<const float*>(b), M);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) fp32, w (K, N) bf16, b (N) fp32 -> out (M, N) bf16, all
// contiguous and 16-byte aligned; (K, N) = (256, 768), (512, 1536) or
// (768, 2304), else cudaErrorInvalidValue (the Python wrapper checks the
// same before it launches).
extern "C" int ppgs_qkv_proj(const void* x, const void* w, const void* b,
                             void* out, int M, int K, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N != 3 * K || (K != 256 && K != 512 && K != 768))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  if (K == 256) return launch<256>(x, w, b, out, M, s);
  if (K == 512) return launch<512>(x, w, b, out, M, s);
  return launch<768>(x, w, b, out, M, s);
}
