// Hopper building blocks shared by the kernels that feed the tensor cores
// with TMA and wgmma (gemm.cu, ffn_ln.cu, attention.cu, qkv_proj.cu,
// attention_train.cu, attention_train_bwd.cu, ffn_train.cu, conv_stack.cu,
// fused_mel.cu, and out_proj_ln.cu through residual_ln.cuh):
// mbarrier waits that trap rather than hang, TMA tile loads and stores
// (2-D and 3-D), the 128-byte-swizzle shared-memory descriptor, the
// wgmma.mma_async wrappers (A from shared memory or from registers), the
// staging of rows as a swizzled bf16 operand tile, the attention kernels'
// quad reductions and swizzled output staging, and the host-side encoding
// of a TMA tensor map (2-D and 3-D). Header-only; sm_90a.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                    // looked up at run time (no -lcuda)

#include "common.cuh"

namespace ppgs {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// A wait that lasts seconds traps (a launch error) rather than hanging the
// card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - start > 4000000000ull) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Arrive on the barrier at `bar`'s offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar,
                                                   uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      ::"r"(bar), "r"(rank) : "memory");
}

// Initialise one barrier for `count` arrivals; the fence that ends
// mbar_init_ring publishes it too when it comes first
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Initialise the ring's barriers: full[s] waits for the producer's one
// arrival (and the bytes it announces), empty[s] for `consumers` arrivals
__device__ __forceinline__ void mbar_init_ring(uint64_t* full,
                                               uint64_t* empty, int stages,
                                               int consumers) {
  for (int s = 0; s < stages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 ::"r"(smem_addr(full + s)) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 ::"r"(smem_addr(empty + s)), "r"(consumers) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(bar)
      : "memory");
}

// The same into the same offset of the shared memory of each block of the
// cluster in `mask`, each block's barrier at `bar`'s offset told the bytes
// it receives
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   int c0, int c1,
                                                   uint32_t bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

// The same from a 3-D tensor map, at coordinates (c0, c1, c2)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Store a box of shared memory through a 2-D tensor map at (c0, c1), or a
// 3-D one at (c0, c1, c2); what falls past the map's edges is not written.
// bulk_commit, then bulk_wait_read before the shared memory is reused or
// the block exits
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0,
                                          int c1, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int c0,
                                             int c1, int c2,
                                             const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// A contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, reported to the barrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
      "r"(bytes), "r"(bar)
      : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle; the tile's
// 1024-byte atoms start 1024-byte aligned (base offset 0)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING)
               : "memory");
}
// Keep the compiler from moving or reusing registers that an asynchronous
// wgmma reads or writes
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads, TMA); a barrier after it publishes
// them to the other threads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A named barrier over `count` threads (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
// Arrive at it without waiting: what this thread wrote before is visible
// to the threads that bar_sync on it
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

#define PPGS_R16                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define PPGS_R32                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
  "%28, %29, %30, %31"
#define PPGS_R40                                                            \
  PPGS_R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define PPGS_R64                                                            \
  PPGS_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, "                \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "       \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define PPGS_R128                                                           \
  PPGS_R64 ", %64, %65, %66, "                                              \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "       \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "       \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "       \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "      \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define PPGS_F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PPGS_F16 PPGS_F8(0), PPGS_F8(8)
#define PPGS_F32 PPGS_F8(0), PPGS_F8(8), PPGS_F8(16), PPGS_F8(24)
#define PPGS_F40 PPGS_F32, PPGS_F8(32)
#define PPGS_F64                                                            \
  PPGS_F32, PPGS_F8(32), PPGS_F8(40), PPGS_F8(48), PPGS_F8(56)
#define PPGS_F128                                                           \
  PPGS_F64, PPGS_F8(64), PPGS_F8(72), PPGS_F8(80), PPGS_F8(88),             \
      PPGS_F8(96), PPGS_F8(104), PPGS_F8(112), PPGS_F8(120)

// d (64 x BN fp32, BN / 2 a thread; BN 32, 64, 128 or 256) += A (64 x 16,
// shared memory) B (16 x BN, shared memory); TA / TB: that operand is
// MN-major (wgmma's transpose immediates), else K-major
template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 256) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{" PPGS_R128 "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : PPGS_F128
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (BN == 128) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" PPGS_R64 "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : PPGS_F64
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (BN == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" PPGS_R32 "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : PPGS_F32
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else {
    static_assert(BN == 32, "wgmma_ss takes BN 32, 64, 128 or 256");
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" PPGS_R16 "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : PPGS_F16
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
}

// The same with A's m64k16 fragment in registers; TB: B is MN-major (as
// stored row-major (K, N)), else K-major; accumulate false: d = A B, its
// old value ignored. BN 80 is for the mel product of fused_mel.cu (80 mel
// bands)
template <int BN, int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         bool accumulate = true) {
  const int scale_d = accumulate ? 1 : 0;
  if constexpr (BN == 256) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{" PPGS_R128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : PPGS_F128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  } else if constexpr (BN == 128) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" PPGS_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : PPGS_F64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  } else if constexpr (BN == 80) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %45, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{" PPGS_R40 "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : PPGS_F40
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  } else {
    static_assert(BN == 64, "wgmma_rs takes BN 64, 80, 128 or 256");
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" PPGS_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : PPGS_F32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  }
}

#undef PPGS_R16
#undef PPGS_R32
#undef PPGS_R40
#undef PPGS_R64
#undef PPGS_R128
#undef PPGS_F8
#undef PPGS_F16
#undef PPGS_F32
#undef PPGS_F40
#undef PPGS_F64
#undef PPGS_F128

__device__ __forceinline__ uint4 to_bf16x8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  __nv_bfloat162 q[4] = {
      __floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
      __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  return *reinterpret_cast<uint4*>(q);
}
__device__ __forceinline__ uint4 to_bf16x8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// 64 rows of a (M, COLS) fp32 or bf16 array from row grow0 into rows
// srow0.. of a K-major bf16 operand tile of TILE_ROWS rows (COLS / 64
// atoms of TILE_ROWS x 128 bytes, the 16-byte chunk q of row r at
// q ^ (r & 7), as a 128-byte-swizzled TMA load lays it out), rounded to
// bf16; zeros past M. 128 threads (tid 0..127); a warp reads one row
// (coalesced) and writes each atom's 128 bytes of it.
template <int TILE_ROWS, int COLS, typename T>
__device__ __forceinline__ void stage_rows(unsigned char* tile, const T* src,
                                           long long grow0, int srow0, int M,
                                           int tid) {
  constexpr int CHUNKS = COLS / 8;          // 8-column chunks of a row
#pragma unroll 4
  for (int i = tid; i < 64 * CHUNKS; i += 128) {
    const int r = i / CHUNKS, q = i % CHUNKS;
    const long long grow = grow0 + r;
    const uint4 v = grow < M ? to_bf16x8(src + grow * COLS + q * 8)
                             : make_uint4(0u, 0u, 0u, 0u);
    const int sr = srow0 + r;
    *reinterpret_cast<uint4*>(tile + (q / 8) * (TILE_ROWS * 128) + sr * 128 +
                              (((q % 8) ^ (sr & 7)) << 4)) = v;
  }
}

// --- The attention kernels' softmax and epilogue (attention.cu,
// attention_train.cu, attention_train_bwd.cu). An m64nN accumulator holds,
// in register 4j + e, row g + 8 (e / 2) of the warp's 16 rows and column
// 8j + 2t + e % 2 (lane = 4g + t).

// exp2 in fp32 (relative error ~2^-22; denormal results flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Reductions over the four lanes of a quad: one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two fp32 values as the bf16 pair of an A fragment (a in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Zero an accumulator before the wgmma fence
template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
  fence_regs(r);
}

// Stage columns 8 J0 .. 8 J1 - 1 of a 64 x D fp32 accumulator as boxes of
// 64 rows x 32 fp32 columns, 128-byte swizzled (the 16-byte chunk q of row
// r at q ^ (r & 7)), box n at box(n) holding columns 8 J0 + 32 n onwards
template <int D, int J0 = 0, int J1 = D / 8, typename Box>
__device__ __forceinline__ void stage_f32(const float (&acc)[D / 2],
                                          Box box, int warp, int g, int t) {
  const int row = (16 * warp + g) * 128;
#pragma unroll
  for (int j = J0; j < J1; ++j) {
    unsigned char* p = box((j - J0) / 4) + row +
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

// Publish warpgroup c's staged boxes and write them by TMA stores at
// (col0 + n * width, row, window) of a 3-D map, none past row T; the
// shared memory is free again on return. wg_lead: the warpgroup's thread 0
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D row-major (rows, cols) tensor of 2- or 4-byte elements, loaded in
// boxes of box_rows x box_cols (box_cols x element = 128 bytes, or the
// width of another swizzle) with the 128-byte swizzle unless `swizzle`
// says otherwise; zeros past its edges
inline bool encode(CUtensorMap* map, const void* base, bool f32,
                   long long rows, long long cols, long long ld,
                   int box_cols, int box_rows,
                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map,
            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D bf16 (or, with f32, fp32) tensor of n2 slabs of n1 rows of n0
// elements (rows ld1 elements apart, slabs ld2), loaded in boxes of box0 x
// box1 x 1 (box0 x element = 128 bytes) with the 128-byte swizzle; zeros
// past its edges
inline bool encode_3d(CUtensorMap* map, const void* base, long long n0,
                      long long n1, long long n2, long long ld1,
                      long long ld2, int box0, int box1, bool f32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t size = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n0),
                              static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld1) * size,
                                 static_cast<cuuint64_t>(ld2) * size};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map,
            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace ppgs
