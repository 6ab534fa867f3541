// A bf16 matrix product with fp32 accumulation and transpose flags, for
// the products of the training layer's backward that are not inside
// another kernel: the data gradients through the attention projections
// (da = do Wo^T, dx = dqkv Wqkv^T + dz1) and the weight gradients
// (dWo = a^T do, dWqkv = x^T dqkv, dW1 = r^T dh, dW2 = hd^T dy).
//
// Replaces: the `dot(..., w*t_ref)` and `dotT(...)` products of
// ppgs_tpu/ops/encoder_layer_train.py _bwd_kernel (pallas_call :531) and
// the dw1/dw2 products of ppgs_tpu/ops/fused_ffn.py _ffn_train_bwd_kernel
// (pallas_call :294). The TPU kernels sum the weight gradients over their
// sequential grid into revisited output blocks; here a weight gradient is
// a product whose depth is all M rows (131,072 at the training shape) with
// a small output (at most 2048 x 256), so it splits the depth over
// blockIdx.z, each split writing fp32 partial sums, and colsum
// (layer_train.cu) adds the partials in a fixed order: deterministic, no
// atomics and no TMA reduce-add.
//
// C[m, n] = sum_k A(m, k) B(k, n) with A(m, k) = a[m, k] (ta = 0) or
// a[k, m] (ta = 1), B(k, n) = b[n, k] (tb = 1) or b[k, n] (tb = 0); A may
// be fp32 (ta = 1 only), rounded to bf16 (nearest even) as it is read (the
// TPU's x.astype(cd) of res['rc'] / res['xc']). The epilogue writes fp32
// (plus an fp32 residual, where given) and/or bf16, or fp32 split partials.
// Taken: (ta, tb) = (0, 1) (data gradients, any M) and (1, 0) (weight
// gradients, any depth K); N % 128 == 0; every row 16-byte aligned.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s) at the training shape,
// 131,072 rows, C = 256, F = 2048: every form is bound by bytes. dW1
// 0.2010 ms (137.4 GFLOP, 673 MB), dW2 0.1809, dWo 0.0401, dWqkv 0.1004,
// da 0.0802, dx 0.1403: 0.743 ms a layer.
//
// Design (a warp-specialised wgmma + TMA mainloop, against the three
// faults of the 16x16x16 mma.sync body it replaces):
// - no Hopper tensor-core path: two consumer warpgroups each own 64 rows x
//   BN columns of a 128 x BN block tile (BN = 256, or 128 where
//   N % 256 != 0) and issue wgmma.mma_async.m64nBNk16, fp32 accumulators
//   in registers;
// - synchronous loads between two barriers: one producer thread keeps a
//   ring of STAGES 64-deep stages in flight with TMA (128-byte swizzle),
//   full and empty mbarriers, so loads overlap the products; setmaxnreg
//   moves the producer warpgroup's registers to the consumers (40 against
//   232), though ptxas fits the consumers' code in the launch's 168;
// - a 64 x 128 tile that re-read its operands (about 4.3 GB through L2 on
//   dW1): the 128 x 256 tile reads each operand 2-8 times less often, and
//   the weight gradients split their depth so that tiles x splits fills
//   one wave of the 132 SMs (ops/backward.py split_count).
// Layouts: (0, 1) loads both operands K-major (a 64-deep row is the 128
// bytes of one swizzle atom); (1, 0) loads both MN-major, as stored, in
// 64-column (bf16) or 32-column (fp32) boxes, and sets wgmma's transpose
// immediates. For MN-major the descriptor's leading byte offset is the
// step between 64-element atoms along M or N (one box, 8 KB) and the stride
// byte offset the step between groups of 8 depth rows (1 KB). An fp32 A
// is TMA'd as it is; each consumer thread reads its m64k16 fragment from
// the swizzled tile (conflict-free), rounds it to bf16 and issues wgmma
// with A from registers (the RS form): no cast kernel and no second copy
// in shared memory. Two fragments are live at a time (with 128
// accumulators, four spill at 168 registers and serialise the wgmmas), and
// each stage waits for its last product before it is released (the other
// warpgroup fills the gap).
// A split's depth chunk is a multiple of 64 rows, so no box reads into the
// next chunk; only the last is ragged, where TMA fills zeros past the end.
// A wait on a barrier that lasts seconds traps (a launch error) rather
// than hanging the card.

#include <cuda.h>   // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                    // looked up at run time (no -lcuda)

#include "common.cuh"

using ppgs::bf16;

namespace {

constexpr int BM = 128, BK = 64;          // block tile rows, depth step
constexpr int THREADS = 384;              // producer warpgroup + 2 consumers
constexpr int RING_BYTES = 192 * 1024;    // the stages' shared memory
constexpr int BOX_BYTES = 8192;           // 64 rows of 128 bytes

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

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(bar)
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

#define PPGS_R64                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "       \
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
#define PPGS_F64                                                            \
  PPGS_F8(0), PPGS_F8(8), PPGS_F8(16), PPGS_F8(24), PPGS_F8(32),            \
      PPGS_F8(40), PPGS_F8(48), PPGS_F8(56)
#define PPGS_F128                                                           \
  PPGS_F64, PPGS_F8(64), PPGS_F8(72), PPGS_F8(80), PPGS_F8(88),             \
      PPGS_F8(96), PPGS_F8(104), PPGS_F8(112), PPGS_F8(120)

// d (64 x BN fp32, BN / 2 a thread) += A (64 x 16, shared memory) B (16 x
// BN, shared memory); TRANS: both operands MN-major
template <int BN, int TRANS>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 256) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{" PPGS_R128 "}, %128, %129, p, 1, 1, %131, %131;\n}\n"
        : PPGS_F128
        : "l"(da), "l"(db), "r"(1), "n"(TRANS));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" PPGS_R64 "}, %64, %65, p, 1, 1, %67, %67;\n}\n"
        : PPGS_F64
        : "l"(da), "l"(db), "r"(1), "n"(TRANS));
  }
}

// The same with A's m64k16 fragment in registers and B MN-major
template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (BN == 256) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{" PPGS_R128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : PPGS_F128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" PPGS_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : PPGS_F64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

template <bool TA, bool A_F32, int BN>
struct Tile {
  static constexpr int A_BYTES = BM * BK * (A_F32 ? 4 : 2);
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE;    // 3, 4 or 6
  // the ring, its barriers, and slack to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// One consumer thread's m64k16 A fragment of depth step kk from an fp32
// stage (four 32-column boxes of 64 depth rows, 128-byte swizzle), rounded
// to bf16: registers {a0 a1}, {a2 a3}, {a4 a5}, {a6 a7} of the fragment are
// (row g, depth 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)
// of the warp's 16 rows
__device__ __forceinline__ void f32_fragment(uint32_t (&a)[4],
                                             const float* stage, int wg,
                                             int warp, int lane, int kk) {
  const int g = lane >> 2, t = lane & 3;
  const float* box = stage + (2 * wg + (warp >> 1)) * (BOX_BYTES / 4);
#pragma unroll
  for (int q = 0; q < 2; ++q) {       // depth 2t.. or 2t + 8..
#pragma unroll
    for (int h = 0; h < 2; ++h) {     // row g or g + 8
      const int mm = 16 * (warp & 1) + 8 * h + g;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * kk + 8 * q + 2 * t + e;
        v[e] = box[k * 32 + (((mm >> 2) ^ (k & 7)) << 2) + (mm & 3)];
      }
      __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);
      a[2 * q + h] = *reinterpret_cast<uint32_t*>(&p);
    }
  }
}

template <bool TA, bool A_F32, int BN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b,
            float* __restrict__ out32, bf16* __restrict__ out16,
            const float* __restrict__ residual, long long ldc, int M, int K,
            int k_chunk) {
  using T = Tile<TA, A_F32, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int steps = max(0, (min(K, k_begin + k_chunk) - k_begin + BK - 1) / BK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_addr(full + s)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 8;"   // consumer warps
                   ::"r"(smem_addr(empty + s)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 0) return;
    for (int i = 0; i < steps; ++i) {
      const int s = i % T::STAGES, round = i / T::STAGES;
      if (round > 0) mbar_wait(smem_addr(empty + s), (round - 1) & 1);
      const uint32_t bar = smem_addr(full + s);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar), "r"(T::STAGE) : "memory");
      unsigned char* sa = ring + s * T::STAGE;
      unsigned char* sb = sa + T::A_BYTES;
      const int k = k_begin + i * BK;
      if (!TA) {          // K-major: 128 (m) and BN (n) rows of 64
        tma_load(sa, &map_a, k, m0, bar);
        tma_load(sb, &map_b, k, n0, bar);
      } else {            // MN-major: 64 depth rows of 128-byte boxes
        constexpr int A_COLS = A_F32 ? 32 : 64;
#pragma unroll
        for (int j = 0; j < BM / A_COLS; ++j)
          tma_load(sa + j * BOX_BYTES, &map_a, m0 + j * A_COLS, k, bar);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(sb + j * BOX_BYTES, &map_b, n0 + j * 64, k, bar);
      }
    }
    return;
  }

  // Consumers: warpgroup c = wg - 1 owns rows 64c..64c+63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int s = i % T::STAGES;
    mbar_wait(smem_addr(full + s), (i / T::STAGES) & 1);
    unsigned char* sa = ring + s * T::STAGE;
    const uint32_t a_addr = smem_addr(sa), b_addr = a_addr + T::A_BYTES;
    if constexpr (A_F32) {
      // One depth step's fragment a product, the next one's loaded while
      // it runs: two fragments live, not four (registers are the limit)
      uint32_t frag[2][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        f32_fragment(frag[kk & 1], reinterpret_cast<const float*>(sa), c,
                     warp, lane, kk);
        fence_regs(acc);
        wgmma_fence();
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
      if (lane == 0) mbar_arrive(smem_addr(empty + s));
    } else {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint64_t da, db;
        if (TA) {         // MN-major: 16 depth rows of 128 bytes a step
          da = sw128_desc(a_addr + c * BOX_BYTES + kk * 2048, BOX_BYTES,
                          1024);
          db = sw128_desc(b_addr + kk * 2048, BOX_BYTES, 1024);
        } else {          // K-major: 32 bytes of each 128-byte row a step
          da = sw128_desc(a_addr + c * 64 * 128 + kk * 32, 16, 1024);
          db = sw128_desc(b_addr + kk * 32, 16, 1024);
        }
        wgmma_ss<BN, TA ? 1 : 0>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();    // the previous step's products are done
      fence_regs(acc);
      if (i > 0 && lane == 0)
        mbar_arrive(smem_addr(empty + (i - 1) % T::STAGES));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue from the accumulator fragments: register 4j + e holds row
  // g + 8 (e / 2) of the warp's 16, columns 8j + 2t + e % 2; split z
  // writes its own (M, N) slab of partial sums
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + 64 * c + 16 * warp + g, row1 = row0 + 8;
  const long long slab = static_cast<long long>(blockIdx.z) * M * ldc;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    float2 v0 = make_float2(acc[4 * j], acc[4 * j + 1]);
    float2 v1 = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    const long long g0 = row0 * ldc + col, g1 = row1 * ldc + col;
    if (residual) {
      if (row0 < M) {
        const float2 r = *reinterpret_cast<const float2*>(residual + g0);
        v0.x += r.x, v0.y += r.y;
      }
      if (row1 < M) {
        const float2 r = *reinterpret_cast<const float2*>(residual + g1);
        v1.x += r.x, v1.y += r.y;
      }
    }
    if (out32) {
      if (row0 < M) *reinterpret_cast<float2*>(out32 + slab + g0) = v0;
      if (row1 < M) *reinterpret_cast<float2*>(out32 + slab + g1) = v1;
    }
    if (out16) {
      // 8-byte stores: lanes t and t ^ 1 trade halves so that an even t
      // holds 4 columns of row g, an odd t 4 columns of row g + 8
      __nv_bfloat162 p0 = __floats2bfloat162_rn(v0.x, v0.y);
      __nv_bfloat162 p1 = __floats2bfloat162_rn(v1.x, v1.y);
      const uint32_t u0 = *reinterpret_cast<uint32_t*>(&p0);
      const uint32_t u1 = *reinterpret_cast<uint32_t*>(&p1);
      const uint32_t got = __shfl_xor_sync(0xffffffffu, (t & 1) ? u0 : u1, 1);
      const int row = (t & 1) ? row1 : row0;
      if (row < M) {
        const uint2 o = (t & 1) ? make_uint2(got, u1) : make_uint2(u0, got);
        *reinterpret_cast<uint2*>(out16 + row * ldc + col - 2 * (t & 1)) = o;
      }
    }
  }
}

#undef PPGS_R64
#undef PPGS_R128
#undef PPGS_F8
#undef PPGS_F64
#undef PPGS_F128

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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
// boxes of box_rows x box_cols (box_cols x element = 128 bytes) with the
// 128-byte swizzle; zeros past its edges
bool encode(CUtensorMap* map, const void* base, bool f32, long long rows,
            long long cols, long long ld, int box_cols, int box_rows) {
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
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TA, bool A_F32, int BN>
int launch(const void* a, long long lda, const void* b, long long ldb,
           float* out32, bf16* out16, const float* residual, long long ldc,
           int M, int N, int K, int splits, int k_chunk, cudaStream_t s) {
  using T = Tile<TA, A_F32, BN>;
  CUtensorMap map_a, map_b;
  const bool ok =
      TA ? encode(&map_a, a, A_F32, K, M, lda, A_F32 ? 32 : 64, BK) &&
               encode(&map_b, b, false, K, N, ldb, 64, BK)
         : encode(&map_a, a, false, M, K, lda, BK, BM) &&
               encode(&map_b, b, false, N, K, ldb, BK, BN);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_kernel<TA, A_F32, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((M + BM - 1) / BM, N / BN, splits);
  kernel<<<grid, THREADS, T::SMEM, s>>>(map_a, map_b, out32, out16, residual,
                                        ldc, M, K, k_chunk);
  return static_cast<int>(cudaGetLastError());
}

template <bool TA, bool A_F32>
int launch_n(const void* a, long long lda, const void* b, long long ldb,
             float* out32, bf16* out16, const float* residual, long long ldc,
             int M, int N, int K, int splits, int k_chunk, cudaStream_t s) {
  return N % 256 == 0
             ? launch<TA, A_F32, 256>(a, lda, b, ldb, out32, out16, residual,
                                      ldc, M, N, K, splits, k_chunk, s)
             : launch<TA, A_F32, 128>(a, lda, b, ldb, out32, out16, residual,
                                      ldc, M, N, K, splits, k_chunk, s);
}

}  // namespace

// C (M, N) = op(a) op(b); see the header for the layouts. a_is_f32: a is
// fp32 (rounded to bf16 as read; ta = 1 only). out32 (fp32, with `splits`
// slabs of (M, N) partials when splits > 1) and/or out16 (bf16, splits ==
// 1), row stride ldc; residual (M, N) fp32 added when not null
// (splits == 1). A split's depth chunk is ceil(ceil(K / splits) / 64) * 64
// rows (ops/backward.py _k_chunk).
extern "C" int ppgs_gemm(const void* a, int a_is_f32, int ta, long long lda,
                         const void* b, int tb, long long ldb, void* out32,
                         void* out16, const void* residual, long long ldc,
                         int M, int N, int K, int splits, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (N % 128 || splits < 1 || (splits > 1 && (out16 || residual)) ||
      (a_is_f32 && !ta) || ta == tb)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_chunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  float* o32 = static_cast<float*>(out32);
  bf16* o16 = static_cast<bf16*>(out16);
  const float* res = static_cast<const float*>(residual);
  if (!ta)
    return launch_n<false, false>(a, lda, b, ldb, o32, o16, res, ldc, M, N,
                                  K, splits, k_chunk, s);
  if (a_is_f32)
    return launch_n<true, true>(a, lda, b, ldb, o32, o16, res, ldc, M, N, K,
                                splits, k_chunk, s);
  return launch_n<true, false>(a, lda, b, ldb, o32, o16, res, ldc, M, N, K,
                               splits, k_chunk, s);
}
