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
// than hanging the card. The mainloop's building blocks (barriers, TMA,
// descriptors, wgmma) are in hopper.cuh, shared with ffn_ln.cu.

#include "hopper.cuh"

using ppgs::bf16;
using namespace ppgs::hopper;

namespace {

constexpr int BM = 128, BK = 64;          // block tile rows, depth step
constexpr int THREADS = 384;              // producer warpgroup + 2 consumers
constexpr int RING_BYTES = 192 * 1024;    // the stages' shared memory
constexpr int BOX_BYTES = 8192;           // 64 rows of 128 bytes

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

  if (threadIdx.x == 0)
    mbar_init_ring(full, empty, T::STAGES, 8);   // 8 consumer warps
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 0) return;
    for (int i = 0; i < steps; ++i) {
      const int s = i % T::STAGES, round = i / T::STAGES;
      if (round > 0) mbar_wait(smem_addr(empty + s), (round - 1) & 1);
      const uint32_t bar = smem_addr(full + s);
      mbar_expect_tx(bar, T::STAGE);
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
        wgmma_ss<BN, TA ? 1 : 0, TA ? 1 : 0>(acc, da, db);
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
