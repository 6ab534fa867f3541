// The FFN's training backward up to its input, C = 256, any F % 128 == 0,
// any M; the forward is K4 (ffn_ln.cu) with its dropout sites on.
//
// Replaces: the backward of ppgs_tpu/ops/fused_ffn.py ffn_train
// (_ffn_train_bwd_kernel) and the FFN half of the backward of
// ppgs_tpu/ops/encoder_layer_train.py (_bwd_kernel after LN2).
//
// What it computes, with the TPU kernels' rounding points: dy (M, 256)
// bf16 is the gradient of the FFN's output, already masked and rounded
// (the LayerNorm backward or the dropout replay before it makes it), and
// for every hidden column
//   h   = relu(bf16(bf16(x W1) + bf16(b1)))          (recomputed)
//   hd  = keep_h ? bf16(h * bf16(1 / (1 - rate))) : 0
//   dhd = keep_h ? (dy W2^T) / (1 - rate) : 0         (fp32)
//   dh  = h > 0 ? dhd : 0                             (fp32)
//   dx  = bf16(dh) W1^T, plus the fp32 residual (x fp32, B4's form) or
//         rounded to bf16 (x bf16, ffn_train's form)
// It writes hd and bf16(dh) (M, F) bf16 for the weight-gradient products
// dW2 = hd^T dy and dW1 = x^T bf16(dh), which run as GEMMs (gemm.cu): they
// reduce over all M rows, which the TPU kernel accumulates across its
// sequential grid and Hopper's parallel blocks cannot. db1's column
// partials of the fp32 dh, one row per 64 rows, are summed by colsum. The
// keep bits are read, not drawn: K4's train form writes them as int32
// words (M, F / 32), bit k of word w for column 32 w + k; at rate 0 there
// are none.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s) at the training shape
// (M = 131,072, F = 2048): three products, 6 M 256 F = 412 GFLOP, 0.417
// ms; bytes: x (fp32), dy, the residual, the words and the weights in,
// dx, hd, dh and the db1 partials out, 1.60 GB, 0.476 ms. So the bytes
// bound it, and 1.07 GB of them are hd and dh, the price of leaving the
// weight gradients to the GEMMs.
//
// Design, on the wgmma + TMA building blocks of hopper.cuh, after K4's
// fused C = 256 kernel: a block owns 128 rows, two consumer warpgroups of
// 64, 256 threads, one block an SM. x (rounded to bf16 as it is staged)
// and dy stay in shared memory as K-major 128-byte-swizzled tiles (64 KB
// each), and the block walks F in chunks of FC = 32 hidden columns. TMA
// brings each chunk's W1 piece and W2 piece once into a stage of a
// 2-stage ring (thread 0 fills it, thread LOADER refills a stage when both
// warpgroups have released it), and the one W1 piece feeds two products:
// - h = x W1_f and dhd = dy W2_f^T: m64n32k16, A the resident tile, B the
//   chunk's 32 rows of W1^T (the wrapper hands W1 transposed, (F, 256))
//   or of W2, both K-major;
// - dx += bf16(dh) W1_f^T: m64n256k16 with A in registers (the RS form:
//   the elementwise pass leaves bf16(dh) as the A fragments) and B the
//   same W1^T rows read MN-major.
// dx's 64 x 256 fp32 sum stays in registers for the whole walk (128 a
// thread), beside h's 16, dhd's 16 and the fragments' 8. The chunk width
// is set by shared memory, not registers: x and dy take 128 KB of the
// 227, and a stage of FC = 64 (64 KB) would leave no room for a second
// one and the output staging; FC = 32 stages are 32 KB. The W1 piece must
// be 32 columns of 128-byte-swizzled rows for both of its operand forms,
// hence W1^T. Measured no faster on an H100 (PERF.md §6, findings):
// separate rings of 3 W1 and 2 W2 pieces, each refilled two chunks ahead
// (+3%); a 2-block cluster sharing each piece by TMA multicast on top of
// them (+11%); the two warpgroups taking turns to issue their products
// (+1%). Neither the ring's depth nor the weights' L2 stream sets the
// pace: the products (m64n32 reads A from shared memory for 32 columns)
// and the elementwise pass (two warps a scheduler) add up, ~1.1 and
// ~1.3 us a chunk.
// Per chunk, each warpgroup: bias, ReLU, the keep bits, the scale and the
// roundings on the two accumulators in registers; hd and bf16(dh) into
// swizzled (64-byte) staging tiles that TMA stores write out (register
// stores inside a wgmma mainloop stall it under memory back-pressure, TMA
// stores do not); db1's column sums from the fp32 dh, one partial row a
// warpgroup. No barrier holds the warps of a warpgroup together in this
// pass: each warp stages and stores its own 16 rows, and sums them by a
// butterfly of 7 shuffles that leaves one column a lane; warps 1-3 hand
// their sums over through shared memory (two buffers, by chunk parity)
// with a barrier arrive, and warp 0 waits, adds the four in order and
// stores the row. (A first form that staged and stored each warpgroup's
// 64 rows at once, behind two warpgroup barriers a chunk, and summed by
// 24 shuffles, was 2-5% slower.) Chunk f's dx product and chunk f + 1's
// two products are issued together after chunk f's elementwise pass, and
// the last chunk is peeled, so that no branch or barrier wait lies
// between them (ptxas then waits for every wgmma in flight, C7518).
// Rows past M: the staged tiles hold zeros there (so dhd and dh are 0),
// TMA stores clip them, and no row >= M is written.
//
// C = 512 (the w2v2fb head) would not fit this form: its dx sum, 128 x 512
// fp32, is twice the registers that two warpgroups have. It needs 64-row
// blocks with a cluster multicasting each weight stage to two of them, or
// a split of dx along C (each block recomputing h and dh for half of C's
// columns, or reading them).

#include "common.cuh"
#include "hopper.cuh"

using ppgs::bf16;
using namespace ppgs::hopper;

namespace {

constexpr int C = 256, BM = 128, FC = 32;
constexpr int THREADS = 256;            // two consumer warpgroups
constexpr int LOADER = 128;             // the thread that refills the ring
constexpr int STAGES = 2;
// Computes the function; false gives a loads-only walk that streams every
// stage, stages x and dy and writes the outputs but multiplies nothing
// (scripts/torch_ffn_bwd_probe.py times it)
constexpr bool LIVE = true;

struct Smem {
  static constexpr int TILE = BM * C * 2;          // x or dy: 4 atoms
  static constexpr int BOX = FC * 128;             // 32 rows x 64 columns
  static constexpr int W_BYTES = FC * C * 2;       // 4 boxes
  static constexpr int B1_BYTES = FC * 4;
  static constexpr int LOADED = 2 * W_BYTES + B1_BYTES;
  static constexpr int STAGE = 2 * W_BYTES + 1024;  // W1^T, W2, b1
  static constexpr int OUT = 64 * FC * 2;           // a warpgroup's rows
  static constexpr int WARP_OUT = 16 * FC * 2;      // a warp's box
  static constexpr int X = 0;
  static constexpr int DY = X + TILE;
  static constexpr int RING = DY + TILE;
  static constexpr int HD = RING + STAGES * STAGE;  // [2 warpgroups]
  static constexpr int DH = HD + 2 * OUT;
  static constexpr int SUMS = DH + 2 * OUT;   // [2 wgs][2][4 warps][FC]
  static constexpr int BARS = SUMS + 2 * 2 * 4 * FC * 4;
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;   // + align
  static_assert(BYTES <= 232448, "more shared memory than a block may have");
  static_assert(RING % 1024 == 0 && STAGE % 1024 == 0 && HD % 1024 == 0,
                "tiles must keep their swizzle atoms aligned");
};

// acc (the warpgroup's 64 rows x FC) = A B over depth C: A the resident
// tile's rows (K-major), B the stage's FC rows of W1^T or W2 (K-major)
__device__ __forceinline__ void issue_narrow(float (&acc)[FC / 2],
                                             uint32_t a, uint32_t b) {
#pragma unroll
  for (int k = 0; k < C / 16; ++k)
    wgmma_ss<FC, 0, 0>(
        acc, sw128_desc(a + (k / 4) * (BM * 128) + (k % 4) * 32, 16, 1024),
        sw128_desc(b + (k / 4) * Smem::BOX + (k % 4) * 32, 16, 1024));
}

template <typename TX, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_kernel(const __grid_constant__ CUtensorMap map_w1t,
               const __grid_constant__ CUtensorMap map_w2,
               const __grid_constant__ CUtensorMap map_hd,
               const __grid_constant__ CUtensorMap map_dh,
               const TX* __restrict__ x, const bf16* __restrict__ dy,
               const float* __restrict__ b1,
               const uint32_t* __restrict__ words,
               const float* __restrict__ residual, float* __restrict__ dx32,
               bf16* __restrict__ dx16, float* __restrict__ db1_partial,
               int M, int F, float scale) {
  using S = Smem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = sm + S::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.x * BM;
  const int chunks = F / FC, wpr = F / 32;      // words a row

  // Load chunk f's W1^T and W2 rows and its b1 into stage f % STAGES
  auto load = [&](int f) {
    const int s = f % STAGES;
    const uint32_t bar = smem_addr(full + s);
    mbar_expect_tx(bar, S::LOADED);
    unsigned char* st = ring + s * S::STAGE;
#pragma unroll
    for (int j = 0; j < C / 64; ++j) {
      tma_load(st + j * S::BOX, &map_w1t, j * 64, f * FC, bar);
      tma_load(st + S::W_BYTES + j * S::BOX, &map_w2, j * 64, f * FC, bar);
    }
    bulk_load(st + 2 * S::W_BYTES, b1 + f * FC, S::B1_BYTES, bar);
  };
  if (threadIdx.x == 0) {
    mbar_init_ring(full, empty, STAGES, 8);
    for (int f = 0; f < STAGES && f < chunks; ++f) load(f);
  }
  __syncthreads();

  const int c = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp + g;                 // the warpgroup's row
  const long long r0 = m0 + 64 * c + wr, r1 = r0 + 8;
  const bool dropped = words != nullptr;
  const float sc16 = ppgs::round_bf16(scale);

  // The warpgroup's rows of x and dy, for the async proxy to read
  stage_rows<BM, C>(sm + S::X, x, m0 + 64 * c, 64 * c, M, threadIdx.x % 128);
  stage_rows<BM, C>(sm + S::DY, dy, m0 + 64 * c, 64 * c, M,
                    threadIdx.x % 128);
  fence_async_smem();
  bar_sync(1 + c, 128);

  const uint32_t x_addr = smem_addr(sm + S::X) + c * 64 * 128;
  const uint32_t dy_addr = smem_addr(sm + S::DY) + c * 64 * 128;
  const uint32_t ring_addr = smem_addr(ring);
  // The warp's staging boxes (1024-byte aligned, so that the swizzle's
  // row bits are the box's)
  unsigned char* hd_box = sm + S::HD + c * S::OUT + warp * S::WARP_OUT;
  unsigned char* dh_box = sm + S::DH + c * S::OUT + warp * S::WARP_OUT;
  float* sums = reinterpret_cast<float*>(sm + S::SUMS) + c * 2 * 4 * FC;
  const long long prow = 2ll * blockIdx.x + c;  // the db1 partial row
  const bool store_rows = m0 + 64 * c < M;
  const int wrow = m0 + 64 * c + 16 * warp;     // the warp's first row

  float dx[128], h[FC / 2], d[FC / 2];
  uint32_t a[FC / 16][4];
#pragma unroll
  for (int i = 0; i < 128; ++i) dx[i] = 0.f;
  // The keep words of chunk f for rows r0 and r1, read a chunk ahead
  uint32_t kw0 = 0u, kw1 = 0u;
  auto read_words = [&](int f, uint32_t& w0, uint32_t& w1) {
    w0 = dropped && r0 < M ? words[r0 * wpr + f] : 0u;
    w1 = dropped && r1 < M ? words[r1 * wpr + f] : 0u;
  };
  read_words(0, kw0, kw1);

  // h and dhd of chunk f
  auto issue_hidden = [&](int f) {
    const uint32_t st = ring_addr + (f % STAGES) * S::STAGE;
#pragma unroll
    for (int i = 0; i < FC / 2; ++i) h[i] = 0.f, d[i] = 0.f;
    fence_regs(h);
    fence_regs(d);
    wgmma_fence();
    if (LIVE) {
      issue_narrow(h, x_addr, st);
      issue_narrow(d, dy_addr, st + S::W_BYTES);
    }
    wgmma_commit();
  };
  // dx += bf16(dh_f) W1_f^T: a[k] holds the chunk's columns 16k..16k+15
  auto issue_dx = [&](int f) {
    const uint32_t w1t = ring_addr + (f % STAGES) * S::STAGE;
#pragma unroll
    for (int k = 0; k < FC / 16; ++k) fence_regs(a[k]);
    fence_regs(dx);
    wgmma_fence();
    if (LIVE) {
#pragma unroll
      for (int k = 0; k < FC / 16; ++k)
        wgmma_rs<C>(dx, a[k], sw128_desc(w1t + k * 2048, S::BOX, 1024));
    }
    wgmma_commit();
  };
  // Chunk f's products are done: its stage goes back to the ring
  auto release = [&](int f) {
    fence_regs(dx);
#pragma unroll
    for (int k = 0; k < FC / 16; ++k) fence_regs(a[k]);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(empty + f % STAGES));
  };
  // The elementwise pass of chunk f on h and d: the A fragments, hd and
  // bf16(dh) staged and stored, db1's partial row
  auto elementwise = [&](int f) {
    const float* sb = reinterpret_cast<const float*>(
        ring + (f % STAGES) * S::STAGE + 2 * S::W_BYTES);
    float2 bias[FC / 8];
#pragma unroll
    for (int j = 0; j < FC / 8; ++j)
      bias[j] = *reinterpret_cast<const float2*>(sb + 8 * j + 2 * t);
    uint32_t w0 = kw0, w1 = kw1;
    if (f + 1 < chunks) read_words(f + 1, kw0, kw1);
    uint32_t hd_pair[FC / 8][2];
    float sum[FC / 8][2];
#pragma unroll
    for (int j = 0; j < FC / 8; ++j) {
      // Register 4j + e: row r0 (e < 2) or r1, column 8j + 2t + e % 2
      const __nv_bfloat162 b = __floats2bfloat162_rn(bias[j].x, bias[j].y);
      const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
      __nv_bfloat162 hp[2] = {
          __hmax2(__hadd2(__floats2bfloat162_rn(h[4 * j], h[4 * j + 1]), b),
                  zero),
          __hmax2(__hadd2(__floats2bfloat162_rn(h[4 * j + 2], h[4 * j + 3]),
                          b),
                  zero)};
      const int bit = 8 * j + 2 * t;
      float dh[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t w = r ? w1 : w0;
        const float2 hv = __bfloat1622float2(hp[r]);
        float v0 = d[4 * j + 2 * r], v1 = d[4 * j + 2 * r + 1];
        uint32_t hd_bits = *reinterpret_cast<uint32_t*>(&hp[r]);
        if (dropped) {
          const bool k0 = (w >> bit) & 1u, k1 = (w >> (bit + 1)) & 1u;
          v0 = k0 ? v0 * scale : 0.f;
          v1 = k1 ? v1 * scale : 0.f;
          __nv_bfloat162 s = __hmul2(hp[r], __floats2bfloat162_rn(sc16, sc16));
          hd_bits = *reinterpret_cast<uint32_t*>(&s) &
                    ((k0 ? 0x0000FFFFu : 0u) | (k1 ? 0xFFFF0000u : 0u));
        }
        dh[2 * r] = hv.x > 0.f ? v0 : 0.f;
        dh[2 * r + 1] = hv.y > 0.f ? v1 : 0.f;
        hd_pair[j][r] = hd_bits;
      }
      a[j / 2][2 * (j % 2)] = pack_bf16(dh[0], dh[1]);
      a[j / 2][2 * (j % 2) + 1] = pack_bf16(dh[2], dh[3]);
      sum[j][0] = dh[0] + dh[2];
      sum[j][1] = dh[1] + dh[3];
    }
    // Column sums over the warp's 16 rows by a butterfly over the 8 lanes
    // of one t: at each step a lane keeps half of its values and adds its
    // partner's sums of them, so that lane g ends with value g, column
    // 8 (g / 2) + 2t + g % 2
    float w4[4], w2[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool up = g & 4;
      const float keep = up ? sum[2 + i / 2][i % 2] : sum[i / 2][i % 2];
      const float give = up ? sum[i / 2][i % 2] : sum[2 + i / 2][i % 2];
      w4[i] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool up = g & 2;
      w2[i] = (up ? w4[i + 2] : w4[i]) +
              __shfl_xor_sync(0xffffffffu, up ? w4[i] : w4[i + 2], 8);
    }
    const float col_sum =
        ((g & 1) ? w2[1] : w2[0]) +
        __shfl_xor_sync(0xffffffffu, (g & 1) ? w2[0] : w2[1], 4);
    // The warp's previous stores have read its staging boxes
    if (lane == 0) bulk_wait_read();
    __syncwarp();
    // 64-byte-swizzled boxes of 16 rows x FC: the 16-byte chunk q of row r
    // at q ^ ((r >> 1) & 3), as TMA's 64-byte swizzle reads it
#pragma unroll
    for (int j = 0; j < FC / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        const int off = row * 64 + ((j ^ ((row >> 1) & 3)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(hd_box + off) = hd_pair[j][r];
        *reinterpret_cast<uint32_t*>(dh_box + off) = a[j / 2][2 * (j % 2) + r];
      }
    fence_async_smem();
    __syncwarp();
    if (lane == 0 && wrow < M) {
      tma_store(&map_hd, f * FC, wrow, hd_box);
      tma_store(&map_dh, f * FC, wrow, dh_box);
      bulk_commit();
    }
    // The four warps' sums of chunk f meet in buffer f % 2, one barrier
    // per parity: a warp cannot pass chunk f + 1's products before warp 0
    // has read chunk f's
    float* buf = sums + (f & 1) * 4 * FC;
    buf[warp * FC + 8 * (g / 2) + 2 * t + g % 2] = col_sum;
    const int bar = 3 + 2 * c + (f & 1);
    if (warp != 0) {
      bar_arrive(bar, 128);
    } else {
      bar_sync(bar, 128);
      if (store_rows)
        db1_partial[prow * F + f * FC + lane] =
            buf[lane] + buf[FC + lane] + buf[2 * FC + lane] +
            buf[3 * FC + lane];
    }
  };

  mbar_wait(smem_addr(full), 0);
  issue_hidden(0);
  wgmma_wait<0>();
  fence_regs(h);
  fence_regs(d);
  // The last chunk is peeled, so that no branch separates chunk f's dx
  // product from chunk f + 1's products and they run side by side
  for (int f = 0; f + 1 < chunks; ++f) {
    const int s1 = (f + 1) % STAGES;
    elementwise(f);
    mbar_wait(smem_addr(full + s1), ((f + 1) / STAGES) & 1);
    issue_dx(f);
    issue_hidden(f + 1);
    wgmma_wait<1>();
    release(f);
    wgmma_wait<0>();
    fence_regs(h);
    fence_regs(d);
    if (threadIdx.x == LOADER && f + STAGES < chunks) {
      mbar_wait(smem_addr(empty + f % STAGES), (f / STAGES) & 1);
      load(f + STAGES);
    }
    __syncwarp();
  }
  elementwise(chunks - 1);
  issue_dx(chunks - 1);
  wgmma_wait<0>();
  release(chunks - 1);

  // dx (+ the residual) from the accumulators: register 4j + e is row r0
  // or r1 (e / 2), column 8j + 2t + e % 2
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = r ? r1 : r0;
      if (row >= M) continue;
      float2 v = make_float2(dx[4 * j + 2 * r], dx[4 * j + 2 * r + 1]);
      if constexpr (RESIDUAL) {
        const float2 res =
            *reinterpret_cast<const float2*>(residual + row * C + col);
        v.x += res.x, v.y += res.y;
        *reinterpret_cast<float2*>(dx32 + row * C + col) = v;
      } else {
        *reinterpret_cast<uint32_t*>(dx16 + row * C + col) =
            pack_bf16(v.x, v.y);
      }
    }
  }
  if (lane == 0) bulk_wait_read();   // the staging outlives its stores
}

template <typename TX, bool RESIDUAL>
int launch(const CUtensorMap& mw1t, const CUtensorMap& mw2,
           const CUtensorMap& mhd, const CUtensorMap& mdh, const void* x,
           const void* dy, const void* b1, const void* words,
           const void* residual, void* dx32, void* dx16, void* partial,
           int M, int F, float scale, cudaStream_t s) {
  auto kernel = ffn_bwd_kernel<TX, RESIDUAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(M + BM - 1) / BM, THREADS, Smem::BYTES, s>>>(
      mw1t, mw2, mhd, mdh, static_cast<const TX*>(x),
      static_cast<const bf16*>(dy), static_cast<const float*>(b1),
      static_cast<const uint32_t*>(words),
      static_cast<const float*>(residual), static_cast<float*>(dx32),
      static_cast<bf16*>(dx16), static_cast<float*>(partial), M, F, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, 256): fp32 (x_is_f32 = 1, rounded to bf16 as staged) with residual
// (M, 256) fp32 and dx32 (M, 256) fp32 = dx + residual; or bf16 with dx16
// (M, 256) bf16 (residual and dx32 null). dy (M, 256) bf16, masked and
// rounded; w1t (F, 256) bf16, W1 transposed; b1 (F) fp32, 16-byte
// aligned; w2 (F, 256) bf16. words (M, F / 32) int32, the hidden's keep
// words from K4's train form, or null for no dropout; scale 1 / (1 -
// rate). hd_out, dh_out (M, F) bf16; db1_partial (ceil(M / 64), F) fp32.
// F % 128 == 0; anything else returns cudaErrorInvalidValue.
extern "C" int ppgs_ffn_train_bwd(
    const void* x, int x_is_f32, const void* dy, const void* w1t,
    const void* b1, const void* w2, const void* words, const void* residual,
    void* dx32, void* dx16, void* hd_out, void* dh_out, void* db1_partial,
    int M, int F, float scale, void* stream) {
  if (F <= 0 || F % 128 || reinterpret_cast<uintptr_t>(b1) % 16 ||
      (x_is_f32 ? !residual || !dx32 : !dx16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap mw1t, mw2, mhd, mdh;
  if (!encode(&mw1t, w1t, false, F, C, C, 64, FC) ||
      !encode(&mw2, w2, false, F, C, C, 64, FC) ||
      !encode(&mhd, hd_out, false, M, F, F, FC, 16,
              CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(&mdh, dh_out, false, M, F, F, FC, 16,
              CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_f32
             ? launch<float, true>(mw1t, mw2, mhd, mdh, x, dy, b1, words,
                                   residual, dx32, nullptr, db1_partial, M,
                                   F, scale, s)
             : launch<bf16, false>(mw1t, mw2, mhd, mdh, x, dy, b1, words,
                                   nullptr, nullptr, dx16, db1_partial, M, F,
                                   scale, s);
}
