// The FFN's training backward up to its input at any C % 128 == 0 from
// 128 to 2048 (C = 256 the mel model, 512 the w2v2fb and w2v2fc heads, each
// with a form of its own; every other C on one route with C known at run
// time), any F % 128 == 0, any M; the forward is K4 (ffn_ln.cu) with its
// dropout sites on.
//
// Replaces: the backward of ppgs_tpu/ops/fused_ffn.py ffn_train
// (_ffn_train_bwd_kernel) and the FFN half of the backward of
// ppgs_tpu/ops/encoder_layer_train.py (_bwd_kernel after LN2).
//
// What it computes, with the TPU kernels' rounding points: dy (M, C)
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
// weight gradients to the GEMMs. At C = 512 (the w2v2fb head, the same M
// and F) the products are 6 M 512 F = 825 GFLOP, 0.834 ms, against 2.08
// GB, 0.62 ms: bound by the operations.
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
// C = 512 (the w2v2fb and w2v2fc heads) takes three launches. In one,
// dx's sum (64 x 512 fp32 a 64-row block: every register of two
// warpgroups) and x and dy (128 KB) left room for one 65 KB weight stage,
// so each chunk's loads waited for the previous chunk's products, and both
// warpgroups issued h and dhd: 4.60 ms on an H100, 1.73x its library
// route. Without dx, a block holds 128 rows, and h and dhd need not share
// one: so the hidden passes split them.
// - The hd pass (hidden_kernel<TX, 0>) computes h = x W1_f, hp =
//   relu(bf16(bf16(h) + bf16(b1))), hd (the keep words' bits) and a mask,
//   bit set where hp > 0 and kept; the dh pass (hidden_kernel<bf16, 1>)
//   computes dhd = dy W2_f^T, dh from it and the mask, bf16(dh) and db1's
//   partial rows. The mask crosses between them through a scratch of M F
//   / 32 words in the accumulators' own layout (a word a thread a row tile
//   and chunk), 34 MB each way at the training shape.
// - A pass: 128 rows a block, x or dy resident (128 KB, rounded to bf16 as
//   staged), F in chunks of HC = 64 hidden columns. The two consumer
//   warpgroups take the chunks in turn, each over all 128 rows (two m64n64
//   accumulators, 64 registers), so that one's elementwise pass runs beside
//   the other's products; each has a ring of 8 KB slices (64 hidden rows x
//   64 depth columns of W1^T or W2; 4 a ring on the hd side, 3 on the dh
//   side, as shared memory allows) filled by a producer warp of its own
//   (320 threads). Each product is issued once: 2 M 512 F MACs a pass.
//   hd and bf16(dh) leave by TMA stores from 128-byte-swizzled boxes of 16
//   rows (two a warp, 32 KB); db1's partial rows come from the C = 256
//   form's butterfly, one level deeper, and the four warps' sums added in
//   order, so they equal the one-launch form's bit for bit, as hd, dh and
//   dx do (the same k16 steps in the same order).
// - The dx pass (dx_kernel) computes dx = bf16(dh) W1^T from the dh the dh
//   pass wrote (+ the fp32 residual, or rounded to bf16): 128 x 256 tiles,
//   depth F in 64-deep stages of 48 KB, 4 of them, a producer warpgroup and
//   two consumer warpgroups (gemm.cu's form).
// Bound (the training shape): the dx pass reads dh again (+0.54 GB) and
// the mask crosses (+0.07 GB), 2.69 GB in all (0.80 ms), against the same
// 825 GFLOP (0.834 ms): still bound by the operations. Measured on an H100
// (scripts/torch_ffn_bwd_probe.py, PERF.md section 6): the hd pass 0.80
// ms, the dh pass 0.69, the dx pass 0.51 (fp32 x, dropout 0.1); their
// loads-only walks 0.54, 0.42 and 0.51. ptxas: 168 registers (hd pass, dx
// pass; 204 allowed), 128 (dh pass), no spills. Measured no faster: the
// products split by warpgroup inside one 64-row pass (h by one, dhd by the
// other, the mask handed over; 3.43 ms: each slice's ring protocol cost
// as much as its four products); 8 KB slices refilled by the consumers'
// last warp (1.35-1.83 ms a pass); a 2-block cluster sharing each slice
// by TMA multicast (+5%: the L2 stream does not set the pace); the outputs
// stored from registers to give the rings the staging's 32 KB (+30%); the
// dx pass in 128 x 128 tiles two blocks an SM (+25%) or with its residual
// prefetched into L2 (+35%); the blocks walking the chunks from chunk b %
// (F / 64) on, so as not to read the same slices at once (no faster).
//
// Every other C (128, 384, 640, 768, ..., 2048) takes three launches too,
// on one route with C passed at run time, right first and not yet tuned.
// A resident 128-row tile of x or dy is 192 KB at C = 768, which leaves
// no room for the C = 512 passes' rings (and at 384 already x and dy no
// longer fit beside the C = 256 form's ring), so the two hidden passes are
// plain tiled products with their elementwise work as epilogues, on the
// (A, B) TMA ring of residual_ln.cuh that K4's hidden launch uses: 128 x
// 256 tiles of the (M, F) hidden (128 x 128 where F % 256 != 0), a
// producer warpgroup and two consumer warpgroups of 64 rows, depth C in
// 64-deep stages (an fp32 x rounded to bf16 as its fragments are read,
// the RS form), B MN-major: W1 as stored and W2^T, (C, F) both.
// - The hd pass (wide_pass_kernel<..., 0>): h = x W1, hp =
//   relu(bf16(bf16(h) + bf16(b1))), hd from the keep words.
// - The dh pass (wide_pass_kernel<..., 1>): dhd = dy W2^T, and dh from it
//   and the mask, which it reads from the hd just written: hd > 0 exactly
//   where hp > 0 and the unit is kept (hd = bf16(hp * s), s =
//   bf16(1 / (1 - rate)) >= 1, so no positive hp rounds to 0), so no mask
//   crosses between the passes; bf16(dh) stored and db1's partial rows
//   (each warp's 16 rows summed by shuffles, the 4 warps' sums added in
//   order through shared memory).
// - The dx pass: dx_kernel with C at run time, ceil(C / 256) tiles a row
//   block, the last one 128 columns wide where C % 256 == 128 (its W1^T
//   boxes past C not loaded, its columns past C not stored).
// The depth C streams through the ring in C / 64 steps, so no C up to
// 2048 is too wide for it; the loops' trip counts are read at run time, as
// the C = 768 instances' were by their producers and consumers.
// Bound (the training shape, M = 131,072, F = 2048): 6 M C F, 1.25 ms at
// C = 768 (1.24 TFLOP), 0.625 ms at 384 and 1.668 ms at 1024; bytes: x
// (fp32), dy, the residual, the words and the weights in; hd written and
// read back, dh written and read back, dx and the partials out, 3.8 GB at
// 768, 1.1 ms: bound by the operations.

#include "common.cuh"
#include "hopper.cuh"
#include "residual_ln.cuh"

using ppgs::bf16;
using namespace ppgs::hopper;

namespace {

constexpr int FC = 32;
constexpr int THREADS = 256;            // two consumer warpgroups
constexpr int LOADER = 128;             // the thread that refills the ring
constexpr int DXC = 256;                // dx columns a warpgroup sums
// Computes the function; false gives a loads-only walk that streams every
// stage, stages x and dy and writes the outputs but multiplies nothing
// (scripts/torch_ffn_bwd_probe.py times it)
constexpr bool LIVE = true;

template <int C>
struct Smem {
  static constexpr int BM = 128;                   // a block's rows
  static constexpr int STAGES = 2;
  static constexpr int TILE = BM * C * 2;          // x or dy: C / 64 atoms
  static constexpr int BOX = FC * 128;             // 32 rows x 64 columns
  static constexpr int W_BYTES = FC * C * 2;       // C / 64 boxes
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
template <int C>
__device__ __forceinline__ void issue_narrow(float (&acc)[FC / 2],
                                             uint32_t a, uint32_t b) {
  using S = Smem<C>;
#pragma unroll
  for (int k = 0; k < C / 16; ++k)
    wgmma_ss<FC, 0, 0>(
        acc,
        sw128_desc(a + (k / 4) * (S::BM * 128) + (k % 4) * 32, 16, 1024),
        sw128_desc(b + (k / 4) * S::BOX + (k % 4) * 32, 16, 1024));
}

template <int C, typename TX, bool RESIDUAL>
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
  using S = Smem<C>;
  constexpr int BM = S::BM, STAGES = S::STAGES;
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
  const int row_off = 64 * c;                   // the warpgroup's rows
  const long long r0 = m0 + row_off + wr, r1 = r0 + 8;
  const bool dropped = words != nullptr;
  const float sc16 = ppgs::round_bf16(scale);

  // The warpgroup's rows of x and dy, for the async proxy to read
  stage_rows<BM, C>(sm + S::X, x, m0 + 64 * c, 64 * c, M, threadIdx.x % 128);
  stage_rows<BM, C>(sm + S::DY, dy, m0 + 64 * c, 64 * c, M,
                    threadIdx.x % 128);
  fence_async_smem();
  bar_sync(1 + c, 128);

  const uint32_t x_addr = smem_addr(sm + S::X) + row_off * 128;
  const uint32_t dy_addr = smem_addr(sm + S::DY) + row_off * 128;
  const uint32_t ring_addr = smem_addr(ring);
  // The warp's staging boxes (1024-byte aligned, so that the swizzle's
  // row bits are the box's)
  unsigned char* hd_box = sm + S::HD + c * S::OUT + warp * S::WARP_OUT;
  unsigned char* dh_box = sm + S::DH + c * S::OUT + warp * S::WARP_OUT;
  float* sums = reinterpret_cast<float*>(sm + S::SUMS) + c * 2 * 4 * FC;
  // the db1 partial row (one a 64 rows)
  const long long prow = 2ll * blockIdx.x + c;
  const bool store_rows = m0 + row_off < M;
  const int wrow = m0 + row_off + 16 * warp;    // the warp's first row

  float dx[DXC / 2], h[FC / 2], d[FC / 2];
  uint32_t a[FC / 16][4];
#pragma unroll
  for (int i = 0; i < DXC / 2; ++i) dx[i] = 0.f;
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
      issue_narrow<C>(h, x_addr, st);
      issue_narrow<C>(d, dy_addr, st + S::W_BYTES);
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
        wgmma_rs<DXC>(dx, a[k], sw128_desc(w1t + k * 2048, S::BOX, 1024));
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
  for (int j = 0; j < DXC / 8; ++j) {
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

// ----------------------------------------------------------- C = 512

constexpr int WC = 512;          // the width
constexpr int HC = 64;           // hidden columns a chunk
constexpr int KS = WC / 64;      // depth slices of a chunk's product
constexpr int SLICE = HC * 128;  // 64 hidden rows x 64 depth columns
constexpr int HTHREADS = 320;    // two consumer warpgroups, two producers

// A hidden pass's shared memory: its resident tile (x or dy, 128 rows),
// a ring of STAGES slices a warpgroup (as many as fit), a warp's two
// staging boxes of 16 rows x 128 bytes, and (the dh side) each
// warpgroup's column sums by warp
template <int SIDE>
struct Wide {
  static constexpr int STAGES = SIDE == 0 ? 4 : 3;
  static constexpr int TILE = 128 * WC * 2;        // 8 atoms of 128 rows
  static constexpr int RING = TILE;                // [2][STAGES]
  static constexpr int OUT = RING + 2 * STAGES * SLICE;   // [8][2] boxes
  static constexpr int SUMS = OUT + 8 * 2 * 2048;  // [2][2][2][4][HC]
  static constexpr int BARS = SUMS + (SIDE == 1 ? 2 * 2 * 2 * 4 * HC * 4 : 0);
  static constexpr int BYTES = BARS + 2 * 2 * STAGES * 8 + 1024;
  static_assert(BYTES <= 232448, "more shared memory than a block may have");
  static_assert(RING % 1024 == 0 && OUT % 1024 == 0,
                "tiles must keep their swizzle atoms aligned");
};

// A hidden pass at C = 512: 128 rows a block, F in chunks of HC, the
// chunks taken in turn by the two consumer warpgroups (warpgroup c chunks
// c, c + 2, ..., over all 128 rows, so that one warpgroup's elementwise
// pass runs beside the other's products), each fed
// by a ring of its own that a producer warp of its own fills. SIDE 0
// computes h = x W1_f and writes hd and the mask (two words a thread a
// chunk: bit 4j + e of word u for its register 4j + e of row tile u, hp
// > 0 and kept); SIDE 1 computes dhd = dy W2_f^T and, with the mask,
// writes bf16(dh) and db1's partial rows
template <typename TX, int SIDE>
__global__ void __launch_bounds__(HTHREADS, 1)
hidden_kernel(const __grid_constant__ CUtensorMap map_w,
              const __grid_constant__ CUtensorMap map_out,
              const TX* __restrict__ a, const float* __restrict__ b1,
              const uint32_t* __restrict__ words,
              uint32_t* __restrict__ mask, float* __restrict__ db1_partial,
              int M, int F, float scale) {
  using S = Wide<SIDE>;
  constexpr int WSTAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Warpgroup c (0, 1) or, for warps 8 and 9, the warpgroup it feeds
  const int c = warp_id < 8 ? warp_id / 4 : warp_id - 8;
  unsigned char* ring = sm + S::RING + c * WSTAGES * SLICE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::BARS) +
                   c * 2 * WSTAGES;
  uint64_t* empty = full + WSTAGES;
  const int m0 = blockIdx.x * 128;
  const int chunks = F / HC;

  if (threadIdx.x == 0)
    for (int r = 0; r < 2; ++r)
      mbar_init_ring(full + r * 2 * WSTAGES, empty + r * 2 * WSTAGES,
                     WSTAGES, 4);
  if (warp_id < 8) {
    // The warpgroup's 64 rows of x or dy, for the async proxy to read
    stage_rows<128, WC>(sm, a, m0 + 64 * c, 64 * c, M, threadIdx.x % 128);
    fence_async_smem();
  }
  __syncthreads();

  if (warp_id >= 8) {
    // Producer: the ring's slices in the order its warpgroup walks them
    if (lane != 0) return;
    int n = 0;
    for (int f = c; f < chunks; f += 2)
      for (int k = 0; k < KS; ++k, ++n) {
        const int s = n % WSTAGES, round = n / WSTAGES;
        if (round > 0) mbar_wait(smem_addr(empty + s), (round - 1) & 1);
        const uint32_t bar = smem_addr(full + s);
        mbar_expect_tx(bar, SLICE);
        tma_load(ring + s * SLICE, &map_w, k * 64, f * HC, bar);
      }
    return;
  }

  const int warp = warp_id % 4, g = lane >> 2, t = lane & 3;
  const uint32_t a_addr = smem_addr(sm);
  const uint32_t ring_addr = smem_addr(ring);
  // Row tile u (0, 1): the block's rows 64u..; the thread's rows in it
  const long long r0 = m0 + 16 * warp + g;
  unsigned char* boxes = sm + S::OUT + warp_id * 4096;   // two a warp
  const bool dropped = words != nullptr;
  // The thread's two mask words of chunk f
  auto mask_words = [&](int f) {
    return reinterpret_cast<uint2*>(mask) +
           (static_cast<long long>(blockIdx.x) * chunks + f) * 128 +
           threadIdx.x % 128;
  };

  // acc[u] (row tile u's 64 rows x HC) = its resident rows times chunk
  // f's 64 rows of W1^T or W2, both K-major, over depth 512; n counts the
  // ring's slices
  float acc[2][HC / 2];
  int n = 0;
  auto product = [&]() {
    zero(acc[0]);
    zero(acc[1]);
#pragma unroll 1
    for (int k = 0; k < KS; ++k, ++n) {
      const int s = n % WSTAGES;
      mbar_wait(smem_addr(full + s), (n / WSTAGES) & 1);
      const uint32_t b = ring_addr + s * SLICE;
      wgmma_fence();
      if (LIVE) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            wgmma_ss<HC, 0, 0>(
                acc[u],
                sw128_desc(a_addr + k * 16384 + u * 8192 + kk * 32, 16,
                           1024),
                sw128_desc(b + kk * 32, 16, 1024));
      }
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_addr(empty + (n - 1) % WSTAGES));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(empty + (n - 1) % WSTAGES));
  };
  // Stage the warp's 16 rows x HC of row tile u, register pair p[j][r]
  // (row g + 8r, columns 8j + 2t..), in its 128-byte-swizzled box and
  // store it at column f * HC (the box's store of two chunks before has
  // read it: bulk_wait_read before the first)
  auto store = [&](uint32_t (&p)[HC / 8][2], int u, int f) {
    unsigned char* box = boxes + u * 2048;
#pragma unroll
    for (int j = 0; j < HC / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        *reinterpret_cast<uint32_t*>(box + row * 128 +
                                     ((j ^ (row & 7)) << 4) + 4 * t) =
            p[j][r];
      }
    fence_async_smem();
    __syncwarp();
    const int wrow = m0 + 64 * u + 16 * warp;
    if (lane == 0 && wrow < M) {
      tma_store(&map_out, f * HC, wrow, box);
      bulk_commit();
    }
  };

  if constexpr (SIDE == 0) {
    // hp, hd and the mask; the keep words read a chunk ahead
    const float sc16 = ppgs::round_bf16(scale);
    const int wpr = F / 32;                     // keep words a row
    uint2 kw[2][2] = {};                        // [row tile][r]
    auto read_words = [&](int f) {
      if (!dropped) return;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = r0 + 64 * u + 8 * r;
          kw[u][r] = row < M ? *reinterpret_cast<const uint2*>(
                                   words + row * wpr + 2 * f)
                             : make_uint2(0u, 0u);
        }
    };
    if (c < chunks) read_words(c);
#pragma unroll 1
    for (int f = c; f < chunks; f += 2) {
      product();
      uint2 w[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) w[u][0] = kw[u][0], w[u][1] = kw[u][1];
      if (f + 2 < chunks) read_words(f + 2);
      if (lane == 0) bulk_wait_read();
      __syncwarp();
      __nv_bfloat162 bias[HC / 8];
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        const float2 v = __ldg(
            reinterpret_cast<const float2*>(b1 + f * HC + 8 * j + 2 * t));
        bias[j] = __floats2bfloat162_rn(v.x, v.y);
      }
      uint32_t bits[2] = {0u, 0u};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t hd_pair[HC / 8][2];
#pragma unroll
        for (int j = 0; j < HC / 8; ++j) {
          const __nv_bfloat162 b = bias[j];
          const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
          const int bit = 8 * (j % 4) + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const __nv_bfloat162 hp = __hmax2(
                __hadd2(__floats2bfloat162_rn(acc[u][4 * j + 2 * r],
                                              acc[u][4 * j + 2 * r + 1]),
                        b),
                zero2);
            const float2 hv = __bfloat1622float2(hp);
            uint32_t hd_bits = *reinterpret_cast<const uint32_t*>(&hp);
            bool k0 = true, k1 = true;
            if (dropped) {
              const uint32_t wd = j < 4 ? w[u][r].x : w[u][r].y;
              k0 = (wd >> bit) & 1u;
              k1 = (wd >> (bit + 1)) & 1u;
              __nv_bfloat162 s =
                  __hmul2(hp, __floats2bfloat162_rn(sc16, sc16));
              hd_bits = *reinterpret_cast<uint32_t*>(&s) &
                        ((k0 ? 0x0000FFFFu : 0u) | (k1 ? 0xFFFF0000u : 0u));
            }
            hd_pair[j][r] = hd_bits;
            bits[u] |= static_cast<uint32_t>(k0 && hv.x > 0.f)
                       << (4 * j + 2 * r);
            bits[u] |= static_cast<uint32_t>(k1 && hv.y > 0.f)
                       << (4 * j + 2 * r + 1);
          }
        }
        store(hd_pair, u, f);
      }
      *mask_words(f) = make_uint2(bits[0], bits[1]);
    }
  } else {
    // dh from dhd and the mask, bf16(dh) stored, db1's partial rows of the
    // block's two 64-row tiles; the mask words read a chunk ahead
    float* sums = reinterpret_cast<float*>(sm + S::SUMS) + c * 4 * 4 * HC;
    uint2 next = c < chunks ? *mask_words(c) : make_uint2(0u, 0u);
#pragma unroll 1
    for (int f = c; f < chunks; f += 2) {
      product();
      float* buf = sums + ((f / 2) & 1) * 2 * 4 * HC;   // by turn parity
      const uint32_t bits[2] = {next.x, next.y};
      if (f + 2 < chunks) next = *mask_words(f + 2);
      if (lane == 0) bulk_wait_read();
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t dh_pair[HC / 8][2];
        float sum[HC / 8][2];
#pragma unroll
        for (int j = 0; j < HC / 8; ++j) {
          float dh[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v =
                dropped ? acc[u][4 * j + e] * scale : acc[u][4 * j + e];
            dh[e] = (bits[u] >> (4 * j + e)) & 1u ? v : 0.f;
          }
          dh_pair[j][0] = pack_bf16(dh[0], dh[1]);
          dh_pair[j][1] = pack_bf16(dh[2], dh[3]);
          sum[j][0] = dh[0] + dh[2];
          sum[j][1] = dh[1] + dh[3];
        }
        store(dh_pair, u, f);
        // Column sums over the warp's 16 rows by a butterfly over the 8
        // lanes of one t (the C = 256 form's, one level deeper): lane g
        // ends with columns 8g + 2t and 8g + 2t + 1, that is 2 lane and 2
        // lane + 1
        float w4[4][2], w2[2][2], w1[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool up = g & 4;
            w4[i][e] = (up ? sum[4 + i][e] : sum[i][e]) +
                       __shfl_xor_sync(0xffffffffu,
                                       up ? sum[i][e] : sum[4 + i][e], 16);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool up = g & 2;
            w2[i][e] = (up ? w4[2 + i][e] : w4[i][e]) +
                       __shfl_xor_sync(0xffffffffu,
                                       up ? w4[i][e] : w4[2 + i][e], 8);
          }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool up = g & 1;
          w1[e] = (up ? w2[1][e] : w2[0][e]) +
                  __shfl_xor_sync(0xffffffffu, up ? w2[0][e] : w2[1][e], 4);
        }
        *reinterpret_cast<float2*>(buf + (u * 4 + warp) * HC + 2 * lane) =
            make_float2(w1[0], w1[1]);
      }
      // The four warps' sums meet in the buffer of the turn's parity, one
      // barrier a parity; warp 0 adds them in order and writes the two
      // partial rows (a warp cannot pass the warpgroup's next products
      // before warp 0 has read these)
      const int bar = 1 + 2 * c + ((f / 2) & 1);
      if (warp != 0) {
        bar_arrive(bar, 128);
      } else {
        bar_sync(bar, 128);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* tile = buf + u * 4 * HC;
          float2 total = *reinterpret_cast<const float2*>(tile + 2 * lane);
#pragma unroll
          for (int w = 1; w < 4; ++w) {
            const float2 p =
                *reinterpret_cast<const float2*>(tile + w * HC + 2 * lane);
            total.x += p.x, total.y += p.y;
          }
          if (m0 + 64 * u < M)
            *reinterpret_cast<float2*>(
                db1_partial + (2ll * blockIdx.x + u) * F + f * HC +
                2 * lane) = total;
        }
      }
    }
  }
  if (lane == 0) bulk_wait_read();   // the staging outlives its stores
}

// Pass 2 at C = 512 and pass 3 on the run-time route: dx = bf16(dh) W1^T
// (+ the residual, or rounded to bf16), 128 x 256 tiles over depth F,
// gemm.cu's warp-specialised form. WIDTH: C known to the compiler (512),
// or 0 for C passed at run time (ldc); NARROW: the instance whose last
// block's tile has 128 columns (C % 256 == 128), which loads two of its
// four W1^T boxes and stores its first 128 columns (the wgmma still runs
// 256 wide: its other columns are never stored)
constexpr int DX_BM = 128, DX_BN = 256, DX_STAGES = 4;
constexpr int DX_A = DX_BM * 128;               // 128 rows x 64 depth
constexpr int DX_B = 64 * DX_BN * 2;            // 64 depth rows x 256
constexpr int DX_STAGE = DX_A + DX_B;
constexpr int DX_SMEM = DX_STAGES * DX_STAGE + 2 * DX_STAGES * 8 + 1024;
static_assert(DX_SMEM <= 232448, "more shared memory than a block may have");

template <int WIDTH, bool RESIDUAL, bool NARROW = false>
__global__ void __launch_bounds__(384, 1)
dx_kernel(const __grid_constant__ CUtensorMap map_dh,
          const __grid_constant__ CUtensorMap map_w1t,
          const float* __restrict__ residual, float* __restrict__ dx32,
          bf16* __restrict__ dx16, int M, int F, int ldc) {
  const int C = WIDTH ? WIDTH : ldc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DX_STAGES * DX_STAGE);
  uint64_t* empty = full + DX_STAGES;
  const int n0 = blockIdx.x * DX_BN, m0 = blockIdx.y * DX_BM;
  const int steps = F / 64, wg = threadIdx.x / 128;
  // the tile's 64-column boxes inside C (4, or 2 in a last narrow tile)
  const int boxes = NARROW ? min(C - n0, DX_BN) / 64 : DX_BN / 64;

  if (threadIdx.x == 0) mbar_init_ring(full, empty, DX_STAGES, 8);
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 0) return;
    for (int i = 0; i < steps; ++i) {
      const int s = i % DX_STAGES, round = i / DX_STAGES;
      if (round > 0) mbar_wait(smem_addr(empty + s), (round - 1) & 1);
      const uint32_t bar = smem_addr(full + s);
      mbar_expect_tx(bar, NARROW ? DX_A + boxes * 8192 : DX_STAGE);
      unsigned char* sa = ring + s * DX_STAGE;
      tma_load(sa, &map_dh, i * 64, m0, bar);          // K-major rows
#pragma unroll
      for (int j = 0; j < DX_BN / 64; ++j)              // MN-major boxes
        if (!NARROW || j < boxes)
          tma_load(sa + DX_A + j * 8192, &map_w1t, n0 + j * 64, i * 64,
                   bar);
    }
    return;
  }

  // Consumers: warpgroup c = wg - 1 owns rows 64c..64c+63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[DX_BN / 2];
#pragma unroll
  for (int i = 0; i < DX_BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % DX_STAGES;
    mbar_wait(smem_addr(full + s), (i / DX_STAGES) & 1);
    const uint32_t a_addr = smem_addr(ring + s * DX_STAGE);
    const uint32_t b_addr = a_addr + DX_A;
    fence_regs(acc);
    wgmma_fence();
    if (LIVE) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<DX_BN, 0, 1>(
            acc, sw128_desc(a_addr + c * 64 * 128 + kk * 32, 16, 1024),
            sw128_desc(b_addr + kk * 2048, 8192, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();    // the previous step's products are done
    fence_regs(acc);
    if (i > 0 && lane == 0)
      mbar_arrive(smem_addr(empty + (i - 1) % DX_STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Register 4j + e: row g + 8 (e / 2) of the warp's 16, column 8j + 2t +
  // e % 2 of the tile
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = m0 + 64 * c + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < DX_BN / 8; ++j) {
    if (NARROW && j >= 8 * boxes) continue;     // past C
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = row0 + 8 * r;
      if (row >= M) continue;
      float2 v = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
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
}

template <typename TX, bool RESIDUAL>
int launch_wide(const void* x, const void* dy, const void* w1t,
                const void* b1, const void* w2, const void* words,
                const void* residual, void* dx32, void* dx16, void* hd_out,
                void* dh_out, void* db1_partial, void* mask, int M, int F,
                float scale, cudaStream_t s) {
  CUtensorMap mw1t, mw2, mhd, mdh, mdh_in, mw1t_mn;
  if (!encode(&mw1t, w1t, false, F, WC, WC, 64, HC) ||
      !encode(&mw2, w2, false, F, WC, WC, 64, HC) ||
      !encode(&mhd, hd_out, false, M, F, F, HC, 16) ||
      !encode(&mdh, dh_out, false, M, F, F, HC, 16) ||
      !encode(&mdh_in, dh_out, false, M, F, F, 64, DX_BM) ||
      !encode(&mw1t_mn, w1t, false, F, WC, WC, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto hd_pass = hidden_kernel<TX, 0>;
  auto dh_pass = hidden_kernel<bf16, 1>;
  auto dx_pass = dx_kernel<WC, RESIDUAL>;
  static const cudaError_t attr[3] = {
      cudaFuncSetAttribute(hd_pass,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Wide<0>::BYTES),
      cudaFuncSetAttribute(dh_pass,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Wide<1>::BYTES),
      cudaFuncSetAttribute(dx_pass,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DX_SMEM)};
  for (const cudaError_t err : attr)
    if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + 127) / 128;
  const uint32_t* w = static_cast<const uint32_t*>(words);
  uint32_t* bits = static_cast<uint32_t*>(mask);
  const float* bias = static_cast<const float*>(b1);
  float* partial = static_cast<float*>(db1_partial);
  hd_pass<<<blocks, HTHREADS, Wide<0>::BYTES, s>>>(
      mw1t, mhd, static_cast<const TX*>(x), bias, w, bits, partial, M, F,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dh_pass<<<blocks, HTHREADS, Wide<1>::BYTES, s>>>(
      mw2, mdh, static_cast<const bf16*>(dy), bias, w, bits, partial, M, F,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dx_pass<<<dim3(WC / DX_BN, (M + DX_BM - 1) / DX_BM), 384, DX_SMEM, s>>>(
      mdh_in, mw1t_mn, static_cast<const float*>(residual),
      static_cast<float*>(dx32), static_cast<bf16*>(dx16), M, F, WC);
  return static_cast<int>(cudaGetLastError());
}

template <int C, typename TX, bool RESIDUAL>
int launch(const CUtensorMap& mw1t, const CUtensorMap& mw2,
           const CUtensorMap& mhd, const CUtensorMap& mdh, const void* x,
           const void* dy, const void* b1, const void* words,
           const void* residual, void* dx32, void* dx16, void* partial,
           int M, int F, float scale, cudaStream_t s) {
  using S = Smem<C>;
  auto kernel = ffn_bwd_kernel<C, TX, RESIDUAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(M + S::BM - 1) / S::BM, THREADS, S::BYTES, s>>>(
      mw1t, mw2, mhd, mdh, static_cast<const TX*>(x),
      static_cast<const bf16*>(dy), static_cast<const float*>(b1),
      static_cast<const uint32_t*>(words),
      static_cast<const float*>(residual), static_cast<float*>(dx32),
      static_cast<bf16*>(dx16), static_cast<float*>(partial), M, F, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_width(const void* x, int x_is_f32, const void* dy,
                 const void* w1t, const void* b1, const void* w2,
                 const void* words, const void* residual, void* dx32,
                 void* dx16, void* hd_out, void* dh_out, void* db1_partial,
                 int M, int F, float scale, cudaStream_t s) {
  CUtensorMap mw1t, mw2, mhd, mdh;
  if (!encode(&mw1t, w1t, false, F, C, C, 64, FC) ||
      !encode(&mw2, w2, false, F, C, C, 64, FC) ||
      !encode(&mhd, hd_out, false, M, F, F, FC, 16,
              CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(&mdh, dh_out, false, M, F, F, FC, 16,
              CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  return x_is_f32
             ? launch<C, float, true>(mw1t, mw2, mhd, mdh, x, dy, b1, words,
                                      residual, dx32, nullptr, db1_partial,
                                      M, F, scale, s)
             : launch<C, bf16, false>(mw1t, mw2, mhd, mdh, x, dy, b1, words,
                                      nullptr, nullptr, dx16, db1_partial, M,
                                      F, scale, s);
}


// ------------------------------------------- every other C, at run time

namespace rl = ppgs::residual_ln;

constexpr int PASS_THREADS = 384;   // a producer warpgroup, two consumers

// A hidden pass's shared memory: the ring of rl::Ring (its LayerNorm row
// sums unused) and, for the dh side, each warpgroup's column sums by warp
template <bool X_F32, int BN, int SIDE>
struct Pass {
  using R = rl::Ring<X_F32, BN>;
  static constexpr int SUMS = SIDE == 1 ? 2 * 4 * BN * 4 : 0;
  static constexpr int SMEM = R::SMEM + SUMS;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// One hidden pass on a 128 x BN tile of the (M, F) hidden: acc = A B over
// depth C (A = x for SIDE 0, dy for SIDE 1; B = W1 or W2^T, (C, F)
// MN-major), then SIDE 0 writes hd (keep words `words`, null at
// rate 0) and SIDE 1 writes bf16(dh) from hd (`hd_in`) and db1's partial
// rows. Register 4j + e of acc: row g + 8 (e / 2) of the warp's 16, column
// 8j + 2t + e % 2 of the tile.
template <int BN, bool X_F32, int SIDE>
__global__ void __launch_bounds__(PASS_THREADS, 1)
wide_pass_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const float* __restrict__ b1,
                 const uint32_t* __restrict__ words,
                 const bf16* __restrict__ hd_in, bf16* __restrict__ out,
                 float* __restrict__ db1_partial, int M, int F, int C,
                 int dropped, float scale) {
  using R = rl::Ring<X_F32, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = rl::aligned_ring(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  float* sums = reinterpret_cast<float*>(empty + R::STAGES);  // [2][4][BN]
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * rl::BM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) mbar_init_ring(full, empty, R::STAGES, 8);
  __syncthreads();
  if (wg == 0) {
    if (threadIdx.x == 0)
      rl::produce<X_F32, BN>(&map_a, &map_b, ring, full, empty, C / rl::BK,
                             m0, n0);
    return;
  }
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[BN / 2];
  rl::consume<X_F32, BN>(acc, ring, full, empty, C / rl::BK, c, warp, lane);
  const int g = lane >> 2, t = lane & 3;
  const long long r0 = m0 + 64 * c + 16 * warp + g, r1 = r0 + 8;

  if constexpr (SIDE == 0) {
    // hd = keep ? bf16(hp * bf16(scale)) : 0, hp in bf16x2 as the C = 512
    // hd pass computes it; a keep word covers 4 groups (32 columns)
    const int wpr = F / 32;
    const float sc16 = ppgs::round_bf16(scale);
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += 4) {
      const int word = (n0 + 8 * j0) / 32;
      const uint32_t kw[2] = {
          words && r0 < M ? words[r0 * wpr + word] : ~0u,
          words && r1 < M ? words[r1 * wpr + word] : ~0u};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + i, col = n0 + 8 * j + 2 * t, bit = 8 * i + 2 * t;
        const float2 bias = *reinterpret_cast<const float2*>(b1 + col);
        const __nv_bfloat162 b = __floats2bfloat162_rn(bias.x, bias.y);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = r ? r1 : r0;
          __nv_bfloat162 hp = __hmax2(
              __hadd2(__floats2bfloat162_rn(acc[4 * j + 2 * r],
                                            acc[4 * j + 2 * r + 1]),
                      b),
              zero);
          uint32_t bits = *reinterpret_cast<const uint32_t*>(&hp);
          if (words) {
            const bool k0 = (kw[r] >> bit) & 1u;
            const bool k1 = (kw[r] >> (bit + 1)) & 1u;
            const __nv_bfloat162 sv =
                __hmul2(hp, __floats2bfloat162_rn(sc16, sc16));
            bits = *reinterpret_cast<const uint32_t*>(&sv) &
                   ((k0 ? 0x0000FFFFu : 0u) | (k1 ? 0xFFFF0000u : 0u));
          }
          if (row < M)
            *reinterpret_cast<uint32_t*>(out + row * F + col) = bits;
        }
      }
    }
  } else {
    // dh = hd > 0 ? (dropped ? dhd / (1 - rate) : dhd) : 0, bf16(dh)
    // stored; its column sums over the warp's 16 rows by a butterfly of
    // shuffles (every lane ends with the sum), written by the lanes of g =
    // 0 into the warp's row of `sums`
    float* wsums = sums + (c * 4 + warp) * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      float dh[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = r ? r1 : r0;
        const uint32_t hbits =
            row < M ? *reinterpret_cast<const uint32_t*>(hd_in + row * F + col)
                    : 0u;
        const float2 hv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hbits));
        float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
        if (dropped) v0 *= scale, v1 *= scale;
        dh[2 * r] = hv.x > 0.f ? v0 : 0.f;
        dh[2 * r + 1] = hv.y > 0.f ? v1 : 0.f;
        if (row < M)
          *reinterpret_cast<uint32_t*>(out + row * F + col) =
              pack_bf16(dh[2 * r], dh[2 * r + 1]);
      }
      float s0 = dh[0] + dh[2], s1 = dh[1] + dh[3];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (g == 0)
        *reinterpret_cast<float2*>(wsums + 8 * j + 2 * t) =
            make_float2(s0, s1);
    }
    // The warpgroup's four warps meet; each thread adds their sums of its
    // columns in warp order and writes the 64-row block's partial row
    bar_sync(1 + c, 128);
    const float* wg_sums = sums + c * 4 * BN;
    const long long prow = 2ll * blockIdx.y + c;
    if (m0 + 64 * c < M) {
      for (int col = threadIdx.x % 128; col < BN; col += 128)
        db1_partial[prow * F + n0 + col] =
            wg_sums[col] + wg_sums[BN + col] + wg_sums[2 * BN + col] +
            wg_sums[3 * BN + col];
    }
  }
}

template <int BN, bool X_F32, int SIDE>
int launch_pass(const CUtensorMap& ma, const CUtensorMap& mb, const void* b1,
                const void* words, const void* hd_in, void* out,
                void* partial, int M, int F, int C, int dropped, float scale,
                cudaStream_t s) {
  return rl::launch(wide_pass_kernel<BN, X_F32, SIDE>, PASS_THREADS,
                    Pass<X_F32, BN, SIDE>::SMEM,
                    dim3(F / BN, (M + rl::BM - 1) / rl::BM), 1, s, ma, mb,
                    static_cast<const float*>(b1),
                    static_cast<const uint32_t*>(words),
                    static_cast<const bf16*>(hd_in), static_cast<bf16*>(out),
                    static_cast<float*>(partial), M, F, C, dropped, scale);
}

template <bool X_F32>
int launch_any(const void* x, const void* dy, const void* w1t,
               const void* b1, const void* w1, const void* w2t,
               const void* words, const void* residual, void* dx32,
               void* dx16, void* hd_out, void* dh_out, void* db1_partial,
               int M, int F, int C, float scale, cudaStream_t s) {
  CUtensorMap mx, mdy, mw1, mw2t, mdh_in, mw1t_mn;
  if (!encode(&mx, x, X_F32, M, C, C, X_F32 ? 32 : 64, rl::BM) ||
      !encode(&mdy, dy, false, M, C, C, 64, rl::BM) ||
      !encode(&mw1, w1, false, C, F, F, 64, rl::BK) ||
      !encode(&mw2t, w2t, false, C, F, F, 64, rl::BK) ||
      !encode(&mdh_in, dh_out, false, M, F, F, 64, DX_BM) ||
      !encode(&mw1t_mn, w1t, false, F, C, C, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dropped = words != nullptr;
  const bool wide = F % 256 == 0;
  int err = wide ? launch_pass<256, X_F32, 0>(mx, mw1, b1, words, nullptr,
                                              hd_out, nullptr, M, F, C,
                                              dropped, scale, s)
                 : launch_pass<128, X_F32, 0>(mx, mw1, b1, words, nullptr,
                                              hd_out, nullptr, M, F, C,
                                              dropped, scale, s);
  if (err) return err;
  err = wide ? launch_pass<256, false, 1>(mdy, mw2t, b1, nullptr, hd_out,
                                          dh_out, db1_partial, M, F, C,
                                          dropped, scale, s)
             : launch_pass<128, false, 1>(mdy, mw2t, b1, nullptr, hd_out,
                                          dh_out, db1_partial, M, F, C,
                                          dropped, scale, s);
  if (err) return err;
  return rl::launch(C % DX_BN ? dx_kernel<0, X_F32, true>
                              : dx_kernel<0, X_F32>,
                    384, DX_SMEM,
                    dim3((C + DX_BN - 1) / DX_BN, (M + DX_BM - 1) / DX_BM), 1,
                    s, mdh_in, mw1t_mn, static_cast<const float*>(residual),
                    static_cast<float*>(dx32), static_cast<bf16*>(dx16), M, F,
                    C);
}

}  // namespace

// x (M, C), C % 128 == 0 and 128 <= C <= 2048: one launch at 256, three
// at the others. fp32 (x_is_f32 = 1, rounded to bf16 as staged) with
// residual (M, C) fp32 and dx32 (M, C) fp32 = dx + residual; or bf16 with
// dx16 (M, C) bf16 (residual and dx32 null). dy (M, C) bf16, masked and
// rounded; w1t (F, C) bf16, W1 transposed; b1 (F) fp32, 16-byte aligned;
// w2 (F, C) bf16; w1 and w2t (C, F) bf16, W1 as stored and W2 transposed,
// at every C but 256 and 512 (null, unused, at those). words (M, F /
// 32) int32, the hidden's keep words from K4's train form, or null for no
// dropout; scale 1 / (1 - rate). hd_out, dh_out (M, F) bf16; db1_partial
// (ceil(M / 64), F) fp32. mask: at C = 512 the hidden passes' scratch,
// ceil(M / 128) x F / 64 x 256 uint32 words; unused at the others. F %
// 128 == 0; anything else returns cudaErrorInvalidValue.
extern "C" int ppgs_ffn_train_bwd(
    const void* x, int x_is_f32, const void* dy, const void* w1t,
    const void* b1, const void* w2, const void* w1, const void* w2t,
    const void* words, const void* residual, void* dx32, void* dx16,
    void* hd_out, void* dh_out, void* db1_partial, void* mask, int M, int F,
    int C, float scale, void* stream) {
  const bool any = C != 256 && C != 512;     // the run-time route
  if (F <= 0 || F % 128 || C % 128 || C < 128 || C > rl::MAX_C ||
      (C == 512 && !mask) ||
      (any && (!w1 || !w2t || (M + rl::BM - 1) / rl::BM > 65535)) ||
      reinterpret_cast<uintptr_t>(b1) % 16 ||
      (x_is_f32 ? !residual || !dx32 : !dx16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any)
    return x_is_f32 ? launch_any<true>(x, dy, w1t, b1, w1, w2t, words,
                                       residual, dx32, nullptr, hd_out,
                                       dh_out, db1_partial, M, F, C, scale, s)
                    : launch_any<false>(x, dy, w1t, b1, w1, w2t, words,
                                        nullptr, nullptr, dx16, hd_out,
                                        dh_out, db1_partial, M, F, C, scale,
                                        s);
  if (C == 512)
    return x_is_f32 ? launch_wide<float, true>(x, dy, w1t, b1, w2, words,
                                               residual, dx32, nullptr, hd_out,
                                               dh_out, db1_partial, mask, M,
                                               F, scale, s)
                    : launch_wide<bf16, false>(x, dy, w1t, b1, w2, words,
                                               nullptr, nullptr, dx16, hd_out,
                                               dh_out, db1_partial, mask, M,
                                               F, scale, s);
  return launch_width<256>(x, x_is_f32, dy, w1t, b1, w2, words, residual,
                           dx32, dx16, hd_out, dh_out, db1_partial, M, F,
                           scale, s);
}
