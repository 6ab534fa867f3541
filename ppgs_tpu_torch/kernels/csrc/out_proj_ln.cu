// K3 out_proj_residual_ln: out = LN1(x + drop(a @ Wo + bo)) at any C % 128
// == 0 from 128 to 2048 (one kernel, C passed at run time), in its
// inference form and its train form (dropout, the normalised rows and
// 1/std).
//
// Replaces: the per-head output projection and the first LayerNorm inside
// ppgs_tpu/ops/encoder_layer_kernel.py _layer_body
// (`acc += dot(oh, wo[sl])`; `r = _ln(x32 + acc + bo, g1, be1)`), run per
// layer by encoder_stack (C = 256 mel and the bottleneck head, C = 512 the
// w2v2fb head) and encoder_stack_streamed (C = 768, the wav2vec2 trunk);
// and, with the keep_sa dropout site on, the same step of
// ppgs_tpu/ops/encoder_layer_train.py _fwd_compute (`od = keep_sa ? o1 /
// (1 - rate) : 0`, `r = LN1(x + od)`), where it also saves the normalised
// rows and 1/std for the backward.
//
// Rounding follows the TPU kernel: the attention output a is bf16 (the
// TPU rounds each head's output to the compute dtype before its product),
// the product accumulates in fp32, the fp32 residual is added without
// rounding, and the LayerNorm statistics are fp32 (two-pass). The dropout
// mask is philox.cuh's stream keyed by (seed, site, row * C + col).
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16), counting bf16 a, fp32 x
// in and fp32 out once: the mel shape (M = 64,000, C = 256) 164 MB, 0.049
// ms; the w2v2fb head (64,000, 512) 328 MB, 0.098 ms; the wav2vec2 trunk
// (25,600, 768) 197 MB, 0.059 ms; the training shape (131,072, 256) with
// the normalised rows and 1/std 0.47 GB, 0.140 ms; wav2vec2-large's trunk
// (25,600, 1024) 262 MB, 0.078 ms. Every width up to 2048 is bound by
// bytes: fp32 x in and out are ~80% of them, and the products' depth is
// only C / 64 steps of 64 (2 M C^2 operations, 0.03 ms at the base trunk's
// shape, 0.11 ms at (25,600, 2048) against its 0.16 ms of bytes).
//
// Design (wgmma + TMA on the blocks of hopper.cuh and residual_ln.cuh,
// which K4's output launch shares): a block's two consumer warpgroups
// compute 128 rows x 256 columns of the product, 64 rows each, their
// m64n256 fp32 sums in registers (128 a thread), and apply the LayerNorm
// to them in the epilogue; the ceil(C / 256) blocks that hold a row's
// columns are one thread-block cluster and trade each row's partial sums
// through distributed shared memory (layer_norm_rows). Where C % 256 ==
// 128 (384, 640, ...) the last block's tile is 128 columns wide in the
// same 256-column layout: it loads two of its four Wo boxes and four of
// its eight x boxes, its other 128 accumulators are kept at 0 and out of
// the sums (residual_ln.cuh), and it stores four boxes. Such widths take
// an instance of their own, with the epilogue compiled twice (the 256-
// and the 128-column copy), and their train form a third, whose 128-column
// copy has the dropout and the saved rows too: a second copy slowed the
// first by 18% (scripts/torch_layer_width_probe.py), so C % 256 == 0 keeps
// the instance that has one, and inference the narrow copy without the
// train form's work. Eight ranks, the
// portable cluster's most, cap C at 2048. The products are a few
// microseconds a tile; the time goes to moving x in and out (and n) out,
// fp32, and to the epilogue, which the products cannot hide. So:
// - x comes by TMA, the tile's 128 rows x 256 columns (128 KB, eight
//   128-byte-swizzled boxes of 32 columns) into shared memory, asked for
//   with the tile's first stages and arriving while the products run; the
//   epilogue reads it from there (conflict-free: a quad's 8 rows hit 8
//   different 16-byte chunks). Read by each thread from global memory
//   once the products are done, as K4's output launch reads its residual,
//   it came a few loads a thread at a time;
// - out (and, in the train form, the normalised rows first) leave by TMA
//   stores from the same boxes, written in place of x once it has been
//   read: register stores stalled the warps for as long as the memory
//   took to drain them;
// - that leaves 96 KB for the ring: two stages of a's 128 x 64 and Wo's
//   64 x 256 (MN-major as stored), filled by TMA from one consumer thread
//   (the LOADER), which refills each stage as soon as both warpgroups have
//   released it; no producer warp, so that a thread keeps 255 registers
//   (a 9th warp would cap it at 168) and every thread meets the cluster's
//   barriers; each cluster walks the depth from its own step on;
// - a cluster takes one tile. One block an SM: the blocks on an SM take
//   turns, a block's TMA stores draining before the next one starts, and
//   that is what holds K3 back. Forms that measured no better (PERF.md):
//   x prefetched to L2 and read by thread loads; a persistent grid; two
//   blocks an SM of 64-row tiles; Wo's stages shared by a pair of tiles'
//   blocks and a's by a tile's C / 256 blocks, by TMA multicast.
// Rows past M: TMA fills a's and x's with zeros, and no row >= M is
// written. A wait on a barrier that lasts seconds traps (a launch error)
// rather than hanging the card.

#include <type_traits>

#include "residual_ln.cuh"

using ppgs::bf16;
using namespace ppgs::hopper;
using namespace ppgs::residual_ln;

namespace {

constexpr int THREADS = 256;          // two consumer warpgroups
constexpr int LOADER = 0;             // the thread that fills the ring
constexpr bool LIVE = true;           // false: a loads-only walk (a probe's)
constexpr bool LAYER_NORM = true;     // false: no LayerNorm, nothing written
constexpr bool STORE = true;          // false: out staged, not stored
using R = Ring<false, OUT_BN, 2 * (BM + OUT_BN) * BK * 2>;
constexpr int STAGES = R::STAGES;     // 2 of 48 KB
constexpr int X_BOX = BM * 128;       // 32 fp32 columns of the tile's rows
constexpr int X_BYTES = OUT_BN / 32 * X_BOX;            // 128 KB
// x, the ring, its barriers and x's, the row sums, alignment slack
constexpr int SMEM = X_BYTES + STAGES * R::STAGE + (2 * STAGES + 1) * 8 +
                     2 * BM * 4 + 1024;
static_assert(SMEM <= 232448, "more shared memory than a block may have");

// The instances by the last block's tile: C % 256 == 0 (WIDE), or 128
// columns with the epilogue copied for them, without the train form's
// dropout and saved rows (NARROW) or with them (NARROW_TRAIN)
enum Tiles { WIDE = 0, NARROW = 1, NARROW_TRAIN = 2 };

template <int TILES>
__global__ void __launch_bounds__(THREADS, 1)
out_proj_ln_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_out,
                   const __grid_constant__ CUtensorMap map_n,
                   const float* __restrict__ bias,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ rstd,
                   int M, int C, bool stats, ppgs::Dropout drop) {
  const int ranks = ln_ranks(C), steps = C / BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs = aligned_ring(smem_raw);
  unsigned char* ring = xs + X_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * R::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* x_full = empty + STAGES;
  float* sums = reinterpret_cast<float*>(x_full + 1);       // [2][BM]
  const int rank =
      ranks > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int n0 = rank * OUT_BN;
  // the block's 8-column groups inside C, and its boxes of Wo (64 columns)
  // and of x and out (32)
  const int groups = ln_groups(C, n0), w_boxes = groups / 8;
  const int x_boxes = groups / 4;
  const int tile = blockIdx.x / ranks, m0 = tile * BM;   // the cluster's
  // Each cluster walks the depth from its own step on, so that the card's
  // blocks do not all read one Wo box at once
  const int rot = tile % steps;
  const int c = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = lane >> 2, t = lane & 3;
  const int lr0 = 64 * c + 16 * warp + q;       // the tile's rows
  const long long r0 = static_cast<long long>(m0) + lr0;
  const bool loader = threadIdx.x == LOADER;

  if (loader) {
    mbar_init(x_full, 1);
    mbar_init_ring(full, empty, STAGES, 8);
  }
  __syncthreads();

  // The loader's side of the ring: issue_to(n) loads the steps before n
  int ld = 0;
  const auto issue_to = [&](int n) {
    for (; ld < n; ++ld) {
      const int s = ld % STAGES, k = (ld + rot) % steps;
      if (ld >= STAGES)
        mbar_wait(smem_addr(empty + s), (ld / STAGES - 1) & 1);
      const uint32_t bar = smem_addr(full + s);
      mbar_expect_tx(bar, R::A_BYTES + w_boxes * BOX_BYTES);
      unsigned char* sa = ring + s * R::STAGE;
      tma_load(sa, &map_a, k * BK, m0, bar);
#pragma unroll
      for (int j = 0; j < OUT_BN / 64; ++j)
        if (j < w_boxes)
          tma_load(sa + R::A_BYTES + j * BOX_BYTES, &map_w, n0 + j * 64,
                   k * BK, bar);
    }
  };
  // Once step i - 1's stage is free, its next load can go
  const auto refill = [&](int i) {
    if (loader) issue_to(min(i + STAGES, steps));
    __syncwarp();
  };
  refill(0);
  if (loader) {           // x, behind the first stages
    const uint32_t bar = smem_addr(x_full);
    mbar_expect_tx(bar, x_boxes * X_BOX);
#pragma unroll
    for (int j = 0; j < OUT_BN / 32; ++j)
      if (j < x_boxes) tma_load(xs + j * X_BOX, &map_x, n0 + 32 * j, m0, bar);
  }
  __syncwarp();

  float acc[OUT_BN / 2];
  if constexpr (LIVE) {
    consume<false, OUT_BN, R>(acc, ring, full, empty, steps, c, warp, lane,
                              refill);
  } else {
    // The same stream of a, Wo and x, and nothing multiplied or written
    for (int it = 0; it < steps; ++it) {
      mbar_wait(smem_addr(full + it % STAGES), (it / STAGES) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(empty + it % STAGES));
      refill(it + 1);
    }
#pragma unroll
    for (int e = 0; e < OUT_BN / 2; ++e) acc[e] = 0.f;
  }

  // A thread's values of 8-column group j, rows lr0 and lr0 + 8, in x's
  // boxes: box j / 4, 16-byte chunk 2 (j % 4) + t / 2 of the row, swizzled
  // by the row's low bits (q for both rows)
  unsigned char* x_row = xs + lr0 * 128 + 8 * (t & 1);
  const auto at = [&](int j) {
    return reinterpret_cast<float2*>(x_row + (j / 4) * X_BOX +
                                     (((2 * (j % 4) + (t >> 1)) ^ q) << 4));
  };
  const auto res = [&](int j) {
    const float2 x0 = at(j)[0], x1 = at(j)[8 * 128 / sizeof(float2)];
    return make_float4(x0.x, x0.y, x1.x, x1.y);
  };
  mbar_wait(smem_addr(x_full), 0);
  // The epilogue, for a block of `groups` 8-column groups: 32, or 16 in a
  // last tile of 128 columns. Each block takes the copy of its width, so
  // that the count is a constant in each (the residual reads then batch as
  // they did at the fixed widths); the NARROW instance's 128-column copy
  // is compiled without the dropout and the saved rows, NARROW_TRAIN's
  // with them
  const auto epilogue = [&](auto width, const ppgs::Dropout& dropped,
                            bool save_rows) {
    constexpr int G = decltype(width)::value;
    const auto residual = [&](float& s0, float& s1) {
      residual_sums(acc, res, bias, C, n0, r0, r0 + 8, t, 0, dropped, s0,
                    s1, G);
    };
    if constexpr (!LIVE || !LAYER_NORM) {
      float s0, s1;
      residual(s0, s1);
      if (s0 == 1e30f) sums[0] = s1;    // keeps the reads
      return;
    }
    float inv0, inv1;
    layer_norm_rows(acc, true, sums, C, lr0, t, residual,
                    [&](float v0, float v1) { inv0 = v0, inv1 = v1; }, G);
    if (rstd && rank == 0 && t == 0) {
      if (r0 < M) rstd[r0] = inv0;
      if (r0 + 8 < M) rstd[r0 + 8] = inv1;
    }
    // The normalised rows (the train form), then out, written over x's
    // boxes and stored from there by TMA, which writes no row past M (nor
    // the boxes past C)
    const auto store = [&](const CUtensorMap* map, bool affine) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float2 v0 = make_float2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        float2 v1 = make_float2(acc[4 * j + 2] * inv1,
                                acc[4 * j + 3] * inv1);
        if (affine) {
          const int col = n0 + 8 * j + 2 * t;
          const float2 gm = *reinterpret_cast<const float2*>(gamma + col);
          const float2 bt = *reinterpret_cast<const float2*>(beta + col);
          v0 = make_float2(v0.x * gm.x + bt.x, v0.y * gm.y + bt.y);
          v1 = make_float2(v1.x * gm.x + bt.x, v1.y * gm.y + bt.y);
        }
        at(j)[0] = v0;
        at(j)[8 * 128 / sizeof(float2)] = v1;
      }
      fence_async_smem();       // the writes, for the TMA store to read
      __syncthreads();
      if (loader && STORE) {
#pragma unroll
        for (int j = 0; j < G / 4; ++j)
          tma_store(map, n0 + 32 * j, m0, xs + j * X_BOX);
        bulk_commit();
        bulk_wait_read();       // before the boxes are written or freed
      }
    };
    if (save_rows) {
      store(&map_n, false);
      __syncthreads();          // before out overwrites the boxes
    }
    store(&map_out, true);
    // No block leaves while a peer reads its sums
    if (ranks > 1) cg::this_cluster().sync();
  };
  if (TILES == WIDE || groups == OUT_BN / 8)
    epilogue(std::integral_constant<int, OUT_BN / 8>{}, drop, stats);
  else if constexpr (TILES == NARROW_TRAIN)
    epilogue(std::integral_constant<int, OUT_BN / 16>{}, drop, stats);
  else
    epilogue(std::integral_constant<int, OUT_BN / 16>{}, ppgs::Dropout{},
             false);
}

int launch_width(const void* a, const void* w, const void* bias,
                 const void* x, const void* gamma, const void* beta,
                 void* out, void* n_out, void* rstd, int M, int C,
                 int clusters, bool train, ppgs::Dropout drop,
                 cudaStream_t s) {
  // x, out and n in boxes of 32 fp32 columns of a tile's rows
  CUtensorMap map_a, map_w, map_x, map_out, map_n;
  if (!encode(&map_a, a, false, M, C, C, 64, BM) ||
      !encode(&map_w, w, false, C, C, C, 64, BK) ||
      !encode(&map_x, x, true, M, C, C, 32, BM) ||
      !encode(&map_out, out, true, M, C, C, 32, BM) ||
      (n_out && !encode(&map_n, n_out, true, M, C, C, 32, BM)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!n_out) map_n = map_out;        // not read
  const auto kernel = C % OUT_BN == 0 ? out_proj_ln_kernel<WIDE>
                      : train          ? out_proj_ln_kernel<NARROW_TRAIN>
                                       : out_proj_ln_kernel<NARROW>;
  return launch(kernel, THREADS, SMEM,
                dim3(clusters * ln_ranks(C)), ln_ranks(C), s, map_a, map_w,
                map_x, map_out, map_n, static_cast<const float*>(bias),
                static_cast<const float*>(gamma),
                static_cast<const float*>(beta), static_cast<float*>(rstd), M,
                C, n_out != nullptr, drop);
}

}  // namespace

// a (M, C) bf16, w (C, C) bf16, bias/gamma/beta (C) fp32, x (M, C) fp32 ->
// out (M, C) fp32, and n_out (M, C) and rstd (M) fp32 unless null; every
// array but rstd 16-byte aligned; C % 128 == 0, 128 <= C <= 2048, in
// both forms (the train form: n_out, rstd or the dropout on);
// `clusters`, the grid's clusters of ceil(C / 256) blocks, one a 128-row
// tile (the wrapper's plan). The dropout site (threshold 0: off) drops a @
// w + bias. Anything else returns cudaErrorInvalidValue (the Python
// wrapper checks the same before it launches).
extern "C" int ppgs_out_proj_ln(const void* a, const void* w, const void* bias,
                                const void* x, const void* gamma,
                                const void* beta, void* out, void* n_out,
                                void* rstd, int M, int C, int clusters,
                                unsigned seed_lo, unsigned seed_hi,
                                unsigned site, unsigned threshold, float scale,
                                void* stream) {
  const void* arrays[] = {a, w, bias, x, gamma, beta, out, n_out};
  bool aligned = true;
  for (const void* p : arrays)
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const bool train = n_out || rstd || threshold;
  if (C % 128 || C < 128 || C > MAX_C || M < 0 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  if (clusters != (M + BM - 1) / BM)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const ppgs::Dropout drop =
      ppgs::make_dropout(seed_lo, seed_hi, site, threshold, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_width(a, w, bias, x, gamma, beta, out, n_out, rstd, M, C,
                      clusters, train, drop, s);
}
