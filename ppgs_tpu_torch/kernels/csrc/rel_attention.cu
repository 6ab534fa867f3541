// B8 rel_attention: the conformer's relative-position attention,
// softmax((q_u k^T + shift(bf16(q_v pos^T))) / sqrt(d_k)) v with a key
// mask, the shifted position term made inside the kernel from q_v and pos.
//
// Replaces: ppgs_tpu/ops/flash_attention.py fused_attention_bias (kernel
// _fused_kernel_bias, pallas_call at :373) and the einsum that
// ppgs_tpu/models/conformer.py runs before it to form the term: the TPU
// kernel is handed the zero-column-padded (B, H, T + 1, T) term, since a
// TPU program could not skew it in VMEM. The 16 blocks of the bottleneck
// frontend run it (bf16, T <= 2048).
//
// The function is the TPU kernel's, in its order: the position term is
// each dot product's fp32 sum rounded once to bf16 (as JAX's einsum
// returns it), added to q_u.k in fp32; logits = that sum * sm_scale;
// masked keys -1e30; the row max clamped at -1e29; p = exp(logits - max),
// 0 at masked keys; the denominator clamped at 1e-30; p / denom rounded to
// bf16 BEFORE the PV product. A wholly masked row gives 0. The kernel
// works in log2 units (log2 e folded into the scale) and takes p / denom
// as exp2(z - m - log2(denom)): one ex2.approx a logit a pass.
//
// The shift in closed form (the legacy ESPnet rel_shift; bd[a, c] = q_v[a]
// . pos[c]): shifted element (i, j) of a head is bd[i, T - 1 - i + j]
// where j <= i, 0 where j = i + 1, and bd[i + 1, j - i - 2] where j >= i +
// 2. For the 64 rows of a warpgroup from i0 and the 64 keys of a tile from
// j0, both parts read a band of 127 positions with one skew: row r, key c
// reads band column x = 63 - r + c. The lower part's band starts at
// position T - i0 - 64 + j0 and takes q_v rows i0 ..; the upper part's at
// j0 - i0 - 65, with rows i0 + 1 ... Band columns 0-63 (half A) serve the
// pairs c <= r of the diagonal tile and columns 64-127 (half B) the pairs
// c >= r + 1, so on the diagonal tile (j0 = i0) half A is the lower part's
// and half B the upper part's, whose column 64 is position -1: the zero of
// j = i + 1 comes from TMA's zero fill, as does every position below 0 or
// at T and above, and q_v row T. Tiles before the diagonal take both
// halves from the lower part, tiles after it from the upper part (the
// tile after the diagonal reads position -1 for its one pair j = i + 1).
// No pair needs a select. Half A of key tile t + 1 is half B of tile t
// (the same positions and q_v rows, below), so a tile whose predecessor
// was formed takes its half A from that tile's bf16 words: one m64n64 band
// product a tile beside QK^T.
//
// The heads. d_k = 36 is no multiple of 16 columns or 16 bytes: head h
// starts 72 h bytes into a 288-byte row. The kernel reads every operand in
// place through 64-column TMA boxes (2-D tensor maps over (H d_k, B T)
// through the row strides; k and v are views of the fused QKV product,
// 864-byte rows). A box's first column must lie on 16 bytes (TMA takes no
// other: an illegal instruction on the card), so head h's boxes start at
// column h d_k rounded down to 8, and the head sits at column off = (h d_k)
// mod 8 (0 or 4) of them, off + d_k <= 64; the neighbouring heads' columns,
// or TMA's zeros past column H d_k, come along. Columns 0 .. off - 1 and
// off + d_k .. 16 ceil(d_k / 16) - 1 of the resident q_u and q_v tiles are
// zeroed once, so the streamed K and pos columns outside the head multiply
// zeros, and the products stop at a depth of 16 ceil(d_k / 16) (48 at d_k
// = 36: three k16 steps). PV's extra output columns are dropped: the output
// is written from registers, the pairs of the head's columns, as a
// 64-column TMA box would overwrite the neighbouring heads.
//
// Design, on hopper.cuh: one block per (192 query rows, head, utterance), three
// warpgroups of 64 rows (384 threads, one block an SM; 12 warps keep a thread
// to 168 registers), no producer warp. The resident tiles arrive once by TMA:
// q_u, q_v (rows q0 ..) and q_v from row q0 + 1 (the upper part's rows: a
// one-row offset breaks the 128-byte swizzle's phase, so it is a tile of its
// own). The pos boxes: the warpgroups' bands are 64 positions apart and a band
// moves 64 positions a key tile, so one sequence of 64-row pos boxes serves the
// block: box m is the lower part's (positions T - q0 - 192 + 64 m ..) while m
// <= td0 + 2, td0 = q0 / 64 the first warpgroup's diagonal tile, else the upper
// part's (64 m - q0 - 193 ..); key tile t's half A of warpgroup c is box t + 2
// - c, its half B box t + 3 - c, with the q_v tile of the same part: half A of
// tile t + 1 is half B of tile t. Each box is read by four tiles, so it is
// loaded once a pass: the ring (6 stages of 24 KB) carries, per pass, items u =
// 0 .. tiles + 2, item u pos box u and, from u = 3, key tile u - 3's K (and in
// pass 2 its V). A warp holds four items at once (the boxes of tile t are items
// t .. t + 3) and frees item t after tile t; the last of the 12 warps to free a
// stage refills it, so the ring is walked and freed in order by every warp.
// - Per tile and warpgroup: S = q_u K^T and the half-B band by SS wgmma
//   (m64n64, three k16 steps each), the half-A elements added to S while
//   half B's product runs. Half A's bf16 words are the last tile's half B,
//   kept in registers (16 a thread), or after a tile not formed (the first
//   of a pass, one past a wholly masked tile) a product of their own. A
//   row's band lies in its own quad of lanes, so the skew read (S element
//   (r, c) takes band column 63 - r + c) is one shuffle an element within
//   the quad (Skew below), the registers it reads chosen at compile time
//   per warp; only the groups of 8 columns a row reads are rounded to bf16
//   pairs. No band touches shared memory: a first form that staged it there
//   and read it back skewed spent most of its time on it (PERF.md section
//   6).
// - Pass 1: the row max (from the -1e29 floor) and denominator, online.
//   Pass 2: S and the band again, p / denom packed into the A fragments of
//   O += P V (RS wgmma, V the MN-major B operand); O in registers.
// - The window's mask is read once, as one 64-bit word a key tile; the
//   tiles past its last valid key are not walked, a tile with no valid key
//   is skipped, and a wholly masked window loads nothing and writes zeros.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s) at 64 x 8 s (B = 64, T =
// 800, H = 4, d_k = 36), per launch: QK^T, the position term and PV, 6 B H
// T^2 d_k = 3.54e10 FLOP, 0.0358 ms; q_u, k, v, q_v and out (5 x 14.7 MB),
// pos (0.23 MB) and the mask, 74 MB, 0.022 ms: bound by operations. The
// exponentials, 2 x 1.64e8 a launch at 16 a clock an SM, take about 0.09
// ms, a floor the roofline does not show; the band's bf16 conversions run
// on the same 16-a-clock unit. What holds it back on the card
// (scripts/torch_rel_attention_probe.py builds this source beside a
// loads-only walk and variants less one part of the work; PERF.md section
// 6): each tile's chain of products, waits, the skew and the softmax, which
// three warpgroups an SM overlap only in part; the skew's selects,
// shuffles, extractions and adds cost most (a third of the kernel), then
// pass 2's PV and the band product; the loads-only walk is under half of
// it. Keeping half B for the next tile saves 7% against forming half A
// again (PERF.md section 6).

#include "common.cuh"
#include "hopper.cuh"

using namespace ppgs::hopper;
using ppgs::bf16;

namespace {

constexpr int WGS = 3;                       // warpgroups a block
constexpr int BQ = 64 * WGS, BK = 64;        // query rows a block, keys a tile
constexpr int THREADS = 128 * WGS;
constexpr int WARPS = THREADS / 32;
constexpr int DP = 64;                       // a head's box: 64 bf16, 128 B
constexpr int MAX_T = 2048, MAX_TILES = MAX_T / BK;
constexpr int STAGES = 6;
constexpr bool LIVE = true;                  // false: loads only (the probe)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MAX_FLOOR = -1e29f * LOG2E;  // the row-max clamp, log2 units
constexpr float DENOM_FLOOR = 1e-30f;
constexpr float MINUS_INF = -__builtin_huge_valf();

constexpr int BOX = BK * 128;                // 64 rows of a 128-byte box
constexpr int Q_TILE = BQ * 128;
// A stage: a pos box, the K tile, the V tile (pass 2)
constexpr int ST_POS = 0, ST_K = BOX, ST_V = 2 * BOX, STAGE = 3 * BOX;
constexpr int OFF_QU = 0, OFF_QV = Q_TILE, OFF_QV1 = 2 * Q_TILE;
constexpr int OFF_RING = 3 * Q_TILE;
constexpr int OFF_VALID = OFF_RING + STAGES * STAGE;
constexpr int OFF_BARS = OFF_VALID + MAX_TILES * 8;
constexpr int SMEM = OFF_BARS + (2 * STAGES + 1) * 8 + STAGES * 4 + 1024;
static_assert(OFF_RING % 1024 == 0 && STAGE % 1024 == 0,
              "shared-memory regions must stay aligned");
static_assert(SMEM <= 232448, "more shared memory than a block may have");

// acc (64 x 64 fp32) = 64 rows of a K-major tile at a times 64 rows of a
// K-major box at b, over KS steps of 16 columns (the first overwrites acc)
template <int KS>
__device__ __forceinline__ void product(float (&acc)[BK / 2], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss<BK, 0, 0>(acc, sw128_desc(a + kk * 32, 16, 1024),
                       sw128_desc(b + kk * 32, 16, 1024), kk > 0);
}

// The skew read by shuffles. Row g of warp w (its 64-row band in two
// m64n64 halves: register 4j + e of lane 4g + t holds row 16w + g + 8(e /
// 2), column 64 half + 8j + 2t + e % 2) takes band column 63 - r + c = 8J +
// sigma + 2t + e for key c = 8j + 2t + e, J = 7 - 2w (6 - 2w for row g +
// 8), sigma = 7 - g: element (j, e) lies in group J + j, or J + j + 1 past
// the pair's end, of lane t + (sigma + e) / 2 of the quad, element (sigma +
// e) % 2 of its bf16 pair. One shuffle an element: each lane sends the
// pair its receiver takes (the receiver's choice of group is the sender's
// to make, as the quad shares sigma), the receiver keeps its element.
struct Skew {
  int src[2];          // the lane read, for e = 0, 1
  uint32_t sel[2];     // __byte_perm selector: that element to fp32
  bool next[2];        // as a sender: the receiver's pair is in the next group
  __device__ __forceinline__ explicit Skew(int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 7 - g + e, step = q >> 1;
      src[e] = (lane & ~3) | ((t + step) & 3);
      sel[e] = q & 1 ? 0x3244u : 0x1044u;
      next[e] = q + 2 * ((t - step) & 3) >= 8;
    }
  }
};

// Only the groups of 8 band columns a row reads, J .. J + 8 (J = 7 - 2W -
// rho), are rounded to bf16 pairs (a conversion is as slow as an ex2):
// word g of half A (wa[rho][g], g = J .. 7) and word g - 8 of half B hold
// columns 8g + 2t, 8g + 2t + 1 of the half's row 16W + g + 8 rho, each
// rounded once.

// Half A's words of warp W from its accumulator bd
template <int W>
__device__ __forceinline__ void pack_half_a(uint32_t (&wa)[2][8],
                                            const float (&bd)[BK / 2]) {
#pragma unroll
  for (int rho = 0; rho < 2; ++rho)
#pragma unroll
    for (int g = 7 - 2 * W - rho; g < 8; ++g)
      wa[rho][g] = pack_bf16(bd[4 * g + 2 * rho], bd[4 * g + 2 * rho + 1]);
}

// Add to sc the band elements of warp W whose pair of groups (J + j, J + j
// + 1) lies in half A (PART 0, from the words wa) or reaches half B (PART
// 1, from its accumulator bd, group 7 from wa). PART 1 then leaves in wa
// half B's words of groups J .. 7, the next tile's half A.
template <int W, int PART>
__device__ __forceinline__ void skew_add(float (&sc)[BK / 2],
                                         const float (&bd)[BK / 2],
                                         uint32_t (&wa)[2][8],
                                         const Skew& k) {
#pragma unroll
  for (int rho = 0; rho < 2; ++rho) {
    const int J = 7 - 2 * W - rho;
    uint32_t w[16];
#pragma unroll
    for (int g = J; g <= J + 8; ++g) {
      const int r = 4 * (g & 7) + 2 * rho;
      if (g < 8) w[g] = wa[rho][g];
      else if (PART == 1) w[g] = pack_bf16(bd[r], bd[r + 1]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lo = J + j, hi = lo + 1;
      if ((PART == 0) != (hi <= 7)) continue;
      const uint32_t first = w[lo], second = w[hi];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t got = __shfl_sync(
            0xffffffffu, k.next[e] ? second : first, k.src[e]);
        sc[4 * j + 2 * rho + e] +=
            __uint_as_float(__byte_perm(got, 0, k.sel[e]));
      }
    }
    if (PART == 1) {
      wa[rho][J] = w[J + 8];
#pragma unroll
      for (int g = J + 1; g < 8; ++g)
        wa[rho][g] = pack_bf16(bd[4 * g + 2 * rho], bd[4 * g + 2 * rho + 1]);
    }
  }
}

// warp-uniform switches: the register indices are constants
__device__ __forceinline__ void pack_half_a(int warp, uint32_t (&wa)[2][8],
                                            const float (&bd)[BK / 2]) {
  switch (warp) {
    case 0: pack_half_a<0>(wa, bd); break;
    case 1: pack_half_a<1>(wa, bd); break;
    case 2: pack_half_a<2>(wa, bd); break;
    default: pack_half_a<3>(wa, bd); break;
  }
}

template <int PART>
__device__ __forceinline__ void skew_add(int warp, float (&sc)[BK / 2],
                                         const float (&bd)[BK / 2],
                                         uint32_t (&wa)[2][8],
                                         const Skew& k) {
  switch (warp) {
    case 0: skew_add<0, PART>(sc, bd, wa, k); break;
    case 1: skew_add<1, PART>(sc, bd, wa, k); break;
    case 2: skew_add<2, PART>(sc, bd, wa, k); break;
    default: skew_add<3, PART>(sc, bd, wa, k); break;
  }
}

// KS: the products' k16 steps, ceil(d / 16); the head's columns of a box
// (off + d <= 16 KS) are the first NO of PV's output
template <int KS, int NO = KS == 3 ? 48 : DP>
__global__ void __launch_bounds__(THREADS, 1)
rel_attention_kernel(const __grid_constant__ CUtensorMap map_qu,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_qv,
                     const __grid_constant__ CUtensorMap map_pos,
                     const uint8_t* __restrict__ mask,
                     bf16* __restrict__ out, long long out_rs, int T, int d,
                     float scale2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* tile_valid = reinterpret_cast<uint64_t*>(sm + OFF_VALID);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + OFF_BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;
  int* released = reinterpret_cast<int*>(q_bar + 1);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  // The head's first column, its boxes' (on 16 bytes) and its place there
  const int col0 = h * d, box0 = col0 & ~7, off = col0 - box0;
  // The utterance's first row in the (B T)-row maps. Its rows past T are
  // the next utterance's: the key mask zeroes their p, their q rows give
  // outputs that are not stored, and the upper part reads q_v row T only
  // for keys past T
  const int row0 = b * T;
  const int key_tiles = (T + BK - 1) / BK;
  const int warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint8_t* mrow = mask + static_cast<long long>(b) * T;

  // The window's valid keys, a word a key tile (bit k: key 64 i + k)
  for (int i = warp_id; i < key_tiles; i += WARPS) {
    const int key = i * BK + lane;
    const uint64_t bits =
        __ballot_sync(0xffffffffu, key < T && mrow[key] != 0) |
        static_cast<uint64_t>(
            __ballot_sync(0xffffffffu, key + 32 < T && mrow[key + 32] != 0))
            << 32;
    if (lane == 0) tile_valid[i] = bits;
  }
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    mbar_init_ring(full, empty, STAGES, WARPS);
    for (int i = 0; i < STAGES; ++i) released[i] = 0;
  }
  __syncthreads();
  // The key tiles walked, up to the window's last valid key; twice
  int tiles = 0;
  for (int i = 0; i < key_tiles; ++i)
    if (tile_valid[i]) tiles = i + 1;
  const int td0 = q0 / BK;      // the first warpgroup's diagonal tile

  // Items a pass: pos boxes 0 .. tiles + WGS - 1, and from item WGS on key
  // tile u - WGS
  const int per_pass = tiles > 0 ? tiles + WGS : 0;
  const int items = 2 * per_pass;
  // Item n (item u = n % per_pass of pass n / per_pass) into stage n %
  // STAGES
  auto load = [&](int n) {
    const int s = n % STAGES;
    const bool pass2 = n >= per_pass;
    const int u = pass2 ? n - per_pass : n, tt = u - WGS;
    const uint32_t bar = smem_addr(full + s);
    unsigned char* st = sm + OFF_RING + s * STAGE;
    mbar_expect_tx(bar, (tt < 0 ? 1 : pass2 ? 3 : 2) * BOX);
    const int row = u <= td0 + WGS - 1 ? T - q0 - BQ + BK * u
                                       : BK * u - q0 - BQ - 1;
    tma_load(st + ST_POS, &map_pos, box0, row, bar);
    if (tt >= 0) {
      tma_load(st + ST_K, &map_k, box0, row0 + tt * BK, bar);
      if (pass2) tma_load(st + ST_V, &map_v, box0, row0 + tt * BK, bar);
    }
  };
  if (threadIdx.x == 0 && tiles > 0) {
    const uint32_t qb = smem_addr(q_bar);
    mbar_expect_tx(qb, 3 * Q_TILE);
    tma_load(sm + OFF_QU, &map_qu, box0, row0 + q0, qb);
    tma_load(sm + OFF_QV, &map_qv, box0, row0 + q0, qb);
    tma_load(sm + OFF_QV1, &map_qv, box0, row0 + q0 + 1, qb);
    for (int n = 0; n < STAGES && n < items; ++n) load(n);
  }

  // Warpgroup c owns the block's rows 64c .. 64c + 63; a thread rows r0,
  // r0 + 8 of them (lane = 4g + t)
  const int c = warp_id / 4, warp = warp_id % 4;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = q0 + 64 * c, td = td0 + c;
  const bool wg_live = LIVE && i0 < T;
  const uint32_t qu = smem_addr(sm + OFF_QU) + c * 64 * 128;
  const uint32_t qv = smem_addr(sm + OFF_QV) + c * 64 * 128;
  const uint32_t qv1 = smem_addr(sm + OFF_QV1) + c * 64 * 128;
  const uint32_t ring = smem_addr(sm + OFF_RING);
  const Skew skew(lane);

  if (tiles > 0) {
    mbar_wait(smem_addr(q_bar), 0);
    // Columns 0 .. off - 1 and off + d .. 16 KS - 1 of the warpgroup's rows
    // of the three resident tiles to zero, 4 columns (8 bytes) at a time
    // (16-byte chunk q of row r sits at q ^ (r & 7))
    for (int i = threadIdx.x % 128; i < 3 * 64; i += 128) {
      unsigned char* row =
          sm + (i / 64) * Q_TILE + (64 * c + i % 64) * 128;
      for (int col = 0; col < 16 * KS; col += 4)
        if (col < off || col >= off + d)
          *reinterpret_cast<uint2*>(row + (((col / 8) ^ (i % 8)) << 4) +
                                    (col % 8) * 2) = make_uint2(0u, 0u);
    }
    fence_async_smem();
    bar_sync(1 + c, 128);
  }

  auto stage_of = [&](int n) { return ring + (n % STAGES) * STAGE; };
  auto wait_full = [&](int n) {
    mbar_wait(smem_addr(full + n % STAGES), (n / STAGES) & 1);
  };
  // A warp is done with item n's stage; the last of the warps to free it
  // refills it
  auto release = [&](int n) {
    const int s = n % STAGES;
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(smem_addr(empty + s));
      if (n + STAGES < items &&
          atomicAdd(released + s, 1) % WARPS == WARPS - 1) {
        mbar_wait(smem_addr(empty + s), (n / STAGES) & 1);
        load(n + STAGES);
      }
    }
    __syncwarp();
  };

  // Half A's bf16 words (the last tile's half B) between tiles
  uint32_t wa[2][8];

  // sc = q_u K^T + the shifted position term of key tile tt, whose items
  // start at item n (its pos boxes in items n .. n + WGS, its K and V in
  // item n + WGS), the keys its tile word marks invalid at -inf. The band
  // halves come from the lower part (q_v) before the diagonal, the upper
  // part (q_v from row i0 + 1) after it. Half A's words are in wa if tile
  // tt - 1 was formed (kept), else made here
  auto logits = [&](float (&sc)[BK / 2], int tt, int n, uint64_t valid,
                    bool kept) {
    if (!kept) {
      float bd[BK / 2];
      fence_regs(bd);
      wgmma_fence();
      product<KS>(bd, tt <= td ? qv : qv1,
                  stage_of(n + WGS - 1 - c) + ST_POS);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(bd);
      pack_half_a(warp, wa, bd);
    }
    // Half B's product runs while half A's elements are added
    float bd2[BK / 2];
    fence_regs(sc);
    fence_regs(bd2);
    wgmma_fence();
    product<KS>(sc, qu, stage_of(n + WGS) + ST_K);
    wgmma_commit();
    product<KS>(bd2, tt < td ? qv : qv1, stage_of(n + WGS - c) + ST_POS);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    skew_add<0>(warp, sc, bd2, wa, skew);
    wgmma_wait<0>();
    fence_regs(bd2);
    skew_add<1>(warp, sc, bd2, wa, skew);
    if (valid != ~0ull) {
      const uint64_t bits = valid >> (2 * t);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!((bits >> (8 * j + e % 2)) & 1u)) sc[4 * j + e] = MINUS_INF;
    }
  };

  // Pass 1: the row max m (from the floor) and sum l of exp2(z - m), online
  float m0 = MAX_FLOOR, m1 = MAX_FLOOR, l0 = 0.f, l1 = 0.f;
  int formed = -2;                  // the last key tile formed (half B in wa)
  for (int n = 0; n < WGS && tiles > 0; ++n) wait_full(n);
  for (int tt = 0; tt < tiles; ++tt) {
    const uint64_t valid = tile_valid[tt];
    wait_full(tt + WGS);
    if (wg_live && valid) {
      float sc[BK / 2];
      logits(sc, tt, tt, valid, formed == tt - 1);
      formed = tt;
      release(tt);
      float x0 = MINUS_INF, x1 = MINUS_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      const float n0 = fmaxf(m0, quad_max(x0) * scale2);
      const float n1 = fmaxf(m1, quad_max(x1) * scale2);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        ps0 += exp2_approx(fmaf(sc[4 * j], scale2, -n0)) +
               exp2_approx(fmaf(sc[4 * j + 1], scale2, -n0));
        ps1 += exp2_approx(fmaf(sc[4 * j + 2], scale2, -n1)) +
               exp2_approx(fmaf(sc[4 * j + 3], scale2, -n1));
      }
      l0 = l0 * exp2_approx(m0 - n0) + ps0;
      l1 = l1 * exp2_approx(m1 - n1) + ps1;
      m0 = n0, m1 = n1;
    } else {
      release(tt);
    }
  }
  for (int n = tiles; n < per_pass; ++n) release(n);
  // p / denom = exp2(z - lse), lse = m + log2(max(l, 1e-30))
  const float lse0 = m0 + log2f(fmaxf(quad_sum(l0), DENOM_FLOOR));
  const float lse1 = m1 + log2f(fmaxf(quad_sum(l1), DENOM_FLOOR));

  // Pass 2: O = sum over the keys of bf16(p / denom) v, over the NO
  // columns that hold the head
  float o[NO / 2];
#pragma unroll
  for (int e = 0; e < NO / 2; ++e) o[e] = 0.f;
  const int base = per_pass;
  formed = -2;
  for (int n = base; n < base + WGS && tiles > 0; ++n) wait_full(n);
  for (int tt = 0; tt < tiles; ++tt) {
    const int n = base + tt;
    const uint64_t valid = tile_valid[tt];
    wait_full(n + WGS);
    if (wg_live && valid) {
      float sc[BK / 2];
      logits(sc, tt, n, valid, formed == tt - 1);
      formed = tt;
      // a[k] holds keys 16k .. 16k + 15: groups j = 2k (registers 0, 1)
      // and 2k + 1 (2, 3)
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        a[j / 2][2 * (j % 2)] =
            pack_bf16(exp2_approx(fmaf(sc[4 * j], scale2, -lse0)),
                      exp2_approx(fmaf(sc[4 * j + 1], scale2, -lse0)));
        a[j / 2][2 * (j % 2) + 1] =
            pack_bf16(exp2_approx(fmaf(sc[4 * j + 2], scale2, -lse1)),
                      exp2_approx(fmaf(sc[4 * j + 3], scale2, -lse1)));
      }
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) fence_regs(a[k]);
      fence_regs(o);
      wgmma_fence();
      const uint32_t v_addr = stage_of(n + WGS) + ST_V;
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        wgmma_rs<NO>(o, a[k], sw128_desc(v_addr + k * 2048, BK * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) fence_regs(a[k]);
    }
    release(n);
  }
  for (int n = base + tiles; n < base + per_pass; ++n) release(n);

  // The head's columns of the output (box columns off .. off + d - 1), a
  // pair of bf16 a store, rows below T
  if (i0 < T) {
    const int r0 = i0 + 16 * warp + g, r1 = r0 + 8;
    bf16* out0 = out + (static_cast<long long>(b) * T + r0) * out_rs + box0;
    bf16* out1 = out0 + 8 * out_rs;
#pragma unroll
    for (int j = 0; j < NO / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < off || col >= off + d) continue;
      if (r0 < T)
        *reinterpret_cast<uint32_t*>(out0 + col) =
            pack_bf16(o[4 * j], o[4 * j + 1]);
      if (r1 < T)
        *reinterpret_cast<uint32_t*>(out1 + col) =
            pack_bf16(o[4 * j + 2], o[4 * j + 3]);
    }
  }
}

template <int KS>
int launch(const CUtensorMap* maps, const void* mask, void* out,
           long long out_rs, int B, int T, int H, int d, float scale2,
           cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory a kernel must opt in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      rel_attention_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  rel_attention_kernel<KS><<<grid, THREADS, SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), out_rs, T,
      d, scale2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_u, q_v: bf16 (B, T, H*d) with row strides q_rs, qv_rs, utterances T
// rows apart; k, v: the same with row stride kv_rs (views of one buffer are
// fine); pos: bf16 (T, H*d)
// with row stride pos_rs, shared by the batch; mask: (B, T) bytes, nonzero
// = valid key; out: bf16 (B, T, ...) with row stride out_rs, 4-byte
// aligned pairs. TMA: 16-byte aligned bases, row strides multiples of 8
// elements. scale2 = log2(e) / sqrt(d). d % 4 == 0 and d <= 64, T <= 2048,
// else cudaErrorInvalidValue.
extern "C" int ppgs_rel_attention(const void* q_u, long long q_rs,
                                  const void* k, const void* v,
                                  long long kv_rs, const void* q_v,
                                  long long qv_rs, const void* pos,
                                  long long pos_rs, const void* mask,
                                  void* out, long long out_rs, int B, int T,
                                  int H, int d, float scale2, void* stream) {
  if (d < 4 || d > DP || d % 4 || T > MAX_T)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
  const long long cols = static_cast<long long>(H) * d;
  // 2-D maps over the B T rows (a 3-D map with a dimension of one row read
  // the wrong rows on the card)
  const long long rows = static_cast<long long>(B) * T;
  CUtensorMap maps[5] = {};
  if (!encode(&maps[0], q_u, false, rows, cols, q_rs, DP, BQ) ||
      !encode(&maps[1], k, false, rows, cols, kv_rs, DP, BK) ||
      !encode(&maps[2], v, false, rows, cols, kv_rs, DP, BK) ||
      !encode(&maps[3], q_v, false, rows, cols, qv_rs, DP, BQ) ||
      !encode(&maps[4], pos, false, T, cols, pos_rs, DP, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1:
      return launch<1>(maps, mask, out, out_rs, B, T, H, d, scale2, s);
    case 2:
      return launch<2>(maps, mask, out, out_rs, B, T, H, d, scale2, s);
    case 3:
      return launch<3>(maps, mask, out, out_rs, B, T, H, d, scale2, s);
    default:
      return launch<4>(maps, mask, out, out_rs, B, T, H, d, scale2, s);
  }
}
