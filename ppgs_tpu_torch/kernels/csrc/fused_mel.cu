// B9 fused_mel: log-mel spectrogram in one kernel, bf16 DFT and mel
// products on wgmma with fp32 sums, the (frames, 513) spectrum kept on chip.
//
// Replaces: ppgs_tpu/ops/stft.py _fused_log_mel (kernel _fused_mel_kernel),
// the mel frontend's opt-in (PPGS_TPU_FUSED_MEL=1 with a bf16 config).
//
// The function is the TPU kernel's: each frame's window of samples rounded
// to bf16, times the Hann-windowed cos and -sin bases in bf16 (fp32 sums);
// mag = sqrt(re^2 + im^2 + 1e-6) in fp32; mag rounded to bf16 times the
// transposed mel basis in bf16 (fp32 sums); log(max(mel, 1e-5)). Output
// (B, 80, T) fp32.
//
// Reading frames. The TPU copies each frame's window out of the
// hop-blocked stream (a host-side im2col) to get one contiguous
// contraction. Here a block owns FB = 128 frames of one utterance (64 when
// their stretch would not fit, hop >= 396), and their windows are one
// contiguous stretch of the blocked stream, (FB - 1) hop + 1024 samples
// (21,344 at hop 160: 43 KB in bf16, where 128 expanded windows would take
// 256 KB). The consumer threads load the stretch once, rounding it to
// bf16, into shared memory as rows of hop samples padded to a pitch of 8
// mod 16 samples (160 -> 168), so that the 8 frames of an ldmatrix (one
// row apart) fall in 8 different 16-byte bank groups. Window sample k of
// frame f is at row f + k / hop, column k % hop, and each warp builds
// wgmma's m64k16 A fragments of its 16 frames from there: one ldmatrix.x4
// a k-step where hop % 8 == 0 (an 8-sample segment never crosses a row),
// four 32-bit loads where hop % 8 == 4 (a bf16 pair never does). The
// products take A from registers (wgmma RS).
//
// The bases. _fused_mel_weights (ops/stft.py) lays the cos and -sin bases
// out as one (1024, 1152) bf16 array, re and im interleaved by 8 columns,
// and the mel basis as (80, 576) (K-major for the mel product). The 513
// frequencies (zero-padded to 576: 12% more products than 513 need) are
// walked in 9 chunks of 64; a chunk's 1024 x 128 basis columns stream
// through a 4-stage TMA ring of 64 x 128 (16 KB) stages that a producer
// warp keeps full, and the chunk's 64 x 80 mel basis (10 KB) through a
// 2-slot ring of its own. With the interleave, the accumulator registers a
// thread holds for columns 8j + 2t (+1) and 8(j + 1) + 2t (+1) are re and
// im of the same frequencies, so the magnitude is computed in registers,
// and the bf16 magnitudes of 16 frequencies sit exactly in the m64k16 A
// fragment's layout: the mel product is a second RS wgmma (m64n80k16,
// B K-major) with no shared-memory round trip.
//
// The sums. The tensor cores' own additions drop low bits: one chain of
// the 64 k-steps of a chunk moved 0.13% of the log-mels by more than 1e-4
// from the plain version (fp32 sums), which fp32 adds move 0.035% from
// exact ones (PERF.md). So the products of FOLD = 4 stages (256 samples)
// are summed on the tensor cores and then added to the chunk's re/im sums
// by fp32 adds (0.045% then). Those sums take the registers the mel sums
// had: at FB = 128 the 40 mel sums a thread wait in shared memory between
// chunks (40 KB), at FB = 64 they stay in registers.
//
// Two consumer warpgroups: at FB = 128 each owns 64 frames and the whole
// chunk (m64n128 re/im sums, 64 registers, and 64 more for the chunk's
// fp32 sums); at FB = 64 both take the same frames, each half the chunk's
// frequencies (m64n64), and their mel sums are added in a fixed order at
// the end (warpgroup 0's plus warpgroup 1's). Each stage's products are
// waited for before the next stage's fragments are loaded: the other
// warpgroup's keep the tensor cores busy meanwhile. The epilogue takes
// log(max(mel, 1e-5)), stages the (80, FB) block in the ring's shared
// memory and writes it along T with coalesced stores, none past T; frames
// past T read zeros, never past the utterance's rows.
//
// Bound on an H100 at 64 x 8 s (T = 800 frames, M = 51,200): the DFT,
// 2 x 2 x M x 1024 x 513 = 1.08e11 FLOP, and the mel product, 2 x M x 513 x
// 80 = 4.2e9, take 0.113 ms at 989 TFLOP/s; the bytes (the fp32 blocked
// audio, 33 MB, the bases, the output, 16 MB) 0.015 ms: bound by
// operations. What the design reads from L2 is the bases, 2.45 MB a block,
// 1.1 GB a call at 448 blocks (one an SM: 3.4 waves); a walk that loads
// everything and multiplies nothing takes ~60% of the kernel's time
// (PERF.md has the measured walks).
// A wait on a barrier that lasts seconds traps (a launch error) rather
// than hanging the card.

#include "hopper.cuh"

using namespace ppgs::hopper;

namespace {

constexpr int K = 1024;                // window samples read (n_fft)
constexpr int MELS = 80;
constexpr int F_PAD = 576;             // 513 frequencies, zero-padded
constexpr int FC = 64;                 // frequencies a chunk
constexpr int CHUNKS = F_PAD / FC;
constexpr int NC = 2 * FC;             // basis columns a chunk: re and im
constexpr int KC = 64;                 // window samples a stage
constexpr int KSTEPS = K / KC;         // stages a chunk
constexpr int STAGES = 4;
constexpr int BOX = KC * 128;          // 64 samples x 64 columns of bf16
constexpr int STAGE = 2 * BOX;
constexpr int MEL_BYTES = MELS * 128;  // 80 mels x 64 frequencies, K-major
constexpr int OFF_MEL = STAGES * STAGE;
constexpr int OFF_BARS = OFF_MEL + 2 * MEL_BYTES;
// At 128 frames the mel sums wait in shared memory between chunks (40 fp32
// a thread), so that the chunk's fp32 sums fit the registers; at 64 they
// stay in registers
constexpr int MEL_SUMS = MELS / 2 * 256 * 4;
constexpr int SMEM_MAX = 232448;
constexpr int THREADS = 288;           // 2 consumer warpgroups + a producer
// false: a walk that loads every operand but multiplies nothing; false:
// the stretch's rows unpadded (scripts/torch_mel_probe.py times each)
constexpr bool LIVE = true;
constexpr bool PAD = true;
// Stages a fold: the products of FOLD stages (64 FOLD samples) are summed
// on the tensor cores, then added to the chunk's sums in fp32
constexpr int FOLD = 4;
static_assert(KSTEPS % FOLD == 0, "a chunk is whole folds");

// The stretch's row pitch in samples: hop, or hop padded to 8 mod 16
__host__ __device__ constexpr int pitch_of(int hop) {
  return PAD ? hop + (24 - hop % 16) % 16 : hop;
}
__host__ __device__ constexpr int taps_of(int hop) {
  return (K + hop - 1) / hop;
}
// The stretch's offset: after the barriers, and the mel sums at 128 frames
__host__ __device__ constexpr int stretch_at(int frames) {
  return OFF_BARS + 128 + (frames == 128 ? MEL_SUMS : 0);
}
__host__ __device__ constexpr int smem_of(int hop, int frames) {
  return 1024 + stretch_at(frames) +
         (frames + taps_of(hop) - 1) * pitch_of(hop) * 2;
}
// 128 frames a block where their stretch fits beside the rings, else 64
__host__ __device__ constexpr int frames_of(int hop) {
  return smem_of(hop, 128) <= SMEM_MAX ? 128 : 64;
}
static_assert(smem_of(1024, 64) <= SMEM_MAX, "the largest hop must fit");
static_assert(MELS * (128 + 4) * 4 <= OFF_MEL, "the output fits the ring");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// Where window sample k of the frame whose window starts at row f lies in
// the stretch, (f + k / hop) pitch + k % hop, kept for k = k0, k0 + 16, ...
struct Cursor {
  int off, rem;
  __device__ __forceinline__ Cursor(int f, int k, int hop, int pitch)
      : off((f + k / hop) * pitch + k % hop), rem(k % hop) {}
  __device__ __forceinline__ void next(int hop, int pitch) {
    off += 16;
    rem += 16;
    while (rem >= hop) {
      rem -= hop;
      off += pitch - hop;
    }
  }
};

// A warp's m64k16 A fragments of window samples, k-step by k-step: row g
// (+ 8) of its 16 frames, samples 2t (+ 1) and 2t + 8 (+ 1) of the step
// (lane = 4g + t). LDM: one ldmatrix.x4, lane L giving the row address of
// frame (L & 7) + 8 ((L >> 3) & 1), samples 8 (L >> 4) ..; else four 32-bit
// loads, samples 2t of frame g from the cursor and 2t + 8 from a copy of
// it moved on by 8.
template <bool LDM>
struct Windows {
  Cursor at;
  uint32_t base;       // the stretch's shared address
  __device__ __forceinline__ Windows(uint32_t stretch, int row0, int lane,
                                     int hop, int pitch)
      : at(LDM ? row0 + (lane & 7) + 8 * ((lane >> 3) & 1) : row0 + lane / 4,
           LDM ? 8 * (lane >> 4) : 2 * (lane % 4), hop, pitch),
        base(stretch) {}
  __device__ __forceinline__ void load(uint32_t (&a)[4], int hop,
                                       int pitch) {
    if constexpr (LDM) {
      ldmatrix_x4(a, base + 2 * at.off);
    } else {
      int off8 = at.off + 8, rem8 = at.rem + 8;
      while (rem8 >= hop) {
        rem8 -= hop;
        off8 += pitch - hop;
      }
      a[0] = lds32(base + 2 * at.off);
      a[1] = lds32(base + 2 * at.off + 16 * pitch);
      a[2] = lds32(base + 2 * off8);
      a[3] = lds32(base + 2 * off8 + 16 * pitch);
    }
    at.next(hop, pitch);
  }
};

// blocks (B, rows, hop) fp32, rows = batch_stride / hop; map_basis: the
// (1024, 1152) interleaved bases in 64 x 64 boxes; map_mel: the (80, 576)
// mel basis in 80 x 64 boxes; out (B, 80, T). Block (x, b): frames
// x FB .. x FB + FB - 1 of utterance b.
template <int ROWS, bool LDM>
__global__ void __launch_bounds__(THREADS, 1)
fused_mel_kernel(const __grid_constant__ CUtensorMap map_basis,
                 const __grid_constant__ CUtensorMap map_mel,
                 const float* __restrict__ blocks, long long batch_stride,
                 int hop, int pitch, int T, float* __restrict__ out) {
  constexpr int FB = 64 * ROWS;        // frames a block
  constexpr int BN = 64 * ROWS;        // basis columns a warpgroup a chunk
  constexpr int FRAGS = BN / 32;       // its magnitudes' k16 fragments
  constexpr int LD = FB + 4;           // the staged output's row, fp32
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + OFF_BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* mel_full = empty + STAGES;
  uint64_t* mel_empty = mel_full + 2;
  float* mel_sums = reinterpret_cast<float*>(sm + OFF_BARS + 128);
  const int t0 = blockIdx.x * FB, b = blockIdx.y;

  // every consumer warp frees a stage and a mel slot
  if (threadIdx.x == 0) {
    mbar_init_ring(full, empty, STAGES, 8);
    mbar_init_ring(mel_full, mel_empty, 2, 8);
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer warp: one thread keeps both rings full, in the consumers'
    // order (a chunk's mel slot, then its 16 basis stages)
    if (threadIdx.x == 256) {
      int i = 0;
      for (int ch = 0; ch < CHUNKS; ++ch) {
        const int slot = ch % 2;
        if (ch >= 2) mbar_wait(smem_addr(mel_empty + slot), (ch / 2 - 1) & 1);
        mbar_expect_tx(smem_addr(mel_full + slot), MEL_BYTES);
        tma_load(sm + OFF_MEL + slot * MEL_BYTES, &map_mel, ch * FC, 0,
                 smem_addr(mel_full + slot));
        for (int ks = 0; ks < KSTEPS; ++ks, ++i) {
          const int st = i % STAGES;
          if (i >= STAGES)
            mbar_wait(smem_addr(empty + st), (i / STAGES - 1) & 1);
          const uint32_t bar = smem_addr(full + st);
          mbar_expect_tx(bar, STAGE);
          tma_load(sm + st * STAGE, &map_basis, ch * NC, ks * KC, bar);
          tma_load(sm + st * STAGE + BOX, &map_basis, ch * NC + 64, ks * KC,
                   bar);
        }
      }
    }
    return;
  }

  // The block's stretch, rounded to bf16: rows t0 .. t0 + FB + taps - 2 of
  // the utterance's blocked stream, zeros past its last row
  __nv_bfloat16* stretch =
      reinterpret_cast<__nv_bfloat16*>(sm + stretch_at(FB));
  {
    const int rows = FB + taps_of(hop) - 1, quads = hop / 4;
    const int avail = static_cast<int>(batch_stride / hop) - t0;
    const float* src =
        blocks + b * batch_stride + static_cast<long long>(t0) * hop;
    for (int i = threadIdx.x; i < rows * quads; i += 256) {
      const int r = i / quads, col = 4 * (i % quads);
      const float4 v =
          r < avail ? *reinterpret_cast<const float4*>(
                          src + static_cast<long long>(r) * hop + col)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<uint2*>(stretch + r * pitch + col) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  }
  bar_sync(1, 256);

  // Consumers: warpgroup c's warp w takes frames row0 .. row0 + 15
  const int c = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int row0 = (ROWS == 2 ? 64 * c : 0) + 16 * warp;
  const uint32_t ring = smem_addr(sm);
  const uint32_t mel_ring = smem_addr(sm + OFF_MEL);
  // ROWS 1: warpgroup c takes the chunk's columns 64c .. 64c + 63, its
  // frequencies 32c .. 32c + 31, mel depth steps 2c, 2c + 1
  const uint32_t col_off = ROWS == 2 ? 0 : c * BOX;
  const int k_off = ROWS == 2 ? 0 : 2 * c;
  const Windows<LDM> first(smem_addr(stretch), row0, lane, hop, pitch);

  // The mel sums: registers at 64 frames; at 128 this thread's 40 in
  // shared memory ([register][thread]) between chunks
  float mel[MELS / 2];
  zero(mel);
  auto mel_io = [&](bool store) {
    if constexpr (ROWS == 2) {
#pragma unroll
      for (int e = 0; e < MELS / 2; ++e) {
        float& v = mel_sums[e * 256 + threadIdx.x];
        if (store) {
          v = mel[e];
        } else {
          mel[e] = v;
        }
      }
    }
  };
  mel_io(true);
  float acc[BN / 2], sum[BN / 2];
  int i = 0;          // the block's stage

#pragma unroll 1
  for (int ch = 0; ch < CHUNKS; ++ch) {
    zero(sum);
    Windows<LDM> w = first;
#pragma unroll 1
    for (int fold = 0; fold < KSTEPS / FOLD; ++fold) {
      // FOLD stages of re/im products summed on the tensor cores, then
      // added to the chunk's sums in fp32: the tensor cores' own additions
      // drop low bits, and one chain of 64 k-steps a chunk moved 0.13% of
      // the log-mels by more than 1e-4 (PERF.md)
#pragma unroll
      for (int s = 0; s < FOLD; ++s) {
        // the windows' fragments first (they need only the stretch); each
        // stage's products are done before the next one's fragments are
        // loaded, while the other warpgroup's keep the tensor cores busy
        uint32_t af[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) w.load(af[kk], hop, pitch);
        const int st = i % STAGES;
        const uint32_t b_addr = ring + st * STAGE + col_off;
        mbar_wait(smem_addr(full + st), (i / STAGES) & 1);
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(af[kk]);
        wgmma_fence();
        if (LIVE) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)     // a fold's first: acc = A B
            wgmma_rs<BN, 1>(acc, af[kk],
                            sw128_desc(b_addr + kk * 2048, BOX, 1024),
                            s > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(af[kk]);
        if (lane == 0) mbar_arrive(smem_addr(empty + st));
        ++i;
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sum[e] += acc[e];
    }

    // The chunk's magnitudes as the mel product's A fragments: fragment s
    // holds frequency groups 2s (registers 0, 1) and 2s + 1 (2, 3); group
    // j's re is accumulator column group 2j, its im 2j + 1
    uint32_t m[FRAGS][4];
#pragma unroll
    for (int s = 0; s < FRAGS; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * s + h;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float re = sum[8 * j + e], im = sum[8 * j + 4 + e];
          v[e] = sqrtf(re * re + im * im + 1e-6f);
        }
        m[s][2 * h] = pack_bf16(v[0], v[1]);
        m[s][2 * h + 1] = pack_bf16(v[2], v[3]);
      }
    }
    const int slot = ch % 2;
    mel_io(false);
    mbar_wait(smem_addr(mel_full + slot), (ch / 2) & 1);
    fence_regs(mel);
#pragma unroll
    for (int s = 0; s < FRAGS; ++s) fence_regs(m[s]);
    wgmma_fence();
    if (LIVE) {
#pragma unroll
      for (int s = 0; s < FRAGS; ++s)
        wgmma_rs<MELS, 0>(mel, m[s],
                          sw128_desc(mel_ring + slot * MEL_BYTES +
                                         (k_off + s) * 32,
                                     16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(mel);
#pragma unroll
    for (int s = 0; s < FRAGS; ++s) fence_regs(m[s]);
    if (lane == 0) mbar_arrive(smem_addr(mel_empty + slot));
    if (ch + 1 < CHUNKS) mel_io(true);
  }

  // Epilogue: both warpgroups' products are done, so the ring is free.
  // log(max(mel, 1e-5)) staged as (mel, frame), then written along T
  bar_sync(1, 256);
  float* staged = reinterpret_cast<float*>(sm);
  const int f = row0 + g;
  if (ROWS == 1 && c == 1) {
#pragma unroll
    for (int j = 0; j < MELS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        staged[(8 * j + 2 * t + (e & 1)) * LD + f + 8 * (e >> 1)] =
            mel[4 * j + e];
  }
  if (ROWS == 1) bar_sync(1, 256);
  if (ROWS == 2 || c == 0) {
#pragma unroll
    for (int j = 0; j < MELS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* p = staged + (8 * j + 2 * t + (e & 1)) * LD + f + 8 * (e >> 1);
        const float v = ROWS == 1 ? mel[4 * j + e] + *p : mel[4 * j + e];
        *p = logf(fmaxf(v, 1e-5f));
      }
  }
  bar_sync(1, 256);
  float* dst = out + static_cast<long long>(b) * MELS * T + t0;
  for (int n = threadIdx.x; n < MELS * FB; n += 256) {
    const int mb = n / FB, fr = n % FB;
    if (t0 + fr < T)
      dst[static_cast<long long>(mb) * T + fr] = staged[mb * LD + fr];
  }
}

template <int ROWS, bool LDM>
cudaError_t launch(const CUtensorMap& map_basis, const CUtensorMap& map_mel,
                   const float* blocks, long long batch_stride, int hop,
                   int T, int B, float* out, cudaStream_t stream) {
  constexpr int FB = 64 * ROWS;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_mel_kernel<ROWS, LDM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  fused_mel_kernel<ROWS, LDM><<<dim3((T + FB - 1) / FB, B), THREADS,
                                smem_of(hop, FB), stream>>>(
      map_basis, map_mel, blocks, batch_stride, hop, pitch_of(hop), T, out);
  return cudaGetLastError();
}

}  // namespace

// blocks: fp32 (B, T + taps - 1, hop) hop-blocked audio (taps = ceil(1024
// / hop)), contiguous, batch_stride = (T + taps - 1) hop elements, 16-byte
// aligned; hop % 4 == 0 and hop <= 1024 (frame t reads 1024 samples from
// t hop). frames and pitch: the caller's plan (ops/stft.py fused_mel_plan),
// frames a block and the stretch's row pitch; any other values are
// refused. basis: bf16 (1024, 1152), the windowed cos and -sin bases (rows
// = window samples) interleaved by 8 columns (columns 16j .. 16j + 7 cos of
// frequencies 8j .., 16j + 8 .. 16j + 15 -sin of the same; zero past 513
// frequencies); mel: bf16 (80, 576), the mel basis, zero past 513
// frequencies. out: fp32 (B, 80, T).
extern "C" int ppgs_fused_mel(const void* blocks, long long batch_stride,
                              int hop, int T, int B, int frames, int pitch,
                              const void* basis, const void* mel, void* out,
                              void* stream) {
  if (hop <= 0 || hop % 4 || hop > K || T < 0 || B < 0 ||
      frames != frames_of(hop) || pitch != pitch_of(hop) ||
      batch_stride != static_cast<long long>(T + taps_of(hop) - 1) * hop)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap map_basis, map_mel;
  if (!encode(&map_basis, basis, false, K, 2 * F_PAD, 2 * F_PAD, 64, KC) ||
      !encode(&map_mel, mel, false, MELS, F_PAD, F_PAD, 64, MELS))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(blocks);
  float* y = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ldm = hop % 8 == 0;
  cudaError_t err =
      frames == 128
          ? (ldm ? launch<2, true>(map_basis, map_mel, x, batch_stride, hop,
                                   T, B, y, s)
                 : launch<2, false>(map_basis, map_mel, x, batch_stride, hop,
                                    T, B, y, s))
          : (ldm ? launch<1, true>(map_basis, map_mel, x, batch_stride, hop,
                                   T, B, y, s)
                 : launch<1, false>(map_basis, map_mel, x, batch_stride, hop,
                                    T, B, y, s));
  return static_cast<int>(err);
}
