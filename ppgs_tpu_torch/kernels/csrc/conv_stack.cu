// B10: the wav2vec2 feature extractor's conv chain (7 VALID convs of 512
// channels, k = (10,3,3,3,3,2,2), s = (5,2,2,2,2,2,2), GroupNorm(512, 512)
// after conv 0, tanh-GELU after each conv), bf16 stream, fp32 statistics.
//
// Replaces: ppgs_tpu/ops/conv_stack.py feature_encoder_stack, its
// _stats_kernel (conv 0's per-channel sum and sum of squares over every
// conv-0 frame) and _stack_kernel (conv 0 -> GroupNorm -> GELU -> the six
// strided convs with GELU, per time tile, all in VMEM).
//
// The TPU kernel runs the whole chain per time tile with every
// intermediate in VMEM, and writes its strided convs as a "lane fold" (a
// Mosaic workaround for strided sublane slices). Neither carries over: at
// 128 final frames a tile's conv-1 input alone is 8,207 rows x 512
// channels (8.4 MB), far past the 227 KB a Hopper block may have, and
// strided reads cost nothing special here. The Hopper design:
//
// - conv_stats_kernel: one block per (256 conv-0 frames, utterance), one
//   thread per channel; conv 0 (k0 <= 16 taps) in fp32 on the CUDA cores
//   from the bf16 audio in shared memory; per-block partial sums, and the
//   last block of an utterance (an atomic ticket) adds the partials in
//   tile order, so the statistics are the same from run to run.
// - conv_gelu_kernel: one strided conv as an implicit GEMM. For a
//   row-major (T_in, C) input the k taps of output frame t are the k*C
//   contiguous values from row s*t on, so the conv is a GEMM whose A
//   matrix has row stride s*C and depth k*C, against the JAX weight
//   (k, C_in, C_out) read as (k*C_in, C_out); GELU and the bf16 rounding
//   in the epilogue. Its FIRST form is conv 1 with conv 0 folded into the
//   A-tile load: each A element is recomputed from the audio (k0 FMAs),
//   normalised with the statistics and put through GELU, so the conv-0
//   activation (1.68 GB in bf16 at 64 x 8 s) never reaches device memory.
//   Convs 2-6 read the previous conv's bf16 output.
//
// Rounding follows the TPU kernel: the audio and the weights are bf16,
// products accumulate in fp32, the GroupNorm is fp32 with var = E[x^2] -
// mean^2 from the statistics pass, GELU is fp32, and every conv output is
// rounded to bf16.
//
// Bound on an H100 at 64 x 8 s (128,080 samples): 2.5 TFLOP of conv
// products, bound by the tensor cores (~2.5 ms); the bytes (audio in,
// 26 MB out, and the 1.3 GB of convs 1-5's outputs written and read) come
// to ~0.4 ms. The stats pass is 17 GFLOP against 33 MB. A 64 x 128 tile
// per block (8 warps, 16 x 64 each), plain wmma with synchronous loads:
// right first, fast later.

#include "common.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int C = 512;                 // the stack's channels
constexpr int MAX_K0 = 16;             // conv 0 taps (the TPU's PATCH_LANES)
constexpr float GN_EPS = 1e-5f;

// ---------------------------------------------------------------- stats

constexpr int STATS_FRAMES = 256;      // conv-0 frames per stats block

__global__ void __launch_bounds__(C)
conv_stats_kernel(const bf16* __restrict__ audio, long long S,
                  const bf16* __restrict__ w0, int k0, int s0, int T0,
                  int tiles, float* __restrict__ partial,
                  float* __restrict__ sums, unsigned* __restrict__ tickets) {
  extern __shared__ float s_audio[];
  __shared__ bool last;
  const int tile = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const int f0 = tile * STATS_FRAMES;
  const int nf = min(STATS_FRAMES, T0 - f0);
  const long long a0 = (long long)s0 * f0;
  const int n_samples = s0 * (nf - 1) + k0;
  const bf16* src = audio + b * S + a0;
  for (int i = threadIdx.x; i < n_samples; i += C)
    s_audio[i] = __bfloat162float(src[i]);
  float w[MAX_K0];
#pragma unroll
  for (int p = 0; p < MAX_K0; ++p)
    w[p] = p < k0 ? __bfloat162float(w0[p * C + c]) : 0.f;
  __syncthreads();

  float sum = 0.f, sq = 0.f;
  for (int f = 0; f < nf; ++f) {
    const float* a = s_audio + s0 * f;
    float x = 0.f;
#pragma unroll
    for (int p = 0; p < MAX_K0; ++p)
      if (p < k0) x = fmaf(a[p], w[p], x);
    sum += x;
    sq = fmaf(x, x, sq);
  }
  float* mine = partial + ((long long)b * tiles + tile) * 2 * C;
  mine[c] = sum;
  mine[C + c] = sq;

  // The last block of utterance b adds the partials in tile order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + b, 1u) == tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float total = 0.f, total_sq = 0.f;
  const float* all = partial + (long long)b * tiles * 2 * C;
  for (int t = 0; t < tiles; ++t) {
    total += __ldcg(all + t * 2 * C + c);
    total_sq += __ldcg(all + t * 2 * C + C + c);
  }
  sums[b * 2 * C + c] = total;
  sums[b * 2 * C + C + c] = total_sq;
  if (threadIdx.x == 0) tickets[b] = 0u;
}

// ---------------------------------------------------------------- convs

constexpr int BM = 64, BN = 128, BK = 64, THREADS = 256;
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;   // fp32 epilogue tile
constexpr int SMEM_OPERANDS = (BM * A_LD + BK * B_LD) * 2;
constexpr int SMEM_EPILOGUE = BM * C_LD * 4;
constexpr int SMEM_TILES = SMEM_OPERANDS > SMEM_EPILOGUE ? SMEM_OPERANDS
                                                         : SMEM_EPILOGUE;
// FIRST only: the GroupNorm's mean, 1/std, scale and shift per channel,
// conv 0's weights in fp32, then the block's audio samples
constexpr int OFF_GN = SMEM_TILES;
constexpr int OFF_W0 = OFF_GN + 4 * C * 4;

// Audio samples a FIRST block reads: the conv-0 frames of BM conv-1 rows
__host__ __device__ inline int first_samples(int k, int s, int k0, int s0) {
  return s0 * (s * (BM - 1) + k - 1) + k0;
}

struct First {            // conv 0 + GroupNorm, folded into conv 1's loads
  const bf16* w0;         // (k0, C) bf16
  const float* sums;      // (B, 2, C): sum and sum of squares of conv 0
  const float* gamma;     // (C) GroupNorm scale
  const float* beta;      // (C) GroupNorm shift
  int k0, s0, T0;
  long long S;            // samples per utterance
};

// x: FIRST: the bf16 audio (B, S); else the bf16 (B, T_in, C) input.
// w: (k*C, C) bf16. out: (B, T_out, C) bf16.
template <bool FIRST>
__global__ void __launch_bounds__(THREADS)
conv_gelu_kernel(const bf16* __restrict__ x, long long x_batch,
                 const bf16* __restrict__ w, int k, int s, int T_out,
                 bf16* __restrict__ out, First first) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + BM * A_LD;
  float* sC = reinterpret_cast<float*>(smem);

  const int t0 = blockIdx.x * BM, col0 = blockIdx.y * BN, b = blockIdx.z;
  const int rows = min(BM, T_out - t0);
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 16;   // the warp's 16 rows
  const int wc = (warp % 2) * 64;   // and 64 columns
  const int K = k * C;

  float* gn = reinterpret_cast<float*>(smem + OFF_GN);   // FIRST only
  float* s_w0 = reinterpret_cast<float*>(smem + OFF_W0);
  float* s_audio = s_w0 + (FIRST ? first.k0 * C : 0);
  if constexpr (FIRST) {
    // Per-channel GroupNorm from the statistics (groups = channels)
    const float n = static_cast<float>(first.T0);
    for (int c = threadIdx.x; c < C; c += THREADS) {
      const float mean = first.sums[b * 2 * C + c] / n;
      const float var = first.sums[b * 2 * C + C + c] / n - mean * mean;
      gn[c] = mean;
      gn[C + c] = rsqrtf(var + GN_EPS);
      gn[2 * C + c] = first.gamma[c];
      gn[3 * C + c] = first.beta[c];
    }
    for (int i = threadIdx.x; i < first.k0 * C; i += THREADS)
      s_w0[i] = __bfloat162float(first.w0[i]);
    // Samples from conv-0 frame s * t0 on; past the audio: zeros (those
    // frames feed only rows >= T_out, which are not written)
    const long long a0 = (long long)first.s0 * s * t0;
    const int n_samples = first_samples(k, s, first.k0, first.s0);
    for (int i = threadIdx.x; i < n_samples; i += THREADS)
      s_audio[i] = a0 + i < first.S
                       ? __bfloat162float(x[b * x_batch + a0 + i]) : 0.f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int kk0 = 0; kk0 < K; kk0 += BK) {
    __syncthreads();
    if constexpr (FIRST) {
      // A = bf16(gelu(GN(conv0))) of conv-0 frame s*(t0+r) + j, channels
      // i0 .. i0+63: lanes on neighbouring channels, one row per warp
      const int j = kk0 / C, i0 = kk0 % C;
      const int c = threadIdx.x % BK, i = i0 + c;
      float wi[MAX_K0];
#pragma unroll
      for (int p = 0; p < MAX_K0; ++p)
        wi[p] = p < first.k0 ? s_w0[p * C + i] : 0.f;
      const float mean = gn[i], rstd = gn[C + i], g = gn[2 * C + i],
                  be = gn[3 * C + i];
      for (int r = threadIdx.x / BK; r < BM; r += THREADS / BK) {
        float v = 0.f;
        if (r < rows) {
          const float* a = s_audio + first.s0 * (s * r + j);
          float x0 = 0.f;
#pragma unroll
          for (int p = 0; p < MAX_K0; ++p)
            if (p < first.k0) x0 = fmaf(a[p], wi[p], x0);
          v = ppgs::gelu_tanh((x0 - mean) * rstd * g + be);
        }
        sA[r * A_LD + c] = __float2bfloat16(v);
      }
    } else {
      ppgs::load_tile_bf16<BM, BK, THREADS>(
          sA, A_LD, x + b * x_batch + (long long)s * t0 * C + kk0,
          (long long)s * C, rows);
    }
    ppgs::load_tile_bf16<BK, BN, THREADS>(
        sB, B_LD, w + (long long)kk0 * C + col0, C, BK);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sA + wr * A_LD + kk, A_LD);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sB + kk * B_LD + wc + jj * 16, B_LD);
        wmma::mma_sync(acc[jj], fa, fb, acc[jj]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(sC + wr * C_LD + wc + j * 16, acc[j], C_LD,
                            wmma::mem_row_major);
  __syncthreads();

  // Epilogue: bf16(gelu(acc)), 8 columns (16 bytes) per thread and step
  for (int i = threadIdx.x; i < BM * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    if (r >= rows) continue;
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = __float2bfloat16(ppgs::gelu_tanh(sC[r * C_LD + c + e]));
    *reinterpret_cast<uint4*>(
        out + ((long long)b * T_out + t0 + r) * C + col0 + c) =
        *reinterpret_cast<const uint4*>(o);
  }
}

}  // namespace

// audio (B, S) bf16, w0 (k0, 512) bf16, k0 <= 16; T0 = (S - k0) / s0 + 1
// conv-0 frames in tiles = ceil(T0 / 256) blocks per utterance; partial
// (B, tiles, 2, 512) fp32 scratch; tickets (B) zeroed uint32 (left zeroed)
// -> sums (B, 2, 512) fp32: each channel's sum and sum of squares of conv
// 0 over all T0 frames.
extern "C" int ppgs_conv_stats(const void* audio, long long S, const void* w0,
                               int k0, int s0, int T0, int B, void* partial,
                               void* sums, void* tickets, void* stream) {
  if (k0 > MAX_K0 || k0 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && T0 > 0) {
    const int tiles = (T0 + STATS_FRAMES - 1) / STATS_FRAMES;
    const int smem = (s0 * (STATS_FRAMES - 1) + k0) * 4;
    conv_stats_kernel<<<dim3(tiles, B), C, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(audio), S, static_cast<const bf16*>(w0), k0,
        s0, T0, tiles, static_cast<float*>(partial), static_cast<float*>(sums),
        static_cast<unsigned*>(tickets));
  }
  return static_cast<int>(cudaGetLastError());
}

// One strided conv with GELU: out (B, T_out, 512) bf16 = bf16(gelu(x * w))
// with w (k*512, 512) bf16 (the (k, C_in, C_out) weight), stride s.
// w0 null: x (B, T_in, 512) bf16, x_batch = T_in * 512, and
// s * (T_out - 1) + k <= T_in. w0 given: the FIRST form, x is the bf16
// audio (B, S), x_batch = S, and this conv's input is conv 0 (w0 (k0, 512)
// bf16, stride s0, T0 frames) normalised with sums (from ppgs_conv_stats),
// gamma and beta (512) fp32, and GELU.
extern "C" int ppgs_conv_gelu(const void* x, long long x_batch, const void* w,
                              int k, int s, int T_out, int B, void* out,
                              const void* w0, int k0, int s0, int T0,
                              const void* sums, const void* gamma,
                              const void* beta, void* stream) {
  const First first{static_cast<const bf16*>(w0),
                    static_cast<const float*>(sums),
                    static_cast<const float*>(gamma),
                    static_cast<const float*>(beta), k0, s0, T0, x_batch};
  const bool from_audio = w0 != nullptr;
  if (from_audio && (k0 > MAX_K0 || k0 < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = from_audio ? OFF_W0 + k0 * C * 4 +
                                    first_samples(k, s, k0, s0) * 4
                              : SMEM_TILES;
  const void* kernel =
      from_audio ? reinterpret_cast<const void*>(conv_gelu_kernel<true>)
                 : reinterpret_cast<const void*>(conv_gelu_kernel<false>);
  // Above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && T_out > 0) {
    const dim3 grid((T_out + BM - 1) / BM, C / BN, B);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* ob = static_cast<bf16*>(out);
    if (from_audio)
      conv_gelu_kernel<true><<<grid, THREADS, smem, st>>>(
          xb, x_batch, wb, k, s, T_out, ob, first);
    else
      conv_gelu_kernel<false><<<grid, THREADS, smem, st>>>(
          xb, x_batch, wb, k, s, T_out, ob, first);
  }
  return static_cast<int>(cudaGetLastError());
}
