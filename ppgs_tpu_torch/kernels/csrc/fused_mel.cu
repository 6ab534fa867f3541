// B9 fused_mel: log-mel spectrogram in one kernel, bf16 DFT and mel
// products with fp32 accumulation, the (frames, 513) spectrum kept on chip.
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
// Reading frames. The TPU copies each frame's 7 x 160-sample window out of
// the hop-blocked stream (a host-side im2col) to get one contiguous
// contraction. Here frame t's window is samples [t * hop, t * hop + 1024)
// of the blocked stream itself, so the kernel reads its A rows in place at
// a row stride of hop (as conv_stack.cu reads its conv inputs) and rounds
// them to bf16 in the load. K stops at 1024: the blocked basis rows past
// n_fft are zero.
//
// Keeping the spectrum on chip. A block owns 64 frames of one utterance
// and holds their 64 x 1024 bf16 windows in shared memory (132 KB). It
// walks the 513 frequencies (zero-padded to 576) in chunks of 64: re and
// im of the chunk over the 1024 samples (basis tiles of 64 x 64 streamed
// from L2), the magnitude on the accumulators, rounded to bf16 through a
// per-warp buffer, then mel += mag_chunk . mel_t[chunk] into accumulators
// that live in registers across the chunks. The (rows, 513) spectrum never
// reaches device memory; the output is staged in shared memory and written
// along the frame axis.
//
// Bound on an H100 at 64 x 8 s (T = 800 frames, M = 51,200): the DFT,
// 2 x 2 x M x 1024 x 513 = 1.08e11 FLOP, and the mel product, 2 x M x 513 x
// 80 = 4.2e9, take 0.113 ms at 989 TFLOP/s; the bytes (the fp32 blocked
// audio, 33 MB, the bases, the output, 16 MB) 0.015 ms: bound by
// operations. The design re-reads the bases (2.4 MB) from L2 for every
// 64-frame block and runs wmma 16x16x16 from synchronous loads, one block
// per SM (188 KB of shared memory): a right-first kernel, not a fast one.

#include "common.cuh"

using namespace nvcuda;
using ppgs::bf16;

namespace {

constexpr int BT = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int K = 1024;           // window samples read (n_fft)
constexpr int FC = 64;            // frequencies per chunk
constexpr int F_PAD = 576;        // 513 frequencies, zero-padded
constexpr int KC = 64;            // samples per basis tile
constexpr int MELS = 80;
constexpr int A_LD = K + 8;       // bf16 windows, 64 x 1024
constexpr int B_LD = FC + 8;      // bf16 basis tiles, 64 x 64
constexpr int MEL_LD = MELS + 8;  // bf16 mel basis chunk, 64 x 80
constexpr int MAG_LD = FC + 4;    // fp32 magnitudes, per warp 16 x 64
constexpr int MAGB_LD = FC + 8;   // bf16 magnitudes, per warp 16 x 64
constexpr int OUT_LD = BT + 4;    // fp32 mel output, 80 x 64 (in A's room)

constexpr int OFF_A = 0;
constexpr int OFF_RE = OFF_A + BT * A_LD * 2;
constexpr int OFF_IM = OFF_RE + KC * B_LD * 2;
constexpr int OFF_MEL = OFF_IM + KC * B_LD * 2;
constexpr int OFF_MAG = OFF_MEL + FC * MEL_LD * 2;
constexpr int OFF_MAGB = OFF_MAG + WARPS * 16 * MAG_LD * 4;
constexpr int SMEM = OFF_MAGB + WARPS * 16 * MAGB_LD * 2;
static_assert(OFF_RE % 128 == 0 && OFF_IM % 128 == 0 && OFF_MEL % 128 == 0 &&
                  OFF_MAG % 128 == 0 && OFF_MAGB % 128 == 0,
              "shared-memory regions must stay aligned");
static_assert(MELS * OUT_LD * 4 <= OFF_RE, "the output fits in A's room");
static_assert(SMEM <= 232448, "more shared memory than a block may have");

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(THREADS)
fused_mel_kernel(const float* __restrict__ blocks, long long batch_stride,
                 int hop, int T, const bf16* __restrict__ basis_re,
                 const bf16* __restrict__ basis_im,
                 const bf16* __restrict__ mel_t, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem + OFF_A);
  bf16* sRe = reinterpret_cast<bf16*>(smem + OFF_RE);
  bf16* sIm = reinterpret_cast<bf16*>(smem + OFF_IM);
  bf16* sMel = reinterpret_cast<bf16*>(smem + OFF_MEL);
  const int t0 = blockIdx.x * BT, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sMag = reinterpret_cast<float*>(smem + OFF_MAG) + warp * 16 * MAG_LD;
  bf16* sMagB = reinterpret_cast<bf16*>(smem + OFF_MAGB) + warp * 16 * MAGB_LD;

  // The block's 64 windows, rounded to bf16: frame t0 + r reads samples
  // [(t0 + r) * hop, ... + 1024) of its utterance's blocked stream
  ppgs::load_tile_f32_as_bf16<BT, K, THREADS>(
      sA, A_LD, blocks + b * batch_stride + (long long)t0 * hop, hop,
      min(BT, T - t0));

  Acc mel[MELS / 16];
#pragma unroll
  for (int n = 0; n < MELS / 16; ++n) wmma::fill_fragment(mel[n], 0.f);

  for (int fc = 0; fc < F_PAD; fc += FC) {
    Acc re[FC / 16], im[FC / 16];
#pragma unroll
    for (int n = 0; n < FC / 16; ++n) {
      wmma::fill_fragment(re[n], 0.f);
      wmma::fill_fragment(im[n], 0.f);
    }
    for (int kc = 0; kc < K; kc += KC) {
      __syncthreads();      // the previous tiles (and A's load) are done
      ppgs::load_tile_bf16<KC, FC, THREADS>(
          sRe, B_LD, basis_re + (long long)kc * F_PAD + fc, F_PAD, KC);
      ppgs::load_tile_bf16<KC, FC, THREADS>(
          sIm, B_LD, basis_im + (long long)kc * F_PAD + fc, F_PAD, KC);
      if (kc == 0)
        ppgs::load_tile_bf16<FC, MELS, THREADS>(
            sMel, MEL_LD, mel_t + (long long)fc * MELS, MELS, FC);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sA + warp * 16 * A_LD + kc + kk, A_LD);
#pragma unroll
        for (int n = 0; n < FC / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, sRe + kk * B_LD + n * 16, B_LD);
          wmma::mma_sync(re[n], fa, fb, re[n]);
          wmma::load_matrix_sync(fb, sIm + kk * B_LD + n * 16, B_LD);
          wmma::mma_sync(im[n], fa, fb, im[n]);
        }
      }
    }

    // The chunk's magnitudes (re and im fragments share one layout), then
    // rounded to bf16 as the mel product's A operand
#pragma unroll
    for (int n = 0; n < FC / 16; ++n) {
#pragma unroll
      for (int e = 0; e < re[n].num_elements; ++e)
        re[n].x[e] = sqrtf(re[n].x[e] * re[n].x[e] +
                           im[n].x[e] * im[n].x[e] + 1e-6f);
      wmma::store_matrix_sync(sMag + n * 16, re[n], MAG_LD,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * FC; i += 32)
      sMagB[(i / FC) * MAGB_LD + i % FC] =
          __float2bfloat16(sMag[(i / FC) * MAG_LD + i % FC]);
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < FC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sMagB + kk, MAGB_LD);
#pragma unroll
      for (int n = 0; n < MELS / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sMel + kk * MEL_LD + n * 16, MEL_LD);
        wmma::mma_sync(mel[n], fa, fb, mel[n]);
      }
    }
  }

  // Stage (mel, frame) in A's room, then write log(max(mel, 1e-5)) along
  // the frame axis of out (B, 80, T)
  __syncthreads();
  float* sOut = reinterpret_cast<float*>(smem + OFF_A);
#pragma unroll
  for (int n = 0; n < MELS / 16; ++n)
    wmma::store_matrix_sync(sOut + n * 16 * OUT_LD + warp * 16, mel[n],
                            OUT_LD, wmma::mem_col_major);
  __syncthreads();
  for (int i = threadIdx.x; i < MELS * BT; i += THREADS) {
    const int m = i / BT, f = i % BT;
    if (t0 + f < T)
      out[((long long)b * MELS + m) * T + t0 + f] =
          logf(fmaxf(sOut[m * OUT_LD + f], 1e-5f));
  }
}

}  // namespace

// blocks: fp32 (B, T + taps - 1, hop) hop-blocked audio, contiguous, batch
// stride batch_stride elements; hop % 4 == 0 and hop <= 1024 (frame t
// reads 1024 samples from t * hop). basis_re, basis_im: bf16 (1024, 576)
// windowed DFT bases (rows = window samples, columns = frequencies, zero
// past 513); mel_t: bf16 (576, 80) transposed mel basis, zero rows past
// 513. out: fp32 (B, 80, T).
extern "C" int ppgs_fused_mel(const void* blocks, long long batch_stride,
                              int hop, int T, int B, const void* basis_re,
                              const void* basis_im, const void* mel_t,
                              void* out, void* stream) {
  if (hop <= 0 || hop % 4 || hop > K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && T > 0) {
    dim3 grid((T + BT - 1) / BT, B);
    fused_mel_kernel<<<grid, THREADS, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(blocks), batch_stride, hop, T,
        static_cast<const bf16*>(basis_re), static_cast<const bf16*>(basis_im),
        static_cast<const bf16*>(mel_t), static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
