// Native audio/data runtime for ppgs_tpu_torch (a copy of the JAX
// package's ppgs_tpu/native/src/audio_io.cc; host code, no device).
//
// The training/preprocessing hot path reads thousands of WAV files and
// float16 feature caches per epoch. The reference does this through
// torchaudio's C++ backends; here the equivalent native layer is a small
// dependency-free C++ library exposed over a C ABI and bound via ctypes
// (ppgs_tpu_torch/native/__init__.py), with a pure-Python fallback.
//
// Capabilities:
//  - RIFF/WAVE parsing (PCM 8/16/32-bit) -> float32 in [-1, 1]
//  - batched multi-threaded file decode into a caller-provided arena
//  - framewise phoneme-label expansion (interval -> per-frame indices)
//
// Build: see ppgs_tpu_torch/native/Makefile (g++ -O3 -shared -fPIC), into
// ppgs_tpu_torch/native/build/.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  int64_t num_frames = 0;   // samples per channel
  int64_t data_offset = 0;  // byte offset of PCM payload
  int64_t data_bytes = 0;
};

// Parse RIFF chunks; returns false on malformed input.
bool parse_wav_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t size;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4) != 0) return false;
  if (fread(&size, 4, 1, f) != 1) return false;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4) != 0) return false;

  bool have_fmt = false;
  while (fread(id, 1, 4, f) == 4 && fread(&size, 4, 1, f) == 1) {
    if (memcmp(id, "fmt ", 4) == 0) {
      uint16_t format, channels, bits;
      uint32_t rate, byte_rate;
      uint16_t block_align;
      if (fread(&format, 2, 1, f) != 1) return false;
      if (fread(&channels, 2, 1, f) != 1) return false;
      if (fread(&rate, 4, 1, f) != 1) return false;
      if (fread(&byte_rate, 4, 1, f) != 1) return false;
      if (fread(&block_align, 2, 1, f) != 1) return false;
      if (fread(&bits, 2, 1, f) != 1) return false;
      if (format != 1 && format != 0xFFFE) return false;  // PCM only
      info->channels = channels;
      info->sample_rate = rate;
      info->bits = bits;
      have_fmt = true;
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      if (have_fmt && info->channels && info->bits) {
        info->num_frames =
            info->data_bytes / (info->channels * (info->bits / 8));
      }
      return have_fmt;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  return false;
}

// Decode one file's first channel into out[0..max_samples).
// Returns samples written, or -1 on error.
int64_t decode_wav(const char* path, float* out, int64_t max_samples,
                   int32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_wav_header(f, &info) || info.num_frames <= 0) {
    fclose(f);
    return -1;
  }
  *sample_rate = static_cast<int32_t>(info.sample_rate);

  int64_t n = info.num_frames < max_samples ? info.num_frames : max_samples;
  fseek(f, info.data_offset, SEEK_SET);

  const int stride = info.channels;
  if (info.bits == 16) {
    std::vector<int16_t> buf(n * stride);
    if (fread(buf.data(), 2, n * stride, f) !=
        static_cast<size_t>(n * stride)) {
      fclose(f);
      return -1;
    }
    constexpr float kScale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = buf[i * stride] * kScale;
  } else if (info.bits == 32) {
    std::vector<int32_t> buf(n * stride);
    if (fread(buf.data(), 4, n * stride, f) !=
        static_cast<size_t>(n * stride)) {
      fclose(f);
      return -1;
    }
    constexpr double kScale = 1.0 / 2147483648.0;
    for (int64_t i = 0; i < n; ++i)
      out[i] = static_cast<float>(buf[i * stride] * kScale);
  } else if (info.bits == 8) {
    std::vector<uint8_t> buf(n * stride);
    if (fread(buf.data(), 1, n * stride, f) !=
        static_cast<size_t>(n * stride)) {
      fclose(f);
      return -1;
    }
    constexpr float kScale = 1.0f / 128.0f;
    for (int64_t i = 0; i < n; ++i)
      out[i] = (static_cast<int>(buf[i * stride]) - 128) * kScale;
  } else {
    fclose(f);
    return -1;
  }
  fclose(f);
  return n;
}

}  // namespace

extern "C" {

// Number of samples in the WAV (first channel); -1 on error.
int64_t ppgs_wav_info(const char* path, int32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_wav_header(f, &info);
  fclose(f);
  if (!ok) return -1;
  *sample_rate = static_cast<int32_t>(info.sample_rate);
  return info.num_frames;
}

// Decode a single WAV file; returns samples written or -1.
int64_t ppgs_wav_read(const char* path, float* out, int64_t max_samples,
                      int32_t* sample_rate) {
  return decode_wav(path, out, max_samples, sample_rate);
}

// Decode a batch of WAV files concurrently into a zero-initialized arena
// of shape (batch, max_samples), row-major. lengths[i] receives samples
// written (-1 on per-file error). num_threads <= 0 -> hardware threads.
void ppgs_wav_read_batch(const char** paths, int64_t batch,
                         float* arena, int64_t max_samples,
                         int64_t* lengths, int32_t* sample_rates,
                         int32_t num_threads) {
  int threads = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  if (threads < 1) threads = 1;
  if (threads > batch) threads = static_cast<int>(batch);

  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([=]() {
      for (int64_t i = t; i < batch; i += threads) {
        lengths[i] = decode_wav(paths[i], arena + i * max_samples,
                                max_samples, &sample_rates[i]);
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Expand phoneme intervals to framewise indices: for each frame center
// time, the index of the first interval whose end exceeds it (boundary
// frames belong to the following phoneme; clamped to the last interval).
// ends: (num_intervals) seconds ascending; indices_out: (num_frames).
void ppgs_framewise_indices(const double* ends, const int32_t* labels,
                            int64_t num_intervals, const double* times,
                            int64_t num_frames, int32_t* indices_out) {
  int64_t j = 0;
  for (int64_t i = 0; i < num_frames; ++i) {
    while (j < num_intervals && ends[j] <= times[i]) ++j;
    int64_t idx = j < num_intervals ? j : num_intervals - 1;
    indices_out[i] = labels[idx];
  }
}

}  // extern "C"
