// Native audio decode + batch assembly (the reference's SoX-equivalent
// runtime component — SURVEY.md §2 "NATIVE: SoX / audio codecs").
//
// Decodes RIFF/WAVE PCM16 / PCM32 / float32 (first channel of multi-channel
// files) into float32 [-1, 1) with EXACTLY the same arithmetic as the python
// reader (aas_enhancement_tpu/data/wav.py:45-52): int16/32768.0f,
// int32 -> float -> /2147483648.0f, f32 passthrough — so the native and
// python paths are bit-identical and interchangeable.  The int16 variant is
// the quantized transport for DataConfig.feed_dtype="int16": PCM16 sources
// are a direct (strided) copy; PCM32/float32 follow the python chain
// read_wav -> *32768 -> clip -> rint (data/dataset.py _to_int16).
//
// wav_batch_decode / wav_batch_decode_i16 pack B files into a
// caller-allocated [B, bucket] batch in parallel (one thread per core up to
// n_threads), writing per-row valid lengths — the host-side hot loop of the
// training input pipeline (data/dataset.py make_batch).
//
// Exposed via ctypes (no pybind11 in this image): plain C ABI, caller owns
// all memory, no exceptions cross the boundary.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Little-endian loads (portable regardless of host alignment rules).
inline uint16_t ld16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0] | (p[1] << 8));
}
inline uint32_t ld32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

struct WavData {
  std::vector<uint8_t> raw;   // owns the file bytes
  const uint8_t* pcm = nullptr;
  uint32_t pcm_size = 0;
  uint16_t audio_fmt = 0;
  uint16_t n_ch = 0;
  uint16_t bits = 0;
  uint32_t sr = 0;
};

// Errors: -1 io, -2 not riff/wave, -3 missing chunk, -4 unsupported format,
// -5 sample-rate mismatch.
int parse_wav(const char* path, int expected_sr, WavData* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 12) { std::fclose(f); return -2; }
  w->raw.resize(static_cast<size_t>(fsize));
  if (std::fread(w->raw.data(), 1, w->raw.size(), f) != w->raw.size()) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  const std::vector<uint8_t>& data = w->raw;
  if (std::memcmp(data.data(), "RIFF", 4) != 0 ||
      std::memcmp(data.data() + 8, "WAVE", 4) != 0)
    return -2;

  const uint8_t* fmt = nullptr;
  uint32_t fmt_size = 0;
  size_t pos = 12;
  while (pos + 8 <= data.size()) {
    const uint8_t* hdr = data.data() + pos;
    uint32_t sz = ld32(hdr + 4);
    if (pos + 8 + sz > data.size()) sz = static_cast<uint32_t>(data.size() - pos - 8);
    if (std::memcmp(hdr, "fmt ", 4) == 0) {
      fmt = hdr + 8;
      fmt_size = sz;
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      w->pcm = hdr + 8;
      w->pcm_size = sz;
    }
    pos += 8 + sz + (sz & 1);  // chunks are word-aligned
  }
  if (!fmt || !w->pcm || fmt_size < 16) return -3;

  w->audio_fmt = ld16(fmt);
  w->n_ch = ld16(fmt + 2);
  w->sr = ld32(fmt + 4);
  w->bits = ld16(fmt + 14);
  if (w->n_ch == 0) return -4;
  if (expected_sr > 0 && static_cast<int>(w->sr) != expected_sr) return -5;
  bool ok = (w->audio_fmt == 1 && (w->bits == 16 || w->bits == 32)) ||
            (w->audio_fmt == 3 && w->bits == 32);
  return ok ? 0 : -4;
}

inline int16_t quantize_i16(float v) {
  v *= 32768.0f;
  if (v > 32767.0f) v = 32767.0f;
  if (v < -32768.0f) v = -32768.0f;
  return static_cast<int16_t>(std::lrintf(v));
}

// Decode the first channel into out[0:max_n] in the output type selected by
// the conversion functor.  Returns samples written or a parse_wav error.
template <typename T, typename FromI16, typename FromI32, typename FromF32>
long decode_channel0(const WavData& w, T* out, long max_n,
                     FromI16 from_i16, FromI32 from_i32, FromF32 from_f32) {
  const uint8_t* p = w.pcm;
  long n;
  if (w.audio_fmt == 1 && w.bits == 16) {
    n = static_cast<long>(w.pcm_size / (2 * w.n_ch));
    if (n > max_n) n = max_n;
    for (long i = 0; i < n; ++i)
      out[i] = from_i16(
          static_cast<int16_t>(ld16(p + 2 * static_cast<size_t>(i) * w.n_ch)));
  } else if (w.audio_fmt == 1 && w.bits == 32) {
    n = static_cast<long>(w.pcm_size / (4 * w.n_ch));
    if (n > max_n) n = max_n;
    for (long i = 0; i < n; ++i)
      out[i] = from_i32(
          static_cast<int32_t>(ld32(p + 4 * static_cast<size_t>(i) * w.n_ch)));
  } else {  // audio_fmt == 3 && bits == 32
    n = static_cast<long>(w.pcm_size / (4 * w.n_ch));
    if (n > max_n) n = max_n;
    for (long i = 0; i < n; ++i) {
      uint32_t u = ld32(p + 4 * static_cast<size_t>(i) * w.n_ch);
      float v;
      std::memcpy(&v, &u, 4);
      out[i] = from_f32(v);
    }
  }
  return n;
}

long decode_one_f32(const char* path, float* out, long max_n, int expected_sr,
                    int* sr_out) {
  WavData w;
  int rc = parse_wav(path, expected_sr, &w);
  if (sr_out) *sr_out = static_cast<int>(w.sr);
  if (rc != 0) return rc;
  return decode_channel0<float>(
      w, out, max_n,
      [](int16_t s) { return static_cast<float>(s) / 32768.0f; },
      [](int32_t s) { return static_cast<float>(s) / 2147483648.0f; },
      [](float v) { return v; });
}

long decode_one_i16(const char* path, int16_t* out, long max_n,
                    int expected_sr) {
  WavData w;
  int rc = parse_wav(path, expected_sr, &w);
  if (rc != 0) return rc;
  if (w.audio_fmt == 1 && w.bits == 16 && w.n_ch == 1) {
    // The common case (PCM16 mono): a straight copy, no float round-trip.
    long n = static_cast<long>(w.pcm_size / 2);
    if (n > max_n) n = max_n;
    std::memcpy(out, w.pcm, static_cast<size_t>(n) * 2);
    return n;
  }
  return decode_channel0<int16_t>(
      w, out, max_n,
      [](int16_t s) { return s; },
      [](int32_t s) {
        return quantize_i16(static_cast<float>(s) / 2147483648.0f);
      },
      [](float v) { return quantize_i16(v); });
}

// Parallel batch runner shared by both output types: zero-fill each row,
// decode, record length; first failure (as -(index+1)) wins and stops work.
template <typename T, typename DecodeRow>
int run_batch(int b, long bucket, T* out, int* lengths, int n_threads,
              DecodeRow decode_row) {
  if (b <= 0 || bucket <= 0) return 0;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  int nt = n_threads > 0 ? n_threads : hw;
  if (nt > b) nt = b;

  std::atomic<int> next{0};
  std::atomic<int> failed{0};

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= b || failed.load(std::memory_order_relaxed)) return;
      T* row = out + static_cast<size_t>(i) * bucket;
      std::memset(row, 0, static_cast<size_t>(bucket) * sizeof(T));
      long n = decode_row(i, row);
      if (n < 0) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
        return;
      }
      lengths[i] = static_cast<int>(n);
    }
  };

  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(nt));
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return -failed.load();
}

}  // namespace

extern "C" {

// Single-file decode into out[0:max_n]; remaining samples are NOT zeroed.
// Returns valid sample count or negative error (see parse_wav).
long wav_decode(const char* path, float* out, long max_n, int expected_sr,
                int* sr_out) {
  return decode_one_f32(path, out, max_n, expected_sr, sr_out);
}

// Parallel batch decode: paths[b] -> out[b * bucket : (b+1) * bucket]
// (zero-padded), lengths[b] = valid samples.  Returns 0 on success or
// -(first_failed_index + 1).  n_threads <= 0 means hardware concurrency.
int wav_batch_decode(const char** paths, int b, long bucket, int expected_sr,
                     float* out, int* lengths, int n_threads) {
  return run_batch<float>(b, bucket, out, lengths, n_threads,
                          [&](int i, float* row) {
                            return decode_one_f32(paths[i], row, bucket,
                                                  expected_sr, nullptr);
                          });
}

// int16-output batch decode (see decode_one_i16).
int wav_batch_decode_i16(const char** paths, int b, long bucket,
                         int expected_sr, int16_t* out, int* lengths,
                         int n_threads) {
  return run_batch<int16_t>(b, bucket, out, lengths, n_threads,
                            [&](int i, int16_t* row) {
                              return decode_one_i16(paths[i], row, bucket,
                                                    expected_sr);
                            });
}

}  // extern "C"
