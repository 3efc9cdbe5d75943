// Threaded batch WAV (PCM16) decoder for the port's host data path
// (a copy of csrc/wav_decoder.cc, the JAX package's decoder).
//
// A split is decoded once, when it is loaded: this decoder fills the
// int16 [N, desired_samples] matrix that is then copied to the device
// (tcresnet_tpu_torch/data/native_loader.py builds it with g++ at first
// use and binds it with ctypes; a plain C ABI, no PyTorch headers).
//
// Semantics (matching decode_wav and the numpy decoder, data/wav.py):
//   - RIFF/WAVE, PCM (format 1), 16-bit samples; first channel taken;
//   - crop or zero-pad to desired_samples;
//   - returns per-file status (0 ok, negative error code).
//
// One change from the copy: tcresnet_wav_num_samples skips an odd-sized
// fmt chunk's pad byte, as decode_one does, so it finds the data chunk
// of such a file (the original reads every later chunk header one byte
// off and reports 0 samples).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrUnsupported = -3;
constexpr int kErrRate = -4;  // header sample rate != expected_rate

struct Chunk {
  char id[4];
  uint32_t size;
};

int decode_one(const char* path, int desired_samples, int expected_rate,
               int16_t* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kErrOpen;

  char riff[12];
  if (std::fread(riff, 1, 12, f) != 12 || std::memcmp(riff, "RIFF", 4) != 0 ||
      std::memcmp(riff + 8, "WAVE", 4) != 0) {
    std::fclose(f);
    return kErrFormat;
  }

  uint16_t audio_format = 0, num_channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  bool have_fmt = false;
  long data_pos = -1;
  uint32_t data_size = 0;

  Chunk c;
  while (std::fread(&c, 1, sizeof(c), f) == sizeof(c)) {
    if (std::memcmp(c.id, "fmt ", 4) == 0) {
      char fmt[16];
      if (c.size < 16 || std::fread(fmt, 1, 16, f) != 16) {
        std::fclose(f);
        return kErrFormat;
      }
      std::memcpy(&audio_format, fmt + 0, 2);
      std::memcpy(&num_channels, fmt + 2, 2);
      std::memcpy(&sample_rate, fmt + 4, 4);
      std::memcpy(&bits, fmt + 14, 2);
      have_fmt = true;
      // skip any fmt extension; chunks are 2-aligned, so odd sizes carry
      // a pad byte (Python's chunk.py honors it — parity with the
      // numpy-oracle decode path)
      if (c.size > 16) std::fseek(f, ((c.size + 1) & ~1u) - 16, SEEK_CUR);
    } else if (std::memcmp(c.id, "data", 4) == 0) {
      data_pos = std::ftell(f);
      data_size = c.size;
      std::fseek(f, (c.size + 1) & ~1u, SEEK_CUR);  // chunks are 2-aligned
    } else {
      std::fseek(f, (c.size + 1) & ~1u, SEEK_CUR);
    }
  }

  if (!have_fmt || data_pos < 0) {
    std::fclose(f);
    return kErrFormat;
  }
  if (audio_format != 1 || bits != 16 || num_channels == 0) {
    std::fclose(f);
    return kErrUnsupported;
  }
  if (expected_rate > 0 && sample_rate != (uint32_t)expected_rate) {
    std::fclose(f);
    return kErrRate;
  }

  const uint32_t bytes_per_frame = 2u * num_channels;
  const uint32_t n_frames = data_size / bytes_per_frame;
  const uint32_t to_read =
      desired_samples < 0 ? n_frames
                          : (n_frames < (uint32_t)desired_samples
                                 ? n_frames
                                 : (uint32_t)desired_samples);

  std::fseek(f, data_pos, SEEK_SET);
  if (num_channels == 1) {
    if (std::fread(out, 2, to_read, f) != to_read) {
      std::fclose(f);
      return kErrFormat;
    }
  } else {
    std::vector<int16_t> frame(num_channels);
    for (uint32_t i = 0; i < to_read; ++i) {
      if (std::fread(frame.data(), 2, num_channels, f) != num_channels) {
        std::fclose(f);
        return kErrFormat;
      }
      out[i] = frame[0];
    }
  }
  std::fclose(f);

  if (desired_samples > 0 && to_read < (uint32_t)desired_samples) {
    std::memset(out + to_read, 0, ((uint32_t)desired_samples - to_read) * 2);
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode `n` files into out[n * desired_samples] (int16, row-major).
// status[n] receives per-file codes. expected_rate > 0 rejects files
// whose header sample rate differs (kErrRate). Returns failure count.
int tcresnet_decode_batch(const char** paths, int n, int desired_samples,
                          int expected_rate, int16_t* out, int* status,
                          int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n > 0 ? n : 1;

  std::atomic<int> next(0);
  std::atomic<int> failures(0);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = decode_one(paths[i], desired_samples, expected_rate,
                          out + (int64_t)i * desired_samples);
      status[i] = rc;
      if (rc != 0) failures.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Single-file probe: returns sample count (pre-crop) or a negative error.
int tcresnet_wav_num_samples(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kErrOpen;
  char riff[12];
  if (std::fread(riff, 1, 12, f) != 12 || std::memcmp(riff, "RIFF", 4) != 0) {
    std::fclose(f);
    return kErrFormat;
  }
  uint16_t num_channels = 0;
  uint32_t data_size = 0;
  Chunk c;
  while (std::fread(&c, 1, sizeof(c), f) == sizeof(c)) {
    if (std::memcmp(c.id, "fmt ", 4) == 0) {
      char fmt[16];
      if (c.size < 16 || std::fread(fmt, 1, 16, f) != 16) break;
      std::memcpy(&num_channels, fmt + 2, 2);
      if (c.size > 16) std::fseek(f, ((c.size + 1) & ~1u) - 16, SEEK_CUR);
    } else if (std::memcmp(c.id, "data", 4) == 0) {
      data_size = c.size;
      std::fseek(f, (c.size + 1) & ~1u, SEEK_CUR);
    } else {
      std::fseek(f, (c.size + 1) & ~1u, SEEK_CUR);
    }
  }
  std::fclose(f);
  if (num_channels == 0) return kErrFormat;
  return (int)(data_size / (2u * num_channels));
}

}  // extern "C"
