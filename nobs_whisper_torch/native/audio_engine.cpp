// Native audio ingestion / DSP engine.
//
// Host-side replacement for the reference's native capture stack
// (cpal/CoreAudio capture + rubato FFT resampler,
// src-tauri/src/audio.rs): a lock-free-ish ring buffer per stream,
// streaming windowed-RMS VAD with an EMA-adaptive noise floor, offline
// silence-boundary scanning, and a polyphase 48k->16k resampler. Exposed
// through a C ABI consumed via ctypes; semantics match the Python
// implementations bit-for-bit on the decision level (same constants:
// 20 ms windows, 700 ms min silence, 3x noise-floor threshold, 200 ms
// overlap, 25 s forced split).
//
// Build: g++ -O3 -march=native -shared -fPIC audio_engine.cpp -o ...

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

constexpr float kSilenceThreshold = 0.01f;
constexpr int kMinSilenceMs = 700;
constexpr int kMinChunkMs = 1000;
constexpr int kOverlapMs = 200;
constexpr int kMaxBufferS = 25;
constexpr float kNoiseFactor = 3.0f;
constexpr float kMinThresholdFactor = 0.5f;
constexpr float kEmaDecay = 0.95f;
constexpr float kNoiseUpdateFactor = 0.5f;
constexpr int kNoiseMaxFrames = 100;
constexpr int kNoiseEstWindows = 25;
constexpr float kNoisePercentile = 0.1f;
constexpr float kMinNoiseFloorFactor = 0.3f;

float rms(const float* x, size_t n) {
  if (n == 0) return 0.0f;
  double acc = 0.0;
  for (size_t i = 0; i < n; ++i) acc += double(x[i]) * x[i];
  return float(std::sqrt(acc / double(n)));
}

struct StreamBuffer {
  std::mutex mu;
  std::vector<float> samples;
  std::vector<float> overlap;
  size_t last_speech_pos = 0;
  int sample_rate = 48000;
  float noise_floor = kSilenceThreshold;
  int noise_frames = 0;
  // partial RMS window carry
  size_t rms_cursor = 0;  // absolute sample index of next unscanned window

  int win() const { return sample_rate / 50; }

  float adaptive_threshold() const {
    return std::max(noise_floor * kNoiseFactor,
                    kSilenceThreshold * kMinThresholdFactor);
  }

  void push(const float* data, size_t n) {
    std::lock_guard<std::mutex> lock(mu);
    size_t start = samples.size();
    samples.insert(samples.end(), data, data + n);
    // scan 20ms windows aligned to this push INCLUDING the final
    // partial window — the reference's samples.chunks(window) yields
    // the tail too (audio.rs:66); without it, sub-window pushes (10 ms
    // callbacks vs 20 ms windows) never get analyzed at all
    const int w = win();
    size_t nw = n / size_t(w);
    size_t n_scan = nw + ((n % size_t(w)) ? 1 : 0);
    for (size_t i = 0; i < n_scan; ++i) {
      size_t lo = i * size_t(w);
      size_t hi = std::min(lo + size_t(w), n);
      float r = rms(data + lo, hi - lo);
      if (r < noise_floor * kNoiseUpdateFactor &&
          noise_frames < kNoiseMaxFrames) {
        noise_floor = noise_floor * kEmaDecay + r * (1.0f - kEmaDecay);
        ++noise_frames;
      }
      if (r >= adaptive_threshold()) {
        last_speech_pos = start + hi;
      }
    }
  }

  bool has_silence_boundary() const {
    if (samples.empty() || last_speech_pos == 0) return false;
    size_t silence = samples.size() > last_speech_pos
                         ? samples.size() - last_speech_pos : 0;
    return silence >= size_t(sample_rate) * kMinSilenceMs / 1000;
  }

  // extract [0, split) with the retained overlap prepended; keep tail.
  // Returns byte count written (or required if out==nullptr).
  int64_t extract(size_t split, float* out, int64_t out_cap) {
    size_t overlap_n = size_t(sample_rate) * kOverlapMs / 1000;
    size_t total = overlap.size() + split;
    if (out == nullptr) return int64_t(total);
    if (int64_t(total) > out_cap) return -1;
    std::memcpy(out, overlap.data(), overlap.size() * sizeof(float));
    std::memcpy(out + overlap.size(), samples.data(), split * sizeof(float));
    size_t ostart = split > overlap_n ? split - overlap_n : 0;
    overlap.assign(samples.begin() + ostart, samples.begin() + split);
    samples.erase(samples.begin(), samples.begin() + split);
    return int64_t(total);
  }

  int64_t take_chunk_at_silence(float* out, int64_t cap) {
    std::lock_guard<std::mutex> lock(mu);
    if (!has_silence_boundary()) return 0;
    if (last_speech_pos < size_t(sample_rate) / 2) return 0;
    size_t split = last_speech_pos + (samples.size() - last_speech_pos) / 2;
    int64_t n = extract(split, out, cap);
    if (out != nullptr && n >= 0) last_speech_pos = 0;
    return n;
  }

  int64_t take_forced_chunk(float* out, int64_t cap) {
    std::lock_guard<std::mutex> lock(mu);
    if (samples.size() <= size_t(sample_rate) * kMaxBufferS) return 0;
    const int w = win();
    size_t search_start = samples.size() > size_t(5 * sample_rate)
                              ? samples.size() - 5 * sample_rate : 0;
    size_t quietest = search_start;
    float best = 1e30f;
    for (size_t p = search_start; p + w <= samples.size(); p += w) {
      float r = rms(samples.data() + p, w);
      if (r < best) { best = r; quietest = p; }
    }
    size_t split = std::min(quietest + size_t(w) / 2, samples.size());
    if (split < size_t(sample_rate) / 2) return 0;
    int64_t n = extract(split, out, cap);
    if (out != nullptr && n >= 0) {
      last_speech_pos = last_speech_pos > split ? last_speech_pos - split : 0;
    }
    return n;
  }

  int64_t take_all(float* out, int64_t cap) {
    std::lock_guard<std::mutex> lock(mu);
    if (out == nullptr) return int64_t(samples.size());
    if (int64_t(samples.size()) > cap) return -1;
    std::memcpy(out, samples.data(), samples.size() * sizeof(float));
    int64_t n = int64_t(samples.size());
    samples.clear();
    overlap.clear();
    last_speech_pos = 0;
    return n;
  }
};

}  // namespace

extern "C" {

// ---- streaming buffer -----------------------------------------------------

void* nwt_buffer_new(int sample_rate) {
  auto* b = new StreamBuffer();
  b->sample_rate = sample_rate;
  return b;
}

void nwt_buffer_free(void* h) { delete static_cast<StreamBuffer*>(h); }

void nwt_buffer_push(void* h, const float* data, int64_t n) {
  static_cast<StreamBuffer*>(h)->push(data, size_t(n));
}

int64_t nwt_buffer_len(void* h) {
  auto* b = static_cast<StreamBuffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);
  return int64_t(b->samples.size());
}

double nwt_buffer_noise_floor(void* h) {
  auto* b = static_cast<StreamBuffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);  // push() mutates it
  return b->noise_floor;
}

int64_t nwt_buffer_last_speech_pos(void* h) {
  auto* b = static_cast<StreamBuffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);  // push() mutates it
  return int64_t(b->last_speech_pos);
}

int nwt_buffer_has_silence_boundary(void* h) {
  auto* b = static_cast<StreamBuffer*>(h);
  std::lock_guard<std::mutex> lock(b->mu);
  return b->has_silence_boundary() ? 1 : 0;
}

// out==nullptr: return required capacity without consuming.
int64_t nwt_buffer_take_silence_chunk(void* h, float* out, int64_t cap) {
  return static_cast<StreamBuffer*>(h)->take_chunk_at_silence(out, cap);
}

int64_t nwt_buffer_take_forced_chunk(void* h, float* out, int64_t cap) {
  return static_cast<StreamBuffer*>(h)->take_forced_chunk(out, cap);
}

int64_t nwt_buffer_take_all(void* h, float* out, int64_t cap) {
  return static_cast<StreamBuffer*>(h)->take_all(out, cap);
}

// ---- offline VAD ------------------------------------------------------------

double nwt_estimate_noise_floor(const float* audio, int64_t n,
                                int sample_rate) {
  const int w = sample_rate / 50;
  std::vector<float> vals;
  for (int i = 0; i < kNoiseEstWindows; ++i) {
    int64_t start = int64_t(i) * w;
    if (start + w > n) break;
    vals.push_back(rms(audio + start, w));
  }
  if (vals.empty()) return kSilenceThreshold;
  std::sort(vals.begin(), vals.end());
  size_t idx = size_t(vals.size() * kNoisePercentile);
  float floor = vals[std::min(idx, vals.size() - 1)];
  return std::max(floor, kSilenceThreshold * kMinNoiseFloorFactor);
}

// Writes up to max_bounds boundary sample indices; returns the count.
int64_t nwt_find_silence_boundaries(const float* audio, int64_t n,
                                    int sample_rate, int64_t* bounds,
                                    int64_t max_bounds) {
  const int w = sample_rate / 50;
  const int64_t min_sil = int64_t(sample_rate) * kMinSilenceMs / 1000;
  const int64_t min_chunk = int64_t(sample_rate) * kMinChunkMs / 1000;
  float thresh =
      std::max(float(nwt_estimate_noise_floor(audio, n, sample_rate)) *
                   kNoiseFactor,
               kSilenceThreshold * kMinThresholdFactor);

  int64_t count = 0, last_boundary = 0, sil_start = -1;
  auto consider = [&](int64_t s, int64_t e) {
    if (e - s >= min_sil) {
      int64_t split = s + (e - s) / 2;
      if (split - last_boundary >= min_chunk && count < max_bounds) {
        bounds[count++] = split;
        last_boundary = split;
      }
    }
  };
  for (int64_t p = 0; p + w <= n; p += w) {
    if (rms(audio + p, w) < thresh) {
      if (sil_start < 0) sil_start = p;
    } else {
      if (sil_start >= 0) consider(sil_start, p);
      sil_start = -1;
    }
  }
  if (sil_start >= 0) consider(sil_start, n);
  return count;
}

// ---- windowed RMS (bulk helper) --------------------------------------------

void nwt_windowed_rms(const float* audio, int64_t n, int window,
                      float* out, int64_t n_out) {
  int64_t k = std::min(n / window, n_out);
  for (int64_t i = 0; i < k; ++i) out[i] = rms(audio + i * window, window);
}

// ---- polyphase resampler -----------------------------------------------------

// Windowed-sinc polyphase resample (up/down rational). Matches the Python
// polyphase filter design (24 taps/phase, Hamming window).
int64_t nwt_resample(const float* in, int64_t n_in, int in_rate,
                     int out_rate, float* out, int64_t out_cap) {
  if (in_rate == out_rate) {
    if (out == nullptr) return n_in;
    if (n_in > out_cap) return -1;
    std::memcpy(out, in, size_t(n_in) * sizeof(float));
    return n_in;
  }
  int64_t g = std::__gcd(int64_t(in_rate), int64_t(out_rate));
  int up = int(out_rate / g), down = int(in_rate / g);
  const int taps_per_phase = 24;
  const int n_taps = taps_per_phase * up;
  const double cutoff = 1.0 / std::max(up, down);

  std::vector<float> h(n_taps);
  for (int i = 0; i < n_taps; ++i) {
    double t = i - (n_taps - 1) / 2.0;
    double x = t * cutoff;
    double sinc = x == 0.0 ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
    double window =
        0.54 - 0.46 * std::cos(2.0 * M_PI * i / (n_taps - 1));
    h[i] = float(sinc * cutoff * up * window);
  }

  int64_t n_out = n_in * up / down;
  if (out == nullptr) return n_out;
  if (n_out > out_cap) return -1;

  for (int64_t j = 0; j < n_out; ++j) {
    int64_t phase = (j * int64_t(down)) % up;
    int64_t start = (j * int64_t(down)) / up + taps_per_phase / 2;
    double acc = 0.0;
    for (int k2 = 0; k2 < taps_per_phase; ++k2) {
      int64_t idx = start - k2;
      if (idx >= 0 && idx < n_in) {
        acc += double(in[idx]) * h[size_t(phase) + size_t(k2) * up];
      }
    }
    out[j] = float(acc);
  }
  return n_out;
}

}  // extern "C"
