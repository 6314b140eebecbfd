// Host-side feature extractor (the framework's `dump_data`) of the
// PyTorch port.
//
// A copy of cpp/feature_extractor.cpp, the JAX package's, kept by the
// port (which builds and loads nothing of that package): built with g++
// by fpsc_tpu_torch/ops/host_build.py into build/host/ at first use and
// bound by fpsc_tpu_torch/data/native.py.  It implements the analysis of
// fpsc_tpu/dsp/frontend.py, which the port's dsp/frontend.py also
// implements (tests/test_torch_data.py holds this copy to the JAX
// package's native extractor, row for row):
//
//   per 10 ms frame: [18 Bark cepstra | pitch period feat | pitch corr
//                     | 16 LPC]
//
// Build:  g++ -O2 -shared -fPIC -o libfeatures.so feature_extractor.cpp
//         g++ -O2 -DFE_MAIN -o dump_features feature_extractor.cpp
// CLI:    dump_features <in.s16|in.f32> <out.f32> [s16|f32]
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kFrameSize = 160;
constexpr int kWindowSize = 320;
constexpr int kFreqSize = kWindowSize / 2 + 1;  // 161
constexpr int kNbBands = 18;
constexpr int kLpcOrder = 16;
constexpr int kNbFeatures = 36;
constexpr int kPitchMin = 32;
constexpr int kPitchMax = 256;
constexpr double kPi = 3.14159265358979323846;

const int kEband[kNbBands] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 10,
                              12, 14, 16, 20, 24, 28, 34, 40};
const float kCompensation[kNbBands] = {
    0.8f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 0.666667f, 0.5f,
    0.5f, 0.5f, 0.333333f, 0.25f, 0.25f, 0.2f, 0.166667f, 0.173913f};

struct Tables {
  float window[kWindowSize];
  // triangular band-summation matrix (FreqSize x NbBands)
  float band[kFreqSize][kNbBands];
  // DCT-II basis (i, j) = cos((i+.5) j pi/18), col 0 * sqrt(.5)
  float dct[kNbBands][kNbBands];
  // rfft cos/sin tables (bin, n)
  std::vector<float> fft_cos, fft_sin;

  Tables() {
    for (int n = 0; n < kWindowSize; ++n) {
      double t = (n + 0.5) / kWindowSize;
      double s = std::sin(kPi * t);
      window[n] = (float)std::sin(0.5 * kPi * s * s);
    }
    std::memset(band, 0, sizeof(band));
    for (int i = 0; i < kNbBands - 1; ++i) {
      int size = (kEband[i + 1] - kEband[i]) * 4;
      for (int j = 0; j < size; ++j) {
        double frac = (double)j / size;
        int k = kEband[i] * 4 + j;
        band[k][i] += (float)(1.0 - frac);
        band[k][i + 1] += (float)frac;
      }
    }
    for (int i = 0; i < kNbBands; ++i)
      for (int j = 0; j < kNbBands; ++j) {
        double v = std::cos((i + 0.5) * j * kPi / kNbBands);
        if (j == 0) v *= std::sqrt(0.5);
        dct[i][j] = (float)v;
      }
    fft_cos.resize((size_t)kFreqSize * kWindowSize);
    fft_sin.resize((size_t)kFreqSize * kWindowSize);
    for (int k = 0; k < kFreqSize; ++k)
      for (int n = 0; n < kWindowSize; ++n) {
        double ang = -2.0 * kPi * k * n / kWindowSize;
        fft_cos[(size_t)k * kWindowSize + n] = (float)std::cos(ang);
        fft_sin[(size_t)k * kWindowSize + n] = (float)std::sin(ang);
      }
  }
};

const Tables& tables() {
  static Tables t;
  return t;
}

// power spectrum of one vorbis-windowed frame, normalised by N
void power_spectrum(const float* frame, double* power) {
  const Tables& t = tables();
  float w[kWindowSize];
  for (int n = 0; n < kWindowSize; ++n) w[n] = frame[n] * t.window[n];
  for (int k = 0; k < kFreqSize; ++k) {
    double re = 0.0, im = 0.0;
    const float* c = &t.fft_cos[(size_t)k * kWindowSize];
    const float* s = &t.fft_sin[(size_t)k * kWindowSize];
    for (int n = 0; n < kWindowSize; ++n) {
      re += (double)w[n] * c[n];
      im += (double)w[n] * s[n];
    }
    power[k] = (re * re + im * im) / kWindowSize;
  }
}

void frame_cepstra(const float* frame, float* ceps) {
  const Tables& t = tables();
  double power[kFreqSize];
  power_spectrum(frame, power);
  double band_e[kNbBands] = {0};
  for (int k = 0; k < kFreqSize; ++k)
    for (int b = 0; b < kNbBands; ++b)
      band_e[b] += power[k] * t.band[k][b];
  double log_e[kNbBands];
  for (int b = 0; b < kNbBands; ++b)
    log_e[b] = std::log10(band_e[b] + 1e-7);
  const double scale = std::sqrt(2.0 / kNbBands);
  for (int j = 0; j < kNbBands; ++j) {
    double acc = 0.0;
    for (int i = 0; i < kNbBands; ++i) acc += log_e[i] * t.dct[i][j];
    ceps[j] = (float)(acc * scale);
  }
  ceps[0] -= 4.0f;
}

// Open-loop pitch, mirroring fpsc_tpu/dsp/frontend.py::estimate_pitch
// stage for stage (tests/test_native.py pins lag-for-lag agreement):
// 1. normalised autocorrelation over the step-2 lag grid (argmax,
//    smallest lag on ties),
// 2. octave-error suppression: round(L/2), round(L/3) snapped to the
//    even grid, judged against the ORIGINAL peak at
//    kOctaveThreshold * peak, smallest passing lag wins,
// 3. +-1 sample refinement around the winner,
// with frames whose even-grid peak correlation is <= 0 reporting
// kPitchMax directly — stages 2-3 are SKIPPED for such frames so an
// odd-lag refinement cannot flip an unvoiced frame to voiced with
// near-zero confidence (advisor round-2 finding).
constexpr double kOctaveThreshold = 0.7;

void pitch_features(const std::vector<float>& pad, int t, float* out) {
  int base = kPitchMax + t * kFrameSize;
  const float* seg = &pad[base];
  double e0 = 1e-9;
  for (int n = 0; n < kWindowSize; ++n) e0 += (double)seg[n] * seg[n];

  auto corr_at = [&](int lag) {
    const float* ref = &pad[base - lag];
    double num = 0.0, er = 1e-9;
    for (int n = 0; n < kWindowSize; ++n) {
      num += (double)seg[n] * ref[n];
      er += (double)ref[n] * ref[n];
    }
    return num / std::sqrt(e0 * er);
  };

  constexpr int kNumLags = (kPitchMax - kPitchMin) / 2 + 1;
  double corr[kNumLags];
  double best_corr = -1e30;
  int best_lag = kPitchMin;
  for (int i = 0; i < kNumLags; ++i) {
    corr[i] = corr_at(kPitchMin + 2 * i);
    if (corr[i] > best_corr) {  // strict: smallest lag wins ties
      best_corr = corr[i];
      best_lag = kPitchMin + 2 * i;
    }
  }

  if (best_corr <= 0.0) {  // unvoiced at the grid: skip stages 2-3
    out[0] = (float)((kPitchMax - 100.0) / 50.0);
    out[1] = (float)(0.0 - 0.5);
    return;
  }

  // stage 2: sub-lag preference from the ORIGINAL peak
  int pick_lag = best_lag;
  double pick_corr = best_corr;
  for (int div = 3; div >= 2; --div) {  // /3 judged first: smallest wins
    // round-half-up, matching the Python mirror's floor(x + .5)
    long cand = 2 * (long)std::floor(best_lag / (2.0 * div) + 0.5);
    if (cand < kPitchMin) cand = kPitchMin;
    if (cand > kPitchMax) cand = kPitchMax;
    double c = corr[(cand - kPitchMin) / 2];
    if (c > kOctaveThreshold * best_corr && cand < best_lag &&
        (div == 3 || pick_lag == best_lag)) {
      // div==3 always overrides; div==2 only if /3 did not pass
      pick_lag = (int)cand;
      pick_corr = c;
    }
  }

  // stage 3: +-1 refinement
  for (int delta = -1; delta <= 1; delta += 2) {
    int cand = pick_lag + delta;
    if (cand < kPitchMin) cand = kPitchMin;
    if (cand > kPitchMax) cand = kPitchMax;
    double c = corr_at(cand);
    if (c > pick_corr) {
      pick_corr = c;
      pick_lag = cand;
    }
  }

  if (pick_corr <= 0.0) {
    pick_lag = kPitchMax;
    pick_corr = 0.0;
  }
  out[0] = (float)((pick_lag - 100.0) / 50.0);
  out[1] = (float)(pick_corr - 0.5);
}

// Levinson-Durbin with the celt_lpc dual early exit
void levinson(const double* ac, float* lpc_out) {
  double error = ac[0];
  double lpc[kLpcOrder] = {0};
  if (ac[0] != 0.0) {
    for (int i = 0; i < kLpcOrder; ++i) {
      double rr = ac[i + 1];
      for (int j = 0; j < i; ++j) rr += lpc[j] * ac[i - j];
      double r = -rr / error;
      double old[kLpcOrder];
      std::memcpy(old, lpc, sizeof(old));
      for (int j = 0; j < i; ++j) lpc[j] = old[j] + r * old[i - 1 - j];
      lpc[i] = r;
      error -= r * r * error;
      if (error < ac[0] / 1024.0 || error < 0.001 * ac[0]) break;
    }
  }
  for (int i = 0; i < kLpcOrder; ++i) lpc_out[i] = (float)lpc[i];
}

// cepstra -> LPC (idct -> 10^x -> compensation -> band interp ->
// irfft autocorrelation -> noise floor + lag window -> levinson),
// mirroring fpsc_tpu/dsp/ceps2lpc.py (reference
// src/ceps2lpc/ceps2lpc_vct.py:122-161)
void ceps_to_lpc(const float* ceps, float* lpc_out) {
  const Tables& t = tables();
  double tmp[kNbBands];
  for (int i = 0; i < kNbBands; ++i) tmp[i] = ceps[i];
  tmp[0] += 4.0;
  const double scale = std::sqrt(2.0 / kNbBands);
  double ex[kNbBands];
  for (int i = 0; i < kNbBands; ++i) {
    double acc = 0.0;
    for (int j = 0; j < kNbBands; ++j) acc += tmp[j] * t.dct[i][j];
    ex[i] = std::pow(10.0, acc * scale) * kCompensation[i];
  }
  double xr[kFreqSize] = {0};
  for (int i = 0; i < kNbBands - 1; ++i) {
    int size = (kEband[i + 1] - kEband[i]) * 4;
    for (int j = 0; j < size; ++j) {
      double frac = (double)j / size;
      xr[kEband[i] * 4 + j] = (1.0 - frac) * ex[i] + frac * ex[i + 1];
    }
  }
  // irfft restricted to the first 17 lags
  double ac[kLpcOrder + 1];
  for (int k = 0; k <= kLpcOrder; ++k) {
    double acc = xr[0] + ((k % 2) ? -1.0 : 1.0) * xr[kFreqSize - 1];
    for (int j = 1; j < kFreqSize - 1; ++j)
      acc += 2.0 * xr[j] * std::cos(2.0 * kPi * j * k / kWindowSize);
    ac[k] = acc / kWindowSize;
  }
  ac[0] += ac[0] * 1e-4 + 320.0 / 12.0 / 38.0;
  for (int i = 1; i <= kLpcOrder; ++i) ac[i] *= 1.0 - 6e-5 * i * i;
  levinson(ac, lpc_out);
}

}  // namespace

extern "C" {

// x: n_samples floats in [-1, 1].  features: caller-allocated
// (n_frames x 36).  Returns n_frames = n_samples/160 - 1 (clamped >=0).
// Pre-emphasises internally (y[n] = x[n] - 0.85 x[n-1], LPCNet
// dump_data semantics) so the analysis domain matches the vocoder's
// synthesis-side de-emphasis; identical to the JAX frontend
// (fpsc_tpu/dsp/frontend.py, fpsc_tpu/dsp/emphasis.py).
int fe_extract_features(const float* x, int n_samples, float* features) {
  int n_frames = n_samples / kFrameSize - 1;
  if (n_frames < 0) n_frames = 0;
  std::vector<float> pad(kPitchMax + n_samples, 0.0f);
  constexpr float kPreemph = 0.85f;
  for (int i = 0; i < n_samples; ++i)
    pad[kPitchMax + i] = i ? x[i] - kPreemph * x[i - 1] : x[0];
  const float* s = &pad[kPitchMax];
  for (int t = 0; t < n_frames; ++t) {
    float* row = features + (size_t)t * kNbFeatures;
    frame_cepstra(s + t * kFrameSize, row);
    pitch_features(pad, t, row + kNbBands);
    ceps_to_lpc(row, row + kNbBands + 2);
  }
  return n_frames;
}

int fe_num_features() { return kNbFeatures; }

}  // extern "C"

#ifdef FE_MAIN
int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s <in.s16|in.f32> <out.f32> [s16|f32]\n",
                 argv[0]);
    return 2;
  }
  const char* fmt = argc > 3 ? argv[3] : "s16";
  FILE* in = std::fopen(argv[1], "rb");
  if (!in) { std::perror("open input"); return 1; }
  std::vector<float> x;
  if (std::strcmp(fmt, "s16") == 0) {
    int16_t buf[4096];
    size_t n;
    while ((n = std::fread(buf, sizeof(int16_t), 4096, in)) > 0)
      for (size_t i = 0; i < n; ++i) x.push_back(buf[i] / 32768.0f);
  } else {
    float buf[4096];
    size_t n;
    while ((n = std::fread(buf, sizeof(float), 4096, in)) > 0)
      x.insert(x.end(), buf, buf + n);
  }
  std::fclose(in);
  int max_frames = (int)x.size() / kFrameSize;
  std::vector<float> feats((size_t)std::max(max_frames, 1) * kNbFeatures);
  int n_frames = fe_extract_features(x.data(), (int)x.size(),
                                     feats.data());
  FILE* out = std::fopen(argv[2], "wb");
  if (!out) { std::perror("open output"); return 1; }
  std::fwrite(feats.data(), sizeof(float),
              (size_t)n_frames * kNbFeatures, out);
  std::fclose(out);
  std::fprintf(stderr, "%d frames -> %s\n", n_frames, argv[2]);
  return 0;
}
#endif
