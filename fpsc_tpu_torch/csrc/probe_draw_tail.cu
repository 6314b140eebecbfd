// The sampler's draw for Hopper (sm_90a), chained, with ablations: the
// probe of the draw in csrc/lpcnet_sampler.cu.
//
// Replaces the Pallas TPU kernel scripts/probe_draw_tail.py::make ->
// kernel (52-113, pallas_call at 118).  The wrapper and the plain
// PyTorch version are in fpsc_tpu_torch/probes/probe_draw_tail.py.
//
// Each column of the (256, b) logits is independent: `iters` times
// fcpre <- fcpre + 1e-3 * draw(fcpre), where draw is
//   logits = tanh(f) + tanh(f); p = exp(0.1 * logits);
//   pcut = max(p - 0.002 * sum(p), 0); cdf = inclusive prefix sum;
//   sum(u2l[l] for l with cdf[l] < u * cdf[255]).
// Arms (arm = index in ARMS): 0 empty (fcpre + 1e-6), 1 full, 2
// no_cumsum, 3 no_exp (0.125 * logits + 2), 4 no_decode (cdf[0] - u *
// total), 5 no_tanh (0.3 f + 0.2 f), 6 tri_bf16, 7 tri_f32.
//
// What bounds it.  About 13 f32 operations a level and draw (each
// elementary function counted once): 1.6e8 for 64 draws at b = 768,
// 2.4 us at the 67 TFLOP/s f32 rate; the operands (2.4 MB once) take 0.7
// us.  But a draw is a chain of dependent steps inside one column, and
// 256 or 768 columns do not fill the card's 528 warp schedulers twice
// over, so the latency of one draw sets the time; draw_sass.py counts
// the instructions a warp issues a draw, which bound it from below.
//
// The design cuts that latency:
// - levels blocked by lane: in the reductions lane j holds levels
//   8 j ... 8 j + 7 (register i: level 8 j + i).  A prefix sum is the
//   lane's 8 levels in order, a hypercube scan of the lane totals (5
//   shuffles, which leave every lane the column total, taken as level
//   255's), and the lane's offset added: 5 shuffles where the sampler's
//   Hillis-Steele scan takes 40.
// - one scan for the column sum and the cdf: the scan of p gives the
//   column sum (its total), hence the cut, and where no level of the
//   column is cut to 0 (a vote), the cdf is level l's prefix sum of p less
//   (l + 1) cuts, one multiply and one subtraction a level: the two
//   chains of 5 shuffles (a butterfly for the sum, then the scan of
//   pcut) become one.  A column with a level cut to 0 scans pcut.  (In
//   the full arm none is: tanh keeps p within e^+-0.2, so each level
//   holds more than 0.002 of the column.)
// - the decode as a count: pcut >= 0, so the levels with cdf < thresh
//   are the first n up to f32 rounding.  The warp counts them (a ballot
//   and a popcount a register) and reads the sum of u2l over levels 0 ...
//   n - 1 from u2l's prefix sums in shared memory, taken once before the
//   chain by the same scan (u2l does not change).  no_cumsum, whose
//   levels below are no prefix, and the full arm's `sum` variant sum
//   u2l over them as a tree of the lane's 8 and a butterfly instead.
// - two warps a column where columns are few (W = 2 while b * 2 warps
//   have a scheduler each, auto_warps; with these tile loads 4 and 8
//   warps were at best 1% faster at 8, 100 and 256 columns): each thread takes tanh and exp of 4 levels and
//   writes p to shared memory (two buffers, by the draw's parity); the
//   column's two warps meet at a named barrier (bar.sync id, 64), and
//   each of them reads all 256 p and runs the reductions itself, so one
//   barrier a draw suffices and every warp has the draw to update its
//   levels with.
// - operands: each block stages its columns' (256, columns) tiles of
//   u2l and logits through shared memory with coalesced loads, and
//   writes fcpre back the same way.
// The tri arms take the prefix sum as the product with a triangle of
// ones, as the sampler's cdf_mm branch does: each warp writes the cut
// probabilities (rounded to bf16 for tri_bf16) to shared memory and each
// lane takes the dot products of its 8 triangle rows with them, all 256
// terms in order, an FMA by 1 or 0 each: 2,048 a lane and draw.  Every
// other operation rounds on its own (the __f*_rn intrinsics), as the
// plain version's do; expf and tanhf are the accurate ones.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (plain C interface, loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLevels = 256;
constexpr int kLanes = 32;
constexpr int kPerLane = kLevels / kLanes;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSchedulers = 4;  // warp schedulers an SM
// The p buffer holds 4 floats of padding after every 32 levels, so that
// the 8 lanes of a phase of a 16-byte load (32 bytes apart) hit 8
// different groups of 4 banks.
constexpr int kPad = 4;
constexpr int kPStride = kLevels + kLevels / 32 * kPad;

enum Arm { kEmpty, kFullDraw, kNoCumsum, kNoExp, kNoDecode, kNoTanh,
           kTriBf16, kTriF32 };
enum Decode { kCount, kSum };

// W (1 or 2) warps a column; a block holds 4 warps.
template <int W>
struct Geometry {
  static_assert(W == 1 || W == 2, "one or two warps a column");
  static constexpr int kCols = 4 / W;                  // columns a block
  static constexpr int kThreads = kLanes * W * kCols;  // 128
  static constexpr int kOwn = kPerLane / W;  // levels a thread updates
};

__device__ __forceinline__ int padded(int level) {
  return level + (level >> 5) * kPad;
}

__device__ __forceinline__ float tree8(const float (&x)[kPerLane]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(x[0], x[1]), __fadd_rn(x[2], x[3])),
                   __fadd_rn(__fadd_rn(x[4], x[5]), __fadd_rn(x[6], x[7])));
}

// s += s[lane ^ o], o = 16 ... 1: every lane ends with the same sum.
__device__ __forceinline__ float butterfly(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// The inclusive prefix sums of a column whose lane j holds levels 8 j + i
// in x[i], in place -> the column total, which every lane holds and
// which is level 255's sum.  The lane totals (the lane's running sums'
// last) go through a hypercube scan: at k = 1, 2, 4, 8, 16 a lane takes
// the total of the aligned group of k lanes that holds lane ^ k (a
// shuffle), adds it to its offset if lane & k, and to its own group's
// total; the offset is added to the lane's running sums.  (Lane totals
// as trees of the 8 start the shuffles sooner, but cost one warp a
// column 9% at 768 columns: more instructions where warps share
// schedulers.)
__device__ __forceinline__ float blocked_scan(float (&x)[kPerLane],
                                              int lane) {
#pragma unroll
  for (int i = 1; i < kPerLane; ++i) x[i] = __fadd_rn(x[i - 1], x[i]);
  float total = x[kPerLane - 1], offset = 0.0f;
#pragma unroll
  for (int k = 1; k < kLanes; k <<= 1) {
    const float other = __shfl_xor_sync(kFull, total, k);
    if (lane & k) offset = __fadd_rn(offset, other);
    total = __fadd_rn(total, other);
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) x[i] = __fadd_rn(offset, x[i]);
  if (lane == kLanes - 1) x[kPerLane - 1] = total;
  return total;
}

__device__ __forceinline__ void column_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int ARM, int W, int DECODE>
__global__ void __launch_bounds__(Geometry<W>::kThreads)
    draw_kernel(const float* __restrict__ logits, const float* __restrict__ u2l,
                const float* __restrict__ u, float* __restrict__ out, int b,
                int iters) {
  using G = Geometry<W>;
  constexpr int kCols = G::kCols, kOwn = G::kOwn;
  constexpr bool kTri = ARM == kTriBf16 || ARM == kTriF32;
  constexpr bool kExchange = W > 1 && ARM != kEmpty;
  constexpr bool kHoldU2l = ARM == kNoCumsum || DECODE == kSum;
  constexpr bool kLookup = !kHoldU2l && ARM != kEmpty && ARM != kNoDecode;
  __shared__ __align__(16) float s_tile[kCols][kLevels];
  __shared__ float s_pre[kCols][kLookup ? kLevels + 1 : 1];
  __shared__ __align__(16)
      float s_p[kExchange ? kCols : 1][2][kExchange ? kPStride : 1];
  __shared__ __align__(16) float s_tri[kTri ? W * kCols : 1][kTri ? kLevels : 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cb = tid / (kLanes * W);  // the thread's column in the block
  const int t = tid % (kLanes * W);   // and its place in that column
  const int col0 = blockIdx.x * kCols, col = col0 + cb;
  const bool live = col < b;
  auto stage = [&](const float* src) {
    for (int idx = tid; idx < kLevels * kCols; idx += G::kThreads) {
      const int c = idx % kCols, l = idx / kCols;
      s_tile[c][l] = col0 + c < b ? src[(size_t)l * b + col0 + c] : 0.0f;
    }
  };
  auto lane_levels = [&](float (&x)[kPerLane]) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) x[i] = s_tile[cb][kPerLane * lane + i];
  };

  // u2l: held in registers for a float-sum decode, else its prefix sums
  // (with a 0 ahead) in shared memory, from the column's first warp
  float w[kPerLane];
  if (kHoldU2l || kLookup) {
    stage(u2l);
    __syncthreads();
  }
  if (kHoldU2l) lane_levels(w);
  if (kLookup && t < kLanes) {
    lane_levels(w);
    blocked_scan(w, lane);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) s_pre[cb][kPerLane * lane + i + 1] = w[i];
    if (lane == 0) s_pre[cb][0] = 0.0f;
  }
  __syncthreads();
  stage(logits);
  __syncthreads();
  float v[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) v[i] = s_tile[cb][kOwn * t + i];
  const float uval = live ? u[col] : 0.0f;

  for (int it = 0; live && it < iters; ++it) {
    if (ARM == kEmpty) {
#pragma unroll
      for (int i = 0; i < kOwn; ++i) v[i] = __fadd_rn(v[i], 1e-6f);
      continue;
    }
    float p[kPerLane];  // the first kOwn: this thread's levels
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const float lg = ARM == kNoTanh
          ? __fadd_rn(__fmul_rn(v[i], 0.3f), __fmul_rn(v[i], 0.2f))
          : __fadd_rn(tanhf(v[i]), tanhf(v[i]));
      p[i] = ARM == kNoExp ? __fadd_rn(__fmul_rn(lg, 0.125f), 2.0f)
                           : expf(__fmul_rn(lg, 0.1f));
    }
    float c[kPerLane];
    if constexpr (kExchange) {
      float* buf = s_p[cb][it & 1];
      *reinterpret_cast<float4*>(buf + padded(kOwn * t)) =
          make_float4(p[0], p[1], p[2], p[3]);
      column_barrier(1 + cb, kLanes * W);
      const float4* src =
          reinterpret_cast<const float4*>(buf + padded(kPerLane * lane));
      const float4 lo = src[0], hi = src[1];
      c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
      c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
    } else {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) c[i] = p[i];
    }
    // one scan of p gives the column sum (its total) and, where no level
    // is cut to 0, the cdf: level l's prefix sum less (l + 1) cuts
    float sums[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) sums[i] = c[i];
    // the lane's least p, taken while the scan's shuffles run, so that
    // only one compare waits for the cut
    const float low = fminf(fminf(fminf(c[0], c[1]), fminf(c[2], c[3])),
                            fminf(fminf(c[4], c[5]), fminf(c[6], c[7])));
    const float sum = blocked_scan(sums, lane);
    const float cut = __fmul_rn(0.002f, sum);
    const bool clipped = __any_sync(kFull, low < cut);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) c[i] = fmaxf(__fsub_rn(c[i], cut), 0.0f);
    float total;
    if constexpr (kTri) {
      float* tri = s_tri[warp];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        tri[kPerLane * lane + i] =
            ARM == kTriBf16 ? __bfloat162float(__float2bfloat16_rn(c[i]))
                            : c[i];
      __syncwarp();
      // row 8 lane + i takes level 8 mb + j by 1 where mb < lane, or
      // mb == lane and i >= j, else by 0: two factors a block of 8 levels
      float acc[kPerLane] = {};
      for (int mb = 0; mb < kLanes; ++mb) {
        const float le = mb <= lane ? 1.0f : 0.0f;
        const float lt = mb < lane ? 1.0f : 0.0f;
        const float4* src = reinterpret_cast<const float4*>(tri) + 2 * mb;
        const float4 lo = src[0], hi = src[1];
        const float pm[kPerLane] = {lo.x, lo.y, lo.z, lo.w,
                                    hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
#pragma unroll
          for (int i = 0; i < kPerLane; ++i)
            acc[i] = fmaf(i >= j ? le : lt, pm[j], acc[i]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) c[i] = acc[i];
      total = __shfl_sync(kFull, c[kPerLane - 1], kLanes - 1);
    } else if constexpr (ARM == kNoCumsum) {
      total = __shfl_sync(kFull, c[kPerLane - 1], kLanes - 1);
    } else if (clipped) {
      total = blocked_scan(c, lane);
    } else {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        c[i] = __fsub_rn(sums[i],
                         __fmul_rn((float)(kPerLane * lane + i + 1), cut));
      total = __fsub_rn(sum, __fmul_rn((float)kLevels, cut));
    }
    const float thresh = __fmul_rn(uval, total);
    float e;
    if constexpr (ARM == kNoDecode) {
      e = __fsub_rn(__shfl_sync(kFull, c[0], 0), thresh);
    } else if constexpr (kHoldU2l) {
      float below[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) below[i] = c[i] < thresh ? w[i] : 0.0f;
      e = butterfly(tree8(below));
    } else {
      int n[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        n[i] = __popc(__ballot_sync(kFull, c[i] < thresh));
      e = s_pre[cb][(n[0] + n[1] + n[2]) + (n[3] + n[4] + n[5]) +
                    (n[6] + n[7])];
    }
    const float step = __fmul_rn(e, 1e-3f);
#pragma unroll
    for (int i = 0; i < kOwn; ++i) v[i] = __fadd_rn(v[i], step);
  }

  // each thread wrote back only the levels it read, so the barrier need
  // only come before the tile's coalesced store
#pragma unroll
  for (int i = 0; i < kOwn; ++i) s_tile[cb][kOwn * t + i] = v[i];
  __syncthreads();
  for (int idx = tid; idx < kLevels * kCols; idx += G::kThreads) {
    const int c = idx % kCols, l = idx / kCols;
    if (col0 + c < b) out[(size_t)l * b + col0 + c] = s_tile[c][l];
  }
}

template <int ARM, int W, int DECODE>
cudaError_t launch(const float* logits, const float* u2l, const float* u,
                   float* out, int b, int iters, cudaStream_t s) {
  using G = Geometry<W>;
  draw_kernel<ARM, W, DECODE>
      <<<(b + G::kCols - 1) / G::kCols, G::kThreads, 0, s>>>(logits, u2l, u,
                                                            out, b, iters);
  return cudaGetLastError();
}

template <int ARM, int DECODE = kCount>
cudaError_t by_warps(int warps, const float* logits, const float* u2l,
                     const float* u, float* out, int b, int iters,
                     cudaStream_t s) {
  switch (warps) {
    case 1: return launch<ARM, 1, DECODE>(logits, u2l, u, out, b, iters, s);
    case 2: return launch<ARM, 2, DECODE>(logits, u2l, u, out, b, iters, s);
    default: return cudaErrorInvalidValue;
  }
}

// 2 warps a column while b * 2 warps have a scheduler each, else 1:
// probe_draw_tail.warps_per_column.
int auto_warps(int b) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return (long long)b * 2 <= (long long)kSchedulers * sms ? 2 : 1;
}

}  // namespace

extern "C" int fpsc_probe_draw_tail_warps(int b) { return auto_warps(b); }

// One template instance: `warps` a column (0: auto_warps(b)); for the
// full arm also decode 1 (the float sum).  Returns a cudaError_t code:
// 0 when the kernel was launched.
extern "C" int fpsc_probe_draw_tail_variant(int arm, const float* logits,
                                            const float* u2l, const float* u,
                                            float* out, int b, int iters,
                                            int warps, int decode,
                                            void* stream) {
  if (b <= 0 || iters < 0 || !logits || !u2l || !u || !out)
    return (int)cudaErrorInvalidValue;
  if (warps == 0) warps = auto_warps(b);
  if (decode < kCount || decode > kSum || (decode != kCount && arm != kFullDraw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = warps;
  switch (arm) {
    case kEmpty: return (int)by_warps<kEmpty>(w, logits, u2l, u, out, b, iters, s);
    case kFullDraw:
      if (decode == kSum)
        return (int)by_warps<kFullDraw, kSum>(w, logits, u2l, u, out, b, iters, s);
      return (int)by_warps<kFullDraw>(w, logits, u2l, u, out, b, iters, s);
    case kNoCumsum: return (int)by_warps<kNoCumsum>(w, logits, u2l, u, out, b, iters, s);
    case kNoExp: return (int)by_warps<kNoExp>(w, logits, u2l, u, out, b, iters, s);
    case kNoDecode: return (int)by_warps<kNoDecode>(w, logits, u2l, u, out, b, iters, s);
    case kNoTanh: return (int)by_warps<kNoTanh>(w, logits, u2l, u, out, b, iters, s);
    case kTriBf16: return (int)by_warps<kTriBf16>(w, logits, u2l, u, out, b, iters, s);
    case kTriF32: return (int)by_warps<kTriF32>(w, logits, u2l, u, out, b, iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launcher's instance.  Returns a cudaError_t code: 0 when the
// kernel was launched.
extern "C" int fpsc_probe_draw_tail(int arm, const float* logits,
                                    const float* u2l, const float* u,
                                    float* out, int b, int iters,
                                    void* stream) {
  return fpsc_probe_draw_tail_variant(arm, logits, u2l, u, out, b, iters, 0,
                                      kCount, stream);
}
