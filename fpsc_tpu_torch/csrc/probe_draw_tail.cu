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
// As the sampler's draw, one warp takes one column, lane l the levels
// l + 32 i, i = 0 ... 7, in registers: a column sum is each lane's 8
// levels in order, then a butterfly of shuffles; the prefix sum is the
// sampler's in-register Hillis-Steele scan (cdf[l] += cdf[l - k],
// k = 1 ... 128: shuffles for k < 32, in-lane adds for 32, 64, 128).
// The tri arms take the prefix sum as the product with a triangle of
// ones, as the sampler's cdf_mm branch does: the warp writes the cut
// probabilities (rounded to bf16 for tri_bf16) to shared memory and each
// lane takes the dot products of its 8 triangle rows with them, all 256
// terms in order, an FMA by 1 or 0 each: 2,048 a lane and draw.  Every
// other operation rounds on its own (the __f*_rn intrinsics), as the
// plain version's do; expf and tanhf are the accurate ones.
//
// What bounds it.  About 13 f32 operations a level and draw (each
// elementary function counted once): 1.6e8 for 64 draws at b = 768,
// 2.4 us at the 67 TFLOP/s f32 rate; the operands (2.4 MB once) take 0.7
// us.  A draw is a chain of dependent steps inside one warp (two
// reductions and 8 scan stages of shuffles), so its latency, not the
// card's rate, sets the time: 768 warps fill the 132 SMs only about 1.5
// warps a scheduler.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (plain C interface, loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLevels = 256;
constexpr int kPerLane = kLevels / 32;
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

enum Arm { kEmpty, kFullDraw, kNoCumsum, kNoExp, kNoDecode, kNoTanh,
           kTriBf16, kTriF32 };

__device__ __forceinline__ float warp_sum(const float (&x)[kPerLane]) {
  float s = x[0];
#pragma unroll
  for (int i = 1; i < kPerLane; ++i) s = __fadd_rn(s, x[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

template <int ARM>
__global__ void __launch_bounds__(kWarps * 32)
    draw_kernel(const float* __restrict__ logits, const float* __restrict__ u2l,
                const float* __restrict__ u, float* __restrict__ out, int b,
                int iters) {
  __shared__ __align__(16) float s_pc[kWarps][kLevels];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kWarps + warp;
  if (col >= b) return;  // a whole warp; the kernel has no block barrier
  float v[kPerLane], w[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    v[i] = logits[(size_t)(lane + 32 * i) * b + col];
    w[i] = u2l[(size_t)(lane + 32 * i) * b + col];
  }
  const float uval = u[col];
  for (int t = 0; t < iters; ++t) {
    if (ARM == kEmpty) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) v[i] = __fadd_rn(v[i], 1e-6f);
      continue;
    }
    float c[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const float lg = ARM == kNoTanh
          ? __fadd_rn(__fmul_rn(v[i], 0.3f), __fmul_rn(v[i], 0.2f))
          : __fadd_rn(tanhf(v[i]), tanhf(v[i]));
      c[i] = ARM == kNoExp ? __fadd_rn(__fmul_rn(lg, 0.125f), 2.0f)
                           : expf(__fmul_rn(lg, 0.1f));
    }
    const float cut = __fmul_rn(0.002f, warp_sum(c));
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) c[i] = fmaxf(__fsub_rn(c[i], cut), 0.0f);
    if (ARM == kTriBf16 || ARM == kTriF32) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        s_pc[warp][lane + 32 * i] =
            ARM == kTriBf16 ? __bfloat162float(__float2bfloat16_rn(c[i]))
                            : c[i];
      __syncwarp();
      float acc[kPerLane] = {};
      for (int j = 0; j < kLevels; ++j) {
        const float pj = s_pc[warp][j];
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          acc[i] = fmaf(lane + 32 * i >= j ? 1.0f : 0.0f, pj, acc[i]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) c[i] = acc[i];
    } else if (ARM != kNoCumsum) {
      // the sampler's scan: level l - k sits in register i or i - 1 of
      // lane (lane - k) mod 32 for k < 32, in register i - k/32 above
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        float sh[kPerLane];
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          sh[i] = __shfl_sync(kFull, c[i], (lane - k) & 31);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          c[i] = __fadd_rn(c[i], lane >= k ? sh[i] : (i > 0 ? sh[i - 1] : 0.0f));
      }
#pragma unroll
      for (int m = 1; m < kPerLane; m <<= 1)
#pragma unroll
        for (int i = kPerLane - 1; i >= m; --i) c[i] = __fadd_rn(c[i], c[i - m]);
    }
    const float total = __shfl_sync(kFull, c[kPerLane - 1], 31);
    const float thresh = __fmul_rn(uval, total);
    float e;
    if (ARM == kNoDecode) {
      e = __fsub_rn(__shfl_sync(kFull, c[0], 0), thresh);
    } else {
      float below[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) below[i] = c[i] < thresh ? w[i] : 0.0f;
      e = warp_sum(below);
    }
    const float step = __fmul_rn(e, 1e-3f);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = __fadd_rn(v[i], step);
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    out[(size_t)(lane + 32 * i) * b + col] = v[i];
}

template <int ARM>
void launch(const float* logits, const float* u2l, const float* u, float* out,
            int b, int iters, cudaStream_t s) {
  draw_kernel<ARM><<<(b + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      logits, u2l, u, out, b, iters);
}

}  // namespace

// Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int fpsc_probe_draw_tail(int arm, const float* logits,
                                    const float* u2l, const float* u,
                                    float* out, int b, int iters,
                                    void* stream) {
  if (b <= 0 || iters < 0 || !logits || !u2l || !u || !out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case kEmpty: launch<kEmpty>(logits, u2l, u, out, b, iters, s); break;
    case kFullDraw: launch<kFullDraw>(logits, u2l, u, out, b, iters, s); break;
    case kNoCumsum: launch<kNoCumsum>(logits, u2l, u, out, b, iters, s); break;
    case kNoExp: launch<kNoExp>(logits, u2l, u, out, b, iters, s); break;
    case kNoDecode: launch<kNoDecode>(logits, u2l, u, out, b, iters, s); break;
    case kNoTanh: launch<kNoTanh>(logits, u2l, u, out, b, iters, s); break;
    case kTriBf16: launch<kTriBf16>(logits, u2l, u, out, b, iters, s); break;
    case kTriF32: launch<kTriF32>(logits, u2l, u, out, b, iters, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
