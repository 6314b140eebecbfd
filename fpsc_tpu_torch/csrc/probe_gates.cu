// GRU_A gate evaluation for Hopper (sm_90a), chained: the probe of the
// sampler kernel's gate math.
//
// Replaces the Pallas TPU kernel scripts/probe_gates.py::make -> kernel
// (41-75, pallas_call at 85).  The wrapper and the plain PyTorch version
// are in fpsc_tpu_torch/probes/probe_gates.py.
//
// Arms (arm = index in ARMS): 0 none, h <- h + 1e-6; 1 gates_f32; 2
// gates_bf16, each `iters` times h <- 0.999 * gates(pre, gh, h) with
//   z = sigmoid(pre_z + gh_z), r = sigmoid(pre_r + gh_r),
//   n = tanh(pre_n + r * gh_n), gates = (1 - z) * n + z * h,
// pre and gh (3H, b) in the row order [z; r; n], h (H, b).  The bf16
// arm rounds where probe_gates.py:52-64 casts: pre and gh to bf16, the
// two gate sums, r before its product with gh_n, that product and its
// sum, and (1 - z) and n before their product, which is rounded too;
// sigmoid, tanh, z * h, the blend's sum and the state stay f32.
// Every operation rounds on its own (the __f*_rn intrinsics and the
// bf16 __hadd_rn / __hmul_rn: the plain __hmul is a mul.bf16 that the
// compiler may fuse with the following add into one FMA, which rounds
// once where the script rounds twice), as the plain version's
// operations do; expf and tanhf are the accurate ones.
//
// What bounds it.  Each element (j, i) needs pre[j | H+j | 2H+j, i],
// gh[...] and h[j, i] only, so one thread takes one element with h in
// a register over the whole chain: 294,912 threads at b = 768.  At 12
// f32 operations an element and evaluation (each elementary function
// counted once) that is 1.8e9 operations for 512 evaluations, 27 us at
// the 67 TFLOP/s f32 rate; the bytes (9.4 MB once) take 2.8 us.  pre and
// gh are loaded once; an empty asm statement tells the compiler that
// they may change in every iteration, as they do in the sampler, so
// that the gate math is not hoisted out of the chain.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (plain C interface, loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoidf(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ __nv_bfloat16 bf(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int ARM>
__global__ void __launch_bounds__(kThreads)
    gates_kernel(const float* __restrict__ pre, const float* __restrict__ gh,
                 const float* __restrict__ h0, float* __restrict__ out,
                 int hu, int b, int iters) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)hu * b) return;
  const long long plane = (long long)hu * b;
  float h = h0[idx];
  if (ARM == 0) {
    for (int t = 0; t < iters; ++t) h = __fadd_rn(h, 1e-6f);
    out[idx] = h;
    return;
  }
  float pz = pre[idx], pr = pre[plane + idx], pn = pre[2 * plane + idx];
  float gz = gh[idx], gr = gh[plane + idx], gn = gh[2 * plane + idx];
  for (int t = 0; t < iters; ++t) {
    asm volatile("" : "+f"(pz), "+f"(pr), "+f"(pn), "+f"(gz), "+f"(gr),
                 "+f"(gn));
    float blend, z;
    if (ARM == 1) {
      z = sigmoidf(__fadd_rn(pz, gz));
      const float r = sigmoidf(__fadd_rn(pr, gr));
      const float n = tanhf(__fadd_rn(pn, __fmul_rn(r, gn)));
      blend = __fmul_rn(__fsub_rn(1.0f, z), n);
    } else {
      z = sigmoidf(f32(__hadd_rn(bf(pz), bf(gz))));
      const float r = sigmoidf(f32(__hadd_rn(bf(pr), bf(gr))));
      const float n =
          tanhf(f32(__hadd_rn(bf(pn), __hmul_rn(bf(r), bf(gn)))));
      blend = f32(__hmul_rn(bf(__fsub_rn(1.0f, z)), bf(n)));
    }
    h = __fmul_rn(__fadd_rn(blend, __fmul_rn(z, h)), 0.999f);
  }
  out[idx] = h;
}

}  // namespace

// Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int fpsc_probe_gates(int arm, const float* pre, const float* gh,
                                const float* h, float* out, int hu, int b,
                                int iters, void* stream) {
  if (hu <= 0 || b <= 0 || iters < 0 || !pre || !gh || !h || !out)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)hu * b;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case 0: gates_kernel<0><<<grid, kThreads, 0, s>>>(pre, gh, h, out, hu, b, iters); break;
    case 1: gates_kernel<1><<<grid, kThreads, 0, s>>>(pre, gh, h, out, hu, b, iters); break;
    case 2: gates_kernel<2><<<grid, kThreads, 0, s>>>(pre, gh, h, out, hu, b, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
