// Chained products on Hopper's tensor cores (sm_90a): int8 x int8 -> int32
// against bf16, and a one-hot int8 operand: the probe of int8 products
// for the sampler.
//
// Replaces the Pallas TPU kernels scripts/probe_i8_matmul.py::bf16_kernel
// and i8_kernel (34-55, pallas_call at 63 via run) and onehot_i8_kernel
// (89-104, pallas_call at 115 via run_emb).  The wrapper and the plain
// PyTorch version are in fpsc_tpu_torch/probes/probe_i8_matmul.py.
//
// Arms (arm = index in ARMS), each `iters` chained products of W (m,
// depth) with the (k, b) state x, of which rows [:k] become the next x:
//   0 bf16    x <- bf16(W @ x), W bf16, x rounded to bf16 first; mma.sync
//             m16n8k16 bf16 -> f32;
//   1 i8      xq = clip(rint(127 x), -127, 127) as int8, x <- f32(Wq @ xq)
//             * f32(1 / 127^2); mma.sync m16n8k32 s8 -> s32;
//   2 onehot  idx = int(clip(x[0], 0, 255)) truncated, x <- f32(W_emb @
//             onehot(idx)) * 1e-4f, W_emb (m, 256); mma.sync m16n8k32.
// The output is the last x in f32.  The i8 and onehot arms are exact
// (integer sums below 2^24); the bf16 arm's f32 sums follow the tensor
// cores' order.
//
// What bounds it.  The tensor cores: 2 m depth b operations a product,
// 7.2e9 for 64 bf16 products at (1152, 384) @ (384, 128), 7.3 us at 989
// TFLOP/s; 3.7 us for i8 and 2.4 us for onehot at 1,979 TOP/s; the
// bytes (1.3 MB once) take 0.4 us.  But each product needs every column
// of the one before, so all products run in one cooperative launch, a
// grid-wide barrier (cooperative_groups grid.sync) between them, the
// grid no larger than fits on the card at once.  Each warp takes 16 x 8
// output tiles in turn and runs the whole depth of each: A fragments
// straight from W (resident in L2), B fragments from the state, which
// is quantised (i8), turned into a one-hot (onehot) or read as bf16 as
// it is loaded.  The state lives in two ping-pong buffers read through
// L2 only (__ldcg), since other SMs wrote them.  All m rows are
// computed, as on the TPU, though only the first k feed the next
// product: the mma statements are volatile, so the rows that are not
// stored are not optimised away.  One barrier and one pass over W a
// product: latency, not the rate of the tensor cores, sets the time.
// wgmma and TMA are the later form.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (plain C interface, loaded with ctypes).

#include <cooperative_groups.h>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kEmbRows = 256;
// the f32 constants JAX multiplies by: Python floats rounded to f32
constexpr float kInv127Sq = (float)(1.0 / (127.0 * 127.0));
constexpr float kOneHotScale = 1e-4f;

enum Arm { kBf16, kI8, kOneHot };

struct Args {
  const void* w;
  const float* x;
  float* out;
  void* xbuf;
  int m, k, b, iters;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ldg32(const void* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// clip(round-half-even(127 v), -127, 127) as an int8 bit pattern
__device__ __forceinline__ uint32_t quantize(float v) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, 127.0f)), -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// Row r of the chain's state before product t: x itself for t = 0, else
// what product t - 1 wrote to buffer (t - 1) % 2.
template <typename T>
__device__ __forceinline__ const T* state(const Args& a, int t) {
  return reinterpret_cast<const T*>(a.xbuf) + (size_t)((t + 1) & 1) * a.k * a.b;
}

template <int ARM>
__global__ void __launch_bounds__(kThreads) chain_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int warp = (int)((blockIdx.x * kThreads + threadIdx.x) >> 5);
  const int n_warps = (int)(gridDim.x * kWarpsPerBlock);
  const int k = a.k, b = a.b;
  const int depth = ARM == kOneHot ? kEmbRows : k;
  const int tiles_n = b / 8, tiles = (a.m / 16) * tiles_n;
  for (int t = 0; t < a.iters; ++t) {
    const bool first = t == 0, last = t == a.iters - 1;
    for (int tile = warp; tile < tiles; tile += n_warps) {
      const int r0 = (tile / tiles_n) * 16, c0 = (tile % tiles_n) * 8;
      const int col = c0 + g;  // this lane's column of the B fragment
      const size_t w0 = (size_t)(r0 + g) * depth, w1 = w0 + (size_t)8 * depth;
      float v[4];
      if constexpr (ARM == kBf16) {
        const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(a.w);
        const unsigned short* X = state<unsigned short>(a, t);
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int k0 = 0; k0 < depth; k0 += 16) {
          const int kc = k0 + 2 * tq;
          const uint32_t af[4] = {ldg32(W + w0 + kc), ldg32(W + w1 + kc),
                                  ldg32(W + w0 + kc + 8),
                                  ldg32(W + w1 + kc + 8)};
          uint32_t bf[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t lo, hi;
            const int r = kc + 8 * h;
            if (first) {
              lo = __bfloat16_as_ushort(__float2bfloat16_rn(a.x[(size_t)r * b + col]));
              hi = __bfloat16_as_ushort(
                  __float2bfloat16_rn(a.x[(size_t)(r + 1) * b + col]));
            } else {
              lo = __ldcg(X + (size_t)r * b + col);
              hi = __ldcg(X + (size_t)(r + 1) * b + col);
            }
            bf[h] = lo | (hi << 16);
          }
          mma_bf16(d, af, bf);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = d[i];
      } else {
        const int8_t* W = static_cast<const int8_t*>(a.w);
        const float* X = first ? a.x : state<float>(a, t);
        int idx = 0;
        if (ARM == kOneHot)
          idx = (int)fminf(fmaxf(__ldcg(X + col), 0.0f), 255.0f);
        int d[4] = {0, 0, 0, 0};
#pragma unroll 4
        for (int k0 = 0; k0 < depth; k0 += 32) {
          const int kc = k0 + 4 * tq;
          const uint32_t af[4] = {ldg32(W + w0 + kc), ldg32(W + w1 + kc),
                                  ldg32(W + w0 + kc + 16),
                                  ldg32(W + w1 + kc + 16)};
          uint32_t bf[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = kc + 16 * h;
            uint32_t packed = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t q = ARM == kOneHot
                  ? (uint32_t)(r + e == idx)
                  : quantize(__ldcg(X + (size_t)(r + e) * b + col));
              packed |= q << (8 * e);
            }
            bf[h] = packed;
          }
          mma_s8(d, af, bf);
        }
        const float scale = ARM == kOneHot ? kOneHotScale : kInv127Sq;
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = __fmul_rn((float)d[i], scale);
      }
      if (r0 < k) {
        // d[i]: row r0 + g (+ 8 for i >= 2), column c0 + 2 tq (+ 1 for
        // odd i)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const size_t o = (size_t)(r0 + g + 8 * (i >> 1)) * b + c0 + 2 * tq + (i & 1);
          if (ARM == kBf16) {
            const __nv_bfloat16 r = __float2bfloat16_rn(v[i]);
            if (last)
              a.out[o] = __bfloat162float(r);
            else
              reinterpret_cast<__nv_bfloat16*>(a.xbuf)[(size_t)(t & 1) * k * b + o] = r;
          } else if (last) {
            a.out[o] = v[i];
          } else {
            reinterpret_cast<float*>(a.xbuf)[(size_t)(t & 1) * k * b + o] = v[i];
          }
        }
      }
    }
    grid.sync();
  }
}

template <int ARM>
cudaError_t launch(Args a, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel<ARM>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int tiles = (a.m / 16) * (a.b / 8);
  const int need = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = need < per_sm * sms ? need : per_sm * sms;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)chain_kernel<ARM>, blocks, kThreads,
                                    args, 0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the kernel was launched.  xbuf holds
// two (k, b) states: bf16 for the bf16 arm, else f32.
extern "C" int fpsc_probe_i8_matmul(int arm, const void* w, const float* x,
                                    float* out, void* xbuf, int m, int k, int b,
                                    int iters, void* stream) {
  if (m <= 0 || m % 16 != 0 || k <= 0 || k % 32 != 0 || k > m || b <= 0 ||
      b % 8 != 0 || iters < 1 || !w || !x || !out || !xbuf)
    return (int)cudaErrorInvalidValue;
  const Args a{w, x, out, xbuf, m, k, b, iters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case kBf16: return (int)launch<kBf16>(a, s);
    case kI8: return (int)launch<kI8>(a, s);
    case kOneHot: return (int)launch<kOneHot>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
