// Wide output stores for Hopper (sm_90a): per-row against 8-row stores
// of an (8, b) carry.
//
// Replaces the Pallas TPU kernel scripts/probe_wide_store.py::make ->
// kernel (38-50, pallas_call at 54).  The wrapper and the plain PyTorch
// version are in fpsc_tpu_torch/probes/probe_wide_store.py.
//
// Arms (arm = index in ARMS): 0 none, rows/8 iterations, no store in the
// loop; 1 per_row, rows iterations, carry row 0 stored at row t; 2
// block8, rows/8 iterations, the 8 rows stored at row 8t.  Each
// iteration adds 1e-6f to the carry; after the loop rows 0-7 take the
// final carry.  Rows that no arm writes stay as the caller allocated
// them.
//
// What bounds it.  The stores: per_row and block8 write rows * b * 4
// bytes (6.3 MB at the defaults, 1.9 us at 3.35 TB/s); the adds are b a
// row.  One thread per (carry row, column), the carry in a register;
// a block is 32 columns by the 8 carry rows, so a warp stores 32
// neighbouring floats of one row (128 bytes) at a time.  per_row leaves
// seven of the block's eight warps without a store, as the sampler
// kernel's one-sample stores do.  The barrier before the final store
// orders it after per_row's stores of rows 0-7 by the carry row 0
// threads.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (plain C interface, loaded with ctypes).

#include <cuda_runtime.h>

namespace {

constexpr int kCarry = 8;
constexpr int kCols = 32;

template <int ARM>
__global__ void __launch_bounds__(kCols * kCarry)
    wide_store_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int b, int rows) {
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int c = threadIdx.y;
  const bool live = col < b;
  float carry = live ? x[c * b + col] : 0.0f;
  const int n = ARM == 1 ? rows : rows / kCarry;
  for (int t = 0; t < n; ++t) {
    carry = __fadd_rn(carry, 1e-6f);
    if (ARM == 1 && c == 0 && live) out[(size_t)t * b + col] = carry;
    if (ARM == 2 && live) out[((size_t)kCarry * t + c) * b + col] = carry;
  }
  __syncthreads();
  if (live) out[(size_t)c * b + col] = carry;
}

}  // namespace

// Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int fpsc_probe_wide_store(int arm, const float* x, float* out,
                                     int b, int rows, void* stream) {
  if (b <= 0 || rows < kCarry || rows % kCarry != 0 || !x || !out)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kCols, kCarry), grid((b + kCols - 1) / kCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case 0: wide_store_kernel<0><<<grid, block, 0, s>>>(x, out, b, rows); break;
    case 1: wide_store_kernel<1><<<grid, block, 0, s>>>(x, out, b, rows); break;
    case 2: wide_store_kernel<2><<<grid, block, 0, s>>>(x, out, b, rows); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
