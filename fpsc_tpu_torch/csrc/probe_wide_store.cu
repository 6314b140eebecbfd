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
// What bounds it.  per_row and block8 write rows * b * 4 bytes (6.3 MB
// at the defaults, 1.9 us at 3.35 TB/s).  But each carry is a chain of
// dependent f32 adds, 4 cycles each: per_row's 2,048 take 4.1 us at the
// 1.98 GHz SM clock, above the bytes, so per_row is bound by its chain
// and block8 (256 adds, 0.5 us) by its bytes.
//
// The design keeps the add the only step that one iteration waits on:
// - one thread per (carry row, column), the carry in a register; a block
//   is COLS columns by the 8 carry rows (kLauncherCols: 8 for block8,
//   96 blocks at b = 768, where 32 columns gave 24, and the eight lanes
//   of a carry row still store a full 32-byte sector);
// - the chain unrolled by kUnroll rows, the stores predicated (not
//   branched around), so that stores and address updates issue beside
//   the adds;
// - per_row: a store costs a warp more issue time than the 4 cycles an
//   add leaves it (on an H100, 6.7 cycles a row with a store, 4.1
//   without), and an SM more than one a row, so carry row 0's chain runs
//   on kStoreWarps = 4 warps (the one that holds it and 3 more) in each of
//   kRowBlocks = 4 blocks of a column group, the same adds in the same
//   order, each warp storing every 16th row (chain_every); the first
//   block's warps of the other carry rows run the chain alone and store
//   rows 0-7.  The repeat of the chain is the probe's own: the
//   sampler's chain is a GRU step, which it cannot repeat to spread its
//   one-sample stores, so this part of the design does not carry there.
// The barrier before the final store orders it after the stores of rows
// 0-7.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (plain C interface, loaded with ctypes).

#include <cuda_runtime.h>

namespace {

constexpr int kCarry = 8;
constexpr int kUnroll = 16;
// per_row's stores: kStoreWarps warps in each of kRowBlocks blocks
constexpr int kStoreWarps = 4, kRowBlocks = 4;
constexpr int kStores = kStoreWarps * kRowBlocks;  // divides kUnroll
constexpr float kStep = 1e-6f;
// columns a block of the launcher's instance of each arm (none, per_row,
// block8; probe_wide_store.LAUNCHER_COLS): per_row's 128-byte rows take
// the fewest store instructions, and its row blocks spread them; block8
// gains from blocks over more SMs
constexpr int kLauncherCols[3] = {8, 32, 8};

enum Arm { kNone, kPerRow, kBlock8 };

__device__ __forceinline__ void store_if(float* p, float v, bool on) {
  asm volatile(
      "{\n\t.reg .pred on;\n\tsetp.ne.b32 on, %2, 0;\n\t"
      "@on st.global.f32 [%0], %1;\n\t}" ::"l"(p),
      "f"(v), "r"((int)on)
      : "memory");
}

// q + n floats: an address update the compiler leaves as it is (it would
// merge chain_every's updates, one every kStores rows, into one a row).
__device__ __forceinline__ float* advance(float* q, int n) {
  float* r;
  asm("mad.wide.s32 %0, %1, 4, %2;" : "=l"(r) : "r"(n), "l"(q));
  return r;
}

// n adds of kStep to carry; with STORE, after add t the carry goes to
// p + t * stride where `on`.
template <bool STORE>
__device__ __forceinline__ float chain(float carry, int n, float* p,
                                       int stride, bool on) {
#pragma unroll 16
  for (int t = 0; t < n; ++t) {
    carry = __fadd_rn(carry, kStep);
    if (STORE) {
      store_if(p, carry, on);
      p = advance(p, stride);
    }
  }
  return carry;
}

// per_row's carry row 0 on one of kStoreWarps warps in each of
// kRowBlocks blocks, each of which runs the whole chain of n adds (the
// same adds in the same order, so the same values) and stores the rows t
// with t % kStores == R, t >= 8 (rows 0-7 take the final carry, from the
// first of the blocks).  A store costs its warp more issue time than the
// add's 4 cycles leave it, and an SM more than it takes to issue: spread
// over kStores warps on kRowBlocks SMs, each warp stores one row in
// kStores.
template <int R>
__device__ __forceinline__ float chain_every(float carry, int n, float* p,
                                             int stride, bool on) {
  float* q = p + (size_t)R * stride;
  const int step = kStores * stride;
  int t = 0;
  for (; t + kUnroll <= n; t += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      carry = __fadd_rn(carry, kStep);
      if (k % kStores == R) {
        store_if(q, carry, on && (t > 0 || R >= kCarry));
        q = advance(q, step);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (t + k < n) {
      carry = __fadd_rn(carry, kStep);
      if (k % kStores == R) {
        store_if(q, carry, on && t + k >= kCarry);
        q = advance(q, step);
      }
    }
  }
  return carry;
}

// Warps a block holds beyond the COLS x 8 carry threads: per_row's
// kStoreWarps - 1 further warps of carry row 0.
template <int ARM>
constexpr int kExtraWarps = ARM == kPerRow ? kStoreWarps - 1 : 0;

template <int ARM, int COLS>
__global__ void __launch_bounds__(COLS * kCarry + 32 * kExtraWarps<ARM>)
    wide_store_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int b, int rows) {
  const int lane = threadIdx.x & 31;
  const bool extra = threadIdx.x >= COLS * kCarry;  // a warp of the extra
  const int col_in = (extra ? lane : threadIdx.x) % COLS;
  const int c = extra ? 0 : threadIdx.x / COLS;
  const int col = blockIdx.x * COLS + col_in;
  const bool live = col < b && !extra;  // holds carry row c of its column
  float carry = col < b ? x[c * b + col] : 0.0f;
  if constexpr (ARM == kNone) {
    carry = chain<false>(carry, rows / kCarry, nullptr, 0, false);
  } else if constexpr (ARM == kBlock8) {
    carry = chain<true>(carry, rows / kCarry, out + (size_t)c * b + col,
                        kCarry * b, live);
  } else {
    const bool on = col < b && (extra ? lane < COLS : c == 0);
    const int w = extra ? 1 + (threadIdx.x - COLS * kCarry) / 32
                        : threadIdx.x < 32 ? 0 : -1;
    if (w < 0 && blockIdx.y > 0) return;  // a row block's other carry rows
    float* p = out + col;
#define FPSC_ROWS(R) \
  case R: carry = chain_every<R>(carry, rows, p, b, on); break;
    switch (w < 0 ? -1 : (int)blockIdx.y * kStoreWarps + w) {
      FPSC_ROWS(0) FPSC_ROWS(1) FPSC_ROWS(2) FPSC_ROWS(3)
      FPSC_ROWS(4) FPSC_ROWS(5) FPSC_ROWS(6) FPSC_ROWS(7)
      FPSC_ROWS(8) FPSC_ROWS(9) FPSC_ROWS(10) FPSC_ROWS(11)
      FPSC_ROWS(12) FPSC_ROWS(13) FPSC_ROWS(14) FPSC_ROWS(15)
      default:  // a warp without carry row 0
        carry = chain<false>(carry, rows, nullptr, 0, false);
    }
#undef FPSC_ROWS
    static_assert(kStores == 16, "one case a store warp");
  }
  if (blockIdx.y > 0) return;  // rows 0-7 are the first row block's
  __syncthreads();
  if (live) out[(size_t)c * b + col] = carry;
}

template <int COLS>
cudaError_t launch(int arm, const float* x, float* out, int b, int rows,
                   cudaStream_t s) {
  const int blocks = (b + COLS - 1) / COLS;
  constexpr int kThreads = COLS * kCarry;
  switch (arm) {
    case kNone: wide_store_kernel<kNone, COLS><<<blocks, kThreads, 0, s>>>(x, out, b, rows); break;
    case kPerRow:
      wide_store_kernel<kPerRow, COLS>
          <<<dim3(blocks, kRowBlocks), kThreads + 32 * kExtraWarps<kPerRow>,
             0, s>>>(x, out, b, rows);
      break;
    case kBlock8: wide_store_kernel<kBlock8, COLS><<<blocks, kThreads, 0, s>>>(x, out, b, rows); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// One template instance: `cols` columns a block (8 or 32, the
// launcher's for some arm).  Returns a cudaError_t code: 0 when the
// kernel was launched.
extern "C" int fpsc_probe_wide_store_variant(int arm, const float* x,
                                             float* out, int b, int rows,
                                             int cols, void* stream) {
  if (b <= 0 || rows < kCarry || rows % kCarry != 0 || !x || !out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 8: return (int)launch<8>(arm, x, out, b, rows, s);
    case 32: return (int)launch<32>(arm, x, out, b, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launcher's instance: kLauncherCols[arm] columns a block.  Returns
// a cudaError_t code: 0 when the kernel was launched.
extern "C" int fpsc_probe_wide_store(int arm, const float* x, float* out,
                                     int b, int rows, void* stream) {
  if (arm < kNone || arm > kBlock8) return (int)cudaErrorInvalidValue;
  return fpsc_probe_wide_store_variant(arm, x, out, b, rows,
                                       kLauncherCols[arm], stream);
}
