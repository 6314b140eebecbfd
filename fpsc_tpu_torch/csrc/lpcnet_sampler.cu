// Fused LPCNet sampler for Hopper (sm_90a), in every form of the TPU
// kernel: bunch=1, 2 or 4; a dense or a static block-sparse GRU_A
// recurrent matrix; f32, bf16 or int8 weights; the sampling cdf as a scan
// or as a product with a triangle of ones.
//
// Replaces the Pallas TPU kernel fpsc_tpu/ops/lpcnet_sampler.py::_kernel
// in its bunch=1 form (step 275-289), its bunch=2 form (step2 291-332,
// emb_many 157-183, the head operand fch 626-644), its bunch=4 form
// (step4 334-382, fch interleaved by position 631-638), its block-sparse
// GRU_A product (recurrent_a 193-217, pattern 437-473), its int8 weights
// (wdot 142-148, 208-215, 361-367; quantize_rows_int8 417-429) and its
// cdf_matmul draw (241-243, 613, 647-649), with gru_chain 260-273, draw
// 219-258 and _l2u_rows 79-84, launched by pallas_sample (659-706).  The
// wrapper and the plain PyTorch version with the same arithmetic are in
// fpsc_tpu_torch/ops/lpcnet_sampler.py.
//
// One GRU step emits BUNCH 16 kHz samples per batch item:
//   1. pred = -sum(hist * lpc_rev) over the 16-sample history;
//   2. mu-law indices of the GRU_A inputs (the TPU took their embeddings
//      as one-hot matmuls): the BUNCH newest samples, the BUNCH previous
//      excitations (oldest first), pred;
//   3. pre_a = wiemb @ e_cat + cond_a, as the sum over the slots s of
//      the rows ta[s, idx_s] of the folded table (below);
//   4. GRU_A gates on wh_a @ h_a + bh_a, dense, or per row block the sum
//      of its live column blocks' products (dead blocks are skipped, not
//      compacted);
//   5. GRU_B on wi_b @ h_a + cond_b and wh_b @ h_b + bh_b;
//   6. head 1, the dual FC [fc1; fc2] @ h_b + b, then draw: exp, 0.002*Z
//      tail cut, inclusive prefix sum (a Hillis-Steele scan, or with
//      cdf_mm one dot product per level, TRI @ p),
//      idx = #{cdf < u * cdf[255]}, mu-law table; x = pred + e;
//   7. each further sub-sample s: the history takes x, pred is
//      recomputed, head s = rows (s-1)*512 ... of fch @ [h_b, head
//      embeddings] + b, its h_b part taken with head 1's product and its
//      embedding part the sum of the rows th[s-1, slot, idx] of the
//      folded head table; draw with the next uniform; the head
//      embeddings are [x1, pred2] at bunch=2 and [hist[15], hist[14],
//      pred] at bunch=4 (kHead of them);
//   8. y = x + deemph * prev_y per sample; the step's excitations are
//      the next step's previous ones.
// Cast points are the TPU kernel's (bf16 build): cond and weights are
// bf16; the matmul operands e_cat, h_a, h_b and the head inputs are
// rounded to bf16 and the products accumulate in f32; biases, gates and
// state stay f32; exp takes the bf16-rounded logits*temp and its result
// is rounded to bf16.  The f32 build (weights in f32, no rounding)
// exists for parity checks.  int8 weights (W = int8_t, with either
// activation precision A) convert exactly to f32 in each product; the
// sum is multiplied by its output row's f32 scale, then the bias is
// added; an embedding element is q * s in f32, rounded to A.
//
// The fold (fold_kernel, fpsc_lpcnet_fold).  An embedding input is a row
// of a 256-entry table, so its product with a weight block is one of 256
// precomputable rows: ta[s, code, r] = sum_c wiemb[r, s*E + c] *
// emb_A(code, c), and th[s-1, slot, code, col] likewise from the head
// weights' embedding rows, as xiph/LPCNet's dump_lpcnet.py folds
// embed_sig into GRU_A.  bf16 x bf16 and bf16 x int8 products are exact
// in f32, so the fold changes only the order of the f32 sums; the
// tables stay f32 and the int8 row scales apply after the sum over the
// slots, as wdot applies them.  The wrapper folds at every call, on the
// stream of the sampler's launch, so wrong operands reach the tables:
// both tables in one launch.  The fold writes 5.9 + 1.0 MB of f32 tables
// at the flagship from 1.7 MB of weights, so the bytes bound it (8.7 MB,
// 2.6 us at 3.35 TB/s; its 0.44 GFLOP take 0.45 us on the tensor
// cores).  Each block computes a 64-code x 128-column tile over the
// whole of E from operands staged once in shared memory, on the tensor
// cores with bf16 activations (the products are exact; only the order
// and rounding of the f32 sums differ from fold_plain), with f32 FMAs
// otherwise, and writes it 16 bytes a store.
//
// What bounds it.  The step is a serial chain: each sample feeds the
// next, so the whole loop runs inside one thread block per batch item
// (Hopper blocks cannot carry state across a grid the way the TPU's
// sequential grid did).  The work of a step is far too small to fill
// the card, so the step is bound by the latency of its weight loads
// from L2, where the weights stay resident (they do not fit one SM's
// 227 KB of shared memory).  After the fold, a step reads per item, in
// bf16 at the flagship widths (GRU_A 384, E 128): 0.35 MB at bunch=2
// (GRU_B 32, 22 of 108 (64, 64) recurrent blocks live), 1.38 MB at
// bunch=4 (GRU_B 64, dense), 0.95 MB at bunch=1 (GRU_B 16, dense), of
// which the dense recurrent matrix is 0.88 MB; the unfolded embedding
// products were 1.7 MB of the flagship's 2.06.  Every weight product
// reads 16 bytes a thread a load (8 bf16, 4 f32 or 16 int8), with
// kDepth loads issued before the first is used: the recurrent product
// on kProdThreads threads, each kN consecutive output rows of the
// k-major matrix over a share of k (partial sums in shared memory),
// while the other warps gather the table rows; GRU_B's two products the
// same way (the input one on those threads, the recurrent one on the
// others); every head's product on h_b at once after GRU_B, kN rows a
// thread over the whole of k (the wrapper gives GRU_B's and the heads'
// weights k-major).  int8 weights convert four at a
// time with byte permutes and a float bias.  State (h_a, h_b, the
// history, the previous excitations, prev_y) lives in shared memory;
// __syncthreads() separates the phases; the draws, which are serial,
// run on warp 0, but for the cdf product, one level a thread on the
// first 8 warps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (plain C interface, loaded with ctypes).
// Twelve instances of sample_kernel: (f32, bf16, int8 with f32 or bf16
// activations) x bunch 1, 2, 4; sparsity and cdf_mm are run-time flags.
// Four of fold_kernel: the same weight and activation types, the bf16
// activations' two on the tensor cores.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;
// threads of the GRU_A recurrent product; the others gather the table
constexpr int kProdThreads = 288;
constexpr int kDepth = 16;       // 16-byte loads issued before the first use
constexpr int kLevels = 256;
constexpr int kPerLane = kLevels / 32;
constexpr int kFrame = 160;
constexpr int kOrder = 16;
constexpr int kIdx = 16;         // decision slots: 9 GRU_A + 3 head at most
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog256 = 5.545177444479562f;
constexpr float kMuScale = 255.0f / 32768.0f;

struct Args {
  const void* cond_a;     // (B, L, 3Ha)  A, input bias folded in
  const void* cond_b;     // (B, L, 3Hb)  A, input bias folded in
  const float* lpc_rev;   // (B, L, 16)   reversed LPC coefficients
  const float* temp;      // (B, L)       sharpening temperature
  const float* u;         // (L, B, 160)  uniforms
  const float* ta;        // (nE, 256, 3Ha) f32, GRU_A's folded input rows
  const void* wh_a_t;     // (Ha, 3Ha)    W, GRU_A recurrent weights, k-major
  const float* bh_a;      // (3Ha,)
  const void* wi_b_t;     // (Ha, 3Hb)    W, GRU_B input weights (h_a part),
                          //              k-major
  const void* wh_b_t;     // (Hb, 3Hb)    W, k-major
  const float* bh_b;      // (3Hb,)
  const void* heads_t;    // (Hb, 512*bunch) W, every head's weights on h_b,
                          //              k-major: [fc1; fc2], then block s
                          //              = [fc3_s; fc4_s]
  const float* fc_b;      // (512,)
  const float* u2l;       // (256,)       mu-law code -> linear
  const float* th;        // (bunch-1, kE, 256, 512) f32, the further heads'
                          //              folded embedding rows
  const float* fch_b;     // (512*(bunch-1),)
  // int8 weights only: the f32 scales of the output rows
  const float* s_wiemb;   // (3Ha,)
  const float* s_wh_a;    // (3Ha,)
  const float* s_wi_b;    // (3Hb,)
  const float* s_wh_b;    // (3Hb,)
  const float* s_fc;      // (512,)
  const float* s_fch;     // (512*(bunch-1),)
  const int* blk_ptr;     // (3Ha/rb + 1,) row block -> first live entry
  const int* blk_col;     // (n_live,)    live column blocks, pattern order
  float* out;             // (B, L*160)
  int* trace;             // (B, L*160/bunch, trace width) or null: the
                          // decisions of each step (ops/lpcnet_sampler.py
                          // sample_plain)
  int batch, frames, ha, hb;
  int rb, cb, n_live;     // rb = 0: dense GRU_A
  int cdf_mm;             // 1: the cdf as TRI @ p
  float deemph;
};

// Activation precision: the rounding of the matmul operands.
template <typename A> struct Prec;
template <> struct Prec<float> {
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <> struct Prec<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const int8_t* p) { return (float)*p; }

// 16 bytes of weights, read through the read-only path, and their kN
// values as f32.
__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename W> struct Wide;
template <> struct Wide<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
};
template <> struct Wide<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Wide<int8_t> {
  static constexpr int kN = 16;
  // byte b of x ^ 0x80808080 is q + 128; as the low mantissa byte of
  // 2^23 it gives the float 2^23 + q + 128 exactly
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned x = w[i] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + b))
                       - 8388736.0f;
    }
  }
};

// acc[i] += sum over k in [k, k + D) of w[k, r0 + i] * x[k], the D loads
// issued before the first is used; w k-major with row stride ld.
template <typename W, int D>
__device__ __forceinline__ void kmajor_batch(const W* w, int ld, int k,
                                             const float* x, float* acc) {
  constexpr int kN = Wide<W>::kN;
  uint4 v[D];
#pragma unroll
  for (int d = 0; d < D; ++d) v[d] = ld16(w + (size_t)(k + d) * ld);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float f[kN];
    Wide<W>::unpack(v[d], f);
    const float xk = x[k + d];
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = fmaf(f[i], xk, acc[i]);
  }
}

template <typename W>
__device__ __forceinline__ void kmajor_product(const W* w, int ld, int k0,
                                               int k1, const float* x,
                                               float* acc) {
  int k = k0;
  for (; k + kDepth <= k1; k += kDepth) kmajor_batch<W, kDepth>(w, ld, k, x, acc);
  for (; k + 4 <= k1; k += 4) kmajor_batch<W, 4>(w, ld, k, x, acc);
  for (; k < k1; ++k) kmajor_batch<W, 1>(w, ld, k, x, acc);
}

__device__ __forceinline__ void store_rows(float* dst, const float* acc, int n) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = 0; i < n / 4; ++i)
    d4[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                        acc[4 * i + 3]);
}

// Shares of k in a k-major product of `rows` output rows: groups of kn
// rows over `threads` threads.
__host__ __device__ inline int k_splits(int rows, int kn, int threads) {
  const int groups = rows / kn;
  return groups >= threads ? 1 : threads / groups;
}

// y = W^T x for a k-major W (k_len, rows): tasks of kN consecutive output
// rows over one of k_splits(rows, kN, nt) shares of k, on threads t, t +
// nt, ... of the nt given; share sp's sums go to part[sp * rows + r].
template <typename W>
__device__ __forceinline__ void kmajor_tasks(const W* w, int rows, int k_len,
                                             const float* x, float* part,
                                             int t, int nt) {
  constexpr int kN = Wide<W>::kN;
  const int n_grp = rows / kN, n_split = k_splits(rows, kN, nt);
  for (int task = t; task < n_grp * n_split; task += nt) {
    const int g = task % n_grp, sp = task / n_grp;
    float acc[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = 0.0f;
    kmajor_product<W>(w + g * kN, rows, k_len * sp / n_split,
                      k_len * (sp + 1) / n_split, x, acc);
    store_rows(part + sp * rows + g * kN, acc, kN);
  }
}

// A product's sum for output row r: times the row's scale with int8
// weights (wdot: the scale applies to the output, before the bias).
template <typename W>
__device__ __forceinline__ float scaled(float acc, const float* scale, int r) {
  if constexpr (std::is_same<W, int8_t>::value) {
    return acc * scale[r];
  } else {
    return acc;
  }
}

__device__ __forceinline__ int l2u_index(float v) {
  const float x = v * 32768.0f;
  const float s = (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
  const float u = s * (128.0f * log1pf(kMuScale * fabsf(x)) / kLog256);
  return (int)fminf(fmaxf(rintf(128.0f + u), 0.0f), 255.0f);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float lpc_pred(const float* hist, const float* lpc) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kOrder; ++i) acc += hist[i] * lpc[i];
  return -acc;
}

// Called by every thread of the block: the drawn mu-law code of the
// stacked dual-FC pre-activations fcpre[512] (bias included) at
// temperature temp and uniform uval, valid in warp 0.  Lane l of warp 0
// holds levels l + 32 * i.  The prefix sum is warp 0's register scan, or
// with cdf_mm one dot product over s_pc (512 floats of scratch, 16-byte
// aligned) per level.
template <typename P>
__device__ __forceinline__ int draw(const float* fcpre, float temp, float uval,
                                    bool cdf_mm, float* s_pc, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  float v[kPerLane];
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int l = lane + 32 * i;
      const float logit = tanhf(fcpre[l]) + tanhf(fcpre[kLevels + l]);
      v[i] = P::round(expf(P::round(logit * temp)));
    }
    float zsum = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) zsum += v[i];
    const float cut = 0.002f * warp_sum(zsum);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = fmaxf(v[i] - cut, 0.0f);
    if (cdf_mm) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) s_pc[lane + 32 * i] = v[i];
    } else {
      // inclusive Hillis-Steele scan: cdf[l] += cdf[l - k], k = 1..128.
      // Shifts below 32 cross lanes (level l - k sits in register i or
      // i - 1 of lane (lane - k) mod 32); shifts of 32m stay in-lane.
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        float sh[kPerLane];
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          sh[i] = __shfl_sync(kFull, v[i], (lane - k) & 31);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          v[i] += (lane >= k) ? sh[i] : (i > 0 ? sh[i - 1] : 0.0f);
      }
#pragma unroll
      for (int m = 1; m < kPerLane; m <<= 1)
#pragma unroll
        for (int i = kPerLane - 1; i >= m; --i) v[i] += v[i - m];
    }
  }
  if (cdf_mm) {
    // cdf[k] = sum_j TRI[k, j] pcut[j], TRI lower-triangular ones: the
    // f32 dot product of row k on thread k, over float4s of pcut, two
    // at a time into eight partial sums, so that loads stay in flight.
    __syncthreads();
    if (tid < kLevels) {
      const float4* p4 = reinterpret_cast<const float4*>(s_pc);
      const int n = tid + 1, nq = n >> 2;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
      int q = 0;
#pragma unroll 4
      for (; q + 2 <= nq; q += 2) {
        const float4 x = p4[q], y = p4[q + 1];
        a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
        b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
      }
      if (q < nq) {
        const float4 x = p4[q];
        a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      }
      float tail = 0.0f;
      for (int j = 4 * nq; j < n; ++j) tail += s_pc[j];
      s_pc[kLevels + tid] = (((a.x + b.x) + (a.y + b.y))
                             + ((a.z + b.z) + (a.w + b.w))) + tail;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) v[i] = s_pc[kLevels + lane + 32 * i];
    }
  }
  int code = 0;
  if (warp == 0) {
    const float total = __shfl_sync(kFull, v[kPerLane - 1], 31);
    const float thresh = uval * total;
    int below = 0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) below += (v[i] < thresh) ? 1 : 0;
    below = __reduce_add_sync(kFull, below);
    code = min(below, kLevels - 1);
  }
  return code;
}

__host__ __device__ constexpr int head_embeds(int bunch) {
  return bunch == 1 ? 0 : (bunch == 2 ? 2 : 3);
}

__host__ __device__ inline int take(int& at, int n) {
  const int here = at;
  at += (n + 3) & ~3;              // every array 16-byte aligned
  return here;
}

// Shared memory, in 4-byte words from a 16-byte-aligned base.
struct Layout {
  int pc, ha, har, hbin, xa, part, partb, hb, hbr, hfc, fc, hist, lpc, u2l,
      item, idx, bptr, bcol, words;
  __host__ __device__ Layout(const Args& a, int bunch, int kn) {
    const int ha3 = 3 * a.ha, hb3 = 3 * a.hb, n_rb = a.rb ? ha3 / a.rb : 0;
    const int part_a = k_splits(ha3, kn, kProdThreads) * ha3;
    const int part_b = k_splits(hb3, kn, kProdThreads) * hb3;
    int at = 0;
    pc = take(at, 2 * kLevels);              // cdf product: pcut, then cdf
    ha = take(at, a.ha);                     // GRU_A state
    har = take(at, a.ha);                    // rounded h_a (GRU_A in)
    hbin = take(at, a.ha);                   // rounded new h_a (GRU_B in)
    xa = take(at, ha3);                      // GRU_A's gathered input rows
    // partial sums: GRU_A's recurrent product, then GRU_B's input one
    part = take(at, part_a > part_b ? part_a : part_b);
    partb = take(at, k_splits(hb3, kn, kThreads - kProdThreads) * hb3);
    hb = take(at, a.hb);                     // GRU_B state
    hbr = take(at, a.hb);                    // rounded old h_b
    hfc = take(at, a.hb);                    // rounded new h_b (heads in)
    fc = take(at, bunch * 2 * kLevels);      // the heads' pre-activations
    hist = take(at, kOrder);                 // newest sample last
    lpc = take(at, kOrder);                  // this frame's lpc_rev
    u2l = take(at, kLevels);
    item = take(at, 8);        // pred, prev_y, temp, -, e_prev[BUNCH]
    idx = take(at, kIdx);                    // int
    bptr = take(at, n_rb + 1);               // int
    bcol = take(at, a.n_live);               // int
    words = at;
  }
};

// One thread block per batch item runs the item's whole sample loop.
// W: weight storage; A: activations' precision (and cond's type).
template <typename W, typename A, int BUNCH>
__global__ void __launch_bounds__(kThreads, 1) sample_kernel(Args a) {
  using P = Prec<A>;
  constexpr int kN = Wide<W>::kN;
  constexpr int kEmb = 2 * BUNCH + 1;
  constexpr int kHead = head_embeds(BUNCH);
  // decisions per step: the GRU_A indices and code 1, then for each
  // further sub-sample its head indices and code (trace_width)
  constexpr int kTrace = 2 * BUNCH + 2 + (BUNCH - 1) * (kHead + 1);
  constexpr int kSteps = kFrame / BUNCH;
  constexpr int kHeadRows = 2 * kLevels;
  extern __shared__ __align__(16) float smem[];
  const int ha = a.ha, hb = a.hb, ha3 = 3 * ha;
  const int frames = a.frames;
  const int n_rb = a.rb ? ha3 / a.rb : 0;
  const int hb3 = 3 * hb;
  const int n_grp = ha3 / kN, n_split = k_splits(ha3, kN, kProdThreads);
  const int n_split_bi = k_splits(hb3, kN, kProdThreads);
  const int n_split_bh = k_splits(hb3, kN, kThreads - kProdThreads);
  constexpr int kHeadAll = BUNCH * kHeadRows;
  // lanes that sum one GRU_B unit's shares of k: a power of two, as many
  // as the block has for every unit at once
  int gsz = 32;
  while (gsz > 1 && hb * gsz > kThreads) gsz >>= 1;
  const bool cdf_mm = a.cdf_mm != 0;
  const Layout lay(a, BUNCH, kN);
  int* smem_i = reinterpret_cast<int*>(smem);
  float* s_pc = smem + lay.pc;
  float* s_ha = smem + lay.ha;
  float* s_har = smem + lay.har;
  float* s_hbin = smem + lay.hbin;
  float* s_xa = smem + lay.xa;
  float* s_part = smem + lay.part;
  float* s_partb = smem + lay.partb;
  float* s_hb = smem + lay.hb;
  float* s_hbr = smem + lay.hbr;
  float* s_hfc = smem + lay.hfc;
  float* s_fc = smem + lay.fc;
  float* s_hist = smem + lay.hist;
  float* s_lpc = smem + lay.lpc;
  float* s_u2l = smem + lay.u2l;
  float* s_item = smem + lay.item;
  float* s_eprev = s_item + 4;    // previous excitations, oldest first
  int* s_idx = smem_i + lay.idx;
  int* s_bptr = smem_i + lay.bptr;
  int* s_bcol = smem_i + lay.bcol;

  const W* wh_a_t = static_cast<const W*>(a.wh_a_t);
  const W* wi_b_t = static_cast<const W*>(a.wi_b_t);
  const W* wh_b_t = static_cast<const W*>(a.wh_b_t);
  const W* heads_t = static_cast<const W*>(a.heads_t);

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  float* out = a.out + (size_t)b * frames * kFrame;
  int* trace = a.trace ? a.trace + (size_t)b * frames * kSteps * kTrace
                       : nullptr;

  for (int i = tid; i < ha; i += kThreads) s_ha[i] = 0.0f;
  for (int i = tid; i < hb; i += kThreads) s_hb[i] = 0.0f;
  for (int i = tid; i < kOrder; i += kThreads) s_hist[i] = 0.0f;
  if (tid < 8) s_item[tid] = 0.0f;
  for (int i = tid; i < kLevels; i += kThreads) s_u2l[i] = a.u2l[i];
  if (n_rb) {
    for (int i = tid; i <= n_rb; i += kThreads) s_bptr[i] = a.blk_ptr[i];
    for (int i = tid; i < a.n_live; i += kThreads) s_bcol[i] = a.blk_col[i];
  }
  __syncthreads();

  for (int f = 0; f < frames; ++f) {
    const size_t bf = (size_t)b * frames + f;
    const A* cond_a = static_cast<const A*>(a.cond_a) + bf * ha3;
    const A* cond_b = static_cast<const A*>(a.cond_b) + bf * 3 * hb;
    const float* u = a.u + ((size_t)f * a.batch + b) * kFrame;
    if (tid < kOrder) s_lpc[tid] = a.lpc_rev[bf * kOrder + tid];
    if (tid == 0) s_item[2] = a.temp[bf];
    __syncthreads();

    for (int t = 0; t < kSteps; ++t) {
      // 1-2: LPC prediction, mu-law indices, rounded state copies
      if (tid == 0) {
        const float pred = lpc_pred(s_hist, s_lpc);
        s_item[0] = pred;
#pragma unroll
        for (int i = 0; i < BUNCH; ++i) {
          s_idx[i] = l2u_index(s_hist[kOrder - BUNCH + i]);
          s_idx[BUNCH + i] = l2u_index(s_eprev[i]);
        }
        s_idx[2 * BUNCH] = l2u_index(pred);
      }
      for (int i = tid; i < ha; i += kThreads) s_har[i] = P::round(s_ha[i]);
      for (int i = tid; i < hb; i += kThreads) s_hbr[i] = P::round(s_hb[i]);
      __syncthreads();

      // 3-4a: GRU_A's products.  The recurrent one on kProdThreads
      // threads: kN consecutive output rows of the k-major matrix over
      // one share of k (of the live blocks' k in the sparse form) each,
      // into s_part; meanwhile the other warps sum the rows of the folded
      // input table in slot order, a float4 of rows at a time, into s_xa.
      if (tid < kProdThreads && !n_rb) {
        kmajor_tasks<W>(wh_a_t, ha3, ha, s_har, s_part, tid, kProdThreads);
      } else if (tid < kProdThreads) {
        for (int task = tid; task < n_grp * n_split; task += kProdThreads) {
          const int g = task % n_grp, sp = task / n_grp;
          const int r0 = g * kN;
          float acc[kN];
#pragma unroll
          for (int i = 0; i < kN; ++i) acc[i] = 0.0f;
          // the live column blocks of the row block, in pattern order, as
          // one run of n * cb values of k, split evenly
          const int rbk = r0 / a.rb, p0 = s_bptr[rbk];
          const int n = (s_bptr[rbk + 1] - p0) * a.cb;
          int q = n * sp / n_split;
          const int q1 = n * (sp + 1) / n_split;
          while (q < q1) {
            const int blk = q / a.cb, off = q - blk * a.cb;
            const int len = min(a.cb - off, q1 - q);
            const int k0 = s_bcol[p0 + blk] * a.cb + off;
            kmajor_product<W>(wh_a_t + r0, ha3, k0, k0 + len, s_har, acc);
            q += len;
          }
          store_rows(s_part + sp * ha3 + r0, acc, kN);
        }
      } else {
        for (int q = tid - kProdThreads; q < ha3 / 4;
             q += kThreads - kProdThreads) {
          float4 x[kEmb];
#pragma unroll
          for (int s = 0; s < kEmb; ++s)
            x[s] = __ldg(reinterpret_cast<const float4*>(
                a.ta + ((size_t)s * kLevels + s_idx[s]) * ha3) + q);
          float4 sum = x[0];
#pragma unroll
          for (int s = 1; s < kEmb; ++s) {
            sum.x += x[s].x; sum.y += x[s].y; sum.z += x[s].z; sum.w += x[s].w;
          }
          reinterpret_cast<float4*>(s_xa)[q] = sum;
        }
      }
      __syncthreads();

      // 4b: GRU_A's gates, one thread per unit j and its r, z, n rows;
      // int8 scales apply after the sum over the slots (input) and over
      // the shares of k (recurrent)
      for (int j = tid; j < ha; j += kThreads) {
        float gx[3], gh[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const int r = g * ha + j;
          float h = s_part[r];
          for (int sp = 1; sp < n_split; ++sp) h += s_part[sp * ha3 + r];
          gx[g] = scaled<W>(s_xa[r], a.s_wiemb, r) + ld(cond_a + r);
          gh[g] = scaled<W>(h, a.s_wh_a, r) + a.bh_a[r];
        }
        const float r = sigmoidf(gx[0] + gh[0]);
        const float z = sigmoidf(gx[1] + gh[1]);
        const float n = tanhf(gx[2] + r * gh[2]);
        const float h = (1.0f - z) * n + z * s_ha[j];
        s_ha[j] = h;
        s_hbin[j] = P::round(h);
      }
      __syncthreads();

      // 5: GRU_B's products as GRU_A's recurrent one, the input product
      // on kProdThreads threads and the recurrent one on the others, then
      // its gates, gsz lanes a unit summing the shares of k
      if (tid < kProdThreads)
        kmajor_tasks<W>(wi_b_t, hb3, ha, s_hbin, s_part, tid, kProdThreads);
      else
        kmajor_tasks<W>(wh_b_t, hb3, hb, s_hbr, s_partb, tid - kProdThreads,
                        kThreads - kProdThreads);
      __syncthreads();
      // (one pass of whole warps when gsz > 1)
      for (int t = tid; t < hb * gsz; t += kThreads) {
        const int j = t / gsz, sub = t - j * gsz;
        float x[3], h[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const int r = g * hb + j;
          x[g] = 0.0f;
          h[g] = 0.0f;
          for (int sp = sub; sp < n_split_bi; sp += gsz) x[g] += s_part[sp * hb3 + r];
          for (int sp = sub; sp < n_split_bh; sp += gsz) h[g] += s_partb[sp * hb3 + r];
          for (int o = gsz / 2; o > 0; o >>= 1) {
            x[g] += __shfl_xor_sync(kFull, x[g], o);
            h[g] += __shfl_xor_sync(kFull, h[g], o);
          }
        }
        if (sub == 0) {
          float gx[3], gh[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const int r = g * hb + j;
            gx[g] = scaled<W>(x[g], a.s_wi_b, r) + ld(cond_b + r);
            gh[g] = scaled<W>(h[g], a.s_wh_b, r) + a.bh_b[r];
          }
          const float r = sigmoidf(gx[0] + gh[0]);
          const float z = sigmoidf(gx[1] + gh[1]);
          const float n = tanhf(gx[2] + r * gh[2]);
          const float hn = (1.0f - z) * n + z * s_hb[j];
          s_hb[j] = hn;
          s_hfc[j] = P::round(hn);
        }
      }
      __syncthreads();

      // 6: every head's product on h_b, k-major, kN rows a thread over the
      // whole of k (no barrier to sum shares: at Hb 16-64 the chains are
      // short): head 1 ([fc1; fc2]) finished with scale and bias, the
      // further heads' h_b part kept for their sub-sample
      for (int g = tid; g < kHeadAll / kN; g += kThreads) {
        float acc[kN];
#pragma unroll
        for (int i = 0; i < kN; ++i) acc[i] = 0.0f;
        kmajor_product<W>(heads_t + g * kN, kHeadAll, 0, hb, s_hfc, acc);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const int r = g * kN + i;
          s_fc[r] = r < kHeadRows ? scaled<W>(acc[i], a.s_fc, r) + a.fc_b[r]
                                  : acc[i];
        }
      }
      __syncthreads();

#pragma unroll
      for (int s = 0; s < BUNCH; ++s) {
        float* fcs = s_fc + s * kHeadRows;
        if (s > 0) {
          // 7: head s: its h_b part plus the rows of the folded head
          // table at its kHead indices, in slot order; int8 scales after
          // the whole sum
          const float* tab = a.th + (size_t)(s - 1) * kHead * kLevels * kHeadRows;
          for (int i = tid; i < kHeadRows; i += kThreads) {
            float x[kHead > 0 ? kHead : 1];
#pragma unroll
            for (int k = 0; k < kHead; ++k)
              x[k] = __ldg(tab + ((size_t)k * kLevels + s_idx[kEmb + k]) * kHeadRows + i);
            float e = x[0];
#pragma unroll
            for (int k = 1; k < kHead; ++k) e += x[k];
            const int r = (s - 1) * kHeadRows + i;
            fcs[i] = scaled<W>(fcs[i] + e, a.s_fch, r) + a.fch_b[r];
          }
          __syncthreads();
        }
        // draw (warp 0, or the block for the cdf product), then thread 0
        // emits the sample
        const int code = draw<P>(fcs, s_item[2], u[BUNCH * t + s], cdf_mm,
                                 s_pc, tid);
        if (tid == 0) {
          const float e = s_u2l[code];
          const float x = s_item[0] + e;
#pragma unroll
          for (int i = 0; i < kOrder - 1; ++i) s_hist[i] = s_hist[i + 1];
          s_hist[kOrder - 1] = x;
          const float y = x + a.deemph * s_item[1];
          s_item[1] = y;
          s_eprev[s] = e;
          out[(size_t)f * kFrame + BUNCH * t + s] = y;
          if (trace) {
            int* tr = trace + ((size_t)f * kSteps + t) * kTrace;
            if (s == 0) {
#pragma unroll
              for (int i = 0; i < kEmb; ++i) tr[i] = s_idx[i];
              tr[kEmb] = code;
            } else {
              tr += kEmb + 1 + (s - 1) * (kHead + 1);
#pragma unroll
              for (int i = 0; i < kHead; ++i) tr[i] = s_idx[kEmb + i];
              tr[kHead] = code;
            }
          }
          if (s + 1 < BUNCH) {
            // the next sub-sample's pred, from the history that now ends
            // with x, and its head embeddings: the kHead - 1 newest
            // samples, newest first, then pred
            const float pred = lpc_pred(s_hist, s_lpc);
            s_item[0] = pred;
#pragma unroll
            for (int i = 0; i < kHead - 1; ++i)
              s_idx[kEmb + i] = l2u_index(s_hist[kOrder - 1 - i]);
            s_idx[kEmb + kHead - 1] = l2u_index(pred);
          }
        }
        __syncthreads();
      }
    }
  }
}

template <typename W, typename A, int BUNCH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)Layout(a, BUNCH, Wide<W>::kN).words * 4;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sample_kernel<W, A, BUNCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  sample_kernel<W, A, BUNCH><<<a.batch, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename W, typename A>
cudaError_t launch_bunch(const Args& a, int bunch, cudaStream_t stream) {
  switch (bunch) {
    case 1: return launch<W, A, 1>(a, stream);
    case 2: return launch<W, A, 2>(a, stream);
    case 4: return launch<W, A, 4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ fold

constexpr int kFoldThreads = 256;
constexpr int kFoldCodes = 64;   // codes (output rows) a tile
constexpr int kFoldCols = 128;   // output columns a tile
constexpr int kFoldMaxE = 256;

struct FoldTable {
  const void* w;   // (rows, ld) W, k-major weights
  float* out;      // (n_pos, n_slot, levels, cols) f32
  int ld, row0, n_pos, n_slot, cols;
  int tiles;       // n_pos n_slot x code tiles x column tiles; 0: none
};

struct FoldArgs {
  FoldTable t[2];       // GRU_A's table, then the heads' (if any)
  const void* emb;      // (levels, E) W, mu-law embedding
  const float* s_emb;   // (E,) its int8 scales, or null
  int e_dim, levels, code_tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A B, A 16 x 16 and B 16 x 8 bf16: the exact products summed in f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N f32 values into shared memory as bf16 (exact for bf16 and int8
// weights and for emb_A) or f32, 16 bytes a store.
template <int N>
__device__ __forceinline__ void put(__nv_bfloat16* dst, const float* v) {
#pragma unroll
  for (int j = 0; j < N; j += 8) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[j + 2 * i], v[j + 2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(dst + j) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}
template <int N>
__device__ __forceinline__ void put(float* dst, const float* v) {
#pragma unroll
  for (int j = 0; j < N; j += 4)
    *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
}

// Shared memory of a fold tile.  Tensor-core form (A = bf16): the
// embedding rows [code][E + 8] and the weights [c][kFoldCols + 8] in
// bf16 (rows 16 bytes apart modulo 128, so ldmatrix meets no bank
// conflict), then the f32 output tile [code][kFoldCols + 4] over them.
// f32 form: the embedding transposed [c][kFoldCodes] and the weights
// [c][kFoldCols] in f32.
template <typename A>
size_t fold_smem(int e) {
  if (!std::is_same<A, __nv_bfloat16>::value)
    return (size_t)e * (kFoldCodes + kFoldCols) * 4;
  const size_t staged = ((size_t)kFoldCodes * (e + 8) + (size_t)e * (kFoldCols + 8)) * 2;
  const size_t tile = (size_t)kFoldCodes * (kFoldCols + 4) * 4;
  return staged > tile ? staged : tile;
}

// out[p, s, code, col] = sum_c w[row0 + s*E + c, p*cols + col] *
// emb_A(code, c) for both tables of a `sample` call in one launch: block
// i is output tile i of the flat list of the two tables' tiles, kFoldCodes
// codes x kFoldCols columns of one (p, s) over the whole of E.  The tile's
// embedding rows (rounded to A as the sampler's plain version rounds
// them) and its weights are staged in shared memory once, 16 bytes a
// load, so every weight is read from L2 once a code tile.  bf16
// activations: the products on the tensor cores (mma.sync m16n8k16, A by
// ldmatrix, the k-major weights by ldmatrix.trans), each 16-deep partial
// sum added to the f32 sum with a round-to-nearest add; 8 warps of 32 x
// 32 outputs; the tile goes out through shared memory in 16-byte stores.
// f32 activations: f32 FMAs in the order of c, no TF32; 4 codes x 8
// columns a thread, 16-byte stores.
template <typename W, typename A>
__global__ void __launch_bounds__(kFoldThreads) fold_kernel(FoldArgs f) {
  extern __shared__ __align__(128) unsigned char fold_mem[];
  constexpr bool kMma = std::is_same<A, __nv_bfloat16>::value;
  constexpr int kN = Wide<W>::kN;
  const int E = f.e_dim;
  int tile = blockIdx.x;
  const bool second = tile >= f.t[0].tiles;
  const FoldTable tb = second ? f.t[1] : f.t[0];
  if (second) tile -= f.t[0].tiles;
  const int col_tiles = (tb.cols + kFoldCols - 1) / kFoldCols;
  const int col0 = (tile % col_tiles) * kFoldCols;
  tile /= col_tiles;
  const int code0 = (tile % f.code_tiles) * kFoldCodes;
  const int ps = tile / f.code_tiles;
  const int p = ps / tb.n_slot, s = ps - p * tb.n_slot;
  const W* w = static_cast<const W*>(tb.w) + (size_t)(tb.row0 + s * E) * tb.ld +
               (size_t)p * tb.cols + col0;
  const W* emb = static_cast<const W*>(f.emb) + (size_t)code0 * E;
  A* se = reinterpret_cast<A*>(fold_mem);
  const int lde = kMma ? E + 8 : kFoldCodes;
  A* sw = se + (kMma ? kFoldCodes * lde : E * kFoldCodes);
  constexpr int ldw = kMma ? kFoldCols + 8 : kFoldCols;

  // the embedding rows, emb_A: with int8 weights q * s rounded to A;
  // transposed in the f32 form, neighbouring threads on neighbouring codes
  for (int i = threadIdx.x; i < kFoldCodes * (E / kN); i += kFoldThreads) {
    const int r = kMma ? i / (E / kN) : i % kFoldCodes;
    const int c = (kMma ? i % (E / kN) : i / kFoldCodes) * kN;
    float v[kN];
    if (code0 + r < f.levels) {
      Wide<W>::unpack(ld16(emb + (size_t)r * E + c), v);
      if constexpr (std::is_same<W, int8_t>::value) {
#pragma unroll
        for (int j = 0; j < kN; ++j)
          v[j] = Prec<A>::round(__fmul_rn(v[j], f.s_emb[c + j]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) v[j] = 0.0f;
    }
    if constexpr (kMma) {
      put<kN>(se + r * lde + c, v);
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) se[(c + j) * kFoldCodes + r] = v[j];
    }
  }
  // the weights: E rows of kFoldCols columns, zero beyond the table
  for (int i = threadIdx.x; i < E * (kFoldCols / kN); i += kFoldThreads) {
    const int r = i / (kFoldCols / kN), c = (i - r * (kFoldCols / kN)) * kN;
    float v[kN];
    if (col0 + c < tb.cols) {
      Wide<W>::unpack(ld16(w + (size_t)r * tb.ld + c), v);
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) v[j] = 0.0f;
    }
    put<kN>(sw + r * ldw + c, v);
  }
  __syncthreads();

  float* out = tb.out + ((size_t)ps * f.levels + code0) * tb.cols + col0;
  if constexpr (kMma) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    // ldmatrix lane addresses: A rows lane & 15, depth + 8 for lanes
    // 16-31; B depth rows lane & 15, columns + 8 for lanes 16-31
    const uint32_t a_addr =
        smem_u32(se) + (uint32_t)(((wm * 32 + (lane & 15)) * lde + (lane >> 4) * 8) * 2);
    const uint32_t b_addr =
        smem_u32(sw) + (uint32_t)(((lane & 15) * ldw + wn * 32 + (lane >> 4) * 8) * 2);
    for (int k0 = 0; k0 < E; k0 += 16) {
      uint32_t af[2][4], bf[2][4];
      ldmatrix_x4(af[0], a_addr + k0 * 2);
      ldmatrix_x4(af[1], a_addr + (16 * lde + k0) * 2);
      ldmatrix_x4_trans(bf[0], b_addr + k0 * ldw * 2);
      ldmatrix_x4_trans(bf[1], b_addr + (k0 * ldw + 16) * 2);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(part, af[mt], bf[nt >> 1][2 * (nt & 1)],
                   bf[nt >> 1][2 * (nt & 1) + 1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], part[i]);
        }
    }
    __syncthreads();  // every warp has read the staged operands
    constexpr int ldo = kFoldCols + 4;
    float* so = reinterpret_cast<float*>(fold_mem);
    const int g = lane >> 2, tq = lane & 3;
    // acc[mt][nt]: rows wm*32 + mt*16 + g (+ 8 for the second pair),
    // columns wn*32 + nt*8 + 2 tq, + 1
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(so + (wm * 32 + mt * 16 + g + 8 * h) * ldo +
                                     wn * 32 + nt * 8 + 2 * tq) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    __syncthreads();
    for (int i = threadIdx.x; i < kFoldCodes * kFoldCols / 4; i += kFoldThreads) {
      const int r = i / (kFoldCols / 4), c = (i - r * (kFoldCols / 4)) * 4;
      if (code0 + r < f.levels && col0 + c < tb.cols)
        *reinterpret_cast<float4*>(out + (size_t)r * tb.cols + c) =
            *reinterpret_cast<const float4*>(so + r * ldo + c);
    }
  } else {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // 8 columns, 4 codes
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < E; ++c) {
      const float4 e4 = *reinterpret_cast<const float4*>(se + c * kFoldCodes + ty * 4);
      const float4 w0 = *reinterpret_cast<const float4*>(sw + c * ldw + tx * 8);
      const float4 w1 = *reinterpret_cast<const float4*>(sw + c * ldw + tx * 8 + 4);
      const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[j], ev[i], acc[i][j]);
    }
    if (col0 + tx * 8 < tb.cols) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (code0 + ty * 4 + i < f.levels) {
          float4* o = reinterpret_cast<float4*>(out + (size_t)(ty * 4 + i) * tb.cols +
                                                tx * 8);
          o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          o[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      }
    }
  }
}

template <typename W, typename A>
cudaError_t launch_fold(const FoldArgs& f, cudaStream_t stream) {
  const size_t smem = fold_smem<A>(f.e_dim);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fold_kernel<W, A>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fold_kernel<W, A><<<f.t[0].tiles + f.t[1].tiles, kFoldThreads, smem, stream>>>(f);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Returns a cudaError_t code: 0 when the kernel was launched.  act_bf16
// selects the activations' precision; the weights are int8 with w8, else
// of that precision.  The weights and tables must be 16-byte aligned, Ha
// and Hb multiples of 16, and a sparse row block a multiple of 16 rows.
extern "C" int fpsc_lpcnet_sample(
    int act_bf16, int bunch, int w8, int cdf_mm,
    const void* cond_a, const void* cond_b, const float* lpc_rev,
    const float* temp, const float* u, const float* ta,
    const void* wh_a_t, const float* bh_a,
    const void* wi_b_t, const void* wh_b_t, const float* bh_b,
    const void* heads_t, const float* fc_b, const float* u2l,
    const float* th, const float* fch_b,
    const float* s_wiemb, const float* s_wh_a,
    const float* s_wi_b, const float* s_wh_b, const float* s_fc,
    const float* s_fch,
    const int* blk_ptr, const int* blk_col, float* out, int* trace,
    int batch, int frames, int ha, int hb, int rb, int cb,
    int n_live, float deemph, void* stream) {
  if (batch <= 0 || frames <= 0 || ha <= 0 || hb <= 0 || ha % 16 ||
      hb % 16 || (bunch != 1 && bunch != 2 && bunch != 4) || !ta ||
      (bunch > 1 && (!th || !fch_b)))
    return (int)cudaErrorInvalidValue;
  const void* wide[] = {ta, wh_a_t, wi_b_t, wh_b_t, heads_t, th};
  for (const void* p : wide)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  if (w8 && (!s_wiemb || !s_wh_a || !s_wi_b || !s_wh_b || !s_fc ||
             (bunch > 1 && !s_fch)))
    return (int)cudaErrorInvalidValue;
  if (rb != 0 && (rb < 0 || rb % 16 || cb <= 0 || (3 * ha) % rb != 0 ||
                  ha % cb != 0 || n_live < 0 || !blk_ptr ||
                  (n_live > 0 && !blk_col)))
    return (int)cudaErrorInvalidValue;
  Args a{cond_a, cond_b, lpc_rev, temp, u, ta, wh_a_t, bh_a,
         wi_b_t, wh_b_t, bh_b, heads_t, fc_b, u2l, th, fch_b,
         s_wiemb, s_wh_a, s_wi_b, s_wh_b, s_fc, s_fch,
         blk_ptr, blk_col, out, trace, batch, frames, ha, hb,
         rb, cb, n_live, cdf_mm, deemph};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (w8)
    err = act_bf16 ? launch_bunch<int8_t, bf16>(a, bunch, s)
                   : launch_bunch<int8_t, float>(a, bunch, s);
  else
    err = act_bf16 ? launch_bunch<bf16, bf16>(a, bunch, s)
                   : launch_bunch<float, float>(a, bunch, s);
  return (int)err;
}

// The folded embedding tables of one `sample` call in one launch:
// n_tables (1 or 2) k-major weights, table i out_i (n_pos_i, n_slot_i,
// levels, cols_i) f32, out_i[p, s, code, col] = sum over c < e_dim of
// w_i[row0_i + s*e_dim + c, p*cols_i + col] * emb_A(code, c), w_i of row
// stride ld_i.  The weights, the embedding and the tables 16-byte
// aligned, ld_i and cols_i multiples of 16, e_dim a multiple of 16 up to
// kFoldMaxE.  Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int fpsc_lpcnet_fold(
    int act_bf16, int w8, const void* emb, const float* s_emb, int e_dim,
    int levels, int n_tables,
    const void* w0, int ld0, int row00, int n_pos0, int n_slot0, int cols0,
    float* out0,
    const void* w1, int ld1, int row01, int n_pos1, int n_slot1, int cols1,
    float* out1, void* stream) {
  if (!emb || !aligned16(emb) || e_dim <= 0 || e_dim % 16 ||
      e_dim > kFoldMaxE || levels <= 0 || (w8 && !s_emb) ||
      n_tables < 1 || n_tables > 2)
    return (int)cudaErrorInvalidValue;
  FoldArgs f{{{w0, out0, ld0, row00, n_pos0, n_slot0, cols0, 0},
              {w1, out1, ld1, row01, n_pos1, n_slot1, cols1, 0}},
             emb, s_emb, e_dim, levels, (levels + kFoldCodes - 1) / kFoldCodes};
  for (int i = 0; i < n_tables; ++i) {
    FoldTable& t = f.t[i];
    if (!t.w || !t.out || !aligned16(t.w) || !aligned16(t.out) || t.ld <= 0 ||
        t.ld % 16 || t.row0 < 0 || t.n_pos <= 0 || t.n_slot <= 0 ||
        t.cols <= 0 || t.cols % 16 || t.n_pos * t.cols > t.ld)
      return (int)cudaErrorInvalidValue;
    t.tiles = t.n_pos * t.n_slot * f.code_tiles *
              ((t.cols + kFoldCols - 1) / kFoldCols);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (w8)
    err = act_bf16 ? launch_fold<int8_t, bf16>(f, s)
                   : launch_fold<int8_t, float>(f, s);
  else
    err = act_bf16 ? launch_fold<bf16, bf16>(f, s)
                   : launch_fold<float, float>(f, s);
  return (int)err;
}
