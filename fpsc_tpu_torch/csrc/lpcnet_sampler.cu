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
//   2. mu-law indices of the GRU_A inputs and their embedding rows
//      (the TPU took them as one-hot matmuls): the BUNCH newest samples,
//      the BUNCH previous excitations (oldest first), pred;
//   3. pre_a = wiemb @ e_cat + cond_a;  4. GRU_A gates on wh_a @ h_a + bh_a,
//      dense, or per row block the sum of its live column blocks'
//      products in pattern order (dead blocks are skipped, not
//      compacted);
//   5. GRU_B on wi_b @ h_a + cond_b and wh_b @ h_b + bh_b;
//   6. head 1, the dual FC [fc1; fc2] @ h_b + b, then draw: exp, 0.002*Z
//      tail cut, inclusive prefix sum (a Hillis-Steele scan, or with
//      cdf_mm one dot product per level, TRI @ p),
//      idx = #{cdf < u * cdf[255]}, mu-law table; x = pred + e;
//   7. each further sub-sample s: the history takes x, pred is
//      recomputed, head s = rows (s-1)*512 ... of fch @ [h_b, head
//      embeddings] + b, draw with the next uniform; the head embeddings
//      are [x1, pred2] at bunch=2 and [hist[15], hist[14], pred] at
//      bunch=4 (kHead of them);
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
// What bounds it.  The step is a serial chain: each sample feeds the
// next, so the whole loop runs inside one thread block per batch item
// (Hopper blocks cannot carry state across a grid the way the TPU's
// sequential grid did).  Per item and GRU step, at the flagship widths
// (GRU_A 384, GRU_B 32, E 128), bunch=2 with 22 of 108 (64, 64) blocks
// live does 1,031,168 MACs, bunch=4 at GRU_B 64 dense 2,576,384: far
// too little work per step to fill the card, so it is bound by the
// latency of the chain, not by bytes or FLOPs.  The weights (2.2 MB in
// bf16 at bunch=2, 2.9 MB at bunch=4, half that in int8) do not fit one
// SM's 227 KB of shared memory; here they are read from global memory at
// every step and stay resident in the 50 MB L2.  State (h_a, h_b, the
// history, the previous excitations, prev_y) lives in shared memory;
// __syncthreads() separates the phases.  The heads run on all 12 warps,
// one thread per output row; the draws, which are serial, on warp 0,
// but for the cdf product, one level a thread on the first 8 warps.
// Holding the weights in the distributed shared memory of a 16-block
// cluster is the redesign for a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (plain C interface, loaded with ctypes).
// Twelve instances of sample_kernel: (f32, bf16, int8 with f32 or bf16
// activations) x bunch 1, 2, 4; sparsity and cdf_mm are run-time flags.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
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
  const void* emb;        // (256, E)     W, mu-law embedding
  const void* wiemb_t;    // (nE, 3Ha)    W, GRU_A input weights, k-major
  const void* wh_a_t;     // (Ha, 3Ha)    W, GRU_A recurrent weights, k-major
  const float* bh_a;      // (3Ha,)
  const void* wi_b;       // (3Hb, Ha)    W, GRU_B input weights (h_a part)
  const void* wh_b;       // (3Hb, Hb)    W
  const float* bh_b;      // (3Hb,)
  const void* fc_w;       // (512, Hb)    W, [fc1; fc2]
  const float* fc_b;      // (512,)
  const float* u2l;       // (256,)       mu-law code -> linear
  const void* fch_t;      // (Hb+kE, 512*(bunch-1)) W, the further heads,
                          //              k-major, block s-1 = [fc3_s; fc4_s]
  const float* fch_b;     // (512*(bunch-1),)
  // int8 weights only: the f32 scales of the output rows
  const float* s_emb;     // (E,)
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
  int batch, frames, ha, hb, e_dim;
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

size_t smem_bytes(const Args& a, int bunch) {
  const size_t n_emb = 2 * (size_t)bunch + 1;
  const size_t floats = 3 * (size_t)a.ha           // h_a, rounded old and new
                        + n_emb * a.e_dim          // e_cat
                        + 3 * (size_t)a.hb         // h_b, rounded old and new
                        + head_embeds(bunch) * (size_t)a.e_dim  // head embs
                        + 2 * kLevels              // head pre-activations
                        + 2 * kOrder               // history, lpc
                        + kLevels + 8              // u2l, per-item scalars
                        + 2 * kLevels;             // cdf product scratch
  const size_t ints = kIdx + (a.rb ? 3 * (size_t)a.ha / a.rb + 1 + a.n_live : 0);
  return floats * sizeof(float) + ints * sizeof(int);
}

// One thread block per batch item runs the item's whole sample loop.
// W: weight storage; A: activations' precision (and cond's type).
template <typename W, typename A, int BUNCH>
__global__ void __launch_bounds__(kThreads, 1) sample_kernel(Args a) {
  using P = Prec<A>;
  constexpr bool kW8 = std::is_same<W, int8_t>::value;
  constexpr int kEmb = 2 * BUNCH + 1;
  constexpr int kHead = head_embeds(BUNCH);
  // decisions per step: the GRU_A indices and code 1, then for each
  // further sub-sample its head indices and code (trace_width)
  constexpr int kTrace = 2 * BUNCH + 2 + (BUNCH - 1) * (kHead + 1);
  constexpr int kSteps = kFrame / BUNCH;
  constexpr int kHeadLd = 2 * kLevels * (BUNCH > 1 ? BUNCH - 1 : 1);
  extern __shared__ __align__(16) float smem[];
  const int ha = a.ha, hb = a.hb, e_dim = a.e_dim, en = kEmb * a.e_dim;
  const int frames = a.frames;
  const int n_rb = a.rb ? 3 * ha / a.rb : 0;
  const bool cdf_mm = a.cdf_mm != 0;
  float* s_pc = smem;             // [512] cdf product: pcut, then cdf
  float* s_ha = s_pc + 2 * kLevels;  // [ha]  GRU_A state
  float* s_har = s_ha + ha;       // [ha]  rounded h_a (GRU_A in)
  float* s_hbin = s_har + ha;     // [ha]  rounded new h_a (GRU_B in)
  float* s_ecat = s_hbin + ha;    // [nE]  GRU_A input embeddings
  float* s_hb = s_ecat + en;      // [hb]  GRU_B state
  float* s_hbr = s_hb + hb;       // [hb]  rounded old h_b
  float* s_hfc = s_hbr + hb;      // [hb]  rounded new h_b (heads in)
  float* s_h2 = s_hfc + hb;       // [kHead*E] head embeddings
  float* s_fc = s_h2 + kHead * e_dim;  // [512] head pre-activations
  float* s_hist = s_fc + 2 * kLevels;  // [16] newest sample last
  float* s_lpc = s_hist + kOrder; // [16]  this frame's lpc_rev
  float* s_u2l = s_lpc + kOrder;  // [256]
  float* s_item = s_u2l + kLevels;  // pred, prev_y, temp, -, e_prev[BUNCH]
  float* s_eprev = s_item + 4;    // previous excitations, oldest first
  int* s_idx = reinterpret_cast<int*>(s_item + 8);  // [kIdx]
  int* s_bptr = s_idx + kIdx;     // [n_rb + 1]
  int* s_bcol = s_bptr + n_rb + 1;  // [n_live]

  const W* emb = static_cast<const W*>(a.emb);
  const W* wiemb_t = static_cast<const W*>(a.wiemb_t);
  const W* wh_a_t = static_cast<const W*>(a.wh_a_t);
  const W* wi_b = static_cast<const W*>(a.wi_b);
  const W* wh_b = static_cast<const W*>(a.wh_b);
  const W* fc_w = static_cast<const W*>(a.fc_w);
  const W* fch_t = static_cast<const W*>(a.fch_t);
  // an embedding element: the table's, or q * s rounded to A
  auto emb_at = [&](int idx, int c) -> float {
    const float w = ld(emb + (size_t)idx * e_dim + c);
    if constexpr (kW8) {
      return P::round(w * a.s_emb[c]);
    } else {
      return w;
    }
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
    const A* cond_a = static_cast<const A*>(a.cond_a) + bf * 3 * ha;
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
      for (int i = tid; i < en; i += kThreads) {
        const int slot = i / e_dim, c = i - slot * e_dim;
        s_ecat[i] = emb_at(s_idx[slot], c);
      }
      __syncthreads();

      // 3-4: GRU_A, one thread per unit j holding its r, z, n rows
      for (int j = tid; j < ha; j += kThreads) {
        float ax0 = 0.0f, ax1 = 0.0f, ax2 = 0.0f;
        float ah0 = 0.0f, ah1 = 0.0f, ah2 = 0.0f;
        const W* wx = wiemb_t + j;
#pragma unroll 4
        for (int k = 0; k < en; ++k) {
          const W* row = wx + (size_t)k * 3 * ha;
          const float x = s_ecat[k];
          ax0 = fmaf(ld(row), x, ax0);
          ax1 = fmaf(ld(row + ha), x, ax1);
          ax2 = fmaf(ld(row + 2 * ha), x, ax2);
        }
        if (n_rb) {
          // rows j, ha + j, 2ha + j lie in three row blocks, each with
          // its own live list; with 64-row blocks a warp's 32 units
          // share their row blocks, so the loops do not diverge
          float ah[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const int r = g * ha + j;
            const int rbk = r / a.rb;
            const W* wr = wh_a_t + r;
            float acc = 0.0f;
            for (int p = s_bptr[rbk]; p < s_bptr[rbk + 1]; ++p) {
              const int k0 = s_bcol[p] * a.cb;
              float part = 0.0f;
#pragma unroll 4
              for (int k = k0; k < k0 + a.cb; ++k)
                part = fmaf(ld(wr + (size_t)k * 3 * ha), s_har[k], part);
              acc += part;
            }
            ah[g] = acc;
          }
          ah0 = ah[0]; ah1 = ah[1]; ah2 = ah[2];
        } else {
          const W* wr = wh_a_t + j;
#pragma unroll 4
          for (int k = 0; k < ha; ++k) {
            const W* row = wr + (size_t)k * 3 * ha;
            const float x = s_har[k];
            ah0 = fmaf(ld(row), x, ah0);
            ah1 = fmaf(ld(row + ha), x, ah1);
            ah2 = fmaf(ld(row + 2 * ha), x, ah2);
          }
        }
        // int8: the recurrent scale applies after the column-block sum
        ax0 = scaled<W>(ax0, a.s_wiemb, j);
        ax1 = scaled<W>(ax1, a.s_wiemb, ha + j);
        ax2 = scaled<W>(ax2, a.s_wiemb, 2 * ha + j);
        ah0 = scaled<W>(ah0, a.s_wh_a, j);
        ah1 = scaled<W>(ah1, a.s_wh_a, ha + j);
        ah2 = scaled<W>(ah2, a.s_wh_a, 2 * ha + j);
        const float r = sigmoidf((ax0 + ld(cond_a + j)) + (ah0 + a.bh_a[j]));
        const float z = sigmoidf((ax1 + ld(cond_a + ha + j)) + (ah1 + a.bh_a[ha + j]));
        const float n = tanhf((ax2 + ld(cond_a + 2 * ha + j)) + r * (ah2 + a.bh_a[2 * ha + j]));
        const float h = (1.0f - z) * n + z * s_ha[j];
        s_ha[j] = h;
        s_hbin[j] = P::round(h);
      }
      __syncthreads();

      // 5: GRU_B, one warp per unit, lanes split the inner dimension
      for (int uu = warp; uu < hb; uu += kWarps) {
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
        for (int k = lane; k < ha; k += 32) {
          const float x = s_hbin[k];
          a0 = fmaf(ld(wi_b + (size_t)uu * ha + k), x, a0);
          a1 = fmaf(ld(wi_b + (size_t)(hb + uu) * ha + k), x, a1);
          a2 = fmaf(ld(wi_b + (size_t)(2 * hb + uu) * ha + k), x, a2);
        }
        for (int k = lane; k < hb; k += 32) {
          const float x = s_hbr[k];
          c0 = fmaf(ld(wh_b + uu * hb + k), x, c0);
          c1 = fmaf(ld(wh_b + (hb + uu) * hb + k), x, c1);
          c2 = fmaf(ld(wh_b + (2 * hb + uu) * hb + k), x, c2);
        }
        a0 = warp_sum(a0); a1 = warp_sum(a1); a2 = warp_sum(a2);
        c0 = warp_sum(c0); c1 = warp_sum(c1); c2 = warp_sum(c2);
        if (lane == 0) {
          a0 = scaled<W>(a0, a.s_wi_b, uu);
          a1 = scaled<W>(a1, a.s_wi_b, hb + uu);
          a2 = scaled<W>(a2, a.s_wi_b, 2 * hb + uu);
          c0 = scaled<W>(c0, a.s_wh_b, uu);
          c1 = scaled<W>(c1, a.s_wh_b, hb + uu);
          c2 = scaled<W>(c2, a.s_wh_b, 2 * hb + uu);
          const float r = sigmoidf((a0 + ld(cond_b + uu)) + (c0 + a.bh_b[uu]));
          const float z = sigmoidf((a1 + ld(cond_b + hb + uu)) + (c1 + a.bh_b[hb + uu]));
          const float n = tanhf((a2 + ld(cond_b + 2 * hb + uu)) + r * (c2 + a.bh_b[2 * hb + uu]));
          const float h = (1.0f - z) * n + z * s_hb[uu];
          s_hb[uu] = h;
          s_hfc[uu] = P::round(h);
        }
      }
      __syncthreads();

      // 6: head 1 on all warps, one thread per output row of [fc1; fc2]
      for (int i = tid; i < 2 * kLevels; i += kThreads) {
        const W* row = fc_w + (size_t)i * hb;
        float d = 0.0f;
        for (int k = 0; k < hb; ++k) d = fmaf(ld(row + k), s_hfc[k], d);
        s_fc[i] = scaled<W>(d, a.s_fc, i) + a.fc_b[i];
      }
      __syncthreads();

#pragma unroll
      for (int s = 0; s < BUNCH; ++s) {
        if (s > 0) {
          // 7: head s on [h_b, its kHead embeddings], one thread per row
          // of the row block (s-1)*512 of fch (a column block of fch_t)
          for (int i = tid; i < kHead * e_dim; i += kThreads) {
            const int slot = i / e_dim, c = i - slot * e_dim;
            s_h2[i] = emb_at(s_idx[kEmb + slot], c);
          }
          __syncthreads();
          const int r0 = (s - 1) * 2 * kLevels;
          for (int i = tid; i < 2 * kLevels; i += kThreads) {
            const W* col = fch_t + r0 + i;
            float d = 0.0f;
            for (int k = 0; k < hb; ++k)
              d = fmaf(ld(col + (size_t)k * kHeadLd), s_hfc[k], d);
            for (int k = 0; k < kHead * e_dim; ++k)
              d = fmaf(ld(col + (size_t)(hb + k) * kHeadLd), s_h2[k], d);
            s_fc[i] = scaled<W>(d, a.s_fch, r0 + i) + a.fch_b[r0 + i];
          }
          __syncthreads();
        }
        // draw (warp 0, or the block for the cdf product), then thread 0
        // emits the sample
        const int code = draw<P>(s_fc, s_item[2], u[BUNCH * t + s], cdf_mm,
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
  const size_t smem = smem_bytes(a, BUNCH);
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

}  // namespace

// Returns a cudaError_t code: 0 when the kernel was launched.  act_bf16
// selects the activations' precision; the weights are int8 with w8, else
// of that precision.
extern "C" int fpsc_lpcnet_sample(
    int act_bf16, int bunch, int w8, int cdf_mm,
    const void* cond_a, const void* cond_b, const float* lpc_rev,
    const float* temp, const float* u, const void* emb,
    const void* wiemb_t, const void* wh_a_t, const float* bh_a,
    const void* wi_b, const void* wh_b, const float* bh_b,
    const void* fc_w, const float* fc_b, const float* u2l,
    const void* fch_t, const float* fch_b,
    const float* s_emb, const float* s_wiemb, const float* s_wh_a,
    const float* s_wi_b, const float* s_wh_b, const float* s_fc,
    const float* s_fch,
    const int* blk_ptr, const int* blk_col, float* out, int* trace,
    int batch, int frames, int ha, int hb, int e_dim, int rb, int cb,
    int n_live, float deemph, void* stream) {
  if (batch <= 0 || frames <= 0 || ha <= 0 || hb <= 0 || e_dim <= 0 ||
      (bunch != 1 && bunch != 2 && bunch != 4) ||
      (bunch > 1 && (!fch_t || !fch_b)))
    return (int)cudaErrorInvalidValue;
  if (w8 && (!s_emb || !s_wiemb || !s_wh_a || !s_wi_b || !s_wh_b || !s_fc ||
             (bunch > 1 && !s_fch)))
    return (int)cudaErrorInvalidValue;
  if (rb != 0 && (rb < 0 || cb <= 0 || (3 * ha) % rb != 0 || ha % cb != 0 ||
                  n_live < 0 || !blk_ptr || (n_live > 0 && !blk_col)))
    return (int)cudaErrorInvalidValue;
  Args a{cond_a, cond_b, lpc_rev, temp, u, emb, wiemb_t, wh_a_t, bh_a,
         wi_b, wh_b, bh_b, fc_w, fc_b, u2l, fch_t, fch_b,
         s_emb, s_wiemb, s_wh_a, s_wi_b, s_wh_b, s_fc, s_fch,
         blk_ptr, blk_col, out, trace, batch, frames, ha, hb, e_dim,
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
