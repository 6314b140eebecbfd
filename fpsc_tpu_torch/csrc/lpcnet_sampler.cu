// Fused LPCNet sampler for Hopper (sm_90a): bunch=1 and bunch=2, with a
// dense or a static block-sparse GRU_A recurrent matrix.
//
// Replaces the Pallas TPU kernel fpsc_tpu/ops/lpcnet_sampler.py::_kernel
// in its bunch=1 form (step 275-289), its bunch=2 form (step2 291-332,
// emb_many 157-183, the head-2 operand fch 626-644) and its block-sparse
// GRU_A product (recurrent_a 193-217, pattern 437-473), with gru_chain
// 260-273, draw 219-258 and _l2u_rows 79-84, launched by pallas_sample
// (659-706).  The wrapper and the plain PyTorch version with the same
// arithmetic are in fpsc_tpu_torch/ops/lpcnet_sampler.py.
//
// One GRU step emits BUNCH 16 kHz samples per batch item:
//   1. pred = -sum(hist * lpc_rev) over the 16-sample history;
//   2. mu-law indices of the GRU_A inputs and their embedding rows
//      (the TPU took them as one-hot matmuls): bunch=1 hist[15], prev_e,
//      pred; bunch=2 hist[14], hist[15], e_p2, e_p1, pred;
//   3. pre_a = wiemb @ e_cat + cond_a;  4. GRU_A gates on wh_a @ h_a + bh_a,
//      dense, or per row block the sum of its live column blocks'
//      products in pattern order (dead blocks are skipped, not
//      compacted);
//   5. GRU_B on wi_b @ h_a + cond_b and wh_b @ h_b + bh_b;
//   6. head 1, the dual FC [fc1; fc2] @ h_b + b, then draw: exp, 0.002*Z
//      tail cut, inclusive Hillis-Steele prefix sum, idx = #{cdf <
//      u * cdf[255]}, mu-law table; x1 = pred + e1;
//   7. bunch=2 only: the history takes x1, pred2 = -sum(hist * lpc_rev),
//      head 2 = [fc3; fc4] @ [h_b, emb(x1), emb(pred2)] + b, draw with
//      the next uniform, x2 = pred2 + e2;
//   8. y = x + deemph * prev_y per sample; the step's excitations are
//      the next step's (e_p2, e_p1).
// Cast points are the TPU kernel's (bf16 build): cond and weights are
// bf16; the matmul operands e_cat, h_a, h_b and the head-2 input are
// rounded to bf16 and the products accumulate in f32; biases, gates and
// state stay f32; exp takes the bf16-rounded logits*temp and its result
// is rounded to bf16.  The f32 build (weights in f32, no rounding)
// exists for parity checks.
//
// What bounds it.  The step is a serial chain: each sample feeds the
// next, so the whole loop runs inside one thread block per batch item
// (Hopper blocks cannot carry state across a grid the way the TPU's
// sequential grid did).  Per item and GRU step, at the flagship widths
// (GRU_A 384, GRU_B 32, E 128), bunch=2 with 22 of 108 (64, 64) blocks
// live does 1,031,168 MACs: far too little work per step to fill the
// card, so it is bound by the latency of the chain, not by bytes or
// FLOPs.  The bf16 weights (2.2 MB at bunch=2) do not fit one SM's
// 227 KB of shared memory; here they are read from global memory at
// every step and stay resident in the 50 MB L2.  State (h_a, h_b, the
// history, the previous excitations, prev_y) lives in shared memory;
// __syncthreads() separates the phases.  The heads run on all 12 warps,
// one thread per output row; the draws, which are serial, on warp 0.
// Holding the weights in the distributed shared memory of a 16-block
// cluster is the redesign for a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (plain C interface, loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kLevels = 256;
constexpr int kPerLane = kLevels / 32;
constexpr int kFrame = 160;
constexpr int kOrder = 16;
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog256 = 5.545177444479562f;
constexpr float kMuScale = 255.0f / 32768.0f;

struct Args {
  const void* cond_a;     // (B, L, 3Ha)  W, input bias folded in
  const void* cond_b;     // (B, L, 3Hb)  W, input bias folded in
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
  const void* fch_t;      // (Hb+2E, 512) W, [fc3; fc4] k-major (bunch=2)
  const float* fch_b;     // (512,)       (bunch=2)
  const int* blk_ptr;     // (3Ha/rb + 1,) row block -> first live entry
  const int* blk_col;     // (n_live,)    live column blocks, pattern order
  float* out;             // (B, L*160)
  int* trace;             // (B, L*160/bunch, trace width) or null: the
                          // decisions of each step (ops/lpcnet_sampler.py
                          // sample_plain)
  int batch, frames, ha, hb, e_dim;
  int rb, cb, n_live;     // rb = 0: dense GRU_A
  float deemph;
};

template <typename W> struct Prec;
template <> struct Prec<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <> struct Prec<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

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

// Run by all 32 lanes of one warp: the drawn mu-law code of the stacked
// dual-FC pre-activations fcpre[512] (bias included) at temperature
// temp and uniform uval.  Lane l holds levels l + 32 * i.
template <typename P>
__device__ __forceinline__ int draw(const float* fcpre, float temp, float uval,
                                    int lane) {
  float v[kPerLane];
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
  const float total = __shfl_sync(kFull, v[kPerLane - 1], 31);
  const float thresh = uval * total;
  int below = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) below += (v[i] < thresh) ? 1 : 0;
  below = __reduce_add_sync(kFull, below);
  return min(below, kLevels - 1);
}

size_t smem_bytes(const Args& a, int bunch) {
  const size_t n_emb = 2 * (size_t)bunch + 1;
  const size_t floats = 3 * (size_t)a.ha           // h_a, rounded old and new
                        + n_emb * a.e_dim          // e_cat
                        + 3 * (size_t)a.hb         // h_b, rounded old and new
                        + 2 * (size_t)a.e_dim      // head-2 embeddings
                        + 2 * kLevels              // head pre-activations
                        + 2 * kOrder               // history, lpc
                        + kLevels + 8;             // u2l, per-item scalars
  const size_t ints = 8 + (a.rb ? 3 * (size_t)a.ha / a.rb + 1 + a.n_live : 0);
  return floats * sizeof(float) + ints * sizeof(int);
}

// One thread block per batch item runs the item's whole sample loop.
template <typename W, int BUNCH>
__global__ void __launch_bounds__(kThreads, 1) sample_kernel(Args a) {
  using P = Prec<W>;
  constexpr int kEmb = 2 * BUNCH + 1;
  // decisions per step: the GRU_A indices and code 1, then for bunch=2
  // the indices of x1 and pred2 and code 2 (lpcnet_sampler.trace_width)
  constexpr int kTrace = 2 * BUNCH + 2 + 3 * (BUNCH - 1);
  constexpr int kSteps = kFrame / BUNCH;
  extern __shared__ float smem[];
  const int ha = a.ha, hb = a.hb, e_dim = a.e_dim, en = kEmb * a.e_dim;
  const int frames = a.frames;
  const int n_rb = a.rb ? 3 * ha / a.rb : 0;
  float* s_ha = smem;             // [ha]  GRU_A state
  float* s_har = s_ha + ha;       // [ha]  bf16-rounded h_a (GRU_A in)
  float* s_hbin = s_har + ha;     // [ha]  rounded new h_a (GRU_B in)
  float* s_ecat = s_hbin + ha;    // [nE]  GRU_A input embeddings
  float* s_hb = s_ecat + en;      // [hb]  GRU_B state
  float* s_hbr = s_hb + hb;       // [hb]  rounded old h_b
  float* s_hfc = s_hbr + hb;      // [hb]  rounded new h_b (heads in)
  float* s_h2 = s_hfc + hb;       // [2E]  head-2 embeddings
  float* s_fc = s_h2 + 2 * e_dim; // [512] head pre-activations
  float* s_hist = s_fc + 2 * kLevels;  // [16] newest sample last
  float* s_lpc = s_hist + kOrder; // [16]  this frame's lpc_rev
  float* s_u2l = s_lpc + kOrder;  // [256]
  float* s_item = s_u2l + kLevels;  // pred, prev_y, temp, x1, e_prev[BUNCH]
  float* s_eprev = s_item + 4;    // previous excitations, oldest first
  int* s_idx = reinterpret_cast<int*>(s_item + 8);  // [8] decisions
  int* s_bptr = s_idx + 8;        // [n_rb + 1]
  int* s_bcol = s_bptr + n_rb + 1;  // [n_live]

  const W* emb = static_cast<const W*>(a.emb);
  const W* wiemb_t = static_cast<const W*>(a.wiemb_t);
  const W* wh_a_t = static_cast<const W*>(a.wh_a_t);
  const W* wi_b = static_cast<const W*>(a.wi_b);
  const W* wh_b = static_cast<const W*>(a.wh_b);
  const W* fc_w = static_cast<const W*>(a.fc_w);
  const W* fch_t = static_cast<const W*>(a.fch_t);

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
    const W* cond_a = static_cast<const W*>(a.cond_a) + bf * 3 * ha;
    const W* cond_b = static_cast<const W*>(a.cond_b) + bf * 3 * hb;
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
        s_ecat[i] = P::load(emb + (size_t)s_idx[slot] * e_dim + c);
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
          ax0 = fmaf(P::load(row), x, ax0);
          ax1 = fmaf(P::load(row + ha), x, ax1);
          ax2 = fmaf(P::load(row + 2 * ha), x, ax2);
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
                part = fmaf(P::load(wr + (size_t)k * 3 * ha), s_har[k], part);
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
            ah0 = fmaf(P::load(row), x, ah0);
            ah1 = fmaf(P::load(row + ha), x, ah1);
            ah2 = fmaf(P::load(row + 2 * ha), x, ah2);
          }
        }
        const float r = sigmoidf((ax0 + P::load(cond_a + j)) + (ah0 + a.bh_a[j]));
        const float z = sigmoidf((ax1 + P::load(cond_a + ha + j)) + (ah1 + a.bh_a[ha + j]));
        const float n = tanhf((ax2 + P::load(cond_a + 2 * ha + j)) + r * (ah2 + a.bh_a[2 * ha + j]));
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
          a0 = fmaf(P::load(wi_b + (size_t)uu * ha + k), x, a0);
          a1 = fmaf(P::load(wi_b + (size_t)(hb + uu) * ha + k), x, a1);
          a2 = fmaf(P::load(wi_b + (size_t)(2 * hb + uu) * ha + k), x, a2);
        }
        for (int k = lane; k < hb; k += 32) {
          const float x = s_hbr[k];
          c0 = fmaf(P::load(wh_b + uu * hb + k), x, c0);
          c1 = fmaf(P::load(wh_b + (hb + uu) * hb + k), x, c1);
          c2 = fmaf(P::load(wh_b + (2 * hb + uu) * hb + k), x, c2);
        }
        a0 = warp_sum(a0); a1 = warp_sum(a1); a2 = warp_sum(a2);
        c0 = warp_sum(c0); c1 = warp_sum(c1); c2 = warp_sum(c2);
        if (lane == 0) {
          const float r = sigmoidf((a0 + P::load(cond_b + uu)) + (c0 + a.bh_b[uu]));
          const float z = sigmoidf((a1 + P::load(cond_b + hb + uu)) + (c1 + a.bh_b[hb + uu]));
          const float n = tanhf((a2 + P::load(cond_b + 2 * hb + uu)) + r * (c2 + a.bh_b[2 * hb + uu]));
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
        for (int k = 0; k < hb; ++k) d = fmaf(P::load(row + k), s_hfc[k], d);
        s_fc[i] = d + a.fc_b[i];
      }
      __syncthreads();

#pragma unroll
      for (int s = 0; s < BUNCH; ++s) {
        if (s > 0) {
          // 7: head 2 on [h_b, emb(x1), emb(pred2)], one thread per row
          for (int i = tid; i < 2 * e_dim; i += kThreads) {
            const int slot = i / e_dim, c = i - slot * e_dim;
            s_h2[i] = P::load(emb + (size_t)s_idx[2 * BUNCH + 1 + slot] * e_dim + c);
          }
          __syncthreads();
          for (int i = tid; i < 2 * kLevels; i += kThreads) {
            const W* col = fch_t + i;
            float d = 0.0f;
            for (int k = 0; k < hb; ++k)
              d = fmaf(P::load(col + (size_t)k * 2 * kLevels), s_hfc[k], d);
            for (int k = 0; k < 2 * e_dim; ++k)
              d = fmaf(P::load(col + (size_t)(hb + k) * 2 * kLevels), s_h2[k], d);
            s_fc[i] = d + a.fch_b[i];
          }
          __syncthreads();
        }
        // draw in warp 0, then lane 0 emits the sample
        if (warp == 0) {
          const int code = draw<P>(s_fc, s_item[2], u[BUNCH * t + s], lane);
          if (lane == 0) {
            const float e = s_u2l[code];
            const float x = (s == 0 ? s_item[0] : s_item[3]) + e;
#pragma unroll
            for (int i = 0; i < kOrder - 1; ++i) s_hist[i] = s_hist[i + 1];
            s_hist[kOrder - 1] = x;
            const float y = x + a.deemph * s_item[1];
            s_item[1] = y;
            s_eprev[s] = e;
            out[(size_t)f * kFrame + BUNCH * t + s] = y;
            int* tr = trace ? trace + ((size_t)f * kSteps + t) * kTrace : nullptr;
            if (s == 0) {
              if (tr) {
#pragma unroll
                for (int i = 0; i < kEmb; ++i) tr[i] = s_idx[i];
                tr[kEmb] = code;
              }
              if (BUNCH > 1) {
                // pred2 from the history that now ends with x1; head 2
                // embeds x1 and pred2
                const float pred2 = lpc_pred(s_hist, s_lpc);
                s_item[3] = pred2;
                s_idx[2 * BUNCH + 1] = l2u_index(x);
                s_idx[2 * BUNCH + 2] = l2u_index(pred2);
              }
            } else if (tr) {
              tr[kEmb + 1] = s_idx[2 * BUNCH + 1];
              tr[kEmb + 2] = s_idx[2 * BUNCH + 2];
              tr[kEmb + 3] = code;
            }
          }
        }
        __syncthreads();
      }
    }
  }
}

template <typename W, int BUNCH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a, BUNCH);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sample_kernel<W, BUNCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  sample_kernel<W, BUNCH><<<a.batch, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_bunch(const Args& a, int bunch, cudaStream_t stream) {
  return bunch == 2 ? launch<W, 2>(a, stream) : launch<W, 1>(a, stream);
}

}  // namespace

// Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int fpsc_lpcnet_sample(
    int weights_bf16, int bunch,
    const void* cond_a, const void* cond_b, const float* lpc_rev,
    const float* temp, const float* u, const void* emb,
    const void* wiemb_t, const void* wh_a_t, const float* bh_a,
    const void* wi_b, const void* wh_b, const float* bh_b,
    const void* fc_w, const float* fc_b, const float* u2l,
    const void* fch_t, const float* fch_b,
    const int* blk_ptr, const int* blk_col, float* out, int* trace,
    int batch, int frames, int ha, int hb, int e_dim, int rb, int cb,
    int n_live, float deemph, void* stream) {
  if (batch <= 0 || frames <= 0 || ha <= 0 || hb <= 0 || e_dim <= 0 ||
      (bunch != 1 && bunch != 2) || (bunch == 2 && (!fch_t || !fch_b)))
    return (int)cudaErrorInvalidValue;
  if (rb != 0 && (rb < 0 || cb <= 0 || (3 * ha) % rb != 0 || ha % cb != 0 ||
                  n_live < 0 || !blk_ptr || (n_live > 0 && !blk_col)))
    return (int)cudaErrorInvalidValue;
  Args a{cond_a, cond_b, lpc_rev, temp, u, emb, wiemb_t, wh_a_t, bh_a,
         wi_b, wh_b, bh_b, fc_w, fc_b, u2l, fch_t, fch_b, blk_ptr, blk_col,
         out, trace, batch, frames, ha, hb, e_dim, rb, cb, n_live, deemph};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(weights_bf16 ? launch_bunch<__nv_bfloat16>(a, bunch, s)
                            : launch_bunch<float>(a, bunch, s));
}
