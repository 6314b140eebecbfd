// The WaveNet's sample steps for Hopper (sm_90a): one launch runs a whole
// chunk of generation's steps, float32 on the CUDA cores.
//
// Replaces no TPU kernel.  The JAX package generates with a lax.scan over
// the ring-buffer step (fpsc_tpu/models/wavenet.py:258-342), which XLA
// compiles; it has no Pallas kernel.  On the card the port's step was
// about 220 small library kernels (ATen and cuBLAS, replayed from a
// captured graph), each bound by its launch and its tile latency, about
// 66 times the step's bound.  This kernel is that step written for the
// H100.  The wrapper is fpsc_tpu_torch/ops/wavenet_step.py; the plain
// PyTorch version with the same arithmetic is
// models/wavenet.py::GenerateChunks._plain_chunk.
//
// A step of each row (a row: one utterance of the batch):
//   1. h_0 = relu(front_b + x[t - K .. t) @ front_w)      (the front)
//   2. per layer i (dilation d):
//        pre = past_w^T h_i[t - d] + now_w^T h_i[t] + conv_b + crow_i[t]
//        out = tanh(pre[:gc]) * sigmoid(pre[gc:])
//        rs  = rs_w^T out + rs_b
//        h_{i+1} = (h_i + rs[:rc]) sqrt(1/2);  skip += rs[rc:]
//      h_i[t] goes into layer i's ring of d + 1 rows;
//   3. dist = final2(relu(final1(relu(skip)))), exc = mean + exp(log_std)
//      eps, x[t] = exc - sum(x[t - 16 .. t) * lpc), y[t] = x[t] +
//      deemph y[t - 1].
// crow_i is layer i's conditioning term, projected for a block of samples
// before the chunk (GenerateChunks._project), read by the step's position.
//
// What bounds it.  At the published widths (residual 128, gate 256, skip
// 128, front 32, 2 x 10 layers) a step of a row is 3.95 M multiply-adds,
// so the kernel's bound at 64 rows is 7.5 us a step at the card's 67
// TFLOP/s in float32 (10.06 us with the conditioning's projection, 5.26 M
// multiply-adds a row, which runs outside the kernel in
// GenerateChunks._project: benchmark/counts/wavenet.py's figure for the
// whole step); the step's weights, 15.8 MB, take
// 4.7 us to read once from HBM and stay in the 50 MB L2.  But the 20
// layers are a serial chain, each of two dependent products (the gate
// needs all of a row's taps, the residual product all of its gate), and
// step t + 1 needs step t's sample: 41 dependent phases a step, each of
// which needs the whole of a row's previous phase.  So a step is bound by
// the latency of those phases, not by the card's rate.
//
// The design (design (b) of the redesign: row groups on thread-block
// clusters).  Rows never mix, so each cluster of kCluster = 16 CTAs runs
// kRows = 12 rows (a warp a row; an H100 holds 7 such clusters at once,
// so up to 84 rows run in one wave) through all the chunk's steps, and
// clusters never wait for each other: no grid-wide
// barrier and no co-residency to guarantee (design (a)'s persistent grid
// would broadcast every phase's 64 rows to 132 SMs through L2 and wait at
// 42 grid barriers a step).  Within a cluster every phase's columns are
// split over the 16 CTAs (CTA j: gate channels j G ... (G = gc / 16),
// filter and gate together, so the gate is local; residual and skip
// columns j rc / 16 ... and j sc / 16 ...; final1's columns j sc / 16
// ...).  Each CTA's columns of a layer (57.5 KB at the published widths,
// packed once a call by the wrapper as the stage holds them) come from L2
// by one bulk copy, with the rows' past inputs from the ring and their
// conditioning row, a layer ahead of the chain (double-buffered), counted
// on the stage's mbarrier.  After each phase a CTA stores its slice of
// the phase's output, 16 bytes at a time, into every CTA's copy (st.async
// to distributed shared memory, counted on the receiver's mbarrier, which
// expects the whole vector's bytes): one exchange a phase, no
// cluster-wide barrier in the step.  A peer stores a phase's output only
// once it holds this CTA's part of the phase before, so every exchanged
// vector is free to overwrite by then; the gate's output, which some
// warps still read while others have sent the next phase's, has a buffer
// a layer parity.  The ring rows, stored by the generic proxy and read
// steps later by the bulk copy (the async proxy), are ordered by a proxy
// fence before each copy.  The front, final2 and the sample are
// computed by every CTA on its own copy (identically), so each holds the
// signal's history.  A phase's products: a warp computes a tile of 4 x 8
// outputs (2 x 8 for final1), its 32 lanes splitting the depth (lane l
// takes depths l, l + 32, ...; float4 weight rows padded against bank
// conflicts), then a reduce-scatter of shuffles leaves one output a lane.
// Every output is summed in the same order (lane partials in depth order,
// then the same butterfly), fixed by the widths alone: a row's samples
// are the same, bit for bit, whatever rows run beside it.
//
// Measured on an H100 (700 W, probes/wavenet_step.py): 85.2 us a step at
// 64 rows (6 clusters of 12), 78.0 at one row, against 728 and 366 us for
// the plain chunk's captured graph; 8.9% of the kernel's bound of 7.55 us
// at 64 rows (11.8% of the whole step's 10.06, the projection included).
// Of the 85: the products about 31 us, the exchanges about 11, the
// epilogues (shuffles, gate, front, finals) and the step's
// synchronisation about 22, the stage's loads 5 exposed (timing variants
// with each part taken out).  So the phases' latency, not the card's rate
// or its bandwidth, bounds it: tiles of 4 rows in place of 2 in the
// residual product, half its shared-memory reads, moved 1%.  Clusters of
// 8 rows took 61 us a step at one row, but 64 rows in two waves; one
// instance serves every batch.
//
// Precision: float32 FMA on the CUDA cores, tanhf, expf, 1 / (1 +
// expf(-x)); no tensor cores, no fast math.  The sums run in another
// order than cuBLAS's, so the samples agree with the plain version's to
// float32 rounding, not bit for bit.
//
// Carried state stays in the caller's buffers: the rings, the signal
// history x, the output y (y[0] the last sample of the chunk before),
// read at the launch's start and written back at its end; the position
// is read from the device (the wrapper adds the chunk to it after the
// launch).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (plain C interface, loaded with ctypes).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCluster = 16;     // CTAs a cluster
constexpr int kRows = 12;        // rows a cluster, a warp each
constexpr int kMaxLayers = 64;
constexpr int kLpc = 16;         // LPC order
constexpr int kOut = 2;          // (mean, log_std)
constexpr int kMaxSmem = 232448; // the card's dynamic shared memory a CTA
constexpr float kSqrtHalf = 0.70710678118654752440f;

// mbarriers: one a buffer that peers fill, one a stage of the layers
enum Bar { kBarOut, kBarH0, kBarH1, kBarSkip, kBarFin, kBarStage0, kBarStage1, kBars };

struct Params {
  const float *packed, *front_w, *front_b;
  const float *f1_w, *f1_b, *f2_w, *f2_b, *cond, *eps, *lpc;
  float *rings, *x, *y;
  const long long* pos;
  int rows, rc, gc, sc, k_front, lead, chunk, cond_block, layers;
  float deemph;
  int ring_rows[kMaxLayers];  // d + 1 a layer
  int ring_base[kMaxLayers];  // its first row in `rings`
};

// A weight tile's row stride in floats: its columns, padded by 4 where
// they are an even number of float4s, so that 8 lanes reading the same
// columns of 8 consecutive rows hit distinct banks.
__host__ __device__ constexpr int pad_ld(int cols) {
  return (cols / 4) % 2 == 0 ? cols + 4 : cols;
}

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// Shared memory of a CTA, offsets in floats (each a multiple of 4).
// Two stages of a layer (its weight columns, their biases, the rows'
// past inputs and conditioning), the exchanged vectors (the gate's
// output twice, by layer parity), the CTA's skip
// sums, the front's and the finals' weights, the signal history.  A
// stage's first `past` floats, the weights and biases, are the CTA's
// block of the packed weights as the wrapper lays them out
// (ops/wavenet_step.py::pack), so one bulk copy brings them.
struct Layout {
  int G, rb, sb, fb, ldA, ldB, ldF;
  int wa, wb, ba, bb, past, crow, stage;
  int h0, h1, out, skip, fin, skacc, fw, fbias, f1w, f1b, f2w, f2b, xs;
  int xs_ld, bars_bytes, bytes;
  __host__ __device__ Layout(int rc, int gc, int sc, int k_front, int lead, int chunk) {
    constexpr int R = kRows;
    G = gc / kCluster;
    rb = rc / kCluster;
    sb = sc / kCluster;
    fb = sc / kCluster;
    ldA = pad_ld(2 * G);
    ldB = pad_ld(rb + sb);
    ldF = pad_ld(fb);
    wa = 0;
    wb = wa + 2 * rc * ldA;
    ba = wb + gc * ldB;
    bb = ba + up4(2 * G);
    past = bb + up4(rb + sb);
    crow = past + R * rc;
    stage = up4(crow + R * 2 * G);
    h0 = 2 * stage;
    h1 = h0 + R * rc;
    out = h1 + R * rc;
    skip = out + 2 * R * gc;
    fin = skip + R * sc;
    skacc = fin + R * sc;
    fw = skacc + up4(R * sb);
    fbias = fw + k_front * rc;
    f1w = fbias + rc;
    f1b = f1w + sc * ldF;
    f2w = f1b + up4(fb);
    f2b = f2w + sc * kOut;
    xs = f2b + 4;
    xs_ld = lead + chunk;
    bars_bytes = 4 * up4(xs + R * xs_ld);
    bytes = bars_bytes + 8 * kBars;
  }
};

// ---------------------------------------------------------------------------
// Cluster, mbarrier and copy primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster: what each wrote before is seen by all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of st.async data in this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Until the barrier's phase of this parity has completed, acquiring at
// cluster scope what the peers released.  try_wait suspends the thread
// for a while where the phase is not complete, so waiting warps leave
// their issue slots to the warps still computing.  A phase that never
// completes (a fault) traps after some seconds rather than hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spin > (1ll << 22)) __trap();
  }
}

__device__ __forceinline__ uint32_t map_rank(uint32_t local, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

// 16 bytes to `dst`'s offset in the shared memory of the cluster's CTA
// `rank` (this CTA included), counted there on its barrier at `bar`'s
// offset.
__device__ __forceinline__ void send16(const float4& v, uint32_t dst, uint32_t bar,
                                       unsigned rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1,%2,%3,%4}, [%5];\n" ::"r"(map_rank(dst, rank)),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(map_rank(bar, rank))
      : "memory");
}

// `bytes` (a multiple of 16) from global memory to this CTA's shared
// memory by the copy engine, counted on the barrier at bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// ---------------------------------------------------------------------------
// A warp's tile: TR rows x two float4 column groups (at c1 and c2 of a
// weight tile w, rows ldw apart) over `depth` rows of w and columns of the
// activations act (TR rows lda apart).  Lane l sums depths l, l + 32, ...
// in that order into acc[r * 8 + e] (e < 4: column c1 + e, else c2 + e -
// 4).
template <int TR>
__device__ __forceinline__ void tile_dot(float (&acc)[TR * 8], const float* act, int lda,
                                         const float* w, int ldw, int c1, int c2,
                                         int depth, int lane) {
#pragma unroll 2
  for (int k = lane; k < depth; k += 32) {
    const float4 w1 = ld4(w + k * ldw + c1), w2 = ld4(w + k * ldw + c2);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float a = act[r * lda + k];
      acc[r * 8 + 0] = fmaf(a, w1.x, acc[r * 8 + 0]);
      acc[r * 8 + 1] = fmaf(a, w1.y, acc[r * 8 + 1]);
      acc[r * 8 + 2] = fmaf(a, w1.z, acc[r * 8 + 2]);
      acc[r * 8 + 3] = fmaf(a, w1.w, acc[r * 8 + 3]);
      acc[r * 8 + 4] = fmaf(a, w2.x, acc[r * 8 + 4]);
      acc[r * 8 + 5] = fmaf(a, w2.y, acc[r * 8 + 5]);
      acc[r * 8 + 6] = fmaf(a, w2.z, acc[r * 8 + 6]);
      acc[r * 8 + 7] = fmaf(a, w2.w, acc[r * 8 + 7]);
    }
  }
}

// One level of the butterfly: the lanes l and l ^ S exchange halves of
// their 2 S values, each keeping the half whose bit S is its own, summed.
template <int S, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  const bool up = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = up ? v[i] : v[i + S];
    const float keep = up ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// The warp's N partial sums (N = 32, 16 or 8) reduced over its lanes:
// lane l returns output l mod N.  A butterfly of shuffles over lane bits
// N / 2 ... 1, halving the values a lane holds at each level, then sums
// over the lane bits above N; every output is summed over the same tree
// of lanes.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  static_assert(N == 32 || N == 16 || N == 8, "a warp's tile");
  if constexpr (N == 32) halve<16>(v, lane);
  if constexpr (N >= 16) halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  float r = v[0];
  if constexpr (N == 8) r += __shfl_xor_sync(0xffffffffu, r, 8);
  if constexpr (N <= 16) r += __shfl_xor_sync(0xffffffffu, r, 16);
  return r;
}

// The float4 of 4 consecutive outputs held by lanes src .. src + 3.
__device__ __forceinline__ float4 gather4(float v, int src) {
  return make_float4(__shfl_sync(0xffffffffu, v, src), __shfl_sync(0xffffffffu, v, src + 1),
                     __shfl_sync(0xffffffffu, v, src + 2),
                     __shfl_sync(0xffffffffu, v, src + 3));
}

// ---------------------------------------------------------------------------

// Bytes of a stage: the CTA's packed weights, the valid rows' past inputs
// and conditioning.
__device__ __forceinline__ unsigned stage_bytes(const Layout& L, int rc, int valid) {
  return 4u * (unsigned)(L.past + valid * rc + valid * 2 * L.G);
}

// Layer i's stage for step t into st, counted on the barrier at bar:
// this CTA's block of the layer's packed weights, the valid rows' past
// inputs h_i[t - d] (ring row base + (t + 1) mod (d + 1)), and their
// conditioning for this CTA's filter and gate channels.  Threads 0 ...
// 2 valid issue one bulk copy or two each.
__device__ void prefetch_layer(const Params& p, const Layout& L, float* st, uint32_t bar, int i,
                               long long t, int j, int row0, int valid) {
  const int tid = threadIdx.x, rc = p.rc, G = L.G;
  if (tid == 0) {
    mbar_arrive_expect(bar, stage_bytes(L, rc, valid));
    bulk_copy(st, p.packed + ((size_t)i * kCluster + j) * L.past, 4u * L.past, bar);
    const long long ring_row = p.ring_base[i] + (t + 1) % p.ring_rows[i];
    // the ring row's generic stores, acquired through the exchanges,
    // before the async proxy's read
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    bulk_copy(st + L.past, p.rings + ((size_t)ring_row * p.rows + row0) * rc,
              4u * (unsigned)(valid * rc), bar);
  } else if (tid <= 2 * valid) {
    const int r = (tid - 1) >> 1, half = (tid - 1) & 1;
    const long long crow = (long long)i * p.cond_block + t % p.cond_block;
    bulk_copy(st + L.crow + r * 2 * G + half * G,
              p.cond + ((size_t)crow * p.rows + row0 + r) * 2 * p.gc + half * p.gc + j * G,
              4u * G, bar);
  }
}

__global__ void __launch_bounds__(32 * kRows, 1)
    wavenet_chunk_kernel(const __grid_constant__ Params p) {
  constexpr int R = kRows, kWarps = R, kThreads = 32 * R;
  extern __shared__ __align__(16) float sm[];
  const Layout L(p.rc, p.gc, p.sc, p.k_front, p.lead, p.chunk);
  const int rc = p.rc, gc = p.gc, sc = p.sc, G = L.G, rb = L.rb, sb = L.sb, fb = L.fb;
  const int j = (int)cluster_ctarank(), row0 = (int)cluster_id() * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int valid = min(R, p.rows - row0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(sm) + L.bars_bytes);
  // the bytes an exchange barrier's phase expects: the whole of its vector
  auto bar_bytes = [&](int b) {
    return (unsigned)(4 * R * (b == kBarOut ? gc : b == kBarSkip || b == kBarFin ? sc : rc));
  };
  if (tid == 0) {
    for (int b = 0; b < kBars; ++b) mbar_init(smem_u32(&bars[b]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int b = 0; b < kBarStage0; ++b) mbar_arrive_expect(smem_u32(&bars[b]), bar_bytes(b));
  }
  unsigned parity = 0;  // bit b: the parity of barrier b's phase awaited next
  auto wait = [&](int b) {
    mbar_wait(smem_u32(&bars[b]), (parity >> b) & 1u);
    parity ^= 1u << b;
    if (tid == 0) mbar_arrive_expect(smem_u32(&bars[b]), bar_bytes(b));
  };

  // once a launch: the front's and the finals' weights (final1's columns
  // j fb ...), the signal history, zeros for the rows past the batch in
  // both stages
  const long long t0 = *p.pos;
  for (int e = tid; e < p.k_front * rc; e += kThreads) sm[L.fw + e] = p.front_w[e];
  for (int e = tid; e < rc; e += kThreads) sm[L.fbias + e] = p.front_b[e];
  for (int e = tid; e < sc * fb; e += kThreads) {
    const int k = e / fb, c = e - k * fb;
    sm[L.f1w + k * L.ldF + c] = p.f1_w[(size_t)k * sc + j * fb + c];
  }
  for (int e = tid; e < fb; e += kThreads) sm[L.f1b + e] = p.f1_b[j * fb + e];
  for (int e = tid; e < sc * kOut; e += kThreads) sm[L.f2w + e] = p.f2_w[e];
  if (tid < kOut) sm[L.f2b + tid] = p.f2_b[tid];
  for (int e = tid; e < R * p.lead; e += kThreads) {
    const int r = e / p.lead, k = e - r * p.lead, row = row0 + r;
    sm[L.xs + r * L.xs_ld + k] = row < p.rows ? p.x[(size_t)k * p.rows + row] : 0.0f;
  }
  for (int e = tid; e < R * sb; e += kThreads) sm[L.skacc + e] = 0.0f;
  for (int e = tid; e < (R - valid) * (rc + 2 * G); e += kThreads) {
    const int r = valid + e / (rc + 2 * G), c = e % (rc + 2 * G);
    for (int s2 = 0; s2 < 2; ++s2)
      sm[s2 * L.stage + (c < rc ? L.past + r * rc + c : L.crow + r * 2 * G + c - rc)] = 0.0f;
  }
  // every CTA's barriers armed before any peer stores into them
  __syncthreads();
  cluster_sync();
  prefetch_layer(p, L, sm, smem_u32(&bars[kBarStage0]), 0, t0, j, row0, valid);
  // the final step's lanes: lane 2 (r mod 4) of warp r / 4 holds row
  // r's y[t - 1]
  const bool sampler = warp < R / 4 && lane < 8 && (lane & 1) == 0;
  const int srow = warp * 4 + (lane >> 1);
  float yprev = 0.0f;
  if (sampler && row0 + srow < p.rows) yprev = p.y[row0 + srow];

  int g = 0;  // layers run in this launch: the stage of layer g is g & 1
  for (int k = 0; k < p.chunk; ++k) {
    const long long t = t0 + k;
    float eps = 0.0f, lpcv[kLpc];
    if (sampler) {
      const int row = row0 + srow;
      const bool valid = row < p.rows;
      eps = valid ? __ldg(p.eps + (size_t)k * p.rows + row) : 0.0f;
#pragma unroll
      for (int q = 0; q < kLpc; ++q)
        lpcv[q] = valid ? __ldg(p.lpc + ((size_t)k * p.rows + row) * kLpc + q) : 0.0f;
    }
    __syncthreads();  // the history's sample of the step before
    // the front, on every CTA for all columns; this CTA's residual
    // columns of h_0 into layer 0's ring
    {
      float* h = sm + L.h0;
      const int q4 = rc / 4;
      const long long ring_row = p.ring_base[0] + t % p.ring_rows[0];
      for (int e = tid; e < R * q4; e += kThreads) {
        const int r = e / q4, c = (e - r * q4) * 4;
        const float* xw = sm + L.xs + r * L.xs_ld + k + p.lead - p.k_front;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < p.k_front; ++q) {
          const float xv = xw[q];
          const float4 w = ld4(sm + L.fw + q * rc + c);
          acc.x = fmaf(xv, w.x, acc.x);
          acc.y = fmaf(xv, w.y, acc.y);
          acc.z = fmaf(xv, w.z, acc.z);
          acc.w = fmaf(xv, w.w, acc.w);
        }
        const float4 b = ld4(sm + L.fbias + c);
        const float4 v = make_float4(fmaxf(acc.x + b.x, 0.f), fmaxf(acc.y + b.y, 0.f),
                                     fmaxf(acc.z + b.z, 0.f), fmaxf(acc.w + b.w, 0.f));
        *reinterpret_cast<float4*>(h + r * rc + c) = v;
        if (c >= j * rb && c < (j + 1) * rb && row0 + r < p.rows)
          *reinterpret_cast<float4*>(p.rings + ((size_t)ring_row * p.rows + row0 + r) * rc + c) = v;
      }
    }
    for (int i = 0; i < p.layers; ++i, ++g) {
      float* st = sm + (g & 1) * L.stage;
      // every warp done with the other stage (layer g - 1's), then the
      // next layer's loads into it, then this layer's stage in
      __syncthreads();
      const uint32_t next_bar = smem_u32(&bars[kBarStage0 + ((g + 1) & 1)]);
      if (i + 1 < p.layers)
        prefetch_layer(p, L, sm + ((g + 1) & 1) * L.stage, next_bar, i + 1, t, j, row0, valid);
      else if (k + 1 < p.chunk)
        prefetch_layer(p, L, sm + ((g + 1) & 1) * L.stage, next_bar, 0, t + 1, j, row0, valid);
      mbar_wait(smem_u32(&bars[kBarStage0 + (g & 1)]), (unsigned)(g >> 1) & 1u);
      if (i > 0) wait(kBarH0 + (i & 1));
      const float* h = sm + ((i & 1) ? L.h1 : L.h0);
      float* out = sm + L.out + (g & 1) * R * gc;

      // taps and gate: tiles of 4 rows x (4 filter, 4 gate) channels
      {
        const int quads = G / 4, tiles = (R / 4) * quads;
        for (int tile = warp; tile < tiles; tile += kWarps) {
          const int r0 = (tile / quads) * 4, q = tile - (tile / quads) * quads;
          float acc[32];
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
          tile_dot<4>(acc, st + L.past + r0 * rc, rc, st + L.wa, L.ldA, 4 * q, G + 4 * q, rc,
                      lane);
          tile_dot<4>(acc, h + r0 * rc, rc, st + L.wa + rc * L.ldA, L.ldA, 4 * q, G + 4 * q,
                      rc, lane);
          const float v = reduce_scatter<32>(acc, lane);
          // lane l: row r0 + l / 8; l mod 8 < 4 filter channel 4 q + l mod
          // 4, else its gate
          const int r = r0 + (lane >> 3), e = lane & 7;
          const int col = e < 4 ? 4 * q + e : G + 4 * q + e - 4;
          const float pre = v + st[L.ba + col] + st[L.crow + r * 2 * G + col];
          const float gate = __shfl_down_sync(0xffffffffu, pre, 4);
          const float o = tanhf(pre) * sigmoid(gate);
          const float4 ov = gather4(o, lane & ~7);
          const uint32_t dst = smem_u32(out + r * gc + j * G + 4 * q);
          const uint32_t bar = smem_u32(&bars[kBarOut]);
#pragma unroll
          for (int m = 0; m < kCluster / 8; ++m) send16(ov, dst, bar, (unsigned)(e + 8 * m));
        }
      }
      wait(kBarOut);

      // residual and skip: tiles of 4 rows x 8 of this CTA's rb + sb
      // columns
      {
        const bool last = i + 1 == p.layers;
        const float* hn = sm + ((i & 1) ? L.h0 : L.h1);
        const int pairs = (rb + sb) / 8, tiles = (R / 4) * pairs;
        const long long ring_row =
            last ? 0 : p.ring_base[i + 1] + t % p.ring_rows[i + 1];
        for (int tile = warp; tile < tiles; tile += kWarps) {
          const int r0 = (tile / pairs) * 4, q = tile - (tile / pairs) * pairs;
          float acc[32];
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
          tile_dot<4>(acc, out + r0 * gc, gc, st + L.wb, L.ldB, 8 * q, 8 * q + 4, gc,
                      lane);
          const float v = reduce_scatter<32>(acc, lane);
          // lane l: row r0 + l / 8, column 8 q + l mod 8
          const int r = r0 + (lane >> 3), c = 8 * q + (lane & 7);
          const float rs = v + st[L.bb + c];
          float o;
          if (c < rb) {
            o = (h[r * rc + j * rb + c] + rs) * kSqrtHalf;
          } else {
            float* s = sm + L.skacc + r * sb + c - rb;
            o = i == 0 ? rs : *s + rs;
            *s = o;
            o = fmaxf(o, 0.0f);
          }
          // the quad of lanes 4 u ... (u = l / 4: row r0 + u / 2, columns
          // 8 q + 4 (u mod 2) ...), sent by its 4 lanes to 4 peers each
          const float4 ov = gather4(o, lane & ~3);
          const int cc = 8 * q + 4 * ((lane >> 2) & 1);
          const unsigned peer0 = (unsigned)(lane & 3);
          if (cc < rb) {
            if (!last) {
              const uint32_t dst = smem_u32(hn + r * rc + j * rb + cc);
              const uint32_t bar = smem_u32(&bars[kBarH0 + ((i + 1) & 1)]);
#pragma unroll
              for (int m = 0; m < kCluster / 4; ++m) send16(ov, dst, bar, peer0 + 4 * m);
              if ((lane & 3) == 0 && row0 + r < p.rows)
                *reinterpret_cast<float4*>(
                    p.rings + ((size_t)ring_row * p.rows + row0 + r) * rc + j * rb + cc) = ov;
            }
          } else if (last) {
            const uint32_t dst = smem_u32(sm + L.skip + r * sc + j * sb + cc - rb);
            const uint32_t bar = smem_u32(&bars[kBarSkip]);
#pragma unroll
            for (int m = 0; m < kCluster / 4; ++m) send16(ov, dst, bar, peer0 + 4 * m);
          }
        }
      }
    }
    wait(kBarSkip);

    // final1 on relu(skip): tiles of 2 rows x this CTA's 8 columns a pair
    {
      const int pairs = fb / 8, tiles = (R / 2) * pairs;
      for (int tile = warp; tile < tiles; tile += kWarps) {
        const int r0 = (tile / pairs) * 2, q = tile - (tile / pairs) * pairs;
        float acc[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
        tile_dot<2>(acc, sm + L.skip + r0 * sc, sc, sm + L.f1w, L.ldF, 8 * q, 8 * q + 4, sc,
                    lane);
        const float v = reduce_scatter<16>(acc, lane);
        const int c = 8 * q + (lane & 7);
        const float o = fmaxf(v + sm[L.f1b + c], 0.0f);
        const int u = (lane >> 2) & 3;
        const float4 ov = gather4(o, 4 * u);
        const int rr = r0 + (u >> 1), cc = 8 * q + 4 * (u & 1);
        const unsigned peer0 = (unsigned)((lane & 3) + 4 * (lane >> 4));
        const uint32_t dst = smem_u32(sm + L.fin + rr * sc + j * fb + cc);
        const uint32_t bar = smem_u32(&bars[kBarFin]);
        send16(ov, dst, bar, peer0);
        send16(ov, dst, bar, peer0 + 8);
      }
    }
    wait(kBarFin);

    // final2, the draw, the LPC prediction and de-emphasis: warp w takes
    // rows 4 w ... (every CTA, on its own copy)
    if (warp < R / 4) {
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
      const float* f = sm + L.fin + warp * 4 * sc;
      for (int kk = lane; kk < sc; kk += 32) {
        const float w0 = sm[L.f2w + kk * kOut], w1 = sm[L.f2w + kk * kOut + 1];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = f[r * sc + kk];
          acc[2 * r] = fmaf(a, w0, acc[2 * r]);
          acc[2 * r + 1] = fmaf(a, w1, acc[2 * r + 1]);
        }
      }
      // lane l: row 4 w + (l mod 8) / 2, output l mod 2
      const float dist = reduce_scatter<8>(acc, lane) + sm[L.f2b + (lane & 1)];
      const float log_std = __shfl_down_sync(0xffffffffu, dist, 1);
      if (sampler) {
        float* hist = sm + L.xs + srow * L.xs_ld + k + p.lead;
        float pred = 0.0f;
#pragma unroll
        for (int q = 0; q < kLpc; ++q) pred = fmaf(hist[q - kLpc], lpcv[q], pred);
        const float xv = fmaf(expf(log_std), eps, dist) - pred;
        const float yv = fmaf(p.deemph, yprev, xv);
        hist[0] = xv;
        yprev = yv;
        const int row = row0 + srow;
        if (j == 0 && row < p.rows) p.y[(size_t)(k + 1) * p.rows + row] = yv;
      }
    }
  }
  // the carried history: x[lead + k] the chunk's samples, x[0 .. lead)
  // its last lead; y[0] its last sample
  __syncthreads();
  if (j == 0) {
    const int n = p.lead + p.chunk;
    for (int e = tid; e < R * n; e += kThreads) {
      const int r = e / n, q = e - r * n, row = row0 + r;
      if (row >= p.rows) continue;
      p.x[(size_t)q * p.rows + row] = sm[L.xs + r * L.xs_ld + (q < p.lead ? p.chunk + q : q)];
    }
    if (sampler && row0 + srow < p.rows) p.y[row0 + srow] = yprev;
  }
  // no CTA leaves while a peer may still store into it
  cluster_sync();
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  const Layout L(p.rc, p.gc, p.sc, p.k_front, p.lead, p.chunk);
  // set at every launch (a stream capture takes it): no state kept
  cudaError_t err = cudaFuncSetAttribute(wavenet_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wavenet_chunk_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)((p.rows + kRows - 1) / kRows * kCluster));
  cfg.blockDim = dim3((unsigned)(32 * kRows));
  cfg.dynamicSmemBytes = (size_t)L.bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, wavenet_chunk_kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a CTA takes at these widths (the
// card's limit: 232,448).
extern "C" int fpsc_wavenet_step_smem(int rc, int gc, int sc, int k_front, int lead, int chunk) {
  return Layout(rc, gc, sc, k_front, lead, chunk).bytes;
}

// Floats of a CTA's block of a layer's packed weights
// (ops/wavenet_step.py::pack).
extern "C" int fpsc_wavenet_step_packed(int rc, int gc, int sc) {
  return Layout(rc, gc, sc, 1, kLpc, 1).past;
}

// One chunk of `chunk` sample steps of `rows` rows from the carried state
// (see the header; shapes in fpsc_tpu_torch/ops/wavenet_step.py), on
// `stream`.  Returns a cudaError_t code: 0 when the kernel was launched.
extern "C" int fpsc_wavenet_step(const float* packed, const float* front_w,
                                 const float* front_b, const float* f1_w,
                                 const float* f1_b, const float* f2_w, const float* f2_b,
                                 const float* cond, const float* eps, const float* lpc,
                                 float* rings, float* x, float* y, const long long* pos,
                                 int rows, int rc, int gc, int sc, int k_front, int lead,
                                 int chunk, int cond_block, int layers, const int* dilations,
                                 float deemph, void* stream) {
  if (rows <= 0 || layers <= 0 || layers > kMaxLayers || chunk <= 0 || k_front <= 0 ||
      lead < k_front || lead < kLpc || cond_block <= 0 ||
      rc % (4 * kCluster) || gc % (4 * kCluster) || sc % (8 * kCluster) ||
      (rc + sc) % (8 * kCluster) || rc % 32 || gc % 32 || sc % 32)
    return (int)cudaErrorInvalidValue;
  Params p{packed, front_w, front_b, f1_w, f1_b, f2_w, f2_b,
           cond, eps, lpc, rings, x, y, pos,
           rows, rc, gc, sc, k_front, lead, chunk, cond_block, layers, deemph, {}, {}};
  int base = 0;
  for (int i = 0; i < layers; ++i) {
    if (dilations[i] <= 0) return (int)cudaErrorInvalidValue;
    p.ring_rows[i] = dilations[i] + 1;
    p.ring_base[i] = base;
    base += dilations[i] + 1;
  }
  if (Layout(rc, gc, sc, k_front, lead, chunk).bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return (int)launch(p, static_cast<cudaStream_t>(stream));
}
