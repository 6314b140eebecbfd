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
//             m16n8k16 bf16 -> f32 (cluster_chain_kernel);
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
// bytes (1.3 MB once) take 0.4 us.  But each product needs the whole
// result of the one before, so the chain is bound by the latency of one
// product, not by the rate of the tensor cores.
//
// The bf16 arm (cluster_chain_kernel).  Column j of W @ x depends only
// on column j of x, so the b columns are independent chains.  A thread-
// block cluster of CTAs on neighbouring SMs owns a group of 8 columns
// and runs that group's whole chain; where b has more groups than the
// card holds clusters at once, clusters walk over groups.  The cluster
// has 6 CTAs (an H100 holds 17 such clusters at once against 15 of 8
// CTAs, so b = 128 needs no walking), or 8 or 16 where W's stripe needs
// them.  No grid-wide barrier, no cooperative launch.  Each CTA holds a
// stripe of W in shared memory for the whole chain: ceil(k / 16 / CTAs)
// row tiles below k, which feed the next product, and ceil((m - k) / 16
// / CTAs) above (150,528 bytes a CTA at the default), loaded once with
// cp.async, each row padded by 16 bytes so that ldmatrix reads it
// without bank conflicts.  Each warp computes two 16-row tiles: A
// fragments by ldmatrix from the stripe, B fragments by ldmatrix from the
// CTA's copy of x (bf16, column-major, double-buffered), each loaded once
// for both tiles, the next 32 of depth loaded before the mma of these are
// issued.  A CTA rounds its rows below k to bf16 into its own next
// buffer and, after a __syncthreads (its warps have read the current x),
// stores them 16 bytes at a time into every peer's with st.async, whose
// bytes count on the peer's mbarrier for that buffer (a CTA without such
// rows arrives on every peer's instead).  A CTA starts the next product
// when its barrier has all the peers' rows and arrivals.  No cluster-wide
// barrier a product: one at the start of each column group.  So what
// bounds a product is its latency: the ldmatrix-fed mma steps over the
// stripe, the distributed-shared-memory stores and their signal, and one
// __syncthreads; chain_parts.py times each.  All m rows are computed, as
// on the TPU, though only the first k feed the next product: the mma
// statements are volatile, so the rows that are not stored are not
// optimised away.
//
// The i8 and onehot arms (chain_kernel) run all products in one
// cooperative launch, a grid-wide barrier (cooperative_groups grid.sync)
// between them, the grid no larger than fits on the card at once.  Each
// warp takes 16 x 8 output tiles in turn and runs the whole depth of
// each: A fragments straight from W (resident in L2), B fragments from
// the state, which is quantised (i8) or turned into a one-hot (onehot)
// as it is loaded.  The state lives in two ping-pong buffers read
// through L2 only (__ldcg), since other SMs wrote them.
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
// The bf16 arm: the columns of x a cluster carries, at most this many
// warps a CTA (they walk over the stripe's tiles beyond), and the dynamic
// shared memory one CTA may take: the card's 232,448 bytes less the two
// barriers' 16.  probes/probe_i8_matmul.py names the same CHAIN_COLS and
// SMEM_BYTES.
constexpr int kChainCols = 8;
constexpr int kClusterWarps = 8;
constexpr int kChainSmem = 232432;

enum Arm { kBf16, kI8, kOneHot };

struct Args {
  const void* w;
  const float* x;
  float* out;
  void* xbuf;
  int m, k, b, iters;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// ---------------------------------------------------------------- bf16 arm

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned n_clusters() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster: what each wrote before (to its own shared
// memory or a peer's) is seen by all after.
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

// Until the barrier's phase of this parity has completed: every arrival,
// and every byte expected, in (a spin on test_wait, which never
// suspends the thread; acquiring at cluster scope what the peers
// released).
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ uint32_t map_rank(uint32_t local, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

// One arrival on the barrier at `bar`'s offset in the cluster's CTA
// `rank`, releasing what this thread did before at cluster scope.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, unsigned rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          map_rank(bar, rank))
      : "memory");
}

// 16 bytes v to `dst`'s offset in the shared memory of the cluster's CTA
// `rank`, there counted on its barrier at `bar`'s offset (st.async,
// complete_tx).
__device__ __forceinline__ void send16(const uint4& v, uint32_t dst, uint32_t bar,
                                       unsigned rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1,%2,%3,%4}, [%5];\n" ::"r"(map_rank(dst, rank)),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(map_rank(bar, rank))
      : "memory");
}

// The fragments of two depth steps of 16 for two 16-row tiles: A from
// the W stripe, B from x.
struct Frags {
  uint32_t a[2][2][4];  // [step][tile]
  uint32_t b[2][2];     // [step]
};

// Two 16-row tiles of W @ x over the whole depth k, on the 8 columns of
// x: A from the W stripe (row stride ld), B from x stored column-major
// (column stride ld), each B fragment loaded once for both row tiles.
// The fragments of the next 32 of depth are loaded before the products of
// these are issued, and the two steps of 16 sum into two accumulator
// sets, added at the end.
__device__ __forceinline__ void tile_product(float (&d)[2][4], uint32_t w0, uint32_t w1,
                                             uint32_t x_cur, int k, int ld, int lane) {
  float acc[2][2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][m][i] = 0.0f;
  // ldmatrix lane addresses: A rows lane & 15, depth + 8 for lanes 16-31;
  // B columns lane & 7, depth + 8 for lanes 8-15
  const uint32_t a_off = (uint32_t)(((lane & 15) * ld + (lane >> 4) * 8) * 2);
  const uint32_t a_addr[2] = {w0 + a_off, w1 + a_off};
  const uint32_t b_addr = x_cur + (uint32_t)(((lane & 7) * ld + ((lane >> 3) & 1) * 8) * 2);
  auto load = [&](Frags& f, int k0) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int kk = k0 + 16 * st;
      ldmatrix_x2(f.b[st][0], f.b[st][1], b_addr + kk * 2);
#pragma unroll
      for (int m = 0; m < 2; ++m) ldmatrix_x4(f.a[st][m], a_addr[m] + kk * 2);
    }
  };
  auto multiply = [&](const Frags& f) {
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_bf16(acc[st][m], f.a[st][m], f.b[st][0], f.b[st][1]);
  };
  // k is a multiple of 32
  Frags f[2];
  load(f[0], 0);
  int k0 = 32;
#pragma unroll 1
  for (; k0 + 32 < k; k0 += 64) {
    load(f[1], k0);
    multiply(f[0]);
    load(f[0], k0 + 32);
    multiply(f[1]);
  }
  if (k0 < k) {
    load(f[1], k0);
    multiply(f[0]);
    multiply(f[1]);
  } else {
    multiply(f[0]);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[m][i] = acc[0][m][i] + acc[1][m][i];
}

// What a timing variant of the bf16 chain leaves out (0: nothing, the
// chain itself): the products, or the sending of x to the peers (every
// CTA then arrives on its peers' barriers in its place); the
// synchronisation stays.  Its output is then not the chain's.  The
// variants give the split of one product's time (probes/chain_parts.py)
// that the sampler's cluster redesign is measured against; as template
// instances, they leave the chain's own instance (SKIP 0) untouched.
enum Skip { kSkipProducts = 1, kSkipExchange = 2 };

// The bf16 chain, one cluster a group of kChainCols columns at a time
// (see the header).  A CTA of rank r holds row tiles r pp ... below k
// (they feed the next product) and k/16 + r qq ... above.  Dynamic shared
// memory: the stripe, (pp + qq) 16 rows of ld = k + 8 bf16; two
// (kChainCols, ld) column-major buffers of x.  A product's rows below k
// go straight into the CTA's own next buffer, which its warps finished
// reading a product before; a __syncthreads orders them for its own
// warps.  Barrier full[i] completes when buffer i has the peers' rows of
// the next x and every peer has finished the product before: one local
// arrival, with the bytes expected from the peers' st.async, which they
// send after their __syncthreads, and one arrival from each peer that
// owns no rows below k, after its __syncthreads.  So no CTA writes into a
// buffer a peer still reads, and none runs two phases ahead of another.
template <int SKIP>
__global__ void __launch_bounds__(kClusterWarps * 32)
    cluster_chain_kernel(Args a, int pp, int qq) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[2];
  constexpr bool exchange = !(SKIP & kSkipExchange);
  const int k = a.k, b = a.b, ld = k + 8;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = ws + (size_t)(pp + qq) * 16 * ld;
  const int buf = kChainCols * ld;
  const unsigned rank = cluster_ctarank(), csize = cluster_nctarank();
  const int ptiles = k / 16, qtiles = a.m / 16 - ptiles;
  const int p0 = (int)rank * pp, my_p = max(0, min(pp, ptiles - p0));
  const int q0 = (int)rank * qq, my_q = max(0, min(qq, qtiles - q0));
  const int my_tiles = my_p + my_q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  // The CTAs 0 ... that own rows below k show their progress by those
  // rows; the others, and in the variant without the exchange every CTA,
  // by an arrival on each peer's barrier.
  const int producers = (ptiles + pp - 1) / pp;
  const bool arrives = my_p == 0 || !exchange;
  const unsigned arriving_peers =
      exchange ? csize - producers - (my_p == 0) : csize - 1;
  // x's rows a product brings from the peers, in bytes
  const unsigned remote_bytes =
      exchange ? (unsigned)((ptiles - my_p) * 16 * kChainCols * 2) : 0u;
  // the global row tile of the stripe's tile lt
  auto row_tile = [&](int lt) { return lt < my_p ? p0 + lt : ptiles + q0 + lt - my_p; };

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&full[0]), 1 + arriving_peers);
    mbar_init(smem_u32(&full[1]), 1 + arriving_peers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the stripe of W, once for the whole chain
  {
    const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(a.w);
    const int per_row = k / 8, total = my_tiles * 16 * per_row;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / per_row, c = (i - r * per_row) * 8;
      const size_t src = ((size_t)row_tile(r / 16) * 16 + (r & 15)) * k + c;
      cp_async16(smem_u32(ws + r * ld + c), W + src);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  unsigned parity = 0;  // bit i: the parity of full[i]'s next phase
  const int groups = b / kChainCols;
  for (int grp = (int)cluster_id(); grp < groups; grp += (int)n_clusters()) {
    const int c0 = grp * kChainCols;
    __syncthreads();  // the previous group's last product has read xs
    for (int i = threadIdx.x; i < k * kChainCols; i += blockDim.x) {
      const int r = i / kChainCols, n = i - r * kChainCols;
      xs[n * ld + r] = __float2bfloat16_rn(a.x[(size_t)r * b + c0 + n]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // W, x and the barriers ready in every CTA; no peer is still in the
    // previous group
    cluster_sync();
    for (int t = 0; t < a.iters; ++t) {
      const bool last = t == a.iters - 1;
      const int cb = t & 1, nb = cb ^ 1;
      const __nv_bfloat16* cur = xs + cb * buf;
      __nv_bfloat16* nxt = xs + nb * buf;
      if (t > 0) {
        mbar_wait(smem_u32(&full[cb]), (parity >> cb) & 1u);
        parity ^= 1u << cb;
      }
      for (int lt = 2 * warp; lt < my_tiles; lt += 2 * n_warps) {
        // tiles lt and lt + 1 (lt again where the stripe ends: computed
        // twice, stored once)
        const int lt1 = lt + 1 < my_tiles ? lt + 1 : lt;
        float d[2][4] = {};
        if (!(SKIP & kSkipProducts))
          tile_product(d, smem_u32(ws + (size_t)lt * 16 * ld),
                       smem_u32(ws + (size_t)lt1 * 16 * ld), smem_u32(cur), k, ld, lane);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int t16 = lt + m;
          // computed, as on the TPU, never stored: the rows above k
          if (t16 >= my_p || (m == 1 && lt1 == lt)) continue;
          const int r0 = (p0 + t16) * 16;
          // d[m][i]: row r0 + g (+ 8 for i >= 2), column 2 tq (+ 1 for
          // odd i)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = g + 8 * (i >> 1), col = 2 * tq + (i & 1);
            const __nv_bfloat16 v = __float2bfloat16_rn(d[m][i]);
            if (last)
              a.out[(size_t)(r0 + row) * b + c0 + col] = __bfloat162float(v);
            else
              nxt[col * ld + r0 + row] = v;
          }
        }
      }
      if (last) continue;
      // every warp of this CTA has read cur (peers may fill it once they
      // have this CTA's rows or arrival below) and stored its rows of nxt
      __syncthreads();
      const uint32_t bar = smem_u32(&full[nb]);
      if (threadIdx.x == 0) {
        mbar_arrive_expect(bar, remote_bytes);
      } else if (arrives && threadIdx.x < csize) {
        const unsigned p = threadIdx.x - 1;
        mbar_arrive_remote(bar, p + (p >= rank));
      }
      if (!exchange) continue;
      // each tile's rows of each column, 2 x 16 bytes, into every peer's
      // next buffer
      constexpr int kChunks = 2 * kChainCols;
      for (int lt = warp; lt < my_p; lt += n_warps) {
        const int r0 = (p0 + lt) * 16;
        for (int ch = lane; ch < kChunks; ch += 32) {
          const int col = ch >> 1, h = ch & 1;
          const __nv_bfloat16* src = nxt + col * ld + r0 + 8 * h;
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          for (unsigned peer = 0; peer < csize; ++peer)
            if (peer != rank) send16(v, smem_u32(src), bar, peer);
        }
      }
    }
  }
}

// The shared memory of cluster_chain_kernel at (m, k) on clusters of
// csize CTAs; the stripe's row tiles a CTA below k in *pp, above in *qq.
// probes/probe_i8_matmul.py::cluster_smem is this formula, and
// tests/test_torch_probes.py holds the two to each other.
size_t cluster_smem(int m, int k, int csize, int* pp, int* qq) {
  *pp = (k / 16 + csize - 1) / csize;
  *qq = ((m - k) / 16 + csize - 1) / csize;
  return ((size_t)(*pp + *qq) * 16 + 2 * kChainCols) * (k + 8) * 2;
}

// The bf16 chain on clusters of csize CTAs, as many clusters as there are
// column groups or as the card holds at once, whichever is fewer: then
// clusters walk over the groups.
template <int SKIP>
cudaError_t launch_chain(Args a, int csize, cudaStream_t stream) {
  int pp = 0, qq = 0;
  const size_t smem = cluster_smem(a.m, a.k, csize, &pp, &qq);
  if (smem > (size_t)kChainSmem) return cudaErrorInvalidValue;
  auto kernel = cluster_chain_kernel<SKIP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && csize > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // one warp a pair of the stripe's row tiles
  const int warps = (pp + qq + 1) / 2;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)csize);
  cfg.blockDim = dim3((unsigned)(32 * (warps < kClusterWarps ? warps : kClusterWarps)));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorLaunchOutOfResources;
  const int groups = a.b / kChainCols;
  cfg.gridDim = dim3((unsigned)((groups < active ? groups : active) * csize));
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, a, pp, qq);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ------------------------------------------------------ i8 and onehot arms

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
      if (r0 < k) {
        // d[i]: row r0 + g (+ 8 for i >= 2), column c0 + 2 tq (+ 1 for
        // odd i)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const size_t o = (size_t)(r0 + g + 8 * (i >> 1)) * b + c0 + 2 * tq + (i & 1);
          if (last)
            a.out[o] = v[i];
          else
            reinterpret_cast<float*>(a.xbuf)[(size_t)(t & 1) * k * b + o] = v[i];
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

bool valid(int m, int k, int b, int iters) {
  return m > 0 && m % 16 == 0 && k > 0 && k % 32 == 0 && k <= m && b > 0 &&
         b % 8 == 0 && iters >= 1;
}

}  // namespace

// Returns a cudaError_t code: 0 when the kernel was launched.  The i8 and
// onehot arms; xbuf holds two (k, b) f32 states.
extern "C" int fpsc_probe_i8_matmul(int arm, const void* w, const float* x,
                                    float* out, void* xbuf, int m, int k, int b,
                                    int iters, void* stream) {
  if (!valid(m, k, b, iters) || !w || !x || !out || !xbuf)
    return (int)cudaErrorInvalidValue;
  const Args a{w, x, out, xbuf, m, k, b, iters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case kI8: return (int)launch<kI8>(a, s);
    case kOneHot: return (int)launch<kOneHot>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 arm on clusters of `cluster` CTAs (1 to 8, or 16 where the
// card allows non-portable clusters); skip 0, or the parts (Skip) a
// timing variant leaves out.  A refused cluster launch or shared-memory
// size comes back as its cudaError_t code.
extern "C" int fpsc_probe_bf16_chain(const void* w, const float* x, float* out,
                                     int m, int k, int b, int iters, int cluster,
                                     int skip, void* stream) {
  if (!valid(m, k, b, iters) || !w || !x || !out || cluster < 1 ||
      (cluster > 8 && cluster != 16))
    return (int)cudaErrorInvalidValue;
  const Args a{w, x, out, nullptr, m, k, b, iters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (skip) {
    case 0: return (int)launch_chain<0>(a, cluster, s);
    case kSkipProducts: return (int)launch_chain<kSkipProducts>(a, cluster, s);
    case kSkipExchange: return (int)launch_chain<kSkipExchange>(a, cluster, s);
    case kSkipProducts | kSkipExchange:
      return (int)launch_chain<kSkipProducts | kSkipExchange>(a, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
