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
//             * f32(1 / 127^2); mma.sync m16n8k32 s8 -> s32
//             (cluster_chain_kernel);
//   2 onehot  idx = int(clip(x[0], 0, 255)) truncated, x <- f32(W_emb @
//             onehot(idx)) * 1e-4f, W_emb (m, 256); mma.sync m16n8k32
//             (onehot_chain_kernel).
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
// The design.  Column j of W @ x depends only on column j of x, so the b
// columns are independent chains.  A thread-block cluster of CTAs on
// neighbouring SMs owns a group of 8 columns and runs that group's whole
// chain; where b has more groups than the card holds clusters at once,
// clusters walk over groups.  The cluster has 6 CTAs, the fastest size
// of every arm (an H100 holds 17 such clusters of the bf16 arm at once
// against 15 of 8 CTAs, so b = 128 needs no walking), or 8 or 16 where
// W's stripe needs them (probe_i8_matmul.cluster_ctas).  No grid-wide
// barrier, no cooperative launch.  Each CTA holds a stripe of W in
// shared memory for the whole chain: ceil(k / 16 / CTAs) row tiles below
// k, which feed the next product, and ceil((m - k) / 16 / CTAs) above,
// loaded once with cp.async, each row's depth in bytes padded to 64
// (int8 at k = 32 mod 64: zeros on both sides of the product) and then
// by 16 bytes so that ldmatrix reads it without bank conflicts.  Each
// warp computes two 16-row tiles: A fragments by ldmatrix from the
// stripe.  The int8 A fragment of m16n8k32 (16 rows x 32 bytes) is byte
// for byte the bf16 one of m16n8k16, and so is B, so one tile_product
// serves both arms with 32 bytes of depth a step.  All m rows are
// computed, as on the TPU, though only the first k feed the next
// product: the mma statements are volatile, so the rows that are not
// stored are not optimised away.
//
// bf16 and i8 (cluster_chain_kernel<ARM, SKIP>).  B fragments by ldmatrix
// from the CTA's copy of x (bf16 or int8, column-major, double-buffered),
// each loaded once for both tiles, the next 64 bytes of depth loaded
// before the mma of these are issued.  A CTA rounds its rows below k
// (bf16), or scales them by 1/127^2 and quantises them (i8: once, at the
// producer), into its own next buffer and, after a __syncthreads (its
// warps have read the current x), stores them 16 bytes at a time into
// every peer's with st.async, whose bytes count on the peer's mbarrier
// for that buffer (a CTA without such rows arrives on every peer's
// instead): 6 KB a product for bf16, 3 KB for i8 at k = 384.  A CTA
// starts the next product when its barrier has all the peers' rows and
// arrivals.  No cluster-wide barrier a product: one at the start of each
// column group.  So what bounds a product is its latency: the
// ldmatrix-fed mma steps over the stripe, the distributed-shared-memory
// stores and their signal, and one __syncthreads; chain_parts.py times
// each.
//
// onehot (onehot_chain_kernel).  The operand is onehot(idx), and idx
// is row 0 of the product before: a function of W_emb's row 0 alone.
// So every CTA also holds W_emb's row tile 0 and every warp computes it
// beside its own two tiles, with the same B fragment, built in registers
// from its column's idx (the one byte set in the 32 of a step).  Each
// warp then has the next idx of all 8 columns (a shuffle from the lanes
// holding row 0) and runs its own chain: no shared x, no exchange, no
// barrier after W's load.  The product is 8 steps of m16n8k32 over the
// 256 levels, on three tiles a warp, whose A fragments (96 registers)
// the warp loads from the stripe once and keeps for the whole chain
// (a warp with more than one pair of tiles reads the others' from the
// stripe each product): on an H100, 24% faster than reading all of them
// from the stripe each product.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (plain C interface, loaded with ctypes).

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kEmbRows = 256;
// the f32 constants JAX multiplies by: Python floats rounded to f32
constexpr float kInv127Sq = (float)(1.0 / (127.0 * 127.0));
constexpr float kOneHotScale = 1e-4f;
// The columns of x a cluster carries, at most this many warps a CTA
// (they walk over the stripe's tiles beyond), and the dynamic shared
// memory one CTA may take: the card's 232,448 bytes less the two
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
  int m, k, b, iters;
};

// One step of 32 bytes of depth: 16 bf16 -> f32, or 32 int8 -> int32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// clip(round-half-even(127 v), -127, 127) as an int8 bit pattern
__device__ __forceinline__ uint32_t quantize(float v) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, 127.0f)), -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// int(clip(v, 0, 255)), truncated: the onehot arm's index
__device__ __forceinline__ int hot_index(float v) {
  return (int)fminf(fmaxf(v, 0.0f), 255.0f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// The bytes of a row of W's stripe, and of a column of x: the depth in
// bytes padded to 64, then by 16 against bank conflicts.
__host__ __device__ constexpr int row_bytes(int depth) {
  return (depth + 63) / 64 * 64 + 16;
}

// A CTA's stripe of W: of W's k / 16 row tiles below k, `my_p` from p0
// on; of those above, `my_q` from q0 on (in the rows above k).
struct Stripe {
  int ptiles, p0, my_p, q0, my_q, tiles;
  __device__ Stripe(int m, int k, int pp, int qq, int rank)
      : ptiles(k / 16),
        p0(rank * pp),
        my_p(max(0, min(pp, k / 16 - rank * pp))),
        q0(rank * qq),
        my_q(max(0, min(qq, (m - k) / 16 - rank * qq))),
        tiles(my_p + my_q) {}
  // W's row tile of the stripe's tile lt
  __device__ int row_tile(int lt) const {
    return lt < my_p ? p0 + lt : ptiles + q0 + lt - my_p;
  }
};

// cp.async of `tiles` 16-row tiles of W (rows of `depth` bytes; the
// stripe's tile lt is W's row tile tile_of(lt)) into shared memory at
// dst, rows ldb bytes apart.
template <typename TileOf>
__device__ __forceinline__ void load_tiles(uint32_t dst, const unsigned char* W,
                                           int tiles, int depth, int ldb,
                                           TileOf tile_of) {
  const int per_row = depth / 16, total = tiles * 16 * per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * 16;
    cp_async16(dst + r * ldb + c,
               W + ((size_t)tile_of(r / 16) * 16 + (r & 15)) * depth + c);
  }
}

// Zero bytes [from, to) of `rows` rows ld bytes apart at p (16-byte
// multiples): the depth padding of the int8 arm.
__device__ __forceinline__ void zero_pad(unsigned char* p, int rows, int from, int to,
                                         int ld) {
  const int per_row = (to - from) / 16;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x)
    *reinterpret_cast<uint4*>(p + (i / per_row) * ld + from + (i % per_row) * 16) =
        make_uint4(0, 0, 0, 0);
}

// The fragments of two depth steps of 32 bytes for two 16-row tiles: A
// from the W stripe, B from x.
struct Frags {
  uint32_t a[2][2][4];  // [step][tile]
  uint32_t b[2][2];     // [step]
};

// Two 16-row tiles of W @ x over `depth` bytes (a multiple of 64), on the
// 8 columns of x: A from the W stripe (rows ldb bytes apart), B from x
// stored column-major (columns ldb bytes apart), each B fragment loaded
// once for both row tiles.  The fragments of the next 64 bytes are
// loaded before the products of these are issued, and the two steps of
// 32 bytes sum into two accumulator sets, added at the end.
template <typename Acc>
__device__ __forceinline__ void tile_product(Acc (&d)[2][4], uint32_t w0, uint32_t w1,
                                             uint32_t x_cur, int depth, int ldb,
                                             int lane) {
  Acc acc[2][2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][m][i] = 0;
  // ldmatrix lane addresses: A rows lane & 15, depth + 16 bytes for lanes
  // 16-31; B columns lane & 7, depth + 16 bytes for lanes 8-15
  const uint32_t a_off = (uint32_t)((lane & 15) * ldb + (lane >> 4) * 16);
  const uint32_t a_addr[2] = {w0 + a_off, w1 + a_off};
  const uint32_t b_addr = x_cur + (uint32_t)((lane & 7) * ldb + ((lane >> 3) & 1) * 16);
  auto load = [&](Frags& f, int k0) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int kk = k0 + 32 * st;
      ldmatrix_x2(f.b[st], b_addr + kk);
#pragma unroll
      for (int m = 0; m < 2; ++m) ldmatrix_x4(f.a[st][m], a_addr[m] + kk);
    }
  };
  auto multiply = [&](const Frags& f) {
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int m = 0; m < 2; ++m) mma(acc[st][m], f.a[st][m], f.b[st]);
  };
  Frags f[2];
  load(f[0], 0);
  int k0 = 64;
#pragma unroll 1
  for (; k0 + 64 < depth; k0 += 128) {
    load(f[1], k0);
    multiply(f[0]);
    load(f[0], k0 + 64);
    multiply(f[1]);
  }
  if (k0 < depth) {
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

// What a timing variant of the bf16 or i8 chain leaves out (0: nothing,
// the chain itself): the products, or the sending of x to the peers
// (every CTA then arrives on its peers' barriers in its place); the
// synchronisation stays.  Its output is then not the chain's.  The
// variants give the split of one product's time (probes/chain_parts.py);
// as template instances, they leave the chain's own instance (SKIP 0)
// untouched.
enum Skip { kSkipProducts = 1, kSkipExchange = 2 };

// The bf16 or i8 chain, one cluster a group of kChainCols columns at a
// time (see the header).  A CTA of rank r holds row tiles r pp ... below
// k (they feed the next product) and k/16 + r qq ... above.  Dynamic
// shared memory: the stripe, (pp + qq) 16 rows of ldb bytes; two
// (kChainCols, ldb) column-major buffers of x.  A product's rows below k
// go straight into the CTA's own next buffer, which its warps finished
// reading a product before; a __syncthreads orders them for its own
// warps.  Barrier full[i] completes when buffer i has the peers' rows of
// the next x and every peer has finished the product before: one local
// arrival, with the bytes expected from the peers' st.async, which they
// send after their __syncthreads, and one arrival from each peer that
// owns no rows below k, after its __syncthreads.  So no CTA writes into a
// buffer a peer still reads, and none runs two phases ahead of another.
template <int ARM, int SKIP>
__global__ void __launch_bounds__(kClusterWarps * 32)
    cluster_chain_kernel(Args a, int pp, int qq) {
  static_assert(ARM == kBf16 || ARM == kI8, "the arms that exchange x");
  using Acc = std::conditional_t<ARM == kBf16, float, int>;
  constexpr int E = ARM == kBf16 ? 2 : 1;  // bytes of an element of W and x
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[2];
  constexpr bool exchange = !(SKIP & kSkipExchange);
  const int k = a.k, b = a.b, kb = k * E, ldb = row_bytes(kb), depth = ldb - 16;
  unsigned char* ws = smem;
  unsigned char* xs = ws + (size_t)(pp + qq) * 16 * ldb;
  const int buf = kChainCols * ldb;
  const unsigned rank = cluster_ctarank(), csize = cluster_nctarank();
  const Stripe s(a.m, k, pp, qq, (int)rank);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  // The CTAs 0 ... that own rows below k show their progress by those
  // rows; the others, and in the variant without the exchange every CTA,
  // by an arrival on each peer's barrier.
  const int producers = (s.ptiles + pp - 1) / pp;
  const bool arrives = s.my_p == 0 || !exchange;
  const unsigned arriving_peers =
      exchange ? csize - producers - (s.my_p == 0) : csize - 1;
  // x's rows a product brings from the peers, in bytes
  const unsigned remote_bytes =
      exchange ? (unsigned)((s.ptiles - s.my_p) * 16 * kChainCols * E) : 0u;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&full[0]), 1 + arriving_peers);
    mbar_init(smem_u32(&full[1]), 1 + arriving_peers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the stripe of W, once for the whole chain; zeros in the depth padding
  // of W's rows and of x's columns, which nothing writes after
  load_tiles(smem_u32(ws), static_cast<const unsigned char*>(a.w), s.tiles, kb, ldb,
             [&](int lt) { return s.row_tile(lt); });
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (depth > kb) {
    zero_pad(ws, s.tiles * 16, kb, depth, ldb);
    zero_pad(xs, 2 * kChainCols, kb, depth, ldb);
  }
  unsigned parity = 0;  // bit i: the parity of full[i]'s next phase
  const int groups = b / kChainCols;
  for (int grp = (int)cluster_id(); grp < groups; grp += (int)n_clusters()) {
    const int c0 = grp * kChainCols;
    __syncthreads();  // the previous group's last product has read xs
    for (int i = threadIdx.x; i < k * kChainCols; i += blockDim.x) {
      const int r = i / kChainCols, n = i - r * kChainCols;
      const float v = a.x[(size_t)r * b + c0 + n];
      if constexpr (ARM == kBf16)
        reinterpret_cast<__nv_bfloat16*>(xs + n * ldb)[r] = __float2bfloat16_rn(v);
      else
        xs[n * ldb + r] = (unsigned char)quantize(v);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // W, x and the barriers ready in every CTA; no peer is still in the
    // previous group
    cluster_sync();
    for (int t = 0; t < a.iters; ++t) {
      const bool last = t == a.iters - 1;
      const int cb = t & 1, nb = cb ^ 1;
      const unsigned char* cur = xs + cb * buf;
      unsigned char* nxt = xs + nb * buf;
      if (t > 0) {
        mbar_wait(smem_u32(&full[cb]), (parity >> cb) & 1u);
        parity ^= 1u << cb;
      }
      for (int lt = 2 * warp; lt < s.tiles; lt += 2 * n_warps) {
        // tiles lt and lt + 1 (lt again where the stripe ends: computed
        // twice, stored once)
        const int lt1 = lt + 1 < s.tiles ? lt + 1 : lt;
        Acc d[2][4] = {};
        if (!(SKIP & kSkipProducts))
          tile_product(d, smem_u32(ws + (size_t)lt * 16 * ldb),
                       smem_u32(ws + (size_t)lt1 * 16 * ldb), smem_u32(cur), depth,
                       ldb, lane);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int t16 = lt + m;
          // computed, as on the TPU, never stored: the rows above k
          if (t16 >= s.my_p || (m == 1 && lt1 == lt)) continue;
          const int r0 = (s.p0 + t16) * 16;
          // d[m][i]: row r0 + g (+ 8 for i >= 2), column 2 tq (+ 1 for
          // odd i)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = g + 8 * (i >> 1), col = 2 * tq + (i & 1);
            float* o = a.out + (size_t)(r0 + row) * b + c0 + col;
            if constexpr (ARM == kBf16) {
              const __nv_bfloat16 v = __float2bfloat16_rn(d[m][i]);
              if (last)
                *o = __bfloat162float(v);
              else
                reinterpret_cast<__nv_bfloat16*>(nxt + col * ldb)[r0 + row] = v;
            } else {
              const float v = __fmul_rn((float)d[m][i], kInv127Sq);
              if (last)
                *o = v;
              else
                nxt[col * ldb + r0 + row] = (unsigned char)quantize(v);
            }
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
      // each tile's rows of each column, E x 16 bytes, into every peer's
      // next buffer
      constexpr int kChunks = E * kChainCols;
      for (int lt = warp; lt < s.my_p; lt += n_warps) {
        const int r0 = (s.p0 + lt) * 16;
        for (int ch = lane; ch < kChunks; ch += 32) {
          const int col = ch / E, h = ch % E;
          const unsigned char* src = nxt + col * ldb + r0 * E + 16 * h;
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          for (unsigned peer = 0; peer < csize; ++peer)
            if (peer != rank) send16(v, smem_u32(src), bar, peer);
        }
      }
    }
  }
}

// A 32-bit word of a one-hot B fragment, levels `level` ... level + 3 of
// a column: byte e is 1 where level + e is the column's idx.
__device__ __forceinline__ uint32_t hot_word(int idx, int level) {
  const unsigned off = (unsigned)(idx - level);
  return off < 4u ? 1u << (8 * off) : 0u;
}

constexpr int kHotSteps = kEmbRows / 32;

// The one-hot B fragment of depth step st: levels 32 st + 4 tq ... and
// 16 more.
__device__ __forceinline__ void hot_fragment(uint32_t (&bf)[2], int idx, int st, int tq) {
  bf[0] = hot_word(idx, 32 * st + 4 * tq);
  bf[1] = hot_word(idx, 32 * st + 16 + 4 * tq);
}

// Three 16-row tiles of W_emb @ onehot(idx) over the 256 levels, A from
// the stripe at a[j] (this lane's ldmatrix address), B in registers; the
// fragments of the next step loaded before this step's mma, the steps
// summed alternately into two accumulator sets.
__device__ __forceinline__ void onehot_product(int (&d)[3][4], const uint32_t (&a)[3],
                                               int idx, int tq) {
  int acc[2][3][4] = {};
  uint32_t f[2][3][4];
#pragma unroll
  for (int j = 0; j < 3; ++j) ldmatrix_x4(f[0][j], a[j]);
#pragma unroll
  for (int st = 0; st < kHotSteps; ++st) {
    if (st + 1 < kHotSteps) {
#pragma unroll
      for (int j = 0; j < 3; ++j) ldmatrix_x4(f[(st + 1) & 1][j], a[j] + 32 * (st + 1));
    }
    uint32_t bf[2];
    hot_fragment(bf, idx, st, tq);
#pragma unroll
    for (int j = 0; j < 3; ++j) mma(acc[st & 1][j], f[st & 1][j], bf);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = acc[0][j][i] + acc[1][j][i];
}

// The same product with the A fragments of all 8 steps in registers.
__device__ __forceinline__ void onehot_product(int (&d)[3][4],
                                               const uint32_t (&f)[3][kHotSteps][4],
                                               int idx, int tq) {
  int acc[2][3][4] = {};
#pragma unroll
  for (int st = 0; st < kHotSteps; ++st) {
    uint32_t bf[2];
    hot_fragment(bf, idx, st, tq);
#pragma unroll
    for (int j = 0; j < 3; ++j) mma(acc[st & 1][j], f[j][st], bf);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = acc[0][j][i] + acc[1][j][i];
}

// The onehot chain (see the header), one cluster a group of kChainCols
// columns at a time.  Dynamic shared memory: the stripe, (pp + qq) 16
// rows of 272 bytes, then W_emb's row tile 0.  Each warp computes its
// two tiles and tile 0 together (their A fragments in registers), takes
// the next idx of its column from tile 0's row 0, and goes on: warps
// wait on nothing after W's load.
__global__ void __launch_bounds__(kClusterWarps * 32)
    onehot_chain_kernel(Args a, int pp, int qq) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldb = row_bytes(kEmbRows);
  const int k = a.k, b = a.b;
  const Stripe s(a.m, k, pp, qq, (int)cluster_ctarank());
  const unsigned char* W = static_cast<const unsigned char*>(a.w);
  const uint32_t ws = smem_u32(smem), w_top = ws + (uint32_t)((pp + qq) * 16 * ldb);
  load_tiles(ws, W, s.tiles, kEmbRows, ldb, [&](int lt) { return s.row_tile(lt); });
  load_tiles(w_top, W, 1, kEmbRows, ldb, [](int) { return 0; });
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t a_off = (uint32_t)((lane & 15) * ldb + (lane >> 4) * 16);
  auto tiles_at = [&](uint32_t (&at)[3], int lt) {
    const int lt1 = lt + 1 < s.tiles ? lt + 1 : lt;
    at[0] = ws + (uint32_t)(lt * 16 * ldb) + a_off;
    at[1] = ws + (uint32_t)(lt1 * 16 * ldb) + a_off;
    at[2] = w_top + a_off;
  };
  // the warp's first two tiles and tile 0, in registers for the whole chain
  uint32_t own[3][kHotSteps][4];
  if (2 * warp < s.tiles) {
    uint32_t at[3];
    tiles_at(at, 2 * warp);
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int st = 0; st < kHotSteps; ++st) ldmatrix_x4(own[j][st], at[j] + 32 * st);
  }
  const int groups = b / kChainCols;
  for (int grp = (int)cluster_id(); grp < groups; grp += (int)n_clusters()) {
    const int c0 = grp * kChainCols;
    // this lane's column of B is c0 + g
    int idx = hot_index(a.x[c0 + g]);
    for (int t = 0; t < a.iters; ++t) {
      const bool last = t == a.iters - 1;
      int next = idx;
      for (int lt = 2 * warp; lt < s.tiles; lt += 2 * n_warps) {
        const int lt1 = lt + 1 < s.tiles ? lt + 1 : lt;
        int d[3][4];
        if (lt == 2 * warp) {
          onehot_product(d, own, idx, tq);
        } else {
          uint32_t at[3];
          tiles_at(at, lt);
          onehot_product(d, at, idx, tq);
        }
        // row 0 of tile 0 lies in lanes 0-3: d[2][0] at column 2 tq, d[2][1]
        // at 2 tq + 1
        const int v0 = __shfl_sync(0xffffffffu, d[2][0], g >> 1);
        const int v1 = __shfl_sync(0xffffffffu, d[2][1], g >> 1);
        next = hot_index(__fmul_rn((float)(g & 1 ? v1 : v0), kOneHotScale));
        if (!last) continue;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int t16 = lt + m;
          // computed, as on the TPU, never stored: the rows above k
          if (t16 >= s.my_p || (m == 1 && lt1 == lt)) continue;
          const int r0 = (s.p0 + t16) * 16;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a.out[(size_t)(r0 + g + 8 * (i >> 1)) * b + c0 + 2 * tq + (i & 1)] =
                __fmul_rn((float)d[m][i], kOneHotScale);
        }
      }
      idx = next;
    }
  }
}

// The shared memory of the arm's chain kernel at (m, k) on clusters of
// csize CTAs; the stripe's row tiles a CTA below k in *pp, above in *qq:
// the stripe, and two buffers of x (bf16, i8) or W's row tile 0
// (onehot), in rows of row_bytes(depth).
// probes/probe_i8_matmul.py::cluster_smem is this formula, and
// tests/test_torch_probes.py holds the two to each other.
size_t cluster_smem(int arm, int m, int k, int csize, int* pp, int* qq) {
  *pp = (k / 16 + csize - 1) / csize;
  *qq = ((m - k) / 16 + csize - 1) / csize;
  const int depth = (arm == kOneHot ? kEmbRows : k) * (arm == kBf16 ? 2 : 1);
  const int extra = (arm == kOneHot ? 16 : 2 * kChainCols);
  return ((size_t)(*pp + *qq) * 16 + extra) * row_bytes(depth);
}

// The arm's chain on clusters of csize CTAs, as many clusters as there
// are column groups or as the card holds at once, whichever is fewer:
// then clusters walk over the groups.
cudaError_t launch_chain(void (*kernel)(Args, int, int), int arm, Args a, int csize,
                         cudaStream_t stream) {
  int pp = 0, qq = 0;
  const size_t smem = cluster_smem(arm, a.m, a.k, csize, &pp, &qq);
  if (smem > (size_t)kChainSmem) return cudaErrorInvalidValue;
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

template <int ARM>
cudaError_t launch_exchanging(Args a, int csize, int skip, cudaStream_t s) {
  switch (skip) {
    case 0: return launch_chain(cluster_chain_kernel<ARM, 0>, ARM, a, csize, s);
    case kSkipProducts:
      return launch_chain(cluster_chain_kernel<ARM, kSkipProducts>, ARM, a, csize, s);
    case kSkipExchange:
      return launch_chain(cluster_chain_kernel<ARM, kSkipExchange>, ARM, a, csize, s);
    case kSkipProducts | kSkipExchange:
      return launch_chain(cluster_chain_kernel<ARM, kSkipProducts | kSkipExchange>, ARM,
                          a, csize, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(int m, int k, int b, int iters) {
  return m > 0 && m % 16 == 0 && k > 0 && k % 32 == 0 && k <= m && b > 0 &&
         b % 8 == 0 && iters >= 1;
}

}  // namespace

// The arm's chain on clusters of `cluster` CTAs (1 to 8, or 16 where the
// card allows non-portable clusters); skip 0, or for bf16 and i8 the
// parts (Skip) a timing variant leaves out.  Returns a cudaError_t code:
// 0 when the kernel was launched; a refused cluster launch or
// shared-memory size comes back as its code.
extern "C" int fpsc_probe_i8_matmul(int arm, const void* w, const float* x, float* out,
                                    int m, int k, int b, int iters, int cluster,
                                    int skip, void* stream) {
  if (!valid(m, k, b, iters) || !w || !x || !out || cluster < 1 ||
      (cluster > 8 && cluster != 16))
    return (int)cudaErrorInvalidValue;
  const Args a{w, x, out, m, k, b, iters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case kBf16: return (int)launch_exchanging<kBf16>(a, cluster, skip, s);
    case kI8: return (int)launch_exchanging<kI8>(a, cluster, skip, s);
    case kOneHot:
      return skip ? (int)cudaErrorInvalidValue
                  : (int)launch_chain(onehot_chain_kernel, kOneHot, a, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
