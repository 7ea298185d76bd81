// The CUDA-core popcount kernels for Hopper (sm_90a): K3, the
// popcount-reduce of the count path; K8, the per-row popcounts of TopN and
// of Sum's planes; K9, the per-shard plane walk of Min and Max; K10, the
// fused walk of one BSI condition.
//
// Stacks are int32[S, R, W] with W = 32768 words per shard row (one shard of
// 2^20 columns); the bits are the same as the uint32 layout the host packs.
// K3 reads each word once and popcounts it on the CUDA cores. Two rates
// bound it on an H100 SXM: the memory rate (3.35 TB/s), and the popcount
// issue rate, 16 a clock per SM (CUDA C++ Programming Guide, arithmetic
// instruction throughput, compute capability 9.0): 132 SMs x 1.98 GHz x 16
// = 4.2e12 a second. One popcount per 4 bytes read is bound by the bytes.
// (The pair and group kernels K1, K2 and K4 to K7 run on the tensor cores'
// binary MMA, in bmma.cu.) Design against that:
//
//   - threads read 16-byte vectors (uint4), neighbouring threads on
//     neighbouring addresses, so every warp load is a full 512-byte burst;
//   - partial sums live in registers for the whole row and are reduced
//     once per block, with warp shuffles and a small shared-memory table;
//   - each block owns its output, so no atomics are needed.
//
// K8 to K10 are byte streams of the same kind: a row against one mask is a
// matrix-vector product (N = 1), which would leave 7/8 of the b1 MMA's
// output unused, and the plane walks are bitwise ops with at most one
// popcount a word, so they stay on the CUDA cores beside K3.
//
// Each entry point returns cudaGetLastError() right after its launch, so a
// launch the card refuses is reported to the caller instead of being lost.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t popc4(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// K3. The per-row popcount-reduce of the count program: the counterpart of
// jnp.sum(population_count(slab), -1) in the JAX package's fused count
// program (pilosa_tpu/exec/tpu.py:2074; PyTorch has no popcount operator).
// A pure byte stream: one block per row, 16-byte loads, one register sum
// per thread, one shuffle reduction per block.
__global__ void __launch_bounds__(kThreads)
popcount_rows_kernel(const uint4* __restrict__ x, int32_t* __restrict__ out,
                     int w4) {
  const uint4* row = x + (size_t)blockIdx.x * w4;
  uint32_t c = 0u;
  for (int i = threadIdx.x; i < w4; i += kThreads) c += popc4(__ldg(row + i));
  __shared__ uint32_t red[kWarps];
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t v = 0u;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[wi];
    out[blockIdx.x] = (int32_t)v;
  }
}

__device__ __forceinline__ uint4 and4(const uint4& a, const uint4& b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ uint4 andnot4(const uint4& a, const uint4& b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}

__device__ __forceinline__ int any4(const uint4& v) {
  return (v.x | v.y | v.z | v.w) != 0u;
}

// Sum over the block of one value a thread; the result is valid in thread 0.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t total = 0u;
  if (threadIdx.x == 0) {
    const int warps = blockDim.x >> 5;
    for (int wi = 0; wi < warps; ++wi) total += red[wi];
  }
  return total;
}

// K8. Per-row popcounts of a stack's rows row0 .. row0 + n_rows, each row
// ANDed with M in {0, 1, 2} per-shard mask slabs: the counterpart of the
// JAX package's topn_plain / topn_src programs and of bsi_sum's plane
// counts (pilosa_tpu/exec/tpu.py:2134, :2156, :2172). Bound by bytes: each
// row is read once from device memory; a shard's mask slab (128 KiB) is
// read again by each of that shard's rows, which neighbouring blocks run
// at the same time, so those re-reads hit L2. One block per (shard, row),
// K3's 16-byte loads and shuffle reduction, one register sum per mask.
template <int M>
__global__ void __launch_bounds__(kThreads)
row_popcounts_kernel(const uint4* __restrict__ stack, const uint4* __restrict__ m0,
                     const uint4* __restrict__ m1, int32_t* __restrict__ out,
                     int r, int row0, int n_rows, int w4, int total) {
  const int s = blockIdx.x / n_rows;
  const int rr = blockIdx.x - s * n_rows;
  const uint4* row = stack + ((size_t)s * r + row0 + rr) * w4;
  const size_t mo = (size_t)s * w4;
  uint32_t c0 = 0u, c1 = 0u;
  for (int i = threadIdx.x; i < w4; i += kThreads) {
    const uint4 v = __ldg(row + i);
    if (M == 0) {
      c0 += popc4(v);
    } else {
      c0 += popc4(and4(v, __ldg(m0 + mo + i)));
      if (M == 2) c1 += popc4(and4(v, __ldg(m1 + mo + i)));
    }
  }
  __shared__ uint32_t red[kWarps];
  c0 = block_sum(c0, red);
  if (threadIdx.x == 0) out[blockIdx.x] = (int32_t)c0;
  if (M == 2) {
    __syncthreads();  // red is reused
    c1 = block_sum(c1, red);
    if (threadIdx.x == 0) out[(size_t)total + blockIdx.x] = (int32_t)c1;
  }
}

// K9. The Min/Max plane walk of one shard, both branches: the counterpart
// of the whole bsi_min / bsi_max program body (pilosa_tpu/exec/tpu.py:2204).
// Stack rows: 0 exists, 1 sign, 2 + i plane i.
//
//   consider = exists [& filt];
//   branch 0 (maxUnsigned, fragment.go:1216) starts from
//     sign & consider (min) or consider & ~sign (max): from the top plane
//     down, row = plane & run; the bit is "row has a bit"; if so, run = row;
//   branch 1 (minUnsigned, fragment.go:1198) starts from consider:
//     row = run & ~plane; the bit is "row is empty"; if not, run = row;
//   then the popcount of run, and whether the branch's start had a bit.
//
// Each plane's decision needs the whole shard's 128 KiB slab, and two
// running filters of that size do not fit one block. So a shard is a
// thread-block cluster of kMmCluster blocks (Hopper's distributed shared
// memory): each block owns 1/kMmCluster of the shard's words and keeps
// both branches' running filters for them in registers (kMmVec uint4 a
// thread), so every input word is read from device memory once. Per plane,
// each warp ORs its two "row has a bit" flags, stores them as one byte into
// every peer block's flag table, and the cluster passes one barrier
// (barrier.cluster arrive/wait: the peers' stores are visible after it);
// every thread then ORs the table and applies the same decision. The table
// is double-buffered by step parity: a step's slot is written again only
// two steps later, after a barrier every reader has passed, and each byte
// is overwritten whole, so no second barrier is needed. The planes stream
// in ahead of the decision: one thread keeps the next planes' slices in
// flight with TMA bulk copies (cp.async.bulk) into a ring in shared memory,
// each slot completing on its own mbarrier, and reissues a slot right after
// the barrier that follows its last read. The decision chain (one cluster
// barrier a plane) bounds a cluster, so as many clusters as fit stay
// resident: four blocks an SM. Bound by bytes.
constexpr int kMmCluster = 8;   // blocks a shard (the portable cluster maximum)
constexpr int kMmThreads = 256;
constexpr int kMmWarps = kMmThreads / 32;
constexpr int kMmVec = 4;       // uint4 a thread: w4 <= kMmCluster * kMmThreads * kMmVec
constexpr int kMmStages = 3;    // ring slots a block: kMmStages - 1 planes ahead
constexpr int kMmBlocksPerSm = 4;  // 48 KiB of ring each, at most 64 registers a thread
// A wait on a plane's copy that outlasts this many clocks (about a second)
// traps, so a lost copy fails the launch instead of hanging the card.
constexpr long long kWaitClocks = 2000000000LL;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitClocks) __trap();
  }
}

// One thread: arm `bar` for `bytes` and copy them from global to shared
// memory with the TMA (16-byte aligned, a multiple of 16 bytes).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  if (bytes) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t block_rank_in_cluster() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The generic address of `p` (this block's shared memory) in block `rank`
// of the cluster.
template <typename T>
__device__ __forceinline__ T* peer(T* p, uint32_t rank) {
  uint64_t remote;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(remote) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(remote);
}

// The OR over the cluster of each warp's two-bit flag `b` (bit 0 branch 0,
// bit 1 branch 1), through flag table `slot`.
__device__ __forceinline__ uint32_t cluster_or(uint32_t b, uint8_t (*flags)[kMmCluster * kMmWarps],
                                               int slot, uint32_t rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  b = (__any_sync(0xffffffffu, b & 1u) ? 1u : 0u) | (__any_sync(0xffffffffu, b & 2u) ? 2u : 0u);
  if (lane < kMmCluster) *peer(&flags[slot][rank * kMmWarps + warp], lane) = (uint8_t)b;
  cluster_sync_all();
  const uint4* t = reinterpret_cast<const uint4*>(flags[slot]);
  uint32_t x = 0u;
#pragma unroll
  for (int k = 0; k < kMmCluster * kMmWarps / 16; ++k) {
    const uint4 v = t[k];
    x |= v.x | v.y | v.z | v.w;
  }
  x |= x >> 16;
  x |= x >> 8;
  return x & 3u;
}

template <bool kMin>
__global__ void __cluster_dims__(kMmCluster, 1, 1) __launch_bounds__(kMmThreads, kMmBlocksPerSm)
bsi_minmax_kernel(const uint4* __restrict__ stack, const uint4* __restrict__ filt,
                  int32_t* __restrict__ out, int s_count, int r, int depth, int w4) {
  extern __shared__ uint4 ring[];  // kMmStages slices of v uint4
  __shared__ __align__(8) uint64_t bar[kMmStages];
  __shared__ __align__(16) uint8_t flags[2][kMmCluster * kMmWarps];
  __shared__ uint32_t red[2][kMmWarps];
  __shared__ uint32_t fin[kMmCluster][2];
  const uint32_t rank = block_rank_in_cluster();
  const int s = blockIdx.x / kMmCluster;
  const int v = (w4 + kMmCluster - 1) / kMmCluster;
  const int lo = min((int)rank * v, w4);
  const int nv = min(v, w4 - lo);  // this block's words, as uint4; may be 0
  const uint4* base = stack + (size_t)s * r * w4 + lo;
  const int tid = threadIdx.x;

  // Plane j of the walk (plane depth - 1 - j) into ring slot j % kMmStages.
  auto issue = [&](int j) {
    const int slot = j % kMmStages;
    bulk_load(ring + (size_t)slot * v, base + (size_t)(1 + depth - j) * w4,
              (uint32_t)nv * sizeof(uint4), &bar[slot]);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kMmStages; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < kMmStages && j < depth; ++j) issue(j);
  }

  uint4 run0[kMmVec], run1[kMmVec];
  uint32_t any = 0u;
#pragma unroll
  for (int k = 0; k < kMmVec; ++k) {
    const int i = tid + k * kMmThreads;
    run0[k] = run1[k] = make_uint4(0u, 0u, 0u, 0u);
    if (i < nv) {
      uint4 c = __ldg(base + i);
      if (filt != nullptr) c = and4(c, __ldg(filt + (size_t)s * w4 + lo + i));
      const uint4 sg = __ldg(base + w4 + i);
      run0[k] = kMin ? and4(sg, c) : andnot4(c, sg);
      run1[k] = c;
      any |= (uint32_t)any4(run0[k]) | (uint32_t)any4(run1[k]) << 1;
    }
  }
  __syncthreads();       // the barriers are initialised
  cluster_sync_all();    // every block of the cluster runs: peers may be written
  const uint32_t start_any = cluster_or(any, flags, 0, rank);

  int32_t* o0 = out + (size_t)s * (depth + 2);
  int32_t* o1 = out + ((size_t)s_count + s) * (depth + 2);
  for (int j = 0; j < depth; ++j) {
    const int slot = j % kMmStages;
    mbar_wait(&bar[slot], (uint32_t)(j / kMmStages) & 1u);
    const uint4* sl = ring + (size_t)slot * v;
    uint32_t nz = 0u;
#pragma unroll
    for (int k = 0; k < kMmVec; ++k) {
      const int i = tid + k * kMmThreads;
      const uint4 q = i < nv ? sl[i] : make_uint4(0u, 0u, 0u, 0u);
      nz |= (uint32_t)any4(and4(q, run0[k])) | (uint32_t)any4(andnot4(run1[k], q)) << 1;
    }
    const uint32_t bits = cluster_or(nz, flags, (j + 1) & 1, rank);
    // Every thread of the block finished step j - 1, its last read of that
    // step's slot, before this barrier: refill the slot.
    if (tid == 0 && j >= 1 && j - 1 + kMmStages < depth) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(j - 1 + kMmStages);
    }
    // The slice is read again rather than held in registers across the
    // barrier, which leaves room for four blocks an SM.
#pragma unroll
    for (int k = 0; k < kMmVec; ++k) {
      const int i = tid + k * kMmThreads;
      const uint4 q = i < nv ? sl[i] : make_uint4(0u, 0u, 0u, 0u);
      if (bits & 1u) run0[k] = and4(q, run0[k]);
      if (bits & 2u) run1[k] = andnot4(run1[k], q);
    }
    if (rank == 0 && tid == 0) {
      const int p = depth - 1 - j;
      o0[p] = (int32_t)(bits & 1u);
      o1[p] = (int32_t)!(bits & 2u);
    }
  }

  uint32_t c0 = 0u, c1 = 0u;
#pragma unroll
  for (int k = 0; k < kMmVec; ++k) {
    c0 += popc4(run0[k]);
    c1 += popc4(run1[k]);
  }
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = c0;
    red[1][tid >> 5] = c1;
  }
  __syncthreads();
  if (tid == 0) {
    uint32_t t0 = 0u, t1 = 0u;
#pragma unroll
    for (int wi = 0; wi < kMmWarps; ++wi) {
      t0 += red[0][wi];
      t1 += red[1][wi];
    }
    uint32_t* dst = peer(&fin[rank][0], 0);
    dst[0] = t0;
    dst[1] = t1;
  }
  cluster_sync_all();  // also keeps every block's shared memory alive until here
  if (rank == 0 && tid == 0) {
    uint32_t t0 = 0u, t1 = 0u;
#pragma unroll
    for (int q = 0; q < kMmCluster; ++q) {
      t0 += fin[q][0];
      t1 += fin[q][1];
    }
    o0[depth] = (int32_t)t0;
    o1[depth] = (int32_t)t1;
    o0[depth + 1] = (int32_t)(start_any & 1u);
    o1[depth + 1] = (int32_t)(start_any >> 1);
  }
}

// K10. One BSI condition over a BSI stack: the counterpart of the C and CB
// nodes of the JAX package's count and vec programs (_eval_spec,
// pilosa_tpu/exec/tpu.py:1243-1277, with the range helpers at :1113-1202),
// which XLA fuses into one pass. Each output word depends only on the same
// word of exists, sign and the planes, so a thread owns one uint4 column of
// one shard and walks the planes from depth - 1 down to 0 with its walk's
// filter and keep in registers, reading every word once; two walks (a's
// and b's filter and keep) carry the mixed between's two less-than walks,
// or a between's two keeps, in the same pass. The host has resolved the
// predicate's bits (the JAX helpers' selects, their early returns and the
// strict-<0 fix) into one action byte a plane (ops/kernels.py
// compare_plan), passed in the launch's parameters, so every branch in the
// loop is uniform across the grid. Each thread keeps the next kCmpAhead
// planes' loads in flight. Bound by bytes: (2 + depth) rows read, one
// written.
struct CompareTable {
  uint8_t op[64];  // plane i: walk a's action in bits 0-2, walk b's in 3-5
  int start_a, start_b, extra, neq;
};
constexpr int kCmpThreads = 256;
constexpr int kCmpAhead = 4;  // plane loads in flight a thread

__device__ __forceinline__ uint4 or4(const uint4& a, const uint4& b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// The slab a walk starts from (or the result is ORed with): 0 none, 1
// exists & ~sign, 2 exists & sign, 3 exists.
__device__ __forceinline__ uint4 start_slab(int code, const uint4& e, const uint4& sg) {
  switch (code) {
    case 1: return andnot4(e, sg);
    case 2: return and4(e, sg);
    case 3: return e;
    default: return make_uint4(0u, 0u, 0u, 0u);
  }
}

// One plane's action on a walk's filter f and keep k (ops/kernels.py OP_*).
__device__ __forceinline__ void step(int op, uint4& f, uint4& k, const uint4& p) {
  switch (op) {
    case 1: f = andnot4(f, p); break;                // f &= ~p
    case 2: f = and4(f, p); break;                   // f &= p
    case 3: k = or4(k, and4(f, p)); break;           // k |= f & p
    case 4: k = or4(k, andnot4(f, p)); break;        // k |= f & ~p
    case 5: f = and4(f, or4(p, k)); break;           // f &= p | k
    case 6: f = andnot4(f, andnot4(p, k)); break;    // f &= ~p | k
    case 7: f = k; break;                            // f = k
    default: break;
  }
}

// MODE 0: one walk; 1: a between, walk b's action on walk a's filter with
// its own keep; 2: two walks, ORed.
template <int MODE>
__global__ void __launch_bounds__(kCmpThreads)
bsi_compare_kernel(const uint4* __restrict__ stack, uint4* __restrict__ out,
                   const CompareTable t, int r, int depth, int w4, int blocks_a_shard) {
  // The action table in shared memory: indexing the parameter with the
  // plane would copy it to local memory.
  __shared__ uint32_t ops_s[16];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 16; ++k) ops_s[k] = reinterpret_cast<const uint32_t*>(t.op)[k];
  }
  __syncthreads();
  const uint8_t* ops = reinterpret_cast<const uint8_t*>(ops_s);
  const int s = blockIdx.x / blocks_a_shard;
  const int i = (blockIdx.x - s * blocks_a_shard) * kCmpThreads + threadIdx.x;
  if (i >= w4) return;
  const uint4* col = stack + (size_t)s * r * w4 + i;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // A ring of kCmpAhead planes in registers: plane p is loaded kCmpAhead
  // planes before it is used, into buf[(depth - 1 - p) % kCmpAhead].
  uint4 buf[kCmpAhead];
#pragma unroll
  for (int k = 0; k < kCmpAhead; ++k) {
    buf[k] = k < depth ? __ldg(col + (size_t)(1 + depth - k) * w4) : zero;
  }
  const uint4 e = __ldg(col), sg = __ldg(col + w4);
  uint4 fa = start_slab(t.start_a, e, sg), ka = zero;
  uint4 fb = start_slab(t.start_b, e, sg), kb = zero;
  const uint4 x = start_slab(t.extra, e, sg);
  for (int top = depth - 1; top >= 0; top -= kCmpAhead) {
#pragma unroll
    for (int k = 0; k < kCmpAhead; ++k) {
      const int p = top - k;
      if (p >= 0) {
        const uint4 pl = buf[k];
        if (p >= kCmpAhead) buf[k] = __ldg(col + (size_t)(2 + p - kCmpAhead) * w4);
        const int op = ops[p];
        step(op & 7, fa, ka, pl);
        if (MODE == 1) step(op >> 3, fa, kb, pl);
        if (MODE == 2) step(op >> 3, fb, kb, pl);
      }
    }
  }
  out[(size_t)s * w4 + i] = t.neq ? andnot4(x, fa) : or4(or4(fa, fb), x);
}

}  // namespace

// Plain C entry points, bound with ctypes. The pointers are 16-byte aligned,
// w is a multiple of 4, and the caller has checked every shape.

// x int32[n, w] -> out int32[n], the popcount of each row.
extern "C" int popcount_rows_launch(const void* x, void* out, int n, int w,
                                    void* stream) {
  popcount_rows_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<int32_t*>(out), w / 4);
  return static_cast<int>(cudaGetLastError());
}

// stack int32[s, r, w], masks int32[s, w] (null past the m-th) ->
// out int32[max(m, 1), s, n_rows]: out[k, s, i] = popcount(stack[s, row0 + i]
// & mask_k[s]), or of the row alone when m = 0.
extern "C" int row_popcounts_launch(const void* stack, const void* mask0,
                                    const void* mask1, void* out, int m, int s,
                                    int r, int row0, int n_rows, int w,
                                    void* stream) {
  const int total = s * n_rows;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint4*>(stack);
  const auto* a = static_cast<const uint4*>(mask0);
  const auto* b = static_cast<const uint4*>(mask1);
  auto* o = static_cast<int32_t*>(out);
  if (m == 0) {
    row_popcounts_kernel<0><<<total, kThreads, 0, st>>>(x, a, b, o, r, row0, n_rows, w / 4, total);
  } else if (m == 1) {
    row_popcounts_kernel<1><<<total, kThreads, 0, st>>>(x, a, b, o, r, row0, n_rows, w / 4, total);
  } else {
    row_popcounts_kernel<2><<<total, kThreads, 0, st>>>(x, a, b, o, r, row0, n_rows, w / 4, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// stack int32[s, r, w] (exists, sign, planes), filt int32[s, w] or null ->
// out int32[2, s, depth + 2]: per branch and shard, the decision bit of each
// plane i at [i], the final count at [depth] and the start's "any" at
// [depth + 1]. kind 0 is Min, 1 is Max. Needs w <= 32768.
extern "C" int bsi_minmax_launch(const void* stack, const void* filt, void* out,
                                 int kind, int s, int r, int depth, int w,
                                 void* stream) {
  const int w4 = w / 4;
  const int v = (w4 + kMmCluster - 1) / kMmCluster;
  if (v > kMmThreads * kMmVec) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)kMmStages * v * sizeof(uint4);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint4*>(stack);
  const auto* f = static_cast<const uint4*>(filt);
  auto* o = static_cast<int32_t*>(out);
  const int grid = s * kMmCluster;
  cudaError_t err;
  if (kind == 0) {
    err = cudaFuncSetAttribute(bsi_minmax_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bsi_minmax_kernel<true><<<grid, kMmThreads, smem, st>>>(x, f, o, s, r, depth, w4);
  } else {
    err = cudaFuncSetAttribute(bsi_minmax_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bsi_minmax_kernel<false><<<grid, kMmThreads, smem, st>>>(x, f, o, s, r, depth, w4);
  }
  return static_cast<int>(cudaGetLastError());
}

// stack int32[s, r, w] (exists, sign, planes) -> out int32[s, w], the slab
// of one condition: ops (host memory, 64 bytes) holds plane i's actions at
// [i], mode the walks' shape (0 one, 1 between, 2 two), start_a, start_b
// and extra the slab codes, neq whether the result is exists & ~walk a.
extern "C" int bsi_compare_launch(const void* stack, void* out, const void* ops, int mode,
                                  int start_a, int start_b, int extra, int neq, int s,
                                  int r, int depth, int w, void* stream) {
  if (depth < 0 || depth > 63) return static_cast<int>(cudaErrorInvalidValue);
  CompareTable t;
  memcpy(t.op, ops, sizeof(t.op));
  t.start_a = start_a;
  t.start_b = start_b;
  t.extra = extra;
  t.neq = neq;
  const int w4 = w / 4;
  const int per = (w4 + kCmpThreads - 1) / kCmpThreads;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint4*>(stack);
  auto* o = static_cast<uint4*>(out);
  if (mode == 0) {
    bsi_compare_kernel<0><<<s * per, kCmpThreads, 0, st>>>(x, o, t, r, depth, w4, per);
  } else if (mode == 1) {
    bsi_compare_kernel<1><<<s * per, kCmpThreads, 0, st>>>(x, o, t, r, depth, w4, per);
  } else {
    bsi_compare_kernel<2><<<s * per, kCmpThreads, 0, st>>>(x, o, t, r, depth, w4, per);
  }
  return static_cast<int>(cudaGetLastError());
}
