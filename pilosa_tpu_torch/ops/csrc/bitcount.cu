// The CUDA-core popcount kernels for Hopper (sm_90a): K3, the
// popcount-reduce of the count path; K8, the per-row popcounts of TopN and
// of Sum's planes; K9, the per-shard plane walk of Min and Max.
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
// K8 and K9 are byte streams of the same kind: a row against one mask is a
// matrix-vector product (N = 1), which would leave 7/8 of the b1 MMA's
// output unused, so they stay on the CUDA cores beside K3.
//
// Each entry point returns cudaGetLastError() right after its launch, so a
// launch the card refuses is reported to the caller instead of being lost.

#include <cuda_runtime.h>
#include <stdint.h>

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

// K9. The Min/Max plane walk of one shard and one branch: the counterpart
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
// Each step's decision needs the whole shard's slab, so one block of 1024
// threads owns one (shard, branch) and walks the planes in order, one
// __syncthreads_or a step. The running filter (W words, 128 KiB for a
// shard) sits in dynamic shared memory; each thread reads and writes only
// its own words of it, so the barrier of the OR is the only one a step
// needs. A step's candidate row stays in registers (8 uint4 a thread, so W
// <= 32768) until the decision. Bound by bytes: each plane read once; the
// two branches read the planes once each, from device memory or L2.
constexpr int kWalkThreads = 1024;
constexpr int kWalkVec = 8;  // uint4 a thread: w4 <= kWalkThreads * kWalkVec

template <bool kMin>
__global__ void __launch_bounds__(kWalkThreads, 1)
bsi_minmax_kernel(const uint4* __restrict__ stack, const uint4* __restrict__ filt,
                  int32_t* __restrict__ out, int s_count, int r, int depth, int w4) {
  extern __shared__ uint4 run[];
  __shared__ uint32_t red[kWalkThreads / 32];
  const int s = blockIdx.x;
  const int branch = blockIdx.y;
  const uint4* base = stack + (size_t)s * r * w4;
  const uint4* fl = filt == nullptr ? nullptr : filt + (size_t)s * w4;
  int any = 0;
#pragma unroll
  for (int k = 0; k < kWalkVec; ++k) {
    const int i = threadIdx.x + k * kWalkThreads;
    if (i < w4) {
      uint4 c = __ldg(base + i);
      if (fl != nullptr) c = and4(c, __ldg(fl + i));
      if (branch == 0) {
        const uint4 sg = __ldg(base + w4 + i);
        c = kMin ? and4(sg, c) : andnot4(c, sg);
      }
      run[i] = c;
      any |= any4(c);
    }
  }
  any = __syncthreads_or(any);
  int32_t* o = out + ((size_t)branch * s_count + s) * (depth + 2);
  for (int p = depth - 1; p >= 0; --p) {
    const uint4* plane = base + (size_t)(2 + p) * w4;
    uint4 row[kWalkVec];
    int nz = 0;
#pragma unroll
    for (int k = 0; k < kWalkVec; ++k) {
      const int i = threadIdx.x + k * kWalkThreads;
      if (i < w4) {
        const uint4 pl = __ldg(plane + i);
        row[k] = branch == 0 ? and4(pl, run[i]) : andnot4(run[i], pl);
        nz |= any4(row[k]);
      }
    }
    nz = __syncthreads_or(nz);
    if (nz) {
#pragma unroll
      for (int k = 0; k < kWalkVec; ++k) {
        const int i = threadIdx.x + k * kWalkThreads;
        if (i < w4) run[i] = row[k];
      }
    }
    if (threadIdx.x == 0) o[p] = branch == 0 ? nz : !nz;
  }
  uint32_t c = 0u;
#pragma unroll
  for (int k = 0; k < kWalkVec; ++k) {
    const int i = threadIdx.x + k * kWalkThreads;
    if (i < w4) c += popc4(run[i]);
  }
  c = block_sum(c, red);
  if (threadIdx.x == 0) {
    o[depth] = (int32_t)c;
    o[depth + 1] = any;
  }
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
  const size_t smem = (size_t)w4 * sizeof(uint4);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint4*>(stack);
  const auto* f = static_cast<const uint4*>(filt);
  auto* o = static_cast<int32_t*>(out);
  const dim3 grid(s, 2);
  cudaError_t err;
  if (kind == 0) {
    err = cudaFuncSetAttribute(bsi_minmax_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bsi_minmax_kernel<true><<<grid, kWalkThreads, smem, st>>>(x, f, o, s, r, depth, w4);
  } else {
    err = cudaFuncSetAttribute(bsi_minmax_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bsi_minmax_kernel<false><<<grid, kWalkThreads, smem, st>>>(x, f, o, s, r, depth, w4);
  }
  return static_cast<int>(cudaGetLastError());
}
