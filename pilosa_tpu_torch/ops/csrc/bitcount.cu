// Popcount kernels for Hopper (sm_90a): the bitmap index's count path.
//
// Stacks are int32[S, R, W] with W = 32768 words per shard row (one shard of
// 2^20 columns); the bits are the same as the uint32 layout the host packs.
// The kernels here run on the CUDA cores: each word is read once, ANDed and
// popcounted. Two rates bound them on an H100 SXM: the memory rate (3.35
// TB/s), and the popcount issue rate, 16 a clock per SM (CUDA C++
// Programming Guide, arithmetic instruction throughput, compute capability
// 9.0): 132 SMs x 1.98 GHz x 16 = 4.2e12 a second. The popcount-reduce does
// one popcount per 4 bytes and is bound by bytes. An 8 x 8 per-shard pair
// sweep does 64 + 16 = 80 popcounts per 64 bytes read, which takes the same
// time at either rate. (The shard-summed pair kernel K2 runs on the tensor
// cores' binary MMA, in bmma.cu.) Design against that:
//
//   - threads read 16-byte vectors (uint4), neighbouring threads on
//     neighbouring addresses, so every warp load is a full 512-byte burst;
//   - partial sums live in registers for the whole stream and are reduced
//     once per block, with warp shuffles and a small shared-memory table;
//   - each block owns its outputs, so no atomics are needed.
//
// Each entry point returns cudaGetLastError() right after its launch, so a
// launch the card refuses is reported to the caller instead of being lost.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Rows per side of one pair tile: an 8 x 8 tile is the main path's whole
// pair matrix (ROW_PAD = 8), and its 64 accumulators plus one side's 8
// vectors fit in registers without spilling.
constexpr int kTile = 8;
constexpr int kStats = kTile * kTile + 2 * kTile;

__device__ __forceinline__ uint32_t popc4(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint32_t popc4_and(const uint4& a, const uint4& b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// K1. Replaces the Pallas kernel pair_stats_pershard
// (pilosa_tpu/ops/kernels.py:142). The TPU kernel carries the sum in VMEM
// across a sequential (shard, word-tile) grid; blocks on Hopper run in no
// order, so the grid here is (shard, pair tile) and the word axis is a loop
// inside the block. At the main path's 8 x 8 rows one tile is the whole
// pair matrix and each word is read once; with more rows each tile re-reads
// its 2 x kTile rows, and the popcount issue rate, not the bytes, bounds
// the sweep.
//
// Block (s, t) computes, for the kTile x kTile tile t of (a, b) pairs:
//   pair[s, a, b] = popcount(F[s, a, :] & G[s, b, :])
// and, in the blocks of the first tile row / column, cf[s, a] and cg[s, b].
// Output row layout (per shard, D = rf*rg + rf + rg int32 cells):
//   [pair (row-major rf x rg) | cf (rf) | cg (rg)], at out[s * D + cell].
__global__ void __launch_bounds__(kThreads)
pair_stats_kernel(const uint4* __restrict__ f, const uint4* __restrict__ g,
                  int32_t* __restrict__ out, int rf, int rg, int w4,
                  int tiles_b) {
  const int s = blockIdx.x;
  const int ta = blockIdx.y / tiles_b;
  const int tb = blockIdx.y - ta * tiles_b;
  const int a0 = ta * kTile;
  const int b0 = tb * kTile;
  const int na = min(kTile, rf - a0);
  const int nb = min(kTile, rg - b0);
  const uint4* fs = f + ((size_t)s * rf + a0) * w4;
  const uint4* gs = g + ((size_t)s * rg + b0) * w4;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  uint32_t acc[kTile][kTile];
  uint32_t cf[kTile];
  uint32_t cg[kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    cf[a] = 0u;
    cg[a] = 0u;
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc[a][b] = 0u;
  }

  for (int i = threadIdx.x; i < w4; i += kThreads) {
    uint4 fv[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      fv[a] = a < na ? __ldg(fs + (size_t)a * w4 + i) : zero;
      cf[a] += popc4(fv[a]);
    }
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const uint4 gv = b < nb ? __ldg(gs + (size_t)b * w4 + i) : zero;
      cg[b] += popc4(gv);
#pragma unroll
      for (int a = 0; a < kTile; ++a) acc[a][b] += popc4_and(fv[a], gv);
    }
  }

  __shared__ uint32_t red[kWarps][kStats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const uint32_t v = warp_sum(acc[a][b]);
      if (lane == 0) red[warp][a * kTile + b] = v;
    }
    const uint32_t vf = warp_sum(cf[a]);
    const uint32_t vg = warp_sum(cg[a]);
    if (lane == 0) {
      red[warp][kTile * kTile + a] = vf;
      red[warp][kTile * kTile + kTile + a] = vg;
    }
  }
  __syncthreads();

  const int d = rf * rg + rf + rg;
  for (int k = threadIdx.x; k < kStats; k += kThreads) {
    uint32_t v = 0u;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[wi][k];
    int cell = -1;
    if (k < kTile * kTile) {
      const int a = k / kTile;
      const int b = k - a * kTile;
      if (a < na && b < nb) cell = (a0 + a) * rg + (b0 + b);
    } else if (k < kTile * kTile + kTile) {
      const int a = k - kTile * kTile;
      if (tb == 0 && a < na) cell = rf * rg + a0 + a;
    } else {
      const int b = k - kTile * kTile - kTile;
      if (ta == 0 && b < nb) cell = rf * rg + rf + b0 + b;
    }
    if (cell >= 0) out[(size_t)s * d + cell] = (int32_t)v;
  }
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

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are 16-byte aligned,
// w is a multiple of 4, and the caller has checked every shape.

// f int32[s, rf, w], g int32[s, rg, w] -> out int32[s, rf*rg + rf + rg].
extern "C" int pair_stats_pershard_launch(const void* f, const void* g,
                                          void* out, int s, int rf, int rg,
                                          int w, void* stream) {
  const int tiles_a = (rf + kTile - 1) / kTile;
  const int tiles_b = (rg + kTile - 1) / kTile;
  const dim3 grid(s, tiles_a * tiles_b);
  pair_stats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(f), static_cast<const uint4*>(g),
      static_cast<int32_t*>(out), rf, rg, w / 4, tiles_b);
  return static_cast<int>(cudaGetLastError());
}

// x int32[n, w] -> out int32[n], the popcount of each row.
extern "C" int popcount_rows_launch(const void* x, void* out, int n, int w,
                                    void* stream) {
  popcount_rows_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<int32_t*>(out), w / 4);
  return static_cast<int>(cudaGetLastError());
}
