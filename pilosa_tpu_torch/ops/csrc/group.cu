// Group-tensor kernels for Hopper (sm_90a): the odometer sweeps of the
// N-field GroupBy.
//
// Stacks are int32[S, R, W] with W = 32768 words per shard row, as in
// bitcount.cu. For a GroupBy over fields F, G, H1..HE the group tensor is
//
//   out[k, (s,) a, b] = popcount(F[s, a, :] & G[s, b, :] & m_k[s, :])
//   m_k[s, :]         = H1[s, r1(k), :] & ... & HE[s, rE(k), :] [& filt[s, :]]
//
// where k runs as an odometer over the extras' rows (last extra fastest),
// decoded in the kernel. Two kernels, instantiations of one template (the
// slot-table tiles K4 group_tile_stats and K5 group_tile_stats_pershard run
// on the tensor cores in bmma.cu):
//
//   K6 nary_stats            summed over shards, optional filter;
//   K7 nary_stats_pershard   per shard, unfiltered.
//
// They replace the TPU's Pallas kernels nary_stats (K6,
// pilosa_tpu/ops/kernels.py:253) and nary_stats_pershard (K7, :349). On the
// TPU the k axis and the shard axis are sequential grid axes with the sum
// carried in VMEM; here each block owns one (k, shard, 8 x 8 pair tile) and
// loops over the words.
//
// What bounds them: every k does Rf * Rg popcounts a word, so at the main
// path's 8 x 8 pair face the popcount issue rate (16 a clock per SM, 4.2e12
// a second on an H100 SXM) bounds a sweep, not its bytes: a k reads its F
// and G words (16 a word) plus E extra words for 64 popcounts. (On the
// tensor cores' b1 MMA, bmma.cu, the same work is bound by its bytes: that
// is where K4 and K5 went, and where these two are to follow.) The design
// keeps that to one pass over device memory:
//
//   - the k axis is the fastest grid axis, so the K blocks of one (shard,
//     tile) run side by side and share that shard's F and G words through
//     L2 (2 MB a shard at 8 rows, well inside the 50 MB L2) instead of
//     re-reading 2 GB of stacks from device memory per k;
//   - m is formed once a word (E loads and ANDs) and folded into the 8 F
//     words, so the 64 pair sums cost one AND and one popcount each;
//   - the 64 sums live in registers for the whole word loop and are
//     reduced once per block with warp shuffles; the summed kernel adds
//     one cell a block with atomicAdd into a zeroed output (exact while
//     S * 2^20 < 2^31, the caller's MAX_PAIR_SHARDS bound), the per-shard
//     kernel writes its cells.
//
// The extras have different heights. Their base pointers and heights
// travel by value in the launch's parameters (a table of kMaxExtras
// entries, in the constant bank); a block puts its k's E row pointers in
// shared memory.
//
// Each entry point returns cudaGetLastError() right after its launch, or
// cudaErrorInvalidValue for arguments the grid cannot take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;
constexpr int kMaxExtras = 8;  // MAX_GROUP_EXTRAS in ops/kernels.py
constexpr int kMaxGridYZ = 65535;

struct ExtraTable {
  const uint4* base[kMaxExtras];
  int rows[kMaxExtras];
  int n;
};

__device__ __forceinline__ uint4 and4(const uint4& a, const uint4& b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
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

// Block (k, s, t): odometer slot k, shard s, pair tile t. PERSHARD writes
// out[((k * S + s) * rf + a) * rg + b]; otherwise out[(k * rf + a) * rg + b]
// gathers every shard's part by atomicAdd.
template <bool PERSHARD, bool FILTERED>
__global__ void __launch_bounds__(kThreads)
group_kernel(const uint4* __restrict__ f, const uint4* __restrict__ g,
             const ExtraTable ex, const uint4* __restrict__ filt,
             int32_t* __restrict__ out, int n_shards, int rf, int rg, int w4,
             int tiles_b) {
  const int q = blockIdx.x;
  const int s = blockIdx.y;
  const int ta = blockIdx.z / tiles_b;
  const int tb = blockIdx.z - ta * tiles_b;
  const int a0 = ta * kTile;
  const int b0 = tb * kTile;
  const int na = min(kTile, rf - a0);
  const int nb = min(kTile, rg - b0);
  const uint4* fs = f + ((size_t)s * rf + a0) * w4;
  const uint4* gs = g + ((size_t)s * rg + b0) * w4;
  const uint4* ms = FILTERED ? filt + (size_t)s * w4 : nullptr;
  const int n_extra = ex.n;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  __shared__ const uint4* hp[kMaxExtras];
  if (threadIdx.x == 0) {
    int rem = q;
    for (int e = n_extra - 1; e >= 0; --e) {
      const int height = ex.rows[e];
      const int row = rem % height;
      rem /= height;
      hp[e] = ex.base[e] + ((size_t)s * height + row) * w4;
    }
  }
  __syncthreads();

  uint32_t acc[kTile][kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc[a][b] = 0u;
  }

  for (int i = threadIdx.x; i < w4; i += kThreads) {
    uint4 m = __ldg(hp[0] + i);
    for (int e = 1; e < n_extra; ++e) m = and4(m, __ldg(hp[e] + i));
    if (FILTERED) m = and4(m, __ldg(ms + i));
    uint4 fv[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      fv[a] = a < na ? and4(__ldg(fs + (size_t)a * w4 + i), m) : zero;
    }
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const uint4 gv = b < nb ? __ldg(gs + (size_t)b * w4 + i) : zero;
#pragma unroll
      for (int a = 0; a < kTile; ++a) acc[a][b] += popc4_and(fv[a], gv);
    }
  }

  __shared__ uint32_t red[kWarps][kTile * kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const uint32_t v = warp_sum(acc[a][b]);
      if (lane == 0) red[warp][a * kTile + b] = v;
    }
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k >= kTile * kTile) return;
  const int a = k / kTile;
  const int b = k - a * kTile;
  if (a >= na || b >= nb) return;
  uint32_t v = 0u;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) v += red[wi][k];
  const size_t cell = (size_t)(a0 + a) * rg + (b0 + b);
  const size_t face = (size_t)rf * rg;
  if (PERSHARD) {
    out[((size_t)q * n_shards + s) * face + cell] = (int32_t)v;
  } else {
    atomicAdd(out + (size_t)q * face + cell, (int32_t)v);
  }
}

template <bool PERSHARD, bool FILTERED>
int launch(const dim3& grid, cudaStream_t st, const void* f, const void* g,
           const ExtraTable& ex, const void* filt, void* out, int s, int rf, int rg,
           int w4, int tiles_b) {
  group_kernel<PERSHARD, FILTERED><<<grid, kThreads, 0, st>>>(
      static_cast<const uint4*>(f), static_cast<const uint4*>(g), ex,
      static_cast<const uint4*>(filt), static_cast<int32_t*>(out), s, rf, rg, w4,
      tiles_b);
  return static_cast<int>(cudaGetLastError());
}

int group_launch(bool pershard, const void* f, const void* g, const void* const* ptrs,
                 const int* heights, int n_extra, const void* filt, void* out, int s,
                 int rf, int rg, int w, int n_slots, void* stream) {
  const int tiles_a = (rf + kTile - 1) / kTile;
  const int tiles_b = (rg + kTile - 1) / kTile;
  const bool filtered = filt != nullptr;
  if (n_extra < 1 || n_extra > kMaxExtras || n_slots < 1 || s < 1 ||
      s > kMaxGridYZ || tiles_a * tiles_b > kMaxGridYZ || (pershard && filtered)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ExtraTable ex;
  for (int e = 0; e < kMaxExtras; ++e) {
    ex.base[e] = e < n_extra ? static_cast<const uint4*>(ptrs[e]) : nullptr;
    ex.rows[e] = e < n_extra ? heights[e] : 0;
  }
  ex.n = n_extra;
  const dim3 grid(n_slots, s, tiles_a * tiles_b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int w4 = w / 4;
  if (pershard) return launch<true, false>(grid, st, f, g, ex, filt, out, s, rf, rg, w4, tiles_b);
  if (filtered) return launch<false, true>(grid, st, f, g, ex, filt, out, s, rf, rg, w4, tiles_b);
  return launch<false, false>(grid, st, f, g, ex, filt, out, s, rf, rg, w4, tiles_b);
}

}  // namespace

// Plain C entry points, bound with ctypes, with the signature of bmma.cu's
// group-tile entry points (rows_idx and active are not read: the odometer
// names each k's rows). f int32[s, rf, w], g int32[s, rg, w]; ptrs /
// heights: host arrays of n_extra (<= 8) extra stacks int32[s, heights[e],
// w]; out zeroed by the caller on the same stream; n_slots = K, the
// product of the heights. Pointers are 16-byte aligned, w is a multiple of
// 4, and the caller has checked every shape.

// filt int32[s, w] or null -> out int32[K, rf, rg].
extern "C" int nary_stats_launch(
    const void* f, const void* g, const void* const* ptrs, const int* heights,
    int n_extra, const void* rows_idx, const void* active, const void* filt,
    void* out, int s, int rf, int rg, int w, int n_slots, void* stream) {
  return group_launch(false, f, g, ptrs, heights, n_extra, filt, out, s, rf, rg, w,
                      n_slots, stream);
}

// filt null -> out int32[K, s, rf, rg].
extern "C" int nary_stats_pershard_launch(
    const void* f, const void* g, const void* const* ptrs, const int* heights,
    int n_extra, const void* rows_idx, const void* active, const void* filt,
    void* out, int s, int rf, int rg, int w, int n_slots, void* stream) {
  return group_launch(true, f, g, ptrs, heights, n_extra, filt, out, s, rf, rg, w,
                      n_slots, stream);
}
