// K15, the dirty-shard splice of a sharded stack, for Hopper (sm_90a).
//
// It replaces splice_shard_slabs (pilosa_tpu/ops/kernels.py:497), the XLA
// program that the JAX package runs under shard_map to write a write
// epoch's dirty shard slabs into each device's part of a sharded stack
// (pilosa_tpu/exec/tpu.py _splice_sharded). Its contract is that
// program's: block int32[S_local, R, W] (one device's part), slabs
// int32[C, R, W], and per entry j a local shard index idx[j], clipped to
// [0, S_local - 1], and a flag valid[j]. Each valid slab is written over its
// shard in entry order, so a later entry wins over an earlier one with the
// same index; an invalid entry leaves the part as it is. The part is
// written in place (the JAX program returns a new array; the port's stacks
// are updated in place, exec/cuda.py _StackedBlocks._try_incremental).
//
// Bound: bytes. Each live slab is read once and written once: 2 x n x slab
// bytes over 3.35 TB/s. A round of the backend's splice (exec/cuda.py
// _StackedBlocks._splice) carries up to kMaxEntries slabs a part; at rows_p
// = 8 a slab is 1 MiB, so one slab is 0.63 us (below the launch floor) and
// 32 slabs 20 us.
//
// The design:
// - Entries. The wrapper (ops/kernels.py splice_pairs) resolves the entries
//   on the host in O(C): it clips each index, drops invalid entries and
//   keeps only the last entry for each target. The kernel gets the live
//   (source slab, target shard) pairs in its parameters, every target
//   distinct, so no block resolves anything, no two blocks write one word,
//   and no barrier is needed. The parameter is __grid_constant__, so a
//   block reads its pair in place, with no copy to local memory.
// - Grid. blockIdx.y is the live pair and blockIdx.x a tile of its slab.
//   A block is one warp; each thread issues the 16-byte loads of kUnroll
//   vectors before it stores them, so a warp keeps 2 KiB in flight. A
//   1 MiB slab has 512 tiles: at one live slab the grid is 512 blocks, about
//   four to an SM, and the whole slab is in flight at once. With more
//   slabs, each pair gets a share of kBlocksPerSm blocks an SM and its
//   blocks stride over its tiles, so the launch keeps about 32 KiB in
//   flight on every SM, enough to cover device-memory latency at the full
//   rate.
// - The other design weighed, a TMA bulk copy (cp.async.bulk) through
//   shared memory, was not taken. Hopper has no bulk copy from global to
//   global memory, so every byte would pass through shared memory with an
//   mbarrier wait between its load and its store; a splice reuses nothing,
//   so shared memory buys no reuse, and the register path needs neither
//   shared memory nor barriers, which keeps a block small enough to spread
//   one slab over every SM.
//
// The entry point returns cudaGetLastError() right after its launch, so a
// launch the card refuses is reported to the caller.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 32;      // one warp a block
constexpr int kUnroll = 4;        // 16-byte vectors a thread loads before storing
constexpr long long kTile = kThreads * kUnroll;  // vectors a block moves a step
constexpr int kBlocksPerSm = 16;  // the grid a launch aims at, over its pairs
constexpr int kMaxEntries = 32;   // ops/kernels.py MAX_SPLICE_ENTRIES

struct SplicePairs {
  int src[kMaxEntries];  // the source slab of each live pair
  int tgt[kMaxEntries];  // its target shard in the part, all distinct
};

__global__ void __launch_bounds__(kThreads)
splice_slabs_kernel(uint4* __restrict__ block, const uint4* __restrict__ slabs,
                    const __grid_constant__ SplicePairs p, long long slab_vec) {
  const uint4* __restrict__ src = slabs + (long long)p.src[blockIdx.y] * slab_vec;
  uint4* __restrict__ dst = block + (long long)p.tgt[blockIdx.y] * slab_vec;
  for (long long base = (long long)blockIdx.x * kTile + threadIdx.x; base < slab_vec;
       base += (long long)gridDim.x * kTile) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = base + (long long)u * kThreads;
      if (v < slab_vec) r[u] = __ldcs(src + v);  // read once: evict first
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = base + (long long)u * kThreads;
      if (v < slab_vec) dst[v] = r[u];
    }
  }
}

// The launch floor at K15's grid: the same blocks and threads, no work.
__global__ void __launch_bounds__(kThreads) splice_floor_kernel() {}

int sm_count() {
  static int sms = 0;  // the same on every card a process drives
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0) {
      sms = 132;  // an H100 SXM's
    }
  }
  return sms;
}

// K15's grid for n live slabs of rows x w words: (blocks a pair, n).
dim3 splice_grid(int n, int rows, int w) {
  const long long slab_vec = (long long)rows * (w / 4);
  const long long tiles = (slab_vec + kTile - 1) / kTile;
  const long long aim = ((long long)sm_count() * kBlocksPerSm + n - 1) / n;
  long long bx = tiles < aim ? tiles : aim;
  if (bx < 1) bx = 1;
  return dim3((unsigned)bx, (unsigned)n, 1);
}

}  // namespace

// block int32[s_local, rows, w] (written in place), slabs int32[c, rows, w],
// not overlapping block; pairs (host memory, int32[2 n]) the n live pairs'
// source slabs, then their target shards, n <= kMaxEntries, every source in
// [0, c), every target in [0, s_local) and distinct; w a multiple of 4 and
// both tensors 16-byte aligned.
extern "C" int splice_slabs_launch(void* block, const void* slabs, const void* pairs, int n,
                                   int c, int s_local, int rows, int w, void* stream) {
  if (n < 0 || n > kMaxEntries || n > c || s_local <= 0 || rows <= 0 || w <= 0 || w % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  SplicePairs p;
  memset(&p, 0, sizeof(p));
  memcpy(p.src, pairs, sizeof(int) * n);
  memcpy(p.tgt, static_cast<const int*>(pairs) + n, sizeof(int) * n);
  for (int k = 0; k < n; ++k) {
    if (p.src[k] < 0 || p.src[k] >= c || p.tgt[k] < 0 || p.tgt[k] >= s_local) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int l = 0; l < k; ++l) {
      if (p.tgt[l] == p.tgt[k]) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  splice_slabs_kernel<<<splice_grid(n, rows, w), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(block), static_cast<const uint4*>(slabs), p,
      (long long)rows * (w / 4));
  return static_cast<int>(cudaGetLastError());
}

// The no-op kernel at the grid and block that splice_slabs_launch gives n
// live slabs of rows x w words (ops/probe.py splice_floor).
extern "C" int splice_floor_launch(int n, int rows, int w, void* stream) {
  if (n <= 0 || n > kMaxEntries || rows <= 0 || w <= 0 || w % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  splice_floor_kernel<<<splice_grid(n, rows, w), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
