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
// The design is the simple one: a thread owns one 16-byte column of a
// slab (4 words) and walks the entries in order, storing each valid entry's
// column over its target shard's. One thread writes a column of every
// target, in program order, so duplicate indices resolve deterministically.
// The entries (at most kMaxEntries) travel in the launch's parameters from
// host memory, and block's thread 0 resolves them into shared memory first:
// the clipped target of each valid entry, or -1 for an invalid one and for
// one that a later valid entry with the same target overwrites (its stores
// would be dead). So each distinct target's column is read once and
// written once.
//
// Bound: bytes. One round of the backend's splice (exec/cuda.py
// _StackedBlocks._splice: one slab a part, rows_p = 8) reads 1 MiB and writes
// 1 MiB, 0.63 us at 3.35 TB/s, below the launch floor.
//
// The entry point returns cudaGetLastError() right after its launch, so a
// launch the card refuses is reported to the caller.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kSpliceThreads = 256;
constexpr int kMaxEntries = 32;  // ops/kernels.py MAX_SPLICE_ENTRIES

struct SpliceEntries {
  int idx[kMaxEntries];
  uint32_t valid[kMaxEntries];
};

__global__ void __launch_bounds__(kSpliceThreads)
splice_slabs_kernel(uint4* __restrict__ block, const uint4* __restrict__ slabs,
                    const SpliceEntries e, int c, int s_local, long long slab_vec) {
  // Each entry's target in shared memory, resolved with static indices: a
  // dynamic index into the parameter would copy it to local memory.
  __shared__ int tgt[kMaxEntries];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kMaxEntries; ++k) {
      int li = e.idx[k];
      li = li < 0 ? 0 : (li > s_local - 1 ? s_local - 1 : li);
      tgt[k] = (k < c && e.valid[k] != 0u) ? li : -1;
    }
    for (int k = 0; k < c; ++k) {
      for (int l = k + 1; l < c; ++l) {
        if (tgt[l] >= 0 && tgt[l] == tgt[k]) {
          tgt[k] = -1;  // a later entry wins: this one's stores are dead
          break;
        }
      }
    }
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * kSpliceThreads;
  for (long long v = (long long)blockIdx.x * kSpliceThreads + threadIdx.x; v < slab_vec;
       v += stride) {
    for (int j = 0; j < c; ++j) {
      const int li = tgt[j];
      if (li >= 0) block[(long long)li * slab_vec + v] = __ldg(slabs + (long long)j * slab_vec + v);
    }
  }
}

}  // namespace

// block int32[s_local, rows, w] (written in place), slabs int32[c, rows, w];
// idx (host memory, int32[c]) and valid (host memory, uint32[c]) the
// entries, c <= kMaxEntries; w a multiple of 4 and both tensors 16-byte
// aligned.
extern "C" int splice_slabs_launch(void* block, const void* slabs, const void* idx,
                                   const void* valid, int c, int s_local, int rows, int w,
                                   void* stream) {
  if (c < 0 || c > kMaxEntries || s_local <= 0 || rows <= 0 || w <= 0 || w % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c == 0) return static_cast<int>(cudaSuccess);
  SpliceEntries e;
  memset(&e, 0, sizeof(e));
  memcpy(e.idx, idx, sizeof(int) * c);
  memcpy(e.valid, valid, sizeof(uint32_t) * c);
  const long long slab_vec = (long long)rows * (w / 4);
  long long blocks = (slab_vec + kSpliceThreads - 1) / kSpliceThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // the loop strides past it
  splice_slabs_kernel<<<(unsigned)blocks, kSpliceThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(block), static_cast<const uint4*>(slabs), e, c, s_local, slab_vec);
  return static_cast<int>(cudaGetLastError());
}
