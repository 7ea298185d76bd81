// The popcount-reduce of the count path for Hopper (sm_90a): K3.
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
// The entry point returns cudaGetLastError() right after its launch, so a
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

}  // namespace

// Plain C entry point, bound with ctypes. The pointers are 16-byte aligned,
// w is a multiple of 4, and the caller has checked every shape.

// x int32[n, w] -> out int32[n], the popcount of each row.
extern "C" int popcount_rows_launch(const void* x, void* out, int n, int w,
                                    void* stream) {
  popcount_rows_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<int32_t*>(out), w / 4);
  return static_cast<int>(cudaGetLastError());
}
