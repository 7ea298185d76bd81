// The expansion kernels of the chunked cold build for Hopper (sm_90a): K12,
// K13 and K14 write one chunk of a stack's words from its container wire
// (pilosa_tpu_torch/ops/sparse.py ChunkedStackBuilder).
//
// They replace three fused XLA programs of the JAX package, not Pallas
// kernels: expand_array_positions (pilosa_tpu/ops/kernels.py:410),
// expand_run_spans (:446) and the mask decompress (_chunk_prog,
// pilosa_tpu/ops/sparse.py:213). Each computes what its program computes,
// not how: the JAX programs scatter-add into a zeroed chunk accumulator and
// place it into the stack; these kernels write the stack's own words.
//
//   K12 expand_positions: one block a roaring array container. The block
//       zeroes its container's 2048 words in shared memory, ORs 1 << (p & 31)
//       into word p >> 5 for each of the container's u16 positions with a
//       shared-memory atomic, and stores the 8 KiB tile with 16-byte stores.
//   K13 expand_runs: one block a run container. Each warp takes a run
//       [start, last] (inclusive, u16): lane 0 ORs the edge masks into the
//       tile, the lanes store all-ones into the words strictly inside it,
//       then the block stores the tile.
//   K14 expand_words: one block 256 mask words (8192 chunk words). Each
//       thread takes the popcount of its mask word, the block scans them
//       into offsets from the block's base (the host computes the bases from
//       the mask it already holds), then each warp walks its 32 mask words
//       one at a time, lane b storing value number base + rank of bit b when
//       the bit is set: the stores of a mask word are one 128-byte segment.
//
// Why plain stores are enough: the stack starts as torch.zeros. Container
// slots partition a chunk (a container key occurs once in a fragment, and
// shards and rows do not overlap), so K12 and K13 own their slots whole,
// zero words included; a chunk's other words (bitmap containers and dense
// feeds) reach the stack only through K14 or the raw-words copy, which K14
// and the copy never share with a container slot. So no two writers touch
// one word, no word needs a read-modify-write in device memory, and a word
// that no writer touches keeps torch.zeros' zero.
//
// Bound: bytes. K12 reads 2 bytes a position and writes 8 KiB a container;
// at the bench density (about 3277 positions a container) that is 6.5 KiB
// read for 8 KiB written, 1.8 GB a 1 GB stack, 0.54 ms at 3.35 TB/s. The
// shared-memory tile keeps the scatter's atomics out of device memory, so
// device memory sees one coalesced read of the positions and one coalesced
// write of the words. K13 reads 4 bytes a run and writes 8 KiB a container;
// K14 reads the mask, the values and the bases and writes the nonzero words.
//
// Each entry point returns cudaGetLastError() right after its launch, so a
// launch the card refuses is reported to the caller instead of being lost.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Words of one roaring container: 2^16 bits.
constexpr int kSlotWords = 2048;
constexpr int kSlotVec = kSlotWords / 4;

__device__ __forceinline__ void zero_tile(uint4* tile) {
  for (int i = threadIdx.x; i < kSlotVec; i += kThreads) tile[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Stores a finished tile into its container slot of the chunk; a slot past
// the chunk's n words is not written (the host never ships one).
__device__ __forceinline__ void store_tile(const uint4* tile, uint32_t* out, int slot, int n) {
  const long long base = (long long)slot * kSlotWords;
  if (slot < 0 || base + kSlotWords > n) return;
  uint4* dst = reinterpret_cast<uint4*>(out + base);
  for (int i = threadIdx.x; i < kSlotVec; i += kThreads) dst[i] = tile[i];
}

// K12. Block c expands array container c: positions pos[starts[c] ..
// starts[c + 1]) into slot slots[c] of the chunk.
__global__ void __launch_bounds__(kThreads)
expand_positions_kernel(const uint16_t* __restrict__ pos, const int32_t* __restrict__ slots,
                        const int32_t* __restrict__ starts, uint32_t* __restrict__ out, int n) {
  __shared__ uint4 tile[kSlotVec];
  uint32_t* words = reinterpret_cast<uint32_t*>(tile);
  zero_tile(tile);
  __syncthreads();
  const int lo = starts[blockIdx.x], hi = starts[blockIdx.x + 1];
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const uint32_t p = pos[i];
    atomicOr(words + (p >> 5), 1u << (p & 31u));
  }
  __syncthreads();
  store_tile(tile, out, slots[blockIdx.x], n);
}

// K13. Block c expands run container c: runs [runs[2r], runs[2r + 1]] for r
// in [starts[c], starts[c + 1]), each inclusive, into slot slots[c].
// Edge words may hold the bits of two runs, so their masks are ORed in
// with atomics; a word strictly inside a run holds no other run's bits, so
// it takes a plain store (and all ones absorbs any OR that races it).
__global__ void __launch_bounds__(kThreads)
expand_runs_kernel(const uint16_t* __restrict__ runs, const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ starts, uint32_t* __restrict__ out, int n) {
  __shared__ uint4 tile[kSlotVec];
  uint32_t* words = reinterpret_cast<uint32_t*>(tile);
  zero_tile(tile);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = starts[blockIdx.x], hi = starts[blockIdx.x + 1];
  for (int r = lo + warp; r < hi; r += kWarps) {
    const uint32_t a = runs[2 * r], b = runs[2 * r + 1];
    const uint32_t wa = a >> 5, wb = b >> 5;
    const uint32_t ma = 0xffffffffu << (a & 31u);
    const uint32_t mb = 0xffffffffu >> (31u - (b & 31u));
    if (lane == 0) {
      if (wa == wb) {
        atomicOr(words + wa, ma & mb);
      } else {
        atomicOr(words + wa, ma);
        atomicOr(words + wb, mb);
      }
    }
    for (uint32_t w = wa + 1u + lane; w < wb; w += 32u) words[w] = 0xffffffffu;
  }
  __syncthreads();
  store_tile(tile, out, slots[blockIdx.x], n);
}

// K14. Block b covers mask words [256 b, 256 b + 256): bit k of mask[j]
// marks chunk word 32 j + k nonzero, and the nonzero words are vals in
// order, block b's first at vals[bases[b]].
__global__ void __launch_bounds__(kThreads)
expand_words_kernel(const uint32_t* __restrict__ mask, const uint32_t* __restrict__ vals,
                    const int32_t* __restrict__ bases, uint32_t* __restrict__ out,
                    int n_mask, int n) {
  __shared__ uint32_t m_s[kThreads];
  __shared__ int32_t off_s[kThreads];
  __shared__ int32_t warp_total[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t m = j < n_mask ? mask[j] : 0u;
  const int c = __popc(m);
  int x = c;  // inclusive scan within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  int before = bases[blockIdx.x];
  for (int i = 0; i < warp; ++i) before += warp_total[i];
  m_s[threadIdx.x] = m;
  off_s[threadIdx.x] = before + x - c;
  __syncthreads();
  const uint32_t below = (1u << lane) - 1u;
  for (int k = 0; k < 32; ++k) {
    const int t = warp * 32 + k;
    const uint32_t mk = m_s[t];
    if ((mk >> lane) & 1u) {
      const long long word = ((long long)blockIdx.x * kThreads + t) * 32 + lane;
      if (word < n) out[word] = vals[off_s[t] + __popc(mk & below)];
    }
  }
}

}  // namespace

// pos uint16[P], slots int32[c], starts int32[c + 1], out uint32[n] (the
// chunk, 16-byte aligned) -> one block a container.
extern "C" int expand_positions_launch(const void* pos, const void* slots, const void* starts,
                                       void* out, int n_containers, int n, void* stream) {
  expand_positions_kernel<<<n_containers, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(pos), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(starts), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// runs uint16[2 R] (start, last pairs), slots int32[c], starts int32[c + 1],
// out uint32[n] (the chunk, 16-byte aligned) -> one block a container.
extern "C" int expand_runs_launch(const void* runs, const void* slots, const void* starts,
                                  void* out, int n_containers, int n, void* stream) {
  expand_runs_kernel<<<n_containers, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(runs), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(starts), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// mask uint32[n_mask], vals uint32[popcount(mask)], bases int32[blocks],
// out uint32[n] (the chunk) -> one block each 256 mask words.
extern "C" int expand_words_launch(const void* mask, const void* vals, const void* bases,
                                   void* out, int n_mask, int n, void* stream) {
  const int blocks = (n_mask + kThreads - 1) / kThreads;
  expand_words_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(vals),
      static_cast<const int32_t*>(bases), static_cast<uint32_t*>(out), n_mask, n);
  return static_cast<int>(cudaGetLastError());
}
