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
//   K14 expand_words: one block a tile of 2048 mask words (65536 chunk
//       words), 512 threads, each taking a group of 4 mask words with one
//       16-byte load, the tile's base (computed by the host from the mask
//       it already holds) loaded beside it. The block scans the groups'
//       popcounts into value offsets and sorts each group four ways. Zero
//       groups cost nothing more. A sparse group (1 to 4 set bits) is
//       stored by its own thread, which finds its bits in order and loads
//       their values while the block waits at its barrier. An all-ones
//       group, whose 128 words and 128 values are both contiguous, goes to
//       a list in shared memory that all 16 warps copy with 16-byte loads
//       and stores, 8 groups' loads in flight a lane (4 when a value offset
//       sits off 16 bytes: each lane then loads the two aligned vectors its
//       16 bytes span and shifts). A mixed group goes to a second list,
//       whose groups the warps share 2 at a time, lane b storing value
//       base + popc(m & below) for each set bit b. So a block waits on two
//       round trips to memory, the mask and then the values, and a run of
//       bitmap containers is a block-wide copy.
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
// What bounds K14 depends on the mask. A container chunk's remainder of
// bitmap containers (s's in chip_smoke.py: 2^20 values in runs of all-ones
// mask words, 9.4 MB moved) is bound by its bytes, which only runs of
// 16-byte copies with many loads in flight reach. A sparse words chunk
// (v's: 6355 values in 1.1 MB of mask) is bound by the launch and by the
// round trips a block waits on; a walk of every mask word, zeros
// included, and a block every 256 mask words spend their time there. So
// the grid is 128 blocks a 2^23-word chunk, a block waits on two round
// trips (mask, then values), and its batches are sized so that nothing
// spills at 512 threads (128 registers a thread): a copy batch of 16
// groups spilled, and ran slower.
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

// K14: mask words a group (one 16-byte load, one thread), threads a block
// and so mask words a tile (EXPAND_WORDS_BLOCK in ops/kernels.py); the
// most set bits of a sparse group, which its own thread stores; the
// all-ones groups a warp copies at once (half that when a value offset
// sits off 16 bytes), and the mixed groups a warp stores at once.
constexpr int kGroup = 4;
constexpr int kWordsThreads = 512;
constexpr int kWordsWarps = kWordsThreads / 32;
constexpr int kWordsTile = kGroup * kWordsThreads;
constexpr int kSparse = 4;
constexpr int kCopyBatch = 8;
constexpr int kMixBatch = 2;

// Copies all-ones groups list[0 .. count) (count <= D): group (g, o) holds
// the 128 chunk words from word 32 g, its values vals[o .. o + 128); lane i
// moves 16 bytes of each. SHIFT: a value offset may sit off a 16-byte
// boundary, so each lane loads the two aligned vectors its 16 bytes span
// and shifts. Every load of the batch is issued before its first store.
template <int D, bool SHIFT>
__device__ __forceinline__ void copy_groups(const int2* list, int count,
                                            const uint32_t* __restrict__ vals,
                                            uint32_t* __restrict__ out, int lane) {
  uint4 a[D], b[D];
  int r[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k < count) {
      const uint32_t* p = vals + list[k].y;
      r[k] = SHIFT ? static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3u) : 0;
      const uint4* q = reinterpret_cast<const uint4*>(p - r[k]);
      a[k] = q[lane];
      if (SHIFT && r[k]) b[k] = q[lane + 1];
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k < count) {
      uint4 v = a[k];
      if (SHIFT) {
        if (r[k] == 1) v = make_uint4(a[k].y, a[k].z, a[k].w, b[k].x);
        else if (r[k] == 2) v = make_uint4(a[k].z, a[k].w, b[k].x, b[k].y);
        else if (r[k] == 3) v = make_uint4(a[k].w, b[k].x, b[k].y, b[k].z);
      }
      reinterpret_cast<uint4*>(out + 32LL * list[k].x)[lane] = v;
    }
  }
}

__device__ __forceinline__ uint32_t pick(const uint4& m, int k) {
  return k == 0 ? m.x : k == 1 ? m.y : k == 2 ? m.z : m.w;
}

// K14. Block t covers mask words [2048 t, 2048 t + 2048), thread i the
// group of 4 from 2048 t + 4 i: bit k of mask[j] marks chunk word 32 j + k
// nonzero, and the nonzero words are vals in order, block t's first at
// vals[bases[t]]. mask and out are 16-byte aligned; vals need not be.
__global__ void __launch_bounds__(kWordsThreads, 1)
expand_words_kernel(const uint32_t* __restrict__ mask, const uint32_t* __restrict__ vals,
                    const int32_t* __restrict__ bases, uint32_t* __restrict__ out,
                    int n_mask, int n) {
  __shared__ int2 full_s[kWordsThreads];
  __shared__ int2 mixed_s[kWordsThreads];
  __shared__ uint4 mixed_m[kWordsThreads];
  __shared__ int32_t warp_words[kWordsWarps];
  __shared__ int32_t warp_groups[kWordsWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = bases[blockIdx.x];  // in flight with the mask's load
  const int g = blockIdx.x * kWordsTile + kGroup * threadIdx.x;
  uint4 m;
  if (g + kGroup <= n_mask) {
    m = reinterpret_cast<const uint4*>(mask)[g / kGroup];
  } else {
    m = make_uint4(g < n_mask ? mask[g] : 0u, g + 1 < n_mask ? mask[g + 1] : 0u,
                   g + 2 < n_mask ? mask[g + 2] : 0u, 0u);
  }
  const int c = __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
  const bool full = (m.x & m.y & m.z & m.w) == 0xffffffffu &&
                    32LL * (g + kGroup) <= static_cast<long long>(n);
  // All-ones groups counted low, mixed groups (more than kSparse set bits,
  // not all ones) from bit 16.
  const int groups = full ? 1 : c > kSparse ? 1 << 16 : 0;
  int x = c, y = groups;  // inclusive scans within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int xs = __shfl_up_sync(0xffffffffu, x, o);
    const int ys = __shfl_up_sync(0xffffffffu, y, o);
    if (lane >= o) {
      x += xs;
      y += ys;
    }
  }
  if (lane == 31) {
    warp_words[warp] = x;
    warp_groups[warp] = y;
  }
  __syncthreads();
  int off = base + x - c, at = y - groups, total = 0;
#pragma unroll
  for (int i = 0; i < kWordsWarps; ++i) {
    if (i < warp) {
      off += warp_words[i];
      at += warp_groups[i];
    }
    total += warp_groups[i];
  }
  if (full) {
    full_s[at & 0xffff] = make_int2(g, off);
  } else if (c > kSparse) {
    mixed_m[at >> 16] = m;
    mixed_s[at >> 16] = make_int2(g, off);
  }
  // A sparse group (1 to kSparse set bits): its own thread finds the bits
  // in order and loads their values now, under the barrier, and stores
  // them after it.
  uint32_t sv[kSparse];
  long long sat[kSparse];
  uint32_t w[kGroup] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int t = 0; t < kSparse; ++t) {
    const int k = w[0] ? 0 : w[1] ? 1 : w[2] ? 2 : w[3] ? 3 : kGroup;
    uint32_t cur = 0u;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) cur = q == k ? w[q] : cur;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) w[q] = q == k ? (cur & (cur - 1u)) : w[q];
    sat[t] = c <= kSparse && k < kGroup ? 32LL * (g + k) + (__ffs(cur) - 1)
                                        : static_cast<long long>(n);
    if (sat[t] < n) sv[t] = vals[off + t];
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kSparse; ++t) {
    if (sat[t] < n) out[sat[t]] = sv[t];
  }
  const int n_full = total & 0xffff, n_mixed = total >> 16;
  const uint32_t below = (1u << lane) - 1u;
  // Mixed groups, the block's list: lane b stores value o + popc(m & below)
  // for each set bit b of each mask word, kMixBatch groups' loads before
  // their stores.
  for (int b0 = warp * kMixBatch; b0 < n_mixed; b0 += kWordsWarps * kMixBatch) {
    uint32_t v[kMixBatch][kGroup];
    bool on[kMixBatch][kGroup];
    long long w0[kMixBatch];
#pragma unroll
    for (int j = 0; j < kMixBatch; ++j) {
      const bool live = b0 + j < n_mixed;
      const int2 e = live ? mixed_s[b0 + j] : make_int2(0, 0);
      const uint4 mm = live ? mixed_m[b0 + j] : make_uint4(0u, 0u, 0u, 0u);
      w0[j] = 32LL * e.x + lane;
      int o = e.y;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const uint32_t mk = pick(mm, k);
        on[j][k] = ((mk >> lane) & 1u) && w0[j] + 32 * k < n;
        if (on[j][k]) v[j][k] = vals[o + __popc(mk & below)];
        o += __popc(mk);
      }
    }
#pragma unroll
    for (int j = 0; j < kMixBatch; ++j) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (on[j][k]) out[w0[j] + 32 * k] = v[j][k];
      }
    }
  }
  // All-ones groups, the block's list: straight copies, kCopyBatch a warp.
  for (int b0 = warp * kCopyBatch; b0 < n_full; b0 += kWordsWarps * kCopyBatch) {
    const int count = min(kCopyBatch, n_full - b0);
    const bool off16 = lane < count &&
                       (reinterpret_cast<uintptr_t>(vals + full_s[b0 + lane].y) & 15u);
    if (!__ballot_sync(0xffffffffu, off16)) {
      copy_groups<kCopyBatch, false>(full_s + b0, count, vals, out, lane);
    } else {
      copy_groups<kCopyBatch / 2, true>(full_s + b0, min(count, kCopyBatch / 2), vals, out,
                                        lane);
      if (count > kCopyBatch / 2)
        copy_groups<kCopyBatch / 2, true>(full_s + b0 + kCopyBatch / 2,
                                          count - kCopyBatch / 2, vals, out, lane);
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
// out uint32[n] (the chunk) -> one block each 2048 mask words. mask and
// out must be 16-byte aligned and n at most 32 n_mask, else the launch is
// refused with cudaErrorInvalidValue.
extern "C" int expand_words_launch(const void* mask, const void* vals, const void* bases,
                                   void* out, int n_mask, int n, void* stream) {
  if (n_mask <= 0 || n < 0 || static_cast<long long>(n) > 32LL * n_mask ||
      (reinterpret_cast<uintptr_t>(mask) & 15u) || (reinterpret_cast<uintptr_t>(out) & 15u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_mask + kWordsTile - 1) / kWordsTile;
  expand_words_kernel<<<blocks, kWordsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(vals),
      static_cast<const int32_t*>(bases), static_cast<uint32_t*>(out), n_mask, n);
  return static_cast<int>(cudaGetLastError());
}
