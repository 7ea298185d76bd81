// K11, the fused evaluation of a query's bitmap tree for Hopper (sm_90a):
// for Q query slots at once, gather each leaf row of every shard, combine
// the leaves with AND, OR, ANDNOT and XOR, and either popcount the result
// to one count per (slot, shard) (count mode) or write it out (slab mode).
//
// It replaces the JAX package's fused XLA programs "count", "vec",
// "count_batch" and "vec_batch" (pilosa_tpu/exec/tpu.py:2070, :2084,
// :2091, :2116): there XLA fuses _eval_spec's gathers and bitwise ops with
// the popcount (and lax.scan runs the slots); torch cannot fuse them, and
// evaluated op by op the tree writes and re-reads a 125 MB slab a node.
//
// The host compiles the tree into a postfix program (ops/kernels.py
// spec_program): op i < kMaxLeaves pushes leaf i, the others pop two values
// and push their combination. Every leaf is pushed once, in leaf order.
// The host also builds the launch's window table (ops/kernels.py
// spec_window): the distinct leaf rows the slots name ("entries"), each a
// pointer to its row in shard 0 and the stride from one shard to the next,
// and per slot and leaf the entry it reads (-1: the zero leaf, a row past
// the stack's height or an empty time range).
//
// Bound by bytes on an H100 SXM: each distinct entry read once, and the
// output written once. The program does a few bitwise ops and at most one
// popcount a word, so reading a row once per slot that names it (Q slots
// of a window share most of their rows) is what lost time. Two bodies:
//
// - The window body (any Q): a block owns one tile of kTile 16-byte words
//   of one shard for all the slots of the launch. One warp stages the
//   tile of every entry into shared memory with TMA bulk copies
//   (cp.async.bulk) completing on an mbarrier, so each entry's bytes leave
//   device memory once whatever the number of slots that name it. Each
//   block walks a contiguous run of tiles (persistent: as many blocks as
//   fit on the card). The ring is double-buffered, the next tile's copies
//   in flight while the slots run over this one, as long as two blocks an
//   SM fit; past that (many entries) a block has one buffer and three or
//   more blocks share the SM, each computing while another waits. Each
//   buffer starts with a zero tile, the zero leaf's, so a leaf is always
//   a load. Each thread then runs every slot's program on its word from
//   shared memory. A program that folds its leaves left to right with one
//   op (Intersect, Union, Difference or Xor of rows, a time range, a lone
//   row) runs a kernel with that op compiled in, unrolled exactly for up to
//   kFoldLeaves leaves; any other program walks its leaves in order,
//   running the combines that follow each push from a host-built table
//   (ncomb, cops) with the stack in registers. The first kCached leaves
//   keep their last tile and value in registers: a slot that names the
//   same row as the slot before reads nothing (a predicated load). Count
//   mode popcounts a word with three popcounts (a carry-save adder), sums
//   a slot over the warp (redux.sync) and the block (shared memory), and
//   adds it to out[q, s] with one atomic a (slot, shard, block); slab mode
//   writes each slot's words.
//   What limits it next: the arithmetic a slot costs on each word, not the
//   copies. At 64 slots x 3 leaves the slots read up to 24 GB from shared
//   memory (about 0.8 ms at about 30 TB/s over 132 SMs, an estimate, not
//   a measurement) where the cache misses, and issue some 30 integer
//   instructions and 3 popcounts (16 a clock an SM) a slot and word.
// - The per-slot body (the first design, for one slot of a program that is
//   not a fold, or of one leaf counted, where it is faster on an H100): a
//   block owns one chunk of one shard
//   for one slot and loads that slot's leaves straight from device memory,
//   the first kAhead of a word together, and interprets the postfix
//   program with the stack in registers.
//
// Shared memory caps the window body: at least one buffer of (1 +
// entries) x kTile x 16 bytes, plus 20 bytes a slot. A launch takes at most
// kMaxEntries entries and kMaxWindowSlots slots; the host splits a window
// past either into launches of whole slots (ops/kernels.py spec_split).
// Each window kernel may take all the dynamic shared memory a block can
// have (set once a device): server threads launch windows of different
// sizes on one kernel at once, and a limit set to each launch's own size
// could be lowered under another's launch.
// chip_smoke.py times the window body against two variants the entry
// point also runs (kBodyWalk, kBodyFoldN), which no served launch takes,
// to show what the fold kernels and their exact unrolling each save.
//
// The entry point returns cudaGetLastError() right after its launches, so
// a launch the card refuses is reported to the caller instead of being
// lost.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int kMaxLeaves = 16;         // ops/kernels.py MAX_SPEC_LEAVES
constexpr int kMaxDepth = 8;           // ops/kernels.py MAX_SPEC_DEPTH
constexpr int kMaxOps = 32;            // 2 * kMaxLeaves - 1, rounded up
constexpr int kMaxInlineRows = 256;    // ops/kernels.py SPEC_INLINE_ROWS
constexpr int kMaxEntries = 24;        // ops/kernels.py MAX_SPEC_ENTRIES
constexpr int kMaxWindowSlots = 512;   // ops/kernels.py MAX_SPEC_SLOTS

// The per-slot body.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 8;  // uint4 words a block
constexpr int kAhead = 4;             // leaf loads in flight a word
constexpr int kMaxSlotsALaunch = 65535;  // gridDim.y

// The window body.
constexpr int kWinThreads = 256;
constexpr int kTile = kWinThreads;  // uint4 words of an entry a stage: one a thread
constexpr int kStages = 2;          // ring buffers a block, at most
constexpr int kFoldLeaves = 4;      // folds of up to this many leaves are unrolled exactly
constexpr int kCached = 4;          // leaves whose last value a thread keeps
constexpr int kTabStride = 16;      // bytes of a slot's row of the shared slot table
// A wait on a tile's copies that outlasts this many clocks (about a
// second) traps, so a lost copy fails the launch instead of hanging the card.
constexpr long long kWaitClocks = 2000000000LL;

constexpr int kOpAnd = 0x80, kOpOr = 0x81, kOpAndNot = 0x82, kOpXor = 0x83;
constexpr int kGeneric = 0;  // the window body's tag for a program walked leaf by leaf

// The entry point's bodies (ops/kernels.py SPEC_BODY_*): the per-slot
// body; the window body as the launch chooses it; and two variants of the
// window body that chip_smoke.py times against it, and that no served
// launch takes: every program walked leaf by leaf (no fold kernels), and
// a fold's kernel over its run-time leaf count (no exact unrolling).
constexpr int kBodySlot = 0, kBodyWindow = 1, kBodyWalk = 2, kBodyFoldN = 3;

struct SpecTable {
  const uint4* base[kMaxEntries];  // entry e: its row's words in shard 0
  long long stride[kMaxEntries];   // uint4 words from one shard to the next
  int slots[kMaxInlineRows];       // slots[q * n_leaves + i], when they fit
  unsigned long long ncomb;        // combines after leaf i's push, 4 bits a leaf
  unsigned int cops;               // the combines' ops in order, 2 bits each (op - kOpAnd)
  unsigned char ops[kMaxOps];
  int n_ops;
  int n_leaves;
  int n_entries;
};
static_assert(sizeof(SpecTable) % 4 == 0, "staged word by word");
// A block's shared memory on an H100 (227 KiB) beside the window body's
// static tables, with room for their alignment.
constexpr size_t kMaxDynamicSmem = 232448 - sizeof(SpecTable) - 128;
static_assert((size_t)(1 + kMaxEntries) * kTile * 16 + (size_t)kMaxWindowSlots * (kTabStride + 4) <=
                  kMaxDynamicSmem,
              "the window body's largest launch fits a block's shared memory in one buffer");

__device__ __forceinline__ uint32_t popc4(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

template <int kOp>
__device__ __forceinline__ uint4 combine_c(const uint4& a, const uint4& b) {
  if (kOp == kOpAnd) return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  if (kOp == kOpOr) return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  if (kOp == kOpAndNot) return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__device__ __forceinline__ uint4 combine(int op, const uint4& a, const uint4& b) {
  switch (op) {
    case kOpAnd: return combine_c<kOpAnd>(a, b);
    case kOpOr: return combine_c<kOpOr>(a, b);
    case kOpAndNot: return combine_c<kOpAndNot>(a, b);
    default: return combine_c<kOpXor>(a, b);
  }
}

// stk[k] = v and stk[k] for a run-time k, as selects over compile-time
// indices so that the array stays in registers.
template <int N>
__device__ __forceinline__ void put(uint4 (&stk)[N], int k, const uint4& v) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j == k) stk[j] = v;
  }
}

template <int N>
__device__ __forceinline__ uint4 get(const uint4 (&stk)[N], int k) {
  uint4 v = stk[0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    if (j == k) v = stk[j];
  }
  return v;
}

// Copy the launch's table from the parameters into shared memory, word by
// word, so that no run-time index reaches the parameter space.
__device__ __forceinline__ void stage_table(const SpecTable& t, SpecTable& ts, int threads) {
  const int* src = reinterpret_cast<const int*>(&t);
  int* dst = reinterpret_cast<int*>(&ts);
  for (int k = threadIdx.x; k < (int)(sizeof(SpecTable) / 4); k += threads) dst[k] = src[k];
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads, 3)
spec_slot_kernel(const __grid_constant__ SpecTable t, const int* __restrict__ slots_dev,
                 int32_t* __restrict__ counts, uint4* __restrict__ slab, int q0,
                 int s_count, int w4, int chunks) {
  __shared__ SpecTable ts;
  __shared__ const uint4* leaf[kMaxLeaves];
  __shared__ uint32_t red[kWarps];
  stage_table(t, ts, kThreads);
  __syncthreads();
  const int q = q0 + blockIdx.y;
  const int s = blockIdx.x / chunks;
  const int c = blockIdx.x - s * chunks;
  const int n_leaves = ts.n_leaves;
  const int n_ops = ts.n_ops;
  if (threadIdx.x < n_leaves) {
    const int i = threadIdx.x;
    const int e = slots_dev != nullptr ? slots_dev[q * n_leaves + i] : ts.slots[q * n_leaves + i];
    leaf[i] = e < 0 ? nullptr : ts.base[e] + (long long)s * ts.stride[e];
  }
  __syncthreads();
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int end = min((c + 1) * kChunk, w4);
  uint32_t cnt = 0u;
  for (int w = c * kChunk + threadIdx.x; w < end; w += kThreads) {
    uint4 pre[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const uint4* p = k < n_leaves ? leaf[k] : nullptr;
      pre[k] = p != nullptr ? __ldg(p + w) : zero;
    }
    uint4 stk[kMaxDepth - 1];
#pragma unroll
    for (int k = 0; k < kMaxDepth - 1; ++k) stk[k] = zero;
    uint4 top = zero;
    int depth = 0;  // values on the stack, top included
    for (int pc = 0; pc < n_ops; ++pc) {
      const int op = ts.ops[pc];
      if (op < kMaxLeaves) {  // push leaf op (leaves are pushed in order)
        uint4 v;
        if (op < kAhead) {
          v = get(pre, op);
        } else {
          const uint4* p = leaf[op];
          v = p != nullptr ? __ldg(p + w) : zero;
        }
        if (depth > 0) put(stk, depth - 1, top);
        top = v;
        ++depth;
      } else {
        top = combine(op, get(stk, depth - 2), top);
        --depth;
      }
    }
    if (kCount) {
      cnt += popc4(top);
    } else {
      slab[((size_t)q * s_count + s) * w4 + w] = top;
    }
  }
  if (kCount) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = cnt;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t v = 0u;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) v += red[k];
      if (v) atomicAdd(counts + (size_t)q * s_count + s, (int32_t)v);
    }
  }
}

// ---------------------------------------------------------------------------
// The window body
// ---------------------------------------------------------------------------

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

// Arrive on `bar` (its one arrival a phase) and expect `bytes` of copies.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Copy `bytes` (16-byte aligned, a multiple of 16) from global to shared
// memory with the TMA, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Byte i (a compile-time index) of a slot's table row: the staged tile of
// leaf i, 1 + its entry, or 0 (the zero tile) for the zero leaf.
__device__ __forceinline__ int entry_of(const int4& row, int i) {
  const int word = (i >> 2) == 0 ? row.x : (i >> 2) == 1 ? row.y : (i >> 2) == 2 ? row.z : row.w;
  return (static_cast<uint32_t>(word) >> (8 * (i & 3))) & 0xffu;
}

// popc4 with three popcounts: x, y and z through a full adder (sum and
// carry bits), so the slow popcount unit (16 a clock an SM) runs 3 times a
// word, not 4.
__device__ __forceinline__ uint32_t popc4_csa(const uint4& v) {
  const uint32_t s = v.x ^ v.y ^ v.z;
  const uint32_t c = (v.x & v.y) | (v.z & (v.x ^ v.y));
  return __popc(s) + __popc(v.w) + 2u * __popc(c);
}

// Word k of staged tile e (0: the zero tile).
__device__ __forceinline__ uint4 staged(const uint4* buf, int e, int k) {
  return buf[e * kTile + k];
}

// Leaf i's word (i a compile-time index once unrolled) from staged tile e:
// the first kCached leaves keep their last tile and value in registers,
// so a slot that names the same row as the slot before reads nothing.
__device__ __forceinline__ uint4 leaf_word(const uint4* buf, int e, int i, uint4 (&val)[kCached],
                                           int (&last)[kCached]) {
  if (i < kCached) {
    const int ci = i < kCached ? i : 0;  // i itself: keeps the index in range
    if (e != last[ci]) val[ci] = staged(buf, e, threadIdx.x);
    last[ci] = e;
    return val[ci];
  }
  return staged(buf, e, threadIdx.x);
}

// A left fold of the slot's leaves with kOp: kL leaves, or n_leaves when
// kL is 0.
template <int kOp, int kL>
__device__ __forceinline__ uint4 eval_fold(const uint4* buf, const int4& row, int n_leaves,
                                           uint4 (&val)[kCached], int (&last)[kCached]) {
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < (kL > 0 ? kL : kMaxLeaves); ++i) {
    if (kL > 0 || i < n_leaves) {
      const uint4 v = leaf_word(buf, entry_of(row, i), i, val, last);
      acc = i == 0 ? v : combine_c<kOp>(acc, v);
    }
  }
  return acc;
}

// Any program, leaf by leaf: push leaf i, then run the ncomb[i] combines
// that follow it, their ops from cops; the stack below the top in
// registers, kDepth values at most.
template <int kDepth>
__device__ __forceinline__ uint4 eval_program(const uint4* buf, const int4& row, int n_leaves,
                                              unsigned long long ncomb, uint32_t cops,
                                              uint4 (&val)[kCached], int (&last)[kCached]) {
  uint4 stk[kDepth - 1];
#pragma unroll
  for (int d = 0; d < kDepth - 1; ++d) stk[d] = make_uint4(0u, 0u, 0u, 0u);
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  int depth = 0;  // values on the stack, acc (the top) included
#pragma unroll
  for (int i = 0; i < kMaxLeaves; ++i) {
    if (i < n_leaves) {
      const uint4 v = leaf_word(buf, entry_of(row, i), i, val, last);
      if (i > 0) put(stk, depth - 1, acc);
      acc = v;
      ++depth;
      for (int c = (int)((ncomb >> (4 * i)) & 15u); c > 0; --c) {
        acc = combine(kOpAnd + (int)(cops & 3u), get(stk, depth - 2), acc);
        cops >>= 2;
        --depth;
      }
    }
  }
  return acc;
}

// Every slot of the launch over word w of the staged tile `buf` of shard
// s: count mode adds each slot's popcount to cnt[q], slab mode writes it.
template <bool kCount, int kOp, int kKind>
__device__ __forceinline__ void run_tile(const uint4* buf, const unsigned char* tab, uint32_t* cnt,
                                         uint4* slab, const SpecTable& ts, int q_count,
                                         int s_count, int s, int w, int w4) {
  const int lane = threadIdx.x & 31;
  const bool live = w < w4;
  const int n_leaves = ts.n_leaves;
  const unsigned long long ncomb = ts.ncomb;
  const uint32_t cops = ts.cops;
  uint4 val[kCached];
  int last[kCached];
#pragma unroll
  for (int i = 0; i < kCached; ++i) {
    val[i] = make_uint4(0u, 0u, 0u, 0u);
    last[i] = -1;
  }
  for (int qg = 0; qg < q_count; qg += 32) {
    const int qn = min(32, q_count - qg);
    uint32_t mine = 0u;
    for (int j = 0; j < qn; ++j) {
      const int q = qg + j;
      const int4 row = *reinterpret_cast<const int4*>(tab + q * kTabStride);
      uint4 acc;
      if constexpr (kOp != kGeneric) {
        acc = eval_fold<kOp, kKind>(buf, row, n_leaves, val, last);
      } else {
        acc = eval_program<kKind>(buf, row, n_leaves, ncomb, cops, val, last);
      }
      if (kCount) {
        const uint32_t sum = __reduce_add_sync(0xffffffffu, live ? popc4_csa(acc) : 0u);
        if (lane == j) mine = sum;
      } else if (live) {
        slab[((size_t)q * s_count + s) * w4 + w] = acc;
      }
    }
    if (kCount && lane < qn && mine) atomicAdd(&cnt[qg + lane], mine);
  }
}

// t: the table; slots_dev: the slot table on the card, or null when it is
// in t; tiles: kTile-word tiles a shard; per_block: tiles a block walks;
// stages: ring buffers (1 to kStages).
// kOp is the one op of a left fold, or kGeneric; kind is a fold's leaves
// (1 to kFoldLeaves, 0: more) or a program's stack depth (3 or kMaxDepth).
template <bool kCount, int kOp>
__global__ void __launch_bounds__(kWinThreads, 512 / kWinThreads)
spec_window_kernel(const __grid_constant__ SpecTable t, const int* __restrict__ slots_dev,
                   int32_t* __restrict__ counts, uint4* __restrict__ slab, int q_count,
                   int s_count, int w4, int tiles, int per_block, int kind, int stages) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ SpecTable ts;
  __shared__ __align__(8) uint64_t bar[kStages];
  const int tid = threadIdx.x, lane = tid & 31;
  const int first = blockIdx.x * per_block;
  const int items = min(per_block, s_count * tiles - first);
  if (items <= 0) return;
  stage_table(t, ts, kWinThreads);
  __syncthreads();
  const int n_leaves = ts.n_leaves, n_entries = ts.n_entries;
  // [stages][1 + n_entries][kTile]: each buffer's tile 0 stays zero (the
  // zero leaf's), entry e's tile is 1 + e.
  uint4* ring = reinterpret_cast<uint4*>(dyn);
  const int span = (1 + n_entries) * kTile;
  unsigned char* tab =
      reinterpret_cast<unsigned char*>(ring + (size_t)stages * span);  // [Q][16]
  uint32_t* cnt = reinterpret_cast<uint32_t*>(tab + (size_t)q_count * kTabStride);  // [Q]
  for (int k = tid; k < q_count * kTabStride; k += kWinThreads) {
    const int q = k / kTabStride, i = k % kTabStride;
    int e = -1;
    if (i < n_leaves) {
      e = slots_dev != nullptr ? slots_dev[q * n_leaves + i] : ts.slots[q * n_leaves + i];
    }
    tab[k] = (unsigned char)(e + 1);
  }
  for (int b = 0; b < stages; ++b) ring[(size_t)b * span + tid] = make_uint4(0u, 0u, 0u, 0u);
  if (kCount) {
    for (int q = tid; q < q_count; q += kWinThreads) cnt[q] = 0u;
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < kStages; ++k) mbar_init(&bar[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile `first + k` of every entry into ring slot k % stages, by warp 0.
  auto issue = [&](int k) {
    const int item = first + k;
    const int s = item / tiles, c = item - s * tiles;
    const uint32_t bytes = (uint32_t)min(kTile, w4 - c * kTile) * sizeof(uint4);
    uint4* dst = ring + (size_t)(k % stages) * span + kTile;
    uint64_t* b = &bar[k % stages];
    if (lane == 0) mbar_arrive_expect(b, bytes * (uint32_t)n_entries);
    __syncwarp();
    for (int e = lane; e < n_entries; e += 32) {
      bulk_copy(dst + (size_t)e * kTile,
                ts.base[e] + (long long)s * ts.stride[e] + (long long)c * kTile, bytes, b);
    }
  };
  if (tid < 32) {
    for (int k = 0; k < stages - 1 && k < items; ++k) issue(k);
  }

  for (int k = 0; k < items; ++k) {
    const int item = first + k;
    const int s = item / tiles, c = item - s * tiles;
    if (tid < 32 && k + stages - 1 < items) {
      // Every thread passed the barrier after its last read of the slot.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(k + stages - 1);
    }
    mbar_wait(&bar[k % stages], (uint32_t)(k / stages) & 1u);
    const uint4* buf = ring + (size_t)(k % stages) * span;
    const int w = c * kTile + tid;
    if constexpr (kOp != kGeneric) {
      switch (kind) {
        case 1: run_tile<kCount, kOp, 1>(buf, tab, cnt, slab, ts, q_count, s_count, s, w, w4); break;
        case 2: run_tile<kCount, kOp, 2>(buf, tab, cnt, slab, ts, q_count, s_count, s, w, w4); break;
        case 3: run_tile<kCount, kOp, 3>(buf, tab, cnt, slab, ts, q_count, s_count, s, w, w4); break;
        case 4: run_tile<kCount, kOp, 4>(buf, tab, cnt, slab, ts, q_count, s_count, s, w, w4); break;
        default: run_tile<kCount, kOp, 0>(buf, tab, cnt, slab, ts, q_count, s_count, s, w, w4);
      }
    } else {
      if (kind == 3) {
        run_tile<kCount, kGeneric, 3>(buf, tab, cnt, slab, ts, q_count, s_count, s, w, w4);
      } else {
        run_tile<kCount, kGeneric, kMaxDepth>(buf, tab, cnt, slab, ts, q_count, s_count, s, w,
                                              w4);
      }
    }
    __syncthreads();  // the slot is read and the tile's counts are in
    if (kCount && (k + 1 == items || (item + 1) / tiles != s)) {
      for (int q = tid; q < q_count; q += kWinThreads) {
        const uint32_t v = cnt[q];
        if (v) {
          atomicAdd(counts + (size_t)q * s_count + s, (int32_t)v);
          cnt[q] = 0u;
        }
      }
      __syncthreads();
    }
  }
}

// The window body's kernel and kind for a program: a left fold of its
// leaves with one op (kOpAnd for one leaf) runs that op's kernel, kind
// its leaves (0 past kFoldLeaves, or for kBodyFoldN); any other, and every
// program under kBodyWalk, runs the kGeneric kernel, kind its stack depth
// (3, or kMaxDepth past 3). Fills t.ncomb and t.cops.
void window_shape(SpecTable& t, int body, int* op, int* kind) {
  int depth = 0, max_depth = 0, leaf = -1, n_comb = 0;
  bool fold = t.ops[0] == 0;
  int fold_op = kOpAnd;
  t.ncomb = 0ull;
  t.cops = 0u;
  for (int pc = 0; pc < t.n_ops; ++pc) {
    const int o = t.ops[pc];
    if (o < kMaxLeaves) {
      leaf = o;
      max_depth = ++depth > max_depth ? depth : max_depth;
      fold = fold && (o == 0 || (pc == 2 * o - 1));
    } else {
      --depth;
      t.ncomb += 1ull << (4 * leaf);
      t.cops |= (unsigned)(o - kOpAnd) << (2 * n_comb);
      ++n_comb;
      if (pc == 2) fold_op = o;
      fold = fold && pc == 2 * leaf && o == fold_op;
    }
  }
  if (fold && body != kBodyWalk) {
    *op = fold_op;
    *kind = t.n_leaves <= kFoldLeaves && body != kBodyFoldN ? t.n_leaves : 0;
  } else {
    *op = kGeneric;
    *kind = max_depth <= 3 ? 3 : kMaxDepth;
  }
}

// The current device and its SM count, read from the card once a device.
cudaError_t device_sms(int* dev, int* sms) {
  static std::atomic<int> cached[64] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 64 && (*sms = cached[*dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess && *dev < 64) cached[*dev].store(*sms, std::memory_order_relaxed);
  return err;
}

// The ring is double-buffered while two blocks an SM still fit: the slots
// of a window are arithmetic on the staged tile, and with fewer warps
// resident their latency, not the copies, sets the time. Past that, one
// buffer a block and more blocks, each computing while another waits.
template <bool kCount, int kOp>
cudaError_t launch_window(const SpecTable& t, int kind, const int* slots_dev, int32_t* counts,
                          uint4* slab, int q, int s, int w4, cudaStream_t st) {
  auto* kern = spec_window_kernel<kCount, kOp>;
  const size_t tile = (size_t)(1 + t.n_entries) * kTile * sizeof(uint4);
  const size_t rest = (size_t)q * (kTabStride + sizeof(uint32_t));
  int stages = kStages, per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return err;
  // The kernel may take all the dynamic shared memory a block can have on
  // this device (its opt-in limit less the kernel's static tables), set
  // once a device. The attribute belongs to the kernel, which every
  // launching thread shares: set to one constant, no launch finds it
  // lowered by a concurrent launch of a smaller window (each launch passes
  // its own size).
  static std::atomic<int> allowed[64];
  int cap = dev < 64 ? allowed[dev].load(std::memory_order_acquire) : 0;
  if (cap == 0) {
    int optin = 0;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return err;
    cap = optin - (int)fa.sharedSizeBytes;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed[dev].store(cap, std::memory_order_release);
  }
  for (;; --stages) {
    if (stages > 1 && stages * tile + rest > (size_t)cap) continue;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kWinThreads,
                                                        stages * tile + rest);
    if (err != cudaSuccess) return err;
    if (per_sm >= 2 || stages == 1) break;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (w4 + kTile - 1) / kTile;
  const int items = s * tiles;
  const int per_block = (items + sms * per_sm - 1) / (sms * per_sm);
  const int grid = (items + per_block - 1) / per_block;
  kern<<<grid, kWinThreads, stages * tile + rest, st>>>(t, slots_dev, counts, slab, q, s, w4,
                                                        tiles, per_block, kind, stages);
  return cudaSuccess;
}

template <bool kCount>
cudaError_t launch_window_for(const SpecTable& t, int body, const int* slots_dev,
                              int32_t* counts, uint4* slab, int q, int s, int w4,
                              cudaStream_t st) {
  SpecTable u = t;
  int op = kGeneric, kind = 0;
  window_shape(u, body, &op, &kind);
  switch (op) {
    case kOpAnd:
      return launch_window<kCount, kOpAnd>(u, kind, slots_dev, counts, slab, q, s, w4, st);
    case kOpOr:
      return launch_window<kCount, kOpOr>(u, kind, slots_dev, counts, slab, q, s, w4, st);
    case kOpAndNot:
      return launch_window<kCount, kOpAndNot>(u, kind, slots_dev, counts, slab, q, s, w4, st);
    case kOpXor:
      return launch_window<kCount, kOpXor>(u, kind, slots_dev, counts, slab, q, s, w4, st);
    default:
      return launch_window<kCount, kGeneric>(u, kind, slots_dev, counts, slab, q, s, w4, st);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. bases holds n_entries device
// pointers (16-byte aligned), each entry's row in shard 0, strides the
// uint4 words from one shard to the next of each, ops the n_ops program
// bytes, slots_host the q x n_leaves entries of each slot's leaves (host
// memory, -1 the zero leaf) and slots_dev the same on the device, or null
// when they fit the launch's parameters (q * n_leaves <= 256). mode 0
// writes counts int32[q, s] (zeroed here first), 1 writes slab
// int32[q, s, w]; w is a multiple of 4. body 0 runs the per-slot body, 1
// the window body (at most 24 entries and 512 slots), 2 and 3 its timed
// variants (kBodyWalk, kBodyFoldN). The caller has checked the program
// and every shape.
extern "C" int spec_eval_launch(const void* bases, const void* strides, int n_entries,
                                const void* ops, int n_ops, int n_leaves,
                                const void* slots_host, const void* slots_dev, void* counts,
                                void* slab, int mode, int body, int q, int s, int w,
                                void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_ops < 1 || n_ops > kMaxOps ||
      n_entries < 0 || n_entries > kMaxEntries ||
      (slots_dev == nullptr && q * n_leaves > kMaxInlineRows) ||
      body < kBodySlot || body > kBodyFoldN || (body != kBodySlot && q > kMaxWindowSlots)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SpecTable t;
  memset(&t, 0, sizeof(t));
  memcpy(t.base, bases, sizeof(void*) * n_entries);
  memcpy(t.stride, strides, sizeof(long long) * n_entries);
  memcpy(t.ops, ops, n_ops);
  if (slots_dev == nullptr) memcpy(t.slots, slots_host, sizeof(int) * q * n_leaves);
  t.n_ops = n_ops;
  t.n_leaves = n_leaves;
  t.n_entries = n_entries;
  const auto st = static_cast<cudaStream_t>(stream);
  const int w4 = w / 4;
  auto* cnt = static_cast<int32_t*>(counts);
  auto* out = static_cast<uint4*>(slab);
  const auto* sd = static_cast<const int*>(slots_dev);
  if (mode == 0) {
    const cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int32_t) * (size_t)q * s, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (body != kBodySlot) {
    const cudaError_t err = mode == 0
                                ? launch_window_for<true>(t, body, sd, cnt, out, q, s, w4, st)
                                : launch_window_for<false>(t, body, sd, cnt, out, q, s, w4, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = (w4 + kChunk - 1) / kChunk;
  for (int q0 = 0; q0 < q; q0 += kMaxSlotsALaunch) {
    const dim3 grid(s * chunks, min(kMaxSlotsALaunch, q - q0));
    if (mode == 0) {
      spec_slot_kernel<true><<<grid, kThreads, 0, st>>>(t, sd, cnt, out, q0, s, w4, chunks);
    } else {
      spec_slot_kernel<false><<<grid, kThreads, 0, st>>>(t, sd, cnt, out, q0, s, w4, chunks);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
