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
// and push their combination. Leaf i is a stack int32[S, R, W] (or a slab
// int32[S, W]) with a row per slot; a row of -1 is the zero leaf (a row past
// the stack's height, an empty time range). Every leaf is pushed once, in
// leaf order, so the first kAhead leaves of a word are loaded together
// before the program runs.
//
// Bound by bytes on an H100 SXM: each leaf row is read once per slot (16
// bytes a load, neighbouring threads on neighbouring addresses) and the
// program does a few bitwise ops and at most one popcount a word. The
// stack lives in registers (kMaxDepth - 1 uint4 beside the top, indexed
// through unrolled selects so nothing spills to local memory); the program,
// the leaf pointers and the per-slot rows travel in the launch's parameters
// as a __grid_constant__ table that each block stages in shared memory.
// A block owns one chunk of one shard's words for one slot: count mode adds
// its block sum to out[q, s] (zeroed on the stream first), slab mode writes
// its words.
//
// The entry point returns cudaGetLastError() right after its launches, so
// a launch the card refuses is reported to the caller instead of being
// lost.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLeaves = 16;       // ops/kernels.py MAX_SPEC_LEAVES
constexpr int kMaxDepth = 8;         // ops/kernels.py MAX_SPEC_DEPTH
constexpr int kMaxOps = 32;          // 2 * kMaxLeaves - 1, rounded up
constexpr int kMaxInlineRows = 256;  // ops/kernels.py SPEC_INLINE_ROWS
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 8;  // uint4 words a block
constexpr int kAhead = 4;             // leaf loads in flight a word
constexpr int kMaxSlotsALaunch = 65535;  // gridDim.y

constexpr int kOpAnd = 0x80, kOpOr = 0x81, kOpAndNot = 0x82, kOpXor = 0x83;

struct SpecTable {
  const uint4* base[kMaxLeaves];   // leaf i's words
  long long stride[kMaxLeaves];    // uint4 words from one shard to the next
  int rows[kMaxInlineRows];        // rows[q * n_leaves + i], when they fit
  unsigned char ops[kMaxOps];
  int n_ops;
  int n_leaves;
};
static_assert(sizeof(SpecTable) % 4 == 0, "staged word by word");

__device__ __forceinline__ uint32_t popc4(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint4 combine(int op, const uint4& a, const uint4& b) {
  switch (op) {
    case kOpAnd: return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
    case kOpOr: return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
    case kOpAndNot: return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
    case kOpXor:
    default: return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
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

template <bool kCount>
__global__ void __launch_bounds__(kThreads, 3)
spec_eval_kernel(const __grid_constant__ SpecTable t, const int* __restrict__ rows_dev,
                 int32_t* __restrict__ counts, uint4* __restrict__ slab, int q0,
                 int s_count, int w4, int chunks) {
  __shared__ SpecTable ts;
  __shared__ const uint4* leaf[kMaxLeaves];
  __shared__ uint32_t red[kWarps];
  {
    const int* src = reinterpret_cast<const int*>(&t);
    int* dst = reinterpret_cast<int*>(&ts);
    for (int k = threadIdx.x; k < (int)(sizeof(SpecTable) / 4); k += kThreads) dst[k] = src[k];
  }
  __syncthreads();
  const int q = q0 + blockIdx.y;
  const int s = blockIdx.x / chunks;
  const int c = blockIdx.x - s * chunks;
  const int n_leaves = ts.n_leaves;
  const int n_ops = ts.n_ops;
  if (threadIdx.x < n_leaves) {
    const int i = threadIdx.x;
    const int row = rows_dev != nullptr ? rows_dev[q * n_leaves + i] : ts.rows[q * n_leaves + i];
    leaf[i] = row < 0 ? nullptr : ts.base[i] + (long long)s * ts.stride[i] + (long long)row * w4;
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

}  // namespace

// Plain C entry point, bound with ctypes. bases holds n_leaves device
// pointers (16-byte aligned), strides the uint4 words from one shard to the
// next in each, ops the n_ops program bytes, rows_host the q x n_leaves rows
// (host memory) and rows_dev the same on the device, or null when they fit
// the launch's parameters (q * n_leaves <= 256). mode 0 writes counts
// int32[q, s] (zeroed here first), 1 writes slab int32[q, s, w]; w is a
// multiple of 4. The caller has checked the program and every shape.
extern "C" int spec_eval_launch(const void* bases, const void* strides, const void* ops,
                                int n_ops, int n_leaves, const void* rows_host,
                                const void* rows_dev, void* counts, void* slab, int mode,
                                int q, int s, int w, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_ops < 1 || n_ops > kMaxOps ||
      (rows_dev == nullptr && q * n_leaves > kMaxInlineRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SpecTable t;
  memset(&t, 0, sizeof(t));
  memcpy(t.base, bases, sizeof(void*) * n_leaves);
  memcpy(t.stride, strides, sizeof(long long) * n_leaves);
  memcpy(t.ops, ops, n_ops);
  if (rows_dev == nullptr) memcpy(t.rows, rows_host, sizeof(int) * q * n_leaves);
  t.n_ops = n_ops;
  t.n_leaves = n_leaves;
  const auto st = static_cast<cudaStream_t>(stream);
  const int w4 = w / 4;
  const int chunks = (w4 + kChunk - 1) / kChunk;
  auto* cnt = static_cast<int32_t*>(counts);
  auto* out = static_cast<uint4*>(slab);
  const auto* rd = static_cast<const int*>(rows_dev);
  if (mode == 0) {
    const cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int32_t) * (size_t)q * s, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int q0 = 0; q0 < q; q0 += kMaxSlotsALaunch) {
    const dim3 grid(s * chunks, min(kMaxSlotsALaunch, q - q0));
    if (mode == 0) {
      spec_eval_kernel<true><<<grid, kThreads, 0, st>>>(t, rd, cnt, out, q0, s, w4, chunks);
    } else {
      spec_eval_kernel<false><<<grid, kThreads, 0, st>>>(t, rd, cnt, out, q0, s, w4, chunks);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
