// AND-popcount on Hopper's tensor cores (sm_90a): the pair kernels, per
// shard (K1) and summed over shards (K2), the group-tile kernels, summed
// and filtered (K4) and per shard (K5), and the odometer group-tensor
// kernels, summed and filtered (K6) and per shard (K7), with a rate probe.
//
// Stacks are int32[S, R, W] (W = 32768 words per shard row), the bits of
// the host's uint32 layout. All six kernels compute sums of popcount(x & y)
// over words, which is exactly what the binary tensor-core MMA computes:
//
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//   D[m][n] += sum over 256 bits k of A[m][k] & B[n][k]
//
// with the fragments of the SM80 16x8 layout: lane 4g+t holds A's rows g
// and g+8 at 32-bit words t and t+4 of the 256-bit k-chunk (a0 = row g word
// t, a1 = row g+8 word t, a2 = row g word t+4, a3 = row g+8 word t+4), B's
// row (column of the product) g at words t and t+4, and D's rows g and g+8
// at columns 2t and 2t+1. The fragments are whole packed words, so the
// stacks feed the MMA with no unpacking; and since the product sums over
// k, any assignment of words to k-slots is exact as long as A and B use
// the same one. One MMA is 16 * 8 * 256 = 32768 AND-popcount bit-products.
//
// What bounds them on an H100 SXM: the probe below measured the b1 MMA at
// 5.3e15 bit-products a second, 39 times the CUDA cores' __popc(a & b)
// (1.36e14; chip_smoke.py's probe phase), so the tensor-core work of a
// pair sweep is small beside its bytes (3.35 TB/s): the designs aim at
// reading each word of device memory once or twice, with the MMAs and the
// row popcounts hidden under the loads.
//
// Each entry point returns cudaGetLastError() right after its launch, or
// cudaErrorInvalidValue for arguments the grid cannot take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExtras = 8;  // MAX_GROUP_EXTRAS in ops/kernels.py
constexpr int kMaxGridYZ = 65535;

__device__ __forceinline__ void mma_b1(uint32_t (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t popc4(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint4 and4(const uint4& a, const uint4& b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 16-byte matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register j of lane 4g+t receives word t of
// row g of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The SM count of the current device, asked at every launch (the runtime
// answers from its cached properties), so that each device gets its own.
cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// Word slices of a shard row for the register-direct kernels: enough
// blocks for several waves, each slice at least 1024 words.
int word_slices(int sms, int blocks_per_slice, int w4) {
  const int want = 16 * sms;
  int n = (want + blocks_per_slice - 1) / blocks_per_slice;
  const int most = w4 / 256 > 1 ? w4 / 256 : 1;
  if (n > most) n = most;
  return n < 1 ? 1 : n;
}

// ---------------------------------------------------------------------------
// The rate probe: one block per SM, a register-only loop of one instruction
// kind, accumulators fed back so that nothing is optimised away.
// ---------------------------------------------------------------------------

constexpr int kProbeThreads = 512;
constexpr int kProbeChains = 4;

// MODE 0: m16n8k256 b1 AND-popc MMAs; 1: __popc(a & b) on the CUDA cores.
// Each thread writes one word so that the loop is live.
template <int MODE>
__global__ void __launch_bounds__(kProbeThreads)
probe_kernel(uint32_t* __restrict__ out, int iters) {
  const uint32_t seed = blockIdx.x * kProbeThreads + threadIdx.x;
  uint32_t sink = 0u;
  if (MODE == 1) {
    uint32_t a[8], b[8], acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] = seed * 2654435761u + j;
      b[j] = seed ^ (0x9e3779b9u * (j + 1));
      acc[j] = 0u;
    }
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j] += __popc(a[j] & b[j]);
        a[j] ^= acc[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sink += acc[j];
  } else {
    uint32_t a[4], acc[kProbeChains][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = seed * 2654435761u + j;
    const uint32_t b0 = seed ^ 0x9e3779b9u, b1 = seed ^ 0x7f4a7c15u;
#pragma unroll
    for (int c = 0; c < kProbeChains; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][j] = c + j;
    }
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int c = 0; c < kProbeChains; ++c) mma_b1(acc[c], a[0], a[1], a[2], a[3], b0, b1);
    }
#pragma unroll
    for (int c = 0; c < kProbeChains; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sink += acc[c][j];
    }
  }
  out[seed] = sink;
}

// ---------------------------------------------------------------------------
// K1 and K2's narrow route: m16n8 faces. The main path's 8 x 8 pair (the
// uncached batched Count's K1 at S = 954, the filtered 2-field GroupBy's K2)
// is one m16n8 MMA face, so no tile is staged: lane 4g+t loads 16-byte
// vectors of F rows g and g+8 and G row g of the face straight from device
// memory (neighbouring lanes on neighbouring vectors), and each vector
// feeds two MMAs (words x, y, then z, w). cf and cg are popcounts of the
// same registers on the CUDA cores. Each word is read once; the bytes bound
// the sweep.
//
// A pair past 16 x 8 (K1 only: K2 stages those) is cut into 16 x 8 faces,
// one a block; the faces of one word slice of one shard are neighbours in
// the grid (blockIdx.x = slice * faces + face), so they run together and
// their re-reads of a row come from L2. cf is counted only by the faces of
// the first face column, cg only by those of the first face row, so each
// is counted once.
//
// Block (slice * faces + face, s) sums its word slice of shard s; the
// block's sums are reduced over warps in shared memory and added with one
// atomicAdd per cell into the zeroed output: K2's int32[rf*rg + rf + rg]
// (exact while S * 2^20 < 2^31, the caller's MAX_PAIR_SHARDS bound), or,
// PERSHARD (K1), row s of int32[S, rf*rg + rf + rg] (every cell <= 2^20).
// Blocks that each own a whole shard row and store plainly would need one
// word slice a shard, which leaves the grid too small to fill the card at
// small S; the atomics cost one add a cell and slice.
// ---------------------------------------------------------------------------

template <bool PERSHARD>
__global__ void __launch_bounds__(kThreads)
pair_face_kernel(const uint4* __restrict__ f, const uint4* __restrict__ g,
                 int32_t* __restrict__ out, int rf, int rg, int w4, int slice_w4,
                 int faces, int tiles_b) {
  // K2's face route has one face a launch: its body stays the plain face.
  const int s = blockIdx.y;
  const int slice = PERSHARD ? blockIdx.x / faces : blockIdx.x;
  const int face = PERSHARD ? blockIdx.x - slice * faces : 0;
  const int ta = PERSHARD ? face / tiles_b : 0;
  const int tb = PERSHARD ? face - ta * tiles_b : 0;
  const int a0 = ta * 16;
  const int b0 = tb * 8;
  const bool do_cf = tb == 0;
  const bool do_cg = ta == 0;
  const int v_begin = slice * slice_w4;
  const int v_end = min(v_begin + slice_w4, w4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4* f0 = a0 + gq < rf ? f + ((size_t)s * rf + a0 + gq) * w4 : nullptr;
  const uint4* f1 = a0 + gq + 8 < rf ? f + ((size_t)s * rf + a0 + gq + 8) * w4 : nullptr;
  const uint4* g0 = b0 + gq < rg ? g + ((size_t)s * rg + b0 + gq) * w4 : nullptr;

  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  uint32_t cf0 = 0u, cf1 = 0u, cg0 = 0u;
  // The loop bound is the warp's, so every lane reaches each mma.sync.
#pragma unroll 2
  for (int vs = v_begin + warp * 4; vs < v_end; vs += kWarps * 4) {
    const int v = vs + tq;
    const bool in = v < v_end;
    const uint4 a = in && f0 ? __ldg(f0 + v) : zero;
    const uint4 a8 = in && f1 ? __ldg(f1 + v) : zero;
    const uint4 b = in && g0 ? __ldg(g0 + v) : zero;
    mma_b1(acc, a.x, a8.x, a.y, a8.y, b.x, b.y);
    mma_b1(acc, a.z, a8.z, a.w, a8.w, b.z, b.w);
    if (do_cf) {
      cf0 += popc4(a);
      cf1 += popc4(a8);
    }
    if (do_cg) cg0 += popc4(b);
  }
  // Row counts: the four lanes of a row hold its parts.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    cf0 += __shfl_xor_sync(0xffffffffu, cf0, off);
    cf1 += __shfl_xor_sync(0xffffffffu, cf1, off);
    cg0 += __shfl_xor_sync(0xffffffffu, cg0, off);
  }

  __shared__ uint32_t red[kWarps][32 * 8];
  uint32_t* mine = red[warp] + lane * 8;
  mine[0] = acc[0];
  mine[1] = acc[1];
  mine[2] = acc[2];
  mine[3] = acc[3];
  mine[4] = cf0;
  mine[5] = cf1;
  mine[6] = cg0;
  mine[7] = 0u;
  __syncthreads();

  uint32_t v = 0u;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) v += red[wi][threadIdx.x];
  if (v == 0u) return;
  const int l = threadIdx.x >> 3;
  const int r = threadIdx.x & 7;
  const int g8 = l >> 2;
  const int t4 = l & 3;
  int cell = -1;
  if (r < 4) {
    const int row = a0 + g8 + (r >= 2 ? 8 : 0);
    const int col = b0 + 2 * t4 + (r & 1);
    if (row < rf && col < rg) cell = row * rg + col;
  } else if (t4 == 0) {
    if (r == 4 && a0 + g8 < rf) cell = rf * rg + a0 + g8;
    if (r == 5 && a0 + g8 + 8 < rf) cell = rf * rg + a0 + g8 + 8;
    if (r == 6 && b0 + g8 < rg) cell = rf * rg + rf + b0 + g8;
  }
  int32_t* row_out = PERSHARD ? out + (size_t)s * (rf * rg + rf + rg) : out;
  if (cell >= 0) atomicAdd(row_out + cell, (int32_t)v);
}

// ---------------------------------------------------------------------------
// K2, wide faces: a binary GEMM. Summed over shards, the pair matrix is one
// product C[Rf, Rg] = F[Rf, K] (AND-popc) G[Rg, K] with K = S * W words, so
// shards only lengthen K. Blocks own 128 x 128 tiles of C; 8 warps each own
// 64 x 32 (4 x 4 m16n8 sub-tiles, 64 int32 accumulators a lane). The K axis
// runs in stages of 32 words (4 k-chunks of 256 bits) staged through a ring
// of 4 shared-memory buffers by cp.async (32 KB a stage: 128 rows of F and
// 128 of G, each row 128 bytes); a stage never crosses a shard, and words
// past W or rows past Rf / Rg are zero-filled, so any W that is a multiple
// of 4 and any Rf, Rg >= 1 are exact.
//
// Bank conflicts: a staged row is 8 16-byte chunks, and chunk c of row r
// lies at chunk c ^ (r % 8), so the 8 rows an ldmatrix phase reads cover all
// 32 banks. ldmatrix.x4 then yields the b1 A fragment of an m16 sub-tile
// directly (matrices: rows 0-7 / 8-15 at words 0-3, then at words 4-7), and
// the B fragments of two n8 sub-tiles.
//
// Grid: the K stages are split across blocks so that the grid fills the
// card once (one block an SM: 128 KB of stages), and the tiles of one K
// split are neighbours in the grid (blockIdx = split * tiles + tile), so
// they run together and their second read of a staged row comes from L2:
// each word is read from device memory about once, and from L2 at most
// once more per extra tile along the other side.
//
// cf and cg come from the same fragments, as MMAs against an all-ones
// operand (3 more MMAs a warp and k-chunk beside its 16; popcounting the
// fragments on the CUDA cores instead runs at a 39th of the MMA's rate, and
// was the slower of the two on an H100). A stage's A rows are counted in
// one block of their tile row and its B rows in one block of their tile
// column, taking turns by stage, so
// no block of a split does more than its share; inside a block every warp
// counts a quarter of the A rows it holds (the 4 warps along N hold the
// same A rows) and a half of its B rows (the 2 warps along M hold the
// same B rows). Every cell of C is added once per block with atomicAdd
// into the zeroed output (zero sums are skipped).
// ---------------------------------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBKW = 32;             // words of a row in one stage
constexpr int kRowBytes = kBKW * 4;  // 128
constexpr int kChunks = kBKW / 4;    // 16-byte chunks of a staged row
constexpr int kLoadsPerSide = kBM * kChunks / kThreads;
constexpr int kStages = 4;
constexpr int kStageBytes = (kBM + kBN) * kRowBytes;  // 32 KB
static_assert(kBM == kBN, "load_stage stages F and G rows alike");
constexpr int kGemmSmem = kStages * kStageBytes;       // 128 KB

__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

__global__ void __launch_bounds__(kThreads, 1)
pair_gemm_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ g,
                 int32_t* __restrict__ out, int rf, int rg, int w, int tiles_n,
                 int n_tiles, int k_stages, int per_split) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tile = blockIdx.x % n_tiles;
  const int split = blockIdx.x / n_tiles;
  const int tm = tile / tiles_n;
  const int tn = tile - tm * tiles_n;
  const int m0 = tm * kBM;
  const int n0 = tn * kBN;
  const int k_begin = split * per_split;
  const int n_k = min(per_split, k_stages - k_begin);
  if (n_k <= 0) return;
  const int tw = (w + kBKW - 1) / kBKW;  // stages per shard
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;  // 2 warps along M
  const int wn = warp & 3;   // 4 warps along N
  const int tiles_m = n_tiles / tiles_n;
  const uint32_t base = smem_addr(smem);

  // Stage k -> buffer buf: the chunks of F's rows, then G's, neighbouring
  // threads on neighbouring chunks of one row segment.
  auto load_stage = [&](int k, int buf) {
    const int s = k / tw;
    const int word0 = (k - s * tw) * kBKW;
    const uint32_t sb = base + buf * kStageBytes;
#pragma unroll
    for (int i = 0; i < kLoadsPerSide * 2; ++i) {
      const bool is_g = i >= kLoadsPerSide;
      const int c = threadIdx.x + (i % kLoadsPerSide) * kThreads;
      const int row = c / kChunks;
      const int ch = c % kChunks;
      const int word = word0 + ch * 4;
      const int nrows = is_g ? rg : rf;
      const int grow = (is_g ? n0 : m0) + row;
      const bool valid = grow < nrows && word < w;
      const uint32_t* src = is_g ? g : f;
      if (valid) src += ((size_t)s * nrows + grow) * w + word;
      cp_async16(sb + (is_g ? kBM * kRowBytes : 0) + swz(row, ch), src, valid);
    }
  };

  uint32_t acc[4][4][4];
  uint32_t cfa[4] = {0u, 0u, 0u, 0u};  // A sub-tile wn against all-ones
  uint32_t cga[2][4];                  // all-ones against B sub-tiles 2 wm, 2 wm + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) cga[h][0] = cga[h][1] = cga[h][2] = cga[h][3] = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0u;
    }
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k) load_stage(k_begin + st, st);
    cp_async_commit();
  }

  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1's buffer is free
    const int nxt = it + kStages - 1;
    if (nxt < n_k) load_stage(k_begin + nxt, nxt % kStages);
    cp_async_commit();

    // Stage `it` of this split counts its A rows' popcounts in the block of
    // tile column it % tiles_n, its B rows' in the block of tile row
    // it % tiles_m: each once, spread over the split's blocks.
    const bool do_cf = it % tiles_n == tn;
    const bool do_cg = it % tiles_m == tm;
    const uint32_t a_base = base + (it % kStages) * kStageBytes;
    const uint32_t b_base = a_base + kBM * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < kBKW / 8; ++kk) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(af[i], a_base + swz(row, 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int mi = lane >> 3;
        const int row = wn * 32 + j * 8 + (mi >> 1) * 8 + (lane & 7);
        uint32_t r[4];
        ldmatrix_x4(r, b_base + swz(row, 2 * kk + (mi & 1)));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_b1(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j][0], bf[j][1]);
        }
      }
      // The row popcounts as MMAs against an all-ones operand, spread
      // evenly: the 4 warps of one wm hold the same A rows and each counts
      // one of its 4 sub-tiles; the 2 warps of one wn hold the same B rows
      // and each counts two of its 4.
      if (do_cf) {
        uint32_t x[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) x[r] = af[0][r];
#pragma unroll
        for (int i = 1; i < 4; ++i) {
#pragma unroll
          for (int r = 0; r < 4; ++r) x[r] = i == wn ? af[i][r] : x[r];
        }
        mma_b1(cfa, x[0], x[1], x[2], x[3], ~0u, ~0u);
      }
      if (do_cg) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t y0 = wm ? bf[2 + h][0] : bf[h][0];
          const uint32_t y1 = wm ? bf[2 + h][1] : bf[h][1];
          mma_b1(cga[h], ~0u, ~0u, ~0u, ~0u, y0, y1);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g8 = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + wm * 64 + i * 16 + g8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rr = row + (r >= 2 ? 8 : 0);
        const int cc = col + (r & 1);
        const uint32_t v = acc[i][j][r];
        if (v != 0u && rr < rf && cc < rg) atomicAdd(out + (size_t)rr * rg + cc, (int32_t)v);
      }
    }
  }
  // Every column of cfa holds its row's count (lanes t = 0 write rows g and
  // g+8), every row of cga its column's (lanes g = 0 write columns 2t, 2t+1).
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = cfa[2 * h];
      const int row = m0 + wm * 64 + wn * 16 + g8 + 8 * h;
      if (v != 0u && row < rf) atomicAdd(out + (size_t)rf * rg + row, (int32_t)v);
    }
  }
  if (g8 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t v = cga[h][c];
        const int col = n0 + wn * 32 + (2 * wm + h) * 8 + 2 * t4 + c;
        if (v != 0u && col < rg) atomicAdd(out + (size_t)rf * rg + rf + col, (int32_t)v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4 to K7: the group tensor, summed over shards with an optional filter
// (K4, K6), or per shard and unfiltered (K5, K7: PERSHARD), slot pairs
// stacked along M. For slots q, q+1 of a launch, one m16n8k256 MMA
// computes both slots' 8 x 8 faces:
//
//   A rows 0-7  = F[a] & m_q,   A rows 8-15 = F[a] & m_{q+1},   B = G[b],
//   m_q = H1[r1(q)] & ... & HE[rE(q)] [& filt]
//
// K4 and K5 read each slot's rows r_e(q) from a device slot table
// (rows_idx int32[T, E], active int32[T]). K6 and K7 (ODOMETER) run the
// whole odometer, K slots for K the product of the extras' heights, and
// decode slot q's rows from q itself, last extra fastest: no table is
// uploaded and every q < K is live. They replace the TPU's Pallas kernels nary_stats
// (K6, pilosa_tpu/ops/kernels.py:253) and nary_stats_pershard (K7, :349),
// which carry the shard sum in VMEM across a sequential grid; here the
// shard axis is a grid axis and the sum goes through atomicAdd.
//
// The odometer's prefix (HOIST): when the last extra's height is a multiple
// of the 8 slots a block holds, the block's slots share every other extra's
// row and differ only in the last extra's, which are 8 consecutive rows. So
// F & H1 & ... & H_{E-1} [& filt] is formed once a vector, and each slot
// loads one word of its last-extra row. A one-extra odometer has no extra
// row to hoist, only the filter, and keeps the per-slot body.
//
// Lane 4g+t loads 16-byte vectors of F row g and G row g, and the slots'
// mask words, which are the same for every g (a broadcast load); four ANDs
// form the A registers of two MMAs per vector. A block owns 4 slot pairs
// (8 slots) of one shard's word slice and one 8 x 8 tile of (a, b), so F
// and G are loaded once for the 8 slots; the slot groups of a shard are
// neighbours in the grid, so more than 8 slots re-read F and G from L2. An
// odd slot count pairs the last slot with a zero mask; an inactive slot's
// mask is zero and its cells are not written; Rf or Rg above 8 take more
// tiles. Sums go once per block and cell into the zeroed output with
// atomicAdd: K4's int32[T, Rf, Rg] and K6's int32[K, Rf, Rg] (exact while
// S * 2^20 < 2^31), or K5's int32[T, S, Rf, Rg] and K7's int32[K, S, Rf,
// Rg] at cell ((q * S + s) * Rf + a) * Rg + b, where only the word slices
// of one shard meet (every cell <= 2^20).
// ---------------------------------------------------------------------------

constexpr int kGroupSlots = 8;
constexpr int kGroupPairs = kGroupSlots / 2;

struct ExtraTable {
  const uint4* base[kMaxExtras];
  int rows[kMaxExtras];
  int n;
};

// At most 64 registers a thread, so 4 blocks (32 warps) fit an SM and keep
// enough loads in flight.
template <bool FILTERED, bool PERSHARD, bool ODOMETER, bool HOIST>
__global__ void __launch_bounds__(kThreads, 4)
group_pair_kernel(const uint4* __restrict__ f, const uint4* __restrict__ g,
                  const ExtraTable ex, const int32_t* __restrict__ rows_idx,
                  const int32_t* __restrict__ active, const uint4* __restrict__ filt,
                  int32_t* __restrict__ out, int n_slots, int n_shards, int rf, int rg,
                  int w4, int slice_w4, int n_slices, int tiles_b) {
  const int q0 = blockIdx.x * kGroupSlots;
  const int s = blockIdx.y / n_slices;
  const int slice = blockIdx.y - s * n_slices;
  const int ta = blockIdx.z / tiles_b;
  const int tb = blockIdx.z - ta * tiles_b;
  const int a0 = ta * 8;
  const int b0 = tb * 8;
  const int n_extra = ex.n;
  static_assert(ODOMETER || !HOIST, "only the odometer has a prefix to hoist");

  __shared__ const uint4* hp[kGroupSlots][kMaxExtras];
  __shared__ int live[kGroupSlots];
  if (threadIdx.x < kGroupSlots) {
    const int j = threadIdx.x;
    const int q = q0 + j;
    if constexpr (ODOMETER) {
      const int on = q < n_slots;
      live[j] = on;
      int rem = q;
      for (int e = n_extra - 1; e >= 0; --e) {
        const int height = ex.rows[e];
        const int row = rem % height;
        rem /= height;
        hp[j][e] = on ? ex.base[e] + ((size_t)s * height + row) * w4 : nullptr;
      }
    } else {
      const int on = q < n_slots && active[q] != 0;
      live[j] = on;
      for (int e = 0; e < n_extra; ++e) {
        hp[j][e] = on ? ex.base[e] + ((size_t)s * ex.rows[e] + rows_idx[(size_t)q * n_extra + e]) * w4
                      : nullptr;
      }
    }
  }
  __syncthreads();
  bool slot_on[kGroupSlots];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kGroupSlots; ++j) {
    slot_on[j] = live[j] != 0;
    any = any || slot_on[j];
  }
  if (!any) return;  // the whole block leaves

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4* fr = a0 + gq < rf ? f + ((size_t)s * rf + a0 + gq) * w4 : nullptr;
  const uint4* gr = b0 + gq < rg ? g + ((size_t)s * rg + b0 + gq) * w4 : nullptr;
  const uint4* ms = FILTERED ? filt + (size_t)s * w4 : nullptr;
  const int v_begin = slice * slice_w4;
  const int v_end = min(v_begin + slice_w4, w4);
  // HOIST: slot j's last-extra row is row j past slot 0's.
  const uint4* last = HOIST ? hp[0][n_extra - 1] : nullptr;

  uint32_t acc[kGroupPairs][4];
#pragma unroll
  for (int p = 0; p < kGroupPairs; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0u;

  for (int vs = v_begin + warp * 4; vs < v_end; vs += kWarps * 4) {
    const int v = vs + tq;
    const bool in = v < v_end;
    const uint4 a = in && fr ? __ldg(fr + v) : zero;
    const uint4 b = in && gr ? __ldg(gr + v) : zero;
    const uint4 flt = FILTERED && in ? __ldg(ms + v) : zero;
    uint4 pre = a;  // F [& the hoisted prefix]
    if constexpr (HOIST) {
      for (int e = 0; e + 1 < n_extra; ++e) pre = and4(pre, in ? __ldg(hp[0][e] + v) : zero);
      if (FILTERED) pre = and4(pre, flt);
    }
#pragma unroll
    for (int p = 0; p < kGroupPairs; ++p) {
      if (!(slot_on[2 * p] || slot_on[2 * p + 1])) continue;  // uniform
      uint4 m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * p + h;
        m[h] = zero;
        if constexpr (HOIST) {
          if (in) m[h] = __ldg(last + (size_t)j * w4 + v);
        } else if (slot_on[j] && in) {
          m[h] = __ldg(hp[j][0] + v);
          for (int e = 1; e < n_extra; ++e) m[h] = and4(m[h], __ldg(hp[j][e] + v));
          if (FILTERED) m[h] = and4(m[h], flt);
        }
      }
      const uint4 x = and4(pre, m[0]);
      const uint4 y = and4(pre, m[1]);
      mma_b1(acc[p], x.x, y.x, x.y, y.y, b.x, b.y);
      mma_b1(acc[p], x.z, y.z, x.w, y.w, b.z, b.w);
    }
  }

  // Reduce over warps: entry (p, lane, r) at p * 128 + lane * 4 + r.
  __shared__ uint32_t red[kWarps][kGroupPairs * 128];
#pragma unroll
  for (int p = 0; p < kGroupPairs; ++p) {
#pragma unroll
    for (int r = 0; r < 4; ++r) red[warp][p * 128 + lane * 4 + r] = acc[p][r];
  }
  __syncthreads();
  const size_t face = (size_t)rf * rg;
  for (int k = threadIdx.x; k < kGroupPairs * 128; k += kThreads) {
    uint32_t v = 0u;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[wi][k];
    const int p = k >> 7;
    const int l = (k >> 2) & 31;
    const int r = k & 3;
    const int row = (l >> 2) + (r >= 2 ? 8 : 0);  // D row: slot half, F row
    const int j = 2 * p + (row >> 3);
    const int a = a0 + (row & 7);
    const int b = b0 + 2 * (l & 3) + (r & 1);
    if (v != 0u && live[j] && a < rf && b < rg) {
      const size_t slot = PERSHARD ? (size_t)(q0 + j) * n_shards + s : (size_t)(q0 + j);
      atomicAdd(out + slot * face + (size_t)a * rg + b, (int32_t)v);
    }
  }
}

// The face grid of K1 and K2's narrow route: (slices * faces, s), enough
// word slices to fill the card several times over.
template <bool PERSHARD>
int face_launch(const void* f, const void* g, void* out, int s, int rf, int rg, int w,
                int sms, cudaStream_t st) {
  if (s > kMaxGridYZ) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_b = (rg + 7) / 8;
  const int faces = ((rf + 15) / 16) * tiles_b;
  const int w4 = w / 4;
  const int slices = word_slices(sms, s * faces, w4);
  const int slice_w4 = (w4 + slices - 1) / slices;
  const dim3 grid(((w4 + slice_w4 - 1) / slice_w4) * faces, s);
  pair_face_kernel<PERSHARD><<<grid, kThreads, 0, st>>>(
      static_cast<const uint4*>(f), static_cast<const uint4*>(g),
      static_cast<int32_t*>(out), rf, rg, w4, slice_w4, faces, tiles_b);
  return static_cast<int>(cudaGetLastError());
}

template <bool ODOMETER, bool HOIST>
void group_pair_grid(const dim3& grid, cudaStream_t st, bool pershard, const uint4* fv,
                     const uint4* gv, const ExtraTable& ex, const int32_t* ri,
                     const int32_t* ac, const uint4* fl, int32_t* o, int n_slots, int s,
                     int rf, int rg, int w4, int slice_w4, int slices, int tiles_b) {
  if (pershard) {
    group_pair_kernel<false, true, ODOMETER, HOIST><<<grid, kThreads, 0, st>>>(
        fv, gv, ex, ri, ac, nullptr, o, n_slots, s, rf, rg, w4, slice_w4, slices, tiles_b);
  } else if (fl) {
    group_pair_kernel<true, false, ODOMETER, HOIST><<<grid, kThreads, 0, st>>>(
        fv, gv, ex, ri, ac, fl, o, n_slots, s, rf, rg, w4, slice_w4, slices, tiles_b);
  } else {
    group_pair_kernel<false, false, ODOMETER, HOIST><<<grid, kThreads, 0, st>>>(
        fv, gv, ex, ri, ac, nullptr, o, n_slots, s, rf, rg, w4, slice_w4, slices, tiles_b);
  }
}

// K4 and K6 (summed, filt optional), K5 and K7 (pershard, filt null): grid
// (slot groups, s * word slices, 8 x 8 tiles), the slot groups fastest.
// The odometer kernels (K6, K7) read no slot table: rows_idx and active
// may be null; they hoist the prefix when the last of two or more extras'
// height is a multiple of the block's slots.
int group_pair_launch(bool pershard, bool odometer, const void* f, const void* g,
                      const void* const* ptrs, const int* heights, int n_extra,
                      const void* rows_idx, const void* active, const void* filt,
                      void* out, int s, int rf, int rg, int w, int n_slots,
                      void* stream) {
  const int tiles_a = (rf + 7) / 8;
  const int tiles_b = (rg + 7) / 8;
  const int groups = (n_slots + kGroupSlots - 1) / kGroupSlots;
  if (n_extra < 1 || n_extra > kMaxExtras || n_slots < 1 || s < 1 || rf < 1 ||
      rg < 1 || w < 4 || w % 4 || s > kMaxGridYZ || tiles_a * tiles_b > kMaxGridYZ ||
      (!odometer && (!rows_idx || !active)) || (pershard && filt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ExtraTable ex;
  for (int e = 0; e < kMaxExtras; ++e) {
    ex.base[e] = e < n_extra ? static_cast<const uint4*>(ptrs[e]) : nullptr;
    ex.rows[e] = e < n_extra ? heights[e] : 0;
    if (e < n_extra && heights[e] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  ex.n = n_extra;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int w4 = w / 4;
  int slices = word_slices(sms, groups * s * tiles_a * tiles_b, w4);
  while (slices > 1 && (long long)s * slices > kMaxGridYZ) --slices;
  const int slice_w4 = (w4 + slices - 1) / slices;
  slices = (w4 + slice_w4 - 1) / slice_w4;
  const dim3 grid(groups, s * slices, tiles_a * tiles_b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* fv = static_cast<const uint4*>(f);
  const uint4* gv = static_cast<const uint4*>(g);
  const int32_t* ri = static_cast<const int32_t*>(rows_idx);
  const int32_t* ac = static_cast<const int32_t*>(active);
  const uint4* fl = static_cast<const uint4*>(filt);
  int32_t* o = static_cast<int32_t*>(out);
  if (!odometer) {
    group_pair_grid<false, false>(grid, st, pershard, fv, gv, ex, ri, ac, fl, o, n_slots, s,
                                  rf, rg, w4, slice_w4, slices, tiles_b);
  } else if (n_extra > 1 && heights[n_extra - 1] % kGroupSlots == 0) {
    group_pair_grid<true, true>(grid, st, pershard, fv, gv, ex, ri, ac, fl, o, n_slots, s,
                                rf, rg, w4, slice_w4, slices, tiles_b);
  } else {
    group_pair_grid<true, false>(grid, st, pershard, fv, gv, ex, ri, ac, fl, o, n_slots, s,
                                 rf, rg, w4, slice_w4, slices, tiles_b);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are 16-byte aligned,
// w is a multiple of 4, and the caller has checked every shape.

// The rate probe. mode 0: b1 AND-popc MMA, 1: CUDA-core popcount.
// out uint32[blocks * 512]. Work per launch, in bit-products:
//   mode 0: blocks * 16 warps * iters * 4 chains * 16*8*256;
//   mode 1: blocks * 512 threads * iters * 8 words * 32.
extern "C" int and_popc_probe_launch(int mode, int iters, void* out, int blocks,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (mode == 0) {
    probe_kernel<0><<<blocks, kProbeThreads, 0, st>>>(o, iters);
  } else if (mode == 1) {
    probe_kernel<1><<<blocks, kProbeThreads, 0, st>>>(o, iters);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1: f int32[s, rf, w], g int32[s, rg, w] -> out int32[s, rf*rg + rf + rg],
// zeroed by the caller on the same stream; the face kernel at any Rf, Rg.
extern "C" int pair_stats_pershard_launch(const void* f, const void* g, void* out, int s,
                                          int rf, int rg, int w, void* stream) {
  if (s < 1 || rf < 1 || rg < 1 || w < 4 || w % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  return face_launch<true>(f, g, out, s, rf, rg, w, sms, static_cast<cudaStream_t>(stream));
}

// K2: f int32[s, rf, w], g int32[s, rg, w] -> out int32[rf*rg + rf + rg],
// summed over shards into the zeroed out. Rf <= 16 and Rg <= 8 take the
// register-direct face kernel, larger pairs the staged binary GEMM.
extern "C" int pair_stats_launch(const void* f, const void* g, void* out, int s,
                                 int rf, int rg, int w, void* stream) {
  if (s < 1 || rf < 1 || rg < 1 || w < 4 || w % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (rf <= 16 && rg <= 8) return face_launch<false>(f, g, out, s, rf, rg, w, sms, st);
  // Set on every launch: the attribute belongs to the current device.
  e = cudaFuncSetAttribute(pair_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kGemmSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_m = (rf + kBM - 1) / kBM;
  const int tiles_n = (rg + kBN - 1) / kBN;
  const int n_tiles = tiles_m * tiles_n;
  const int k_stages = s * ((w + kBKW - 1) / kBKW);
  int splits = sms / n_tiles;
  if (splits < 1) splits = 1;
  if (splits > k_stages) splits = k_stages;
  const int per_split = (k_stages + splits - 1) / splits;
  splits = (k_stages + per_split - 1) / per_split;
  pair_gemm_kernel<<<splits * n_tiles, kThreads, kGemmSmem, st>>>(
      static_cast<const uint32_t*>(f), static_cast<const uint32_t*>(g),
      static_cast<int32_t*>(out), rf, rg, w, tiles_n, n_tiles, k_stages, per_split);
  return static_cast<int>(cudaGetLastError());
}

// K4 to K7: f int32[s, rf, w], g int32[s, rg, w]; ptrs / heights: host
// arrays of n_extra (<= 8) extra stacks int32[s, heights[e], w]; out zeroed
// by the caller on the same stream. K4 and K5 take rows_idx int32[T,
// n_extra] and active int32[T] on the device; K6 and K7 read neither (the
// odometer names each slot's rows), and n_slots = K, the product of the
// heights.

// K4: filt int32[s, w] or null; out int32[T, rf, rg], summed over shards.
extern "C" int group_tile_stats_launch(
    const void* f, const void* g, const void* const* ptrs, const int* heights,
    int n_extra, const void* rows_idx, const void* active, const void* filt,
    void* out, int s, int rf, int rg, int w, int n_slots, void* stream) {
  return group_pair_launch(false, false, f, g, ptrs, heights, n_extra, rows_idx, active,
                           filt, out, s, rf, rg, w, n_slots, stream);
}

// K5: filt null; out int32[T, s, rf, rg].
extern "C" int group_tile_stats_pershard_launch(
    const void* f, const void* g, const void* const* ptrs, const int* heights,
    int n_extra, const void* rows_idx, const void* active, const void* filt,
    void* out, int s, int rf, int rg, int w, int n_slots, void* stream) {
  return group_pair_launch(true, false, f, g, ptrs, heights, n_extra, rows_idx, active,
                           filt, out, s, rf, rg, w, n_slots, stream);
}

// K6: filt int32[s, w] or null; out int32[K, rf, rg], summed over shards.
extern "C" int nary_stats_launch(
    const void* f, const void* g, const void* const* ptrs, const int* heights,
    int n_extra, const void* rows_idx, const void* active, const void* filt,
    void* out, int s, int rf, int rg, int w, int n_slots, void* stream) {
  return group_pair_launch(false, true, f, g, ptrs, heights, n_extra, rows_idx, active,
                           filt, out, s, rf, rg, w, n_slots, stream);
}

// K7: filt null; out int32[K, s, rf, rg].
extern "C" int nary_stats_pershard_launch(
    const void* f, const void* g, const void* const* ptrs, const int* heights,
    int n_extra, const void* rows_idx, const void* active, const void* filt,
    void* out, int s, int rf, int rg, int w, int n_slots, void* stream) {
  return group_pair_launch(true, true, f, g, ptrs, heights, n_extra, rows_idx, active,
                           filt, out, s, rf, rg, w, n_slots, stream);
}
