// Native helpers for pilosa_tpu_torch: FNV hashing for the op-log checksum and
// shard partitioning, plus hot byte-level utilities that are slow in pure
// Python. Compiled to a shared library loaded via ctypes
// (pilosa_tpu_torch/native/__init__.py); every entry point has a pure-Python
// fallback so the framework still runs without a C++ toolchain.
//
// Reference behavior mirrored:
//  - fnv32a: op record checksum (reference roaring/roaring.go op.WriteTo)
//  - fnv64a: shard->partition hash (reference cluster.go:871-880)
#include <cstdint>
#include <cstddef>
#include <cstdlib>
#include <cstring>

extern "C" {

uint32_t pilosa_fnv32a(const uint8_t* data, size_t n, uint32_t h) {
    for (size_t i = 0; i < n; i++) {
        h ^= (uint32_t)data[i];
        h *= 16777619u;
    }
    return h;
}

uint64_t pilosa_fnv64a(const uint8_t* data, size_t n, uint64_t h) {
    for (size_t i = 0; i < n; i++) {
        h ^= (uint64_t)data[i];
        h *= 1099511628211ULL;
    }
    return h;
}

// xxhash64 (used for fragment block checksums, reference fragment.go:2814
// blockHasher uses cespare/xxhash). Independent implementation from the
// public algorithm spec.
static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

static const uint64_t PRIME1 = 11400714785074694791ULL;
static const uint64_t PRIME2 = 14029467366897019727ULL;
static const uint64_t PRIME3 = 1609587929392839161ULL;
static const uint64_t PRIME4 = 9650029242287828579ULL;
static const uint64_t PRIME5 = 2870177450012600261ULL;

static inline uint64_t read64(const uint8_t* p) {
    uint64_t v;
    __builtin_memcpy(&v, p, 8);
    return v;
}
static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    __builtin_memcpy(&v, p, 4);
    return v;
}

uint64_t pilosa_xxhash64(const uint8_t* data, size_t n, uint64_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + PRIME1 + PRIME2;
        uint64_t v2 = seed + PRIME2;
        uint64_t v3 = seed;
        uint64_t v4 = seed - PRIME1;
        const uint8_t* limit = end - 32;
        do {
            v1 = rotl64(v1 + read64(p) * PRIME2, 31) * PRIME1; p += 8;
            v2 = rotl64(v2 + read64(p) * PRIME2, 31) * PRIME1; p += 8;
            v3 = rotl64(v3 + read64(p) * PRIME2, 31) * PRIME1; p += 8;
            v4 = rotl64(v4 + read64(p) * PRIME2, 31) * PRIME1; p += 8;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        v1 = rotl64(v1 * PRIME2, 31) * PRIME1; h ^= v1; h = h * PRIME1 + PRIME4;
        v2 = rotl64(v2 * PRIME2, 31) * PRIME1; h ^= v2; h = h * PRIME1 + PRIME4;
        v3 = rotl64(v3 * PRIME2, 31) * PRIME1; h ^= v3; h = h * PRIME1 + PRIME4;
        v4 = rotl64(v4 * PRIME2, 31) * PRIME1; h ^= v4; h = h * PRIME1 + PRIME4;
    } else {
        h = seed + PRIME5;
    }
    h += (uint64_t)n;
    while (p + 8 <= end) {
        uint64_t k = rotl64(read64(p) * PRIME2, 31) * PRIME1;
        h = rotl64(h ^ k, 27) * PRIME1 + PRIME4;
        p += 8;
    }
    if (p + 4 <= end) {
        h = rotl64(h ^ ((uint64_t)read32(p) * PRIME1), 23) * PRIME2 + PRIME3;
        p += 4;
    }
    while (p < end) {
        h = rotl64(h ^ ((uint64_t)(*p) * PRIME5), 11) * PRIME1;
        p++;
    }
    h ^= h >> 33;
    h *= PRIME2;
    h ^= h >> 29;
    h *= PRIME3;
    h ^= h >> 32;
    return h;
}

// Scatter sorted uint16 bit positions of one roaring array container
// into a dense uint32 word vector (the HBM pack hot loop,
// pilosa_tpu_torch/ops/blocks.py _scatter_container). Python's fallback is
// np.bitwise_or.at, an unbuffered ufunc ~50x slower than this loop.
void pilosa_scatter_positions(uint32_t* words, size_t base_word,
                              const uint16_t* pos, size_t n) {
    for (size_t i = 0; i < n; i++) {
        uint16_t p = pos[i];
        words[base_word + (p >> 5)] |= (1u << (p & 31u));
    }
}

// Batched sorted-merge intersection count over K array-container pairs
// (reference roaring.IntersectionCount / intersectionCountArrayArray,
// roaring/roaring.go:570). Containers arrive concatenated with K+1
// offsets. One branch-light galloping-free merge per pair: ~O(n+m)
// with no 64 KiB table fill — the numpy membership-mask path costs
// ~18 us per pair in Python; this whole-row call replaces ~16 of those
// with one ctypes hop.
long long pilosa_intersection_count_many(const uint16_t* a, const long long* aoff,
                                         const uint16_t* b, const long long* boff,
                                         size_t k) {
    // Bitset probe instead of a two-pointer merge: the merge's three
    // data-dependent pointer updates serialize at the CPU's dependency
    // latency (~80 ns/step measured on the virtualized host), while the
    // fill and probe loops below are independent stores/loads that
    // pipeline. 8 KiB bitset stays L1-resident across pairs.
    uint64_t bits[1024];
    long long total = 0;
    for (size_t i = 0; i < k; i++) {
        const uint16_t* pb = b + boff[i];
        const uint16_t* eb = b + boff[i + 1];
        const uint16_t* pa = a + aoff[i];
        const uint16_t* ea = a + aoff[i + 1];
        __builtin_memset(bits, 0, sizeof(bits));
        for (; pb < eb; pb++) {
            bits[*pb >> 6] |= 1ull << (*pb & 63u);
        }
        for (; pa < ea; pa++) {
            total += (bits[*pa >> 6] >> (*pa & 63u)) & 1ull;
        }
    }
    return total;
}

// One 8 KiB container bitset -> sorted uint16 positions appended at
// `out`; returns the count. Shared by all three dedupe paths so the
// ctz pop loop has exactly one copy to maintain.
static inline size_t extract_bitset(const uint64_t* bs, uint16_t* out) {
    size_t wrote = 0;
    for (uint32_t w = 0; w < 1024; w++) {
        uint64_t word = bs[w];
        while (word) {
            uint32_t tz = (uint32_t)__builtin_ctzll(word);
            out[wrote++] = (uint16_t)((w << 6) | tz);
            word &= word - 1;
        }
    }
    return wrote;
}

// Container-granular bulk import (the ImportRoaringBits shape,
// reference roaring/roaring.go:1511 — bits group by container key and
// merge at container level instead of value-at-a-time): from one
// shard's (row, col) pairs, produce per-container SORTED UNIQUE low
// bits in one pass — a counting sort over container keys followed by an
// 8 KiB-bitset dedupe per container (O(n + containers); no comparison
// sort anywhere). numpy's np.unique comparison sort was the import
// bottleneck (~70 M bits/s for the sort alone on one core).
//
// Outputs: out_keys/out_counts (one entry per non-empty container, keys
// ascending) and out_lows (each container's sorted unique lows,
// concatenated; caller sizes it to n). Returns the number of container
// groups, -1 when a key exceeds key_cap (caller falls back to the
// comparison-sort path — rows too tall for the counting table), -2 on
// allocation failure.
}  // extern "C" — the import body is a template (uint64/uint32 column
   // streams share one implementation), which needs C++ linkage.

// COL = uint64_t for global column ids, uint32_t for the narrow wire
// (global ids fit 32 bits up to 4096 shards; halving the column stream
// cut the measured import time — the input load is the bound).
template <typename ROW, typename COL>
static long long import_containers_impl(
    const ROW* rows, const COL* cols, size_t n,
    uint32_t shard_width_exp, size_t key_cap, uint32_t* out_keys,
    uint32_t* out_counts, uint16_t* out_lows) {
    if (n == 0) return 0;
    const uint64_t col_mask = (1ULL << shard_width_exp) - 1;
    const uint32_t key_shift = shard_width_exp - 16;
    // Reusable scratch (grown on demand, zeroed cursor maintained by
    // clearing only touched keys below): the bulk loader calls this once
    // per shard, so per-call malloc/calloc was measurable.
    static thread_local uint16_t* bucket = nullptr;
    static thread_local size_t scratch_n = 0;
    static thread_local uint32_t* cursor = nullptr;
    static thread_local size_t cursor_cap = 0;
    static thread_local uint64_t* slabs = nullptr;
    static thread_local size_t slab_cap = 0;
    if (cursor_cap < key_cap) {
        free(cursor);
        cursor = (uint32_t*)calloc(key_cap, sizeof(uint32_t));
        cursor_cap = cursor ? key_cap : 0;
        if (!cursor_cap) return -2;
    }
    // Single-pass fast path: scatter bits directly into per-KEY
    // bitsets, zeroing the slab region lazily as the max key grows —
    // the 16 B/item input streams through ONCE instead of the
    // count-then-scatter double read (the input load was the measured
    // bound). Falls through to the two-pass paths when the key range
    // exceeds the slab cap (tall imports) or on alloc failure; the
    // cursor table is untouched here, so the invariant holds.
    const size_t kMaxSlabSlots = 512;
    if (key_cap >= kMaxSlabSlots) {
        if (slab_cap < kMaxSlabSlots * 1024) {
            free(slabs);
            slabs = (uint64_t*)malloc(kMaxSlabSlots * 1024 * sizeof(uint64_t));
            slab_cap = slabs ? kMaxSlabSlots * 1024 : 0;
        }
        if (slab_cap) {
            uint64_t zeroed = 0;  // slab slots [0, zeroed) are zero
            int tall = 0;
            for (size_t i = 0; i < n; i++) {
                uint64_t local = cols[i] & col_mask;
                uint64_t key = (((uint64_t)rows[i]) << key_shift) + (local >> 16);
                if (key >= kMaxSlabSlots) { tall = 1; break; }
                if (key >= zeroed) {
                    memset(slabs + (zeroed << 10), 0,
                           (size_t)(key + 1 - zeroed) * 8192);
                    zeroed = key + 1;
                }
                slabs[(key << 10) | ((local & 0xFFFFu) >> 6)] |=
                    1ULL << (local & 63u);
            }
            if (!tall) {
                size_t nk = 0, lo = 0;
                for (uint64_t k = 0; k < zeroed; k++) {
                    size_t wrote = extract_bitset(slabs + (k << 10), out_lows + lo);
                    lo += wrote;
                    if (wrote) {
                        out_keys[nk] = (uint32_t)k;
                        out_counts[nk] = (uint32_t)wrote;
                        nk++;
                    }
                }
                return (long long)nk;
            }
        }
    }
    // Pass 1: count per container key (kept store-free: key/low are
    // recomputed in pass 2 — rescanning 16 B/item beats materializing
    // and re-reading 6 B/item of key+low temporaries on this host).
    // maxk bounds every later table walk: the collect/prefix/reset
    // loops over the full 2^16 table dominated low-row imports.
    size_t bad = 0;
    uint64_t maxk = 0;
    for (size_t i = 0; i < n; i++) {
        uint64_t key = (((uint64_t)rows[i]) << key_shift) + ((cols[i] & col_mask) >> 16);
        if (key >= key_cap) { bad = i + 1; break; }
        maxk = key > maxk ? key : maxk;
        cursor[key]++;
    }
    if (bad) {
        for (size_t i = 0; i < bad; i++) {
            uint64_t key = (((uint64_t)rows[i]) << key_shift) + ((cols[i] & col_mask) >> 16);
            if (key < key_cap) cursor[key] = 0;
        }
        return -1;
    }
    size_t nk = 0;
    for (size_t k = 0; k <= maxk; k++) {
        if (cursor[k]) out_keys[nk++] = (uint32_t)k;
    }
    // Two-pass direct-bitset dedupe (keys beyond the single-pass range
    // but few DISTINCT containers): one 8 KiB bitset per container via
    // a compacted key->slot map. Taller imports take the bucket path.
    if (nk <= kMaxSlabSlots) {
        if (slab_cap < nk * 1024) {
            free(slabs);
            slabs = (uint64_t*)malloc(kMaxSlabSlots * 1024 * sizeof(uint64_t));
            slab_cap = slabs ? kMaxSlabSlots * 1024 : 0;
            if (!slab_cap) {
                // Restore the zero-cursor invariant: pass 1 already
                // counted into it, and a dirty table corrupts the NEXT
                // call's prefix sums (bucket overflow / phantom keys).
                memset(cursor, 0, (maxk + 1) * sizeof(uint32_t));
                return -2;
            }
        }
        memset(slabs, 0, nk * 1024 * sizeof(uint64_t));
        for (size_t j = 0; j < nk; j++) cursor[out_keys[j]] = (uint32_t)j;
        for (size_t i = 0; i < n; i++) {
            uint64_t local = cols[i] & col_mask;
            uint64_t key = (((uint64_t)rows[i]) << key_shift) + (local >> 16);
            uint32_t low = (uint32_t)(local & 0xFFFFu);
            slabs[((size_t)cursor[key] << 10) | (low >> 6)] |= 1ULL << (low & 63u);
        }
        size_t lo = 0;
        for (size_t j = 0; j < nk; j++) {
            size_t wrote = extract_bitset(slabs + (j << 10), out_lows + lo);
            lo += wrote;
            out_counts[j] = (uint32_t)wrote;
        }
        for (size_t j = 0; j < nk; j++) cursor[out_keys[j]] = 0;
        return (long long)nk;
    }
    // Bucket path (many containers): counts -> exclusive prefix sums,
    // scatter lows per container, then dedupe each group through one
    // shared 8 KiB bitset.
    if (scratch_n < n) {
        free(bucket);
        bucket = (uint16_t*)malloc(n * sizeof(uint16_t));
        scratch_n = bucket ? n : 0;
        if (!scratch_n) {
            memset(cursor, 0, (maxk + 1) * sizeof(uint32_t));  // see above
            return -2;
        }
    }
    uint32_t acc = 0;
    for (size_t k = 0; k <= maxk; k++) {
        uint32_t c = cursor[k];
        cursor[k] = acc;
        acc += c;
    }
    for (size_t i = 0; i < n; i++) {
        uint64_t local = cols[i] & col_mask;
        uint64_t key = (((uint64_t)rows[i]) << key_shift) + (local >> 16);
        bucket[cursor[key]++] = (uint16_t)(local & 0xFFFFu);
    }
    // cursor[k] is now the END offset of bucket k.
    uint64_t bits[1024];
    size_t lo = 0, start = 0;
    for (size_t j = 0; j < nk; j++) {
        uint32_t k = out_keys[j];
        size_t end = cursor[k];
        memset(bits, 0, sizeof(bits));
        for (size_t i = start; i < end; i++) {
            uint16_t p = bucket[i];
            bits[p >> 6] |= 1ULL << (p & 63u);
        }
        size_t wrote = extract_bitset(bits, out_lows + lo);
        lo += wrote;
        out_counts[j] = (uint32_t)wrote;
        start = end;
    }
    memset(cursor, 0, (maxk + 1) * sizeof(uint32_t));
    return (long long)nk;
}

extern "C" {

long long pilosa_import_containers(const uint64_t* rows, const uint64_t* cols,
                                   size_t n, uint32_t shard_width_exp,
                                   size_t key_cap, uint32_t* out_keys,
                                   uint32_t* out_counts, uint16_t* out_lows) {
    return import_containers_impl<uint64_t, uint64_t>(
        rows, cols, n, shard_width_exp, key_cap, out_keys, out_counts,
        out_lows);
}

long long pilosa_import_containers32(
    const uint64_t* rows, const uint32_t* cols, size_t n,
    uint32_t shard_width_exp, size_t key_cap, uint32_t* out_keys,
    uint32_t* out_counts, uint16_t* out_lows) {
    return import_containers_impl<uint64_t, uint32_t>(
        rows, cols, n, shard_width_exp, key_cap, out_keys, out_counts,
        out_lows);
}

// The narrow bulk-load profile: row ids < 256 and 32-bit global column
// ids — 5 B/pair of input stream vs 16 for the wide form.
long long pilosa_import_containers_r8c32(
    const uint8_t* rows, const uint32_t* cols, size_t n,
    uint32_t shard_width_exp, size_t key_cap, uint32_t* out_keys,
    uint32_t* out_counts, uint16_t* out_lows) {
    return import_containers_impl<uint8_t, uint32_t>(
        rows, cols, n, shard_width_exp, key_cap, out_keys, out_counts,
        out_lows);
}

// Zero-word compression for the sparse stack wire format
// (ops/sparse.py): mask_out gets one occupancy bit per input word
// (bit b of mask_out[j] covers in[j*32+b]), vals_out the nonzero words
// in order. Returns nnz. n_words must be a multiple of 32 (callers pad
// their chunk staging buffer). ~1 GB/s scalar; the numpy fallback's
// reshape/reduce pipeline measured ~9 s/GB on this host.
long long pilosa_compress_words(const uint32_t* in, size_t n_words,
                                uint32_t* mask_out, uint32_t* vals_out) {
    size_t nnz = 0;
    for (size_t w = 0; w < n_words; w += 32) {
        uint32_t m = 0;
        for (int b = 0; b < 32; ++b) {
            uint32_t v = in[w + b];
            if (v) {
                m |= (1u << b);
                vals_out[nnz++] = v;
            }
        }
        mask_out[w >> 5] = m;
    }
    return (long long)nnz;
}

}  // extern "C"
