"""The port's chunked cold build (pilosa_tpu_torch/ops/sparse.py) and its
expansion kernels' plain forms (ops/kernels.py expand_positions_torch,
expand_runs_torch, expand_words_torch: K12 to K14), run on the CPU against
the JAX package's ops/sparse.py and its XLA expansion programs.

Chunks are shrunk to 1 << 12 words (two roaring containers a chunk) in both
packages, as tests/test_sparse.py shrinks the JAX one, so that small stacks
cross many chunks. Every stack the port's builder makes must equal the
dense pack and the JAX builder's stack byte for byte, with the same chunks
in each wire tier. The JAX package's warm-gate test
(test_not_warm_falls_back_dense) has no counterpart here: the port compiles
no program per shape, so nothing is ever cold.
"""

import collections
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.core.view import VIEW_STANDARD as JAX_VIEW_STANDARD
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec import tpu as jax_tpu
from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu.ops import kernels as jax_kernels
from pilosa_tpu.ops import sparse as jax_sparse
from pilosa_tpu.roaring.bitmap import Container as JaxContainer
from pilosa_tpu.utils.stats import global_stats as jax_stats
from pilosa_tpu_torch import native
from pilosa_tpu_torch.carry import open_reference_holder
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.ops import sparse
from pilosa_tpu_torch.ops.blocks import WORDS_PER_SHARD, pack_fragment
from pilosa_tpu_torch.roaring.bitmap import Container
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.stats import global_stats

SMALL = 1 << 12
SLOT = 2048


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages' chunks shrunk to SMALL words. The JAX package's
    programs are compiled first (its cache is keyed by CHUNK_WORDS), so its
    warm gate is open and its builder takes the sparse tiers."""
    monkeypatch.setattr(sparse, "CHUNK_WORDS", SMALL)
    monkeypatch.setattr(sparse, "MIN_CHUNKED_WORDS", 2 * SMALL)
    monkeypatch.setattr(jax_sparse, "CHUNK_WORDS", SMALL)
    monkeypatch.setattr(jax_sparse, "BUCKETS", (SMALL // 32, SMALL // 16, SMALL // 8,
                                                SMALL // 4))
    monkeypatch.setattr(jax_sparse, "MIN_CHUNKED_WORDS", 2 * SMALL)
    monkeypatch.setattr(jax_tpu, "MIN_CHUNKED_WORDS", 2 * SMALL)
    for b in jax_sparse.BUCKETS:
        jax_sparse._chunk_prog(None, b)
    jax_sparse._chunk_zeros_prog(None)
    jax_sparse._or_prog(None)
    jax_sparse._pos_prog(None)
    jax_sparse._run_prog(None)
    assert jax_sparse.container_progs_ready(None)


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _i16(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint16).view(np.int16))


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32, copy=False))


def _csr(groups):
    """(slots, starts) of (slot, entries) groups."""
    sizes = [len(e) for _, e in groups]
    return (np.array([s for s, _ in groups], dtype=np.int32),
            np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))


# -- K12 to K14's plain forms against the JAX programs ----------------------


def _array_groups(rng):
    """Array containers over 12 of a 16-slot chunk: edge positions 0 and
    65535, bit 31 of a word, a single position, random fills."""
    groups = [(0, [0, 31, 32, 65535]), (3, [65535]), (4, [31])]
    for slot in (1, 5, 6, 7, 9, 10, 13, 15):
        n = int(rng.integers(1, 4000))
        groups.append((slot, sorted(rng.choice(65536, n, replace=False).tolist())))
    return sorted(groups)


def _run_groups(rng):
    """Run containers: a whole-container run, one-word spans, a span that
    ends on bit 31, one inside one word, two sharing an edge word, and
    random disjoint runs."""
    groups = [
        (0, [(0, 65535)]),
        (2, [(0, 0), (31, 31), (32, 63), (64, 64), (65535, 65535)]),
        (3, [(5, 9), (10, 10), (40, 100), (101, 4000), (4031, 4095)]),
        (6, [(33, 62), (96, 127), (65000, 65534)]),
    ]
    for slot in (8, 11, 14):
        cuts = np.sort(rng.choice(65536, 2 * int(rng.integers(1, 40)), replace=False))
        groups.append((slot, [(int(a), int(b)) for a, b in cuts.reshape(-1, 2)]))
    return groups


def test_expand_positions_plain_equals_jax_expand_array_positions(rng):
    groups = _array_groups(rng)
    c = 16 * SLOT
    pos = np.concatenate([np.array(e, dtype=np.uint16) for _, e in groups])
    slots, starts = _csr(groups)
    out = torch.zeros(c, dtype=torch.int32)
    K.expand_positions(out, _i16(pos), _i32(slots), _i32(starts))
    counts = np.bincount(np.repeat(slots, np.diff(starts)), minlength=16).astype(np.int32)
    page = np.zeros(pos.size + 7, dtype=np.uint16)
    page[: pos.size] = pos
    want = jax_kernels.expand_array_positions(
        jnp.zeros(c, jnp.uint32), jnp.asarray(page), jnp.asarray(counts),
        jnp.int32(pos.size))
    np.testing.assert_array_equal(_words(out), np.asarray(want))


def test_expand_runs_plain_equals_jax_expand_run_spans(rng):
    groups = _run_groups(rng)
    c = 16 * SLOT
    runs = np.array([r for _, e in groups for r in e], dtype=np.uint16)
    slots, starts = _csr(groups)
    out = torch.zeros(c, dtype=torch.int32)
    K.expand_runs(out, _i16(runs.reshape(-1)), _i32(slots), _i32(starts))
    base = np.repeat(slots.astype(np.int64) * 65536, np.diff(starts))
    lo = np.zeros(runs.shape[0] + 5, dtype=np.int32)
    hi = np.zeros_like(lo)
    lo[: runs.shape[0]] = base + runs[:, 0]
    hi[: runs.shape[0]] = base + runs[:, 1]
    want = jax_kernels.expand_run_spans(
        jnp.zeros(c, jnp.uint32), jnp.asarray(lo), jnp.asarray(hi),
        jnp.int32(runs.shape[0]))
    np.testing.assert_array_equal(_words(out), np.asarray(want))


def test_expand_slots_are_written_whole_and_others_left(rng):
    """K12 and K13 write their slots whole (zero words too) and no other
    word; K14 writes only the nonzero words."""
    out = torch.full((4 * SLOT,), -1, dtype=torch.int32)
    K.expand_positions(out, _i16([7]), _i32([1]), _i32([0, 1]))
    K.expand_runs(out, _i16([3, 3]), _i32([2]), _i32([0, 1]))
    got = _words(out)
    assert (got[:SLOT] == 0xFFFFFFFF).all() and (got[3 * SLOT :] == 0xFFFFFFFF).all()
    assert got[SLOT] == 1 << 7 and not got[SLOT + 1 : 2 * SLOT].any()
    assert got[2 * SLOT] == 1 << 3 and not got[2 * SLOT + 1 : 3 * SLOT].any()
    mask = np.zeros(4 * SLOT // 32, dtype=np.uint32)
    mask[0] = 0b101
    out = torch.full((4 * SLOT,), 5, dtype=torch.int32)
    K.expand_words(out, _i32(mask.view(np.int32)), _i32([9, 10]),
                   _i32(K.expand_words_bases(mask)))
    got = _words(out)
    assert got[0] == 9 and got[2] == 10 and (np.delete(got, [0, 2]) == 5).all()


@pytest.mark.parametrize("density", [0.0, 0.002, 0.05, 0.24])
def test_expand_words_plain_equals_jax_chunk_prog(rng, small_chunks, density):
    chunk = np.zeros(SMALL, dtype=np.uint32)
    nnz = int(SMALL * density)
    if nnz:
        at = rng.choice(SMALL, nnz, replace=False)
        chunk[at] = rng.integers(1, 2**32, nnz, dtype=np.uint32)
    chunk[0] = 0x80000000
    chunk[-1] = 0xFFFFFFFF
    mask, vals, n = sparse.compress_chunk(chunk)
    bucket = sparse.pick_bucket(n)
    padded = np.zeros(bucket, dtype=np.uint32)
    padded[:n] = vals
    want = jax_sparse._chunk_prog(None, bucket)(jax.device_put(mask), jax.device_put(padded))
    out = torch.zeros(SMALL, dtype=torch.int32)
    K.expand_words(out, _i32(mask.view(np.int32)), _i32(vals.view(np.int32)),
                   _i32(K.expand_words_bases(mask)))
    np.testing.assert_array_equal(_words(out), np.asarray(want))
    np.testing.assert_array_equal(_words(out), chunk)


def test_expand_words_bases_count_the_words_before_each_block(rng):
    mask = rng.integers(0, 2**32, 3 * K.EXPAND_WORDS_BLOCK + 17, dtype=np.uint32)
    bases = K.expand_words_bases(mask)
    per = np.bitwise_count(mask).astype(np.int64)
    want = [per[: b * K.EXPAND_WORDS_BLOCK].sum() for b in range(4)]
    assert bases.dtype == np.int32 and bases.tolist() == want


#: A chunk of five whole K14 tiles and a ragged sixth (100 mask words).
TILED_CHUNK = 32 * (5 * K.EXPAND_WORDS_BLOCK + 100)


def _tile_walk(mask, vals, bases, n):
    """K14's indexing, as its CUDA blocks take it, in numpy: tile b's groups
    of 4 mask words take their values from bases[b] on; an all-ones group
    wholly inside the n words is a straight copy of 128 values, any other
    nonzero group a rank store of its set bits below word n."""
    out = np.zeros(n, dtype=np.uint32)
    tile = K.EXPAND_WORDS_BLOCK
    padded = np.zeros(-(-mask.size // tile) * tile, dtype=np.uint32)
    padded[: mask.size] = mask
    for b, base in enumerate(bases.tolist()):
        groups = padded[b * tile : (b + 1) * tile].reshape(-1, 4)
        per = np.bitwise_count(groups).sum(axis=1).astype(np.int64)
        offs = base + np.cumsum(per) - per
        for i in np.flatnonzero(groups.any(axis=1)):
            w0 = 32 * (b * tile + 4 * int(i))
            if (groups[i] == 0xFFFFFFFF).all() and w0 + 128 <= n:
                out[w0 : w0 + 128] = vals[offs[i] : offs[i] + 128]
                continue
            bits = ((groups[i][:, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1)
            at = np.flatnonzero(bits)
            keep = w0 + at < n
            out[w0 + at[keep]] = vals[offs[i] + np.arange(at.size)[keep]]
    return out


def _mask_family(rng, family, n_mask):
    """A mask of n_mask words: all zero, all ones, or mixed: random words,
    an all-ones span across the tile 0/1 edge, zero spans across the tile
    2 and 3 edges, an all-ones span off the 4-word groups, full words in
    the ragged last tile."""
    if family == "zero":
        return np.zeros(n_mask, dtype=np.uint32)
    if family == "ones":
        return np.full(n_mask, 0xFFFFFFFF, dtype=np.uint32)
    tile = K.EXPAND_WORDS_BLOCK
    mask = rng.integers(0, 2**32, n_mask, dtype=np.uint32)
    mask[rng.random(n_mask) < 0.3] = 0
    mask[tile - 40 : tile + 24] = 0xFFFFFFFF
    mask[2 * tile - 300 : 2 * tile + 500] = 0
    mask[3 * tile - 7 : 3 * tile + 9] = 0
    mask[3001:3014] = 0xFFFFFFFF
    mask[-60:-20] = 0xFFFFFFFF
    return mask


@pytest.mark.parametrize("family", ["zero", "ones", "mixed"])
@pytest.mark.parametrize("short", [0, 4 * 32 * 7 + 13])
def test_expand_words_tiles_equal_jax_chunk_prog(rng, monkeypatch, family, short):
    """The plain K14, and K14's tile walk over expand_words_bases at the
    tile size (EXPAND_WORDS_BLOCK mask words), against the JAX package's
    mask decompress on a chunk of five tiles and a ragged sixth: all-zero,
    all-ones and mixed masks whose spans cross the tiles' edges, the whole
    chunk or a short last chunk (its words past n zero in the mask)."""
    monkeypatch.setattr(jax_sparse, "CHUNK_WORDS", TILED_CHUNK)
    n = TILED_CHUNK - short
    mask = _mask_family(rng, family, TILED_CHUNK // 32)
    bits = ((mask[:, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1)
    bits[n:] = 0
    mask = np.bitwise_or.reduce(
        bits.reshape(-1, 32).astype(np.uint32) << np.arange(32, dtype=np.uint32), axis=1)
    nnz = int(bits.sum())
    vals = rng.integers(1, 2**32, nnz, dtype=np.uint32)
    bucket = max(nnz, 1)
    padded = np.zeros(bucket, dtype=np.uint32)
    padded[:nnz] = vals
    want = np.asarray(jax_sparse._chunk_prog(None, bucket)(
        jax.device_put(mask), jax.device_put(padded)))[:n]
    bases = K.expand_words_bases(mask)
    assert bases.size == 6
    out = torch.zeros(n, dtype=torch.int32)
    K.expand_words(out, _i32(mask.view(np.int32)), _i32(vals.view(np.int32)), _i32(bases))
    np.testing.assert_array_equal(_words(out), want)
    np.testing.assert_array_equal(_tile_walk(mask, vals, bases, n), want)


@pytest.mark.parametrize("call,args,err", [
    ("expand_positions", lambda o: (o, _i16([1]), _i32([0]), _i32([0])), ValueError),
    ("expand_positions", lambda o: (o[:100], _i16([1]), _i32([0]), _i32([0, 1])), ValueError),
    ("expand_positions", lambda o: (o, _i32([1]), _i32([0]), _i32([0, 1])), TypeError),
    ("expand_runs", lambda o: (o.long(), _i16([1, 2]), _i32([0]), _i32([0, 1])), TypeError),
    ("expand_words", lambda o: (o, _i32([1]), _i32([1]), _i32([0, 0])), ValueError),
    ("expand_words", lambda o: (o, _i32([1]), _i32([1]), _i32([0])), ValueError),
])
def test_expand_wrappers_reject_bad_inputs(call, args, err):
    out = torch.zeros(SLOT, dtype=torch.int32)
    with pytest.raises(err):
        getattr(K, call)(*args(out))


def test_cpu_expansions_launch_nothing():
    before = K.launch_counts()
    out = torch.zeros(SLOT, dtype=torch.int32)
    K.expand_positions(out, _i16([1]), _i32([0]), _i32([0, 1]))
    K.expand_runs(out, _i16([1, 2]), _i32([0]), _i32([0, 1]))
    K.expand_words(out, _i32([1] + [0] * 63), _i32([1]), _i32([0]))
    assert K.launch_counts() == before


# -- compress_chunk ---------------------------------------------------------


@pytest.mark.parametrize("density", [0.0, 0.01, 0.2, 0.9])
def test_compress_chunk_native_fallback_and_jax_agree(rng, small_chunks, monkeypatch,
                                                      density):
    chunk = np.zeros(SMALL, dtype=np.uint32)
    nnz = int(SMALL * density)
    if nnz:
        chunk[rng.choice(SMALL, nnz, replace=False)] = rng.integers(1, 2**32, nnz,
                                                                   dtype=np.uint32)
    m1, v1, n1 = sparse.compress_chunk(chunk)
    mj, vj, nj = jax_sparse.compress_chunk(chunk)
    monkeypatch.setattr(native, "compress_words", lambda *a: None)
    m2, v2, n2 = sparse.compress_chunk(chunk)
    assert n1 == n2 == nj == int((chunk != 0).sum())
    for m, v in ((m2, v2), (mj, vj)):
        np.testing.assert_array_equal(m1, m)
        np.testing.assert_array_equal(v1[:n1], v[:n1])


def test_pick_bucket_is_the_reference_menu(small_chunks):
    for nnz in (0, SMALL // 32, SMALL // 32 + 1, SMALL // 8, SMALL // 4, SMALL // 4 + 1):
        assert sparse.pick_bucket(nnz) == jax_sparse.pick_bucket(nnz)


# -- ChunkedStackBuilder against the dense pack and the JAX builder ---------


class _JaxBuilder(jax_sparse.ChunkedStackBuilder):
    """The JAX builder, counting the chunks of each wire kind it drains."""

    def __init__(self, *args):
        super().__init__(*args)
        self.kinds = collections.Counter()

    def _drain_pending(self):
        for _, kind, _ in self._pending:
            self.kinds[kind] += 1
        super()._drain_pending()


#: The JAX builder's wire kinds by the port's tier names.
_KINDS = {"words": "sparse", "raw": "dense", "container": "cont"}

#: Counters that both builders count alike (the wire bytes differ: the port
#: ships no padding).
SHARED_COUNTERS = ("stack_container_chunks_total", "stack_container_pos_total",
                   "stack_container_runs_total", "stack_sparse_dense_bytes_total",
                   "stack_sparse_uploads_total")


def _counts(stats) -> dict:
    return {n: sum(stats.counter_totals(n).values()) for n in
            SHARED_COUNTERS + ("stack_pending_drains_total",)}


def _both_build(shape, feed):
    """Runs feed(builder) on the port's builder and the JAX one; asserts
    equal stacks and equal tier chunk counts and shared counters; returns
    (port builder, port stack words)."""
    t0, j0 = _counts(global_stats), _counts(jax_stats)
    port = sparse.ChunkedStackBuilder("cpu", shape)
    feed(port)
    got = _words(port.finish())
    ref = _JaxBuilder(None, shape)
    feed(ref)
    want = np.asarray(ref.finish())
    assert got.shape == want.shape == tuple(shape)
    np.testing.assert_array_equal(got, want)
    assert {t: port.chunks[t] for t in _KINDS} == {t: ref.kinds[k] for t, k in _KINDS.items()}
    t1, j1 = _counts(global_stats), _counts(jax_stats)
    assert {n: t1[n] - t0[n] for n in SHARED_COUNTERS} == \
        {n: j1[n] - j0[n] for n in SHARED_COUNTERS}
    port.drains = t1["stack_pending_drains_total"] - t0["stack_pending_drains_total"]
    return port, got


def _ragged(host):
    flat = host.reshape(-1)
    step = max(1, flat.size // 7)

    def feed(b):
        for i in range(0, flat.size, step):
            b.feed(flat[i : i + step])

    return feed


def test_sparse_stack(rng, small_chunks):
    host = np.zeros((4, 8, 512), dtype=np.uint32)
    pos = rng.choice(host.size, size=host.size // 20, replace=False)
    host.reshape(-1)[pos] = 1 + pos.astype(np.uint32)
    b, got = _both_build(host.shape, lambda b: b.feed(host.reshape(-1)))
    np.testing.assert_array_equal(got, host)
    assert b.chunks["words"] > 0 and 0 < b._wire_bytes < b._dense_bytes // 2


def test_dense_stack_falls_back_per_chunk(rng, small_chunks):
    host = rng.integers(0, 2**32, size=(3, 8, 512), dtype=np.uint32)
    b, got = _both_build(host.shape, _ragged(host))
    np.testing.assert_array_equal(got, host)
    assert b.chunks["raw"] == host.size // SMALL


def test_all_zero_stack_ships_nothing(small_chunks):
    host = np.zeros((4, 8, 512), dtype=np.uint32)
    b, got = _both_build(host.shape, lambda b: b.feed(host.reshape(-1)))
    assert b._wire_bytes == 0 and not got.any()


def test_partial_tail_chunk(small_chunks):
    host = np.zeros((5, 8, 400), dtype=np.uint32)
    host[4, 7, 399] = 0xDEADBEEF
    host[0, 0, 0] = 3
    _, got = _both_build(host.shape, _ragged(host))
    np.testing.assert_array_equal(got, host)


def test_partial_tail_chunk_of_raw_words(rng, small_chunks):
    host = rng.integers(0, 2**32, size=(5, 8, 400), dtype=np.uint32)
    b, got = _both_build(host.shape, _ragged(host))
    np.testing.assert_array_equal(got, host)
    assert b._wire_bytes == host.nbytes


def test_mixed_density_chunks(rng, small_chunks):
    host = np.zeros((6, 8, 512), dtype=np.uint32)
    host[0] = rng.integers(0, 2**32, size=(8, 512), dtype=np.uint32)
    host[3, 2, 17] = 42
    b, got = _both_build(host.shape, _ragged(host))
    np.testing.assert_array_equal(got, host)
    assert b.chunks["raw"] and b.chunks["words"] and b.chunks["empty"]


def test_skip_regions_are_zero(rng, small_chunks):
    slab = rng.integers(0, 2**32, size=8 * 512, dtype=np.uint32)

    def feed(b):
        b.feed(slab)
        b.skip(8 * 512)
        b.feed(slab)

    _, got = _both_build((3, 8, 512), feed)
    np.testing.assert_array_equal(got[0].reshape(-1), slab)
    assert not got[1].any()
    np.testing.assert_array_equal(got[2].reshape(-1), slab)


def test_pending_bytes_bound_drains_early(rng, small_chunks, monkeypatch):
    monkeypatch.setattr(sparse, "MAX_PENDING_BYTES", 1 << 12)
    monkeypatch.setattr(jax_sparse, "MAX_PENDING_BYTES", 1 << 12)
    host = rng.integers(0, 2**32, size=(6, 8, 512), dtype=np.uint32)
    seen = []

    def feed(b):
        b.feed(host.reshape(-1))
        seen.append(b._pending_bytes)

    b, got = _both_build(host.shape, feed)
    np.testing.assert_array_equal(got, host)
    assert b.drains > 0
    assert seen[0] <= (1 << 12) + sparse.CHUNK_WORDS * 4


def _twin_fragment(rng, runs=False, bitmap=False, n_rows=4, density_bits=3000,
                   packed_bitmap=False):
    """The same fragment in an in-memory holder of each package (shard 0
    of field f): rows 0 .. n_rows - 1 over random columns, and optionally
    a planted run container (key 1) and bitmap container (key 2), whose
    bits are random or (packed_bitmap) fill its first 200 words, so that
    its chunk rides the container tier's word-mask remainder."""
    cols = np.unique(rng.integers(0, SHARD_WIDTH, density_bits, dtype=np.uint64))
    rows = rng.integers(0, n_rows, cols.size, dtype=np.uint64)
    run_table = np.array([[0, 5000], [5002, 5002], [60000, 65535]], dtype=np.int64)
    pos = (np.arange(200 * 32, dtype=np.uint16) if packed_bitmap
           else np.unique(rng.integers(0, 65536, 9000).astype(np.uint16)))
    out = []
    for holder_cls, view, container in ((JaxHolder, JAX_VIEW_STANDARD, JaxContainer),
                                        (Holder, VIEW_STANDARD, Container)):
        h = holder_cls(None).open()
        f = h.create_index("i").create_field("f")
        f.import_bits(rows, cols)
        fr = f.view(view).fragment(0)
        if runs:
            fr.storage.put_container(1, container.from_runs(run_table))
        if bitmap:
            fr.storage.put_container(2, container.from_positions(pos))
        out.append((h, fr))
    return out


def _fragment_build(rng, **kw):
    (jh, jfr), (th, tfr) = _twin_fragment(rng, **kw)
    shape = (4, 8, WORDS_PER_SHARD)

    def feed(b):
        b.feed_fragment(tfr if isinstance(b, sparse.ChunkedStackBuilder) else jfr, 8)
        b.skip(3 * 8 * WORDS_PER_SHARD)

    try:
        b, got = _both_build(shape, feed)
        np.testing.assert_array_equal(got[0], pack_fragment(tfr, n_rows=8))
        assert not got[1:].any()
    finally:
        jh.close()
        th.close()
    return b


def test_array_containers(rng, small_chunks):
    b = _fragment_build(rng)
    assert b.chunks["container"] > 0
    assert 0 < b._wire_bytes < b._dense_bytes


def test_run_and_bitmap_containers(rng, small_chunks):
    runs0 = sum(global_stats.counter_totals("stack_container_runs_total").values())
    b = _fragment_build(rng, runs=True, bitmap=True)
    assert b.chunks["container"] > 0
    assert sum(global_stats.counter_totals("stack_container_runs_total").values()) > runs0


def test_container_chunk_with_a_bitmap_remainder(rng, small_chunks):
    """A chunk of an array container and a bitmap container of 200 nonzero
    words ships on the container tier, the bitmap's words as its mask
    remainder (K12 and K14 on one chunk)."""
    b = _fragment_build(rng, bitmap=True, packed_bitmap=True)
    assert b.chunks["container"] > 0 and b.chunks["raw"] == 0


#: One shard's 8 rows: the chunk of the skewed-field test, so that each
#: chunk holds what a 2^23-word chunk of 32 shards holds, at 1/32 scale.
SKEW_CHUNK = 8 * WORDS_PER_SHARD


@pytest.fixture
def skew_chunks(monkeypatch):
    """Both packages' chunks set to SKEW_CHUNK words, the JAX programs
    compiled first (as small_chunks does)."""
    monkeypatch.setattr(sparse, "CHUNK_WORDS", SKEW_CHUNK)
    monkeypatch.setattr(sparse, "MIN_CHUNKED_WORDS", 2 * SKEW_CHUNK)
    monkeypatch.setattr(jax_sparse, "CHUNK_WORDS", SKEW_CHUNK)
    monkeypatch.setattr(jax_sparse, "BUCKETS", (SKEW_CHUNK // 32, SKEW_CHUNK // 16,
                                                SKEW_CHUNK // 8, SKEW_CHUNK // 4))
    monkeypatch.setattr(jax_sparse, "MIN_CHUNKED_WORDS", 2 * SKEW_CHUNK)
    for b in jax_sparse.BUCKETS:
        jax_sparse._chunk_prog(None, b)
    jax_sparse._chunk_zeros_prog(None)
    jax_sparse._or_prog(None)
    jax_sparse._pos_prog(None)
    jax_sparse._run_prog(None)
    assert jax_sparse.container_progs_ready(None)


def test_skewed_field_rides_the_container_tier_with_a_words_remainder(rng, skew_chunks):
    """A field shaped like chip_smoke.py's s: row 0 broad (every container
    a bitmap container of random words, bit density 0.5), rows 1 to 7
    narrow (array containers, bit density 0.01), over 3 shards of one chunk
    each. Every chunk ships on the container tier with its bitmap
    containers as a word-mask remainder of exactly CHUNK_WORDS // 8 words,
    and the stack equals the dense pack and the JAX builder's."""
    n_shards, per_row = 3, SHARD_WIDTH >> 16
    holders, frags = [], {}
    for holder_cls, view, container in ((JaxHolder, JAX_VIEW_STANDARD, JaxContainer),
                                        (Holder, VIEW_STANDARD, Container)):
        h = holder_cls(None).open()
        holders.append(h)
        f = h.create_index("i").create_field("s")
        frags[holder_cls] = []
        draw = np.random.default_rng(5)
        for shard in range(n_shards):
            narrow = draw.random((7, SHARD_WIDTH)) < 0.01
            rows, cols = np.nonzero(narrow)
            f.import_bits((rows + 1).astype(np.uint64),
                          (shard * SHARD_WIDTH + cols).astype(np.uint64))
            fr = f.view(view).fragment(shard)
            words = np.frombuffer(draw.bytes(per_row * 8192), dtype="<u8").reshape(per_row, -1)
            for key in range(per_row):
                fr.storage.put_container(key, container.from_bitmap_words(words[key].copy()))
            kinds = {(k // per_row == 0, fr.storage.container(k).typ) for k in fr.storage.keys()}
            assert kinds == {(True, "bitmap"), (False, "array")}
            frags[holder_cls].append(fr)
    shipped = []

    class Capture(sparse.ChunkedStackBuilder):
        def _ship(self, lay, kind):
            shipped.append((kind, [v.numel() for v in lay.views(lay.host)]))
            super()._ship(lay, kind)

    def feed(b):
        own = frags[Holder] if isinstance(b, sparse.ChunkedStackBuilder) else frags[JaxHolder]
        for fr in own:
            b.feed_fragment(fr, 8)

    try:
        port = Capture("cpu", (n_shards, 8, WORDS_PER_SHARD))
        feed(port)
        got = _words(port.finish())
        for shard, fr in enumerate(frags[Holder]):
            np.testing.assert_array_equal(got[shard], pack_fragment(fr, n_rows=8))
        b, both = _both_build((n_shards, 8, WORDS_PER_SHARD), feed)
        np.testing.assert_array_equal(both, got)
    finally:
        for h in holders:
            h.close()
    assert port.chunks == {"empty": 0, "words": 0, "container": n_shards, "raw": 0}
    assert b.chunks == port.chunks
    assert [kind for kind, _ in shipped] == ["container"] * n_shards
    for _, sizes in shipped:
        # six container views, then the remainder: mask, values, bases
        assert len(sizes) == 9 and sizes[4] > 0
        assert sizes[6:] == [SKEW_CHUNK // 32, SKEW_CHUNK // 8,
                             -(-SKEW_CHUNK // 32 // K.EXPAND_WORDS_BLOCK)]


def test_dense_rows_materialize(rng, small_chunks):
    """Array containers too full for the container tier's wire ship their
    chunk on the word tiers, scattered on the host."""
    b = _fragment_build(rng, n_rows=1, density_bits=60_000)
    assert b.chunks["raw"] > 0


def test_disabled_tier_ships_words(rng, small_chunks, monkeypatch):
    monkeypatch.setattr(sparse, "CONTAINER_TIER_ENABLED", False)
    monkeypatch.setattr(jax_sparse, "CONTAINER_TIER_ENABLED", False)
    b = _fragment_build(rng, runs=True)
    assert b.chunks["container"] == 0 and b.chunks["words"] > 0


def test_builders_share_no_staging_buffer(rng, small_chunks):
    """Two builders at once never hold one pooled buffer, and a later
    builder takes the buffers they gave back at finish."""
    slab = rng.integers(0, 2**32, size=8 * 512, dtype=np.uint32)

    def held(x):
        return {id(buf) for _, _, buf in x._inflight}

    a = sparse.ChunkedStackBuilder("cpu", (2, 8, 512))
    b = sparse.ChunkedStackBuilder("cpu", (2, 8, 512))
    for x in (a, b, a, b):
        x.feed(slab)
    ha, hb = held(a), held(b)
    assert ha and hb and not ha & hb
    np.testing.assert_array_equal(_words(a.finish()).reshape(-1), np.tile(slab, 2))
    np.testing.assert_array_equal(_words(b.finish()).reshape(-1), np.tile(slab, 2))
    c = sparse.ChunkedStackBuilder("cpu", (2, 8, 512))
    c.feed(slab)
    assert held(c) and held(c) <= ha | hb
    c.finish()


# -- CUDABackend(device="cpu") through the chunked build --------------------

QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=0), Row(g=2)))",
    "Count(Union(Row(f=3), Row(g=1)))",
    "TopN(f, n=4)",
    "GroupBy(Rows(f), Rows(g))",
]


def test_backend_differential_through_chunked_build(rng, small_chunks, tmp_path):
    """tests/test_sparse.py's query differential: the port's stacks built
    chunk by chunk answer as the JAX TPUBackend's, and equal them byte for
    byte."""
    src = tmp_path / "src"
    h = JaxHolder(str(src)).open()
    idx = h.create_index("i")
    for fn in ("f", "g"):
        f = idx.create_field(fn)
        for s in range(3):
            cols = np.unique(rng.integers(0, SHARD_WIDTH, 2000, dtype=np.uint64)) + s * SHARD_WIDTH
            f.import_bits(rng.integers(0, 4, cols.size, dtype=np.uint64), cols)
    h.close()
    shutil.copytree(src, tmp_path / "port")
    jh = JaxHolder(str(src)).open()
    th = open_reference_holder(str(tmp_path / "port"))
    try:
        n0 = sum(global_stats.counter_totals("stack_sparse_uploads_total").values())
        backend = CUDABackend(th, device="cpu")
        jbackend = TPUBackend(jh)
        dev, jdev = Executor(th, backend=backend), JaxExecutor(jh, backend=jbackend)
        for q in QUERIES:
            assert result_to_json(dev.execute("i", q)) == jax_json(jdev.execute("i", q)), q
        assert sum(global_stats.counter_totals("stack_sparse_uploads_total").values()) > n0
        for fn in ("f", "g"):
            got, _ = backend.blocks.get("i", th.index("i").field(fn), (0, 1, 2))
            want, _ = jbackend.blocks.get("i", jh.index("i").field(fn), (0, 1, 2))
            np.testing.assert_array_equal(_words(got), np.asarray(want))
    finally:
        jh.close()
        th.close()
