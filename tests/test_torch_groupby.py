"""GroupBy on the port: the group kernels' plain versions
(pilosa_tpu_torch/ops/kernels.py) and CUDABackend.group_by
(pilosa_tpu_torch/exec/cuda.py), run on the CPU, against the JAX package.

- The four plain group functions equal the JAX package's nary_stats /
  nary_stats_pershard / tri_stats (Pallas, interpret mode) and
  group_tile_stats(_pershard) (with padded, inactive slots) on the same
  numpy inputs.
- tests/test_groupby_tiles.py's GroupBy matrix, plus bench.py's four
  GroupBy queries, built into a JAX Holder and a port Holder from the same
  seed: the port's CUDABackend(device="cpu") answers as the JAX TPUBackend
  and the port's CPU oracle do, on the maintained per-shard route and on
  the generic tiled route (MAX_PAIR_PERSHARD_BYTES = 1), and across write
  churn.

Every output is an integer: equality is exact.
"""

import datetime as dt

import numpy as np
import pytest
import torch

from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.core.field import options_for_time as jax_options_for_time
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu.ops import kernels as JK
from pilosa_tpu_torch.carry import stack_from_reference
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.field import options_for_time
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.cpu import CPUBackend
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.stats import global_stats
from tests.test_groupby_tiles import LIVE, QUERIES, WIDE_QUERIES, build, build_wide


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the plain group functions against the JAX package's kernels
# ---------------------------------------------------------------------------

W = 256  # small word axis: the interpret-mode grid walks (K, S) in Python


def _words(rng, *shape):
    """uint32 words at bit density 1/4 (the AND of two random words)."""
    return (rng.integers(0, 2**32, shape, dtype=np.uint32)
            & rng.integers(0, 2**32, shape, dtype=np.uint32))


def _t(words):
    return stack_from_reference(words, "cpu")


# (S, Rf, Rg, extra heights, filtered): E in {1, 2}, S in {1, 3}, filtered
# and not, Rf != Rg.
KERNEL_CASES = [
    (s, rf, rg, heights, filtered)
    for s, rf, rg in ((1, 8, 8), (3, 8, 5))
    for heights in ((4,), (3, 5))
    for filtered in (False, True)
]


def _case(s, rf, rg, heights, filtered):
    rng = np.random.default_rng(s * 100 + rf * 10 + rg + 7 * len(heights) + filtered)
    f, g = _words(rng, s, rf, W), _words(rng, s, rg, W)
    hs = tuple(_words(rng, s, r, W) for r in heights)
    filt = (_words(rng, s, W) | _words(rng, s, W)) if filtered else None
    return f, g, hs, filt


# Odometer shapes the CUDA kernels' 8-slot groups make edges of: K = 9 (an
# odd K across two groups), K = 1, E = 3, and 2 x 8 (a last extra of 8 rows
# after another: the shape whose prefix the CUDA kernels hoist), filtered
# and not.
NARY_CASES = KERNEL_CASES + [
    (s, rf, rg, heights, filtered)
    for s, rf, rg, heights in ((2, 8, 8, (9,)), (1, 8, 5, (1,)), (2, 8, 8, (2, 2, 2)),
                               (1, 8, 8, (2, 8)))
    for filtered in (False, True)
]


@pytest.mark.parametrize("s,rf,rg,heights,filtered", NARY_CASES)
def test_nary_stats_match_pallas(s, rf, rg, heights, filtered):
    f, g, hs, filt = _case(s, rf, rg, heights, filtered)
    got = K.nary_stats(_t(f), _t(g), tuple(map(_t, hs)), None if filt is None else _t(filt))
    want = np.asarray(JK.nary_stats(f, g, hs, filt, interpret=True))
    assert got.dtype == torch.int32 and tuple(got.shape) == (int(np.prod(heights)), rf, rg)
    np.testing.assert_array_equal(got.numpy(), want)
    if len(hs) == 1:
        tri = K.tri_stats(_t(f), _t(g), _t(hs[0]), None if filt is None else _t(filt))
        np.testing.assert_array_equal(
            tri.numpy(), np.asarray(JK.tri_stats(f, g, hs[0], filt, interpret=True)))
    if not filtered:
        per = K.nary_stats_pershard(_t(f), _t(g), tuple(map(_t, hs)))
        assert tuple(per.shape) == (int(np.prod(heights)), s, rf, rg)
        np.testing.assert_array_equal(
            per.numpy(), np.asarray(JK.nary_stats_pershard(f, g, hs, interpret=True)))


@pytest.mark.parametrize("s,rf,rg,heights,filtered", KERNEL_CASES)
def test_group_tile_stats_match_jax_with_padded_slots(s, rf, rg, heights, filtered):
    f, g, hs, filt = _case(s, rf, rg, heights, filtered)
    rng = np.random.default_rng(len(heights) + s)
    live = np.stack([rng.integers(0, r, 5) for r in heights], axis=1).astype(np.int32)
    # The JAX package's padded form: 5 live slots in an 8-slot bucket, the
    # padding replaying slot 0 under active = 0.
    rows_idx = np.concatenate([live, np.repeat(live[:1], 3, axis=0)])
    active = np.array([1] * 5 + [0] * 3, dtype=np.uint32)
    ft, gt, ht = _t(f), _t(g), tuple(map(_t, hs))
    ftt = None if filt is None else _t(filt)
    got = K.group_tile_stats(ft, gt, ht, rows_idx, active, ftt)
    want = np.asarray(JK.group_tile_stats(f, g, hs, rows_idx, active, filt))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[5:].any()
    per = K.group_tile_stats_pershard(ft, gt, ht, rows_idx, active)
    np.testing.assert_array_equal(
        per.numpy(), np.asarray(JK.group_tile_stats_pershard(f, g, hs, rows_idx, active)))
    # The tiles agree with the full odometer on the matching k slots.
    if not filtered:
        full = K.nary_stats(ft, gt, ht)
        for q in range(5):
            k = 0
            for t, r in enumerate(live[q]):
                k = k * heights[t] + int(r)
            assert torch.equal(got[q], full[k])


@pytest.mark.parametrize("heights,filtered", [((3, 5), False), ((9,), True), ((1,), False),
                                              ((2, 2, 2), True), ((3, 8), True)])
def test_nary_stats_is_group_tile_over_the_full_odometer(heights, filtered):
    """The identity the CUDA K6 and K7 rest on, checked on the plain
    versions (each is held against the JAX package elsewhere): the whole
    odometer, last extra fastest, as the slot table, every slot active,
    gives the tile kernels the same tensor. The kernels themselves are held
    against the plain versions by the cuda-marked tests."""
    f, g, hs, filt = _case(2, 8, 13, heights, filtered)
    ft, gt, ht = _t(f), _t(g), tuple(map(_t, hs))
    ftt = None if filt is None else _t(filt)
    table = np.array(list(np.ndindex(*heights)), dtype=np.int32).reshape(-1, len(heights))
    active = np.ones(len(table), dtype=np.int32)
    assert torch.equal(K.nary_stats(ft, gt, ht, ftt),
                       K.group_tile_stats(ft, gt, ht, table, active, ftt))
    assert torch.equal(K.nary_stats_pershard(ft, gt, ht),
                       K.group_tile_stats_pershard(ft, gt, ht, table, active))


@pytest.mark.parametrize("rf,rg", [(9, 8), (16, 13)])
@pytest.mark.parametrize("n_slots", [1, 3, 7])
@pytest.mark.parametrize("filtered", [False, True])
def test_group_tile_stats_slot_pairs_match_jax(rf, rg, n_slots, filtered):
    """The tensor-core K4 stacks slots in pairs along the MMA's M axis and
    takes F and G in 8-row tiles: odd slot counts (the last slot paired
    with nothing), inactive slots (every third), and Rf = 9 and 16."""
    f, g, hs, filt = _case(2, rf, rg, (3, 5), filtered)
    rng = np.random.default_rng(rf * 10 + n_slots)
    rows_idx = np.stack([rng.integers(0, r, n_slots) for r in (3, 5)], axis=1).astype(np.int32)
    active = np.array([int(q % 3 != 2) for q in range(n_slots)], dtype=np.uint32)
    got = K.group_tile_stats(_t(f), _t(g), tuple(map(_t, hs)), rows_idx, active,
                             None if filt is None else _t(filt))
    want = np.asarray(JK.group_tile_stats(f, g, hs, rows_idx, active, filt))
    assert tuple(got.shape) == (n_slots, rf, rg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[active == 0].any()


def test_group_wrappers_reject_bad_inputs():
    rng = np.random.default_rng(5)
    f, g = _t(_words(rng, 2, 8, 64)), _t(_words(rng, 2, 8, 64))
    h = _t(_words(rng, 2, 3, 64))
    ok = (np.array([[2]], np.int32), np.array([1], np.int32))
    with pytest.raises(ValueError, match="outside"):
        K.group_tile_stats(f, g, (h,), np.array([[3]], np.int32), [1])
    # An inactive slot's rows are never read, so they are not checked.
    assert not K.group_tile_stats(f, g, (h,), np.array([[3]], np.int32), [0]).any()
    with pytest.raises(ValueError, match="rows_idx"):
        K.group_tile_stats(f, g, (h,), np.zeros((1, 2), np.int32), [1])
    with pytest.raises(ValueError, match="active"):
        K.group_tile_stats_pershard(f, g, (h,), ok[0], [1, 1])
    with pytest.raises(ValueError, match="cap"):
        K.nary_stats(f, g, (h,) * (K.MAX_GROUP_EXTRAS + 1))
    with pytest.raises(ValueError, match="extra"):
        K.nary_stats_pershard(f, g, ())
    with pytest.raises(ValueError, match="disagrees"):
        K.nary_stats(f, g, (h[:1],))
    with pytest.raises(ValueError, match="disagrees"):
        K.group_tile_stats(f, g, (h,), *ok, filt=f[:, 0, :8].contiguous())
    big = torch.zeros((K.MAX_PAIR_SHARDS + 1, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 bound"):
        K.nary_stats(big, big, (big,))
    with pytest.raises(ValueError, match="int32 bound"):
        K.group_tile_stats(big, big, (big,), [[0]], [1])


# ---------------------------------------------------------------------------
# (b)-(d) CUDABackend.group_by against the JAX package and the CPU oracle
# ---------------------------------------------------------------------------

# bench.py's GroupBy queries (bench.py:2592-2595), over a small copy of its
# fields f, g (8 rows) and h (4 rows).
BENCH_QUERIES = [
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), filter=Row(f=2))",
    "GroupBy(Rows(f), Rows(g), Rows(h))",
]
MATRIX = QUERIES + WIDE_QUERIES + BENCH_QUERIES
TIME_RANGED = "GroupBy(Rows(t, from=2018-01-01T00:00, to=2019-01-01T00:00), Rows(a))"


def _build_bench_fields(holder, rng):
    idx = holder.index("i")
    for fname, nrows in (("f", 8), ("g", 8), ("h", 4)):
        field = idx.create_field(fname)
        for row in range(nrows):
            cols = np.unique(np.concatenate([
                rng.integers(0, 4096, 2000, dtype=np.uint64) + np.uint64(s * SHARD_WIDTH)
                for s in (0, 1)]))
            field.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)


def _densify(idx, rng, wide):
    """A dense block of 2048 columns in each of the two shards, where every
    live row of a, b, c, d (and e) holds each column with probability 1/2:
    the tile-test data alone is so sparse that most of its 3- and 4-field
    groups are empty."""
    cols = np.concatenate([np.arange(2048, dtype=np.uint64) + np.uint64(s * SHARD_WIDTH)
                           for s in (0, 1)])
    rows = {"a": range(1, 4), "b": range(1, 3), **LIVE}
    if wide:
        rows["e"] = range(70)
    for fname, live in rows.items():
        for row in live:
            mine = cols[rng.random(cols.size) < 0.5]
            idx.field(fname).import_bits(np.full(mine.size, row, dtype=np.uint64), mine)


def _build_both(tmp_path, wide=True):
    """The same index in a JAX Holder and a port Holder: the GroupBy
    tile-test data made denser, its wide field e, bench-like f/g/h and a
    time field."""
    jax_h = JaxHolder(str(tmp_path / "jax")).open()
    port_h = Holder(None).open()
    for h, opts in ((jax_h, jax_options_for_time), (port_h, options_for_time)):
        rng = np.random.default_rng(42)
        idx = build(h, rng)
        if wide:
            build_wide(idx, rng)
        _densify(idx, rng, wide)
        _build_bench_fields(h, rng)
        t = idx.create_field("t", opts("YMDH"))
        for col, row, when in ((3, 1, dt.datetime(2018, 3, 1)),
                               (SHARD_WIDTH + 5, 1, dt.datetime(2019, 6, 1)),
                               (7, 2, dt.datetime(2018, 7, 9))):
            t.set_bit(row, col, when)
            idx.field("a").set_bit(1, col)
    return jax_h, port_h


def _executors(jax_h, port_h, generic):
    """(port CUDABackend on the CPU, JAX TPUBackend, port CPU oracle)."""
    port_be = CUDABackend(port_h, device="cpu")
    jax_be = TPUBackend(jax_h)
    if generic:  # refuse every per-shard table: the generic tiled sweep serves
        port_be.MAX_PAIR_PERSHARD_BYTES = 1
        jax_be.MAX_PAIR_PERSHARD_BYTES = 1
    return (Executor(port_h, backend=port_be), JaxExecutor(jax_h, backend=jax_be),
            Executor(port_h, backend=CPUBackend(port_h)))


def _plain(results):
    return [[(tuple((fr.field, fr.row_id) for fr in g.group), g.count) for g in r]
            for r in results]


def _routed(call):
    return global_stats.counter_totals("cpu_routed_total").get(
        f'cpu_routed_total{{call="{call}"}}', 0)


def _counter(name):
    return sum(global_stats.counter_totals(name).values())


def _same(execs, q):
    dev, jax_dev, oracle = execs
    got = _plain(dev.execute("i", q))
    assert got == _plain(jax_dev.execute("i", q)), q
    assert got == _plain(oracle.execute("i", q)), q
    return got


@pytest.fixture(scope="module")
def holders(tmp_path_factory):
    jax_h, port_h = _build_both(tmp_path_factory.mktemp("groupby"))
    yield jax_h, port_h
    jax_h.close()
    port_h.close()


@pytest.fixture(scope="module", params=["maintained", "generic"])
def route(request, holders):
    return _executors(*holders, generic=request.param == "generic")


@pytest.mark.parametrize("q", MATRIX)
def test_groupby_matrix_equals_jax_and_oracle(route, q):
    routed = _routed("GroupBy")
    got = _same(route, q)
    assert got[0], q  # every query of the matrix has groups
    assert _routed("GroupBy") == routed, f"{q} left the card"


def test_routes_take_their_kernels(holders):
    """A cold unfiltered 3-field request sweeps K5 tiles (maintained
    table) and a repeat serves from it; the generic route and a filtered
    request sweep K4 tiles."""
    def launches(kind):
        return global_stats.counter_totals("device_launches_total").get(
            f'device_launches_total{{kind="{kind}"}}', 0)

    q = "GroupBy(Rows(f), Rows(g), Rows(h))"
    dev, _, _ = _executors(*holders, generic=False)
    per0, tile0 = launches("group_tile_pershard"), launches("group_tile")
    first = dev.execute("i", q)
    assert launches("group_tile_pershard") == per0 + 1 and launches("group_tile") == tile0
    hits = _counter("groupn_cache_hits_total")
    assert dev.execute("i", q) == first
    assert _counter("groupn_cache_hits_total") == hits + 1
    assert launches("group_tile_pershard") == per0 + 1
    dev.execute("i", "GroupBy(Rows(f), Rows(g), Rows(h), filter=Row(g=1))")
    assert launches("group_tile") == tile0 + 1
    gen, _, _ = _executors(*holders, generic=True)
    assert gen.execute("i", q) == first
    assert launches("group_tile") == tile0 + 2


@pytest.mark.parametrize("generic", [False, True])
def test_wide_field_spans_two_tiles(holders, generic):
    """70 live combinations > one 64-slot launch: two tiles, and the
    enumeration stays exact across the boundary."""
    execs = _executors(*holders, generic=generic)
    tiles = _counter("groupby_tiles_total")
    _same(execs, "GroupBy(Rows(a), Rows(b), Rows(e))")
    assert _counter("groupby_tiles_total") - tiles == 2


def test_time_ranged_child_is_routed_and_counted(holders):
    execs = _executors(*holders, generic=False)
    routed = _routed("GroupBy")
    assert _same(execs, TIME_RANGED)[0]
    assert _routed("GroupBy") == routed + 1


def test_too_many_extra_fields_are_routed_and_counted(tmp_path):
    """Past MAX_GROUP_EXTRAS extra fields the kernels' table is full: the
    backend refuses and the host iterator answers, counted."""
    port_h = Holder(None).open()
    idx = port_h.create_index("i")
    names = [f"x{i}" for i in range(K.MAX_GROUP_EXTRAS + 3)]
    for name in names:
        idx.create_field(name).import_bits(
            np.array([0, 1], dtype=np.uint64), np.array([5, SHARD_WIDTH + 5], dtype=np.uint64))
    q = "GroupBy({})".format(", ".join(f"Rows({n})" for n in names))
    dev = Executor(port_h, backend=CUDABackend(port_h, device="cpu"))
    routed = _routed("GroupBy")
    assert _plain(dev.execute("i", q)) == _plain(
        Executor(port_h, backend=CPUBackend(port_h)).execute("i", q))
    assert _routed("GroupBy") == routed + 1
    port_h.close()


def test_host_answered_topn_and_rows_are_counted(holders):
    """TopN with pinned ids and Rows pinned to a column have no device
    lowering: the host iterator answers them, counted; the plain forms
    stay on the card."""
    dev, _, oracle = _executors(*holders, generic=False)
    topn, rows = _routed("TopN"), _routed("Rows")
    for q in ("TopN(a, ids=[1, 2])", "Rows(c, column=3)"):
        assert dev.execute("i", q) == oracle.execute("i", q), q
    assert _routed("TopN") == topn + 1 and _routed("Rows") == rows + 1
    for q in ("TopN(a, n=2)", "Rows(c)"):
        assert dev.execute("i", q) == oracle.execute("i", q), q
    assert _routed("TopN") == topn + 1 and _routed("Rows") == rows + 1
    # The oracle itself is the host: nothing is counted for it.
    oracle.execute("i", "Rows(c, column=3)")
    assert _routed("Rows") == rows + 1


@pytest.mark.parametrize("generic", [False, True])
def test_write_churn_gives_fresh_answers(tmp_path, generic):
    """set_bit / clear_bit on c and a between queries: every answer is
    fresh and equal to the JAX package's and the oracle's."""
    jax_h, port_h = _build_both(tmp_path, wide=False)
    execs = _executors(jax_h, port_h, generic=generic)
    qs = ["GroupBy(Rows(a), Rows(b), Rows(c))",
          "GroupBy(Rows(a), Rows(b), Rows(c), Rows(d), limit=6)",
          "GroupBy(Rows(a), Rows(b), Rows(c), filter=Row(a=1))"]
    before = [_same(execs, q) for q in qs]
    for k in range(3):
        for h in (jax_h, port_h):
            idx = h.index("i")
            idx.field("c").set_bit(LIVE["c"][k % 3], 444_000 + k)
            idx.field("a").set_bit(1 + k % 3, 444_000 + k)
            # Row 4 of c was empty (pruned): a write makes a new group.
            for fname, row in (("a", 1), ("b", 1), ("c", 4)):
                idx.field(fname).set_bit(row, SHARD_WIDTH + 11)
            idx.field("a").clear_bit(1, 3)
        for q in qs:
            _same(execs, q)
    after = [_same(execs, q) for q in qs]
    assert after != before
    assert any(g[0][-1] == ("c", 4) for g in after[0][0])
    jax_h.close()
    port_h.close()


def test_pruning_and_tile_counters(holders):
    """8 x 8 nominal extra rows (c and d pad to 8), 3 x 2 live: 58
    combinations pruned before any tile, one tile of 6 slots."""
    dev, _, _ = _executors(*holders, generic=True)
    pruned, tiles = _counter("groupby_pruned_groups_total"), _counter("groupby_tiles_total")
    dev.execute("i", "GroupBy(Rows(a), Rows(b), Rows(c), Rows(d))")
    assert _counter("groupby_pruned_groups_total") - pruned == 8 * 8 - 3 * 2
    assert _counter("groupby_tiles_total") - tiles == 1
    assert "groupby_tile_occupancy" in global_stats.histogram_snapshot()


def test_filtered_tensor_cache_hits_and_invalidates(tmp_path):
    """A filtered tensor is cached on the filter's fields' generations: a
    repeat hits, a write to a field only the filter reads misses."""
    jax_h, port_h = _build_both(tmp_path, wide=False)
    execs = _executors(jax_h, port_h, generic=False)
    q = "GroupBy(Rows(a), Rows(b), Rows(c), filter=Row(d=5))"
    _same(execs, q)
    hits = _counter("agg_cache_hits_total")
    _same(execs, q)
    assert _counter("agg_cache_hits_total") == hits + 1
    assert global_stats.gauge_value("agg_cache_bytes") > 0
    for h in (jax_h, port_h):
        h.index("i").field("d").set_bit(5, SHARD_WIDTH + 77)
    hits = _counter("agg_cache_hits_total")
    _same(execs, q)
    assert _counter("agg_cache_hits_total") == hits
    jax_h.close()
    port_h.close()
