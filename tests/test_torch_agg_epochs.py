"""Write epochs absorbed on the host by the port's GroupN, Sum and Min/Max
tables (pilosa_tpu_torch/exec/cuda.py: _groupn_try_incremental,
_groupn_shard_delta, _host_slab_groupn, _sum_try_incremental,
_minmax_try_incremental), held against the JAX package's TPUBackend.

One holder directory is written by the JAX package from a numpy seed and
carried across with carry.open_reference_holder. Both backends serve the
same requests through the same seeded write epochs, each built to take one
branch of the tiers (a point write on one field, writes to two fields of one
shard, a bulk import, row growth, a deleted and a recreated fragment, a
write outside the queried shards, the two budget gates, better, worse and
equal values, a cleared extremum, a tie, import_value, a ring overrun).
After every epoch the answers and the tier counters must equal the JAX
backend's. Then each race guard of the tiers is driven on its own, on a
holder of the port.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.core.field import options_for_int as jax_options_for_int
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec import tpu as jax_tpu
from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu.utils.stats import global_stats as jax_stats
from pilosa_tpu_torch.carry import open_reference_holder
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.field import options_for_int
from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT, Fragment
from pilosa_tpu_torch.core.view import bsi_view_name
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec import cuda
from pilosa_tpu_torch.exec.cpu import CPUBackend
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.ops.blocks import WORDS_PER_SHARD
from pilosa_tpu_torch.ops.kernels import (
    group_tile_stats_pershard_torch,
    nary_stats_pershard_torch,
)
from pilosa_tpu_torch.roaring.bitmap import Bitmap
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.stats import global_stats

SW = SHARD_WIDTH
N_SHARDS = 3
# Set fields and their rows: f and g 0..5, h 0..2, k 0..1 (stacks of 8),
# BITS_PER_ROW random columns a row over the shards, and in every shard
# the PLANTED columns in one row of every field.
SET_ROWS = {"f": 6, "g": 6, "h": 3, "k": 2}
BITS_PER_ROW = 4000
PLANTED = np.arange(0, 128, 2, dtype=np.uint64)

GN3 = "GroupBy(Rows(f), Rows(g), Rows(h))"
GN4 = "GroupBy(Rows(f), Rows(g), Rows(h), Rows(k))"
AGGS = ["Sum(field=v)", "Min(field=v)", "Max(field=v)", "Sum(field=w)", "Max(field=w)"]
FILTERED = ["Sum(Row(f=1), field=v)", "Min(Row(g=2), field=v)", "Max(Row(h=3), field=v)"]
QUERIES = [GN3] + AGGS
# The epochs that also send the 4-field GroupBy (its table is 8 times the
# 3-field one's) and the filtered aggregates (a sweep each, every time):
# the others leave them out to keep the file quick.
FOUR_FIELD_EPOCHS = ("cold", "point write on one field", "point writes on h in two shards",
                     "two fields of one shard", "past the slab word budget",
                     "within the budgets again")
FILTERED_EPOCHS = ("cold", "better value", "cleared extremum", "import_value", "ring overrun")

TIER_COUNTERS = (
    "groupn_incremental_updates_total", "groupn_incremental_shards_total",
    "groupn_delta_ops_total", "groupn_cache_hits_total",
    "sum_incremental_updates_total", "minmax_incremental_updates_total",
    "minmax_shard_rederives_total", "agg_cache_hits_total",
)
TIERS = ('tier="groupn"', 'tier="sum"', 'tier="minmax"')


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in about half the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tier_counters(stats) -> dict:
    out = {name: sum(stats.counter_totals(name).values()) for name in TIER_COUNTERS}
    for name in ("version_walk_total", "version_walk_shards_total"):
        for k, v in stats.counter_totals(name).items():
            if any(t in k for t in TIERS):
                out[k] = v
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)
            if after.get(k, 0) != before.get(k, 0)}


def _port_counter(name: str) -> float:
    return sum(global_stats.counter_totals(name).values())


def _launches(kind: str) -> float:
    return global_stats.counter_totals("device_launches_total").get(
        f'device_launches_total{{kind="{kind}"}}', 0)


def _write_data(h, rng, int_options):
    """Set fields f, g, h, k (BITS_PER_ROW random columns a row over the
    shards, column PLANTED[j] of every shard in row j of every field,
    modulo its rows) and int fields v (200 values in [-900, 900], base 0) and w (120 values
    in [200, 4000], base 100)."""
    idx = h.create_index("i")
    for name, rows in SET_ROWS.items():
        fld = idx.create_field(name)
        for row in range(rows):
            cols = np.unique(rng.integers(0, N_SHARDS * SW, BITS_PER_ROW, dtype=np.uint64))
            fld.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
        for shard in range(N_SHARDS):
            fld.import_bits(np.arange(PLANTED.size, dtype=np.uint64) % np.uint64(rows),
                            PLANTED + np.uint64(shard * SW))
    for name, lo, hi, n, vlo, vhi in (("v", -1000, 1000, 200, -900, 900),
                                      ("w", 100, 5000, 120, 200, 4000)):
        fld = idx.create_field(name, int_options(lo, hi))
        cols = np.unique(rng.integers(0, N_SHARDS * SW, n, dtype=np.uint64))
        fld.import_value(cols, rng.integers(vlo, vhi + 1, cols.size))


def _slabs(rng, rs, w, density):
    out = []
    for r in rs:
        bits = (rng.random((r, w, 32)) < density).astype(np.uint8)
        out.append(np.packbits(bits, axis=-1, bitorder="little").view(np.uint32).reshape(r, w))
    return out


# ---------------------------------------------------------------------------
# the host row against K7's and K5's plain forms and the JAX function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rs,w,densities", [([8, 8, 8], 1024, (0.0, 0.05, 0.5)),
                                            ([8, 8, 4, 3], 1024, (0.0, 0.05, 0.5)),
                                            ([24, 32, 2], WORDS_PER_SHARD, (0.5,)),
                                            ([3, 5, 2, 2], 100, (0.0, 0.05, 0.5)),
                                            ([1, 1, 1], 7, (0.05, 1.0))])
def test_host_slab_groupn_equals_plain_kernels_and_jax(rs, w, densities):
    """rf * rg = 768 at a shard's W words takes two word chunks of the AND."""
    rng = np.random.default_rng(sum(rs) * 100 + len(rs))
    chunk = max(1, (64 << 20) // max(1, rs[0] * rs[1] * 4))
    assert (w > chunk) == (rs[:2] == [24, 32])
    k_total = int(np.prod(rs[2:]))
    for density in densities:
        slabs = _slabs(rng, rs, w, density)
        got = cuda._host_slab_groupn(slabs, rs)
        assert got.dtype == np.int32 and got.shape == (k_total * rs[0] * rs[1],)
        t = [torch.from_numpy(s.view(np.int32))[None] for s in slabs]
        k7 = nary_stats_pershard_torch(t[0], t[1], tuple(t[2:]))  # [K, 1, rf, rg]
        assert np.array_equal(got, k7[:, 0].numpy().reshape(-1))
        # K5 over every combination, in odometer order (last field fastest).
        grids = np.meshgrid(*[np.arange(r) for r in rs[2:]], indexing="ij")
        combos = np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)
        k5 = group_tile_stats_pershard_torch(t[0], t[1], tuple(t[2:]), combos,
                                             np.ones(len(combos), np.int32))
        assert np.array_equal(got, k5[:, 0].numpy().reshape(-1))
        assert np.array_equal(got, jax_tpu._host_slab_groupn(slabs, rs))


def test_minmax_reduce_keeps_the_tie_rule():
    """The cross-shard reduce equals the JAX package's on ties, empty
    shards and both kinds."""
    tables = [
        ((5, 1), (5, 2), (0, 0), (3, 4)),
        ((0, 0), (0, 0)),
        ((-7, 1), (9, 1), (-7, 3), (9, 2)),
        ((0, 2), (0, 0), (-1, 1)),
    ]
    for kind in ("bsi_min", "bsi_max"):
        for tab in tables:
            assert (CUDABackend._minmax_reduce(kind, tab)
                    == TPUBackend._minmax_reduce(kind, list(tab)))


# ---------------------------------------------------------------------------
# seeded epochs, port against the JAX TPUBackend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX oracle, JAX TPUBackend executor, port oracle, port executor,
    JAX backend, port backend, JAX holder, port holder)."""
    src = str(tmp_path_factory.mktemp("jax_written"))
    jh = JaxHolder(src).open()
    _write_data(jh, np.random.default_rng(21), jax_options_for_int)
    jh.close()
    dst = str(tmp_path_factory.mktemp("carried")) + "/data"
    shutil.copytree(src, dst)
    jh = JaxHolder(src).open()
    th = open_reference_holder(dst)
    jdev_b, tdev_b = TPUBackend(jh), CUDABackend(th, device="cpu")
    yield (JaxExecutor(jh), JaxExecutor(jh, backend=jdev_b), Executor(th, backend=CPUBackend(th)),
           Executor(th, backend=tdev_b), jdev_b, tdev_b, jh, th)
    jh.close()
    th.close()


def _both_holders(fn):
    def apply(jh, th):
        fn(jh)
        fn(th)
    return apply


def _import(field, row, cols):
    cols = np.asarray(cols, dtype=np.uint64)
    return _both_holders(lambda h: h.index("i").field(field).import_bits(
        np.full(cols.size, row, dtype=np.uint64), cols))


def _import_values(field, cols, vals):
    cols = np.asarray(cols, dtype=np.uint64)
    vals = np.asarray(vals, dtype=np.int64)
    return _both_holders(lambda h: h.index("i").field(field).import_value(cols, vals))


def _set_values(field, pairs):
    def apply(h):
        fld = h.index("i").field(field)
        for col, val in pairs:
            fld.set_value(col, val)
    return _both_holders(apply)


def _delete_fragment(field, shard, view="standard"):
    return _both_holders(
        lambda h: h.index("i").field(field).view(view).delete_fragment(shard))


def _row_in(th, field, row, shard):
    return th.index("i").field(field).view("standard").fragment(shard).row(row)


def _grouped_column(th, shard, field, row, member=False):
    """A column of `shard` in some row of every other set field, in
    `field`=`row` when `member` else not: setting (or clearing) that bit
    moves both N-field tables."""
    rows = {name: [_row_in(th, name, r, shard) for r in range(n)]
            for name, n in SET_ROWS.items() if name != field}
    own = _row_in(th, field, row, shard)
    for r in [own] if member else rows[next(iter(rows))]:
        for col in r.columns():
            col = int(col)
            if own.includes_column(col) == member and all(
                    any(x.includes_column(col) for x in rows[n]) for n in rows):
                return col
    raise AssertionError("no grouped column")


def _values(th, field):
    """{column: value} of an int field, from the port's fragments."""
    fld = th.index("i").field(field)
    depth = fld.bsi_group().bit_depth
    base = fld.bsi_group().base
    v = fld.view(bsi_view_name(field))
    out = {}
    for s in range(N_SHARDS):
        fr = v.fragment(s) if v is not None else None
        if fr is None:
            continue
        for col in fr.row(BSI_EXISTS_BIT).columns():
            val, ok = fr.value(int(col), depth)
            if ok:
                out[int(col)] = val + base
    return out


def _free_column(th, shard, taken):
    """A column of `shard` with no value of v or w, not in `taken`."""
    vals = set(_values(th, "v")) | set(_values(th, "w")) | set(taken)
    col = shard * SW + 7
    while col in vals:
        col += 1
    taken.add(col)
    return col


def _extreme(th, field, pick, shard=None):
    """(column, value) of the field's extreme value (of one shard)."""
    vals = {c: x for c, x in _values(th, field).items()
            if shard is None or c // SW == shard}
    best = pick(vals.values())
    return min(c for c, x in vals.items() if x == best), best


def _epochs(th):
    """(name, writes, shards or None, expected port counter moves). A write
    is a PQL string, run by both oracles, or a callable on both holders.
    Epochs are built lazily (each reads the data its predecessors left)."""
    taken: set = set()
    yield ("cold", [], None, {})
    yield ("point write on one field", [f"Set({_grouped_column(th, 1, 'f', 1)}, f=1)"], None,
           {"groupn_delta_ops_total": 2, "groupn_incremental_updates_total": 2})
    yield ("point writes on h in two shards",
           [f"Set({_grouped_column(th, 0, 'h', 2)}, h=2)",
            f"Clear({_grouped_column(th, 2, 'h', 1, member=True)}, h=1)"],
           None, {"groupn_delta_ops_total": 4, "groupn_incremental_shards_total": 4})
    yield ("two fields of one shard", [f"Set({SW + 200}, f=3)", f"Set({SW + 201}, g=2)"], None,
           {"groupn_incremental_shards_total": 2})
    yield ("past the slab word budget", [_import("k", 2, [2 * SW + 45])], "words",
           {"groupn_incremental_updates_total": 0})
    yield ("within the budgets again", [_import("f", 0, [77])], None,
           {"groupn_incremental_updates_total": 2})
    yield ("bulk import", [_import("h", 1, [5, 6, 900])], None,
           {"groupn_incremental_shards_total": 1})
    yield ("deleted fragment", [_delete_fragment("h", 2)], None,
           {"groupn_incremental_shards_total": 1})
    yield ("created fragment", [f"Set({2 * SW + 3}, h=1)"], None,
           {"groupn_incremental_shards_total": 1})
    yield ("deleted and recreated in one epoch", [_delete_fragment("h", 1), f"Set({SW + 3}, h=1)"],
           None, {"groupn_incremental_shards_total": 1, "groupn_delta_ops_total": 0})
    yield ("row growth past the table", [f"Set({SW + 300}, g=9)"], None,
           {"groupn_incremental_updates_total": 0})
    yield ("another shard set", [], [0, 1], {})
    yield ("write outside the shard set",
           [f"Set({2 * SW + 20}, f=1)", f"Set({_free_column(th, 2, taken)}, v=11)"],
           [0, 1], {"groupn_incremental_updates_total": 0})
    yield ("all shards again", [], None, {})
    yield ("past the host-update cutoff",
           [_import("h", 3, [44, SW + 44])], "cutoff",
           {"groupn_incremental_updates_total": 0})
    c_new = _free_column(th, 0, taken)
    yield ("better value", [f"Set({c_new}, v=-999)"], None,
           {"sum_incremental_updates_total": 1, "minmax_incremental_updates_total": 2})
    yield ("worse value", [f"Set({_free_column(th, 1, taken)}, v=3)"], None,
           {"sum_incremental_updates_total": 1, "minmax_shard_rederives_total": 0})
    c_max, v_max = _extreme(th, "v", max)
    other = (c_max // SW + 1) % N_SHARDS
    c_tie = _free_column(th, other, taken)
    yield ("equal value in another shard, a tie", [f"Set({c_tie}, v={v_max})"], None,
           {"minmax_shard_rederives_total": 0})
    yield ("cleared extremum", [f"Clear({c_tie}, v=0)"], None,
           {"minmax_shard_rederives_total": 1})
    c_min, _ = _extreme(th, "v", min)
    yield ("extremum overwritten", [f"Set({c_min}, v=500)"], None,
           {"minmax_shard_rederives_total": 1})
    yield ("import_value", [_import_values("v", [SW + 11, SW + 12], [-5, 950])], None,
           {"sum_incremental_updates_total": 0, "minmax_shard_rederives_total": 2})
    ring = [(2 * SW + 1000 + j, (j % 50) - 25) for j in range(Fragment.BIT_OPS_MAX + 8)]
    yield ("ring overrun", [_set_values("v", ring)], None,
           {"sum_incremental_updates_total": 0, "minmax_shard_rederives_total": 2})
    gone = _extreme(th, "v", max)[0] // SW  # the shard of v's maximum
    yield ("deleted BSI fragment", [_delete_fragment("v", gone, bsi_view_name("v"))], None,
           {"sum_incremental_updates_total": 0, "minmax_incremental_updates_total": 2})
    yield ("created BSI fragment", [f"Set({gone * SW + 77}, v=-998)"], None,
           {"sum_incremental_updates_total": 0, "minmax_shard_rederives_total": 2})
    yield ("BSI fragment deleted and recreated in one epoch",
           [_delete_fragment("v", 1, bsi_view_name("v")), f"Set({SW + 77}, v=-997)"], None,
           {"sum_incremental_updates_total": 0, "minmax_shard_rederives_total": 2})
    w_max, wv = _extreme(th, "w", max)
    yield ("base 100: better and cleared", [f"Set({_free_column(th, 2, taken)}, w=4999)",
                                            f"Clear({w_max}, w=0)"], None,
           {"sum_incremental_updates_total": 1, "minmax_incremental_updates_total": 1})


def _answers(execs, q, shards):
    jcpu, jdev, tcpu, tdev = execs
    return (
        [jax_json(r) for r in jcpu.execute("i", q, shards=shards)],
        [jax_json(r) for r in jdev.execute("i", q, shards=shards)],
        [result_to_json(r) for r in tcpu.execute("i", q, shards=shards)],
        [result_to_json(r) for r in tdev.execute("i", q, shards=shards)],
    )


def test_epochs_equal_jax_answers_and_tier_counters(both):
    jcpu, jdev, tcpu, tdev, jdev_b, tdev_b, jh, th = both
    execs = (jcpu, jdev, tcpu, tdev)
    seen = set()
    for name, writes, shards, expect in _epochs(th):
        for w in writes:
            if isinstance(w, str):
                assert jcpu.execute("i", w) == tcpu.execute("i", w), (name, w)
            else:
                w(jh, th)
        gate = {"cutoff": "MAX_PAIR_HOST_UPDATE_SHARDS",
                "words": "MAX_GROUPN_HOST_SLAB_WORDS"}.get(shards if isinstance(shards, str)
                                                           else None)
        if gate is not None:
            shards = None
            for b in (jdev_b, tdev_b):
                setattr(b, gate, 1)
        j0, t0 = _tier_counters(jax_stats), _tier_counters(global_stats)
        swept0 = {k: _launches(k) for k in ("group_tile_pershard", "bsi_sum", "bsi_min",
                                             "bsi_max")}
        routed = _port_counter("cpu_routed_total")
        try:
            filtered = FILTERED if name in FILTERED_EPOCHS else []
            for q in QUERIES + ([GN4] if name in FOUR_FIELD_EPOCHS else []) + filtered:
                want, jgot, tgot_cpu, got = _answers(execs, q, shards)
                assert jgot == want and tgot_cpu == want, (name, q)
                assert got == want, (name, q)
        finally:
            if gate is not None:
                for b in (jdev_b, tdev_b):
                    delattr(b, gate)
        jd = _delta(_tier_counters(jax_stats), j0)
        td = _delta(_tier_counters(global_stats), t0)
        assert td == jd, name
        assert _port_counter("cpu_routed_total") == routed, name
        for k, v in expect.items():
            assert td.get(k, 0) == v, (name, k, td)
        swept = {k: _launches(k) - n for k, n in swept0.items()}
        # Filtered aggregates are never cached: each sends one sweep.
        agg_swept = [swept[k] - (1 if filtered else 0) for k in ("bsi_sum", "bsi_min", "bsi_max")]
        assert min(agg_swept) >= 0, name
        if "groupn_incremental_updates_total" in td and not swept["group_tile_pershard"]:
            seen.add(name)
        if ("sum_incremental_updates_total" in td or "minmax_incremental_updates_total" in td) \
                and not any(agg_swept):
            seen.add(name)
        if name == "write outside the shard set":
            assert not swept["group_tile_pershard"], "a re-key swept"
    assert {"point write on one field", "point writes on h in two shards",
            "two fields of one shard", "bulk import", "deleted fragment",
            "created fragment", "deleted and recreated in one epoch",
            "within the budgets again", "better value", "worse value",
            "equal value in another shard, a tie", "cleared extremum",
            "extremum overwritten"} <= seen


def test_tables_equal_a_fresh_sweep_after_the_epochs(both):
    """After the epochs, the absorbed tables equal a cold sweep's on a new
    backend over the same holder."""
    *_, tdev_b, _, th = both
    tdev = Executor(th, backend=tdev_b)
    for q in (GN3, "Sum(field=v)", "Min(field=v)", "Max(field=v)"):
        tdev.execute("i", q)
    fresh = CUDABackend(th, device="cpu")
    fdev = Executor(th, backend=fresh)
    for q in (GN3, "Sum(field=v)", "Min(field=v)", "Max(field=v)"):
        assert fdev.execute("i", q) == tdev.execute("i", q), q
    for key, cold in fresh._groupn_cache.items():
        ent = tdev_b._groupn_cache[key]
        assert ent.rs == cold.rs and np.array_equal(ent.pershard, cold.pershard), key
        assert np.array_equal(ent.stats, cold.stats)
    for kind in ("sum", "bsi_min", "bsi_max"):
        got, cold = tdev_b._agg_cache[(kind, "i", "v")], fresh._agg_cache[(kind, "i", "v")]
        assert got[1] == cold[1]
        assert got[2][:-1] == cold[2][:-1], kind  # the tier's state; versions may differ


# ---------------------------------------------------------------------------
# the race guards, one at a time, on a holder of the port
# ---------------------------------------------------------------------------


@pytest.fixture
def port():
    """(port holder, device executor, its backend, CPU oracle executor)."""
    h = Holder(None).open()
    _write_data(h, np.random.default_rng(8), options_for_int)
    backend = CUDABackend(h, device="cpu")
    yield h, Executor(h, backend=backend), backend, Executor(h, backend=CPUBackend(h))
    h.close()


def _same(dev, oracle, q):
    got = dev.execute("i", q)
    assert got == oracle.execute("i", q), q
    return got


def _frag(h, field, shard, view="standard"):
    return h.index("i").field(field).view(view).fragment(shard)


def test_write_racing_the_walk_on_another_field_takes_the_slab_tier(port, monkeypatch):
    """The probe confirmation before the probes: f's epoch is replayed
    against g's and h's storage, which the entry records at their walk
    versions. An h write landing between the walk and the probes must send
    the shard to the slab tier: probing h would count the cell here and
    again in h's own delta."""
    h, dev, backend, oracle = port
    _same(dev, oracle, GN3)
    col = _grouped_column(h, 2, 'f', 1)
    h.index("i").field("f").set_bit(1, col)
    real = CUDABackend._epoch_versions
    calls = []

    def walk(self, fld, *args, **kw):
        out = real(self, fld, *args, **kw)
        calls.append(fld.name)
        if fld.name == "h" and calls.count("h") == 1:
            h.index("i").field("h").set_bit(3, col)
        return out

    probed = _frag(h, "h", 2).storage
    real_contains = Bitmap.contains
    probes = []

    def contains(self, v):
        if self is probed:
            probes.append(v)
        return real_contains(self, v)

    monkeypatch.setattr(CUDABackend, "_epoch_versions", walk)
    monkeypatch.setattr(Bitmap, "contains", contains)
    delta_ops = _port_counter("groupn_delta_ops_total")
    shards = _port_counter("groupn_incremental_shards_total")
    _same(dev, oracle, GN3)
    assert probes == [], "probed h after it moved since the walk"
    assert _port_counter("groupn_delta_ops_total") == delta_ops
    assert _port_counter("groupn_incremental_shards_total") == shards + 1
    monkeypatch.setattr(CUDABackend, "_epoch_versions", real)
    _same(dev, oracle, GN3)


def test_write_racing_the_probes_reverts_the_row(port, monkeypatch):
    """The probe confirmation after the probes: an h write during the
    membership probes is seen, the shard's row goes back to the old
    entry's and the slab tier derives it."""
    h, dev, backend, oracle = port
    _same(dev, oracle, GN3)
    col = _grouped_column(h, 1, 'f', 2)
    h.index("i").field("f").set_bit(2, col)
    real = Bitmap.contains
    fired = []
    probed = _frag(h, "h", 1).storage

    def contains(self, v):
        if self is probed and not fired:
            fired.append(1)
            h.index("i").field("h").set_bit(3, col)
        return real(self, v)

    monkeypatch.setattr(Bitmap, "contains", contains)
    delta_ops = _port_counter("groupn_delta_ops_total")
    got = dev.execute("i", GN3)
    monkeypatch.setattr(Bitmap, "contains", real)
    assert fired
    assert got == oracle.execute("i", GN3)
    assert _port_counter("groupn_delta_ops_total") == delta_ops
    _same(dev, oracle, GN3)


def test_groupn_sweep_over_a_racing_write_is_recorded_stale(port, monkeypatch):
    """_VERS_STALE for the GroupN table: a write during K5's sweep is
    confirmed through the journal (_confirm_vers_journal), its shard
    recorded stale, and the next epoch re-derives it from its slab
    instead of replaying the op onto content that may hold it."""
    h, dev, backend, oracle = port
    real = cuda.group_tile_stats_pershard
    fired = []
    col = _grouped_column(h, 1, 'f', 4)

    def launch(*args, **kw):
        out = real(*args, **kw)
        if not fired:
            fired.append(1)
            h.index("i").field("f").set_bit(4, col)
        return out

    monkeypatch.setattr(cuda, "group_tile_stats_pershard", launch)
    dev.execute("i", GN3)
    monkeypatch.setattr(cuda, "group_tile_stats_pershard", real)
    ent = backend._groupn_cache[("groupn", "i", ("f", "g", "h"))]
    assert ent.vers[0][1] == cuda._VERS_STALE
    delta_ops = _port_counter("groupn_delta_ops_total")
    updates = _port_counter("groupn_incremental_updates_total")
    _same(dev, oracle, GN3)
    assert _port_counter("groupn_incremental_updates_total") == updates + 1
    assert _port_counter("groupn_delta_ops_total") == delta_ops
    fr = _frag(h, "f", 1)
    assert backend._groupn_cache[("groupn", "i", ("f", "g", "h"))].vers[0][1] == (fr.uid, fr.version)


@pytest.mark.parametrize("q,wrapper", [("Sum(field=v)", "row_popcounts"),
                                       ("Min(field=v)", "bsi_minmax"),
                                       ("Max(field=v)", "bsi_minmax")])
def test_aggregate_sweep_over_a_racing_write_is_recorded_stale(port, monkeypatch, q, wrapper):
    """_VERS_STALE for the Sum and Min/Max tables: a value write during the
    sweep leaves its shard stale, and the next epoch does not replay the
    write's op onto content that holds it (Sum sweeps again, Min/Max
    re-derives the shard)."""
    h, dev, backend, oracle = port
    real = getattr(cuda, wrapper)
    fired = []

    def launch(*args, **kw):
        out = real(*args, **kw)
        if not fired:
            fired.append(1)
            h.index("i").field("v").set_value(2 * SW + 4321, -990)
        return out

    monkeypatch.setattr(cuda, wrapper, launch)
    dev.execute("i", q)  # cold: the sweep, a write racing it
    monkeypatch.setattr(cuda, wrapper, real)
    assert fired
    kind = {"Sum": "sum", "Min": "bsi_min", "Max": "bsi_max"}[q[:3]]
    assert backend._agg_cache[(kind, "i", "v")][2][-1][2] == cuda._VERS_STALE
    rederived = _port_counter("minmax_shard_rederives_total")
    sums = _port_counter("sum_incremental_updates_total")
    n = _launches(kind if kind != "sum" else "bsi_sum")
    _same(dev, oracle, q)
    if kind == "sum":
        # The stale shard matches no op window: the sweep runs again.
        assert _port_counter("sum_incremental_updates_total") == sums
        assert _launches("bsi_sum") == n + 1
    else:
        assert _port_counter("minmax_shard_rederives_total") == rederived + 1
        assert _launches(kind) == n
    fr = _frag(h, "v", 2, bsi_view_name("v"))
    assert backend._agg_cache[(kind, "i", "v")][2][-1][2] == (fr.uid, fr.version)
    _same(dev, oracle, q)


def test_rederive_reads_its_version_under_the_scans_lock(port, monkeypatch):
    """The re-derive's version is read under the lock its scan holds: a
    write that starts during the scan waits for both, so the recorded
    version never precedes content the scan saw. A write that slipped in
    between would be replayed next epoch, counting its value twice."""
    h, dev, backend, oracle = port
    v = h.index("i").field("v")
    _same(dev, oracle, "Max(field=v)")
    _same(dev, oracle, "Max(field=v)")
    c_max, _ = _extreme(h, "v", max)
    shard = c_max // SW
    v.set_value(c_max, -5)  # clears the extremum of its shard: a re-derive
    real = Fragment.max
    racer = []

    def scan(self, filt, depth):
        if not racer:
            t = threading.Thread(target=lambda: v.set_value(shard * SW + 9999, 999))
            racer.append(t)
            t.start()
            t.join(0.3)  # blocked on the fragment's lock, which the tier holds
        return real(self, filt, depth)

    monkeypatch.setattr(Fragment, "max", scan)
    dev.execute("i", "Max(field=v)")
    monkeypatch.setattr(Fragment, "max", real)
    racer[0].join(10)
    assert _port_counter("minmax_shard_rederives_total") > 0
    got = _same(dev, oracle, "Max(field=v)")
    assert got[0].val == 999 and got[0].count == 1


def test_inconsistent_table_row_is_rederived(port):
    """A shard whose table row cannot be the state its ops start from (a
    cleared value better than its extremum, or a clear on a row with no
    count) is re-derived by the host walk instead of being updated: an
    update would carry the wrong row on."""
    h, dev, backend, oracle = port
    _same(dev, oracle, "Max(field=v)")
    key = ("bsi_max", "i", "v")
    cfp, result, (table, vers) = backend._agg_cache[key]
    shard = max(range(N_SHARDS), key=lambda s: table[s][0])
    bad = list(table)
    bad[shard] = (0, 0)  # the shard's row lost its values
    backend._agg_cache[key] = (cfp, result, (tuple(bad), vers))
    col, _ = _extreme(h, "v", max, shard)
    h.index("i").field("v").set_value(col, -999)  # a clear of the row's old value
    rederived = _port_counter("minmax_shard_rederives_total")
    _same(dev, oracle, "Max(field=v)")
    assert _port_counter("minmax_shard_rederives_total") == rederived + 1


def test_tables_are_copied_never_changed(port):
    """An absorbed epoch makes new tables; the old entries' stay as they
    were (another thread may still be reading them)."""
    h, dev, backend, oracle = port
    _same(dev, oracle, GN3)
    for q in ("Min(field=v)", "Sum(field=v)"):
        _same(dev, oracle, q)
        _same(dev, oracle, q)
    old = backend._groupn_cache[("groupn", "i", ("f", "g", "h"))]
    old_min = backend._agg_cache[("bsi_min", "i", "v")]
    table, totals, min_table = old.pershard.copy(), old.stats.copy(), list(old_min[2][0])
    h.index("i").field("f").set_bit(1, _grouped_column(h, 1, 'f', 1))
    h.index("i").field("g").set_bit(2, 2 * SW + 31)
    h.index("i").field("v").set_value(SW + 5, -999)
    _same(dev, oracle, GN3)
    _same(dev, oracle, "Min(field=v)")
    new = backend._groupn_cache[("groupn", "i", ("f", "g", "h"))]
    assert new is not old and new.pershard is not old.pershard
    assert np.array_equal(old.pershard, table) and np.array_equal(old.stats, totals)
    assert list(old_min[2][0]) == min_table
    assert backend._agg_cache[("bsi_min", "i", "v")][2][0] != old_min[2][0]


def test_one_groupn_update_an_epoch_packs_without_the_lock(port, monkeypatch):
    """The ("groupn", ...) single flight: concurrent requests after an
    epoch; one thread updates the table inside the latch, packing without
    _pair_lock; the others wait and hit the stored entry."""
    h, dev, backend, oracle = port
    _same(dev, oracle, GN3)
    h.index("i").field("f").set_bit(3, SW + 12)
    h.index("i").field("g").set_bit(3, SW + 12)  # two fields: the slab tier packs
    real = cuda._pack_confirmed
    ckey = ("groupn", "i", ("f", "g", "h"))
    states = []

    def pack(fr, n_rows):
        states.append((backend._pair_lock.locked(), ckey in backend._stats_updating))
        return real(fr, n_rows)

    monkeypatch.setattr(cuda, "_pack_confirmed", pack)
    want = oracle.execute("i", GN3)
    updates = _port_counter("groupn_incremental_updates_total")
    hits = _port_counter("groupn_cache_hits_total")
    start = threading.Barrier(6)
    out = []

    def reader():
        start.wait()
        out.append(dev.execute("i", GN3))

    threads = [threading.Thread(target=reader) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out == [want] * 6
    assert states and all(s == (False, True) for s in states)
    assert _port_counter("groupn_incremental_updates_total") == updates + 1
    assert _port_counter("groupn_cache_hits_total") == hits + 5


def test_filtered_aggregates_are_never_cached(port):
    """A filtered Sum, Min or Max depends on the filter's fields: it is
    never stored, and a repeat sweeps again."""
    h, dev, backend, oracle = port
    for q, kind in (("Sum(Row(f=1), field=v)", "bsi_sum"), ("Min(Row(g=2), field=v)", "bsi_min"),
                    ("Max(Row(h=1), field=v)", "bsi_max")):
        n = _launches(kind)
        _same(dev, oracle, q)
        _same(dev, oracle, q)
        assert _launches(kind) == n + 2, q
    assert not backend._agg_cache


def test_threaded_writer_and_readers(port):
    """A writer toggles one bit of f and one value of v while readers send
    the 3-field GroupBy, Sum, Min and Max: every answer is one of the four
    states', nothing is swept after the warm-up, and the final tables
    equal a fresh backend's."""
    h, dev, backend, oracle = port
    f_col = _grouped_column(h, 1, 'f', 1)
    v_col, v_max = _extreme(h, "v", max)
    qs = [GN3, "Sum(field=v)", "Min(field=v)", "Max(field=v)"]
    fld_f, fld_v = h.index("i").field("f"), h.index("i").field("v")

    def apply(mask):
        (fld_f.set_bit if mask & 1 else fld_f.clear_bit)(1, f_col)
        fld_v.set_value(v_col, -995 if mask & 2 else v_max)

    states = {}
    for mask in range(4):
        apply(mask)
        states[mask] = {q: oracle.execute("i", q) for q in qs}
    apply(0)
    for q in qs:
        assert dev.execute("i", q) == states[0][q]
        assert dev.execute("i", q) == states[0][q]  # Sum/Min/Max now carry versions
    stop = threading.Event()
    bad, served = [], []
    swept = {k: _launches(k) for k in ("group_tile_pershard", "bsi_sum", "bsi_min", "bsi_max")}

    def writer():
        k = 0
        while not stop.is_set():
            apply(k % 4)
            k += 1
            stop.wait(0.001)

    def reader(i):
        rng = np.random.default_rng(i)
        for _ in range(20):
            q = qs[int(rng.integers(len(qs)))]
            got = dev.execute("i", q)
            served.append(q)
            if all(got != states[m][q] for m in states):
                bad.append((q, got))

    w = threading.Thread(target=writer)
    readers = [threading.Thread(target=reader, args=(i,)) for i in range(3)]
    w.start()
    for t in readers:
        t.start()
    for t in readers:
        t.join()
    stop.set()
    w.join()
    assert not bad
    assert len(served) == 60
    assert {k: _launches(k) for k in swept} == swept
    fresh = Executor(h, backend=CUDABackend(h, device="cpu"))
    for q in qs:
        assert dev.execute("i", q) == oracle.execute("i", q) == fresh.execute("i", q)
