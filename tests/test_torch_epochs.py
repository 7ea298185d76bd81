"""Write epochs absorbed on the host by the port's pair and TopN tables
(pilosa_tpu_torch/exec/cuda.py: the freshness plane, _pair_try_incremental,
_topn_try_incremental), held against the JAX package's TPUBackend.

One holder directory is written by the JAX package from a numpy seed and
carried across with carry.open_reference_holder. Both backends serve the
same requests through the same seeded write epochs, each built to take one
branch of the tiers (a delta on either side, both sides changed, a self
pair, a created, deleted or recreated fragment, a bulk import the op ring
cannot explain, row growth past the table, a write outside the queried
shards, more slab shards than the host-update cutoff). After every epoch
the answers and the tier counters must equal the JAX backend's. Then each
race guard of the tiers is driven on its own, on a holder of the port.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec import tpu as jax_tpu
from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu.utils.stats import global_stats as jax_stats
from pilosa_tpu_torch.carry import open_reference_holder
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec import cuda
from pilosa_tpu_torch.exec.cpu import CPUBackend
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.ops.blocks import WORDS_PER_SHARD, pack_fragment
from pilosa_tpu_torch.ops.kernels import pair_stats_torch, row_popcounts_torch
from pilosa_tpu_torch.roaring.bitmap import Bitmap
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.stats import global_stats


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SW = SHARD_WIDTH
N_SHARDS = 4
ROWS = 6  # rows 0..5 of f and g: stacks of 8 padded rows

# One request of 16 Counts over (f, g): one pair entry.
PAIR = " ".join(
    [f"Count(Intersect(Row(f={a}), Row(g={b})))" for a in (0, 1, 2) for b in (1, 4)]
    + [f"Count(Union(Row(f={a}), Row(g=4)))" for a in (1, 2, 3)]
    + [f"Count(Difference(Row(f={a}), Row(g=1)))" for a in (1, 2, 3)]
    + [f"Count(Xor(Row(f={a}), Row(g=4)))" for a in (0, 3)]
    + ["Count(Row(f=2))", "Count(Row(g=4))"]
)
# A self pair (f, f).
SELF = "Count(Intersect(Row(f=1), Row(f=2))) Count(Xor(Row(f=0), Row(f=3)))"
QUERIES = [PAIR, SELF, "GroupBy(Rows(f), Rows(g))", "TopN(f)", "TopN(g, n=3)",
           "Rows(f)", "GroupBy(Rows(f))"]

TIER_COUNTERS = (
    "pair_stats_sweeps_total", "pair_stats_cache_hits_total",
    "pair_stats_incremental_updates_total", "pair_stats_incremental_shards_total",
    "pair_stats_delta_ops_total", "topn_incremental_updates_total",
    "topn_incremental_shards_total", "topn_cache_hits_total",
)


def _tier_counters(stats) -> dict:
    out = {name: sum(stats.counter_totals(name).values()) for name in TIER_COUNTERS}
    for name in ("version_walk_total", "version_walk_shards_total"):
        for k, v in stats.counter_totals(name).items():
            if 'tier="pair"' in k or 'tier="topn"' in k:
                out[k] = v
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)
            if after.get(k, 0) != before.get(k, 0)}


def _port_counter(name: str) -> float:
    return sum(global_stats.counter_totals(name).values())


def _write_data(h, rng, *, g_in_last_shard: bool):
    """f and g rows 0..5, ~1500 random columns a row over the shards; g
    has no fragment in the last shard unless asked."""
    idx = h.create_index("i")
    for name in ("f", "g"):
        fld = idx.create_field(name)
        span = N_SHARDS if name == "f" or g_in_last_shard else N_SHARDS - 1
        for row in range(ROWS):
            cols = np.unique(rng.integers(0, span * SW, 1500, dtype=np.uint64))
            fld.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)


# ---------------------------------------------------------------------------
# the host rows against K1's and K8's plain forms and the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rf,rg,w", [(8, 8, WORDS_PER_SHARD), (24, 32, WORDS_PER_SHARD),
                                     (3, 5, 100), (1, 1, 7)])
def test_host_slab_rows_equal_plain_kernels_and_jax(rf, rg, w):
    """rf * rg = 768 at W words takes two word chunks of the AND."""
    rng = np.random.default_rng(rf * 1000 + rg)
    chunk = max(1, (64 << 20) // max(1, rf * rg * 4))
    assert (w > chunk) == ((rf, rg) == (24, 32))
    for density in (0.0, 0.05, 0.5, 1.0):
        fslab = (rng.random((rf, w, 32)) < density).astype(np.uint8)
        fslab = np.packbits(fslab, axis=-1, bitorder="little").view(np.uint32).reshape(rf, w)
        gslab = (rng.random((rg, w, 32)) < density).astype(np.uint8)
        gslab = np.packbits(gslab, axis=-1, bitorder="little").view(np.uint32).reshape(rg, w)
        got = cuda._host_slab_pair_flat(fslab, gslab)
        plain = pair_stats_torch(torch.from_numpy(fslab.view(np.int32))[None],
                                 torch.from_numpy(gslab.view(np.int32))[None])[0].numpy()
        assert got.dtype == np.int32 and np.array_equal(got, plain)
        assert np.array_equal(got, jax_tpu._host_slab_pair_flat(fslab, gslab))
        counts = cuda._host_slab_row_counts(fslab)
        k8 = row_popcounts_torch(torch.from_numpy(fslab.view(np.int32))[None], 0, rf)
        assert np.array_equal(counts, k8[0, 0].numpy().astype(np.int64))
        assert np.array_equal(counts, jax_tpu._host_slab_row_counts(fslab))


def test_pack_confirmed_repacks_over_a_racing_write(monkeypatch):
    """A write between the version read and the pack: the pack is taken
    again, so the version returned describes the slab."""
    h = Holder(None).open()
    _write_data(h, np.random.default_rng(4), g_in_last_shard=True)
    fr = h.index("i").field("f").view("standard").fragment(2)
    real = cuda.pack_fragment
    packs = []

    def pack(frag, n_rows=None):
        packs.append(1)
        if len(packs) == 1:
            h.index("i").field("f").set_bit(5, 2 * SW + 31)
        return real(frag, n_rows=n_rows)

    monkeypatch.setattr(cuda, "pack_fragment", pack)
    slab, vers = cuda._pack_confirmed(fr, 8)
    assert len(packs) == 2
    assert vers == (fr.uid, fr.version)
    assert slab[5, 0] >> 31 & 1
    h.close()


def test_self_pair_never_takes_the_delta_tier():
    """A self pair's probes would read the side that changes: the delta
    tier hands its shard to the slab tier, whatever the versions say."""
    h = Holder(None).open()
    _write_data(h, np.random.default_rng(6), g_in_last_shard=True)
    backend = CUDABackend(h, device="cpu")
    v = h.index("i").field("f").view("standard")
    fr = v.fragment(1)
    old = (fr.uid, fr.version)
    h.index("i").field("f").set_bit(1, SW + 3)
    new = (fr.uid, fr.version)
    hit = cuda._PairEntry((0, 1), 8, 8, None, np.zeros((2, 80), np.int32), 0, 0,
                          (None, old), (None, new))
    args = (hit, 1, 1, v, v)
    table = hit.pershard.copy()
    assert backend._pair_shard_delta(*args, True, table, (None, new), (None, new)) is None
    assert backend._pair_shard_delta(*args, False, table, (None, new), (None, new)) == 1
    h.close()


def test_host_rows_of_packed_fragments_equal_the_plain_kernels():
    h = Holder(None).open()
    _write_data(h, np.random.default_rng(3), g_in_last_shard=True)
    f = h.index("i").field("f").view("standard").fragment(1)
    g = h.index("i").field("g").view("standard").fragment(1)
    fslab, vf = cuda._pack_confirmed(f, 8)
    gslab, vg = cuda._pack_confirmed(g, 8)
    assert vf == (f.uid, f.version) and vg == (g.uid, g.version)
    plain = pair_stats_torch(torch.from_numpy(fslab.view(np.int32))[None],
                             torch.from_numpy(gslab.view(np.int32))[None])[0].numpy()
    assert np.array_equal(cuda._host_slab_pair_flat(fslab, gslab), plain)
    h.close()


# ---------------------------------------------------------------------------
# seeded epochs, port against the JAX TPUBackend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX oracle, JAX TPUBackend executor, port oracle, port executor,
    JAX backend, port backend, JAX holder, port holder)."""
    src = str(tmp_path_factory.mktemp("jax_written"))
    jh = JaxHolder(src).open()
    _write_data(jh, np.random.default_rng(12), g_in_last_shard=False)
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


def _existing(th, field, row, shard):
    """A column of row `row` of `field` in `shard` (from the port's holder,
    whose content equals the JAX one's)."""
    frag = th.index("i").field(field).view("standard").fragment(shard)
    return int(frag.row(row).columns()[0])


def _both_holders(fn):
    def apply(jh, th):
        fn(jh)
        fn(th)
    return apply


def _import(field, row, cols):
    cols = np.asarray(cols, dtype=np.uint64)
    return _both_holders(lambda h: h.index("i").field(field).import_bits(
        np.full(cols.size, row, dtype=np.uint64), cols))


def _delete_fragment(field, shard):
    return _both_holders(
        lambda h: h.index("i").field(field).view("standard").delete_fragment(shard))


def _epochs(th):
    """(name, writes, shards or None, expected port counter moves). A write
    is a PQL string, run by both oracles, or a callable on both holders."""
    c_g4 = _existing(th, "g", 4, 0)
    return [
        ("cold", [], None, {"pair_stats_sweeps_total": 2}),
        ("delta on f", [f"Set({SW + 101}, f=1)", f"Set({2 * SW + 7}, f=0)"], None,
         {"pair_stats_delta_ops_total": 2}),
        ("delta on g", [f"Clear({c_g4}, g=4)", "Set(5, g=1)"], None,
         {"pair_stats_delta_ops_total": 2}),
        ("both sides changed", [f"Set({SW + 200}, f=3)", f"Set({SW + 201}, g=2)"], None,
         {"pair_stats_incremental_shards_total": 2}),
        ("created fragment", [f"Set({3 * SW + 9}, g=1)"], None,
         {"pair_stats_incremental_updates_total": 1}),
        ("deleted fragment", [_delete_fragment("f", 2)], None,
         {"pair_stats_incremental_updates_total": 2}),
        ("created again", [f"Set({2 * SW + 3}, f=1)"], None,
         {"pair_stats_incremental_updates_total": 2}),
        ("recreated fragment", [_delete_fragment("g", 0), "Set(11, g=2)"], None,
         {"pair_stats_incremental_updates_total": 1}),
        ("bulk import", [_import("f", 2, [SW + 5, SW + 6, SW + 900])], None,
         {"pair_stats_incremental_updates_total": 2, "topn_incremental_updates_total": 1}),
        ("row growth past the table", [f"Set({SW + 300}, f=9)"], None,
         {"pair_stats_sweeps_total": 2}),
        ("another shard set", [], [0, 1, 2], {"pair_stats_sweeps_total": 2}),
        ("write outside the shard set", [f"Set({3 * SW + 20}, f=1)", f"Set({3 * SW + 21}, g=3)"],
         [0, 1, 2], {}),
        ("all shards again", [], None, {"pair_stats_sweeps_total": 2}),
        ("past the host-update cutoff",
         [_import("f", 3, [44, SW + 44]), _import("g", 3, [45, SW + 45])], "cutoff",
         {"pair_stats_sweeps_total": 2}),
        ("within the cutoff again", [_import("f", 0, [77])], None,
         {"pair_stats_incremental_updates_total": 2}),
    ]


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
        cutoff = shards == "cutoff"
        if cutoff:
            shards = None
            for b in (jdev_b, tdev_b):
                b.MAX_PAIR_HOST_UPDATE_SHARDS = 1
        j0, t0 = _tier_counters(jax_stats), _tier_counters(global_stats)
        launches = _port_counter("device_launches_total")
        routed = _port_counter("cpu_routed_total")
        try:
            for q in QUERIES:
                want, jgot, tgot_cpu, got = _answers(execs, q, shards)
                assert jgot == want and tgot_cpu == want, (name, q)
                assert got == want, (name, q)
        finally:
            if cutoff:
                for b in (jdev_b, tdev_b):
                    del b.MAX_PAIR_HOST_UPDATE_SHARDS
        jd = _delta(_tier_counters(jax_stats), j0)
        td = _delta(_tier_counters(global_stats), t0)
        assert td == jd, name
        assert _port_counter("cpu_routed_total") == routed, name
        for k, v in expect.items():
            assert td.get(k, 0) == v, (name, k, td)
        absorbed = ("pair_stats_incremental_updates_total" in td
                    or "topn_incremental_updates_total" in td)
        swept = "pair_stats_sweeps_total" in td
        if name == "write outside the shard set":
            # Re-keyed: nothing launched, nothing absorbed.
            assert _port_counter("device_launches_total") == launches
            assert not absorbed and not swept
        if absorbed and not swept:
            seen.add(name)
    assert {"delta on f", "delta on g", "both sides changed", "created fragment",
            "recreated fragment", "bulk import", "within the cutoff again"} <= seen


def test_tables_equal_a_fresh_sweep_after_the_epochs(both):
    """After the epochs, the absorbed per-shard tables equal K1's and K8's
    plain rows over freshly packed stacks."""
    *_, tdev_b, _, th = both
    tdev = Executor(th, backend=tdev_b)
    tdev.execute("i", PAIR)
    tdev.execute("i", "TopN(f)")
    ent = tdev_b._pair_cache[("i", "f", "g")]
    _check_tables_fresh(tdev_b, th, ent)


def _check_tables_fresh(backend, h, ent):
    shards = ent.shards
    f = h.index("i").field("f").view("standard")
    g = h.index("i").field("g").view("standard")

    def stack(v, rows):
        return torch.from_numpy(np.stack([
            pack_fragment(v.fragment(s), n_rows=rows) if v.fragment(s) is not None
            else np.zeros((rows, WORDS_PER_SHARD), np.uint32) for s in shards
        ]).view(np.int32))

    fs, gs = stack(f, ent.rf), stack(g, ent.rg)
    assert ent.pershard is not None
    assert np.array_equal(ent.pershard, pair_stats_torch(fs, gs).numpy())
    top = backend._topn_cache[("i", "f")]
    assert top[2] is not None
    want = row_popcounts_torch(stack(f, top[2].shape[1]), 0, top[2].shape[1])[0]
    assert np.array_equal(top[2], want.numpy().astype(np.int64))
    assert np.array_equal(top[1], want.numpy().astype(np.int64).sum(axis=0))


# ---------------------------------------------------------------------------
# the race guards, one at a time, on a holder of the port
# ---------------------------------------------------------------------------


@pytest.fixture
def port():
    """(port holder, device executor, its backend, CPU oracle executor)."""
    h = Holder(None).open()
    _write_data(h, np.random.default_rng(5), g_in_last_shard=True)
    backend = CUDABackend(h, device="cpu")
    yield h, Executor(h, backend=backend), backend, Executor(h, backend=CPUBackend(h))
    h.close()


def _same(dev, oracle, q):
    got = dev.execute("i", q)
    assert got == oracle.execute("i", q), q
    return got


def _frag(h, field, shard):
    return h.index("i").field(field).view("standard").fragment(shard)


def _blocks_while_locked(fr, fn) -> None:
    """fn() must wait while another thread holds fr.lock, and finish once
    it is released."""
    held, release = threading.Event(), threading.Event()

    def holder():
        with fr.lock:
            held.set()
            release.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(10)
    done = threading.Event()
    w = threading.Thread(target=lambda: (fn(), done.set()))
    w.start()
    assert not done.wait(0.2), "read the version without the fragment's lock"
    release.set()
    t.join()
    w.join(10)
    assert done.is_set()


def test_version_reads_take_the_fragment_lock(port):
    """(a) Every version a table records comes from a locked read: the
    stack build, the full and journal walks, the confirmations and the
    confirmed pack."""
    h, _, backend, _ = port
    f = h.index("i").field("f")
    fr = _frag(h, "f", 1)
    shards = (0, 1, 2, 3)
    gen = f.view("standard").generation
    vers = backend._live_versions(f, shards)
    f.set_bit(1, SW + 77)  # journals shard 1
    _blocks_while_locked(fr, lambda: backend.blocks.get_with_versions("i", f, shards))
    _blocks_while_locked(fr, lambda: backend._live_versions(f, shards))
    _blocks_while_locked(fr, lambda: backend._confirm_vers(f, shards, vers))
    _blocks_while_locked(fr, lambda: backend._epoch_versions(f, shards, "standard", vers, gen))
    _blocks_while_locked(fr, lambda: backend._confirm_vers_journal(f, shards, vers, gen))
    _blocks_while_locked(fr, lambda: cuda._pack_confirmed(fr, 8))


def test_freshness_walks_equal_jax(port, tmp_path):
    """_live_versions, _epoch_versions, _confirm_vers and
    _confirm_vers_journal give the JAX backend's versions (mapped through
    the fragments' uids) and count the same walks."""
    h, _, backend, _ = port
    jh = JaxHolder(str(tmp_path)).open()
    _write_data(jh, np.random.default_rng(5), g_in_last_shard=True)
    jb = TPUBackend(jh)
    shards = (0, 1, 2, 3)
    fields = [h.index("i").field("f"), jh.index("i").field("f")]

    def norm(vers, hh):
        v = hh.index("i").field("f").view("standard")
        return tuple(x if x is None or x[0] == "stale"
                     else (shards.index(next(s for s in shards
                                             if v.fragment(s) is not None
                                             and v.fragment(s).uid == x[0])), x[1])
                     for x in vers)

    def run(b, fld, hh):
        gen = fld.view("standard").generation
        live = b._live_versions(fld, shards, tier="t")
        fld.set_bit(2, SW + 5)
        fld.set_bit(3, 3 * SW + 6)
        epoch = b._epoch_versions(fld, shards, "standard", live, gen, tier="t")
        conf = b._confirm_vers(fld, shards, live, tier="t")
        journal = b._confirm_vers_journal(fld, shards, live, gen, tier="t")
        return [norm(x, hh) for x in (live, epoch, conf, journal)]

    def walks(stats):
        return {k: v for k, v in stats.counter_totals("version_walk").items() if 'tier="t"' in k}

    t0, j0 = walks(global_stats), walks(jax_stats)
    assert run(backend, fields[0], h) == run(jb, fields[1], jh)
    assert _delta(walks(global_stats), t0) == _delta(walks(jax_stats), j0)
    jh.close()


def test_stack_built_over_a_racing_write_is_recorded_stale(port, monkeypatch):
    """(b) A write between the stack build's version read and its pack: the
    sweep's content holds the write, so the shard is recorded _VERS_STALE
    and the next epoch re-derives it from its slab. Replaying the write's
    op onto that content would count it twice."""
    h, dev, backend, oracle = port
    target = _frag(h, "f", 1)
    real_pack = cuda.pack_fragment
    fired = []

    def pack(fr, n_rows=None):
        if fr is target and not fired:
            fired.append(1)
            h.index("i").field("f").set_bit(1, SW + 4321)
        return real_pack(fr, n_rows=n_rows)

    monkeypatch.setattr(cuda, "pack_fragment", pack)
    _same(dev, oracle, PAIR)
    _same(dev, oracle, "TopN(f)")
    assert fired
    assert backend._pair_cache[("i", "f", "g")].vers_f[1] == cuda._VERS_STALE
    monkeypatch.setattr(cuda, "pack_fragment", real_pack)
    delta_ops = _port_counter("pair_stats_delta_ops_total")
    _same(dev, oracle, PAIR)
    _same(dev, oracle, "TopN(f)")
    assert _port_counter("pair_stats_delta_ops_total") == delta_ops
    assert backend._pair_cache[("i", "f", "g")].vers_f[1] == (target.uid, target.version)


def test_topn_dispatch_over_a_racing_write_is_recorded_stale(port, monkeypatch):
    """(b) for the TopN table: a write during K8's launch leaves the shard
    _VERS_STALE, and the next epoch re-derives it."""
    h, dev, backend, oracle = port
    real = cuda.row_popcounts
    fired = []

    def launch(*args, **kw):
        out = real(*args, **kw)
        if not fired:
            fired.append(1)
            h.index("i").field("f").set_bit(2, 2 * SW + 99)
        return out

    monkeypatch.setattr(cuda, "row_popcounts", launch)
    dev.execute("i", "TopN(f)")
    monkeypatch.setattr(cuda, "row_popcounts", real)
    assert backend._topn_cache[("i", "f")][3][2] == cuda._VERS_STALE
    absorbed = _port_counter("topn_incremental_updates_total")
    _same(dev, oracle, "TopN(f)")
    assert _port_counter("topn_incremental_updates_total") == absorbed + 1


def test_write_racing_the_walk_on_the_other_side_takes_the_slab_tier(port, monkeypatch):
    """(d) f's epoch is replayed against g's storage, which the entry
    records at its walk version. A g write landing between the walk and the
    probes, at the column of f's op, must send the shard to the slab tier:
    probing it would count the cell here and again in g's own delta."""
    h, dev, backend, oracle = port
    _same(dev, oracle, PAIR)
    col = 2 * SW + 555
    h.index("i").field("f").set_bit(1, col)
    real = CUDABackend._epoch_versions
    calls = []

    def walk(self, fld, *args, **kw):
        out = real(self, fld, *args, **kw)
        calls.append(fld.name)
        if fld.name == "g" and calls.count("g") == 1:
            h.index("i").field("g").set_bit(4, col)
        return out

    probed = _frag(h, "g", 2).storage
    real_contains = Bitmap.contains
    probes = []

    def contains(self, v):
        if self is probed:
            probes.append(v)
        return real_contains(self, v)

    monkeypatch.setattr(CUDABackend, "_epoch_versions", walk)
    monkeypatch.setattr(Bitmap, "contains", contains)
    delta_ops = _port_counter("pair_stats_delta_ops_total")
    shards = _port_counter("pair_stats_incremental_shards_total")
    _same(dev, oracle, PAIR)
    assert probes == [], "probed g after it moved since the walk"
    assert _port_counter("pair_stats_delta_ops_total") == delta_ops
    assert _port_counter("pair_stats_incremental_shards_total") == shards + 1
    _same(dev, oracle, PAIR)
    _same(dev, oracle, "Count(Intersect(Row(f=1), Row(g=4))) Count(Row(g=4))")


def test_write_racing_the_probes_reverts_the_row(port, monkeypatch):
    """(d) A g write during the membership probes: the confirmation after
    them sees g moved, the shard's row goes back to the old entry's and the
    slab tier derives it."""
    h, dev, backend, oracle = port
    _same(dev, oracle, PAIR)
    col = SW + 999
    h.index("i").field("f").set_bit(2, col)
    real = Bitmap.contains
    fired = []

    probed = _frag(h, "g", 1).storage

    def contains(self, v):
        if self is probed and not fired:
            fired.append(1)
            h.index("i").field("g").set_bit(1, col)
        return real(self, v)

    monkeypatch.setattr(Bitmap, "contains", contains)
    delta_ops = _port_counter("pair_stats_delta_ops_total")
    got = dev.execute("i", PAIR)
    monkeypatch.setattr(Bitmap, "contains", real)
    assert fired
    assert got == oracle.execute("i", PAIR)
    assert _port_counter("pair_stats_delta_ops_total") == delta_ops
    _same(dev, oracle, PAIR)


def test_tables_are_copied_never_changed(port):
    """(e) An absorbed epoch makes new tables; the old entry's stay as
    they were (another thread may still be resolving it)."""
    h, dev, backend, oracle = port
    _same(dev, oracle, PAIR)
    _same(dev, oracle, "TopN(f)")
    old = backend._pair_cache[("i", "f", "g")]
    old_top = backend._topn_cache[("i", "f")]
    pair_copy, top_copy = old.pershard.copy(), old_top[2].copy()
    h.index("i").field("f").set_bit(1, SW + 31)
    h.index("i").field("g").set_bit(2, 2 * SW + 31)
    _same(dev, oracle, PAIR)
    _same(dev, oracle, "TopN(f)")
    new = backend._pair_cache[("i", "f", "g")]
    assert new is not old and new.pershard is not old.pershard
    assert np.array_equal(old.pershard, pair_copy)
    assert backend._topn_cache[("i", "f")][2] is not old_top[2]
    assert np.array_equal(old_top[2], top_copy)


def test_one_update_a_epoch_packs_without_the_lock(port, monkeypatch):
    """(f) Concurrent requests after an epoch: one thread updates the table
    inside the single-flight latch, packing without _pair_lock; the others
    wait and hit the stored entry."""
    h, dev, backend, oracle = port
    _same(dev, oracle, PAIR)
    h.index("i").field("f").set_bit(3, SW + 12)
    h.index("i").field("g").set_bit(3, SW + 12)  # both sides: the slab tier packs
    real = cuda._pack_confirmed
    states = []

    def pack(fr, n_rows):
        states.append((backend._pair_lock.locked(), ("i", "f", "g") in backend._stats_updating))
        return real(fr, n_rows)

    monkeypatch.setattr(cuda, "_pack_confirmed", pack)
    want = oracle.execute("i", PAIR)
    updates = _port_counter("pair_stats_incremental_updates_total")
    hits = _port_counter("pair_stats_cache_hits_total")
    start = threading.Barrier(6)
    out = []

    def reader():
        start.wait()
        out.append(dev.execute("i", PAIR))

    threads = [threading.Thread(target=reader) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out == [want] * 6
    assert states and all(s == (False, True) for s in states)
    assert _port_counter("pair_stats_incremental_updates_total") == updates + 1
    assert _port_counter("pair_stats_cache_hits_total") == hits + 5


def test_absorbed_epochs_leave_the_resident_stack(port):
    """(g) The tiers never touch the resident stack: the next query that
    needs it splices the epoch in, as before."""
    h, dev, backend, oracle = port
    _same(dev, oracle, PAIR)
    _same(dev, oracle, "TopN(f)")
    key = ("i", "f", "standard")
    entry = backend.blocks._entries[key]
    spliced = _port_counter("stack_incremental_updates_total")
    h.index("i").field("f").set_bit(1, SW + 8)
    _same(dev, oracle, PAIR)
    _same(dev, oracle, "TopN(f)")
    assert backend.blocks._entries[key] is entry
    assert _port_counter("stack_incremental_updates_total") == spliced
    _same(dev, oracle, "Count(Intersect(Row(f=1), Row(g=2)))")  # K11 over the stacks
    assert _port_counter("stack_incremental_updates_total") == spliced + 1
    assert backend.blocks._entries[key][1] is entry[1]


def test_a_write_outside_the_shards_rekeys(port):
    """(h) A write outside the queried shards moves the generations only:
    the entries are re-keyed, nothing launches and no count moves."""
    h, dev, backend, oracle = port
    shards = [0, 1]
    first = dev.execute("i", PAIR, shards=shards), dev.execute("i", "TopN(f)", shards=shards)
    old = backend._pair_cache[("i", "f", "g")]
    h.index("i").field("f").set_bit(2, 3 * SW + 1)
    h.index("i").field("g").set_bit(2, 2 * SW + 1)
    before = {k: _port_counter(k) for k in TIER_COUNTERS + ("device_launches_total",)}
    again = dev.execute("i", PAIR, shards=shards), dev.execute("i", "TopN(f)", shards=shards)
    assert again == first
    assert {k: _port_counter(k) for k in before} == before
    new = backend._pair_cache[("i", "f", "g")]
    assert new is not old and new.stats is old.stats and new.pershard is old.pershard
    assert new.gen_f != old.gen_f
    assert _port_counter("pair_stats_cache_hits_total") == before["pair_stats_cache_hits_total"]
    dev.execute("i", PAIR, shards=shards)
    assert _port_counter("pair_stats_cache_hits_total") == before["pair_stats_cache_hits_total"] + 1


def test_threaded_writer_and_readers(port):
    """A writer toggles one bit of f and one of g while readers send the
    pair request and TopN: every answer is one of the four states', and
    the final tables equal a fresh sweep's."""
    h, dev, backend, oracle = port
    f_col, g_col = SW + 4242, 2 * SW + 4243
    writes = [("f", 1, f_col), ("g", 4, g_col)]
    qs = [PAIR, "TopN(f)", "TopN(g, n=3)"]
    states = {}
    for mask in range(4):
        for k, (fname, row, col) in enumerate(writes):
            fld = h.index("i").field(fname)
            (fld.set_bit if mask >> k & 1 else fld.clear_bit)(row, col)
        states[mask] = {q: oracle.execute("i", q) for q in qs}
    for fname, row, col in writes:
        h.index("i").field(fname).clear_bit(row, col)
    for q in qs:
        assert dev.execute("i", q) == states[0][q]
    stop = threading.Event()
    bad, served = [], []
    launches = _port_counter("pair_stats_sweeps_total")

    def writer():
        k = 0
        while not stop.is_set():
            fname, row, col = writes[k % 2]
            fld = h.index("i").field(fname)
            (fld.set_bit if (k // 2) % 2 == 0 else fld.clear_bit)(row, col)
            k += 1
            stop.wait(0.001)

    def reader(i):
        rng = np.random.default_rng(i)
        for _ in range(25):
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
    assert len(served) == 75
    assert _port_counter("pair_stats_sweeps_total") == launches
    dev.execute("i", PAIR)
    dev.execute("i", "TopN(f)")
    for q in qs:
        assert dev.execute("i", q) == oracle.execute("i", q)
    _check_tables_fresh(backend, h, backend._pair_cache[("i", "f", "g")])
