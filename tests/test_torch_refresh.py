"""The port's windowed refresher and preheat (pilosa_tpu_torch/exec/cuda.py
_StackedBlocks.refresh_stale, CUDABackend.start_refresher, stop_refresher,
preheat, _preheat_programs), run on the CPU with the kernels' plain
versions, against the JAX package.

One data directory is written by the JAX package and copied: the JAX
TPUBackend serves one copy and the port's CUDABackend(device="cpu") the
other, through the same writes. A windowed port backend must keep stacks
byte-identical to an unwindowed one and count its window flushes and
inline barriers as the JAX backend counts them; a refresher splicing the
resident stacks from a second thread must leave the pair, TopN and GroupN
tables' answers and tier counters those of the JAX backend; preheat must
make the JAX backend's stacks resident, byte for byte, and stop where it
stops under a byte budget.
"""

import shutil
import threading
import time

import numpy as np
import pytest
import torch

from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.core.field import options_for_int
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu.pql import parse_string as jax_parse
from pilosa_tpu.utils.stats import global_stats as jax_stats
from pilosa_tpu_torch.carry import open_reference_holder
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.pql import parse_string
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.stats import global_stats
from tests.test_torch_agg_epochs import TIER_COUNTERS as AGG_TIER_COUNTERS
from tests.test_torch_epochs import TIER_COUNTERS as PAIR_TIER_COUNTERS

N_SHARDS = 2
SW = SHARD_WIDTH

#: The stack counters the refresher moves.
REFRESH_COUNTERS = ("stack_windowed_refresh_total", "stack_refresh_forced_total",
                    "stack_full_rebuilds_total", "stack_incremental_updates_total")

#: The pair request, TopN and the 3-field GroupBy: the three tables that
#: absorb write epochs on the host.
PAIR = " ".join(
    [f"Count(Intersect(Row(f={a}), Row(g={b})))" for a in (1, 2, 3) for b in (4, 9)]
    + ["Count(Union(Row(f=1), Row(g=9)))", "Count(Row(f=2))"])
TABLE_QUERIES = [PAIR, "TopN(f)", "GroupBy(Rows(f), Rows(g), Rows(h))"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path):
    """tests/test_tpu.py's windowed-refresh holder (f rows 1 to 3, g row 9
    over two shards), with a row 4 of g, a field h of two rows and its
    preheat case's int field v (values in shard 0 only)."""
    rng = np.random.default_rng(5)
    h = JaxHolder(path).open()
    idx = h.create_index("i")
    for name in ("f", "g", "h"):
        idx.create_field(name)
    idx.create_field("v", options_for_int(-100, 100))
    for row in (1, 2, 3):
        cols = np.unique(rng.integers(0, N_SHARDS * SW, 3000, dtype=np.uint64))
        idx.field("f").import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    for row, n in ((9, 2000), (4, 700)):
        cols = np.unique(rng.integers(0, N_SHARDS * SW, n, dtype=np.uint64))
        idx.field("g").import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    cols = np.unique(rng.integers(0, N_SHARDS * SW, 1500, dtype=np.uint64))
    idx.field("h").import_bits(rng.integers(0, 2, cols.size, dtype=np.uint64), cols)
    vcols = np.unique(rng.integers(0, SW, 300, dtype=np.uint64))
    idx.field("v").import_value(vcols, rng.integers(-100, 101, vcols.size))
    h.close()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("jax_written"))
    _write(src)
    return src


class _Both:
    """The JAX holder and the port's, each over its own copy of one
    directory; writes go to both."""

    def __init__(self, src, root):
        jdir, tdir = str(root / "jax"), str(root / "port")
        shutil.copytree(src, jdir)
        shutil.copytree(src, tdir)
        self.jh = JaxHolder(jdir).open()
        self.th = open_reference_holder(tdir)

    def close(self):
        self.jh.close()
        self.th.close()

    def set_bit(self, field, row, col):
        self.jh.index("i").field(field).set_bit(row, col)
        self.th.index("i").field(field).set_bit(row, col)

    def clear_bit(self, field, row, col):
        self.jh.index("i").field(field).clear_bit(row, col)
        self.th.index("i").field(field).clear_bit(row, col)


@pytest.fixture
def both(written, tmp_path):
    pair = _Both(written, tmp_path)
    yield pair
    pair.close()


def _counters(stats, names) -> dict:
    return {n: sum(stats.counter_totals(n).values()) for n in names}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _words(block) -> np.ndarray:
    """A stack's bits as uint32 words, from either package."""
    if isinstance(block, torch.Tensor):
        return block.numpy().view(np.uint32)
    return np.asarray(block)


# -- the windowed refresher -------------------------------------------------


def test_windowed_stacks_and_counters_equal_the_jax_backend(both):
    """tests/test_tpu.py TestWindowedRefresh's differential, on both
    packages: window flushes (refresh_stale) interleave with mid-window
    reads across writes. The windowed port stack stays byte-identical to an
    unwindowed port backend's and to the JAX stack, the answers equal the
    JAX backend's, the forced and windowed counters move as the JAX
    backend's do, and no stack is rebuilt whole."""
    queries = ["Intersect(Row(f=1), Row(g=9))", "Union(Row(f=2), Row(g=9))", "Row(f=3)"]
    tw, tu = CUDABackend(both.th, device="cpu"), CUDABackend(both.th, device="cpu")
    jw = TPUBackend(both.jh)
    tcalls = [parse_string(q).calls[0] for q in queries]
    jcalls = [jax_parse(q).calls[0] for q in queries]
    tf, jf = both.th.index("i").field("f"), both.jh.index("i").field("f")
    shards = (0, 1)
    tw.blocks.get("i", tf, shards)
    jw.blocks.get("i", jf, shards)
    t0, j0 = _counters(global_stats, REFRESH_COUNTERS), _counters(jax_stats, REFRESH_COUNTERS)
    tw.blocks.refresh_window_ms = jw.blocks.refresh_window_ms = 60_000
    forced = windowed = 0
    for k in range(8):
        both.set_bit("f", 1 + k % 3, 555_000 + 97 * k)
        if k % 2 == 0:
            forced += 1  # a mid-window read refreshes inline
        else:
            n = tw.blocks.refresh_stale()
            assert n == jw.blocks.refresh_stale() >= 1
            windowed += n
        bw, _ = tw.blocks.get("i", tf, shards)
        bu, _ = tu.blocks.get("i", tf, shards)
        bj, _ = jw.blocks.get("i", jf, shards)
        np.testing.assert_array_equal(_words(bw), _words(bu))
        np.testing.assert_array_equal(_words(bw), _words(bj))
        assert tw.count_batch("i", tcalls, list(shards)) == \
            jw.count_batch("i", jcalls, list(shards))
    td = _delta(_counters(global_stats, REFRESH_COUNTERS), t0)
    jd = _delta(_counters(jax_stats, REFRESH_COUNTERS), j0)
    assert td.get("stack_refresh_forced_total") == forced
    assert td.get("stack_windowed_refresh_total") == windowed
    assert "stack_full_rebuilds_total" not in td
    assert {k: v for k, v in td.items() if k != "stack_incremental_updates_total"} == \
        {k: v for k, v in jd.items() if k != "stack_incremental_updates_total"}
    # A read right after a flush is a plain hit: no barrier.
    assert tw.blocks.refresh_stale() == 0
    f1 = _counters(global_stats, REFRESH_COUNTERS)["stack_refresh_forced_total"]
    tw.blocks.get("i", tf, shards)
    assert _counters(global_stats, REFRESH_COUNTERS)["stack_refresh_forced_total"] == f1


def test_background_refresher_refreshes(both):
    """start_refresher: the refresher thread splices a write within a few
    windows with no read in between; the next read is a plain hit with the
    new bit."""
    be = CUDABackend(both.th, device="cpu")
    calls = [parse_string("Row(f=1)").calls[0]]
    first = be.count_batch("i", calls, [0, 1])
    be.start_refresher(10)
    try:
        w0 = _counters(global_stats, REFRESH_COUNTERS)["stack_windowed_refresh_total"]
        both.set_bit("f", 1, 777_777)
        deadline = time.monotonic() + 10
        while _counters(global_stats, REFRESH_COUNTERS)["stack_windowed_refresh_total"] == w0:
            assert time.monotonic() < deadline, "the refresher never refreshed"
            time.sleep(0.01)
        f0 = _counters(global_stats, REFRESH_COUNTERS)["stack_refresh_forced_total"]
        assert be.count_batch("i", calls, [0, 1]) == [first[0] + 1]
        assert _counters(global_stats, REFRESH_COUNTERS)["stack_refresh_forced_total"] == f0
    finally:
        be.stop_refresher()
    assert be.blocks.refresh_window_ms == 0


def test_stop_refresher_joins(both):
    """The refresher thread ends at stop_refresher; a window of 0 starts
    none, and a second start keeps the first thread."""
    be = CUDABackend(both.th, device="cpu")
    be.start_refresher(0)
    assert be._refresher is None and be.blocks.refresh_window_ms == 0
    be.start_refresher(5)
    thread = be._refresher
    assert thread.is_alive() and thread.name == "stack-refresh"
    be.start_refresher(7)
    assert be._refresher is thread and be.blocks.refresh_window_ms == 5
    be.stop_refresher()
    assert not thread.is_alive()
    assert be._refresher is None and be.blocks.refresh_window_ms == 0
    be.stop_refresher()  # idempotent


def test_refresher_thread_beside_the_tables_equals_the_jax_backend(both):
    """The in-place splice beside the host tables: a second thread runs
    refresh_stale without pause while Set/Clear epochs meet the pair, TopN
    and GroupN tables. Every answer and every tier counter equal the JAX
    backend's (unwindowed) on the same writes, and no stack is rebuilt
    whole."""
    tbe = CUDABackend(both.th, device="cpu")
    tex = Executor(both.th, backend=tbe)
    jex = JaxExecutor(both.jh, backend=TPUBackend(both.jh))
    names = PAIR_TIER_COUNTERS + AGG_TIER_COUNTERS

    def run_all():
        for q in TABLE_QUERIES:
            assert [result_to_json(r) for r in tex.execute("i", q)] == \
                [jax_json(r) for r in jex.execute("i", q)], q

    run_all()  # the tables' first sweeps
    t0, j0 = _counters(global_stats, names), _counters(jax_stats, names)
    r0 = _counters(global_stats, REFRESH_COUNTERS)
    tbe.blocks.refresh_window_ms = 60_000
    stop = threading.Event()
    rounds = [0]

    def refresher():
        while not stop.is_set():
            rounds[0] += tbe.blocks.refresh_stale()

    thread = threading.Thread(target=refresher)
    thread.start()
    rng = np.random.default_rng(9)
    try:
        for epoch in range(6):
            for _ in range(3):
                field, row = [("f", 1 + int(rng.integers(3))), ("g", (4, 9)[rng.integers(2)]),
                              ("h", int(rng.integers(2)))][int(rng.integers(3))]
                col = int(rng.integers(N_SHARDS * SW))
                (both.set_bit if epoch % 2 == 0 else both.clear_bit)(field, row, col)
            run_all()
    finally:
        stop.set()
        thread.join()
    td = _delta(_counters(global_stats, names), t0)
    assert td == _delta(_counters(jax_stats, names), j0)
    assert td.get("pair_stats_incremental_updates_total", 0) > 0
    assert td.get("topn_incremental_updates_total", 0) > 0
    assert td.get("groupn_incremental_updates_total", 0) > 0
    rd = _delta(_counters(global_stats, REFRESH_COUNTERS), r0)
    assert "stack_full_rebuilds_total" not in rd


# -- preheat ------------------------------------------------------------------


class _Lines:
    """A logger that keeps its lines."""

    def __init__(self):
        self.lines = []

    def printf(self, fmt, *args):
        self.lines.append(fmt % args)


def _resident(blocks) -> dict:
    with blocks._lock:
        return {k: _words(e[1]) for k, e in blocks._entries.items()}


def test_preheat_makes_the_jax_stacks_resident(both):
    """tests/test_tpu.py TestPreheat on both packages: the same number of
    stacks (f, g, h and v's BSI view at full plane height), the
    same keys and bits; the first queries upload nothing and answer as the
    JAX backend."""
    tbe, jbe = CUDABackend(both.th, device="cpu"), TPUBackend(both.jh)
    n = tbe.preheat()
    assert n == jbe.preheat() == 4  # f, g, h and bsig_v
    got, want = _resident(tbe.blocks), _resident(jbe.blocks)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    uploads = sum(e["uploads"] for e in tbe.blocks.ledger())
    resident = tbe.blocks.resident_bytes()
    c = parse_string("Row(f=1)").calls[0]
    jc = jax_parse("Row(f=1)").calls[0]
    assert tbe.count_shards("i", c, [0, 1]) == jbe.count_shards("i", jc, [0, 1])
    assert tbe.bsi_sum("i", "v", [0, 1]) == jbe.bsi_sum("i", "v", [0, 1]) != (0, 0)
    assert sum(e["uploads"] for e in tbe.blocks.ledger()) == uploads
    assert tbe.blocks.resident_bytes() == resident


def test_preheat_stops_at_the_budget_as_the_jax_backend(both):
    """Under a byte budget of two and a half stacks, preheat stops at the
    first upload that evicted, at the JAX backend's stop, with the same
    log line and the same stacks resident."""
    budget = 5 * N_SHARDS * 8 * (SW // 32) * 4 // 2
    tbe = CUDABackend(both.th, device="cpu", max_bytes=budget)
    jbe = TPUBackend(both.jh, max_bytes=budget)
    tl, jl = _Lines(), _Lines()
    assert tbe.preheat(logger=tl) == jbe.preheat(logger=jl)
    assert tl.lines == jl.lines
    assert any(line.startswith("preheat: HBM budget reached at i/") for line in tl.lines)
    assert _resident(tbe.blocks).keys() == _resident(jbe.blocks).keys()
    assert tbe.blocks.evictions == jbe.blocks.evictions == 1


def test_preheat_launches_nothing_and_leaves_the_caches_empty(both):
    """preheat only packs stacks and loads the kernel libraries (none on the
    CPU): no launch is made, so no pair, TopN, aggregate or GroupN cache
    entry, and _preheat_programs uploads nothing."""
    tbe, jbe = CUDABackend(both.th, device="cpu"), TPUBackend(both.jh)
    tl, jl = _Lines(), _Lines()
    n = tbe.preheat(logger=tl)
    assert n == jbe.preheat(logger=jl) and tl.lines == jl.lines == []
    assert tbe.programs.ledger() == [] and tbe.programs.counts()["launches"] == 0
    for be in (tbe, jbe):
        assert be._pair_cache == {} and be._topn_cache == {}
        assert be._agg_cache == {} and be._groupn_cache == {}
    uploads = sum(e["uploads"] for e in tbe.blocks.ledger())
    tbe._preheat_programs(tl)
    assert sum(e["uploads"] for e in tbe.blocks.ledger()) == uploads
    assert tl.lines == [] and tbe.programs.ledger() == []


def test_refresher_splices_under_concurrent_reads_stay_in_an_epoch(both):
    """The in-place splice while reads run: a writer toggles one bit of f
    between two epochs without pause, the refresher splices every 1 ms and
    three readers send the pair request, TopN and the 3-field GroupBy. Every
    answer is one epoch's; once the writer stops, every answer equals the
    JAX backend's."""
    tbe = CUDABackend(both.th, device="cpu")
    tex = Executor(both.th, backend=tbe)
    # A column of shard 1 in g=9, not in f=1: f=1 there moves the pair
    # request's and TopN's answers.
    idx = both.th.index("i")

    def cols(field, row):
        return set(idx.field(field).row(row, 1).columns().tolist())

    col = min(cols("g", 9) - cols("f", 1))

    def answers(ex, conv):
        return {q: [conv(r) for r in ex.execute("i", q)] for q in TABLE_QUERIES}

    tf = both.th.index("i").field("f")
    tf.set_bit(1, col)
    epoch_b = answers(tex, result_to_json)
    tf.clear_bit(1, col)
    epoch_a = answers(tex, result_to_json)
    assert all(epoch_a[q] != epoch_b[q] for q in TABLE_QUERIES[:2])
    w0 = _counters(global_stats, REFRESH_COUNTERS)["stack_windowed_refresh_total"]
    tbe.start_refresher(1)
    stop = threading.Event()
    bad, served = [], [0]

    def reader(i):
        k = i
        while not stop.is_set():
            q = TABLE_QUERIES[k % len(TABLE_QUERIES)]
            k += 1
            got = [result_to_json(r) for r in tex.execute("i", q)]
            served[0] += 1
            if got not in (epoch_a[q], epoch_b[q]):
                bad.append(q)

    readers = [threading.Thread(target=reader, args=(i,)) for i in range(3)]
    for t in readers:
        t.start()
    try:
        for k in range(40):
            (tf.set_bit if k % 2 == 0 else tf.clear_bit)(1, col)
            time.sleep(0.01)
    finally:
        stop.set()
        for t in readers:
            t.join()
        tbe.stop_refresher()
    assert bad == [] and served[0] > 0
    assert _counters(global_stats, REFRESH_COUNTERS)["stack_windowed_refresh_total"] > w0
    both.jh.index("i").field("f").clear_bit(1, col)
    jex = JaxExecutor(both.jh, backend=TPUBackend(both.jh))
    assert answers(tex, result_to_json) == answers(jex, jax_json) == epoch_a


def test_a_write_between_generation_and_version_reads_rebuilds_nothing(both):
    """A write can land between a build's generation read (its fingerprint)
    and its version reads, so the entry holds the write under an older
    generation. The next get() finds the generation moved and no shard's
    version moved: it keeps the resident tensor (its content holds the
    write) instead of rebuilding it whole, which the refresher's rounds,
    racing the writers, would otherwise do under churn."""
    be = CUDABackend(both.th, device="cpu")
    f = both.th.index("i").field("f")
    shards = (0, 1)
    block, _ = be.blocks.get("i", f, shards)
    both.set_bit("f", 2, SW + 12345)
    spliced, _ = be.blocks.get("i", f, shards)
    assert spliced is block
    key = ("i", "f", "standard")
    with be.blocks._lock:  # the race's outcome: the write under the old generation
        fp, arr, rows_p, vers = be.blocks._entries[key]
        be.blocks._entries[key] = ((fp[0], fp[1] - 1, fp[2]), arr, rows_p, vers)
    before = _counters(global_stats, REFRESH_COUNTERS)
    again, _ = be.blocks.get("i", f, shards)
    assert again is block
    d = _delta(_counters(global_stats, REFRESH_COUNTERS), before)
    assert "stack_full_rebuilds_total" not in d and "stack_incremental_updates_total" not in d
    fresh, _ = CUDABackend(both.th, device="cpu").blocks.get("i", f, shards)
    assert torch.equal(again, fresh)
