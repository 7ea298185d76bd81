"""Row paging under a device byte budget and the HBM ledger
(pilosa_tpu_torch/exec/cuda.py _StackedBlocks.get_row, ledger, tier_bytes,
CUDABackend._topn_paged_counts; ops/blocks.py pack_row, pack_rows,
fragment_tier_words), run on the CPU with the kernels' plain versions,
against the JAX package.

One data directory is written by the JAX package and copied; the JAX
TPUBackend(max_bytes=B) serves one copy and the port's
CUDABackend(device="cpu", max_bytes=B) the other, through the same query
sequence. After every query the two must agree on the answer, the page
counters' deltas (hbm_page_uploads_total, hbm_page_bytes_total), the
evictions, resident_bytes(), tier_bytes() and every ledger entry but its
clock fields (lastAccess, idleSeconds). A call the reference pages adds
nothing to the port's cpu_routed_total.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu.ops import blocks as jax_blocks
from pilosa_tpu.utils.stats import global_stats as jax_stats
from pilosa_tpu_torch.carry import open_reference_holder
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.cpu import CPUBackend
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.ops import blocks
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.stats import global_stats
from tests.test_torch_backend import PAIR_REQUEST
from tests.test_torch_blocks import _pair_of_fragments

N_SHARDS = 3
#: The tall field t: row r holds T_BITS + r random columns over the shards,
#: so no two rows tie and the CPU oracle's TopN order is the card's.
T_ROWS = 40
T_BITS = 20
#: One row page over N_SHARDS shards, and one 8-row stack.
PAGE = N_SHARDS * blocks.WORDS_PER_SHARD * 4
STACK = blocks.ROW_PAD * PAGE
#: Budgets: nothing fits; two row pages but no stack; one stack (f, g and
#: h resident in turn, t paged).
BUDGETS = {"one-byte": 1, "two-pages": 2 * PAGE + PAGE // 2, "one-stack": STACK + PAGE}

PAGE_COUNTERS = ("hbm_page_uploads_total", "hbm_page_bytes_total")

#: Answered on the card under every budget: paged where a stack is over it.
PAGED_QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=7)))",
    "Count(Intersect(Row(f=1), Row(g=7)))",  # repeated: its pages may hit
    "Row(f=2)",
    "Count(Intersect(Row(f=1), Row(g=7), Row(h=1)))",
    "Count(Union(Row(t=3), Row(t=35)))",
    "Count(Row(t=5000))",
    PAIR_REQUEST,
    "TopN(f, n=2)",
    "TopN(f, Row(g=7), n=3)",
    "Rows(f)",
    "GroupBy(Rows(f))",
    "TopN(t, n=10)",
    "TopN(t, Row(f=1), n=5)",
    "Rows(t)",
    "GroupBy(Rows(t))",
    "Intersect(Row(t=7), Row(g=7))",
]
#: Not paged by the reference either: routed to the host while their BSI
#: or existence stack is over the budget, counted once.
ROUTED_UNDER_BUDGET = ["Sum(field=v)", "Min(field=v)", "Max(field=v)",
                       "Count(Row(v > 100))", "Count(Not(Row(f=1)))"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(path):
    """The backend tests' holder over N_SHARDS shards, and the tall field t."""
    h = ge._build_holder(path, N_SHARDS, np.random.default_rng(0))
    idx = h.index("i")
    idx.create_field("t")
    rng = np.random.default_rng(1)
    for r in range(T_ROWS):
        cols = rng.choice(N_SHARDS * SHARD_WIDTH, T_BITS + r, replace=False)
        idx.field("t").import_bits(np.full(cols.size, r, dtype=np.uint64),
                                   cols.astype(np.uint64))
    h.close()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("jax_written"))
    _build(src)
    return src


class _Budgeted:
    """The JAX executor over TPUBackend(max_bytes=B) and the port's over
    CUDABackend(device="cpu", max_bytes=B), each on its own copy of one
    directory, and the port's CPU oracle."""

    def __init__(self, src, root, budget):
        jdir, tdir = str(root / "jax"), str(root / "port")
        shutil.copytree(src, jdir)
        shutil.copytree(src, tdir)
        self.jh = JaxHolder(jdir).open()
        self.th = open_reference_holder(tdir)
        self.jbe = TPUBackend(self.jh, max_bytes=budget)
        self.tbe = CUDABackend(self.th, device="cpu", max_bytes=budget)
        self.jax = JaxExecutor(self.jh, backend=self.jbe)
        self.port = Executor(self.th, backend=self.tbe)
        self.oracle = Executor(self.th, backend=CPUBackend(self.th))

    def close(self):
        self.jh.close()
        self.th.close()

    def write(self, q):
        assert self.jax.execute("i", q) == self.port.execute("i", q)

    def step(self, q, routed: int = 0):
        """Run q on both backends and hold everything the slice ports equal;
        the port's answer also equals its CPU oracle's. Returns the port's
        page-counter deltas."""
        jb = {n: _total(jax_stats, n) for n in PAGE_COUNTERS}
        tb = {n: _total(global_stats, n) for n in PAGE_COUNTERS}
        routed0 = _total(global_stats, "cpu_routed_total")
        want = [jax_json(r) for r in self.jax.execute("i", q)]
        got = [result_to_json(r) for r in self.port.execute("i", q)]
        assert got == want, q
        assert [result_to_json(r) for r in self.oracle.execute("i", q)] == want, q
        assert _total(global_stats, "cpu_routed_total") == routed0 + routed, q
        deltas = {n: _total(global_stats, n) - tb[n] for n in PAGE_COUNTERS}
        assert deltas == {n: _total(jax_stats, n) - jb[n] for n in PAGE_COUNTERS}, q
        self.same_ledger(q)
        return deltas

    def same_ledger(self, what=""):
        jb, tb = self.jbe.blocks, self.tbe.blocks
        assert tb.evictions == jb.evictions, what
        assert tb.resident_bytes() == jb.resident_bytes(), what
        assert tb.tier_bytes() == jb.tier_bytes(), what
        assert sum(tb.tier_bytes().values()) == tb.resident_bytes(), what
        assert _stable(tb.ledger()) == _stable(jb.ledger()), what


def _total(stats, name) -> float:
    return sum(stats.counter_totals(name).values())


def _stable(entries):
    """Ledger entries without their clock fields."""
    return [{k: v for k, v in e.items() if k not in ("lastAccess", "idleSeconds")}
            for e in entries]


@pytest.fixture(params=list(BUDGETS), ids=list(BUDGETS))
def budgeted(request, written, tmp_path):
    pair = _Budgeted(written, tmp_path, BUDGETS[request.param])
    yield pair
    pair.close()


# ---------------------------------------------------------------------------
# ops/blocks.py: the page packs and the tier attribution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_row_and_pack_rows_are_byte_identical(seed):
    ours, ref = _pair_of_fragments(seed)
    kinds = {ours.storage.container(k).typ for k in ours.storage.keys()}
    assert kinds == {"array", "run", "bitmap"}
    for row in range(12):
        got, want = blocks.pack_row(ours, row), jax_blocks.pack_row(ref, row)
        assert got.dtype == want.dtype == np.uint32
        assert got.tobytes() == want.tobytes(), row
    for start, stop in [(0, 8), (1, 3), (2, 3), (5, 11), (8, 16), (11, 20)]:
        got = blocks.pack_rows(ours, start, stop)
        want = jax_blocks.pack_rows(ref, start, stop)
        assert got.shape == want.shape == (stop - start, blocks.WORDS_PER_SHARD)
        assert got.tobytes() == want.tobytes(), (start, stop)
    # A page is its rows of the whole-fragment pack.
    whole = blocks.pack_fragment(ours)
    assert blocks.pack_rows(ours, 0, 16).tobytes() == whole.tobytes()


@pytest.mark.parametrize("n_rows", [1, 2, 3, 8, 16])
def test_fragment_tier_words_match_jax(n_rows):
    ours, ref = _pair_of_fragments(2)
    got = blocks.fragment_tier_words(ours, n_rows)
    assert got == jax_blocks.fragment_tier_words(ref, n_rows)
    if n_rows >= 3:
        assert got[0] > 0 and got[1] > 0  # array rows 0 and 2's halves, run row 1


# ---------------------------------------------------------------------------
# the backend under a budget, query by query
# ---------------------------------------------------------------------------


def test_paged_calls_equal_jax(budgeted):
    """Every call of PAGED_QUERIES answers on the card and leaves the same
    page traffic, evictions and ledger as the reference; a Row leaf over
    the budget takes one page and the pages of a Count hit the cache where
    the budget holds them."""
    budget = budgeted.tbe.blocks.max_bytes
    deltas = [budgeted.step(q) for q in PAGED_QUERIES]
    uploads = [d["hbm_page_uploads_total"] for d in deltas]
    if budget < STACK:
        assert uploads[0] == 2  # Row(f=1) and Row(g=7), one page each
        assert uploads[1] == (0 if budget >= 2 * PAGE else 2)
    else:
        assert uploads[:4] == [0, 0, 0, 0]  # f, g and h stacks are resident in turn
    # TopN(t): one upload of one 8-row page a sweep step, under every budget.
    n_pages = -(-T_ROWS // blocks.ROW_PAD)
    assert (uploads[11], deltas[11]["hbm_page_bytes_total"]) == (n_pages, n_pages * STACK)


@pytest.mark.parametrize("q", ROUTED_UNDER_BUDGET)
def test_unpaged_calls_stay_routed_and_counted_once(written, tmp_path, q):
    """BSI stacks and Not's existence stack over the budget are not paged,
    by the reference either: the host iterator answers, counted once."""
    pair = _Budgeted(written, tmp_path, BUDGETS["two-pages"])
    try:
        assert pair.step(q, routed=1) == {n: 0 for n in PAGE_COUNTERS}
    finally:
        pair.close()


def test_over_budget_stack_is_refused_before_its_version_walk(written, tmp_path,
                                                              monkeypatch):
    """A stack over the budget is refused before the per-shard locked
    version reads, which a paged field would otherwise pay on every call."""
    from pilosa_tpu_torch.exec import cuda as cuda_mod

    pair = _Budgeted(written, tmp_path, BUDGETS["two-pages"])
    reads = []
    real = cuda_mod._locked_version
    monkeypatch.setattr(cuda_mod, "_locked_version", lambda fr: reads.append(fr) or real(fr))
    try:
        f = pair.th.index("i").field("f")
        assert pair.tbe.blocks.get("i", f, tuple(range(N_SHARDS))) == (None, 8)
        assert reads == []
        pair.step("Count(Intersect(Row(f=1), Row(g=7)))")
        assert reads == []
    finally:
        pair.close()


def test_stack_ledger_keeps_its_split_across_a_splice(written, tmp_path):
    """Under a budget that holds one stack: the full build attributes its
    words to tiers, an in-place splice keeps the split and its access
    stats, a re-upload after eviction keeps counting accesses."""
    pair = _Budgeted(written, tmp_path, BUDGETS["one-stack"])
    try:
        pair.step("Count(Row(f=1))")
        led = pair.tbe.blocks.ledger()
        assert [(e["field"], e["uploads"], e["accessCount"]) for e in led] == [("f", 1, 1)]
        assert led[0]["tierBytes"]["array"] > 0
        pair.write(f"Set({SHARD_WIDTH + 11}, f=1)")
        pair.step("Count(Row(f=1))")
        led = pair.tbe.blocks.ledger()
        assert [(e["uploads"], e["accessCount"]) for e in led] == [(2, 2)]
        # Two of three shards dirty: a full rebuild, which drops the stale
        # stack before packing its successor, and keeps its ledger entry.
        rebuilt = _total(global_stats, "stack_full_rebuilds_total")
        pair.write(f"Set({12}, f=2) Set({2 * SHARD_WIDTH + 12}, f=2)")
        pair.step("Count(Row(f=2))")
        assert _total(global_stats, "stack_full_rebuilds_total") == rebuilt + 1
        led = pair.tbe.blocks.ledger()
        assert [(e["uploads"], e["accessCount"]) for e in led] == [(3, 3)]
        pair.step("Count(Row(g=7))")  # evicts f
        pair.step("Count(Row(f=2))")  # f again, its entry new
        assert [e["field"] for e in pair.tbe.blocks.ledger()] == ["f"]
    finally:
        pair.close()


def test_hbm_gauges_publish_the_ledger_split(written, tmp_path):
    """utils/monitor.py publish_hbm_gauges, the one publisher of the
    hbm_resident_bytes{tier} gauges, reads the port's ledger unchanged:
    its tier series sum to the total and equal the JAX package's
    publisher's over the JAX backend."""
    from pilosa_tpu.utils.monitor import publish_hbm_gauges as jax_publish
    from pilosa_tpu.utils.stats import StatsClient as JaxStats
    from pilosa_tpu_torch.utils.monitor import publish_hbm_gauges
    from pilosa_tpu_torch.utils.stats import StatsClient

    pair = _Budgeted(written, tmp_path, BUDGETS["one-stack"])
    try:
        for q in ("Count(Row(f=1))", "Count(Row(t=4))"):
            pair.step(q)
        got, want = StatsClient(), JaxStats()
        publish_hbm_gauges(pair.tbe.blocks, got)
        jax_publish(pair.jbe.blocks, want)
        tiers = ("dense", "array", "run")
        split = [got.with_tags(f"tier:{t}").gauge_value("hbm_resident_bytes") for t in tiers]
        assert split == [want.with_tags(f"tier:{t}").gauge_value("hbm_resident_bytes")
                         for t in tiers]
        assert sum(split) == got.gauge_value("hbm_resident_bytes") == STACK + PAGE
        assert got.gauge_value("hbm_evictions_total") == want.gauge_value(
            "hbm_evictions_total")
    finally:
        pair.close()


# ---------------------------------------------------------------------------
# the paged TopN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", ["one-byte", "two-pages"])
def test_tall_topn_streams_pages_filtered_and_not(written, tmp_path, budget):
    """A tall field's TopN sweeps ceil(T_ROWS / page) pages, one K8 launch
    and no host route each; filtered, the src tree is evaluated once (one
    vec launch) whatever the page count; Rows and 1-field GroupBy come
    from the cached counts."""
    pair = _Budgeted(written, tmp_path, BUDGETS[budget])
    n_pages = -(-T_ROWS // pair.tbe._topn_page_rows(N_SHARDS))
    try:
        launches = _launches()
        assert pair.step("TopN(t)")["hbm_page_uploads_total"] == n_pages
        assert _launched_since(launches) == {"topn": n_pages}
        for q in ("Rows(t)", "GroupBy(Rows(t))", "TopN(t, n=3)"):
            assert pair.step(q)["hbm_page_uploads_total"] == 0, q
        launches = _launches()
        assert pair.step("TopN(t, Row(g=7), n=4)")["hbm_page_uploads_total"] == n_pages + 1
        assert _launched_since(launches) == {"topn": n_pages, "vec": 1}
    finally:
        pair.close()


def test_write_between_paged_topns_resweeps(written, tmp_path):
    """The paged counts are cached with no per-shard table, as in the
    reference: a write epoch on the field sweeps its pages again, and the
    answer moves with it."""
    pair = _Budgeted(written, tmp_path, BUDGETS["one-byte"])
    try:
        first = pair.step("TopN(t, n=3)")
        assert pair.step("TopN(t, n=3)")["hbm_page_uploads_total"] == 0
        for k in range(T_ROWS):
            pair.write(f"Set({k * 997 + 13}, t=17)")
        after = pair.step("TopN(t, n=3)")
        assert after == first
        top = pair.port.execute("i", "TopN(t, n=1)")[0]
        assert [p.id for p in top.pairs] == [17]
    finally:
        pair.close()


# ---------------------------------------------------------------------------
# the JAX package's own paging cases (tests/test_tpu.py TestRowPaging)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tall_written(tmp_path_factory):
    """TestRowPaging._tall_field: 2000 rows of 3 random columns in shard 0."""
    src = str(tmp_path_factory.mktemp("tall"))
    h = JaxHolder(src).open()
    idx = h.create_index("i")
    idx.create_field("tall")
    rows = np.arange(2000, dtype=np.uint64).repeat(3)
    cols = np.random.default_rng(0).integers(0, SHARD_WIDTH, rows.size, dtype=np.uint64)
    idx.field("tall").import_bits(rows, cols)
    h.close()
    return src


@pytest.fixture
def tall(tall_written, tmp_path):
    pair = _Budgeted(tall_written, tmp_path, 16 << 20)
    yield pair
    pair.close()


def test_row_query_pages_single_row(tall):
    # The whole stack (2000 rows x 128 KiB) exceeds the 16 MiB budget.
    assert tall.tbe.blocks.get("i", tall.th.index("i").field("tall"), (0,))[0] is None
    for rid in (0, 1500, 1999, 5000):
        assert tall.step(f"Count(Row(tall={rid}))")["hbm_page_uploads_total"] == 1
    tall.step("Count(Union(Row(tall=3), Row(tall=1500)))")


def test_topn_paged_matches_oracle(tall):
    deltas = tall.step("TopN(tall, n=10)")
    page = tall.tbe._topn_page_rows(1)
    assert page == 32  # a quarter of 16 MiB over one 128 KiB row
    assert deltas["hbm_page_uploads_total"] == -(-2000 // page)
    assert "hbm_page_bytes_total" in global_stats.prometheus_text()


# ---------------------------------------------------------------------------
# threaded readers under a budget of two pages
# ---------------------------------------------------------------------------


def test_threaded_readers_of_one_paged_field(written, tmp_path):
    """8 threads read one paged field at once. While the two pages they
    name fit, each is built once (the per-key latch); then, naming more
    rows than fit, the threads thrash the LRU and every answer stays the
    oracle's."""
    pair = _Budgeted(written, tmp_path, BUDGETS["two-pages"])
    queries = [f"Count(Intersect(Row(t={a}), Row(t={b})))"
               for a, b in [(1, 2), (3, 4), (5, 6), (7, 8), (2, 9)]]
    want = {q: pair.oracle.execute("i", q) for q in queries}
    try:
        def run(qs, rounds):
            start = threading.Barrier(8)
            errors = []

            def worker(k):
                try:
                    start.wait()
                    for r in range(rounds):
                        q = qs[(k + r) % len(qs)]
                        assert pair.port.execute("i", q) == want[q], q
                except BaseException as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors, errors[0]

        uploads = _total(global_stats, "hbm_page_uploads_total")
        run(queries[:1], 3)
        assert _total(global_stats, "hbm_page_uploads_total") == uploads + 2
        assert pair.tbe.blocks.evictions == 0
        run(queries, 4)
        assert pair.tbe.blocks.resident_bytes() <= BUDGETS["two-pages"]
        assert sum(pair.tbe.blocks.tier_bytes().values()) == pair.tbe.blocks.resident_bytes()
    finally:
        pair.close()


def _launches():
    return global_stats.counter_totals("device_launches_total")


def _launched_since(before):
    """device_launches_total by kind since the ``before`` snapshot."""
    return {k.split('"')[1]: v - before.get(k, 0)
            for k, v in _launches().items() if v != before.get(k, 0)}
