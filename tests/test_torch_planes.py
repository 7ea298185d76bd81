"""The port's launch records, device-program ledger, block heat and
reuse-distance estimator (pilosa_tpu_torch/exec/cuda.py CUDABackend._launched,
_ProgramLedger, _StackedBlocks.heat_snapshot; pilosa_tpu_torch/utils/reuse.py),
run on the CPU with the kernels' plain versions, against the JAX package.

One data directory is written by the JAX package and copied: the JAX
package serves one copy and the port's CUDABackend(device="cpu") the
other. Every launch through the port's chokepoint is counted in
device_launches_total, recorded in the program ledger and, under an
EXPLAIN plan, written as one launch record with the JAX record's keys;
the estimator is held against an exact Mattson LRU simulation and against
the JAX package's estimator, and heat against the JAX backend's under one
patched clock.
"""

import json
import shutil
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu.utils import qprofile as jax_qprofile
from pilosa_tpu.utils.reuse import ReuseDistanceEstimator as JaxEstimator
from pilosa_tpu_torch.carry import open_reference_holder
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.cpu import CPUBackend
from pilosa_tpu_torch.exec.cuda import CUDABackend, _StackedBlocks
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.pql import parse_string
from pilosa_tpu_torch.server import API, Server
from pilosa_tpu_torch.utils.qprofile import (
    NOP_PROFILE, ExplainPlan, current_profile, profile_scope,
)
from pilosa_tpu_torch.utils.reuse import HASH_SPACE, ReuseDistanceEstimator
from pilosa_tpu_torch.utils.stats import global_stats
from tests.test_heat import exact_lru_hit_rate, zipf_trace
from tests.test_torch_backend import PAIR_REQUEST

N_SHARDS = 3

#: tests/test_torch_backend.py's kinds of request: a Count, Row, the pair
#: request, TopN, Sum, Min, a BSI condition and a 3-field GroupBy.
QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=7)))",
    "Row(f=2)",
    PAIR_REQUEST,
    "TopN(f, n=2)",
    "Sum(field=v)",
    "Min(field=v)",
    "Count(Row(v > 100))",
    "GroupBy(Rows(f), Rows(g), Rows(h))",
]

#: The keys of the JAX package's EXPLAIN launch record (exec/tpu.py
#: _counted_launch).
LAUNCH_KEYS = {"kind", "program", "shapes", "occupancy", "compiled", "dispatchMs",
               "bytesShipped", "bytesReturned", "devices"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Carried:
    """The JAX holder and the port's, each over its own copy of one
    directory the JAX package wrote."""

    def __init__(self, src, root):
        jdir, tdir = str(root / "jax"), str(root / "port")
        shutil.copytree(src, jdir)
        shutil.copytree(src, tdir)
        self.jh = JaxHolder(jdir).open()
        self.th = open_reference_holder(tdir)
        self.oracle = JaxExecutor(self.jh)

    def close(self):
        self.jh.close()
        self.th.close()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("jax_written"))
    ge._build_holder(src, N_SHARDS, np.random.default_rng(0)).close()
    return src


@pytest.fixture(scope="module")
def carried(written, tmp_path_factory):
    pair = _Carried(written, tmp_path_factory.mktemp("carried"))
    yield pair
    pair.close()


def _launches() -> dict:
    return global_stats.counter_totals("device_launches_total")


def _recompiles() -> float:
    return sum(global_stats.counter_totals("device_recompiles_total").values())


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def _kind(series: str) -> str:
    return series.split('kind="')[1].rstrip('"}')


# -- EXPLAIN launch records and the profile's counters ---------------------


@pytest.mark.parametrize("q", QUERIES, ids=lambda q: q[:40])
def test_explain_records_one_launch_per_counter_increase(carried, q):
    """Under an EXPLAIN plan every launch of the request writes one record:
    as many records as device_launches_total rose, each naming its kind
    and program with bytesShipped > 0; the profile carries device_launches,
    device_wait_us, bytes_shipped and bytes_returned; nothing recompiles;
    the answer is the JAX package's."""
    ex = Executor(carried.th, backend=CUDABackend(carried.th, device="cpu"))
    before, rec0 = _launches(), _recompiles()
    with profile_scope(index="i", query=q) as prof:
        prof.explain = ExplainPlan()
        got = ex.execute("i", q)
    delta = sum(_delta(_launches(), before).values())
    records = [r for c in prof.explain.calls for r in c.get("launches", [])]
    assert len(records) == delta > 0
    for r in records:
        assert r.keys() == LAUNCH_KEYS
        assert r["kind"] and r["program"] and r["shapes"]
        assert r["bytesShipped"] > 0 and r["bytesReturned"] > 0
        assert r["compiled"] is False and r["devices"] == 1 and r["dispatchMs"] >= 0
    c = prof.counters
    assert c["device_launches"] == delta
    assert c["bytes_shipped"] == sum(r["bytesShipped"] for r in records)
    assert c["bytes_returned"] == sum(r["bytesReturned"] for r in records)
    assert c["device_wait_us"] >= 0
    assert _recompiles() == rec0
    want = [jax_json(r) for r in carried.oracle.execute("i", q)]
    assert [result_to_json(r) for r in got] == want


def test_launch_record_keys_are_the_jax_records(carried):
    """The JAX backend's record of the same Count has the same keys, and
    its device_wait_us / byte counters are the profile keys the port
    fills."""
    ex = JaxExecutor(carried.jh, backend=TPUBackend(carried.jh))
    with jax_qprofile.profile_scope(index="i", query="Count(Row(f=1))") as prof:
        prof.explain = jax_qprofile.ExplainPlan()
        ex.execute("i", "Count(Row(f=1))")
    records = [r for c in prof.explain.calls for r in c.get("launches", [])]
    assert records and all(r.keys() == LAUNCH_KEYS for r in records)
    assert {"device_launches", "device_wait_us", "bytes_shipped",
            "bytes_returned"} <= prof.counters.keys()


def test_unprofiled_launch_is_counted_and_ledgered(carried):
    """Outside any profile a launch is still counted and ledgered."""
    be = CUDABackend(carried.th, device="cpu")
    before = _launches()
    c = parse_string("Row(f=1)").calls[0]
    assert current_profile() is NOP_PROFILE
    assert be.count_shards("i", c, [0, 1, 2]) == \
        Executor(carried.th, backend=CPUBackend(carried.th)).execute("i", "Count(Row(f=1))")[0]
    delta = _delta(_launches(), before)
    assert sum(delta.values()) == be.programs.counts()["launches"] == 1


# -- the program ledger -----------------------------------------------------


def test_ledger_launches_equal_the_counters(carried):
    """The ledger's launches equal device_launches_total's increase, in
    total and by kind; nothing compiles on the CPU."""
    be = CUDABackend(carried.th, device="cpu")
    ex = Executor(carried.th, backend=be)
    before = _launches()
    for q in QUERIES:
        ex.execute("i", q)
    delta = _delta(_launches(), before)
    counts = be.programs.counts()
    assert counts["launches"] == sum(delta.values()) > len(QUERIES)
    assert counts["compiles"] == counts["recompiles"] == 0
    assert counts["programs"] == len(be.programs.ledger())
    by_kind: dict = {}
    for e in be.programs.ledger():
        by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + e["launches"]
        assert e["compiles"] == 0 and e["compileSeconds"] == 0
    assert by_kind == {_kind(k): v for k, v in delta.items()}


def test_ledger_counts_launches_from_many_threads(carried):
    """Eight threads launching and reading back at once: the ledger's
    launches equal the counters' increase (one lock a launch), and every
    closed wait is folded into deviceSeconds when the ledger is read."""
    be = CUDABackend(carried.th, device="cpu")
    ex = Executor(carried.th, backend=be)
    q = "Count(Intersect(Row(f=1), Row(g=7)))"
    want = ex.execute("i", q)
    before = sum(_launches().values())
    errors = []

    def run():
        for _ in range(25):
            if ex.execute("i", q) != want:
                errors.append(q)

    threads = [threading.Thread(target=run) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    counts = be.programs.counts()
    assert counts["launches"] == 201 and sum(_launches().values()) - before == 200
    (ent,) = be.programs.ledger()
    assert ent["launches"] == 201 and ent["deviceSeconds"] > 0
    assert all(not e.waits for e in be.programs._entries.values())


def test_ledger_lists_coldest_first(carried):
    be = CUDABackend(carried.th, device="cpu")
    ex = Executor(carried.th, backend=be)
    for q in ("Count(Row(f=1))", "TopN(f, n=2)", "Count(Row(f=1))"):
        ex.execute("i", q)
    rows = be.programs.ledger()
    assert [e["kind"] for e in rows] == ["topn", "count"]
    assert rows[0]["idleSeconds"] >= rows[1]["idleSeconds"]
    assert rows[0]["lastLaunch"] <= rows[1]["lastLaunch"]
    assert [e["launches"] for e in rows] == [1, 2]


def test_two_shard_counts_are_two_programs(carried):
    """The shape signature holds the stacks' shard count: one kind over
    two shard sets is two ledger entries."""
    be = CUDABackend(carried.th, device="cpu")
    c = parse_string("Intersect(Row(f=1), Row(g=7))").calls[0]
    assert be.count_shards("i", c, [0, 1, 2]) == be.count_shards("i", c, [0, 1]) + \
        be.count_shards("i", c, [2])
    counts = [e for e in be.programs.ledger() if e["kind"] == "count"]
    assert len(counts) == 3
    assert {e["shapes"].count("(3, 8, 32768)") > 0 for e in counts} == {True, False}


def test_device_seconds_grow_at_the_readback(carried):
    """A launch parks its dispatch time on its thread; only the readback
    that waits for it closes it into the entry's deviceSeconds."""
    be = CUDABackend(carried.th, device="cpu")
    calls = [parse_string(f"Intersect(Row(f={r}), Row(g=7), Row(h=1))").calls[0]
             for r in (1, 2)]
    resolve = be.count_batch_async("i", calls, [0, 1, 2])
    (ent,) = be.programs.ledger()
    assert (ent["kind"], ent["launches"], ent["bucket"]) == ("count_batch", 1, 2)
    assert ent["deviceSeconds"] == 0
    oracle = Executor(carried.th, backend=CPUBackend(carried.th)).execute
    assert resolve() == [oracle("i", f"Count({c})")[0] for c in
                         ("Intersect(Row(f=1), Row(g=7), Row(h=1))",
                          "Intersect(Row(f=2), Row(g=7), Row(h=1))")]
    (ent,) = be.programs.ledger()
    assert ent["deviceSeconds"] > 0


def test_debug_programs_and_workload_served(carried):
    """/debug/programs on the port's server: the totals and the entries,
    whose launches sum to the total; /debug/workload charges the request's
    shape the device wait and bytes its launches recorded."""
    from pilosa_tpu_torch.utils.qprofile import global_workload_table

    global_workload_table.clear()
    be = CUDABackend(carried.th, device="cpu")
    srv = Server(API(carried.th, Executor(carried.th, backend=be)), host="127.0.0.1",
                 port=0).open()
    try:
        _post(srv, "/index/i/query", b"Count(Row(f=1)) TopN(f, n=2)")
        out = _get(srv, "/debug/programs")
        work = _get(srv, "/debug/workload")
    finally:
        srv.close()
    assert out.keys() == {"programs", "compiles", "recompiles", "launches", "entries"}
    assert out["launches"] == sum(e["launches"] for e in out["entries"]) == 2
    assert {e["kind"] for e in out["entries"]} == {"count", "topn"}
    (ent,) = work["entries"]
    assert ent["deviceSeconds"] > 0 and ent["bytesShipped"] > 0


# -- the reuse-distance estimator -------------------------------------------


class TestReuseEstimator:
    """tests/test_heat.py's estimator cases on the port's copy."""

    def test_zipf_within_5_points_of_exact(self):
        trace = zipf_trace()
        est = ReuseDistanceEstimator(max_samples=1 << 14)
        for key, nb in trace:
            est.record(key, nb)
        assert est.rate == 1.0
        for budget in (10_000, 25_000, 50_000, 100_000, 200_000, 400_000):
            exact = exact_lru_hit_rate(trace, budget)
            assert abs(est.hit_rate(budget) - exact) <= 0.05, budget

    def test_sampled_rate_still_within_5_points(self):
        trace = zipf_trace(n_keys=800, n_refs=40_000, seed=11)
        est = ReuseDistanceEstimator(max_samples=512)
        for key, nb in trace:
            est.record(key, nb)
        assert est.rate < 1.0
        for budget in (50_000, 100_000, 200_000, 400_000):
            exact = exact_lru_hit_rate(trace, budget)
            assert abs(est.hit_rate(budget) - exact) <= 0.05, budget

    def test_scan_trace_is_all_misses_below_footprint(self):
        n, nb = 100, 1000
        trace = [((i % n,), nb) for i in range(10 * n)]
        est = ReuseDistanceEstimator()
        for key, b in trace:
            est.record(key, b)
        assert est.hit_rate(n * nb // 2) == 0.0
        assert abs(est.hit_rate(n * nb * 1.1) - exact_lru_hit_rate(trace, n * nb)) <= 0.05

    def test_rejection_path_touches_nothing(self):
        est = ReuseDistanceEstimator()
        est._threshold = 0
        for i in range(1000):
            assert est.record((i,), 1000) is False
        assert est.samples == 0 and len(est._stack) == 0 and est._hist == {}

    def test_curve_is_monotonic_and_bounded(self):
        est = ReuseDistanceEstimator()
        for key, nb in zipf_trace(n_refs=5000):
            est.record(key, nb)
        pts = est.curve(points=16)
        assert 0 < len(pts) <= 17
        rates = [p["hitRate"] for p in pts]
        assert rates == sorted(rates) and all(0.0 <= r <= 1.0 for r in rates)
        budgets = [p["budgetBytes"] for p in pts]
        assert budgets == sorted(budgets)

    def test_shards_max_keeps_stack_bounded(self):
        est = ReuseDistanceEstimator(max_samples=32)
        for i in range(10_000):
            est.record((i,), 100)
        assert len(est._stack) <= 32 and est._threshold < HASH_SPACE

    @pytest.mark.parametrize("max_samples", [4096, 256])
    def test_same_snapshot_as_the_jax_estimator(self, max_samples):
        """The same trace through both packages' estimators: the same
        admissions, histogram and curve."""
        ours, theirs = ReuseDistanceEstimator(max_samples), JaxEstimator(max_samples)
        for key, nb in zipf_trace(n_keys=600, n_refs=8000, seed=3):
            assert ours.record(key, nb) == theirs.record(key, nb)
        assert ours.snapshot() == theirs.snapshot()
        assert ours.hit_rate(123_456) == theirs.hit_rate(123_456)

    @pytest.mark.parametrize("max_samples", [4096, 256])
    def test_offered_queue_records_as_record_does(self, max_samples):
        """offer() queues what the block store sees and flushes at
        QUEUE_CAP and before each read: the snapshot is the JAX
        estimator's on the same trace, and on_samples hears every
        admission once."""
        heard = []
        ours = ReuseDistanceEstimator(max_samples, on_samples=heard.append)
        theirs = JaxEstimator(max_samples)
        trace = zipf_trace(n_keys=600, n_refs=8000, seed=5)
        admitted = 0
        for key, nb in trace:
            ours.offer(key, nb)
            admitted += theirs.record(key, nb)
            assert len(ours._queue) < ReuseDistanceEstimator.QUEUE_CAP
        assert ours.snapshot() == theirs.snapshot()
        assert sum(heard) == admitted == ours.samples and len(heard) > 1
        assert ours.flush() == 0 and not ours._queue


# -- block heat ---------------------------------------------------------------


class TestHeat:
    def test_heat_halves_over_one_half_life(self):
        blocks = _StackedBlocks(torch.device("cpu"), heat_half_life=10.0)
        led = {"access_count": 0}
        blocks._bump_heat(led)
        assert led["heat"] == 1.0
        led["last_access"] -= 10.0
        blocks._bump_heat(led)
        assert led["heat"] == pytest.approx(1.5, abs=1e-3)
        assert led["access_count"] == 2

    def test_fresh_entry_skips_decay(self):
        blocks = _StackedBlocks(torch.device("cpu"), heat_half_life=10.0)
        led = {"access_count": 0}
        blocks._bump_heat(led)
        assert led["heat"] == 1.0

    def test_default_half_life(self):
        blocks = _StackedBlocks(torch.device("cpu"))
        assert blocks.heat_half_life == _StackedBlocks.HEAT_HALF_LIFE == 300.0

    def test_heat_snapshot_tiers_sum_to_entry_heat(self, carried):
        be = CUDABackend(carried.th, device="cpu", heat_half_life=60.0)
        ex = Executor(carried.th, backend=be)
        for _ in range(5):
            ex.execute("i", "Count(Intersect(Row(f=1), Row(g=7)))")
        snap = be.blocks.heat_snapshot()
        assert snap["halfLifeSeconds"] == 60.0
        ent = snap["entries"][0]
        assert ent["heat"] > 0 and ent["accessCount"] >= 5
        assert sum(snap["tierHeat"].values()) == pytest.approx(
            sum(e["heat"] for e in snap["entries"]), rel=1e-3)
        top1 = be.blocks.heat_snapshot(entries=1)
        assert len(top1["entries"]) == 1
        for t in snap["tierHeat"]:
            assert top1["tierHeat"][t] == pytest.approx(snap["tierHeat"][t], abs=0.01)
        assert be.blocks.heat_snapshot(entries=0)["entries"] == []

    def test_block_hits_feed_reuse_estimator(self, carried):
        be = CUDABackend(carried.th, device="cpu")
        ex = Executor(carried.th, backend=be)
        samples0 = sum(global_stats.counter_totals("reuse_distance_samples_total").values())
        for _ in range(6):
            ex.execute("i", "Count(Row(f=1))")
        reuse = be.blocks.reuse.snapshot()
        assert reuse["samples"] >= 6
        assert reuse["finiteWeight"] > 0 and reuse["curve"]
        assert sum(global_stats.counter_totals(
            "reuse_distance_samples_total").values()) - samples0 == reuse["samples"]

    def test_same_heat_and_reuse_as_the_jax_backend(self, carried, monkeypatch):
        """One access sequence through both backends under one patched
        clock: the port's reuse snapshot equals the JAX backend's, and its
        heat snapshot equals it within 1e-9."""
        clock = [1000.0]
        monkeypatch.setattr(time, "monotonic", lambda: clock[0])
        jbe = TPUBackend(carried.jh, heat_half_life=30.0)
        tbe = CUDABackend(carried.th, device="cpu", heat_half_life=30.0)
        jex, tex = JaxExecutor(carried.jh, backend=jbe), Executor(carried.th, backend=tbe)
        seq = ["Count(Intersect(Row(f=1), Row(g=7)))", "TopN(f, n=2)", "Row(f=2)",
               "Count(Row(h=1))", "Count(Intersect(Row(f=1), Row(g=7)))", "Count(Row(h=1))"]
        for k, q in enumerate(seq):
            clock[0] += 7.0 + k
            assert [result_to_json(r) for r in tex.execute("i", q)] == \
                [jax_json(r) for r in jex.execute("i", q)]
        clock[0] += 11.0
        assert tbe.blocks.reuse.snapshot() == jbe.blocks.reuse.snapshot()
        got, want = tbe.blocks.heat_snapshot(), jbe.blocks.heat_snapshot()
        assert got["halfLifeSeconds"] == want["halfLifeSeconds"] == 30.0
        assert [(e["field"], e["bytes"], e["accessCount"], e["idleSeconds"])
                for e in got["entries"]] == \
            [(e["field"], e["bytes"], e["accessCount"], e["idleSeconds"])
             for e in want["entries"]]
        for a, b in zip(got["entries"], want["entries"]):
            assert abs(a["heat"] - b["heat"]) <= 1e-9
        for t in want["tierHeat"]:
            assert abs(got["tierHeat"][t] - want["tierHeat"][t]) <= 1e-9


def _post(srv, path, body=b"{}"):
    r = urllib.request.Request(srv.uri + path, data=body, method="POST",
                               headers={"Content-Type": "text/plain"})
    return json.loads(urllib.request.urlopen(r).read())


def _get(srv, path):
    return json.loads(urllib.request.urlopen(srv.uri + path).read())


def test_debug_heat_serves_heat_and_curve(carried):
    """/debug/heat on the port's server: heat, the tier rollup and the
    reuse curve; ?top=N cuts the entries, not the rollup."""
    be = CUDABackend(carried.th, device="cpu")
    srv = Server(API(carried.th, Executor(carried.th, backend=be)), host="127.0.0.1",
                 port=0).open()
    try:
        for _ in range(4):
            _post(srv, "/index/i/query", b"Count(Intersect(Row(f=1), Row(g=7)))")
        out = _get(srv, "/debug/heat")
        top = _get(srv, "/debug/heat?top=1")
    finally:
        srv.close()
    assert out["halfLifeSeconds"] == 300.0
    assert set(out["tierHeat"]) == {"dense", "array", "run"}
    assert len(out["entries"]) == 2 and out["entries"][0]["heat"] > 0
    assert out["reuse"]["samples"] > 0 and isinstance(out["reuse"]["curve"], list)
    assert len(top["entries"]) == 1
    for t in out["tierHeat"]:
        assert top["tierHeat"][t] == pytest.approx(out["tierHeat"][t], abs=0.01)
