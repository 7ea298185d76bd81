"""The port's shard-leg batcher (pilosa_tpu_torch/exec/batcher.py) against
the JAX package's (pilosa_tpu/exec/batcher.py).

- tests/test_batcher.py's StubBackend scenarios (leg composition, result
  scatter, error isolation, telemetry) against the port's
  ShardLegBatcher, and one deterministic window through both batchers:
  the same backend dispatches, group for group.
- The concurrent differential: threads through the port's Executor with
  a batcher over CUDABackend(device="cpu") answer what the JAX Executor
  with a batcher over TPUBackend and the unbatched executors answer, on
  one JAX-written data directory, and the window really coalesces.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec.batcher import ShardLegBatcher as JaxBatcher
from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu_torch.carry import open_reference_holder
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.batcher import CountBatcher, LEG_KINDS, ShardLegBatcher
from pilosa_tpu_torch.exec.cpu import CPUBackend
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.utils.stats import global_stats
from tests.test_batcher import DIFF_QUERIES, StubBackend, _build_index, _run_threads


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestLegComposition:
    def test_mixed_kinds_group_per_kind(self):
        be = StubBackend()
        b = ShardLegBatcher(be, window=0.3)
        shards = [0, 1]
        filt = object()
        got = _run_threads([
            lambda: b.count("i", [1, 2], shards),
            lambda: b.count("i", [3], shards),
            lambda: b.row("i", "rowA", shards),
            lambda: b.row("i", "rowB", shards),
            lambda: b.bsi("bsi_sum", "i", "v", shards, None),
            lambda: b.bsi("bsi_sum", "i", "v", shards, None),
            lambda: b.bsi("bsi_min", "i", "v", shards, None),
            lambda: b.topn("i", "f", shards, 2, filt),
            lambda: b.topn("i", "f", shards, 0, filt),
        ])
        assert not any(isinstance(g, Exception) for g in got), got
        assert len(be.count_groups) == 1
        assert sorted(be.count_groups[0][0]) == [1, 2, 3]
        assert sorted(got[0]) + got[1] == [10, 20, 30]
        assert len(be.row_groups) == 1
        assert sorted(be.row_groups[0][0]) == ["rowA", "rowB"]
        assert got[2] == ("row", "rowA") and got[3] == ("row", "rowB")
        assert be.bsi_calls.count(("bsi_sum", "v", None)) == 1
        assert be.bsi_calls.count(("bsi_min", "v", None)) == 1
        assert got[4] == got[5] == (100, 7)
        assert got[6] == (1, 2)
        assert len(be.topn_calls) == 1
        assert got[7] == [(0, 50), (1, 49)]
        assert len(got[8]) == 5

    def test_count_scatter_respects_leg_boundaries(self):
        b = ShardLegBatcher(StubBackend(), window=0.2)
        got = _run_threads([lambda: b.count("i", [1, 2], [0]), lambda: b.count("i", [7], [0])])
        assert got == [[10, 20], [70]]

    def test_distinct_shard_sets_do_not_share_a_group(self):
        be = StubBackend()
        b = ShardLegBatcher(be, window=0.2)
        got = _run_threads([lambda: b.count("i", [1], [0]), lambda: b.count("i", [2], [0, 1])])
        assert got == [[10], [20]]
        assert {g[1] for g in be.count_groups} == {(0,), (0, 1)}

    def test_uncontended_leg_dispatches_immediately(self):
        b = ShardLegBatcher(StubBackend(), window=0.0)
        assert b.count("i", [4], [0]) == [40]
        assert b.row("i", "r", [0]) == ("row", "r")
        assert b.bsi("bsi_sum", "i", "v", [0]) == (100, 7)
        assert b.topn("i", "f", [0], 1) == [(0, 50)]

    def test_countbatcher_alias_and_leg_kinds(self):
        assert CountBatcher is ShardLegBatcher
        assert LEG_KINDS == ("count", "row", "bsi_sum", "bsi_min", "bsi_max", "topn")
        with pytest.raises(ValueError, match="unknown bsi leg kind"):
            ShardLegBatcher(StubBackend()).bsi("topn", "i", "v", [0])


class TestErrorIsolation:
    def test_bad_count_leg_fails_only_its_submitter(self):
        b = ShardLegBatcher(StubBackend(), window=0.25)
        got = _run_threads([
            lambda: b.count("i", [1], [0]),
            lambda: b.count("i", [StubBackend.BAD], [0]),
            lambda: b.count("i", [5], [0]),
        ])
        assert len([g for g in got if isinstance(g, ValueError)]) == 1
        assert sorted(g[0] for g in got if isinstance(g, list)) == [10, 50]

    def test_group_failure_retries_individually(self):
        be = StubBackend()
        be.fail_count_groups = True
        b = ShardLegBatcher(be, window=0.25)
        before = global_stats.counter_totals("batch_dispatch_errors_total").get(
            'batch_dispatch_errors_total{kind="count"}', 0)
        got = _run_threads([lambda: b.count("i", [1], [0]), lambda: b.count("i", [2], [0])])
        assert sorted(g[0] for g in got) == [10, 20]
        assert sorted(c[0] for c in be.individual_counts) == [1, 2]
        after = global_stats.counter_totals("batch_dispatch_errors_total")
        assert after['batch_dispatch_errors_total{kind="count"}'] == before + 1

    def test_bad_row_leg_fails_only_its_submitter(self):
        b = ShardLegBatcher(StubBackend(), window=0.25)
        got = _run_threads([lambda: b.row("i", "good", [0]),
                            lambda: b.row("i", StubBackend.BAD, [0])])
        assert len([g for g in got if isinstance(g, ValueError)]) == 1
        assert ("row", "good") in got

    def test_bad_sync_leg_fails_only_its_dedupe_set(self):
        b = ShardLegBatcher(StubBackend(), window=0.25)
        got = _run_threads([lambda: b.bsi("bsi_sum", "i", "v", [0]),
                            lambda: b.bsi("bsi_sum", "i", "boom", [0])])
        assert len([g for g in got if isinstance(g, ValueError)]) == 1
        assert (100, 7) in got


class TestTelemetry:
    def test_occupancy_and_coalesce_counters(self):
        before = dict(global_stats.snapshot()["counters"])
        b = ShardLegBatcher(StubBackend(), window=0.25)
        got = _run_threads([lambda k=k: b.count("i", [k], [0]) for k in (1, 2, 3)])
        assert sorted(g[0] for g in got) == [10, 20, 30]
        after = dict(global_stats.snapshot()["counters"])

        def delta(name):
            return after.get(name, 0.0) - before.get(name, 0.0)

        assert delta('batch_legs_total{kind="count"}') == 3
        assert delta('batch_coalesced_total{kind="count"}') == 2
        occ = global_stats.histogram_snapshot().get('batch_occupancy{kind="count"}')
        assert occ is not None and occ["count"] >= 1


def _window(batcher_cls):
    """One deterministic mixed window through batcher_cls over a fresh
    StubBackend: (its dispatch record, the submitters' results)."""
    be = StubBackend()
    b = batcher_cls(be, window=0.3)
    filt = "Row(g=1)"  # one parsed tree shared by two legs
    got = _run_threads([
        lambda: b.count("i", [1, 2], [0, 1]),
        lambda: b.count("i", [3], [0, 1]),
        lambda: b.count("i", [4], [0]),
        lambda: b.row("i", "x", [0, 1]),
        lambda: b.row("i", "y", [0, 1]),
        lambda: b.bsi("bsi_sum", "i", "v", [0, 1]),
        lambda: b.bsi("bsi_sum", "i", "v", [0, 1]),
        lambda: b.bsi("bsi_min", "i", "w", [0, 1], filt),
        lambda: b.topn("i", "f", [0, 1], 3),
        lambda: b.topn("i", "f", [0, 1], 1),
    ])
    record = (
        sorted((sorted(c), s) for c, s in be.count_groups),
        sorted((sorted(c), s) for c, s in be.row_groups),
        sorted(be.bsi_calls, key=repr),
        be.topn_calls,
    )
    return record, got


def test_same_window_same_groups_as_jax():
    """The port's batcher groups, dedupes and scatters one window exactly
    as the JAX package's does."""
    jax_record, jax_got = _window(JaxBatcher)
    port_record, port_got = _window(ShardLegBatcher)
    assert port_record == jax_record
    assert port_got == jax_got
    assert port_record[0] == [([1, 2, 3], (0, 1)), ([4], (0,))]


# ---------------------------------------------------------------------------
# the concurrent differential on real backends
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(JAX holder, port holder) over two copies of one JAX-written data
    directory: tests/test_batcher.py's index."""
    src = str(tmp_path_factory.mktemp("jax_batch"))
    h = JaxHolder(src).open()
    _build_index(h, np.random.default_rng(0))
    h.close()
    dst = str(tmp_path_factory.mktemp("carried_batch")) + "/data"
    shutil.copytree(src, dst)
    jh = JaxHolder(src).open()
    th = open_reference_holder(dst)
    yield jh, th
    jh.close()
    th.close()


QUERIES = DIFF_QUERIES + [
    "Count(Intersect(Row(f=1), Row(f=2), Row(g=9)))",
    "Count(Not(Row(f=1)))",
    "Count(Row(v > 100))",
    "Not(Row(g=9))",
    "Row(v >< [-50, 50])",
]


def test_batched_equals_jax_and_unbatched_under_concurrency(carried):
    jh, th = carried
    want = {q: [jax_json(r) for r in JaxExecutor(jh).execute("i", q)] for q in QUERIES}
    jbe = TPUBackend(jh)
    jex = JaxExecutor(jh, backend=jbe)
    jex.batcher = JaxBatcher(jbe, window=0.2)
    be = CUDABackend(th, device="cpu")
    ex = Executor(th, backend=be)
    ex.batcher = ShardLegBatcher(be, window=0.2)
    plain = Executor(th, backend=CUDABackend(th, device="cpu"))
    oracle = Executor(th, backend=CPUBackend(th))
    coalesced0 = sum(global_stats.counter_totals("batch_coalesced_total").values())
    routed0 = sum(global_stats.counter_totals("cpu_routed_total").values())

    def run(executor, encode):
        return lambda q: (lambda: [encode(r) for r in executor.execute("i", q)])

    port_got = _run_threads([run(ex, result_to_json)(q) for q in QUERIES])
    jax_got = _run_threads([run(jex, jax_json)(q) for q in QUERIES])
    for q, g, j in zip(QUERIES, port_got, jax_got):
        assert not isinstance(g, Exception), (q, g)
        assert g == want[q] and j == want[q], q
        assert [result_to_json(r) for r in plain.execute("i", q)] == want[q], q
        assert [result_to_json(r) for r in oracle.execute("i", q)] == want[q], q
    assert sum(global_stats.counter_totals("batch_coalesced_total").values()) > coalesced0
    assert sum(global_stats.counter_totals("cpu_routed_total").values()) == routed0


def test_single_queries_through_the_batcher(carried):
    """window=0: each query alone through the batcher (a Count run of one
    included) equals the unbatched executor's answer."""
    _, th = carried
    be = CUDABackend(th, device="cpu")
    ex = Executor(th, backend=be)
    ex.batcher = ShardLegBatcher(be, window=0.0)
    oracle = Executor(th, backend=CPUBackend(th))
    legs0 = global_stats.counter_totals("batch_legs_total")
    for q in QUERIES:
        assert ([result_to_json(r) for r in ex.execute("i", q)]
                == [result_to_json(r) for r in oracle.execute("i", q)]), q
    legs = global_stats.counter_totals("batch_legs_total")
    key = 'batch_legs_total{kind="count"}'
    assert legs[key] - legs0.get(key, 0) == sum(q.startswith("Count") for q in QUERIES)


def test_count_window_coalesces_into_one_k11_launch(carried):
    """Concurrent 3-row Counts, which the pair plan cannot serve, drain as
    one count window: fewer count_batch launches than legs."""
    _, th = carried
    be = CUDABackend(th, device="cpu")
    ex = Executor(th, backend=be)
    ex.batcher = ShardLegBatcher(be, window=0.2)
    qs = [f"Count(Intersect(Row(f={a}), Row(f={b}), Row(g=9)))" for a in (1, 2) for b in (1, 2)]
    want = {q: Executor(th, backend=CPUBackend(th)).execute("i", q) for q in qs}
    key = 'device_launches_total{kind="count_batch"}'
    before = global_stats.counter_totals("device_launches_total").get(key, 0)
    barrier = threading.Barrier(len(qs))

    def run(q):
        def go():
            barrier.wait()
            return ex.execute("i", q)
        return go

    got = _run_threads([run(q) for q in qs])
    assert got == [want[q] for q in qs]
    launches = global_stats.counter_totals("device_launches_total")[key] - before
    assert 1 <= launches < len(qs)
