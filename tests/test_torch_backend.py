"""The port's CUDABackend (pilosa_tpu_torch/exec/cuda.py), run on the CPU
with the kernels' plain versions, against the JAX package.

One holder directory is written by the JAX package and carried across
with carry.open_reference_holder. Each package then serves the same query
list from its own copy of that directory, through the same write-churn
epochs: the port's CUDABackend(device="cpu") must give exactly the
answers of the JAX TPUBackend (conftest CPU platform) and of the JAX CPU
oracle. Answers compare as the HTTP layer encodes them.
"""

import shutil

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu_torch.carry import open_reference_holder
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.cpu import CPUBackend
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.stats import global_stats

N_SHARDS = 4

# tests/test_tpu_live.py's list, cut to the slice's Count/Row queries, with
# the other two-row verbs, All, and Not over a union.
SLICE_QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=7)))",
    "Count(Union(Row(f=1), Row(f=2), Row(f=3)))",
    "Count(Not(Row(f=1)))",
    "Row(f=2)",
    "Count(Row(f=3))",
    "Count(Difference(Row(f=2), Row(g=7)))",
    "Count(Xor(Row(f=1), Row(g=7)))",
    "Count(All())",
    "Not(Union(Row(f=1), Row(g=7)))",
    "Intersect(Row(f=3), Row(g=7))",
    "Count(Row(f=99))",
]
# Routed to the host by the port, each counted once in cpu_routed_total
# under its call's name: a BSI condition (through count_shards), a TopN and
# Sum/Min/Max (answered on the host, the backend unused but for a filter).
ROUTED_QUERIES = [
    "Count(Row(v > 100))", "TopN(f, n=2)",
    "Sum(field=v)", "Sum(Row(f=1), field=v)",
    "Min(field=v)", "Min(Row(g=7), field=v)",
    "Max(field=v)", "Max(Intersect(Row(f=2), Row(g=7)), field=v)",
]

# One request of 16 Counts over the field pair (f, g): one pair sweep.
PAIR_REQUEST = " ".join(
    [f"Count(Intersect(Row(f={a}), Row(g={b})))" for a in (1, 2, 3) for b in (0, 7)]
    + [f"Count(Union(Row(f={a}), Row(g=7)))" for a in (1, 2, 3)]
    + [f"Count(Difference(Row(f={a}), Row(g=7)))" for a in (1, 2, 3)]
    + [f"Count(Xor(Row(f={a}), Row(g=7)))" for a in (1, 2)]
    + ["Count(Row(f=2))", "Count(Row(g=7))"]
)

# Write-churn epochs: Set/Clear on at most two of the four shards, so the
# resident stacks are spliced, not rebuilt.
EPOCHS = [
    [f"Set({SHARD_WIDTH + 5}, f=1)", f"Set({SHARD_WIDTH + 6}, g=7)",
     f"Clear({SHARD_WIDTH + 5}, f=2)", f"Set({SHARD_WIDTH + 9}, f=3)"],
    [f"Set({3 * SHARD_WIDTH + 1}, f=2)", f"Set({3 * SHARD_WIDTH + 1}, g=7)",
     f"Clear({SHARD_WIDTH + 6}, g=7)", f"Set({SHARD_WIDTH + 70000}, f=1)"],
]


def _counter(prefix: str) -> float:
    return sum(global_stats.counter_totals(prefix).values())


def _pair_served() -> float:
    """Pair-path requests: one sweep or one fresh-cache hit each."""
    return _counter("pair_stats_sweeps_total") + _counter("pair_stats_cache_hits_total")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX oracle, JAX TPUBackend, port oracle, port CUDABackend)
    executors over two copies of one JAX-written data directory."""
    src = str(tmp_path_factory.mktemp("jax_written"))
    h = ge._build_holder(src, N_SHARDS, np.random.default_rng(0))
    h.close()
    dst = str(tmp_path_factory.mktemp("carried")) + "/data"
    shutil.copytree(src, dst)

    jh = JaxHolder(src).open()
    th = open_reference_holder(dst)
    backend = CUDABackend(th, device="cpu")
    yield (JaxExecutor(jh), JaxExecutor(jh, backend=TPUBackend(jh)),
           Executor(th, backend=CPUBackend(th)), Executor(th, backend=backend), backend)
    jh.close()
    th.close()


def _answers(pair, q):
    jcpu, jdev, tcpu, tdev, _ = pair
    return (
        [jax_json(r) for r in jcpu.execute("i", q)],
        [jax_json(r) for r in jdev.execute("i", q)],
        [result_to_json(r) for r in tcpu.execute("i", q)],
        [result_to_json(r) for r in tdev.execute("i", q)],
    )


def _check_all(pair):
    routed = _counter("cpu_routed_total")
    for q in SLICE_QUERIES:
        want, jdev, tcpu, got = _answers(pair, q)
        assert jdev == want, q
        assert tcpu == want, q
        assert got == want, q
    assert _counter("cpu_routed_total") == routed, "a slice query left the device"

    served = _pair_served()
    want, jdev, tcpu, got = _answers(pair, PAIR_REQUEST)
    assert len(want) == 16
    assert jdev == want and tcpu == want and got == want
    assert _pair_served() == served + 1, "the request left the pair path"

    for q in ROUTED_QUERIES:
        want, jdev, tcpu, got = _answers(pair, q)
        assert jdev == want and tcpu == want and got == want, q


def _write(pair, epoch):
    jcpu, _, tcpu, _, _ = pair
    for q in EPOCHS[epoch]:
        assert jcpu.execute("i", q) == tcpu.execute("i", q)


def test_answers_equal_jax_across_churn_epochs(pair):
    _check_all(pair)
    for epoch in range(len(EPOCHS)):
        spliced = _counter("stack_incremental_updates_total")
        rebuilt = _counter("stack_full_rebuilds_total")
        _write(pair, epoch)
        _check_all(pair)
        assert _counter("stack_incremental_updates_total") > spliced
        assert _counter("stack_full_rebuilds_total") == rebuilt


def test_bsi_condition_is_routed_and_counted(pair):
    before = global_stats.counter_totals("cpu_routed_total")
    want, _, _, got = _answers(pair, "Count(Row(v > 100))")
    assert got == want
    after = global_stats.counter_totals("cpu_routed_total")
    key = 'cpu_routed_total{call="Row"}'
    assert after[key] == before.get(key, 0) + 1


@pytest.mark.parametrize("q", ROUTED_QUERIES)
def test_routed_queries_are_counted_once(pair, q):
    call = q[: q.index("(")]
    key = f'cpu_routed_total{{call="{"Row" if call == "Count" else call}"}}'
    before = global_stats.counter_totals("cpu_routed_total")
    want, _, _, got = _answers(pair, q)
    assert got == want
    after = global_stats.counter_totals("cpu_routed_total")
    assert after[key] == before.get(key, 0) + 1
    assert sum(after.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("q", [
    "Sum(Row(f=1), field=v)", "Min(Row(g=7), field=v)", "Max(Row(f=3), field=v)",
    "MinRow(Row(g=7), field=f)", "MaxRow(Row(g=7), field=f)", "TopN(f, Row(g=7), n=2)",
])
def test_filter_is_evaluated_once_per_request(pair, q):
    """A host-answered call's filter runs one whole-query evaluation over
    the shard set, not one per shard (nor one per TopN pass)."""
    tdev = pair[3]
    key = 'device_launches_total{kind="vec"}'
    before = global_stats.counter_totals("device_launches_total").get(key, 0)
    want, _, _, got = _answers(pair, q)
    assert got == want
    assert global_stats.counter_totals("device_launches_total")[key] == before + 1
    assert len(tdev.holder.index("i").available_shards_list()) == N_SHARDS


def test_single_counts_take_popcount_program(pair):
    tdev = pair[3]
    key = 'device_launches_total{kind="count"}'
    before = global_stats.counter_totals("device_launches_total").get(key, 0)
    tdev.execute("i", "Count(Intersect(Row(f=1), Row(g=7)))")
    assert global_stats.counter_totals("device_launches_total")[key] == before + 1


def test_pair_request_repeats_from_cache(pair):
    hits = _counter("pair_stats_cache_hits_total")
    sweeps = _counter("pair_stats_sweeps_total")
    first = _answers(pair, PAIR_REQUEST)
    second = _answers(pair, PAIR_REQUEST)
    assert first == second
    assert _counter("pair_stats_sweeps_total") <= sweeps + 1
    assert _counter("pair_stats_cache_hits_total") >= hits + 1


def test_pair_gates_match_jax(pair):
    backend = pair[4]
    ref = TPUBackend.__new__(TPUBackend)
    for s_pad, rf, rg in [(954, 8, 8), (4, 256, 256), (4, 256, 257),
                          (3000, 64, 64), (1500, 64, 64), (954, 1, 1)]:
        assert backend._pair_gates(s_pad, rf, rg) == ref._pair_gates(s_pad, rf, rg)


def test_budget_too_small_routes_to_cpu(pair):
    tcpu = pair[2]
    th = tcpu.holder
    small = Executor(th, backend=CUDABackend(th, device="cpu", max_bytes=1))
    q = "Count(Intersect(Row(f=1), Row(g=7)))"
    before = _counter("cpu_routed_total")
    assert small.execute("i", q) == tcpu.execute("i", q)
    assert _counter("cpu_routed_total") == before + 1


def _small_port_holder():
    from pilosa_tpu_torch.core import Holder

    h = Holder(None).open()
    idx = h.create_index("i")
    for name in ("f", "g", "h"):
        idx.create_field(name).import_bits(
            np.array([1, 2], dtype=np.uint64),
            np.array([3, SHARD_WIDTH + 4], dtype=np.uint64),
        )
    return h


def test_stack_budget_evicts_lru_and_makes_room():
    from pilosa_tpu_torch.exec.cuda import _StackedBlocks

    h = _small_port_holder()
    idx = h.index("i")
    one = 2 * 8 * 32768 * 4  # two shards x 8 padded rows x W words
    blocks = _StackedBlocks(torch.device("cpu"), max_bytes=2 * one)
    shards = (0, 1)
    for name in ("f", "g", "h"):
        stack, rows_p = blocks.get("i", idx.field(name), shards)
        assert tuple(stack.shape) == (2, rows_p, 32768) and rows_p == 8
    assert blocks.evictions == 1 and blocks.resident_bytes() == 2 * one
    blocks.make_room(one)
    assert blocks.evictions == 2 and blocks.resident_bytes() == one
    # A stack larger than the whole budget is never resident.
    tiny = _StackedBlocks(torch.device("cpu"), max_bytes=one - 1)
    assert tiny.get("i", idx.field("f"), shards) == (None, 8)


def test_stack_versions_follow_the_splice():
    from pilosa_tpu_torch.exec.cuda import _StackedBlocks

    h = _small_port_holder()
    f = h.index("i").field("f")
    blocks = _StackedBlocks(torch.device("cpu"))
    stack, _, vers = blocks.get_with_versions("i", f, (0, 1))
    f.set_bit(5, SHARD_WIDTH + 9)
    spliced, _, vers2 = blocks.get_with_versions("i", f, (0, 1))
    assert spliced is stack  # updated in place, one copy on the device
    assert vers2[0] == vers[0] and vers2[1] != vers[1]
    words = spliced[1, 5].numpy().view(np.uint32)
    assert words[0] == 1 << 9
