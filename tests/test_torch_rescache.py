"""The port's result cache (pilosa_tpu_torch/exec/rescache.py) against the
JAX package's (pilosa_tpu/exec/rescache.py).

One script of reads, Set/Clear writes, attribute writes, bypassed reads
and a bounded-staleness window runs through two executors over two copies
of one JAX-written data directory, each with its own ResultCache: the JAX
Executor and the port's Executor over CUDABackend(device="cpu"). At every
step both give the same answers, the same per-request cache verdicts
(hits, stale hits, misses, bypasses, uncached) and the same debug_dump
totals; cached answers equal the uncached executor's.
"""

import shutil

import numpy as np
import pytest
import torch

from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.core.field import options_for_int
from pilosa_tpu.exec import ExecOptions as JaxExecOptions
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec.rescache import ResultCache as JaxResultCache
from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.shardwidth import SHARD_WIDTH
from pilosa_tpu.utils.qprofile import profile_scope as jax_profile_scope
from pilosa_tpu_torch.carry import open_reference_holder
from pilosa_tpu_torch.exec import ExecOptions, Executor
from pilosa_tpu_torch.exec.cpu import CPUBackend
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.exec.rescache import ResultCache, result_nbytes
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.utils.qprofile import profile_scope


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


READS = [
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Row(f=1)) Count(Row(g=3))",
    "Row(f=1)",
    "Union(Row(f=2), Row(g=2))",
    "Count(Not(Row(f=3)))",
    "Count(Row(v > 0))",
    "TopN(f, n=2)",
    "Sum(field=v)",
    "Min(Row(g=1), field=v)",
    "Max(field=v)",
    "GroupBy(Rows(f), Rows(g))",
    "Rows(f)",  # uncacheable: passes through
]

# (step, queries, options): every read, then writes, reads, attribute
# writes, reads and bypassed reads.
SCRIPT = [
    ("cold", READS, {}),
    ("warm", READS, {}),
    ("set f in shard 0", ["Set(7, f=1)"], {}),
    ("after set", READS, {}),
    ("clear g in shard 2", [f"Clear({2 * SHARD_WIDTH + 11}, g=2)", f"Set({2 * SHARD_WIDTH + 11}, g=2)"], {}),
    ("after clear", READS, {}),
    ("warm again", READS, {}),
    ("set v", ["Set(3, v=-77)"], {}),
    ("after set v", READS, {}),
    ("row attrs", ["SetRowAttrs(f, 1, color=\"red\")"], {}),
    ("after row attrs", READS, {}),
    ("column attrs", ["SetColumnAttrs(5, tag=\"x\")"], {}),
    ("after column attrs", READS, {}),
    ("bypass", READS, {"cache_bypass": True}),
    ("after bypass", READS, {}),
]


def _build(path):
    """tests/test_rescache.py's holder (three shards of f and g, rows 0 to
    3, and v in [-10000, 10000]), written by the JAX package."""
    h = JaxHolder(path).open()
    idx = h.create_index("i")
    f = idx.create_field("f")
    g = idx.create_field("g")
    rng = np.random.default_rng(5)
    for shard in range(3):
        base = shard * SHARD_WIDTH
        for field in (f, g):
            rows = np.repeat(np.arange(4, dtype=np.uint64), 200)
            cols = rng.integers(0, SHARD_WIDTH, rows.size).astype(np.uint64) + base
            field.import_bits(rows, cols)
            idx.existence_field().import_bits(np.zeros(cols.size, dtype=np.uint64), cols)
    v = idx.create_field("v", options_for_int(-10000, 10000))
    cols = np.unique(np.arange(300, dtype=np.uint64) * 17 % (3 * SHARD_WIDTH))
    v.import_value(cols, (cols.astype(np.int64) % 400) - 200)
    h.close()


@pytest.fixture
def pair(tmp_path):
    src = str(tmp_path / "jax")
    _build(src)
    dst = str(tmp_path / "carried")
    shutil.copytree(src, dst)
    jh = JaxHolder(src).open()
    th = open_reference_holder(dst)
    yield jh, th
    jh.close()
    th.close()


def _executors(jh, th, max_staleness=0):
    jex = JaxExecutor(jh)
    jex.rescache = JaxResultCache(jh, max_bytes=1 << 20, max_staleness=max_staleness)
    tex = Executor(th, backend=CUDABackend(th, device="cpu"))
    tex.rescache = ResultCache(th, max_bytes=1 << 20, max_staleness=max_staleness)
    return jex, tex


_VERDICTS = ("cache_lookups", "cache_hits", "cache_uncached", "cache_bypass")


def _run(ex, q, opt, encode):
    """(answers as JSON, the request's cache verdict counters), in a query
    profile of the executor's own package."""
    scope = jax_profile_scope if isinstance(ex, JaxExecutor) else profile_scope
    with scope(index="i", query=q) as prof:
        out = [encode(r) for r in ex.execute("i", q, opt=opt)]
        counters = {k: prof.counters.get(k, 0) for k in _VERDICTS}
    return out, counters


def _totals(cache):
    d = cache.debug_dump()
    d.pop("entries")
    return d


def test_script_same_answers_verdicts_and_totals(pair):
    jh, th = pair
    jex, tex = _executors(jh, th)
    oracle = Executor(th, backend=CPUBackend(th))
    for step, queries, opts in SCRIPT:
        for q in queries:
            jgot, jv = _run(jex, q, JaxExecOptions(**opts), jax_json)
            tgot, tv = _run(tex, q, ExecOptions(**opts), result_to_json)
            assert tgot == jgot, (step, q)
            assert tv == jv, (step, q)
            if not q.startswith(("Set", "Clear")):
                assert tgot == [result_to_json(r) for r in oracle.execute("i", q)], (step, q)
        assert _totals(tex.rescache) == _totals(jex.rescache), step
    totals = _totals(tex.rescache)
    assert totals["hits"] > 0 and totals["misses"] > 0 and totals["bypass"] > 0
    assert totals["residentBytes"] == sum(e["bytes"] for e in
                                          tex.rescache.debug_dump()["entries"])


def test_warm_reads_are_hits_and_a_write_misses_only_its_answers(pair):
    jh, th = pair
    _, tex = _executors(jh, th)
    for q in READS:
        tex.execute("i", q)
    c = tex.rescache
    hits = c.hits
    for q in READS:
        tex.execute("i", q)
    # Every cacheable answer is a hit: READS hold 12 (Rows is uncacheable).
    assert c.hits - hits == 12
    misses = c.misses
    tex.execute("i", f"Set({SHARD_WIDTH + 3}, g=3)")
    assert tex.execute("i", "Count(Intersect(Row(f=1), Row(g=2)))")  # g moved: a miss
    assert c.misses == misses + 1
    hits = c.hits
    tex.execute("i", "Max(field=v)")  # v did not move: a hit
    assert c.hits == hits + 1


def test_max_staleness_serves_within_its_bound(pair):
    """With a bound past the writes in between, both caches serve the
    answer computed before a covered write as a stale hit (generations
    count a process-wide counter, so the bound is set wide); with 0 the
    same write is a miss."""
    jh, th = pair
    for bound, stale in ((0, False), (10_000, True)):
        jex, tex = _executors(jh, th, max_staleness=bound)
        q = "Count(Row(f=1))"
        steps = [q, f"Set({bound + 9}, f=1)", q]
        answers = []
        for s in steps:
            jgot, jv = _run(jex, s, JaxExecOptions(), jax_json)
            tgot, tv = _run(tex, s, ExecOptions(), result_to_json)
            assert tgot == jgot and tv == jv, (bound, s)
            answers.append(tgot)
        assert _totals(tex.rescache) == _totals(jex.rescache)
        assert tex.rescache.stale_hits == int(stale)
        fresh = [result_to_json(r) for r in Executor(th, backend=CPUBackend(th)).execute("i", q)]
        assert answers[2] == (answers[0] if stale else fresh)
        assert answers[0] != fresh


def test_result_nbytes_matches_jax_for_each_answer(pair):
    from pilosa_tpu.exec.rescache import result_nbytes as jax_nbytes

    jh, th = pair
    jex = JaxExecutor(jh)
    tex = Executor(th, backend=CUDABackend(th, device="cpu"))
    for q in READS:
        for a, b in zip(jex.execute("i", q), tex.execute("i", q)):
            assert result_nbytes(b) == jax_nbytes(a), q
