"""The port's BSI plane, time ranges, Shift and TopN on CUDABackend
(pilosa_tpu_torch/exec/cuda.py), run on the CPU with the kernels' plain
versions, against the JAX package.

- Every query of tests/test_tpu.py's BSI_QUERIES, its Shift and time-range
  queries, through the port's CUDABackend(device="cpu"), the JAX
  TPUBackend and the JAX oracle over one carried data directory, with
  cpu_routed_total flat.
- The BSI range helpers and _shift_slab against their JAX functions on the
  same random slabs (words with bit 31 set), every op, depths 1 to 16.
- The plain forms of K8 (row_popcounts_torch) and K9 (bsi_minmax_torch)
  against the JAX package's topn_plain, topn_src, bsi_sum, bsi_min and
  bsi_max programs on the same stacks.
- The plain K10 (bsi_compare on CPU tensors) against the JAX count
  program's C and CB nodes (_eval_spec), every op, sign and between class
  at depths 1 to 16 and 63; and K10's action table (compare_plan), walked
  as the CUDA kernel walks it, against the plain form.
- The TopN rank-vector cache.

All outputs are integers or bitmaps: every comparison is exact.
"""

import shutil

import numpy as np
import pytest
import torch

import tests.test_tpu as jax_tpu_tests
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec import tpu as jax_tpu
from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu_torch.carry import open_reference_holder, stack_from_reference
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec import cuda as port
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.ops import kernels as K
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


BSI_QUERIES = jax_tpu_tests.TestTPUBackendDifferential.BSI_QUERIES
# tests/test_tpu.py test_shift_on_device and test_time_range_on_device, and
# shifts across a word (32), past it (33, 40) and of a BSI row.
SHIFT_QUERIES = [
    "Shift(Row(f=1), n=1)", "Shift(Row(f=2), n=40)", "Count(Shift(Row(f=1), n=3))",
    "Count(Shift(Row(f=2), n=32))", "Shift(Row(f=3), n=33)", "Shift(Row(v > 0), n=31)",
    "Count(Shift(Shift(Row(g=7), n=5), n=0))",
]
TIME_QUERIES = [
    "Row(t=9, from='2019-08-01T00:00', to='2019-08-31T00:00')",
    "Count(Row(t=9, from='2019-08-04T00:00', to='2019-08-31T00:00'))",
    "Row(t=9, from='2019-08-03T10:00', to='2019-08-03T11:00')",
    "Row(t=9, from='2020-01-01T00:00', to='2020-02-01T00:00')",
    "Row(f=1, from='2019-08-01T00:00', to='2019-08-31T00:00')",
    "Count(Union(Row(t=9, from='2019-08-01T00:00', to='2019-08-04T00:00'), Row(g=7)))",
]
N_SHARDS = 3


def _build(path):
    """tests/test_tpu.py's differential holder (_setup and _setup_bsi, its
    numpy stream seeded), with its time field, written by the JAX package."""
    from pilosa_tpu.core.field import options_for_int, options_for_time

    rng = np.random.default_rng(11)
    h = JaxHolder(path).open()
    idx = h.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("v", options_for_int(-500, 500))
    idx.create_field("t", options_for_time("YMDH"))
    for row in (1, 2, 3):
        cols = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, 2000, dtype=np.uint64))
        idx.field("f").import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
        idx.existence_field().import_bits(np.zeros(cols.size, dtype=np.uint64), cols)
    cols = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, 1500, dtype=np.uint64))
    idx.field("g").import_bits(np.full(cols.size, 7, dtype=np.uint64), cols)
    cols = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, 800, dtype=np.uint64))
    idx.field("v").import_value(cols, rng.integers(-500, 501, cols.size))
    ex = JaxExecutor(h)
    ex.execute("i", "Set(5, v=42) Set(6, v=-10)")
    ex.execute("i", "Set(3, t=9, 2019-08-03T10:00)")
    ex.execute("i", "Set(1048579, t=9, 2019-08-05T12:00)")
    return h


@pytest.fixture(scope="module")
def execs(tmp_path_factory):
    """(JAX oracle, JAX TPUBackend, port CUDABackend(device="cpu"), port
    backend) over two copies of one JAX-written data directory."""
    src = str(tmp_path_factory.mktemp("jax_bsi"))
    _build(src).close()
    dst = str(tmp_path_factory.mktemp("carried_bsi")) + "/data"
    shutil.copytree(src, dst)
    jh = JaxHolder(src).open()
    th = open_reference_holder(dst)
    backend = CUDABackend(th, device="cpu")
    yield (JaxExecutor(jh), JaxExecutor(jh, backend=TPUBackend(jh)),
           Executor(th, backend=backend), backend)
    jh.close()
    th.close()


def _routed() -> float:
    return sum(global_stats.counter_totals("cpu_routed_total").values())


def _same(execs, q):
    jcpu, jdev, tdev, _ = execs
    want = [jax_json(r) for r in jcpu.execute("i", q)]
    assert [jax_json(r) for r in jdev.execute("i", q)] == want, q
    assert [result_to_json(r) for r in tdev.execute("i", q)] == want, q
    return want


@pytest.mark.parametrize("q", BSI_QUERIES + SHIFT_QUERIES + TIME_QUERIES)
def test_query_equals_jax_on_the_card(execs, q):
    routed = _routed()
    _same(execs, q)
    assert _routed() == routed, f"{q} left the card"


def test_time_range_views_are_unioned(execs):
    """The August range holds both of t=9's columns, from two day views."""
    got = _same(execs, TIME_QUERIES[0])
    assert got[0]["columns"] == [3, 1048579]


# ---------------------------------------------------------------------------
# the helpers against the JAX functions
# ---------------------------------------------------------------------------

S, W = 2, 8


def _slabs(seed, n):
    """n random uint32 [S, W] slabs at bit density 1/2 (bit 31 set in about
    half the words, and in the first word of the first slab's shards)."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 2**32, (S, W), dtype=np.uint32) for _ in range(n)]
    out[0][:, 0] |= np.uint32(1 << 31)
    return out


def _t(x):
    return stack_from_reference(np.ascontiguousarray(x), "cpu")


def _j(x):
    return np.asarray(x).astype(np.uint32)


@pytest.mark.parametrize("depth", range(1, 17))
def test_range_helpers_equal_jax(depth):
    rng = np.random.default_rng(depth)
    exists, sign, filt, *planes = _slabs(100 + depth, 3 + depth)
    t_planes = [_t(p) for p in planes]
    values = sorted({0, 1, (1 << depth) - 1, int(rng.integers(0, 1 << depth)),
                     int(rng.integers(0, 1 << depth))})
    for value in values:
        jb = jax_tpu._pred_bits(value, depth)
        tb = port._pred_bits(value, depth)
        assert list(jb) == list(tb)
        for allow_eq in (False, True):
            for name in ("_lt_unsigned", "_gt_unsigned"):
                want = _j(getattr(jax_tpu, name)(filt, planes, jb, depth, allow_eq))
                got = getattr(port, name)(_t(filt), t_planes, tb, depth, allow_eq)
                np.testing.assert_array_equal(got.numpy().view(np.uint32), want,
                                              err_msg=f"{name} {value} {allow_eq}")
        for neg in (False, True):
            want = _j(jax_tpu._eq_slab(exists, sign, planes, jb, depth, neg))
            got = port._eq_slab(_t(exists), _t(sign), t_planes, tb, depth, neg)
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        for hi in values:
            if hi < value:
                continue
            jh, th = jax_tpu._pred_bits(hi, depth), port._pred_bits(hi, depth)
            want = _j(jax_tpu._between_unsigned(filt, planes, jb, jh, depth))
            got = port._between_unsigned(_t(filt), t_planes, tb, th, depth)
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    bits = port._bsi_slabs(_t(np.stack([exists, sign] + planes, axis=1)), depth)
    assert torch.equal(bits[0], _t(exists)) and torch.equal(bits[1], _t(sign))
    assert all(torch.equal(a, b) for a, b in zip(bits[2], t_planes))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 40, 32 * W - 1, 32 * W])
def test_shift_slab_equals_jax(n):
    (slab,) = _slabs(7 + n, 1)
    slab[:, 1:3] = np.uint32(0xFFFFFFFF)  # carries out of every bit
    want = _j(jax_tpu._shift_slab(slab, n))
    got = port._shift_slab(_t(slab), n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# ---------------------------------------------------------------------------
# the plain K8 and K9 against the JAX programs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_backend():
    h = JaxHolder(None).open()
    yield TPUBackend(h)
    h.close()


def _stack(seed, s, r, w=64):
    rng = np.random.default_rng(seed)
    words = (rng.integers(0, 2**32, (s, r, w), dtype=np.uint32)
             & rng.integers(0, 2**32, (s, r, w), dtype=np.uint32))
    words[:, :, 0] |= np.uint32(1 << 31)
    return words


@pytest.mark.parametrize("s,r", [(1, 8), (3, 8), (2, 16), (4, 3)])
def test_row_popcounts_equals_topn_programs(jax_backend, s, r):
    f, g = _stack(s * 10 + r, s, r), _stack(s * 20 + r, s, 8)
    want = np.asarray(jax_backend._program("topn_plain", None, False)(f))
    got = K.row_popcounts(_t(f), 0, r)
    assert tuple(got.shape) == (1, s, r)
    np.testing.assert_array_equal(got[0].numpy(), want)
    summed = np.asarray(jax_backend._program("topn_plain", None, True)(f))
    np.testing.assert_array_equal(got[0].sum(dim=0).numpy(), summed)
    spec = ("R", "g")
    scalars = (np.uint32(5), np.uint32(1))
    want = np.asarray(jax_backend._program("topn_src", spec, False)(f, (g,), scalars))
    got = K.row_popcounts(_t(f), 0, r, (_t(g[:, 5, :]),))
    np.testing.assert_array_equal(got[0].numpy(), want)
    # A window of rows of the stack, read in place.
    got = K.row_popcounts(_t(f), 1, r - 1, (_t(g[:, 5, :]),))
    np.testing.assert_array_equal(got[0].numpy(), want[:, 1:])


def _bsi_stack(seed, s, depth, w=64):
    """A BSI stack [s, 2 + depth padded to 8, w]: exists, sign, planes; the
    last shard is empty, the second-to-last all negative, when s > 2."""
    rng = np.random.default_rng(seed)
    rows = -(-(2 + depth) // 8) * 8
    st = np.zeros((s, rows, w), dtype=np.uint32)
    exists = rng.integers(0, 2**32, (s, w), dtype=np.uint32)
    st[:, 0] = exists
    st[:, 1] = exists & rng.integers(0, 2**32, (s, w), dtype=np.uint32)
    for i in range(depth):
        st[:, 2 + i] = exists & rng.integers(0, 2**32, (s, w), dtype=np.uint32)
    if s > 2:
        st[-1] = 0
        st[-2, 1] = st[-2, 0]
    return st


@pytest.mark.parametrize("s,depth", [(1, 1), (3, 5), (4, 14), (3, 16), (2, 0)])
def test_sum_plane_counts_equal_bsi_sum(jax_backend, s, depth):
    st = _bsi_stack(s * 7 + depth, s, depth)
    pos_c, neg_c, cnt = (np.asarray(x) for x in
                         jax_backend._program("bsi_sum", None, True, extra=depth)(st, (), ()))
    t = _t(st)
    consider = t[:, 0, :]
    neg = (t[:, 1, :] & consider).contiguous()
    pos = (consider & ~neg).contiguous()
    got = K.row_popcounts(t, 2, depth, (pos, neg))
    assert tuple(got.shape) == (2, s, depth)
    np.testing.assert_array_equal(got[0].sum(dim=0).numpy(), pos_c)
    np.testing.assert_array_equal(got[1].sum(dim=0).numpy(), neg_c)
    assert int(K.popcount_rows(consider.contiguous()).sum()) == int(cnt)


@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("s,depth,filtered", [(1, 1, False), (3, 5, True), (4, 14, False),
                                              (4, 14, True), (3, 16, True), (2, 0, False)])
def test_bsi_minmax_equals_jax_program(jax_backend, kind, s, depth, filtered):
    st = _bsi_stack(s * 13 + depth, s, depth)
    g = _stack(s + depth, s, 8)
    if filtered:
        g[0, 3] = 0  # a filter that empties shard 0
        spec, blocks, scalars = ("R", "g"), (g,), (np.uint32(3), np.uint32(1))
    else:
        spec, blocks, scalars = None, (), ()
    want = [np.asarray(x) for x in
            jax_backend._program(f"bsi_{kind}", spec, True, extra=depth)(st, blocks, scalars)]
    filt = _t(g[:, 3, :]) if filtered else None
    table = K.bsi_minmax(_t(st), depth, filt, kind)
    assert tuple(table.shape) == (2, s, depth + 2)
    got = K.split_minmax(table, depth)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), b.astype(a.numpy().dtype), err_msg=str(i))


# ---------------------------------------------------------------------------
# the plain K10 against the JAX program's C and CB nodes
# ---------------------------------------------------------------------------

COMPARE_DEPTHS = list(range(1, 17)) + [63]


def _compare_cases(depth, seed):
    """(op, neg, allow_eq, bits, hi_bits) of every comparison with both
    predicate signs, and of the between classes, at predicates 0, 1, all
    ones, bit depth - 1 alone and random ones (as host ints)."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    values = sorted({0, 1, top, 1 << (depth - 1)}
                    | {int(rng.integers(0, top + 1)) for _ in range(3)})
    bits = {v: tuple(int(b) for b in jax_tpu._pred_bits(v, depth)) for v in values}
    cases = []
    for v in values:
        for op in ("==", "!=", "<", ">"):
            for neg in (False, True):
                for allow_eq in ((False, True) if op in "<>" else (False,)):
                    cases.append((op, neg, allow_eq, bits[v], None))
    for lo in values:
        for hi in values:
            if lo <= hi:
                cases.append(("pos", False, False, bits[lo], bits[hi]))
                cases.append(("neg", False, False, bits[hi], bits[lo]))
            cases.append(("mixed", False, False, bits[lo], bits[hi]))
    return cases


def _jax_node(st, depth, op, neg, allow_eq, bits, hi_bits):
    """The JAX program's C or CB node on stack st, evaluated on the CPU."""
    u32 = lambda b: np.asarray(b, dtype=np.uint32)  # noqa: E731
    if hi_bits is None:
        spec, scalars = ("C", "v", op, neg, allow_eq, depth), [u32(bits)]
    else:
        spec, scalars = ("CB", "v", op, depth), [u32(bits), u32(hi_bits)]
    return _j(jax_tpu._eval_spec(spec, iter([st]), iter(scalars)))


@pytest.mark.parametrize("depth", COMPARE_DEPTHS)
@pytest.mark.parametrize("kind", ["compare", "between"])
def test_bsi_compare_equals_jax_eval_spec(depth, kind):
    """K10 through its wrapper on CPU tensors (the plain form) equals the
    JAX count program's C and CB nodes, every op, sign and class."""
    st = _bsi_stack(depth * 31 + 7, 3, depth, w=8)
    t = _t(st)
    for op, neg, allow_eq, bits, hi_bits in _compare_cases(depth, depth):
        if (hi_bits is None) != (kind == "compare"):
            continue
        got = K.bsi_compare(t, depth, op, bits, neg=neg, allow_eq=allow_eq, hi_bits=hi_bits)
        assert got.dtype == torch.int32 and tuple(got.shape) == (3, 8)
        want = _jax_node(st, depth, op, neg, allow_eq, bits, hi_bits)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want,
                                      err_msg=f"{op} neg={neg} eq={allow_eq}")


def _run_plan(stack, depth, plan):
    """The CUDA K10's walk in torch ops (bitcount.cu bsi_compare_kernel):
    the host's action table (K.compare_plan) run one plane at a time."""
    mode, start_a, start_b, extra, neq, ops = plan
    exists, sign, planes = K._bsi_slabs(stack, depth)
    slabs = [torch.zeros_like(exists), exists & ~sign, exists & sign, exists]
    w = {"fa": slabs[start_a], "ka": slabs[0], "fb": slabs[start_b], "kb": slabs[0]}

    def step(op, f, k, p):
        fv, kv = w[f], w[k]
        if op == K.OP_F_ANDNOT_P:
            w[f] = fv & ~p
        elif op == K.OP_F_AND_P:
            w[f] = fv & p
        elif op == K.OP_K_OR_F_P:
            w[k] = kv | (fv & p)
        elif op == K.OP_K_OR_F_NP:
            w[k] = kv | (fv & ~p)
        elif op == K.OP_F_AND_P_K:
            w[f] = fv & (p | kv)
        elif op == K.OP_F_AND_NP_K:
            w[f] = fv & (~p | kv)
        elif op == K.OP_F_TAKE_K:
            w[f] = kv

    for p in range(depth - 1, -1, -1):
        step(ops[p] & 7, "fa", "ka", planes[p])
        if mode == K.MODE_BETWEEN:
            step(ops[p] >> 3, "fa", "kb", planes[p])
        elif mode == K.MODE_TWO:
            step(ops[p] >> 3, "fb", "kb", planes[p])
    if neq:
        return slabs[extra] & ~w["fa"]
    return w["fa"] | w["fb"] | slabs[extra]


@pytest.mark.parametrize("depth", [0] + COMPARE_DEPTHS)
def test_compare_plan_walk_equals_plain(depth):
    """The action table the CUDA K10 runs (compare_plan), walked in torch
    ops as the kernel walks it, equals the plain form: every op, sign and
    class, the strict-<0 fix and the early returns of the last plane."""
    t = _t(_bsi_stack(depth * 17 + 3, 3, depth, w=8))
    cases = _compare_cases(depth, depth + 100) if depth else [
        (op, neg, eq, (), hi) for op in ("==", "!=", "<", ">", "pos", "neg", "mixed")
        for neg in (False, True) for eq in (False, True)
        for hi in ([()] if op in K.BETWEEN_CLASSES else [None])]
    for op, neg, allow_eq, bits, hi_bits in cases:
        plan = K.compare_plan(depth, op, bits, neg, allow_eq, hi_bits)
        assert len(plan[5]) == depth and all(0 <= o < 64 for o in plan[5])
        want = K.bsi_compare_torch(t, depth, op, bits, neg, allow_eq, hi_bits)
        assert torch.equal(_run_plan(t, depth, plan), want), (op, neg, allow_eq, bits, hi_bits)


def test_port_reexports_the_range_helpers():
    for name in ("_lt_unsigned", "_gt_unsigned", "_between_unsigned", "_eq_slab", "_bsi_slabs"):
        assert getattr(port, name) is getattr(K, name)


# ---------------------------------------------------------------------------
# the TopN rank-vector cache
# ---------------------------------------------------------------------------


def _launches(kind):
    return global_stats.counter_totals("device_launches_total").get(
        f'device_launches_total{{kind="{kind}"}}', 0)


def test_topn_cache_serves_repeats_and_groupby(execs):
    jcpu, _, tdev, backend = execs
    backend._topn_cache.clear()
    first = _same(execs, "TopN(f, n=2)")
    launches, grouped = _launches("topn"), _launches("groupby")
    hits = sum(global_stats.counter_totals("topn_cache_hits_total").values())
    assert _same(execs, "TopN(f, n=2)") == first
    assert _same(execs, "Rows(f)")
    _same(execs, "GroupBy(Rows(f))")
    assert _launches("topn") == launches, "a repeat launched"
    assert _launches("groupby") == grouped, "GroupBy(Rows(f)) swept its field"
    assert sum(global_stats.counter_totals("topn_cache_hits_total").values()) == hits + 3
    # A write moves the view's generation: the next TopN absorbs the epoch
    # into its per-shard table on the host, without a launch.
    absorbed = sum(global_stats.counter_totals("topn_incremental_updates_total").values())
    for ex in (jcpu, tdev):
        ex.execute("i", f"Set({2 * SHARD_WIDTH + 17}, f=2)")
    _same(execs, "TopN(f)")
    assert _launches("topn") == launches
    assert sum(global_stats.counter_totals("topn_incremental_updates_total").values()) \
        == absorbed + 1
