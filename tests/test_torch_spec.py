"""K11's host side and plain form (pilosa_tpu_torch/ops/kernels.py
spec_program, spec_eval) and the batched entry points of the port's
CUDABackend, run on the CPU, against the JAX package.

- spec_program compiles every spec tag of the backend's _build, walks the
  call's blocks and scalars in _build's order, and splits a tree past
  MAX_SPEC_LEAVES or MAX_SPEC_DEPTH into sub-programs that each fit.
- The backend's K11 run (_spec_run: spec_program, the slab leaves, and
  spec_eval's plain form) equals the JAX package's "count", "vec",
  "count_batch" and "vec_batch" programs (pilosa_tpu/exec/tpu.py:2070 to
  :2116, through TPUBackend._program on JAX's CPU) on the same
  numpy-seeded stacks, for Q = 1, 3 and 8 slots with duplicate slots; the
  JAX side pads to its slot bucket, and its padded lanes
  (masked_lane_counts, mask_lane_slab) are exactly 0.
- K11's window table (spec_window: the distinct leaf rows a launch stages
  once, and each slot's index into them) gives back every slot's rows,
  over random windows (hypothesis: 1 to 300 slots, duplicate slots, zero
  leaves, fixed rows, stacks, slabs and one stack named by two leaves);
  spec_split cuts a window into runs of whole slots, in order, each within
  its entry and slot caps; the launch arguments (spec_launch_args) address
  each entry's row in every shard as the kernel reads them; and the
  program run over the table's gathered entries, launch by launch, equals
  spec_eval_torch and the JAX "count_batch" and "vec_batch" programs at
  Q = 1, 3, 8 and 64. Each limit, body and op the wrapper hands the
  kernel has the value spec.cu gives it.
- CUDABackend(device="cpu").count_batch_async and row_batch_async equal
  the JAX TPUBackend's over tests/test_tpu.py's query lists, BSI
  conditions and Shift included, on one JAX-written data directory.

Every output is an integer or a bitmap: every comparison is exact.
"""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import tests.test_tpu as jax_tpu_tests
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.exec import tpu as jax_tpu
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu.ops.kernels import mask_lane_slab, masked_lane_counts
from pilosa_tpu.pql import parse_string as jax_parse
from pilosa_tpu_torch.carry import open_reference_holder, stack_from_reference
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.exec import cuda as port
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.ops.blocks import WORDS_PER_SHARD
from pilosa_tpu_torch.pql import parse_string
from tests.test_torch_bsi import N_SHARDS, SHIFT_QUERIES, _bsi_stack, _build


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, R, W = 3, 8, 128
DEPTH = 10


def _stacks(seed):
    """Random uint32 stacks: f, g, the existence stack, three time views,
    and a BSI stack of depth DEPTH (bit 31 set in many words)."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, 2**32, (S, R, W), dtype=np.uint32)
           for k in ("f", "g", "e", "t0", "t1", "t2")}
    out["v"] = _bsi_stack(seed + 1, S, DEPTH, w=W)
    return out


def _row(rng):
    """A row leaf's (row, mask): a row past the stack is row R - 1, mask 0."""
    return (int(rng.integers(0, R)), 1) if rng.random() < 0.8 else (R - 1, 0)


def _bits(rng):
    return tuple(int(b) for b in jax_tpu._pred_bits(int(rng.integers(0, 1 << DEPTH)), DEPTH))


def _deep(n):
    """A right-nested tree n levels deep: I(R, U(R, I(R, ...)))."""
    node = ("R", "f")
    for k in range(n):
        node = ("I" if k % 2 else "U", (("R", "g"), node))
    return node


# (name, spec, the blocks' stack names in _build order, one slot's scalars)
CASES = [
    ("intersect", ("I", (("R", "f"), ("R", "g"))), ["f", "g"],
     lambda r: _row(r) + _row(r)),
    ("not-union", ("N", ("U", (("R", "f"), ("R", "g")))), ["e", "f", "g"],
     lambda r: _row(r) + _row(r)),
    ("all", ("A",), ["e"], lambda r: ()),
    ("time-range", ("T", "t", 3), ["t0", "t1", "t2"],
     lambda r: _row(r) + _row(r) + _row(r)),
    ("empty-difference", ("D", (("R", "f"), ("E",))), ["f", "g"], lambda r: _row(r)),
    ("exists-xor", ("X", (("NN", "v"), ("R", "f"))), ["v", "f"], lambda r: _row(r)),
    ("condition", ("I", (("C", "v", ">", False, True, DEPTH), ("R", "f"))), ["v", "f"],
     lambda r: (_bits(r),) + _row(r)),
    ("negative-condition", ("U", (("C", "v", "<", True, False, DEPTH), ("R", "g"))),
     ["v", "g"], lambda r: (_bits(r),) + _row(r)),
    ("between", ("D", (("CB", "v", "mixed", DEPTH), ("R", "g"))), ["v", "g"],
     lambda r: (_bits(r), _bits(r)) + _row(r)),
    ("shift", ("S", 33, ("I", (("R", "f"), ("R", "g")))), ["f", "g"],
     lambda r: _row(r) + _row(r)),
    ("wide-union", ("U", tuple(("R", "fg"[k % 2]) for k in range(20))),
     ["f", "g"] * 10, lambda r: sum((_row(r) for _ in range(20)), ())),
    ("deep", _deep(10), ["g"] * 10 + ["f"], lambda r: sum((_row(r) for _ in range(11)), ())),
]


def _walk(prog):
    """Every program and sub-program of prog."""
    yield prog
    for leaf in prog.leaves:
        if leaf[0] == "shift":
            yield from _walk(leaf[2])
        elif leaf[0] == "sub":
            yield from _walk(leaf[1])


@pytest.mark.parametrize("name,spec,names,gen", CASES, ids=[c[0] for c in CASES])
def test_spec_program_fits_and_walks_build_order(name, spec, names, gen):
    prog, b, s = K._spec_compile(spec, 0, 0)
    assert b == len(names)
    assert s == len(gen(np.random.default_rng(0)))
    for p in _walk(prog):
        assert len(p.leaves) <= K.MAX_SPEC_LEAVES and p.depth <= K.MAX_SPEC_DEPTH
        pushes = [op for op in p.ops if op < K.MAX_SPEC_LEAVES]
        assert pushes == list(range(len(p.leaves)))
    assert K.spec_program(spec) == prog
    split = any(leaf[0] == "sub" for p in _walk(prog) for leaf in p.leaves)
    assert split == (name in ("wide-union", "deep"))
    assert prog.per_slot == (name in ("condition", "negative-condition", "between", "shift",
                                      "wide-union", "deep"))


def test_spec_program_leaf_tags():
    """Each tag's leaf descriptor and postfix ops."""
    bits = K.BSI_EXISTS_ROW
    assert K.spec_program(("R", "f")) == K.SpecProgram((0,), (("row", 0, 0),), 1)
    assert K.spec_program(("A",)) == K.SpecProgram((0,), (("fixed", 0, 0),), 1)
    assert K.spec_program(("NN", "v")) == K.SpecProgram((0,), (("fixed", 0, bits),), 1)
    assert K.spec_program(("E",)) == K.SpecProgram((0,), (("zero", 0),), 1)
    assert K.spec_program(("N", ("R", "f"))) == K.SpecProgram(
        (0, 1, K.SPEC_ANDNOT), (("fixed", 0, 0), ("row", 1, 0)), 2)
    assert K.spec_program(("T", "t", 2)) == K.SpecProgram(
        (0, 1, K.SPEC_OR), (("row", 0, 0), ("row", 1, 2)), 2)
    c = ("C", "v", "==", False, False, 4)
    assert K.spec_program(c).leaves == (("cmp", 0, 0, c),)
    cb = ("CB", "v", "pos", 4)
    assert K._spec_compile(("U", (cb, ("R", "f"))), 0, 0)[1:] == (2, 4)
    for tag, op in (("U", K.SPEC_OR), ("I", K.SPEC_AND), ("D", K.SPEC_ANDNOT),
                    ("X", K.SPEC_XOR)):
        prog = K.spec_program((tag, (("R", "f"), ("R", "g"), ("R", "h"))))
        assert prog.ops == (0, 1, op, 2, op) and prog.depth == 2
    shift = K.spec_program(("S", 5, ("R", "f")))
    assert shift.leaves == (("shift", 5, K.spec_program(("R", "f"))),)


def _slots(gen, q, seed):
    """q slots' scalars, with duplicates when q > 1."""
    rng = np.random.default_rng(seed)
    pool = [gen(rng) for _ in range(max(1, q // 2 + 1))]
    return [pool[0]] + [pool[int(rng.integers(0, len(pool)))] for _ in range(q - 1)]


def _jax_scalars(slot):
    return tuple(np.asarray(x, dtype=np.uint32) for x in slot)


@pytest.fixture(scope="module")
def backends():
    jh = JaxHolder(None).open()
    th = Holder(None).open()
    yield TPUBackend(jh), CUDABackend(th, device="cpu")
    jh.close()
    th.close()


@pytest.mark.parametrize("q", [1, 3, 8])
@pytest.mark.parametrize("name,spec,names,gen", CASES, ids=[c[0] for c in CASES])
def test_spec_run_equals_jax_programs(backends, name, spec, names, gen, q):
    jb, tb = backends
    stacks = _stacks(len(name))
    jblocks = tuple(jnp.asarray(stacks[n]) for n in names)
    tblocks = tuple(stack_from_reference(stacks[n], "cpu") for n in names)
    slots = _slots(gen, q, q)
    prog = K.spec_program(spec)
    counts = tb._spec_run(prog, tblocks, slots, "count", "count_batch")
    slabs = tb._spec_run(prog, tblocks, slots, "slab", "vec_batch")
    assert counts.dtype == torch.int32 and tuple(counts.shape) == (q, S)
    assert slabs.dtype == torch.int32 and tuple(slabs.shape) == (q, S, W)
    got_c = counts.numpy()
    got_v = slabs.numpy().view(np.uint32)
    for k, slot in enumerate(slots):
        want_c = np.asarray(jb._program("count", spec, False)(jblocks, _jax_scalars(slot)))
        want_v = np.asarray(jb._program("vec", spec, False)(jblocks, _jax_scalars(slot)))
        np.testing.assert_array_equal(got_c[k], want_c.astype(np.int64))
        np.testing.assert_array_equal(got_v[k], want_v)
        one = jnp.asarray(want_v)
        np.testing.assert_array_equal(np.asarray(masked_lane_counts(one, jnp.uint32(1))), want_c)
        assert not np.asarray(masked_lane_counts(one, jnp.uint32(0))).any()
        assert not np.asarray(mask_lane_slab(one, jnp.uint32(0))).any()
    if not slots[0]:
        return  # no per-slot scalars: the JAX package runs "count" once
    qb = jax_tpu._slot_bucket(q)
    scal = jb._padded_slot_scalars([_jax_scalars(s) for s in slots], qb)
    want_cb = np.asarray(jb._program("count_batch", spec, False)(jblocks, scal))
    want_vb = np.asarray(jb._program("vec_batch", spec, False)(jblocks, scal))
    assert want_cb.shape == (qb, S) and want_vb.shape == (qb, S, W)
    np.testing.assert_array_equal(got_c, want_cb[:q].astype(np.int64))
    np.testing.assert_array_equal(got_v, want_vb[:q])
    assert not want_cb[q:].any() and not want_vb[q:].any()  # JAX's padded lanes


def test_spec_run_equals_eval_spec_reference(backends):
    """The K11 run equals the backend's node-by-node torch walk
    (exec/cuda.py _eval_spec) on every case's first slot."""
    _, tb = backends
    for name, spec, names, gen in CASES:
        stacks = _stacks(len(name) + 100)
        tblocks = tuple(stack_from_reference(stacks[n], "cpu") for n in names)
        slot = gen(np.random.default_rng(7))
        want = port._eval_spec(spec, iter(tblocks), iter(slot))
        got = tb._spec_run(K.spec_program(spec), tblocks, [slot], "slab", "vec")[0]
        assert torch.equal(got, want), name


def test_spec_eval_checks_its_program():
    x = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="out of order"):
        K.spec_eval((1, 0, K.SPEC_AND), (x, x), [[0, 0]])
    with pytest.raises(ValueError, match="on a stack of 1"):
        K.spec_eval((0, K.SPEC_OR), (x,), [[0]])
    with pytest.raises(ValueError, match="leaves 2 values"):
        K.spec_eval((0, 1), (x, x), [[0, 0]])
    with pytest.raises(ValueError, match="outside a leaf"):
        K.spec_eval((0,), (x,), [[4]])
    with pytest.raises(ValueError, match="1 to 16"):
        K.spec_eval((), (), [])
    deep = tuple(range(K.MAX_SPEC_DEPTH + 1)) + (K.SPEC_AND,) * K.MAX_SPEC_DEPTH
    with pytest.raises(ValueError, match="stack past"):
        K.spec_eval(deep, (x,) * (K.MAX_SPEC_DEPTH + 1), [[0] * (K.MAX_SPEC_DEPTH + 1)])
    with pytest.raises(ValueError, match="mode"):
        K.spec_eval((0,), (x,), [[0]], mode="vec")


def test_spec_eval_torch_zero_leaf_and_slab_leaf():
    """Row -1 is the zero leaf; a 2-D leaf is a slab read as it is."""
    rng = np.random.default_rng(3)
    st = stack_from_reference(rng.integers(0, 2**32, (2, 4, 8), dtype=np.uint32), "cpu")
    slab = stack_from_reference(rng.integers(0, 2**32, (2, 8), dtype=np.uint32), "cpu")
    out = K.spec_eval((0, 1, K.SPEC_OR), (st, slab), [[-1, 0], [2, -1]], mode="slab")
    assert torch.equal(out[0], slab) and torch.equal(out[1], st[:, 2, :])
    counts = K.spec_eval((0, 1, K.SPEC_XOR), (st, slab), [[1, 0]])
    want = K.popcount32(st[:, 1, :] ^ slab).sum(dim=-1)
    assert counts.tolist() == [want.tolist()]


# ---------------------------------------------------------------------------
# K11's window table and its split
# ---------------------------------------------------------------------------


@st.composite
def _windows(draw):
    """(leaves, rows, max_entries, max_slots): 1 to 6 leaves (stacks of 1
    to 8 rows and [S, W] slabs, one stack possibly named by two leaves), 1
    to 300 slots drawn from a pool (duplicates), rows -1 (the zero leaf),
    fixed rows (one row in every slot) or any, and caps no smaller than a
    slot's leaves."""
    n = draw(st.integers(1, 6))
    leaves = []
    for _ in range(n):
        if leaves and draw(st.integers(0, 4)) == 0:
            leaves.append(leaves[draw(st.integers(0, len(leaves) - 1))])
        elif draw(st.booleans()):
            leaves.append(torch.zeros((2, draw(st.integers(1, 8)), 4), dtype=torch.int32))
        else:
            leaves.append(torch.zeros((2, 4), dtype=torch.int32))
    heights = [t.shape[1] if t.dim() == 3 else 1 for t in leaves]
    fixed = [draw(st.integers(-1, h - 1)) if draw(st.integers(0, 3)) == 0 else None
             for h in heights]
    slot = st.tuples(*[st.just(f) if f is not None else st.integers(-1, h - 1)
                       for f, h in zip(fixed, heights)])
    pool = draw(st.lists(slot, min_size=1, max_size=40))
    q = draw(st.integers(1, 300))
    rows = [list(pool[draw(st.integers(0, len(pool) - 1))]) for _ in range(q)]
    return leaves, rows, draw(st.integers(n, 3 * n + 4)), draw(st.integers(1, 64))


@settings(max_examples=150, deadline=None)
@given(_windows())
def test_spec_window_gives_back_every_slot_and_split_covers_the_window(window):
    leaves, rows, max_entries, max_slots = window
    entries, index = K.spec_window(leaves, rows)
    keys = [(id(leaves[i]), r) for i, r in entries]
    assert len(set(keys)) == len(keys) and all(r >= 0 for _, r in entries)
    assert len(index) == len(rows)
    for slot, idx in zip(rows, index):
        assert len(idx) == len(slot)
        for i, (r, e) in enumerate(zip(slot, idx)):
            if r < 0:
                assert e == -1
            else:
                j, er = entries[e]
                assert leaves[j] is leaves[i] and er == r
    named = {(id(leaves[i]), r) for slot in rows for i, r in enumerate(slot) if r >= 0}
    assert set(keys) == named
    spans = K.spec_split(leaves, rows, max_entries, max_slots)
    assert spans[0][0] == 0 and spans[-1][1] == len(rows)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for q0, q1 in spans:
        assert 0 < q1 - q0 <= max_slots
        assert len(K.spec_window(leaves, rows[q0:q1])[0]) <= max_entries
    for (q0, q1), _ in zip(spans, spans[1:]):  # each launch takes every slot it can
        assert (q1 - q0 == max_slots
                or len(K.spec_window(leaves, rows[q0:q1 + 1])[0]) > max_entries)


def test_spec_split_caps_entries_and_slots():
    """At the launch's caps: 8 + 8 + 16 distinct rows of three stacks cut
    into runs of at most MAX_SPEC_ENTRIES entries; 600 slots of one row
    into runs of MAX_SPEC_SLOTS; a window within both is one launch."""
    f, g = torch.zeros((1, 8, 4), dtype=torch.int32), torch.zeros((1, 8, 4), dtype=torch.int32)
    wide = torch.zeros((1, 16, 4), dtype=torch.int32)
    rows = [[k % 8, (k // 8) % 8, k % 16] for k in range(64)]
    spans = K.spec_split((f, g, wide), rows)
    assert len(spans) > 1
    assert [len(K.spec_window((f, g, wide), rows[a:b])[0]) <= K.MAX_SPEC_ENTRIES
            for a, b in spans] == [True] * len(spans)
    assert K.spec_split((f,), [[k % 8] for k in range(600)]) == [
        (0, K.MAX_SPEC_SLOTS), (K.MAX_SPEC_SLOTS, 600)]
    combos = [[a, b, c] for a in range(8) for b in range(8) for c in range(4)]
    h = torch.zeros((1, 4, 4), dtype=torch.int32)
    for step in (4, 32):  # the 64- and 8-slot windows of 3-row Counts
        window = combos[::step]
        assert K.spec_split((f, g, h), window) == [(0, len(window))]
        assert len(K.spec_window((f, g, h), window)[0]) == (17 if step == 4 else 10)
    assert K.spec_split((f, g, h), [[1, 2, 0]] * 64) == [(0, 64)]
    assert len(K.spec_window((f, g, h), [[1, 2, 0]] * 64)[0]) == 3


@pytest.mark.parametrize("spec,fold", [
    (("R", "f"), True), (("I", (("R", "f"), ("R", "g"))), True),
    (("D", (("R", "f"), ("R", "g"), ("R", "h"))), True), (("T", "t", 3), True),
    (("N", ("R", "f")), True), (("N", ("I", (("R", "f"), ("R", "g")))), False),
    (("I", (("R", "f"), ("T", "t", 2))), False),
    (("D", (("U", (("R", "f"), ("R", "g"))), ("R", "h"))), False),
])
def test_spec_body_takes_the_window_body_but_for_one_slot(spec, fold):
    """A fold (one op, left to right) is what spec.cu's window_shape runs
    as a fold kernel; one slot of any other program, or of a lone leaf
    counted, takes the per-slot body; every other launch the window body."""
    ops = K.spec_program(spec).ops
    assert K.spec_is_fold(ops) == fold
    lone = len(ops) == 1
    for mode in ("count", "slab"):
        want_one = (K.SPEC_BODY_SLOT if not fold or (lone and mode == "count")
                    else K.SPEC_BODY_WINDOW)
        assert K.spec_body(ops, 1, mode) == want_one
        assert K.spec_body(ops, 2, mode) == K.SPEC_BODY_WINDOW


@pytest.mark.parametrize("source,name", [
    ("kMaxLeaves", "MAX_SPEC_LEAVES"), ("kMaxDepth", "MAX_SPEC_DEPTH"),
    ("kMaxInlineRows", "SPEC_INLINE_ROWS"), ("kMaxEntries", "MAX_SPEC_ENTRIES"),
    ("kMaxWindowSlots", "MAX_SPEC_SLOTS"), ("kBodySlot", "SPEC_BODY_SLOT"),
    ("kBodyWindow", "SPEC_BODY_WINDOW"), ("kBodyWalk", "SPEC_BODY_WALK"),
    ("kBodyFoldN", "SPEC_BODY_FOLD_N"), ("kOpAnd", "SPEC_AND"), ("kOpOr", "SPEC_OR"),
    ("kOpAndNot", "SPEC_ANDNOT"), ("kOpXor", "SPEC_XOR"),
])
def test_spec_limits_and_bodies_match_the_kernel_source(source, name):
    """Each limit, body and op the wrapper hands K11 has the value spec.cu
    gives it."""
    import os
    import re

    path = os.path.join(os.path.dirname(K.__file__), "csrc", "spec.cu")
    with open(path) as fh:
        text = fh.read()
    found = re.findall(rf"\b{source} = (0x[0-9a-fA-F]+|\d+)\b", text)
    assert len(found) == 1, found
    assert int(found[0], 0) == getattr(K, name)


def _kernel_view(ops, leaves, rows, mode):
    """spec_eval as the card computes it, in torch ops: per run of
    spec_split, the ctypes arguments of spec_launch_args read back from
    raw memory (each entry's row in each shard at base + s * stride, each
    slot's entries), the entries gathered once, and every slot's program
    run over them."""
    s, w = leaves[0].shape[0], leaves[0].shape[-1]
    w4 = w // 4
    outs = []
    for q0, q1 in K.spec_split(leaves, rows):
        out = torch.empty((q1 - q0, s) if mode == "count" else (q1 - q0, s, w),
                          dtype=torch.int32)
        args, keep = K.spec_launch_args(ops, leaves, rows[q0:q1], out, mode, K.SPEC_BODY_WINDOW)
        bases_p, strides_p, ne, ops_p, n_ops, n_leaves, slots_p = args[:7]
        assert args[7] is None or len(rows[q0:q1]) * n_leaves > K.SPEC_INLINE_ROWS
        assert args[10:] == (0 if mode == "count" else 1, K.SPEC_BODY_WINDOW, q1 - q0, s, w)
        assert list((ctypes.c_uint8 * n_ops).from_address(ops_p)) == list(ops)
        bases = (ctypes.c_void_p * max(ne, 1)).from_address(bases_p)
        strides = (ctypes.c_longlong * max(ne, 1)).from_address(strides_p)
        slots = list((ctypes.c_int * ((q1 - q0) * n_leaves)).from_address(slots_p))
        entries = torch.stack([
            torch.stack([torch.frombuffer(bytearray(ctypes.string_at(
                bases[e] + sh * strides[e] * 16, w4 * 16)), dtype=torch.int32)
                for sh in range(s)]) for e in range(ne)]) if ne else None
        del keep
        for q in range(q1 - q0):
            stack = []
            for op in ops:
                if op < K.MAX_SPEC_LEAVES:
                    e = slots[q * n_leaves + op]
                    stack.append(torch.zeros((s, w), dtype=torch.int32) if e < 0 else entries[e])
                    continue
                b, a = stack.pop(), stack.pop()
                stack.append({K.SPEC_AND: a & b, K.SPEC_OR: a | b, K.SPEC_ANDNOT: a & ~b,
                              K.SPEC_XOR: a ^ b}[op])
            res = stack.pop()
            outs.append(K.popcount32(res).sum(dim=-1).to(torch.int32) if mode == "count"
                        else res)
    return torch.stack(outs)


_BATCHED = [c for c in CASES if not K.spec_program(c[1]).per_slot]


@pytest.mark.parametrize("q", [1, 3, 8, 64])
@pytest.mark.parametrize("name,spec,names,gen", _BATCHED, ids=[c[0] for c in _BATCHED])
def test_window_table_run_equals_plain_and_jax_batch_programs(backends, name, spec, names,
                                                              gen, q):
    """The program run over each launch's window table (the entries
    gathered once from the addresses the kernel is given) equals
    spec_eval_torch and the JAX count_batch / vec_batch programs."""
    jb, tb = backends
    stacks = _stacks(len(name) + 7)
    tblocks = tuple(stack_from_reference(stacks[n], "cpu") for n in names)
    slots = _slots(gen, q, q + 1)
    prog = K.spec_program(spec)
    leaves = [tb._spec_leaf(leaf, tblocks, slots[0]) for leaf in prog.leaves]
    rows = [K.spec_leaf_rows(prog, sc) for sc in slots]
    got_c = _kernel_view(prog.ops, leaves, rows, "count")
    got_v = _kernel_view(prog.ops, leaves, rows, "slab")
    assert torch.equal(got_c, K.spec_eval_torch(prog.ops, leaves, rows, "count"))
    assert torch.equal(got_v, K.spec_eval_torch(prog.ops, leaves, rows, "slab"))
    jblocks = tuple(jnp.asarray(stacks[n]) for n in names)
    if not slots[0]:  # no per-slot scalars: the JAX package runs "count" once
        want_c = np.asarray(jb._program("count", spec, False)(jblocks, ()))
        np.testing.assert_array_equal(got_c.numpy(), np.tile(want_c, (q, 1)))
        return
    qb = jax_tpu._slot_bucket(q)
    scal = jb._padded_slot_scalars([_jax_scalars(sc) for sc in slots], qb)
    want_cb = np.asarray(jb._program("count_batch", spec, False)(jblocks, scal))
    want_vb = np.asarray(jb._program("vec_batch", spec, False)(jblocks, scal))
    np.testing.assert_array_equal(got_c.numpy(), want_cb[:q].astype(np.int64))
    np.testing.assert_array_equal(got_v.numpy().view(np.uint32), want_vb[:q])


def test_window_table_run_past_the_caps_equals_plain():
    """A window past MAX_SPEC_ENTRIES and MAX_SPEC_SLOTS, launch by launch
    through the table, equals spec_eval_torch: 520 slots over 8 + 8 + 16
    rows, the zero leaf among them."""
    rng = np.random.default_rng(5)
    f, g, wide = (stack_from_reference(rng.integers(0, 2**32, (2, r, 8), dtype=np.uint32),
                                       "cpu") for r in (8, 8, 16))
    rows = [[k % 8, -1 if k % 7 == 0 else (k // 8) % 8, k % 16] for k in range(520)]
    ops = K.spec_program(("D", (("R", "f"), ("R", "g"), ("R", "w")))).ops
    assert len(K.spec_split((f, g, wide), rows)) > 2
    for mode in ("count", "slab"):
        assert torch.equal(_kernel_view(ops, (f, g, wide), rows, mode),
                           K.spec_eval_torch(ops, (f, g, wide), rows, mode))


# ---------------------------------------------------------------------------
# the backend's batched entry points against the JAX TPUBackend
# ---------------------------------------------------------------------------

_BITMAP = ("Row", "Union", "Intersect", "Difference", "Xor", "Not", "All", "Shift")


def _bitmap_calls(queries):
    """The bitmap calls of a query list: a Count's child, or the call."""
    out = []
    for q in queries:
        name = q[: q.index("(")]
        if name == "Count":
            out.append(q[len("Count("):-1])
        elif name in _BITMAP:
            out.append(q)
    return out


BATCH_CALLS = _bitmap_calls(
    jax_tpu_tests.TestTPUBackendDifferential.QUERIES
    + jax_tpu_tests.TestTPUBackendDifferential.BSI_QUERIES
    + SHIFT_QUERIES
) + ["Row(f=1)", "Row(f=99)", "Union(Row(f=1), Row(f=2), Row(f=3), Row(g=7))"]


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(JAX TPUBackend, port CUDABackend(device="cpu")) over two copies of
    one JAX-written data directory."""
    src = str(tmp_path_factory.mktemp("jax_spec"))
    _build(src).close()
    dst = str(tmp_path_factory.mktemp("carried_spec")) + "/data"
    shutil.copytree(src, dst)
    jh = JaxHolder(src).open()
    th = open_reference_holder(dst)
    yield TPUBackend(jh), CUDABackend(th, device="cpu")
    jh.close()
    th.close()


@pytest.mark.parametrize("shards", [list(range(N_SHARDS)), [2, 0]],
                         ids=["all-shards", "subset"])
def test_count_batch_async_equals_jax(carried, shards):
    jb, tb = carried
    jcalls = [jax_parse(q).calls[0] for q in BATCH_CALLS]
    tcalls = [parse_string(q).calls[0] for q in BATCH_CALLS]
    want = jb.count_batch_async("i", jcalls, shards)()
    got = tb.count_batch_async("i", tcalls, shards)()
    assert got == [int(v) for v in want]


@pytest.mark.parametrize("shards", [list(range(N_SHARDS)), [2, 0]],
                         ids=["all-shards", "subset"])
def test_row_batch_async_equals_jax(carried, shards):
    jb, tb = carried
    jcalls = [jax_parse(q).calls[0] for q in BATCH_CALLS]
    tcalls = [parse_string(q).calls[0] for q in BATCH_CALLS]
    want = jb.row_batch_async("i", jcalls, shards)()
    got = tb.row_batch_async("i", tcalls, shards)()
    assert len(got) == len(want)
    for q, g, w in zip(BATCH_CALLS, got, want):
        np.testing.assert_array_equal(g.columns(), w.columns(), err_msg=q)
    assert got[BATCH_CALLS.index("Row(f=1)")] is not got[-3]  # a Row per call


def test_count_batch_groups_and_dedupes_slots(carried):
    """One K11 launch a (spec, blocks) group over its distinct slots: four
    3-row Intersects, two of them the same, are one count_batch launch of
    three slots; a pair-plan batch takes the pair sweep instead."""
    from pilosa_tpu_torch.utils.stats import global_stats

    _, tb = carried
    qs = ["Intersect(Row(f=1), Row(f=2), Row(g=7))", "Intersect(Row(f=2), Row(f=3), Row(g=7))",
          "Intersect(Row(f=1), Row(f=2), Row(g=7))", "Intersect(Row(f=3), Row(f=1), Row(g=7))"]
    calls = [parse_string(q).calls[0] for q in qs]
    seen = []
    real = K.spec_eval

    def spy(ops, leaves, rows, mode="count"):
        seen.append(len(rows))
        return real(ops, leaves, rows, mode)

    key = 'device_launches_total{kind="count_batch"}'
    before = global_stats.counter_totals("device_launches_total").get(key, 0)
    port.spec_eval = spy
    try:
        got = tb.count_batch("i", calls, list(range(N_SHARDS)))
    finally:
        port.spec_eval = real
    assert seen == [3]
    assert global_stats.counter_totals("device_launches_total")[key] == before + 1
    assert got[0] == got[2]
    assert got == [tb.count_shards("i", c, list(range(N_SHARDS))) for c in calls]


def test_row_batch_chunks_under_the_byte_cap(carried, monkeypatch):
    """A row group's distinct slots split into launches whose [Q, S, W]
    output stays under MAX_ROW_BATCH_BYTES (a power of two slots each)."""
    _, tb = carried
    slab = N_SHARDS * WORDS_PER_SHARD * 4
    monkeypatch.setattr(port, "MAX_ROW_BATCH_BYTES", 3 * slab)  # 3 -> 2 slots a launch
    qs = [f"Row(f={r})" for r in (1, 2, 3, 4, 1)]
    calls = [parse_string(q).calls[0] for q in qs]
    seen = []
    real = K.spec_eval

    def spy(ops, leaves, rows, mode="count"):
        seen.append(len(rows))
        return real(ops, leaves, rows, mode)

    monkeypatch.setattr(port, "spec_eval", spy)
    rows = tb.row_batch_async("i", calls, list(range(N_SHARDS)))()
    assert seen == [2, 2]
    for c, r in zip(calls, rows):
        np.testing.assert_array_equal(
            r.columns(), tb.bitmap_call("i", c, list(range(N_SHARDS))).columns())
