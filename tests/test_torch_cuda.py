"""The port's CUDA kernels and backend on the card, against their plain
PyTorch versions and the CPU oracle. Every test here needs a CUDA card and
skips without one. The file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.carry import stack_from_reference
from pilosa_tpu_torch.ops import kernels as K

W = 32768

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


def _stacks(seed, s, rf, rg):
    rng = np.random.default_rng(seed)

    def one(r):
        words = np.bitwise_and.reduce(
            rng.integers(0, 2**32, (4, s, r, W), dtype=np.uint32), axis=0
        )
        words[:, 0, :] = 0
        words[:, -1, :] = 0xFFFFFFFF
        return words

    return one(rf), one(rg)


@pytest.mark.parametrize(
    "s,rf,rg", [(2, 8, 8), (3, 8, 16), (2, 16, 8), (2, 8, 12), (1, 8, 8),
                (3, 64, 64), (5, 1, 3), (2, 9, 130)]
)
def test_kernels_equal_plain_versions(card, s, rf, rg):
    f, g = _stacks(s + rf * rg, s, rf, rg)
    fd, gd = stack_from_reference(f, card), stack_from_reference(g, card)
    fc, gc = stack_from_reference(f, "cpu"), stack_from_reference(g, "cpu")
    before = K.launch_counts()
    per = K.pair_stats_pershard(fd, gd)
    tot = K.pair_stats(fd, gd)
    rows = K.popcount_rows(fd.reshape(-1, W))
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert all(after[k] == before[k] + 1
               for k in ("pair_stats_pershard", "pair_stats", "popcount_rows"))
    assert per.device.type == tot.device.type == rows.device.type == "cuda"
    assert torch.equal(per.cpu(), K.pair_stats_torch(fc, gc, True))
    assert torch.equal(tot.cpu(), K.pair_stats_torch(fc, gc, False))
    assert torch.equal(rows.cpu(), K.popcount_rows_torch(fc.reshape(-1, W)))


def _words(rng, *shape):
    """uint32 words at bit density 1/4 (the AND of two random words)."""
    return (rng.integers(0, 2**32, shape, dtype=np.uint32)
            & rng.integers(0, 2**32, shape, dtype=np.uint32))


# (S, Rf, Rg, extra heights, filtered): E = 2 with heights 3 and 5, Rf != Rg,
# Rg = 13 (off the 8-row tile), S = 1, and filtered; then odometers across
# the tensor-core K6's and K7's 8-slot groups: K = 70 (9 groups, the last
# part-full), K = 1 and E = 8 (K = 256, every decode step); and the
# hoisted odometer (a last extra of 8 or 16 rows after one or two others:
# the slots of a group share the prefix). A filtered shape runs K6 with
# and without its filter (so heights 3 x 5 at Rg = 13 runs both).
GROUP_SHAPES = [
    (2, 8, 8, (3, 5), False),
    (3, 8, 13, (3, 5), True),
    (1, 16, 8, (4,), True),
    (2, 9, 13, (8,), False),
    (1, 8, 8, (2, 3, 2), True),
    (2, 8, 8, (70,), True),
    (2, 8, 8, (1,), True),
    (1, 8, 8, (2,) * 8, True),
    (2, 8, 8, (3, 8), True),
    (1, 9, 13, (2, 2, 16), True),
]


@pytest.mark.parametrize("s,rf,rg,heights,filtered", GROUP_SHAPES)
def test_group_kernels_equal_plain_versions(card, s, rf, rg, heights, filtered):
    rng = np.random.default_rng(s * 1000 + rf * 10 + rg)
    f, g = _words(rng, s, rf, W), _words(rng, s, rg, W)
    hs = [_words(rng, s, r, W) for r in heights]
    filt = _words(rng, s, W) | _words(rng, s, W) if filtered else None
    dev = [stack_from_reference(x, card) for x in [f, g, *hs]]
    cpu = [stack_from_reference(x, "cpu") for x in [f, g, *hs]]
    fd, gd, ed = dev[0], dev[1], tuple(dev[2:])
    fc, gc, ec = cpu[0], cpu[1], tuple(cpu[2:])
    filt_d = None if filt is None else stack_from_reference(filt, card)
    filt_c = None if filt is None else stack_from_reference(filt, "cpu")
    # 7 slots (not a power of two) over random rows, slots 2 and 5 inactive.
    rows = np.stack([rng.integers(0, r, 7) for r in heights], axis=1).astype(np.int32)
    active = np.array([1, 1, 0, 1, 1, 0, 1], dtype=np.int32)
    before = K.launch_counts()
    got = {
        "group_tile_stats": K.group_tile_stats(fd, gd, ed, rows, active, filt_d),
        "group_tile_stats_pershard": K.group_tile_stats_pershard(fd, gd, ed, rows, active),
        "nary_stats": K.nary_stats(fd, gd, ed, filt_d),
        "nary_stats_pershard": K.nary_stats_pershard(fd, gd, ed),
    }
    if filtered:
        got["nary_stats, unfiltered"] = K.nary_stats(fd, gd, ed)
    torch.cuda.synchronize()
    after = K.launch_counts()
    want = {
        "group_tile_stats": K.group_tile_stats_torch(fc, gc, ec, rows, active, filt_c),
        "group_tile_stats_pershard": K.group_tile_stats_pershard_torch(fc, gc, ec, rows,
                                                                       active),
        "nary_stats": K.nary_stats_torch(fc, gc, ec, filt_c),
        "nary_stats_pershard": K.nary_stats_pershard_torch(fc, gc, ec),
    }
    if filtered:
        want["nary_stats, unfiltered"] = K.nary_stats_torch(fc, gc, ec)
    for name in ("group_tile_stats", "group_tile_stats_pershard", "nary_stats_pershard"):
        assert after[name] == before[name] + 1, name
    assert after["nary_stats"] == before["nary_stats"] + 1 + int(filtered)
    for name, out in got.items():
        assert out.device.type == "cuda", name
        assert torch.equal(out.cpu(), want[name]), name
    assert not got["group_tile_stats"][[2, 5]].any()


# (S, Rf, Rg, W) of the tensor-core K2: a 2 x 2 grid of its 128 x 128
# staged tiles, faces off its m16 / n8 sub-tiles, the largest register-direct
# face, and 36-word axes (not a multiple of its 8-word k-chunk) on both routes.
TENSOR_PAIR_SHAPES = [(2, 256, 256, W), (3, 17, 130, W), (1, 16, 8, W),
                      (2, 40, 24, 36), (3, 16, 8, 36)]


@pytest.mark.parametrize("s,rf,rg,w", TENSOR_PAIR_SHAPES)
def test_tensor_core_pair_stats_equals_plain(card, s, rf, rg, w):
    rng = np.random.default_rng(s * 1000 + rf + rg + w)
    f, g = _words(rng, s, rf, w), _words(rng, s, rg, w)
    fd, gd = stack_from_reference(f, card), stack_from_reference(g, card)
    before = K.launch_counts()["pair_stats"]
    got = K.pair_stats(fd, gd)
    torch.cuda.synchronize()
    assert K.launch_counts()["pair_stats"] == before + 1
    want = K.pair_stats_torch(stack_from_reference(f, "cpu"), stack_from_reference(g, "cpu"),
                              False)
    assert torch.equal(got.cpu(), want)


# (S, Rf, Rg, W) of the tensor-core K1: 16 x 8 faces tiled 4 x 8 and 2 x 17
# (cf and cg each counted once), one face exactly, one face of 8 x 8 over a
# 36-word axis, and Rg off the 8-row face.
TENSOR_PAIR_PERSHARD_SHAPES = [(3, 64, 64, W), (3, 17, 130, 100), (1, 16, 8, W),
                               (2, 8, 8, 36), (5, 8, 13, W)]


@pytest.mark.parametrize("s,rf,rg,w", TENSOR_PAIR_PERSHARD_SHAPES)
def test_tensor_core_pair_stats_pershard_equals_plain(card, s, rf, rg, w):
    rng = np.random.default_rng(s * 2000 + rf + rg + w)
    f, g = _words(rng, s, rf, w), _words(rng, s, rg, w)
    fd, gd = stack_from_reference(f, card), stack_from_reference(g, card)
    before = K.launch_counts()["pair_stats_pershard"]
    got = K.pair_stats_pershard(fd, gd)
    torch.cuda.synchronize()
    assert K.launch_counts()["pair_stats_pershard"] == before + 1
    # The plain version on the card: the same arithmetic, in seconds less.
    assert torch.equal(got, K.pair_stats_torch(fd, gd, True))


@pytest.mark.parametrize("rf,rg,w", [(9, 8, W), (16, 13, W), (9, 16, 36)])
def test_tensor_core_group_tile_equals_plain(card, rf, rg, w):
    """K4's and K5's slot pairs: 1 to 9 slots, every third inactive (its
    cells stay 0), K4 filtered and not."""
    rng = np.random.default_rng(rf * 100 + rg + w)
    s, heights = 2, (3, 5)
    f, g = _words(rng, s, rf, w), _words(rng, s, rg, w)
    hs = [_words(rng, s, r, w) for r in heights]
    filt = _words(rng, s, w) | _words(rng, s, w)
    dev = [stack_from_reference(x, card) for x in [f, g, filt, *hs]]
    cpu = [stack_from_reference(x, "cpu") for x in [f, g, filt, *hs]]
    for n in range(1, 10):
        rows = np.stack([rng.integers(0, r, n) for r in heights], axis=1).astype(np.int32)
        active = np.array([int(q % 3 != 2) for q in range(n)], dtype=np.int32)
        for filtered in (False, True):
            before = K.launch_counts()["group_tile_stats"]
            got = K.group_tile_stats(dev[0], dev[1], tuple(dev[3:]), rows, active,
                                     dev[2] if filtered else None)
            torch.cuda.synchronize()
            assert K.launch_counts()["group_tile_stats"] == before + 1
            want = K.group_tile_stats_torch(cpu[0], cpu[1], tuple(cpu[3:]), rows, active,
                                            cpu[2] if filtered else None)
            assert torch.equal(got.cpu(), want), (n, filtered)
            assert not got[torch.from_numpy(active == 0).to(card)].any()
        before = K.launch_counts()["group_tile_stats_pershard"]
        per = K.group_tile_stats_pershard(dev[0], dev[1], tuple(dev[3:]), rows, active)
        torch.cuda.synchronize()
        assert K.launch_counts()["group_tile_stats_pershard"] == before + 1
        want = K.group_tile_stats_pershard_torch(cpu[0], cpu[1], tuple(cpu[3:]), rows, active)
        assert torch.equal(per.cpu(), want), n
        assert not per[torch.from_numpy(active == 0).to(card)].any()


def test_and_popc_probe_rates(card):
    from pilosa_tpu_torch.ops.probe import and_popc_rates

    rates = and_popc_rates(card, target_ms=5.0)
    assert set(rates) == {"b1", "popc"}
    assert all(0 < r < float("inf") for r in rates.values())


def test_kernels_refuse_misaligned_words(card):
    flat = torch.zeros(4 * W + 1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        K.popcount_rows(flat[1:].view(4, W))  # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="multiple of 4"):
        K.popcount_rows(torch.zeros((2, 6), dtype=torch.int32, device=card))


def test_backend_on_card_matches_cpu_oracle(card):
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(3)
    h = Holder(None).open()
    idx = h.create_index("i")
    for name, rows in (("f", 8), ("g", 8)):
        field = idx.create_field(name)
        for row in range(rows):
            cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, 5000, dtype=np.uint64))
            field.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    dev = Executor(h, backend=CUDABackend(h))
    cpu = Executor(h, backend=CPUBackend(h))
    K.reset_launch_counts()
    queries = ["Count(Intersect(Row(f=1), Row(g=2)))", "Count(Xor(Row(f=3), Row(g=3)))",
               " ".join(f"Count(Union(Row(f={a}), Row(g={a})))" for a in range(8))]
    for q in queries:
        assert dev.execute("i", q) == cpu.execute("i", q), q
    got = dev.execute("i", "Row(f=4)")[0].columns()
    np.testing.assert_array_equal(got, cpu.execute("i", "Row(f=4)")[0].columns())
    counts = K.launch_counts()
    # K11 for each single Count and for Row(f=4), the pair kernel for the
    # 8-Count request; no K3.
    assert counts["spec_eval"] == 3 and counts["pair_stats_pershard"] == 1
    assert counts["popcount_rows"] == 0


def test_http_count_round_trip_on_card(card):
    """A Count sent over HTTP to the port's server runs on the card (one
    K3 launch on a handler thread) and answers what the CPU oracle does."""
    import http.client
    import json

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.server import API, Server
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(4)
    h = Holder(None).open()
    idx = h.create_index("i")
    for name in ("f", "g"):
        cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, 5000, dtype=np.uint64))
        idx.create_field(name).import_bits(np.full(cols.size, 1, dtype=np.uint64), cols)
    q = "Count(Intersect(Row(f=1), Row(g=1)))"
    want = Executor(h, backend=CPUBackend(h)).execute("i", q)
    srv = Server(API(h, Executor(h, backend=CUDABackend(h))), host="127.0.0.1", port=0).open()
    try:
        K.reset_launch_counts()
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        conn.request("POST", "/index/i/query", body=q.encode())
        r = conn.getresponse()
        assert r.status == 200
        assert json.loads(r.read()) == {"results": want}
        assert K.launch_counts()["spec_eval"] == 1
        conn.request("GET", "/debug/diagnostics")
        inv = json.loads(conn.getresponse().read())["jax"]
        conn.close()
        assert inv["platform"] == "gpu" and inv["device_count"] == torch.cuda.device_count()
        assert inv["devices"][0]["kind"] == torch.cuda.get_device_name(0)
    finally:
        srv.close()
        h.close()


def _bsi_words(rng, s, depth, w):
    """A BSI stack [s, 2 + depth padded to 8, w] of uint32 words (exists,
    sign, planes), bit 31 set in many words; shard 1 is all negative and
    shard 2 empty when s > 2."""
    rows = -(-(2 + depth) // 8) * 8
    st = np.zeros((s, rows, w), dtype=np.uint32)
    exists = rng.integers(0, 2**32, (s, w), dtype=np.uint32)
    st[:, 0] = exists
    st[:, 1] = exists & rng.integers(0, 2**32, (s, w), dtype=np.uint32)
    for i in range(depth):
        st[:, 2 + i] = exists & rng.integers(0, 2**32, (s, w), dtype=np.uint32)
    if s > 2:
        st[1, 1] = st[1, 0]
        st[2] = 0
    return st


# (S, R, row0, n_rows, masks, W): M = 0, 1, 2; row0 > 0; one row; a 36-word
# axis; the BSI planes of a depth-14 stack read in place.
ROW_POPCOUNT_SHAPES = [(3, 8, 0, 8, 0, W), (2, 16, 0, 16, 1, W), (3, 16, 2, 14, 2, W),
                       (1, 8, 7, 1, 2, W), (4, 24, 5, 11, 1, 36), (2, 8, 3, 0, 1, W)]


@pytest.mark.parametrize("s,r,row0,n_rows,m,w", ROW_POPCOUNT_SHAPES)
def test_row_popcounts_equals_plain(card, s, r, row0, n_rows, m, w):
    rng = np.random.default_rng(s * 100 + r + row0 + m + w)
    st = rng.integers(0, 2**32, (s, r, w), dtype=np.uint32)
    masks = [rng.integers(0, 2**32, (s, w), dtype=np.uint32) for _ in range(m)]
    dev = [stack_from_reference(x, card) for x in [st, *masks]]
    cpu = [stack_from_reference(x, "cpu") for x in [st, *masks]]
    before = K.launch_counts()["row_popcounts"]
    got = K.row_popcounts(dev[0], row0, n_rows, tuple(dev[1:]))
    torch.cuda.synchronize()
    assert K.launch_counts()["row_popcounts"] == before + int(n_rows > 0)
    want = K.row_popcounts_torch(cpu[0], row0, n_rows, tuple(cpu[1:]))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


# (S, depth, filtered, W): the served depth, depths 1 and 63, no planes;
# word axes the shard's cluster of 8 blocks splits unevenly (36 and 1000
# words: the last blocks own fewer words, or none) or leaves to one block (4).
@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("s,depth,filtered,w", [(3, 14, False, W), (4, 14, True, W),
                                                (2, 1, True, W), (3, 63, False, W),
                                                (3, 5, True, 36), (1, 0, False, W),
                                                (3, 14, True, 1000), (3, 14, False, 4)])
def test_bsi_minmax_equals_plain(card, kind, s, depth, filtered, w):
    rng = np.random.default_rng(s * 1000 + depth + w)
    st = _bsi_words(rng, s, depth, w)
    filt = rng.integers(0, 2**32, (s, w), dtype=np.uint32)
    filt[0] = 0  # the filter empties shard 0
    dev = stack_from_reference(st, card)
    cpu = stack_from_reference(st, "cpu")
    fd = stack_from_reference(filt, card) if filtered else None
    fc = stack_from_reference(filt, "cpu") if filtered else None
    before = K.launch_counts()["bsi_minmax"]
    got = K.bsi_minmax(dev, depth, fd, kind)
    torch.cuda.synchronize()
    assert K.launch_counts()["bsi_minmax"] == before + 1
    assert torch.equal(got.cpu(), K.bsi_minmax_torch(cpu, depth, fc, kind))


def _compare_conditions(depth):
    """(op, neg, allow_eq, value, hi) of every comparison, both signs, and
    every between class, at predicates 0, all ones and bit depth - 1 alone."""
    top = (1 << depth) - 1
    values = sorted({0, top, 1 << (depth - 1)})
    out = [(op, neg, eq, v, None) for v in values for op in ("==", "!=", "<", ">")
           for neg in (False, True) for eq in ((False, True) if op in "<>" else (False,))]
    for lo in values:
        for hi in values:
            if lo <= hi:
                out += [("pos", False, False, lo, hi), ("neg", False, False, hi, lo)]
            out.append(("mixed", False, False, lo, hi))
    return out


@pytest.mark.parametrize("s,depth,w", [(3, 1, W), (4, 14, W), (3, 63, W), (3, 14, 36),
                                       (2, 5, 1000)])
def test_bsi_compare_equals_plain(card, s, depth, w):
    """K10 at the edge shapes: every op, sign and between class, an
    all-negative and an empty shard (S >= 3), one launch a condition."""
    from pilosa_tpu_torch.exec.cuda import _pred_bits

    rng = np.random.default_rng(s * 77 + depth + w)
    dev = stack_from_reference(_bsi_words(rng, s, depth, w), card)
    for op, neg, eq, v, hi in _compare_conditions(depth):
        bits = _pred_bits(v, depth)
        hb = None if hi is None else _pred_bits(hi, depth)
        before = K.launch_counts()["bsi_compare"]
        got = K.bsi_compare(dev, depth, op, bits, neg=neg, allow_eq=eq, hi_bits=hb)
        torch.cuda.synchronize()
        assert K.launch_counts()["bsi_compare"] == before + 1
        # The plain form's torch ops on the same card.
        want = K.bsi_compare_torch(dev, depth, op, bits, neg, eq, hb)
        assert got.device.type == "cuda" and torch.equal(got, want), (op, neg, eq, v, hi)


def test_backend_condition_counts_on_card_match_cpu_oracle(card):
    """Each BSI condition node of a Count runs as one K10 launch, and the
    Count as one K11, answering what the CPU oracle does."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.field import options_for_int
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(9)
    h = Holder(None).open()
    idx = h.create_index("i")
    cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, 4000, dtype=np.uint64))
    vals = rng.integers(-9000, 9001, cols.size)
    idx.create_field("v", options_for_int(-10000, 10000)).import_value(cols, vals)
    dev = Executor(h, backend=CUDABackend(h))
    cpu = Executor(h, backend=CPUBackend(h))
    x = int(vals[7])
    for q, nodes in [("Count(Row(v > 100))", 1), ("Count(Row(v >= -100))", 1),
                     ("Count(Row(v < -8990))", 1), ("Count(Row(v <= 0))", 1),
                     (f"Count(Row(v == {x}))", 1), (f"Count(Row(v != {x}))", 1),
                     ("Count(Row(v >< [-50, 50]))", 1), ("Count(Row(v >< [10, 5000]))", 1),
                     ("Count(Row(v >< [-5000, -10]))", 1),
                     ("Count(Intersect(Row(v > -3000), Row(v < 3000)))", 2),
                     ("Count(Row(v != null))", 0)]:
        K.reset_launch_counts()
        assert dev.execute("i", q) == cpu.execute("i", q), q
        counts = K.launch_counts()
        assert counts["bsi_compare"] == nodes and counts["spec_eval"] == 1, (q, counts)
        assert counts["popcount_rows"] == 0, (q, counts)
    h.close()


def test_backend_bsi_and_topn_on_card_match_cpu_oracle(card):
    """TopN, Rows, Sum, Min, Max, a BSI condition, a time range and Shift
    on the card answer what the CPU oracle does, none routed to the host;
    an uncached Sum launches K8 and K3 once, Min K9 once."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.field import options_for_int, options_for_time
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils.stats import global_stats

    rng = np.random.default_rng(5)
    h = Holder(None).open()
    idx = h.create_index("i")
    for name in ("f", "g"):
        field = idx.create_field(name)
        for row in range(8):
            cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, 3000, dtype=np.uint64))
            field.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, 900, dtype=np.uint64))
    idx.create_field("v", options_for_int(-10000, 10000)).import_value(
        cols, rng.integers(-9000, 9001, cols.size))
    idx.create_field("t", options_for_time("YMDH"))
    backend = CUDABackend(h)
    dev = Executor(h, backend=backend)
    cpu = Executor(h, backend=CPUBackend(h))
    for q in ("Set(3, t=9, 2019-08-03T10:00)", "Set(1048579, t=9, 2019-08-05T12:00)"):
        cpu.execute("i", q)
    routed = sum(global_stats.counter_totals("cpu_routed_total").values())
    K.reset_launch_counts()
    assert dev.execute("i", "Sum(field=v)") == cpu.execute("i", "Sum(field=v)")
    assert K.launch_counts()["row_popcounts"] == 1 and K.launch_counts()["popcount_rows"] == 1
    assert dev.execute("i", "Min(field=v)") == cpu.execute("i", "Min(field=v)")
    assert K.launch_counts()["bsi_minmax"] == 1
    queries = ["TopN(f, n=3)", "TopN(f, Row(g=2), n=4)", "Rows(g, previous=2, limit=3)",
               "Max(Row(f=1), field=v)", "Sum(Intersect(Row(f=2), Row(g=3)), field=v)",
               "Count(Row(v > 100))", "Count(Row(v >< [-50, 50]))", "Count(Row(v < -8990))",
               "Count(Shift(Row(f=1), n=33))", "GroupBy(Rows(f))",
               "Row(t=9, from='2019-08-01T00:00', to='2019-08-31T00:00')"]
    for q in queries:
        got, want = dev.execute("i", q), cpu.execute("i", q)
        if q.startswith("Row("):
            np.testing.assert_array_equal(got[0].columns(), want[0].columns())
        else:
            assert got == want, q
    # Shift's left shift wraps past the sign bit on the card as on the host.
    got = dev.execute("i", "Shift(Row(f=2), n=40)")[0].columns()
    np.testing.assert_array_equal(got, cpu.execute("i", "Shift(Row(f=2), n=40)")[0].columns())
    assert sum(global_stats.counter_totals("cpu_routed_total").values()) == routed
    h.close()


def _spec_case(rng, s, w, n_leaves):
    """K11's inputs: n_leaves leaves (stacks of 8 or 16 rows and [S, W]
    slabs, in turn) and a program that pushes them in order, folding with
    every op and reaching a stack of min(n_leaves, MAX_SPEC_DEPTH)."""
    leaves = []
    for i in range(n_leaves):
        shape = (s, w) if i % 3 == 2 else (s, 8 if i % 3 == 0 else 16, w)
        leaves.append(_words(rng, *shape))
    ops_cycle = (K.SPEC_AND, K.SPEC_OR, K.SPEC_ANDNOT, K.SPEC_XOR)
    ops, depth, k = [], 0, 0
    for i in range(n_leaves):
        ops.append(i)
        depth += 1
        # Pile up to the depth limit first, then fold after each push.
        if depth == K.MAX_SPEC_DEPTH or (i >= K.MAX_SPEC_DEPTH and depth > 1):
            ops.append(ops_cycle[k % 4])
            k += 1
            depth -= 1
    while depth > 1:
        ops.append(ops_cycle[k % 4])
        k += 1
        depth -= 1
    return leaves, ops


def _spec_rows(rng, leaves, q):
    """q slots' rows: random rows, and -1 (the zero leaf, as a row past the
    stack's height with mask 0) in about one of five."""
    rows = []
    for _ in range(q):
        slot = []
        for x in leaves:
            height = x.shape[1] if x.ndim == 3 else 1
            slot.append(-1 if rng.random() < 0.2 else int(rng.integers(0, height)))
        rows.append(slot)
    return rows


@pytest.mark.parametrize("q", [1, 64])
@pytest.mark.parametrize("s,w,n_leaves", [(1, W, 2), (3, W, 3), (2, W, K.MAX_SPEC_LEAVES),
                                          (2, 36, 5), (1, 100, K.MAX_SPEC_DEPTH)])
def test_spec_eval_equals_plain(card, s, w, n_leaves, q):
    """K11 in both modes equals its plain form: S = 1, word axes off the
    block's chunk, every op, the full leaf table and stack, zero leaves,
    Q = 1 and 64 (the per-slot entries in the launch's parameters or, past
    SPEC_INLINE_ROWS, in a table on the card), one launch a run of the
    window's split (random rows of 64 slots pass MAX_SPEC_ENTRIES)."""
    rng = np.random.default_rng(s * 1000 + n_leaves + q)
    leaves, ops = _spec_case(rng, s, w, n_leaves)
    rows = _spec_rows(rng, leaves, q)
    dev = [stack_from_reference(x, card) for x in leaves]
    cpu = [stack_from_reference(x, "cpu") for x in leaves]
    launches = len(K.spec_split(dev, rows))
    for mode in ("count", "slab"):
        before = K.launch_counts()["spec_eval"]
        got = K.spec_eval(ops, dev, rows, mode)
        torch.cuda.synchronize()
        assert K.launch_counts()["spec_eval"] == before + launches
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), K.spec_eval_torch(ops, cpu, rows, mode)), mode


def test_backend_spec_programs_on_card_equal_plain(card):
    """Every spec tag through the backend's K11 run on the card (slab
    leaves by K10, _shift_slab and sub-programs) equals the same run on
    the CPU, for 1 and 64 slots."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec.cuda import CUDABackend

    rng = np.random.default_rng(21)
    s = 3
    stacks = {n: _words(rng, s, 8, W) for n in ("f", "g", "e", "t0", "t1")}
    v = _words(rng, s, 16, W)
    stacks["v"] = v
    h = Holder(None).open()
    dev_be, cpu_be = CUDABackend(h), CUDABackend(h, device="cpu")

    def row():
        return (int(rng.integers(0, 8)), 1) if rng.random() < 0.8 else (7, 0)

    def bits():
        return tuple(int(b) for b in rng.integers(0, 2, 12))

    cases = [
        (("I", (("R", "f"), ("R", "g"))), ["f", "g"], lambda: row() + row()),
        (("N", ("X", (("R", "f"), ("R", "g")))), ["e", "f", "g"], lambda: row() + row()),
        (("U", (("A",), ("E",))), ["e", "f"], lambda: ()),
        (("T", "t", 2), ["t0", "t1"], lambda: row() + row()),
        (("D", (("NN", "v"), ("R", "f"))), ["v", "f"], row),
        (("I", (("C", "v", ">", False, True, 12), ("R", "f"))), ["v", "f"],
         lambda: (bits(),) + row()),
        (("U", (("CB", "v", "mixed", 12), ("R", "g"))), ["v", "g"],
         lambda: (bits(), bits()) + row()),
        (("S", 33, ("I", (("R", "f"), ("R", "g")))), ["f", "g"], lambda: row() + row()),
        (("U", tuple(("R", "fg"[k % 2]) for k in range(20))), ["f", "g"] * 10,
         lambda: sum((row() for _ in range(20)), ())),
    ]
    for spec, names, gen in cases:
        prog = K.spec_program(spec)
        dev_blocks = [stack_from_reference(stacks[n], card) for n in names]
        cpu_blocks = [stack_from_reference(stacks[n], "cpu") for n in names]
        for q in ((1, 4) if prog.per_slot else (1, 64)):
            slots = [gen() for _ in range(q)]
            for mode in ("count", "slab"):
                got = dev_be._spec_run(prog, dev_blocks, slots, mode, "count")
                want = cpu_be._spec_run(prog, cpu_blocks, slots, mode, "count")
                assert torch.equal(got.cpu(), want), (spec, q, mode)
    h.close()


def test_backend_batches_on_card_match_cpu_oracle(card):
    """count_batch_async and row_batch_async on the card answer what the
    CPU oracle does: a 3-row window is one K11 launch over its distinct
    slots, a row window one K11 launch in slab mode, and the single Count
    one K11 launch with nothing else."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.pql import parse_string
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(8)
    h = Holder(None).open()
    idx = h.create_index("i")
    for name in ("f", "g", "h"):
        field = idx.create_field(name)
        for row in range(4):
            cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, 3000, dtype=np.uint64))
            field.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    be = CUDABackend(h)
    cpu = Executor(h, backend=CPUBackend(h))
    qs = [f"Intersect(Row(f={a}), Row(g={b}), Row(h=1))" for a in range(4) for b in range(4)]
    calls = [parse_string(q).calls[0] for q in qs + qs[:3]]
    K.reset_launch_counts()
    got = be.count_batch("i", calls, [0, 1, 2])
    assert K.launch_counts()["spec_eval"] == 1
    assert got == [cpu.execute("i", f"Count({q})")[0] for q in qs + qs[:3]]
    K.reset_launch_counts()
    rows = be.row_batch_async("i", calls[:5], [2, 0])()
    assert K.launch_counts()["spec_eval"] == 1
    for q, r in zip(qs[:5], rows):
        want = cpu.execute("i", q, shards=[2, 0])[0]
        np.testing.assert_array_equal(r.columns(), want.columns())
    K.reset_launch_counts()
    dev = Executor(h, backend=be)
    assert dev.execute("i", "Count(Intersect(Row(f=1), Row(g=2)))") == cpu.execute(
        "i", "Count(Intersect(Row(f=1), Row(g=2)))")
    assert K.launch_counts() == {**{k: 0 for k in K.launch_counts()}, "spec_eval": 1}
    h.close()


def _shared_window(rng, s, w):
    """Stacks f, g (8 rows), h (4 rows), the existence row e, and 64 slots
    of 3-row windows that share their rows as the batcher's do: every
    (a, b) with h row 0, some with the zero leaf."""
    f, g, h = (_words(rng, s, r, w) for r in (8, 8, 4))
    e = _words(rng, s, 1, w)
    rows = [[a, -1 if (a + b) % 9 == 0 else b, 0] for a in range(8) for b in range(8)]
    return (f, g, h, e), rows


@pytest.mark.parametrize("spec,names", [
    (("I", (("R", "f"), ("R", "g"), ("R", "h"))), "fgh"),
    (("U", (("R", "f"), ("R", "g"), ("R", "h"))), "fgh"),
    (("D", (("R", "f"), ("R", "g"), ("R", "h"))), "fgh"),
    (("X", (("R", "f"), ("R", "g"), ("R", "h"))), "fgh"),
    (("N", ("I", (("R", "f"), ("R", "g")))), "efg"),
    (("I", (("R", "f"), ("T", "t", 2))), "fgh"),
])
@pytest.mark.parametrize("q", [1, 8, 64])
def test_spec_window_shared_rows_equal_plain(card, spec, names, q):
    """K11 over windows whose slots share rows (the window body stages each
    distinct row once) equals its plain form in both modes: folds of every
    op, a Not over a pair, a row with a time range; 1, 8 and 64 slots."""
    rng = np.random.default_rng(q + len(spec))
    stacks, rows = _shared_window(rng, 3, W)
    by = dict(zip("fghe", stacks))
    leaves = [by[n] for n in names]
    if names == "efg":  # the existence row, then f and g
        rows = [[0, r[0], r[1]] for r in rows]
    rows = rows[:q]
    ops = K.spec_program(spec).ops
    dev = [stack_from_reference(x, card) for x in leaves]
    cpu = [stack_from_reference(x, "cpu") for x in leaves]
    assert K.spec_split(dev, rows) == [(0, q)]
    for mode in ("count", "slab"):
        before = K.launch_counts()["spec_eval"]
        got = K.spec_eval(ops, dev, rows, mode)
        torch.cuda.synchronize()
        assert K.launch_counts()["spec_eval"] == before + 1
        assert torch.equal(got.cpu(), K.spec_eval_torch(ops, cpu, rows, mode)), mode


def test_spec_window_past_the_cap_launches_its_split(card):
    """A window past MAX_SPEC_ENTRIES (8 + 8 + 16 rows) and one past
    MAX_SPEC_SLOTS: one launch a run of spec_split, exactly, equal to the
    plain form."""
    rng = np.random.default_rng(31)
    f, g, wide = (_words(rng, 2, r, 1028) for r in (8, 8, 16))
    cases = [((f, g, wide), [[k % 8, (k // 8) % 8, k % 16] for k in range(64)],
              K.spec_program(("I", (("R", "f"), ("R", "g"), ("R", "w")))).ops),
             ((f,), [[k % 8] for k in range(600)], (0,))]
    for leaves, rows, ops in cases:
        dev = [stack_from_reference(x, card) for x in leaves]
        cpu = [stack_from_reference(x, "cpu") for x in leaves]
        spans = K.spec_split(dev, rows)
        assert len(spans) > 1
        for mode in ("count", "slab"):
            before = K.launch_counts()["spec_eval"]
            got = K.spec_eval(ops, dev, rows, mode)
            torch.cuda.synchronize()
            assert K.launch_counts()["spec_eval"] == before + len(spans)
            assert torch.equal(got.cpu(), K.spec_eval_torch(ops, cpu, rows, mode)), mode


@pytest.mark.parametrize("spec,names", [
    (("I", (("R", "f"), ("R", "g"))), "fg"), (("R", "f"), "f"),
    (("N", ("I", (("R", "f"), ("R", "g")))), "efg")])
def test_spec_one_slot_both_bodies_equal_plain(card, spec, names):
    """One slot in both modes on both bodies (the wrapper's choice and the
    other, forced through the bare entry point) equals the plain form."""
    from pilosa_tpu_torch.ops.build import library

    rng = np.random.default_rng(len(names))
    stacks, _ = _shared_window(rng, 2, W)
    by = dict(zip("fghe", stacks))
    ops = K.spec_program(spec).ops
    rows = [{"f": [3], "fg": [3, 5], "efg": [0, 3, 5]}[names]]
    dev = [stack_from_reference(by[n], card) for n in names]
    cpu = [stack_from_reference(by[n], "cpu") for n in names]
    lib = library(K._LIBRARY["spec_eval"])
    for mode in ("count", "slab"):
        want = K.spec_eval_torch(ops, cpu, rows, mode)
        assert torch.equal(K.spec_eval(ops, dev, rows, mode).cpu(), want)
        for body in (K.SPEC_BODY_SLOT, K.SPEC_BODY_WINDOW):
            out = torch.empty(tuple(want.shape), dtype=torch.int32, device=card)
            args, keep = K.spec_launch_args(ops, dev, rows, out, mode, body)
            assert lib.spec_eval_launch(*args, torch.cuda.current_stream().cuda_stream) == 0
            torch.cuda.synchronize()
            del keep
            assert torch.equal(out.cpu(), want), (mode, body)


@pytest.mark.parametrize("spec,names", [
    (("I", (("R", "f"), ("R", "g"), ("R", "h"))), "fgh"),
    (("X", (("R", "f"), ("R", "g"))), "fg"),
    (("U", tuple(("R", "f") for _ in range(5))), "fffff"),
    (("N", ("I", (("R", "f"), ("R", "g")))), "efg"),
])
@pytest.mark.parametrize("q", [8, 64])
def test_spec_window_body_variants_equal_plain(card, spec, names, q):
    """The window body's two timed variants, the program walk and the fold
    over a run-time leaf count, forced through the bare entry point, equal
    the plain form in both modes, as the window body does."""
    from pilosa_tpu_torch.ops.build import library

    rng = np.random.default_rng(q + len(names))
    stacks, rows = _shared_window(rng, 2, W)
    by = dict(zip("fghe", stacks))
    rows = [{"fgh": r, "fg": r[:2], "efg": [0, r[0], r[1]],
             "fffff": [r[0], r[1], (r[0] + 3) % 8, -1, (r[0] * 5) % 8]}[names]
            for r in rows[:q]]
    dev = [stack_from_reference(by[n], card) for n in names]
    cpu = [stack_from_reference(by[n], "cpu") for n in names]
    if names == "fffff":  # one stack: its rows are entries of every leaf
        dev, cpu = [dev[0]] * 5, [cpu[0]] * 5
    ops = K.spec_program(spec).ops
    lib = library(K._LIBRARY["spec_eval"])
    for mode in ("count", "slab"):
        want = K.spec_eval_torch(ops, cpu, rows, mode)
        for body in (K.SPEC_BODY_WINDOW, K.SPEC_BODY_WALK, K.SPEC_BODY_FOLD_N):
            out = torch.empty(tuple(want.shape), dtype=torch.int32, device=card)
            args, keep = K.spec_launch_args(ops, dev, rows, out, mode, body)
            assert lib.spec_eval_launch(*args, torch.cuda.current_stream().cuda_stream) == 0
            torch.cuda.synchronize()
            del keep
            assert torch.equal(out.cpu(), want), (mode, body)


def test_spec_windows_of_2_and_17_entries_from_threads(card):
    """K11 launched from 8 threads at once, each alternating a single Count
    (2 entries) and a window of 64 3-row Counts (17 entries): both run the
    same fold kernel with different shared memory, and every call returns
    its plain answer."""
    import threading

    rng = np.random.default_rng(217)
    (f, g, h, _), _ = _shared_window(rng, 3, W)
    dev = [stack_from_reference(x, card) for x in (f, g, h)]
    cpu = [stack_from_reference(x, "cpu") for x in (f, g, h)]
    pair = K.spec_program(("I", (("R", "f"), ("R", "g")))).ops
    three = K.spec_program(("I", (("R", "f"), ("R", "g"), ("R", "h")))).ops
    window = [[a, b, 0] for a in range(8) for b in range(8)]
    shapes = [(pair, dev[:2], [[1, 2]], K.spec_eval_torch(pair, cpu[:2], [[1, 2]])),
              (three, dev, window, K.spec_eval_torch(three, cpu, window))]
    assert [len(K.spec_window(leaves, rows)[0]) for _, leaves, rows, _ in shapes] == [2, 17]
    errors = []

    def worker(k):
        try:
            for j in range(25):
                ops, leaves, rows, want = shapes[(k + j) % 2]
                got = K.spec_eval(ops, leaves, rows)
                torch.cuda.current_stream().synchronize()
                if not torch.equal(got.cpu(), want):
                    errors.append((k, j))
        except Exception as e:  # noqa: BLE001 - reported by the assert
            errors.append((k, repr(e)))

    before = K.launch_counts()["spec_eval"]
    pool = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    assert errors == []
    assert K.launch_counts()["spec_eval"] == before + 8 * 25


def test_generic_batch_window_of_64_three_row_counts_is_one_launch(card):
    """_generic_batch_dispatch over 64 distinct 3-row Counts is one K11
    launch, and its answers are the CPU oracle's."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.pql import parse_string
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(64)
    h = Holder(None).open()
    idx = h.create_index("i")
    for name, n_rows in (("f", 8), ("g", 8), ("h", 4)):
        field = idx.create_field(name)
        for row in range(n_rows):
            cols = np.unique(rng.integers(0, 2 * SHARD_WIDTH, 4000, dtype=np.uint64))
            field.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    be = CUDABackend(h)
    cpu = Executor(h, backend=CPUBackend(h))
    qs = [f"Intersect(Row(f={a}), Row(g={b}), Row(h=0))" for a in range(8) for b in range(8)]
    calls = [parse_string(q).calls[0] for q in qs]
    K.reset_launch_counts()
    got = be.count_batch("i", calls, [0, 1])
    assert K.launch_counts()["spec_eval"] == 1
    assert got == [cpu.execute("i", f"Count({q})")[0] for q in qs]
    h.close()


@pytest.mark.parametrize("rf,rg,density_ands", [(8, 8, 4), (8, 8, 1), (16, 8, 2)])
def test_host_table_rows_equal_the_card_rows(card, rf, rg, density_ands):
    """The host rows a write epoch derives (exec/cuda.py
    _host_slab_pair_flat, _host_slab_row_counts) equal K1's and K8's rows
    of the same slabs on the card, exactly."""
    from pilosa_tpu_torch.exec import cuda as C

    rng = np.random.default_rng(rf * 10 + density_ands)
    s = 4
    f = np.bitwise_and.reduce(rng.integers(0, 2**32, (density_ands, s, rf, W),
                                           dtype=np.uint32), axis=0)
    g = np.bitwise_and.reduce(rng.integers(0, 2**32, (density_ands, s, rg, W),
                                           dtype=np.uint32), axis=0)
    fd, gd = stack_from_reference(f, card), stack_from_reference(g, card)
    pair = K.pair_stats_pershard(fd, gd).cpu().numpy()
    rows = K.row_popcounts(fd, 0, rf)[0].cpu().numpy().astype(np.int64)
    for i in range(s):
        assert np.array_equal(C._host_slab_pair_flat(f[i], g[i]), pair[i])
        assert np.array_equal(C._host_slab_row_counts(f[i]), rows[i])


def test_write_epochs_absorbed_without_a_launch(card):
    """After one warm-up request of each kind, write epochs (Set and Clear of
    one bit) answered by the pair request and TopN launch neither K1, K2 nor
    K8: the tables absorb them on the host. Every answer equals the CPU
    oracle's."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils.stats import global_stats

    rng = np.random.default_rng(8)
    h = Holder(None).open()
    idx = h.create_index("i")
    for name in ("f", "g"):
        field = idx.create_field(name)
        for row in range(8):
            cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, 4000, dtype=np.uint64))
            field.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    dev = Executor(h, backend=CUDABackend(h))
    cpu = Executor(h, backend=CPUBackend(h))
    pair = " ".join(f"Count(Intersect(Row(f={a}), Row(g={b})))"
                    for a in range(4) for b in range(4))
    queries = [pair, "TopN(f)", "TopN(g, n=3)"]
    for q in queries:
        assert dev.execute("i", q) == cpu.execute("i", q), q
    absorbed = sum(global_stats.counter_totals("pair_stats_incremental_updates_total",
                                               "topn_incremental_updates_total").values())
    before = K.launch_counts()
    for k in range(12):
        col = int(rng.integers(0, 3 * SHARD_WIDTH))
        write = f"{'Set' if k % 3 else 'Clear'}({col}, {'fg'[k % 2]}={k % 8})"
        cpu.execute("i", write)
        for q in queries:
            assert dev.execute("i", q) == cpu.execute("i", q), (write, q)
    after = K.launch_counts()
    for name in ("pair_stats_pershard", "pair_stats", "row_popcounts"):
        assert after[name] == before[name], name
    assert sum(global_stats.counter_totals("pair_stats_incremental_updates_total",
                                           "topn_incremental_updates_total").values()) > absorbed
    h.close()


@pytest.mark.parametrize("rs,density_ands", [([8, 8, 8], 4), ([8, 8, 8], 1),
                                             ([8, 16, 8, 8], 2)])
def test_host_groupn_rows_equal_the_card_rows(card, rs, density_ands):
    """The N-field group table's host rows (exec/cuda.py _host_slab_groupn)
    equal K7's rows and K5's over every combination of the same slabs on
    the card, exactly."""
    from pilosa_tpu_torch.exec import cuda as C

    rng = np.random.default_rng(sum(rs) + density_ands)
    s = 3
    host = [np.bitwise_and.reduce(rng.integers(0, 2**32, (density_ands, s, r, W),
                                               dtype=np.uint32), axis=0) for r in rs]
    dev = [stack_from_reference(x, card) for x in host]
    k7 = K.nary_stats_pershard(dev[0], dev[1], tuple(dev[2:])).cpu().numpy()
    grids = np.meshgrid(*[np.arange(r) for r in rs[2:]], indexing="ij")
    combos = np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)
    k5 = K.group_tile_stats_pershard(dev[0], dev[1], tuple(dev[2:]), combos,
                                     np.ones(len(combos), np.int32)).cpu().numpy()
    for i in range(s):
        row = C._host_slab_groupn([x[i] for x in host], rs)
        assert np.array_equal(row, k7[:, i].reshape(-1))
        assert np.array_equal(row, k5[:, i].reshape(-1))


def test_groupn_and_aggregate_epochs_absorbed_without_a_launch(card):
    """After one warm-up request of each kind, write epochs answered by the
    3-field GroupBy, Sum, Min and Max launch neither K5, K3, K8 nor K9: the
    tables absorb them on the host. Every answer equals the CPU oracle's."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.field import options_for_int
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils.stats import global_stats

    rng = np.random.default_rng(9)
    h = Holder(None).open()
    idx = h.create_index("i")
    for name, rows in (("f", 8), ("g", 8), ("h", 4)):
        field = idx.create_field(name)
        for row in range(rows):
            cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, 40000, dtype=np.uint64))
            field.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, 900, dtype=np.uint64))
    idx.create_field("v", options_for_int(-10000, 10000)).import_value(
        cols, rng.integers(-9000, 9001, cols.size))
    dev = Executor(h, backend=CUDABackend(h))
    cpu = Executor(h, backend=CPUBackend(h))
    queries = ["GroupBy(Rows(f), Rows(g), Rows(h))", "Sum(field=v)", "Min(field=v)",
               "Max(field=v)"]
    for q in queries:
        assert dev.execute("i", q) == cpu.execute("i", q), q
    tiers = ("groupn_incremental_updates_total", "sum_incremental_updates_total",
             "minmax_incremental_updates_total")
    absorbed = {k: sum(global_stats.counter_totals(k).values()) for k in tiers}
    before = K.launch_counts()
    for k in range(12):
        col = int(rng.integers(0, 3 * SHARD_WIDTH))
        write = (f"{'Set' if k % 3 else 'Clear'}({col}, {'fgh'[k % 3]}={k % 4})" if k % 2
                 else f"Set({col}, v={int(rng.integers(-9500, 9500))})")
        cpu.execute("i", write)
        for q in queries:
            assert dev.execute("i", q) == cpu.execute("i", q), (write, q)
    after = K.launch_counts()
    for name in ("group_tile_stats_pershard", "popcount_rows", "row_popcounts", "bsi_minmax"):
        assert after[name] == before[name], name
    for k in tiers:
        assert sum(global_stats.counter_totals(k).values()) > absorbed[k], k
    h.close()


def _paging_holder(seed, s=3, t_rows=40):
    """Fields f and g (8 rows) and a tall field t (t_rows rows, row r with
    20 + r columns, so no two rows tie) over s shards."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(seed)
    h = Holder(None).open()
    idx = h.create_index("i")
    for name in ("f", "g"):
        field = idx.create_field(name)
        for row in range(8):
            cols = np.unique(rng.integers(0, s * SHARD_WIDTH, 3000, dtype=np.uint64))
            field.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    field = idx.create_field("t")
    for row in range(t_rows):
        cols = rng.choice(s * SHARD_WIDTH, 20 + row, replace=False).astype(np.uint64)
        field.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    return h


def test_paged_calls_on_card_equal_resident_and_plain(card):
    """Under a budget of two and a half row pages no stack fits: a Count,
    Row and a tall field's TopN (filtered and not), Rows and GroupBy run on
    the card from row pages (K11 over [S, 1, W] leaves, K8 once a page),
    and answer what the resident backend, the plain forms under the same
    budget and the CPU oracle answer; nothing is routed to the host."""
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.utils.stats import global_stats

    h = _paging_holder(31)
    budget = 5 * 3 * W * 4 // 2
    paged = Executor(h, backend=CUDABackend(h, max_bytes=budget))
    resident = Executor(h, backend=CUDABackend(h))
    plain = Executor(h, backend=CUDABackend(h, device="cpu", max_bytes=budget))
    cpu = Executor(h, backend=CPUBackend(h))

    def total(name):
        return sum(global_stats.counter_totals(name).values())

    routed = total("cpu_routed_total")
    queries = ["Count(Intersect(Row(f=1), Row(g=7)))", "Count(Intersect(Row(f=1), Row(g=7)))",
               "Row(f=2)", "Count(Intersect(Row(f=1), Row(g=2), Row(t=3)))",
               "TopN(t)", "TopN(t, Row(f=1), n=5)", "Rows(t)", "GroupBy(Rows(t))"]
    for q in queries:
        uploads = total("hbm_page_uploads_total")
        K.reset_launch_counts()
        got = paged.execute("i", q)
        launched = K.launch_counts()
        if q == "TopN(t)":
            assert launched["row_popcounts"] == 5  # 40 rows, 8-row pages
        elif q.startswith("Count") or q.startswith("Row("):
            assert launched["spec_eval"] == 1, q
        for other in (resident, plain, cpu):
            want = other.execute("i", q)
            if q.startswith("Row("):
                np.testing.assert_array_equal(got[0].columns(), want[0].columns())
            else:
                assert got == want, q
        if q in queries[2:5]:
            assert total("hbm_page_uploads_total") > uploads, q
    assert paged.backend.blocks.resident_bytes() <= budget
    assert total("cpu_routed_total") == routed
    h.close()


@pytest.mark.parametrize("q", [1, 8, 64])
def test_spec_eval_page_leaf_beside_a_stack_leaf(card, q):
    """K11 over one window naming a [S, 1, W] row page and an [S, 8, W]
    stack: a leaf's shard stride is its own height, so both read their
    shards' rows; equal to the plain form in both modes."""
    rng = np.random.default_rng(300 + q)
    page, stack = _words(rng, 3, 1, W), _words(rng, 3, 8, W)
    ops = K.spec_program(("I", (("R", "t"), ("R", "g")))).ops
    rows = [[0, int(rng.integers(0, 8))] for _ in range(q)]
    dev = [stack_from_reference(x, card) for x in (page, stack)]
    cpu = [stack_from_reference(x, "cpu") for x in (page, stack)]
    for mode in ("count", "slab"):
        got = K.spec_eval(ops, dev, rows, mode)
        assert torch.equal(got.cpu(), K.spec_eval_torch(ops, cpu, rows, mode)), mode


def test_page_evicted_while_a_window_names_it(card):
    """8 threads send count windows over a paged field under a budget of
    two row pages: a page is evicted from the cache while another thread's
    window, which holds it, is in flight. Every answer is the CPU
    oracle's."""
    import threading

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.pql import parse_string

    h = _paging_holder(47)
    be = CUDABackend(h, max_bytes=2 * 3 * W * 4)
    cpu = Executor(h, backend=CPUBackend(h))
    qs = [f"Intersect(Row(t={a}), Row(f={b}))" for a in range(0, 40, 3) for b in (1, 5)]
    want = {q: cpu.execute("i", f"Count({q})")[0] for q in qs}
    calls = {q: parse_string(q).calls[0] for q in qs}
    errors = []

    def worker(k):
        try:
            for j in range(12):
                window = [qs[(k * 5 + j * 3 + i) % len(qs)] for i in range(3)]
                got = be.count_batch("i", [calls[q] for q in window], [0, 1, 2])
                if got != [want[q] for q in window]:
                    errors.append((k, j, window))
        except Exception as e:  # noqa: BLE001 - reported by the assert
            errors.append((k, repr(e)))

    evictions = be.blocks.evictions
    pool = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    assert errors == []
    assert be.blocks.evictions > evictions
    assert be.blocks.resident_bytes() <= 2 * 3 * W * 4
    h.close()


def _planes_holder(seed, s=3):
    """Fields f, g and h (8, 12 and 4 rows: stacks of 8, 16 and 8) and an int
    field v over s shards. Row r holds 3000 + 7 r columns, so no two rows of
    a field tie and TopN's order is the CPU oracle's."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.field import options_for_int
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(seed)
    h = Holder(None).open()
    idx = h.create_index("i")
    for name, rows in (("f", 8), ("g", 12), ("h", 4)):
        field = idx.create_field(name)
        for row in range(rows):
            cols = rng.choice(s * SHARD_WIDTH, 3000 + 7 * row, replace=False)
            field.import_bits(np.full(cols.size, row, dtype=np.uint64),
                              cols.astype(np.uint64))
    cols = np.unique(rng.integers(0, s * SHARD_WIDTH, 2000, dtype=np.uint64))
    idx.create_field("v", options_for_int(-500, 500)).import_value(
        cols, rng.integers(-500, 501, cols.size))
    return h


#: A Count, Row, the pair request, TopN, Sum, Min, a BSI condition and a
#: 3-field GroupBy, and the kernels each launches once on a cold backend.
PLANE_QUERIES = [
    ("Count(Intersect(Row(f=1), Row(g=7)))", {"count": 1}, {"spec_eval": 1}),
    ("Row(f=2)", {"vec": 1}, {"spec_eval": 1}),
    (" ".join(f"Count(Intersect(Row(f={a}), Row(g={b})))" for a in range(4) for b in range(4)),
     {"pair_stats": 1}, {"pair_stats_pershard": 1}),
    ("TopN(f, n=3)", {"topn": 1}, {"row_popcounts": 1}),
    ("Sum(field=v)", {"bsi_sum": 1}, {"row_popcounts": 1, "popcount_rows": 1}),
    ("Min(field=v)", {"bsi_min": 1}, {"bsi_minmax": 1}),
    ("Count(Row(v > 100))", {"count": 1}, {"bsi_compare": 1, "spec_eval": 1}),
    ("GroupBy(Rows(f), Rows(g), Rows(h))", {"groupby": 1, "group_tile_pershard": 1},
     {"popcount_rows": 1, "group_tile_stats_pershard": 1}),
]


def test_ledger_launches_equal_the_kernel_launches(card):
    """Each request's ledger launches by kind equal device_launches_total's
    increase, and the kernels those launches made equal the increase of
    ops.kernels.launch_counts(); the answers are the CPU oracle's; the
    ledger records no recompile."""
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.utils.stats import global_stats

    h = _planes_holder(21)
    be = CUDABackend(h)
    dev, cpu = Executor(h, backend=be), Executor(h, backend=CPUBackend(h))

    def ledger_by_kind():
        out = {}
        for e in be.programs.ledger():
            out[e["kind"]] = out.get(e["kind"], 0) + e["launches"]
        return out

    for q, kinds, kernels in PLANE_QUERIES:
        led0, k0 = ledger_by_kind(), K.launch_counts()
        c0 = global_stats.counter_totals("device_launches_total")
        assert dev.execute("i", q) == cpu.execute("i", q), q
        torch.cuda.synchronize()
        led = {k: v - led0.get(k, 0) for k, v in ledger_by_kind().items()
               if v != led0.get(k, 0)}
        ctr = {s.split('kind="')[1].rstrip('"}'): v - c0.get(s, 0.0)
               for s, v in global_stats.counter_totals("device_launches_total").items()
               if v != c0.get(s, 0.0)}
        made = {k: v - k0[k] for k, v in K.launch_counts().items() if v != k0[k]}
        assert led == ctr == kinds, q
        assert made == kernels, q
    counts = be.programs.counts()
    assert counts["recompiles"] == 0 and counts["compiles"] <= 1
    h.close()


def test_preheat_on_card_loads_libraries_and_leaves_caches_empty(card):
    """preheat on the card: every kernel library is loaded, the stacks are
    resident, no kernel was launched, and no pair, TopN, aggregate or GroupN
    cache entry exists; the first queries then upload nothing and answer as
    the CPU oracle."""
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.ops import build

    h = _planes_holder(22)
    be = CUDABackend(h)
    k0 = K.launch_counts()
    assert be.preheat() == 4  # f, g, h and v's BSI view
    torch.cuda.synchronize()
    assert set(build._libs) == set(build.SOURCES)
    assert K.launch_counts() == k0 and be.programs.counts()["launches"] == 0
    assert be._pair_cache == {} and be._topn_cache == {}
    assert be._agg_cache == {} and be._groupn_cache == {}
    uploads = sum(e["uploads"] for e in be.blocks.ledger())
    dev, cpu = Executor(h, backend=be), Executor(h, backend=CPUBackend(h))
    for q, _, _ in PLANE_QUERIES:
        assert dev.execute("i", q) == cpu.execute("i", q), q
    assert sum(e["uploads"] for e in be.blocks.ledger()) == uploads
    h.close()


def test_refresher_beside_readers_and_a_writer_equals_unwindowed(card):
    """A refresher at a 5 ms window, 8 reader threads and a writer on one
    backend: every answer equals an unwindowed backend's over the same
    holder in the same write epoch (a reader holds the epoch for its two
    calls; the writer stops new reads and waits for those in flight), and
    no stack is rebuilt whole."""
    import threading
    import time

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils.stats import global_stats

    h = _planes_holder(23)
    win, plain = CUDABackend(h), CUDABackend(h)
    wex, pex = Executor(h, backend=win), Executor(h, backend=plain)
    queries = [PLANE_QUERIES[0][0], PLANE_QUERIES[2][0], "TopN(f, n=3)",
               "Count(Union(Row(f=3), Row(h=1)))", "GroupBy(Rows(f), Rows(g), Rows(h))"]
    for q in queries:
        assert wex.execute("i", q) == pex.execute("i", q)
    rebuilds = sum(global_stats.counter_totals("stack_full_rebuilds_total").values())
    windowed = sum(global_stats.counter_totals("stack_windowed_refresh_total").values())
    win.start_refresher(5)
    stop = threading.Event()
    errors = []
    epoch = threading.Condition()
    state = {"readers": 0, "writing": False}

    def reader(i):
        k = i
        while not stop.is_set():
            q = queries[k % len(queries)]
            k += 1
            with epoch:
                epoch.wait_for(lambda: not state["writing"])
                state["readers"] += 1
            try:
                got, want = wex.execute("i", q), pex.execute("i", q)
            finally:
                with epoch:
                    state["readers"] -= 1
                    epoch.notify_all()
            if got != want:
                errors.append(q)

    def writer():
        rng = np.random.default_rng(24)
        for k in range(60):
            # Shard 1 only: one dirty shard a stack is spliced, never
            # rebuilt, by either backend.
            col = int(rng.integers(SHARD_WIDTH, 2 * SHARD_WIDTH))
            with epoch:
                state["writing"] = True  # new reads wait: no starved writer
                epoch.wait_for(lambda: state["readers"] == 0)
                h.index("i").field("fgh"[k % 3]).set_bit(k % 4, col)
                state["writing"] = False
                epoch.notify_all()
            time.sleep(0.005)

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    w = threading.Thread(target=writer)
    w.start()
    w.join()
    stop.set()
    for t in threads:
        t.join()
    win.stop_refresher()
    assert errors == []
    assert sum(global_stats.counter_totals("stack_windowed_refresh_total").values()) > windowed
    assert sum(global_stats.counter_totals("stack_full_rebuilds_total").values()) == rebuilds
    for q in queries:
        assert wex.execute("i", q) == pex.execute("i", q)
    h.close()


# -- the cold build's expansion kernels (K12 to K14) ------------------------

SLOT = 2048


def _expand_inputs(rng, n_slots, full):
    """A chunk of n_slots container slots: array containers (positions 0,
    31 and 65535 among them) and run containers (a whole-container run, one-
    word spans, a span ending on bit 31, one inside one word, two sharing an
    edge word) on alternate slots, and a word mask with its values. With
    `full`, array containers of about 3277 positions (density 0.05) on
    every slot not a run."""
    arrays, runs = [], []
    edge_runs = [[(0, 65535)], [(0, 0), (31, 31), (32, 63), (65535, 65535)],
                 [(5, 9), (10, 10), (40, 100), (101, 4000)]]
    for slot in range(n_slots):
        if slot % 4 == 3:
            cuts = np.sort(rng.choice(65536, 2 * int(rng.integers(1, 60)), replace=False))
            spans = edge_runs[slot // 4] if slot // 4 < len(edge_runs) else \
                [(int(a), int(b)) for a, b in cuts.reshape(-1, 2)]
            runs.append((slot, np.array(spans, dtype=np.uint16)))
        elif full or slot % 4 == 0:
            n = 3277 if full else int(rng.integers(1, 4000))
            pos = np.sort(rng.choice(65536, n, replace=False)).astype(np.uint16)
            if slot == 0:
                pos = np.union1d(pos, np.array([0, 31, 65535], dtype=np.uint16))
            arrays.append((slot, pos))
    words = np.zeros(n_slots * SLOT, dtype=np.uint32)
    at = rng.choice(words.size, words.size // 5, replace=False)
    words[at] = rng.integers(1, 2**32, at.size, dtype=np.uint32)
    words[0], words[-1] = 0x80000000, 0xFFFFFFFF
    return arrays, runs, words


def _csr_tensors(entries, device):
    slots = torch.tensor([s for s, _ in entries], dtype=torch.int32, device=device)
    starts = torch.tensor(np.concatenate([[0], np.cumsum([len(d) for _, d in entries])]),
                          dtype=torch.int32, device=device)
    return slots, starts


def _u16(parts, device):
    cat = np.concatenate([p.reshape(-1) for p in parts]) if parts else np.zeros(0, np.uint16)
    return torch.from_numpy(cat.astype(np.uint16).view(np.int16)).to(device)


@pytest.mark.parametrize("n_slots,full", [(12, False), (4096, True)])
def test_expand_kernels_equal_plain_forms(card, n_slots, full):
    """K12, K13 and K14 on the card against their plain forms on the CPU,
    exactly: edge positions and spans, and a full-size chunk (2^23 words,
    4096 slots) at the bench density."""
    rng = np.random.default_rng(n_slots)
    arrays, runs, words = _expand_inputs(rng, n_slots, full)
    mask, vals, _ = _compress(words)
    bases = K.expand_words_bases(mask)
    outs = []
    for dev in (card, torch.device("cpu")):
        out = torch.zeros(n_slots * SLOT, dtype=torch.int32, device=dev)
        K.expand_positions(out, _u16([d for _, d in arrays], dev), *_csr_tensors(arrays, dev))
        K.expand_runs(out, _u16([d for _, d in runs], dev), *_csr_tensors(runs, dev))
        words_out = torch.zeros_like(out)
        K.expand_words(words_out, torch.from_numpy(mask.view(np.int32)).to(dev),
                       torch.from_numpy(vals.view(np.int32)).to(dev),
                       torch.from_numpy(bases).to(dev))
        outs.append((out.cpu(), words_out.cpu()))
    torch.cuda.synchronize()
    (kernel, kernel_words), (plain, plain_words) = outs
    assert torch.equal(kernel, plain) and torch.equal(kernel_words, plain_words)
    np.testing.assert_array_equal(kernel_words.numpy().view(np.uint32), words)


def _compress(words):
    """(mask, nonzero values, count) of a word vector of any length."""
    nz = words != 0
    mask = np.bitwise_or.reduce(
        nz.reshape(-1, 32).astype(np.uint32) << np.arange(32, dtype=np.uint32), axis=1)
    return mask.astype(np.uint32), words[nz], int(nz.sum())


def test_expand_kernels_count_their_launches(card):
    out = torch.zeros(SLOT, dtype=torch.int32, device=card)
    one = torch.tensor([0, 1], dtype=torch.int32, device=card)
    before = K.launch_counts()
    K.expand_positions(out, torch.tensor([7], dtype=torch.int16, device=card), one[:1], one)
    K.expand_runs(out, torch.tensor([3, 9], dtype=torch.int16, device=card), one[:1], one)
    K.expand_words(out, torch.zeros(64, dtype=torch.int32, device=card),
                   torch.zeros(0, dtype=torch.int32, device=card), one[:1])
    torch.cuda.synchronize()
    after = K.launch_counts()
    for name in ("expand_positions", "expand_runs", "expand_words"):
        assert after[name] == before.get(name, 0) + 1


#: A full chunk of the cold build, in words, and K14's mask words over it.
CHUNK = 1 << 23
CHUNK_MASK = CHUNK // 32
#: An out-of-range word: K14 must leave every word it does not own as it is.
SENTINEL = 0x5A5A5A5A


def _words_mask(rng, family):
    """(mask uint32[M], n) of one K14 case at a full chunk: all zero, all
    ones, mixed (random words, 30 % zero, all-ones runs of 1024 mask words
    like a broad row's bitmap containers, an all-ones span across a tile
    edge and one off the 4-word groups, zero spans across tile edges), the
    same with its values off 16-byte alignment, or a ragged end (M off the
    groups and tiles, n off the words, set bits past n)."""
    tile = K.EXPAND_WORDS_BLOCK
    if family == "zero":
        return np.zeros(CHUNK_MASK, dtype=np.uint32), CHUNK
    if family == "ones":
        return np.full(CHUNK_MASK, 0xFFFFFFFF, dtype=np.uint32), CHUNK
    mask = rng.integers(0, 2**32, CHUNK_MASK, dtype=np.uint32)
    mask[rng.random(CHUNK_MASK) < 0.3] = 0
    for start in range(0, CHUNK_MASK, 8192):
        mask[start : start + 1024] = 0xFFFFFFFF
    mask[5 * tile - 40 : 5 * tile + 24] = 0xFFFFFFFF
    mask[7 * tile - 300 : 7 * tile + 500] = 0
    mask[9 * tile + 3 : 9 * tile + 17] = 0xFFFFFFFF
    if family == "unaligned":
        mask[0] = 0b111  # three values ahead of the first all-ones run
        return mask, CHUNK
    if family == "ragged":
        m = CHUNK_MASK - 37
        mask = mask[:m].copy()
        mask[-9:] = 0xFFFFFFFF
        return mask, 32 * m - 5
    return mask, CHUNK


@pytest.mark.parametrize("family", ["zero", "ones", "mixed", "unaligned", "ragged"])
def test_expand_words_at_a_full_chunk_equals_its_plain_form(card, family):
    """K14 on a 2^23-word chunk against expand_words_torch, exactly, every
    word it does not own left as it was: all-zero, all-ones and mixed
    masks, values whose offsets sit off 16-byte alignment (and a vals
    tensor that starts 4 bytes into its storage), and a ragged end."""
    rng = np.random.default_rng(len(family))
    mask, n = _words_mask(rng, family)
    nnz = int(np.bitwise_count(mask).sum())
    vals = rng.integers(0, 2**32, nnz + 1, dtype=np.uint32).view(np.int32)
    bases = torch.from_numpy(K.expand_words_bases(mask))
    outs = []
    for dev in (card, torch.device("cpu")):
        buf = torch.full((n + 64,), SENTINEL, dtype=torch.int32, device=dev)
        v = torch.from_numpy(vals).to(dev)
        v = v[1:] if family == "unaligned" else v[:nnz]
        K.expand_words(buf[:n], torch.from_numpy(mask.view(np.int32)).to(dev), v,
                       bases.to(dev))
        outs.append(buf.cpu())
    torch.cuda.synchronize()
    kernel, plain = outs
    assert torch.equal(kernel, plain)
    assert (kernel[n:] == SENTINEL).all()
    if family == "ones":
        assert torch.equal(kernel[:n], torch.from_numpy(vals[:nnz]))


def test_expand_words_refuses_misaligned_launches(card):
    """The wrapper raises on a chunk off 16-byte alignment before any
    launch; the entry point refuses such a launch itself, and the launch
    path raises on the refusal."""
    from pilosa_tpu_torch.ops.build import library

    buf = torch.zeros(SLOT + 4, dtype=torch.int32, device=card)
    mask = torch.zeros(SLOT // 32, dtype=torch.int32, device=card)
    vals = torch.zeros(1, dtype=torch.int32, device=card)
    bases = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        K.expand_words(buf[1 : SLOT + 1], mask, vals, bases)
    with pytest.raises(RuntimeError, match="cudaError"):
        K._launch("expand_words", card, library("expand").expand_words_launch,
                  mask.data_ptr(), vals.data_ptr(), bases.data_ptr(), buf.data_ptr() + 4,
                  mask.numel(), SLOT)
    torch.cuda.synchronize()
    assert not buf.any()


def test_chunked_build_on_card_equals_the_dense_pack(card, monkeypatch):
    """A CUDABackend over a 72-shard index (a field of array containers, a
    field of run containers, and one with a bitmap and array containers a
    shard, whose chunks carry a word-mask remainder; 18.9M words a stack,
    past MIN_CHUNKED_WORDS): its stacks are built chunk by chunk at the
    full chunk size and its Counts equal the CPU oracle's; the same stacks
    built by a builder whose wire bound makes it wait on every chunk equal
    their dense packs byte for byte."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.ops import sparse
    from pilosa_tpu_torch.ops.blocks import pack_fragment
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils.stats import global_stats

    rng = np.random.default_rng(31)
    shards = 72
    h = Holder(None).open()
    idx = h.create_index("i")
    f, r, b = (idx.create_field(n) for n in "frb")
    for s in range(shards):
        base = s * SHARD_WIDTH
        cols = rng.integers(0, SHARD_WIDTH, 8 * 52_000, dtype=np.uint64) + base
        f.import_bits(rng.integers(0, 8, cols.size, dtype=np.uint64), cols)
        start = int(rng.integers(0, SHARD_WIDTH - 70_000))
        span = np.arange(start, start + int(rng.integers(1000, 60_000)), dtype=np.uint64)
        r.import_bits(np.full(span.size, s % 8, dtype=np.uint64), span + base)
        dense = np.arange(0, 65536, 2, dtype=np.uint64) + base
        b.import_bits(np.zeros(dense.size, dtype=np.uint64), dense)
        sparse_cols = rng.integers(0, SHARD_WIDTH, 3000, dtype=np.uint64) + base
        b.import_bits(np.ones(sparse_cols.size, dtype=np.uint64), sparse_cols)
        fr = r.view("standard").fragment(s)
        with fr.lock:
            fr.storage.optimize()
        assert {fr.storage.container(k).typ for k in fr.storage.keys()} == {"run"}
    dev = Executor(h, backend=CUDABackend(h))
    cpu = Executor(h, backend=CPUBackend(h))
    n0 = sum(global_stats.counter_totals("stack_sparse_uploads_total").values())
    for q in ["Count(Intersect(Row(f=1), Row(r=2)))", "Count(Union(Row(b=0), Row(f=3)))",
              "Count(Row(r=5))"]:
        assert dev.execute("i", q) == cpu.execute("i", q), q
    assert sum(global_stats.counter_totals("stack_sparse_uploads_total").values()) == n0 + 3
    monkeypatch.setattr(sparse, "MAX_PENDING_BYTES", 1)
    for name in "frb":
        frags = [idx.field(name).view("standard").fragment(s) for s in range(shards)]
        want = np.stack([pack_fragment(fr, n_rows=8) for fr in frags])
        builder = sparse.ChunkedStackBuilder(card, want.shape)
        for fr in frags:
            builder.feed_fragment(fr, 8)
        got = builder.finish().cpu().numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want)
        assert builder.chunks["container"] > 0
    h.close()


def _card_cluster(replica_n):
    """Two in-process port nodes (tests/torch_cluster_harness.py), each with
    a CUDABackend on the one card."""
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from torch_cluster_harness import PortCluster  # tests/, on pytest's path

    return PortCluster(2, replica_n=replica_n,
                       backend_factory=lambda i, holder: CUDABackend(holder))


def test_cluster_queries_on_card_nodes(card):
    """tests/test_cluster2.py's per-node device cluster on the port: each
    node answers its legs on the card, every answer equals the count from
    the data, and the launches happen on the card."""
    from pilosa_tpu_torch.exec.result import result_to_json
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    with _card_cluster(1) as c:
        c.create_index("i")
        c.create_field("i", "f")
        c.create_field("i", "g")
        for s in range(8):
            base = s * SHARD_WIDTH
            c.query(0, "i", f"Set({base + 1}, f=1) Set({base + 2}, f=1)")
            c.query(1, "i", f"Set({base + 1}, g=2)")
        before = K.launch_counts()
        for node in (0, 1):
            assert c.query(node, "i", "Count(Row(f=1))")["results"][0] == 16, node
            out = c.query(node, "i", "Count(Intersect(Row(f=1), Row(g=2)))")
            assert out["results"][0] == 8, node
            top = result_to_json(c.query(node, "i", "TopN(f, n=1)")["results"][0])
            assert top == [{"id": 1, "count": 16}], node
        out = c.query(0, "i", "Count(Row(f=1))Count(Row(g=2))Count(Xor(Row(f=1), Row(g=2)))")
        assert out["results"] == [16, 8, 8]
        torch.cuda.synchronize()
        assert K.launch_counts()["spec_eval"] > before["spec_eval"]
        for cn in c.nodes:
            assert cn.backend.device.type == "cuda"


def test_anti_entropy_heals_card_results(card):
    """Repair writes move view generations, so both nodes' card stacks
    serve the healed bit (tests/test_cluster2.py's device-backed form)."""
    from pilosa_tpu_torch.exec.result import result_to_json

    with _card_cluster(2) as c:
        c.create_index("i")
        c.create_field("i", "f")
        c.query(0, "i", "Set(1, f=3) Set(100, f=3)")
        for node in (0, 1):
            assert c.query(node, "i", "Count(Row(f=3))")["results"][0] == 2
        c[0].holder.index("i").field("f").view("standard").fragment(0).set_bit(3, 777)
        assert c.sync_all() > 0
        for node in (0, 1):
            row = result_to_json(c.query(node, "i", "Row(f=3)")["results"][0])
            assert row["columns"] == [1, 100, 777], node
            assert c.query(node, "i", "Count(Row(f=3))")["results"][0] == 3
            pinned = c[node].api.query("i", "Count(Row(f=3))", shards=[0], remote=True)
            assert pinned["results"] == [3]


#: K15 cases with 8 and 32 entries: 8 distinct targets and one written
#: twice; 32 distinct; 32 with duplicate, invalid and clipped entries.
_SPLICE_C8 = [(3 * j, 1) for j in range(8)] + [(9, 1)]
_SPLICE_C32 = [(j, 1) for j in range(32)]
_SPLICE_C32_MIXED = [((7 * j) % 47 - 3, int(j % 5 != 3)) for j in range(32)]


@pytest.mark.parametrize("entries", [
    [(0, 1)], [(2, 1), (2, 1)], [(1, 0), (3, 1)], [(-4, 1), (49, 1)],
    [(3, 1), (0, 0), (3, 1), (1, 1)], [(0, 0)],
    _SPLICE_C8[:8], _SPLICE_C8, _SPLICE_C32, _SPLICE_C32_MIXED,
], ids=["one", "duplicate", "invalid", "clipped", "mixed", "none-valid",
        "c8", "c9-duplicate", "c32", "c32-mixed"])
def test_splice_slabs_equals_its_plain_form(card, entries):
    """K15 writes a part in place exactly as its plain form does: later
    entries win, an invalid entry leaves its shard, indices clip; one
    launch carries the live pairs the host resolved, none when no entry is
    valid."""
    rng = np.random.default_rng(len(entries) + 40)
    s_local, rows = 40, 8
    block = rng.integers(0, 2**32, (s_local, rows, W), dtype=np.uint32).view(np.int32)
    slabs = rng.integers(0, 2**32, (len(entries), rows, W), dtype=np.uint32).view(np.int32)
    idx = np.array([e[0] for e in entries], dtype=np.int32)
    valid = np.array([e[1] for e in entries], dtype=np.uint32)
    want = torch.from_numpy(block.copy())
    K.splice_slabs(want, torch.from_numpy(slabs), idx, valid)
    got = torch.from_numpy(block.copy()).to(card)
    before = K.launch_counts().get("splice_slabs", 0)
    K.splice_slabs(got, torch.from_numpy(slabs).to(card), idx, valid)
    torch.cuda.synchronize()
    assert K.launch_counts().get("splice_slabs", 0) == before + int(valid.any())
    assert torch.equal(got.cpu(), want)


def test_splice_slabs_refuses_overlapping_slabs(card):
    block = torch.zeros((4, 1, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="overlap"):
        K.splice_slabs(block, block[1:2], [0], [1])


def test_meshed_backend_absorbs_a_40_shard_epoch_in_two_launches(card):
    """ShardMesh([cuda:0] * 2) over 80 shards: 40 dirty shards of one part
    are spliced by ceil(40 / 32) = 2 K15 launches and one dirty shard by 1,
    no stack rebuilt whole, every answer the unmeshed backend's."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.exec.result import result_to_json
    from pilosa_tpu_torch.parallel import ShardMesh
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils.stats import global_stats

    shards, rng = 80, np.random.default_rng(21)
    h = Holder(None).open()
    field = h.create_index("i").create_field("f")
    cols = np.unique(rng.integers(0, shards * SHARD_WIDTH, 20000, dtype=np.uint64))
    field.import_bits(rng.integers(0, 4, cols.size, dtype=np.uint64), cols)
    meshed = Executor(h, backend=CUDABackend(h, mesh=ShardMesh([torch.device("cuda", 0)] * 2)))
    one = Executor(h, backend=CUDABackend(h))
    queries = ["Count(Row(f=1))", "Row(f=2)", "Count(Union(Row(f=1), Row(f=3)))",
               "TopN(f, n=2)"]

    def same(what):
        for q in queries:
            got = [result_to_json(r) for r in meshed.execute("i", q)]
            assert got == [result_to_json(r) for r in one.execute("i", q)], (what, q)

    same("cold")
    try:
        for cols_set, launches in (([s * SHARD_WIDTH + 3 * s + 1 for s in range(40)], 2),
                                   ([45 * SHARD_WIDTH + 17], 1)):
            rebuilds = sum(global_stats.counter_totals("stack_full_rebuilds_total").values())
            k15 = K.launch_counts().get("splice_slabs", 0)
            for col in cols_set:
                meshed.execute("i", f"Set({col}, f=1)")
            same(f"{len(cols_set)} dirty shards")
            assert K.launch_counts()["splice_slabs"] - k15 == launches
            assert sum(global_stats.counter_totals(
                "stack_full_rebuilds_total").values()) == rebuilds
    finally:
        h.close()


def test_meshed_backend_on_one_card_equals_unmeshed(card):
    """A CUDABackend over ShardMesh([cuda:0] * 2) (5 shards padded to 6,
    two parts on the one card) answers Counts, Row, TopN, Sum, Min, Max,
    a BSI condition and 1- to 3-field GroupBys as the unmeshed backend
    does, across write epochs that its stacks absorb by K15 splices."""
    _meshed_equals_unmeshed([torch.device("cuda", 0)] * 2)


def test_meshed_paged_backend_on_one_card_equals_unmeshed(card):
    """The same mesh under a byte budget of two and a half padded row
    pages: its Counts, Rows and TopNs read padded row pages, psum'd per
    page, and answer as the unmeshed backend with no budget does."""
    _meshed_equals_unmeshed([torch.device("cuda", 0)] * 2, paged=True)


def test_meshed_backend_over_distinct_cards_equals_unmeshed(card):
    """The same over every visible card, one part a card (the merges copy
    between cards); needs two cards or more."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards or more")
    _meshed_equals_unmeshed([torch.device("cuda", i) for i in range(n)])


def _meshed_equals_unmeshed(devices, paged=False):
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.field import options_for_int
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.exec.result import result_to_json
    from pilosa_tpu_torch.parallel import ShardMesh, Sharded
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils.stats import global_stats

    rng = np.random.default_rng(20)
    shards = 5
    h = Holder(None).open()
    idx = h.create_index("i")
    for name, rows in (("f", 8), ("g", 4), ("hh", 2)):
        field = idx.create_field(name)
        cols = np.unique(rng.integers(0, shards * SHARD_WIDTH, 20000, dtype=np.uint64))
        field.import_bits(rng.integers(0, rows, cols.size, dtype=np.uint64), cols)
        idx.existence_field().import_bits(np.zeros(cols.size, dtype=np.uint64), cols)
    idx.create_field("v", options_for_int(-500, 500))
    cols = np.unique(rng.integers(0, shards * SHARD_WIDTH, 3000, dtype=np.uint64))
    idx.field("v").import_value(cols, rng.integers(-500, 501, cols.size))
    s_pad = -(-shards // len(devices)) * len(devices)
    page = s_pad * 32768 * 4
    meshed = CUDABackend(h, mesh=ShardMesh(devices),
                         max_bytes=2 * page + page // 2 if paged else None)
    mesh_ex = Executor(h, backend=meshed)
    uploads = sum(global_stats.counter_totals("hbm_page_uploads_total").values())
    one = Executor(h, backend=CUDABackend(h))
    queries = ["Count(Intersect(Row(f=1), Row(g=2)))", "Count(Not(Row(f=3)))", "Row(f=2)",
               "Count(Union(Row(f=1), Row(f=2), Row(hh=1)))", "TopN(f, n=3)",
               "TopN(f, Row(g=1), n=2)", "Sum(field=v)", "Min(field=v)", "Max(field=v)",
               "Count(Row(v > 100))", "GroupBy(Rows(f))", "GroupBy(Rows(f), Rows(g))",
               "GroupBy(Rows(f), Rows(g), Rows(hh))",
               " ".join(f"Count(Intersect(Row(f={a}), Row(g={b})))"
                        for a in range(3) for b in range(3))]

    def same(what):
        for q in queries:
            got = [result_to_json(r) for r in mesh_ex.execute("i", q)]
            assert got == [result_to_json(r) for r in one.execute("i", q)], (what, q)

    same("cold")
    assert all(isinstance(e[1], Sharded) and e[1].shape[0] == s_pad
               and [p.device for p in e[1].parts] == list(devices)
               for e in meshed.blocks._entries.values())
    if paged:
        assert sum(global_stats.counter_totals("hbm_page_uploads_total").values()) > uploads
        h.close()
        return
    rebuilds = sum(global_stats.counter_totals("stack_full_rebuilds_total").values())
    k15 = K.launch_counts().get("splice_slabs", 0)
    for k in range(3):
        col = int(rng.integers(0, shards * SHARD_WIDTH))
        mesh_ex.execute("i", f"{'Set' if k % 2 == 0 else 'Clear'}({col}, f={k % 8})")
        mesh_ex.execute("i", f"Set({col + 1}, v={100 + k})")
        same(f"epoch {k}")
    assert K.launch_counts()["splice_slabs"] > k15
    assert sum(global_stats.counter_totals("stack_full_rebuilds_total").values()) == rebuilds
    h.close()


def _trace_index(shards=5):
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(22)
    h = Holder(None).open()
    idx = h.create_index("i")
    for name, rows in (("f", 4), ("g", 4)):
        cols = np.unique(rng.integers(0, shards * SHARD_WIDTH, 20000, dtype=np.uint64))
        idx.create_field(name).import_bits(rng.integers(0, rows, cols.size, dtype=np.uint64),
                                           cols)
    return h


def _is_k11(name):
    return "spec_slot_kernel" in name or "spec_window_kernel" in name


def _traced_counts(ex, device, n_threads=2, seconds=1.0):
    """A trace_window over Counts sent from n_threads threads: (trace,
    the threads' native ids)."""
    import threading

    from pilosa_tpu_torch.utils import devtrace

    ex.execute("i", "Count(Intersect(Row(f=1), Row(g=2)))")  # resident stacks
    stop = threading.Event()
    tids = [None] * n_threads

    def counts(i):
        tids[i] = threading.get_native_id()
        while not stop.is_set():
            ex.execute("i", f"Count(Intersect(Row(f={i % 4}), Row(g={(i + 1) % 4})))")

    threads = [threading.Thread(target=counts, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    try:
        trace = devtrace.trace_window(seconds, [device])
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return trace, tids


def test_device_trace_holds_each_counts_k11_kernels(card):
    """A trace over Counts from two threads: each thread's pilosa.count
    ranges hold that thread's launch calls, most of them a K11 kernel
    (spec_slot_kernel or spec_window_kernel), each kernel starting after
    its launch call; the trace's K11 kernels against device_launches_total
    in the window (a shortfall is reported, not hidden)."""
    import warnings

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.utils import devtrace

    h = _trace_index()
    try:
        trace, tids = _traced_counts(Executor(h, backend=CUDABackend(h)), card)
    finally:
        h.close()
    meta = trace["pilosaTrace"]
    k11 = [e for e in trace["traceEvents"] if e.get("cat") == "kernel" and _is_k11(e["name"])]
    assert meta["deviceLaunches"] > 0 and k11
    if len(k11) < meta["deviceLaunches"]:
        warnings.warn(f"the trace holds {len(k11)} K11 kernels of "
                      f"{meta['deviceLaunches']} launches in the window")
    ranges = devtrace.range_kernels(trace, "pilosa.count")
    assert {r["tid"] for r, _, _ in ranges} == set(tids)
    with_kernel = 0
    for r, calls, kernels in ranges:
        for c, k in zip(calls, kernels):
            assert k["ts"] >= c["ts"]
        with_kernel += any(_is_k11(k["name"]) for k in kernels)
    assert with_kernel > 0.5 * len(ranges), (with_kernel, len(ranges))


def test_device_trace_of_a_mesh_on_one_card_has_part_ranges(card):
    """A 2-part mesh on one card: each Count's launch opens pilosa.part.0
    and pilosa.part.1, and each part's range holds its K11 kernel."""
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.parallel import ShardMesh
    from pilosa_tpu_torch.utils import devtrace

    h = _trace_index()
    try:
        be = CUDABackend(h, mesh=ShardMesh([torch.device("cuda", 0)] * 2))
        trace, _ = _traced_counts(Executor(h, backend=be), card, n_threads=1, seconds=0.5)
    finally:
        h.close()
    for d in (0, 1):
        parts = devtrace.range_kernels(trace, f"pilosa.part.{d}")
        assert parts
        assert sum(any(_is_k11(k["name"]) for k in ks)
                   for _, _, ks in parts) > 0.5 * len(parts)
