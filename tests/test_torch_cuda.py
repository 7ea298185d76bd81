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
    assert counts["popcount_rows"] == 2 and counts["pair_stats_pershard"] == 1


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
        assert K.launch_counts()["popcount_rows"] == 1
        conn.request("GET", "/debug/diagnostics")
        inv = json.loads(conn.getresponse().read())["jax"]
        conn.close()
        assert inv["platform"] == "gpu" and inv["device_count"] == torch.cuda.device_count()
        assert inv["devices"][0]["kind"] == torch.cuda.get_device_name(0)
    finally:
        srv.close()
        h.close()
