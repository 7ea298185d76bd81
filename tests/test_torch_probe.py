"""The kernels' restated bounds (pilosa_tpu_torch/ops/probe.py): bytes and
bit-products counted by hand, and the AND-popcount route that each set of
rates makes the bound take. The rate probe itself needs a card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import pytest

from pilosa_tpu_torch.ops import probe as P


def test_pair_work_hand_counted():
    # S=2, Rf=3, Rg=5, W=8: 15 pairs + 3 + 5 row popcounts = 23 cells a shard.
    nbytes, bits = P.pair_work(2, 3, 5, 8, pershard=False)
    assert nbytes == 4 * 2 * (3 + 5) * 8 + 4 * 23 == 604
    assert bits == 32 * 2 * 8 * 23 == 11776
    nbytes, bits = P.pair_work(2, 3, 5, 8, pershard=True)
    assert nbytes == 512 + 4 * 2 * 23 and bits == 11776


def test_group_work_hand_counted():
    # S=3, an 8 x 8 face, 4 slots reading 4 extra rows and a filter, W=16.
    nbytes, bits = P.group_work(3, 8, 8, 16, 4, 4, filtered=True, pershard=False)
    assert nbytes == 4 * 3 * 16 * (8 + 8 + 4 + 1) + 4 * 4 * 64 == 5056
    assert bits == 32 * 4 * 3 * 16 * 64 == 393216
    nbytes, _ = P.group_work(3, 8, 8, 16, 4, 4, filtered=False, pershard=True)
    assert nbytes == 4 * 3 * 16 * 20 + 4 * 4 * 3 * 64


WIDE = P.pair_work(128, 256, 256, 32768, pershard=False)  # the wide 16-Count pair


@pytest.mark.parametrize(
    "popc,b1,route,by,ms",
    [
        # The measured b1 MMA (H100, 5.3e15) is the fastest: the bytes bound.
        (4.18e12, 5.3e15, "b1", "bytes", 8590198784 / 3.35e12 * 1e3),
        # A slow b1: the published int8 rate is the fastest, and the
        # 8.86e12 bit-products outlast the bytes.
        (4.18e12, 1e14, "s8", "operations", 8864812498944 / 9.9e14 * 1e3),
        # Popcounts at 1e14 a second (3.2e15 bit-products a second) beat int8.
        (1e14, 1e13, "popc", "operations", 8864812498944 / 3.2e15 * 1e3),
    ],
)
def test_bound_takes_the_fastest_route(popc, b1, route, by, ms):
    assert WIDE == (8590198784, 8864812498944)
    rates = P.routes(popc, b1)
    assert rates == {"popc": 32 * popc, "s8": P.INT8_MACS_PER_S, "b1": b1}
    sec, got_by, got_route = P.bound(*WIDE, rates)
    assert (got_route, got_by) == (route, by)
    assert sec * 1e3 == pytest.approx(ms, rel=1e-12)


def test_probe_needs_a_card():
    with pytest.raises(ValueError, match="CUDA card"):
        P.and_popc_rates("cpu")
