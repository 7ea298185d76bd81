"""The port's dense stack layout (pilosa_tpu_torch/ops/blocks.py) is byte
for byte the JAX package's: the same fragment content packs to identical
uint32[R_pad, W] words through both, for array, run and bitmap
containers, and the carry helpers move those words to int32 tensors and
back unchanged."""

import numpy as np
import pytest
import torch

from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu.ops import blocks as jax_blocks
from pilosa_tpu_torch.carry import stack_from_reference, stack_to_reference
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.ops import blocks
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


def _content(seed):
    """(rows, cols) holding all three container kinds once optimized:
    sparse random bits (array), long contiguous ranges (run) and a dense
    random half of a container (bitmap). Row 10 pads the stack to 16."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []

    def add(row, c):
        c = np.unique(np.asarray(c, dtype=np.uint64))
        rows.append(np.full(c.size, row, dtype=np.uint64))
        cols.append(c)

    add(0, rng.integers(0, SHARD_WIDTH, 3000))
    add(1, np.r_[np.arange(5, 40_000), np.arange(70_000, 200_000)])
    add(2, np.flatnonzero(rng.random(1 << 16) < 0.5) + (3 << 16))
    add(5, rng.integers(0, SHARD_WIDTH, 50))
    add(10, [0, 1, SHARD_WIDTH - 1])
    return np.concatenate(rows), np.concatenate(cols)


def _pair_of_fragments(seed):
    rows, cols = _content(seed)
    ours = Fragment(None, "i", "f", "standard", 0)
    ref = JaxFragment(None, "i", "f", "standard", 0)
    for fr in (ours, ref):
        fr.bulk_import(rows, cols)
        fr.storage.optimize()
    return ours, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_fragment_is_byte_identical(seed):
    ours, ref = _pair_of_fragments(seed)
    kinds = {ours.storage.container(k).typ for k in ours.storage.keys()}
    assert kinds == {"array", "run", "bitmap"}
    got = blocks.pack_fragment(ours)
    want = jax_blocks.pack_fragment(ref)
    assert got.dtype == want.dtype == np.uint32
    assert got.shape == want.shape == (16, blocks.WORDS_PER_SHARD)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n_rows", [1, 3, 9, 24])
def test_pack_fragment_row_targets_match(n_rows):
    ours, ref = _pair_of_fragments(2)
    got = blocks.pack_fragment(ours, n_rows=n_rows)
    want = jax_blocks.pack_fragment(ref, n_rows=n_rows)
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_unpack_matches_reference():
    ours, _ = _pair_of_fragments(3)
    packed = blocks.pack_fragment(ours)
    for r in range(packed.shape[0]):
        np.testing.assert_array_equal(
            blocks.unpack_row(packed[r]), jax_blocks.unpack_row(packed[r])
        )
        np.testing.assert_array_equal(
            blocks.unpack_row(packed[r]), ours.row(r).columns()
        )
    bases = np.arange(packed.shape[0], dtype=np.uint64) * np.uint64(SHARD_WIDTH)
    np.testing.assert_array_equal(
        blocks.unpack_slab_columns(packed, bases),
        jax_blocks.unpack_slab_columns(packed, bases),
    )


def test_carry_round_trip_keeps_the_bits():
    ours, _ = _pair_of_fragments(4)
    stack = np.stack([blocks.pack_fragment(ours)] * 2)
    t = stack_from_reference(stack, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == stack.shape
    back = stack_to_reference(t)
    assert back.dtype == np.uint32 and back.tobytes() == stack.tobytes()
    with pytest.raises(TypeError):
        stack_to_reference(t.to(torch.int64))
