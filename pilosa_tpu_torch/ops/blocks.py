"""Dense device block layout.

Layout: one fragment (view ∩ shard) becomes uint32[rows_padded, WORDS]
where WORDS = SHARD_WIDTH/32 (32768 for the default 2^20 shard width, i.e.
128 KiB per row). Rows are padded to a multiple of 8 (ROW_PAD), the
layout the JAX package uses, so stacks of the two packages compare byte
for byte; the CUDA backend holds them as int32 tensors with the same bits.

Packing walks roaring containers directly: a container key maps to
(row, word-range) and its 1024 uint64 words view as 2048 little-endian
uint32 words, so dense containers are a straight memcpy and array
containers scatter only their set bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

WORDS_PER_SHARD = SHARD_WIDTH // 32
_CONTAINERS_PER_ROW = SHARD_WIDTH >> 16
_WORDS_PER_CONTAINER = (1 << 16) // 32  # 2048

ROW_PAD = 8


def _padded_rows(n_rows: int) -> int:
    return max(((n_rows + ROW_PAD - 1) // ROW_PAD) * ROW_PAD, ROW_PAD)


def _scatter_container(row_words: np.ndarray, cidx: int, c) -> None:
    """OR one roaring container into a row's word vector at container
    slot cidx (dense containers memcpy; array containers scatter bits —
    via the native C++ loop when available, np.bitwise_or.at otherwise)."""
    base = cidx * _WORDS_PER_CONTAINER
    if c.typ == "bitmap":
        row_words[base : base + _WORDS_PER_CONTAINER] = c.data.view("<u4")
        return
    if c.typ == "run":
        # RLE containers pack via their materialized bitmap words (run
        # fills would need per-run partial-word masking for no gain —
        # packing is once per write epoch).
        row_words[base : base + _WORDS_PER_CONTAINER] = c.bitmap_words().view("<u4")
        return
    from pilosa_tpu_torch.native import scatter_positions

    data = np.ascontiguousarray(c.data, dtype=np.uint16)
    if row_words.flags.c_contiguous and scatter_positions(row_words, base, data):
        return
    pos = data.astype(np.uint32)
    np.bitwise_or.at(
        row_words,
        base + (pos >> 5),
        np.uint32(1) << (pos & np.uint32(31)),
    )


def pack_fragment(frag, n_rows: Optional[int] = None) -> np.ndarray:
    """Flatten a fragment's roaring storage into uint32[rows_p, WORDS].

    n_rows: minimum logical row count (pad target); defaults to
    frag.max_row_id + 1.
    """
    storage = frag.storage
    if n_rows is None:
        n_rows = frag.max_row_id + 1
    rows_p = _padded_rows(n_rows)
    arr = np.zeros((rows_p, WORDS_PER_SHARD), dtype=np.uint32)
    for key in storage.keys():
        c = storage.container(key)
        if c is None or c.n == 0:
            continue
        row = key // _CONTAINERS_PER_ROW
        if row >= rows_p:
            continue  # caller asked for fewer rows than stored
        _scatter_container(arr[row], key % _CONTAINERS_PER_ROW, c)
    return arr


def unpack_row(words: np.ndarray) -> np.ndarray:
    """uint32[WORDS] -> sorted shard-relative column positions."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint64)


#: Transient bit-buffer bound for unpack_slab_columns: unpackbits
#: materializes one byte per bit (8x the packed slab), so the slab is
#: processed in row blocks whose bit buffer stays under this — the
#: per-block pass is still fully vectorized, but a dense query over a
#: large resident stack can no longer allocate a GB-scale temporary
#: (code review r14; the old per-shard loop peaked at one row).
MAX_UNPACK_BITS_BYTES = 32 << 20


def unpack_slab_columns(host: np.ndarray, bases: np.ndarray) -> np.ndarray:
    """uint32[R, W] result slab + uint64[R] per-row column bases ->
    ONE sorted absolute-column uint64 array (ISSUE r14 tentpole 1).

    The whole-slab pass replaces R per-shard unpack_row calls + R
    Bitmap constructions + R Row merges with one (blocked) unpackbits,
    one flatnonzero, and one vectorized base add — the word-level bulk
    decode move from the Roaring reference library applied to device
    readback. Requires bases strictly ascending with row order and
    spaced at least one shard apart (callers sort + dedupe rows by
    shard); output is then globally sorted, ready for
    Row.from_columns."""
    host = np.ascontiguousarray(host, dtype=np.uint32)
    r_n, w = host.shape
    span = w * 32
    bases = np.asarray(bases, dtype=np.uint64)
    rows_per_block = max(1, MAX_UNPACK_BITS_BYTES // max(span, 1))
    parts = []
    for start in range(0, r_n, rows_per_block):
        block = host[start : start + rows_per_block]
        bits = np.unpackbits(
            block.view(np.uint8).reshape(-1), bitorder="little"
        )
        idx = np.flatnonzero(bits)
        if idx.size == 0:
            continue
        rows = idx // span
        pos = (idx - rows * span).astype(np.uint64)
        parts.append(bases[start + rows] + pos)
    if not parts:
        return np.empty(0, dtype=np.uint64)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)
