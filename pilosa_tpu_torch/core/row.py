"""Row — a query-result bitmap spanning shards (reference row.go).

The reference keeps per-shard rowSegments holding roaring bitmaps in
absolute column space (reference row.go:27,332). Here a Row maps
shard -> roaring.Bitmap with *shard-relative* positions (0..SHARD_WIDTH),
which is both simpler and exactly the layout the TPU dense blocks use;
absolute columns are materialized only at result-serialization time.

Lazy columns-array representation (ISSUE r14 tentpole 1): the device
readback path produces ONE sorted uint64 absolute-column array for the
whole result slab (ops/blocks.py unpack_slab_columns), and the dominant
consumers — serialization (columns()), Count — never need roaring
containers at all. A Row built with `from_columns` therefore holds just
that array; the per-shard segment map materializes lazily (vectorized
shard split + Bitmap.from_sorted_array, no per-element adds) only when
a set-algebra caller actually asks for it. The two representations are
differential-tested against each other (tests/test_fastjson.py row
oracle suite).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from pilosa_tpu_torch.roaring import Bitmap
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

_EMPTY_COLS = np.empty(0, dtype=np.uint64)


class Row:
    __slots__ = ("segments", "attrs", "keys", "_cols")

    def __init__(self, columns: Optional[Iterable[int]] = None):
        # shard -> Bitmap of shard-relative positions; None while the
        # Row is backed only by the lazy columns array (_cols).
        self.segments: Optional[dict[int, Bitmap]] = {}
        self.attrs: dict = {}
        self.keys: list[str] = []
        # Sorted-unique absolute columns; None until computed. Kept in
        # sync with segments: mutating merges invalidate it.
        self._cols: Optional[np.ndarray] = None
        if columns is not None:
            cols = np.asarray(
                list(columns) if not isinstance(columns, np.ndarray) else columns,
                dtype=np.uint64,
            )
            if cols.size:
                self.segments = None
                self._cols = np.unique(cols)

    @staticmethod
    def from_segment(shard: int, bitmap: Bitmap) -> "Row":
        r = Row()
        if bitmap.any():
            r.segments[shard] = bitmap
        return r

    @staticmethod
    def from_columns(cols: np.ndarray) -> "Row":
        """Row backed by a SORTED-UNIQUE uint64 absolute-column array
        (ownership transfers: the array must not be mutated after).
        Serialization and Count read the array directly; roaring
        segments materialize only if set algebra asks."""
        r = Row()
        if cols.size:
            r.segments = None
            r._cols = cols
        return r

    # -- representation plumbing ------------------------------------------

    def _segs(self) -> dict[int, Bitmap]:
        """The per-shard segment map, materializing from the lazy
        columns array on first set-algebra/bitmap access. Vectorized:
        one shard-boundary split over the sorted array, one bulk
        Bitmap.from_sorted_array per shard."""
        if self.segments is None:
            cols = self._cols
            segs: dict[int, Bitmap] = {}
            shards = cols // np.uint64(SHARD_WIDTH)
            bounds = np.nonzero(np.diff(shards))[0] + 1
            starts = np.concatenate(([0], bounds))
            ends = np.concatenate((bounds, [cols.size]))
            for s, e in zip(starts, ends):
                shard = int(shards[s])
                segs[shard] = Bitmap.from_sorted_array(
                    cols[s:e] - np.uint64(shard) * np.uint64(SHARD_WIDTH)
                )
            self.segments = segs
        return self.segments

    # -- set algebra (segment-wise; reference row.go:107-217) -------------

    def _binary(self, other: "Row", fn, keys) -> "Row":
        out = Row()
        empty = Bitmap()
        a_segs, b_segs = self._segs(), other._segs()
        for shard in keys:
            a = a_segs.get(shard, empty)
            b = b_segs.get(shard, empty)
            c = fn(a, b)
            if c.any():
                out.segments[shard] = c
        return out

    def intersect(self, other: "Row") -> "Row":
        return self._binary(
            other, Bitmap.intersect,
            self._segs().keys() & other._segs().keys(),
        )

    def union(self, other: "Row") -> "Row":
        return self._binary(
            other, Bitmap.union, self._segs().keys() | other._segs().keys()
        )

    def difference(self, other: "Row") -> "Row":
        return self._binary(other, Bitmap.difference, self._segs().keys())

    def xor(self, other: "Row") -> "Row":
        return self._binary(
            other, Bitmap.xor, self._segs().keys() | other._segs().keys()
        )

    def shift(self) -> "Row":
        # Shift within each shard; Pilosa's Shift does not carry across
        # shards either (reference row.go Shift -> segment-wise shift).
        out = Row()
        for shard, seg in self._segs().items():
            shifted = seg.shift()
            # Drop any bit shifted past the shard width.
            if shifted.max() >= SHARD_WIDTH:
                shifted.remove(SHARD_WIDTH, log=False)
            if shifted.any():
                out.segments[shard] = shifted
        return out

    def intersection_count(self, other: "Row") -> int:
        a_segs, b_segs = self._segs(), other._segs()
        return sum(
            a_segs[s].intersection_count(b_segs[s])
            for s in a_segs.keys() & b_segs.keys()
        )

    def count(self) -> int:
        if self.segments is None:
            return int(self._cols.size)
        return sum(b.count() for b in self.segments.values())

    def any(self) -> bool:
        if self.segments is None:
            return self._cols.size > 0
        return any(b.any() for b in self.segments.values())

    def includes_column(self, col: int) -> bool:
        if self.segments is None:
            # Sorted-array membership probe: no need to materialize.
            i = int(np.searchsorted(self._cols, np.uint64(col)))
            return i < self._cols.size and int(self._cols[i]) == col
        shard = col // SHARD_WIDTH
        seg = self.segments.get(shard)
        return seg is not None and seg.contains(col % SHARD_WIDTH)

    def columns(self) -> np.ndarray:
        """All absolute column IDs, sorted ascending. Cached: the array
        is shared with callers (and the result cache) — treat it as
        immutable."""
        if self._cols is not None:
            return self._cols
        parts = []
        for shard in sorted(self.segments):
            seg = self.segments[shard]
            parts.append(seg.to_array() + np.uint64(shard * SHARD_WIDTH))
        self._cols = (
            np.concatenate(parts) if parts else _EMPTY_COLS
        )
        return self._cols

    def shard_bitmap(self, shard: int) -> Bitmap:
        return self._segs().get(shard, Bitmap())

    def merge(self, other: "Row") -> None:
        """Absorb other's segments (used by the executor's reduce step,
        reference row.go Merge :67)."""
        segs = self._segs()
        for shard, seg in other._segs().items():
            mine = segs.get(shard)
            if mine is None:
                segs[shard] = seg
            else:
                segs[shard] = mine.union(seg)
        self._cols = None  # cached columns are stale after a merge

    def __eq__(self, other) -> bool:
        if not isinstance(other, Row):
            return NotImplemented
        return np.array_equal(self.columns(), other.columns())

    def __repr__(self) -> str:
        return f"Row(count={self.count()}, shards={sorted(self._segs())})"
