"""Attribute store: id -> {name: value} maps (reference attr.go:34 AttrStore).

sqlite3-backed (the reference uses BoltDB, boltdb/attrstore.go:67) with an
in-memory LRU block cache equivalent and 100-id block checksums for
anti-entropy diffing (reference attr.go:80-120 blocks of 100 ids).
Attribute values may be string / int / bool / float (reference attr.go:26-31).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Any, Optional

from pilosa_tpu_torch.native import xxhash64

ATTR_BLOCK_SIZE = 100  # reference attr.go attrBlockSize


class AttrStore:
    """A single shared connection guarded by a lock — sqlite serializes
    fine at this layer, and per-thread ':memory:' connections would see
    separate databases (each in-memory connection is private)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.RLock()
        if path is not None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._db = sqlite3.connect(path or ":memory:", check_same_thread=False)
        with self._lock:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS attrs (id INTEGER PRIMARY KEY, data TEXT)"
            )
            self._db.commit()

    def attrs(self, id_: int) -> dict[str, Any]:
        with self._lock:
            cur = self._db.execute("SELECT data FROM attrs WHERE id=?", (id_,))
            row = cur.fetchone()
        return json.loads(row[0]) if row else {}

    def set_attrs(self, id_: int, attrs: dict[str, Any]) -> dict[str, Any]:
        """Merge attrs into the existing map; None values delete keys
        (reference attr.go SetAttrs merge semantics)."""
        with self._lock:
            cur = self.attrs(id_)
            for k, v in attrs.items():
                if v is None:
                    cur.pop(k, None)
                else:
                    cur[k] = v
            self._db.execute(
                "INSERT OR REPLACE INTO attrs (id, data) VALUES (?, ?)",
                (id_, json.dumps(cur, sort_keys=True)),
            )
            self._db.commit()
            return cur

    def set_bulk_attrs(self, attrs_by_id: dict[int, dict[str, Any]]) -> None:
        with self._lock:
            for id_, attrs in attrs_by_id.items():
                self.set_attrs(id_, attrs)

    def blocks(self) -> list[tuple[int, int]]:
        """[(block_id, checksum)] over 100-id blocks (reference attr.go Blocks)."""
        with self._lock:
            cur = self._db.execute("SELECT id, data FROM attrs ORDER BY id").fetchall()
        out: list[tuple[int, int]] = []
        h = 0
        prev_block = None
        hasher_data = bytearray()
        for id_, data in cur:
            block = id_ // ATTR_BLOCK_SIZE
            if block != prev_block:
                if prev_block is not None:
                    out.append((prev_block, xxhash64(bytes(hasher_data))))
                prev_block = block
                hasher_data = bytearray()
            hasher_data += id_.to_bytes(8, "little") + data.encode()
        if prev_block is not None:
            out.append((prev_block, xxhash64(bytes(hasher_data))))
        return out

    def block_data(self, block_id: int) -> dict[int, dict[str, Any]]:
        lo = block_id * ATTR_BLOCK_SIZE
        hi = lo + ATTR_BLOCK_SIZE
        with self._lock:
            cur = self._db.execute(
                "SELECT id, data FROM attrs WHERE id >= ? AND id < ? ORDER BY id", (lo, hi)
            ).fetchall()
        return {id_: json.loads(data) for id_, data in cur}

    def close(self) -> None:
        with self._lock:
            self._db.close()
