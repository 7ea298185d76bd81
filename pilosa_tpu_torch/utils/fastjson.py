"""Zero-copy JSON result encoding.

The serving path used to pay three Python hot loops between device
readback and socket write: `Row.columns().tolist()` (one PyLong boxed
per column), the `[int(v) ...]` re-boxing in the encoders, and
`json.dumps` walking the resulting object graph one element at a time.
This module replaces that chain for the KNOWN response envelopes
(columns / count / TopN pairs / GroupBy / ValCount / Rows) with
numpy-vectorized integer-array-to-ASCII encoding spliced into template
byte fragments — the same move the Roaring reference library makes for
container decode (word-level bulk ops instead of per-element loops,
"Roaring Bitmaps: Implementation of an Optimized Software Library",
PAPERS.md), applied to serialization.

BYTE-COMPAT CONTRACT: every function here emits bytes identical to what
`json.dumps` produced for the same value under the previous encoders
(default separators `", "` / `": "`, `ensure_ascii=True`). The
differential suite in tests/test_fastjson.py pins this across every
response shape; anything not covered by a fast path falls back to
`json.dumps` itself, so the contract can never drift for shapes this
module does not understand.
"""

from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np

#: Powers of ten covering the uint64 range (10^19 < 2^64 < 10^20).
_POW10 = np.array([10 ** k for k in range(20)], dtype=np.uint64)

#: Two-decimal-digit lookup table: value v in [0, 100) -> its two ASCII
#: digit bytes packed little-endian in a uint16 (tens digit at the low
#: byte = the lower address after a .view(np.uint8)). Halves the number
#: of vector divide passes vs digit-at-a-time peeling.
_LUT100 = np.array(
    [(0x30 + i // 10) | ((0x30 + i % 10) << 8) for i in range(100)],
    dtype=np.uint16,
)


def encode_uints(a: np.ndarray) -> bytes:
    """Non-negative integer array -> ASCII b"1, 2, 3" (no brackets),
    byte-identical to ", ".join(str(int(v))...). Vectorized: every value
    renders fixed-width (two digits per divide pass via the _LUT100
    table), then one row-major boolean selection strips the leading
    zeros and splices the ", " separators — no PyLong boxing, no
    per-element str()."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    n = a.size
    if n == 0:
        return b""
    # Decimal width per value = #{k : 10^k <= v}, floor 1 for v=0.
    nd = np.maximum(np.searchsorted(_POW10, a, side="right"), 1)
    # Values < 10^10 render through signed-int64 divides (measurably
    # faster than uint64 on this numpy); the full-range path is the
    # same loop at width 20.
    wide = int(a.max()) >= 10 ** 10
    wmax = 20 if wide else 10
    half = wmax // 2
    mat16 = np.empty((n, half), dtype=np.uint16)
    if wide:
        d = a.copy()
        hundred = np.uint64(100)
        for j in range(half - 1, -1, -1):
            q = d // hundred
            mat16[:, j] = _LUT100[(d - q * hundred).astype(np.int64)]
            d = q
    else:
        d = a.astype(np.int64)
        for j in range(half - 1, -1, -1):
            q = d // 100
            mat16[:, j] = _LUT100[d - q * 100]
            d = q
    mat = np.empty((n, wmax + 2), dtype=np.uint8)
    mat[:, :wmax] = mat16.view(np.uint8).reshape(n, wmax)
    mat[:, wmax] = 0x2C  # ","
    mat[:, wmax + 1] = 0x20  # " "
    # Keep the last nd digits of each row plus the separator pair; the
    # boolean selection is row-major, so per-value byte order holds.
    mask = np.arange(wmax + 2)[None, :] >= (wmax - nd)[:, None]
    return mat[mask].tobytes()[:-2]


def encode_varints(a: np.ndarray) -> bytes:
    """uint64 array -> concatenated protobuf (LEB128) varints, byte-
    identical to b"".join(_encode_varint(int(v))...). Builds an [n, 10]
    byte matrix (10 = max varint width) with vectorized shifts, sets
    continuation bits, and selects the valid bytes row-major — per-value
    byte order is preserved by the boolean selection."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    if a.size == 0:
        return b""
    nb = np.ones(a.size, dtype=np.int64)
    for k in range(1, 10):
        nb += a >= np.uint64(1 << (7 * k))
    mat = np.empty((a.size, 10), dtype=np.uint8)
    for j in range(10):
        mat[:, j] = ((a >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(
            np.uint8
        )
    cols = np.arange(10)
    mat |= (cols < (nb - 1)[:, None]).astype(np.uint8) << 7
    return mat[cols < nb[:, None]].tobytes()


def dumps(obj: Any) -> bytes:
    """Generic object -> JSON bytes, byte-identical to json.dumps(obj).
    The fallback for envelopes without a template (error bodies, debug
    payloads); keeps every reply on one encoder contract."""
    return json.dumps(obj).encode()


def _string(s: str) -> bytes:
    # json.dumps handles the escaping table (incl. \uXXXX for
    # non-ASCII under the default ensure_ascii) — one small string, not
    # a per-element loop.
    return json.dumps(s).encode()


def _string_list(ss) -> bytes:
    return b"[" + b", ".join(_string(s) for s in ss) + b"]"


def _pair(p) -> bytes:
    if p.key:
        return b'{"key": ' + _string(p.key) + b', "count": %d}' % p.count
    return b'{"id": %d, "count": %d}' % (p.id, p.count)


def _row(r, exclude_columns: bool) -> bytes:
    # Mirrors server/api.py _encode_result's Row envelope: attrs first,
    # then keys (translated) OR the columns array.
    out = b'{"attrs": ' + dumps(r.attrs or {})
    if r.keys:
        out += b', "keys": ' + _string_list(r.keys)
    elif not exclude_columns:
        out += b', "columns": [' + encode_uints(r.columns()) + b"]"
    else:
        out += b', "columns": []'
    return out + b"}"


def _group_count(gc) -> bytes:
    rows = []
    for fr in gc.group:
        if fr.row_key:
            rows.append(
                b'{"field": ' + _string(fr.field) + b', "rowKey": '
                + _string(fr.row_key) + b"}"
            )
        else:
            rows.append(
                b'{"field": ' + _string(fr.field)
                + b', "rowID": %d}' % fr.row_id
            )
    return b'{"group": [' + b", ".join(rows) + b'], "count": %d}' % gc.count


def encode_result(r: Any, exclude_columns: bool = False) -> bytes:
    """One executor result -> its JSON fragment, byte-identical to
    json.dumps(server/api.py _encode_result(r, exclude_columns))."""
    from pilosa_tpu_torch.core.row import Row
    from pilosa_tpu_torch.exec.result import (
        GroupCount,
        PairField,
        PairsField,
        RowIDs,
        ValCount,
    )

    if r is None:
        return b"null"
    if isinstance(r, Row):
        return _row(r, exclude_columns)
    if isinstance(r, bool):
        return b"true" if r else b"false"
    if isinstance(r, int):
        return b"%d" % r
    if isinstance(r, ValCount):
        return b'{"value": %d, "count": %d}' % (r.val, r.count)
    if isinstance(r, PairsField):
        return b"[" + b", ".join(_pair(p) for p in r.pairs) + b"]"
    if isinstance(r, PairField):
        return _pair(r.pair)
    if isinstance(r, RowIDs):
        if r.keys is not None:
            return b'{"keys": ' + _string_list(r.keys) + b"}"
        if not r:
            return b'{"rows": []}'
        return (
            b'{"rows": ['
            + encode_uints(np.asarray(list(r), dtype=np.uint64))
            + b"]}"
        )
    if isinstance(r, GroupCount):
        return _group_count(r)
    from pilosa_tpu_torch.exec.result import result_to_json

    if isinstance(r, list):
        if r and all(isinstance(v, GroupCount) for v in r):
            return b"[" + b", ".join(_group_count(gc) for gc in r) + b"]"
        # Other lists (rare) keep the legacy element encoding exactly.
        return dumps(result_to_json(r))
    # Unknown shape: the generic encoder keeps the byte contract.
    return dumps(result_to_json(r))


def response_body(
    fragments: list[bytes], attr_sets: Optional[list] = None
) -> bytes:
    """Query-response envelope (with trailing newline), byte-identical
    to json.dumps({"results": [...], "columnAttrSets": [...]}) + "\\n".
    One join over pre-encoded fragments — a wire-bytes cache hit splices
    straight in without re-encoding (exec/rescache.py)."""
    body = b'{"results": [' + b", ".join(fragments) + b"]"
    if attr_sets is not None:
        body += b', "columnAttrSets": ' + dumps(attr_sets)
    return body + b"}\n"
