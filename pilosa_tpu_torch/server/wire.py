"""Minimal protobuf wire codec for the import/query messages.

Implements just the varint/length-delimited subset the reference's wire
contract needs (field numbers from reference internal/public.proto:57-122;
gogo-protobuf on the Go side). Hand-rolled instead of protoc-generated so
the framework stays dependency-light; the wire format is the compat
surface, not the codegen.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Iterator, Optional

import numpy as np

from pilosa_tpu_torch.utils.fastjson import encode_varints


def _encode_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _iter_fields(data: bytes) -> Iterator[tuple[int, int, object]]:
    """Yields (field_number, wire_type, value)."""
    pos = 0
    while pos < len(data):
        tag, pos = _decode_varint(data, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            v, pos = _decode_varint(data, pos)
            yield fnum, wtype, v
        elif wtype == 2:  # length-delimited
            ln, pos = _decode_varint(data, pos)
            yield fnum, wtype, data[pos : pos + ln]
            pos += ln
        elif wtype == 1:  # 64-bit
            yield fnum, wtype, data[pos : pos + 8]
            pos += 8
        elif wtype == 5:  # 32-bit
            yield fnum, wtype, data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")


def _repeated_uint64(value, wtype) -> list[int]:
    """Handles both packed and unpacked repeated uint64."""
    if wtype == 0:
        return [value]
    out = []
    pos = 0
    while pos < len(value):
        v, pos = _decode_varint(value, pos)
        out.append(v)
    return out


def _zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _signed(v: int) -> int:
    """int64 fields are two's-complement varints (not zigzag)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _field_str(v: bytes) -> str:
    return v.decode("utf-8")


def _encode_tag(fnum: int, wtype: int) -> bytes:
    return _encode_varint((fnum << 3) | wtype)


def _encode_string(fnum: int, s: str) -> bytes:
    b = s.encode("utf-8")
    return _encode_tag(fnum, 2) + _encode_varint(len(b)) + b


def _encode_bytes(fnum: int, b: bytes) -> bytes:
    return _encode_tag(fnum, 2) + _encode_varint(len(b)) + b


def _encode_packed_uint64(fnum: int, vals) -> bytes:
    """Packed repeated uint64. Vectorized: every
    remote shard leg's Row payload used to pay one Python varint loop
    per column; utils/fastjson.encode_varints emits identical bytes in
    a handful of numpy passes, straight from the Row columns array —
    no tolist() round trip."""
    if not len(vals):
        return b""
    body = encode_varints(np.asarray(vals, dtype=np.uint64))
    return _encode_tag(fnum, 2) + _encode_varint(len(body)) + body


def _encode_packed_int64(fnum: int, vals) -> bytes:
    """Packed repeated int64 (two's-complement varints). The uint64
    reinterpretation (& mask / .view) matches _encode_varint(v & 2^64-1)
    byte for byte."""
    if not len(vals):
        return b""
    arr = np.asarray(
        [int(v) & 0xFFFFFFFFFFFFFFFF for v in vals]
        if not isinstance(vals, np.ndarray)
        else vals.astype(np.int64).view(np.uint64),
        dtype=np.uint64,
    )
    body = encode_varints(arr)
    return _encode_tag(fnum, 2) + _encode_varint(len(body)) + body


def _encode_uint64(fnum: int, v: int) -> bytes:
    return _encode_tag(fnum, 0) + _encode_varint(v)


def _encode_bool(fnum: int, v: bool) -> bytes:
    return _encode_tag(fnum, 0) + _encode_varint(1 if v else 0)


# ---------------------------------------------------------------------------
# Messages (field numbers from reference internal/public.proto)
# ---------------------------------------------------------------------------


@dataclass
class ImportRequest:
    """reference internal/public.proto:84."""

    index: str = ""
    field: str = ""
    shard: int = 0
    row_ids: list[int] = dc_field(default_factory=list)
    column_ids: list[int] = dc_field(default_factory=list)
    row_keys: list[str] = dc_field(default_factory=list)
    column_keys: list[str] = dc_field(default_factory=list)
    timestamps: list[int] = dc_field(default_factory=list)

    def to_bytes(self) -> bytes:
        out = b""
        if self.index:
            out += _encode_string(1, self.index)
        if self.field:
            out += _encode_string(2, self.field)
        if self.shard:
            out += _encode_uint64(3, self.shard)
        out += _encode_packed_uint64(4, self.row_ids)
        out += _encode_packed_uint64(5, self.column_ids)
        out += _encode_packed_int64(6, self.timestamps)
        for k in self.row_keys:
            out += _encode_string(7, k)
        for k in self.column_keys:
            out += _encode_string(8, k)
        return out

    @staticmethod
    def from_bytes(data: bytes) -> "ImportRequest":
        m = ImportRequest()
        for fnum, wtype, v in _iter_fields(data):
            if fnum == 1:
                m.index = _field_str(v)
            elif fnum == 2:
                m.field = _field_str(v)
            elif fnum == 3:
                m.shard = v
            elif fnum == 4:
                m.row_ids.extend(_repeated_uint64(v, wtype))
            elif fnum == 5:
                m.column_ids.extend(_repeated_uint64(v, wtype))
            elif fnum == 6:
                m.timestamps.extend(_signed(x) for x in _repeated_uint64(v, wtype))
            elif fnum == 7:
                m.row_keys.append(_field_str(v))
            elif fnum == 8:
                m.column_keys.append(_field_str(v))
        return m


@dataclass
class ImportValueRequest:
    """reference internal/public.proto:95."""

    index: str = ""
    field: str = ""
    shard: int = 0
    column_ids: list[int] = dc_field(default_factory=list)
    column_keys: list[str] = dc_field(default_factory=list)
    values: list[int] = dc_field(default_factory=list)

    def to_bytes(self) -> bytes:
        out = b""
        if self.index:
            out += _encode_string(1, self.index)
        if self.field:
            out += _encode_string(2, self.field)
        if self.shard:
            out += _encode_uint64(3, self.shard)
        out += _encode_packed_uint64(5, self.column_ids)
        out += _encode_packed_int64(6, self.values)
        for k in self.column_keys:
            out += _encode_string(7, k)
        return out

    @staticmethod
    def from_bytes(data: bytes) -> "ImportValueRequest":
        m = ImportValueRequest()
        for fnum, wtype, v in _iter_fields(data):
            if fnum == 1:
                m.index = _field_str(v)
            elif fnum == 2:
                m.field = _field_str(v)
            elif fnum == 3:
                m.shard = v
            elif fnum == 5:
                m.column_ids.extend(_repeated_uint64(v, wtype))
            elif fnum == 6:
                m.values.extend(_signed(x) for x in _repeated_uint64(v, wtype))
            elif fnum == 7:
                m.column_keys.append(_field_str(v))
        return m


@dataclass
class ImportRoaringRequestView:
    name: str = ""
    data: bytes = b""


@dataclass
class ImportRoaringRequest:
    """reference internal/public.proto:119."""

    clear: bool = False
    views: list[ImportRoaringRequestView] = dc_field(default_factory=list)

    def to_bytes(self) -> bytes:
        out = b""
        if self.clear:
            out += _encode_bool(1, True)
        for v in self.views:
            body = b""
            if v.name:
                body += _encode_string(1, v.name)
            body += _encode_bytes(2, v.data)
            out += _encode_bytes(2, body)
        return out

    @staticmethod
    def from_bytes(data: bytes) -> "ImportRoaringRequest":
        m = ImportRoaringRequest()
        for fnum, wtype, v in _iter_fields(data):
            if fnum == 1:
                m.clear = bool(v)
            elif fnum == 2:
                view = ImportRoaringRequestView()
                for f2, w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        view.name = _field_str(v2)
                    elif f2 == 2:
                        view.data = v2
                m.views.append(view)
        return m


# ---------------------------------------------------------------------------
# QueryResponse (reference internal/public.proto:66-81 + the type codes in
# encoding/proto/proto.go:1056-1067; attr types proto.go:1119-1124)
# ---------------------------------------------------------------------------

QUERY_RESULT_NIL = 0
QUERY_RESULT_ROW = 1
QUERY_RESULT_PAIRS = 2
QUERY_RESULT_VALCOUNT = 3
QUERY_RESULT_UINT64 = 4
QUERY_RESULT_BOOL = 5
QUERY_RESULT_ROWIDS = 6
QUERY_RESULT_GROUPCOUNTS = 7
QUERY_RESULT_ROWIDENTIFIERS = 8
QUERY_RESULT_PAIR = 9

ATTR_TYPE_STRING = 1
ATTR_TYPE_INT = 2
ATTR_TYPE_BOOL = 3
ATTR_TYPE_FLOAT = 4


def _encode_int64(fnum: int, v: int) -> bytes:
    return _encode_tag(fnum, 0) + _encode_varint(int(v) & 0xFFFFFFFFFFFFFFFF)


def _encode_attr(key: str, value) -> bytes:
    """reference internal.Attr (proto.go encodeAttrs)."""
    out = _encode_string(1, key)
    if isinstance(value, bool):
        out += _encode_uint64(2, ATTR_TYPE_BOOL) + _encode_bool(5, value)
    elif isinstance(value, int):
        out += _encode_uint64(2, ATTR_TYPE_INT) + _encode_int64(4, value)
    elif isinstance(value, float):
        import struct

        out += _encode_uint64(2, ATTR_TYPE_FLOAT)
        out += _encode_tag(6, 1) + struct.pack("<d", value)
    else:
        out += _encode_uint64(2, ATTR_TYPE_STRING) + _encode_string(3, str(value))
    return out


def _encode_attr_list(fnum: int, attrs: dict) -> bytes:
    out = b""
    for k in sorted(attrs):
        out += _encode_bytes(fnum, _encode_attr(k, attrs[k]))
    return out


def _encode_pair(p) -> bytes:
    out = b""
    if p.id:
        out += _encode_uint64(1, int(p.id))
    if p.count:
        out += _encode_uint64(2, int(p.count))
    if getattr(p, "key", ""):
        out += _encode_string(3, p.key)
    return out


def encode_query_result(r) -> bytes:
    """One executor result -> internal.QueryResult bytes (reference
    encoding/proto/proto.go:416-448 encodeQueryResult)."""
    from pilosa_tpu_torch.core.cache import Pair
    from pilosa_tpu_torch.core.row import Row
    from pilosa_tpu_torch.exec.result import (
        GroupCount,
        PairField,
        PairsField,
        RowIDs,
        ValCount,
    )

    out = b""
    if isinstance(r, Row):
        # The Row columns array feeds the vectorized varint packer
        # directly — the [int(c) for c in ...tolist()] per-element loop
        # every remote shard leg used to pay is gone.
        body = _encode_packed_uint64(1, r.columns())
        if r.keys:
            for k in r.keys:
                body += _encode_string(3, k)
        if r.attrs:
            body += _encode_attr_list(2, r.attrs)
        out += _encode_tag(6, 0) + _encode_varint(QUERY_RESULT_ROW)
        out += _encode_bytes(1, body)
    elif isinstance(r, PairsField):
        out += _encode_tag(6, 0) + _encode_varint(QUERY_RESULT_PAIRS)
        for p in r.pairs:
            out += _encode_bytes(3, _encode_pair(p))
    elif isinstance(r, PairField):
        out += _encode_tag(6, 0) + _encode_varint(QUERY_RESULT_PAIR)
        out += _encode_bytes(3, _encode_pair(r.pair))
    elif isinstance(r, ValCount):
        out += _encode_tag(6, 0) + _encode_varint(QUERY_RESULT_VALCOUNT)
        body = _encode_int64(1, r.val) + _encode_int64(2, r.count)
        out += _encode_bytes(5, body)
    elif isinstance(r, bool):
        out += _encode_tag(6, 0) + _encode_varint(QUERY_RESULT_BOOL)
        out += _encode_bool(4, r)
    elif isinstance(r, int):
        out += _encode_tag(6, 0) + _encode_varint(QUERY_RESULT_UINT64)
        out += _encode_uint64(2, r)
    elif isinstance(r, RowIDs):
        out += _encode_tag(6, 0) + _encode_varint(QUERY_RESULT_ROWIDENTIFIERS)
        body = _encode_packed_uint64(1, list(r))
        for k in getattr(r, "keys", None) or []:
            body += _encode_string(2, k)
        out += _encode_bytes(9, body)
    elif isinstance(r, list) and (not r or isinstance(r[0], GroupCount)):
        out += _encode_tag(6, 0) + _encode_varint(QUERY_RESULT_GROUPCOUNTS)
        for gc in r:
            gbody = b""
            for fr in gc.group:
                fbody = _encode_string(1, fr.field)
                if fr.row_id:
                    fbody += _encode_uint64(2, int(fr.row_id))
                if getattr(fr, "row_key", ""):
                    fbody += _encode_string(3, fr.row_key)
                gbody += _encode_bytes(1, fbody)
            gbody += _encode_uint64(2, int(gc.count))
            out += _encode_bytes(8, gbody)
    else:  # None / unknown
        out += _encode_tag(6, 0) + _encode_varint(QUERY_RESULT_NIL)
    return out


def encode_query_response(results, column_attr_sets=None, err: str = "") -> bytes:
    """internal.QueryResponse (the wire shape Go client libraries read)."""
    out = b""
    if err:
        out += _encode_string(1, err)
    for r in results:
        out += _encode_bytes(2, encode_query_result(r))
    for cas in column_attr_sets or []:
        body = _encode_uint64(1, int(cas.get("id", 0)))
        if cas.get("key"):
            body += _encode_string(3, cas["key"])
        body += _encode_attr_list(2, cas.get("attrs", {}))
        out += _encode_bytes(3, body)
    return out


def _decode_attr(data: bytes):
    key, value = "", None
    typ = 0
    raw = {}
    for fnum, wtype, v in _iter_fields(data):
        raw[fnum] = v
    key = _field_str(raw.get(1, b""))
    typ = raw.get(2, 0)
    if typ == ATTR_TYPE_STRING:
        value = _field_str(raw.get(3, b""))
    elif typ == ATTR_TYPE_INT:
        value = _signed(raw.get(4, 0))
    elif typ == ATTR_TYPE_BOOL:
        value = bool(raw.get(5, 0))
    elif typ == ATTR_TYPE_FLOAT:
        import struct

        value = struct.unpack("<d", raw.get(6, b"\0" * 8))[0]
    return key, value


def decode_query_response(data: bytes) -> dict:
    """QueryResponse bytes -> plain python (for tests + python clients)."""
    results = []
    err = ""
    column_attr_sets = []
    for fnum, wtype, v in _iter_fields(data):
        if fnum == 1:
            err = _field_str(v)
        elif fnum == 2:
            results.append(_decode_query_result(v))
        elif fnum == 3:
            cas = {"id": 0, "attrs": {}}
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1:
                    cas["id"] = v2
                elif f2 == 3:
                    cas["key"] = _field_str(v2)
                elif f2 == 2:
                    k, val = _decode_attr(v2)
                    cas["attrs"][k] = val
            column_attr_sets.append(cas)
    out = {"results": results}
    if err:
        out["error"] = err
    if column_attr_sets:
        out["columnAttrSets"] = column_attr_sets
    return out


def _decode_query_result(data: bytes):
    typ = QUERY_RESULT_NIL
    fields: list[tuple[int, int, object]] = []
    for fnum, wtype, v in _iter_fields(data):
        if fnum == 6:
            typ = v
        else:
            fields.append((fnum, wtype, v))
    if typ == QUERY_RESULT_ROW:
        row = {"columns": [], "keys": [], "attrs": {}}
        for fnum, wtype, v in fields:
            if fnum == 1:
                for f2, w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        row["columns"].extend(_repeated_uint64(v2, w2))
                    elif f2 == 3:
                        row["keys"].append(_field_str(v2))
                    elif f2 == 2:
                        k, val = _decode_attr(v2)
                        row["attrs"][k] = val
        if not row["keys"]:
            del row["keys"]
        return row
    if typ in (QUERY_RESULT_PAIRS, QUERY_RESULT_PAIR):
        pairs = []
        for fnum, wtype, v in fields:
            if fnum == 3:
                p = {"id": 0, "count": 0}
                for f2, w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        p["id"] = v2
                    elif f2 == 2:
                        p["count"] = v2
                    elif f2 == 3:
                        p["key"] = _field_str(v2)
                pairs.append(p)
        return pairs[0] if typ == QUERY_RESULT_PAIR and pairs else pairs
    if typ == QUERY_RESULT_VALCOUNT:
        out = {"value": 0, "count": 0}
        for fnum, wtype, v in fields:
            if fnum == 5:
                for f2, w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        out["value"] = _signed(v2)
                    elif f2 == 2:
                        out["count"] = _signed(v2)
        return out
    if typ == QUERY_RESULT_UINT64:
        for fnum, wtype, v in fields:
            if fnum == 2:
                return v
        return 0
    if typ == QUERY_RESULT_BOOL:
        for fnum, wtype, v in fields:
            if fnum == 4:
                return bool(v)
        return False
    if typ in (QUERY_RESULT_ROWIDS, QUERY_RESULT_ROWIDENTIFIERS):
        out = {"rows": [], "keys": []}
        for fnum, wtype, v in fields:
            if fnum == 9:
                for f2, w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        out["rows"].extend(_repeated_uint64(v2, w2))
                    elif f2 == 2:
                        out["keys"].append(_field_str(v2))
        if not out["keys"]:
            del out["keys"]
        return out
    if typ == QUERY_RESULT_GROUPCOUNTS:
        groups = []
        for fnum, wtype, v in fields:
            if fnum == 8:
                gc = {"group": [], "count": 0}
                for f2, w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        fr = {"field": "", "rowID": 0}
                        for f3, w3, v3 in _iter_fields(v2):
                            if f3 == 1:
                                fr["field"] = _field_str(v3)
                            elif f3 == 2:
                                fr["rowID"] = v3
                            elif f3 == 3:
                                fr["rowKey"] = _field_str(v3)
                        gc["group"].append(fr)
                    elif f2 == 2:
                        gc["count"] = v2
                groups.append(gc)
        return groups
    return None


@dataclass
class QueryRequest:
    """reference internal/public.proto:57."""

    query: str = ""
    shards: list[int] = dc_field(default_factory=list)
    column_attrs: bool = False
    remote: bool = False
    exclude_row_attrs: bool = False
    exclude_columns: bool = False

    def to_bytes(self) -> bytes:
        out = _encode_string(1, self.query)
        out += _encode_packed_uint64(2, self.shards)
        if self.column_attrs:
            out += _encode_bool(3, True)
        if self.remote:
            out += _encode_bool(5, True)
        if self.exclude_row_attrs:
            out += _encode_bool(6, True)
        if self.exclude_columns:
            out += _encode_bool(7, True)
        return out

    @staticmethod
    def from_bytes(data: bytes) -> "QueryRequest":
        m = QueryRequest()
        for fnum, wtype, v in _iter_fields(data):
            if fnum == 1:
                m.query = _field_str(v)
            elif fnum == 2:
                m.shards.extend(_repeated_uint64(v, wtype))
            elif fnum == 3:
                m.column_attrs = bool(v)
            elif fnum == 5:
                m.remote = bool(v)
            elif fnum == 6:
                m.exclude_row_attrs = bool(v)
            elif fnum == 7:
                m.exclude_columns = bool(v)
        return m
