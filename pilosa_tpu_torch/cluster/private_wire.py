"""Typed binary control plane (reference internal/private.proto:5-195 +
encoding/proto/proto.go:29-42).

The reference moves cluster-control traffic — resize instructions
(carrying whole schemas), cluster status, node events — as versioned
protobuf messages behind a Serializer seam, with a 1-byte type prefix
on the broadcast wire (broadcast.go:55-122). This module is that seam's
binary implementation: hand-rolled protobuf wire format (same varint
codec style as server/wire.py's public.proto messages) for every
control message the bus carries. The in-process representation stays
the broadcast.Message dict; marshal/unmarshal convert at the wire so
the cluster protocol can evolve behind explicit field numbers instead
of ad-hoc JSON key spellings.

Frame layout: [type byte][version byte][protobuf body]. Type bytes
deliberately start at 0x01 and never collide with '{' (0x7B), so a
receiver can sniff legacy-JSON frames from old peers.

Compatibility directions: old→new works transparently (JSON sniff);
frames from a NEWER peer (unknown type byte or version) decode to an
ignorable "unknown-wire-*" message so the receive dispatch skips them
instead of erroring. new→old does NOT work automatically — an
old JSON-only peer cannot parse binary frames — so rolling upgrades
across the serializer boundary should run the sender in JSON mode
(PILOSA_TPU_CONTROL_WIRE=json) until every node is upgraded.

Message ↔ type byte registry at the bottom; unknown/untyped message
types marshal as JSON transparently.
"""

from __future__ import annotations

import json

from pilosa_tpu_torch.server.wire import (
    _encode_bool,
    _encode_bytes,
    _encode_packed_uint64,
    _encode_string,
    _encode_uint64,
    _encode_varint,
    _field_str,
    _iter_fields,
    _repeated_uint64,
)

WIRE_VERSION = 1


def _encode_sint64(fnum: int, v: int) -> bytes:
    """zigzag-encoded signed int (BSI min/max/base can be negative)."""
    zz = (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1
    return _encode_varint(fnum << 3) + _encode_varint(zz & ((1 << 64) - 1))


def _decode_sint(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


# -- Node ----------------------------------------------------------------


def _enc_node(n: dict) -> bytes:
    uri = n.get("uri") or {}
    out = _encode_string(1, n.get("id", ""))
    out += _encode_string(2, uri.get("scheme", "http"))
    out += _encode_string(3, uri.get("host", "localhost"))
    out += _encode_uint64(4, int(uri.get("port", 10101)))
    out += _encode_bool(5, bool(n.get("isCoordinator")))
    out += _encode_string(6, n.get("state", "READY"))
    return out


def _dec_node(data: bytes) -> dict:
    n = {"id": "", "uri": {"scheme": "http", "host": "localhost", "port": 10101},
         "isCoordinator": False, "state": "READY"}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            n["id"] = _field_str(v)
        elif fnum == 2:
            n["uri"]["scheme"] = _field_str(v)
        elif fnum == 3:
            n["uri"]["host"] = _field_str(v)
        elif fnum == 4:
            n["uri"]["port"] = int(v)
        elif fnum == 5:
            n["isCoordinator"] = bool(v)
        elif fnum == 6:
            n["state"] = _field_str(v)
    return n


# -- Schema (IndexMeta/FieldMeta, private.proto) ---------------------------


def _enc_field_options(o: dict) -> bytes:
    out = _encode_string(1, o.get("type", "set"))
    out += _encode_string(2, o.get("cacheType", ""))
    out += _encode_uint64(3, int(o.get("cacheSize", 0)))
    out += _encode_sint64(4, int(o.get("min", 0)))
    out += _encode_sint64(5, int(o.get("max", 0)))
    out += _encode_sint64(6, int(o.get("base", 0)))
    out += _encode_uint64(7, int(o.get("bitDepth", 0)))
    out += _encode_string(8, o.get("timeQuantum", "") or "")
    out += _encode_bool(9, bool(o.get("keys")))
    out += _encode_bool(10, bool(o.get("noStandardView")))
    return out


def _dec_field_options(data: bytes) -> dict:
    o = {"type": "set", "cacheType": "", "cacheSize": 0, "min": 0, "max": 0,
         "base": 0, "bitDepth": 0, "timeQuantum": "", "keys": False,
         "noStandardView": False}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            o["type"] = _field_str(v)
        elif fnum == 2:
            o["cacheType"] = _field_str(v)
        elif fnum == 3:
            o["cacheSize"] = int(v)
        elif fnum == 4:
            o["min"] = _decode_sint(int(v))
        elif fnum == 5:
            o["max"] = _decode_sint(int(v))
        elif fnum == 6:
            o["base"] = _decode_sint(int(v))
        elif fnum == 7:
            o["bitDepth"] = int(v)
        elif fnum == 8:
            o["timeQuantum"] = _field_str(v)
        elif fnum == 9:
            o["keys"] = bool(v)
        elif fnum == 10:
            o["noStandardView"] = bool(v)
    return o


def _enc_field(f: dict) -> bytes:
    out = _encode_string(1, f.get("name", ""))
    out += _encode_bytes(2, _enc_field_options(f.get("options") or {}))
    return out


def _dec_field(data: bytes) -> dict:
    f = {"name": "", "options": {}}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            f["name"] = _field_str(v)
        elif fnum == 2:
            f["options"] = _dec_field_options(v)
    return f


def _enc_index(i: dict) -> bytes:
    opts = i.get("options") or {}
    out = _encode_string(1, i.get("name", ""))
    out += _encode_bool(2, bool(opts.get("keys")))
    out += _encode_bool(3, bool(opts.get("trackExistence", True)))
    for f in i.get("fields") or []:
        out += _encode_bytes(4, _enc_field(f))
    out += _encode_uint64(5, int(i.get("shardWidth", 0)))
    return out


def _dec_index(data: bytes) -> dict:
    i = {"name": "", "options": {"keys": False, "trackExistence": True},
         "fields": []}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            i["name"] = _field_str(v)
        elif fnum == 2:
            i["options"]["keys"] = bool(v)
        elif fnum == 3:
            i["options"]["trackExistence"] = bool(v)
        elif fnum == 4:
            i["fields"].append(_dec_field(v))
        elif fnum == 5 and int(v):
            i["shardWidth"] = int(v)
    return i


def _enc_schema(s: dict) -> bytes:
    out = b""
    for idx in (s or {}).get("indexes") or []:
        out += _encode_bytes(1, _enc_index(idx))
    return out


def _dec_schema(data: bytes) -> dict:
    return {"indexes": [_dec_index(v) for fnum, _w, v in _iter_fields(data)
                        if fnum == 1]}


# -- available-shards map + resize sources ---------------------------------


def _enc_avail(available: dict) -> bytes:
    """{index: {field: [shards]}} as repeated FieldAvail submessages."""
    out = b""
    for iname, fields in (available or {}).items():
        for fname, shards in fields.items():
            body = _encode_string(1, iname)
            body += _encode_string(2, fname)
            body += _encode_packed_uint64(3, [int(s) for s in shards])
            out += _encode_bytes(15, body)
    return out


def _dec_avail_entry(data: bytes, into: dict) -> None:
    iname = fname = ""
    shards: list[int] = []
    for fnum, w, v in _iter_fields(data):
        if fnum == 1:
            iname = _field_str(v)
        elif fnum == 2:
            fname = _field_str(v)
        elif fnum == 3:
            shards.extend(_repeated_uint64(v, w))
    into.setdefault(iname, {})[fname] = shards


def _enc_source(src: dict) -> bytes:
    out = _encode_string(1, src.get("index", ""))
    out += _encode_string(2, src.get("field", ""))
    out += _encode_uint64(3, int(src.get("shard", 0)))
    out += _encode_string(4, str(src.get("from", "")))
    # Alternate surviving owners the fetcher fails over to;
    # repeated string, absent on frames from older builds.
    for alt in src.get("alts") or []:
        out += _encode_string(5, str(alt))
    return out


def _dec_source(data: bytes) -> dict:
    src: dict = {"index": "", "field": "", "shard": 0, "from": "", "alts": []}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            src["index"] = _field_str(v)
        elif fnum == 2:
            src["field"] = _field_str(v)
        elif fnum == 3:
            src["shard"] = int(v)
        elif fnum == 4:
            src["from"] = _field_str(v)
        elif fnum == 5:
            src["alts"].append(_field_str(v))
    return src


# -- per-message-type bodies ------------------------------------------------
# Each entry: (type_byte, encode(msg)->bytes, decode(bytes)->fields dict).


def _enc_create_shard(m: dict) -> bytes:
    return (_encode_string(1, m.get("index", ""))
            + _encode_string(2, m.get("field", ""))
            + _encode_uint64(3, int(m.get("shard", 0))))


def _dec_create_shard(data: bytes) -> dict:
    m = {"index": "", "field": "", "shard": 0}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            m["index"] = _field_str(v)
        elif fnum == 2:
            m["field"] = _field_str(v)
        elif fnum == 3:
            m["shard"] = int(v)
    return m


def _enc_cluster_status(m: dict) -> bytes:
    out = _encode_string(1, m.get("state", ""))
    for n in m.get("nodes") or []:
        out += _encode_bytes(2, _enc_node(n))
    if "replicaN" in m:
        out += _encode_uint64(3, int(m["replicaN"]))
    # presence marker for nodes: an empty node list must stay absent
    out += _encode_bool(4, "nodes" in m)
    return out


def _dec_cluster_status(data: bytes) -> dict:
    m: dict = {"state": ""}
    nodes = []
    has_nodes = False
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            m["state"] = _field_str(v)
        elif fnum == 2:
            nodes.append(_dec_node(v))
        elif fnum == 3:
            m["replicaN"] = int(v)
        elif fnum == 4:
            has_nodes = bool(v)
    if has_nodes or nodes:
        m["nodes"] = nodes
    return m


def _enc_node_status(m: dict) -> bytes:
    out = b""
    if m.get("schema") is not None:
        out += _encode_bytes(1, _enc_schema(m["schema"]))
    out += _enc_avail(m.get("available") or {})
    return out


def _dec_node_status(data: bytes) -> dict:
    m: dict = {}
    avail: dict = {}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            m["schema"] = _dec_schema(v)
        elif fnum == 15:
            _dec_avail_entry(v, avail)
    if avail:
        m["available"] = avail
    return m


def _enc_node_event(m: dict) -> bytes:
    out = _encode_string(1, m.get("event", ""))
    if m.get("node") is not None:
        out += _encode_bytes(2, _enc_node(m["node"]))
    if m.get("status") is not None:
        out += _encode_bytes(3, _enc_node_status(m["status"]))
    out += _encode_bool(4, bool(m.get("forwarded")))
    return out


def _dec_node_event(data: bytes) -> dict:
    m: dict = {"event": ""}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            m["event"] = _field_str(v)
        elif fnum == 2:
            m["node"] = _dec_node(v)
        elif fnum == 3:
            m["status"] = _dec_node_status(v)
        elif fnum == 4 and v:
            m["forwarded"] = True
    return m


def _enc_node_state(m: dict) -> bytes:
    return _encode_string(1, m.get("id", "")) + _encode_string(
        2, m.get("state", "")
    )


def _dec_node_state(data: bytes) -> dict:
    m = {"id": "", "state": ""}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            m["id"] = _field_str(v)
        elif fnum == 2:
            m["state"] = _field_str(v)
    return m


def _enc_resize_instruction(m: dict) -> bytes:
    out = _encode_uint64(1, int(m.get("job", 0)))
    if m.get("coordinator") is not None:
        out += _encode_bytes(2, _enc_node(m["coordinator"]))
    if m.get("schema") is not None:
        out += _encode_bytes(3, _enc_schema(m["schema"]))
    for src in m.get("sources") or []:
        out += _encode_bytes(4, _enc_source(src))
    out += _encode_string(5, str(m.get("node", "")))
    # Job epoch: completions must echo it or the coordinator
    # rejects them as stale — dropping it on the wire would reject EVERY
    # completion and wedge the job at its timeout.
    out += _encode_uint64(6, int(m.get("epoch") or 0))
    out += _enc_avail(m.get("available") or {})
    return out


def _dec_resize_instruction(data: bytes) -> dict:
    m: dict = {"job": 0, "epoch": 0, "sources": []}
    avail: dict = {}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            m["job"] = int(v)
        elif fnum == 2:
            m["coordinator"] = _dec_node(v)
        elif fnum == 3:
            m["schema"] = _dec_schema(v)
        elif fnum == 4:
            m["sources"].append(_dec_source(v))
        elif fnum == 5:
            m["node"] = _field_str(v)
        elif fnum == 6:
            m["epoch"] = int(v)
        elif fnum == 15:
            _dec_avail_entry(v, avail)
    if avail:
        m["available"] = avail
    return m


def _enc_resize_complete(m: dict) -> bytes:
    out = _encode_uint64(1, int(m.get("job", 0)))
    out += _encode_string(2, m.get("node", ""))
    if m.get("error"):
        out += _encode_string(3, str(m["error"]))
    out += _encode_uint64(4, int(m.get("epoch") or 0))
    return out


def _dec_resize_complete(data: bytes) -> dict:
    m: dict = {"job": 0, "epoch": 0, "node": ""}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            m["job"] = int(v)
        elif fnum == 2:
            m["node"] = _field_str(v)
        elif fnum == 3:
            m["error"] = _field_str(v)
        elif fnum == 4:
            m["epoch"] = int(v)
    return m


def _enc_set_coordinator(m: dict) -> bytes:
    return _encode_string(1, m.get("id", ""))


def _dec_set_coordinator(data: bytes) -> dict:
    m = {"id": ""}
    for fnum, _w, v in _iter_fields(data):
        if fnum == 1:
            m["id"] = _field_str(v)
    return m


def _enc_empty(m: dict) -> bytes:
    return b""


def _dec_empty(data: bytes) -> dict:
    return {}


# Registry: message type string -> (type byte, enc, dec). Type bytes
# mirror the reference's 1-byte prefixes (broadcast.go:55-122 ordering).
_REGISTRY = {
    "create-shard": (0x01, _enc_create_shard, _dec_create_shard),
    "delete-available-shard": (0x02, _enc_create_shard, _dec_create_shard),
    "cluster-status": (0x03, _enc_cluster_status, _dec_cluster_status),
    "node-status": (0x04, _enc_node_status, _dec_node_status),
    "node-event": (0x05, _enc_node_event, _dec_node_event),
    "node-state": (0x06, _enc_node_state, _dec_node_state),
    "resize-instruction": (0x07, _enc_resize_instruction, _dec_resize_instruction),
    "resize-complete": (0x08, _enc_resize_complete, _dec_resize_complete),
    "resize-abort": (0x09, _enc_empty, _dec_empty),
    "set-coordinator": (0x0A, _enc_set_coordinator, _dec_set_coordinator),
    "recalculate-caches": (0x0B, _enc_empty, _dec_empty),
}
_BY_BYTE = {tb: (typ, dec) for typ, (tb, _enc, dec) in _REGISTRY.items()}


class ProtoSerializer:
    """Typed binary for registered control messages; transparent JSON for
    anything else (forward compatibility). Unmarshal sniffs legacy JSON
    frames ('{' first byte) from older peers."""

    def marshal(self, msg: dict) -> bytes:
        entry = _REGISTRY.get(msg.get("type", ""))
        if entry is None:
            return json.dumps(msg).encode()
        type_byte, enc, _dec = entry
        return bytes((type_byte, WIRE_VERSION)) + enc(msg)

    def unmarshal(self, data: bytes) -> dict:
        if not data:
            raise ValueError("empty control message")
        if data[0] == 0x7B:  # '{' — legacy/fallback JSON frame
            return json.loads(data)
        if len(data) < 2:
            raise ValueError("truncated control message header")
        entry = _BY_BYTE.get(data[0])
        if entry is None or data[1] != WIRE_VERSION:
            # A NEWER peer sent a type/version we don't know. The receive
            # dispatch deliberately ignores unknown message types
            # (forward compatibility, reference server.go receiveMessage);
            # surface an ignorable message instead of 500ing the
            # /internal/cluster/message endpoint mid-rolling-upgrade.
            return {
                "type": f"unknown-wire-{data[0]:#04x}-v{data[1]}",
            }
        typ, dec = entry
        fields = dec(data[2:])
        fields["type"] = typ
        return fields


class JSONSerializer:
    """The debuggable fallback (still used by tests that inspect frames)."""

    def marshal(self, msg: dict) -> bytes:
        return json.dumps(msg).encode()

    def unmarshal(self, data: bytes) -> dict:
        return json.loads(data)
