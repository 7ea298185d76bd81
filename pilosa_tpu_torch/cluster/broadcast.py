"""Control-plane broadcast messages (reference broadcast.go:30-140).

The reference encodes 16 protobuf message types with a 1-byte type prefix
and delivers them sync (HTTP POST /internal/cluster/message to every
node, server.go:666) or async (piggybacked on gossip). Here messages are
JSON objects with a "type" field — the control plane is low-rate schema/
topology traffic, so self-describing JSON beats protobuf for
debuggability; the data plane (imports, fragments) stays binary.
"""

from __future__ import annotations

import threading
from typing import Optional, Protocol

# Message types (reference broadcast.go:55-122).
MSG_CREATE_SHARD = "create-shard"
MSG_CREATE_INDEX = "create-index"
MSG_DELETE_INDEX = "delete-index"
MSG_CREATE_FIELD = "create-field"
MSG_DELETE_FIELD = "delete-field"
MSG_DELETE_AVAILABLE_SHARD = "delete-available-shard"
MSG_CLUSTER_STATUS = "cluster-status"
MSG_RESIZE_INSTRUCTION = "resize-instruction"
MSG_RESIZE_COMPLETE = "resize-complete"
MSG_SET_COORDINATOR = "set-coordinator"
MSG_UPDATE_COORDINATOR = "update-coordinator"
MSG_NODE_EVENT = "node-event"
MSG_NODE_STATE = "node-state"
MSG_NODE_STATUS = "node-status"
MSG_RECALCULATE_CACHES = "recalculate-caches"
MSG_RESIZE_ABORT = "resize-abort"
# Coordinator liveness while a resize job is in flight:
# followers renew their rollback lease on each one; when the coordinator
# dies the heartbeats die with it and every follower's lease expires.
MSG_RESIZE_HEARTBEAT = "resize-heartbeat"

# Node events (reference event.go).
EVENT_JOIN = "join"
EVENT_LEAVE = "leave"
EVENT_UPDATE = "update"


class Message(dict):
    """A typed control message; plain dict with a required 'type'.

    The wire representation goes through the module serializer seam
    (reference encoding/proto Serializer, proto.go:29-42): typed binary
    protobuf frames for registered control messages
    (cluster/private_wire.py), JSON for unregistered ones, and
    legacy-JSON sniffing on receive so mixed-version clusters
    interoperate."""

    @staticmethod
    def make(msg_type: str, **fields) -> "Message":
        m = Message(fields)
        m["type"] = msg_type
        return m

    def to_bytes(self) -> bytes:
        return _serializer().marshal(self)

    @staticmethod
    def from_bytes(data: bytes) -> "Message":
        return Message(_serializer().unmarshal(data))


_SERIALIZER = None


def _serializer():
    global _SERIALIZER
    if _SERIALIZER is None:
        import os

        from pilosa_tpu_torch.cluster.private_wire import JSONSerializer, ProtoSerializer

        # PILOSA_TPU_CONTROL_WIRE=json keeps frames parseable by
        # JSON-only peers during a rolling upgrade (see private_wire.py
        # compatibility notes).
        if os.environ.get("PILOSA_TPU_CONTROL_WIRE", "").lower() == "json":
            _SERIALIZER = JSONSerializer()
        else:
            _SERIALIZER = ProtoSerializer()
    return _SERIALIZER


def set_serializer(s) -> None:
    """Swap the control-plane serializer (tests / wire-compat modes)."""
    global _SERIALIZER
    _SERIALIZER = s


class Broadcaster(Protocol):
    """reference broadcast.go:30 broadcaster interface."""

    def send_sync(self, msg: Message) -> None: ...
    def send_async(self, msg: Message) -> None: ...
    def send_to(self, node, msg: Message) -> None: ...
    def reset_wire_negotiation(self) -> None: ...


class NopBroadcaster:
    """Default no-op (reference broadcast.go:41) so single-node servers and
    tests need no cluster plumbing."""

    def send_sync(self, msg: Message) -> None:
        pass

    def send_async(self, msg: Message) -> None:
        pass

    def send_to(self, node, msg: Message) -> None:
        pass

    def reset_wire_negotiation(self) -> None:
        pass


class HTTPBroadcaster:
    """Delivers messages over the internal client to every peer
    (reference server.go SendSync :666).

    send_sync raises on the first failed peer; send_async fires
    best-effort threads (the gossip-queue analog — same at-most-once
    semantics from the sender's view).
    """

    def __init__(self, cluster, client=None):
        self.cluster = cluster
        from pilosa_tpu_torch.cluster.client import InternalClient

        self.client = client or InternalClient()
        # Peers that rejected a binary frame and accepted the JSON retry:
        # JSON-only older builds mid-rolling-upgrade (the
        # binary default would otherwise require the operator to pre-set
        # PILOSA_TPU_CONTROL_WIRE=json on every sender). Subsequent sends
        # to them go straight to JSON (every receiver, old or new, parses
        # JSON — receive sniffs the frame). Cleared on membership change
        # (cluster.receive_message MSG_CLUSTER_STATUS) so a replaced or
        # upgraded-in-place node re-negotiates. Guarded by _wire_lock:
        # the fan-out send threads read/pin concurrently with the
        # message handler's membership-change clear (shared-state rule).
        self._json_peers: set[str] = set()
        self._wire_lock = threading.Lock()

    def _peers(self):
        local_id = self.cluster.local_node.id
        return [n for n in self.cluster.topology.nodes if n.id != local_id]

    def reset_wire_negotiation(self) -> None:
        """Forget per-peer wire pins (called by the cluster on membership
        change: a replaced or upgraded-in-place node may speak binary)."""
        with self._wire_lock:
            self._json_peers.clear()

    @staticmethod
    def _is_parse_failure(e) -> bool:
        """True when an HTTP error means 'the peer could not PARSE the
        frame' (safe to retry as JSON). Current peers answer a structured
        code='bad-frame' 400 before any side effect; legacy JSON-only
        builds surface json.JSONDecodeError through their panic trap, so
        the 500 body's final traceback line names the decoder. Anything
        else (a handler error AFTER the message was parsed and possibly
        partially applied) must NOT be retried — control messages are
        idempotent by design, but re-running a half-applied handler is
        still the sender guessing about receiver state. (Deliberately
        narrow: only the exception NAME is matched, because a panic-trap
        body carries a full traceback whose source lines could contain
        arbitrary function names.)"""
        if e.status < 400:
            return False
        if getattr(e, "code", "") == "bad-frame":
            return True
        return getattr(e, "code", "") == "" and "JSONDecodeError" in str(e)

    def _deliver(self, node, msg: Message, payload: Optional[bytes] = None) -> None:
        """Send with per-peer wire negotiation: a peer that answers a
        parse failure to the default (possibly binary) frame gets ONE
        retry with legacy JSON; success pins that peer to JSON. Transport
        failures (status 0: refused/timeout) are not retried — the frame
        never reached a parser. Broadcast paths pass the default payload
        in so an N-peer send marshals once, not N times."""
        from pilosa_tpu_torch.cluster.client import ClientError
        from pilosa_tpu_torch.cluster.private_wire import JSONSerializer

        from pilosa_tpu_torch.utils.deadline import Deadline, deadline_scope

        node_id = getattr(node, "id", None)
        if payload is None:
            payload = msg.to_bytes()
        json_payload = None  # marshalled only on the fallback paths
        with self._wire_lock:
            pinned_json = node_id in self._json_peers
        if pinned_json:
            json_payload = JSONSerializer().marshal(msg)
            if json_payload == payload:
                json_payload = None  # already JSON: nothing to negotiate
            else:
                payload = json_payload
        # Budget per frame (deadline-scope rule): one delivery is at
        # most two wire attempts (default + JSON renegotiation), so 2x
        # the client timeout bounds the frame without squeezing the
        # fallback when the first attempt burned a full socket timeout.
        # An outer (tighter) request deadline still wins — scopes nest.
        # getattr: test doubles stand in for the client without a
        # timeout attribute.
        with deadline_scope(Deadline(getattr(self.client, "timeout", 30.0) * 2)):
            try:
                self.client.send_message(node, payload)
                return
            except ClientError as e:
                if not self._is_parse_failure(e):
                    raise
                if json_payload is None:
                    json_payload = JSONSerializer().marshal(msg)
                if json_payload == payload:
                    raise  # frame WAS JSON; nothing better to offer
            from pilosa_tpu_torch.cluster.client import count_rpc_retry, peer_label

            count_rpc_retry(peer_label(node), "send_message")
            self.client.send_message(node, json_payload)
        if node_id is not None:
            with self._wire_lock:
                self._json_peers.add(node_id)

    def send_sync(self, msg: Message) -> None:
        peers = self._peers()
        if not peers:
            return
        payload = msg.to_bytes()  # marshal once for all peers
        errors: list[str] = []
        lock = threading.Lock()

        def send(node):
            try:
                self._deliver(node, msg, payload)
            except Exception as e:  # collected, not fatal per-peer
                with lock:
                    errors.append(f"{node.id}: {e}")

        # One RTT total, not N sequential RTTs.
        from pilosa_tpu_torch.utils.threads import spawn

        threads = [
            spawn("cluster-broadcast", send, args=(n,), start=False)
            for n in peers
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError("broadcast failed: " + "; ".join(errors))

    def send_async(self, msg: Message) -> None:
        from pilosa_tpu_torch.utils.threads import spawn

        payload = msg.to_bytes()  # marshal once for all peers
        for node in self._peers():
            spawn(
                "cluster-broadcast",
                self._send_quiet, args=(node, msg, payload),
            )

    def _send_quiet(self, node, msg: Message, payload: bytes) -> None:
        try:
            self._deliver(node, msg, payload)
        except Exception:
            # Async broadcast is best-effort by contract (missed nodes
            # reconverge via gossip/anti-entropy) — but a silently
            # diverging peer must still be visible on /metrics.
            from pilosa_tpu_torch.utils.stats import global_stats

            global_stats.with_tags(f"peer:{node.id}").count(
                "broadcast_async_errors_total"
            )

    def send_to(self, node, msg: Message) -> None:
        self._deliver(node, msg)
