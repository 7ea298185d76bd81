"""Internal peer-to-peer HTTP client (reference http/client.go InternalClient).

The DCN data plane: query fan-out (QueryNode with shards pinned +
remote=true, reference http/client.go:268), imports, fragment block sync
for anti-entropy, whole-fragment retrieval for resize, control-plane
message delivery, and key-translation RPCs. stdlib urllib with persistent
behavior left to the OS; every call raises ClientError on transport or
HTTP-status failure so the scatter-gather layer can retry replicas.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Optional, Sequence, Union

from pilosa_tpu_torch.cluster.breaker import BreakerRegistry
from pilosa_tpu_torch.cluster.topology import URI, Node
from pilosa_tpu_torch.utils.deadline import current_deadline
from pilosa_tpu_torch.utils.stats import global_stats
from pilosa_tpu_torch.utils.tracing import global_tracer


class ClientError(Exception):
    def __init__(self, msg: str, status: int = 0, code: str = "",
                 transport: bool = False):
        super().__init__(msg)
        self.status = status
        # Machine-readable error class from the peer's JSON error body
        # (e.g. "not-found"); empty when the body carried none.
        self.code = code
        # True for dial/reset/timeout failures (no HTTP exchange
        # completed): the class the breaker counts and the only class an
        # idempotent-GET retry may act on — an HTTP error status is a
        # peer DECISION and retrying it re-asks a question already
        # answered.
        self.transport = transport


#: A transport timeout whose socket budget was at least this long counts
#: as breaker evidence even when the query deadline set (truncated) the
#: socket timeout: half a second of silence is the peer's fault, not the
#: budget's. Below it, a deadline-squeezed timeout is the query's own.
_FAIR_WINDOW = 0.5


def _uri_str(uri: Union[URI, Node, str]) -> str:
    if isinstance(uri, Node):
        uri = uri.uri
    return str(uri)


def peer_label(uri: Union[URI, Node, str]) -> str:
    """host:port tag value for per-peer RPC series. Node ids would read
    better but the client routinely dials bare URIs (resize sources,
    rejoin announces) where no id exists; host:port is the one identity
    every call site has."""
    u = _uri_str(uri)
    _, _, hostport = u.partition("://")
    return hostport or u


# Per-peer in-flight request counts behind the peer_rpc_inflight gauge:
# the client is shared across serving threads, so the counter lives at
# module scope under one lock and each _do publishes the new value.
_inflight_lock = threading.Lock()
_inflight: dict[str, int] = {}


def _track_inflight(peer: str, delta: int) -> None:
    with _inflight_lock:
        n = _inflight.get(peer, 0) + delta
        _inflight[peer] = n
        # Published INSIDE the lock: otherwise two racing updates can
        # publish in inverted order and pin the gauge at a stale nonzero
        # value — the exact stuck-peer signature operators alert on.
        global_stats.with_tags(f"peer:{peer}").gauge("peer_rpc_inflight", n)


def count_rpc_retry(peer: str, method: str) -> None:
    """One retargeted/re-sent peer RPC (scatter-gather re-split onto a
    replica, schema-repair re-query, wire renegotiation). The client
    itself never retries — the layers above do — so they report here to
    keep every peer_rpc_* series in one vocabulary."""
    global_stats.with_tags(f"peer:{peer}", f"method:{method}").count(
        "peer_rpc_retries_total"
    )


def _ts_epoch(t) -> int:
    """Timestamp (int seconds / PQL string / datetime / falsy) -> unix
    seconds for the wire (reference ImportRequest.Timestamps int64)."""
    if not t:
        return 0
    if isinstance(t, int):
        return t
    import datetime as dt

    from pilosa_tpu_torch.core.timequantum import parse_time

    return int(parse_time(t).replace(tzinfo=dt.timezone.utc).timestamp())


class InternalClient:
    def __init__(self, timeout: float = 30.0, ssl_context=None,
                 retries: int = 1, breakers: Optional[BreakerRegistry] = None):
        self.timeout = timeout
        # ssl context for https:// peers (TLSConfig.client_context():
        # CA-verified or skip-verify); None = stdlib default validation.
        self.ssl_context = ssl_context
        # Transport-error retries for idempotent GETs (fragment sync,
        # status probes, federation scrapes): jittered backoff, bounded
        # by `retries` extra attempts and the active deadline. POSTs are
        # never retried here — the layers above own write retry policy.
        self.retries = max(int(retries), 0)
        # Per-peer circuit breakers: OWN instance per client (per node),
        # never shared — see breaker.py on asymmetric partitions.
        self.breakers = breakers if breakers is not None else BreakerRegistry()
        # Peer view-epoch piggyback sink: every
        # response carrying X-Pilosa-View-Epochs — remote query legs,
        # replica writes — hands the parsed payload here. The cluster
        # layer installs its epoch-map fold; None drops them.
        self.on_peer_epochs = None

    # -- plumbing ----------------------------------------------------------

    def _connect_uri(self, uri: Union[URI, Node, str]) -> str:
        """The URL actually dialed for a peer. Identity (peer_label: the
        breaker key and every peer_rpc_* tag) is always derived from the
        LOGICAL uri, not this — the test harness overrides this hook to
        route one peer through a fault proxy without the proxy's port
        leaking into the peer's telemetry or breaker state."""
        return _uri_str(uri)

    def _do(
        self,
        method: str,
        uri: Union[URI, Node, str],
        path: str,
        body: Optional[bytes] = None,
        content_type: str = "application/json",
        raw: bool = False,
        op: str = "",
        want_headers: bool = False,
        extra_headers: Optional[dict] = None,
    ):
        """One RPC with bounded jittered-backoff retries for idempotent
        GETs on transport errors. Retries stop early when the peer's
        breaker just opened (the peer is systemically failing — route to
        a replica instead of burning budget here) or when the remaining
        deadline no longer covers a backoff sleep plus a dial."""
        attempts = self.retries + 1 if method == "GET" else 1
        delay = 0.05
        for attempt in range(attempts):
            try:
                return self._do_once(method, uri, path, body=body,
                                     content_type=content_type, raw=raw, op=op,
                                     want_headers=want_headers,
                                     extra_headers=extra_headers)
            except ClientError as e:
                if not e.transport or attempt + 1 >= attempts:
                    raise
                peer = peer_label(uri)
                if self.breakers.is_blocked(peer):
                    raise
                sleep = delay * (0.5 + random.random())
                d = current_deadline()
                if d is not None and d.remaining() <= sleep + 0.05:
                    raise
                count_rpc_retry(peer, op or method)
                time.sleep(sleep)
                delay = min(delay * 2, 1.0)

    def _do_once(
        self,
        method: str,
        uri: Union[URI, Node, str],
        path: str,
        body: Optional[bytes] = None,
        content_type: str = "application/json",
        raw: bool = False,
        op: str = "",
        want_headers: bool = False,
        extra_headers: Optional[dict] = None,
    ):
        url = self._connect_uri(uri) + path
        # Per-peer, per-method RPC telemetry: the
        # first signal for "replica N is degraded". op is the client
        # method name (query_node, block_data, ...) — the path would
        # explode series cardinality with per-index/shard values.
        peer = peer_label(uri)
        op = op or method
        stats = global_stats.with_tags(f"peer:{peer}", f"method:{op}")
        req = urllib.request.Request(url, data=body, method=method)
        if body is not None:
            req.add_header("Content-Type", content_type)
        req.add_header("Accept", "application/json")
        if extra_headers:
            for k, v in extra_headers.items():
                req.add_header(k, v)
        # Cross-node trace propagation (reference tracing.go:36-40): the
        # receiving node's HTTP dispatch extracts these and links its
        # spans to the coordinator's trace (the
        # extraction side existed but nothing ever injected).
        span = global_tracer.active_span()
        if span is not None:
            for k, v in span.inject_headers().items():
                req.add_header(k, v)
        # Deadline budget: the socket timeout is
        # min(client timeout, remaining budget), and the remaining budget
        # (minus a skew margin) rides the request so the peer abandons a
        # leg the coordinator has already given up on. An already-expired
        # budget fails BEFORE dialing — dispatching work nobody will wait
        # for only loads the peer.
        deadline = current_deadline()
        timeout = self.timeout
        if deadline is not None:
            if deadline.expired():
                global_stats.with_tags("phase:peer_rpc").count(
                    "deadline_exceeded_total"
                )
                raise ClientError(
                    f"{method} {url}: deadline exceeded before dispatch",
                    code="deadline-exceeded",
                )
            timeout = deadline.bound(timeout)
            req.add_header("X-Pilosa-Deadline", deadline.header_value())
        _track_inflight(peer, +1)
        t0 = time.perf_counter()
        try:
            try:
                with urllib.request.urlopen(
                    req, timeout=timeout, context=self.ssl_context
                ) as resp:
                    data = resp.read()
                    # email.message.Message: case-insensitive .get();
                    # returned to the caller only on request (checksum
                    # verification), always consulted for piggybacks.
                    resp_headers = resp.headers if want_headers else None
                    self._fold_epoch_header(resp.headers)
            except urllib.error.HTTPError as e:
                detail = ""
                err_code = ""
                try:
                    detail = e.read().decode("utf-8", "replace")
                    err_code = json.loads(detail).get("code", "")
                except (OSError, ValueError, AttributeError):
                    # Body unreadable / not JSON / not an object: the
                    # status-only ClientError below is still correct.
                    pass
                stats.with_tags(f"class:{e.code // 100}xx").count(
                    "peer_rpc_errors_total"
                )
                # An HTTP status is a live peer answering: transport is
                # healthy, whatever the answer — close the breaker.
                self.breakers.record_success(peer)
                raise ClientError(
                    f"{method} {url}: status {e.code}: {detail}",
                    status=e.code,
                    code=err_code,
                ) from e
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                stats.with_tags("class:transport").count("peer_rpc_errors_total")
                # Breaker evidence — unless the failure is a timeout this
                # request's own nearly-spent deadline manufactured: a
                # tight budget must not open the breaker against a
                # healthy-but-not-instant peer. A peer that stayed silent
                # for a FAIR window (the full client timeout, or at least
                # _FAIR_WINDOW of budget) is the peer's fault even when
                # the deadline set the socket timeout — otherwise a
                # blackholed peer under all-deadlined traffic would never
                # open its breaker (every timeout fires exactly at budget
                # expiry) and every query would keep paying a doomed leg.
                if (
                    timeout >= min(self.timeout, _FAIR_WINDOW)
                    or deadline is None
                    or deadline.remaining() > 0.01
                ):
                    self.breakers.record_failure(peer)
                raise ClientError(
                    f"{method} {url}: {e}", transport=True
                ) from e
            else:
                self.breakers.record_success(peer)
        finally:
            stats.timing("peer_rpc_seconds", time.perf_counter() - t0)
            _track_inflight(peer, -1)
        if raw:
            return (data, resp_headers) if want_headers else data
        if not data:
            return {}
        try:
            return json.loads(data)
        except json.JSONDecodeError as e:
            stats.with_tags("class:decode").count("peer_rpc_errors_total")
            raise ClientError(f"{method} {url}: invalid JSON response: {e}") from e

    def _fold_epoch_header(self, headers) -> None:
        """Parse an X-Pilosa-View-Epochs piggyback into the installed
        sink. Malformed payloads are dropped silently: the piggyback is
        an optimization plane — losing one means a cache entry ages a
        little later via the next fold, never a wrong answer (entries
        only SERVE when the map matches what was recorded)."""
        if self.on_peer_epochs is None or headers is None:
            return
        raw = headers.get("X-Pilosa-View-Epochs")
        if not raw:
            return
        try:
            payload = json.loads(raw)
        except ValueError:
            return
        if isinstance(payload, dict) and payload.get("node"):
            self.on_peer_epochs(payload)

    # -- queries (reference http/client.go QueryNode :268) -----------------

    def query_node(
        self,
        uri: Union[URI, Node, str],
        index: str,
        query: str,
        shards: Optional[Sequence[int]] = None,
        remote: bool = True,
        bypass: bool = False,
    ) -> dict:
        path = f"/index/{index}/query"
        params = []
        if shards is not None:
            params.append("shards=" + ",".join(str(s) for s in shards))
        if remote:
            params.append("remote=true")
        if params:
            path += "?" + "&".join(params)
        # A coordinator-side X-Pilosa-Cache: bypass rides every remote
        # leg: peers consult their local result caches on remote
        # executions, so the always-fresh contract must cross the node
        # boundary like the deadline does.
        hdrs = {"X-Pilosa-Cache": "bypass"} if bypass else None
        out = self._do("POST", uri, path, query.encode(), content_type="text/plain",
                       op="query_node", extra_headers=hdrs)
        if "error" in out:
            raise ClientError(out["error"])
        return out

    # -- schema ------------------------------------------------------------

    def create_index(self, uri, index: str, options: Optional[dict] = None) -> None:
        body = json.dumps({"options": options or {}}).encode()
        self._do("POST", uri, f"/index/{index}", body, op="create_index")

    def create_field(self, uri, index: str, field: str, options: Optional[dict] = None) -> None:
        body = json.dumps({"options": options or {}}).encode()
        self._do("POST", uri, f"/index/{index}/field/{field}", body, op="create_field")

    def schema(self, uri) -> dict:
        return self._do("GET", uri, "/schema", op="schema")

    def status(self, uri) -> dict:
        return self._do("GET", uri, "/status", op="status")

    def max_shards(self, uri) -> dict:
        return self._do("GET", uri, "/internal/shards/max", op="max_shards")

    # -- imports (reference http/client.go Import/ImportRoaring) -----------

    def import_roaring(
        self,
        uri,
        index: str,
        field: str,
        shard: int,
        views: dict[str, bytes],
        clear: bool = False,
    ) -> None:
        from pilosa_tpu_torch.server.wire import ImportRoaringRequest, ImportRoaringRequestView

        req = ImportRoaringRequest(
            clear=clear,
            views=[ImportRoaringRequestView(name, data) for name, data in views.items()],
        )
        path = f"/index/{index}/field/{field}/import-roaring/{shard}?remote=true"
        self._do("POST", uri, path, req.to_bytes(), content_type="application/x-protobuf",
                 op="import_roaring")

    def import_bits(self, uri, index: str, field: str, shard: int,
                    row_ids: Sequence[int], column_ids: Sequence[int],
                    timestamps: Optional[Sequence] = None,
                    clear: bool = False) -> None:
        """Peer-routed import: always marked remote so the receiver applies
        locally instead of re-routing (reference api.go Import forwarding)."""
        from pilosa_tpu_torch.server.wire import ImportRequest

        req = ImportRequest(
            index=index, field=field, shard=shard,
            row_ids=list(row_ids), column_ids=list(column_ids),
            timestamps=[_ts_epoch(t) for t in timestamps] if timestamps else [],
        )
        path = f"/index/{index}/field/{field}/import?remote=true"
        if clear:
            path += "&clear=true"
        self._do("POST", uri, path, req.to_bytes(),
                 content_type="application/x-protobuf", op="import_bits")

    def import_values(self, uri, index: str, field: str, shard: int,
                      column_ids: Sequence[int], values: Sequence[int],
                      clear: bool = False) -> None:
        from pilosa_tpu_torch.server.wire import ImportValueRequest

        req = ImportValueRequest(
            index=index, field=field, shard=shard,
            column_ids=list(column_ids), values=list(values),
        )
        path = f"/index/{index}/field/{field}/import?remote=true"
        if clear:
            path += "&clear=true"
        self._do("POST", uri, path, req.to_bytes(),
                 content_type="application/x-protobuf", op="import_values")

    # -- fragment sync (reference http/client.go:591-780) ------------------

    def fragment_blocks(self, uri, index: str, field: str, view: str, shard: int) -> list[tuple[int, int, int]]:
        """[(block, checksum, epoch)] — epoch 0 when the peer predates
        the epoch plane (rolling upgrades: an absent field degrades the
        caller to union repair, never a directed wipe)."""
        out = self._do(
            "GET", uri,
            f"/internal/fragment/blocks?index={index}&field={field}&view={view}&shard={shard}",
            op="fragment_blocks",
        )
        return [
            (int(b["id"]), int(b["checksum"]), int(b.get("epoch", 0)))
            for b in out.get("blocks", [])
        ]

    def block_data(self, uri, index: str, field: str, view: str, shard: int, block: int) -> tuple[bytes, int]:
        """One block's bytes + the epoch of exactly those bytes
        (X-Pilosa-Block-Epoch, read with the data under one fragment
        lock on the serving side — a peer write between the checksum
        snapshot and this fetch would otherwise ship post-write data
        the syncer stamps with the pre-write epoch). Epoch 0 when the
        block is epoch-unknown or the peer predates the header."""
        out = self._do(
            "GET", uri,
            f"/internal/fragment/block/data?index={index}&field={field}&view={view}"
            f"&shard={shard}&block={block}",
            raw=True,
            op="block_data",
            want_headers=True,
        )
        data, headers = out
        epoch = 0
        raw_epoch = (headers.get("X-Pilosa-Block-Epoch") or "") if headers else ""
        try:
            epoch = int(raw_epoch)
        except ValueError:
            pass
        return data, epoch

    def retrieve_shard(self, uri, index: str, field: str, view: str, shard: int) -> bytes:
        """Whole-fragment roaring payload (reference RetrieveShardFromURI
        http/client.go:742, used by resize cluster.go:1297).

        Verified: the server stamps an
        X-Pilosa-Content-Checksum header and the payload is checked here
        BEFORE any caller can import_roaring it — a corrupt transfer
        raises code=checksum-mismatch so the resize fetcher retries /
        fails over instead of silently ingesting garbage. Peers too old
        to send the header skip verification (rolling-upgrade safe)."""
        import zlib

        out = self._do(
            "GET", uri,
            f"/internal/fragment/data?index={index}&field={field}&view={view}&shard={shard}",
            raw=True,
            op="retrieve_shard",
            want_headers=True,
        )
        data, headers = out
        want = (headers.get("X-Pilosa-Content-Checksum") or "") if headers else ""
        if want:
            got = f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"
            if got != want:
                # Same integrity class as an unparseable JSON body: the
                # bytes that arrived are not the bytes the peer meant.
                global_stats.with_tags(
                    f"peer:{peer_label(uri)}", "method:retrieve_shard",
                    "class:decode",
                ).count("peer_rpc_errors_total")
                raise ClientError(
                    f"fragment payload checksum mismatch from "
                    f"{peer_label(uri)}: got {got}, want {want}",
                    code="checksum-mismatch",
                )
        return data

    def repair_fragment(self, uri, index: str, field: str, view: str,
                        shard: int, blocks=None) -> int:
        """Ask a replica to run one targeted epoch-directed repair pass
        on its own copy of a fragment (the read-repair plane's fan-out).
        Returns the peer's repaired-block count."""
        body = json.dumps({
            "index": index, "field": field, "view": view,
            "shard": int(shard),
            "blocks": sorted(int(b) for b in blocks) if blocks else [],
        }).encode()
        out = self._do("POST", uri, "/internal/fragment/repair", body,
                       op="repair_fragment")
        return int(out.get("repaired", 0))

    def field_state(self, uri, index: str, field: str) -> dict:
        """Peer field state: view names + available shards (anti-entropy
        discovery; the reference ships this in NodeStatus gossip)."""
        return self._do(
            "GET", uri, f"/internal/field/state?index={index}&field={field}",
            op="field_state",
        )

    # -- attr sync (reference attr.go Blocks/BlockData) --------------------

    def attr_blocks(self, uri, index: str, field: Optional[str] = None) -> list[tuple[int, int]]:
        path = f"/internal/attr/blocks?index={index}"
        if field:
            path += f"&field={field}"
        out = self._do("GET", uri, path, op="attr_blocks")
        return [(int(b["id"]), int(b["checksum"])) for b in out.get("blocks", [])]

    def attr_block_data(self, uri, index: str, field: Optional[str], block: int) -> dict:
        path = f"/internal/attr/block/data?index={index}&block={block}"
        if field:
            path += f"&field={field}"
        out = self._do("GET", uri, path, op="attr_block_data")
        return {int(k): v for k, v in out.get("attrs", {}).items()}

    # -- control plane -----------------------------------------------------

    def send_message(self, uri, payload: bytes) -> None:
        self._do("POST", uri, "/internal/cluster/message", payload,
                 content_type="application/octet-stream", op="send_message")

    def export_csv_shard(self, uri, index: str, field: str, shard: int) -> str:
        """One shard's CSV from the node that holds it (whole-field
        export fans out through this; reference ctl/export.go)."""
        from urllib.parse import quote

        raw = self._do(
            "GET", uri,
            f"/export?index={quote(index)}&field={quote(field)}&shard={shard}",
            raw=True,
            op="export_csv_shard",
        )
        return raw.decode()

    # -- translation -------------------------------------------------------

    def translate_keys(self, uri, index: str, field: str, keys: Sequence[str]) -> list[int]:
        body = json.dumps({"index": index, "field": field, "keys": list(keys)}).encode()
        out = self._do("POST", uri, "/internal/translate/keys", body,
                       op="translate_keys")
        return [int(v) for v in out.get("ids", [])]

    def translate_data(self, uri, index: str, field: str = "", offset: int = 0) -> list:
        out = self._do(
            "GET", uri,
            f"/internal/translate/data?index={index}&field={field}&offset={offset}",
            op="translate_data",
        )
        return out.get("entries", [])

    # -- observability plane ------------------------------------

    def node_traces(self, uri, trace_id: str) -> list[dict]:
        """One node's local spans for a trace — the per-node leg of
        /debug/traces/<id> distributed assembly."""
        out = self._do("GET", uri, f"/internal/traces/{trace_id}",
                       op="node_traces")
        return out.get("spans", [])

    def metrics_text(self, uri) -> str:
        """One node's raw prometheus exposition — the federation scrape
        behind /metrics/cluster. ?exemplars=1 opts into the OpenMetrics
        exemplar suffixes so the re-tagged per-node series keep their
        trace links (the federation response strips them again for any
        scraper that didn't opt in itself)."""
        return self._do("GET", uri, "/metrics?exemplars=1", raw=True,
                        op="metrics_text").decode("utf-8", "replace")

    def debug_vars(self, uri) -> dict:
        """One node's expvar-style registry dump (/debug/cluster leg)."""
        return self._do("GET", uri, "/debug/vars", op="debug_vars")
