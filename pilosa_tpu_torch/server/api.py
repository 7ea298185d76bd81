"""API facade (reference api.go:42).

Sits between the HTTP handler and the holder/executor/cluster: validates
cluster state per method (reference api.go:119 apiMethod validation),
performs import-side key translation and existence tracking, and exposes
schema CRUD. The cluster attribute is None in single-node mode; the
cluster layer injects itself to gate methods and route imports.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Optional

import numpy as np

from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import IndexOptions
from pilosa_tpu_torch.core.timequantum import parse_time
from pilosa_tpu_torch.exec import ExecOptions, Executor
from pilosa_tpu_torch.exec.cpu import QueryError
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.deadline import Deadline, deadline_scope


class APIError(Exception):
    def __init__(self, msg: str, status: int = 400, code: str = ""):
        super().__init__(msg)
        self.status = status
        # Machine-readable error class carried in the JSON body (additive
        # — the HTTP status stays reference-compatible). "not-found" lets
        # the cluster's missed-DDL repair distinguish a genuinely absent
        # index/field from a peer that lacks schema, without string
        # matching.
        self.code = code


class NotFoundError(APIError):
    def __init__(self, msg: str):
        super().__init__(msg, status=404, code="not-found")


class ConflictError(APIError):
    def __init__(self, msg: str):
        super().__init__(msg, status=409)


# Methods allowed in non-NORMAL cluster states (reference api.go:1343+).
_STATE_EXEMPT = {"Status", "ClusterMessage", "ResizeAbort", "SetCoordinator"}


class API:
    def __init__(self, holder: Holder, executor: Optional[Executor] = None, cluster=None):
        self.holder = holder
        self.executor = executor if executor is not None else Executor(holder)
        self.cluster = cluster  # wired by pilosa_tpu_torch/cluster
        # Memo for the encoded X-Pilosa-View-Epochs header: a bounded
        # tuple of (index, generation watermark at build, encoded
        # payload) entries so a coordinator serving remote legs for
        # several indexes doesn't thrash one slot. Rebuilt only when
        # ANY view/field minted since — between writes every remote leg
        # reuses the bytes instead of re-walking the schema +
        # re-encoding per request. An immutable tuple published by
        # plain assignment (the documented GIL-atomic swap idiom), so
        # concurrent query threads need no lock.
        self._epoch_header_memo: tuple = ()
        # Same memo for /status's ALL-index indexEpochs report (the
        # failure detector probes every peer ~1/s: between mints the
        # probe plane reuses the walk instead of re-paying it per probe
        # per peer). The memoized subtree is shared across responses —
        # consumers read it, never mutate. A schema object created
        # without a mint (bare field, no view yet) shows up one mint
        # late; that only delays a peer's cacheability (unknown field =
        # uncacheable), never serves stale.
        self._epoch_status_memo: tuple = (-1, None)
        # Set by the HTTP server once the listener is bound.
        self.local_host = "localhost"
        self.local_port = 10101
        self.local_scheme = "http"
        # Default per-query deadline in seconds when the client supplies
        # neither ?timeout= nor X-Pilosa-Deadline (config query-timeout).
        # 0 = no default budget.
        self.query_timeout = 0.0
        # SLO objectives ([{metric, quantile, threshold_s, window_s}],
        # config `slo`) and the RuntimeMonitor whose windowed histogram
        # snapshots /debug/slo evaluates them against. The CLI wires
        # both; a bare server lazily attaches an unstarted monitor on
        # first /debug/slo scrape.
        self.slo: list[dict] = []
        self.monitor = None
        # Deliberate load shedding (ROADMAP item 1 down payment): when
        # max_inflight_queries > 0, the HTTP layer admits at most that
        # many concurrent /query executions and answers the rest with
        # 429 + Retry-After + code=overloaded — the front door degrades
        # by contract, never by kernel reset. 0 = unbounded (default).
        self.max_inflight_queries = 0
        self._inflight_lock = threading.Lock()
        self._inflight_queries = 0
        # Write-side admission (mirroring the read
        # gate above): bounded in-flight import bytes + a pending-WAL
        # depth cap. Over either, imports are shed deliberately
        # (429/503 + Retry-After + code) — the node degrades by
        # contract, never by OOM. 0 = unbounded (defaults).
        self.max_import_bytes = 0
        self.max_pending_wal = 0
        self._import_lock = threading.Lock()
        self._import_inflight_bytes = 0
        # SLO-adaptive ingest derating (config
        # `ingest-derate`): when the attached monitor's derate ladder is
        # raised (read-latency objective burning), admit 1-in-2^level
        # imports and shed the rest with 429 + a Retry-After scaled to
        # the ladder — overload degrades the writer, not the readers.
        self.ingest_derate = True
        self._derate_seq = 0
        # Per-/query write-call cap (reference MaxWritesPerRequest,
        # config max-writes-per-request; cli.py wires it). 0 = no cap so
        # directly-constructed test APIs stay unbounded.
        self.max_writes_per_request = 0
        # `[metric] service` knob: "none" disables the /metrics
        # exposition endpoint (the in-process registry still accrues —
        # it feeds /debug/vars and the SLO plane).
        self.metric_service = "memory"

    # -- import admission (wired by server/http.py around /import) ---------

    def begin_import(self, nbytes: int):
        """Admit one import request of `nbytes` body bytes, or refuse:
        returns None when admitted (caller MUST call end_import(nbytes)
        in a finally block), else (status, code, reason[, retry_after])
        for the shed response. Sheds are counted as
        import_shed_total{reason} / import_derated_total{reason}."""
        from pilosa_tpu_torch.core.fragment import WAL_BACKLOG
        from pilosa_tpu_torch.utils.stats import global_stats

        if self.ingest_derate and self.monitor is not None:
            level = self.monitor.derate_level()
            if level > 0:
                with self._import_lock:
                    self._derate_seq += 1
                    admit = self._derate_seq % (1 << level) == 0
                if not admit:
                    # Deterministic 1-in-2^level counter (not random):
                    # a well-behaved writer retrying on Retry-After sees
                    # steady fractional admission, and the ingest-leg
                    # bench is reproducible. Retry-After scales with the
                    # ladder so backoff deepens as the burn persists.
                    global_stats.with_tags("reason:read-slo").count(
                        "import_derated_total"
                    )
                    return (
                        429,
                        "import-derated",
                        "read-slo",
                        float(1 << (level - 1)),
                    )
        if self.max_pending_wal > 0 and WAL_BACKLOG.ops > self.max_pending_wal:
            # The WAL/snapshot plane is behind: admitting more writes
            # only deepens the un-snapshotted backlog (and the recovery
            # replay a crash would pay). 503: retry after the background
            # snapshots drain, not after an in-flight request finishes.
            global_stats.with_tags("reason:wal-backlog").count(
                "import_shed_total"
            )
            return (503, "wal-backlog", "wal-backlog")
        with self._import_lock:
            over = (
                self.max_import_bytes > 0
                and self._import_inflight_bytes + nbytes > self.max_import_bytes
                # A single request larger than the whole cap must still
                # be admitted when nothing else is in flight, or it
                # could never succeed at any retry pace.
                and self._import_inflight_bytes > 0
            )
            if not over:
                self._import_inflight_bytes += nbytes
                global_stats.gauge(
                    "import_inflight_bytes", self._import_inflight_bytes
                )
                return None
        global_stats.with_tags("reason:inflight-bytes").count(
            "import_shed_total"
        )
        return (429, "import-overloaded", "inflight-bytes")

    def end_import(self, nbytes: int) -> None:
        from pilosa_tpu_torch.utils.stats import global_stats

        with self._import_lock:
            self._import_inflight_bytes = max(
                0, self._import_inflight_bytes - nbytes
            )
            global_stats.gauge(
                "import_inflight_bytes", self._import_inflight_bytes
            )

    # -- admission control (wired by server/http.py around /query) ---------

    def begin_query(self) -> bool:
        """Admit one query execution, or refuse (False) when the in-flight
        cap is reached. Callers that get True MUST call end_query() in a
        finally block. Exported as the http_inflight_queries gauge."""
        from pilosa_tpu_torch.utils.stats import global_stats

        # Gauge writes stay INSIDE the lock: written outside with a
        # captured count, two interleaved begin/end calls could publish
        # their snapshots out of order and leave the gauge wrong until
        # the next query. Lock order is always
        # _inflight_lock -> stats lock; nothing takes them reversed.
        with self._inflight_lock:
            if (
                self.max_inflight_queries > 0
                and self._inflight_queries >= self.max_inflight_queries
            ):
                return False
            self._inflight_queries += 1
            global_stats.gauge("http_inflight_queries", self._inflight_queries)
        return True

    def end_query(self) -> None:
        from pilosa_tpu_torch.utils.stats import global_stats

        with self._inflight_lock:
            self._inflight_queries -= 1
            global_stats.gauge("http_inflight_queries", self._inflight_queries)

    def _validate_state(self, method: str) -> None:
        if self.cluster is None or method in _STATE_EXEMPT:
            return
        state = self.cluster.state()
        if state not in ("NORMAL", "DEGRADED"):
            raise APIError(f"cluster is in state {state}", status=503)

    # -- query -------------------------------------------------------------

    def query_results(
        self,
        index: str,
        query: str,
        shards: Optional[list[int]] = None,
        column_attrs: bool = False,
        exclude_row_attrs: bool = False,
        exclude_columns: bool = False,
        remote: bool = False,
        cache_bypass: bool = False,
        wire_sink: Optional[list] = None,
    ) -> tuple[list[Any], list[dict]]:
        """Raw executor results + column attr sets (shared by the JSON and
        protobuf response encoders)."""
        self._validate_state("Query")
        from pilosa_tpu_torch.pql import ParseError

        if self.max_writes_per_request > 0:
            # reference api.go MaxWritesPerRequest: bound the write calls
            # one /query body may carry (Query.write_call_n existed for
            # this; the config-drift rule caught the knob parsed but
            # never enforced). Parse HERE, under the same profile phase
            # the executor would use, and hand the tree down — the
            # executor accepts pre-parsed queries, so a multi-kilobyte
            # write batch (too big for the parse cache) is still parsed
            # exactly once.
            from pilosa_tpu_torch.pql.parser import parse_string
            from pilosa_tpu_torch.utils.qprofile import current_profile

            try:
                with current_profile().phase("parse"):
                    parsed = parse_string(query)
            except ParseError as e:
                raise APIError(str(e)) from e
            writes = parsed.write_call_n()
            if writes > self.max_writes_per_request:
                raise APIError(
                    f"query contains {writes} write calls, over the "
                    f"max-writes-per-request cap "
                    f"({self.max_writes_per_request})",
                    status=400, code="too-many-writes",
                )
            query = parsed

        opt = ExecOptions(
            remote=remote,
            exclude_row_attrs=exclude_row_attrs,
            exclude_columns=exclude_columns,
            column_attrs=column_attrs,
            cache_bypass=cache_bypass,
            wire_sink=wire_sink,
        )
        from pilosa_tpu_torch.cluster.client import ClientError
        from pilosa_tpu_torch.cluster.cluster import ShardUnavailableError
        from pilosa_tpu_torch.utils.deadline import DeadlineExceeded

        from pilosa_tpu_torch.exec.cpu import NotFoundError as ExecNotFound

        try:
            results = self.executor.execute(index, query, shards=shards, opt=opt)
        except ExecNotFound as e:
            raise APIError(str(e), code="not-found") from e
        except (ParseError, QueryError, ValueError) as e:
            raise APIError(str(e)) from e
        except ShardUnavailableError as e:
            raise APIError(str(e), status=503, code="shard-unavailable") from e
        except DeadlineExceeded as e:
            # The query's budget ran out mid-execution: structured 504
            # (the HTTP layer adds Retry-After) — the abandoned legs stop
            # themselves via the propagated header.
            raise APIError(str(e), status=504, code="deadline-exceeded") from e
        except ClientError as e:
            code = getattr(e, "code", "")
            if code == "deadline-exceeded":
                raise APIError(str(e), status=504, code=code) from e
            if code == "replicas-unavailable":
                # The loud-failure invariant surfacing: every replica of
                # a written shard was down/circuit-broken.
                raise APIError(str(e), status=503, code=code) from e
            raise APIError(f"remote node error: {e}", status=502,
                           code="peer-error") from e
        attr_sets: list[dict] = []
        if column_attrs and not exclude_columns:
            attr_sets = self._column_attr_sets(index, results)
        return results, attr_sets

    def query(
        self,
        index: str,
        query: str,
        shards: Optional[list[int]] = None,
        column_attrs: bool = False,
        exclude_row_attrs: bool = False,
        exclude_columns: bool = False,
        remote: bool = False,
        cache_bypass: bool = False,
    ) -> dict[str, Any]:
        results, attr_sets = self.query_results(
            index, query, shards=shards, column_attrs=column_attrs,
            exclude_row_attrs=exclude_row_attrs,
            exclude_columns=exclude_columns, remote=remote,
            cache_bypass=cache_bypass,
        )
        from pilosa_tpu_torch.utils.deadline import DeadlineExceeded, check_deadline
        from pilosa_tpu_torch.utils.qprofile import current_profile

        try:
            check_deadline("serialize")
        except DeadlineExceeded as e:
            raise APIError(str(e), status=504, code="deadline-exceeded") from e
        with current_profile().phase("serialize"):
            out: dict[str, Any] = {
                "results": [
                    self._encode_result(r, exclude_columns) for r in results
                ]
            }
            if column_attrs and not exclude_columns:
                out["columnAttrSets"] = attr_sets
            return out

    def query_bytes(
        self,
        index: str,
        query: str,
        shards: Optional[list[int]] = None,
        column_attrs: bool = False,
        exclude_row_attrs: bool = False,
        exclude_columns: bool = False,
        remote: bool = False,
        cache_bypass: bool = False,
    ) -> bytes:
        """The serving path's JSON response body as BYTES (with trailing
        newline), byte-identical to json.dumps(self.query(...)) + "\\n"
        (pinned by tests/test_fastjson.py). Two collapses vs query()
: results encode through utils/fastjson's vectorized
        template fragments instead of tolist()+json.dumps, and a result-
        cache hit splices its entry's pre-encoded wire bytes straight
        into the envelope — hits skip `serialize` work entirely."""
        from pilosa_tpu_torch.utils import fastjson

        wire_sink: list = []
        results, attr_sets = self.query_results(
            index, query, shards=shards, column_attrs=column_attrs,
            exclude_row_attrs=exclude_row_attrs,
            exclude_columns=exclude_columns, remote=remote,
            cache_bypass=cache_bypass, wire_sink=wire_sink,
        )
        from pilosa_tpu_torch.utils.deadline import DeadlineExceeded, check_deadline
        from pilosa_tpu_torch.utils.qprofile import current_profile

        try:
            check_deadline("serialize")
        except DeadlineExceeded as e:
            raise APIError(str(e), status=504, code="deadline-exceeded") from e
        cache = getattr(self.executor, "rescache", None)
        flags = ("json", exclude_columns)
        with current_profile().phase("serialize"):
            frags: list[bytes] = []
            for i, r in enumerate(results):
                token = wire_sink[i] if i < len(wire_sink) else None
                frag = (
                    cache.wire_for(token, flags)
                    if cache is not None else None
                )
                if frag is None:
                    frag = fastjson.encode_result(r, exclude_columns)
                    if cache is not None and token is not None:
                        cache.attach_wire(token, flags, frag)
                frags.append(frag)
            return fastjson.response_body(
                frags,
                attr_sets if (column_attrs and not exclude_columns)
                else None,
            )

    def query_proto(self, index: str, query: str, **kw) -> bytes:
        """Protobuf QueryResponse (reference QueryResponse public.proto:66;
        Go client libraries speak this both ways)."""
        from pilosa_tpu_torch.server.wire import encode_query_response
        from pilosa_tpu_torch.utils.qprofile import current_profile

        results, attr_sets = self.query_results(index, query, **kw)
        with current_profile().phase("serialize"):
            return encode_query_response(results, attr_sets)

    def _encode_result(self, r: Any, exclude_columns: bool) -> Any:
        from pilosa_tpu_torch.core.row import Row
        from pilosa_tpu_torch.exec.result import result_to_json

        if isinstance(r, Row):
            out: dict[str, Any] = {"attrs": r.attrs or {}}
            if r.keys:
                out["keys"] = r.keys
            elif not exclude_columns:
                # lint: allow-hot-serialize(legacy dict path kept as the byte-compat oracle for query_bytes; tests diff the two)
                out["columns"] = r.columns().tolist()
            else:
                out["columns"] = []
            return out
        return result_to_json(r)

    def _column_attr_sets(self, index: str, results: list) -> list[dict]:
        from pilosa_tpu_torch.core.row import Row

        idx = self.holder.index(index)
        if idx is None or idx.column_attr_store is None:
            return []
        seen: set[int] = set()
        for r in results:
            if isinstance(r, Row):
                # lint: allow-hot-serialize(attr plane: the column set keys Python dict lookups into the attr store, not serialization)
                seen.update(int(c) for c in r.columns().tolist())
        out = []
        for col in sorted(seen):
            attrs = idx.column_attr_store.attrs(col)
            if attrs:
                out.append({"id": col, "attrs": attrs})
        return out

    # -- schema ------------------------------------------------------------

    def create_index(self, name: str, options: Optional[dict] = None) -> dict:
        self._validate_state("CreateIndex")
        options = options or {}
        opts = IndexOptions(
            keys=bool(options.get("keys", False)),
            track_existence=bool(options.get("trackExistence", True)),
        )
        try:
            idx = self.holder.create_index(name, opts)
        except ValueError as e:
            if "exists" in str(e):
                raise ConflictError(str(e)) from e
            raise APIError(str(e)) from e
        if self.cluster is not None:
            self.cluster.broadcast_schema()
        return {"name": name, "options": idx.options.to_dict()}

    def delete_index(self, name: str) -> None:
        self._validate_state("DeleteIndex")
        try:
            self.holder.delete_index(name)
        except KeyError as e:
            raise NotFoundError(f"index not found: {name}") from e
        if self.cluster is not None:
            self.cluster.broadcast_schema()

    def create_field(self, index: str, name: str, options: Optional[dict] = None) -> dict:
        self._validate_state("CreateField")
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        fo = self._field_options(options or {})
        try:
            f = idx.create_field(name, fo)
        except ValueError as e:
            if "exists" in str(e):
                raise ConflictError(str(e)) from e
            raise APIError(str(e)) from e
        if self.cluster is not None:
            self.cluster.broadcast_schema()
        return {"name": name, "options": f.options.to_dict()}

    @staticmethod
    def _field_options(o: dict) -> FieldOptions:
        from pilosa_tpu_torch.core import field as field_mod

        typ = o.get("type", "set")
        if typ == "set":
            fo = field_mod.options_for_set(
                o.get("cacheType", "ranked"), o.get("cacheSize", 50000)
            )
        elif typ == "int":
            fo = field_mod.options_for_int(o.get("min", 0), o.get("max", 0))
        elif typ == "time":
            fo = field_mod.options_for_time(
                o.get("timeQuantum", ""), o.get("noStandardView", False)
            )
        elif typ == "mutex":
            fo = field_mod.options_for_mutex(
                o.get("cacheType", "ranked"), o.get("cacheSize", 50000)
            )
        elif typ == "bool":
            fo = field_mod.options_for_bool()
        else:
            raise APIError(f"invalid field type: {typ}")
        fo.keys = bool(o.get("keys", False))
        return fo

    def delete_field(self, index: str, name: str) -> None:
        self._validate_state("DeleteField")
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        try:
            idx.delete_field(name)
        except KeyError as e:
            raise NotFoundError(f"field not found: {name}") from e
        if self.cluster is not None:
            self.cluster.broadcast_schema()

    def schema(self) -> dict:
        return {"indexes": self.holder.schema()}

    def apply_schema(self, schema: dict) -> None:
        """POST /schema: idempotent create of indexes+fields (reference
        api.go ApplySchema)."""
        for idx_def in schema.get("indexes", []):
            idx = self.holder.create_index_if_not_exists(
                idx_def["name"],
                IndexOptions(
                    keys=idx_def.get("options", {}).get("keys", False),
                    track_existence=idx_def.get("options", {}).get("trackExistence", True),
                ),
            )
            for f_def in idx_def.get("fields", []):
                if idx.field(f_def["name"]) is None:
                    idx.create_field(f_def["name"], self._field_options(f_def.get("options", {})))

    # -- imports -----------------------------------------------------------

    def import_bits(
        self,
        index: str,
        field: str,
        row_ids: list[int],
        column_ids: list[int],
        row_keys: Optional[list[str]] = None,
        column_keys: Optional[list[str]] = None,
        timestamps: Optional[list[int]] = None,
        clear: bool = False,
        remote: bool = False,
    ) -> None:
        """reference api.go Import :920 (key translation + shard routing +
        existence). remote=True marks a peer-routed request that must
        apply locally without re-routing."""
        self._validate_state("Import")
        from pilosa_tpu_torch.utils.stats import global_stats

        global_stats.with_tags(f"index:{index}", f"field:{field}").count(
            "import_bits_total", len(column_ids) or len(column_keys or [])
        )
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        f = idx.field(field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        if column_keys:
            if idx.translate_store is None:
                raise APIError("index does not use string keys")
            column_ids = idx.translate_store.translate_keys(column_keys)
        if row_keys:
            if f.translate_store is None:
                raise APIError("field does not use string keys")
            row_ids = f.translate_store.translate_keys(row_keys)
        if self.cluster is not None and not remote:
            from pilosa_tpu_torch.cluster.client import ClientError

            try:
                self._route_import(index, field, row_ids, column_ids,
                                   timestamps, clear)
            except ClientError as e:
                raise self._map_import_client_error(e) from e
            return
        rows = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(column_ids, dtype=np.uint64)
        ts = None
        if timestamps and any(timestamps):
            ts = [parse_time(t) if t else None for t in timestamps]
        try:
            f.import_bits(rows, cols, timestamps=ts, clear=clear)
        except ValueError as e:
            raise APIError(str(e)) from e
        ef = idx.existence_field()
        if ef is not None and not clear and cols.size:
            ef.import_bits(np.zeros(cols.size, dtype=np.uint64), cols)

    def import_values(
        self,
        index: str,
        field: str,
        column_ids: list[int],
        values: list[int],
        column_keys: Optional[list[str]] = None,
        clear: bool = False,
        remote: bool = False,
    ) -> None:
        self._validate_state("ImportValue")
        from pilosa_tpu_torch.utils.stats import global_stats

        global_stats.with_tags(f"index:{index}", f"field:{field}").count(
            "import_values_total", len(column_ids) or len(column_keys or [])
        )
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        f = idx.field(field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        if column_keys:
            if idx.translate_store is None:
                raise APIError("index does not use string keys")
            column_ids = idx.translate_store.translate_keys(column_keys)
        if self.cluster is not None and not remote:
            from pilosa_tpu_torch.cluster.client import ClientError

            try:
                self._route_import_values(index, field, column_ids, values,
                                          clear)
            except ClientError as e:
                raise self._map_import_client_error(e) from e
            return
        cols = np.asarray(column_ids, dtype=np.uint64)
        try:
            f.import_value(cols, np.asarray(values, dtype=np.int64), clear=clear)
        except ValueError as e:
            raise APIError(str(e)) from e
        ef = idx.existence_field()
        if ef is not None and not clear and cols.size:
            ef.import_bits(np.zeros(cols.size, dtype=np.uint64), cols)

    @staticmethod
    def _map_import_client_error(e) -> "APIError":
        """A fanned-out import leg's peer refusal, translated so the
        originating client sees the peer's backpressure contract —
        429/503/504 + Retry-After + code — instead of an opaque 500
        (remote legs propagate the budget like read legs do)."""
        code = getattr(e, "code", "")
        status = getattr(e, "status", 0)
        if code in ("import-overloaded", "overloaded") or status == 429:
            return APIError(str(e), status=429, code=code or "overloaded")
        if code in ("wal-backlog", "unavailable") or status == 503:
            return APIError(str(e), status=503, code=code or "unavailable")
        if code == "deadline-exceeded" or status == 504:
            return APIError(str(e), status=504, code="deadline-exceeded")
        return APIError(f"remote import error: {e}", status=502,
                        code="peer-error")

    # -- cluster import routing (reference api.go:920-1127: bits grouped by
    # shard, each group sent to every owning node) ------------------------

    def _owners_by_node(self, index: str, shards: set[int]):
        """node id -> (node, is_local, set of its shards), over replicas.

        DOWN or circuit-broken replicas are skipped exactly like the
        route_write path (anti-entropy delivers the import when they
        return) — previously one dead replica failed the WHOLE import
        with a 502, which made every import during a rolling restart an
        error instead of a degraded write. A shard with NO
        live owner still fails loudly: a silently dropped import is
        unrepairable."""
        topo = self.cluster.topology
        local_id = self.cluster.local_node.id
        out: dict[str, tuple] = {}
        for shard in shards:
            reps = topo.shard_nodes(index, shard)
            live = [
                n for n in reps
                if n.id == local_id or not self.cluster._peer_unwritable(n)
            ]
            if reps and not live:
                err = self.cluster._no_live_replica(index, shard)
                raise APIError(
                    str(err), status=503, code="replicas-unavailable"
                )
            for node in live:
                entry = out.setdefault(node.id, (node, node.id == local_id, set()))
                entry[2].add(shard)
        return out.values()

    def _route_import(self, index, field, row_ids, column_ids, timestamps, clear) -> None:
        from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

        shard_of = [c // SHARD_WIDTH for c in column_ids]
        for node, is_local, node_shards in self._owners_by_node(index, set(shard_of)):
            sel = [i for i, s in enumerate(shard_of) if s in node_shards]
            sub_rows = [row_ids[i] for i in sel]
            sub_cols = [column_ids[i] for i in sel]
            sub_ts = [timestamps[i] for i in sel] if timestamps else None
            if is_local:
                self.import_bits(index, field, sub_rows, sub_cols,
                                 timestamps=sub_ts, clear=clear, remote=True)
            else:
                self.cluster.client.import_bits(
                    node, index, field, 0, sub_rows, sub_cols,
                    timestamps=sub_ts, clear=clear,
                )

    def _route_import_values(self, index, field, column_ids, values, clear) -> None:
        from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

        shard_of = [c // SHARD_WIDTH for c in column_ids]
        for node, is_local, node_shards in self._owners_by_node(index, set(shard_of)):
            sel = [i for i, s in enumerate(shard_of) if s in node_shards]
            sub_cols = [column_ids[i] for i in sel]
            sub_vals = [values[i] for i in sel]
            if is_local:
                self.import_values(index, field, sub_cols, sub_vals,
                                   clear=clear, remote=True)
            else:
                self.cluster.client.import_values(
                    node, index, field, 0, sub_cols, sub_vals, clear=clear
                )

    def import_roaring(
        self, index: str, field: str, shard: int, views: dict[str, bytes],
        clear: bool = False, remote: bool = False,
    ) -> None:
        """reference api.go ImportRoaring :368."""
        self._validate_state("ImportRoaring")
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        f = idx.field(field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        if self.cluster is not None and not remote:
            from pilosa_tpu_torch.cluster.client import ClientError

            try:
                for node, is_local, _ in self._owners_by_node(index, {shard}):
                    if is_local:
                        self.import_roaring(index, field, shard, views,
                                            clear=clear, remote=True)
                    else:
                        self.cluster.client.import_roaring(
                            node, index, field, shard, views, clear=clear
                        )
            except ClientError as e:
                raise self._map_import_client_error(e) from e
            return
        for view_name, data in views.items():
            name = view_name or "standard"
            try:
                f.import_roaring(shard, data, view_name=name, clear=clear)
            except ValueError as e:
                raise APIError(str(e)) from e

    # -- resize (reference api.go:1193-1261) -------------------------------

    def _resizer(self):
        if self.cluster is None or self.cluster.resizer is None:
            raise APIError("cluster resize is not enabled", status=400)
        return self.cluster.resizer

    def _forward_to_coordinator(self, path: str, body: dict) -> dict:
        """Non-coordinator resize endpoints forward to the coordinator
        under one client-timeout deadline (deadline-scope rule): the
        serving thread must not pin on a hung coordinator past one
        budget, and the remaining budget rides X-Pilosa-Deadline."""
        coord = self.cluster.coordinator()
        with deadline_scope(Deadline(self.cluster.client.timeout)):
            return self.cluster.client._do(
                "POST", coord, path, json.dumps(body).encode()
            )

    def resize_add_node(self, body: dict) -> dict:
        """POST /cluster/resize/add-node {id?, uri}. Non-coordinators
        forward to the coordinator (reference routes joins there)."""
        from pilosa_tpu_torch.cluster.resize import ResizeError
        from pilosa_tpu_torch.cluster.topology import Node, URI

        rz = self._resizer()

        if not self.cluster.is_coordinator():
            return self._forward_to_coordinator(
                "/cluster/resize/add-node", body
            )
        uri = URI.parse(body.get("uri", ""))
        node_id = body.get("id") or f"node-{uri.host}-{uri.port}"
        try:
            job = rz.add_node(Node(id=node_id, uri=uri))
        except ResizeError as e:
            raise APIError(str(e), status=400) from e
        return {"job": job, "node": node_id}

    def resize_remove_node(self, node_id: str) -> dict:
        from pilosa_tpu_torch.cluster.resize import ResizeError

        rz = self._resizer()

        if not self.cluster.is_coordinator():
            return self._forward_to_coordinator(
                "/cluster/resize/remove-node", {"id": node_id}
            )
        try:
            job = rz.remove_node(node_id)
        except ResizeError as e:
            raise APIError(str(e), status=400) from e
        return {"job": job, "node": node_id}

    def resize_abort(self) -> None:
        self._validate_state("ResizeAbort")
        rz = self._resizer()
        if not self.cluster.is_coordinator():
            self._forward_to_coordinator("/cluster/resize/abort", {})
            return
        rz.abort()

    def set_coordinator(self, node_id: str) -> dict:
        """POST /cluster/coordinator {id} — manual coordinator move /
        failover (reference api.go:1193-1261 SetCoordinator). Applied
        locally and broadcast best-effort; nodes that miss it converge
        via the failure detector's piggybacked view merge. Works when
        the OLD coordinator is dead — that is the point."""
        if self.cluster is None:
            raise APIError("not clustered", status=400)
        from pilosa_tpu_torch.cluster import broadcast as bc

        if self.cluster.topology.node_by_id(node_id) is None:
            raise APIError(f"node not in cluster: {node_id}", status=400)
        msg = bc.Message.make(bc.MSG_SET_COORDINATOR, id=node_id)
        self.cluster.apply_message(msg)
        self.cluster.broadcaster.send_async(msg)
        return {"coordinator": node_id}

    # -- info --------------------------------------------------------------

    def status(self) -> dict:
        nodes = (
            self.cluster.nodes_json()
            if self.cluster is not None
            else [{"id": "local",
                   "uri": {"scheme": self.local_scheme, "host": self.local_host,
                           "port": self.local_port},
                   "isCoordinator": True, "state": "READY"}]
        )
        out = {
            "state": self.cluster.state() if self.cluster is not None else "NORMAL",
            "nodes": nodes,
            "localID": self.cluster.node_id if self.cluster is not None else "local",
        }
        if self.cluster is not None and self.cluster.resizer is not None:
            # A follower frozen mid-resize reports the job it is frozen
            # on; a promoted coordinator's probes read this and abort the
            # orphan for it.
            rz = self.cluster.resizer.follower_status()
            if rz:
                out["resize"] = rz
        if self.cluster is not None:
            # View-epoch piggyback on the probe plane: the failure
            # detector polls /status every
            # ~interval second, so every peer's epoch map advances even
            # for indexes no fan-out has touched — this is what bounds
            # the clustered result cache's staleness window for writes
            # that never route through the coordinator. Memoized on the
            # generation watermark (read BEFORE the walk, same protocol
            # as view_epochs_header) so idle probes don't re-walk the
            # schema.
            from pilosa_tpu_torch.core.view import BOOT_ID, generation_watermark

            wm = generation_watermark()
            got_wm, got_indexes = self._epoch_status_memo
            if got_wm != wm or got_indexes is None:
                got_indexes = self.view_epochs_payload()["indexes"]
                if generation_watermark() == wm:
                    # Same torn-walk discipline as view_epochs_header:
                    # a walk a mint landed inside ships once, unmemoized.
                    self._epoch_status_memo = (wm, got_indexes)
            out["indexEpochs"] = got_indexes
            out["indexEpochsBoot"] = BOOT_ID
        return out

    def view_epochs_header(self, index: str) -> str:
        """Encoded X-Pilosa-View-Epochs value for one index, memoized on
        the process-wide generation watermark: the watermark is read
        BEFORE the walk and re-checked AFTER, so a memo hit proves
        nothing minted since the stored payload was assembled (no
        staleness, the piggyback's synchronous write-invalidation
        contract holds). A walk the re-check catches a mint inside may
        be TORN (one view's generation read pre-mint, another's post) —
        it still ships (the very mint that tore it will raise the
        watermark and the next report supersedes), but it must never be
        memoized: a torn payload under a settled watermark would serve
        the stale generation until the next mint anywhere."""
        from pilosa_tpu_torch.core.view import generation_watermark

        wm = generation_watermark()
        memo = self._epoch_header_memo
        for got_index, got_wm, got_enc in memo:
            if got_index == index and got_wm == wm:
                return got_enc
        enc = json.dumps(
            self.view_epochs_payload(index), separators=(",", ":")
        )
        if generation_watermark() != wm:
            return enc  # possibly torn: usable once, never memoized
        # Keep other indexes' entries that are still current (a mint
        # anywhere obsoletes every entry), newest first, bounded.
        self._epoch_header_memo = ((index, wm, enc),) + tuple(
            e for e in memo if e[0] != index and e[1] == wm
        )[:7]
        return enc

    def view_epochs_payload(self, index: Optional[str] = None) -> dict:
        """This node's view-epoch report ({"node", "indexes": {index:
        {field: {"structure": int, "views": {view: generation}}}}}) for
        one index or all — the X-Pilosa-View-Epochs piggyback body and
        the /status indexEpochs field. Generations come from the
        wall-seeded process counter (core/view.py), so values are
        unique across restarts and peers compare them by equality."""
        names = [index] if index is not None else list(self.holder.indexes)
        indexes: dict = {}
        for iname in names:
            idx = self.holder.index(iname)
            if idx is None:
                continue
            fields: dict = {}
            for fname in list(idx.fields):
                f = idx.field(fname)
                if f is None:
                    continue
                fields[fname] = {
                    "structure": f.structure_version,
                    "views": {
                        vname: v.generation
                        for vname, v in sorted(list(f.views.items()))
                    },
                }
            indexes[iname] = fields
        from pilosa_tpu_torch.core.view import BOOT_ID

        return {
            "node": self.cluster.node_id if self.cluster is not None else "local",
            # Incarnation token: lets the fold guard tell "this node
            # restarted" (accept the fresh report even if its max
            # generation is lower — a post-clock-step reboot mints
            # below the previous life) from "this report is older".
            "boot": BOOT_ID,
            "indexes": indexes,
        }

    def info(self) -> dict:
        import os

        return {
            "shardWidth": SHARD_WIDTH,
            "cpuPhysicalCores": os.cpu_count(),
            "cpuLogicalCores": os.cpu_count(),
        }

    def max_shards(self) -> dict:
        out = {}
        for name in self.holder.indexes:
            idx = self.holder.index(name)
            av = idx.available_shards()
            out[name] = int(av.max()) if av.any() else 0
        return {"standard": out}

    def recalculate_caches(self) -> None:
        for idx in self.holder.indexes.values():
            for f in idx.fields.values():
                for v in f.views.values():
                    for frag in v.fragments.values():
                        frag.cache.invalidate()

    def export_csv(self, index: str, field: str, shard: Optional[int] = None) -> str:
        """reference handler.go handleGetExport / ctl/export.go.

        shard=None exports the WHOLE field cluster-wide: local fragments stream directly; shards this node
        doesn't hold are fetched from a live owner with the shard pinned
        (the reference's ctl/export.go per-shard loop, server side).
        Keyed indexes/fields export keys, not ids (api.go:591)."""
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        f = idx.field(field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        if shard is not None:
            return self._export_shard_local(idx, f, shard)
        parts = []
        # lint: allow-hot-serialize(export walks the schema-sized shard inventory, off the serving path)
        for s in f.available_shards().to_array().tolist():
            s = int(s)
            v = f.view("standard")
            if v is not None and v.fragment(s) is not None:
                parts.append(self._export_shard_local(idx, f, s))
                continue
            if self.cluster is None:
                # Unclustered: an available shard with no local fragment
                # has no bits in this field's standard view — nothing to
                # export for it.
                continue
            from pilosa_tpu_torch.cluster.client import ClientError
            from pilosa_tpu_torch.cluster.topology import NODE_STATE_DOWN

            owners = [
                n
                for n in self.cluster.topology.shard_nodes(index, s)
                if n.id != self.cluster.node_id
                and n.state != NODE_STATE_DOWN
            ]
            got = None
            last_err = None
            for owner in owners:  # every live replica before giving up
                try:
                    # Per-attempt budget (deadline-scope rule): the
                    # remote leg rides X-Pilosa-Deadline so a replica
                    # that stalls mid-export is abandoned after one
                    # client timeout and the next replica is tried.
                    with deadline_scope(Deadline(self.cluster.client.timeout)):
                        got = self.cluster.client.export_csv_shard(
                            owner, index, field, s
                        )
                    break
                except ClientError as e:
                    last_err = e
            if got is None:
                # NEVER return a silently partial export — an operator
                # treats the CSV as a complete backup.
                raise APIError(
                    f"shard {s} unavailable for export "
                    f"({len(owners)} live owner(s); last error: {last_err})",
                    status=503,
                )
            parts.append(got)
        return "".join(parts)

    def _export_shard_local(self, idx, f, shard: int) -> str:
        v = f.view("standard")
        frag = v.fragment(shard) if v is not None else None
        if frag is None:
            return ""
        row_tr = f.translate_store if f.options.keys else None
        col_tr = idx.translate_store if idx.options.keys else None
        row_keys: dict[int, str] = {}
        col_keys: dict[int, str] = {}

        def fmt(tr, cache, id_) -> str:
            k = cache.get(id_)
            if k is None:
                k = tr.translate_id(id_)
                cache[id_] = k if k is not None else str(id_)
                k = cache[id_]
            return k

        lines = []
        if row_tr is None and col_tr is None:
            frag.for_each_bit(lambda r, c: lines.append(f"{r},{c}"))
        else:
            frag.for_each_bit(
                lambda r, c: lines.append(
                    f"{fmt(row_tr, row_keys, r) if row_tr else r},"
                    f"{fmt(col_tr, col_keys, c) if col_tr else c}"
                )
            )
        return "\n".join(lines) + ("\n" if lines else "")
