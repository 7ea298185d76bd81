"""The PQL executor (reference executor.go).

Entry point execute() mirrors the reference's flow (executor.go:113):
translate keys to ids, execute each top-level call (serially — later calls
may read earlier writes), translate result ids back to keys. Per-call
evaluation is delegated to a backend: the CUDA device backend's
whole-query programs by default, or the CPU oracle, whose per-shard calls
fold through map_reduce() (reference mapperLocal :2578). Single node: the
cluster mapper/router, the result cache and the cross-request batcher
come with the slices that port their owners.
"""

from __future__ import annotations

import datetime as dt
from dataclasses import dataclass
from typing import Any, Optional, Union


from pilosa_tpu_torch.core.cache import Pair, add_pairs, top_n_pairs
from pilosa_tpu_torch.core.field import FIELD_TYPE_BOOL, FIELD_TYPE_INT, FIELD_TYPE_TIME
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.timequantum import parse_time, views_by_time_range
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec.cpu import CPUBackend, NotFoundError, QueryError
from pilosa_tpu_torch.exec.result import (
    FieldRow,
    GroupCount,
    PairField,
    PairsField,
    RowIDs,
    ValCount,
    merge_group_counts,
)
from pilosa_tpu_torch.pql import Call, Condition, Query, parse_string
from pilosa_tpu_torch.pql.ast import is_reserved_arg, shape_key
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.deadline import check_deadline
from pilosa_tpu_torch.utils.qprofile import current_profile, profile_scope
from pilosa_tpu_torch.utils.stats import global_stats
from pilosa_tpu_torch.utils.tracing import global_tracer

MAX_INT = (1 << 63) - 1


@dataclass
class ExecOptions:
    """reference executor.go execOptions :2960."""

    remote: bool = False
    profile: bool = False
    exclude_row_attrs: bool = False
    exclude_columns: bool = False
    column_attrs: bool = False
    shards: Optional[list[int]] = None
    # Per-query result-cache bypass (HTTP `X-Pilosa-Cache: bypass`). The
    # port has no result cache yet, so there is nothing to bypass.
    cache_bypass: bool = False
    # Wire-bytes plumbing: when the caller provides a list, the executor
    # appends ONE item per result — the result-cache token, or None, as
    # always here with no result cache — so the serialization layer
    # encodes every result itself.
    wire_sink: Optional[list] = None


class Executor:
    """Single-node executor. `backend` defaults to the CUDA device backend
    on the card (which raises where there is none); the CPU oracle is
    chosen explicitly with ``backend=CPUBackend(holder)``."""

    def __init__(self, holder, backend=None):
        self.holder = holder
        if backend is None:
            from pilosa_tpu_torch.exec.cuda import CUDABackend

            backend = CUDABackend(holder)
        self.backend = backend
        # Observability (reference spans in Execute executor.go:114, stats
        # tags per index, and the long-query log api.go:1157).
        self.stats = global_stats
        self.tracer = global_tracer
        self.long_query_time: float = 60.0
        self.logger = None

    # ------------------------------------------------------------------
    # entry
    # ------------------------------------------------------------------

    def execute(
        self,
        index: str,
        query: Union[str, Query],
        shards: Optional[list[int]] = None,
        opt: Optional[ExecOptions] = None,
    ) -> list[Any]:
        # Query-lifecycle telemetry: reuse the caller's profile when one
        # is active, else own a fresh one.
        with profile_scope(
            index=index, query=query if isinstance(query, str) else ""
        ) as prof:
            return self._execute_profiled(index, query, shards, opt, prof)

    def _execute_profiled(
        self,
        index: str,
        query: Union[str, Query],
        shards: Optional[list[int]],
        opt: Optional[ExecOptions],
        prof,
    ) -> list[Any]:
        opt = opt or ExecOptions()
        # Deadline checks sit at the phase boundaries QueryProfile names:
        # work not yet started is the part worth abandoning.
        check_deadline("parse")
        if isinstance(query, str):
            with prof.phase("parse"):
                query = parse_string(query)
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        if opt.shards:
            shards = list(opt.shards)

        import time as _time

        t0 = _time.perf_counter()
        stats = self.stats.with_tags(f"index:{index}")
        results = []
        translate = self._needs_translation(idx)
        if query.calls and not prof.call:
            prof.call = query.calls[0].name
        if query.calls and prof.shape is None:
            # Per-shape cost accounting: a structure-only fingerprint of
            # the request. Cap at three calls / 200 chars — batch imports
            # can carry hundreds of calls and the table keys must stay
            # small.
            prof.shape = "; ".join(
                shape_key(c) for c in query.calls[:3]
            )[:200]

        with self.tracer.start_span("executor.Execute") as span:
            span.set_tag("index", index)
            calls = query.calls
            i = 0
            while i < len(calls):
                # A run of consecutive Count(bitmap) calls fuses into one
                # batched device dispatch — the serving-side batching that
                # makes multi-Count requests ride the pair-stats kernel
                # (reference runs calls serially, executor.go:231; counts
                # are reads, so batching preserves write ordering).
                run = 0
                if hasattr(self.backend, "count_batch"):
                    while (
                        i + run < len(calls)
                        and calls[i + run].name == "Count"
                        and len(calls[i + run].children) == 1
                    ):
                        run += 1
                if run > 1:
                    check_deadline("plan")
                    batch = calls[i : i + run]
                    stats.count("query_Count_total", run)
                    if not opt.remote:
                        with prof.phase("key_translate"):
                            batch = [
                                self._translate_call(idx, b)
                                if translate or b.has_str_args else b
                                for b in batch
                            ]
                    with self.tracer.start_span("executor.executeCountBatch"):
                        counts = self.backend.count_batch(
                            index,
                            [b.children[0] for b in batch],
                            self._shards(index, shards),
                        )
                    results.extend(int(v) for v in counts)
                    i += run
                    continue
                call = calls[i]
                check_deadline("plan")
                stats.count(f"query_{call.name}_total")
                # Remote (peer-issued) requests arrive pre-translated and
                # are returned raw; translation happens only at the
                # coordinator (reference executor.go:121-127).
                if not opt.remote and (translate or call.has_str_args):
                    with prof.phase("key_translate"):
                        call = self._translate_call(idx, call)
                check_deadline("device_dispatch")
                with self.tracer.start_span(f"executor.execute{call.name}"):
                    result = self.execute_call(index, call, shards, opt)
                if not opt.remote:
                    check_deadline("key_translate")
                    with prof.phase("key_translate"):
                        result = self._translate_result(idx, call, result)
                results.append(result)
                i += 1
            if opt.wire_sink is not None:
                opt.wire_sink.extend(None for _ in results)
            # Phase breakdown on the executor span.
            span.set_tag("qid", prof.qid)
            span.set_tag("phasesMs", prof.phases_ms())
        elapsed = _time.perf_counter() - t0
        stats.timing("execute_duration_seconds", elapsed)
        if elapsed > self.long_query_time and self.logger is not None:
            # reference api.go:1157 long-query log, with the phase
            # breakdown and the index's histogram p99.
            self.logger.printf(
                "%.3fs longQueryTime exceeded: %r [qid=%d %s%s]",
                elapsed, query, prof.qid, prof.phase_summary(),
                self._p99_context(index),
            )
        return results

    def _p99_context(self, index: str) -> str:
        """' p99=12.3ms' for the slow-query log: the index's interpolated
        execute-duration p99 from the cumulative histogram — never from a
        sample ring, so the context can't recency-bias toward the very
        outlier being logged. Empty on any failure: the log line must
        never be the thing that breaks."""
        try:
            from pilosa_tpu_torch.utils.stats import bucket_quantile

            snap = self.stats.histogram_snapshot()
            key = f'execute_duration_seconds{{index="{index}"}}'
            ent = snap.get(key)
            if ent is None:
                return ""
            p99 = bucket_quantile(ent["buckets"], 0.99)
            if p99 is None:
                return ""
            return f" p99={round(p99 * 1e3, 1)}ms"
        # lint: allow-except-exception(slow-log p99 context is display-only; a stats bug must not fail the query)
        except Exception:  # noqa: BLE001 — context is best-effort
            return ""

    # ------------------------------------------------------------------
    # key translation (reference executor.go translateCalls :2615)
    # ------------------------------------------------------------------

    @staticmethod
    def _needs_translation(idx) -> bool:
        """False when translation is a guaranteed identity for EVERY
        call against this index: no index keys, and no field with keys
        or bool type (the only per-field rewrites). Lets the hot path
        skip the whole per-call tree walk — at 16 Counts x 4 calls per
        request the walk itself was the top serving-CPU item even after
        the copy-on-write change."""
        if idx.options.keys:
            return True
        return any(
            f.options.keys or f.options.type == FIELD_TYPE_BOOL
            for f in idx.fields.values()
        )

    def _translate_call(self, idx, c: Call) -> Call:
        """Copy-on-write key translation: returns c UNCHANGED (shared —
        parsed trees are cached and served to concurrent requests, so
        the common keyless case must not copy or mutate) or a fresh
        Call with translated args. The per-request tree copy was ~13%
        of serving CPU before this."""
        col_key, row_key, field_name = None, None, None
        if c.name in ("Set", "Clear", "Row", "Range", "SetColumnAttrs", "ClearRow"):
            col_key = "_col"
            try:
                field_name = c.field_arg()
                row_key = field_name
            except ValueError:
                pass
        elif c.name == "SetRowAttrs":
            row_key = "_row"
            field_name = c.args.get("_field")
        elif c.name in ("Rows", "TopN"):
            field_name = c.args.get("_field")
            row_key = "previous"
            # Rows(f, column="key") translates the column arg too
            # (reference executor.go:2639-2642).
            if c.name == "Rows":
                col_key = "column"

        new_args = None
        if col_key and isinstance(c.args.get(col_key), str):
            if not idx.options.keys or idx.translate_store is None:
                raise QueryError(
                    "string 'col' value not allowed unless index 'keys' option enabled"
                )
            new_args = dict(c.args)
            new_args[col_key] = idx.translate_store.translate_key(c.args[col_key])

        if field_name:
            f = idx.field(field_name)
            if f is not None and row_key and row_key in c.args:
                val = c.args[row_key]
                if f.options.type == FIELD_TYPE_BOOL and isinstance(val, bool):
                    new_args = new_args if new_args is not None else dict(c.args)
                    new_args[row_key] = 1 if val else 0
                elif f.options.keys and isinstance(val, str):
                    if f.translate_store is None:
                        raise QueryError(f"field has no translate store: {field_name}")
                    new_args = new_args if new_args is not None else dict(c.args)
                    new_args[row_key] = f.translate_store.translate_key(val)
                elif f.options.keys and not isinstance(val, (str, Condition)):
                    raise QueryError(
                        "row value must be a string when field 'keys' option enabled"
                    )
        new_children = None
        for i, child in enumerate(c.children):
            nc = self._translate_call(idx, child)
            if nc is not child:
                if new_children is None:
                    new_children = list(c.children)
                new_children[i] = nc
        if new_args is None and new_children is None:
            return c
        return Call(
            c.name,
            new_args if new_args is not None else dict(c.args),
            new_children if new_children is not None else list(c.children),
        )

    def _translate_result(self, idx, c: Call, result: Any) -> Any:
        """ids -> keys on results (reference executor.go translateResults :2786)."""
        if isinstance(result, Row) and idx.options.keys and idx.translate_store is not None:
            cols = result.columns()
            result.keys = idx.translate_store.translate_ids(
                # lint: allow-hot-serialize(key translation necessarily builds one Python string per id; the id list is that lookup's input, not serialization output)
                cols.tolist()
            )
        if isinstance(result, PairsField):
            f = idx.field(result.field_name) if result.field_name else None
            if f is not None and f.options.keys and f.translate_store is not None:
                ks = f.translate_store.translate_ids([p.id for p in result.pairs])
                result.pairs = [
                    Pair(id=p.id, count=p.count, key=ks[i] or "")
                    for i, p in enumerate(result.pairs)
                ]
        if isinstance(result, RowIDs):
            field_name = c.args.get("field") or c.args.get("_field")
            f = idx.field(field_name) if field_name else None
            if f is not None and f.options.keys and f.translate_store is not None:
                ks = f.translate_store.translate_ids(list(result))
                result.keys = [k or "" for k in ks]
        if isinstance(result, PairField):
            f = idx.field(result.field_name) if result.field_name else None
            if f is not None and f.options.keys and f.translate_store is not None:
                result.pair = Pair(
                    id=result.pair.id,
                    count=result.pair.count,
                    key=f.translate_store.translate_id(result.pair.id) or "",
                )
        if isinstance(result, list) and result and isinstance(result[0], GroupCount):
            for gc in result:
                for fr in gc.group:
                    f = idx.field(fr.field)
                    if f is not None and f.options.keys and f.translate_store is not None:
                        fr.row_key = f.translate_store.translate_id(fr.row_id) or ""
        return result

    # ------------------------------------------------------------------
    # call dispatch (reference executor.go executeCall :274)
    # ------------------------------------------------------------------

    def execute_call(self, index: str, c: Call, shards: Optional[list[int]], opt: ExecOptions) -> Any:
        handlers = {
            "Sum": self._execute_sum,
            "Min": self._execute_min,
            "Max": self._execute_max,
            "MinRow": self._execute_min_row,
            "MaxRow": self._execute_max_row,
            "Count": self._execute_count,
            "TopN": self._execute_topn,
            "Rows": self._execute_rows,
            "GroupBy": self._execute_group_by,
        }
        if c.name in handlers:
            return handlers[c.name](index, c, self._shards(index, shards), opt)
        if c.name == "Clear":
            return self._execute_clear(index, c, opt)
        if c.name == "ClearRow":
            return self._execute_clear_row(index, c, self._shards(index, shards), opt)
        if c.name == "Store":
            return self._execute_store(index, c, self._shards(index, shards), opt)
        if c.name == "Set":
            return self._execute_set(index, c, opt)
        if c.name == "SetRowAttrs":
            return self._execute_set_row_attrs(index, c, opt)
        if c.name == "SetColumnAttrs":
            return self._execute_set_column_attrs(index, c, opt)
        if c.name == "Options":
            return self._execute_options(index, c, shards, opt)
        # default: bitmap call
        return self._execute_bitmap_call(index, c, self._shards(index, shards), opt)

    def _shards(self, index: str, shards: Optional[list[int]]) -> list[int]:
        if shards is not None:
            current_profile().shards = len(shards)
            return shards
        idx = self.holder.index(index)
        out = idx.available_shards_list()  # cached + read-only
        out = out if out else [0]
        # Route context for the /debug/queries ring + slow-query log
        # (ISSUE 16 satellite): every resolution path stamps the count.
        current_profile().shards = len(out)
        return out

    # ------------------------------------------------------------------
    # mapReduce (reference executor.go:2460; local form)
    # ------------------------------------------------------------------

    def map_reduce(self, index, shards, c, opt, map_fn, reduce_fn):
        """Serial local fold over the shard axis (reference mapperLocal,
        executor.go:2578)."""
        result = None
        for shard in shards:
            v = map_fn(shard)
            result = v if result is None else reduce_fn(result, v)
        return result

    def _host_routed(self, c) -> None:
        """Count a call that the executor's host iterator answers while the
        backend is a device backend (the backend lacks the lowering, the
        call's options have none, or the backend refused it), in
        cpu_routed_total{call}, as the backend counts the calls it routes
        to the CPU oracle itself."""
        if not isinstance(self.backend, CPUBackend):
            self.stats.with_tags(f"call:{c.name}").count("cpu_routed_total")

    # ------------------------------------------------------------------
    # bitmap calls
    # ------------------------------------------------------------------

    def _execute_bitmap_call(self, index, c, shards, opt) -> Row:
        # Device fast path: ONE program execution + readback for the whole
        # shard set (a per-shard loop is O(S^2) when each map_fn evaluates
        # the full resident stack).
        if hasattr(self.backend, "bitmap_call"):
            row = self.backend.bitmap_call(index, c, shards)
            return self._attach_row_attrs(index, c, row, opt)
        map_fn = lambda shard: self.backend.bitmap_call_shard(index, c, shard)

        def reduce_fn(a, b):
            a.merge(b)
            return a

        result = self.map_reduce(index, shards, c, opt, map_fn, reduce_fn)
        row = result if result is not None else Row()
        return self._attach_row_attrs(index, c, row, opt)

    def _attach_row_attrs(self, index, c, row, opt) -> Row:
        # Attach row attributes at the coordinator (reference
        # executor.go:348-380 executeBitmapCall attrs handling).
        if c.name in ("Row", "Range") and not opt.exclude_row_attrs and not opt.remote:
            try:
                field_name = c.field_arg()
            except ValueError:
                field_name = None
            if field_name is not None and not isinstance(c.args.get(field_name), Condition):
                idx = self.holder.index(index)
                f = idx.field(field_name) if idx else None
                row_id, ok = c.uint64_arg(field_name)
                if f is not None and ok and f.row_attr_store is not None:
                    row.attrs = f.row_attr_store.attrs(row_id)
        return row

    # ------------------------------------------------------------------
    # aggregates
    # ------------------------------------------------------------------

    def _filter_rows(self, index, c, shards):
        """shard -> the filter child's Row in that shard (None without a
        child). A backend with a whole-query bitmap_call evaluates the
        child once over the shard set and the result is split per shard;
        per-shard evaluation would run the whole resident stack once for
        every shard."""
        if not c.children:
            return lambda shard: None
        child = c.children[0]
        if hasattr(self.backend, "bitmap_call"):
            row = self.backend.bitmap_call(index, child, shards)
            return lambda shard: Row.from_segment(shard, row.shard_bitmap(shard))
        return lambda shard: self.backend.bitmap_call_shard(index, child, shard)

    def _execute_count(self, index, c, shards, opt) -> int:
        if len(c.children) != 1:
            raise QueryError("Count() only accepts a single bitmap input")
        # Device fast path: the whole scatter-gather collapses into fused
        # bitwise ops + popcount kernel (the device backend's count_shards).
        if hasattr(self.backend, "count_shards"):
            return int(self.backend.count_shards(index, c.children[0], shards))
        map_fn = lambda shard: self.backend.count_shard(index, c.children[0], shard)
        result = self.map_reduce(index, shards, c, opt, map_fn, lambda a, b: a + b)
        return int(result or 0)

    def _bsi_fast(self, kind, index, f, c, shards) -> Optional[ValCount]:
        """Device fast path for Sum/Min/Max when the backend has one.
        None = not lowerable; caller runs the map-reduce path."""
        if not hasattr(self.backend, kind):
            self._host_routed(c)
            return None
        filter_call = c.children[0] if c.children else None
        r = getattr(self.backend, kind)(index, f.name, shards, filter_call)
        if r is None:
            self._host_routed(c)
            return None
        val, cnt = r
        return ValCount(val, cnt) if cnt else ValCount()

    def _agg_field(self, index, c):
        field_name, ok = c.string_arg("field")
        if not ok:
            try:
                field_name = c.field_arg()
            except ValueError:
                raise QueryError("field required")
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx else None
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        return f

    def _execute_sum(self, index, c, shards, opt) -> ValCount:
        """reference executor.go executeSum :406."""
        f = self._agg_field(index, c)
        if len(c.children) > 1:
            raise QueryError("Sum() only accepts a single bitmap input")

        fast = self._bsi_fast("bsi_sum", index, f, c, shards)
        if fast is not None:
            return fast
        filter_of = self._filter_rows(index, c, shards)

        def map_fn(shard):
            filt = filter_of(shard)
            s, cnt = f.sum(filt, shard)
            return ValCount(s, cnt)

        def reduce_fn(a, b):
            return ValCount(a.val + b.val, a.count + b.count)

        out = self.map_reduce(index, shards, c, opt, map_fn, reduce_fn) or ValCount()
        if out.count == 0:
            return ValCount()
        return out

    def _execute_min(self, index, c, shards, opt) -> ValCount:
        f = self._agg_field(index, c)
        if len(c.children) > 1:
            raise QueryError("Min() only accepts a single bitmap input")

        fast = self._bsi_fast("bsi_min", index, f, c, shards)
        if fast is not None:
            return fast
        filter_of = self._filter_rows(index, c, shards)

        def map_fn(shard):
            filt = filter_of(shard)
            v, cnt = f.min(filt, shard)
            return ValCount(v, cnt)

        def reduce_fn(a, b):
            if a.count == 0:
                return b
            if b.count == 0:
                return a
            if a.val < b.val:
                return a
            if b.val < a.val:
                return b
            return ValCount(a.val, a.count + b.count)

        return self.map_reduce(index, shards, c, opt, map_fn, reduce_fn) or ValCount()

    def _execute_max(self, index, c, shards, opt) -> ValCount:
        f = self._agg_field(index, c)
        if len(c.children) > 1:
            raise QueryError("Max() only accepts a single bitmap input")

        fast = self._bsi_fast("bsi_max", index, f, c, shards)
        if fast is not None:
            return fast
        filter_of = self._filter_rows(index, c, shards)

        def map_fn(shard):
            filt = filter_of(shard)
            v, cnt = f.max(filt, shard)
            return ValCount(v, cnt)

        def reduce_fn(a, b):
            if a.count == 0:
                return b
            if b.count == 0:
                return a
            if a.val > b.val:
                return a
            if b.val > a.val:
                return b
            return ValCount(a.val, a.count + b.count)

        return self.map_reduce(index, shards, c, opt, map_fn, reduce_fn) or ValCount()

    def _minmax_row_fragments(self, index, c, shard):
        field_name = c.args.get("_field") or c.args.get("field")
        if not field_name:
            raise QueryError("MinRow/MaxRow requires field")
        idx = self.holder.index(index)
        f = idx.field(field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        v = f.view(VIEW_STANDARD)
        return v.fragment(shard) if v is not None else None

    def _execute_min_row(self, index, c, shards, opt) -> PairField:
        self._host_routed(c)
        filter_of = self._filter_rows(index, c, shards)

        def map_fn(shard):
            frag = self._minmax_row_fragments(index, c, shard)
            if frag is None:
                return PairField(Pair(0, 0), str(c.args.get("_field") or c.args.get("field") or ""))
            filt = filter_of(shard)
            row_id, cnt = frag.min_row(filt)
            return PairField(Pair(row_id, cnt), str(c.args.get("_field") or c.args.get("field") or ""))

        def reduce_fn(a, b):
            if a.pair.count == 0:
                return b
            if b.pair.count == 0:
                return a
            if a.pair.id < b.pair.id:
                return a
            if b.pair.id < a.pair.id:
                return b
            return PairField(Pair(a.pair.id, a.pair.count + b.pair.count), a.field_name)

        return self.map_reduce(index, shards, c, opt, map_fn, reduce_fn) or PairField(
            Pair(0, 0), str(c.args.get("_field") or c.args.get("field") or "")
        )

    def _execute_max_row(self, index, c, shards, opt) -> PairField:
        self._host_routed(c)
        filter_of = self._filter_rows(index, c, shards)

        def map_fn(shard):
            frag = self._minmax_row_fragments(index, c, shard)
            if frag is None:
                return PairField(Pair(0, 0), str(c.args.get("_field") or c.args.get("field") or ""))
            filt = filter_of(shard)
            row_id, cnt = frag.max_row(filt)
            return PairField(Pair(row_id, cnt), str(c.args.get("_field") or c.args.get("field") or ""))

        def reduce_fn(a, b):
            if a.pair.count == 0:
                return b
            if b.pair.count == 0:
                return a
            if a.pair.id > b.pair.id:
                return a
            if b.pair.id > a.pair.id:
                return b
            return PairField(Pair(a.pair.id, a.pair.count + b.pair.count), a.field_name)

        return self.map_reduce(index, shards, c, opt, map_fn, reduce_fn) or PairField(
            Pair(0, 0), str(c.args.get("_field") or c.args.get("field") or "")
        )

    # ------------------------------------------------------------------
    # TopN (two-pass, reference executor.go:860-997)
    # ------------------------------------------------------------------

    def _execute_topn(self, index, c, shards, opt) -> PairsField:
        field_name = c.args.get("_field")
        if not field_name:
            raise QueryError("TopN() field required")
        n, _ = c.uint64_arg("n")

        # Device fast path: exact single-pass TopN (popcount-per-row +
        # top_k) when no rank-cache-only options are in play.
        plain = not any(
            k in c.args for k in ("ids", "threshold", "tanimotoThreshold", "attrName")
        )
        if plain and hasattr(self.backend, "topn_field"):
            src_call = c.children[0] if c.children else None
            exact = self.backend.topn_field(index, field_name, shards, n, src_call)
            if exact is not None:
                return PairsField(exact, field_name)

        self._host_routed(c)
        # The source filter is evaluated once and serves both passes.
        filter_of = self._filter_rows(index, c, shards)
        # Pass 1: approximate candidates from rank caches.
        pairs = self._execute_topn_shards(index, c, shards, opt, filter_of)

        # Pass 2: exact recount of candidate ids (coordinator only).
        if n and not opt.remote and pairs.pairs:
            ids = [p.id for p in pairs.pairs]
            other = c.clone()
            other.args["ids"] = ids
            pairs = self._execute_topn_shards(index, other, shards, opt, filter_of)
        # Remote (per-node) responses stay untrimmed: a candidate's count
        # may be split across nodes, so only the coordinator may cut to n
        # (reference fragment.go:1574 forces N=0 under pinned ids).
        if not opt.remote:
            pairs.pairs = top_n_pairs(pairs.pairs, n)
        return pairs

    def _execute_topn_shards(self, index, c, shards, opt, filter_of) -> PairsField:
        field_name = c.args["_field"]
        n, _ = c.uint64_arg("n")
        ids, _ = c.uint64_slice_arg("ids")
        threshold, _ = c.uint64_arg("threshold")
        tanimoto, _ = c.uint64_arg("tanimotoThreshold")

        def map_fn(shard):
            idx = self.holder.index(index)
            f = idx.field(field_name)
            if f is None:
                raise NotFoundError(f"field not found: {field_name}")
            src = filter_of(shard)
            # With explicit ids (pass 2) or a src filter, never trim per
            # shard — a local top-n would drop cross-shard count
            # contributions before the merge (reference fragment.go:1574
            # forces N=0 when RowIDs are given).
            return f.top(
                shard,
                n=n if (src is None and not ids) else 0,
                src=src,
                row_ids=ids if ids else None,
                min_threshold=threshold,
                tanimoto_threshold=tanimoto,
            )

        def reduce_fn(a, b):
            return add_pairs(a, b)

        merged = self.map_reduce(index, shards, c, opt, map_fn, reduce_fn) or []
        return PairsField(top_n_pairs(merged, 0), field_name)

    # ------------------------------------------------------------------
    # Rows (reference executor.go:1274)
    # ------------------------------------------------------------------

    def _execute_rows(self, index, c, shards, opt) -> RowIDs:
        field_name = c.args.get("field") or c.args.get("_field")
        if not field_name:
            raise QueryError("Rows() field required")
        col, has_col = c.uint64_arg("column")
        if has_col:
            shards = [col // SHARD_WIDTH]
        limit = MAX_INT
        lim, has_lim = c.uint64_arg("limit")
        if has_lim:
            limit = lim

        # Device fast path (VERDICT r3 #5): unfiltered Rows served from
        # the backend's cached per-row counts vector — one (usually
        # cached) dispatch instead of a host fragment walk per shard.
        # Column pins and time ranges keep the host path (a column pin is
        # a single-shard membership probe; time ranges union quantum
        # views).
        if (
            not has_col
            and "from" not in c.args
            and "to" not in c.args
            and hasattr(self.backend, "rows_field")
        ):
            start = 0
            prev, has_prev = c.uint64_arg("previous")
            if has_prev:
                start = prev + 1
            ids = self.backend.rows_field(index, field_name, shards, start)
            if ids is not None:
                return RowIDs(ids[:limit] if has_lim else ids)

        self._host_routed(c)
        map_fn = lambda shard: self._execute_rows_shard(index, field_name, c, shard)

        def reduce_fn(a, b):
            return a.merge(b, limit)

        return self.map_reduce(index, shards, c, opt, map_fn, reduce_fn) or RowIDs()

    def _execute_rows_shard(self, index, field_name, c, shard) -> RowIDs:
        idx = self.holder.index(index)
        f = idx.field(field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        views = [VIEW_STANDARD]
        if f.options.type == FIELD_TYPE_TIME:
            from_t = parse_time(c.args["from"]) if "from" in c.args else None
            to_t = parse_time(c.args["to"]) if "to" in c.args else None
            if from_t is not None or to_t is not None:
                from_t = from_t or dt.datetime(1, 1, 1)
                to_t = to_t or (dt.datetime.utcnow() + dt.timedelta(days=1))
                views = views_by_time_range(
                    VIEW_STANDARD, from_t, to_t, f.options.time_quantum
                )

        start = 0
        prev, has_prev = c.uint64_arg("previous")
        if has_prev:
            start = prev + 1
        col, has_col = c.uint64_arg("column")
        limit, has_lim = c.uint64_arg("limit")

        out: set[int] = set()
        for vname in views:
            v = f.view(vname)
            if v is None:
                continue
            frag = v.fragment(shard)
            if frag is None:
                continue
            out.update(
                frag.rows(column=col if has_col else None, start_row=start, limit=0)
            )
        ids = sorted(out)
        if has_lim:
            ids = ids[:limit]
        return RowIDs(ids)

    # ------------------------------------------------------------------
    # GroupBy (reference executor.go:1068)
    # ------------------------------------------------------------------

    def _execute_group_by(self, index, c, shards, opt) -> list[GroupCount]:
        if not c.children:
            raise QueryError("need at least one child call")
        limit = MAX_INT
        lim, has_lim = c.uint64_arg("limit")
        if has_lim:
            limit = lim
        filter_call = c.args.get("filter")
        if filter_call is not None and not isinstance(filter_call, Call):
            raise QueryError("filter must be a call")

        # Pre-compute cluster-wide Rows results for children with limit or
        # column args (reference executor.go:1085-1117).
        child_rows: list[Optional[RowIDs]] = [None] * len(c.children)
        for i, child in enumerate(c.children):
            if child.name != "Rows":
                raise QueryError(
                    f"'{child.name}' is not a valid child query for GroupBy, must be 'Rows'"
                )
            _, has_l = child.uint64_arg("limit")
            _, has_c = child.uint64_arg("column")
            if has_l or has_c:
                child_rows[i] = self._execute_rows(index, child, shards, opt)
                if not child_rows[i]:
                    return []

        offset, has_off = c.uint64_arg("offset")
        if not has_off:
            offset = 0
        # Groups the merge must retain before the final offset/limit trim:
        # a per-shard iterator may stop after this many nonzero groups
        # (reference groupByIterator limit semantics, executor.go:3063).
        cap = limit + offset if has_lim else MAX_INT

        # Device fast path: the whole-query group-count tensor in ONE
        # program (exec/tpu.py group_by); falls back (None) to the
        # per-shard host iterator for anything not lowerable.
        if hasattr(self.backend, "group_by"):
            with self.tracer.start_span("executor.executeGroupByDevice"):
                results = self.backend.group_by(
                    index, c, filter_call, child_rows,
                    self._shards(index, shards),
                    # Enumeration may stop after cap nonzero groups: the
                    # executor's window is a prefix of odometer order,
                    # applied below (local) or by the coordinator
                    # (remote partials are capped-but-untrimmed).
                    cap=cap if has_lim else None,
                )
            if results is not None:
                if opt.remote:
                    # Partial for the coordinator's merge: cap, never
                    # offset — trimming here would double-apply the
                    # window and drop this node's counts for early
                    # groups.
                    return results[:cap] if has_lim else results
                if offset:
                    results = results[offset:]
                if has_lim:
                    results = results[:limit]
                return results

        map_fn = lambda shard: self._execute_group_by_shard(
            index, c, filter_call, shard, child_rows, cap
        )

        def reduce_fn(a, b):
            return merge_group_counts(a, b, cap)

        results = self.map_reduce(index, shards, c, opt, map_fn, reduce_fn) or []

        if opt.remote:
            # Remote partials return capped-but-untrimmed: the
            # coordinator merges counts across nodes first, THEN applies
            # the offset/limit window exactly once.
            return results
        if offset and offset < len(results):
            results = results[offset:]
        elif offset:
            results = []
        if has_lim and limit < len(results):
            results = results[:limit]
        return results

    def _execute_group_by_shard(
        self, index, c, filter_call, shard, child_rows, cap=MAX_INT
    ) -> list[GroupCount]:
        filter_row = None
        if filter_call is not None:
            filter_row = self.backend.bitmap_call_shard(index, filter_call, shard)

        # Per-child candidate (field, row_id, bitmap) lists.
        fields = []
        per_child: list[list[tuple[int, Row]]] = []
        for i, child in enumerate(c.children):
            field_name = child.args.get("field") or child.args.get("_field")
            fields.append(field_name)
            if child_rows[i] is not None:
                ids = list(child_rows[i])
            else:
                ids = list(self._execute_rows_shard(index, field_name, child, shard))
            rows = []
            for rid in ids:
                idx = self.holder.index(index)
                f = idx.field(field_name)
                row = f.row(rid, shard)
                rows.append((rid, row))
            per_child.append(rows)

        # Paginated iterator semantics (reference groupByIterator,
        # executor.go:3063-3236): enumerate groups in odometer order and
        # STOP after `cap` (= limit+offset) nonzero groups — per-shard
        # truncation is safe because every shard enumerates the same
        # global order, so the cross-shard merge of capped lists is a
        # prefix of the uncapped merge.
        out: list[GroupCount] = []

        def recurse(i: int, acc: Optional[Row], group: list[FieldRow]) -> bool:
            if i == len(per_child):
                cnt = acc.count() if acc is not None else 0
                if cnt > 0:
                    out.append(GroupCount(list(group), cnt))
                return len(out) < cap
            for rid, row in per_child[i]:
                nxt = row if acc is None else acc.intersect(row)
                if i > 0 or acc is not None:
                    if not nxt.any():
                        continue
                group.append(FieldRow(fields[i], rid))
                more = recurse(i + 1, nxt, group)
                group.pop()
                if not more:
                    return False
            return True

        recurse(0, filter_row, [])
        return out

    # ------------------------------------------------------------------
    # writes (reference executor.go:1825-2417)
    # ------------------------------------------------------------------

    def _execute_set(self, index, c, opt) -> bool:
        col_id, ok = c.uint64_arg("_col")
        if not ok:
            raise QueryError("Set() column argument 'col' required")
        field_name = c.field_arg()
        idx = self.holder.index(index)
        f = idx.field(field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")

        # Track column existence (reference executor.go:2101-2106).
        ef = idx.existence_field()
        if ef is not None:
            ef.set_bit(0, col_id)

        if f.options.type == FIELD_TYPE_INT:
            val, ok = c.int_arg(field_name)
            if not ok:
                raise QueryError("Set() row argument required")
            return f.set_value(col_id, val)

        row_id, ok = c.uint64_arg(field_name)
        if not ok:
            raise QueryError("Set() row argument required")
        timestamp = None
        ts = c.args.get("_timestamp")
        if isinstance(ts, str):
            timestamp = parse_time(ts)
        return f.set_bit(row_id, col_id, timestamp)

    def _execute_clear(self, index, c, opt) -> bool:
        col_id, ok = c.uint64_arg("_col")
        if not ok:
            raise QueryError("Clear() column argument 'col' required")
        field_name = c.field_arg()
        idx = self.holder.index(index)
        f = idx.field(field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        if f.options.type == FIELD_TYPE_INT:
            frag = f._bsi_fragment(col_id // SHARD_WIDTH)
            if frag is None:
                return False
            return frag.clear_value(col_id, f.options.bit_depth)
        row_id, ok = c.uint64_arg(field_name)
        if not ok:
            raise QueryError("Clear() row argument required")
        return f.clear_bit(row_id, col_id)

    def _execute_clear_row(self, index, c, shards, opt) -> bool:
        field_name = c.field_arg()
        idx = self.holder.index(index)
        f = idx.field(field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        if f.options.type not in ("set", "time", "mutex", "bool"):
            raise QueryError(f"ClearRow() is not supported on {f.options.type} fields")
        row_id, ok = c.uint64_arg(field_name)
        if not ok:
            raise QueryError("ClearRow() row argument required")

        def map_fn(shard):
            changed = False
            for vname, v in list(f.views.items()):
                frag = v.fragment(shard)
                if frag is not None:
                    changed = frag.clear_row(row_id) or changed
            return changed

        return bool(self.map_reduce(index, shards, c, opt, map_fn, lambda a, b: a or b))

    def _execute_store(self, index, c, shards, opt) -> bool:
        """Store(child, f=row): overwrite row with child's result
        (reference executeSetRow :2303)."""
        if len(c.children) != 1:
            raise QueryError("Store() requires a single row input")
        field_name = c.field_arg()
        idx = self.holder.index(index)
        f = idx.create_field_if_not_exists(field_name)
        if f.options.type != "set":
            raise QueryError("Store() currently only supports set fields")
        row_id, ok = c.uint64_arg(field_name)
        if not ok:
            raise QueryError("Store() row argument required")

        def map_fn(shard):
            row = self.backend.bitmap_call_shard(index, c.children[0], shard)
            frag = f.create_view_if_not_exists(VIEW_STANDARD).create_fragment_if_not_exists(shard)
            f.add_available_shard(shard)
            return frag.set_row(row, row_id)

        return bool(self.map_reduce(index, shards, c, opt, map_fn, lambda a, b: a or b))

    def _execute_set_row_attrs(self, index, c, opt) -> None:
        field_name = c.args.get("_field")
        idx = self.holder.index(index)
        f = idx.field(field_name)
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        row_id, ok = c.uint64_arg("_row")
        if not ok:
            raise QueryError("SetRowAttrs() row argument required")
        attrs = {k: v for k, v in c.args.items() if not is_reserved_arg(k)}
        f.row_attr_store.set_attrs(row_id, attrs)
        return None

    def _execute_set_column_attrs(self, index, c, opt) -> None:
        idx = self.holder.index(index)
        col_id, ok = c.uint64_arg("_col")
        if not ok:
            raise QueryError("SetColumnAttrs() column argument required")
        attrs = {k: v for k, v in c.args.items() if not is_reserved_arg(k)}
        idx.column_attr_store.set_attrs(col_id, attrs)
        return None

    # ------------------------------------------------------------------
    # Options (reference executeOptionsCall)
    # ------------------------------------------------------------------

    def _execute_options(self, index, c, shards, opt) -> Any:
        if len(c.children) != 1:
            raise QueryError("Options() requires a single child call")
        import copy

        new_opt = copy.copy(opt)
        for k, v in c.args.items():
            if k == "columnAttrs":
                new_opt.column_attrs = bool(v)
            elif k == "excludeRowAttrs":
                new_opt.exclude_row_attrs = bool(v)
            elif k == "excludeColumns":
                new_opt.exclude_columns = bool(v)
            elif k == "shards":
                if not isinstance(v, list):
                    raise QueryError("Options() shards must be a list")
                new_opt.shards = [int(s) for s in v]
            elif k == "profile":
                new_opt.profile = bool(v)
            else:
                raise QueryError(f"Unknown Options() argument: {k}")
        if new_opt.shards:
            shards = new_opt.shards
        return self.execute_call(index, c.children[0], shards, new_opt)
