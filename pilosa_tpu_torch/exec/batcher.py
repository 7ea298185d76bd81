"""Shard-leg batching plane: cross-request coalescing of device launches
(the JAX package's exec/batcher.py, its imports rewritten).

Concurrent queries' device legs (Count runs, bitmap Row/Intersect/Union
resolves, BSI Sum/Min/Max, TopN per-row counts) are enqueued as typed LEG
descriptors, and a drain groups compatible legs by (kind, index, shard
set) so that ONE backend call answers the whole group: count legs
concatenate into one count_batch_async (the pair-stats sweep, or one K11
launch per (spec, blocks) group over its distinct slots), row legs into
one row_batch_async (K11's slab mode, chunked under the device-memory
cap), and identical BSI and TopN legs dedupe to one call.

Scheduling is a leader/follower backpressure loop: the first submitter
becomes leader and dispatches its batch IMMEDIATELY (no coalescing sleep:
an uncontended single leg pays no added latency); legs arriving while the
leader's dispatch is in flight queue behind the leadership flag and drain
as the NEXT batch (by a detached helper thread, so the leader's own
response returns as soon as its leg resolves). Batching therefore emerges
from backpressure: the longer a dispatch and its readback take, the larger
the coalesced batches, with no idle window on a quiet server. `window > 0`
restores a fixed coalescing sleep for tests that need deterministic batch
composition. The leader and the helper threads each launch on the stack's
device and that thread's current stream (ops/kernels.py _launch), and each
resolver reads back on the thread that launched, after its launches.

Coalescing strategy per kind:
- count: every group's calls concatenate into one backend
  count_batch_async.
- row: calls share one row_batch_async; identical calls dedupe to one
  slot.
- bsi_sum/bsi_min/bsi_max and topn: identical legs (same field + filter
  tree) dedupe to ONE backend call (the concurrent-hot-query case), and
  the backend's epoch caches make the deduped call itself usually a host
  hit.

Telemetry: each dispatched group observes its occupancy (legs per
coalesced launch GROUP) into the `batch_occupancy{kind=...}` histogram and
counts `batch_legs_total{kind=...}` / `batch_coalesced_total{kind=...}`;
the backend counts every program it runs as
`device_launches_total{kind=...}`. A group usually maps to one launch,
but heterogeneous specs or a byte-capped row group fan one group into
several, so compare batch_legs_total against device_launches_total for
the exact coalescing ratio. Followers attribute their whole cost to the
`batch_wait` profile phase; the leader's dispatch work self-attributes
(`device_dispatch` et al.) inside the backend calls it makes on behalf of
the batch.

Error isolation: a failed group dispatch retries each member leg
individually, so one client's bad query (unknown field, unsupported
shape) errors only that client, never the whole window. Only Exception is
absorbed into the retry path; KeyboardInterrupt/SystemExit in the drain
thread propagates after waiters are released.

The reference has no analog: the Go engine executes each request's calls
serially per connection (executor.go:231) because its per-shard loop is
already CPU-parallel. On the card a launch and its readback cost more
than the sweep of a small query, so coalescing across requests is what
lets the serving path reach the batched kernels' throughput.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from pilosa_tpu_torch.utils.locks import InstrumentedLock
from pilosa_tpu_torch.utils.qprofile import current_profile
from pilosa_tpu_torch.utils.stats import global_stats
from pilosa_tpu_torch.utils.threads import spawn

#: Leg kinds the plane coalesces. count/row/topn legs are built only by
#: their own submit methods; bsi() takes the kind as an argument and
#: validates it against the bsi_ subset below.
LEG_KINDS = ("count", "row", "bsi_sum", "bsi_min", "bsi_max", "topn")


class _Leg:
    """One enqueued shard-leg: a typed descriptor plus its rendezvous."""

    __slots__ = ("kind", "index", "shards", "payload", "event", "result",
                 "error", "explain", "explain_rec")

    def __init__(self, kind: str, index: str, shards, payload):
        self.kind = kind
        self.index = index
        self.shards = shards  # tuple — part of the group key
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        # EXPLAIN: the submitter's plan leg-sink, captured at
        # construction ON THE SUBMITTING THREAD so the leader can
        # attribute this leg's group record into the right plan. None
        # when the submitter carries no plan (the common case) — the
        # batching plane then allocates nothing.
        ex = getattr(current_profile(), "explain", None)
        self.explain = ex.leg_sink() if ex is not None else None
        self.explain_rec: Optional[dict] = None


class ShardLegBatcher:
    """Leader/follower backpressure batcher over the device backend's
    batched entry points (count_batch_async / row_batch_async /
    bsi_* / topn_field).

    window > 0 restores the fixed coalescing sleep before each drain
    (useful for tests that need deterministic batch composition); the
    production default is 0 — see module docstring.
    """

    def __init__(self, backend, window: float = 0.0):
        self.backend = backend
        self.window = window
        self._lock = InstrumentedLock("batcher_drain")
        self._pending: list[_Leg] = []
        self._leader_active = False
        self.stats = global_stats
        # EXPLAIN group ids: process-unique per batcher, so two legs of
        # one query showing the same id PROVES they shared a drain
        # group (itertools.count: GIL-atomic, no lock).
        self._group_ids = itertools.count(1)

    # -- public submit API (one method per leg kind) -----------------------

    def count(self, index: str, calls: list, shards: list[int]) -> list[int]:
        """Block until the batch containing these Count calls resolves;
        returns one count per call. Thread-safe; any thread may become
        leader."""
        return self._submit(_Leg("count", index, tuple(shards), list(calls)))

    def row(self, index: str, call, shards: list[int]):
        """Bitmap materialization (Row/Intersect/Union/... resolve):
        returns the merged Row for the shard set."""
        return self._submit(_Leg("row", index, tuple(shards), call))

    def bsi(self, kind: str, index: str, field_name: str, shards: list[int],
            filter_call=None):
        """BSI aggregate (kind: bsi_sum | bsi_min | bsi_max). Returns the
        backend's (value, count) tuple, or None when not lowerable (the
        executor then runs its map-reduce path)."""
        if kind not in LEG_KINDS or not kind.startswith("bsi_"):
            raise ValueError(f"unknown bsi leg kind: {kind!r}")
        return self._submit(
            _Leg(kind, index, tuple(shards), (field_name, filter_call))
        )

    def topn(self, index: str, field_name: str, shards: list[int], n: int,
             src_call=None):
        """Exact TopN pairs (or None when not device-servable). The
        backend computes the FULL ranked vector once per unique
        (field, src) leg; n trims per submitter at scatter time, so
        TopN(n=5) and TopN(n=50) on the same field share one launch."""
        pairs = self._submit(
            _Leg("topn", index, tuple(shards), (field_name, src_call))
        )
        if pairs is None:
            return None
        return pairs[:n] if n else list(pairs)

    # -- leader/follower drain ---------------------------------------------

    def _submit(self, leg: _Leg):
        with self._lock:
            self._pending.append(leg)
            am_leader = not self._leader_active
            if am_leader:
                self._leader_active = True
        if am_leader:
            self._drain(leader_call=True)
        # Telemetry: a follower's whole cost is this wait (the leader's
        # dispatch work self-attributes inside the backend calls); for
        # the leader the event is already set and the phase is ~0.
        with current_profile().phase("batch_wait"):
            leg.event.wait()
        if leg.error is not None:
            raise leg.error
        return leg.result

    def _drain(self, leader_call: bool) -> None:
        """Serve queued batches. A leader (client thread) serves exactly
        ONE batch — its own leg resolves in it — then hands any queue
        that built up during the round trip to a detached helper thread,
        so under sustained load the first client's HTTP response is not
        held open serving everyone else's batches. The
        helper loops until the queue is empty; leadership is released
        under the lock, so a concurrent submitter either sees pending
        work claimed or becomes the next leader itself — never neither."""
        if leader_call and self.window > 0:
            # Optional fixed coalescing window before the leader's first
            # (only) drain; helper threads never sleep — the device round
            # trip itself is their window.
            time.sleep(self.window)
        while True:
            with self._lock:
                batch = self._pending
                self._pending = []
                if not batch:
                    self._leader_active = False
                    return
            try:
                self._serve(batch)
            except BaseException:
                # KeyboardInterrupt/SystemExit (or a bug in _serve): free
                # the waiters — INCLUDING followers already queued behind
                # this leadership, who would otherwise wait forever with
                # no leader — and release leadership before propagating.
                err = RuntimeError("shard-leg batch leader interrupted")
                with self._lock:
                    stranded = self._pending
                    self._pending = []
                    self._leader_active = False
                for leg in batch + stranded:
                    if not leg.event.is_set():
                        leg.error = err
                        leg.event.set()
                raise
            if leader_call:
                with self._lock:
                    if not self._pending:
                        self._leader_active = False
                        return
                spawn("batcher-leader", self._drain, args=(False,))
                return

    # -- batch service ------------------------------------------------------

    def _serve(self, batch: list[_Leg]) -> None:
        """Group the drained window by (kind, index, shard set), dispatch
        every async-capable group BEFORE resolving any (the card runs the
        launches back to back while the host waits on the first readback), then run the
        synchronous groups and scatter results back by leg."""
        groups: dict[tuple, list[_Leg]] = {}
        for leg in batch:
            groups.setdefault((leg.kind, leg.index, leg.shards), []).append(leg)
        pending = []  # (legs, resolver) for async kinds
        sync_groups = []
        for (kind, index, shards), legs in groups.items():
            self._observe_group(kind, legs)
            if kind == "count":
                pending.append((legs, self._dispatch_count(index, shards, legs)))
            elif kind == "row":
                pending.append((legs, self._dispatch_row(index, shards, legs)))
            else:
                sync_groups.append((kind, index, shards, legs))
        # Synchronous kinds (bsi_*/topn) run AFTER every async dispatch is
        # in flight, so their host/cache work overlaps the device round
        # trips instead of serializing ahead of them.
        for kind, index, shards, legs in sync_groups:
            self._serve_sync(kind, index, shards, legs)
        for legs, resolver in pending:
            if resolver is None:
                continue  # already resolved individually by the dispatcher
            try:
                resolver()
            except Exception:
                # Shared-launch resolution failed: visible on /metrics,
                # then isolate so one bad query can't fail the window.
                self.stats.with_tags(f"kind:{legs[0].kind}").count(
                    "batch_dispatch_errors_total"
                )
                self._resolve_individually(legs)

    def _observe_group(self, kind: str, legs: list[_Leg]) -> None:
        st = self.stats.with_tags(f"kind:{kind}")
        st.count("batch_legs_total", len(legs))
        if len(legs) > 1:
            st.count("batch_coalesced_total", len(legs) - 1)
        # Occupancy histogram: legs per coalesced launch group (unit:
        # legs, not seconds — the shared bucket set covers 1..100 with
        # 5 buckets/decade; the mean from _sum/_count is exact).
        st.timing("batch_occupancy", float(len(legs)))
        if any(leg.explain is not None for leg in legs):
            occ = len(legs)
            gid = next(self._group_ids)
            bucket = 1 if occ <= 1 else 1 << (occ - 1).bit_length()
            for leg in legs:
                if leg.explain is None:
                    continue
                rec = {
                    "group": gid,
                    "kind": kind,
                    "occupancy": occ,
                    "occupancyBucket": bucket,
                    "shards": len(leg.shards),
                }
                leg.explain.append(rec)
                leg.explain_rec = rec

    # -- count legs ---------------------------------------------------------

    def _dispatch_count(self, index, shards, legs):
        all_calls = [c for leg in legs for c in leg.payload]
        try:
            resolver = self.backend.count_batch_async(
                index, all_calls, list(shards)
            )
        except Exception:
            self.stats.with_tags("kind:count").count(
                "batch_dispatch_errors_total"
            )
            self._resolve_individually(legs)
            return None

        def resolve():
            values = resolver()
            off = 0
            for leg in legs:
                n = len(leg.payload)
                leg.result = [int(v) for v in values[off : off + n]]
                off += n
                leg.event.set()

        return resolve

    # -- row legs -----------------------------------------------------------

    def _dispatch_row(self, index, shards, legs):
        try:
            resolver = self.backend.row_batch_async(
                index, [leg.payload for leg in legs], list(shards)
            )
        except Exception:
            self.stats.with_tags("kind:row").count(
                "batch_dispatch_errors_total"
            )
            self._resolve_individually(legs)
            return None

        def resolve():
            rows = resolver()
            for leg, row in zip(legs, rows):
                leg.result = row
                leg.event.set()

        return resolve

    # -- synchronous kinds (bsi aggregates, topn) ---------------------------

    def _serve_sync(self, kind, index, shards, legs) -> None:
        """Dedupe identical legs (same field + same filter tree object —
        parse-cached trees make repeated hot queries literally identical)
        to one backend call each; every member leg of a dedupe set gets
        the shared immutable result."""
        by_payload: dict[tuple, list[_Leg]] = {}
        for leg in legs:
            field_name, filt = leg.payload
            by_payload.setdefault((field_name, id(filt) if filt is not None else None), []).append(leg)
        for (field_name, _fid), members in by_payload.items():
            filt = members[0].payload[1]
            for leg in members:
                if leg.explain_rec is not None:
                    # Slot-dedupe outcome: `shared` means this leg rode
                    # another identical leg's backend call.
                    leg.explain_rec["dedupe"] = (
                        "shared" if len(members) > 1 else "unique"
                    )
            try:
                if kind == "topn":
                    # n=0: the full ranked vector — submitters trim in
                    # topn() so different n's share the launch.
                    result = self.backend.topn_field(
                        index, field_name, list(shards), 0, filt
                    )
                else:
                    result = getattr(self.backend, kind)(
                        index, field_name, list(shards), filt
                    )
            except Exception as e:  # noqa: BLE001 — delivered to waiters
                for leg in members:
                    leg.error = e
                    leg.event.set()
                continue
            for leg in members:
                leg.result = result
                leg.event.set()

    # -- error isolation ----------------------------------------------------

    def _resolve_individually(self, legs: list[_Leg]) -> None:
        """Group dispatch failed — isolate: one dispatch per leg so only
        the offending client sees the error."""
        for leg in legs:
            try:
                if leg.kind == "count":
                    resolver = self.backend.count_batch_async(
                        leg.index, leg.payload, list(leg.shards)
                    )
                    leg.result = [int(v) for v in resolver()]
                elif leg.kind == "row":
                    leg.result = self.backend.bitmap_call(
                        leg.index, leg.payload, list(leg.shards)
                    )
                else:  # bsi_*/topn legs retry through _serve_sync directly
                    self._serve_sync(
                        leg.kind, leg.index, leg.shards, [leg]
                    )
                    continue
            except Exception as e:  # noqa: BLE001 — delivered to waiter
                leg.error = e
            leg.event.set()


#: Backward-compatible name: the plane grew out of the Count-only
#: coalescer and every wiring site (cli, bench, tests) used this name.
CountBatcher = ShardLegBatcher
