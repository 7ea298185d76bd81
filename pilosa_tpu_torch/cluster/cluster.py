"""Cluster runtime: scatter-gather mapReduce, write replication, control
messages (reference cluster.go:186 + executor.go:2419-2613).

A Cluster binds a local node into a Topology and installs two seams on
the Executor:

- ``mapper`` — the distributed mapReduce. Shards are grouped by owning
  node (reference shardsByNode executor.go:2440); local shards run
  through the backend in-process, one per-shard call each (on the device
  backend, one launch over that shard's slab of the resident stacks),
  remote groups become one QueryNode HTTP call each with shards pinned
  and remote=true (reference remoteExec :2419), which the peer answers
  on its own backend, batcher and result cache. Responses
  stream-reduce as they arrive; a failed node is filtered out and its
  shards re-split across remaining replicas (reference :2497-2507).
- ``router`` — write replication. Set/Clear apply on every replica of
  the target shard (reference executeSetBitField :2096-2135); attribute
  writes fan to all nodes (attr stores are fully replicated).
"""

from __future__ import annotations

import itertools
import queue
import random
import time
import threading

import numpy as np
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from pilosa_tpu_torch.cluster import broadcast as bc
from pilosa_tpu_torch.cluster.broadcast import HTTPBroadcaster, Message, NopBroadcaster
from pilosa_tpu_torch.cluster.client import ClientError, InternalClient
from pilosa_tpu_torch.cluster.topology import (
    NODE_STATE_DOWN,
    NODE_STATE_READY,
    Node,
    STATE_DEGRADED,
    STATE_NORMAL,
    Topology,
)
from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.exec.result import (
    FieldRow,
    GroupCount,
    PairField,
    RowIDs,
    ValCount,
)
from pilosa_tpu_torch.utils.threads import spawn


class ShardUnavailableError(Exception):
    """No live node owns a shard (reference errShardUnavailable)."""


@dataclass
class _MapResponse:
    node: Node
    shards: list[int]
    result: Any = None
    err: Optional[Exception] = None
    # Leg identity for hedged reads: the gather loop accepts a response
    # only while its shard set is still unreduced, so a hedge's loser is
    # discarded instead of double-reduced.
    leg: int = 0
    attempt: int = 1


class Cluster:
    def __init__(
        self,
        local_node: Node,
        topology: Topology,
        holder=None,
        client: Optional[InternalClient] = None,
        use_broadcast: bool = True,
        state: str = STATE_NORMAL,
    ):
        self.local_node = local_node
        self.topology = topology
        self.holder = holder
        self.client = client or InternalClient()
        self._state = state
        self._state_lock = threading.RLock()
        self.executor = None
        self.broadcaster = (
            HTTPBroadcaster(self, self.client) if use_broadcast else NopBroadcaster()
        )
        # Seams the resize/anti-entropy layers hook (set by attach_* below).
        self.resizer = None
        self.api = None
        self.logger = None
        # Control messages that failed to broadcast; retried by the sync
        # daemon (a dropped DDL/shard broadcast must not be
        # silently lost). Entries are [msg, attempts, next_due]: a
        # message that keeps failing backs off exponentially (capped,
        # jittered) instead of re-hammering dead peers every sync pass.
        self._pending_msgs: list[list] = []
        self._pending_lock = threading.Lock()
        # Schema-repair throttle per (node, index): a query naming a
        # genuinely nonexistent field must not trigger a schema push +
        # duplicate remote execution on every query. Entries
        # expire after repair_retry_interval (a permanent throttle would
        # disable the NotFound repair the moment one bad-field query came
        # through); cleared on membership change or successful repair.
        self._repair_attempted: dict[tuple[str, str], float] = {}
        # Guards the throttle's check-then-arm: scatter-gather worker
        # threads race each other (and the membership-change clear) on
        # the same (node, index) key, and an unguarded get-then-set
        # would let N concurrent queries all start repair pushes
        # (shared-state rule).
        self._repair_lock = threading.Lock()
        self.repair_retry_interval: float = 30.0
        # Hedged shard reads: a remote leg that
        # hasn't answered after this many seconds is re-launched at the
        # next live replica, first result wins. 0 disables. The CLI wires
        # the `hedge-delay` config; the default here is off so direct
        # Cluster constructions (tests, embedders) opt in explicitly.
        self.hedge_delay: float = 0.0
        # Monotonic leg ids for the hedged gather (shared across
        # concurrent map_shards calls; uniqueness is all that matters).
        self._leg_ids = itertools.count(1)
        # Path of the persisted-topology file:
        # when set (the CLI points it at <data-dir>/.topology), every
        # durable membership change — CLUSTER_STATUS node lists,
        # coordinator moves — rewrites it atomically so a restarting
        # node rejoins with its same identity and a full-cluster restart
        # reconverges without operator re-seeding.
        self.topology_file: Optional[str] = None
        self._topology_file_lock = threading.Lock()
        # Read-path divergence monitor (cluster/consistency.py): when
        # wired, a hedge race's two answers are
        # handed over for a background checksum diff + targeted repair.
        self.divergence = None
        # Per-peer view-epoch map: node id ->
        # {index -> {field -> {"structure": int, "views": {view: gen}}}}
        # folded from X-Pilosa-View-Epochs piggybacks on internal RPC
        # responses (remote query legs, replica writes) and from the
        # failure detector's /status probes. The clustered coordinator's
        # result cache keys fan-out answers on this map — see
        # rescache_peer_epochs below.
        self._peer_epochs: dict[str, dict] = {}
        self._peer_epochs_lock = threading.Lock()
        # Shard-set -> covering-peer memo for the provider's hot path
        # (one topology walk per distinct shard tuple, not per lookup);
        # invalidated wholesale on any membership change. Both the memo
        # and the generation it keys on share the peer-epoch lock.
        self._owners_memo: dict = {}
        self._topo_gen = 0
        # held_shards' memo: (membership, {index: (shards, held shards)}).
        self._held_cache: tuple = ((), {})

    def persist_topology(self) -> None:
        """Best-effort atomic rewrite of the topology file; a failed
        persist is logged (the live cluster keeps working — the file
        only matters at the NEXT boot). Serialized: during a failover
        the broadcast handler and the failure detector both persist, and
        two writers sharing the one tmp file would interleave into torn
        JSON — losing the identity the file exists to preserve."""
        if not self.topology_file:
            return
        from pilosa_tpu_torch.cluster.topology import save_topology

        epoch = 0
        if self.resizer is not None:
            # The resize epoch survives coordinator restarts through the
            # same file, so a rebooted coordinator's fresh jobs can never
            # reuse a dead job's (job, epoch) identity.
            epoch = self.resizer._epoch
        try:
            with self._topology_file_lock:
                save_topology(
                    self.topology_file, self.topology, self.local_node.id,
                    resize_epoch=epoch,
                )
        except OSError as e:
            self._log("topology persist to %s failed: %s", self.topology_file, e)

    # -- wiring ------------------------------------------------------------

    def attach(self, executor, api=None) -> None:
        """Install the cluster seams on an executor + holder + API."""
        self.executor = executor
        executor.mapper = self.map_shards
        executor.router = self
        self.api = api
        if hasattr(executor.backend, "held_shards"):
            # The device backend stacks only the shards this node holds.
            executor.backend.held_shards = self.held_shards
        if self.holder is not None:
            self.holder.broadcast_shard = self._on_local_new_shard
        # Peer view-epoch piggybacks fold into this node's epoch map
        # — and when a result cache is wired,
        # the provider below is what lets a CLUSTERED coordinator
        # consult it: fan-out answers key on the merged (local + peer)
        # epoch vector instead of being uncacheable.
        self.client.on_peer_epochs = self.fold_peer_epochs
        if getattr(executor, "rescache", None) is not None:
            executor.rescache.peer_epochs_provider = self.rescache_peer_epochs
        # Keyed translation routes through the coordinator primary.
        from pilosa_tpu_torch.cluster.sync import wrap_translate_stores

        wrap_translate_stores(self)

    def held_shards(self, index: str, shards) -> tuple:
        """The shards among ``shards`` that this node owns under the
        current topology, memoized per membership (the topology is updated
        in place) and per index on the identity of ``shards`` (the index's
        available-shards list, one object while its shard set is
        unchanged): the same tuple object until either moves."""
        topo = self.topology
        members = (tuple(n.id for n in topo.nodes), topo.replica_n)
        cache = self._held_cache
        if cache[0] != members:
            cache = self._held_cache = (members, {})
        got = cache[1].get(index)
        if got is None or got[0] is not shards:
            local_id = self.local_node.id
            got = cache[1][index] = (
                shards, tuple(s for s in shards if topo.owns_shard(local_id, index, s)))
        return got[1]

    def attach_resizer(self, logger=None):
        """Install the resize state machine (cluster/resize.py)."""
        from pilosa_tpu_torch.cluster.resize import Resizer

        return Resizer(self, logger or self.logger)

    def _log(self, fmt: str, *args) -> None:
        if self.logger is not None:
            self.logger.printf(fmt, *args)

    # -- identity / state --------------------------------------------------

    @property
    def node_id(self) -> str:
        return self.local_node.id

    def state(self) -> str:
        with self._state_lock:
            return self._state

    def set_state(self, state: str) -> None:
        with self._state_lock:
            changed = state != self._state
            self._state = state
        if changed:
            # NORMAL<->DEGRADED<->RESIZING transitions on /metrics: a
            # wedged resize shows up as a RESIZING transition with no
            # matching NORMAL, next to a flatlined migration gauge.
            from pilosa_tpu_torch.utils.stats import global_stats

            global_stats.with_tags(f"state:{state}").count(
                "cluster_state_transitions_total"
            )

    def is_coordinator(self) -> bool:
        return self.local_node.is_coordinator

    def coordinator(self) -> Optional[Node]:
        for n in self.topology.nodes:
            if n.is_coordinator:
                return n
        return self.topology.nodes[0] if self.topology.nodes else None

    def node_status(self) -> dict:
        """This node's schema + per-field available shards — the
        NodeStatus a joiner ships so the cluster learns what data it
        already holds (reference gossip LocalState/MergeRemoteState,
        gossip.go:321-362)."""
        status: dict = {"schema": {"indexes": []}, "available": {}}
        if self.holder is not None:
            status["schema"] = {"indexes": self.holder.schema()}
            for iname in list(self.holder.indexes):
                idx = self.holder.index(iname)
                if idx is None:
                    continue
                fields = {}
                for fname in list(idx.fields):
                    f = idx.field(fname)
                    if f is not None:
                        shards = f.available_shards().to_array().tolist()
                        if shards:
                            fields[fname] = [int(s) for s in shards]
                if fields:
                    status["available"][iname] = fields
        return status

    def merge_node_status(self, status: dict) -> None:
        """Apply a peer's NodeStatus: schema union + available shards
        (reference mergeRemoteState → holder schema/availableShards)."""
        if not status:
            return
        if self.api is not None and status.get("schema"):
            self.api.apply_schema(status["schema"])
            from pilosa_tpu_torch.cluster.sync import wrap_translate_stores

            wrap_translate_stores(self)
        from pilosa_tpu_torch.roaring import Bitmap

        for iname, fields in status.get("available", {}).items():
            idx = self.holder.index(iname) if self.holder else None
            if idx is None:
                continue
            for fname, shards in fields.items():
                f = idx.field(fname)
                if f is not None and shards:
                    # Bulk union + ONE persist (field.go:274 analog) —
                    # per-shard add_available_shard would rewrite the
                    # bitmap file once per shard inside the message
                    # handler.
                    bm = Bitmap()
                    bm.add_many(
                        np.array([int(s) for s in shards], dtype=np.uint64),
                        log=False,
                    )
                    f.merge_remote_available_shards(bm)

    def join_cluster(
        self, coordinator_uri, timeout: float = 60.0, announce_every: float = 2.0
    ) -> bool:
        """Dynamic membership (reference gossip join →
        listenForJoins cluster.go:1063-1141): announce this node to the
        coordinator with a JOIN node event carrying our NodeStatus, then
        wait for the resize machinery to deliver schema + fragments and
        flip the topology (MSG_CLUSTER_STATUS) to include us. Re-announces
        until membership lands or the timeout expires. Returns True once
        this node is a member of a multi-node topology."""
        msg = Message.make(
            bc.MSG_NODE_EVENT,
            event=bc.EVENT_JOIN,
            node=self.local_node.to_json(),
            status=self.node_status(),
        )
        deadline = time.monotonic() + timeout
        # Failed announces retry on capped jittered exponential backoff
        # (the fixed interval hammered a coordinator
        # that was mid-restart exactly when it could least absorb it):
        # 0.25 s doubling to a cap, each interval jittered 0.5-1.5x so a
        # fleet of rebooting joiners doesn't retry in lockstep. A
        # successful send re-asserts at the steady announce_every pace
        # (membership may still take a resize to land) and resets the
        # backoff.
        backoff = 0.25
        cap = max(4 * announce_every, 8.0)
        next_announce = 0.0
        attempt = 0
        while time.monotonic() < deadline:
            member = any(
                n.id == self.local_node.id for n in self.topology.nodes
            ) and len(self.topology.nodes) > 1
            if member and self.state() == STATE_NORMAL:
                self._log(
                    "joined cluster: %d nodes (%d announce attempts)",
                    len(self.topology.nodes), attempt,
                )
                return True
            if time.monotonic() >= next_announce:
                attempt += 1
                try:
                    # Through the broadcaster so the announce gets the
                    # per-peer JSON wire fallback too — a JSON-only
                    # coordinator mid-rolling-upgrade must still accept
                    # a new build's join.
                    self.broadcaster.send_to(coordinator_uri, msg)
                    backoff = 0.25
                    interval = announce_every
                except Exception as e:  # noqa: BLE001 — keep re-announcing
                    interval = backoff
                    backoff = min(backoff * 2, cap)
                    self._log(
                        "join announce attempt %d failed (retry in ~%.2fs): %s",
                        attempt, interval, e,
                    )
                next_announce = time.monotonic() + interval * (
                    0.5 + random.random()
                )
            time.sleep(0.05)
        self._log("join timed out after %d announce attempts", attempt)
        return False

    def nodes_json(self) -> list[dict]:
        return [n.to_json() for n in self.topology.nodes]

    def shard_nodes_json(self, index: str, shard: int) -> list[dict]:
        return [n.to_json() for n in self.topology.shard_nodes(index, shard)]

    # -- peer view-epoch plane ----------------------

    @staticmethod
    def _merge_report(stored: dict, new: dict) -> dict:
        """Per-view monotone merge of two same-incarnation reports: the
        new snapshot is the base (additions adopted), but no individual
        stored generation may regress — the report walk on the peer is
        lock-free, so a report can be TORN (one view read pre-mint,
        another post), and a per-report max guard alone would let a
        torn report with a high max fold a regressed view generation
        back over a newer one, re-validating a cache entry a
        synchronous write invalidation already killed. Generations are
        per-process monotone, so per-view max is exact. (A view deleted
        within one incarnation lingers as a ghost at its last
        generation until the peer restarts — it can never change again,
        so an equality-compared signature through it is stable, never
        stale.)"""
        out = dict(new)
        for fname, old_f in stored.items():
            new_f = out.get(fname)
            if not isinstance(old_f, dict):
                continue
            if not isinstance(new_f, dict):
                out[fname] = old_f
                continue
            merged = dict(new_f)
            old_s, new_s = old_f.get("structure"), new_f.get("structure")
            if isinstance(old_s, int) and (
                not isinstance(new_s, int) or old_s > new_s
            ):
                merged["structure"] = old_s
            old_v = old_f.get("views")
            if isinstance(old_v, dict):
                new_v = merged.get("views")
                mv = dict(new_v) if isinstance(new_v, dict) else {}
                for vname, g in old_v.items():
                    cur = mv.get(vname)
                    if isinstance(g, int) and (
                        not isinstance(cur, int) or g > cur
                    ):
                        mv[vname] = g
                merged["views"] = mv
            out[fname] = merged
        return out

    @staticmethod
    def _report_max(report: dict) -> int:
        """Newest generation anywhere in one index's epoch report — the
        report's ORDER among reports from the same peer, because a
        peer's generations all come from one monotonic per-process
        counter."""
        top = 0
        for f in report.values():
            if not isinstance(f, dict):
                continue
            s = f.get("structure")
            if isinstance(s, int) and s > top:
                top = s
            views = f.get("views")
            if isinstance(views, dict):
                for g in views.values():
                    if isinstance(g, int) and g > top:
                        top = g
        return top

    def fold_peer_epochs(self, payload: dict) -> None:
        """Fold one piggybacked epoch report ({"node": id, "indexes":
        {index: {field: {"structure": int, "views": {view: gen}}}}})
        into the per-peer map. Reports are whole-index snapshots —
        generations are minted from one monotonic per-process counter
        (wall-seeded, so a restarted peer can never repeat a value) and
        the cache compares them for EQUALITY only. Folds can arrive OUT
        OF ORDER (a slow read leg's response races a later write's), so
        a report only replaces the stored one when its newest
        generation is >= the stored report's: an older snapshot folding
        back over a newer one would re-validate a cache entry that a
        synchronous write invalidation already killed. (A deletion-only
        change can lower the max — that stale entry lasts only until
        the peer's next mint, and a deleted field can't serve anyway.)"""
        node_id = payload.get("node")
        indexes = payload.get("indexes")
        boot = payload.get("boot")
        if not node_id or not isinstance(indexes, dict):
            return
        if node_id == self.local_node.id:
            return  # our own loopback report: the local vector covers it
        # Entries store (boot, report_max, report). Same-incarnation
        # folds MERGE per-view monotone (see _merge_report: torn
        # reports must never regress an individual generation; merge is
        # commutative, so arrival order stops mattering entirely). A
        # boot change — the peer restarted; its post-clock-step counter
        # may mint below its previous life — or an unknown boot
        # (mixed-version peers) replaces wholesale: the reborn process
        # is fresh truth, deletions included. The incoming report's max
        # walk happens out here, unlocked; the merge walk runs under
        # the lock but only per FOLD (one per RPC response), never on
        # the cache-lookup path.
        prepared = [
            (index, self._report_max(report), report)
            for index, report in indexes.items()
            if isinstance(report, dict)
        ]
        if not prepared:
            return
        with self._peer_epochs_lock:
            per_node = self._peer_epochs.setdefault(node_id, {})
            for index, mx, report in prepared:
                stored = per_node.get(index)
                if (
                    stored is not None
                    and boot is not None
                    and stored[0] == boot
                ):
                    report = self._merge_report(stored[2], report)
                    mx = max(mx, stored[1])
                per_node[index] = (boot, mx, report)

    def _covering_peers(self, index: str, shards_t: tuple) -> frozenset:
        """Node ids (excluding this node) owning any replica of any
        covered shard — every node whose writes could change a fan-out
        answer over this shard set. Memoized per (index, shard tuple,
        membership generation)."""
        with self._peer_epochs_lock:
            key = (index, shards_t, self._topo_gen)
            got = self._owners_memo.get(key)
        if got is not None:
            return got
        local_id = self.local_node.id
        out = set()
        for s in shards_t:
            for n in self.topology.shard_nodes(index, s):
                if n.id != local_id:
                    out.add(n.id)
        got = frozenset(out)
        with self._peer_epochs_lock:
            if len(self._owners_memo) > 64:
                self._owners_memo.clear()
            self._owners_memo[key] = got
        return got

    def rescache_peer_epochs(self, index: str, field_names, shards_t: tuple):
        """The result cache's peer-epoch provider: a tuple signature of
        every covering peer's last-reported epochs for the covered
        fields, or None when any covering peer's state is unknown
        (nothing piggybacked yet — the first fan-out populates the map,
        so only the answer AFTER it becomes cacheable). () means the
        shard set is covered locally and no peer vector is needed.

        Freshness contract (docs/administration.md "Result caching"):
        the map advances on every internal RPC response from a peer —
        coordinator-routed writes invalidate synchronously — and on the
        failure detector's ~1 s /status probes, which bound the
        staleness window for writes entering via other nodes."""
        peers = self._covering_peers(index, shards_t)
        if not peers:
            return ()
        # Lock held only for the ref grabs: folds REPLACE a peer's
        # report wholesale (never mutate in place), so the references
        # are stable snapshots and the O(fields x views) signature walk
        # + sorts run outside the lock every RPC piggyback fold and
        # every other cache lookup contends for.
        reports = []
        with self._peer_epochs_lock:
            for nid in sorted(peers):
                entry = self._peer_epochs.get(nid, {}).get(index)
                per_index = entry[2] if entry else None
                if not per_index:
                    return None
                reports.append((nid, per_index))
        out = []
        for nid, per_index in reports:
            for fname in field_names:
                frep = per_index.get(fname)
                if not isinstance(frep, dict):
                    return None
                out.append((nid, fname, -1, frep.get("structure")))
                views = frep.get("views") or {}
                for vname in sorted(views):
                    out.append((nid, fname, vname, views[vname]))
        return tuple(out)

    # -- mapReduce (reference executor.go:2460-2613) -----------------------

    def _routable_nodes(self, index, shards):
        """Scatter-gather candidates: DOWN nodes are skipped up front, and
        so are peers whose circuit breaker is open
        — both route traffic straight to replicas instead of eating a
        timeout. Each filter is dropped again if it would orphan a shard:
        availability beats the optimization."""
        from pilosa_tpu_torch.cluster.client import peer_label
        from pilosa_tpu_torch.cluster.topology import NODE_STATE_DOWN

        live = [n for n in self.topology.nodes if n.state != NODE_STATE_DOWN]
        if not live:
            live = list(self.topology.nodes)
        breakers = getattr(self.client, "breakers", None)
        if breakers is not None:
            unblocked = [
                n
                for n in live
                if n.id == self.local_node.id
                or not breakers.is_blocked(peer_label(n))
            ]
            if unblocked and unblocked != live:
                try:
                    self._shards_by_node(unblocked, index, shards)
                    return unblocked
                except ShardUnavailableError:
                    pass  # a blocked peer is some shard's only owner
        return live

    def map_shards(self, index, shards, c, map_fn, reduce_fn, opt):
        from pilosa_tpu_torch.cluster.client import count_rpc_retry, peer_label
        from pilosa_tpu_torch.utils.deadline import current_deadline
        from pilosa_tpu_torch.utils.stats import global_stats

        nodes = self._routable_nodes(index, shards)
        ch: "queue.Queue[_MapResponse]" = queue.Queue()
        # The caller's active span (executor.Execute / the HTTP span) is
        # captured HERE because the mapper legs run on fresh threads whose
        # thread-local span stacks are empty — without handing the parent
        # over, the client would find no active span and the trace would
        # die at the node boundary. The active
        # Deadline crosses the same thread boundary the same way.
        from pilosa_tpu_torch.utils.tracing import global_tracer

        parent_span = global_tracer.active_span()
        deadline = current_deadline()

        # Hedged gather state: every launched leg is tracked until its
        # shard set is reduced. `needed` is the set of shards still
        # awaiting exactly one reduction; a response is accepted only if
        # its whole shard set is still needed, so a hedge's loser — or a
        # straggler whose shards a hedge already covered — is discarded
        # instead of double-reduced.
        inflight: dict[int, dict] = {}
        needed: set[int] = set(shards)
        hedged: set[int] = set()  # parent leg ids with a hedge in flight
        # Parents no longer hedge-eligible: already hedged, or hedging
        # was tried and no live alternate owns their shards. Tracked
        # separately from `hedged` so an unhedgeable straggler stops
        # driving the gather wait to zero (busy-poll) without ever being
        # scored as a hedge win/loss.
        hedge_done: set[int] = set()
        scored: set[int] = set()  # hedged parents already counted won/lost

        def launch(target_nodes, shard_list, attempt=1, parent=None):
            groups = self._shards_by_node(target_nodes, index, shard_list)
            for node, node_shards in groups.values():
                leg = next(self._leg_ids)
                inflight[leg] = {
                    "node": node,
                    "shards": node_shards,
                    "t0": time.monotonic(),
                    "attempt": attempt,
                    "parent": parent if parent is not None else leg,
                }
                spawn(
                    "cluster-map",
                    self._map_node,
                    args=(ch, leg, attempt, node, node_shards, index, c,
                          map_fn, reduce_fn, opt, parent_span, deadline),
                )

        launch(nodes, list(shards))

        result = None
        got_any = False
        # The gather wait is budget-derived (was a flat
        # client.timeout + 30): the deadline governs when one is active,
        # and the old cap stays as the no-deadline backstop — every
        # remote leg's socket timeout already ends below it.
        hard_cap = time.monotonic() + self.client.timeout + 30
        while needed:
            if deadline is not None:
                deadline.check("gather")
            now = time.monotonic()
            wait = hard_cap - now
            if deadline is not None:
                wait = min(wait, deadline.remaining())
            if self.hedge_delay > 0:
                for rec in inflight.values():
                    if (
                        rec["attempt"] == 1
                        and rec["parent"] not in hedge_done
                        and rec["node"].id != self.local_node.id
                    ):
                        wait = min(wait, rec["t0"] + self.hedge_delay - now)
            if now >= hard_cap:
                # A worker hung past the client timeout; surface as a
                # routable 5xx instead of an unhandled traceback.
                raise ShardUnavailableError(
                    f"query timed out waiting for shard results ({index})"
                ) from None
            try:
                resp = ch.get(timeout=max(wait, 0.001))
            except queue.Empty:
                self._maybe_hedge(
                    launch, inflight, needed, hedged, hedge_done, nodes
                )
                continue
            rec = inflight.pop(resp.leg, {"attempt": resp.attempt,
                                          "parent": resp.leg})
            if resp.err is not None:
                # Re-split the failed leg's still-needed shards across
                # the remaining replicas (reference :2497-2507). Shards a
                # hedge already reduced need no retry — and shards a
                # SIBLING attempt of the same parent still has in flight
                # (the primary of a failed hedge, or the hedge of a
                # failed primary) are already covered: re-splitting them
                # would duplicate the dispatch, and raising would abort a
                # query the sibling may still answer. Only shards no
                # sibling covers re-split (or raise).
                covered: set[int] = set()
                for r in inflight.values():
                    if r["parent"] == rec["parent"]:
                        covered.update(r["shards"])
                still = [
                    s for s in resp.shards if s in needed and s not in covered
                ]
                if not still:
                    continue
                count_rpc_retry(peer_label(resp.node), "query_node")
                nodes = [n for n in nodes if n.id != resp.node.id]
                try:
                    launch(nodes, still, attempt=rec["attempt"],
                           parent=rec["parent"])
                except ShardUnavailableError:
                    raise resp.err
                continue
            if not set(resp.shards) <= needed:
                # A sibling attempt already reduced part of this shard
                # set: the loser of a hedge race. Any shard of it still
                # needed is covered by an in-flight sibling (hedges cover
                # the straggler's full shard set), so dropping the whole
                # response is safe and the only way not to double-count.
                continue
            needed.difference_update(resp.shards)
            if rec["parent"] in hedged and rec["parent"] not in scored:
                scored.add(rec["parent"])
                won = "hedge" if rec["attempt"] > 1 else "primary"
                global_stats.with_tags(f"won:{won}").count(
                    "hedged_requests_total"
                )
                # The hedge RACED two replicas over one shard set — a
                # free consistency probe. The
                # winner's response plus its still-inflight sibling
                # identify both replicas; the checksum diff runs on the
                # monitor's thread, never here (one bounded-queue
                # append). Observed at scoring time because the loser's
                # answer usually lands AFTER this gather returns.
                if self.divergence is not None:
                    from pilosa_tpu_torch.cluster.consistency import call_fields

                    for r in inflight.values():
                        if (
                            r["parent"] == rec["parent"]
                            and r["node"].id != resp.node.id
                        ):
                            common = set(r["shards"]) & set(resp.shards)
                            if common:
                                # Scoped to the fields the hedged read
                                # touched: the probe diffs what the
                                # race witnessed, the sweep covers the
                                # rest of the schema.
                                self.divergence.observe(
                                    index, common, resp.node.id,
                                    r["node"].id, fields=call_fields(c),
                                )
            if got_any:
                result = reduce_fn(result, resp.result)
            else:
                result = resp.result
                got_any = True
        return result

    def _maybe_hedge(self, launch, inflight, needed, hedged, hedge_done,
                     nodes) -> None:
        """Re-launch every straggler remote leg's shards at the next live
        replica (first result wins; see the needed-set accounting above).
        A leg with no alternate owner for its shards is marked done (so
        the gather stops waking up for it) and left to its socket
        timeout — the error path re-splits what it can. Eligibility is
        keyed by PARENT id: a re-split leg carries its original parent,
        and hedging it twice would storm duplicate legs."""
        if self.hedge_delay <= 0:
            return
        now = time.monotonic()
        for rec in list(inflight.values()):
            if (
                rec["attempt"] != 1
                or rec["parent"] in hedge_done
                or rec["node"].id == self.local_node.id
                or now - rec["t0"] < self.hedge_delay
                or not any(s in needed for s in rec["shards"])
            ):
                continue
            alternates = [n for n in nodes if n.id != rec["node"].id]
            try:
                launch(alternates, [s for s in rec["shards"] if s in needed],
                       attempt=2, parent=rec["parent"])
            except ShardUnavailableError:
                hedge_done.add(rec["parent"])  # nowhere to hedge: stop waking
                continue
            hedge_done.add(rec["parent"])
            hedged.add(rec["parent"])

    def _shards_by_node(self, nodes: Sequence[Node], index: str, shards: Sequence[int]):
        m: dict[str, tuple[Node, list[int]]] = {}
        live = {n.id for n in nodes}
        for shard in shards:
            owner = None
            for n in self.topology.shard_nodes(index, shard):
                if n.id in live:
                    owner = n
                    break
            if owner is None:
                raise ShardUnavailableError(f"shard {shard} unavailable")
            m.setdefault(owner.id, (owner, []))[1].append(shard)
        return m

    def _map_node(self, ch, leg, attempt, node, node_shards, index, c,
                  map_fn, reduce_fn, opt, parent_span=None,
                  deadline=None) -> None:
        # Re-establish the trace context on this worker thread: one child
        # span per scatter-gather leg, tagged with the target node, so a
        # slow leg is directly visible in the assembled cross-node tree
        # (and remote legs inject X-Trace-Id via the client). The
        # caller's Deadline is re-activated the same way so the client
        # bounds and propagates the remaining budget.
        from pilosa_tpu_torch.utils.deadline import deadline_scope

        span = None
        if parent_span is not None:
            from pilosa_tpu_torch.utils.tracing import global_tracer

            span = global_tracer.start_span(
                "cluster.mapShards", headers=parent_span.inject_headers()
            )
            # targetNode, NOT node: the node tag means "where this span
            # RAN" to the trace assembler (origin attribution + the
            # cross-node clock-skew check), and this span runs on the
            # coordinator regardless of which peer the leg targets.
            span.set_tag("targetNode", node.id)
            span.set_tag("shards", len(node_shards))
            if attempt > 1:
                span.set_tag("hedge", attempt)
        resp = _MapResponse(node=node, shards=node_shards, leg=leg,
                            attempt=attempt)
        try:
            with deadline_scope(deadline):
                if node.id == self.local_node.id:
                    result = None
                    first = True
                    for shard in node_shards:
                        v = map_fn(shard)
                        result = v if first else reduce_fn(result, v)
                        first = False
                    resp.result = result
                else:
                    resp.result = self._remote_exec(
                        node, index, c, node_shards,
                        bypass=getattr(opt, "cache_bypass", False),
                    )
        except Exception as e:  # transport or peer error -> retried upstream
            resp.err = e
            if span is not None:
                span.set_tag("error", str(e)[:200])
        finally:
            if span is not None:
                span.finish()
        ch.put(resp)

    def _remote_exec(self, node, index, c, shards, bypass=False):
        try:
            out = self.client.query_node(
                node, index, c.to_string(), shards=shards, remote=True,
                bypass=bypass,
            )
        except ClientError as e:
            # A peer that missed a DDL broadcast answers code=not-found:
            # push it the schema and retry once (pull schema on
            # NotFound instead of failing until anti-entropy). At most one
            # repair attempt per (node, index): a genuinely nonexistent
            # field otherwise costs a schema push + duplicate remote
            # execution on EVERY query. The structured error
            # code replaces substring matching: an
            # unrelated error merely containing 'not found' can no longer
            # trigger a repair storm.
            repair_key = (node.id, index)
            if getattr(e, "code", "") != "not-found":
                raise
            with self._repair_lock:
                last = self._repair_attempted.get(repair_key)
                throttled = (
                    last is not None
                    and time.monotonic() - last < self.repair_retry_interval
                )
                if throttled:
                    raise
                # Armed inside the lock: concurrent legs hitting the
                # same missing schema run ONE repair, not one each.
                self._repair_attempted[repair_key] = time.monotonic()
            self._push_state_to(node, index)
            from pilosa_tpu_torch.cluster.client import count_rpc_retry, peer_label

            count_rpc_retry(peer_label(node), "query_node")
            out = self.client.query_node(
                node, index, c.to_string(), shards=shards, remote=True,
                bypass=bypass,
            )
            # The retry succeeded: the peer genuinely lacked schema and is
            # now repaired. Forget the attempt so a FUTURE missed DDL on
            # the same index can be repaired too; only the
            # genuinely-nonexistent-field case stays throttled.
            with self._repair_lock:
                self._repair_attempted.pop(repair_key, None)
        results = out.get("results", [])
        raw = results[0] if results else None
        return decode_result(c, raw)

    def _push_state_to(self, node, index: str) -> None:
        """Repair one peer's schema + available shards inline."""
        if self.holder is None:
            return
        self.broadcaster.send_to(
            node, Message.make(bc.MSG_NODE_STATUS, schema={"indexes": self.holder.schema()})
        )
        idx = self.holder.index(index)
        if idx is None:
            return
        for fname in list(idx.fields):
            f = idx.field(fname)
            if f is None:
                continue
            for shard in f.available_shards().to_array().tolist():
                self.broadcaster.send_to(
                    node,
                    Message.make(
                        bc.MSG_CREATE_SHARD, index=index, field=fname, shard=int(shard)
                    ),
                )

    # -- write replication (reference executor.go:2072-2141) ---------------

    def _parallel_peer_writes(self, peers: Sequence[Node], index: str, pql: str,
                              shards: Optional[dict[str, list[int]]] = None) -> list[Any]:
        """Fire one remote-exec per peer concurrently; first error raised.
        shards maps node id -> pinned shard list (None = unpinned)."""
        results: list[Any] = [None] * len(peers)
        errs: list[Exception] = []
        lock = threading.Lock()
        # Same cross-thread trace handoff as map_shards: replica writes
        # run on fresh threads, so the parent span — and the active
        # Deadline — are captured here.
        from pilosa_tpu_torch.utils.deadline import current_deadline, deadline_scope
        from pilosa_tpu_torch.utils.tracing import global_tracer

        parent_span = global_tracer.active_span()
        deadline = current_deadline()

        def send(i, node):
            span = None
            if parent_span is not None:
                span = global_tracer.start_span(
                    "cluster.replicaWrite",
                    headers=parent_span.inject_headers(),
                )
                span.set_tag("targetNode", node.id)
            try:
                with deadline_scope(deadline):
                    out = self.client.query_node(
                        node, index, pql,
                        shards=shards.get(node.id) if shards else None,
                        remote=True,
                    )
                rs = out.get("results", [])
                results[i] = rs[0] if rs else None
            except Exception as e:
                with lock:
                    errs.append(e)
            finally:
                if span is not None:
                    span.finish()

        threads = [
            spawn("cluster-broadcast", send, args=(i, n), start=False)
            for i, n in enumerate(peers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return results

    def _peer_unwritable(self, n: Node) -> bool:
        """A replica the write path skips: DOWN, or circuit-broken (an
        open breaker is treated exactly like DOWN — the write routes to
        the remaining replicas and anti-entropy repairs the peer when its
        breaker closes)."""
        if n.state == NODE_STATE_DOWN:
            return True
        breakers = getattr(self.client, "breakers", None)
        if breakers is None:
            return False
        from pilosa_tpu_torch.cluster.client import peer_label

        return breakers.is_blocked(peer_label(n))

    def _no_live_replica(self, index: str, shard: int) -> ClientError:
        """All replicas of a shard are unwritable: fail LOUDLY — a
        silently dropped write is unrepairable (no replica ever held it).
        Counted so an operator sees the rejection rate, not just client
        complaints."""
        from pilosa_tpu_torch.utils.stats import global_stats

        global_stats.with_tags(f"index:{index}").count(
            "write_replica_unavailable_total"
        )
        return ClientError(
            f"every replica of shard {shard} is down; write not applied",
            code="replicas-unavailable",
        )

    def route_write(self, index: str, c, shard: int, local_fn: Callable[[], Any]):
        """Apply a single-shard write on every replica; OR the changed
        flags (reference executeSetBitField: ret = changed on any node)."""
        replicas = self.topology.shard_nodes(index, shard)
        # DOWN or circuit-broken replicas are skipped (reads already skip
        # them in map_shards); anti-entropy delivers the write when they
        # return — but ONLY if at least one live replica takes it now.
        peers = [
            n
            for n in replicas
            if n.id != self.local_node.id and not self._peer_unwritable(n)
        ]
        local_is_replica = any(n.id == self.local_node.id for n in replicas)
        if replicas and not peers and not local_is_replica:
            raise self._no_live_replica(index, shard)
        ret = None
        if local_is_replica:
            ret = local_fn()
        for r in self._parallel_peer_writes(peers, index, c.to_string()):
            if ret is None:
                ret = r
            elif isinstance(r, bool):
                ret = bool(ret) or r
        return ret

    def route_write_shards(self, index: str, c, shards: Sequence[int],
                           local_fn: Callable[[int], Any]):
        """Multi-shard write (ClearRow/Store) applied on EVERY replica of
        every shard: local shards via local_fn, remote groups as one
        pinned remote-exec per node. The reference routes these through
        plain mapReduce (one owner per shard, executor.go:1871-1953),
        which silently diverges replicas until anti-entropy — replicating
        here keeps replicas consistent at write time."""
        by_node: dict[str, tuple[Node, list[int]]] = {}
        for shard in shards:
            reps = self.topology.shard_nodes(index, shard)
            if reps and all(
                self._peer_unwritable(n) and n.id != self.local_node.id
                for n in reps
            ):
                # No live replica for THIS shard: fail loudly — a
                # silently skipped shard write is unrepairable.
                raise self._no_live_replica(index, shard)
            for node in reps:
                by_node.setdefault(node.id, (node, []))[1].append(shard)
        ret = None
        local = by_node.pop(self.local_node.id, None)
        if local is not None:
            for shard in local[1]:
                r = local_fn(shard)
                ret = r if ret is None else (bool(ret) or bool(r))
        peers = [
            node for node, _ in by_node.values()
            if not self._peer_unwritable(node)
        ]
        pinned = {node.id: ss for node, ss in by_node.values()}
        for r in self._parallel_peer_writes(peers, index, c.to_string(), pinned):
            if ret is None:
                ret = r
            elif isinstance(r, bool):
                ret = bool(ret) or r
        return ret

    def fan_out_all(self, index: str, c, local_fn: Callable[[], Any]):
        """Apply on every node (attr writes; stores fully replicated,
        reference executeSetRowAttrs remote fan-out)."""
        ret = local_fn()
        peers = [n for n in self.topology.nodes if n.id != self.local_node.id]
        self._parallel_peer_writes(peers, index, c.to_string())
        return ret

    # -- schema / shard propagation ----------------------------------------

    def broadcast_schema(self) -> None:
        """Push the full schema to peers after a local DDL (the reference
        broadcasts per-op messages, broadcast.go:57-79; a full-schema sync
        is simpler and idempotent — receivers apply_schema)."""
        if self.holder is None:
            return
        # Local DDL may have created keyed stores: route them first.
        from pilosa_tpu_torch.cluster.sync import wrap_translate_stores

        wrap_translate_stores(self)
        msg = Message.make(bc.MSG_NODE_STATUS, schema={"indexes": self.holder.schema()})
        self._send_or_queue(msg)

    def _on_local_new_shard(self, index: str, field: str, shard: int) -> None:
        # Sync so a query routed through any node right after a write sees
        # the new shard in its fan-out set; down peers are repaired by
        # anti-entropy later.
        self._send_or_queue(
            Message.make(bc.MSG_CREATE_SHARD, index=index, field=field, shard=shard)
        )

    def _send_or_queue(self, msg: Message) -> None:
        """Sync broadcast; failures are logged and queued for retry by the
        sync daemon instead of dropped."""
        try:
            self.broadcaster.send_sync(msg)
        except RuntimeError as e:
            self._log("broadcast failed (queued for retry): %s", e)
            self._queue_pending(msg, attempts=1)

    def _queue_pending(self, msg: Message, attempts: int) -> None:
        """First failure retries at the very next flush; repeated
        failures back off exponentially (jittered 0.5-1.5x, capped at
        60 s) so a long-dead peer costs one send per cap interval, not
        one per queued message per sync pass."""
        if attempts <= 1:
            due = 0.0
        else:
            base = min(0.5 * (2 ** (attempts - 1)), 60.0)
            due = time.monotonic() + base * (0.5 + random.random())
        with self._pending_lock:
            self._pending_msgs.append([msg, attempts, due])

    def flush_pending_broadcasts(self) -> None:
        now = time.monotonic()
        with self._pending_lock:
            due = [e for e in self._pending_msgs if e[2] <= now]
            self._pending_msgs = [e for e in self._pending_msgs if e[2] > now]
        for msg, attempts, _ in due:
            try:
                self.broadcaster.send_sync(msg)
            except RuntimeError as e:
                self._log(
                    "broadcast retry attempt %d failed (backing off): %s",
                    attempts + 1, e,
                )
                self._queue_pending(msg, attempts + 1)

    # -- message receive (reference server.go receiveMessage :569) ---------

    def receive_message(self, payload: bytes) -> None:
        self.apply_message(Message.from_bytes(payload))

    def apply_message(self, msg: Message) -> None:
        typ = msg.get("type")
        if typ == bc.MSG_CREATE_SHARD:
            idx = self.holder.index(msg["index"]) if self.holder else None
            f = idx.field(msg["field"]) if idx else None
            if f is not None:
                f.add_available_shard(int(msg["shard"]))
        elif typ == bc.MSG_DELETE_AVAILABLE_SHARD:
            idx = self.holder.index(msg["index"]) if self.holder else None
            f = idx.field(msg["field"]) if idx else None
            if f is not None:
                f.remove_available_shard(int(msg["shard"]))
        elif typ == bc.MSG_NODE_STATUS:
            # schema + (optionally) per-field available shards — the
            # rejoin path ships both so a restarted node immediately fans
            # queries out over every shard (schema alone
            # left available_shards empty until anti-entropy, silently
            # undercounting queries routed through the rejoined node).
            self.merge_node_status(
                {k: msg[k] for k in ("schema", "available") if k in msg}
            )
        elif typ == bc.MSG_CLUSTER_STATUS:
            self.set_state(msg.get("state", self.state()))
            if "replicaN" in msg:
                # lint: allow-shared-state(membership swap: each store is a GIL-atomic publish and readers tolerate one stale view until the next CLUSTER_STATUS frame)
                self.topology.replica_n = int(msg["replicaN"])
                with self._peer_epochs_lock:
                    self._topo_gen += 1  # replica fan changes ownership
            if "nodes" in msg:
                new_nodes = sorted(
                    (Node.from_json(d) for d in msg["nodes"]), key=lambda n: n.id
                )
                self.topology.nodes = new_nodes
                with self._repair_lock:
                    self._repair_attempted.clear()
                # Membership moved: shard ownership may have too — the
                # covering-peer memo keys on this generation, and a
                # departed peer's epoch report must not keep validating
                # cache entries it can no longer witness.
                live = {n.id for n in new_nodes}
                with self._peer_epochs_lock:
                    self._topo_gen += 1
                    for nid in list(self._peer_epochs):
                        if nid not in live:
                            del self._peer_epochs[nid]
                # Membership changed: re-negotiate control-plane wire
                # format per peer (a replaced node may speak binary now).
                self.broadcaster.reset_wire_negotiation()
                # Keep the local node's identity object in sync (it may
                # have just become or stopped being a member/coordinator).
                mine = next((n for n in new_nodes if n.id == self.local_node.id), None)
                if mine is not None:
                    # lint: allow-shared-state(identity swap: atomic publish of the replacement Node object; readers key off the stable node id)
                    self.local_node = mine
                # Membership is durable state: persist so a restart
                # rejoins with the same identity.
                self.persist_topology()
            if self.resizer is not None:
                from pilosa_tpu_torch.cluster.topology import STATE_RESIZING

                if msg.get("state") == STATE_RESIZING:
                    # The freeze arms the follower's rollback lease: a
                    # coordinator that dies right after freezing must not
                    # strand this node in RESIZING forever.
                    self.resizer.renew_lease(msg)
                elif "state" in msg:
                    self.resizer.cancel_lease()
            if msg.get("state") == STATE_NORMAL and self.resizer is not None:
                self.resizer.clean_holder()
        elif typ == bc.MSG_RESIZE_HEARTBEAT:
            if self.resizer is not None:
                self.resizer.renew_lease(msg)
        elif typ == bc.MSG_RECALCULATE_CACHES:
            if self.api is not None:
                self.api.recalculate_caches()
        elif typ == bc.MSG_RESIZE_INSTRUCTION:
            if self.resizer is not None:
                # Follow asynchronously: the instruction fetches fragments
                # from peers, which must not block the coordinator's
                # broadcast round-trip.
                spawn(
                    "resize-follower",
                    self.resizer.follow_instruction, args=(msg,),
                )
        elif typ == bc.MSG_RESIZE_COMPLETE:
            if self.resizer is not None:
                self.resizer.mark_complete(msg)
        elif typ == bc.MSG_RESIZE_ABORT:
            if self.resizer is not None:
                # local=True: a received abort is applied, never echoed —
                # two nodes both holding the coordinator flag during a
                # failover window would otherwise ping-pong it forever.
                self.resizer.abort(local=True)
        elif typ == bc.MSG_NODE_EVENT:
            self._handle_node_event(msg)
        elif typ == bc.MSG_NODE_STATE:
            # Disseminated liveness (each node used
            # to discover DOWN peers only by its own probes, so views
            # could disagree indefinitely; reference shares this via
            # gossip events, gossip.go:364-443).
            nid, state = msg.get("id"), msg.get("state")
            target = self.topology.node_by_id(nid)
            if target is not None and nid != self.local_node.id and state in (
                NODE_STATE_READY,
                NODE_STATE_DOWN,
            ):
                # Asymmetric-partition guard (SWIM-style, r5): a peer's
                # DOWN claim is a VOTE against our own probe history,
                # never an overwrite — an unconditional overwrite let
                # one one-sided partition flap the whole cluster
                # (claimer marks DOWN and broadcasts; a healthy
                # receiver overwrites, then its own next probe flips it
                # READY and re-broadcasts, forever). Symmetric failures
                # (the node is really dead) still converge fast: every
                # receiver's probes are failing too, so the vote tops
                # up their confirm counter.
                fd = getattr(self, "failure_detector", None)
                if (
                    state == NODE_STATE_DOWN
                    and fd is not None
                    and not fd.vote_down(nid)
                ):
                    return
                target.state = state
        elif typ == bc.MSG_SET_COORDINATOR:
            new_id = msg.get("id")
            was_coordinator = self.local_node.is_coordinator
            for n in self.topology.nodes:
                n.is_coordinator = n.id == new_id
            self.local_node.is_coordinator = self.local_node.id == new_id
            self.persist_topology()
            if (
                self.local_node.is_coordinator
                and not was_coordinator
                and self.resizer is not None
            ):
                # A promotion mid-resize adopts (and aborts) the dead
                # coordinator's orphaned job.
                self.resizer.on_promoted()
        # unknown types ignored (forward compatibility)

    def _handle_node_event(self, msg: Message) -> None:
        event = msg.get("event")
        node = Node.from_json(msg["node"]) if "node" in msg else None
        if node is None:
            return
        if event == bc.EVENT_JOIN:
            if self.is_coordinator() and self.resizer is not None:
                # NodeStatus ships with the announce: a restarting node's
                # schema/shard inventory merges BEFORE the resize job
                # diffs fragment sources, so its data counts as present.
                self.merge_node_status(msg.get("status") or {})
                self.resizer.handle_join(node)
            elif not msg.get("forwarded"):
                # Announce landed on a member that isn't the coordinator
                # (e.g. coordinatorship moved after the operator noted
                # the URI): forward once instead of silently dropping.
                coord = self.coordinator()
                if coord is not None and coord.id != self.local_node.id:
                    fwd = Message(msg)
                    fwd["forwarded"] = True
                    try:
                        self.broadcaster.send_to(coord, fwd)
                    except Exception as e:  # noqa: BLE001 — joiner retries
                        self._log("join forward to coordinator failed: %s", e)
        elif event == bc.EVENT_LEAVE:
            existing = self.topology.node_by_id(node.id)
            if existing is not None:
                existing.state = "DOWN"
            # Degraded until repaired/resized (reference determineClusterState
            # cluster.go:571: missing node + replicas -> DEGRADED).
            if self.topology.replica_n > 1:
                self.set_state(STATE_DEGRADED)


# ---------------------------------------------------------------------------
# remote result decoding (reference QueryResponse protobuf -> result types)
# ---------------------------------------------------------------------------

_ROW_CALLS = frozenset(
    ("Row", "Range", "Union", "Intersect", "Difference", "Xor", "Not", "Shift", "All")
)


def decode_result(c, raw: Any) -> Any:
    """JSON result from a peer -> the executor's native result type, so the
    coordinator's reduce functions work unchanged."""
    name = c.name
    if name == "Count":
        return int(raw or 0)
    if name in ("Sum", "Min", "Max"):
        raw = raw or {}
        return ValCount(val=int(raw.get("value", 0)), count=int(raw.get("count", 0)))
    if name in ("MinRow", "MaxRow"):
        raw = raw or {}
        field_name = str(c.args.get("_field") or c.args.get("field") or "")
        return PairField(
            Pair(id=int(raw.get("id", 0)), count=int(raw.get("count", 0))),
            field_name,
        )
    if name == "TopN":
        # Shard-level merge type is a plain pair list (add_pairs); the
        # coordinator wraps the final PairsField.
        return [
            Pair(id=int(p.get("id", 0)), count=int(p.get("count", 0)),
                 key=p.get("key", ""))
            for p in (raw or [])
        ]
    if name == "Rows":
        raw = raw or {}
        out = RowIDs(int(r) for r in raw.get("rows", []))
        if "keys" in raw:
            out.keys = list(raw["keys"])
        return out
    if name == "GroupBy":
        out_groups = []
        for g in raw or []:
            frs = [
                FieldRow(
                    field=fr["field"],
                    row_id=int(fr.get("rowID", 0)),
                    row_key=fr.get("rowKey", ""),
                )
                for fr in g.get("group", [])
            ]
            out_groups.append(GroupCount(frs, int(g.get("count", 0))))
        return out_groups
    if name in ("Set", "Clear", "Store", "ClearRow"):
        return bool(raw)
    if name in ("SetRowAttrs", "SetColumnAttrs"):
        return None
    if name == "Options":
        return decode_result(c.children[0], raw) if c.children else raw
    if name in _ROW_CALLS:
        raw = raw or {}
        row = Row(int(v) for v in raw.get("columns", []))
        if raw.get("attrs"):
            row.attrs = raw["attrs"]
        return row
    return raw
