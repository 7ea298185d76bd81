"""Cluster convergence: translate replication, anti-entropy, failure detection.

Three loops the reference runs as background monitors:

- **Key translation** (reference translate.go:35-70, holder.go:785-878):
  the coordinator is the translation primary. Non-coordinator stores wrap
  the local sqlite store in a ForwardingTranslateStore: key *writes*
  forward to the primary over RPC (so the same key gets the same id
  cluster-wide), and replicas tail the primary's entry log
  (entries_since) both on-demand (read miss) and from the sync daemon.
- **Anti-entropy** (reference holder.go:882-1101, server.go:514): the
  HolderSyncer periodically walks the schema and, for every fragment this
  node owns, diffs 100-row block checksums against each replica and
  merges differing blocks (union repair, fragment.go:1875). Attribute
  stores sync the same way over 100-id blocks. View names and available
  shards are pulled from peers first so a replica that missed a
  CREATE_SHARD broadcast converges too.
- **Failure detection** (reference gossip NotifyLeave + confirm-down
  retry, cluster.go:65-67): each node probes peers' /status; after
  CONFIRM_DOWN consecutive failures the peer is marked DOWN in the local
  topology (queries then skip it proactively instead of timing out per
  request) and the cluster degrades; a successful probe marks it READY.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from pilosa_tpu_torch.cluster.client import ClientError
from pilosa_tpu_torch.cluster.topology import NODE_STATE_DOWN, NODE_STATE_READY
from pilosa_tpu_torch.utils.logger import NopLogger
from pilosa_tpu_torch.utils.stats import global_stats


def _count_transition(node_id: str, to_state: str) -> None:
    """Membership state-transition counter: a flapping peer
    shows up as a climbing DOWN/READY pair on /metrics instead of only
    as interleaved log lines."""
    global_stats.with_tags(f"peer:{node_id}", f"to:{to_state}").count(
        "cluster_node_state_transitions_total"
    )

# Consecutive probe failures before a peer is declared down
# (the reference re-checks a leave event before acting, cluster.go:65).
CONFIRM_DOWN = 3


class ForwardingTranslateStore:
    """Wraps a node-local TranslateStore; assigns ids only on the primary.

    reference translate.go:35 (primary store) + http/translator.go (replica
    reader). The local store is a strict replica of the primary's log:
    entries are applied with their primary-assigned ids, so offsets never
    diverge.
    """

    def __init__(self, local, cluster, index: str, field: str = ""):
        self.local = local
        self.cluster = cluster
        self.index = index
        self.field = field

    # -- write path --------------------------------------------------------

    def translate_key(self, key: str, write: bool = True) -> Optional[int]:
        id_ = self.local.translate_key(key, write=False)
        if id_ is not None:
            return id_
        if self.cluster.is_coordinator():
            return self.local.translate_key(key, write=write)
        if not write:
            return None
        coord = self.cluster.coordinator()
        ids = self.cluster.client.translate_keys(coord, self.index, self.field, [key])
        # Catch the local replica up so the log has no gaps, then make sure
        # this entry landed even if the tail raced.
        self.sync_from_primary()
        self.local.apply_entries([(ids[0], key)])
        return ids[0]

    def translate_keys(self, keys: list[str], write: bool = True) -> list[Optional[int]]:
        """Bulk translation in ONE coordinator RPC + ONE log tail for all
        missing keys (the per-key loop made a keyed
        import of 100k fresh keys 100k round trips; reference batches via
        TranslateKeysNode, http/client.go)."""
        out = self.local.translate_keys(keys, write=False)
        missing = [i for i, v in enumerate(out) if v is None]
        if not missing:
            return out
        if self.cluster.is_coordinator():
            if write:  # write=False misses are already known-absent
                filled = self.local.translate_keys(
                    [keys[i] for i in missing], write=True
                )
                for j, i in enumerate(missing):
                    out[i] = filled[j]
            return out
        if not write:
            return out
        coord = self.cluster.coordinator()
        ids = self.cluster.client.translate_keys(
            coord, self.index, self.field, [keys[i] for i in missing]
        )
        # Catch the local replica up so the log has no gaps, then make
        # sure these entries landed even if the tail raced.
        self.sync_from_primary()
        self.local.apply_entries(
            [(ids[j], keys[i]) for j, i in enumerate(missing)]
        )
        for j, i in enumerate(missing):
            out[i] = ids[j]
        return out

    # -- read path ---------------------------------------------------------

    def translate_id(self, id_: int) -> Optional[str]:
        k = self.local.translate_id(id_)
        if k is None and not self.cluster.is_coordinator():
            try:
                self.sync_from_primary()
            except ClientError:
                return None
            k = self.local.translate_id(id_)
        return k

    def translate_ids(self, ids: list[int]) -> list[Optional[str]]:
        """Bulk id -> key: one local bulk lookup; a replica with misses
        tails the primary ONCE and re-looks the misses up in bulk."""
        out = self.local.translate_ids(ids)
        missing = [i for i, v in enumerate(out) if v is None]
        if not missing or self.cluster.is_coordinator():
            return out
        try:
            self.sync_from_primary()
        except ClientError:
            return out
        filled = self.local.translate_ids([ids[i] for i in missing])
        for j, i in enumerate(missing):
            out[i] = filled[j]
        return out

    # -- replication -------------------------------------------------------

    def sync_from_primary(self) -> None:
        """Tail the primary's entry log (reference EntryReader stream)."""
        coord = self.cluster.coordinator()
        if coord is None or coord.id == self.cluster.local_node.id:
            return
        entries = self.cluster.client.translate_data(
            coord, self.index, self.field, self.local.max_id()
        )
        if entries:
            self.local.apply_entries([(int(s), k) for s, k in entries])

    # -- delegation --------------------------------------------------------

    def max_id(self) -> int:
        return self.local.max_id()

    def entries_since(self, seq: int):
        return self.local.entries_since(seq)

    def apply_entries(self, entries) -> None:
        self.local.apply_entries(entries)

    def close(self) -> None:
        self.local.close()


def wrap_translate_stores(cluster) -> None:
    """Install forwarding wrappers on every keyed store in the holder.
    Idempotent; called at attach and after any schema change."""
    holder = cluster.holder
    if holder is None:
        return
    for name in list(holder.indexes):
        idx = holder.index(name)
        if idx is None:
            continue
        if idx.translate_store is not None and not isinstance(
            idx.translate_store, ForwardingTranslateStore
        ):
            idx.translate_store = ForwardingTranslateStore(
                idx.translate_store, cluster, name
            )
        for fname in list(idx.fields):
            f = idx.field(fname)
            if f is not None and f.translate_store is not None and not isinstance(
                f.translate_store, ForwardingTranslateStore
            ):
                f.translate_store = ForwardingTranslateStore(
                    f.translate_store, cluster, name, fname
                )


class HolderSyncer:
    """Anti-entropy repair loop (reference holderSyncer holder.go:882)."""

    def __init__(self, cluster, logger=None):
        self.cluster = cluster
        self.log = logger or NopLogger()

    # -- one full pass -----------------------------------------------------

    def sync_holder(self) -> int:
        """Walk schema, diff checksums vs replicas, merge differing blocks.
        Returns the number of blocks repaired (reference SyncHolder
        holder.go:911).

        Observability: each pass counts
        anti_entropy_runs_total, times itself into the
        anti_entropy_run_seconds histogram, and stamps the
        anti_entropy_last_run_seconds gauge (monotonic clock, same base
        as the exported uptime: `uptime - value` is the run's age) — a
        stalled syncer on one node used to be invisible except as the
        absence of log lines."""
        holder = self.cluster.holder
        if holder is None:
            return 0
        t0 = time.monotonic()
        repaired = 0
        self._sync_schema()
        for index_name in list(holder.indexes):
            idx = holder.index(index_name)
            if idx is None:
                continue
            repaired += self._sync_attrs(index_name, None, idx.column_attr_store)
            for field_name in list(idx.fields):
                f = idx.field(field_name)
                if f is None:
                    continue
                repaired += self._sync_attrs(index_name, field_name, f.row_attr_store)
                self._pull_field_state(index_name, field_name, f)
                shards = f.available_shards().to_array().tolist()
                for view_name in list(f.views):
                    for shard in shards:
                        if not self.cluster.topology.owns_shard(
                            self.cluster.local_node.id, index_name, shard
                        ):
                            continue
                        if self._migration_in_flight(index_name, shard):
                            # A resize is mid-move on this shard: a
                            # repair sourced from a half-migrated peer
                            # fragment would ship a partial block as
                            # truth. Skip; the post-resize pass heals
                            # it.
                            global_stats.with_tags("reason:resizing").count(
                                "anti_entropy_skipped_total"
                            )
                            continue
                        repaired += self._sync_fragment(
                            index_name, f, view_name, shard
                        )
        # Drain any control messages that failed to broadcast earlier.
        self.cluster.flush_pending_broadcasts()
        global_stats.count("anti_entropy_runs_total")
        global_stats.timing("anti_entropy_run_seconds", time.monotonic() - t0)
        global_stats.gauge("anti_entropy_last_run_seconds", time.monotonic())
        return repaired

    def _live_replicas(self, index: str, shard: int):
        local_id = self.cluster.local_node.id
        return [
            n
            for n in self.cluster.topology.shard_nodes(index, shard)
            if n.id != local_id and n.state != NODE_STATE_DOWN
        ]

    def _peers(self):
        local_id = self.cluster.local_node.id
        return [
            n
            for n in self.cluster.topology.nodes
            if n.id != local_id and n.state != NODE_STATE_DOWN
        ]

    def _sync_schema(self) -> None:
        """Pull peer schemas (repairs a missed DDL broadcast; reference
        syncs schema via NodeStatus gossip, holder.go:924)."""
        api = self.cluster.api
        if api is None:
            return
        for peer in self._peers():
            try:
                schema = self.cluster.client.schema(peer)
            except ClientError:
                continue
            try:
                api.apply_schema(schema)
            except Exception as e:
                self.log.printf("anti-entropy: apply schema from %s: %s", peer.id, e)
        wrap_translate_stores(self.cluster)

    def _pull_field_state(self, index: str, field_name: str, f) -> None:
        """Union peer view lists + available shards (repairs a missed
        CREATE_SHARD broadcast)."""
        for peer in self._peers():
            try:
                state = self.cluster.client.field_state(peer, index, field_name)
            except ClientError:
                continue
            for shard in state.get("availableShards", []):
                f.add_available_shard(int(shard))
            for view_name in state.get("views", []):
                f.create_view_if_not_exists(view_name)

    def _migration_in_flight(self, index: str, shard: int) -> bool:
        rz = self.cluster.resizer
        return rz is not None and rz.migration_in_flight(index, shard)

    def _sync_fragment(self, index: str, f, view_name: str, shard: int,
                       only_blocks=None) -> int:
        """Epoch-directed anti-entropy for one fragment.
        The wire ships per-block (checksum, epoch); a
        differing block resolves by the matrix:

          both epochs known, unequal  -> directed copy from the HIGHER
                                         epoch (clears included — this
                                         is what lets tombstones
                                         propagate); the lower side
                                         adopts the winner's epoch so
                                         replicas converge on both axes.
          both known, equal           -> union (two distinct writes can
                                         never share a stamp within one
                                         fragment, so an equal-epoch
                                         disagreement means the epoch
                                         plane cannot order them).
          either side unknown (0)     -> union (mixed-version peers,
                                         pre-upgrade data, crash-dropped
                                         sidecars) — NEVER a directed
                                         wipe of data nobody can date.

        `only_blocks` (read-repair plane) restricts the pass to the
        named block ids."""
        v = f.view(view_name)
        frag = v.fragment(shard) if v is not None else None
        repaired = 0
        for peer in self._live_replicas(index, shard):
            try:
                peer_blocks = self.cluster.client.fragment_blocks(
                    peer, index, f.name, view_name, shard
                )
            except ClientError:
                continue  # peer has no fragment (404) or is unreachable
            if not peer_blocks:
                continue
            local_blocks = (
                {b: (s, e) for b, s, e in frag.block_sums_epochs()}
                if frag is not None
                else {}
            )
            for block_id, checksum, peer_epoch in peer_blocks:
                if only_blocks is not None and block_id not in only_blocks:
                    continue
                local_sum, local_epoch = local_blocks.get(block_id, (0, 0))
                if local_sum == checksum:
                    continue
                directed = (
                    peer_epoch > 0
                    and local_epoch > 0
                    and peer_epoch != local_epoch
                )
                if directed and local_epoch > peer_epoch:
                    # Our block is newer: keep it. The peer's own pass
                    # (or its read-repair) pulls ours — counted so both
                    # heal directions are visible from one registry.
                    global_stats.with_tags("direction:local_wins").count(
                        "anti_entropy_directed_repairs_total"
                    )
                    continue
                try:
                    data, wire_epoch = self.cluster.client.block_data(
                        peer, index, f.name, view_name, shard, block_id
                    )
                except ClientError:
                    continue
                # The epoch that rode WITH the data supersedes the
                # snapshot's: a peer write between the two RPCs shipped
                # newer bytes, and stamping them with the older
                # snapshot epoch would diverge the epoch axis (epochs
                # only grow, so the higher-wins decision still holds).
                # wire_epoch 0 means the peer's block went
                # epoch-UNKNOWN in flight (a union merge landed there):
                # the directed/pull decision's basis is gone — zeroing
                # peer_epoch degrades this block to union.
                if wire_epoch > 0:
                    peer_epoch = wire_epoch
                else:
                    peer_epoch = 0
                    directed = False
                if frag is None:
                    frag = v.create_fragment_if_not_exists(shard) if v is not None else None
                    if frag is None:
                        frag = f.create_view_if_not_exists(
                            view_name
                        ).create_fragment_if_not_exists(shard)
                    local_blocks = {
                        b: (s, e) for b, s, e in frag.block_sums_epochs()
                    }
                # Pure pull into a block we have NO data and NO epoch
                # for: the union result IS the peer's block, so copying
                # it (epoch included) keeps replicas convergent on both
                # axes — and nothing local can be wiped, because there
                # is nothing local. Counted as the classic missed-write
                # block repair (kind=fragment), NOT as a directed
                # repair: the direction family is reserved for
                # epoch-ARBITRATED resolutions between two dated blocks.
                pull = (
                    not directed
                    and local_sum == 0
                    and local_epoch == 0
                    and peer_epoch > 0
                )
                if directed or pull:
                    # expected_local_epoch closes the snapshot-to-
                    # replace race: a client write landing between the
                    # (checksum, epoch) snapshot and this call minted a
                    # newer local epoch the decision never saw —
                    # replace_block skips (None) instead of wiping the
                    # acked write, and the next pass re-evaluates.
                    result = frag.replace_block(
                        block_id, data, peer_epoch,
                        expected_local_epoch=local_epoch,
                    )
                    if result is None:
                        global_stats.with_tags("reason:stale-epoch").count(
                            "anti_entropy_skipped_total"
                        )
                        continue
                    added, removed = result
                    if added or removed:
                        repaired += 1
                        if directed:
                            global_stats.with_tags(
                                "direction:remote_wins"
                            ).count("anti_entropy_directed_repairs_total")
                        else:
                            global_stats.with_tags("kind:fragment").count(
                                "anti_entropy_blocks_repaired_total"
                            )
                else:
                    added, _ = frag.merge_block(block_id, data)
                    if added:
                        repaired += 1
                        global_stats.with_tags("kind:fragment").count(
                            "anti_entropy_blocks_repaired_total"
                        )
        return repaired

    def sync_fragment_targeted(self, index: str, field: str, view_name: str,
                               shard: int, blocks=None) -> int:
        """One fragment's epoch-directed repair, outside the full pass —
        the read-repair queue's unit of work. Skips (0) while the shard
        is mid-migration, exactly like the daemon pass."""
        from pilosa_tpu_torch.utils.deadline import Deadline, current_deadline, deadline_scope

        holder = self.cluster.holder
        idx = holder.index(index) if holder is not None else None
        f = idx.field(field) if idx is not None else None
        if f is None:
            return 0
        # Ownership guard, same as the daemon pass: a read-repair RPC
        # can land MINUTES after the hedge observation (bounded queue x
        # per-probe budget), by which time a resize may have moved the
        # shard off this node — repairing here would recreate and
        # repopulate a fragment cleanup already removed.
        if not self.cluster.topology.owns_shard(
            self.cluster.local_node.id, index, shard
        ):
            global_stats.with_tags("reason:not-owner").count(
                "anti_entropy_skipped_total"
            )
            return 0
        if self._migration_in_flight(index, shard):
            global_stats.with_tags("reason:resizing").count(
                "anti_entropy_skipped_total"
            )
            return 0
        # Budget the repair's peer RPCs (deadline-scope rule): the
        # /internal/fragment/repair handler and the divergence worker
        # both land here; an inherited request budget is honored, a
        # bare call gets its own bound so a stalled replica can't pin
        # the caller.
        d = current_deadline()
        with deadline_scope(d if d is not None else Deadline(30.0)):
            return self._sync_fragment(
                index, f, view_name, shard,
                only_blocks=set(blocks) if blocks else None,
            )

    def _sync_attrs(self, index: str, field_name: Optional[str], store) -> int:
        """100-id block diff + merge (reference holder.go:975-1067)."""
        if store is None:
            return 0
        repaired = 0
        for peer in self._peers():
            try:
                peer_blocks = self.cluster.client.attr_blocks(peer, index, field_name)
            except ClientError:
                continue
            local_blocks = dict(store.blocks())
            for block_id, checksum in peer_blocks:
                if local_blocks.get(block_id) == checksum:
                    continue
                try:
                    data = self.cluster.client.attr_block_data(
                        peer, index, field_name, block_id
                    )
                except ClientError:
                    continue
                for id_, attrs in data.items():
                    if attrs:
                        store.set_attrs(int(id_), attrs)
                        repaired += 1
                        global_stats.with_tags("kind:attr").count(
                            "anti_entropy_blocks_repaired_total"
                        )
        return repaired

    def _sync_translation(self) -> None:
        """Replica-side tail of the primary's key logs."""
        holder = self.cluster.holder
        if holder is None or self.cluster.is_coordinator():
            return
        for name in list(holder.indexes):
            idx = holder.index(name)
            if idx is None:
                continue
            stores = [idx.translate_store] + [
                idx.field(fn).translate_store
                for fn in list(idx.fields)
                if idx.field(fn) is not None
            ]
            for st in stores:
                if isinstance(st, ForwardingTranslateStore):
                    try:
                        st.sync_from_primary()
                    except ClientError:
                        pass


class SyncDaemon:
    """Background thread running anti-entropy + translate tailing on an
    interval (reference monitorAntiEntropy server.go:514)."""

    def __init__(self, cluster, interval: float = 600.0, logger=None):
        self.cluster = cluster
        self.interval = interval
        self.syncer = HolderSyncer(cluster, logger)
        self.log = logger or NopLogger()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SyncDaemon":
        from pilosa_tpu_torch.utils.threads import spawn

        self._thread = spawn("sync-daemon", self._run)
        return self

    def _run(self) -> None:
        # ±25% jitter per cycle: a fleet restarted
        # together would otherwise run synchronized cluster-wide checksum
        # storms at every interval, forever — the phases decorrelate
        # within a few cycles instead.
        from pilosa_tpu_torch.utils.deadline import Deadline, deadline_scope

        while not self._stop.wait(self.interval * (0.75 + 0.5 * random.random())):
            try:
                # Budget the whole pass (deadline-scope rule): every
                # peer RPC below bounds its socket timeout by the
                # remainder and rides X-Pilosa-Deadline, so a stalled
                # peer can pin the syncer for at most one pass — the
                # next jittered cycle starts from a clean budget. The
                # 60 s floor keeps test-sized intervals from starving
                # an honest pass.
                with deadline_scope(Deadline(max(self.interval, 60.0))):
                    n = self.syncer.sync_holder()
                    self.syncer._sync_translation()
                if n:
                    self.log.printf("anti-entropy: repaired %d blocks", n)
            except Exception as e:
                self.log.printf("anti-entropy error: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class FailureDetector:
    """Static-topology liveness probe (the gossip-membership replacement:
    the cluster's peers are fixed, SURVEY.md §2.2 gossip row)."""

    def __init__(self, cluster, interval: float = 1.0, confirm_down: int = CONFIRM_DOWN,
                 logger=None):
        self.cluster = cluster
        # Backref for the asymmetric-partition guard: disseminated DOWN
        # claims consult our probe history (cluster.receive_message).
        cluster.failure_detector = self
        self.interval = interval
        self.confirm_down = confirm_down
        self.log = logger or NopLogger()
        self._fails: dict[str, int] = {}
        # Guards the confirm counters: the probe loop's increments race
        # the message handler's vote_down RMWs on the same key
        # (shared-state rule), and a lost increment delays a legitimate
        # DOWN confirmation by a whole probe sweep.
        self._fails_lock = threading.Lock()
        # (peer id, subject id) -> last state that peer reported for the
        # subject. Peer-view DOWN observations vote only on the
        # TRANSITION to DOWN (SWIM-style), not on every repeated stale
        # snapshot — re-counting an unchanged report each sweep would
        # flap a recovered node back DOWN.
        self._peer_reports: dict[tuple[str, str], str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def vote_down(self, node_id: str) -> bool:
        """A peer's disseminated DOWN claim counts as ONE vote on our
        confirm counter — same SWIM discipline as _merge_peer_view,
        never an outright overwrite (a single transient local probe
        failure plus one broadcast must not mark a reachable node DOWN).
        No vote at all while our probes succeed.
        Returns True when the accumulated evidence reaches
        confirm_down (the caller then applies the DOWN)."""
        with self._fails_lock:
            if self._fails.get(node_id, 0) <= 0:
                return False
            self._fails[node_id] += 1
            return self._fails[node_id] >= self.confirm_down

    def probe_once(self) -> None:
        topo = self.cluster.topology
        local_id = self.cluster.local_node.id
        for node in list(topo.nodes):
            if node.id == local_id:
                continue
            try:
                st = self.cluster.client.status(node)
                ok = True
            except ClientError:
                st = None
                ok = False
            if ok:
                with self._fails_lock:
                    self._fails[node.id] = 0
                if node.state == NODE_STATE_DOWN:
                    node.state = NODE_STATE_READY
                    self.log.printf("node %s is back up", node.id)
                    _count_transition(node.id, NODE_STATE_READY)
                    self._disseminate(node.id, NODE_STATE_READY)
                    self._heal_returning_node(node)
                self._merge_peer_view(node, st)
            else:
                global_stats.with_tags(f"peer:{node.id}").count(
                    "cluster_probe_failures_total"
                )
                with self._fails_lock:
                    self._fails[node.id] = self._fails.get(node.id, 0) + 1
                    confirmed = self._fails[node.id] >= self.confirm_down
                if confirmed and node.state != NODE_STATE_DOWN:
                    node.state = NODE_STATE_DOWN
                    self.log.printf("node %s marked down", node.id)
                    _count_transition(node.id, NODE_STATE_DOWN)
                    self._disseminate(node.id, NODE_STATE_DOWN)
        # Cluster state follows membership (reference determineClusterState
        # cluster.go:571): any down node + replication -> DEGRADED.
        from pilosa_tpu_torch.cluster.topology import STATE_DEGRADED, STATE_NORMAL

        any_down = any(n.state == NODE_STATE_DOWN for n in topo.nodes)
        state = self.cluster.state()
        if any_down and topo.replica_n > 1 and state == STATE_NORMAL:
            self.cluster.set_state(STATE_DEGRADED)
        elif not any_down and state == STATE_DEGRADED:
            self.cluster.set_state(STATE_NORMAL)
        self._maybe_promote_coordinator()

    # -- piggybacked membership exchange -------------------

    def _merge_peer_view(self, peer, st: Optional[dict]) -> None:
        """Each probe response carries the peer's full node view — merge
        it (the gossip LocalState/MergeRemoteState NodeStatus exchange,
        reference gossip.go:321-362, piggybacked on the existing probe
        loop instead of a separate transport):

        - A peer-observed DOWN for a third node counts as ONE vote on our
          confirm-down counter — but only on the peer's TRANSITION to
          reporting DOWN, and only while our own probes of that node are
          also failing (votes accelerate a DOWN we are witnessing; they
          never originate one for a node we can reach). k probing peers
          then converge in ~confirm_down/k rounds instead of each
          independently burning confirm_down probes.
        - A coordinator flag on a live peer view replaces ours when OUR
          recorded coordinator is dead or missing — how a node that
          missed MSG_SET_COORDINATOR (e.g. was partitioned during the
          failover) catches up without any coordinator involvement.
        """
        if not st:
            return
        # View-epoch piggyback on the probe plane:
        # every probe response refreshes the peer's epoch report, so
        # the clustered result cache's staleness window for writes that
        # never route through the coordinator is bounded by the probe
        # interval.
        epochs = st.get("indexEpochs")
        if isinstance(epochs, dict):
            self.cluster.fold_peer_epochs(
                {"node": peer.id, "boot": st.get("indexEpochsBoot"),
                 "indexes": epochs}
            )
        local = {n.id: n for n in self.cluster.topology.nodes}
        local_id = self.cluster.local_node.id
        for nd in st.get("nodes", []):
            nid = nd.get("id")
            target = local.get(nid)
            if target is None or nid in (local_id, peer.id):
                continue
            state = nd.get("state")
            prev = self._peer_reports.get((peer.id, nid))
            self._peer_reports[(peer.id, nid)] = state
            if (
                state == NODE_STATE_DOWN
                and prev != NODE_STATE_DOWN  # transition, not a stale echo
                and target.state != NODE_STATE_DOWN
                # vote_down is the one locked counter path: "we are
                # failing it too" + increment + confirm, atomically.
                and self.vote_down(nid)
            ):
                target.state = NODE_STATE_DOWN
                self.log.printf(
                    "node %s marked down (peer %s's observation)",
                    nid, peer.id,
                )
                _count_transition(nid, NODE_STATE_DOWN)
                self._disseminate(nid, NODE_STATE_DOWN)
        peer_coord = next(
            (nd.get("id") for nd in st.get("nodes", []) if nd.get("isCoordinator")),
            None,
        )
        if peer_coord is not None:
            ours = next(
                (n for n in self.cluster.topology.nodes if n.is_coordinator), None
            )
            cand = local.get(peer_coord)
            if (
                cand is not None
                and cand.state != NODE_STATE_DOWN
                and (ours is None or ours.state == NODE_STATE_DOWN)
                and (ours is None or ours.id != peer_coord)
            ):
                was_coordinator = self.cluster.local_node.is_coordinator
                for n in self.cluster.topology.nodes:
                    n.is_coordinator = n.id == peer_coord
                self.cluster.local_node.is_coordinator = local_id == peer_coord
                self.cluster.persist_topology()
                self.log.printf(
                    "adopted coordinator %s from peer %s's view", peer_coord, peer.id
                )
                if (
                    self.cluster.local_node.is_coordinator
                    and not was_coordinator
                    and self.cluster.resizer is not None
                ):
                    self.cluster.resizer.on_promoted()
        # A peer frozen in RESIZING on a job this (coordinator) node
        # doesn't own reports the orphaned job in its /status; adopt and
        # abort it so the follower unfreezes before its own lease fires.
        from pilosa_tpu_torch.cluster.topology import STATE_RESIZING

        rz_info = st.get("resize")
        if (
            rz_info
            and st.get("state") == STATE_RESIZING
            and self.cluster.is_coordinator()
            and self.cluster.resizer is not None
        ):
            self.cluster.resizer.observe_follower(rz_info)

    def _heal_returning_node(self, node) -> None:
        """A node that comes back READY missed every broadcast while it
        was down; if WE are the coordinator, re-send it the coordinator
        identity + current membership so a returning OLD coordinator
        stops believing it still leads (reference re-sends ClusterStatus
        on nodeJoin, cluster.go:2121)."""
        if not self.cluster.is_coordinator():
            return
        from pilosa_tpu_torch.cluster import broadcast as bc

        try:
            self.cluster.broadcaster.send_to(
                node,
                bc.Message.make(
                    bc.MSG_SET_COORDINATOR, id=self.cluster.local_node.id
                ),
            )
            self.cluster.broadcaster.send_to(
                node,
                bc.Message.make(
                    bc.MSG_CLUSTER_STATUS,
                    state=self.cluster.state(),
                    nodes=self.cluster.nodes_json(),
                    replicaN=self.cluster.topology.replica_n,
                ),
            )
        except Exception as e:  # noqa: BLE001 — next probe retries
            self.log.printf("heal status to %s failed: %s", node.id, e)

    def _maybe_promote_coordinator(self) -> None:
        """Coordinator failover (reference
        api.go:1193-1261 SetCoordinator made automatic): when the
        recorded coordinator is confirmed DOWN, the lowest-id READY node
        deterministically promotes itself and broadcasts
        MSG_SET_COORDINATOR — every live node computes the same
        successor, so there is no election traffic; laggards converge
        via the broadcast or the piggybacked view merge above. The
        translate primary and join/resize handling follow coordinator()
        dynamically, so they move with the flag."""
        topo = self.cluster.topology
        coord = next((n for n in topo.nodes if n.is_coordinator), None)
        if coord is None or coord.state != NODE_STATE_DOWN:
            return
        ready = [n for n in topo.nodes if n.state != NODE_STATE_DOWN]
        if not ready:
            return
        successor = min(ready, key=lambda n: n.id)
        if successor.id != self.cluster.local_node.id:
            return  # the successor promotes itself; we adopt its broadcast
        self.log.printf(
            "coordinator %s is down: promoting self (%s)", coord.id, successor.id
        )
        global_stats.count("cluster_coordinator_promotions_total")
        from pilosa_tpu_torch.cluster import broadcast as bc

        for n in topo.nodes:
            n.is_coordinator = n.id == successor.id
        self.cluster.local_node.is_coordinator = True
        self.cluster.persist_topology()
        self.cluster.broadcaster.send_async(
            bc.Message.make(bc.MSG_SET_COORDINATOR, id=successor.id)
        )
        # A promotion mid-resize adopts (and aborts) the dead
        # coordinator's orphaned job so followers unfreeze without
        # waiting out their leases.
        if self.cluster.resizer is not None:
            self.cluster.resizer.on_promoted()

    def _disseminate(self, node_id: str, state: str) -> None:
        """Share the observed transition over the broadcast bus so every
        node's view converges within one probe interval instead of each
        independently burning confirm_down probes (reference shares
        membership via gossip events, gossip.go:364-443). Best-effort:
        probes keep running either way."""
        from pilosa_tpu_torch.cluster import broadcast as bc

        try:
            self.cluster.broadcaster.send_async(
                bc.Message.make(bc.MSG_NODE_STATE, id=node_id, state=state)
            )
        except Exception as e:  # noqa: BLE001 — liveness must not die
            self.log.printf("node-state broadcast failed: %s", e)

    def start(self) -> "FailureDetector":
        from pilosa_tpu_torch.utils.threads import spawn

        self._thread = spawn("failure-detector", self._run)
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.probe_once()
            except Exception as e:
                self.log.printf("failure detector error: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
