"""Cluster resize: elastic add/remove of nodes with fragment re-placement
(reference cluster.go:784-868 fragSources, :1196-1441 resizeJob /
followResizeInstruction, holder.go:1104 holderCleaner).

Flow (coordinator-driven state machine, reference cluster.go:47-50):

1. Coordinator receives add/remove (HTTP endpoint or a JOIN node event),
   snapshots the old topology, builds the new one, and diffs placement:
   for every (index, shard) a node owns in the NEW topology but not the
   OLD, an instruction entry points it at a surviving old owner.
2. State broadcasts to RESIZING (API writes 503 during the move), then
   each node gets a MSG_RESIZE_INSTRUCTION and fetches whole fragments
   over /internal/fragment/data (reference RetrieveShardFromURI
   http/client.go:742), unioning them into local storage.
3. Nodes report MSG_RESIZE_COMPLETE; when all have, the coordinator
   broadcasts the new node list with state NORMAL; every node then drops
   fragments it no longer owns (holderCleaner).
4. Abort (POST /cluster/resize/abort, reference api.go:1250) rolls state
   back to NORMAL on the old topology.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from pilosa_tpu_torch.cluster import broadcast as bc
from pilosa_tpu_torch.cluster.broadcast import Message
from pilosa_tpu_torch.cluster.client import ClientError
from pilosa_tpu_torch.cluster.topology import (
    NODE_STATE_DOWN,
    Node,
    STATE_NORMAL,
    STATE_RESIZING,
    Topology,
)
from pilosa_tpu_torch.utils.logger import NopLogger
from pilosa_tpu_torch.utils.stats import global_stats


class ResizeError(Exception):
    pass


def _grow_bsi_depth(f, view_name: str, shard: int) -> None:
    """A migrated BSI fragment brings its bit planes: grow the field's bit
    depth to them, as set_value and import_value do for the values they
    write. Without it a node that received a field's values only by
    migration reads them at the depth it had (0 on a joiner). The JAX
    package's migration leaves the depth as it was, so its cluster answers
    Sum, Min, Max and BSI conditions from truncated values after a resize
    (tests/test_torch_resize.py pins that)."""
    from pilosa_tpu_torch.core.field import FIELD_TYPE_INT
    from pilosa_tpu_torch.core.fragment import BSI_OFFSET_BIT
    from pilosa_tpu_torch.core.view import bsi_view_name

    if f.options.type != FIELD_TYPE_INT or view_name != bsi_view_name(f.name):
        return
    frag = f.view(view_name).fragment(shard)
    depth = frag.max_row_id + 1 - BSI_OFFSET_BIT if frag is not None else 0
    with f.lock:
        if depth > f.options.bit_depth:
            f.options.bit_depth = depth
            f.save_meta()


class Resizer:
    """Owns resize jobs on the coordinator and instruction-following on
    every node. Installed via cluster.attach_resizer()."""

    #: Coordinator-side auto-abort: a job whose completions don't all
    #: arrive within this window rolls back instead of wedging the
    #: cluster in RESIZING (no manual-abort-only escape).
    job_timeout: float = 600.0
    #: Follower-side lease: a node frozen in
    #: RESIZING that hears neither a coordinator heartbeat nor a terminal
    #: status for this long rolls itself back to NORMAL on the old
    #: topology. This is the escape hatch the coordinator's own timer
    #: cannot be — that timer dies with the coordinator process, and a
    #: dead coordinator used to strand every follower answering 503
    #: forever. Config knob: resize-lease.
    lease_timeout: float = 90.0
    #: Per-source retry budget for transient fragment-fetch failures
    #: (transport, checksum mismatch, 5xx) before failing over to the
    #: next surviving old owner.
    fetch_retries: int = 2
    #: Concurrent fragment fetches per instruction (config knob:
    #: migration-concurrency). Bounded so a resize's fan-in cannot
    #: starve the serving path's sockets and device time.
    fetch_concurrency: int = 2
    #: Aggregate migration bandwidth cap in bytes/s across all fetch
    #: workers (config knob: migration-bandwidth; 0 = uncapped).
    bandwidth_limit: int = 0
    #: Per-RPC budget for migration fetches: each fetch opens a Deadline
    #: scope (the deadline plane) so its socket timeout is bounded and the
    #: budget rides X-Pilosa-Deadline to the source node.
    fetch_timeout: float = 30.0

    def __init__(self, cluster, logger=None):
        self.cluster = cluster
        self.log = logger or NopLogger()
        self._lock = threading.RLock()
        self._job_id = 0
        # Job epoch: instructions and completions
        # carry it, mark_complete requires it to match. A promoted
        # coordinator adopting a dead coordinator's in-flight job bumps
        # past the highest epoch it observed, so the dead job's stale
        # COMPLETEs can never satisfy a new job whose fresh counter
        # happens to reuse the same job id.
        self._epoch = 0
        # Highest epoch / last job this node observed as a follower
        # (instructions, heartbeats) — what a promotion adopts from.
        self._observed_epoch = 0
        self._observed_job: Optional[int] = None
        # Coordinator-side live job state.
        self._active_job: Optional[int] = None
        self._pending_nodes: set[str] = set()
        self._new_nodes: Optional[list[Node]] = None
        self._notify_nodes: list[Node] = []
        self._timer: Optional[threading.Timer] = None
        # Follower-side lease timer + coordinator-side heartbeat stop.
        self._lease: Optional[threading.Timer] = None
        self._hb_stop: Optional[threading.Event] = None
        # Migration-fetch cancellation: each follow_instruction run gets
        # a generation; a lease expiry or abort cancels the CURRENT
        # generation so in-flight fetch workers stop instead of
        # migrating (and re-arming cleanup) for a dead job.
        self._follow_gen = 0
        self._follow_cancel_gen = 0
        # Aggregate bandwidth pacing across concurrent fetch workers.
        self._bw_lock = threading.Lock()
        self._bw_next = 0.0
        # (index, shard) pairs an active instruction is currently
        # migrating onto this node: the
        # anti-entropy / read-repair planes skip these — a repair
        # sourced mid-move would treat a half-migrated fragment as
        # truth. Guarded by its own leaf lock: the hot consumer is the
        # sync loop, which must not contend on the resizer RLock the
        # coordinator's inline instruction-follow holds.
        self._migrating: set[tuple[str, int]] = set()
        self._migrating_lock = threading.Lock()
        # Set on every node while it should clean after the topology flips.
        self._needs_clean = False
        cluster.resizer = self

    # -- coordinator: job control (reference cluster.go:1196) --------------

    def add_node(self, node: Node) -> int:
        """Grow the cluster by one node; returns the job id."""
        with self._lock:
            if self.cluster.topology.node_by_id(node.id) is not None:
                raise ResizeError(f"node already in cluster: {node.id}")
            new_nodes = [
                Node(n.id, n.uri, n.is_coordinator, n.state)
                for n in self.cluster.topology.nodes
            ] + [Node(node.id, node.uri, False)]
            # lint: allow-lock-discipline(control plane: job mutations serialize across the announce RPCs by design; the data path never takes this lock)
            return self._start_job(new_nodes)

    def remove_node(self, node_id: str) -> int:
        with self._lock:
            gone = self.cluster.topology.node_by_id(node_id)
            if gone is None:
                raise ResizeError(f"node not in cluster: {node_id}")
            if gone.is_coordinator:
                raise ResizeError("cannot remove the coordinator")
            new_nodes = [
                Node(n.id, n.uri, n.is_coordinator, n.state)
                for n in self.cluster.topology.nodes
                if n.id != node_id
            ]
            # lint: allow-lock-discipline(control plane: job mutations serialize across the announce RPCs by design; the data path never takes this lock)
            return self._start_job(new_nodes, removed=gone)

    def handle_join(self, node: Node) -> None:
        """A JOIN node event on the coordinator triggers a grow job
        (reference listenForJoins cluster.go:1141)."""
        try:
            self.add_node(node)
        except ResizeError:
            # Two reasons land here. A resize job already running: do
            # nothing, the joiner keeps re-announcing. Already a member:
            # that is a RESTARTED --join node — it
            # boots single-node believing itself coordinator while the
            # cluster still routes shards to it, so re-send the current
            # schema + cluster status directly instead of silently
            # dropping the announce (reference nodeJoin re-sends
            # ClusterStatus to existing members, cluster.go:2121-2134).
            if self.cluster.topology.node_by_id(node.id) is None:
                return
            schema = (
                {"indexes": self.cluster.holder.schema()}
                if self.cluster.holder is not None
                else {}
            )
            status = Message.make(
                bc.MSG_CLUSTER_STATUS,
                state=self.cluster.state(),
                nodes=[n.to_json() for n in self.cluster.topology.nodes],
                replicaN=self.cluster.topology.replica_n,
            )
            try:
                self.cluster.broadcaster.send_to(
                    node,
                    Message.make(
                        bc.MSG_NODE_STATUS,
                        schema=schema,
                        # available shards too: the restarted node must
                        # fan queries out over every shard immediately,
                        # not after the next anti-entropy pass (the
                        # normal join path ships this in the resize
                        # instruction for the same reason).
                        available=self._available_map(),
                    ),
                )
                self.cluster.broadcaster.send_to(node, status)
            except Exception as e:  # noqa: BLE001 — joiner re-announces
                self.log.printf("resize: rejoin status to %s failed: %s", node.id, e)

    def _start_job(self, new_nodes: list[Node], removed: Optional[Node] = None) -> int:
        if not self.cluster.is_coordinator():
            raise ResizeError("resize must run on the coordinator")
        if self._new_nodes is not None:
            raise ResizeError("a resize job is already running")
        old_topo = self.cluster.topology
        new_topo = Topology(
            nodes=new_nodes,
            replica_n=old_topo.replica_n,
            partition_n=old_topo.partition_n,
            hasher=old_topo.hasher,
        )
        self._job_id += 1
        # Every job gets a FRESH epoch, so a dead job's straggler
        # COMPLETE (still retrying through its reporter's backoff) can
        # never carry this job's (job, epoch) identity even when the
        # job counter collides across aborts or coordinator changes.
        self._epoch += 1
        job = self._job_id
        self._active_job = job
        self._new_nodes = new_topo.nodes
        # Counted the moment the job is armed, not after start succeeds:
        # a start that fails mid-delivery runs abort() (counting
        # resize_jobs_aborted_total), and started >= completed + aborted
        # must hold for any jobs-in-flight dashboard expression.
        global_stats.count("resize_jobs_started_total")
        instructions = self._build_instructions(old_topo, new_topo, removed)
        # DOWN members cannot follow instructions or report completion —
        # waiting on them (or fail-fasting on their freeze delivery)
        # would wedge every post-failover join until the dead node
        # returns. They keep their membership; anti-entropy re-syncs
        # them when they come back.
        live_new = [n for n in new_topo.nodes if n.state != NODE_STATE_DOWN]
        self._pending_nodes = {n.id for n in live_new}
        # Final-status recipients: the union of old and new membership — a
        # removed node must still see the flip back to NORMAL.
        notify = {n.id: n for n in old_topo.nodes}
        notify.update({n.id: n for n in new_topo.nodes})
        self._notify_nodes = list(notify.values())

        # Anything failing past this point (state broadcast, instruction
        # delivery, local follow) must roll back rather than leave the
        # cluster frozen in RESIZING with a half-armed job.
        try:
            # Freeze writes cluster-wide while fragments move. The freeze
            # is a safety invariant for every node that SURVIVES into the
            # new topology (a survivor that keeps accepting writes while
            # its fragments copy would silently lose them at the flip), so
            # delivery to survivors is fail-fast; a node being removed is
            # best-effort — it is usually being removed precisely because
            # it is dead, and its post-freeze writes are lost by design
            # (the reference leaves removed-node data dirs behind too).
            self.cluster.set_state(STATE_RESIZING)
            freeze = Message.make(bc.MSG_CLUSTER_STATUS, state=STATE_RESIZING)
            live_ids = {n.id for n in live_new}
            for node in self._notify_nodes:
                if node.id == self.cluster.local_node.id:
                    continue
                try:
                    self.cluster.broadcaster.send_to(node, freeze)
                except Exception as e:
                    if node.id in live_ids:
                        raise ResizeError(
                            f"freeze broadcast to {node.id} failed: {e}"
                        ) from e
                    self.log.printf(
                        "resize: freeze to leaving/down node %s failed: %s",
                        node.id, e,
                    )
            schema = {"indexes": self.cluster.holder.schema()} if self.cluster.holder else {}
            available = self._available_map()
            for node in live_new:
                msg = Message.make(
                    bc.MSG_RESIZE_INSTRUCTION,
                    job=job,
                    epoch=self._epoch,
                    node=node.id,
                    coordinator=self.cluster.local_node.to_json(),
                    sources=instructions.get(node.id, []),
                    schema=schema,
                    available=available,
                )
                if node.id == self.cluster.local_node.id:
                    self.follow_instruction(msg)
                else:
                    try:
                        self.cluster.broadcaster.send_to(node, msg)
                    except Exception as e:
                        # An unreachable node would wedge the job in
                        # RESIZING forever; roll back instead.
                        raise ResizeError(
                            f"instruction delivery to {node.id} failed: {e}"
                        ) from e
        except Exception as e:
            self.log.printf("resize: job %d failed to start: %s", job, e)
            self.abort()
            raise
        global_stats.gauge("resize_pending_nodes", len(self._pending_nodes))
        # The bumped epoch rides the topology file so a coordinator
        # RESTART cannot mint a fresh job with a dead job's identity.
        self.cluster.persist_topology()
        self._arm_timeout(job)
        self._start_heartbeats(job)
        return job

    def _broadcast_best_effort(self, msg: Message, nodes=None) -> None:
        """Deliver to the given nodes (default: current topology), logging
        failures instead of raising: a dead peer must not stop state
        transitions from reaching the survivors (a
        fail-fast send_sync left reachable nodes frozen in RESIZING)."""
        for node in (nodes if nodes is not None else self.cluster.topology.nodes):
            if node.id == self.cluster.local_node.id:
                continue
            try:
                self.cluster.broadcaster.send_to(node, msg)
            except Exception as e:
                self.log.printf("resize: broadcast to %s failed: %s", node.id, e)

    def _arm_timeout(self, job: int) -> None:
        t = threading.Timer(self.job_timeout, self._timeout_job, args=(job,))
        t.daemon = True
        with self._lock:
            self._timer = t
        t.start()

    def _timeout_job(self, job: int) -> None:
        with self._lock:
            if self._active_job != job or self._new_nodes is None:
                return  # completed or already aborted
            pending = sorted(self._pending_nodes)
        self.log.printf(
            "resize job %d timed out after %.0fs waiting on %s: aborting",
            job, self.job_timeout, pending,
        )
        # only_job guards the race where the final completion lands
        # between the check above and the abort: aborting a job that
        # already finished would re-freeze the NEW topology.
        self.abort(only_job=job)

    # -- coordinator: liveness heartbeats ------------

    def _start_heartbeats(self, job: int) -> None:
        """While a job is in flight the coordinator heartbeats every
        participant; followers renew their rollback lease on each one.
        When the coordinator process dies the heartbeats stop with it and
        every follower's lease expires — the failover path that used to
        not exist."""
        stop = threading.Event()
        with self._lock:
            if self._hb_stop is not None:
                self._hb_stop.set()
            self._hb_stop = stop
        from pilosa_tpu_torch.utils.threads import spawn

        spawn("resize-lease", self._heartbeat_loop, args=(job, stop))

    def _heartbeat_loop(self, job: int, stop: threading.Event) -> None:
        # 3 heartbeats per lease window: one lost datagram-equivalent
        # cannot expire a healthy job's lease.
        interval = max(self.lease_timeout / 3.0, 0.05)
        while not stop.wait(interval):
            with self._lock:
                if self._active_job != job:
                    return
                targets = list(self._notify_nodes)
                msg = Message.make(
                    bc.MSG_RESIZE_HEARTBEAT, job=job, epoch=self._epoch
                )
            self._broadcast_best_effort(msg, targets)

    def _stop_heartbeats(self) -> None:
        with self._lock:
            stop, self._hb_stop = self._hb_stop, None
        if stop is not None:
            stop.set()

    # -- every node: rollback lease ------------------

    def renew_lease(self, msg: Optional[Message] = None) -> None:
        """(Re)arm the follower-side rollback lease. Called when this
        node observes the cluster freeze (MSG_CLUSTER_STATUS RESIZING),
        receives a resize instruction, or receives a coordinator
        heartbeat. The coordinator's own job is excluded — its
        job_timeout owns termination there."""
        if msg is not None:
            with self._lock:
                self._observed_epoch = max(
                    self._observed_epoch, int(msg.get("epoch") or 0)
                )
                if msg.get("job") is not None:
                    self._observed_job = msg.get("job")
        with self._lock:
            if self._new_nodes is not None:
                return  # our own job: the coordinator timer covers it
            if self._lease is not None:
                self._lease.cancel()
            t = threading.Timer(self.lease_timeout, self._lease_expired)
            t.daemon = True
            self._lease = t
        t.start()

    def cancel_lease(self) -> None:
        with self._lock:
            if self._lease is not None:
                self._lease.cancel()
                self._lease = None

    def _lease_expired(self) -> None:
        """No coordinator heartbeat or terminal status inside the lease
        window: the coordinator (or its job) is gone. Roll THIS node back
        to NORMAL on the old topology — the topology only flips on the
        completion broadcast, so state is all that needs reverting — and
        drop any pending cleanup (we may still own fragments the dead job
        meant to move)."""
        with self._lock:
            self._lease = None
        if self.cluster.state() != STATE_RESIZING:
            # Terminal status raced the timer: nothing to do. Checked
            # BEFORE touching _needs_clean — the completed job's
            # clean_holder() still needs that flag.
            return
        with self._lock:
            self._needs_clean = False
            # Stop any in-flight migration workers: fetching (and
            # re-arming cleanup) for a dead job wastes the links and
            # imports shards the rolled-back topology may not own.
            self._follow_cancel_gen = self._follow_gen
        global_stats.count("resize_lease_expirations_total")
        self.log.printf(
            "resize: lease expired after %.0fs without coordinator "
            "heartbeat; rolling back to NORMAL on the old topology",
            self.lease_timeout,
        )
        self.cluster.set_state(STATE_NORMAL)

    def follower_status(self) -> Optional[dict]:
        """This node's view of an in-flight resize it is FOLLOWING —
        surfaced in /status so a promoted coordinator that never saw the
        job (the old coordinator died before freezing it) learns about
        it from its liveness probes and can abort it for the stranded
        followers."""
        state = self.cluster.state()
        with self._lock:
            if state != STATE_RESIZING or self._new_nodes is not None:
                return None
            return {"job": self._observed_job, "epoch": self._observed_epoch}

    def on_promoted(self) -> None:
        """The local node just became coordinator. Any resize job the
        dead coordinator left in flight is adopted — and adoption means
        owning its TERMINATION: the pending-completion set died with the
        old coordinator, so blindly completing could flip topology before
        fragment copies finished (silent data loss). Roll the cluster
        back to the old topology under a bumped epoch instead; stale
        COMPLETEs from the dead job are rejected by the epoch check, the
        operator re-issues the resize, and anti-entropy heals any
        partially-copied fragments."""
        state = self.cluster.state()
        with self._lock:
            observed = max(self._epoch, self._observed_epoch)
            if self._new_nodes is not None:
                return  # we own a live job already: nothing to adopt
            # Epoch advances PAST everything observed even when there is
            # nothing to abort: the dead coordinator's last job may still
            # have completion reports in retry flight, and our future
            # jobs must outrank it, never tie it.
            self._epoch = observed + 1
            if state != STATE_RESIZING:
                self.cluster.persist_topology()
                return
            job = self._observed_job
            epoch = self._epoch  # captured under the lock for the log
        self.cluster.persist_topology()
        global_stats.count("resize_jobs_adopted_total")
        self.log.printf(
            "resize: promoted mid-job; adopting orphaned job %s "
            "(new epoch %d) and aborting it", job, epoch,
        )
        self.abort()

    def observe_follower(self, info: dict) -> None:
        """Probe-reported resize state from a peer frozen in RESIZING on
        a job this coordinator doesn't own (we were promoted after the
        freeze reached them but before any instruction reached us):
        adopt-and-abort it so the stranded follower unfreezes before its
        own lease has to fire."""
        if not self.cluster.is_coordinator():
            return
        with self._lock:
            if self._new_nodes is not None:
                return  # our live job: heartbeats already cover the peer
            self._epoch = max(self._epoch, int(info.get("epoch") or 0) + 1)
            epoch = self._epoch  # captured under the lock for the log
        self.cluster.persist_topology()
        global_stats.count("resize_jobs_adopted_total")
        self.log.printf(
            "resize: follower reports orphaned job %s; aborting it "
            "(epoch now %d)", info.get("job"), epoch,
        )
        self.abort()

    def _available_map(self) -> dict:
        """index -> field -> cluster-wide available shards (the joiner must
        fan queries out to every shard, not just the ones it fetched)."""
        holder = self.cluster.holder
        out: dict[str, dict[str, list[int]]] = {}
        if holder is None:
            return out
        for index_name in list(holder.indexes):
            idx = holder.index(index_name)
            if idx is None:
                continue
            for field_name in list(idx.fields):
                f = idx.field(field_name)
                if f is not None:
                    out.setdefault(index_name, {})[field_name] = [
                        int(s) for s in f.available_shards().to_array().tolist()
                    ]
        return out

    def _build_instructions(self, old_topo: Topology, new_topo: Topology,
                            removed: Optional[Node]) -> dict[str, list[dict]]:
        """node id -> fragment sources (reference fragSources cluster.go:784).
        A node fetches every (index, field, shard) it owns in the new
        topology but not the old, from any surviving old owner."""
        holder = self.cluster.holder
        out: dict[str, list[dict]] = {}
        if holder is None:
            return out
        gone_id = removed.id if removed is not None else None
        for index_name in list(holder.indexes):
            idx = holder.index(index_name)
            if idx is None:
                continue
            for field_name in list(idx.fields):
                f = idx.field(field_name)
                if f is None:
                    continue
                for shard in f.available_shards().to_array().tolist():
                    old_owners = [
                        n for n in old_topo.shard_nodes(index_name, shard)
                        if n.id != gone_id and n.state != NODE_STATE_DOWN
                    ]
                    if removed is not None:
                        # The leaving node's data must survive: it stays a
                        # valid source for fragments only it holds.
                        old_owners = old_owners + [removed]
                    old_ids = {n.id for n in old_topo.shard_nodes(index_name, shard)}
                    if not old_owners:
                        continue
                    for node in new_topo.shard_nodes(index_name, shard):
                        if node.id in old_ids:
                            continue  # already holds it
                        src = next(
                            (o for o in old_owners if o.id != node.id), old_owners[0]
                        )
                        # Every OTHER surviving old owner rides along as
                        # an alternate: the fetcher fails over to them
                        # when the primary source flakes or serves a
                        # corrupt payload.
                        alts = [
                            str(o.uri)
                            for o in old_owners
                            if o.id not in (node.id, src.id)
                        ]
                        out.setdefault(node.id, []).append(
                            {
                                "index": index_name,
                                "field": field_name,
                                "shard": int(shard),
                                "from": str(src.uri),
                                "alts": alts,
                            }
                        )
        return out

    # -- every node: instruction following (reference cluster.go:1297) -----

    def follow_instruction(self, msg: Message) -> None:
        """Fetch assigned fragments, then report completion. Runs inline —
        callers that need async wrap it in a thread (the HTTP receive path
        does, so the coordinator isn't blocked on its own broadcast).

        Completion is reported even when the fetch fails part-way (with an
        'error' field): a silent dead thread would wedge the whole cluster
        in RESIZING; incomplete data heals via anti-entropy.
        """
        self.renew_lease(msg)
        err = None
        try:
            self._follow_instruction_inner(msg)
        except Exception as e:  # noqa: BLE001 — any failure must still report
            err = str(e)
            self.log.printf("resize: follow_instruction failed: %s", e)
        done = Message.make(
            bc.MSG_RESIZE_COMPLETE,
            job=msg.get("job"),
            epoch=int(msg.get("epoch") or 0),
            node=self.cluster.local_node.id,
            **({"error": err} if err else {}),
        )
        self._report_complete(done, msg)

    def _report_complete(self, done: Message, instruction: Message) -> None:
        """Deliver the completion report with capped jittered backoff
        against the CURRENTLY resolved coordinator, re-resolving each
        attempt: the old single-shot send was
        logged and dropped, so a coordinator crash between instruction
        and completion wedged the job even after a successor was
        promoted. Retries stop when the report lands, the cluster left
        RESIZING (abort/lease rollback owns recovery), or the lease
        window is spent (the lease rollback takes over)."""
        fallback = Node.from_json(instruction["coordinator"])
        backoff, cap = 0.25, 5.0
        give_up = time.monotonic() + self.lease_timeout
        attempt = 0
        while True:
            attempt += 1
            # Only an explicitly FLAGGED coordinator counts as resolved:
            # a joiner's topology is just itself until the flip, and the
            # positional coordinator() fallback would resolve the joiner
            # itself, silently self-delivering the report into the void.
            coord = next(
                (n for n in self.cluster.topology.nodes if n.is_coordinator),
                None,
            ) or fallback
            if coord.id == self.cluster.local_node.id:
                self.mark_complete(done)
                return
            try:
                self.cluster.broadcaster.send_to(coord, done)
                return
            except Exception as e:  # noqa: BLE001 — retried below
                global_stats.count("resize_complete_retries_total")
                self.log.printf(
                    "resize: completion report to %s failed "
                    "(attempt %d): %s", coord.id, attempt, e,
                )
            if (
                time.monotonic() >= give_up
                or self.cluster.state() != STATE_RESIZING
            ):
                self.log.printf(
                    "resize: giving up on completion report after %d "
                    "attempts; lease rollback owns recovery", attempt,
                )
                return
            time.sleep(min(backoff, cap) * (0.5 + random.random()))
            backoff = min(backoff * 2, cap)

    def _follow_instruction_inner(self, msg: Message) -> None:
        # A joining node first needs the schema the cluster already has.
        if self.cluster.api is not None and msg.get("schema"):
            self.cluster.api.apply_schema(msg["schema"])
        from pilosa_tpu_torch.cluster.sync import wrap_translate_stores

        wrap_translate_stores(self.cluster)
        holder = self.cluster.holder
        for index_name, fields in msg.get("available", {}).items():
            idx = holder.index(index_name) if holder else None
            if idx is None:
                continue
            for field_name, shards in fields.items():
                f = idx.field(field_name)
                if f is not None:
                    for s in shards:
                        f.add_available_shard(int(s))
        # Shard-migration progress gauges: a wedged resize is
        # a flatlined resize_migration_sources_done under a nonzero
        # _total, instead of silence. Totals are per-instruction (they
        # reset when the next job's instruction arrives).
        sources = msg.get("sources", [])
        global_stats.gauge("resize_migration_sources_total", len(sources))
        global_stats.gauge("resize_migration_sources_done", 0)
        # Window the whole instruction's shard set as migration-in-flight
        # (not per-source): a queued-but-unfetched source is about to be
        # overwritten, so repairing it mid-window is wasted work at best
        # and a half-block ship at worst.
        inflight_keys = {
            (str(s.get("index")), int(s.get("shard", 0))) for s in sources
        }
        with self._migrating_lock:
            self._migrating |= inflight_keys
        # Bounded fan-out: fetch_concurrency
        # workers pull sources off a shared queue; failures are
        # aggregated and reported in the completion's error field (the
        # topology still flips — incomplete data heals via anti-entropy)
        # instead of silently skipped.
        workers = max(int(self.fetch_concurrency), 1)
        state_lock = threading.Lock()
        n_done = [0]
        errors: list[str] = []
        queue = list(sources)
        with self._lock:
            self._follow_gen += 1
            gen = self._follow_gen

        def cancelled() -> bool:
            # Deliberately lockless: the coordinator's own instruction
            # runs INLINE under self._lock (add_node → _start_job →
            # follow_instruction), so workers taking the lock here would
            # deadlock against the joining owner. Single int read is
            # atomic; a one-iteration-late cancel observation is fine.
            return self._follow_cancel_gen >= gen

        def worker() -> None:
            while True:
                if cancelled():
                    return  # lease expired / job aborted: stop migrating
                with state_lock:
                    if not queue:
                        return
                    src = queue.pop(0)
                try:
                    self._fetch_source(holder, src, cancelled)
                except Exception as e:  # noqa: BLE001 — aggregated below
                    self.log.printf(
                        "resize: source %s/%s/%s failed: %s",
                        src.get("index"), src.get("field"),
                        src.get("shard"), e,
                    )
                    with state_lock:
                        errors.append(
                            f"{src.get('index')}/{src.get('field')}/"
                            f"{src.get('shard')}: {e}"
                        )
                finally:
                    with state_lock:
                        n_done[0] += 1
                        global_stats.gauge(
                            "resize_migration_sources_done", n_done[0]
                        )

        from pilosa_tpu_torch.utils.threads import spawn

        threads = [
            spawn("resize-worker", worker, start=False)
            for _ in range(min(workers, max(len(sources), 1)))
        ]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            # The move window is over (success, cancel, or error): the
            # repair planes may touch these shards again. Set-difference,
            # not clear: an overlapping instruction for OTHER shards
            # keeps its registrations (two windows sharing a shard — a
            # failover re-delivery — just degrade that shard to the
            # pre-skip behavior one pass early, which is safe).
            with self._migrating_lock:
                self._migrating -= inflight_keys
        # Unconditional final set: sources skipped at the tail (field not
        # held locally) must not leave _done below _total forever — that
        # is the wedged-resize signature and would be a standing false
        # alarm on a job that completed fine.
        global_stats.gauge("resize_migration_sources_done", len(sources))
        if cancelled():
            # The lease rollback (or abort) already decided this job is
            # dead: _needs_clean must stay dropped — re-arming it would
            # let the NEXT terminal status trigger cleanup off a dead
            # job's state.
            raise ResizeError(
                "migration cancelled (lease expired or job aborted)"
            )
        self._needs_clean = True
        if errors:
            raise ResizeError(
                f"{len(errors)} of {len(sources)} fragment sources "
                "failed: " + "; ".join(errors[:3])
            )

    def migration_in_flight(self, index: str, shard: int) -> bool:
        """True while an active instruction is migrating this shard onto
        this node — the anti-entropy/read-repair skip predicate
        (anti_entropy_skipped_total{reason=resizing})."""
        with self._migrating_lock:
            return (index, int(shard)) in self._migrating

    # -- migration fetch plane -----------------------

    def _fetch_source(self, holder, src: dict, cancelled=None) -> None:
        """One instruction source: every view of one (index, field,
        shard), verified and failover-capable. The primary source plus
        every other surviving old owner ('alts') are candidates.
        cancelled (optional callable) is checked between views so a
        lease expiry or abort stops a long throttled fetch mid-source."""
        from pilosa_tpu_torch.utils.deadline import Deadline, deadline_scope

        index, field_name = src["index"], src["field"]
        shard = int(src["shard"])
        candidates = [src["from"]] + [
            u for u in src.get("alts", []) if u != src["from"]
        ]
        idx = holder.index(index) if holder else None
        f = idx.field(field_name) if idx else None
        if f is None:
            return
        view_names = None
        last_err: Optional[Exception] = None
        for uri in candidates:
            try:
                with deadline_scope(Deadline(self.fetch_timeout)):
                    view_names = self.cluster.client.field_state(
                        uri, index, field_name
                    ).get("views", [])
                break
            except ClientError as e:
                last_err = e
                self._count_fetch_error(e)
        if view_names is None:
            raise ResizeError(
                f"no reachable source for view list: {last_err}"
            )
        for view_name in view_names:
            if cancelled is not None and cancelled():
                raise ResizeError("migration cancelled mid-source")
            data = self._fetch_fragment(
                candidates, index, field_name, view_name, shard
            )
            if data is None:
                continue  # absent on every surviving source
            # epoch_unknown: this is a COPY of another replica's data,
            # not a new write — minting fresh block epochs here would
            # out-date genuinely newer blocks on surviving replicas and
            # let directed repair wipe them with this (possibly stale)
            # migrated snapshot.
            f.import_roaring(
                shard, data, view_name=view_name, epoch_unknown=True
            )
            _grow_bsi_depth(f, view_name, shard)
            self._throttle(len(data))
        f.add_available_shard(shard)
        global_stats.count("resize_fragments_fetched_total")

    def _fetch_fragment(self, candidates, index: str, field: str,
                        view: str, shard: int) -> Optional[bytes]:
        """One verified fragment payload from the first source able to
        serve it. A 404 is a peer DECISION — 'fragment absent in this
        view' — and moves to the next source without burning retries
        (the old `except ClientError: continue` conflated it with
        transport failure, silently skipping fragments a flaky link
        owed us). Transient failures (transport, checksum mismatch,
        5xx) get bounded per-source retries with jittered backoff, then
        fail over to the next surviving old owner. Checksum
        verification happens in the client (retrieve_shard): a corrupt
        transfer raises before import_roaring can ever ingest it."""
        from pilosa_tpu_torch.utils.deadline import Deadline, deadline_scope

        last_err: Optional[Exception] = None
        for uri in candidates:
            delay = 0.05
            for attempt in range(max(self.fetch_retries, 0) + 1):
                try:
                    with deadline_scope(Deadline(self.fetch_timeout)):
                        return self.cluster.client.retrieve_shard(
                            uri, index, field, view, shard
                        )
                except ClientError as e:
                    if e.status == 404:
                        break  # absent at this source: not a failure
                    last_err = e
                    self._count_fetch_error(e)
                    if attempt < self.fetch_retries:
                        time.sleep(delay * (0.5 + random.random()))
                        delay = min(delay * 2, 1.0)
        if last_err is not None:
            raise ResizeError(
                f"fragment {index}/{field}/{view}/{shard} unfetchable "
                f"from any surviving source: {last_err}"
            )
        return None  # 404 everywhere: genuinely absent in this view

    @staticmethod
    def _count_fetch_error(e: Exception) -> None:
        if getattr(e, "code", "") == "checksum-mismatch":
            kind = "checksum"
        elif getattr(e, "transport", False):
            kind = "transport"
        else:
            kind = "http"
        global_stats.with_tags(f"kind:{kind}").count(
            "resize_fetch_errors_total"
        )

    def _throttle(self, nbytes: int) -> None:
        """Aggregate bandwidth pacing: each completed transfer reserves
        nbytes/limit seconds on a shared monotonic schedule, so the
        sustained fetch rate across ALL workers stays under
        bandwidth_limit bytes/s and a resize cannot saturate the links
        the serving path shares."""
        if self.bandwidth_limit <= 0 or nbytes <= 0:
            return
        cost = nbytes / float(self.bandwidth_limit)
        with self._bw_lock:
            now = time.monotonic()
            self._bw_next = max(self._bw_next, now) + cost
            wait = self._bw_next - now
        if wait > 0:
            time.sleep(wait)

    # -- coordinator: completion tracking (reference cluster.go:1413) ------

    def mark_complete(self, msg: Message) -> None:
        with self._lock:
            msg_epoch = int(msg.get("epoch") or 0)
            if msg.get("job") != self._active_job or (
                msg_epoch and msg_epoch != self._epoch
            ):
                # Stale COMPLETE from an aborted/earlier job — or from a
                # dead coordinator's epoch after a failover — must not
                # satisfy a later job's pending set: flipping
                # topology before copies finish silently loses data.
                # Epoch 0 means an epoch-UNAWARE legacy follower (every
                # live job stamps >= 1): accepted on job-id match so a
                # mixed-version rolling upgrade can still resize —
                # epoch-aware peers' stale reports stay rejected.
                return
            if msg.get("error"):
                self.log.printf(
                    "resize: node %s completed with error: %s",
                    msg.get("node"), msg.get("error"),
                )
            self._pending_nodes.discard(msg.get("node"))
            global_stats.gauge("resize_pending_nodes", len(self._pending_nodes))
            if self._pending_nodes or self._new_nodes is None:
                return
            new_nodes = self._new_nodes
            notify = self._notify_nodes
            self._notify_nodes = []
            self._new_nodes = None
            self._active_job = None
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        self._stop_heartbeats()
        # Counted at the decision point, BEFORE the status broadcast: an
        # observer that sees the cluster flip to NORMAL must already see
        # the completion on /metrics.
        global_stats.count("resize_jobs_completed_total")
        # Flip the whole cluster to the new topology atomically via one
        # status broadcast; receivers clean unowned fragments. Recipients
        # are old∪new members (send_sync would miss the joiner/leaver
        # because the coordinator's own topology flips only on receive).
        status = Message.make(
            bc.MSG_CLUSTER_STATUS,
            state=STATE_NORMAL,
            nodes=[n.to_json() for n in new_nodes],
            # A --join node boots with its own default; the cluster's
            # replication factor must override or its shard_nodes view
            # diverges from every other member.
            replicaN=self.cluster.topology.replica_n,
        )
        self.cluster.receive_message(status.to_bytes())
        for node in notify:
            if node.id != self.cluster.local_node.id:
                try:
                    self.cluster.broadcaster.send_to(node, status)
                except Exception as e:
                    self.log.printf("resize: status to %s failed: %s", node.id, e)
        self.log.printf("resize complete: %d nodes", len(new_nodes))

    def abort(self, only_job: Optional[int] = None,
              local: bool = False) -> None:
        """Roll back to NORMAL on the old topology (reference api.go:1250).
        only_job: abort only if that job is still active (timeout path).
        local: apply without re-broadcasting — the MSG_RESIZE_ABORT
        receive path uses this, because during a failover window two
        nodes can both hold the coordinator flag and a re-broadcast on
        receive ping-pongs the abort between them forever."""
        with self._lock:
            if only_job is not None and self._active_job != only_job:
                return  # job completed/was replaced while we decided
            if self._active_job is not None:
                global_stats.count("resize_jobs_aborted_total")
            global_stats.gauge("resize_pending_nodes", 0)
            self._pending_nodes = set()
            self._new_nodes = None
            self._active_job = None
            self._needs_clean = False
            # Any in-flight migration workers are fetching for the job
            # being aborted: stop them (see _lease_expired).
            # lint: allow-shared-state(deliberately lockless cancel flag: workers poll it WITHOUT the resizer lock because the coordinator's inline follow runs under it and joining on it deadlocked)
            self._follow_cancel_gen = self._follow_gen
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            # old∪new membership: a joiner that already received its
            # instruction must learn the job died, even though it is not
            # in topology.nodes yet (same reason mark_complete notifies
            # this set).
            notify = {n.id: n for n in self.cluster.topology.nodes}
            notify.update({n.id: n for n in self._notify_nodes})
            self._notify_nodes = []
        self._stop_heartbeats()
        self.cancel_lease()
        self.cluster.set_state(STATE_NORMAL)
        if not local and self.cluster.is_coordinator():
            # Best-effort delivery: a dead peer (often the very reason for
            # the abort) must not stop survivors from unfreezing.
            targets = list(notify.values())
            self._broadcast_best_effort(Message.make(bc.MSG_RESIZE_ABORT), targets)
            self._broadcast_best_effort(
                Message.make(bc.MSG_CLUSTER_STATUS, state=STATE_NORMAL), targets
            )

    # -- every node: post-resize cleanup (reference holder.go:1104) --------

    def clean_holder(self) -> int:
        """Drop fragments for shards this node no longer owns. Runs after
        the topology flip to NORMAL; returns fragments removed."""
        with self._lock:
            if not self._needs_clean:
                return 0
            self._needs_clean = False
        holder = self.cluster.holder
        if holder is None:
            return 0
        removed = 0
        local_id = self.cluster.local_node.id
        # A node that is no longer a member keeps its data (the reference
        # leaves removed-node data dirs intact too).
        if self.cluster.topology.node_by_id(local_id) is None:
            return 0
        for index_name in list(holder.indexes):
            idx = holder.index(index_name)
            if idx is None:
                continue
            for field_name in list(idx.fields):
                f = idx.field(field_name)
                if f is None:
                    continue
                for view in list(f.views.values()):
                    for shard in list(view.fragments):
                        if not self.cluster.topology.owns_shard(
                            local_id, index_name, shard
                        ):
                            view.delete_fragment(shard)
                            removed += 1
        if removed:
            self.log.printf("holder cleaner: removed %d fragments", removed)
        return removed
