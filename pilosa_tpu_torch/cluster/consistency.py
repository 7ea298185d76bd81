"""Read-path replica divergence detection + targeted read repair.

A hedged shard read that gets answers from TWO replicas is a free
consistency probe: the serving path hands the pair to this monitor (one
bounded-queue append, never any comparison work on the request thread),
and a background worker diffs the replicas' per-fragment block
checksums for the touched shards. Disagreement is counted per index
(`replica_divergence_blocks_total{index}`), recorded on a ledger served
at `GET /debug/consistency` (ordered by staleness: oldest unrepaired
divergence first), and healed by asking BOTH replicas to run a
targeted epoch-directed repair pass over exactly the differing blocks
(`/internal/fragment/repair` -> HolderSyncer.sync_fragment_targeted) —
each side pulls the higher-epoch blocks from the other, so the pair
converges without waiting for the next full anti-entropy sweep.

The queue is bounded (`read-repair-queue` config knob): under a
divergence storm the serving path stays O(1) and overflow is counted
(`read_repair_dropped_total`) rather than buffered — the periodic
anti-entropy sweep is the backstop for anything dropped here.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from pilosa_tpu_torch.cluster.client import ClientError
from pilosa_tpu_torch.utils.logger import NopLogger
from pilosa_tpu_torch.utils.stats import global_stats

#: Ledger bound: recent divergence observations kept for
#: /debug/consistency. Repaired entries age out first.
LEDGER_MAX = 256

#: Per-probe RPC budget (seconds): checksum fetches + repair fan-out
#: for one observation. A stalled replica costs the worker at most one
#: budget, not a wedge.
PROBE_BUDGET = 30.0


def call_fields(c):
    """Best-effort field names a PQL call tree reads, for scoping a
    divergence probe to the fragments the hedged read actually
    witnessed (diffing EVERY field of a wide index per observation
    multiplies peer RPC load by schema width for fields the read never
    touched — whole-index coverage is the periodic sweep's job). None =
    couldn't positively identify every field (unknown call shape):
    the probe falls back to all fields, never silently under-covers."""
    out: set = set()
    stack = [c]
    while stack:
        node = stack.pop()
        name = getattr(node, "name", "")
        args = getattr(node, "args", None) or {}
        if name == "Row":
            for arg in args:
                if not arg.startswith("_"):
                    out.add(arg)
                    break
        elif name in ("Rows", "TopN"):
            fn = args.get("_field") or args.get("field")
            if not fn:
                return None
            out.add(fn)
        elif name in ("Sum", "Min", "Max"):
            fn = args.get("field")
            if not fn:
                for arg in args:
                    if not arg.startswith("_"):
                        fn = arg
                        break
            if not fn:
                return None
            out.add(fn)
        elif name in ("Count", "Intersect", "Union", "Difference",
                      "Xor", "Not", "GroupBy", "All"):
            pass  # container calls: fields come from their children
        else:
            return None  # unknown shape: don't guess, probe everything
        for v in args.values():
            if hasattr(v, "name") and hasattr(v, "args"):
                stack.append(v)
        stack.extend(getattr(node, "children", ()) or ())
    return frozenset(out) if out else None


class DivergenceMonitor:
    """Bounded-queue background consistency checker."""

    def __init__(self, cluster, max_queue: int = 128, logger=None):
        self.cluster = cluster
        self.max_queue = max(int(max_queue), 1)
        self.log = logger or NopLogger()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._ledger: deque = deque(maxlen=LEDGER_MAX)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        cluster.divergence = self

    # -- serving-path hook (O(1), lock held for an append only) ------------

    def observe(self, index: str, shards, node_a: str, node_b: str,
                fields=None) -> None:
        """One hedge race produced answers from two replicas: queue the
        pair for a background checksum diff. Never blocks the serving
        path — a full queue drops the probe (counted; the anti-entropy
        sweep remains the backstop). `fields` (frozenset) scopes the
        diff to the fields the read touched; None probes every field."""
        probe = (index, tuple(sorted(set(shards))), node_a, node_b, fields)
        with self._cv:
            if probe in self._queue:
                # A hot hedged pair re-observed while its probe is
                # still pending: re-diffing it back to back buys
                # nothing and starves genuinely new observations out of
                # the bounded queue. O(queue) scan, queue <= max_queue.
                return
            if len(self._queue) >= self.max_queue:
                global_stats.count("read_repair_dropped_total")
                return
            self._queue.append(probe)
            global_stats.gauge("read_repair_pending", len(self._queue))
            self._cv.notify()
        global_stats.count("read_repair_enqueued_total")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "DivergenceMonitor":
        from pilosa_tpu_torch.utils.threads import spawn

        self._thread = spawn(
            "divergence-monitor", self._run, name="divergence-monitor"
        )
        return self

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    # lint: allow-lock-discipline(canonical Condition.wait: it RELEASES the condition lock while blocked; observers only ever append under it)
                    self._cv.wait(1.0)
                if self._stop:
                    return
                probe = self._queue.popleft()
                global_stats.gauge("read_repair_pending", len(self._queue))
            try:
                self._check(*probe)
            except Exception as e:  # noqa: BLE001 — counted crash barrier
                global_stats.count("read_repair_errors_total")
                self.log.printf("divergence probe failed: %s", e)

    def drain(self, timeout: float = 5.0) -> bool:
        """Test/bench barrier: True once the queue is empty and the
        worker is idle (best-effort — the queue length is the signal)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._queue:
                    return True
            time.sleep(0.01)
        return False

    # -- the probe ----------------------------------------------------------

    def _node(self, node_id: str):
        return self.cluster.topology.node_by_id(node_id)

    def _check(self, index: str, shards, id_a: str, id_b: str,
               fields=None) -> None:
        """Diff the two replicas' block checksums for every fragment of
        the touched shards (scoped to `fields` when the observation
        names them); divergent blocks land on the ledger and both
        replicas are asked to repair exactly those blocks."""
        from pilosa_tpu_torch.utils.deadline import Deadline, deadline_scope

        holder = self.cluster.holder
        a, b = self._node(id_a), self._node(id_b)
        if holder is None or a is None or b is None:
            return
        with deadline_scope(Deadline(PROBE_BUDGET)):
            for index_name, field_name, view_name, shard in self._fragments(
                holder, index, shards, fields
            ):
                self._check_fragment(
                    index_name, field_name, view_name, shard, a, b
                )

    @staticmethod
    def _fragments(holder, index: str, shards, fields=None):
        idx = holder.index(index)
        if idx is None:
            return
        for fname in list(idx.fields):
            if fields is not None and fname not in fields:
                continue
            f = idx.field(fname)
            if f is None:
                continue
            for vname in list(f.views):
                for shard in shards:
                    yield index, fname, vname, shard

    def _check_fragment(self, index, field, view, shard, a, b) -> None:
        client = self.cluster.client

        def fetch(node):
            # A 404 is a DECISION — this replica simply has no such
            # fragment, which against a peer that does is the LARGEST
            # possible divergence (it missed every write), so it must
            # be diffed as an empty block set, counted, and ledgered —
            # not silently skipped. Transport failures stay a skip: we
            # can't judge what we can't reach.
            try:
                return client.fragment_blocks(node, index, field, view, shard)
            except ClientError as e:
                if e.status == 404:
                    return []
                raise

        try:
            blocks_a = fetch(a)
            blocks_b = fetch(b)
        except ClientError:
            return  # unreachable replica: the sweep backstops
        map_a = {blk: s for blk, s, _e in blocks_a}
        map_b = {blk: s for blk, s, _e in blocks_b}
        diff = sorted(
            blk
            for blk in set(map_a) | set(map_b)
            if map_a.get(blk, 0) != map_b.get(blk, 0)
        )
        if not diff:
            return
        global_stats.with_tags(f"index:{index}").count(
            "replica_divergence_blocks_total", len(diff)
        )
        entry = {
            "index": index,
            "field": field,
            "view": view,
            "shard": int(shard),
            "blocks": diff,
            "nodes": [a.id, b.id],
            "detected_mono": time.monotonic(),
            "repaired": False,
            "repairedBlocks": 0,
        }
        with self._lock:
            self._ledger.append(entry)
        # Targeted heal: each replica pulls the higher-epoch blocks from
        # its peers for exactly these blocks. Best-effort — a failed
        # repair leaves the ledger entry unrepaired (staleness-ordered
        # at the top of /debug/consistency) and the sweep backstops.
        repaired = 0
        for node in (a, b):
            try:
                repaired += client.repair_fragment(
                    node, index, field, view, shard, blocks=diff
                )
            except ClientError as e:
                self.log.printf(
                    "read repair on %s %s/%s/%s/%s failed: %s",
                    node.id, index, field, view, shard, e,
                )
        with self._lock:
            entry["repaired"] = repaired > 0
            entry["repairedBlocks"] = repaired

    # -- /debug/consistency --------------------------------------------------

    def debug_dump(self) -> dict:
        """Ledger ordered by staleness: unrepaired divergences first,
        oldest first — the top row is the longest-standing known
        inconsistency (mirroring /debug/hbm's coldest-first)."""
        now = time.monotonic()
        with self._lock:
            entries = [dict(e) for e in self._ledger]
            pending = len(self._queue)
        for e in entries:
            e["ageSeconds"] = round(now - e.pop("detected_mono"), 3)
        entries.sort(key=lambda e: (e["repaired"], -e["ageSeconds"]))
        return {
            "enabled": True,
            "pendingProbes": pending,
            "maxQueue": self.max_queue,
            "entries": entries,
        }
