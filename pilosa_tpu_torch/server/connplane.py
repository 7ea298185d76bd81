"""Connection-plane observability: the front-door lifecycle ledger.

Served qps can plateau as clients grow while `resp_write` grows, and
without this plane nothing observes the front door itself: no accept-to-handler queue-wait number, no
per-connection accounting, no kernel listen-backlog truth. This module
is that accounting plane. It instruments connection lifecycle EVENTS —
accept, dispatch, read, parse, execute, write, idle, close — not the
threading implementation, so the plane survives a C10k front-door
rewrite unchanged.

State machine (per connection)::

    accepted -> queued -> reading -> parsing -> executing -> writing
                   ^                                |           |
                   |        (keep-alive)            v           v
                 closed <------------------------ idle <---- executing

- ``accepted``: the instant between kernel accept and ledger
  registration (~0 by construction).
- ``queued``: waiting for a worker to pick the socket up AND for the
  first request bytes to arrive. The accept-to-handler slice of it is
  ALSO observed into the ``http_queue_wait_seconds`` histogram — the
  thread-dispatch delay the C10k rewrite must collapse.
- ``reading``/``parsing``: request head arrival vs header read +
  validation + eager chunked-body decode.
- ``executing``: route dispatch through handler return (body reads
  included); ``writing`` brackets exactly the response write.
- ``idle``: a keep-alive connection waiting for its next request.

Timing contract: the clock is read ONLY at state transitions — never
per byte — and per-state seconds accumulate on the entry itself
(owner-thread plain-float math, no locks). Aggregate counters
(``http_connection_state_seconds{state}``,
``http_keepalive_reuse_total``) are flushed once per request cycle (at
the transition to ``idle``) and at close, so the serving path pays a
handful of clock reads and one batched stats pass per request.

Kernel-side truth (monitor-poll cadence + /debug/connections scrape):
the listen socket's accept-queue depth from ``/proc/net/tcp{,6}`` and
``ListenOverflows`` / ``ListenDrops`` deltas from
``/proc/net/netstat`` — a full 128-deep ``request_queue_size`` backlog
becomes visible instead of silently RSTing SYNs. Off Linux every probe
is a graceful no-op. Note the TcpExt counters are HOST-wide (the
kernel does not split them per listener); deltas still move exactly
when this process's backlog overflows under bench load.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Optional

from pilosa_tpu_torch.utils.stats import global_stats

#: The full state vocabulary (the `state` metric tag's bounded
#: enumeration for connection series; tools/lint/checkers/metrics.py).
STATES = (
    "accepted", "queued", "reading", "parsing",
    "executing", "writing", "idle", "closed",
)

#: Pre-tagged stats clients, one per state: a transition flush must not
#: allocate a tagged client per request.
_STATE_STATS = {s: global_stats.with_tags(f"state:{s}") for s in STATES}


class _NopEntry:
    """Zero-cost sink for handlers running without a connection plane
    (direct _Handler construction in tests, exotic embeddings): every
    hook is a pass, so the handler code never branches."""

    __slots__ = ()

    def transition(self, state: str) -> None:
        pass

    def request_started(self) -> None:
        pass

    def add_bytes_in(self, n: int) -> None:
        pass

    def add_bytes_out(self, n: int) -> None:
        pass


NOP_ENTRY = _NopEntry()

_current = threading.local()


def current_entry():
    """The ledger entry owned by the calling worker thread, or the nop
    sink. One threading.local read — the handler-side cost of every
    lifecycle hook."""
    return getattr(_current, "entry", None) or NOP_ENTRY


class ConnEntry:
    """One accepted socket's ledger entry. Written ONLY by its owner
    (the listener thread until dispatch, then exactly one worker
    thread); /debug/connections readers take GIL-atomic snapshots of
    the plain fields, the same discipline as qprofile's in-flight
    reads."""

    __slots__ = (
        "cid", "peer", "state", "requests", "reuses",
        "bytes_in", "bytes_out", "queue_wait_s", "state_seconds",
        "opened_monotonic", "closed_total_s", "_t_last",
        "_flushed", "_flushed_reuses", "tracked",
    )

    def __init__(self, cid: int, peer: str, now: float):
        self.cid = cid
        self.peer = peer
        self.state = "accepted"
        self.requests = 0
        self.reuses = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.queue_wait_s: Optional[float] = None
        self.state_seconds: dict[str, float] = {}
        self.opened_monotonic = now
        self.closed_total_s: Optional[float] = None
        self._t_last = now
        self._flushed: dict[str, float] = {}
        self._flushed_reuses = 0
        self.tracked = True

    def transition(self, state: str) -> None:
        """Account the outgoing state's dwell and enter `state`. ONE
        clock read; plain owner-thread float math. The transition to
        ``idle`` (the request boundary) flushes aggregate deltas."""
        now = time.perf_counter()
        cur = self.state
        # lint: allow-shared-state(single-owner handoff: the listener writes only before dispatch, then exactly one worker thread owns the entry; snapshot readers take GIL-atomic reads and tolerate one stale field — the class docstring's contract)
        self.state_seconds[cur] = (
            self.state_seconds.get(cur, 0.0) + (now - self._t_last)
        )
        # lint: allow-shared-state(owner-thread-only write, same handoff contract as above)
        self._t_last = now
        # lint: allow-shared-state(owner-thread-only write, same handoff contract as above)
        self.state = state
        if state == "idle":
            self.flush()

    def request_started(self) -> None:
        self.requests += 1
        if self.requests > 1:
            # lint: allow-shared-state(owner-thread-only RMW: only the single worker thread that owns the entry runs the request loop)
            self.reuses += 1
        self.transition("executing")

    def add_bytes_in(self, n: int) -> None:
        self.bytes_in += n

    def add_bytes_out(self, n: int) -> None:
        self.bytes_out += n

    def flush(self) -> None:
        """Batch per-state second deltas (and keep-alive reuses) into
        the global counters — once per request cycle and at close, not
        per transition, so stats-lock traffic stays a single short pass
        per request."""
        for st, total in self.state_seconds.items():
            d = total - self._flushed.get(st, 0.0)
            if d > 0:
                _STATE_STATS[st].count("http_connection_state_seconds", d)
                # lint: allow-shared-state(owner-thread-only write: flush runs on the owning worker at the idle transition and at close, never concurrently)
                self._flushed[st] = total
        d = self.reuses - self._flushed_reuses
        if d > 0:
            global_stats.count("http_keepalive_reuse_total", d)
            # lint: allow-shared-state(owner-thread-only write, same flush contract as above)
            self._flushed_reuses = self.reuses

    def to_dict(self) -> dict:
        now = time.perf_counter()
        age = (
            self.closed_total_s
            if self.closed_total_s is not None
            else now - self.opened_monotonic
        )
        return {
            "id": self.cid,
            "peer": self.peer,
            "state": self.state,
            "ageSeconds": round(age, 3),
            "requests": self.requests,
            "reuses": self.reuses,
            "bytesIn": self.bytes_in,
            "bytesOut": self.bytes_out,
            "queueWaitMs": (
                round(self.queue_wait_s * 1e3, 3)
                if self.queue_wait_s is not None
                else None
            ),
            "stateSeconds": {
                s: round(v, 6) for s, v in self.state_seconds.items()
            },
        }


def parse_listen_backlogs(text: str, ports: set) -> dict:
    """{port: accept-queue depth} for LISTEN sockets on `ports`, from
    /proc/net/tcp{,6} text. For a listener the kernel reports the
    current accept backlog in the rx_queue half of tx_queue:rx_queue
    (hex); st == 0A is TCP_LISTEN. Pure function — fixture-testable."""
    out: dict = {}
    for line in text.splitlines()[1:]:
        parts = line.split()
        if len(parts) < 5 or parts[3] != "0A":
            continue
        try:
            port = int(parts[1].rsplit(":", 1)[1], 16)
            rx = int(parts[4].split(":", 1)[1], 16)
        except (ValueError, IndexError):
            continue
        if port in ports:
            out[port] = max(out.get(port, 0), rx)
    return out


def parse_listen_drops(text: str) -> Optional[tuple]:
    """(ListenOverflows, ListenDrops) from /proc/net/netstat text, or
    None when the TcpExt pair is absent/malformed. The file carries
    header/value line PAIRS per prefix (TcpExt:, IpExt:); the values
    line is the one following its own header."""
    lines = text.splitlines()
    for i, line in enumerate(lines[:-1]):
        if not line.startswith("TcpExt:"):
            continue
        nxt = lines[i + 1]
        if not nxt.startswith("TcpExt:"):
            continue
        fields = dict(zip(line.split()[1:], nxt.split()[1:]))
        try:
            return (
                int(fields["ListenOverflows"]),
                int(fields["ListenDrops"]),
            )
        except (KeyError, ValueError):
            return None
    return None


class ConnectionPlane:
    """The process-wide connection ledger: bounded live table, bounded
    ring of recently closed connections, listener registry, and the
    kernel listen-stats poller."""

    #: Live-table cap: past this, new connections still get a (metric-
    #: accruing) entry but are not TABLED — the ledger's memory stays
    #: bounded even under an fd-leak pathology. Real concurrency is
    #: bounded far lower by the fd limit.
    LIVE_CAP = 4096
    #: Recently-closed ring size.
    RING_CAP = 256

    def __init__(self, proc_net: str = "/proc/net"):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._live: dict[int, ConnEntry] = {}
        self._live_count = 0
        self._opened = 0
        self._closed: deque = deque(maxlen=self.RING_CAP)
        self._listeners: dict[int, int] = {}  # port -> refcount
        self._netstat_last: Optional[tuple] = None
        self.proc_net = proc_net

    # -- lifecycle (listener + worker threads) ------------------------------

    def register(self, peer) -> ConnEntry:
        """Called on the LISTENER thread at accept: stamps the accept
        time (the queue-wait origin) and tables the entry."""
        now = time.perf_counter()
        try:
            peer_s = f"{peer[0]}:{peer[1]}"
        except (TypeError, IndexError):
            peer_s = str(peer)
        entry = ConnEntry(next(self._ids), peer_s, now)
        # `accepted` is the registration instant itself; the dwell that
        # matters starts now, waiting for a worker + first bytes.
        entry.transition("queued")
        with self._lock:
            self._opened += 1
            self._live_count += 1
            if len(self._live) < self.LIVE_CAP:
                self._live[entry.cid] = entry
            else:
                entry.tracked = False
            live = self._live_count
        global_stats.count("http_connections_opened_total")
        global_stats.gauge("http_connections_live", live)
        return entry

    def enter(self, entry: ConnEntry) -> None:
        """Called on the WORKER thread the instant it picks the
        connection up: binds the entry to the thread and observes the
        accept-to-handler queue wait — the thread-dispatch delay."""
        wait = time.perf_counter() - entry.opened_monotonic
        entry.queue_wait_s = wait
        _current.entry = entry
        global_stats.timing("http_queue_wait_seconds", wait)

    def close_entry(self, entry: ConnEntry) -> None:
        """Worker-thread teardown: final state accounting, aggregate
        flush, move from the live table to the closed ring."""
        _current.entry = None
        entry.transition("closed")
        entry.closed_total_s = entry._t_last - entry.opened_monotonic
        entry.flush()
        with self._lock:
            self._live_count -= 1
            if entry.tracked:
                self._live.pop(entry.cid, None)
                self._closed.append(entry)
            live = self._live_count
        global_stats.gauge("http_connections_live", live)

    # -- listener registry --------------------------------------------------

    def register_listener(self, port: int) -> None:
        with self._lock:
            self._listeners[port] = self._listeners.get(port, 0) + 1

    def unregister_listener(self, port: int) -> None:
        with self._lock:
            n = self._listeners.get(port, 0) - 1
            if n <= 0:
                self._listeners.pop(port, None)
            else:
                self._listeners[port] = n

    # -- kernel truth -------------------------------------------------------

    def _read_proc(self, name: str) -> Optional[str]:
        path = os.path.join(self.proc_net, name)
        try:
            with open(path, "r") as f:
                return f.read()
        except (OSError, UnicodeDecodeError):
            return None  # non-Linux / restricted /proc: graceful no-op

    def accept_queue_depth(self, port: Optional[int] = None) -> Optional[int]:
        """Current accept-queue depth of the registered listener(s)
        (or one explicit `port`) straight from /proc/net/tcp{,6};
        None when nothing is registered or /proc is unavailable."""
        if port is not None:
            ports = {port}
        else:
            with self._lock:
                ports = set(self._listeners)
        if not ports:
            return None
        depth: Optional[int] = None
        for name in ("tcp", "tcp6"):
            text = self._read_proc(name)
            if text is None:
                continue
            for _p, rx in parse_listen_backlogs(text, ports).items():
                depth = rx if depth is None else max(depth, rx)
        return depth

    def poll_kernel(self, stats=None) -> dict:
        """One kernel-truth poll (monitor cadence + /debug/connections
        scrape): gauge the accept-queue depth, count ListenOverflows /
        ListenDrops deltas, return the current readings. Every probe
        no-ops gracefully where /proc/net is absent."""
        s = stats if stats is not None else global_stats
        out: dict = {
            "acceptQueueDepth": None,
            "listenOverflows": None,
            "listenDrops": None,
        }
        depth = self.accept_queue_depth()
        if depth is not None:
            out["acceptQueueDepth"] = depth
            s.gauge("http_accept_queue_depth", depth)
        text = self._read_proc("netstat")
        pair = parse_listen_drops(text) if text is not None else None
        if pair is not None:
            out["listenOverflows"], out["listenDrops"] = pair
            with self._lock:
                last = self._netstat_last
                self._netstat_last = pair
            if last is not None:
                d_over = pair[0] - last[0]
                d_drop = pair[1] - last[1]
                if d_over > 0:
                    s.count("http_listen_overflows_total", d_over)
                if d_drop > 0:
                    s.count("http_listen_drops_total", d_drop)
        return out

    # -- /debug/connections -------------------------------------------------

    @staticmethod
    def _reuse_bucket(reuses: int) -> str:
        if reuses == 0:
            return "0"
        if reuses < 10:
            return "1-9"
        if reuses < 100:
            return "10-99"
        return "100+"

    def snapshot(self, top: int = 50) -> dict:
        """Aggregates first (live count, per-state occupancy, reuse
        distribution, worst queue waits, kernel listen stats), then the
        newest `top` live entries and the recently-closed ring."""
        with self._lock:
            live = list(self._live.values())
            closed = list(self._closed)
            opened = self._opened
            live_count = self._live_count
        occupancy: dict[str, int] = {}
        for e in live:
            st = e.state
            occupancy[st] = occupancy.get(st, 0) + 1
        reuse_dist: dict[str, int] = {}
        for e in live + closed:
            b = self._reuse_bucket(e.reuses)
            reuse_dist[b] = reuse_dist.get(b, 0) + 1
        waits = sorted(
            (e for e in live + closed if e.queue_wait_s is not None),
            key=lambda e: e.queue_wait_s,
            reverse=True,
        )[:10]
        live.sort(key=lambda e: e.cid, reverse=True)
        closed.sort(key=lambda e: e.cid, reverse=True)
        return {
            "live": live_count,
            "opened": opened,
            "tabled": len(live),
            "stateOccupancy": occupancy,
            "reuseDistribution": reuse_dist,
            "worstQueueWaits": [
                {
                    "id": e.cid,
                    "peer": e.peer,
                    "queueWaitMs": round((e.queue_wait_s or 0.0) * 1e3, 3),
                }
                for e in waits
            ],
            "kernel": self.poll_kernel(),
            "connections": [e.to_dict() for e in live[:top]],
            "recentClosed": [e.to_dict() for e in closed[:top]],
        }


global_conn_plane = ConnectionPlane()
