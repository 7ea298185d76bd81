"""Lock-stall attribution: instrumented locks for the named hot sites.

The serving plane is thread-per-request over shared registries; the Go
reference diagnoses convoys with `go tool pprof -contentions`, we get
this. An InstrumentedLock wraps a threading.Lock so that the UNCONTENDED
path stays a bare try-acquire (one C-level call, no clock reads) while
the contended path — the only one an operator cares about — is timed
into `lock_wait_seconds{site=...}` / `lock_hold_seconds{site=...}`
histograms and a bounded worst-recent-waits ledger behind
GET /debug/stalls.

Site names are a bounded vocabulary (one per instrumented lock object):
fragment, wal_append, wal_drain, snapshot_mutex, batcher_drain,
rescache, hbm_ledger. `lock_wait_seconds` picks up trace exemplars for
free via
the stats client's exemplar provider, so a worst-wait entry resolves to
the exact request that convoyed (/debug/traces/<id>).

Timing contract:
- wait is recorded ONLY when the try-acquire fails (real contention);
  an uncontended acquire never reads the clock.
- hold is recorded ONLY for holds that someone contended for (the
  acquire that waited): uncontended critical sections stay unobserved
  by construction, which is what keeps the fragment read path — ~1000
  acquisitions per freshness walk — at its pre-instrumentation cost.
- for reentrant locks only the OUTERMOST acquire/release pair is
  timed: an owner cannot contend with itself.

The lint callgraph (tools/lint/callgraph.py LOCK_CTORS) recognizes
these constructors as lock definitions, so the lock-discipline and
shared-state whole-program analyses keep covering the instrumented
sites exactly as they covered the bare threading locks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from pilosa_tpu_torch.utils.qprofile import current_profile
from pilosa_tpu_torch.utils.stats import exemplar_trace_id, global_stats
from pilosa_tpu_torch.utils.threads import role_of_current


class StallLedger:
    """Bounded record of the worst recent lock waits (/debug/stalls).

    Every contended acquire reports here; the ledger keeps the most
    recent `capacity` waits plus per-site aggregates, and serves them
    worst-first. Records carry the waiter's trace id (when a trace was
    active) so a stall resolves to the request that suffered it."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=capacity)
        self._sites: dict[str, dict] = {}

    def record(self, site: str, wait_s: float,
               trace_id: Optional[str]) -> None:
        entry = {
            "site": site,
            "waitMs": round(wait_s * 1e3, 3),
            "traceId": trace_id,
            "thread": threading.current_thread().name,
            # Which PLANE stalled, not just which thread (ISSUE 20):
            # exemplars used to read `Thread-42` — now the name is
            # stable (utils/threads.spawn) and the role places it.
            "role": role_of_current(),
            # Epoch stamp by contract: operators correlate stall times
            # with logs and traces, not with a monotonic origin.
            "at": time.time(),  # lint: allow-monotonic-time(operator-facing epoch display stamp, same contract as qprofile startedAt)
        }
        with self._lock:
            self._recent.append(entry)
            agg = self._sites.get(site)
            if agg is None:
                agg = self._sites[site] = {
                    "waits": 0, "waitSeconds": 0.0, "maxWaitMs": 0.0,
                }
            agg["waits"] += 1
            agg["waitSeconds"] += wait_s
            agg["maxWaitMs"] = max(agg["maxWaitMs"], entry["waitMs"])

    def worst(self, n: int = 50) -> list[dict]:
        with self._lock:
            items = list(self._recent)
        items.sort(key=lambda e: e["waitMs"], reverse=True)
        return items[:n]

    def sites(self) -> dict:
        with self._lock:
            return {
                s: dict(agg, waitSeconds=round(agg["waitSeconds"], 6))
                for s, agg in self._sites.items()
            }


global_stall_ledger = StallLedger()


class InstrumentedLock:
    """A threading.Lock with contended-path stall attribution.

    Drop-in for the `acquire/release` + context-manager surface. The
    fast path is `_lock.acquire(False)` — success means zero clock
    reads and no stats traffic. `_hold_t0` is written and read only by
    the exclusive holder, so the plain-float stores are race-free by
    the lock's own exclusion."""

    __slots__ = ("site", "_lock", "_stats", "_hold_t0")

    _REENTRANT = False

    def __init__(self, site: str):
        self.site = site
        self._lock = threading.Lock()
        self._stats = global_stats.with_tags(f"site:{site}")
        self._hold_t0 = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            self._hold_t0 = 0.0
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        got = self._lock.acquire(True, timeout)
        if not got:
            return False
        wait = time.perf_counter() - t0
        self._hold_t0 = time.perf_counter()
        self._observe_wait(wait)
        return True

    def release(self) -> None:
        t0 = self._hold_t0
        self._lock.release()
        if t0:
            self._stats.timing(
                "lock_hold_seconds", time.perf_counter() - t0
            )

    def locked(self) -> bool:
        return self._lock.locked()

    def _observe_wait(self, wait: float) -> None:
        self._stats.timing("lock_wait_seconds", wait)
        # Per-query lock-wait attribution (ISSUE 18): the waiting thread
        # IS the request thread, so its profile charges the stall to the
        # query shape that suffered it (nop sink when no profile).
        current_profile().incr("lock_wait_us", int(wait * 1e6))
        global_stall_ledger.record(self.site, wait, exemplar_trace_id())

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()


class InstrumentedRLock:
    """Reentrant variant: only the outermost acquire/release of an
    owning thread is timed (an owner never contends with itself).
    Per-thread depth lives in a threading.local, never on the shared
    instance."""

    __slots__ = ("site", "_lock", "_stats", "_hold_t0", "_local")

    _REENTRANT = True

    def __init__(self, site: str):
        self.site = site
        self._lock = threading.RLock()
        self._stats = global_stats.with_tags(f"site:{site}")
        self._hold_t0 = 0.0
        self._local = threading.local()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        depth = getattr(self._local, "depth", 0)
        if depth:
            # Reentrant acquire by the owner: cannot block, never timed.
            self._lock.acquire()
            self._local.depth = depth + 1
            return True
        if self._lock.acquire(False):
            self._local.depth = 1
            self._hold_t0 = 0.0
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        got = self._lock.acquire(True, timeout)
        if not got:
            return False
        wait = time.perf_counter() - t0
        self._local.depth = 1
        self._hold_t0 = time.perf_counter()
        self._observe_wait(wait)
        return True

    def release(self) -> None:
        depth = getattr(self._local, "depth", 1)
        if depth > 1:
            self._local.depth = depth - 1
            self._lock.release()
            return
        t0 = self._hold_t0
        self._local.depth = 0
        self._lock.release()
        if t0:
            self._stats.timing(
                "lock_hold_seconds", time.perf_counter() - t0
            )

    def _observe_wait(self, wait: float) -> None:
        self._stats.timing("lock_wait_seconds", wait)
        # Same per-query attribution as InstrumentedLock (ISSUE 18).
        current_profile().incr("lock_wait_us", int(wait * 1e6))
        global_stall_ledger.record(self.site, wait, exemplar_trace_id())

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()
