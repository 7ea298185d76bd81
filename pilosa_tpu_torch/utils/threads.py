"""Named-thread spawn helper + thread-role registry (ISSUE 20).

The sampling profiler used to see ~20 anonymous ``Thread-N`` stacks it
could not attribute to a plane, and stall-ledger exemplars read
``Thread-42``. Every background thread in this codebase now starts
through :func:`spawn`, which names the thread and registers its ROLE —
a bounded vocabulary naming the plane the thread serves — keyed by
thread ident, for the lifetime of the thread.

Consumers:

- ``utils/profiler.py`` tags each stack sample with the owning
  thread's role (``thread_samples_total{role}``) so ``/debug/pprof``
  answers "which plane is burning CPU".
- ``GET /debug/threads`` (server/http.py) lists every live thread with
  its role, name, and age.
- ``utils/locks.py`` stall exemplars carry the waiter's role next to
  its (now meaningful) thread name.

Role vocabulary (bounded by construction — one literal per spawn call
site; the ``role`` metric tag key's boundedness rationale in
tools/lint/checkers/metrics.py points here):

    http-listener, http-worker, batcher-leader, snapshot-scheduler,
    device-refresh, groupby-prewarm, sparse-warm, sync-daemon,
    failure-detector, divergence-monitor, monitor-poll, profiler,
    cluster-map, cluster-broadcast, resize-follower, resize-lease,
    resize-worker, preheat, cluster-announce, device-trace

plus the two synthetic roles ``main`` (the main thread) and
``unknown`` (a thread that did not start through spawn — stdlib pool
workers, test harness threads).

The lint callgraph (tools/lint/callgraph.py thread_targets) resolves
``spawn(role, target, ...)`` exactly like ``threading.Thread(target=
...)``, so the shared-state and lock-discipline whole-program analyses
keep seeing every spawn site as a thread root.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Optional

_lock = threading.Lock()
#: ident -> {"role", "name", "startedMonotonic"} for live registered
#: threads only: entries are removed in the spawn wrapper's finally, so
#: the registry is bounded by the live thread count by construction.
_registry: dict[int, dict] = {}
_seq = itertools.count(1)


def register_current(role: str, name: Optional[str] = None) -> None:
    """Register the CALLING thread under `role` (and optionally rename
    it). For threads that cannot route their creation through spawn()
    — pool workers, request threads adopted mid-life — pair with
    unregister_current() in a finally."""
    t = threading.current_thread()
    if name:
        t.name = name
    with _lock:
        _registry[threading.get_ident()] = {
            "role": role,
            "name": t.name,
            "startedMonotonic": time.monotonic(),
        }


def unregister_current() -> None:
    with _lock:
        _registry.pop(threading.get_ident(), None)


def spawn(role: str, target: Callable, *, name: Optional[str] = None,
          args: tuple = (), kwargs: Optional[dict] = None,
          daemon: bool = True, start: bool = True) -> threading.Thread:
    """Create (and by default start) a named, role-registered thread.

    The drop-in for every ``threading.Thread(target=...)`` spawn site:
    the thread gets a stable name (``<role>-<seq>`` unless `name` is
    given), its role lands in the registry for the profiler / debug
    endpoints / stall exemplars, and the registry entry is removed when
    the target returns — dead threads never accumulate."""
    call_kwargs = kwargs or {}
    tname = name or f"{role}-{next(_seq)}"

    def _run() -> None:
        register_current(role)
        try:
            target(*args, **call_kwargs)
        finally:
            unregister_current()

    t = threading.Thread(target=_run, name=tname, daemon=daemon)
    if start:
        t.start()
    return t


def role_of(ident: int) -> str:
    """The registered role for a thread ident; ``main`` for the main
    thread, ``unknown`` for anything that never registered."""
    with _lock:
        info = _registry.get(ident)
    if info is not None:
        return info["role"]
    main = threading.main_thread()
    if main is not None and ident == main.ident:
        return "main"
    return "unknown"


def role_of_current() -> str:
    return role_of(threading.get_ident())


def roles_snapshot() -> dict[int, str]:
    """ident -> role for every registered thread plus the main thread —
    ONE lock acquisition per call, so per-sample consumers (the
    profiler resolves every thread in every sample) don't pay a lock
    per thread."""
    with _lock:
        out = {ident: info["role"] for ident, info in _registry.items()}
    main = threading.main_thread()
    if main is not None and main.ident is not None:
        out.setdefault(main.ident, "main")
    return out


def threads_snapshot() -> list[dict]:
    """Every live thread with its role — the /debug/threads payload.
    Walks threading.enumerate() so unregistered threads (role
    ``unknown``) are listed too, not hidden."""
    with _lock:
        registry = {ident: dict(info) for ident, info in _registry.items()}
    now = time.monotonic()
    main_ident = getattr(threading.main_thread(), "ident", None)
    out = []
    for t in threading.enumerate():
        ident = t.ident
        info = registry.get(ident) if ident is not None else None
        if info is not None:
            role = info["role"]
            age: Optional[float] = round(now - info["startedMonotonic"], 3)
        else:
            role = "main" if ident == main_ident else "unknown"
            age = None
        out.append(
            {
                "name": t.name,
                "ident": ident,
                "role": role,
                "daemon": t.daemon,
                "ageSeconds": age,
            }
        )
    out.sort(key=lambda e: (e["role"], e["name"]))
    return out
