"""End-to-end query deadlines (ISSUE r9 tentpole 1).

A Deadline is a monotonic budget created once at HTTP ingress (from
``?timeout=``, the ``X-Pilosa-Deadline`` request header, or the server's
``query-timeout`` config default) and consulted by every layer under it:

- the executor checks it at phase boundaries (the same phase names
  QueryProfile records) and aborts with DeadlineExceeded;
- the cluster's scatter-gather derives its gather wait from it instead
  of the flat ``client.timeout + 30``;
- the peer client bounds every RPC's socket timeout to
  ``min(client.timeout, remaining)`` and propagates the remaining budget
  (minus a skew margin) to the remote node via ``X-Pilosa-Deadline``, so
  a peer abandons work the coordinator has already given up on.

The deadline is activated thread-locally (deadline_scope) exactly like
QueryProfile: the serving path is thread-per-request, so the thread-local
IS the request scope. Scatter-gather worker threads re-establish the
scope explicitly (cluster.py hands the captured Deadline over, the same
way it hands the parent span over).

Every expiry observed by check() counts on
``deadline_exceeded_total{phase}`` — on the node that observed it, which
for a propagated budget is the REMOTE node aborting its leg.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

#: Subtracted from the remaining budget before it is propagated to a
#: peer: covers serialization + transit + the receiving node's dispatch,
#: so the remote's clock starts strictly inside the coordinator's budget
#: and a leg never outlives the coordinator's wait by header rounding.
SKEW_MARGIN = 0.025

#: A request may not ask for more than this (3600 s): a garbage or
#: abusive ?timeout= must not pin a serving thread for a day.
MAX_TIMEOUT = 3600.0

#: Floor handed to socket timeouts: stdlib treats 0 as non-blocking.
MIN_TIMEOUT = 0.001


class DeadlineExceeded(Exception):
    """The query's budget ran out. Carries the phase that observed the
    expiry; the HTTP layer maps this to 504 + code=deadline-exceeded."""

    def __init__(self, msg: str, phase: str = ""):
        super().__init__(msg)
        self.phase = phase


class Deadline:
    """Monotonic absolute expiry; immutable once created."""

    __slots__ = ("_expires", "budget")

    def __init__(self, seconds: float):
        self.budget = float(seconds)
        self._expires = time.monotonic() + self.budget

    @staticmethod
    def parse(raw) -> "Deadline":
        """A client-supplied budget (?timeout= / X-Pilosa-Deadline) ->
        Deadline. Raises ValueError on garbage or non-positive values so
        the HTTP layer can 400 instead of silently serving unbounded."""
        seconds = float(raw)  # ValueError propagates
        if not seconds > 0:  # rejects NaN too: NaN <= 0 is also False
            raise ValueError(f"timeout must be positive, got {seconds}")
        return Deadline(min(seconds, MAX_TIMEOUT))

    def remaining(self) -> float:
        return self._expires - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, phase: str) -> None:
        """Raise (and count) if the budget ran out. Call at the START of
        a unit of work: work already done is sunk cost, work not yet
        started is the part worth abandoning."""
        rem = self.remaining()
        if rem > 0:
            return
        from pilosa_tpu_torch.utils.stats import global_stats

        global_stats.with_tags(f"phase:{phase}").count("deadline_exceeded_total")
        raise DeadlineExceeded(
            f"deadline exceeded ({-rem * 1e3:.0f} ms past a "
            f"{self.budget:g} s budget) in phase {phase}",
            phase=phase,
        )

    def bound(self, timeout: float) -> float:
        """A socket/wait timeout bounded by the remaining budget."""
        return max(min(timeout, self.remaining()), MIN_TIMEOUT)

    def header_value(self) -> str:
        """Remaining budget for the X-Pilosa-Deadline propagation header,
        skew margin already subtracted. Relative seconds, NOT a wall-clock
        instant: peers' clocks may disagree by more than a short query's
        whole budget (the PR 3 trace assembler measures exactly that
        skew), while transit time — the error a relative value absorbs —
        is bounded by the margin."""
        return f"{max(self.remaining() - SKEW_MARGIN, MIN_TIMEOUT):.6f}"


_local = threading.local()


def current_deadline() -> Optional[Deadline]:
    """The active thread's Deadline, or None (no budget: maintenance
    work, direct executor callers, requests without a timeout)."""
    return getattr(_local, "deadline", None)


def check_deadline(phase: str) -> None:
    """Phase-boundary check against the active deadline, if any."""
    d = current_deadline()
    if d is not None:
        d.check(phase)


class deadline_scope:
    """Activate a Deadline for the current thread. None is a valid scope
    (explicitly no budget). Nested scopes keep the TIGHTER deadline: an
    outer request budget must not be loosened by an inner layer."""

    __slots__ = ("deadline", "_prev")

    def __init__(self, deadline: Optional[Deadline]):
        self.deadline = deadline

    def __enter__(self) -> Optional[Deadline]:
        self._prev = getattr(_local, "deadline", None)
        d = self.deadline
        if d is None or (
            self._prev is not None and self._prev.remaining() <= d.remaining()
        ):
            d = self._prev
        _local.deadline = d
        return d

    def __exit__(self, *exc) -> bool:
        _local.deadline = self._prev
        return False
