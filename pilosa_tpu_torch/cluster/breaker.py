"""Per-peer circuit breaker for the DCN data plane.

One breaker per peer (host:port — the same label every peer_rpc_* series
uses), owned by the InternalClient that dials that peer, NOT a module
global: in-process test clusters run many nodes in one interpreter, and
node A's view of peer C must never be poisoned by node B's one-sided
partition to C (the same asymmetry discipline as the failure detector's
vote_down).

State machine (the classic three-state breaker):

- CLOSED: traffic flows; consecutive transport failures count up.
  ``threshold`` consecutive failures -> OPEN.
- OPEN: routing layers (map_shards node selection, route_write*) treat
  the peer like NODE_STATE_DOWN and go straight to replicas instead of
  eating a socket timeout per request. The client itself never refuses a
  dial — the failure detector's probes and any sole-owner fallback must
  still reach the peer, and their outcomes drive recovery.
- After a jittered cooldown OPEN relaxes to HALF_OPEN: the peer is
  routable again, and the next real RPC is the probe. Success -> CLOSED;
  failure -> OPEN again with the cooldown doubled (capped), so a peer
  that keeps failing is re-probed at a decaying rate instead of a fixed
  hammer.

Failures are TRANSPORT failures only (refused, reset, timeout): an HTTP
error status means the peer is alive and serving — it closes the
breaker. A timeout induced by an almost-expired query deadline is the
query's fault, not the peer's; the client skips recording those
(client.py _do).

Metrics: ``peer_breaker_state{peer}`` gauge (0 closed, 1 half-open,
2 open) and ``peer_breaker_transitions_total{peer,to}``.
"""

from __future__ import annotations

import random
import threading
import time

STATE_CLOSED = "closed"
STATE_HALF_OPEN = "half-open"
STATE_OPEN = "open"

_STATE_GAUGE = {STATE_CLOSED: 0, STATE_HALF_OPEN: 1, STATE_OPEN: 2}


class _PeerBreaker:
    __slots__ = ("state", "failures", "reopen_count", "open_until")

    def __init__(self):
        self.state = STATE_CLOSED
        self.failures = 0  # consecutive transport failures
        self.reopen_count = 0  # consecutive OPEN entries (backoff exponent)
        self.open_until = 0.0  # monotonic instant the cooldown ends


class BreakerRegistry:
    def __init__(
        self,
        threshold: int = 3,
        cooldown: float = 1.0,
        max_cooldown: float = 30.0,
    ):
        self.threshold = max(int(threshold), 1)
        self.cooldown = float(cooldown)
        self.max_cooldown = float(max_cooldown)
        self._lock = threading.Lock()
        self._peers: dict[str, _PeerBreaker] = {}

    # -- transitions (lock held) -------------------------------------------

    def _publish(self, peer: str, b: _PeerBreaker, to_state: str) -> None:
        from pilosa_tpu_torch.utils.stats import global_stats

        b.state = to_state
        global_stats.with_tags(f"peer:{peer}").gauge(
            "peer_breaker_state", _STATE_GAUGE[to_state]
        )
        global_stats.with_tags(f"peer:{peer}", f"to:{to_state}").count(
            "peer_breaker_transitions_total"
        )

    def _open(self, peer: str, b: _PeerBreaker) -> None:
        # Jittered exponential cooldown: 0.5-1.5x the doubled base, so a
        # fleet of coordinators that all saw the same peer die does not
        # re-probe it in lockstep.
        base = min(self.cooldown * (2**b.reopen_count), self.max_cooldown)
        b.reopen_count += 1
        b.open_until = time.monotonic() + base * (0.5 + random.random())
        self._publish(peer, b, STATE_OPEN)

    # -- recording (called from client._do) --------------------------------

    def record_failure(self, peer: str) -> None:
        """One transport failure. HALF_OPEN probe failure re-opens with a
        doubled cooldown; threshold consecutive CLOSED failures open."""
        with self._lock:
            b = self._peers.setdefault(peer, _PeerBreaker())
            b.failures += 1
            if b.state == STATE_HALF_OPEN or (
                b.state == STATE_CLOSED and b.failures >= self.threshold
            ):
                self._open(peer, b)

    def record_success(self, peer: str) -> None:
        """Any completed exchange (including an HTTP error status: the
        peer answered) closes the breaker and resets the backoff."""
        with self._lock:
            b = self._peers.get(peer)
            if b is None:
                return
            b.failures = 0
            b.reopen_count = 0
            if b.state != STATE_CLOSED:
                self._publish(peer, b, STATE_CLOSED)

    # -- routing queries ----------------------------------------------------

    def is_blocked(self, peer: str) -> bool:
        """True while the peer's breaker is OPEN and inside its cooldown:
        routing layers treat the peer like DOWN. Cooldown expiry relaxes
        to HALF_OPEN here (the first caller to ask after expiry performs
        the state change; the next real RPC is the probe)."""
        with self._lock:
            b = self._peers.get(peer)
            if b is None or b.state == STATE_CLOSED:
                return False
            if b.state == STATE_OPEN:
                if time.monotonic() < b.open_until:
                    return True
                self._publish(peer, b, STATE_HALF_OPEN)
            return False  # HALF_OPEN: routable — the next RPC probes

    def state(self, peer: str) -> str:
        with self._lock:
            b = self._peers.get(peer)
            return b.state if b is not None else STATE_CLOSED
