"""Online reuse-distance estimation for the device block store.

SHARDS-style spatially-hashed sampling (Waldspurger et al., FAST'15):
admit a block reference into the LRU-stack model only when
hash(key) mod P < T, track stack distances for the sampled keys only,
and scale every observation by 1/rate (rate = T/P). Spatial hashing --
sampling KEYS, not references -- is what keeps the distance estimate
unbiased: a sampled key's every reference is observed, so its reuse
distances are exact up to the missing (unsampled) intermediate keys,
which the 1/rate scaling corrects in expectation.

Distances here are measured in BYTES (the sum of bytes of sampled
entries touched more recently, scaled by 1/rate), because the consumer
is the miss-ratio curve behind GET /debug/heat: predicted hit rate as a
function of a device *byte* budget (max-hbm-bytes). Distances land in
~1/8-decade log buckets, so the curve is within a few percent of exact
while the footprint stays a bounded dict regardless of trace length.

Memory is bounded twice over: the sampled stack holds at most
`max_samples` keys (SHARDS-max: on overflow the largest-hash entry is
evicted and T drops to its hash, so the effective rate self-tunes down
for huge key populations), and the distance histogram has at most
~buckets-per-decade x decades entries.

The admission fast path is ONE hash + compare with no lock, so the
block-fetch hot path pays next to nothing when the hash rejects. The
block store does not record on its hot path at all: it offer()s each
reference to a queue (one deque append), which is recorded in arrival
order when it reaches QUEUE_CAP and before every read, so the estimate
is the one record() would give on the same sequence. The
port's own copy of the JAX package's pilosa_tpu/utils/reuse.py: the
same estimator, so the two packages' /debug/heat curves agree on the
same access sequence (tests/test_torch_planes.py pins both against an
exact Mattson LRU simulation).
"""

from __future__ import annotations

import functools
import math
import threading
from collections import OrderedDict, deque

#: Hash modulus: admission compares the low 24 bits of hash(key)
#: against the threshold, so rate granularity is ~6e-8.
HASH_SPACE = 1 << 24

#: Log-bucket resolution of the byte-distance histogram: 8 buckets per
#: factor of 2 keeps the interpolated miss-ratio curve within ~4% of
#: the un-bucketed distances (0.5 * 2^(1/8) relative bound per bucket).
_BUCKETS_PER_LOG2 = 8.0


@functools.lru_cache(maxsize=4096)
def _bucket(nbytes: float) -> int:
    """Log bucket of a byte distance (memoized: a steady access pattern
    repeats a few distances)."""
    return int(math.log2(max(1.0, nbytes)) * _BUCKETS_PER_LOG2)


def _bucket_hi(b: int) -> float:
    """Upper byte bound of bucket b — the budget at which every
    distance in the bucket is a hit."""
    return 2.0 ** ((b + 1) / _BUCKETS_PER_LOG2)


class ReuseDistanceEstimator:
    """Online byte-weighted LRU reuse-distance histogram over a sampled
    key subset, with the derived hit-rate-vs-byte-budget curve."""

    #: Queued references (offer) past which the offering thread records
    #: the queue.
    QUEUE_CAP = 256

    def __init__(self, max_samples: int = 4096, start_rate: float = 1.0,
                 on_samples=None):
        self.max_samples = max_samples
        # offer()'s queue of (key, nbytes), recorded by flush(); and
        # on_samples(n), told how many references each flush admitted.
        self._queue: deque = deque()
        self._on_samples = on_samples
        # Admission threshold over HASH_SPACE; start_rate 1.0 samples
        # everything until SHARDS-max pressure lowers it, so small
        # working sets (tests, modest schemas) are tracked exactly.
        self._threshold = max(1, min(HASH_SPACE, int(start_rate * HASH_SPACE)))
        self._lock = threading.Lock()
        # Sampled LRU stack: key -> (nbytes, hash value), most recently
        # used LAST (OrderedDict append order).
        self._stack: "OrderedDict[tuple, tuple[int, int]]" = OrderedDict()
        # log-bucket index -> scaled observation weight (finite reuse
        # distances only; cold first-touches are infinite distance).
        self._hist: dict[int, float] = {}
        self.samples = 0  # admitted references (unscaled)
        self._finite_weight = 0.0
        self._cold_weight = 0.0

    # -- recording ---------------------------------------------------------

    def record(self, key: tuple, nbytes: int) -> bool:
        """Observe one reference to `key` (a block of `nbytes`).
        Returns True when the reference was admitted into the sample —
        the caller's cue to bump reuse_distance_samples_total. The
        rejection path is one hash + one compare, nothing else."""
        hv = hash(key) & (HASH_SPACE - 1)
        if hv >= self._threshold:
            return False
        with self._lock:
            return self._admit_all(((key, nbytes),)) == 1

    def offer(self, key: tuple, nbytes: int) -> None:
        """Queue one reference for recording: one deque append, no lock, no
        hash. The queue is recorded in arrival order by flush(), which every
        read makes first and which the offering thread makes once the queue
        holds QUEUE_CAP references."""
        q = self._queue
        q.append((key, nbytes))
        if len(q) >= self.QUEUE_CAP:
            self.flush()

    def flush(self, min_queued: int = 1) -> int:
        """Record every queued reference, oldest first, when at least
        min_queued are queued, and return how many were admitted (also
        passed to on_samples). Under the lock, so two flushes never reorder
        the queue."""
        q = self._queue
        if len(q) < min_queued or not q:
            return 0
        with self._lock:
            n = self._admit_all([q.popleft() for _ in range(len(q))])
        if n and self._on_samples is not None:
            self._on_samples(n)
        return n

    def _admit_all(self, refs) -> int:
        """Record (key, nbytes) references in order (caller holds _lock);
        returns how many the sampler admitted."""
        stack, hist = self._stack, self._hist
        n = 0
        for key, nbytes in refs:
            hv = hash(key) & (HASH_SPACE - 1)
            # The gate under the lock: SHARDS-max may have lowered the
            # threshold since record()'s lock-free gate.
            if hv >= self._threshold:
                continue
            rate = self._threshold / HASH_SPACE
            w = 1.0 / rate
            n += 1
            if key in stack:
                # Byte stack distance = bytes of sampled entries touched
                # MORE recently than this key (walked newest-first, so
                # the cost is the distance itself — short for hot keys),
                # scaled to the full population by 1/rate.
                above = 0
                for k in reversed(stack):
                    if k == key:
                        break
                    above += stack[k][0]
                b = _bucket((above + nbytes) / rate)
                hist[b] = hist.get(b, 0.0) + w
                self._finite_weight += w
                stack.move_to_end(key)
            else:
                # Cold first touch: infinite distance (a compulsory
                # miss at ANY budget).
                self._cold_weight += w
            stack[key] = (int(nbytes), hv)
            if len(stack) > self.max_samples:
                self._shards_max_evict()
        self.samples += n
        return n

    def _shards_max_evict(self) -> None:
        """SHARDS-max: drop the largest-hash sampled key and lower the
        admission threshold to its hash — the rate self-tunes so the
        sample set stays at max_samples for any key population."""
        victim, vmax = None, -1
        for k, (_, hv) in self._stack.items():
            if hv > vmax:
                victim, vmax = k, hv
        if victim is not None:
            del self._stack[victim]
            self._threshold = max(1, vmax)

    # -- reading -----------------------------------------------------------

    @property
    def rate(self) -> float:
        return self._threshold / HASH_SPACE

    def hit_rate(self, budget_bytes: float) -> float:
        """Predicted LRU hit rate at an HBM byte budget: the weighted
        share of references whose byte reuse distance fits the budget
        (cold first-touches are misses at every budget). 0.0 when
        nothing has been observed."""
        self.flush()
        with self._lock:
            total = self._finite_weight + self._cold_weight
            if total <= 0:
                return 0.0
            fits = sum(
                w for b, w in self._hist.items() if _bucket_hi(b) <= budget_bytes
            )
            return fits / total

    def curve(self, points: int = 32) -> list[dict]:
        """The miss-ratio curve as hit-rate-vs-budget points at the
        populated bucket boundaries (at most `points`, log-thinned) —
        what /debug/heat serves and the HBM-sizing runbook reads."""
        self.flush()
        with self._lock:
            total = self._finite_weight + self._cold_weight
            if total <= 0:
                return []
            buckets = sorted(self._hist)
            cum = 0.0
            pts = []
            for b in buckets:
                cum += self._hist[b]
                pts.append(
                    {
                        "budgetBytes": int(_bucket_hi(b)),
                        "hitRate": round(cum / total, 4),
                    }
                )
        if len(pts) > points:
            step = len(pts) / points
            keep = {int(i * step) for i in range(points)}
            keep.add(len(pts) - 1)  # always keep the curve's endpoint
            pts = [p for i, p in enumerate(pts) if i in keep]
        return pts

    def snapshot(self) -> dict:
        """The /debug/heat `reuse` block: sampling state + the curve."""
        self.flush()
        with self._lock:
            sampled = len(self._stack)
            samples = self.samples
            cold = self._cold_weight
            finite = self._finite_weight
            rate = self._threshold / HASH_SPACE
        return {
            "samples": samples,
            "sampledKeys": sampled,
            "rate": round(rate, 6),
            "coldWeight": round(cold, 1),
            "finiteWeight": round(finite, 1),
            "curve": self.curve(),
        }

    def clear(self) -> None:
        with self._lock:
            self._queue.clear()
            self._stack.clear()
            self._hist.clear()
            self.samples = 0
            self._finite_weight = 0.0
            self._cold_weight = 0.0
