"""Stats clients (reference stats/stats.go:31 StatsClient interface).

Backends: in-memory (serves /metrics in prometheus text format, replacing
the reference's prometheus/ and expvar backends), and nop. Tag scoping via
with_tags mirrors the reference's per-index/field tagging.

Timing series are fixed-boundary cumulative histograms (the reference
leaned on prometheus client_golang histograms for exactly this): every
series shares ONE static log-spaced boundary set, so bucket vectors from
different nodes are additive and /metrics/cluster can merge them into a
true cluster-wide distribution — averaging per-node p99s is statistically
meaningless, summing per-node buckets is exact. Quantiles are estimated
by linear interpolation within the bucket (prometheus histogram_quantile
semantics): never worse than one bucket width, and honest about it.
Each bucket also remembers the most recent observation made under an
active trace as an OpenMetrics-style exemplar, so a hot bucket links
straight into /debug/traces/<trace_id>.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import defaultdict
from typing import Callable, Optional, Sequence

#: Shared static bucket boundaries (seconds): 5 per decade, log-spaced,
#: 100 µs .. 100 s — 31 finite `le` bounds plus the implicit +Inf bucket.
#: Every histogram in the process (and, by construction, the cluster)
#: uses THIS set; identical boundaries are what make bucket vectors
#: additive across series, nodes, and scrape windows.
BUCKET_BOUNDS: tuple[float, ...] = tuple(
    round(10.0 ** (-4 + k / 5), 10) for k in range(31)
)

#: `le` label values, precomputed once ("0.0001" ... "100", no +Inf —
#: that label is the literal "+Inf").
_LE_LABELS: tuple[str, ...] = tuple(f"{b:.6g}" for b in BUCKET_BOUNDS)

#: Worst-case multiplicative error of an interpolated quantile: one
#: bucket spans a factor of 10^(1/5) ≈ 1.585.
BUCKET_RATIO: float = 10.0 ** (1 / 5)

#: The quantiles every summary surface reports (label stem, q) —
#: /debug/vars timings, /debug/queries, bench `*_server_ms` all iterate
#: THIS table so adding a quantile is one edit, not three.
QUANTILE_LABELS: tuple[tuple[str, float], ...] = (
    ("p50", 0.5), ("p95", 0.95), ("p99", 0.99), ("p999", 0.999),
)


def bucket_index(value: float) -> int:
    """Index of the bucket a value falls in (len(BUCKET_BOUNDS) = +Inf).
    Buckets are (prev_bound, bound] to match prometheus `le` semantics."""
    return bisect_left(BUCKET_BOUNDS, value)


def bucket_quantile(counts: Sequence[float], q: float) -> Optional[float]:
    """Estimate the q-quantile (0 < q < 1) from a per-bucket count vector
    (len(BUCKET_BOUNDS)+1, last = +Inf) by linear interpolation within
    the target bucket — prometheus histogram_quantile semantics. The
    +Inf bucket clamps to the largest finite bound. None when empty."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= rank:
            lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
            if i >= len(BUCKET_BOUNDS):
                return BUCKET_BOUNDS[-1]
            hi = BUCKET_BOUNDS[i]
            return lo + (hi - lo) * (rank - cum) / c
        cum += c
    return BUCKET_BOUNDS[-1]


def bucket_fraction_le(counts: Sequence[float], threshold: float) -> Optional[float]:
    """Estimated fraction of observations <= threshold seconds, linearly
    interpolated within the bucket containing the threshold — the CDF
    read an SLO compliance check needs. None when the vector is empty."""
    total = sum(counts)
    if total <= 0:
        return None
    i = bucket_index(threshold)
    cum = sum(counts[:i])
    if i < len(BUCKET_BOUNDS):
        lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
        hi = BUCKET_BOUNDS[i]
        cum += counts[i] * (threshold - lo) / (hi - lo)
    else:
        cum += counts[i] if i < len(counts) else 0.0
    return min(1.0, cum / total)


def merge_buckets(a: Sequence[float], b: Sequence[float]) -> list[float]:
    """Sum two per-bucket count vectors — the merge operation identical
    boundaries buy (commutative and associative by construction)."""
    return [x + y for x, y in zip(a, b)]


def histogram_mean(entry: dict, baseline: Optional[dict] = None) -> Optional[float]:
    """Exact mean of one histogram_snapshot() entry, optionally diffed
    against an earlier snapshot of the same series (windowed mean).
    Derived from the exact _sum/_count — never from bucket midpoints —
    so it is precise even for value-typed histograms whose range
    outruns the bucket set (batch_occupancy's legs/launch, where the
    bench's acceptance gate is the windowed mean). None when the
    (diffed) series is empty."""
    s, c = entry["sum"], entry["count"]
    if baseline is not None:
        s -= baseline["sum"]
        c -= baseline["count"]
    if c <= 0:
        return None
    return s / c


def series_matches(name: str, metric: str) -> bool:
    """Does a snapshot series name (`family` or `family{tags}`) belong
    to `metric`? `metric` may itself be a fully tagged series name. The
    ONE matching rule SLO evaluation (utils/monitor.py) and bench's
    server-side quantiles share."""
    return name == metric or name.startswith(metric + "{")


#: Hook returning the current thread's active trace id (or None) —
#: registered by utils/tracing.py at import. A provider hook instead of
#: an import because tracing imports stats; the cycle must break here.
_exemplar_provider: Optional[Callable[[], Optional[str]]] = None


def set_exemplar_provider(fn: Callable[[], Optional[str]]) -> None:
    global _exemplar_provider
    _exemplar_provider = fn


def exemplar_trace_id() -> Optional[str]:
    """The current thread's active trace id via the registered provider,
    or None. Public so non-histogram surfaces (the lock-stall ledger)
    can stamp records with the same resolvable id exemplars carry."""
    if _exemplar_provider is None:
        return None
    try:
        return _exemplar_provider()
    # lint: allow-except-exception(exemplar provider is best-effort; a tracer bug must not fail a stall record)
    except Exception:  # noqa: BLE001 — exemplars are best-effort
        return None


class _Histogram:
    """One timing series: per-bucket counts + exact sum/count, plus the
    most recent traced observation per bucket (the exemplar)."""

    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self):
        self.counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self.sum = 0.0
        self.count = 0
        # bucket index -> (trace_id, observed value, monotonic time)
        self.exemplars: dict[int, tuple[str, float, float]] = {}


class StatsClient:
    """In-memory counters/gauges/histograms with prometheus text export."""

    def __init__(self, tags: Optional[Sequence[str]] = None, _root: Optional["StatsClient"] = None):
        self.tags = tuple(sorted(tags or ()))
        root = _root or self
        self._root = root
        if _root is None:
            self._lock = threading.Lock()
            self._counters: dict[tuple, float] = defaultdict(float)
            self._gauges: dict[tuple, float] = {}
            self._timings: dict[tuple, _Histogram] = {}

    def with_tags(self, *tags: str) -> "StatsClient":
        child = StatsClient(self.tags + tuple(tags), _root=self._root)
        return child

    def _key(self, name: str) -> tuple:
        return (name, self.tags)

    def count(self, name: str, value: float = 1, rate: float = 1.0) -> None:
        r = self._root
        with r._lock:
            r._counters[self._key(name)] += value

    def gauge(self, name: str, value: float, rate: float = 1.0) -> None:
        r = self._root
        with r._lock:
            r._gauges[self._key(name)] = value

    def remove_gauge(self, name: str) -> None:
        """Drop a gauge series (e.g. a deleted index's per-index gauges —
        otherwise /metrics exports its last value forever)."""
        r = self._root
        with r._lock:
            r._gauges.pop(self._key(name), None)

    def timing(self, name: str, value: float, rate: float = 1.0) -> None:
        """Observe one latency sample. Lock-cheap by construction: the
        bucket search and the exemplar lookup happen OUTSIDE the lock;
        the critical section is four scalar updates — hot paths
        (qprofile phase exit, peer_rpc_seconds, HTTP request timing)
        pay no list append and never a ring trim."""
        i = bucket_index(value)
        trace_id = None
        if _exemplar_provider is not None:
            try:
                trace_id = _exemplar_provider()
            # lint: allow-except-exception(exemplar provider is best-effort; a tracer bug must not fail the hot observe path)
            except Exception:  # noqa: BLE001 — exemplars are best-effort
                trace_id = None
        # Monotonic stamp: exemplar times only ever feed AGE arithmetic
        # (utils/monitor.py SLO windows, /debug/slo ageS) — never an
        # epoch display (lint: monotonic-time).
        exemplar = (trace_id, value, time.monotonic()) if trace_id else None
        r = self._root
        key = self._key(name)
        with r._lock:
            h = r._timings.get(key)
            if h is None:
                h = r._timings[key] = _Histogram()
            h.counts[i] += 1
            h.count += 1
            h.sum += value
            if exemplar is not None:
                h.exemplars[i] = exemplar

    def observe(self, name: str, value: float) -> None:
        self.timing(name, value)

    def histogram(self, name: str, value: float, rate: float = 1.0) -> None:
        self.timing(name, value, rate)

    class _Timer:
        def __init__(self, client: "StatsClient", name: str):
            self.client = client
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.client.timing(self.name, time.perf_counter() - self.t0)

    def timer(self, name: str) -> "_Timer":
        return self._Timer(self, name)

    @staticmethod
    def _fmt_tags(tags: tuple, extra: str = "") -> str:
        if not tags and not extra:
            return ""
        pairs = []
        for t in tags:
            if ":" in t:
                k, v = t.split(":", 1)
            else:
                k, v = t, "true"
            pairs.append(f'{k}="{v}"')
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}"

    def snapshot(self) -> dict:
        """expvar-style dict of every live series (served by /debug/vars,
        the reference's expvar route, http/handler.go:307). Same series
        naming as the prometheus text — name{k="v",...} — so operators
        can grep either surface with one vocabulary. Timings export the
        monotonic count/sum plus bucket-interpolated p50/p95/p99/p999
        (cumulative since process start — never a sample ring, so a
        series can neither vanish nor recency-bias its quantiles)."""
        r = self._root
        out: dict[str, dict] = {"counters": {}, "gauges": {}, "timings": {}}
        with r._lock:
            for (name, tags), v in sorted(r._counters.items()):
                out["counters"][name + self._fmt_tags(tags)] = v
            for (name, tags), v in sorted(r._gauges.items()):
                out["gauges"][name + self._fmt_tags(tags)] = v
            for (name, tags), h in sorted(r._timings.items()):
                entry: dict = {"count": h.count, "sum": h.sum}
                if h.count:
                    for label, q in QUANTILE_LABELS:
                        entry[label] = bucket_quantile(h.counts, q)
                out["timings"][name + self._fmt_tags(tags)] = entry
        return out

    def counter_totals(self, *prefixes: str) -> dict[str, float]:
        """{full series name: current value} for counter families whose
        name starts with any prefix — a point read for high-frequency
        samplers (the flight recorder ticks at 1 Hz; a full snapshot()
        deep-copies and sorts every series on each tick, this copies a
        handful of floats)."""
        r = self._root
        out: dict[str, float] = {}
        with r._lock:
            for (name, tags), v in r._counters.items():
                if name.startswith(prefixes):
                    out[name + self._fmt_tags(tags)] = v
        return out

    def timing_totals(self, *prefixes: str) -> dict[str, tuple[float, float]]:
        """{full series name: (cumulative sum, observation count)} for
        timing families matching any prefix — the recorder's qps and
        per-site lock-wait inputs without copying bucket vectors."""
        r = self._root
        out: dict[str, tuple[float, float]] = {}
        with r._lock:
            for (name, tags), h in r._timings.items():
                if name.startswith(prefixes):
                    out[name + self._fmt_tags(tags)] = (h.sum, h.count)
        return out

    def gauge_value(self, name: str, default: float = 0.0) -> float:
        """Current value of one gauge series (this client's tag scope),
        or `default` — the recorder's residency/pending point reads."""
        r = self._root
        with r._lock:
            return r._gauges.get((name, self.tags), default)

    def histogram_snapshot(self) -> dict[str, dict]:
        """{series name: {"buckets": per-bucket counts, "sum", "count",
        "exemplars": [{"trace_id","value","time"}...]}} — the raw bucket
        vectors behind every timing series. This is what windowed SLO
        evaluation (utils/monitor.py) diffs, what bench.py interpolates
        server-side quantiles from, and what tests merge directly."""
        r = self._root
        out: dict[str, dict] = {}
        with r._lock:
            for (name, tags), h in sorted(r._timings.items()):
                out[name + self._fmt_tags(tags)] = {
                    "buckets": list(h.counts),
                    "sum": h.sum,
                    "count": h.count,
                    "exemplars": [
                        {"trace_id": t, "value": v, "time": ts}
                        for _, (t, v, ts) in sorted(h.exemplars.items())
                    ],
                }
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition format for /metrics (reference
        prometheus/prometheus.go backend + /metrics route). Counters and
        gauges are flat series; timings are full cumulative histograms:
        `_bucket{le=...}` / `_sum` / `_count` under `# TYPE <family>
        histogram`, with OpenMetrics-style `# {trace_id="..."} <value>`
        exemplars on buckets that observed a traced request."""
        r = self._root
        out = []
        with r._lock:
            prev = None
            for (name, tags), v in sorted(r._counters.items()):
                metric = "pilosa_" + name.replace(".", "_").replace("-", "_")
                if metric != prev:
                    out.append(f"# HELP {metric} counter {name}")
                    out.append(f"# TYPE {metric} counter")
                    prev = metric
                out.append(f"{metric}{self._fmt_tags(tags)} {v}")
            prev = None
            for (name, tags), v in sorted(r._gauges.items()):
                metric = "pilosa_" + name.replace(".", "_").replace("-", "_")
                if metric != prev:
                    out.append(f"# HELP {metric} gauge {name}")
                    out.append(f"# TYPE {metric} gauge")
                    prev = metric
                out.append(f"{metric}{self._fmt_tags(tags)} {v}")
            prev = None
            for (name, tags), h in sorted(r._timings.items()):
                metric = "pilosa_" + name.replace(".", "_").replace("-", "_")
                if metric != prev:
                    out.append(
                        f"# HELP {metric} latency histogram of {name} (seconds)"
                    )
                    out.append(f"# TYPE {metric} histogram")
                    prev = metric
                cum = 0
                for i, c in enumerate(h.counts):
                    cum += c
                    le = _LE_LABELS[i] if i < len(_LE_LABELS) else "+Inf"
                    le_tag = f'le="{le}"'
                    line = f"{metric}_bucket{self._fmt_tags(tags, le_tag)} {cum}"
                    ex = h.exemplars.get(i)
                    if ex is not None:
                        line += f' # {{trace_id="{ex[0]}"}} {ex[1]:.6g}'
                    out.append(line)
                out.append(f"{metric}_sum{self._fmt_tags(tags)} {h.sum}")
                out.append(f"{metric}_count{self._fmt_tags(tags)} {h.count}")
        return "\n".join(out) + "\n"


class NopStatsClient:
    """reference stats/stats.go:69 NopStatsClient."""

    tags: tuple = ()

    def with_tags(self, *tags):
        return self

    def count(self, name, value=1, rate=1.0):
        pass

    def gauge(self, name, value, rate=1.0):
        pass

    def timing(self, name, value, rate=1.0):
        pass

    def observe(self, name, value):
        pass

    def histogram(self, name, value, rate=1.0):
        pass

    def timer(self, name):
        import contextlib

        return contextlib.nullcontext()

    def prometheus_text(self):
        return "\n"

    def snapshot(self):
        return {"counters": {}, "gauges": {}, "timings": {}}

    def histogram_snapshot(self):
        return {}

    def counter_totals(self, *prefixes):
        return {}

    def timing_totals(self, *prefixes):
        return {}

    def gauge_value(self, name, default=0.0):
        return default


global_stats = StatsClient()
