"""Process runtime monitor + diagnostics snapshot.

Reference server.go:813-857 (monitorRuntime: heap/GC/goroutine gauges on
a poll interval, gcnotify/gopsutil) and diagnostics.go:42-260 (hourly
diagnostics). This build polls the Python/OS equivalents — RSS,
thread count, open fds, GC collections, uptime — onto the stats
registry (visible at /metrics), plus device-side gauges (resident
bytes, eviction count) when a device backend is attached. Diagnostics
is a local snapshot served at /debug/diagnostics: this environment has
zero egress, so the reference's phone-home becomes an operator
endpoint with the same content (version, platform, schema shape,
uptime) instead of an HTTP POST to a vendor.
"""

from __future__ import annotations

import gc
import os
import platform
import re
import threading
import time
from collections import deque
from typing import Optional

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.utils.stats import (
    BUCKET_BOUNDS,
    bucket_fraction_le,
    bucket_quantile,
    global_stats,
    merge_buckets,
    series_matches,
)

# Single source of process uptime for gauges AND /debug/diagnostics.
# Monotonic (lint: monotonic-time): uptime is a DURATION —
# an NTP step must never make it jump. Every timestamp in this module
# (snapshot ring, exemplar ages, burn windows) shares this clock.
PROCESS_STARTED_AT = time.monotonic()

#: Multi-window burn-rate horizons (the classic fast/slow alert pair):
#: the fast window catches a sudden burn before it torches the budget,
#: the slow window keeps a brief blip from paging anyone.
SLO_FAST_WINDOW = 300.0
SLO_SLOW_WINDOW = 3600.0

#: Ingest-derate ladder ceiling. Each level
#: halves import admission in api.begin_import, so level 4 admits
#: 1-in-16 — enough to shed a writer overdrive without ever fully
#: closing the door (a wedged-open ladder still trickles imports, and
#: the decay path below unwinds it one evaluation at a time).
DERATE_MAX_LEVEL = 4

#: Windowed-snapshot housekeeping: at most one retained snapshot per
#: _SNAP_MIN_INTERVAL (the poll loop runs every 10 s; finer grain buys
#: nothing a 5 m window can see). Retention covers the LARGEST window
#: any objective names (never less than the slow burn window) plus
#: slack — a 4 h compliance window must find a 4 h-old baseline, not
#: be silently truncated to the 1 h default.
_SNAP_MIN_INTERVAL = 15.0
_SNAP_RETENTION_SLACK = 120.0

#: Histogram families always retained in the window ring even with no
#: objective configured, so /debug/slo answers immediately after an
#: objective is added instead of starting blind.
_DEFAULT_SLO_FAMILIES = (
    "query_seconds",
    "http_request_duration_seconds",
    "peer_rpc_seconds",
)


def publish_hbm_gauges(blocks, stats=None) -> None:
    """HBM residency gauges — the untagged total plus the per-
    representation-tier split from the block-store ledger (the tier
    mix, not one scalar, is what an informed eviction policy
    needs). The ONE publisher, shared by the RuntimeMonitor poll loop
    and /metrics scrape-time refresh, so the invariant that the tagged
    tier series sum exactly to the untagged total cannot drift between
    two copies of this block."""
    s = stats or global_stats
    s.gauge("hbm_resident_bytes", blocks.resident_bytes())
    s.gauge("hbm_evictions_total", blocks.evictions)
    tiers = getattr(blocks, "tier_bytes", None)
    if tiers is not None:
        for tier, nbytes in tiers().items():
            s.with_tags(f"tier:{tier}").gauge("hbm_resident_bytes", nbytes)
    # Decayed-frequency heat per tier: same publisher
    # discipline as residency — poll loop and /metrics scrape share
    # this block, so the heat gauges can never disagree with the
    # residency split about which tiers exist.
    heat = getattr(blocks, "heat_snapshot", None)
    if heat is not None:
        for tier, h in heat(entries=0)["tierHeat"].items():
            s.with_tags(f"tier:{tier}").gauge("hbm_access_heat", h)


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def _open_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return 0


_SITE_RE = re.compile(r'site="([^"]+)"')


class FlightRecorder:
    """Interference flight recorder: a bounded 1 s-grain ring
    of RAW CUMULATIVE samples — counter totals, timing (sum, count)
    pairs, gauge point reads — from which /debug/timeline derives rates
    at serve time. Recording raw totals instead of deltas means a
    missed tick (busy poll thread, paused process) degrades to a wider
    span, never to a wrong rate.

    Cost contract: one sample is a handful of dict reads under the
    stats registry lock (counter_totals/timing_totals point reads — NO
    histogram_snapshot deep copy) and one ring append; idle cost is the
    same as loaded cost, ~microseconds. The ring rides the monitor
    poll thread at 1 Hz; bench's ingest leg and /debug/timeline may
    also call sample() — min_interval dedups concurrent tickers.

    freeze() pins the trailing window into a bounded incidents deque —
    called by RuntimeMonitor.evaluate_slos on a burn-rate False→True
    transition, so the timeline AROUND the moment an objective started
    burning survives ring eviction for the post-mortem."""

    COUNTER_FAMILIES = (
        "import_bits_total",
        "import_values_total",
        "device_launches_total",
        "snapshot_stall_seconds_total",
        "fragment_snapshots_total",
        "http_requests_shed_total",
    )
    TIMING_FAMILIES = ("query_seconds", "lock_wait_seconds")
    GAUGES = ("hbm_resident_bytes", "snapshot_pending", "wal_pending_ops")

    def __init__(self, capacity: int = 600, min_interval: float = 0.5):
        self.min_interval = min_interval
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._incidents: deque = deque(maxlen=4)

    def sample(self, stats=None) -> bool:
        """Append one raw sample; returns False when min_interval
        dedups it. The pre-read gate keeps N concurrent tickers from
        N-plicating registry reads; the post-read re-check keeps the
        ring monotonic in time."""
        now = time.monotonic()
        with self._lock:
            if self._ring and now - self._ring[-1]["t"] < self.min_interval:
                return False
        s = stats or global_stats
        rec = {
            "t": now,
            "counters": s.counter_totals(*self.COUNTER_FAMILIES),
            "timings": s.timing_totals(*self.TIMING_FAMILIES),
            "gauges": {g: s.gauge_value(g) for g in self.GAUGES},
        }
        with self._lock:
            if self._ring and now - self._ring[-1]["t"] < self.min_interval:
                return False
            self._ring.append(rec)
        return True

    def timeline(self, seconds: float = 60.0) -> list[dict]:
        """Adjacent-sample deltas over the trailing window, oldest
        first — the serve-time derivative of the raw ring."""
        now = time.monotonic()
        with self._lock:
            recs = [r for r in self._ring if now - r["t"] <= seconds + 1.0]
        return self._deltas(recs, now)

    @staticmethod
    def _deltas(recs: list[dict], now: float) -> list[dict]:
        out = []
        for prev, cur in zip(recs, recs[1:]):
            span = max(1e-9, cur["t"] - prev["t"])

            def cdelta(prefix, _p=prev, _c=cur):
                return sum(
                    max(0.0, v - _p["counters"].get(k, 0.0))
                    for k, v in _c["counters"].items()
                    if k.startswith(prefix)
                )

            q_n = q_s = 0.0
            lock_wait: dict[str, float] = {}
            for name, (tsum, tcount) in cur["timings"].items():
                psum, pcount = prev["timings"].get(name, (0.0, 0.0))
                if name.startswith("query_seconds"):
                    q_n += max(0.0, tcount - pcount)
                    q_s += max(0.0, tsum - psum)
                elif name.startswith("lock_wait_seconds"):
                    d = max(0.0, tsum - psum)
                    if d > 0.0:
                        m = _SITE_RE.search(name)
                        site = m.group(1) if m else "?"
                        lock_wait[site] = round(
                            lock_wait.get(site, 0.0) + d, 6
                        )
            g = cur["gauges"]
            out.append({
                "ageS": round(now - cur["t"], 1),
                "spanS": round(span, 2),
                "qps": round(q_n / span, 2),
                "queryS": round(q_s, 4),
                "ingestBitsPerS": round(cdelta("import_bits_total") / span, 1),
                "ingestValsPerS": round(cdelta("import_values_total") / span, 1),
                "deviceLaunches": int(cdelta("device_launches_total")),
                "snapshotStallS": round(cdelta("snapshot_stall_seconds_total"), 4),
                "snapshots": int(cdelta("fragment_snapshots_total")),
                "shedRequests": int(cdelta("http_requests_shed_total")),
                "lockWaitS": lock_wait,
                "hbmResidentBytes": int(g.get("hbm_resident_bytes", 0.0)),
                "snapshotPending": int(g.get("snapshot_pending", 0.0)),
                "walPendingOps": int(g.get("wal_pending_ops", 0.0)),
            })
        return out

    def freeze(self, reason: str, seconds: float = 120.0) -> dict:
        """Pin the trailing window as a named incident (bounded deque:
        the four most recent survive). Takes one fresh sample first so
        the incident includes the instant of the trigger."""
        self.sample()
        incident = {
            "reason": reason,
            # Epoch stamp: operators correlate incidents with logs.
            "at": time.time(),  # lint: allow-monotonic-time(operator-facing epoch display stamp, same contract as StallLedger)
            "timeline": self.timeline(seconds),
        }
        with self._lock:
            self._incidents.append(incident)
        return incident

    def incidents(self) -> list[dict]:
        with self._lock:
            return list(self._incidents)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._incidents.clear()


global_flight_recorder = FlightRecorder()


class RuntimeMonitor:
    """Polls process gauges onto the stats registry (reference
    monitorRuntime, server.go:813)."""

    def __init__(self, holder=None, backend=None, interval: float = 10.0):
        self.holder = holder
        self.backend = backend
        self.interval = interval
        self.started_at = PROCESS_STARTED_AT
        #: SLO objectives ([{metric, quantile, threshold_s, window_s}]),
        #: wired from server/config.py `slo` by the CLI; evaluated by
        #: /debug/slo against the windowed snapshots below.
        self.slo: list[dict] = []
        # (unix time, {series name: bucket tuple}) ring — the windowed
        # bucket snapshots burn-rate math diffs. Only latency families
        # an objective can name are retained (cardinality bound).
        self._hist_snaps: deque = deque()
        self._snap_lock = threading.Lock()
        # Objectives currently burning (keyed by metric spec) — the
        # edge detector behind flight-recorder auto-freeze: an incident
        # is pinned on the False→True transition only, never re-pinned
        # every evaluation while the burn persists.
        self._burning: set[str] = set()
        # Ingest-derate ladder: 0 = admit everything; each
        # level halves import admission (api.begin_import consults
        # derate_level() per request). Ramped +1 per evaluation while
        # ANY configured objective burns, decayed -1 per clean
        # evaluation — the multi-window burn rule already provides the
        # hysteresis, so the ladder never flaps on sub-minute blips.
        self._derate_level = 0
        self._seen_indexes: set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- SLO windowed snapshots + burn rates -------------------------------

    def _slo_families(self) -> tuple[str, ...]:
        extra = tuple(
            str(o.get("metric", "")).split("{", 1)[0]
            for o in self.slo
            if o.get("metric")
        )
        return _DEFAULT_SLO_FAMILIES + extra

    _series_matches = staticmethod(series_matches)

    def record_histogram_snapshot(self, snap: Optional[dict] = None,
                                  force: bool = False) -> None:
        """Retain the current bucket vectors of every SLO-relevant
        series. Called from the poll loop AND from /debug/slo scrapes,
        so windows accrue even on a server without the poller thread."""
        now = time.monotonic()
        with self._snap_lock:
            if (
                not force
                and self._hist_snaps
                and now - self._hist_snaps[-1][0] < _SNAP_MIN_INTERVAL
            ):
                # Gate BEFORE copying the registry: the poll loop runs
                # every 10 s against a 15 s min interval, so without
                # this early exit roughly every other poll would deep-
                # copy every timing series only to throw the copy away.
                return
        families = self._slo_families()
        if snap is None:
            snap = global_stats.histogram_snapshot()
        keep = {
            name: tuple(ent["buckets"])
            for name, ent in snap.items()
            if any(self._series_matches(name, f) for f in families)
        }
        retention = max(
            [SLO_SLOW_WINDOW]
            + [float(o.get("window_s", 0) or 0) for o in self.slo]
        ) + _SNAP_RETENTION_SLACK
        with self._snap_lock:
            if (
                not force
                and self._hist_snaps
                and now - self._hist_snaps[-1][0] < _SNAP_MIN_INTERVAL
            ):
                return
            self._hist_snaps.append((now, keep))
            while self._hist_snaps and now - self._hist_snaps[0][0] > retention:
                self._hist_snaps.popleft()

    def _window_counts(self, metric: str, window_s: float,
                       now_snap: dict) -> tuple[list[float], float]:
        """(per-bucket observation counts within the trailing window,
        actual seconds the window covers). The baseline is the newest
        retained snapshot at least window_s old; a younger monitor
        truncates the window to what it has actually seen — reported,
        never silently widened."""
        now = time.monotonic()
        current: Optional[list[float]] = None
        for name, ent in now_snap.items():
            if self._series_matches(name, metric):
                b = ent["buckets"] if isinstance(ent, dict) else ent
                current = list(b) if current is None else merge_buckets(current, b)
        if current is None:
            return [0.0] * (len(BUCKET_BOUNDS) + 1), 0.0
        base: Optional[dict] = None
        base_ts = None
        with self._snap_lock:
            for ts, keep in self._hist_snaps:
                if now - ts >= window_s:
                    base, base_ts = keep, ts
                else:
                    break
            if base is None and self._hist_snaps:
                base_ts, base = self._hist_snaps[0]
        if base is None:
            return current, now - self.started_at
        base_counts: Optional[list[float]] = None
        for name, b in base.items():
            if self._series_matches(name, metric):
                base_counts = (
                    list(b) if base_counts is None
                    else merge_buckets(base_counts, b)
                )
        if base_counts is None:
            return current, now - base_ts
        delta = [max(0.0, c - b) for c, b in zip(current, base_counts)]
        return delta, now - base_ts

    def evaluate_slos(self, objectives: Optional[list[dict]] = None) -> list[dict]:
        """Current compliance + multi-window burn rate per objective —
        the payload behind /debug/slo. Burn rate is the rate the error
        budget is being spent: (share of observations over threshold) /
        (1 - quantile); 1.0 burns the whole budget exactly over the
        objective window, 4x torches it in a quarter of it. An
        objective is `burning` only when BOTH the fast (5 m) and slow
        (1 h) windows burn >1 — the standard multi-window rule that
        suppresses both ancient history and sub-minute blips."""
        objs = objectives if objectives is not None else self.slo
        now_snap = global_stats.histogram_snapshot()
        out = []
        for o in objs:
            metric = str(o.get("metric", ""))
            q = float(o.get("quantile", 0.99))
            thr = float(o.get("threshold_s", 1.0))
            win = float(o.get("window_s", SLO_SLOW_WINDOW))
            budget = max(1e-9, 1.0 - q)
            ent: dict = {
                "metric": metric,
                "quantile": q,
                "thresholdS": thr,
                "windowS": win,
                "errorBudget": budget,
            }
            counts, span = self._window_counts(metric, win, now_snap)
            total = sum(counts)
            qv = bucket_quantile(counts, q)
            ent["observations"] = int(total)
            ent["windowCoveredS"] = round(span, 1)
            ent["currentQuantileS"] = (
                round(qv, 6) if qv is not None else None
            )
            ent["compliant"] = qv is None or qv <= thr
            for label, w in (("fast", SLO_FAST_WINDOW), ("slow", SLO_SLOW_WINDOW)):
                wc, wspan = self._window_counts(metric, w, now_snap)
                frac = bucket_fraction_le(wc, thr)
                viol = None if frac is None else max(0.0, 1.0 - frac)
                ent[f"burnRate_{label}"] = (
                    None if viol is None else round(viol / budget, 3)
                )
                ent[f"violationShare_{label}"] = (
                    None if viol is None else round(viol, 6)
                )
                ent[f"windowCoveredS_{label}"] = round(wspan, 1)
            ent["burning"] = bool(
                (ent["burnRate_fast"] or 0) > 1.0
                and (ent["burnRate_slow"] or 0) > 1.0
            )
            # Auto-freeze the flight recorder the moment an objective
            # STARTS burning: the interference timeline
            # around the transition is exactly the evidence the
            # post-mortem needs, and it would age out of the ring long
            # before a human looks.
            with self._snap_lock:
                was_burning = metric in self._burning
                if ent["burning"]:
                    self._burning.add(metric)
                else:
                    self._burning.discard(metric)
            if ent["burning"] and not was_burning:
                global_flight_recorder.freeze(f"slo-burn:{metric}")
            # Trace exemplars from over-threshold buckets, newest first:
            # the direct link from "this objective is burning" to
            # /debug/traces/<id> of a query that burned it. Exemplars
            # older than the objective window are dropped — cumulative
            # buckets remember yesterday's outage forever, and pointing
            # an operator at a long-evicted trace as evidence for a
            # CURRENT burn is worse than no exemplar at all. Exemplar
            # stamps are monotonic (utils/stats.py) — same clock as now.
            now = time.monotonic()
            exemplars = []
            for name, se in now_snap.items():
                if not self._series_matches(name, metric):
                    continue
                for ex in se.get("exemplars", ()):
                    if ex["value"] > thr and now - ex["time"] <= win:
                        exemplars.append(
                            {
                                "traceID": ex["trace_id"],
                                "valueS": round(ex["value"], 6),
                                "ageS": round(now - ex["time"], 1),
                                "series": name,
                            }
                        )
            exemplars.sort(key=lambda e: e["ageS"])
            ent["exemplars"] = exemplars[:5]
            out.append(ent)
        # SLO-adaptive ingest derating: step the
        # ladder once per evaluation of the monitor's OWN objectives —
        # an ad-hoc evaluate_slos(objectives=[...]) probe must never
        # move production admission. The configured objectives are the
        # read-plane contract (query/http latency), so any of them
        # burning means readers are paying for the writer.
        if objectives is None and self.slo:
            with self._snap_lock:
                if any(e["burning"] for e in out):
                    self._derate_level = min(
                        DERATE_MAX_LEVEL, self._derate_level + 1
                    )
                elif self._derate_level:
                    self._derate_level -= 1
                level = self._derate_level
            global_stats.gauge("ingest_derate_state", level)
        # Retain the snapshot AFTER evaluating: on a poller-less server
        # the very first scrape then falls back to cumulative-since-boot
        # (windowCoveredS = uptime, honestly reported) instead of
        # diffing the just-taken snapshot against itself and answering
        # "0 observations" over hours of history.
        self.record_histogram_snapshot(now_snap)
        return out

    def derate_level(self) -> int:
        """Current ingest-derate ladder position (0 = no derating).
        Read per import request by api.begin_import; a plain int read
        under the snap lock so admission never observes a torn ramp."""
        with self._snap_lock:
            return self._derate_level

    def poll_once(self) -> None:
        s = global_stats
        if self.slo:
            # Evaluating (rather than just snapshotting) is what arms
            # the burn-transition freeze on servers nobody is scraping:
            # the recorder must capture the incident even when no
            # /debug/slo request ever asks. evaluate_slos retains the
            # histogram snapshot itself.
            self.evaluate_slos()
        else:
            self.record_histogram_snapshot()
        s.gauge("runtime_rss_bytes", _rss_bytes())
        s.gauge("runtime_threads", threading.active_count())
        s.gauge("runtime_open_fds", _open_fds())
        s.gauge("runtime_uptime_seconds", time.monotonic() - self.started_at)
        # Kernel-side front-door truth on the same cadence:
        # listen-socket accept-queue depth + ListenOverflows/Drops
        # deltas; a graceful no-op off Linux. Lazy import: the monitor
        # must stay importable without the server package.
        from pilosa_tpu_torch.server.connplane import global_conn_plane

        global_conn_plane.poll_kernel(s)
        counts = gc.get_count()
        s.gauge("runtime_gc_gen0_pending", counts[0])
        collected = sum(st.get("collected", 0) for st in gc.get_stats())
        s.gauge("runtime_gc_collected_total", collected)
        if self.backend is not None:
            publish_hbm_gauges(self.backend.blocks, s)
        if self.holder is not None:
            current = set()
            for name in list(self.holder.indexes):
                idx = self.holder.index(name)
                if idx is None:
                    continue
                current.add(name)
                tagged = s.with_tags(f"index:{name}")
                tagged.gauge("index_fields", len(idx.fields))
                tagged.gauge(
                    "index_available_shards",
                    int(idx.available_shards().count()),
                )
            # Prune series for deleted indexes; /metrics must not export
            # a phantom index's last value forever.
            for name in self._seen_indexes - current:
                tagged = s.with_tags(f"index:{name}")
                tagged.remove_gauge("index_fields")
                tagged.remove_gauge("index_available_shards")
            self._seen_indexes = current

    def start(self) -> "RuntimeMonitor":
        from pilosa_tpu_torch.utils.threads import spawn

        self._thread = spawn("monitor-poll", self._run)
        return self

    def _run(self) -> None:
        # Tick at 1 s (bounded by the configured interval) so the
        # flight-recorder ring gets its 1-second grain; the heavier
        # gauge poll still runs only every `interval` seconds.
        tick = min(1.0, self.interval)
        next_poll = time.monotonic()
        while not self._stop.wait(tick):
            try:
                global_flight_recorder.sample()
                now = time.monotonic()
                if now >= next_poll:
                    next_poll = now + self.interval
                    self.poll_once()
            # lint: allow-except-exception(poll-loop crash barrier: a gauge bug must never kill the monitor thread)
            except Exception:  # noqa: BLE001 — gauges must never kill the loop
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _device_inventory() -> dict:
    """The device block for /debug/diagnostics: platform, device count,
    and per-device name and memory figures from torch.cuda. The block
    keeps the reference's shape (platform, device_count, devices[] of id,
    platform, kind, memory_stats) so diagnostics clients read both
    packages alike. It never starts CUDA: per-device figures are read
    only once a backend has initialised it, so a CPU-executor server or
    a machine without a card reports the count alone. Any failure is
    reported instead of raised — a diagnostics endpoint must never 500
    over its own inventory."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {"platform": "cpu", "device_count": 0, "devices": []}
        count = torch.cuda.device_count()
        inv: dict = {"platform": "gpu", "device_count": count, "devices": []}
        if not torch.cuda.is_initialized():
            return inv
        for i in range(count):
            free, total = torch.cuda.mem_get_info(i)
            inv["devices"].append({
                "id": i,
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(i),
                "memory_stats": {
                    "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                    "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                    "bytes_reserved": int(torch.cuda.memory_reserved(i)),
                    "bytes_free": int(free),
                    "bytes_limit": int(total),
                },
            })
        return inv
    except Exception as e:  # noqa: BLE001 — report, never raise
        return {"error": str(e)}


def diagnostics_snapshot(holder=None, started_at: Optional[float] = None) -> dict:
    """The reference's hourly diagnostics payload (diagnostics.go:42-260),
    served locally instead of phoned home (zero egress here)."""
    snap = {
        "version": __version__,
        "platform": {
            "os": platform.system(),
            "arch": platform.machine(),
            "python": platform.python_version(),
            "cpus": os.cpu_count(),
        },
        # Key kept from the reference ("jax") so /debug/diagnostics
        # clients read the same payload shape from either package.
        "jax": _device_inventory(),
        "uptime_seconds": round(
            time.monotonic() - (started_at or PROCESS_STARTED_AT), 1
        ),
        "rss_bytes": _rss_bytes(),
        "threads": threading.active_count(),
        "open_fds": _open_fds(),
    }
    if holder is not None:
        idx_info = []
        for name in list(holder.indexes):
            idx = holder.index(name)
            if idx is None:
                continue
            idx_info.append(
                {
                    "name": name,
                    "fields": len(idx.fields),
                    "shards": int(idx.available_shards().count()),
                }
            )
        snap["indexes"] = idx_info
    return snap
