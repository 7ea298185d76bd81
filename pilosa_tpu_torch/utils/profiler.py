"""Live-server CPU profiling — the /debug/pprof analog.

The reference exposes Go's pprof endpoints plus profile.block-rate /
profile.mutex-fraction config (reference http/handler.go:283-295,
server/config.go:153-155). Python's cProfile hooks only the calling
thread, which is useless for a ThreadingHTTPServer where the work runs on
per-connection handler threads — so this is a SAMPLING profiler over
``sys._current_frames()`` (the py-spy idea, in-process): every interval
it captures all threads' stacks and aggregates self + cumulative hit
counts per frame. Sampling costs nothing between samples, needs no
instrumentation, and sees every thread, including JAX dispatch waits.

Every sample is also attributed to the owning thread's registered ROLE
(utils/threads.py): the report carries a per-role breakdown
and stop() flushes the counts to ``thread_samples_total{role}``, so
"which plane is burning CPU" is answerable from /metrics alone — the
old report named 20 anonymous ``Thread-N`` stacks nobody could place.

Two operator flows (server/http.py routes):
- ``GET /debug/pprof/profile?seconds=10&top=30`` — Go-pprof-style: block
  for the window, return the aggregated report.
- ``POST /debug/pprof/start`` + ``POST /debug/pprof/stop`` — manual
  bracketing around an interesting workload.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict
from typing import Optional

from pilosa_tpu_torch.utils import threads


class SamplingProfiler:
    """Whole-process stack sampler; one instance per server."""

    def __init__(self, interval: float = 0.005):
        self.interval = interval
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._samples = 0
        self._t0 = 0.0
        self._elapsed = 0.0
        # (file, line, func) -> [self_hits, cumulative_hits]
        self._frames: dict[tuple, list[int]] = defaultdict(lambda: [0, 0])
        # role -> thread-samples (one per sampled thread per sample)
        self._role_samples: dict[str, int] = defaultdict(int)

    @property
    def running(self) -> bool:
        return self._thread is not None

    def start(self) -> bool:
        """Begin sampling; False if already running."""
        with self._lock:
            if self._thread is not None:
                return False
            # Per-session stop event + frames dict: a stale sampler from
            # a just-stopped session keeps ITS event (already set) and
            # ITS dict, so it can neither outlive its stop nor write
            # into the new session's aggregates.
            self._stop = threading.Event()
            self._samples = 0
            self._frames = defaultdict(lambda: [0, 0])
            self._role_samples = defaultdict(int)
            self._t0 = time.perf_counter()
            self._thread = threads.spawn(
                "profiler",
                self._run,
                args=(self._stop, self._frames),
                name="pprof-sampler",
            )
            return True

    def stop(self, top: int = 30) -> dict:
        """Stop sampling and return the aggregated report. The stop
        event is set INSIDE the lock: a concurrent start() would
        otherwise clear-then-launch between our thread handoff and the
        set(), killing its fresh sampler at birth and wedging `running`
        True forever."""
        with self._lock:
            t = self._thread
            self._thread = None
            if t is not None:
                self._stop.set()
                self._elapsed = time.perf_counter() - self._t0
        if t is not None:
            t.join(timeout=2)
            # Flush the session's role attribution to the registry ONCE
            # per session (never per sample — sampling must stay free):
            # thread_samples_total{role} is the /metrics twin of the
            # report's `roles` block.
            from pilosa_tpu_torch.utils.stats import global_stats

            with self._lock:
                flush = dict(self._role_samples)
            for role, hits in flush.items():
                global_stats.with_tags(f"role:{role}").count(
                    "thread_samples_total", hits
                )
        return self.report(top)

    def profile(self, seconds: float, top: int = 30) -> dict:
        """Go-pprof-style: sample for `seconds`, return the report.
        Concurrent with start/stop: whoever starts first wins; a profile
        call while a manual session runs returns its own error entry."""
        if not self.start():
            return {"error": "profiler already running (POST /debug/pprof/stop)"}
        time.sleep(max(0.0, seconds))
        return self.stop(top)

    def _run(self, stop: threading.Event, agg: dict) -> None:
        own = threading.get_ident()
        while not stop.wait(self.interval):
            frames = sys._current_frames()
            # ONE registry lock acquisition per sample (not per thread):
            # the map is read under the profiler lock below.
            role_map = threads.roles_snapshot()
            with self._lock:
                if stop is not self._stop:
                    return  # superseded session: drop the final sample
                self._samples += 1
                for tid, frame in frames.items():
                    if tid == own:
                        continue
                    self._role_samples[
                        role_map.get(tid, "unknown")
                    ] += 1
                    seen = set()
                    top_frame = True
                    f = frame
                    while f is not None:
                        code = f.f_code
                        key = (code.co_filename, f.f_lineno, code.co_name)
                        entry = agg[key]
                        if top_frame:
                            entry[0] += 1
                            top_frame = False
                        # Recursive frames count once per sample in
                        # cumulative (or a self-recursive function would
                        # exceed 100%).
                        ckey = (code.co_filename, code.co_name)
                        if ckey not in seen:
                            seen.add(ckey)
                            entry[1] += 1
                        f = f.f_back

    def report(self, top: int = 30) -> dict:
        """Top frames by cumulative hits (the 'where is Python CPU time
        going' answer; self hits separate leaf cost from callers).
        Percentages are per SAMPLE, summed across threads — a frame
        shared by k concurrently-running threads reads up to k*100%
        (same convention as py-spy's aggregate view)."""
        with self._lock:
            n = self._samples
            items = sorted(
                self._frames.items(), key=lambda kv: -kv[1][1]
            )[: max(1, top)]
            out = []
            for (fname, line, func), (self_h, cum_h) in items:
                out.append(
                    {
                        "function": func,
                        "file": fname,
                        "line": line,
                        "self_pct": round(100.0 * self_h / n, 2) if n else 0.0,
                        "cum_pct": round(100.0 * cum_h / n, 2) if n else 0.0,
                        "self_samples": self_h,
                        "cum_samples": cum_h,
                    }
                )
            roles = sorted(
                (
                    {
                        "role": role,
                        "samples": hits,
                        # Per-sample percentage like the frame table: k
                        # busy threads of one role read up to k*100%.
                        "pct": round(100.0 * hits / n, 2) if n else 0.0,
                    }
                    for role, hits in self._role_samples.items()
                ),
                key=lambda r: -r["samples"],
            )
            return {
                "samples": n,
                "interval_s": self.interval,
                "duration_s": round(self._elapsed, 3),
                "roles": roles,
                "frames": out,
            }
