"""Vendor-neutral tracing seam (reference tracing/tracing.go:22-50).

A global Tracer with start_span(); spans carry cross-node context via HTTP
headers (inject/extract), exactly the reference's shape. The default
in-memory tracer records recent spans for /debug inspection and is
indexable by trace id (spans_for), which is what lets the coordinator's
/debug/traces/<trace_id> fan out to every node's /internal/traces/<id>
and assemble one cross-node tree.
"""

from __future__ import annotations

import threading
import time
import random
from typing import Optional

from pilosa_tpu_torch.utils.stats import global_stats


class Span:
    def __init__(self, tracer: "Tracer", name: str, trace_id: str, parent_id: Optional[str]):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        # getrandbits is ~5x cheaper than uuid4 and spans are minted on
        # every request; ids only need uniqueness within a trace window.
        self.span_id = f"{random.getrandbits(64):016x}"
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        # Wall-clock start: perf_counter is monotonic but node-local with
        # an arbitrary epoch — cross-node trace assembly needs a shared
        # timescale to order spans from different machines (and to report
        # the observed clock skew when a child appears to start before
        # its remote parent).
        self.start = time.time()  # lint: allow-monotonic-time(cross-node span ordering needs a shared epoch; skew is measured, not assumed)
        self.tags: dict = {}
        self.duration = None

    def set_tag(self, k, v) -> "Span":
        # lint: allow-shared-state(a Span is confined to the thread that opened it until finish; scatter-gather legs tag their own per-leg child spans)
        self.tags[k] = v
        return self

    def finish(self) -> None:
        self.duration = time.perf_counter() - self.t0
        self.tracer._record(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()

    def inject_headers(self) -> dict[str, str]:
        """Cross-node propagation (reference tracing.go:36-40)."""
        return {"X-Trace-Id": self.trace_id, "X-Span-Id": self.span_id}


def _span_json(s: Span) -> dict:
    return {
        "name": s.name,
        "traceID": s.trace_id,
        "spanID": s.span_id,
        "parentID": s.parent_id,
        "start": s.start,
        "duration": s.duration,
        "tags": s.tags,
    }


class Tracer:
    """In-memory ring of recent spans, indexed by trace id."""

    #: Per-thread span-stack depth cap. A span abandoned without
    #: finish() (an exception path that bypassed the context manager)
    #: would otherwise sit on _local.stack forever and silently
    #: re-parent every later span on that thread; past the cap the
    #: OLDEST stack entry is force-popped and counted dropped.
    MAX_STACK_DEPTH = 64

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._spans: list[Span] = []
        # trace id -> recorded spans, maintained alongside the ring so
        # /internal/traces/<id> is a dict hit, not a ring scan.
        self._by_trace: dict[str, list[Span]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def active_span(self) -> Optional[Span]:
        """Innermost unfinished span on this thread, if any — the context
        the internal client injects into peer RPC headers."""
        stack = self._stack()
        return stack[-1] if stack else None

    def start_span(self, name: str, headers: Optional[dict] = None) -> Span:
        trace_id = None
        parent_id = None
        if headers:
            trace_id = headers.get("X-Trace-Id")
            parent_id = headers.get("X-Span-Id")
        stack = self._stack()
        if trace_id is None and stack:
            trace_id = stack[-1].trace_id
            parent_id = stack[-1].span_id
        if trace_id is None:
            trace_id = f"{random.getrandbits(128):032x}"
        span = Span(self, name, trace_id, parent_id)
        # Leak guard: entries piling up on an over-deep stack are
        # abandoned spans (legitimate nesting never approaches the cap).
        # Force-pop the oldest entry ABOVE the bottom: stack[0] is the
        # request's live root span — evicting it would orphan _record's
        # `del stack[i:]` cleanup when the root finishes and make the
        # leak permanent; the entries above it are the pile-up.
        while len(stack) >= self.MAX_STACK_DEPTH:
            stack.pop(1 if len(stack) > 1 else 0)
            global_stats.count("trace_spans_dropped_total")
        stack.append(span)
        return span

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            self._by_trace.setdefault(span.trace_id, []).append(span)
            if len(self._spans) > self.capacity:
                cut = self._spans[: self.capacity // 2]
                del self._spans[: self.capacity // 2]
                for old in cut:
                    bucket = self._by_trace.get(old.trace_id)
                    if bucket is not None:
                        try:
                            bucket.remove(old)
                        except ValueError:
                            pass
                        if not bucket:
                            del self._by_trace[old.trace_id]
        # Pop back to the parent so sibling spans keep the trace context.
        # Anything ABOVE the finishing span is an abandoned child (its
        # finish() never ran); leaving those on the stack would re-parent
        # the next span on this thread — drop them and count it.
        stack = self._stack()
        if span in stack:
            i = stack.index(span)
            abandoned = len(stack) - i - 1
            del stack[i:]
            if abandoned:
                global_stats.count("trace_spans_dropped_total", abandoned)

    def recent(self, n: int = 50) -> list[dict]:
        with self._lock:
            spans = self._spans[-n:]
        return [_span_json(s) for s in spans]

    def spans_for(self, trace_id: str) -> list[dict]:
        """Every recorded span of one trace still in the ring — the
        node-local half of distributed trace assembly (served at
        /internal/traces/<trace_id>)."""
        with self._lock:
            spans = list(self._by_trace.get(trace_id, ()))
        return [_span_json(s) for s in spans]


class NopTracer:
    class _NopSpan:
        def set_tag(self, k, v):
            return self

        def finish(self):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def inject_headers(self):
            return {}

    def start_span(self, name: str, headers=None):
        return self._NopSpan()

    def active_span(self):
        return None

    def recent(self, n: int = 50):
        return []

    def spans_for(self, trace_id: str):
        return []


global_tracer = Tracer()


def _current_trace_id() -> Optional[str]:
    """The active thread's trace id, if a span is open — the exemplar
    hook stats.timing() consults so a histogram bucket can remember
    which trace put an observation there. Registered as a provider
    (stats cannot import tracing: tracing imports stats)."""
    span = global_tracer.active_span()
    return span.trace_id if span is not None else None


from pilosa_tpu_torch.utils import stats as _stats  # noqa: E402

_stats.set_exemplar_provider(_current_trace_id)
