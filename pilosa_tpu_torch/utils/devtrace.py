"""Device traces of a running server: the port's counterpart of
``jax.profiler.start_server`` and ``jax.profiler.TraceAnnotation``.

The JAX server (``pilosa_tpu/cli.py``, ``profile.port``) starts JAX's
attachable profiler service, and its backend wraps each request's device
work in a ``pilosa.<name>`` annotation, so a trace names the work of every
request. torch has no attachable trace service, and ``torch.profiler``
records host ranges only on the thread that started it, while the server
answers each connection on a thread of its own. So the ranges are recorded
here, by the port itself, and merged into the profiler's trace:

- :func:`trace_range` is the annotation. With no trace live it costs one
  read of a module global; with one live it records (name, native thread
  id, start ns, end ns) into that trace's buffer, up to its cap, counting
  what the cap drops.
- :func:`trace_window` runs one window: ``torch.profiler`` over the card
  (CUPTI records the kernels and launch calls of every thread of the
  process) and the host, the ranges live for ``seconds``, the card
  synchronised before the profiler stops, and the ranges written into the
  exported Chrome trace as complete events on their threads' ids, aligned
  to the trace's clock by an anchor range the window opens on its own
  thread. A window on the card in which ``device_launches_total`` moved
  but that holds no kernel raises :class:`TraceIncomplete`: it is never
  answered with a trace of the host alone.
- :class:`DeviceTraceServer` serves ``GET /trace?seconds=S`` on its own
  port (``profile.port`` of ``cli server``), one window at a time in the
  process (a second concurrent request is answered 409), the window
  clamped to [0.1, 60] s as ``/debug/pprof/profile`` clamps it.

Usage, against a server started with ``[profile] port = 6060``::

    curl -o trace.json 'http://127.0.0.1:6060/trace?seconds=2'

and open ``trace.json`` in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, Optional, Sequence

from pilosa_tpu_torch.utils.threads import register_current, spawn, unregister_current

#: Ranges a window keeps; past it ranges are counted, not kept.
MAX_RANGES = 1_000_000
#: The window's bounds in seconds (those of /debug/pprof/profile).
DEFAULT_SECONDS = 2.0
MIN_SECONDS = 0.1
MAX_SECONDS = 60.0
#: The name of the window's clock anchors in the trace.
ANCHOR = "pilosa.trace_anchor"

#: One profiler session in the process at a time: Kineto's activity
#: profiler is one per process.
_GUARD = threading.Lock()
#: The live recorder, or None. trace_range's only cost with no trace live
#: is the read of this name.
_LIVE: Optional["_Recorder"] = None
#: The thread every window of the process runs on (_session).
_SESSION: Optional[ThreadPoolExecutor] = None
_SESSION_LOCK = threading.Lock()


class TraceBusy(RuntimeError):
    """Another trace or profiler session is live in this process."""


class TraceIncomplete(RuntimeError):
    """The card launched kernels in the window, and the trace holds none."""


class _Recorder:
    """One window's ranges: (name, native thread id, start ns, end ns,
    pthread id) on the perf_counter clock, at most `cap` of them;
    `dropped` counts the rest. A range that ends after the window closed
    is not the window's."""

    def __init__(self, cap: int = MAX_RANGES):
        self.cap = cap
        self.ranges: list[tuple] = []
        self.dropped = 0
        self.closed = False
        self._lock = threading.Lock()

    def add(self, item: tuple) -> None:
        with self._lock:
            if self.closed:
                return
            if len(self.ranges) < self.cap:
                self.ranges.append(item)
            else:
                self.dropped += 1


class _Range:
    __slots__ = ("rec", "name", "t0")

    def __init__(self, rec: _Recorder, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.rec.add((self.name, threading.get_native_id(), self.t0,
                      time.perf_counter_ns(), threading.get_ident()))


_NO_RANGE = contextlib.nullcontext()


def trace_range(name: str, detail=None):
    """A context manager around one range of device work, named ``name``
    (``name + str(detail)`` where detail is given, so that a call site
    builds no string while no trace is live)."""
    rec = _LIVE
    if rec is None:
        return _NO_RANGE
    return _Range(rec, name if detail is None else f"{name}{detail}")


@contextlib.contextmanager
def exclusive(blocking: bool = True) -> Iterator[None]:
    """Hold the process's one profiler session for the body. Other
    torch.profiler users of the process take it too, so that no two
    sessions overlap. Raises TraceBusy when not blocking and it is held."""
    if not _GUARD.acquire(blocking=blocking):
        raise TraceBusy("a device trace is already running in this process")
    try:
        yield
    finally:
        _GUARD.release()


@contextlib.contextmanager
def _live(rec: _Recorder) -> Iterator[_Recorder]:
    global _LIVE
    _LIVE = rec
    try:
        yield rec
    finally:
        _LIVE = None
        with rec._lock:
            rec.closed = True


@contextlib.contextmanager
def recording(max_ranges: int = MAX_RANGES) -> Iterator[_Recorder]:
    """Record the process's ranges for the body, without a profiler: the
    recorder's ``ranges`` after it. Raises TraceBusy while a trace is live."""
    with exclusive(blocking=False), _live(_Recorder(max_ranges)) as rec:
        yield rec


def clamp_seconds(raw: Optional[str]) -> float:
    """The window of a ?seconds= value: DEFAULT_SECONDS when absent,
    clamped to [MIN_SECONDS, MAX_SECONDS]. Raises ValueError when it is not
    a number."""
    seconds = DEFAULT_SECONDS if raw is None else float(raw)
    if seconds != seconds:  # NaN passes float() and every comparison
        raise ValueError(raw)
    return min(max(seconds, MIN_SECONDS), MAX_SECONDS)


def _launches_total() -> float:
    from pilosa_tpu_torch.utils.stats import global_stats

    return sum(global_stats.counter_totals("device_launches_total").values())


def _anchor_offset_ns(events: list, brackets: list) -> int:
    """trace clock ns minus perf_counter ns. Each anchor range's start was
    stamped by the profiler between the two perf_counter reads of its
    bracket; the tightest bracket's midpoint is taken."""
    starts = [e["ts"] for e in events if e.get("name") == ANCHOR and e.get("ph") == "X"]
    if len(starts) != len(brackets):
        raise RuntimeError(f"the trace holds {len(starts)} of {len(brackets)} clock anchors")
    starts.sort()
    _, ts, (a, b) = min((b - a, ts, (a, b)) for ts, (a, b) in zip(starts, brackets))
    return round(ts * 1e3) - (a + b) // 2


def _thread_aliases(rec: _Recorder) -> dict:
    """Kineto's id of a thread -> its native id. Kineto names the thread of
    a runtime call by the low 32 bits of its pthread id
    (threading.get_ident()) as an int32, written out as its absolute value
    (NVIDIA H100, torch 2.11), and turns it into the native id only for a
    thread it registered (one that ran a profiler). Known: the threads
    alive now and those that recorded a range in the window (a pthread id
    reused within one window maps to the later thread)."""
    out = {}
    pairs = [(t.ident, t.native_id) for t in threading.enumerate() if t.ident is not None]
    pairs += [(r[4], r[1]) for r in rec.ranges]
    for ident, native in pairs:
        low = ident & 0xFFFFFFFF
        signed = low - (1 << 32) if low >= 1 << 31 else low
        out[low] = out[signed] = out[abs(signed)] = native
    return out


def trace_window(seconds: float, devices: Sequence = ("cpu",),
                 max_ranges: int = MAX_RANGES) -> dict:
    """One trace window of `seconds` over the process: the Chrome trace as
    a dict, the window's ranges merged in, and its summary under
    ``pilosaTrace`` (ranges kept and dropped, device launches counted in
    the window, kernels in the trace). `devices` are the cards (or "cpu")
    the server's backend runs on: CUDA activity is traced where one is a
    card, and each card is synchronised before the profiler stops.

    The window runs on the process's session thread (_session), the
    caller waiting. Raises TraceBusy while another window is live, and
    TraceIncomplete when the backend launched kernels and the trace holds
    none."""
    with exclusive(blocking=False):
        return _session().submit(_trace_window, seconds, devices, max_ranges).result()


def _session() -> ThreadPoolExecutor:
    """The one thread, of role ``device-trace``, that runs every window of
    the process, and lives as long as the process: Kineto keeps the native
    id of each thread that ran a profiler, keyed by its pthread id, and
    names any later thread with that pthread id by it, so a profiler
    thread that exited would lend its id to the next thread reusing its
    pthread id."""
    global _SESSION
    with _SESSION_LOCK:
        if _SESSION is None:
            _SESSION = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="device-trace-session",
                initializer=register_current, initargs=("device-trace",))
        return _SESSION


def _trace_window(seconds: float, devices: Sequence, max_ranges: int) -> dict:
    """trace_window on the session thread, the guard held."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cards = [torch.device(d) for d in devices if torch.device(d).type == "cuda"]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
    rec = _Recorder(max_ranges)
    brackets = []
    with profile(activities=activities) as prof:
        for _ in range(3):
            a = time.perf_counter_ns()
            with record_function(ANCHOR):
                brackets.append((a, time.perf_counter_ns()))
        launches0 = _launches_total()
        t0 = time.perf_counter()
        with _live(rec):
            time.sleep(seconds)
        window = time.perf_counter() - t0
        for card in cards:
            torch.cuda.synchronize(card)
        launches = _launches_total() - launches0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="pilosa-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = trace.setdefault("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if cards and launches and not kernels:
        raise TraceIncomplete(
            f"{int(launches)} device launches in the window and no kernel in the "
            "trace: the profiler recorded no device activity")
    offset = _anchor_offset_ns(events, brackets)
    pid = os.getpid()
    aliases = _thread_aliases(rec)
    for e in events:
        if e.get("pid") == pid and e.get("tid") in aliases:
            e["tid"] = aliases[e["tid"]]
    named = {e.get("tid") for e in events if e.get("name") == "thread_name"}
    names = {t.native_id: t.name for t in threading.enumerate()}
    for tid in sorted({r[1] for r in rec.ranges} - named):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": names.get(tid, f"thread {tid}")}})
    for name, tid, start, end, _ in rec.ranges:
        events.append({"ph": "X", "cat": "pilosa", "name": name, "pid": pid, "tid": tid,
                       "ts": (start + offset) / 1e3, "dur": (end - start) / 1e3})
    trace["pilosaTrace"] = {
        "seconds": window,
        "devices": [str(d) for d in devices],
        "ranges": len(rec.ranges),
        "rangesDropped": rec.dropped,
        "deviceLaunches": int(launches),
        "deviceKernels": kernels,
    }
    return trace


#: The host calls that launch a kernel, as CUPTI names them in a trace.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def range_kernels(trace: dict, name: str) -> list:
    """[(range event, its launch calls, their kernels)] for each range
    called `name` in a trace_window trace: the kernel-launch calls CUPTI
    recorded on the range's thread that lie inside it, and the kernels
    those calls launched (by correlation id)."""
    events = trace["traceEvents"]
    kernels = {e["args"].get("correlation"): e for e in events
               if e.get("cat") == "kernel" and "args" in e}
    calls: dict = {}
    for e in events:
        if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name", "").startswith(LAUNCH_CALLS)):
            calls.setdefault(e["tid"], []).append(e)
    starts = {}
    for tid, evs in calls.items():
        evs.sort(key=lambda e: e["ts"])
        starts[tid] = [e["ts"] for e in evs]
    out = []
    for r in events:
        if r.get("cat") != "pilosa" or r.get("name") != name:
            continue
        evs = calls.get(r["tid"], [])
        lo = bisect.bisect_left(starts.get(r["tid"], []), r["ts"])
        end = r["ts"] + r["dur"]
        inside = []
        for e in evs[lo:]:
            if e["ts"] > end:
                break
            if e["ts"] + e.get("dur", 0) <= end:
                inside.append(e)
        launched = [kernels[c] for c in (e.get("args", {}).get("correlation") for e in inside)
                    if c in kernels]
        out.append((r, inside, launched))
    return out


class _Handler(BaseHTTPRequestHandler):
    server: "_HTTPServer"

    def handle(self):
        register_current("device-trace")
        try:
            super().handle()
        finally:
            unregister_current()

    def log_message(self, format, *args):  # noqa: A002 — the stdlib's name
        pass

    def _reply(self, status: int, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status: int, msg: str) -> None:
        self._reply(status, json.dumps({"error": msg}).encode())

    def do_GET(self):
        url = urllib.parse.urlsplit(self.path)
        if url.path != "/trace":
            self._error(404, f"no route {url.path}: GET /trace?seconds=S")
            return
        raw = urllib.parse.parse_qs(url.query).get("seconds", [None])[-1]
        try:
            seconds = clamp_seconds(raw)
        except ValueError:
            self._error(400, f"invalid seconds: {raw!r}")
            return
        try:
            trace = trace_window(seconds, self.server.devices)
        except TraceBusy as e:
            self._error(409, str(e))
            return
        except TraceIncomplete as e:
            self._error(500, str(e))
            return
        self._reply(200, json.dumps(trace).encode())


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    devices: Sequence


class DeviceTraceServer:
    """``GET /trace?seconds=S`` on (host, port): one trace_window over
    `devices` (the backend's device, or the cards of its mesh), answered as Chrome trace
    JSON; 400 for a non-numeric window, 409 while another is live, 500 for
    a window whose kernels the profiler lost. Binds on construction (an
    OSError where the port is taken) and serves on a thread of role
    ``device-trace``; each window runs on the process's session thread
    (see trace_window). stop() closes the listener."""

    def __init__(self, host: str, port: int, devices: Sequence = ("cpu",)):
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.devices = tuple(devices)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = spawn("device-trace", self._httpd.serve_forever)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)
