"""HTTP layer: the reference's public route table on stdlib http.server.

Routes mirror reference http/handler.go:274-330 (public + /internal peer
endpoints). JSON in/out like the reference's handler; import endpoints
accept the protobuf wire format (Content-Type application/x-protobuf,
reference http/handler.go handlePostImport) and JSON for convenience.
"""

from __future__ import annotations

import json
import re
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.utils import fastjson, threads
from pilosa_tpu_torch.utils.qprofile import (
    ExplainPlan,
    cache_state,
    profile_scope,
)
from pilosa_tpu_torch.utils.stats import global_stats
from pilosa_tpu_torch.server.api import API, APIError
from pilosa_tpu_torch.server.connplane import current_entry, global_conn_plane
from pilosa_tpu_torch.server.wire import (
    ImportRequest,
    ImportRoaringRequest,
    ImportValueRequest,
    QueryRequest,
)

#: (method, compiled pattern, handler name, raw pattern) — the raw
#: pattern string rides along so GET /debug can render the catalogue.
_ROUTES: list[tuple[str, re.Pattern, str, str]] = []

#: RFC 7230 §3.2.6 token — the only charset a header field-name may use.
#: Validated with fullmatch so embedded whitespace, bare CR, or any other
#: separator/control char in the name is a 400, not a silent normalize.
_TOKEN_RE = re.compile(r"[!#$%&'*+\-.^_`|~0-9A-Za-z]+")

_PPROF = None
_PPROF_LOCK = threading.Lock()

#: Process start, for /debug/vars uptime — monotonic: uptime is a
#: duration, an NTP step must not dent it (lint: monotonic-time).
_START_TIME = time.monotonic()

#: Per-second cache of the RFC 7231 Date header value: rendering it
#: (email.utils.formatdate) costs more than assembling the rest of a
#: small response. Immutable (second, bytes) tuple swap — safe under
#: concurrent handler threads.
_DATE_CACHE: tuple[int, bytes] = (0, b"")


def _http_date() -> bytes:
    """Current Date header value, re-rendered at most once per second.
    Wall clock by protocol: Date is a calendar timestamp peers compare
    against their own clocks, never a duration."""
    global _DATE_CACHE
    now = int(time.time())  # lint: allow-monotonic-time(HTTP Date header is a wall-clock calendar stamp by RFC 7231)
    sec, rendered = _DATE_CACHE
    if sec != now:
        from email.utils import formatdate

        rendered = formatdate(now, usegmt=True).encode("latin-1")
        _DATE_CACHE = (now, rendered)
    return rendered


class _HTTPServer(ThreadingHTTPServer):
    """socketserver's default listen backlog is 5: under the bench's 16
    keep-alive clients plus a churn writer, a burst of reconnects (or a
    thread-scheduling stall on a one-core host) overflows it and the
    kernel RSTs the excess SYNs — the mid-window ConnectionResetError
    that zeroed a benchmark run. 128 matches the half of
    net.core.somaxconn actually honored everywhere."""

    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        # Single-slot carry from get_request to process_request: the
        # listener thread runs one accept to completion (get_request →
        # verify_request → process_request, all sequential) before the
        # next, so no fd-keyed map is needed.
        self._pending_entry = None
        # Request-finalization barrier: the reply
        # bytes reach a same-process client one GIL slice BEFORE the
        # handler thread finishes its post-reply work (end_query,
        # profile-ring insert, span finish). Tests that read that state
        # right after a response used to poll for it; quiesce() waits
        # for it deterministically. _active counts requests from
        # dispatch entry to the END of all finalization.
        self._active_cv = threading.Condition()
        self._active = 0
        super().__init__(*args, **kwargs)

    def _request_begin(self) -> None:
        with self._active_cv:
            self._active += 1

    def _request_end(self) -> None:
        with self._active_cv:
            self._active -= 1
            if self._active <= 0:
                self._active_cv.notify_all()

    def quiesce(self, timeout: float = 5.0) -> bool:
        """Block until every request that has entered dispatch is fully
        finalized (reply sent AND post-reply bookkeeping done). True on
        drained, False on timeout. New requests arriving while waiting
        extend the wait — call from a client that has stopped sending."""
        deadline = time.monotonic() + timeout
        with self._active_cv:
            while self._active > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                # lint: allow-lock-discipline(canonical Condition.wait: it RELEASES the condition lock while blocked, handlers never stall on it)
                self._active_cv.wait(remaining)
        return True

    def get_request(self):
        """Accept + ledger registration in one breath: the
        timestamp the entry carries out of here is the origin of the
        http_queue_wait_seconds histogram — the accept-to-handler
        thread-dispatch delay the C10k front-door rewrite must
        collapse. Runs on the listener thread."""
        request, client_address = super().get_request()
        self._pending_entry = global_conn_plane.register(client_address)
        return request, client_address

    def process_request(self, request, client_address):
        """ThreadingMixIn.process_request with two changes:
        the worker starts through utils/threads.spawn — named
        http-worker-N and role-registered for the profiler,
        /debug/threads, and stall exemplars — and it runs _conn_worker,
        which binds the accept-stamped ledger entry to the worker
        before any request byte is read."""
        entry = self._pending_entry
        self._pending_entry = None
        if self.block_on_close:
            import socketserver

            vars(self).setdefault("_threads", socketserver._Threads())
        t = threads.spawn(
            "http-worker", self._conn_worker,
            args=(request, client_address, entry),
            daemon=self.daemon_threads, start=False,
        )
        self._threads.append(t)
        t.start()

    def _conn_worker(self, request, client_address, entry) -> None:
        """One connection's worker-thread body: bind the ledger entry
        (observing the queue wait), run the stock socketserver
        per-connection loop, close the entry on the way out — error
        paths included, so aborted connections still land in the
        recently-closed ring."""
        if entry is not None:
            global_conn_plane.enter(entry)
        try:
            self.process_request_thread(request, client_address)
        finally:
            if entry is not None:
                global_conn_plane.close_entry(entry)

    def server_activate(self):
        super().server_activate()
        # The kernel-truth poller matches LISTEN rows in /proc/net/tcp
        # by local port; registered here, where listen() just happened.
        global_conn_plane.register_listener(self.server_address[1])

    def server_close(self):
        try:
            global_conn_plane.unregister_listener(self.server_address[1])
        finally:
            super().server_close()

    def handle_error(self, request, client_address):
        """A client that vanishes mid-exchange can surface OUTSIDE the
        route dispatcher's abort trap (e.g. send_error during request
        parsing hitting a reset socket): count it on the same
        http_connection_aborts_total the dispatcher uses instead of
        letting socketserver spray a traceback on stderr. Anything
        that is not a connection-teardown race keeps the default noisy
        behavior — real bugs must stay loud."""
        import sys as _sys

        exc = _sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError)):
            from pilosa_tpu_torch.utils.stats import global_stats

            global_stats.count("http_connection_aborts_total")
            return
        super().handle_error(request, client_address)


def _profiler():
    """Process-wide sampling profiler behind /debug/pprof/* (one server
    process = one profiler; concurrent sessions 409). Locked: two racing
    first requests must not each construct (and orphan) a sampler."""
    global _PPROF
    with _PPROF_LOCK:
        if _PPROF is None:
            from pilosa_tpu_torch.utils.profiler import SamplingProfiler

            _PPROF = SamplingProfiler()
        return _PPROF


def _retag_prometheus(text: str, node_id: str) -> list[str]:
    """Re-tag one node's prometheus exposition with node=<id> as the
    FIRST label (federation semantics: every series in /metrics/cluster
    is attributable to its origin; series that already carry labels keep
    them). A pre-existing node= label (e.g. a member's own
    cluster_scrape_failures_total{node=...}) is renamed exported_node=
    — duplicate label names are illegal in the exposition format and
    would make Prometheus reject the whole federated scrape. Comment/
    blank lines are dropped — the merged pane re-groups series anyway.
    A histogram bucket's trailing `# {trace_id=...}` exemplar is split
    off before the value parse and re-appended after the retag."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        line, _, exemplar = line.partition(" # ")
        series, sep, value = line.rpartition(" ")
        if not sep:
            continue
        brace = series.find("{")
        if brace < 0:
            series = f'{series}{{node="{node_id}"}}'
        else:
            tags = series[brace + 1 :]
            # Anchored at a label-name start: a bare substring replace
            # would also mangle exported_node= on double federation.
            tags = re.sub(r'(^|,)node="', r'\1exported_node="', tags)
            series = series[: brace + 1] + f'node="{node_id}",' + tags
        suffix = f" # {exemplar}" if exemplar else ""
        out.append(f"{series} {value}{suffix}")
    return out


_HIST_LINE_RE = re.compile(
    r"^(pilosa_[A-Za-z0-9_]+)_(bucket|sum|count)\{(.*)\} ([0-9.eE+-]+)$"
)
_LE_TAG_RE = re.compile(r'(?:^|,)le="([^"]+)"')


def _merge_member_histograms(texts: list[str]) -> list[str]:
    """Sum every member's histogram series into true cluster-wide
    distributions, emitted with `node="_cluster"` as the first label
    (next to — never instead of — the per-node re-tagged series).
    Identical static bucket boundaries (utils/stats.py BUCKET_BOUNDS)
    make the cumulative bucket vectors additive per `le`, so the merged
    p99 is the quantile of the POOLED observations — the figure
    averaging per-node p99s can never produce. Only families that emit
    `_bucket` lines merge; a counter that merely ends in _count is
    untouched."""
    buckets: dict[tuple, dict[str, float]] = {}
    sums: dict[tuple, float] = {}
    counts: dict[tuple, float] = {}
    for text in texts:
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            line = line.partition(" # ")[0]  # exemplars don't merge
            m = _HIST_LINE_RE.match(line)
            if m is None:
                continue
            family, kind, tags, value = m.groups()
            try:
                v = float(value)
            except ValueError:
                continue
            if kind == "bucket":
                le = _LE_TAG_RE.search(tags)
                if le is None:
                    continue
                rest = _LE_TAG_RE.sub("", tags).strip(",")
                key = (family, rest)
                buckets.setdefault(key, {})
                buckets[key][le.group(1)] = buckets[key].get(le.group(1), 0.0) + v
            elif kind == "sum":
                sums[(family, tags)] = sums.get((family, tags), 0.0) + v
            else:
                counts[(family, tags)] = counts.get((family, tags), 0.0) + v

    def le_order(le: str) -> float:
        return float("inf") if le == "+Inf" else float(le)

    def fmt(v: float) -> str:
        # Exact, not '%g': a 6-sig-digit render of a 1,234,567-count
        # bucket would round adjacent cumulative buckets independently
        # and break monotonicity (and counter-delta math downstream).
        return str(int(v)) if v == int(v) else repr(v)

    out = []
    for (family, rest), les in sorted(buckets.items()):
        prefix = f'node="_cluster"' + ("," + rest if rest else "")
        for le in sorted(les, key=le_order):
            out.append(
                f'{family}_bucket{{{prefix},le="{le}"}} {fmt(les[le])}'
            )
        for kind, store in (("sum", sums), ("count", counts)):
            if (family, rest) in store:
                out.append(
                    f"{family}_{kind}{{{prefix}}} {fmt(store[(family, rest)])}"
                )
    return out


def route(method: str, pattern: str):
    compiled = re.compile("^" + pattern + "$")

    def deco(fn):
        _ROUTES.append((method, compiled, fn.__name__, pattern))
        return fn

    return deco


class Server:
    """Owns the API + the listening socket (reference server.go Server).

    tls: an ssl.SSLContext (or a server/config.py TLSConfig with
    certificate+key set) wraps the listener — the whole public AND
    internal route table then speaks HTTPS (reference
    server/tlsconfig.go wires one tls.Config into the http.Server)."""

    def __init__(self, api: API, host: str = "localhost", port: int = 10101,
                 tls=None):
        self.api = api
        self.host = host
        self.port = port
        if tls is not None and not hasattr(tls, "wrap_socket"):
            tls = tls.server_context() if tls.enabled else None
        self._tls = tls
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _bind(self) -> None:
        api = self.api

        class Handler(_Handler):
            pass

        Handler.api = api
        self._httpd = _HTTPServer((self.host, self.port), Handler)
        if self._tls is not None:
            self._httpd.socket = self._tls.wrap_socket(
                self._httpd.socket, server_side=True
            )
        self.port = self._httpd.server_address[1]  # resolve port 0
        api.local_host, api.local_port = self.host, self.port
        api.local_scheme = self.scheme

    def open(self) -> "Server":
        self._bind()
        self._thread = threads.spawn(
            "http-listener", self._httpd.serve_forever
        )
        return self

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def quiesce(self, timeout: float = 5.0) -> bool:
        """Wait until every in-flight request is FULLY finalized —
        reply sent and post-reply bookkeeping (end_query, profile-ring
        insert, span finish) done. The test-visible barrier for the
        'server finalizes one GIL slice after the client has the reply
        bytes' race class (PR 10 fixed four tests
        with ad-hoc poll loops instead)."""
        if self._httpd is None:
            return True
        return self._httpd.quiesce(timeout)

    @property
    def scheme(self) -> str:
        return "https" if self._tls is not None else "http"

    @property
    def uri(self) -> str:
        return f"{self.scheme}://{self.host}:{self.port}"

    def serve_forever(self) -> None:
        """Foreground mode for the CLI."""
        self._bind()
        self._httpd.serve_forever()


class _Headers:
    """Case-insensitive header map with the one email.Message method the
    handlers use (.get). The stdlib parses request headers through
    email.feedparser — ~20% of serving CPU at the measured request rate
    — for features (obs-fold continuations, MIME structure) HTTP/1.1
    requests don't need."""

    __slots__ = ("_d", "conflicting_length", "repeated_te")

    def __init__(self):
        self._d: dict[str, str] = {}
        self.conflicting_length = False
        self.repeated_te = False

    def add(self, k: str, v: str) -> None:
        # Repeated headers keep the FIRST value, matching what
        # email.Message.get returned (comma-joining would e.g. make a
        # duplicated Content-Length unparseable downstream). DIFFERING
        # repeated Content-Length values are flagged so parse_request
        # can reject the request (RFC 7230 §3.3.2 — the classic CL.CL
        # request-smuggling vector when proxy and server disagree on
        # which value wins). ANY repeated Transfer-Encoding is flagged:
        # RFC 7230 joins them into a coding list ("chunked, gzip"),
        # so first-wins would decode chunked framing a joining proxy
        # sees differently — the TE.TE variant of the same desync class
        #.
        lk = k.lower()
        prev = self._d.get(lk)
        if prev is None:
            self._d[lk] = v
            return
        if lk == "content-length" and prev != v:
            self.conflicting_length = True
        elif lk == "transfer-encoding":
            self.repeated_te = True

    def get(self, k: str, default=None):
        return self._d.get(k.lower(), default)


class _BadChunked(Exception):
    """Malformed/oversized chunked body: (status, reason) for the error
    reply; the connection always closes (rfile is mid-frame)."""

    def __init__(self, status: int, reason: str):
        super().__init__(reason)
        self.status = status
        self.reason = reason


class _Handler(BaseHTTPRequestHandler):
    api: API  # injected per-server subclass
    protocol_version = "HTTP/1.1"

    def handle_one_request(self):
        """Stdlib handle_one_request with the connection-plane state
        transitions woven in. The keep-alive readline blocks
        until the client's NEXT request — the transition to `reading`
        happens only AFTER it returns, so socket idle time stays
        charged to `queued`/`idle`, never to `reading`. The transition
        to `idle` at the end of a completed request is the cycle
        boundary that flushes the entry's aggregate deltas."""
        conn = current_entry()
        try:
            self.raw_requestline = self.rfile.readline(65537)
            if not self.raw_requestline:
                self.close_connection = True
                return
            conn.transition("reading")
            conn.add_bytes_in(len(self.raw_requestline))
            if len(self.raw_requestline) > 65536:
                self.requestline = ""
                self.request_version = ""
                self.command = ""
                self.send_error(414, "Request-URI Too Long")
                return
            if not self.parse_request():
                return
            conn.request_started()
            mname = "do_" + self.command
            if not hasattr(self, mname):
                self.send_error(501, f"Unsupported method ({self.command!r})")
                return
            getattr(self, mname)()
            self.wfile.flush()
            conn.transition("idle")
        except TimeoutError:
            # A read/write timed out: discard this connection (stdlib
            # semantics, minus its log_error — logging is quiet here).
            self.close_connection = True

    def parse_request(self) -> bool:
        """Minimal HTTP/1.x request parsing (mirrors the stdlib's
        semantics for request line, keep-alive, and Expect handling,
        minus email.feedparser — see _Headers). Obs-fold header
        continuations (deprecated, RFC 7230 §3.2.4) are not supported."""
        self.command = None
        self.request_version = version = self.default_request_version
        self.close_connection = True
        requestline = str(self.raw_requestline, "iso-8859-1").rstrip("\r\n")
        self.requestline = requestline
        words = requestline.split()
        if len(words) == 3:
            command, path, version = words
            if not version.startswith("HTTP/"):
                self.send_error(400, f"Bad request version ({version!r})")
                return False
            try:
                nums = version.split("/", 1)[1].split(".")
                version_number = (int(nums[0]), int(nums[1]))
                if len(nums) != 2:
                    raise ValueError
            except (ValueError, IndexError):
                self.send_error(400, f"Bad request version ({version!r})")
                return False
            if version_number >= (1, 1):
                self.close_connection = False
            if version_number >= (2, 0):
                self.send_error(505, f"Invalid HTTP version ({version!r})")
                return False
            self.request_version = version
        elif len(words) == 2:
            command, path = words
            if command != "GET":
                self.send_error(400, f"Bad HTTP/0.9 request type ({command!r})")
                return False
        elif not words:
            return False
        else:
            self.send_error(400, f"Bad request syntax ({requestline!r})")
            return False
        self.command, self.path = command, path
        headers = _Headers()
        n = 0
        head_bytes = 0  # accumulated locally: no per-line ledger calls
        while True:
            line = self.rfile.readline(65537)
            head_bytes += len(line)
            if len(line) > 65536:
                self.send_error(431, "Header line too long")
                return False
            if line in (b"\r\n", b"\n", b""):
                break
            n += 1
            if n > 100:
                self.send_error(431, "Too many headers")
                return False
            decoded = line.decode("iso-8859-1")
            # Strip ONLY the line terminator: an embedded bare CR must
            # stay visible so it fails validation below (a proxy that
            # treats it as a terminator would see different headers).
            if decoded.endswith("\r\n"):
                decoded = decoded[:-2]
            elif decoded.endswith("\n"):
                decoded = decoded[:-1]
            if decoded[:1] in (" ", "\t"):
                # Obs-fold continuation (RFC 7230 §3.2.4: reject or
                # normalize). Silently dropping it would let a folding
                # front proxy see a different header set than this
                # server — the same proxy-disagreement class as CL.CL.
                self.send_error(400, "Obsolete header folding not supported")
                return False
            if "\r" in decoded:
                self.send_error(400, "Bare CR in header line")
                return False
            k, sep, v = decoded.partition(":")
            if not sep or not _TOKEN_RE.fullmatch(k):
                # No colon, empty name, or any non-token char in the
                # field-name (whitespace before the colon included) —
                # RFC 7230 §3.2.4 requires 400, not a drop-or-normalize.
                self.send_error(400, "Malformed header line")
                return False
            if any(c < " " and c != "\t" or c == "\x7f" for c in v):
                # RFC 7230 §3.2 field-content excludes CTLs; proxies
                # disagree on NUL/VT handling (reject vs truncate) — the
                # same disagreement class as the name checks above.
                self.send_error(400, "Control character in header value")
                return False
            headers.add(k, v.strip())
        self.headers = headers
        # Header block fully read: request-head arrival (`reading`)
        # ends; validation + eager chunked decode account as `parsing`.
        conn = current_entry()
        conn.add_bytes_in(head_bytes)
        conn.transition("parsing")
        if headers.conflicting_length:
            self.send_error(400, "Conflicting Content-Length headers")
            return False
        cl = headers.get("Content-Length")
        if cl is not None and not re.fullmatch(r"[0-9]+", cl.strip()):
            # RFC 7230 §3.3.2: 1*DIGIT only. Letting "abc" or "-5"
            # through to int()/read() in _body() re-opens the keep-alive
            # desync this parser rejects for CL.CL/TE.CL (the later 500
            # would NOT close the connection, so the unread body would
            # be parsed as the next request).
            self.send_error(400, "Invalid Content-Length")
            return False
        self._chunked_body = None
        te = headers.get("Transfer-Encoding")
        if headers.repeated_te:
            self.send_error(400, "Repeated Transfer-Encoding headers")
            return False
        if te is not None:
            # Bounded chunked decoding (the reference's stdlib serves
            # chunked clients). Anything
            # but exactly "chunked" still gets RFC 7230 §3.3.1's 501 +
            # close, and TE alongside Content-Length is the TE.CL
            # smuggling shape: reject, never pick one (§3.3.3).
            if te.strip().lower() != "chunked":
                self.send_error(501, "Transfer-Encoding not supported")
                return False
            if cl is not None:
                self.send_error(
                    400, "Transfer-Encoding with Content-Length"
                )
                return False
        conntype = (headers.get("Connection") or "").lower()
        if conntype == "close":
            self.close_connection = True
        elif conntype == "keep-alive" and self.protocol_version >= "HTTP/1.1":
            # Gate on the SERVER's protocol (stdlib semantics): an
            # HTTP/1.0 client asking keep-alive gets it.
            self.close_connection = False
        expect = (headers.get("Expect") or "").lower()
        if (
            expect == "100-continue"
            and self.protocol_version >= "HTTP/1.1"
            and self.request_version >= "HTTP/1.1"
        ):
            if not self.handle_expect_100():
                return False
        if te is not None:
            # Decode EAGERLY (after the 100-continue handshake so the
            # client has started sending): a route that never reads its
            # body must not leave chunk framing in rfile to be parsed as
            # the next request on the keep-alive connection — the same
            # desync class the old blanket 501 existed to prevent.
            try:
                self._chunked_body = self._read_chunked_body()
                # Decoded size, not wire framing bytes: the ledger's
                # bytes_in answers "how much payload", close enough.
                conn.add_bytes_in(len(self._chunked_body))
            except _BadChunked as e:
                # A malformed/oversized stream leaves rfile mid-frame:
                # the connection cannot be reused.
                self.close_connection = True
                self.send_error(e.status, e.reason)
                return False
        return True

    #: Chunked bodies are size-capped (the Content-Length path bounds
    #: itself by the declared length; chunked frames would otherwise
    #: stream without bound). 64 MiB covers any batch import the API
    #: accepts with wide margin.
    MAX_CHUNKED_BODY = 64 << 20

    def _read_chunked_body(self) -> bytes:
        """RFC 7230 §4.1 chunked-body decoder: size-capped, chunk
        extensions ignored (§4.1.1: a recipient MUST ignore unrecognized
        extensions — stdlib behavior), trailers REJECTED (nothing in
        this API consumes them, and accepting arbitrary trailing headers
        widens the smuggling surface for no capability)."""
        total = 0
        parts = []
        while True:
            line = self.rfile.readline(1026)
            if not line.endswith(b"\n") or len(line) > 1025:
                raise _BadChunked(400, "Invalid chunk size line")
            # BWS before the extension separator is grammar-legal
            # (RFC 7230 §4.1.1 chunk-ext = *( BWS ";" BWS ... )):
            # strip the token itself, not just the line.
            token = line.strip().split(b";", 1)[0].strip()
            if not re.fullmatch(rb"[0-9a-fA-F]{1,16}", token):
                raise _BadChunked(400, "Invalid chunk size")
            size = int(token, 16)
            if size == 0:
                break
            total += size
            if total > self.MAX_CHUNKED_BODY:
                raise _BadChunked(413, "Chunked body too large")
            data = self.rfile.read(size)
            if len(data) != size:
                raise _BadChunked(400, "Truncated chunk")
            if self.rfile.read(2) != b"\r\n":
                raise _BadChunked(400, "Missing chunk terminator")
            parts.append(data)
        line = self.rfile.readline(65537)
        if line not in (b"\r\n", b"\n"):
            raise _BadChunked(400, "Chunked trailers not supported")
        return b"".join(parts)
    # Headers and body go out as separate small writes; without NODELAY
    # Nagle + the peer's delayed ACK stall every keep-alive response by
    # ~40 ms — 10x the whole handling cost.
    disable_nagle_algorithm = True

    # quiet default logging
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    # -- plumbing ----------------------------------------------------------

    def _int_query(self, key: str, default: int) -> int:
        """Integer query param or a structured 400 — garbage in a debug
        URL must not surface as a PANIC 500."""
        raw = self.query.get(key)
        if raw is None:
            return default
        try:
            return int(raw)
        except ValueError:
            raise APIError(f"invalid {key}: {raw!r}") from None

    def _body(self) -> bytes:
        if getattr(self, "_chunked_body", None) is not None:
            return self._chunked_body  # decoded eagerly in parse_request
        length = int(self.headers.get("Content-Length") or 0)
        if not length:
            return b""
        data = self.rfile.read(length)
        current_entry().add_bytes_in(len(data))
        return data

    def _json_body(self) -> dict:
        return self._json_body_from(self._body())

    @staticmethod
    def _json_body_from(raw: bytes) -> dict:
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise APIError(f"invalid JSON body: {e}") from e

    def _reply(self, obj: Any, status: int = 200,
               content_type: str = "application/json",
               headers: Optional[dict] = None) -> None:
        if content_type == "application/json":
            # fastjson.dumps == json.dumps bytes (the generic fallback
            # encoder) — every JSON reply stays on one byte contract.
            data = fastjson.dumps(obj) + b"\n"
        elif isinstance(obj, bytes):
            data = obj
        else:
            data = str(obj).encode()
        self._reply_bytes(
            data, status=status, content_type=content_type, headers=headers
        )

    def _reply_bytes(self, data: bytes, status: int = 200,
                     content_type: str = "application/json",
                     headers: Optional[dict] = None) -> None:
        """Write one complete response — status line, headers, body —
        with a SINGLE wfile.write (one sendall, one TCP segment for
        small responses). The stdlib send_response/send_header path
        buffers headers but still pays a separate body write plus a
        strftime-equivalent Date render per response; this is the
        serialize-phase floor for every reply.
        Semantics match send_response: Server/Date headers included,
        keep-alive framing via Content-Length, request logging elided
        (log_message is a no-op here)."""
        reason = self.responses[status][0] if status in self.responses else ""
        head = (
            f"{self.protocol_version} {status} {reason}\r\n"
            f"Server: {self.version_string()}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(data)}\r\n"
        )
        if headers:
            for k, v in headers.items():
                head += f"{k}: {v}\r\n"
        buf = head.encode("latin-1") + b"Date: " + _http_date() + b"\r\n\r\n"
        global_stats.count("http_response_payload_bytes_total", len(data))
        # `writing` brackets exactly the response send; back to
        # `executing` after — post-reply bookkeeping (span finish,
        # profile-ring insert) is handler work, not socket work.
        conn = current_entry()
        conn.transition("writing")
        self.wfile.write(buf + data)
        conn.add_bytes_out(len(buf) + len(data))
        conn.transition("executing")

    #: Machine-readable fallback `code` per status, so EVERY 4xx/5xx JSON
    #: body out of this layer carries one (the peer
    #: client already parses it, cluster/client.py) even when the raising
    #: site predates structured codes. A site-specific code always wins.
    _CODE_BY_STATUS = {
        400: "bad-request",
        404: "not-found",
        409: "conflict",
        413: "too-large",
        429: "overloaded",
        500: "internal",
        501: "not-implemented",
        502: "bad-gateway",
        503: "unavailable",
        504: "deadline-exceeded",
    }

    def _error(self, msg: str, status: int = 400, code: str = "",
               retry_after: Optional[float] = None) -> None:
        body = {
            "error": msg,
            "code": code or self._CODE_BY_STATUS.get(status, f"http-{status}"),
        }
        # 429/503/504 are retryable-by-contract: tell the client when
        #. 1 s is the breaker/hedge recovery scale;
        # a shed 429 clears as soon as an in-flight query finishes.
        # Callers with a better estimate (the ingest-derate ladder
        # scales backoff with burn persistence) override it.
        headers = (
            {"Retry-After": str(int(max(1, retry_after or 1)))}
            if status in (429, 503, 504)
            else None
        )
        self._reply(body, status=status, headers=headers)

    def _dispatch(self, method: str) -> None:
        # Finalization barrier bracket: entered before any reply byte
        # can be written, left only after ALL post-reply bookkeeping
        # (the finally blocks below included) — Server.quiesce() waits
        # on this.
        begin = getattr(self.server, "_request_begin", None)
        if begin is not None:
            begin()
        try:
            self._dispatch_inner(method)
        finally:
            end = getattr(self.server, "_request_end", None)
            if end is not None:
                end()

    def _dispatch_inner(self, method: str) -> None:
        parsed = urlparse(self.path)
        path = parsed.path
        self.query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        for m, pattern, fn_name, _raw in _ROUTES:
            if m != method:
                continue
            match = pattern.match(path)
            if match:
                # Per-route stats middleware (reference statsValidator,
                # http stats middleware in handler.go, CHANGELOG 1.4).
                from pilosa_tpu_torch.utils.stats import global_stats
                from pilosa_tpu_torch.utils.tracing import global_tracer

                stats = global_stats.with_tags(f"route:{fn_name[7:]}", f"method:{method}")
                stats.count("http_requests_total")
                # self.headers is an email.message.Message: its .get() is
                # case-insensitive, which matters because urllib
                # normalizes injected header casing (X-trace-id).
                span = global_tracer.start_span(
                    f"http.{fn_name}", headers=self.headers
                )
                # Origin node on the span itself: cross-node assembly
                # attributes by this tag, independent of which node's
                # ring served the span to the assembler.
                try:
                    span.set_tag("node", self._local_node_id())
                # lint: allow-except-exception(span node-tagging is best-effort display metadata)
                except Exception:  # noqa: BLE001 — tagging is best-effort
                    pass
                try:
                    with stats.timer("http_request_duration_seconds"):
                        getattr(self, fn_name)(**match.groupdict())
                except APIError as e:
                    stats.count("http_request_errors_total")
                    self._error(
                        str(e), status=e.status, code=getattr(e, "code", "")
                    )
                except (BrokenPipeError, ConnectionResetError):
                    # The client went away mid-response (or reset the
                    # socket under us). Nothing to send back — but count
                    # it: silent aborts are how a benchmark's mid-window
                    # reset went undiagnosed. Close the
                    # connection: a keep-alive loop would read the dead
                    # socket, raise a SECOND reset into handle_error,
                    # and double-count this one abort.
                    stats.count("http_connection_aborts_total")
                    self.close_connection = True
                except Exception as e:  # mirror the reference's panic trap
                    stats.count("http_request_errors_total")
                    self._error(f"PANIC: {e}\n{traceback.format_exc()}", status=500)
                finally:
                    span.finish()
                return
        self._error("not found", status=404)

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")

    # -- public routes (reference http/handler.go:276-304) -----------------

    @route("GET", r"/")
    def handle_home(self):
        """Server banner: the pilosa-tpu version."""
        self._reply({"pilosa-tpu": __version__})

    @route("GET", r"/version")
    def handle_version(self):
        """Server version."""
        self._reply({"version": __version__})

    @route("GET", r"/info")
    def handle_info(self):
        """Host info: shard width, CPU count, memory."""
        self._reply(self.api.info())

    @route("GET", r"/status")
    def handle_status(self):
        """Cluster state, node list, local node id."""
        self._reply(self.api.status())

    @route("GET", r"/schema")
    def handle_get_schema(self):
        """The full index/field schema."""
        self._reply(self.api.schema())

    @route("POST", r"/schema")
    def handle_post_schema(self):
        """Apply a schema document (indexes + fields, idempotent)."""
        self.api.apply_schema(self._json_body())
        self._reply({"success": True})

    @route("GET", r"/index")
    def handle_get_indexes(self):
        self._reply(self.api.schema())

    @route("GET", r"/index/(?P<index>[^/]+)")
    def handle_get_index(self, index):
        idx = self.api.holder.index(index)
        if idx is None:
            self._error(f"index not found: {index}", status=404)
            return
        self._reply({"name": index, "options": idx.options.to_dict()})

    @route("POST", r"/index/(?P<index>[^/]+)/?")
    def handle_post_index(self, index):
        body = self._json_body()
        out = self.api.create_index(index, body.get("options", {}))
        self._reply(out)

    @route("DELETE", r"/index/(?P<index>[^/]+)")
    def handle_delete_index(self, index):
        self.api.delete_index(index)
        self._reply({"success": True})

    @route("POST", r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/?")
    def handle_post_field(self, index, field):
        body = self._json_body()
        out = self.api.create_field(index, field, body.get("options", {}))
        self._reply(out)

    @route("DELETE", r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)")
    def handle_delete_field(self, index, field):
        self.api.delete_field(index, field)
        self._reply({"success": True})

    def _request_deadline(self, use_default: bool = True):
        """The request's Deadline, or None (no budget). Precedence:
        X-Pilosa-Deadline (the internal propagation header — a remote leg
        must inherit the coordinator's remaining budget, never restart a
        full client budget), then ?timeout= (the public knob), then the
        server's query-timeout config default. Import routes pass
        use_default=False: query-timeout is sized for READ SLOs, and
        silently applying it to a long bulk import would 504 a write
        that used to complete — explicit budgets still propagate."""
        from pilosa_tpu_torch.utils.deadline import Deadline

        raw = self.headers.get("X-Pilosa-Deadline")
        if raw is None:
            raw = self.query.get("timeout")
        if raw is not None:
            try:
                return Deadline.parse(raw)
            except ValueError:
                raise APIError(f"invalid timeout: {raw!r}") from None
        if not use_default:
            return None
        default = getattr(self.api, "query_timeout", 0.0)
        return Deadline(default) if default and default > 0 else None

    @route("POST", r"/index/(?P<index>[^/]+)/query")
    def handle_post_query(self, index):
        """Execute PQL against an index (the data-plane read path)."""
        # Admission gate FIRST (ROADMAP item 1 down payment): past the
        # configured in-flight cap the request is shed deliberately —
        # 429 + Retry-After + code=overloaded, counted — instead of
        # queueing until the accept path RSTs under burst. The unread
        # body must still be drained (chunked bodies already were, in
        # parse_request) or the keep-alive connection would parse it as
        # the next request — the desync class this file rejects
        # elsewhere.
        from pilosa_tpu_torch.utils.stats import global_stats

        if not self.api.begin_query():
            global_stats.count("http_requests_shed_total")
            self._body()
            self._error(
                "server overloaded: in-flight query cap reached",
                status=429,
                code="overloaded",
            )
            return
        try:
            # The deadline scope opens HERE — at HTTP receipt, like the
            # query profile — so the budget covers the whole serving path
            # through response serialization.
            from pilosa_tpu_torch.utils.deadline import deadline_scope

            with deadline_scope(self._request_deadline()):
                self._serve_query(index)
        finally:
            self.api.end_query()

    def _serve_query(self, index):
        body = self._body()
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        if ctype == "application/x-protobuf":
            req = QueryRequest.from_bytes(body)
            query = req.query
            shards = req.shards or None
            column_attrs = req.column_attrs
            exclude_row_attrs = req.exclude_row_attrs
            exclude_columns = req.exclude_columns
            remote = req.remote
        else:
            try:
                query = body.decode("utf-8")
            except UnicodeDecodeError as e:
                raise APIError(f"query body is not valid UTF-8: {e}") from e
            shards = None
            if "shards" in self.query:
                shards = [int(s) for s in self.query["shards"].split(",")]
            column_attrs = self.query.get("columnAttrs") == "true"
            exclude_row_attrs = self.query.get("excludeRowAttrs") == "true"
            exclude_columns = self.query.get("excludeColumns") == "true"
            remote = self.query.get("remote") == "true"
        kw = dict(
            shards=shards,
            column_attrs=column_attrs,
            exclude_row_attrs=exclude_row_attrs,
            exclude_columns=exclude_columns,
            remote=remote,
            # Per-query result-cache bypass (docs/administration.md
            # "Result caching"): the always-fresh escape hatch. Shed
            # 429s never reach the executor, so refused queries can
            # neither hit nor populate the cache by construction.
            cache_bypass=(
                (self.headers.get("X-Pilosa-Cache") or "").strip().lower()
                == "bypass"
            ),
        )
        # Content negotiation (reference handler.go: protobuf responses
        # when the client Accepts application/x-protobuf).
        accept = (self.headers.get("Accept") or "").split(";")[0].strip()
        # The query-lifecycle profile opens HERE — at HTTP receipt — so
        # the breakdown covers the whole serving path through response
        # serialization; the executor reuses this profile (nested
        # profile_scope) and adds its phases to the same record.
        # Per-query EXPLAIN opt-in. The plan allocates ONLY
        # here — with the flag off every deep-layer hook is a single
        # `getattr(prof, "explain", None)` check and the serving path
        # is byte-identical to a non-explain request.
        explain = (
            self.query.get("explain") == "1"
            or bool((self.headers.get("X-Pilosa-Explain") or "").strip())
        )
        with profile_scope(
            index=index, query=query if isinstance(query, str) else ""
        ) as prof:
            prof.remote = remote
            if explain:
                prof.explain = ExplainPlan()
            if accept == "application/x-protobuf":
                try:
                    data = self.api.query_proto(index, query, **kw)
                except APIError as e:
                    from pilosa_tpu_torch.server.wire import encode_query_response

                    prof.error = str(e)[:200]
                    self._reply(
                        encode_query_response([], err=str(e)),
                        status=e.status,
                        content_type="application/x-protobuf",
                    )
                    return
                with prof.phase("resp_write"):
                    self._reply(
                        data, content_type="application/x-protobuf",
                        headers=self._query_headers(prof, index, remote),
                    )
                return
            # Zero-copy serving path: the API layer hands
            # back the COMPLETE response body bytes (vectorized
            # fragment encoding; cache hits splice pre-encoded wire
            # bytes), and the reply is one header+body sendall.
            data = self.api.query_bytes(index, query, **kw)
            if prof.explain is not None and data.endswith(b"}\n"):
                # Splice the executed plan into the complete body bytes
                # (the non-explain path never touches the bytes, so the
                # test_fastjson byte-identity pin is undisturbed). The
                # protobuf path above skips body attachment — its wire
                # schema is fixed — but the plan still lands in the
                # /debug/queries ring entry.
                with prof.phase("serialize"):
                    payload = json.dumps(
                        prof.explain.to_dict(), separators=(",", ":")
                    ).encode("utf-8")
                    data = data[:-2] + b',"explain":' + payload + b"}\n"
            # resp_write, not serialize: the body is already encoded
            # (query_bytes' serialize phase), and this write's wall time
            # is dominated by the GIL/scheduler handoff around the send
            # — a queueing signal, not serialization cost (the raw send
            # is ~1 µs; docs/observability.md phase table).
            with prof.phase("resp_write"):
                self._reply_bytes(
                    data, headers=self._query_headers(prof, index, remote)
                )

    def _query_headers(self, prof, index, remote) -> Optional[dict]:
        """Cache marker + (on remote legs) the view-epoch piggyback: a
        peer-issued request's response carries this node's POST-execution
        epochs for the queried index (X-Pilosa-View-Epochs), which is
        how a coordinator's per-peer epoch map advances — a replica
        write routed here invalidates the coordinator's cached fan-outs
        synchronously with its own response.
        Headers stay off non-remote responses: external clients never
        pay the report bytes."""
        headers = self._cache_marker(prof)
        piggyback = self._epoch_piggyback_headers(index, remote)
        if piggyback:
            headers = dict(headers) if headers else {}
            headers.update(piggyback)
        return headers

    def _epoch_piggyback_headers(self, index, remote) -> Optional[dict]:
        """The view-epoch piggyback for any peer-issued WRITE or QUERY
        response (imports included: the freshness contract says writes
        routed through the coordinator invalidate its cached fan-outs
        synchronously with their own response, and an import that
        didn't carry its post-write epochs would leave the coordinator
        serving pre-import answers until the next ~1 s probe fold).
        None on non-remote responses: external clients never pay the
        report bytes."""
        if not remote:
            return None
        try:
            # Memoized on the generation watermark: between writes the
            # encoded report is reused, not re-walked per request.
            encoded = self.api.view_epochs_header(index)
        # lint: allow-except-exception(epoch piggyback is best-effort: its absence only delays cache invalidation to the next probe fold; the query answer itself must still ship)
        except Exception:  # noqa: BLE001 — piggyback is an optimization
            return None
        return {"X-Pilosa-View-Epochs": encoded}

    @staticmethod
    def _cache_marker(prof) -> Optional[dict]:
        """Served-from-cache response marker: X-Pilosa-Cache is `hit`
        when EVERY answer in the request came from the result cache,
        `partial` when some did (misses or uncacheable calls computed
        the rest fresh), `miss` when lookups happened but none hit, and
        `bypass` when the request asked past the cache. Absent entirely
        when no cache is wired or nothing was even looked up."""
        state = cache_state(getattr(prof, "counters", None))
        return {"X-Pilosa-Cache": state} if state else None

    #: On a shed, bodies up to this size are drained to keep the
    #: keep-alive connection framed; larger ones are NOT read (reading
    #: would buffer exactly the bytes the cap refuses) — the connection
    #: closes instead.
    SHED_DRAIN_MAX = 1 << 20

    def _import_request_bytes(self) -> int:
        """The import body size WITHOUT buffering it: the declared
        Content-Length, or the decoded chunked body when parse_request
        already read one. Known carve-out: chunked bodies are decoded
        eagerly at parse time (before the route is known), so they are
        buffered — bounded to MAX_CHUNKED_BODY (64 MiB) each — BEFORE
        the gate sees them; only Content-Length bodies are refused
        entirely unread. Documented in docs/administration.md."""
        if getattr(self, "_chunked_body", None) is not None:
            return len(self._chunked_body)
        return int(self.headers.get("Content-Length") or 0)

    def _shed_import(self, refuse, nbytes: int) -> None:
        """Answer a refused import through the _error funnel (429/503 +
        Retry-After + code) WITHOUT having buffered the body: a small
        unread body is drained to keep the keep-alive connection
        framed; a large one would be the very buffering the cap exists
        to refuse, so the connection closes after the error instead."""
        status, code, reason = refuse[:3]
        # Optional 4th element: a caller-scaled Retry-After (the
        # ingest-derate ladder deepens backoff while the read SLO
        # burns); absent, _error's fixed 1 s applies.
        retry_after = refuse[3] if len(refuse) > 3 else None
        if getattr(self, "_chunked_body", None) is None:
            if nbytes <= self.SHED_DRAIN_MAX:
                self._body()
            else:
                self.close_connection = True
        self._error(
            f"import shed ({reason}): write-side admission cap reached",
            status=status,
            code=code,
            retry_after=retry_after,
        )

    @route("POST", r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import")
    def handle_post_import(self, index, field):
        """Bulk bit/value import (JSON or protobuf wire format)."""
        # Write-side admission FIRST (the mirror of
        # handle_post_query's gate), consulted BEFORE the body is read:
        # gating after buffering would let N concurrent over-cap bodies
        # occupy RAM anyway — the OOM shape the cap refuses. The
        # deadline scope opens like the query path's so fanned-out
        # remote legs inherit the remaining budget via X-Pilosa-Deadline.
        nbytes = self._import_request_bytes()
        refuse = self.api.begin_import(nbytes)
        if refuse is not None:
            self._shed_import(refuse, nbytes)
            return
        try:
            from pilosa_tpu_torch.utils.deadline import deadline_scope

            with deadline_scope(self._request_deadline(use_default=False)):
                self._serve_import(index, field, self._body())
        finally:
            self.api.end_import(nbytes)

    def _serve_import(self, index, field, body):
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        clear = self.query.get("clear") == "true"
        remote = self.query.get("remote") == "true"
        if ctype == "application/x-protobuf":
            # Value import is signaled by the field type on the wire level
            # in the reference client; sniff by field schema.
            idx = self.api.holder.index(index)
            f = idx.field(field) if idx else None
            if f is not None and f.options.type == "int":
                req = ImportValueRequest.from_bytes(body)
                self.api.import_values(
                    index, field, req.column_ids, req.values,
                    column_keys=req.column_keys or None, clear=clear, remote=remote,
                )
            else:
                req = ImportRequest.from_bytes(body)
                self.api.import_bits(
                    index, field, req.row_ids, req.column_ids,
                    row_keys=req.row_keys or None,
                    column_keys=req.column_keys or None,
                    timestamps=req.timestamps or None, clear=clear, remote=remote,
                )
        else:
            payload = self._json_body_from(body)
            if "values" in payload:
                self.api.import_values(
                    index, field,
                    payload.get("columnIDs", []), payload.get("values", []),
                    column_keys=payload.get("columnKeys"), clear=clear, remote=remote,
                )
            else:
                self.api.import_bits(
                    index, field,
                    payload.get("rowIDs", []), payload.get("columnIDs", []),
                    row_keys=payload.get("rowKeys"),
                    column_keys=payload.get("columnKeys"),
                    timestamps=payload.get("timestamps"), clear=clear, remote=remote,
                )
        self._reply(
            {"success": True},
            headers=self._epoch_piggyback_headers(index, remote),
        )

    @route("POST", r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import-roaring/(?P<shard>\d+)")
    def handle_post_import_roaring(self, index, field, shard):
        nbytes = self._import_request_bytes()
        refuse = self.api.begin_import(nbytes)
        if refuse is not None:
            self._shed_import(refuse, nbytes)
            return
        try:
            from pilosa_tpu_torch.utils.deadline import deadline_scope

            with deadline_scope(self._request_deadline(use_default=False)):
                self._serve_import_roaring(index, field, shard, self._body())
        finally:
            self.api.end_import(nbytes)

    def _serve_import_roaring(self, index, field, shard, body):
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        if ctype == "application/x-protobuf":
            req = ImportRoaringRequest.from_bytes(body)
            views = {v.name: v.data for v in req.views}
            clear = req.clear
        else:
            payload = self._json_body_from(body)
            import base64

            views = {
                k: base64.b64decode(v) for k, v in payload.get("views", {}).items()
            }
            clear = bool(payload.get("clear", False))
        remote = self.query.get("remote") == "true"
        self.api.import_roaring(index, field, int(shard), views, clear=clear, remote=remote)
        self._reply(
            {"success": True},
            headers=self._epoch_piggyback_headers(index, remote),
        )

    @route("GET", r"/export")
    def handle_get_export(self):
        index = self.query.get("index", "")
        field = self.query.get("field", "")
        shard = self.query.get("shard")  # absent = whole field, all nodes
        csv = self.api.export_csv(
            index, field, int(shard) if shard is not None else None
        )
        self._reply(csv, content_type="text/csv")

    @route("POST", r"/recalculate-caches")
    def handle_recalculate_caches(self):
        self.api.recalculate_caches()
        self._reply({"success": True})

    def _refresh_device_gauges(self) -> None:
        """Surface device-residency gauges at scrape time (HBM policy) —
        shared by /metrics and the /metrics/cluster local leg so a bare
        server (no RuntimeMonitor poller) still exports fresh values."""
        from pilosa_tpu_torch.utils.monitor import publish_hbm_gauges
        from pilosa_tpu_torch.utils.stats import global_stats

        backend = getattr(self.api.executor, "backend", None)
        blocks = getattr(backend, "blocks", None)
        if blocks is None:
            return
        global_stats.gauge("tpu_resident_bytes", blocks.resident_bytes())
        global_stats.gauge("tpu_stack_evictions", blocks.evictions)
        publish_hbm_gauges(blocks)

    def _exposition_reply(self, text: str) -> None:
        """Serve prometheus exposition, gating exemplars: the
        `# {trace_id=...}` suffix is OpenMetrics syntax and a text-0.0.4
        parser (stock Prometheus without exemplar scraping) reads the
        token after the value as a timestamp and fails the WHOLE scrape.
        Exemplars are kept only when the scraper opts in via
        `?exemplars=1` (the internal federation scrape, curl). The
        content type is always text-0.0.4 — never the OpenMetrics one an
        Accept header may ask for, because this exposition is NOT valid
        OpenMetrics (counter sample names carry the family's `_total`;
        a strict OM parser rejects the whole scrape as a name clash) and
        claiming the type would break exactly the scrapers it courts."""
        if self.query.get("exemplars") not in ("1", "true"):
            text = "\n".join(
                l.partition(" # ")[0] for l in text.splitlines()
            ) + "\n"
        self._reply(text, content_type="text/plain; version=0.0.4")

    @route("GET", r"/metrics")
    def handle_metrics(self):
        """Prometheus exposition of the local stats registry."""
        from pilosa_tpu_torch.utils.stats import global_stats

        if getattr(self.api, "metric_service", "memory") == "none":
            # `[metric] service = "none"`: no exposition endpoint. The
            # registry still accrues in-process (it feeds /debug/vars
            # and the SLO evaluator) — this only closes the scrape
            # surface (config-drift rule: the knob parsed but nothing
            # consumed it).
            self._error("metrics disabled by [metric] service config",
                        status=404, code="metrics-disabled")
            return
        self._refresh_device_gauges()
        self._exposition_reply(global_stats.prometheus_text())

    @route("GET", r"/debug/queries")
    def handle_debug_queries(self):
        """Recent + in-flight queries with per-phase breakdowns (the ring
        behind pilosa_tpu_torch/utils/qprofile.py). ?n bounds the recent list.
        The operator's first stop for 'why is THIS query slow': phases,
        version-walk counters, and errors per query, newest first. The
        `latency` block puts each recent query IN CONTEXT: per-call
        p50/p95/p99/p999 interpolated from the cumulative query_seconds
        histogram — a 40 ms query next to a 4 ms p99 is the outlier, a
        40 ms query next to a 38 ms p99 is the workload."""
        from pilosa_tpu_torch.utils.qprofile import global_query_ring
        from pilosa_tpu_torch.utils.stats import (
            QUANTILE_LABELS,
            bucket_quantile,
            global_stats,
        )

        n = self._int_query("n", 50)
        latency: dict[str, dict] = {}
        for name, ent in global_stats.histogram_snapshot().items():
            m = re.fullmatch(r'query_seconds\{call="([^"]+)"\}', name)
            if m is None:
                continue
            row: dict = {"count": ent["count"]}
            for label, q in QUANTILE_LABELS:
                v = bucket_quantile(ent["buckets"], q)
                row[label + "Ms"] = round(v * 1e3, 3) if v is not None else None
            latency[m.group(1)] = row
        self._reply(
            {
                "inflight": global_query_ring.inflight(),
                "recent": global_query_ring.recent(n),
                "latency": latency,
            }
        )

    @route("GET", r"/debug/slo")
    def handle_debug_slo(self):
        """SLO compliance + multi-window burn rates (utils/monitor.py
        evaluate_slos): per objective, the current windowed quantile vs
        its threshold, the fast-5m/slow-1h burn-rate pair, and trace
        exemplars from over-threshold buckets — each resolvable at
        /debug/traces/<traceID>. Objectives come from the server config
        (`slo = [{metric, quantile, threshold_s, window_s}]`); the
        answer an operator needs is "p99 query latency SLO burning 4x",
        not a page of raw series."""
        from pilosa_tpu_torch.utils.monitor import (
            SLO_FAST_WINDOW,
            SLO_SLOW_WINDOW,
            RuntimeMonitor,
        )

        mon = getattr(self.api, "monitor", None)
        if mon is None:
            # Bare server (no CLI-started poller): a lazily attached,
            # unstarted monitor still accrues windowed snapshots on
            # every /debug/slo scrape, so burn windows fill with use.
            mon = RuntimeMonitor(self.api.holder)
            mon.slo = list(getattr(self.api, "slo", []) or [])
            self.api.monitor = mon
        objectives = mon.slo or list(getattr(self.api, "slo", []) or [])
        self._reply(
            {
                "objectives": mon.evaluate_slos(objectives),
                "fastWindowS": SLO_FAST_WINDOW,
                "slowWindowS": SLO_SLOW_WINDOW,
            }
        )

    @route("GET", r"/debug/vars")
    def handle_debug_vars(self):
        """expvar-style JSON dump of the whole stats registry (reference
        /debug/vars, http/handler.go:307): every counter/gauge/timing
        series by its prometheus series name — the greppable twin of
        /metrics for tooling that wants JSON."""
        from pilosa_tpu_torch.utils.stats import global_stats

        out = {
            "version": __version__,
            "uptimeSeconds": round(time.monotonic() - _START_TIME, 3),
        }
        out.update(global_stats.snapshot())
        self._reply(out)

    @route("GET", r"/debug/traces")
    def handle_debug_traces(self):
        """Recent spans from the in-memory tracer (the reference exposes
        jaeger; an inspection endpoint keeps the seam observable here)."""
        from pilosa_tpu_torch.utils.tracing import global_tracer

        n = self._int_query("n", 50)
        self._reply({"spans": global_tracer.recent(n)})

    @route("GET", r"/debug/pprof/profile")
    def handle_pprof_profile(self):
        """Go-pprof-style CPU profile: sample every
        thread's stack for ?seconds (default 10), return top-N frames by
        cumulative samples. Two HTTP calls max to a hot answer; see
        utils/profiler.py for why sampling, not cProfile. ?seconds is
        hard-capped at 60 and non-numeric input is a 400 — before the
        clamp, `seconds=86400` pinned a handler thread for a day and
        garbage was a PANIC 500."""
        raw = self.query.get("seconds", "10")
        try:
            seconds = float(raw)
        except ValueError:
            raise APIError(f"invalid seconds: {raw!r}") from None
        seconds = min(max(seconds, 0.1), 60.0)
        top = self._int_query("top", 30)
        rep = _profiler().profile(seconds, top)
        if "error" in rep:
            # A manual start/stop session is active: same 409 contract as
            # the sibling endpoints, not a 200 with zero frames.
            self._error(rep["error"], status=409)
            return
        self._reply(rep)

    @route("POST", r"/debug/pprof/start")
    def handle_pprof_start(self):
        """Start a manual CPU-sampling session (409 if one is live)."""
        if _profiler().start():
            self._reply({"profiling": True})
        else:
            self._error("profiler already running", status=409)

    @route("POST", r"/debug/pprof/stop")
    def handle_pprof_stop(self):
        """Stop the manual sampling session, return top frames by role."""
        if not _profiler().running:
            self._error("profiler not running", status=409)
            return
        self._reply(_profiler().stop(self._int_query("top", 30)))

    @route("GET", r"/debug/diagnostics")
    def handle_debug_diagnostics(self):
        """Local diagnostics snapshot (reference diagnostics.go:42-260
        phone-home payload, served to the operator instead — zero
        egress)."""
        from pilosa_tpu_torch.utils.monitor import diagnostics_snapshot

        self._reply(diagnostics_snapshot(self.api.holder))

    # -- cluster observability plane ----------------------------

    def _local_node_id(self) -> str:
        cluster = self.api.cluster
        if cluster is not None:
            return cluster.node_id
        return f"{self.api.local_host}:{self.api.local_port}"

    def _cluster_members(self) -> list[tuple[str, object, bool]]:
        """(node_id, uri, is_local) for every cluster member, local node
        first; a single unclustered server is a one-member cluster."""
        cluster = self.api.cluster
        if cluster is None:
            return [(self._local_node_id(), None, True)]
        local_id = cluster.node_id
        out = [(local_id, None, True)]
        for n in cluster.topology.nodes:
            if n.id != local_id:
                out.append((n.id, n, False))
        return out

    def _scrape_client(self, default_timeout: float = 3.0):
        """Short-timeout client for cluster fan-outs: a downed node must
        read as a scrape failure, not hang the whole pane for the peer
        client's 30 s data-plane timeout. ?timeout= overrides (validated
        and clamped to [0.1, 30] — a garbage or zero timeout must be a
        400 / a working scrape, not a PANIC 500 or all-peers-down)."""
        from pilosa_tpu_torch.cluster.client import InternalClient

        raw = self.query.get("timeout", default_timeout)
        try:
            timeout = float(raw)
        except ValueError:
            raise APIError(f"invalid timeout: {raw!r}") from None
        timeout = min(max(timeout, 0.1), 30.0)
        cluster = self.api.cluster
        ssl_ctx = cluster.client.ssl_context if cluster is not None else None
        return InternalClient(timeout=timeout, ssl_context=ssl_ctx)

    def _fan_out_members(self, local_fn, remote_fn):
        """Scrape every member CONCURRENTLY; returns
        [(node_id, payload | ClientError, seconds)] in member order.
        Sequential scraping would make the pane's latency the SUM of
        per-peer timeouts — with several nodes down it would go dark
        exactly when it is needed; threads bound it at ~one timeout."""
        import concurrent.futures as cf

        from pilosa_tpu_torch.cluster.client import ClientError

        members = self._cluster_members()

        def leg(node_id, uri, is_local):
            t0 = time.perf_counter()
            try:
                out = local_fn() if is_local else remote_fn(uri)
            except ClientError as e:
                out = e
            return node_id, out, time.perf_counter() - t0

        if len(members) == 1:
            return [leg(*members[0])]
        with cf.ThreadPoolExecutor(
            max_workers=min(16, len(members))
        ) as pool:
            return [f.result() for f in
                    [pool.submit(leg, *m) for m in members]]

    @route("GET", r"/debug/traces/(?P<trace_id>[^/]+)")
    def handle_debug_trace_tree(self, trace_id):
        """Distributed trace assembly: fan out to every cluster node's
        /internal/traces/<id>, merge the spans into one parent-linked
        tree with per-node attribution, and note observed wall-clock skew
        — one slow scatter-gather leg becomes directly visible instead of
        dying in each node's local ring."""
        from pilosa_tpu_torch.cluster.client import ClientError
        from pilosa_tpu_torch.utils.stats import global_stats
        from pilosa_tpu_torch.utils.tracing import global_tracer

        client = self._scrape_client()
        spans: list[dict] = []
        by_id: dict[str, dict] = {}
        failures: list[dict] = []
        legs = self._fan_out_members(
            lambda: global_tracer.spans_for(trace_id),
            lambda uri: client.node_traces(uri, trace_id),
        )
        for node_id, got, _dt in legs:
            if isinstance(got, ClientError):
                failures.append({"node": node_id, "error": str(got)})
                global_stats.with_tags(f"node:{node_id}").count(
                    "cluster_scrape_failures_total"
                )
                continue
            for s in got:
                if s["spanID"] in by_id:
                    continue  # another node's ring already held it
                # Origin attribution: a span's own node tag (set at
                # creation by the HTTP dispatcher) beats scrape origin —
                # the two only differ in in-process test clusters, where
                # the rings are shared.
                s["node"] = s.get("tags", {}).get("node", node_id)
                by_id[s["spanID"]] = s
                spans.append(s)
        children: dict[str, list] = {}
        roots = []
        max_skew = 0.0
        for s in spans:
            pid = s.get("parentID")
            parent = by_id.get(pid) if pid else None
            if parent is None:
                # Parent unknown: remote root (parent span still open or
                # aged out of its ring) — keep it as a tree root rather
                # than dropping the subtree.
                roots.append(s)
                continue
            children.setdefault(pid, []).append(s)
            if (
                parent["node"] != s["node"]
                and s.get("start") is not None
                and parent.get("start") is not None
                and s["start"] < parent["start"]
            ):
                # A child cannot start before its parent; on different
                # nodes that reads as wall-clock skew of at least this.
                max_skew = max(max_skew, parent["start"] - s["start"])

        def render(s):
            kids = sorted(
                children.get(s["spanID"], ()), key=lambda c: c.get("start") or 0
            )
            out = dict(s)
            out["children"] = [render(k) for k in kids]
            return out

        roots.sort(key=lambda s: s.get("start") or 0)
        # Attributed node set (spans' own origin), not the scrape list:
        # "which nodes did this trace touch" is the operator question.
        nodes_seen = sorted({s["node"] for s in spans})
        self._reply(
            {
                "traceID": trace_id,
                "nodes": nodes_seen,
                "spanCount": len(spans),
                "clockSkewSecondsMin": round(max_skew, 6),
                "scrapeFailures": failures,
                "tree": [render(r) for r in roots],
            }
        )

    @route("GET", r"/metrics/cluster")
    def handle_metrics_cluster(self):
        """Metrics federation: scrape every node's /metrics, re-tag each
        series with node=<id>, and append per-node scrape health
        (pilosa_cluster_scrape_up / _seconds) — one pane for the whole
        cluster; a downed node is a scrape failure, never a hang."""
        from pilosa_tpu_torch.cluster.client import ClientError
        from pilosa_tpu_torch.utils.stats import global_stats

        client = self._scrape_client()

        def local_text() -> str:
            self._refresh_device_gauges()
            return global_stats.prometheus_text()

        out: list[str] = []
        member_texts: list[str] = []
        for node_id, text, dt in self._fan_out_members(
            local_text, client.metrics_text
        ):
            up = 1
            if isinstance(text, ClientError):
                text = ""
                up = 0
                global_stats.with_tags(f"node:{node_id}").count(
                    "cluster_scrape_failures_total"
                )
            member_texts.append(text)
            out.extend(_retag_prometheus(text, node_id))
            out.append(f'pilosa_cluster_scrape_up{{node="{node_id}"}} {up}')
            out.append(
                f'pilosa_cluster_scrape_seconds{{node="{node_id}"}} {dt:.6f}'
            )
        # Cluster-wide latency distributions: member bucket vectors are
        # additive (shared static boundaries), so the merged series'
        # interpolated quantiles describe the pooled traffic — the
        # statistic no arithmetic on per-node p99 series can recover.
        out.extend(_merge_member_histograms(member_texts))
        self._exposition_reply("\n".join(out) + "\n")

    @route("GET", r"/debug/cluster")
    def handle_debug_cluster(self):
        """/debug/vars federation: every node's expvar-style registry
        dump keyed by node id, with per-node scrape latency/failures —
        the JSON twin of /metrics/cluster."""
        from pilosa_tpu_torch.cluster.client import ClientError
        from pilosa_tpu_torch.utils.stats import global_stats

        client = self._scrape_client()

        def local_vars() -> dict:
            # Same shape handle_debug_vars serves remotely: the local
            # member's entry must not be the one missing version/uptime.
            out = {
                "version": __version__,
                "uptimeSeconds": round(time.monotonic() - _START_TIME, 3),
            }
            out.update(global_stats.snapshot())
            return out

        nodes: dict[str, dict] = {}
        for node_id, got, dt in self._fan_out_members(
            local_vars, client.debug_vars
        ):
            ent: dict = {}
            if isinstance(got, ClientError):
                ent["up"] = False
                ent["error"] = str(got)
                global_stats.with_tags(f"node:{node_id}").count(
                    "cluster_scrape_failures_total"
                )
            else:
                ent["up"] = True
                ent["vars"] = got
            ent["scrapeMs"] = round(dt * 1e3, 3)
            nodes[node_id] = ent
        self._reply({"nodes": nodes})

    @route("GET", r"/debug/hbm")
    def handle_debug_hbm(self):
        """The device HBM ledger: per-entry resident bytes split by
        representation tier (dense / array-container / run-container
        source), upload epoch, access counts — sorted coldest first,
        i.e. the LRU eviction-candidate order. ?top=N truncates to the
        N coldest (0 = all, the default — back-compat with pre-r18
        consumers that expect the full ledger)."""
        backend = getattr(self.api.executor, "backend", None)
        blocks = getattr(backend, "blocks", None)
        if blocks is None or not hasattr(blocks, "ledger"):
            self._reply(
                {"residentBytes": 0, "tierBytes": {}, "evictions": 0,
                 "totalEntries": 0, "entries": []}
            )
            return
        top = self._int_query("top", 0)
        entries = blocks.ledger()
        total = len(entries)
        if top > 0:
            entries = entries[:top]
        self._reply(
            {
                "residentBytes": blocks.resident_bytes(),
                "tierBytes": blocks.tier_bytes(),
                "evictions": blocks.evictions,
                "totalEntries": total,
                "entries": entries,
            }
        )

    @route("GET", r"/debug/heat")
    def handle_debug_heat(self):
        """Block heat + miss-ratio curve: per-entry decayed-
        frequency heat (hottest first, ?top=N, default 50), the per-tier
        heat rollup behind hbm_access_heat{tier}, and the SHARDS reuse-
        distance estimator's predicted hit-rate-vs-HBM-budget curve —
        'would a bigger (or smaller) HBM budget change my hit rate', as
        a curve instead of a guess."""
        backend = getattr(self.api.executor, "backend", None)
        blocks = getattr(backend, "blocks", None)
        if blocks is None or not hasattr(blocks, "heat_snapshot"):
            self._reply(
                {"halfLifeSeconds": 0, "tierHeat": {}, "entries": [],
                 "reuse": None}
            )
            return
        top = self._int_query("top", 50)
        out = blocks.heat_snapshot(entries=top if top > 0 else -1)
        out["reuse"] = blocks.reuse.snapshot()
        self._reply(out)

    @route("GET", r"/debug/timeline")
    def handle_debug_timeline(self):
        """Interference flight recorder: second-by-second
        deltas of qps, ingest rates, per-site lock waits, snapshot
        state, device launches, and HBM residency over the trailing
        ?seconds=N window (default 60), plus pinned incidents (frozen
        automatically when an SLO objective starts burning). Each
        scrape takes a sample first, so a server without the monitor
        poller still accrues a timeline with use."""
        from pilosa_tpu_torch.utils.monitor import global_flight_recorder

        raw = self.query.get("seconds", "60")
        try:
            seconds = min(600.0, max(1.0, float(raw)))
        except ValueError:
            raise APIError(f"invalid seconds: {raw!r}") from None
        global_flight_recorder.sample()
        self._reply(
            {
                "windowS": seconds,
                "timeline": global_flight_recorder.timeline(seconds),
                "incidents": global_flight_recorder.incidents(),
            }
        )

    @route("GET", r"/debug/workload")
    def handle_debug_workload(self):
        """Per-query-shape cost accounting: the top-K table
        of canonical-PQL shape fingerprints by cumulative device-
        seconds — which query SHAPES are spending the device, with
        bytes shipped/returned, lock-wait, and cache hit-rate per
        shape. ?top=N (default 50)."""
        from pilosa_tpu_torch.utils.qprofile import global_workload_table

        top = self._int_query("top", 50)
        self._reply(global_workload_table.snapshot(top))

    @route("GET", r"/debug/rescache")
    def handle_debug_rescache(self):
        """The result-cache ledger (exec/rescache.py): totals plus
        entries sorted coldest-first — the LRU eviction-candidate order,
        mirroring /debug/hbm. {enabled: false} when no cache is wired."""
        rc = getattr(self.api.executor, "rescache", None)
        if rc is None:
            self._reply(
                {"enabled": False, "residentBytes": 0, "entryCount": 0,
                 "entries": []}
            )
            return
        self._reply(rc.debug_dump())

    @route("GET", r"/debug/programs")
    def handle_debug_programs(self):
        """The device-program ledger: every compiled
        executable with its (kind, build key, shape signature), compile
        cost, launch count, and cumulative post-sync device seconds —
        sorted coldest-first, mirroring /debug/hbm. A nonzero
        `recompiles` total here is the paging signal bucket-padding
        regressions show up as."""
        backend = getattr(self.api.executor, "backend", None)
        programs = getattr(backend, "programs", None)
        if programs is None or not hasattr(programs, "ledger"):
            self._reply(
                {"programs": 0, "compiles": 0, "recompiles": 0,
                 "launches": 0, "entries": []}
            )
            return
        out = programs.counts()
        out["entries"] = programs.ledger()
        self._reply(out)

    @route("GET", r"/debug/stalls")
    def handle_debug_stalls(self):
        """The lock-stall ledger (utils/locks.py): the worst recent
        contended waits across the named hot sites, worst-first, plus
        per-site aggregates. Entries carry the waiter's trace id when a
        trace was active — resolve it at /debug/traces/<id>."""
        from pilosa_tpu_torch.utils.locks import global_stall_ledger

        n = int(self.query.get("n", "50"))
        self._reply(
            {
                "worst": global_stall_ledger.worst(n),
                "sites": global_stall_ledger.sites(),
            }
        )

    # -- connection plane ---------------------------------------

    @route("GET", r"/debug")
    def handle_debug_index(self):
        """Route catalogue, auto-generated from the @route registry:
        every endpoint's method, path, and the first line of its
        handler docstring — the debug surface stays discoverable
        without reading source."""
        endpoints = []
        for m, _compiled, fn_name, raw in _ROUTES:
            # `(?P<index>[^/]+)` renders as `<index>` in the catalogue.
            display = re.sub(r"\(\?P<([^>]+)>[^)]*\)", r"<\1>", raw)
            display = display.replace("/?", "").replace(r"\d+", "<n>")
            doc = (getattr(type(self), fn_name).__doc__ or "").strip()
            first = doc.splitlines()[0].strip() if doc else ""
            endpoints.append(
                {"method": m, "path": display, "description": first}
            )
        endpoints.sort(key=lambda e: (e["path"], e["method"]))
        self._reply({"endpoints": endpoints})

    @route("GET", r"/debug/connections")
    def handle_debug_connections(self):
        """The connection-plane ledger (server/connplane.py): aggregates
        first — live count, per-state occupancy, keep-alive reuse
        distribution, worst queue waits, kernel accept-queue truth —
        then the newest ?top=N live and recently-closed entries."""
        top = self._int_query("top", 50)
        self._reply(global_conn_plane.snapshot(top))

    @route("GET", r"/debug/threads")
    def handle_debug_threads(self):
        """Every live thread with its registered role (utils/threads.py)
        — which plane each thread serves, with name, daemon flag, and
        age. The text twin of thread_samples_total{role}."""
        snap = threads.threads_snapshot()
        roles: dict[str, int] = {}
        for t in snap:
            roles[t["role"]] = roles.get(t["role"], 0) + 1
        self._reply({"count": len(snap), "roles": roles, "threads": snap})

    # -- internal routes (reference http/handler.go:307-318) ---------------

    @route("GET", r"/internal/traces/(?P<trace_id>[^/]+)")
    def handle_internal_traces(self, trace_id):
        """One node's local spans for a trace — the per-node leg the
        coordinator's /debug/traces/<id> assembly scrapes."""
        from pilosa_tpu_torch.utils.tracing import global_tracer

        self._reply(
            {
                "node": self._local_node_id(),
                "spans": global_tracer.spans_for(trace_id),
            }
        )

    @route("GET", r"/internal/shards/max")
    def handle_get_shards_max(self):
        self._reply(self.api.max_shards())

    @route("GET", r"/internal/nodes")
    def handle_get_nodes(self):
        self._reply(self.api.status()["nodes"])

    @route("GET", r"/internal/fragment/nodes")
    def handle_get_fragment_nodes(self):
        index = self.query.get("index", "")
        shard = int(self.query.get("shard", "0"))
        if self.api.cluster is None:
            self._reply(self.api.status()["nodes"])
            return
        self._reply(self.api.cluster.shard_nodes_json(index, shard))

    @route("GET", r"/internal/fragment/data")
    def handle_get_fragment_data(self):
        index = self.query.get("index", "")
        field = self.query.get("field", "")
        view = self.query.get("view", "standard")
        shard = int(self.query.get("shard", "0"))
        idx = self.api.holder.index(index)
        f = idx.field(field) if idx else None
        v = f.view(view) if f else None
        frag = v.fragment(shard) if v else None
        if frag is None:
            self._error("fragment not found", status=404)
            return
        import zlib

        from pilosa_tpu_torch.roaring import serialize

        data = serialize(frag.storage)
        # Content checksum: the resize fetcher
        # verifies this before import_roaring, so a corrupt transfer is
        # retried from another source instead of silently ingested.
        self._reply(
            data,
            content_type="application/octet-stream",
            headers={
                "X-Pilosa-Content-Checksum":
                    f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"
            },
        )

    @route("GET", r"/internal/fragment/blocks")
    def handle_get_fragment_blocks(self):
        index = self.query.get("index", "")
        field = self.query.get("field", "")
        view = self.query.get("view", "standard")
        shard = int(self.query.get("shard", "0"))
        idx = self.api.holder.index(index)
        f = idx.field(field) if idx else None
        v = f.view(view) if f else None
        frag = v.fragment(shard) if v else None
        if frag is None:
            self._error("fragment not found", status=404)
            return
        # (checksum, epoch) pairs: epoch 0 = unknown
        # (the receiver unions), and tombstoned blocks ship as
        # checksum 0 with their clear's epoch so block-wide deletes
        # propagate. Stringified like the checksum (64-bit-safe JSON).
        blocks = [
            {"id": b, "checksum": str(c), "epoch": str(e)}
            for b, c, e in frag.block_sums_epochs()
        ]
        self._reply({"blocks": blocks})

    @route("GET", r"/internal/fragment/block/data")
    def handle_get_fragment_block_data(self):
        index = self.query.get("index", "")
        field = self.query.get("field", "")
        view = self.query.get("view", "standard")
        shard = int(self.query.get("shard", "0"))
        block = int(self.query.get("block", "0"))
        idx = self.api.holder.index(index)
        f = idx.field(field) if idx else None
        v = f.view(view) if f else None
        frag = v.fragment(shard) if v else None
        if frag is None:
            self._error("fragment not found", status=404)
            return
        data, epoch = frag.block_data_epoch(block)
        # The epoch rides WITH the data (one lock acquisition on the
        # serving side): the syncer stamps the adopted block with the
        # epoch of exactly these bytes, not its earlier snapshot's.
        self._reply(
            data, content_type="application/octet-stream",
            headers={"X-Pilosa-Block-Epoch": str(epoch)},
        )

    @route("POST", r"/internal/fragment/repair")
    def handle_post_fragment_repair(self):
        """Targeted epoch-directed repair of one local fragment (the
        read-repair plane's fan-out): this node
        pulls the named blocks from its live replicas, higher epoch
        wins, union where epochs are unknown. Body: {index, field,
        view, shard, blocks: [...]} — an empty blocks list repairs the
        whole fragment."""
        if self.api.cluster is None:
            self._error("not clustered", status=400)
            return
        body = self._json_body()
        from pilosa_tpu_torch.cluster.sync import HolderSyncer

        repaired = HolderSyncer(self.api.cluster).sync_fragment_targeted(
            str(body.get("index", "")),
            str(body.get("field", "")),
            str(body.get("view", "standard")),
            int(body.get("shard", 0)),
            blocks=[int(b) for b in body.get("blocks", [])],
        )
        self._reply({"repaired": repaired})

    @route("GET", r"/debug/consistency")
    def handle_debug_consistency(self):
        """Replica-divergence ledger, ordered by
        staleness — unrepaired divergences first, oldest first. {enabled:
        false} when no divergence monitor is wired."""
        mon = getattr(self.api.cluster, "divergence", None) if (
            self.api.cluster is not None
        ) else None
        if mon is None:
            self._reply(
                {"enabled": False, "pendingProbes": 0, "entries": []}
            )
            return
        self._reply(mon.debug_dump())

    @route("GET", r"/internal/field/state")
    def handle_get_field_state(self):
        """View names + available shards for one field (anti-entropy and
        resize discovery; the reference ships this in NodeStatus gossip)."""
        index = self.query.get("index", "")
        field = self.query.get("field", "")
        idx = self.api.holder.index(index)
        f = idx.field(field) if idx else None
        if f is None:
            self._error(f"field not found: {field}", status=404)
            return
        self._reply(
            {
                "views": sorted(f.views),
                # lint: allow-hot-serialize(debug route over the schema-sized shard inventory)
                "availableShards": f.available_shards().to_array().tolist(),
            }
        )

    @route("GET", r"/internal/attr/blocks")
    def handle_get_attr_blocks(self):
        store = self._attr_store()
        if store is None:
            return
        self._reply(
            {"blocks": [{"id": b, "checksum": str(c)} for b, c in store.blocks()]}
        )

    @route("GET", r"/internal/attr/block/data")
    def handle_get_attr_block_data(self):
        store = self._attr_store()
        if store is None:
            return
        block = int(self.query.get("block", "0"))
        self._reply({"attrs": {str(k): v for k, v in store.block_data(block).items()}})

    def _attr_store(self):
        index = self.query.get("index", "")
        field = self.query.get("field", "")
        idx = self.api.holder.index(index)
        if idx is None:
            self._error(f"index not found: {index}", status=404)
            return None
        if field:
            f = idx.field(field)
            store = f.row_attr_store if f else None
        else:
            store = idx.column_attr_store
        if store is None:
            self._error("no attr store", status=400)
            return None
        return store

    # -- resize control (reference api.go:1193-1261) -----------------------

    @route("POST", r"/cluster/resize/add-node")
    def handle_resize_add_node(self):
        body = self._json_body()
        self._reply(self.api.resize_add_node(body))

    @route("POST", r"/cluster/resize/remove-node")
    def handle_resize_remove_node(self):
        body = self._json_body()
        self._reply(self.api.resize_remove_node(body.get("id", "")))

    @route("POST", r"/cluster/resize/abort")
    def handle_resize_abort(self):
        self.api.resize_abort()
        self._reply({"success": True})

    @route("POST", r"/cluster/coordinator")
    def handle_set_coordinator(self):
        body = self._json_body()
        self._reply(self.api.set_coordinator(body.get("id", "")))

    @route("POST", r"/internal/cluster/message")
    def handle_post_cluster_message(self):
        if self.api.cluster is None:
            self._error("not clustered", status=400)
            return
        from pilosa_tpu_torch.cluster.broadcast import Message

        body = self._body()
        try:
            msg = Message.from_bytes(body)
        # lint: allow-except-exception(delivered as the structured bad-frame 400 the sender's wire renegotiation keys on)
        except Exception:
            # Structured parse-failure code BEFORE any side effect: the
            # sender's wire negotiation (broadcast.py _deliver) retries
            # with legacy JSON on exactly this; handler errors below keep
            # the generic panic trap and are never retried.
            self._error("unparseable control frame", status=400, code="bad-frame")
            return
        self.api.cluster.apply_message(msg)
        self._reply({"success": True})

    @route("POST", r"/internal/translate/keys")
    def handle_post_translate_keys(self):
        body = self._json_body()
        index = body.get("index", "")
        field = body.get("field", "")
        keys = body.get("keys", [])
        idx = self.api.holder.index(index)
        if idx is None:
            self._error(f"index not found: {index}", status=404)
            return
        if field:
            f = idx.field(field)
            store = f.translate_store if f else None
        else:
            store = idx.translate_store
        if store is None:
            self._error("no translate store", status=400)
            return
        self._reply({"ids": store.translate_keys(keys)})

    @route("GET", r"/internal/translate/data")
    def handle_get_translate_data(self):
        index = self.query.get("index", "")
        field = self.query.get("field", "")
        since = int(self.query.get("offset", "0"))
        idx = self.api.holder.index(index)
        if idx is None:
            self._error(f"index not found: {index}", status=404)
            return
        store = idx.translate_store
        if field:
            f = idx.field(field)
            store = f.translate_store if f else None
        if store is None:
            self._error("no translate store", status=400)
            return
        self._reply({"entries": store.entries_since(since)})
