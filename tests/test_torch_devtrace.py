"""The port's device traces (pilosa_tpu_torch/utils/devtrace.py: trace_range,
trace_window, DeviceTraceServer; the pilosa.* ranges of
pilosa_tpu_torch/exec/cuda.py; `cli server`'s profile.port), run on the CPU
against the JAX package.

The JAX backend names each request's device work with
jax.profiler.TraceAnnotation("pilosa.<name>"); the port opens trace_range
at the counterparts of those sites. One query list runs through the JAX
TPUBackend, its annotations recorded by a stand-in, and through
CUDABackend(device="cpu") with a recording live: the request-level names
must be equal query by query. The port's launch and part ranges
(pilosa.launch.<kind>, pilosa.part.<d>), which a JAX device trace shows by
itself as programs and device rows, are left out of that comparison.
"""

import http.client
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.exec.batcher import ShardLegBatcher as JaxBatcher
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu.pql import parse_string as jax_parse
from pilosa_tpu_torch.carry import open_reference_holder
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.batcher import ShardLegBatcher
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.parallel import ShardMesh
from pilosa_tpu_torch.pql import parse_string
from pilosa_tpu_torch.utils import devtrace
from tests.test_torch_backend import PAIR_REQUEST

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SHARDS = 3
SHARDS = list(range(N_SHARDS))

#: The request-level ranges: the JAX backend's twelve annotation sites.
REQUEST_RANGES = {
    "pilosa.bitmap_call", "pilosa.count", "pilosa.pair_stats", "pilosa.group_by",
    "pilosa.groupn", "pilosa.count_batch", "pilosa.row_batch", "pilosa.topn",
    "pilosa.topn_page", "pilosa.bsi_sum", "pilosa.bsi_min", "pilosa.bsi_max",
}

#: Where the port's path differs from the JAX one, and why no name differs
#: for it: the JAX group_by opens its range around the tile sweep and,
#: on a Mosaic compile or VMEM failure only real TPU hardware hits, calls
#: _count_device_fallback inside it and answers on the host; the port has
#: no such fallback (a kernel failure raises), so the range is the same
#: and nothing is answered around it. The JAX _topn_dispatch sweeps a
#: paged TopN outside its pilosa.topn range, one pilosa.topn_page a page;
#: the port does the same.
PATH_DIFFERENCES = {
    "pilosa.group_by": "no _count_device_fallback in the port: a kernel failure raises",
}

#: (label, query or batcher leg) in order: the pair, TopN and aggregate
#: caches fill as the list runs, on both backends alike. A leg is a kind
#: and the bitmap calls it counts or materialises.
PARITY_STEPS = [
    ("Count", "Count(Intersect(Row(f=1), Row(g=7)))"),
    ("Row", "Row(f=2)"),
    ("batched Counts", ("count", ["Intersect(Row(f=1), Row(f=2), Row(g=7))",
                                  "Intersect(Row(f=2), Row(f=3), Row(g=7))",
                                  "Union(Row(f=1), Row(h=1))"])),
    ("batched rows", ("row", ["Intersect(Row(f=1), Row(g=7))"])),
    ("pair request", PAIR_REQUEST),
    ("2-field GroupBy", "GroupBy(Rows(f), Rows(g), filter=Row(h=1))"),
    ("3-field GroupBy", "GroupBy(Rows(f), Rows(g), Rows(h))"),
    ("3-field filtered GroupBy", "GroupBy(Rows(f), Rows(g), Rows(h), filter=Row(g=7))"),
    ("TopN", "TopN(f, n=2)"),
    ("Sum", "Sum(field=v)"),
    ("Min", "Min(field=v)"),
    ("Max", "Max(field=v)"),
    ("BSI condition", "Count(Row(v > 100))"),
]
#: Under max-hbm-bytes of one byte every stack is paged: TopN sweeps a page
#: at a time.
PAGED_STEPS = [("paged TopN", "TopN(f, n=2)"), ("paged filtered TopN", "TopN(f, Row(g=7), n=2)")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("jax_written"))
    ge._build_holder(src, N_SHARDS, np.random.default_rng(0)).close()
    return src


class _Pair:
    """The JAX TPUBackend and the port's CUDABackend(device="cpu"), each
    over its own copy of one JAX-written directory."""

    def __init__(self, src, root, max_bytes=None):
        jdir, tdir = str(root / "jax"), str(root / "port")
        shutil.copytree(src, jdir)
        shutil.copytree(src, tdir)
        self.jh = JaxHolder(jdir).open()
        self.th = open_reference_holder(tdir)
        self.jbe = TPUBackend(self.jh, max_bytes=max_bytes)
        self.tbe = CUDABackend(self.th, device="cpu", max_bytes=max_bytes)
        self.jax = JaxExecutor(self.jh, backend=self.jbe)
        self.port = Executor(self.th, backend=self.tbe)

    def close(self):
        self.jh.close()
        self.th.close()


@pytest.fixture(scope="module")
def pair(written, tmp_path_factory):
    p = _Pair(written, tmp_path_factory.mktemp("pair"))
    yield p
    p.close()


@pytest.fixture
def jax_annotations(monkeypatch):
    """The names the JAX backend opens jax.profiler.TraceAnnotation with,
    in order."""
    names = []

    class Recorder:
        def __init__(self, name, **kwargs):
            self.name = name

        def __enter__(self):
            names.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(jax.profiler, "TraceAnnotation", Recorder)
    return names


def _request_names(rec) -> list:
    """The recording's request-level range names in start order (launch and
    part ranges left out)."""
    return [r[0] for r in sorted(rec.ranges, key=lambda r: r[2])
            if not r[0].startswith(("pilosa.launch.", "pilosa.part."))]


def _step(executor, batcher_cls, backend, step, parse):
    if isinstance(step, str):
        return executor.execute("i", step)
    kind, qs = step
    b = batcher_cls(backend, window=0.0)  # one leg dispatches at once
    calls = [parse(q).calls[0] for q in qs]
    if kind == "count":
        return b.count("i", calls, SHARDS)
    return [b.row("i", c, SHARDS) for c in calls]


def _parity(p, steps, jax_annotations):
    """[(label, JAX names, port names)] over steps."""
    out = []
    for label, step in steps:
        jax_annotations.clear()
        _step(p.jax, JaxBatcher, p.jbe, step, jax_parse)
        with devtrace.recording() as rec:
            _step(p.port, ShardLegBatcher, p.tbe, step, parse_string)
        out.append((label, list(jax_annotations), _request_names(rec)))
    return out


def test_request_ranges_equal_jax_annotations(pair, jax_annotations, written, tmp_path):
    """Query by query, the port opens the JAX backend's pilosa.* ranges,
    the same names in the same order, and the list reaches all twelve."""
    got = _parity(pair, PARITY_STEPS, jax_annotations)
    paged = _Pair(written, tmp_path, max_bytes=1)
    try:
        got += _parity(paged, PAGED_STEPS, jax_annotations)
    finally:
        paged.close()
    diffs = [(label, j, t) for label, j, t in got if j != t]
    assert not diffs, f"range names differ (known path differences: {PATH_DIFFERENCES})"
    seen = {n for _, j, _ in got for n in j}
    assert seen == REQUEST_RANGES, sorted(REQUEST_RANGES - seen)


def test_launch_ranges_nest_in_request_ranges(pair):
    """Each launch of a Count is a pilosa.launch.<kind> range inside the
    request's pilosa.count range, on the same thread."""
    with devtrace.recording() as rec:
        pair.port.execute("i", "Count(Intersect(Row(f=2), Row(g=7)))")
    by_name = {r[0]: r for r in rec.ranges}
    assert set(by_name) == {"pilosa.count", "pilosa.launch.count"}
    outer, inner = by_name["pilosa.count"], by_name["pilosa.launch.count"]
    assert outer[1] == inner[1] == threading.get_native_id()
    assert outer[2] <= inner[2] <= inner[3] <= outer[3]


def test_mesh_opens_one_part_range_a_part(written, tmp_path):
    """A meshed backend's Count runs its launch once a part: one
    pilosa.part.<d> range a part, inside the launch's range."""
    root = tmp_path / "mesh"
    shutil.copytree(written, str(root))
    th = open_reference_holder(str(root))
    try:
        ex = Executor(th, backend=CUDABackend(th, device="cpu", mesh=ShardMesh(["cpu"] * 2)))
        ex.execute("i", "Count(Row(f=1))")  # builds the stacks
        with devtrace.recording() as rec:
            ex.execute("i", "Count(Intersect(Row(f=1), Row(g=7)))")
    finally:
        th.close()
    names = sorted(r[0] for r in rec.ranges)
    assert names == ["pilosa.count", "pilosa.launch.count", "pilosa.part.0", "pilosa.part.1"]
    launch = next(r for r in rec.ranges if r[0] == "pilosa.launch.count")
    for r in rec.ranges:
        if r[0].startswith("pilosa.part."):
            assert launch[2] <= r[2] <= r[3] <= launch[3]


# -- bounds and refusals -----------------------------------------------------


def test_nothing_is_recorded_with_no_trace_live(pair):
    """With no trace live trace_range hands back one shared no-op, and the
    ranges of a request run then reach no later recording."""
    assert devtrace._LIVE is None
    assert devtrace.trace_range("pilosa.count") is devtrace.trace_range("pilosa.topn")
    pair.port.execute("i", "Count(Row(f=3))")
    with devtrace.recording() as rec:
        pass
    assert rec.ranges == [] and rec.dropped == 0


def test_range_buffer_cap_counts_what_it_drops(pair):
    """Past the cap a range is counted, not kept: three Counts open six
    ranges, a cap of two keeps the first two."""
    with devtrace.recording(max_ranges=2) as rec:
        for _ in range(3):
            pair.port.execute("i", "Count(Row(f=3))")
    assert len(rec.ranges) == 2 and rec.dropped == 4


def test_range_that_outlives_its_window_is_not_kept():
    """A range opened while a window is live and closed after the window
    ended is not the window's: the trace holds no range past its end."""
    with devtrace.recording() as rec:
        straddling = devtrace.trace_range("pilosa.count")
        straddling.__enter__()
        with devtrace.trace_range("pilosa.topn"):
            pass
    straddling.__exit__(None, None, None)
    assert [r[0] for r in rec.ranges] == ["pilosa.topn"]


def test_trace_window_writes_dropped_ranges_into_its_metadata(pair):
    stop = threading.Event()

    def counts():
        while not stop.is_set():
            pair.port.execute("i", "Count(Row(f=1))")

    t = threading.Thread(target=counts)
    t.start()
    try:
        trace = devtrace.trace_window(0.3, ("cpu",), max_ranges=1)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    meta = trace["pilosaTrace"]
    assert meta["ranges"] == 1 and meta["rangesDropped"] > 0
    assert sum(e.get("cat") == "pilosa" for e in trace["traceEvents"]) == 1


@pytest.mark.parametrize("raw,want", [
    (None, 2.0), ("0.5", 0.5), ("0", 0.1), ("-3", 0.1), ("1e9", 60.0), ("60", 60.0),
])
def test_seconds_clamp(raw, want):
    assert devtrace.clamp_seconds(raw) == want


@pytest.mark.parametrize("raw", ["abc", "nan", ""])
def test_seconds_not_a_number_raises(raw):
    with pytest.raises(ValueError):
        devtrace.clamp_seconds(raw)


def test_recording_refused_while_a_trace_is_live():
    with devtrace.recording():
        with pytest.raises(devtrace.TraceBusy):
            with devtrace.recording():
                pass
    with devtrace.recording():  # released
        pass


def test_range_kernels_attributes_launches_by_thread_and_time():
    """range_kernels pairs each range with the launch calls on its thread
    inside it and the kernels they launched: a call on another thread, one
    past the range's end and one straddling it are not the range's."""
    def call(tid, ts, corr, dur=2.0, name="cudaLaunchKernel"):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "tid": tid, "ts": ts,
                "dur": dur, "args": {"correlation": corr}}

    def kernel(corr, ts):
        return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "tid": 7, "ts": ts,
                "dur": 1.0, "args": {"correlation": corr}}

    trace = {"traceEvents": [
        {"ph": "X", "cat": "pilosa", "name": "pilosa.count", "tid": 1, "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "pilosa", "name": "pilosa.count", "tid": 2, "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "pilosa", "name": "pilosa.topn", "tid": 1, "ts": 100.0, "dur": 50.0},
        call(1, 110.0, 1), call(1, 120.0, 2, name="cuLaunchKernel"), call(2, 130.0, 3),
        call(1, 149.0, 4, dur=5.0), call(1, 160.0, 5), call(1, 90.0, 6),
        call(1, 115.0, 9, name="cudaMemsetAsync"),
        kernel(1, 112.0), kernel(2, 125.0), kernel(3, 131.0), kernel(4, 155.0),
        kernel(5, 161.0),
    ]}
    got = devtrace.range_kernels(trace, "pilosa.count")
    assert [(r["tid"], [c["args"]["correlation"] for c in calls], [k["name"] for k in ks])
            for r, calls, ks in got] == [(1, [1, 2], ["k1", "k2"]), (2, [3], ["k3"])]


def test_cupti_thread_ids_map_to_native_ids():
    """Kineto's id for a thread it did not register is the low 32 bits of
    its pthread id as an int32, written as its absolute value: each form
    maps to the native id of the thread that recorded a range, or of a
    live thread."""
    rec = devtrace._Recorder()
    rec.ranges = [("pilosa.count", 501, 0, 1, 0x7F00_1234_5678), ("pilosa.count", 502, 2, 3,
                                                                  0x7F00_8765_4320)]
    aliases = devtrace._thread_aliases(rec)
    assert aliases[0x1234_5678] == 501
    assert (aliases[0x8765_4320] == aliases[0x8765_4320 - (1 << 32)]
            == aliases[(1 << 32) - 0x8765_4320] == 502)
    me = threading.current_thread()
    assert aliases[me.ident & 0xFFFFFFFF] == me.native_id


# -- the listener --------------------------------------------------------------


def _get(port, path, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


@pytest.fixture
def trace_server():
    srv = devtrace.DeviceTraceServer("127.0.0.1", 0, ("cpu",))
    yield srv
    srv.stop()


def test_listener_trace_holds_each_threads_requests(pair, trace_server):
    """Counts from 4 threads during GET /trace?seconds=0.5: the trace holds
    pilosa.count ranges on each thread's id, none on another's, every one
    inside the profiler's window and after its clock anchors."""
    pair.port.execute("i", "Count(Row(f=1))")  # the stacks are resident
    stop = threading.Event()
    tids, done = [None] * 4, [0] * 4

    def counts(i):
        tids[i] = threading.get_native_id()
        while not stop.is_set():
            pair.port.execute("i", f"Count(Intersect(Row(f={1 + i % 3}), Row(g=7)))")
            done[i] += 1

    threads = [threading.Thread(target=counts, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        status, body = _get(trace_server.port, "/trace?seconds=0.5")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert status == 200, body
    trace = json.loads(body)
    events = trace["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "pilosa"]
    by_tid = {}
    for e in ranges:
        by_tid.setdefault(e["tid"], []).append(e)
    assert set(tids) <= set(by_tid), (tids, sorted(by_tid))
    for i, tid in enumerate(tids):
        mine = [e for e in by_tid[tid] if e["name"] == "pilosa.count"]
        assert 0 < len(mine) <= done[i]
        assert all(e["pid"] == os.getpid() for e in mine)
    span = next(e for e in events if e.get("name", "").startswith("PyTorch Profiler"))
    anchor = min(e["ts"] for e in events if e.get("name") == devtrace.ANCHOR)
    for e in ranges:
        assert anchor <= e["ts"] and e["ts"] + e["dur"] <= span["ts"] + span["dur"]
    meta = trace["pilosaTrace"]
    assert meta["ranges"] == len(ranges) and meta["rangesDropped"] == 0
    assert 0.5 <= meta["seconds"] < 5 and meta["deviceKernels"] == 0


def test_listener_refuses_a_second_trace_and_bad_seconds(trace_server):
    """A second trace while one is live is answered 409, a non-numeric
    window 400, an unknown path 404; the first trace still answers."""
    first = {}
    t = threading.Thread(target=lambda: first.update(
        r=_get(trace_server.port, "/trace?seconds=1.5")))
    t.start()
    deadline = time.monotonic() + 30
    while not devtrace._GUARD.locked():
        assert time.monotonic() < deadline and t.is_alive()
        time.sleep(0.01)
    status, body = _get(trace_server.port, "/trace?seconds=0.1")
    assert status == 409 and "already running" in json.loads(body)["error"]
    assert _get(trace_server.port, "/trace?seconds=abc")[0] == 400
    assert _get(trace_server.port, "/profile")[0] == 404
    t.join(timeout=60)
    assert not t.is_alive()
    assert first["r"][0] == 200
    assert "traceEvents" in json.loads(first["r"][1])


def test_listener_thread_has_its_role(trace_server):
    from pilosa_tpu_torch.utils.threads import roles_snapshot

    assert "device-trace" in roles_snapshot().values()


# -- cli server ----------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _boot(tmp_path, profile_port):
    """`cli server --executor=cpu` with [profile] port = profile_port, as a
    process, once its HTTP port answers: (process, HTTP port)."""
    port = _free_port()
    conf = tmp_path / "c.toml"
    conf.write_text(f"[profile]\nport = {profile_port}\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d", str(tmp_path / "d"),
         "--bind", f"127.0.0.1:{port}", "--executor=cpu", "-c", str(conf)],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    deadline = time.monotonic() + 60
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return proc, port
        except OSError:
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.monotonic() < deadline, "server did not bind"
            time.sleep(0.1)


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body.encode())
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _stop(proc) -> str:
    """SIGINT the server; its exit code must be 0. Its output."""
    try:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
        return proc.stdout.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def test_cli_profile_port_serves_traces(tmp_path):
    """`cli server` with [profile] port = N logs its trace server and
    answers GET /trace there with a Chrome trace; SIGINT stops both."""
    profile_port = _free_port()
    proc, port = _boot(tmp_path, profile_port)
    try:
        assert _post(port, "/index/i", "{}")[0] == 200
        assert _post(port, "/index/i/field/f", "{}")[0] == 200
        status, body = _get(profile_port, "/trace?seconds=0.2")
        assert status == 200, body
        trace = json.loads(body)
        assert trace["pilosaTrace"]["devices"] == ["cpu"]
        assert any(e.get("name") == devtrace.ANCHOR for e in trace["traceEvents"])
        status, body = _post(port, "/index/i/query", "Count(Row(f=1))")
        assert status == 200 and json.loads(body) == {"results": [0]}
    finally:
        out = _stop(proc)
    assert f"device profiler server on :{profile_port}" in out


def test_cli_profile_port_taken_is_logged_and_served_around(tmp_path):
    """A profile port already bound is logged, and the server serves."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        proc, port = _boot(tmp_path, taken.getsockname()[1])
        try:
            assert _post(port, "/index/i", "{}")[0] == 200
            assert _post(port, "/index/i/field/f", "{}")[0] == 200
            status, body = _post(port, "/index/i/query", "Set(3, f=1) Count(Row(f=1))")
            assert status == 200 and json.loads(body) == {"results": [True, 1]}
        finally:
            out = _stop(proc)
    assert "device profiler server failed" in out
