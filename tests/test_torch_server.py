"""The port's HTTP server and CLI (pilosa_tpu_torch.server, .cli) against
the JAX package's.

One data directory is written by the JAX package and copied twice. The JAX
Server(API(holder, Executor(holder))) opens one copy; the port's server,
over CUDABackend(device="cpu") (the kernels' plain versions), opens the
other through carry.open_reference_holder. Both get the same requests,
and every query, import, schema and export response must be byte-identical
in status, content type and body, in JSON and in protobuf. /status, /info,
/version and /metrics report process state, so only their status and
shape are compared.
"""

import http.client
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.exec import Executor as JaxExecutor
from pilosa_tpu.roaring import Bitmap, serialize
from pilosa_tpu.server import API as JaxAPI
from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu.server.wire import (
    ImportRequest,
    ImportRoaringRequest,
    ImportRoaringRequestView,
    ImportValueRequest,
    QueryRequest,
)
from pilosa_tpu_torch import cli
from pilosa_tpu_torch.carry import open_reference_holder
from pilosa_tpu_torch.exec import Executor
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.server import API, Server
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.stats import global_stats
from tests.test_torch_backend import N_SHARDS, PAIR_REQUEST, ROUTED_QUERIES, SLICE_QUERIES


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The per-request write-call cap both servers run with.
WRITE_CAP = 4

AGG_QUERIES = [
    "MinRow(field=f)",
    "MaxRow(Row(g=7), field=f)",
    "TopN(f, Row(g=7), n=2)",
    "TopN(g)",
    "Rows(f)",
    "Count(Row(v > 100))",
]
GROUPBY_QUERIES = [
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), filter=Row(f=2))",
    "GroupBy(Rows(f), Rows(g), Rows(h))",
    "GroupBy(Rows(f), Rows(g), Rows(h), filter=Row(g=7))",
    "GroupBy(Rows(f), Rows(h), limit=3)",
]
ERROR_QUERIES = ["Row(", "Bogus(f=1)", "Row(zz=1)", "Sum(field=nope)"]
READ_QUERIES = (
    SLICE_QUERIES + [PAIR_REQUEST] + ROUTED_QUERIES + AGG_QUERIES
    + GROUPBY_QUERIES + ERROR_QUERIES
    + ["Set(1, f=1) " * (WRITE_CAP + 1)]  # over the cap: refused, unapplied
)


# ---------------------------------------------------------------------------
# the two servers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """A data directory the JAX package wrote: fields f, g, h and the int
    field v over N_SHARDS shards (the backend tests' holder)."""
    src = str(tmp_path_factory.mktemp("jax_written"))
    ge._build_holder(src, N_SHARDS, np.random.default_rng(0)).close()
    return src


class _Pair:
    """The JAX server and the port's server, each over its own copy of
    one data directory."""

    def __init__(self, src, root, cache_bytes=0, budget=None):
        jdir, tdir = os.path.join(root, "jax"), os.path.join(root, "port")
        shutil.copytree(src, jdir)
        shutil.copytree(src, tdir)
        self.jh = JaxHolder(jdir).open()
        self.th = open_reference_holder(tdir)
        self.backend = CUDABackend(self.th, device="cpu", max_bytes=budget)
        japi = JaxAPI(self.jh, JaxExecutor(self.jh))
        if budget is not None:
            # The JAX server over its device backend with the same budget,
            # for the HBM ledger behind /debug/hbm.
            from pilosa_tpu.exec.tpu import TPUBackend

            japi = JaxAPI(self.jh, JaxExecutor(self.jh, backend=TPUBackend(
                self.jh, max_bytes=budget)))
        tapi = API(self.th, Executor(self.th, backend=self.backend))
        if cache_bytes:
            # Wired as `cli server` wires each package with a device
            # backend: its batcher beside the backend and a result cache
            # of cache_bytes.
            from pilosa_tpu.exec.batcher import ShardLegBatcher as JaxBatcher
            from pilosa_tpu.exec.rescache import ResultCache as JaxResultCache
            from pilosa_tpu.exec.tpu import TPUBackend
            from pilosa_tpu_torch.exec.batcher import ShardLegBatcher
            from pilosa_tpu_torch.exec.rescache import ResultCache

            jbe = TPUBackend(self.jh)
            japi = JaxAPI(self.jh, JaxExecutor(self.jh, backend=jbe))
            japi.executor.batcher = JaxBatcher(jbe)
            japi.executor.rescache = JaxResultCache(self.jh, max_bytes=cache_bytes)
            tapi.executor.batcher = ShardLegBatcher(self.backend)
            tapi.executor.rescache = ResultCache(self.th, max_bytes=cache_bytes)
        for api in (japi, tapi):
            api.max_writes_per_request = WRITE_CAP
        self.jax = JaxServer(japi, host="127.0.0.1", port=0).open()
        self.port = Server(tapi, host="127.0.0.1", port=0).open()

    def close(self):
        for srv in (self.jax, self.port):
            srv.close()
        self.jh.close()
        self.th.close()

    def both(self, method, path, body=b"", headers=None):
        """One request to each server -> (JAX reply, port reply), each
        (status, content type, body)."""
        return (_send(self.jax, method, path, body, headers),
                _send(self.port, method, path, body, headers))

    def same(self, method, path, body=b"", headers=None, status=200):
        """Send one request to both servers; the replies must be
        byte-identical, with `status` unless that is None. Returns the
        port's reply."""
        want, got = self.both(method, path, body, headers)
        assert got == want, (method, path, body[:200])
        assert status is None or got[0] == status, (method, path, got)
        return got


def _send(srv, method, path, body=b"", headers=None, marker=False):
    """(status, content type, body), and the X-Pilosa-Cache header last
    when ``marker``."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    elif isinstance(body, str):
        body = body.encode()
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        out = (r.status, r.getheader("Content-Type"), r.read())
        return out + (r.getheader("X-Pilosa-Cache"),) if marker else out
    finally:
        conn.close()


@pytest.fixture(scope="module")
def servers(written, tmp_path_factory):
    """A pair shared by the read-only cases."""
    pair = _Pair(written, str(tmp_path_factory.mktemp("read_pair")))
    yield pair
    pair.close()


#: A budget of two and a half row pages over N_SHARDS shards: no stack of
#: the written directory fits, two row pages do.
HBM_BUDGET = 5 * N_SHARDS * (SHARD_WIDTH // 32) * 4 // 2


@pytest.fixture(scope="module")
def budgeted_servers(written, tmp_path_factory):
    """A pair whose backends both run under HBM_BUDGET, the JAX server's
    over a TPUBackend: its /debug/hbm serves the JAX package's ledger."""
    pair = _Pair(written, str(tmp_path_factory.mktemp("hbm_pair")), budget=HBM_BUDGET)
    yield pair
    pair.close()


@pytest.fixture
def fresh(written, tmp_path):
    """A pair of its own, for a case that writes."""
    pair = _Pair(written, str(tmp_path))
    yield pair
    pair.close()


PB = "application/x-protobuf"


@pytest.fixture
def cached(written, tmp_path):
    """A pair whose executors each carry a result cache (the port's also
    its batcher), as `cli server` wires them with max-result-cache-bytes."""
    pair = _Pair(written, str(tmp_path), cache_bytes=1 << 20)
    yield pair
    pair.close()


CACHED_QUERIES = (SLICE_QUERIES + [PAIR_REQUEST] + AGG_QUERIES + GROUPBY_QUERIES[:3]
                  + ["Sum(field=v)", "Rows(f)"])


def test_cached_server_bytes_identical(cached):
    """Every response of a cache-enabled server, its X-Pilosa-Cache marker
    included, equals the JAX server's: cold (misses), warm (hits), bypassed,
    and around a Set and a SetRowAttrs; /debug/rescache agrees but for the
    entries' ages."""
    path = "/index/i/query"

    def same(q, headers=None):
        want = _send(cached.jax, "POST", path, q, headers, marker=True)
        got = _send(cached.port, "POST", path, q, headers, marker=True)
        assert got == want, q
        return got[3]

    def markers(headers=None):
        return [same(q, headers) for q in CACHED_QUERIES]

    cold = markers()
    warm = markers()
    assert "miss" in cold and "hit" in warm
    assert set(markers({"X-Pilosa-Cache": "bypass"})) <= {"bypass", None}
    same(f"Set({SHARD_WIDTH + 17}, f=1)")
    after_set = markers()
    assert after_set != warm
    same('SetRowAttrs(f, 1, color="red")')
    assert markers() == cold
    for encoding in ("json", "protobuf"):
        for q in CACHED_QUERIES[:4]:
            _query(cached, q, encoding)

    def dump(srv):
        d = json.loads(_send(srv, "GET", "/debug/rescache")[2])
        for e in d["entries"]:
            e.pop("ageSeconds")
        return d

    assert dump(cached.port) == dump(cached.jax)


def _query(pair, q, encoding, index="i", params="", status=200):
    path = f"/index/{index}/query{params}"
    if encoding == "json":
        return pair.same("POST", path, q, {"Content-Type": "text/plain"}, status)
    return pair.same("POST", path, QueryRequest(query=q).to_bytes(),
                     {"Content-Type": PB, "Accept": PB}, status)


# ---------------------------------------------------------------------------
# reads: every query of the backend tests, in both encodings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("encoding", ["json", "protobuf"])
@pytest.mark.parametrize("q", READ_QUERIES)
def test_query_bytes_identical(servers, q, encoding):
    refused = q in ERROR_QUERIES or "Set(" in q
    assert _query(servers, q, encoding, status=400 if refused else 200)[2]


@pytest.mark.parametrize("params", [
    "?shards=0,2", "?excludeColumns=true", "?columnAttrs=true",
    "?excludeRowAttrs=true",
])
def test_query_params_bytes_identical(servers, params):
    for q in ("Row(f=2)", "Count(Row(f=1)) Intersect(Row(f=3), Row(g=7))"):
        for encoding in ("json", "protobuf"):
            _query(servers, q, encoding, params=params)


@pytest.mark.parametrize("path", [
    "/schema", "/index/i", "/index/nope", "/index/nope/query",
    "/export?index=i&field=f", "/export?index=i&field=g&shard=1",
    "/export?index=i&field=nope",
])
def test_get_bytes_identical(servers, path):
    method = "POST" if path.endswith("/query") else "GET"
    status = 200 if "nope" not in path else 400 if method == "POST" else 404
    servers.same(method, path, "Count(Row(f=1))" if method == "POST" else b"", status=status)


@pytest.mark.parametrize("method,path,body,status", [
    # Cluster-only routes answer a single node before they reach the
    # multi-node modules the port has not copied yet.
    ("POST", "/cluster/resize/add-node", {"uri": "http://127.0.0.1:1"}, 400),
    ("POST", "/cluster/resize/remove-node", {"id": "node-x"}, 400),
    ("POST", "/cluster/resize/abort", {}, 400),
    ("POST", "/internal/fragment/repair", {"index": "i", "field": "f"}, 400),
    # The HBM ledger (against the JAX package's, see below).
    ("GET", "/debug/hbm", b"", 200),
    # Debug planes the port has not ported answer as on a backend without
    # them.
    ("GET", "/debug/heat", b"", 200),
    ("GET", "/debug/programs", b"", 200),
    ("GET", "/debug/rescache", b"", 200),
])
def test_single_node_routes_bytes_identical(servers, request, method, path, body, status):
    if path == "/debug/hbm":
        _same_hbm_ledger(request.getfixturevalue("budgeted_servers"))
        return
    servers.same(method, path, body, status=status)


def _same_hbm_ledger(pair):
    """/debug/hbm of the port's server equals the JAX server's over a
    TPUBackend with the same budget, after the same requests, on every
    field but the entries' clock fields (lastAccess, idleSeconds): the row
    pages the Counts took, their tiers summing to residentBytes."""
    for q in ("TopN(f, n=2)", "Count(Intersect(Row(f=1), Row(g=7)))", "Row(f=2)",
              "Count(Row(g=7))"):
        _query(pair, q, "json")

    def ledger(srv, top=""):
        status, ctype, body = _send(srv, "GET", f"/debug/hbm{top}")
        assert (status, ctype) == (200, "application/json")
        d = json.loads(body)
        for e in d["entries"]:
            del e["lastAccess"], e["idleSeconds"]
        return d

    for top in ("", "?top=1"):
        got = ledger(pair.port, top)
        assert got == ledger(pair.jax, top)
    got = ledger(pair.port)
    assert [(e["field"], e["row"]) for e in got["entries"]] == [("f", 2), ("g", 7)]
    assert sum(got["tierBytes"].values()) == got["residentBytes"] > 0


@pytest.mark.parametrize("path", ["/status", "/info", "/version", "/debug/diagnostics"])
def test_info_routes_same_shape(servers, path):
    (js, jt, jb), (ts, tt, tb) = servers.both("GET", path)
    assert (ts, tt) == (js, jt) == (200, "application/json")
    assert json.loads(tb).keys() == json.loads(jb).keys()


def test_metrics_route_same_shape(servers):
    servers.same("POST", "/index/i/query", "Count(Row(f=1))")
    (js, jt, jb), (ts, tt, tb) = servers.both("GET", "/metrics")
    assert (ts, tt) == (js, jt) and ts == 200
    # The series differ with the backend; both are Prometheus text and
    # both count the query just served.
    for body in (jb, tb):
        assert b"# TYPE" in body and b'pilosa_query_Count_total{index="i"}' in body


def test_http_routes_stay_on_the_device(servers):
    """The slice's reads reach the port's device backend: no call of the
    slice leaves it, and the Count and GroupBy run its programs."""
    routed = sum(global_stats.counter_totals("cpu_routed_total").values())
    launches = sum(global_stats.counter_totals("device_launches_total").values())
    for q in SLICE_QUERIES + [PAIR_REQUEST] + GROUPBY_QUERIES[:5]:
        _query(servers, q, "json")
    assert sum(global_stats.counter_totals("cpu_routed_total").values()) == routed
    assert sum(global_stats.counter_totals("device_launches_total").values()) > launches


# ---------------------------------------------------------------------------
# writes: each scenario on a pair of its own
# ---------------------------------------------------------------------------


def _schema(pair):
    pair.same("POST", "/index/w", {"options": {"trackExistence": True}})
    pair.same("POST", "/index/w/field/f", {})
    pair.same("POST", "/index/w/field/v",
              {"options": {"type": "int", "min": -100, "max": 100}})
    pair.same("POST", "/index/w", {}, status=409)
    pair.same("GET", "/schema")
    pair.same("POST", "/index/w/field/gone", {})
    pair.same("DELETE", "/index/w/field/gone")
    pair.same("DELETE", "/index/nope", status=404)
    pair.same("GET", "/index/w")
    pair.same("GET", "/schema")


def _json_import(pair):
    _schema(pair)
    pair.same("POST", "/index/w/field/f/import", {
        "rowIDs": [1, 1, 2, 2], "columnIDs": [10, SHARD_WIDTH + 20, 10, 3 * SHARD_WIDTH],
    })
    pair.same("POST", "/index/w/field/v/import", {
        "columnIDs": [10, 11, SHARD_WIDTH + 20], "values": [42, -7, 99],
    })
    for q in ("Row(f=1)", "Count(Row(f=2))", "All()", "Sum(field=v)",
              "Min(Row(f=1), field=v)", "Max(field=v)", "TopN(f)",
              "GroupBy(Rows(f))", "Count(Row(v < 50))"):
        for encoding in ("json", "protobuf"):
            _query(pair, q, encoding, index="w")
    pair.same("GET", "/export?index=w&field=f")


def _protobuf_import(pair):
    _schema(pair)
    msg = ImportRequest(index="w", field="f", row_ids=[5, 5, 6],
                        column_ids=[1, 2, SHARD_WIDTH + 3])
    pair.same("POST", "/index/w/field/f/import", msg.to_bytes(), {"Content-Type": PB})
    msg = ImportValueRequest(index="w", field="v", column_ids=[1, 2], values=[42, -7])
    pair.same("POST", "/index/w/field/v/import", msg.to_bytes(), {"Content-Type": PB})
    for q in ("Row(f=5)", "Count(Union(Row(f=5), Row(f=6)))", "Sum(Row(f=5), field=v)",
              "MaxRow(field=f)", "Rows(f)"):
        for encoding in ("json", "protobuf"):
            _query(pair, q, encoding, index="w")
    pair.same("GET", "/export?index=w&field=f")


def _roaring_import(pair):
    _schema(pair)
    msg = ImportRoaringRequest(views=[ImportRoaringRequestView(
        name="", data=serialize(Bitmap(np.array([1, 2, 3, 70000], dtype=np.uint64))))])
    pair.same("POST", "/index/w/field/f/import-roaring/1", msg.to_bytes(),
              {"Content-Type": PB})
    for q in ("Row(f=0)", "Count(Row(f=0))"):
        for encoding in ("json", "protobuf"):
            _query(pair, q, encoding, index="w")


def _keyed(pair):
    pair.same("POST", "/index/k", {"options": {"keys": True}})
    pair.same("POST", "/index/k/field/f", {"options": {"keys": True}})
    pair.same("POST", "/index/k/field/f/import",
              {"rowKeys": ["red", "red", "blue"], "columnKeys": ["a", "b", "a"]})
    for q in ('Row(f="red")', 'Count(Row(f="blue"))', "TopN(f)", "GroupBy(Rows(f))",
              'Set("c", f="blue")', "Rows(f)"):
        for encoding in ("json", "protobuf"):
            _query(pair, q, encoding, index="k")
    pair.same("GET", "/schema")
    pair.same("GET", "/export?index=k&field=f")


def _write_cap(pair):
    _query(pair, "Set(1, f=1) " * (WRITE_CAP + 1), "json", status=400)
    _query(pair, "Set(1, f=1) " * WRITE_CAP, "json")
    _query(pair, f"Set({SHARD_WIDTH + 9}, f=3) Clear(1, f=2)", "protobuf")
    for q in SLICE_QUERIES + [PAIR_REQUEST]:
        _query(pair, q, "json")


def _attrs(pair):
    for q in ('SetRowAttrs(f, 1, note="hi", n=3)', 'SetColumnAttrs(10, tag="x")',
              "Set(10, f=1)"):
        _query(pair, q, "json")
    for params in ("", "?columnAttrs=true", "?excludeRowAttrs=true"):
        for encoding in ("json", "protobuf"):
            _query(pair, "Row(f=1)", encoding, params=params)


def _clear_row_store(pair):
    for q in ("ClearRow(f=3)", "Count(Row(f=3))", "Store(Row(g=7), f=9)",
              "Count(Row(f=9))", "Options(Row(f=9), shards=[0, 1])"):
        for encoding in ("json", "protobuf"):
            _query(pair, q, encoding)


@pytest.mark.parametrize("scenario", [
    _schema, _json_import, _protobuf_import, _roaring_import, _keyed,
    _write_cap, _attrs, _clear_row_store,
], ids=lambda f: f.__name__.strip("_"))
def test_write_scenario_bytes_identical(fresh, scenario):
    scenario(fresh)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _no_serving(monkeypatch):
    """Make binding a server fail the test: a refused start serves
    nothing, on no backend."""
    from pilosa_tpu_torch.server import http as http_mod

    def refuse(*a, **k):
        raise AssertionError("the server was started")

    monkeypatch.setattr(http_mod.Server, "__init__", refuse)


def test_cli_cuda_without_card_exits_nonzero(tmp_path, monkeypatch, capsys):
    _no_serving(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["server", "-d", str(tmp_path / "d"), "--bind", "127.0.0.1:0"])
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err


def _write_topology(data_dir, n_nodes):
    from pilosa_tpu_torch.cluster import Node, Topology, URI
    from pilosa_tpu_torch.cluster.topology import TOPOLOGY_FILE, save_topology

    nodes = [Node(id=f"node-{i}", uri=URI(host="127.0.0.1", port=10101 + i))
             for i in range(n_nodes)]
    os.makedirs(data_dir, exist_ok=True)
    save_topology(os.path.join(data_dir, TOPOLOGY_FILE), Topology(nodes), "node-0")


#: A non-default value of every setting the port's server does not read.
UNREAD_SETTING_TOML = {
    "anti-entropy.interval": "[anti-entropy]\ninterval = 60.0\n",
    "client-timeout": "client-timeout = 5.0\n",
    "client-retries": "client-retries = 3\n",
    "breaker-threshold": "breaker-threshold = 5\n",
    "breaker-cooldown": "breaker-cooldown = 2.0\n",
    "hedge-delay": "hedge-delay = 0.0\n",
    "resize-lease": "resize-lease = 30.0\n",
    "migration-concurrency": "migration-concurrency = 4\n",
    "migration-bandwidth": "migration-bandwidth = 1000000\n",
    "read-repair-queue": "read-repair-queue = 0\n",
    "cluster.coordinator": "[cluster]\ncoordinator = true\n",
    "cluster.replicas": "[cluster]\nreplicas = 2\n",
    "tls.ca-certificate": '[tls]\nca-certificate = "ca.pem"\n',
    "tls.skip-verify": "[tls]\nskip-verify = true\n",
}


def test_every_unread_setting_is_tested():
    assert set(UNREAD_SETTING_TOML) == set(cli._UNREAD_SETTINGS)


@pytest.mark.parametrize("knob,toml,argv", [
    *((k, t, []) for k, t in UNREAD_SETTING_TOML.items()),
    ("preheat", "preheat = true\n", []),
    ("refresh-window-ms", "refresh-window-ms = 5\n", []),
    ("mesh-devices", "mesh-devices = 2\n", []),
    ("profile.port", "[profile]\nport = 6060\n", []),
    ("cluster.hosts", '[cluster]\nhosts = ["127.0.0.1:10101", "127.0.0.1:10102"]\n', []),
    ("--join", "", ["--join", "http://127.0.0.1:10102"]),
    ("multi-node topology", "", []),
    ("executor='tpu'", 'executor = "tpu"\n', []),
])
def test_cli_refuses_unported_knob(tmp_path, monkeypatch, capsys, knob, toml, argv):
    _no_serving(monkeypatch)
    data_dir = str(tmp_path / "d")
    if knob == "multi-node topology":
        _write_topology(data_dir, 2)
    conf = tmp_path / "c.toml"
    conf.write_text(toml)
    executor = [] if "executor" in toml else ["--executor", "cpu"]
    rc = cli.main(["server", "-d", data_dir, "--bind", "127.0.0.1:0",
                   "-c", str(conf)] + executor + argv)
    err = capsys.readouterr().err
    assert rc != 0
    assert knob.split()[0] in err and "ROADMAP.md" in err


def test_cli_refuses_unread_setting_from_env(tmp_path, monkeypatch, capsys):
    _no_serving(monkeypatch)
    monkeypatch.setenv("PILOSA_TPU_CLIENT_TIMEOUT", "5.0")
    rc = cli.main(["server", "-d", str(tmp_path / "d"), "--bind", "127.0.0.1:0",
                   "--executor", "cpu"])
    err = capsys.readouterr().err
    assert rc != 0
    assert "client-timeout" in err and "ROADMAP.md" in err


@pytest.mark.parametrize("toml,env,argv,budget", [
    ("", {}, [], None),
    ("max-hbm-bytes = 1073741824\n", {}, [], 1 << 30),
    ("", {"PILOSA_TPU_MAX_HBM_BYTES": "536870912"}, [], 1 << 29),
    ("max-hbm-bytes = 1073741824\n", {}, ["--max-hbm-bytes", "4096"], 4096),
], ids=["default", "toml", "env", "flag"])
def test_cli_max_hbm_bytes_reaches_the_backend(tmp_path, monkeypatch, toml, env, argv,
                                               budget):
    """max-hbm-bytes, from TOML, from PILOSA_TPU_MAX_HBM_BYTES or from the
    flag (which wins), is the byte budget of the server's CUDABackend
    (0, the default: none). The card is stood in for by the plain versions
    on the CPU."""
    from pilosa_tpu_torch.exec import cuda as cuda_mod
    from pilosa_tpu_torch.server import api as api_mod

    built = {}

    def capture(self, holder, executor, *a, **k):
        built["executor"] = executor
        raise _Booted

    real = cuda_mod.CUDABackend
    monkeypatch.setattr(cuda_mod, "CUDABackend",
                        lambda holder, **k: real(holder, device="cpu", **k))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stand-in")
    monkeypatch.setattr(api_mod.API, "__init__", capture)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    conf = tmp_path / "c.toml"
    conf.write_text(toml)
    with pytest.raises(_Booted):
        cli.main(["server", "-d", str(tmp_path / "d"), "--bind", "127.0.0.1:0",
                  "-c", str(conf)] + argv)
    ex = built["executor"]
    try:
        assert isinstance(ex.backend, real)
        assert ex.backend.blocks.max_bytes == budget
    finally:
        ex.holder.close()


class _Booted(Exception):
    """Raised where the CLI builds its API: the wiring is done."""


@pytest.mark.parametrize("toml,executor,window,cache", [
    ("batch-window = 0.002\n", "cuda", 0.002, None),
    ("max-result-cache-bytes = 1048576\nmax-staleness = 2\n", "cuda", 0.0, (1048576, 2)),
    ("max-result-cache-bytes = 1048576\n", "cpu", None, (1048576, 0)),
    ("max-result-cache-bytes = 1048576\ncache-enabled = false\n", "cuda", 0.0, None),
], ids=["batch-window", "cache-and-staleness", "cpu-oracle-cache", "cache-disabled"])
def test_cli_wires_batcher_and_cache(tmp_path, monkeypatch, toml, executor, window, cache):
    """`cli server` wires a ShardLegBatcher (with batch-window) beside the
    card's backend, none beside the CPU oracle, and a ResultCache (with
    max-staleness) when cache-enabled and max-result-cache-bytes ask for
    one. The card is stood in for by the plain versions on the CPU."""
    from pilosa_tpu_torch.exec import cuda as cuda_mod
    from pilosa_tpu_torch.exec.batcher import ShardLegBatcher
    from pilosa_tpu_torch.exec.rescache import ResultCache
    from pilosa_tpu_torch.server import api as api_mod

    built = {}

    def capture(self, holder, executor, *a, **k):
        built["executor"] = executor
        raise _Booted

    real = cuda_mod.CUDABackend
    monkeypatch.setattr(cuda_mod, "CUDABackend",
                        lambda holder, **k: real(holder, device="cpu", **k))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stand-in")
    monkeypatch.setattr(api_mod.API, "__init__", capture)
    conf = tmp_path / "c.toml"
    conf.write_text(toml)
    with pytest.raises(_Booted):
        cli.main(["server", "-d", str(tmp_path / "d"), "--bind", "127.0.0.1:0",
                  "-c", str(conf), "--executor", executor])
    ex = built["executor"]
    try:
        if window is None:
            assert ex.batcher is None
        else:
            assert isinstance(ex.batcher, ShardLegBatcher) and ex.batcher.window == window
            assert ex.batcher.backend is ex.backend
        if cache is None:
            assert ex.rescache is None
        else:
            assert isinstance(ex.rescache, ResultCache)
            assert (ex.rescache.max_bytes, ex.rescache.max_staleness) == cache
    finally:
        ex.holder.close()


def cli_config(data_dir):
    from pilosa_tpu_torch.server.config import Config

    return Config.from_sources(env={}, args={"data_dir": data_dir})


def test_cli_single_node_topology_is_not_refused(tmp_path):
    """A persisted one-node topology is not a cluster: no refusal."""
    data_dir = str(tmp_path / "d")
    _write_topology(data_dir, 1)
    assert cli._saved_cluster_size(data_dir) == 1
    assert cli._unported_knobs(cli_config(data_dir), None) == []


def test_generate_config_names_cuda(capsys):
    assert cli.main(["generate-config"]) == 0
    assert 'executor = "cuda"' in capsys.readouterr().out


def test_config_defaults_serve():
    """Every refused knob is off by default, so the default configuration
    starts (heat-half-life is accepted and inert)."""
    cfg = cli_config("/nonexistent")
    assert cfg.executor == "cuda"
    assert cfg.heat_half_life == 300.0
    assert cli._unported_knobs(cfg, None) == []


def test_heat_half_life_is_accepted():
    """heat-half-life is accepted and inert until block heat is ported."""
    cfg = cli_config("/nonexistent")
    cfg.heat_half_life = 60.0
    assert cli._unported_knobs(cfg, None) == []


def test_cli_import_and_export_through_the_port(fresh, tmp_path, capsys):
    csv = tmp_path / "bits.csv"
    csv.write_text(f"1,3\n1,{SHARD_WIDTH + 4}\n2,3\n")
    for srv in (fresh.jax, fresh.port):
        assert cli.main(["import", "--host", srv.uri, "-i", "c", "-f", "f",
                         "--create", str(csv)]) == 0
    fresh.same("POST", "/index/c/query", "Row(f=1) Count(Row(f=2))")
    capsys.readouterr()
    assert cli.main(["export", "--host", fresh.port.uri, "-i", "c", "-f", "f"]) == 0
    out = capsys.readouterr().out
    assert out == fresh.same("GET", "/export?index=c&field=f")[2].decode()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_cpu_executor_serves(tmp_path):
    """`--executor=cpu` boots the server as a process; it answers, and
    SIGINT stops it with exit code 0."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d",
         str(tmp_path / "d"), "--bind", f"127.0.0.1:{port}", "--executor=cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.monotonic() < deadline, "server did not bind"
                time.sleep(0.1)

        srv = types.SimpleNamespace(host="127.0.0.1", port=port)
        assert _send(srv, "POST", "/index/i", {})[0] == 200
        assert _send(srv, "POST", "/index/i/field/f", {})[0] == 200
        for q, want in (("Set(3, f=1)", [True]), ("Count(Row(f=1))", [1])):
            status, _, body = _send(srv, "POST", "/index/i/query", q)
            assert status == 200 and json.loads(body) == {"results": want}
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def test_diagnostics_device_block_without_card(monkeypatch):
    """The diagnostics device block reports and never raises, and it does
    not start CUDA."""
    from pilosa_tpu_torch.utils import monitor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    snap = monitor.diagnostics_snapshot()
    assert snap["jax"] == {"platform": "cpu", "device_count": 0, "devices": []}
    assert not torch.cuda.is_initialized()
