"""Command-line interface (reference cmd/ + ctl/: server, import, export,
check, inspect, generate-config, config).

Usage: python -m pilosa_tpu_torch.cli <command> [flags]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


#: Where the knobs the server refuses are queued for porting.
_ROADMAP = "ROADMAP.md, queue 1"


def _unported_knobs(cfg, args) -> list[str]:
    """The knobs this port does not serve, each as a refusal message.
    Their defaults are off, so the default configuration serves; a knob
    set on is refused at startup rather than ignored."""
    out = []
    if cfg.executor not in ("cuda", "cpu"):
        out.append(f"executor={cfg.executor!r}: choose cuda or cpu")
    return [f"{m} ({_ROADMAP})" for m in out]


def _mesh_devices(cfg):
    """The cards mesh-devices asks for (the JAX CLI's rule): none for 0; -1
    every visible card, N the first N. More than are visible raises
    MeshConfigError. A mesh of one card is one device: the backend takes
    it as no mesh."""
    import torch

    from pilosa_tpu_torch.parallel import MeshConfigError

    if not cfg.mesh_devices:
        return None
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = visible if cfg.mesh_devices < 0 else cfg.mesh_devices
    if want > visible or want < 1:
        raise MeshConfigError(
            f"mesh-devices={cfg.mesh_devices} but {visible} card"
            f"{'' if visible == 1 else 's'} {'is' if visible == 1 else 'are'} visible")
    return [torch.device("cuda", i) for i in range(want)]


def cmd_server(args) -> int:
    """Serve one node, alone or as a member of a cluster (cluster.hosts,
    --join, or a persisted multi-node topology): --executor=cuda (the
    default) on the card, which exits non-zero where the card cannot be
    used; --executor=cpu on the CPU oracle, by explicit choice only."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.server.config import Config
    from pilosa_tpu_torch.server.http import Server
    from pilosa_tpu_torch.utils.logger import StandardLogger

    cfg = Config.from_sources(
        toml_path=args.config,
        args={
            "data_dir": args.data_dir,
            "bind": args.bind,
            "executor": args.executor,
            "max_hbm_bytes": args.max_hbm_bytes,
            "preheat": args.preheat or None,
            "refresh_window_ms": args.refresh_window_ms,
            "heat_half_life": args.heat_half_life,
            "mesh_devices": args.mesh_devices,
            "verbose": args.verbose or None,
        },
    )
    # log-path: append server logs to a file instead of stderr
    # (reference config.go LogPath). Line-buffered so a crash loses at
    # most one line.
    log_stream = (
        open(os.path.expanduser(cfg.log_path), "a", buffering=1)
        if cfg.log_path
        else None
    )
    log = StandardLogger(stream=log_stream, verbose=cfg.verbose)
    data_dir = os.path.expanduser(cfg.data_dir)
    refused = _unported_knobs(cfg, args)
    if refused:
        for m in refused:
            log.printf("refusing to start: %s", m)
        return 2
    holder = Holder(data_dir).open()

    backend = None
    if cfg.executor == "cuda":
        import torch

        try:
            from pilosa_tpu_torch.exec.cuda import CUDABackend
            from pilosa_tpu_torch.parallel import ShardMesh

            # mesh-devices: shard the stacks over that many cards (one
            # process, parallel/mesh.py); a count past the visible cards
            # raises MeshConfigError, and the server does not start.
            # max-hbm-bytes: the device byte budget (0: none). A field over
            # it is paged through the card a row at a time. heat-half-life:
            # the half-life of the stacks' heat (/debug/heat).
            devices = _mesh_devices(cfg)
            backend = CUDABackend(holder, max_bytes=cfg.max_hbm_bytes or None,
                                  heat_half_life=cfg.heat_half_life or None,
                                  mesh=ShardMesh(devices) if devices else None)
        except Exception as e:  # noqa: BLE001 — reported, never served around
            log.printf(
                "executor=cuda: %s; not serving (--executor=cpu runs the "
                "CPU oracle)", e,
            )
            holder.close()
            return 1
        log.printf("executor=cuda: device backend on %s (%s), max-hbm-bytes %d, "
                   "%d device%s", backend.device, torch.cuda.get_device_name(backend.device),
                   cfg.max_hbm_bytes, backend.mesh.n if backend.mesh is not None else 1,
                   "s" if backend.mesh is not None else "")
    executor = Executor(
        holder, backend=backend if backend is not None else CPUBackend(holder)
    )
    if backend is not None:
        # Cross-request batching of device legs (exec/batcher.py); the CPU
        # oracle gets none, as in the reference.
        from pilosa_tpu_torch.exec.batcher import ShardLegBatcher

        executor.batcher = ShardLegBatcher(backend, window=cfg.batch_window)
        if cfg.preheat:
            from pilosa_tpu_torch.utils.threads import spawn

            def _preheat():
                n = backend.preheat(logger=log)
                log.printf("preheat: %d stacks resident", n)

            spawn("preheat", _preheat)
        if cfg.refresh_window_ms > 0:
            # Windowed device refresh: a window's writes reach the resident
            # stacks in one splice round, off the read path.
            backend.start_refresher(cfg.refresh_window_ms)
            log.printf("windowed device refresh: %d ms coalescing window",
                       cfg.refresh_window_ms)
    # Epoch-tagged result cache (exec/rescache.py): serve hot terminal
    # answers from memory while their epoch vector matches. 0 bytes =
    # disabled; cache-enabled=false keeps it out even with a budget set.
    if cfg.cache_enabled and cfg.max_result_cache_bytes > 0:
        from pilosa_tpu_torch.exec.rescache import ResultCache

        executor.rescache = ResultCache(
            holder,
            max_bytes=cfg.max_result_cache_bytes,
            max_staleness=cfg.max_staleness,
        )
        log.printf(
            "result cache: %.1f MiB budget, max-staleness=%d",
            cfg.max_result_cache_bytes / (1 << 20), cfg.max_staleness,
        )
    executor.logger = log
    trace_server = None
    if cfg.profile_port:
        from pilosa_tpu_torch.utils.devtrace import DeviceTraceServer

        # GET /trace?seconds=S on profile.port: a Chrome trace of the
        # card's kernels and the requests' pilosa.* ranges
        # (utils/devtrace.py). A port that cannot be bound is logged, and
        # the server serves on without it.
        if backend is None:
            devices = ("cpu",)
        else:
            devices = backend.mesh.devices if backend.mesh is not None else (backend.device,)
        try:
            trace_server = DeviceTraceServer(cfg.host, cfg.profile_port, devices)
            log.printf("device profiler server on :%d", cfg.profile_port)
        except OSError as e:
            log.printf("device profiler server failed: %s", e)
    if cfg.long_query_time > 0:
        executor.long_query_time = cfg.long_query_time
    api = API(holder, executor)
    # Default per-query budget for clients that send no ?timeout=
    # (server/http.py opens the deadline scope at ingress).
    api.query_timeout = cfg.query_timeout
    # In-flight /query admission cap (deliberate 429 shedding past it).
    api.max_inflight_queries = cfg.max_inflight
    # Write-side admission: in-flight import bytes + pending-WAL depth
    # caps (deliberate 429/503 import shedding — never OOM).
    api.max_import_bytes = cfg.max_import_bytes
    api.max_pending_wal = cfg.max_pending_wal
    # Per-request write-call cap + metric exposition switch.
    api.max_writes_per_request = cfg.max_writes_per_request
    api.metric_service = cfg.metric_service
    # Read/write plane isolation: paced + globally bounded background
    # snapshots and SLO-adaptive import derating.
    from pilosa_tpu_torch.core.fragment import SNAPSHOT_SCHEDULER

    SNAPSHOT_SCHEDULER.configure(
        concurrency=cfg.snapshot_concurrency,
        bandwidth=cfg.snapshot_bandwidth,
    )
    api.ingest_derate = cfg.ingest_derate

    # TLS (reference server/tlsconfig.go): certificate+key serve HTTPS;
    # peers are dialed with a CA-verified (or skip-verify) context. A
    # bare host in cluster.hosts inherits the local scheme so an
    # all-TLS cluster doesn't need https:// spelled on every host.
    local_scheme = "https" if cfg.tls.enabled else "http"
    client_ssl = (
        cfg.tls.client_context()
        if (cfg.tls.enabled or cfg.tls.skip_verify or cfg.tls.ca_certificate)
        else None
    )

    # Persisted topology: membership survives restarts in
    # <data-dir>/.topology, written atomically on every durable change, so
    # a restarting node rejoins with its same identity and a full-cluster
    # restart reconverges without operator re-seeding.
    from pilosa_tpu_torch.cluster.topology import TOPOLOGY_FILE, load_topology

    topo_path = os.path.join(data_dir, TOPOLOGY_FILE)
    saved = load_topology(topo_path)  # None on absent/corrupt: reseed
    saved_nodes = []
    saved_local = None
    if saved:
        from pilosa_tpu_torch.cluster import Node
        from pilosa_tpu_torch.cluster.topology import NODE_STATE_READY

        saved_nodes = [Node.from_json(d) for d in saved["nodes"]]
        for n in saved_nodes:
            # Persisted liveness is stale by definition: every member
            # boots READY and the failure detector re-learns the truth.
            n.state = NODE_STATE_READY
        saved_local = next(
            (
                n
                for n in saved_nodes
                if n.uri.host == cfg.host and n.uri.port == cfg.port
            ),
            None,
        )

    def restore_saved_cluster():
        """Boot from the persisted topology: the one restore sequence
        both the --join-restart and no-cluster-config paths share."""
        if saved.get("replicaN"):
            cfg.cluster.replicas = int(saved["replicaN"])
        cluster = wire_cluster(
            saved_nodes, saved_local.id, partition_n=saved.get("partitionN")
        )
        log.printf(
            "restored topology from %s: %d nodes, replicas=%d, local id %s",
            topo_path, len(saved_nodes), cfg.cluster.replicas, saved_local.id,
        )
        return cluster

    def wire_cluster(topo_nodes, local_id, partition_n=None):
        """Shared cluster bootstrap for the static-hosts, --join, and
        persisted-topology paths: build the topology, attach seams,
        start daemons."""
        from pilosa_tpu_torch.cluster import Cluster, InternalClient, Topology
        from pilosa_tpu_torch.cluster.breaker import BreakerRegistry
        from pilosa_tpu_torch.cluster.sync import FailureDetector, SyncDaemon
        from pilosa_tpu_torch.cluster.topology import DEFAULT_PARTITION_N

        topo = Topology(
            topo_nodes,
            replica_n=cfg.cluster.replicas,
            partition_n=partition_n or DEFAULT_PARTITION_N,
        )
        local = topo.node_by_id(local_id)
        if local is None:
            return None
        cluster = Cluster(
            local, topo, holder,
            client=InternalClient(
                timeout=cfg.client_timeout,
                ssl_context=client_ssl,
                retries=cfg.client_retries,
                breakers=BreakerRegistry(
                    threshold=cfg.breaker_threshold,
                    cooldown=cfg.breaker_cooldown,
                ),
            ),
        )
        cluster.hedge_delay = cfg.hedge_delay
        cluster.logger = log
        cluster.attach(executor, api)
        api.cluster = cluster
        resizer = cluster.attach_resizer(log)
        # Cluster-lifecycle knobs: follower rollback lease + migration
        # throttles.
        resizer.lease_timeout = cfg.resize_lease
        resizer.fetch_concurrency = cfg.migration_concurrency
        resizer.bandwidth_limit = cfg.migration_bandwidth
        resizer.fetch_timeout = cfg.client_timeout
        if saved:
            # The resize epoch survives restarts: a rebooted
            # coordinator's fresh jobs must outrank any dead job whose
            # completion reports are still in retry flight.
            resizer._epoch = int(saved.get("resizeEpoch") or 0)
        cluster.topology_file = topo_path
        cluster.persist_topology()
        daemons.append(
            SyncDaemon(cluster, interval=cfg.anti_entropy_interval, logger=log).start()
        )
        daemons.append(FailureDetector(cluster, logger=log).start())
        if cfg.read_repair_queue > 0:
            # Read-path divergence monitor: hedge races' replica-pair
            # answers feed a bounded queue of background checksum diffs +
            # targeted epoch-directed repairs, surfaced at
            # /debug/consistency.
            from pilosa_tpu_torch.cluster.consistency import DivergenceMonitor

            daemons.append(
                DivergenceMonitor(
                    cluster, max_queue=cfg.read_repair_queue, logger=log
                ).start()
            )
        return cluster

    daemons = [] if trace_server is None else [trace_server]
    from pilosa_tpu_torch.utils.monitor import RuntimeMonitor

    monitor = RuntimeMonitor(holder, backend)
    # SLO objectives (config `slo`): the monitor's poll loop keeps the
    # windowed histogram snapshots /debug/slo evaluates them against.
    monitor.slo = cfg.slo
    api.slo = cfg.slo
    api.monitor = monitor
    daemons.append(monitor.start())
    join_cluster_ref = None
    if getattr(args, "join", None):
        # Dynamic join (reference gossip join → listenForJoins
        # cluster.go:1063): boot as a single-node topology; the announce
        # fires AFTER the HTTP server is bound (below) so the
        # coordinator's resize instructions can reach us, and the resize
        # machinery delivers schema + fragments + the real topology.
        from pilosa_tpu_torch.cluster import Node, URI

        if saved_local is not None and len(saved_nodes) > 1:
            # Restart of a previously joined node: come back with the
            # SAME identity and the last known membership — the cluster
            # still routes shards to us, so booting as a blank
            # single-node would orphan them until a fresh resize. The
            # announce below re-syncs schema/shards (handle_join's
            # restarted-member path) without moving any data.
            join_cluster_ref = restore_saved_cluster()
        else:
            local_id = f"node-{cfg.host}-{cfg.port}"
            local = Node(
                id=local_id,
                uri=URI(scheme=local_scheme, host=cfg.host, port=cfg.port),
            )
            join_cluster_ref = wire_cluster([local], local_id)
    elif cfg.cluster.hosts:
        from pilosa_tpu_torch.cluster import Node, URI

        # Node IDs derive from the URI so every host computes the same
        # ID-sorted ring without an out-of-band registry (the reference
        # persists a UUID and gossips it; static topology needs neither).
        import dataclasses as _dc

        nodes = []
        for h in cfg.cluster.hosts:
            u = URI.parse(h)
            if "://" not in h and local_scheme != "http":
                u = _dc.replace(u, scheme=local_scheme)
            nodes.append(Node(id=f"node-{u.host}-{u.port}", uri=u))
        local_id = f"node-{cfg.host}-{cfg.port}"
        if cfg.cluster.coordinator:
            # cluster.coordinator = true marks THIS node the coordinator
            # (reference server/config.go Cluster.Coordinator); set it in
            # every node's config consistently.
            for n in nodes:
                n.is_coordinator = n.id == local_id
        elif nodes:
            min(nodes, key=lambda n: n.id).is_coordinator = True
        cluster = wire_cluster(nodes, local_id)
        if cluster is None:
            log.printf(
                "bind %s:%d is not in cluster.hosts %s", cfg.host, cfg.port, cfg.cluster.hosts
            )
            _stop(daemons, backend, holder)
            return 1
        log.printf(
            "clustered: %d nodes, replicas=%d, coordinator=%s",
            len(nodes), cfg.cluster.replicas, cluster.coordinator().id,
        )
    elif saved_local is not None and len(saved_nodes) > 1:
        # No cluster config at all, but a persisted topology: a
        # full-cluster restart reconverges straight from the file —
        # every member boots with the membership it last agreed on, no
        # operator re-seeding.
        restore_saved_cluster()

    server = Server(api, host=cfg.host, port=cfg.port, tls=cfg.tls)  # binds
    log.printf(
        "listening on %s://%s:%d (data: %s)",
        local_scheme, cfg.host, cfg.port, data_dir,
    )
    if join_cluster_ref is not None:
        from pilosa_tpu_torch.utils.threads import spawn

        def announce():
            if join_cluster_ref.join_cluster(args.join):
                log.printf("joined cluster via %s", args.join)
            else:
                log.printf("join via %s timed out; still standalone", args.join)

        spawn("cluster-announce", announce)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        log.printf("shutting down")
        _stop(daemons, backend, holder)
    return 0


def _stop(daemons, backend, holder) -> None:
    """Stop the server's daemons (the runtime monitor and, in a cluster,
    anti-entropy, the failure detector and the divergence monitor), the
    backend's refresher, and close the holder."""
    for d in daemons:
        d.stop()
    if backend is not None:
        backend.stop_refresher()
    holder.close()


def _client_tls_context(args):
    """ssl context for the ctl-style client commands' --ca-certificate /
    --skip-verify trust flags (reference ctl's --tls.* flags). None for
    plain-http hosts or default system-store verification."""
    if getattr(args, "skip_verify", False):
        from pilosa_tpu_torch.server.config import TLSConfig

        return TLSConfig(skip_verify=True).client_context()
    if getattr(args, "ca_certificate", None):
        import ssl

        return ssl.create_default_context(cafile=args.ca_certificate)
    return None


def cmd_import(args) -> int:
    """CSV import: rows of row_id,column_id (or col,value with -v)
    (reference ctl/import.go)."""
    import urllib.error
    import urllib.request

    host = args.host.rstrip("/")
    ctx = _client_tls_context(args)
    index, field = args.index, args.field

    # create index/field if requested
    if args.create:
        for url, body in [
            (f"{host}/index/{index}", {}),
            (
                f"{host}/index/{index}/field/{field}",
                {"options": {"type": "int", "min": args.min, "max": args.max}}
                if args.value
                else {},
            ),
        ]:
            req = urllib.request.Request(
                url, data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json"},
            )
            try:
                urllib.request.urlopen(req, context=ctx)
            except urllib.error.HTTPError as e:
                if e.code != 409:  # only "already exists" is benign
                    raise

    rows, cols, values = [], [], []
    for path in args.files:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(",")
                if args.value:
                    cols.append(int(parts[0]))
                    values.append(int(parts[1]))
                else:
                    rows.append(int(parts[0]))
                    cols.append(int(parts[1]))

    payload = (
        {"columnIDs": cols, "values": values}
        if args.value
        else {"rowIDs": rows, "columnIDs": cols}
    )
    req = urllib.request.Request(
        f"{host}/index/{index}/field/{field}/import",
        data=json.dumps(payload).encode(),
        method="POST",
        headers={"Content-Type": "application/json"},
    )
    resp = urllib.request.urlopen(req, context=ctx)
    print(resp.read().decode().strip())
    return 0


def cmd_export(args) -> int:
    """reference ctl/export.go: exports the whole field across every
    shard and node by default; --shard restricts to one shard."""
    import urllib.request

    url = f"{args.host.rstrip('/')}/export?index={args.index}&field={args.field}"
    if args.shard is not None:
        url += f"&shard={args.shard}"
    resp = urllib.request.urlopen(
        urllib.request.Request(url), context=_client_tls_context(args)
    )
    sys.stdout.write(resp.read().decode())
    return 0


def cmd_check(args) -> int:
    """Offline consistency check of fragment + cache files
    (reference ctl/check.go:28-50)."""
    from pilosa_tpu_torch.roaring.codec import deserialize

    ok = True
    for path in args.files:
        try:
            with open(path, "rb") as f:
                data = f.read()
            b = deserialize(data)
            print(f"{path}: ok ({b.count()} bits, {len(b._cs)} containers, opN={b.op_n})")
        except Exception as e:
            ok = False
            print(f"{path}: CORRUPT: {e}")
    return 0 if ok else 1


def cmd_inspect(args) -> int:
    """Dump roaring container stats (reference ctl/inspect.go:30-60)."""
    from pilosa_tpu_torch.roaring.codec import deserialize

    for path in args.files:
        with open(path, "rb") as f:
            b = deserialize(f.read())
        type_counts: dict[str, int] = {}
        for key in b.keys():
            c = b.container(key)
            type_counts[c.typ] = type_counts.get(c.typ, 0) + 1
        print(f"{path}:")
        print(f"  bits: {b.count()}")
        print(f"  containers: {len(b._cs)} {type_counts}")
        print(f"  ops applied: {b.op_n}")
        if args.containers:
            for key in b.keys():
                c = b.container(key)
                print(f"  {key:>12} {c.typ:>6} n={c.n}")
    return 0


def cmd_generate_config(args) -> int:
    from pilosa_tpu_torch.server.config import Config

    sys.stdout.write(Config().toml_text())
    return 0


def cmd_config(args) -> int:
    """Validate a config file (reference `pilosa config`)."""
    from pilosa_tpu_torch.server.config import Config

    try:
        cfg = Config.from_sources(toml_path=args.config)
    except Exception as e:
        print(f"invalid config: {e}", file=sys.stderr)
        return 1
    print(json.dumps(cfg.to_dict(), indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pilosa_tpu_torch.cli", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("server", help="run the server")
    sp.add_argument("-d", "--data-dir", default=None)
    sp.add_argument("-b", "--bind", default=None)
    sp.add_argument("-c", "--config", default=None)
    sp.add_argument(
        "--executor", choices=["cuda", "cpu"], default=None,
        help="cuda (default): serve on the card, exit if it cannot be "
        "used; cpu: serve on the CPU oracle",
    )
    sp.add_argument(
        "--max-hbm-bytes", type=int, default=None, metavar="N",
        help="device byte budget of the resident stacks and row pages "
        "(0: none); a field over it is paged through the card",
    )
    sp.add_argument(
        "--preheat", action="store_true", default=None,
        help="upload every field's stacks at startup, on a thread of its own",
    )
    sp.add_argument(
        "--refresh-window-ms", type=int, default=None, metavar="N",
        help="splice the writes of each N-ms window into the resident stacks "
        "off the read path (0: reads refresh inline)",
    )
    sp.add_argument(
        "--heat-half-life", type=float, default=None, metavar="S",
        help="half-life in seconds of the resident stacks' heat (/debug/heat)",
    )
    sp.add_argument(
        "--mesh-devices", type=int, default=None, metavar="N",
        help="shard the stacks over the first N cards (-1: every visible "
        "card; 0 or 1: one); more than are visible refuses to start",
    )
    sp.add_argument(
        "--join",
        default=None,
        metavar="URI",
        help="announce to a live cluster's coordinator and join it "
        "(dynamic membership; no operator resize call needed)",
    )
    sp.add_argument("--verbose", action="store_true")
    sp.set_defaults(fn=cmd_server)

    def _tls_client_flags(sp):
        sp.add_argument(
            "--ca-certificate", default="",
            help="PEM CA bundle to verify an https:// host against",
        )
        sp.add_argument(
            "--skip-verify", action="store_true",
            help="accept any https:// server certificate (dev clusters)",
        )

    sp = sub.add_parser("import", help="import CSV data")
    sp.add_argument("--host", default="http://localhost:10101")
    _tls_client_flags(sp)
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-f", "--field", required=True)
    sp.add_argument("--create", action="store_true", help="create index/field first")
    sp.add_argument("-v", "--value", action="store_true", help="int-field value import")
    sp.add_argument("--min", type=int, default=0)
    sp.add_argument("--max", type=int, default=1 << 40)
    sp.add_argument("files", nargs="+")
    sp.set_defaults(fn=cmd_import)

    sp = sub.add_parser(
        "export", help="export a whole field (all shards/nodes) as CSV"
    )
    sp.add_argument("--host", default="http://localhost:10101")
    _tls_client_flags(sp)
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-f", "--field", required=True)
    sp.add_argument("-s", "--shard", type=int, default=None,
                    help="restrict to one shard (default: all)")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("check", help="check fragment files for corruption")
    sp.add_argument("files", nargs="+")
    sp.set_defaults(fn=cmd_check)

    sp = sub.add_parser("inspect", help="inspect roaring fragment files")
    sp.add_argument("--containers", action="store_true")
    sp.add_argument("files", nargs="+")
    sp.set_defaults(fn=cmd_inspect)

    sp = sub.add_parser("generate-config", help="print default config TOML")
    sp.set_defaults(fn=cmd_generate_config)

    sp = sub.add_parser("config", help="validate a config file")
    sp.add_argument("-c", "--config", required=True)
    sp.set_defaults(fn=cmd_config)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
