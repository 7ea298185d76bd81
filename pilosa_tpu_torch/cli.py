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

#: Settings that configure a plane the port's server does not have yet,
#: by their TOML key: (Config attribute, the plane). Nothing reads them,
#: so any value but the default is refused at startup, never ignored.
#: heat-half-life alone is accepted and inert (ROADMAP.md).
_UNREAD_SETTINGS = {
    "anti-entropy.interval": ("anti_entropy_interval", "multi-node serving"),
    "client-timeout": ("client_timeout", "multi-node serving"),
    "client-retries": ("client_retries", "multi-node serving"),
    "breaker-threshold": ("breaker_threshold", "multi-node serving"),
    "breaker-cooldown": ("breaker_cooldown", "multi-node serving"),
    "hedge-delay": ("hedge_delay", "multi-node serving"),
    "resize-lease": ("resize_lease", "cluster resize"),
    "migration-concurrency": ("migration_concurrency", "cluster resize"),
    "migration-bandwidth": ("migration_bandwidth", "cluster resize"),
    "read-repair-queue": ("read_repair_queue", "the replica consistency plane"),
    "cluster.coordinator": ("cluster.coordinator", "multi-node serving"),
    "cluster.replicas": ("cluster.replicas", "multi-node serving"),
    "tls.ca-certificate": ("tls.ca_certificate", "multi-node serving"),
    "tls.skip-verify": ("tls.skip_verify", "multi-node serving"),
}


def _setting(cfg, attr: str):
    for part in attr.split("."):
        cfg = getattr(cfg, part)
    return cfg


def _unported_knobs(cfg, args) -> list[str]:
    """The knobs this slice does not serve, each as a refusal message.
    Their defaults are off, so the default configuration serves; a knob
    set on is refused at startup rather than ignored."""
    from pilosa_tpu_torch.server.config import Config

    default = Config()
    out = [
        f"{key}: {plane} is not ported yet"
        for key, (attr, plane) in _UNREAD_SETTINGS.items()
        if _setting(cfg, attr) != _setting(default, attr)
    ]
    if cfg.executor not in ("cuda", "cpu"):
        out.append(f"executor={cfg.executor!r}: choose cuda or cpu")
    if cfg.preheat:
        out.append("preheat: stack preheating is not ported yet")
    if cfg.refresh_window_ms > 0:
        out.append("refresh-window-ms: windowed device refresh is not ported yet")
    if cfg.mesh_devices not in (0, 1):
        out.append("mesh-devices: the multi-device mesh is not ported yet")
    if cfg.profile_port:
        out.append("profile.port: the device profiler server is not ported yet")
    if getattr(args, "join", None):
        out.append("--join: multi-node serving is not ported yet")
    if cfg.cluster.hosts:
        out.append("cluster.hosts: multi-node serving is not ported yet")
    return [f"{m} ({_ROADMAP})" for m in out]


def _saved_cluster_size(data_dir: str) -> int:
    """Members of the topology persisted in data_dir (0 when none)."""
    from pilosa_tpu_torch.cluster.topology import TOPOLOGY_FILE, load_topology

    saved = load_topology(os.path.join(data_dir, TOPOLOGY_FILE))
    return len(saved["nodes"]) if saved else 0


def cmd_server(args) -> int:
    """Serve one node: --executor=cuda (the default) on the card, which
    exits non-zero where the card cannot be used; --executor=cpu on the
    CPU oracle, by explicit choice only."""
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
    if _saved_cluster_size(data_dir) > 1:
        refused.append(
            "a persisted multi-node topology: multi-node serving is not "
            f"ported yet ({_ROADMAP})"
        )
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

            # max-hbm-bytes: the device byte budget (0: none). A field over
            # it is paged through the card a row at a time.
            backend = CUDABackend(holder, max_bytes=cfg.max_hbm_bytes or None)
        except Exception as e:  # noqa: BLE001 — reported, never served around
            log.printf(
                "executor=cuda: %s; not serving (--executor=cpu runs the "
                "CPU oracle)", e,
            )
            holder.close()
            return 1
        log.printf("executor=cuda: device backend on %s (%s), max-hbm-bytes %d",
                   backend.device, torch.cuda.get_device_name(backend.device),
                   cfg.max_hbm_bytes)
    executor = Executor(
        holder, backend=backend if backend is not None else CPUBackend(holder)
    )
    if backend is not None:
        # Cross-request batching of device legs (exec/batcher.py); the CPU
        # oracle gets none, as in the reference.
        from pilosa_tpu_torch.exec.batcher import ShardLegBatcher

        executor.batcher = ShardLegBatcher(backend, window=cfg.batch_window)
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

    from pilosa_tpu_torch.utils.monitor import RuntimeMonitor

    monitor = RuntimeMonitor(holder, backend)
    # SLO objectives (config `slo`): the monitor's poll loop keeps the
    # windowed histogram snapshots /debug/slo evaluates them against.
    monitor.slo = cfg.slo
    api.slo = cfg.slo
    api.monitor = monitor
    daemons = [monitor.start()]

    local_scheme = "https" if cfg.tls.enabled else "http"
    server = Server(api, host=cfg.host, port=cfg.port, tls=cfg.tls)  # binds
    log.printf(
        "listening on %s://%s:%d (data: %s)",
        local_scheme, cfg.host, cfg.port, data_dir,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        log.printf("shutting down")
        for d in daemons:
            d.stop()
        holder.close()
    return 0


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
        "--join",
        default=None,
        metavar="URI",
        help="join a live cluster (refused: multi-node serving is not "
        "ported yet)",
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
