"""Server configuration (reference server/config.go:48 Config).

Three sources, lowest to highest precedence: TOML file, environment
variables (PILOSA_TPU_*), command-line flags — same layering as the
reference's viper/pflag stack (reference docs/configuration.md:20-34).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional

try:  # py3.11+ stdlib; gated so a 3.10 runtime still boots servers
    import tomllib  # configured via env/flags (TOML files raise clearly)
except ModuleNotFoundError:  # pragma: no cover — interpreter-dependent
    tomllib = None


@dataclass
class ClusterConfig:
    coordinator: bool = False
    replicas: int = 1
    hosts: list[str] = field(default_factory=list)


@dataclass
class TLSConfig:
    """reference server/tlsconfig.go:1-40 + config.go:120-130: serve
    HTTPS when certificate+key are set; the internal client verifies
    peers against ca_certificate (or the system store), or skips
    verification entirely with skip_verify (self-signed dev clusters)."""

    certificate: str = ""  # PEM cert (+chain) path; empty = plain HTTP
    key: str = ""  # PEM private key path
    ca_certificate: str = ""  # PEM CA bundle for peer verification
    skip_verify: bool = False

    @property
    def enabled(self) -> bool:
        return bool(self.certificate and self.key)

    def server_context(self):
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certificate, self.key)
        return ctx

    def client_context(self):
        """ssl context for OUTBOUND peer calls (internal client). Built
        whenever any TLS field is set — a node can be a plain-HTTP
        client of an HTTPS cluster during migration."""
        import ssl

        if self.skip_verify:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            return ctx
        return ssl.create_default_context(
            cafile=self.ca_certificate or None
        )


@dataclass
class Config:
    data_dir: str = "~/.pilosa-tpu"
    bind: str = "localhost:10101"
    executor: str = "cuda"  # cuda | cpu  (the --executor=cuda switch)
    max_writes_per_request: int = 5000
    log_path: str = ""
    verbose: bool = False
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    tls: TLSConfig = field(default_factory=TLSConfig)
    anti_entropy_interval: float = 600.0  # seconds (reference: 10m)
    metric_service: str = "memory"  # memory | none
    long_query_time: float = 0.0
    # Optional fixed leg-coalescing sleep in seconds (exec/batcher.py).
    # 0 (default) = backpressure batching: an uncontended single Count
    # dispatches immediately with no added latency, and requests arriving
    # during the in-flight device round trip coalesce into the next batch
    # (the fixed window taxed every lone query ~2 ms for no
    # batching benefit). Set >0 only to force deterministic batch windows.
    batch_window: float = 0.0
    # Pack + upload every field's device stack in the background at
    # startup so first queries skip the cold upload (off by default: it
    # fronts residency for ALL fields, wanted only on read-serving nodes).
    preheat: bool = False
    # TCP port of the device trace server (the reference's profile.*
    # config, server/config.go:153-155): GET /trace?seconds=S there answers
    # a Chrome trace of the card's kernels and the requests' pilosa.*
    # ranges (utils/devtrace.py). 0 = off. Python CPU profiling needs no
    # config — it's always-available via /debug/pprof/* (utils/profiler.py).
    profile_port: int = 0
    # Internal HTTP client timeout in seconds (peer queries, probes,
    # broadcasts). The SIGSTOP/partition tests lower it so hung-peer
    # retries happen in test time (reference Cluster.stuttering timeouts).
    client_timeout: float = 30.0
    # -- data-plane resilience ----------------------------------
    # Default per-query deadline in seconds when the client supplies
    # neither ?timeout= nor X-Pilosa-Deadline. 0 = no default budget.
    query_timeout: float = 0.0
    # Transport-error retries for idempotent peer GETs (fragment sync,
    # probes, federation scrapes); jittered backoff between attempts.
    client_retries: int = 1
    # Per-peer circuit breaker: consecutive transport failures before the
    # breaker opens, and the base cooldown (jittered, doubling per
    # consecutive reopen up to 30x) before a half-open probe.
    breaker_threshold: int = 3
    breaker_cooldown: float = 1.0
    # Hedged shard reads: a remote scatter-gather leg silent for this
    # many seconds is re-launched at the next live replica (first result
    # wins). 0 disables hedging.
    hedge_delay: float = 0.25
    # -- cluster lifecycle --------------------------------------
    # Follower-side resize lease in seconds: a node frozen in RESIZING
    # that hears neither a coordinator heartbeat nor a terminal status
    # for this long rolls itself back to NORMAL on the old topology
    # (the coordinator-crash escape hatch).
    resize_lease: float = 90.0
    # Concurrent fragment fetches while following a resize instruction.
    migration_concurrency: int = 2
    # Aggregate migration fetch bandwidth cap in bytes/s (0 = uncapped)
    # so a resize cannot saturate the links the serving path shares.
    migration_bandwidth: int = 0
    # -- replica consistency plane -----------------------------
    # Bound on the read-repair probe queue (cluster/consistency.py): a
    # hedge race's two answers enqueue one background checksum diff;
    # past this depth probes are dropped (read_repair_dropped_total —
    # the periodic anti-entropy sweep backstops them) so a divergence
    # storm can never buffer unboundedly. 0 disables the monitor.
    read_repair_queue: int = 128
    # In-flight /query admission cap (server/http.py): past this many
    # concurrently executing queries, new ones are shed with 429 +
    # Retry-After + code=overloaded (http_requests_shed_total) instead
    # of queueing until the kernel RSTs the accept backlog. 0 = no cap.
    max_inflight: int = 0
    # -- write-plane backpressure -------------------------------
    # Cap on concurrently in-flight import request bytes per node: past
    # it new /import bodies are shed with 429 + Retry-After +
    # code=import-overloaded (import_shed_total{reason=inflight-bytes})
    # instead of buffering toward OOM. A single request larger than the
    # cap is still admitted when nothing else is in flight. 0 = no cap.
    max_import_bytes: int = 0
    # Cap on the node's pending-WAL depth (un-snapshotted op records,
    # the wal_pending_ops gauge): past it imports answer 503 +
    # Retry-After + code=wal-backlog until the background snapshot
    # plane catches up. 0 = no cap.
    max_pending_wal: int = 0
    # -- read/write plane isolation ----------------------------
    # Token-bucket cap in bytes/s on the background snapshot rewrite's
    # unlocked serialize+write middle (core/fragment.py): paces the
    # rewrite's disk pressure so a churn burst cannot saturate the I/O
    # the read plane shares. 0 = uncapped.
    snapshot_bandwidth: int = 0
    # Concurrent background snapshot rewrites across ALL fragments (the
    # global snapshot scheduler's worker-pool size). Before r19 each
    # fragment past MAX_OP_N spawned its own thread — a 64-fragment
    # churn burst meant 64 concurrent O(storage) rewrites.
    snapshot_concurrency: int = 2
    # Windowed device-refresh coalescing: dirty shards
    # accumulate for this many milliseconds and flush as ONE incremental
    # splice round per stack, instead of every read paying the splice
    # inline after every write. Reads landing mid-window still force the
    # splice (freshness is never traded away). 0 = off (inline-only).
    refresh_window_ms: int = 0
    # SLO-adaptive ingest derating (server/api.py + utils/monitor.py):
    # when a read-latency SLO objective is burning, import admission
    # sheds a growing fraction of requests with 429 + scaled Retry-After
    # (import_derated_total{reason=read-slo}), relaxing on recovery.
    ingest_derate: bool = True
    # -- result cache ------------------------------------------
    # Byte budget for the epoch-tagged result cache (exec/rescache.py):
    # terminal answers (Count/Row/TopN/Sum/Min/Max/GroupBy) served from
    # memory while their journal-derived epoch vector still matches.
    # 0 = disabled (matching the max-inflight convention).
    max_result_cache_bytes: int = 0
    # Bounded-staleness contract: serve a generation-mismatched cached
    # answer when every covered view is at most this many (process-
    # global) write generations behind. 0 = exact-epoch only (default).
    max_staleness: int = 0
    # Master switch: false keeps the cache out even when a byte budget
    # is set (the bench's enabled-vs-disabled same-run comparison).
    cache_enabled: bool = True
    # Device-memory residency budget in bytes for the CUDA backend's
    # field stacks (SURVEY §7 hard part c). 0 = unbounded; over-budget
    # fields serve via row paging instead of whole-stack residency.
    max_hbm_bytes: int = 0
    # Half-life (seconds) of the HBM block-heat EWMA: how
    # fast an idle block's decayed-access-frequency heat halves. Short
    # half-lives track phase changes quickly but forget the working set
    # over a lull; the 5-minute default matches the SLO fast window.
    heat_half_life: float = 300.0
    # Shard the device stacks over this many cards (a mesh in one process,
    # parallel/mesh.py): 0 or 1 = one device, -1 = every visible card. A
    # count past the visible cards makes the server refuse to start.
    mesh_devices: int = 0
    # -- latency SLO objectives --------------------------------
    # Each objective: {metric, quantile, threshold_s, window_s} —
    # "quantile of <metric> must stay under threshold_s seconds over
    # window_s". Evaluated from windowed histogram snapshots at
    # GET /debug/slo with fast-5m/slow-1h burn rates. TOML spelling is
    # [[slo]] tables (keys metric / quantile / threshold / window); env
    # PILOSA_TPU_SLO takes the same list as JSON.
    slo: list = field(default_factory=list)

    @staticmethod
    def _normalize_slo(entries) -> list:
        from pilosa_tpu_torch.utils.stats import BUCKET_BOUNDS

        out = []
        for e in entries or ():
            if not isinstance(e, dict) or not e.get("metric"):
                raise ValueError(f"invalid slo objective: {e!r}")
            q = float(e.get("quantile", 0.99))
            thr = float(e.get("threshold_s", e.get("threshold", 1.0)))
            win = float(e.get("window_s", e.get("window", 3600.0)))
            # Range checks at config load, not at evaluation: `quantile
            # = 99` (the percent-vs-fraction typo) would otherwise page
            # forever with a ~1e9 burn rate instead of failing boot.
            if not 0.0 < q < 1.0:
                raise ValueError(
                    f"slo quantile must be in (0, 1), got {q!r}: {e!r}"
                )
            if thr <= 0.0:
                raise ValueError(f"slo threshold must be > 0: {e!r}")
            # The histogram's top finite bound is the largest threshold
            # the bucket CDF can evaluate: past it every observation in
            # the +Inf bucket reads as compliant and the objective can
            # never page — reject rather than silently never alert.
            if thr > BUCKET_BOUNDS[-1]:
                raise ValueError(
                    f"slo threshold {thr}s exceeds the largest histogram "
                    f"bucket bound ({BUCKET_BOUNDS[-1]:g}s): {e!r}"
                )
            if win <= 0.0:
                raise ValueError(f"slo window must be > 0: {e!r}")
            out.append(
                {
                    "metric": str(e["metric"]),
                    "quantile": q,
                    "threshold_s": thr,
                    "window_s": win,
                }
            )
        return out

    def _split_bind(self) -> tuple[str, int]:
        """Handles host:port, :port, bare host, [v6]:port, and bare IPv6."""
        b = self.bind
        if b.startswith("["):  # [::1]:10101
            host, _, rest = b[1:].partition("]")
            port = int(rest[1:]) if rest.startswith(":") and rest[1:] else 10101
            return host or "localhost", port
        if b.count(":") > 1:  # bare IPv6 address, no port
            return b, 10101
        host, _, port_s = b.partition(":")
        return host or "localhost", int(port_s) if port_s else 10101

    @property
    def host(self) -> str:
        return self._split_bind()[0]

    @property
    def port(self) -> int:
        return self._split_bind()[1]

    def to_dict(self) -> dict[str, Any]:
        return {
            "data-dir": self.data_dir,
            "bind": self.bind,
            "executor": self.executor,
            "max-writes-per-request": self.max_writes_per_request,
            "log-path": self.log_path,
            "verbose": self.verbose,
            "anti-entropy": {"interval": self.anti_entropy_interval},
            "metric": {"service": self.metric_service},
            "cluster": {
                "coordinator": self.cluster.coordinator,
                "replicas": self.cluster.replicas,
                "hosts": self.cluster.hosts,
            },
            "tls": {
                "certificate": self.tls.certificate,
                "key": self.tls.key,
                "ca-certificate": self.tls.ca_certificate,
                "skip-verify": self.tls.skip_verify,
            },
            "long-query-time": self.long_query_time,
            "client-timeout": self.client_timeout,
            "batch-window": self.batch_window,
            "preheat": self.preheat,
            "max-inflight": self.max_inflight,
            "max-import-bytes": self.max_import_bytes,
            "max-pending-wal": self.max_pending_wal,
            "snapshot-bandwidth": self.snapshot_bandwidth,
            "snapshot-concurrency": self.snapshot_concurrency,
            "refresh-window-ms": self.refresh_window_ms,
            "ingest-derate": self.ingest_derate,
            "max-hbm-bytes": self.max_hbm_bytes,
            "heat-half-life": self.heat_half_life,
            "mesh-devices": self.mesh_devices,
            "max-result-cache-bytes": self.max_result_cache_bytes,
            "max-staleness": self.max_staleness,
            "cache-enabled": self.cache_enabled,
            "profile": {"port": self.profile_port},
            "query-timeout": self.query_timeout,
            "client-retries": self.client_retries,
            "breaker-threshold": self.breaker_threshold,
            "breaker-cooldown": self.breaker_cooldown,
            "hedge-delay": self.hedge_delay,
            "resize-lease": self.resize_lease,
            "migration-concurrency": self.migration_concurrency,
            "migration-bandwidth": self.migration_bandwidth,
            "read-repair-queue": self.read_repair_queue,
            "slo": [dict(o) for o in self.slo],
        }

    @staticmethod
    def from_sources(
        toml_path: Optional[str] = None, env: Optional[dict] = None, args: Optional[dict] = None
    ) -> "Config":
        cfg = Config()
        if toml_path:
            if tomllib is None:
                raise RuntimeError(
                    "TOML config files need Python 3.11+ (tomllib); "
                    "use PILOSA_TPU_* env vars or flags on this runtime"
                )
            with open(toml_path, "rb") as f:
                data = tomllib.load(f)
            cfg._apply_toml(data)
        cfg._apply_env(env if env is not None else dict(os.environ))
        if args:
            for k, v in args.items():
                if v is not None and hasattr(cfg, k):
                    setattr(cfg, k, v)
        return cfg

    def _apply_toml(self, data: dict) -> None:
        simple = {
            "data-dir": "data_dir",
            "bind": "bind",
            "executor": "executor",
            "max-writes-per-request": "max_writes_per_request",
            "log-path": "log_path",
            "verbose": "verbose",
            "long-query-time": "long_query_time",
            "batch-window": "batch_window",
            "preheat": "preheat",
            "client-timeout": "client_timeout",
            "max-inflight": "max_inflight",
            "max-import-bytes": "max_import_bytes",
            "max-pending-wal": "max_pending_wal",
            "snapshot-bandwidth": "snapshot_bandwidth",
            "snapshot-concurrency": "snapshot_concurrency",
            "refresh-window-ms": "refresh_window_ms",
            "ingest-derate": "ingest_derate",
            "max-hbm-bytes": "max_hbm_bytes",
            "heat-half-life": "heat_half_life",
            "mesh-devices": "mesh_devices",
            "max-result-cache-bytes": "max_result_cache_bytes",
            "max-staleness": "max_staleness",
            "cache-enabled": "cache_enabled",
            "query-timeout": "query_timeout",
            "client-retries": "client_retries",
            "breaker-threshold": "breaker_threshold",
            "breaker-cooldown": "breaker_cooldown",
            "hedge-delay": "hedge_delay",
            "resize-lease": "resize_lease",
            "migration-concurrency": "migration_concurrency",
            "migration-bandwidth": "migration_bandwidth",
            "read-repair-queue": "read_repair_queue",
        }
        for k, attr in simple.items():
            if k in data:
                setattr(self, attr, data[k])
        if "profile" in data and "port" in data["profile"]:
            self.profile_port = int(data["profile"]["port"])
        if "anti-entropy" in data and "interval" in data["anti-entropy"]:
            self.anti_entropy_interval = float(data["anti-entropy"]["interval"])
        if "metric" in data and "service" in data["metric"]:
            self.metric_service = data["metric"]["service"]
        c = data.get("cluster", {})
        self.cluster.coordinator = c.get("coordinator", self.cluster.coordinator)
        self.cluster.replicas = c.get("replicas", self.cluster.replicas)
        self.cluster.hosts = c.get("hosts", self.cluster.hosts)
        t = data.get("tls", {})
        self.tls.certificate = t.get("certificate", self.tls.certificate)
        self.tls.key = t.get("key", self.tls.key)
        self.tls.ca_certificate = t.get("ca-certificate", self.tls.ca_certificate)
        self.tls.skip_verify = t.get("skip-verify", self.tls.skip_verify)
        if "slo" in data:
            self.slo = self._normalize_slo(data["slo"])

    def _apply_env(self, env: dict) -> None:
        pre = "PILOSA_TPU_"
        mapping = {
            pre + "DATA_DIR": ("data_dir", str),
            pre + "BIND": ("bind", str),
            pre + "EXECUTOR": ("executor", str),
            pre + "VERBOSE": ("verbose", lambda v: v.lower() in ("1", "true")),
            pre + "LOG_PATH": ("log_path", str),
            pre + "MAX_WRITES_PER_REQUEST": ("max_writes_per_request", int),
            pre + "LONG_QUERY_TIME": ("long_query_time", float),
            pre + "METRIC_SERVICE": ("metric_service", str),
            pre + "CLUSTER_COORDINATOR": (
                "cluster.coordinator",
                lambda v: v.lower() in ("1", "true"),
            ),
            pre + "CLUSTER_REPLICAS": ("cluster.replicas", int),
            pre + "CLUSTER_HOSTS": ("cluster.hosts", lambda v: v.split(",") if v else []),
            pre + "ANTI_ENTROPY_INTERVAL": ("anti_entropy_interval", float),
            pre + "BATCH_WINDOW": ("batch_window", float),
            pre + "PREHEAT": ("preheat", lambda v: v.lower() in ("1", "true")),
            pre + "PROFILE_PORT": ("profile_port", int),
            pre + "CLIENT_TIMEOUT": ("client_timeout", float),
            pre + "MAX_INFLIGHT": ("max_inflight", int),
            pre + "MAX_IMPORT_BYTES": ("max_import_bytes", int),
            pre + "MAX_PENDING_WAL": ("max_pending_wal", int),
            pre + "SNAPSHOT_BANDWIDTH": ("snapshot_bandwidth", int),
            pre + "SNAPSHOT_CONCURRENCY": ("snapshot_concurrency", int),
            pre + "REFRESH_WINDOW_MS": ("refresh_window_ms", int),
            pre + "INGEST_DERATE": (
                "ingest_derate",
                lambda v: v.lower() in ("1", "true"),
            ),
            pre + "MAX_HBM_BYTES": ("max_hbm_bytes", int),
            pre + "HEAT_HALF_LIFE": ("heat_half_life", float),
            pre + "MESH_DEVICES": ("mesh_devices", int),
            pre + "MAX_RESULT_CACHE_BYTES": ("max_result_cache_bytes", int),
            pre + "MAX_STALENESS": ("max_staleness", int),
            pre + "CACHE_ENABLED": (
                "cache_enabled",
                lambda v: v.lower() in ("1", "true"),
            ),
            pre + "QUERY_TIMEOUT": ("query_timeout", float),
            pre + "CLIENT_RETRIES": ("client_retries", int),
            pre + "BREAKER_THRESHOLD": ("breaker_threshold", int),
            pre + "BREAKER_COOLDOWN": ("breaker_cooldown", float),
            pre + "HEDGE_DELAY": ("hedge_delay", float),
            pre + "RESIZE_LEASE": ("resize_lease", float),
            pre + "MIGRATION_CONCURRENCY": ("migration_concurrency", int),
            pre + "MIGRATION_BANDWIDTH": ("migration_bandwidth", int),
            pre + "READ_REPAIR_QUEUE": ("read_repair_queue", int),
            pre + "SLO": (
                "slo",
                lambda v: Config._normalize_slo(json.loads(v)) if v else [],
            ),
            pre + "TLS_CERTIFICATE": ("tls.certificate", str),
            pre + "TLS_KEY": ("tls.key", str),
            pre + "TLS_CA_CERTIFICATE": ("tls.ca_certificate", str),
            pre + "TLS_SKIP_VERIFY": (
                "tls.skip_verify",
                lambda v: v.lower() in ("1", "true"),
            ),
        }
        for key, (attr, conv) in mapping.items():
            if key in env:
                value = conv(env[key])
                if "." in attr:
                    obj_name, sub = attr.split(".")
                    setattr(getattr(self, obj_name), sub, value)
                else:
                    setattr(self, attr, value)

    def toml_text(self) -> str:
        """generate-config output (reference ctl/generate_config.go)."""
        c = self
        return (
            f'data-dir = "{c.data_dir}"\n'
            f'bind = "{c.bind}"\n'
            f'executor = "{c.executor}"\n'
            f"max-writes-per-request = {c.max_writes_per_request}\n"
            f'log-path = "{c.log_path}"\n'
            f"verbose = {str(c.verbose).lower()}\n"
            f"long-query-time = {c.long_query_time}\n"
            f"batch-window = {c.batch_window}\n"
            f"preheat = {str(c.preheat).lower()}\n"
            f"client-timeout = {c.client_timeout}\n"
            f"max-inflight = {c.max_inflight}\n"
            f"max-import-bytes = {c.max_import_bytes}\n"
            f"max-pending-wal = {c.max_pending_wal}\n"
            f"snapshot-bandwidth = {c.snapshot_bandwidth}\n"
            f"snapshot-concurrency = {c.snapshot_concurrency}\n"
            f"refresh-window-ms = {c.refresh_window_ms}\n"
            f"ingest-derate = {str(c.ingest_derate).lower()}\n"
            f"max-hbm-bytes = {c.max_hbm_bytes}\n"
            f"heat-half-life = {c.heat_half_life}\n"
            f"mesh-devices = {c.mesh_devices}\n"
            f"max-result-cache-bytes = {c.max_result_cache_bytes}\n"
            f"max-staleness = {c.max_staleness}\n"
            f"cache-enabled = {str(c.cache_enabled).lower()}\n"
            f"query-timeout = {c.query_timeout}\n"
            f"client-retries = {c.client_retries}\n"
            f"breaker-threshold = {c.breaker_threshold}\n"
            f"breaker-cooldown = {c.breaker_cooldown}\n"
            f"hedge-delay = {c.hedge_delay}\n"
            f"resize-lease = {c.resize_lease}\n"
            f"migration-concurrency = {c.migration_concurrency}\n"
            f"migration-bandwidth = {c.migration_bandwidth}\n"
            f"read-repair-queue = {c.read_repair_queue}\n"
            + "".join(
                "\n[[slo]]\n"
                # json.dumps: a tagged metric spelling like
                # query_seconds{call="Count"} carries double quotes that
                # must be escaped or the emitted TOML can't round-trip.
                f'metric = {json.dumps(o["metric"])}\n'
                f"quantile = {o['quantile']}\n"
                f"threshold = {o['threshold_s']}\n"
                f"window = {o['window_s']}\n"
                for o in c.slo
            )
            + f"[profile]\nport = {c.profile_port}\n"
            "\n[tls]\n"
            f'certificate = "{c.tls.certificate}"\n'
            f'key = "{c.tls.key}"\n'
            f'ca-certificate = "{c.tls.ca_certificate}"\n'
            f"skip-verify = {str(c.tls.skip_verify).lower()}\n"
            "\n[anti-entropy]\n"
            f"interval = {c.anti_entropy_interval}\n"
            "\n[metric]\n"
            f'service = "{c.metric_service}"\n'
            "\n[cluster]\n"
            f"coordinator = {str(c.cluster.coordinator).lower()}\n"
            f"replicas = {c.cluster.replicas}\n"
            f"hosts = {c.cluster.hosts!r}\n".replace("'", '"')
        )
