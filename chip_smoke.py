#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pilosa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--root DIR]

Builds the hand-written CUDA kernels from pilosa_tpu_torch/ops/csrc with
nvcc, then runs the phases below. ``--root DIR`` drives the
pilosa_tpu_torch package of another checkout DIR instead of this script's
own (its kernels built under DIR), so that two trees can be compared in
turns by the same script on one card.

1. card: prints the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, and the kernel build seconds with ptxas's report
   (ops/csrc/bmma.cu: K1, K2 and K4 to K7 on the tensor cores' binary MMA,
   and the probe; ops/csrc/bitcount.cu: K3);
   then the AND-popcount rate probe (ops/csrc/bmma.cu, ops/probe.py): the
   b1 tensor-core MMA's and the CUDA cores' popcount rates in bit-products
   a second, which set the kernels' operations bounds;
2. main path, at full size: a 1B-column index (fields f and g, 954 shards
   of 2^20 columns, 8 rows, bit density 0.05, the content of bench.py's
   build_index) built through the port's Holder / Field.import_bits and
   queried through Executor(holder, backend=CUDABackend(holder)): single
   Count(Intersect|Union|Difference|Xor(Row, Row)) calls (popcount kernel),
   one request of 16 fused Counts (per-shard pair kernel: cold, cached, and
   with its pair-cache entry dropped, profiled) and Row(f=2);
   then a 256 x 256-row field pair over 128 shards, whose per-shard pair
   table is past the retention gate, so it takes the shard-summed pair
   kernel (the binary GEMM on the tensor cores), cold and then with the
   pair cache dropped. Every answer is checked against the port's CPU
   oracle (Executor(holder, backend=CPUBackend(holder))). The kernels' launch
   counters are zeroed before this phase and read after it: every kernel
   of the count path must have launched. Launches per request are printed
   beside it;
3. GroupBy on the same index, with bench.py's third field h (4 rows of
   n_bits // 4 columns per shard): bench.py's four GroupBy queries, a
   filtered 3-field one and a limit/offset one, through the same Executor.
   Every group's count must equal the Count of its rows' Intersect through
   the port's Count path, every combination left out must count 0, and the
   same queries over the first 32 shards must equal the CPU oracle's.
   Launch counters are zeroed before the requests and read after: the
   group-tile kernels must have launched, and each request launches what
   its route should. No GroupBy may be routed to the CPU oracle. Then a
   2-shard index whose 70-row extra field crosses the 64-slot tile
   boundary, on the maintained and the generic route;
4. each kernel against its plain PyTorch version on the card, on the
   inputs the main path gave it and at edge shapes (pair faces off 8 and
   16 rows, word axes that are not a multiple of 8, 1 to 9 group slots
   with inactive ones, odometers of 1 to 256 slots), exactly; the odometer
   kernels also at K = 64 (extras h and g, g also being G; 954 shards,
   held against the plain versions over the first 64 shards, K7 over the
   last 64 too); with its median time by CUDA events
   around a wrapper call, its own time by CUDA events around back-to-back
   bare launches (kernel_ms: without the wrapper's host checks, output
   zeroing and slot-table uploads), the plain version's time and
   its bound (each kernel's earlier time, recorded before it moved to the
   tensor cores, is printed on a line of its own and is not measured
   here); and the cross-check of
   the odometer kernels (nary_stats, nary_stats_pershard) against the
   group tensor that GroupBy served (one kernel body on both sides: the
   plain versions are the independent check);
5. a small holder with an existence field: the whole Count/Row/Not/All
   query list through two write-churn epochs, checked against the CPU
   oracle after each; the resident stacks must be spliced, not rebuilt,
   and no query may be routed to the CPU oracle.

cpu_routed_total is printed after each phase.

Prints a JSON line of every kernel, then, last, one JSON object whose
"ok" is true. Any failed check raises; the exit code is then not 0.
With no CUDA card the script exits with code 2 before doing anything.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SHARDS = 954  # 954 * 2^20 > 1e9 columns
ROWS = 8
DENSITY = 0.05
# The wide pair: Rf = Rg = 256 over 128 shards makes the per-shard table
# 128 * (256*256 + 512) * 4 bytes > MAX_PAIR_PERSHARD_BYTES (32 MiB).
WIDE_SHARDS = 128
WIDE_ROWS = 256
WIDE_BITS_PER_ROW = 256

# Popcount issue rate a clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0). Times the
# card's SM count and maximum SM clock (read in phase_card) it gives the
# CUDA cores' popcount route; the probe phase adds the measured b1 MMA
# route and the published int8 one (ops/probe.py routes), and each
# kernel's bound takes the fastest.
POPC_PER_SM_CLOCK = 16
RATES = {}
ROUTES = {}

# GroupBy: bench.py's 3-field query, its groups checked through the Count
# path, and its answers over the first ORACLE_SHARDS shards against the CPU
# oracle (the host iterator over 954 shards would take minutes).
H_ROWS = 4
ORACLE_SHARDS = 32
GROUP_QUERIES = [
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), filter=Row(f=2))",
    "GroupBy(Rows(f), Rows(g), Rows(h))",
    "GroupBy(Rows(f), Rows(g), Rows(h), filter=Row(g=1))",
    "GroupBy(Rows(f), Rows(g), Rows(h), limit=5, offset=3)",
]
# The 2-shard cardinality index: a 70-row fully-live extra field, so the
# live combinations span two 64-slot tiles.
CARD_SHARDS = 2
CARD_ROWS = 70

REPLACES = {
    "pair_stats_pershard": "pilosa_tpu/ops/kernels.py:142",
    "pair_stats": "pilosa_tpu/ops/kernels.py:81",
    # Not a Pallas kernel: the popcount-reduce of the fused count program.
    "popcount_rows": "pilosa_tpu/exec/tpu.py:2074",
    # Fused-XLA tile programs of the serving GroupBy.
    "group_tile_stats": "pilosa_tpu/ops/kernels.py:642",
    "group_tile_stats_pershard": "pilosa_tpu/ops/kernels.py:656",
    "nary_stats": "pilosa_tpu/ops/kernels.py:253",
    "nary_stats_pershard": "pilosa_tpu/ops/kernels.py:349",
}
COUNT_KERNELS = ("pair_stats_pershard", "pair_stats", "popcount_rows")
# Each kernel's earlier time at the shape timed here, recorded by this
# script on an NVIDIA H100 80GB HBM3 at 700.00 W on the CUDA cores: K2 and
# K4 before they moved to the tensor cores, K1 and K5 before they followed
# (events around a wrapper call); K6 and K7 before they followed, their
# kernel_ms (events around bare launches); K3, which has not moved, from
# the same run as K2's and K4's. Printed for comparison on a line of its
# own, never in the kernels line, whose numbers are all of this run.
EARLIER_MS = {
    "pair_stats_pershard": 1.1817, "pair_stats": 141.80, "popcount_rows": 0.06478,
    "group_tile_stats": 4.0985, "group_tile_stats_pershard": 3.8494,
    "nary_stats kernel_ms": 6.4030, "nary_stats_pershard kernel_ms": 6.4061,
    "pair_stats at S=954, 8 x 8": 1.1986,
}
# The odometer kernels' second shape: K = 64 over the extras (h, g), from
# the resident stacks (so g is both G and an extra, and its bound counts g
# once), whose output is held against the plain versions over the first
# K64_SHARDS shards, K7's over the last as well (the plain pass over all
# 954 would take about a minute).
K64_SHARDS = 64


def log(*args) -> None:
    print(*args, flush=True)


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of fn() in ms, by CUDA events around each call."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 5):
    """(first call ms, median of `reps` further calls ms, last result) on
    the host clock; every call ends in a device readback."""
    t0 = time.perf_counter()
    out = fn()
    first = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return first, statistics.median(times), out


def kernel_ms(launch, n: int = 20) -> float:
    """A kernel's own device ms: CUDA events around n back-to-back calls of
    ``launch``, which enqueues the bare kernel on inputs, output and slot
    tables staged once (no zeroing, no host-to-device copy), over n. The
    launches queue behind each other, so the host's cost of a launch is
    hidden after the first. (torch.profiler lost between a third and all
    of the kernels of such back-to-back windows on the card, so it does not
    time them.)"""
    import torch

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# Bare launches for kernel_ms: each enqueues one kernel through the
# package's own launch helpers, its output and slot tables allocated once.
# Outputs accumulate across calls (int32 atomics wrap): only the time is read.


def bare_pair(name, f, g):
    import torch

    from pilosa_tpu_torch.ops import kernels as K

    width = K.pair_stats_width(f.shape[1], g.shape[1])
    shape = (f.shape[0], width) if name == "pair_stats_pershard" else (width,)
    out = torch.zeros(shape, dtype=torch.int32, device=f.device)
    return lambda: K._launch_pair(name, f, g, out)


def bare_group(name, f, g, extras, rows_idx=None, active=None, filt=None):
    """A group kernel's bare launch: the slot table's kernels (K4, K5) take
    rows_idx and active, the odometer kernels (K6, K7) neither."""
    from pilosa_tpu_torch.ops import kernels as K

    if rows_idx is None:
        rows = act = None
        n_slots = K._odometer_slots(extras)
    else:
        rows, act = (t.to(f.device) for t in K._slot_table(name, extras, rows_idx, active))
        n_slots = rows.shape[0]
    out = K._group_out(f, g, n_slots, name.endswith("_pershard"))
    return lambda: K._launch_group(name, f, g, extras, filt, rows, act, out, n_slots)


def bare_popcount_rows(x):
    import torch

    from pilosa_tpu_torch.ops import build
    from pilosa_tpu_torch.ops import kernels as K

    lib = build.library(K._LIBRARY["popcount_rows"])
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch():
        rc = lib.popcount_rows_launch(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                                      stream)
        check(rc == 0, f"popcount_rows: CUDA launch failed with cudaError {rc}")

    return launch


def device_share(fn, label: str, n: int = 10) -> None:
    """Profile n calls of fn with torch.profiler: wall ms per call, device
    kernel ms per call and the device's busy share, and the kernels that
    took the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((us, ev.count, ev.key))
    dev_us = sum(r[0] for r in rows)
    log(f"profile {label}: wall {wall_us / n / 1e3:.4f} ms/call, device "
        f"{dev_us / n / 1e3:.4f} ms/call, device busy {dev_us / wall_us:.3f}")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        log(f"profile {label}:   {us / n / 1e3:.4f} ms/call x{count // n} {key[:90]}")


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------


def phase_card():
    import torch

    from pilosa_tpu_torch.ops import build, probe

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0]
    log(card_line)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr}")
    sm_hz = float(clk.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    RATES["popc"] = POPC_PER_SM_CLOCK * sms * sm_hz
    log(f"card: {sms} SMs, max SM clock {sm_hz / 1e6:.0f} MHz: popcount issue "
        f"rate {RATES['popc']:.4g}/s, memory {probe.HBM_BYTES_PER_S:.4g} B/s")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    build.library("bitcount")  # builds every kernel library, in parallel
    log(f"kernel build seconds: {build.build_seconds:.2f}")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())
    return card_line


def phase_probe(card_line):
    """The AND-popcount rate probe, and the routes the bounds take."""
    from pilosa_tpu_torch.ops import probe

    rates = probe.and_popc_rates()
    log(f"probe: {card_line}: b1 AND-popc MMA {rates['b1']:.6e} bit-products/s, "
        f"CUDA-core popcount {rates['popc']:.6e} bit-products/s; "
        f"b1 / popcount {rates['b1'] / rates['popc']:.2f}")
    ROUTES.update(probe.routes(RATES["popc"], rates["b1"]))
    log("probe: bound routes, bit-products/s " + json.dumps(ROUTES))
    return rates


# ---------------------------------------------------------------------------
# phase 2: the main path at full size
# ---------------------------------------------------------------------------


def build_bench_index(holder):
    """bench.py build_index: per shard, f and g hold ROWS * SHARD_WIDTH *
    DENSITY uniform columns per row, and h H_ROWS rows of n_bits // 4, all
    from SFC64(42)'s raw stream in that order."""
    import numpy as np

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    idx = holder.create_index("bench")
    n_bits = int(SHARD_WIDTH * DENSITY)
    bitgen = np.random.SFC64(42)
    mask = np.uint32(SHARD_WIDTH - 1)

    def rand_cols(shard, size):
        raw = bitgen.random_raw((size + 1) // 2).view(np.uint32)[:size]
        np.bitwise_and(raw, mask, out=raw)
        np.bitwise_or(raw, np.uint32(shard * SHARD_WIDTH), out=raw)
        return raw

    rows = np.repeat(np.arange(ROWS, dtype=np.uint8), n_bits)
    for fname in ("f", "g"):
        field = idx.create_field(fname)
        for shard in range(SHARDS):
            field.import_bits(rows, rand_cols(shard, rows.size))
    hrows = np.repeat(np.arange(H_ROWS, dtype=np.uint8), n_bits // 4)
    field = idx.create_field("h")
    for shard in range(SHARDS):
        field.import_bits(hrows, rand_cols(shard, hrows.size))


def build_wide_index(holder):
    import numpy as np

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    idx = holder.create_index("wide")
    rng = np.random.default_rng(7)
    rows = np.repeat(np.arange(WIDE_ROWS, dtype=np.uint64), WIDE_BITS_PER_ROW)
    for fname in ("a", "b"):
        field = idx.create_field(fname)
        for shard in range(WIDE_SHARDS):
            cols = rng.integers(0, SHARD_WIDTH, rows.size, dtype=np.uint64)
            field.import_bits(rows, cols + np.uint64(shard * SHARD_WIDTH))


def same_answers(a, b) -> bool:
    import numpy as np

    from pilosa_tpu_torch.core.row import Row

    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, Row) or isinstance(y, Row):
            if not (isinstance(x, Row) and isinstance(y, Row)):
                return False
            if not np.array_equal(x.columns(), y.columns()):
                return False
        elif x != y:
            return False
    return True


def phase_main(results: dict):
    import torch

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.utils.stats import global_stats

    holder = Holder(None).open()
    t0 = time.perf_counter()
    build_bench_index(holder)
    log(f"main: index build seconds {time.perf_counter() - t0:.1f} "
        f"({SHARDS} shards x 2 fields x {ROWS} rows, density {DENSITY}, "
        f"and h: {H_ROWS} rows)")
    t0 = time.perf_counter()
    build_wide_index(holder)
    log(f"main: wide index build seconds {time.perf_counter() - t0:.1f} "
        f"({WIDE_SHARDS} shards x 2 fields x {WIDE_ROWS} rows)")

    backend = CUDABackend(holder)
    dev = Executor(holder, backend=backend)
    oracle = Executor(holder, backend=CPUBackend(holder))
    routed0 = sum(global_stats.counter_totals("cpu_routed_total").values())

    singles = [
        "Count(Intersect(Row(f=1), Row(g=2)))",
        "Count(Union(Row(f=3), Row(g=0)))",
        "Count(Difference(Row(f=5), Row(g=5)))",
        "Count(Xor(Row(f=7), Row(g=4)))",
    ]
    verbs = ("Intersect", "Union", "Difference", "Xor")
    pair_request = " ".join(
        f"Count({verbs[k % 4]}(Row(f={k % ROWS}), Row(g={(3 * k + 1) % ROWS})))"
        for k in range(16)
    )
    wide_request = " ".join(
        f"Count({verbs[k % 4]}(Row(a={(37 * k) % WIDE_ROWS}), "
        f"Row(b={(101 * k + 5) % WIDE_ROWS})))"
        for k in range(16)
    )

    K.reset_launch_counts()
    latencies = {}
    answers = {}
    t0 = time.perf_counter()
    answers["cold"] = dev.execute("bench", singles[0])
    torch.cuda.synchronize()
    log(f"main: first query (stack build + upload) seconds "
        f"{time.perf_counter() - t0:.2f}; resident stack bytes "
        f"{backend.blocks.resident_bytes()}")
    for q in singles + ["Row(f=2)"]:
        first, med, out = host_ms(lambda q=q: dev.execute("bench", q))
        latencies[q] = {"first_ms": first, "median_ms": med}
        answers[q] = out
    device_share(lambda: dev.execute("bench", singles[0]), "single Count")
    device_share(lambda: dev.execute("bench", "Row(f=2)"), "Row(f=2)", n=2)
    per_request = {}

    def launches_of(label, fn):
        before = K.launch_counts()
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        per_request[label] = {k: v - before[k] for k, v in K.launch_counts().items()
                              if v != before[k]}
        return ms, out

    launches_of("single Count", lambda: dev.execute("bench", singles[0]))
    launches_of("Row(f=2)", lambda: dev.execute("bench", "Row(f=2)"))
    sweeps0 = global_stats.counter_totals("pair_stats_sweeps_total")
    first, answers[pair_request] = launches_of(
        "16-Count request, uncached", lambda: dev.execute("bench", pair_request))
    launches_of("16-Count request, cached", lambda: dev.execute("bench", pair_request))
    _, med, out = host_ms(lambda: dev.execute("bench", pair_request))
    check(same_answers(out, answers[pair_request]), "cached pair answers moved")
    latencies["16-Count pair request"] = {"first_ms": first, "median_cached_ms": med}
    check(sum(global_stats.counter_totals("pair_stats_sweeps_total").values())
          == sum(sweeps0.values()) + 1, "the 16-Count request did not sweep once")

    def pair_uncached():  # stacks resident, the f x g pair's cache entry dropped: one K1 sweep
        backend._pair_cache.pop(("bench", "f", "g"), None)
        return dev.execute("bench", pair_request)

    launches_of("16-Count request, cache entry dropped", pair_uncached)
    _, med, out = host_ms(pair_uncached)
    check(same_answers(out, answers[pair_request]), "uncached pair answers moved")
    latencies["16-Count pair request, uncached"] = {"median_ms": med}
    device_share(pair_uncached, "16-Count request, uncached")
    cold, answers[wide_request] = launches_of(
        "16-Count wide request", lambda: dev.execute("wide", wide_request))
    latencies["16-Count wide pair request (cold)"] = {"first_ms": cold}

    def wide_uncached():  # stacks resident, the wide pair's cache entry dropped: one K2 sweep
        for key in [k for k in backend._pair_cache if k[0] == "wide"]:
            del backend._pair_cache[key]
        return dev.execute("wide", wide_request)

    launches_of("16-Count wide request, uncached", wide_uncached)
    _, med, out = host_ms(wide_uncached)
    check(same_answers(out, answers[wide_request]), "uncached wide answers moved")
    latencies["16-Count wide pair request, uncached"] = {"median_ms": med}
    torch.cuda.synchronize()
    launches = K.launch_counts()
    log("main: launches per request " + json.dumps(per_request))
    want = {
        "single Count": {"popcount_rows": 1},
        "Row(f=2)": {},
        "16-Count request, uncached": {"pair_stats_pershard": 1},
        "16-Count request, cached": {},
        "16-Count request, cache entry dropped": {"pair_stats_pershard": 1},
        "16-Count wide request": {"pair_stats": 1},
        "16-Count wide request, uncached": {"pair_stats": 1},
    }
    for label, expect in want.items():
        check(per_request[label] == expect,
              f"main: {label} launched {per_request[label]}, expected {expect}")
    log("main: launches " + json.dumps(launches))
    log("main: latencies " + json.dumps(latencies))
    log(f"main: resident stack bytes {backend.blocks.resident_bytes()}")
    for name in COUNT_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")

    for q in singles + ["Row(f=2)", pair_request]:
        t0 = time.perf_counter()
        want = oracle.execute("bench", q)
        check(same_answers(answers[q], want), f"main: {q[:60]} disagrees with the oracle")
        log(f"main: oracle agrees on {q[:60]} ({time.perf_counter() - t0:.1f} s)")
    check(same_answers(answers["cold"], oracle.execute("bench", singles[0])),
          "main: cold query disagrees")
    check(same_answers(answers[wide_request], oracle.execute("wide", wide_request)),
          "main: wide pair request disagrees with the oracle")
    log("main: oracle agrees on the wide pair request")
    check(sum(global_stats.counter_totals("cpu_routed_total").values()) == routed0,
          "main: a query was routed to the CPU oracle")
    log("main: answers " + json.dumps(
        {q[:40]: [r if isinstance(r, int) else int(r.count()) for r in answers[q]]
         for q in singles + ["Row(f=2)"]}))
    log_routed("main")

    results["launches"] = launches
    a_stack, _ = backend.blocks.get("wide", holder.index("wide").field("a"),
                                    tuple(range(WIDE_SHARDS)))
    b_stack, _ = backend.blocks.get("wide", holder.index("wide").field("b"),
                                    tuple(range(WIDE_SHARDS)))
    check(a_stack.shape == (WIDE_SHARDS, WIDE_ROWS, 32768),
          f"a stack {tuple(a_stack.shape)}")
    return holder, backend, (a_stack, b_stack)


def log_routed(phase: str) -> None:
    from pilosa_tpu_torch.utils.stats import global_stats

    log(f"{phase}: cpu_routed_total " + json.dumps(
        global_stats.counter_totals("cpu_routed_total"), sort_keys=True))


def bench_stack(backend, holder, fname, shards=SHARDS):
    stack, _ = backend.blocks.get("bench", holder.index("bench").field(fname),
                                  tuple(range(shards)))
    return stack


# ---------------------------------------------------------------------------
# phase 3: GroupBy
# ---------------------------------------------------------------------------


def group_tuples(result):
    return [(tuple((fr.field, fr.row_id) for fr in g.group), g.count) for g in result]


def check_groups_by_count(dev, q, groups, filt):
    """Every group's count equals Count(Intersect(its rows [, filt])) on
    the port's Count path, and every combination left out counts 0."""
    import itertools

    heights = {"f": ROWS, "g": ROWS, "h": H_ROWS}
    fields = [c.split("(")[1].split(")")[0] for c in q.split("Rows")[1:]]
    combos = list(itertools.product(*(range(heights[f]) for f in fields)))
    counts = dev.execute("bench", " ".join(
        "Count(Intersect({}))".format(", ".join(
            [f"Row({f}={r})" for f, r in zip(fields, combo)] + ([filt] if filt else [])))
        for combo in combos))
    want = {tuple(zip(fields, combo)): n for combo, n in zip(combos, counts) if n}
    check(dict(groups) == want, f"groupby: {q} disagrees with the Count path")
    return len(combos)


def phase_groupby(holder, backend):
    """GroupBy at 954 shards through the main path's Executor."""
    import torch

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.utils.stats import global_stats

    dev = Executor(holder, backend=backend)
    oracle = Executor(holder, backend=CPUBackend(holder))
    routed_key = 'cpu_routed_total{call="GroupBy"}'
    routed0 = global_stats.counter_totals("cpu_routed_total").get(routed_key, 0)
    three = GROUP_QUERIES[3]
    per_request = {}
    latencies = {}
    answers = {}

    def request(label, q):
        before = K.launch_counts()
        t0 = time.perf_counter()
        out = dev.execute("bench", q)
        torch.cuda.synchronize()
        latencies[label] = (time.perf_counter() - t0) * 1e3
        per_request[label] = {k: v - before[k] for k, v in K.launch_counts().items()
                              if v != before[k]}
        return group_tuples(out[0])

    K.reset_launch_counts()
    for q in GROUP_QUERIES[:3]:
        answers[q] = request(q, q)
    answers[three] = request("3-field, cold", three)
    check(request("3-field, warm", three) == answers[three], "groupby: warm answer moved")
    answers[GROUP_QUERIES[4]] = request("3-field filtered", GROUP_QUERIES[4])
    answers[GROUP_QUERIES[5]] = request("3-field limit/offset", GROUP_QUERIES[5])
    torch.cuda.synchronize()
    launches = K.launch_counts()
    log("groupby: launches per request " + json.dumps(per_request))
    log("groupby: launches " + json.dumps(launches))
    want = {
        "GroupBy(Rows(f))": {"popcount_rows": 1},
        "GroupBy(Rows(f), Rows(g), filter=Row(f=2))": {"pair_stats": 1},
        "3-field, cold": {"popcount_rows": 1, "group_tile_stats_pershard": 1},
        "3-field, warm": {},
        "3-field filtered": {"popcount_rows": 1, "group_tile_stats": 1},
        "3-field limit/offset": {},
    }
    for label, expect in want.items():
        check(per_request[label] == expect,
              f"groupby: {label} launched {per_request[label]}, expected {expect}")
    for name in ("group_tile_stats", "group_tile_stats_pershard", "popcount_rows"):
        check(launches[name] > 0, f"kernel {name} was not launched on the GroupBy path")
    check(answers[GROUP_QUERIES[5]] == answers[three][3:8], "groupby: limit/offset window")

    # Timings: the re-dispatched sweep (tensor caches dropped, stacks
    # resident) and the warm request, with their device share.
    def sweep():
        backend._groupn_cache.clear()
        return dev.execute("bench", three)

    def uncached(q):
        def run():
            backend._agg_cache.clear()
            return dev.execute("bench", q)
        return run

    for label, fn in (("3-field sweep", sweep),
                      ("3-field warm", lambda: dev.execute("bench", three)),
                      ("3-field filtered sweep", uncached(GROUP_QUERIES[4])),
                      ("1-field sweep", uncached(GROUP_QUERIES[0])),
                      ("2-field, pair cache", lambda: dev.execute("bench", GROUP_QUERIES[1])),
                      ("2-field filtered sweep", uncached(GROUP_QUERIES[2]))):
        first, med, out = host_ms(fn)
        latencies[label + " median"] = med
    device_share(sweep, "3-field GroupBy, sweep")
    device_share(lambda: dev.execute("bench", three), "3-field GroupBy, warm")
    device_share(uncached(GROUP_QUERIES[4]), "3-field filtered GroupBy, sweep")
    log("groupby: latencies ms " + json.dumps(latencies))

    n_checked = 0
    for q, filt in ((GROUP_QUERIES[0], None), (GROUP_QUERIES[1], None),
                    (GROUP_QUERIES[2], "Row(f=2)"), (three, None),
                    (GROUP_QUERIES[4], "Row(g=1)")):
        n_checked += check_groups_by_count(dev, q, answers[q], filt)
    log(f"groupby: {n_checked} combinations agree with the Count path")
    log("groupby: groups " + json.dumps({q: len(a) for q, a in answers.items()}))
    check(global_stats.counter_totals("cpu_routed_total").get(routed_key, 0) == routed0,
          "groupby: a GroupBy was routed to the CPU oracle")

    stacks = {name: bench_stack(backend, holder, name) for name in ("f", "g", "h")}
    served = backend._groupn_cache[("groupn", "bench", ("f", "g", "h"))].stats

    # The same queries over the first shards, against the CPU oracle. This
    # replaces the resident stacks with 32-shard ones, so it runs last.
    sub = list(range(ORACLE_SHARDS))
    for q in GROUP_QUERIES:
        t0 = time.perf_counter()
        got = group_tuples(dev.execute("bench", q, shards=sub)[0])
        check(got == group_tuples(oracle.execute("bench", q, shards=sub)[0]),
              f"groupby: {q} over {ORACLE_SHARDS} shards disagrees with the oracle")
        log(f"groupby: oracle agrees on {q} over {ORACLE_SHARDS} shards "
            f"({len(got)} groups, {time.perf_counter() - t0:.1f} s)")
    check(global_stats.counter_totals("cpu_routed_total").get(routed_key, 0) == routed0,
          "groupby: a GroupBy was routed to the CPU oracle")
    log_routed("groupby")
    return launches, stacks, served


def phase_groupby_tiles():
    """A 2-shard index whose 70-row extra field is fully live: 8 x 8 x 70
    groups, 70 live combinations, so both routes cut 2 tiles."""
    import numpy as np

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils.stats import global_stats

    holder = Holder(None).open()
    idx = holder.create_index("card")
    rng = np.random.default_rng(19)
    for fname, nrows in (("f", ROWS), ("g", ROWS), ("e", CARD_ROWS)):
        field = idx.create_field(fname)
        for row in range(nrows):
            cols = np.concatenate([rng.integers(0, 4096, 1500, dtype=np.uint64)
                                   + np.uint64(s * SHARD_WIDTH) for s in range(CARD_SHARDS)])
            field.import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    oracle = Executor(holder, backend=CPUBackend(holder))
    q = "GroupBy(Rows(f), Rows(g), Rows(e))"
    want = group_tuples(oracle.execute("card", q)[0])
    for route, budget in (("maintained", None), ("generic", 1)):
        backend = CUDABackend(holder)
        if budget is not None:
            backend.MAX_PAIR_PERSHARD_BYTES = budget
        tiles0 = sum(global_stats.counter_totals("groupby_tiles_total").values())
        got = group_tuples(Executor(holder, backend=backend).execute("card", q)[0])
        tiles = sum(global_stats.counter_totals("groupby_tiles_total").values()) - tiles0
        check(tiles == 2, f"tiles: the {route} route cut {tiles} tiles, expected 2")
        check(got == want, f"tiles: the {route} route disagrees with the oracle")
        log(f"tiles: {route} route: 2 tiles, {len(got)} groups agree with the oracle")
    log_routed("tiles")
    holder.close()


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_bound(work):
    """(bound ms, "bytes" or "operations", route) of (bytes, bit-products)
    at this card's routes (ops/probe.py bound)."""
    from pilosa_tpu_torch.ops import probe

    sec, by, route = probe.bound(*work, ROUTES)
    return sec * 1e3, by, route


def kernel_line(name, ms, k_ms, plain_ms, work, err, launches):
    from pilosa_tpu_torch.ops import kernels as K

    bound_ms, by, route = kernel_bound(work)
    return {
        "name": name, "route": "cuda",
        "source": f"pilosa_tpu_torch/ops/csrc/{K._LIBRARY[name]}.cu",
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": err, "ms": ms, "kernel_ms": k_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
        "bound_route": route,
    }


def max_abs_err(got, want) -> int:
    import torch

    diff = got.to(device="cpu", dtype=torch.int64) - want.to(device="cpu", dtype=torch.int64)
    return int(diff.abs().max())


def cross_check(gstacks, served):
    """The odometer kernels against the group tensor GroupBy served:
    nary_stats_pershard summed over shards equals the maintained tensor
    on the live k (and both are 0 on the pruned k), and nary_stats equals
    group_tile_stats over the full odometer. Both sides run one kernel body
    (bmma.cu's group_pair_kernel, odometer and slot table), so this checks
    the odometer's decode and the served route's slot table against each
    other; the plain versions (phase_kernels) are the independent check.
    Returns the launches it made."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import kernels as K

    f, g, h = gstacks["f"], gstacks["g"], gstacks["h"]
    rh = h.shape[1]
    K.reset_launch_counts()
    per = K.nary_stats_pershard(f, g, (h,))
    full = K.nary_stats(f, g, (h,))
    tiles = K.group_tile_stats(f, g, (h,), [[r] for r in range(rh)], [1] * rh)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    summed = per.sum(dim=1, dtype=torch.int64).cpu().numpy()
    live = summed.reshape(rh, -1).any(axis=1)
    check(list(np.nonzero(live)[0]) == list(range(H_ROWS)), f"cross: live k {live}")
    check(np.array_equal(summed[live], served[live]),
          "cross: nary_stats_pershard disagrees with the served group tensor")
    check(not served[~live].any(), "cross: the served tensor has a pruned k")
    check(torch.equal(full, tiles), "cross: nary_stats disagrees with group_tile_stats")
    log(f"cross: nary_stats_pershard summed over shards equals the served tensor on "
        f"the {int(live.sum())} live k; nary_stats equals group_tile_stats over "
        f"all {rh} k; launches {json.dumps(launches)}")
    return launches


def distinct_rows(stacks) -> int:
    """Rows of the distinct stacks among ``stacks``: a stack passed twice
    (an extra that is also F or G) is read from device memory once."""
    seen = {}
    for x in stacks:
        seen[(x.data_ptr(), tuple(x.shape))] = x.shape[1]
    return sum(seen.values())


def odometer_k64(f, g, h, pershard):
    """K6 (pershard False) or K7 at K = 64, the odometer over the extras
    (h, g) of the GroupBy stacks: timed at all shards, its output held
    exactly against the plain version over the first K64_SHARDS shards
    (K7 over the last K64_SHARDS as well). The extra g is also G, so the
    bound reads f, g and h once each. The k64_* keys of the kernel's
    line."""
    import torch

    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.ops import probe

    name = "nary_stats_pershard" if pershard else "nary_stats"
    kern = K.nary_stats_pershard if pershard else K.nary_stats
    plain = K.nary_stats_pershard_torch if pershard else K.nary_stats_torch
    extras = (h, g)
    s, rf, w = f.shape
    rg = g.shape[1]
    k = K._odometer_slots(extras)
    extra_rows = distinct_rows((f, g) + extras) - rf - rg
    full = kern(f, g, extras)
    sub = [x[:K64_SHARDS] for x in (f, g, h)]
    sub_extras = (sub[2], sub[1])
    want = plain(sub[0], sub[1], sub_extras)
    if pershard:
        err = max_abs_err(full[:, :K64_SHARDS], want)
        # The last shards too: the full grid's split over the shards.
        tail = [x[-K64_SHARDS:] for x in (f, g, h)]
        err = max(err, max_abs_err(full[:, -K64_SHARDS:],
                                   plain(tail[0], tail[1], (tail[2], tail[1]))))
        # The summed kernel over all shards equals this one's shard sum.
        check(torch.equal(K.nary_stats(f, g, extras),
                          full.sum(dim=1, dtype=torch.int64).to(torch.int32)),
              "nary_stats at K=64 disagrees with nary_stats_pershard summed over shards")
    else:
        err = max_abs_err(kern(*sub[:2], sub_extras), want)
    held = f"the first and last {K64_SHARDS}" if pershard else f"the first {K64_SHARDS}"
    check(err == 0, f"{name} at K={k} differs from its plain version over {held} shards")
    ms = time_ms(lambda: kern(f, g, extras))
    k_ms = kernel_ms(bare_group(name, f, g, extras))
    plain_ms = time_ms(lambda: plain(sub[0], sub[1], sub_extras), reps=1, warm=0)
    bound_ms, by, _ = kernel_bound(probe.group_work(s, rf, rg, w, k, extra_rows, False,
                                                    pershard))
    log(f"kernels: {name} at K={k} (extras h, g; g is also G) S={s} Rf={rf} Rg={rg}: "
        f"{ms:.4f} ms, kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} "
        f"({rf + rg + extra_rows} distinct rows read); exact over {held} shards "
        f"(plain {plain_ms:.4f} ms over the first {K64_SHARDS})")
    return {"k64_shape": [s, rf, rg, w, k], "k64_ms": ms, "k64_kernel_ms": k_ms,
            "k64_plain_ms": plain_ms, "k64_plain_shards": K64_SHARDS,
            "k64_bound_ms": bound_ms, "k64_bound_by": by, "k64_max_abs_err": err}


def phase_kernels(gstacks, wide_stacks, launches):
    import torch

    from pilosa_tpu_torch.ops import kernels as K

    main_stacks = (gstacks["f"], gstacks["g"])
    dev = main_stacks[0].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def rand_stack(s, r, w=32768):
        return torch.randint(-(2**31), 2**31, (s, r, w), dtype=torch.int32,
                             device=dev, generator=gen)

    # Pair edge shapes: Rf != Rg, Rg off the 8-row tile, a 64 x 64 pair,
    # S = 1, one-row stacks; the tensor-core K2's faces off 16 and 8 rows
    # on both of its routes, a 2 x 2 grid of its 128 x 128 tiles, and word
    # axes that are not a multiple of its 8-word k-chunk (36, 100).
    from pilosa_tpu_torch.ops import probe

    for s, rf, rg, w in [(16, 8, 16, 32768), (7, 16, 8, 32768), (5, 8, 13, 32768),
                         (3, 64, 64, 32768), (1, 8, 8, 32768), (2, 1, 3, 32768),
                         (2, 256, 256, 32768), (3, 17, 130, 32768), (1, 16, 8, 32768),
                         (2, 40, 24, 36), (1, 17, 130, 100), (3, 16, 8, 36), (2, 8, 8, 36)]:
        f, g = rand_stack(s, rf, w), rand_stack(s, rg, w)
        check(max_abs_err(K.pair_stats_pershard(f, g), K.pair_stats_torch(f, g, True)) == 0,
              f"pair_stats_pershard differs at S={s} Rf={rf} Rg={rg} W={w}")
        check(max_abs_err(K.pair_stats(f, g), K.pair_stats_torch(f, g, False)) == 0,
              f"pair_stats differs at S={s} Rf={rf} Rg={rg} W={w}")
        x = f.reshape(-1, f.shape[-1])
        check(max_abs_err(K.popcount_rows(x), K.popcount_rows_torch(x)) == 0,
              f"popcount_rows differs at N={x.shape[0]} W={w}")
        log(f"kernels: exact at S={s} Rf={rf} Rg={rg} W={w}")

    # The group kernels at edge shapes: E = 2 with heights 3 and 5, Rf != Rg,
    # Rg = 13, 7 slots with 2 inactive, S = 1, filtered, and odometers of K =
    # 70 (9 slot groups), 1 and 256 (E = 8), and hoisted ones (a last extra
    # of 8 or 16 rows after one or two others); then K4's and K5's
    # slot pairs: 1 to 9 slots (every third inactive, whose cells must stay
    # 0) at Rf = 9 and 16, K4 filtered and not, and a 36-word axis.
    cpu_gen = torch.Generator().manual_seed(99)

    def slot_table(heights, n):
        return torch.stack([torch.randint(0, r, (n,), generator=cpu_gen) for r in heights],
                           dim=1).to(torch.int32)

    active = [1, 1, 0, 1, 1, 0, 1]
    for s, rf, rg, heights, filtered in [(2, 8, 8, (3, 5), False), (3, 8, 13, (3, 5), True),
                                         (1, 16, 8, (4,), True), (2, 9, 13, (8,), False),
                                         (1, 8, 8, (2, 3, 2), True), (2, 8, 8, (70,), True),
                                         (1, 8, 8, (1,), False), (1, 8, 8, (2,) * 8, True),
                                         (2, 8, 8, (3, 8), True), (1, 9, 13, (2, 2, 16), False)]:
        f, g = rand_stack(s, rf), rand_stack(s, rg)
        hs = tuple(rand_stack(s, r) for r in heights)
        filt = rand_stack(s, 1)[:, 0].contiguous() if filtered else None
        rows = slot_table(heights, 7)
        for name, got, want in [
            ("group_tile_stats", K.group_tile_stats(f, g, hs, rows, active, filt),
             K.group_tile_stats_torch(f, g, hs, rows, active, filt)),
            ("group_tile_stats_pershard", K.group_tile_stats_pershard(f, g, hs, rows, active),
             K.group_tile_stats_pershard_torch(f, g, hs, rows, active)),
            ("nary_stats", K.nary_stats(f, g, hs, filt), K.nary_stats_torch(f, g, hs, filt)),
            ("nary_stats_pershard", K.nary_stats_pershard(f, g, hs),
             K.nary_stats_pershard_torch(f, g, hs)),
        ]:
            check(max_abs_err(got, want) == 0,
                  f"{name} differs at S={s} Rf={rf} Rg={rg} heights={heights}")
        log(f"kernels: group kernels exact at S={s} Rf={rf} Rg={rg} heights={heights} "
            f"filtered={filtered}")
    for s, rf, rg, heights, w in [(2, 9, 8, (5,), 32768), (1, 16, 13, (3, 4), 32768),
                                  (3, 9, 16, (6,), 36)]:
        f, g = rand_stack(s, rf, w), rand_stack(s, rg, w)
        hs = tuple(rand_stack(s, r, w) for r in heights)
        filt = rand_stack(s, 1, w)[:, 0].contiguous()
        for n in range(1, 10):
            rows, act = slot_table(heights, n), [int(q % 3 != 2) for q in range(n)]
            for fl in (filt, None):
                check(max_abs_err(K.group_tile_stats(f, g, hs, rows, act, fl),
                                  K.group_tile_stats_torch(f, g, hs, rows, act, fl)) == 0,
                      f"group_tile_stats differs at S={s} Rf={rf} Rg={rg} W={w} "
                      f"slots={n} filtered={fl is not None}")
            per = K.group_tile_stats_pershard(f, g, hs, rows, act)
            check(max_abs_err(per, K.group_tile_stats_pershard_torch(f, g, hs, rows, act)) == 0,
                  f"group_tile_stats_pershard differs at S={s} Rf={rf} Rg={rg} W={w} "
                  f"slots={n}")
            check(not per[torch.tensor(act, device=dev) == 0].any(),
                  f"group_tile_stats_pershard wrote an inactive slot at slots={n}")
        log(f"kernels: group_tile_stats (filtered and not) and group_tile_stats_pershard "
            f"exact at S={s} Rf={rf} Rg={rg} W={w}, 1 to 9 slots")

    lines = []
    f, g = main_stacks
    s, rf, w = f.shape
    rg = g.shape[1]
    err = max_abs_err(K.pair_stats_pershard(f, g), K.pair_stats_torch(f, g, True))
    check(err == 0, "pair_stats_pershard differs on the main path's stacks")
    ms = time_ms(lambda: K.pair_stats_pershard(f, g))
    k_ms = kernel_ms(bare_pair("pair_stats_pershard", f, g))
    plain = time_ms(lambda: K.pair_stats_torch(f, g, True), reps=3, warm=1)
    lines.append(kernel_line("pair_stats_pershard", ms, k_ms, plain,
                             probe.pair_work(s, rf, rg, w, True), err,
                             launches["pair_stats_pershard"]))

    # The count program's slab: Intersect(Row(f=1), Row(g=2)) over all shards.
    slab = (f[:, 1, :] & g[:, 2, :]).contiguous()
    err = max_abs_err(K.popcount_rows(slab), K.popcount_rows_torch(slab))
    check(err == 0, "popcount_rows differs on the main path's slab")
    ms = time_ms(lambda: K.popcount_rows(slab))
    k_ms = kernel_ms(bare_popcount_rows(slab))
    plain = time_ms(lambda: K.popcount_rows_torch(slab), reps=5, warm=1)
    # Bytes: the slab read once, the counts written once; one popcount (32
    # bit-products' worth) a word.
    work = (slab.numel() * 4 + slab.shape[0] * 4, 32 * slab.numel())
    lines.append(kernel_line("popcount_rows", ms, k_ms, plain, work, err,
                             launches["popcount_rows"]))

    a, b = wide_stacks
    sa, ra, wa = a.shape
    err = max_abs_err(K.pair_stats(a, b), K.pair_stats_torch(a, b, False))
    check(err == 0, "pair_stats differs on the wide pair's stacks")
    ms = time_ms(lambda: K.pair_stats(a, b), reps=5, warm=1)
    k_ms = kernel_ms(bare_pair("pair_stats", a, b), n=5)
    plain = time_ms(lambda: K.pair_stats_torch(a, b, False), reps=1, warm=0)
    line = kernel_line("pair_stats", ms, k_ms, plain,
                       probe.pair_work(sa, ra, b.shape[1], wa, False), err,
                       launches["pair_stats"])
    # The shard-summed kernel on the main path's square shape too: the
    # filtered 2-field GroupBy's launch.
    err_sq = max_abs_err(K.pair_stats(f, g), K.pair_stats_torch(f, g, False))
    check(err_sq == 0, "pair_stats differs on the main path's stacks")
    ms_sq = time_ms(lambda: K.pair_stats(f, g))
    k_ms_sq = kernel_ms(bare_pair("pair_stats", f, g))
    bound_sq, by_sq, _ = kernel_bound(probe.pair_work(s, rf, rg, w, False))
    line.update({"square_shape": [s, rf, rg, w], "square_ms": ms_sq,
                 "square_kernel_ms": k_ms_sq, "square_bound_ms": bound_sq,
                 "square_max_abs_err": err_sq})
    lines.append(line)
    log(f"kernels: pair_stats at S={s} Rf={rf} Rg={rg}: {ms_sq:.4f} ms, kernel "
        f"{k_ms_sq:.4f} ms, bound {bound_sq:.4f} ms by {by_sq}, exact")

    # The group kernels on the GroupBy path's inputs: the 4 live rows of h
    # as 4 slots (K4 filtered by Row(g=1)'s slab, as the filtered 3-field
    # request), and the full 8-row odometer of h's padded stack (K6, K7).
    h = gstacks["h"]
    rh = h.shape[1]
    live = [[r] for r in range(H_ROWS)]
    ones = [1] * H_ROWS
    filt = g[:, 1, :].contiguous()
    for name, kern, bare, plain, work in [
        ("group_tile_stats", lambda: K.group_tile_stats(f, g, (h,), live, ones, filt),
         bare_group("group_tile_stats", f, g, (h,), live, ones, filt),
         lambda: K.group_tile_stats_torch(f, g, (h,), live, ones, filt),
         probe.group_work(s, rf, rg, w, H_ROWS, H_ROWS, True, False)),
        ("group_tile_stats_pershard", lambda: K.group_tile_stats_pershard(f, g, (h,), live, ones),
         bare_group("group_tile_stats_pershard", f, g, (h,), live, ones),
         lambda: K.group_tile_stats_pershard_torch(f, g, (h,), live, ones),
         probe.group_work(s, rf, rg, w, H_ROWS, H_ROWS, False, True)),
        ("nary_stats", lambda: K.nary_stats(f, g, (h,)), bare_group("nary_stats", f, g, (h,)),
         lambda: K.nary_stats_torch(f, g, (h,)),
         probe.group_work(s, rf, rg, w, rh, rh, False, False)),
        ("nary_stats_pershard", lambda: K.nary_stats_pershard(f, g, (h,)),
         bare_group("nary_stats_pershard", f, g, (h,)),
         lambda: K.nary_stats_pershard_torch(f, g, (h,)),
         probe.group_work(s, rf, rg, w, rh, rh, False, True)),
    ]:
        err = max_abs_err(kern(), plain())
        check(err == 0, f"{name} differs on the GroupBy path's stacks")
        ms = time_ms(kern)
        k_ms = kernel_ms(bare)
        plain_ms = time_ms(plain, reps=1, warm=0)
        lines.append(kernel_line(name, ms, k_ms, plain_ms, work, err, launches[name]))
    lines[-2].update(odometer_k64(f, g, h, pershard=False))
    lines[-1].update(odometer_k64(f, g, h, pershard=True))
    for ln in lines:
        log(f"kernels: {ln['name']}: {ln['ms']:.4f} ms, kernel {ln['kernel_ms']:.4f} ms, "
            f"plain {ln['plain_ms']:.4f} ms, bound {ln['bound_ms']:.4f} ms by "
            f"{ln['bound_by']} (route {ln['bound_route']}); no single PyTorch call "
            f"computes a popcount, so no library yardstick")
    log("kernels: earlier times ms on the CUDA cores, recorded before each kernel "
        "moved to the tensor cores (NVIDIA H100 80GB HBM3, 700.00 W), not measured "
        "in this run: " + json.dumps(EARLIER_MS))
    return lines


# ---------------------------------------------------------------------------
# phase 4: small holder, whole query list, write churn
# ---------------------------------------------------------------------------


SMALL_QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=7)))",
    "Count(Union(Row(f=1), Row(f=2), Row(f=3)))",
    "Count(Not(Row(f=1)))",
    "Row(f=2)",
    "Count(Row(f=3))",
    "Count(Difference(Row(f=2), Row(g=7)))",
    "Count(Xor(Row(f=1), Row(g=7)))",
    "Count(All())",
    "Not(Union(Row(f=1), Row(g=7)))",
    "Intersect(Row(f=3), Row(g=7))",
    "Count(Row(f=99))",
    " ".join(f"Count(Intersect(Row(f={a}), Row(g={b})))"
             for a in (0, 1, 2, 3) for b in (0, 1, 7, 9)),
]


def phase_small():
    import numpy as np

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils.stats import global_stats

    n = 4
    rng = np.random.default_rng(0)
    holder = Holder(None).open()
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    for row in (1, 2, 3):
        cols = np.unique(rng.integers(0, n * SHARD_WIDTH, 4000, dtype=np.uint64))
        idx.field("f").import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
        idx.existence_field().import_bits(np.zeros(cols.size, dtype=np.uint64), cols)
    cols = np.unique(rng.integers(0, n * SHARD_WIDTH, 3000, dtype=np.uint64))
    idx.field("g").import_bits(np.full(cols.size, 7, dtype=np.uint64), cols)

    dev = Executor(holder, backend=CUDABackend(holder))
    oracle = Executor(holder, backend=CPUBackend(holder))
    epochs = [
        [], [f"Set({SHARD_WIDTH + 5}, f=1)", f"Set({SHARD_WIDTH + 6}, g=7)",
             f"Clear({SHARD_WIDTH + 5}, f=2)"],
        [f"Set({3 * SHARD_WIDTH + 1}, f=2)", f"Clear({SHARD_WIDTH + 6}, g=7)",
         f"Set({SHARD_WIDTH + 70000}, f=1)"],
    ]

    def counter(name):
        return sum(global_stats.counter_totals(name).values())

    routed0 = counter("cpu_routed_total")
    for k, writes in enumerate(epochs):
        spliced, rebuilt = counter("stack_incremental_updates_total"), counter(
            "stack_full_rebuilds_total")
        for q in writes:
            oracle.execute("i", q)
        for q in SMALL_QUERIES:
            check(same_answers(dev.execute("i", q), oracle.execute("i", q)),
                  f"small: epoch {k}: {q[:60]} disagrees with the oracle")
        if writes:
            check(counter("stack_incremental_updates_total") > spliced,
                  f"small: epoch {k} did not splice the resident stacks")
            check(counter("stack_full_rebuilds_total") == rebuilt,
                  f"small: epoch {k} rebuilt a stack")
        log(f"small: epoch {k}: {len(SMALL_QUERIES)} requests agree with the oracle")
    routed = counter("cpu_routed_total") - routed0
    check(routed == 0, f"small: {routed} calls were routed to the CPU oracle")
    log("small: cpu_routed_total 0")
    holder.close()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of pilosa_tpu_torch on one card.")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose pilosa_tpu_torch to drive (default: this "
                         "script's own)")
    root = os.path.abspath(ap.parse_args(argv).root)
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(root, "pilosa_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              f"(pilosa_tpu_torch/ is missing under {root})", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    torch.cuda.set_device(0)
    import pilosa_tpu_torch

    log(f"package: {os.path.dirname(pilosa_tpu_torch.__file__)}")

    card_line = phase_card()
    phase_probe(card_line)
    log("reduced: none (954 shards, full size)")
    results: dict = {}
    holder, backend, wide_stacks = phase_main(results)
    group_launches, gstacks, served = phase_groupby(holder, backend)
    holder.close()
    del backend
    phase_groupby_tiles()
    launches = dict(results["launches"])
    for name in ("group_tile_stats", "group_tile_stats_pershard"):
        launches[name] = group_launches[name]
    cross = cross_check(gstacks, served)
    for name in ("nary_stats", "nary_stats_pershard"):
        launches[name] = cross[name]
    lines = phase_kernels(gstacks, wide_stacks, launches)
    del gstacks, wide_stacks
    phase_small()
    log_routed("small")
    log(f"total seconds {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
