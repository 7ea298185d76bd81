#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pilosa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--root DIR] [--churn | --miss | --budget | --cold | --cluster | --mesh | --epochs | --trace | --host-count | --host-count-ab PARENT]

Builds the hand-written CUDA kernels from pilosa_tpu_torch/ops/csrc with
nvcc, then runs the phases below. ``--root DIR`` drives the
pilosa_tpu_torch package of another checkout DIR instead of this script's
own (its kernels built under DIR), so that two trees can be compared in
turns by the same script on one card (a checkout from before the TopN
and BSI slice has no K8 or K9, and one from before the fused BSI condition
no K10, so its run stops at phase 3b: run that checkout's own
chip_smoke.py to time it).

1. card: prints the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, and the kernel build seconds with ptxas's report
   (ops/csrc/bmma.cu: K1, K2 and K4 to K7 on the tensor cores' binary MMA,
   and the probe; ops/csrc/bitcount.cu: K3, K8, K9 and K10;
   ops/csrc/spec.cu: K11; ops/csrc/expand.cu: K12 to K14;
   ops/csrc/splice.cu: K15);
   then the AND-popcount rate probe (ops/csrc/bmma.cu, ops/probe.py): the
   b1 tensor-core MMA's and the CUDA cores' popcount rates in bit-products
   a second, which set the kernels' operations bounds;
2. main path, at full size: a 1B-column index (fields f and g, 954 shards
   of 2^20 columns, 8 rows, bit density 0.05, the content of bench.py's
   build_index) built through the port's Holder / Field.import_bits and
   queried through Executor(holder, backend=CUDABackend(holder)): single
   Count(Intersect|Union|Difference|Xor(Row, Row)) calls, a 3-leaf Not and
   a 3-row Count (each one K11 launch and nothing else), the batched count
   path over 8 and 64 distinct 3-row Counts (one K11 launch each, equal to
   the single Counts), one request of 16 fused Counts (per-shard pair
   kernel: cold, cached, and with its pair-cache entry dropped, profiled)
   and Row(f=2) (K11 in slab mode);
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
   same queries over the first 32 shards must equal the CPU oracle's (run
   after phase 4, as it replaces the resident stacks with 32-shard ones).
   Launch counters are zeroed before the requests and read after: the
   group-tile kernels must have launched, and each request launches what
   its route should. No GroupBy may be routed to the CPU oracle. Then a
   2-shard index whose 70-row extra field crosses the 64-slot tile
   boundary, on the maintained and the generic route;
3b. TopN, Rows and the BSI plane on the same index, with bench.py's BSI
   field v (build_bsi_field: up to 50 values a shard in [-9000, 9000],
   bit depth 14): TopN(f, n=5), TopN(f) and Rows(f) against the Count of
   each row (K11), TopN(f, Row(g=7), n=3) against the Counts of the rows'
   Intersects, Rows(g, previous=2, limit=3), GroupBy(Rows(f)) from the
   TopN table, Sum, Min and Max of v and five BSI-condition Counts against
   numpy over the imported values; the launches of each request (an
   uncached TopN launches K8 once, Sum K8 and K3 once each, Min and Max
   K9 once, a condition Count K10 and K11 once each), its median wall time
   with the TopN and aggregate caches dropped and cached, uncached Min and
   Max broken into the backend's profile phases (launch, readback, host
   reduce), and the device profiles of TopN(f), Sum, Min and
   Count(Row(v > 100));
   then, after phase 4, Sum/Min/Max with filters, a Count over a BSI
   condition and Shifts over the first 32 shards against the CPU oracle;
   then the program ledger against the launch counters (phase_ledger):
   after phases 2 to 3b, whose backend made every launch of the process,
   its launches equal device_launches_total in total and by kind, with no
   recompile (phase 2 prints the single Count's ledger deviceSeconds a
   launch beside the profiler's kernel time for the same calls);
3c. row paging under a device byte budget (phase_budget): a second
   CUDABackend with max_bytes 512 MiB over the same index (f, g and v over
   it, h not) and a tall field t in an index of its own (1024 rows over 64
   shards, an 8 GiB stack, 64 pages of 16 rows under the budget): the
   cold and the repeated Count, Row(f=2), a 3-row Count, the 16-Count pair
   request, TopN(f) (one 8-row page of 954 MiB, past the budget), the
   filtered TopN(f, Row(g=7)), TopN(t), Rows(t), GroupBy(Rows(t)) and
   Sum(field=v), each equal to the unbudgeted backend's answer, with its
   host time, its device time in kernels and copies, its K8 and K11
   launches, page uploads and bytes, evictions and resident bytes against
   the budget; only Sum may be routed to the host. Then the repeated paged
   Count's device profile beside the resident Count's, the paged TopN of t
   timed a page at a time (host pack, copy, K8, readback) with the upload
   rate beside a pinned-memory copy_ of the same bytes and K8's share of
   its bound, and the phase's peak device memory over its start;
4. the HTTP server (pilosa_tpu_torch.server) over the same index and
   backend: the north-star Count, the 16-Count pair request, three
   GroupBys, TopN(f, n=5) and Sum(field=v) sent as JSON and as protobuf,
   each answer byte-identical to the in-process executor's encoded the
   same way, with the pair, GroupBy, TopN and aggregate caches dropped
   first so that each request launches what its route should (K11, K1,
   K2, K5 with K3, K4 with K3, K8, K8 with K3); one HTTP Count profiled
   (wall and device time); then requests/s and p50/p99 latency, each
   client a thread with its own keep-alive connection in a process of its
   own, every answer checked, with the launches, batch legs, device
   programs and mean batch occupancy of each window: the Count under 1, 4
   and 16 clients without the batcher; then wired as `cli server` wires
   it, with the shard-leg batcher (a batched Count launches the pair
   sweep, a batched 3-row Count K11), the Count at 1, 4 and 16, 3-row
   Counts at 16, the pair request and the 3-field GroupBy at 1 and 4, and
   a 4-client window in which every request drops the pair, agg and
   groupn caches first while a writer toggles one bit of f with
   Set/Clear, each answer equal to the single-threaded answer of one of
   the two epochs, and the window's time split by phase and call with
   the version walks it took; then the churn window: 4 clients send the
   16-Count pair request, TopN(f) and the 3-field GroupBy in a seeded
   random order while a writer toggles one bit of f every 50 ms, without
   dropping any cache, so each write epoch meets the pair, TopN and GroupN
   tables: after one warm-up request of each kind no pair sweep (K1, K2),
   no K8 and no K5 or K3 may launch, the tables' incremental counters must
   grow, at least 20 writes must land, and every answer must be one of the
   two epochs'; then the aggregate churn window, the same with Sum, Min
   and Max of v while the writer swaps the column of v's largest value
   with -9500: no K8, K3 or K9, the Sum and Min/Max counters grow and a
   shard is re-derived; then the churn window twice more, without and
   with the windowed refresher at 50 ms (refresh_windows): the refresher's
   counters and the launches by kind of each, no stack rebuilt whole, the
   refresher's window refreshing some; then with the result cache on too, the Count at 1 and
   16 (cache hits) and the same Set/Clear window; then the Count and
   3-row Counts without HTTP (threads calling Executor.execute) at 1, 4
   and 16 threads, without and with the batcher; no batch dispatch error
   and no request routed to the host; the device block of
   /debug/diagnostics;
   and the CLI's server (`python -m pilosa_tpu_torch.cli server`) booted
   as a process on a 4-shard on-disk index that `cli import` loads, its Count,
   Row and GroupBy over HTTP equal to the in-process executor's over the
   same directory, stopped by SIGINT with exit code 0; then again with
   --max-hbm-bytes at half of one of its stacks: the same answers, and a
   /debug/hbm that lists row pages whose tierBytes sum to residentBytes;
   then with preheat = true, refresh-window-ms = 50 and heat-half-life =
   60 in its TOML (planes_cli_run): the same answers, its log's
   `preheat: N stacks resident` and window, no failed preheat line,
   /debug/programs' launches equal to device_launches_total, /debug/heat's
   entries, tier heat and reuse curve, and one ?explain=1 launch record
   per launch of a Count;
   then the device trace server (phase_trace, utils/devtrace.py, the
   server's profile.port): in-process Counts from 16 threads in 2 s
   windows, untraced and traced in turns (two of each), GET /trace
   covering each traced window; Counts/s of each, the trace's pilosa.*
   ranges, kernels (K11's among them), bytes and events, the window's
   device_launches_total beside the trace's K11 kernels (its
   completeness), and the share of pilosa.count ranges whose thread's
   launch calls lie inside them (the clock alignment); the run fails where
   a trace holds no kernel or no pilosa.* range, or a second concurrent
   GET /trace is not answered 409. ``--trace`` runs it alone on an
   unmeshed backend over bench.py's index, then traces a meshed backend of
   2 parts (on two cards where two are visible, else both on cuda:0)
   through a write epoch and reads, printing each request's kernels by
   part, their intervals and the parts' overlap;
   after phase 4, the main backend's f, g, h and v stacks, spliced in
   place through its write windows, must equal fresh packs of the holder
   bit for bit (phase_stacks_exact);
4b. preheat at 954 shards (phase_preheat, after phase 4's oracle checks,
   on bench.py's index alone): a fresh backend's preheat() seconds and
   stacks, then the first Count, TopN(f), 16-Count pair request and
   3-field GroupBy after it, which must upload nothing, beside the same
   calls on a cold backend, whose answers they must equal;
4c. the chunked cold build (phase_cold_build, on bench.py's index alone
   after phase 4b): preheat() and the first Count on fresh backends by
   the dense path (MIN_CHUNKED_WORDS past every stack, the container tier
   off: the parent's pack and pageable copy) and by the chunked path
   (ops/sparse.py); then a run-heavy field r in an index of its own (954
   shards x 8 rows, every roaring container one run of 1000 to 60000
   columns, imported as run containers, checked to be runs) and a
   skewed field s in another (954 shards x 8 rows: row 0 at bit density
   0.5 in bitmap containers, rows 1 to 7 at 0.01 in array containers; its
   first Count(Row(s=0)) timed on a fresh backend by each path), and,
   with the launch counters zeroed, f, g, h, v's BSI view, the existence
   row, r and s each built on fresh backends by both paths over 2 rounds
   in alternating order (v also with the container tier off, so that its
   chunks take the words tier), each pair torch.equal; each build prints
   its wall, version walk, tier walk, host pack, copy and expansion, wire
   and dense bytes, chunks by tier, drains and peak device memory over
   its start (at most the stack plus MAX_PENDING_BYTES when chunked);
   each chunked build of s must ship 30 container chunks with a word-mask
   remainder, K12 and K14 launched once a chunk; K12, K13 and K14 must
   each have launched (``--cold`` runs this phase and the expansion
   kernels' checks alone);
4d. two nodes of a cluster sharing the card (phase_cluster, after the
   2-shard tile index; ``--cluster`` runs it alone, after the kernel
   libraries' build and load): bench.py's f, g and h over CLUSTER_SHARDS
   shards (cut from 954; PERF.md section 4; CLUSTER_SHARDS_WHOLE in the
   whole run) and the existence of h's
   columns, written through the port's holder into a data directory and
   copied to a second; two `cli server` processes with executor cuda, the
   same cluster.hosts, replicas 2, hedge-delay 0 and a 10 s anti-entropy
   interval. Count(Row), Count(Intersect), Count(Union), Count(Not),
   TopN(f), Rows(f), a filtered 2-field and a 3-field GroupBy go to each
   node, every answer equal to the in-process single-node executor's over
   the same data; each kind and node prints its first request, p50 and
   p99, and both nodes' launches by kind (/debug/programs),
   cpu_routed_total and stack_full_rebuilds_total deltas. Then a Set and
   a Clear through the node that is not the coordinator, read back from
   each replica by a pinned remote leg; that node killed (SIGKILL) and
   every read answered as before by the survivor (its first answer
   timed); a write on the survivor, the lost node restarted on its
   persisted topology, and its pinned answer holding the write after an
   anti-entropy pass. A non-zero exit, a traceback or a refusal in a
   node's log fails the phase;
4e. the shard mesh on the one card (phase_mesh, after phase 4c, on
   bench.py's index with v; ``--mesh`` runs it alone with the card line
   and K15's checks): an unmeshed CUDABackend and CUDABackend(holder,
   mesh=ShardMesh([cuda:0] * n)) for n = 2 (954 shards in two parts of
   477) and 4 (padded to 956), each with its batcher; tests/test_mesh.py's
   FAMILIES (h for its hh), bench.py's Count, the pair request and the
   GroupBys, every meshed answer equal to the unmeshed one, cold and after
   each of 3 Set/Clear/value epochs, which every backend absorbs by
   splices and no full rebuild (K15 on the meshed ones: one launch a
   round, so its launches equal the sum over the parts of ceil(dirty
   shards in the part / 32) at rows_p 8); per read kind and backend a
   window of up to 100 requests with the tables dropped, in two runs with
   the backends built cold and timed in alternating order: p50 and p90,
   the programs and the kernel launches a request; the kernel counts
   zeroed before the phase and every kernel of its path launched; then the
   epoch absorption (phase_epochs: write epochs dirtying 1 shard, 8 shards
   in each part and 400 spread over every part, each absorbed by the first
   read on each backend, its writes and that read timed and its splices
   split into pack, copy, launch and wait, with the K15 launches the
   rounds give and no full rebuild; ``--epochs [--root DIR]`` runs it
   alone on f's stack, for a parent/change A/B); `cli server
   --mesh-devices` past the visible cards exiting non-zero with
   MeshConfigError's message, and `--mesh-devices 1` serving. K15
   (phase_splice_kernel) is held against its plain form at 1, 8 and 32
   live slabs into a 477-shard part and at 32 entries with duplicate,
   invalid and clipped ones, with its times, `graph_ms`, bound, the
   launch floor at its grid and `index_copy_`'s time at each;
5. each kernel against its plain PyTorch version on the card, on the
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
   plain versions are the independent check); K8 at the TopN, filtered
   TopN and Sum shapes, K9 on v's stack and K10 on it for Row(v > 100)
   and v >< [-50, 50], each also at edge shapes (K8: 0, 1 and 2 masks,
   row0 > 0; K9: depths 1, 14 and 63, an all-negative, an empty and a
   filtered-out shard; K10: every op, sign and between class at depths 1,
   14 and 63, predicates 0, all ones and bit depth - 1); K11 at the served
   shapes (the Count's two leaves, the 3-leaf Not, 8 and 64 distinct
   3-row slots, Row(f=2)'s slab) and at the window shapes of
   phase_spec_kernels with its times and bound, the window body against
   its two timed variants, from 8 threads at once, and at edge shapes
   (S = 1, word axes off its chunk, the full leaf table and stack, zero
   leaves, per-slot rows past the launch's parameters) in both modes on
   every body; K12, K13 and K14 on the first chunks of f, r and v (its
   words tier) that phase 4c's builds shipped, and K14 also on the word-
   mask remainder of s's first container chunk, their wire as the builder
   staged it, beside the launch floor (ops/probe.py noop, a kernel that
   does nothing), each also timed as 20 launches replayed in one CUDA
   graph (graph_ms: the device's time without the host's launch cost)
   (phase_expand_kernels);
5b. the host rows of the tables (exec/cuda.py _host_slab_pair_flat,
   _host_slab_row_counts, _host_slab_groupn), which a write epoch derives
   on the host, against K1's, K8's, K7's and K5's rows of two random slab
   sets at the stack height of bench.py's index, and the Min/Max re-derive
   (Fragment.min/max) against K9's per-shard rows at two value densities,
   exactly;
6. a small holder with an existence field and a YMDH time field: the
   whole Count/Row/Not/All/time-range query list through two write-churn
   epochs, checked against the CPU
   oracle after each; the resident stacks must be spliced, not rebuilt,
   and no query may be routed to the CPU oracle.

cpu_routed_total is printed after each phase.

``--budget`` runs only phase 3c (with bench.py's index and its BSI field v
built) and the CLI's servers.

``--host-count`` runs only the single Count's host time on bench.py's index
(phase_host_count: the first Count's stack build and upload, the Count's
host time one call after another and from 16 threads, a ledger record's
host time). ``--host-count-ab PARENT`` runs it for PARENT's package and
the --root checkout's in two processes, in alternating rounds (--pairs N),
and prints the change over the parent for each metric.

``--churn`` runs only the two churn windows (with bench.py's BSI field v
built), and ``--miss`` only the cache-missing window, on bench.py's index
served by the --root checkout's package, and prints their lines: run it
for the parent and the change in turns to compare the two (each table's
zero-launch checks apply to a package with its host tier).

Prints a JSON line of every kernel, then, last, one JSON object whose
"ok" is true. Any failed check raises; the exit code is then not 0.
With no CUDA card the script exits with code 2 before doing anything.
"""

from __future__ import annotations

import contextlib
import gc
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
# One request of 16 fused Counts over the field pair (f, g).
PAIR_REQUEST = " ".join(
    f"Count({('Intersect', 'Union', 'Difference', 'Xor')[k % 4]}(Row(f={k % ROWS}), "
    f"Row(g={(3 * k + 1) % ROWS})))"
    for k in range(16))
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
    # The per-row popcounts of the topn_plain / topn_src programs (:2134,
    # :2156) and of bsi_sum's planes (:2172).
    "row_popcounts": "pilosa_tpu/exec/tpu.py:2134",
    # The bsi_min / bsi_max program body.
    "bsi_minmax": "pilosa_tpu/exec/tpu.py:2201",
    # The C and CB nodes of the count and vec programs' _eval_spec (the
    # range helpers at :1113-1202), fused by XLA.
    "bsi_compare": "pilosa_tpu/exec/tpu.py:1243",
    # The fused count, count_batch and vec_batch programs (and vec, :2084).
    "spec_eval": "pilosa_tpu/exec/tpu.py:2070, :2091, :2116",
    # The cold build's XLA expansion programs (ops/sparse.py _pos_prog,
    # _run_prog, and the mask decompress _chunk_prog at sparse.py:213).
    "expand_positions": "pilosa_tpu/ops/kernels.py:410",
    "expand_runs": "pilosa_tpu/ops/kernels.py:446",
    "expand_words": "pilosa_tpu/ops/sparse.py:213",
    # The XLA program the JAX mesh runs under shard_map for a write epoch.
    "splice_slabs": "pilosa_tpu/ops/kernels.py:497",
}
COUNT_KERNELS = ("pair_stats_pershard", "pair_stats", "spec_eval")
# The cold build's expansion kernels (K12 to K14). They launch where a
# request builds a stack (a chunk at a time), so the per-request launch
# counts of the query phases leave them out (query_launches).
BUILD_KERNELS = ("expand_positions", "expand_runs", "expand_words")
# Each kernel's earlier time at the shape timed here, recorded by this
# script on an NVIDIA H100 80GB HBM3 at 700.00 W on the CUDA cores: K2 and
# K4 before they moved to the tensor cores, K1 and K5 before they followed
# (events around a wrapper call); K6 and K7 before they followed, their
# kernel_ms (events around bare launches); K3, which has not moved, from
# the same run as K2's and K4's; K9's kernel_ms on v's stack before its
# redesign (two blocks a shard, one a branch, each reading the planes).
# Printed for comparison on a line of its own, never in the kernels line,
# whose numbers are all of this run.
EARLIER_MS = {
    "pair_stats_pershard": 1.1817, "pair_stats": 141.80, "popcount_rows": 0.06478,
    "group_tile_stats": 4.0985, "group_tile_stats_pershard": 3.8494,
    "nary_stats kernel_ms": 6.4030, "nary_stats_pershard kernel_ms": 6.4061,
    "pair_stats at S=954, 8 x 8": 1.1986,
    "bsi_minmax kernel_ms": 1.3494,
}
# The odometer kernels' second shape: K = 64 over the extras (h, g), from
# the resident stacks (so g is both G and an extra, and its bound counts g
# once), whose output is held against the plain versions over the first
# K64_SHARDS shards, K7's over the last as well (the plain pass over all
# 954 would take about a minute).
K64_SHARDS = 64


def query_launches() -> dict:
    """ops.kernels.launch_counts() of the query kernels (all but
    BUILD_KERNELS)."""
    from pilosa_tpu_torch.ops import kernels as K

    return {k: v for k, v in K.launch_counts().items() if k not in BUILD_KERNELS}


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


def bare_row_popcounts(stack, row0, n_rows, masks=()):
    import torch

    from pilosa_tpu_torch.ops import build
    from pilosa_tpu_torch.ops import kernels as K

    lib = build.library(K._LIBRARY["row_popcounts"])
    s, r, w = stack.shape
    out = torch.empty((max(len(masks), 1), s, n_rows), dtype=torch.int32, device=stack.device)
    ptrs = [m.data_ptr() for m in masks] + [None] * (2 - len(masks))
    stream = torch.cuda.current_stream(stack.device).cuda_stream

    def launch():
        rc = lib.row_popcounts_launch(stack.data_ptr(), ptrs[0], ptrs[1], out.data_ptr(),
                                      len(masks), s, r, row0, n_rows, w, stream)
        check(rc == 0, f"row_popcounts: CUDA launch failed with cudaError {rc}")

    return launch


def bare_bsi_minmax(stack, depth, filt, kind):
    import torch

    from pilosa_tpu_torch.ops import build
    from pilosa_tpu_torch.ops import kernels as K

    lib = build.library(K._LIBRARY["bsi_minmax"])
    s, r, w = stack.shape
    out = torch.empty((2, s, depth + 2), dtype=torch.int32, device=stack.device)
    stream = torch.cuda.current_stream(stack.device).cuda_stream

    def launch():
        rc = lib.bsi_minmax_launch(stack.data_ptr(), None if filt is None else filt.data_ptr(),
                                   out.data_ptr(), 0 if kind == "min" else 1, s, r, depth, w,
                                   stream)
        check(rc == 0, f"bsi_minmax: CUDA launch failed with cudaError {rc}")

    return launch


def bare_bsi_compare(stack, depth, op, bits, neg=False, allow_eq=False, hi_bits=None):
    import ctypes

    import torch

    from pilosa_tpu_torch.ops import build
    from pilosa_tpu_torch.ops import kernels as K

    lib = build.library(K._LIBRARY["bsi_compare"])
    s, r, w = stack.shape
    mode, start_a, start_b, extra, neq, ops = K.compare_plan(depth, op, bits, neg, allow_eq,
                                                             hi_bits)
    table = (ctypes.c_uint8 * (K.MAX_COMPARE_DEPTH + 1))(*ops)
    out = torch.empty((s, w), dtype=torch.int32, device=stack.device)
    stream = torch.cuda.current_stream(stack.device).cuda_stream

    def launch():
        rc = lib.bsi_compare_launch(stack.data_ptr(), out.data_ptr(), ctypes.addressof(table),
                                    mode, start_a, start_b, extra, int(neq), s, r, depth, w,
                                    stream)
        check(rc == 0, f"bsi_compare: CUDA launch failed with cudaError {rc}")

    return launch


def bare_spec_eval(ops, leaves, rows, mode, body=None):
    """K11's bare launches: one a run of slots of the window's split, their
    window tables and output staged once (count mode's launch zeroes its
    output on the stream, as the wrapper's does); ``body`` forces a body
    (default: the wrapper's choice for each run)."""
    import torch

    from pilosa_tpu_torch.ops import build
    from pilosa_tpu_torch.ops import kernels as K

    lib = build.library(K._LIBRARY["spec_eval"])
    q = len(rows)
    s, w = leaves[0].shape[0], leaves[0].shape[-1]
    dev = leaves[0].device
    out = torch.empty((q, s) if mode == "count" else (q, s, w), dtype=torch.int32, device=dev)
    staged = [K.spec_launch_args(ops, leaves, rows[q0:q1], out[q0:q1], mode,
                                 K.spec_body(ops, q1 - q0, mode) if body is None else body)
              for q0, q1 in K.spec_split(leaves, rows)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        for args, _keep in staged:
            rc = lib.spec_eval_launch(*args, stream)
            check(rc == 0, f"spec_eval: CUDA launch failed with cudaError {rc}")

    launch.out = out
    return launch


def profiler_guard():
    """The package's one-profiler-session guard (utils/devtrace.py
    exclusive), so that no torch.profiler window here overlaps a device
    trace; a package from before the device trace server has none."""
    try:
        from pilosa_tpu_torch.utils.devtrace import exclusive
    except ImportError:
        return contextlib.nullcontext()
    return exclusive()


def is_k11(name: str) -> bool:
    """A trace's kernel name is K11's (ops/csrc/spec.cu)."""
    return "spec_slot_kernel" in name or "spec_window_kernel" in name


def device_share(fn, label: str, n: int = 10, warm: int = 3) -> None:
    """Profile n calls of fn with torch.profiler: wall ms per call, device
    kernel ms per call and the device's busy share, and the kernels that
    took the device time. The profiler traces ``warm`` calls first and
    keeps only the n after them (its schedule's warm-up): it can lose the
    kernels launched soon after its tracing starts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profiler_guard(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                   schedule=schedule(wait=0, warmup=warm, active=n,
                                                     repeat=1)) as prof:
        for _ in range(warm):
            fn()
            prof.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn()
            if i < n - 1:
                prof.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()  # closes the active window
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        # The schedule's ProfilerStep ranges span whole calls: not kernels.
        if (us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA")
                and not ev.key.startswith("ProfilerStep")):
            rows.append((us, ev.count, ev.key))
    dev_us = sum(r[0] for r in rows)
    log(f"profile {label}: wall {wall_us / n / 1e3:.4f} ms/call, device "
        f"{dev_us / n / 1e3:.4f} ms/call, device busy {dev_us / wall_us:.3f}")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        log(f"profile {label}:   {us / n / 1e3:.4f} ms/call, {count} in {n} calls "
            f"{key[:90]}")
    return wall_us / n / 1e3, dev_us / n / 1e3


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


def build_bench_index(holder, shards: int = SHARDS, only_f: bool = False):
    """bench.py build_index: per shard, f and g hold ROWS * SHARD_WIDTH *
    DENSITY uniform columns per row, and h H_ROWS rows of n_bits // 4, all
    from SFC64(42)'s raw stream in that order, over the first ``shards``
    shards; only f (the same f) with only_f."""
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
        for shard in range(shards):
            field.import_bits(rows, rand_cols(shard, rows.size))
        if only_f:
            return
    hrows = np.repeat(np.arange(H_ROWS, dtype=np.uint8), n_bits // 4)
    field = idx.create_field("h")
    for shard in range(shards):
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
    pair_request = PAIR_REQUEST
    wide_request = " ".join(
        f"Count({verbs[k % 4]}(Row(a={(37 * k) % WIDE_ROWS}), "
        f"Row(b={(101 * k + 5) % WIDE_ROWS})))"
        for k in range(16)
    )
    # K11 beyond the pair Count: the existence row ANDNOT a pair (the bench
    # index tracks existence but imports none, as bench.py's does) and a
    # 3-row Count, which no pair plan serves.
    not3 = "Count(Not(Intersect(Row(f=1), Row(g=2))))"
    three_row = "Count(Intersect(Row(f=1), Row(g=2), Row(h=3)))"

    K.reset_launch_counts()
    latencies = {}
    answers = {}
    t0 = time.perf_counter()
    answers["cold"] = dev.execute("bench", singles[0])
    torch.cuda.synchronize()
    log(f"main: first query (stack build + upload) seconds "
        f"{time.perf_counter() - t0:.2f}; resident stack bytes "
        f"{backend.blocks.resident_bytes()}")
    for q in singles + ["Row(f=2)", not3, three_row]:
        first, med, out = host_ms(lambda q=q: dev.execute("bench", q))
        latencies[q] = {"first_ms": first, "median_ms": med}
        answers[q] = out
    led0 = ledger_kind(backend, "count")
    _, prof_ms = device_share(lambda: dev.execute("bench", singles[0]), "single Count")
    led1 = ledger_kind(backend, "count")
    launches = led1["launches"] - led0["launches"]
    led_ms = (led1["deviceSeconds"] - led0["deviceSeconds"]) * 1e3 / max(1, launches)
    log(f"ledger: single Count deviceSeconds {led_ms:.4f} ms a launch over {launches} "
        f"launches (dispatch to readback) beside the profiler's {prof_ms:.4f} ms of "
        "kernels a call over the last 10 of them")
    device_share(lambda: dev.execute("bench", "Row(f=2)"), "Row(f=2)", n=2)
    per_request = {}

    def launches_of(label, fn):
        before = query_launches()
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        per_request[label] = {k: v - before[k] for k, v in query_launches().items()
                              if v != before[k]}
        return ms, out

    launches_of("single Count", lambda: dev.execute("bench", singles[0]))
    launches_of("Row(f=2)", lambda: dev.execute("bench", "Row(f=2)"))
    launches_of("3-leaf Not Count", lambda: dev.execute("bench", not3))
    launches_of("3-row Count", lambda: dev.execute("bench", three_row))
    # The batched count path over Q distinct 3-row Counts: one K11 launch.
    from pilosa_tpu_torch.pql import parse_string

    combos = [(a, b, c) for a in range(ROWS) for b in range(ROWS) for c in range(H_ROWS)]
    for q_slots in (8, 64):
        picks = combos[:: len(combos) // q_slots][:q_slots]
        calls = [parse_string(f"Intersect(Row(f={a}), Row(g={b}), Row(h={c}))").calls[0]
                 for a, b, c in picks]
        _, got = launches_of(f"count batch of {q_slots} 3-row Counts",
                             lambda: backend.count_batch("bench", calls, list(range(SHARDS))))
        want_counts = [dev.execute("bench", f"Count({c})")[0] for c in
                       (f"Intersect(Row(f={a}), Row(g={b}), Row(h={c}))" for a, b, c in picks)]
        check(got == want_counts, f"main: the {q_slots}-slot count batch disagrees with "
              "its single Counts")
        answers[f"batch{q_slots}"] = got
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
    launches = query_launches()
    log("main: launches per request " + json.dumps(per_request))
    want = {
        "single Count": {"spec_eval": 1},
        "Row(f=2)": {"spec_eval": 1},
        "3-leaf Not Count": {"spec_eval": 1},
        "3-row Count": {"spec_eval": 1},
        "count batch of 8 3-row Counts": {"spec_eval": 1},
        "count batch of 64 3-row Counts": {"spec_eval": 1},
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

    for q in singles + ["Row(f=2)", pair_request, not3, three_row]:
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
         for q in singles + ["Row(f=2)", not3, three_row, "batch8"]}))
    log_routed("main")

    results["launches"] = launches
    # The 3-leaf Not's existence stack, for K11's served shapes.
    results["exists"], _ = backend.blocks.get(
        "bench", holder.index("bench").existence_field(), tuple(range(SHARDS)))
    a_stack, _ = backend.blocks.get("wide", holder.index("wide").field("a"),
                                    tuple(range(WIDE_SHARDS)))
    b_stack, _ = backend.blocks.get("wide", holder.index("wide").field("b"),
                                    tuple(range(WIDE_SHARDS)))
    check(a_stack.shape == (WIDE_SHARDS, WIDE_ROWS, 32768),
          f"a stack {tuple(a_stack.shape)}")
    return holder, backend, (a_stack, b_stack)


def ledger_kind(backend, kind: str) -> dict:
    """The program ledger's launches and deviceSeconds of one kind, summed
    over its entries."""
    out = {"launches": 0, "deviceSeconds": 0.0}
    for e in backend.programs.ledger():
        if e["kind"] == kind:
            out["launches"] += e["launches"]
            out["deviceSeconds"] += e["deviceSeconds"]
    return out


def kind_launches() -> dict:
    """device_launches_total by kind so far."""
    from pilosa_tpu_torch.utils.stats import global_stats

    return {name.split('kind="')[1].rstrip('"}'): v for name, v in
            global_stats.counter_totals("device_launches_total").items()}


def phase_ledger(backend) -> None:
    """The program ledger against the launch counters after the main-path
    phases, in which this backend made every launch of the process: its
    launches equal device_launches_total in total and by kind, and no
    program recompiled."""
    counts = backend.programs.counts()
    by_kind: dict = {}
    for e in backend.programs.ledger():
        by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + e["launches"]
    counters = kind_launches()
    check(counts["launches"] == sum(counters.values()),
          f"ledger: {counts['launches']} launches against device_launches_total "
          f"{sum(counters.values())}")
    check(by_kind == {k: int(v) for k, v in counters.items() if v},
          f"ledger: launches by kind {by_kind} against the counters {counters}")
    check(counts["recompiles"] == 0, f"ledger: {counts['recompiles']} recompiles")
    log("ledger: " + json.dumps(counts) + " by kind " + json.dumps(by_kind)
        + " equal to device_launches_total")


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
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.utils.stats import global_stats

    dev = Executor(holder, backend=backend)
    routed_key = 'cpu_routed_total{call="GroupBy"}'
    routed0 = global_stats.counter_totals("cpu_routed_total").get(routed_key, 0)
    three = GROUP_QUERIES[3]
    per_request = {}
    latencies = {}
    answers = {}

    def request(label, q):
        before = query_launches()
        t0 = time.perf_counter()
        out = dev.execute("bench", q)
        torch.cuda.synchronize()
        latencies[label] = (time.perf_counter() - t0) * 1e3
        per_request[label] = {k: v - before[k] for k, v in query_launches().items()
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
    launches = query_launches()
    log("groupby: launches per request " + json.dumps(per_request))
    log("groupby: launches " + json.dumps(launches))
    want = {
        "GroupBy(Rows(f))": {"row_popcounts": 1},  # the TopN rank vector
        # A filter is one K11 launch in slab mode.
        "GroupBy(Rows(f), Rows(g), filter=Row(f=2))": {"pair_stats": 1, "spec_eval": 1},
        "3-field, cold": {"popcount_rows": 1, "group_tile_stats_pershard": 1},
        "3-field, warm": {},
        "3-field filtered": {"popcount_rows": 1, "group_tile_stats": 1, "spec_eval": 1},
        "3-field limit/offset": {},
    }
    for label, expect in want.items():
        check(per_request[label] == expect,
              f"groupby: {label} launched {per_request[label]}, expected {expect}")
    for name in ("group_tile_stats", "group_tile_stats_pershard", "popcount_rows",
                 "row_popcounts"):
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
            backend._topn_cache.clear()
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
    return launches, stacks, served


# ---------------------------------------------------------------------------
# phase 3b: TopN, Rows and the BSI plane
# ---------------------------------------------------------------------------

# bench.py build_bsi_field: per shard up to BSI_COLS unique columns from
# default_rng(43), values in [-BSI_ABS, BSI_ABS] of an int field over
# [-BSI_RANGE, BSI_RANGE] (bit depth 14: a 16-row BSI stack).
BSI_COLS = 50
BSI_ABS = 9000
BSI_RANGE = 10000
# Over the first ORACLE_SHARDS shards against the CPU oracle (run after the
# 954-shard phases, as groupby_oracle_check is).
BSI_ORACLE_QUERIES = [
    "Sum(Row(f=1), field=v)", "Min(Row(g=7), field=v)",
    "Max(Intersect(Row(f=2), Row(g=7)), field=v)",
    "Count(Intersect(Row(f=1), Row(v < 0)))", "Count(Shift(Row(f=1), n=3))",
    "Count(Shift(Row(f=2), n=32))", "Shift(Row(f=2), n=40)",
]


def build_bsi_field(holder):
    """bench.py build_bsi_field on the bench index: field v, per shard the
    unique columns of BSI_COLS draws and their values. Returns the imported
    (columns, values) arrays."""
    import numpy as np

    from pilosa_tpu_torch.core.field import options_for_int
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    idx = holder.index("bench")
    rng = np.random.default_rng(43)
    field = idx.create_field("v", options_for_int(-BSI_RANGE, BSI_RANGE))
    all_cols, all_vals = [], []
    for shard in range(SHARDS):
        cols = (np.unique(rng.integers(0, SHARD_WIDTH, BSI_COLS, dtype=np.uint64))
                + np.uint64(shard * SHARD_WIDTH))
        vals = rng.integers(-BSI_ABS, BSI_ABS + 1, cols.size)
        field.import_value(cols, vals)
        all_cols.append(cols)
        all_vals.append(vals)
    return np.concatenate(all_cols), np.concatenate(all_vals)


def numpy_minmax(vals, pick):
    """(value, count) of numpy's extreme ``pick`` over ``vals``."""
    best = int(pick(vals))
    return best, int((vals == best).sum())


def phase_bsi(holder, backend):
    """TopN, Rows, Sum, Min, Max and BSI conditions on the 954-shard index
    through the main path's Executor, each answer checked; launches per
    request; wall times with the caches dropped and cached; device
    profiles of TopN(f), Sum and Min."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.utils.stats import global_stats

    t_phase = time.perf_counter()
    cols, vals = build_bsi_field(holder)
    log(f"bsi: field v built in {time.perf_counter() - t_phase:.1f} s, {cols.size} values "
        f"over {SHARDS} shards, bit depth {holder.index('bench').field('v').bsi_group().bit_depth}")
    dev = Executor(holder, backend=backend)
    routed0 = sum(global_stats.counter_totals("cpu_routed_total").values())
    x = int(vals[len(vals) // 2])
    cond_queries = {
        "Count(Row(v > 100))": int((vals > 100).sum()),
        "Count(Row(v >< [-50, 50]))": int(((vals >= -50) & (vals <= 50)).sum()),
        f"Count(Row(v == {x}))": int((vals == x).sum()),
        "Count(Row(v != null))": int(vals.size),
        "Count(Row(v < -8990))": int((vals < -8990).sum()),
    }
    agg_queries = {
        "Sum(field=v)": (int(vals.sum()), int(vals.size)),
        "Min(field=v)": numpy_minmax(vals, np.min),
        "Max(field=v)": numpy_minmax(vals, np.max),
    }
    topn_queries = ["TopN(f, n=5)", "TopN(f)", "Rows(f)", "TopN(f, Row(g=7), n=3)",
                    "Rows(g, previous=2, limit=3)", "GroupBy(Rows(f))"]

    def drop_caches():
        with backend._pair_lock:
            backend._topn_cache.clear()
            backend._agg_cache.clear()

    per_request = {}
    answers = {}
    t0 = time.perf_counter()
    drop_caches()
    K.reset_launch_counts()
    for q in topn_queries + list(agg_queries) + list(cond_queries):
        before = query_launches()
        answers[q] = dev.execute("bench", q)[0]
        torch.cuda.synchronize()
        per_request[q] = {k: v - before[k] for k, v in query_launches().items()
                          if v != before[k]}
    launches = query_launches()
    log(f"bsi: first pass {time.perf_counter() - t0:.1f} s (the BSI stack build included)")
    log("bsi: launches per request " + json.dumps(per_request))
    want = {"TopN(f, n=5)": {"row_popcounts": 1}, "TopN(f)": {}, "Rows(f)": {},
            "TopN(f, Row(g=7), n=3)": {"row_popcounts": 1, "spec_eval": 1},
            "Rows(g, previous=2, limit=3)": {"row_popcounts": 1}, "GroupBy(Rows(f))": {},
            "Sum(field=v)": {"row_popcounts": 1, "popcount_rows": 1},
            "Min(field=v)": {"bsi_minmax": 1}, "Max(field=v)": {"bsi_minmax": 1}}
    # A condition is one K10 launch, its Count one K11; v != null reads the
    # exists row as it is.
    want.update({q: {"bsi_compare": 1, "spec_eval": 1} for q in cond_queries})
    want["Count(Row(v != null))"] = {"spec_eval": 1}
    for q, expect in want.items():
        check(per_request[q] == expect, f"bsi: {q} launched {per_request[q]}, expected {expect}")

    # TopN, Rows and GroupBy against the Count path (K11, one Count a row).
    f_counts = [dev.execute("bench", f"Count(Row(f={r}))")[0] for r in range(ROWS)]
    fg_counts = [dev.execute("bench", f"Count(Intersect(Row(f={r}), Row(g=7)))")[0]
                 for r in range(ROWS)]

    def ranked(counts):
        return sorted(((r, c) for r, c in enumerate(counts) if c), key=lambda p: (-p[1], p[0]))

    def pairs(result):
        return [(p.id, p.count) for p in result.pairs]

    check(pairs(answers["TopN(f)"]) == ranked(f_counts), "bsi: TopN(f) disagrees with Count")
    check(pairs(answers["TopN(f, n=5)"]) == ranked(f_counts)[:5], "bsi: TopN(f, n=5)")
    check(list(answers["Rows(f)"]) == [r for r in range(ROWS) if f_counts[r]], "bsi: Rows(f)")
    check(pairs(answers["TopN(f, Row(g=7), n=3)"]) == ranked(fg_counts)[:3],
          "bsi: TopN(f, Row(g=7), n=3) disagrees with the Count path")
    check(list(answers["Rows(g, previous=2, limit=3)"]) == [3, 4, 5],
          "bsi: Rows(g, previous=2, limit=3)")
    check(group_tuples(answers["GroupBy(Rows(f))"])
          == [((("f", r),), c) for r, c in enumerate(f_counts) if c],
          "bsi: GroupBy(Rows(f)) disagrees with the Count path")
    for q, (val, cnt) in agg_queries.items():
        got = answers[q]
        check((got.val, got.count) == (val, cnt),
              f"bsi: {q} = {(got.val, got.count)}, numpy says {(val, cnt)}")
    for q, n in cond_queries.items():
        check(answers[q] == n, f"bsi: {q} = {answers[q]}, numpy says {n}")
    log("bsi: answers agree with the Count path and numpy: " + json.dumps(
        {q: (pairs(a) if hasattr(a, "pairs") else
             [a.val, a.count] if hasattr(a, "val") else
             a if isinstance(a, int) else len(a))
         for q, a in answers.items()}))

    # Wall times: caches dropped (stacks resident) and cached.
    latencies = {}
    for q in topn_queries + list(agg_queries) + list(cond_queries):
        def uncached(q=q):
            drop_caches()
            return dev.execute("bench", q)
        _, med_cold, _ = host_ms(uncached)
        _, med_warm, _ = host_ms(lambda q=q: dev.execute("bench", q))
        latencies[q] = {"p50_caches_dropped_ms": med_cold, "p50_cached_ms": med_warm}
    log("bsi: latencies " + json.dumps(latencies))
    minmax_phases(dev, drop_caches)
    for q in ("TopN(f)", "Sum(field=v)", "Min(field=v)", "Count(Row(v > 100))"):
        def uncached(q=q):
            drop_caches()
            return dev.execute("bench", q)
        device_share(uncached, f"{q}, caches dropped")
    check(sum(global_stats.counter_totals("cpu_routed_total").values()) == routed0,
          "bsi: a request was routed to the CPU oracle")
    log_routed("bsi")
    log(f"bsi: phase seconds {time.perf_counter() - t_phase:.1f}")
    # The served inputs of K8, K9 and K10, for phase_bsi_kernels.
    from pilosa_tpu_torch.core.view import bsi_view_name

    depth = holder.index("bench").field("v").bsi_group().bit_depth
    vstack, _ = backend.blocks.get("bench", holder.index("bench").field("v"),
                                   tuple(range(SHARDS)), bsi_view_name("v"), 2 + depth)
    consider = vstack[:, 0, :]
    neg = (vstack[:, 1, :] & consider).contiguous()
    stacks = {"f": bench_stack(backend, holder, "f"), "v": vstack, "depth": depth,
              "src": bench_stack(backend, holder, "g")[:, 7, :].contiguous(),
              "neg": neg, "pos": (consider & ~neg).contiguous()}
    return launches, stacks


def minmax_phases(dev, drop_caches, reps: int = 5) -> None:
    """Uncached Min and Max broken into the backend's own profile phases
    (median ms of ``reps`` calls): freshness (the locked version walks
    before and after the sweep that the host tier's table records),
    stack_fetch, device_dispatch (the filter and K9's launch), readback
    (the table's copy to the host, which waits for K9), host_reduce (the
    per-shard values and the cross-shard reduce) and the rest of the
    executor's call (other)."""
    from pilosa_tpu_torch.utils.qprofile import profile_scope

    for q in ("Min(field=v)", "Max(field=v)"):
        runs = []
        for _ in range(reps):
            drop_caches()
            with profile_scope("bench", q) as prof:
                t0 = time.perf_counter()
                dev.execute("bench", q)
                wall = time.perf_counter() - t0
            phases = {k: v * 1e3 for k, v in prof.phases.items()}
            phases["other"] = wall * 1e3 - sum(phases.values())
            phases["wall"] = wall * 1e3
            runs.append(phases)
        med = {k: statistics.median(r.get(k, 0.0) for r in runs) for k in runs[0]}
        log(f"bsi: {q} caches dropped, median ms of {reps} by phase " + json.dumps(med))


def bsi_oracle_check(holder, backend):
    """BSI_ORACLE_QUERIES over the first ORACLE_SHARDS shards, against the
    CPU oracle (after every 954-shard phase: it replaces the resident
    stacks with 32-shard ones)."""
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.utils.stats import global_stats

    dev = Executor(holder, backend=backend)
    oracle = Executor(holder, backend=CPUBackend(holder))
    routed0 = sum(global_stats.counter_totals("cpu_routed_total").values())
    sub = list(range(ORACLE_SHARDS))
    for q in BSI_ORACLE_QUERIES:
        t0 = time.perf_counter()
        got = dev.execute("bench", q, shards=sub)
        check(same_answers(got, oracle.execute("bench", q, shards=sub)),
              f"bsi: {q} over {ORACLE_SHARDS} shards disagrees with the oracle")
        log(f"bsi: oracle agrees on {q} over {ORACLE_SHARDS} shards "
            f"({time.perf_counter() - t0:.1f} s)")
    check(sum(global_stats.counter_totals("cpu_routed_total").values()) == routed0,
          "bsi: an oracle-checked query was routed to the CPU oracle")
    log_routed("bsi oracle")


def groupby_oracle_check(holder, backend):
    """The GroupBy queries over the first shards, against the CPU oracle.
    This replaces the resident stacks with 32-shard ones, so it runs after
    every phase that serves the 954-shard index."""
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.utils.stats import global_stats

    dev = Executor(holder, backend=backend)
    oracle = Executor(holder, backend=CPUBackend(holder))
    routed_key = 'cpu_routed_total{call="GroupBy"}'
    routed0 = global_stats.counter_totals("cpu_routed_total").get(routed_key, 0)
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
# phase 3b: the HTTP server and the CLI
# ---------------------------------------------------------------------------

# Client windows of the throughput measurement: seconds each, and the
# client counts of the Count and of the pair and GroupBy requests; then
# the Count's in-process windows (threads calling Executor.execute, no
# HTTP), which part the HTTP layer's cost from the executor's.
HTTP_SECONDS = 2.0
HTTP_COUNT_CLIENTS = (1, 4, 16)
HTTP_OTHER_CLIENTS = (1, 4)
# Clients of the window whose every request misses the backend's caches,
# and its requests: the pair request and three GroupBys.
MISS_CLIENTS = 4
MISS_QUERIES = [PAIR_REQUEST, GROUP_QUERIES[2], GROUP_QUERIES[3], GROUP_QUERIES[4]]
# The churn window: clients sending the pair request and TopN(f) while a
# writer toggles one bit every CHURN_WRITE_SECONDS.
CHURN_CLIENTS = 4
CHURN_WRITE_SECONDS = 0.05
# The refresher's window in the churn window beside it (refresh-window-ms),
# and in the CLI's third server.
REFRESH_WINDOW_MS = 50
# Clients of the windows served from the result cache, and its budget.
CACHED_CLIENTS = (1, 16)
RESCACHE_BYTES = 64 << 20
INPROC_SECONDS = 1.0
INPROC_THREADS = (1, 4, 16)
# Calls of the single Count timed one after another by --host-count.
HOST_COUNT_CALLS = 2000
# The CLI's on-disk index: CLI_SHARDS shards, fields f and g of CLI_ROWS
# rows, CLI_BITS bits a row, imported through `cli import`.
CLI_SHARDS = 4
CLI_ROWS = 4
CLI_BITS = 3000
CLI_QUERIES = ["Count(Intersect(Row(f=1), Row(g=2)))", "Row(f=3)",
               "GroupBy(Rows(f), Rows(g))"]
# A Count of the CLI's index that the pair plan does not serve: one K11
# launch each time, for the explain check.
EXPLAIN_COUNT = "Count(Union(Row(f=1), Row(g=2), Row(g=3)))"
# The budgeted CLI server's max-hbm-bytes: four row pages of the 4-shard
# index, half of one of its 8-row stacks.
CLI_BUDGET = 4 * CLI_SHARDS * 32768 * 4


def http_post(conn, path, body, headers=None):
    """One request on a keep-alive connection -> (status, body)."""
    conn.request("POST", path, body=body, headers=headers or {})
    r = conn.getresponse()
    return r.status, r.read()


def load_window(n: int, seconds: float, make_worker) -> dict:
    """n threads, each running the request make_worker(i) returns over
    and over for `seconds`: requests/s, p50/p99 latency, and the count of
    requests whose answer was wrong (the request returns False)."""
    import threading

    lat = [[] for _ in range(n)]
    bad = [0] * n
    ready = threading.Barrier(n + 1)
    stop = [0.0]

    def run(i):
        request = make_worker(i)
        ready.wait()
        while time.perf_counter() < stop[0]:
            t0 = time.perf_counter()
            ok = request()
            lat[i].append(time.perf_counter() - t0)
            bad[i] += not ok

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    stop[0] = t0 + seconds
    ready.wait()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    all_lat = sorted(x for per in lat for x in per)
    q = lambda p: all_lat[min(len(all_lat) - 1, int(p * len(all_lat)))] * 1e3
    return {"clients": n, "requests": len(all_lat), "seconds": elapsed,
            "rps": len(all_lat) / elapsed, "p50_ms": q(0.50), "p99_ms": q(0.99),
            "mismatches": sum(bad)}


def round_robin(items, i: int, n: int):
    """Worker i of n's endless walk over items, offset by i."""
    k = i
    while True:
        yield items[k % len(items)]
        k += n


def http_load(spec: dict) -> dict:
    """Client side of one throughput window, run in a process of its own
    (`chip_smoke.py --http-load SPEC`) so that the clients do not share
    the server's interpreter lock: spec["clients"] threads, each with its
    own keep-alive connection, send spec["queries"] (body, expected
    response) round robin for spec["seconds"]; every response is held
    against its expected bytes."""
    import http.client

    queries = [(q.encode("latin-1"), want.encode("latin-1"))
               for q, want in spec["queries"]]
    n = spec["clients"]

    def client(i):
        conn = http.client.HTTPConnection(spec["host"], spec["port"], timeout=120)
        walk = round_robin(queries, i, n)

        def request():
            body, want = next(walk)
            return http_post(conn, spec["path"], body) == (200, want)

        return request

    return load_window(n, spec["seconds"], client)


def inproc_load(dev, queries, expected, threads: int, seconds: float) -> dict:
    """Requests without HTTP: `threads` threads of this process call
    dev.execute on `queries` round robin for `seconds`, every answer
    checked against `expected`."""
    def worker(i):
        walk = round_robin(queries, i, threads)

        def request():
            q = next(walk)
            return dev.execute("bench", q) == expected[q]

        return request

    return load_window(threads, seconds, worker)


def batch_counters() -> tuple:
    """(batch legs, device programs, kernel launches, occupancy sum,
    occupancy count) so far: the batcher's and the backend's counters."""
    from pilosa_tpu_torch.utils.stats import global_stats

    occ = [v for k, v in global_stats.histogram_snapshot().items()
           if k.startswith("batch_occupancy")]
    return (sum(global_stats.counter_totals("batch_legs_total").values()),
            sum(global_stats.counter_totals("device_launches_total").values()),
            sum(query_launches().values()),
            sum(v["sum"] for v in occ), sum(v["count"] for v in occ))


def batch_delta(before: tuple) -> dict:
    """What a window added to batch_counters(): legs the batcher took,
    programs the backend ran (device_launches_total), kernels launched,
    and the mean legs a coalesced group (batch_occupancy)."""
    legs, programs, kernels, occ_sum, occ_n = (
        a - b for a, b in zip(batch_counters(), before))
    return {"batch_legs": legs, "device_launches": programs, "kernel_launches": kernels,
            "mean_batch_occupancy": occ_sum / occ_n if occ_n else None}


def run_http_load(spec: dict) -> dict:
    """One window of http_load in a child process of this script."""
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(spec, f)
    try:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--http-load",
                              f.name], capture_output=True, text=True,
                             timeout=spec["seconds"] + 120)
    finally:
        os.unlink(f.name)
    check(out.returncode == 0, f"http: load client failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def toggle_column(holder) -> int:
    """A column of shard 0 that lies in h=0 and in some g row but not in
    f=1: setting f=1 there moves the 3-field GroupBy's answer."""
    def frag(name):
        return holder.index("bench").field(name).view("standard").fragment(0)

    f1, g, h0 = frag("f").row(1), frag("g"), frag("h").row(0)
    g_rows = [g.row(r) for r in range(ROWS)]
    for col in h0.columns():
        col = int(col)
        if not f1.includes_column(col) and any(r.includes_column(col) for r in g_rows):
            return col
    raise AssertionError("http: no column to toggle in shard 0")


# The phases the cache-missing window's time is split into; every other
# phase a request records is summed under "rest".
SPLIT_PHASES = ("freshness", "stack_fetch", "device_dispatch", "host_reduce",
                "batch_wait", "other")


def phase_split_totals() -> tuple:
    """(query_phase_seconds sums by (call, phase), version_walk_total and
    version_walk_shards_total by (kind, tier)) so far."""
    import re

    from pilosa_tpu_torch.utils.stats import global_stats

    def tags(name):
        return dict(re.findall(r'(\w+)="([^"]*)"', name))

    phases = {}
    for name, (total, _) in global_stats.timing_totals("query_phase_seconds").items():
        t = tags(name)
        phases[(t.get("call", "?"), t.get("phase", "?"))] = total
    walks = {}
    for counter in ("version_walk_total", "version_walk_shards_total"):
        for name, v in global_stats.counter_totals(counter).items():
            t = tags(name)
            walks[(counter, t.get("kind", "?"), t.get("tier", "?"))] = v
    return phases, walks


def phase_split(before: tuple) -> dict:
    """What a window added to phase_split_totals(): the requests' summed
    query_phase_seconds by phase and by call and phase (SPLIT_PHASES, the
    rest summed), and the version walks and the locked reads they took by
    kind and tier."""
    phases0, walks0 = before
    phases1, walks1 = phase_split_totals()
    by_phase = {p: 0.0 for p in SPLIT_PHASES + ("rest",)}
    by_call = {}
    for (call, phase), total in phases1.items():
        d = total - phases0.get((call, phase), 0.0)
        if d <= 0:
            continue
        key = phase if phase in SPLIT_PHASES else "rest"
        by_phase[key] += d
        calls = by_call.setdefault(call, {})
        calls[key] = calls.get(key, 0.0) + d
    walks = {}
    for (counter, kind, tier), v in walks1.items():
        d = v - walks0.get((counter, kind, tier), 0)
        if d:
            walks[f"{counter}{{kind={kind},tier={tier}}}"] = d
    return {"phase_seconds": by_phase, "phase_seconds_by_call": by_call,
            "version_walks": walks}


def miss_window(port: int, path: str, backend, dev, queries, col: int,
                clients: int, seconds: float) -> dict:
    """`clients` threads of this process, each with its own keep-alive
    connection, send `queries` in a seeded random order (so that two
    threads often miss the same entry at once), and each drops the backend's
    pair, agg and groupn caches (under their lock) before every request,
    so that every request misses and concurrent misses race through the
    build latches. Meanwhile a writer thread toggles bit (f=1, col) with
    Set and Clear over HTTP, so the stacks are spliced under the readers.
    Every answer must equal the single-threaded answer of one of the two
    epochs, and both epochs must be served. The window's time is split by
    phase and call (phase_split)."""
    import http.client
    import random
    import threading

    from pilosa_tpu_torch.utils import fastjson

    def body(results):
        return fastjson.response_body([fastjson.encode_result(r) for r in results])

    to_b, to_a = f"Set({col}, f=1)", f"Clear({col}, f=1)"
    check(dev.execute("bench", to_b) == [True], f"http: {to_b} changed nothing")
    epoch_b = {q: body(dev.execute("bench", q)) for q in queries}
    check(dev.execute("bench", to_a) == [True], f"http: {to_a} changed nothing")
    epoch_a = {q: body(dev.execute("bench", q)) for q in queries}
    moved = [q for q in queries if epoch_a[q] != epoch_b[q]]
    check(moved, "http: the toggled bit moves no answer of the window")
    seen = {"a": 0, "b": 0}
    seen_lock = threading.Lock()

    def reader(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        pick = random.Random(i).choice

        def request():
            q = pick(queries)
            with backend._pair_lock:
                backend._pair_cache.clear()
                backend._agg_cache.clear()
                backend._groupn_cache.clear()
            status, got = http_post(conn, path, q.encode())
            if q in moved and got in (epoch_a[q], epoch_b[q]):
                with seen_lock:
                    seen["a" if got == epoch_a[q] else "b"] += 1
            return status == 200 and got in (epoch_a[q], epoch_b[q])

        return request

    done = threading.Event()
    writes = {"n": 0, "bad": 0}

    def writer():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        in_b = False
        while not done.is_set() or in_b:
            status, got = http_post(conn, path, (to_a if in_b else to_b).encode())
            writes["n"] += 1
            writes["bad"] += status != 200 or got != body([True])
            in_b = not in_b
            if not done.is_set():
                time.sleep(0.05)
        conn.close()

    before, split0 = query_launches(), phase_split_totals()
    w = threading.Thread(target=writer)
    w.start()
    try:
        r = load_window(clients, seconds, reader)
    finally:
        done.set()
        w.join()
    after = query_launches()
    r.update(phase_split(split0))
    r["request"] = "cache-missing mix under Set/Clear epochs"
    r["launches_per_request"] = {k: (after[k] - before[k]) / max(1, r["requests"])
                                 for k in after if after[k] != before[k]}
    r["writes"] = writes["n"]
    r["answers_per_epoch"] = seen
    check(writes["bad"] == 0, f"http: {writes['bad']} of {writes['n']} writes failed")
    check(r["mismatches"] == 0,
          f"http: {r['mismatches']} cache-missing answers match neither epoch")
    check(seen["a"] > 0 and seen["b"] > 0, f"http: one epoch was never served {seen}")
    for name in ("pair_stats_pershard", "pair_stats", "group_tile_stats",
                 "group_tile_stats_pershard"):
        check(after[name] > before[name], f"http: {name} never launched in the miss window")
    check(all(body(dev.execute("bench", q)) == epoch_a[q] for q in queries),
          "http: the index did not end in its first epoch")
    return r


# The table tiers' counters the churn windows read (pilosa_tpu_torch/exec/cuda.py).
TIER_COUNTERS = ("pair_stats_sweeps_total", "pair_stats_incremental_updates_total",
                 "pair_stats_incremental_shards_total", "pair_stats_delta_ops_total",
                 "topn_incremental_updates_total", "topn_incremental_shards_total",
                 "groupn_incremental_updates_total", "groupn_incremental_shards_total",
                 "groupn_delta_ops_total", "sum_incremental_updates_total",
                 "minmax_incremental_updates_total", "minmax_shard_rederives_total",
                 "version_walk_total", "version_walk_shards_total")
# The sweeps a table's host tier takes the place of: K1 and K2 (pair), K8
# (TopN; Sum's planes), K5 and K3 (the 3-field GroupBy; K3 also Sum's
# considered count) and K9 (Min, Max).
SWEEP_KERNELS = ("pair_stats_pershard", "pair_stats", "row_popcounts",
                 "group_tile_stats_pershard", "popcount_rows", "bsi_minmax")
# The aggregate churn window's requests, and the value its writer swaps
# with v's largest one: below every value of v, inside its range.
AGG_QUERIES = ["Sum(field=v)", "Min(field=v)", "Max(field=v)"]
AGG_CHURN_VALUE = -9500


def churn_column(holder) -> int:
    """A column of shard 0 in some row of g and of h but in neither f=1
    nor g=4: toggling f=1 there moves the pair request's Union(Row(f=1),
    Row(g=4)) Counts, TopN(f) and the 3-field GroupBy."""
    def frag(name):
        return holder.index("bench").field(name).view("standard").fragment(0)

    f1, g, h = frag("f").row(1), frag("g"), frag("h")
    g_rows = [g.row(r) for r in range(ROWS)]
    h_rows = [h.row(r) for r in range(H_ROWS)]
    for col in g_rows[0].columns():
        col = int(col)
        if (not f1.includes_column(col) and not g_rows[4].includes_column(col)
                and any(r.includes_column(col) for r in h_rows)):
            return col
    raise AssertionError("churn: no column to toggle in shard 0")


def tier_totals() -> dict:
    from pilosa_tpu_torch.utils.stats import global_stats

    return {name: sum(global_stats.counter_totals(name).values()) for name in TIER_COUNTERS}


def epoch_window(label: str, port: int, path: str, dev, queries, to_b: str, to_a: str,
                 clients: int, seconds: float, kernels, counters, rederive: bool) -> dict:
    """The churn windows' common body: `clients` threads of this process,
    each with its own keep-alive connection, send `queries` in a seeded
    random order, without dropping any cache, while a writer swaps the
    index between two epochs with the writes to_b and to_a over HTTP every
    CHURN_WRITE_SECONDS, so every write epoch meets the backend's tables.
    After one warm-up request of each kind, counts the launches of the
    sweep kernels and the tiers' counters over the window. Every answer
    must equal the single-threaded answer of one of the two epochs, both
    epochs must be served, every answer must move between them and at
    least 20 writes must land. `kernels` may not launch in the window and
    `counters` must grow (empty for a package without the tiers); with
    `rederive`, minmax_shard_rederives_total must grow too."""
    import http.client
    import random
    import threading

    from pilosa_tpu_torch.utils import fastjson

    def body(results):
        return fastjson.response_body([fastjson.encode_result(r) for r in results])

    check(dev.execute("bench", to_b) == [True], f"{label}: {to_b} changed nothing")
    epoch_b = {q: body(dev.execute("bench", q)) for q in queries}
    check(dev.execute("bench", to_a) == [True], f"{label}: {to_a} changed nothing")
    epoch_a = {q: body(dev.execute("bench", q)) for q in queries}
    check(all(epoch_a[q] != epoch_b[q] for q in queries),
          f"{label}: the write does not move every answer of the window")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    for q in queries:  # the warm-up request of each kind
        check(http_post(conn, path, q.encode()) == (200, epoch_a[q]),
              f"{label}: a warm-up answer disagrees with the in-process executor")
    conn.close()
    seen = {"a": 0, "b": 0}
    seen_lock = threading.Lock()

    def reader(i):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        pick = random.Random(i).choice

        def request():
            q = pick(queries)
            status, got = http_post(c, path, q.encode())
            if got in (epoch_a[q], epoch_b[q]):
                with seen_lock:
                    seen["a" if got == epoch_a[q] else "b"] += 1
            return status == 200 and got in (epoch_a[q], epoch_b[q])

        return request

    done = threading.Event()
    writes = {"n": 0, "bad": 0}

    def writer():
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        in_b = False
        while not done.is_set() or in_b:
            status, got = http_post(c, path, (to_a if in_b else to_b).encode())
            writes["n"] += 1
            writes["bad"] += status != 200 or got != body([True])
            in_b = not in_b
            if not done.is_set():
                time.sleep(CHURN_WRITE_SECONDS)
        c.close()

    before, t0 = query_launches(), tier_totals()
    rf0, kl0 = refresh_totals(), kind_launches()
    w = threading.Thread(target=writer)
    w.start()
    try:
        r = load_window(clients, seconds, reader)
    finally:
        done.set()
        w.join()
    after, t1 = query_launches(), tier_totals()
    rf1, kl1 = refresh_totals(), kind_launches()
    r["refresh"] = {k: rf1[k] - rf0[k] for k in REFRESH_COUNTERS}
    r["launches_by_kind"] = {k: v - kl0.get(k, 0) for k, v in kl1.items()
                             if v != kl0.get(k, 0)}
    n = max(1, r["requests"])
    r["launches_per_request"] = {k: (after[k] - before[k]) / n for k in SWEEP_KERNELS}
    r["launches"] = {k: after[k] - before[k] for k in SWEEP_KERNELS}
    r["tiers"] = {k: t1[k] - t0[k] for k in TIER_COUNTERS}
    r["writes"] = writes["n"]
    r["answers_per_epoch"] = seen
    check(writes["bad"] == 0, f"{label}: {writes['bad']} of {writes['n']} writes failed")
    check(writes["n"] >= 20, f"{label}: only {writes['n']} writes in the window")
    check(r["mismatches"] == 0, f"{label}: {r['mismatches']} answers match neither epoch")
    check(seen["a"] > 0 and seen["b"] > 0, f"{label}: one epoch was never served {seen}")
    for name in kernels:
        check(after[name] == before[name],
              f"{label}: {name} launched {after[name] - before[name]} times in the window")
    for name in counters:
        check(r["tiers"][name] > 0, f"{label}: {name} did not grow")
    if rederive:
        check(r["tiers"]["minmax_shard_rederives_total"] > 0,
              f"{label}: no Min/Max shard was re-derived")
    check(all(body(dev.execute("bench", q)) == epoch_a[q] for q in queries),
          f"{label}: the index did not end in its first epoch")
    return r


#: The stack counters of the windowed refresher.
REFRESH_COUNTERS = ("stack_windowed_refresh_total", "stack_refresh_forced_total",
                    "stack_full_rebuilds_total")


def refresh_totals() -> dict:
    from pilosa_tpu_torch.utils.stats import global_stats

    return {n: sum(global_stats.counter_totals(n).values()) for n in REFRESH_COUNTERS}


def churn_window(port: int, path: str, backend, dev, pair_request: str, col: int,
                 clients: int, seconds: float) -> dict:
    """The churn window: the 16-Count pair request, TopN(f) and the
    3-field GroupBy while a writer toggles bit (f=1, col) with Set and
    Clear (epoch_window). Where the package has the pair and TopN tiers, no
    K1, K2 or K8 may launch after the warm-up and their incremental
    counters must grow; where it has the GroupN tier, no K5 or K3 either,
    and groupn_incremental_updates_total must grow."""
    kernels, counters = [], []
    if hasattr(backend, "_pair_try_incremental"):
        kernels += ["pair_stats_pershard", "pair_stats", "row_popcounts"]
        counters += ["pair_stats_incremental_updates_total", "topn_incremental_updates_total"]
    if hasattr(backend, "_groupn_try_incremental"):
        kernels += ["group_tile_stats_pershard", "popcount_rows"]
        counters += ["groupn_incremental_updates_total"]
    r = epoch_window("churn", port, path, dev, [pair_request, "TopN(f)", GROUP_QUERIES[3]],
                     f"Set({col}, f=1)", f"Clear({col}, f=1)", clients, seconds,
                     kernels, counters, rederive=False)
    r["request"] = "16-Count pair request, TopN(f) and 3-field GroupBy under Set/Clear epochs"
    return r


def count_churn_window(port: int, path: str, dev, col: int, clients: int,
                       seconds: float) -> dict:
    """Single Counts under writes: 3-row Counts of f=1, g=0 and the h row
    of `col`, whose K11 launch fetches f's stack, while a writer toggles
    bit (f=1, col) with Set and Clear (epoch_window), so each read after a
    write meets a stale stack: the traffic the windowed refresher is for."""
    h = dev.holder.index("bench").field("h").view("standard").fragment(0)
    c = next(r for r in range(H_ROWS) if h.row(r).includes_column(col))
    q = f"Count(Intersect(Row(f=1), Row(g=0), Row(h={c})))"
    r = epoch_window("count churn", port, path, dev, [q], f"Set({col}, f=1)",
                     f"Clear({col}, f=1)", clients, seconds, [], [], rederive=False)
    r["request"] = f"{q} under Set/Clear epochs"
    return r


def refresh_windows(port: int, path: str, backend, dev, pair_request: str,
                    col: int) -> list:
    """The churn window and the single Counts' churn window, each without
    and with the windowed refresher at REFRESH_WINDOW_MS (the server of
    `cli server` with refresh-window-ms): requests/s, p50/p99, the
    refresher's counters and the launches by kind of each; every answer
    checked, and no stack rebuilt whole in any."""
    t_phase = time.perf_counter()
    out = []
    for mix, refresher in (("churn", False), ("churn", True),
                           ("count churn", False), ("count churn", True)):
        if refresher:
            backend.start_refresher(REFRESH_WINDOW_MS)
        try:
            if mix == "churn":
                r = churn_window(port, path, backend, dev, pair_request, col,
                                 CHURN_CLIENTS, HTTP_SECONDS)
            else:
                r = count_churn_window(port, path, dev, col, CHURN_CLIENTS, HTTP_SECONDS)
        finally:
            backend.stop_refresher()
        r["wiring"] = (f"batcher + refresher at {REFRESH_WINDOW_MS} ms" if refresher
                       else "batcher, no refresher")
        check(r["refresh"]["stack_full_rebuilds_total"] == 0,
              f"refresh: a stack was rebuilt whole in the window ({r['wiring']})")
        if refresher and mix == "churn":
            # The churn mix's tables fetch no stack: only the refresher
            # refreshes f's. In the count mix reads may beat it to each.
            check(r["refresh"]["stack_windowed_refresh_total"] > 0,
                  "refresh: the refresher refreshed no stack in its window")
        r["mix"] = mix
        out.append(r)
        log("refresh: throughput " + json.dumps(r))
    log(f"refresh: phase seconds {time.perf_counter() - t_phase:.1f}")
    return out


def value_column(holder, fname: str, value: int) -> int:
    """The first column whose value of int field `fname` is `value`, found
    on the host (the shard from each fragment's own maximum walk)."""
    from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT

    fld = holder.index("bench").field(fname)
    for shard in range(SHARDS):
        val, cnt = fld.max(None, shard)
        if cnt and val == value:
            frag = fld._bsi_fragment(shard)
            for c in frag.row(BSI_EXISTS_BIT).columns():
                if fld.value(int(c)) == (value, True):
                    return int(c)
    raise AssertionError(f"no column of {fname} holds {value}")


def agg_churn_window(port: int, path: str, backend, dev, clients: int,
                     seconds: float) -> dict:
    """The aggregate churn window: Sum, Min and Max of v while a writer
    swaps the column of v's largest value between that value and
    AGG_CHURN_VALUE (epoch_window). One way Min moves in O(1) and Max
    re-derives the column's shard; the other way the reverse. Where the
    package has the Sum and Min/Max tiers, no K8, K3 or K9 may launch after
    the warm-up, both tiers' counters must grow and a shard must be
    re-derived."""
    vmax = dev.execute("bench", "Max(field=v)")[0].val
    col = value_column(dev.holder, "v", vmax)
    kernels, counters = [], []
    absorbed = hasattr(backend, "_sum_try_incremental")
    if absorbed:
        kernels = ["row_popcounts", "popcount_rows", "bsi_minmax"]
        counters = ["sum_incremental_updates_total", "minmax_incremental_updates_total"]
    r = epoch_window("agg churn", port, path, dev, AGG_QUERIES,
                     f"Set({col}, v={AGG_CHURN_VALUE})", f"Set({col}, v={vmax})",
                     clients, seconds, kernels, counters, rederive=absorbed)
    r["request"] = f"Sum, Min and Max of v while column {col} swaps {vmax} and {AGG_CHURN_VALUE}"
    return r


def phase_window(root, which: str) -> int:
    """`chip_smoke.py --churn|--miss [--root DIR]`: the two churn windows
    or the cache-missing window (miss_window) alone, on bench.py's index (f,
    g and h at 954 shards; the churn windows with its BSI field v too)
    served by DIR's package as `cli server` wires it (the batcher beside the
    device backend), so that two trees can be compared in turns in one
    call. Prints the card and one JSON line a window; each table's
    zero-launch checks apply when the package has its host tier."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.batcher import ShardLegBatcher
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.server import API, Server

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    holder = Holder(None).open()
    t0 = time.perf_counter()
    build_bench_index(holder)
    log(f"{which}: index build seconds {time.perf_counter() - t0:.1f}")
    backend = CUDABackend(holder)
    dev = Executor(holder, backend=backend)
    dev.batcher = ShardLegBatcher(backend)
    server = Server(API(holder, dev), host="127.0.0.1", port=0).open()
    path = "/index/bench/query"
    try:
        if which == "churn":
            t0 = time.perf_counter()
            build_bsi_field(holder)
            log(f"churn: field v built in {time.perf_counter() - t0:.1f} s")
            rs = [churn_window(server.port, path, backend, dev, PAIR_REQUEST,
                               churn_column(holder), CHURN_CLIENTS, HTTP_SECONDS),
                  agg_churn_window(server.port, path, backend, dev, CHURN_CLIENTS,
                                   HTTP_SECONDS)]
        else:
            rs = [miss_window(server.port, path, backend, dev, MISS_QUERIES,
                              toggle_column(holder), MISS_CLIENTS, HTTP_SECONDS)]
    finally:
        server.close()
        holder.close()
    for r in rs:
        r["package"] = root
        log(f"{which}: throughput " + json.dumps(r))
    return 0


def phase_budget_alone(root) -> int:
    """`chip_smoke.py --budget`: bench.py's index with its BSI field v, the
    row-paging phase over it and the CLI's two servers."""
    import torch

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec.cuda import CUDABackend

    card_line = phase_card()
    phase_probe(card_line)
    holder = Holder(None).open()
    t0 = time.perf_counter()
    build_bench_index(holder)
    build_bsi_field(holder)
    log(f"budget: index build seconds {time.perf_counter() - t0:.1f}")
    backend = CUDABackend(holder)
    phase_budget(holder, backend)
    holder.close()
    del backend
    torch.cuda.empty_cache()
    phase_cli(root)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase_cold_alone(root) -> int:
    """`chip_smoke.py --cold`: bench.py's index with its BSI field v, the
    cold-build phase over it (with r and s) and the expansion kernels'
    checks, launch floor and times (phase_expand_kernels)."""
    import torch

    from pilosa_tpu_torch.core import Holder

    card_line = phase_card()
    phase_probe(card_line)
    holder = Holder(None).open()
    t0 = time.perf_counter()
    build_bench_index(holder)
    build_bsi_field(holder)
    log(f"cold: index build seconds {time.perf_counter() - t0:.1f}")
    launches, capture = phase_cold_build(holder)
    holder.close()
    lines = phase_expand_kernels(capture, launches)
    del capture
    torch.cuda.empty_cache()
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase_stacks_exact(holder, backend, gstacks, rebuilds_before: float):
    """After phase 4's write windows (Set/Clear epochs beside concurrent
    readers, with and without the refresher splicing in place): the main
    backend's stacks of f, g, h and v's BSI view, refreshed to the last
    write, equal the stacks a fresh backend packs from the holder, bit for
    bit; phase 3's stacks are still the resident tensors (a splice writes
    in place; only a full rebuild replaces one), and no stack was rebuilt
    whole since rebuilds_before (stack_full_rebuilds_total before phase
    4), so the odometer cross-check sweeps the index's last epoch."""
    import torch

    from pilosa_tpu_torch.core.fragment import BSI_OFFSET_BIT
    from pilosa_tpu_torch.core.view import VIEW_STANDARD, bsi_view_name
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.utils.stats import global_stats

    t0 = time.perf_counter()
    idx = holder.index("bench")
    fresh = CUDABackend(holder)
    shards = tuple(range(SHARDS))
    same = []
    for name, view, min_rows in (
            ("f", VIEW_STANDARD, 1), ("g", VIEW_STANDARD, 1), ("h", VIEW_STANDARD, 1),
            ("v", bsi_view_name("v"), BSI_OFFSET_BIT + idx.field("v").options.bit_depth)):
        field = idx.field(name)
        got, _ = backend.blocks.get("bench", field, shards, view, min_rows)
        want, _ = fresh.blocks.get("bench", field, shards, view, min_rows)
        check(torch.equal(got, want),
              f"stacks: the resident {name} stack differs from a fresh pack of the holder")
        if name in gstacks:
            same.append((name, gstacks[name] is got))
    counters = {n: sum(global_stats.counter_totals(n).values()) for n in
                ("stack_incremental_updates_total", "stack_full_rebuilds_total")}
    del fresh
    torch.cuda.empty_cache()
    check(counters["stack_full_rebuilds_total"] == rebuilds_before,
          f"stacks: {counters['stack_full_rebuilds_total'] - rebuilds_before} stacks "
          "were rebuilt whole since phase 4 began")
    check(all(ok for _, ok in same), f"stacks: a phase 3 stack was replaced {same}")
    log(f"stacks: the resident f, g, h and v stacks equal fresh packs after the write "
        f"windows; phase 3's stacks still resident {same}; {json.dumps(counters)}; "
        f"{time.perf_counter() - t0:.1f} s")


class LogLines:
    """A logger that keeps its lines (preheat's)."""

    def __init__(self):
        self.lines = []

    def printf(self, fmt, *args):
        self.lines.append(fmt % args)


#: The first requests timed after preheat and on a cold backend.
FIRST_CALLS = [("Count", "Count(Intersect(Row(f=1), Row(g=2)))"), ("TopN(f)", "TopN(f)"),
               ("16-Count pair request", PAIR_REQUEST), ("3-field GroupBy", GROUP_QUERIES[3])]


def phase_preheat(holder):
    """Preheat at 954 shards: bench.py's index alone (the phase drops the
    other indexes of the holder first), a fresh CUDABackend's preheat()
    (seconds, stacks made resident, resident bytes, the seconds of its
    library load, _preheat_programs, which launches nothing), then the
    first Count, TopN(f),
    16-Count pair request and 3-field GroupBy on it, each timed to its
    readback, which must upload nothing (the HBM ledger's uploads); then
    the same four calls on a cold backend, whose answers the preheated
    ones must equal."""
    import torch

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.ops import build

    t_phase = time.perf_counter()
    for name in list(holder.indexes):
        if name != "bench":
            holder.delete_index(name)
    torch.cuda.empty_cache()
    lines = LogLines()
    warm = CUDABackend(holder)
    programs_s = [0.0]
    inner = warm._preheat_programs

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            programs_s[0] += time.perf_counter() - t

    warm._preheat_programs = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = warm.preheat(logger=lines)
    torch.cuda.synchronize()
    preheat_s = time.perf_counter() - t0
    check(not lines.lines, f"preheat: {lines.lines}")
    keys = [(e["field"], e["view"]) for e in warm.blocks.ledger()]
    check(n == len(keys) and {("f", "standard"), ("g", "standard"), ("h", "standard"),
                              ("v", "bsig_v")} <= set(keys),
          f"preheat: {n} stacks resident: {keys}")
    uploads = sum(e["uploads"] for e in warm.blocks.ledger())
    check(warm.programs.counts()["launches"] == 0, "preheat: preheat launched a kernel")
    log(f"preheat: {n} stacks resident ({keys}) in {preheat_s:.3f} s, "
        f"{warm.blocks.resident_bytes()} bytes; its library load (_preheat_programs) "
        f"{programs_s[0]:.4f} s, 0 s of it loading (this process loaded the "
        f"libraries in phase 1: {build.load_seconds:.3f} s, nvcc "
        f"{build.build_seconds:.3f} s); ledger {json.dumps(warm.programs.counts())}")

    def first_calls(backend):
        dev = Executor(holder, backend=backend)
        out = {}
        for label, q in FIRST_CALLS:
            torch.cuda.synchronize()
            t = time.perf_counter()
            ans = dev.execute("bench", q)
            torch.cuda.synchronize()
            out[label] = (time.perf_counter() - t, ans)
        return out

    hot = first_calls(warm)
    check(sum(e["uploads"] for e in warm.blocks.ledger()) == uploads,
          "preheat: a first call after preheat uploaded a stack")
    cold_be = CUDABackend(holder)
    cold = first_calls(cold_be)
    for label, _ in FIRST_CALLS:
        check(same_answers(hot[label][1], cold[label][1]),
              f"preheat: {label} after preheat disagrees with the cold backend's")
    log("preheat: first calls seconds " + json.dumps(
        {label: {"after preheat": hot[label][0], "cold": cold[label][0]}
         for label, _ in FIRST_CALLS}))
    del warm, cold_be
    torch.cuda.empty_cache()
    log(f"preheat: phase seconds {time.perf_counter() - t_phase:.1f}")


# ---------------------------------------------------------------------------
# phase 4c: the chunked cold build (ops/sparse.py) against the dense build
# ---------------------------------------------------------------------------

#: The run-heavy field r, in an index of its own: 954 shards x 8 rows, every
#: roaring container of a row one column interval of RUN_MIN to RUN_MAX
#: columns, imported as run containers.
RUN_MIN, RUN_MAX = 1000, 60000
COLD_ROUNDS = 2
#: The paths every stack is built by: "dense" packs the stack on the host
#: and copies it whole (MIN_CHUNKED_WORDS past the stack, the container
#: tier off: the parent's path), "chunked" streams it (ops/sparse.py). v is
#: also built by "words": streamed with the container tier off, so that its
#: chunks take the words tier and expand through K14.
COLD_PATHS = ("dense", "chunked")


def build_run_field(holder):
    """r: per shard, one roaring Bitmap whose every container (8 rows x 16
    containers) holds one run of RUN_MIN to RUN_MAX columns at a random
    offset, imported with Field.import_roaring; every container of every
    fragment must be a run container."""
    import numpy as np

    from pilosa_tpu_torch.roaring.bitmap import Bitmap, Container
    from pilosa_tpu_torch.roaring.codec import serialize
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(11)
    field = holder.create_index("runs").create_field("r")
    keys = ROWS * (SHARD_WIDTH >> 16)
    for shard in range(SHARDS):
        lens = rng.integers(RUN_MIN, RUN_MAX + 1, keys)
        starts = (rng.random(keys) * (65536 - lens)).astype(np.int64)
        bm = Bitmap()
        for key in range(keys):
            bm.put_container(key, Container.from_runs(
                np.array([[starts[key], starts[key] + lens[key] - 1]], dtype=np.int64)))
        field.import_roaring(shard, serialize(bm))
    kinds = set()
    for shard in range(SHARDS):
        fr = field.view("standard").fragment(shard)
        with fr.lock:
            fr.storage.optimize()
            kinds |= {fr.storage.container(k).typ for k in fr.storage.keys()}
    check(kinds == {"run"}, f"cold: r's containers are {kinds}, not runs")


#: The skewed field s, in an index of its own: 954 shards x 8 rows, row 0
#: broad (every roaring container a bitmap container of random words, bit
#: density 0.5) and rows 1 to 7 narrow (array containers of about 655
#: positions, bit density SKEW_NARROW): a segment field whose majority row
#: puts bitmap containers into every chunk, so that each chunk takes the
#: container tier with a word-mask remainder (K12 and K14 once a chunk).
SKEW_NARROW = 0.01
#: Chunks of a 954-shard, 8-row stack: 32 shards a 2^23-word chunk.
SKEW_CHUNKS = 30


def roaring_blob(entries) -> bytes:
    """Pilosa's roaring file (roaring/codec.py serialize's layout, no op
    log) of (key, type code, bit count, body) entries in key order, with no
    re-encoding: each container keeps the type it is given."""
    import struct

    from pilosa_tpu_torch.roaring.codec import MAGIC_NUMBER, STORAGE_VERSION

    out = bytearray(struct.pack("<II", MAGIC_NUMBER | (STORAGE_VERSION << 16), len(entries)))
    for key, typ, n, _ in entries:
        out += struct.pack("<QHH", key, typ, n - 1)
    offset = 8 + 16 * len(entries)
    for *_, body in entries:
        out += struct.pack("<I", offset)
        offset += len(body)
    for *_, body in entries:
        out += body
    return bytes(out)


def build_skew_field(holder) -> int:
    """s: per shard, row 0's 16 bitmap containers (random words) and rows 1
    to 7's 112 array containers (a Bernoulli process of SKEW_NARROW drawn by
    geometric gaps), imported with Field.import_roaring as one roaring file
    (roaring_blob); row 0's containers must all be bitmap containers and
    the others arrays. Returns row 0's bit count (Count(Row(s=0)))."""
    import numpy as np

    from pilosa_tpu_torch.roaring.bitmap import ARRAY_MAX_SIZE
    from pilosa_tpu_torch.roaring.codec import TYPE_CODE_ARRAY, TYPE_CODE_BITMAP
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(17)
    field = holder.create_index("skew").create_field("s")
    per_row = SHARD_WIDTH >> 16
    narrow = (ROWS - 1) * per_row
    draws = int(2 * 65536 * SKEW_NARROW)
    row0 = 0
    for shard in range(SHARDS):
        words = np.frombuffer(rng.bytes(per_row * 8192), dtype="<u8").reshape(per_row, 1024)
        counts = np.bitwise_count(words).sum(axis=1)
        row0 += int(counts.sum())
        check(bool((counts > ARRAY_MAX_SIZE).all()), "cold: a broad container of s is sparse")
        entries = [(key, TYPE_CODE_BITMAP, int(counts[key]), words[key].tobytes())
                   for key in range(per_row)]
        cols = np.cumsum(rng.geometric(SKEW_NARROW, (narrow, draws)), axis=1) - 1
        check(bool((cols[:, -1] >= 65536).all()), "cold: s's narrow draws end short")
        for i in range(narrow):
            pos = cols[i][cols[i] < 65536].astype("<u2")
            check(0 < pos.size <= ARRAY_MAX_SIZE, "cold: a narrow container of s is full")
            entries.append((per_row + i, TYPE_CODE_ARRAY, int(pos.size), pos.tobytes()))
        field.import_roaring(shard, roaring_blob(entries))
    for shard in range(SHARDS):
        fr = field.view("standard").fragment(shard)
        with fr.lock:
            kinds = {(k // per_row == 0, fr.storage.container(k).typ)
                     for k in fr.storage.keys()}
        check(kinds == {(True, "bitmap"), (False, "array")},
              f"cold: s's shard {shard} holds containers {kinds}")
    return row0


class build_path:
    """Sets ops/sparse.py's switches for one build path, and restores them."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        from pilosa_tpu_torch.ops import sparse

        self.saved = (sparse.MIN_CHUNKED_WORDS, sparse.CONTAINER_TIER_ENABLED)
        if self.path == "dense":
            sparse.MIN_CHUNKED_WORDS = 1 << 62
        sparse.CONTAINER_TIER_ENABLED = self.path == "chunked"
        return self

    def __exit__(self, *exc):
        from pilosa_tpu_torch.ops import sparse

        sparse.MIN_CHUNKED_WORDS, sparse.CONTAINER_TIER_ENABLED = self.saved


class BuildSplit:
    """Times one full build of _StackedBlocks.get through the names it
    calls: the version walk (_locked_version), the tier walk
    (fragment_tier_words), the dense path's host pack (pack_fragment) and
    copy (_put, to the card's readiness), and the chunked path's builder
    (timed: host pack, waits, device ms of its copies and expansions), and
    keeps the first chunk of each wire tier (its views on the host) for the
    kernels' checks."""

    def __init__(self, backend, capture: dict, label: str):
        import torch

        from pilosa_tpu_torch.exec import cuda as cuda_mod
        from pilosa_tpu_torch.ops import sparse

        self.t = {"version_walk_s": 0.0, "tier_walk_s": 0.0, "host_pack_s": 0.0,
                  "copy_s": 0.0}
        self.builder = None
        split = self
        self.mods = cuda_mod, sparse
        self.saved = (cuda_mod._locked_version, cuda_mod.fragment_tier_words,
                      cuda_mod.pack_fragment, sparse.ChunkedStackBuilder)

        def timed(key, fn):
            def call(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    split.t[key] += time.perf_counter() - t0
            return call

        cuda_mod._locked_version = timed("version_walk_s", self.saved[0])
        cuda_mod.fragment_tier_words = timed("tier_walk_s", self.saved[1])
        cuda_mod.pack_fragment = timed("host_pack_s", self.saved[2])
        put = backend.blocks._put

        def timed_put(host):
            t0 = time.perf_counter()
            out = put(host)
            torch.cuda.synchronize()
            split.t["copy_s"] += time.perf_counter() - t0
            return out

        backend.blocks._put = timed_put

        class Timed(self.saved[3]):
            def __init__(b, device, shape):
                super().__init__(device, shape, timed=True)
                split.builder = b

            def _ship(b, lay, kind):
                if (label, kind) not in capture:
                    capture[(label, kind)] = (b._valid(), [v.clone() for v in
                                                           lay.views(lay.host)])
                super()._ship(lay, kind)

        sparse.ChunkedStackBuilder = Timed

    def restore(self):
        cuda_mod, sparse = self.mods
        (cuda_mod._locked_version, cuda_mod.fragment_tier_words, cuda_mod.pack_fragment,
         sparse.ChunkedStackBuilder) = self.saved


def cold_stacks(holder):
    """(label, index, field, view, min_rows) of the stacks the phase builds:
    f, g, h, v's BSI view, the existence row, r and s."""
    from pilosa_tpu_torch.core.fragment import BSI_OFFSET_BIT
    from pilosa_tpu_torch.core.view import VIEW_STANDARD, bsi_view_name

    idx = holder.index("bench")
    return [("f", "bench", idx.field("f"), VIEW_STANDARD, 1),
            ("g", "bench", idx.field("g"), VIEW_STANDARD, 1),
            ("h", "bench", idx.field("h"), VIEW_STANDARD, 1),
            ("v", "bench", idx.field("v"), bsi_view_name("v"),
             BSI_OFFSET_BIT + idx.field("v").options.bit_depth),
            ("exists", "bench", idx.existence_field(), VIEW_STANDARD, 1),
            ("r", "runs", holder.index("runs").field("r"), VIEW_STANDARD, 1),
            ("s", "skew", holder.index("skew").field("s"), VIEW_STANDARD, 1)]


def cold_build(holder, spec, path, capture):
    """One full build of a stack on a fresh backend by `path`: (stack, its
    record: wall s to the card's readiness, the split, wire and dense
    bytes, chunks by tier, drains, peak device bytes over the start)."""
    import torch

    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.ops import sparse
    from pilosa_tpu_torch.utils.stats import global_stats

    label, index, field, view, min_rows = spec
    backend = CUDABackend(holder)
    drains0 = sum(global_stats.counter_totals("stack_pending_drains_total").values())
    gc.collect()  # earlier backends' stacks, held in reference cycles
    with build_path(path):
        split = BuildSplit(backend, capture, label)
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            stack, _ = backend.blocks.get(index, field, tuple(range(SHARDS)), view, min_rows)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            split.restore()
    rec = {"s": wall, **split.t, "peak_bytes": peak, "stack_bytes": stack.numel() * 4}
    b = split.builder
    if path == "dense":
        check(b is None, f"cold: the dense path of {label} went through the builder")
        rec.update(wire_bytes=stack.numel() * 4, dense_bytes=stack.numel() * 4)
    else:
        check(b is not None, f"cold: the {path} path of {label} did not stream")
        rec.update(b.split())
        rec.update(wire_bytes=b._wire_bytes, dense_bytes=b._dense_bytes,
                   chunks=dict(b.chunks),
                   drains=sum(global_stats.counter_totals(
                       "stack_pending_drains_total").values()) - drains0)
        check(peak <= rec["stack_bytes"] + sparse.MAX_PENDING_BYTES,
              f"cold: {label}'s chunked build peaked at {peak} bytes over the stack's "
              f"{rec['stack_bytes']} plus MAX_PENDING_BYTES")
    del backend
    return stack, rec


def cold_first_calls(holder):
    """preheat() and the first Count on fresh backends, on each path:
    {path: {preheat_s, stacks, first_count_s}}, answers checked equal."""
    import torch

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend

    out, answers = {}, {}
    for path in COLD_PATHS:
        with build_path(path):
            warm = CUDABackend(holder)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = warm.preheat()
            torch.cuda.synchronize()
            preheat_s = time.perf_counter() - t0
            del warm
            torch.cuda.empty_cache()
            cold = CUDABackend(holder)
            t0 = time.perf_counter()
            answers[path] = Executor(holder, backend=cold).execute("bench", FIRST_CALLS[0][1])
            torch.cuda.synchronize()
            out[path] = {"preheat_s": preheat_s, "stacks": n,
                         "first_count_s": time.perf_counter() - t0}
            del cold
            torch.cuda.empty_cache()
    check(same_answers(answers["dense"], answers["chunked"]),
          "cold: the first Count differs between the paths")
    return out


def cold_first_skew_count(holder, want: int) -> dict:
    """The first Count(Row(s=0)) on a fresh backend by each path, host
    clock to its readback (s's stack built, uploaded and counted):
    {path: seconds}, each answer checked against row 0's bit count."""
    import torch

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend

    out = {}
    for path in COLD_PATHS:
        with build_path(path):
            gc.collect()
            cold = CUDABackend(holder)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = Executor(holder, backend=cold).execute("skew", "Count(Row(s=0))")
            torch.cuda.synchronize()
            out[path] = time.perf_counter() - t0
            check(got == [want], f"cold: s's first Count by the {path} path is {got}, "
                                 f"not [{want}]")
            del cold
            torch.cuda.empty_cache()
    return out


def phase_cold_build(holder):
    """The chunked cold build against the dense one at 954 shards: preheat
    and the first Count on each path (bench.py's index alone); then, with
    the launch counters zeroed, f, g, h, v's BSI view, the existence row,
    the run-heavy field r and the skewed field s each built on fresh
    backends by the dense and the chunked path over COLD_ROUNDS rounds in
    alternating order (and v also by the words path), each pair
    torch.equal, each build's split, wire,
    chunks by tier, drains and peak device memory printed; K12, K13 and K14
    must each have launched. The skewed field s (its own index) is built
    first, and its first Count timed on a fresh backend by each path; each
    of its chunked builds must ship SKEW_CHUNKS container chunks with K12
    and K14 launched once a chunk. Returns their launches and the first
    chunk of each tier, by stack, for the kernels' checks."""
    import torch

    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.ops import sparse

    t_phase = time.perf_counter()
    first = cold_first_calls(holder)
    log("cold: preheat and first Count by path " + json.dumps(first))
    t0 = time.perf_counter()
    build_run_field(holder)
    log(f"cold: r built ({SHARDS} shards x {ROWS} rows, a run of {RUN_MIN} to {RUN_MAX} "
        f"columns in every container) in {time.perf_counter() - t0:.1f} s; its containers "
        "are runs")
    t0 = time.perf_counter()
    skew_row0 = build_skew_field(holder)
    log(f"cold: s built ({SHARDS} shards x {ROWS} rows, row 0 at bit density "
        f"0.5 in bitmap containers, rows 1 to {ROWS - 1} at {SKEW_NARROW} in "
        f"array containers; {skew_row0} bits in row 0) in "
        f"{time.perf_counter() - t0:.1f} s")
    log("cold: s's first Count(Row(s=0)) seconds by path "
        + json.dumps(cold_first_skew_count(holder, skew_row0)))
    capture: dict = {}
    K.reset_launch_counts()
    for rnd in range(COLD_ROUNDS):
        order = COLD_PATHS if rnd % 2 == 0 else COLD_PATHS[::-1]
        for spec in cold_stacks(holder):
            paths = order + (("words",) if spec[0] == "v" else ())
            built = {}
            for path in paths:
                before = K.launch_counts()
                stack, rec = cold_build(holder, spec, path, capture)
                built[path] = stack
                log(f"cold: round {rnd} {spec[0]} {path} " + json.dumps(rec))
                if spec[0] == "s" and path == "chunked":
                    after = K.launch_counts()
                    grew = {k: after.get(k, 0) - before.get(k, 0) for k in BUILD_KERNELS}
                    check(rec["chunks"] == {"empty": 0, "words": 0, "container": SKEW_CHUNKS,
                                            "raw": 0},
                          f"cold: s's chunked build shipped {rec['chunks']}, not "
                          f"{SKEW_CHUNKS} container chunks")
                    check(grew == {"expand_positions": SKEW_CHUNKS, "expand_runs": 0,
                                   "expand_words": SKEW_CHUNKS},
                          f"cold: s's chunked build launched {grew}")
            for path in paths[1:]:
                check(torch.equal(built[paths[0]], built[path]),
                      f"cold: {spec[0]}'s {path} stack differs from its {paths[0]} twin")
            del built, stack
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts().items() if k in BUILD_KERNELS}
    log("cold: launches in the phase's builds " + json.dumps(launches))
    for name in BUILD_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} was not launched on the cold build")
    holder.delete_index("runs")
    holder.delete_index("skew")
    torch.cuda.empty_cache()
    log(f"cold: MAX_PENDING_BYTES {sparse.MAX_PENDING_BYTES}, CHUNK_WORDS "
        f"{sparse.CHUNK_WORDS}; phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches, capture


#: The expansion kernels' cases: (kernel, stack, tier) of the first chunk
#: of that tier the cold build shipped for that stack. K14 runs on two: v's
#: words-tier chunk (its whole wire: sparse, launch-bound) and s's first
#: container chunk's word-mask remainder (its last three wire views: 512
#: bitmap containers, 2^20 words in runs of all-ones mask words).
EXPAND_CASES = (("expand_positions", "f", "container"), ("expand_runs", "r", "container"),
                ("expand_words", "v", "words"), ("expand_words", "s", "container"))
#: Grids of the launch floor's no-op kernel: one block, K14's grid over a
#: 2^23-word chunk (128 tiles of 2048 mask words), and the grid of its
#: earlier 256-word blocks.
FLOOR_BLOCKS = (1, 128, 1024)


def graph_ms(launch, n: int = 20, reps: int = 5) -> float:
    """A launch's device ms with the host out of the way: n calls of
    ``launch`` (which must enqueue on the current stream at each call)
    captured as one CUDA graph, the median of reps replays timed by CUDA
    events, over n."""
    import torch

    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def launch_floor() -> dict:
    """The no-op kernel's (ops/probe.py noop) kernel_ms and graph_ms by
    grid, timed as the kernels are: {blocks: {kernel_ms, graph_ms}}; empty
    for a package without it (a checkout from before the floor)."""
    import torch

    from pilosa_tpu_torch.ops import probe

    if not hasattr(probe, "noop"):
        return {}
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for blocks in FLOOR_BLOCKS:
        out[blocks] = {"kernel_ms": kernel_ms(probe.noop(blocks=blocks, stream=stream)),
                       "graph_ms": graph_ms(probe.noop(blocks=blocks))}
    return out


def phase_expand_kernels(capture, launches, device="cuda"):
    """K12 on f's first container chunk, K13 on r's, and K14 on v's first
    words chunk and on s's first container chunk's remainder (the chunks
    the cold build shipped, their wire as the builder staged it) against
    the plain forms on the card, exactly, with times and bounds, beside the
    launch floor. K14's line is v's chunk's, with both chunks under
    ``cases`` and the floor under ``launch_floor``."""
    import torch

    from pilosa_tpu_torch.ops import build
    from pilosa_tpu_torch.ops import kernels as K

    dev = torch.device(device)
    floor = launch_floor()
    log("expand: launch floor (a kernel that does nothing) by grid "
        + json.dumps(floor))
    lines, words_cases = [], {}
    for name, label, tier in EXPAND_CASES:
        key = (label, tier)
        check(key in capture, f"expand: no {tier} chunk of {label} was captured")
        valid, views = capture[key]
        views = [v.to(dev) for v in views]
        if name == "expand_words":
            # mask, vals, bases: the words tier's wire, or the container
            # tier's remainder after its six container views.
            check(len(views) in (3, 9) and (tier == "words") == (len(views) == 3),
                  f"expand: {key} holds no word mask")
            args = views[-3:]
            written = 4 * int(views[-2].numel())
        else:
            a_slot, a_start, r_slot, r_start, pos, spans = views[:6]
            args = (pos, a_slot, a_start) if name == "expand_positions" else \
                (spans, r_slot, r_start)
            written = 4 * K.CONTAINER_SLOT_WORDS * int(args[1].numel())
            check(args[1].numel() > 0, f"expand: {key} holds no {name} containers")
        read = sum(int(a.numel()) * a.element_size() for a in args)
        wrapper = getattr(K, name)
        plain = getattr(K, name + "_torch")
        out = torch.zeros(valid, dtype=torch.int32, device=dev)
        want = torch.zeros_like(out)
        wrapper(out, *args)
        plain(want, *args)
        torch.cuda.synchronize()
        err = max_abs_err(out, want)
        check(err == 0, f"expand: {name} disagrees with its plain form on {key}")
        ms = time_ms(lambda: wrapper(out, *args))
        plain_ms = time_ms(lambda: plain(want, *args), reps=3, warm=1)
        fn = getattr(build.library(K._LIBRARY[name]), name + "_launch")
        fixed = torch.cuda.current_stream(dev).cuda_stream
        n = int(args[1].numel()) if name != "expand_words" else int(args[0].numel())

        def bare(fn=fn, args=args, n=n, stream=fixed):
            # stream None: the current stream at each call (a graph's capture)
            rc = fn(*(a.data_ptr() for a in args), out.data_ptr(), n, valid,
                    stream if stream is not None else
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise SmokeFailure(f"{name}: CUDA launch failed with cudaError {rc}")

        k_ms = kernel_ms(bare)
        line = kernel_line(name, ms, k_ms, plain_ms, (read + written, 0), err,
                           launches.get(name, 0))
        line["graph_ms"] = graph_ms(lambda: bare(stream=None))
        log(f"expand: {name} on {label}'s first {tier} chunk ({valid} words, "
            f"{read} bytes read, {written} written) " + json.dumps(line))
        if name == "expand_words":
            words_cases[f"{label}_{tier}"] = line
        else:
            lines.append(line)
    line = dict(words_cases["v_words"])
    line["max_abs_err"] = max(c["max_abs_err"] for c in words_cases.values())
    line["cases"] = {k: {f: c[f] for f in ("max_abs_err", "ms", "kernel_ms", "graph_ms",
                                           "plain_ms", "bound_ms", "bound_by")}
                     for k, c in words_cases.items()}
    line["launch_floor"] = floor
    lines.append(line)
    return lines


def phase_host_count(root, rounds: int = 0) -> int:
    """`chip_smoke.py --host-count [--root DIR] [--rounds N]`: bench.py's
    index served by DIR's package in-process, its kernel libraries loaded
    first: the first Count's seconds (its two stacks built and uploaded),
    then rounds of the single Count's host time: one call after another
    (median and mean of HOST_COUNT_CALLS calls, each to its readback) and
    from 1 and 16 threads (requests/s, p50/p99). Then one stack hit's host
    time in the block cache and, where the package has the program ledger,
    the host time of one record_launch and of one _launched around a
    launch that does nothing, on the Count's arguments. With --rounds N it
    waits for a line on its standard input before each of N rounds and
    prints each round's line (host_count_ab drives two such processes);
    without, it runs one round."""
    import torch

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    from pilosa_tpu_torch.ops import build

    t0 = time.perf_counter()
    for name in build.SOURCES:
        build.library(name)
    log(f"host-count: kernel libraries loaded in {time.perf_counter() - t0:.1f} s")
    holder = Holder(None).open()
    t0 = time.perf_counter()
    build_bench_index(holder)
    log(f"host-count: index build seconds {time.perf_counter() - t0:.1f}")
    backend = CUDABackend(holder)
    dev = Executor(holder, backend=backend)
    q = FIRST_CALLS[0][1]
    t0 = time.perf_counter()
    want = dev.execute("bench", q)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    out = {"package": root, "first_count_s": first_s,
           "resident_bytes": backend.blocks.resident_bytes()}
    for _ in range(50):
        dev.execute("bench", q)

    def one_round() -> dict:
        r = {}
        times = []
        for _ in range(HOST_COUNT_CALLS):
            t = time.perf_counter()
            got = dev.execute("bench", q)
            times.append((time.perf_counter() - t) * 1e3)
            check(got == want, "host-count: a Count moved")
        r["one_thread_ms"] = {"median": statistics.median(times),
                              "mean": statistics.fmean(times), "calls": len(times)}
        for n in (1, 16):
            w = inproc_load(dev, [q], {q: want}, n, HTTP_SECONDS)
            check(w["mismatches"] == 0, f"host-count: {w['mismatches']} answers disagree")
            r[f"threads_{n}"] = w
        return r

    if rounds:
        log("host-count-ready")
        for i in range(rounds):
            if not sys.stdin.readline():
                break
            print("host-count-round: " + json.dumps(one_round()), flush=True)
    else:
        out.update(one_round())
    # One resident stack's hit in the block cache, as each Count takes two.
    f_obj, shards = holder.index("bench").field("f"), tuple(range(SHARDS))
    reps = 20000
    t = time.perf_counter()
    for _ in range(reps):
        backend.blocks.get("bench", f_obj, shards)
    out["stack_hit_us"] = (time.perf_counter() - t) / reps * 1e6
    programs = getattr(backend, "programs", None)
    if programs is not None:
        # The chokepoint alone, on the Count's arguments: the ledger record
        # (signature and entry), then the whole of _launched under a
        # profile as the executor runs it, around a launch that does
        # nothing (these launches are counted; the mode ends here).
        from pilosa_tpu_torch.exec.cuda import _shape_sig, _Slots
        from pilosa_tpu_torch.utils.qprofile import profile_scope

        args = (backend.blocks.peek("bench", "f"), backend.blocks.peek("bench", "g"),
                _Slots(1, 2))
        key = ("count", (0, 1, 32))
        done = torch.zeros(1, SHARDS, dtype=torch.int32, device=backend.device)
        t = time.perf_counter()
        for _ in range(reps):
            programs.record_launch("count", key, _shape_sig(args)[0], t)
        out["record_launch_us"] = (time.perf_counter() - t) / reps * 1e6
        programs.block_ready()
        with profile_scope(index="bench", query="chokepoint"):
            t = time.perf_counter()
            for _ in range(reps):
                backend._launched("count", key, args, lambda: done)
            out["launched_us"] = (time.perf_counter() - t) / reps * 1e6
        programs.block_ready()
    holder.close()
    log("host-count: " + json.dumps(out))
    return 0


def host_count_ab(parent_root: str, change_root: str, pairs: int) -> int:
    """`chip_smoke.py --host-count-ab PARENT [--root CHANGE] [--pairs N]`:
    the single Count's host time of two checkouts' packages, compared in
    one call. Two --host-count --rounds processes, one a package, build
    bench.py's index side by side and then run their rounds in turns, one
    at a time, parent and change first in alternate pairs, so drifts of the
    host hit both alike. Prints every round and, for each metric, the
    change's median over the parent's and the change/parent ratio of each
    pair."""
    me = os.path.abspath(__file__)
    procs = {}
    for name, r in (("parent", parent_root), ("change", change_root)):
        procs[name] = subprocess.Popen(
            [sys.executable, me, "--host-count", "--root", r, "--rounds", str(pairs)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        for name, p in procs.items():
            for line in p.stdout:
                log(f"{name}: {line.rstrip()}")
                if line.startswith("host-count-ready"):
                    break
            else:
                check(False, f"host-count-ab: the {name} process ended before its rounds")
        rounds = {"parent": [], "change": []}
        for i in range(pairs):
            for name in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                p = procs[name]
                p.stdin.write("round\n")
                p.stdin.flush()
                for line in p.stdout:
                    if line.startswith("host-count-round: "):
                        r = json.loads(line.split(": ", 1)[1])
                        rounds[name].append(r)
                        log(f"{name} round {i}: one-thread median "
                            f"{r['one_thread_ms']['median']:.4f} ms, "
                            f"1 thread {r['threads_1']['rps']:.1f}/s, "
                            f"16 threads {r['threads_16']['rps']:.1f}/s")
                        break
                    log(f"{name}: {line.rstrip()}")
                else:
                    check(False, f"host-count-ab: the {name} process ended mid-round")
        for name, p in procs.items():
            p.stdin.close()
            for line in p.stdout:
                log(f"{name}: {line.rstrip()}")
            check(p.wait(timeout=300) == 0, f"host-count-ab: the {name} process failed")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    metrics = {"one_thread_median_ms": lambda r: r["one_thread_ms"]["median"],
               "counts_per_s_1_thread": lambda r: r["threads_1"]["rps"],
               "counts_per_s_16_threads": lambda r: r["threads_16"]["rps"]}
    summary = {"pairs": pairs}
    for m, get in metrics.items():
        par = [get(r) for r in rounds["parent"]]
        chg = [get(r) for r in rounds["change"]]
        ratios = [c / p for p, c in zip(par, chg)]
        summary[m] = {"parent": par, "change": chg,
                      "parent_median": statistics.median(par),
                      "change_median": statistics.median(chg),
                      "change_over_parent_median": statistics.median(chg) / statistics.median(par),
                      "pair_ratios": ratios,
                      "pair_ratio_median": statistics.median(ratios)}
    log("host-count-ab: " + json.dumps(summary))
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for_port(port: int, proc, seconds: float = 90.0) -> None:
    import socket

    deadline = time.perf_counter() + seconds
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            check(proc.poll() is None, f"cli: server exited with {proc.returncode}")
            check(time.perf_counter() < deadline, "cli: server did not bind")
            time.sleep(0.1)


# ---------------------------------------------------------------------------
# phase 3c: row paging under a device byte budget
# ---------------------------------------------------------------------------

# A second CUDABackend over the bench index with this budget: f and g (954
# MiB stacks) and v (1.9 GB) are over it, h (477 MiB) fits; a row page of f
# is 954 x 128 KiB = 119.25 MiB.
BUDGET_BYTES = 512 << 20
# The tall field t, in an index of its own: TALL_ROWS rows over TALL_SHARDS
# shards (an 8 GiB stack), each row TALL_BITS random columns a shard
# (density 256 / 2^20). Under the budget a page is 16 rows (128 MiB), so
# TopN(t) streams 64 pages.
TALL_SHARDS = 64
TALL_ROWS = 1024
TALL_BITS = 256
BUDGET_CALLS = [
    ("Count, cold", "bench", "Count(Intersect(Row(f=1), Row(g=2)))"),
    ("Count, repeated", "bench", "Count(Intersect(Row(f=1), Row(g=2)))"),
    ("Row(f=2)", "bench", "Row(f=2)"),
    ("3-row Count", "bench", "Count(Intersect(Row(f=1), Row(g=2), Row(h=3)))"),
    ("16-Count pair request", "bench", PAIR_REQUEST),
    ("TopN(f)", "bench", "TopN(f)"),
    ("TopN(f, Row(g=7))", "bench", "TopN(f, Row(g=7))"),
    ("TopN(t)", "tall", "TopN(t)"),
    ("Rows(t)", "tall", "Rows(t)"),
    ("GroupBy(Rows(t))", "tall", "GroupBy(Rows(t))"),
    ("Sum(field=v)", "bench", "Sum(field=v)"),
]


def build_tall_index(holder):
    """Index "tall", field t: TALL_BITS random columns a row a shard for
    TALL_ROWS rows over TALL_SHARDS shards, from PCG64(11)."""
    import numpy as np

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    field = holder.create_index("tall").create_field("t")
    rng = np.random.default_rng(11)
    rows = np.repeat(np.arange(TALL_ROWS, dtype=np.uint64), TALL_BITS)
    for shard in range(TALL_SHARDS):
        cols = rng.integers(0, SHARD_WIDTH, rows.size, dtype=np.uint64)
        field.import_bits(rows, cols + np.uint64(shard * SHARD_WIDTH))


def profiled_device_ms(fn):
    """(kernel ms, copy ms) of one call of fn, from torch.profiler's device
    events (memcpy and memset events are the copies); (None, None) when the
    profiler saw no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profiler_guard(), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = copy = 0.0
    seen = False
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us <= 0 or not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        seen = True
        if ev.key.startswith(("Memcpy", "Memset")):
            copy += us / 1e3
        else:
            kern += us / 1e3
    return (kern, copy) if seen else (None, None)


def paged_topn_split(bud, holder, want_counts):
    """The paged TopN of t a page at a time, as _topn_paged_counts runs it,
    timed by part: the host pack (host clock), the pageable host-to-device
    copy (CUDA events), the launch of K8 to its end (CUDA events around the
    wrapper call, so the wrapper's host work is in it) and the readback of
    the page's summed counts (host clock, which waits for the sum). Its
    counts must be the backend's. Then K8's own time on the last page
    (kernel_ms: back-to-back bare launches) against its bound, and a
    pinned-memory copy_ of one page's bytes. Returns K8's kernel_ms."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.ops.blocks import WORDS_PER_SHARD, pack_rows

    shards = tuple(range(TALL_SHARDS))
    v = holder.index("tall").field("t").view("standard")
    frags = [v.fragment(s) for s in shards]
    n_rows = max(fr.max_row_id + 1 for fr in frags if fr is not None)
    page = bud._topn_page_rows(len(shards))
    counts = np.zeros(-(-n_rows // page) * page, dtype=np.int64)
    parts = {"pack": [], "copy": [], "k8_launch": [], "readback": []}
    host = None
    for start in range(0, n_rows, page):
        stop = min(start + page, n_rows)
        t0 = time.perf_counter()
        host = np.zeros((len(shards), page, WORDS_PER_SHARD), dtype=np.uint32)
        for i, fr in enumerate(frags):
            if fr is not None and start <= fr.max_row_id:
                host[i, : stop - start] = pack_rows(fr, start, stop)
        parts["pack"].append((time.perf_counter() - t0) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        dev = bud.blocks._put(host)
        ev[1].record()
        table = K.row_popcounts(dev, 0, page)[0]
        ev[2].record()
        t0 = time.perf_counter()
        counts[start : start + page] += table.sum(dim=0, dtype=torch.int64).cpu().numpy()
        parts["readback"].append((time.perf_counter() - t0) * 1e3)
        parts["copy"].append(ev[0].elapsed_time(ev[1]))
        parts["k8_launch"].append(ev[1].elapsed_time(ev[2]))
        if stop < n_rows:
            del dev, table
    check(np.array_equal(counts[:n_rows], want_counts),
          "budget: the timed page loop's counts disagree with the backend's")
    k8_ms = kernel_ms(bare_row_popcounts(dev, 0, page))
    del dev, table
    page_bytes = host.nbytes
    pinned = torch.empty(host.shape, dtype=torch.int32, pin_memory=True)
    pinned.numpy()[:] = host.view(np.int32)
    target = torch.empty(host.shape, dtype=torch.int32, device="cuda")
    pinned_ms = time_ms(lambda: target.copy_(pinned, non_blocking=True), reps=5, warm=1)
    bound_ms, by, _ = kernel_bound(row_popcounts_work(len(shards), page, WORDS_PER_SHARD, 0))
    med = {k: statistics.median(x) for k, x in parts.items()}
    log(f"budget: TopN(t) by page ({len(parts['copy'])} pages of {page} rows, "
        f"{page_bytes} bytes): median ms " + json.dumps(med) + ", total ms "
        + json.dumps({k: sum(x) for k, x in parts.items()}))
    log(f"budget: page upload {page_bytes / med['copy'] / 1e6:.2f} GB/s pageable "
        f"(median of {len(parts['copy'])}), pinned copy_ of the same bytes "
        f"{page_bytes / pinned_ms / 1e6:.2f} GB/s ({pinned_ms:.4f} ms)")
    log(f"budget: K8 a page, kernel_ms {k8_ms:.4f} against its bound {bound_ms:.4f} ms "
        f"({by}): {bound_ms / k8_ms:.2f} of the bound; from the launch to its end "
        f"{med['k8_launch']:.4f} ms")
    return k8_ms


def phase_budget(holder, backend):
    """Row paging under a device byte budget: a second CUDABackend with
    max_bytes BUDGET_BYTES over the bench index (f, g, h and v) and the tall
    field t of an index of its own. Every call of BUDGET_CALLS answers what
    the unbudgeted backend answers; each logs its host time, its device
    time split into kernels and copies (torch.profiler, a second call in
    the same cache state), its K8 and K11 launches, page uploads and bytes,
    evictions, and resident bytes against the budget. Sum(field=v) stays on
    the host, counted once in cpu_routed_total; nothing else is routed.
    Then the paged TopN of t a page at a time (paged_topn_split), the
    repeated paged Count's device profile beside the resident Count's, and
    the phase's peak device memory over its start."""
    import torch

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.utils.stats import global_stats

    t0 = time.perf_counter()
    build_tall_index(holder)
    log(f"budget: tall index built in {time.perf_counter() - t0:.1f} s ({TALL_SHARDS} "
        f"shards x {TALL_ROWS} rows x {TALL_BITS} columns)")
    dev = Executor(holder, backend=backend)
    # The tall field's unbudgeted answers from a backend of its own, whose
    # 8 GiB stack is freed before the phase's peak memory is read.
    ref = CUDABackend(holder)
    rdev = Executor(holder, backend=ref)
    want = {}
    for label, index, q in BUDGET_CALLS:
        want[label] = (rdev if index == "tall" else dev).execute(index, q)
    del rdev, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    bud = CUDABackend(holder, max_bytes=BUDGET_BYTES)
    bdev = Executor(holder, backend=bud)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def counter(name):
        return sum(global_stats.counter_totals(name).values())

    def empty_cache():
        bud.blocks.make_room(BUDGET_BYTES)
        bud._topn_cache.clear()

    resets = {"Count, cold": empty_cache, "3-row Count": empty_cache,
              "16-Count pair request": empty_cache, "TopN(f)": empty_cache,
              "TopN(t)": empty_cache}
    routed0 = global_stats.counter_totals("cpu_routed_total")
    K.reset_launch_counts()
    path_launches = {}
    rows = {}
    for label, index, q in BUDGET_CALLS:
        launches = query_launches()
        pages = (counter("hbm_page_uploads_total"), counter("hbm_page_bytes_total"))
        evictions = bud.blocks.evictions
        t0 = time.perf_counter()
        got = bdev.execute(index, q)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        now = query_launches()
        for k, n in now.items():
            path_launches[k] = path_launches.get(k, 0) + n - launches[k]
        row = {
            "host_ms": host,
            "K8": now["row_popcounts"] - launches["row_popcounts"],
            "K11": now["spec_eval"] - launches["spec_eval"],
            "page_uploads": counter("hbm_page_uploads_total") - pages[0],
            "page_bytes": counter("hbm_page_bytes_total") - pages[1],
            "evictions": bud.blocks.evictions - evictions,
            "resident_bytes": bud.blocks.resident_bytes(),
            "budget": BUDGET_BYTES,
        }
        check(same_answers(got, want[label]), f"budget: {label} disagrees with the "
              "unbudgeted backend")
        check(row["resident_bytes"] <= BUDGET_BYTES,
              f"budget: {label} left {row['resident_bytes']} bytes resident")
        # The device time from a second call in the same cache state (its
        # launches are not counted as the path's).
        if label in resets:
            resets[label]()
        row["device_kernel_ms"], row["device_copy_ms"] = profiled_device_ms(
            lambda: bdev.execute(index, q))
        rows[label] = row
        log(f"budget: {label}: " + json.dumps(row))
    peak = torch.cuda.max_memory_allocated() - base
    routed = global_stats.counter_totals("cpu_routed_total")
    delta = {k: v - routed0.get(k, 0) for k, v in routed.items() if v != routed0.get(k, 0)}
    log("budget: launches on the path " + json.dumps(path_launches))
    log("budget: cpu_routed_total delta " + json.dumps(delta))
    # Each call ran twice (timed, then profiled): Sum is routed twice.
    check(delta == {'cpu_routed_total{call="Sum"}': 2},
          f"budget: only Sum may be routed to the host, got {delta}")
    for name in ("spec_eval", "row_popcounts"):
        check(path_launches.get(name, 0) > 0, f"budget: {name} was not launched")
    check(rows["TopN(t)"]["K8"] == rows["TopN(t)"]["page_uploads"] == -(-TALL_ROWS // 16),
          f"budget: TopN(t) took {rows['TopN(t)']} (expected one K8 launch a 16-row page)")
    check(rows["Count, repeated"]["page_uploads"] == 0,
          "budget: the repeated Count's pages did not hit the cache")
    log(f"budget: peak device memory over the phase's start {peak} bytes "
        f"({peak / BUDGET_BYTES:.3f} x the budget of {BUDGET_BYTES})")
    count_q = BUDGET_CALLS[0][2]
    device_share(lambda: bdev.execute("bench", count_q), "paged Count, repeated")
    device_share(lambda: dev.execute("bench", count_q), "resident Count")
    # The paged counts the profiled TopN(t) left in the TopN cache.
    paged_topn_split(bud, holder, bud._topn_cache[("tall", "t")][1])
    log_routed("budget")
    del bdev, bud
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return path_launches


def phase_http(holder, backend, root):
    """The port's HTTP server over the main path's index and backend: the
    slice's requests in JSON and protobuf against the in-process executor,
    their kernel launches, throughput under concurrent clients without the
    batcher, with it and with the result cache too, in-process windows with
    and without the batcher, and the CLI's server booted as a process on a
    small on-disk index."""
    import http.client

    import torch

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.batcher import ShardLegBatcher
    from pilosa_tpu_torch.exec.rescache import ResultCache
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.server import API, Server
    from pilosa_tpu_torch.server.wire import QueryRequest, encode_query_response
    from pilosa_tpu_torch.utils import fastjson
    from pilosa_tpu_torch.utils.stats import global_stats

    t_phase = time.perf_counter()
    dev = Executor(holder, backend=backend)
    routed0 = sum(global_stats.counter_totals("cpu_routed_total").values())
    pair_request = PAIR_REQUEST
    north = "Count(Intersect(Row(f=1), Row(g=2)))"
    three, three_filtered, two_filtered = GROUP_QUERIES[3], GROUP_QUERIES[4], GROUP_QUERIES[2]
    requests = [("Count", north), ("16-Count pair request", pair_request),
                ("2-field filtered GroupBy", two_filtered),
                ("3-field GroupBy", three), ("3-field filtered GroupBy", three_filtered),
                ("TopN", "TopN(f, n=5)"), ("Sum", "Sum(field=v)")]

    def json_body(results):
        return fastjson.response_body([fastjson.encode_result(r) for r in results])

    inproc = {q: dev.execute("bench", q) for _, q in requests}
    api = API(holder, dev)
    server = Server(api, host="127.0.0.1", port=0).open()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
        path = "/index/bench/query"
        pb = {"Content-Type": "application/x-protobuf", "Accept": "application/x-protobuf"}
        # Cold: the pair and GroupBy caches dropped, so each request
        # launches what its route should; then the same in protobuf.
        backend._pair_cache.clear()
        backend._agg_cache.clear()
        backend._groupn_cache.clear()
        backend._topn_cache.clear()
        per_request = {}
        K.reset_launch_counts()
        for label, q in requests:
            before = query_launches()
            status, body = http_post(conn, path, q.encode())
            per_request[label] = {k: v - before[k] for k, v in query_launches().items()
                                  if v != before[k]}
            check(status == 200 and body == json_body(inproc[q]),
                  f"http: JSON {label} disagrees with the in-process executor")
        for label, q in requests:
            status, body = http_post(conn, path, QueryRequest(query=q).to_bytes(), pb)
            check(status == 200 and body == encode_query_response(inproc[q], []),
                  f"http: protobuf {label} disagrees with the in-process executor")
        torch.cuda.synchronize()
        launches = query_launches()
        log("http: launches per request (JSON, caches dropped) " + json.dumps(per_request))
        log("http: launches " + json.dumps(launches))
        want = {
            "Count": {"spec_eval": 1},
            "16-Count pair request": {"pair_stats_pershard": 1},
            "2-field filtered GroupBy": {"pair_stats": 1, "spec_eval": 1},
            "3-field GroupBy": {"popcount_rows": 1, "group_tile_stats_pershard": 1},
            "3-field filtered GroupBy": {"popcount_rows": 1, "group_tile_stats": 1,
                                         "spec_eval": 1},
            "TopN": {"row_popcounts": 1},
            "Sum": {"row_popcounts": 1, "popcount_rows": 1},
        }
        for label, expect in want.items():
            check(per_request[label] == expect,
                  f"http: {label} launched {per_request[label]}, expected {expect}")
        log(f"http: {len(requests)} requests x JSON and protobuf agree with the "
            "in-process executor")
        device_share(lambda: http_post(conn, path, north.encode()), "HTTP Count")
        conn.request("GET", "/debug/diagnostics")
        inv = json.loads(conn.getresponse().read())["jax"]
        kinds = [d.get("kind") for d in inv.get("devices", [])]
        check(inv.get("device_count") == torch.cuda.device_count()
              and kinds[:1] == [torch.cuda.get_device_name(0)],
              f"http: /debug/diagnostics device block {inv}")
        log("http: /debug/diagnostics device block " + json.dumps(inv))

        # Throughput: client threads in a process of their own. First the
        # server without the batcher (the earlier slices' wiring), then as
        # `cli server` wires it: the batcher beside the device backend, and
        # then the result cache too.
        counts = [f"Count(Intersect(Row(f={a}), Row(g={b})))"
                  for a in range(ROWS) for b in range(ROWS)]
        threes = [f"Count(Intersect(Row(f={a}), Row(g={b}), Row(h={c})))"
                  for a in range(ROWS) for b in range(ROWS) for c in range(H_ROWS)][::4]
        expected = {q: json_body(dev.execute("bench", q)).decode("latin-1")
                    for q in counts + threes + [pair_request, three]}
        throughput = []

        def window(label, qs, n, wiring):
            before, bc = query_launches(), batch_counters()
            r = run_http_load({"host": "127.0.0.1", "port": server.port, "path": path,
                               "clients": n, "seconds": HTTP_SECONDS,
                               "queries": [[q, expected[q]] for q in qs]})
            after = query_launches()
            r["request"] = label
            r["wiring"] = wiring
            r["launches_per_request"] = {k: (after[k] - before[k]) / max(1, r["requests"])
                                         for k in after if after[k] != before[k]}
            r.update(batch_delta(bc))
            check(r["mismatches"] == 0,
                  f"http: {r['mismatches']} answers of {label} x{n} ({wiring}) disagree")
            throughput.append(r)
            log("http: throughput " + json.dumps(r))

        for n in HTTP_COUNT_CLIENTS:
            window("Count", counts, n, "no batcher")
        dev.batcher = ShardLegBatcher(backend)
        # With the batcher a Count run of one is a count window: the pair
        # plan serves the pair Count (one K1 sweep with its cache dropped),
        # K11 the 3-row Count.
        per_request = {}
        for label, q in (("Count", north), ("3-row Count", threes[1])):
            backend._pair_cache.clear()
            before = query_launches()
            status, body = http_post(conn, path, q.encode())
            check(status == 200 and body.decode("latin-1") == expected[q],
                  f"http: batched {label} disagrees with the in-process executor")
            per_request[label] = {k: v - before[k] for k, v in query_launches().items()
                                  if v != before[k]}
        log("http: launches per request with the batcher (caches dropped) "
            + json.dumps(per_request))
        want = {"Count": {"pair_stats_pershard": 1}, "3-row Count": {"spec_eval": 1}}
        check(per_request == want, f"http: batched launches {per_request}, expected {want}")
        for n in HTTP_COUNT_CLIENTS:
            window("Count", counts, n, "batcher")
        window("3-row Count", threes, HTTP_COUNT_CLIENTS[-1], "batcher")
        for n in HTTP_OTHER_CLIENTS:
            window("16-Count pair request", [pair_request], n, "batcher")
        for n in HTTP_OTHER_CLIENTS:
            window("3-field GroupBy", [three], n, "batcher")
        r = miss_window(server.port, path, backend, dev, MISS_QUERIES,
                        toggle_column(holder), MISS_CLIENTS, HTTP_SECONDS)
        r["wiring"] = "batcher"
        throughput.append(r)
        log("http: throughput " + json.dumps(r))
        for r in (churn_window(server.port, path, backend, dev, pair_request,
                               churn_column(holder), CHURN_CLIENTS, HTTP_SECONDS),
                  agg_churn_window(server.port, path, backend, dev, CHURN_CLIENTS,
                                   HTTP_SECONDS)):
            r["wiring"] = "batcher"
            throughput.append(r)
            log("http: throughput " + json.dumps(r))
        throughput += refresh_windows(server.port, path, backend, dev, pair_request,
                                      churn_column(holder))
        dev.rescache = ResultCache(holder, max_bytes=RESCACHE_BYTES)
        for n in CACHED_CLIENTS:
            hits = dev.rescache.hits
            window("Count, cached", counts, n, "batcher + result cache")
            check(dev.rescache.hits > hits, "http: the result cache served no hit")
        r = miss_window(server.port, path, backend, dev, MISS_QUERIES,
                        toggle_column(holder), MISS_CLIENTS, HTTP_SECONDS)
        r["wiring"] = "batcher + result cache"
        throughput.append(r)
        log("http: throughput " + json.dumps(r))
        log("http: result cache " + json.dumps(
            {k: v for k, v in dev.rescache.debug_dump().items() if k != "entries"}))
        conn.close()
    finally:
        server.close()
    errors = sum(global_stats.counter_totals("batch_dispatch_errors_total").values())
    check(errors == 0, f"http: {errors} batch dispatch errors")
    dev.batcher = dev.rescache = None
    answers = {q: dev.execute("bench", q) for q in counts + threes}
    for batched in (False, True):
        dev.batcher = ShardLegBatcher(backend) if batched else None
        for label, qs in (("Count, in-process", counts), ("3-row Count, in-process", threes)):
            for n in INPROC_THREADS:
                bc = batch_counters()
                r = inproc_load(dev, qs, answers, n, INPROC_SECONDS)
                r["request"] = label
                r["wiring"] = "batcher" if batched else "no batcher"
                r.update(batch_delta(bc))
                check(r["mismatches"] == 0,
                      f"http: {r['mismatches']} {label} x{n} ({r['wiring']}) disagree")
                throughput.append(r)
                log("http: throughput " + json.dumps(r))
    dev.batcher = None
    errors = sum(global_stats.counter_totals("batch_dispatch_errors_total").values())
    check(errors == 0, f"http: {errors} batch dispatch errors")
    check(sum(global_stats.counter_totals("cpu_routed_total").values()) == routed0,
          "http: a request was routed to the CPU oracle")
    log_routed("http")
    phase_cli(root)
    log(f"http: phase seconds {time.perf_counter() - t_phase:.1f}")
    return throughput


# ---------------------------------------------------------------------------
# phase 4b: the device trace server (profile.port)
# ---------------------------------------------------------------------------

#: phase_trace's load: in-process Counts from TRACE_THREADS threads over
#: TRACE_ROUNDS pairs of TRACE_SECONDS windows, untraced then traced; a
#: traced window's GET /trace covers it with TRACE_SLACK seconds to spare.
TRACE_THREADS = 16
TRACE_SECONDS = 2.0
TRACE_ROUNDS = 2
TRACE_SLACK = 0.5
#: trace_mesh's window, for the write epoch and the reads after it.
TRACE_MESH_SECONDS = 3.0
TRACE_QUERIES = [f"Count(Intersect(Row(f={a}), Row(g={b})))"
                 for a in range(1, 5) for b in (2, 5)]


def http_get(port: int, path: str, timeout: float = 300.0):
    """(status, body bytes) of GET path on 127.0.0.1:port."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def traced(port: int, seconds: float, body):
    """GET /trace?seconds=S on port from a thread, body() run once the
    trace is live, and a second GET while it is: (status, trace bytes,
    body's result, the second GET's status)."""
    import threading

    from pilosa_tpu_torch.utils import devtrace

    got = {}
    t = threading.Thread(target=lambda: got.update(r=http_get(port, f"/trace?seconds={seconds}")))
    t.start()
    deadline = time.perf_counter() + 120
    while devtrace._LIVE is None:
        check(t.is_alive() and time.perf_counter() < deadline, "trace: the window never opened")
        time.sleep(0.001)
    second = http_get(port, "/trace?seconds=0.1")[0]
    out = body()
    t.join(timeout=300)
    check(not t.is_alive(), "trace: GET /trace did not return")
    status, data = got["r"]
    return status, data, out, second


def trace_summary(data: bytes, label: str) -> dict:
    """What a trace holds: its pilosa.* ranges by name, kernels (K11's
    spec_*_kernel among them), the window's device launches, the share of
    pilosa.count ranges whose thread's launch calls lie inside them."""
    from pilosa_tpu_torch.utils import devtrace

    trace = json.loads(data)
    events = trace["traceEvents"]
    meta = trace["pilosaTrace"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ranges: dict = {}
    for e in events:
        if e.get("cat") == "pilosa":
            ranges[e["name"]] = ranges.get(e["name"], 0) + 1
    counts = devtrace.range_kernels(trace, "pilosa.count")
    out = {
        "label": label, "bytes": len(data), "events": len(events),
        "seconds": round(meta["seconds"], 6), "ranges": ranges,
        "rangesDropped": meta["rangesDropped"],
        "deviceLaunches": meta["deviceLaunches"], "kernels": len(kernels),
        "k11Kernels": sum(is_k11(e["name"]) for e in kernels),
        "countRanges": len(counts),
        "countRangesWithLaunch": sum(bool(calls) for _, calls, _ in counts),
        "countRangesWithK11": sum(any(is_k11(k["name"]) for k in ks)
                                  for _, _, ks in counts),
        "launchCallKinds": sorted({e["name"] for e in events
                                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                                   and e.get("name", "").startswith(devtrace.LAUNCH_CALLS)}),
    }
    out["completeness"] = (out["k11Kernels"] / out["deviceLaunches"]
                           if out["deviceLaunches"] else None)
    out["alignedShare"] = (out["countRangesWithLaunch"] / out["countRanges"]
                           if out["countRanges"] else None)
    return out


def phase_trace(holder, backend) -> list:
    """The device trace server over the main path's backend: in-process
    Counts from TRACE_THREADS threads in alternating untraced and traced
    windows, GET /trace covering each traced one; Counts/s of each, the
    trace's pilosa.count ranges, kernels (K11 among them) and bytes, the
    window's device_launches_total beside the trace's K11 kernels, and the
    share of pilosa.count ranges whose launch calls lie inside them. Fails
    where a trace holds no kernel or no pilosa.* range, or where a second
    concurrent trace is not refused."""
    import torch

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.utils import devtrace

    t_phase = time.perf_counter()
    dev = Executor(holder, backend=backend)
    answers = {q: dev.execute("bench", q) for q in TRACE_QUERIES}
    srv = devtrace.DeviceTraceServer("127.0.0.1", 0, [backend.device])
    out = []
    try:
        for rnd in range(TRACE_ROUNDS):
            r = inproc_load(dev, TRACE_QUERIES, answers, TRACE_THREADS, TRACE_SECONDS)
            check(r["mismatches"] == 0, "trace: an untraced Count disagrees")
            r.update(request="Count", traced=False, round=rnd)
            log("trace: throughput " + json.dumps(r))
            out.append(r)
            status, data, r, second = traced(
                srv.port, TRACE_SECONDS + TRACE_SLACK,
                lambda: inproc_load(dev, TRACE_QUERIES, answers, TRACE_THREADS,
                                    TRACE_SECONDS))
            check(r["mismatches"] == 0, "trace: a traced Count disagrees")
            check(second == 409, f"trace: a second concurrent trace got {second}, not 409")
            check(status == 200, f"trace: GET /trace answered {status}: {data[:300]!r}")
            r.update(request="Count", traced=True, round=rnd)
            log("trace: throughput " + json.dumps(r))
            out.append(r)
            s = trace_summary(data, f"Counts x{TRACE_THREADS}, round {rnd}")
            log("trace: window " + json.dumps(s))
            check(s["kernels"] > 0, "trace: the trace holds no kernel of the window")
            check(s["ranges"].get("pilosa.count", 0) > 0, "trace: the trace holds no "
                  "pilosa.* range")
            out.append(s)
    finally:
        srv.stop()
    untraced = [r["rps"] for r in out if r.get("traced") is False]
    traced_rps = [r["rps"] for r in out if r.get("traced") is True]
    log(f"trace: Counts/s untraced {untraced} traced {traced_rps} "
        f"({torch.cuda.get_device_name(0)})")
    log(f"trace: phase seconds {time.perf_counter() - t_phase:.1f}")
    return out


def kernel_short_name(name: str) -> str:
    """A trace's demangled kernel name without its return type, namespaces,
    template and parameters: "void (anonymous namespace)::spec_window_kernel<
    true, 128>(...)" -> "spec_window_kernel"."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    return name.split("<")[0].split("(")[0].split("::")[-1]


def trace_mesh(holder) -> None:
    """A meshed backend of 2 parts traced through a write epoch and a few
    reads: each request's kernels by part (the pilosa.part.<d> ranges inside
    its launch), their intervals from the request's start and the overlap
    of the two parts' intervals; the parts on distinct cards where two are
    visible, else both on cuda:0 (then they run in launch order)."""
    import threading

    import torch

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.parallel import ShardMesh
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils import devtrace

    n_cards = torch.cuda.device_count()
    devices = [torch.device("cuda", d if n_cards >= 2 else 0) for d in range(2)]
    be = CUDABackend(holder, mesh=ShardMesh(devices))
    ex = Executor(holder, backend=be)
    reads = [("Count", "Count(Intersect(Row(f=1), Row(g=2)))"),
             ("3-row Count", "Count(Union(Row(f=1), Row(f=2), Row(g=3)))"),
             ("TopN", "TopN(f, n=5)"), ("pair request", PAIR_REQUEST)]
    for _, q in reads:
        ex.execute("bench", q)  # resident stacks
    writes = [f"Set({s * SHARD_WIDTH + 7}, f=1)" for s in (3, SHARDS - 3)]

    def epoch():
        for w in writes:
            ex.execute("bench", w)
        for label, q in reads + reads[:1]:
            with devtrace.trace_range("chip_smoke.", label):
                ex.execute("bench", q)
            torch.cuda.synchronize()

    # The epoch runs on a thread of its own once the window is live.
    took = {}

    def run_epoch():
        while devtrace._LIVE is None:
            time.sleep(0.001)
        t0 = time.perf_counter()
        epoch()
        took["s"] = time.perf_counter() - t0

    t = threading.Thread(target=run_epoch)
    t.start()
    trace = devtrace.trace_window(TRACE_MESH_SECONDS, devices)
    t.join(timeout=300)
    check(not t.is_alive() and "s" in took, "trace: the mesh epoch did not end")
    log(f"trace mesh: epoch and reads {took['s']:.3f} s of the "
        f"{trace['pilosaTrace']['seconds']:.3f} s window")
    check(trace["pilosaTrace"]["deviceKernels"] > 0, "trace: the mesh trace holds no kernel")
    events = trace["traceEvents"]
    by_part = {d: devtrace.range_kernels(trace, f"pilosa.part.{d}") for d in (0, 1)}
    requests = sorted((e for e in events if e.get("cat") == "pilosa"
                       and e["name"].startswith("chip_smoke.")), key=lambda e: e["ts"])
    check(len(requests) == len(reads) + 1, f"trace: {len(requests)} mesh requests traced")
    log(f"trace mesh: parts on {[str(d) for d in devices]} "
        f"({n_cards} card{'s' if n_cards > 1 else ''} visible)")
    launched = {}
    for name in {r["name"] for r in requests}:
        for r, _, ks in devtrace.range_kernels(trace, name):
            launched[(r["tid"], r["ts"])] = ks
    for req in requests:
        lo, hi = req["ts"], req["ts"] + req["dur"]
        spans, in_parts = {}, set()
        for d in (0, 1):
            ks = [k for r, _, kk in by_part[d] if r["tid"] == req["tid"]
                  and lo <= r["ts"] <= hi for k in kk]
            in_parts.update(id(k) for k in ks)
            if ks:
                spans[d] = (min(k["ts"] for k in ks) - lo,
                            max(k["ts"] + k["dur"] for k in ks) - lo, len(ks),
                            sorted({k["args"].get("device") for k in ks}))
        overlap = None
        if len(spans) == 2:
            overlap = max(0.0, min(spans[0][1], spans[1][1]) - max(spans[0][0], spans[1][0]))
        log("trace mesh: " + json.dumps({
            "request": req["name"][len("chip_smoke."):], "us": round(req["dur"], 3),
            "parts": {d: {"kernels": n, "from_us": round(a, 3), "to_us": round(b, 3),
                          "cards": cards} for d, (a, b, n, cards) in spans.items()},
            "overlap_us": None if overlap is None else round(overlap, 3),
            "outside_parts": sorted(
                {kernel_short_name(k["name"]) for k in launched.get((req["tid"], lo), [])
                 if id(k) not in in_parts}),
            "order": (None if len(spans) < 2 else
                      "serial" if spans[0][1] <= spans[1][0] or spans[1][1] <= spans[0][0]
                      else "overlapping")}))


def phase_trace_alone(root) -> int:
    """`chip_smoke.py --trace`: the card line, bench.py's index (f, g and
    h), phase_trace over an unmeshed backend, then trace_mesh."""
    import torch

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec.cuda import CUDABackend

    phase_card()
    holder = Holder(None).open()
    t0 = time.perf_counter()
    build_bench_index(holder)
    log(f"trace: index build seconds {time.perf_counter() - t0:.1f}")
    phase_trace(holder, CUDABackend(holder))
    trace_mesh(holder)
    holder.close()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase_cli(root):
    """`python -m pilosa_tpu_torch.cli server` as a process on a
    CLI_SHARDS-shard on-disk index that `cli import` loads: its answers
    over HTTP equal the in-process executor's over the same directory
    after it stops, and SIGINT stops it with exit code 0. Then the same
    server with --max-hbm-bytes CLI_BUDGET, below one of the index's
    stacks: its answers equal the first run's, and its /debug/hbm lists
    row pages whose tierBytes sum to residentBytes."""
    import tempfile

    import numpy as np

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils import fastjson

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=root)
    cli = [sys.executable, "-m", "pilosa_tpu_torch.cli"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        data_dir = os.path.join(tmp, "data")
        rng = np.random.default_rng(7)
        for name in ("f", "g"):
            with open(os.path.join(tmp, f"{name}.csv"), "w") as f:
                for row in range(CLI_ROWS):
                    cols = rng.integers(0, CLI_SHARDS * SHARD_WIDTH, CLI_BITS)
                    f.writelines(f"{row},{c}\n" for c in cols)

        def load(host):
            for name in ("f", "g"):
                imp = subprocess.run(
                    cli + ["import", "--host", host, "-i", "small", "-f", name, "--create",
                           os.path.join(tmp, f"{name}.csv")],
                    cwd=root, env=env, capture_output=True, text=True, timeout=120)
                check(imp.returncode == 0, f"cli: import {name} failed: {imp.stderr[-2000:]}")

        run = cli_server_run(root, env, data_dir, tmp, [], load)
        check("executor=cuda: device backend on cuda" in run["log"],
              f"cli: the server did not serve on the card: {run['log'][-2000:]}")
        check("device_launches_total" in run["metrics"]
              and "cpu_routed_total" not in run["metrics"],
              "cli: the server's requests did not stay on the card")
        holder = Holder(data_dir).open()
        try:
            dev = Executor(holder, backend=CUDABackend(holder))
            oracle = Executor(holder, backend=CPUBackend(holder))
            for q in CLI_QUERIES:
                want = fastjson.response_body(
                    [fastjson.encode_result(r) for r in dev.execute("small", q)])
                check(run["got"][q] == want,
                      f"cli: {q} over HTTP disagrees with the in-process executor")
                check(same_answers(dev.execute("small", q), oracle.execute("small", q)),
                      f"cli: {q} disagrees with the CPU oracle")
        finally:
            holder.close()
        log(f"cli: server booted in {run['boot_s']:.1f} s, {len(CLI_QUERIES)} answers over "
            f"HTTP agree with the in-process executor and the oracle, exit code {run['rc']}")
        budgeted = cli_server_run(root, env, data_dir, tmp,
                                  ["--max-hbm-bytes", str(CLI_BUDGET)], None)
        check(f"max-hbm-bytes {CLI_BUDGET}" in budgeted["log"],
              f"cli: the budgeted server did not take its budget: {budgeted['log'][-2000:]}")
        for q in CLI_QUERIES:
            check(budgeted["got"][q] == run["got"][q],
                  f"cli: {q} under max-hbm-bytes disagrees with the unbudgeted server")
        hbm = budgeted["hbm"]
        pages = [e for e in hbm["entries"] if "row" in e]
        check(pages and sum(hbm["tierBytes"].values()) == hbm["residentBytes"]
              and hbm["residentBytes"] <= CLI_BUDGET,
              f"cli: /debug/hbm under max-hbm-bytes {CLI_BUDGET}: {hbm}")
        routed = [ln for ln in budgeted["metrics"].splitlines()
                  if ln.startswith("pilosa_cpu_routed_total")]
        log(f"cli: with --max-hbm-bytes {CLI_BUDGET} (a stack is "
            f"{CLI_SHARDS * 8 * SHARD_WIDTH // 8} bytes) the answers equal the unbudgeted "
            f"run's; /debug/hbm: residentBytes {hbm['residentBytes']}, tierBytes "
            f"{json.dumps(hbm['tierBytes'])}, evictions {hbm['evictions']}, entries "
            + json.dumps([(e["field"], e.get("row"), e["bytes"]) for e in hbm["entries"]])
            + f"; routed {routed}; exit code {budgeted['rc']}")
        planes_cli_run(root, env, data_dir, tmp, run)
    log(f"cli: {time.perf_counter() - t0:.1f} s")


def metric_sum(metrics: str, family: str) -> float:
    """The sum of a counter family's series in /metrics text."""
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
               if ln.startswith(f"pilosa_{family}{{") or ln.startswith(f"pilosa_{family} "))


def planes_cli_run(root, env, data_dir, tmp, first):
    """The CLI's server once more, with preheat = true, refresh-window-ms =
    REFRESH_WINDOW_MS and heat-half-life = 60 in its TOML: it logs the
    stacks preheat made resident and its window, answers as the first run;
    /debug/programs' entries sum to device_launches_total, and the library
    load preheat made is the compile of the first launch after it;
    /debug/heat has entries, tierHeat and a
    reuse curve; the ?explain=1 plan of a Count that no cache serves
    (EXPLAIN_COUNT, one K11 launch) holds one launch record per launch."""
    import urllib.request

    t0 = time.perf_counter()
    conf = os.path.join(tmp, "planes.toml")
    with open(conf, "w") as f:
        f.write(f"preheat = true\nrefresh-window-ms = {REFRESH_WINDOW_MS}\n"
                "heat-half-life = 60.0\n")

    def probe(host):
        def get(path):
            return urllib.request.urlopen(f"{host}{path}", timeout=120).read()

        def post(path, body):
            req = urllib.request.Request(f"{host}{path}", data=body.encode(), method="POST")
            return urllib.request.urlopen(req, timeout=120).read()

        out = {}
        before = metric_sum(get("/metrics").decode(), "device_launches_total")
        explained = json.loads(post("/index/small/query?explain=1", EXPLAIN_COUNT))
        after = metric_sum(get("/metrics").decode(), "device_launches_total")
        out["explain_records"] = [r for c in explained["explain"]["calls"]
                                  for r in c.get("launches", [])]
        out["explain_launches"] = after - before
        out["programs"] = json.loads(get("/debug/programs"))
        out["launches_total"] = metric_sum(get("/metrics").decode(), "device_launches_total")
        out["heat"] = json.loads(get("/debug/heat"))
        return out

    run = cli_server_run(root, env, data_dir, tmp, ["-c", conf], None,
                         wait_log="stacks resident", probe=probe)
    log_text = run["log"]
    failed = [ln for ln in log_text.splitlines() if "preheat" in ln and "failed" in ln]
    check(not failed, f"cli: {failed}")
    resident = [ln for ln in log_text.splitlines() if "stacks resident" in ln]
    check(resident and f"windowed device refresh: {REFRESH_WINDOW_MS} ms" in log_text,
          f"cli: the planes server did not preheat or window: {log_text[-2000:]}")
    for q in CLI_QUERIES:
        check(run["got"][q] == first["got"][q],
              f"cli: {q} with preheat and the refresher disagrees with the first run")
    pr = run["probe"]
    programs, heat = pr["programs"], pr["heat"]
    recs = pr["explain_records"]
    check(len(recs) == pr["explain_launches"] > 0
          and all(r["bytesShipped"] > 0 for r in recs),
          f"cli: explain records {recs} against {pr['explain_launches']} launches")
    check(programs["entries"] and programs["launches"]
          == sum(e["launches"] for e in programs["entries"]) == pr["launches_total"]
          and programs["recompiles"] == 0,
          f"cli: /debug/programs {programs} against device_launches_total "
          f"{pr['launches_total']}")
    check(heat["entries"] and heat["tierHeat"] and heat["reuse"]["curve"]
          and heat["halfLifeSeconds"] == 60.0, f"cli: /debug/heat {heat}")
    compiled = [e for e in programs["entries"] if e["compiles"]]
    log(f"cli: with preheat, refresh-window-ms {REFRESH_WINDOW_MS} and heat-half-life 60 "
        f"the answers equal the first run's; {resident[0].split(' ', 1)[1]}; "
        f"/debug/programs {programs['programs']} programs, {programs['launches']} launches "
        f"= device_launches_total, compiles {programs['compiles']} "
        + json.dumps([(e["kind"], e["compileSeconds"]) for e in compiled])
        + f"; /debug/heat {len(heat['entries'])} entries, tierHeat "
        f"{json.dumps(heat['tierHeat'])}, reuse {heat['reuse']['samples']} samples, "
        f"{len(heat['reuse']['curve'])} curve points; explain: {len(recs)} records for "
        f"{pr['explain_launches']:.0f} launches; {time.perf_counter() - t0:.1f} s")


def cli_server_run(root, env, data_dir, tmp, extra, load, wait_log=None, probe=None):
    """One `cli server` process over data_dir with the extra flags: load(host)
    first when given, then (when wait_log is given, once its log holds that
    text) CLI_QUERIES over HTTP, /metrics and /debug/hbm, then probe(host)
    when given, then SIGINT, which must stop it with exit code 0."""
    import signal
    import urllib.request

    t0 = time.perf_counter()
    port = free_port()
    host = f"http://127.0.0.1:{port}"
    log_path = os.path.join(
        tmp, f"server{sum(n.startswith('server') for n in os.listdir(tmp))}.log")
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d", data_dir,
             "--bind", f"127.0.0.1:{port}"] + extra,
            cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        wait_for_port(port, proc)
        boot_s = time.perf_counter() - t0
        if load is not None:
            load(host)
        deadline = time.monotonic() + 120
        while wait_log is not None and wait_log not in open(log_path).read():
            check(proc.poll() is None and time.monotonic() < deadline,
                  f"cli: no {wait_log!r} in the log: {open(log_path).read()[-2000:]}")
            time.sleep(0.1)
        got = {}
        for q in CLI_QUERIES:
            req = urllib.request.Request(f"{host}/index/small/query", data=q.encode(),
                                         method="POST")
            got[q] = urllib.request.urlopen(req, timeout=120).read()
        metrics = urllib.request.urlopen(f"{host}/metrics", timeout=120).read().decode()
        hbm = json.loads(urllib.request.urlopen(f"{host}/debug/hbm", timeout=120).read())
        probed = probe(host) if probe is not None else None
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log_text = open(log_path).read()
    check(rc == 0, f"cli: server {extra} exited with {rc}: {log_text[-2000:]}")
    return {"got": got, "metrics": metrics, "hbm": hbm, "rc": rc, "log": log_text,
            "boot_s": boot_s, "probe": probed}


# ---------------------------------------------------------------------------
# phase 3e: two nodes of a cluster sharing the card
# ---------------------------------------------------------------------------

#: Shards of the cluster phase's index: bench.py's f, g and h (8, 8 and 4
#: rows, density 0.05), cut from 954 because at 954 the phase took past
#: 240 s before its reads were done (PERF.md section 4): CLUSTER_SHARDS
#: under ``--cluster``, CLUSTER_SHARDS_WHOLE in the whole run, whose
#: clustered GroupBys, answered on a node's host a shard at a time, took
#: 10 to 33 s each at 256 and brought the run within 14 s of its limit
#: on a slow host; the whole run drives the cluster's path, --cluster
#: measures it.
CLUSTER_SHARDS = 256
CLUSTER_SHARDS_WHOLE = 64
#: Each node's anti-entropy interval in seconds (short, for the heal step).
CLUSTER_ANTI_ENTROPY_S = 10.0
#: A read window after the first request: CLUSTER_WINDOW_N timed requests,
#: or as many as CLUSTER_WINDOW_S seconds allow but at least
#: CLUSTER_WINDOW_MIN, over which p50, p90 and p99 are printed.
CLUSTER_WINDOW_N = 100
CLUSTER_WINDOW_S = 10.0
CLUSTER_WINDOW_MIN = 20
#: (request kind, PQL, windowed): the reads sent to both nodes, each answer
#: checked. A GroupBy takes seconds on the host of the node it is sent to:
#: its one request is printed as is, with no window and no percentile.
CLUSTER_READS = [
    ("Count(Row)", "Count(Row(f=1))", True),
    ("Count(Intersect)", "Count(Intersect(Row(f=1), Row(g=2)))", True),
    ("Count(Union)", "Count(Union(Row(f=3), Row(g=0)))", True),
    ("Count(Not)", "Count(Not(Row(h=1)))", True),
    ("TopN(f)", "TopN(f)", True),
    ("Rows(f)", "Rows(f)", True),
    ("filtered 2-field GroupBy", "GroupBy(Rows(f), Rows(g), filter=Row(h=1))", False),
    ("3-field GroupBy", "GroupBy(Rows(f), Rows(g), Rows(h))", False),
]


def build_cluster_index(holder, shards: int) -> None:
    """bench.py's f, g and h over ``shards`` shards (build_bench_index), and
    the existence of h's columns, so that Not has a universe."""
    import numpy as np

    build_bench_index(holder, shards)
    idx = holder.index("bench")
    h = idx.field("h")
    exists = idx.existence_field()
    for shard in range(shards):
        cols = np.unique(np.concatenate([h.row(r, shard).columns() for r in range(H_ROWS)]))
        exists.import_bits(np.zeros(cols.size, dtype=np.uint64), cols.astype(np.uint64))


class ClusterNodeProc:
    """One `python -m pilosa_tpu_torch.cli server` process of the cluster
    phase, its log appended to across restarts."""

    def __init__(self, root, env, data_dir, port, log_path):
        self.root, self.env, self.data_dir, self.port = root, env, data_dir, port
        self.log_path = log_path
        self.url = f"http://127.0.0.1:{port}"
        self.id = f"node-127.0.0.1-{port}"
        self.proc = None

    def start(self, conf: str) -> None:
        with open(self.log_path, "a") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d", self.data_dir,
                 "--bind", f"127.0.0.1:{self.port}", "-c", conf, "--executor", "cuda"],
                cwd=self.root, env=self.env, stdout=out, stderr=subprocess.STDOUT)

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def stop(self) -> int:
        """SIGINT, which must stop the node with exit code 0."""
        import signal

        self.proc.send_signal(signal.SIGINT)
        try:
            return self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            return -9

    def kill(self) -> None:
        if self.alive():
            self.proc.kill()
            self.proc.wait()


def cluster_http(url: str, path: str, body=None, timeout: float = 900.0):
    """(parsed JSON answer, seconds) of one request."""
    import urllib.request

    req = urllib.request.Request(url + path, data=None if body is None else body.encode(),
                                 method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    return json.loads(raw), time.perf_counter() - t0


def cluster_counters(node) -> dict:
    """A node's launches by kind (/debug/programs), cpu_routed_total by
    call and stack_full_rebuilds_total (/metrics)."""
    import re
    import urllib.request

    programs, _ = cluster_http(node.url, "/debug/programs")
    launches: dict = {}
    for e in programs["entries"]:
        launches[e["kind"]] = launches.get(e["kind"], 0) + e["launches"]
    with urllib.request.urlopen(node.url + "/metrics", timeout=120) as r:
        metrics = r.read().decode()
    routed: dict = {}
    for ln in metrics.splitlines():
        if ln.startswith("pilosa_cpu_routed_total{"):
            call = re.search(r'call="([^"]+)"', ln)
            routed[call.group(1) if call else "?"] = float(ln.rsplit(" ", 1)[1])
    return {"launches": launches, "routed": routed,
            "rebuilds": metric_sum(metrics, "stack_full_rebuilds_total")}


def counters_delta(after: dict, before: dict) -> dict:
    def d(a, b):
        return {k: a[k] - b.get(k, 0) for k in sorted(a) if a[k] != b.get(k, 0)}

    return {"launches": d(after["launches"], before["launches"]),
            "routed": d(after["routed"], before["routed"]),
            "rebuilds": after["rebuilds"] - before["rebuilds"]}


def pinned_columns(node, shard: int, pql: str = "Row(f=1)") -> list:
    """The columns a node's own copy of `shard` answers for a Row call: a
    remote (per-node) leg pinned to that shard."""
    out, _ = cluster_http(node.url, f"/index/bench/query?shards={shard}&remote=true", pql)
    return out["results"][0]["columns"]


def phase_cluster(root, shards: int = CLUSTER_SHARDS):
    """Two `cli server` processes of one cluster (cluster.hosts, replicas 2,
    executor cuda) share the card over one index of bench.py's f, g and h,
    written through the port's holder and copied to the second node. The
    CLUSTER_READS go to both nodes over HTTP, each answer checked against
    the CPU oracle's over the same data (which the in-process single-node
    executor on the card must match first); for each kind and node: the
    first request's seconds, p50, p90 and p99 over a window of up to 100
    (a GroupBy's one request alone), and each node's launches by kind
    (/debug/programs), cpu_routed_total and stack_full_rebuilds_total
    deltas. Then a Set and a Clear through the
    node that is not the coordinator, read back from each replica by a
    pinned remote leg; the loss of that node (SIGKILL), after which the
    survivor answers every read as before (its first answer's seconds
    include the stacks it builds for the shards it now serves); a write on
    the survivor, the lost node restarted on its persisted topology, and
    its pinned answer holding the write after an anti-entropy pass. A
    non-zero exit, a traceback or a refusal in a node's log fails the
    phase; both nodes are stopped when it ends."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.utils import fastjson

    t0 = time.perf_counter()
    steps = []

    def step(name):
        steps.append((name, round(time.perf_counter() - t0, 1)))
        log(f"cluster: {name} done at {steps[-1][1]} s")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    nodes = []
    try:
        dirs = [os.path.join(tmp, "node0"), os.path.join(tmp, "node1")]
        holder = Holder(dirs[0]).open()
        build_cluster_index(holder, shards)
        build_s = time.perf_counter() - t0

        def answers(ex):
            out = {}
            for kind, q, _ in CLUSTER_READS:
                body = fastjson.response_body([fastjson.encode_result(r)
                                               for r in ex.execute("bench", q)])
                out[kind] = json.loads(body)["results"]
            return out

        # The expected answers: the CPU oracle's over the same holder, which
        # the in-process single-node executor on the card must match.
        t1 = time.perf_counter()
        expected = answers(Executor(holder, backend=CPUBackend(holder)))
        oracle_s = time.perf_counter() - t1
        backend = CUDABackend(holder)
        single = answers(Executor(holder, backend=backend))
        for kind, _, _ in CLUSTER_READS:
            check(single[kind] == expected[kind],
                  f"cluster: the single node's {kind} disagrees with the CPU oracle")
        log(f"cluster: the CPU oracle's answers in {oracle_s:.1f} s; the single node on the "
            "card agrees")
        holder.close()
        del single, backend
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        shutil.copytree(dirs[0], dirs[1])
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(dirs[0]) for f in fs)
        log(f"cluster: index bench, {shards} shards (f, g: {ROWS} rows, h: {H_ROWS} rows, "
            f"density {DENSITY}), written in {build_s:.1f} s, {size} bytes on disk a node, "
            f"copied in {time.perf_counter() - t1:.1f} s")
        step("data")

        env = dict(os.environ, PYTHONPATH=root)
        ports = [free_port(), free_port()]
        while ports[1] == ports[0]:
            ports[1] = free_port()
        hosts = ", ".join(f'"127.0.0.1:{p}"' for p in ports)
        common = (f"hedge-delay = 0.0\n[anti-entropy]\ninterval = {CLUSTER_ANTI_ENTROPY_S}\n")
        conf = os.path.join(tmp, "cluster.toml")
        with open(conf, "w") as f:
            f.write(common + f"[cluster]\nhosts = [{hosts}]\nreplicas = 2\n")
        restart_conf = os.path.join(tmp, "restart.toml")
        with open(restart_conf, "w") as f:
            f.write(common)
        nodes = [ClusterNodeProc(root, env, d, p, os.path.join(tmp, f"node{k}.log"))
                 for k, (d, p) in enumerate(zip(dirs, ports))]
        for n in nodes:
            n.start(conf)
        for n in nodes:
            wait_for_port(n.port, n.proc, seconds=600)
        status, _ = cluster_http(nodes[0].url, "/status")
        coord_id = next(x["id"] for x in status["nodes"] if x["isCoordinator"])
        coord = next(n for n in nodes if n.id == coord_id)
        other = next(n for n in nodes if n is not coord)
        check(len(status["nodes"]) == 2 and status["state"] == "NORMAL",
              f"cluster: /status {status}")
        log(f"cluster: 2 nodes up, coordinator {coord.id}; " + "; ".join(
            ln for n in nodes for ln in n.log().splitlines()
            if "clustered:" in ln or "executor=cuda" in ln))
        step("boot")

        def read(node, kind, q, label):
            out, sec = cluster_http(node.url, "/index/bench/query", q)
            check(out["results"] == expected[kind],
                  f"cluster: {kind} from {label} {node.id} disagrees with the single node")
            return sec

        summary = []
        for node in nodes:
            role = "coordinator" if node is coord else "other"
            for kind, q, windowed in CLUSTER_READS:
                before = [cluster_counters(n) for n in nodes]
                first = read(node, kind, q, role)
                times: list = []
                end = time.perf_counter() + CLUSTER_WINDOW_S
                while windowed and len(times) < CLUSTER_WINDOW_N and (
                        len(times) < CLUSTER_WINDOW_MIN or time.perf_counter() < end):
                    times.append(read(node, kind, q, role))
                delta = [counters_delta(cluster_counters(n), b) for n, b in zip(nodes, before)]
                row = {"kind": kind, "to": role, "first_ms": round(first * 1e3, 3),
                       "requests": 1 + len(times)}
                for p in (50, 90, 99) if times else ():
                    row[f"p{p}_ms"] = round(float(np.percentile(times, p)) * 1e3, 3)
                row.update(coordinator=delta[nodes.index(coord)],
                           other=delta[nodes.index(other)])
                summary.append(row)
                log("cluster: " + json.dumps(row))
        step("reads")

        # Writes through the node that is not the coordinator, read back
        # from each replica's own copy. The columns written hold h's bits
        # already, so the existence row (which a Clear leaves) stays as it
        # was and every expected answer but f's holds.
        def fresh_column(shard):
            have = set(pinned_columns(coord, shard))
            return next(c for c in pinned_columns(coord, shard, "Row(h=0)") if c not in have)

        shard = shards // 2
        col = fresh_column(shard)
        cluster_http(other.url, "/index/bench/query", f"Set({col}, f=1)")
        for n in nodes:
            check(col in pinned_columns(n, shard), f"cluster: Set({col}) missing on {n.id}")
        cluster_http(other.url, "/index/bench/query", f"Clear({col}, f=1)")
        for n in nodes:
            check(col not in pinned_columns(n, shard),
                  f"cluster: Clear({col}) did not reach {n.id}")
        log(f"cluster: Set and Clear of column {col} through {other.id} reached both "
            "replicas (pinned remote legs)")
        step("writes")

        # Node loss: the survivor answers every read as before.
        other.kill()
        t_loss = time.perf_counter()
        before = cluster_counters(coord)
        first = read(coord, "Count(Row)", "Count(Row(f=1))", "survivor")
        lost = {"first_ms": round(first * 1e3, 3)}
        for kind, q, _ in CLUSTER_READS:
            lost[kind + " ms"] = round(read(coord, kind, q, "survivor") * 1e3, 3)
        lost["survivor"] = counters_delta(cluster_counters(coord), before)
        log(f"cluster: {other.id} killed (SIGKILL); the survivor's first answer "
            f"{lost['first_ms']} ms, every read equal in "
            f"{time.perf_counter() - t_loss:.1f} s: " + json.dumps(lost))
        step("loss")

        # The survivor's failure detector confirms the loss (CONFIRM_DOWN
        # probes a second apart) before the write. Until then the write's
        # leg to the dead replica fails and the write is answered 502, as
        # a write that a reachable-looking replica did not take must be;
        # the reads above can end before the confirmation.
        t_down = time.perf_counter()
        while True:
            status, _ = cluster_http(coord.url, "/status")
            if any(x["id"] == other.id and x["state"] == "DOWN" for x in status["nodes"]):
                break
            check(time.perf_counter() - t_down < 60,
                  f"cluster: {coord.id} never marked {other.id} DOWN: {status}")
            time.sleep(0.25)
        log(f"cluster: {coord.id} marked {other.id} DOWN "
            f"{time.perf_counter() - t_loss:.1f} s after the kill")

        # Heal: a write on the survivor reaches the restarted node by
        # anti-entropy.
        shard2 = (shard + 1) % shards
        col2 = fresh_column(shard2)
        cluster_http(coord.url, "/index/bench/query", f"Set({col2}, f=1)")
        check(col2 in pinned_columns(coord, shard2), "cluster: the survivor lost its write")
        t_restart = time.perf_counter()
        other.start(restart_conf)
        wait_for_port(other.port, other.proc, seconds=600)
        check("restored topology" in other.log(),
              f"cluster: {other.id} did not restore its topology: {other.log()[-2000:]}")
        deadline = time.perf_counter() + 6 * CLUSTER_ANTI_ENTROPY_S + 60
        while col2 not in pinned_columns(other, shard2):
            check(time.perf_counter() < deadline and other.alive(),
                  f"cluster: anti-entropy never healed column {col2} on {other.id}")
            time.sleep(1.0)
        heal_s = time.perf_counter() - t_restart
        count, _ = cluster_http(other.url, "/index/bench/query", "Count(Row(f=1))")
        check(count["results"] == [expected["Count(Row)"][0] + 1],
              f"cluster: after the heal {other.id} counts {count['results']}")
        log(f"cluster: {other.id} restarted on its persisted topology; its pinned answer "
            f"holds the survivor's write {heal_s:.1f} s after the restart")
        step("heal")

        rcs = [n.stop() for n in nodes]
        for n, rc in zip(nodes, rcs):
            text = n.log()
            check(rc == 0, f"cluster: {n.id} exited with {rc}: {text[-2000:]}")
            bad = [ln for ln in text.splitlines()
                   if "Traceback" in ln or "refusing" in ln or "not serving" in ln]
            check(not bad, f"cluster: {n.id}'s log: {bad[:5]}")
        log("cluster: " + json.dumps({"shards": shards, "steps": steps, "reads": len(summary)}))
    finally:
        for n in nodes:
            n.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"cluster: {time.perf_counter() - t0:.1f} s")


def phase_cluster_alone(root, shards: int) -> int:
    """`chip_smoke.py --cluster`: the card line and the kernel libraries,
    built and loaded before any node starts, then phase_cluster."""
    import torch

    phase_card()
    phase_cluster(root, shards)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 4e: the shard mesh on the one card
# ---------------------------------------------------------------------------

#: Parts of the meshed backends: 954 shards in two parts of 477, and in
#: four of 239 (padded to 956). On a one-card machine every part is on
#: cuda:0: the run shows the padded placement, the per-part builds, the
#: K15 splice, the per-part launches and the merges, not distinct cards.
MESH_PARTS = (2, 4)
#: A read kind's window on a backend, the tables dropped before each
#: request: MESH_WINDOW_N timed requests, or as many as MESH_WINDOW_S
#: seconds allow but at least MESH_WINDOW_MIN; p50 and p90 over it. A
#: bitmap read (seconds of host unpack) is timed once, in the first run.
MESH_WINDOW_N = 100
MESH_WINDOW_S = 1.5
MESH_WINDOW_MIN = 30
#: Runs of the windows, the backends in alternating order (unmeshed first,
#: then last), each after a cold build in that order: MESH_RUNS under
#: ``--mesh``, MESH_RUNS_WHOLE in the whole run, which keeps one run of
#: windows so that it stays well inside its time limit.
MESH_RUNS = 2
MESH_RUNS_WHOLE = 1
#: tests/test_mesh.py's FAMILIES on bench.py's fields (its hh is h here).
MESH_FAMILIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=7)))",
    "Count(Union(Row(f=1), Row(f=2), Row(f=3)))",
    "Count(Difference(Row(f=1), Row(g=7)))",
    "Count(Xor(Row(f=1), Row(g=7)))",
    "Count(Not(Row(f=1)))",
    "Row(f=2)",
    "Intersect(Row(f=1), Row(g=7))",
    "TopN(f, n=3)",
    "TopN(f, Row(g=7), n=2)",
    "Sum(field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "Count(Row(v > 100))",
    "Count(Row(v >< [-100, 100]))",
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), Rows(h))",
]
#: Write epochs through the executor: bit writes on resident rows (each
#: set bit cleared by the next epoch) and BSI value writes, in shards of
#: every part at n = 2 and 4 (shard 10 in the first, 600 and 900 later).
MESH_EPOCHS = [
    ["Set(10485770, f=1)", "Set(629145605, g=2)", "Set(943718410, v=1234)"],
    ["Clear(10485770, f=1)", "Clear(629145605, g=2)", "Set(943718410, v=-4321)"],
    ["Set(524288019, f=5)", "Set(10485790, h=1)", "Set(943718411, v=17)"],
]
#: The kernels that the meshed path must launch (phase_mesh's reads, its
#: builds and its write epochs).
MESH_KERNELS = ("spec_eval", "pair_stats_pershard", "pair_stats", "popcount_rows",
                "row_popcounts", "bsi_minmax", "bsi_compare", "group_tile_stats",
                "group_tile_stats_pershard", "splice_slabs", "expand_positions")


def mesh_reads() -> list:
    """(kind, PQL, returns a bitmap): the FAMILIES, bench.py's Count, the
    16-Count pair request and bench.py's GroupBy queries."""
    out, seen = [], set()
    for q in (MESH_FAMILIES + ["Count(Intersect(Row(f=1), Row(g=2)))", PAIR_REQUEST]
              + GROUP_QUERIES):
        if q not in seen:
            seen.add(q)
            kind = "16-Count pair request" if q == PAIR_REQUEST else q
            out.append((kind, q, q.startswith(("Row(", "Intersect("))))
    return out


def drop_backend_caches(backend) -> None:
    """Drop the pair, TopN, aggregate and GroupN tables: the next request
    of each kind sweeps on the card."""
    with backend._pair_lock:
        backend._pair_cache.clear()
        backend._topn_cache.clear()
        backend._agg_cache.clear()
        backend._groupn_cache.clear()


def counter_total(name: str) -> float:
    from pilosa_tpu_torch.utils.stats import global_stats

    return sum(global_stats.counter_totals(name).values())


def mesh_backend(holder, n, cards: bool = False):
    """The Executor (with its batcher) over CUDABackend(holder), meshed over
    n parts when n is given: all on cuda:0, or with cards one a card
    (cuda:0 .. cuda:n-1)."""
    import torch

    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.batcher import ShardLegBatcher
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.parallel import ShardMesh

    mesh = None
    if n:
        mesh = ShardMesh([torch.device("cuda", i if cards else 0) for i in range(n)])
    be = CUDABackend(holder, mesh=mesh)
    ex = Executor(holder, backend=be)
    ex.batcher = ShardLegBatcher(be)
    return be, ex


def mesh_read_pass(ex, reads, want=None, label="", rows=True, times=None):
    """Each read once; its answer checked against want[q] when given, and
    its ms put in times[kind] when times is given. Returns {q: answer}."""
    import torch

    got = {}
    for kind, q, is_row in reads:
        if is_row and not rows:
            continue
        t0 = time.perf_counter()
        got[q] = ex.execute("bench", q)
        torch.cuda.synchronize()
        if times is not None:
            times[kind] = (time.perf_counter() - t0) * 1e3
        if want is not None:
            check(same_answers(got[q], want[q]), f"mesh {label}: {q} disagrees with the "
                                                 "unmeshed backend")
    return got


def window_stats(times) -> dict:
    import numpy as np

    return {"n": len(times), "p50_ms": float(np.percentile(times, 50)),
            "p90_ms": float(np.percentile(times, 90))}


def mesh_timings(be, ex, reads, label) -> dict:
    """Per read kind but the bitmap reads: a window of requests (MESH_WINDOW_N,
    MESH_WINDOW_S, MESH_WINDOW_MIN), each with the tables dropped first;
    its ms, programs (device_launches_total) and kernel launches a
    request."""
    import torch

    out = {}
    for kind, q, is_row in reads:
        if is_row:
            continue
        times = []
        end = time.perf_counter() + MESH_WINDOW_S
        while len(times) < MESH_WINDOW_N and (
                len(times) < MESH_WINDOW_MIN or time.perf_counter() < end):
            drop_backend_caches(be)
            progs0, k0 = counter_total("device_launches_total"), query_launches()
            t0 = time.perf_counter()
            ex.execute("bench", q)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            progs = counter_total("device_launches_total") - progs0
            kl = {k: v - k0[k] for k, v in query_launches().items() if v != k0[k]}
        st = window_stats(times)
        out[kind] = {"times": times, "programs": progs, "launches": kl}
        log(f"mesh {label}: {kind[:60]}: p50 {st['p50_ms']:.3f} p90 {st['p90_ms']:.3f} ms "
            f"over {st['n']}, programs {progs:g}, kernel launches {json.dumps(kl)}")
    return out


def drop_backend_stacks(be) -> None:
    """Drop a backend's tables and resident stacks: its next reads build
    every stack cold."""
    import torch

    drop_backend_caches(be)
    with be.blocks._lock:
        for key in list(be.blocks._entries):
            be.blocks._drop(key)
    gc.collect()
    torch.cuda.empty_cache()


def mesh_cli(root) -> None:
    """`cli server --mesh-devices N`: past the visible cards it exits
    non-zero with MeshConfigError's message; --mesh-devices 1 serves on the
    card, its answers those of the in-process executor; where more than
    one card is visible, --mesh-devices -1 serves over all of them with
    the same answers."""
    import tempfile

    import numpy as np
    import torch

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    from pilosa_tpu_torch.utils import fastjson

    visible = torch.cuda.device_count()
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        data_dir = os.path.join(tmp, "data")
        holder = Holder(data_dir).open()
        idx = holder.create_index("small")
        rng = np.random.default_rng(5)
        for name in ("f", "g"):
            field = idx.create_field(name)
            cols = rng.integers(0, CLI_SHARDS * SHARD_WIDTH, CLI_ROWS * CLI_BITS,
                                dtype=np.uint64)
            field.import_bits(rng.integers(0, CLI_ROWS, cols.size, dtype=np.uint64), cols)
        holder.close()
        want = visible + 1
        refused = subprocess.run(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d", data_dir,
             "--bind", f"127.0.0.1:{free_port()}", "--mesh-devices", str(want)],
            cwd=root, env=env, capture_output=True, text=True, timeout=120)
        msg = f"mesh-devices={want} but {visible} card"
        check(refused.returncode != 0 and msg in refused.stderr,
              f"mesh: cli server --mesh-devices {want} on {visible} visible: rc "
              f"{refused.returncode}, {refused.stderr[-1500:]}")
        log(f"mesh: cli server --mesh-devices {want} exits {refused.returncode}: "
            + next(ln for ln in refused.stderr.splitlines() if msg in ln).strip())
        run = cli_server_run(root, env, data_dir, tmp, ["--mesh-devices", "1"], None)
        check("executor=cuda: device backend on cuda" in run["log"] and "1 device" in run["log"],
              f"mesh: cli server --mesh-devices 1 did not serve on one card: "
              f"{run['log'][-1500:]}")
        holder = Holder(data_dir).open()
        try:
            dev = Executor(holder, backend=CUDABackend(holder))
            for q in CLI_QUERIES:
                body = fastjson.response_body(
                    [fastjson.encode_result(r) for r in dev.execute("small", q)])
                check(run["got"][q] == body, f"mesh: cli {q} disagrees in-process")
        finally:
            holder.close()
        log(f"mesh: cli server --mesh-devices 1 served {len(CLI_QUERIES)} answers equal to "
            f"the in-process executor's, exit code {run['rc']}")
        if visible > 1:
            every = cli_server_run(root, env, data_dir, tmp, ["--mesh-devices", "-1"], None)
            check(f"{visible} devices" in every["log"] and every["got"] == run["got"],
                  f"mesh: cli server --mesh-devices -1 over {visible} cards: "
                  f"{every['log'][-1500:]}")
            log(f"mesh: cli server --mesh-devices -1 served over {visible} cards, the same "
                f"answers, exit code {every['rc']}")


def phase_mesh(holder, root, cards: bool = False, n_runs: int = MESH_RUNS) -> dict:
    """The shard mesh on the card, on bench.py's index with v (5.0 GB): an
    unmeshed CUDABackend and meshed ones over ShardMesh([cuda:0] * n), n in
    MESH_PARTS, each with its batcher. Every read of mesh_reads() answers
    as the unmeshed backend does, cold and after each of MESH_EPOCHS, which
    the stacks absorb by splices (K15 on the meshed ones): no stack is
    rebuilt whole, stack_incremental_updates_total rises, and K15's
    launches equal what the package's rounds give (SpliceSplit.
    expected_launches: the sum over the parts of ceil(dirty shards in the
    part / 32) at rows_p 8, one launch a dirty shard in a package with
    MESH_UPDATE_CHUNK 1). Per read kind and backend, a window of requests
    (mesh_timings) in each of n_runs runs (MESH_RUNS under ``--mesh``,
    MESH_RUNS_WHOLE in the whole run), the backends built cold and timed
    in alternating order; the table pools the runs' windows into p50 and
    p90 beside each run's p50, with the programs and kernel launches a
    request. A bitmap read is timed once. The kernel counts are zeroed before the
    phase and read after: every kernel of MESH_KERNELS must have launched.
    Then the epoch absorption (phase_epochs) on the same backends. Returns
    those counts. cards puts the parts on distinct cards (``--mesh-cards``,
    on a machine with at least as many), one a card, and prints each
    card's allocated bytes once the stacks are built."""
    import torch

    from pilosa_tpu_torch.ops import kernels as K

    t_phase = time.perf_counter()
    reads = mesh_reads()
    K.reset_launch_counts()
    parts = [n for n in MESH_PARTS if not cards or n <= torch.cuda.device_count()]
    check(parts, f"mesh: {torch.cuda.device_count()} cards for meshes of {MESH_PARTS}")
    where = "one a card" if cards else "on cuda:0"
    labels = [("unmeshed", None)] + [(f"mesh {n} ({where})", n) for n in parts]
    exes, want, runs, row_ms = {}, None, [], {}
    for run in range(n_runs):
        order = labels if run % 2 == 0 else labels[::-1]
        cold, timings = {}, {}
        for label, n in order:
            if run == 0:
                exes[label] = mesh_backend(holder, n, cards)
            else:
                drop_backend_stacks(exes[label][0])
            be, ex = exes[label]
            t0 = time.perf_counter()
            first = mesh_read_pass(ex, reads, want, label, rows=False)
            cold[label] = time.perf_counter() - t0
            if run == 0:
                row_ms[label] = {}
                rows = mesh_read_pass(ex, [r for r in reads if r[2]], want, label,
                                      times=row_ms[label])
                if want is None:
                    want = dict(first, **rows)
            if n:
                entries = be.blocks._entries.items()
                check(entries and all(len(e[1].parts) == n and e[1].shape[0] % n == 0
                                      for _, e in entries),
                      f"mesh {label}: a resident stack is not cut into {n} parts")
                shapes = [(k[1], k[2], tuple(e[1].shape)) for k, e in entries]
                part_bytes = sorted({b for _, e in entries for b in e[1].part_bytes()})
                placed = f", stacks {shapes}, part bytes {part_bytes}"
                if cards:
                    placed += ", allocated bytes by card " + json.dumps(
                        [torch.cuda.memory_allocated(i)
                         for i in range(torch.cuda.device_count())])
            else:
                placed = ""
            log(f"mesh run {run} {label}: cold reads (stack builds included) "
                f"{cold[label]:.2f} s, {len(reads)} reads equal to the unmeshed "
                f"backend's{placed}")
        for label, _ in order:
            timings[label] = mesh_timings(*exes[label], reads, f"run {run} {label}")
        runs.append({"order": [lb for lb, _ in order], "cold_s": cold, "timings": timings})
    writer = exes["unmeshed"][1]
    for k, writes in enumerate(MESH_EPOCHS):
        for q in writes:
            writer.execute("bench", q)
        want = mesh_read_pass(writer, reads, None, "unmeshed", rows=k == len(MESH_EPOCHS) - 1)
        for label, n in labels[1:]:
            be, ex = exes[label]
            c0 = {c: counter_total(c) for c in ("stack_incremental_updates_total",
                                                "stack_incremental_shards_total",
                                                "stack_full_rebuilds_total")}
            k15 = K.launch_counts().get("splice_slabs", 0)
            with SpliceSplit() as split:
                mesh_read_pass(ex, reads, want, f"{label} epoch {k}",
                               rows=k == len(MESH_EPOCHS) - 1)
            d = {c: counter_total(c) - v for c, v in c0.items()}
            spliced = K.launch_counts().get("splice_slabs", 0) - k15
            rounds = split.expected_launches()
            check(d["stack_full_rebuilds_total"] == 0,
                  f"mesh {label} epoch {k}: a stack was rebuilt whole: {d}")
            check(d["stack_incremental_updates_total"] > 0 and spliced > 0
                  and spliced == rounds
                  and split.totals()["dirty"] == d["stack_incremental_shards_total"],
                  f"mesh {label} epoch {k}: K15 launched {spliced}, its rounds give "
                  f"{rounds}, for {d}")
            log(f"mesh {label} epoch {k}: reads equal; splices "
                f"{d['stack_incremental_updates_total']:g} over "
                f"{d['stack_incremental_shards_total']:g} shards, K15 launches {spliced} "
                f"(the rounds give {rounds}), full rebuilds 0")
    launches = K.launch_counts()
    missing = [k for k in MESH_KERNELS if not launches.get(k)]
    check(not missing, f"mesh: kernels of the meshed path never launched: {missing}")
    log(f"mesh: kernel launches of the phase {json.dumps(launches)}")
    for kind, q, is_row in reads:
        cells = []
        for label, _ in labels:
            if is_row:
                cells.append(f"{label} {row_ms[label][kind]:.3f} ms (one request)")
                continue
            pooled = window_stats([t for r in runs for t in r["timings"][label][kind]["times"]])
            per_run = ", ".join(f"{window_stats(r['timings'][label][kind]['times'])['p50_ms']:.3f}"
                                for r in runs)
            last = runs[-1]["timings"][label][kind]
            cells.append(f"{label} p50 {pooled['p50_ms']:.3f} p90 {pooled['p90_ms']:.3f} ms "
                         f"over {pooled['n']} (p50 a run {per_run}), programs "
                         f"{last['programs']:g}, launches {sum(last['launches'].values())}")
        log(f"mesh table: {kind[:60]}: " + "; ".join(cells))
    for r in runs:
        log("mesh cold reads s, in the order built: "
            + ", ".join(f"{lb} {r['cold_s'][lb]:.2f}" for lb in r["order"]))
    phase_epochs([(label, n) + exes[label] for label, n in labels])
    del exes
    gc.collect()
    torch.cuda.empty_cache()
    mesh_cli(root)
    log(f"mesh: {time.perf_counter() - t_phase:.1f} s "
        + (f"(the parts on distinct cards of {torch.cuda.device_count()})" if cards else
           "(one card: every part on cuda:0; no placement across cards, P2P copies or "
           "concurrency between cards)"))
    return launches


def splice_parts(n_parts: int = MESH_PARTS[0]):
    """K15's inputs at the shapes the meshed main path gives it: one part of
    f's stack over SHARDS shards in n_parts parts (477 x 8 x 32768 words at
    n = 2) and a round's worth of slabs (MAX_SPLICE_ENTRIES), random
    words."""
    import torch

    from pilosa_tpu_torch.ops import kernels as K

    s_local = -(-SHARDS // n_parts)
    gen = torch.Generator(device="cuda").manual_seed(15)
    part = torch.randint(-2**31, 2**31 - 1, (s_local, ROWS, 32768), dtype=torch.int32,
                         device="cuda", generator=gen)
    slabs = torch.randint(-2**31, 2**31 - 1, (K.MAX_SPLICE_ENTRIES, ROWS, 32768),
                          dtype=torch.int32, device="cuda", generator=gen)
    return part, slabs, s_local


class SpliceSplit:
    """Within its block, times and records every dirty-shard splice of the
    --root package by wrapping what the port has had since its mesh:
    _StackedBlocks._splice (the splice's host seconds, "host"; then a
    synchronize, whose seconds are "wait": the device work that the splice
    left, which the read that follows would wait for at its readback),
    _StackedBlocks._pack_slabs ("pack"), and the K15 wrapper that
    exec/cuda.py calls and Tensor.index_copy_ inside a splice ("launch").
    "copy" is the rest of the splice's host time: staging and enqueueing
    the host-to-device copy, or a pageable copy that blocks; "take" is the
    part of it spent taking staging buffers from ops/sparse.py's pool
    (waits on their last copies included; 0 where the package's splice
    does not stage through the pool). Each record
    also holds the splice's dirty positions, its parts, shards a part and
    rows_p."""

    def __init__(self):
        self.splices = []
        self._saved = []

    def __enter__(self):
        import torch

        from pilosa_tpu_torch.exec import cuda as cuda_mod
        from pilosa_tpu_torch.ops import sparse

        blocks = cuda_mod._StackedBlocks
        cur = {}  # the splice in progress, empty outside one

        def timed(key, fn):
            def wrapper(*a, **k):
                if not cur:
                    return fn(*a, **k)
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    cur[key] += time.perf_counter() - t0
            return wrapper

        real_splice = blocks._splice

        def splice(be, old_arr, shards, frags, dirty, rows_p):
            parts = getattr(old_arr, "parts", None) or [old_arr]
            cur.update(dirty=list(dirty), parts=len(parts), s_local=int(parts[0].shape[0]),
                       rows_p=rows_p, pack=0.0, launch=0.0, take=0.0)
            t0 = time.perf_counter()
            try:
                out = real_splice(be, old_arr, shards, frags, dirty, rows_p)
                cur["host"] = time.perf_counter() - t0
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                cur["wait"] = time.perf_counter() - t1
            finally:
                rec = dict(cur)
                cur.clear()
            rec["copy"] = rec["host"] - rec["pack"] - rec["launch"]
            self.splices.append(rec)
            return out

        self._saved = [(obj, name, obj.__dict__.get(name, _MISSING)) for obj, name in (
            (blocks, "_splice"), (blocks, "_pack_slabs"), (cuda_mod, "splice_slabs"),
            (torch.Tensor, "index_copy_"), (sparse, "_take_buffer"))]
        sparse._take_buffer = timed("take", sparse._take_buffer)
        blocks._pack_slabs = timed("pack", blocks._pack_slabs)
        cuda_mod.splice_slabs = timed("launch", cuda_mod.splice_slabs)
        torch.Tensor.index_copy_ = timed("launch", torch.Tensor.index_copy_)
        blocks._splice = splice
        return self

    def __exit__(self, *exc):
        for obj, name, was in reversed(self._saved):
            if was is _MISSING:
                delattr(obj, name)
            else:
                setattr(obj, name, was)
        return False

    def totals(self) -> dict:
        """The splices, their dirty shards and their summed split in ms."""
        out = {"splices": len(self.splices),
               "dirty": sum(len(r["dirty"]) for r in self.splices)}
        for key in ("pack", "copy", "take", "launch", "wait", "host"):
            out[key + "_ms"] = 1e3 * sum(r[key] for r in self.splices)
        return out

    def expected_launches(self) -> int:
        """The K15 launches the recorded meshed splices make under the
        package's rounds: MESH_UPDATE_CHUNK slabs a part a round where the
        package has that constant (one a dirty shard), else at most
        MAX_SPLICE_ENTRIES slabs and sparse.CHUNK_WORDS words."""
        from pilosa_tpu_torch.exec import cuda as cuda_mod
        from pilosa_tpu_torch.ops import kernels as K
        from pilosa_tpu_torch.ops import sparse

        chunk = getattr(cuda_mod._StackedBlocks, "MESH_UPDATE_CHUNK", None)
        n = 0
        for r in self.splices:
            if r["parts"] == 1:
                continue
            per = chunk or max(1, min(K.MAX_SPLICE_ENTRIES,
                                      sparse.CHUNK_WORDS // (r["rows_p"] * 32768)))
            by_part: dict = {}
            for i in r["dirty"]:
                by_part[i // r["s_local"]] = by_part.get(i // r["s_local"], 0) + 1
            n += sum(-(-c // per) for c in by_part.values())
        return n


_MISSING = object()

#: The epoch absorption measure (phase_epochs): EPOCH_REPS write epochs of
#: each kind on each backend, each absorbed by the first EPOCH_READ after
#: it, which splices f's resident stack (a 3-row Count is one K11 launch on
#: the stack; a single-row Count may be answered by the host's pair table).
EPOCH_KINDS = ("1 shard", "8 a part", "400 spread")
EPOCH_REPS = 3
EPOCH_READ = "Count(Union(Row(f=1), Row(f=2), Row(f=3)))"
#: The column of a shard that an epoch kind toggles in row 1 of f (k-th
#: kind: EPOCH_COL + k).
EPOCH_COL = 777


def epoch_shards(kind: str, n_parts: int) -> list:
    """The shards an epoch of the kind dirties on a backend of n_parts
    parts (1 unmeshed): shard 318, in the middle of a part at n = 2 and 4;
    8 in each part, 13 apart; 400 spread evenly over the 954."""
    import numpy as np

    if kind == "1 shard":
        return [SHARDS // 3]
    if kind == "8 a part":
        s_local = -(-SHARDS // n_parts)
        return [d * s_local + 5 + 13 * k for d in range(n_parts) for k in range(8)]
    return sorted(set(np.linspace(0, SHARDS - 1, 400).round().astype(int).tolist()))


def phase_epochs(backends) -> dict:
    """One write epoch absorbed end to end, on each of ``backends`` ((label,
    parts or None, backend, executor), f's stack resident on each): for
    each EPOCH_KINDS and EPOCH_REPS times, the epoch's writes (one query of
    Set or Clear calls, each toggling a bit of f's row 1) and the first
    read after them (EPOCH_READ, which splices), each timed on the host
    clock; the read's splices split into pack, copy, launch and wait
    (SpliceSplit); K15 launches equal to what the rounds give, every
    written shard spliced, no full rebuild. Every backend absorbs the
    others' epochs with an untimed read before its own. Prints a line a
    backend and kind and the table; returns it."""
    import torch

    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    t_phase = time.perf_counter()
    cols = {k: EPOCH_COL + i for i, k in enumerate(EPOCH_KINDS)}
    every = sorted({s for k in EPOCH_KINDS for n in (1, 2, 4) for s in epoch_shards(k, n)})
    writer = backends[0][3]
    for kind, col in cols.items():  # start from clear bits
        writer.execute("bench", " ".join(f"Clear({s * SHARD_WIDTH + col}, f=1)" for s in every))
    is_set: dict = {}  # (column, shard) -> the bit is set
    table = {}
    for label, n, _, ex in backends:
        ex.execute("bench", EPOCH_READ)
        for kind in EPOCH_KINDS:
            shards = epoch_shards(kind, n or 1)
            rows = []
            for rep in range(EPOCH_REPS):
                q = " ".join(f"{'Clear' if is_set.get((cols[kind], s)) else 'Set'}"
                             f"({s * SHARD_WIDTH + cols[kind]}, f=1)" for s in shards)
                c0 = {c: counter_total(c) for c in ("stack_full_rebuilds_total",
                                                    "stack_incremental_shards_total")}
                k0 = K.launch_counts().get("splice_slabs", 0)
                t0 = time.perf_counter()
                changed = ex.execute("bench", q)
                writes_ms = (time.perf_counter() - t0) * 1e3
                for s in shards:
                    is_set[(cols[kind], s)] = not is_set.get((cols[kind], s))
                check(len(changed) == len(shards) and all(changed),
                      f"epochs {label} {kind}: a write changed no bit")
                with SpliceSplit() as split:
                    t0 = time.perf_counter()
                    ex.execute("bench", EPOCH_READ)
                    torch.cuda.synchronize()
                    read_ms = (time.perf_counter() - t0) * 1e3
                d = {c: counter_total(c) - v for c, v in c0.items()}
                k15 = K.launch_counts().get("splice_slabs", 0) - k0
                tot = split.totals()
                check(d["stack_full_rebuilds_total"] == 0,
                      f"epochs {label} {kind}: a stack was rebuilt whole")
                check(tot["splices"] == 1 and tot["dirty"] == len(shards)
                      == d["stack_incremental_shards_total"],
                      f"epochs {label} {kind}: {len(shards)} shards written, splices {tot}")
                check(k15 == split.expected_launches(),
                      f"epochs {label} {kind}: K15 launched {k15}, the rounds give "
                      f"{split.expected_launches()}")
                rows.append(dict(tot, writes_ms=writes_ms, read_ms=read_ms, k15=k15))
            med = {k: statistics.median(r[k] for r in rows)
                   for k in ("writes_ms", "read_ms", "pack_ms", "copy_ms", "take_ms",
                             "launch_ms", "wait_ms")}
            table[f"{label}: {kind}"] = dict(med, dirty=len(shards), k15=rows[0]["k15"],
                                             reps=rows)
            log(f"epochs {label}: {kind} ({len(shards)} shards): read ms "
                + ", ".join(f"{r['read_ms']:.3f}" for r in rows)
                + f" (median {med['read_ms']:.3f}); writes ms median {med['writes_ms']:.3f}; "
                f"splice ms median pack {med['pack_ms']:.3f} copy {med['copy_ms']:.3f} "
                f"(take {med['take_ms']:.3f}) launch {med['launch_ms']:.3f} wait "
                f"{med['wait_ms']:.3f}; K15 launches "
                f"{rows[0]['k15']}, full rebuilds 0")
    left = [f"Clear({s * SHARD_WIDTH + col}, f=1)" for (col, s), on in is_set.items() if on]
    if left:  # leave f's bits as they were
        writer.execute("bench", " ".join(left))
    log("epoch table: " + json.dumps({k: {f: v[f] for f in v if f != "reps"}
                                       for k, v in table.items()}))
    log(f"epochs: {time.perf_counter() - t_phase:.1f} s")
    return table


def phase_epochs_alone(root) -> int:
    """`chip_smoke.py --epochs [--root DIR]`: the card line, f of bench.py's
    index (954 shards, 8 rows), f's stack built on an unmeshed backend and
    on meshes of 2 and 4 parts of the card, and phase_epochs on them, for
    DIR's package. It needs only the executor, the backend's counters and
    the launch counts, so it runs a parent's package as well."""
    import torch

    from pilosa_tpu_torch.core import Holder

    phase_card()
    holder = Holder(None).open()
    t0 = time.perf_counter()
    build_bench_index(holder, only_f=True)
    log(f"epochs: f built in {time.perf_counter() - t0:.1f} s")
    backends = []
    for label, n in [("unmeshed", None)] + [(f"mesh {n}", n) for n in MESH_PARTS]:
        be, ex = mesh_backend(holder, n)
        t0 = time.perf_counter()
        ex.execute("bench", EPOCH_READ)
        log(f"epochs {label}: f's stack cold in {time.perf_counter() - t0:.2f} s")
        backends.append((label, n, be, ex))
    phase_epochs(backends)
    holder.close()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


#: K15's timed shapes: live slabs a launch into one 477-shard part.
SPLICE_SHAPES = (1, 8, 32)
#: Launches a K15 timing cycles its targets over, so that repeated calls
#: do not write the same shards.
SPLICE_ROTATE = 7


def phase_splice_kernel(launches) -> list:
    """K15 against its plain form on the card, exactly: at 1, 8 and 32 live
    slabs into a 477-shard part (rows_p = 8; the rounds of the meshed main
    path) and at 32 entries with duplicate, invalid and clipped ones. At
    each shape: ms (the wrapper), kernel_ms and graph_ms (bare launches of
    the resolved pairs), the plain form's ms, index_copy_'s ms for the same
    splice (also as graph_ms), the bound (each slab read once and written
    once), the launch floor at K15's grid (ops/probe.py splice_floor) and
    the wrapper's host time split (splice_host_us). Each timed call writes
    its slabs over other targets than the call before (SPLICE_ROTATE target
    sets); the slabs are read warm, as a round's just-copied slabs are. The
    line's top-level numbers are the one-slab shape's, every shape's under
    ``cases``."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.ops import probe
    from pilosa_tpu_torch.ops.build import library

    part, slabs, s_local = splice_parts()
    s_l, rows, w = part.shape
    mixed_idx = [(37 * j) % (s_local + 40) - 20 for j in range(32)]
    mixed_idx[6] = mixed_idx[20] = mixed_idx[5]
    mixed = (mixed_idx, [int(j % 7 != 3) for j in range(32)])
    cases = {f"c{c}": ([s_local - 1 - 13 * j for j in range(c)], [1] * c)
             for c in SPLICE_SHAPES}
    cases["c32 duplicate, invalid, clipped"] = mixed
    err = 0
    for label, (idx, valid) in cases.items():
        c = len(idx)
        got = part.clone()
        want = part.clone()
        K.splice_slabs(got, slabs[:c], idx, valid)
        K.splice_slabs_torch(want, slabs[:c], idx, valid)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err = max(err, e)
        del got, want
        log(f"kernel splice_slabs ({label}, {c} entries, "
            f"{K.splice_pairs(np.array(idx, dtype=np.int32), np.array(valid) != 0, s_local).shape[1]}"
            f" live): max_abs_err {e}")
        check(e == 0, f"splice_slabs disagrees with its plain form ({label})")
    lib = library("splice")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for c in SPLICE_SHAPES:
        src = slabs[:c]
        idxs = [np.array([(s_local - 1 - 13 * j - 61 * r) % s_local for j in range(c)],
                         dtype=np.int32) for r in range(SPLICE_ROTATE)]
        valid = np.ones(c, dtype=np.uint32)
        pairs = [K.splice_pairs(i, valid != 0, s_local) for i in idxs]
        idx_t = [torch.from_numpy(i.astype(np.int64)).to("cuda") for i in idxs]
        turn = [0]

        def nxt():
            turn[0] = (turn[0] + 1) % SPLICE_ROTATE
            return turn[0]

        def bare(fixed=True, src=src, pairs=pairs, c=c):
            p = pairs[nxt()]
            rc = lib.splice_slabs_launch(
                part.data_ptr(), src.data_ptr(), p.ctypes.data, c, c, s_l, rows, w,
                stream if fixed else torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SmokeFailure(f"splice_slabs: CUDA launch failed with cudaError {rc}")

        ms = time_ms(lambda: K.splice_slabs(part, src, idxs[nxt()], valid))
        k_ms = kernel_ms(bare)
        g_ms = graph_ms(lambda: bare(fixed=False))
        plain_ms = time_ms(lambda: K.splice_slabs_torch(part, src, idxs[nxt()], valid))
        library_ms = time_ms(lambda: part.index_copy_(0, idx_t[nxt()], src))
        library_graph_ms = graph_ms(lambda: part.index_copy_(0, idx_t[nxt()], src))
        floor = {"kernel_ms": kernel_ms(probe.splice_floor(c, rows, w, stream=stream)),
                 "graph_ms": graph_ms(probe.splice_floor(c, rows, w))}
        host_us = splice_host_us(part, src, idxs[0], valid, pairs[0], lib, stream)
        nbytes = 2 * src.nbytes  # each slab read once, its shard written once
        line = kernel_line("splice_slabs", ms, k_ms, plain_ms, (nbytes, 0), err,
                           launches.get("splice_slabs", 0))
        line.update(graph_ms=g_ms, library_ms=library_ms, library_graph_ms=library_graph_ms,
                    launch_floor=floor, host_us=host_us)
        out[c] = line
        log(f"kernel splice_slabs, {c} live slab(s) of {rows} rows into a {s_l}-shard part: "
            f"ms {ms:.5f}, kernel_ms {k_ms:.5f}, graph_ms {g_ms:.5f}, bound "
            f"{line['bound_ms']:.5f} ({line['bound_by']}, {nbytes} bytes; graph_ms at "
            f"{100 * line['bound_ms'] / g_ms:.0f} %), plain {plain_ms:.5f}, index_copy_ "
            f"{library_ms:.5f} (graph_ms {library_graph_ms:.5f}); launch floor at K15's grid "
            f"kernel_ms "
            f"{floor['kernel_ms']:.5f}, graph_ms {floor['graph_ms']:.5f} "
            f"(graph_ms {g_ms / floor['graph_ms']:.2f} times it); host us a call: "
            + json.dumps({k: round(v, 2) for k, v in host_us.items()}))
    line = dict(out[SPLICE_SHAPES[0]])
    line["cases"] = {f"c{c}": {f: out[c][f] for f in (
        "ms", "kernel_ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
        "bound_ms", "bound_by", "launch_floor", "host_us")} for c in SPLICE_SHAPES}
    return [line]


def splice_host_us(part, src, idx, valid, pairs, lib, stream, n: int = 300) -> dict:
    """The host microseconds of one K15 wrapper call and of its parts, each
    the mean of n calls on the host clock (the kernel enqueued each time,
    but for the checks and the resolver): the wrapper, its entry checks
    (_splice_entries), its resolver (splice_pairs), the counted launch
    through the package's launch helper (_launch) and the bare ctypes
    call."""
    import torch

    from pilosa_tpu_torch.ops import kernels as K

    s_l, rows, w = part.shape
    c = src.shape[0]
    args = (part.data_ptr(), src.data_ptr(), pairs.ctypes.data, pairs.shape[1], c, s_l,
            rows, w)
    parts = {
        "wrapper": lambda: K.splice_slabs(part, src, idx, valid),
        "entries": lambda: K._splice_entries("splice_slabs", part, src, idx, valid),
        "pairs": lambda: K.splice_pairs(idx, valid, s_l),
        "launch": lambda: K._launch("splice_slabs", part.device, lib.splice_slabs_launch,
                                    *args),
        "ctypes": lambda: lib.splice_slabs_launch(*args, stream),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return out


def phase_mesh_alone(root, cards: bool = False) -> int:
    """`chip_smoke.py --mesh`: the card line, bench.py's index with its BSI
    field v, phase_mesh and K15's checks; `--mesh-cards` the same with the
    parts on distinct cards."""
    import torch

    from pilosa_tpu_torch.core import Holder

    card_line = phase_card()
    phase_probe(card_line)
    holder = Holder(None).open()
    t0 = time.perf_counter()
    build_bench_index(holder)
    build_bsi_field(holder)
    log(f"mesh: index build seconds {time.perf_counter() - t0:.1f}")
    launches = phase_mesh(holder, root, cards)
    holder.close()
    lines = phase_splice_kernel(launches)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
    launches = query_launches()
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


def row_popcounts_work(s, n_rows, w, m):
    """(bytes, bit-products) of K8: the rows and masks read once, the
    counts written once; a popcount (32 bit-products) per row word and
    mask."""
    return ((s * n_rows * w + m * s * w + max(m, 1) * s * n_rows) * 4,
            32 * s * n_rows * w * max(m, 1))


def bsi_minmax_work(s, depth, w, filtered):
    """(bytes, bit-products) of K9: exists, sign, the planes and the
    filter read once, the table written once; each plane word tested once
    a branch."""
    return (((2 + depth + int(filtered)) * s * w + 2 * s * (depth + 2)) * 4,
            32 * s * w * depth * 2)


def bsi_compare_work(s, depth, w, walks):
    """(bytes, bit-products) of K10: exists, sign and the planes read once,
    the slab written once; a word's worth of bitwise work (32 bit-products)
    per plane word a walk."""
    return ((2 + depth) * s * w * 4 + s * w * 4, 32 * s * w * depth * walks)


def compare_conditions(depth):
    """K10's edge conditions: every op with both signs (and <=, >=), every
    between class, at predicates 0, all ones and bit depth - 1 alone."""
    from pilosa_tpu_torch.exec.cuda import _pred_bits

    values = sorted({0, (1 << depth) - 1, 1 << (depth - 1)})
    out = [(op, _pred_bits(v, depth), neg, eq, None) for v in values
           for op in ("==", "!=", "<", ">") for neg in (False, True)
           for eq in ((False, True) if op in "<>" else (False,))]
    for lo in values:
        for hi in values:
            if lo <= hi:
                out += [("pos", _pred_bits(lo, depth), False, False, _pred_bits(hi, depth)),
                        ("neg", _pred_bits(hi, depth), False, False, _pred_bits(lo, depth))]
            out.append(("mixed", _pred_bits(lo, depth), False, False, _pred_bits(hi, depth)))
    return out


def bsi_edge_stack(gen, dev, s, depth, w=32768):
    """A BSI stack [s, 2 + depth padded to 8, w] of random int32 words (bit
    31 set in half of them): shard 1 all negative and shard 2 empty."""
    import torch

    rows = -(-(2 + depth) // 8) * 8

    def rnd(*shape):
        return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    st = torch.zeros((s, rows, w), dtype=torch.int32, device=dev)
    exists = rnd(s, w)
    st[:, 0] = exists
    st[:, 1] = exists & rnd(s, w)
    for i in range(depth):
        st[:, 2 + i] = exists & rnd(s, w)
    st[1, 1] = st[1, 0]
    st[2] = 0
    return st


def phase_bsi_kernels(bsi, launches):
    """K8, K9 and K10 against their plain versions: at the served shapes
    (TopN over f, TopN over f filtered by Row(g=7), Sum's 14 planes with
    their two masks; the Min walk of v's 16-row stack; Row(v > 100) and
    v >< [-50, 50] over it), and at edge shapes, all exactly; with times and
    bounds. Returns the three kernels' lines."""
    import torch

    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.ops import probe

    f, src, vstack, pos, neg, depth = (bsi[k] for k in ("f", "src", "v", "pos", "neg", "depth"))
    dev = f.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)

    def rand(*shape):
        return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    # K8 edges: M = 0, 1, 2; row0 > 0; one row; a 36-word axis.
    for s, r, row0, n_rows, m, w in [(3, 8, 0, 8, 0, 32768), (2, 16, 3, 9, 1, 32768),
                                     (5, 16, 2, 14, 2, 32768), (1, 8, 7, 1, 2, 32768),
                                     (4, 24, 5, 11, 1, 36), (7, 8, 1, 6, 0, 36)]:
        st = rand(s, r, w)
        masks = tuple(rand(s, w) for _ in range(m))
        check(max_abs_err(K.row_popcounts(st, row0, n_rows, masks),
                          K.row_popcounts_torch(st, row0, n_rows, masks)) == 0,
              f"row_popcounts differs at S={s} R={r} rows {row0}+{n_rows} M={m} W={w}")
    log("kernels: row_popcounts exact at M = 0, 1, 2, row0 > 0, one row, 36-word axes")
    # K9 edges: depth 1, 14 and 63, an all-negative shard, an empty shard, a
    # filter that empties a shard, both kinds, filtered and not.
    for s, d in [(4, 1), (5, 14), (3, 63)]:
        st = bsi_edge_stack(gen, dev, s, d)
        filt = rand(s, 32768)
        filt[0] = 0
        for kind in ("min", "max"):
            for fl in (None, filt):
                check(max_abs_err(K.bsi_minmax(st, d, fl, kind),
                                  K.bsi_minmax_torch(st, d, fl, kind)) == 0,
                      f"bsi_minmax differs at S={s} depth={d} {kind} "
                      f"filtered={fl is not None}")
    log("kernels: bsi_minmax exact at depths 1, 14, 63 with an all-negative, an empty "
        "and a filtered-out shard, min and max, filtered and not")
    # K10 edges: every op, sign and between class at depths 1, 14 and 63,
    # predicates 0, all ones and bit depth - 1 alone, an all-negative and an
    # empty shard; and a 36-word axis.
    n_cond = 0
    for s, d, w in [(4, 1, 32768), (5, 14, 32768), (3, 63, 32768), (3, 14, 36)]:
        st = bsi_edge_stack(gen, dev, s, d, w)
        for cond in compare_conditions(d):
            check(max_abs_err(K.bsi_compare(st, d, *cond), K.bsi_compare_torch(st, d, *cond))
                  == 0, f"bsi_compare differs at S={s} depth={d} W={w}: (op, bits, neg, "
                  f"allow_eq, hi_bits) = {cond}")
            n_cond += 1
    log(f"kernels: bsi_compare exact on {n_cond} conditions: every op with both signs, "
        f"<= and >=, the between classes pos, neg and mixed, at depths 1, 14, 63 and a "
        f"36-word axis, predicates 0, all ones and bit depth - 1, with an all-negative and "
        f"an empty shard")

    lines = []
    s, r, w = f.shape
    cases = [("topn", f, 0, r, ()), ("src", f, 0, r, (src,)),
             ("sum", vstack, 2, depth, (pos, neg))]
    k8 = {}
    for label, st, row0, n_rows, masks in cases:
        err = max_abs_err(K.row_popcounts(st, row0, n_rows, masks),
                          K.row_popcounts_torch(st, row0, n_rows, masks))
        check(err == 0, f"row_popcounts differs on the {label} shape")
        k8[label] = {
            "shape": [st.shape[0], st.shape[1], row0, n_rows, len(masks), st.shape[2]],
            "ms": time_ms(lambda: K.row_popcounts(st, row0, n_rows, masks)),
            "kernel_ms": kernel_ms(bare_row_popcounts(st, row0, n_rows, masks)),
            "plain_ms": time_ms(lambda: K.row_popcounts_torch(st, row0, n_rows, masks),
                                reps=1, warm=0),
            "work": row_popcounts_work(st.shape[0], n_rows, st.shape[2], len(masks)),
            "max_abs_err": err,
        }
    main = k8["topn"]
    line = kernel_line("row_popcounts", main["ms"], main["kernel_ms"], main["plain_ms"],
                       main["work"], main["max_abs_err"], launches["row_popcounts"])
    for label in ("src", "sum"):
        b_ms, b_by, _ = kernel_bound(k8[label]["work"])
        line.update({f"{label}_shape": k8[label]["shape"], f"{label}_ms": k8[label]["ms"],
                     f"{label}_kernel_ms": k8[label]["kernel_ms"],
                     f"{label}_plain_ms": k8[label]["plain_ms"],
                     f"{label}_bound_ms": b_ms, f"{label}_bound_by": b_by,
                     f"{label}_max_abs_err": k8[label]["max_abs_err"]})
        log(f"kernels: row_popcounts {label} shape {k8[label]['shape']}: "
            f"{k8[label]['ms']:.4f} ms, kernel {k8[label]['kernel_ms']:.4f} ms, "
            f"plain {k8[label]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by}, exact")
    lines.append(line)

    sv = vstack.shape[0]
    err = max_abs_err(K.bsi_minmax(vstack, depth, None, "min"),
                      K.bsi_minmax_torch(vstack, depth, None, "min"))
    check(err == 0, "bsi_minmax differs on v's stack")
    ms = time_ms(lambda: K.bsi_minmax(vstack, depth, None, "min"))
    k_ms = kernel_ms(bare_bsi_minmax(vstack, depth, None, "min"))
    plain = time_ms(lambda: K.bsi_minmax_torch(vstack, depth, None, "min"), reps=1, warm=0)
    line = kernel_line("bsi_minmax", ms, k_ms, plain,
                       bsi_minmax_work(sv, depth, vstack.shape[2], False), err,
                       launches["bsi_minmax"])
    line["shape"] = [sv, vstack.shape[1], depth, vstack.shape[2]]
    lines.append(line)

    # K10 on v's stack: Row(v > 100), the served condition; also the mixed
    # between v >< [-50, 50], two walks in one pass.
    from pilosa_tpu_torch.exec.cuda import _pred_bits

    k10 = {}
    for label, cond in [("gt", (">", _pred_bits(100, depth), False, False, None)),
                        ("mixed", ("mixed", _pred_bits(50, depth), False, False,
                                   _pred_bits(50, depth)))]:
        err = max_abs_err(K.bsi_compare(vstack, depth, *cond),
                          K.bsi_compare_torch(vstack, depth, *cond))
        check(err == 0, f"bsi_compare differs on v's stack ({label})")
        k10[label] = {
            "ms": time_ms(lambda: K.bsi_compare(vstack, depth, *cond)),
            "kernel_ms": kernel_ms(bare_bsi_compare(vstack, depth, *cond)),
            "plain_ms": time_ms(lambda: K.bsi_compare_torch(vstack, depth, *cond), reps=3,
                                warm=1),
            "work": bsi_compare_work(sv, depth, vstack.shape[2], 2 if label == "mixed" else 1),
            "max_abs_err": err,
        }
    main = k10["gt"]
    line = kernel_line("bsi_compare", main["ms"], main["kernel_ms"], main["plain_ms"],
                       main["work"], main["max_abs_err"], launches["bsi_compare"])
    line["shape"] = [sv, vstack.shape[1], depth, vstack.shape[2]]
    b_ms, b_by, _ = kernel_bound(k10["mixed"]["work"])
    line.update({"mixed_ms": k10["mixed"]["ms"], "mixed_kernel_ms": k10["mixed"]["kernel_ms"],
                 "mixed_plain_ms": k10["mixed"]["plain_ms"], "mixed_bound_ms": b_ms,
                 "mixed_bound_by": b_by, "mixed_max_abs_err": k10["mixed"]["max_abs_err"]})
    lines.append(line)
    for ln in lines[1:]:
        log(f"kernels: {ln['name']} on v's stack: {ln['ms']:.4f} ms, kernel "
            f"{ln['kernel_ms']:.4f} ms, plain {ln['plain_ms']:.4f} ms, bound "
            f"{ln['bound_ms']:.4f} ms by {ln['bound_by']}, exact")
    log(f"kernels: bsi_compare mixed between on v's stack: {k10['mixed']['ms']:.4f} ms, "
        f"kernel {k10['mixed']['kernel_ms']:.4f} ms, plain {k10['mixed']['plain_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms by {b_by}, exact")
    return lines


def spec_work(leaves, rows, mode, n_ops):
    """(bytes, bit operations) of one K11 call: each distinct leaf row the
    slots read, once (two leaves that are one stack share its rows), and
    the output written once; one bit operation a bit of every binary op
    and of the popcount."""
    s, w = leaves[0].shape[0], leaves[0].shape[-1]
    distinct = {(id(leaves[i]), r) for slot in rows for i, r in enumerate(slot) if r >= 0}
    out = len(rows) * s * (1 if mode == "count" else w) * 4
    binary = sum(1 for op in n_ops if op >= 0x80)
    return len(distinct) * s * w * 4 + out, len(rows) * (binary + 1) * s * w * 32


def spec_ptxas_report() -> None:
    """K11's registers, spills and shared memory as ptxas reported them."""
    from pilosa_tpu_torch.ops import build

    section = build.build_log.split("== spec.cu", 1)
    if len(section) < 2:
        log("kernels: spec_eval ptxas report: not built in this process")
        return
    for line in section[1].split("\n== ", 1)[0].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("kernels: spec_eval ptxas:", line.strip())


def spec_forced(ops, leaves, rows, mode, body):
    """K11's output with every run of the split on ``body``."""
    import torch

    launch = bare_spec_eval(ops, leaves, rows, mode, body)
    launch()
    torch.cuda.synchronize()
    return launch.out


def spec_concurrent(shapes, threads: int = 8, rounds: int = 12) -> int:
    """K11 from several threads at once, each alternating the windows of
    ``shapes`` (ops, leaves, rows, mode, want): windows of different
    entry counts share a kernel, and every call must return exactly its
    plain answer. Returns the calls made."""
    import threading

    import torch

    from pilosa_tpu_torch.ops import kernels as K

    errors = []

    def worker(k):
        try:
            for j in range(rounds):
                ops, leaves, rows, mode, want = shapes[(k + j) % len(shapes)]
                got = K.spec_eval(ops, leaves, rows, mode)
                torch.cuda.current_stream().synchronize()
                if max_abs_err(got, want) != 0:
                    errors.append(f"thread {k} round {j}: differs")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"thread {k}: {e!r}")

    pool = [threading.Thread(target=worker, args=(k,)) for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    check(not errors, f"spec_eval from {threads} threads: {errors[:3]}")
    return threads * rounds


def phase_spec_kernels(gstacks, exists, launches):
    """K11 against its plain form on the card, exactly: at the served
    shapes (the single Count's two leaves, the 3-leaf Not over the
    existence stack, 3-row Counts over 8 and 64 distinct slots,
    Row(f=2)'s slab and a condition Count's one slab leaf), at window
    shapes (64 slots naming the same three rows, a window past
    MAX_SPEC_ENTRIES that spec_split cuts into launches, 8 slabs of a
    3-row Intersect, and the batcher's windows of trees that are not a
    3-row fold: 64 Nots over pairs, 8 rows each with a 3-view time range,
    64 5-row Unions), with their times and bounds, the one-slot shapes
    timed on both bodies, the multi-slot folds on the window body and its
    two variants (the program walk, the fold over a run-time leaf count),
    windows of 2 and 17 entries from 8 threads at once, and at edge shapes
    (S = 1, word axes off the block's tile, the full leaf table and stack,
    zero leaves, per-slot entries past the launch's parameters)."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import kernels as K

    spec_ptxas_report()
    f, g, h = gstacks["f"], gstacks["g"], gstacks["h"]
    # A 16-row stack beside f and g: 8 + 8 + 16 rows pass the entry cap.
    wide = torch.empty((f.shape[0], 16, f.shape[-1]), dtype=torch.int32,
                       device=f.device).random_()
    combos = [(a, b, c) for a in range(ROWS) for b in range(ROWS) for c in range(H_ROWS)]
    three = K.spec_program(("I", (("R", "f"), ("R", "g"), ("R", "h")))).ops
    q8 = [list(c) for c in combos[::32]]
    served = {
        "count": (K.spec_program(("I", (("R", "f"), ("R", "g")))).ops, (f, g), [[1, 2]],
                  "count"),
        "not3": (K.spec_program(("N", ("I", (("R", "f"), ("R", "g"))))).ops, (exists, f, g),
                 [[0, 1, 2]], "count"),
        "q8": (three, (f, g, h), q8, "count"),
        "q64": (three, (f, g, h), [list(c) for c in combos[::4]], "count"),
        "slab": ((0,), (f,), [[2]], "slab"),
        # A condition Count's K11: one slab leaf (K10's), count mode.
        "cond": ((0,), (f[:, 2].contiguous(),), [[0]], "count"),
        "q64same": (three, (f, g, h), [[1, 2, 0]] * 64, "count"),
        "split": (three, (f, g, wide), [[k % ROWS, (k // ROWS) % ROWS, k % 16]
                                        for k in range(64)], "count"),
        "slab8": (three, (f, g, h), q8, "slab"),
        "q64not": (K.spec_program(("N", ("I", (("R", "f"), ("R", "g"))))).ops, (exists, f, g),
                   [[0, a, b] for a in range(ROWS) for b in range(ROWS)], "count"),
        "q8time": (K.spec_program(("I", (("R", "f"), ("T", "t", 3)))).ops, (f, g, h, exists),
                   [[a, 1, 2, 0] for a in range(ROWS)], "count"),
        "q64u5": (K.spec_program(("U", tuple(("R", "f") for _ in range(5)))).ops,
                  (f, g, h, exists, f),
                  [[a, b, 0, 0, (a + b) % ROWS] for a in range(ROWS) for b in range(ROWS)],
                  "count"),
    }
    out = {}
    for label, (ops, leaves, rows, mode) in served.items():
        spans = K.spec_split(leaves, rows)
        before = query_launches()["spec_eval"]
        got = K.spec_eval(ops, leaves, rows, mode)
        calls = query_launches()["spec_eval"] - before
        check(calls == len(spans), f"spec_eval {label}: {calls} launches, the split "
              f"reports {len(spans)}")
        check(label == "split" or calls == 1, f"spec_eval {label}: {calls} launches")
        err = max_abs_err(got, K.spec_eval_torch(ops, leaves, rows, mode))
        check(err == 0, f"spec_eval differs at the served shape {label}")
        del got
        ms = time_ms(lambda: K.spec_eval(ops, leaves, rows, mode))
        k_ms = kernel_ms(bare_spec_eval(ops, leaves, rows, mode))
        plain_ms = time_ms(lambda: K.spec_eval_torch(ops, leaves, rows, mode), reps=1, warm=0)
        bound, by, route = kernel_bound(spec_work(leaves, rows, mode, ops))
        entries = len(K.spec_window(leaves, rows)[0])
        out[label] = {"slots": len(rows), "leaves": len(leaves), "entries": entries,
                      "launches": calls, "mode": mode, "ms": ms, "kernel_ms": k_ms,
                      "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                      "max_abs_err": err}
        extra = ""
        if len(rows) == 1:  # both bodies, in turns
            for body, name in ((K.SPEC_BODY_SLOT, "slot"), (K.SPEC_BODY_WINDOW, "window"),
                               (K.SPEC_BODY_WINDOW, "window"), (K.SPEC_BODY_SLOT, "slot")):
                t = kernel_ms(bare_spec_eval(ops, leaves, rows, mode, body))
                out[label].setdefault(f"kernel_ms_{name}_body", []).append(t)
            extra = (f", per-slot body {out[label]['kernel_ms_slot_body']}, window body "
                     f"{out[label]['kernel_ms_window_body']}")
            check(max_abs_err(spec_forced(ops, leaves, rows, mode, K.SPEC_BODY_WINDOW),
                              K.spec_eval_torch(ops, leaves, rows, mode)) == 0,
                  f"spec_eval's window body differs at {label}")
        elif K.spec_is_fold(tuple(ops)):  # the window body and its variants, in turns
            variants = ((K.SPEC_BODY_WINDOW, "window"), (K.SPEC_BODY_FOLD_N, "fold_n"),
                        (K.SPEC_BODY_WALK, "walk"))
            for body, name in variants + variants[::-1]:
                t = kernel_ms(bare_spec_eval(ops, leaves, rows, mode, body))
                out[label].setdefault(f"kernel_ms_{name}_body", []).append(t)
            want = K.spec_eval_torch(ops, leaves, rows, mode)
            for body, name in variants[1:]:
                check(max_abs_err(spec_forced(ops, leaves, rows, mode, body), want) == 0,
                      f"spec_eval's {name} body differs at {label}")
            del want
            extra = "".join(f", {name} body {out[label][f'kernel_ms_{name}_body']}"
                            for _, name in variants)
        log(f"kernels: spec_eval {label} ({len(rows)} slots, {len(leaves)} leaves, "
            f"{entries} entries, {calls} launches, {mode}): {ms:.4f} ms, kernel "
            f"{k_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms by {by}, "
            f"exact{extra}")
    del wide
    mixed = [(ops, leaves, rows, mode, K.spec_eval_torch(ops, leaves, rows, mode))
             for ops, leaves, rows, mode in (served["count"], served["q64"])]
    calls = spec_concurrent(mixed)
    del mixed
    log(f"kernels: spec_eval exact over {calls} calls from 8 threads, windows of 2 and 17 "
        f"entries interleaved")
    dev = f.device
    rng = np.random.default_rng(11)

    def words(*shape):
        x = rng.integers(0, 2**32, shape, dtype=np.uint32)
        return torch.from_numpy(x.view(np.int32)).to(dev)

    ops_cycle = (K.SPEC_AND, K.SPEC_OR, K.SPEC_ANDNOT, K.SPEC_XOR)
    n_edge = 0
    for s, w, n_leaves, q in [(1, 32768, 2, 1), (3, 36, 3, 5), (2, 100, K.MAX_SPEC_DEPTH, 3),
                              (2, 32768, K.MAX_SPEC_LEAVES, 20), (1, 32768, 1, 600),
                              (4, 1028, 5, 64)]:
        leaves = [words(s, w) if i % 3 == 2 else words(s, 8 if i % 3 == 0 else 16, w)
                  for i in range(n_leaves)]
        ops, depth = [], 0
        for i in range(n_leaves):  # the deepest stack first, then every op
            ops.append(i)
            depth += 1
            if depth == K.MAX_SPEC_DEPTH or (i >= K.MAX_SPEC_DEPTH and depth > 1):
                ops.append(ops_cycle[len(ops) % 4])
                depth -= 1
        while depth > 1:
            ops.append(ops_cycle[len(ops) % 4])
            depth -= 1
        rows = [[-1 if rng.random() < 0.2 else
                 int(rng.integers(0, t.shape[1] if t.dim() == 3 else 1)) for t in leaves]
                for _ in range(q)]
        for mode in ("count", "slab"):
            want = K.spec_eval_torch(ops, leaves, rows, mode)
            err = max([max_abs_err(K.spec_eval(ops, leaves, rows, mode), want)]
                      + [max_abs_err(spec_forced(ops, leaves, rows, mode, body), want)
                         for body in (K.SPEC_BODY_SLOT, K.SPEC_BODY_WINDOW, K.SPEC_BODY_WALK,
                                      K.SPEC_BODY_FOLD_N)])
            check(err == 0, f"spec_eval differs at S={s} W={w} leaves={n_leaves} Q={q} {mode}")
            n_edge += 1
    torch.cuda.synchronize()
    log(f"kernels: spec_eval exact at {n_edge} edge shapes and modes, on both bodies and the "
        f"window body's two variants")
    main = out.pop("count")
    line = kernel_line("spec_eval", main["ms"], main["kernel_ms"], main["plain_ms"],
                       spec_work((f, g), [[1, 2]], "count", served["count"][0]),
                       main["max_abs_err"], launches["spec_eval"])
    line["served_shapes"] = out
    return [line]


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

    # A [954, 32768] slab, the shape of Sum's considered columns (and of the
    # count program's slab, which K11 now popcounts itself).
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


# The host rows' phase: shards of each random slab set.
HOST_ROW_SHARDS = 32


def phase_host_rows():
    """The host rows of the tables (pilosa_tpu_torch/exec/cuda.py) against
    the card's, exactly: a row the host derives for a write epoch sits next
    to rows the card swept. Two random slab sets at the bench index's stack
    height (8 rows), HOST_ROW_SHARDS shards each, bit densities 1/16 (four
    random words ANDed) and 1/2: every shard's _host_slab_pair_flat against
    its row of K1 (pair_stats_pershard), _host_slab_row_counts against K8
    (row_popcounts) and _host_slab_groupn over (f, g, h) against K7
    (nary_stats_pershard) and K5 (group_tile_stats_pershard over every
    combination). Then the Min/Max table's host re-derive
    (Fragment.min/max) against K9's per-shard rows (bsi_minmax, through
    the backend's cold Min and Max) on HOST_ROW_SHARDS shards of a BSI
    field, at bench.py's BSI_COLS values a shard and at 1/16 of the
    columns, with an all-negative and an empty shard."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.exec import cuda as C
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.ops.blocks import WORDS_PER_SHARD

    gen = torch.Generator(device="cuda").manual_seed(12)
    shape = (HOST_ROW_SHARDS, 8, WORDS_PER_SHARD)

    def words(n_and):
        out = None
        for _ in range(n_and):
            w = torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                              device="cuda", generator=gen)
            out = w if out is None else out & w
        return out

    for label, n_and in (("1/16", 4), ("1/2", 1)):
        f, g, h = words(n_and), words(n_and), words(n_and)
        card_pair = K.pair_stats_pershard(f, g).cpu().numpy()
        card_rows = K.row_popcounts(f, 0, 8)[0].cpu().numpy().astype(np.int64)
        # [K, S, rf, rg] -> the table's rows [S, K * rf * rg].
        k7 = K.nary_stats_pershard(f, g, (h,)).cpu().numpy()
        combos = np.arange(8, dtype=np.int32)[:, None]
        k5 = K.group_tile_stats_pershard(f, g, (h,), combos, np.ones(8, np.int32))
        k5 = k5.cpu().numpy()
        fh, gh, hh = (x.cpu().numpy().view(np.uint32) for x in (f, g, h))
        host_pair = np.stack([C._host_slab_pair_flat(fh[i], gh[i]) for i in range(shape[0])])
        host_rows = np.stack([C._host_slab_row_counts(fh[i]) for i in range(shape[0])])
        host_groupn = np.stack([C._host_slab_groupn([fh[i], gh[i], hh[i]], [8, 8, 8])
                                for i in range(shape[0])])
        check(np.array_equal(host_pair, card_pair),
              f"host rows: _host_slab_pair_flat disagrees with K1 at density {label}")
        check(np.array_equal(host_rows, card_rows),
              f"host rows: _host_slab_row_counts disagrees with K8 at density {label}")
        for name, card in (("K7", k7), ("K5", k5)):
            check(np.array_equal(host_groupn, card.transpose(1, 0, 2, 3).reshape(shape[0], -1)),
                  f"host rows: _host_slab_groupn disagrees with {name} at density {label}")
        log(f"host rows: density {label}, {shape[0]} shards x 8 rows: K1's "
            f"{card_pair.shape}, K8's {card_rows.shape}, K7's and K5's {k7.shape} rows "
            "equal the host's")
    host_rows_minmax()


def host_rows_minmax():
    """Fragment.min/max, the Min/Max table's host re-derive, against K9's
    per-shard rows as the backend keeps them after a cold Min and Max
    ((value + base, count), (0, 0) for a shard with no value), on
    HOST_ROW_SHARDS shards of a BSI field of bench.py's value range: the
    last shard empty, the one before it all negative."""
    import numpy as np

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.field import options_for_int
    from pilosa_tpu_torch.exec.cuda import CUDABackend
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    for label, per_shard in (("BSI_COLS", BSI_COLS), ("1/16", SHARD_WIDTH // 16)):
        holder = Holder(None).open()
        fld = holder.create_index("bench").create_field(
            "v", options_for_int(-BSI_RANGE, BSI_RANGE))
        rng = np.random.default_rng(44)
        for shard in range(HOST_ROW_SHARDS - 1):
            cols = (np.unique(rng.integers(0, SHARD_WIDTH, per_shard, dtype=np.uint64))
                    + np.uint64(shard * SHARD_WIDTH))
            hi = -1 if shard == HOST_ROW_SHARDS - 2 else BSI_ABS
            fld.import_value(cols, rng.integers(-BSI_ABS, hi + 1, cols.size))
        backend = CUDABackend(holder)
        shards = list(range(HOST_ROW_SHARDS))
        base, depth = fld.bsi_group().base, fld.bsi_group().bit_depth
        for kind in ("bsi_min", "bsi_max"):
            getattr(backend, kind)("bench", "v", shards)
            card = backend._agg_cache[(kind, "bench", "v")][2][0]
            host = []
            for shard in shards:
                frag = fld._bsi_fragment(shard)
                raw = (0, 0) if frag is None else (
                    frag.min(None, depth) if kind == "bsi_min" else frag.max(None, depth))
                host.append((raw[0] + base, raw[1]) if raw[1] else (0, 0))
            check(list(card) == host,
                  f"host rows: Fragment.{kind[4:]} disagrees with K9 at {label} values a shard")
        log(f"host rows: {label} values a shard, {HOST_ROW_SHARDS} shards: Fragment.min/max "
            "equal K9's per-shard rows")
        holder.close()


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
    # The YMDH time field t (tests/test_tpu.py test_time_range_on_device).
    "Row(t=9, from='2019-08-01T00:00', to='2019-08-31T00:00')",
    "Count(Row(t=9, from='2019-08-04T00:00', to='2019-08-31T00:00'))",
    "Row(t=9, from='2019-08-03T10:00', to='2019-08-03T11:00')",
]
TIME_SETS = ["Set(3, t=9, 2019-08-03T10:00)", "Set(1048579, t=9, 2019-08-05T12:00)",
             "Set(3145730, t=9, 2019-08-20T01:00)"]


def phase_small():
    import numpy as np

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.field import options_for_time
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
    idx.create_field("t", options_for_time("YMDH"))

    dev = Executor(holder, backend=CUDABackend(holder))
    oracle = Executor(holder, backend=CPUBackend(holder))
    for q in TIME_SETS:
        oracle.execute("i", q)
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
    ap.add_argument("--http-load", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--churn", action="store_true",
                    help="run only the churn windows (the pair request, TopN(f) and the "
                         "3-field GroupBy; Sum, Min and Max of v; under write epochs) on "
                         "the --root checkout's package")
    ap.add_argument("--miss", action="store_true",
                    help="run only the cache-missing window (miss_window) on the --root "
                         "checkout's package")
    ap.add_argument("--budget", action="store_true",
                    help="run only the row-paging phase (phase_budget, with bench.py's "
                         "index and BSI field v built) and the CLI's servers (phase_cli)")
    ap.add_argument("--cold", action="store_true",
                    help="run only the cold-build phase (phase_cold_build, with bench.py's "
                         "index and BSI field v built, r and s) and the expansion "
                         "kernels' checks (phase_expand_kernels) on the --root "
                         "checkout's package")
    ap.add_argument("--host-count", action="store_true",
                    help="run only the single Count's host time (phase_host_count) on "
                         "the --root checkout's package")
    ap.add_argument("--rounds", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--host-count-ab", metavar="PARENT",
                    help="compare the single Count's host time of PARENT's package and "
                         "the --root checkout's in alternating rounds (host_count_ab)")
    ap.add_argument("--cluster", action="store_true",
                    help="run only the cluster phase (phase_cluster: two `cli server` "
                         "nodes sharing the card) on the --root checkout's package")
    ap.add_argument("--mesh", action="store_true",
                    help="run only the card line, the shard-mesh phase (phase_mesh: "
                         "bench.py's index with v on meshes of 2 and 4 parts of the "
                         "card) and K15's checks on the --root checkout's package")
    ap.add_argument("--epochs", action="store_true",
                    help="run only the card line and the epoch absorption (phase_epochs: "
                         "f's stack unmeshed and on meshes of 2 and 4 parts of the card) "
                         "on the --root checkout's package")
    ap.add_argument("--mesh-cards", action="store_true",
                    help="--mesh with each mesh's parts on distinct cards (a machine "
                         "with 4 cards runs meshes of 2 and 4 cards)")
    ap.add_argument("--trace", action="store_true",
                    help="run only the card line, the device trace phase (phase_trace) "
                         "and a meshed backend's trace (trace_mesh) on the --root "
                         "checkout's package")
    ap.add_argument("--cluster-shards", type=int, default=CLUSTER_SHARDS, metavar="N",
                    help=f"shards of the cluster phase's index (default {CLUSTER_SHARDS})")
    ap.add_argument("--pairs", type=int, default=10,
                    help="rounds of each package in --host-count-ab (default 10)")
    args = ap.parse_args(argv)
    if args.http_load:  # a throughput window's clients (phase_http)
        with open(args.http_load) as f:
            print(json.dumps(http_load(json.load(f))), flush=True)
        return 0
    root = os.path.abspath(args.root)
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
    if args.churn or args.miss:
        return phase_window(root, "churn" if args.churn else "miss")
    if args.budget:
        return phase_budget_alone(root)
    if args.cold:
        return phase_cold_alone(root)
    if args.cluster:
        return phase_cluster_alone(root, args.cluster_shards)
    if args.mesh or args.mesh_cards:
        return phase_mesh_alone(root, args.mesh_cards)
    if args.epochs:
        return phase_epochs_alone(root)
    if args.trace:
        return phase_trace_alone(root)
    if args.host_count:
        return phase_host_count(root, args.rounds)
    if args.host_count_ab:
        return host_count_ab(os.path.abspath(args.host_count_ab), root, args.pairs)

    card_line = phase_card()
    phase_probe(card_line)
    log("reduced: none (954 shards, full size)")
    results: dict = {}
    holder, backend, wide_stacks = phase_main(results)
    group_launches, gstacks, served = phase_groupby(holder, backend)
    bsi_launches, bsi_stacks = phase_bsi(holder, backend)
    phase_ledger(backend)
    phase_budget(holder, backend)
    from pilosa_tpu_torch.utils.stats import global_stats

    rebuilds = sum(global_stats.counter_totals("stack_full_rebuilds_total").values())
    phase_http(holder, backend, root)
    phase_trace(holder, backend)
    phase_stacks_exact(holder, backend, gstacks, rebuilds)
    groupby_oracle_check(holder, backend)
    bsi_oracle_check(holder, backend)
    phase_preheat(holder)
    cold_launches, capture = phase_cold_build(holder)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches = phase_mesh(holder, root, n_runs=MESH_RUNS_WHOLE)
    holder.close()
    del backend
    phase_groupby_tiles()
    phase_cluster(root, CLUSTER_SHARDS_WHOLE)
    launches = dict(results["launches"])
    for name in ("group_tile_stats", "group_tile_stats_pershard"):
        launches[name] = group_launches[name]
    cross = cross_check(gstacks, served)
    for name in ("nary_stats", "nary_stats_pershard"):
        launches[name] = cross[name]
    for name in ("row_popcounts", "bsi_minmax", "bsi_compare"):
        launches[name] = bsi_launches[name]
    # K3 left the Count path for K11; GroupBy's live-row counts launch it.
    launches["popcount_rows"] = group_launches["popcount_rows"]
    lines = phase_kernels(gstacks, wide_stacks, launches)
    lines += phase_bsi_kernels(bsi_stacks, launches)
    lines += phase_spec_kernels(gstacks, results.pop("exists"), launches)
    lines += phase_expand_kernels(capture, cold_launches)
    lines += phase_splice_kernel(mesh_launches)
    del capture
    del gstacks, wide_stacks, bsi_stacks
    phase_host_rows()
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
