"""The card's AND-popcount rates, measured (ops/csrc/bmma.cu, the probe).

One block per SM runs a register-only loop of one instruction kind:

- ``b1``: ``mma.sync.m16n8k256.b1.and.popc`` on the tensor cores, 16 * 8 *
  256 bit-products an instruction;
- ``popc``: ``__popc(a & b)`` on the CUDA cores, 32 bit-products each.

``and_popc_rates()`` times each with CUDA events and returns bit-products
a second. It needs a CUDA card. ``noop()`` launches a kernel that does
nothing: the launch floor beside a kernel's time; ``splice_floor()`` the
same at K15's grid.

The bound of a pair or group kernel is the least time the card could take
for its work: the larger of its bytes (each input read once, each output
written once) over the memory rate, and its bit-products (pairs x words x
32, plus the row popcounts) over the fastest AND-popcount route
(``bound``). The routes are the CUDA cores' popcount (32 bit-products a
popcount at the issue rate), the int8 tensor cores on bits unpacked to 0/1
bytes (one multiply-add a bit-product, the published rate), and the
measured ``b1`` MMA.
"""

from __future__ import annotations

import torch

#: Published H100 SXM memory rate (NVIDIA data sheet), bytes a second.
HBM_BYTES_PER_S = 3.35e12
#: The int8 tensor route: half of the published 1,979 dense int8 TOPS, as
#: multiply-adds (one per bit-product on 0/1 bytes) a second.
INT8_MACS_PER_S = 9.9e14

PROBE_THREADS = 512
PROBE_CHAINS = 4
MODES = {"b1": 0, "popc": 1}
#: Work one thread-iteration of each mode does.
_WORK = {
    "b1": PROBE_CHAINS * 16 * 8 * 256 / 32,  # per lane: a warp's MMAs / 32
    "popc": 8 * 32,
}


def _run(lib, mode: str, iters: int, out: torch.Tensor, blocks: int) -> float:
    """Device ms of one probe launch of ``iters`` iterations."""
    stream = torch.cuda.current_stream(out.device).cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rc = lib.and_popc_probe_launch(MODES[mode], iters, out.data_ptr(), blocks, stream)
    end.record()
    if rc != 0:
        raise RuntimeError(f"and_popc_probe: CUDA launch failed with cudaError {rc}")
    end.synchronize()
    return start.elapsed_time(end)


def and_popc_rates(device="cuda", target_ms: float = 50.0) -> dict:
    """{mode: work a second} for each probe mode; each launch is grown
    until it takes at least ``target_ms`` on the card, then timed three
    times and the fastest taken."""
    from pilosa_tpu_torch.ops.build import library

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("and_popc_rates: the probe measures a CUDA card")
    lib = library("bmma")
    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.empty(blocks * PROBE_THREADS, dtype=torch.int32, device=device)
    rates = {}
    for mode in MODES:
        iters = 1024
        _run(lib, mode, iters, out, blocks)  # warm: loads the module
        while True:
            ms = _run(lib, mode, iters, out, blocks)
            if ms >= target_ms or iters >= 1 << 28:
                break
            iters = min(1 << 28, int(iters * max(2.0, 1.2 * target_ms / max(ms, 1e-3))))
        ms = min(_run(lib, mode, iters, out, blocks) for _ in range(3))
        work = blocks * PROBE_THREADS * iters * _WORK[mode]
        rates[mode] = work / (ms / 1e3)
    return rates


def noop(device="cuda", blocks: int = 1, stream=None):
    """One launch of the kernel that does nothing (``noop_launch`` in
    bmma.cu), as a callable that enqueues it on ``stream`` (a CUDA stream
    handle), or on the device's current stream at each call when None (as
    a CUDA graph's capture needs): timed like a kernel's bare launches, it
    is the launch floor under which no kernel's time can fall. It needs a
    CUDA card."""
    return _floor("noop", device, stream, "bmma", blocks)


def splice_floor(n: int, rows: int, w: int, device="cuda", stream=None):
    """The launch floor at K15's grid: a callable as noop's that enqueues
    splice.cu's kernel that does nothing, with the grid and block that
    splice_slabs gives n live slabs of rows x w words."""
    return _floor("splice_floor", device, stream, "splice", n, rows, w)


def _floor(name, device, stream, lib_name, *args):
    """A callable that enqueues ``<name>_launch`` of library lib_name with
    args and the stream."""
    from pilosa_tpu_torch.ops.build import library

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{name}: the launch floor is a CUDA card's")
    fn = getattr(library(lib_name), name + "_launch")

    def launch():
        rc = fn(*args, stream if stream is not None
                else torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")

    return launch


def pair_work(s: int, rf: int, rg: int, w: int, pershard: bool) -> tuple:
    """(bytes, bit-products) of a pair sweep: F and G read once, the table
    written once; Rf * Rg pairs and Rf + Rg row popcounts a word, 32
    bit-products each."""
    cells = rf * rg + rf + rg
    nbytes = 4 * s * (rf + rg) * w + 4 * (s if pershard else 1) * cells
    return nbytes, 32 * s * w * cells


def group_work(s: int, rf: int, rg: int, w: int, slots: int, extra_rows: int,
               filtered: bool, pershard: bool) -> tuple:
    """(bytes, bit-products) of a group sweep: F, G, the ``extra_rows``
    rows the slots read and the filter slab read once, the output written
    once; Rf * Rg pairs a slot and word, 32 bit-products each."""
    nbytes = (4 * s * w * (rf + rg + extra_rows + int(filtered))
              + 4 * slots * (s if pershard else 1) * rf * rg)
    return nbytes, 32 * slots * s * w * rf * rg


def routes(popc_per_s: float, b1_per_s: float) -> dict:
    """Bit-products a second of each AND-popcount route: the CUDA cores at
    ``popc_per_s`` popcounts a second, the int8 tensor cores' published
    rate, and the ``b1`` MMA at its measured rate."""
    return {"popc": 32.0 * popc_per_s, "s8": INT8_MACS_PER_S, "b1": b1_per_s}


def bound(nbytes: int, bits: int, rates: dict) -> tuple:
    """(seconds, "bytes" or "operations", route) of the least time for
    ``nbytes`` moved and ``bits`` bit-products at the fastest route of
    ``rates``."""
    route = max(rates, key=rates.get)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = bits / rates[route]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", route
