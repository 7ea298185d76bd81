"""Builds and loads the hand-written CUDA kernels (ops/csrc/*.cu).

Each source is compiled at first use with nvcc for Hopper (sm_90a) into a
shared library of its own with a plain C interface, which ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o ops/build/lib<name>.so ops/csrc/<name>.cu

The sources that need a build are compiled together, one nvcc process for
each, all started at once. ``-Xptxas -v`` makes ptxas report each kernel's
registers, shared memory and spills; the report of the last build is kept
in ``build_log``.

A library is rebuilt when its source's digest differs from the one
recorded beside it. A missing nvcc or a failed compile raises with the
compiler's output: nothing on the device path falls back to another form.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")
#: Kernel sources by library name: bmma.cu (the pair kernels K1, K2, the
#: group tiles K4, K5 and the odometer group tensor K6, K7 on the tensor
#: cores' binary MMA, and the AND-popcount rate probe) and bitcount.cu (K3,
#: the count path's popcount-reduce, on the CUDA cores).
SOURCES = {
    name: os.path.join(_HERE, "csrc", f"{name}.cu")
    for name in ("bitcount", "bmma")
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
#: Wall seconds the last build in this process took (0.0 when every library
#: was already built for its source); None until the libraries are loaded.
build_seconds = None
#: nvcc's output (the ptxas resource reports) of the last build, "" when
#: every library was already built for its source.
build_log = ""


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)"
    )


def _library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _source_digest(name: str) -> str:
    with open(SOURCES[name], "rb") as fh:
        return hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()


def _fresh(name: str, digest: str) -> bool:
    try:
        with open(_library_path(name) + ".sha256") as fh:
            return fh.read().strip() == digest and os.path.exists(_library_path(name))
    except FileNotFoundError:
        return False


def _compile(stale: dict) -> str:
    """Compile every stale source at once, one nvcc each; returns their
    output. stale: name -> source digest."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    try:
        for name in stale:
            tmp = f"{_library_path(name)}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
            procs[name] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outputs = {name: p.communicate()[0] for name, (_, _, p) in procs.items()}
    finally:
        for _, _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, (cmd, tmp, p) in procs.items():
        if p.returncode != 0:
            raise KernelBuildError(
                f"{' '.join(cmd)} failed ({p.returncode}):\n{outputs[name]}"
            )
    for name, (_, tmp, _) in procs.items():
        os.replace(tmp, _library_path(name))
        with open(_library_path(name) + ".sha256", "w") as fh:
            fh.write(stale[name])
    return "".join(f"== {name}.cu\n{out}" for name, out in outputs.items())


def _bind(name: str, lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # f, g, out, s, rf, rg, w, stream
    pair = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    # f, g, extra pointers, extra heights, n_extra, rows_idx, active, filt,
    # out, s, rf, rg, w, n_slots, stream
    group = [ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    signatures = {
        # x, out, n, w, stream
        "bitcount": {"popcount_rows_launch": [ptr, ptr, i32, i32, ptr]},
        "bmma": {"pair_stats_pershard_launch": pair, "pair_stats_launch": pair,
                 "group_tile_stats_launch": group,
                 "group_tile_stats_pershard_launch": group,
                 "nary_stats_launch": group, "nary_stats_pershard_launch": group,
                 # mode, iters, out, blocks, stream
                 "and_popc_probe_launch": [i32, i32, ptr, i32, ptr]},
    }
    for fn_name, argtypes in signatures[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = i32


def library(name: str):
    """The loaded kernel library ``name`` ("bitcount" or "bmma"). The
    first call builds every library whose source changed."""
    global build_seconds, build_log
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if not _libs:
            digests = {n: _source_digest(n) for n in SOURCES}
            stale = {n: d for n, d in digests.items() if not _fresh(n, d)}
            t0 = time.perf_counter()
            log = _compile(stale) if stale else ""
            built = time.perf_counter() - t0 if stale else 0.0
            for n in SOURCES:
                loaded = ctypes.CDLL(_library_path(n))
                _bind(n, loaded)
                _libs[n] = loaded
            build_seconds, build_log = built, log
    return _libs[name]
