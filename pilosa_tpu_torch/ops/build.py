"""Builds and loads the hand-written CUDA kernels (ops/csrc/bitcount.cu).

The source is compiled at first use with nvcc for Hopper (sm_90a) into a
shared library with a plain C interface, which ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o ops/build/libbitcount.so ops/csrc/bitcount.cu

``-Xptxas -v`` makes ptxas report each kernel's registers, shared memory
and spills; the report of the last build is kept in ``build_log``.

The library is rebuilt when the source's digest differs from the one
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
SOURCE = os.path.join(_HERE, "csrc", "bitcount.cu")
BUILD_DIR = os.path.join(_HERE, "build")
LIBRARY = os.path.join(BUILD_DIR, "libbitcount.so")
_DIGEST = LIBRARY + ".sha256"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
#: Seconds the last build in this process took (0.0 when the library was
#: already built for this source); None until the library is loaded.
build_seconds = None
#: nvcc's output (the ptxas resource report) of the last build, "" when
#: the library was already built for this source.
build_log = ""


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the kernel source."""


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


def _source_digest() -> str:
    with open(SOURCE, "rb") as fh:
        return hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()


def _compile(digest: str) -> tuple[float, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIBRARY)
    with open(_DIGEST, "w") as fh:
        fh.write(digest)
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def _bind(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("pair_stats_pershard_launch", "pair_stats_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        fn.restype = i32
    lib.popcount_rows_launch.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.popcount_rows_launch.restype = i32


def library():
    """The loaded kernel library, built first if the source changed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            digest = _source_digest()
            built, log = 0.0, ""
            try:
                with open(_DIGEST) as fh:
                    fresh = fh.read().strip() == digest and os.path.exists(LIBRARY)
            except FileNotFoundError:
                fresh = False
            if not fresh:
                built, log = _compile(digest)
            lib = ctypes.CDLL(LIBRARY)
            _bind(lib)
            build_seconds, build_log = built, log
            _lib = lib
    return _lib
