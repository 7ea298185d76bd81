"""mmap/file-handle budget (reference syswrap/mmap.go:37, syswrap/os.go:30).

The reference guards the process against exhausting vm.max_map_count and
open-file limits: mmap falls back to a plain read once the map budget is
exceeded. Fragments read their storage through read_buffer(), which mmaps
when the budget allows (no transient whole-file copy on open — the r1
weak-#8 fix) and falls back to a read() otherwise.
"""

from __future__ import annotations

import mmap
import os
import threading
from contextlib import contextmanager

DEFAULT_MAX_MAP_COUNT = 32768  # reference server/config.go max-map-count default
DEFAULT_MAX_FILE_COUNT = 262144  # reference holder.go:43

_lock = threading.Lock()
_map_count = 0
_max_map_count = DEFAULT_MAX_MAP_COUNT
_mmap_fallbacks = 0

# File-handle budget (reference syswrap/os.go:30-60: close files over
# maxFileCount). Long-lived handles — fragment WAL appenders — register
# here; when the budget is exceeded the least-recently-used holders
# (by lock-free use stamps) are asked to release() their fds (they
# reopen lazily on the next write).
import itertools

_files_lock = threading.Lock()
_files: dict[int, object] = {}
_max_file_count = DEFAULT_MAX_FILE_COUNT
_file_evictions = 0
_use_counter = itertools.count(1)


def set_max_map_count(n: int) -> None:
    global _max_map_count
    _max_map_count = n


def set_max_file_count(n: int) -> None:
    global _max_file_count
    _max_file_count = n


def file_opened(holder) -> None:
    """Register a budgeted handle holder (must expose release() and a
    budget_stamp attribute)."""
    global _file_evictions
    holder.budget_stamp = next(_use_counter)
    victims = []
    with _files_lock:
        _files[id(holder)] = holder
        if len(_files) > _max_file_count:
            over = len(_files) - _max_file_count
            for v in sorted(_files.values(), key=lambda h: h.budget_stamp)[:over]:
                _files.pop(id(v), None)
                victims.append(v)
                _file_evictions += 1
    # release() takes the holder's own lock: call OUTSIDE _files_lock so
    # a concurrent write's acquire (holder lock -> _files_lock) can't
    # deadlock against this eviction (the opposite order).
    for v in victims:
        v.release()


def file_touched(holder) -> None:
    """Lock-free LRU stamp: per-append bookkeeping must not funnel every
    fragment mutation through one global lock; ordering is derived
    lazily at eviction time."""
    holder.budget_stamp = next(_use_counter)


def file_closed(holder) -> None:
    with _files_lock:
        _files.pop(id(holder), None)


def stats() -> dict:
    with _lock:
        out = {"maps": _map_count, "fallbacks": _mmap_fallbacks}
    with _files_lock:
        out["open_files"] = len(_files)
        out["file_evictions"] = _file_evictions
    return out


@contextmanager
def read_buffer(path: str):
    """Yield a read-only buffer of the file: an mmap when the budget
    allows, else bytes. The buffer is only valid inside the context."""
    global _map_count, _mmap_fallbacks
    size = os.path.getsize(path) if os.path.exists(path) else 0
    if size == 0:
        yield b""
        return
    use_mmap = False
    with _lock:
        if _map_count < _max_map_count:
            _map_count += 1
            use_mmap = True
        else:
            _mmap_fallbacks += 1
    if not use_mmap:
        with open(path, "rb") as f:
            yield f.read()
        return
    try:
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            yield mm
        finally:
            try:
                mm.close()
            except BufferError:
                # An error path (e.g. a corrupt-fragment refusal) can
                # leave numpy views of the map alive in the in-flight
                # exception's traceback frames; closing would replace
                # the structured error with a BufferError. The map
                # closes when those views are collected.
                pass
    finally:
        with _lock:
            _map_count -= 1
