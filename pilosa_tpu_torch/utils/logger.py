"""Logger seam (reference logger/logger.go: Logger iface, std/verbose/nop)."""

from __future__ import annotations

import sys
import time


class Logger:
    def printf(self, fmt: str, *args) -> None:
        raise NotImplementedError

    def debugf(self, fmt: str, *args) -> None:
        raise NotImplementedError


class StandardLogger(Logger):
    def __init__(self, stream=None, verbose: bool = False):
        self.stream = stream or sys.stderr
        self.verbose = verbose

    def _write(self, fmt: str, args) -> None:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        msg = fmt % args if args else fmt
        self.stream.write(f"{ts} {msg}\n")
        self.stream.flush()

    def printf(self, fmt: str, *args) -> None:
        self._write(fmt, args)

    def debugf(self, fmt: str, *args) -> None:
        if self.verbose:
            self._write(fmt, args)


class NopLogger(Logger):
    def printf(self, fmt: str, *args) -> None:
        pass

    def debugf(self, fmt: str, *args) -> None:
        pass
