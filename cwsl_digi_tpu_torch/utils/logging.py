"""Leveled async logger with the reference's levels and prefixes.

Reference parity: source/ScreenPrinter.hpp:37-222 — an async queue + print
thread with levels {ERR=1, WARN=2, INFO=3, DEBUG=4, TRACE=5, MAX_VERBOSE=8},
timestamped lines, "### ERROR" / "@@@ WARNING" / "%%% TRACE" prefixes and an
optional mirror log file.  Here the queue+thread is Python's stdlib logging
with a QueueHandler-style wrapper kept deliberately simple; the observable
format matches the reference.
"""

from __future__ import annotations

import datetime as _dt
import enum
import queue
import sys
import threading
from typing import IO, Optional


class LogLevel(enum.IntEnum):
    """Reference: source/ScreenPrinter.hpp:37-45."""

    NONE = 0
    ERR = 1
    WARN = 2
    INFO = 3
    DEBUG = 4
    TRACE = 5
    MAX_VERBOSE = 8


_PREFIXES = {
    LogLevel.ERR: "### ERROR ",
    LogLevel.WARN: "@@@ WARNING ",
    LogLevel.TRACE: "%%% TRACE ",
}


def _timestamp() -> str:
    return _dt.datetime.now(_dt.timezone.utc).strftime("%Y-%m-%d %H:%M:%S")


class ScreenPrinter:
    """Async logger. ``immediate=True`` prints synchronously (useful in tests).

    Reference: ScreenPrinter's print thread flushes every 250 ms at idle
    priority (source/ScreenPrinter.hpp:60-72); we use a daemon thread draining
    a queue.
    """

    FLUSH_INTERVAL_S = 0.25

    def __init__(
        self,
        level: LogLevel | int = LogLevel.INFO,
        logfile: Optional[str] = None,
        immediate: bool = False,
        stream: Optional[IO[str]] = None,
    ) -> None:
        self.level = LogLevel(int(level))
        self.immediate = immediate
        self.stream = stream if stream is not None else sys.stdout
        self._logfile_handle: Optional[IO[str]] = None
        if logfile:
            self._logfile_handle = open(logfile, "a", encoding="utf-8")
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        if not immediate:
            self._thread = threading.Thread(
                target=self._run, name="screenprinter", daemon=True
            )
            self._thread.start()

    # -- public API mirroring the reference's print(msg, level) ------------

    def print(self, msg: str, level: LogLevel | int = LogLevel.INFO) -> None:
        level = LogLevel(int(level))
        if level > self.level or self.level == LogLevel.NONE:
            return
        line = f"{_timestamp()} {_PREFIXES.get(level, '')}{msg}"
        if self.immediate:
            self._emit(line)
        else:
            self._queue.put(line)

    def err(self, msg: str) -> None:
        self.print(msg, LogLevel.ERR)

    def warn(self, msg: str) -> None:
        self.print(msg, LogLevel.WARN)

    def info(self, msg: str) -> None:
        self.print(msg, LogLevel.INFO)

    def debug(self, msg: str) -> None:
        self.print(msg, LogLevel.DEBUG)

    def trace(self, msg: str) -> None:
        self.print(msg, LogLevel.TRACE)

    def flush(self) -> None:
        while not self._queue.empty():
            try:
                line = self._queue.get_nowait()
            except queue.Empty:
                break
            if line is not None:
                self._emit(line)

    def terminate(self) -> None:
        """Reference terminates the printer last so final logs flush
        (source/CWSL_DIGI.cpp:454-468)."""
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=2.0)
            self._thread = None
        self.flush()
        if self._logfile_handle:
            self._logfile_handle.close()
            self._logfile_handle = None

    # -- internals ----------------------------------------------------------

    def _emit(self, line: str) -> None:
        print(line, file=self.stream)
        if self._logfile_handle:
            self._logfile_handle.write(line + "\n")
            self._logfile_handle.flush()

    def _run(self) -> None:
        from cwsl_digi_tpu_torch.utils import qos

        qos.set_current_thread_nice(qos.IDLE)   # ≙ idle-prio print thread,
        while True:                             # ScreenPrinter / :1191
            try:
                line = self._queue.get(timeout=self.FLUSH_INTERVAL_S)
            except queue.Empty:
                continue
            if line is None:
                return
            self._emit(line)
