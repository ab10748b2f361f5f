"""Chain loggers: the libpointmatcher Logger registrar.

A copy of the JAX package's ``ops/registration/loggers.py`` (plain Python;
the port keeps its own copy rather than importing the JAX package), the
counterpart of the reference's logging surface
(reference: libpointmatcher/pointmatcher/Logger.cpp,
LoggerImpl.h:40-80, Registry.cpp:126-127):
  - ``NullLogger`` — swallows everything (the registry default),
  - ``ConsoleLogger`` — info to stdout, warnings to stderr
    (≙ FileLogger with empty file names),
  - ``FileLogger(infoFileName, warningFileName, displayLocation)`` —
    streams to files, falling back to the console streams when a name is
    empty, exactly like the reference's FileLogger parameter semantics.

The reference logs per-iteration from inside the ICP loop; the port's
loop keeps its stopping test on the device and never waits for it, so the
chain logs per *register() call* (counts, iterations, match ratio,
transform: a logger that writes reads them back) — the same information at
the granularity the host actually observes.  Per-iteration dumps are the
inspectors' (ops/registration/inspectors.py), which run the production
iteration step.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, Optional, TextIO


class Logger:
    """Base logger (≙ PointMatcherSupport::Logger)."""

    has_info = False
    has_warning = False

    def info(self, msg: str) -> None:  # pragma: no cover - overridden
        pass

    def warning(self, msg: str) -> None:  # pragma: no cover - overridden
        pass

    def close(self) -> None:
        pass


class NullLogger(Logger):
    """≙ NullLogger (Registry.cpp:126): swallow everything."""


class ConsoleLogger(Logger):
    """Info to stdout, warnings to stderr."""

    has_info = True
    has_warning = True

    def info(self, msg: str) -> None:
        print(msg, file=sys.stdout)

    def warning(self, msg: str) -> None:
        print(msg, file=sys.stderr)


class FileLogger(Logger):
    """≙ FileLogger (LoggerImpl.h:40-80): parameters infoFileName /
    warningFileName (empty -> stdout / stderr) and displayLocation."""

    has_info = True
    has_warning = True

    def __init__(self, info_file_name: str = "", warning_file_name: str = "",
                 display_location: bool = False):
        self.display_location = display_location
        self._close_info = bool(info_file_name)
        self._close_warn = bool(warning_file_name)
        self._info: TextIO = (open(info_file_name, "w") if info_file_name
                              else sys.stdout)
        self._warn: TextIO = (open(warning_file_name, "w") if warning_file_name
                              else sys.stderr)

    def info(self, msg: str) -> None:
        print(msg, file=self._info)
        self._info.flush()

    def warning(self, msg: str) -> None:
        print(msg, file=self._warn)
        self._warn.flush()

    def close(self) -> None:
        if self._close_info:
            self._info.close()
        if self._close_warn:
            self._warn.close()


def make_logger(name: str, params: Optional[Dict[str, Any]] = None) -> Logger:
    """Logger registrar (≙ Registry.cpp:126-127 ADD_TO_REGISTRAR(Logger, …)).

    Accepts the reference spelling (NullLogger / FileLogger) and a
    ConsoleLogger alias for FileLogger-with-empty-names.
    """
    params = params or {}
    canon = name.lower().replace("logger", "")
    if canon in ("", "null"):
        return NullLogger()
    if canon == "console":
        return ConsoleLogger()
    if canon == "file":
        return FileLogger(
            info_file_name=str(params.get("infoFileName", "")),
            warning_file_name=str(params.get("warningFileName", "")),
            display_location=bool(int(params.get("displayLocation", 0))))
    raise ValueError(f"unknown logger {name!r}; known: NullLogger, "
                     f"ConsoleLogger, FileLogger")
