"""Logging destinations: syslog / stderr / none (reference: src/logging.cpp).

``log(level, msg)`` mirrors the reference's interface; ``error()`` is fatal
(reference: logging.cpp:31-34 `_Exit(1)`), softened here to raising
SystemExit so library users can catch it.
"""

from __future__ import annotations

import sys
import syslog as _syslog

LOG_ERR = _syslog.LOG_ERR
LOG_WARNING = _syslog.LOG_WARNING
LOG_NOTICE = _syslog.LOG_NOTICE
LOG_INFO = _syslog.LOG_INFO

_DEST = "stderr"  # 'syslog' | 'stderr' | 'none'
_NAMES = {LOG_ERR: "ERROR", LOG_WARNING: "WARN", LOG_NOTICE: "NOTICE", LOG_INFO: "INFO"}


def init_logging(dest: str) -> None:
    global _DEST
    _DEST = dest
    if dest == "syslog":
        _syslog.openlog("rtlsdr_airband_tpu_torch", _syslog.LOG_PID, _syslog.LOG_DAEMON)


def log(level: int, msg: str) -> None:
    if _DEST == "none":
        return
    if _DEST == "syslog":
        _syslog.syslog(level, msg)
    else:
        print(f"[{_NAMES.get(level, level)}] {msg}", file=sys.stderr, flush=True)


def error(msg: str) -> None:
    log(LOG_ERR, msg)
    raise SystemExit(1)


# --- debug file (reference: -d flag + debug_print, logging.h:32-46) ---------

_DEBUG_FILE = None


def init_debug(filepath: str | None) -> None:
    """Open the debug log file (reference: init_debug, logging.cpp:36-47)."""
    global _DEBUG_FILE
    if _DEBUG_FILE is not None:
        _DEBUG_FILE.close()
        _DEBUG_FILE = None
    if filepath:
        _DEBUG_FILE = open(filepath, "a", buffering=1)


def debug_print(msg: str) -> None:
    """No-op unless a debug file is configured (reference: debug_print)."""
    if _DEBUG_FILE is not None:
        import time as _time

        _DEBUG_FILE.write(f"{_time.time():.6f} {msg}\n")
