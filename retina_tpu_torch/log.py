"""Structured logging singleton (a copy of retina_tpu/log.py).

Reference analog: pkg/log/zap.go — a zap singleton with a rotating file
sink plus console, configured once at daemon start
(cmd/standard/daemon.go:112-126). Python analog: stdlib logging with a
RotatingFileHandler and a key=value console formatter; one setup call,
named child loggers everywhere (``logger("pluginmanager")``).
"""

from __future__ import annotations

import logging
import logging.handlers
import sys
import threading
import time

_ROOT = "retina"
_configured = False

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "panic": logging.CRITICAL,
}


class _KVFormatter(logging.Formatter):
    """ts level logger msg key=value... — zap's console encoding shape."""

    def format(self, record: logging.LogRecord) -> str:
        base = (
            f"{self.formatTime(record, '%Y-%m-%dT%H:%M:%S')} "
            f"{record.levelname.lower():5s} {record.name} {record.getMessage()}"
        )
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


def setup_logger(
    level: str = "info",
    log_file: str = "",
    max_bytes: int = 10 * 1024 * 1024,
    backups: int = 3,
) -> logging.Logger:
    """Configure the retina root logger. Idempotent (sync.Once analog)."""
    global _configured
    root = logging.getLogger(_ROOT)
    if _configured:
        return root
    root.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    con = logging.StreamHandler(sys.stderr)
    con.setFormatter(_KVFormatter())
    root.addHandler(con)
    if log_file:
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=max_bytes, backupCount=backups
        )
        fh.setFormatter(_KVFormatter())
        root.addHandler(fh)
    root.propagate = False
    _configured = True
    return root


def logger(name: str = "") -> logging.Logger:
    """Named child logger, e.g. logger('pluginmanager')."""
    if not _configured:
        setup_logger()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


_rl_lock = threading.Lock()
_rl_last: dict = {}


def rate_limited(key: str, interval_s: float = 60.0) -> bool:
    """True when the caller should emit a log line for ``key`` now.

    Error paths on the hot dispatch/harvest loops must not turn a
    persistent fault into a log flood: callers bump their error counter
    unconditionally and gate the (expensive, possibly per-event) log
    line behind this. First hit always logs; repeats within
    ``interval_s`` are suppressed.
    """
    now = time.monotonic()
    with _rl_lock:
        last = _rl_last.get(key)
        if last is not None and now - last < interval_s:
            return False
        _rl_last[key] = now
        return True


def reset_for_tests() -> None:
    global _configured
    root = logging.getLogger(_ROOT)
    for h in list(root.handlers):
        root.removeHandler(h)
    _configured = False
    with _rl_lock:
        _rl_last.clear()
