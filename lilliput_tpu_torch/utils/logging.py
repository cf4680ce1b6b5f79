"""Structured logging for the transcode runtime.

The port's copy of ``lilliput_tpu/utils/logging.py``: every subsystem logs
through one namespaced logger ("lilliput") with a key=value formatter, so
a serving deployment can ship logs without parsing free text. The level
comes from LILLIPUT_LOG_LEVEL (WARNING by default).
"""

from __future__ import annotations

import logging
import os
import sys


class _KVFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = (f"ts={self.formatTime(record, '%Y-%m-%dT%H:%M:%S')} "
                f"level={record.levelname.lower()} "
                f"logger={record.name} msg={record.getMessage()!r}")
        extras = getattr(record, "kv", None)
        if extras:
            base += " " + " ".join(f"{k}={v}" for k, v in extras.items())
        return base


_configured = False


def get_logger(name: str = "lilliput") -> logging.Logger:
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_KVFormatter())
        root = logging.getLogger("lilliput")
        root.addHandler(handler)
        root.setLevel(os.environ.get("LILLIPUT_LOG_LEVEL", "WARNING").upper())
        root.propagate = False
        _configured = True
    return logger


def kv(logger: logging.Logger, level: int, msg: str, **fields) -> None:
    logger.log(level, msg, extra={"kv": fields})
