"""Structured key-value logging.

The reference imports structlog everywhere but never configures it
(SURVEY.md §5 observability). Here: a stdlib-only structured logger that is
actually configured — key=value pairs, ISO timestamps, level filtering via
settings.log_level.
"""
from __future__ import annotations

import json
import logging
import sys
from typing import Any

_CONFIGURED = False


def configure(level: str = "INFO", stream=None, as_json: bool = False) -> None:
    global _CONFIGURED
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(_KVFormatter(as_json=as_json))
    root = logging.getLogger("kaeg")
    root.handlers[:] = [handler]
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.propagate = False
    _CONFIGURED = True


class _KVFormatter(logging.Formatter):
    def __init__(self, as_json: bool = False):
        super().__init__()
        self.as_json = as_json

    def format(self, record: logging.LogRecord) -> str:
        fields = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname.lower(),
            "logger": record.name,
            "event": record.getMessage(),
        }
        fields.update(getattr(record, "kv", {}))
        if self.as_json:
            return json.dumps(fields, default=str)
        return " ".join(
            f'{k}={json.dumps(v, default=str) if not isinstance(v, str) else v}'
            for k, v in fields.items()
        )


class BoundLogger:
    """structlog-style bound logger: log.info("event", key=value)."""

    def __init__(self, name: str, **bound: Any):
        self._logger = logging.getLogger(f"kaeg.{name}")
        self._bound = bound

    def bind(self, **kv: Any) -> "BoundLogger":
        out = BoundLogger.__new__(BoundLogger)
        out._logger = self._logger
        out._bound = {**self._bound, **kv}
        return out

    def _log(self, level: int, event: str, **kv: Any) -> None:
        if not _CONFIGURED:
            configure()
        self._logger.log(level, event, extra={"kv": {**self._bound, **kv}})

    def debug(self, event: str, **kv: Any) -> None:
        self._log(logging.DEBUG, event, **kv)

    def info(self, event: str, **kv: Any) -> None:
        self._log(logging.INFO, event, **kv)

    def warning(self, event: str, **kv: Any) -> None:
        self._log(logging.WARNING, event, **kv)

    def error(self, event: str, **kv: Any) -> None:
        self._log(logging.ERROR, event, **kv)


def get_logger(name: str = "app", **bound: Any) -> BoundLogger:
    return BoundLogger(name, **bound)
