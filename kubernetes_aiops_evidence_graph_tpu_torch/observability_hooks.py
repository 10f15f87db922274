"""Light indirection so collectors/workflow can emit metrics without
importing the observability stack eagerly (and without it existing yet in
early builds). Wired to real counters in observability/metrics.py."""
from __future__ import annotations

from typing import Any, Callable

_collector_observer: Callable[[str, Any], None] | None = None


def set_collector_observer(fn: Callable[[str, Any], None] | None) -> None:
    global _collector_observer
    _collector_observer = fn


def observe_collector(name: str, result: Any) -> None:
    if _collector_observer is not None:
        _collector_observer(name, result)
