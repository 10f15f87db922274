"""Dataclass base for the data models.

The JAX package's models are pydantic ``BaseModel``s; the port keeps their
field names, defaults and enums as keyword-only dataclasses, so it runs
where pydantic is not installed. ``model_dump`` is the one pydantic
method the slice calls (evidence dicts for the CPU oracle), with the same
``mode="json"`` conversions: enums to values, UUIDs to strings and
datetimes to ISO-8601 (UTC as ``Z``).
"""
from __future__ import annotations

import dataclasses
from datetime import datetime
from enum import Enum
from uuid import UUID


def _dump(value, json_mode: bool):
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _dump(getattr(value, f.name), json_mode)
                for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {k: _dump(v, json_mode) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_dump(v, json_mode) for v in value]
    if not json_mode:
        return value
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, UUID):
        return str(value)
    if isinstance(value, datetime):
        return value.isoformat().replace("+00:00", "Z")
    return value


class Model:
    """Mixin giving a dataclass model pydantic's ``model_dump``."""

    def model_dump(self, mode: str = "python") -> dict:
        if mode not in ("python", "json"):
            raise ValueError(f"unknown dump mode {mode!r}")
        return _dump(self, mode == "json")


model = dataclasses.dataclass(kw_only=True)
