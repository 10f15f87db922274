"""Dataclass base for the data models.

The JAX package's models are pydantic ``BaseModel``s; the port keeps their
field names, defaults and enums as keyword-only dataclasses, so it runs
where pydantic is not installed. They carry the pydantic surface the port
calls: ``model_dump`` (evidence dicts for the CPU oracle), with the same
``mode="json"`` conversions: enums to values, UUIDs to strings and
datetimes to ISO-8601 (UTC as ``Z``); ``model_dump_json`` (the durable
store's runbook rows); the class attribute ``model_fields`` (field name →
``dataclasses.Field``); and ``model_validate``, which builds a model from a
stored row, converting strings back to the field's enum, UUID or datetime
as pydantic's validation does.

Models built from a request body (``HypothesisFeedback``) also check their
fields when constructed, as pydantic's lax mode does (``validate_fields``):
a value of the wrong type raises ``TypeError`` or ``ValueError``, so the
API answers 400 to the bodies the JAX package's API refuses.
``Model.from_request`` drops the keys that name no field, as pydantic
ignores them.
"""
from __future__ import annotations

import dataclasses
import json
import typing
from datetime import datetime, timezone
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


def _coerce(value, hint):
    """A stored value (a string from JSON or SQL) as the annotated type:
    enums, UUIDs and datetimes, also inside ``Optional``; anything else as
    it is."""
    if value is None:
        return None
    args = [a for a in typing.get_args(hint) if a is not type(None)]
    if typing.get_origin(hint) is typing.Union and len(args) == 1:
        hint = args[0]
    if isinstance(hint, type):
        if issubclass(hint, Enum) and not isinstance(value, hint):
            return hint(value)
        if hint is UUID and isinstance(value, str):
            return UUID(value)
        if hint is datetime and isinstance(value, str):
            return datetime.fromisoformat(value.replace("Z", "+00:00"))
    return value


_TRUE = frozenset(("1", "on", "t", "true", "y", "yes"))
_FALSE = frozenset(("0", "off", "f", "false", "n", "no"))


def _lax(name: str, value, hint):
    """``value`` as pydantic's lax mode takes it for the annotation
    ``hint`` (bool, str, UUID, datetime, and their ``Optional``: the
    field types of the request models); raises ``TypeError``/``ValueError``
    where pydantic raises its ``ValidationError``."""
    args = [a for a in typing.get_args(hint) if a is not type(None)]
    if typing.get_origin(hint) is typing.Union and len(args) == 1:
        if value is None:
            return None
        hint = args[0]
    if value is None:
        raise TypeError(f"{name}: a value is required, got None")
    if hint is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.lower() in _TRUE | _FALSE:
            return value.lower() in _TRUE
        raise ValueError(f"{name}: not a valid boolean: {value!r}")
    if hint is str:
        if isinstance(value, str):
            return value
        raise TypeError(f"{name}: not a string: {value!r}")
    if hint is UUID:
        if isinstance(value, UUID):
            return value
        if isinstance(value, str):
            return UUID(value)
        raise TypeError(f"{name}: not a UUID: {value!r}")
    if hint is datetime:
        if isinstance(value, datetime):
            return value
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return datetime.fromtimestamp(value, tz=timezone.utc)
        if isinstance(value, str):
            return datetime.fromisoformat(value.replace("Z", "+00:00"))
        raise TypeError(f"{name}: not a datetime: {value!r}")
    raise TypeError(f"{name}: no request validation for {hint!r}")


def validate_fields(obj) -> None:
    """Check and convert every field of a dataclass model in place, as
    pydantic's lax validation would (see ``_lax``)."""
    hints = typing.get_type_hints(type(obj))
    for f in dataclasses.fields(obj):
        setattr(obj, f.name, _lax(f.name, getattr(obj, f.name),
                                  hints[f.name]))


class _FieldMap:
    """``Model.model_fields``: the dataclass fields by name, read off the
    class (a class attribute, as in pydantic)."""

    def __get__(self, obj, cls) -> dict:
        return {f.name: f for f in dataclasses.fields(cls)}


class Model:
    """Mixin giving a dataclass model pydantic's ``model_dump``,
    ``model_dump_json``, ``model_fields`` and ``model_validate``."""

    model_fields = _FieldMap()

    def model_dump(self, mode: str = "python") -> dict:
        if mode not in ("python", "json"):
            raise ValueError(f"unknown dump mode {mode!r}")
        return _dump(self, mode == "json")

    def model_dump_json(self) -> str:
        """The ``mode="json"`` dump as compact JSON, as pydantic writes it."""
        return json.dumps(self.model_dump(mode="json"), separators=(",", ":"))

    @classmethod
    def from_request(cls, **body):
        """The model from a request body's keys; keys that name no field
        are dropped, as pydantic drops them."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in body.items() if k in names})

    @classmethod
    def model_validate(cls, data: dict):
        """The model from a dict of its fields (other keys are an error),
        converting stored strings to the fields' enums, UUIDs and
        datetimes."""
        hints = typing.get_type_hints(cls)
        return cls(**{k: _coerce(v, hints[k]) for k, v in data.items()})


model = dataclasses.dataclass(kw_only=True)
