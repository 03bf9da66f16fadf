"""Typed configuration tree with YAML round-tripping.

Counterpart of ``devqa_tpu/utils/config.py``: frozen dataclasses that load
from / dump to YAML, nested dataclasses built from their type annotations.
PyYAML is imported only inside the YAML methods, so the package runs on
hosts without it.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T", bound="BaseConfig")


def _build(field_type: Any, value: Any) -> Any:
    """Recursively construct nested dataclasses from plain YAML values."""
    if value is None:
        return None
    origin = typing.get_origin(field_type)
    if origin in (list, tuple):
        (elem_t,) = typing.get_args(field_type)[:1] or (Any,)
        seq = [_build(elem_t, v) for v in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        args = typing.get_args(field_type)
        val_t = args[1] if len(args) == 2 else Any
        return {k: _build(val_t, v) for k, v in value.items()}
    if origin is typing.Union:  # Optional[X] and friends
        for arg in typing.get_args(field_type):
            if arg is type(None):
                continue
            try:
                return _build(arg, value)
            except (TypeError, ValueError):
                continue
        return value
    if dataclasses.is_dataclass(field_type) and isinstance(value, dict):
        return _from_dict(field_type, value)
    return value


def _from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _build(hints.get(f.name, Any), data[f.name])
    return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class BaseConfig:
    """Base class for all configs (frozen, hashable)."""

    @classmethod
    def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
        return _from_dict(cls, data)

    @classmethod
    def from_yaml(cls: Type[T], fpath: str) -> T:
        import yaml

        with open(fpath, "r") as f:
            data = yaml.safe_load(f)
        return cls.from_dict(data)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_yaml(self, fpath: str) -> None:
        import yaml

        with open(fpath, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def replace(self: T, **kwargs: Any) -> T:
        return dataclasses.replace(self, **kwargs)
