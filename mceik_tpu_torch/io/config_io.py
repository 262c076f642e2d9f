"""Typed-config (de)serialization: JSON <-> nested frozen dataclasses, plus
dotted ``key=value`` overrides. Counterpart of ``mceik_tpu/io/config_io.py``."""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict

from mceik_tpu_torch.config import RunConfig


def _from_dict(cls, d: Dict[str, Any]):
    if d is None:
        return cls()
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints[f.name]
        origin = typing.get_origin(t)
        if dataclasses.is_dataclass(t):
            v = _from_dict(t, v)
        elif origin is tuple or (origin is typing.Union and any(
                typing.get_origin(a) is tuple for a in typing.get_args(t))):
            if v is not None:
                v = tuple(v)
        kwargs[f.name] = v
    # Keys starting with "_" are comments (JSON has no comment syntax);
    # anything else unknown is a typo and must fail loudly.
    unknown = {k for k in set(d) - {f.name for f in dataclasses.fields(cls)}
               if not k.startswith("_")}
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**kwargs)


def config_from_dict(d: Dict[str, Any]) -> RunConfig:
    return _from_dict(RunConfig, d)


def config_to_dict(cfg: RunConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def load_config(path: str) -> RunConfig:
    with open(path) as f:
        return config_from_dict(json.load(f))


def _parse_value(s: str):
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s  # bare string


def apply_overrides(cfg: RunConfig, overrides) -> RunConfig:
    """Apply ``section.key=value`` overrides (value parsed as JSON when
    possible: numbers, booleans, lists)."""
    d = config_to_dict(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        key = key.lstrip("-")
        parts = key.split(".")
        node = d
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise ValueError(f"unknown config key {key!r}")
        node[parts[-1]] = _parse_value(val)
    return config_from_dict(d)
