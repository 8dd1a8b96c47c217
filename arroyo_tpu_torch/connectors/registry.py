"""Connector registry (port of ``arroyo_tpu.connectors.registry``): each
connector registers factories producing source/sink operators from a
config dict, validated by its config class (a dataclass here; the JAX
package uses pydantic models)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ..engine.operator import Operator, SourceOperator


@dataclass
class ConnectorMeta:
    name: str
    description: str
    source_factory: Optional[Callable[[Dict[str, Any]], SourceOperator]] = None
    sink_factory: Optional[Callable[[Dict[str, Any]], Operator]] = None
    config_model: Optional[type] = None  # dataclass for validation

    @property
    def supports_source(self) -> bool:
        return self.source_factory is not None

    @property
    def supports_sink(self) -> bool:
        return self.sink_factory is not None


_REGISTRY: Dict[str, ConnectorMeta] = {}


def register_connector(meta: ConnectorMeta) -> None:
    _REGISTRY[meta.name] = meta


def get_connector(name: str) -> ConnectorMeta:
    _ensure_builtin()
    if name not in _REGISTRY:
        raise KeyError(f"unknown connector: {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def validate_config(name: str, config: Dict[str, Any]) -> Dict[str, Any]:
    """Run a config through the connector's config class (unknown keys
    and bad values raise) and return it as a plain dict."""
    meta = get_connector(name)
    if meta.config_model is not None:
        return dataclasses.asdict(meta.config_model(**config))
    return config


def make_source(name: str, config: Dict[str, Any]) -> SourceOperator:
    meta = get_connector(name)
    if not meta.supports_source:
        raise ValueError(f"connector {name} does not support sources")
    return meta.source_factory(validate_config(name, config))


def make_sink(name: str, config: Dict[str, Any]) -> Operator:
    meta = get_connector(name)
    if not meta.supports_sink:
        raise ValueError(f"connector {name} does not support sinks")
    return meta.sink_factory(validate_config(name, config))


def _ensure_builtin() -> None:
    from . import (blackhole, filesystem, impulse, kafka,  # noqa: F401
                   memory, nexmark, preview, single_file)  # (register)
