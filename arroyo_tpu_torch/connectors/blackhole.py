"""Blackhole sink: discards everything (benchmarks the upstream path)."""

from __future__ import annotations

from typing import Any, Dict

from ..engine.context import Context
from ..engine.operator import Operator
from ..types import Batch
from .registry import ConnectorMeta, register_connector


class BlackholeSink(Operator):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__("blackhole")
        self.rows = 0

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        self.rows += len(batch)


register_connector(ConnectorMeta(
    name="blackhole",
    description="discard sink for benchmarks",
    sink_factory=BlackholeSink,
))
