"""Env-first configuration (the engine subset of ``arroyo_tpu.config``):
a typed settings object reads the environment once, with the same
variable names and defaults as the JAX package."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclass
class Config:
    # bounded in-process edge queues (messages, not rows)
    queue_size: int = field(default_factory=lambda: _env_int("QUEUE_SIZE", 64))
    # rows per source batch when a connector config does not say
    target_batch_size: int = field(
        default_factory=lambda: _env_int("BATCH_SIZE", 8192))
    # input coalescing (engine/coalesce.py): the target rows of a merged
    # batch (0: target_batch_size) and how long a partial buffer may
    # wait for more input; ARROYO_COALESCE=0 turns it off
    coalesce_target: int = field(
        default_factory=lambda: _env_int("COALESCE_TARGET", 0))
    coalesce_linger_micros: int = field(
        default_factory=lambda: _env_int("COALESCE_LINGER_MICROS", 2_000))
    # initial per-subtask keyed-state slots (doubles on overflow)
    state_capacity: int = field(
        default_factory=lambda: _env_int("STATE_CAPACITY", 1 << 12))
    # latency observatory (obs/latency.py): sample 1 record in N at the
    # sources (0 = off)
    latency_sample_n: int = field(
        default_factory=lambda: _env_int("ARROYO_LATENCY_SAMPLE_N", 0))


_config: Optional[Config] = None


def config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def reset_config() -> None:
    """Testing hook: force re-read of the environment."""
    global _config
    _config = None
