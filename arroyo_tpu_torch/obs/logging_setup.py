"""Structured logging init (port of ``arroyo_tpu.obs.logging_setup``;
init_logging, arroyo-server-common/src/lib.rs:49-101): human-readable stdout in dev, logfmt-style JSON lines in
prod (LOG_JSON=true), plus an excepthook that reports panics through the
logger the way the reference installs a tracing panic hook (lib.rs:86-99).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
import traceback
from typing import Optional


class LogfmtJsonFormatter(logging.Formatter):
    """One JSON object per line: ts, level, target, message, fields."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname.lower(),
            "target": record.name,
            "message": record.getMessage(),
        }
        for k in ("job_id", "operator_id", "subtask_idx", "worker_id"):
            v = getattr(record, k, None)
            if v is not None:
                out[k] = v
        if record.exc_info:
            out["exception"] = "".join(
                traceback.format_exception(*record.exc_info))
        return json.dumps(out)


def init_logging(service: str, level: Optional[str] = None) -> None:
    level_name = (level or os.environ.get("LOG_LEVEL", "INFO")).upper()
    root = logging.getLogger()
    root.setLevel(getattr(logging, level_name, logging.INFO))
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("LOG_JSON", "").lower() in ("1", "true", "yes"):
        handler.setFormatter(LogfmtJsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            f"%(asctime)s %(levelname)-7s {service} %(name)s: %(message)s"))
    root.addHandler(handler)

    def hook(exc_type, exc, tb):
        logging.getLogger(service).critical(
            "panic: %s", exc, exc_info=(exc_type, exc, tb))
        sys.__excepthook__(exc_type, exc, tb)

    sys.excepthook = hook
