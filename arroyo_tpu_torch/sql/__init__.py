"""SQL front end: parse -> plan -> Program (the port of ``arroyo_tpu.sql``).

``plan_sql(text)`` plans a script into the Program that
``arroyo_tpu.sql.plan_sql`` plans from it, node for node, and
``LocalRunner`` runs it on the card (``device="cpu"`` on the host)."""

from .parser import parse_sql  # noqa: F401
from .planner import Planner, SqlPlanError, plan_sql  # noqa: F401
from .schema_provider import SchemaProvider  # noqa: F401
from .compiler import Schema, SqlCompileError  # noqa: F401
from .functions import (  # noqa: F401
    register_udaf,
    register_udf,
    unregister_udfs,
)
