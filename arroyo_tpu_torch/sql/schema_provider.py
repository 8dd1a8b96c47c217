"""Table registry for SQL planning — the port of
``arroyo_tpu.sql.schema_provider``, the ``ArroyoSchemaProvider`` analog
(arroyo-sql/src/lib.rs:62-158): connector tables created via CREATE TABLE,
plus built-in virtual tables (nexmark, impulse).

A CREATE TABLE naming a connector this package has not ported raises
``SqlPlanError`` at plan time (ROADMAP A.8), and so does a Kafka table
naming a format neither package knows, never inside a running task."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ast_nodes import ColumnDef, CreateTable, Expr
from .compiler import Schema, StructDef

TYPE_KIND = {
    "int": "i", "integer": "i", "bigint": "i", "smallint": "i",
    "tinyint": "i", "serial": "i",
    "float": "f", "double": "f", "real": "f", "decimal": "f", "numeric": "f",
    "bool": "b", "boolean": "b",
    "text": "s", "varchar": "s", "string": "s", "char": "s", "character": "s",
    "timestamp": "t", "datetime": "t", "timestamptz": "t", "date": "t",
}


@dataclass
class TableDef:
    name: str
    connector: str
    config: Dict[str, Any]
    schema: Schema
    is_source: bool = True
    is_sink: bool = False
    format: str = "json"
    event_time_field: Optional[str] = None
    watermark_field: Optional[str] = None
    generated: List[Tuple[str, str, Expr]] = field(default_factory=list)
    # (col name, type kind, expr)
    columns: List[ColumnDef] = field(default_factory=list)
    default_lateness_micros: int = 1_000_000
    is_updating: bool = False  # debezium formats produce updating streams


CONNECTOR_OPTION_KEYS = {
    # options consumed by the planner, not passed to the connector config
    "connector", "type", "format", "event_time_field", "watermark_field",
}


def nexmark_lateness_micros(rate: float) -> int:
    """Out-of-orderness bound of the nexmark generator: group size x
    inter-event delay (see nexmark.py's (event_number * 953) % 50 shuffle).
    Shared with bench.py's latency math — keep single-sourced."""
    return max(int(50 * 1_000_000.0 / max(rate, 1.0)), 1000)


def nexmark_table(config: Dict[str, Any]) -> TableDef:
    """Built-in nexmark virtual table: Event{person, auction, bid} structs
    flattened onto the generator's union columns."""
    schema = Schema(
        columns={
            "event_type": "i",
            "person_id": "i", "person_name": "s", "person_email": "s",
            "person_city": "s", "person_state": "s", "person_extra": "s",
            "auction_id": "i", "auction_seller": "i", "auction_category": "i",
            "auction_initial_bid": "i", "auction_reserve": "i",
            "auction_expires": "t", "auction_datetime": "t",
            "auction_item_name": "s", "auction_description": "s",
            "auction_extra": "s",
            "bid_auction": "i", "bid_bidder": "i", "bid_price": "i",
            "bid_datetime": "t", "bid_channel": "s", "bid_url": "s",
            "bid_extra": "s",
        },
        structs={
            "person": StructDef("person", {
                "id": "person_id", "name": "person_name",
                "email_address": "person_email", "city": "person_city",
                "state": "person_state", "datetime": "__timestamp",
                "extra": "person_extra",
            }, "event_type", 0),
            "auction": StructDef("auction", {
                "id": "auction_id", "seller": "auction_seller",
                "category": "auction_category",
                "initial_bid": "auction_initial_bid",
                "reserve": "auction_reserve", "expires": "auction_expires",
                "datetime": "auction_datetime",
                "item_name": "auction_item_name",
                "description": "auction_description",
                "extra": "auction_extra",
            }, "event_type", 1),
            "bid": StructDef("bid", {
                "auction": "bid_auction", "bidder": "bid_bidder",
                "price": "bid_price", "datetime": "bid_datetime",
                "channel": "bid_channel", "url": "bid_url",
                "extra": "bid_extra",
            }, "event_type", 2),
        },
        # the generator stamps each event's datetime field with the event
        # timestamp itself (nexmark.py: cols["bid_datetime"] =
        # where(is_bid, ts, 0), masked NULL when the struct is absent) —
        # declare the provenance so the optimizer can prove
        # window-range predicates on these columns pin rows to their own
        # event-time window (reference semantics: nexmark/mod.rs
        # datetime == wallclock event time)
        event_time_cols={"auction_datetime", "bid_datetime",
                         "__timestamp"},
    )
    rate = float(config.get("event_rate", 100_000.0))
    return TableDef("nexmark", "nexmark", config, schema,
                    default_lateness_micros=nexmark_lateness_micros(rate))


def impulse_table(config: Dict[str, Any]) -> TableDef:
    schema = Schema(columns={"counter": "i", "subtask_index": "i"})
    return TableDef("impulse", "impulse", config, schema,
                    default_lateness_micros=0)


# serde formats (formats.make_format): all of the JAX package's
PORTED_FORMATS = {"json", "debezium_json", "raw", "raw_string", "avro"}


def _check_ported(table: str, connector: str, fmt: str) -> None:
    from ..connectors.registry import get_connector
    from .planner import SqlPlanError

    try:
        get_connector(connector)
    except KeyError:
        raise SqlPlanError(
            f"CREATE TABLE {table}: connector {connector!r} is not ported "
            "to arroyo_tpu_torch (ROADMAP A.8)") from None
    if connector == "kafka" and fmt not in PORTED_FORMATS:
        raise SqlPlanError(
            f"CREATE TABLE {table}: unknown format {fmt!r} (known: "
            f"{sorted(PORTED_FORMATS)})")


class SchemaProvider:
    def __init__(self) -> None:
        self.tables: Dict[str, TableDef] = {}

    def register_udf(self, name: str, fn) -> None:
        """Register a scalar UDF ``fn(*cols: np.ndarray) -> np.ndarray``
        usable in any SQL expression (arroyo-sql/src/lib.rs:196-290
        analog; executed on the host expression path)."""
        from .functions import register_udf

        register_udf(name, fn)

    def register_udaf(self, name: str, fn) -> None:
        """Register a user aggregate ``fn(values: np.ndarray) -> scalar``,
        applied per group over non-null rows; windowed aggregations only
        (not mergeable — operators.rs:165-167 two-phase exclusion)."""
        from .functions import register_udaf

        register_udaf(name, fn)

    def get(self, name: str, default_config: Optional[Dict[str, Any]] = None
            ) -> TableDef:
        n = name.lower()
        if n in self.tables:
            return self.tables[n]
        if n == "nexmark":
            return nexmark_table(default_config or {})
        if n == "impulse":
            return impulse_table(default_config or {})
        raise KeyError(f"unknown table {name!r}; known: {sorted(self.tables)}"
                       " + built-ins [nexmark, impulse]")

    def add_memory_table(self, name: str, columns: Dict[str, str],
                         batches: List[Any],
                         lateness_micros: int = 0,
                         event_time_field: Optional[str] = None) -> TableDef:
        """Testing hook: register an in-memory table with explicit batches
        (plays the role of the reference's single_file test tables)."""
        td = TableDef(name.lower(), "memory", {"batches": batches},
                      Schema(columns=dict(columns)),
                      default_lateness_micros=lateness_micros,
                      event_time_field=event_time_field)
        self.tables[td.name] = td
        return td

    def add_create_table(self, ct: CreateTable) -> TableDef:
        opts = dict(ct.with_options)
        connector = opts.get("connector")
        if connector is None:
            raise ValueError(f"CREATE TABLE {ct.name} needs connector = '...'")
        typ = opts.get("type", "source")
        fmt = opts.get("format", "json")
        _check_ported(ct.name, connector, fmt)
        cfg = {k: v for k, v in opts.items() if k not in CONNECTOR_OPTION_KEYS}

        # built-in virtual tables keep their rich schema under a custom
        # name/config (CREATE TABLE my_nexmark WITH (connector='nexmark', ...))
        if connector in ("nexmark", "impulse") and not ct.columns:
            base = (nexmark_table(cfg) if connector == "nexmark"
                    else impulse_table(cfg))
            base.name = ct.name.lower()
            self.tables[base.name] = base
            return base

        schema = Schema()
        generated: List[Tuple[str, str, Expr]] = []
        for col in ct.columns:
            kind = TYPE_KIND.get(col.type, "n")
            schema.columns[col.name.lower()] = kind
            if col.generated_as is not None:
                generated.append((col.name.lower(), kind, col.generated_as))

        # the connector consumes the serde format too (it constructs the
        # Format); planner-only options stay stripped
        cfg["format"] = fmt
        if fmt == "avro" and "format_options" not in cfg and ct.columns:
            # DDL drives the serde: synthesize the Avro record schema from
            # the declared columns (nullable unions)
            avro_t = {"i": "long", "f": "double", "b": "boolean",
                      "s": "string", "t": "long"}
            cfg["format_options"] = {"schema": {
                "type": "record", "name": ct.name,
                "fields": [
                    {"name": c.name.lower(),
                     "type": ["null", avro_t.get(
                         TYPE_KIND.get(c.type, "s"), "string")]}
                    for c in ct.columns if c.generated_as is None],
            }}

        td = TableDef(
            ct.name.lower(), connector, cfg, schema,
            is_source=(typ == "source"), is_sink=(typ == "sink"),
            format=fmt,
            event_time_field=opts.get("event_time_field"),
            watermark_field=opts.get("watermark_field"),
            generated=generated,
            columns=ct.columns,
            is_updating=fmt.startswith("debezium"),
        )
        self.tables[td.name] = td
        return td
