"""Minimal Confluent Schema Registry client over ``urllib`` (port of
``arroyo_tpu.connectors.schema_registry``): register a schema under a
subject, returning the id the 5-byte wire header carries, and fetch a
writer schema by id for decoding.  The REST surface is the Confluent
API's: ``POST /subjects/{subject}/versions`` and
``GET /schemas/ids/{id}``."""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Union


class SchemaRegistryError(RuntimeError):
    pass


class SchemaRegistryClient:
    """Tiny blocking client; callers cache instances per URL.  Both
    directions memoize (ids are immutable in the registry model)."""

    def __init__(self, url: str, timeout: float = 10.0,
                 auth: Optional[str] = None):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.auth = auth  # "user:pass" basic auth, if the registry needs it
        self._by_id: Dict[int, Dict[str, Any]] = {}
        self._ids: Dict[str, int] = {}  # subject \x00 schema-json -> id

    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        req = urllib.request.Request(
            self.url + path, method=method,
            data=(json.dumps(body).encode() if body is not None else None),
            headers={
                "Content-Type": "application/vnd.schemaregistry.v1+json"})
        if self.auth:
            import base64

            req.add_header("Authorization", "Basic " + base64.b64encode(
                self.auth.encode()).decode())
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            raise SchemaRegistryError(
                f"{method} {path} -> {e.code}: "
                f"{e.read().decode(errors='replace')[:200]}")
        except (urllib.error.URLError, OSError) as e:
            raise SchemaRegistryError(f"{method} {path} failed: {e}")

    def register(self, subject: str,
                 schema: Union[str, Dict[str, Any]],
                 schema_type: str = "AVRO") -> int:
        """Register (idempotently) and return the global schema id."""
        text = schema if isinstance(schema, str) else json.dumps(schema)
        key = f"{subject}\x00{text}"
        if key in self._ids:
            return self._ids[key]
        body: Dict[str, Any] = {"schema": text}
        if schema_type != "AVRO":  # AVRO is the registry default
            body["schemaType"] = schema_type
        resp = self._request(
            "POST", f"/subjects/{subject}/versions", body)
        sid = int(resp["id"])
        self._ids[key] = sid
        return sid

    def get_schema(self, schema_id: int) -> Dict[str, Any]:
        """Fetch a (writer) schema by the id from the wire header."""
        if schema_id in self._by_id:
            return self._by_id[schema_id]
        resp = self._request("GET", f"/schemas/ids/{schema_id}")
        schema = json.loads(resp["schema"])
        self._by_id[schema_id] = schema
        return schema


_clients: Dict[str, SchemaRegistryClient] = {}


def registry_client(url: str) -> SchemaRegistryClient:
    """Shared per-URL client (schema caches amortize across operators)."""
    if url not in _clients:
        _clients[url] = SchemaRegistryClient(url)
    return _clients[url]
