"""URL-dispatched object storage (a copy of ``arroyo_tpu.utils.storage``):
``StorageProvider.for_url`` with ``get``, ``put``, ``exists``, ``list``,
``delete_if_present`` and ``delete_prefix``.

Schemes: ``file://`` (and bare paths) and ``memory://`` (one store a
root, shared in the process), with ``gs://`` / ``s3://`` through fsspec
(gcsfs / s3fs), imported when such a provider is made: without them the
provider raises a clear error, never an import error at import."""

from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, List, Optional
from urllib.parse import urlparse

_MEMORY_STORES: Dict[str, Dict[str, bytes]] = {}
_MEMORY_LOCK = threading.Lock()


class StorageProvider:
    def __init__(self, scheme: str, root: str):
        self.scheme = scheme
        self.root = root

    # -- constructors ------------------------------------------------------

    @staticmethod
    def for_url(url: str) -> "StorageProvider":
        parsed = urlparse(url)
        scheme = parsed.scheme or "file"
        if scheme == "file":
            path = parsed.path if parsed.scheme else url
            return LocalStorage("file", path)
        if scheme == "memory":
            return MemoryStorage("memory", parsed.netloc + parsed.path)
        if scheme in ("gs", "s3"):
            return _fsspec_storage(scheme, url)
        raise ValueError(f"unsupported storage scheme: {scheme} ({url})")

    # -- interface ---------------------------------------------------------

    def put(self, key: str, data: bytes) -> str:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def delete_if_present(self, key: str) -> None:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def size(self, key: str) -> int:
        """Object size in bytes without reading the payload."""
        return len(self.get(key))

    def url_for(self, key: str) -> str:
        return f"{self.scheme}://{os.path.join(self.root, key)}"

    def local_path(self, key: str) -> Optional[str]:
        """Filesystem path if this is local storage (for pyarrow direct IO)."""
        return None


class LocalStorage(StorageProvider):
    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes) -> str:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return path

    def get(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete_if_present(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def delete_prefix(self, prefix: str) -> None:
        shutil.rmtree(self._path(prefix), ignore_errors=True)

    def list(self, prefix: str) -> List[str]:
        base = self._path(prefix)
        out: List[str] = []
        if not os.path.isdir(base):
            return out
        for dirpath, _, files in os.walk(base):
            for fn in files:
                full = os.path.join(dirpath, fn)
                out.append(os.path.relpath(full, self.root))
        return sorted(out)

    def size(self, key: str) -> int:
        return os.path.getsize(self._path(key))

    def local_path(self, key: str) -> Optional[str]:
        return self._path(key)


class MemoryStorage(StorageProvider):
    def __init__(self, scheme: str, root: str):
        super().__init__(scheme, root)
        with _MEMORY_LOCK:
            self._store = _MEMORY_STORES.setdefault(root, {})

    def put(self, key: str, data: bytes) -> str:
        self._store[key] = bytes(data)
        return key

    def get(self, key: str) -> bytes:
        return self._store[key]

    def exists(self, key: str) -> bool:
        return key in self._store

    def delete_if_present(self, key: str) -> None:
        self._store.pop(key, None)

    def delete_prefix(self, prefix: str) -> None:
        for k in [k for k in self._store if k.startswith(prefix)]:
            del self._store[k]

    def list(self, prefix: str) -> List[str]:
        return sorted(k for k in self._store if k.startswith(prefix))


class FsspecStorage(StorageProvider):
    """gs:// / s3:// via fsspec (gcsfs / s3fs); construction raises a
    clear error where they are not installed."""

    def __init__(self, scheme: str, url: str):
        try:
            import fsspec

            self.fs = fsspec.filesystem(scheme)
        except (ImportError, ValueError) as e:
            raise RuntimeError(
                f"{scheme}:// storage requires "
                f"{'gcsfs' if scheme == 'gs' else 's3fs'}, which is not "
                "installed; use file:// or memory://") from e
        parsed = urlparse(url)
        super().__init__(scheme, parsed.netloc + parsed.path.rstrip("/"))

    def _path(self, key: str) -> str:
        return f"{self.root}/{key}" if key else self.root

    def put(self, key: str, data: bytes) -> str:
        with self.fs.open(self._path(key), "wb") as f:
            f.write(data)
        return self._path(key)

    def get(self, key: str) -> bytes:
        with self.fs.open(self._path(key), "rb") as f:
            return f.read()

    def exists(self, key: str) -> bool:
        return self.fs.exists(self._path(key))

    def delete_if_present(self, key: str) -> None:
        try:
            self.fs.rm(self._path(key))
        except FileNotFoundError:
            pass

    def delete_prefix(self, prefix: str) -> None:
        try:
            self.fs.rm(self._path(prefix), recursive=True)
        except FileNotFoundError:
            pass

    def list(self, prefix: str) -> List[str]:
        base = self._path(prefix)
        try:
            files = self.fs.find(base)
        except FileNotFoundError:
            return []
        return sorted(f[len(self.root) + 1:] for f in files)

    def size(self, key: str) -> int:
        return int(self.fs.size(self._path(key)))


def _fsspec_storage(scheme: str, url: str) -> StorageProvider:
    return FsspecStorage(scheme, url)
