"""A persistent key-value collection and function memoisation on sqlite
(a copy of ``mptpu/data/kv.py``, which imports no JAX; the port keeps its
own): ``KVCollection`` with prefix scans, and ``cache``, which memoises a
function under the SHA1 of its code and arguments. numpy arrays are stored
as ``.npy`` bytes behind a ``NPY0`` tag, other objects pickled behind
``PKL0``, bytes as they are; a database written by either package reads
in the other.
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
import sqlite3
import threading
from typing import Iterator, Optional

import numpy as np


def hash_function(func, *args, **kwargs) -> str:
    """SHA1 of the function's code + repr of args (reference
    ``data/conjure.py:24-35``)."""
    h = hashlib.sha1()
    try:
        h.update(func.__code__.co_code)
    except AttributeError:
        h.update(func.__name__.encode())
    h.update(repr(args).encode())
    h.update(repr(sorted(kwargs.items())).encode())
    return h.hexdigest()


def _encode_array(x: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, x, allow_pickle=False)
    return b"NPY0" + buf.getvalue()


def _decode_value(raw: bytes):
    if raw[:4] == b"NPY0":
        return np.load(io.BytesIO(raw[4:]), allow_pickle=False)
    if raw[:4] == b"PKL0":
        return pickle.loads(raw[4:])
    return raw


class KVCollection:
    """sqlite-backed KV collection with prefix cursor."""

    def __init__(self, path: str):
        self.path = path if path.endswith(".db") else path + ".db"
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._local = threading.local()
        with self._conn() as c:
            c.execute(
                "CREATE TABLE IF NOT EXISTS kv "
                "(k TEXT PRIMARY KEY, v BLOB) WITHOUT ROWID"
            )

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path)
            conn.execute("PRAGMA journal_mode=WAL")
            self._local.conn = conn
        return conn

    def put(self, key: str, value) -> None:
        if isinstance(value, np.ndarray):
            raw = _encode_array(value)
        elif isinstance(value, bytes):
            raw = value
        else:
            raw = b"PKL0" + pickle.dumps(value)
        with self._conn() as c:
            c.execute("INSERT OR REPLACE INTO kv VALUES (?, ?)", (key, raw))

    def get(self, key: str):
        cur = self._conn().execute("SELECT v FROM kv WHERE k = ?", (key,))
        row = cur.fetchone()
        if row is None:
            raise KeyError(key)
        return _decode_value(row[0])

    def __contains__(self, key: str) -> bool:
        cur = self._conn().execute("SELECT 1 FROM kv WHERE k = ?", (key,))
        return cur.fetchone() is not None

    def __setitem__(self, key, value):
        self.put(key, value)

    def __getitem__(self, key):
        return self.get(key)

    def iter_prefix(self, prefix: str) -> Iterator[tuple[str, object]]:
        cur = self._conn().execute(
            "SELECT k, v FROM kv WHERE k GLOB ? ORDER BY k", (prefix + "*",)
        )
        for k, v in cur:
            yield k, _decode_value(v)

    def keys(self, prefix: str = "") -> Iterator[str]:
        cur = self._conn().execute(
            "SELECT k FROM kv WHERE k GLOB ? ORDER BY k", (prefix + "*",)
        )
        for (k,) in cur:
            yield k

    def delete(self, key: str) -> None:
        with self._conn() as c:
            c.execute("DELETE FROM kv WHERE k = ?", (key,))


def cache(collection: KVCollection):
    """Memoize a function into a collection keyed by content hash
    (reference ``data/conjure.py:95-117``)."""

    def decorator(func):
        def wrapped(*args, **kwargs):
            key = f"{func.__name__}:{hash_function(func, *args, **kwargs)}"
            try:
                return collection.get(key)
            except KeyError:
                result = func(*args, **kwargs)
                collection.put(key, result)
                return result

        wrapped.__name__ = func.__name__
        return wrapped

    return decorator
