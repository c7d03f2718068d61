"""Head state persistence: write-through sqlite tables.

Parity target: the reference's GCS table storage + fault tolerance
(reference: src/ray/gcs/gcs_server/gcs_table_storage.h — actor/node/PG/KV
tables over a Redis/in-memory StoreClient; gcs_redis_failure_detector.h;
RayletNotifyGCSRestart, src/ray/protobuf/core_worker.proto:443),
re-designed small: one WAL-mode sqlite file per cluster session. Every
durable mutation (KV, actor registry + state, placement groups, job
counter) is written through; a restarted head reloads the tables and the
cluster re-converges (nodes re-register on the next heartbeat NACK,
submitters re-resolve actors via retrying calls).

sqlite is the right fit at this scale: the head is a single process, the
write rate is control-plane (not data-plane), and WAL gives atomic
durability without a second service — the reference's Redis dependency is
exactly what its HA docs call optional for single-cluster deployments.
"""

from __future__ import annotations

import os
import pickle
import sqlite3
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple


class HeadStore:
    """Write-through durable tables for the head. Thread-safe."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        for ddl in (
            "CREATE TABLE IF NOT EXISTS kv (ns TEXT, k BLOB, v BLOB, "
            "PRIMARY KEY (ns, k))",
            "CREATE TABLE IF NOT EXISTS actors (actor_id BLOB PRIMARY KEY, "
            "blob BLOB)",
            "CREATE TABLE IF NOT EXISTS pgs (pg_id BLOB PRIMARY KEY, "
            "blob BLOB)",
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v BLOB)",
        ):
            self._db.execute(ddl)
        self._db.commit()

    def close(self) -> None:
        with self._lock:
            try:
                self._db.commit()
                self._db.close()
            except Exception:
                pass

    def checkpoint(self) -> None:
        """Flush the WAL into the main database file (rolling-upgrade
        snapshot step): the successor head — possibly a NEWER build
        opening the file fresh — reads a fully-merged db instead of
        replaying this era's write-ahead log. TRUNCATE also resets the
        -wal file so the handover copies no stale log frames."""
        with self._lock:
            self._db.commit()
            self._db.execute("PRAGMA wal_checkpoint(TRUNCATE)")

    # ------------------------------------------------------------------ kv

    def kv_put(self, ns: str, key: bytes, value: bytes) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO kv (ns, k, v) VALUES (?, ?, ?)",
                (ns, key, value))
            self._db.commit()

    def kv_del(self, ns: str, key: bytes) -> None:
        with self._lock:
            self._db.execute("DELETE FROM kv WHERE ns=? AND k=?", (ns, key))
            self._db.commit()

    def kv_load(self) -> Dict[Tuple[str, bytes], bytes]:
        with self._lock:
            rows = self._db.execute("SELECT ns, k, v FROM kv").fetchall()
        return {(ns, bytes(k)): bytes(v) for ns, k, v in rows}

    # -------------------------------------------------------------- actors

    def save_actor(self, actor_id: bytes, state: Dict[str, Any]) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO actors (actor_id, blob) "
                "VALUES (?, ?)", (actor_id, pickle.dumps(state, 5)))
            self._db.commit()

    def delete_actor(self, actor_id: bytes) -> None:
        with self._lock:
            self._db.execute("DELETE FROM actors WHERE actor_id=?",
                             (actor_id,))
            self._db.commit()

    def load_actors(self) -> List[Tuple[bytes, Dict[str, Any]]]:
        with self._lock:
            rows = self._db.execute(
                "SELECT actor_id, blob FROM actors").fetchall()
        return [(bytes(a), pickle.loads(b)) for a, b in rows]

    # ----------------------------------------------------------------- pgs

    def save_pg(self, pg_id: bytes, state: Dict[str, Any]) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO pgs (pg_id, blob) VALUES (?, ?)",
                (pg_id, pickle.dumps(state, 5)))
            self._db.commit()

    def delete_pg(self, pg_id: bytes) -> None:
        with self._lock:
            self._db.execute("DELETE FROM pgs WHERE pg_id=?", (pg_id,))
            self._db.commit()

    def load_pgs(self) -> List[Tuple[bytes, Dict[str, Any]]]:
        with self._lock:
            rows = self._db.execute("SELECT pg_id, blob FROM pgs").fetchall()
        return [(bytes(p), pickle.loads(b)) for p, b in rows]

    # ---------------------------------------------------------------- meta

    def set_meta(self, key: str, value: Any) -> None:
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO meta (k, v) VALUES (?, ?)",
                (key, pickle.dumps(value, 5)))
            self._db.commit()

    def get_meta(self, key: str, default: Any = None) -> Any:
        with self._lock:
            row = self._db.execute("SELECT v FROM meta WHERE k=?",
                                   (key,)).fetchone()
        return pickle.loads(row[0]) if row else default
