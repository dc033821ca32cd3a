"""SQLite storage backend — the default persistent store.

Counterpart of ``incubator_predictionio_tpu/data/storage/sqlite_backend.py``
(itself the counterpart of the reference's JDBC backend, storage/jdbc/),
with the same tables and columns, so a database written by either package
reads in the other. Serves events, apps, access keys, channels, engine
instances, evaluation instances and models; the native ingest fast path
and jobs come in later slices (ROADMAP.md). The layout decisions:

- one event table per app/channel, named ``pio_event_<appid>[_<channelid>]``
  (JDBCLEvents.scala:109-150);
- models as a blob column (JDBCModels.scala:55);
- event rows carry a precomputed ``entity_shard`` column (the reference
  package's parallel read path scans it; the port's sharded reads come with
  the sharding slice).

Event times are stored as integer UTC microseconds for correct ordering.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import sqlite3
import threading
import uuid
from typing import Any, Iterator, Optional, Sequence

from incubator_predictionio_tpu_torch.data.event import (
    DataMap,
    Event,
    UTC,
    epoch_micros,
    time_prefixed_event_id,
)
from incubator_predictionio_tpu_torch.data.storage.base import (
    UNSET,
    AccessKey,
    AccessKeysStore,
    App,
    AppsStore,
    Channel,
    ChannelsStore,
    EngineInstance,
    EngineInstancesStore,
    EvaluationInstance,
    EvaluationInstancesStore,
    EventStore,
    Model,
    ModelsStore,
    StorageClient,
    StorageError,
    entity_shard,
)

N_SHARD_BUCKETS = 1024  # fixed bucket count; find_sharded folds buckets into n shards


# the shared exact-integer definition (data/event.py): the C ingest sink
# computes integer microseconds, and both paths must store bit-identical
# event_time for the same request body
_us = epoch_micros


def _from_us(us: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(us / 1_000_000, UTC)


def _event_table(app_id: int, channel_id: Optional[int]) -> str:
    if not isinstance(app_id, int) or (channel_id is not None and not isinstance(channel_id, int)):
        raise StorageError("app_id/channel_id must be ints")
    return f"pio_event_{app_id}" + (f"_{channel_id}" if channel_id is not None else "")


class _Db:
    """One sqlite connection shared under a lock (nproc=1 environments; the
    event server serializes writes through this anyway)."""

    def __init__(self, path: str):
        self.path = path
        self.lock = threading.RLock()
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=NORMAL")

    def execute(self, sql: str, params: Sequence[Any] = ()) -> sqlite3.Cursor:
        with self.lock:
            cur = self.conn.execute(sql, params)
            self.conn.commit()
            return cur

    def executemany(self, sql: str, rows: Sequence[Sequence[Any]]) -> None:
        with self.lock:
            self.conn.executemany(sql, rows)
            self.conn.commit()

    def query(self, sql: str, params: Sequence[Any] = ()) -> list[tuple]:
        with self.lock:
            return self.conn.execute(sql, params).fetchall()

    def close(self) -> None:
        with self.lock:
            self.conn.close()


_EVENT_COLS = (
    "id, event, entity_type, entity_id, target_entity_type, target_entity_id, "
    "properties, event_time, tags, pr_id, creation_time, entity_shard"
)


def _row_to_event(r: tuple) -> Event:
    return Event(
        event_id=r[0],
        event=r[1],
        entity_type=r[2],
        entity_id=r[3],
        target_entity_type=r[4],
        target_entity_id=r[5],
        properties=DataMap(json.loads(r[6])),
        event_time=_from_us(r[7]),
        tags=tuple(json.loads(r[8])),
        pr_id=r[9],
        creation_time=_from_us(r[10]),
    )


def _event_row(event_id: str, e: Event) -> tuple:
    props = e.properties.to_dict()
    return (
        event_id,
        e.event,
        e.entity_type,
        e.entity_id,
        e.target_entity_type,
        e.target_entity_id,
        json.dumps(props) if props else "{}",  # empty fast path (hot)
        _us(e.event_time),
        json.dumps(list(e.tags)) if e.tags else "[]",
        e.pr_id,
        _us(e.creation_time),
        entity_shard(e.entity_id, N_SHARD_BUCKETS),
    )


class SqliteEvents(EventStore):
    def __init__(self, db: _Db):
        self._db = db
        self._initialized: set[tuple[int, Optional[int]]] = set()

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        # idempotent and called on hot paths — 4 statements (each with a
        # commit) per call otherwise
        if (app_id, channel_id) in self._initialized:
            return True
        t = _event_table(app_id, channel_id)
        self._db.execute(
            f"""CREATE TABLE IF NOT EXISTS {t} (
                id TEXT PRIMARY KEY,
                event TEXT NOT NULL,
                entity_type TEXT NOT NULL,
                entity_id TEXT NOT NULL,
                target_entity_type TEXT,
                target_entity_id TEXT,
                properties TEXT NOT NULL,
                event_time INTEGER NOT NULL,
                tags TEXT NOT NULL,
                pr_id TEXT,
                creation_time INTEGER NOT NULL,
                entity_shard INTEGER NOT NULL
            )"""
        )
        self._db.execute(f"CREATE INDEX IF NOT EXISTS {t}_time ON {t} (event_time)")
        self._db.execute(f"CREATE INDEX IF NOT EXISTS {t}_entity ON {t} (entity_type, entity_id)")
        self._db.execute(f"CREATE INDEX IF NOT EXISTS {t}_shard ON {t} (entity_shard)")
        self._initialized.add((app_id, channel_id))
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._initialized.discard((app_id, channel_id))
        self._db.execute(f"DROP TABLE IF EXISTS {_event_table(app_id, channel_id)}")
        return True

    @staticmethod
    def _new_event_id(e: Event) -> str:
        # time-prefixed, btree-right-edge ids (shared scheme, data/event.py)
        return time_prefixed_event_id(e.creation_time)

    def _heal_no_table(self, op, app_id: int, channel_id: Optional[int]):
        """Run ``op``; if the table vanished underneath us (another process
        ran data-delete → DROP TABLE), re-init and retry ONCE — the per-event
        init this backend's cache replaced was self-healing, so the cached
        path must be too."""
        try:
            return op()
        except sqlite3.OperationalError as err:
            if "no such table" not in str(err):
                raise
            self._initialized.discard((app_id, channel_id))
            self.init(app_id, channel_id)
            return op()

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> list[str]:
        t = _event_table(app_id, channel_id)
        ids = [e.event_id or self._new_event_id(e) for e in events]
        rows = [_event_row(i, e) for i, e in zip(ids, events)]
        self._heal_no_table(
            lambda: self._db.executemany(
                f"INSERT OR REPLACE INTO {t} ({_EVENT_COLS}) "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?,?)", rows),
            app_id, channel_id)
        return ids

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        t = _event_table(app_id, channel_id)
        try:
            rows = self._db.query(f"SELECT {_EVENT_COLS} FROM {t} WHERE id = ?", (event_id,))
        except sqlite3.OperationalError:
            return None
        return _row_to_event(rows[0]) if rows else None

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        t = _event_table(app_id, channel_id)
        try:
            cur = self._db.execute(f"DELETE FROM {t} WHERE id = ?", (event_id,))
        except sqlite3.OperationalError:
            return False
        return cur.rowcount > 0

    def _find_sql(
        self,
        app_id: int,
        channel_id: Optional[int],
        start_time,
        until_time,
        entity_type,
        entity_id,
        event_names,
        target_entity_type,
        target_entity_id,
        shard_range: Optional[tuple[int, int]] = None,
    ) -> tuple[str, list]:
        t = _event_table(app_id, channel_id)
        where, params = [], []
        if start_time is not None:
            where.append("event_time >= ?")
            params.append(_us(start_time))
        if until_time is not None:
            where.append("event_time < ?")
            params.append(_us(until_time))
        if entity_type is not None:
            where.append("entity_type = ?")
            params.append(entity_type)
        if entity_id is not None:
            where.append("entity_id = ?")
            params.append(entity_id)
        if event_names is not None:
            where.append(f"event IN ({','.join('?' * len(event_names))})")
            params.extend(event_names)
        if target_entity_type is not UNSET:
            if target_entity_type is None:
                where.append("target_entity_type IS NULL")
            else:
                where.append("target_entity_type = ?")
                params.append(target_entity_type)
        if target_entity_id is not UNSET:
            if target_entity_id is None:
                where.append("target_entity_id IS NULL")
            else:
                where.append("target_entity_id = ?")
                params.append(target_entity_id)
        if shard_range is not None:
            where.append("entity_shard >= ? AND entity_shard < ?")
            params.extend(shard_range)
        sql = f"SELECT {_EVENT_COLS} FROM {t}"
        if where:
            sql += " WHERE " + " AND ".join(where)
        return sql, params

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        sql, params = self._find_sql(
            app_id, channel_id, start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id,
        )
        # id tiebreaker: equal-timestamp ordering must be deterministic so
        # per-entity and batched (IN-clause) reads keep the SAME events
        # under limits — the batched-serving parity contract
        order = "DESC" if reversed else "ASC"
        sql += f" ORDER BY event_time {order}, id {order}"
        if limit is not None and limit >= 0:
            sql += " LIMIT ?"
            params.append(limit)
        try:
            rows = self._db.query(sql, params)
        except sqlite3.OperationalError as e:
            raise StorageError(
                f"event table for app {app_id} channel {channel_id} not initialized"
            ) from e
        return (_row_to_event(r) for r in rows)

    def find_by_entities(
        self,
        app_id: int,
        entity_type: str,
        entity_ids: Sequence[str],
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        limit_per_entity: Optional[int] = None,
        reversed: bool = False,
    ) -> dict[str, list[Event]]:
        """One ``entity_id IN (...)`` query for the whole batch, the
        per-entity cap pushed into SQL (a ``ROW_NUMBER`` window), rows in
        the ``ORDER BY event_time, id`` a per-entity :meth:`find` uses."""
        ids = list(dict.fromkeys(entity_ids))
        if not ids:
            return {}
        sql, params = self._find_sql(
            app_id, channel_id, start_time, until_time, entity_type, None,
            event_names, target_entity_type, target_entity_id,
        )
        clause = f"entity_id IN ({','.join('?' * len(ids))})"
        sql += (" AND " if " WHERE " in sql else " WHERE ") + clause
        params.extend(ids)
        order = "DESC" if reversed else "ASC"
        limit = (limit_per_entity if limit_per_entity is not None
                 and limit_per_entity >= 0 else None)
        if limit is not None:
            prefix = f"SELECT {_EVENT_COLS} FROM "
            inner = (
                f"SELECT {_EVENT_COLS}, ROW_NUMBER() OVER ("
                f"PARTITION BY entity_id "
                f"ORDER BY event_time {order}, id {order}) AS rn "
                f"FROM {sql[len(prefix):]}")
            sql = f"SELECT {_EVENT_COLS} FROM ({inner}) WHERE rn <= ?"
            params.append(limit)
        sql += f" ORDER BY event_time {order}, id {order}"
        try:
            rows = self._db.query(sql, params)
        except sqlite3.OperationalError as e:
            if "no such table" not in str(e):
                raise
            raise StorageError(
                f"event table for app {app_id} channel {channel_id} not initialized"
            ) from e
        return self.group_events_by_entity(
            (_row_to_event(r) for r in rows), ids, limit_per_entity)


class SqliteApps(AppsStore):
    def __init__(self, db: _Db):
        self._db = db
        db.execute(
            """CREATE TABLE IF NOT EXISTS pio_apps (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                name TEXT UNIQUE NOT NULL,
                description TEXT
            )"""
        )

    def insert(self, app: App) -> Optional[int]:
        try:
            if app.id > 0:
                cur = self._db.execute(
                    "INSERT INTO pio_apps (id, name, description) VALUES (?,?,?)",
                    (app.id, app.name, app.description),
                )
            else:
                cur = self._db.execute(
                    "INSERT INTO pio_apps (name, description) VALUES (?,?)",
                    (app.name, app.description),
                )
        except sqlite3.IntegrityError:
            return None
        return cur.lastrowid if app.id <= 0 else app.id

    def get(self, app_id: int) -> Optional[App]:
        rows = self._db.query("SELECT id, name, description FROM pio_apps WHERE id=?", (app_id,))
        return App(*rows[0]) if rows else None

    def get_by_name(self, name: str) -> Optional[App]:
        rows = self._db.query("SELECT id, name, description FROM pio_apps WHERE name=?", (name,))
        return App(*rows[0]) if rows else None

    def get_all(self) -> list[App]:
        return [App(*r) for r in self._db.query("SELECT id, name, description FROM pio_apps")]

    def update(self, app: App) -> bool:
        cur = self._db.execute(
            "UPDATE pio_apps SET name=?, description=? WHERE id=?",
            (app.name, app.description, app.id),
        )
        return cur.rowcount > 0

    def delete(self, app_id: int) -> bool:
        cur = self._db.execute("DELETE FROM pio_apps WHERE id=?", (app_id,))
        return cur.rowcount > 0


class SqliteAccessKeys(AccessKeysStore):
    def __init__(self, db: _Db):
        self._db = db
        db.execute(
            """CREATE TABLE IF NOT EXISTS pio_access_keys (
                key TEXT PRIMARY KEY,
                app_id INTEGER NOT NULL,
                events TEXT NOT NULL
            )"""
        )

    def insert(self, access_key: AccessKey) -> Optional[str]:
        key = access_key.key or self.generate_key()
        try:
            self._db.execute(
                "INSERT INTO pio_access_keys (key, app_id, events) VALUES (?,?,?)",
                (key, access_key.app_id, json.dumps(list(access_key.events))),
            )
        except sqlite3.IntegrityError:
            return None
        return key

    def _row(self, r: tuple) -> AccessKey:
        return AccessKey(r[0], r[1], tuple(json.loads(r[2])))

    def get(self, key: str) -> Optional[AccessKey]:
        rows = self._db.query(
            "SELECT key, app_id, events FROM pio_access_keys WHERE key=?", (key,)
        )
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[AccessKey]:
        return [self._row(r) for r in self._db.query("SELECT key, app_id, events FROM pio_access_keys")]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [
            self._row(r)
            for r in self._db.query(
                "SELECT key, app_id, events FROM pio_access_keys WHERE app_id=?", (app_id,)
            )
        ]

    def update(self, access_key: AccessKey) -> bool:
        cur = self._db.execute(
            "UPDATE pio_access_keys SET app_id=?, events=? WHERE key=?",
            (access_key.app_id, json.dumps(list(access_key.events)), access_key.key),
        )
        return cur.rowcount > 0

    def delete(self, key: str) -> bool:
        cur = self._db.execute("DELETE FROM pio_access_keys WHERE key=?", (key,))
        return cur.rowcount > 0


class SqliteChannels(ChannelsStore):
    def __init__(self, db: _Db):
        self._db = db
        db.execute(
            """CREATE TABLE IF NOT EXISTS pio_channels (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                name TEXT NOT NULL,
                app_id INTEGER NOT NULL
            )"""
        )

    def insert(self, channel: Channel) -> Optional[int]:
        if not Channel.is_valid_name(channel.name):
            return None
        cur = self._db.execute(
            "INSERT INTO pio_channels (name, app_id) VALUES (?,?)",
            (channel.name, channel.app_id),
        )
        return cur.lastrowid

    def get(self, channel_id: int) -> Optional[Channel]:
        rows = self._db.query("SELECT id, name, app_id FROM pio_channels WHERE id=?", (channel_id,))
        return Channel(*rows[0]) if rows else None

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [
            Channel(*r)
            for r in self._db.query("SELECT id, name, app_id FROM pio_channels WHERE app_id=?", (app_id,))
        ]

    def delete(self, channel_id: int) -> bool:
        cur = self._db.execute("DELETE FROM pio_channels WHERE id=?", (channel_id,))
        return cur.rowcount > 0


_EI_COLS = (
    "id, status, start_time, end_time, engine_id, engine_version, engine_variant, "
    "engine_factory, batch, env, mesh_conf, data_source_params, preparator_params, "
    "algorithms_params, serving_params"
)


class SqliteEngineInstances(EngineInstancesStore):
    def __init__(self, db: _Db):
        self._db = db
        db.execute(
            """CREATE TABLE IF NOT EXISTS pio_engine_instances (
                id TEXT PRIMARY KEY, status TEXT, start_time INTEGER, end_time INTEGER,
                engine_id TEXT, engine_version TEXT, engine_variant TEXT,
                engine_factory TEXT, batch TEXT, env TEXT, mesh_conf TEXT,
                data_source_params TEXT, preparator_params TEXT,
                algorithms_params TEXT, serving_params TEXT
            )"""
        )

    def _to_row(self, i: EngineInstance) -> tuple:
        return (
            i.id, i.status, _us(i.start_time),
            _us(i.end_time) if i.end_time else None,
            i.engine_id, i.engine_version, i.engine_variant, i.engine_factory,
            i.batch, json.dumps(i.env), json.dumps(i.mesh_conf),
            i.data_source_params, i.preparator_params, i.algorithms_params,
            i.serving_params,
        )

    def _from_row(self, r: tuple) -> EngineInstance:
        return EngineInstance(
            id=r[0], status=r[1], start_time=_from_us(r[2]),
            end_time=_from_us(r[3]) if r[3] is not None else None,
            engine_id=r[4], engine_version=r[5], engine_variant=r[6],
            engine_factory=r[7], batch=r[8], env=json.loads(r[9]),
            mesh_conf=json.loads(r[10]), data_source_params=r[11],
            preparator_params=r[12], algorithms_params=r[13], serving_params=r[14],
        )

    def insert(self, instance: EngineInstance) -> str:
        from dataclasses import replace

        instance_id = instance.id or uuid.uuid4().hex
        self._db.execute(
            f"INSERT OR REPLACE INTO pio_engine_instances ({_EI_COLS}) "
            f"VALUES ({','.join('?' * 15)})",
            self._to_row(replace(instance, id=instance_id)),
        )
        return instance_id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        rows = self._db.query(
            f"SELECT {_EI_COLS} FROM pio_engine_instances WHERE id=?", (instance_id,)
        )
        return self._from_row(rows[0]) if rows else None

    def get_all(self) -> list[EngineInstance]:
        return [
            self._from_row(r)
            for r in self._db.query(f"SELECT {_EI_COLS} FROM pio_engine_instances")
        ]

    def update(self, instance: EngineInstance) -> bool:
        if self.get(instance.id) is None:
            return False
        self.insert(instance)
        return True

    def delete(self, instance_id: str) -> bool:
        cur = self._db.execute("DELETE FROM pio_engine_instances WHERE id=?", (instance_id,))
        return cur.rowcount > 0


_EVI_COLS = (
    "id, status, start_time, end_time, evaluation_class, "
    "engine_params_generator_class, batch, env, evaluator_results, "
    "evaluator_results_html, evaluator_results_json"
)


class SqliteEvaluationInstances(EvaluationInstancesStore):
    def __init__(self, db: _Db):
        self._db = db
        db.execute(
            """CREATE TABLE IF NOT EXISTS pio_evaluation_instances (
                id TEXT PRIMARY KEY, status TEXT, start_time INTEGER, end_time INTEGER,
                evaluation_class TEXT, engine_params_generator_class TEXT,
                batch TEXT, env TEXT, evaluator_results TEXT,
                evaluator_results_html TEXT, evaluator_results_json TEXT
            )"""
        )

    def _to_row(self, i: EvaluationInstance) -> tuple:
        return (
            i.id, i.status, _us(i.start_time),
            _us(i.end_time) if i.end_time else None,
            i.evaluation_class, i.engine_params_generator_class, i.batch,
            json.dumps(i.env), i.evaluator_results, i.evaluator_results_html,
            i.evaluator_results_json,
        )

    def _from_row(self, r: tuple) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0], status=r[1], start_time=_from_us(r[2]),
            end_time=_from_us(r[3]) if r[3] is not None else None,
            evaluation_class=r[4], engine_params_generator_class=r[5], batch=r[6],
            env=json.loads(r[7]), evaluator_results=r[8],
            evaluator_results_html=r[9], evaluator_results_json=r[10],
        )

    def insert(self, instance: EvaluationInstance) -> str:
        from dataclasses import replace

        instance_id = instance.id or uuid.uuid4().hex
        self._db.execute(
            f"INSERT OR REPLACE INTO pio_evaluation_instances ({_EVI_COLS}) "
            f"VALUES ({','.join('?' * 11)})",
            self._to_row(replace(instance, id=instance_id)),
        )
        return instance_id

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        rows = self._db.query(
            f"SELECT {_EVI_COLS} FROM pio_evaluation_instances WHERE id=?", (instance_id,)
        )
        return self._from_row(rows[0]) if rows else None

    def get_all(self) -> list[EvaluationInstance]:
        return [
            self._from_row(r)
            for r in self._db.query(f"SELECT {_EVI_COLS} FROM pio_evaluation_instances")
        ]

    def update(self, instance: EvaluationInstance) -> bool:
        if self.get(instance.id) is None:
            return False
        self.insert(instance)
        return True

    def delete(self, instance_id: str) -> bool:
        cur = self._db.execute("DELETE FROM pio_evaluation_instances WHERE id=?", (instance_id,))
        return cur.rowcount > 0


class SqliteModels(ModelsStore):
    def __init__(self, db: _Db):
        self._db = db
        db.execute(
            "CREATE TABLE IF NOT EXISTS pio_models (id TEXT PRIMARY KEY, models BLOB NOT NULL)"
        )

    def insert(self, model: Model) -> None:
        self._db.execute(
            "INSERT OR REPLACE INTO pio_models (id, models) VALUES (?,?)",
            (model.id, model.models),
        )

    def get(self, model_id: str) -> Optional[Model]:
        rows = self._db.query("SELECT id, models FROM pio_models WHERE id=?", (model_id,))
        return Model(rows[0][0], rows[0][1]) if rows else None

    def delete(self, model_id: str) -> bool:
        cur = self._db.execute("DELETE FROM pio_models WHERE id=?", (model_id,))
        return cur.rowcount > 0


class SqliteStorageClient(StorageClient):
    """Serves all three repositories from one sqlite database file.

    Config keys: ``PATH`` (db file; default ``$PIO_FS_BASEDIR/pio.db`` or
    ``~/.pio_store/pio.db``).
    """

    def __init__(self, config: dict[str, str]):
        super().__init__(config)
        path = config.get("PATH")
        if not path:
            base = os.environ.get("PIO_FS_BASEDIR", os.path.expanduser("~/.pio_store"))
            path = os.path.join(base, "pio.db")
        self._db = _Db(path)
        self._apps = SqliteApps(self._db)
        self._access_keys = SqliteAccessKeys(self._db)
        self._channels = SqliteChannels(self._db)
        self._engine_instances = SqliteEngineInstances(self._db)
        self._evaluation_instances = SqliteEvaluationInstances(self._db)
        self._events = SqliteEvents(self._db)
        self._models = SqliteModels(self._db)

    def apps(self) -> AppsStore:
        return self._apps

    def access_keys(self) -> AccessKeysStore:
        return self._access_keys

    def channels(self) -> ChannelsStore:
        return self._channels

    def engine_instances(self) -> EngineInstancesStore:
        return self._engine_instances

    def evaluation_instances(self) -> EvaluationInstancesStore:
        return self._evaluation_instances

    def events(self) -> EventStore:
        return self._events

    def models(self) -> ModelsStore:
        return self._models

    def close(self) -> None:
        self._db.close()
