"""Env-var-driven storage registry.

Counterpart of ``incubator_predictionio_tpu/data/storage/registry.py``: the
same ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` /
``PIO_STORAGE_REPOSITORIES_<REPO>_{NAME,SOURCE}`` surface, resolved the same
way. The ``memory``, ``sqlite`` and ``eventlog`` backends are ported; a
source of any other type raises :class:`StorageError` naming what is
registered (the network and cloud backends come with ROADMAP.md Queue 1
item 7).
With no storage configuration at all, every repository is sqlite under
``$PIO_FS_BASEDIR``, as in the reference.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Callable, Optional

from incubator_predictionio_tpu_torch.data.storage.base import (
    AccessKeysStore,
    AppsStore,
    ChannelsStore,
    EngineInstancesStore,
    EvaluationInstancesStore,
    EventStore,
    ModelsStore,
    StorageClient,
    StorageError,
)
from incubator_predictionio_tpu_torch.data.storage.eventlog_backend import (
    EventLogStorageClient,
)
from incubator_predictionio_tpu_torch.data.storage.memory import (
    MemoryStorageClient,
)
from incubator_predictionio_tpu_torch.data.storage.sqlite_backend import (
    SqliteStorageClient,
)

logger = logging.getLogger(__name__)

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")

#: type name -> StorageClient factory
BACKEND_TYPES: dict[str, Callable[[dict[str, str]], StorageClient]] = {
    "memory": MemoryStorageClient,
    "sqlite": SqliteStorageClient,
    "eventlog": EventLogStorageClient,
}

_SOURCE_RE = re.compile(r"^PIO_STORAGE_SOURCES_([^_]+)_(.+)$")
_REPO_RE = re.compile(r"^PIO_STORAGE_REPOSITORIES_([^_]+)_(NAME|SOURCE)$")


class Storage:
    """One resolved storage configuration: sources + repository bindings.
    Instantiate via :func:`get_storage` or directly with an env dict."""

    def __init__(self, env: Optional[dict[str, str]] = None):
        self._env = dict(env) if env is not None else dict(os.environ)
        self._lock = threading.RLock()
        self._clients: dict[str, StorageClient] = {}
        self._sources = self._parse_sources()
        self._repos = self._parse_repositories()

    def _parse_sources(self) -> dict[str, dict[str, str]]:
        sources: dict[str, dict[str, str]] = {}
        for key, value in self._env.items():
            m = _SOURCE_RE.match(key)
            if m:
                sources.setdefault(m.group(1), {})[m.group(2)] = value
        if not sources:
            sources["DEFAULT"] = {"TYPE": "sqlite"}
        return sources

    def _parse_repositories(self) -> dict[str, tuple[str, str]]:
        repos: dict[str, dict[str, str]] = {}
        for key, value in self._env.items():
            m = _REPO_RE.match(key)
            if m:
                repos.setdefault(m.group(1), {})[m.group(2)] = value
        out: dict[str, tuple[str, str]] = {}
        for repo in REPOSITORIES:
            cfg = repos.get(repo, {})
            name = cfg.get("NAME", f"pio_{repo.lower()}")
            source = cfg.get("SOURCE")
            if source is None:
                source = next(iter(self._sources))
            if source not in self._sources:
                raise StorageError(
                    f"repository {repo} references undefined source {source}; "
                    f"defined sources: {sorted(self._sources)}"
                )
            out[repo] = (name, source)
        return out

    def _client_for(self, repo: str) -> StorageClient:
        _, source = self._repos[repo]
        with self._lock:
            if source not in self._clients:
                cfg = self._sources[source]
                type_name = cfg.get("TYPE")
                if type_name not in BACKEND_TYPES:
                    raise StorageError(
                        f"unknown storage backend type {type_name!r} for source {source}; "
                        f"registered: {sorted(BACKEND_TYPES)}"
                    )
                logger.info("storage: opening source %s (type=%s)", source, type_name)
                self._clients[source] = BACKEND_TYPES[type_name](cfg)
            return self._clients[source]

    def get_meta_data_apps(self) -> AppsStore:
        return self._client_for("METADATA").apps()

    def get_meta_data_access_keys(self) -> AccessKeysStore:
        return self._client_for("METADATA").access_keys()

    def get_meta_data_channels(self) -> ChannelsStore:
        return self._client_for("METADATA").channels()

    def get_meta_data_engine_instances(self) -> EngineInstancesStore:
        return self._client_for("METADATA").engine_instances()

    def get_meta_data_evaluation_instances(self) -> EvaluationInstancesStore:
        return self._client_for("METADATA").evaluation_instances()

    def get_events(self) -> EventStore:
        """The EVENTDATA store (both the L and P read paths of the reference)."""
        return self._client_for("EVENTDATA").events()

    def get_model_data_models(self) -> ModelsStore:
        return self._client_for("MODELDATA").models()

    def close(self) -> None:
        with self._lock:
            for c in self._clients.values():
                c.close()
            self._clients.clear()


_storage_singleton: Optional[Storage] = None
_singleton_lock = threading.Lock()


def get_storage() -> Storage:
    """Process-wide Storage honoring ``os.environ`` (reference Storage object)."""
    global _storage_singleton
    with _singleton_lock:
        if _storage_singleton is None:
            _storage_singleton = Storage()
        return _storage_singleton


def use_storage(storage: Optional[Storage]) -> Optional[Storage]:
    """Install an explicit Storage as the process singleton; returns the
    previous one. Pass None to reset."""
    global _storage_singleton
    with _singleton_lock:
        prev, _storage_singleton = _storage_singleton, storage
        return prev


def storage_env_vars(env: Optional[dict[str, str]] = None) -> dict[str, str]:
    """The PIO_* env subset an engine instance records (reference
    Runner.pioEnvVars, Runner.scala:217-219)."""
    env = env if env is not None else dict(os.environ)
    return {k: v for k, v in env.items() if k.startswith("PIO_")}
