"""Deployment store: oauth_key → engine endpoints.

Reference: ``api-frontend/.../deployments/DeploymentStore.java:30-60`` — an
in-memory map from oauth_key to DeploymentSpec, kept fresh by the CRD watch
(``k8s/DeploymentWatcher.java:183-184``, @Scheduled 5 s).  Here the store is
fed either programmatically (tests, embedded use), from a config file that a
``refresh()`` poll re-reads (the watch analog), or by the operator runtime.

Port of ``seldon_core_tpu/gateway/store.py``: the same names, bodies and
behaviour, on the standard library.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Optional

logger = logging.getLogger(__name__)


@dataclass
class DeploymentRecord:
    name: str
    oauth_key: str
    oauth_secret: str
    engine_url: str = ""          # REST base, e.g. http://dep-name:8000
    engine_grpc: str = ""         # gRPC target, e.g. dep-name:5001
    annotations: dict = field(default_factory=dict)
    # fleet plane (docs/scale-out.md): every engine replica's REST base.
    # With one entry (or empty) the record behaves exactly as before —
    # engine_url stays the single source of truth for N=1 callers.
    engine_urls: tuple = ()

    def __post_init__(self):
        self.engine_urls = tuple(self.engine_urls)
        if self.engine_urls and not self.engine_url:
            self.engine_url = self.engine_urls[0]

    @property
    def urls(self) -> tuple:
        """Every engine replica URL (fleet members), falling back to the
        single ``engine_url`` — callers route over this, never both."""
        if self.engine_urls:
            return self.engine_urls
        return (self.engine_url,) if self.engine_url else ()


class DeploymentStore:
    def __init__(self, config_path: Optional[str] = None):
        self._by_key: dict[str, DeploymentRecord] = {}
        self._by_name: dict[str, DeploymentRecord] = {}
        self._lock = threading.Lock()
        self._config_path = config_path
        self._config_mtime = 0.0
        if config_path:
            self.refresh()

    # -- mutation (watch events) ----------------------------------------
    def put(self, rec: DeploymentRecord) -> None:
        with self._lock:
            old = self._by_name.get(rec.name)
            if old is not None and old.oauth_key != rec.oauth_key:
                self._by_key.pop(old.oauth_key, None)
            self._by_name[rec.name] = rec
            if rec.oauth_key:
                self._by_key[rec.oauth_key] = rec

    def remove(self, name: str) -> Optional[DeploymentRecord]:
        with self._lock:
            rec = self._by_name.pop(name, None)
            if rec is not None:
                self._by_key.pop(rec.oauth_key, None)
            return rec

    # -- lookup ----------------------------------------------------------
    def by_oauth_key(self, key: str) -> Optional[DeploymentRecord]:
        with self._lock:
            return self._by_key.get(key)

    def by_name(self, name: str) -> Optional[DeploymentRecord]:
        with self._lock:
            return self._by_name.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._by_name)

    # -- config-file source (the poll-watch analog) ----------------------
    def refresh(self) -> bool:
        """Re-read the config file if it changed.  Format:

        .. code-block:: json

            {"deployments": [{"name": "...", "oauth_key": "...",
                              "oauth_secret": "...", "engine_url": "...",
                              "engine_urls": ["...", "..."],
                              "engine_grpc": "..."}]}

        ``engine_urls`` (optional) lists every engine replica for the
        fleet plane; ``engine_url`` alone keeps the single-replica shape.
        """
        path = self._config_path
        if not path or not os.path.exists(path):
            return False
        mtime = os.path.getmtime(path)
        if mtime == self._config_mtime:
            return False
        with open(path) as f:
            cfg = json.load(f)
        seen = set()
        for d in cfg.get("deployments", []):
            rec = DeploymentRecord(
                name=d["name"],
                oauth_key=d.get("oauth_key", ""),
                oauth_secret=d.get("oauth_secret", ""),
                engine_url=d.get("engine_url", ""),
                engine_urls=tuple(d.get("engine_urls", ()) or ()),
                engine_grpc=d.get("engine_grpc", ""),
                annotations=dict(d.get("annotations", {})),
            )
            self.put(rec)
            seen.add(rec.name)
        for name in self.names():
            if name not in seen:
                self.remove(name)
        self._config_mtime = mtime
        logger.info("deployment store refreshed: %s", self.names())
        return True
