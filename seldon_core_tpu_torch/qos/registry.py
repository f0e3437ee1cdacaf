"""Process-local QoS registry (port of ``seldon_core_tpu/qos/registry.py``):
each deployment's runner publishes a snapshot provider of its live QoS
state under the deployment's name; :func:`snapshot` reads it (None when no
runtime of this process serves the deployment, or its provider fails)."""

from __future__ import annotations

import threading
from typing import Callable, Optional

__all__ = ["publish", "unpublish", "snapshot", "clear"]

_lock = threading.Lock()
_providers: dict[str, Callable[[], dict]] = {}


def publish(deployment: str, provider: Callable[[], dict]) -> None:
    with _lock:
        _providers[deployment] = provider


def unpublish(deployment: str) -> None:
    with _lock:
        _providers.pop(deployment, None)


def snapshot(deployment: str) -> Optional[dict]:
    with _lock:
        provider = _providers.get(deployment)
    if provider is None:
        return None
    try:
        return provider()
    except Exception:
        return None


def clear() -> None:
    """Forget every provider (tests)."""
    with _lock:
        _providers.clear()
