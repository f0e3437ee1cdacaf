"""Shared utilities: metrics, tracing, the YAML reader, analytics."""

from __future__ import annotations

import inspect
from typing import Any


async def maybe_await(x: Any) -> Any:
    """Await ``x`` if it is awaitable, else return it: components may be
    sync (``ComponentHandle``) or async (``BatchedModel``,
    ``LLMComponent``, ``RemoteComponent``) with the same method surface."""
    if inspect.isawaitable(x):
        return await x
    return x
