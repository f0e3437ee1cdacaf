"""Request QoS context: priority class and deadline (port of
``seldon_core_tpu/qos/context.py``).

One request's QoS facts ride three channels, and every layer reads the
one it can reach and restamps the others:

- **wire hops**: the headers ``X-Seldon-Priority`` and
  ``X-Seldon-Deadline-Ms`` (the *remaining* budget in milliseconds at send
  time, so no clocks need to agree); gRPC metadata carries the same keys
  in lower case;
- **message hops** (engine to a remote node): ``meta.tags`` ``priority``
  and ``deadline-ms``;
- **in-process call stacks** (engine walk, dynamic batcher): a
  :data:`contextvars.ContextVar`, which asyncio tasks inherit at creation.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Mapping, Optional

__all__ = ["PRIORITIES", "PRIORITY_HEADER", "PRIORITY_TAG", "DEADLINE_HEADER",
           "DEADLINE_TAG", "DEGRADED_TAG", "Deadline", "QosContext",
           "current_qos", "qos_scope", "qos_from_headers", "qos_from_meta",
           "stamp_meta", "forward_headers", "priority_rank"]

PRIORITY_HEADER = "X-Seldon-Priority"
DEADLINE_HEADER = "X-Seldon-Deadline-Ms"
PRIORITY_TAG = "priority"
DEADLINE_TAG = "deadline-ms"
#: stamped on answers of the ``seldon.io/qos-fallback`` subgraph
DEGRADED_TAG = "degraded"

#: shedding order: the lowest rank sheds first
PRIORITIES = ("low", "normal", "high")
_RANK = {p: i for i, p in enumerate(PRIORITIES)}
DEFAULT_PRIORITY = "normal"


def priority_rank(priority: str) -> int:
    return _RANK.get(priority, _RANK[DEFAULT_PRIORITY])


def _parse_priority(raw: Any) -> str:
    p = str(raw or "").strip().lower()
    return p if p in _RANK else DEFAULT_PRIORITY


@dataclass(frozen=True)
class Deadline:
    """A request deadline as a ``time.monotonic()`` instant (the asyncio
    loop's clock)."""

    expires_at: float

    @classmethod
    def after_ms(cls, budget_ms: float) -> "Deadline":
        return cls(time.monotonic() + max(float(budget_ms), 0.0) / 1000.0)

    def remaining_s(self) -> float:
        return max(self.expires_at - time.monotonic(), 0.0)

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1000.0

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at


@dataclass(frozen=True)
class QosContext:
    priority: str = DEFAULT_PRIORITY
    deadline: Optional[Deadline] = None

    @property
    def rank(self) -> int:
        return priority_rank(self.priority)


_current: contextvars.ContextVar[Optional[QosContext]] = \
    contextvars.ContextVar("qos_request_context", default=None)


def current_qos() -> Optional[QosContext]:
    """The ambient context (None outside any request scope)."""
    return _current.get()


@contextmanager
def qos_scope(ctx: Optional[QosContext]):
    """Bind ``ctx`` for the enclosed block; ``None`` leaves the ambient
    context as it is, so callers may wrap unconditionally."""
    if ctx is None:
        yield
        return
    token = _current.set(ctx)
    try:
        yield
    finally:
        _current.reset(token)


def _parse_budget_ms(raw: Any) -> Optional[float]:
    try:
        v = float(str(raw).strip())
    except (TypeError, ValueError):
        return None
    return v if v > 0 else 0.0


def _context(raw_p: Any, raw_d: Any) -> Optional[QosContext]:
    if raw_p is None and raw_d is None:
        return None
    deadline = None
    if raw_d is not None:
        budget = _parse_budget_ms(raw_d)
        if budget is not None:
            deadline = Deadline.after_ms(budget)
    return QosContext(priority=_parse_priority(raw_p), deadline=deadline)


def _header(headers: Mapping[str, str], name: str) -> Optional[str]:
    v = headers.get(name)
    return headers.get(name.lower()) if v is None else v


def qos_from_headers(headers: Mapping[str, str]) -> Optional[QosContext]:
    """The context of wire headers (or gRPC metadata: lower-case keys);
    None when neither QoS header is set, so the plain path stays as it
    is."""
    return _context(_header(headers, PRIORITY_HEADER),
                    _header(headers, DEADLINE_HEADER))


def qos_from_meta(meta: Any) -> Optional[QosContext]:
    """The context of a message's ``meta.tags`` (the message channel)."""
    tags = getattr(meta, "tags", None) or {}
    return _context(tags.get(PRIORITY_TAG), tags.get(DEADLINE_TAG))


def stamp_meta(meta: Any, ctx: QosContext) -> None:
    """Restamp ``ctx`` onto ``meta.tags`` for the next hop; the deadline as
    the remaining budget, so every hop's stamp shrinks."""
    meta.tags[PRIORITY_TAG] = ctx.priority
    if ctx.deadline is not None:
        meta.tags[DEADLINE_TAG] = round(ctx.deadline.remaining_ms(), 3)


def forward_headers(ctx: QosContext) -> dict:
    """The headers of the next wire hop (the budget remaining at send)."""
    out = {PRIORITY_HEADER: ctx.priority}
    if ctx.deadline is not None:
        out[DEADLINE_HEADER] = f"{ctx.deadline.remaining_ms():.3f}"
    return out
