"""Single-flight table: coalesce concurrent identical work onto one future
(port of ``seldon_core_tpu/caching/singleflight.py``).

N identical requests arriving while the first ("leader") is still
computing all await the leader's future — one model invocation, N
responses.  Composes with the dynamic batcher naturally: the leader puts
ONE row into the batch, so a coalesced group costs one batch row instead
of N duplicate rows.

Failure semantics: a leader error propagates to every follower and is
never cached; the table entry is removed either way, so the next arrival
retries cold.  (The Go ``singleflight`` package shape, minus forgotten
keys — asyncio is single-threaded so the dict needs no lock.)
"""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable

__all__ = ["SingleFlight"]


class SingleFlight:
    def __init__(self):
        self._inflight: dict[str, asyncio.Future] = {}

    def leader_count(self) -> int:
        return len(self._inflight)

    async def run(
        self, key: str, compute: Callable[[], Awaitable[Any]]
    ) -> tuple[Any, bool]:
        """``(result, coalesced)`` — ``coalesced`` True when this caller
        rode an already-in-flight computation instead of starting one."""
        fut = self._inflight.get(key)
        if fut is not None:
            return await fut, True
        fut = asyncio.get_running_loop().create_future()
        # leader path: probe -> insert with NO await between them (the
        # await above is on the follower's return branch), so the
        # check-then-act is atomic on the event loop
        self._inflight[key] = fut  # graphlint: disable=RL601
        try:
            result = await compute()
        except BaseException as e:
            if not fut.cancelled():
                fut.set_exception(e)
                # mark retrieved: with zero followers the orphan exception
                # would otherwise warn at GC time
                fut.exception()
            raise
        else:
            if not fut.cancelled():
                fut.set_result(result)
            return result, False
        finally:
            self._inflight.pop(key, None)
