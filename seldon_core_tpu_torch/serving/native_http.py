"""Native wire tier: an asyncio bridge over the C++ HTTP/1.1 server (port
of the REST half of ``seldon_core_tpu/serving/native_http.py``).

:class:`NativeRestServer` puts the native epoll server
(``native/httpserver.cc``, built by :mod:`seldon_core_tpu_torch.native`)
in front of a :class:`~seldon_core_tpu_torch.serving.rest.RestServer`'s
route and stream tables: protocol bytes never touch the interpreter, and
each request crosses into Python once, as a ``rest.Request`` that the
Python tier's handlers answer.  So the two tiers serve the same routes with
the same bodies, status codes and metrics, and, given one ``RestServer``,
share its state: after ``/pause`` on either, predictions, the stream and
``/ready`` answer 503 on both.  Server-sent events go out with chunked
transfer encoding.  The bridge runs every handler on the caller's asyncio
loop, so engines, components, metrics and the dynamic batcher behave as
they do behind the Python tier.  The C server writes every answer as
``application/json`` and sends no ``Retry-After``.

The native gRPC server (``NativeGrpcServer``) waits for slice 4a-ii of the
port.
"""

from __future__ import annotations

import asyncio
import logging
import sys
from collections import deque
from typing import Awaitable, Callable, Optional

from seldon_core_tpu_torch.native import NativeHttpServer
from seldon_core_tpu_torch.serving.rest import (
    _EMPTY,
    EventStream,
    Request,
    RestServer,
    _err_json,
    _error_event,
)

logger = logging.getLogger(__name__)

__all__ = ["NativeRestServer"]

#: asyncio.Task(eager_start=) landed in 3.12
_EAGER_TASKS = sys.version_info >= (3, 12)


class _AsyncBridge:
    """Pumps native-server submissions onto an asyncio loop and completions
    back.  One instance per server."""

    def __init__(
        self,
        router: Callable[[str, str, bytes], Awaitable[object]],
        port: int = 0,
        bind: str = "0.0.0.0",
        reuseport: bool = False,
    ):
        self._router = router
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._tasks: set = set()
        # submission batching: under load the IO thread delivers many
        # requests per loop iteration; one deque + one scheduled drain
        # amortizes call_soon_threadsafe's lock + self-pipe wakeup
        # (~2-3 us + a syscall each) across the burst instead of paying
        # it per request
        self._inbox: deque = deque()
        self._drain_scheduled = False
        self.server = NativeHttpServer(
            submit=self._submit, http2=False, port=port, bind=bind,
            reuseport=reuseport,
        )

    # IO thread (GIL held by ctypes) — enqueue and return immediately
    def _submit(self, token: int, method: str, path: str, body: bytes) -> None:
        self._inbox.append((token, method, path, body))
        if not self._drain_scheduled:
            # benign race: a concurrent drain may consume the item and
            # leave the extra scheduled drain a no-op; the flag only
            # bounds wakeups, it never gates correctness (deque ops are
            # GIL-atomic, and the flag clears BEFORE the drain loop runs
            # so an append after the clear always re-schedules)
            self._drain_scheduled = True
            self._loop.call_soon_threadsafe(self._drain)

    def _drain(self) -> None:
        self._drain_scheduled = False
        inbox = self._inbox
        while inbox:
            token, method, path, body = inbox.popleft()
            self._spawn(token, method, path, body)

    def _spawn(self, token: int, method: str, path: str, body: bytes) -> None:
        # EAGER task start (3.12 stdlib): the handler runs synchronously
        # inside real task context until its first true suspension, so
        # non-suspending handlers (in-process engines) skip the
        # schedule/wakeup round trip.  A hand-rolled inline coro.send
        # fast path measured ~+27% gRPC throughput but breaks
        # current_task()-dependent handler code (asyncio.timeout /
        # wait_for raise outside a task on 3.12) — eager tasks keep the
        # semantics; the measured win is within run-to-run noise, the
        # Task allocation dominating what remains.  eager_start only
        # exists on 3.12+; older runtimes take the ordinary scheduled
        # task (one extra loop wakeup, same semantics).
        if _EAGER_TASKS:
            t = asyncio.Task(
                self._run(token, method, path, body),
                loop=self._loop, eager_start=True,
            )
        else:
            t = self._loop.create_task(
                self._run(token, method, path, body))
        if not t.done():
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)

    async def _run(self, token, method, path, body) -> None:
        """Answer one request: the router gives ``(status, body)`` or an
        async iterator of stream chunks."""
        try:
            result = await self._router(method, path, body)
        except Exception as e:  # router bug: fail the request, keep serving
            logger.exception("native bridge handler failed (%s)", path)
            result = (500, _err_json(500, f"{type(e).__name__}: {e}"))
        if isinstance(result, tuple):
            self.server.complete(token, result[0], result[1], None)
            return
        # chunks for a stream the client reset are dropped by the C side;
        # the stream's own length (an LLM's n_new) bounds the wasted work
        try:
            async for chunk in result:
                self.server.stream_chunk(token, chunk)
        finally:
            self.server.stream_end(token, 0, None)
            await result.aclose()

    async def start(self) -> int:
        self._loop = asyncio.get_running_loop()
        self.server.start()
        return self.server.port

    async def stop(self) -> None:
        self.server.stop()
        for t in list(self._tasks):
            t.cancel()

    @property
    def port(self) -> int:
        return self.server.port


class NativeRestServer:
    """The routes of ``rest`` (a :class:`RestServer`, started or not) over
    the native HTTP/1.1 server.  Without ``rest``, the server builds its
    own over ``engine`` and ``component``, as ``RestServer`` does."""

    def __init__(self, engine=None, component=None, metrics=None,
                 port: int = 0, bind: str = "0.0.0.0",
                 reuseport: bool = False, rest: Optional[RestServer] = None):
        self._owns_rest = rest is None
        self.rest = rest or RestServer(engine, component=component,
                                       metrics=metrics)
        self._bridge = _AsyncBridge(self._route, port=port, bind=bind,
                                    reuseport=reuseport)

    async def _route(self, method: str, path: str, body: bytes):
        out = await self.rest.dispatch(
            Request(method, path, {}, body, self.rest))
        if isinstance(out, EventStream):
            return _chunks(out)
        return (out.code, out.body)

    async def start(self) -> int:
        return await self._bridge.start()

    async def stop(self) -> None:
        await self._bridge.stop()
        if self._owns_rest:
            await self.rest.stop()

    @property
    def port(self) -> int:
        return self._bridge.port


async def _chunks(stream: EventStream):
    """``stream``'s server-sent events as the native server's chunks; a
    failure mid-stream sends an ``error`` event and ends the stream, as
    the Python tier does."""
    code = None
    try:
        if stream.first is not _EMPTY:
            yield stream.encode(stream.first)
            async for event in stream.agen:
                yield stream.encode(event)
        code = 200
    except asyncio.CancelledError:
        code = 499
        raise
    except Exception as e:
        logger.exception("native stream failed (%s)", stream.name)
        code = 500
        yield _error_event(e)
    finally:
        await stream.end(code)
