"""Worker processes on one port (``SO_REUSEPORT``) (port of
``seldon_core_tpu/serving/workers.py``).

CPython serves one core per process, so the serving tiers scale on a host
by kernel socket sharding: N worker processes bind the same port with
``SO_REUSEPORT`` and the kernel spreads connections among them, with no
proxy and no shared state.  Every tier can: the REST server
(``RestServer(reuse_port=True)``), the native REST and gRPC tiers
(``reuseport=True``) and the ``grpc.aio`` server (``GrpcServer(
reuse_port=True)``).  Each worker is a whole process with its own engine,
its own CUDA context and its own copy of the weights; each serves its own
``/metrics``.

:func:`fork_workers` must run before the process touches CUDA
(``torch.cuda.is_available()`` initializes CUDA), before ``grpc``
makes a channel or a server, and before the native library starts an IO
thread: a forked child inherits none of those in a usable state.
:class:`WorkerPool` spawns fresh interpreters instead, for callers that
have already done any of that.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from typing import Callable, Optional

__all__ = ["fork_workers", "WorkerPool", "pick_free_port", "alive"]


def pick_free_port(host: str = "127.0.0.1") -> int:
    """A port that was free a moment ago, for a group of workers to bind
    with ``SO_REUSEPORT`` (they bind it at once; the small race is
    accepted)."""
    import socket

    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def fork_workers(n: int) -> int:
    """Fork ``n`` workers; each child returns its index, and the calling
    process becomes their supervisor and never returns: it exits when the
    group stops.  Fail-fast: when one worker exits, the supervisor stops
    the others (SIGTERM) and reaps them all; restarts are the
    orchestrator's.  SIGTERM or SIGINT to the supervisor stops the group
    too."""
    if n <= 1:
        return 0
    pids = []
    for i in range(n):
        pid = os.fork()
        if pid == 0:
            return i
        pids.append(pid)

    def _term(*_sig) -> None:
        for p in pids:
            try:
                os.kill(p, signal.SIGTERM)
            except ProcessLookupError:
                pass

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        os.waitpid(-1, 0)  # the first exit, a crash or a stop ...
    except ChildProcessError:
        pass
    _term()  # ... stops the whole group
    for p in pids:
        try:
            os.waitpid(p, 0)
        except ChildProcessError:
            continue  # reaped already
    sys.exit(0)


def _boot_child(boot: Callable[[int], None], i: int) -> None:
    """A spawned worker's entry (module level, so it pickles)."""
    try:
        boot(i)
    except KeyboardInterrupt:
        pass


class WorkerPool:
    """Runs ``boot(worker_index)`` (blocking, picklable) in each of ``n``
    spawned processes.  Spawn, not fork: callers of the pool (tests,
    tools) may already hold CUDA, grpc or native threads.  A server in
    ``boot`` binds a fixed port with ``SO_REUSEPORT``
    (:func:`pick_free_port`); the parent stays free."""

    def __init__(self, boot: Callable[[int], None], n: int):
        self.boot = boot
        self.n = n
        self.procs: list = []

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self.procs if p.pid is not None]

    def start(self) -> "WorkerPool":
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        for i in range(self.n):
            p = ctx.Process(target=_boot_child, args=(self.boot, i))
            p.start()
            self.procs.append(p)
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.05))
            if p.is_alive():
                p.kill()
                p.join(timeout_s)
        self.procs.clear()

    def __enter__(self) -> "WorkerPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def alive(pool: Optional[WorkerPool]) -> int:
    """How many of the pool's workers are running."""
    if pool is None:
        return 0
    return sum(1 for p in pool.procs if p.is_alive())
