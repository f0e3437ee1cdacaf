"""Server-side dynamic batching (port of the plain path of
``seldon_core_tpu/runtime/batcher.py``).

Queue, pad to a bucket, one device call per batch, split:

- Requests are grouped into lanes by (trailing shape, dtype); a lane packs
  the rows of many requests along axis 0, pads them up to a bucket of the
  ladder (powers of two up to ``max_batch_size``, :func:`default_buckets`)
  with rows of zeros, and hands every caller its own rows.  A lane
  flushes when it holds ``max_batch_size`` rows or ``max_delay_ms`` after
  its first request.
- ``materialize="host"``: one device-to-host copy per batch, in an executor
  thread, and callers get numpy views of their rows; at most
  ``max_inflight`` batches are between dispatch and that copy.
  ``materialize="device"``: callers get slices of the output tensor where
  it lies (an ensemble's members feeding a combiner on the card).
- Backpressure: more than ``max_queue_rows`` rows pending in a lane raise
  :class:`QueueFullError` (429); requests queued longer than
  ``shed_after_ms`` are shed at flush time with
  :class:`DeadlineExceededError` (504).

- QoS deadlines (``qos.context``: the contextvar the engine binds from
  ``X-Seldon-Deadline-Ms`` or the message's tags): a request with a
  deadline queues earliest-deadline-first, ahead of requests without one
  (which stay first-in first-out), and a request whose remaining budget
  cannot cover the batcher's observed batch latency (an EWMA of dispatch
  to delivery) is rejected with 504 when it reaches the head of the queue,
  before it costs a device call.

``fn(batch)`` returns ``(batch_out, aux)``, ``batch_out`` row-aligned with
``batch``; every caller gets ``(rows, aux)`` of its own batch.  It runs on the
event loop; on the card it returns as soon as the kernels are queued.  A
fused segment (``graph/plan.py``) is such an ``fn``: it replays a CUDA graph
and hands back a clone of the graph's static output made on the same
stream, so the next replay cannot overwrite a batch whose host copy is still
pending.
``stats`` counts batches, rows, pad rows and sheds; ``shed_reasons`` splits
the sheds by reason (``queue_full``, ``deadline``, ``budget``).  ``metrics``
(a ``MetricsRegistry``) gets the reference's series:
``seldon_batcher_batch_rows``, ``seldon_batcher_batches_total``,
``seldon_batcher_pad_rows_total`` and ``seldon_batcher_shed_total`` by
reason.

Tracing: with a ``tracer`` set (the engine sets its own on a segment's
batcher), every dispatched batch is a root span of its own
(``batch:<name>``: rows, bucket, requests, pad rows) **linked** to each
member request's span, whose context was captured when the request was
queued (links, not parenthood: one batch serves many traces, and the
flush timer runs outside any request's context).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.qos.context import current_qos
from seldon_core_tpu_torch.runtime.component import SeldonComponentError
from seldon_core_tpu_torch.utils.tracing import current_trace

__all__ = ["QueueFullError", "DeadlineExceededError", "default_buckets",
           "BatcherConfig", "DynamicBatcher", "BatchedModel"]


class QueueFullError(SeldonComponentError):
    """Batcher queue at capacity: shed with HTTP 429."""

    def __init__(self, message: str):
        super().__init__(message, status_code=429, reason="QUEUE_FULL")


class DeadlineExceededError(SeldonComponentError):
    """Request aged out of the batch queue: shed with HTTP 504."""

    def __init__(self, message: str):
        super().__init__(message, status_code=504, reason="DEADLINE_EXCEEDED")


def default_buckets(max_batch: int) -> list[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


@dataclass
class BatcherConfig:
    max_batch_size: int = 64
    max_delay_ms: float = 2.0     # the longest the first request waits
    name: str = "batcher"
    materialize: str = "host"     # "host" | "device"
    # pending-row cap per lane; None -> 32 * max_batch_size; 0 -> unbounded
    max_queue_rows: Optional[int] = None
    shed_after_ms: float = 0.0    # 0 -> never
    max_inflight: int = 4         # host mode only; 0 -> unbounded


@dataclass
class _Pending:
    array: Any
    nrows: int
    future: asyncio.Future = field(compare=False, default=None)
    t_enqueue: float = 0.0
    deadline: Optional[float] = None  # QoS expiry on the loop's clock
    # the trace context at enqueue (TraceContext or None): the batch span
    # links to it
    tctx: Optional[Any] = None


def _qos_deadline() -> Optional[float]:
    """The ambient QoS deadline as a ``time.monotonic()`` instant (the
    asyncio loop's clock), or None."""
    ctx = current_qos()
    if ctx is None or ctx.deadline is None:
        return None
    return ctx.deadline.expires_at


class _Lane:
    """One (trailing shape, dtype) lane with its own queue."""

    def __init__(self):
        self.pending: list[_Pending] = []
        self.pending_rows = 0
        self.flush_handle: Optional[asyncio.Handle] = None


def _fetch_host(out: Any) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class DynamicBatcher:
    """Coalesces concurrent ``await batcher(X)`` calls into batched
    ``fn(batch) -> (batch_out, aux)`` calls; each caller gets ``(rows, aux)``."""

    max_lanes = 64

    def __init__(self, fn: Callable[[Any], tuple[Any, Any]],
                 config: Optional[BatcherConfig] = None, metrics=None):
        self.fn = fn
        self.metrics = metrics
        self.config = config or BatcherConfig()
        self.buckets = default_buckets(self.config.max_batch_size)
        if self.config.materialize not in ("host", "device"):
            raise ValueError(f"materialize must be 'host' or 'device', got "
                             f"{self.config.materialize!r}")
        self.max_queue_rows = (32 * self.config.max_batch_size
                               if self.config.max_queue_rows is None
                               else self.config.max_queue_rows)
        self._lanes: dict[tuple, _Lane] = {}
        self._inflight = 0
        self._slot_waiters: list[asyncio.Future] = []
        # what went through: batches dispatched, real rows, pad rows, sheds
        self.stats = {"batches": 0, "rows": 0, "pad_rows": 0, "shed": 0}
        self.shed_reasons = {"queue_full": 0, "deadline": 0, "budget": 0}
        # EWMA of dispatch-to-delivery seconds: what a queued request's
        # remaining budget must cover (0 until a batch has completed)
        self.latency_ewma_s = 0.0
        # set by the owning engine: one span per dispatched batch
        self.tracer = None
        self._batch_seq = 0

    def bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def warmup(self, example_row: Any) -> None:
        """Run ``fn`` once at every bucket size and wait for it, so the
        first-use costs of each batch shape (on the card: cuDNN's choice of
        algorithm, the allocator's first blocks) come before traffic."""
        row = np.asarray(example_row)
        for b in self.buckets:
            out, _ = self.fn(np.array(np.broadcast_to(row, (b,) + row.shape)))
            _fetch_host(out)

    async def __call__(self, X: Any) -> Any:
        arr = X if hasattr(X, "shape") else np.asarray(X)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        nrows = int(arr.shape[0])
        loop = asyncio.get_running_loop()
        if nrows > self.config.max_batch_size:
            # an oversized request runs alone, unbatched, but still takes an
            # in-flight slot
            acquired = await self._acquire_slot()
            try:
                out, aux = self.fn(arr)
                if self.config.materialize == "device":
                    return out, aux
                return await loop.run_in_executor(None, _fetch_host,
                                                  out), aux
            finally:
                if acquired:
                    self._release_slot()
        key = (tuple(arr.shape[1:]), str(arr.dtype),
               str(arr.device) if isinstance(arr, torch.Tensor) else "host")
        lane = self._lanes.get(key)
        if lane is None:
            if len(self._lanes) >= self.max_lanes:
                # evict an idle lane so varied shapes cannot grow the table
                for k, ln in list(self._lanes.items()):
                    if not ln.pending and ln.flush_handle is None:
                        del self._lanes[k]
                        break
            lane = self._lanes[key] = _Lane()
        if (self.max_queue_rows
                and lane.pending_rows + nrows > self.max_queue_rows):
            self._count_shed("queue_full")
            raise QueueFullError(
                f"batcher {self.config.name!r} queue full "
                f"({lane.pending_rows} rows pending, cap "
                f"{self.max_queue_rows})")
        fut: asyncio.Future = loop.create_future()
        self._edf_insert(lane, _Pending(arr, nrows, fut,
                                        t_enqueue=loop.time(),
                                        deadline=_qos_deadline(),
                                        tctx=current_trace()))
        lane.pending_rows += nrows
        if lane.pending_rows >= self.config.max_batch_size:
            self._flush(lane)
        elif lane.flush_handle is None:
            lane.flush_handle = loop.call_later(
                self.config.max_delay_ms / 1000.0, self._flush, lane)
        return await fut

    @staticmethod
    def _edf_insert(lane: _Lane, p: _Pending) -> None:
        """Earliest deadline first: a request with a deadline goes before
        every later deadline and every request without one; ties and the
        requests without a deadline stay in arrival order."""
        if p.deadline is not None:
            for i, q in enumerate(lane.pending):
                if q.deadline is None or q.deadline > p.deadline:
                    lane.pending.insert(i, p)
                    return
        lane.pending.append(p)

    def _count_shed(self, reason: str) -> None:
        self.stats["shed"] += 1
        self.shed_reasons[reason] += 1
        if self.metrics is not None:
            self.metrics.counter_inc(
                "seldon_batcher_shed_total",
                {"batcher": self.config.name, "reason": reason})

    def _shed(self, p: _Pending, reason: str, message: str) -> None:
        self._count_shed(reason)
        if not p.future.done():
            p.future.set_exception(DeadlineExceededError(message))

    # ------------------------------------------------------------------
    def _flush(self, lane: _Lane) -> None:
        if lane.flush_handle is not None:
            lane.flush_handle.cancel()
            lane.flush_handle = None
        loop = asyncio.get_running_loop()
        now = loop.time()
        if self.config.shed_after_ms > 0:
            # the queue is in deadline order: scan all of it for age
            cutoff = now - self.config.shed_after_ms / 1000.0
            keep = []
            for p in lane.pending:
                if p.t_enqueue < cutoff:
                    lane.pending_rows -= p.nrows
                    self._shed(p, "deadline",
                               f"batcher {self.config.name!r}: request "
                               f"queued longer than "
                               f"{self.config.shed_after_ms}ms")
                else:
                    keep.append(p)
            lane.pending = keep
        if (self.config.materialize == "host" and self.config.max_inflight
                and self._inflight >= self.config.max_inflight):
            return  # the device queue is full: _release_slot re-flushes
        items, rows = [], 0
        est = self.latency_ewma_s
        while lane.pending:
            head = lane.pending[0]
            if head.deadline is not None and est > 0.0 and \
                    head.deadline - now < est:
                # its budget cannot cover a batch: answer 504 now rather
                # than spend a device call on an answer already too late
                lane.pending.pop(0)
                lane.pending_rows -= head.nrows
                self._shed(head, "budget",
                           f"batcher {self.config.name!r}: remaining "
                           f"deadline budget "
                           f"{max(head.deadline - now, 0) * 1000:.1f}ms "
                           f"below observed batch latency {est * 1000:.1f}ms")
                continue
            if rows + head.nrows > self.config.max_batch_size:
                break
            lane.pending.pop(0)
            rows += head.nrows
            items.append(head)
        lane.pending_rows -= rows
        if not items:
            return
        if lane.pending:  # leftovers: flush again at once
            lane.flush_handle = loop.call_soon(self._flush, lane)
        try:
            self._run_batch(items, rows)
        except Exception as e:
            for p in items:
                if not p.future.done():
                    p.future.set_exception(e)

    def _note_latency(self, elapsed_s: float) -> None:
        self.latency_ewma_s = elapsed_s if self.latency_ewma_s <= 0.0 else \
            0.8 * self.latency_ewma_s + 0.2 * elapsed_s

    def _assemble(self, items: list[_Pending], bucket: int) -> Any:
        """The rows of ``items`` in one array of ``bucket`` rows, pad rows
        last (a tensor where the requests hold tensors)."""
        first = items[0].array
        if len(items) == 1 and items[0].nrows == bucket:
            return first
        shape = (bucket,) + tuple(first.shape[1:])
        if isinstance(first, torch.Tensor):
            batch = torch.zeros(shape, dtype=first.dtype, device=first.device)
        else:
            batch = np.zeros(shape, dtype=first.dtype)
        off = 0
        for p in items:
            batch[off:off + p.nrows] = p.array
            off += p.nrows
        return batch

    def _run_batch(self, items: list[_Pending], rows: int) -> None:
        bucket = self.bucket_for(rows)
        tracer = self.tracer
        if tracer is None or not getattr(tracer, "enabled", False):
            self._run_batch_inner(items, rows, bucket)
            return
        self._batch_seq += 1
        with tracer.trace(f"batch:{self.config.name}:{self._batch_seq}",
                          name=f"batch:{self.config.name}",
                          batcher=self.config.name, rows=rows,
                          bucket=bucket, n_requests=len(items),
                          pad_rows=bucket - rows) as bsp:
            for p in items:
                if p.tctx is not None and p.tctx.span_id:
                    bsp.add_link(p.tctx.trace_id, p.tctx.span_id,
                                 kind="batched-request")
            self._run_batch_inner(items, rows, bucket)

    def _run_batch_inner(self, items: list[_Pending], rows: int,
                         bucket: int) -> None:
        batch = self._assemble(items, bucket)
        self.stats["batches"] += 1
        self.stats["rows"] += rows
        self.stats["pad_rows"] += bucket - rows
        if self.metrics is not None:
            labels = {"batcher": self.config.name}
            self.metrics.observe("seldon_batcher_batch_rows", rows, labels)
            self.metrics.counter_inc("seldon_batcher_batches_total", labels)
            self.metrics.counter_inc("seldon_batcher_pad_rows_total", labels,
                                     bucket - rows)
        t_dispatch = time.monotonic()
        # on the card: returns once the work is queued
        out, aux = self.fn(batch)
        if self.config.materialize == "host" and not isinstance(out,
                                                                 np.ndarray):
            # ONE device-to-host copy for the whole batch, off the loop
            self._inflight += 1
            try:
                fetch = asyncio.get_running_loop().run_in_executor(
                    None, _fetch_host, out)
                fetch.add_done_callback(
                    lambda f: self._on_batch_done(f, items, aux, t_dispatch))
            except BaseException:
                self._release_slot()
                raise
            return
        self._note_latency(time.monotonic() - t_dispatch)
        self._deliver(out, items, aux)

    def _deliver(self, out: Any, items: list[_Pending], aux: Any) -> None:
        off = 0
        for p in items:
            rows = out[off:off + p.nrows]
            if not p.future.done():
                p.future.set_result((rows, aux))
            off += p.nrows

    def _on_batch_done(self, fetch: asyncio.Future, items, aux,
                       t_dispatch: float) -> None:
        try:
            try:
                host = fetch.result()
            except Exception as e:
                for p in items:
                    if not p.future.done():
                        p.future.set_exception(e)
            else:
                self._note_latency(time.monotonic() - t_dispatch)
                self._deliver(host, items, aux)
        finally:
            self._release_slot()

    async def _acquire_slot(self) -> bool:
        cap = self.config.max_inflight
        if not cap or self.config.materialize != "host":
            return False
        while self._inflight >= cap:
            waiter = asyncio.get_running_loop().create_future()
            self._slot_waiters.append(waiter)
            await waiter
        self._inflight += 1
        return True

    def _release_slot(self) -> None:
        self._inflight -= 1
        waiters, self._slot_waiters = self._slot_waiters, []
        for w in waiters:
            if not w.done():
                w.set_result(None)
        loop = asyncio.get_running_loop()
        for lane in self._lanes.values():  # lanes held at the in-flight cap
            if lane.pending and lane.flush_handle is None:
                lane.flush_handle = loop.call_soon(self._flush, lane)


class BatchedModel:
    """A MODEL handle whose ``predict`` goes through a
    :class:`DynamicBatcher`.  Non-tensor payloads (jsonData, strData,
    binData) bypass it.  The component sees the batch, so per-request
    feature names are not passed on."""

    def __init__(self, handle, config: Optional[BatcherConfig] = None,
                 metrics=None):
        self.handle = handle
        self.name = handle.name
        cfg = (dataclasses.replace(config) if config is not None
               else BatcherConfig())
        cfg.name = self.name
        self._batcher = DynamicBatcher(self._predict_array, cfg,
                                       metrics=metrics)

    def warmup(self, example_row: Any) -> None:
        self._batcher.warmup(example_row)

    def _predict_array(self, batch):
        out = self.handle.predict(SeldonMessage(data=batch))
        return out.data, (out.meta, out.names)

    def has(self, method: str) -> bool:
        return self.handle.has(method)

    async def predict(self, msg: SeldonMessage) -> SeldonMessage:
        if msg.data is None:
            return self.handle.predict(msg)
        Y, (meta, names) = await self._batcher(msg.data)
        return SeldonMessage(data=Y, names=list(names), meta=meta.copy())

    def __getattr__(self, item):
        return getattr(self.handle, item)
