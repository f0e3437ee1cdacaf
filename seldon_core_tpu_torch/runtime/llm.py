"""Continuous-batching LLM serving (port of ``seldon_core_tpu/runtime/llm.py``).

- **Slots**: a request occupies one of ``max_slots`` slots for its lifetime;
  each tick decodes every slot in one pass.  :class:`LLMEngine` keeps a
  slab KV cache ``(layers, max_slots, max_len, Hkv, Dh)`` and ticks with
  ``decode_step``; :class:`PagedLLMEngine` keeps KV pages, reserves
  ``ceil((L0 + n_new) / page_size)`` of them at admission and ticks with
  ``paged_decode_step`` (kernel K2 on the card).
- **Admission**: waiters for a slot or for pages queue by priority class,
  then arrival; ``admit_timeout`` sheds with :class:`AdmissionDeadlineError`
  (HTTP 504).  A waiter of a higher class PREEMPTS the lowest-class, most
  recent active request: its slot and pages free at once, and it resumes
  later by re-prefilling prompt + generated tokens, emitting the ids it
  would have emitted unpreempted (its sampling generator's state is kept).
- **Prefill variants**, in the reference's precedence: a registered
  prefix that is the whole prompt (no model work); a prefix hit (registered
  or automatic) with the suffix run as one K-token ``decode_step`` chunk,
  or in ``chunk_prefill``-token chunks when it is long; a chunked prompt;
  the batched admission window (``batch_prefill_ms``, priority <= 0); a
  solo bucketed prefill.  Prompts are right-padded to a power-of-two bucket
  (exact under causal attention) and only the last true position is
  projected through the vocab matrix.
- **Prefix caching**: :meth:`LLMEngine.register_prefix` keeps a prefix's
  K/V and last logits; with ``auto_prefix_tokens`` every admitted prompt's
  K/V is kept in a token-budget LRU and later admissions reuse the longest
  common prefix (rounded down to ``auto_prefix_granularity``).  The paged
  engine maps a registered prefix's full pages into every slot that hits
  it (refcounted) instead of copying them.
- **Sampling on the device**: temperature / top-k / top-p are applied to
  the logits where they are; only the sampled ids reach the host.  Sampled
  draws come from a per-request ``torch.Generator`` seeded with the
  request's ``seed``; they cannot replay the reference's threefry draws, so
  the port holds sampling to the same distribution (:func:`filtered_probs`).

Device work (prefills, extend chunks, cache inserts, ticks) runs on ONE
worker thread, in submission order, so the event loop keeps serving while
the card computes, and the in-place cache updates never race.  Admission
state changes on the event loop only.  The ordering argument is the
reference's: a tick submitted before an admission's insert writes only rows
the insert then overwrites (or rows past the new position, masked), and a
tick submitted after it sees the slot's position already set.  Unlike the
reference's immutable arrays, caches here are written in place, so every
kept prefix entry owns its storage (a clone), and an extend pads its
prefix into a fresh buffer before writing the suffix.

**Records** (:mod:`..utils.tracing`): every job on the worker leaves a
:class:`~..utils.tracing.JobRecord` (its kind and shape key, host times,
on the card its span on the stream and the idle before it from a CUDA
event pair read without a sync) and every request a
:class:`~..utils.tracing.RequestRecord` (its waits, prefill jobs, first
token and end), in process-wide rings; inside an enabled tracer's span a
request's phases become its child spans, and inside a ``device_profile``
window each job is a ``llm.<kind>(<key>)`` range on the timeline.

**Programs** (:mod:`.programs`): the model work of a tick, a prefill of
(rows, bucket), an extend of (prefix rows, suffix bucket) and a
speculative round each runs as a program, the counterpart of the
reference's ``jax.jit`` programs: on the card one CUDA graph per shape,
captured on the worker at first sight and replayed after (eager under
``programs.eager()``), on the CPU the plain path.  A program's inputs are
the host snapshot a job was given, staged into static buffers on the
worker; its graphs hold the weights' and caches' addresses, so the engine
never rebinds them (if they are rebound, every program is dropped).
Sampling (per-request generators), the first token's draw, the speculative
uniforms and the cache inserts (their lengths vary per admission) stay
eager.

**Speculative decoding** (``draft_params``/``draft_cfg``, ``k_draft``):
every tick drafts ``k_draft`` tokens per slot with the draft model against
its own slab cache (a slab in the paged engine too), verifies them in one
(k+1)-token target chunk (:func:`decode_step` on the slab,
:func:`paged_chunk_step` on pages) and accepts per slot by
:func:`rejection_verify`: 1..k+1 tokens per tick, greedy and sampled slots
in the same tick.  Greedy slots emit exactly the target's greedy decode;
sampled slots emit tokens whose marginals are exactly the target's
sampling distribution.  Rejection rewinds by lowering the host ``pos``:
the rows past it are masked and later overwritten, so every cache carries
``k_draft + 1`` rows of headroom (per slot on the slab, per reservation in
pages).

**Tensor parallelism** (``mesh``, a :class:`~..parallel.mesh.Mesh` with a
"tp" axis; the params placed on it by ``shard_params`` or
``quantize_ffn_params(mesh=)``): every prefill, extend, tick and
speculative round runs the tensor-parallel layers of
``models/transformer.py``, the KV caches (the draft's too) split their
KV-head axis over the ranks, and the engine's own logic (slots, sampling,
speculation, prefix caching) is unchanged: logits and sampled ids live on
rank 0's device.  Ranks that share one card run in one program, captured as
one CUDA graph; a mesh whose ranks span several cards runs its programs
eagerly (``program_stats()["graphs"]``, ``tp_span()["cudaGraphs"]``).
``ring_prefill``: prompt buckets of at least that many tokens (and a
multiple of tp) prefill sequence-parallel, ring attention over "tp"
(:meth:`LLMEngine._ring_eligible`); their K/V come back split by KV head,
the caches' layout.  Without a mesh (or at tp = 1) every bucket prefills
dense, as the reference's does.  An engine serves over tp only: a dp axis
is one engine per dp group.

**Across processes** (a mesh from ``parallel/mesh.py`` ``process_mesh``,
the processes joined by ``runtime/multihost.py``): every process runs an
engine over the same global mesh and computes only its own ranks; the
collectives cross processes.  Each keeps the whole host-side state (slots,
page tables, prefix refcounts) and samples from the same gathered logits,
so a seeded sampler draws the same ids in every process.  Requests must
enter every process in the same order, one after another (the reference's
multi-host worker does so): each collective waits for the same collective
in every other process.  The programs run eagerly: a CUDA graph cannot
hold a transfer between processes (``tp_span()["cudaGraphs"]`` False,
``tp_span()["processes"]``).
"""

from __future__ import annotations

import asyncio
import bisect
import collections
import dataclasses
import itertools
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    has_quantized_params,
    init_cache,
    prefill,
)
from seldon_core_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    first_device,
    unshard,
)
from seldon_core_tpu_torch.runtime import programs
from seldon_core_tpu_torch.runtime.component import SeldonComponentError
from seldon_core_tpu_torch.runtime.paged import (
    PagedConfig,
    arrival_counters,
    init_paged_cache,
    insert_rows,
    paged_chunk_step,
    paged_decode_step,
)
from seldon_core_tpu_torch.utils.tracing import (
    JOBS,
    REQUESTS,
    JobRecord,
    RequestRecord,
    add_request_spans,
    current_span,
    profile_annotation,
    profiler_active,
)

__all__ = ["LLMEngine", "PagedLLMEngine", "LLMComponent",
           "AdmissionDeadlineError", "sample_tokens", "filtered_probs",
           "rejection_verify"]

logger = logging.getLogger(__name__)

# the budget of the static buffers that each program of many shape keys
# (prefill, draft prefill, extend) keeps captured: past it, its least
# recently used keys are dropped (programs.Program ``retain_bytes``)
GRAPH_RETAIN_BYTES = 2 << 30


class AdmissionDeadlineError(SeldonComponentError):
    """Admission deadline expired while the request waited for a slot or
    for KV pages: shed with HTTP 504 instead of queueing unboundedly."""

    def __init__(self, message: str):
        super().__init__(message, status_code=504, reason="DEADLINE_EXCEEDED")


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def _filter_pipeline(logits, temps, top_k, top_p):
    """The engine's sampling filters: temperature, then top-k, then top-p
    over the renormalized top-k survivors (position 0 is always kept).

    Returns ``(order (S, V) descending sort, sorted_logits (S, V)
    temperature-scaled in sorted space, keep (S, V) mask)``.  The sort is
    stable, as ``jnp.argsort`` is, so ties keep vocabulary order."""
    V = logits.shape[-1]
    logits = logits.float()
    temp = torch.clamp(temps.float(), min=1e-6)[:, None]
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    sorted_logits = torch.gather(logits / temp, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    pos = torch.arange(V, device=logits.device)[None, :]
    keep_k = pos < torch.where(top_k > 0, top_k, V)[:, None]
    probs_k = torch.where(keep_k, probs, 0.0)
    probs_k = probs_k / probs_k.sum(dim=-1, keepdim=True)
    keep_p = (torch.cumsum(probs_k, dim=-1) - probs_k) < top_p[:, None]
    return order, sorted_logits, keep_k & keep_p


def sample_tokens(logits, temps, top_k, top_p, generators):
    """Per-slot sampling on the logits' device.

    - ``logits``: (S, V); ``temps`` (S,) float, <= 0 is greedy argmax (the
      first maximum, as ``jnp.argmax``); ``top_k`` (S,) int, 0 disables;
      ``top_p`` (S,) float, >= 1 disables
    - ``generators``: one ``torch.Generator`` (on the logits' device) or
      None per slot; a slot is sampled only when it has one and temps > 0

    Returns (S,) int64 token ids.
    """
    toks = torch.argmax(logits, dim=-1)
    rows = [i for i, g in enumerate(generators) if g is not None]
    if not rows:
        return toks
    idx = torch.tensor(rows, device=logits.device)
    order, sorted_logits, keep = _filter_pipeline(
        logits[idx], temps[idx], top_k[idx], top_p[idx])
    probs = torch.softmax(torch.where(keep, sorted_logits, -torch.inf), -1)
    picks = torch.cat([
        torch.multinomial(probs[j], 1, generator=generators[r])
        for j, r in enumerate(rows)
    ])
    sampled = order.gather(1, picks[:, None])[:, 0]
    toks[idx] = torch.where(temps[idx] > 0, sampled, toks[idx])
    return toks


def filtered_probs(logits, temps, top_k, top_p):
    """The exact (S, V) distribution :func:`sample_tokens` draws from when
    ``temperature > 0``, in vocabulary order."""
    order, sorted_logits, keep = _filter_pipeline(logits, temps, top_k, top_p)
    probs = torch.softmax(sorted_logits, dim=-1)
    kept = torch.where(keep, probs, 0.0)
    kept = kept / kept.sum(dim=-1, keepdim=True)
    return torch.zeros_like(kept).scatter_(-1, order, kept)


def _draw(probs, u):
    """Inverse-CDF draws: for each row of ``probs`` (..., V), non-negative
    with a positive total, the first id whose running sum exceeds ``u``
    (...) in [0, 1) times the total.  An id of zero mass is never drawn."""
    cdf = torch.cumsum(probs, dim=-1)
    x = (u * cdf[..., -1]).unsqueeze(-1)
    idx = torch.searchsorted(cdf, x.contiguous(), right=True).squeeze(-1)
    # u * total can round up to the total: take the last id with mass
    last = probs.shape[-1] - 1 - torch.argmax(
        (probs.flip(-1) > 0).to(torch.int8), dim=-1)
    return torch.minimum(idx, last)


def rejection_verify(pprobs, qprobs, drafts, tgt_greedy, temps, uniforms):
    """Per-slot speculative verification (Leviathan/Chen rejection
    sampling); greedy slots (``temps <= 0``) accept their longest prefix of
    drafts equal to the target's argmax.

    - ``pprobs``: (S, k+1, V) filtered TARGET distributions per position
    - ``qprobs``: (S, k, V) filtered DRAFT distributions the drafts were
      drawn from
    - ``drafts``: (S, k); ``tgt_greedy``: (S, k+1) target argmax
    - ``uniforms``: (S, 2k+1) in [0, 1), per slot: the k acceptance draws
      ``u``, then the k residual resamples, then the bonus; greedy rows
      are not read

    Accept draft i while ``u_i * q(x_i) < p(x_i)``; at the first rejection
    emit a draw from ``norm(max(p - q, 0))`` (p where that is all zero), on
    full acceptance a bonus draw from ``p`` at position k.  Draws are
    inverse-CDF (:func:`_draw`), so they cannot replay the reference's
    threefry bits; every emitted token's marginal is the target's sampling
    distribution all the same.

    Returns ``(tokens (S, k+1), n_emit (S,))``: emit ``tokens[s,
    :n_emit[s]]``."""
    S, k = drafts.shape
    drafts = drafts.long()
    sampled = temps > 0
    px = pprobs[:, :k].gather(2, drafts[:, :, None])[:, :, 0]
    qx = qprobs.gather(2, drafts[:, :, None])[:, :, 0]
    accept = torch.where(sampled[:, None], uniforms[:, :k] * qx < px,
                         drafts == tgt_greedy[:, :k])
    n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # (S,) in [0, k]
    res = torch.clamp(pprobs[:, :k] - qprobs, min=0.0)
    res_sum = res.sum(dim=-1, keepdim=True)
    res = torch.where(res_sum > 0, res / torch.clamp(res_sum, min=1e-20),
                      pprobs[:, :k])
    resamples = _draw(res, uniforms[:, k:2 * k])  # (S, k)
    bonus = _draw(pprobs[:, k], uniforms[:, 2 * k])
    at = torch.clamp(n_acc, max=k - 1)[:, None]
    final_sampled = torch.where(n_acc < k, resamples.gather(1, at)[:, 0],
                                bonus)
    final = torch.where(sampled, final_sampled,
                        tgt_greedy.long().gather(1, n_acc[:, None])[:, 0])
    tokens = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    tokens[torch.arange(S, device=tokens.device), n_acc] = final
    return tokens, n_acc + 1


_DONE = object()  # end-of-stream sentinel on a slot's token queue

_ENGINE_IDS = itertools.count(1)


class _DeviceClock:
    """Each job's span on one device worker's stream: a CUDA event pair
    recorded as the job starts and after it returns, from a pool, read
    once the job's end event has completed (``query()``), never by a sync:
    by the next tick while the card runs its launches, before the tick
    waits for its ids, or once 64 pairs wait.  The previous job's end
    event gives the idle before the next job.  Used on the worker thread
    (and by ``close`` once it has stopped)."""

    #: pairs left waiting before a job's end reads them itself
    PENDING = 64

    def __init__(self, device):
        self.device = device
        self._stream = None  # the worker's current stream, at its first job
        self._free: list = []
        # (record, start, end, the previous job's end), oldest first
        self._pending: collections.deque = collections.deque()
        self._last_end = None

    def mark(self):
        """An event recorded now on the worker's stream."""
        if self._stream is None:
            self._stream = torch.cuda.current_stream(self.device)
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record(self._stream)
        return ev

    def end(self, rec: JobRecord, start) -> None:
        """``rec``'s job ended: its pair is read once ``end`` completes."""
        end = self.mark()
        self._pending.append((rec, start, end, self._last_end))
        self._last_end = end
        if len(self._pending) > self.PENDING:
            self.poll()

    def poll(self) -> None:
        """Read every pending pair whose end has completed, in order, and
        return the events no later job reads to the pool."""
        while self._pending and self._pending[0][2].query():
            rec, start, end, prev = self._pending.popleft()
            rec.device_ms = start.elapsed_time(end)
            if prev is not None:
                rec.gap_ms = prev.elapsed_time(start)
                self._free.append(prev)
            self._free.append(start)


@dataclass
class _Slot:
    queue: asyncio.Queue  # generated token ids; _DONE / exception terminate
    remaining: int
    tokens: list
    stop: frozenset
    # priority class (higher preempts lower), admission sequence (victims:
    # the most recent first), the slot held (-1 while preempted), whether
    # the consumer walked away, and the prompt's host ids for a resume
    priority: int = 0
    seq: int = 0
    slot: int = -1
    cancelled: bool = False
    prompt: Any = None


def _each(fn, *xs):
    """``fn`` on a K/V tensor, or rank by rank on a placed one
    (:class:`Shards`, with the same ranks of the other arguments)."""
    if isinstance(xs[0], Shards):
        return xs[0].map(fn, *xs[1:])
    return fn(*xs)


class LLMEngine:
    """Slot-based continuous batching over one transformer and a slab KV
    cache (``max_slots`` x ``max_len`` rows, allocated up front).

    ``await engine.generate(prompt_ids, n_new)`` returns the ids ``[1, L0 +
    n_generated]`` as a CPU int32 tensor; :meth:`stream` yields them as
    they are sampled.  With ``draft_params``/``draft_cfg`` every tick is
    speculative (module docstring); ``spec_stats`` counts its rounds and
    its drafted and accepted tokens.
    """

    def __init__(
        self,
        params: dict,
        cfg: TransformerConfig,
        max_slots: int = 8,
        max_len: Optional[int] = None,
        draft_params: Optional[dict] = None,
        draft_cfg: Optional[TransformerConfig] = None,
        k_draft: int = 4,
        chunk_prefill: int = 0,
        mesh: Optional[Mesh] = None,
        auto_prefix_tokens: int = 0,
        auto_prefix_granularity: int = 16,
        ring_prefill: int = 0,
        batch_prefill_ms: float = 0.0,
    ):
        if mesh is not None and (mesh.axis_size("dp") > 1
                                 or mesh.axis_size("pp") > 1):
            raise ValueError(
                f"an engine serves over tp only, not {mesh!r}: serve one "
                "engine per dp group (pp runs in forward and training only)")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params and draft_cfg go together")
        if draft_params is not None and int(k_draft) < 1:
            raise ValueError(f"k_draft must be >= 1, not {k_draft}")
        self.params = params
        self.cfg = cfg
        self.mesh = mesh
        # the controller's device: rank 0's under a mesh (this process's
        # first under a mesh that spans processes)
        self.device = params["embed"].device
        # one CUDA graph cannot hold ranks on several cards, nor a transfer
        # between processes
        self._graphs_ok = mesh is None or (
            not mesh.spans_processes and len(mesh.distinct_devices) == 1)
        # prompt buckets of at least this many tokens prefill
        # sequence-parallel over tp (_ring_eligible); 0 = off
        self.ring_prefill = int(ring_prefill)
        self.max_slots = max_slots
        self.max_len = max_len or cfg.max_seq
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.k_draft = int(k_draft)
        # a speculative tick writes up to k_draft + 1 rows past a slot's
        # true position before the rewind
        self._headroom = self.k_draft + 1 if draft_params is not None else 0
        self.spec_stats = {"rounds": 0, "drafted": 0, "accepted": 0}
        # admissions longer than this extend their cache in chunks of this
        # many tokens, each its own device job, so ticks interleave; 0 = off
        self.chunk_prefill = int(chunk_prefill)
        # admissions arriving within this window share one prefill of B
        # rows (padded to the group's largest bucket); 0 = off
        self.batch_prefill_ms = float(batch_prefill_ms)
        self._pf_queue: list = []
        self._pf_flusher: Optional[asyncio.Task] = None
        self._pf_event: Optional[tuple] = None  # (loop, asyncio.Event)
        self.prefill_batch_stats = {"groups": 0, "requests": 0}
        self.cache = self._init_cache(self.max_len + self._headroom)
        # the draft's cache is a slab in both engines
        self.draft_cache = None if draft_params is None else init_cache(
            draft_cfg, max_slots, max_len=self.max_len + self._headroom,
            device=self.device, mesh=mesh)
        self._slots: dict[int, _Slot] = {}
        self._free = list(range(max_slots))
        # slot admission queue: (-priority, seq, future), kept sorted
        self._slot_waiters: list[tuple] = []
        self._admit_seq = 0
        self.preempt_stats = {"preempted": 0, "resumed": 0, "shed": 0}
        # strong refs to in-flight resumes (the loop holds tasks weakly)
        self._resume_tasks: set = set()
        # names this engine's job and request records
        self.engine_id = next(_ENGINE_IDS)
        self._tick_task: Optional[asyncio.Task] = None
        # host mirrors of per-slot state, snapshotted into each tick
        self._tokens = np.zeros((max_slots,), np.int64)
        self._temps = np.zeros((max_slots,), np.float32)
        self._topk = np.zeros((max_slots,), np.int64)
        self._topp = np.ones((max_slots,), np.float32)
        self._pos = np.zeros((max_slots,), np.int32)
        self._gens: list[Optional[torch.Generator]] = [None] * max_slots
        # each sampled slot's generator state after its latest EMITTED
        # token: a preemption resumes from it (a tick in flight may have
        # advanced the generator past it already)
        self._gen_state: list[Optional[torch.Tensor]] = [None] * max_slots
        # registered prefixes: token tuple -> {"k", "v" (layers, 1, bucket,
        # Hkv, Dh), "len", "logits"}
        self._prefixes: dict[tuple, dict] = {}
        # automatic prefix cache: a token-budget LRU of admitted prompts'
        # K/V (oldest first); 0 = off
        self._auto_budget = int(auto_prefix_tokens)
        self._auto_gran = max(int(auto_prefix_granularity), 1)
        self._auto_entries: list[dict] = []
        self.prefix_stats = {"auto_hits": 0, "auto_tokens_reused": 0,
                             "auto_stored": 0, "auto_evicted": 0,
                             "auto_admissions": 0}
        # the ONE thread that runs device work, in submission order
        self._device_worker = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="llm-device")
        self._clock = (_DeviceClock(self.device)
                       if self.device.type == "cuda" else None)
        # device programs by name, built at first use, and what they were
        # built over (_program)
        self._programs: dict[str, programs.Program] = {}
        self._graph_pool: Optional[programs.GraphPool] = None
        self._bound: tuple = ()

    def _init_cache(self, cache_len: int):
        return init_cache(self.cfg, self.max_slots, max_len=cache_len,
                          device=self.device, mesh=self.mesh)

    def close(self) -> None:
        """Stop the device worker thread (after its queued work)."""
        self._device_worker.shutdown(wait=True)
        if self._clock is not None:
            self._clock.poll()

    def _job(self, kind: str, key=None, req: Optional[RequestRecord] = None,
             **fields) -> JobRecord:
        """A new job's record (``fields``: its rows, context, tokens,
        padded), entered in the job ring and in ``req``'s prefill jobs."""
        rec = JobRecord(kind, self.engine_id, time.perf_counter(), key,
                        **fields)
        JOBS.add(rec)
        if req is not None:
            req.jobs.append(rec)
        return rec

    def _captures(self) -> int:
        return sum(p.captures for p in self._programs.values())

    def _timed(self, fn, rec: JobRecord):
        """``fn`` as the worker runs it: ``rec``'s start and end, its event
        pair on the card, whether it captured, and its range in a
        ``device_profile`` window."""
        clock = self._clock

        def run(*args):
            n = self._captures()
            rec.t_start = time.perf_counter()
            start = clock.mark() if clock is not None else None
            try:
                if not profiler_active():
                    return fn(*args)
                with profile_annotation(rec.label):
                    return fn(*args)
            finally:
                if clock is not None:
                    clock.end(rec, start)
                rec.t_end = time.perf_counter()
                rec.captured = self._captures() != n

        return run

    def _on_device(self, fn, *args, rec: JobRecord):
        """Queue ``fn(*args)`` on the device worker; an awaitable future.
        ``rec``: its record (:meth:`_job`)."""
        return asyncio.get_running_loop().run_in_executor(
            self._device_worker, self._timed(fn, rec), *args)

    def _device_job(self, fn, what: str, rec: JobRecord) -> None:
        """Queue ``fn()`` on the device worker from any thread, without
        waiting for it; a failure is logged."""
        def done(f):
            if not f.cancelled() and f.exception() is not None:
                logger.error("%s failed: %r", what, f.exception())

        self._device_worker.submit(self._timed(fn, rec)).add_done_callback(
            done)

    # -- checkpoints -----------------------------------------------------
    @classmethod
    def from_checkpoint(cls, path: str, *, mesh=None, int8: str = "none",
                        draft_path: Optional[str] = None, device=None,
                        **engine_kwargs):
        """Boot an engine from a checkpoint directory
        (:mod:`.checkpoint`), placed over ``mesh`` and int8 quantized at
        load; ``device`` defaults to the card (a mesh brings its own
        devices).  ``draft_path`` loads a second checkpoint as the
        speculative draft, dense as it was saved (placed over ``mesh``
        too).  Pass ``paged=`` through ``engine_kwargs`` for
        :class:`PagedLLMEngine`."""
        from seldon_core_tpu_torch.device import resolve_device
        from seldon_core_tpu_torch.runtime.checkpoint import load_transformer

        dev = (first_device(mesh.axis_devices("tp")) if mesh is not None
               else resolve_device(device))
        params, cfg = load_transformer(path, mesh=mesh, int8=int8, device=dev)
        if draft_path is not None:
            dparams, dcfg = load_transformer(draft_path, mesh=mesh, device=dev)
            engine_kwargs.setdefault("draft_params", dparams)
            engine_kwargs.setdefault("draft_cfg", dcfg)
        return cls(params, cfg, mesh=mesh, **engine_kwargs)

    def save_checkpoint(self, path: str) -> str:
        """Export the engine's weights as a checkpoint (a placed tree as
        its global tensors).  int8 trees are refused: save the canonical
        weights and quantize at load."""
        from seldon_core_tpu_torch.runtime.checkpoint import save_transformer

        if has_quantized_params(self.params):
            raise ValueError(
                "engine params are int8-quantized; export the canonical "
                "weights (save before quantizing, or via "
                "checkpoint.save_transformer on the master tree) and "
                "quantize at load with from_checkpoint(int8=...)")
        params = {k: ({n: unshard(v) for n, v in t.items()}
                      if isinstance(t, dict) else unshard(t))
                  for k, t in self.params.items()}
        return save_transformer(path, params, self.cfg)

    def tp_span(self) -> Optional[dict]:
        """This engine's tensor-parallel posture, in the placement plane's
        tp-span vocabulary (``/admin/placement`` ``tpSpans``): the mesh
        slice the weights partition over, their bytes and the bytes split
        over "tp", and the per-rank share (split bytes / tp + the rest).
        None off a mesh or at tp = 1.  ``cudaGraphs`` (port only): whether
        its programs replay as CUDA graphs (not across several cards, nor
        across processes); ``processes`` (port only): how many processes
        the mesh spans."""
        if self.mesh is None:
            return None
        tp = self.mesh.axis_size("tp")
        if tp < 2:
            return None
        total = sharded = 0

        def walk(x):
            nonlocal total, sharded
            if isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, Shards):
                # every piece of a split is the same size (even splits)
                n = x.first.nbytes * (len(x) if x.dim is not None else 1)
                total += n
                sharded += n if x.dim is not None else 0
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)
            elif isinstance(x, torch.Tensor):
                total += x.nbytes

        walk(self.params)
        return {
            "meshSlice": ",".join(f"{a}={n}" for a, n in
                                  self.mesh.shape.items() if n > 1),
            "paramBytes": total,
            "shardedParamBytes": sharded,
            "tpBytesPerDevice": sharded // tp + (total - sharded),
            "cudaGraphs": self._graphs_ok,
            "processes": self.mesh.n_processes,
        }

    # -- programs --------------------------------------------------------
    def _program(self, name: str, build) -> programs.Program:
        """The program ``name``, made by ``build()`` at its first use.  Its
        graphs hold the addresses of the weights and caches it was built
        over: if any has been rebound since, every program is dropped."""
        bound = (self.params, self.draft_params, self.cache["k"],
                 self.cache["v"],
                 *((self.draft_cache["k"], self.draft_cache["v"])
                   if self.draft_cache is not None else ()))
        if len(bound) != len(self._bound) or any(
                a is not b for a, b in zip(bound, self._bound)):
            self._programs, self._graph_pool, self._bound = {}, None, bound
        prog = self._programs.get(name)
        if prog is None:
            prog = self._programs[name] = build()
        return prog

    def _pool(self) -> programs.GraphPool:
        if self._graph_pool is None:
            self._graph_pool = programs.GraphPool(self.device)
        return self._graph_pool

    def _make(self, name: str, fn, **kw) -> programs.Program:
        return programs.Program(name, fn, self.device, self._pool,
                                graphs=self._graphs_ok, **kw)

    def program_stats(self) -> dict:
        """Per program: capture seconds per shape key (its latest capture),
        captures, replays, eager runs, keys evicted for its budget and the
        bytes its captured keys hold; and the bytes of the engine's graph
        pool (0 before the first capture)."""
        return {
            "programs": {
                name: {"capture_s": {str(k): v
                                     for k, v in p.capture_s.items()},
                       "captures": p.captures, "replays": p.replays, "eager_runs": p.eager_runs,
                       "evicted": p.evicted,
                       "retained_bytes": p.retained_bytes()}
                for name, p in self._programs.items()},
            "pool_bytes": (0 if self._graph_pool is None
                           else self._graph_pool.bytes()),
            "graphs": self._graphs_ok,
        }

    def _prefill_program(self, name: str, params, cfg) -> programs.Program:
        """Prefill of (B, bucket) right-padded rows with one logit position
        per row, a (B,) tensor (an int would be a constant of the graph):
        ``(logits (B, V), k, v)``, each (layers, B, bucket, Hkv, Dh)."""
        mesh = self.mesh

        def fn(key, ids, logit_pos):
            with torch.no_grad():
                logits, small = prefill(params, ids, cfg, max_len=ids.shape[1],
                                        logit_pos=logit_pos, mesh=mesh)
            return logits, small["k"], small["v"]

        return self._make(name, fn, keep=(params,), owned_outputs=True,
                          retain_bytes=GRAPH_RETAIN_BYTES)

    def _extend_program(self) -> programs.Program:
        """Extend of a prefix's (1, cap0) K/V by a (1, bs) suffix chunk at
        row ``done`` ((1,) int32): the prefix padded into a fresh buffer of
        cap0 + bs rows, one K-token ``decode_step``, and the logits of the
        chunk's position ``last`` ((1,) int64)."""
        params, cfg, mesh = self.params, self.cfg, self.mesh

        def fn(key, k, v, suffix, done, last):
            bs = suffix.shape[1]

            def pad(t):
                return F.pad(t, (0, 0, 0, 0, 0, bs))

            with torch.no_grad():
                cache = {"k": _each(pad, k), "v": _each(pad, v), "pos": done}
                logits, cache = decode_step(params, cache, suffix, cfg,
                                            mesh=mesh)
                return logits[0, last], cache["k"], cache["v"]

        return self._make("extend", fn, keep=(params,), owned_outputs=True,
                          retain_bytes=GRAPH_RETAIN_BYTES)

    def _tick_program(self) -> programs.Program:
        """One decode step of every slot against the slab at host positions
        (``pos`` a static input; ``self.cache`` is never rebound)."""
        params, cfg, cache, mesh = self.params, self.cfg, self.cache, self.mesh

        def fn(key, tokens, pos):
            with torch.no_grad():
                logits, _ = decode_step(
                    params, {"k": cache["k"], "v": cache["v"], "pos": pos},
                    tokens, cfg, mesh=mesh)
            return logits

        return self._make("tick", fn, keep=(params, cache),
                          answered=self._answered_rows)

    def _tick_inputs(self, state) -> tuple:
        """The tick program's inputs from a tick snapshot."""
        return state["tokens"], state["pos"]

    def _answered_rows(self, key, host, out):
        """The part of a tick's or a round's output an answer reads (the
        bitwise check of a first replay): on the slab, every row."""
        return out

    def _spec_program(self) -> programs.Program:
        """The speculative round (:meth:`_spec_device`), keyed by whether
        any slot samples: ``(S, k + 2)`` int64, the tokens then ``n_emit``.
        The draft's cache and the target's are written in place; neither
        is rebound."""
        k = self.k_draft

        def fn(sampled, tok, pos, temps, top_k, top_p, u, *tables):
            with torch.no_grad():
                drafts, qprobs = self._draft_propose(tok, pos, temps, top_k,
                                                     top_p, u[:, :k], sampled)
                vtokens = torch.cat([tok[:, None], drafts], dim=1)
                vlogits = self._verify_logits(pos, vtokens, *tables)
                tokens, n_emit = self._verify_emit(
                    vlogits, drafts, qprobs, temps, top_k, top_p, u[:, k:])
                return torch.cat([tokens, n_emit[:, None]], dim=1)

        return self._make("spec", fn, keep=(self.params, self.draft_params,
                                            self.cache, self.draft_cache),
                          answered=self._answered_rows)

    # -- device work (runs on the device worker) -------------------------
    def _prefill_rows(self, ids: np.ndarray, logit_pos):
        """Prefill of right-padded rows ``ids`` (B, bucket): last-position
        logits (B, V) and the 1-row-per-request K/V ``{"k", "v"}``.
        ``logit_pos``: one position for every row, or one per row."""
        B = ids.shape[0]
        lp = np.array(np.broadcast_to(np.asarray(logit_pos, np.int64), (B,)))
        name, cfg = self._prefill_variant("prefill", self.cfg, ids.shape[1])
        prog = self._program(name, lambda: self._prefill_program(
            name, self.params, cfg))
        logits, k, v = prog(ids.shape, ids.astype(np.int64), lp)
        return logits, {"k": k, "v": v}

    def _ring_eligible(self, bucket: int) -> bool:
        """Whether a prompt bucket prefills sequence-parallel: at least
        ``ring_prefill`` tokens, on a mesh with tp > 1, split evenly."""
        if not self.ring_prefill or bucket < self.ring_prefill:
            return False
        if self.mesh is None:
            return False
        tp = self.mesh.axis_size("tp")
        return tp > 1 and bucket % tp == 0

    def _prefill_variant(self, name: str, cfg, bucket: int):
        """The program name and config of a prefill of ``bucket`` tokens:
        a ring-eligible bucket runs ring attention over "tp" (flash is a
        per-rank whole-sequence kernel, what a long prompt must avoid)."""
        if self._ring_eligible(bucket):
            return ("ring_" + name, dataclasses.replace(
                cfg, attention="ring", use_flash=False))
        return name, cfg

    @staticmethod
    def _kv_of(src: dict):
        """K/V of a prefix source: an automatic match takes its entry's
        first ``len`` rows, a registered entry or a 1-row cache its own."""
        if "src" in src:
            e, n = src["src"], src["len"]
            return (_each(lambda t: t[:, :, :n], e["k"]),
                    _each(lambda t: t[:, :, :n], e["v"]))
        return src["k"], src["v"]

    def _extend_job(self, src: dict, suffix: np.ndarray, done: int,
                    last: int):
        """Extend ``src``'s K/V (``done`` true rows) by a padded suffix
        chunk: the prefix K/V padded into a FRESH buffer of cap0 + bs rows,
        one K-token ``decode_step`` writing the chunk at ``done``, and the
        logits of the chunk's last true position ``last`` (the program of
        key (cap0, bs), :meth:`_extend_program`)."""
        k, v = self._kv_of(src)
        logits, k2, v2 = self._program("extend", self._extend_program)(
            ((k.first if isinstance(k, Shards) else k).shape[2],
             suffix.shape[1]), k, v, suffix.astype(np.int64),
            np.array([done], np.int32), np.array([last], np.int64))
        return logits, {"k": k2, "v": v2}

    def _sample_first(self, logits, first):
        """The first generated token from the last position's logits (B = 1)
        by the ticks' own sampling; ``first`` is ``(temperature, top_k,
        top_p, generator)``, or None (a resume samples nothing here)."""
        if first is None:
            return None
        temp, top_k, top_p, gen = first
        dev = self.device
        with torch.no_grad():
            tok = sample_tokens(
                logits, torch.tensor([temp], device=dev),
                torch.tensor([top_k], device=dev),
                torch.tensor([top_p], device=dev), [gen])
            return int(tok[0])

    def _then_first(self, job, first):
        """``job`` (returning logits and the 1-row cache) followed, in the
        same device-worker call, by the first token's draw: it follows its
        own logits at once, as the reference dispatches it, instead of
        queueing behind other admissions' prefills."""
        def run(*args):
            logits, small = job(*args)
            return logits, small, self._sample_first(logits, first)

        return run

    def _tick_device(self, state):
        """One decode tick of every slot (the tick program), host snapshot
        in, sampled ids out.  Under a mesh the logits are whole on rank 0's
        device already (the vocabulary all-gather), so the reference's
        ``_replicated`` (a GSPMD constraint that keeps a multi-process
        mesh's fetched ids addressable) has no counterpart here."""
        dev = self.device
        logits = self._program("tick", self._tick_program)(
            self.max_slots, *self._tick_inputs(state))
        with torch.no_grad():
            toks = sample_tokens(
                logits, torch.from_numpy(state["temps"]).to(dev),
                torch.from_numpy(state["top_k"]).to(dev),
                torch.from_numpy(state["top_p"]).to(dev), state["gens"])
            self._read_clock()
            return toks.cpu().numpy()

    def _read_clock(self) -> None:
        """Read the finished jobs' device times while the card runs a
        tick's launches, off the path the tick's answer waits on."""
        if self._clock is not None:
            self._clock.poll()

    def _insert_slab(self, small, slot: int, true_len: int) -> None:
        """Copy a 1-row prefill cache's first ``true_len`` rows into slot
        ``slot`` of the slab (in place)."""
        for name in ("k", "v"):
            _each(lambda c, s: c[:, slot, :true_len].copy_(
                s[:, 0, :true_len].to(c.device, c.dtype)),
                self.cache[name], small[name])

    def _insert_job(self, small, slot: int, L0: int):
        """A callable for the device worker that writes an admission's K/V
        into the cache (host state read now, not later)."""
        return lambda: self._insert_slab(small, slot, L0)

    # -- speculative decoding (runs on the device worker) ----------------
    def _draft_prefill(self, host_ids, L0: int):
        """The draft's K/V of the whole prompt, a 1-row cache: prefix
        entries hold target state only, so the draft always prefills."""
        padded = np.zeros((1, _bucket(L0)), np.int64)
        padded[0, :L0] = host_ids[:L0]
        name, cfg = self._prefill_variant("draft_prefill", self.draft_cfg,
                                          padded.shape[1])
        prog = self._program(name, lambda: self._prefill_program(
            name, self.draft_params, cfg))
        _, k, v = prog(padded.shape, padded, np.array([L0 - 1], np.int64))
        return {"k": k, "v": v}

    def _spec_uniforms(self, gens: list):
        """(S, 3k+1) uniforms, ONE draw call per sampled slot from its own
        generator, in the order: the k draft samples, the k acceptance
        draws ``u``, the k residual resamples, the bonus.  Greedy rows are
        zeros (no draw)."""
        n = 3 * self.k_draft + 1
        if all(g is None for g in gens):
            return torch.zeros((len(gens), n), device=self.device)
        zero = torch.zeros((n,), device=self.device)
        return torch.stack([
            zero if g is None else torch.rand((n,), generator=g,
                                              device=self.device)
            for g in gens])

    def _draft_propose(self, tok, pos, temps, top_k, top_p, u, sampled):
        """Draft phase: k draft tokens per slot, each drawn from the slot's
        filtered draft distribution (argmax for greedy slots), with the
        uniforms ``u`` (S, k).  ``sampled``: whether any slot samples (else
        no distribution is computed).  Returns ``(drafts (S, k), qprobs (S,
        k, V) or None)``.

        k + 1 draft steps: the extra one processes d_{k-1} so that its KV
        row is WRITTEN.  On full acceptance the rewound position counts that
        row as valid, and a row never written there would be a hole the
        draft attends over from then on, lowering acceptance round by
        round.  Its proposed token is discarded."""
        d_cache = {"k": self.draft_cache["k"], "v": self.draft_cache["v"],
                   "pos": pos}
        t = tok
        drafts, qs = [], []
        for j in range(self.k_draft + 1):
            dl, d_cache = decode_step(self.draft_params, d_cache, t,
                                      self.draft_cfg, mesh=self.mesh)
            if j == self.k_draft:
                break
            t = torch.argmax(dl, dim=-1)
            if sampled:
                q = filtered_probs(dl, temps, top_k, top_p)
                t = torch.where(temps > 0, _draw(q, u[:, j]), t)
                qs.append(q)
            drafts.append(t)
        return (torch.stack(drafts, dim=1),
                torch.stack(qs, dim=1) if sampled else None)

    def _verify_logits(self, pos, vtokens):
        """The target's (S, k+1, V) logits of the verify chunk ``vtokens``
        at ``pos``, its K/V rows written into the slab."""
        logits, _ = decode_step(
            self.params, {"k": self.cache["k"], "v": self.cache["v"],
                          "pos": pos}, vtokens, self.cfg, mesh=self.mesh)
        return logits

    def _verify_emit(self, vlogits, drafts, qprobs, temps, top_k, top_p, u):
        """Per-slot acceptance (:func:`rejection_verify`) of the drafts
        against the target's (k+1)-position logits.  With no sampled slot
        (``qprobs`` None) only the argmax is read: no distribution is
        computed, and zeros stand in for the unread ones."""
        S, K, V = vlogits.shape
        tgt = torch.argmax(vlogits, dim=-1)
        if qprobs is None:
            pprobs = torch.zeros((S, K, V), device=vlogits.device)
            qprobs = pprobs[:, 1:]
        else:
            pprobs = filtered_probs(
                vlogits.reshape(S * K, V), temps.repeat_interleave(K),
                top_k.repeat_interleave(K), top_p.repeat_interleave(K),
            ).reshape(S, K, V)
        return rejection_verify(pprobs, qprobs, drafts, tgt, temps, u)

    def _spec_device(self, state):
        """One speculative tick of every slot: draft proposal, one (k+1)
        token target verification, per-slot acceptance (the spec program,
        keyed by whether any slot samples; its uniforms are drawn first,
        outside it).  Returns host ``(tokens (S, k+1), n_emit (S,))``."""
        sampled = any(g is not None for g in state["gens"])
        with torch.no_grad():
            u = self._spec_uniforms(state["gens"])
        # the paged engine's tables come last, as in the tick's inputs
        out = self._program("spec", self._spec_program)(
            sampled, state["tokens"], state["pos"], state["temps"],
            state["top_k"], state["top_p"], u, *self._tick_inputs(state)[2:])
        self._read_clock()
        out = out.cpu().numpy()
        return out[:, :-1], out[:, -1]

    # -- prefix caching --------------------------------------------------
    def register_prefix(self, prefix_ids) -> None:
        """Keep the K/V of a shared prompt prefix (a system prompt) and its
        last-position logits on the device.  Later requests that start with
        it run only their suffix (one K-token ``decode_step`` chunk); a
        request that IS the prefix runs no model work.  Exact: causal
        attention makes the prefix state independent of what follows.

        Returns at once: the prefill is queued on the device worker and
        fills the entry there, so serving does not stall; every admission
        that uses the entry reads it in a job queued after that one."""
        ids = tuple(int(t) for t in np.asarray(prefix_ids).reshape(-1))
        if not ids:
            raise ValueError("empty prefix")
        if len(ids) >= self.max_len:
            raise ValueError(f"prefix {len(ids)} >= max_len {self.max_len}")
        padded = np.zeros((1, _bucket(len(ids))), np.int64)
        padded[0, :len(ids)] = ids
        entry = {"k": None, "v": None, "len": len(ids), "logits": None}

        def job():
            # a fresh prefill's buffers: nothing else holds or writes them
            entry["logits"], small = self._prefill_rows(padded, len(ids) - 1)
            entry["k"], entry["v"] = small["k"], small["v"]

        self._prefixes[ids] = entry
        self._device_job(job, "prefix prefill", self._prefill_record(
            padded.shape, len(ids), None))

    def clear_prefixes(self) -> None:
        """Drop every cached prefix, registered and automatic."""
        self._prefixes.clear()
        self._auto_entries.clear()

    def _auto_store(self, host_ids, L0: int) -> Optional[dict]:
        """Enter an admitted prompt in the automatic prefix cache (a
        token-budget LRU) and return the entry, whose K/V the admission's
        insert job fills with a clone (so slot recycling cannot touch it);
        None when it is not kept."""
        if L0 > self._auto_budget or L0 < self._auto_gran:
            return None
        ids = np.asarray(host_ids, np.int32).reshape(-1)[:L0]
        for e in self._auto_entries:
            if e["len"] >= L0 and np.array_equal(e["ids"][:L0], ids):
                return None  # an entry already covers this prompt
        entry = {"ids": ids, "k": None, "v": None, "len": L0}
        self._auto_entries.append(entry)
        self.prefix_stats["auto_stored"] += 1
        total = sum(e["len"] for e in self._auto_entries)
        while total > self._auto_budget and len(self._auto_entries) > 1:
            gone = self._auto_entries.pop(0)
            total -= gone["len"]
            self.prefix_stats["auto_evicted"] += 1
        return entry

    def _match_auto(self, host_ids, L0: int):
        """Longest common prefix with any kept prompt, rounded down to the
        granularity and capped at L0 - 1 (the suffix always has a token to
        run).  A pure lookup: :meth:`_auto_touch` counts it when it wins."""
        ids = np.asarray(host_ids, np.int32).reshape(-1)
        best, best_c = None, 0
        for e in self._auto_entries:
            m = min(e["len"], L0 - 1)
            if m < self._auto_gran:
                continue
            neq = np.nonzero(e["ids"][:m] != ids[:m])[0]
            c = m if neq.size == 0 else int(neq[0])
            c -= c % self._auto_gran
            if c > best_c:
                best, best_c = e, c
        if best is None or best_c < self._auto_gran:
            return None
        return {"src": best, "len": best_c}

    def _auto_touch(self, auto: dict) -> None:
        e = auto["src"]
        # removal by identity: dict equality would compare tensors
        self._auto_entries[:] = [x for x in self._auto_entries if x is not e]
        self._auto_entries.append(e)
        self.prefix_stats["auto_hits"] += 1
        self.prefix_stats["auto_tokens_reused"] += auto["len"]

    def _match_prefix(self, ids: tuple):
        """Longest registered prefix that ``ids`` starts with, or None."""
        best = None
        for p, entry in self._prefixes.items():
            if len(p) <= len(ids) and ids[: len(p)] == p:
                if best is None or len(p) > best[1]["len"]:
                    best = (p, entry)
        return best[1] if best is not None else None

    # -- prefill variants ------------------------------------------------
    async def _chunked_prefill(self, host_ids, L0: int, first,
                               req: RequestRecord):
        """Prefill in ``chunk_prefill``-token pieces, each its own device
        job with an event-loop yield before it, so decode ticks interleave.
        Returns the last position's logits, the 1-row cache and the first
        token (drawn in the last chunk's job)."""
        n = min(self.chunk_prefill, L0)
        padded = np.zeros((1, _bucket(n)), np.int64)
        padded[0, :n] = host_ids[:n]
        rec = self._prefill_record(padded.shape, n, req)
        if n == L0:
            return await self._on_device(
                self._then_first(self._prefill_rows, first), padded, n - 1,
                rec=rec)
        _, small = await self._on_device(self._prefill_rows, padded, n - 1,
                                         rec=rec)
        return await self._extend_chunks(small, n, host_ids, L0, first, req)

    async def _extend_chunks(self, src, done: int, host_ids, L0: int, first,
                             req: RequestRecord):
        """Extend a 1-row cache or prefix source (``done`` tokens processed)
        to the whole prompt in ``chunk_prefill``-token chunks; also the
        long-suffix path after a prefix hit."""
        C = self.chunk_prefill
        while True:
            await asyncio.sleep(0)  # decode ticks dispatch between chunks
            n = min(C, L0 - done)
            chunk = np.zeros((1, _bucket(n)), np.int64)
            chunk[0, :n] = host_ids[done:done + n]
            rec = self._extend_record(src, chunk, n, req)
            if done + n == L0:
                return await self._on_device(
                    self._then_first(self._extend_job, first), src, chunk,
                    done, n - 1, rec=rec)
            _, src = await self._on_device(self._extend_job, src, chunk, done,
                                           n - 1, rec=rec)
            done += n

    def _prefill_record(self, shape, tokens: int,
                        req: Optional[RequestRecord]) -> JobRecord:
        """The record of a prefill of ``shape`` (rows, bucket) holding
        ``tokens`` true tokens, one of ``req``'s prefill jobs."""
        rows, bucket = shape
        if req is not None:
            req.bucket = bucket
        return self._job("prefill", (rows, bucket), req, tokens=tokens,
                         padded=rows * bucket)

    def _extend_record(self, src: dict, chunk, tokens: int,
                       req: RequestRecord) -> JobRecord:
        """The record of an extend of ``src``'s K/V by ``chunk`` (its
        program's key: the prefix's rows, the chunk's bucket)."""
        bs = chunk.shape[1]
        if "src" in src:
            rows = src["len"]
        elif src.get("k") is None:  # a registered prefix still prefilling
            rows = _bucket(src["len"])
        else:
            k = src["k"]
            rows = (k.first if isinstance(k, Shards) else k).shape[2]
        req.bucket = bs
        return self._job("extend", (rows, bs), req, tokens=tokens, padded=bs)

    def _pf_wake(self) -> asyncio.Event:
        """The batched window's early-flush event, made on the running
        loop (an engine may serve from more than one loop in turn)."""
        loop = asyncio.get_running_loop()
        if self._pf_event is None or self._pf_event[0] is not loop:
            self._pf_event = (loop, asyncio.Event())
        return self._pf_event[1]

    async def _batched_prefill(self, host_ids, L0: int, first,
                               req: RequestRecord):
        """Join the current window; its flusher runs ONE prefill for the
        group and hands each caller its own row: ``(logits [1, V], 1-row
        cache, first token)``, like the solo path."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pf_queue.append((host_ids, L0, first, req, fut))
        if len(self._pf_queue) >= self.max_slots:
            # every member holds a slot: the group cannot grow
            self._pf_wake().set()
        if self._pf_flusher is None or self._pf_flusher.done():
            self._pf_flusher = loop.create_task(self._pf_flush_after_window())
        return await fut

    async def _pf_flush_after_window(self) -> None:
        wake = self._pf_wake()
        try:
            await asyncio.wait_for(wake.wait(), self.batch_prefill_ms / 1000.0)
        except asyncio.TimeoutError:
            pass
        wake.clear()
        batch, self._pf_queue = self._pf_queue, []
        # reset BEFORE dispatch: arrivals during the device call open a
        # fresh window
        self._pf_flusher = None
        for group in self._pf_partition(batch):
            try:
                await self._pf_dispatch(group)
            except BaseException as e:
                for *_, f in group:
                    if not f.done():
                        f.set_exception(e)
                if not isinstance(e, Exception):
                    raise
            # decode ticks dispatch between group programs
            await asyncio.sleep(0)

    def _pf_partition(self, batch: list) -> list:
        """Consecutive groups whose padded tokens stay within
        ``chunk_prefill`` (a row alone may exceed it); no bound, one
        group."""
        if not batch:
            return []
        budget = self.chunk_prefill
        if not budget:
            return [batch]
        groups, cur, cur_tokens = [], [], 0
        for item in batch:
            b = _bucket(item[1])
            if cur and cur_tokens + b > budget:
                groups.append(cur)
                cur, cur_tokens = [], 0
            cur.append(item)
            cur_tokens += b
        groups.append(cur)
        return groups

    async def _pf_dispatch(self, batch: list) -> None:
        """One prefill for the group: rows padded to its largest bucket,
        per-row logit positions, the row count padded to a power of two
        (padding rows repeat row 0 and are dropped); each member's first
        token is drawn in the same job, each with its own generator."""
        B = len(batch)
        bucket = _bucket(max(item[1] for item in batch))
        Bp = 1
        while Bp < B:
            Bp *= 2
        ids = np.zeros((Bp, bucket), np.int64)
        for b, (h, L, *_) in enumerate(batch):
            ids[b, :L] = h[:L]
        ids[B:] = ids[0]
        pos = np.asarray([item[1] - 1 for item in batch] + [0] * (Bp - B),
                         np.int64)
        firsts = [item[2] or (0.0, 0, 1.0, None) for item in batch]

        def job():
            logits, small = self._prefill_rows(ids, pos)
            dev = self.device
            with torch.no_grad():
                toks = sample_tokens(
                    logits[:B],
                    torch.tensor([f[0] for f in firsts], device=dev),
                    torch.tensor([f[1] for f in firsts], device=dev),
                    torch.tensor([f[2] for f in firsts], device=dev),
                    [f[3] for f in firsts])
                return logits, small, toks.tolist()

        rec = self._prefill_record((Bp, bucket),
                                   sum(item[1] for item in batch), None)
        for item in batch:
            item[3].jobs.append(rec)
            item[3].bucket = bucket
        logits, small, toks = await self._on_device(job, rec=rec)
        self.prefill_batch_stats["groups"] += 1
        self.prefill_batch_stats["requests"] += B
        for b, (_, _, first, _, f) in enumerate(batch):
            if not f.done():  # the caller may have gone meanwhile
                f.set_result((logits[b:b + 1],
                              {"k": _each(lambda t: t[:, b:b + 1], small["k"]),
                               "v": _each(lambda t: t[:, b:b + 1], small["v"])},
                              None if first is None else toks[b]))

    # -- public ----------------------------------------------------------
    async def generate(self, prompt_ids, n_new: int, temperature: float = 0.0,
                       seed: int = 0, top_k: int = 0, top_p: float = 1.0,
                       stop_tokens=(), priority: int = 0,
                       admit_timeout: Optional[float] = None):
        """Generate up to ``n_new`` tokens; returns ``[1, L0 + n_generated]``
        (prompt + new tokens).  See :meth:`stream`."""
        prompt = _host_ids(prompt_ids)
        out_new = []
        if n_new > 0:
            out_new = [
                t async for t in self.stream(
                    prompt, n_new, temperature=temperature, seed=seed,
                    top_k=top_k, top_p=top_p, stop_tokens=stop_tokens,
                    priority=priority, admit_timeout=admit_timeout,
                )
            ]
        ids = np.concatenate([prompt, np.asarray(out_new, np.int32)])
        return torch.from_numpy(ids.astype(np.int32))[None, :]

    async def stream(self, prompt_ids, n_new: int, temperature: float = 0.0,
                     seed: int = 0, top_k: int = 0, top_p: float = 1.0,
                     stop_tokens=(), priority: int = 0,
                     admit_timeout: Optional[float] = None):
        """Async generator of generated token ids as they are sampled.

        ``stop_tokens`` end generation early (the stop token is yielded);
        ``top_k=0`` / ``top_p>=1`` disable those filters; ``temperature=0``
        is greedy.  ``priority`` orders admission waiters (higher first) and
        lets a waiter preempt a strictly lower class; ``admit_timeout``
        (seconds) sheds a request still waiting for a slot or pages with
        :class:`AdmissionDeadlineError`.  A preempted request is never
        shed.  Abandoning the generator releases the slot."""
        t_arrive = time.perf_counter()
        host_ids = _host_ids(prompt_ids)
        L0 = int(host_ids.shape[0])
        if L0 + n_new > self.max_len:
            raise ValueError(
                f"prompt {L0} + n_new {n_new} exceeds max_len {self.max_len}")
        if n_new <= 0:
            return
        deadline = (
            None if admit_timeout is None
            else asyncio.get_running_loop().time() + float(admit_timeout)
        )
        req = RequestRecord(self.engine_id, t_arrive, L0)
        REQUESTS.add(req)
        st = None
        try:
            slot = await self._acquire_slot(priority=priority,
                                            deadline=deadline)
            req.t_slot = time.perf_counter()
            try:
                gen = None
                if temperature > 0:
                    gen = torch.Generator(device=self.device)
                    gen.manual_seed(int(seed))
                # the first token is drawn on the worker right after the
                # last logits; the insert comes later, so a tick in flight
                # meanwhile cannot see the slot
                _, small, first_tok, d_small = await self._prefill_into_slot(
                    slot, host_ids, L0, n_new, priority=priority,
                    deadline=deadline,
                    first=(float(temperature), int(top_k), float(top_p), gen),
                    req=req)
                self._temps[slot] = float(temperature)
                self._topk[slot] = int(top_k)
                self._topp[slot] = float(top_p)
                st = _Slot(queue=asyncio.Queue(), remaining=n_new, tokens=[],
                           stop=frozenset(int(t) for t in stop_tokens),
                           priority=int(priority), seq=self._next_seq(),
                           slot=slot, prompt=host_ids)
                # no awaits from here to the registration below
                self._gens[slot] = gen
                self._gen_state[slot] = (None if gen is None
                                         else gen.get_state())
                self._finalize_admission(slot, st, small, d_small, L0,
                                         host_ids)
            except BaseException:
                self._release_slot(slot)
                raise
            self._slots[slot] = st
            req.t_first = time.perf_counter()
            self._emit(slot, st, first_tok)
            if slot in self._slots:  # not already finished by stop/n_new=1
                self._ensure_ticking()
                self._recheck_preemption()
            try:
                while True:
                    item = await st.queue.get()
                    if item is _DONE:
                        req.outcome = "ok"
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                # the consumer walked away (or finished): ``st.slot``, not
                # the local, since a resume may have moved the request
                st.cancelled = True
                if self._slots.get(st.slot) is st:
                    self._finish(st.slot, st)
        except AdmissionDeadlineError:
            req.outcome = "shed"
            raise
        except (GeneratorExit, asyncio.CancelledError):
            req.outcome = "cancelled"
            raise
        except BaseException:
            req.outcome = "error"
            raise
        finally:
            req.t_done = time.perf_counter()
            req.tokens = 0 if st is None else len(st.tokens)
            parent = current_span()
            if parent is not None:
                add_request_spans(parent, req)

    # -- admission internals ---------------------------------------------
    async def _prefill_into_slot(self, slot: int, host_ids, L0: int,
                                 n_new: int, *, priority: int = 0,
                                 deadline: Optional[float] = None,
                                 first=None, req: RequestRecord):
        """Admission tail shared by :meth:`stream` and a preemption resume
        (:meth:`_readmit`): prefix resolution, capacity reservation and the
        prefill variant, then the draft's prefill of the whole prompt when
        speculating.  Returns ``(last-position logits [1, V], 1-row cache,
        first token, the draft's 1-row cache or None)``, the token drawn as
        ``first`` says (:meth:`_sample_first`; None for a resume); the
        caller then calls :meth:`_finalize_admission` with no await between
        it and the slot's registration.  ``req``: the request's record (a
        resume's own, outside the ring)."""
        logits, small, tok = await self._target_prefill(
            slot, host_ids, L0, n_new, priority=priority, deadline=deadline,
            first=first, req=req)
        d_small = None
        if self.draft_params is not None:
            b = _bucket(L0)
            d_small = await self._on_device(
                self._draft_prefill, host_ids, L0, rec=self._job(
                    "draft_prefill", (1, b), tokens=L0, padded=b))
        return logits, small, tok, d_small

    async def _target_prefill(self, slot: int, host_ids, L0: int, n_new: int,
                              *, priority: int, deadline: Optional[float],
                              first, req: RequestRecord):
        # prefixes are matched AFTER the slot is held (one may have been
        # registered meanwhile) and BEFORE the reservation, so the paged
        # engine reserves only the pages the prefix does not cover
        pref = (self._match_prefix(tuple(int(t) for t in host_ids))
                if self._prefixes else None)
        if self._auto_budget:
            # an automatic entry wins only when strictly longer than the
            # registered one (which also carries whole-prompt logits)
            self.prefix_stats["auto_admissions"] += 1
            auto = self._match_auto(host_ids, L0)
            if auto is not None and (pref is None or auto["len"] > pref["len"]):
                self._auto_touch(auto)
                pref = auto
        # the paged engine pins the prefix's shared pages now, before any
        # await, so a concurrent clear_prefixes defers their release
        self._note_prefix(slot, pref)
        await self._reserve_capacity(slot, L0, n_new, priority=priority,
                                     deadline=deadline)
        req.t_reserved = time.perf_counter()
        # a ring-eligible prompt prefills sequence-parallel (per-rank work
        # L/tp): chunking it into small dense buckets would turn off the
        # path the operator asked for, so the ring takes precedence
        use_ring = self._ring_eligible(_bucket(L0))
        chunking = bool(self.chunk_prefill and L0 > self.chunk_prefill
                        and not use_ring)
        if pref is not None and pref["len"] == L0:
            # the whole prompt is a registered prefix: no model work (the
            # entry is read on the worker, after its prefill has filled it)
            def hit():
                return (pref["logits"], {"k": pref["k"], "v": pref["v"]},
                        self._sample_first(pref["logits"], first))

            req.variant = "prefix"
            return await self._on_device(hit, rec=self._job("prefix_hit",
                                                            req=req))
        if pref is not None and not (
                chunking and L0 - pref["len"] > self.chunk_prefill):
            # the prefix's K/V from the cache; only the suffix runs, one
            # K-token chunk padded to a bucket
            Lp, Ls = pref["len"], L0 - pref["len"]
            suffix = np.zeros((1, _bucket(Ls)), np.int64)
            suffix[0, :Ls] = host_ids[Lp:]
            req.variant = "extend"
            return await self._on_device(
                self._then_first(self._extend_job, first), pref, suffix, Lp,
                Ls - 1, rec=self._extend_record(pref, suffix, Ls, req))
        if pref is not None:
            # a long suffix after a prefix hit is chunked too
            req.variant = "chunked"
            return await self._extend_chunks(pref, pref["len"], host_ids, L0,
                                             first, req)
        if chunking:
            req.variant = "chunked"
            return await self._chunked_prefill(host_ids, L0, first, req)
        if self.batch_prefill_ms and not use_ring and priority <= 0:
            # classes above 0 skip the window: they pay to avoid its wait
            req.variant = "batched"
            return await self._batched_prefill(host_ids, L0, first, req)
        padded = np.zeros((1, _bucket(L0)), np.int64)
        padded[0, :L0] = host_ids
        req.variant = "solo"
        return await self._on_device(
            self._then_first(self._prefill_rows, first), padded, L0 - 1,
            rec=self._prefill_record(padded.shape, L0, req))

    def _finalize_admission(self, slot: int, st: _Slot, small, d_small,
                            L0: int, host_ids, store_auto: bool = True
                            ) -> None:
        """Make the admitted request visible to ticks: set its position and
        queue the cache inserts (the draft's too) and the automatic prefix
        entry's copy on the device worker.  No await: it runs before any
        tick submitted after this point.  ``store_auto=False`` on a resume:
        a prompt plus its generated tokens is not a future prompt."""
        self._pos[slot] = L0
        entry = (self._auto_store(host_ids, L0)
                 if store_auto and self._auto_budget else None)
        insert = self._insert_job(small, slot, L0)

        def job():
            with torch.no_grad():
                insert()
                if d_small is not None:
                    for name in ("k", "v"):
                        _each(lambda c, s: c[:, slot, :L0].copy_(
                            s[:, 0, :L0].to(c.device, c.dtype)),
                            self.draft_cache[name], d_small[name])
                if entry is not None:
                    entry["k"] = _each(lambda t: t[:, :, :L0].clone(),
                                       small["k"])
                    entry["v"] = _each(lambda t: t[:, :, :L0].clone(),
                                       small["v"])

        fut = self._on_device(job, rec=self._job("insert", L0))

        def done(f, st=st):
            if not f.cancelled() and f.exception() is not None:
                logger.error("cache insert failed: %r", f.exception())
                if self._slots.get(st.slot) is st:
                    self._finish(st.slot, st, exc=f.exception())

        fut.add_done_callback(done)

    async def _reserve_capacity(self, slot: int, L0: int, n_new: int, *,
                                priority: int = 0,
                                deadline: Optional[float] = None) -> None:
        """Capacity admission hook: the slab's capacity is the slot itself
        (pages in :class:`PagedLLMEngine`)."""

    def _note_prefix(self, slot: int, pref) -> None:
        """Prefix-aliasing hook: the slab copies prefix K/V into the slot
        (:class:`PagedLLMEngine` maps shared pages)."""

    def _next_seq(self) -> int:
        self._admit_seq += 1
        return self._admit_seq

    def _shed(self, what: str):
        self.preempt_stats["shed"] += 1
        raise AdmissionDeadlineError(
            f"admission deadline exceeded waiting for {what}") from None

    async def _wait_admission(self, waiters: list, item: tuple,
                              deadline: Optional[float], return_pool, wake,
                              what: str):
        """Deadline-bounded wait on a sorted admission queue whose wakes hand
        resources over through the future (``item[-1]``).  On failure the
        waiter is dequeued, resources already handed over go back through
        ``return_pool``, and ``wake`` runs again; expiry sheds (504)."""
        fut: asyncio.Future = item[-1]
        loop = asyncio.get_running_loop()
        try:
            if deadline is None:
                return await fut
            timeout = deadline - loop.time()
            if timeout <= 0:
                raise asyncio.TimeoutError
            # shield: a timeout must not cancel the future, or resources
            # handed over concurrently would leak with it
            return await asyncio.wait_for(asyncio.shield(fut), timeout)
        except BaseException as e:
            waiters[:] = [w for w in waiters if w is not item]
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                return_pool(fut.result())
            wake()
            if isinstance(e, asyncio.TimeoutError):
                self._shed(what)
            raise

    async def _acquire_slot(self, priority: int = 0,
                            deadline: Optional[float] = None) -> int:
        """Slot admission, class then FIFO; the freed slot is handed over
        through the waiter's future.  A waiter that outranks an active
        request preempts it (:meth:`_preempt_for_slot`)."""
        if self._free and not self._slot_waiters:
            return self._free.pop()
        what = f"an engine slot (all {self.max_slots} busy)"
        loop = asyncio.get_running_loop()
        if deadline is not None and deadline - loop.time() <= 0:
            # shed BEFORE preempting: a victim's work would be wasted
            self._shed(what)
        item = (-priority, self._next_seq(), loop.create_future())
        bisect.insort(self._slot_waiters, item)
        self._preempt_for_slot()
        return await self._wait_admission(
            self._slot_waiters, item, deadline,
            return_pool=self._free.append, wake=self._wake_slot_waiters,
            what=what,
        )

    def _release_slot(self, slot: int) -> None:
        self._gens[slot] = None
        self._gen_state[slot] = None
        # an idle slot's tick writes its row 0, which the next admission's
        # insert overwrites
        self._pos[slot] = 0
        self._free.append(slot)
        self._wake_slot_waiters()

    def _wake_slot_waiters(self) -> None:
        while self._free and self._slot_waiters:
            _, _, w = self._slot_waiters.pop(0)
            if not w.done():
                w.set_result(self._free.pop())
                break

    # -- preemption ------------------------------------------------------
    def _preempt_for_slot(self) -> None:
        """If the head slot waiter outranks an active request, preempt the
        cheapest victim: its slot frees at once and goes to the head."""
        if self._free or not self._slot_waiters:
            return
        victim = self._pick_victim(-self._slot_waiters[0][0])
        if victim is not None:
            self._preempt(*victim)
        elif self._pf_queue:
            # members of the batched window hold slots but are not yet
            # registered: flush so they register and can be preempted
            self._pf_wake().set()

    def _recheck_preemption(self) -> None:
        """After a request registers: a waiting higher class may have found
        no victim only because its candidates were mid-admission."""
        if self._slot_waiters:
            self._preempt_for_slot()

    def _pick_victim(self, priority: int):
        """Strictly lower class only; the lowest class first, then the most
        recent admission (the least work to redo).  None when nothing
        qualifies: equal classes wait."""
        cands = [(slot, st) for slot, st in self._slots.items()
                 if st.priority < priority]
        if not cands:
            return None
        return min(cands, key=lambda kv: (kv[1].priority, -kv[1].seq))

    def _preempt(self, slot: int, st: _Slot) -> None:
        """Take an active request off its slot (and pages): keep its
        sampling parameters and its generator's state after its latest
        emitted token, release the slot to the waiters, and schedule
        :meth:`_readmit`.  A tick in flight for it is discarded by the
        identity check, and its draw is redone from the kept state."""
        resume = (self._gen_state[slot], float(self._temps[slot]),
                  int(self._topk[slot]), float(self._topp[slot]))
        self._slots.pop(slot)
        st.slot = -1
        self.preempt_stats["preempted"] += 1
        self._release_slot(slot)
        t = asyncio.get_running_loop().create_task(self._readmit(st, *resume))
        self._resume_tasks.add(t)
        t.add_done_callback(self._resume_tasks.discard)

    async def _readmit(self, st: _Slot, gen_state, temp: float, top_k: int,
                       top_p: float) -> None:
        """Resume a preempted request: everything but the latest emitted
        token re-prefills (through the prefix caches when they hit), the
        slot then holds the state it had mid-flight (``pos = L - 1``, the
        latest token as the tick's input, the generator's kept state), and
        the next tick continues the chain.  It re-enters admission at its
        own class with no deadline."""
        try:
            if st.cancelled:
                return
            full = np.concatenate([st.prompt, np.asarray(st.tokens, np.int32)])
            ctx = full[:-1]  # the latest token is the next tick's input
            L1 = int(ctx.shape[0])
            slot = await self._acquire_slot(priority=st.priority)
            admitted = False
            try:
                if not st.cancelled:
                    # remaining + 1 keeps the original reservation's rows;
                    # the request's record keeps its first admission
                    _, small, _, d_small = await self._prefill_into_slot(
                        slot, ctx, L1, st.remaining + 1, priority=st.priority,
                        req=RequestRecord(self.engine_id, time.perf_counter(),
                                          L1))
                    self._temps[slot] = temp
                    self._topk[slot] = top_k
                    self._topp[slot] = top_p
                    if not st.cancelled:
                        # no awaits from here to the registration
                        gen = None
                        if gen_state is not None:
                            gen = torch.Generator(device=self.device)
                            gen.set_state(gen_state)
                        self._gens[slot] = gen
                        self._gen_state[slot] = gen_state
                        self._finalize_admission(slot, st, small, d_small,
                                                 L1, ctx, store_auto=False)
                        self._tokens[slot] = int(st.tokens[-1])
                        admitted = True
            finally:
                if not admitted:
                    self._release_slot(slot)
            if not admitted:
                return
            st.slot = slot
            self._slots[slot] = st
            self.preempt_stats["resumed"] += 1
            self._ensure_ticking()
            self._recheck_preemption()
        except BaseException as e:
            # the consumer must not hang on a silent queue
            st.queue.put_nowait(e)
            if not isinstance(e, Exception):
                raise

    # -- ticks -----------------------------------------------------------
    def _emit(self, slot: int, st: _Slot, tok: int) -> None:
        st.tokens.append(tok)
        st.remaining -= 1
        self._tokens[slot] = tok
        st.queue.put_nowait(tok)
        if st.remaining <= 0 or tok in st.stop:
            self._finish(slot, st)

    def _finish(self, slot: int, st: _Slot, exc=None) -> None:
        """Retire a slot: out of the active set, back to waiters, and the
        consumer's queue terminated (with ``exc`` on failure)."""
        self._slots.pop(slot, None)
        self._release_slot(slot)
        st.queue.put_nowait(_DONE if exc is None else exc)

    def _ensure_ticking(self) -> None:
        if self._tick_task is None or self._tick_task.done():
            self._tick_task = asyncio.get_running_loop().create_task(
                self._tick_loop())

    def _tick_state(self, active: dict) -> dict:
        """Snapshot of the host mirrors a tick runs on.  Slots not active
        decode greedily (their output is dropped)."""
        temps = self._temps.copy()
        gens: list = [None] * self.max_slots
        for slot in range(self.max_slots):
            if slot in active and self._gens[slot] is not None:
                gens[slot] = self._gens[slot]
            else:
                temps[slot] = 0.0
        return {"pos": self._pos.copy(), "tokens": self._tokens.copy(),
                "temps": temps, "top_k": self._topk.copy(),
                "top_p": self._topp.copy(), "gens": gens}

    async def _plain_tick(self) -> None:
        # snapshot by _Slot IDENTITY before dispatch: a request admitted to
        # a slot freed mid-tick must not receive the previous occupant's
        # token
        active = dict(self._slots)
        state = self._tick_state(active)
        rec = self._tick_job("tick", state, active)
        host_toks = await self._on_device(self._tick_device, state, rec=rec)
        for slot, st in active.items():
            if self._slots.get(slot) is not st:
                continue  # freed (and possibly re-occupied) mid-tick
            gen = state["gens"][slot]
            if gen is not None:
                self._gen_state[slot] = gen.get_state()
            self._pos[slot] += 1
            self._emit(slot, st, int(host_toks[slot]))

    async def _spec_tick(self) -> None:
        """A speculative tick: each slot emits its accepted drafts and one
        more token (1..k+1), then its position advances by what it emitted
        (rows written past that are masked).  A request that finishes
        mid-chunk (stop token, ``n_new``) drops the rest."""
        active = dict(self._slots)
        state = self._tick_state(active)
        rec = self._tick_job("spec", state, active)
        toks, n_emit = await self._on_device(self._spec_device, state, rec=rec)
        k = self.k_draft
        self.spec_stats["rounds"] += 1
        for slot, st in active.items():
            if self._slots.get(slot) is not st:
                continue  # freed (and possibly re-occupied) mid-tick
            gen = state["gens"][slot]
            if gen is not None:
                self._gen_state[slot] = gen.get_state()
            n = int(n_emit[slot])
            self.spec_stats["drafted"] += k
            self.spec_stats["accepted"] += n - 1
            pos0 = int(self._pos[slot])
            for tok in toks[slot, :n]:
                self._emit(slot, st, int(tok))
                if self._slots.get(slot) is not st:
                    break  # finished mid-chunk; the slot is released
            else:
                self._pos[slot] = pos0 + n

    def _tick_job(self, kind: str, state: dict, active: dict) -> JobRecord:
        """A tick's record: its active rows and the context tokens they
        attend (each row's position + 1)."""
        rows = list(active)
        return self._job(kind, rows=len(rows),
                         context=int(state["pos"][rows].sum()) + len(rows))

    async def _tick_loop(self) -> None:
        tick = (self._plain_tick if self.draft_params is None
                else self._spec_tick)
        try:
            while self._slots:
                await tick()
                await asyncio.sleep(0)  # let arrivals join between ticks
        except BaseException as e:
            # a dying tick loop must not strand in-flight requests
            for slot, st in list(self._slots.items()):
                self._finish(slot, st, exc=e)
            raise
        finally:
            self._tick_task = None


def _host_ids(prompt_ids) -> np.ndarray:
    if isinstance(prompt_ids, torch.Tensor):
        prompt_ids = prompt_ids.detach().cpu().numpy()
    return np.asarray(prompt_ids, np.int32).reshape(-1)


class PagedLLMEngine(LLMEngine):
    """Continuous batching over a PAGED KV cache (:mod:`.paged`): requests
    reserve ``ceil((L0 + n_new) / page_size)`` pages at admission (class
    then FIFO waiting when the pool is dry; a higher class preempts for
    pages), return them on release, and every tick runs
    :func:`paged_decode_step` (kernel K2 on the card).  A speculative
    engine verifies against the pages with :func:`paged_chunk_step` (no
    K2), and each reservation holds ``k_draft + 1`` more rows; the draft's
    cache stays a slab, ``k_draft + 1`` rows longer per slot.

    A registered prefix's FULL pages are held once in the pool and mapped
    into the table of every slot that hits it (refcounted; a cleared or
    replaced prefix's pages return when their last user releases).  Only
    full pages are shared, so a slot never writes a shared page: its rows
    past the prefix live in its own pages.

    With ``mesh`` the pool splits its KV-head axis over "tp" and each tick
    launches K2 once per rank and layer, on that rank's KV and query heads
    with its own merge counters.
    """

    def __init__(self, params: dict, cfg: TransformerConfig, paged,
                 max_slots: int = 16, max_len: Optional[int] = None,
                 **kwargs):
        if not isinstance(paged, PagedConfig):
            raise TypeError("paged must be a PagedConfig")
        if paged.n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the trash page)")
        self.paged_cfg = paged
        super().__init__(params, cfg, max_slots=max_slots, max_len=max_len,
                         **kwargs)
        # a single max-length request (with the speculative headroom) must
        # be admissible
        self.max_pp = paged.pages_for(self.max_len + self._headroom)
        if self.max_pp > paged.n_pages - 1:
            raise ValueError(
                f"max_len {self.max_len} (+{self._headroom} speculative "
                f"headroom) needs {self.max_pp} pages but the pool has "
                f"{paged.n_pages - 1} usable")
        self._free_pages = list(range(1, paged.n_pages))
        # page reservation queue: (-priority, seq, need, future), sorted
        self._page_waiters: list[tuple] = []
        self._tables = np.zeros((max_slots, self.max_pp), np.int32)
        self._reserved: dict[int, list] = {}
        # shared-prefix aliasing: the entry each aliased slot holds a
        # reference on, retired entries still referenced, pinned pages
        self._alias_used: dict[int, dict] = {}
        self._retired_prefixes: list[dict] = []
        self._pinned_pages = 0
        self.prefix_stats.update(alias_hits=0, alias_pages_saved=0)
        # K2's merge counters of this engine's ticks, made before any
        # capture (a graph holds their address)
        # (one set per tp rank under a mesh)
        self._arrivals = (arrival_counters(max_slots, cfg.n_heads,
                                           cfg.kv_heads, self.device,
                                           mesh=self.mesh)
                          if self.device.type == "cuda" else None)

    def _init_cache(self, cache_len: int):
        return init_paged_cache(self.cfg, self.paged_cfg, device=self.device,
                                mesh=self.mesh)

    def _tick_state(self, active: dict) -> dict:
        state = super()._tick_state(active)
        state["tables"] = self._tables.copy()
        return state

    def _tick_program(self) -> programs.Program:
        """One :func:`paged_decode_step` of every slot (K2 on the card)."""
        params, cfg, paged = self.params, self.cfg, self.paged_cfg
        cache, arrivals, mesh = self.cache, self._arrivals, self.mesh

        def fn(key, tokens, pos, tables):
            with torch.no_grad():
                logits, _ = paged_decode_step(params, cache, tables, pos,
                                              tokens, cfg=cfg, paged=paged,
                                              arrivals=arrivals, mesh=mesh)
            return logits

        return self._make("tick", fn, keep=(params, cache, arrivals),
                          answered=self._answered_rows)

    def _tick_inputs(self, state) -> tuple:
        return state["tokens"], state["pos"], state["tables"]

    def _answered_rows(self, key, host, out):
        """``out``'s rows of the slots whose current page is not the trash
        page: inactive slots write there together, any winner, so what
        they attend over may differ from run to run; nobody reads them.
        ``host`` holds ``pos`` second and the tables last."""
        pos, tables = host[1], host[-1]
        live = tables[np.arange(len(pos)), pos // self.paged_cfg.page_size]
        return out[torch.from_numpy(np.nonzero(live)[0]).to(out.device)]

    def _verify_logits(self, pos, vtokens, tables):
        """Verification against pages (:func:`paged_chunk_step`)."""
        logits, _ = paged_chunk_step(self.params, self.cache, tables, pos,
                                     vtokens, cfg=self.cfg,
                                     paged=self.paged_cfg, mesh=self.mesh)
        return logits

    def _rows_of(self, pages, start: int, end: int) -> torch.Tensor:
        ps = self.paged_cfg.page_size
        idx = np.arange(start, end)
        rows = np.asarray(pages, np.int64)[idx // ps] * ps + idx % ps
        return torch.from_numpy(rows)

    def _insert_job(self, small, slot: int, L0: int):
        # the shared pages are mapped now, in the no-await section: the
        # next tick sees the whole table together with pos = L0
        start = self._apply_alias(slot, L0)
        rows = self._rows_of(self._tables[slot], start, L0)

        def job():
            insert_rows(self.cache, small, rows.to(self.device), true_len=L0,
                        start=start)

        return job

    # -- shared-prefix page aliasing -------------------------------------
    def register_prefix(self, prefix_ids) -> None:
        """Besides the 1-row entry (the suffix extend still reads it), the
        prefix's FULL pages are written once into pinned pool pages that
        later admissions map instead of copying.  Pinning is skipped (copies
        then) when it would leave less than one max-length request's pages
        or would jump the page queue."""
        ids = tuple(int(t) for t in np.asarray(prefix_ids).reshape(-1))
        old = self._prefixes.get(ids)
        super().register_prefix(prefix_ids)
        if old is not None and old.get("shared_pages"):
            # the old entry's pinned pages must not leak: free them now, or
            # when the admissions attending over them release
            self._retire_prefix(old)
        entry = self._prefixes[ids]
        ps = self.paged_cfg.page_size
        full = entry["len"] // ps
        if full == 0:
            return  # shorter than a page: nothing to share
        usable = self.paged_cfg.n_pages - 1
        if (len(self._free_pages) < full or self._page_waiters
                or usable - (self._pinned_pages + full) < self.max_pp):
            logger.warning(
                "prefix of %d tokens needs %d pages to share; the pool cannot "
                "pin them without starving admissions - per-request copies",
                entry["len"], full)
            return
        pages = [self._free_pages.pop() for _ in range(full)]
        self._pinned_pages += full
        rows = self._rows_of(pages, 0, full * ps)
        # queued behind the entry's prefill, which fills entry["k"/"v"]
        self._device_job(lambda: insert_rows(
            self.cache, {"k": entry["k"], "v": entry["v"]},
            rows.to(self.device), true_len=full * ps), "prefix page write",
            self._job("insert", full * ps))
        entry["shared_pages"] = pages
        entry["refs"] = 0

    def _retire_prefix(self, entry: dict) -> None:
        if entry.get("refs", 0) > 0:
            self._retired_prefixes.append(entry)
        else:
            self._free_pages.extend(entry["shared_pages"])
            self._pinned_pages -= len(entry["shared_pages"])
            entry["shared_pages"] = []

    def clear_prefixes(self) -> None:
        """Shared pages return to the pool: at once when no slot maps them,
        else when the last one releases."""
        for entry in self._prefixes.values():
            if entry.get("shared_pages"):
                self._retire_prefix(entry)
        super().clear_prefixes()
        self._wake_page_waiters()

    def _note_prefix(self, slot: int, pref) -> None:
        """Take the winning shared-page prefix's reference NOW (before the
        reservation awaits), so a concurrent clear defers its pages."""
        if pref is not None and pref.get("shared_pages"):
            pref["refs"] = pref.get("refs", 0) + 1
            self._alias_used[slot] = pref
            self.prefix_stats["alias_hits"] += 1
            self.prefix_stats["alias_pages_saved"] += len(
                pref["shared_pages"])

    async def _reserve_capacity(self, slot: int, L0: int, n_new: int, *,
                                priority: int = 0,
                                deadline: Optional[float] = None) -> None:
        """Reserve the pages the request needs beyond its shared prefix,
        with the speculative headroom.  Waiters queue class then FIFO; a
        deadline sheds on expiry; a higher class preempts lower ones for
        pages (:meth:`_preempt_for_pages`)."""
        entry = self._alias_used.get(slot)
        shared = len(entry["shared_pages"]) if entry is not None else 0
        need = self.paged_cfg.pages_for(L0 + n_new + self._headroom)
        need -= min(shared, need)
        if not self._page_waiters and len(self._free_pages) >= need:
            pages = [self._free_pages.pop() for _ in range(need)]
        else:
            # join the queue even if pages would fit: jumping ahead of an
            # earlier equal-or-higher-class request would starve it
            what = f"{need} KV pages ({len(self._free_pages)} free)"
            loop = asyncio.get_running_loop()
            if deadline is not None and deadline - loop.time() <= 0:
                self._shed(what)
            item = (-priority, self._next_seq(), need, loop.create_future())
            bisect.insort(self._page_waiters, item)
            self._preempt_for_pages()
            pages = await self._wait_admission(
                self._page_waiters, item, deadline,
                return_pool=self._free_pages.extend,
                wake=self._wake_page_waiters, what=what,
            )
        self._reserved[slot] = pages
        self._tables[slot, :] = 0
        # own pages at their final places; the shared ones are mapped only
        # at insert (_apply_alias): until then a tick steps this slot at pos
        # 0, and with entry 0 unmapped that write lands in the trash page,
        # not in a page every user of the prefix reads
        self._tables[slot, shared:shared + need] = pages

    def _apply_alias(self, slot: int, true_len: int) -> int:
        """Map the aliased prefix's shared pages into the slot's table and
        return the row the insert starts at (0 when not aliased)."""
        entry = self._alias_used.get(slot)
        if entry is None or not entry.get("shared_pages"):
            return 0
        full = min(len(entry["shared_pages"]),
                   true_len // self.paged_cfg.page_size)
        if full == 0:
            return 0
        self._tables[slot, :full] = entry["shared_pages"][:full]
        return full * self.paged_cfg.page_size

    # -- page accounting -------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    def _wake_page_waiters(self) -> None:
        while self._page_waiters:
            _, _, need, fut = self._page_waiters[0]
            if fut.done():
                self._page_waiters.pop(0)
                continue
            if len(self._free_pages) < need:
                break  # strict order: later smaller requests wait too
            pages = [self._free_pages.pop() for _ in range(need)]
            self._page_waiters.pop(0)
            fut.set_result(pages)

    def _preempt_for_pages(self) -> None:
        """Free pages for a higher-class head waiter by preempting strictly
        lower classes, cheapest first; each release re-runs the wake, so
        pages flow straight to the head."""
        while self._page_waiters:
            negp, _, need, fut = self._page_waiters[0]
            if fut.done():
                self._page_waiters.pop(0)
                continue
            if len(self._free_pages) >= need:
                self._wake_page_waiters()
                continue
            victim = self._pick_victim(-negp)
            if victim is None:
                if self._pf_queue:
                    self._pf_wake().set()
                return
            self._preempt(*victim)

    def _recheck_preemption(self) -> None:
        super()._recheck_preemption()
        if self._page_waiters:
            self._preempt_for_pages()

    def _release_slot(self, slot: int) -> None:
        pages = self._reserved.pop(slot, None)
        # always unmap: an aliased slot's table points at shared pages
        self._tables[slot, :] = 0
        if pages:
            self._free_pages.extend(pages)
        entry = self._alias_used.pop(slot, None)
        if entry is not None:
            entry["refs"] -= 1
            retired = any(e is entry for e in self._retired_prefixes)
            if entry["refs"] == 0 and retired:
                self._retired_prefixes[:] = [
                    e for e in self._retired_prefixes if e is not entry]
                self._free_pages.extend(entry["shared_pages"])
                self._pinned_pages -= len(entry["shared_pages"])
                entry["shared_pages"] = []
        # inactive slots' ticks write to the trash page at offset 0
        super()._release_slot(slot)
        self._wake_page_waiters()


class LLMComponent:
    """Graph MODEL adapter: serves ``engine.generate`` through the
    component surface.

    Request: jsonData ``{"prompt_ids": [...], "n_new": N, "temperature": T,
    "top_k": K, "top_p": P, "stop": [ids...], "seed": S, "priority": C,
    "admit_timeout_ms": D}`` or a token-id tensor (``n_new`` from the
    component parameter).  Response: jsonData ``{"ids": [...],
    "prompt_len": L0}``, ids being prompt + generated tokens.
    """

    accepts_messages = True

    def __init__(self, engine: LLMEngine, n_new: int = 16, priority: int = 0,
                 admit_timeout_ms: Optional[float] = None,
                 max_priority: Optional[int] = None):
        self.engine = engine
        self.default_n_new = n_new
        self.default_priority = int(priority)
        self.default_admit_timeout_ms = (
            None if admit_timeout_ms is None else float(admit_timeout_ms))
        # cap on the per-request priority override (None = uncapped)
        self.max_priority = None if max_priority is None else int(max_priority)
        self.name = "llm"

    def has(self, method: str) -> bool:
        return method in ("predict", "stream")

    def _parse(self, msg):
        kw: dict[str, Any] = dict(priority=self.default_priority)
        if self.default_admit_timeout_ms is not None:
            kw["admit_timeout"] = self.default_admit_timeout_ms / 1000.0
        if msg.json_data is not None:
            spec = msg.json_data
            ids = spec["prompt_ids"]
            n_new = int(spec.get("n_new", self.default_n_new))
            kw.update(
                temperature=float(spec.get("temperature", 0.0)),
                top_k=int(spec.get("top_k", 0)),
                top_p=float(spec.get("top_p", 1.0)),
                stop_tokens=spec.get("stop", ()),
                seed=int(spec.get("seed", 0)),
            )
            prio = int(spec.get("priority", self.default_priority))
            if self.max_priority is not None:
                prio = min(prio, self.max_priority)
            kw["priority"] = prio
            if spec.get("admit_timeout_ms") is not None:
                kw["admit_timeout"] = float(spec["admit_timeout_ms"]) / 1000.0
        else:
            ids = np.asarray(msg.host_data(), np.int32).reshape(-1)
            n_new = self.default_n_new
        return ids, n_new, kw

    async def stream(self, msg):
        """Async generator of events: one ``{"token": t, "i": i}`` per
        generated token, then ``{"done": true, "ids": [...], ...}``."""
        ids, n_new, kw = self._parse(msg)
        ids = [int(t) for t in np.asarray(ids, np.int32).reshape(-1)]
        out = list(ids)
        i = 0
        t0 = time.perf_counter()
        ttft_ms = None
        async for tok in self.engine.stream(np.asarray(ids, np.int32), n_new,
                                            **kw):
            if ttft_ms is None:
                ttft_ms = (time.perf_counter() - t0) * 1000.0
            out.append(int(tok))
            yield {"token": int(tok), "i": i}
            i += 1
        dt = time.perf_counter() - t0
        yield {
            "done": True, "ids": out, "prompt_len": len(ids),
            "n_generated": i,
            "ttft_ms": round(ttft_ms, 3) if ttft_ms is not None else None,
            "duration_ms": round(dt * 1000.0, 3),
            "metrics": [m.to_dict() for m in self._request_metrics(i, dt)],
        }

    async def predict(self, msg):
        from seldon_core_tpu_torch.messages import Meta, SeldonMessage

        ids, n_new, kw = self._parse(msg)
        ids = np.asarray(ids, np.int32).reshape(-1)
        t0 = time.perf_counter()
        out = await self.engine.generate(ids, n_new, **kw)
        dt = time.perf_counter() - t0
        ids_out = out[0].tolist()
        meta = Meta(metrics=self._request_metrics(len(ids_out) - len(ids), dt))
        tags_fn = getattr(self, "tags", None)
        if callable(tags_fn):
            meta.tags.update(tags_fn() or {})
        return SeldonMessage(
            json_data={"ids": ids_out, "prompt_len": len(ids)}, meta=meta)

    def _request_metrics(self, n_gen: int, seconds: float):
        """The reference's per-request metrics: tokens, duration and rate,
        and the engine's speculative acceptance rate, prefix hit rate, page
        use and preemption gauges."""
        from seldon_core_tpu_torch.messages import Metric, MetricType

        out = [
            Metric("seldon_llm_tokens_generated_total", MetricType.COUNTER,
                   float(n_gen)),
            Metric("seldon_llm_generate_duration_seconds", MetricType.TIMER,
                   seconds * 1000.0),
        ]
        if n_gen > 0 and seconds > 0:
            out.append(Metric("seldon_llm_tokens_per_second",
                              MetricType.GAUGE, n_gen / seconds))
        st = self.engine.spec_stats
        if self.engine.draft_params is not None and st["drafted"]:
            out.append(Metric("seldon_llm_spec_accept_rate", MetricType.GAUGE,
                              st["accepted"] / st["drafted"]))
        ps = self.engine.prefix_stats
        if ps.get("auto_admissions"):
            # hits over the admissions that consulted the automatic cache
            out.append(Metric("seldon_llm_prefix_hit_rate", MetricType.GAUGE,
                              ps["auto_hits"] / ps["auto_admissions"]))
        free = getattr(self.engine, "free_pages", None)
        if free is not None:
            total = self.engine.paged_cfg.n_pages - 1
            out.append(Metric("seldon_llm_kv_pages_used_ratio",
                              MetricType.GAUGE,
                              (total - free) / max(total, 1)))
        pstats = self.engine.preempt_stats
        if pstats["preempted"] or pstats["shed"]:
            # cumulative counts as gauges; the *_total names are the
            # reference's deprecated aliases
            for name, key in (("seldon_llm_preempted", "preempted"),
                              ("seldon_llm_admission_shed", "shed"),
                              ("seldon_llm_preempted_total", "preempted"),
                              ("seldon_llm_admission_shed_total", "shed")):
                out.append(Metric(name, MetricType.GAUGE, float(pstats[key])))
        return out
