"""Continuous-batching LLM serving over a paged KV cache (port of
``seldon_core_tpu/runtime/llm.py``).

- **Slots**: a request occupies one of ``max_slots`` slots for its lifetime
  and reserves ``ceil((L0 + n_new) / page_size)`` KV pages at admission;
  each tick decodes every slot in one pass (``paged_decode_step``).
- **Admission**: waiters for a slot or for pages queue by priority class,
  then arrival; a request with ``admit_timeout`` sheds with
  :class:`AdmissionDeadlineError` (HTTP 504) when it expires waiting.
- **Bucketed prefill**: prompts are right-padded to a power-of-two bucket
  (exact under causal attention) and only the last true position is
  projected through the vocab matrix.
- **Sampling on the device**: temperature / top-k / top-p are applied to
  the logits where they are; only the sampled ids reach the host.  Sampled
  draws come from a per-request ``torch.Generator`` seeded with the
  request's ``seed``; they cannot replay the reference's threefry draws, so
  the port holds sampling to the same distribution (:func:`filtered_probs`).

Device work (prefill, cache inserts, ticks) runs on ONE worker thread, in
submission order, so the event loop keeps serving while the card computes,
and the in-place cache updates never race.  The ordering argument is the
reference's: a tick submitted before an admission's insert writes only rows
the insert then overwrites, and a tick submitted after it sees the slot's
position already set.

Not in this slice (each raises ``NotImplementedError`` naming slice 3 when
asked for): the slab-cache engine, registered and automatic prefix
caching, page aliasing, speculative decoding, chunked / ring / batched
prefill, and preemption.  Without preemption a higher-priority waiter is
served first but does not evict a running request.
"""

from __future__ import annotations

import asyncio
import bisect
import collections
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.models.transformer import TransformerConfig, prefill
from seldon_core_tpu_torch.runtime.component import SeldonComponentError
from seldon_core_tpu_torch.runtime.paged import (
    PagedConfig,
    init_paged_cache,
    insert_rows,
    paged_decode_step,
)

__all__ = ["LLMEngine", "PagedLLMEngine", "LLMComponent",
           "AdmissionDeadlineError", "sample_tokens", "filtered_probs"]

logger = logging.getLogger(__name__)


class AdmissionDeadlineError(SeldonComponentError):
    """Admission deadline expired while the request waited for a slot or
    for KV pages: shed with HTTP 504 instead of queueing unboundedly."""

    def __init__(self, message: str):
        super().__init__(message, status_code=504, reason="DEADLINE_EXCEEDED")


def _later_slice(feature: str):
    raise NotImplementedError(f"{feature} comes with slice 3 of the port")


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


_DONE = object()  # end-of-stream sentinel on a slot's token queue


@dataclass
class _Slot:
    queue: asyncio.Queue  # generated token ids; _DONE / exception terminate
    remaining: int
    tokens: list
    stop: frozenset
    slot: int = -1


class LLMEngine:
    """Slot-based continuous batching over one transformer: the admission,
    streaming and tick machinery.  Its KV cache comes from the subclass;
    the reference's slab cache is not in this slice, so serve through
    :class:`PagedLLMEngine`.

    ``await engine.generate(prompt_ids, n_new)`` returns the ids ``[1, L0 +
    n_generated]`` as a CPU int32 tensor.
    """

    def __init__(
        self,
        params: dict,
        cfg: TransformerConfig,
        max_slots: int = 8,
        max_len: Optional[int] = None,
        draft_params: Optional[dict] = None,
        draft_cfg: Optional[TransformerConfig] = None,
        chunk_prefill: int = 0,
        mesh=None,
        auto_prefix_tokens: int = 0,
        ring_prefill: int = 0,
        batch_prefill_ms: float = 0.0,
    ):
        if draft_params is not None or draft_cfg is not None:
            _later_slice("speculative decoding (draft_params)")
        if chunk_prefill:
            _later_slice("chunked prefill (chunk_prefill)")
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh) comes with slice 6 of the port")
        if auto_prefix_tokens:
            _later_slice("automatic prefix caching (auto_prefix_tokens)")
        if ring_prefill:
            _later_slice("ring prefill (ring_prefill)")
        if batch_prefill_ms:
            _later_slice("batched admission prefill (batch_prefill_ms)")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.max_slots = max_slots
        self.max_len = max_len or cfg.max_seq
        self.cache = self._init_cache(self.max_len)
        self._slots: dict[int, _Slot] = {}
        self._free = list(range(max_slots))
        # slot admission queue: (-priority, seq, future), kept sorted
        self._slot_waiters: list[tuple] = []
        self._admit_seq = 0
        self.preempt_stats = {"shed": 0}  # admissions shed at deadline
        # per finished request: seconds to first token (from arrival) and
        # per later token, host clock; the latest 1024 requests
        self.latency_log: collections.deque = collections.deque(maxlen=1024)
        self._tick_task: Optional[asyncio.Task] = None
        # host mirrors of per-slot state, snapshotted into each tick
        self._tokens = np.zeros((max_slots,), np.int64)
        self._temps = np.zeros((max_slots,), np.float32)
        self._topk = np.zeros((max_slots,), np.int64)
        self._topp = np.ones((max_slots,), np.float32)
        self._pos = np.zeros((max_slots,), np.int32)
        self._gens: list[Optional[torch.Generator]] = [None] * max_slots
        # the ONE thread that runs device work, in submission order
        self._device_worker = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="llm-device")

    def _init_cache(self, cache_len: int):
        _later_slice("the slab KV cache (LLMEngine); use PagedLLMEngine")

    def close(self) -> None:
        """Stop the device worker thread (after its queued work)."""
        self._device_worker.shutdown(wait=True)

    def register_prefix(self, prefix_ids) -> None:
        _later_slice("registered prefix caching (register_prefix)")

    def _on_device(self, fn, *args):
        """Queue ``fn(*args)`` on the device worker; an awaitable future."""
        return asyncio.get_running_loop().run_in_executor(
            self._device_worker, fn, *args)

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
        is greedy.  ``priority`` orders admission waiters (higher first);
        ``admit_timeout`` (seconds) sheds a request still waiting for a slot
        or pages with :class:`AdmissionDeadlineError`.  Abandoning the
        generator releases the slot."""
        t_arrive = time.perf_counter()
        host_ids = _host_ids(prompt_ids)
        L0 = int(host_ids.shape[0])
        if L0 == 0:
            raise ValueError("empty prompt")
        if L0 + n_new > self.max_len:
            raise ValueError(
                f"prompt {L0} + n_new {n_new} exceeds max_len {self.max_len}")
        if n_new <= 0:
            return
        deadline = (
            None if admit_timeout is None
            else asyncio.get_running_loop().time() + float(admit_timeout)
        )
        slot = await self._acquire_slot(priority=priority, deadline=deadline)
        try:
            await self._reserve_capacity(slot, L0, n_new, priority=priority,
                                         deadline=deadline)
            gen = None
            if temperature > 0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(int(seed))
            self._temps[slot] = float(temperature)
            self._topk[slot] = int(top_k)
            self._topp[slot] = float(top_p)
            first_tok, small = await self._on_device(
                self._prefill_sample, host_ids, float(temperature),
                int(top_k), float(top_p), gen)
            st = _Slot(queue=asyncio.Queue(), remaining=n_new, tokens=[],
                       stop=frozenset(int(t) for t in stop_tokens),
                       slot=slot)
            # no awaits from here to the registration below
            self._gens[slot] = gen
            self._finalize_admission(slot, st, small, L0)
        except BaseException:
            self._release_slot(slot)
            raise
        self._slots[slot] = st
        t_first = time.perf_counter()
        self._emit(slot, st, first_tok)
        if slot in self._slots:  # not already finished by stop/n_new=1
            self._ensure_ticking()
        try:
            while True:
                item = await st.queue.get()
                if item is _DONE:
                    n = len(st.tokens)
                    self.latency_log.append({
                        "ttft_s": t_first - t_arrive, "tokens": n,
                        "tpot_s": ((time.perf_counter() - t_first) / (n - 1)
                                   if n > 1 else None),
                    })
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            if self._slots.get(st.slot) is st:
                self._finish(st.slot, st)

    # -- device work (runs on the device worker) -------------------------
    def _prefill_sample(self, host_ids, temp, top_k, top_p, gen):
        """Bucketed prefill of one prompt and its first sampled token."""
        L0 = int(host_ids.shape[0])
        b = _bucket(L0)
        padded = np.zeros((1, b), np.int64)
        padded[0, :L0] = host_ids
        dev = self.device
        with torch.no_grad():
            logits, small = prefill(
                self.params, torch.from_numpy(padded).to(dev), self.cfg,
                max_len=b, logit_pos=L0 - 1)
            tok = sample_tokens(
                logits, torch.tensor([temp], device=dev),
                torch.tensor([top_k], device=dev),
                torch.tensor([top_p], device=dev), [gen])
            return int(tok[0]), small

    def _tick_device(self, state):
        raise NotImplementedError

    # -- admission internals ---------------------------------------------
    def _finalize_admission(self, slot: int, st: _Slot, small, L0: int):
        """Make the admitted request visible to ticks: set its position and
        queue the cache insert on the device worker (no await: it runs
        before any tick submitted after this point)."""
        self._pos[slot] = L0
        fut = self._on_device(self._insert_job(small, slot, L0))

        def done(f, st=st):
            if not f.cancelled() and f.exception() is not None:
                logger.error("cache insert failed: %r", f.exception())
                if self._slots.get(st.slot) is st:
                    self._finish(st.slot, st, exc=f.exception())

        fut.add_done_callback(done)

    def _insert_job(self, small, slot: int, L0: int):
        """A callable for the device worker that writes the prefill K/V of
        an admission into the cache (read host state now, not later)."""
        raise NotImplementedError

    async def _reserve_capacity(self, slot: int, L0: int, n_new: int, *,
                                priority: int = 0,
                                deadline: Optional[float] = None) -> None:
        """Capacity admission hook (pages in :class:`PagedLLMEngine`)."""

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
        through the waiter's future."""
        if self._free and not self._slot_waiters:
            return self._free.pop()
        what = f"an engine slot (all {self.max_slots} busy)"
        loop = asyncio.get_running_loop()
        if deadline is not None and deadline - loop.time() <= 0:
            self._shed(what)
        item = (-priority, self._next_seq(), loop.create_future())
        bisect.insort(self._slot_waiters, item)
        return await self._wait_admission(
            self._slot_waiters, item, deadline,
            return_pool=self._free.append, wake=self._wake_slot_waiters,
            what=what,
        )

    def _release_slot(self, slot: int) -> None:
        self._gens[slot] = None
        self._free.append(slot)
        self._wake_slot_waiters()

    def _wake_slot_waiters(self) -> None:
        while self._free and self._slot_waiters:
            _, _, w = self._slot_waiters.pop(0)
            if not w.done():
                w.set_result(self._free.pop())
                break

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
        host_toks = await self._on_device(self._tick_device,
                                          self._tick_state(active))
        for slot, st in active.items():
            if self._slots.get(slot) is not st:
                continue  # freed (and possibly re-occupied) mid-tick
            self._pos[slot] += 1
            self._emit(slot, st, int(host_toks[slot]))

    async def _tick_loop(self) -> None:
        try:
            while self._slots:
                await self._plain_tick()
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
    then FIFO waiting when the pool is dry), return them on release, and
    every tick runs :func:`paged_decode_step` (kernel K2 on the card)."""

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
        self.max_pp = paged.pages_for(self.max_len)
        if self.max_pp > paged.n_pages - 1:
            raise ValueError(
                f"max_len {self.max_len} needs {self.max_pp} pages but the "
                f"pool has {paged.n_pages - 1} usable")
        self._free_pages = list(range(1, paged.n_pages))
        # page reservation queue: (-priority, seq, need, future), sorted
        self._page_waiters: list[tuple] = []
        self._tables = np.zeros((max_slots, self.max_pp), np.int32)
        self._reserved: dict[int, list] = {}

    def _init_cache(self, cache_len: int):
        return init_paged_cache(self.cfg, self.paged_cfg, device=self.device)

    def _tick_state(self, active: dict) -> dict:
        state = super()._tick_state(active)
        state["tables"] = self._tables.copy()
        return state

    def _tick_device(self, state):
        dev = self.device
        with torch.no_grad():
            logits, self.cache = paged_decode_step(
                self.params, self.cache,
                torch.from_numpy(state["tables"]).to(dev),
                torch.from_numpy(state["pos"]).to(dev),
                torch.from_numpy(state["tokens"]).to(dev),
                cfg=self.cfg, paged=self.paged_cfg,
            )
            toks = sample_tokens(
                logits, torch.from_numpy(state["temps"]).to(dev),
                torch.from_numpy(state["top_k"]).to(dev),
                torch.from_numpy(state["top_p"]).to(dev), state["gens"])
            return toks.cpu().numpy()

    def _insert_job(self, small, slot: int, L0: int):
        ps = self.paged_cfg.page_size
        idx = np.arange(L0)
        rows = self._tables[slot][idx // ps].astype(np.int64) * ps + idx % ps

        def job():
            with torch.no_grad():
                insert_rows(self.cache, small,
                            torch.from_numpy(rows).to(self.device),
                            true_len=L0)

        return job

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    async def _reserve_capacity(self, slot: int, L0: int, n_new: int, *,
                                priority: int = 0,
                                deadline: Optional[float] = None) -> None:
        need = self.paged_cfg.pages_for(L0 + n_new)
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
            pages = await self._wait_admission(
                self._page_waiters, item, deadline,
                return_pool=self._free_pages.extend,
                wake=self._wake_page_waiters, what=what,
            )
        self._reserved[slot] = pages
        self._tables[slot, :] = 0
        self._tables[slot, :need] = pages

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

    def _release_slot(self, slot: int) -> None:
        pages = self._reserved.pop(slot, None)
        self._tables[slot, :] = 0
        if pages:
            self._free_pages.extend(pages)
        # inactive slots' ticks write to the trash page at offset 0
        self._pos[slot] = 0
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
        free = getattr(self.engine, "free_pages", None)
        if free is not None:
            total = self.engine.paged_cfg.n_pages - 1
            out.append(Metric("seldon_llm_kv_pages_used_ratio",
                              MetricType.GAUGE,
                              (total - free) / max(total, 1)))
        pstats = self.engine.preempt_stats
        if pstats["shed"]:
            out.append(Metric("seldon_llm_admission_shed", MetricType.GAUGE,
                              float(pstats["shed"])))
        return out
