"""Always-on host sampling profiler: where the CPU cycles go.

A dedicated daemon thread wakes ``seldon.io/profile-hz`` times a second,
snapshots every other thread's stack via ``sys._current_frames()``, and
folds each stack into a bounded collapsed-flamegraph table — the
Google-Wide-Profiling posture: sampling is cheap enough to leave on in
production, so the profile of the incident is already captured when the
incident is noticed.

Folded keys are rooted at the sampled thread (``thread:MainThread``) and,
when one of the frames belongs to a *running* asyncio task, the task name
(``task:<name>``) — so flamegraphs separate the serving tasks from the
batch flusher from the health sampler even though they share one thread.

Capture windows (``/admin/profile/capture``) are baseline diffs against
the always-on table: opening a window snapshots the counts, reading it
subtracts — concurrent windows from both admin surfaces (gateway AND
engine proxying to the same plane, or two operators at once) each hold
their own baseline and can never corrupt the shared table.  A window may
also request a device trace: it enters the ``xla_profile`` context from
utils/tracing.py (``torch.profiler`` over CPU and CUDA activity), whose module-level re-entrancy guard makes overlapping
device-trace requests a warn-and-skip, never a crash.

Lock discipline: the table lock is private and nothing is called under it
— in particular never the metrics registry (its own lock would otherwise
order-couple with ours and a probe reading profiler stats could deadlock
the scrape path).

A copy of ``seldon_core_tpu/profiling/hostsampler.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
from typing import Optional

__all__ = ["HostSampler", "OVERFLOW_KEY"]

#: folded-stack key absorbing the tail once the table is full — bounded
#: cardinality can cost resolution, never memory
OVERFLOW_KEY = "(other)"

#: stack frames deeper than this are truncated leaf-side (a runaway
#: recursion must not make one sample O(recursion depth * hz))
_MAX_DEPTH = 128

#: concurrent capture windows (gateway + engine + a couple of operators)
_MAX_WINDOWS = 8

_SAMPLES_COUNTER = "seldon_profile_samples_total"
_STACKS_GAUGE = "seldon_profile_stacks"
_WINDOWS_GAUGE = "seldon_profile_windows_open"


def _frame_label(frame) -> str:
    code = frame.f_code
    base = os.path.basename(code.co_filename)
    if base.endswith(".py"):
        base = base[:-3]
    return f"{base}:{code.co_name}"


def _running_task_frames() -> dict:
    """id(frame) -> task name for every *currently running* asyncio task
    (one per loop).  Best-effort against private asyncio internals — an
    interpreter without them degrades to thread-only keys."""
    out: dict[int, str] = {}
    try:
        import asyncio.tasks as _tasks

        current = dict(getattr(_tasks, "_current_tasks", None) or {})
    except Exception:
        return out
    for task in current.values():
        try:
            coro = task.get_coro()
            frame = getattr(coro, "cr_frame", None) or getattr(
                coro, "gi_frame", None)
            if frame is not None:
                out[id(frame)] = task.get_name()
        except Exception:
            continue
    return out


class HostSampler:
    """Bounded folded-stack aggregator fed by a sampling daemon thread."""

    def __init__(self, hz: float = 19.0, max_stacks: int = 2000,
                 metrics=None, service: str = ""):
        self.hz = max(0.1, float(hz))
        self.interval_s = 1.0 / self.hz
        self.max_stacks = max(1, int(max_stacks))
        self.metrics = metrics
        self.service = service
        self._lock = threading.Lock()
        self._folded: dict[str, int] = {}
        self._windows: dict[str, dict] = {}
        self._window_ids = itertools.count(1)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.samples = 0
        self.sample_errors = 0
        self._started_at: Optional[float] = None

    # -- lifecycle ------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def ensure_started(self) -> bool:
        """Start the sampling thread; idempotent (serving-path lazy
        start, same contract as the health RuntimeSampler)."""
        if self.running:
            return True
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="profile-sampler", daemon=True)
        self._started_at = time.time()
        self._thread.start()
        return True

    def stop(self, timeout: float = 2.0) -> None:
        thread, self._thread = self._thread, None
        if thread is None or not thread.is_alive():
            return
        self._stop.set()
        thread.join(timeout)
        # close any device-trace window left open so profiler state
        # never outlives the plane
        with self._lock:
            windows = list(self._windows.values())
        for w in windows:
            self._close_device(w)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                self.sample_errors += 1

    # -- sampling -------------------------------------------------------
    def sample_once(self) -> int:
        """Sample every other thread once; returns stacks folded.
        Callable synchronously (tests, capture endpoints) as well as from
        the sampler thread."""
        me = threading.get_ident()
        sampler_ident = getattr(self._thread, "ident", None)
        try:
            frames = sys._current_frames()
        except Exception:
            self.sample_errors += 1
            return 0
        names = {t.ident: t.name for t in threading.enumerate()}
        task_frames = _running_task_frames()
        folds: list[str] = []
        for ident, frame in frames.items():
            if ident == me or ident == sampler_ident:
                continue
            stack: list[str] = []
            task_name = None
            f = frame
            depth = 0
            while f is not None and depth < _MAX_DEPTH:
                stack.append(_frame_label(f))
                if task_name is None:
                    task_name = task_frames.get(id(f))
                f = f.f_back
                depth += 1
            stack.reverse()  # root-first, collapsed-flamegraph order
            root = [f"thread:{names.get(ident, ident)}"]
            if task_name is not None:
                root.append(f"task:{task_name}")
            folds.append(";".join(root + stack))
        expired = []
        now = time.time()
        with self._lock:
            for fold in folds:
                if fold in self._folded or len(self._folded) < self.max_stacks:
                    self._folded[fold] = self._folded.get(fold, 0) + 1
                else:
                    self._folded[OVERFLOW_KEY] = (
                        self._folded.get(OVERFLOW_KEY, 0) + 1)
            self.samples += 1
            n_stacks = len(self._folded)
            n_windows = len(self._windows)
            for w in self._windows.values():
                if now > w["until"] and w.get("final") is None:
                    w["final"] = self._diff_locked(w["baseline"])
                    expired.append(w)
        # metrics strictly OUTSIDE the table lock (see module docstring)
        for w in expired:
            self._close_device(w)
        if self.metrics is not None:
            try:
                labels = {"service": self.service or "profiler"}
                self.metrics.counter_inc(_SAMPLES_COUNTER, labels,
                                         len(folds))
                self.metrics.gauge_set(_STACKS_GAUGE, n_stacks, labels)
                self.metrics.gauge_set(_WINDOWS_GAUGE, n_windows, labels)
            except Exception:
                pass
        return len(folds)

    # -- folded export --------------------------------------------------
    def _diff_locked(self, baseline: dict) -> dict:
        return {
            k: v - baseline.get(k, 0)
            for k, v in self._folded.items()
            if v - baseline.get(k, 0) > 0
        }

    @staticmethod
    def render(folded: dict, n: Optional[int] = None) -> str:
        """Collapsed flamegraph text (``stack count`` per line, hottest
        first) — the format flamegraph.pl / speedscope / tools/profview.py
        consume."""
        items = sorted(folded.items(), key=lambda kv: (-kv[1], kv[0]))
        if n is not None:
            items = items[:n]
        return "\n".join(f"{stack} {count}" for stack, count in items)

    def folded(self) -> dict:
        with self._lock:
            return dict(self._folded)

    def collapsed(self, n: Optional[int] = None) -> str:
        return self.render(self.folded(), n=n)

    def reset(self) -> None:
        """Zero the always-on table.  Open windows keep their baselines
        (their diffs clamp at 0 — a reset mid-window loses that window's
        pre-reset counts, never corrupts the table)."""
        with self._lock:
            self._folded.clear()

    # -- capture windows ------------------------------------------------
    def open_window(self, seconds: float,
                    device_dir: Optional[str] = None) -> dict:
        """Start one on-demand capture window: a baseline diff against
        the always-on table, optionally with an ``xla_profile`` device
        trace for its duration.  Raises ``ValueError`` on a bad length or
        too many concurrent windows."""
        seconds = float(seconds)
        if seconds <= 0:
            raise ValueError("capture window seconds must be > 0")
        device = None
        if device_dir:
            from seldon_core_tpu_torch.utils.tracing import xla_profile

            device = contextlib.ExitStack()
            try:
                device.enter_context(xla_profile(device_dir))
            except Exception:
                device = None
        now = time.time()
        with self._lock:
            too_many = len(self._windows) >= _MAX_WINDOWS
            if not too_many:
                wid = f"w{next(self._window_ids)}"
                self._windows[wid] = {
                    "id": wid,
                    "opened": now,
                    "until": now + seconds,
                    "baseline": dict(self._folded),
                    "baseline_samples": self.samples,
                    "device": device,
                    "device_dir": device_dir if device is not None else None,
                    "final": None,
                }
        if too_many:
            if device is not None:
                self._close_device({"device": device})
            raise ValueError(
                f"too many concurrent capture windows (max {_MAX_WINDOWS})")
        self.ensure_started()
        return {"id": wid, "until": now + seconds, "seconds": seconds,
                "device": device_dir if device is not None else None}

    def read_window(self, wid: str, stop: bool = False) -> Optional[dict]:
        """Window status/result.  A window past its deadline (or read with
        ``stop``) finalizes: diff frozen, device trace closed, entry
        removed — one-shot fetch."""
        now = time.time()
        close_device = None
        with self._lock:
            w = self._windows.get(wid)
            if w is None:
                return None
            done = stop or now > w["until"]
            if done and w.get("final") is None:
                w["final"] = self._diff_locked(w["baseline"])
            if done:
                self._windows.pop(wid, None)
                close_device = w
            folded = w["final"] if w.get("final") is not None \
                else self._diff_locked(w["baseline"])
            samples = self.samples - w["baseline_samples"]
        if close_device is not None:
            self._close_device(close_device)
        return {
            "id": wid,
            "done": done,
            "remainingS": max(0.0, round(w["until"] - now, 3)),
            "samples": samples,
            "stacks": len(folded),
            "folded": self.render(folded),
            "device": w.get("device_dir"),
        }

    @staticmethod
    def _close_device(w: dict) -> None:
        device, w["device"] = w.get("device"), None
        if device is not None:
            try:
                device.close()
            except Exception:
                pass

    # -- stats ----------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            n_stacks = len(self._folded)
            total = sum(self._folded.values())
            windows = [
                {"id": w["id"], "until": w["until"],
                 "device": w.get("device_dir")}
                for w in self._windows.values()
            ]
        return {
            "running": self.running,
            "hz": self.hz,
            "samples": self.samples,
            "sampleErrors": self.sample_errors,
            "stacks": n_stacks,
            "stackCap": self.max_stacks,
            "folds": total,
            "windows": windows,
            "startedAt": self._started_at,
        }
