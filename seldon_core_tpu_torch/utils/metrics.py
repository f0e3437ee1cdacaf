"""Prometheus-style metrics registry (port of
``seldon_core_tpu/utils/metrics.py``; no external dependencies).

The same externally visible scheme as the reference: engine request timers
tagged by deployment, predictor and node, the custom COUNTER / GAUGE /
TIMER metrics forwarded from component responses and stream events, and
the feedback counters, rendered as Prometheus text at ``GET /metrics``.
The text is the reference's line for line for the same observations.
Histogram exemplars (a bucket's last trace id) wait for the tracer, slice 5
of the port.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Iterable, Optional

from seldon_core_tpu_torch.messages import Metric, MetricType

__all__ = ["MetricsRegistry", "EngineMetrics"]

_DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0,
)


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class MetricsRegistry:
    """Thread-safe counter / gauge / histogram registry with labels.

    Series are capped per metric name (``max_series``): a label set that
    would mint a series past the cap is dropped and counted in
    ``seldon_metrics_dropped_series_total`` instead.
    """

    DROPPED_SERIES = "seldon_metrics_dropped_series_total"

    def __init__(self, max_series: int = 1000):
        self._lock = threading.Lock()
        self.max_series = max_series
        self._counters: dict[tuple, float] = defaultdict(float)
        self._gauges: dict[tuple, float] = {}
        self._hist_counts: dict[tuple, list[int]] = {}
        self._hist_sum: dict[tuple, float] = defaultdict(float)
        self._hist_total: dict[tuple, int] = defaultdict(int)
        # metric name -> count of distinct label sets across all kinds
        self._series_count: dict[str, int] = defaultdict(int)

    def _key(self, name: str, labels: Optional[dict]) -> tuple:
        return (name, tuple(sorted((labels or {}).items())))

    def _admit_locked(self, key: tuple, store: dict) -> bool:
        """Cardinality gate for a series about to be minted (lock held)."""
        if key in store:
            return True
        name = key[0]
        if self._series_count[name] >= self.max_series:
            dropped = (self.DROPPED_SERIES, (("metric", name),))
            if dropped not in self._counters:
                self._series_count[self.DROPPED_SERIES] += 1
            self._counters[dropped] += 1
            return False
        self._series_count[name] += 1
        return True

    def counter_inc(self, name: str, labels: Optional[dict] = None,
                    value: float = 1.0):
        key = self._key(name, labels)
        with self._lock:
            if not self._admit_locked(key, self._counters):
                return
            self._counters[key] += value

    def gauge_set(self, name: str, value: float,
                  labels: Optional[dict] = None):
        key = self._key(name, labels)
        with self._lock:
            if not self._admit_locked(key, self._gauges):
                return
            self._gauges[key] = value

    def observe(self, name: str, value: float,
                labels: Optional[dict] = None):
        """Histogram observation (seconds for timers)."""
        key = self._key(name, labels)
        with self._lock:
            if key not in self._hist_counts:
                if not self._admit_locked(key, self._hist_counts):
                    return
                self._hist_counts[key] = [0] * (len(_DEFAULT_BUCKETS) + 1)
            counts = self._hist_counts[key]
            for i, b in enumerate(_DEFAULT_BUCKETS):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._hist_sum[key] += value
            self._hist_total[key] += 1

    def timer(self, name: str, labels: Optional[dict] = None):
        registry = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                registry.observe(name, time.perf_counter() - self.t0, labels)

        return _Timer()

    def render(self) -> str:
        # snapshot under the lock, format outside it
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hist_counts = {k: list(v) for k, v in self._hist_counts.items()}
            hist_sum = dict(self._hist_sum)
            hist_total = dict(self._hist_total)

        lines: list[str] = []
        seen_types: set[str] = set()
        for (name, labels), v in sorted(counters.items()):
            if name not in seen_types:
                lines.append(f"# TYPE {name} counter")
                seen_types.add(name)
            lines.append(f"{name}{_fmt_labels(dict(labels))} {v}")
        for (name, labels), v in sorted(gauges.items()):
            if name not in seen_types:
                lines.append(f"# TYPE {name} gauge")
                seen_types.add(name)
            lines.append(f"{name}{_fmt_labels(dict(labels))} {v}")
        for key in sorted(hist_counts):
            name, labels = key
            ld = dict(labels)
            if name not in seen_types:
                lines.append(f"# TYPE {name} histogram")
                seen_types.add(name)
            cum = 0
            for i, b in enumerate(_DEFAULT_BUCKETS):
                cum += hist_counts[key][i]
                lines.append(
                    f'{name}_bucket{_fmt_labels({**ld, "le": repr(b)})} {cum}')
            cum += hist_counts[key][-1]
            lines.append(
                f'{name}_bucket{_fmt_labels({**ld, "le": "+Inf"})} {cum}')
            lines.append(f"{name}_sum{_fmt_labels(ld)} {hist_sum[key]}")
            lines.append(f"{name}_count{_fmt_labels(ld)} {hist_total[key]}")
        return "\n".join(lines) + "\n"


class EngineMetrics:
    """The sink the graph engine and the servers feed, with the reference's
    metric names: ``seldon_api_executor_*`` timers, custom metrics passed
    through, feedback counters."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 deployment: str = ""):
        self.registry = registry or MetricsRegistry()
        self.deployment = deployment

    def observe_node(self, predictor: str, node: str, seconds: float,
                     status: str = "ok") -> None:
        """``status`` is "ok" or "error"."""
        self.registry.observe(
            "seldon_api_executor_client_requests_seconds", seconds,
            {"deployment_name": self.deployment, "predictor_name": predictor,
             "model_name": node, "status": status})

    def observe_request(self, predictor: str, seconds: float,
                        code: int = 200) -> None:
        self.registry.observe(
            "seldon_api_executor_server_requests_seconds", seconds,
            {"deployment_name": self.deployment, "predictor_name": predictor,
             "code": str(code)})

    def merge_custom(self, node: str, metrics: Iterable[Metric]) -> None:
        for m in metrics:
            labels = {"model_name": node, **m.tags}
            if m.type == MetricType.COUNTER:
                self.registry.counter_inc(m.key, labels, m.value)
            elif m.type == MetricType.GAUGE:
                self.registry.gauge_set(m.key, m.value, labels)
            else:  # TIMER: milliseconds, as in the reference
                self.registry.observe(m.key, m.value / 1000.0, labels)

    def observe_feedback(self, predictor: str, reward: float) -> None:
        labels = {"deployment_name": self.deployment,
                  "predictor_name": predictor}
        self.registry.counter_inc("seldon_api_model_feedback_total", labels)
        self.registry.counter_inc("seldon_api_model_feedback_reward_total",
                                  labels, reward)

    def render(self) -> str:
        return self.registry.render()
