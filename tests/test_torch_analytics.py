"""The port's analytics generator (``seldon_core_tpu_torch/utils/
analytics.py``) against its own source and the reference's catalog.

The catalog lists every metric name the port's source emits (a grep of
``"seldon_..."`` literals over ``seldon_core_tpu_torch/``) and nothing
else; dashboard panels and alert rules name only catalogued metrics; each
metric the two packages share keeps the reference's kind and labels; the
metrics the port leaves out are exactly the gateway's, the fleet's, the
placement plane's (their slices are not ported) and the XLA compile
cache's (no counterpart).  The exposition stays scrapeable and the CLI's
artifacts parse.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from seldon_core_tpu.utils import analytics as janalytics
from seldon_core_tpu_torch.utils import analytics

REPO = os.path.join(os.path.dirname(__file__), "..")

#: ``"seldon_..."`` literals in the port that name no metric
NOT_METRICS = {
    "seldon_current_span",      # tracing contextvar
    "seldon_checkpoint",        # checkpoint metadata key
    "seldon_dtr_",              # shm segment name prefix
    "seldon_service_handler",   # gRPC handler factory
}


def emitted() -> set:
    names = set()
    root = os.path.join(REPO, "seldon_core_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py") and fn != "analytics.py":
                with open(os.path.join(dirpath, fn)) as f:
                    names |= set(re.findall(r'"(seldon_[a-z_]+)"', f.read()))
    names -= NOT_METRICS
    return {re.sub(r"_(bucket|count|sum)$", "", n) for n in names}


def catalog() -> dict:
    return {m.name: m for m in analytics.CATALOG}


def test_catalog_is_exactly_what_the_port_emits():
    names = set(catalog())
    assert len(names) == len(analytics.CATALOG)  # no duplicates
    assert emitted() == names


def test_shared_metrics_keep_the_reference_kind_and_labels():
    ref = {m.name: m for m in janalytics.CATALOG}
    for name, m in catalog().items():
        if name in ref:
            assert (m.kind, m.labels) == (ref[name].kind, ref[name].labels), \
                name
    left_out = set(ref) - set(catalog())
    assert all(n.startswith(("seldon_fleet_", "seldon_placement_",
                             "seldon_runtime_placement_",
                             "seldon_compile_cache_"))
               or n in ("seldon_api_server_ingress_seconds",
                        "seldon_api_gateway_retries_total")
               for n in left_out), left_out
    assert not any("jax" in m.help.lower() or "xla" in m.help.lower()
                   for m in analytics.CATALOG)


def _used(expr: str) -> set:
    return set(re.findall(r"(seldon_[a-z_]+?)(?:_bucket|_count|_sum)?\b",
                          expr))


@pytest.mark.parametrize("which", ["dashboard", "alerts"])
def test_expressions_name_only_catalogued_metrics(which):
    names = set(catalog())
    if which == "dashboard":
        exprs = [(p["title"], t["expr"])
                 for p in analytics.grafana_dashboard()["panels"]
                 for t in p["targets"]]
    else:
        exprs = [(r["alert"], r["expr"])
                 for g in analytics.alert_rules()["groups"]
                 for r in g["rules"]]
    assert exprs
    for title, expr in exprs:
        used = _used(expr)
        assert used and used <= names, (title, used - names)


def test_docs_and_cli_artifacts_parse():
    docs = analytics.metric_docs()
    for name in catalog():
        assert f"`{name}`" in docs
    for what, parse in (("dashboard", json.loads), ("docs", str)):
        out = subprocess.run(
            [sys.executable, "-m", "seldon_core_tpu_torch.utils.analytics",
             what], capture_output=True, text=True, cwd=REPO, timeout=120)
        assert out.returncode == 0, out.stderr
        assert parse(out.stdout)


def test_exposition_is_scrapeable_with_exemplars():
    from seldon_core_tpu_torch.utils.metrics import MetricsRegistry
    from seldon_core_tpu_torch.utils.tracing import TraceContext, trace_scope

    reg = MetricsRegistry()
    reg.counter_inc("seldon_batcher_shed_total",
                    {"batcher": "m", "reason": "queue_full"})
    with trace_scope(TraceContext("ab" * 16, "cd" * 8, True)):
        reg.observe("seldon_api_executor_server_requests_seconds", 0.02,
                    {"deployment": "d"})
    text = reg.render()
    assert 'seldon_batcher_shed_total{batcher="m",reason="queue_full"} 1' \
        in text
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series = line.split(" # ")[0]
            assert re.match(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$',
                            series), line
