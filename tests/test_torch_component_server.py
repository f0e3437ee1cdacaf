"""The port's component server and engine routes against the reference's on
the CPU.

- Every ``ComponentServer`` route of the port answers the status and JSON
  of the reference's ``ComponentServer`` (booted on aiohttp here) for the
  same component and the same request: the message routes with ``ndarray``,
  ``tensor`` and ``binTensor`` payloads, ``/route``, ``/aggregate``,
  ``/send-feedback``, the error bodies (empty, not JSON, not a
  SeldonMessage, a failing component), ``/health/status``, the series of
  ``/metrics`` and ``/seldon.json``.
- The engine routes ``/pause``, ``/unpause``, ``/ready``, ``/metrics`` and
  ``/seldon.json``, and predictions while paused, answer as the
  reference's ``EngineServer`` does.
- The microservice CLI parses parameters as the reference's, serves REST
  and FRAMED from a subprocess, refuses GRPC naming its slice, and with
  ``--persistence 1`` restores a router's state after SIGTERM.

Every socket test runs under its own timeout (``_run``, urllib timeouts).
"""

import asyncio
import base64
import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
from seldon_core_tpu.serving import microservice as jmicro
from seldon_core_tpu.serving.rest import build_app, start_server
from seldon_core_tpu.utils.metrics import EngineMetrics as JMetrics
from seldon_core_tpu_torch import __version__
from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine
from seldon_core_tpu_torch.runtime.component import ComponentHandle as THandle
from seldon_core_tpu_torch.serving import microservice as tmicro
from seldon_core_tpu_torch.serving.rest import RestServer
from seldon_core_tpu_torch.utils.metrics import EngineMetrics as TMetrics

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120


def _run(coro, timeout: float = TIMEOUT):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class Echo:
    """A component with every method, written once for both packages."""

    class_names = ["a", "b"]

    def predict(self, X, names):
        return np.asarray(X) * 2.0

    def transform_input(self, X, names):
        return np.asarray(X) + 1.0

    def transform_output(self, X, names):
        return -np.asarray(X)

    def route(self, X, names):
        return int(np.asarray(X).sum() > 0)

    def aggregate(self, Xs, names_list):
        return np.mean([np.asarray(x) for x in Xs], axis=0)

    def send_feedback(self, X, names, reward, truth, routing=None):
        return None

    def tags(self):
        return {"version": "v3"}

    def metrics(self):
        return [{"key": "echo_calls", "type": "COUNTER", "value": 1},
                {"key": "echo_ms", "type": "TIMER", "value": 2.5},
                {"key": "echo_gauge", "type": "GAUGE", "value": 7}]


class Broken:
    def predict(self, X, names):
        raise ValueError("no luck")


def _request(port, path, body=None, ctype="application/json",
             method=None):
    """``(status, JSON or text)``."""
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": ctype},
                                 method=method or ("POST" if data is not None
                                                   else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            code, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode()


async def _both_servers(jtarget, ttarget, engine=False):
    """The reference's aiohttp app and the port's server over the same
    kind of target; returns ``(ref port, port port, stop)``."""
    kw = "engine" if engine else "component"
    runner = await start_server(build_app(**{kw: jtarget}), "127.0.0.1", 0)
    server = await RestServer(host="127.0.0.1", port=0,
                              **{kw: ttarget}).start()

    async def stop():
        await server.stop()
        await runner.cleanup()

    return runner.addresses[0][1], server.port, stop


def _series(text: str) -> list:
    """The series and their order in a Prometheus text, values dropped
    (latencies differ between two runs)."""
    return [ln.rsplit(" ", 1)[0] for ln in text.splitlines()]


_X = np.random.default_rng(0).normal(size=(2, 2))
_BIN = {"shape": [2, 2], "dtype": "float32",
        "b64": base64.b64encode(
            _X.astype(np.float32).tobytes()).decode()}
_MSG = {"data": {"names": ["x", "y"], "ndarray": _X.tolist()},
        "meta": {"puid": "p1", "tags": {"t": 1}}}
CASES = [
    ("/predict", _MSG),
    ("/predict", {"data": {"tensor": {"shape": [2, 2],
                                      "values": _X.ravel().tolist()}}}),
    ("/predict", {"data": {"names": ["x", "y"], "binTensor": _BIN}}),
    ("/predict", {"strData": "hello"}),
    ("/transform-input", _MSG),
    ("/transform-output", _MSG),
    ("/route", _MSG),
    ("/route", {"data": {"ndarray": (-_X).tolist()}}),
    ("/aggregate", {"seldonMessages": [_MSG, {"data": {
        "ndarray": (_X + 1).tolist()}}]}),
    ("/send-feedback", {"request": _MSG, "reward": 0.5}),
    ("/predict", b""),
    ("/predict", b"{not json"),
    ("/predict", {"data": {"neither": 1}}),
    ("/send-feedback", {"reward": "x"}),
    ("/aggregate", {"seldonMessages": [{"data": {"bad": 0}}]}),
]


def test_component_routes_answer_like_the_reference():
    async def run():
        jp, tp, stop = await _both_servers(
            JHandle(Echo(), name="echo"), THandle(Echo(), name="echo"))
        try:
            out = []
            for path, body in CASES:
                out.append((path, body, await asyncio.to_thread(
                    _request, jp, path, body), await asyncio.to_thread(
                    _request, tp, path, body)))
            # the reference's form-encoded body
            form = b"json=" + urllib.parse.quote(json.dumps(_MSG)).encode()
            out.append(("/predict", "form", await asyncio.to_thread(
                _request, jp, "/predict", form,
                "application/x-www-form-urlencoded"),
                await asyncio.to_thread(
                _request, tp, "/predict", form,
                "application/x-www-form-urlencoded")))
            for path in ("/health/status", "/metrics", "/seldon.json"):
                out.append((path, None,
                            await asyncio.to_thread(_request, jp, path),
                            await asyncio.to_thread(_request, tp, path)))
            return out
        finally:
            await stop()

    answers = _run(run())
    for path, body, (jc, jb), (tc, tb) in answers:
        assert tc == jc, (path, body, jb, tb)
        if path == "/metrics":
            assert _series(tb) == _series(jb)
            assert 'echo_calls{model_name="echo"} 7.0' in tb
        elif path == "/seldon.json":
            assert tb["info"].pop("version") == __version__
            jb["info"].pop("version")
            assert tb == jb
        else:
            assert tb == jb, (path, body)
    codes = [c for _, _, (c, _), _ in answers]
    # strData reaches predict as a str; unknown data as no tensor (500s)
    assert codes[:15] == [200, 200, 200, 500] + [200] * 6 + [400] * 2 + [
        500, 400, 500]


def test_failing_component_answers_500_like_the_reference():
    async def run():
        jp, tp, stop = await _both_servers(
            JHandle(Broken(), name="b"), THandle(Broken(), name="b"))
        try:
            return [await asyncio.to_thread(_request, p, "/predict", _MSG)
                    for p in (jp, tp)]
        finally:
            await stop()

    (jc, jb), (tc, tb) = _run(run())
    assert tc == jc == 500 and tb == jb
    assert tb["status"]["info"] == "ValueError: no luck"


def test_engine_routes_pause_metrics_and_spec_like_the_reference():
    """``/pause`` turns predictions, the stream and ``/ready`` into 503;
    ``/unpause`` restores them; ``/metrics`` holds the same series (node,
    request and feedback timers and counters, the custom metrics)."""
    node = {"name": "echo", "type": "MODEL"}

    async def run():
        jeng = JEngine(node, resolver=lambda u: JHandle(Echo(), name="echo"),
                       metrics_sink=JMetrics(deployment="d"), name="main")
        teng = TEngine(node, resolver=lambda u: THandle(Echo(), name="echo"),
                       metrics_sink=TMetrics(deployment="d"), name="main")
        jp, tp, stop = await _both_servers(jeng, teng, engine=True)
        steps = [("/api/v0.1/predictions", _MSG), ("/ready", None),
                 ("/pause", None), ("/api/v0.1/predictions", _MSG),
                 ("/api/v0.1/stream", _MSG), ("/ready", None),
                 ("/api/v0.1/feedback", {"reward": 1.0}),
                 ("/unpause", None), ("/ready", None),
                 ("/api/v0.1/predictions", _MSG),
                 ("/api/v0.1/stream", _MSG),
                 ("/api/v0.1/predictions", b"{bad"),
                 ("/metrics", None), ("/seldon.json", None)]
        try:
            out = []
            for path, body in steps:
                out.append((path, await asyncio.to_thread(
                    _request, jp, path, body), await asyncio.to_thread(
                    _request, tp, path, body)))
            return out
        finally:
            await stop()

    answers = _run(run())
    for path, (jc, jb), (tc, tb) in answers:
        assert tc == jc, (path, jb, tb)
        if path == "/metrics":
            assert _series(tb) == _series(jb)
            assert "seldon_api_model_feedback_total" in tb
        elif path == "/seldon.json":
            tb["info"].pop("version"), jb["info"].pop("version")
            assert tb == jb
        elif isinstance(jb, dict):
            jb.get("meta", {}).pop("puid", None)
            tb.get("meta", {}).pop("puid", None)
            assert tb == jb, path
        else:
            assert tb == jb, path
    codes = [c for _, (c, _), _ in answers]
    assert codes[:6] == [200, 200, 200, 503, 503, 503]
    assert codes[8:11] == [200, 200, 501]


# ---- the microservice CLI -------------------------------------------------

def test_parameters_and_cli_contract_match_the_reference():
    raw = json.dumps([{"name": "a", "value": "3", "type": "INT"},
                      {"name": "b", "value": "0.5", "type": "FLOAT"},
                      {"name": "c", "value": "true", "type": "BOOL"},
                      {"name": "d", "value": "x", "type": "STRING"}])
    assert tmicro.parse_parameters(raw) == jmicro.parse_parameters(raw)
    assert tmicro.parse_parameters("") == {}
    targs = tmicro.build_parser().parse_args(["m:C", "FRAMED"])
    jargs = jmicro.build_parser().parse_args(["m:C", "FRAMED"])
    for k in ("interface_name", "api_type", "service_type", "parameters",
              "port", "host", "persistence", "push_frequency"):
        assert getattr(targs, k) == getattr(jargs, k), k
    with pytest.raises(SystemExit, match="slice 4a-ii"):
        tmicro.main(["seldon_core_tpu_torch.graph.builtins:SimpleModel",
                     "GRPC", "--device", "cpu"])


def _boot(args, env=None):
    """Start the microservice; ``(process, port)`` once it serves."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.serving.microservice",
         *args, "--port", "0", "--host", "127.0.0.1", "--device", "cpu"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()
    if "serving" not in line:
        proc.kill()
        raise AssertionError(line + proc.stdout.read())
    return proc, int(line.strip().rsplit(":", 1)[1])


def _reap(proc, sig=signal.SIGTERM):
    proc.send_signal(sig)
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=30)


def test_microservice_serves_rest_and_framed_from_a_subprocess():
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.serving.framed import FramedClient

    cls = "seldon_core_tpu_torch.graph.builtins:SimpleModel"
    proc, port = _boot([cls, "REST"])
    try:
        assert _request(port, "/health/status") == (200, "ok")
        code, body = _request(port, "/predict", _MSG)
        assert code == 200 and body["data"]["names"] == ["svc1", "svc2",
                                                         "svc3"]
        code, spec = _request(port, "/seldon.json")
        assert code == 200 and "/predict" in spec["paths"]
    finally:
        _reap(proc)
    proc, port = _boot([cls, "FRAMED"])
    try:
        with FramedClient("127.0.0.1", port, timeout=30) as c:
            out = c.predict(SeldonMessage.from_ndarray(_X))
        assert out.names == ["svc1", "svc2", "svc3"]
        assert out.host_data().shape[0] == 2
    finally:
        _reap(proc)


def test_microservice_persistence_restores_a_router_after_sigterm(tmp_path):
    """``--persistence 1``: a router rewarded on branch 1 is stopped with
    SIGTERM (the final push), booted again, and routes as before."""
    env = {"SELDON_STATE_DIR": str(tmp_path), "PREDICTIVE_UNIT_ID": "eg",
           "SELDON_DEPLOYMENT_ID": "dep", "PREDICTOR_ID": "main"}
    params = json.dumps([{"name": "n_branches", "value": "2", "type": "INT"},
                         {"name": "epsilon", "value": "0", "type": "FLOAT"},
                         {"name": "seed", "value": "0", "type": "INT"}])
    args = ["seldon_core_tpu_torch.graph.builtins:EpsilonGreedy", "REST",
            "--service-type", "ROUTER", "--parameters", params,
            "--persistence", "1", "--push-frequency", "3600"]
    proc, port = _boot(args, env)
    try:
        assert _request(port, "/route", _MSG)[1]["data"]["ndarray"] == [[0]]
        fb = {"response": {"meta": {"routing": {"eg": 1}}}, "reward": 1.0}
        for _ in range(3):
            assert _request(port, "/send-feedback", fb)[0] == 200
        assert _request(port, "/route", _MSG)[1]["data"]["ndarray"] == [[1]]
    finally:
        assert _reap(proc) == 0
    assert (tmp_path / "persistence_dep_main_eg").exists() or any(
        tmp_path.iterdir())
    proc, port = _boot(args, env)
    try:
        assert _request(port, "/route", _MSG)[1]["data"]["ndarray"] == [[1]]
    finally:
        _reap(proc)
