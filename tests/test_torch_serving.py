"""The port's serving stack on the CPU: the local runner booted on the
port's copy of the LLM graph answers ``POST /api/v0.1/predictions`` with the
reference engine's JSON shape, and on the same weights the port's
``LLMComponent`` answers the reference's ids exactly."""

import asyncio
import json
import os
import subprocess
import sys
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.messages import Feedback as JFeedback
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.models.llm_demo import DemoLLM as JDemoLLM
from seldon_core_tpu.operator.local import (
    LocalDeployment as JLocalDeployment,
    load_deployment_file,
)
from seldon_core_tpu.operator.spec import SeldonDeployment
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.graph.spec import load_deployment
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.models import transformer as ttf
from seldon_core_tpu_torch.operator.local import serve
from seldon_core_tpu_torch.runtime import llm as tllm
from seldon_core_tpu_torch.runtime.paged import PagedConfig

ROOT = Path(__file__).resolve().parents[1]
PORT_GRAPH = ROOT / "seldon_core_tpu_torch" / "examples" / "llm.json"
REF_GRAPH = ROOT / "examples" / "graphs" / "llm.json"
REQUEST = {"jsonData": {"prompt_ids": [3, 1, 4, 1, 5, 9, 2], "n_new": 5}}


def _post(port: int, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v0.1/predictions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read().decode()


@pytest.fixture(scope="module")
def reference_answer():
    local = JLocalDeployment(load_deployment_file(str(REF_GRAPH)))
    out = asyncio.run(local.predict(JMessage.from_dict(REQUEST)))
    return out.to_dict()


def test_graph_copy_differs_only_in_model_class():
    port = json.loads(PORT_GRAPH.read_text())
    ref = json.loads(REF_GRAPH.read_text())
    pp = port["spec"]["predictors"][0]["graph"]["parameters"]
    rp = ref["spec"]["predictors"][0]["graph"]["parameters"]
    assert [p for p in pp if p["name"] != "model_class"] == \
        [p for p in rp if p["name"] != "model_class"]
    dep = load_deployment(str(PORT_GRAPH))
    assert dep.graph.parameters["model_class"] == \
        "seldon_core_tpu_torch.models.llm_demo:DemoLLM"
    assert dep.graph.parameters["paged_pages"] == 65


def test_local_runner_cli_answers_reference_json_shape(reference_answer):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.operator.local",
         "--graph", str(PORT_GRAPH), "--port", "0", "--host", "127.0.0.1",
         "--grpc-port", "0", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = proc.stdout.readline()
        assert "serving deployment" in line, line
        port = int(line.strip().rsplit(":", 1)[1])
        assert _get(port, "/ready") == (200, "ready")
        assert _get(port, "/live") == (200, "live")
        code, body = _post(port, REQUEST)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    ref = reference_answer
    assert code == 200
    assert set(body) == set(ref) == {"meta", "status", "jsonData"}
    assert body["status"] == ref["status"]
    assert set(body["jsonData"]) == set(ref["jsonData"])
    assert body["jsonData"]["prompt_len"] == ref["jsonData"]["prompt_len"]
    ids = body["jsonData"]["ids"]
    assert ids[:7] == REQUEST["jsonData"]["prompt_ids"]
    assert len(ids) == len(ref["jsonData"]["ids"]) == 7 + 5
    assert all(0 <= t < 256 for t in ids)
    assert set(body["meta"]) == set(ref["meta"])
    assert body["meta"]["requestPath"] == ref["meta"]["requestPath"]
    assert body["meta"]["tags"] == ref["meta"]["tags"]
    assert len(body["meta"]["puid"]) == len(ref["meta"]["puid"])
    port_keys = {m["key"] for m in body["meta"]["metrics"]}
    ref_keys = {m["key"] for m in ref["meta"]["metrics"]}
    # both serve with automatic prefix caching on, so both report its hit
    # rate
    assert port_keys == ref_keys


def test_same_weights_same_answer():
    """The reference DemoLLM of llm.json and a port LLMComponent over its
    converted weights answer the same ids (greedy, int8 "full")."""
    dep = load_deployment(str(PORT_GRAPH))
    params = {k: v for k, v in dep.graph.parameters.items()
              if k != "model_class"}
    jdemo = JDemoLLM(**params)
    jc = jdemo.engine.cfg
    cfg = ttf.TransformerConfig(
        vocab_size=jc.vocab_size, d_model=jc.d_model, n_layers=jc.n_layers,
        n_heads=jc.n_heads, n_kv_heads=jc.n_kv_heads, d_ff=jc.d_ff,
        max_seq=jc.max_seq, dtype=torch.float32)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jdemo.engine.params))
    engine = tllm.PagedLLMEngine(
        tp, cfg, PagedConfig(params["paged_pages"], params["page_size"]),
        max_slots=params["max_slots"])
    comp = tllm.LLMComponent(engine, n_new=params["n_new"])

    async def both(body):
        j = await jdemo.predict(JMessage.from_dict(body))
        t = await comp.predict(SeldonMessage.from_dict(body))
        return j.to_dict(), t.to_dict()

    bodies = [REQUEST, {"jsonData": {"prompt_ids": list(range(1, 40))}},
              {"data": {"ndarray": [7, 7, 7]}}]
    for body in bodies:
        j, t = asyncio.run(both(body))
        assert t["jsonData"] == j["jsonData"]

    async def stream_events():
        return [ev async for ev in comp.stream(SeldonMessage.from_dict(REQUEST))]

    events = asyncio.run(stream_events())
    j, _ = asyncio.run(both(REQUEST))
    assert [ev["token"] for ev in events[:-1]] == j["jsonData"]["ids"][7:]
    assert events[-1]["done"] and events[-1]["ids"] == j["jsonData"]["ids"]
    assert events[-1]["n_generated"] == 5 and events[-1]["ttft_ms"] > 0
    engine.close()


async def test_rest_errors_and_keep_alive():
    server, _ = await serve(str(PORT_GRAPH), port=0, host="127.0.0.1",
                            device="cpu")
    try:
        port = server.port
        reader, writer = await asyncio.open_connection("127.0.0.1", port)

        async def call(method, path, body=b""):
            writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                         f"Content-Length: {len(body)}\r\n\r\n".encode()
                         + body)
            await writer.drain()
            status = (await reader.readline()).split()[1]
            n = 0
            while (h := await reader.readline()) != b"\r\n":
                if h.lower().startswith(b"content-length:"):
                    n = int(h.split(b":")[1])
            return int(status), json.loads(await reader.readexactly(n))

        # three requests on one connection (keep-alive)
        code, body = await call("POST", "/api/v0.1/predictions", b"{not json")
        assert code == 400 and body["status"]["status"] == "FAILURE"
        code, body = await call("GET", "/nowhere")
        assert code == 404
        code, body = await call(
            "POST", "/api/v0.1/predictions",
            json.dumps({"jsonData": {"prompt_ids": [1] * 125,
                                     "n_new": 8}}).encode())
        # prompt + n_new beyond max_seq 128: the reference engine's answer
        # for a component ValueError, 500 INTERNAL
        assert code == 500 and body["status"]["reason"] == "INTERNAL"
        assert "exceeds max_len" in body["status"]["info"]
    finally:
        await server.stop()


# ---- the BASELINE graphs -------------------------------------------------

BASELINE = ["iris", "mnist", "epsilon-greedy-mab", "ensemble",
            "iris-with-outlier"]


def _graph(name: str, root: Path, seed_router: bool) -> dict:
    d = json.loads((root / f"{name}.json").read_text())
    if seed_router and name == "epsilon-greedy-mab":
        # unseeded, the router explores from OS entropy: seed both copies
        d["spec"]["predictors"][0]["graph"]["parameters"].append(
            {"name": "seed", "value": "11", "type": "INT"})
    return d


def _share_weights(jlocal, tlocal) -> None:
    """Give every port model the reference's weights."""
    jengine = jlocal.predictors[0].engine
    for unit in tlocal.spec.graph.walk():
        if unit.resolved_type == "MODEL" and "model_class" in unit.parameters:
            params = jengine.node_impl(unit.name).user.params
            tlocal.engine.node_impl(unit.name).user.params = \
                convert.params_from_jax(jax.tree.map(np.asarray, params))


def _post_to(port: int, path: str, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _requests(name: str) -> list:
    rng = np.random.default_rng(len(name))
    if name.startswith("iris"):
        rows = [rng.normal([5.8, 3.0, 3.8, 1.2], 0.8, (n, 4))
                for n in (3, 1, 4, 2)]
        rows.append(np.full((1, 4), 30.0))  # an outlier
    else:
        rows = [rng.normal(size=(n, 784)) for n in (2, 1, 3)]
    return [{"data": {"ndarray": r.tolist()}} for r in rows]


def _same_answer(t: dict, j: dict) -> None:
    assert t["status"] == j["status"]
    tm, jm = dict(t["meta"]), dict(j["meta"])
    assert len(tm.pop("puid")) == len(jm.pop("puid"))
    assert tm == jm  # requestPath, routing, tags (outlier scores) exactly
    td, jd = t["data"], j["data"]
    assert td["names"] == jd["names"]
    tv, jv = np.asarray(td["ndarray"]), np.asarray(jd["ndarray"])
    assert tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, atol=1e-6)  # float32 probabilities
    np.testing.assert_array_equal(tv.argmax(-1), jv.argmax(-1))


@pytest.mark.parametrize("name", BASELINE)
async def test_local_runner_serves_each_baseline_graph_like_the_reference(
        name):
    """The port's copy of each graph over REST on the CPU, on the
    reference's weights, against the reference's LocalDeployment."""
    jlocal = JLocalDeployment(SeldonDeployment.from_dict(
        _graph(name, REF_GRAPH.parent, True)))
    server, tlocal = await serve(
        _graph(name, PORT_GRAPH.parent, True), port=0, host="127.0.0.1",
        device="cpu")
    try:
        _share_weights(jlocal, tlocal)
        for body in _requests(name):
            code, t = await asyncio.to_thread(
                _post_to, server.port, "/api/v0.1/predictions", body)
            j = (await jlocal.predict(JMessage.from_dict(body))).to_dict()
            assert code == 200
            _same_answer(t, j)
        if name == "epsilon-greedy-mab":
            # reward the branch the router did not take, through the wire
            taken = t["meta"]["routing"]["eg-router"]
            fb = {"request": _requests(name)[0],
                  "response": {"meta": {"routing":
                                        {"eg-router": 1 - taken}}},
                  "reward": 1.0}
            for _ in range(3):
                code, out = await asyncio.to_thread(
                    _post_to, server.port, "/api/v0.1/feedback", fb)
                assert code == 200 and out["status"]["status"] == "SUCCESS"
                await jlocal.send_feedback(JFeedback.from_dict(fb))
            routes = []
            for body in _requests(name):
                code, t = await asyncio.to_thread(
                    _post_to, server.port, "/api/v0.1/predictions", body)
                j = (await jlocal.predict(JMessage.from_dict(body))).to_dict()
                _same_answer(t, j)
                routes.append(t["meta"]["routing"]["eg-router"])
            # exploitation now picks the rewarded branch (epsilon 0.1)
            assert routes.count(1 - taken) >= 2
    finally:
        await server.stop()


@pytest.mark.parametrize("name", ["resnet50", "resnet50-int8"])
async def test_local_runner_serves_resnet50_graphs(name):
    """Full ResNet50 (224 x 224, 1000 classes, bf16) behind the batcher:
    concurrent single-image requests coalesce, and every answer is the
    in-process forward's (the same component; pad rows change no row)."""
    server, local = await serve(str(PORT_GRAPH.parent / f"{name}.json"),
                                port=0, host="127.0.0.1", device="cpu")
    try:
        x = np.random.default_rng(4).uniform(0, 255, (4, 224, 224, 3))
        x = np.round(x)  # JSON pixels are integers
        bodies = [{"data": {"ndarray": x[i:i + 1].tolist()}}
                  for i in range(4)]
        answers = await asyncio.gather(*(asyncio.to_thread(
            _post_to, server.port, "/api/v0.1/predictions", b)
            for b in bodies))
        handle = local.engine.node_impl(name).handle
        alone = handle.predict(SeldonMessage.from_ndarray(x)).host_data()
        for i, (code, body) in enumerate(answers):
            assert code == 200, body
            probs = np.asarray(body["data"]["ndarray"])
            assert probs.shape == (1, 1000)
            assert body["data"]["names"][:2] == ["class:0", "class:1"]
            assert body["meta"]["requestPath"] == {
                name: "ResNet50Model" if name == "resnet50"
                else "Int8ResNet50Model"}
            np.testing.assert_allclose(probs[0], alone[i], atol=1e-3)
            assert probs[0].argmax() == alone[i].argmax()
        stats = local.engine.node_impl(name)._batcher.stats
        assert stats["rows"] == 4 and stats["batches"] < 4
    finally:
        await server.stop()


async def test_feedback_route_errors():
    server, _ = await serve(str(PORT_GRAPH.parent / "iris.json"), port=0,
                            host="127.0.0.1", device="cpu")
    try:
        code, body = await asyncio.to_thread(
            _post_to, server.port, "/api/v0.1/feedback", {"reward": "x"})
        assert code == 400 and "bad Feedback" in body["status"]["info"]
        code, body = await asyncio.to_thread(
            _post_to, server.port, "/api/v0.1/feedback", {"reward": 0.5})
        assert code == 200 and body["status"]["status"] == "SUCCESS"
    finally:
        await server.stop()


async def test_large_bodies_do_not_starve_the_batcher():
    """Bodies that arrive together are decoded off the event loop, so the
    batcher's flush timers run between them: no request waits in the queue
    past ``shed_after_ms`` while others are still being decoded.  A body
    takes about 20 ms to decode, so 32 decoded back to back hold the first
    request for over 600 ms, while one decode ahead of it stays far below
    the 300 ms limit even on a loaded host."""
    d = json.loads((PORT_GRAPH.parent / "mnist.json").read_text())
    d["spec"]["annotations"].update({"seldon.io/batch-max-size": "4096",
                                     "seldon.io/batch-shed-after-ms": "300"})
    server, local = await serve(d, port=0, host="127.0.0.1", device="cpu")
    try:
        rng = np.random.default_rng(0)
        bodies = [{"data": {"ndarray": rng.normal(size=(64, 784)).tolist()}}
                  for _ in range(32)]
        loop = asyncio.get_running_loop()
        with ThreadPoolExecutor(32) as pool:  # not the server's executor
            answers = await asyncio.gather(*(loop.run_in_executor(
                pool, _post_to, server.port, "/api/v0.1/predictions", b)
                for b in bodies))
        assert [code for code, _ in answers] == [200] * 32
        assert local.engine.node_impl("mnist")._batcher.stats["shed"] == 0
    finally:
        await server.stop()
