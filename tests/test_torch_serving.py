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
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.models.llm_demo import DemoLLM as JDemoLLM
from seldon_core_tpu.operator.local import (
    LocalDeployment as JLocalDeployment,
    load_deployment_file,
)
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
         "--device", "cpu"],
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
    # the reference adds its prefix-cache hit rate (auto prefix caching is
    # on in its DemoLLM; it comes to the port in slice 3)
    assert port_keys == ref_keys - {"seldon_llm_prefix_hit_rate"}


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
