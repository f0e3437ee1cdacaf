"""The port imports neither jax, nor anything of the JAX package, nor
``safetensors`` (the port reads and writes the format itself), and only
its gRPC modules (``proto.*``, ``serving.grpc_api`` and the gRPC half of
``serving.native_http``) import ``grpc`` and ``google.protobuf``.  Both
import on the card's machine (``chip_smoke.py`` ``wire_env`` read grpc
1.80.0 and protobuf 6.33.6 there), but REST, the framed wire and the native
REST tier stand without them, and without ``aiohttp`` and ``ml_dtypes``:
every other module imports, and a checkpoint, a state blob and the wire
tiers round-trip (a framed call with the device plane on among them), and
a fused deployment boots with the artifact, device, tracing, health and
profiling planes, with those packages blocked.  A second probe imports the
gRPC modules and serves a gRPC call, still without jax or the JAX package.

This runs in subprocesses: the test process itself has jax imported (the
conftest pins its platform), so only a fresh interpreter with
``sys.modules["jax"] = None`` can show that every port module imports
without it.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["safetensors"] = None
for blocked in ("aiohttp", "grpc", "google.protobuf", "ml_dtypes"):
    sys.modules[blocked] = None
import seldon_core_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
GRPC_MODULES = ("seldon_core_tpu_torch.proto",
                "seldon_core_tpu_torch.serving.grpc_api")
for name in names:
    if not name.startswith(GRPC_MODULES):
        importlib.import_module(name)
# the gRPC half of the native tier needs grpc: it says so when made
from seldon_core_tpu_torch.serving.native_http import NativeGrpcServer
try:
    NativeGrpcServer(component=object())
    raise AssertionError("NativeGrpcServer made without protobuf")
except ImportError:
    pass
# careful: seldon_core_tpu_torch shares the prefix seldon_core_tpu
ref = sorted(m for m in sys.modules
             if m == "seldon_core_tpu" or m.startswith("seldon_core_tpu."))
jaxish = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith(("jax.", "jaxlib")))
                and sys.modules[m] is not None)
# a checkpoint written and read back without the package
import tempfile, torch
from seldon_core_tpu_torch.runtime import checkpoint
d = tempfile.mkdtemp()
checkpoint.save_checkpoint(d, {"w": torch.ones(2)}, {"family": "x"})
tree, meta = checkpoint.load_checkpoint(d)
assert tree["w"].tolist() == [1.0, 1.0] and meta == {"family": "x"}
# a state blob packed and read back without jax
from seldon_core_tpu_torch.runtime import persistence
assert persistence.unpack_state(persistence.pack_state({"a": [1]})) == {
    "a": [1]}
st = sorted(m for m in sys.modules
            if m.split(".")[0] == "safetensors" and sys.modules[m] is not None)
# the wire tiers without aiohttp, grpc, protobuf or ml_dtypes: a bfloat16
# binTensor and frame, a component server, a remote call, a framed call
import asyncio, numpy as np
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.native import FrameCodec
from seldon_core_tpu_torch.runtime.component import ComponentHandle
from seldon_core_tpu_torch.serving.client import RemoteComponent
from seldon_core_tpu_torch.serving.framed import (
    AsyncFramedClient, FramedComponentServer)
from seldon_core_tpu_torch.serving.rest import RestServer
bf = torch.arange(4).bfloat16()
m = SeldonMessage.from_dict(SeldonMessage(data=bf, encoding="binTensor")
                            .to_dict())
assert m.data.dtype == torch.bfloat16 and torch.equal(m.data, bf)
assert torch.equal(FrameCodec().decode(FrameCodec().encode(1, b"", [bf]))
                   .tensors[0], bf)
class Twice:
    def predict(self, X, names):
        return np.asarray(X) * 2
async def wire():
    srv = await RestServer(component=ComponentHandle(Twice()),
                           host="127.0.0.1", port=0).start()
    fsrv = FramedComponentServer(ComponentHandle(Twice())).start()
    try:
        rc = RemoteComponent(f"http://127.0.0.1:{srv.port}")
        a = await rc.predict(SeldonMessage.from_ndarray(
            np.ones((1, 2)), encoding="binTensor"))
        fc = await AsyncFramedClient(timeout=30).connect("127.0.0.1",
                                                         fsrv.port)
        b = await fc.predict(SeldonMessage.from_ndarray(np.ones((1, 2))))
        fc.close()
        await rc.close()
        return a.host_data().tolist(), b.host_data().tolist()
    finally:
        fsrv.stop()
        await srv.stop()
assert asyncio.run(asyncio.wait_for(wire(), 60)) == ([[2.0, 2.0]],) * 2
# a framed call with the device plane on (the tensor rides a pooled shm
# lane), without jax
from seldon_core_tpu_torch.runtime.device_plane import (
    DevicePlane, DevicePlaneConfig)
from seldon_core_tpu_torch.runtime.device_registry import registry
from seldon_core_tpu_torch.serving.framed import FramedClient
registry.device = torch.device("cpu")
plane = DevicePlane(DevicePlaneConfig(enabled=True, remote="shm"))
with FramedComponentServer(ComponentHandle(Twice()),
                           device_plane=plane) as psrv:
    pc = FramedClient(port=psrv.port, device_plane=plane, timeout=30)
    try:
        po = pc.predict(SeldonMessage.from_ndarray(np.ones((1, 2))))
        assert pc._device_mode == "shm" and po.device_wire_mode == "shm"
        assert po.host_data().tolist() == [[2.0, 2.0]]
    finally:
        pc.close()
# a fused, cached two-predictor deployment without jax
from seldon_core_tpu_torch.graph.spec import load_deployment
from seldon_core_tpu_torch.operator.local import LocalDeployment
mlp = {"name": "m", "type": "MODEL", "parameters": [
    {"name": "model_class", "type": "STRING",
     "value": "seldon_core_tpu_torch.models.mlp:MNISTMLP"},
    {"name": "hidden", "value": "8", "type": "INT"}]}
import tempfile
local = LocalDeployment(load_deployment({"spec": {"name": "d", "annotations": {
    "seldon.io/graph-plan": "fused", "seldon.io/prediction-cache": "true",
    "seldon.io/artifact-store": tempfile.mkdtemp(),
    "seldon.io/device-plane": "true", "seldon.io/tracing": "true",
    "seldon.io/health": "true", "seldon.io/profile": "true"},
    "predictors": [{"name": "a", "graph": mlp},
                   {"name": "b", "graph": mlp}]}}), device="cpu", seed=0)
for _ in range(4):
    out = asyncio.run(local.predict(SeldonMessage.from_ndarray(
        np.zeros((1, 784), np.float32))))
    assert out.status.status == "SUCCESS"
assert sum(p.cache.stats["hits"] for p in local.predictors) >= 2
assert local.tracer.enabled and local.health.recorder.stats()["recorded"] > 0
assert local.profiler.compile.stats()["compiles"] > 0
asyncio.run(local.aclose())
blocked = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("aiohttp", "grpc", "ml_dtypes")
                 or m.startswith("google.protobuf")
                 if sys.modules[m] is not None)
print(json.dumps({"modules": names, "ref": ref, "jax": jaxish,
                  "safetensors": st, "blocked": blocked}))
"""


GRPC_PROBE = r"""
import asyncio, json, sys
sys.modules["jax"] = None
for blocked in ("aiohttp", "ml_dtypes", "safetensors"):
    sys.modules[blocked] = None
import numpy as np
from seldon_core_tpu_torch.proto import convert, prediction_pb2
from seldon_core_tpu_torch.runtime.component import ComponentHandle
from seldon_core_tpu_torch.serving import grpc_api
from seldon_core_tpu_torch.serving.native_http import NativeGrpcServer
from seldon_core_tpu_torch.messages import SeldonMessage
class Twice:
    def predict(self, X, names):
        return np.asarray(X) * 2
async def call():
    h = ComponentHandle(Twice())
    srv = grpc_api.GrpcServer(grpc_api.component_service_handlers(h, "MODEL"),
                              port=0, host="127.0.0.1")
    port = await srv.start()
    nsrv = NativeGrpcServer(component=h, bind="127.0.0.1")
    nport = await nsrv.start()
    try:
        outs = []
        for p in (port, nport):
            c = grpc_api.GrpcComponentClient(f"127.0.0.1:{p}")
            outs.append((await c.predict(SeldonMessage.from_ndarray(
                np.ones((1, 2))))).host_data().tolist())
            await c.close()
        return outs
    finally:
        await nsrv.stop()
        await srv.stop()
assert asyncio.run(asyncio.wait_for(call(), 60)) == [[[2.0, 2.0]]] * 2
ref = sorted(m for m in sys.modules
             if m == "seldon_core_tpu" or m.startswith("seldon_core_tpu."))
jaxish = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith(("jax.", "jaxlib")))
                and sys.modules[m] is not None)
print(json.dumps({"ref": ref, "jax": jaxish,
                  "grpc": "grpc" in sys.modules,
                  "protobuf": "google.protobuf" in sys.modules}))
"""


def test_grpc_modules_import_without_jax_or_the_jax_package():
    import json

    out = subprocess.run([sys.executable, "-c", GRPC_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ref": [], "jax": [], "grpc": True, "protobuf": True}


def test_port_imports_without_jax_or_the_jax_package():
    import json

    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ref"] == [], res["ref"]
    assert res["jax"] == [], res["jax"]
    assert res["safetensors"] == [], res["safetensors"]
    assert res["blocked"] == [], res["blocked"]
    expected = {
        "seldon_core_tpu_torch.device", "seldon_core_tpu_torch.convert",
        "seldon_core_tpu_torch.messages", "seldon_core_tpu_torch.ops._build",
        "seldon_core_tpu_torch.ops.quant", "seldon_core_tpu_torch.ops.attention",
        "seldon_core_tpu_torch.parallel.ring_attention",
        "seldon_core_tpu_torch.models.transformer",
        "seldon_core_tpu_torch.models.llm_demo",
        "seldon_core_tpu_torch.runtime.paged",
        "seldon_core_tpu_torch.runtime.llm",
        "seldon_core_tpu_torch.runtime.checkpoint",
        "seldon_core_tpu_torch.runtime.component",
        "seldon_core_tpu_torch.runtime.persistence",
        "seldon_core_tpu_torch.graph.spec",
        "seldon_core_tpu_torch.serving.rest",
        "seldon_core_tpu_torch.operator.local",
        "seldon_core_tpu_torch.graph.builtins",
        "seldon_core_tpu_torch.graph.engine",
        "seldon_core_tpu_torch.runtime.batcher",
        "seldon_core_tpu_torch.models.iris",
        "seldon_core_tpu_torch.models.mlp",
        "seldon_core_tpu_torch.models.outlier",
        "seldon_core_tpu_torch.models.resnet",
        "seldon_core_tpu_torch.models.resnet_int8",
        "seldon_core_tpu_torch.native",
        "seldon_core_tpu_torch.utils.metrics",
        "seldon_core_tpu_torch.serving.openapi",
        "seldon_core_tpu_torch.serving.client",
        "seldon_core_tpu_torch.serving.microservice",
        "seldon_core_tpu_torch.serving.framed",
        "seldon_core_tpu_torch.serving.native_http",
        "seldon_core_tpu_torch.serving.bodies",
        "seldon_core_tpu_torch.serving.workers",
        "seldon_core_tpu_torch.serving.grpc_api",
        "seldon_core_tpu_torch.proto.convert",
        "seldon_core_tpu_torch.proto.prediction_pb2",
        "seldon_core_tpu_torch.qos.context",
        "seldon_core_tpu_torch.qos.admission",
        "seldon_core_tpu_torch.qos.breaker",
        "seldon_core_tpu_torch.qos.policy",
        "seldon_core_tpu_torch.qos.registry",
        "seldon_core_tpu_torch.graph.plan",
        "seldon_core_tpu_torch.caching",
        "seldon_core_tpu_torch.caching.key",
        "seldon_core_tpu_torch.caching.store",
        "seldon_core_tpu_torch.caching.singleflight",
        "seldon_core_tpu_torch.caching.policy",
        "seldon_core_tpu_torch.models",
        "seldon_core_tpu_torch.ops.launches",
        "seldon_core_tpu_torch.runtime.programs",
        "seldon_core_tpu_torch.runtime.device_registry",
        "seldon_core_tpu_torch.runtime.device_plane",
        "seldon_core_tpu_torch.artifacts",
        "seldon_core_tpu_torch.artifacts.config",
        "seldon_core_tpu_torch.artifacts.store",
        "seldon_core_tpu_torch.artifacts.key",
        "seldon_core_tpu_torch.artifacts.plane",
        "seldon_core_tpu_torch.artifacts.registry",
        "seldon_core_tpu_torch.artifacts.http",
        "seldon_core_tpu_torch.ops.cost",
        "seldon_core_tpu_torch.utils.tracing",
        "seldon_core_tpu_torch.utils.analytics",
        "seldon_core_tpu_torch.health",
        "seldon_core_tpu_torch.health.config",
        "seldon_core_tpu_torch.health.registry",
        "seldon_core_tpu_torch.health.burnrate",
        "seldon_core_tpu_torch.health.flightrecorder",
        "seldon_core_tpu_torch.health.introspect",
        "seldon_core_tpu_torch.health.plane",
        "seldon_core_tpu_torch.health.http",
        "seldon_core_tpu_torch.profiling",
        "seldon_core_tpu_torch.profiling.config",
        "seldon_core_tpu_torch.profiling.hostsampler",
        "seldon_core_tpu_torch.profiling.compilewatch",
        "seldon_core_tpu_torch.profiling.attribution",
        "seldon_core_tpu_torch.profiling.plane",
        "seldon_core_tpu_torch.profiling.http",
    }
    assert expected <= set(res["modules"])


def test_entry_points_refuse_cuda_without_a_card():
    """Entry points default to the card; with none visible they raise
    instead of serving from the CPU, unless the CPU is asked for."""
    import pytest
    import torch

    from seldon_core_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
