"""The reference's public surface against the port's, and the names the
port took from it last.

The guard walks every module of ``seldon_core_tpu/`` by AST (no import,
so no jax) and collects its public top-level names (functions, classes,
assignments), its ``__all__`` and the public methods of its public
classes.  Each must exist in the mirrored port module
(``seldon_core_tpu/x/y.py`` -> ``seldon_core_tpu_torch/x/y.py``;
``native/__init__.py``, a build shim, -> ``native.py``): defined or
imported there by AST, or found by ``hasattr`` after the port module is
imported with jax blocked (a name a module makes lazily, or a method a
class inherits).  The only other way to pass is an entry of
:data:`OMITTED`, with its reason.  One case per reference module, so a new
gap names its module; signatures are not compared (the port takes a
``torch.Generator`` where the reference takes a ``jax.random`` key).

Then the names themselves: ``GraphEngine.predict_sync`` and
``send_feedback_sync``, ``SeldonMessage.parse``, ``cast_params``,
``load_deployment_file``, ``AdmissionShedError`` and the package
re-exports, each against the reference's on the same inputs.
"""

import ast
import asyncio
import gc
import json
import subprocess
import sys
import warnings
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "seldon_core_tpu"
PORT = ROOT / "seldon_core_tpu_torch"

#: "reference module:name" -> why the port has no such name
OMITTED = {
    "artifacts:jaxlib_version":
        "the key's runtime identity is torch, CUDA, cuDNN and the card "
        "(artifacts/key.py runtime_identity), not a jaxlib version",
    "artifacts.key:jaxlib_version":
        "the key's runtime identity is torch, CUDA, cuDNN and the card "
        "(artifacts/key.py runtime_identity), not a jaxlib version",
    "graph.engine:NodeImpl":
        "a type alias (Any) for annotations; the port annotates Any",
    "messages:ArrayLike":
        "a type alias over jax.Array; the port's payloads are numpy "
        "arrays and torch tensors",
    "models.resnet:ModuleDef":
        "flax's alias for a module type; the port's modules are "
        "torch.nn.Module",
    "native:HAVE_NATIVE":
        "the library builds at first use and raises when it cannot "
        "(native.load); a flag read at import would force the build then",
    "serving.framed:HAVE_NATIVE":
        "the library builds at first use and raises when it cannot "
        "(native.load); a flag read at import would force the build then",
    "operator.compile:CHIPS_PER_HOST":
        "TPU slice topology; the port schedules nvidia.com/gpu "
        "(test_torch_operator.py::test_topology_is_dropped_on_the_gpu)",
    "operator.compile:KNOWN_TOPOLOGIES":
        "TPU slice topology; the port schedules nvidia.com/gpu "
        "(test_torch_operator.py::test_topology_is_dropped_on_the_gpu)",
    "operator.compile:tpu_topology_for":
        "TPU slice topology; the port schedules nvidia.com/gpu "
        "(test_torch_operator.py::test_topology_is_dropped_on_the_gpu)",
    "ops:use_interpret":
        "Pallas interpret mode; a port wrapper runs its plain version for "
        "a CPU tensor",
    "ops.attention:use_interpret":
        "Pallas interpret mode; a port wrapper runs its plain version for "
        "a CPU tensor",
    "runtime.batcher:logger":
        "the port's batcher logs nothing",
    "runtime.checkpoint:load_orbax_tree":
        "orbax needs jax; the port reads and writes safetensors "
        "checkpoints only",
    "runtime.persistence:OrbaxStateStore.load":
        "the orbax state backend needs jax: refused at construction "
        "(runtime/persistence.py OrbaxStateStore)",
    "runtime.persistence:OrbaxStateStore.save":
        "the orbax state backend needs jax: refused at construction "
        "(runtime/persistence.py OrbaxStateStore)",
    "serving.rest:build_app":
        "aiohttp's application; RestServer(engine, component=, metrics=) "
        "builds the same routes (no aiohttp on the card)",
    "serving.rest:start_server":
        "aiohttp's runner; RestServer.start() binds the routes",
    "serving.rest:ComponentServer.predict":
        "an aiohttp handler; the route comes from "
        "ComponentServer._message_route",
    "serving.rest:ComponentServer.transform_input":
        "an aiohttp handler; the route comes from "
        "ComponentServer._message_route",
    "serving.rest:ComponentServer.transform_output":
        "an aiohttp handler; the route comes from "
        "ComponentServer._message_route",
    "serving.rest:EngineServer.fleet_obs":
        "an aiohttp handler; /admin/fleet/* come from "
        "EngineServer._fleet_obs",
    **{f"serving.rest:EngineServer.{name}":
       "an aiohttp handler; the /admin/* routes come from one table "
       "(EngineServer._admin) with the reference's bodies"
       for name in ("introspect", "flightrecorder", "health_verdict",
                    "profile", "profile_capture", "profile_compile",
                    "profile_capacity", "placement")},
    "utils:compile_cache_enabled":
        "XLA's persistent compile cache; the port keeps no compile cache "
        "(its captures are the artifact plane's)",
    "utils:compile_cache_stats":
        "XLA's persistent compile cache; the port keeps no compile cache "
        "(its captures are the artifact plane's)",
    "utils:enable_compile_cache":
        "XLA's persistent compile cache; the port keeps no compile cache "
        "(its captures are the artifact plane's)",
}


def _module_name(rel: Path) -> str:
    parts = list(rel.with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


REF_MODULES = sorted(_module_name(p.relative_to(REF))
                     for p in REF.rglob("*.py"))


def _path(root: Path, module: str) -> Path:
    base = root.joinpath(*module.split(".")) if module else root
    return base / "__init__.py" if (base / "__init__.py").exists() \
        else base.with_suffix(".py")


def _public(name: str) -> bool:
    return not name.startswith("_")


def _targets(node) -> list:
    tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in tgts for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def _all_entries(node) -> list:
    if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
            "__all__" in _targets(node) and node.value is not None:
        try:
            return list(ast.literal_eval(node.value))
        except ValueError:
            return []
    return []


def surface(path: Path, imports: bool = False) -> set:
    """The public names of a module's source: top-level functions, classes
    and assignments, ``__all__``, ``Class.method`` for public classes, and
    (``imports``) the names its top-level imports bind."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            if _public(node.name):
                out.update(f"{node.name}.{b.name}" for b in node.body
                           if isinstance(b, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(_targets(node))
            out.update(_all_entries(node))
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return {n for n in out if all(_public(p) for p in n.split("."))}


HASATTR_PROBE = r"""
import importlib, json, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
found = {}
for module, names in json.load(sys.stdin).items():
    try:
        mod = importlib.import_module(module)
    except Exception as e:
        found[module] = f"import failed: {type(e).__name__}: {e}"
        continue
    hits = []
    for name in names:
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part, None)
            if obj is None:
                break
        else:
            hits.append(name)
    found[module] = hits
ref = [m for m in sys.modules
       if m == "seldon_core_tpu" or m.startswith("seldon_core_tpu.")]
print(json.dumps({"found": found, "ref": ref}))
"""


def _port_module(module: str) -> str:
    return "seldon_core_tpu_torch" + (f".{module}" if module else "")


@lru_cache(maxsize=1)
def _hasattr_hits() -> dict:
    """Per reference module: the names the port module has at run time,
    every port module imported in one fresh interpreter with jax
    blocked."""
    asks = {_port_module(m): sorted(surface(_path(REF, m)))
            for m in REF_MODULES}
    out = subprocess.run([sys.executable, "-c", HASATTR_PROBE],
                         input=json.dumps(asks), capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ref"] == [], f"the port loaded {res['ref']}"
    return res["found"]


def _missing(module: str) -> list:
    ref = surface(_path(REF, module))
    port_path = _path(PORT, module)
    port = surface(port_path, imports=True) if port_path.exists() else set()
    hits = _hasattr_hits()[_port_module(module)]
    assert not isinstance(hits, str), f"{_port_module(module)}: {hits}"
    return sorted(n for n in ref - port - set(hits)
                  if f"{module}:{n}" not in OMITTED)


@pytest.mark.parametrize("module", REF_MODULES, ids=lambda m: m or "root")
def test_reference_name_has_a_port_counterpart(module):
    missing = _missing(module)
    assert not missing, (
        f"seldon_core_tpu.{module} names {missing} that "
        f"{_port_module(module)} lacks: port them, or add each to OMITTED "
        "with its reason")


def test_every_omission_is_live_and_has_its_reason():
    """Each OMITTED entry names a public reference name the port lacks,
    with a one-line reason: an entry the port has since filled is
    removed, not kept."""
    for key, reason in OMITTED.items():
        module, _, name = key.partition(":")
        assert module in REF_MODULES, key
        assert name in surface(_path(REF, module)), key
        assert reason.strip() and "\n" not in reason, key
        port_path = _path(PORT, module)
        assert name not in surface(port_path, imports=True), key
        assert name not in _hasattr_hits()[_port_module(module)], key


def test_surface_walk_sees_every_kind_of_name(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os as o_s\nfrom x import y\n__all__ = ['z']\nA = 1\n"
        "_b = 2\nc: int = 3\ndef f(): pass\nasync def g(): pass\n"
        "def _h(): pass\nclass K:\n    def m(self): pass\n"
        "    def _p(self): pass\n    @property\n    def q(self): pass\n"
        "class _L:\n    def m(self): pass\n")
    assert surface(src) == {"z", "A", "c", "f", "g", "K", "K.m", "K.q"}
    assert surface(src, imports=True) == surface(src) | {"o_s", "y"}


# ---- the names the port took last ----------------------------------------

def _engines():
    from seldon_core_tpu.graph.engine import GraphEngine as JEngine
    from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine

    spec = {"name": "m", "implementation": "SIMPLE_MODEL"}
    return JEngine(spec), TEngine(spec)


def _no_puid(d: dict) -> dict:
    d.get("meta", {}).pop("puid", None)
    return d


def test_sync_calls_equal_the_awaited_calls():
    from seldon_core_tpu_torch.messages import Feedback, SeldonMessage

    _, engine = _engines()
    req = {"data": {"names": ["a", "b"], "ndarray": [[1.0, 2.0]]}}
    sync = engine.predict_sync(SeldonMessage.from_dict(req))
    awaited = asyncio.run(engine.predict(SeldonMessage.from_dict(req)))
    assert _no_puid(sync.to_dict()) == _no_puid(awaited.to_dict())
    fb = Feedback.from_dict({"request": req, "response": sync.to_dict(),
                             "reward": 1.0})
    assert engine.send_feedback_sync(fb).to_dict() == \
        asyncio.run(engine.send_feedback(fb)).to_dict()


@pytest.mark.parametrize("call", ["predict_sync", "send_feedback_sync"])
def test_sync_calls_refuse_a_running_loop(call):
    from seldon_core_tpu_torch.messages import Feedback, SeldonMessage

    ref, port = _engines()
    arg = {"predict_sync": SeldonMessage(json_data={}),
           "send_feedback_sync": Feedback(reward=1.0)}[call]
    texts = []

    async def inside(engine, msg):
        with pytest.raises(RuntimeError) as e:
            getattr(engine, call)(msg)
        texts.append(str(e.value))

    from seldon_core_tpu.messages import Feedback as JFeedback
    from seldon_core_tpu.messages import SeldonMessage as JMessage

    jarg = {"predict_sync": JMessage(json_data={}),
            "send_feedback_sync": JFeedback(reward=1.0)}[call]
    with warnings.catch_warnings():
        # the reference leaves the refused coroutine unawaited
        warnings.simplefilter("ignore", RuntimeWarning)
        asyncio.run(inside(ref, jarg))
        gc.collect()
    asyncio.run(inside(port, arg))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("kind", ["str", "bytes", "dict", "message"])
def test_parse_gives_the_reference_message(kind):
    from seldon_core_tpu.messages import SeldonMessage as JMessage
    from seldon_core_tpu_torch.messages import SeldonMessage as TMessage

    d = {"data": {"names": ["x", "y"], "ndarray": [[1.5, -2.0], [3, 4]]},
         "meta": {"puid": "p1", "tags": {"t": 1}}}
    text = json.dumps(d)
    src = {"str": lambda cls: text, "bytes": lambda cls: text.encode(),
           "dict": lambda cls: d,
           "message": lambda cls: cls.from_dict(d)}[kind]
    want = JMessage.parse(src(JMessage)).to_dict()
    given = src(TMessage)
    got = TMessage.parse(given)
    assert got.to_dict() == want
    if kind == "message":
        assert got is given


def test_cast_params_gives_the_reference_dtypes_and_values():
    from seldon_core_tpu.models import transformer as jtf
    from seldon_core_tpu_torch import convert
    from seldon_core_tpu_torch.models import transformer as ttf

    cfg = jtf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=64,
                                max_seq=64, dtype=jnp.float32)
    jp = jtf.init_params(jax.random.PRNGKey(3), cfg)
    want = jax.tree.map(np.asarray, jtf.cast_params(jp, jnp.bfloat16))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    got = ttf.cast_params(tp, torch.bfloat16)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_w) == len(ttf.param_leaves(got))
    for path, w in flat_w:
        t = got
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert w.dtype == ml_dtypes.bfloat16 and t.dtype == torch.bfloat16
        assert tuple(t.shape) == w.shape
        assert t.view(torch.int16).numpy().tobytes() == w.tobytes(), path
    # a new tree; the master params stay float32
    assert all(t.dtype == torch.float32 for t in ttf.param_leaves(tp))


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "examples" / "graphs").glob("*.json")))
def test_load_deployment_file_reads_every_example(name):
    from seldon_core_tpu.operator.local import (
        load_deployment_file as jload,
    )
    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.operator.local import load_deployment_file

    path = str(ROOT / "examples" / "graphs" / name)
    got = load_deployment_file(path)
    assert got == load_deployment(path)
    ref = jload(path)
    assert [p.name for p in got.predictors] == \
        [p.name for p in ref.predictors]
    for p, r in zip(got.predictors, ref.predictors):
        assert [(u.name, u.type, u.implementation) for u in p.graph.walk()] \
            == [(u.name, u.type, u.implementation) for u in r.graph.walk()]


def test_load_deployment_file_reads_yaml(tmp_path):
    from seldon_core_tpu.operator.local import (
        load_deployment_file as jload,
    )
    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.operator.local import load_deployment_file

    text = ("apiVersion: machinelearning.seldon.io/v1\n"
            "kind: SeldonDeployment\n"
            "metadata:\n  name: iris\n"
            "spec:\n  name: iris\n  predictors:\n"
            "  - name: main\n    replicas: 2\n"
            "    annotations:\n      seldon.io/batching: 'false'\n"
            "    graph:\n      name: router\n      type: ROUTER\n"
            "      implementation: RANDOM_ABTEST\n"
            "      parameters:\n      - name: ratioA\n"
            "        value: '0.5'\n        type: FLOAT\n"
            "      children:\n"
            "      - {name: a, implementation: SIMPLE_MODEL}\n"
            "      - {name: b, implementation: SIMPLE_MODEL}\n")
    path = tmp_path / "dep.yaml"
    path.write_text(text)
    got = load_deployment_file(str(path))
    # one reader: the runner's own entry reads the same YAML file
    assert load_deployment(str(path)) == got
    as_json = tmp_path / "dep.json"
    import yaml

    as_json.write_text(json.dumps(yaml.safe_load(text)))
    assert got == load_deployment_file(str(as_json))
    ref = jload(str(path))
    assert got.predictors[0].replicas == ref.predictors[0].replicas == 2
    assert [u.name for u in got.predictors[0].graph.walk()] == \
        [u.name for u in ref.predictors[0].graph.walk()] == \
        ["router", "a", "b"]
    (tmp_path / "bad.yaml").write_text("just a string\n")
    with pytest.raises(ValueError, match="not a JSON or YAML mapping"):
        load_deployment_file(str(tmp_path / "bad.yaml"))
    with pytest.raises(ValueError, match="not a JSON or YAML mapping"):
        load_deployment(str(tmp_path / "bad.yaml"))


def test_admission_shed_error_is_the_references():
    from seldon_core_tpu.qos import AdmissionShedError as JShed
    from seldon_core_tpu_torch.qos import AdmissionShedError
    from seldon_core_tpu_torch.qos.admission import (
        AdmissionShedError as Shed,
    )
    from seldon_core_tpu_torch.runtime.component import (
        SeldonComponentError,
    )

    assert AdmissionShedError is Shed
    for kw in ({}, {"retry_after_s": 0.25}):
        e, j = AdmissionShedError("shed", **kw), JShed("shed", **kw)
        assert isinstance(e, SeldonComponentError)
        assert (e.status_code, e.reason, e.retry_after_s, str(e)) == \
            (j.status_code, j.reason, j.retry_after_s, str(j))
    assert (e.status_code, e.reason) == (429, "ADMISSION_SHED")


def test_package_re_exports():
    import seldon_core_tpu_torch.ops as ops
    import seldon_core_tpu_torch.qos as qos
    from seldon_core_tpu_torch.ops import attention, quant
    from seldon_core_tpu_torch.qos import registry

    assert (ops.flash_attention, ops.QuantizedLinear, ops.int8_matmul,
            ops.quantize_int8) == (attention.flash_attention,
                                   quant.QuantizedLinear, quant.int8_matmul,
                                   quant.quantize_int8)
    assert qos.unpublish is registry.unpublish
    for pkg in (ops, qos):
        assert all(hasattr(pkg, n) for n in pkg.__all__)
