"""The port's checkpoints against the JAX reference's on the CPU.

The port reads and writes ``model.safetensors`` itself (no ``safetensors``
package): a file the reference writes loads in the port, and a file the
port writes loads in the reference, tensors bitwise equal, for float32,
bfloat16 and int8 trees.  Then the transformer load path (int8 quantized
at load, quantized trees verbatim), engine restarts from a checkpoint, and
``model_uri`` through ``DemoLLM``, the MLP, ResNet50 and the local runner.
"""

import asyncio
import json
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import transformer as jtf
from seldon_core_tpu.runtime import checkpoint as jck
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.models import transformer as ttf
from seldon_core_tpu_torch.ops.quant import k_major
from seldon_core_tpu_torch.runtime import checkpoint as tck
from seldon_core_tpu_torch.runtime import llm as tllm
from seldon_core_tpu_torch.runtime import paged as tpaged

JCFG = jtf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64,
                             dtype=jnp.float32)
TCFG = ttf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64,
                             dtype=torch.float32)
JP = jtf.init_params(jax.random.PRNGKey(7), JCFG)
PROMPT = np.asarray([5, 9, 3, 17, 22, 1], np.int32)
DEMO = dict(d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=64,
            max_seq=64, max_slots=2, n_new=6, seed=7)


def _jtree(kind: str):
    """A reference transformer tree: float32, bfloat16 or int8 'full'."""
    if kind == "f32":
        return jax.tree.map(np.asarray, JP)
    if kind == "bf16":
        return jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16),
                            JP)
    q = jtf.quantize_attn_params(jtf.quantize_ffn_params(JP))
    return jax.tree.map(np.asarray, q)


def _flat(tree, path=""):
    """``{dotted path: numpy array}`` of a tree of tensors or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}.{k}" if path else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}.{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        t = tree.contiguous()
        if t.dtype == torch.bfloat16:
            return {path: t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)}
        return {path: t.numpy()}
    return {path: np.asarray(tree)}


def _bitwise_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _gen(engine, p=PROMPT, n=8, **kw):
    async def run():
        return (await engine.generate(p, n, **kw))[0].tolist()

    return asyncio.run(run())


# ---- the file and the codec ---------------------------------------------------

def test_codec_round_trips_a_mixed_tree(tmp_path):
    tree = {
        "f32": torch.randn(3, 4), "bf16": torch.randn(5).to(torch.bfloat16),
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "i64": torch.tensor(7), "f16": torch.ones(2, dtype=torch.float16),
        "bool": torch.tensor([True, False]), "u8": torch.arange(4,
                                                               dtype=torch.uint8),
        "empty": torch.zeros((0, 3)), "np": np.arange(3, dtype=np.float64),
        "u32": np.array([1, 2**31], np.uint32),
        "nested": {"tup": (torch.ones(2), [torch.zeros(1), 3]),
                   "vals": [1.5, "s", None, True]},
        "kmajor": k_major(torch.arange(12, dtype=torch.int8).reshape(3, 4)),
    }
    tck.save_checkpoint(str(tmp_path / "ck"), tree, {"family": "x", "n": 3})
    out, meta = tck.load_checkpoint(str(tmp_path / "ck"))
    assert meta == {"family": "x", "n": 3}
    assert isinstance(out["nested"]["tup"], tuple)
    assert out["nested"]["vals"] == [1.5, "s", None, True]
    assert out["nested"]["tup"][1][1] == 3
    _bitwise_equal({k: v for k, v in tree.items() if k != "nested"},
                   {k: v for k, v in out.items() if k != "nested"})
    cfg = json.loads((tmp_path / "ck" / "config.json").read_text())
    assert cfg["format_version"] == 1 and cfg["model"]["family"] == "x"


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_reference_written_checkpoint_reads_in_the_port(tmp_path, kind):
    tree = _jtree(kind)
    jck.save_checkpoint(str(tmp_path / "ck"), tree, {"family": "t"})
    out, meta = tck.load_checkpoint(str(tmp_path / "ck"))
    assert meta == {"family": "t"}
    _bitwise_equal(out, tree)
    if kind == "int8":
        assert isinstance(out["blocks"]["wq"]["values"], tuple)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_port_written_checkpoint_reads_in_the_reference(tmp_path, kind):
    """The port's own trees (converted; int8 values K-major) written by the
    port's writer load in the reference, bitwise equal, int8 per-layer
    tuples included."""
    tree = _jtree(kind)
    port_tree = convert.params_from_jax(tree)
    tck.save_transformer(str(tmp_path / "ck"), port_tree, TCFG)
    out, meta = jck.load_checkpoint(str(tmp_path / "ck"))
    assert meta["family"] == "transformer" and meta["dtype"] == "float32"
    _bitwise_equal(out, tree)
    if kind == "int8":
        assert isinstance(out["blocks"]["wq"]["values"], tuple)
        params, cfg = jck.load_transformer(str(tmp_path / "ck"))
        assert cfg.n_kv_heads == 2 and jtf.has_quantized_params(params)


def test_safetensors_layout_is_the_format(tmp_path):
    """Header length, JSON header padded to 8 bytes, offsets back to back
    from 0 and every tensor aligned to its element size."""
    path = str(tmp_path / "t.safetensors")
    tck.write_safetensors(path, {"b": torch.ones(3, dtype=torch.int8),
                                 "a": torch.ones(3), "c": torch.ones(1,
                                                                     dtype=torch.float64)},
                          {"k": "v"})
    raw = open(path, "rb").read()
    (n,) = struct.unpack("<Q", raw[:8])
    assert n % 8 == 0
    header = json.loads(raw[8:8 + n])
    assert header.pop("__metadata__") == {"k": "v"}
    spans = sorted(tuple(h["data_offsets"]) for h in header.values())
    assert spans[0][0] == 0 and spans[-1][1] == len(raw) - 8 - n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for h in header.values():
        size = {"F64": 8, "F32": 4, "I8": 1}[h["dtype"]]
        assert h["data_offsets"][0] % size == 0
    from safetensors.numpy import load_file  # the format's own reader

    got = load_file(path)
    assert got["c"].dtype == np.float64 and got["b"].tolist() == [1, 1, 1]


def test_reserved_metadata_keys_are_refused(tmp_path):
    for key in ("seldon.checkpoint", "seldon_checkpoint", "framework"):
        with pytest.raises(ValueError, match="reserved"):
            tck.save_checkpoint(str(tmp_path / "ck"), {"a": torch.ones(1)},
                                metadata={key: "x"})
    tck.save_checkpoint(str(tmp_path / "ck"), {"a": torch.ones(1)},
                        metadata={"owner": "me"})
    _, md = tck.read_safetensors(str(tmp_path / "ck" / "model.safetensors"))
    assert md["owner"] == "me"


def test_bad_trees_are_refused(tmp_path):
    for tree in ({"a.b": torch.ones(1)}, {"__tensor__": torch.ones(1)},
                 {1: torch.ones(1)}, {"a": object()}):
        with pytest.raises(TypeError):
            tck.save_checkpoint(str(tmp_path / "ck"), tree)


def test_missing_and_foreign_files_fail_cleanly(tmp_path):
    with pytest.raises(FileNotFoundError, match="not a checkpoint"):
        tck.load_checkpoint(str(tmp_path / "nothing"))
    (tmp_path / "foreign").mkdir()
    from safetensors.numpy import save_file

    save_file({"x": np.ones(2, np.float32)},
              str(tmp_path / "foreign" / "model.safetensors"))
    with pytest.raises(ValueError, match="no seldon.checkpoint metadata"):
        tck.load_checkpoint(str(tmp_path / "foreign"))
    (tmp_path / "junk").mkdir()
    (tmp_path / "junk" / "model.safetensors").write_bytes(b"not a file")
    with pytest.raises(ValueError, match="not a safetensors file"):
        tck.load_checkpoint(str(tmp_path / "junk"))


# ---- transformer weights --------------------------------------------------------

def test_int8_at_load_equals_quantize_after_init(tmp_path):
    tp = convert.params_from_jax(_jtree("f32"))
    tck.save_transformer(str(tmp_path / "ck"), tp, TCFG)
    params, cfg = tck.load_transformer(str(tmp_path / "ck"), int8="full")
    assert cfg == TCFG
    want = ttf.quantize_attn_params(ttf.quantize_ffn_params(tp))
    _bitwise_equal(params, want)
    for w in params["blocks"]["w1"]["values"]:  # K-major, as K1 reads
        assert w.stride() == (1, w.shape[0])
    # and the reference's quantization of the same weights, converted
    _bitwise_equal(params, convert.params_from_jax(_jtree("int8")))


def test_quantized_tree_loads_verbatim(tmp_path):
    jck.save_transformer(str(tmp_path / "ck"),
                         jtf.quantize_attn_params(jtf.quantize_ffn_params(JP)),
                         JCFG)
    params, cfg = tck.load_transformer(str(tmp_path / "ck"))
    assert cfg.dtype == torch.float32 and cfg.n_kv_heads == 2
    _bitwise_equal(params, convert.params_from_jax(_jtree("int8")))
    assert params["lm_head"]["values"].stride() == (1, 32)
    with pytest.raises(ValueError, match="already-quantized"):
        tck.load_transformer(str(tmp_path / "ck"), int8="ffn")


def test_family_mismatch_is_refused(tmp_path):
    tck.save_checkpoint(str(tmp_path / "ck"), [{"w": torch.ones(2, 2)}],
                        {"family": "mlp"})
    with pytest.raises(ValueError, match="not a transformer"):
        tck.load_transformer(str(tmp_path / "ck"))


@pytest.mark.parametrize("kind", ["slab", "paged"])
def test_engine_restart_from_checkpoint_is_deterministic(tmp_path, kind):
    """An engine booted from a checkpoint serves the ids of the engine that
    saved it (greedy and sampled), and the reference's greedy ids."""
    tp = convert.params_from_jax(_jtree("f32"))
    extra = ({"paged": tpaged.PagedConfig(17, 4)} if kind == "paged" else {})
    cls = tllm.PagedLLMEngine if kind == "paged" else tllm.LLMEngine
    first = cls(tp, TCFG, max_slots=2, **extra)
    first.save_checkpoint(str(tmp_path / "ck"))
    again = cls.from_checkpoint(str(tmp_path / "ck"), device="cpu",
                                max_slots=2, **extra)
    for kw in ({}, {"temperature": 0.9, "seed": 4}):
        assert _gen(first, **kw) == _gen(again, **kw)
    want = np.asarray(jtf.generate(JP, jnp.asarray(PROMPT)[None], 8,
                                   JCFG))[0]
    assert _gen(again) == want.tolist()
    first.close()
    again.close()
    # the checkpoint as its own speculative draft: loaded dense, and the
    # greedy ids stay the reference's
    spec = cls.from_checkpoint(str(tmp_path / "ck"), device="cpu",
                               draft_path=str(tmp_path / "ck"), max_slots=2,
                               max_len=32, **extra)
    _bitwise_equal(spec.draft_params, tp)
    assert _gen(spec) == want.tolist()
    assert spec.spec_stats["accepted"] == spec.spec_stats["drafted"] > 0
    spec.close()


def test_int8_engine_refuses_export(tmp_path):
    tp = ttf.quantize_ffn_params(convert.params_from_jax(_jtree("f32")))
    eng = tllm.LLMEngine(tp, TCFG, max_slots=2)
    with pytest.raises(ValueError, match="quantized"):
        eng.save_checkpoint(str(tmp_path / "ck"))
    eng.close()


# ---- model_uri --------------------------------------------------------------------

@pytest.mark.parametrize("int8", ["none", "full"])
@pytest.mark.parametrize("paged", [0, 17])
def test_demo_llm_model_uri_serves_the_reference_checkpoint(tmp_path, int8,
                                                            paged):
    """The reference's DemoLLM saves its seeded weights; the port's DemoLLM
    boots them with ``model_uri`` (slab or paged, int8 at load) and serves
    the reference DemoLLM's ids; the shape comes from the artifact."""
    from seldon_core_tpu.messages import SeldonMessage as JMessage
    from seldon_core_tpu.models.llm_demo import DemoLLM as JDemoLLM
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.models.llm_demo import DemoLLM

    JDemoLLM(**DEMO).save_checkpoint(str(tmp_path / "ck"))
    ref = JDemoLLM(**{**DEMO, "int8": int8})
    port = DemoLLM(model_uri=f"file://{tmp_path / 'ck'}", int8=int8,
                   paged_pages=paged, page_size=4, max_slots=2, n_new=6,
                   device="cpu")
    assert port.engine.cfg.d_model == 32 and port.engine.cfg.max_seq == 64
    assert port.engine._auto_budget == 4 * 64
    body = {"prompt_ids": [4, 8, 2, 30, 11], "n_new": 6}

    async def both():
        a = await ref.predict(JMessage(json_data=body))
        b = await port.predict(SeldonMessage(json_data=body))
        return a.json_data["ids"], b.json_data["ids"]

    a, b = asyncio.run(both())
    port.engine.close()
    assert a == b


def test_demo_llm_port_checkpoint_restart(tmp_path):
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.models.llm_demo import DemoLLM

    kw = {**DEMO, "device": "cpu"}
    writer = DemoLLM(**kw)
    writer.save_checkpoint(str(tmp_path / "ck"))
    seeded = DemoLLM(int8="full", **kw)
    reader = DemoLLM(model_uri=str(tmp_path / "ck"), int8="full",
                     paged_pages=17, page_size=4, max_slots=2, n_new=6,
                     device="cpu")
    msg = SeldonMessage(json_data={"prompt_ids": [4, 8, 2], "n_new": 6})

    async def both():
        return ((await seeded.predict(msg)).json_data["ids"],
                (await reader.predict(msg)).json_data["ids"])

    a, b = asyncio.run(both())
    for c in (writer, seeded, reader):
        c.engine.close()
    assert a == b
    with pytest.raises(ValueError, match="quantized"):
        seeded.save_checkpoint(str(tmp_path / "ck2"))


def test_mlp_model_uri(tmp_path):
    from seldon_core_tpu.models.mlp import MNISTMLP as JMLP
    from seldon_core_tpu_torch.models.mlp import MNISTMLP

    writer = JMLP(seed=3, hidden=32)
    writer.save_checkpoint(str(tmp_path / "ck"))
    reader = MNISTMLP(model_uri=str(tmp_path / "ck"), device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 784)).astype(np.float32)
    np.testing.assert_allclose(
        reader.predict_fn(reader.params, torch.from_numpy(x)).numpy(),
        np.asarray(writer.predict_fn(writer.params, x)), atol=1e-6)


def test_resnet_model_uri_and_family_check(tmp_path):
    """The reference ResNet50Model's checkpoint (bf16 storage cast, flax
    variables) serves in the port within bf16's tolerance (2e-2, as the
    port's ResNet parity tests hold), with the same top-1; an MLP
    checkpoint is refused."""
    from seldon_core_tpu.models.mlp import MNISTMLP as JMLP
    from seldon_core_tpu.models.resnet import ResNet50Model as JResNet
    from seldon_core_tpu_torch.models.resnet import ResNet50Model

    writer = JResNet(seed=1, num_classes=10, image_size=32)
    writer.save_checkpoint(str(tmp_path / "ck"))
    reader = ResNet50Model(model_uri=str(tmp_path / "ck"), num_classes=10,
                           image_size=32, device="cpu")
    x = np.random.default_rng(0).uniform(0, 255, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(writer.predict_fn(writer.params, x))
    got = reader.predict_fn(reader.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    JMLP(seed=0, hidden=16).save_checkpoint(str(tmp_path / "m"))
    with pytest.raises(ValueError, match="not resnet"):
        ResNet50Model(model_uri=str(tmp_path / "m"), num_classes=10,
                      image_size=32, device="cpu")


def test_resolve_model_uri():
    assert tck.resolve_model_uri("/a/b") == "/a/b"
    assert tck.resolve_model_uri("file:///a/b") == "/a/b"
    with pytest.raises(ValueError, match="initContainer"):
        tck.resolve_model_uri("gs://bucket/model")


def test_local_deployment_serves_a_checkpoint_graph(tmp_path):
    """The port's ``llm-checkpoint.json`` with a local ``model_uri``, booted
    by the local runner, answers the writer's ids."""
    from pathlib import Path

    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.models.llm_demo import DemoLLM
    from seldon_core_tpu_torch.operator.local import LocalDeployment

    writer = DemoLLM(**{**DEMO, "device": "cpu"})
    writer.save_checkpoint(str(tmp_path / "ck"))
    graph = json.loads((Path(__file__).resolve().parents[1]
                        / "seldon_core_tpu_torch" / "examples"
                        / "llm-checkpoint.json").read_text())
    for p in graph["spec"]["predictors"][0]["graph"]["parameters"]:
        if p["name"] == "model_uri":
            p["value"] = str(tmp_path / "ck")
        if p["name"] == "int8":
            p["value"] = "none"
    local = LocalDeployment(load_deployment(graph), device="cpu")
    msg = SeldonMessage(json_data={"prompt_ids": [4, 8, 2], "n_new": 6})

    async def both():
        return ((await local.predict(msg)).json_data["ids"],
                (await writer.predict(msg)).json_data["ids"])

    a, b = asyncio.run(both())
    local.engine.node_impl("llm").user.engine.close()
    writer.engine.close()
    assert a == b and len(a) == 9


# ---- weight export: the port writes, the reference serves ----------------

def _randomize_bn(module, seed: int) -> None:
    """Seeded BatchNorm scales, biases and statistics (a seeded ResNet's are
    1, 0, 0, 1, and 0 for each bottleneck's last scale), so that the
    export's every leaf moves the answer."""
    from seldon_core_tpu_torch.models.resnet import _BatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _BatchNorm):
                c = m.scale.shape[0]
                for name, lo, hi in (("scale", 0.5, 1.5), ("bias", -0.1, 0.1),
                                     ("mean", -0.1, 0.1), ("var", 0.5, 1.5)):
                    v = torch.rand(c, generator=gen) * (hi - lo) + lo
                    getattr(m, name).copy_(v)


def _read_file(path):
    tensors, meta = tck.read_safetensors(str(path / "model.safetensors"))
    return {k: (str(t.dtype), tuple(t.shape),
                t.contiguous().view(torch.uint8).numpy().tobytes()
                if t.numel() else b"")
            for k, t in tensors.items()}, meta


def test_port_mlp_export_serves_in_the_reference(tmp_path):
    """float32: atol 1e-5 on probabilities, argmax EQUAL."""
    from seldon_core_tpu.models.mlp import MNISTMLP as JMLP
    from seldon_core_tpu_torch.models.mlp import MNISTMLP

    writer = MNISTMLP(seed=5, hidden=16, device="cpu")
    assert writer.save_checkpoint(str(tmp_path / "ck")) == str(tmp_path / "ck")
    reader = JMLP(model_uri=str(tmp_path / "ck"))
    _bitwise_equal(writer.params, reader.params)
    x = np.random.default_rng(2).normal(size=(8, 784)).astype(np.float32)
    want = writer.predict_fn(writer.params, torch.from_numpy(x)).numpy()
    got = np.asarray(reader.predict_fn(reader.params, x))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_port_resnet_export_serves_in_the_reference(tmp_path, dtype, atol):
    """The port's ResNet50Model (the reference test's small shape, random
    BN) exported and served by the reference's: the flax variables in its
    storage dtypes, probabilities within the dtype's tolerance, argmax
    EQUAL."""
    from seldon_core_tpu.models.resnet import ResNet50Model as JResNet
    from seldon_core_tpu_torch.models.resnet import ResNet50Model

    writer = ResNet50Model(seed=4, num_classes=10, image_size=32,
                           dtype=dtype, device="cpu")
    _randomize_bn(writer.module, 14)
    writer.save_checkpoint(str(tmp_path / "ck"))
    reader = JResNet(model_uri=str(tmp_path / "ck"), num_classes=10,
                     image_size=32, dtype=dtype)
    host = jax.tree.map(np.asarray, reader.params)
    serving = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    assert host["params"]["Conv_0"]["kernel"].shape == (7, 7, 3, 64)
    assert host["params"]["Conv_0"]["kernel"].dtype == serving
    assert host["params"]["Bottleneck_0"]["proj_bn"]["scale"].dtype == serving
    assert host["params"]["Dense_0"]["kernel"].dtype == np.float32
    assert host["batch_stats"]["BatchNorm_0"]["var"].dtype == np.float32
    # unit-scale images, as the reference's own model_uri test draws them:
    # 0..255 pixels through 16 bottlenecks of seeded weights saturate the
    # softmax, where one ulp of a logit moves a probability by 0.5
    x = np.random.default_rng(3).normal(size=(8, 32, 32, 3)).astype(
        np.float32)
    with torch.inference_mode():
        want = writer.predict_fn(writer.params, torch.from_numpy(x)).numpy()
    got = np.asarray(reader.predict_fn(reader.params, x))
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_reference_export_read_and_written_back_is_the_same_file(tmp_path,
                                                                 model):
    """Reference file -> port -> file: the same tensor names, dtypes,
    shapes and bytes, and the same metadata (skeleton and family)."""
    from seldon_core_tpu.models.mlp import MNISTMLP as JMLP
    from seldon_core_tpu.models.resnet import ResNet50Model as JResNet
    from seldon_core_tpu_torch.models.mlp import MNISTMLP
    from seldon_core_tpu_torch.models.resnet import ResNet50Model

    if model == "mlp":
        JMLP(seed=1, hidden=16).save_checkpoint(str(tmp_path / "ref"))
        port = MNISTMLP(model_uri=str(tmp_path / "ref"), device="cpu")
    else:
        JResNet(seed=1, num_classes=10, image_size=32).save_checkpoint(
            str(tmp_path / "ref"))
        port = ResNet50Model(model_uri=str(tmp_path / "ref"), num_classes=10,
                             image_size=32, device="cpu")
    port.save_checkpoint(str(tmp_path / "port"))
    ref_leaves, ref_meta = _read_file(tmp_path / "ref")
    port_leaves, port_meta = _read_file(tmp_path / "port")
    assert port_leaves == ref_leaves
    assert port_meta == ref_meta
    assert json.loads(port_meta["seldon.checkpoint"])["model"] == \
        {"family": model}


@pytest.mark.parametrize("cls,params", [
    ("seldon_core_tpu_torch.models.mlp:MNISTMLP",
     ["seed=5", "hidden=16"]),
    ("seldon_core_tpu_torch.models.resnet:ResNet50Model",
     ["seed=5", "num_classes=10", "image_size=32"])])
def test_save_model_cli_exports_the_port_models(tmp_path, capsys, cls,
                                                params):
    from seldon_core_tpu_torch.tools.__main__ import main

    out = str(tmp_path / "ck")
    argv = ["save-model", cls, out, "--device", "cpu"]
    for p in params:
        argv += ["--param", p]
    assert main(argv) == 0
    assert capsys.readouterr().out.strip() == out
    _, meta = tck.load_checkpoint(out)
    assert meta == {"family": "mlp" if "mlp" in cls else "resnet"}
    mod_name, _, cls_name = cls.partition(":")
    import importlib

    kw = dict(p.split("=") for p in params)
    kw = {k: int(v) for k, v in kw.items() if k != "seed"}
    klass = getattr(importlib.import_module(mod_name), cls_name)
    a = klass(seed=5, device="cpu", **kw)
    b = klass(model_uri=out, device="cpu", **kw)
    _bitwise_equal(_export_tree(a), _export_tree(b))


def _export_tree(m):
    return convert.resnet_to_jax(m.module) if hasattr(m, "module") \
        else m.params


def test_family_cross_check_refuses_a_port_mlp_export(tmp_path):
    from seldon_core_tpu.models.resnet import ResNet50Model as JResNet
    from seldon_core_tpu_torch.models.mlp import MNISTMLP
    from seldon_core_tpu_torch.models.resnet import ResNet50Model

    MNISTMLP(seed=0, hidden=16, device="cpu").save_checkpoint(
        str(tmp_path / "m"))
    with pytest.raises(ValueError, match="not resnet"):
        ResNet50Model(model_uri=str(tmp_path / "m"), num_classes=10,
                      image_size=32, device="cpu")
    with pytest.raises(ValueError, match="not resnet"):
        JResNet(model_uri=str(tmp_path / "m"), num_classes=10, image_size=32)
