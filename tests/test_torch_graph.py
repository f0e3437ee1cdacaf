"""The port's graph spec, built-ins, component handle and engine against the
JAX package's: the same specs, components and requests go through the
reference ``GraphEngine`` and the port's, and the answers (data, names,
status, ``meta.routing``, ``requestPath``, tags, metrics) must be equal."""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from seldon_core_tpu.graph import spec as jspec
from seldon_core_tpu.graph.engine import GraphEngine as JEngine
from seldon_core_tpu.messages import Feedback as JFeedback
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
from seldon_core_tpu.runtime.component import (
    SeldonComponentError as JComponentError,
)
from seldon_core_tpu_torch.graph import spec as tspec
from seldon_core_tpu_torch.graph.builtins import AverageCombiner
from seldon_core_tpu_torch.graph.engine import GraphEngine as TEngine
from seldon_core_tpu_torch.messages import Feedback as TFeedback
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.runtime.component import ComponentHandle as THandle
from seldon_core_tpu_torch.runtime.component import (
    SeldonComponentError as TComponentError,
)

ROOT = Path(__file__).resolve().parents[1]
REF_GRAPHS = sorted((ROOT / "examples" / "graphs").glob("*.json"))
PORT_GRAPHS = ROOT / "seldon_core_tpu_torch" / "examples"


# ---- components, written once for both packages (numpy in, numpy out) --

class Identity:
    def predict(self, X, names):
        return X


class PlusN:
    def __init__(self, n=1.0):
        self.n = n

    def predict(self, X, names):
        return np.asarray(X) + self.n


class Doubler:
    def transform_input(self, X, names):
        return np.asarray(X) * 2.0


class NegateOut:
    def transform_output(self, X, names):
        return -np.asarray(X)


class Route:
    def __init__(self, branch):
        self.branch = branch

    def route(self, X, names):
        return self.branch


class Tagged:
    def predict(self, X, names):
        return X

    def tags(self):
        return {"version": "v7"}

    def metrics(self):
        return [{"key": "hits", "type": "COUNTER", "value": 1}]


class SumScore:
    def score(self, X, names):
        return np.asarray(X).sum(axis=-1)


class NoOp:
    pass


def _boom_factory(error_cls):
    class Boom:
        def predict(self, X, names):
            raise error_cls("bad input", status_code=400, reason="USER")

    return Boom


class Shatter:
    def predict(self, X, names):
        raise ValueError("shape mismatch")


def _engines(spec, mapping=None):
    """The reference engine and the port's over ``spec``; ``mapping`` is
    ``{node: (factory, service_type)}`` and every node gets a fresh object
    from its factory in each engine."""
    mapping = mapping or {}

    def resolver(handle_cls):
        def resolve(unit):
            factory, stype = mapping[unit.name]
            return handle_cls(factory(), name=unit.name, service_type=stype)
        return resolve

    return (JEngine(spec, resolver=resolver(JHandle)),
            TEngine(spec, resolver=resolver(THandle)))


def _canon(msg) -> dict:
    d = msg.to_dict()
    d.get("meta", {}).pop("puid", None)
    return d


def _predict_both(engines, body):
    jeng, teng = engines
    j = asyncio.run(jeng.predict(JMessage.from_dict(body)))
    t = asyncio.run(teng.predict(TMessage.from_dict(body)))
    assert t.meta.puid and j.meta.puid
    return _canon(j), _canon(t)


def _assert_same(engines, body):
    j, t = _predict_both(engines, body)
    assert t == j
    return t


def _feedback_both(engines, fb: dict):
    jeng, teng = engines
    j = asyncio.run(jeng.send_feedback(JFeedback.from_dict(fb)))
    t = asyncio.run(teng.send_feedback(TFeedback.from_dict(fb)))
    assert _canon(t) == _canon(j)
    return t


def _body(x):
    return {"data": {"ndarray": np.asarray(x).tolist()}}


# ---- spec ---------------------------------------------------------------

def _tree(unit) -> dict:
    return {"name": unit.name, "type": unit.type,
            "resolved": unit.resolved_type,
            "implementation": unit.implementation,
            "parameters": unit.parameters,
            "children": [_tree(c) for c in unit.children]}


@pytest.mark.parametrize("path", REF_GRAPHS, ids=lambda p: p.stem)
def test_spec_parses_every_example_graph_like_the_reference(path):
    d = json.loads(path.read_text())
    graph = d["spec"]["predictors"][0]["graph"]
    j, t = jspec.parse_graph(graph), tspec.parse_graph(graph)
    jspec.validate_graph(j)
    tspec.validate_graph(t)
    assert _tree(t) == _tree(j)
    assert [u.name for u in t.walk()] == [u.name for u in j.walk()]


def _port_copy(path: Path) -> Path:
    return PORT_GRAPHS / ("resnet50.json" if path.stem == "resnet50-v5e8"
                          else path.name)


def _no_tpu(ann: dict) -> dict:
    return {k: v for k, v in ann.items() if not k.startswith("seldon.io/tpu-")}


@pytest.mark.parametrize("path", [p for p in REF_GRAPHS
                                  if _port_copy(p).exists()],
                         ids=lambda p: p.stem)
def test_port_graph_copies_differ_only_in_model_class(path):
    """Each port copy (resnet50-v5e8 as resnet50) keeps the reference's
    tree, parameters and batching annotations; TPU annotations may go."""
    name = _port_copy(path).name
    ref = tspec.load_deployment(str(path))
    port = tspec.load_deployment(str(PORT_GRAPHS / name))

    def strip(tree):
        tree["parameters"] = {
            k: (v.replace("seldon_core_tpu.", "seldon_core_tpu_torch.")
                if k == "model_class" else v)
            for k, v in tree["parameters"].items()}
        for c in tree["children"]:
            strip(c)
        return tree

    assert _tree(port.graph) == strip(_tree(ref.graph))
    assert _no_tpu(port.annotations) == _no_tpu(ref.annotations)


def test_int8_resnet_graph_is_the_float_graph_on_the_int8_model():
    f = tspec.load_deployment(str(PORT_GRAPHS / "resnet50.json"))
    q = tspec.load_deployment(str(PORT_GRAPHS / "resnet50-int8.json"))
    assert q.annotations == f.annotations
    assert q.graph.parameters == {
        **f.graph.parameters,
        "model_class":
            "seldon_core_tpu_torch.models.resnet_int8:Int8ResNet50Model"}


@pytest.mark.parametrize("bad", [
    {"name": "c", "type": "COMBINER"},
    {"name": "r", "type": "ROUTER"},
    {"name": "a", "type": "MODEL", "children": [{"name": "a",
                                                 "type": "MODEL"}]},
    {"name": "x", "type": "WAT"},
    {"name": "", "type": "MODEL"},
    {"name": "m", "implementation": "NOPE"},
], ids=["combiner-no-children", "router-no-children", "duplicate",
        "unknown-type", "empty-name", "unknown-implementation"])
def test_spec_validation_errors_match(bad):
    with pytest.raises(jspec.GraphValidationError):
        jspec.validate_graph(jspec.parse_graph(bad))
    with pytest.raises(tspec.GraphValidationError):
        tspec.validate_graph(tspec.parse_graph(bad))


def test_spec_typed_parameters_match():
    node = {"name": "m", "type": "MODEL", "parameters": [
        {"name": "a", "value": "0.5", "type": "FLOAT"},
        {"name": "b", "value": "3", "type": "INT"},
        {"name": "c", "value": "yes", "type": "BOOL"},
        {"name": "d", "value": "x", "type": "STRING"},
        {"name": "e", "value": "2.5", "type": "DOUBLE"},
        {"name": "f", "value": "raw", "type": "JSON"}]}
    assert (tspec.parse_graph(node).parameters
            == jspec.parse_graph(node).parameters)
    bad = {"name": "m", "parameters": [{"name": "n", "value": "x",
                                        "type": "INT"}]}
    with pytest.raises(tspec.GraphValidationError, match="m: parameter 'n'"):
        tspec.parse_graph(bad)


def test_remote_endpoint_node_names_its_slice():
    """A REST endpoint node gets a RemoteComponent with the timeout
    annotations in seconds; a GRPC one names the slice that brings it."""
    from seldon_core_tpu_torch.operator.local import resolve_component
    from seldon_core_tpu_torch.serving.client import RemoteComponent

    node = {"name": "remote", "type": "MODEL", "methods": ["predict"],
            "endpoint": {"service_host": "h", "service_port": 9000}}
    ann = {"seldon.io/rest-read-timeout": "2500",
           "seldon.io/rest-connection-timeout": "400"}
    client = resolve_component(tspec.parse_graph(node), ann, "cpu")
    assert isinstance(client, RemoteComponent)
    assert client.base_url == "http://h:9000" and client.name == "remote"
    assert client.timeout_s == 2.5
    assert client._http.connect_timeout_s == 0.4
    assert client.has("predict") and not client.has("route")
    grpc = tspec.parse_graph({**node, "endpoint": {
        "service_host": "h", "service_port": 9000, "type": "GRPC"}})
    with pytest.raises(NotImplementedError, match="slice 4a-ii"):
        resolve_component(grpc, {}, "cpu")


# ---- the engine, case by case against the reference ----------------------

def test_single_model_predict():
    t = _assert_same(_engines({"name": "m", "type": "MODEL"},
                              {"m": (lambda: PlusN(1.0), "MODEL")}),
                     _body([[1.0, 2.0]]))
    assert t["data"]["ndarray"] == [[2.0, 3.0]]
    assert t["meta"]["requestPath"] == {"m": "PlusN"}


def test_simple_model_builtin():
    t = _assert_same(_engines({"name": "m", "implementation":
                               "SIMPLE_MODEL"}), _body(np.zeros((2, 5))))
    assert t["data"]["names"] == ["svc1", "svc2", "svc3"]


def test_transformer_and_output_transformer():
    spec = {"name": "out-t", "type": "OUTPUT_TRANSFORMER", "children": [
        {"name": "in-t", "type": "TRANSFORMER",
         "children": [{"name": "m", "type": "MODEL"}]}]}
    t = _assert_same(_engines(spec, {
        "out-t": (NegateOut, "OUTPUT_TRANSFORMER"),
        "in-t": (Doubler, "TRANSFORMER"),
        "m": (lambda: PlusN(1.0), "MODEL")}), _body([[3.0]]))
    assert t["data"]["ndarray"] == [[-7.0]]


def test_leaf_output_transformer_applies():
    t = _assert_same(_engines({"name": "t", "type": "OUTPUT_TRANSFORMER"},
                              {"t": (NegateOut, "OUTPUT_TRANSFORMER")}),
                     _body([[3.0]]))
    assert t["data"]["ndarray"] == [[-3.0]]


def test_average_combiner_graph():
    spec = {"name": "ens", "type": "COMBINER",
            "implementation": "AVERAGE_COMBINER",
            "children": [{"name": "m1", "type": "MODEL"},
                         {"name": "m2", "type": "MODEL"}]}
    t = _assert_same(_engines(spec, {"m1": (lambda: PlusN(0.0), "MODEL"),
                                     "m2": (lambda: PlusN(2.0), "MODEL")}),
                     _body([[1.0, 1.0]]))
    assert t["data"]["ndarray"] == [[2.0, 2.0]]


def test_average_combiner_averages_tensors_where_they_lie():
    comb = AverageCombiner()
    res = comb.aggregate([torch.ones((2, 2)), torch.zeros((2, 2))], [[], []])
    assert isinstance(res, torch.Tensor)
    np.testing.assert_allclose(res.numpy(), 0.5 * np.ones((2, 2)))
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(3, 10)).astype(np.float32) for _ in range(3)]
    ref = np.mean(np.stack(xs), axis=0)
    np.testing.assert_allclose(
        comb.aggregate([torch.from_numpy(x) for x in xs], None).numpy(),
        ref, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(comb.aggregate(xs, None), ref)


@pytest.mark.parametrize("branch", [0, 1])
def test_router_branch_selection_and_routing_meta(branch):
    spec = {"name": "r", "type": "ROUTER",
            "children": [{"name": "a", "type": "MODEL"},
                         {"name": "b", "type": "MODEL"}]}
    t = _assert_same(_engines(spec, {
        "r": (lambda: Route(branch), "ROUTER"),
        "a": (lambda: PlusN(100.0), "MODEL"),
        "b": (lambda: PlusN(1.0), "MODEL")}), _body([[0.0]]))
    assert t["meta"]["routing"] == {"r": branch}
    assert ("a" in t["meta"]["requestPath"]) == (branch == 0)


def test_router_out_of_range_branch_is_a_500_routing_error():
    spec = {"name": "r", "type": "ROUTER",
            "children": [{"name": "a", "type": "MODEL"}]}
    t = _assert_same(_engines(spec, {"r": (lambda: Route(3), "ROUTER"),
                                     "a": (Identity, "MODEL")}),
                     _body([[0.0]]))
    assert t["status"]["code"] == 500
    assert t["status"]["reason"] == "ROUTING_ERROR"


def test_router_fanout_all_when_minus_one():
    spec = {"name": "r", "type": "ROUTER", "children": [
        {"name": "a", "type": "MODEL"},
        {"name": "c", "type": "COMBINER",
         "implementation": "AVERAGE_COMBINER",
         "children": [{"name": "b", "type": "MODEL"}]}]}
    t = _assert_same(_engines(spec, {"r": (lambda: Route(-1), "ROUTER"),
                                     "a": (lambda: PlusN(1.0), "MODEL"),
                                     "b": (lambda: PlusN(2.0), "MODEL")}),
                     _body([[0.0]]))
    assert t["data"]["ndarray"] == [[1.0]]  # the first child's output
    assert t["meta"]["routing"]["r"] == -1 and "b" in t["meta"]["requestPath"]


@pytest.mark.parametrize("impl,params", [
    ("RANDOM_ABTEST", [{"name": "ratioA", "value": "0.5", "type": "FLOAT"},
                       {"name": "seed", "value": "3", "type": "INT"}]),
    ("EPSILON_GREEDY", [{"name": "n_branches", "value": "2", "type": "INT"},
                        {"name": "epsilon", "value": "0.5", "type": "FLOAT"},
                        {"name": "seed", "value": "5", "type": "INT"}]),
])
def test_seeded_routers_route_request_for_request(impl, params):
    spec = {"name": "ab", "implementation": impl, "parameters": params,
            "children": [{"name": "a", "type": "MODEL"},
                         {"name": "b", "type": "MODEL"}]}
    engines = _engines(spec, {"a": (lambda: PlusN(0.0), "MODEL"),
                              "b": (lambda: PlusN(9.0), "MODEL")})
    routes = [_assert_same(engines, _body([[1.0]]))["meta"]["routing"]["ab"]
              for _ in range(24)]
    assert set(routes) == {0, 1}


def test_epsilon_greedy_learns_from_feedback():
    spec = {"name": "eg", "implementation": "EPSILON_GREEDY", "parameters": [
        {"name": "n_branches", "value": "2", "type": "INT"},
        {"name": "epsilon", "value": "0.0", "type": "FLOAT"},
        {"name": "seed", "value": "0", "type": "INT"}],
        "children": [{"name": "a", "type": "MODEL"},
                     {"name": "b", "type": "MODEL"}]}
    engines = _engines(spec, {"a": (lambda: PlusN(0.0), "MODEL"),
                              "b": (lambda: PlusN(1.0), "MODEL")})
    assert _assert_same(engines, _body([[0.0]]))["meta"]["routing"] == {
        "eg": 0}
    for _ in range(5):
        _feedback_both(engines, {"response": {"meta": {"routing": {"eg": 1}}},
                                 "reward": 1.0})
    t = _assert_same(engines, _body([[0.0]]))
    assert t["meta"]["routing"]["eg"] == 1
    mab = engines[1].node_impl("eg").user
    assert mab.counts[1] == 5 and mab.values[1] == pytest.approx(1.0)
    jmab = engines[0].node_impl("eg").user
    np.testing.assert_array_equal(mab.values, jmab.values)


def test_feedback_reaches_models_down_routed_branch():
    calls = {"j": [], "t": []}

    def fb_model(tag, sink):
        class FBModel:
            def predict(self, X, names):
                return X

            def send_feedback(self, request, names, reward, truth):
                calls[sink].append((tag, reward))
        return FBModel()

    spec = {"name": "r", "implementation": "SIMPLE_ROUTER",
            "children": [{"name": "a", "type": "MODEL"},
                         {"name": "b", "type": "MODEL"}]}

    def resolver(handle_cls, sink):
        return lambda u: handle_cls(fb_model(u.name, sink), name=u.name)

    jeng = JEngine(spec, resolver=resolver(JHandle, "j"))
    teng = TEngine(spec, resolver=resolver(THandle, "t"))
    _feedback_both((jeng, teng), {"response": {"meta": {"routing": {"r": 0}}},
                                  "reward": 0.5})
    assert calls["t"] == calls["j"] == [("a", 0.5)]


def test_feedback_out_of_range_routing_is_safe():
    spec = {"name": "eg", "implementation": "EPSILON_GREEDY", "parameters": [
        {"name": "n_branches", "value": "2", "type": "INT"}],
        "children": [{"name": "a", "type": "MODEL"},
                     {"name": "b", "type": "MODEL"}]}
    engines = _engines(spec, {"a": (Identity, "MODEL"),
                              "b": (Identity, "MODEL")})
    out = _feedback_both(engines, {"response": {"meta": {"routing":
                                                         {"eg": 7}}},
                                   "reward": 1.0})
    assert out.status.status == "SUCCESS"
    assert np.all(engines[1].node_impl("eg").user.counts == 0)


def test_feedback_delivered_to_ducktyped_impl_without_has():
    rewards = []

    class Duck:
        def predict(self, msg):
            return msg

        def send_feedback(self, fb):
            rewards.append(fb.reward)

    eng = TEngine({"name": "m", "type": "MODEL"}, resolver=lambda u: Duck())
    asyncio.run(eng.send_feedback(TFeedback(reward=0.9)))
    assert rewards == [0.9]


@pytest.mark.parametrize("factory", [
    lambda: _boom_factory(JComponentError)(),
    Shatter,
], ids=["component-error-400", "exception-500"])
def test_failure_status_on_component_error(factory):
    jeng = JEngine({"name": "m", "type": "MODEL"},
                   resolver=lambda u: JHandle(factory(), name="m"))
    tfactory = (factory if factory is Shatter
                else lambda: _boom_factory(TComponentError)())
    teng = TEngine({"name": "m", "type": "MODEL"},
                   resolver=lambda u: THandle(tfactory(), name="m"))
    t = _assert_same((jeng, teng), _body(np.ones((1, 1))))
    assert t["status"]["status"] == "FAILURE"
    assert t["status"]["code"] == (500 if factory is Shatter else 400)


def test_tags_and_metrics_flow_to_response_meta():
    t = _assert_same(_engines({"name": "m", "type": "MODEL"},
                              {"m": (Tagged, "MODEL")}),
                     _body(np.ones((1, 1))))
    assert t["meta"]["tags"] == {"version": "v7"}
    assert [m["key"] for m in t["meta"]["metrics"]] == ["hits"]


def test_request_meta_not_mutated():
    spec = {"name": "r", "implementation": "SIMPLE_ROUTER",
            "children": [{"name": "a", "type": "MODEL"}]}
    _, teng = _engines(spec, {"a": (Identity, "MODEL")})
    req = TMessage.from_ndarray(np.ones((1, 1)))
    req.meta.tags["client"] = "v1"
    out = asyncio.run(teng.predict(req))
    assert req.meta.tags == {"client": "v1"}
    assert out.meta.tags == {"client": "v1"} and out.meta.metrics == []


def test_pass_through_graph_does_not_return_request_object():
    spec = {"name": "t", "type": "TRANSFORMER",
            "children": [{"name": "t2", "type": "TRANSFORMER"}]}
    engines = _engines(spec, {"t": (NoOp, "TRANSFORMER"),
                              "t2": (NoOp, "TRANSFORMER")})
    _assert_same(engines, _body(np.ones((1, 1))))
    req = TMessage.from_ndarray(np.ones((1, 1)))
    out = asyncio.run(engines[1].predict(req))
    assert out is not req
    assert req.status is None and req.meta.puid == ""


def test_outlier_detector_as_transformer_node():
    spec = {"name": "od", "type": "TRANSFORMER",
            "children": [{"name": "m", "type": "MODEL"}]}
    t = _assert_same(_engines(spec, {"od": (SumScore, "OUTLIER_DETECTOR"),
                                     "m": (Identity, "MODEL")}),
                     _body([[1.0, 2.0], [3.0, 4.0]]))
    assert t["meta"]["tags"]["outlierScore"] == [3.0, 7.0]


# ---- the component handle -------------------------------------------------

def test_predict_fn_arity_and_dtype_like_jax():
    """A float64 host input reaches ``predict_fn`` as float32, as jax (64-bit
    types off) hands it to the reference's; ``predict_fn(X)`` beside an
    unrelated ``params`` attribute takes one argument."""
    seen = []

    class C:
        params = {"unrelated": 1}

        def predict_fn(self, X):
            seen.append(X.dtype)
            return X * 2.0

    out = THandle(C(), name="c").predict(
        TMessage.from_ndarray(np.ones((1, 2))))
    assert seen == [torch.float32]
    np.testing.assert_array_equal(out.host_data(), [[2.0, 2.0]])
    assert out.names == ["t:0", "t:1"]

    class NeedsParams:
        def predict_fn(self, params, X):
            return X

    with pytest.raises(ValueError, match="no `params` attribute"):
        THandle(NeedsParams())


def test_llm_component_boots_through_the_message_passthrough():
    from seldon_core_tpu_torch.operator.local import LocalDeployment

    dep = tspec.load_deployment(str(PORT_GRAPHS / "llm.json"))
    local = LocalDeployment(dep, device="cpu")
    handle = local.engine.node_impl("llm")
    assert isinstance(handle, THandle)  # batching "false": no BatchedModel
    assert handle.has("predict") and handle.has("stream")
    assert not handle.has("send_feedback")
    handle.user.engine.close()
