"""Several predictors per deployment: the port's spec loader and
``LocalDeployment`` against the JAX package's.

- Every predictor is loaded (name, graph, replicas, traffic, annotations
  merged metadata < spec < predictor) with the reference's defaults and
  admission checks.
- ``pick()`` draws the reference's predictor sequence, draw for draw, for
  the same seed (seeds 0-4, 1000 picks, several weightings).
- ``predict`` and ``stream`` go through ``pick()`` and feedback reaches
  every predictor, as in the reference; each predictor has its own engine,
  QoS, plan and cache.
- The fault repaired: a canary's second predictor received no request
  (the port served everything by the first).
"""

import asyncio
import json
import urllib.request

import numpy as np
import pytest

from seldon_core_tpu.messages import Feedback as JFeedback
from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.operator.local import LocalDeployment as JLocal
from seldon_core_tpu.operator.spec import (
    DeploymentValidationError as JDeploymentValidationError,
)
from seldon_core_tpu.operator.spec import SeldonDeployment, validate_deployment
from seldon_core_tpu_torch.graph import spec as tspec
from seldon_core_tpu_torch.messages import Feedback as TFeedback
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.operator.local import LocalDeployment as TLocal


def run(coro):
    return asyncio.run(coro)


def _model(name):
    return {"name": name, "implementation": "SIMPLE_MODEL"}


def _dep(preds, ann=None, meta_ann=None) -> dict:
    return {"metadata": {"name": "canary",
                         "annotations": meta_ann or {}},
            "spec": {"name": "canary", "annotations": ann or {},
                     "predictors": preds}}


def _both(d, seed):
    jlocal = JLocal(SeldonDeployment.from_dict(d), seed=seed)
    tlocal = TLocal(tspec.load_deployment(d), device="cpu", seed=seed)
    return jlocal, tlocal


WEIGHTINGS = {
    "3:1": [{"name": "main", "replicas": 3, "graph": _model("a")},
            {"name": "canary", "replicas": 1, "graph": _model("b")}],
    "traffic-90-10": [
        {"name": "main", "traffic": 90, "graph": _model("a")},
        {"name": "canary", "traffic": 10, "graph": _model("b")}],
    "three": [{"name": "p0", "replicas": 2, "traffic": 50,
               "graph": _model("a")},
              {"name": "p1", "replicas": 1, "graph": _model("b")},
              {"name": "p2", "replicas": 0, "graph": _model("c")}],
    "all-zero": [{"name": "p0", "replicas": 0, "graph": _model("a")},
                 {"name": "p1", "replicas": 0, "graph": _model("b")}],
}


@pytest.mark.parametrize("weighting", list(WEIGHTINGS))
@pytest.mark.parametrize("seed", range(5))
def test_pick_draws_the_reference_sequence(weighting, seed):
    jlocal, tlocal = _both(_dep(WEIGHTINGS[weighting]), seed)
    assert tlocal._weights == jlocal._weights
    j = [jlocal.pick().spec.name for _ in range(1000)]
    t = [tlocal.pick().spec.name for _ in range(1000)]
    assert t == j


def test_every_predictor_is_loaded_like_the_reference():
    preds = [{"name": "main", "replicas": 3, "traffic": 75,
              "annotations": {"seldon.io/batching": "false",
                              "seldon.io/graph-plan": "fused"},
              "graph": _model("a")},
             {"name": "canary", "graph": _model("b")}]
    d = _dep(preds, ann={"seldon.io/spec-hash": "h", "x": "spec"},
             meta_ann={"x": "meta", "y": "meta"})
    jdep = SeldonDeployment.from_dict(d)
    tdep = tspec.load_deployment(d)
    assert [p.name for p in tdep.predictors] == [p.name for p in
                                                 jdep.predictors]
    for t, j in zip(tdep.predictors, jdep.predictors):
        assert (t.replicas, t.traffic) == (j.replicas, j.traffic)
        assert t.annotations == {**jdep.annotations, **j.annotations}
        assert t.graph.name == j.graph.name
    assert (tdep.graph, tdep.annotations, tdep.predictor) == (
        tdep.predictors[0].graph, tdep.predictors[0].annotations, "main")


@pytest.mark.parametrize("preds", [
    [{"name": "p", "graph": _model("a")}, {"name": "p", "graph": _model("b")}],
    [{"name": "p", "replicas": -1, "graph": _model("a")}],
], ids=["duplicate-name", "negative-replicas"])
def test_admission_errors_match_the_reference(preds):
    with pytest.raises(JDeploymentValidationError) as je:
        validate_deployment(SeldonDeployment.from_dict(_dep(preds)))
    with pytest.raises(tspec.DeploymentValidationError) as te:
        tspec.load_deployment(_dep(preds))
    assert str(te.value) == str(je.value)


def test_each_predictor_has_its_own_engine_plan_cache_and_qos():
    mlp = {"name": "m", "type": "MODEL", "parameters": [
        {"name": "model_class",
         "value": "seldon_core_tpu_torch.models.mlp:MNISTMLP",
         "type": "STRING"},
        {"name": "hidden", "value": "32", "type": "INT"}]}
    preds = [{"name": "main", "graph": mlp,
              "annotations": {"seldon.io/graph-plan": "fused",
                              "seldon.io/prediction-cache": "true",
                              "seldon.io/slo-p95-ms": "100"}},
             {"name": "canary", "graph": mlp}]
    local = TLocal(tspec.load_deployment(_dep(preds)), device="cpu")
    main, canary = local.predictors
    assert local.engine is main.engine
    assert main.engine.plan is not None and canary.engine.plan is None
    assert main.cache is not None and canary.cache is None
    assert main.cache.config.name == "canary/main"
    assert main.qos is not None and canary.qos is None
    assert main.engine.node_impl("m") is not canary.engine.node_impl("m")
    assert main.engine.metrics is canary.engine.metrics is local.metrics


def _served_by(out) -> str:
    return next(iter(out.meta.request_path))


def _drive(local, msg_cls, n=60) -> list:
    """Predictions, every fifth call a stream (this graph cannot stream:
    501, after the pick); the node that served each prediction."""
    x = np.ones((1, 2))
    out = []
    for i in range(n):
        if i % 5 == 4:
            with pytest.raises(Exception) as e:
                local.stream(msg_cls.from_ndarray(x))
            assert getattr(e.value, "status_code", None) == 501
            out.append("stream")
        else:
            out.append(_served_by(run(local.predict(
                msg_cls.from_ndarray(x)))))
    return out


def test_predict_and_stream_go_through_pick_like_the_reference():
    """The fault repaired: the second predictor of a canary was never
    served.  Interleaved predictions and streams pick in the reference's
    order."""
    jlocal, tlocal = _both(_dep(WEIGHTINGS["3:1"]), seed=3)
    t = _drive(tlocal, TMessage)
    assert t == _drive(jlocal, JMessage)
    assert {"a", "b"} <= set(t)


def test_feedback_reaches_every_predictor():
    def bandit(name):
        return {"name": name, "implementation": "EPSILON_GREEDY",
                "parameters": [
                    {"name": "n_branches", "value": "2", "type": "INT"},
                    {"name": "epsilon", "value": "0.0", "type": "FLOAT"}],
                "children": [_model(f"{name}-a"), _model(f"{name}-b")]}

    preds = [{"name": "main", "replicas": 3, "graph": bandit("r0")},
             {"name": "canary", "replicas": 1, "graph": bandit("r1")}]
    jlocal, tlocal = _both(_dep(preds), seed=0)
    fb = {"response": {"meta": {"routing": {"r0": 1, "r1": 0}}},
          "reward": 1.0}
    for _ in range(3):
        jo = run(jlocal.send_feedback(JFeedback.from_dict(fb)))
        to = run(tlocal.send_feedback(TFeedback.from_dict(fb)))
        assert to.status.status == jo.status.status == "SUCCESS"
    for tp, jp, name in zip(tlocal.predictors, jlocal.predictors,
                            ("r0", "r1")):
        tu = tp.engine.node_impl(name).user
        ju = jp.engine.node_impl(name).user
        np.testing.assert_array_equal(tu.counts, ju.counts)
        np.testing.assert_array_equal(tu.values, ju.values)
    assert tlocal.predictors[0].engine.node_impl("r0").user.counts[1] == 3
    assert tlocal.predictors[1].engine.node_impl("r1").user.counts[0] == 3


def test_rest_serves_the_split():
    """The runner's REST tier serves the deployment, not one engine: 40
    requests over HTTP follow the reference's seeded picks."""
    from seldon_core_tpu_torch.operator.local import serve

    d = _dep(WEIGHTINGS["traffic-90-10"])
    jlocal = JLocal(SeldonDeployment.from_dict(d), seed=1)
    want = [jlocal.pick().spec.name for _ in range(40)]
    names = {"main": "a", "canary": "b"}

    async def go():
        server, local = await serve(d, port=0, host="127.0.0.1",
                                    device="cpu", seed=1)
        try:
            got = []
            for _ in range(40):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{server.port}/api/v0.1/predictions",
                    data=json.dumps({"data": {"ndarray": [[1.0]]}}).encode(),
                    headers={"Content-Type": "application/json"})
                body = await asyncio.to_thread(
                    lambda: json.loads(urllib.request.urlopen(
                        req, timeout=30).read()))
                got.append(next(iter(body["meta"]["requestPath"])))
            return got
        finally:
            await server.stop()

    assert run(go()) == [names[w] for w in want]
