"""The port's state persistence against the JAX reference on the CPU.

- Stores round-trip blobs (memory and file; the file store writes
  atomically and checks its default root's owner).
- ``PersistenceManager`` restores, pushes, pushes on a timer and pushes a
  last time on stop.
- ``store_from_env`` reads the reference's environment variables and picks
  the reference's default root.
- The MAB router's and the outlier detector's state EQUAL the reference's
  after the same traffic and feedback, and survive a ``FileStateStore``
  round trip: the restored component routes and scores as the original.
  The same holds through the local runner's graphs.
- The reference's blobs (a pickled jax treedef, a pickled object) and the
  orbax backend are refused with an error that says why.
"""

import asyncio
import io
import os
import pickle
import stat
import time

import numpy as np
import pytest

from seldon_core_tpu.graph import builtins as jbuiltins
from seldon_core_tpu.models import outlier as joutlier
from seldon_core_tpu.runtime import persistence as jpersist
from seldon_core_tpu_torch.graph import builtins as tbuiltins
from seldon_core_tpu_torch.models import outlier as toutlier
from seldon_core_tpu_torch.runtime import persistence as tpersist


def _traffic(router, n=60, seed=0):
    """Route ``n`` requests and reward branch 1 more than branch 0."""
    rng = np.random.default_rng(seed)
    routes = []
    for _ in range(n):
        b = router.route(None, [])
        routes.append(b)
        router.send_feedback(None, [], float(rng.random() < (0.8 if b else
                                                              0.3)), None,
                             routing=b)
    return routes


def _rows(n=40, seed=1):
    return np.random.default_rng(seed).normal([5.8, 3.0, 3.8, 1.2], 0.8,
                                              (n, 4))


def _ref_outlier_state(det):
    data = np.load(io.BytesIO(det.get_state()))
    return {k: data[k] for k in ("n", "mean", "m2")}


def test_mab_state_equals_reference_and_survives_a_file_round_trip(tmp_path):
    ref = jbuiltins.EpsilonGreedy(n_branches=3, epsilon=0.2, seed=5)
    port = tbuiltins.EpsilonGreedy(n_branches=3, epsilon=0.2, seed=5)
    assert _traffic(ref) == _traffic(port)
    want, got = ref.get_state(), port.get_state()
    np.testing.assert_array_equal(got["counts"], want["counts"])
    np.testing.assert_array_equal(got["values"], want["values"])
    assert got["counts"].sum() == 60

    store = tpersist.FileStateStore(str(tmp_path))
    key = tpersist.persistence_key("dep", "main", "eg-router")
    tpersist.PersistenceManager(port, store, key).push()
    fresh = tbuiltins.EpsilonGreedy(n_branches=3, epsilon=0.2, seed=5)
    assert tpersist.PersistenceManager(fresh, store, key).restore()
    back = fresh.get_state()
    assert back["counts"].dtype == np.int64
    np.testing.assert_array_equal(back["counts"], got["counts"])
    np.testing.assert_array_equal(back["values"], got["values"])
    # the reference's set_state reads the restored state as its own
    twin = jbuiltins.EpsilonGreedy(n_branches=3)
    twin.set_state(back)
    np.testing.assert_array_equal(twin.get_state()["values"], want["values"])
    fresh.epsilon = port.epsilon = 0.0  # exploitation: a function of state
    assert fresh.route(None, []) == port.route(None, []) == int(
        np.argmax(want["values"]))


def test_outlier_state_equals_reference_and_survives_a_round_trip(tmp_path):
    ref = joutlier.MahalanobisOutlier(warmup=5)
    port = toutlier.MahalanobisOutlier(warmup=5)
    rows = _rows()
    np.testing.assert_array_equal(port.score(rows, []), ref.score(rows, []))
    want, got = _ref_outlier_state(ref), port.get_state()
    assert int(got["n"]) == int(want["n"]) == 40
    np.testing.assert_array_equal(got["mean"], want["mean"])
    np.testing.assert_array_equal(got["m2"], want["m2"])

    store = tpersist.FileStateStore(str(tmp_path))
    tpersist.PersistenceManager(port, store, "k").push()
    fresh = toutlier.MahalanobisOutlier(warmup=5)
    tpersist.PersistenceManager(fresh, store, "k").restore()
    probe = np.vstack([_rows(5, 9), np.full((1, 4), 30.0)])
    scores = fresh.score(probe, [])
    np.testing.assert_array_equal(scores, port.score(probe, []))
    np.testing.assert_array_equal(scores, ref.score(probe, []))
    assert scores[-1] > 100 * scores[:-1].max()  # the outlier stands out


def test_empty_outlier_state_round_trips():
    det = toutlier.MahalanobisOutlier()
    blob = tpersist.pack_state(det.get_state())
    fresh = toutlier.MahalanobisOutlier()
    fresh.set_state(tpersist.unpack_state(blob))
    assert fresh.n == 0 and fresh.mean is None and fresh.m2 is None


def test_stores_round_trip(tmp_path):
    for store in (tpersist.MemoryStateStore(),
                  tpersist.FileStateStore(str(tmp_path / "s"))):
        assert store.load("a/b") is None
        store.save("a/b", b"one")
        store.save("a/b", b"two")
        assert store.load("a/b") == b"two"
    # one file per key, no temporary left behind
    assert os.listdir(tmp_path / "s") == ["a_b.state"]


def test_file_store_owner_check(tmp_path, monkeypatch):
    root = tmp_path / "open"
    root.mkdir()
    os.chmod(root, 0o777)
    tpersist.FileStateStore(str(root), require_owner=True)
    assert stat.S_IMODE(os.stat(root).st_mode) & 0o022 == 0
    monkeypatch.setattr(os, "getuid", lambda: os.stat(root).st_uid + 1)
    with pytest.raises(PermissionError, match="another user"):
        tpersist.FileStateStore(str(root), require_owner=True)
    tpersist.FileStateStore(str(root))  # an explicit root is not checked


def test_blob_codec_round_trips_nested_state():
    import torch

    state = {"a": np.arange(6, dtype=np.int16).reshape(2, 3),
             "b": [np.float32(1.5), 3, "x", None, {"c": torch.ones(2)}],
             "d": 2.25}
    back = tpersist.unpack_state(tpersist.pack_state(state))
    np.testing.assert_array_equal(back["a"], state["a"])
    assert back["a"].dtype == np.int16
    assert back["b"][0] == np.float32(1.5) and back["b"][1:4] == [3, "x",
                                                                 None]
    assert torch.equal(back["b"][4]["c"], torch.ones(2))
    assert back["d"] == 2.25
    with pytest.raises(TypeError, match="pickle"):
        tpersist.pack_state({"o": np.asarray([object()])})
    with pytest.raises(TypeError, match="strings"):
        tpersist.pack_state({1: 2})


def test_manager_restore_push_start_stop():
    store = tpersist.MemoryStateStore()
    mab = tbuiltins.EpsilonGreedy(seed=1)
    mgr = tpersist.PersistenceManager(mab, store, "k", push_frequency=0.02)
    assert not mgr.restore()  # nothing stored yet
    assert mgr.start() is mgr.start()  # one thread
    _traffic(mab, 10)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 5:
        blob = store.load("k")
        if blob is not None and \
                tpersist.unpack_state(blob)["counts"].sum() == 10:
            break
        time.sleep(0.01)
    assert tpersist.unpack_state(store.load("k"))["counts"].sum() == 10
    _traffic(mab, 5)
    mgr.stop()  # joins the thread, then one last push
    assert mgr._thread is None
    assert tpersist.unpack_state(store.load("k"))["counts"].sum() == 15
    fresh = tbuiltins.EpsilonGreedy(seed=1)
    assert tpersist.PersistenceManager(fresh, store, "k").restore()
    np.testing.assert_array_equal(fresh.counts, mab.counts)
    with pytest.raises(TypeError, match="get_state"):
        tpersist.PersistenceManager(object(), store, "k")


def test_store_from_env_matches_reference(tmp_path, monkeypatch):
    monkeypatch.delenv("SELDON_STATE_BACKEND", raising=False)
    monkeypatch.setenv("SELDON_STATE_DIR", str(tmp_path / "explicit"))
    ref, port = jpersist.store_from_env(), tpersist.store_from_env()
    assert isinstance(port, tpersist.FileStateStore)
    assert port.root == ref.root == str(tmp_path / "explicit")
    monkeypatch.delenv("SELDON_STATE_DIR")
    monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path / "xdg"))
    ref, port = jpersist.store_from_env(), tpersist.store_from_env()
    assert port.root == ref.root == str(tmp_path / "xdg" / "seldon-state")
    monkeypatch.delenv("XDG_STATE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    ref, port = jpersist.store_from_env(), tpersist.store_from_env()
    assert port.root == ref.root == str(
        tmp_path / "home" / ".local" / "state" / "seldon-state")
    assert tpersist.persistence_key("d", "p", "u") == \
        jpersist.persistence_key("d", "p", "u")
    monkeypatch.setenv("SELDON_STATE_BACKEND", "orbax")
    with pytest.raises(NotImplementedError, match="orbax"):
        tpersist.store_from_env()
    with pytest.raises(NotImplementedError, match="orbax"):
        tpersist.OrbaxStateStore(str(tmp_path))


def test_reference_blobs_are_refused(tmp_path):
    mab = jbuiltins.EpsilonGreedy(seed=2)
    _traffic(mab, 8)
    store = tpersist.FileStateStore(str(tmp_path))
    # what the reference's manager writes for a state and for an object
    store.save("state", jpersist._pack_state(mab.get_state()))
    store.save("pickle", jpersist._PICKLE_MAGIC + pickle.dumps([1, 2]))
    store.save("junk", b"hello world")
    port = tbuiltins.EpsilonGreedy(seed=2)
    for key, what in (("state", "jax treedef"), ("pickle", "pickled"),
                      ("junk", "unrecognized")):
        with pytest.raises(ValueError, match=what):
            tpersist.PersistenceManager(port, store, key).restore()
    assert port.counts.sum() == 0  # nothing was applied


def _runner_graph(name):
    import json
    from pathlib import Path

    d = json.loads((Path(__file__).resolve().parent.parent
                    / "seldon_core_tpu_torch" / "examples"
                    / f"{name}.json").read_text())
    g = d["spec"]["predictors"][0]["graph"]
    if name == "epsilon-greedy-mab":
        # exploitation only: routing is then a function of the state
        for p in g["parameters"]:
            if p["name"] == "epsilon":
                p["value"] = "0.0"
    return d


@pytest.mark.parametrize("name,unit", [("epsilon-greedy-mab", "eg-router"),
                                       ("iris-with-outlier",
                                        "outlier-detector")])
def test_graph_state_survives_a_runner_restart(tmp_path, name, unit):
    """A runner's learning unit takes traffic (and feedback), its state is
    pushed to a file store, and a fresh runner that restores it answers the
    same probes as the original: equal routing, outlier scores and data."""
    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.messages import Feedback, SeldonMessage
    from seldon_core_tpu_torch.operator.local import LocalDeployment

    d = _runner_graph(name)
    rng = np.random.default_rng(3)
    if name == "epsilon-greedy-mab":
        bodies = [{"data": {"ndarray": rng.normal(size=(2, 784)).tolist()}}
                  for _ in range(3)]
    else:
        bodies = [{"data": {"ndarray": _rows(4, s).tolist()}}
                  for s in range(4)]
    store = tpersist.FileStateStore(str(tmp_path))
    key = tpersist.persistence_key(d["spec"]["name"], "main", unit)

    async def serve_traffic(local):
        for b in bodies:
            out = await local.predict(SeldonMessage.from_dict(b))
            if name == "epsilon-greedy-mab":
                fb = {"response": {"meta": {"routing": {unit: 1}}},
                      "reward": 1.0}
                await local.send_feedback(Feedback.from_dict(fb))
        return out

    async def probes(local):
        outs = []
        for b in bodies:
            o = (await local.predict(SeldonMessage.from_dict(b))).to_dict()
            o["meta"].pop("puid")
            outs.append(o)
        return outs

    first = LocalDeployment(load_deployment(d), device="cpu")
    asyncio.run(serve_traffic(first))
    tpersist.PersistenceManager(first.engine.node_impl(unit).user, store,
                                key).push()
    want = asyncio.run(probes(first))
    second = LocalDeployment(load_deployment(d), device="cpu")
    assert tpersist.PersistenceManager(second.engine.node_impl(unit).user,
                                       store, key).restore()
    got = asyncio.run(probes(second))
    assert got == want
    if name == "epsilon-greedy-mab":
        assert {o["meta"]["routing"][unit] for o in got} == {1}
    else:
        assert any(s > 0 for o in got for s in o["meta"]["tags"][
            "outlierScore"])
