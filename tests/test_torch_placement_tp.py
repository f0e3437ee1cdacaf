"""The port's tensor-parallel leaves and its sharded buckets in the
artifact store, on the CPU.

- ``placement/tp.py`` :class:`TpLeaf`: a product against a leaf split on
  its output dim computes each rank's columns, one split on its contraction
  dim sums the ranks' partials in float32 in rank order; every other op
  gathers the leaf, which is exact.  Held against the same op on the whole
  weight, and against the reference's split of the same weight
  (``jax.device_put`` onto its ``NamedSharding`` on 2 of conftest's
  virtual devices).
- ``placement/layouts.py`` :func:`build_shardings` names the reference's
  specs leaf for leaf; :func:`place_params` holds 1/tp of every covered
  leaf per rank in storage of its own and copies nothing else.
- The artifact plane (``artifacts/plane.py``): a fused iris armed at
  dp = 2 publishes its verified sharded buckets under the mesh slice; a
  warm engine on the same store captures them at boot (``aot-cache`` on
  the capture ledger, under ``clf@dp2``) and answers EQUAL with no live
  capture; a tp = 2 or unmeshed engine takes none of them.  A bucket is
  captured only on the card, so capture is stood in for as in
  ``tests/test_torch_artifacts.py`` (its ``graphs`` fixture).
"""

import asyncio
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec

from seldon_core_tpu.parallel.mesh import make_mesh as jmake_mesh
from seldon_core_tpu.placement import layouts as jlayouts
from seldon_core_tpu_torch.artifacts import ArtifactConfig, ArtifactPlane
from seldon_core_tpu_torch.graph.engine import GraphEngine
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.operator.local import resolve_component
from seldon_core_tpu_torch.parallel.mesh import Shards, make_mesh
from seldon_core_tpu_torch.placement import (
    PlacementPlane,
    layouts,
    placement_config_from_annotations,
)
from seldon_core_tpu_torch.placement.tp import TpLeaf, rank_bytes
from seldon_core_tpu_torch.profiling.compilewatch import CompileWatch
from tests.test_torch_artifacts import graphs  # noqa: F401  (fixture)

# ---------------------------------------------------------------------------
# the sharded leaf
# ---------------------------------------------------------------------------


def _split(w: torch.Tensor, dim: int, n: int = 2) -> TpLeaf:
    return TpLeaf(Shards([p.contiguous() for p in torch.chunk(w, n, dim)],
                         dim))


def _xw(seed=0, m=5, k=8, n=6):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.standard_normal((m, k)).astype("float32")),
            torch.from_numpy(rng.standard_normal((k, n)).astype("float32")),
            torch.from_numpy(rng.standard_normal((n,)).astype("float32")))


@pytest.mark.parametrize("op", ["matmul", "operator", "mm", "linear",
                                "addmm"])
@pytest.mark.parametrize("split", ["output", "contraction"])
def test_products_against_the_whole_weight(op, split):
    x, w, b = _xw()
    lin = op == "linear"
    whole = w.t().contiguous() if lin else w
    # the output dim is 0 of a linear weight (N, K), 1 of a matmul's (K, N)
    dim = (0 if split == "output" else 1) if lin else (
        1 if split == "output" else 0)
    leaf = _split(whole, dim)
    call = {
        "matmul": lambda v: torch.matmul(x, v),
        "operator": lambda v: x @ v,
        "mm": lambda v: torch.mm(x, v),
        "linear": lambda v: F.linear(x, v, b),
        "addmm": lambda v: torch.addmm(b, x, v),
    }[op]
    with torch.inference_mode():
        got, want = call(leaf), call(whole)
    assert type(got) is torch.Tensor
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_contraction_split_sums_in_float32_in_rank_order():
    x, w, _ = _xw(1)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    leaf = _split(wb, 0)
    with torch.inference_mode():
        got = xb @ leaf
    parts = [xb[:, :4] @ wb[:4], xb[:, 4:] @ wb[4:]]
    want = (parts[0].float() + parts[1].float()).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_every_other_op_gathers_the_leaf_exactly():
    x, w, b = _xw(2)
    leaf, bias = _split(w, 1), _split(b, 0)
    with torch.inference_mode():
        assert torch.equal(leaf.t(), w.t())
        assert torch.equal(leaf.sum(dim=0), w.sum(dim=0))
        assert torch.equal(x @ w + bias, x @ w + b)
        assert torch.equal(torch.relu(leaf), torch.relu(w))
        assert torch.equal(leaf[1], w[1])
        assert torch.equal(leaf.whole(), w)
    assert (leaf.shape, leaf.dtype, leaf.device, leaf.dim()) == (
        w.shape, w.dtype, w.device, 2)
    assert rank_bytes(leaf) == [w.nbytes // 2] * 2


def test_the_split_matches_the_references():
    """The pieces are the reference's shards of the same weight: the
    reference's ``device_put`` onto its ``NamedSharding`` on two devices,
    shard for shard."""
    _, w, _ = _xw(3)
    jmesh = jmake_mesh(n_devices=2, tp=2)
    for axes, dim in (((None, "tp"), 1), (("tp", None), 0)):
        arr = jax.device_put(jnp.asarray(w.numpy()),
                             JNamedSharding(jmesh, PartitionSpec(*axes)))
        jparts = [np.asarray(s.data) for s in sorted(
            arr.addressable_shards, key=lambda s: s.index[dim].start or 0)]
        leaf = _split(w, dim)
        assert [p.numpy().tolist() for p in leaf.parts] == \
            [p.tolist() for p in jparts]


# ---------------------------------------------------------------------------
# layouts: build_shardings and place_params
# ---------------------------------------------------------------------------

MLP_SPECS = {"0/w": (None, "tp"), "0/b": ("tp",),
             "1/w": (None, "tp"), "1/b": ("tp",)}


def _mlp_params(hidden=16):
    g = torch.Generator().manual_seed(0)
    sizes = (784, hidden, hidden // 2, 10)
    return [{"w": torch.randn((m, n), generator=g), "b": torch.zeros(n)}
            for m, n in zip(sizes[:-1], sizes[1:])]


def test_build_shardings_names_the_references_specs():
    params = _mlp_params()
    lay = layouts.resolve_layout(params, declared=MLP_SPECS, tp=2)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    assert lay == jlayouts.resolve_layout(jparams, declared=MLP_SPECS, tp=2)
    mesh = make_mesh(devices=["cpu"] * 4, tp=2)
    jmesh = jmake_mesh(n_devices=4, tp=2)
    ours = layouts.build_shardings(mesh, params, lay)
    ref = jlayouts.build_shardings(jmesh, jparams, lay)
    ours = dict(layouts.iter_param_leaves(ours))
    ref = dict(jlayouts.iter_param_leaves(ref))
    assert set(ours) == set(ref) == {f"{i}/{k}" for i in range(3)
                                     for k in "wb"}
    for pkey, s in ours.items():
        assert s.mesh is mesh
        assert tuple(s.spec) == tuple(ref[pkey].spec), pkey


def test_place_params_holds_one_piece_per_rank():
    params = _mlp_params()
    lay = layouts.resolve_layout(params, declared=MLP_SPECS, tp=2)
    mesh = make_mesh(devices=["cpu"] * 4, tp=2)
    placed = layouts.place_params(mesh, params, lay, dp=1)
    for i in (0, 1):
        for k in ("w", "b"):
            leaf = placed[i][k]
            assert isinstance(leaf, TpLeaf) and leaf.split_dim == (
                1 if k == "w" else 0)
            assert torch.equal(leaf.whole(), params[i][k])
            assert rank_bytes(leaf) == [params[i][k].nbytes // 2] * 2
    assert placed[2]["w"] is params[2]["w"]  # replicated: no copy
    assert placed[2]["b"] is params[2]["b"]


def test_placement_plane_arms_on_a_given_mesh():
    """Two ranks of one device (the card phase's posture, here on the
    CPU), the plane given its mesh rather than building one."""
    cfg = placement_config_from_annotations({"seldon.io/mesh": "tp=2"})
    mesh = make_mesh(devices=["cpu", "cpu"], tp=2)
    plane = PlacementPlane(cfg, mesh=mesh)
    spec = {"name": "clf", "type": "MODEL", "parameters": [
        {"name": "model_class",
         "value": "seldon_core_tpu_torch.models.mlp:MNISTMLPClassifier",
         "type": "STRING"},
        {"name": "hidden", "value": "16", "type": "INT"}]}
    eng = GraphEngine(spec, resolver=lambda u: resolve_component(
        u, {"seldon.io/batching": "false"}, "cpu"), name="p",
        plan_mode="fused", placement=plane)
    seg = eng.plan.segments[0]
    assert plane.mesh is mesh
    assert plane.sharded_segments == ["clf"]
    assert seg.shard_parity == "verified"
    assert seg.describe()["tpSpan"]["params"] == {
        "clf": ["0/b", "0/w", "1/b", "1/w"]}


# ---------------------------------------------------------------------------
# sharded buckets in the artifact store (capture stood in for)
# ---------------------------------------------------------------------------

IRIS_SPEC = {"name": "clf", "type": "MODEL", "parameters": [{
    "name": "model_class",
    "value": "seldon_core_tpu_torch.models.iris:IrisClassifier",
    "type": "STRING"}]}
XS = [np.random.RandomState(i).uniform(size=(n, 4)).astype("float32")
      for i, n in enumerate((4, 8))]


def _profiler():
    """The engine's profiler surface the capture ledger needs."""
    return SimpleNamespace(
        compile=CompileWatch(), ensure_started=lambda: None,
        attribution=SimpleNamespace(note_request=lambda *a: None,
                                    note_dispatch=lambda *a: None))


def _engine(store, mesh_spec):
    art = ArtifactPlane(ArtifactConfig(enabled=True, store=str(store)))
    plane = None
    if mesh_spec:
        cfg = placement_config_from_annotations({"seldon.io/mesh": mesh_spec})
        plane = PlacementPlane(cfg, device="cpu")
    prof = _profiler()
    eng = GraphEngine(IRIS_SPEC, resolver=lambda u: resolve_component(
        u, {"seldon.io/batching": "false"}, "cpu"), name="p",
        plan_mode="fused", placement=plane, artifacts=art, profiler=prof)
    return eng, art, prof.compile


def _answers(eng):
    out = []
    for x in XS:
        m = SeldonMessage.from_ndarray(x)
        m.meta.puid = "art"
        out.append(asyncio.run(eng.predict(m)).to_dict())
    return out


def test_sharded_buckets_publish_and_hydrate(tmp_path, graphs):  # noqa: F811
    cold, cold_art, _ = _engine(tmp_path, "dp=2")
    seg = cold.plan.segments[0]
    assert seg.shard_parity == "verified"
    cold_out = _answers(cold)
    assert seg.n_sharded_calls == 2
    assert {c["parity"] for c in seg.shard_cost_by_bucket.values()} == {
        "verified"}
    snap = cold_art.snapshot()
    assert snap["published"] == 2 and snap["parityFailures"] == 0
    shard_records = [sc for sc in cold_art.store.sidecars(seg._artifact_fp)
                     if sc["sharding"]]
    assert sorted(sc["bucketShape"][0] for sc in shard_records) == [4, 8]
    assert {sc["sharding"] for sc in shard_records} == {"dp=2"}
    assert {sc["segment"] for sc in shard_records} == {"clf@dp2"}
    captures = graphs["captures"]

    warm, warm_art, ledger = _engine(tmp_path, "dp=2")
    wseg = warm.plan.segments[0]
    assert graphs["captures"] == captures + 2  # both, at boot
    assert wseg.shard_hydrated == {((4, 4), "torch.float32"),
                                   ((8, 4), "torch.float32")}
    rows = ledger.snapshot()["segments"]["clf@dp2"]
    assert rows["hydrations"] == 2 and rows["compiles"] == 0
    assert {b["source"] for b in rows["buckets"].values()} == {"aot-cache"}
    warm_out = _answers(warm)
    assert graphs["captures"] == captures + 2  # none on the request path
    assert wseg.n_sharded_calls == 2
    assert warm_art.snapshot()["liveCompiles"] == 0
    assert all(c["source"] == "aot-cache" and c["parity"] == "verified"
               for c in wseg.shard_cost_by_bucket.values())
    for a, b in zip(cold_out, warm_out):
        assert a["data"] == b["data"]
    desc = warm_art.describe()["segments"][0]
    assert set(desc["shardBuckets"]) == {"4x4:float32", "8x4:float32"}


@pytest.mark.parametrize("mesh_spec", ["tp=2", ""])
def test_a_dp_record_is_never_taken_by_another_mesh(tmp_path, graphs,  # noqa
                                                     mesh_spec):
    cold, _, _ = _engine(tmp_path, "dp=2")
    _answers(cold)
    other, art, _ = _engine(tmp_path, mesh_spec)
    seg = other.plan.segments[0]
    assert art.snapshot()["hydrated"] == 0
    assert not seg.shard_hydrated and not seg.hydrated
    _answers(other)
    assert seg.n_sharded_calls == 0  # iris has no tp layout; no mesh
