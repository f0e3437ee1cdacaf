"""The port's mesh plan, mesh registry, collectives and ring attention
(``seldon_core_tpu_torch/parallel/``, ``placement/meshes.py``) against the
reference's (``tests/test_parallel.py``) on the CPU: the reference on
conftest's 8 virtual devices, the port on repeats of the CPU device.

Tolerances: ring attention in float32 is held to the reference's ring and
to dense attention within 2e-5 (the reference's own bound), chunked within
1e-5 of unchunked."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.parallel import mesh as jmesh
from seldon_core_tpu.placement import meshes as jmeshes
from seldon_core_tpu.placement.config import PlacementConfig as JPlacement
from seldon_core_tpu_torch import parallel as tparallel
from seldon_core_tpu_torch.parallel import mesh as tmesh
from seldon_core_tpu_torch.placement import meshes as tmeshes
from seldon_core_tpu_torch.placement.config import PlacementConfig as TPlacement

# the packages export ``ring_attention`` the function under the module's name
jring = importlib.import_module("seldon_core_tpu.parallel.ring_attention")
tring = importlib.import_module("seldon_core_tpu_torch.parallel.ring_attention")

# ---- plan_mesh / make_mesh -------------------------------------------------

PLANS = [dict(n_devices=8), dict(n_devices=8, tp=2),
         dict(n_devices=8, tp=2, pp=2), dict(n_devices=1),
         dict(n_devices=1, tp=1, pp=1), dict(n_devices=2),
         dict(n_devices=2, tp=1), dict(n_devices=8, tp=1, pp=1),
         dict(n_devices=6), dict(n_devices=12, max_tp=4)]


@pytest.mark.parametrize("kw", PLANS)
def test_plan_mesh_factorizations_equal(kw):
    assert tmesh.plan_mesh(**kw).axis_sizes() == \
        jmesh.plan_mesh(**kw).axis_sizes()


@pytest.mark.parametrize("kw", [dict(n_devices=0), dict(n_devices=8, tp=0),
                                dict(n_devices=8, pp=0),
                                dict(n_devices=8, pp=3),
                                dict(n_devices=8, tp=3)])
def test_plan_mesh_errors_are_typed_and_worded_alike(kw):
    assert issubclass(tmesh.MeshPlanError, ValueError)
    with pytest.raises(jmesh.MeshPlanError) as je:
        jmesh.plan_mesh(**kw)
    with pytest.raises(tmesh.MeshPlanError) as te:
        tmesh.plan_mesh(**kw)
    assert str(te.value) == str(je.value)


def test_oversubscribed_plan_refused():
    with pytest.raises(jmesh.MeshPlanError):
        jmesh.make_mesh(plan=jmesh.MeshPlan(dp=4), n_devices=2)
    with pytest.raises(tmesh.MeshPlanError):
        tmesh.make_mesh(plan=tmesh.MeshPlan(dp=4), n_devices=2,
                        device="cpu")


def test_parallel_public_exports_importable():
    assert tparallel.__all__ == sorted(tparallel.__all__)
    for name in tparallel.__all__:
        assert getattr(tparallel, name) is not None, name


@pytest.mark.parametrize("kw", [dict(n_devices=8, tp=2, pp=2),
                                dict(n_devices=8, tp=2, pp=1),
                                dict(n_devices=2, tp=2, pp=1)])
def test_make_mesh_axes_equal(kw):
    j = jmesh.make_mesh(**kw)
    t = tmesh.make_mesh(device="cpu", **kw)
    assert t.axis_names == j.axis_names == ("dp", "pp", "tp")
    assert t.shape == dict(j.shape)
    assert t.devices.shape == j.devices.shape
    assert set(t.devices.flat) == {torch.device("cpu")}


def test_make_mesh_default_devices_follow_the_kind_asked_for():
    # an explicit list may repeat a device: two ranks on one device
    m = tmesh.make_mesh(devices=["cpu", "cpu"], tp=2)
    assert m.axis_devices("tp") == [torch.device("cpu")] * 2
    assert m.distinct_devices == [torch.device("cpu")]
    # the card's default devices are the visible ones, refused past them
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(tmesh.MeshPlanError, match="visible"):
        tmesh.make_mesh(n_devices=have + 1, tp=1)


def test_single_axis_mesh():
    j = jmesh.single_axis_mesh("sp", 4)
    t = tmesh.single_axis_mesh("sp", 4, device="cpu")
    assert t.axis_names == j.axis_names and t.shape == dict(j.shape)


# ---- the mesh registry -----------------------------------------------------

def test_mesh_registry_as_the_reference():
    jmeshes.clear()
    tmeshes.clear()
    try:
        jm = jmeshes.mesh_for(JPlacement(enabled=True, dp=2, tp=2))
        tm = tmeshes.mesh_for(TPlacement(enabled=True, dp=2, tp=2),
                              device="cpu")
        # one Mesh per spec per process
        assert tmeshes.mesh_for(TPlacement(enabled=True, dp=2, tp=2),
                                device="cpu") is tm
        assert jmeshes.lookup("dp=2,tp=2") is jm
        assert tmeshes.lookup("dp=2,tp=2", device="cpu") is tm
        assert tmeshes.lookup("dp=2,tp=2") is None  # no card mesh of it
        js, ts = jmeshes.registry_stats(), tmeshes.registry_stats()
        assert ts["dp=2,tp=2@cpu"]["axes"] == js["dp=2,tp=2"]["axes"]
        assert len(ts["dp=2,tp=2@cpu"]["devices"]) == \
            len(js["dp=2,tp=2"]["devices"])
        # more devices than the card has: the typed error, as the
        # reference's past its 8
        with pytest.raises(tmesh.MeshPlanError, match="visible"):
            tmeshes.mesh_for(TPlacement(enabled=True, dp=2,
                                        tp=tmeshes.device_count() + 1))
        with pytest.raises(jmesh.MeshPlanError, match="visible"):
            jmeshes.mesh_for(JPlacement(enabled=True, dp=16))
    finally:
        jmeshes.clear()
        tmeshes.clear()
    assert tmeshes.registry_stats() == {}


# ---- collectives -----------------------------------------------------------

def test_psum_sums_float32_partials_in_rank_order():
    parts = [torch.tensor([1.0, 2.0]).bfloat16(),
             torch.tensor([0.00390625, 3.0]).bfloat16()]
    out = tmesh.psum(parts, dtype=torch.bfloat16)
    assert isinstance(out, tmesh.Shards) and out.dim is None
    want = (parts[0].float() + parts[1].float()).bfloat16()
    assert all(torch.equal(o, want) for o in out)
    f32 = tmesh.psum([torch.ones(3), 2 * torch.ones(3), 3 * torch.ones(3)])
    assert f32[0].dtype == torch.float32 and f32[0].tolist() == [6.0] * 3


def test_all_gather_ppermute_all_to_all():
    parts = [torch.arange(6).reshape(1, 6) + 10 * r for r in range(3)]
    g = tmesh.all_gather(parts, dim=0)
    assert [p.tolist() for p in g] == [torch.cat(parts).tolist()] * 3
    # rank r receives rank r - 1's (the reference ring's perm i -> i + 1)
    shifted = tmesh.ppermute(parts)
    assert [p[0, 0].item() for p in shifted] == [20, 0, 10]
    x = [torch.arange(12).reshape(2, 6) + 100 * r for r in range(2)]
    y = tmesh.all_to_all(x, split_dim=1, concat_dim=0)
    assert torch.equal(y[0], torch.cat([x[0][:, :3], x[1][:, :3]]))
    assert torch.equal(y[1], torch.cat([x[0][:, 3:], x[1][:, 3:]]))
    # the round trip restores each rank's tensor
    back = tmesh.all_to_all(y, split_dim=0, concat_dim=1)
    assert all(torch.equal(a, b) for a, b in zip(back, x))


def test_place_and_unshard():
    m = tmesh.make_mesh(n_devices=2, tp=2, device="cpu")
    w = torch.arange(24.0).reshape(2, 3, 4)
    s = tmesh.place(w, tmesh.named_sharding(m, None, None, "tp"))
    assert s.dim == 2 and [p.shape for p in s] == [(2, 3, 2)] * 2
    assert torch.equal(tmesh.unshard(s), w)
    whole = tmesh.place(w, tmesh.named_sharding(m, None, None, None))
    assert torch.equal(whole, w)
    with pytest.raises(tmesh.MeshPlanError):
        tmesh.place(w, tmesh.named_sharding(m, None, "tp", None))


# ---- ring attention --------------------------------------------------------

def _qkv(B, L, H, D, seed=0, kv_heads=None):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, L, h, D)).astype(np.float32)
            for h in (H, kv_heads or H, kv_heads or H)]
    return (tuple(jnp.asarray(a) for a in arrs),
            tuple(torch.from_numpy(a) for a in arrs))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_dense(causal):
    """The port's ring against the reference's dense attention and its own
    (the reference's ring is held to the same dense attention by its own
    test at this bound; TestRingChunking holds the two rings together)."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 32, 4, 16)
    out = tring.ring_attention_sharded(
        q, k, v, tmesh.single_axis_mesh("sp", 4, device="cpu"), axis="sp",
        causal=causal, batch_axis=None)
    ref = np.asarray(jring.dense_attention(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    dense = tring.dense_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=2e-5)


def test_ring_attention_batch_over_dp():
    (jq, jk, jv), (q, k, v) = _qkv(4, 16, 2, 8, seed=3)
    m = tmesh.make_mesh(n_devices=8, tp=4, device="cpu")  # dp=2, tp=4
    out = tring.ring_attention_sharded(q, k, v, m, axis="tp")
    ref = np.asarray(jring.dense_attention(jq, jk, jv, causal=True))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


class TestRingChunking:
    """kv_chunk bounds the score tile per ring step; the result does not
    depend on it (reference ``tests/test_parallel.py`` TestRingChunking)."""

    def _run(self, kv_chunk, L=32, n=4):
        from jax.sharding import PartitionSpec as P

        (jq, jk, jv), (q, k, v) = _qkv(2, L, 2, 8)
        jm = jmesh.make_mesh(n_devices=8, tp=n, pp=1)
        spec = P(None, "tp", None, None)
        fn = jax.shard_map(
            functools.partial(jring.ring_attention, axis_name="tp",
                              causal=True, kv_chunk=kv_chunk),
            mesh=jm, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False)
        ref = np.asarray(jax.jit(fn)(jq, jk, jv))

        out = self._port(kv_chunk, q, k, v, n)
        return out, ref, (q, k, v)

    @staticmethod
    def _port(kv_chunk, q, k, v, n=4, n_rep=1):
        def split(x):
            return list(torch.chunk(x, n, dim=1))

        out = tring.ring_attention(split(q), split(k), split(v), causal=True,
                                   kv_chunk=kv_chunk, n_rep=n_rep)
        return torch.cat(list(out), dim=1).numpy()

    def test_chunked_matches_unchunked_dense_and_the_reference(self):
        # the reference's unchunked ring, the port's at every chunk size
        full, ref, (q, k, v) = self._run(kv_chunk=None)
        np.testing.assert_allclose(full, ref, atol=2e-5)
        for chunk in (2, 4, 8):  # the local shard is 32 / 4 = 8 keys
            out = self._port(chunk, q, k, v)
            np.testing.assert_allclose(out, full, atol=1e-5, rtol=1e-5)
        dense = tring.dense_attention(q, k, v, causal=True).numpy()
        np.testing.assert_allclose(full, dense, atol=1e-5, rtol=1e-5)

    def test_gqa_blocks_rotate_compact(self):
        """k/v at one head for two query heads rotate compact and expand
        per chunk: equal to dense attention over the expanded K/V."""
        _, (q, k, v) = _qkv(2, 32, 2, 8, kv_heads=1)
        out = self._port(4, q, k, v, n_rep=2)
        dense = tring.dense_attention(q, k.repeat_interleave(2, 2),
                                      v.repeat_interleave(2, 2))
        np.testing.assert_allclose(out, dense.numpy(), atol=1e-5)

    def test_nondividing_chunk_rejected(self):
        with pytest.raises(ValueError, match="divide"):
            tring.ring_attention([torch.zeros(1, 8, 2, 4)] * 2,
                                 [torch.zeros(1, 8, 2, 4)] * 2,
                                 [torch.zeros(1, 8, 2, 4)] * 2, kv_chunk=3)
        with pytest.raises(ValueError, match="divide"):
            self._port(3, *(torch.zeros(2, 32, 2, 8) for _ in range(3)))


# ---- gradients through the ring (the training slice) -----------------------

@pytest.mark.parametrize("kv_chunk", [None, 2])
def test_ring_attention_gradients_match_dense(kv_chunk):
    """``tests/test_parallel.py:92`` and ``:280``: the gradients of a loss
    through the port's ring (4 ranks, unchunked and in chunks of 2 keys)
    against those through dense attention, and against the reference's
    ``jax.grad`` through its ring on 4 of conftest's devices, at the
    reference's 2e-4."""
    from jax.sharding import PartitionSpec as P

    (jq, jk, jv), (q, k, v) = _qkv(2, 16, 2, 8, seed=5)
    w = np.random.default_rng(6).standard_normal((2, 16, 2, 8)).astype(
        np.float32)

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*ts) * torch.from_numpy(w)).sum().backward()
        return [t.grad.numpy() for t in ts]

    def ring(q, k, v):
        split = [torch.chunk(x, 4, dim=1) for x in (q, k, v)]
        out = tring.ring_attention(*[list(s) for s in split], causal=True,
                                   kv_chunk=kv_chunk)
        return torch.cat(list(out), dim=1)

    got = grads(ring)
    dense = grads(lambda q, k, v: tring.dense_attention(q, k, v))
    jm = jmesh.make_mesh(n_devices=8, tp=4, pp=1)
    spec = P(None, "tp", None, None)

    def jloss(q, k, v):
        fn = jax.shard_map(
            functools.partial(jring.ring_attention, axis_name="tp",
                              causal=True, kv_chunk=kv_chunk),
            mesh=jm, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False)
        return (fn(q, k, v) * w).sum()

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jq, jk, jv)
    for g, d, j in zip(got, dense, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, d, atol=2e-4)
        np.testing.assert_allclose(g, np.asarray(j), atol=2e-4)


def test_parallel_exports_cover_the_reference():
    """Every name the reference's ``parallel`` package exports, the port's
    does too (the pipeline and the MoE since the training slice)."""
    from seldon_core_tpu import parallel as jparallel

    assert set(jparallel.__all__) <= set(tparallel.__all__)
