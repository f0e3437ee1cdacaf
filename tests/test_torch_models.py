"""The port's BASELINE models against the JAX package's on the same weights
and inputs: iris, the MNIST MLP, the Mahalanobis outlier detector, ResNet
(float32 and bfloat16, with random BatchNorm statistics) and the int8
ResNet.

Tolerances: float32 paths atol 1e-5 on probabilities (the two frameworks sum
the same terms in another order); bfloat16 paths atol 2e-2 on probabilities
plus equal top-1 ids (each conv output rounds to bf16, about 0.4%, so an
order difference can move a value by one bf16 step, and that compounds
through the layers).  Discrete outputs (ids, outlier scores, folded int8
weights) must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.messages import SeldonMessage as JMessage
from seldon_core_tpu.models import iris as jiris
from seldon_core_tpu.models import mlp as jmlp
from seldon_core_tpu.models import outlier as joutlier
from seldon_core_tpu.models import resnet as jresnet
from seldon_core_tpu.models import resnet_int8 as jint8
from seldon_core_tpu.runtime.component import ComponentHandle as JHandle
from seldon_core_tpu_torch import convert
from seldon_core_tpu_torch.messages import SeldonMessage as TMessage
from seldon_core_tpu_torch.models import iris as tiris
from seldon_core_tpu_torch.models import mlp as tmlp
from seldon_core_tpu_torch.models import outlier as toutlier
from seldon_core_tpu_torch.models import resnet as tresnet
from seldon_core_tpu_torch.models import resnet_int8 as tint8
from seldon_core_tpu_torch.runtime.component import ComponentHandle as THandle

STAGES = (1, 1)   # two bottlenecks: one plain stage, one strided
CLASSES = 16
SIZE = 32         # even: every strided SAME pad is asymmetric


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _both(jh, th, x):
    j = np.asarray(jh.predict(JMessage.from_ndarray(x)).data)
    t = th.predict(TMessage.from_ndarray(x))
    return j, t.host_data(), t


# ---- iris ---------------------------------------------------------------

def test_iris_data_is_the_reference_copy():
    jx, jy = jiris._iris_data()
    tx, ty = tiris._iris_data()
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


def test_iris_training_from_the_reference_init_lands_on_its_params():
    """The port's training loop, started from the reference's jax.random
    init, ends where the reference's does (float32 gradient descent, 200
    steps)."""
    w0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (4, 3),
                                      jnp.float32) * 0.01)
    X, y = tiris._iris_data()
    got = tiris.train_logreg(torch.from_numpy(w0), torch.zeros(3),
                             torch.from_numpy(X), torch.from_numpy(y),
                             200, 0.1)
    ref = _host(jiris.IrisClassifier().params)
    np.testing.assert_allclose(got["w"].numpy(), ref["w"], atol=1e-5)
    np.testing.assert_allclose(got["b"].numpy(), ref["b"], atol=1e-5)


def test_iris_same_params_same_answer():
    jm = jiris.IrisClassifier()
    tm = tiris.IrisClassifier(params=convert.params_from_jax(
        _host(jm.params)), device="cpu")
    X, y = tiris._iris_data()
    j, t, out = _both(JHandle(jm), THandle(tm), X.astype(np.float64))
    np.testing.assert_allclose(t, j, atol=1e-6)
    np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))
    assert out.names == ["setosa", "versicolor", "virginica"]
    assert out.meta.tags == {"model": "iris-logreg"}


def test_iris_seeded_port_model_learns_the_clusters():
    m = tiris.IrisClassifier(device="cpu")
    X, y = tiris._iris_data()
    probs = THandle(m).predict(TMessage.from_ndarray(X)).host_data()
    assert (probs.argmax(-1) == y).mean() > 0.9
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)


# ---- MLP ----------------------------------------------------------------

@pytest.mark.parametrize("cls", ["MNISTMLP", "MNISTMLPClassifier"])
def test_mlp_same_params_same_answer(cls):
    jm = getattr(jmlp, cls)(hidden=64, seed=3)
    tm = getattr(tmlp, cls)(hidden=64, device="cpu",
                            params=convert.params_from_jax(_host(jm.params)))
    x = np.random.default_rng(0).normal(size=(5, 784))  # float64, as JSON
    j, t, out = _both(JHandle(jm), THandle(tm), x)
    if cls == "MNISTMLP":
        np.testing.assert_allclose(t, j, atol=1e-6)
        assert out.names[0] == "class:0"
    else:
        np.testing.assert_array_equal(t, j)
        assert t.dtype == np.int32


def test_mlp_seeded_port_model_shapes():
    m = tmlp.MNISTMLP(hidden=64, seed=0, device="cpu")
    assert [tuple(p["w"].shape) for p in m.params] == [(784, 64), (64, 32),
                                                       (32, 10)]
    probs = THandle(m).predict(TMessage.from_ndarray(np.ones((2, 784))))
    np.testing.assert_allclose(probs.host_data().sum(-1), 1.0, atol=1e-5)
    with pytest.raises(FileNotFoundError, match="not a checkpoint"):
        tmlp.MNISTMLP(model_uri="file:///x", device="cpu")


# ---- outlier detector -----------------------------------------------------

def test_outlier_scores_are_the_reference_scores():
    rng = np.random.default_rng(1)
    jd, td = joutlier.MahalanobisOutlier(warmup=5), \
        toutlier.MahalanobisOutlier(warmup=5)
    batches = [rng.normal(0, 1, (7, 4)), rng.normal(0, 1, (1, 4)),
               np.full((2, 4), 40.0), rng.normal(0, 1, (30, 4)),
               rng.normal(0, 1, 4)]
    for b in batches:
        np.testing.assert_array_equal(td.score(b, []), jd.score(b, []))
        assert td.tags() == jd.tags()


# ---- ResNet -------------------------------------------------------------

def _random_bn(variables, seed: int):
    """Random BN scale, bias, mean and var (var > 0) from a numpy seed: with
    the reference's zero-initialised last-BN scale every bottleneck's c3
    branch would be exactly zero and prove nothing."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for k in sorted(p):
            if "BatchNorm" in k or k == "proj_bn":
                c = p[k]["scale"].shape[0]
                p[k]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                p[k]["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    out = jax.tree.map(lambda a: np.array(a), variables)
    walk(out["params"], out["batch_stats"])
    # spread the head so the logits do not tie
    out["params"]["Dense_0"]["kernel"] = (
        out["params"]["Dense_0"]["kernel"] * 8.0)
    return out


def _serving_cast(variables, dtype):
    """The reference ResNet50Model's storage cast: every param except the
    Dense head in the serving dtype, batch_stats float32."""
    if dtype == jnp.float32:
        return variables
    return {"params": {k: (v if k.startswith("Dense")
                           else jax.tree.map(lambda a: a.astype(dtype), v))
                       for k, v in variables["params"].items()},
            "batch_stats": variables["batch_stats"]}


def _resnets(dtype_name: str, seed: int = 0):
    jdt = jnp.dtype(dtype_name)
    module = jresnet.ResNet(stage_sizes=STAGES, num_classes=CLASSES,
                            dtype=jdt)
    variables = module.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    variables = _serving_cast(_random_bn(variables, seed + 10), jdt)
    tmod = tresnet.ResNet(STAGES, CLASSES, getattr(torch, dtype_name))
    convert.resnet_from_jax(_host(variables), tmod)
    return module, variables, tmod


def _images(n: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("size,k,s,pads", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
    (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)), (32, 7, 2, (2, 3)),
    (7, 3, 2, (1, 1))])
def test_same_pads_are_flax_pads(size, k, s, pads):
    assert tresnet.same_pads(size, k, s) == pads


@pytest.mark.parametrize("size,k,s", [(16, 7, 2), (8, 3, 2), (9, 3, 2),
                                      (8, 3, 1), (8, 1, 2)])
def test_conv_and_pool_same_match_xla(size, k, s):
    """A one-pixel shift (torch's symmetric padding) fails these."""
    rng = np.random.default_rng(size * k + s)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tresnet.conv2d_same(xt, convert._oihw(w), s).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    pref = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), "SAME")
    pool = tresnet.max_pool_same(xt).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(pool.numpy(), np.asarray(pref))


@pytest.mark.parametrize("dtype_name,atol", [("float32", 1e-5),
                                             ("bfloat16", 2e-2)])
def test_resnet_matches_the_reference(dtype_name, atol):
    module, variables, tmod = _resnets(dtype_name)
    x = _images(4)
    ref = np.asarray(module.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, CLASSES)
    np.testing.assert_allclose(got, ref, atol=atol)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_resnet50_model_component_serves_the_module():
    module, variables, tmod = _resnets("float32")
    m = tresnet.ResNet50Model(module=tmod, image_size=SIZE, device="cpu")
    x = _images(2, seed=5)
    out = THandle(m).predict(TMessage.from_ndarray(x.astype(np.float64)))
    ref = np.asarray(module.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(out.host_data(), ref, atol=1e-5)
    assert out.names == [f"class:{i}" for i in range(CLASSES)]
    assert out.meta.tags == {"model": "resnet50", "image_size": SIZE}


def test_seeded_resnet50_is_resnet50():
    m = tresnet.ResNet50Model(device="cpu")
    assert m.module.stage_sizes == (3, 4, 6, 3)
    assert len(m.module.blocks) == 16
    assert m.module.head_w.shape == (2048, 1000)
    assert m.module.stem.weight.dtype == torch.bfloat16
    assert m.module.head_w.dtype == torch.float32
    # the reference's zero-initialised last BN scale
    assert all(float(b.bn2.scale.abs().max()) == 0 for b in m.module.blocks)
    n = sum(p.numel() for p in m.module.parameters())
    assert 25_000_000 < n < 26_000_000
    with pytest.raises(ValueError, match="initContainer"):
        tresnet.ResNet50Model(model_uri="gs://x", device="cpu")


# ---- int8 ResNet ----------------------------------------------------------

def test_int8_convert_params_matches_the_reference():
    """Folding and quantizing the same bf16 weights gives the reference's
    int8 values and scales, up to rsqrt: XLA's and torch's differ by an ulp
    in some channels, the folded kernels then differ by up to ~1e-7
    (relative 1e-6), and a weight that sat on a rounding boundary moves by
    one step (1 of 16384 in c1 of this net; ROADMAP.md Queue 3).  The
    quantization itself is exact on equal inputs (tests/test_torch_ops.py)."""
    module, variables, tmod = _resnets("bfloat16")
    ref = _host(jint8.convert_params(variables))
    got = tint8.convert_params(tmod)

    def same_q(t, r):
        values, scales = r["q"]
        diff = np.abs(t["q"].values.numpy().astype(int) - values)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        np.testing.assert_allclose(t["q"].scales.numpy(), scales, rtol=1e-6)
        np.testing.assert_allclose(t["bias"].numpy(), r["bias"], rtol=1e-6,
                                   atol=1e-6)

    def same_kernel(t, r):
        np.testing.assert_allclose(t["kernel"].permute(2, 3, 1, 0).numpy(),
                                   r["kernel"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(t["bias"].numpy(), r["bias"], rtol=1e-6,
                                   atol=1e-6)

    same_kernel(got["stem"], ref["stem"])
    for t, r in zip(got["blocks"], ref["blocks"], strict=True):
        assert t.keys() == r.keys()
        same_q(t["c1"], r["c1"])
        same_kernel(t["c2"], r["c2"])
        same_q(t["c3"], r["c3"])
        if "proj" in r:
            same_q(t["proj"], r["proj"])
    same_q(got["head"], ref["head"])


@pytest.mark.parametrize("dtype_name,atol", [("float32", 1e-5),
                                             ("bfloat16", 2e-2)])
def test_int8_forward_matches_the_reference(dtype_name, atol):
    """The port's ``forward`` on the reference's folded int8 weights
    against the reference's ``forward`` (its int8 matmul as its own CPU
    tests run it: interpret mode where the shape tiles, else its
    fallback)."""
    module, variables, _ = _resnets("bfloat16")
    ref_w = jint8.convert_params(variables)
    x = _images(4, seed=2)
    jdt = jnp.dtype(dtype_name)
    ref = np.asarray(jint8.forward(ref_w, jnp.asarray(x), dtype=jdt,
                                   stage_sizes=STAGES))
    tw = convert.resnet_int8_from_jax(_host(ref_w))
    got = tint8.forward(tw, torch.from_numpy(x),
                        dtype=getattr(torch, dtype_name),
                        stage_sizes=STAGES).numpy()
    np.testing.assert_allclose(got, ref, atol=atol)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_int8_model_serves_the_float_models_classes():
    module, variables, tmod = _resnets("bfloat16")
    src = tresnet.ResNet50Model(module=tmod, image_size=SIZE, device="cpu")
    m = tint8.Int8ResNet50Model(source=src, image_size=SIZE, device="cpu")
    x = _images(8, seed=3)
    q = THandle(m).predict(TMessage.from_ndarray(x)).host_data()
    f = THandle(src).predict(TMessage.from_ndarray(x)).host_data()
    assert q.shape == f.shape == (8, CLASSES)
    np.testing.assert_allclose(q.sum(-1), 1.0, atol=1e-5)
    assert (q.argmax(-1) == f.argmax(-1)).mean() >= 0.75
    assert m.stage_sizes == STAGES
