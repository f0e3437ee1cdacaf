"""The port's dynamic batcher: bucketing and padding as the reference's
(the same request patterns make the same batches), row splitting, lanes,
pad rows that never change a real row's answer, and backpressure (429 when
the queue is full, 504 when a request waits too long, the in-flight cap)."""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from seldon_core_tpu.runtime import batcher as jbatcher
from seldon_core_tpu_torch.messages import SeldonMessage
from seldon_core_tpu_torch.models import mlp as tmlp
from seldon_core_tpu_torch.runtime.batcher import (
    BatchedModel,
    BatcherConfig,
    DeadlineExceededError,
    DynamicBatcher,
    QueueFullError,
    _Pending,
    default_buckets,
)
from seldon_core_tpu_torch.runtime.component import ComponentHandle


@pytest.mark.parametrize("n", [1, 2, 48, 64, 100, 256])
def test_default_buckets_match_the_reference(n):
    assert default_buckets(n) == jbatcher.default_buckets(n)


@pytest.mark.parametrize("rows", [
    [1, 1, 1, 1], [1, 1, 1], [3, 2, 1], [5], [2, 7, 1], [4, 4, 4, 4, 1],
    [9],
], ids=lambda r: "-".join(map(str, r)))
def test_same_requests_make_the_reference_batches(rows):
    """Concurrent requests of these row counts go out in the same batches
    (shapes, padding) and come back split the same way."""
    def run(mod, with_aux):
        shapes = []

        def fn(batch):
            shapes.append(np.shape(batch))
            out = np.asarray(batch) * 2.0
            return (out, "aux") if with_aux else out

        b = mod.DynamicBatcher(fn, mod.BatcherConfig(max_batch_size=8,
                                                     max_delay_ms=20.0))

        async def main():
            return await asyncio.gather(*(
                b(np.full((n, 3), i, np.float32)) for i, n in enumerate(rows)))

        return shapes, asyncio.run(main())

    jshapes, jouts = run(jbatcher, False)
    tshapes, touts = run(__import__(
        "seldon_core_tpu_torch.runtime.batcher", fromlist=["x"]), True)
    assert tshapes == jshapes
    for (t, aux), j in zip(touts, jouts):
        assert aux == "aux"
        np.testing.assert_array_equal(t, np.asarray(j))


def test_full_batch_flushes_immediately():
    calls = []

    def fn(batch):
        calls.append(batch.shape[0])
        return batch, None

    b = DynamicBatcher(fn, BatcherConfig(max_batch_size=4,
                                         max_delay_ms=10_000.0))

    async def main():
        return await asyncio.gather(*(b(np.ones((1, 2))) for _ in range(4)))

    asyncio.run(main())  # would wait 10 s if the size trigger did not fire
    assert calls == [4]
    assert b.stats == {"batches": 1, "rows": 4, "pad_rows": 0, "shed": 0}


def test_shape_lanes_are_independent():
    calls = []

    def fn(batch):
        calls.append(batch.shape)
        return batch, None

    b = DynamicBatcher(fn, BatcherConfig(max_batch_size=8, max_delay_ms=5.0))

    async def main():
        return await asyncio.gather(b(np.ones((1, 2))), b(np.ones((1, 3))),
                                    b(np.ones((1, 2), np.float32)))

    (a, _), (c, _), (d, _) = asyncio.run(main())
    assert sorted(calls) == [(1, 2), (1, 2), (1, 3)]
    assert a.shape == (1, 2) and c.shape == (1, 3) and d.dtype == np.float32


def test_error_propagates_to_all_waiters():
    def fn(batch):
        raise RuntimeError("device fell over")

    b = DynamicBatcher(fn, BatcherConfig(max_batch_size=4, max_delay_ms=2.0))

    async def main():
        return await asyncio.gather(*(b(np.ones((1, 1))) for _ in range(3)),
                                    return_exceptions=True)

    res = asyncio.run(main())
    assert all(isinstance(r, RuntimeError) for r in res)


def test_tensor_requests_batch_as_tensors_and_materialize():
    """Tensors are padded with torch where they lie; host mode hands back
    numpy rows (one copy per batch), device mode tensor slices."""
    seen = []

    def fn(batch):
        seen.append(type(batch))
        return batch * 3.0, len(seen)

    for mode, want in (("host", np.ndarray), ("device", torch.Tensor)):
        b = DynamicBatcher(fn, BatcherConfig(max_batch_size=4,
                                             max_delay_ms=2.0,
                                             materialize=mode))

        async def main():
            return await asyncio.gather(*(b(torch.full((1, 2), float(i)))
                                          for i in range(3)))

        outs = asyncio.run(main())
        for i, (o, aux) in enumerate(outs):
            assert isinstance(o, want) and aux == len(seen)
            np.testing.assert_array_equal(np.asarray(o), [[3.0 * i] * 2])
        assert b.stats["pad_rows"] == 1  # 3 rows in bucket 4
    assert seen == [torch.Tensor, torch.Tensor]


def test_oversized_request_runs_alone():
    calls = []

    def fn(batch):
        calls.append(batch.shape[0])
        return torch.as_tensor(batch) + 1, "alone"

    b = DynamicBatcher(fn, BatcherConfig(max_batch_size=4, max_delay_ms=1.0))
    out, aux = asyncio.run(b(np.zeros((9, 2))))
    assert calls == [9] and isinstance(out, np.ndarray) and out.shape == (9, 2)
    assert aux == "alone"


@pytest.mark.parametrize("n_rows", [1, 3, 5])
def test_pad_rows_do_not_change_a_real_rows_answer(n_rows):
    """A batched MLP answers each row as it answers that row alone: the pad
    rows sit past the real ones and every row is computed independently."""
    m = tmlp.MNISTMLP(hidden=64, seed=1, device="cpu")
    handle = ComponentHandle(m, name="mnist")
    bm = BatchedModel(handle, BatcherConfig(max_batch_size=8,
                                            max_delay_ms=20.0))
    x = np.random.default_rng(n_rows).normal(size=(n_rows + 2, 784))

    async def main():
        return await asyncio.gather(
            bm.predict(SeldonMessage.from_ndarray(x[:n_rows])),
            bm.predict(SeldonMessage.from_ndarray(x[n_rows:])))

    a, b = asyncio.run(main())
    alone = handle.predict(SeldonMessage.from_ndarray(x)).host_data()
    np.testing.assert_allclose(a.host_data(), alone[:n_rows], atol=1e-6)
    np.testing.assert_allclose(b.host_data(), alone[n_rows:], atol=1e-6)
    np.testing.assert_array_equal(
        np.concatenate([a.host_data(), b.host_data()]).argmax(-1),
        alone.argmax(-1))
    assert bm._batcher.stats["pad_rows"] == {3: 1, 5: 3, 7: 1}[n_rows + 2]


def test_batched_model_meta_names_and_bypass():
    class M:
        class_names = ["a", "b"]

        def predict(self, X, names):
            return np.asarray(X) + 1.0

        def tags(self):
            return {"m": 1}

    bm = BatchedModel(ComponentHandle(M(), name="m"),
                      BatcherConfig(max_batch_size=4, max_delay_ms=5.0))

    async def main():
        return await asyncio.gather(*(bm.predict(SeldonMessage.from_ndarray(
            np.zeros((1, 2)))) for _ in range(3)))

    for o in asyncio.run(main()):
        np.testing.assert_array_equal(o.host_data(), [[1.0, 1.0]])
        assert o.meta.tags == {"m": 1} and o.names == ["a", "b"]
    assert bm._batcher.stats["batches"] == 1
    assert bm.has("predict") and not bm.has("route")


def test_batched_model_config_not_mutated_and_bad_config_rejected():
    cfg = BatcherConfig(max_batch_size=48, name="shared")
    bm = BatchedModel(ComponentHandle(tmlp.MNISTMLP(hidden=8, device="cpu"),
                                      name="m1"), cfg)
    assert cfg.name == "shared" and bm._batcher.config.name == "m1"
    assert bm._batcher.buckets == [1, 2, 4, 8, 16, 32, 48]
    with pytest.raises(ValueError, match="materialize"):
        DynamicBatcher(lambda b: (b, None), BatcherConfig(materialize="disk"))


class _SlowFetch:
    """An output whose host copy takes a while (a card still computing)."""

    def __init__(self, arr, hook=None):
        self.arr = arr
        self.hook = hook

    def __array__(self, dtype=None, copy=None):
        if self.hook:
            self.hook()
        time.sleep(0.01)
        return self.arr


def test_queue_full_sheds_with_429():
    b = DynamicBatcher(lambda batch: (_SlowFetch(np.asarray(batch)), None),
                       BatcherConfig(max_batch_size=2, max_delay_ms=1.0,
                                     max_queue_rows=4, max_inflight=1))

    async def main():
        return await asyncio.gather(*(b(np.ones((1, 1))) for _ in range(40)),
                                    return_exceptions=True)

    res = asyncio.run(main())
    shed = [r for r in res if isinstance(r, QueueFullError)]
    ok = [r for r in res if not isinstance(r, Exception)]
    assert shed and ok
    assert shed[0].status_code == 429 and shed[0].reason == "QUEUE_FULL"
    assert b.stats["shed"] == len(shed)


def test_deadline_shed_at_flush():
    # the stale request waited 10 s; the fresh one only the flush delay,
    # far below the limit even on a loaded host
    b = DynamicBatcher(lambda batch: (batch, None),
                       BatcherConfig(max_batch_size=8, max_delay_ms=1.0,
                                     shed_after_ms=1000.0, max_queue_rows=0))

    async def main():
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        task = asyncio.ensure_future(b(np.ones((1, 1))))
        await asyncio.sleep(0)  # the lane exists now
        lane = next(iter(b._lanes.values()))
        lane.pending.insert(0, _Pending(np.ones((1, 1)), 1, fut,
                                        t_enqueue=loop.time() - 10.0))
        lane.pending_rows += 1
        return fut, await task

    fut, fresh = asyncio.run(main())
    assert isinstance(fut.exception(), DeadlineExceededError)
    assert fut.exception().status_code == 504
    assert fresh[0].shape == (1, 1)


def test_inflight_cap_defers_flushes():
    inflight, peak = [0], [0]
    lock = threading.Lock()

    def enter():
        with lock:
            inflight[0] += 1
            peak[0] = max(peak[0], inflight[0])

    class Tracked(_SlowFetch):
        def __array__(self, dtype=None, copy=None):
            out = super().__array__(dtype)
            with lock:
                inflight[0] -= 1
            return out

    b = DynamicBatcher(lambda batch: (Tracked(np.asarray(batch), enter),
                                      None),
                       BatcherConfig(max_batch_size=2, max_delay_ms=0.5,
                                     max_inflight=2, max_queue_rows=0))

    async def main():
        return await asyncio.gather(*(b(np.ones((1, 1))) for _ in range(32)))

    assert len(asyncio.run(main())) == 32
    assert peak[0] <= 2


def test_lane_eviction_bounds_memory():
    b = DynamicBatcher(lambda batch: (batch, None),
                       BatcherConfig(max_batch_size=2, max_delay_ms=1.0))
    b.max_lanes = 4

    async def main():
        for w in range(10):
            await b(np.ones((1, w + 1)))

    asyncio.run(main())
    assert len(b._lanes) <= 4


def test_warmup_runs_every_bucket_once():
    calls = []

    def fn(batch):
        calls.append(batch.shape)
        return torch.as_tensor(batch) * 2, None

    b = DynamicBatcher(fn, BatcherConfig(max_batch_size=8))
    b.warmup(np.ones((3,)))
    assert calls == [(1, 3), (2, 3), (4, 3), (8, 3)]
    bm = BatchedModel(ComponentHandle(tmlp.MNISTMLP(hidden=8, device="cpu"),
                                      name="m"), BatcherConfig(max_batch_size=4))
    bm.warmup(np.zeros(784))
    assert bm._batcher.stats["batches"] == 0  # warm-up is not traffic


class _RowStub:
    """A MODEL component that records the batches it is given."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.input_shape = (3,)
        self.seen = []

    def predict(self, X, names):
        self.seen.append(np.shape(X))
        return np.asarray(X) + 1.0


@pytest.mark.parametrize("device,warmed", [("cuda", True), ("cpu", False)])
def test_runner_warms_batched_models_on_the_card(monkeypatch, device, warmed):
    """The local runner runs every bucket of a batched model that states its
    ``input_shape`` once at boot when the model lies on the card; warm-up
    is not traffic.  On the CPU there is nothing to warm."""
    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.operator import local

    stub = _RowStub(device)
    monkeypatch.setattr(local, "load_component",
                        lambda *a, **k: ComponentHandle(stub))

    def boot(ann):
        node = {"name": "m", "type": "MODEL", "parameters": [
            {"name": "model_class", "value": "x:Y", "type": "STRING"}]}
        dep = {"metadata": {"name": "w", "annotations": ann},
               "spec": {"predictors": [{"name": "p", "graph": node}]}}
        # the stub states its own device; the runner's is the CPU
        return local.LocalDeployment(load_deployment(dep),
                                     device="cpu").engine.node_impl("m")

    bm = boot({"seldon.io/batch-max-size": "4"})
    assert isinstance(bm, BatchedModel)
    assert stub.seen == ([(1, 3), (2, 3), (4, 3)] if warmed else [])
    assert bm._batcher.stats["batches"] == 0
    no_batch = boot({"seldon.io/batching": "false"})
    assert isinstance(no_batch, ComponentHandle)
    assert len(stub.seen) == (3 if warmed else 0)
