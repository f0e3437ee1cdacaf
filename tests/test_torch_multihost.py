"""The port's multi-host slice (``runtime/multihost.py`` on
``torch.distributed``, ``parallel/mesh.py`` ``process_mesh``) against the
reference's ``seldon_core_tpu/runtime/multihost.py`` on the CPU.

- the env contract: the same environments give the same results in both
  packages (no-op single-host, the join's keyword values, the
  half-configured raise);
- ``_statefulset_env_names`` through the port's operator;
- every collective over 4 ranks in 2 gloo processes (2 ranks each) is
  bitwise EQUAL to the single-controller function on the same seeded numpy
  inputs, in bfloat16 and float32;
- ``run_multihost_dryrun(n_hosts=2, devices_per_host=2)`` on the
  reference's converted params and prompts: its tokens EQUAL the
  reference's ``generate``, its ``paged_requests``, ``spec_rounds`` and
  ``pinned_pages`` EQUAL the reference's own ``run_multihost_dryrun`` at the
  same size (run beside it), its two summary lines the reference's letter
  for letter, and one sampled request draws the same ids in both processes;
- ``engine_main`` joins the slice before it serves;
- the placement plane's sharded segments refuse a mesh whose ranks span
  processes, by name (training, the MoE, the pipeline and ring attention
  run across processes: ``tests/test_torch_multihost_train.py``).

Every spawning test runs its processes under a deadline of its own on free
ports; the pytest process never joins a process group.  Run this file as a
script with ``--collectives-worker`` to get one collectives worker.
"""

import asyncio
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from seldon_core_tpu.runtime import multihost as J
from seldon_core_tpu_torch.operator import compile as pcompile
from seldon_core_tpu_torch.parallel import mesh as M
from seldon_core_tpu_torch.runtime import multihost as T

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 120.0
ENV_NAMES = (T.ENV_NUM_HOSTS, T.ENV_WORKER_ID, T.ENV_COORDINATOR)

# ----------------------------------------------------------------------
# the env contract
# ----------------------------------------------------------------------

CONTRACT_CASES = {
    "unset": {},
    "one_host": {T.ENV_NUM_HOSTS: "1", T.ENV_WORKER_ID: "0"},
    "join_worker_1": {T.ENV_NUM_HOSTS: "2", T.ENV_WORKER_ID: "1",
                      T.ENV_COORDINATOR: "mh-0.mh.ns.svc:8476"},
    "join_worker_0_of_4": {T.ENV_NUM_HOSTS: "4", T.ENV_WORKER_ID: "0",
                           T.ENV_COORDINATOR: "10.0.0.7:8476"},
    "half_no_worker": {T.ENV_NUM_HOSTS: "2",
                       T.ENV_COORDINATOR: "mh-0.mh.ns.svc:8476"},
    "half_no_coordinator": {T.ENV_NUM_HOSTS: "3", T.ENV_WORKER_ID: "2"},
}


def _outcome(mod):
    calls = []
    try:
        joined = mod.maybe_initialize_distributed(
            initialize=lambda **kw: calls.append(kw))
        return {"joined": joined, "calls": calls, "env": mod.multihost_env()}
    except RuntimeError as e:
        return {"raised": str(e), "calls": calls}


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_env_contract_equals_the_reference(case, monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    for name, value in CONTRACT_CASES[case].items():
        monkeypatch.setenv(name, value)
    port, ref = _outcome(T), _outcome(J)
    assert port == ref
    if case.startswith("join"):
        assert port["calls"] == [port["env"]] and port["joined"] is True
    elif case.startswith("half"):
        assert "StatefulSet" in port["raised"] and port["calls"] == []
    else:
        assert port == {"joined": False, "calls": [], "env": None}


def test_contract_names_are_the_reference_names_defined_once():
    assert (T.ENV_NUM_HOSTS, T.ENV_WORKER_ID, T.ENV_COORDINATOR,
            T.COORDINATOR_PORT) == (J.ENV_NUM_HOSTS, J.ENV_WORKER_ID,
                                    J.ENV_COORDINATOR, J.COORDINATOR_PORT)
    # the operator writes the names it imports from the runtime module
    for name in ("ENV_NUM_HOSTS", "ENV_WORKER_ID", "ENV_COORDINATOR",
                 "COORDINATOR_PORT"):
        assert getattr(pcompile, name) is getattr(T, name)
    src = (ROOT / "seldon_core_tpu_torch" / "operator" / "compile.py"
           ).read_text()
    assert '= "NUM_TPU_HOSTS"' not in src and "= 8476" not in src


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_statefulset_env_names_through_the_ports_compile(n_hosts):
    T._statefulset_env_names(n_hosts)


def test_statefulset_env_names_catch_drift(monkeypatch):
    monkeypatch.setattr(pcompile, "COORDINATOR_PORT", 1234)
    with pytest.raises(AssertionError):
        T._statefulset_env_names(2)


# ----------------------------------------------------------------------
# the collectives across two processes
# ----------------------------------------------------------------------

N_RANKS, PER_PROCESS = 4, 2
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
COLLECTIVES = ("psum", "psum_scatter", "all_gather", "ppermute",
               "all_to_all", "unshard")


def _inputs(dtype) -> list:
    rng = np.random.default_rng(11)
    return [torch.from_numpy(rng.standard_normal((2, 8, 6)).astype(
        np.float32)).to(dtype) for _ in range(N_RANKS)]


def _collectives(parts: list) -> dict:
    """Every collective of ``parts`` (None at other processes' ranks): per
    collective, one tensor per rank (None where not held)."""
    return {
        "psum": list(M.psum(parts)),
        "psum_scatter": M.psum_scatter(parts, dim=1),
        "all_gather": list(M.all_gather(parts, dim=2)),
        "ppermute": M.ppermute(parts),
        "all_to_all": M.all_to_all(parts, split_dim=1, concat_dim=2),
        "unshard": [None if p is None else whole for p, whole in zip(
            parts, [M.unshard(M.Shards(parts, 0))] * len(parts))],
    }


def _bytes(t) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def collectives_worker(out_path: str) -> None:
    """One of the two processes: join through the env contract, build the
    global mesh of 2 CPU ranks a process, run every collective on this
    process's ranks of the seeded inputs, and save each result's bytes."""
    import torch.distributed as dist

    assert T.maybe_initialize_distributed()
    mesh = M.process_mesh(["cpu"] * PER_PROCESS)
    me = dist.get_rank()
    held = [r for r, d in enumerate(mesh.devices.flat) if d is not None]
    assert held == [me * PER_PROCESS + j for j in range(PER_PROCESS)]
    assert mesh.spans_processes and mesh.n_processes == 2
    out = {"held": np.asarray(held)}
    for name, dtype in DTYPES.items():
        parts = [p if r in held else None
                 for r, p in enumerate(_inputs(dtype))]
        for coll, per_rank in _collectives(parts).items():
            for r, t in enumerate(per_rank):
                assert (t is None) == (r not in held), (coll, r)
                if t is not None:
                    out[f"{name}/{coll}/{r}"] = _bytes(t)
    np.savez(out_path, **out)
    dist.destroy_process_group()


def _spawn_pair(args: list, tmp_path) -> list:
    """Two processes of this file under the env contract, on a free port;
    both killed past the deadline.  Returns their logs."""
    from seldon_core_tpu_torch.serving.workers import pick_free_port

    port = pick_free_port()
    procs = []
    for i in range(2):
        env = {**os.environ, T.ENV_NUM_HOSTS: "2", T.ENV_WORKER_ID: str(i),
               T.ENV_COORDINATOR: f"127.0.0.1:{port}",
               "PYTHONPATH": str(ROOT)}
        procs.append(subprocess.Popen(
            [sys.executable, __file__, *args, str(tmp_path / f"w{i}.npz")],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=DEADLINE_S)
            logs.append(out)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


@pytest.fixture(scope="module")
def across(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    _spawn_pair(["--collectives-worker"], tmp)
    out = {}
    for i in range(2):
        with np.load(tmp / f"w{i}.npz") as z:
            out.update({k: z[k] for k in z.files if k != "held"})
    return out


@pytest.mark.parametrize("coll", COLLECTIVES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_collective_across_processes_equals_the_single_controller(
        across, coll, dtype):
    single = _collectives(_inputs(DTYPES[dtype]))[coll]
    for r, t in enumerate(single):
        got = across[f"{dtype}/{coll}/{r}"]
        assert np.array_equal(got, _bytes(t)), (coll, dtype, r)


def test_a_mesh_that_spans_processes_without_a_group():
    mesh = M.make_mesh(devices=["cpu", "cpu", None, None], tp=4)
    assert mesh.spans_processes and mesh.n_processes == 2
    assert mesh.distinct_devices == [torch.device("cpu")]
    x = torch.arange(16.0).reshape(4, 4)
    placed = M.place(x, M.named_sharding(mesh, None, "tp"))
    assert [p is None for p in placed] == [False, False, True, True]
    assert torch.equal(placed[1], x[:, 1:2])
    whole = M.place(x, M.named_sharding(mesh, None, None))
    assert torch.equal(whole, x)
    assert M.rank_map(lambda r, d: r, mesh.axis_devices("tp")) == [
        0, 1, None, None]
    assert not M.make_mesh(devices=["cpu"] * 4, tp=4).spans_processes


# ----------------------------------------------------------------------
# refusals: the placement plane's sharded segments stay in one process
# ----------------------------------------------------------------------

def _refusals():
    from seldon_core_tpu_torch.graph.plan import FusedSegment
    from seldon_core_tpu_torch.placement.config import PlacementConfig
    from seldon_core_tpu_torch.placement.plane import PlacementPlane

    return {
        "placement_plane": lambda m: PlacementPlane(
            PlacementConfig(enabled=True, tp=4), mesh=m),
        # the refusal comes first: no segment is needed to reach it
        "enable_sharding": lambda m: FusedSegment.enable_sharding(None, m),
    }


@pytest.mark.parametrize("what", sorted(_refusals()))
def test_a_process_spanning_mesh_is_refused_by_name(what):
    spanning = M.make_mesh(devices=["cpu", "cpu", None, None], tp=4)
    with pytest.raises(M.MeshPlanError, match="span processes"):
        _refusals()[what](spanning)


# ----------------------------------------------------------------------
# engine_main joins before it serves
# ----------------------------------------------------------------------

def test_engine_main_joins_the_slice_before_serving(monkeypatch):
    import torch.distributed as dist

    from seldon_core_tpu_torch.operator import local

    events = []
    monkeypatch.setenv(T.ENV_NUM_HOSTS, "2")
    monkeypatch.setenv(T.ENV_WORKER_ID, "1")
    monkeypatch.setenv(T.ENV_COORDINATOR, "mh-0.mh.ns.svc:8476")
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: events.append(("join", a, kw)))

    class Served(Exception):
        pass

    async def serve(*a, **kw):
        events.append(("serve",))
        raise Served

    monkeypatch.setattr(local, "serve", serve)
    graph = str(ROOT / "seldon_core_tpu_torch" / "examples" / "iris.json")
    with pytest.raises(Served):
        local.engine_main(["--graph", graph, "--device", "cpu",
                           "--grpc-port", "0"])
    assert [e[0] for e in events] == ["join", "serve"]
    _, args, kw = events[0]
    assert args == ("gloo",)
    assert kw["init_method"] == "tcp://mh-0.mh.ns.svc:8476"
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert kw["timeout"].total_seconds() == T.JOIN_TIMEOUT_S


def test_engine_main_single_host_never_joins(monkeypatch):
    import torch.distributed as dist

    from seldon_core_tpu_torch.operator import local

    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    events = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: events.append("join"))

    async def serve(*a, **kw):
        events.append("serve")
        raise KeyboardInterrupt

    monkeypatch.setattr(local, "serve", serve)
    graph = str(ROOT / "seldon_core_tpu_torch" / "examples" / "iris.json")
    with pytest.raises(KeyboardInterrupt):
        local.engine_main(["--graph", graph, "--device", "cpu",
                           "--grpc-port", "0"])
    assert events == ["serve"]


# ----------------------------------------------------------------------
# the dryrun on the reference's weights, beside the reference's own
# ----------------------------------------------------------------------

def _reference_inputs(n_ranks: int):
    """The reference worker's params and prompts (``multihost.py``
    :299-329), drawn by jax as it draws them."""
    import jax
    import jax.numpy as jnp

    from seldon_core_tpu.models.transformer import (
        TransformerConfig,
        init_params,
    )

    cfg = TransformerConfig(vocab_size=64, d_model=64, n_layers=2,
                            n_heads=n_ranks, d_ff=128, max_seq=64,
                            dtype=jnp.float32)
    dcfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1,
                             n_heads=n_ranks, d_ff=64, max_seq=64,
                             dtype=jnp.float32)
    params = init_params(jax.random.PRNGKey(0), cfg)
    dparams = init_params(jax.random.PRNGKey(9), dcfg)
    prompts = {
        "prompt": jax.random.randint(jax.random.PRNGKey(1), (1, 4), 0, 64),
        "prefix": jax.random.randint(jax.random.PRNGKey(2), (16,), 0, 64),
        "suffix": jax.random.randint(jax.random.PRNGKey(3), (1, 6), 0, 64),
        "long_prompt": jax.random.randint(jax.random.PRNGKey(4), (1, 44), 0,
                                          64),
    }
    return cfg, params, dparams, {k: np.asarray(v) for k, v in
                                  prompts.items()}


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    """The port's dryrun on the reference's weights and the reference's own
    dryrun, side by side (threads: both wait on their processes)."""
    import jax

    from seldon_core_tpu.models.transformer import generate as jgenerate
    from seldon_core_tpu_torch.convert import params_from_jax

    cfg, params, dparams, prompts = _reference_inputs(4)
    path = T.write_dryrun_inputs(
        str(tmp_path_factory.mktemp("mh") / "inputs.npz"),
        params_from_jax(params), params_from_jax(dparams), prompts)
    ref: dict = {}

    def reference():
        try:
            ref["r"] = J.run_multihost_dryrun(n_hosts=2, devices_per_host=2,
                                              timeout=DEADLINE_S)
        except BaseException as e:  # reported in the test thread
            ref["error"] = e

    th = threading.Thread(target=reference)
    th.start()
    try:
        port = T.run_multihost_dryrun(n_hosts=2, devices_per_host=2,
                                      timeout=DEADLINE_S, device="cpu",
                                      params=path)
        aliased = np.concatenate([prompts["prefix"][None, :],
                                  prompts["suffix"]], axis=1)
        ref_ids = {
            "tokens": np.asarray(jgenerate(params, prompts["prompt"], 5,
                                           cfg)).tolist(),
            "paged": [np.asarray(jgenerate(params, p, n, cfg)).tolist()
                      for p, n in ((aliased, 5), (aliased, 7),
                                   (prompts["long_prompt"], 4))],
        }
        jax.clear_caches()
    finally:
        th.join(DEADLINE_S)
    if "error" in ref:
        raise ref["error"]
    return port, ref["r"], ref_ids


def test_dryrun_tokens_equal_the_references_generate(dryruns):
    port, ref, ref_ids = dryruns
    assert port["tokens"] == ref_ids["tokens"] == np.asarray(
        ref["tokens"]).tolist()
    assert port["n_hosts"] == 2 and port["global_devices"] == 4


def test_dryrun_paged_tokens_equal_the_references_generate(dryruns):
    port, _, ref_ids = dryruns
    # the workers assert their paged ids equal in both processes and to
    # their own plain decode; the reference's generate gives the same
    assert port["paged_requests"] == 3
    assert port["paged_tokens"] == ref_ids["paged"]


@pytest.mark.parametrize("key", ["paged_requests", "spec_rounds",
                                 "pinned_pages", "global_devices"])
def test_dryrun_counts_equal_the_references_dryrun(dryruns, key):
    port, ref, _ = dryruns
    assert port[key] == ref[key]


def test_dryrun_lines_are_the_references_letter_for_letter(dryruns):
    from seldon_core_tpu_torch.dryrun import multihost_lines

    port, ref, _ = dryruns
    assert multihost_lines(port) == multihost_lines(ref)
    # the format against the reference's own record at 8 devices
    recorded = json.loads((ROOT / "MULTICHIP_r05.json").read_text())["tail"]
    lines = [ln.split("dryrun_multichip OK: ", 1)[1]
             for ln in recorded.splitlines() if "multihost" in ln]
    assert lines == multihost_lines({"global_devices": 8,
                                     "paged_requests": 3, "spec_rounds": 13,
                                     "pinned_pages": 4})


def test_dryrun_fleet_membership(dryruns):
    port, ref, _ = dryruns
    assert port["fleet"]["healthy"] == ref["fleet"]["healthy"] == 2
    assert [r["state"] for r in port["fleet"]["replicas"]] == ["healthy"] * 2


def test_a_sampled_request_draws_the_same_ids_in_both_processes(dryruns):
    port, _, _ = dryruns
    sampled, greedy = port["sampled_tokens"], port["tokens"]
    # run_multihost_dryrun asserts both processes' ids EQUAL; the request
    # did sample (a greedy decode would repeat the greedy ids)
    assert len(sampled[0]) == len(greedy[0]) == 9
    assert sampled[0][:4] == greedy[0][:4] and sampled != greedy


if __name__ == "__main__":
    if sys.argv[1] == "--collectives-worker":
        collectives_worker(sys.argv[2])
