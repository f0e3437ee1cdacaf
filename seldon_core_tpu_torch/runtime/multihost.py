"""Multi-host slice bring-up: ``torch.distributed`` from the operator's env
(port of ``seldon_core_tpu/runtime/multihost.py``).

The operator compiles a multi-host predictor to one StatefulSet per slice
replica (``operator/compile.py``): every pod gets

- ``TPU_WORKER_ID``           - the pod ordinal (apps.kubernetes.io/pod-index)
- ``NUM_TPU_HOSTS``           - hosts in the slice
- ``TPU_COORDINATOR_ADDRESS`` - worker 0's stable DNS name under the
  StatefulSet's headless service, port 8476

The engine pod's entry point (``operator/local.py`` ``engine_main``) calls
:func:`maybe_initialize_distributed` before anything touches the card, so
every host joins one gloo process group: worker ``i`` is rank ``i`` and
worker 0 hosts the group's store at the coordinator address.  A mesh over
the group (``parallel/mesh.py`` ``process_mesh``) then spans the hosts,
its ranks in process order, and tensor-parallel serving runs over it: each
process computes its own ranks and the collectives cross processes through
host memory (the names keep the reference's TPU wording, so both packages
read the same manifests).

:func:`run_multihost_dryrun` proves the path: OS processes join through the
env the real operator compiles, and an ``LLMEngine`` and a
``PagedLLMEngine`` serve with tp spanning the process boundary.
:func:`run_multihost_training` runs the reference's training dryrun plans
the same way, over a mesh whose dp, pp and tp axes may each cross the
boundary (``process_mesh(..., plan=)``), and every process prints the
plans' lines.  Run them::

    python -m seldon_core_tpu_torch.runtime.multihost [--device cpu]
        [--hosts 2] [--devices-per-host 4] [--mode serve|train]

On one card every process's ranks share it (``cuda:0``) over gloo: the
NCCL backend refuses two ranks of one communicator on one card.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = [
    "ENV_NUM_HOSTS",
    "ENV_WORKER_ID",
    "ENV_COORDINATOR",
    "COORDINATOR_PORT",
    "JOIN_TIMEOUT_S",
    "multihost_env",
    "maybe_initialize_distributed",
    "run_multihost_dryrun",
    "run_multihost_training",
    "write_dryrun_inputs",
    "write_training_inputs",
]

# The operator/runtime env contract, defined ONCE here: operator/compile.py
# writes these names into the StatefulSet manifest and this module parses
# them back, so the contract cannot drift silently.
ENV_NUM_HOSTS = "NUM_TPU_HOSTS"
ENV_WORKER_ID = "TPU_WORKER_ID"
ENV_COORDINATOR = "TPU_COORDINATOR_ADDRESS"
COORDINATOR_PORT = 8476

#: how long the join, and then each collective, may wait for the others
JOIN_TIMEOUT_S = 600.0


def multihost_env() -> Optional[dict]:
    """Parse the operator's multi-host env contract; None when single-host.

    Raises on a HALF-configured contract (NUM_TPU_HOSTS > 1 but no worker
    id / coordinator): silently proceeding single-host would wedge the
    slice at its first collective - fail at boot with the reason instead.
    """
    hosts = int(os.environ.get(ENV_NUM_HOSTS, "1") or 1)
    if hosts <= 1:
        return None
    wid = os.environ.get(ENV_WORKER_ID, "")
    coord = os.environ.get(ENV_COORDINATOR, "")
    if wid == "" or not coord:
        raise RuntimeError(
            f"{ENV_NUM_HOSTS}={hosts} but {ENV_WORKER_ID}={wid!r} / "
            f"{ENV_COORDINATOR}={coord!r}: multi-host pods must run "
            "under the operator's StatefulSet (operator/compile.py) which "
            "injects both"
        )
    return {
        "num_processes": hosts,
        "process_id": int(wid),
        "coordinator_address": coord,
    }


def _join_process_group(coordinator_address: str, num_processes: int,
                        process_id: int) -> None:
    """The default join: a gloo group whose store worker 0 hosts at the
    coordinator address."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=JOIN_TIMEOUT_S))


def maybe_initialize_distributed(initialize=None) -> bool:
    """Join the slice if the env says so; returns True when distributed.

    ``initialize`` is injectable for tests; it takes the reference's
    keywords (``coordinator_address``, ``num_processes``, ``process_id``).
    By default it is ``torch.distributed.init_process_group("gloo",
    init_method="tcp://<coordinator>", world_size=, rank=, timeout=)``.
    """
    env = multihost_env()
    if env is None:
        return False
    if initialize is None:
        initialize = _join_process_group
    logger.info(
        "joining %d-host slice as worker %d (coordinator %s)",
        env["num_processes"], env["process_id"], env["coordinator_address"],
    )
    initialize(
        coordinator_address=env["coordinator_address"],
        num_processes=env["num_processes"],
        process_id=env["process_id"],
    )
    return True


# ----------------------------------------------------------------------
# the dryrun: multi-process join + tensor parallelism across processes
# ----------------------------------------------------------------------

def _statefulset_env_names(n_hosts: int) -> None:
    """Compile a multi-host SeldonDeployment through the port's operator
    and assert its StatefulSet engine container carries the exact contract
    this module parses, so the dryrun exercises the operator wiring, not a
    hand-typed env.  The port sizes hosts by GPUs (``GPUS_PER_HOST``; the
    topology annotation is ignored).  Raises AssertionError on drift."""
    from seldon_core_tpu_torch.operator.compile import (
        GPUS_PER_HOST,
        compile_deployment,
    )
    from seldon_core_tpu_torch.operator.spec import SeldonDeployment

    dep = SeldonDeployment.from_dict({
        "metadata": {"name": "mh-dryrun"},
        "spec": {
            "name": "mh-dryrun",
            "predictors": [{
                "name": "p",
                "graph": {"name": "m", "implementation": "SIMPLE_MODEL"},
                "annotations": {
                    "seldon.io/tpu-chips": str(n_hosts * GPUS_PER_HOST),
                },
            }],
        },
    })
    sts = [m for m in compile_deployment(dep) if m["kind"] == "StatefulSet"]
    assert sts, "multi-host compile produced no StatefulSet"
    env = {e["name"]: e
           for e in sts[0]["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env[ENV_NUM_HOSTS]["value"] == str(n_hosts)
    # the worker id comes from the pod-index label (what the parent mirrors
    # with the loop ordinal)
    assert "pod-index" in (
        env[ENV_WORKER_ID]["valueFrom"]["fieldRef"]["fieldPath"]
    )
    assert env[ENV_COORDINATOR]["value"].endswith(f":{COORDINATOR_PORT}")


#: the dryrun's prompts, by name: the reference draws them from
#: ``jax.random.PRNGKey(1..4)``
DRYRUN_PROMPTS = {"prompt": (1, 4), "prefix": (16,), "suffix": (1, 6),
                  "long_prompt": (1, 44)}


def _flat(tree: dict, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().cpu().numpy()
    return out


def _unflat(arrays: dict, prefix: str) -> dict:
    import torch

    out: dict = {}
    for key, a in arrays.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(a)
    return out


def write_dryrun_inputs(path: str, params: dict, draft_params: dict,
                        prompts: dict) -> str:
    """An npz of the dryrun's inputs: the float target and draft trees (of
    :func:`_dryrun_configs`) and :data:`DRYRUN_PROMPTS` by name, for the
    workers to serve instead of their own seeded draws (a CPU test hands
    them the reference's converted weights so)."""
    import numpy as np

    arrays = {**_flat(params, "params/"), **_flat(draft_params, "draft/")}
    for name, shape in DRYRUN_PROMPTS.items():
        arrays[f"prompts/{name}"] = np.asarray(prompts[name],
                                               np.int64).reshape(shape)
    np.savez(path, **arrays)
    return path


def _dryrun_configs(n_ranks: int):
    """The reference's two float32 configs, heads = the global rank count."""
    import torch

    from seldon_core_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(
        vocab_size=64, d_model=64, n_layers=2, n_heads=n_ranks,
        d_ff=128, max_seq=64, dtype=torch.float32)
    dcfg = TransformerConfig(
        vocab_size=64, d_model=32, n_layers=1, n_heads=n_ranks,
        d_ff=64, max_seq=64, dtype=torch.float32)
    return cfg, dcfg


def _spawn_workers(n_hosts: int, args: list, timeout: float) -> list:
    """``n_hosts`` OS processes of this module's CLI (``args``), joined
    through the operator's StatefulSet env contract on a free port; each
    one's last JSON line, parsed, with ``"port"`` added.  Raises with the
    failing worker's log, every worker killed, on failure or past one
    shared ``timeout``."""
    import json
    import subprocess
    import sys
    import tempfile
    import time

    from seldon_core_tpu_torch.serving.workers import pick_free_port

    port = pick_free_port()
    cmd = [sys.executable, "-m", "seldon_core_tpu_torch.runtime.multihost",
           *args]
    procs, logs = [], []
    for i in range(n_hosts):
        env = dict(os.environ)
        env.update({
            # what k8s materializes from the StatefulSet manifest: the
            # pod-index label -> TPU_WORKER_ID, the headless-service DNS
            # of pod 0 -> coordinator (loopback stands in for DNS here)
            ENV_NUM_HOSTS: str(n_hosts),
            ENV_WORKER_ID: str(i),
            ENV_COORDINATOR: f"127.0.0.1:{port}",
        })
        logs.append(tempfile.TemporaryFile("w+"))
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=logs[-1], stderr=subprocess.STDOUT,
            text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
        ))

    def log(i: int) -> str:
        logs[i].seek(0)
        return logs[i].read()

    # ONE shared deadline: workers wedging must not serialize into
    # n_hosts x timeout of wall clock; a worker that fails stops the rest
    # (they would wait for it at their next collective)
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            for i, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise RuntimeError(
                        f"worker {i} failed (rc={p.returncode}):\n"
                        + log(i)[-3000:])
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "multihost dryrun worker timed out:\n"
                    + "\n".join(log(i)[-1500:] for i in range(n_hosts)))
            time.sleep(0.05)
        for i, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"worker {i} failed (rc={p.returncode}):"
                                   "\n" + log(i)[-3000:])
        outs = [log(i) for i in range(n_hosts)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    results = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        results.append({**json.loads(line), "port": port})
    return results


def run_multihost_dryrun(n_hosts: int = 2, devices_per_host: int = 4,
                         timeout: float = 600.0, device="cuda",
                         params: Optional[str] = None) -> dict:
    """Spawn ``n_hosts`` OS PROCESSES through the operator's StatefulSet
    env contract, join them into one gloo process group, and run a
    tensor-parallel ``LLMEngine`` and ``PagedLLMEngine`` over the GLOBAL
    mesh (``devices_per_host`` ranks a process, all on ``device``: repeats
    of the CPU, or of ``cuda:0``): tp spans the process boundary, so every
    tick's partial sums and gathers cross processes.  Each worker also runs
    the plain single-device decode as a reference and asserts
    byte-identical output.  ``params`` (:func:`write_dryrun_inputs`) gives
    the workers their weights and prompts; without it they draw seeded
    ones from ``torch.Generator``.

    Returns {"n_hosts", "global_devices", "tokens", "paged_requests",
    "spec_rounds", "pinned_pages", "fleet"} as the reference does, and
    (port only) "paged_tokens" (the paged engine's ids), "sampled_tokens"
    (one sampled request, equal in every process) and "launches" (the
    kernels' launches summed over the workers); raises with the failing
    worker's log, every worker killed, on failure or past one shared
    ``timeout``."""
    _statefulset_env_names(n_hosts)
    args = ["--dryrun-worker", "--devices-per-host", str(devices_per_host),
            "--device", str(device)]
    if params is not None:
        args += ["--params", os.path.abspath(params)]
    results = _spawn_workers(n_hosts, args, timeout)
    port = results[0]["port"]
    toks = [r["tokens"] for r in results]
    assert all(t == toks[0] for t in toks), (
        f"ranks disagree on generated tokens: {toks}"
    )
    assert all(r["match_ref"] for r in results), (
        f"engine output diverged from plain decode: {results}"
    )
    assert all(
        r["global_devices"] == n_hosts * devices_per_host for r in results
    )
    # the composed PagedLLMEngine proof: every rank byte-identical to the
    # plain decode AND to each other, speculation live, shared-prefix
    # pages pinned (and returned) with refcounts consistent per rank
    ptoks = [r["paged_tokens"] for r in results]
    assert all(t == ptoks[0] for t in ptoks), (
        f"ranks disagree on paged-engine tokens: {ptoks}"
    )
    assert all(r["paged_match_ref"] for r in results), (
        f"paged engine diverged from plain decode: {results}"
    )
    assert all(r["spec_rounds"] > 0 for r in results)
    assert all(r["pinned_pages"] > 0 for r in results), (
        f"shared prefix never pinned pages: {results}"
    )
    assert all(r["pages_ok"] for r in results), f"pages leaked: {results}"
    # one sampled request: the gathered logits are equal in every process,
    # so a seeded sampler draws the same ids
    stoks = [r["sampled_tokens"] for r in results]
    assert all(t == stoks[0] for t in stoks), (
        f"ranks disagree on sampled tokens: {stoks}"
    )
    # fleet-aware: every slice worker registers into a ReplicaPool exactly
    # as gateway membership would see it - one replica per host, all
    # healthy after a clean dryrun
    from seldon_core_tpu_torch.fleet import ReplicaPool

    pool = ReplicaPool(
        "mh-dryrun",
        members=tuple(
            f"http://127.0.0.1:{port}/worker-{r['process']}"
            for r in sorted(results, key=lambda r: r["process"])
        ),
    )
    fleet = pool.snapshot()
    assert len(pool) == n_hosts, (
        f"fleet membership {len(pool)} != n_hosts {n_hosts}"
    )
    assert fleet["healthy"] == n_hosts
    launches: dict = {}
    for r in results:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return {
        "n_hosts": n_hosts,
        "global_devices": results[0]["global_devices"],
        "tokens": toks[0],
        "paged_requests": len(ptoks[0]),
        "spec_rounds": results[0]["spec_rounds"],
        "pinned_pages": results[0]["pinned_pages"],
        "fleet": fleet,
        "paged_tokens": ptoks[0],
        "sampled_tokens": stoks[0],
        "launches": launches,
    }


def _local_device(device) -> "torch.device":  # noqa: F821
    import torch

    from seldon_core_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _dryrun_worker(devices_per_host: int, device, params_path=None) -> None:
    """One slice worker: join through the env contract, then prove TWO
    engines over the GLOBAL mesh (tp spanning the process boundary, gloo):

    1. plain ``LLMEngine`` generate;
    2. the ``PagedLLMEngine``: paged KV pool split over the cross-process
       "tp" axis, speculative decoding (k = 3), ring (sequence-parallel)
       prefill for the long prompt, and SHARED-PREFIX page aliasing with
       its host-side refcounts kept in every process.

    Requests run SEQUENTIALLY: every process must run the same collectives
    in the same order, and concurrent admissions would make the
    tick/admission interleaving depend on each host's timing.  Each worker
    compares against the plain local single-device decode and prints one
    JSON line (the reference's keys, and the port's ``sampled_tokens`` and
    ``launches``)."""
    import asyncio
    import json

    import numpy as np
    import torch

    assert maybe_initialize_distributed(), "contract env missing"
    import torch.distributed as dist

    from seldon_core_tpu_torch.models.transformer import (
        generate,
        init_params,
        shard_params,
    )
    from seldon_core_tpu_torch.ops import launches as kernel_launches
    from seldon_core_tpu_torch.parallel.mesh import process_mesh
    from seldon_core_tpu_torch.runtime.llm import LLMEngine, PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import PagedConfig

    dev = _local_device(device)
    if dev.type == "cpu":
        # the processes share the host's cores
        torch.set_num_threads(2)
    mesh = process_mesh([dev] * devices_per_host)
    n = mesh.devices.size
    cfg, dcfg = _dryrun_configs(n)
    if params_path is not None:
        with np.load(params_path) as z:
            arrays = {k: z[k] for k in z.files}
        params = _to(_unflat(arrays, "params/"), dev)
        dparams = _to(_unflat(arrays, "draft/"), dev)
        prompts = {k: torch.from_numpy(arrays[f"prompts/{k}"])
                   for k in DRYRUN_PROMPTS}
    else:
        params = init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
        dparams = init_params(torch.Generator(dev).manual_seed(9), dcfg, dev)
        prompts = {k: torch.randint(
            0, 64, shape, generator=torch.Generator().manual_seed(i + 1))
            for i, (k, shape) in enumerate(DRYRUN_PROMPTS.items())}
    sp = shard_params(params, mesh, cfg)
    pr = prompts["prompt"]
    for fn in kernel_launches._kernels.values():
        fn.launches = 0

    eng = LLMEngine(sp, cfg, max_slots=2, max_len=32, mesh=mesh)
    out = asyncio.run(eng.generate(pr, 5)).numpy()
    # port only: one sampled request through the same engine
    sampled = asyncio.run(eng.generate(pr, 5, temperature=0.8,
                                       seed=3)).numpy()
    eng.close()
    ref = generate(params, pr.to(dev), 5, cfg).cpu().numpy()

    # --- 2: the composed paged engine across the process boundary -------
    paged_eng = PagedLLMEngine(
        sp, cfg, PagedConfig(n_pages=33, page_size=4),
        max_slots=4, max_len=60, mesh=mesh,
        draft_params=shard_params(dparams, mesh, dcfg), draft_cfg=dcfg,
        k_draft=3, ring_prefill=32,
    )
    # shared prefix: its full pages pin ONCE per rank; both admissions
    # below alias them (host-side page tables + refcounts in every process)
    prefix = prompts["prefix"]
    aliased = torch.cat([prefix[None, :], prompts["suffix"]], dim=1)
    # 44-token prompt -> bucket 64 >= ring_prefill and 64 % tp == 0: its
    # prefill runs sequence-parallel (ring over the cross-process axis)
    long_pr = prompts["long_prompt"]

    async def run_paged():
        paged_eng.register_prefix(prefix)
        outs = []
        outs.append(await paged_eng.generate(aliased, 5))  # aliased #1
        outs.append(await paged_eng.generate(aliased, 7))  # aliased #2
        outs.append(await paged_eng.generate(long_pr, 4))  # ring + spec
        return outs

    paged_outs = [o.numpy() for o in asyncio.run(run_paged())]
    paged_refs = [generate(params, p.to(dev), k, cfg).cpu().numpy()
                  for p, k in ((aliased, 5), (aliased, 7), (long_pr, 4))]
    pinned = paged_eng._pinned_pages
    paged_eng.clear_prefixes()
    launches = {name: fn.launches
                for name, fn in kernel_launches._kernels.items()}
    print(json.dumps({
        "process": dist.get_rank(),
        "global_devices": n,
        "local_devices": devices_per_host,
        "tokens": out.tolist(),
        "match_ref": bool((out == ref).all()),
        "paged_tokens": [o.tolist() for o in paged_outs],
        "paged_match_ref": bool(all(
            (o == r).all() for o, r in zip(paged_outs, paged_refs)
        )),
        "spec_rounds": paged_eng.spec_stats["rounds"],
        "pinned_pages": pinned,
        "pages_ok": paged_eng.free_pages == 32,
        "sampled_tokens": sampled.tolist(),
        "launches": launches,
    }), flush=True)
    paged_eng.close()
    dist.destroy_process_group()


def _parse_plan(label: str):
    """A :class:`MeshPlan` from ``dp2pp2tp2``."""
    import re

    from seldon_core_tpu_torch.parallel.mesh import MeshPlan

    m = re.fullmatch(r"dp(\d+)pp(\d+)tp(\d+)", label)
    if m is None:
        raise ValueError(f"a plan is dp<n>pp<n>tp<n>, not {label!r}")
    return MeshPlan(*(int(g) for g in m.groups()))


def write_training_inputs(path: str, inputs: dict) -> str:
    """An npz of the training dryrun's inputs: ``inputs`` maps a plan's
    label (``dryrun.plan_label``) to ``(params, batch)``, an unplaced float
    tree of ``dryrun_config(plan)`` and a batch dict, for the workers to
    train instead of their own seeded draws (a CPU test hands them the
    reference's converted weights and batch so)."""
    import numpy as np

    arrays = {}
    for label, (params, batch) in inputs.items():
        arrays.update(_flat(params, f"{label}/params/"))
        for k, v in batch.items():
            arrays[f"{label}/batch/{k}"] = np.asarray(
                v.cpu() if hasattr(v, "cpu") else v)
    np.savez(path, **arrays)
    return path


def _train_worker(devices_per_host: int, device, plans: list,
                  inputs_path=None, out_dir=None) -> None:
    """One slice worker of the training dryrun: join through the env
    contract, then for each plan one AdamW step of the dryrun model over
    ``process_mesh(..., plan=)`` (dp, pp and tp may each cross the process
    boundary), and print one JSON line: each plan's summary line, loss,
    step seconds, whether every leaf several processes keep is bitwise the
    same in each of them, and the kernels' launches here.  ``out_dir``
    gets this process's pieces and their gradients after the step
    (``w<process>.npz``, keyed by plan and ``parallel/mesh.py``
    ``leaf_items``)."""
    import json
    import time

    import numpy as np
    import torch

    assert maybe_initialize_distributed(), "contract env missing"
    import torch.distributed as dist

    from seldon_core_tpu_torch.dryrun import dryrun_training, plan_label
    from seldon_core_tpu_torch.ops import launches as kernel_launches
    from seldon_core_tpu_torch.parallel.mesh import (
        leaf_items,
        process_mesh,
        replicas_agree,
    )

    dev = _local_device(device)
    if dev.type == "cpu":
        # the processes share the host's cores
        torch.set_num_threads(2)
    arrays = {}
    if inputs_path is not None:
        with np.load(inputs_path) as z:
            arrays = {k: z[k] for k in z.files}
    results, saved = [], {}
    for plan in plans:
        label = plan_label(plan)
        mesh = process_mesh([dev] * devices_per_host, plan=plan)
        params = batch = None
        if f"{label}/batch/input_ids" in arrays:
            params = _to(_unflat(arrays, f"{label}/params/"), dev)
            batch = {k: torch.from_numpy(arrays[f"{label}/batch/{k}"]).to(dev)
                     for k in ("input_ids", "targets", "mask")}
        for fn in kernel_launches._kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        line, loss, placed = dryrun_training(plan, dev, params=params,
                                             batch=batch, mesh=mesh)
        step_s = time.perf_counter() - t0
        agree = replicas_agree(placed, mesh)
        results.append({
            "plan": label, "line": line, "loss": loss, "step_s": step_s,
            "replicas": agree,
            "launches": {name: fn.launches
                         for name, fn in kernel_launches._kernels.items()}})
        for key, t in leaf_items(placed, label):
            saved[f"param/{key}"] = t.detach().cpu().numpy()
            if t.grad is not None:
                saved[f"grad/{key}"] = t.grad.cpu().numpy()
    if out_dir is not None:
        np.savez(os.path.join(out_dir, f"w{dist.get_rank()}.npz"), **saved)
    print(json.dumps({"process": dist.get_rank(),
                      "global_devices": dist.get_world_size()
                      * devices_per_host,
                      "local_devices": devices_per_host,
                      "plans": results}), flush=True)
    dist.destroy_process_group()


def run_multihost_training(n_hosts: int = 2, devices_per_host: int = 4,
                           timeout: float = 600.0, device="cuda",
                           plans=None, inputs: Optional[str] = None) -> dict:
    """Spawn ``n_hosts`` OS processes through the operator's StatefulSet
    env contract, join them, and run the training dryrun (``dryrun.py``
    ``dryrun_training``) for each plan (``MeshPlan``s; by default the
    reference's two, ``dryrun.TRAINING_PLANS``, on every rank) over the
    global mesh of ``devices_per_host`` ranks a process on ``device``.
    ``inputs`` (:func:`write_training_inputs`) gives the params and batch
    per plan.

    Returns ``{"n_hosts", "global_devices", "plans": [{"plan", "line",
    "loss", "step_s" (each process's), "launches" (summed)}],
    "processes"}`` after asserting that every process printed the same
    lines and losses and that every leaf several processes keep is
    bitwise the same in each of them."""
    from seldon_core_tpu_torch.dryrun import TRAINING_PLANS, plan_label
    from seldon_core_tpu_torch.parallel.mesh import plan_mesh

    _statefulset_env_names(n_hosts)
    n = n_hosts * devices_per_host
    if plans is None:
        plans = [plan_mesh(n, **kw) for kw in TRAINING_PLANS]
    args = ["--dryrun-worker", "--mode", "train",
            "--devices-per-host", str(devices_per_host),
            "--device", str(device),
            "--plans", ",".join(plan_label(p) for p in plans)]
    if inputs is not None:
        args += ["--params", os.path.abspath(inputs)]
    results = sorted(_spawn_workers(n_hosts, args, timeout),
                     key=lambda r: r["process"])
    per_plan = []
    for i, plan in enumerate(plans):
        rows = [r["plans"][i] for r in results]
        lines = [r["line"] for r in rows]
        assert all(ln == lines[0] for ln in lines), (
            f"processes print different lines: {lines}")
        losses = [r["loss"] for r in rows]
        assert all(x == losses[0] for x in losses), (
            f"processes hold different losses: {losses}")
        assert all(r["replicas"]["equal"] for r in rows), (
            f"replicated leaves differ between processes: {rows}")
        launches: dict = {}
        for r in rows:
            for k, c in r["launches"].items():
                launches[k] = launches.get(k, 0) + c
        per_plan.append({"plan": plan_label(plan), "line": lines[0],
                         "loss": losses[0],
                         "step_s": [r["step_s"] for r in rows],
                         "shared_leaves": [r["replicas"]["leaves"]
                                           for r in rows],
                         "launches": launches})
    return {"n_hosts": n_hosts, "global_devices": n, "plans": per_plan,
            "processes": results}


def _to(tree: dict, dev) -> dict:
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-worker", action="store_true",
                    help="one worker (the env contract names it)")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--devices-per-host", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--params", default=None,
                    help="an npz of write_dryrun_inputs (serve) or "
                         "write_training_inputs (train)")
    ap.add_argument("--mode", choices=("serve", "train"), default="serve",
                    help="the engines' dryrun, or the training dryrun")
    ap.add_argument("--plans", default=None,
                    help="train: plans as dp2pp2tp2,dp2pp1tp4 (default: "
                         "the reference's two on every rank)")
    args = ap.parse_args(argv)
    plans = (None if args.plans is None
             else [_parse_plan(x) for x in args.plans.split(",")])
    if args.dryrun_worker and args.mode == "train":
        _train_worker(args.devices_per_host, args.device, plans,
                      args.params)
    elif args.dryrun_worker:
        _dryrun_worker(args.devices_per_host, args.device, args.params)
    elif args.mode == "train":
        r = run_multihost_training(args.hosts, args.devices_per_host,
                                   device=args.device, plans=plans,
                                   inputs=args.params)
        print(json.dumps({k: v for k, v in r.items()  # noqa: T201
                          if k != "processes"}))
    else:
        print(json.dumps(run_multihost_dryrun(  # noqa: T201
            args.hosts, args.devices_per_host, device=args.device,
            params=args.params)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
