"""Worker processes on one port (``serving/workers.py``), the port's against
the reference's on the CPU.

- A spawned ``WorkerPool`` of 2, each worker serving REST and gRPC on the
  same two ``SO_REUSEPORT`` ports: fresh connections reach both worker
  pids on both tiers, and every answer is the graph's.
- ``fork_workers``' fail-fast: when one worker exits, the supervisor stops
  the other and exits 0, every child reaped; SIGTERM to the supervisor
  stops the group.  The same script under the reference's ``fork_workers``
  behaves EQUALLY (the exit codes and which workers ran).
- The runner's ``--workers 2``: both workers answer on REST, gRPC, native
  REST and native gRPC, and killing one stops the group.

This module imports nothing heavy at its top: a spawned worker imports it
to find its boot function.
"""

import asyncio
import functools
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120


class PidModel:
    """Answers its worker's pid."""

    def predict(self, X, names):
        import numpy as np

        return np.full((len(X), 1), os.getpid(), dtype=np.float64)


def _boot(rest_port: int, grpc_port: int, index: int) -> None:
    """One worker: REST and gRPC on the shared ports, until terminated."""
    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.runtime.component import ComponentHandle
    from seldon_core_tpu_torch.serving.grpc_api import (
        GrpcServer,
        seldon_service_handler,
    )
    from seldon_core_tpu_torch.serving.rest import RestServer

    async def run():
        eng = GraphEngine({"name": "pid", "type": "MODEL"},
                          resolver=lambda u: ComponentHandle(PidModel()))
        rest = await RestServer(eng, host="127.0.0.1", port=rest_port,
                                reuse_port=True).start()
        g = GrpcServer([seldon_service_handler(eng)], port=grpc_port,
                       host="127.0.0.1", reuse_port=True)
        await g.start()
        try:
            await asyncio.Event().wait()
        finally:
            await g.stop(0)
            await rest.stop()

    asyncio.run(run())


def _rest_pid(port: int):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v0.1/predictions",
        data=json.dumps({"data": {"ndarray": [[1.0]]}}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return int(json.loads(r.read())["data"]["ndarray"][0][0])
    except OSError:
        return None


async def _grpc_pid(port: int):
    import grpc

    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.serving.grpc_api import SeldonGrpcClient

    c = SeldonGrpcClient(f"127.0.0.1:{port}", timeout_s=10)
    try:
        out = await c.predict(SeldonMessage.from_ndarray([[1.0]]))
        return int(out.host_data()[0][0])
    except grpc.aio.AioRpcError:
        return None
    finally:
        await c.close()


def _pids_until(fn, want: int, deadline_s: float = 90):
    pids, t0 = set(), time.monotonic()
    while len(pids) < want and time.monotonic() - t0 < deadline_s:
        pid = fn()
        if pid is not None:
            pids.add(pid)
        else:
            time.sleep(0.2)
    return pids


def test_worker_pool_shares_rest_and_grpc_ports():
    from seldon_core_tpu.serving import workers as jworkers
    from seldon_core_tpu_torch.serving import workers

    rport, gport = workers.pick_free_port(), workers.pick_free_port()
    pool = workers.WorkerPool(functools.partial(_boot, rport, gport), n=2)
    with pool:
        rest = _pids_until(lambda: _rest_pid(rport), 2)
        grpc_pids = _pids_until(lambda: asyncio.run(_grpc_pid(gport)), 2)
        assert workers.alive(pool) == jworkers.alive(pool) == 2
        assert sorted(pool.pids) == sorted(rest) == sorted(grpc_pids)
    assert workers.alive(pool) == 0 and pool.procs == []
    assert workers.alive(None) == jworkers.alive(None) == 0


FORK_SCRIPT = r"""
import os, sys, time
sys.path.insert(0, {root!r})
from {pkg}.serving.workers import fork_workers
out = sys.argv[1]
i = fork_workers(2)
with open(os.path.join(out, f"w{{i}}"), "w") as f:
    f.write(str(os.getpid()))
if i == 1 and sys.argv[2] == "crash":
    time.sleep(0.5)
    os._exit(3)
time.sleep(60)
"""


def _fork_run(pkg: str, mode: str, tmp: Path):
    out = tmp / f"{pkg}_{mode}"
    out.mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-c", FORK_SCRIPT.format(root=str(ROOT), pkg=pkg),
         str(out), mode], cwd=ROOT)
    t0 = time.monotonic()
    while len(list(out.iterdir())) < 2 and time.monotonic() - t0 < 30:
        time.sleep(0.05)
    if mode == "term":
        proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=30)
    pids = sorted(int(p.read_text()) for p in out.iterdir())
    # every worker is gone: reaped by the supervisor, not left a zombie
    alive = [p for p in pids if Path(f"/proc/{p}").exists()]
    return rc, sorted(p.name for p in out.iterdir()), alive


def test_fork_workers_fail_fast_as_the_references(tmp_path):
    for mode in ("crash", "term"):
        ref = _fork_run("seldon_core_tpu", mode, tmp_path)
        port = _fork_run("seldon_core_tpu_torch", mode, tmp_path)
        assert port == ref == (0, ["w0", "w1"], [])


def test_fork_workers_of_one_is_the_caller():
    from seldon_core_tpu_torch.serving.workers import fork_workers

    assert fork_workers(1) == 0 and fork_workers(0) == 0


def _line(proc, marker, lines):
    while True:
        ln = proc.stdout.readline()
        if not ln:
            raise AssertionError("".join(lines))
        lines.append(ln)
        if marker in ln:
            return ln


def test_runner_workers_serve_every_tier_and_stop_together():
    from seldon_core_tpu_torch.serving.workers import pick_free_port

    graph = ROOT / "seldon_core_tpu_torch" / "examples" / "iris.json"
    ports = [pick_free_port() for _ in range(4)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.operator.local",
         "--graph", str(graph), "--host", "127.0.0.1", "--device", "cpu",
         "--workers", "2", "--port", str(ports[0]), "--grpc-port",
         str(ports[1]), "--native-port", str(ports[2]), "--native-grpc-port",
         str(ports[3])],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        workers = set()
        for _ in range(2):
            workers.add(int(_line(proc, "(pid ", lines).split("pid ")[1]
                            .rstrip(")\n")))
        for _ in range(2):
            _line(proc, "serving deployment", lines)
        body = {"data": {"ndarray": [[5.1, 3.5, 1.4, 0.2]]}}

        def rest(port):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/v0.1/predictions",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())["data"]

        async def grpc_call(port):
            from seldon_core_tpu_torch.messages import SeldonMessage
            from seldon_core_tpu_torch.serving.grpc_api import (
                SeldonGrpcClient,
            )

            c = SeldonGrpcClient(f"127.0.0.1:{port}")
            try:
                return (await c.predict(SeldonMessage.from_dict(body))) \
                    .to_dict()["data"]
            finally:
                await c.close()

        answers = [rest(ports[0]), rest(ports[2])]
        answers += [asyncio.run(asyncio.wait_for(grpc_call(p), TIMEOUT))
                    for p in (ports[1], ports[3])]
        assert all(a == answers[0] for a in answers), answers
        assert len(workers) == 2 and proc.pid not in workers
        # fail-fast: one worker killed stops the group
        os.kill(sorted(workers)[0], signal.SIGKILL)
        assert proc.wait(timeout=60) == 0
        t0 = time.monotonic()
        while any(Path(f"/proc/{p}").exists() for p in workers) and \
                time.monotonic() - t0 < 10:
            time.sleep(0.05)
        assert not [p for p in workers if Path(f"/proc/{p}").exists()]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
