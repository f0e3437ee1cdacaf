"""Cells that score rows through a deployed graph: requests through
``predict`` of the deployment that the port's local runner
(``operator/local.py``) boots from the cell's SeldonDeployment, in
process, on the event loop its batchers serve on.

A run: the deployment booted (its model builds the benchmark's weights
for the seed), every batcher bucket of its fused plan captured, a pool of
seeded images made; then the load: a warm-up period, the window, and a
drain.  Closed loop: each client sends its next request of
``rows_per_request`` images when the last has answered.

Once the load has ended: the peak of device memory is read, the
deployment is freed, and the answers of a sample of the window's
requests, drawn from the seed, are compared with the plain reference
(``checks/logit_err.py``).  Where ``run.info["control"]`` is set
(``tools/control.py``), the control's answers are then judged in the
program's place and their line printed too (``run.info["control_line"]``).
"""

from __future__ import annotations

import asyncio
import copy
import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark.core import registry, stats, traffic
from benchmark.core.context import Run, finish
from benchmark.core.trace import Slice, prime

__all__ = ["run", "deployment_spec", "TRAFFIC_KEYS"]

#: the loops this driver runs and the ``traffic`` keys it reads in each
#: (``core/traffic.py``)
TRAFFIC_KEYS = {"closed": ("clients", "stagger_s", "rows_per_request",
                           "pool_images")}


def deployment_spec(cell: dict, config: dict, seed: int) -> dict:
    """The cell's SeldonDeployment with its model node's parameters set
    from the configuration and the seed."""
    spec = copy.deepcopy(cell["deployment"])
    params = {"seed": (seed, "INT"),
              "image_size": (config["image_size"], "INT"),
              "num_classes": (config["num_classes"], "INT"),
              "stage_sizes": (",".join(str(s) for s in config["stage_sizes"]),
                              "STRING"),
              "input_scale": (config.get("input_scale", 1.0), "FLOAT")}
    for pred in spec["spec"]["predictors"]:
        node = pred["graph"]
        kept = [p for p in node.get("parameters", [])
                if p["name"] not in params]
        node["parameters"] = kept + [
            {"name": k, "value": str(v), "type": t}
            for k, (v, t) in params.items()]
    return spec


def _images(config: dict, n: int, seed: int, device) -> np.ndarray:
    """``n`` seeded images (n, H, W, 3) on the host in the configuration's
    ``input_dtype``, made on the card in one draw: uint8 pixels uniform
    over 0-255, or float32 normal."""
    s = config["image_size"]
    g = torch.Generator(device=device).manual_seed(
        (int(seed) + 7919) % (2 ** 63))
    if config.get("input_dtype", "float32") == "uint8":
        x = torch.randint(0, 256, (n, s, s, 3), generator=g, device=device,
                          dtype=torch.uint8)
    else:
        x = torch.randn((n, s, s, 3), generator=g, device=device)
    return x.cpu().numpy()


async def _sleep_until(t: float) -> None:
    dt = t - time.perf_counter()
    if dt > 0:
        await asyncio.sleep(dt)


async def _load(run: Run, dep, fam, bodies: list, keep_every: int,
                keep_at: int) -> None:
    from seldon_core_tpu_torch.messages import SeldonMessage

    cell, tr = run.cell, run.cell["traffic"]
    classes = run.config["num_classes"]
    t0 = time.perf_counter()
    run.w0 = t0 + float(cell["warmup_s"])
    run.w1 = run.w0 + run.seconds
    clients = int(tr["clients"])

    async def edges():
        await _sleep_until(run.w0)
        run.counters["window_start"] = fam.counters(dep)
        if run.trace:
            await _sleep_until(run.w1 - float(cell["slice_s"]))
            run.slice = Slice()
            run.slice.start()
            run.counters["slice_start"] = fam.counters(dep)
            run.s0 = run.slice.t0
        await _sleep_until(run.w1)
        run.counters["window_end"] = fam.counters(dep)
        if run.trace:
            run.counters["slice_end"] = fam.counters(dep)
            run.slice.stop()
            run.s1 = run.slice.t1

    async def client(c):
        await _sleep_until(t0 + float(tr.get("stagger_s", 0.0)) * c
                           / clients)
        k = 0
        while time.perf_counter() < run.w1:
            b = (c + clients * k) % len(bodies)
            r = stats.Request(t_send=time.perf_counter(),
                              rows=bodies[b].shape[0], key=(c, k, b))
            run.requests.append(r)
            try:
                out = await dep.predict(SeldonMessage.from_ndarray(bodies[b]))
                probs = out.host_data()
                r.t_last = time.perf_counter()
                r.ok = (probs is not None
                        and probs.shape == (r.rows, classes))
                if not r.ok:
                    r.error = f"answer {out.to_dict().get('status')}"
                elif (c * 7 + k) % keep_every == keep_at:
                    r.out = probs
            except Exception as e:  # a failed request is counted
                r.error = repr(e)
            k += 1

    tasks = [asyncio.ensure_future(client(c)) for c in range(clients)]
    await edges()
    _, pending = await asyncio.wait(tasks, timeout=float(cell["drain_s"]))
    for t in pending:
        t.cancel()
    if pending:
        await asyncio.gather(*pending, return_exceptions=True)
    run.given_up = time.perf_counter()
    for t in tasks:
        if t.done() and not t.cancelled() and t.exception() is not None:
            raise t.exception()


def run(run: Run) -> dict:
    cfg, cell = run.config, run.cell
    fam = registry.module("families", cfg["family"])
    dep = fam.build_system(deployment_spec(cell, cfg, run.seed),
                           str(run.device))
    size = cfg["image_size"]
    row = np.zeros((size, size, 3), cfg.get("input_dtype", "float32"))
    tr = cell["traffic"]
    per = int(tr["rows_per_request"])
    pool = _images(cfg, int(tr["pool_images"]), run.seed, run.device)
    bodies = [pool[i:i + per] for i in range(0, len(pool) - per + 1, per)]
    keep_every = int(cell["check"]["keep_every"])
    keep_at = int(traffic.rng_of(run.seed, 6).integers(keep_every))

    async def serve():
        if dep.engine.plan is not None:
            dep.engine.plan.warmup(row)
        if run.trace:
            prime()
        run.setup_s = time.perf_counter() - run.t_start
        try:
            await _load(run, dep, fam, bodies, keep_every, keep_at)
        finally:
            await dep.aclose()

    asyncio.run(serve())
    cuda = run.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    del dep, serve
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if run.slice is not None:
        run.slice.reduce()
    sent = run.window()
    ck = cell["check"]
    kept = [r for r in sent if r.out is not None]
    rng = traffic.rng_of(run.seed, 4)
    pick = rng.choice(len(kept), size=min(int(ck["requests"]), len(kept)),
                      replace=False) if kept else []
    sample = [kept[i] for i in sorted(pick)]
    t = time.perf_counter()
    ref = registry.module("references", cfg["reference"])
    check = registry.module("checks", ck["name"])
    w = fam.make_weights(run.seed, tuple(cfg["stage_sizes"]),
                         cfg["num_classes"], run.device,
                         cfg.get("input_scale", 1.0))
    if sample:
        images = torch.from_numpy(np.concatenate(
            [bodies[r.key[2]] for r in sample])).to(run.device)
        probs = torch.from_numpy(np.concatenate(
            [r.out for r in sample])).to(run.device)
        z = ref.logits(w, images, tuple(cfg["stage_sizes"]))
        checks = check.compare(probs, z, float(ck["limit"]))
        if run.info.get("control"):
            ctl = check.control_answers(ref.logits(
                w, images, tuple(cfg["stage_sizes"]), control=True))
            ctl_checks = check.compare(ctl, z, float(ck["limit"]))
    else:
        checks = ctl_checks = {ck["name"]: {"value": float("inf"),
                                            "limit": float(ck["limit"])}}
    summary = {"requests_sent_in_window": len(sent),
               "answered": sum(r.ok for r in sent),
               "images_checked": sum(r.rows for r in sample),
               "setup_s": run.setup_s, "check_s": time.perf_counter() - t}
    print(json.dumps(summary), flush=True)
    print(json.dumps(summary), file=sys.stderr, flush=True)
    line = finish(run, checks, peak)
    if run.info.get("control"):
        run.info["control_line"] = finish(run, ctl_checks, peak)
    return line
