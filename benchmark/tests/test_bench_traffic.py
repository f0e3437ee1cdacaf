"""The generator: the same traffic for the same seed, the same work in
another order for another."""

import numpy as np
import pytest

from benchmark.core import traffic

DECODE = {"loop": "closed", "clients": 8, "stagger_s": 2.0, "rounds": 4,
          "prompt": {"median": 384, "sigma": 0.6, "min": 128, "max": 1024},
          "output": {"median": 512, "sigma": 0.4, "min": 256, "max": 768}}
OPEN = {"loop": "open", "rate": 7.0,
        "prompt": {"median": 2048, "sigma": 0.5, "min": 1024, "max": 4032},
        "output": {"median": 32, "sigma": 0.5, "min": 16, "max": 64}}
BIG = 2**31 + 12345


def test_same_seed_same_traffic():
    assert traffic.closed_loop(DECODE, BIG) == traffic.closed_loop(DECODE,
                                                                    BIG)
    assert traffic.open_loop(OPEN, BIG, 30) == traffic.open_loop(OPEN, BIG,
                                                                  30)
    a = traffic.token_ids(traffic.rng_of(BIG, 3), 50, 49152)
    b = traffic.token_ids(traffic.rng_of(BIG, 3), 50, 49152)
    assert a == b and all(1 <= x < 49152 for x in a)


def test_other_seed_same_work_other_order():
    a = traffic.closed_loop(DECODE, BIG)
    b = traffic.closed_loop(DECODE, BIG + 1)
    assert a != b
    for k in range(DECODE["rounds"]):
        ka = sorted(c["requests"][k]["prompt_len"] for c in a)
        kb = sorted(c["requests"][k]["prompt_len"] for c in b)
        assert ka == kb
    oa = traffic.open_loop(OPEN, 5, 40)
    ob = traffic.open_loop(OPEN, 6, 40)
    assert sorted(x["prompt_len"] for x in oa) != [] and oa != ob
    assert abs(len(oa) - len(ob)) <= 1
    assert abs(sum(x["prompt_len"] for x in oa)
               - sum(x["prompt_len"] for x in ob)) <= 2 * 4032


def test_lengths_follow_the_distribution():
    x = traffic.lognormal_lengths(1001, DECODE["prompt"])
    assert x.min() >= 128 and x.max() <= 1024
    assert np.median(x) == 384
    assert list(x) == sorted(x)


def test_open_loop_rate_and_start():
    arr = traffic.open_loop(OPEN, 3, 60)
    assert arr[0]["at_s"] == 0.0
    assert all(a["at_s"] < 60 for a in arr)
    assert abs(len(arr) / 60 - OPEN["rate"]) < 0.3
    assert all(b["at_s"] >= a["at_s"] for a, b in zip(arr, arr[1:]))
    gaps = traffic.exponential_gaps(1000, 4.0)
    assert abs(gaps.mean() - 0.25) < 0.01


def test_closed_loop_staggers_starts():
    plans = traffic.closed_loop(DECODE, 1)
    starts = [p["start_s"] for p in plans]
    assert starts == sorted(starts) and starts[0] == 0.0
    assert starts[-1] < DECODE["stagger_s"]


def test_fixed_order_is_the_same_for_every_seed():
    fixed = dict(OPEN, order="fixed")
    assert traffic.open_loop(fixed, 5, 30) == traffic.open_loop(fixed, 6, 30)
    closed = dict(DECODE, order="fixed")
    assert traffic.closed_loop(closed, 1) == traffic.closed_loop(closed, 2)


def _drivers():
    from benchmark.core import registry

    return {name: registry.module("drivers", name).TRAFFIC_KEYS
            for name in ("llm_stream", "graph_predict")}


def test_every_cell_asks_only_for_traffic_its_driver_makes():
    from benchmark.core import registry

    keys = _drivers()
    for w in registry.benchmark()["workloads"]:
        cell = registry.cell(w["name"])
        traffic.validate(cell["traffic"], keys[cell["driver"]])


@pytest.mark.parametrize("change", [
    {"shared_prefix_tokens": 2048},      # a key nothing reads
    {"sampling": "top_p"},
    {"arrivals": "poisson"},
    {"clients": 8},                      # a closed-loop key in an open loop
    {"loop": "bursty"},                  # a loop no driver runs
    {"order": "reversed"},
    {"prompt": {"median": 2048, "sigma": 0.5, "min": 1024, "max": 4032,
                "shared": 0.5}},
])
def test_traffic_no_code_makes_is_refused(change):
    keys = _drivers()["llm_stream"]
    with pytest.raises(ValueError):
        traffic.validate(dict(OPEN, **change), keys)


def test_a_run_refuses_a_cell_with_unread_traffic():
    from benchmark import run as bench_run
    from benchmark.core import registry

    cell = registry.cell("resnet50-int8.batch")
    cell["traffic"]["loop"] = "open"
    with pytest.raises(ValueError):
        bench_run.make_run("resnet50-int8.batch", 1, 1.0, False, "cpu",
                           cell=cell)
