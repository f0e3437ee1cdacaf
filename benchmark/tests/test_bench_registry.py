"""BENCHMARK.json against the contract, and every piece found by name."""

import json
import re

from benchmark.core import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    return registry.benchmark()


def test_top_level_keys_and_size():
    raw = (registry.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])


def test_configs_cells_and_files_found_by_name():
    b = _bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = registry.config(c["name"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in data
            assert not key.endswith(("_dim", "_rank", "_size"))
    used = set()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = registry.cell(w["name"])
        assert cell["config"] == w["config"] and w["config"] in configs
        registry.module("drivers", cell["driver"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(configs)


def test_metrics_have_readers_and_cover_every_cell():
    b = _bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(registry.module("e2e", m["name"]).read)
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(registry.module("metrics", m["name"]).read)
        for w in m["workloads"]:
            moved = [e for e in b["end_to_end"] if e["name"] == m["moves"]]
            assert w in moved[0].get("workloads", [w])
    for w in b["workloads"]:
        ends = registry.cell_metrics(b, w["name"], False)
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
        assert registry.cell_metrics(b, w["name"], True)
        layer = {m["name"] for m in registry.cell_metrics(b, w["name"], True)}
        assert any("mfu" in n for n in layer)


def test_command_names_no_file_outside_paths():
    b = _bench()
    assert b["command"][1].startswith("benchmark/")
    assert (registry.ROOT / b["command"][1]).is_file()
