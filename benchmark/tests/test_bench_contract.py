"""BENCHMARK.json against the benchmark's contract: names, units, keys and
lengths, every cell's metrics, and a file for every name."""
import json
import os
import re

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_names_units():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and b["paths"] == ["benchmark"]
    assert all(TEXT.match(w) for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("benchmark/") and all(NAME.match(k) for k in c["reduced"])
        cfg = spec.load_json(spec.ROOT, c["file"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
    # at most a quarter of the cells, rounded down, on four cards; one always may
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and len(json.dumps(b)) < 64 * 1024


def test_every_cell_reports_enough_and_finds_its_files():
    b = spec.benchmark()
    for w in b["workloads"]:
        c = spec.cell(w["name"])
        e2e = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
        for m in c["per_layer"]:
            assert m["moves"] in e2e
        for m in c["end_to_end"] + c["per_layer"]:
            assert os.path.exists(os.path.join(spec.HERE, "metrics", m["name"] + ".py"))
        assert os.path.exists(os.path.join(spec.HERE, "configs",
                                           c["config"]["bench"]["builder"] + ".py"))
        assert "min_tokens_checked" in c["limits"]
