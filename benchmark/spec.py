"""Finding a cell's files by the names in BENCHMARK.json: the configuration
(`configs/<config>.json` and its builder module), the traffic mix
(`traffic/<mix>.json`), the cell's limits (`cells/<workload>.json`) and one
reader a metric (`metrics/<metric>.py`). Adding a cell, a mix or a metric adds
files; nothing here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell's BENCHMARK.json entry with its configuration, mix, limits and
    the metrics it reports at each trace setting."""
    bench = benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(work)})")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def reports(m):
        return name in m.get("workloads", [name])

    return dict(
        workload=w, config=load_json(ROOT, cfg_entry["file"]), config_name=w["config"],
        mix=load_json(HERE, "traffic", w["traffic"] + ".json"),
        limits=load_json(HERE, "cells", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)])


def builder(cfg: dict):
    """The configuration's builder module, configs/<bench.builder>.py."""
    return importlib.import_module(f"benchmark.configs.{cfg['bench']['builder']}")


def reader(metric: str):
    """The `read(run)` of metrics/<metric>.py (a name may hold dots)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
