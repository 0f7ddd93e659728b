"""A new configuration, mix or metric is found by adding a file: a copy of
the benchmark's folder with one more of each, read through spec."""
import json
import os
import shutil

from benchmark import spec


def test_new_files_are_found(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark")
    bench = spec.benchmark()
    bench["configs"].append(dict(bench["configs"][0], name="other7b",
                                 file="benchmark/configs/other7b.json"))
    bench["workloads"].append(dict(name="other7b.burst", config="other7b", traffic="burst",
                                   chips=1, why="a cell added by files alone"))
    bench["per_layer"].append(dict(name="new_counter", unit="count", better="higher",
                                   source="program_counter", layer="decode loop",
                                   moves="output_tok_s", workloads=["other7b.burst"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b = root / "benchmark"
    shutil.copy(b / "configs" / "mistral7b_awq.json", b / "configs" / "other7b.json")
    shutil.copy(b / "traffic" / "serve32.json", b / "traffic" / "burst.json")
    shutil.copy(b / "cells" / "mistral7b_awq.serve32.json", b / "cells" / "other7b.burst.json")
    (b / "metrics" / "new_counter.py").write_text("def read(run):\n    return 42\n")
    monkeypatch.setattr(spec, "HERE", str(b))
    monkeypatch.setattr(spec, "ROOT", str(root))
    c = spec.cell("other7b.burst")
    assert c["config_name"] == "other7b" and c["mix"]["loop"] == "scheduler"
    assert [m["name"] for m in c["per_layer"]][-1] == "new_counter"
    assert spec.reader("new_counter")(None) == 42
    assert "new_counter" not in [m["name"] for m in spec.cell("mistral7b_awq.serve32")["per_layer"]]
    assert os.path.exists(b / "metrics" / "step_ms.py")
