"""The port's profiling helpers (profiling.py) on the CPU: PhaseTimer's
report in the JAX package's format, and a torch.profiler trace file."""
import json
import os
import re

import pytest
import torch

from umbrella_tpu.profiling import PhaseTimer as JaxPhaseTimer
from umbrella_tpu_torch.profiling import PhaseTimer, trace


def test_phase_timer_report_format_matches_jax():
    ours, theirs = PhaseTimer(), JaxPhaseTimer()
    for timer in (ours, theirs):
        for name in ("verify", "draft", "verify"):
            with timer.phase(name):
                pass
    pattern = r"draft: \d+\.\d\d ms/call x1\nverify: \d+\.\d\d ms/call x2"
    assert re.fullmatch(pattern, ours.report())
    assert re.fullmatch(pattern, theirs.report())
    assert ours.counts == {"draft": 1, "verify": 2}


@pytest.mark.parametrize("block_on", [None, "tensor", "tree"])
def test_phase_timer_blocks_on_cpu_tensors(block_on):
    timer = PhaseTimer()
    x = torch.ones(64, 64)
    target = {None: None, "tensor": x, "tree": {"a": [x, (x,)], "b": 3}}[block_on]
    with timer.phase("matmul", block_on=target):
        x @ x
    assert timer.counts["matmul"] == 1 and timer.totals["matmul"] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    path = os.path.join(tmp_path, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())
