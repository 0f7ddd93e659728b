"""On the card: the control (the reference one precision step down) fails the
cell's limit where the program, on the same served tokens, passes it. Each
cell at its own size with a short window, on its own number of cards. Skips
without them."""
import time

import pytest

from benchmark import harness, spec

SECONDS = {"mistral7b_awq.serve32": 10.0, "mistral7b_awq.chat": 15.0, "mixtral8x7b.chat": 30.0,
           "mixtral8x7b.chat_ep4": 30.0}


@pytest.mark.chip
@pytest.mark.parametrize("name", sorted(SECONDS))
def test_control_fails_where_the_program_passes(name, card):
    import torch

    c = spec.cell(name)
    if torch.cuda.device_count() < c["workload"]["chips"]:
        pytest.skip(f"needs {c['workload']['chips']} CUDA cards")
    res = harness.run_cell(c, seed=2 ** 31 + 41, seconds=SECONDS[name], trace=False,
                           device=card, t_start=time.time(), control=True)
    found, limits = res["found"], c["limits"]
    assert res["correct"]
    name = "max_gap" if "max_gap" in limits else "mean_gap"
    control = found["control_gap" if name == "max_gap" else "control_mean_gap"]
    assert found[name] <= limits[name] < control
