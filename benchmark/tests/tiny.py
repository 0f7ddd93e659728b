"""Tiny cells for the CPU tests: the two configurations' builders at small
widths and depths, under small closed loops."""
import copy

from benchmark import spec

TINY_AWQ = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=4,
                num_attention_heads=4, num_key_value_heads=2, head_dim=64)
TINY_MOE = dict(vocab_size=480, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, num_local_experts=4)
TINY_DRAFT = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=32)


def tiny_cell(workload: str, seconds_scale: float = 1.0) -> dict:
    c = copy.deepcopy(spec.cell(workload))
    cfg, mix = c["config"], c["mix"]
    if c["config_name"] == "mistral7b_awq":
        cfg.update(TINY_AWQ)
        cfg["bench"]["exit_layer"] = 2
    else:
        cfg.update(TINY_MOE)
        cfg["draft"].update(TINY_DRAFT)
    mix["engine"]["max_length"] = 1024
    if mix["loop"] == "scheduler":
        mix["engine"].update(batch_size=4, segment_steps=4)
        mix["clients"] = 6
        mix["ramp_seconds"] = 1
    mix["prompt"].update(median=24, min=8, max=96)
    mix["output"].update(median=12, min=4, max=24)
    if mix["loop"] == "stream":
        mix["output"].update(median=40, min=32, max=48)
    mix["pool"] = 32
    mix["check_requests"] = 3
    c["limits"] = dict(min_tokens_checked=1)
    return c
