"""Operations, bytes and bounds against hand-worked shapes."""
import types

import pytest

from benchmark import roofline
from benchmark.roofline import Shapes
from benchmark.window import Record

MISTRAL = dict(hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
               num_attention_heads=32, num_key_value_heads=8, head_dim=128, vocab_size=32768)


def test_bound_takes_the_larger():
    assert roofline.bound(3.35e12, 0) == (1.0, "bytes")
    assert roofline.bound(0, 989e12) == (1.0, "operations")
    assert roofline.bound(0, 1979e12, "int8") == (1.0, "operations")


def test_dense_layer_and_forward():
    s = Shapes.from_config(MISTRAL)
    # q|k|v 4096 x 6144, o 4096 x 4096, gate|up 4096 x 28672, down 14336 x 4096
    macs = 4096 * 6144 + 4096 * 4096 + 4096 * 28672 + 14336 * 4096
    assert s.layer_macs() == macs
    assert s.forward_flops(1, 0) == 2 * (32 * macs + 4096 * 32768)
    assert s.forward_flops(0, 10) == 4 * 32 * 128 * 10 * 32


def test_moe_layer_counts_top_k_experts():
    s = Shapes.from_config(dict(MISTRAL, num_local_experts=8, num_experts_per_tok=2, head_dim=None))
    assert s.layer_macs() == 4096 * 6144 + 4096 * 4096 + 4096 * 8 + 2 * 3 * 4096 * 14336


def test_w4a16_bytes_and_ops():
    s = Shapes.from_config(MISTRAL, w4_from=3)
    by, ops = s.w4a16_work(rows=2)
    per_layer = 0
    for k, n in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
        per_layer += k * n / 2 + 2 * (k // 128) * n * 2 + 2 * (k + n) * 2
    assert by == pytest.approx(29 * per_layer)
    assert ops == 29 * 2 * 2 * s.layer_macs()
    # one verify of 32 slots x 7 tree rows is bound by its 2.8 TFLOP at the bf16
    # peak (2.9 ms), not by its ~3.2 GB of weights (0.95 ms); one row by bytes
    t, what = roofline.bound(*s.w4a16_work(224))
    assert what == "operations" and t == pytest.approx(s.w4a16_work(224)[1] / 989e12)
    t, what = roofline.bound(*s.w4a16_work(1))
    assert what == "bytes" and 0.95e-3 < t < 1.05e-3


def test_attention_bytes_int8_and_bf16():
    s = Shapes.from_config(MISTRAL)
    by, ops = s.attention_work(rows=1, columns=1000, pairs=1000, kv_bytes_per_value=2.0)
    assert by == (2 * 1 * 32 * 128 * 2 + 2 * 1000 * 8 * 128 * 2) * 32
    assert ops == 4 * 32 * 128 * 1000 * 32
    assert roofline.kv_bytes_per_value("int8", 128) == 1 + 4 / 128


def test_draft_level_rows():
    assert roofline.draft_level_rows([1, 2, 2, 2]) == [2, 2, 2]
    assert roofline.draft_level_rows([1, 6, 24, 24, 24, 24, 24]) == [2, 6, 24, 24, 24, 24]


def test_window_work_counts_steps_and_prefills():
    s = Shapes.from_config(MISTRAL, w4_from=3)
    d = Shapes.from_config(dict(MISTRAL, num_hidden_layers=3))
    r = Record(index=0, prompt_len=600, max_new=10, greedy=True, sent=0.0)
    r.arrive(1.0, 10)
    r.done = 1.0
    run = types.SimpleNamespace(shapes=(s, d), t0=0.0, t1=2.0, c0={"steps": 0},
                                c1={"steps": 4}, batch=1, tree_size=7, tree_levels=[1, 2, 2, 2],
                                records=[r], kv_dtype="bf16", chunk=512)
    w = roofline.window_work(run)
    assert w["steps"] == 4 and w["prefill_tokens"] == 600
    # no decode context: the request completed with its first frame
    assert w["context_columns"] == 0
    verify = 4 * roofline.bound(*s.w4a16_work(7))[0]
    prefill = roofline.bound(*s.w4a16_work(512))[0] + roofline.bound(*s.w4a16_work(88))[0]
    assert w["w4a16_s"] == pytest.approx(verify + prefill)
    assert w["flops"] > 2 * 600 * 32 * s.layer_macs()
