"""The plain reference against the port's float32 forward at tiny sizes on
the CPU: the same AutoAWQ tensors or bf16 matrices, the same logits. (The
reference itself imports nothing of the port; these tests do, to hold it to
the program's semantics.)"""
import copy

import numpy as np
import pytest
import torch

from benchmark import reference, spec
from benchmark.configs import mistral7b_awq, mixtral8x7b
from benchmark.reference import Linear
from benchmark.tests.tiny import TINY_AWQ, TINY_DRAFT, TINY_MOE

L = 64


def port_logits(runtime, ids):
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    kv = runtime.init_kv()
    S = len(ids)
    logits, _ = runtime.forward(runtime.params, kv, torch.as_tensor(ids, dtype=torch.int32),
                                torch.arange(S), causal_mask_rows(0, S, runtime.max_length), 0)
    return logits.float()


def close(a, b, rel):
    return float((a - b).abs().max()) <= rel * float(b.abs().max())


def tiny_awq():
    cfg = copy.deepcopy(spec.load_json(spec.HERE, "configs", "mistral7b_awq.json"))
    cfg.update(TINY_AWQ)
    return cfg


def test_awq_dequant_and_forward_match_the_port():
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import ModelRuntime
    from umbrella_tpu_torch.quantization.awq import awq_from_hf_tensors
    from umbrella_tpu_torch.quantization.loader import awq_params_from_hf_state_dict

    cfg = tiny_awq()
    gen = torch.Generator().manual_seed(3)
    shapes = mistral7b_awq.shapes_of(cfg)
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    sd = {"model.embed_tokens.weight": torch.randn(V, H, generator=gen).to(torch.bfloat16),
          "model.norm.weight": torch.ones(H)}
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        lw = {}
        for part, name in mistral7b_awq.PROJ:
            t = mistral7b_awq._awq(gen, "cpu", *shapes[name], 128, 0.02, 0.25)
            for key, v in zip(("qweight", "qzeros", "scales"), t):
                sd[f"model.layers.{i}.{part}.{name}.{key}"] = v
            lw[name] = t
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"model.layers.{i}.{norm}.weight"] = torch.ones(H)
        layers.append({"input_norm": torch.ones(H), "post_norm": torch.ones(H),
                       "qkv": Linear(awq=[lw["q_proj"], lw["k_proj"], lw["v_proj"]]),
                       "wo": Linear(awq=[lw["o_proj"]]),
                       "gate_up": Linear(awq=[lw["gate_proj"], lw["up_proj"]]),
                       "down": Linear(awq=[lw["down_proj"]])})
    head = mistral7b_awq._awq(gen, "cpu", H, V, 128, 0.02, 0.25)
    mcfg = ModelConfig.from_dict({k: v for k, v in cfg.items() if k != "bench"})
    params = awq_params_from_hf_state_dict(sd, mcfg, L, torch.float32, device="cpu")
    params["lm_head"] = awq_from_hf_tensors(*head, dtype=torch.float32)
    rt = ModelRuntime(mcfg, params, L, dtype=torch.float32, family="mistral", device="cpu")
    model = {"embed": sd["model.embed_tokens.weight"], "final_norm": torch.ones(H),
             "head": Linear(awq=[head]), "layers": layers, "heads": 4, "kv_heads": 2,
             "head_dim": 64, "eps": 1e-5, "theta": cfg["rope_theta"], "top_k": 0}
    ids = np.random.default_rng(0).integers(0, V, 40)
    want = port_logits(rt, ids)
    got = reference.forward(model, [torch.as_tensor(ids)])[0]
    assert close(got, want, 1e-4)
    # the control departs from the float32 forward by far more
    low = reference.forward(model, [torch.as_tensor(ids)], low=True)[0]
    assert not close(low, want, 1e-2)


def test_int4f_fit_matches_the_port():
    from umbrella_tpu_torch.quantization.awq import awq_from_hf_tensors
    from umbrella_tpu_torch.quantization.int4f import dequantize_int4f, quantize_int4f

    gen = torch.Generator().manual_seed(5)
    t = mistral7b_awq._awq(gen, "cpu", 256, 384, 128, 0.00435, 0.25)
    port = dequantize_int4f(quantize_int4f(awq_from_hf_tensors(*t, dtype=torch.float32),
                                           refine=0), torch.float32)
    mine = reference.int4f_fit(reference.dequant_awq(*t), t[2])
    step = float(mine.abs().max()) / 7
    # equal but where a value sits on a rounding edge (one code apart)
    assert float((port - mine).abs().max()) <= 1.01 * step
    assert float(((port - mine).abs() > 1e-6).float().mean()) < 1e-3


def test_moe_forward_matches_the_port():
    from umbrella_tpu_torch.models.moe import moe_runtime

    cfg = copy.deepcopy(spec.load_json(spec.HERE, "configs", "mixtral8x7b.json"))
    cfg.update(TINY_MOE)
    cfg["draft"].update(TINY_DRAFT)
    built = mixtral8x7b.build(cfg, 11, torch.device("cpu"), L)
    t = built.target
    p32 = {k: (v.float() if isinstance(v, torch.Tensor) else v) for k, v in t.params.items()}
    p32["layers"] = {k: v.float() for k, v in t.params["layers"].items()}
    rt = moe_runtime(t.cfg, p32, L, dtype=torch.float32, top_k=2, device="cpu")
    ids = np.random.default_rng(1).integers(0, cfg["vocab_size"], 40)
    want = port_logits(rt, ids)
    got = reference.forward(built.reference, [torch.as_tensor(ids)])[0]
    assert close(got, want, 1e-4)


@pytest.mark.parametrize("rel", [2 ** -4])
def test_low_precision_is_float8(rel):
    x = torch.randn(8, 256, generator=torch.Generator().manual_seed(0))
    y = reference.low_precision(x)
    assert float(((y - x).abs() / x.abs().amax(dim=-1, keepdim=True)).max()) <= rel
    assert not torch.equal(y, x)
