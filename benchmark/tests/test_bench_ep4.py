"""The four-card Mixtral builder (configs/mixtral8x7b_ep4.py) at a tiny size
on the CPU, its four "cards" all the CPU: the port gets an expert-sharded
runtime, its forward through the cache matches the plain reference on the
same tensors, and the shards' parts add up to the whole layer."""
import copy

import numpy as np
import torch

from benchmark import reference, spec
from benchmark.configs import mixtral8x7b_ep4
from benchmark.tests.tiny import TINY_DRAFT, TINY_MOE

L = 64


def tiny_build(seed=13):
    cfg = copy.deepcopy(spec.load_json(spec.HERE, "configs", "mixtral8x7b_ep4.json"))
    cfg.update(TINY_MOE)
    cfg["draft"].update(TINY_DRAFT)
    return cfg, mixtral8x7b_ep4.build(cfg, seed, torch.device("cpu"), L)


def fp32_runtime(t):
    """The built target with every tensor in float32, its shards kept."""
    from umbrella_tpu_torch.models.moe import ExpertShard, ShardedExperts, moe_runtime

    p32 = {k: (v.float() if isinstance(v, torch.Tensor) else v) for k, v in t.params.items()}
    layers = dict(t.params["layers"])
    shards = layers.pop("expert_shards").shards
    p32["layers"] = {k: v.float() for k, v in layers.items()}
    p32["layers"]["expert_shards"] = ShardedExperts(
        ExpertShard(s.device, s.gate.float(), s.up.float(), s.down.float()) for s in shards)
    return moe_runtime(t.cfg, p32, L, dtype=torch.float32, top_k=2, device="cpu")


def test_the_port_gets_four_shards():
    cfg, built = tiny_build()
    assert len(built.target.shard_devices) == 4 == cfg["bench"]["expert_parallel"]
    assert "expert_gate" not in built.target.params["layers"]
    gate = built.reference["layers"][1]["experts"][0]
    assert len(gate) == cfg["num_local_experts"]
    shards = built.target.params["layers"]["expert_shards"].shards
    assert torch.equal(gate[3], shards[3].gate[1, 0])


def test_prefill_then_decode_through_the_cache_matches_the_reference():
    """A prompt's prefill, then one token at a time through the cache, as the
    static engine runs the target, in float32 on both sides. Tolerance 1e-4
    of the largest |logit|: both sum in float32, in other orders (the port's
    dense dispatch adds every expert at weight 0 and the four shards' parts;
    the reference the two chosen experts), which parts them by ~1e-6; one
    bf16 rounding anywhere (2^-8) would not pass it."""
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    cfg, built = tiny_build()
    rt = fp32_runtime(built.target)
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, cfg["vocab_size"], 40))
    P = 24
    kv = rt.init_kv()
    first, _ = rt.forward(rt.params, kv, ids[:P].int(), torch.arange(P),
                          causal_mask_rows(0, P, L), 0)
    rows = [first.float()]
    for p in range(P, len(ids)):
        logits, _ = rt.forward(rt.params, kv, ids[p:p + 1].int(), torch.arange(p, p + 1),
                               causal_mask_rows(p, 1, L), p)
        rows.append(logits.float())
    got = torch.cat(rows)
    want = reference.forward(built.reference, [ids])[0]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_the_shards_parts_add_up_to_the_whole_layer():
    """Each shard's part (its experts' weighted outputs, the other experts'
    weights zero) summed over the four shards is the reference's MoE of the
    whole layer."""
    from umbrella_tpu_torch.models.moe import ShardedExperts, route

    cfg, built = tiny_build()
    rt = fp32_runtime(built.target)
    i = 1
    lw = {k: v[i] for k, v in rt.params["layers"].items()}
    x = torch.randn(16, cfg["hidden_size"], generator=torch.Generator().manual_seed(4))
    weights = route(lw, x, 2)[2]
    shards = lw["expert_shards"].shards
    per = cfg["num_local_experts"] // len(shards)
    parts = [ShardedExperts([sh]).combine(x, weights[:, s * per:(s + 1) * per])
             for s, sh in enumerate(shards)]
    whole = reference.moe(built.reference["layers"][i], x, 2, low=False)[0]
    assert float((sum(parts) - whole).abs().max()) <= 1e-5 * float(whole.abs().max())
    assert all(float(p.abs().max()) > 0 for p in parts)
