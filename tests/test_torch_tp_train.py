"""The port's tensor- and sequence-parallel training (parallel/mesh.
shard_train_params, training/draft_trainer.train_forward over shards,
training/data_parallel's (data, model) grid, train_draft --tp) against the
JAX package on the CPU.

Weights: the JAX tests' config (vocab 256, hidden 128, intermediate 256, 2
layers, 8/4 heads, fp32; tests/test_training_and_parallel.py's `_cfg(4)`),
JAX's `init_llama_params(packed=False)` carried across with
`train_params_from_numpy`. JAX runs `jit(make_train_step)` over
`make_mesh(model=4, data=2)` on the 8 virtual CPU devices, the batch sharded
P("data"), as its `test_tp_dp_sharded_train_step` and
`test_sp_sharded_train_step` do; the port runs the same grid, two replicas
of four shards (every device the CPU).

Tolerances: losses within 1e-5 relative over 3 steps; every gradient within
1e-4 x the leaf's max|grad|; params after 3 AdamW steps within
assert_adam_close (2e-4, but for at most 1e-4 of the elements); the
sequence-parallel step equal to the tensor-parallel one bit for bit (losses,
gradients, params).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from umbrella_tpu.config import ModelConfig
from umbrella_tpu.models.llama import StaticModelArgs as JaxArgs
from umbrella_tpu.models.llama import init_llama_params as jax_init
from umbrella_tpu.parallel.mesh import make_mesh, shard_params
from umbrella_tpu.training import draft_trainer as jdt
from umbrella_tpu_torch.models.convert import config_from, train_params_from_numpy
from umbrella_tpu_torch.models.llama import StaticModelArgs
from umbrella_tpu_torch.parallel.mesh import gather_train_params, shard_train_params
from umbrella_tpu_torch.training import draft_trainer as tdt
from umbrella_tpu_torch.training import train_draft
from umbrella_tpu_torch.training.data_parallel import make_dp_train_step

torch.set_num_threads(1)  # several test processes share the cores (test_torch_batched.py)

CPU = torch.device("cpu")
LR, TOTAL, STEPS = 3e-4, 10, 3


def _cfg(tied=False):
    return ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                       num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
                       max_position_embeddings=128, eos_token_id=2, tie_word_embeddings=tied)


def _setup(tied=False, seed=0):
    cfg = _cfg(tied)
    jp = jax_init(cfg, jax.random.PRNGKey(seed), 128, jnp.float32, packed=False)
    return (cfg, jp, jax.tree_util.tree_map(np.asarray, jp), JaxArgs.from_config(cfg),
            StaticModelArgs.from_config(config_from(cfg)))


def _ids(B=4, S=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def assert_adam_close(got, ref, lr, steps, what=""):
    """Params after `steps` AdamW steps at rate <= lr: within 2e-4 of the
    reference, except at most 1e-4 of the elements, which lie within one
    step's reach of it each step (Adam divides each gradient by its own
    running RMS, so a gradient at fp32's noise takes a step of any sign)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert diff.max() <= steps * 1.5 * lr, (what, diff.max())
    assert (diff > 2e-4).mean() <= 1e-4, (what, int((diff > 2e-4).sum()), diff.size)


def _walk(j, t, fn, path=""):
    """fn(path, jax leaf, port leaf) over the two trees' leaves."""
    if isinstance(j, dict):
        for k in j:
            _walk(j[k], t[k], fn, f"{path}/{k}")
    else:
        fn(path, np.asarray(j), t)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _jax_run(jp, ja, ids, sequence_parallel):
    """JAX's grid: 3 jitted steps over make_mesh(model=4, data=2) -> (losses,
    final params as numpy)."""
    mesh = make_mesh(model=4, data=2)
    opt = jdt.make_optimizer(lr=LR, total_steps=TOTAL)
    state = jdt.init_train_state(shard_params(jp, mesh), opt)
    step = jax.jit(jdt.make_train_step(ja, opt, sequence_parallel=sequence_parallel))
    batch = jax.device_put(ids, NamedSharding(mesh, P("data", None)))
    losses = []
    with mesh:
        for _ in range(STEPS):
            state, loss = step(state, batch)
            losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


def _port_run(np_params, ta, ids, sequence_parallel):
    """The port's grid: two replicas (data) of four shards (model) -> (losses,
    the gathered params, the sharded state)."""
    params = shard_train_params(train_params_from_numpy(np_params), [CPU] * 4)
    state = tdt.init_train_state(params, tdt.make_optimizer(lr=LR, total_steps=TOTAL))
    step = make_dp_train_step(ta, None, [[CPU] * 4] * 2, sequence_parallel=sequence_parallel)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, torch.from_numpy(ids))
        losses.append(float(loss))
    return losses, gather_train_params(state.params), state


@pytest.mark.parametrize("sequence_parallel", [False, True], ids=["tp_dp", "sp"])
def test_sharded_train_step_matches_jax(sequence_parallel):
    """JAX's test_tp_dp_sharded_train_step and test_sp_sharded_train_step:
    the (data=2, model=4) step's losses and params after 3 steps, and the
    shards still split over the model axis afterwards (JAX checks the
    sharding spec)."""
    cfg, jp, np_params, ja, ta = _setup()
    ids = _ids()
    jlosses, jparams = _jax_run(jp, ja, ids, sequence_parallel)
    losses, params, state = _port_run(np_params, ta, ids, sequence_parallel)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    _walk(jparams, params, lambda path, r, leaf: assert_adam_close(
        leaf.numpy(), r, LR, STEPS, path))
    shards = state.params["tp_shards"]
    assert len(shards) == 4
    for sh in shards:
        assert sh["layers"]["wq"].shape == (2, 128, 128 // 4)
        assert sh["layers"]["wo"].shape == (2, 128 // 4, 128)
        assert sh["layers"]["down"].shape == (2, 256 // 4, 128)
        assert sh["lm_head"].shape == (128, 256 // 4)
        assert all(t.is_leaf and t.requires_grad for _, t in _leaves(sh))
    assert "wq" not in state.params["layers"] and "lm_head" not in state.params


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("sequence_parallel", [False, True], ids=["tp", "sp"])
def test_sharded_gradients_match_jax_grad(tied, sequence_parallel):
    """Every gradient of one full-batch step over 4 shards within 1e-4 x its
    max of jax.grad's (the rope leaves included), the loss within 1e-5."""
    cfg, jp, np_params, ja, ta = _setup(tied)
    ids = _ids()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, i: jdt.causal_lm_loss(p, ja, i, sequence_parallel=False)))(jp, ids)
    params = shard_train_params(train_params_from_numpy(np_params), [CPU] * 4)
    loss = tdt.causal_lm_loss(params, ta, torch.from_numpy(ids),
                              sequence_parallel=sequence_parallel)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    grads = gather_train_params(params, lambda t: t.grad)

    def check(path, ref, g):
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=path)

    _walk(jgrads, grads, check)
    assert float(grads["rope_inv_freq"].abs().max()) > 0


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_sequence_parallel_equals_tensor_parallel_bit_for_bit(tied):
    """In fp32 the SP layout sums the TP layout's values in the same order:
    the logits, the loss and every gradient are the same bits, and so are
    the params and losses after 3 grid steps."""
    cfg, jp, np_params, ja, ta = _setup(tied)
    ids = torch.from_numpy(_ids())
    out = {}
    for sp in (False, True):
        params = shard_train_params(train_params_from_numpy(np_params), [CPU] * 4)
        logits = tdt.train_forward(params, ta, ids, sequence_parallel=sp)
        loss = tdt.lm_loss(logits, ids)
        loss.backward()
        out[sp] = (logits.detach(), loss.detach(), dict(_leaves(
            gather_train_params(params, lambda t: t.grad))))
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])
    for path, g in out[False][2].items():
        assert torch.equal(g, out[True][2][path]), path
    runs = [_port_run(np_params, ta, _ids(), sp) for sp in (False, True)]
    assert runs[0][0] == runs[1][0]
    for (path, a), (_, b) in zip(_leaves(runs[0][1]), _leaves(runs[1][1])):
        assert torch.equal(a, b), path


def test_shard_and_gather_are_inverse():
    """shard_train_params cuts columns (wq/wk/wv/gate/up, the head's vocab)
    and rows (wo, down) into new leaves; gather_train_params reassembles the
    tree bit for bit."""
    cfg, jp, np_params, ja, ta = _setup()
    params = train_params_from_numpy(np_params)
    sharded = shard_train_params(params, [CPU] * 4)
    back = gather_train_params(sharded)
    assert set(back) == set(params) and set(back["layers"]) == set(params["layers"])
    _walk(np_params, back, lambda path, ref, t: np.testing.assert_array_equal(
        t.numpy(), ref, err_msg=path))
    assert sharded["embed"] is not params["embed"]
    assert all(t.is_leaf and t.requires_grad for _, t in _leaves(sharded))
    with pytest.raises(ValueError, match="packed"):
        shard_train_params(train_params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jax_init(cfg, jax.random.PRNGKey(0), 128, jnp.float32, packed=True))),
            [CPU] * 2)


def test_sharded_step_refuses_indivisible_heads():
    cfg, jp, np_params, ja, ta = _setup()
    params = shard_train_params(train_params_from_numpy(np_params), [CPU] * 2)
    with pytest.raises(ValueError, match="divisible"):
        tdt.train_forward(params, ta._replace(num_kv_heads=3), torch.from_numpy(_ids()))


def test_train_draft_tp2_trains_and_saves_a_whole_checkpoint(tmp_path):
    """train_draft --tp 2 --dp 2 on the CPU: the loss falls on a periodic
    stream, and the checkpoint holds whole, unpacked params that serve: the
    engines' forward over them gives the sharded model's logits."""
    from umbrella_tpu_torch.config import ModelConfig as PortConfig
    from umbrella_tpu_torch.models.auto_model import ModelRuntime
    from umbrella_tpu_torch.models.convert import serving_params
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    tiny = dict(model_type="llama", vocab_size=128, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                max_position_embeddings=64, eos_token_id=2, tie_word_embeddings=False)
    cfg_path = os.path.join(tmp_path, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(tiny, f)
    rng = np.random.default_rng(0)
    data = os.path.join(tmp_path, "tokens.npy")
    np.save(data, np.tile(rng.integers(0, 128, 17), 120)[:2000].astype(np.int32))
    out = os.path.join(tmp_path, "ckpt")
    losses = train_draft.main(["--config", cfg_path, "--data", data, "--output_dir", out,
                               "--device", "cpu", "--batch_size", "4", "--seq_len", "32",
                               "--steps", "40", "--save_steps", "40", "--lr", "1e-2",
                               "--tp", "2", "--dp", "2"])
    assert len(losses) == 40 and np.mean(losses[-5:]) < losses[0] - 1.0
    ck = torch.load(os.path.join(out, "ckpt_40.pt"), weights_only=False)
    p = ck["params"]
    assert "tp_shards" not in p and "wqkv" not in p["layers"]
    assert p["layers"]["wq"].shape == (2, 32, 32) and p["layers"]["down"].shape == (2, 64, 32)
    assert p["lm_head"].shape == (32, 128)
    cfg = PortConfig.from_dict(tiny)
    rt = ModelRuntime(cfg, serving_params(p), 64, dtype=torch.bfloat16, device="cpu")
    ids = torch.arange(10)
    logits = rt.forward(rt.params, rt.init_kv(), ids, torch.arange(10),
                        causal_mask_rows(0, 10, 64), 0)[0]
    sharded = shard_train_params(tdt.map_params(lambda t: t.requires_grad_(), p), [CPU] * 2)
    want = tdt.train_forward(sharded, StaticModelArgs.from_config(cfg), ids[None])[0].detach()
    torch.testing.assert_close(logits, want, rtol=0, atol=2e-2 * float(want.abs().max()))
