"""The port's expert-parallel MoE training (models/moe.py: shard_params_ep,
ShardedExperts as trainable leaves, moe_grid_forward's data axis,
make_moe_train_step over rows) against the JAX package and the unsharded
port on the CPU.

Weights: tests/test_pp_ep.py's config (vocab 211, hidden 64, intermediate
128, 2 layers, 4/2 heads, 4 experts, top-2, fp32) from JAX's
`init_moe_llama_params`, carried across with `train_params_from_numpy`. JAX
runs jitted over `Mesh(devices.reshape(2, 4), ("data", "expert"))` with the
batch sharded P("data") (its test_ep_sharded_moe_matches_unsharded) and over
an ("expert",) mesh of 4 (its test_moe_train_step_loss_decreases).

Tolerances: logits within 2e-4 and the aux loss within 1e-4 relative (JAX's
own test's); gradients within 1e-4 x the leaf's max|grad|; losses within
1e-5 relative; params after 3 AdamW steps within assert_adam_close.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from umbrella_tpu.config import ModelConfig
from umbrella_tpu.models import moe as jax_moe
from umbrella_tpu.models.llama import StaticModelArgs as JaxArgs
from umbrella_tpu.training import draft_trainer as jdt
from umbrella_tpu_torch.models import moe
from umbrella_tpu_torch.models.convert import config_from, train_params_from_numpy
from umbrella_tpu_torch.models.llama import StaticModelArgs
from umbrella_tpu_torch.training import draft_trainer as tdt
from umbrella_tpu_torch.training.data_parallel import place_params

torch.set_num_threads(1)  # several test processes share the cores (test_torch_batched.py)

CPU = torch.device("cpu")
CFG = ModelConfig(vocab_size=211, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                  eos_token_id=2)
JA = JaxArgs.from_config(CFG)
TA = StaticModelArgs.from_config(config_from(CFG))


def assert_adam_close(got, ref, lr, steps, what=""):
    """Params after `steps` AdamW steps at rate <= lr: within 2e-4 of the
    reference, except at most 1e-4 of the elements (Adam divides each
    gradient by its own running RMS, so a gradient at fp32's noise takes a
    step of any sign)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert diff.max() <= steps * 1.5 * lr, (what, diff.max())
    assert (diff > 2e-4).mean() <= 1e-4, (what, int((diff > 2e-4).sum()), diff.size)


def _params(seed):
    jp = jax_moe.init_moe_llama_params(CFG, jax.random.PRNGKey(seed), n_experts=4)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape).astype(np.int32)


def _named(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{path}/{k}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def test_ep_sharded_moe_matches_unsharded():
    """JAX's test: over a (data=2, expert=4) grid -- two replicas, each
    expert-sharded in 4 -- the logits and the aux loss of the whole batch
    equal the unsharded forward's (JAX's and the port's)."""
    jp, np_params = _params(0)
    ids = _ids((2, 16), 0)
    ref_logits, ref_aux = jax_moe.moe_train_forward(jp, JA, jnp.asarray(ids))
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "expert"))
    j_logits, j_aux = jax.jit(lambda p, i: jax_moe.moe_train_forward(p, JA, i))(
        jax_moe.shard_params_ep(jp, mesh), jax.device_put(ids, NamedSharding(mesh, P("data",
                                                                                   None))))
    ep = moe.shard_params_ep(train_params_from_numpy(np_params), [CPU] * 4)
    replicas = [ep, place_params(ep, [CPU] * 4)]
    logits, aux = moe.moe_grid_forward(replicas, TA, torch.from_numpy(ids))
    for want, want_aux in ((ref_logits, ref_aux), (j_logits, j_aux)):
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
        assert float(aux.detach()) == pytest.approx(float(want_aux), rel=1e-4)
    whole, whole_aux = moe.moe_train_forward(train_params_from_numpy(np_params), TA,
                                             torch.from_numpy(ids))
    np.testing.assert_allclose(logits.detach().numpy(), whole.detach().numpy(), rtol=2e-4,
                               atol=2e-4)
    assert float(aux.detach()) == pytest.approx(float(whole_aux.detach()), rel=1e-4)


def test_ep_shards_are_trainable_leaves():
    """Each ExpertShard's gate, up and down are leaves that require grad,
    walked by param_leaves and rebuilt by map_params (the shard's device
    kept); gather_params_ep inverts shard_params_ep bit for bit."""
    jp, np_params = _params(0)
    params = train_params_from_numpy(np_params)
    ep = moe.shard_params_ep(params, [CPU] * 4)
    shards = ep["layers"]["expert_shards"].shards
    assert len(shards) == 4 and shards[0].gate.shape == (2, 1, 64, 128)
    leaves = list(tdt.param_leaves(ep))
    assert all(t.is_leaf and t.requires_grad for t in leaves)
    assert sum(t.numel() for t in leaves) == sum(t.numel() for t in tdt.param_leaves(params))
    for sh in shards:
        assert any(t is sh.down for t in leaves)
    mapped = tdt.map_params(lambda t: t * 2, ep)
    assert isinstance(mapped["layers"]["expert_shards"], moe.ShardedExperts)
    assert mapped["layers"]["expert_shards"].shards[1].device == CPU
    assert torch.equal(mapped["layers"]["expert_shards"].shards[1].up, shards[1].up * 2)
    back = moe.gather_params_ep(ep)
    for path, t in _named(params):
        assert torch.equal(dict(_named(back))[path], t.detach()), path


def test_ep_gradients_match_jax_and_unsharded():
    """One step's loss (mean NLL + 0.01 aux) and every gradient, expert
    shards included, within 1e-4 x max of jax.grad's and of the unsharded
    port's."""
    jp, np_params = _params(1)
    ids = _ids((4, 16), 7)

    def jloss(p, i):
        logits, aux = jax_moe.moe_train_forward(p, JA, i)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(logp, i[:, 1:, None], axis=-1)[..., 0]
        return jnp.mean(nll) + 0.01 * aux

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jp, jnp.asarray(ids))
    grads = {}
    for name, shard in (("whole", False), ("ep", True)):
        params = train_params_from_numpy(np_params)
        if shard:
            params = moe.shard_params_ep(params, [CPU] * 4)
        logits, aux = moe.moe_train_forward(params, TA, torch.from_numpy(ids))
        loss = tdt.lm_loss(logits, torch.from_numpy(ids)) + 0.01 * aux
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
        g = moe.gather_params_ep(params, lambda t: t.grad) if shard else \
            tdt.map_params(lambda t: t.grad, params)
        grads[name] = dict(_named(g))
    for path, g in grads["ep"].items():
        ref = np.asarray(jgrads[path.split("/")[1]] if path.count("/") == 1
                         else jgrads["layers"][path.split("/")[2]])
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=path)
        w = grads["whole"][path]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()), err_msg=path)


def test_moe_train_step_loss_decreases():
    """JAX's test over an ("expert",) mesh of 4: lr 1e-2, 13 steps on one
    batch, the loss falls; the port's EP step gives JAX's first three
    losses within 1e-5."""
    jp, np_params = _params(5)
    ids = _ids((4, 16), 7)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("expert",))
    jopt = jdt.make_optimizer(lr=1e-2, total_steps=30)
    jstate = jdt.init_train_state(jax_moe.shard_params_ep(jp, mesh), jopt)
    jstep = jax.jit(jax_moe.make_moe_train_step(JA, jopt))
    params = moe.shard_params_ep(train_params_from_numpy(np_params), [CPU] * 4)
    state = tdt.init_train_state(params, tdt.make_optimizer(lr=1e-2, total_steps=30))
    step = moe.make_moe_train_step(TA, None)
    losses, jlosses = [], []
    for i in range(13):
        state, loss = step(state, torch.from_numpy(ids))
        losses.append(float(loss))
        if i < 3:
            jstate, jl = jstep(jstate, jnp.asarray(ids))
            jlosses.append(float(jl))
    np.testing.assert_allclose(losses[:3], jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]


def test_ep_grid_train_step_matches_unsharded():
    """make_moe_train_step over a (data=2, expert=4) grid: 3 steps give the
    unsharded step's losses (1e-5) and params (assert_adam_close)."""
    jp, np_params = _params(5)
    ids = torch.from_numpy(_ids((4, 16), 7))
    runs = {}
    for name in ("whole", "grid"):
        params = train_params_from_numpy(np_params)
        devices = None
        if name == "grid":
            params = moe.shard_params_ep(params, [CPU] * 4)
            devices = [[CPU] * 4] * 2
        state = tdt.init_train_state(params, tdt.make_optimizer(lr=1e-2, total_steps=30))
        step = moe.make_moe_train_step(TA, None, devices=devices)
        losses = []
        for _ in range(3):
            state, loss = step(state, ids)
            losses.append(float(loss))
        runs[name] = (losses, params)
    np.testing.assert_allclose(runs["grid"][0], runs["whole"][0], rtol=1e-5)
    whole = dict(_named(tdt.map_params(lambda t: t.detach(), runs["whole"][1])))
    for path, t in _named(moe.gather_params_ep(runs["grid"][1])):
        assert_adam_close(t.numpy(), whole[path].numpy(), 1e-2, 3, path)
