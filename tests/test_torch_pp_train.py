"""The port's GPipe training (parallel/pipeline.py: pp_layer_specs,
shard_params_pp, make_pp_forward, make_pp_train_step) against the unstaged
trainer and the JAX package's pipe mesh on the CPU.

Weights: the JAX package's `init_llama_params` (4 layers, hidden 64, 4/2
heads, vocab 211, fp32, unpacked), as in tests/test_pp_ep.py; stages on
repeated CPU devices (a device may repeat, as one card holds every stage).
JAX runs under `jax.jit` on a `pipe` mesh of virtual CPU devices.

Tolerances: logits within 1e-5 x max|logit| (fp32; microbatches change only
the products' row counts); losses within 1e-6 relative; gradients within
1e-4 x the leaf's max|grad|; params after 3 AdamW steps (lr 1e-2) within
2e-4 absolute but for at most 1e-4 of the elements (assert_adam_close says
why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from umbrella_tpu.config import ModelConfig
from umbrella_tpu.models.llama import StaticModelArgs as JaxArgs
from umbrella_tpu.models.llama import init_llama_params as jax_init
from umbrella_tpu.parallel import pipeline as jpp
from umbrella_tpu.training import draft_trainer as jdt
from umbrella_tpu_torch.models.convert import config_from, train_params_from_numpy
from umbrella_tpu_torch.models.llama import StaticModelArgs
from umbrella_tpu_torch.parallel import pipeline as tpp
from umbrella_tpu_torch.training import draft_trainer as tdt

torch.set_num_threads(1)  # several test processes share the cores (test_torch_batched.py)

CFG = ModelConfig(vocab_size=211, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                  eos_token_id=2)
JA = JaxArgs.from_config(CFG)
TA = StaticModelArgs.from_config(config_from(CFG))


def assert_adam_close(got, ref, lr, steps, what=""):
    """Params after `steps` AdamW steps at rate <= lr: within 2e-4 of the
    reference, except at most 1e-4 of the elements, which lie within one
    step's reach of it each step (steps x 1.5 lr): Adam divides each gradient
    by its own running RMS, so an element whose gradient sits at fp32's noise
    takes a step of any sign on either side."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert diff.max() <= steps * 1.5 * lr, (what, diff.max())
    assert (diff > 2e-4).mean() <= 1e-4, (what, int((diff > 2e-4).sum()), diff.size)


def _params(seed=0):
    jp = jax_init(CFG, jax.random.PRNGKey(seed), 128, jnp.float32, packed=False)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _ids(B=4, S=16, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S)).astype(np.int32)


def _pipe_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("pipe",))


@pytest.mark.parametrize("n_stages", [2, 4])
@pytest.mark.parametrize("n_micro", [2, 4])
def test_pp_forward_matches_unstaged_and_jax(n_stages, n_micro):
    jp, np_params = _params()
    ids = _ids(B=8 if n_micro == 4 else 4)
    mesh = _pipe_mesh(n_stages)
    ref = np.asarray(jax.jit(jpp.make_pp_forward(JA, mesh, n_micro))(
        jpp.shard_params_pp(jp, mesh), ids))
    unstaged = tdt.train_forward(train_params_from_numpy(np_params), TA,
                                 torch.from_numpy(ids)).detach().numpy()
    devices = ["cpu"] * n_stages
    staged = tpp.shard_params_pp(train_params_from_numpy(np_params), devices)
    got = tpp.make_pp_forward(TA, devices, n_micro)(staged, torch.from_numpy(ids))
    tol = 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=tol)
    np.testing.assert_allclose(got.detach().numpy(), unstaged, rtol=0, atol=tol)


def test_stage_placement():
    jp, np_params = _params()
    params = train_params_from_numpy(np_params)
    specs = tpp.pp_layer_specs(params, 2)
    assert specs["layers"]["wq"] == [(0, 2), (2, 4)] and specs["embed"] is None
    staged = tpp.shard_params_pp(params, ["cpu", "cpu"])
    assert [st["wq"].shape[0] for st in staged["stages"]] == [2, 2]
    assert all(t.is_leaf and t.requires_grad for st in staged["stages"] for t in st.values())
    assert staged["rope_scale"].requires_grad and "layers" not in staged
    back = tpp.unstage_params(staged)
    for k, v in params["layers"].items():
        assert torch.equal(back["layers"][k], v.detach()), k
    # the staged leaves are copies: training them leaves the unstaged tree alone
    with torch.no_grad():
        staged["stages"][0]["wq"].add_(1.0)
    assert not torch.equal(tpp.unstage_params(staged)["layers"]["wq"], params["layers"]["wq"])


def test_pp_train_step_matches_unstaged_and_jax():
    jp, np_params = _params(seed=2)
    ids = _ids(seed=3)
    mesh = _pipe_mesh(4)
    jopt = jdt.make_optimizer(lr=1e-2, total_steps=30)
    jstate = jdt.init_train_state(jpp.shard_params_pp(jp, mesh), jopt)
    jstep = jax.jit(jpp.make_pp_train_step(JA, jopt, mesh, n_micro=2))

    devices = ["cpu"] * 4
    staged = tpp.shard_params_pp(train_params_from_numpy(np_params), devices)
    state = tdt.init_train_state(staged, tdt.make_optimizer(lr=1e-2, total_steps=30))
    step = tpp.make_pp_train_step(TA, None, devices, n_micro=2)
    flat = train_params_from_numpy(np_params)
    ustate = tdt.init_train_state(flat, tdt.make_optimizer(lr=1e-2, total_steps=30))
    ustep = tdt.make_train_step(TA, None)

    # one step's loss and gradients against the unstaged step's
    forward = tpp.make_pp_forward(TA, devices, 2)
    loss = tdt.lm_loss(forward(staged, torch.from_numpy(ids)), torch.from_numpy(ids))
    loss.backward()
    uloss = tdt.causal_lm_loss(flat, TA, torch.from_numpy(ids))
    uloss.backward()
    assert float(loss.detach()) == pytest.approx(float(uloss.detach()), rel=1e-6)
    grads = tpp.unstage_params(staged, lambda t: t.grad)
    for k, g in flat["layers"].items():
        torch.testing.assert_close(grads["layers"][k], g.grad, rtol=0,
                                   atol=1e-4 * float(g.grad.abs().max()), msg=k)
    for k in ("embed", "lm_head", "final_norm", "rope_inv_freq", "rope_scale"):
        torch.testing.assert_close(grads[k], flat[k].grad, rtol=0,
                                   atol=1e-4 * float(flat[k].grad.abs().max()), msg=k)
    for t in tdt.param_leaves(staged):
        t.grad = None
    for t in tdt.param_leaves(flat):
        t.grad = None

    for _ in range(3):
        jstate, jloss = jstep(jstate, ids)
        state, loss = step(state, torch.from_numpy(ids))
        ustate, uloss = ustep(ustate, torch.from_numpy(ids))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
        assert float(loss) == pytest.approx(float(uloss), rel=1e-6)
    got = tpp.unstage_params(staged)
    for k, v in jstate.params["layers"].items():
        assert_adam_close(got["layers"][k].numpy(), v, 1e-2, 3, k)
        assert_adam_close(got["layers"][k].numpy(), flat["layers"][k].detach().numpy(), 1e-2, 3,
                          k)


def test_n_micro_must_divide_the_batch():
    jp, np_params = _params()
    staged = tpp.shard_params_pp(train_params_from_numpy(np_params), ["cpu"] * 2)
    with pytest.raises(ValueError, match="must divide batch size 6"):
        tpp.make_pp_forward(TA, ["cpu"] * 2, 4)(staged, torch.from_numpy(_ids(B=6)))
    with pytest.raises(ValueError, match="divisible"):
        tpp.shard_params_pp(train_params_from_numpy(np_params), ["cpu"] * 3)
