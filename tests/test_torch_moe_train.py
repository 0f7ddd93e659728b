"""The port's MoE training (models/moe.py: _moe_layer, moe_train_forward,
make_moe_train_step) against the JAX package on the CPU.

Weights: the JAX package's `init_moe_llama_params` (2 layers of 4 experts,
top-2, hidden 64, 4/2 heads, vocab 211, fp32), as in tests/test_pp_ep.py.
JAX runs under `jax.jit`.

Tolerances: logits within 1e-5 x max|logit| and the aux loss within 1e-6
relative (fp32); gradients within 1e-4 x the leaf's max|grad| (the router
through the softmax and the normalised top-k weights only); losses of 3
AdamW steps (lr 1e-2) within 1e-6 relative, params within 2e-4 absolute
but for at most 1e-4 of the elements (assert_adam_close says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umbrella_tpu.config import ModelConfig
from umbrella_tpu.models import moe as jax_moe
from umbrella_tpu.models.llama import StaticModelArgs as JaxArgs
from umbrella_tpu.training import draft_trainer as jdt
from umbrella_tpu_torch.models import moe
from umbrella_tpu_torch.models.convert import config_from, train_params_from_numpy
from umbrella_tpu_torch.models.llama import StaticModelArgs
from umbrella_tpu_torch.training import draft_trainer as tdt

torch.set_num_threads(1)  # several test processes share the cores (test_torch_batched.py)

CFG = ModelConfig(vocab_size=211, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
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


def _setup(seed=5):
    jp = jax_moe.init_moe_llama_params(CFG, jax.random.PRNGKey(seed), n_experts=4)
    ids = np.random.default_rng(7).integers(0, CFG.vocab_size, (4, 16)).astype(np.int32)
    return jp, train_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)), ids


def test_moe_train_forward_matches_jax():
    jp, params, ids = _setup()
    ref, ref_aux = jax.jit(lambda p, i: jax_moe.moe_train_forward(p, JA, i))(jp, ids)
    logits, aux = moe.moe_train_forward(params, TA, torch.from_numpy(ids))
    ref = np.asarray(ref)
    assert logits.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(logits.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert float(aux.detach()) == pytest.approx(float(ref_aux), rel=1e-6)


def test_moe_gradients_match_jax_grad():
    jp, params, ids = _setup(seed=1)

    def jloss(p, i):
        logits, aux = jax_moe.moe_train_forward(p, JA, i)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(logp, i[:, 1:, None], axis=-1)[..., 0]
        return jnp.mean(nll) + 0.01 * aux

    jgrads = jax.jit(jax.grad(jloss))(jp, ids)
    logits, aux = moe.moe_train_forward(params, TA, torch.from_numpy(ids))
    (tdt.lm_loss(logits, torch.from_numpy(ids)) + 0.01 * aux).backward()
    for k, g in jgrads["layers"].items():
        g = np.asarray(g)
        np.testing.assert_allclose(params["layers"][k].grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)
    assert float(params["layers"]["router"].grad.abs().max()) > 0
    for k in ("embed", "lm_head", "rope_inv_freq"):
        g = np.asarray(jgrads[k])
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


def test_three_moe_train_steps_match_jax():
    jp, params, ids = _setup()
    jopt = jdt.make_optimizer(lr=1e-2, total_steps=30)
    jstate = jdt.init_train_state(jp, jopt)
    jstep = jax.jit(jax_moe.make_moe_train_step(JA, jopt))
    state = tdt.init_train_state(params, tdt.make_optimizer(lr=1e-2, total_steps=30))
    step = moe.make_moe_train_step(TA, None)
    for _ in range(3):
        jstate, jloss = jstep(jstate, ids)
        state, loss = step(state, torch.from_numpy(ids))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    for k, v in jstate.params["layers"].items():
        assert_adam_close(params["layers"][k].detach().numpy(), v, 1e-2, 3, k)
