"""The port's draft trainer (training/draft_trainer.py, training/data_parallel.py,
the embedding lookup's gradient) against the JAX package on the CPU.

Weights: the JAX package's `init_llama_params` (2 layers, hidden 64, 4/2
heads, vocab 256, fp32) carried across with `train_params_from_numpy`; ids
from numpy's seeded generator. JAX runs under `jax.jit`, as its own tests run
the train step.

Tolerances: logits within 1e-5 x max|logit| (fp32, the same products in
another order); losses within 1e-6 relative; every gradient leaf within
1e-4 x the leaf's max|grad|; the learning-rate schedule within 1e-5 relative
or 1e-7 x lr (optax computes it in fp32, the cosine's argument too); params after 5
AdamW steps (lr 1e-2) within 2e-4 absolute (2% of one step) but for at
most 1e-4 of the elements (assert_adam_close says why); losses of the
data-parallel step within 1e-6 relative of the one-replica step.
"""
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
from umbrella_tpu_torch.models.convert import (config_from, serving_params,
                                               train_params_from_numpy)
from umbrella_tpu_torch.models.llama import StaticModelArgs
from umbrella_tpu_torch.ops.kernels.embed_gather import embed_gather_trainable
from umbrella_tpu_torch.ops.select import embed_lookup
from umbrella_tpu_torch.training import draft_trainer as tdt
from umbrella_tpu_torch.training.data_parallel import make_dp_train_step

torch.set_num_threads(1)  # several test processes share the cores (test_torch_batched.py)

LR, TOTAL = 1e-2, 30


def assert_adam_close(got, ref, lr, steps, what=""):
    """Params after `steps` AdamW steps at rate <= lr: within 2e-4 of the
    reference, except at most 1e-4 of the elements, which lie within one
    step's reach of it each step (steps x 1.5 lr): Adam divides each gradient
    by its own running RMS, so an element whose gradient sits at fp32's noise
    takes a step of any sign on either side."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert diff.max() <= steps * 1.5 * lr, (what, diff.max())
    assert (diff > 2e-4).mean() <= 1e-4, (what, int((diff > 2e-4).sum()), diff.size)


def _cfg(tied=False):
    return ModelConfig(vocab_size=256, hidden_size=64, intermediate_size=96,
                       num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=128, eos_token_id=2, tie_word_embeddings=tied)


def _setup(packed=True, tied=False, seed=0):
    cfg = _cfg(tied)
    jp = jax_init(cfg, jax.random.PRNGKey(seed), 128, jnp.float32, packed=packed)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return (cfg, jp, np_params, JaxArgs.from_config(cfg),
            StaticModelArgs.from_config(config_from(cfg)))


def _ids(B=2, S=16, seed=0, V=256):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


def _walk(j, t, fn, path=""):
    """fn(path, jax leaf, port leaf) over the two trees' leaves."""
    if isinstance(j, dict):
        for k in j:
            _walk(j[k], t[k], fn, f"{path}/{k}")
    else:
        fn(path, np.asarray(j), t)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_train_forward_matches_jax(packed, tied):
    cfg, jp, np_params, ja, ta = _setup(packed, tied)
    ids = _ids()
    ref = np.asarray(jax.jit(lambda p, i: jdt.train_forward(p, ja, i))(jp, ids))
    got = tdt.train_forward(train_params_from_numpy(np_params), ta, torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 256)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "loss_mask"])
def test_causal_lm_loss_matches_jax(masked):
    cfg, jp, np_params, ja, ta = _setup()
    ids = _ids(B=3)
    mask = None
    if masked:
        mask = np.ones(ids.shape, bool)
        mask[0, :9] = False
        mask[2, 4:] = False
    ref = float(jax.jit(lambda p, i, m: jdt.causal_lm_loss(p, ja, i, m))(
        jp, ids, None if mask is None else jnp.asarray(mask)))
    got = tdt.causal_lm_loss(train_params_from_numpy(np_params), ta, torch.from_numpy(ids),
                             None if mask is None else torch.from_numpy(mask))
    assert float(got.detach()) == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("packed,tied", [(True, False), (False, True)],
                         ids=["packed-untied", "unpacked-tied"])
def test_every_gradient_matches_jax_grad(packed, tied):
    cfg, jp, np_params, ja, ta = _setup(packed, tied)
    ids = _ids()
    jgrads = jax.jit(jax.grad(lambda p, i: jdt.causal_lm_loss(p, ja, i)))(jp, ids)
    params = train_params_from_numpy(np_params)
    tdt.causal_lm_loss(params, ta, torch.from_numpy(ids)).backward()
    seen = []

    def check(path, ref, leaf):
        seen.append(path)
        assert leaf.grad is not None, path
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=path)

    _walk(jgrads, params, check)
    # the rope leaves are trained, as JAX's make_train_step trains them (ROADMAP C)
    assert {"/rope_inv_freq", "/rope_scale", "/embed"} <= set(seen)
    assert float(params["rope_inv_freq"].grad.abs().max()) > 0
    assert params["rope_scale"].dim() == 0 and params["rope_scale"].dtype == torch.float32


@pytest.mark.parametrize("lr,total,warmup", [(LR, TOTAL, 200), (3e-4, 10000, 200),
                                             (1e-3, 7, 3)])
def test_schedule_matches_optax(lr, total, warmup):
    import optax

    jo_sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, min(warmup, max(total // 10, 1)), total)
    ref = np.asarray(jax.jit(jax.vmap(jo_sched))(jnp.arange(total + 1)))
    opt = tdt.make_optimizer(lr=lr, total_steps=total, warmup=warmup)
    got = np.asarray([opt.schedule(c) for c in range(total + 1)])
    assert got[0] == 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7 * lr)
    # LambdaLR hands the optimizer those rates, one per update
    p = torch.zeros(1, requires_grad=True)
    torch_opt, sched = opt.build({"p": p})
    for c in range(min(total, 40)):
        assert torch_opt.param_groups[0]["lr"] == pytest.approx(got[c], rel=1e-12, abs=0)
        torch_opt.step()
        sched.step()
    g = torch_opt.param_groups[0]
    assert g["betas"] == (0.9, 0.95) and g["eps"] == 1e-8 and g["weight_decay"] == 0.01


def test_optimizer_moments_take_the_param_dtype():
    params = {"w": torch.ones(4, dtype=torch.bfloat16, requires_grad=True),
              "s": torch.tensor(1.0, requires_grad=True)}
    state = tdt.init_train_state(params, tdt.make_optimizer(lr=LR, total_steps=TOTAL))
    (params["w"].float().sum() + params["s"]).backward()
    state, _ = tdt.optimizer_update(state, torch.zeros(()))
    opt_state = state.opt_state[0].state[params["w"]]
    assert opt_state["exp_avg"].dtype == torch.bfloat16
    assert opt_state["exp_avg_sq"].dtype == torch.bfloat16


def test_five_train_steps_match_jax():
    cfg, jp, np_params, ja, ta = _setup(packed=True, tied=False)
    ids = _ids(seed=3)
    jopt = jdt.make_optimizer(lr=LR, total_steps=TOTAL)
    jstate = jdt.init_train_state(jp, jopt)
    jstep = jax.jit(jdt.make_train_step(ja, jopt))
    params = train_params_from_numpy(np_params)
    state = tdt.init_train_state(params, tdt.make_optimizer(lr=LR, total_steps=TOTAL))
    step = tdt.make_train_step(ta, None)
    before = serving_params(params)
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in before.items()}
    for i in range(5):
        jstate, jloss = jstep(jstate, ids)
        state, loss = step(state, torch.from_numpy(ids))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
        if i == 0:  # the rate at count 0 is 0.0: the first update changes nothing
            for k in ("embed", "lm_head", "rope_inv_freq"):
                assert torch.equal(params[k].detach(), before[k]), k
            assert float(params["rope_scale"].detach()) == before["rope_scale"]
    assert state.step == 5

    def check(path, ref, leaf):
        assert_adam_close(leaf.detach().numpy(), ref, LR, 5, path)

    _walk(jax.tree_util.tree_map(np.asarray, jstate.params), params, check)
    # the rope leaves move, and as far as JAX moves them
    for k in ("rope_inv_freq", "rope_scale"):
        jmoved = np.abs(np.asarray(jstate.params[k]) - np_params[k]).max()
        moved = float((params[k].detach() - torch.as_tensor(before[k])).abs().max())
        assert jmoved > 1e-3 and moved == pytest.approx(float(jmoved), rel=1e-3), k


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "loss_mask"])
def test_data_parallel_matches_one_replica_and_jax(masked):
    cfg, jp, np_params, ja, ta = _setup(packed=False)
    ids = _ids(B=4, seed=5)
    mask = None
    if masked:
        mask = np.ones(ids.shape, bool)
        mask[0, :10] = False
        mask[3, 5:] = False
    # JAX: the batch sharded P("data") over a (data=2) mesh
    mesh = make_mesh(data=2)
    jopt = jdt.make_optimizer(lr=LR, total_steps=TOTAL)
    jstate = jdt.init_train_state(shard_params(jp, mesh), jopt)

    def jstep_fn(state, i, m):
        loss, grads = jax.value_and_grad(jdt.causal_lm_loss)(state.params, ja, i, m)
        updates, opt_state = jopt.update(grads, state.opt_state, state.params)
        import optax

        return jdt.TrainState(optax.apply_updates(state.params, updates), opt_state,
                              state.step + 1), loss

    jstep = jax.jit(jstep_fn)
    jids = jax.device_put(ids, NamedSharding(mesh, P("data", None)))
    jmask = None if mask is None else jax.device_put(mask, NamedSharding(mesh, P("data", None)))
    jlosses = []
    for _ in range(3):
        jstate, jloss = jstep(jstate, jids, jmask)
        jlosses.append(float(jloss))
    runs = {}
    for dp in (1, 2):
        params = train_params_from_numpy(np_params)
        state = tdt.init_train_state(params, tdt.make_optimizer(lr=LR, total_steps=TOTAL))
        step = make_dp_train_step(ta, None, ["cpu"] * dp)
        losses = []
        for _ in range(3):
            state, loss = step(state, torch.from_numpy(ids),
                               None if mask is None else torch.from_numpy(mask))
            losses.append(float(loss))
        runs[dp] = (losses, params)
    np.testing.assert_allclose(runs[2][0], runs[1][0], rtol=1e-6)
    np.testing.assert_allclose(runs[2][0], jlosses, rtol=1e-6)
    ref = jax.tree_util.tree_map(np.asarray, jstate.params)
    one = jax.tree_util.tree_map(np.asarray, serving_params(runs[1][1]))

    def check(path, r, leaf):
        assert_adam_close(leaf.detach().numpy(), r, LR, 3, path)

    _walk(ref, runs[2][1], check)
    _walk(one, runs[2][1], check)


def test_data_parallel_refuses_an_uneven_batch():
    cfg, jp, np_params, ja, ta = _setup()
    params = train_params_from_numpy(np_params)
    state = tdt.init_train_state(params, tdt.make_optimizer(lr=LR, total_steps=TOTAL))
    with pytest.raises(ValueError, match="split evenly"):
        make_dp_train_step(ta, None, ["cpu"] * 2)(state, torch.from_numpy(_ids(B=3)))


def test_sequence_parallel_is_the_identity_without_a_model_axis():
    cfg, jp, np_params, ja, ta = _setup()
    params = train_params_from_numpy(np_params)
    ids = torch.from_numpy(_ids())
    a = tdt.causal_lm_loss(params, ta, ids, sequence_parallel=True)
    b = tdt.causal_lm_loss(params, ta, ids, sequence_parallel=False)
    assert torch.equal(a, b)
    # JAX's sequence-parallel loss on a mesh without a model split agrees
    mesh = make_mesh(data=1)
    with mesh:
        ref = float(jax.jit(lambda p, i: jdt.causal_lm_loss(p, ja, i, sequence_parallel=True))(
            shard_params(jax_init(_cfg(), jax.random.PRNGKey(0), 128, jnp.float32,
                                  packed=False), mesh), _ids()))
    unpacked = train_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_init(_cfg(), jax.random.PRNGKey(0), 128, jnp.float32, packed=False)))
    assert float(tdt.causal_lm_loss(unpacked, ta, ids, sequence_parallel=True).detach()) == \
        pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_embed_gather_backward_sums_repeated_ids(dtype):
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(50, 24, generator=gen).to(dtype)
    ids = torch.tensor([3, 7, 3, 3, 49, 0, 7, 12], dtype=torch.int32)
    upstream = torch.randn(8, 24, generator=gen).to(dtype)
    a = table.clone().requires_grad_()
    out = embed_gather_trainable(a, ids)
    assert out.grad_fn is not None and torch.equal(out.detach(), table[ids.long()])
    out.backward(upstream)
    b = table.clone().requires_grad_()
    b[ids.long()].backward(upstream)
    assert a.grad.dtype == dtype
    tol = 0 if dtype == torch.float32 else 2 ** -7 * float(b.grad.abs().max())
    torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=0, atol=tol + 1e-6)
    # repeated ids are summed: row 3 took three rows of the upstream gradient
    torch.testing.assert_close(a.grad[3].float(), upstream[[0, 2, 3]].float().sum(0),
                               rtol=0, atol=tol + 1e-6)
    assert float(a.grad[1].abs().max()) == 0.0


def test_embed_lookup_has_a_gradient():
    table = torch.randn(30, 8, requires_grad=True)
    out = embed_lookup(table, torch.tensor([1, 1, 4]), torch.float32)
    out.sum().backward()
    assert table.grad[1].eq(2).all() and table.grad[4].eq(1).all() and table.grad[0].eq(0).all()
