"""The attention kernels' launch plan, operand checks and routing (pure Python:
the CUDA kernels run only on the card, where chip_smoke.py's `attention` phase
holds them against their plain versions), and the plain versions at a
70B-like GQA layout (groups 8) against the JAX package's Pallas kernels in
interpret mode on the CPU. Inputs are made with numpy from a seed."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umbrella_tpu.ops.pallas.tree_attention import attend_flash as jax_attend_flash
from umbrella_tpu.ops.pallas.tree_attention import \
    attend_flash_batched as jax_attend_flash_batched
from umbrella_tpu_torch.models.convert import to_tensor
from umbrella_tpu_torch.ops import kernels
from umbrella_tpu_torch.ops.kernels import build
from umbrella_tpu_torch.ops.kernels import tree_attention as ta
from umbrella_tpu_torch.ops.masks import causal_mask_rows

# (H, KVH): Llama-3.1-8B and Llama-3.3-70B (the shipped configs' widths)
SHIPPED_HEADS = [(32, 8), (64, 8)]
# row counts of every path: draft levels, verify, serving trees, prefill chunks
PLAN_ROWS = [1, 4, 7, 13, 24, 127, 128, 512, 2047]
PLAN_SLOTS = [1, 8, 32]


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


# ------------------------------------------------------------------ launch plan


@pytest.mark.parametrize("H,KVH", SHIPPED_HEADS)
@pytest.mark.parametrize("int8", [False, True])
def test_plan_tiles_and_stages_ignore_rows_and_slots(H, KVH, int8):
    """At the shipped shapes (D = 128) bf16 q takes the tensor-core kernel with
    64 rows a block, 64 kv slots a tile, a fixed ring depth and two consumer
    warpgroups, whatever S and B are (the plan splits nothing by S or B): a
    row's summation order is the same in every launch. The grid's row tiles
    are ceil(S * groups / 64), its last axis B."""
    plans = [ta._plan(B, S, H, KVH, 2048, 128, torch.bfloat16, int8)
             for S in PLAN_ROWS for B in PLAN_SLOTS]
    assert {(p["kernel"], p["rows"], p["kv_tile"], p["stages"], p["warpgroups"], p["smem"])
            for p in plans} == {("tc", 64, 64, 4, 2, plans[0]["smem"])}
    groups = H // KVH
    for S, B in ((1, 1), (127, 1), (7, 32), (512, 1)):
        assert ta._plan(B, S, H, KVH, 2048, 128, torch.bfloat16, int8)["grid"] == \
            (KVH, -(-S * groups // 64), B)


@pytest.mark.parametrize("D,int8", [(D, q8) for D in ta.TC_HEAD_DIMS for q8 in (False, True)])
def test_plan_ring_fits_the_card(D, int8):
    """2-4 ring stages and a block's shared memory within the card's at every
    cache length up to 128K slots; two consumer warpgroups at D <= 128, whose
    second warpgroup's partial sums fit the ring for the final combine."""
    for L in (2048, 8192, 131072):
        p = ta._plan(1, 127, 32, 8, L, D, torch.bfloat16, int8)
        assert 2 <= p["stages"] <= ta._TC_MAX_STAGES
        assert p["smem"] == ta._tc_smem(D, int8, p["stages"], L) <= ta._SMEM_MAX
        assert p["warpgroups"] == (2 if D <= 128 else 1)
        stage = 2 * 64 * D + 9216 if int8 else 4 * 64 * D + 8192
        assert p["warpgroups"] == 1 or p["stages"] * stage >= 128 * (D // 2 + 4) * 4


@pytest.mark.parametrize("dtype,D", [(torch.float32, 128), (torch.float32, 64),
                                     (torch.bfloat16, 32), (torch.float32, 32)])
def test_plan_fp32_q_and_head_dim_32_take_the_scalar_kernel(dtype, D):
    """fp32 q (the lossless gates' dtype) and head dim 32 stay on the scalar
    kernel: 32 rows and 32 kv slots a block, independent of S and B too."""
    plans = [ta._plan(B, S, 32, 8, 2048, D, dtype, False) for S in PLAN_ROWS for B in PLAN_SLOTS]
    assert {(p["kernel"], p["rows"], p["kv_tile"], p["stages"]) for p in plans} == \
        {("scalar", 32, 32, 1)}


# ------------------------------------------------------------------ operand checks


def _operands(**kw):
    """Single-slot operands at a small shape: q [5, 16, 64] bf16 against
    [2, 2, 96, 64] caches, optionally int8 with scales."""
    S, H, KVH, L, D = 5, 16, 2, 96, 64
    int8 = kw.pop("int8", False)
    ops = dict(q=torch.zeros((S, H, D), dtype=torch.bfloat16),
               k_cache=torch.zeros((2, KVH, L, D), dtype=torch.int8 if int8 else torch.bfloat16),
               mask=torch.ones((S, L), dtype=torch.bool), k_scale=None, v_scale=None,
               kv_limits=None, slots=None, layer_idx=1)
    if int8:
        ops["k_scale"] = torch.ones((2, KVH, L))
        ops["v_scale"] = torch.ones((2, KVH, L))
    ops["v_cache"] = ops["k_cache"].clone()
    ops.update(kw)
    return ops


def _misaligned(t):
    """t's values at an address 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 8, dtype=t.dtype)
    return flat[1:1 + t.numel()].view(t.shape)


CHECK_CASES = {
    "fp16 q": dict(q=torch.zeros((5, 16, 64), dtype=torch.float16)),
    "cache dtype": dict(k_cache=torch.zeros((2, 2, 96, 64)), v_cache=torch.zeros((2, 2, 96, 64))),
    "head dim 48": dict(q=torch.zeros((5, 16, 48), dtype=torch.bfloat16),
                        k_cache=torch.zeros((2, 2, 96, 48), dtype=torch.bfloat16),
                        v_cache=torch.zeros((2, 2, 96, 48), dtype=torch.bfloat16)),
    "heads not a multiple": dict(q=torch.zeros((5, 15, 64), dtype=torch.bfloat16)),
    "mask shape": dict(mask=torch.ones((5, 95), dtype=torch.bool)),
    "mask dtype": dict(mask=torch.ones((5, 96), dtype=torch.uint8)),
    "layer": dict(layer_idx=2),
    "not contiguous": dict(q=torch.zeros((16, 5, 64), dtype=torch.bfloat16).transpose(0, 1)),
    "kv_limits int64": dict(kv_limits=torch.zeros((1,), dtype=torch.int64)),
    "scale shape": dict(int8=True, k_scale=torch.ones((2, 2, 95))),
    "misaligned q": dict(q=_misaligned(torch.zeros((5, 16, 64), dtype=torch.bfloat16))),
    "misaligned scales": dict(int8=True, v_scale=_misaligned(torch.ones((2, 2, 96)))),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_raises_on_what_the_kernels_do_not_take(case):
    """ValueError (never a fallback) on an unsupported dtype or head dim, shapes
    that disagree, a non-bool mask, a layer past the stack, non-contiguous or
    misaligned operands (TMA reads q's rows, the caches and the int8 scales
    from 16-byte aligned bases), int64 limits, and a cache whose live-tile
    flags would not fit beside the ring (checked on the plan: such a cache
    would take gigabytes here)."""
    with pytest.raises(ValueError):
        ta._check("attend_flash", **_operands(**CHECK_CASES[case]))
    with pytest.raises(ValueError):
        ta._plan(1, 5, 16, 2, 1 << 24, 64, torch.bfloat16, False)


@pytest.mark.parametrize("int8", [False, True])
def test_check_passes_and_returns_the_plan(int8):
    """The operand checks take the single-slot and batched forms, bf16 and
    int8 KV, and return the plan with the shape they read."""
    ops = _operands(int8=int8)
    p = ta._check("attend_flash", **ops)
    assert (p["kernel"], p["B"], p["S"], p["H"], p["KVH"], p["L"], p["D"], p["Bc"],
            p["n_layers"]) == ("tc", 1, 5, 16, 2, 96, 64, 1, 2)
    B, Bc = 3, 4
    kb = torch.zeros((2, Bc, 2, 96, 64), dtype=ops["k_cache"].dtype)
    sc = torch.ones((2, Bc, 2, 96)) if int8 else None
    p = ta._check("attend_flash_batched", torch.zeros((B, 5, 16, 64), dtype=torch.bfloat16),
                  kb, kb.clone(), torch.ones((B, 5, 96), dtype=torch.bool), sc,
                  None if sc is None else sc.clone(), torch.zeros((B,), dtype=torch.int32),
                  torch.zeros((B,), dtype=torch.int32), 0)
    assert (p["B"], p["Bc"], p["grid"]) == (B, Bc, (2, 1, B))  # 5 x 8 rows: one tile


# ------------------------------------------------------------------ routing and counts


@pytest.fixture
def fake_launch(monkeypatch):
    """Run `_launch` on CPU tensors against a stand-in library: records which C
    entry point took which arguments and returns 0 (success)."""
    calls = []

    def fn(name):
        return lambda *args: calls.append((name, args)) or 0

    @contextlib.contextmanager
    def on_device(t):
        yield None

    monkeypatch.setattr(ta, "_fn", fn)
    monkeypatch.setattr(build, "on_device", on_device)
    kernels.reset_launch_counts()
    yield calls
    kernels.reset_launch_counts()


@pytest.mark.parametrize("dtype,D,entry", [(torch.bfloat16, 128, "attend_flash_tc"),
                                           (torch.bfloat16, 64, "attend_flash_tc"),
                                           (torch.float32, 128, "attend_flash"),
                                           (torch.bfloat16, 32, "attend_flash")])
def test_launch_routes_by_dtype_and_head_dim(fake_launch, dtype, D, entry):
    """bf16 q at head dim 64-256 calls the tensor-core entry point with the
    stack depth and the plan's stages, row tiles, warpgroups and shared
    memory (which the kernel checks against its own); fp32 q and head dim 32
    call the scalar one. Each launch counts once on its wrapper, and a scalar launch also on
    `scalar_launches` (`launch_counts()["attend_flash_scalar"]`)."""
    q = torch.zeros((24, 32, D), dtype=dtype)
    kc = torch.zeros((3, 8, 256, D), dtype=dtype)
    mask = causal_mask_rows(100, 24, 256)
    limit = ta.limit_tensor(124, q.device)
    ta._launch(ta.attend_flash, q, kc, kc.clone(), mask, None, None, limit, None, 2, 0.1, 0.0)
    ((name, args),) = fake_launch
    # the kernel reads the limit from the device (kv_limits), never a host int
    assert args[6].value == limit.data_ptr() and limit.tolist() == [124]
    assert name == entry
    counts = kernels.launch_counts()
    assert counts["attend_flash"] == 1
    assert counts["attend_flash_scalar"] == (entry == "attend_flash")
    if entry == "attend_flash_tc":
        # ..., Bc, n_layers, layer, kv_limit, scale, cap, int8, then the plan, stream
        assert args[15:18] == (1, 3, 2) and args[18] == 0
        p = ta._plan(1, 24, 32, 8, 256, D, dtype, False)
        assert args[-5:-1] == (p["stages"], p["grid"][1], p["warpgroups"], p["smem"])


def test_launch_counts_reset_the_scalar_count():
    kernels.reset_launch_counts()
    ta.attend_flash_batched.scalar_launches += 2
    assert kernels.launch_counts()["attend_flash_scalar"] == 2
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["attend_flash_scalar"] == 0


# ------------------------------------------------------------------ groups 8 vs the JAX package


def _int8_cache(rng, shape):
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("S", [1, 7, 24])
def test_groups_8_single_slot_matches_pallas(S, int8):
    """A 70B-like GQA layout, H=16 over KVH=2 (groups 8, so a kv head's rows
    are 8 heads of each position): the plain single-slot version against
    `attend_flash` in interpret mode, bf16/int8 KV. Tolerance: max abs err
    <= 1e-4 * max|y| (fp32; summation order and the online-softmax rescaling
    differ)."""
    rng = np.random.default_rng(900 + S + 50 * int8)
    n_layers, KVH, H, D, L, layer, kv_limit = 2, 2, 16, 32, 160, 1, 101
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    if int8:
        (k, ks), (v, vs) = _int8_cache(rng, (n_layers, KVH, L, D)), \
            _int8_cache(rng, (n_layers, KVH, L, D))
        jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tsc = dict(k_scale=_t(ks)[layer], v_scale=_t(vs)[layer])
    else:
        k = rng.standard_normal((n_layers, KVH, L, D)).astype(np.float32)
        v = rng.standard_normal((n_layers, KVH, L, D)).astype(np.float32)
        jsc, tsc = {}, {}
    mask = np.asarray(causal_mask_rows(kv_limit - S, S, L)) & (rng.random((S, L)) > 0.3)
    mask[:, 0] = True
    want = np.asarray(jax_attend_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jnp.int32(kv_limit),
        block_k=32, interpret=True, layer_idx=jnp.int32(layer), **jsc))
    got = ta.attend_flash_ref(_t(q), _t(k)[layer], _t(v)[layer], torch.as_tensor(mask), kv_limit,
                              **tsc).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("int8", [False, True])
def test_groups_8_batched_matches_pallas(int8):
    """The batched plain version at groups 8 (H=16, KVH=2) through slot
    indirection with per-slot limits, against `attend_flash_batched` in
    interpret mode. Tolerance: max abs err <= 1e-4 * max|y| (fp32)."""
    rng = np.random.default_rng(950 + int8)
    B, Bc, S, H, KVH, D, L, layer = 3, 4, 6, 16, 2, 32, 128, 0
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    shape = (2, Bc, KVH, L, D)
    if int8:
        (k, ks), (v, vs) = _int8_cache(rng, shape), _int8_cache(rng, shape)
        jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tsc = dict(k_scale=_t(ks), v_scale=_t(vs))
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        jsc, tsc = {}, {}
    slots = np.asarray([2, 0, 3], np.int32)
    limits = rng.integers(S + 1, L, B).astype(np.int32)
    mask = rng.random((B, S, L)) > 0.4
    for b in range(B):
        mask[b, :, limits[b]:] = False
        mask[b, :, 0] = True
    want = np.asarray(jax_attend_flash_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jnp.asarray(limits),
        jnp.int32(layer), slots=jnp.asarray(slots), block_k=32, interpret=True, **jsc))
    got = ta.attend_flash_batched_ref(_t(q), _t(k), _t(v), torch.as_tensor(mask), _t(limits),
                                      layer, slots=_t(slots), **tsc).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
