"""Pipeline-parallel inference: a model's decoder layers in contiguous blocks
(stages), each block and its KV cache on its own device.

Counterpart of the inference half of `umbrella_tpu/parallel/pipeline.py`
(`stack_awq_layers`, `shard_runtime_pp`, `pp_shard_map_forward`). The JAX
pipeline is one controller on one host: its stages are devices of one process
and the hops are `ppermute`s inside one `shard_map`. Here one process drives one
device per stage: a forward runs stage after stage, each stage's layers on its
device over its own KV cache, and the hidden state moves to the next stage's
device between them (a peer copy over NVLink between two cards). The embedding,
the final norm and the head run on stage 0's device, which is the runtime's
(and its engine's) device, as the JAX package runs them replicated outside the
`shard_map`. The forward is a list of phases (`pp_phases`, cuda_graphs.Phase):
`pp_forward` runs them eagerly (the prefill, the stepwise loop, the CPU), and
the engines' device-resident loop captures them inside its step, one CUDA
graph for each run of phases on one device (cuda_graphs.StepGraph).

A device may repeat in the stage list: one card (or the CPU) can hold every
stage, as the JAX tests stage a model on XLA's virtual host devices.

Inside a stage, the AWQ entries are stacked ([n, K/2, N] packed bytes) and a
layer reads its weights through `AwqLayerView`s with an int32 index already on
the stage's device, so its products run the W4A16 kernel's layered mode with no
host read and no per-layer copy.

Not copied from the JAX package: the scratch KV tail past max_length and the
diversion of KV writes on "garbage ticks" (`pipeline.py:126-138, 194-199, 231,
240` there). SPMD runs every tick on every device, so JAX must park the writes
of stages that are not on their real tick; a sequential stage loop runs each
stage once per forward and writes only real rows. The training half
(`make_pp_forward`, `make_pp_train_step`) waits for the training slice.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..cuda_graphs import Phase, run_phases
from ..models.kv_cache import StagedKVCache, init_kv_cache
from ..models.llama import (kv_limit_of, llama_layer, lm_head_logits, split_scan_layers,
                            view_scan_layer)
from ..ops.norms import rms_norm
from ..ops.select import embed_lookup
from ..quantization.awq import AwqTensor


class Stage(NamedTuple):
    """One stage of a staged model: its layer block and what its layers need,
    all on `device`."""
    device: torch.device
    layers: dict  # stacked AwqTensors and dense [n_local, ...] tensors
    layer_ids: torch.Tensor  # int32 arange(n_local): the layered kernel's indices
    inv_freq: torch.Tensor  # the rope frequencies


def stack_awq_layers(layers: dict) -> dict:
    """Per-layer AwqTensor tuples -> one stacked AwqTensor per entry ([n, K/2, N]
    w8, [n, G, N] scales and zeros); other entries as they are."""
    out = {}
    for k, v in layers.items():
        if isinstance(v, tuple) and v and isinstance(v[0], AwqTensor):
            out[k] = AwqTensor(*(torch.stack([t[f] for t in v]) for f in range(3)))
        else:
            out[k] = v
    return out


def stage_ranges(n_layers: int, n_stages: int) -> List[Tuple[int, int]]:
    """[first, end) layer range of each stage: contiguous blocks of
    n_layers / n_stages layers (the JAX package's P('pipe') split of the layer
    axis), which must divide evenly."""
    if n_stages < 1 or n_layers % n_stages:
        raise ValueError(f"n_layers ({n_layers}) must be divisible by the number of "
                         f"pipeline stages ({n_stages})")
    per = n_layers // n_stages
    return [(s * per, (s + 1) * per) for s in range(n_stages)]


def _to(x, device: torch.device):
    """A tensor or a quantized tuple of tensors on `device`; other values as they are."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and x and all(isinstance(t, torch.Tensor) for t in x):
        return type(x)(*(t.to(device) for t in x))
    return x


def shard_runtime_pp(runtime, devices: Sequence):
    """Stage a llama-family ModelRuntime in place over `devices`, one stage per
    entry (a device may repeat). Returns the runtime.

    Stage s gets layers [s * n / S, (s + 1) * n / S) on devices[s]: AWQ entries
    stacked (stack_awq_layers), dense stacks sliced. The per-layer AWQ tensors are
    released as their stage's stack is built, so staging needs one stage's
    stack of one entry in extra memory when nothing else holds them. The
    embedding, final norm and head move to devices[0], which becomes the
    runtime's device. Afterwards `forward` is the staged forward and `init_kv`
    gives a StagedKVCache."""
    devices = [torch.device(d) for d in devices]
    if runtime.stage_devices is not None:
        raise ValueError(f"runtime is already staged over {runtime.stage_devices}")
    ranges = stage_ranges(runtime.args.n_layers, len(devices))
    bad = [k for k, v in runtime.params["layers"].items()
           if isinstance(v, tuple) and not (v and isinstance(v[0], AwqTensor))]
    if bad:
        raise ValueError(f"layer entries {bad}: staging takes dense and AWQ layers")
    params = dict(runtime.params)
    runtime.params = params
    # lists of the per-layer tensors, emptied as the stacks are built (a
    # comprehension, so no loop variable keeps a tuple alive)
    pending = {k: list(v) if isinstance(v, tuple) else v for k, v in params.pop("layers").items()}
    stages = []
    for dev, (a, b) in zip(devices, ranges):
        block = {}
        for k, v in pending.items():
            if isinstance(v, list):
                block[k] = AwqTensor(*(torch.stack([t[f] for t in v[a:b]]).to(dev)
                                       for f in range(3)))
                v[a:b] = [None] * (b - a)
            else:
                block[k] = v[a:b].to(dev)
        stages.append(Stage(dev, block, torch.arange(b - a, dtype=torch.int32, device=dev),
                            params["rope_inv_freq"].to(dev)))
    for k in list(params):
        params[k] = _to(params[k], devices[0])
    params["stages"] = tuple(stages)
    runtime.device = devices[0]
    return runtime


def init_staged_kv(runtime, kv_dtype=None) -> StagedKVCache:
    """One KVCache per stage, over its layers, on its device."""
    return StagedKVCache(tuple(
        init_kv_cache(runtime.cfg, runtime.max_length, dtype=kv_dtype or runtime.dtype,
                      num_layers=s.layer_ids.shape[0], device=s.device)
        for s in runtime.params["stages"]))


def _current_device(device: torch.device):
    """`device` as the current CUDA device (the hand-written kernels launch on
    the current device, on the stream they are given); nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def pp_phases(args, params: dict, kv: StagedKVCache) -> list:
    """The staged forward as phases (cuda_graphs.Phase) over the step values
    ids, pos, mask and nn (the write offset) -> logits (fp32): the embedding
    on stage 0's device, each stage's layers on its device over its KV cache
    (written in place; the hidden state, positions, mask and offset read on
    that device), the final norm and head back on stage 0's device."""
    dev0 = params["embed"].device

    def embed(ids):
        return embed_lookup(params["embed"], ids, params["final_norm"].dtype)

    def stage_fn(stage, stage_kv):
        awq, dense = split_scan_layers(stage.layers)

        def run(hidden, pos, mask, nn):
            with _current_device(stage.device):
                kv_limit = kv_limit_of(nn, hidden.shape[0], stage_kv)
                for i in range(stage.layer_ids.shape[0]):
                    lw = view_scan_layer(awq, {k: v[i] for k, v in dense.items()},
                                         stage.layer_ids[i])
                    hidden, _ = llama_layer(args, lw, hidden, stage_kv, i, pos, mask, nn,
                                            stage.inv_freq, params["rope_scale"], kv_limit)
            return hidden
        return run

    def head(hidden):
        return lm_head_logits(params, rms_norm(hidden, params["final_norm"], args.rms_eps))

    return ([Phase("embed", dev0, embed, ("ids",), ("hidden",))]
            + [Phase(f"stage{s}", stage.device, stage_fn(stage, stage_kv),
                     ("hidden", "pos", "mask", "nn"), ("hidden",))
               for s, (stage, stage_kv) in enumerate(zip(params["stages"], kv.stages))]
            + [Phase("head", dev0, head, ("hidden",), ("logits",))])


def pp_forward(runtime):
    """The engine-contract forward (params, kv, ids, pos, mask, off) -> (fp32
    logits, kv) of a staged runtime: its phases (pp_phases) run eagerly, the
    hidden state and the stage inputs copied to each stage's device."""

    def fwd(params, kv, input_ids, position_ids, attn_mask, write_offset):
        values = dict(ids=input_ids, pos=position_ids, mask=attn_mask, nn=write_offset)
        return run_phases(pp_phases(runtime.args, params, kv), values)["logits"], kv

    return fwd
