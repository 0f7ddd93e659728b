"""Checkpoint loading: HF safetensors / torch state dicts -> the port's param trees.

Counterpart of `umbrella_tpu/models/weights.py`. Tensors are read straight from
the checkpoint files; linear weights are transposed to [in, out] and stacked
along a leading layer axis.

safetensors files are read by `SafetensorsReader`, the port's own reader (the
format is an 8-byte little-endian header length, a JSON header of dtype, shape
and byte offsets, then the raw data), so no `safetensors` package is needed.
Each tensor is a zero-copy view of its own mmap of its byte range, unmapped
when the view is dropped; the loaders move each one to the device as they
consume it, so host memory holds about one tensor at a time, not the
checkpoint.
"""
from __future__ import annotations

import contextlib
import glob
import json
import mmap
import os
import struct
import warnings
from typing import Dict, Optional

import torch

from ..config import ModelConfig
from ..ops.rope import rope_params

SAFETENSORS_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I32": torch.int32, "I64": torch.int64, "I8": torch.int8, "U8": torch.uint8,
}


class SafetensorsReader:
    """name -> CPU tensor over the *.safetensors files of a checkpoint (shards
    in sorted order). A tensor is a view of a read-only mmap: do not write it."""

    def __init__(self, files):
        self._where: Dict[str, tuple] = {}  # name -> (file, dtype, shape, begin, end)
        self._files = []
        for path in files:
            f = open(path, "rb")
            self._files.append(f)
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            for name, meta in header.items():
                if name == "__metadata__":
                    continue
                if meta["dtype"] not in SAFETENSORS_DTYPES:
                    raise ValueError(f"{path}: tensor {name} has unsupported dtype {meta['dtype']}")
                b, e = meta["data_offsets"]
                self._where[name] = (f, SAFETENSORS_DTYPES[meta["dtype"]], tuple(meta["shape"]),
                                     8 + n + b, 8 + n + e)

    def close(self) -> None:
        for f in self._files:
            f.close()

    def keys(self):
        return self._where.keys()

    def __contains__(self, name) -> bool:
        return name in self._where

    def __getitem__(self, name) -> torch.Tensor:
        f, dtype, shape, b, e = self._where[name]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if e == b:
            return torch.empty(shape, dtype=dtype)
        # map only this tensor's pages; the view holds the mmap, which is
        # unmapped once the view is gone
        start = b // mmap.ALLOCATIONGRANULARITY * mmap.ALLOCATIONGRANULARITY
        mm = mmap.mmap(f.fileno(), e - start, offset=start, access=mmap.ACCESS_READ)
        with warnings.catch_warnings():  # the mmap is read-only, and so is the view
            warnings.simplefilter("ignore", UserWarning)
            if b % itemsize:  # the format does not align tensors: copy this one
                raw = torch.frombuffer(mm, dtype=torch.uint8, count=e - b, offset=b - start)
                return raw.clone().view(dtype).reshape(shape)
            return torch.frombuffer(mm, dtype=dtype, count=(e - b) // itemsize,
                                    offset=b - start).reshape(shape)


def _load_state_dict(path: str):
    """All tensors of a checkpoint directory: a SafetensorsReader over its
    *.safetensors files, else a dict from its pytorch_model*.bin files."""
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        return SafetensorsReader(st_files)
    bin_files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if bin_files:
        tensors: Dict[str, torch.Tensor] = {}
        for f in bin_files:
            tensors.update(torch.load(f, map_location="cpu", weights_only=True))
        return tensors
    raise FileNotFoundError(f"no safetensors/bin checkpoint found under {path}")


@contextlib.contextmanager
def read_state_dict(path: str):
    """_load_state_dict(path) for the block; its files are closed after it."""
    sd = _load_state_dict(path)
    try:
        yield sd
    finally:
        if isinstance(sd, SafetensorsReader):
            sd.close()


def stack_layers(n: int, make) -> torch.Tensor:
    """torch.stack([make(i) for i in range(n)]) written into one tensor as each
    layer is made, so no list of n layers is held beside the stack."""
    out = None
    for i in range(n):
        t = make(i)
        if out is None:
            out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        out[i].copy_(t)
        del t
    return out


def fetch(sd, name: str, device, dtype=None) -> torch.Tensor:
    """sd[name] on `device`, cast there to `dtype` when given (so no converted
    copy is made on the host). numpy arrays are accepted too."""
    t = sd[name]
    if not isinstance(t, torch.Tensor):
        from .convert import to_tensor

        t = to_tensor(t, "cpu")
    out = t.to(device)
    if dtype is not None:
        out = out.to(dtype)
    if out.data_ptr() == t.data_ptr():
        out = out.clone()  # never hand out a view of the file's mmap
    return out


def trim_vocab_rows(a: torch.Tensor, vocab: int) -> torch.Tensor:
    """Slice a [V_ckpt, ...] embedding/lm_head matrix down to the serving vocab
    (Qwen2.5 checkpoints pad the embedding); no-op when the checkpoint matches."""
    return a[:vocab] if a.shape[0] > vocab else a


def load_llama_params(path: str, cfg: ModelConfig, max_length: int, dtype=torch.bfloat16,
                      n_layers: Optional[int] = None, packed: bool = True,
                      device="cpu") -> dict:
    """The llama-family param tree from an HF (non-quantized) checkpoint
    directory (Llama/Mistral, Qwen2.5 attention biases). AWQ checkpoints go
    through quantization/loader.py."""
    with read_state_dict(path) as sd:
        return params_from_hf_state_dict(sd, cfg, max_length, dtype, n_layers=n_layers,
                                         packed=packed, device=device)


def params_from_hf_state_dict(sd, cfg: ModelConfig, max_length: int, dtype=torch.bfloat16,
                              n_layers: Optional[int] = None, packed: bool = True,
                              device="cpu") -> dict:
    n = n_layers if n_layers is not None else cfg.num_hidden_layers
    P = "model."

    def get(name):
        # fp16/bf16 widen to fp32 before the cast to dtype, as in the JAX package
        return fetch(sd, name, device, torch.float32).to(dtype)

    def stack_linear(fmt):
        # HF stores [out, in]; the tree holds [layer, in, out]
        return torch.stack([get(fmt.format(i)).T for i in range(n)]).contiguous()

    def stack_packed(fmts):
        return torch.stack([torch.cat([get(f.format(i)).T for f in fmts], dim=-1)
                            for i in range(n)]).contiguous()

    def stack_vec(fmt):
        return torch.stack([get(fmt.format(i)) for i in range(n)])

    def stack_vec_packed(fmts):
        return torch.stack([torch.cat([get(f.format(i)) for f in fmts], dim=-1)
                            for i in range(n)])

    layers = {
        "input_norm": stack_vec(P + "layers.{}.input_layernorm.weight"),
        "post_norm": stack_vec(P + "layers.{}.post_attention_layernorm.weight"),
        "wo": stack_linear(P + "layers.{}.self_attn.o_proj.weight"),
        "down": stack_linear(P + "layers.{}.mlp.down_proj.weight"),
    }
    qkv_fmts = [P + "layers.{}.self_attn.q_proj.weight", P + "layers.{}.self_attn.k_proj.weight",
                P + "layers.{}.self_attn.v_proj.weight"]
    gu_fmts = [P + "layers.{}.mlp.gate_proj.weight", P + "layers.{}.mlp.up_proj.weight"]
    bias_fmts = [P + "layers.{}.self_attn.%s_proj.bias" % c for c in "qkv"]
    has_bias = bias_fmts[0].format(0) in sd
    if packed:
        layers["wqkv"] = stack_packed(qkv_fmts)
        layers["gate_up"] = stack_packed(gu_fmts)
        if has_bias:
            layers["bqkv"] = stack_vec_packed(bias_fmts)
    else:
        layers["wq"], layers["wk"], layers["wv"] = (stack_linear(f) for f in qkv_fmts)
        layers["gate"], layers["up"] = (stack_linear(f) for f in gu_fmts)
        if has_bias:
            layers["bq"], layers["bk"], layers["bv"] = (stack_vec(f) for f in bias_fmts)

    params = {
        "embed": trim_vocab_rows(get(P + "embed_tokens.weight"), cfg.vocab_size).contiguous(),
        "final_norm": get(P + "norm.weight"),
        "layers": layers,
        **rope_params(cfg, device=device),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = trim_vocab_rows(get("lm_head.weight"), cfg.vocab_size).T.contiguous()
    return params
