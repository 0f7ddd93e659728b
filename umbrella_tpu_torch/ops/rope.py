"""Rotary position embeddings, including Llama-3 frequency scaling.

Angles are computed from (positions, inv_freq) in fp32 per call, as in
`umbrella_tpu/ops/rope.py` and HF.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import ModelConfig


def _base_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def compute_inv_freq(cfg: ModelConfig) -> Tuple[np.ndarray, float]:
    """Return (inv_freq[head_dim//2], attention_scaling) honouring HF rope_scaling."""
    inv_freq = _base_inv_freq(cfg.resolved_head_dim, cfg.rope_theta)
    scaling = cfg.rope_scaling or {}
    rope_type = scaling.get("rope_type", scaling.get("type", "default"))
    attention_scaling = 1.0

    if rope_type == "llama3":
        # HF llama3 rule: leave high-frequency bands, divide low-frequency bands by
        # `factor`, smoothly interpolate in between.
        factor = scaling["factor"]
        low_factor = scaling["low_freq_factor"]
        high_factor = scaling["high_freq_factor"]
        old_len = scaling["original_max_position_embeddings"]
        low_wavelen = old_len / low_factor
        high_wavelen = old_len / high_factor
        wavelen = 2 * math.pi / inv_freq
        scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (old_len / wavelen - low_factor) / (high_factor - low_factor)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        is_medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
        inv_freq = np.where(is_medium, smoothed, scaled)
    elif rope_type == "linear":
        inv_freq = inv_freq / scaling["factor"]
    # "default" / "dynamic": dynamic NTK only differs beyond max_position_embeddings

    return inv_freq.astype(np.float64), attention_scaling


def rope_params(cfg: ModelConfig, device="cpu") -> dict:
    """Param entries for rope: {'rope_inv_freq': [D/2] f32 tensor, 'rope_scale': float}."""
    inv_freq, attention_scaling = compute_inv_freq(cfg)
    return {
        "rope_inv_freq": torch.tensor(inv_freq, dtype=torch.float32, device=device),
        "rope_scale": float(np.float32(attention_scaling)),
    }


def rope_angles(position_ids: torch.Tensor, inv_freq: torch.Tensor,
                attention_scaling) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [S, D] for the given positions (fp32, HF-duplicated layout)."""
    freqs = position_ids.float()[:, None] * inv_freq[None, :]  # [S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * attention_scaling, torch.sin(emb) * attention_scaling


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,  # [S, H, D]
    k: torch.Tensor,  # [S, KVH, D]
    inv_freq: torch.Tensor,  # [D/2] f32
    attention_scaling,  # scalar
    position_ids: torch.Tensor,  # [S]
) -> Tuple[torch.Tensor, torch.Tensor]:
    cos, sin = rope_angles(position_ids, inv_freq, attention_scaling)
    cos = cos[:, None, :].to(q.dtype)  # [S, 1, D]
    sin = sin[:, None, :].to(q.dtype)
    q_out = q * cos + _rotate_half(q) * sin
    k_out = k * cos + _rotate_half(k) * sin
    return q_out, k_out
