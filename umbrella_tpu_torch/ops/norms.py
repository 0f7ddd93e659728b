"""RMS norms (fp32 accumulation, HF semantics).

The mean of squares is summed in fp64 and rounded to fp32 once, so a row's
norm does not depend on how many rows share the call. PyTorch's CUDA
reduction picks its thread layout from the row count (one row: 512 threads
per row; 2-15 rows: 256-64; 16 or more: 32), and in fp32 each layout rounds
the sum differently. The W4A8 layers quantize their inputs to int8 per row,
which turns such a last-bit difference into a whole quantum now and then, so
a verify pass over 7 rows and one over 28 rows (the same slot in a batch)
would otherwise part on near-tied greedy tokens.
"""
import torch


def _mean_square(x32: torch.Tensor) -> torch.Tensor:
    return (x32 * x32).mean(dim=-1, keepdim=True, dtype=torch.float64).float()


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """y = x / rms(x) * w, computed in fp32, cast back to x.dtype."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(_mean_square(x32) + eps)
    return (normed * weight.float()).to(x.dtype)


def gemma_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma flavour: scale by (1 + w) instead of w."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(_mean_square(x32) + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)
