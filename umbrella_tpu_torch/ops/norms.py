"""RMS norms (fp32 accumulation, HF semantics)."""
import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """y = x / rms(x) * w, computed in fp32, cast back to x.dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def gemma_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma flavour: scale by (1 + w) instead of w."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)
