"""Primitive NN ops shared by the models (counterpart of ``devqa_tpu/ops/layers.py``).

Plain functions over explicit parameter tensors, with the JAX package's
numerics contract:

- a matmul runs in the promoted type of its operands (bf16 × f32 → f32, as
  ``jnp.dot`` promotes), accumulates in float32 and is cast once to the
  input's dtype; a bias joins the float32 accumulator before that cast;
- LayerNorm and RMSNorm are computed in float32 and cast back to the
  input's dtype.

Linear weights keep the JAX layout ``[in, out]``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in float32 (``jnp.dot`` with
    ``preferred_element_type=float32``). bf16 products are exact in
    float32, so the float32 product of the upcast operands is that
    accumulation."""
    return torch.matmul(x.float(), w.float())


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., in], w: [in, out], b: [out] or None → [..., out] in x's dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    x2 = x.reshape(-1, x.shape[-1]).to(dt)
    w2 = w.to(dt)
    # One GEMM with the bias in its epilogue: cuBLAS computes in float32
    # (reduced-precision reductions are off, see the package __init__) and
    # rounds once, which is dot(f32) + b then astype.
    y = torch.mm(x2, w2) if b is None else torch.addmm(b.to(dt), x2, w2)
    return y.reshape(*x.shape[:-1], w.shape[1]).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """LLaMA's RMSNorm (no mean, no bias) in float32, cast to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU (``jax.nn.gelu(approximate=False)``)."""
    return F.gelu(x, approximate="none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": gelu_exact,
    "silu": F.silu,
    "quick_gelu": quick_gelu,
}
