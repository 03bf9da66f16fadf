"""LiveEdit auxiliary networks (counterpart of ``devqa_tpu/editors/liveedit_modules.py``).

- :func:`attention_apply` — the cross-attention block: separate q/k/v
  projections, per-head softmax over keys. Plain PyTorch: it was never a
  Pallas kernel.
- QV extractor: learned query slots extracting an edit-query and an
  edit-vision representation from masked spans.
- Low-rank generator: learned slots emitting one LoRA factor.

Spans are passed as masks over the full sequence (masked attention equals
attention over the sliced span). Products follow ``jnp``'s promotion: a
bf16 activation times a float32 parameter runs in float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.layers import layer_norm

NEG_INF = -1e30


def _uniform(shape, bound, generator, device):
    return (torch.rand(shape, generator=generator, device=device)
            .mul_(2 * bound).sub_(bound))


def _kaiming(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device) \
        * (2.0 / shape[-1]) ** 0.5


def _init_linear(d_in, d_out, generator, device):
    bound = 1.0 / d_in ** 0.5
    return {"w": _uniform((d_in, d_out), bound, generator, device),
            "b": _uniform((d_out,), bound, generator, device)}


def init_attention(inp1_dim, inp2_dim, qk_dim, v_dim, generator, device):
    return {"q": _init_linear(inp1_dim, qk_dim, generator, device),
            "k": _init_linear(inp2_dim, qk_dim, generator, device),
            "v": _init_linear(inp2_dim, v_dim, generator, device)}


def _ln(d, device):
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def _affine(x, p):
    dt = torch.promote_types(x.dtype, p["w"].dtype)
    return torch.matmul(x.to(dt), p["w"].to(dt)) + p["b"]


def attention_apply(p, inp1, inp2, head_n: int,
                    kv_mask: Optional[torch.Tensor] = None):
    """inp1 [b, l1, d1] queries; inp2 [b, l2, d2] keys/values; kv_mask
    [b, l2] (1 = attendable). Returns [b, l1, v_dim]."""
    b, l1, _ = inp1.shape
    l2 = inp2.shape[1]
    q = _affine(inp1, p["q"]).reshape(b, l1, head_n, -1)
    k = _affine(inp2, p["k"]).reshape(b, l2, head_n, -1)
    v = _affine(inp2, p["v"]).reshape(b, l2, head_n, -1)
    s = torch.einsum("blhd,bmhd->blmh", q, k) * (1.0 / q.shape[-1] ** 0.5)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, :, None] > 0, s, NEG_INF)
    s = torch.softmax(s, dim=2)
    return torch.einsum("blmh,bmhd->blhd", s, v).reshape(b, l1, -1)


def init_qv_extractor(eqe_n, inpt_reps_dim, module_dim, vision_tok_n,
                      vis_prot: bool, generator, device):
    p = {
        "ln1": _ln(inpt_reps_dim, device),
        "eqe1": _kaiming((1, eqe_n, module_dim), generator, device),
        "ca_query1": init_attention(module_dim, inpt_reps_dim, module_dim,
                                    module_dim, generator, device),
        "ca_vision": init_attention(module_dim, inpt_reps_dim, module_dim,
                                    module_dim, generator, device),
        "ln2": _ln(inpt_reps_dim, device),
        "eqe2": _kaiming((1, eqe_n, module_dim), generator, device),
        "ca_query2": init_attention(module_dim, inpt_reps_dim, module_dim,
                                    module_dim, generator, device),
    }
    if vis_prot:
        p["vis_rep_prot"] = _kaiming((1, vision_tok_n, inpt_reps_dim),
                                     generator, device)
    return p


def qv_extract_vision(p, head_n, query_reps, vision_reps, query_mask=None,
                      vision_mask=None):
    """eqr = att(eqe1, query); evr = att(eqr, vision)."""
    b = query_reps.shape[0]
    qr = layer_norm(query_reps, p["ln1"]["scale"], p["ln1"]["bias"])
    vr = layer_norm(vision_reps, p["ln1"]["scale"], p["ln1"]["bias"])
    eqe1 = p["eqe1"].expand(b, -1, -1)
    eqr = attention_apply(p["ca_query1"], eqe1, qr, head_n, query_mask)
    return attention_apply(p["ca_vision"], eqr, vr, head_n, vision_mask)


def qv_extract_query(p, head_n, query_reps, query_mask=None):
    b = query_reps.shape[0]
    qr = layer_norm(query_reps, p["ln2"]["scale"], p["ln2"]["bias"])
    eqe2 = p["eqe2"].expand(b, -1, -1)
    return attention_apply(p["ca_query2"], eqe2, qr, head_n, query_mask)


def qv_extract_from_visprot(p, head_n, query_reps, query_mask=None):
    """extract_vision against the learned prototype vision tokens."""
    b = query_reps.shape[0]
    prot = p["vis_rep_prot"].expand(b, -1, -1)
    return qv_extract_vision(p, head_n, query_reps, prot, query_mask, None)


def init_lowrank_generator(lora_dim, lora_rank, inpt_reps_dim, module_dim,
                           generator, device):
    return {
        "phi": _kaiming((1, lora_rank, module_dim), generator, device),
        "ca": init_attention(module_dim, inpt_reps_dim, module_dim, lora_dim,
                             generator, device),
        "ln": _ln(inpt_reps_dim, device),
    }


def lowrank_generate(p, head_n, scale, inpt_reps, mask=None):
    """→ [b, lora_rank, lora_dim]; ``scale`` = 1/(lora_scale·√rank)."""
    b = inpt_reps.shape[0]
    x = layer_norm(inpt_reps, p["ln"]["scale"], p["ln"]["bias"])
    phi = p["phi"].expand(b, -1, -1)
    return attention_apply(p["ca"], phi, x, head_n, mask) * scale
