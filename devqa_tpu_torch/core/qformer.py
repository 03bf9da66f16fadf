"""Q-Former: BERT-style query transformer (counterpart of ``devqa_tpu/core/qformer.py``).

Post-LN residual blocks; self-attention over the learned query tokens and,
on every layer with ``i % cross_attention_frequency == 0``, cross-attention
to the ViT features; the query-only MLP branch.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.attention import multihead_attention
from ..ops.layers import gelu_exact, layer_norm, linear
from ..utils.config import BaseConfig
from .vit import _dense, _ln, _merge_heads, _normal, _split_heads


@dataclasses.dataclass(frozen=True)
class QFormerConfig(BaseConfig):
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ffn: int = 3072
    n_query_tokens: int = 32
    encoder_width: int = 1408  # ViT feature dim for cross-attention
    cross_attention_frequency: int = 2
    norm_eps: float = 1e-12


def blip2_qformer_config() -> QFormerConfig:
    return QFormerConfig()


def _mha_params(d_q, d_kv, d, generator, dtype, device):
    return {"q": _dense(d_q, d, generator, dtype, device),
            "k": _dense(d_kv, d, generator, dtype, device),
            "v": _dense(d_kv, d, generator, dtype, device),
            "o": _dense(d, d, generator, dtype, device),
            "ln": _ln(d, dtype, device)}


def init_qformer_params(cfg: QFormerConfig, generator: torch.Generator,
                        dtype=torch.float32, device="cuda"):
    d, f = cfg.d_model, cfg.d_ffn
    layers = []
    for i in range(cfg.n_layers):
        p = {"self_attn": _mha_params(d, d, d, generator, dtype, device),
             "fc1": _dense(d, f, generator, dtype, device),
             "fc2": _dense(f, d, generator, dtype, device),
             "mlp_ln": _ln(d, dtype, device)}
        if i % cfg.cross_attention_frequency == 0:
            p["cross_attn"] = _mha_params(d, cfg.encoder_width, d, generator,
                                          dtype, device)
        layers.append(p)
    return {"query_tokens": _normal((cfg.n_query_tokens, d), generator, dtype,
                                    device),
            "embed_ln": _ln(d, dtype, device),
            "layers": layers}


def _post_ln_attn(p, cfg: QFormerConfig, x_q, x_kv):
    q = _split_heads(linear(x_q, p["q"]["w"], p["q"]["b"]), cfg.n_heads)
    k = _split_heads(linear(x_kv, p["k"]["w"], p["k"]["b"]), cfg.n_heads)
    v = _split_heads(linear(x_kv, p["v"]["w"], p["v"]["b"]), cfg.n_heads)
    o = linear(_merge_heads(multihead_attention(q, k, v)),
               p["o"]["w"], p["o"]["b"])
    return layer_norm(o + x_q, p["ln"]["scale"], p["ln"]["bias"], cfg.norm_eps)


def qformer_forward(params, cfg: QFormerConfig,
                    image_embeds: torch.Tensor) -> torch.Tensor:
    """image_embeds [B, n_img_tokens, encoder_width] → [B, n_query, d]."""
    b = image_embeds.shape[0]
    h = params["query_tokens"].to(image_embeds.dtype).expand(b, -1, -1)
    h = layer_norm(h, params["embed_ln"]["scale"], params["embed_ln"]["bias"],
                   cfg.norm_eps)
    for p in params["layers"]:
        h = _post_ln_attn(p["self_attn"], cfg, h, h)
        if "cross_attn" in p:
            h = _post_ln_attn(p["cross_attn"], cfg, h, image_embeds)
        x = linear(gelu_exact(linear(h, p["fc1"]["w"], p["fc1"]["b"])),
                   p["fc2"]["w"], p["fc2"]["b"])
        h = layer_norm(x + h, p["mlp_ln"]["scale"], p["mlp_ln"]["bias"],
                       cfg.norm_eps)
    return h
