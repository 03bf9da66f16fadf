"""The OPT decoder (BLIP-2's language model); counterpart of ``devqa_tpu/core/decoder.py``.

:func:`decoder_forward` runs layers ``[lo, hi)`` and takes two typed
intervention points in place of forward hooks:

* ``layer_residual=(i, fn)`` — ``fn`` maps layer ``i``'s output hidden
  state to its replacement (LiveEdit's layer-21 residual);
* ``mlp_residual=(i, fn)`` — ``fn`` maps layer ``i``'s post-norm MLP input
  to an additive delta on its MLP output.

One ``kv_valid`` [B, L] mask drives attention masking and the learned
positions (``cumsum(kv_valid) - 1``, offset 2), so a masked vision slot is
position-equivalent to an absent one. Only the OPT architecture is ported;
the LLaMA family comes with the LLaVA geometry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..ops.attention import multihead_attention
from ..ops.layers import ACTIVATIONS, layer_norm, linear, matmul_f32
from ..utils.config import BaseConfig
from .vit import _dense, _ln, _merge_heads, _normal, _split_heads


@dataclasses.dataclass(frozen=True)
class DecoderConfig(BaseConfig):
    arch: str = "opt"
    vocab_size: int = 50272
    d_model: int = 2560
    n_layers: int = 32
    n_heads: int = 32
    d_ffn: int = 10240
    max_positions: int = 2048
    activation: str = "relu"
    norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    pos_offset: int = 2  # OPT's learned-position offset

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def opt_2_7b_config() -> DecoderConfig:
    """blip2-opt-2.7b language model: d 2560, 32 layers, 32 heads of dim 80."""
    return DecoderConfig(arch="opt", vocab_size=50272, d_model=2560,
                         n_layers=32, n_heads=32, d_ffn=10240,
                         activation="relu", tie_word_embeddings=True)


def _check_arch(cfg: DecoderConfig) -> None:
    if cfg.arch != "opt" or not cfg.tie_word_embeddings:
        raise NotImplementedError(
            "decoder arch %r (tied head: %s) is not ported; only OPT is"
            % (cfg.arch, cfg.tie_word_embeddings))


def init_decoder_params(cfg: DecoderConfig, generator: torch.Generator,
                        dtype=torch.float32, device="cuda"):
    _check_arch(cfg)
    d, f = cfg.d_model, cfg.d_ffn
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": _ln(d, dtype, device),
            "q": _dense(d, d, generator, dtype, device),
            "k": _dense(d, d, generator, dtype, device),
            "v": _dense(d, d, generator, dtype, device),
            "o": _dense(d, d, generator, dtype, device),
            "ln2": _ln(d, dtype, device),
            "fc1": _dense(d, f, generator, dtype, device),
            "fc2": _dense(f, d, generator, dtype, device),
        })
    return {
        "embed_tokens": _normal((cfg.vocab_size, d), generator, dtype, device),
        "embed_positions": _normal((cfg.max_positions + cfg.pos_offset, d),
                                   generator, dtype, device),
        "final_norm": _ln(d, dtype, device),
        "layers": layers,
    }


def positions_from_mask(kv_valid: torch.Tensor) -> torch.Tensor:
    """[B, L] validity mask → position ids (cumsum - 1, clamped at 0)."""
    return torch.clamp(torch.cumsum(kv_valid.to(torch.int64), dim=1) - 1,
                       min=0)


def _attn_block(p, cfg: DecoderConfig, h_norm, kv_valid):
    q = _split_heads(linear(h_norm, p["q"]["w"], p["q"]["b"]), cfg.n_heads)
    k = _split_heads(linear(h_norm, p["k"]["w"], p["k"]["b"]), cfg.n_heads)
    v = _split_heads(linear(h_norm, p["v"]["w"], p["v"]["b"]), cfg.n_heads)
    o = multihead_attention(q, k, v, kv_valid=kv_valid, causal=True)
    return linear(_merge_heads(o), p["o"]["w"], p["o"]["b"])


def decoder_layer(p, cfg: DecoderConfig, h, kv_valid,
                  mlp_residual_fn: Optional[Callable] = None):
    """One pre-LN OPT layer; ``p`` holds that layer's params."""
    act = ACTIVATIONS[cfg.activation]
    h_norm = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"], cfg.norm_eps)
    h = h + _attn_block(p, cfg, h_norm, kv_valid)
    x = layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"], cfg.norm_eps)
    mlp = linear(act(linear(x, p["fc1"]["w"], p["fc1"]["b"])),
                 p["fc2"]["w"], p["fc2"]["b"])
    if mlp_residual_fn is not None:
        mlp = mlp + mlp_residual_fn(x)
    return h + mlp


def embed_tokens(params, cfg: DecoderConfig, input_ids) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def decoder_forward(
    params,
    cfg: DecoderConfig,
    inputs_embeds: torch.Tensor,
    kv_valid: torch.Tensor,
    *,
    lo: int = 0,
    hi: Optional[int] = None,
    layer_residual: Optional[Tuple[int, Callable]] = None,
    mlp_residual: Optional[Tuple[int, Callable]] = None,
) -> torch.Tensor:
    """Run decoder layers [lo, hi) over ``inputs_embeds`` → hidden states.

    ``lo == 0`` adds the learned position embeddings; resuming from a
    mid-layer capture (``lo > 0``) must not add them again.
    """
    _check_arch(cfg)
    hi = cfg.n_layers if hi is None else hi
    h = inputs_embeds
    if lo == 0:
        positions = positions_from_mask(kv_valid)
        h = h + params["embed_positions"][positions + cfg.pos_offset]
    for i in range(lo, hi):
        mlp_fn = (mlp_residual[1]
                  if mlp_residual is not None and mlp_residual[0] == i
                  else None)
        h = decoder_layer(params["layers"][i], cfg, h, kv_valid, mlp_fn)
        if layer_residual is not None and layer_residual[0] == i:
            h = layer_residual[1](h)
    return h


def decoder_logits(params, cfg: DecoderConfig, hidden) -> torch.Tensor:
    """Final norm + tied LM head → [B, L, V] float32 logits."""
    _check_arch(cfg)
    h = layer_norm(hidden, params["final_norm"]["scale"],
                   params["final_norm"]["bias"], cfg.norm_eps)
    return matmul_f32(h, params["embed_tokens"].t())


def _head_chunk(V: int, target: int = 8192, floor: int = 1024) -> int:
    """Largest divisor of V that is ≤ target (≥ floor), else 0. OPT's
    50272 → 6284."""
    if V <= target:
        return V
    for c in range(target, floor - 1, -1):
        if V % c == 0:
            return c
    return 0


def decoder_pred_ids(params, cfg: DecoderConfig, hidden) -> torch.Tensor:
    """argmax over the vocabulary of ``decoder_logits(hidden)`` without
    materializing the [..., V] logits: a running (max, argmax) over
    vocabulary chunks. Ties resolve to the first index, within a chunk
    (``argmax``) and across chunks (strict ``>``)."""
    _check_arch(cfg)
    emb = params["embed_tokens"]
    vc = _head_chunk(emb.shape[0])
    if vc == 0:
        return torch.argmax(decoder_logits(params, cfg, hidden), dim=-1)
    h = layer_norm(hidden, params["final_norm"]["scale"],
                   params["final_norm"]["bias"], cfg.norm_eps)
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    best = torch.full((h2.shape[0],), -float("inf"), dtype=torch.float32,
                      device=h.device)
    besti = torch.zeros((h2.shape[0],), dtype=torch.int64, device=h.device)
    for i in range(emb.shape[0] // vc):
        lg = matmul_f32(h2, emb[i * vc:(i + 1) * vc].t())
        ai = torch.argmax(lg, dim=-1)
        m = lg.gather(1, ai[:, None])[:, 0]
        upd = m > best
        best = torch.where(upd, m, best)
        besti = torch.where(upd, ai + i * vc, besti)
    return besti.reshape(lead)
