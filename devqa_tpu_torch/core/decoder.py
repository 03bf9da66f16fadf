"""The decoder LLMs: OPT (BLIP-2's) and LLaMA (Vicuna, LLaVA-1.5's);
counterpart of ``devqa_tpu/core/decoder.py``.

:func:`decoder_forward` runs layers ``[lo, hi)`` and takes two typed
intervention points in place of forward hooks:

* ``layer_residual=(i, fn)`` — ``fn`` maps layer ``i``'s output hidden
  state to its replacement (LiveEdit's layer-21 residual);
* ``mlp_residual=(i, fn)`` — ``fn`` maps layer ``i``'s post-norm MLP input
  to an additive delta on its MLP output.

One ``kv_valid`` [B, L] mask drives attention masking and the positions
(``cumsum(kv_valid) - 1``): OPT's learned positions (offset 2) and LLaMA's
rotary embedding (half-split pairs) alike, so a masked vision slot is
position-equivalent to an absent one. The positions are computed in every
call, whatever ``lo``: RoPE needs them in every layer, also when LiveEdit
resumes after its edit layer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..ops.attention import multihead_attention
from ..ops.layers import ACTIVATIONS, layer_norm, linear, matmul_f32, rms_norm
from ..utils.config import BaseConfig
from .vit import _dense, _ln, _merge_heads, _normal, _split_heads


@dataclasses.dataclass(frozen=True)
class DecoderConfig(BaseConfig):
    arch: str = "opt"  # "opt" | "llama"
    vocab_size: int = 50272
    d_model: int = 2560
    n_layers: int = 32
    n_heads: int = 32
    d_ffn: int = 10240
    max_positions: int = 2048
    activation: str = "relu"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    pos_offset: int = 2  # OPT's learned-position offset
    attn_bias: bool = False  # llama-family q/k/v bias
    o_bias: bool = False     # llama-family o_proj bias
    n_kv_heads: Optional[int] = None  # grouped-query attention
    # Interleaved (GLM / GPT-J) rotary pairing; not ported.
    rope_interleaved: bool = False
    rotary_dim: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


def opt_2_7b_config() -> DecoderConfig:
    """blip2-opt-2.7b language model: d 2560, 32 layers, 32 heads of dim 80."""
    return DecoderConfig(arch="opt", vocab_size=50272, d_model=2560,
                         n_layers=32, n_heads=32, d_ffn=10240,
                         activation="relu", tie_word_embeddings=True)


def vicuna_7b_config() -> DecoderConfig:
    """llava-v1.5-7b's language model (Vicuna-7b): d 4096, 32 layers, 32
    heads of dim 128, SwiGLU 11008, RMSNorm, RoPE, untied head."""
    return DecoderConfig(arch="llama", vocab_size=32000, d_model=4096,
                         n_layers=32, n_heads=32, d_ffn=11008,
                         activation="silu", tie_word_embeddings=False,
                         norm_eps=1e-6, max_positions=4096)


def _check_arch(cfg: DecoderConfig) -> None:
    ok = {"opt": cfg.tie_word_embeddings and cfg.rotary_dim is None,
          "llama": not cfg.rope_interleaved and cfg.rotary_dim is None}
    if not ok.get(cfg.arch, False):
        raise NotImplementedError(
            "decoder arch %r (tied head %s, interleaved rotary %s, rotary "
            "dim %s) is not ported; OPT with a tied head and LLaMA with "
            "half-split RoPE are" % (cfg.arch, cfg.tie_word_embeddings,
                                     cfg.rope_interleaved, cfg.rotary_dim))


def init_decoder_params(cfg: DecoderConfig, generator: torch.Generator,
                        dtype=torch.float32, device="cuda"):
    """Same shapes and scales as the JAX init (normal × 0.02, norms ones)."""
    _check_arch(cfg)
    d, f = cfg.d_model, cfg.d_ffn

    def dense(d_in, d_out, bias=True):
        p = _dense(d_in, d_out, generator, dtype, device)
        return p if bias else {"w": p["w"]}

    def rms():
        return {"scale": torch.ones(d, dtype=dtype, device=device)}

    layers = []
    for _ in range(cfg.n_layers):
        if cfg.arch == "opt":
            layers.append({
                "ln1": _ln(d, dtype, device),
                "q": dense(d, d), "k": dense(d, d), "v": dense(d, d),
                "o": dense(d, d),
                "ln2": _ln(d, dtype, device),
                "fc1": dense(d, f), "fc2": dense(f, d),
            })
        else:
            d_kv = cfg.kv_heads * cfg.head_dim
            layers.append({
                "ln1": rms(),
                "q": dense(d, d, cfg.attn_bias),
                "k": dense(d, d_kv, cfg.attn_bias),
                "v": dense(d, d_kv, cfg.attn_bias),
                "o": dense(d, d, cfg.o_bias),
                "ln2": rms(),
                "gate": dense(d, f, False), "up": dense(d, f, False),
                "down": dense(f, d, False),
            })
    params = {
        "embed_tokens": _normal((cfg.vocab_size, d), generator, dtype, device),
        "layers": layers,
    }
    if cfg.arch == "opt":
        params["embed_positions"] = _normal(
            (cfg.max_positions + cfg.pos_offset, d), generator, dtype, device)
        params["final_norm"] = _ln(d, dtype, device)
    else:
        params["final_norm"] = rms()
        if not cfg.tie_word_embeddings:
            params["lm_head"] = _normal((d, cfg.vocab_size), generator, dtype,
                                        device)
    return params


def positions_from_mask(kv_valid: torch.Tensor) -> torch.Tensor:
    """[B, L] validity mask → position ids (cumsum - 1, clamped at 0)."""
    return torch.clamp(torch.cumsum(kv_valid.to(torch.int64), dim=1) - 1,
                       min=0)


def _rope(q, k, positions, theta):
    """Rotary embedding with half-split pairs (HF LLaMA). q, k: [B, H, L, D]
    (k may have fewer heads); positions [B, L]. Angles, sines and the
    rotation in float32, the result cast back to the inputs' dtypes."""
    d = q.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=q.device) / d))
    ang = positions[:, None, :, None].to(torch.float32) * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(ang), torch.sin(ang)

    def rotate(x):
        xf = x.float()
        x1, x2 = xf.chunk(2, dim=-1)
        return (xf * cos + torch.cat([-x2, x1], dim=-1) * sin).to(x.dtype)

    return rotate(q), rotate(k)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, Hkv, L, D] → [B, Hkv·n_rep, L, D] (grouped-query key/value
    broadcast), contiguous."""
    if n_rep == 1:
        return x
    b, h, l, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, l, d).reshape(b, h * n_rep, l, d)


def _attn_block(p, cfg: DecoderConfig, h_norm, kv_valid, positions):
    q = _split_heads(linear(h_norm, p["q"]["w"], p["q"].get("b")), cfg.n_heads)
    k = _split_heads(linear(h_norm, p["k"]["w"], p["k"].get("b")),
                     cfg.kv_heads)
    v = _split_heads(linear(h_norm, p["v"]["w"], p["v"].get("b")),
                     cfg.kv_heads)
    if cfg.arch == "llama":
        q, k = _rope(q, k, positions, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.kv_heads
    o = multihead_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                            kv_valid=kv_valid, causal=True)
    return linear(_merge_heads(o), p["o"]["w"], p["o"].get("b"))


def decoder_layer(p, cfg: DecoderConfig, h, kv_valid, positions,
                  mlp_residual_fn: Optional[Callable] = None):
    """One pre-norm layer (OPT: LayerNorm and a ReLU MLP; LLaMA: RMSNorm,
    RoPE and SwiGLU); ``p`` holds that layer's params."""
    act = ACTIVATIONS[cfg.activation]
    if cfg.arch == "opt":
        h_norm = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"],
                            cfg.norm_eps)
        h = h + _attn_block(p, cfg, h_norm, kv_valid, positions)
        x = layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"], cfg.norm_eps)
        mlp = linear(act(linear(x, p["fc1"]["w"], p["fc1"]["b"])),
                     p["fc2"]["w"], p["fc2"]["b"])
    else:
        h_norm = rms_norm(h, p["ln1"]["scale"], cfg.norm_eps)
        h = h + _attn_block(p, cfg, h_norm, kv_valid, positions)
        x = rms_norm(h, p["ln2"]["scale"], cfg.norm_eps)
        mlp = linear(act(linear(x, p["gate"]["w"])) * linear(x, p["up"]["w"]),
                     p["down"]["w"])
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

    OPT adds its learned position embeddings at ``lo == 0``; resuming from
    a mid-layer capture (``lo > 0``) must not add them again. LLaMA's
    rotary embedding uses the same positions in every layer.
    """
    _check_arch(cfg)
    hi = cfg.n_layers if hi is None else hi
    positions = positions_from_mask(kv_valid)
    h = inputs_embeds
    if lo == 0 and cfg.arch == "opt":
        h = h + params["embed_positions"][positions + cfg.pos_offset]
    for i in range(lo, hi):
        mlp_fn = (mlp_residual[1]
                  if mlp_residual is not None and mlp_residual[0] == i
                  else None)
        h = decoder_layer(params["layers"][i], cfg, h, kv_valid, positions,
                          mlp_fn)
        if layer_residual is not None and layer_residual[0] == i:
            h = layer_residual[1](h)
    return h


def _final_norm(params, cfg: DecoderConfig, hidden) -> torch.Tensor:
    fn = params["final_norm"]
    if cfg.arch == "opt":
        return layer_norm(hidden, fn["scale"], fn["bias"], cfg.norm_eps)
    return rms_norm(hidden, fn["scale"], cfg.norm_eps)


def _head_weight(params, cfg: DecoderConfig) -> torch.Tensor:
    """The LM head as [d, V]: the tied embedding's transpose or ``lm_head``."""
    return (params["embed_tokens"].t() if cfg.tie_word_embeddings
            else params["lm_head"])


def decoder_logits(params, cfg: DecoderConfig, hidden) -> torch.Tensor:
    """Final norm + LM head → [B, L, V] float32 logits."""
    _check_arch(cfg)
    return matmul_f32(_final_norm(params, cfg, hidden),
                      _head_weight(params, cfg))


def _head_chunk(V: int, target: int = 8192, floor: int = 1024) -> int:
    """Largest divisor of V that is ≤ target (≥ floor), else 0. OPT's
    50272 → 6284, LLaMA's 32000 → 8000."""
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
    w = _head_weight(params, cfg)
    vc = _head_chunk(w.shape[1])
    if vc == 0:
        return torch.argmax(decoder_logits(params, cfg, hidden), dim=-1)
    h = _final_norm(params, cfg, hidden)
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    best = torch.full((h2.shape[0],), -float("inf"), dtype=torch.float32,
                      device=h.device)
    besti = torch.zeros((h2.shape[0],), dtype=torch.int64, device=h.device)
    for i in range(w.shape[1] // vc):
        lg = matmul_f32(h2, w[:, i * vc:(i + 1) * vc])
        ai = torch.argmax(lg, dim=-1)
        m = lg.gather(1, ai[:, None])[:, 0]
        upd = m > best
        best = torch.where(upd, m, best)
        besti = torch.where(upd, ai + i * vc, besti)
    return besti.reshape(lead)
