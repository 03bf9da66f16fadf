"""Vision transformers (counterpart of ``devqa_tpu/core/vit.py``).

- BLIP-2's EVA ViT-g: fused qkv, post-LayerNorm, exact GELU, 224px/14 →
  257 tokens (class token + 256 patches).
- LLaVA-1.5's CLIP ViT-L/14-336: split q/k/v, embedding pre-LayerNorm,
  quick GELU, 336px/14 → 577 tokens; LLaVA reads the penultimate layer's
  hidden states without the post-LayerNorm (``stop_at_layer``).

Patch embedding is patchify + one matmul (the stride-P convolution).
Parameters are a dict; ``layers`` is a list of per-layer dicts (the JAX
package stacks them along a leading axis).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.attention import multihead_attention
from ..ops.layers import ACTIVATIONS, layer_norm, linear
from ..utils.config import BaseConfig


@dataclasses.dataclass(frozen=True)
class ViTConfig(BaseConfig):
    image_size: int = 224
    patch_size: int = 14
    d_model: int = 1408
    n_layers: int = 39
    n_heads: int = 16
    d_ffn: int = 6144
    activation: str = "gelu"
    fused_qkv: bool = True
    pre_layernorm: bool = True
    use_cls_token: bool = True
    norm_eps: float = 1e-5

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def n_tokens(self) -> int:
        return self.n_patches + (1 if self.use_cls_token else 0)


def blip2_vit_config() -> ViTConfig:
    """224/14 → 257 tokens, d 1408, 39 layers, 16 heads of dim 88."""
    return ViTConfig(image_size=224, patch_size=14, d_model=1408, n_layers=39,
                     n_heads=16, d_ffn=6144, fused_qkv=True,
                     pre_layernorm=False)


def clip_vit_l_336_config() -> ViTConfig:
    """336/14 → 577 tokens, d 1024, 24 layers, 16 heads of dim 64."""
    return ViTConfig(image_size=336, patch_size=14, d_model=1024, n_layers=24,
                     n_heads=16, d_ffn=4096, activation="quick_gelu",
                     fused_qkv=False, pre_layernorm=True)


def _normal(shape, generator, dtype, device, scale=0.02):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device).mul_(scale)


def _ln(d, dtype, device):
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def _dense(d_in, d_out, generator, dtype, device):
    return {"w": _normal((d_in, d_out), generator, dtype, device),
            "b": torch.zeros(d_out, dtype=dtype, device=device)}


def init_vit_params(cfg: ViTConfig, generator: torch.Generator,
                    dtype=torch.float32, device="cuda"):
    """Same shapes and scales as the JAX init (normal × 0.02, LN ones/zeros)."""
    d, f = cfg.d_model, cfg.d_ffn
    layers = []
    for _ in range(cfg.n_layers):
        p = {"ln1": _ln(d, dtype, device), "ln2": _ln(d, dtype, device)}
        if cfg.fused_qkv:
            p["qkv"] = _dense(d, 3 * d, generator, dtype, device)
        else:
            for name in ("q", "k", "v"):
                p[name] = _dense(d, d, generator, dtype, device)
        p.update(o=_dense(d, d, generator, dtype, device),
                 fc1=_dense(d, f, generator, dtype, device),
                 fc2=_dense(f, d, generator, dtype, device))
        layers.append(p)
    params = {
        "patch_embed": _dense(3 * cfg.patch_size ** 2, d, generator, dtype,
                              device),
        "pos_embed": _normal((cfg.n_tokens, d), generator, dtype, device),
        "post_ln": _ln(d, dtype, device),
        "layers": layers,
    }
    if cfg.use_cls_token:
        params["cls_token"] = _normal((d,), generator, dtype, device)
    if cfg.pre_layernorm:
        params["pre_ln"] = _ln(d, dtype, device)
    return params


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] → [B, (H/P)*(W/P), 3*P*P], channel-major (c, ph, pw)
    flattening — the layout of a ``Conv2d(3, d, P, stride=P)`` weight."""
    b, h, w, c = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # [B, gh, gw, c, ph, pw]
    return x.reshape(b, gh * gw, c * patch * patch)


def _split_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, l, d = t.shape
    return t.reshape(b, l, n_heads, d // n_heads).transpose(1, 2).contiguous()


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = o.shape
    return o.transpose(1, 2).reshape(b, l, h * dh)


def _vit_layer(p, cfg: ViTConfig, h: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[cfg.activation]
    x = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"], cfg.norm_eps)
    if cfg.fused_qkv:
        q, k, v = linear(x, p["qkv"]["w"], p["qkv"]["b"]).chunk(3, dim=-1)
    else:
        q, k, v = (linear(x, p[n]["w"], p[n]["b"]) for n in ("q", "k", "v"))
    o = multihead_attention(_split_heads(q, cfg.n_heads),
                            _split_heads(k, cfg.n_heads),
                            _split_heads(v, cfg.n_heads))
    h = h + linear(_merge_heads(o), p["o"]["w"], p["o"]["b"])
    x = layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"], cfg.norm_eps)
    return h + linear(act(linear(x, p["fc1"]["w"], p["fc1"]["b"])),
                      p["fc2"]["w"], p["fc2"]["b"])


def vit_forward(params, cfg: ViTConfig, pixels: torch.Tensor, *,
                stop_at_layer: Optional[int] = None,
                apply_post_ln: bool = True) -> torch.Tensor:
    """Normalized pixels [B, H, W, 3] → [B, n_tokens, d].

    ``stop_at_layer=k`` returns the hidden states after layer k, without
    later layers or the post-LN (LLaVA's ``hidden_states[-2]`` is
    ``stop_at_layer=n_layers - 1``); otherwise the post-LN applies unless
    ``apply_post_ln`` is False."""
    # The tower runs in the parameter dtype: the pixels arrive in float32.
    x = patchify(pixels, cfg.patch_size).to(params["patch_embed"]["w"].dtype)
    h = linear(x, params["patch_embed"]["w"], params["patch_embed"]["b"])
    if cfg.use_cls_token:
        cls = params["cls_token"].to(h.dtype).expand(h.shape[0], 1, -1)
        h = torch.cat([cls, h], dim=1)
    h = h + params["pos_embed"]
    if cfg.pre_layernorm and "pre_ln" in params:
        h = layer_norm(h, params["pre_ln"]["scale"], params["pre_ln"]["bias"],
                       cfg.norm_eps)
    hi = cfg.n_layers if stop_at_layer is None else stop_at_layer
    for p in params["layers"][:hi]:
        h = _vit_layer(p, cfg, h)
    if apply_post_ln and stop_at_layer is None:
        h = layer_norm(h, params["post_ln"]["scale"],
                       params["post_ln"]["bias"], cfg.norm_eps)
    return h
