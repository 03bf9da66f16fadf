"""Vision transformer: the BLIP-2 EVA ViT-g tower (counterpart of ``devqa_tpu/core/vit.py``).

Fused qkv, post-LayerNorm, exact GELU, 224px/14 → 257 tokens (class token
+ 256 patches). Patch embedding is patchify + one matmul (the stride-P
convolution). Parameters are a dict; ``layers`` is a list of per-layer
dicts (the JAX package stacks them along a leading axis).
"""
from __future__ import annotations

import dataclasses

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
    if not cfg.fused_qkv:
        raise NotImplementedError("split-qkv towers (CLIP) are not ported yet")
    d, f = cfg.d_model, cfg.d_ffn
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": _ln(d, dtype, device), "ln2": _ln(d, dtype, device),
            "qkv": _dense(d, 3 * d, generator, dtype, device),
            "o": _dense(d, d, generator, dtype, device),
            "fc1": _dense(d, f, generator, dtype, device),
            "fc2": _dense(f, d, generator, dtype, device),
        })
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
    q, k, v = linear(x, p["qkv"]["w"], p["qkv"]["b"]).chunk(3, dim=-1)
    o = multihead_attention(_split_heads(q, cfg.n_heads),
                            _split_heads(k, cfg.n_heads),
                            _split_heads(v, cfg.n_heads))
    h = h + linear(_merge_heads(o), p["o"]["w"], p["o"]["b"])
    x = layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"], cfg.norm_eps)
    return h + linear(act(linear(x, p["fc1"]["w"], p["fc1"]["b"])),
                      p["fc2"]["w"], p["fc2"]["b"])


def vit_forward(params, cfg: ViTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """Normalized pixels [B, H, W, 3] → [B, n_tokens, d] (post-LN)."""
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
    for p in params["layers"]:
        h = _vit_layer(p, cfg, h)
    return layer_norm(h, params["post_ln"]["scale"], params["post_ln"]["bias"],
                      cfg.norm_eps)
