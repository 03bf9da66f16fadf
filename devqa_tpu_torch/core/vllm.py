"""BLIP-2-OPT and LLaVA-1.5 compositions: the Q-Former and MLP bridges
(counterpart of ``devqa_tpu/core/vllm.py``).

One batched layout for image and no-image rows:

    [ text[:, :p] | vision slot block (V tokens) | text[:, p:] ]

BLIP-2 puts the 32 Q-Former tokens at p = 0; LLaVA puts its 576 CLIP
tokens (penultimate layer, class token dropped, through a two-layer MLP)
at p = 1, after BOS. Rows without an image keep the slot block but mask
it off in ``kv_valid``; mask-derived positions make that equivalent to the
shorter no-image sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..ops.layers import gelu_exact, linear, matmul_f32
from ..utils.config import BaseConfig
from . import decoder as dec
from . import qformer as qf
from . import vit as vit_mod


@dataclasses.dataclass(frozen=True)
class VLLMConfig(BaseConfig):
    name: str = "blip2-opt-2.7b"
    bridge: str = "qformer"
    img_slot_pos: int = 0    # where the vision block sits in the text stream
    n_img_tokens: int = 32
    vit: vit_mod.ViTConfig = dataclasses.field(
        default_factory=vit_mod.blip2_vit_config)
    qformer: Optional[qf.QFormerConfig] = dataclasses.field(
        default_factory=qf.blip2_qformer_config)
    decoder: dec.DecoderConfig = dataclasses.field(
        default_factory=dec.opt_2_7b_config)
    vit_feature_layer: Optional[int] = None  # LLaVA: the tower's layer read
    # The image's special token in prompts (LLaVA's "<image>"), stripped
    # before tokenizing: the slot layout stands for it.
    img_special_token: Optional[str] = None

    @property
    def vt_range(self) -> Tuple[int, int]:
        """Vision-token range in the full layout ([0, 32] for BLIP-2)."""
        return (self.img_slot_pos, self.img_slot_pos + self.n_img_tokens)


def blip2_opt_2_7b_config() -> VLLMConfig:
    return VLLMConfig(
        name="blip2-opt-2.7b", bridge="qformer", img_slot_pos=0,
        n_img_tokens=32, vit=vit_mod.blip2_vit_config(),
        qformer=qf.blip2_qformer_config(), decoder=dec.opt_2_7b_config())


def llava_v15_7b_config() -> VLLMConfig:
    """CLIP ViT-L/14-336 (penultimate layer) → MLP → Vicuna-7b, with the
    576 vision tokens after BOS."""
    vit_cfg = vit_mod.clip_vit_l_336_config()
    return VLLMConfig(
        name="llava-v1.5-7b", bridge="mlp", img_slot_pos=1, n_img_tokens=576,
        vit=vit_cfg, qformer=None, decoder=dec.vicuna_7b_config(),
        vit_feature_layer=vit_cfg.n_layers - 1, img_special_token="<image>")


def tiny_vllm_config(arch: str = "opt", img_slot_pos: int = 0) -> VLLMConfig:
    """The JAX package's tiny test geometry (Q-Former bridge; an OPT or a
    LLaMA decoder)."""
    vit_cfg = vit_mod.ViTConfig(
        image_size=16, patch_size=4, d_model=32, n_layers=2, n_heads=2,
        d_ffn=64, fused_qkv=True, pre_layernorm=True)
    qf_cfg = qf.QFormerConfig(
        d_model=24, n_layers=2, n_heads=2, d_ffn=48, n_query_tokens=4,
        encoder_width=32, cross_attention_frequency=2)
    dcfg = dec.DecoderConfig(
        arch=arch, vocab_size=512, d_model=32, n_layers=4, n_heads=2,
        d_ffn=64, max_positions=128,
        activation="relu" if arch == "opt" else "silu",
        tie_word_embeddings=(arch == "opt"))
    return VLLMConfig(name="tiny-%s" % arch, bridge="qformer",
                      img_slot_pos=img_slot_pos, n_img_tokens=4, vit=vit_cfg,
                      qformer=qf_cfg, decoder=dcfg)


def _check_bridge(cfg: VLLMConfig) -> None:
    if cfg.bridge not in ("qformer", "mlp"):
        raise NotImplementedError("bridge %r is not ported; the Q-Former "
                                  "and MLP bridges are" % cfg.bridge)


def init_vllm_params(cfg: VLLMConfig, generator: torch.Generator,
                     dtype=torch.float32, device="cuda"):
    """Random parameters with the JAX init's shapes and scales. The
    generator must live on ``device``."""
    _check_bridge(cfg)
    d_llm = cfg.decoder.d_model
    params = {
        "vit": vit_mod.init_vit_params(cfg.vit, generator, dtype, device),
        "decoder": dec.init_decoder_params(cfg.decoder, generator, dtype,
                                           device),
    }
    if cfg.bridge == "qformer":
        params["qformer"] = qf.init_qformer_params(cfg.qformer, generator,
                                                   dtype, device)
        params["projection"] = vit_mod._dense(cfg.qformer.d_model, d_llm,
                                              generator, dtype, device)
    else:
        params["projection"] = {
            "fc1": vit_mod._dense(cfg.vit.d_model, d_llm, generator, dtype,
                                  device),
            "fc2": vit_mod._dense(d_llm, d_llm, generator, dtype, device)}
    return params


def encode_image(params, cfg: VLLMConfig, pixels: torch.Tensor) -> torch.Tensor:
    """Normalized pixels [B, S, S, 3] → vision tokens [B, V, d_llm].

    BLIP-2: ViT → Q-Former → linear projection. LLaVA: the ViT's hidden
    states at ``vit_feature_layer`` (no post-LN), class token dropped →
    fc1 → exact GELU (in float32, then cast to the tower's dtype) → fc2."""
    _check_bridge(cfg)
    if cfg.bridge == "qformer":
        feats = vit_mod.vit_forward(params["vit"], cfg.vit, pixels)
        q = qf.qformer_forward(params["qformer"], cfg.qformer, feats)
        return linear(q, params["projection"]["w"], params["projection"]["b"])
    feats = vit_mod.vit_forward(params["vit"], cfg.vit, pixels,
                                stop_at_layer=cfg.vit_feature_layer,
                                apply_post_ln=False)[:, 1:]
    p = params["projection"]
    h = gelu_exact(matmul_f32(feats, p["fc1"]["w"]) + p["fc1"]["b"])
    return linear(h.to(feats.dtype), p["fc2"]["w"], p["fc2"]["b"])


def assemble_embeds(params, cfg: VLLMConfig, input_ids: torch.Tensor,
                    text_mask: torch.Tensor, img_tokens: torch.Tensor,
                    has_image: torch.Tensor):
    """→ (inputs_embeds [B, Lt+V, d], kv_valid [B, Lt+V] int32) in the
    ``[text[:p] | slot | text[p:]]`` layout; the slot is live only where
    ``has_image``."""
    p = cfg.img_slot_pos
    tok = dec.embed_tokens(params["decoder"], cfg.decoder, input_ids)
    embeds = torch.cat([tok[:, :p], img_tokens.to(tok.dtype), tok[:, p:]],
                       dim=1)
    img_valid = has_image.to(torch.int32)[:, None].expand(
        tok.shape[0], cfg.n_img_tokens)
    text_mask = text_mask.to(torch.int32)
    kv_valid = torch.cat([text_mask[:, :p], img_valid, text_mask[:, p:]],
                         dim=1)
    return embeds, kv_valid


def vllm_hidden(params, cfg: VLLMConfig, inputs_embeds, kv_valid, *,
                layer_residual: Optional[Tuple[int, Callable]] = None,
                mlp_residual: Optional[Tuple[int, Callable]] = None):
    """Final-layer hidden states (``vllm_logits`` without the LM head)."""
    return dec.decoder_forward(params["decoder"], cfg.decoder, inputs_embeds,
                               kv_valid, layer_residual=layer_residual,
                               mlp_residual=mlp_residual)


def vllm_logits(params, cfg: VLLMConfig, inputs_embeds, kv_valid, *,
                layer_residual: Optional[Tuple[int, Callable]] = None,
                mlp_residual: Optional[Tuple[int, Callable]] = None):
    """Full-sequence teacher-forced logits [B, L, V] f32, with optional
    editor interventions."""
    h = vllm_hidden(params, cfg, inputs_embeds, kv_valid,
                    layer_residual=layer_residual, mlp_residual=mlp_residual)
    return dec.decoder_logits(params["decoder"], cfg.decoder, h)
