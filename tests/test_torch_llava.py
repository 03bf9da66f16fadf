"""LLaVA-1.5 in the port against the JAX package: the CLIP split-qkv tower,
the MLP bridge, the LLaMA decoder (RMSNorm, RoPE, grouped-query k/v,
SwiGLU, untied head) and the image-token prompt rule, on the same weights
(one JAX init, carried over by ``params_from_jax``) and the same numpy
inputs, in float32 on the JAX bench's tiny LLaVA geometry (2 ViT layers,
2 decoder layers). atol 1e-4: float32 matmul summation order differs
between the frameworks. Then the fused sequential evaluation with LiveEdit
end to end (results identical), and the kernel contract of every attention
call on a bf16 LLaVA path at the real head dims (64 and 128)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import write_records
from test_liveedit import tiny_liveedit_cfg

import chip_smoke
from devqa_tpu.core import decoder as jdec
from devqa_tpu.core import vit as jvit
from devqa_tpu.core import vllm as jvllm
from devqa_tpu.core.tokenizer import ToyTokenizer as JToyTokenizer
from devqa_tpu.core.wrapper import JaxVLLM
from devqa_tpu.data.images import SyntheticImageProvider as JImages
from devqa_tpu.data.schema import EVQA as JEVQA
from devqa_tpu.editors.liveedit import LiveEdit as JLiveEdit
from devqa_tpu.eval.harness import FusedEditorEvaluation as JFused
from devqa_tpu.ops import layers as jlayers
from devqa_tpu.retrieval.store import hash_encoder as j_hash_encoder
from devqa_tpu_torch.core import decoder as tdec
from devqa_tpu_torch.core import vit as tvit
from devqa_tpu_torch.core import vllm as tvllm
from devqa_tpu_torch.core.tokenizer import ToyTokenizer
from devqa_tpu_torch.core.wrapper import TorchVLLM
from devqa_tpu_torch.data.images import SyntheticImageProvider
from devqa_tpu_torch.data.schema import EVQA as TEVQA
from devqa_tpu_torch.editors.liveedit import LiveEdit as TLiveEdit
from devqa_tpu_torch.editors.liveedit import LiveEditConfig as TLiveEditConfig
from devqa_tpu_torch.eval.harness import FusedEditorEvaluation as TFused
from devqa_tpu_torch.ops import attention as tattn
from devqa_tpu_torch.ops import layers as tlayers
from devqa_tpu_torch.retrieval.store import hash_encoder as t_hash_encoder
from devqa_tpu_torch.utils.config import BaseConfig
from devqa_tpu_torch.utils.convert import (liveedit_params_from_jax,
                                           params_from_jax)

ATOL = 1e-4


def _tiny(mod):
    """The JAX bench's tiny LLaVA (``bench.py`` CPU branch): the mlp-bridge
    code path at tiny widths, 2 decoder layers, in ``mod``'s classes."""
    cfg = mod.llava_v15_7b_config()
    return dataclasses.replace(
        cfg, name="tiny-llava",
        vit=dataclasses.replace(cfg.vit, image_size=32, patch_size=16,
                                d_model=32, n_layers=2, n_heads=2, d_ffn=64),
        vit_feature_layer=1, n_img_tokens=4,
        decoder=dataclasses.replace(cfg.decoder, d_model=64, n_heads=2,
                                    d_ffn=128, vocab_size=512, n_layers=2,
                                    max_positions=256))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _tiny(jvllm), _tiny(tvllm)
    jparams = jvllm.init_vllm_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(_np_tree(jparams), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    B, Lt = 4, 12
    ids = rng.integers(8, 512, size=(B, Lt)).astype(np.int32)
    lens = np.array([12, 7, 9, 3])
    text_mask = (np.arange(Lt)[None, :] < lens[:, None]).astype(np.int32)
    has_image = np.array([1, 0, 1, 0], np.int32)
    img = rng.normal(size=(B, tcfg.n_img_tokens, 64)).astype(np.float32)
    je, jkv = jvllm.assemble_embeds(jparams, jcfg, jnp.asarray(ids),
                                    jnp.asarray(text_mask), jnp.asarray(img),
                                    jnp.asarray(has_image))
    te, tkv = tvllm.assemble_embeds(
        tparams, tcfg, torch.from_numpy(ids).long(),
        torch.from_numpy(text_mask), torch.from_numpy(img),
        torch.from_numpy(has_image))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                pixels=pixels, je=je, jkv=jkv, te=te, tkv=tkv)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def _same_fields(tc: BaseConfig, jc) -> None:
    """Every field the port's config keeps has the JAX config's value."""
    jd = jc.to_dict()
    for name, sub in tc.to_dict().items():
        if isinstance(sub, dict):
            assert sub == {k: jd[name][k] for k in sub}, name
        else:
            assert sub == jd[name], name


def test_config_geometry():
    cfg = tvllm.llava_v15_7b_config()
    assert cfg.bridge == "mlp" and cfg.vt_range == (1, 577)
    assert cfg.vit.n_tokens == 577 and cfg.vit_feature_layer == 23
    assert cfg.vit.d_model // cfg.vit.n_heads == 64
    assert cfg.decoder.head_dim == 128 and cfg.decoder.kv_heads == 32
    assert tdec._head_chunk(cfg.decoder.vocab_size) == 8000
    for tc, jc in ((cfg, jvllm.llava_v15_7b_config()),
                   (_tiny(tvllm), _tiny(jvllm)),
                   (tvllm.tiny_vllm_config("llama"),
                    jvllm.tiny_vllm_config("llama"))):
        _same_fields(tc, jc)


def test_unported_decoders_are_refused():
    for cfg in (jdec.gptj_6b_config(), jdec.glm_4_9b_config()):
        tcfg = tdec.DecoderConfig(**{f.name: getattr(cfg, f.name) for f in
                                     dataclasses.fields(tdec.DecoderConfig)})
        with pytest.raises(NotImplementedError, match="not ported"):
            tdec.init_decoder_params(tcfg, torch.Generator(), device="meta")
    with pytest.raises(NotImplementedError, match="bridge"):
        tvllm.init_vllm_params(
            tvllm.llava_v15_7b_config().replace(bridge="resampler"),
            torch.Generator(), device="meta")


def test_rms_norm_and_activations():
    x = np.random.default_rng(2).normal(size=(3, 5, 16)).astype(np.float32)
    scale = np.linspace(0.5, 1.5, 16).astype(np.float32)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), 1e-6)
    for name in ("quick_gelu", "silu"):
        _close(tlayers.ACTIVATIONS[name](torch.from_numpy(x)),
               jdec.ACTIVATIONS[name](jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("stop_at_layer,apply_post_ln", [
    (None, True), (None, False), (1, True)])
def test_clip_tower(models, stop_at_layer, apply_post_ln):
    """Split q/k/v, embedding pre-LN, quick GELU; the penultimate layer
    without the post-LN as LLaVA reads it, and the whole tower."""
    m = models
    kw = dict(stop_at_layer=stop_at_layer, apply_post_ln=apply_post_ln)
    j = jvit.vit_forward(m["jparams"]["vit"], m["jcfg"].vit,
                         jnp.asarray(m["pixels"]), **kw)
    t = tvit.vit_forward(m["tparams"]["vit"], m["tcfg"].vit,
                         torch.from_numpy(m["pixels"]), **kw)
    assert t.shape == (3, 5, 32)
    _close(t, j)


def test_encode_image_through_mlp_bridge(models):
    m = models
    j = jvllm.encode_image(m["jparams"], m["jcfg"], jnp.asarray(m["pixels"]))
    t = tvllm.encode_image(m["tparams"], m["tcfg"],
                           torch.from_numpy(m["pixels"]))
    assert t.shape == (3, 4, 64)
    _close(t, j)


def test_rope_and_repeat_kv():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 4, 9, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 9, 16)).astype(np.float32)
    kv = (rng.random((2, 9)) < 0.7).astype(np.int32)
    pos_j = jdec.positions_from_mask(jnp.asarray(kv))
    pos_t = tdec.positions_from_mask(torch.from_numpy(kv))
    assert np.array_equal(pos_t.numpy(), np.asarray(pos_j))
    jq, jk = jdec._rope(jnp.asarray(q), jnp.asarray(k), pos_j, 10000.0)
    tq, tk = tdec._rope(torch.from_numpy(q), torch.from_numpy(k), pos_t,
                        10000.0)
    _close(tq, jq, 1e-5)
    _close(tk, jk, 1e-5)
    for n_rep in (1, 2):
        t = tdec._repeat_kv(torch.from_numpy(k), n_rep)
        assert t.is_contiguous()
        _close(t, jdec._repeat_kv(jnp.asarray(k), n_rep), 0)


@pytest.mark.parametrize("n_kv_heads", [2, 1])
def test_llama_decoder_forward(models, n_kv_heads):
    """From lo = 0 and resumed at lo = 1 with an mlp_residual, with every
    head its own k/v (2) and with grouped-query k/v (1)."""
    m = models
    jd, td = m["jcfg"].decoder, m["tcfg"].decoder
    jdp, tdp = m["jparams"]["decoder"], m["tparams"]["decoder"]
    if n_kv_heads != td.n_heads:
        jd, td = (c.replace(n_kv_heads=n_kv_heads) for c in (jd, td))
        jdp = jdec.init_decoder_params(jd, jax.random.PRNGKey(5))
        tdp = params_from_jax({"decoder": _np_tree(jdp)},
                              m["tcfg"].replace(decoder=td),
                              device="cpu")["decoder"]
        assert tdp["layers"][0]["k"]["w"].shape == (64, 32)
    je, jkv, te, tkv = m["je"], m["jkv"], m["te"], m["tkv"]
    plain_j = jdec.decoder_forward(jdp, jd, je, jkv)
    plain = tdec.decoder_forward(tdp, td, te, tkv)
    _close(plain, plain_j)
    # A [lo, hi) split resumes to the same hidden state: the resumed layer
    # rotates with the same positions.
    mid = tdec.decoder_forward(tdp, td, te, tkv, hi=1)
    torch.testing.assert_close(tdec.decoder_forward(tdp, td, mid, tkv, lo=1),
                               plain, atol=1e-6, rtol=0)

    def delta(x):
        return x * 0.5 - 0.25

    t = tdec.decoder_forward(tdp, td, mid, tkv, lo=1, mlp_residual=(1, delta))
    j = jdec.decoder_forward(jdp, jd, jdec.decoder_forward(jdp, jd, je, jkv,
                                                           hi=1),
                             jkv, lo=1, mlp_residual=(1, delta))
    _close(t, j)
    assert (t - plain).abs().max().item() > 1e-3


def test_logits_and_pred_ids_with_untied_head(models, monkeypatch):
    m = models
    jd, td = m["jcfg"].decoder, m["tcfg"].decoder
    jdp, tdp = m["jparams"]["decoder"], m["tparams"]["decoder"]
    assert "lm_head" in tdp and not td.tie_word_embeddings
    jh = jdec.decoder_forward(jdp, jd, m["je"], m["jkv"])
    th = tdec.decoder_forward(tdp, td, m["te"], m["tkv"])
    _close(tdec.decoder_logits(tdp, td, th), jdec.decoder_logits(jdp, jd, jh))
    for chunk in (None, 128):  # one chunk, then four
        if chunk is not None:
            monkeypatch.setattr(tdec, "_head_chunk", lambda V: chunk)
            monkeypatch.setattr(jdec, "_head_chunk", lambda V: chunk)
        assert np.array_equal(tdec.decoder_pred_ids(tdp, td, th).numpy(),
                              np.asarray(jdec.decoder_pred_ids(jdp, jd, jh)))


def _wrappers(models):
    m = models
    jv = JaxVLLM(m["jcfg"], m["jparams"], JToyTokenizer(vocab_size=512),
                 JImages(32), bucket_multiple=8)
    tv = TorchVLLM(m["tcfg"], m["tparams"], ToyTokenizer(512),
                   SyntheticImageProvider(32), bucket_multiple=8,
                   min_len=jv.min_len, img_batch_pad=jv.img_batch_pad)
    return jv, tv


def test_prompt_text_image_token_rule(models):
    jv, tv = _wrappers(models)
    prompts = ["<image>\nwhat is the cat near", "what <image> is it",
               "no token here", "<image>"]
    for p in prompts:
        for has in (True, False):
            assert tv._prompt_text(p, has) == jv._prompt_text(p, has)
    assert tv._prompt_text("<image>\nwhat", True) == "\nwhat"
    assert tv._prompt_text("<image>\nwhat", False) == "what"
    # (an empty prompt raises in both packages, as in the reference)
    prompts[-1] = "<image>\nwho is it"
    images = ["img_0.jpg", None, "img_1.jpg", None]
    targets = ["dog", "cat", "sky", "tree"]
    got = tv.tokenize_queries(prompts, images, targets)
    want = jv.tokenize_queries(prompts, images, targets)
    assert [(s.input_ids.tolist(), s.prompt_len, s.image_id) for s in got] \
        == [(s.input_ids.tolist(), s.prompt_len, s.image_id) for s in want]
    # The BLIP-2 configs have no image token: prompts pass unchanged.
    tv.cfg = tvllm.blip2_opt_2_7b_config()
    assert tv._prompt_text("<image> x", True) == "<image> x"


def _drop_edit_time(tree):
    if isinstance(tree, dict):
        return {k: _drop_edit_time(v) for k, v in tree.items()
                if k != "edit_time"}
    if isinstance(tree, list):
        return [_drop_edit_time(x) for x in tree]
    return tree


def test_fused_sequential_eval_matches_jax(models, tmp_path):
    """LiveEdit (edit layer 0 of 2) under the fused sequential evaluation:
    the same mean_results and per-probe results as the JAX harness."""
    jv, tv = _wrappers(models)
    jcfg = tiny_liveedit_cfg(jv).replace(edit_layer_i=0)
    jed = JLiveEdit(jv, jcfg, seed=3)
    ted = TLiveEdit(tv, TLiveEditConfig.from_dict(jcfg.to_dict()),
                    params=liveedit_params_from_jax(_np_tree(jed.params),
                                                    device="cpu"))
    path, _ = write_records(str(tmp_path), 4)
    img_root = str(tmp_path / "imgs")
    out = {}
    for name, cls, ed, data in (
            ("jax", JFused, jed, JEVQA(path, img_root,
                                       encoder=j_hash_encoder(16))),
            ("torch", TFused, ted, TEVQA(path, img_root,
                                         encoder=t_hash_encoder(16),
                                         device="cpu"))):
        fe = cls(ed, data, "slice", str(tmp_path / name), max_rows=16,
                 pre_rows=9, post_rows=12)
        fe.evaluate_sequential_edit(edit_n=2)
        d = os.path.join(str(tmp_path / name), "liveedit", "tiny-llava",
                         "slice", "sequential_edit_2")
        with open(os.path.join(d, "mean_results.json")) as f:
            mean = json.load(f)
        with open(os.path.join(d, "results.json")) as f:
            res = json.load(f)
        out[name] = (_drop_edit_time(mean), _drop_edit_time(res))
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][0]["total_mean"]["total_edit_n"] == 4


def test_llava_path_meets_kernel_contract(monkeypatch):
    """``chip_smoke.py``'s LLaVA phases (the fused LiveEdit evaluation at
    the bench settings, then the comparison with plain attention) rehearsed
    on the CPU in bfloat16 at the real head dims (CLIP 64, Vicuna 128):
    every attention call has the dtypes, shapes and layout the forward
    kernel takes (its device aside), and the run's checks pass."""
    cfg = _tiny(tvllm)
    cfg = cfg.replace(
        vit=cfg.vit.replace(d_model=128, d_ffn=64, n_layers=3),
        vit_feature_layer=2,
        decoder=cfg.decoder.replace(d_model=256, d_ffn=64, n_layers=3))
    calls = []

    def checked(q, k, v, kv_valid=None, causal=False):
        tattn.check_kernel_layout(q, k, v, kv_valid)
        calls.append((q.shape[3], q.shape[2], k.shape[2], kv_valid is not None,
                      causal))
        return tattn.flash_attention_ref(q, k, v, kv_valid, causal)

    monkeypatch.setattr(tattn, "xla_attention", checked)
    _, line, ref = chip_smoke.drive_main_path(cfg, "cpu",
                                              path=chip_smoke.LLAVA_EVAL)
    # (head dim, Lq, Lk, masked, causal): the tower's layers read, then the
    # decoder over [BOS | slot 4 | text 63]
    assert set(calls) == {(64, 5, 5, False, False),
                          (128, 68, 68, True, True)}
    assert line["cases"] == 8 and line["edit_n"] == 4
    assert ref["phase"] == "llava_reference" and ref["rows"] == 12


@pytest.mark.parametrize("ratio,ok", [(0.9, True), (1.24, True),
                                      (1.26, False), (2.0, False)])
def test_chained_logits_gate_is_relative_to_their_floor(ratio, ok):
    """``llava_reference`` gates the chained logits at 1.25 x their bf16
    noise floor (plain against float32 attention, on the same line);
    BLIP-2's reference keeps the absolute 5e-2."""
    floor = 0.0501
    out = {"vision_rel_l2": 0.014, "decoder_logits_rel_l2": 0.03,
           "logits_rel_l2": ratio * floor,
           "logits_rel_l2_plain_vs_float32": floor}
    out["bounds"] = chip_smoke.reference_bounds(
        out, chip_smoke.LLAVA_EVAL.chained_floor_factor)
    assert out["bounds"]["logits_rel_l2"] == pytest.approx(1.25 * floor)
    if ok:
        chip_smoke.check_bounds(out)
    else:
        with pytest.raises(AssertionError, match="logits_rel_l2"):
            chip_smoke.check_bounds(out)
    assert chip_smoke.reference_bounds(
        out, chip_smoke.BLIP2_EVAL.chained_floor_factor) == dict.fromkeys(
        ("vision_rel_l2", "decoder_logits_rel_l2", "logits_rel_l2"),
        chip_smoke.LOGITS_TOL)
