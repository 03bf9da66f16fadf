"""The port's BLIP-2 model functions against the JAX package's, on the same
weights (the JAX init at PRNGKey(0), carried over by ``params_from_jax``)
and the same numpy inputs, in float32 on the tiny OPT config. atol 1e-4:
float32 matmul summation order differs between the frameworks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devqa_tpu.core import decoder as jdec
from devqa_tpu.core import qformer as jqf
from devqa_tpu.core import vit as jvit
from devqa_tpu.core import vllm as jvllm
from devqa_tpu_torch.core import decoder as tdec
from devqa_tpu_torch.core import qformer as tqf
from devqa_tpu_torch.core import vit as tvit
from devqa_tpu_torch.core import vllm as tvllm
from devqa_tpu_torch.ops import attention as tattn
from devqa_tpu_torch.utils.convert import params_from_jax

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jvllm.tiny_vllm_config("opt")
    tcfg = tvllm.tiny_vllm_config("opt")
    jparams = jvllm.init_vllm_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_tree, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    B, Lt = 4, 12
    ids = rng.integers(8, 512, size=(B, Lt)).astype(np.int32)
    lens = np.array([12, 7, 9, 3])
    text_mask = (np.arange(Lt)[None, :] < lens[:, None]).astype(np.int32)
    has_image = np.array([1, 0, 1, 0], np.int32)
    img = rng.normal(size=(B, tcfg.n_img_tokens, 32)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                pixels=pixels, ids=ids, text_mask=text_mask,
                has_image=has_image, img=img)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def test_config_geometry():
    cfg = tvllm.blip2_opt_2_7b_config()
    assert cfg.vit.n_tokens == 257 and cfg.vit.d_model // cfg.vit.n_heads == 88
    assert cfg.qformer.d_model // cfg.qformer.n_heads == 64
    assert cfg.decoder.head_dim == 80
    assert tdec._head_chunk(cfg.decoder.vocab_size) == 6284
    # every field the port keeps has the JAX package's value
    for tc, jc in ((cfg, jvllm.blip2_opt_2_7b_config()),
                   (tvllm.tiny_vllm_config("opt"), jvllm.tiny_vllm_config("opt"))):
        jd = jc.to_dict()
        for name, sub in tc.to_dict().items():
            if isinstance(sub, dict):
                assert sub == {k: jd[name][k] for k in sub}, name
            else:
                assert sub == jd[name], name


def test_patchify(models):
    x = models["pixels"]
    _close(tvit.patchify(torch.from_numpy(x), 4), jvit.patchify(jnp.asarray(x), 4),
           atol=0)


def test_vit_forward(models):
    m = models
    j = jvit.vit_forward(m["jparams"]["vit"], m["jcfg"].vit,
                         jnp.asarray(m["pixels"]))
    t = tvit.vit_forward(m["tparams"]["vit"], m["tcfg"].vit,
                         torch.from_numpy(m["pixels"]))
    _close(t, j)


def test_qformer_forward(models):
    m = models
    feats = np.random.default_rng(1).normal(size=(2, 17, 32)).astype(np.float32)
    j = jqf.qformer_forward(m["jparams"]["qformer"], m["jcfg"].qformer,
                            jnp.asarray(feats))
    t = tqf.qformer_forward(m["tparams"]["qformer"], m["tcfg"].qformer,
                            torch.from_numpy(feats))
    _close(t, j)


def test_encode_image(models):
    m = models
    j = jvllm.encode_image(m["jparams"], m["jcfg"], jnp.asarray(m["pixels"]))
    t = tvllm.encode_image(m["tparams"], m["tcfg"], torch.from_numpy(m["pixels"]))
    _close(t, j)


def _assembled(m):
    j = jvllm.assemble_embeds(m["jparams"], m["jcfg"], jnp.asarray(m["ids"]),
                              jnp.asarray(m["text_mask"]),
                              jnp.asarray(m["img"]),
                              jnp.asarray(m["has_image"]))
    t = tvllm.assemble_embeds(m["tparams"], m["tcfg"],
                              torch.from_numpy(m["ids"]).long(),
                              torch.from_numpy(m["text_mask"]),
                              torch.from_numpy(m["img"]),
                              torch.from_numpy(m["has_image"]))
    return j, t


def test_assemble_embeds(models):
    (je, jkv), (te, tkv) = _assembled(models)
    _close(te, je, atol=0)
    assert np.array_equal(tkv.numpy(), np.asarray(jkv))


def test_decoder_forward_logits_and_pred_ids(models):
    m = models
    (je, jkv), (te, tkv) = _assembled(m)
    jdp, tdp = m["jparams"]["decoder"], m["tparams"]["decoder"]
    jd, td = m["jcfg"].decoder, m["tcfg"].decoder
    jh = jdec.decoder_forward(jdp, jd, je, jkv,
                              layer_residual=(2, lambda h: h * 1.5 + 0.1))
    th = tdec.decoder_forward(tdp, td, te, tkv,
                              layer_residual=(2, lambda h: h * 1.5 + 0.1))
    _close(th, jh)
    # the layer_residual really changed the result
    plain = tdec.decoder_forward(tdp, td, te, tkv)
    assert (plain - th).abs().max().item() > 1e-3
    # a [lo, hi) split resumes to the same hidden state
    mid = tdec.decoder_forward(tdp, td, te, tkv, hi=2)
    torch.testing.assert_close(tdec.decoder_forward(tdp, td, mid, tkv, lo=2),
                               plain, atol=1e-6, rtol=0)
    _close(tdec.decoder_logits(tdp, td, th), jdec.decoder_logits(jdp, jd, jh))
    assert np.array_equal(tdec.decoder_pred_ids(tdp, td, th).numpy(),
                          np.asarray(jdec.decoder_pred_ids(jdp, jd, jh)))


def test_pred_ids_chunked_running_argmax():
    """The vocab-chunked running argmax equals a plain argmax, ties to the
    first index across chunk boundaries (strict >)."""
    V, d = 3 * 2048, 8
    cfg = tdec.DecoderConfig(vocab_size=V, d_model=d, n_layers=1, n_heads=1,
                             d_ffn=8)
    assert tdec._head_chunk(V) == V  # ≤ 8192: one chunk
    cfg = cfg.replace(vocab_size=5 * 2048)
    assert tdec._head_chunk(cfg.vocab_size) == 5120
    emb = torch.randn(cfg.vocab_size, d, generator=torch.Generator().manual_seed(0))
    params = {"embed_tokens": emb,
              "final_norm": {"scale": torch.ones(d), "bias": torch.zeros(d)}}
    h = torch.randn(6, d, generator=torch.Generator().manual_seed(1))
    a = int(torch.argmax(tdec.decoder_logits(params, cfg, h[:1])))
    first, second = (a, a + 5120) if a < 5120 else (a - 5120, a)
    emb[first] = emb[second] = emb[a].clone()  # an exact tie across chunks
    ref = torch.argmax(tdec.decoder_logits(params, cfg, h), dim=-1)
    got = tdec.decoder_pred_ids(params, cfg, h)
    assert torch.equal(got, ref) and got[0].item() == first


def test_dead_rows_do_not_reach_live_logits(models, monkeypatch):
    """On the card every attention call takes the flash contract (a dead
    row, e.g. the masked vision slot of a no-image row, gets zeros) where
    the CPU path averages uniformly: logits at live positions agree."""
    m = models
    _, (te, tkv) = _assembled(m)
    tdp, td = m["tparams"]["decoder"], m["tcfg"].decoder
    xla = tdec.decoder_logits(tdp, td, tdec.decoder_forward(tdp, td, te, tkv))
    monkeypatch.setattr(
        tdec, "multihead_attention",
        lambda q, k, v, kv_valid=None, causal=False:
            tattn.flash_attention_ref(q, k, v, kv_valid, causal))
    flash = tdec.decoder_logits(tdp, td, tdec.decoder_forward(tdp, td, te, tkv))
    live = tkv.bool()
    assert (~live).any()
    torch.testing.assert_close(flash[live], xla[live], atol=1e-5, rtol=0)
    assert (flash[~live] - xla[~live]).abs().max().item() > 1e-3
