"""The slice end to end: both packages run the fused sequential evaluation
with LiveEdit on the same synthetic EVQA cases with the same weights (the
JAX inits, carried over by ``utils.convert``), in float32 on the tiny OPT
config. The t×i probe sets and the written ``mean_results`` must be
identical (edit wall times excepted)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from helpers import make_tiny_vllm, write_records
from test_liveedit import tiny_liveedit_cfg

from devqa_tpu.data.schema import EVQA as JEVQA
from devqa_tpu.editors.liveedit import LiveEdit as JLiveEdit
from devqa_tpu.eval.harness import EditorEvaluation as JEval
from devqa_tpu.eval.harness import FusedEditorEvaluation as JFused
from devqa_tpu.eval.harness import case_probe_specs as j_specs
from devqa_tpu.retrieval.store import Retriever as JRetriever
from devqa_tpu.retrieval.store import EmbeddingStore as JStore
from devqa_tpu.retrieval.store import hash_encoder as j_hash_encoder
from devqa_tpu_torch.core import decoder as tdec
from devqa_tpu_torch.core import qformer as tqf
from devqa_tpu_torch.core import vit as tvit
from devqa_tpu_torch.core.tokenizer import ToyTokenizer
from devqa_tpu_torch.core.vllm import VLLMConfig, init_vllm_params
from devqa_tpu_torch.core.wrapper import TorchVLLM
from devqa_tpu_torch.data.images import SyntheticImageProvider
from devqa_tpu_torch.data.schema import EVQA as TEVQA
from devqa_tpu_torch.editors.liveedit import LiveEdit as TLiveEdit
from devqa_tpu_torch.editors.liveedit import LiveEditConfig as TLiveEditConfig
from devqa_tpu_torch.eval.harness import EditorEvaluation as TEval
from devqa_tpu_torch.eval.harness import FusedEditorEvaluation as TFused
from devqa_tpu_torch.eval.harness import case_probe_specs as t_specs
from devqa_tpu_torch.ops import attention as tattn
from devqa_tpu_torch.retrieval.store import EmbeddingStore as TStore
from devqa_tpu_torch.retrieval.store import Retriever as TRetriever
from devqa_tpu_torch.retrieval.store import hash_encoder as t_hash_encoder
from devqa_tpu_torch.utils.convert import (liveedit_params_from_jax,
                                           params_from_jax)
from devqa_tpu_torch.core.vllm import tiny_vllm_config


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_vllm(jvllm):
    cfg = tiny_vllm_config("opt")
    params = params_from_jax(_np_tree(jvllm.params), cfg, device="cpu")
    return TorchVLLM(cfg, params, ToyTokenizer(cfg.decoder.vocab_size),
                     SyntheticImageProvider(cfg.vit.image_size),
                     bucket_multiple=jvllm.bucket_multiple,
                     min_len=jvllm.min_len, img_batch_pad=jvllm.img_batch_pad)


def _editors(jcfg_max_edits=None):
    jvllm = make_tiny_vllm()
    jcfg = tiny_liveedit_cfg(jvllm)
    if jcfg_max_edits is not None:
        jcfg = jcfg.replace(max_edits=jcfg_max_edits)
    jed = JLiveEdit(jvllm, jcfg, seed=3)
    tvllm = _torch_vllm(jvllm)
    ted = TLiveEdit(tvllm, TLiveEditConfig.from_dict(jcfg.to_dict()),
                    params=liveedit_params_from_jax(_np_tree(jed.params),
                                                    device="cpu"))
    return jed, ted


def _spec_tuples(specs):
    return [(s.kind, s.sub, s.index, s.prompt, s.image, s.target)
            for s in specs]


def _drop_edit_time(tree):
    if isinstance(tree, dict):
        return {k: _drop_edit_time(v) for k, v in tree.items()
                if k != "edit_time"}
    if isinstance(tree, list):
        return [_drop_edit_time(x) for x in tree]
    return tree


def test_fused_sequential_eval_matches_jax(tmp_path):
    jed, ted = _editors()
    path, _ = write_records(str(tmp_path), 4)
    img_root = str(tmp_path / "imgs")
    jdata = JEVQA(path, img_root, encoder=j_hash_encoder(16))
    tdata = TEVQA(path, img_root, encoder=t_hash_encoder(16), device="cpu")
    for jc, tc in zip(jdata.data, tdata.data):
        assert _spec_tuples(t_specs(tc)) == _spec_tuples(j_specs(jc))

    out = {}
    for name, cls, ed, data in (("jax", JFused, jed, jdata),
                                ("torch", TFused, ted, tdata)):
        fe = cls(ed, data, "slice", str(tmp_path / name), max_rows=16,
                 pre_rows=9, post_rows=12)
        fe.evaluate_sequential_edit(edit_n=2)
        assert fe._packed_editor_ok is True
        d = os.path.join(str(tmp_path / name), "liveedit", "tiny-opt",
                         "slice", "sequential_edit_2")
        with open(os.path.join(d, "mean_results.json")) as f:
            mean = json.load(f)
        with open(os.path.join(d, "results.json")) as f:
            res = json.load(f)
        out[name] = (_drop_edit_time(mean), _drop_edit_time(res))
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][0]["total_mean"]["total_edit_n"] == 4


@pytest.mark.parametrize("protocol", ["sequential", "single"])
def test_unfused_evaluation_matches_jax(tmp_path, protocol):
    """``EditorEvaluation``'s per-case protocols (one probe batch per case)
    write the same results as the JAX harness's."""
    jed, ted = _editors()
    path, _ = write_records(str(tmp_path), 2)
    img_root = str(tmp_path / "imgs")
    out = {}
    for name, cls, ed, data in (
            ("jax", JEval, jed, JEVQA(path, img_root,
                                      encoder=j_hash_encoder(16))),
            ("torch", TEval, ted, TEVQA(path, img_root,
                                        encoder=t_hash_encoder(16),
                                        device="cpu"))):
        ev = cls(ed, data, "unfused", str(tmp_path / name))
        if protocol == "single":
            ev.evaluate_single_edit()
            sub = "single_edit"
        else:
            ev.evaluate_sequential_edit(edit_n=2)
            sub = "sequential_edit_2"
        d = os.path.join(str(tmp_path / name), "liveedit", "tiny-opt",
                         "unfused", sub)
        with open(os.path.join(d, "results.json")) as f:
            out[name] = _drop_edit_time(json.load(f))
    assert out["torch"] == out["jax"]


def test_retriever_ties_resolve_like_jax():
    """Duplicate store sentences give exact score ties; both packages pick
    the lower index, so the retrieved t2/i2 probes agree."""
    enc_j, enc_t = j_hash_encoder(16), t_hash_encoder(16)
    sents = ["what is the cat", "the dog", "what is the cat", "a red car",
             "what is the cat", "the dog"]
    prompts = [(s, "ans%d" % (i % 2)) for i, s in enumerate(sents)]
    images = ["img%d" % i for i in range(len(sents))]
    jr = JRetriever(JStore.build(sents, enc_j, images, prompts), enc_j, top_k=4)
    tr = TRetriever(TStore.build(sents, enc_t, images, prompts), enc_t, top_k=4,
                    device="cpu")
    queries = ["what is the cat", "the dog", "cat", "red car"]
    trgs = ["ans0", "ans1", "ans1", "zzz"]
    assert tr.find_similar_batch(queries, trgs) == \
        jr.find_similar_batch(queries, trgs)


def test_edit_ring_wraps_like_jax():
    """More edits than pool slots: both packages keep the newest
    ``max_edits`` in the same ring slots and count every edit."""
    jed, ted = _editors(jcfg_max_edits=3)
    reqs = [{"prompt": "what is shown number %d The answer is:" % i,
             "image": "img_%d.jpg" % (i % 3) if i % 2 else None,
             "target_new": "thing%d" % i} for i in range(5)]
    for ed in (jed, ted):
        ed.edit_batch(reqs[:2])
        ed.edit_batch(reqs[2:])       # wraps: slots 2, 0, 1
        ed.edit_batch(reqs[:4] + reqs)  # more than capacity in one call
    assert ted.state["count"] == int(jed.state["count"]) == 5 + 9
    for key in ("eqr", "evr", "moe_c", "moe_r"):
        np.testing.assert_allclose(ted.state[key].numpy(),
                                   np.asarray(jed.state[key]), atol=1e-4,
                                   rtol=0, err_msg=key)


def test_packed_and_query_batch_paths_agree():
    """The packed probe path (full and gathered LM head) and the QueryBatch
    path give the same metrics under the edited model."""
    _, ted = _editors()
    vllm = ted.vllm
    prompts = ["what is the cat near The answer is:", "who wrote the book",
               "what color is the sky The answer is:"]
    images = ["img_0.jpg", None, "img_1.jpg"]
    targets = ["dog", "a long target of several words", "blue"]
    ted.edit_batch([{"prompt": prompts[0], "image": images[0],
                     "target_new": "zebra"}])
    qb = vllm.encode_queries(prompts, images, targets)
    a1, p1 = ted.query_metrics(qb)
    pq = vllm.encode_queries_packed(prompts, images, targets)
    vllm._gather_positions = 0
    a2, p2, v2 = ted.query_metrics_packed(pq)
    assert v2 is None and torch.equal(p1, p2)
    torch.testing.assert_close(a1, a2, atol=1e-6, rtol=0)
    vllm._gather_positions = 16
    a3, p3, v3 = ted.query_metrics_packed(pq)
    torch.testing.assert_close(a1, a3, atol=1e-6, rtol=0)
    masks = qb.label_masks
    for b in range(len(prompts)):
        assert torch.equal(p1[b][masks[b] == 1], p3[b][v3[b] == 1])


def _kernel_width_config():
    """Two layers per tower at the path's head dims: ViT 88, Q-Former 64
    (self- and cross-attention), OPT 80."""
    return VLLMConfig(
        name="kernel-width-opt", bridge="qformer", img_slot_pos=0,
        n_img_tokens=4,
        vit=tvit.ViTConfig(image_size=16, patch_size=4, d_model=176,
                           n_layers=2, n_heads=2, d_ffn=64,
                           pre_layernorm=False),
        qformer=tqf.QFormerConfig(d_model=128, n_layers=2, n_heads=2,
                                  d_ffn=64, n_query_tokens=4,
                                  encoder_width=176),
        decoder=tdec.DecoderConfig(vocab_size=512, d_model=160, n_layers=3,
                                   n_heads=2, d_ffn=64, max_positions=128))


def test_main_path_meets_kernel_contract(tmp_path, monkeypatch):
    """The fused LiveEdit evaluation in bfloat16 at the path's head dims:
    every attention call has the dtypes, shapes and layout the CUDA kernel
    takes (its device aside), and the run writes finite metrics."""
    cfg = _kernel_width_config()
    params = init_vllm_params(cfg, torch.Generator().manual_seed(0),
                              torch.bfloat16, "cpu")
    vllm = TorchVLLM(cfg, params, ToyTokenizer(cfg.decoder.vocab_size),
                     SyntheticImageProvider(cfg.vit.image_size),
                     bucket_multiple=16, min_len=16, img_batch_pad=2)
    lcfg = TLiveEditConfig(
        edit_model_name=cfg.name,
        retrieval_editor=TLiveEditConfig.RetrievalEditor(
            module_dim=16, cross_att_head_n=2, lora_rank=2, eqe_n=2),
        llm_mid_dim=cfg.decoder.d_model, edit_layer_i=1, max_edits=8,
        retrieve_top_k=4)
    editor = TLiveEdit(vllm, lcfg, seed=0)
    calls = []

    def checked(q, k, v, kv_valid=None, causal=False):
        tattn.check_kernel_layout(q, k, v, kv_valid)
        calls.append((q.shape[3], q.shape[2], k.shape[2], kv_valid is not None,
                      causal))
        return tattn.flash_attention_ref(q, k, v, kv_valid, causal)

    monkeypatch.setattr(tattn, "xla_attention", checked)
    path, _ = write_records(str(tmp_path), 4)
    data = TEVQA(path, str(tmp_path), encoder=t_hash_encoder(16), device="cpu")
    fe = TFused(editor, data, "contract", str(tmp_path / "res"),
                pre_rows=9, post_rows=12)
    fe.evaluate_sequential_edit(edit_n=2)
    # (head dim, Lq, Lk, masked, causal) of each kind of call on the path:
    # the ViT, the Q-Former's self- and cross-attention, then the decoder
    n_vit = cfg.vit.n_tokens
    kinds = set(calls)
    assert {c for c in kinds if c[0] != 80} == {
        (88, n_vit, n_vit, False, False),
        (64, 4, 4, False, False), (64, 4, n_vit, False, False)}
    assert {(c[0], c[3], c[4]) for c in kinds if c[0] == 80} == {
        (80, True, True)}
    d = os.path.join(str(tmp_path / "res"), "liveedit", cfg.name, "contract",
                     "sequential_edit_2")
    with open(os.path.join(d, "mean_results.json")) as f:
        mean = json.load(f)["total_mean"]
    accs = [mean["reliability"]["acc"]] + [
        v["acc"] for kind in ("generality", "locality")
        for v in mean[kind].values()]
    assert len(accs) == 12 and all(np.isfinite(accs))
