"""LiveEdit meta-training of LLaVA-1.5 in both packages, on the same weights
(the JAX inits, carried over by ``utils.convert``) and the same cases, in
float32 on the JAX bench's tiny LLaVA geometry (MLP bridge, LLaMA decoder:
RMSNorm, RoPE, SwiGLU, untied head) with three decoder layers and the edit
layer at 1, with every head its own k/v (``n_kv_heads`` 2) and with
grouped-query k/v (1):

- ``organize_batch_data`` draws the same rows, masks and picks, and builds
  the same rows: [BOS | vision slot | text] with the image-token prompt
  rule, text embeddings bitwise equal, the vision slot's tokens (CLIP and
  the bridge) within 1e-4 (float32 summation order);
- two ``train_step``s on one batch, with ``faithful_mid_layer_rerun`` off
  and on, give the same losses (relative 1e-5) and logs, and Adam's first
  moments agree per leaf (relative L2 1e-4, with the 1e-6 floor of
  ``test_torch_train.py`` for the cross-attentions' key biases); a step
  taken after carrying the JAX train state over
  (``liveedit_train_state_from_jax``) gives the same loss and parameters;
- ``chip_smoke.py``'s LLaVA training phases, rehearsed in bf16 at the real
  head dims (CLIP 64, Vicuna 128): every attention call and every backward
  has the layout the kernels take, as many times per step as the card
  counts, and the comparison with plain attention runs.
"""

import jax
import numpy as np
import pytest
import torch

from helpers import write_records
from test_liveedit import tiny_liveedit_cfg
from test_torch_llava import _tiny
from test_torch_train import _as_torch, _check_step, _np_tree, _rel_l2

import chip_smoke
from devqa_tpu.core import vllm as jvllm
from devqa_tpu.core.tokenizer import ToyTokenizer as JToyTokenizer
from devqa_tpu.core.wrapper import JaxVLLM
from devqa_tpu.data.images import SyntheticImageProvider as JImages
from devqa_tpu.data.schema import EVQA as JEVQA
from devqa_tpu.editors.liveedit import LiveEditConfig as JLiveEditConfig
from devqa_tpu.editors.liveedit import LiveEditTrainable as JTrainable
from devqa_tpu.retrieval.store import hash_encoder as j_hash_encoder
from devqa_tpu_torch.core import vllm as tvllm
from devqa_tpu_torch.core.tokenizer import ToyTokenizer
from devqa_tpu_torch.core.wrapper import TorchVLLM
from devqa_tpu_torch.data.images import SyntheticImageProvider
from devqa_tpu_torch.data.schema import EVQA as TEVQA
from devqa_tpu_torch.editors.liveedit import LiveEditConfig as TLiveEditConfig
from devqa_tpu_torch.editors.liveedit import LiveEditTrainable as TTrainable
from devqa_tpu_torch.editors.liveedit import param_leaves
from devqa_tpu_torch.ops import attention as tattn
from devqa_tpu_torch.retrieval.store import hash_encoder as t_hash_encoder
from devqa_tpu_torch.utils.convert import (liveedit_params_from_jax,
                                           liveedit_train_state_from_jax,
                                           params_from_jax)

EMBED_ATOL = 1e-4
MOMENT_RTOL = 1e-4


def _config(mod, n_kv_heads):
    cfg = _tiny(mod)
    return cfg.replace(decoder=cfg.decoder.replace(n_layers=3,
                                                   n_kv_heads=n_kv_heads))


@pytest.fixture(scope="module", params=[2, 1], ids=["kv2", "kv1"])
def setup(request, tmp_path_factory):
    jcfg, tcfg = (_config(m, request.param) for m in (jvllm, tvllm))
    jparams = jvllm.init_vllm_params(jcfg, jax.random.PRNGKey(0))
    jv = JaxVLLM(jcfg, jparams, JToyTokenizer(vocab_size=512), JImages(32),
                 bucket_multiple=8)
    tv = TorchVLLM(tcfg, params_from_jax(_np_tree(jparams), tcfg,
                                         device="cpu"),
                   ToyTokenizer(512), SyntheticImageProvider(32),
                   bucket_multiple=8, min_len=jv.min_len,
                   img_batch_pad=jv.img_batch_pad)
    tmp = str(tmp_path_factory.mktemp("torch_llava_train"))
    path, _ = write_records(tmp, 6)
    jdata = JEVQA(path, tmp + "/imgs", encoder=j_hash_encoder(16))
    tdata = TEVQA(path, tmp + "/imgs", encoder=t_hash_encoder(16),
                  device="cpu")
    jed, ted = _editors(jv, tv, rerun=False)
    batches = (jed.organize_batch_data(jdata.data[:4]),
               ted.organize_batch_data(tdata.data[:4]))
    return jv, tv, batches


def _editors(jv, tv, rerun):
    jcfg = tiny_liveedit_cfg(jv).replace(
        edit_layer_i=1, train_cfg=JLiveEditConfig.TrainConfig(lr=3e-3),
        faithful_mid_layer_rerun=rerun)
    jed = JTrainable(jv, jcfg, seed=0)
    ted = TTrainable(tv, TLiveEditConfig.from_dict(jcfg.to_dict()),
                     params=liveedit_params_from_jax(_np_tree(jed.params),
                                                     device="cpu"),
                     seed=0)
    return jed, ted


def test_organize_batch_data_matches_jax(setup):
    jv, tv, (jb, tb) = setup
    assert set(tb) == set(jb)
    lo, hi = tv.cfg.vt_range
    assert (lo, hi) == (1, 5) and jv.cfg.vt_range == (lo, hi)
    for k, v in jb.items():
        if k == "embeds":
            t, j = tb[k].numpy(), np.asarray(v)
            assert np.array_equal(np.delete(t, np.s_[lo:hi], axis=1),
                                  np.delete(j, np.s_[lo:hi], axis=1))
            np.testing.assert_allclose(t[:, lo:hi], j[:, lo:hi],
                                       atol=EMBED_ATOL, rtol=0)
        elif isinstance(v, int):
            assert tb[k] == v, k
        else:
            assert np.array_equal(tb[k].numpy(), np.asarray(v)), k
    assert (jb["B"], jb["G"], jb["K"]) == (4, 2, 6)
    # Every training row has an image: its slot after BOS is live.
    assert tb["has_image"].all() and tb["kv_valid"][:, :hi].all()


@pytest.mark.parametrize("rerun", [False, True], ids=["resume", "rerun"])
def test_train_steps_match_jax(setup, rerun):
    jv, tv, (jb, tb) = setup
    jed, ted = _editors(jv, tv, rerun)
    tb = _as_torch(jb, tb)  # one batch for both: the step's math alone

    _check_step(jed, ted, jb, tb)
    mu_j = dict(param_leaves(_np_tree(jed._opt_state[0].mu)))
    mu_t = dict(param_leaves(ted.get_train_state()["opt_state"]["mu"]))
    assert mu_t.keys() == mu_j.keys() and len(mu_t) > 20
    floor = 1e-6 * np.sqrt(sum(np.sum(np.square(m, dtype=np.float64))
                               for m in mu_j.values()))
    noise = {path for path, m in mu_j.items() if np.linalg.norm(m) < floor}
    assert all(path[-2:] == ("k", "b") for path in noise), noise
    for path, m in mu_j.items():
        err = np.linalg.norm(mu_t[path].numpy().astype(np.float64) - m)
        assert err <= max(MOMENT_RTOL * np.linalg.norm(m), floor), path

    _check_step(jed, ted, jb, tb)
    assert ted.get_train_state()["opt_state"]["count"] == \
        int(jed._opt_state[0].count) == 2

    # Carry the JAX train state over, then step both once more.
    adam = jed._opt_state[0]
    ted.set_train_state(liveedit_train_state_from_jax(
        _np_tree(jed.params), _np_tree(adam.mu), _np_tree(adam.nu),
        int(adam.count), device="cpu"))
    _check_step(jed, ted, jb, tb)
    p_j = dict(param_leaves(_np_tree(jed.params)))
    for path, t in param_leaves(ted.params):
        if path not in noise:
            assert _rel_l2(t, p_j[path]) <= MOMENT_RTOL, path


def test_chip_smoke_llava_train_phases_meet_kernel_contract(monkeypatch):
    """``chip_smoke``'s LLaVA training phases (LLAVA_TRAIN: 64-token text
    buckets, LiveEdit from its configuration file) at tiny width in bf16
    on the CPU, at the real head dims (CLIP 64, Vicuna 128): every
    attention call has the layout the forward kernel takes, every call
    that needs a gradient goes through the autograd Function and its
    backward has the layout the backward kernels take, as many times per
    step as the card counts; the losses are finite, a Best checkpoint is
    written, and the comparison with plain attention runs with both sides
    fed one prefix."""
    cfg = _tiny(tvllm)
    cfg = cfg.replace(
        vit=cfg.vit.replace(d_model=128, d_ffn=64, n_layers=3),
        vit_feature_layer=2,
        decoder=cfg.decoder.replace(d_model=256, d_ffn=64, n_layers=3))
    params = tvllm.init_vllm_params(cfg, torch.Generator().manual_seed(0),
                                    torch.bfloat16, "cpu")
    calls, fwd_calls, bwd_calls = set(), [], []

    def checked(q, k, v, kv_valid=None, causal=False):
        tattn.check_kernel_layout(q, k, v, kv_valid)
        calls.add((q.shape[3], q.shape[2], k.shape[2], kv_valid is not None,
                   causal))
        if torch.is_grad_enabled() and q.requires_grad:
            fwd_calls.append(q.shape)
            return tattn.FlashAttention.apply(q, k, v, kv_valid, causal)
        return tattn.flash_attention_ref(q, k, v, kv_valid, causal)

    def checked_bwd(q, k, v, kv_valid, causal, o, lse, do):
        tattn.check_bwd_layout(q, k, v, kv_valid, lse, o, do)
        bwd_calls.append(q.shape)
        return tattn.flash_attention_bwd_ref(q, k, v, kv_valid, causal, o,
                                             lse, do)

    monkeypatch.setattr(tattn, "xla_attention", checked)
    monkeypatch.setattr(tattn, "flash_attention_bwd", checked_bwd)
    steps = 2
    line, editor, batch = chip_smoke.drive_train_path(
        cfg, params, "cpu", steps=steps, path=chip_smoke.LLAVA_TRAIN)
    # (head dim, Lq, Lk, masked, causal): the tower's layers read, then
    # the decoder over [BOS | slot 4 | text 63]
    assert calls == {(64, 5, 5, False, False), (128, 68, 68, True, True)}
    # One layer after the edit layer (1 of 3) in each of the three
    # suffixes, in the warm step and the timed ones.
    assert line["phase"] == "llava_train_path"
    assert line["bwd_launches_per_step_expected"] == 3
    assert len(bwd_calls) == len(fwd_calls) == 3 * (steps + 1)
    assert sorted({s[0] for s in bwd_calls}) == [4, 8, 24]
    assert line["best_checkpoint"] and all(np.isfinite(line["losses"]))
    assert line["row_tokens"] == 68 and line["rows_per_step"] == 36
    assert batch["embeds"].dtype == torch.bfloat16
    n_bwd = len(bwd_calls)
    out = chip_smoke.compare_training_with_plain_attention(
        editor, batch, on_card=False, path=chip_smoke.LLAVA_TRAIN)
    assert out["phase"] == "llava_train_reference" and out["shared_prefix"]
    assert len(bwd_calls) > n_bwd  # the kernel side's backwards, checked
    assert out["loss_rel_diff"] == 0.0 and out["grad_rel_l2_max"] == 0.0
    assert out["suffix_input_grad_rel_l2"] == 0.0
    assert out["suffix_input_grad_norm"] > 0
    assert out["chained"]["loss_rel_diff"] == 0.0
    assert set(out["chained_plain_vs_float32"]) == set(out["chained"])
