"""The port's training loop on the CPU: the counterparts of
``tests/test_liveedit_train.py`` for ``devqa_tpu_torch`` (the loss falls,
checkpoints round-trip and resume, the save throttle, "Best" holds the best
moment's state, validation changes nothing, the early stopper), the
prefetcher, and a rehearsal of ``chip_smoke.py``'s training phases at
tiny width in bf16 that checks every attention call needing a gradient
against the layout the CUDA kernels take. Imports no JAX."""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from devqa_tpu_torch.core import decoder as tdec
from devqa_tpu_torch.core import qformer as tqf
from devqa_tpu_torch.core import vit as tvit
from devqa_tpu_torch.core.tokenizer import ToyTokenizer
from devqa_tpu_torch.core.vllm import (VLLMConfig, init_vllm_params,
                                       tiny_vllm_config)
from devqa_tpu_torch.core.wrapper import TorchVLLM
from devqa_tpu_torch.data.images import SyntheticImageProvider
from devqa_tpu_torch.data.prefetch import ParallelDataset
from devqa_tpu_torch.data.schema import EVQA
from devqa_tpu_torch.editors.liveedit import (LiveEditConfig,
                                              LiveEditTrainable,
                                              param_leaves)
from devqa_tpu_torch.ops import attention as tattn
from devqa_tpu_torch.retrieval.store import hash_encoder
from devqa_tpu_torch.train import loop
from devqa_tpu_torch.train.loop import (EarlyStopper, EditorTrainer,
                                        default_val_step, load_editor_ckpt)


def _liveedit_cfg(vcfg, edit_layer_i=2, lr=3e-3):
    return LiveEditConfig(
        edit_model_name=vcfg.name,
        retrieval_editor=LiveEditConfig.RetrievalEditor(
            module_dim=16, cross_att_head_n=2, lora_rank=2, eqe_n=2),
        llm_mid_dim=vcfg.decoder.d_model, edit_layer_i=edit_layer_i,
        max_edits=8, train_cfg=LiveEditConfig.TrainConfig(lr=lr))


class _JsonlOnly(loop.ScalarLogger):
    def __init__(self, logdir):
        super().__init__(logdir, tensorboard=False)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The trainer's logger without TensorBoard (whose import alone takes
    many seconds on a CPU host); the JSONL log is unchanged."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(loop, "ScalarLogger", _JsonlOnly)
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_trainer"))
    cfg = tiny_vllm_config("opt")
    params = init_vllm_params(cfg, torch.Generator().manual_seed(0),
                              torch.float32, "cpu")
    vllm = TorchVLLM(cfg, params, ToyTokenizer(cfg.decoder.vocab_size),
                     SyntheticImageProvider(cfg.vit.image_size),
                     bucket_multiple=8)
    data = EVQA(chip_smoke.build_cases(8, tmp), tmp,
                encoder=hash_encoder(16), device="cpu")
    editor = LiveEditTrainable(vllm, _liveedit_cfg(cfg), seed=0)
    return tmp, vllm, data, editor


def _trainer(setup, name, **kw):
    tmp, _, data, editor = setup
    kw.setdefault("random_seed", 7)
    return EditorTrainer(editor, data, batch_size=4,
                         records_dir=os.path.join(tmp, "records"),
                         train_name=name, data_buffer_size=2, **kw)


def _params(editor):
    return {p: t.detach().clone() for p, t in param_leaves(editor.params)}


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_loss_falls_on_a_repeated_batch(setup):
    _, _, data, editor = setup
    editor.train_init_editor(0)
    batch = editor.organize_batch_data(data.data[:4])
    losses = [editor.train_step(batch)[0] for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_training_batch_holds_no_inference_tensors(setup):
    """``encode_queries`` runs in inference mode; the organized batch is
    cloned out of it, or the step could not save it for its backward."""
    _, vllm, data, editor = setup
    r = data.data[0].requests[0]
    qb = vllm.encode_queries([r["prompt"]], [r["image"]], [r["target_new"]])
    assert qb.embeds.is_inference()
    batch = editor.organize_batch_data(data.data[:4])
    tensors = [v for v in batch.values() if isinstance(v, torch.Tensor)]
    assert len(tensors) == 13
    assert not any(t.is_inference() for t in tensors)


def test_trainer_saves_loads_and_resumes(setup):
    _, vllm, data, editor = setup
    t1 = _trainer(setup, "r1")
    t1.train(total_epochs=1)
    best = os.path.join(t1.ckpt_dir, "Best")
    assert os.path.isfile(os.path.join(best, loop.CKPT_FILE))
    assert os.path.isfile(best + ".resume.json")
    saved = _params(editor)
    other = LiveEditTrainable(vllm, editor.cfg, seed=99)
    assert not _same(_params(other), saved)
    meta = load_editor_ckpt(other, best)
    assert meta["i"] >= 1 and _same(_params(other), saved)
    assert other.get_train_state()["opt_state"]["count"] == \
        editor.get_train_state()["opt_state"]["count"] == 2

    t2 = _trainer(setup, "r2", load_ckpt_path=best)
    resumed_at = t2.train_i
    assert resumed_at >= 2 and t2._resume_best_ema == meta["ema_loss"]
    assert t2._last_save_i == resumed_at
    t2.train(total_epochs=t2.train_epoch + 1)
    assert t2.train_i > resumed_at
    with pytest.raises(NotImplementedError, match="convert_reference"):
        load_editor_ckpt(other, os.path.join(best, loop.CKPT_FILE))


def test_ckpt_save_throttle(setup):
    """EMA-best saves run at most once per ``save_ckpt_per_i`` steps; a
    pending best flushes at the end, so "Best" always exists."""
    trainer = _trainer(setup, "throttle", save_ckpt_per_i=1000)
    saves = []
    orig = trainer.save_ckpt
    trainer.save_ckpt = lambda *a, **k: (saves.append(trainer.train_i),
                                         orig(*a, **k))
    trainer.train(total_epochs=3)  # 6 steps: the EMA improves on most
    assert 1 <= len(saves) <= 2, saves
    assert os.path.isdir(os.path.join(trainer.ckpt_dir, "Best"))


def test_best_holds_the_best_moments_state(setup):
    """A throttled save writes the state snapshotted at the EMA best, not
    the state at flush time: the snapshot must be a clone, since steps
    update the parameters in place."""
    _, vllm, data, editor = setup
    trainer = _trainer(setup, "snap", save_ckpt_per_i=1000)
    trainer.ema_loss = 1.0
    trainer._mark_ema_best()
    best = _params(editor)
    editor.train_step(editor.organize_batch_data(data.data[:4]))
    assert not _same(_params(editor), best)
    trainer.save_ckpt()
    other = LiveEditTrainable(vllm, editor.cfg, seed=99)
    load_editor_ckpt(other, os.path.join(trainer.ckpt_dir, "Best"))
    assert _same(_params(other), best)


def test_validation_changes_nothing(setup):
    """Both the editor's ``val_step`` and ``default_val_step`` leave the
    parameters, Adam's state and the host random streams as they were."""
    _, _, data, editor = setup
    editor.train_init_editor(0)
    batch = editor.organize_batch_data(data.data[:4])
    editor.train_step(batch)

    def snapshot():
        st = editor.get_train_state()["opt_state"]
        return (_params(editor), st["count"],
                {p: t.clone() for p, t in param_leaves(st["mu"])},
                editor._rng_data.bit_generator.state,
                editor._rng_train.bit_generator.state)

    before = snapshot()
    loss_v, _ = editor.val_step(batch)
    loss_d, _ = default_val_step(editor, batch)
    after = snapshot()
    assert _same(before[0], after[0]) and before[1] == after[1]
    assert _same(before[2], after[2]) and before[3:] == after[3:]
    assert np.isfinite(loss_v) and abs(loss_v - loss_d) <= 1e-6 * abs(loss_v)


def test_validation_early_stop(setup, tmp_path):
    _, _, data, editor = setup
    trainer = EditorTrainer(editor, data, batch_size=4,
                            records_dir=str(tmp_path), train_name="val",
                            random_seed=0, data_buffer_size=2, val_data=data,
                            val_interval=2, val_steps=1,
                            early_stop_patience=2)
    trainer.train(total_epochs=50, max_steps=8)
    assert trainer.stopper.should_stop() or trainer.train_i <= 9
    run = os.path.join(str(tmp_path), "liveedit", "tiny-opt", "val")
    assert os.path.isdir(os.path.join(run, "checkpoints", "Best"))
    with open(os.path.join(run, "logs", "scalars.jsonl")) as f:
        assert "val_loss" in f.read()
    with open(os.path.join(run, "config.yaml")) as f:
        assert "faithful_mid_layer_rerun: false" in f.read()


def test_early_stopper_acc_key():
    st = EarlyStopper(patience=3, key="rewrite_acc")
    assert st.update(1, {"rewrite_acc": 0.5})
    assert not st.update(2, {"rewrite_acc": 0.4})
    assert st.update(3, {"rewrite_acc": 0.9})
    assert not st.should_stop()
    st.update(4, {"rewrite_acc": 0.1})
    st.update(6, {"rewrite_acc": 0.1})
    assert st.should_stop()
    with pytest.raises(KeyError):
        st.update(7, {"loss": 1.0})


def test_parallel_dataset_raises_producer_errors_and_stops_early():
    ds = ParallelDataset(10, lambda ids: ids, 3, shuffle=True,
                         buffer_size=1, seed=0)
    epoch = [ids for ids, n in ds]
    assert len(epoch) == 3 and sorted(sum(epoch, []))[:9] != []
    it = iter(ds)
    next(it)
    it.close()  # abandoning the epoch stops its producer

    def boom(ids):
        raise ValueError("organize failed")

    with pytest.raises(ValueError, match="organize failed"):
        list(ParallelDataset(6, boom, 3, seed=0))


def _kernel_width_config():
    """Two layers per tower at the path's head dims: ViT 88, Q-Former 64,
    OPT 80, with three decoder layers."""
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


def test_chip_smoke_train_phases_meet_kernel_contract(monkeypatch):
    """``chip_smoke``'s training phases at tiny width in bf16 on the CPU:
    every attention call that needs a gradient goes through the autograd
    Function with the layout the kernels take, forward and backward, as
    many times per step as the card counts; the losses are finite and the
    plain-attention comparison runs."""
    cfg = _kernel_width_config()
    params = init_vllm_params(cfg, torch.Generator().manual_seed(0),
                              torch.bfloat16, "cpu")
    fwd_calls, bwd_calls = [], []

    def checked(q, k, v, kv_valid=None, causal=False):
        tattn.check_kernel_layout(q, k, v, kv_valid)
        if torch.is_grad_enabled() and q.requires_grad:
            fwd_calls.append((q.shape[3], kv_valid is not None, causal))
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
    line, editor, batch = chip_smoke.drive_train_path(cfg, params, "cpu",
                                                      steps=steps)
    # One layer after the edit layer (1 of 3), differentiated in each of
    # the three suffixes, in the warm step and the timed ones.
    assert line["bwd_launches_per_step_expected"] == 3
    assert len(bwd_calls) == len(fwd_calls) == 3 * (steps + 1)
    assert set(fwd_calls) == {(80, True, True)}
    assert line["best_checkpoint"] and all(np.isfinite(line["losses"]))
    assert batch["embeds"].dtype == torch.bfloat16
    out = chip_smoke.compare_training_with_plain_attention(editor, batch,
                                                           on_card=False)
    assert out["loss_rel_diff"] == 0.0 and out["grad_rel_l2_max"] == 0.0
    assert out["suffix_input_grad_rel_l2"] == 0.0
    assert out["suffix_input_grad_norm"] > 0
    assert not out["leaves_with_zero_gradient"]


@pytest.mark.parametrize("n,ok", [(0, True), (1, False), (7, False)])
def test_eager_attention_calls_fail_the_smoke(n, ok):
    """A driven path or a reference phase's kernel side whose attention
    calls on the card went to xla_attention fails the smoke run."""
    if ok:
        chip_smoke.check_no_eager_calls(n, "llava_train_path")
    else:
        with pytest.raises(AssertionError, match="%d attention calls" % n):
            chip_smoke.check_no_eager_calls(n, "llava_train_path")
