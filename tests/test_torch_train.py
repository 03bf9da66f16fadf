"""LiveEdit meta-training in both packages, on the same weights (the JAX
inits, carried over by ``utils.convert``) and the same cases, in float32
on the tiny OPT config, with ``faithful_mid_layer_rerun`` off and on:

- ``organize_batch_data`` draws the same rows, masks and picks (exactly;
  the vision-derived embeddings within 1e-4, the models' tolerance);
- one ``train_step`` on the same batch gives the same loss (relative
  1e-5: float32 summation order differs between frameworks) and logs
  (within 1e-5 of max(|value|, 1): the locality KL is a difference of
  nearly equal float32 log-probabilities, near 0 at the first step);
- Adam's first moments after it, (1 - β1)·grad, agree per leaf (relative
  L2 1e-4), which compares the gradients; a leaf whose moment is under
  1e-6 of the whole is float32 noise on both sides and is held to that
  floor (the cross-attentions' key biases get a zero gradient: softmax
  ignores a shift shared by all keys);
- a second step's loss agrees (relative 1e-5), and a step taken after
  carrying the JAX train state over (``liveedit_train_state_from_jax``)
  gives the same loss and parameters (relative L2 1e-4; the key biases,
  whose zero gradients Adam's normalization turns into steps of random
  sign, are left out).
"""
import jax
import numpy as np
import pytest
import torch

from helpers import make_tiny_vllm, write_records
from test_liveedit import tiny_liveedit_cfg

from devqa_tpu.data.schema import EVQA as JEVQA
from devqa_tpu.editors.liveedit import LiveEditConfig as JLiveEditConfig
from devqa_tpu.editors.liveedit import LiveEditTrainable as JTrainable
from devqa_tpu.retrieval.store import hash_encoder as j_hash_encoder
from devqa_tpu_torch.core.tokenizer import ToyTokenizer
from devqa_tpu_torch.core.vllm import tiny_vllm_config
from devqa_tpu_torch.core.wrapper import TorchVLLM
from devqa_tpu_torch.data.images import SyntheticImageProvider
from devqa_tpu_torch.data.schema import EVQA as TEVQA
from devqa_tpu_torch.editors.liveedit import LiveEditConfig as TLiveEditConfig
from devqa_tpu_torch.editors.liveedit import LiveEditTrainable as TTrainable
from devqa_tpu_torch.editors.liveedit import param_leaves
from devqa_tpu_torch.retrieval.store import hash_encoder as t_hash_encoder
from devqa_tpu_torch.utils.convert import (liveedit_params_from_jax,
                                           liveedit_train_state_from_jax,
                                           params_from_jax)

LOSS_RTOL = 1e-5
MOMENT_RTOL = 1e-4
EMBED_ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_train"))
    jvllm = make_tiny_vllm()
    cfg = tiny_vllm_config("opt")
    tvllm = TorchVLLM(cfg, params_from_jax(_np_tree(jvllm.params), cfg,
                                           device="cpu"),
                      ToyTokenizer(cfg.decoder.vocab_size),
                      SyntheticImageProvider(cfg.vit.image_size),
                      bucket_multiple=jvllm.bucket_multiple,
                      min_len=jvllm.min_len, img_batch_pad=jvllm.img_batch_pad)
    path, _ = write_records(tmp, 6)
    jdata = JEVQA(path, tmp + "/imgs", encoder=j_hash_encoder(16))
    tdata = TEVQA(path, tmp + "/imgs", encoder=t_hash_encoder(16),
                  device="cpu")
    return jvllm, tvllm, jdata, tdata


def _editors(setup, rerun):
    jvllm, tvllm, _, _ = setup
    jcfg = tiny_liveedit_cfg(jvllm).replace(
        train_cfg=JLiveEditConfig.TrainConfig(lr=3e-3),
        faithful_mid_layer_rerun=rerun)
    jed = JTrainable(jvllm, jcfg, seed=0)
    ted = TTrainable(tvllm, TLiveEditConfig.from_dict(jcfg.to_dict()),
                     params=liveedit_params_from_jax(_np_tree(jed.params),
                                                     device="cpu"),
                     seed=0)
    return jed, ted


def _as_torch(jbatch, like):
    """The JAX batch as the port's tensors (each in the port's dtype)."""
    return {k: (v if isinstance(v, int) else
                torch.from_numpy(np.array(v)).to(like[k].dtype))
            for k, v in jbatch.items()}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _rel_l2(t, j):
    j = np.asarray(j, np.float64)
    return (np.linalg.norm(t.detach().numpy().astype(np.float64) - j)
            / max(np.linalg.norm(j), 1e-30))


def _check_step(jed, ted, jb, tb):
    lj, logs_j = jed.train_step(jb)
    lt, logs_t = ted.train_step(tb)
    assert _rel(lt, lj) <= LOSS_RTOL, (lt, lj)
    assert logs_t.keys() == logs_j.keys()
    for k in logs_j:
        assert abs(logs_t[k] - logs_j[k]) <= LOSS_RTOL * max(
            abs(logs_j[k]), 1.0), (k, logs_t[k], logs_j[k])
    return lj, lt


@pytest.fixture(scope="module")
def batches(setup):
    """One batch organized by each package, from editors seeded alike."""
    _, _, jdata, tdata = setup
    jed, ted = _editors(setup, rerun=False)
    return (jed.organize_batch_data(jdata.data[:4]),
            ted.organize_batch_data(tdata.data[:4]))


def test_organize_batch_data_matches_jax(batches):
    jb, tb = batches
    assert set(tb) == set(jb)
    for k, v in jb.items():
        if k == "embeds":
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(v),
                                       atol=EMBED_ATOL, rtol=0)
        elif isinstance(v, int):
            assert tb[k] == v, k
        else:
            assert np.array_equal(tb[k].numpy(), np.asarray(v)), k
    assert (jb["B"], jb["G"], jb["K"]) == (4, 2, 6)


@pytest.mark.parametrize("rerun", [False, True], ids=["resume", "rerun"])
def test_train_steps_match_jax(setup, batches, rerun):
    jed, ted = _editors(setup, rerun)
    jb, tb = batches
    tb = _as_torch(jb, tb)  # one batch for both: the step's math alone

    _check_step(jed, ted, jb, tb)
    mu_j = dict(param_leaves(_np_tree(jed._opt_state[0].mu)))
    mu_t = dict(param_leaves(ted.get_train_state()["opt_state"]["mu"]))
    assert mu_t.keys() == mu_j.keys() and len(mu_t) > 20
    floor = 1e-6 * np.sqrt(sum(np.sum(np.square(m, dtype=np.float64))
                               for m in mu_j.values()))
    noise = {path for path, m in mu_j.items() if np.linalg.norm(m) < floor}
    assert noise and all(path[-2:] == ("k", "b") for path in noise), noise
    for path, m in mu_j.items():
        err = np.linalg.norm(mu_t[path].numpy().astype(np.float64) - m)
        assert err <= max(MOMENT_RTOL * np.linalg.norm(m), floor), path
    assert ted.get_train_state()["opt_state"]["count"] == \
        int(jed._opt_state[0].count) == 1

    _check_step(jed, ted, jb, tb)

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
