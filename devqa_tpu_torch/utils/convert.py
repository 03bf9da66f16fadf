"""Carry the JAX package's parameters into the port.

The JAX package keeps parameters as pytrees of arrays; given the same tree
as numpy arrays (``jax.tree.map(np.asarray, params)``), these functions
build the port's dicts of tensors, so both packages compute with the same
weights. Weights keep the ``[in, out]`` layout; the JAX package's
scan-stacked ``layers`` leaves (ViT, decoder) become lists of per-layer
dicts, whatever they hold (fused or split q/k/v; OPT's fc1/fc2 or LLaMA's
gate/up/down). The Q-Former's layers are already a list; the other trees
(the projection, be it BLIP-2's linear or LLaVA's MLP, ``lm_head``) keep
their keys.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..core.decoder import _check_arch
from ..core.vllm import VLLMConfig, _check_bridge


def _tensors(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, dtype, device) for v in tree]
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _unstack(tree, n: int) -> List[Dict[str, Any]]:
    """{leaf: [n, ...]} → [{leaf: [...]}] * n."""
    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return [take(tree, i) for i in range(n)]


def params_from_jax(np_tree, cfg: VLLMConfig, dtype=None, device="cuda"):
    """The JAX ``init_vllm_params`` tree (numpy leaves) → the port's VLLM
    params on ``device`` (floating leaves cast to ``dtype`` if given)."""
    _check_bridge(cfg)
    _check_arch(cfg.decoder)
    out = {}
    for name, sub in np_tree.items():
        sub = dict(sub) if isinstance(sub, dict) else sub
        if name == "vit":
            sub["layers"] = _unstack(sub["layers"], cfg.vit.n_layers)
        elif name == "decoder":
            sub["layers"] = _unstack(sub["layers"], cfg.decoder.n_layers)
        out[name] = _tensors(sub, dtype, device)
    return out


def liveedit_params_from_jax(np_tree, device="cuda"):
    """The JAX ``init_liveedit_params`` tree (numpy leaves) → the port's
    LiveEdit params (float32, same keys) on ``device``."""
    return _tensors(np_tree, torch.float32, device)


def liveedit_train_state_from_jax(np_params, np_mu, np_nu, count: int,
                                  device="cuda"):
    """A JAX LiveEdit train state → the port's (``LiveEditTrainable.
    set_train_state``). ``np_params`` is the parameter tree and ``np_mu`` /
    ``np_nu`` / ``count`` are the ``mu`` / ``nu`` / ``count`` of optax's
    ``ScaleByAdamState`` (the first element of the optimizer state), all
    as numpy leaves. The schedule's own count equals Adam's, so one count
    carries both."""
    return {"params": liveedit_params_from_jax(np_params, device),
            "opt_state": {"count": int(count),
                          "mu": liveedit_params_from_jax(np_mu, device),
                          "nu": liveedit_params_from_jax(np_nu, device)}}
