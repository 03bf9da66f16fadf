"""Metrics over full-layout predictions (counterpart of ``devqa_tpu/core/losses.py``).

``label_ids[b, j]`` is the token position j predicts and ``label_masks``
marks supervised positions, both in the full batched layout.
"""
from __future__ import annotations

import torch


def predict_ids(logits: torch.Tensor) -> torch.Tensor:
    """Argmax token predictions [B, L]; ties resolve to the first index."""
    return torch.argmax(logits, dim=-1)


def token_accuracy(logits, label_ids, label_masks):
    """Per-row masked argmax accuracy → (acc [B], pred_ids [B, L])."""
    pred = predict_ids(logits)
    m = label_masks.float()
    acc = ((pred == label_ids).float() * m).sum(-1) / m.sum(-1).clamp(min=1.0)
    return acc, pred


def gathered_label_positions(label_masks, n_pos: int):
    """Per-row indices of the first ``n_pos`` supervised positions, in
    sequence order (stable sort), padded with unsupervised positions whose
    validity is 0 → (positions [B, n_pos], valid [B, n_pos])."""
    m = label_masks.to(torch.int64)
    order = torch.sort(1 - m, dim=-1, stable=True).indices[:, :n_pos]
    return order, m.gather(1, order)


def gathered_token_accuracy(hidden, label_ids, label_masks, n_pos: int,
                            pred_fn):
    """``token_accuracy`` with the head evaluated only at supervised
    positions: ``pred_fn`` maps gathered hidden rows [B, n_pos, d] to argmax
    ids. Returns (acc [B], pred [B, n_pos], valid [B, n_pos]) — ``pred`` in
    gathered layout: ``pred[b][valid[b] == 1]`` equals the full-layout
    ``pred[b][label_masks[b] == 1]``."""
    pos, valid = gathered_label_positions(label_masks, n_pos)
    h = hidden.gather(1, pos[..., None].expand(-1, -1, hidden.shape[-1]))
    pred = pred_fn(h)
    lab = label_ids.gather(1, pos)
    m = valid.float()
    acc = ((pred == lab).float() * m).sum(-1) / m.sum(-1).clamp(min=1.0)
    return acc, pred, valid
