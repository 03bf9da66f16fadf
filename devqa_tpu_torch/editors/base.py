"""Editor abstraction (counterpart of ``devqa_tpu/editors/base.py``).

The harness drives an editor through explicit hooks instead of
monkey-patched forwards and hooks:

- :meth:`build_query_batch` — prompt-space editors transform queries;
- :meth:`query_logits` / :meth:`query_metrics` — logits and metrics under
  the current edit state;
- :meth:`query_metrics_packed` — the same from a :class:`PackedQuery`.

Edit state is reset with ``restore_to_original_model`` without reloading
the backbone.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple

import torch

from ..core.losses import token_accuracy
from ..core.wrapper import QueryBatch, TorchVLLM

# request = {'image': path|None, 'prompt': str, 'target_new': str}
EditRequest = Dict


class VLLMEditor(ABC):
    def __init__(self, vllm: TorchVLLM):
        self.vllm = vllm

    @abstractmethod
    def name_of_editor_and_model(self) -> Tuple[str, str]:
        ...

    @abstractmethod
    def restore_to_original_model(self) -> None:
        ...

    @abstractmethod
    def edit_one_piece(self, request: EditRequest) -> None:
        ...

    def edit_batch(self, requests: List[EditRequest],
                   pad_width: Optional[int] = None) -> None:
        """Apply a batch of edits. ``pad_width`` is the harness's
        shape-stability hint; eager PyTorch has no per-shape compile, so
        the editors here do not pad."""
        if not self.if_can_batch_edit():
            raise NotImplementedError(
                "%s does not support batch editing" % type(self).__name__)
        for r in requests:
            self.edit_one_piece(r)

    def if_can_batch_edit(self) -> bool:
        return False

    # ---------------- harness integration ----------------

    def build_query_batch(self, prompts, image_paths, targets) -> QueryBatch:
        return self.vllm.encode_queries(prompts, image_paths, targets)

    def query_logits(self, qb: QueryBatch) -> torch.Tensor:
        """Logits under the current edit state (default: the backbone)."""
        return self.vllm.logits(qb.embeds, qb.kv_valid)

    def query_metrics(self, qb: QueryBatch):
        """(acc [B], pred_ids [B, L]) under the current edit state."""
        return token_accuracy(self.query_logits(qb), qb.label_ids,
                              qb.label_masks)

    def query_metrics_packed(self, pq):
        """(acc, pred, valid_or_None) from a PackedQuery, or None when this
        editor's queries cannot ride the packed path (it overrides
        ``build_query_batch`` or ``query_logits`` without a packed program
        of its own)."""
        if (type(self).build_query_batch is VLLMEditor.build_query_batch
                and type(self).query_logits is VLLMEditor.query_logits):
            return self.vllm.packed_logits_metrics(pq)
        return None
