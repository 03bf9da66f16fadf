"""Supervised-span ("xym") construction (counterpart of ``devqa_tpu/data/xym.py``, NumPy path).

The label semantics that define every accuracy metric:

1. a space joins prompt and target unless either side already has
   whitespace at the junction;
2. position j is labeled with token j+1 (teacher forcing);
3. the supervised span runs from the position predicting the first target
   token, ``len(tok(prompt)) - 1``, to the second-to-last position.

:func:`batch_samples` packs samples into fixed-length, right-padded
[B, L] arrays with labels at absolute text positions.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..core.tokenizer import Tokenizer


def join_prompt_target(prompt: str, target: str) -> str:
    if not target:
        return prompt
    if prompt[-1] not in (" ", "\n") and target[0] not in (" ", "\n"):
        return prompt + " " + target
    return prompt + target


@dataclasses.dataclass
class SampleTokens:
    """Tokenized (prompt, target) pair."""

    input_ids: np.ndarray  # [L] int32 — tok(prompt + joined target)
    prompt_len: int        # len(tok(prompt)), BOS included
    image_id: Optional[str] = None

    @property
    def total_len(self) -> int:
        return int(self.input_ids.shape[0])


def tokenize_sample(tokenizer: Tokenizer, prompt: str, target: str,
                    image_id: Optional[str] = None) -> SampleTokens:
    joined = join_prompt_target(prompt, target)
    input_ids = np.asarray(tokenizer.encode(joined), dtype=np.int32)
    prompt_len = len(tokenizer.encode(prompt))
    return SampleTokens(input_ids=input_ids, prompt_len=prompt_len,
                        image_id=image_id)


def label_width(tokenizer: Tokenizer, prompt: str, target: str) -> int:
    """Supervised-position count of a (prompt, target) probe."""
    joined = join_prompt_target(prompt, target)
    return len(tokenizer.encode(joined)) - len(tokenizer.encode(prompt))


@dataclasses.dataclass
class TokenBatch:
    """Fixed-length batched layout, all [B, L] int32 at text positions."""

    input_ids: np.ndarray    # right-padded with pad_id
    attn_mask: np.ndarray    # 1 for real tokens
    label_ids: np.ndarray    # token each position must predict
    label_masks: np.ndarray  # supervised span
    image_ids: List[Optional[str]]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def batch_samples(samples: Sequence[SampleTokens], pad_id: int,
                  bucket_multiple: int = 16, min_len: int = 16) -> TokenBatch:
    """Pack samples into a TokenBatch padded to a length bucket."""
    lmax = max(s.total_len for s in samples)
    L = max(min_len, _round_up(lmax, bucket_multiple))
    N = len(samples)
    input_ids = np.full((N, L), pad_id, np.int32)
    attn = np.zeros((N, L), np.int32)
    labels = np.full((N, L), pad_id, np.int32)
    masks = np.zeros((N, L), np.int32)
    for b, s in enumerate(samples):
        n = s.total_len
        input_ids[b, :n] = s.input_ids
        attn[b, :n] = 1
        labels[b, :n] = np.roll(s.input_ids, -1)
        masks[b, max(s.prompt_len - 1, 0):max(n - 1, 0)] = 1
    return TokenBatch(input_ids, attn, labels, masks,
                      [s.image_id for s in samples])
