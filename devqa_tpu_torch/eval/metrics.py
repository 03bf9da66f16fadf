"""Locality metrics (the part of ``devqa_tpu/eval/metrics.py`` the harness uses)."""
from __future__ import annotations

import numpy as np


def topk_span_agreement(pre_topk, pre_mask, post_topk, post_mask,
                        k: int) -> float:
    """Positional top-k index agreement between pre- and post-edit top-k
    arrays, restricted to each row's supervised span (mask == 1) and
    tail-aligned. An empty span scores 0.0."""
    a = np.asarray(pre_topk)[np.asarray(pre_mask) == 1][:, :k]
    b = np.asarray(post_topk)[np.asarray(post_mask) == 1][:, :k]
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    return float((a[len(a) - n:] == b[len(b) - n:]).mean())
