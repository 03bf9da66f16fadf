"""Embedding store + similarity search for probe synthesis (counterpart of
``devqa_tpu/retrieval/store.py``).

Search is one float32 matmul and a top-k. ``jax.lax.top_k`` resolves ties
to the lower index and ``torch.topk`` promises no order among ties, so the
top-k here is a stable sort on ``(-score, index)``: the t×i probe sets then
come out as the JAX package's.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

EncoderFn = Callable[[Sequence[str]], np.ndarray]  # texts → [N, d]


def _normalize(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def topk_search(store_emb: torch.Tensor, query_emb: torch.Tensor, k: int = 5):
    """Dot-product top-k, ties to the lower index. store [N, d], query
    [Q, d] → (scores [Q, k], indices [Q, k])."""
    sims = torch.matmul(query_emb.float(), store_emb.float().t())
    idx = torch.sort(-sims, dim=1, stable=True).indices[:, :k]
    return sims.gather(1, idx), idx


@dataclasses.dataclass
class EmbeddingStore:
    """Sentences with their normalized embeddings, images and (prompt,
    answer) pairs."""

    sentences: List[str]
    embeddings: np.ndarray              # [N, d], normalized
    images: List[Optional[str]]
    prompts: List[Tuple[str, str]]      # (prompt, answer) pairs

    @classmethod
    def build(cls, sentences, encoder: EncoderFn, images,
              prompts) -> "EmbeddingStore":
        emb = _normalize(np.asarray(encoder(sentences), np.float32))
        return cls(list(sentences), emb, list(images),
                   [tuple(p) for p in prompts])

    def __len__(self) -> int:
        return len(self.sentences)


class Retriever:
    """``finds_sim`` semantics: of the top-k neighbours of (src, trg), the
    first whose stored answer differs from ``trg``, else the last hit."""

    def __init__(self, store: EmbeddingStore, encoder: EncoderFn,
                 top_k: int = 5, device="cuda"):
        self.store = store
        self.encoder = encoder
        self.top_k = top_k
        self.device = torch.device(device)
        self._store_emb = torch.from_numpy(store.embeddings).to(self.device)

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return _normalize(np.asarray(self.encoder(texts), np.float32))

    def find_similar_batch(self, srcs: Sequence[str], trgs: Sequence[str]):
        """→ [((prompt, answer), image_path)] per query."""
        q = torch.from_numpy(self.encode_queries(srcs)).to(self.device)
        _, idx = topk_search(self._store_emb, q,
                             min(self.top_k, len(self.store)))
        out = []
        for row, trg in zip(idx.cpu().numpy(), trgs):
            pick = int(row[-1])
            for i in row:
                if self.store.prompts[int(i)][1] != trg:
                    pick = int(i)
                    break
            out.append((self.store.prompts[pick], self.store.images[pick]))
        return out


def hash_encoder(dim: int = 32) -> EncoderFn:
    """Deterministic toy sentence encoder: bag-of-word-hash projections."""

    def enc(texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), dim), np.float32)
        for i, t in enumerate(texts):
            for w in t.split():
                h = zlib.crc32(w.encode())
                rng = np.random.default_rng(h % (2 ** 31))
                out[i] += rng.normal(size=dim).astype(np.float32)
        return out

    return enc
