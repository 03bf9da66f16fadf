"""Tokenizer protocol and the deterministic test tokenizer (counterpart of
``devqa_tpu/core/tokenizer.py``)."""
from __future__ import annotations

import zlib
from typing import List, Protocol, Sequence, runtime_checkable


@runtime_checkable
class Tokenizer(Protocol):
    pad_token_id: int

    def encode(self, text: str) -> List[int]:
        """Text → token ids (including BOS if the tokenizer uses one)."""
        ...

    def decode(self, ids: Sequence[int]) -> str:
        ...


class ToyTokenizer:
    """Deterministic whitespace tokenizer.

    Splits on whitespace; a leading space attaches to the word, so
    ``tok(p + ' ' + t) == tok(p) + tok(' ' + t)``. Prepends BOS when
    ``add_bos``. Ids are crc32 hashes into [N_RESERVED, vocab_size).
    """

    PAD, BOS, EOS, UNK, IMG = 0, 1, 2, 3, 4
    N_RESERVED = 8

    def __init__(self, vocab_size: int = 512, add_bos: bool = True):
        if vocab_size <= self.N_RESERVED:
            raise ValueError("vocab_size must exceed %d" % self.N_RESERVED)
        self.vocab_size = vocab_size
        self.add_bos = add_bos
        self.pad_token_id = self.PAD
        self.bos_token_id = self.BOS
        self.eos_token_id = self.EOS
        self._id_to_word = {}

    def _word_id(self, word: str) -> int:
        wid = self.N_RESERVED + (
            zlib.crc32(word.encode("utf-8"))
            % (self.vocab_size - self.N_RESERVED))
        self._id_to_word.setdefault(wid, word)
        return wid

    def encode(self, text: str) -> List[int]:
        ids = [self.BOS] if self.add_bos else []
        ids.extend(self._word_id(w) for w in text.split())
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i in (self.PAD, self.BOS, self.EOS):
                continue
            words.append(self._id_to_word.get(i, "<unk>"))
        return " ".join(words)
