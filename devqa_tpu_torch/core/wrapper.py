"""TorchVLLM — the stateful host-side wrapper around a VLLM parameter dict
(counterpart of ``devqa_tpu/core/wrapper.py``'s ``JaxVLLM``).

It owns params + tokenizer + image provider and gives editors and the
evaluation harness:

- :meth:`encode_queries` — (prompts, image paths, targets) → a
  :class:`QueryBatch` in the slotted layout;
- :meth:`encode_queries_packed` / :meth:`packed_logits_metrics` — the same
  queries in pre-assembly form, and assemble + forward + metrics in one
  call, with the LM head at supervised positions only when they fit;
- an LRU vision cache: one slot buffer [cap+1, V, d] (last row zeros, the
  no-image row) with a path → slot map, so each unique image is encoded
  through ViT + Q-Former once per appearance window;
- ``counters``: images encoded (padding rows included), unique images
  encoded, and padded decoder tokens pushed through the wrapper.

Unlike the JAX wrapper, a :class:`PackedQuery` carries its own copy of its
rows' vision tokens, gathered when it is built: a later encode that reuses
an evicted slot cannot change a query already built.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.images import ImageProvider
from ..data.xym import SampleTokens, batch_samples, tokenize_sample
from . import decoder as dec
from .losses import gathered_token_accuracy, token_accuracy
from .preprocess import preprocess_images
from .tokenizer import Tokenizer
from .vllm import (VLLMConfig, assemble_embeds, encode_image, vllm_hidden,
                   vllm_logits)


@dataclasses.dataclass
class QueryBatch:
    """(prompt, image, target) queries in the full slotted layout."""

    embeds: torch.Tensor       # [B, Lf, d]
    kv_valid: torch.Tensor     # [B, Lf] int32
    label_ids: torch.Tensor    # [B, Lf] full-layout labels
    label_masks: torch.Tensor  # [B, Lf] supervised-span mask
    prompt_lens: np.ndarray    # [B] text prompt token counts (incl. BOS)
    has_image: np.ndarray      # [B]
    input_ids: np.ndarray      # [B, Lt] text tokens (host copy)


@dataclasses.dataclass
class PackedQuery:
    """A query batch in pre-assembly form."""

    ints: torch.Tensor        # [4, B, Lt] int32: ids, attn, label_ids, label_masks
    rowmeta: torch.Tensor     # [2, B] int32: has_image, query_end
    img_rows: torch.Tensor    # [B, V, d] vision tokens (zeros for no image)
    prompt_lens: np.ndarray   # [B]
    has_image: np.ndarray     # [B]
    label_masks_full: np.ndarray  # [B, Lt+V] host copy


def assemble_packed(params, cfg: VLLMConfig, ints, rowmeta, img_rows):
    """PackedQuery → (embeds, kv_valid, label_ids, label_masks), full
    layout: text label j lands at full position j+V for j ≥ img_slot_pos
    (earlier positions are never supervised)."""
    ids, attn = ints[0], ints[1]
    embeds, kv = assemble_embeds(params, cfg, ids, attn, img_rows, rowmeta[0])
    V, p = cfg.n_img_tokens, cfg.img_slot_pos
    zeros = torch.zeros((ids.shape[0], p + V), dtype=ints.dtype,
                        device=ints.device)
    labels = torch.cat([zeros, ints[2][:, p:]], dim=1)
    masks = torch.cat([zeros, ints[3][:, p:]], dim=1)
    return embeds, kv, labels, masks


class TorchVLLM:
    def __init__(self, cfg: VLLMConfig, params, tokenizer: Tokenizer,
                 image_provider: ImageProvider, img_cache_size: int = 256,
                 bucket_multiple: int = 32, min_len: int = 16,
                 img_batch_pad: int = 4):
        """``params`` live on their device (see ``init_vllm_params`` /
        ``utils.convert.params_from_jax``); every tensor this wrapper makes
        goes there. Vision encodes run in batches of exactly
        ``img_batch_pad`` rows (the last padded by repetition)."""
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.image_provider = image_provider
        self.bucket_multiple = bucket_multiple
        self.min_len = min_len
        self.img_batch_pad = max(1, img_batch_pad)
        emb = params["decoder"]["embed_tokens"]
        self.device, self.dtype = emb.device, emb.dtype
        self._img_cache: "OrderedDict[str, int]" = OrderedDict()  # path→slot
        self._img_buf: Optional[torch.Tensor] = None
        self._img_free: list = []
        self._img_cache_size = img_cache_size
        self.counters = {"images_encoded": 0, "images_unique": 0,
                         "decoder_tokens": 0}
        # Width of the gathered LM head (supervised positions per row); the
        # fused harness raises it to its run's widest span.
        self._gather_positions = 32

    # ---------------- vision ----------------

    @torch.inference_mode()
    def ensure_image_cache_capacity(self, n_images: int,
                                    max_bytes: int = 2 << 30) -> int:
        """Grow the vision LRU to hold ``n_images`` rows, bounded by
        ``max_bytes`` of device memory. Returns the resulting capacity."""
        row = (self.cfg.n_img_tokens * self.cfg.decoder.d_model
               * self.params["decoder"]["embed_tokens"].element_size())
        if row > 0:
            self._img_cache_size = max(self._img_cache_size,
                                       min(int(n_images), max_bytes // row))
            self._grow_buf(self._img_cache_size)
        return self._img_cache_size

    def _buf_capacity(self) -> int:
        return 0 if self._img_buf is None else self._img_buf.shape[0] - 1

    def _grow_buf(self, n_needed: int) -> None:
        """Ensure the buffer holds ≥ n_needed rows plus the zero row, which
        stays last (callers read its index fresh via ``_zero_slot``)."""
        cap = self._buf_capacity()
        if cap >= n_needed:
            return
        V, d = self.cfg.n_img_tokens, self.cfg.decoder.d_model
        new_cap = max(n_needed, 2 * cap, 32)
        buf = torch.zeros((new_cap + 1, V, d), dtype=self.dtype,
                          device=self.device)
        if self._img_buf is not None:
            buf[:cap] = self._img_buf[:cap]
        self._img_buf = buf
        self._img_free.extend(range(cap, new_cap))

    def _zero_slot(self) -> int:
        return self._buf_capacity()

    def _alloc_slot(self) -> int:
        if not self._img_free:
            self._grow_buf(self._buf_capacity() + 1)
        return self._img_free.pop()

    def _evict_oldest(self) -> None:
        _, slot = self._img_cache.popitem(last=False)
        self._img_free.append(slot)

    def _encode_uncached(self, todo: List[str]) -> None:
        """Encode ``todo`` (unique, uncached paths) into the slot buffer in
        batches of exactly ``img_batch_pad`` rows; the padding rows are
        computed and dropped, never written."""
        bp = self.img_batch_pad
        self.counters["images_encoded"] += bp * ((len(todo) + bp - 1) // bp)
        self.counters["images_unique"] += len(todo)
        self._grow_buf(len(self._img_cache) + len(todo))
        for lo in range(0, len(todo), bp):
            chunk = todo[lo:lo + bp]
            imgs = [self.image_provider(p) for p in chunk]
            imgs.extend([imgs[0]] * (bp - len(chunk)))
            u8 = torch.from_numpy(np.stack(imgs)).to(self.device)
            toks = encode_image(self.params, self.cfg,
                                preprocess_images(u8, self.cfg.vit.image_size))
            slots = [self._alloc_slot() for _ in chunk]
            self._img_buf[torch.tensor(slots, device=self.device)] = \
                toks[:len(chunk)].to(self.dtype)
            for p, s in zip(chunk, slots):
                self._img_cache[p] = s
                self._img_cache.move_to_end(p)

    @torch.inference_mode()
    def warm_image_cache(self, paths: Sequence[Optional[str]]) -> int:
        """Pre-encode every unique uncached path in full fixed-size batches.
        No-op (returns 0) when the unique set exceeds the LRU capacity.
        Returns the number encoded."""
        uniq = [p for p in dict.fromkeys(paths) if p is not None]
        if not uniq or len(uniq) > self._img_cache_size:
            return 0
        for p in uniq:
            if p in self._img_cache:
                self._img_cache.move_to_end(p)
        todo = [p for p in uniq if p not in self._img_cache]
        if todo:
            self._encode_uncached(todo)
            while len(self._img_cache) > self._img_cache_size:
                self._evict_oldest()
        return len(todo)

    def _image_slots(self, paths: Sequence[Optional[str]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Paths (None = no image) → (slot indices [B], has_image [B]),
        encoding uncached paths first."""
        has = np.array([1 if p is not None else 0 for p in paths], np.int32)
        uniq = [p for p in dict.fromkeys(paths) if p is not None]
        # Refresh recency first: the eviction below must never pop a path
        # this call is about to read.
        for p in uniq:
            if p in self._img_cache:
                self._img_cache.move_to_end(p)
        todo = [p for p in uniq if p not in self._img_cache]
        if todo:
            self._encode_uncached(todo)
            keep = max(self._img_cache_size, len(uniq))
            while len(self._img_cache) > keep:
                self._evict_oldest()
        if self._img_buf is None:
            self._grow_buf(1)  # all-None batch before any encode
        z = self._zero_slot()
        idx = np.array([self._img_cache[p] if p is not None else z
                        for p in paths], np.int64)
        return idx, has

    @torch.inference_mode()
    def encode_images(self, paths: Sequence[Optional[str]]
                      ) -> Tuple[torch.Tensor, np.ndarray]:
        """Paths (None = no image) → (vision tokens [B, V, d], has_image [B])."""
        idx, has = self._image_slots(paths)
        return self._img_buf[torch.from_numpy(idx).to(self.device)], has

    def clear_image_cache(self) -> None:
        self._img_free.extend(self._img_cache.values())
        self._img_cache.clear()

    # ---------------- queries ----------------

    def _prompt_text(self, prompt: str, has_image: bool) -> str:
        """The auto-add-image-token rule: a model with an image special
        token gets ``"<tok>\\n"`` before the prompt when an image is present.
        The token itself is stripped (the slot layout stands for it) and
        the ``"\\n"`` kept."""
        ist = self.cfg.img_special_token
        if ist is None:
            return prompt
        prompt = prompt.replace(ist + "\n", "").replace(ist, "")
        return "\n" + prompt if has_image else prompt

    def tokenize_queries(self, prompts: Sequence[str],
                         image_paths: Sequence[Optional[str]],
                         targets: Sequence[str]) -> List[SampleTokens]:
        return [tokenize_sample(self.tokenizer,
                                self._prompt_text(p, img is not None), t,
                                image_id=img)
                for p, img, t in zip(prompts, image_paths, targets)]

    def _batch(self, prompts, image_paths, targets):
        samples = self.tokenize_queries(prompts, image_paths, targets)
        tb = batch_samples(samples, self.tokenizer.pad_token_id,
                           bucket_multiple=self.bucket_multiple,
                           min_len=self.min_len)
        prompt_lens = np.array([s.prompt_len for s in samples], np.int32)
        return tb, prompt_lens

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def encode_queries(self, prompts: Sequence[str],
                       image_paths: Sequence[Optional[str]],
                       targets: Sequence[str]) -> QueryBatch:
        """Full-layout embeds + labels for B queries in one batch."""
        tb, prompt_lens = self._batch(prompts, image_paths, targets)
        img_tokens, has = self.encode_images(image_paths)
        embeds, kv = assemble_embeds(
            self.params, self.cfg, self._to_device(tb.input_ids),
            self._to_device(tb.attn_mask), img_tokens, self._to_device(has))
        V, p = self.cfg.n_img_tokens, self.cfg.img_slot_pos
        B, Lt = tb.input_ids.shape
        full_labels = np.zeros((B, Lt + V), np.int32)
        full_masks = np.zeros((B, Lt + V), np.int32)
        # Supervised spans start at text position prompt_len-1 ≥ p, so the
        # whole supervised region maps text j → full j+V.
        full_labels[:, p + V:] = tb.label_ids[:, p:]
        full_masks[:, p + V:] = tb.label_masks[:, p:]
        return QueryBatch(embeds=embeds, kv_valid=kv,
                          label_ids=self._to_device(full_labels),
                          label_masks=self._to_device(full_masks),
                          prompt_lens=prompt_lens, has_image=has,
                          input_ids=tb.input_ids)

    @torch.inference_mode()
    def encode_queries_packed(self, prompts: Sequence[str],
                              image_paths: Sequence[Optional[str]],
                              targets: Sequence[str]) -> PackedQuery:
        """``encode_queries`` in pre-assembly form (see PackedQuery)."""
        tb, prompt_lens = self._batch(prompts, image_paths, targets)
        idx, has = self._image_slots(image_paths)
        V, p = self.cfg.n_img_tokens, self.cfg.img_slot_pos
        B, Lt = tb.input_ids.shape
        ints = np.stack([tb.input_ids, tb.attn_mask,
                         tb.label_ids, tb.label_masks]).astype(np.int32)
        rowmeta = np.stack([has, prompt_lens + V]).astype(np.int32)
        full_masks = np.zeros((B, Lt + V), np.int32)
        full_masks[:, p + V:] = tb.label_masks[:, p:]
        return PackedQuery(
            ints=self._to_device(ints), rowmeta=self._to_device(rowmeta),
            img_rows=self._img_buf[self._to_device(idx)],
            prompt_lens=prompt_lens, has_image=has,
            label_masks_full=full_masks)

    def _gather_head_ok(self, pq: PackedQuery) -> bool:
        """Gathered head: enabled, narrower than the full layout, and no row
        has more supervised positions than the gather width."""
        P = self._gather_positions
        Lf = pq.label_masks_full.shape[1]
        return (0 < P < Lf
                and int(pq.label_masks_full.sum(axis=1).max(initial=0)) <= P)

    @torch.inference_mode()
    def packed_logits_metrics(self, pq: PackedQuery):
        """Assemble + forward + metrics → (acc [B], pred, valid).

        When every row's supervised span fits the gather width the LM head
        runs only at supervised positions and ``pred`` comes back in
        gathered layout with its validity mask; otherwise ``pred`` is
        full-layout and ``valid`` is None. Consumers read
        ``pred[valid_or_masks == 1]`` either way."""
        B, Lt = pq.ints.shape[1], pq.ints.shape[2]
        self.counters["decoder_tokens"] += int(B * (Lt + self.cfg.n_img_tokens))
        embeds, kv, labels, masks = assemble_packed(
            self.params, self.cfg, pq.ints, pq.rowmeta, pq.img_rows)
        if self._gather_head_ok(pq):
            h = vllm_hidden(self.params, self.cfg, embeds, kv)
            return gathered_token_accuracy(
                h, labels, masks, self._gather_positions,
                pred_fn=lambda hg: dec.decoder_pred_ids(
                    self.params["decoder"], self.cfg.decoder, hg))
        a, p = token_accuracy(vllm_logits(self.params, self.cfg, embeds, kv),
                              labels, masks)
        return a, p, None

    def query_end_positions(self, qb: QueryBatch) -> np.ndarray:
        """Full-layout first-target-token position per row: V + prompt_len."""
        return qb.prompt_lens + self.cfg.n_img_tokens

    # ---------------- forwards ----------------

    @torch.inference_mode()
    def logits(self, embeds, kv_valid) -> torch.Tensor:
        self.counters["decoder_tokens"] += int(embeds.shape[0] * embeds.shape[1])
        return vllm_logits(self.params, self.cfg, embeds, kv_valid)

    @torch.inference_mode()
    def logits_metrics(self, embeds, kv_valid, label_ids, label_masks):
        """Forward + masked-argmax metrics → (acc [B], pred [B, L])."""
        return token_accuracy(self.logits(embeds, kv_valid), label_ids,
                              label_masks)
