"""LiveEdit — lifelong VLLM editing with per-edit LoRA experts and two-stage
(hard visual / soft query) routing, and its meta-training (counterpart of
``devqa_tpu/editors/liveedit.py``).

Edit: capture hidden states after LLM layer ``edit_layer_i``, extract an
edit-query rep (eqr), an edit-vision rep (evr) and two LoRA factors
(moe_c, moe_r), and append them to fixed-capacity ring-buffer pools.

Inference: at layer ``edit_layer_i``, hard-route experts whose visual
similarity beats the learned prototype's, keep the top ``retrieve_top_k``,
fuse them by masked softmax × sigmoid of the query similarity, and add the
relu-LoRA mixture to the layer output. Rows without an image get no
residual.

The pools are updated in place (``index_copy_``): one ring of
``max_edits`` slots instead of a new copy per edit.

Training (:class:`LiveEditTrainingMixin`, :class:`LiveEditTrainable`): the
frozen prefix (layers ``0..edit_layer_i``) runs without gradient; the
reliability, generality and locality rows then run the suffix with the
edit residual, and the loss backpropagates through the suffix into the
LiveEdit parameters only (the backbone's tensors never require a
gradient). The optimizer is ``torch.optim.Adam`` with its learning rate
set before each step from the step count.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core import decoder as dec
from ..core.losses import gathered_token_accuracy, token_accuracy
from ..core.wrapper import QueryBatch, TorchVLLM, assemble_packed
from ..ops.layers import layer_norm
from ..utils.config import BaseConfig
from . import liveedit_modules as M
from .base import EditRequest, VLLMEditor


@dataclasses.dataclass(frozen=True)
class LiveEditConfig(BaseConfig):
    @dataclasses.dataclass(frozen=True)
    class TrainConfig(BaseConfig):
        lr: float = 1e-4
        lr_cut_it: Tuple[int, ...] = (10000,)
        lr_cut_rate: float = 0.1
        rel_lambda: float = 1.0
        gen_lambda: float = 1.0
        loc_lambda: float = 1.0
        soft_routing_lambda: float = 1.0
        hard_routing_lambda: float = 1.0

    @dataclasses.dataclass(frozen=True)
    class RetrievalEditor(BaseConfig):
        module_dim: int = 1024
        cross_att_head_n: int = 8
        lora_rank: int = 4
        lora_scale: float = 5.0
        eqe_n: int = 4

    edit_model_name: str = ""
    retrieval_editor: "LiveEditConfig.RetrievalEditor" = dataclasses.field(
        default_factory=lambda: LiveEditConfig.RetrievalEditor())
    train_cfg: "LiveEditConfig.TrainConfig" = dataclasses.field(
        default_factory=lambda: LiveEditConfig.TrainConfig())
    llm_mid_dim: int = 2560
    edit_layer_i: int = 21
    max_edits: int = 1024  # pool capacity
    # The residual mixes only the top-K hard-gated experts (exact whenever
    # at most K pass the gate).
    retrieve_top_k: int = 32
    # Training only: True re-runs layer ``edit_layer_i`` on its own output
    # before the residual, as the reference's training path does (its
    # forward_from_mid_layer feeds the captured layer-k output back as
    # layer k's input); False resumes after layer k, as inference does.
    faithful_mid_layer_rerun: bool = False


def init_liveedit_params(cfg: LiveEditConfig, img_token_n: int,
                         generator: torch.Generator, device="cuda"):
    """Float32 parameters with the JAX init's distributions."""
    re = cfg.retrieval_editor
    d = cfg.llm_mid_dim
    return {
        "edit_extractor": M.init_qv_extractor(
            re.eqe_n, d, re.module_dim, img_token_n, False, generator, device),
        "inpt_extractor": M.init_qv_extractor(
            re.eqe_n, d, re.module_dim, img_token_n, True, generator, device),
        "moegen_c": M.init_lowrank_generator(
            d, re.lora_rank, d, re.module_dim, generator, device),
        "moegen_r": M.init_lowrank_generator(
            d, re.lora_rank, d, re.module_dim, generator, device),
        "instant_reps_norm": {"scale": torch.ones(d, device=device),
                              "bias": torch.zeros(d, device=device)},
    }


def empty_state(cfg: LiveEditConfig, device="cuda"):
    re = cfg.retrieval_editor
    d, m = cfg.llm_mid_dim, cfg.max_edits
    return {
        "eqr": torch.zeros((m, re.eqe_n, re.module_dim), device=device),
        "evr": torch.zeros((m, re.eqe_n, re.module_dim), device=device),
        "moe_c": torch.zeros((m, re.lora_rank, d), device=device),
        "moe_r": torch.zeros((m, re.lora_rank, d), device=device),
        "count": 0,
    }


def span_masks(kv_valid, vt_range, query_ends):
    """→ (vision, query, ans, edit) masks, each [B, L] bool: vision = the
    slot block (off where the row has no image), query = [p+V, query_end),
    ans = [query_end, valid end), edit = their union."""
    L = kv_valid.shape[1]
    p, pe = vt_range
    idx = torch.arange(L, device=kv_valid.device)[None, :]
    valid = kv_valid > 0
    qe = query_ends[:, None]
    vision = (idx >= p) & (idx < pe) & valid
    query = (idx >= pe) & (idx < qe) & valid
    ans = (idx >= qe) & valid
    return vision, query, ans, vision | query | ans


def extract_new_edit(params, cfg: LiveEditConfig, reps, vision_mask,
                     query_mask, ans_mask):
    """reps [B, L, d] → (eqr, evr, moe_c, moe_r)."""
    re = cfg.retrieval_editor
    h = re.cross_att_head_n
    scale = 1.0 / (re.lora_scale * re.lora_rank ** 0.5)
    evr = M.qv_extract_vision(params["edit_extractor"], h, reps, reps,
                              query_mask, vision_mask)
    eqr = M.qv_extract_query(params["edit_extractor"], h, reps, query_mask)
    edit_mask = vision_mask | query_mask | ans_mask
    moe_c = M.lowrank_generate(params["moegen_c"], h, scale, reps, edit_mask)
    moe_r = M.lowrank_generate(params["moegen_r"], h, scale, reps, edit_mask)
    return eqr, evr, moe_c, moe_r


def fuse_coefficients(sim, sel_mask):
    """Masked softmax × sigmoid × selection over the selected experts."""
    s = torch.where(sel_mask, sim, M.NEG_INF)
    any_sel = sel_mask.any(dim=1, keepdim=True)
    rela = torch.where(any_sel, torch.softmax(s, dim=1), 0.0)
    return rela * torch.sigmoid(sim) * sel_mask


def make_residual_fn(params, cfg: LiveEditConfig, state, vt_range, kv_valid,
                     query_ends, has_image):
    """The layer-residual intervention for the current pools."""
    re = cfg.retrieval_editor
    hn = re.cross_att_head_n
    sim_scale = 1.0 / re.module_dim ** 0.5
    slot_active = (torch.arange(cfg.max_edits, device=kv_valid.device)
                   < state["count"])[None, :]

    def fn(h):
        vision_mask, query_mask, _, _ = span_masks(kv_valid, vt_range,
                                                   query_ends)
        inpt = params["inpt_extractor"]
        ivr = M.qv_extract_vision(inpt, hn, h, h, query_mask, vision_mask)
        e = ivr.shape[1]
        vis_sim = torch.einsum("bed,med->bm", ivr, state["evr"]) / e * sim_scale
        ivr_prot = M.qv_extract_from_visprot(inpt, hn, h, query_mask)
        vis_sim_prot = (torch.einsum("bed,bed->b", ivr, ivr_prot)[:, None]
                        / e * sim_scale)
        selected = ((vis_sim > vis_sim_prot) & slot_active
                    & (has_image[:, None] > 0))
        iqr = M.qv_extract_query(inpt, hn, h, query_mask)
        q_sim = torch.einsum("bed,med->bm", iqr, state["eqr"]) / e * sim_scale
        K = min(cfg.retrieve_top_k, cfg.max_edits)
        gate_score = torch.where(selected, vis_sim, M.NEG_INF)
        topv, topi = torch.topk(gate_score, K, dim=1)
        sel_k = topv > M.NEG_INF / 2
        fuse = fuse_coefficients(q_sim.gather(1, topi), sel_k)   # [B, K]
        mc = state["moe_c"][topi]                                # [B, K, r, d]
        mr = state["moe_r"][topi]
        x = layer_norm(h, params["instant_reps_norm"]["scale"],
                       params["instant_reps_norm"]["bias"])
        t = torch.relu(torch.einsum("bld,bkrd->blkr", x.float(), mc))
        res = torch.einsum("blkr,bkrd,bk->bld", t, mr, fuse)
        # The residual is float32 (the editor's parameters are); the sum is
        # rounded once back to the backbone dtype, so the layers after the
        # edit layer keep running in that dtype (bf16 on the card, which
        # the flash kernel takes). jnp promotion would carry float32 on.
        return (h.float() + res).to(h.dtype)

    return fn


class LiveEdit(VLLMEditor):
    def __init__(self, vllm: TorchVLLM, config: LiveEditConfig, params=None,
                 seed: int = 0):
        super().__init__(vllm)
        self.cfg = config
        self.device = vllm.device
        if params is None:
            g = torch.Generator(device=self.device).manual_seed(seed)
            params = init_liveedit_params(config, vllm.cfg.n_img_tokens, g,
                                          self.device)
        self.params = params
        self.state = empty_state(config, self.device)

    def name_of_editor_and_model(self):
        return "liveedit", self.cfg.edit_model_name or self.vllm.cfg.name

    def restore_to_original_model(self):
        self.state = empty_state(self.cfg, self.device)

    # ---------------- edit ----------------

    def if_can_batch_edit(self):
        return True

    def edit_one_piece(self, request: EditRequest):
        self.edit_batch([request])

    @torch.inference_mode()
    def edit_batch(self, requests, pad_width=None):
        """Append one expert per request, in order. Pool appends are
        independent, so one batched extraction equals sequential
        ``edit_one_piece`` calls. The ring keeps the newest ``max_edits``;
        ``count`` advances by every request. ``pad_width`` is ignored:
        there are no padded rows to drop."""
        cap = self.cfg.max_edits
        if len(requests) > cap:
            # Only the last ``cap`` survive the ring anyway.
            self.state["count"] += len(requests) - cap
            requests = requests[-cap:]
        pq = self.vllm.encode_queries_packed(
            [r["prompt"] for r in requests], [r.get("image") for r in requests],
            [r["target_new"] for r in requests])
        vcfg = self.vllm.cfg
        embeds, kv, _, _ = assemble_packed(self.vllm.params, vcfg, pq.ints,
                                           pq.rowmeta, pq.img_rows)
        reps = dec.decoder_forward(self.vllm.params["decoder"], vcfg.decoder,
                                   embeds, kv, lo=0,
                                   hi=self.cfg.edit_layer_i + 1)
        vision_mask, query_mask, ans_mask, _ = span_masks(
            kv, vcfg.vt_range, pq.rowmeta[1])
        new = dict(zip(("eqr", "evr", "moe_c", "moe_r"), extract_new_edit(
            self.params, self.cfg, reps, vision_mask, query_mask, ans_mask)))
        count = self.state["count"]
        idx = (count + torch.arange(len(requests), device=self.device)) % cap
        for name, rows in new.items():
            self.state[name].index_copy_(0, idx, rows.to(self.state[name].dtype))
        self.state["count"] = count + len(requests)

    # ---------------- inference ----------------

    def _edited_hidden(self, embeds, kv_valid, query_ends, has_image):
        vcfg = self.vllm.cfg
        fn = make_residual_fn(self.params, self.cfg, self.state, vcfg.vt_range,
                              kv_valid, query_ends, has_image)
        return dec.decoder_forward(self.vllm.params["decoder"], vcfg.decoder,
                                   embeds, kv_valid,
                                   layer_residual=(self.cfg.edit_layer_i, fn))

    def _query_rows(self, qb: QueryBatch):
        qe = torch.from_numpy(self.vllm.query_end_positions(qb)).to(self.device)
        has = torch.from_numpy(qb.has_image).to(self.device)
        return qe, has

    @torch.inference_mode()
    def query_logits(self, qb: QueryBatch):
        h = self._edited_hidden(qb.embeds, qb.kv_valid, *self._query_rows(qb))
        return dec.decoder_logits(self.vllm.params["decoder"],
                                  self.vllm.cfg.decoder, h)

    @torch.inference_mode()
    def query_metrics(self, qb: QueryBatch):
        return token_accuracy(self.query_logits(qb), qb.label_ids,
                              qb.label_masks)

    @torch.inference_mode()
    def query_metrics_packed(self, pq):
        """Assemble + edited forward + metrics → (acc, pred, valid_or_None),
        with the wrapper's gathered-head rule (``TorchVLLM.packed_logits_metrics``)."""
        vcfg = self.vllm.cfg
        vparams = self.vllm.params
        embeds, kv, labels, masks = assemble_packed(vparams, vcfg, pq.ints,
                                                    pq.rowmeta, pq.img_rows)
        h = self._edited_hidden(embeds, kv, pq.rowmeta[1], pq.rowmeta[0])
        if self.vllm._gather_head_ok(pq):
            return gathered_token_accuracy(
                h, labels, masks, self.vllm._gather_positions,
                pred_fn=lambda hg: dec.decoder_pred_ids(
                    vparams["decoder"], vcfg.decoder, hg))
        a, p = token_accuracy(dec.decoder_logits(vparams["decoder"],
                                                 vcfg.decoder, h),
                              labels, masks)
        return a, p, None


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def param_leaves(tree, prefix=()):
    """[(key path, tensor)] of a nested dict, keys sorted at every level
    (the order of ``jax.tree_util.tree_leaves`` on the same dict)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(param_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def _per_row_label_loss(logits, label_ids, label_masks):
    """Per-row averaged cross-entropy, then the batch mean (the reference
    averages each sample's loss, then divides by the batch size)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, label_ids.long()[..., None])[..., 0]
    m = label_masks.float()
    per_row = -(picked * m).sum(-1) / m.sum(-1).clamp_min(1.0)
    return per_row.mean()


class LiveEditTrainingMixin:
    """Training methods for LiveEdit (mixed into :class:`LiveEditTrainable`).

    The train state is ``{"params": tree, "opt_state": {"count", "mu",
    "nu"}}``: Adam's step count and first and second moments keyed like
    the parameters, as optax's ``ScaleByAdamState`` holds them."""
    # ---- host-side batch organization (the prefetch thread) ----

    def organize_batch_data(self, cases):
        """Sample the reliability / generality / locality rows of each case
        and draw the expert-subset masks and the contrastive neighbour and
        prototype picks, from the same numpy streams in the same order as
        the JAX package, so both build identical batches. The encoded
        tensors are cloned out of inference mode: a training step saves
        them for its backward."""
        rng = self._rng_data
        B = len(cases)
        gen_keys = list(cases[0].generality.keys())
        loc_keys = [k for k in cases[0].locality.keys()
                    if cases[0].locality[k][0]["image"] is not None]
        prompts, images, targets = [], [], []

        def add(p, i, t):
            prompts.append(p)
            images.append(i)
            targets.append(t)

        for c in cases:  # rel rows [0, B)
            r = c.requests[int(rng.integers(0, len(c.requests)))]
            add(r["prompt"], r["image"], r["target_new"])
        for g in gen_keys:  # gen rows [B(1+gi), B(2+gi))
            for c in cases:
                lst = c.generality[g]
                e = lst[int(rng.integers(0, len(lst)))]
                add(e["prompt"], e["image"], e["target"])
        for loc in loc_keys:
            for c in cases:
                lst = c.locality[loc]
                e = lst[int(rng.integers(0, len(lst)))]
                add(e["prompt"], e["image"], e["target"])

        qb = self.vllm.encode_queries(prompts, images, targets)
        G, K = len(gen_keys), len(loc_keys)

        # Expert-subset masks; with one request per case the request index
        # grid is the identity.
        eye = np.eye(B, dtype=bool)
        rel_mask, gen_mask = eye.copy(), eye.copy()
        loc_mask = np.zeros((B, B), bool)
        for i in range(B):
            ns = self._rng_train.integers(0, B + 1, 3)
            rel_mask[i, :ns[0]] = True
            gen_mask[i, :ns[1]] = True
            loc_mask[i, :ns[2]] = True

        def row_of(kind, key_idx, b):
            if kind == 0:
                return b
            if kind == 1:
                return B * (1 + key_idx) + b
            return B * (1 + G + key_idx) + b

        def rand_pick(kinds, b):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            key_idx = int(rng.integers(0, G)) if kind == 1 else (
                int(rng.integers(0, K)) if kind == 2 else 0)
            return row_of(kind, key_idx, b)

        n1, n2, p1, p2 = [], [], [], []
        for b in range(B):  # neighbour pairs
            n = int(rng.integers(0, 3))
            n1.append(rand_pick([n], b) if n != 1 else rand_pick([1], b))
            n_b = int(rng.integers(0, 2)) if n != 2 else 2
            n2.append(rand_pick([n_b], b))
        for b in range(B):  # prototype pairs
            n = int(rng.integers(0, 2))
            first = [int(rng.integers(0, 2)), 2]
            p1.append(rand_pick([first[n]], b))
            p2.append(rand_pick([first[1 - n]], b))

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

        return {
            "embeds": qb.embeds.clone(), "kv_valid": qb.kv_valid.clone(),
            "label_ids": qb.label_ids.clone(),
            "label_masks": qb.label_masks.clone(),
            "query_ends": dev(self.vllm.query_end_positions(qb), torch.int64),
            "has_image": dev(qb.has_image, torch.int32),
            "rel_mask": dev(rel_mask, torch.bool),
            "gen_mask": dev(gen_mask, torch.bool),
            "loc_mask": dev(loc_mask, torch.bool),
            "n1": dev(n1, torch.int64), "n2": dev(n2, torch.int64),
            "p1": dev(p1, torch.int64), "p2": dev(p2, torch.int64),
            "B": B, "G": G, "K": K,
        }

    # ---- the loss ----

    def prefix_reps(self, batch):
        """The frozen prefix (layers ``0..edit_layer_i``) over the batch's
        rows, without gradient → [rows, L, d]."""
        with torch.no_grad():
            return dec.decoder_forward(
                self.vllm.params["decoder"], self.vllm.cfg.decoder,
                batch["embeds"], batch["kv_valid"], lo=0,
                hi=self.cfg.edit_layer_i + 1)

    def train_loss(self, lp, batch, reps=None):
        """The meta-training loss of LiveEdit parameters ``lp`` on an
        organized batch → (loss, logs), scalar tensors. Differentiable in
        ``lp`` only. ``reps``: the batch's :meth:`prefix_reps`, if already
        computed."""
        cfg = self.cfg
        vcfg = self.vllm.cfg
        dparams = self.vllm.params["decoder"]
        tc = cfg.train_cfg
        hn = cfg.retrieval_editor.cross_att_head_n
        sim_scale = 1.0 / cfg.retrieval_editor.module_dim ** 0.5
        eps = 1e-8
        B, G, K = batch["B"], batch["G"], batch["K"]
        kv = batch["kv_valid"]
        vis_m, q_m, ans_m, _ = span_masks(kv, vcfg.vt_range,
                                          batch["query_ends"])
        # The frozen prefix: representations after the edit layer.
        if reps is None:
            reps = self.prefix_reps(batch)
        dev = reps.device
        rel = torch.arange(B, device=dev)
        k_lo = cfg.edit_layer_i
        resume_lo = k_lo if cfg.faithful_mid_layer_rerun else k_lo + 1

        def suffix(h, kv_rows, lo=resume_lo):
            hh = dec.decoder_forward(dparams, vcfg.decoder, h, kv_rows, lo=lo)
            return dec.decoder_logits(dparams, vcfg.decoder, hh)

        def edited_suffix(r, res, kv_rows):
            # The residual is float32; the sum is rounded to the backbone
            # dtype, as at inference (make_residual_fn).
            if cfg.faithful_mid_layer_rerun:
                r = dec.decoder_forward(dparams, vcfg.decoder, r, kv_rows,
                                        lo=k_lo, hi=k_lo + 1)
            return suffix((r.float() + res).to(r.dtype), kv_rows,
                          lo=k_lo + 1)

        logs = {}
        eqr, _evr, moe_c, moe_r = extract_new_edit(
            lp, cfg, reps[rel], vis_m[rel], q_m[rel], ans_m[rel])

        def edited_logits(rows, mm):
            r = reps[rows]
            iqr = M.qv_extract_query(lp["inpt_extractor"], hn, r, q_m[rows])
            sim = (torch.einsum("bed,med->bm", iqr, eqr) / iqr.shape[1]
                   * sim_scale)
            fuse = fuse_coefficients(sim, mm)
            x = layer_norm(r, lp["instant_reps_norm"]["scale"],
                           lp["instant_reps_norm"]["bias"])
            t = torch.relu(torch.einsum("bld,mrd->blmr", x.float(), moe_c))
            res = torch.einsum("blmr,mrd,bm->bld", t, moe_r, fuse)
            return edited_suffix(r, res, kv[rows])

        def per_key_rows(logits, rows, n_keys, kl_pre=None):
            """Per-key token-mean losses from one batched forward."""
            m = batch["label_masks"][rows].float()
            lp1 = torch.log_softmax(logits.float(), dim=-1)
            if kl_pre is None:
                picked = lp1.gather(
                    -1, batch["label_ids"][rows].long()[..., None])[..., 0]
                per_row = -(picked * m).sum(-1) / m.sum(-1).clamp_min(1.0)
            else:
                lp2 = torch.log_softmax(kl_pre.float(), dim=-1)
                klv = (lp1.exp() * (lp1 - lp2)).sum(-1)
                per_row = (klv * m).sum(-1) / m.sum(-1).clamp_min(1.0)
            return per_row.reshape(n_keys, B).mean(1).sum()

        # Reliability
        rel_logits = edited_logits(rel, batch["rel_mask"])
        rel_loss = _per_row_label_loss(rel_logits, batch["label_ids"][rel],
                                       batch["label_masks"][rel])
        logs["rel_loss"] = rel_loss
        total = rel_loss * tc.rel_lambda
        # Generality: all G·B rows in one suffix forward
        gen_rows = B + torch.arange(G * B, device=dev)
        gen_logits = edited_logits(gen_rows, batch["gen_mask"].repeat(G, 1))
        gen_loss = per_key_rows(gen_logits, gen_rows, G)
        logs["gen_loss"] = gen_loss
        total = total + gen_loss * tc.gen_lambda
        # Locality: one batched forward and the KL to the unedited suffix
        loc_rows = B * (1 + G) + torch.arange(K * B, device=dev)
        with torch.no_grad():
            pre = suffix(reps[loc_rows], kv[loc_rows])
        loc_logits = edited_logits(loc_rows, batch["loc_mask"].repeat(K, 1))
        loc_loss = per_key_rows(loc_logits, loc_rows, K, kl_pre=pre)
        logs["loc_loss"] = loc_loss
        total = total + loc_loss * tc.loc_lambda
        # Soft-routing contrastive
        n1, n2 = batch["n1"], batch["n2"]
        iqrs = M.qv_extract_query(lp["inpt_extractor"], hn, reps[n1], q_m[n1])
        eqrs2 = M.qv_extract_query(lp["edit_extractor"], hn, reps[n2],
                                   q_m[n2])
        sim = torch.einsum("ned,med->nm", iqrs, eqrs2) / iqrs.shape[1] \
            * sim_scale
        rela = torch.softmax(sim, dim=1)
        absim = torch.sigmoid(sim)
        soft_rela = -torch.log(torch.diagonal(rela) + eps).mean()
        abs_pos = torch.diagonal(absim)
        abs_neg = torch.diagonal(torch.roll(absim, 1, dims=1))
        soft_abs = -(torch.log(abs_pos + eps)
                     + torch.log(1 - abs_neg + eps)).mean()
        soft = soft_rela + soft_abs
        logs["soft_routing_loss"] = soft
        total = total + soft * tc.soft_routing_lambda

        # Hard-routing
        def hard_sim(rows_i, rows_e):
            ri, re_ = reps[rows_i], reps[rows_e]
            ivrs = M.qv_extract_vision(lp["inpt_extractor"], hn, ri, ri,
                                       q_m[rows_i], vis_m[rows_i])
            evrs = M.qv_extract_vision(lp["edit_extractor"], hn, re_, re_,
                                       q_m[rows_e], vis_m[rows_e])
            s = torch.einsum("bed,med->bm", ivrs, evrs) / ivrs.shape[1] \
                * sim_scale
            prot = M.qv_extract_from_visprot(lp["inpt_extractor"], hn, ri,
                                             q_m[rows_i])
            sp = (torch.einsum("bed,bed->b", ivrs, prot)[:, None]
                  / ivrs.shape[1] * sim_scale)
            return torch.softmax(torch.cat([s, sp], 1), dim=1)

        sim_nb = hard_sim(n1, n2)
        hard_nb = -torch.log(torch.diagonal(sim_nb) + eps).mean()
        sim_pr = hard_sim(batch["p1"], batch["p2"])
        hard_pr = -torch.log(sim_pr[:, -1] + eps).mean()
        logs["hard_routing_neighbor_loss"] = hard_nb
        logs["hard_routing_prototype_loss"] = hard_pr
        total = total + (hard_nb + hard_pr) * tc.hard_routing_lambda
        return total, logs

    # ---- steps ----

    def _lr(self) -> float:
        """``lr · cut_rate^#(cut_it < count)`` at the count before this
        step's increment, as optax's ``scale_by_schedule`` reads it."""
        tc = self.cfg.train_cfg
        n_cuts = sum(1 for c in tc.lr_cut_it if self._opt_count > c)
        return tc.lr * tc.lr_cut_rate ** n_cuts

    def train_step(self, batch):
        """One optimization step → (loss, logs) as floats."""
        self._opt.zero_grad(set_to_none=True)
        loss, logs = self.train_loss(self.params, batch)
        loss.backward()
        for group in self._opt.param_groups:
            group["lr"] = self._lr()
        self._opt.step()
        self._opt_count += 1
        return float(loss.detach()), {k: float(v.detach()) for k, v in logs.items()}

    def val_step(self, batch):
        """The loss of the current parameters on ``batch``; no state (and
        no host random stream) changes."""
        with torch.no_grad():
            loss, logs = self.train_loss(self.params, batch)
        return float(loss.detach()), {k: float(v.detach()) for k, v in logs.items()}

    def train_init_editor(self, seed: int):
        """Fresh parameters from ``seed``, fresh Adam state, and the host
        streams ``default_rng(seed)`` (data) and ``default_rng(seed + 1)``
        (expert-subset masks)."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_liveedit_params(self.cfg,
                                           self.vllm.cfg.n_img_tokens, g,
                                           self.device)
        for _, t in param_leaves(self.params):
            t.requires_grad_(True)
        self.reseed_host(seed)
        # optax's chain scale_by_adam → scale_by_schedule → scale(-1) is
        # Adam with β = (0.9, 0.999), ε = 1e-8 added to the bias-corrected
        # √ν, no weight decay: torch's Adam computes the same update, with
        # the learning rate set before each step (``_lr``).
        self._opt = torch.optim.Adam([t for _, t in param_leaves(self.params)],
                                     lr=self.cfg.train_cfg.lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        self._opt_count = 0

    def reseed_host(self, seed: int):
        """Reseed only the host streams (checkpoint resume)."""
        self._rng_data = np.random.default_rng(seed)
        self._rng_train = np.random.default_rng(seed + 1)

    def get_train_state(self):
        """The live train state (references, not copies)."""
        mu, nu = {}, {}
        for path, t in param_leaves(self.params):
            st = self._opt.state.get(t, {})
            zeros = torch.zeros_like(t, requires_grad=False)
            _set_path(mu, path, st.get("exp_avg", zeros))
            _set_path(nu, path, st.get("exp_avg_sq", zeros))
        return {"params": self.params,
                "opt_state": {"count": self._opt_count, "mu": mu, "nu": nu}}

    def load_params(self, params):
        """Copy a parameter tree into the live parameters (the optimizer
        keeps its references to them)."""
        src = dict(param_leaves(params))
        with torch.no_grad():
            for path, t in param_leaves(self.params):
                t.copy_(src[path])

    def set_train_state(self, state):
        """Copy ``state`` into the live parameters and Adam's state."""
        self.load_params(state["params"])
        opt = state["opt_state"]
        mu = dict(param_leaves(opt["mu"]))
        nu = dict(param_leaves(opt["nu"]))
        count = int(opt["count"])
        with torch.no_grad():
            for path, t in param_leaves(self.params):
                if count == 0:
                    self._opt.state.pop(t, None)
                    continue
                self._opt.state[t] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": mu[path].detach().to(t.device, t.dtype,
                                                    copy=True),
                    "exp_avg_sq": nu[path].detach().to(t.device, t.dtype,
                                                       copy=True)}
        self._opt_count = count


def _set_path(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class LiveEditTrainable(LiveEditTrainingMixin, LiveEdit):
    """LiveEdit with the meta-training protocol attached."""

    def __init__(self, vllm, config, params=None, seed: int = 0):
        LiveEdit.__init__(self, vllm, config, params=params, seed=seed)
        self.train_init_editor(seed)
        if params is not None:
            self.load_params(params)
