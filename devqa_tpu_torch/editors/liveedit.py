"""LiveEdit — lifelong VLLM editing with per-edit LoRA experts and two-stage
(hard visual / soft query) routing; inference only (counterpart of
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
"""
from __future__ import annotations

import dataclasses

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
    class RetrievalEditor(BaseConfig):
        module_dim: int = 1024
        cross_att_head_n: int = 8
        lora_rank: int = 4
        lora_scale: float = 5.0
        eqe_n: int = 4

    edit_model_name: str = ""
    retrieval_editor: "LiveEditConfig.RetrievalEditor" = dataclasses.field(
        default_factory=lambda: LiveEditConfig.RetrievalEditor())
    llm_mid_dim: int = 2560
    edit_layer_i: int = 21
    max_edits: int = 1024  # pool capacity
    # The residual mixes only the top-K hard-gated experts (exact whenever
    # at most K pass the gate).
    retrieve_top_k: int = 32


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
