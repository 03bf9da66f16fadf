"""The dynamic-evaluation harness: edit → measure reliability / generality /
locality over the t×i probe grid (counterpart of ``devqa_tpu/eval/harness.py``).

Same protocol and result JSON as the JAX harness:
- locality is scored against the pre-edit argmax ids (drift metric);
- sequential evaluation splits cases into groups of ``edit_n`` requests and
  runs prepare → edit → test per split, restoring between splits;
- results land in ``<results_dir>/<editor>/<model>/<eval_name>/
  {single_edit|sequential_edit_N}/(results|mean_results).json``, floats
  rounded to 4 decimals.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from copy import deepcopy
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.losses import token_accuracy
from ..data.schema import BaseVLLMEditData, TestCase, unique_image_paths
from ..data.xym import label_width
from ..editors.base import VLLMEditor
from .metrics import topk_span_agreement


def _topk_ids(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k vocabulary ids, ties to the lower index (``jax.lax.top_k``)."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class ProbeSpec:
    kind: str       # 'reliability' | 'generality' | 'locality'
    sub: str        # '' | gen_name | loc_name
    index: int      # index within the sub-list
    prompt: str
    image: Optional[str]
    target: str


def locality_agreement(pre_ids, pre_mask, post_ids, post_mask) -> float:
    """Fraction of the pre-edit supervised span whose argmax is unchanged
    post-edit, each row's predictions taken at its own supervised span."""
    a = np.asarray(pre_ids)[np.asarray(pre_mask) == 1]
    b = np.asarray(post_ids)[np.asarray(post_mask) == 1]
    n = min(len(a), len(b))
    return float((a[:n] == b[:n]).sum() / max(len(a), 1))


def case_probe_specs(case: TestCase) -> List[ProbeSpec]:
    specs = []
    for i, r in enumerate(case.requests):
        specs.append(ProbeSpec("reliability", "", i, r["prompt"], r["image"],
                               r["target_new"]))
    for gname, lst in case.generality.items():
        for i, g in enumerate(lst):
            specs.append(ProbeSpec("generality", gname, i, g["prompt"],
                                   g["image"], g["target"]))
    for lname, lst in case.locality.items():
        for i, l in enumerate(lst):
            specs.append(ProbeSpec("locality", lname, i, l["prompt"],
                                   l["image"], l["target"]))
    return specs


class EditorEvaluation:
    def __init__(self, editor: VLLMEditor, eval_data: BaseVLLMEditData,
                 evaluation_name: Optional[str] = None,
                 results_dir: str = "eval_results",
                 loc_topk: Optional[int] = None):
        self.editor = editor
        self.eval_data = eval_data
        # When set, every locality entry also gets ``topk_acc``: top-k index
        # agreement, k=1 for text_loc and k=loc_topk for image probes.
        self.loc_topk = loc_topk
        # Padded decoder tokens pushed through editor paths that bypass the
        # wrapper's counter (compute accounting = counters + probe_tokens).
        self.probe_tokens = 0
        # Does this editor ride the packed probe path? None = not asked yet.
        self._packed_editor_ok = None
        editor_name, model_name = editor.name_of_editor_and_model()
        evaluation_name = evaluation_name or time.strftime("%Y.%m.%d-%H.%M.%S")
        self.result_dir = os.path.join(results_dir, editor_name, model_name,
                                       evaluation_name)
        # Size the vision LRU to every image the run can encode (case images
        # and probe images), so splits revisiting images never re-encode.
        vllm = editor.vllm
        probe_imgs = {s.image for case in eval_data.data
                      for s in case_probe_specs(case) if s.image}
        vllm.ensure_image_cache_capacity(
            len(set(unique_image_paths(eval_data.data)) | probe_imgs))

    def _query_logits_counted(self, qb) -> torch.Tensor:
        vllm = self.editor.vllm
        ntok = int(qb.embeds.shape[0] * qb.embeds.shape[1])
        c0 = vllm.counters["decoder_tokens"]
        logits = self.editor.query_logits(qb)
        self.probe_tokens += max(0, ntok - (vllm.counters["decoder_tokens"] - c0))
        return logits

    def _query_metrics_counted(self, qb):
        vllm = self.editor.vllm
        ntok = int(qb.embeds.shape[0] * qb.embeds.shape[1])
        c0 = vllm.counters["decoder_tokens"]
        accs, preds = self.editor.query_metrics(qb)
        self.probe_tokens += max(0, ntok - (vllm.counters["decoder_tokens"] - c0))
        return accs, preds

    def _try_packed_metrics(self, prompts, images, targets, via_editor):
        """The packed probe path → (acc, pred, label_masks) or None when
        unsupported (loc_topk needs materialized logits; editors without a
        packed program fall back)."""
        vllm = self.editor.vllm
        if self.loc_topk or (via_editor and self._packed_editor_ok is False):
            return None
        pq = vllm.encode_queries_packed(prompts, images, targets)
        ntok = int(pq.label_masks_full.shape[0] * pq.label_masks_full.shape[1])
        c0 = vllm.counters["decoder_tokens"]
        if via_editor:
            out = self.editor.query_metrics_packed(pq)
            self._packed_editor_ok = out is not None
            if out is None:
                return None
        else:
            out = vllm.packed_logits_metrics(pq)
        self.probe_tokens += max(0, ntok - (vllm.counters["decoder_tokens"] - c0))
        a, p, valid = out
        return a, p, (pq.label_masks_full if valid is None else valid)

    def _k_for(self, sub: str) -> int:
        return 1 if sub == "text_loc" else int(self.loc_topk)

    # ------------------------------------------------------------------
    def _measure_case(self, case: TestCase, before: Dict) -> Dict:
        """Post-edit measurement of one case; ``before`` maps a locality
        spec key → (pred_ids_row, masks_row, topk_row) captured pre-edit."""
        vllm = self.editor.vllm
        specs = case_probe_specs(case)
        qb = self.editor.build_query_batch(
            [s.prompt for s in specs], [s.image for s in specs],
            [s.target for s in specs])
        logits = self._query_logits_counted(qb)
        accs, preds = token_accuracy(logits, qb.label_ids, qb.label_masks)
        post_topk = (_np(_topk_ids(logits, int(self.loc_topk)))
                     if self.loc_topk else None)
        accs, preds, masks = _np(accs), _np(preds), _np(qb.label_masks)

        rd: Dict = {"reliability": [], "generality": {}, "locality": {}}
        for row, s in enumerate(specs):
            entry = {"prompt": s.prompt, "image": s.image, "target": s.target}
            entry["predict_after_edit"] = vllm.tokenizer.decode(
                preds[row][masks[row] == 1].tolist())
            if s.kind == "locality":
                ref_ids, ref_mask, ref_topk = before[(s.sub, s.index)]
                acc = locality_agreement(ref_ids, ref_mask, preds[row],
                                         masks[row])
                if post_topk is not None:
                    entry["topk_acc"] = topk_span_agreement(
                        ref_topk, ref_mask, post_topk[row], masks[row],
                        self._k_for(s.sub))
                entry["predict_before_edit"] = vllm.tokenizer.decode(
                    ref_ids[ref_mask == 1].tolist())
            else:
                acc = float(accs[row])
            entry["acc"] = acc
            if s.kind == "reliability":
                rd["reliability"].append(entry)
            else:
                rd[s.kind].setdefault(s.sub, []).append(entry)
        return rd

    def _before_edit_locality(self, case: TestCase) -> Dict:
        """Pre-edit argmax snapshot for every locality probe, one forward."""
        vllm = self.editor.vllm
        specs = [s for s in case_probe_specs(case) if s.kind == "locality"]
        if not specs:
            return {}
        qb = vllm.encode_queries([s.prompt for s in specs],
                                 [s.image for s in specs],
                                 [s.target for s in specs])
        logits = vllm.logits(qb.embeds, qb.kv_valid)
        _, preds = token_accuracy(logits, qb.label_ids, qb.label_masks)
        topk = (_np(_topk_ids(logits, int(self.loc_topk)))
                if self.loc_topk else None)
        preds, masks = _np(preds), _np(qb.label_masks)
        return {(s.sub, s.index):
                (preds[i], masks[i], topk[i] if topk is not None else None)
                for i, s in enumerate(specs)}

    # ------------------------------------------------------------------
    def evaluate_single_edit(self) -> List[Dict]:
        editor = self.editor
        print("Evaluating reliability, generality and locality for %s on %s "
              "with single editing." % editor.name_of_editor_and_model())
        editor.restore_to_original_model()
        results = []
        for case in self.eval_data.data:
            if len(case.requests) != 1:
                raise ValueError("single-edit evaluation needs one request "
                                 "per case")
            before = self._before_edit_locality(case)
            start = time.time()
            editor.edit_one_piece(case.requests[0])
            edit_time = time.time() - start
            rd = self._measure_case(case, before)
            rd["reliability"][0]["edit_time"] = edit_time
            results.append(rd)
            editor.restore_to_original_model()
        save_dir = os.path.join(self.result_dir, "single_edit")
        self.save_results(os.path.join(save_dir, "results.json"), results)
        mean_results = self.get_mean_results(results)
        mean_results["sample_count"] = len(results)
        self.save_results(os.path.join(save_dir, "mean_results.json"),
                          mean_results)
        return results

    def evaluate_sequential_edit(self, edit_n: int = 10, random: bool = False,
                                 seed: Optional[int] = None
                                 ) -> List[List[Dict]]:
        editor = self.editor
        print("Evaluating reliability, generality and locality for %s on %s "
              "with sequential editing %s."
              % (*editor.name_of_editor_and_model(), edit_n))
        splits, split_ns, seed = self._split_and_shuffle(edit_n, random, seed)
        editor.restore_to_original_model()
        results = []
        for split in splits:
            befores = [self._before_edit_locality(c) for c in split]
            edit_times = []
            for case in split:
                for r in case.requests:
                    start = time.time()
                    editor.edit_one_piece(r)
                    edit_times.append(time.time() - start)
            split_res = []
            ti = 0
            for case, before in zip(split, befores):
                rd = self._measure_case(case, before)
                for rr in rd["reliability"]:
                    rr["edit_time"] = edit_times[ti]
                    ti += 1
                split_res.append(rd)
            editor.restore_to_original_model()
            results.append(split_res)
        self._save_sequential(results, split_ns, edit_n, random, seed)
        return results

    # ------------------------------------------------------------------
    def _split_and_shuffle(self, edit_n: int, random: bool,
                           seed: Optional[int]):
        cases = list(self.eval_data.data)
        if random:
            seed = seed if seed is not None \
                else int(np.random.randint(1, 999999))
            np.random.default_rng(seed).shuffle(cases)
        splits, counts, cur, cur_n = [], [], [], 0
        for d in cases:
            cur.append(d)
            cur_n += len(d.requests)
            if cur_n >= edit_n:
                splits.append(cur)
                counts.append(cur_n)
                cur, cur_n = [], 0
        if cur:
            print("WARNING: %d trailing case(s) (%d requests) do not fill "
                  "a final edit_n=%d split and are excluded (reference "
                  "split_data semantics)." % (len(cur), cur_n, edit_n),
                  file=sys.stderr)
        if not splits:
            raise ValueError(
                "edit_n=%d exceeds the dataset's total request count (%d) "
                "— no split can be formed" % (edit_n, cur_n))
        return splits, counts, seed

    def _save_sequential(self, results, split_ns, edit_n: int, random: bool,
                         seed) -> None:
        save_dir = os.path.join(self.result_dir, "sequential_edit_%s" % edit_n)
        prefix = "seed_%s_" % seed if random else ""
        self.save_results(os.path.join(save_dir, prefix + "results.json"),
                          results)
        split_mean = [self.get_mean_results(sr) for sr in results]
        for mr, n in zip(split_mean, split_ns):
            mr["sequential_edit_n"] = n
        total_mean = self.get_mean_results([r for sr in results for r in sr])
        total_mean["total_edit_n"] = sum(split_ns)
        self.save_results(os.path.join(save_dir, prefix + "mean_results.json"),
                          {"total_mean": total_mean, "split_mean": split_mean})

    # ------------------------------------------------------------------
    def get_mean_results(self, results: List[Dict]) -> Dict:
        """Mean of every numeric field, per reliability / generality sub /
        locality sub."""
        mean: Dict = {"reliability": {}, "generality": {}, "locality": {}}

        def acc_into(bucket, entry):
            for k, v in entry.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    bucket.setdefault(k, [0.0, 0])
                    bucket[k][0] += v
                    bucket[k][1] += 1

        for r in results:
            for rr in r["reliability"]:
                acc_into(mean["reliability"], rr)
            for kind in ("generality", "locality"):
                for sub, lst in r[kind].items():
                    bucket = mean[kind].setdefault(sub, {})
                    for e in lst:
                        acc_into(bucket, e)
        for k, v in list(mean["reliability"].items()):
            mean["reliability"][k] = v[0] / v[1]
        for kind in ("generality", "locality"):
            for sub in mean[kind]:
                for k, v in list(mean[kind][sub].items()):
                    mean[kind][sub][k] = v[0] / v[1]
        return mean

    def save_results(self, save_path: str, results, decimal: int = 4) -> None:
        def set_decimal(r):
            if isinstance(r, list):
                return [set_decimal(x) for x in r]
            if isinstance(r, dict):
                return {k: set_decimal(v) for k, v in r.items()}
            if isinstance(r, float):
                return round(r, decimal)
            return r

        res = set_decimal(deepcopy(results))
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        with open(save_path, "w") as f:
            json.dump(res, f, indent=4)
        print("save to", save_path)


class FusedEditorEvaluation(EditorEvaluation):
    """Throughput-oriented sequential evaluation, protocol-equivalent to
    ``evaluate_sequential_edit``: one chunked pass for every pre-edit
    locality probe (hoisted over splits: the pre-edit model is the same
    restored model for all), one batched edit call per split, and one
    chunked pass for all post-edit probes of a split. Every chunk is
    padded to its pass's row count (the pre and post passes hold 9 and 12
    probes per EVQA case, so each has its own size)."""

    def __init__(self, *args, max_rows: int = 96,
                 pre_rows: Optional[int] = None,
                 post_rows: Optional[int] = None, **kw):
        super().__init__(*args, **kw)
        self.max_rows = max_rows
        self.pre_rows = pre_rows or max_rows
        self.post_rows = post_rows or max_rows
        # Size the gathered LM head to the run's widest supervised span
        # (rounded up to 16; raise-only, so earlier runs stay exact).
        vllm = self.editor.vllm
        pairs = {(s.prompt, s.target) for case in self.eval_data.data
                 for s in case_probe_specs(case)}
        if pairs and vllm._gather_positions:
            w = max(label_width(vllm.tokenizer, p, t) for p, t in pairs)
            vllm._gather_positions = max(vllm._gather_positions,
                                         -(-max(w, 1) // 16) * 16)

    def _dispatch_probe_rows(self, specs, edited: bool, rows=None):
        """Run probe specs in chunks without copying results to the host;
        returns a pending list for :meth:`_collect_probe_rows`."""
        if not specs:
            return []
        rows = rows or self.max_rows
        vllm = self.editor.vllm
        pending = []
        for i in range(0, len(specs), rows):
            chunk = specs[i:i + rows]
            real = len(chunk)
            if real < rows:
                chunk = chunk + [chunk[-1]] * (rows - real)
            prompts = [s.prompt for s in chunk]
            images = [s.image for s in chunk]
            targets = [s.target for s in chunk]
            tk = None
            packed = self._try_packed_metrics(prompts, images, targets, edited)
            if packed is not None:
                a, p, masks = packed
                pending.append((real, a, p, masks, None))
                continue
            if edited:
                qb = self.editor.build_query_batch(prompts, images, targets)
                if self.loc_topk:
                    logits = self._query_logits_counted(qb)
                    a, p = token_accuracy(logits, qb.label_ids, qb.label_masks)
                    tk = _topk_ids(logits, int(self.loc_topk))
                else:
                    a, p = self._query_metrics_counted(qb)
            else:
                qb = vllm.encode_queries(prompts, images, targets)
                if self.loc_topk:
                    logits = vllm.logits(qb.embeds, qb.kv_valid)
                    a, p = token_accuracy(logits, qb.label_ids, qb.label_masks)
                    tk = _topk_ids(logits, int(self.loc_topk))
                else:
                    a, p = vllm.logits_metrics(qb.embeds, qb.kv_valid,
                                               qb.label_ids, qb.label_masks)
            pending.append((real, a, p, qb.label_masks, tk))
        return pending

    @staticmethod
    def _collect_probe_rows(pending):
        """Pending chunks → (accs, preds, masks, topk) numpy arrays."""
        if not pending:
            return (np.zeros((0,), np.float32), np.zeros((0, 1), np.int64),
                    np.zeros((0, 1), np.int64), None)
        accs, preds, masks, topks = [], [], [], []
        for real, a, p, m, tk in pending:
            accs.append(_np(a)[:real])
            preds.append(_np(p)[:real])
            masks.append(_np(m)[:real])
            if tk is not None:
                topks.append(_np(tk)[:real])
        L = max(x.shape[1] for x in preds)

        def padcat(xs):
            return np.concatenate(
                [np.pad(x, ((0, 0), (0, L - x.shape[1]))
                        + ((0, 0),) * (x.ndim - 2)) for x in xs])

        topk = padcat(topks) if topks else None
        return np.concatenate(accs), padcat(preds), padcat(masks), topk

    def evaluate_sequential_edit(self, edit_n: int = 10, random: bool = False,
                                 seed: Optional[int] = None):
        editor = self.editor
        print("Evaluating (fused) %s on %s with sequential editing %s."
              % (*editor.name_of_editor_and_model(), edit_n))
        splits, split_ns, seed = self._split_and_shuffle(edit_n, random, seed)
        editor.restore_to_original_model()
        # Wall seconds of the pipeline stages: the up-front vision warm, the
        # host loop that launches every pass and edit, and the collection
        # that waits for the device and assembles results.
        self.phase_times: Dict[str, float] = {}
        _t_warm = time.time()
        # Encode the whole probe grid's unique images in full fixed-size
        # batches before any chunk runs (a no-op when the LRU cannot hold
        # them all).
        editor.vllm.warm_image_cache(
            [s.image for split in splits for case in split
             for s in case_probe_specs(case)])
        self.phase_times["warm_s"] = time.time() - _t_warm
        _t_disp = time.time()

        # Every split's pre-edit locality probes, in one chunked pass.
        pre_specs, pre_slices = [], []
        for case in (c for split in splits for c in split):
            specs = [s for s in case_probe_specs(case) if s.kind == "locality"]
            pre_slices.append((len(pre_specs), len(pre_specs) + len(specs),
                               specs))
            pre_specs.extend(specs)
        pre_pending = self._dispatch_probe_rows(pre_specs, False,
                                                rows=self.pre_rows)
        per_split = []
        for split in splits:
            requests = [r for case in split for r in case.requests]
            start = time.time()
            if editor.if_can_batch_edit():
                editor.edit_batch(requests, pad_width=len(requests))
            else:
                for r in requests:
                    editor.edit_one_piece(r)
            per_edit = (time.time() - start) / max(len(requests), 1)
            all_specs, slices = [], []
            for case in split:
                specs = case_probe_specs(case)
                slices.append((len(all_specs), len(all_specs) + len(specs),
                               specs))
                all_specs.extend(specs)
            post_pending = self._dispatch_probe_rows(all_specs, True,
                                                     rows=self.post_rows)
            editor.restore_to_original_model()
            per_split.append((split, slices, post_pending, per_edit))
        self.phase_times["dispatch_s"] = time.time() - _t_disp
        _t_coll = time.time()

        _, pre_preds, pre_masks, pre_topk = self._collect_probe_rows(
            pre_pending)
        all_befores = [{(s.sub, s.index):
                        (pre_preds[j], pre_masks[j],
                         pre_topk[j] if pre_topk is not None else None)
                        for j, s in zip(range(lo, hi), specs)}
                       for lo, hi, specs in pre_slices]
        results = []
        tok = editor.vllm.tokenizer
        k = 0
        for split, slices, post_pending, per_edit in per_split:
            befores = all_befores[k:k + len(split)]
            k += len(split)
            accs, preds, masks, post_topk = self._collect_probe_rows(
                post_pending)
            split_res = []
            for case, before, (lo, hi, specs) in zip(split, befores, slices):
                rd: Dict = {"reliability": [], "generality": {},
                            "locality": {}}
                for j, s in zip(range(lo, hi), specs):
                    entry = {"prompt": s.prompt, "image": s.image,
                             "target": s.target}
                    entry["predict_after_edit"] = tok.decode(
                        preds[j][masks[j] == 1].tolist())
                    if s.kind == "locality":
                        ref_ids, ref_mask, ref_topk = before[(s.sub, s.index)]
                        entry["acc"] = locality_agreement(
                            ref_ids, ref_mask, preds[j], masks[j])
                        if post_topk is not None:
                            entry["topk_acc"] = topk_span_agreement(
                                ref_topk, ref_mask, post_topk[j], masks[j],
                                self._k_for(s.sub))
                        entry["predict_before_edit"] = tok.decode(
                            ref_ids[ref_mask == 1].tolist())
                    else:
                        entry["acc"] = float(accs[j])
                        if s.kind == "reliability":
                            entry["edit_time"] = per_edit
                    if s.kind == "reliability":
                        rd["reliability"].append(entry)
                    else:
                        rd[s.kind].setdefault(s.sub, []).append(entry)
                split_res.append(rd)
            results.append(split_res)
        self.phase_times["collect_s"] = time.time() - _t_coll
        self._save_sequential(results, split_ns, edit_n, random, seed)
        return results
