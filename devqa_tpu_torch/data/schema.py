"""EVQA loading and the dynamic t×i locality probe synthesis (counterpart of
``devqa_tpu/data/schema.py``).

The t×i grid: t1 = edit prompt, t2 = retrieved-similar prompt, t3 =
multimodal-locality question; i1 = edit image, i2 = retrieved image, i3 =
locality image, i4 = no image. EVQA appends " The answer is:" to the
request, generality and locality prompts and then "?" to ``text_loc``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

from ..retrieval.store import EmbeddingStore, Retriever

LOCALITY_KEYS = ["text_loc", "t3i3", "t1i4", "t2i4", "t1i2", "t1i3", "t2i1",
                 "t2i2", "t3i1"]
GENERALITY_KEYS = ["text_rephrase", "image_rephrase"]


@dataclasses.dataclass
class TestCase:
    requests: List[Dict]                    # {'image','prompt','target_new'}
    generality: Dict[str, List[Dict]]       # {'image','prompt','target'}
    locality: Dict[str, List[Dict]]


def build_dataset_retriever(records: Sequence[Dict], img_root_dir: str,
                            encoder, top_k: int = 5,
                            device="cuda") -> Retriever:
    """The probe-retrieval store over the dataset's own source prompts."""
    sentences = [r["src"] for r in records]
    prompts = [(r["src"], r.get("pred", r.get("alt", ""))) for r in records]
    images = [os.path.join(img_root_dir, r["image"]) for r in records]
    store = EmbeddingStore.build(sentences, encoder, images, prompts)
    return Retriever(store, encoder, top_k=top_k, device=device)


def synthesize_cases(records: Sequence[Dict], img_root_dir: str,
                     retriever: Retriever, data_n: Optional[int] = None,
                     faithful_t3_path_bug: bool = False) -> List[TestCase]:
    """Request / generality / locality with the full t×i probe grid.
    ``faithful_t3_path_bug`` reproduces the reference's t3 = image path."""
    n = len(records) if data_n is None else min(len(records), data_n)
    recs = records[:n]
    sim = retriever.find_similar_batch(
        [d["src"] for d in recs],
        [d.get("pred", d.get("alt", "")) for d in recs])
    cases = []
    for d, ((t2_prompt, _t2_ans), i2_path) in zip(recs, sim):
        i1 = os.path.join(img_root_dir, d["image"])
        i3 = os.path.join(img_root_dir, d["m_loc"])
        t1, t2 = d["src"], t2_prompt
        t3 = d["m_loc"] if faithful_t3_path_bug else d["m_loc_q"]
        alt = d["alt"]
        cases.append(TestCase(
            requests=[{"image": i1, "prompt": d["src"], "target_new": alt}],
            generality={
                "text_rephrase": [{"image": i1, "prompt": d["rephrase"],
                                   "target": alt}],
                "image_rephrase": [{
                    "image": os.path.join(img_root_dir, d["image_rephrase"]),
                    "prompt": d["src"], "target": alt}],
            },
            locality={
                "text_loc": [{"image": None, "prompt": d["loc"],
                              "target": d["loc_ans"]}],
                "t3i3": [{"image": i3, "prompt": d["m_loc_q"],
                          "target": d["m_loc_a"]}],
                "t1i4": [{"image": None, "prompt": t1, "target": alt}],
                "t2i4": [{"image": None, "prompt": t2, "target": alt}],
                "t1i2": [{"image": i2_path, "prompt": t1, "target": alt}],
                "t1i3": [{"image": i3, "prompt": t1, "target": alt}],
                "t2i1": [{"image": i1, "prompt": t2, "target": alt}],
                "t2i2": [{"image": i2_path, "prompt": t2, "target": alt}],
                "t3i1": [{"image": i1, "prompt": t3, "target": d["m_loc_a"]}],
            },
        ))
    return cases


def _apply_evqa_templates(cases: List[TestCase]) -> None:
    for c in cases:
        c.requests[0]["prompt"] = "%s The answer is:" % c.requests[0]["prompt"]
        for key in GENERALITY_KEYS:
            g = c.generality[key][0]
            g["prompt"] = "%s The answer is:" % g["prompt"]
        for key in c.locality:
            c.locality[key][0]["prompt"] = (
                "%s The answer is:" % c.locality[key][0]["prompt"])
        # The reference appends "?" AFTER the template: "<q> The answer is:?"
        c.locality["text_loc"][0]["prompt"] = (
            "%s?" % c.locality["text_loc"][0]["prompt"])


class BaseVLLMEditData:
    """A loaded evaluation dataset: TestCases with image *paths*."""

    def __init__(self, cases: List[TestCase]):
        self.cases = cases

    @property
    def data(self) -> List[TestCase]:
        return self.cases

    def dataset_name(self) -> str:
        raise NotImplementedError

    def __len__(self):
        return len(self.cases)


def unique_image_paths(cases: Sequence[TestCase]) -> set:
    """All distinct image paths a case list references."""
    paths = set()
    for c in cases:
        for r in c.requests:
            paths.add(r["image"])
        for lst in list(c.generality.values()) + list(c.locality.values()):
            for e in lst:
                paths.add(e["image"])
    paths.discard(None)
    return paths


class EVQA(BaseVLLMEditData):
    """E-VQA: templates request, generality and locality prompts."""

    def __init__(self, data_path: str, img_root_dir: str,
                 retriever: Optional[Retriever] = None, data_n=None,
                 encoder=None, faithful_t3_path_bug: bool = False,
                 device="cuda"):
        """``device`` holds the probe-retrieval search when no
        ``retriever`` is given."""
        with open(data_path, "r") as f:
            records = json.load(f)
        if retriever is None:
            if encoder is None:
                raise ValueError("EVQA needs a retriever or a sentence encoder")
            retriever = build_dataset_retriever(records, img_root_dir, encoder,
                                                device=device)
        cases = synthesize_cases(records, img_root_dir, retriever, data_n,
                                 faithful_t3_path_bug=faithful_t3_path_bug)
        _apply_evqa_templates(cases)
        super().__init__(cases)

    def dataset_name(self):
        return "EVQA"
