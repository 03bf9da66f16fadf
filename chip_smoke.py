#!/usr/bin/env python3
"""Drive the PyTorch port (``devqa_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--kernels-only]

Phases, each printing one JSON line on stdout:

1. device — the card (``nvidia-smi`` name and power limit, torch's name);
2. build — compile every hand-written kernel of the path from
   ``devqa_tpu_torch/ops/csrc`` with nvcc for sm_90a; ptxas's registers,
   spills and static shared memory per instantiation, and for each
   flash_fwd instantiation the CUDA runtime's registers, dynamic shared
   memory and resident blocks per SM;
3. kernel — call each kernel's wrapper on the card at every shape the
   paths give it and at the design's edge cases, and hold it against its
   plain PyTorch version; time the kernel, the plain version and one
   library call;
4. main path — BLIP-2-OPT-2.7b at full width (random bf16 weights from a
   seed) under LiveEdit (1024-slot pools, top-8 routing, edit layer 21),
   scored by the fused sequential evaluation on synthetic EVQA cases: one
   warm split of 10 cases and one timed split of 10; the kernels' launch
   counts are set to 0 just before the timed split and read just after;
5. reference — the same model with every attention call on the plain
   version, on a few probes: the logits must agree;
6. kernel_bwd — the backward kernels (K2 dq, K3 dk/dv) at the training
   path's shapes and at edge cases, held against their plain version:
   each gradient within 2e-2 of its largest plain value, exact zeros for
   masked keys and dead rows; timed beside the plain version and the
   library's backward;
7. train_path — LiveEdit meta-training of the same model (the one
   BLIP-2 init is shared) through ``EditorTrainer``: one warm step, then
   timed steps with the launch counts set to 0 just before and read just
   after, ending with the trainer's "Best" flush;
8. train_reference — one loss and gradient evaluation with the kernels
   and again with every attention call, forward and backward, on the
   plain versions: loss and gradients must agree;
9. llava_path — with the BLIP-2 backbone freed, LLaVA-1.5-7b at full width
   and depth (CLIP ViT-L/14-336, MLP bridge, Vicuna-7b; random bf16
   weights from a seed) under LiveEdit from
   ``configs/liveedit/llava-v1.5-7b.yaml``, by the same fused sequential
   evaluation at the JAX package's bench settings: one warm run of 8 cases
   in splits of 4, then one timed run, with the launch counts set to 0
   just before it and read just after;
10. llava_reference — phase 5 for LLaVA (CLIP tower at head dim 64,
   Vicuna at head dim 128);
11. llava_train_path — phase 7 for LLaVA on the same params (64-token
   text buckets, LiveEdit from its configuration file), K2/K3 at head
   dim 128;
12. llava_train_reference — phase 8 for LLaVA, both sides fed the plain
   side's prefix representations.

Then a ``kernel_ranking`` line (flash_fwd's shapes by launches on the
paths x (ms - bound_ms), the order in which the next redesign takes
them), a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero without that last line; so does a host without a CUDA device.
``--profile`` also traces the timed splits of both evaluations and the
timed training steps of both models with ``torch.profiler``, prints their
device busy share and device time by kernel family (a report, not a
check) and writes every kernel's time to ``build/profile_kernels.txt``,
``build/profile_train_kernels.txt``, ``build/profile_llava_kernels.txt``
and ``build/profile_llava_train_kernels.txt``.
``--kernels-only`` stops after phase 6 (build and the kernel checks, the
quickest test of a kernel change) and prints neither of the last lines.
"""
import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

# Published peaks of one H100 SXM (dense): the bound of a kernel is the
# larger of bytes / memory rate and operations / bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

OUT_TOL = 2e-2    # output max-abs: bf16 rounding of P and of the output
LSE_TOL = 1e-3    # lse max-abs on live rows: f32 sums in another order
LOGITS_TOL = 5e-2  # relative L2 of end-to-end logits, kernel vs plain
GRAD_TOL = 2e-2   # backward kernels: max-abs error over max|plain| per tensor
LOSS_RTOL = 1e-2  # training loss, kernels vs plain attention
TRAIN_GRAD_TOL = 5e-2  # relative L2 per gradient (bf16 through 10 layers)
# A leaf whose gradient nearly cancels (a cross-attention's key biases get
# exactly zero: softmax ignores a shift shared by all keys; its key
# weights nearly zero when the keys are alike) holds mostly rounding noise,
# and the plain run's prefix differs from the kernels' by bf16 noise; its
# error is measured against this share of the whole gradient's norm.
GRAD_NOISE_FLOOR = 1e-4

TRAIN_BATCH = 4   # cases per training step (the reference CLI's default)
TRAIN_STEPS = 8   # timed training steps after the warm one
# LLaVA's chained logits (each side with its own vision tokens, through 23
# CLIP and 32 Vicuna layers of random bf16 weights) sit on a bf16 noise
# floor of about 5e-2: plain bf16 attention lands as far from float32
# attention (P unrounded) as the kernels from plain bf16. So they are
# gated against that floor, measured on the same line: the kernels may be
# at most this factor farther from plain bf16 than float32 attention is.
CHAINED_FLOOR_FACTOR = 1.25


@dataclasses.dataclass(frozen=True)
class EvalPath:
    """One fused sequential evaluation the script drives: its line's phase
    names, the cases of a run (one warm run, then one timed), the
    sequential-edit split, the wrapper's bucketing and the probe chunk
    rows of the pre-edit and post-edit passes."""

    phase: str    # the summary line's phase
    prefix: str   # of the other lines' phases and the profile's file name
    cases: int
    edit_n: int
    bucket_multiple: int
    min_len: int
    max_rows: int
    pre_rows: int
    post_rows: int
    # LiveEdit's configuration file (repository-relative), or None for the
    # settings written out in drive_main_path
    liveedit_yaml: Optional[str] = None
    # The reference phase's bound on the logits of each side's own probe
    # batch (each with its own vision tokens): None for LOGITS_TOL, or a
    # factor of their bf16 noise floor (CHAINED_FLOOR_FACTOR).
    chained_floor_factor: Optional[float] = None

    def name(self, kind: str) -> str:
        return "%s_%s" % (self.prefix, kind) if self.prefix else kind


# BLIP-2-OPT-2.7b: one split of 10 cases, 32-token text buckets.
BLIP2_EVAL = EvalPath("main_path", "", cases=10, edit_n=10,
                      bucket_multiple=32, min_len=32, max_rows=60,
                      pre_rows=90, post_rows=120)
# LLaVA-1.5-7b: the JAX package's bench settings (bench_llava_pipeline):
# 8 cases in splits of 4, 64-token text buckets (rows of 1 + 576 + 63
# tokens), probe chunks of 30 rows, LiveEdit from its configuration file.
# The tower's tokens and the decoder from one probe batch are gated, each
# at 5e-2; the chained logits at CHAINED_FLOOR_FACTOR x their floor (the
# llava_reference line's plain-vs-float32 number, 0.050-0.051 on an H100
# 80GB HBM3 at 700 W, where the kernels came out 0.0502-0.0505 from plain).
LLAVA_EVAL = EvalPath("llava_path", "llava", cases=8, edit_n=4,
                      bucket_multiple=64, min_len=64, max_rows=30,
                      pre_rows=30, post_rows=30,
                      liveedit_yaml="configs/liveedit/llava-v1.5-7b.yaml",
                      chained_floor_factor=CHAINED_FLOOR_FACTOR)


@dataclasses.dataclass(frozen=True)
class TrainPath:
    """One LiveEdit meta-training run the script drives: its lines' phase
    prefix, the wrapper's bucketing, LiveEdit's configuration file, and
    whether the reference phase feeds both sides one prefix."""

    prefix: str   # phases <prefix>_path, <prefix>_reference, <prefix>_profile
    bucket_multiple: int
    min_len: int
    liveedit_yaml: Optional[str] = None  # None: LiveEditConfig's defaults
    # The reference phase gates the kernels fed the plain side's prefix
    # representations (the suffix's 10 layers alone) and reports the
    # chained numbers beside their floor; else it gates the chained ones.
    shared_prefix: bool = False

    def name(self, kind: str) -> str:
        return "%s_%s" % (self.prefix, kind)


# BLIP-2-OPT-2.7b: 32-token text buckets, LiveEditConfig's defaults.
BLIP2_TRAIN = TrainPath("train", bucket_multiple=32, min_len=32)
# LLaVA-1.5-7b: the LLaVA evaluation's buckets and LiveEdit file, on the
# same params. Its chained numbers carry the LLaVA evaluation's bf16 noise
# floor (the tower and the 22 prefix layers), which puts the chained
# gradients over 5e-2 (0.10 on an H100 80GB HBM3 at 700 W, with float32
# attention as far off), so the gates hold the 10 differentiated layers.
LLAVA_TRAIN = TrainPath("llava_train", bucket_multiple=64, min_len=64,
                        liveedit_yaml="configs/liveedit/llava-v1.5-7b.yaml",
                        shared_prefix=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[torch.cuda.current_device()]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls.
    The calls queue behind a device-side sleep, so the device runs them
    back to back and the host's launch overhead stays out of the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 3: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

# (label, B, H, Lq, Lk, D, mask, causal) — the path's shapes: the ViT over
# 257 tokens in batches of 8 images, the Q-Former's self- and
# cross-attention, the OPT decoder over [slot 32 | text 32] at the post
# pass (120 rows), the pre pass (90) and the edit batch (10), and the
# training step's prefix (36 rows) and suffixes (reliability 4,
# generality 8, locality 24 rows); then shapes no path launches: a causal
# call with Lq < Lk, a ragged one with a dead row, and the edges of the
# kernel's design: many key tiles (the load ring wraps), a whole key tile
# masked between live ones, Lq = 1 and Lk = 1, a grid of many blocks per
# SM, and each head dim at the one-tile shape. Then the LLaVA path's
# shapes: the CLIP-L tower over 577 tokens in batches of 8 images, the
# Vicuna probe rows (30 rows of [BOS | slot 576 | text 63], pre and post
# passes alike) and the edit batch (4 rows), a batch of text-only rows
# (keys 1-576 dead: nine whole key tiles), and head dims 120 and 128 at the
# design's edges; then the LLaVA training step's prefix (36 rows) and its
# generality (8) and locality (24) suffixes (the reliability suffix's 4
# rows share the edit batch's shape). Each row's launches on the paths are
# counted in the run (launches_by_shape).
KERNEL_CASES = [
    ("vit", 8, 16, 257, 257, 88, None, False),
    ("qformer_self", 8, 12, 32, 32, 64, None, False),
    ("qformer_cross", 8, 12, 32, 257, 64, None, False),
    ("opt_post", 120, 32, 64, 64, 80, "slot", True),
    ("opt_pre", 90, 32, 64, 64, 80, "slot", True),
    ("opt_edit", 10, 32, 64, 64, 80, "slot", True),
    ("train_prefix", 36, 32, 64, 64, 80, "slot", True),
    ("train_rel", 4, 32, 64, 64, 80, "slot", True),
    ("train_gen", 8, 32, 64, 64, 80, "slot", True),
    ("train_loc", 24, 32, 64, 64, 80, "slot", True),
    ("causal_lq_lt_lk", 4, 32, 16, 200, 80, "prefix", True),
    ("ragged", 3, 5, 77, 131, 88, "random", False),
    ("ring_wrap_d88", 2, 4, 64, 1000, 88, None, False),
    ("ring_wrap_causal", 1, 2, 128, 1000, 80, "prefix", True),
    ("masked_tile", 2, 4, 70, 192, 80, "hole", False),
    ("lq1", 3, 4, 1, 257, 80, "prefix", True),
    ("lk1", 3, 4, 40, 1, 88, None, True),
    ("lq1_lk1", 2, 2, 1, 1, 64, None, False),
    ("many_blocks", 300, 32, 64, 64, 80, "slot", True),
    ("one_tile_d64", 8, 12, 64, 64, 64, "random", True),
    ("one_tile_d80", 8, 12, 64, 64, 80, "random", True),
    ("one_tile_d88", 8, 12, 64, 64, 88, "random", True),
    ("llava_vit", 8, 16, 577, 577, 64, None, False),
    ("llava_rows", 30, 32, 640, 640, 128, "llava_slot", True),
    ("llava_edit", 4, 32, 640, 640, 128, "llava_slot", True),
    ("llava_text_only", 4, 32, 640, 640, 128, "llava_text", True),
    ("d128_ragged", 3, 5, 77, 131, 128, "random", False),
    ("d120_ragged", 3, 5, 77, 131, 120, "random", False),
    ("d128_causal_lq_lt_lk", 4, 8, 16, 200, 128, "prefix", True),
    ("d120_causal", 2, 4, 100, 100, 120, "random", True),
    ("d128_lq1", 3, 4, 1, 640, 128, "prefix", True),
    ("d128_lk1", 3, 4, 40, 1, 128, None, True),
    ("d128_lq1_lk1", 2, 2, 1, 1, 128, None, False),
    ("d128_masked_tile", 2, 4, 70, 192, 128, "hole", False),
    ("d128_ring_wrap", 2, 4, 64, 1000, 128, None, False),
    ("d128_one_tile", 8, 12, 64, 64, 128, "random", True),
    ("llava_train_prefix", 36, 32, 640, 640, 128, "llava_slot", True),
    ("llava_train_gen", 8, 32, 640, 640, 128, "llava_slot", True),
    ("llava_train_loc", 24, 32, 640, 640, 128, "llava_slot", True),
]

LLAVA_SLOT = (1, 577)  # LLaVA's vision slot: keys 1-576, after BOS


def _kv_valid(kind, b, lk, gen):
    dev = "cuda"
    if kind is None:
        return None
    if kind == "slot":
        # Vision slot (32 keys) masked on every odd row, text a prefix.
        kv = torch.zeros((b, lk), dtype=torch.int32, device=dev)
        kv[0::2, :32] = 1
        lens = torch.randint(8, lk - 32 + 1, (b,), generator=gen, device=dev)
        kv[:, 32:] = (torch.arange(lk - 32, device=dev)[None, :]
                      < lens[:, None]).to(torch.int32)
        return kv
    if kind in ("llava_slot", "llava_text"):
        # [BOS | vision slot | text]: BOS live, the slot live on even rows
        # ("llava_slot") or on none (text-only rows), the text a prefix.
        lo, hi = LLAVA_SLOT
        kv = torch.zeros((b, lk), dtype=torch.int32, device=dev)
        kv[:, :lo] = 1
        if kind == "llava_slot":
            kv[0::2, lo:hi] = 1
        lens = torch.randint(8, lk - hi + 1, (b,), generator=gen, device=dev)
        kv[:, hi:] = (torch.arange(lk - hi, device=dev)[None, :]
                      < lens[:, None]).to(torch.int32)
        return kv
    if kind == "prefix":
        lens = torch.randint(1, lk + 1, (b,), generator=gen, device=dev)
        return (torch.arange(lk, device=dev)[None, :]
                < lens[:, None]).to(torch.int32)
    if kind == "hole":  # keys 64-127, a whole key tile, dead between live
        kv = torch.ones((b, lk), dtype=torch.int32, device=dev)
        kv[:, 64:128] = 0
        return kv
    kv = (torch.rand((b, lk), generator=gen, device=dev) < 0.7).to(torch.int32)
    kv[0] = 0  # a batch row with no live key
    return kv


def _live_pairs(kv, b, lq, lk, causal):
    """[B, Lq, Lk] bool: the (query, key) pairs the softmax keeps."""
    live = torch.ones((b, lq, lk), dtype=torch.bool, device="cuda")
    if kv is not None:
        live &= (kv != 0)[:, None, :]
    if causal:
        qi = torch.arange(lq, device="cuda")[:, None] + (lk - lq)
        live &= torch.arange(lk, device="cuda")[None, :] <= qi
    return live


def check_flash_kernel(attn):
    """Every path shape: the kernel within tolerance of the plain version
    (computed in float32 from the same bf16 inputs), dead rows exactly
    zero with lse = -1e30, and the three timings."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    for label, b, h, lq, lk, d, mask, causal in KERNEL_CASES:
        q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for n in (lq, lk, lk))
        kv = _kv_valid(mask, b, lk, gen)
        o, lse = attn.flash_attention(q, k, v, kv, causal, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = attn.flash_attention_ref(q.float(), k.float(),
                                                v.float(), kv, causal,
                                                return_lse=True)
        live = ref_lse > attn.NEG_INF / 2
        err = (o.float() - ref).abs().max().item()
        lse_err = ((lse - ref_lse)[live].abs().max().item()
                   if live.any() else 0.0)
        dead_ok = (torch.equal(lse == attn.NEG_INF, ~live)
                   and bool((o[~live] == 0).all()))
        if not (err <= OUT_TOL and lse_err <= LSE_TOL and dead_ok
                and torch.isfinite(o.float()).all()):
            raise AssertionError(
                "flash_fwd disagrees with its plain version at %s %s: "
                "max|o| err %.3g (tol %g), lse err %.3g (tol %g), dead rows "
                "ok %s" % (label, (b, h, lq, lk, d), err, OUT_TOL, lse_err,
                           LSE_TOL, dead_ok))

        pairs = _live_pairs(kv, b, lq, lk, causal)
        n_bytes = 2 * (q.numel() + k.numel() + v.numel() + o.numel()) \
            + (0 if kv is None else 4 * kv.numel())
        n_flops = 4 * h * d * int(pairs.sum().item())
        bound_ms = 1e3 * max(n_bytes / HBM_BYTES_PER_S,
                             n_flops / BF16_FLOP_PER_S)
        # The path calls the kernel without lse and with no copy around it.
        ms = cuda_ms(lambda: attn.flash_attention(q, k, v, kv, causal))
        plain_ms = cuda_ms(lambda: attn.flash_attention_ref(q, k, v, kv,
                                                            causal))
        sdpa_mask = None if (kv is None and not causal) else pairs[:, None]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask))
        rows.append({
            "shape": label, "q": [b, h, lq, d], "kv": [b, h, lk, d],
            "mask": mask, "causal": causal, "dead_rows": int((~live).sum()),
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                         >= n_flops / BF16_FLOP_PER_S else "operations"),
            "bytes": n_bytes, "flops": n_flops})
        emit({"phase": "kernel", "kernel": "flash_fwd", **rows[-1]})
    return rows


# ---------------------------------------------------------------------------
# Phase 6: the backward kernels against their plain version
# ---------------------------------------------------------------------------

# (label, B, H, Lq, Lk, D, mask, causal) — the training path's suffix
# calls (OPT layers 22-31 over [slot 32 | text 32]): reliability (4 rows),
# generality (2 keys x 4) and locality (6 keys x 4); then causal Lq < Lk,
# ragged lengths with a dead row at the ViT's head dim 88, and the
# Q-Former's head dim 64. Then the LLaVA training path's suffix calls
# (Vicuna layers 22-31 over [BOS | slot 576 | text 63], head dim 128),
# reliability, generality and locality; text-only rows (keys 1-576 dead),
# head dim 120 (padded to 128) with a ragged Lk and a dead row, and a
# causal Lq < Lk at head dim 128.
BWD_CASES = [
    ("train_rel", 4, 32, 64, 64, 80, "slot", True),
    ("train_gen", 8, 32, 64, 64, 80, "slot", True),
    ("train_loc", 24, 32, 64, 64, 80, "slot", True),
    ("causal_lq_lt_lk", 4, 32, 16, 200, 80, "prefix", True),
    ("ragged_dead_d88", 3, 5, 77, 131, 88, "random", False),
    ("causal_d64", 4, 12, 70, 70, 64, "prefix", True),
    ("llava_train_rel", 4, 32, 640, 640, 128, "llava_slot", True),
    ("llava_train_gen", 8, 32, 640, 640, 128, "llava_slot", True),
    ("llava_train_loc", 24, 32, 640, 640, 128, "llava_slot", True),
    ("llava_text_only", 4, 32, 640, 640, 128, "llava_text", True),
    ("ragged_dead_d120", 3, 5, 77, 131, 120, "random", False),
    ("causal_lq_lt_lk_d128", 4, 8, 16, 200, 128, "prefix", True),
]


def _bound(n_bytes, n_flops):
    b, f = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOP_PER_S
    return 1e3 * max(b, f), ("bytes" if b >= f else "operations")


def _sdpa_bwd_ms(q, k, v, do, mask):
    """Device ms of the library's attention backward on the same inputs:
    forward + backward minus forward (the port never calls it)."""
    import torch.nn.functional as F

    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        return torch.autograd.grad(o, (qs, ks, vs), do)

    return cuda_ms(fwd_bwd) - cuda_ms(fwd)


def check_bwd_kernels(attn):
    """Every backward case: K2 and K3 against their plain version
    (computed in float32 from the same bf16 values, with the forward
    kernel's o and lse), exact zeros where the contract asks, and the
    timings. Returns one row per case."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    for label, b, h, lq, lk, d, mask, causal in BWD_CASES:
        q, k, v, do = (torch.randn((b, h, n, d), generator=gen, device="cuda",
                                   dtype=torch.bfloat16)
                       for n in (lq, lk, lk, lq))
        kv = _kv_valid(mask, b, lk, gen)
        o, lse = attn.flash_attention(q, k, v, kv, causal, return_lse=True)
        dq, delta = attn.flash_bwd_dq(q, k, v, kv, causal, o, lse, do)
        dk, dv = attn.flash_bwd_dkv(q, k, v, kv, causal, lse, delta, do)
        torch.cuda.synchronize()
        f = [t.float() for t in (q, k, v, o, do)]
        rdq, rdelta = attn.flash_bwd_dq_ref(f[0], f[1], f[2], kv, causal,
                                            f[3], lse, f[4])
        rdk, rdv = attn.flash_bwd_dkv_ref(f[0], f[1], f[2], kv, causal, lse,
                                          rdelta, f[4])
        errs, rel = {}, {}
        for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
            if not torch.isfinite(got.float()).all():
                raise AssertionError("%s not finite at %s" % (name, label))
            errs[name] = (got.float() - ref).abs().max().item()
            rel[name] = errs[name] / max(ref.abs().max().item(), 1e-30)
        delta_err = (delta - rdelta).abs().max().item()
        dead_rows = lse == attn.NEG_INF
        zeros_ok = bool((dq[dead_rows] == 0).all())
        n_masked_keys = 0
        if kv is not None:
            masked = (kv == 0)[:, None, :, None].expand_as(dk)
            n_masked_keys = int((kv == 0).sum()) * h
            zeros_ok = zeros_ok and bool((dk[masked] == 0).all()
                                         and (dv[masked] == 0).all())
        if not (max(rel.values()) <= GRAD_TOL and delta_err <= LSE_TOL
                and zeros_ok):
            raise AssertionError(
                "flash backward disagrees with its plain version at %s %s: "
                "error / max|plain| %s (tol %g), delta err %.3g, exact zeros "
                "%s" % (label, (b, h, lq, lk, d), rel, GRAD_TOL, delta_err,
                        zeros_ok))

        n_pairs = h * int(_live_pairs(kv, b, lq, lk, causal).sum().item())
        e_q, e_k = q.numel(), k.numel()   # elements of q-like, k-like
        n_rows = lse.numel()
        mask_bytes = 0 if kv is None else 4 * kv.numel()
        # K2 reads q, k, v, o, dO, lse and the mask, writes dq and delta;
        # K3 reads q, k, v, dO, lse, delta and the mask, writes dk and dv;
        # the backward as a whole reads q, k, v, o, dO, lse, delta and the
        # mask once and writes dq, dk and dv once. Operations per live
        # pair: 2·D for each of the products it needs (S and dP for both
        # kernels, then dS·K; Pᵀ·dO and dSᵀ·Q).
        dq_bound = _bound(2 * (3 * e_q + 2 * e_k) + 8 * n_rows + mask_bytes,
                          6 * d * n_pairs)
        dkv_bound = _bound(2 * (2 * e_q + 4 * e_k) + 8 * n_rows + mask_bytes,
                           8 * d * n_pairs)
        all_bound = _bound(2 * (4 * e_q + 4 * e_k) + 8 * n_rows + mask_bytes,
                           10 * d * n_pairs)
        dq_ms = cuda_ms(lambda: attn.flash_bwd_dq(q, k, v, kv, causal, o,
                                                  lse, do))
        dkv_ms = cuda_ms(lambda: attn.flash_bwd_dkv(q, k, v, kv, causal, lse,
                                                    delta, do))
        dq_plain = cuda_ms(lambda: attn.flash_bwd_dq_ref(q, k, v, kv, causal,
                                                         o, lse, do))
        dkv_plain = cuda_ms(lambda: attn.flash_bwd_dkv_ref(
            q, k, v, kv, causal, lse, delta, do))
        sdpa_mask = (None if (kv is None and not causal)
                     else _live_pairs(kv, b, lq, lk, causal)[:, None])
        library_ms = _sdpa_bwd_ms(q, k, v, do, sdpa_mask)
        rows.append({
            "shape": label, "q": [b, h, lq, d], "kv": [b, h, lk, d],
            "mask": mask, "causal": causal,
            "dead_rows": int(dead_rows.sum()), "masked_keys": n_masked_keys,
            "max_abs_err": errs, "err_over_max_plain": rel,
            "delta_max_abs_err": delta_err, "exact_zeros": zeros_ok,
            "dq_ms": dq_ms, "dkv_ms": dkv_ms, "dq_plain_ms": dq_plain,
            "dkv_plain_ms": dkv_plain, "library_bwd_ms": library_ms,
            "dq_bound_ms": dq_bound[0], "dq_bound_by": dq_bound[1],
            "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
            "bwd_bound_ms": all_bound[0], "bwd_bound_by": all_bound[1],
            "live_pairs": n_pairs})
        emit({"phase": "kernel_bwd", **rows[-1]})
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def build_cases(n, tmp):
    """Synthetic EVQA records (the JAX package's bench recipe), written
    to ``tmp/vqa_eval.json``; images are path-seeded synthetic pixels."""
    rng = np.random.default_rng(0)
    words = ["cat", "dog", "sky", "tree", "car", "red", "blue", "bird"]

    def ph():
        return str(rng.choice(words))

    records = []
    for i in range(n):
        records.append({
            "src": f"what is the {ph()} near the {ph()} in scene {i}",
            "rephrase": f"which {ph()} is near the {ph()} in scene {i}",
            "pred": ph(), "alt": ph(),
            "image": f"img_{i}.jpg", "image_rephrase": f"img_{i}_re.jpg",
            "loc": f"who wrote the {ph()} about the {ph()}",
            "loc_ans": ph(),
            "m_loc": f"mloc_{i}.jpg",
            "m_loc_q": f"what color is the {ph()}",
            "m_loc_a": ph()})
    path = os.path.join(tmp, "vqa_eval.json")
    with open(path, "w") as f:
        json.dump(records, f)
    return path


def _finite_tree(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite_tree(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite_tree(v) for v in tree)
    if isinstance(tree, float):
        return math.isfinite(tree)
    return True


# Device kernels by family, matched on their names in order: the port's
# kernel, float32 products (the LM head's argmax and LiveEdit's einsums),
# cuBLAS bf16 products, and PyTorch's elementwise and reduction kernels.
KERNEL_FAMILIES = [
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("gemm_f32", ("f32f32", "sgemm")),
    ("gemm_bf16", ("nvjet", "gemm", "cutlass")),
    ("elementwise_reduce", ("elementwise", "reduce_kernel")),
]


def _profile_report(prof, wall_s, out_dir, file_name="profile_kernels.txt"):
    """Device busy share and kernel time by name from a profiler trace;
    every kernel's time goes to ``out_dir/file_name``."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (e - s)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    families = {}
    for name, us in by_name.items():
        fam = next((f for f, keys in KERNEL_FAMILIES if any(
            k in name for k in keys)), "other")
        families[fam] = families.get(fam, 0.0) + us / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, file_name), "w") as f:
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
            f.write("%12.1f us  %s\n" % (us, name))
    return {"wall_s": wall_s, "device_busy_s": busy / 1e6,
            "device_idle_share": 1.0 - busy / 1e6 / wall_s,
            "kernel_s_total": sum(by_name.values()) / 1e6,
            "family_ms": dict(sorted(families.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[n[:80], us / 1e3] for n, us in top]}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_launches():
    from devqa_tpu_torch.ops import attention as attn

    for fn in (attn.flash_attention, attn.flash_bwd_dq, attn.flash_bwd_dkv):
        fn.launches = 0
        fn.launches_by_shape = {}
    attn.multihead_attention.eager_calls = 0


def launches_by_shape(kernel="flash_attention"):
    """A wrapper's launches since the last reset (flash_fwd's by default,
    or ``"flash_bwd_dq"``'s), as [[B, H, Lq, Lk, D, has kv_valid, causal],
    count] pairs, the most launched first."""
    from devqa_tpu_torch.ops import attention as attn

    return sorted(([list(key), n] for key, n in
                   getattr(attn, kernel).launches_by_shape.items()),
                  key=lambda kn: -kn[1])


def read_launches():
    """(flash_fwd, flash_bwd_dq, flash_bwd_dkv) launch counts."""
    from devqa_tpu_torch.ops import attention as attn

    return (attn.flash_attention.launches, attn.flash_bwd_dq.launches,
            attn.flash_bwd_dkv.launches)


def read_eager_calls():
    """Attention calls on the card that multihead_attention sent to the
    plain xla_attention (not bf16, or a head dim the kernels do not take)."""
    from devqa_tpu_torch.ops import attention as attn

    return attn.multihead_attention.eager_calls


def check_no_eager_calls(n, what):
    """Raise unless ``n`` (a read_eager_calls count) is 0: every attention
    call of a driven path on the card goes through the kernels."""
    if n:
        raise AssertionError("%s sent %d attention calls on the card to the "
                             "plain xla_attention" % (what, n))


def init_backbone(cfg, device="cuda"):
    """Random bf16 weights of ``cfg`` from seed 0 → (params, setup line)."""
    from devqa_tpu_torch.core import vllm as V

    t0 = time.time()
    params = V.init_vllm_params(
        cfg, torch.Generator(device=device).manual_seed(0), torch.bfloat16,
        device)
    _sync(device)
    line = {"model": cfg.name, "init_s": time.time() - t0,
            "params": sum(t.numel() for t in _leaves(params)),
            "weights_gb": sum(t.numel() * t.element_size()
                              for t in _leaves(params)) / 1e9}
    return params, line


def drive_main_path(cfg, device="cuda", profile=False, out_dir=None,
                    params=None, path=BLIP2_EVAL):
    """The fused LiveEdit sequential evaluation of ``cfg`` on ``device``
    with ``path``'s settings (the script passes BLIP-2-OPT-2.7b with
    BLIP2_EVAL and LLaVA-1.5-7b with LLAVA_EVAL, on the card; a CPU run at
    a small width rehearses the same code), on ``params`` or a fresh random
    init. Returns (launches, summary, reference)."""
    from devqa_tpu_torch.core.tokenizer import ToyTokenizer
    from devqa_tpu_torch.core.wrapper import TorchVLLM
    from devqa_tpu_torch.data.images import SyntheticImageProvider
    from devqa_tpu_torch.data.schema import EVQA
    from devqa_tpu_torch.editors.liveedit import LiveEdit, LiveEditConfig
    from devqa_tpu_torch.eval.harness import FusedEditorEvaluation
    from devqa_tpu_torch.ops import attention as attn
    from devqa_tpu_torch.retrieval.store import hash_encoder

    on_card = torch.device(device).type == "cuda"
    setup = {}
    if params is None:
        params, setup = init_backbone(cfg, device)
    vllm = TorchVLLM(cfg, params, ToyTokenizer(cfg.decoder.vocab_size),
                     SyntheticImageProvider(cfg.vit.image_size),
                     bucket_multiple=path.bucket_multiple,
                     min_len=path.min_len, img_cache_size=256,
                     img_batch_pad=8)
    if path.liveedit_yaml is None:
        lcfg = LiveEditConfig(edit_model_name=cfg.name, max_edits=1024)
    else:
        lcfg = LiveEditConfig.from_yaml(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), path.liveedit_yaml))
    # At full size these are the file's own values (4096 wide, layer 21);
    # a small CPU rehearsal takes its model's width and depth.
    lcfg = lcfg.replace(llm_mid_dim=cfg.decoder.d_model,
                        edit_layer_i=min(lcfg.edit_layer_i,
                                         cfg.decoder.n_layers - 2),
                        retrieve_top_k=8)
    editor = LiveEdit(vllm, lcfg, seed=0)
    model_name = editor.name_of_editor_and_model()[1]
    emit({"phase": path.phase + "_setup", "model": cfg.name,
          "liveedit": lcfg.to_dict(), **setup})
    n, edit_n = path.cases, path.edit_n

    with tempfile.TemporaryDirectory() as tmp:
        data = EVQA(build_cases(2 * n + 8, tmp), tmp,
                    encoder=hash_encoder(16), device=device)
        cases = data.data
        res_dir = os.path.join(tmp, "res")

        def run(lo, name):
            d = copy.copy(data)
            d.cases = cases[lo:lo + n]
            fe = FusedEditorEvaluation(
                editor, d, evaluation_name=name, results_dir=res_dir,
                max_rows=path.max_rows, pre_rows=path.pre_rows,
                post_rows=path.post_rows)
            # The harness reports its progress on stdout; this script's
            # stdout carries only its JSON lines.
            with contextlib.redirect_stdout(sys.stderr):
                fe.evaluate_sequential_edit(edit_n=edit_n)
            return fe

        t1 = time.time()
        run(0, "warm")
        _sync(device)
        warm_s = time.time() - t1

        vllm.clear_image_cache()
        editor.restore_to_original_model()
        c0 = dict(vllm.counters)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        reset_launches()
        t2 = time.time()
        fe = run(n, "timed")
        _sync(device)
        timed_s = time.time() - t2
        launches = attn.flash_attention.launches
        by_shape = launches_by_shape()
        eager = read_eager_calls()
        if prof is not None:
            prof.__exit__(None, None, None)
        if on_card and launches <= 0:
            raise AssertionError("the main path launched flash_fwd no time")
        check_no_eager_calls(eager, path.phase)
        if read_launches()[1:] != (0, 0):
            raise AssertionError("the evaluation launched a backward kernel")

        seq_dir = os.path.join(res_dir, "liveedit", model_name, "timed",
                               "sequential_edit_%d" % edit_n)
        with open(os.path.join(seq_dir, "mean_results.json")) as f:
            mean = json.load(f)
        with open(os.path.join(seq_dir, "results.json")) as f:
            results = json.load(f)
        total = mean["total_mean"]
        n_metrics = 1 + len(total["generality"]) + len(total["locality"])
        if not (_finite_tree(mean) and _finite_tree(results)
                and total["total_edit_n"] == n
                and len(results) == n // edit_n
                and all(len(r) == edit_n for r in results)
                and n_metrics == 12):
            raise AssertionError("mean_results malformed or not finite: %s"
                                 % json.dumps(mean)[:2000])
        accs = [total["reliability"]["acc"]] + [
            v["acc"] for kind in ("generality", "locality")
            for v in total[kind].values()]
        if not all(0.0 <= a <= 1.0 for a in accs):
            raise AssertionError("accuracy outside [0, 1]: %s" % accs)
        line = {"phase": path.phase, "model": cfg.name, "cases": n,
                "edit_n": edit_n, "warm_s": warm_s, "timed_s": timed_s,
                "cases_per_s": n / timed_s,
                "flash_fwd_launches": launches,
                "flash_fwd_launches_by_shape": by_shape,
                "eager_attention_calls": eager,
                "launches_per_case": launches / n,
                "counters": {k: vllm.counters[k] - c0[k] for k in c0},
                "probe_tokens": fe.probe_tokens,
                "phase_times_s": fe.phase_times,
                "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                if on_card else None),
                "mean_results_written": True,
                "reliability_acc": total["reliability"]["acc"],
                "locality_acc": {k: v["acc"]
                                 for k, v in total["locality"].items()}}
        emit(line)
        if prof is not None:
            emit({"phase": path.name("profile"), **_profile_report(
                prof, timed_s, out_dir,
                "profile_%s.txt" % path.name("kernels"))})
        reference = compare_with_plain_attention(
            vllm, cases[n], on_card, path.name("reference"),
            path.chained_floor_factor)
    return launches, line, reference


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def reference_bounds(out, chained_floor_factor=None):
    """The bound on each gated number of a reference line ``out``: at most
    LOGITS_TOL relative L2 for the vision tokens and the one-batch logits;
    for the chained logits LOGITS_TOL, or with a factor that factor x their
    bf16 noise floor (``logits_rel_l2_plain_vs_float32``)."""
    chained = (LOGITS_TOL if chained_floor_factor is None else
               chained_floor_factor * out["logits_rel_l2_plain_vs_float32"])
    return {"vision_rel_l2": LOGITS_TOL, "decoder_logits_rel_l2": LOGITS_TOL,
            "logits_rel_l2": chained}


def check_bounds(out):
    """Raise unless each number named in ``out["bounds"]`` is within its
    bound."""
    over = {k: [out[k], b] for k, b in out["bounds"].items()
            if not out[k] <= b}
    if over:
        raise AssertionError("kernel path and plain path disagree, "
                             "[value, bound]: %s in %s" % (over, out))


def compare_with_plain_attention(vllm, case, on_card=True,
                                 phase="reference", chained_floor_factor=None):
    """The full model on one case's probes (image and no-image rows), once
    through the kernels and once with every attention call on the plain
    version. Gated (``reference_bounds``): the vision tokens, the decoder's
    logits at live positions from one probe batch (the plain side's, so
    both decoders start from the same embeddings), and the logits of each
    side's own batch, each with its own vision tokens. Beside that chained
    number: its bf16 noise floor, the plain side against the plain side
    with attention in float32 (P unrounded)."""
    from devqa_tpu_torch.core import vllm as V
    from devqa_tpu_torch.core.preprocess import preprocess_images
    from devqa_tpu_torch.eval.harness import case_probe_specs
    from devqa_tpu_torch.ops import attention as attn

    specs = case_probe_specs(case)
    paths = sorted({s.image for s in specs if s.image})[:2]

    def forward():
        with torch.inference_mode():
            pix = torch.stack([torch.from_numpy(vllm.image_provider(p))
                               for p in paths]).to(vllm.device)
            img = V.encode_image(vllm.params, vllm.cfg,
                                 preprocess_images(pix, vllm.cfg.vit.image_size))
            vllm.clear_image_cache()
            qb = vllm.encode_queries([s.prompt for s in specs],
                                     [s.image for s in specs],
                                     [s.target for s in specs])
            logits = V.vllm_logits(vllm.params, vllm.cfg, qb.embeds,
                                   qb.kv_valid)
            return img.float(), qb, logits

    n0, e0 = attn.flash_attention.launches, read_eager_calls()
    img_k, qb_k, logits_k = forward()
    if on_card and attn.flash_attention.launches == n0:
        raise AssertionError("the kernel side of the comparison ran no kernel")
    eager = read_eager_calls() - e0
    with plain_attention():
        img_p, qb_p, logits_p = forward()
    e0 = read_eager_calls()
    with torch.inference_mode():
        logits_kd = V.vllm_logits(vllm.params, vllm.cfg, qb_p.embeds,
                                  qb_p.kv_valid)
    eager += read_eager_calls() - e0
    with plain_attention(float32=True):
        _, _, logits_f = forward()
    live = qb_k.kv_valid.bool()

    out = {"phase": phase, "model": vllm.cfg.name, "rows": len(specs),
           "vision_rel_l2": _rel_l2(img_k, img_p),
           "decoder_logits_rel_l2": _rel_l2(logits_kd[live], logits_p[live]),
           "logits_rel_l2": _rel_l2(logits_k[live], logits_p[live]),
           "logits_rel_l2_plain_vs_float32": _rel_l2(logits_p[live],
                                                     logits_f[live]),
           "argmax_agreement": (logits_k[live].argmax(-1)
                                == logits_p[live].argmax(-1)).float()
           .mean().item(),
           "eager_attention_calls": eager}
    out["bounds"] = reference_bounds(out, chained_floor_factor)
    emit(out)
    check_bounds(out)
    check_no_eager_calls(eager, "the kernel side of " + phase)
    return out


# ---------------------------------------------------------------------------
# Phases 7 and 8: LiveEdit meta-training
# ---------------------------------------------------------------------------

def drive_train_path(cfg, params, device="cuda", steps=TRAIN_STEPS,
                     profile=False, out_dir=None, path=BLIP2_TRAIN):
    """LiveEdit meta-training of ``cfg`` (backbone ``params``, frozen)
    through ``EditorTrainer`` with ``path``'s settings (the script passes
    BLIP-2-OPT-2.7b with BLIP2_TRAIN and LLaVA-1.5-7b with LLAVA_TRAIN; a
    CPU run at a small width rehearses the same code): one warm step, then
    ``steps`` timed steps of ``TRAIN_BATCH`` cases
    ending with the trainer's "Best" flush into a temporary directory
    (traced with ``torch.profiler`` when ``profile``). Returns (summary
    line, editor, one organized batch for the reference phase)."""
    from devqa_tpu_torch.core.tokenizer import ToyTokenizer
    from devqa_tpu_torch.core.wrapper import TorchVLLM
    from devqa_tpu_torch.data.images import SyntheticImageProvider
    from devqa_tpu_torch.data.schema import EVQA
    from devqa_tpu_torch.editors.liveedit import (LiveEditConfig,
                                                  LiveEditTrainable)
    from devqa_tpu_torch.retrieval.store import hash_encoder
    from devqa_tpu_torch.train.loop import CKPT_FILE, EditorTrainer

    on_card = torch.device(device).type == "cuda"
    batch_n = TRAIN_BATCH
    vllm = TorchVLLM(cfg, params, ToyTokenizer(cfg.decoder.vocab_size),
                     SyntheticImageProvider(cfg.vit.image_size),
                     bucket_multiple=path.bucket_multiple,
                     min_len=path.min_len, img_cache_size=256,
                     img_batch_pad=8)
    if path.liveedit_yaml is None:
        lcfg = LiveEditConfig(edit_model_name=cfg.name)
    else:
        lcfg = LiveEditConfig.from_yaml(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), path.liveedit_yaml))
    # At full size the file's (or the defaults') edit layer, 21; a small CPU
    # rehearsal takes its model's width and depth.
    lcfg = lcfg.replace(llm_mid_dim=cfg.decoder.d_model,
                        edit_layer_i=min(lcfg.edit_layer_i,
                                         cfg.decoder.n_layers - 2))
    editor = LiveEditTrainable(vllm, lcfg, seed=0)
    # Layers after the edit residual, each differentiated once per suffix
    # (with faithful_mid_layer_rerun the re-run edit layer acts on the
    # frozen representation, so it needs no gradient either way).
    n_layers = cfg.decoder.n_layers - lcfg.edit_layer_i - 1
    with tempfile.TemporaryDirectory() as tmp:
        data = EVQA(build_cases(batch_n * (steps + 2), tmp), tmp,
                    encoder=hash_encoder(16), device=device)
        cases = data.data
        # Organized before the trainer starts its prefetch thread, whose
        # last batch may still be in flight when training returns: both
        # would draw from the editor's host streams and image cache. The
        # cache and the streams are then set back as they were, so the warm
        # step and the timed steps encode and draw what they would without.
        ref_batch = editor.organize_batch_data(cases[-batch_n:])
        vllm.clear_image_cache()
        editor.reseed_host(0)
        t0 = time.time()
        warm_batch = editor.organize_batch_data(cases[:batch_n])
        warm_loss, _ = editor.train_step(warm_batch)
        _sync(device)
        warm_s = time.time() - t0
        del warm_batch

        trainer = EditorTrainer(editor, data, batch_size=batch_n,
                                records_dir=os.path.join(tmp, "records"),
                                train_name="smoke", random_seed=0,
                                data_buffer_size=2, log_per_i=1,
                                save_ckpt_per_i=10 ** 6)
        step_ms, losses, comps = [], [], []
        inner = editor.train_step

        def timed_step(batch):
            _sync(device)
            t = time.time()
            loss, logs = inner(batch)  # float(): the step has finished
            step_ms.append(1e3 * (time.time() - t))
            losses.append(loss)
            comps.append(logs)
            return loss, logs

        editor.train_step = timed_step
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        reset_launches()
        t1 = time.time()
        trainer.train(total_epochs=1, max_steps=steps)
        _sync(device)
        train_s = time.time() - t1
        launches = read_launches()
        by_shape = launches_by_shape()
        bwd_by_shape = launches_by_shape("flash_bwd_dq")
        eager = read_eager_calls()
        if prof is not None:
            prof.__exit__(None, None, None)
        editor.train_step = inner
        # TensorBoard's writer appends to its event file by path from a
        # thread of its own: close it before the directory goes.
        trainer.logger.close()
        best = os.path.join(trainer.ckpt_dir, "Best")
        best_ok = (os.path.isfile(os.path.join(best, CKPT_FILE))
                   and os.path.isfile(best + ".resume.json"))
        best_mb = (os.path.getsize(os.path.join(best, CKPT_FILE)) / 1e6
                   if best_ok else 0.0)
    per_step = 3 * n_layers  # reliability, generality, locality suffixes
    line = {"phase": path.name("path"), "model": cfg.name,
            "batch_size": batch_n, "rows_per_step": int(
                ref_batch["embeds"].shape[0]),
            "row_tokens": int(ref_batch["embeds"].shape[1]),
            "edit_layer_i": lcfg.edit_layer_i,
            "faithful_mid_layer_rerun": lcfg.faithful_mid_layer_rerun,
            "warm_s": warm_s, "warm_loss": warm_loss, "steps": len(step_ms),
            "step_ms": step_ms,
            "step_ms_median_last_half": float(np.median(
                step_ms[len(step_ms) // 2:])) if step_ms else None,
            "train_s_with_best_flush": train_s,
            "losses": losses, "loss_components": comps,
            "launches": dict(zip(("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"), launches)),
            "flash_fwd_launches_by_shape": by_shape,
            "flash_bwd_launches_by_shape": bwd_by_shape,
            "eager_attention_calls": eager,
            "bwd_launches_per_step_expected": per_step,
            "best_checkpoint": best_ok, "best_checkpoint_mb": best_mb,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if on_card else None)}
    emit(line)
    if prof is not None:
        emit({"phase": path.name("profile"), **_profile_report(
            prof, train_s, out_dir, "profile_%s_kernels.txt" % path.prefix)})
    if not (len(losses) == steps and all(math.isfinite(x) for x in losses)
            and all(_finite_tree(c) for c in comps)):
        raise AssertionError("training loss not finite: %s" % losses)
    if not best_ok:
        raise AssertionError("the trainer wrote no Best checkpoint")
    if on_card and not (launches[1] == launches[2] == per_step * steps
                        and launches[0] >= per_step * steps):
        raise AssertionError("the training steps did not launch the kernels "
                             "%d times each per step: %s" % (per_step,
                                                             launches))
    check_no_eager_calls(eager, path.name("path"))
    return line, editor, ref_batch


@contextlib.contextmanager
def plain_attention(float32=False):
    """Every attention call, forward and backward, on the plain versions
    (the autograd Function stays, so the backward is the plain one). With
    ``float32``, the forward computes in float32 from the same values (P
    not rounded) and rounds only its output to the inputs' dtype."""
    from devqa_tpu_torch.ops import attention as attn

    fwd, bwd = attn.flash_attention, attn.flash_attention_bwd

    def plain_forward(q, k, v, kv_valid=None, causal=False,
                      return_lse=False):
        if (not return_lse and torch.is_grad_enabled()
                and (q.requires_grad or k.requires_grad or v.requires_grad)):
            return attn.FlashAttention.apply(q, k, v, kv_valid, causal)
        if not float32:
            return attn.flash_attention_ref(q, k, v, kv_valid, causal,
                                            return_lse)
        o = attn.flash_attention_ref(q.float(), k.float(), v.float(),
                                     kv_valid, causal, return_lse)
        return (o[0].to(q.dtype), o[1]) if return_lse else o.to(q.dtype)

    attn.flash_attention = plain_forward
    attn.flash_attention_bwd = attn.flash_attention_bwd_ref
    try:
        reset_launches()
        yield
        if read_launches() != (0, 0, 0):
            raise AssertionError("the plain side launched a kernel")
    finally:
        attn.flash_attention, attn.flash_attention_bwd = fwd, bwd


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _grad_diff(grads, grads_ref):
    """Per-leaf relative L2 of ``grads`` from ``grads_ref``; a leaf under
    GRAD_NOISE_FLOOR of the whole gradient's norm is measured against that
    floor → (worst five, leaves below the floor, leaves exactly zero on
    both sides, {leaf: [norm, err]}, the whole norm)."""
    total = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads_ref.values()))
    floor = GRAD_NOISE_FLOOR * total
    worst, below_floor, zero, leaves = {}, [], [], {}
    for path, gp in grads_ref.items():
        name = ".".join(path)
        norm = float(gp.norm())
        err = float((grads[path] - gp).norm())
        if norm == 0.0 and err == 0.0:
            zero.append(name)
        elif norm < floor:
            below_floor.append(name)
        worst[name] = err / max(norm, floor)
        leaves[name] = [norm, err]
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    return top, below_floor, zero, leaves, total


def compare_training_with_plain_attention(editor, batch, on_card=True,
                                          path=BLIP2_TRAIN):
    """Training with the kernels against training with every attention
    call (forward and backward) on the plain versions: the loss and the
    LiveEdit gradients of one evaluation, and the gradient of the suffix's
    label loss with respect to its input (all rows, from the plain side's
    prefix representations), must agree.

    With ``path.shared_prefix`` the loss and gradients also start from the
    plain side's prefix, so the gates hold the kernels over the
    differentiated suffix alone; the chained numbers (each side from its
    own prefix) are reported beside their bf16 noise floor, the plain side
    against the plain side with attention in float32 (P unrounded).
    Without it the chained loss and gradients are gated."""
    from devqa_tpu_torch.core import decoder as dec
    from devqa_tpu_torch.editors.liveedit import (_per_row_label_loss,
                                                  param_leaves)

    def loss_and_grads(reps=None):
        editor._opt.zero_grad(set_to_none=True)
        loss, _ = editor.train_loss(editor.params, batch, reps)
        loss.backward()
        grads = {p: t.grad.detach().float().clone()
                 for p, t in param_leaves(editor.params)}
        editor._opt.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    vcfg = editor.vllm.cfg
    dparams = editor.vllm.params["decoder"]
    lo = editor.cfg.edit_layer_i + 1
    kv = batch["kv_valid"]

    def suffix_input_grad(reps):
        h = reps.detach().clone().requires_grad_(True)
        logits = dec.decoder_logits(dparams, vcfg.decoder, dec.decoder_forward(
            dparams, vcfg.decoder, h, kv, lo=lo))
        _per_row_label_loss(logits, batch["label_ids"],
                            batch["label_masks"]).backward()
        return h.grad.float()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with plain_attention():
        reps_p = editor.prefix_reps(batch)
        loss_p, grads_p = loss_and_grads(reps_p)
        dh_p = suffix_input_grad(reps_p)
    reset_launches()
    loss_k, grads_k = loss_and_grads(reps_p if path.shared_prefix else None)
    dh_k = suffix_input_grad(reps_p)
    kernel_launches = read_launches()
    eager = read_eager_calls()
    if on_card and min(kernel_launches) <= 0:
        raise AssertionError("the kernel side of the training comparison "
                             "launched %s" % (kernel_launches,))

    top, below_floor, zero, leaves, total = _grad_diff(grads_k, grads_p)
    out = {"phase": path.name("reference"),
           "shared_prefix": path.shared_prefix, "loss_kernels": loss_k,
           "loss_plain": loss_p,
           "loss_rel_diff": abs(loss_k - loss_p) / max(abs(loss_p), 1e-30),
           "suffix_input_grad_rel_l2": _rel_l2(dh_k, dh_p),
           "suffix_input_grad_norm": float(dh_p.norm()),
           "grad_leaves": len(leaves), "grad_norm_plain": total,
           "grad_rel_l2_max": top[0][1], "grad_rel_l2_top": top,
           "leaves_below_noise_floor": below_floor,
           "leaves_with_zero_gradient": zero,
           "leaf_norm_plain_and_err": leaves,
           "kernel_launches": dict(zip(("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv"), kernel_launches)),
           "eager_attention_calls": eager,
           "tolerance_loss_rel": LOSS_RTOL,
           "tolerance_grad_rel_l2": TRAIN_GRAD_TOL}
    if path.shared_prefix:
        # Chained: the kernels from their own prefix; the floor: float32
        # attention from its own prefix; each against the plain side.
        loss_c, grads_c = loss_and_grads()
        dh_c = suffix_input_grad(editor.prefix_reps(batch))
        out["eager_attention_calls"] = read_eager_calls()
        with plain_attention(float32=True):
            loss_f, grads_f = loss_and_grads()
            dh_f = suffix_input_grad(editor.prefix_reps(batch))
        out["chained"] = {
            "loss_rel_diff": abs(loss_c - loss_p) / max(abs(loss_p), 1e-30),
            "grad_rel_l2_max": _grad_diff(grads_c, grads_p)[0][0][1],
            "suffix_input_grad_rel_l2": _rel_l2(dh_c, dh_p)}
        out["chained_plain_vs_float32"] = {
            "loss_rel_diff": abs(loss_f - loss_p) / max(abs(loss_p), 1e-30),
            "grad_rel_l2_max": _grad_diff(grads_f, grads_p)[0][0][1],
            "suffix_input_grad_rel_l2": _rel_l2(dh_f, dh_p)}
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None)
    emit(out)
    if not (out["loss_rel_diff"] <= LOSS_RTOL
            and out["grad_rel_l2_max"] <= TRAIN_GRAD_TOL
            and out["suffix_input_grad_rel_l2"] <= TRAIN_GRAD_TOL
            and out["suffix_input_grad_norm"] > 0
            and math.isfinite(loss_k) and math.isfinite(total)):
        raise AssertionError("training with the kernels and with plain "
                             "attention disagree: %s" % out)
    check_no_eager_calls(out["eager_attention_calls"],
                         "the kernel side of " + out["phase"])
    return out


def _ptxas_summary(log: str) -> dict:
    """Registers, spilled bytes and static shared memory of every compiled
    instantiation, from nvcc's ``-Xptxas -v`` output."""
    fns, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = re.search(r"\d+([a-z_]+kernel)I((?:L[a-z]\d+E)+)E",
                             m.group(1))
            cur = {"function": ("%s<%s>" % (name.group(1), ",".join(
                re.findall(r"L[a-z](\d+)E", name.group(2)))) if name
                else m.group(1)), "registers": 0, "spill_bytes": 0,
                "smem_static_bytes": 0}
            fns.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_static_bytes"] = int(sm.group(1)) if sm else 0
    return {"instantiations": len(fns),
            "max_registers": max((f["registers"] for f in fns), default=0),
            "spill_bytes": sum(f["spill_bytes"] for f in fns),
            "by_function": fns}


def flash_fwd_resources(attn):
    """What the CUDA runtime reports for each flash_fwd instantiation on
    this card: registers and spilled (local) bytes a thread, dynamic shared
    memory a block and resident blocks per SM, for one key tile (Lk 64)
    and for several (Lk 65: a two-stage ring)."""
    import ctypes

    lib = attn._kernel_lib("flash_fwd")
    fn = lib.devqa_flash_fwd_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    rows = []
    for d in (64, 80, 88, 128):
        for has_mask in (0, 1):
            for causal in (0, 1):
                for lk in (64, 65):
                    out = (ctypes.c_int * 4)()
                    attn._raise_on(fn(d, has_mask, causal, lk, out), lib,
                                   "flash_fwd_info")
                    rows.append({"d": d, "mask": has_mask, "causal": causal,
                                 "stages": 1 if lk <= 64 else 2,
                                 "registers": out[0], "local_bytes": out[1],
                                 "smem_bytes": out[2],
                                 "blocks_per_sm": out[3]})
    return rows


def join_launches(rows, by_path):
    """Put each case row's launches on each path of ``by_path`` (path name
    → launches by shape, counted in the run) into the row, and for each
    time of the row (``ms`` for flash_fwd, ``dq_ms`` and ``dkv_ms`` for the
    backward) launches x that time and launches x (time - its bound);
    returns the launched shapes no row matches. Rows of one key (shape,
    masked or not, causal or not) share it: the first takes the launches."""
    def key(r):
        b, h, lq, d = r["q"]
        return (b, h, lq, r["kv"][2], d, r["mask"] is not None, r["causal"])

    counts = {}
    for path, by_shape in by_path.items():
        for k, n in by_shape:
            row = counts.setdefault(tuple(k), dict.fromkeys(by_path, 0))
            row[path] = n
    for r in rows:
        r["launches"] = counts.pop(key(r), dict.fromkeys(by_path, 0))
        n = r["launches_total"] = sum(r["launches"].values())
        for t in ("", "dq_", "dkv_"):
            if t + "ms" in r:
                r["launches_x_%sms" % t] = n * r[t + "ms"]
                r["launches_x_excess_%sms" % t] = n * (r[t + "ms"]
                                                       - r[t + "bound_ms"])
    return [{"shape": list(k), **v} for k, v in counts.items()]


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the timed split and the timed training "
                    "steps with torch.profiler")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phases (build, kernel, "
                    "kernel_bwd), without the paths and without the last "
                    "two lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "devqa_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "devqa_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)

    import devqa_tpu_torch  # noqa: F401  (sets the numerics flags)
    from devqa_tpu_torch.ops import attention as attn
    from devqa_tpu_torch.ops import build

    smi = nvidia_smi_line()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit({"phase": "device", "nvidia_smi": smi, **device,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.time()
    build.build(build.KERNELS)
    build_s = time.time() - t0
    emit({"phase": "build", "kernels": list(build.KERNELS),
          "seconds": build_s,
          "ptxas": {n: _ptxas_summary(log["log"])
                    for n, log in build.BUILD_LOG.items()},
          "flash_fwd_resources": flash_fwd_resources(attn)})

    rows = check_flash_kernel(attn)
    bwd_rows = check_bwd_kernels(attn)
    if args.kernels_only:
        return 0

    out_dir = os.path.join(repo, "build")
    from devqa_tpu_torch.core.vllm import (blip2_opt_2_7b_config,
                                           llava_v15_7b_config)

    cfg = blip2_opt_2_7b_config()
    params, setup = init_backbone(cfg)
    emit({"phase": "backbone", **setup})
    launches, eval_line, _ = drive_main_path(cfg, "cuda", args.profile,
                                             out_dir, params=params)
    train, editor, ref_batch = drive_train_path(cfg, params,
                                                profile=args.profile,
                                                out_dir=out_dir)
    compare_training_with_plain_attention(editor, ref_batch)

    # LLaVA-1.5-7b at full width and depth, with the BLIP-2 backbone freed
    # first: its peak memory is its own.
    del params, editor, ref_batch
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    llava_cfg = llava_v15_7b_config()
    llava_params, llava_setup = init_backbone(llava_cfg)
    emit({"phase": "llava_backbone", "held_before_gb": held_gb,
          **llava_setup})
    llava_launches, llava_line, _ = drive_main_path(
        llava_cfg, "cuda", args.profile, out_dir, params=llava_params,
        path=LLAVA_EVAL)
    gc.collect()
    torch.cuda.empty_cache()
    llava_train, llava_editor, llava_batch = drive_train_path(
        llava_cfg, llava_params, profile=args.profile, out_dir=out_dir,
        path=LLAVA_TRAIN)
    compare_training_with_plain_attention(llava_editor, llava_batch,
                                          path=LLAVA_TRAIN)
    del llava_params, llava_editor, llava_batch

    # Each kernel's line headlines the shape with the largest launches x ms
    # over the paths; every shape, with its launches, is under "shapes".
    fwd_paths = {"fused_eval": eval_line["flash_fwd_launches_by_shape"],
                 "train": train["flash_fwd_launches_by_shape"],
                 "llava_eval": llava_line["flash_fwd_launches_by_shape"],
                 "llava_train": llava_train["flash_fwd_launches_by_shape"]}
    unlisted = join_launches(rows, fwd_paths)
    bwd_unlisted = join_launches(bwd_rows, {
        "train": train["flash_bwd_launches_by_shape"],
        "llava_train": llava_train["flash_bwd_launches_by_shape"]})
    top = max(rows, key=lambda r: r["launches_x_ms"])
    emit({"phase": "kernel_ranking", "kernel": "flash_fwd",
          "by_launches_x_excess_ms": [
              [r["shape"], r["launches_total"], r["launches_x_excess_ms"]]
              for r in sorted(rows, key=lambda r: -r["launches_x_excess_ms"])],
          "launched_shapes_not_in_kernel_cases": unlisted,
          "bwd_launched_shapes_not_in_bwd_cases": bwd_unlisted})
    bwd_source = "devqa_tpu_torch/ops/csrc/flash_bwd.cu"
    library_covers = ("dq, dk and dv: scaled_dot_product_attention forward "
                      "+ backward minus forward")

    def bwd_line(name, kernel, grads, replaces):
        t = kernel + "_"
        btop = max(bwd_rows, key=lambda r: r["launches_x_%sms" % t])
        by_path = {"train": train["launches"][name],
                   "llava_train": llava_train["launches"][name]}
        return {
            "name": name, "route": "cuda", "source": bwd_source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_at_shape": btop["launches"],
            "max_abs_err": max(r["max_abs_err"][g] for r in bwd_rows
                               for g in grads),
            "max_err_over_max_plain": max(
                r["err_over_max_plain"][g] for r in bwd_rows for g in grads),
            "ms": btop[t + "ms"], "plain_ms": btop[t + "plain_ms"],
            "bound_ms": btop[t + "bound_ms"],
            "bound_by": btop[t + "bound_by"],
            "library_ms": btop["library_bwd_ms"],
            "library_covers": library_covers, "shape": btop["shape"],
            "shapes": [{k: r[k] for k in (
                "shape", "q", "kv", "launches", t + "ms", t + "plain_ms",
                t + "bound_ms", "library_bwd_ms", "bwd_bound_ms")}
                for r in bwd_rows]}

    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "devqa_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "devqa_tpu/ops/attention.py:106",
         "launches": (launches + llava_launches
                      + train["launches"]["flash_fwd"]
                      + llava_train["launches"]["flash_fwd"]),
         "launches_by_path": {"fused_eval": launches,
                              "train": train["launches"]["flash_fwd"],
                              "llava_eval": llava_launches,
                              "llava_train":
                                  llava_train["launches"]["flash_fwd"]},
         "launches_at_shape": top["launches"],
         "max_abs_err": max(r["max_abs_err"] for r in rows),
         "ms": top["ms"], "plain_ms": top["plain_ms"],
         "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
         "library_ms": top["library_ms"],
         "shape": top["shape"], "shapes": rows},
        bwd_line("flash_bwd_dq", "dq", ("dq",),
                 "devqa_tpu/ops/attention.py:615"),
        bwd_line("flash_bwd_dkv", "dkv", ("dk", "dv"),
                 "devqa_tpu/ops/attention.py:662")]})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
