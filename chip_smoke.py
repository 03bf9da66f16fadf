#!/usr/bin/env python3
"""Drive the PyTorch port (``devqa_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line on stdout:

1. device — the card (``nvidia-smi`` name and power limit, torch's name);
2. build — compile every hand-written kernel of the path from
   ``devqa_tpu_torch/ops/csrc`` with nvcc for sm_90a;
3. kernel — call each kernel's wrapper on the card at every shape the
   main path gives it and hold it against its plain PyTorch version;
   time the kernel, the plain version and one library call;
4. main path — BLIP-2-OPT-2.7b at full width (random bf16 weights from a
   seed) under LiveEdit (1024-slot pools, top-8 routing, edit layer 21),
   scored by the fused sequential evaluation on synthetic EVQA cases: one
   warm split of 10 cases and one timed split of 10; the kernels' launch
   counts are set to 0 just before the timed split and read just after;
5. reference — the same model with every attention call on the plain
   version, on a few probes: the logits must agree.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero without that last line; so does a host without a CUDA device.
``--profile`` also traces the timed split with ``torch.profiler``, prints
its device busy share and device time by kernel family (a report, not a
check) and writes every kernel's time to ``build/profile_kernels.txt``.
"""
import argparse
import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (dense): the bound of a kernel is the
# larger of bytes / memory rate and operations / bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

OUT_TOL = 2e-2    # output max-abs: bf16 rounding of P and of the output
LSE_TOL = 1e-3    # lse max-abs on live rows: f32 sums in another order
LOGITS_TOL = 5e-2  # relative L2 of end-to-end logits, kernel vs plain

SPLIT = 10        # cases per sequential-edit split (edit_n)


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
# pass (120 rows), the pre pass (90) and the edit batch (10); then a causal
# call with Lq < Lk and a ragged one with a dead row.
KERNEL_CASES = [
    ("vit", 8, 16, 257, 257, 88, None, False),
    ("qformer_self", 8, 12, 32, 32, 64, None, False),
    ("qformer_cross", 8, 12, 32, 257, 64, None, False),
    ("opt_post", 120, 32, 64, 64, 80, "slot", True),
    ("opt_pre", 90, 32, 64, 64, 80, "slot", True),
    ("opt_edit", 10, 32, 64, 64, 80, "slot", True),
    ("causal_lq_lt_lk", 4, 32, 16, 200, 80, "prefix", True),
    ("ragged", 3, 5, 77, 131, 88, "random", False),
]


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
    if kind == "prefix":
        lens = torch.randint(1, lk + 1, (b,), generator=gen, device=dev)
        return (torch.arange(lk, device=dev)[None, :]
                < lens[:, None]).to(torch.int32)
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
    ("gemm_f32", ("f32f32", "sgemm")),
    ("gemm_bf16", ("nvjet", "gemm", "cutlass")),
    ("elementwise_reduce", ("elementwise", "reduce_kernel")),
]


def _profile_report(prof, wall_s, out_dir):
    """Device busy share and kernel time by name from a profiler trace."""
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
    with open(os.path.join(out_dir, "profile_kernels.txt"), "w") as f:
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


def drive_main_path(cfg, device="cuda", profile=False, out_dir=None):
    """The fused LiveEdit sequential evaluation of ``cfg`` on ``device``
    (the script passes BLIP-2-OPT-2.7b and the card; a CPU run at a small
    width rehearses the same code). Returns (launches, summary, reference)."""
    from devqa_tpu_torch.core import vllm as V
    from devqa_tpu_torch.core.tokenizer import ToyTokenizer
    from devqa_tpu_torch.core.wrapper import TorchVLLM
    from devqa_tpu_torch.data.images import SyntheticImageProvider
    from devqa_tpu_torch.data.schema import EVQA
    from devqa_tpu_torch.editors.liveedit import LiveEdit, LiveEditConfig
    from devqa_tpu_torch.eval.harness import FusedEditorEvaluation
    from devqa_tpu_torch.ops import attention as attn
    from devqa_tpu_torch.retrieval.store import hash_encoder

    on_card = torch.device(device).type == "cuda"
    t0 = time.time()
    params = V.init_vllm_params(
        cfg, torch.Generator(device=device).manual_seed(0), torch.bfloat16,
        device)
    _sync(device)
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    vllm = TorchVLLM(cfg, params, ToyTokenizer(cfg.decoder.vocab_size),
                     SyntheticImageProvider(cfg.vit.image_size),
                     bucket_multiple=32, min_len=32, img_cache_size=256,
                     img_batch_pad=8)
    lcfg = LiveEditConfig(edit_model_name=cfg.name,
                          llm_mid_dim=cfg.decoder.d_model,
                          edit_layer_i=min(21, cfg.decoder.n_layers - 2),
                          max_edits=1024, retrieve_top_k=8)
    editor = LiveEdit(vllm, lcfg, seed=0)
    emit({"phase": "main_path_setup", "model": cfg.name,
          "params": n_params, "init_s": init_s,
          "weights_gb": sum(t.numel() * t.element_size()
                            for t in _leaves(params)) / 1e9})

    with tempfile.TemporaryDirectory() as tmp:
        data = EVQA(build_cases(2 * SPLIT + 8, tmp), tmp,
                    encoder=hash_encoder(16), device=device)
        cases = data.data
        res_dir = os.path.join(tmp, "res")

        def run(lo, name):
            d = copy.copy(data)
            d.cases = cases[lo:lo + SPLIT]
            fe = FusedEditorEvaluation(
                editor, d, evaluation_name=name, results_dir=res_dir,
                max_rows=60, pre_rows=90, post_rows=120)
            # The harness reports its progress on stdout; this script's
            # stdout carries only its JSON lines.
            with contextlib.redirect_stdout(sys.stderr):
                fe.evaluate_sequential_edit(edit_n=SPLIT)
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
        attn.flash_attention.launches = 0
        t2 = time.time()
        fe = run(SPLIT, "timed")
        _sync(device)
        timed_s = time.time() - t2
        launches = attn.flash_attention.launches
        if prof is not None:
            prof.__exit__(None, None, None)
        if on_card and launches <= 0:
            raise AssertionError("the main path launched flash_fwd no time")

        seq_dir = os.path.join(res_dir, "liveedit", cfg.name, "timed",
                               "sequential_edit_%d" % SPLIT)
        with open(os.path.join(seq_dir, "mean_results.json")) as f:
            mean = json.load(f)
        with open(os.path.join(seq_dir, "results.json")) as f:
            results = json.load(f)
        total = mean["total_mean"]
        n_metrics = 1 + len(total["generality"]) + len(total["locality"])
        if not (_finite_tree(mean) and _finite_tree(results)
                and total["total_edit_n"] == SPLIT
                and len(results) == 1 and len(results[0]) == SPLIT
                and n_metrics == 12):
            raise AssertionError("mean_results malformed or not finite: %s"
                                 % json.dumps(mean)[:2000])
        accs = [total["reliability"]["acc"]] + [
            v["acc"] for kind in ("generality", "locality")
            for v in total[kind].values()]
        if not all(0.0 <= a <= 1.0 for a in accs):
            raise AssertionError("accuracy outside [0, 1]: %s" % accs)
        line = {"phase": "main_path", "cases": SPLIT, "edit_n": SPLIT,
                "warm_s": warm_s, "timed_s": timed_s,
                "cases_per_s": SPLIT / timed_s,
                "flash_fwd_launches": launches,
                "launches_per_case": launches / SPLIT,
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
            emit({"phase": "profile", **_profile_report(prof, timed_s,
                                                        out_dir)})
        reference = compare_with_plain_attention(vllm, cases[SPLIT],
                                                 on_card)
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


def compare_with_plain_attention(vllm, case, on_card=True):
    """The full model on one case's probes (image and no-image rows), once
    through the kernel and once with every attention call on the plain
    version: vision tokens and logits at live positions must agree."""
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
            return img.float(), logits, qb.kv_valid.bool()

    n0 = attn.flash_attention.launches
    img_k, logits_k, live = forward()
    if on_card and attn.flash_attention.launches == n0:
        raise AssertionError("the kernel side of the comparison ran no kernel")
    kernel = attn.flash_attention
    attn.flash_attention = (lambda q, k, v, kv_valid=None, causal=False:
                            attn.flash_attention_ref(q, k, v, kv_valid, causal))
    try:
        img_p, logits_p, _ = forward()
    finally:
        attn.flash_attention = kernel

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    out = {"phase": "reference", "rows": len(specs),
           "vision_rel_l2": rel(img_k, img_p),
           "logits_rel_l2": rel(logits_k[live], logits_p[live]),
           "argmax_agreement": (logits_k[live].argmax(-1)
                                == logits_p[live].argmax(-1)).float()
           .mean().item(),
           "tolerance_rel_l2": LOGITS_TOL}
    emit(out)
    if not (out["vision_rel_l2"] <= LOGITS_TOL
            and out["logits_rel_l2"] <= LOGITS_TOL):
        raise AssertionError("kernel path and plain path disagree: %s" % out)
    return out


def _ptxas_summary(log: str) -> dict:
    """Registers per compiled instantiation and spilled bytes, from nvcc's
    ``-Xptxas -v`` output."""
    regs, spills = [], 0
    for ln in log.splitlines():
        words = ln.replace(",", " ").split()
        for w, nxt, nxt2 in zip(words, words[1:], words[2:] + [""]):
            if nxt.startswith("registers") and w.isdigit():
                regs.append(int(w))
            elif nxt == "bytes" and nxt2 == "spill" and w.isdigit():
                spills += int(w)
    return {"instantiations": len(regs), "max_registers": max(regs, default=0),
            "spill_bytes": spills}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the timed split with torch.profiler")
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
                    for n, log in build.BUILD_LOG.items()}})

    rows = check_flash_kernel(attn)

    out_dir = os.path.join(repo, "build")
    from devqa_tpu_torch.core.vllm import blip2_opt_2_7b_config

    launches, _, _ = drive_main_path(blip2_opt_2_7b_config(), "cuda",
                                     args.profile, out_dir)

    # The kernel's line: its numbers at the decoder's post-pass shape, the
    # one the main path launches most; every shape is under "shapes".
    top = next(r for r in rows if r["shape"] == "opt_post")
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "devqa_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "devqa_tpu/ops/attention.py:106",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": top["shape"], "shapes": rows}]})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
