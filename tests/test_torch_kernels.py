"""The flash-attention wrappers' dispatch, and on a CUDA card the forward
kernel (K1) and the backward kernels (K2 dq, K3 dk/dv) against their plain
versions. Imports no JAX, so it runs on the machine with the card too:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets up JAX.) Here, without a
card, the CUDA cases skip.
"""
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from devqa_tpu_torch.ops import attention as ta
from devqa_tpu_torch.ops import build


def _inputs(b, h, lq, lk, d, mask, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, d))
                                .astype(np.float32)) for n in (lq, lk, lk))
    if mask == "none":
        kv = None
    elif mask == "prefix":
        lens = rng.integers(1, lk + 1, size=b)
        kv = np.arange(lk)[None, :] < lens[:, None]
    elif mask == "nonprefix":
        kv = rng.random((b, lk)) < 0.6
        kv[:, -1] = True
    elif mask == "deadrow":  # batch row 0 has no live key at all
        kv = rng.random((b, lk)) < 0.6
        kv[0] = False
    elif mask == "slot":  # a 32-key vision slot live on even rows, text a prefix
        lens = rng.integers(8, lk - 32 + 1, size=b)
        kv = np.concatenate([np.repeat((np.arange(b) % 2 == 0)[:, None], 32, 1),
                             np.arange(lk - 32)[None, :] < lens[:, None]], 1)
    elif mask == "llava":  # [BOS | 576-key slot | text]: slot on even rows
        lens = rng.integers(8, lk - 577 + 1, size=b)
        slot = np.repeat((np.arange(b) % 2 == 0)[:, None], 576, 1)
        kv = np.concatenate([np.ones((b, 1), dtype=bool), slot,
                             np.arange(lk - 577)[None, :] < lens[:, None]], 1)
    elif mask == "llava_text":  # text-only LLaVA rows: keys 1-576 dead
        lens = rng.integers(8, lk - 577 + 1, size=b)
        kv = np.concatenate([np.ones((b, 1), dtype=bool),
                             np.zeros((b, 576), dtype=bool),
                             np.arange(lk - 577)[None, :] < lens[:, None]], 1)
    elif mask == "hole":  # keys 64-127, a whole key tile, dead between live
        kv = np.ones((b, lk), dtype=bool)
        kv[:, 64:128] = False
    else:
        raise ValueError(mask)
    kv = None if kv is None else torch.from_numpy(kv.astype(np.int32))
    return q, k, v, kv


def test_flash_attention_cpu_takes_plain_version():
    q, k, v, kv = _inputs(2, 2, 6, 6, 8, "nonprefix")
    ta.flash_attention.launches = 0
    out, lse = ta.flash_attention(q, k, v, kv, causal=True, return_lse=True)
    ref, ref_lse = ta.flash_attention_ref(q, k, v, kv, causal=True,
                                          return_lse=True)
    assert ta.flash_attention.launches == 0
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_multihead_attention_cpu_is_xla_path():
    q, k, v, _ = _inputs(2, 2, 7, 7, 8, "none")
    lengths = torch.tensor([4, 7])
    e0 = ta.multihead_attention.eager_calls
    out = ta.multihead_attention(q, k, v, causal=True, lengths=lengths)
    kv = (torch.arange(7)[None, :] < lengths[:, None]).to(torch.int32)
    assert torch.equal(out, ta.xla_attention(q, k, v, kv, causal=True))
    # Only calls on the card are counted as routed away from the kernels.
    assert ta.multihead_attention.eager_calls == e0


def test_kernel_path_refuses_gradients_and_other_devices(monkeypatch):
    """Off the CPU the wrapper goes to the kernels: a tensor that needs a
    gradient reaches the autograd Function (whose backward launches K2 and
    K3), and a tensor on neither the CPU nor a card is refused before
    anything launches, with or without a gradient."""
    q = torch.empty((1, 1, 8, 64), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    seen = []
    with monkeypatch.context() as m:
        m.setattr(ta.FlashAttention, "apply",
                  lambda *args: seen.append(args) or "function")
        assert ta.flash_attention(q, q.detach(), q.detach()) == "function"
    assert len(seen) == 1 and seen[0][0] is q
    with pytest.raises(ValueError, match="CUDA"):
        ta.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(ValueError, match="CUDA"):
        ta.flash_attention(q.detach(), q.detach(), q.detach())
    lse = torch.empty((1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ta.flash_attention_bwd(q, q, q, None, True, q, lse, q)


def test_backward_wrappers_cpu_take_plain_versions():
    q, k, v, kv = _inputs(2, 2, 6, 9, 8, "deadrow")
    o, lse = ta.flash_attention_ref(q, k, v, kv, causal=True, return_lse=True)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    n0 = (ta.flash_bwd_dq.launches, ta.flash_bwd_dkv.launches)
    dq, dk, dv = ta.flash_attention_bwd(q, k, v, kv, True, o, lse, do)
    assert (ta.flash_bwd_dq.launches, ta.flash_bwd_dkv.launches) == n0
    ref = ta.flash_attention_bwd_ref(q, k, v, kv, True, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), ref))
    # masked keys get exactly zero gradient; dead rows exactly zero dq
    assert torch.all(dk[kv[:, None, :].expand(-1, 2, -1) == 0] == 0)
    assert torch.all(dq[lse == ta.NEG_INF] == 0)


@pytest.mark.parametrize("shape,dtype,kv_dtype,match", [
    ((2, 2, 8, 88), torch.float32, torch.int32, "bfloat16"),
    ((2, 2, 8, 36), torch.bfloat16, torch.int32, "head dim"),
    ((2, 2, 8, 144), torch.bfloat16, torch.int32, "head dim"),
    ((2, 2, 8, 80), torch.bfloat16, torch.int64, "int32"),
])
def test_kernel_layout_refusals(shape, dtype, kv_dtype, match):
    q = torch.zeros(shape, dtype=dtype)
    kv = torch.ones((shape[0], shape[2]), dtype=kv_dtype)
    with pytest.raises((TypeError, ValueError), match=match):
        ta.check_kernel_layout(q, q, q, kv)


@pytest.mark.parametrize("d", [120, 128])
def test_head_dim_128_is_forward_only(d, monkeypatch):
    """Head dims padding to 128 (LLaVA's Vicuna) are no longer forward
    only: they are taken by the forward check and by the backward check,
    and an input at that head dim that needs a gradient reaches the
    autograd Function (on a tensor off the card it is then refused for
    its device, not for its head dim, before anything launches); head dim
    144 is refused by both checks."""
    q = torch.zeros((2, 2, 8, d), dtype=torch.bfloat16)
    kv = torch.ones((2, 8), dtype=torch.int32)
    lse = torch.zeros((2, 2, 8))
    ta.check_kernel_layout(q, q, q, kv)
    ta.check_bwd_layout(q, q, q, kv, lse, q, q)
    wide = torch.zeros((2, 2, 8, 144), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 144"):
        ta.check_kernel_layout(wide, wide, wide, kv)
    with pytest.raises(ValueError, match="head dim 144"):
        ta.check_bwd_layout(wide, wide, wide, kv, lse, wide, wide)
    g = torch.zeros((1, 1, 8, d), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    reached = []
    forward = ta.FlashAttention.forward
    monkeypatch.setattr(ta.FlashAttention, "forward", staticmethod(
        lambda *a: reached.append(a[1].shape) or forward(*a)))
    n0 = ta.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        ta.flash_attention(g, g.detach(), g.detach())
    assert reached == [g.shape] and ta.flash_attention.launches == n0


@pytest.mark.parametrize("d,dtype,kernel", [
    (64, torch.bfloat16, True), (80, torch.bfloat16, True),
    (88, torch.bfloat16, True), (96, torch.bfloat16, True),
    (120, torch.bfloat16, True), (128, torch.bfloat16, True),
    (64, torch.float32, False), (128, torch.float32, False),
    (32, torch.bfloat16, False), (104, torch.bfloat16, False),
    (256, torch.bfloat16, False), (36, torch.bfloat16, False),
])
def test_kernel_route(d, dtype, kernel):
    """multihead_attention's route on the card: bf16 at a head dim padding
    to 64/80/96/128 goes to the kernels (forward and backward alike), any
    other dtype or head dim to xla_attention."""
    q = torch.zeros((1, 2, 4, d), dtype=dtype)
    assert ta.kernel_takes(q, q, q) is kernel


def test_kernel_layout_refuses_a_strided_view():
    q = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ta.check_kernel_layout(q, q, q)
    ta.check_kernel_layout(*(q.contiguous(),) * 3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,d,mask,causal", [
    (2, 3, 70, 70, 88, "nonprefix", True),
    (2, 2, 33, 130, 80, "deadrow", False),
    (1, 2, 40, 97, 64, "prefix", True),
    (3, 2, 24, 9, 80, "none", True),     # Lq > Lk: early rows see no key
    (2, 4, 257, 257, 88, "none", False),
    # the load ring wraps several times
    (2, 4, 64, 1000, 88, "none", False),
    (1, 2, 128, 1000, 80, "prefix", True),
    (2, 4, 70, 192, 80, "hole", False),  # a whole key tile masked
    (3, 4, 1, 257, 80, "prefix", True),  # Lq = 1
    (3, 4, 40, 1, 88, "none", True),     # Lk = 1: only the last row sees it
    (2, 2, 1, 1, 64, "none", False),
    (300, 32, 64, 64, 80, "slot", True),  # many blocks per SM
    # one key tile at each head dim
    (8, 12, 64, 64, 64, "deadrow", True),
    (8, 12, 64, 64, 80, "deadrow", True),
    (8, 12, 64, 64, 88, "deadrow", True),
    # head dims 120 and 128 (LLaVA's Vicuna: DP 128)
    (8, 12, 64, 64, 128, "deadrow", True),
    (2, 3, 70, 70, 120, "nonprefix", True),
    (2, 2, 33, 130, 128, "deadrow", False),
    (1, 2, 40, 97, 120, "prefix", True),
    (3, 4, 1, 257, 128, "prefix", True),     # Lq = 1
    (3, 4, 40, 1, 128, "none", True),        # Lk = 1
    (2, 4, 64, 1000, 128, "none", False),    # the load ring wraps
    (4, 8, 640, 640, 128, "llava", True),    # LLaVA's rows, slot after BOS
])
def test_kernel_matches_plain_version(cuda_device, b, h, lq, lk, d, mask,
                                      causal):
    """bf16 inputs; the plain version in float32 from the same values.
    Output within 2e-2 (bf16 rounding of P and of O), lse within 1e-3 on
    live rows, dead rows exact zeros with lse = -1e30."""
    q, k, v, kv = _inputs(b, h, lq, lk, d, mask)
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    kv = None if kv is None else kv.to(cuda_device)
    n0 = ta.flash_attention.launches
    o, lse = ta.flash_attention(q, k, v, kv, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert ta.flash_attention.launches == n0 + 1
    ref, ref_lse = ta.flash_attention_ref(q.float(), k.float(), v.float(), kv,
                                          causal=causal, return_lse=True)
    live = ref_lse > ta.NEG_INF / 2
    assert (o.float() - ref).abs().max().item() <= 2e-2
    if live.any():
        assert (lse - ref_lse)[live].abs().max().item() <= 1e-3
    assert torch.equal(lse == ta.NEG_INF, ~live)
    assert torch.all(o[~live] == 0)
    o2 = ta.flash_attention(q, k, v, kv, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(o2, o)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 88, 120, 128])
def test_masked_key_tile_leaves_state_unchanged(cuda_device, d):
    """A key tile whose keys are all masked leaves m, l and O exactly as
    they were: o and lse are bitwise those of the same call with that
    tile's keys removed."""
    q, k, v, kv = _inputs(2, 3, 70, 192, d, "hole")
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    kv = kv.to(cuda_device)
    keep = torch.cat([torch.arange(64), torch.arange(128, 192)]).to(cuda_device)
    o, lse = ta.flash_attention(q, k, v, kv, return_lse=True)
    o2, lse2 = ta.flash_attention(q, k[:, :, keep].contiguous(),
                                  v[:, :, keep].contiguous(),
                                  kv[:, keep].contiguous(), return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(64, torch.float32),
                                     (128, torch.float32),
                                     (32, torch.bfloat16)])
def test_multihead_attention_routes_the_rest_eagerly(cuda_device, d, dtype):
    """On the card, a call the kernels do not take (float32, head dim 32)
    goes to xla_attention, with or without a gradient, launches no kernel,
    and counts as an eager call."""
    q, k, v, kv = _inputs(2, 2, 33, 40, d, "deadrow")
    q, k, v = (t.to(cuda_device, dtype) for t in (q, k, v))
    kv = kv.to(cuda_device)
    n0 = (ta.flash_attention.launches, ta.flash_bwd_dq.launches)
    e0 = ta.multihead_attention.eager_calls
    out = ta.multihead_attention(q, k, v, kv_valid=kv, causal=True)
    assert torch.equal(out, ta.xla_attention(q, k, v, kv, causal=True))
    assert ta.multihead_attention.eager_calls == e0 + 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ta.multihead_attention(*leaves, kv_valid=kv, causal=True).sum().backward()
    torch.cuda.synchronize()
    assert all(t.grad is not None for t in leaves)
    assert (ta.flash_attention.launches, ta.flash_bwd_dq.launches) == n0
    assert ta.multihead_attention.eager_calls == e0 + 2


@pytest.mark.cuda
def test_kernel_refuses_float32_on_the_card(cuda_device):
    q = torch.zeros((1, 1, 8, 64), device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        ta.flash_attention(q, q, q)


def _bwd_case(cuda_device, b, h, lq, lk, d, mask, causal):
    """bf16 q/k/v/dO and the forward kernel's o and lse, on the card."""
    q, k, v, kv = _inputs(b, h, lq, lk, d, mask)
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    kv = None if kv is None else kv.to(cuda_device)
    do = torch.from_numpy(np.random.default_rng(1).normal(
        size=(b, h, lq, d)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    o, lse = ta.flash_attention(q, k, v, kv, causal=causal, return_lse=True)
    return q, k, v, kv, do, o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,d,mask,causal", [
    (4, 4, 64, 64, 80, "prefix", True),        # the training path's shape
    (2, 3, 70, 70, 88, "nonprefix", True),
    (2, 2, 33, 130, 80, "deadrow", False),
    (1, 2, 40, 97, 64, "prefix", True),        # Lq < Lk, ragged
    (3, 2, 24, 9, 80, "none", True),           # Lq > Lk: early rows dead
    # head dims 128 and 120 (LLaVA's Vicuna: DP 128)
    (4, 4, 640, 640, 128, "llava", True),      # LLaVA's rows, slot after BOS
    (2, 4, 640, 640, 128, "llava_text", True),  # text-only: keys 1-576 dead
    (2, 3, 70, 131, 120, "deadrow", False),    # D 120, ragged Lk, dead row
    (1, 2, 40, 97, 128, "prefix", True),       # Lq < Lk
    (2, 3, 70, 70, 120, "nonprefix", True),
])
def test_backward_kernels_match_plain_version(cuda_device, b, h, lq, lk, d,
                                              mask, causal):
    """K2 and K3 against the plain backward, computed in float32 from the
    same bf16 values: each of dq, dk, dv within 2e-2 of max|plain| (bf16
    rounding of p, ds and the outputs); masked keys get exactly zero dk
    and dv, dead rows exactly zero dq; delta within 1e-3."""
    q, k, v, kv, do, o, lse = _bwd_case(cuda_device, b, h, lq, lk, d, mask,
                                        causal)
    n0 = (ta.flash_bwd_dq.launches, ta.flash_bwd_dkv.launches)
    dq, delta = ta.flash_bwd_dq(q, k, v, kv, causal, o, lse, do)
    dk, dv = ta.flash_bwd_dkv(q, k, v, kv, causal, lse, delta, do)
    torch.cuda.synchronize()
    assert (ta.flash_bwd_dq.launches, ta.flash_bwd_dkv.launches) == \
        (n0[0] + 1, n0[1] + 1)
    f = [t.float() for t in (q, k, v, o, do)]
    rdq, rdelta = ta.flash_bwd_dq_ref(f[0], f[1], f[2], kv, causal, f[3],
                                      lse, f[4])
    rdk, rdv = ta.flash_bwd_dkv_ref(f[0], f[1], f[2], kv, causal, lse,
                                    rdelta, f[4])
    assert (delta - rdelta).abs().max().item() <= 1e-3
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(got.float()).all()
        tol = 2e-2 * ref.abs().max().item()
        assert (got.float() - ref).abs().max().item() <= tol
    if kv is not None:
        dead_keys = (kv == 0)[:, None, :, None].expand_as(dk)
        assert torch.all(dk[dead_keys] == 0) and torch.all(dv[dead_keys] == 0)
    assert torch.all(dq[lse == ta.NEG_INF] == 0)
    dq2, dk2, dv2 = ta.flash_attention_bwd(q, k, v, kv, causal, o, lse, do)
    torch.cuda.synchronize()
    assert torch.equal(dq2, dq) and torch.equal(dk2, dk) and \
        torch.equal(dv2, dv)


@pytest.mark.cuda
def test_function_gradients_on_the_card(cuda_device):
    """multihead_attention on CUDA tensors that need a gradient: autograd
    reaches K2 and K3 through the Function, and the gradients agree with
    PyTorch's autograd through the plain forward."""
    q, k, v, kv, do, _, _ = _bwd_case(cuda_device, 2, 4, 64, 64, 80,
                                      "prefix", True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = (ta.flash_attention.launches, ta.flash_bwd_dq.launches)
    e0 = ta.multihead_attention.eager_calls
    o = ta.multihead_attention(*leaves, kv_valid=kv, causal=True)
    o.backward(do)
    torch.cuda.synchronize()
    assert ta.flash_attention.launches == n0[0] + 1
    assert ta.flash_bwd_dq.launches == n0[1] + 1
    assert ta.multihead_attention.eager_calls == e0
    ref = [t.float().requires_grad_(True) for t in (q, k, v)]
    ta.flash_attention_ref(*ref, kv, True).backward(do.float())
    for got, r in zip(leaves, ref):
        tol = 2e-2 * r.grad.abs().max().item()
        assert (got.grad.float() - r.grad).abs().max().item() <= tol


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """A kernel's library is keyed by its source and every header it
    includes, directly or through another header: editing one rebuilds
    the sources that include it and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    assert [os.path.basename(p) for p in build.source_files("flash_fwd")] \
        == ["flash_fwd.cu", "tile_mma.cuh"]
    fwd, bwd = build.library_path("flash_fwd"), build.library_path("flash_bwd")
    header = csrc / "tile_mma.cuh"
    header.write_text(header.read_text() + '\n#include "extra.cuh"\n')
    (csrc / "extra.cuh").write_text("// one\n")
    fwd2 = build.library_path("flash_fwd")
    assert fwd2 != fwd and build.library_path("flash_bwd") == bwd
    (csrc / "extra.cuh").write_text("// two\n")
    assert build.library_path("flash_fwd") not in (fwd, fwd2)


def test_launch_counts_survive_threads():
    """The launch counters are bumped from the training path's prefetch
    thread too: no increment is lost under contention."""
    def fn():
        pass

    fn.launches, fn.launches_by_shape = 0, {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            ta._count_launch(fn, ("shape",)) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 32000
    assert fn.launches_by_shape == {("shape",): 32000}
