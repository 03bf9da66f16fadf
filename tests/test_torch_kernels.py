"""The flash-attention wrapper's dispatch, and on a CUDA card the kernel
against its plain version. Imports no JAX, so it runs on the machine with
the card too:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets up JAX.) Here, without a
card, the CUDA cases skip.
"""
import numpy as np
import pytest
import torch

from devqa_tpu_torch.ops import attention as ta


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
    out = ta.multihead_attention(q, k, v, causal=True, lengths=lengths)
    kv = (torch.arange(7)[None, :] < lengths[:, None]).to(torch.int32)
    assert torch.equal(out, ta.xla_attention(q, k, v, kv, causal=True))


def test_kernel_path_refuses_gradients_and_other_devices():
    """Off the CPU the wrapper goes to the kernel, which has no backward
    yet: a tensor that needs a gradient raises before anything launches,
    and a tensor on neither the CPU nor a card is refused."""
    q = torch.empty((1, 1, 8, 64), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    with pytest.raises(NotImplementedError, match="K2"):
        ta.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(ValueError, match="CUDA"):
        ta.flash_attention(q.detach(), q.detach(), q.detach())


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
def test_kernel_refuses_float32_on_the_card(cuda_device):
    q = torch.zeros((1, 1, 8, 64), device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        ta.flash_attention(q, q, q)
