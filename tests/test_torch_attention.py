"""The port's attention against the JAX package's, on the same numpy inputs.

- ``xla_attention`` (the CPU path) against JAX ``xla_attention``;
- ``flash_attention_ref`` (the flash kernel's plain version) against the
  JAX Pallas kernel ``_flash_fwd`` run in interpret mode;
- ``flash_attention_bwd_ref`` (the plain version of the backward kernels)
  against the JAX Pallas backward ``_flash_bwd`` in interpret mode, on
  the same o, lse and dO;
- a float64 ``gradcheck`` of the autograd Function's CPU composition
  (plain forward, plain backward);

The wrapper's dispatch and the CUDA kernel against its plain version are
in ``test_torch_kernels.py``, which imports no JAX so that it also runs on
the machine with the card.

Float32 throughout; atol 1e-5 (summation order differs between the two
frameworks' float32 matmuls, nothing else).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devqa_tpu.ops.attention import _flash_bwd, _flash_fwd
from devqa_tpu.ops.attention import xla_attention as jax_xla_attention
from devqa_tpu_torch.ops import attention as ta

ATOL = 1e-5


def _inputs(b, h, lq, lk, d, mask, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    if mask == "none":
        kv = None
    elif mask == "prefix":
        lens = rng.integers(1, lk + 1, size=b)
        kv = (np.arange(lk)[None, :] < lens[:, None]).astype(np.int32)
    elif mask == "nonprefix":
        kv = (rng.random((b, lk)) < 0.6).astype(np.int32)
        kv[:, -1] = 1
    elif mask == "deadrow":  # batch row 0 has no live key at all
        kv = (rng.random((b, lk)) < 0.6).astype(np.int32)
        kv[0] = 0
    else:
        raise ValueError(mask)
    return q, k, v, kv


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


CASES = [
    # (b, h, lq, lk, d, mask, causal)
    pytest.param(2, 2, 9, 9, 8, "none", False, id="nomask"),
    pytest.param(2, 2, 12, 12, 16, "prefix", False, id="prefix"),
    pytest.param(3, 2, 10, 10, 8, "nonprefix", True, id="nonprefix-causal"),
    pytest.param(2, 2, 5, 13, 8, "prefix", True, id="causal-lq<lk"),
    pytest.param(2, 1, 7, 11, 8, "deadrow", False, id="dead-row"),
]


@pytest.mark.parametrize("b,h,lq,lk,d,mask,causal", CASES)
def test_xla_attention_matches_jax(b, h, lq, lk, d, mask, causal):
    q, k, v, kv = _inputs(b, h, lq, lk, d, mask)
    ref = np.asarray(jax_xla_attention(*_jax(q, k, v, kv), causal=causal))
    out = ta.xla_attention(*_torch(q, k, v, kv), causal=causal).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,h,lq,lk,d,mask,causal", CASES + [
    # Lq > Lk causal: the first rows see no key at all.
    pytest.param(1, 2, 12, 5, 8, "none", True, id="causal-lq>lk-dead"),
    # LLaVA's Vicuna head dim, a ragged causal Lq < Lk with a dead row
    pytest.param(2, 2, 20, 70, 128, "deadrow", True, id="d128-causal"),
])
def test_flash_ref_matches_pallas_interpret(b, h, lq, lk, d, mask, causal):
    q, k, v, kv = _inputs(b, h, lq, lk, d, mask)
    o_j, lse_j = _flash_fwd(*_jax(q, k, v, kv), causal, interpret=True,
                            return_lse=True)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    o_t, lse_t = ta.flash_attention_ref(*_torch(q, k, v, kv), causal=causal,
                                        return_lse=True)
    o_t, lse_t = o_t.numpy(), lse_t.numpy()
    np.testing.assert_allclose(o_t, o_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse_t, lse_j, atol=ATOL, rtol=1e-6)
    dead = lse_j <= ta.NEG_INF / 2
    if mask == "deadrow" or lq > lk:
        assert dead.any()
    assert np.array_equal(dead, lse_t == ta.NEG_INF)
    assert np.all(o_t[dead] == 0.0)


@pytest.mark.parametrize("b,h,lq,lk,d,mask,causal", CASES + [
    pytest.param(1, 2, 12, 5, 8, "none", True, id="causal-lq>lk-dead"),
    pytest.param(2, 2, 13, 13, 8, "deadrow", True, id="ragged-dead-causal"),
    # LLaVA's Vicuna head dim, and 120 (padded to 128 on the card), ragged
    pytest.param(2, 2, 20, 70, 128, "deadrow", True, id="d128-causal"),
    pytest.param(2, 2, 17, 29, 120, "nonprefix", False, id="d120"),
])
def test_flash_bwd_ref_matches_pallas_interpret(b, h, lq, lk, d, mask,
                                                causal):
    q, k, v, kv = _inputs(b, h, lq, lk, d, mask)
    do = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    o, lse = _flash_fwd(*_jax(q, k, v, kv), causal, interpret=True,
                        return_lse=True)
    o, lse = np.array(o), np.array(lse)
    grads_j = _flash_bwd(*_jax(q, k, v, kv), causal, *_jax(o, lse, do),
                         interpret=True)
    grads_t = ta.flash_attention_bwd_ref(*_torch(q, k, v, kv), causal,
                                         *_torch(o, lse, do))
    for name, t, j in zip(("dq", "dk", "dv"), grads_t, grads_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=0, err_msg=name)
    dq, dk, dv = (g.numpy() for g in grads_t)
    dead = lse <= ta.NEG_INF / 2
    if mask == "deadrow" or lq > lk:
        assert dead.any()
    assert np.all(dq[dead] == 0.0)
    if kv is not None:
        masked = np.broadcast_to((kv == 0)[:, None, :], dk.shape[:3])
        assert masked.any() or mask == "prefix"
        assert np.all(dk[masked] == 0.0) and np.all(dv[masked] == 0.0)


@pytest.mark.parametrize("lq,lk,mask,causal", [
    (5, 5, "none", False),
    (4, 7, "nonprefix", True),
    (6, 6, "deadrow", False),
])
def test_function_gradcheck_float64(lq, lk, mask, causal):
    """``FlashAttention`` on CPU tensors: the plain forward with the plain
    backward, against finite differences in float64."""
    q, k, v, kv = _inputs(2, 2, lq, lk, 8, mask, seed=11)
    q, k, v = (torch.from_numpy(a).double().requires_grad_(True)
               for a in (q, k, v))
    kv = None if kv is None else torch.from_numpy(kv)
    assert torch.autograd.gradcheck(
        lambda q, k, v: ta.FlashAttention.apply(q, k, v, kv, causal),
        (q, k, v), eps=1e-6, atol=1e-6)
