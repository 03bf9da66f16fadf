"""Multi-head attention: the Hopper flash kernels and the plain PyTorch paths.

Counterpart of ``devqa_tpu/ops/attention.py``. Layout: q, k, v are
[B, H, L, D]; ``kv_valid`` [B, Lk] marks attendable keys (any pattern, not
only a prefix); ``causal`` aligns the diagonal at offset ``Lk - Lq``.

- :func:`xla_attention` — plain masked attention with the JAX reference
  path's contract (a fully masked row gets a uniform average). The CPU path,
  differentiated by PyTorch's autograd as the JAX package differentiates it
  off the TPU.
- :func:`flash_attention` — the wrapper of the CUDA forward kernel
  ``csrc/flash_fwd.cu`` (the port of the TPU kernel ``_flash_kernel``):
  CUDA tensors launch the kernel, CPU tensors take
  :func:`flash_attention_ref`, its plain version. Inputs that need a
  gradient go through :class:`FlashAttention`.
- :func:`flash_attention_bwd` — the backward: :func:`flash_bwd_dq` and
  :func:`flash_bwd_dkv` wrap the CUDA kernels of ``csrc/flash_bwd.cu`` (the
  ports of ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``), with
  :func:`flash_attention_bwd_ref` as their plain version.
- :class:`FlashAttention` — the ``torch.autograd.Function`` joining them
  (the counterpart of the JAX ``custom_vjp``): its forward saves the lse,
  its backward launches the two backward kernels.
- :func:`multihead_attention` — the entry every model calls: on CUDA a
  call the kernels take (:func:`kernel_takes`: bf16 at a supported head
  dim, whatever its length) goes through them, anything else to
  :func:`xla_attention`, as the JAX package's ``_attention`` does; on the
  CPU it is :func:`xla_attention`, as the JAX package runs off the TPU.

So on the card a dead query row (one with no live key, such as the vision
slot of a no-image row) holds zeros and gets zero gradient, where the CPU
path holds the uniform average. Dead positions are masked as keys and never
supervised, so no live position and no metric depends on them.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

NEG_INF = -1e30

#: Padded head dims (head dim rounded up to 16) the forward kernel and the
#: backward kernels are instantiated for: one set for both directions.
_PADDED_DIMS = (64, 80, 96, 128)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_valid: Optional[torch.Tensor] = None,
                  causal: bool = False) -> torch.Tensor:
    """Reference masked attention. q,k,v: [B, H, Lq/Lk, D] → [B, H, Lq, D]."""
    lq, d = q.shape[2], q.shape[3]
    lk = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_valid is not None:
        bias = torch.where(kv_valid.bool(), 0.0, NEG_INF)
        s = s + bias[:, None, None, :]
    if causal:
        qi = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        ki = torch.arange(lk, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    # Fully masked rows: softmax over a finite floor gives a uniform,
    # harmless distribution instead of NaN.
    p = torch.softmax(torch.clamp(s, min=2 * NEG_INF), dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 for bf16/f32 inputs, float64 for float64 (the gradchecks)."""
    return torch.promote_types(t.dtype, torch.float32)


def _live_pairs(q, k, kv_valid, causal):
    """[B or 1, 1, Lq, Lk] bool: the (query, key) pairs the softmax keeps."""
    lq, lk = q.shape[2], k.shape[2]
    live = torch.ones((1, 1, lq, lk), dtype=torch.bool, device=q.device)
    if kv_valid is not None:
        live = live & (kv_valid != 0)[:, None, None, :]
    if causal:
        qi = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        ki = torch.arange(lk, device=q.device)[None, :]
        live = live & (ki <= qi)
    return live


def flash_attention_ref(q, k, v, kv_valid=None, causal=False,
                        return_lse=False):
    """Plain PyTorch version of the flash kernel, with its contract: a row
    with no live key gives exact zeros and ``lse = -1e30``. Scores and
    sums in float32 (float64 for float64 inputs); probabilities rounded to
    v's dtype before P·V."""
    acc = _acc_dtype(q)
    d = q.shape[3]
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * (1.0 / d ** 0.5)
    s = torch.where(_live_pairs(q, k, kv_valid, causal), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    dead = (m <= NEG_INF / 2) | (l == 0)
    lsafe = torch.where(dead, 1.0, l)
    o = torch.matmul(p.to(v.dtype).to(acc), v.to(acc)) / lsafe
    o = torch.where(dead, 0.0, o).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(dead, NEG_INF, m + torch.log(lsafe))[..., 0]
    return o, lse


def _bwd_p_ds_ref(q, k, v, kv_valid, causal, lse, delta, do):
    """The backward's block math (``_bwd_p_ds``) on whole rows → (p, ds).
    Masked, causal-future and dead-row (lse ≤ -1e30/2) entries are
    removed by select, never by multiplying a zero into them."""
    acc = _acc_dtype(q)
    scale = 1.0 / q.shape[3] ** 0.5
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    lse = lse.to(acc)[..., None]
    live = _live_pairs(q, k, kv_valid, causal) & (lse > NEG_INF / 2)
    p = torch.where(live, torch.exp(s - lse), 0.0)
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    ds = torch.where(live, p * (dp - delta.to(acc)[..., None]) * scale, 0.0)
    return p, ds


def flash_bwd_dq_ref(q, k, v, kv_valid, causal, o, lse, do):
    """Plain version of K2 → (dq in q's dtype, delta = rowsum(dO∘O) in
    float32). ds is rounded to k's dtype before ds·K."""
    acc = _acc_dtype(q)
    delta = (do.to(acc) * o.to(acc)).sum(-1)
    _, ds = _bwd_p_ds_ref(q, k, v, kv_valid, causal, lse, delta, do)
    dq = torch.matmul(ds.to(k.dtype).to(acc), k.to(acc))
    return dq.to(q.dtype), delta


def flash_bwd_dkv_ref(q, k, v, kv_valid, causal, lse, delta, do):
    """Plain version of K3 → (dk, dv) in k's and v's dtypes. p and ds are
    rounded to the operand dtype before pᵀ·dO and dsᵀ·Q."""
    acc = _acc_dtype(q)
    p, ds = _bwd_p_ds_ref(q, k, v, kv_valid, causal, lse, delta, do)
    dv = torch.matmul(p.to(do.dtype).to(acc).transpose(-1, -2), do.to(acc))
    dk = torch.matmul(ds.to(q.dtype).to(acc).transpose(-1, -2), q.to(acc))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, kv_valid, causal, o, lse, do):
    """Plain version of the flash backward → (dq, dk, dv)."""
    dq, delta = flash_bwd_dq_ref(q, k, v, kv_valid, causal, o, lse, do)
    dk, dv = flash_bwd_dkv_ref(q, k, v, kv_valid, causal, lse, delta, do)
    return dq, dk, dv


def _check_kernel_args(q, k, v, kv_valid):
    tensors = (q, k, v) if kv_valid is None else (q, k, v, kv_valid)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("flash_attention: tensors must all be on the same "
                         "CUDA device, or all on the CPU")
    check_kernel_layout(q, k, v, kv_valid)


def _head_dim_ok(d) -> bool:
    return d % 8 == 0 and (d + 15) // 16 * 16 in _PADDED_DIMS


def check_kernel_layout(q, k, v, kv_valid=None):
    """Raise unless (q, k, v, kv_valid) have the dtypes, shapes, head dim,
    contiguity and alignment the forward kernel takes (the device aside)."""
    tensors = (q, k, v) if kv_valid is None else (q, k, v, kv_valid)
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("flash_attention: the CUDA kernel takes bfloat16 "
                        "q, k, v (got %s, %s, %s)" % (q.dtype, k.dtype, v.dtype))
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q [B,H,Lq,D], k and v [B,H,Lk,D]")
    b, h, lq, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError("flash_attention: q %s and k/v %s disagree"
                         % (tuple(q.shape), tuple(k.shape)))
    if lq == 0 or k.shape[2] == 0 or b * h == 0:
        raise ValueError("flash_attention: empty input %s / %s"
                         % (tuple(q.shape), tuple(k.shape)))
    if not _head_dim_ok(d):
        raise ValueError("flash_attention: head dim %d not supported (a "
                         "multiple of 8 padding to one of %s)"
                         % (d, _PADDED_DIMS))
    if kv_valid is not None and (kv_valid.dtype != torch.int32
                                 or kv_valid.shape != (b, k.shape[2])):
        raise ValueError("flash_attention: kv_valid must be int32 [B, Lk]")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: inputs must be contiguous "
                             "and 16-byte aligned")


def check_bwd_layout(q, k, v, kv_valid, lse, *rows):
    """:func:`check_kernel_layout` (the backward kernels take the forward's
    head dims) plus lse float32 [B, H, Lq] and each of ``rows`` (o, dO)
    bf16 like q, all contiguous."""
    check_kernel_layout(q, k, v, kv_valid)
    for t in rows:
        if t.dtype != torch.bfloat16 or t.shape != q.shape:
            raise ValueError("flash_attention_bwd: o and dO must be bfloat16 "
                             "%s (got %s %s)" % (tuple(q.shape), t.dtype,
                                                 tuple(t.shape)))
    if lse.dtype != torch.float32 or lse.shape != q.shape[:3]:
        raise ValueError("flash_attention_bwd: lse and delta must be "
                         "float32 [B, H, Lq]")
    for t in (lse,) + rows:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention_bwd: o, lse, delta and dO must "
                             "be contiguous and 16-byte aligned")


def _typed(lib, fn, n_ptrs):
    p, i = ctypes.c_void_p, ctypes.c_int
    f = getattr(lib, fn)
    f.argtypes = [p] * n_ptrs + [i] * 6 + [ctypes.c_float, p]
    f.restype = ctypes.c_int


def _kernel_lib(name):
    from .build import load_library

    lib = load_library(name)
    if not getattr(lib, "_devqa_typed", False):
        if name == "flash_fwd":
            _typed(lib, "devqa_flash_fwd", 6)
        else:
            _typed(lib, "devqa_flash_bwd_dq", 9)
            _typed(lib, "devqa_flash_bwd_dkv", 9)
        lib.devqa_cuda_error_string.argtypes = [ctypes.c_int]
        lib.devqa_cuda_error_string.restype = ctypes.c_char_p
        lib._devqa_typed = True
    return lib


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError("%s launch failed: CUDA error %d (%s)" % (
            what, rc, lib.devqa_cuda_error_string(rc).decode()))


def _ptr(t):
    return None if t is None else t.data_ptr()


_LAUNCH_LOCK = threading.Lock()


def _count_launch(fn, key=None):
    """One launch of ``fn``'s kernel: ``fn.launches`` and, given a shape
    key, ``fn.launches_by_shape[key]`` go up by one. Under a lock: the
    training path also launches from its prefetch thread."""
    with _LAUNCH_LOCK:
        fn.launches += 1
        if key is not None:
            fn.launches_by_shape[key] = fn.launches_by_shape.get(key, 0) + 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None,
                    causal: bool = False, return_lse: bool = False):
    """Flash-attention forward → o [B, H, Lq, D] (and lse [B, H, Lq] f32).

    CUDA tensors launch the kernel (bf16 q/k/v, int32 ``kv_valid``,
    contiguous); anything it does not take raises, as does a failed build
    or launch. Without ``return_lse``, inputs that need a gradient go
    through :class:`FlashAttention`, whose backward launches the backward
    kernels. CPU tensors go to :func:`flash_attention_ref`.
    ``flash_attention.launches`` counts kernel launches.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_valid, causal, return_lse)
    if (not return_lse and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return FlashAttention.apply(q, k, v, kv_valid, causal)
    _check_kernel_args(q, k, v, kv_valid)
    b, h, lq, d = q.shape
    lib = _kernel_lib("flash_fwd")
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        rc = lib.devqa_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_valid),
            o.data_ptr(), _ptr(lse), b, h, lq, k.shape[2], d, int(causal),
            1.0 / d ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "flash_fwd")
    _count_launch(flash_attention, (b, h, lq, k.shape[2], d,
                                    kv_valid is not None, bool(causal)))
    return (o, lse) if return_lse else o


flash_attention.launches = 0
#: Launches by (B, H, Lq, Lk, D, has kv_valid, causal), beside ``launches``.
flash_attention.launches_by_shape = {}


def _bwd_kernel_args(q, k, v, kv_valid, lse, *rows):
    tensors = [t for t in (q, k, v, kv_valid, lse) + rows if t is not None]
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("flash_attention_bwd: tensors must all be on the "
                         "same CUDA device, or all on the CPU")
    check_bwd_layout(q, k, v, kv_valid, lse, *rows)
    b, h, lq, d = q.shape
    return (b, h, lq, k.shape[2], d)


def flash_bwd_dq(q, k, v, kv_valid, causal, o, lse, do):
    """K2 → (dq like q, delta = rowsum(dO∘O) float32 [B, H, Lq]).

    CUDA tensors launch the kernel (it also writes delta, which
    :func:`flash_bwd_dkv` reads); CPU tensors go to
    :func:`flash_bwd_dq_ref`. ``flash_bwd_dq.launches`` counts launches,
    ``launches_by_shape`` by shape as for :func:`flash_attention`."""
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, kv_valid, causal, o, lse, do)
    dims = _bwd_kernel_args(q, k, v, kv_valid, lse, o, do)
    lib = _kernel_lib("flash_bwd")
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        rc = lib.devqa_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_valid),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *dims, int(causal), 1.0 / dims[-1] ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "flash_bwd_dq")
    _count_launch(flash_bwd_dq, dims + (kv_valid is not None, bool(causal)))
    return dq, delta


flash_bwd_dq.launches = 0
#: Launches by (B, H, Lq, Lk, D, has kv_valid, causal), beside ``launches``.
flash_bwd_dq.launches_by_shape = {}


def flash_bwd_dkv(q, k, v, kv_valid, causal, lse, delta, do):
    """K3 → (dk like k, dv like v), from the delta of :func:`flash_bwd_dq`.

    CUDA tensors launch the kernel; CPU tensors go to
    :func:`flash_bwd_dkv_ref`. ``flash_bwd_dkv.launches`` counts launches,
    ``launches_by_shape`` by shape."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, kv_valid, causal, lse, delta, do)
    _bwd_kernel_args(q, k, v, kv_valid, delta)
    dims = _bwd_kernel_args(q, k, v, kv_valid, lse, do)
    lib = _kernel_lib("flash_bwd")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = lib.devqa_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_valid),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *dims, int(causal), 1.0 / dims[-1] ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, lib, "flash_bwd_dkv")
    _count_launch(flash_bwd_dkv, dims + (kv_valid is not None, bool(causal)))
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_by_shape = {}


def flash_attention_bwd(q, k, v, kv_valid, causal, o, lse, do):
    """Flash-attention backward → (dq, dk, dv): K2 then K3 on CUDA
    tensors (a failed build or launch raises; nothing falls back),
    :func:`flash_attention_bwd_ref` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, kv_valid, causal, o, lse, do)
    dq, delta = flash_bwd_dq(q, k, v, kv_valid, causal, o, lse, do)
    dk, dv = flash_bwd_dkv(q, k, v, kv_valid, causal, lse, delta, do)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the JAX ``_attention`` custom_vjp):
    the forward keeps o and lse, the backward recomputes p from lse.
    ``FlashAttention.apply(q, k, v, kv_valid, causal)`` → o."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal):
        o, lse = flash_attention(q, k, v, kv_valid, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, kv_valid, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_valid, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_valid, ctx.causal, o,
                                         lse, do.contiguous())
        return dq, dk, dv, None, None


def kernel_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether :func:`multihead_attention` on the card sends a call to the
    flash kernels: bf16 q, k and v with a head dim (a multiple of 8) that
    pads to one of ``_PADDED_DIMS``, whatever the length. The backward
    kernels take the same head dims, so the predicate also routes a call
    that needs a gradient. Everything else (float32, another head dim) goes
    to :func:`xla_attention`, as the JAX package's ``_attention`` sends
    what it does not give its kernel. A call it routes to the kernels and
    that fails to build or launch raises: nothing falls back."""
    return (all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and _head_dim_ok(q.shape[-1]))


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Public attention entry. q,k,v: [B, H, L, D].

    ``kv_valid``: [B, Lk] key-validity mask (1 = attendable).
    ``lengths``: [B] sugar for a valid-prefix mask.
    On CUDA, :func:`kernel_takes` decides between the kernels and
    :func:`xla_attention`; ``multihead_attention.eager_calls`` counts the
    calls on the card it sends to :func:`xla_attention`.
    """
    lk = k.shape[2]
    if kv_valid is None and lengths is not None:
        kv_valid = torch.arange(lk, device=k.device)[None, :] < lengths[:, None]
    if kv_valid is not None:
        kv_valid = kv_valid.to(torch.int32).contiguous()
    if q.is_cuda:
        if kernel_takes(q, k, v):
            return flash_attention(q, k, v, kv_valid, causal)
        with _LAUNCH_LOCK:
            multihead_attention.eager_calls += 1
    return xla_attention(q, k, v, kv_valid, causal)


multihead_attention.eager_calls = 0
