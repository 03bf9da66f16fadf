"""Multi-head attention: the Hopper flash kernel and the plain PyTorch paths.

Counterpart of ``devqa_tpu/ops/attention.py``. Layout: q, k, v are
[B, H, L, D]; ``kv_valid`` [B, Lk] marks attendable keys (any pattern, not
only a prefix); ``causal`` aligns the diagonal at offset ``Lk - Lq``.

- :func:`xla_attention` — plain masked attention with the JAX reference
  path's contract (a fully masked row gets a uniform average). The CPU path.
- :func:`flash_attention` — the wrapper of the CUDA kernel
  ``csrc/flash_fwd.cu`` (the port of the TPU kernel ``_flash_kernel``):
  CUDA tensors launch the kernel, CPU tensors take
  :func:`flash_attention_ref`, its plain version.
- :func:`multihead_attention` — the entry every model calls: on CUDA every
  call, whatever its length, goes through the kernel; on the CPU it is
  :func:`xla_attention`, as the JAX package runs off the TPU.

So on the card a dead query row (one with no live key, such as the vision
slot of a no-image row) holds zeros where the CPU path holds the uniform
average. Dead positions are masked as keys and never supervised, so no
live position and no metric depends on them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30

#: Padded head dims the kernel is instantiated for (head dim rounded up to 16).
_KERNEL_PADDED_DIMS = (64, 80, 96)


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


def flash_attention_ref(q, k, v, kv_valid=None, causal=False,
                        return_lse=False):
    """Plain PyTorch version of the flash kernel, with its contract: a row
    with no live key gives exact zeros and ``lse = -1e30``. Scores and
    sums in float32; probabilities rounded to v's dtype before P·V."""
    lq, d = q.shape[2], q.shape[3]
    lk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / d ** 0.5)
    live = torch.ones((q.shape[0], 1, lq, lk), dtype=torch.bool,
                      device=q.device)
    if kv_valid is not None:
        live = live & (kv_valid != 0)[:, None, None, :]
    if causal:
        qi = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        ki = torch.arange(lk, device=q.device)[None, :]
        live = live & (ki <= qi)
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    dead = (m <= NEG_INF / 2) | (l == 0)
    lsafe = torch.where(dead, 1.0, l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / lsafe
    o = torch.where(dead, 0.0, o).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(dead, NEG_INF, m + torch.log(lsafe))[..., 0]
    return o, lse


def _check_kernel_args(q, k, v, kv_valid):
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward on CUDA yet: the TPU backward "
            "kernels K2 (_flash_bwd_dq_kernel) and K3 (_flash_bwd_dkv_kernel) "
            "of devqa_tpu/ops/attention.py are not ported")
    tensors = (q, k, v) if kv_valid is None else (q, k, v, kv_valid)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("flash_attention: tensors must all be on the same "
                         "CUDA device, or all on the CPU")
    check_kernel_layout(q, k, v, kv_valid)


def check_kernel_layout(q, k, v, kv_valid=None):
    """Raise unless (q, k, v, kv_valid) have the dtypes, shapes, head dim,
    contiguity and alignment the CUDA kernel takes (the device aside)."""
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
    if d % 8 or (d + 15) // 16 * 16 not in _KERNEL_PADDED_DIMS:
        raise ValueError("flash_attention: head dim %d not supported (a "
                         "multiple of 8 padding to one of %s)"
                         % (d, _KERNEL_PADDED_DIMS))
    if kv_valid is not None and (kv_valid.dtype != torch.int32
                                 or kv_valid.shape != (b, k.shape[2])):
        raise ValueError("flash_attention: kv_valid must be int32 [B, Lk]")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: inputs must be contiguous "
                             "and 16-byte aligned")


def _flash_lib():
    from .build import load_library

    lib = load_library("flash_fwd")
    if not getattr(lib, "_devqa_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.devqa_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        ctypes.c_float, p]
        lib.devqa_flash_fwd.restype = ctypes.c_int
        lib.devqa_cuda_error_string.argtypes = [ctypes.c_int]
        lib.devqa_cuda_error_string.restype = ctypes.c_char_p
        lib._devqa_typed = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None,
                    causal: bool = False, return_lse: bool = False):
    """Flash-attention forward → o [B, H, Lq, D] (and lse [B, H, Lq] f32).

    CUDA tensors launch the kernel (bf16 q/k/v, int32 ``kv_valid``,
    contiguous); anything it does not take raises, as does a failed build
    or launch. CPU tensors go to :func:`flash_attention_ref`.
    ``flash_attention.launches`` counts kernel launches.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_valid, causal, return_lse)
    _check_kernel_args(q, k, v, kv_valid)
    b, h, lq, d = q.shape
    lib = _flash_lib()
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        rc = lib.devqa_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(),
            o.data_ptr(), None if lse is None else lse.data_ptr(),
            b, h, lq, k.shape[2], d, int(causal), 1.0 / d ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_fwd launch failed: CUDA error %d (%s)" % (
            rc, lib.devqa_cuda_error_string(rc).decode()))
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Public attention entry. q,k,v: [B, H, L, D].

    ``kv_valid``: [B, Lk] key-validity mask (1 = attendable).
    ``lengths``: [B] sugar for a valid-prefix mask.
    """
    lk = k.shape[2]
    if kv_valid is None and lengths is not None:
        kv_valid = torch.arange(lk, device=k.device)[None, :] < lengths[:, None]
    if kv_valid is not None:
        kv_valid = kv_valid.to(torch.int32).contiguous()
    if q.is_cuda:
        return flash_attention(q, k, v, kv_valid, causal)
    return xla_attention(q, k, v, kv_valid, causal)
