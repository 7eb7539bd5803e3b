"""Causal flash attention, and its GQA wrapper.

``flash_attention_fwd(q, k, v)`` is causal attention over [BH, S, hd]
(fp32 or bf16; K/V already broadcast to q's heads), accumulated in fp32
and returned in q's dtype: on a CUDA tensor the hand kernel in
``csrc/flash_attention.cu`` (online softmax, future KV tiles never
loaded; bf16 on the tensor cores through TMA and ``wgmma``, fp32 on the
CUDA cores, register-blocked, with cp.async copies), on a CPU tensor
``flash_attention_plain``, the masked-softmax reference. ``flash_attention`` is the GQA wrapper over [B, S, H, hd] q and
[B, S, KV, hd] k/v. It computes the same function as the model's
`models.attention.chunked_causal_attention`; no model path calls it, as
in the JAX package.

``KERNEL_LAUNCHES`` counts wrapper calls (one per ``flash_attention_fwd``
call, on either path); hand-kernel launches alone are in
``kernels._build.CUDA_LAUNCHES``.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from .. import _build
from .ref import causal_attention_ref

# name -> number of wrapper calls issued
KERNEL_LAUNCHES: collections.Counter = collections.Counter()

#: head dims the CUDA kernel is built for
CUDA_HEAD_DIMS = (64, 128)
MAX_GRID_Y = 65535

#: the plain version: masked softmax in fp32 (ref.py)
flash_attention_plain = causal_attention_ref


def _flash_attention_cuda(q, k, v):
    dtypes = (torch.float32, torch.bfloat16)
    _build.check_cuda_operands("flash_attention", {"q": dtypes, "k": dtypes, "v": dtypes},
                               q=q, k=k, v=v)
    bh, s, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} "
                         f"{k.dtype}, v {tuple(v.shape)} {v.dtype} disagree")
    if hd not in CUDA_HEAD_DIMS or bh > MAX_GRID_Y:
        raise ValueError(f"flash_attention: the kernel takes hd in {CUDA_HEAD_DIMS} and "
                         f"BH <= {MAX_GRID_Y}, got hd={hd}, BH={bh}")
    o = torch.empty_like(q)
    if bh == 0 or s == 0:
        return o
    vp = ctypes.c_void_p
    _build.launch(
        "flash_attention", [vp, vp, vp, vp] + [ctypes.c_int] * 4 + [ctypes.c_float, vp],
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
        int(q.dtype == torch.bfloat16), bh, s, hd, 1.0 / (hd ** 0.5), _build.stream())
    return o


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention. q/k/v: [BH, S, hd] -> o [BH, S, hd] in q's dtype.

    The tensor's device picks the path: CPU -> the plain version, CUDA ->
    the hand kernel (raises on operands it does not take).
    """
    KERNEL_LAUNCHES["flash_attention"] += 1
    if _build.is_cpu("flash_attention", q):
        return flash_attention_plain(q, k, v)
    return _flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """GQA causal attention: q [B,S,H,hd], k/v [B,S,KV,hd] -> [B,S,H,hd]."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    # broadcast kv heads to q heads and fold (B, H) into one axis
    qf = q.transpose(1, 2).reshape(b * h, s, hd)
    kf = k.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, s, hd)
    vf = v.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, s, hd)
    return flash_attention_fwd(qf, kf, vf).reshape(b, h, s, hd).transpose(1, 2)
