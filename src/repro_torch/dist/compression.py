"""Error-feedback int8 gradient compression for the data-parallel all-reduce.

The JAX package's dist/compression.py over ``torch.distributed``. A
quantized all-reduce moves 1 byte per element (plus the scales) where the
fp32 one moves 4; error feedback carries each rank's quantization residual
into its next step's gradient, so the compression error telescopes instead
of accumulating.

* ``quantize_error_feedback`` — one tensor: int8 values + scale + the new
  residual, with ``q * scale + new_err == g + err`` elementwise.
* ``compressed_psum`` — a gradient tree over a process group: the ranks
  agree on a shared scale (``all_reduce(MAX)`` of the compensated amax),
  quantize, ``all_reduce(SUM)`` the int32 counts, and dequantize to the
  *mean* gradient; each rank keeps its own residual.

Both take per-channel scales (``axis=-1`` / ``per_channel=True``): one
scale per last-axis slice of a tensor with two or more dims. Every fp32
operation is the reference's as XLA compiles it (the reference's train
step always runs under ``jit``), so the same inputs give the same bits:
the division by 127 (and by the group size) is a multiplication by the
float32 reciprocal, ``torch.round`` rounds half to even as ``jnp.round``
does, and the residual ``compensated - q * scale`` is one fused
multiply-subtract, rounded once (here evaluated exactly in float64 and
rounded to float32, which gives the same bits on the card and the CPU).
All leaves' amaxes travel in one ``MAX`` and all counts in one ``SUM``:
both reductions are exact, so batching them changes no number.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..train.tree import tree_leaves_with_path, tree_map, tree_map_with_path

_QMAX = 127.0  # symmetric int8 range


def init_error_state(tree: Any) -> Any:
    """Zero f32 residuals shaped like a gradient/parameter tree."""
    return tree_map(lambda leaf: torch.zeros(leaf.shape, dtype=torch.float32,
                                             device=leaf.device), tree)


def _amax(compensated: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """max |x| over the tensor (0-d), or over every axis but ``axis`` with
    the reduced dims kept (``axis=-1``: a broadcastable ``[1, ..., 1, K]``).
    Tensors with fewer than two dims always take the scalar."""
    if axis is None or compensated.ndim < 2:
        return compensated.abs().amax()
    keep = axis % compensated.ndim
    return compensated.abs().amax(dim=tuple(a for a in range(compensated.ndim) if a != keep),
                                  keepdim=True)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on ``like``'s device: an operand that rounds
    the same way on the card and the CPU (a Python scalar need not)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``where(amax > 0, amax, 1) / 127`` as compiled: times float32(1/127)."""
    return torch.where(amax > 0, amax, _f32(1.0, amax)).to(torch.float32) * _f32(1.0 / _QMAX, amax)


def _residual(compensated: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``compensated - q * scale`` rounded once, as a fused multiply-subtract:
    in float64 the product (8 by 24 significant bits) and the difference
    (operands within an LSB of each other, or q = 0) are exact."""
    return (compensated.to(torch.float64)
            - q.to(torch.float64) * scale.to(torch.float64)).to(torch.float32)


def quantize_error_feedback(g: torch.Tensor, err: torch.Tensor, *,
                            scale: Optional[torch.Tensor] = None,
                            axis: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize ``g + err`` to int8 -> ``(q, scale, new_err)``.

    ``scale`` defaults to ``max|g + err| / 127`` per tensor, or per slice
    along ``axis`` (``-1``: per last-axis channel; tensors with fewer than
    two dims keep the scalar); an explicit ``scale`` (the group-agreed one)
    wins.
    """
    compensated = g.to(torch.float32) + err.to(torch.float32)
    if scale is None:
        scale = _scale(_amax(compensated, axis))
    q = torch.clamp(torch.round(compensated / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale, _residual(compensated, q, scale)


def compressed_psum(grads: Any, err: Any, group=None,
                    per_channel: bool = False) -> Tuple[Any, Any]:
    """Quantized mean all-reduce of a gradient tree over ``group``.

    Per leaf: (1) the ranks agree on one scale via ``all_reduce(MAX)`` of
    the error-compensated amax (a shared scale is what lets int8 counts be
    summed directly); (2) quantize with error feedback; (3)
    ``all_reduce(SUM)`` of the int32 counts; (4) dequantize and divide by
    the group's size (times its float32 reciprocal, as compiled).

    Args:
        grads: this rank's gradient tree.
        err: its residual tree from the previous step (`init_error_state`
            layout; never reduced).
        group: the process group of the data axis (None: the default group).
        per_channel: one scale per last-axis channel for leaves with two or
            more dims (1-D leaves keep the scalar).

    Returns:
        ``(mean_grads, new_err)``: the dequantized mean gradients (the same
        bits on every rank) and this rank's new residuals.
    """
    n = dist.get_world_size(group)
    paths = [p for p, _ in tree_leaves_with_path(grads)]
    g_leaves = [g for _, g in tree_leaves_with_path(grads)]
    e_leaves = [e for _, e in tree_leaves_with_path(err)]
    comp = [g.to(torch.float32) + e.to(torch.float32) for g, e in zip(g_leaves, e_leaves)]
    amaxes = [_amax(c, -1 if per_channel else None) for c in comp]
    flat = torch.cat([a.reshape(-1) for a in amaxes])
    dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=group)
    scales, at = [], 0
    for a in amaxes:
        scales.append(_scale(flat[at:at + a.numel()].reshape(a.shape)))
        at += a.numel()
    quantized = [quantize_error_feedback(g, e, scale=s)
                 for g, e, s in zip(g_leaves, e_leaves, scales)]
    counts = torch.cat([q.reshape(-1).to(torch.int32) for q, _, _ in quantized])
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    means, new_errs, at = {}, {}, 0
    for path, (q, _, new_e), s in zip(paths, quantized, scales):
        total = counts[at:at + q.numel()].reshape(q.shape)
        at += q.numel()
        means[path] = total.to(torch.float32) * s * _f32(1.0 / n, s)
        new_errs[path] = new_e
    return (tree_map_with_path(lambda p, _: means[p], grads),
            tree_map_with_path(lambda p, _: new_errs[p], grads))

