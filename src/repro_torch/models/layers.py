"""Common model layers: norms, embeddings, RoPE, MLPs, initializers.

The JAX package's models/layers.py in PyTorch. Initializers draw from an
explicit `torch.Generator` and take a leading shape ``lead`` so that a
stack of per-layer weights ([n_periods, ...]) is drawn in one call. Every
helper that allocates takes a ``device``, the card unless the caller asks
for the CPU (`device.resolve_device`). `mlp_apply_tp` is the MLP on a
tensor-parallel rank's shards (`dist.tensor_parallel`).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _trunc_normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float, dtype,
                  device) -> torch.Tensor:
    """Normal truncated to [-2, 2], times ``scale``, drawn in float32 on
    ``device`` (the generator's device) and cast to ``dtype``. A fake
    tensor (the dry run's shapes) has no values to draw."""
    from torch._subclasses.fake_tensor import is_fake
    w = torch.empty(shape, dtype=torch.float32, device=resolve_device(device))
    if not is_fake(w):
        torch.nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=gen)
    return w.mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device="cuda",
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    return _trunc_normal(gen, (*lead, d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device="cuda") -> torch.Tensor:
    return _trunc_normal(gen, (vocab, d), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def rmsnorm_init(d: int, dtype, device="cuda", lead: Tuple[int, ...] = ()) -> torch.Tensor:
    # scale stored as (1 + s)
    return torch.zeros((*lead, d), dtype=dtype, device=resolve_device(device))


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device="cuda") -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=resolve_device(device)) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (int). Rotates pairs (even, odd)."""
    b, s, h, hd = x.shape
    freqs = rope_freqs(hd, theta, x.device)                      # [hd/2]
    angles = positions[..., None].float() * freqs                # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    out = torch.stack([r1, r2], dim=-1).reshape(b, s, h, hd)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs (swiglu / geglu / gelu / relu2): weights use 'w*' keys as in JAX
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int, act: str, dtype, device="cuda",
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    p = {"w_in": dense_init(gen, d, d_ff, dtype, device, lead),
         "w_out": dense_init(gen, d_ff, d, dtype, device, lead)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d, d_ff, dtype, device, lead)
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["w_in"]
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif act == "geglu":
        h = _gelu(x @ p["w_gate"]) * h
    elif act == "gelu":
        h = _gelu(h)
    elif act == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(act)
    return h @ p["w_out"]


def mlp_apply_tp(tp, p: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """`mlp_apply` on one model rank: ``p`` holds `TPLeaf` s and ``x`` is
    replicated. Column-parallel ``w_in`` / ``w_gate`` (d_ff sharded),
    row-parallel ``w_out``, the partial sums all-reduced; the output is
    replicated. Where d_ff does not divide over the ranks every rank runs
    the whole MLP on the gathered weights."""
    if not tp.divides(tp.extent(p["w_out"], -2)):           # d_ff
        return mlp_apply(tp.full(p), x, act)
    xc = tp.copy(x)
    local = {k: tp.param(v, -2 if k == "w_out" else -1) for k, v in p.items()}
    h = xc @ local["w_in"]
    if act in ("swiglu", "geglu"):
        g = xc @ local["w_gate"]
        h = (F.silu(g) if act == "swiglu" else _gelu(g)) * h
    elif act == "gelu":
        h = _gelu(h)
    elif act == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(act)
    return tp.reduce(h @ local["w_out"])
