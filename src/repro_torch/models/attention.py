"""GQA attention: chunked online-softmax prefill path + KV-cache decode.

The JAX package's models/attention.py in PyTorch. `chunked_causal_attention`
walks query chunks and, inside each, KV chunks with an online-softmax
accumulator (Python loops where JAX scans), with the same chunk choice,
the same -1e30 mask and the same order of operations; fully masked chunks
are computed and masked as there, not skipped. Supports GQA, RoPE, the
optional QKV bias (qwen1.5) and sliding-window masks.

The decode path takes a scalar or a per-row ``[B]`` position vector and an
``active`` row mask. Unlike JAX, it writes the new KV entry into the cache
**in place** (a cache at full width is gigabytes; a copy per token would
double the step's traffic) and returns the same dict. Callers that need the
old state keep a separate tensor (`serve.runners.lm._LMSession._fresh`).

`attention_block_tp` is the training/prefill block on one model rank of
a tensor-parallel mesh (`dist.tensor_parallel`): heads split over the
ranks in contiguous, possibly uneven, ranges.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from .layers import apply_rope, dense_init

NEG_INF = -1e30


def _largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (chunk-size selection)."""
    cap = min(cap, n)
    for d in range(cap, 0, -1):
        if n % d == 0:
            return d
    return 1


def attn_init(gen: torch.Generator, d: int, n_heads: int, n_kv_heads: int, head_dim: int,
              qkv_bias: bool, dtype, device="cuda", lead: Tuple[int, ...] = ()
              ) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    p = {
        "wq": dense_init(gen, d, n_heads * head_dim, dtype, device, lead),
        "wk": dense_init(gen, d, n_kv_heads * head_dim, dtype, device, lead),
        "wv": dense_init(gen, d, n_kv_heads * head_dim, dtype, device, lead),
        "wo": dense_init(gen, n_heads * head_dim, d, dtype, device, lead),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads), ("bv", n_kv_heads)):
            p[name] = torch.zeros((*lead, width * head_dim), dtype=dtype, device=device)
    return p


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rope_theta, positions):
    b, s, _ = x.shape
    q = x @ p["wq"] + (p["bq"] if "bq" in p else 0)
    k = x @ p["wk"] + (p["bk"] if "bk" in p else 0)
    v = x @ p["wv"] + (p["bv"] if "bv" in p else 0)
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv_heads, head_dim)
    v = v.reshape(b, s, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def chunked_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, window: int = 0, q_chunk: int = 512, kv_chunk: int = 1024,
    f32_streams: bool = False,
) -> torch.Tensor:
    """Online-softmax causal attention. q [B,S,H,hd], k/v [B,S,KV,hd].

    window > 0 restricts attention to the last `window` positions. Chunks
    are the largest divisors of S not above the requested sizes. Scores and
    the accumulator are float32 whatever the stream dtype (bf16 products are
    exact in float32, as the TPU's f32-accumulating matmul gives them).
    """
    b, s, h, hd = q.shape
    kv_heads = k.shape[2]
    g = h // kv_heads if kv_heads else 1                  # a model rank with no heads
    q_chunk = _largest_divisor_leq(s, q_chunk)
    kv_chunk = _largest_divisor_leq(s, kv_chunk)
    nq, nk = s // q_chunk, s // kv_chunk
    scale = 1.0 / math.sqrt(hd)

    sdt = torch.float32 if f32_streams else q.dtype
    qr = (q.float() * scale).to(sdt).reshape(b, nq, q_chunk, kv_heads, g, hd)
    kr = k.to(sdt).reshape(b, nk, kv_chunk, kv_heads, hd)
    vr = v.to(sdt).reshape(b, nk, kv_chunk, kv_heads, hd)
    iq = torch.arange(q_chunk, device=q.device)[:, None]
    ik = torch.arange(kv_chunk, device=q.device)[None, :]

    chunks = []
    for qi in range(nq):
        qc = qr[:, qi].float()                                   # [B, C, KV, G, hd]
        m = torch.full((b, kv_heads, g, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((b, kv_heads, g, q_chunk), device=q.device)
        acc = torch.zeros((b, kv_heads, g, q_chunk, hd), device=q.device)
        for ki in range(nk):
            kc, vc = kr[:, ki], vr[:, ki]
            qpos = qi * q_chunk + iq
            kpos = ki * kv_chunk + ik
            mask = kpos <= qpos
            if window > 0:
                mask &= kpos > qpos - window
            sc = torch.einsum("bqkgh,bskh->bkgqs", qc, kc.float())
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(vc.dtype).float(), vc.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]         # [B, KV, G, Cq, hd]
        chunks.append(out.permute(0, 3, 1, 2, 4))                # [B, Cq, KV, G, hd]
    return torch.cat(chunks, dim=1).reshape(b, s, h, hd).to(q.dtype)


def attention_block(
    p: Dict[str, torch.Tensor], x: torch.Tensor, *,
    n_heads: int, n_kv_heads: int, head_dim: int,
    rope_theta: float, window: int = 0,
    q_chunk: int = 512, kv_chunk: int = 1024, f32_streams: bool = False,
) -> torch.Tensor:
    """Full training/prefill attention over [B, S, d] (pre-normed input)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rope_theta, positions)
    out = chunked_causal_attention(q, k, v, window=window, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk, f32_streams=f32_streams)
    return out.reshape(b, s, n_heads * head_dim) @ p["wo"]


def _kv_per_head(t: torch.Tensor, g: int, lo: int, hi: int, klo: int) -> torch.Tensor:
    """K or V of the KV heads ``[klo, ...)`` ``[B, S, nk, hd]`` for the query
    heads ``[lo, hi)`` (head h reads KV head h // g): as they are where the
    local query heads read them in equal groups (one KV head, or whole
    groups of g), else expanded to one per query head."""
    nk = t.shape[2]
    if nk <= 1 or (lo == klo * g and hi - lo == nk * g):
        return t
    b, s, _, hd = t.shape
    t = t[:, :, :, None].expand(b, s, nk, g, hd).reshape(b, s, nk * g, hd)
    return t[:, :, lo - klo * g:hi - klo * g]


def attention_block_tp(
    tp, p: Dict, x: torch.Tensor, *,
    n_heads: int, n_kv_heads: int, head_dim: int,
    rope_theta: float, window: int = 0,
    q_chunk: int = 512, kv_chunk: int = 1024, f32_streams: bool = False,
) -> torch.Tensor:
    """`attention_block` on one model rank: ``p`` holds `TPLeaf` s, ``x``
    is replicated. This rank computes its range of the query heads
    (`TPAxis.span`: uneven where the ranks do not divide the heads, none
    where there are fewer heads than ranks) exactly as one process does,
    from those heads' columns of ``wq`` and the KV heads they read
    (`TPAxis.part`: the column shard where the heads divide), the K / V
    expanded to one per query head where the range cuts a group
    (`_kv_per_head`); ``wo`` row-parallel on the same range, its partial
    sums all-reduced."""
    kw = dict(window=window, q_chunk=q_chunk, kv_chunk=kv_chunk, f32_streams=f32_streams)
    b, s, _ = x.shape
    lo, hi = tp.span(n_heads)
    g = n_heads // n_kv_heads
    klo, khi = (lo // g, (hi - 1) // g + 1) if hi > lo else (0, 0)
    xc = tp.copy(x)

    def project(name, a, z):
        y = xc @ tp.part(p["w" + name], -1, a * head_dim, z * head_dim)
        if "b" + name in p:
            y = y + tp.part(p["b" + name], -1, a * head_dim, z * head_dim)
        return y.reshape(b, s, z - a, head_dim)

    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q = apply_rope(project("q", lo, hi), positions, rope_theta)
    k = _kv_per_head(apply_rope(project("k", klo, khi), positions, rope_theta), g, lo, hi, klo)
    v = _kv_per_head(project("v", klo, khi), g, lo, hi, klo)
    out = chunked_causal_attention(q, k, v, **kw)
    wo = tp.part(p["wo"], -2, lo * head_dim, hi * head_dim)
    return tp.reduce(out.reshape(b, s, (hi - lo) * head_dim) @ wo)


# ---------------------------------------------------------------------------
# Decode path (one new token against a KV cache)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_seq: int, n_kv_heads: int, head_dim: int, dtype,
                  device="cuda", lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    shape = (*lead, batch, max_seq, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(
    p: Dict[str, torch.Tensor], x: torch.Tensor, cache: Dict[str, torch.Tensor], pos, *,
    n_heads: int, n_kv_heads: int, head_dim: int, rope_theta: float, window: int = 0,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, 1, d] new-token activations; pos: a position shared by the
    batch, or a [B] vector of per-request positions.

    active: optional bool [B]; rows with active=False leave their cache slot
    bit-untouched. The write goes to the one slot of each row, in place; a
    slot past the cache (a masked column of `decode_chunk` near max_seq) is
    not written, as JAX's scatter drops it.

    For window > 0 the cache is a ring buffer of size `window` (slot =
    pos % window); otherwise it covers max_seq positions.
    """
    b = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    max_s = ck.shape[1]
    pos_vec = torch.as_tensor(pos, device=x.device).long().expand(b)   # [B]
    q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, rope_theta,
                                   pos_vec[:, None])

    slot = pos_vec % max_s if window > 0 else pos_vec
    keep = slot < max_s
    if active is not None:
        keep = keep & torch.as_tensor(active, device=x.device)
    rows = torch.arange(b, device=x.device)
    at = slot.clamp(max=max_s - 1)
    keep = keep[:, None, None]
    ck[rows, at] = torch.where(keep, k_new[:, 0].to(ck.dtype), ck[rows, at])
    cv[rows, at] = torch.where(keep, v_new[:, 0].to(cv.dtype), cv[rows, at])

    g = n_heads // n_kv_heads
    qh = q.reshape(b, n_kv_heads, g, head_dim).float() / math.sqrt(head_dim)
    sc = torch.einsum("bkgh,bskh->bkgs", qh, ck.float())          # [B, KV, G, S]
    idx = torch.arange(max_s, device=x.device)[None]               # [1, S]
    pv = pos_vec[:, None]                                          # [B, 1]
    if window > 0:
        # ring buffer: slot i holds the absolute position derived from pos
        ph = pv % max_s
        abs_pos = torch.where(idx <= ph, pv - ph + idx, pv - ph - max_s + idx)
        valid = (abs_pos >= 0) & (abs_pos <= pv) & (abs_pos > pv - max_s)
    else:
        valid = idx <= pv                                          # [B, S]
    sc = torch.where(valid[:, None, None], sc, NEG_INF)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w, cv.float())
    out = out.reshape(b, 1, n_heads * head_dim).to(x.dtype) @ p["wo"]
    return out, cache
