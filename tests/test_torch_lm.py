"""The port's LM modules against the JAX package's, on the CPU.

The same numpy inputs (made from a seed) and the same weights (a JAX
parameter tree carried across with `params_from_numpy`) go through the JAX
function and the port's counterpart. Pallas kernels run in interpret mode,
as the JAX package's own tests run them.

Bars, and why:
- int4 packing, quantization and the `quantized_lm_params` view: exact
  (integer work, and the same float32 divide and round on both sides);
- the int4 matmul: the JAX test's own bar (rtol 1e-4, atol 1e-3);
- flash attention: atol 5e-5 in float32, the JAX test's bar;
- single layers (rmsnorm, RoPE, MLP): 1e-5; XLA's and torch's sin, cos,
  rsqrt and silu may differ by an ulp;
- attention and whole-model logits, caches: 1e-4 absolute on values of
  order one. Sums of 32-64 terms are taken in other orders, and RoPE's
  sin/cos and softmax's exp differ by an ulp between XLA's CPU math and
  torch's, through several layers; greedy picks must still agree.
- the port's own invariants (decode_chunk against sequential steps, cache
  resets and rollbacks): bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.core import quant as jax_quant
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.int4_matmul.ops import w4a16_linear as jax_w4a16
from repro.kernels.int4_matmul.ref import int4_matmul_ref as jax_int4_ref
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.serve.runners.lm import quantized_lm_params as jax_quantized
from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant
from repro_torch.kernels import CUDA_LAUNCHES
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.int4_matmul import ops as int4_ops
from repro_torch.kernels.int4_matmul.ref import int4_matmul_ref
from repro_torch.models import attention, layers
from repro_torch.models import transformer as tf
from repro_torch.serve.runners.lm import quantized_lm_params

# the reduced qwen of examples/serve_lm_w4.py (MHA, QKV bias), a GQA
# variant, and sliding-window local attention
QWEN = dict(name="qwen-small", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, head_dim=16, d_ff=128, vocab=257, qkv_bias=True,
            dtype="float32", remat="none", q_chunk=16, kv_chunk=16)
GQA = dict(QWEN, name="gqa-small", n_kv_heads=2, qkv_bias=False, q_chunk=8, kv_chunk=8)
LOCAL = dict(GQA, name="local-small", pattern=("local_attn",), window=5)
CFGS = {"qwen": QWEN, "gqa": GQA, "local": LOCAL}
LOGIT_TOL = 1e-4
SEQ = 24


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _jax_params(kw, seed=0):
    """JAX init, with nonzero norms and biases so they are exercised."""
    p = jax_tf.init_params(jax.random.PRNGKey(seed), jax_base.ArchConfig(**kw))
    noise = iter(range(1000))

    def bump(path, x):
        key = jax.tree_util.keystr(path)
        if "norm" in key or "['b" in key:
            return x + jnp.asarray(_normal(next(noise), x.shape, 0.1))
        return x
    return jax.tree_util.tree_map_with_path(bump, p)


@pytest.fixture(scope="module", params=sorted(CFGS))
def model(request):
    kw = CFGS[request.param]
    jp = _jax_params(kw)
    return (jax_base.ArchConfig(**kw), ArchConfig(**kw), jp,
            tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


def _close(a, b, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=tol)


def _cache_leaves(cache):
    return [cache["periods"]["slot0"]["k"], cache["periods"]["slot0"]["v"]]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_qwen_config_matches_reference():
    ours, ref = configs.get_arch("qwen1.5-4b"), jax_get_arch("qwen1.5-4b")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    # the port's registry is the reference's: every arch, each field equal
    # (the other nine: tests/test_torch_archs.py)
    assert set(configs.all_archs()) == set(jax_all_archs())
    assert ours.hd == 128 and ours.n_periods == 40
    for name, shape in configs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jax_base.SHAPES[name])
        assert configs.shape_applicable(ours, shape) == jax_base.shape_applicable(ref, shape)


# ---------------------------------------------------------------------------
# int4 storage and the W4A16 matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((64, 32), -1), ((17, 130), -1), ((3, 8, 6), None),
                                        ((5, 4), 0)])
def test_int4_quantize_pack_exact(shape, axis):
    w = _normal(1, shape)
    ref = jax_quant.quantize_int4(jnp.asarray(w), axis=axis)
    qt = quant.quantize_int4(torch.from_numpy(w), axis=axis)
    assert qt.packed.dtype == torch.int8 and qt.shape == ref.shape
    np.testing.assert_array_equal(qt.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(ref.scale))
    assert qt.nbytes_logical == ref.nbytes_logical
    np.testing.assert_array_equal(quant.dequantize(qt).numpy(),
                                  np.asarray(jax_quant.dequantize(ref)))


def test_pack_unpack_every_nibble_pair():
    q = np.array([[a, b] for a in range(-8, 8) for b in range(-8, 8)], np.int8)
    packed = quant.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_quant.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(quant.unpack_int4(packed, q.shape).numpy(), q)


@pytest.mark.parametrize("m,k,n", [(4, 64, 32), (17, 96, 130), (128, 512, 256)])
def test_w4a16_linear_matches_reference(m, k, n):
    x, w = _normal(2, (m, k)), _normal(3, (k, n))
    jqt = jax_quant.quantize_int4(jnp.asarray(w), axis=-1)
    ref = np.asarray(jax_w4a16(jnp.asarray(x), jqt, interpret=True))
    qt = quant.quantize_int4(torch.from_numpy(w), axis=-1)
    before = dict(CUDA_LAUNCHES)
    out = int4_ops.w4a16_linear(torch.from_numpy(x), qt)
    assert out.dtype == torch.float32 and CUDA_LAUNCHES == before
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(int4_matmul_ref(torch.from_numpy(x), qt).numpy(),
                               np.asarray(jax_int4_ref(jnp.asarray(x), jqt)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(4, 64, 32), (17, 96, 130), (128, 512, 256)])
def test_w4a16_linear_bf16_matches_reference(m, k, n):
    """bf16 x: the JAX kernel unpacks to bf16 and dots with fp32 sums; the
    port's plain path takes the same bf16 values in fp32."""
    x, w = _normal(6, (m, k)), _normal(7, (k, n))
    jqt = jax_quant.quantize_int4(jnp.asarray(w), axis=-1)
    ref = np.asarray(jax_w4a16(jnp.asarray(x).astype(jnp.bfloat16), jqt, interpret=True))
    qt = quant.quantize_int4(torch.from_numpy(w), axis=-1)
    out = int4_ops.w4a16_linear(torch.from_numpy(x).bfloat16(), qt)
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-3)


def test_w4a16_linear_leading_dims_and_bf16():
    x = torch.from_numpy(_normal(4, (2, 3, 64)))
    qt = quant.quantize_int4(torch.from_numpy(_normal(5, (64, 48))))
    out = int4_ops.w4a16_linear(x, qt)
    assert out.shape == (2, 3, 48)
    torch.testing.assert_close(out.reshape(6, 48), int4_ops.w4a16_linear(x.reshape(6, 64), qt),
                               rtol=0, atol=0)
    xb = x.bfloat16()                        # int4 values are exact in bf16
    torch.testing.assert_close(int4_ops.w4a16_linear(xb, qt),
                               int4_ops.w4a16_linear(xb.float(), qt), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(seed, b, s, h, kv, hd):
    return (_normal(seed, (b, s, h, hd)), _normal(seed + 1, (b, s, kv, hd)),
            _normal(seed + 2, (b, s, kv, hd)))


@pytest.mark.parametrize("b,s,h,kv,hd", [(2, 32, 4, 2, 16), (1, 64, 2, 1, 32), (1, 16, 4, 4, 8)])
@pytest.mark.parametrize("bq,bk", [(8, 8), (16, 32)])
def test_flash_attention_plain_matches_reference(b, s, h, kv, hd, bq, bk):
    q, k, v = _qkv(6, b, s, h, kv, hd)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=bq,
                               block_k=bk, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = flash_ops.flash_attention(tq, tk, tv)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5)
    # the model's own prefill attention computes the same function
    chunked = attention.chunked_causal_attention(tq, tk, tv, q_chunk=bq, kv_chunk=bk)
    np.testing.assert_allclose(chunked.numpy(), out.numpy(), atol=5e-5)


def test_flash_attention_bf16():
    q, k, v = _qkv(9, 1, 32, 2, 1, 16)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_flash(jq, jk, jv, block_q=8, block_k=8, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in (jq, jk, jv))
    out = flash_ops.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    # at most one bf16 rounding step apart (both accumulate in fp32)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7, atol=1e-6)
    counts = flash_ops.KERNEL_LAUNCHES["flash_attention"]
    flash_ops.flash_attention_fwd(tq[0].transpose(0, 1), tk[0].transpose(0, 1),
                                  tv[0].transpose(0, 1))
    assert flash_ops.KERNEL_LAUNCHES["flash_attention"] == counts + 1


def _bf16_kernel_model(q, k, v, block_k=128):
    """The bf16 CUDA kernel's rounding points, in plain PyTorch: q, k, v
    [BH, S, hd] bf16; scores summed in fp32 and scaled in fp32 (q is not
    pre-scaled in bf16; the kernel applies the scale inside its exponent);
    the TPU kernel's online softmax over KV tiles of ``block_k`` (-1e30
    masks, alpha rescale, l summing the fp32 p); p rounded to bf16 before
    P V; the output rounded to bf16 once."""
    bh, s, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, s, 1), -1e30)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, hd))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, block_k):
        kv = slice(k0, min(k0 + block_k, s))
        sc = torch.einsum("bqd,bkd->bqk", qf, kf[:, kv]) * (1.0 / hd ** 0.5)
        sc = torch.where(torch.arange(k0, kv.stop)[None, :] <= qpos, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", p.bfloat16().float(), vf[:, kv])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).bfloat16()


@pytest.mark.parametrize("s,hd", [(130, 64), (256, 128)])
def test_flash_attention_bf16_kernel_rounding_within_the_card_bar(s, hd):
    # the card test's bf16 bar, 2**-7 * max(1, max|ref|), holds for the bf16
    # kernel's rounding points (P in bf16 before P V) against the TPU
    # kernel, which keeps P in fp32
    q, k, v = _qkv(12, 1, s, 2, 1, hd)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_flash(jq, jk, jv, block_q=s, block_k=s, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in (jq, jk, jv))
    heads = lambda t: t.repeat_interleave(2 // t.shape[2], dim=2).transpose(1, 2).reshape(2, s, hd)
    out = _bf16_kernel_model(heads(tq), heads(tk), heads(tv))
    out = out.reshape(1, 2, s, hd).transpose(1, 2).float().numpy()
    err = np.abs(out - ref).max()
    assert 0 < err <= 2 ** -7 * max(1.0, np.abs(ref).max())
    # the plain version (fp32 P) is as close: the model's P rounding is the
    # only extra step, and it stays within one bf16 step of the output
    plain = flash_ops.flash_attention(tq, tk, tv).float().numpy()
    assert np.abs(plain - ref).max() <= 2 ** -7 * max(1.0, np.abs(ref).max())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope_match_reference():
    x, s = _normal(10, (2, 5, 3, 16)), _normal(11, (16,), 0.1)
    _close(jax_layers.rmsnorm(jnp.asarray(x), jnp.asarray(s)),
           layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)), 1e-5)
    pos = _rng(12).integers(0, 500, size=(2, 5))
    _close(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32)),
           layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)), 1e-5)
    np.testing.assert_array_equal(layers.rope_freqs(16, device="cpu").numpy(),
                                  np.asarray(jax_layers.rope_freqs(16)))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_apply_matches_reference(act):
    p = {k: np.array(v) for k, v in
         jax_layers.mlp_init(jax.random.PRNGKey(1), 16, 32, act, jnp.float32).items()}
    x = _normal(13, (3, 16))
    _close(jax_layers.mlp_apply(p, jnp.asarray(x), act),
           layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), act), 1e-5)


def test_initializers_draw_truncated_normals_of_the_reference_scale():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, 400, 300, torch.float32, "cpu", lead=(2,))
    assert w.shape == (2, 400, 300)
    scaled = w * 400 ** 0.5
    assert scaled.abs().max() <= 2.0 and abs(scaled.std().item() - 0.88) < 0.02
    e = layers.embed_init(gen, 1000, 64, torch.float32, "cpu")
    assert (e.abs() <= 0.04).all() and abs(e.std().item() / 0.02 - 0.88) < 0.02


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("kv", [4, 2])
def test_chunked_causal_attention_matches_reference(window, kv):
    q, k, v = _qkv(14, 2, 24, 4, kv, 16)
    ref = jax_attn.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            window=window, q_chunk=8, kv_chunk=12)
    out = attention.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)),
                                             window=window, q_chunk=8, kv_chunk=12)
    _close(ref, out)


@pytest.mark.parametrize("window", [0, 6])
def test_attention_decode_per_row_positions_and_active(window):
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, rope_theta=10000.0, window=window)
    jp = {k: np.array(v) for k, v in
          jax_attn.attn_init(jax.random.PRNGKey(2), 32, 4, 2, 8, True, jnp.float32).items()}
    seq = 6 if window else 16
    ck, cv = _normal(15, (3, seq, 2, 8)), _normal(16, (3, seq, 2, 8))
    x = _normal(17, (3, 1, 32))
    pos = np.array([0, 9, 4], np.int32)
    active = np.array([True, True, False])
    ref_out, ref_cache = jax_attn.attention_decode(
        jp, jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.asarray(pos),
        active=jnp.asarray(active), **kw)
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    out, new = attention.attention_decode(
        {k: torch.from_numpy(v) for k, v in jp.items()}, torch.from_numpy(x), cache,
        torch.from_numpy(pos), active=torch.from_numpy(active), **kw)
    assert new is cache                                   # written in place
    _close(ref_out, out)
    _close(ref_cache["k"], new["k"])
    _close(ref_cache["v"], new["v"])
    # the inactive row's slot, and every unwritten slot, are bit-untouched
    np.testing.assert_array_equal(new["k"][2].numpy(), ck[2])
    np.testing.assert_array_equal(new["v"][1].numpy()[np.arange(seq) != 9 % seq],
                                  cv[1][np.arange(seq) != 9 % seq])


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------

def test_init_params_tree_matches_reference():
    kw = dict(QWEN, n_layers=3)
    ref = jax.eval_shape(lambda: jax_tf.init_params(jax.random.PRNGKey(0),
                                                    jax_base.ArchConfig(**kw)))
    ours = tf.init_params(torch.Generator().manual_seed(0), ArchConfig(**kw), "cpu")
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    count = lambda t: sum(map(count, t.values())) if isinstance(t, dict) else \
        sum(map(count, t)) if isinstance(t, tuple) else 1
    assert len(ref_leaves) == count(ours)
    for path, leaf in ref_leaves:
        t = ours
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32, path


def test_forward_matches_reference(model):
    jcfg, cfg, jp, tp = model
    toks = _rng(18).integers(0, cfg.vocab, size=(2, 16))
    ref, _ = jax_tf.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    out, aux = tf.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(ref, out)
    assert float(aux) == 0.0
    last, _ = tf.prefill_step(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    torch.testing.assert_close(last, out[:, -1:], rtol=0, atol=0)


def test_decode_step_matches_reference(model):
    jcfg, cfg, jp, tp = model
    toks = _rng(19).integers(0, cfg.vocab, size=(3, 5))
    jc, tc = jax_tf.init_cache(jcfg, 3, SEQ), tf.init_cache(cfg, 3, SEQ, "cpu")
    for t in range(toks.shape[1]):
        pos = np.array([t, t + 2, 2 * t], np.int32)
        jl, jc = jax_tf.decode_step(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1], jnp.int32)},
                                    jnp.asarray(pos), jcfg)
        tl, tc = tf.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                torch.from_numpy(pos), cfg)
        _close(jl, tl)
        np.testing.assert_array_equal(np.asarray(jl).argmax(-1), tl.numpy().argmax(-1))
    for a, b in zip(jax.tree.leaves(jc), _cache_leaves(tc)):
        _close(a, b)


def test_decode_chunk_matches_reference_decode_chunk(model):
    """Held against JAX's own `decode_chunk` (not its sequential steps,
    which the reference itself does not match bit for bit)."""
    jcfg, cfg, jp, tp = model
    toks = _rng(20).integers(1, cfg.vocab, size=(3, 6))
    pos0, take = np.array([0, 4, 2], np.int32), np.array([6, 3, 1], np.int32)
    active = np.array([True, True, False])
    jpk, jlg, jc = jax_tf.decode_chunk(jp, jax_tf.init_cache(jcfg, 3, SEQ),
                                       jnp.asarray(toks, jnp.int32), jnp.asarray(pos0),
                                       jnp.asarray(take), jcfg, active=jnp.asarray(active))
    pk, lg, tc = tf.decode_chunk(tp, tf.init_cache(cfg, 3, SEQ, "cpu"), torch.from_numpy(toks),
                                 torch.from_numpy(pos0), torch.from_numpy(take), cfg,
                                 active=torch.from_numpy(active))
    assert pk.shape == (3, 6) and lg.shape == (3, 6, cfg.vocab)
    for row in range(2):                                    # the active rows' columns
        cols = slice(0, take[row])
        np.testing.assert_array_equal(pk[row, cols].numpy(), np.asarray(jpk)[row, cols])
        _close(np.asarray(jlg)[row, cols], lg[row, cols])
    for a, b in zip(jax.tree.leaves(jc), _cache_leaves(tc)):
        _close(a, b)
        assert not b[:, 2].any()                            # the inactive row wrote nothing


def test_decode_chunk_is_sequential_steps_bit_for_bit(model):
    _, cfg, _, tp = model
    toks = torch.from_numpy(_rng(21).integers(1, cfg.vocab, size=(3, 5)))
    pos0, take = torch.tensor([1, 0, 3]), torch.tensor([5, 2, 4])
    picks, logits, chunk_cache = tf.decode_chunk(tp, tf.init_cache(cfg, 3, SEQ, "cpu"), toks, pos0,
                                                 take, cfg)
    cache = tf.init_cache(cfg, 3, SEQ, "cpu")
    for t in range(5):
        step, cache = tf.decode_step(tp, cache, {"tokens": toks[:, t:t + 1]}, pos0 + t, cfg,
                                     active=t < take)
        assert torch.equal(step[:, -1], logits[:, t])
        assert torch.equal(step[:, -1].argmax(-1), picks[:, t])
    for a, b in zip(_cache_leaves(cache), _cache_leaves(chunk_cache)):
        assert torch.equal(a, b)


def test_decode_chunk_masked_columns_past_the_cache_write_nothing():
    cfg = ArchConfig(**dict(GQA, n_layers=1))
    tp = tf.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    cache = tf.init_cache(cfg, 2, 8, "cpu")
    toks = torch.ones((2, 4), dtype=torch.long)
    # row 0 consumes positions 6 and 7; its masked columns reach 8 and 9
    tf.decode_chunk(tp, cache, toks, torch.tensor([6, 0]), torch.tensor([2, 4]), cfg)
    k = cache["periods"]["slot0"]["k"][0]
    assert k[0, 6:8].abs().sum() > 0 and not k[0, :6].any()
    assert k[1, :4].abs().sum() > 0 and not k[1, 4:].any()


def test_reset_and_rollback_cache_rows_match_reference():
    jcfg, cfg = jax_base.ArchConfig(**GQA), ArchConfig(**GQA)
    leaves = [_normal(22 + i, (2, 3, SEQ, 2, 16)) for i in range(2)]
    fresh = [_normal(30 + i, (2, 3, SEQ, 2, 16)) for i in range(2)]
    as_tree = lambda ls, f: {"periods": {"slot0": {"k": f(ls[0]), "v": f(ls[1])}}, "tail": ()}
    keep = np.array([True, False, True])
    ref = jax_tf.reset_cache_rows(as_tree(leaves, jnp.asarray), as_tree(fresh, jnp.asarray),
                                  jnp.asarray(keep))
    cache = as_tree(leaves, lambda a: torch.from_numpy(a.copy()))
    out = tf.reset_cache_rows(cache, as_tree(fresh, torch.from_numpy), torch.from_numpy(keep))
    assert out is cache
    for a, b in zip(jax.tree.leaves(ref), _cache_leaves(out)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    keep_len, rows = np.array([5, 0, 9], np.int32), np.array([True, False, True])
    ref = jax_tf.rollback_cache_rows(ref, jnp.asarray(keep_len), jnp.asarray(rows))
    tf.rollback_cache_rows(cache, torch.from_numpy(keep_len), torch.from_numpy(rows))
    for a, b in zip(jax.tree.leaves(ref), _cache_leaves(cache)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert not np.signbit(cache["periods"]["slot0"]["k"][:, 0, 5:].numpy()).any()


def test_quantized_lm_params_leaf_set_and_values_exact(model):
    _, _, jp, tp = model
    ref = jax_quantized(jp, 4)
    ours = quantized_lm_params(tp, 4)
    changed = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        t, raw = ours, tp
        for k in path:
            t, raw = t[k.key], raw[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf), err_msg=str(path))
        if t is not raw:
            changed.add(jax.tree_util.keystr(path))
    mlp = {f"['periods']['slot0']['mlp']['{w}']" for w in ("w_in", "w_gate", "w_out")}
    assert changed == {"['embed']['w_tok']"} | mlp
