"""Every registered LM architecture, the port's model against the JAX package's, on the CPU.

Each of the JAX registry's ten archs is reduced as `tests/test_models_smoke.py`
reduces it (two periods plus the tail, d_model 48, 8 experts at top-k <= 2,
window 8, 4 frontend tokens of width 16) and initialized once in JAX; the
tree crosses to the port with `params_from_numpy` (norms and biases bumped
off their init so they are exercised). The same numpy inputs then go
through both packages. The CLI serves every arch on the CPU, and refuses
speculation on the recurrent ones with the reference's message. Serving
against JAX: `tests/test_torch_archs_serve.py`.

Bars, and why:
- configs, the init tree's paths and shapes, the `quantized_lm_params` leaf
  set and values: exact;
- logits, the MoE aux loss, caches and recurrent state: 1e-4 absolute on
  values of order one (fp32 sums in other orders, XLA's and torch's exp /
  sin / cos an ulp apart, the RG-LRU's log-depth scan against
  `lax.associative_scan`, through two periods and the tail); greedy picks
  and served streams equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jax_all_archs
from repro.configs import base as jax_base
from repro.configs import get_arch as jax_get_arch
from repro.models import frontends as jax_frontends
from repro.models import transformer as jax_tf
from repro.serve.runners.lm import LMRunner as JaxLMRunner
from repro.serve.runners.lm import quantized_lm_params as jax_quantized
from repro_torch import configs
from repro_torch.launch import serve as cli
from repro_torch.models import attention, frontends, layers, moe, rglru, xlstm
from repro_torch.models import transformer as tf
from repro_torch.serve.runners.lm import LMRunner, quantized_lm_params

ARCHS = sorted(jax_all_archs())
RECURRENT = ("recurrentgemma-2b", "xlstm-125m")
B, S, SEQ = 2, 24, 32
TOL = 1e-4


def _reduce(cfg):
    """`tests/test_models_smoke.py`'s cut (works on either package's config)."""
    kw = dict(dtype="float32", remat="none", d_model=48, head_dim=12, q_chunk=8, kv_chunk=8,
              mlstm_chunk=8, vocab=101, fsdp_experts=False)
    if cfg.d_ff:
        kw["d_ff"] = 96
    if cfg.moe_d_ff:
        kw["moe_d_ff"] = 32
    if cfg.d_rnn:
        kw["d_rnn"] = 48
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), n_experts_padded=0)
    if cfg.window:
        kw["window"] = 8
    if cfg.frontend:
        kw.update(n_frontend_tokens=4, d_frontend=16)
    kw["n_layers"] = 2 * len(cfg.pattern) + len(cfg.tail)
    return cfg.with_(**kw)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _bumped(jp):
    """Norm scales and biases moved off their init, so they are exercised."""
    noise = iter(range(10_000))

    def bump(path, x):
        key = jax.tree_util.keystr(path)
        if "norm" in key or "['b" in key:
            return x + jnp.asarray(_normal(next(noise), x.shape, 0.1))
        return x
    return jax.tree_util.tree_map_with_path(bump, jp)


def _at(tree, path):
    """The port's leaf at a JAX tree path (dict keys and tuple indices)."""
    for k in path:
        tree = tree[k.key] if hasattr(k, "key") else tree[k.idx]
    return tree


def _close(ref, out, tol=TOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0, atol=tol)


def _same_cache(ref, ours, tol=TOL):
    leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(leaves) == len(tf._leaves(ours))
    for path, leaf in leaves:
        _close(leaf, _at(ours, path).numpy(), tol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = _reduce(jax_get_arch(request.param))
    cfg = _reduce(configs.get_arch(request.param))
    jp = _bumped(jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, jp, tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, seed):
    """Numpy tokens (and frontend embeddings) for S positions in all."""
    n_front = cfg.n_frontend_tokens if cfg.frontend else 0
    batch = {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab, (B, S - n_front))}
    if cfg.frontend:
        batch["frontend_embeds"] = _normal(seed + 1, (B, n_front, cfg.d_frontend), 0.02)
    return batch


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    ours, ref = configs.get_arch(arch), jax_get_arch(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.hd, ours.n_periods) == (ref.hd, ref.n_periods)
    for name, shape in configs.SHAPES.items():
        assert configs.shape_applicable(ours, shape) == jax_base.shape_applicable(ref, shape)


def test_init_params_tree_matches_reference(model):
    jcfg, cfg, _, _ = model
    ref = jax.eval_shape(lambda: jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    ours = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    count = lambda t: sum(map(count, t.values())) if isinstance(t, dict) else \
        sum(map(count, t)) if isinstance(t, tuple) else 1
    assert len(leaves) == count(ours)
    assert len(ours["tail"]) == len(cfg.tail)
    for path, leaf in leaves:
        t = _at(ours, path)
        assert tuple(t.shape) == leaf.shape and str(t.dtype) == f"torch.{leaf.dtype}", path
    # the direct decay of RG-LRU is a linspace, the sLSTM bias a fixed split
    if "rglru" in cfg.pattern:
        ref_lam = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)["tail"][0]["rglru"]["lam"]
        _close(ref_lam, ours["tail"][0]["rglru"]["lam"].numpy(), 1e-7)
    if "slstm" in cfg.pattern:
        d = cfg.d_model
        b = ours["periods"]["slot1"]["slstm"]["b"]
        assert torch.equal(b[:, 2 * d:3 * d], torch.full_like(b[:, 2 * d:3 * d], 3.0))
        assert not b[:, :2 * d].any() and not b[:, 3 * d:].any()


def test_quantized_lm_params_leaf_set_and_values_exact(model):
    _, _, jp, tp = model
    ref = jax_quantized(jp, 4)
    ours = quantized_lm_params(tp, 4)
    changed, ref_changed = set(), set()
    raw = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        t = _at(ours, path)
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf), err_msg=str(path))
        if t is not _at(tp, path):
            changed.add(jax.tree_util.keystr(path))
        if not np.array_equal(np.asarray(leaf), np.asarray(raw[path])):
            ref_changed.add(jax.tree_util.keystr(path))
    assert changed == ref_changed and changed
    assert all("norm" not in k and "lam" not in k and "['r']" not in k for k in changed)


# every helper that allocates: the card unless the caller asks for the CPU
ALLOCATING = {
    "dense_init": lambda: layers.dense_init(torch.Generator(), 4, 4, torch.float32),
    "embed_init": lambda: layers.embed_init(torch.Generator(), 8, 4, torch.float32),
    "rmsnorm_init": lambda: layers.rmsnorm_init(4, torch.float32),
    "rope_freqs": lambda: layers.rope_freqs(8),
    "mlp_init": lambda: layers.mlp_init(torch.Generator(), 4, 8, "gelu", torch.float32),
    "attn_init": lambda: attention.attn_init(torch.Generator(), 8, 2, 1, 4, False,
                                             torch.float32),
    "init_kv_cache": lambda: attention.init_kv_cache(1, 4, 1, 4, torch.float32),
    "moe_init": lambda: moe.moe_init(torch.Generator(), 4, 2, 8, "gelu", torch.float32),
    "rglru_init": lambda: rglru.rglru_init(torch.Generator(), 4, 4, 4, torch.float32),
    "rglru_init_state": lambda: rglru.rglru_init_state(1, 4, 4, torch.float32),
    "mlstm_init": lambda: xlstm.mlstm_init(torch.Generator(), 4, 2, torch.float32),
    "mlstm_init_state": lambda: xlstm.mlstm_init_state(1, 4, 2),
    "slstm_init": lambda: xlstm.slstm_init(torch.Generator(), 4, 2, torch.float32),
    "slstm_init_state": lambda: xlstm.slstm_init_state(1, 4),
    "synth_frontend": lambda: frontends.synth_frontend(
        torch.Generator(), configs.get_arch("musicgen-large"), 1),
}


@pytest.mark.parametrize("helper", sorted(ALLOCATING))
def test_model_helpers_default_to_the_card(helper):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ALLOCATING[helper]()


# ---------------------------------------------------------------------------
# forward, decode, decode_chunk
# ---------------------------------------------------------------------------

def test_forward_matches_reference(model):
    jcfg, cfg, jp, tp = model
    batch = _batch(cfg, 18)
    ref, ref_aux = jax.jit(jax_tf.forward, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    out, aux = tf.forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert out.shape == (B, S, cfg.vocab)
    _close(ref, out)
    _close(ref_aux, aux)
    if cfg.n_experts:
        assert float(aux) > 0
    else:
        assert float(aux) == 0.0


def test_frontend_shapes_and_synthesized_embeddings(model):
    jcfg, cfg, _, _ = model
    spec = jax_frontends.frontend_spec(jcfg, 3)
    shape = frontends.frontend_shape(cfg, 3)
    emb = frontends.synth_frontend(torch.Generator().manual_seed(0), cfg, 3, "cpu")
    if spec is None:
        assert shape is None and emb is None
        return
    assert shape == spec.shape and emb.shape == spec.shape and emb.dtype == torch.float32
    assert 0.015 < emb.std().item() < 0.025


def test_decode_step_matches_reference(model):
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(19).integers(0, cfg.vocab, size=(3, 5))
    active = np.array([True, True, False])
    jc, tc = jax_tf.init_cache(jcfg, 3, SEQ), tf.init_cache(cfg, 3, SEQ, "cpu")
    step = jax.jit(jax_tf.decode_step, static_argnums=(4,))   # as the JAX runner jits it
    for t in range(toks.shape[1]):
        pos = np.array([t, t + 2, 2 * t], np.int32)
        act = active | (t % 2 == 0)
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1], jnp.int32)},
                      jnp.asarray(pos), jcfg, jnp.asarray(act))
        tl, tc = tf.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                torch.from_numpy(pos), cfg, active=torch.from_numpy(act))
        _close(jl, tl)
        np.testing.assert_array_equal(np.asarray(jl).argmax(-1), tl.numpy().argmax(-1))
    _same_cache(jc, tc)


def test_decode_chunk_matches_reference_decode_chunk(model):
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(20).integers(1, cfg.vocab, size=(3, 6))
    pos0, take = np.array([0, 4, 2], np.int32), np.array([6, 3, 1], np.int32)
    active = np.array([True, True, False])
    jpk, jlg, jc = jax.jit(jax_tf.decode_chunk, static_argnums=5)(
        jp, jax_tf.init_cache(jcfg, 3, SEQ), jnp.asarray(toks, jnp.int32), jnp.asarray(pos0),
        jnp.asarray(take), jcfg, jnp.asarray(active))
    fresh = tf.init_cache(cfg, 3, SEQ, "cpu")
    pk, lg, tc = tf.decode_chunk(tp, tf.init_cache(cfg, 3, SEQ, "cpu"), torch.from_numpy(toks),
                                 torch.from_numpy(pos0), torch.from_numpy(take), cfg,
                                 active=torch.from_numpy(active))
    for row in range(2):                                    # the active rows' columns
        cols = slice(0, take[row])
        np.testing.assert_array_equal(pk[row, cols].numpy(), np.asarray(jpk)[row, cols])
        _close(np.asarray(jlg)[row, cols], lg[row, cols])
    _same_cache(jc, tc)
    for (leaf, axis), (init, _) in zip(tf._leaves(tc), tf._leaves(fresh)):
        # the inactive row advanced no cache: KV entries or recurrent state
        assert torch.equal(leaf.select(axis, 2), init.select(axis, 2))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_speculation_refused_with_the_reference_message(arch):
    jcfg, cfg = _reduce(jax_get_arch(arch)), _reduce(configs.get_arch(arch))
    with pytest.raises(AssertionError) as ref:
        JaxLMRunner(jcfg, None, speculate_k=4)
    with pytest.raises(AssertionError) as ours:
        LMRunner(cfg, None, speculate_k=4, device="cpu")
    assert str(ours.value) == str(ref.value) and "cannot roll back" in str(ours.value)
    with pytest.raises(AssertionError, match="cannot roll back"):
        cli.main(["--workload", "lm", "--device", "cpu", "--arch", arch, "--speculate", "4"])


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_every_arch_on_cpu(arch, capsys):
    cli.main(["--workload", "lm", "--device", "cpu", "--arch", arch, "--tokens", "3",
              "--requests", "3", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert sum("status=ok" in line for line in out.splitlines()) == 3
    assert "'decode_tokens': 9" in out
