"""LM training in the port against the JAX package, on the CPU: the loss.

Every registered arch is reduced as `tests/test_models_smoke.py` reduces it
(two periods plus the tail, d_model 48, 8 experts at top-k <= 2) and
initialized once in JAX; the tree crosses with `params_from_numpy` (norms
and biases bumped off their init so they are exercised), and JAX's own
`token_batch` crosses as numpy. Bars, and why:

- `train_loss`: 1e-4 relative; every gradient leaf: 1e-4 relative L2, the
  MoE aux term included (fp32 sums in other orders, XLA's and torch's exp /
  log an ulp apart, through two periods and the tail);
- the frontend archs' label slicing, `remat="full"` against `"none"`
  (loss, gradients, and the serving forward under ``no_grad``): exact.

The train step and the launcher: `tests/test_torch_lm_launch.py`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.data.synthetic import token_batch as jax_token_batch
from repro.models import frontends as jax_frontends
from repro.models import transformer as jax_tf
from repro_torch import configs
from repro_torch.models import transformer as tf
from repro_torch.train.train_step import value_and_grad
from repro_torch.train.tree import keystr, tree_leaves_with_path

ARCHS = sorted(jax_all_archs())
MOE = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b")
FRONTEND = tuple(a for a in ARCHS if jax_get_arch(a).frontend)
B, S = 2, 24
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


def _bumped(jp):
    """Norm scales and biases moved off their init, so they are exercised."""
    noise = iter(range(10_000))

    def bump(path, x):
        key = jax.tree_util.keystr(path)
        if "norm" in key or "['b" in key:
            rng = np.random.default_rng(next(noise))
            return x + jnp.asarray((rng.normal(size=x.shape) * 0.1).astype(np.float32))
        return x
    return jax.tree_util.tree_map_with_path(bump, jp)


def _jax_batch(cfg, seed=0, step=0, batch=B, seq=S):
    """The reference's training batch (its `token_batch`, and frontend
    embeddings where the arch has them) as numpy."""
    n_front = cfg.n_frontend_tokens if cfg.frontend else 0
    b = jax_token_batch(seed, step, batch, seq - n_front, cfg.vocab)
    if cfg.frontend:
        b["frontend_embeds"] = jax_frontends.synth_frontend(
            jax.random.fold_in(jax.random.PRNGKey(seed), step), cfg, batch)
    return jax.tree.map(np.asarray, b)


def _to_torch(batch):
    """A numpy batch for the port: int64 tokens and labels."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else np.array(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = _reduce(jax_get_arch(request.param))
    cfg = _reduce(configs.get_arch(request.param))
    jp = _bumped(jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, jp, tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _rel_l2(out, ref) -> float:
    return float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))


def _grads_close(grads, jgrads, tol=TOL):
    ref = {jax.tree_util.keystr(path): np.asarray(g)
           for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    out = {keystr(p): g.numpy() for p, g in tree_leaves_with_path(grads)}
    assert list(out) == list(ref)
    worst = max(ref, key=lambda k: _rel_l2(out[k], ref[k]))
    assert _rel_l2(out[worst], ref[worst]) <= tol, (worst, _rel_l2(out[worst], ref[worst]))


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------

def test_train_loss_and_grads_match_reference(model):
    jcfg, cfg, jp, params = model
    batch = _jax_batch(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_tf.train_loss), static_argnums=2)(
        jp, jax.tree.map(jnp.asarray, batch), jcfg)
    loss, grads = value_and_grad(functools.partial(tf.train_loss, cfg=cfg))(
        params, _to_torch(batch))
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    _grads_close(grads, jgrads)


@pytest.mark.parametrize("arch", MOE)
def test_aux_loss_gradients_match_reference(arch):
    """The load-balance term weighted 1 instead of 0.01, so that its router
    gradients weigh as much as the CE's: loss and gradients match."""
    jcfg = _reduce(jax_get_arch(arch))
    cfg = _reduce(configs.get_arch(arch))
    jp = jax_tf.init_params(jax.random.PRNGKey(1), jcfg)
    params = tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _jax_batch(jcfg, seed=3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_tf.train_loss(p, jax.tree.map(jnp.asarray, batch), jcfg, aux_weight=1.0)))(jp)
    loss, grads = value_and_grad(
        lambda p, b: tf.train_loss(p, b, cfg, aux_weight=1.0))(params, _to_torch(batch))
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    _grads_close(grads, jgrads)


@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_positions_carry_no_labels(arch):
    """The loss reads the logits after the frontend's positions only: equal,
    bit for bit, to the CE of the sliced logits against labels of the
    token positions' length."""
    cfg = _reduce(configs.get_arch(arch))
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = _to_torch(_jax_batch(_reduce(jax_get_arch(arch))))
    assert batch["labels"].shape == (B, S - cfg.n_frontend_tokens)
    with torch.no_grad():
        loss = tf.train_loss(params, batch, cfg)
        logits, aux = tf.forward(params, batch, cfg)
        assert logits.shape[1] == S
        tail = logits[:, cfg.n_frontend_tokens:].float()
        gold = torch.take_along_dim(tail, batch["labels"][..., None], dim=-1)[..., 0]
        manual = torch.mean(torch.logsumexp(tail, dim=-1) - gold) + 0.01 * aux
    assert torch.equal(loss, manual)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_equals_none(arch, monkeypatch):
    """`remat="full"` recomputes each period in the backward (twice the
    period blocks' calls) and changes no bit of the loss or gradients; the
    serving forward under ``no_grad`` checkpoints nothing."""
    cfg = _reduce(configs.get_arch(arch))
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = _to_torch(_jax_batch(_reduce(jax_get_arch(arch)), seed=1))
    calls = []
    apply_block = tf._apply_block
    monkeypatch.setattr(tf, "_apply_block", lambda *a: calls.append(a[0]) or apply_block(*a))
    out = {}
    for remat in ("none", "full"):
        c = cfg.with_(remat=remat)
        calls.clear()
        out[remat] = value_and_grad(lambda p, b: tf.train_loss(p, b, c))(params, batch)
        out[remat + " calls"] = len(calls)
        with torch.no_grad():
            calls.clear()
            out[remat + " logits"] = tf.forward(params, batch, c)[0]
            out[remat + " serve calls"] = len(calls)
    body = cfg.n_periods * len(cfg.pattern)
    assert out["none calls"] == body + len(cfg.tail)
    assert out["full calls"] == 2 * body + len(cfg.tail)
    assert out["none serve calls"] == out["full serve calls"] == body + len(cfg.tail)
    assert torch.equal(out["none logits"], out["full logits"])
    assert torch.equal(out["none"][0], out["full"][0])
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(out["none"][1]),
                                tree_leaves_with_path(out["full"][1])):
        assert pa == pb and torch.equal(a, b), pa
