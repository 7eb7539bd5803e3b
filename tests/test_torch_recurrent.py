"""The port's recurrent blocks (RG-LRU, mLSTM, sLSTM) against the JAX package's, on the CPU.

Weights come from the JAX package's initializers and cross with
`params_from_numpy`; inputs are numpy normals from a seed. Bars, and why:
- RG-LRU prefill 1e-4: the reference scans with `lax.associative_scan`,
  the port with a log-depth doubling scan, which round differently (the
  reference's own decode-vs-scan bar, `tests/test_blocks.py:89`); its decode
  step 1e-5 (the same operations in the same order, exp / sqrt an ulp
  apart);
- mLSTM chunked prefill 1e-4 against JAX and the sequential recurrence
  (exp-weighted sums over 4-8 positions), its decode 1e-5;
- sLSTM, the same step in a loop on both sides: 1e-5;
- cache resets and recurrent-row freezes: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.models import rglru as jax_rglru
from repro.models import transformer as jax_tf
from repro.models import xlstm as jax_xlstm
from repro_torch.configs.base import ArchConfig
from repro_torch.models import rglru, xlstm
from repro_torch.models import transformer as tf

B, S = 2, 16


def _close(ref, out, tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0, atol=tol)


def _x(seed, d, b=B, s=S, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(b, s, d)) * scale).astype(np.float32)


def _carry(jp):
    return tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _state(jstate):
    return {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}


def _decode_all(fn, x, state):
    """Run a block's decode step over every position; (outputs, state)."""
    outs = []
    for t in range(x.shape[1]):
        o, state = fn(x[:, t:t + 1], state)
        outs.append(o)
    cat = torch.cat if isinstance(x, torch.Tensor) else jnp.concatenate
    return cat(outs, 1), state


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rglru_weights():
    jp = jax_rglru.rglru_init(jax.random.PRNGKey(9), 24, 32, 4, jnp.float32)
    return jp, _carry(jp)


def test_rglru_init_matches_reference():
    ref = jax_rglru.rglru_init(jax.random.PRNGKey(0), 24, 32, 4, jnp.float32)
    ours = rglru.rglru_init(torch.Generator().manual_seed(0), 24, 32, 4, torch.float32,
                            "cpu", lead=(3,))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == (3, *v.shape) and ours[k].dtype == torch.float32, k
    _close(ref["lam"], ours["lam"][2].numpy(), 1e-7)


def test_rglru_block_matches_reference(rglru_weights):
    jp, tp = rglru_weights
    x = _x(10, 24)
    _close(jax_rglru.rglru_block(jp, jnp.asarray(x)), rglru.rglru_block(tp, torch.from_numpy(x)),
           1e-4)
    u = _x(11, 32)
    _close(jax_rglru.rglru_scan(jp, jnp.asarray(u)), rglru.rglru_scan(tp, torch.from_numpy(u)),
           1e-4)
    _close(jax_rglru._causal_conv1d(jnp.asarray(u), jp["w_conv"]),
           rglru._causal_conv1d(torch.from_numpy(u), tp["w_conv"]), 1e-6)


@pytest.mark.parametrize("s", [1, 5, 16])
def test_rglru_scan_equals_the_sequential_recurrence(rglru_weights, s):
    _, tp = rglru_weights
    u = torch.from_numpy(_x(12, 32, s=s))
    a, b = rglru._gates(tp, u)
    h, seq = torch.zeros(B, 32), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    _close(torch.stack(seq, 1), rglru.rglru_scan(tp, u), 1e-5)


def test_rglru_decode_matches_reference_and_the_scan(rglru_weights):
    jp, tp = rglru_weights
    x = _x(13, 24)
    jstate = jax_rglru.rglru_init_state(B, 32, 4, jnp.float32)
    state = rglru.rglru_init_state(B, 32, 4, torch.float32, "cpu")
    for t in range(4):                                        # one step at a time vs JAX
        jo, jstate = jax_rglru.rglru_block_decode(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        o, state = rglru.rglru_block_decode(tp, torch.from_numpy(x[:, t:t + 1]), state)
        _close(jo, o, 1e-5)
        for k in jstate:
            _close(jstate[k], state[k], 1e-5)
    dec, _ = _decode_all(lambda xt, st: rglru.rglru_block_decode(tp, xt, st),
                         torch.from_numpy(x), rglru.rglru_init_state(B, 32, 4, torch.float32,
                                                                     "cpu"))
    _close(rglru.rglru_block(tp, torch.from_numpy(x)), dec, 1e-4)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mlstm_weights():
    jp = jax_xlstm.mlstm_init(jax.random.PRNGKey(12), 32, 4, jnp.float32)
    return jp, _carry(jp)


@pytest.mark.parametrize("chunk", [4, 8])
def test_mlstm_chunked_matches_reference_and_the_sequential_recurrence(mlstm_weights, chunk):
    jp, tp = mlstm_weights
    x = _x(14, 32)
    out = xlstm.mlstm_block(tp, torch.from_numpy(x), 4, chunk=chunk)
    _close(jax_xlstm.mlstm_block(jp, jnp.asarray(x), 4, chunk=chunk), out, 1e-4)
    dec, _ = _decode_all(lambda xt, st: xlstm.mlstm_block_decode(tp, xt, st, 4),
                         torch.from_numpy(x), xlstm.mlstm_init_state(B, 32, 4, "cpu"))
    _close(dec, out, 1e-4)


def test_mlstm_chunk_must_divide_the_sequence(mlstm_weights):
    _, tp = mlstm_weights
    with pytest.raises(AssertionError):
        xlstm.mlstm_block(tp, torch.from_numpy(_x(15, 32, s=12)), 4, chunk=8)


def test_mlstm_decode_matches_reference(mlstm_weights):
    jp, tp = mlstm_weights
    x = _x(16, 32, s=5)
    jdec, jstate = _decode_all(lambda xt, st: jax_xlstm.mlstm_block_decode(jp, xt, st, 4),
                               jnp.asarray(x), jax_xlstm.mlstm_init_state(B, 32, 4))
    dec, state = _decode_all(lambda xt, st: xlstm.mlstm_block_decode(tp, xt, st, 4),
                             torch.from_numpy(x), xlstm.mlstm_init_state(B, 32, 4, "cpu"))
    _close(jdec, dec, 1e-5)
    for k in jstate:
        _close(jstate[k], state[k], 1e-5)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def test_slstm_block_matches_decode_and_reference():
    jp = jax_xlstm.slstm_init(jax.random.PRNGKey(14), 32, 4, jnp.float32)
    tp = _carry(jp)
    x = _x(17, 32)
    out = xlstm.slstm_block(tp, torch.from_numpy(x), 4)
    _close(jax_xlstm.slstm_block(jp, jnp.asarray(x), 4), out, 1e-5)
    jdec, jstate = _decode_all(lambda xt, st: jax_xlstm.slstm_block_decode(jp, xt, st, 4),
                               jnp.asarray(x), jax_xlstm.slstm_init_state(B, 32))
    dec, state = _decode_all(lambda xt, st: xlstm.slstm_block_decode(tp, xt, st, 4),
                             torch.from_numpy(x), xlstm.slstm_init_state(B, 32, "cpu"))
    _close(out, dec, 1e-5)
    _close(jdec, dec, 1e-5)
    for k in jstate:
        _close(jstate[k], state[k], 1e-5)


def test_xlstm_init_matches_reference():
    for jfn, fn in ((jax_xlstm.mlstm_init, xlstm.mlstm_init),
                    (jax_xlstm.slstm_init, xlstm.slstm_init)):
        ref = jfn(jax.random.PRNGKey(0), 32, 4, jnp.float32)
        ours = fn(torch.Generator().manual_seed(0), 32, 4, torch.float32, "cpu", lead=(2,))
        assert sorted(ours) == sorted(ref)
        for k, v in ref.items():
            assert tuple(ours[k].shape) == (2, *v.shape), k
        bias = "b_f" if "b_f" in ref else "b"
        np.testing.assert_array_equal(ours[bias][1].numpy(), np.asarray(ref[bias]))


# ---------------------------------------------------------------------------
# cache resets and frozen rows, on recurrent and tail leaves
# ---------------------------------------------------------------------------

HYBRID = dict(name="hybrid-small", family="hybrid", n_layers=5, d_model=16, n_heads=2,
              n_kv_heads=1, head_dim=8, d_ff=32, vocab=64, mlp_act="geglu",
              pattern=("rglru", "mlstm", "local_attn"), tail=("rglru", "slstm"), window=4,
              d_rnn=16, dtype="float32", remat="none")


def _random_like(cache, seed):
    """A cache tree (JAX) of random values with the tree of ``cache``."""
    leaves, treedef = jax.tree.flatten(cache)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [jnp.asarray(rng.normal(size=leaf.shape), leaf.dtype)
                                        for leaf in leaves])


def _port_tree(tree):
    return tf.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def test_reset_cache_rows_matches_reference_on_recurrent_and_tail_leaves():
    jcfg = jax_base.ArchConfig(**HYBRID)
    cache = _random_like(jax_tf.init_cache(jcfg, 3, 8), 20)
    fresh = jax_tf.init_cache(jcfg, 3, 8)
    keep = np.array([True, False, True])
    ref = jax_tf.reset_cache_rows(cache, fresh, jnp.asarray(keep))
    ours = _port_tree(cache)
    out = tf.reset_cache_rows(ours, _port_tree(fresh), torch.from_numpy(keep))
    assert out is ours and len(out["tail"]) == 2 and "h" in out["tail"][1]
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        t = out
        for k in path:
            t = t[k.key] if hasattr(k, "key") else t[k.idx]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf), err_msg=str(path))


@pytest.mark.parametrize("active", [None, [True, False, True]])
def test_freeze_state_rows_matches_reference_in_place(active):
    new = {"h": _x(30, 6, b=3, s=1)[:, 0], "conv": _x(31, 4, b=3, s=3)}
    old = {"h": _x(32, 6, b=3, s=1)[:, 0], "conv": _x(33, 4, b=3, s=3)}
    act = None if active is None else np.array(active)
    if act is None:
        ref = new
    else:
        ref = jax_tf._freeze_state_rows({k: jnp.asarray(v) for k, v in new.items()},
                                        {k: jnp.asarray(v) for k, v in old.items()},
                                        jnp.asarray(act))
    target = _state(old)
    views = dict(target)
    out = tf._freeze_state_rows(_state(new), target,
                                None if act is None else torch.from_numpy(act))
    assert out is target
    for k in ref:
        assert out[k] is views[k]                             # written in place
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


def test_decode_step_freezes_inactive_recurrent_rows():
    cfg = ArchConfig(**HYBRID)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    cache = tf.init_cache(cfg, 3, 8, "cpu")
    fresh = tf.init_cache(cfg, 3, 8, "cpu")
    tokens = torch.tensor([[1], [2], [3]])
    tf.decode_step(params, cache, {"tokens": tokens}, 0, cfg,
                   active=torch.tensor([True, False, True]))
    for (leaf, axis), (init, _) in zip(tf._leaves(cache), tf._leaves(fresh)):
        assert torch.equal(leaf.select(axis, 1), init.select(axis, 1))
        assert not torch.equal(leaf.select(axis, 0), init.select(axis, 0))
