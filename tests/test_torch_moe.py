"""The port's mixture-of-experts layer against the JAX package's, on the CPU.

Weights come from the JAX package's `moe_init` and cross with
`params_from_numpy`; inputs are numpy normals from a seed. Bars: y and the
aux loss within 1e-5 (fp32 sums of 16-32 terms in other orders, softmax
and silu an ulp apart), the routing's kept and dropped rows equal, and the
port's own repeat runs bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.models import moe
from repro_torch.models import transformer as tf

D = 16
TOL = 1e-5

# (name, moe_init kwargs, moe_apply kwargs)
CASES = {
    "swiglu-top2": (dict(n_experts=4, d_ff_e=32, act="swiglu"),
                    dict(top_k=2, act="swiglu", n_experts=4)),
    "sigmoid-top1-shared": (dict(n_experts=4, d_ff_e=24, act="swiglu", shared_expert=True,
                                 d_ff_shared=40),
                            dict(top_k=1, act="swiglu", n_experts=4)),
    "padded-gelu-top2": (dict(n_experts=3, d_ff_e=16, act="gelu", n_experts_padded=4),
                         dict(top_k=2, act="gelu", n_experts=3, n_experts_padded=4)),
    "relu2-top2": (dict(n_experts=5, d_ff_e=16, act="relu2"),
                   dict(top_k=2, act="relu2", n_experts=5, capacity_factor=2.0)),
}


def _weights(init_kw, seed=0):
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), D, dtype=jnp.float32, **init_kw)
    return jp, tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, b=2, s=8, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(b, s, D)) * scale).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(case):
    init_kw, apply_kw = CASES[case]
    jp, tp = _weights(init_kw)
    x = _x(1)
    ref_y, ref_aux = jax_moe.moe_apply(jp, jnp.asarray(x), **apply_kw)
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), **apply_kw)
    assert y.shape == x.shape and aux.shape == ()
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=0, atol=TOL)


def test_padded_experts_are_never_routed():
    init_kw, apply_kw = CASES["padded-gelu-top2"]
    _, tp = _weights(init_kw)
    x = torch.from_numpy(_x(2))
    y, _ = moe.moe_apply(tp, x, **apply_kw)
    zeroed = dict(tp, experts={k: v.clone() for k, v in tp["experts"].items()})
    for v in zeroed["experts"].values():
        v[3] = 0.0
    assert torch.equal(moe.moe_apply(zeroed, x, **apply_kw)[0], y)


def test_capacity_drops_the_reference_rows():
    """top-1 gelu, no shared expert: a dropped token's output is exactly 0,
    so the zero rows are the dropped ones; they must be JAX's, and some."""
    jp, tp = _weights(dict(n_experts=2, d_ff_e=16, act="gelu"), seed=3)
    x = _x(4, b=1, s=16, scale=1.0)
    kw = dict(top_k=1, act="gelu", n_experts=2, capacity_factor=0.25)
    ref_y, _ = jax_moe.moe_apply(jp, jnp.asarray(x), **kw)
    y, _ = moe.moe_apply(tp, torch.from_numpy(x), **kw)
    ref_dropped = np.all(np.asarray(ref_y)[0] == 0, axis=-1)
    dropped = (y[0] == 0).all(-1).numpy()
    np.testing.assert_array_equal(dropped, ref_dropped)
    assert 0 < dropped.sum() < dropped.size
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0, atol=TOL)


def test_routing_ties_go_to_the_lower_expert():
    """`lax.top_k` breaks ties toward the lower index; so does the port."""
    jp, _ = _weights(dict(n_experts=4, d_ff_e=16, act="gelu"), seed=5)
    router = np.asarray(jp["w_router"]).copy()
    router[:, 2] = router[:, 1]                  # experts 1 and 2 tie on every token
    router[:, 3] = router[:, 0]                  # and 0 and 3
    jp = dict(jp, w_router=jnp.asarray(router))
    tp = tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = _x(6)
    for top_k in (1, 3):
        kw = dict(top_k=top_k, act="gelu", n_experts=4, capacity_factor=4.0)
        ref_y, ref_aux = jax_moe.moe_apply(jp, jnp.asarray(x), **kw)
        y, aux = moe.moe_apply(tp, torch.from_numpy(x), **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0, atol=TOL)
        np.testing.assert_allclose(float(aux), float(ref_aux), rtol=0, atol=TOL)


def test_capacity_is_the_reference_float_arithmetic():
    # granite-moe-3b on 4 decode slots: 32 rows over 40 experts -> 8
    assert min(moe.round_up(int(32 / 40 * 1.25) + 1, 8), 32) == 8
    jp, tp = _weights(dict(n_experts=5, d_ff_e=8, act="gelu"))
    for s in (1, 3, 7, 16):
        x = _x(7, b=1, s=s)
        kw = dict(top_k=2, act="gelu", n_experts=5, capacity_factor=1.25)
        ref_y, _ = jax_moe.moe_apply(jp, jnp.asarray(x), **kw)
        y, _ = moe.moe_apply(tp, torch.from_numpy(x), **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0, atol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_calls_are_bit_identical(case):
    init_kw, apply_kw = CASES[case]
    _, tp = _weights(init_kw)
    x = torch.from_numpy(_x(8))
    y1, aux1 = moe.moe_apply(tp, x, **apply_kw)
    y2, aux2 = moe.moe_apply(tp, x.clone(), **apply_kw)
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)


def test_moe_init_tree_matches_reference():
    init_kw = dict(n_experts=3, d_ff_e=16, act="swiglu", shared_expert=True, d_ff_shared=24,
                   n_experts_padded=4)
    ref = jax.eval_shape(lambda: jax_moe.moe_init(jax.random.PRNGKey(0), D,
                                                  dtype=jnp.float32, **init_kw))
    ours = moe.moe_init(torch.Generator().manual_seed(0), D, dtype=torch.float32,
                        device="cpu", lead=(2,), **init_kw)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        t = ours
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == (2, *leaf.shape), path
    assert sorted(ours) == sorted(ref) and sorted(ours["experts"]) == sorted(ref["experts"])
