"""The port's training path against the JAX package: surrogate spike, QAT
fake-quant, coding, sparsity stats, the BPTT forward and loss, optimizers,
schedules, the train step, checkpoints, the loop and the training driver.

Inputs are numpy from a seed and weights come from the JAX init; the two
packages' random generators differ, so where the reference draws (rate
coding) the port is handed the reference's draw. Bars: elementwise
gradients rtol 1e-6; `vgg9_forward` logits 1e-5 and spike counts exact;
`vgg9_loss` 1e-6 and its gradients rtol 1e-4 / atol 1e-6 (XLA's CPU
convolution and `F.conv2d` sum in different orders); one AdamW step from a
mid-training state: params within 1e-6.

LM trees (reduced as `tests/test_models_smoke.py` reduces them): tuples
are nodes, so key paths and leaf order equal JAX's ``keystr`` walk; each
optimizer steps such a tree within 1e-6 of JAX's; every arch takes one
train step; fp32 checkpoints cross both ways and bf16 ones from JAX to the
port bit for bit, a port-written bf16 checkpoint has JAX's manifest and
member bytes, and an LM crash -> resume equals the clean run bit for bit.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import all_archs as jax_all_archs
from repro.configs import vgg9_snn as jax_cfgs
from repro.core import coding as jax_coding
from repro.core import sparsity as jax_sparsity
from repro.core.lif import LIFParams as JaxLIFParams
from repro.core.lif import leaky_integrate as jax_leaky_integrate
from repro.core.lif import lif_scan as jax_lif_scan
from repro.core.lif import spike_surrogate as jax_spike_surrogate
from repro.core.quant import fake_quant as jax_fake_quant
from repro.core.quant import qat_params as jax_qat_params
from repro.models import transformer as jax_lm
from repro.models import vgg9 as jax_vgg9
from repro.train import checkpoint as jax_ckpt
from repro.train import optim as jax_optim
from repro.train import schedule as jax_schedule
from repro.train import train_step as jax_train_step
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.configs import vgg9_snn as torch_cfgs
from repro_torch.core import coding, sparsity
from repro_torch.core.lif import LIFParams, leaky_integrate, lif_scan, spike_surrogate
from repro_torch.core.quant import fake_quant, qat_params
from repro_torch.data.synthetic import image_batch, token_batch
from repro_torch.launch import train_vgg9
from repro_torch.models import transformer as lm
from repro_torch.models import vgg9
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim, schedule
from repro_torch.train.loop import TrainLoop
from repro_torch.train.train_step import init_train_state, make_train_step, value_and_grad
from repro_torch.train.tree import keystr, tree_leaves_with_path, tree_map

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_vgg9.init_vgg9(jax.random.PRNGKey(0), jax_cfgs.TINY))


def _batch(seed, n=4, num_classes=4):
    rng = np.random.default_rng(seed)
    return {"images": rng.random((n, 16, 16, 3)).astype(np.float32),
            "labels": rng.integers(0, num_classes, n).astype(np.int32)}


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _assert_trees_close(out, ref, **tol):
    """``out`` a tree of tensors, ``ref`` one of arrays with the same paths."""
    ref_leaves = dict(tree_leaves_with_path(jax.tree.map(np.asarray, ref)))
    out_leaves = dict(tree_leaves_with_path(out))
    assert set(out_leaves) == set(ref_leaves)
    for path, r in ref_leaves.items():
        o = out_leaves[path].detach().cpu().numpy()
        assert o.dtype == r.dtype and o.shape == r.shape, path
        np.testing.assert_allclose(o, r, err_msg=str(path), **tol)


# ---------------------------------------------------------------------------
# Surrogate spike, LIF scans, fake-quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slope", [25.0, 5.0])
def test_spike_surrogate_forward_and_grad(slope):
    u, g = _normal(0, (64, 33)), _normal(1, (64, 33))
    u[0, :4] = 0.5                                          # exactly at theta
    ref_s = jax_spike_surrogate(jnp.asarray(u), 0.5, slope)
    ref_g = jax.grad(lambda x: jnp.sum(jax_spike_surrogate(x, 0.5, slope) * g))(jnp.asarray(u))
    ut = torch.from_numpy(u).requires_grad_(True)
    s = spike_surrogate(ut, 0.5, slope)
    (s * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(ref_s))
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(ref_g), rtol=1e-6)


def test_lif_scan_matches_reference():
    cur = _normal(2, (5, 32, 24), 0.7)
    ref_s, ref_u = jax_lif_scan(jnp.asarray(cur), JaxLIFParams())
    s, u = lif_scan(torch.from_numpy(cur), LIFParams())
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ref_u))


@pytest.mark.parametrize("decay", ["float", "tensor"])
def test_leaky_integrate_matches_reference(decay):
    x = _normal(3, (6, 40))
    d = 0.37 if decay == "float" else np.abs(_normal(4, (40,), 0.5))
    ref_h, ref_last = jax_leaky_integrate(d if decay == "float" else jnp.asarray(d),
                                          jnp.asarray(x))
    h, last = leaky_integrate(d if decay == "float" else torch.from_numpy(d),
                              torch.from_numpy(x))
    np.testing.assert_array_equal(h.numpy(), np.asarray(ref_h))
    np.testing.assert_array_equal(last.numpy(), np.asarray(ref_last))


@pytest.mark.parametrize("bits,axis", [(4, None), (8, None), (4, 0), (4, (0, 1, 2))])
def test_fake_quant_forward_and_ste(bits, axis):
    w, g = _normal(5, (3, 3, 8, 16)), _normal(6, (3, 3, 8, 16))
    ref = jax_fake_quant(jnp.asarray(w), bits, axis)
    ref_g = jax.grad(lambda x: jnp.sum(jax_fake_quant(x, bits, axis) * g))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    out = fake_quant(wt, bits, axis)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_g), rtol=1e-6)


def test_qat_params_matches_reference():
    tree = {"layer": {"w": _normal(7, (4, 6)), "b": _normal(8, (6,), 0.1),
                      "beta": np.float32(0.15) * np.ones(3, np.float32)},
            "w_out": _normal(9, (6, 2))}
    ref = jax_qat_params(jax.tree.map(jnp.asarray, tree))
    out = qat_params(jax.tree.map(torch.from_numpy, tree))
    _assert_trees_close(out, ref, rtol=0, atol=0)


def test_quantized_view_is_differentiable(jax_params):
    params = vgg9.params_from_numpy(jax_params, "cpu")
    w = params["conv1"]["w"].clone().requires_grad_(True)
    qp = vgg9.quantized_view(dict(params, conv1={"w": w, "b": params["conv1"]["b"]}),
                             torch_cfgs.TINY_INT4)
    qp["conv1"]["w"].sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))


# ---------------------------------------------------------------------------
# Coding and sparsity stats
# ---------------------------------------------------------------------------

def test_direct_code_and_counts_match_reference():
    x = _normal(10, (2, 4, 4, 3))
    np.testing.assert_array_equal(coding.direct_code(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(jax_coding.direct_code(jnp.asarray(x), 3)))
    s = (np.random.default_rng(11).random((3, 50)) < 0.2).astype(np.float32)
    assert int(coding.spike_count(torch.from_numpy(s))) == int(jax_coding.spike_count(s))
    np.testing.assert_allclose(float(coding.sparsity(torch.from_numpy(s))),
                               float(jax_coding.sparsity(jnp.asarray(s))), rtol=1e-7)


def test_rate_code_draws_bernoulli_trains():
    x = torch.full((8, 16, 16, 3), 0.3)
    x[0] = 2.0                                               # clipped to rate 1
    x[1] = -1.0                                              # clipped to rate 0
    a = coding.rate_code(torch.Generator().manual_seed(5), x, 4)
    b = coding.rate_code(torch.Generator().manual_seed(5), x, 4)
    assert a.shape == (4,) + tuple(x.shape) and torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 1.0}
    assert bool((a[:, 0] == 1).all()) and bool((a[:, 1] == 0).all())
    assert abs(float(a[:, 2:].mean()) - 0.3) < 0.01


def test_spike_stats_match_reference():
    rng = np.random.default_rng(12)
    layers = {"conv0": (rng.random((2, 8, 8, 4)) < 0.3).astype(np.float32),
              "fc0": (rng.random((2, 32)) < 0.1).astype(np.float32)}
    ref, out = jax_sparsity.SpikeStats.empty(), sparsity.SpikeStats.empty()
    for name, s in layers.items():
        ref, out = ref.record(name, jnp.asarray(s)), out.record(name, torch.from_numpy(s))
    assert float(out.total_spikes()) == float(ref.total_spikes())
    for k, v in ref.layer_sparsity().items():
        np.testing.assert_allclose(float(out.layer_sparsity()[k]), float(v), rtol=1e-7)
    assert {k: float(v) for k, v in out.sizes.items()} == {k: float(v) for k, v in ref.sizes.items()}


@pytest.mark.parametrize("shape,tile", [((4, 300), 128), ((2, 3, 256), 128), ((5, 7), 4)])
def test_tile_occupancy_matches_reference(shape, tile):
    s = (np.random.default_rng(13).random(shape) < 0.01).astype(np.float32)
    np.testing.assert_allclose(float(sparsity.tile_occupancy(torch.from_numpy(s), tile)),
                               float(jax_sparsity.tile_occupancy(jnp.asarray(s), tile)),
                               rtol=1e-7)


def test_configs_match_reference():
    assert dataclasses.asdict(torch_cfgs.RATE_CIFAR10) == dataclasses.asdict(jax_cfgs.RATE_CIFAR10)
    assert torch_cfgs.LW_ALLOCATIONS == jax_cfgs.LW_ALLOCATIONS
    assert torch_cfgs.PERF2_CIFAR100 == jax_cfgs.PERF2_CIFAR100


# ---------------------------------------------------------------------------
# The BPTT forward and the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,hoist", [("TINY", True), ("TINY", False), ("TINY_INT4", True)])
def test_forward_matches_reference(jax_params, name, hoist):
    jcfg = dataclasses.replace(getattr(jax_cfgs, name), hoist_input_conv=hoist)
    tcfg = dataclasses.replace(getattr(torch_cfgs, name), hoist_input_conv=hoist)
    images = _batch(14)["images"]
    ref_logits, ref_counts = jax_vgg9.vgg9_forward(jax_params, jnp.asarray(images), jcfg)
    logits, counts = vgg9.vgg9_forward(vgg9.params_from_numpy(jax_params, "cpu"), images, tcfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=1e-5)
    assert {k: int(v) for k, v in counts.items()} == {k: int(v) for k, v in ref_counts.items()}


def test_forward_rate_coding_on_the_reference_draw(jax_params, monkeypatch):
    jcfg = dataclasses.replace(jax_cfgs.TINY, coding="rate", timesteps=4)
    tcfg = dataclasses.replace(torch_cfgs.TINY, coding="rate", timesteps=4)
    images = _batch(15)["images"]
    key = jax.random.PRNGKey(3)
    drawn = np.asarray(jax_coding.rate_code(key, jnp.asarray(images), 4))
    monkeypatch.setattr(vgg9, "rate_code", lambda gen, x, t: torch.from_numpy(drawn.copy()))
    ref_logits, ref_counts = jax_vgg9.vgg9_forward(jax_params, jnp.asarray(images), jcfg,
                                                   rng=key)
    logits, counts = vgg9.vgg9_forward(vgg9.params_from_numpy(jax_params, "cpu"), images,
                                       tcfg, generator=torch.Generator())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=1e-5)
    assert {k: int(v) for k, v in counts.items()} == {k: int(v) for k, v in ref_counts.items()}


def test_rate_coding_needs_a_generator(jax_params):
    cfg = dataclasses.replace(torch_cfgs.TINY, coding="rate")
    with pytest.raises(ValueError, match="generator"):
        vgg9.vgg9_forward(vgg9.params_from_numpy(jax_params, "cpu"), _batch(0)["images"], cfg)


@pytest.mark.parametrize("name", ["TINY", "TINY_INT4"])
def test_loss_value_and_grad_match_reference(jax_params, name):
    jcfg, tcfg = getattr(jax_cfgs, name), getattr(torch_cfgs, name)
    batch = _batch(16)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_vgg9.vgg9_loss(p, jax.tree.map(jnp.asarray, batch), jcfg)))(jax_params)
    params = vgg9.params_from_numpy(jax_params, "cpu")
    loss, grads = value_and_grad(lambda p, b: vgg9.vgg9_loss(p, b, tcfg))(params, batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    _assert_trees_close(grads, ref_grads, rtol=1e-4, atol=1e-6)
    for path, g in tree_leaves_with_path(jax.tree.map(np.asarray, ref_grads)):
        out = dict(tree_leaves_with_path(grads))[path].numpy()
        assert np.abs(out - g).max() <= 1e-4 * np.abs(g).max(), path
    assert all(p.grad is None for leaf in params.values() for p in leaf.values())


# ---------------------------------------------------------------------------
# Optimizers, schedules, the train step
# ---------------------------------------------------------------------------

def _opt_tree(seed):
    return {"a": {"w": _normal(seed, (6, 5)), "b": _normal(seed + 1, (5,))},
            "c": _normal(seed + 2, (3, 4, 2))}


@pytest.mark.parametrize("name,kw", [("sgd", dict(momentum=0.9, weight_decay=0.01)),
                                     ("adamw", dict(weight_decay=0.1)),
                                     ("adafactor", dict(weight_decay=0.01))])
def test_optimizer_updates_match_reference(name, kw):
    jopt, topt = jax_optim.make_optimizer(name, **kw), optim.make_optimizer(name, **kw)
    jp = jax.tree.map(jnp.asarray, _opt_tree(20))
    tp = jax.tree.map(torch.from_numpy, _opt_tree(20))
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = _opt_tree(30 + 3 * i)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.asarray(0.01))
        tu, ts = topt.update(jax.tree.map(torch.from_numpy, g), ts, tp,
                             torch.tensor(0.01))
        jp, tp = jax_optim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
    _assert_trees_close(tp, jp, rtol=1e-5, atol=1e-7)
    _assert_trees_close(ts, js, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizer_descends_quadratic(name):
    opt = optim.make_optimizer(name, weight_decay=0.0) if name != "sgd" else optim.sgd(0.9, 0.0)
    params = {"w": torch.tensor([3.0, -2.0]), "m": torch.ones((4, 4)) * 2}
    loss_fn = lambda p, b: torch.sum(p["w"] ** 2) + torch.sum(p["m"] ** 2)
    state = opt.init(params)
    grad_fn = value_and_grad(loss_fn)
    for _ in range(150):
        _, g = grad_fn(params, {})
        upd, state = opt.update(g, state, params, torch.tensor(0.05))
        params = optim.apply_updates(params, upd)
    assert float(loss_fn(params, {})) < 0.2


def test_adafactor_memory_is_factored():
    state = optim.adafactor().init({"w": torch.zeros((128, 256))})
    assert sum(x.numel() for _, x in tree_leaves_with_path(state["s"])) == 128 + 256


@pytest.mark.parametrize("max_norm", [1.0, 0.3, 50.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _opt_tree(40)
    ref, ref_norm = jax_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    out, norm = optim.clip_by_global_norm(jax.tree.map(torch.from_numpy, g), max_norm)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    _assert_trees_close(out, ref, rtol=1e-6)


def test_schedules_match_reference():
    ref, out = jax_schedule.warmup_cosine(3e-3, 20, 200), schedule.warmup_cosine(3e-3, 20, 200)
    for step in [0, 1, 9, 19, 20, 21, 57, 110, 199, 250]:
        np.testing.assert_allclose(float(out(torch.tensor(step, dtype=torch.int32))),
                                   float(ref(jnp.int32(step))), rtol=1e-6)
    assert float(schedule.constant(0.5)(torch.tensor(123))) == 0.5
    lr = schedule.warmup_cosine(1.0, 10, 100, min_ratio=0.1)
    assert float(lr(0)) < float(lr(9)) and float(lr(99)) < 0.2


def test_train_step_from_mid_training_state_matches_reference(jax_params):
    """Two reference steps, then one step in each package from the same
    state (params, AdamW m/v/t, step) with clipping active."""
    jcfg, tcfg = jax_cfgs.TINY_INT4, torch_cfgs.TINY_INT4
    jopt, topt = jax_optim.adamw(weight_decay=0.1), optim.adamw(weight_decay=0.1)
    kw = dict(clip_norm=0.02)
    jstep = jax.jit(jax_train_step.make_train_step(
        lambda p, b: jax_vgg9.vgg9_loss(p, b, jcfg), jopt,
        jax_schedule.warmup_cosine(3e-3, 2, 10), **kw))
    state = jax_train_step.init_train_state(jax.tree.map(jnp.asarray, jax_params), jopt)
    for i in range(2):
        state, _ = jstep(state, jax.tree.map(jnp.asarray, _batch(17 + i)))
    tstate = vgg9.train_state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    assert tstate["step"].dtype == torch.int32 and int(tstate["opt"]["t"]) == 2

    batch = _batch(19)
    ref_state, ref_m = jstep(state, jax.tree.map(jnp.asarray, batch))
    tstep = make_train_step(lambda p, b: vgg9.vgg9_loss(p, b, tcfg), topt,
                            schedule.warmup_cosine(3e-3, 2, 10), **kw)
    new_state, m = tstep(tstate, batch)
    assert float(ref_m["grad_norm"]) > kw["clip_norm"]       # clipping is active
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]), rtol=1e-6)
    _assert_trees_close(new_state["params"], ref_state["params"], rtol=0, atol=1e-6)
    assert int(new_state["step"]) == int(ref_state["step"]) == 3
    assert int(new_state["opt"]["t"]) == 3
    # the input state is left as it was
    _assert_trees_close(tstate["params"], state["params"], rtol=0, atol=0)


def test_grad_accumulation_matches_full_batch(jax_params):
    cfg = torch_cfgs.TINY
    opt = optim.sgd(momentum=0.0, weight_decay=0.0)
    loss_fn = lambda p, b: vgg9.vgg9_loss(p, b, cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(21, n=8).items()}
    s0 = init_train_state(vgg9.params_from_numpy(jax_params, "cpu"), opt)
    s_full, m_full = make_train_step(loss_fn, opt, schedule.constant(0.1))(s0, batch)
    s_acc, m_acc = make_train_step(loss_fn, opt, schedule.constant(0.1), accum_steps=2)(s0, batch)
    np.testing.assert_allclose(float(m_full["loss"]), float(m_acc["loss"]), rtol=1e-6)
    for name, leaf in s_full["params"].items():
        for k, v in leaf.items():
            np.testing.assert_allclose(s_acc["params"][name][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-8)


def test_train_step_refuses_distribution_options():
    """The distribution options on one device: gradient shardings hold
    DTensor gradients to a layout, and plain ones have none to hold, so
    the step's bits do not move (the layouts themselves:
    `tests/test_torch_tp.py`); a compressed step needs a process group to
    reduce over and raises without one; the compressed state and the
    gradient dtype cast work."""
    opt = optim.sgd()
    loss = lambda p, b: (p["w"] ** 2).sum()  # noqa: E731
    state0 = init_train_state({"w": torch.ones(2)}, opt)
    plain, _ = make_train_step(loss, opt, schedule.constant(0.1))(state0, {})
    held, _ = make_train_step(loss, opt, schedule.constant(0.1),
                              grad_shardings={"w": None})(state0, {})
    assert torch.equal(plain["params"]["w"], held["params"]["w"])
    assert torch.equal(plain["opt"]["mu"]["w"], held["opt"]["mu"]["w"])
    state = init_train_state({"w": torch.ones(2)}, opt, compress=True)
    assert torch.equal(state["grad_err"]["w"], torch.zeros(2))
    step = make_train_step(loss, opt, schedule.constant(0.1), compress_axis="data")
    with pytest.raises(RuntimeError, match="process group"):
        step(state, {})
    cast = make_train_step(loss, opt, schedule.constant(0.1), grad_dtype="bfloat16")
    new, _ = cast(init_train_state({"w": torch.ones(2)}, opt), {})
    assert new["opt"]["mu"]["w"].dtype == torch.float32 and float(new["params"]["w"][0]) < 1.0


def _deterministic_flags():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)


def test_train_step_runs_deterministic():
    """The step and `value_and_grad` run their loss and backward with
    deterministic algorithms and cuDNN's deterministic, untuned convolutions
    (what makes two card steps from one state bit-identical; the card test
    in `tests/test_torch_cuda.py` holds that), restore the caller's settings
    afterwards, and the package fixes cuBLAS's workspace."""
    seen = []

    def loss_fn(params, batch):
        seen.append(_deterministic_flags())
        return torch.sum((params["w"] - batch["x"]) ** 2)

    before = _deterministic_flags()
    opt = optim.adamw(weight_decay=0.0)
    step = make_train_step(loss_fn, opt, schedule.constant(0.1), accum_steps=2)
    state, _ = step(init_train_state({"w": torch.zeros(4)}, opt), {"x": torch.ones(2, 4)})
    value_and_grad(loss_fn)(state["params"], {"x": torch.ones(4)})
    assert seen == [(True, True, False)] * 3
    assert _deterministic_flags() == before
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] in (":4096:8", ":16:8")


# ---------------------------------------------------------------------------
# Checkpoints and the loop
# ---------------------------------------------------------------------------

def _state_pair(jax_params):
    opt = jax_optim.adamw()
    jstate = jax_train_step.init_train_state(jax.tree.map(jnp.asarray, jax_params), opt)
    jstate = dict(jstate, step=jnp.asarray(7, jnp.int32),
                  opt=dict(jstate["opt"], t=jnp.asarray(7, jnp.int32),
                           m=jax.tree.map(lambda x: x + 0.25, jstate["opt"]["m"])))
    template = init_train_state(vgg9.params_from_numpy(jax_params, "cpu"), optim.adamw())
    return jstate, template


def test_checkpoint_written_by_reference_restores_identically(jax_params, tmp_path):
    jstate, template = _state_pair(jax_params)
    jax_ckpt.save(str(tmp_path), 7, jstate)
    assert ckpt.latest_step(str(tmp_path)) == 7
    out = ckpt.restore(str(tmp_path), 7, template)
    _assert_trees_close(out, jstate, rtol=0, atol=0)


def test_checkpoint_written_by_port_restores_in_reference(jax_params, tmp_path):
    jstate, template = _state_pair(jax_params)
    state = vgg9.train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    ckpt.save(str(tmp_path), 7, state)
    out = jax_ckpt.restore(str(tmp_path), 7, jax.eval_shape(lambda: jstate))
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"params": {"w": torch.arange(12.0).reshape(3, 4)}})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1, {"params": {"w": torch.zeros((2, 2))}})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 1, {"params": {"v": torch.zeros((3, 4))}})


def test_checkpoint_keep_k_and_atomic_publish(tmp_path):
    for s in range(5):
        ckpt.save(str(tmp_path), s, {"w": torch.full((2,), float(s))}, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4]
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp.123"))
    assert ckpt.latest_step(str(tmp_path)) == 4


def _make_training(ckpt_dir):
    opt = optim.adamw(weight_decay=0.0)
    target = torch.from_numpy(_normal(3, (8,)))

    def loss_fn(params, batch):
        return torch.sum((params["w"] * batch["x"] - batch["y"]) ** 2)

    def make_batch(i):
        x = torch.randn(8, generator=torch.Generator().manual_seed(i))
        return {"x": x, "y": x * target}

    loop = TrainLoop(make_train_step(loss_fn, opt, schedule.constant(0.05)), make_batch,
                     ckpt_dir=str(ckpt_dir), ckpt_every=5, log_every=100,
                     log_fn=lambda *a: None)
    return loop, init_train_state({"w": torch.zeros(8)}, opt)


def test_loss_decreases(tmp_path):
    loop, state = _make_training(tmp_path)
    loop.run(state, 120)
    assert loop.history[-1][1]["loss"] < loop.history[0][1]["loss"] * 0.3


def test_crash_resume_bit_identical(tmp_path):
    loop1, s1 = _make_training(tmp_path / "clean")
    final1 = loop1.run(s1, 20)

    loop2, s2 = _make_training(tmp_path / "crash")
    with pytest.raises(RuntimeError, match="simulated"):
        loop2.run(s2, 20, fail_at_step=12)
    restored, start = loop2.maybe_restore(s2)
    assert start == 10
    final2 = loop2.run(restored, 20, start_step=start)
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(final1), tree_leaves_with_path(final2)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa


# ---------------------------------------------------------------------------
# Data and the training driver
# ---------------------------------------------------------------------------

def test_image_batch_is_keyed_by_seed_and_step():
    a, b = image_batch(0, 3, 6, num_classes=4, hw=16), image_batch(0, 3, 6, num_classes=4, hw=16)
    c = image_batch(0, 4, 6, num_classes=4, hw=16)
    assert a["images"].shape == (6, 16, 16, 3) and a["images"].dtype == torch.float32
    assert torch.equal(a["images"], b["images"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["images"], c["images"])
    assert float(a["images"].min()) >= 0.0 and float(a["images"].max()) <= 1.0
    assert 0 <= int(a["labels"].min()) and int(a["labels"].max()) < 4


def test_training_driver_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train_vgg9",
                          "--device", "cpu", "--steps", "3", "--int4",
                          "--ckpt-dir", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step 2: loss=" in out.stdout
    assert "per-layer spikes" in out.stdout and "hybrid plan" in out.stdout
    assert "hybrid kernels match reference:" in out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_training_driver_resumes(tmp_path, capsys):
    train_vgg9.main(["--device", "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path)])
    result = train_vgg9.main(["--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path)])
    assert "resumed from checkpoint at step 2" in capsys.readouterr().out
    assert [s for s, _ in result["history"]] == [2]
    assert set(result["spikes"]) == set(vgg9.conv_names(torch_cfgs.TINY) + ["fc0", "fc1"])


def test_training_driver_on_the_card_without_one_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_vgg9.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# LM trees: tuple nodes, bf16 leaves, checkpoints
# ---------------------------------------------------------------------------

LM_ARCHS = sorted(jax_all_archs())


def _lm_reduce(cfg, dtype="float32"):
    """`tests/test_models_smoke.py`'s cut of an LM arch (either package's
    config), at ``dtype``."""
    kw = dict(dtype=dtype, remat="none", d_model=48, head_dim=12, q_chunk=8, kv_chunk=8,
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


@functools.lru_cache(maxsize=None)
def _jax_lm_params(arch, dtype="float32"):
    """The reference's init of a reduced LM (immutable arrays, so shared)."""
    return jax_lm.init_params(jax.random.PRNGKey(0), _lm_reduce(jax_get_arch(arch), dtype))


def _jax_lm_state(arch, dtype="float32"):
    """A mid-training reference AdamW state of a reduced LM (step 7, moments
    moved off zero)."""
    opt = jax_optim.adamw()
    jstate = jax_train_step.init_train_state(_jax_lm_params(arch, dtype), opt)
    return dict(jstate, step=jnp.asarray(7, jnp.int32),
                opt=dict(jstate["opt"], t=jnp.asarray(7, jnp.int32),
                         m=jax.tree.map(lambda x: x + 0.25, jstate["opt"]["m"]),
                         v=jax.tree.map(lambda x: x + 0.5, jstate["opt"]["v"])))


def _port_lm_state(jstate):
    """The reference state as the port's (bf16 leaves cross as bits)."""
    tree = jax.tree.map(np.asarray, jstate)
    return {"params": lm.params_from_numpy(tree["params"], "cpu"),
            "opt": {"m": lm.params_from_numpy(tree["opt"]["m"], "cpu"),
                    "v": lm.params_from_numpy(tree["opt"]["v"], "cpu"),
                    "t": torch.from_numpy(np.array(tree["opt"]["t"]))},
            "step": torch.from_numpy(np.array(tree["step"]))}


def _bits(x):
    """A leaf's bit patterns, for exact comparison of any float dtype."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 and x.dtype.kind == "V" else x


def _same_bits(ours, ref):
    """A port tree and a reference tree: the same key paths in the same
    order, and every leaf's dtype, shape and bits equal."""
    ref_leaves = [(jax.tree_util.keystr(p), x)
                  for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]]
    our_leaves = [(keystr(p), x) for p, x in tree_leaves_with_path(ours)]
    assert [k for k, _ in our_leaves] == [k for k, _ in ref_leaves]
    for (key, a), (_, b) in zip(our_leaves, ref_leaves):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_tree_paths_are_the_references(arch):
    """Tuples are nodes walked by index (an empty tail holds no leaves):
    the LM train state's key paths and order are JAX's ``keystr``s, e.g.
    ``['params']['tail'][0]['norm1']['scale']``."""
    jstate = jax.eval_shape(lambda: jax_train_step.init_train_state(
        jax_lm.init_params(jax.random.PRNGKey(0), _lm_reduce(jax_get_arch(arch))),
        jax_optim.adamw()))
    zeros = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), jstate)
    ours = [keystr(p) for p, _ in tree_leaves_with_path(_port_lm_state(zeros))]
    ref = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert ours == ref
    if jax_get_arch(arch).tail:
        assert any(k.startswith("['params']['tail'][0]") for k in ours)


def test_tree_map_keeps_tuples_and_lists():
    tree = {"b": (torch.ones(2), [torch.zeros(1), {"c": torch.ones(3)}]), "a": (), "d": []}
    out = tree_map(lambda x: x + 1, tree)
    assert isinstance(out["b"], tuple) and isinstance(out["b"][1], list)
    assert out["a"] == () and out["d"] == []
    assert [keystr(p) for p, _ in tree_leaves_with_path(out)] == [
        "['b'][0]", "['b'][1][0]", "['b'][1][1]['c']"]
    assert torch.equal(out["b"][1][1]["c"], torch.full((3,), 2.0))


@pytest.mark.parametrize("opt_name", ["sgd", "adamw", "adafactor"])
def test_optimizers_take_lm_trees(opt_name):
    """Each optimizer steps a tree with a tuple tail, as the reference's
    does: updates within 1e-6 of JAX's."""
    arch = "recurrentgemma-2b"
    jcfg = _lm_reduce(jax_get_arch(arch))
    jp = _jax_lm_params(arch)
    jg = jax.tree.map(lambda p: jnp.asarray(_normal(p.size, p.shape, 0.01)), jp)
    jopt, opt = jax_optim.make_optimizer(opt_name), optim.make_optimizer(opt_name)
    jupd, jst = jax.jit(jopt.update)(jg, jopt.init(jp), jp, jnp.float32(1e-2))
    params = lm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    grads = lm.params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")
    upd, st = opt.update(grads, opt.init(params), params, torch.tensor(1e-2))
    assert isinstance(upd["tail"], tuple) and len(upd["tail"]) == len(jcfg.tail)
    _assert_trees_close(upd, jupd, rtol=1e-5, atol=1e-6)
    _assert_trees_close(st, jst, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_runs_for_every_arch(arch):
    """`init_train_state` and `make_train_step` take every arch's tree with
    its own optimizer: one step, a finite loss, every parameter moved by
    its update, the tree's structure kept."""
    cfg = _lm_reduce(torch_get_arch(arch))
    opt = optim.make_optimizer(cfg.optimizer)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = init_train_state(params, opt)
    rng = np.random.default_rng(0)
    n_tok = 24 - (cfg.n_frontend_tokens if cfg.frontend else 0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, n_tok))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, n_tok)))}
    if cfg.frontend:
        batch["frontend_embeds"] = torch.from_numpy(_normal(1, (2, 4, 16), 0.02))
    new, metrics = make_train_step(lambda p, b: lm.train_loss(p, b, cfg), opt,
                                   schedule.constant(1e-3))(state, batch)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert [p for p, _ in tree_leaves_with_path(new)] == \
        [p for p, _ in tree_leaves_with_path(state)]
    assert isinstance(new["params"]["tail"], tuple)
    assert int(new["step"]) == 1 and int(new["opt"]["t"]) == 1


def test_lm_checkpoint_fp32_both_ways(tmp_path):
    """An fp32 LM train state (recurrentgemma: a tuple tail) written by JAX
    restores in the port bit for bit, and written by the port restores in
    JAX bit for bit."""
    jstate = _jax_lm_state("recurrentgemma-2b")
    template = _port_lm_state(jax.tree.map(jnp.zeros_like, jstate))
    jax_ckpt.save(str(tmp_path / "ref"), 7, jstate)
    _same_bits(ckpt.restore(str(tmp_path / "ref"), 7, template), jstate)
    ckpt.save(str(tmp_path / "port"), 7, _port_lm_state(jstate))
    out = jax_ckpt.restore(str(tmp_path / "port"), 7, jax.eval_shape(lambda: jstate))
    _same_bits(_port_lm_state(out), jstate)


def test_lm_checkpoint_bf16_from_the_reference(tmp_path):
    """A bf16 LM train state (bf16 parameters, fp32 moments; recurrentgemma:
    a tuple tail) written by JAX (bf16 leaves as 2-byte records) restores in
    the port bit for bit."""
    jstate = _jax_lm_state("recurrentgemma-2b", "bfloat16")
    assert jstate["params"]["embed"]["w_tok"].dtype == jnp.bfloat16
    template = _port_lm_state(jax.tree.map(jnp.zeros_like, jstate))
    assert template["params"]["embed"]["w_tok"].dtype == torch.bfloat16
    jax_ckpt.save(str(tmp_path), 7, jstate)
    _same_bits(ckpt.restore(str(tmp_path), 7, template), jstate)


def _npz_members(ckpt_dir, step):
    final = os.path.join(str(ckpt_dir), f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    with zipfile.ZipFile(os.path.join(final, "arrays_p0.npz")) as zf:
        return manifest, {name: zf.read(name) for name in zf.namelist()}


def test_port_bf16_checkpoint_is_the_references_bytes(tmp_path):
    """The port writes a bf16 LM state as JAX does: the same manifest
    (paths, keys, shapes, dtype ``bfloat16``) and every ``.npy`` member
    byte for byte (header and records)."""
    jstate = _jax_lm_state("recurrentgemma-2b", "bfloat16")
    jax_ckpt.save(str(tmp_path / "ref"), 7, jstate)
    ckpt.save(str(tmp_path / "port"), 7, _port_lm_state(jstate))
    ref_manifest, ref_members = _npz_members(tmp_path / "ref", 7)
    manifest, members = _npz_members(tmp_path / "port", 7)
    assert manifest == ref_manifest
    assert any(m["dtype"] == "bfloat16" for m in manifest["leaves"])
    assert members == ref_members


def test_bf16_leaves_round_trip_bit_exactly(tmp_path):
    """Every bf16 bit pattern (NaNs, infinities and subnormals too) written
    by the port reads back unchanged, beside fp32 and int32 leaves in a
    tuple; a bf16 leaf restores into an fp32 template exactly."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    tree = {"w": bits.view(torch.bfloat16).reshape(256, 256),
            "tail": ({"a": torch.randn(3), "n": torch.arange(4, dtype=torch.int32)},)}
    ckpt.save(str(tmp_path), 1, tree)
    out = ckpt.restore(str(tmp_path), 1, tree)
    assert out["w"].dtype == torch.bfloat16 and isinstance(out["tail"], tuple)
    assert torch.equal(out["w"].view(torch.int16), tree["w"].view(torch.int16))
    assert torch.equal(out["tail"][0]["a"], tree["tail"][0]["a"])
    assert torch.equal(out["tail"][0]["n"], tree["tail"][0]["n"])
    finite = {"w": torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16)}
    ckpt.save(str(tmp_path), 2, finite)
    wide = ckpt.restore(str(tmp_path), 2, {"w": torch.zeros(3)})
    assert wide["w"].dtype == torch.float32 and torch.equal(wide["w"], finite["w"].float())


def test_snn_checkpoint_keeps_its_leaf_names_and_order(jax_params, tmp_path):
    """An SNN train state (all dicts) checkpoints under the same manifest
    and member bytes as the reference writes for it."""
    jstate, _ = _state_pair(jax_params)
    jax_ckpt.save(str(tmp_path / "ref"), 7, jstate)
    ckpt.save(str(tmp_path / "port"), 7,
              vgg9.train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu"))
    ref_manifest, ref_members = _npz_members(tmp_path / "ref", 7)
    manifest, members = _npz_members(tmp_path / "port", 7)
    assert manifest == ref_manifest and members == ref_members
    assert [m["path"] for m in manifest["leaves"]][:2] == [
        "['opt']['m']['conv0']['b']", "['opt']['m']['conv0']['w']"]


def _lm_training(ckpt_dir, arch="granite-moe-3b-a800m"):
    cfg = _lm_reduce(torch_get_arch(arch))
    opt = optim.make_optimizer(cfg.optimizer)
    step = make_train_step(lambda p, b: lm.train_loss(p, b, cfg), opt,
                           schedule.warmup_cosine(3e-3, 2, 5))
    loop = TrainLoop(step, lambda i: token_batch(0, i, 2, 16, cfg.vocab),
                     ckpt_dir=str(ckpt_dir), ckpt_every=2, log_every=100,
                     log_fn=lambda *a: None)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return loop, init_train_state(params, opt)


def test_lm_crash_resume_bit_identical(tmp_path):
    """An LM (MoE, empty tuple tail) that fails at step 3 and resumes from
    its step-2 checkpoint ends bit-identical to the clean 5-step run."""
    loop1, s1 = _lm_training(tmp_path / "clean")
    final1 = loop1.run(s1, 5)
    loop2, s2 = _lm_training(tmp_path / "crash")
    with pytest.raises(RuntimeError, match="simulated"):
        loop2.run(s2, 5, fail_at_step=3)
    restored, start = loop2.maybe_restore(s2)
    assert start == 2
    final2 = loop2.run(restored, 5, start_step=start)
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(final1), tree_leaves_with_path(final2)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
