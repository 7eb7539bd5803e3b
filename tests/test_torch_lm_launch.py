"""LM training in the port against the JAX package, on the CPU: the train
step and the launcher (`launch/train.py`).

Reductions, carried weights and batches as in `tests/test_torch_lm_train.py`.
Bars, and why:

- one `make_train_step` step at fp32: SGD params within 1e-5; AdamW's
  ``m`` and ``v`` within 1e-4 relative L2 and its params within 2·lr
  (the first AdamW update is lr·g/(|g|+eps), so an entry whose gradient is
  near 0 may move by up to lr either way);
- the launcher's loop (xlstm and granite-moe at seq 32, batch 4) against
  the reference's loop on carried parameters and batches: per-step losses
  within 1e-4;
- the launcher's flags: the reference's defaults and `reduce_cfg`, its
  ``ap.error``, and ``--compress-grads`` training at world size 1 (several
  ranks: `tests/test_torch_dist.py`).
"""
import argparse
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.synthetic import token_batch as jax_token_batch
from repro.launch import train as jax_launch
from repro.models import transformer as jax_tf
from repro.train import optim as jax_optim
from repro.train import schedule as jax_schedule
from repro.train import train_step as jax_train_step
from repro_torch import configs
from repro_torch.launch import train as launch
from repro_torch.models import transformer as tf
from repro_torch.train import optim, schedule
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.train.tree import keystr, tree_leaves_with_path
from test_torch_lm_train import ARCHS, TOL, _bumped, _jax_batch, _reduce, _rel_l2, _to_torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# One train step against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,opt_name", [("granite-moe-3b-a800m", "sgd"),
                                           ("granite-moe-3b-a800m", "adamw")])
def test_train_step_matches_reference(arch, opt_name):
    """One clipped, scheduled step of the MoE (every gradient the routing's
    too; a tuple tail is stepped in `tests/test_torch_train.py`): SGD
    params within 1e-5; AdamW's moments tight and params within 2·lr."""
    jcfg = _reduce(jax_get_arch(arch))
    cfg = _reduce(configs.get_arch(arch))
    jp = _bumped(jax_tf.init_params(jax.random.PRNGKey(2), jcfg))
    lr = 3e-3
    jopt, opt = jax_optim.make_optimizer(opt_name), optim.make_optimizer(opt_name)
    jstep = jax.jit(jax_train_step.make_train_step(
        lambda p, b: jax_tf.train_loss(p, b, jcfg), jopt, jax_schedule.constant(lr)))
    step = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt, schedule.constant(lr))
    batch = _jax_batch(jcfg, seed=5)
    jstate, jm = jstep(jax_train_step.init_train_state(jp, jopt),
                       jax.tree.map(jnp.asarray, batch))
    state, m = step(init_train_state(tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                                     opt), _to_torch(batch))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= TOL * float(jm["grad_norm"])
    ref = {jax.tree_util.keystr(path): np.asarray(x)
           for path, x in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    out = {keystr(p): x.numpy() for p, x in tree_leaves_with_path(state)}
    assert list(out) == list(ref)
    for key, r in ref.items():
        o = out[key]
        assert o.dtype == r.dtype and o.shape == r.shape, key
        if key.startswith("['params']"):
            atol = 1e-5 if opt_name == "sgd" else 2 * lr
            np.testing.assert_allclose(o, r, rtol=0, atol=atol, err_msg=key)
        elif o.dtype.kind == "f":
            assert _rel_l2(o, r) <= TOL, (key, _rel_l2(o, r))
        else:
            np.testing.assert_array_equal(o, r, err_msg=key)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _reference_parser() -> argparse.ArgumentParser:
    """The reference launcher's parser, caught as its ``main`` parses."""
    seen = []

    class Caught(Exception):
        pass

    def catch(self, args=None, namespace=None):
        seen.append(self)
        raise Caught

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        jax_launch.main()
    except Caught:
        pass
    finally:
        argparse.ArgumentParser.parse_args = original
    return seen[0]


def test_flags_and_defaults_are_the_reference_launchers():
    ref = vars(_reference_parser().parse_args([]))
    ours = vars(launch.parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_reduce_cfg_is_the_reference_launchers(arch):
    args = launch.parse_args(["--d-model", "64", "--n-layers", "4", "--vocab", "512"])
    ours = launch.reduce_cfg(configs.get_arch(arch), args)
    ref = jax_launch.reduce_cfg(jax_get_arch(arch), args)
    assert {f: getattr(ours, f) for f in ours.__dataclass_fields__} == \
        {f: getattr(ref, f) for f in ref.__dataclass_fields__}


def test_compress_flags(capsys):
    """--compress-grads trains (a process group of one, started and torn
    down by the launcher); --compress-per-channel alone is refused."""
    import torch.distributed as dist
    history = launch.main(["--device", "cpu", "--compress-grads", "--compress-per-channel",
                           "--steps", "2", "--seq", "16", "--batch", "2"])
    assert [s for s, _ in history] == [0, 1] and np.isfinite(history[-1][1]["loss"])
    assert "rank 0: residual |grad_err| sum" in capsys.readouterr().out
    assert not dist.is_initialized()
    with pytest.raises(SystemExit) as exc:
        launch.main(["--device", "cpu", "--compress-per-channel"])
    assert exc.value.code == 2
    assert "--compress-per-channel requires --compress-grads" in capsys.readouterr().err


def test_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--steps", "1"])


def _reference_losses(jcfg, seed, batch, seq, steps, lr):
    """The reference launcher's loop, step by step, on its own init."""
    jopt = jax_optim.make_optimizer(jcfg.optimizer)
    jstep = jax.jit(jax_train_step.make_train_step(
        lambda p, b: jax_tf.train_loss(p, b, jcfg), jopt,
        jax_schedule.warmup_cosine(lr, 10, steps)))
    jp = jax_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    state = jax_train_step.init_train_state(jp, jopt)
    losses = []
    for i in range(steps):
        state, m = jstep(state, jax.tree.map(jnp.asarray, _jax_batch(jcfg, seed, i, batch, seq)))
        losses.append(float(m["loss"]))
    return jp, losses


@pytest.mark.parametrize("arch", ["xlstm-125m", "granite-moe-3b-a800m"])
def test_launcher_losses_match_reference(arch, monkeypatch, tmp_path):
    """`launch.train.main` on the reference's parameters and batches (its
    init and its `token_batch`, carried as numpy): every step's loss within
    1e-4 of the reference loop's; then a second run resumes from the
    checkpoint and ends on the same final loss."""
    argv = ["--arch", arch, "--device", "cpu", "--steps", "6", "--seq", "32", "--batch", "4",
            "--ckpt-every", "4"]
    args = launch.parse_args(argv)
    jcfg = jax_launch.reduce_cfg(jax_get_arch(arch), args)
    jp, ref = _reference_losses(jcfg, args.seed, args.batch, args.seq, args.steps, args.lr)

    carried = tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    monkeypatch.setattr(tf, "init_params", lambda gen, cfg, device: carried)
    monkeypatch.setattr(launch, "token_batch", lambda seed, i, b, s, vocab, device: _to_torch(
        jax.tree.map(np.asarray, jax_token_batch(seed, i, b, s, vocab))))
    losses = []

    def recording(*a, **kw):
        step = make_train_step(*a, **kw)

        def run(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m
        return run
    monkeypatch.setattr(launch, "make_train_step", recording)
    history = launch.main(argv)
    np.testing.assert_allclose(losses, ref, rtol=TOL)
    assert [s for s, _ in history] == [0, 5]
    assert history[-1][1]["loss"] == losses[-1]

    argv += ["--ckpt-dir", str(tmp_path)]
    launch.main(argv + ["--steps", "4"])       # warmup: the first 4 lrs as in 6 steps
    losses.clear()
    resumed = launch.main(argv)
    assert len(losses) == 2 and resumed[-1][1]["loss"] == history[-1][1]["loss"]


def test_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--steps", "3", "--seq", "32", "--batch", "2",
                          "--ckpt-dir", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step 0: loss=" in out.stdout and "step 2: loss=" in out.stdout
    assert "final loss:" in out.stdout
