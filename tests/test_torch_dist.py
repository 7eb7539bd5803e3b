"""Distribution in the port (`repro_torch.dist`, `launch.mesh`, the data-
parallel train step, loop and launcher, the MoE's data branch) against the
JAX package, on the CPU.

JAX's multi-device side runs in subprocesses on 2 and 4 host devices
(`tests/jax_dist_cases.py`, ``--xla_force_host_platform_device_count``),
the port's ranks as gloo process groups of 2 or 4 processes
(`tests/torch_dist_workers.py`). Bars, and why:

- the sharding rules: equal to JAX's entry by entry, for every leaf of the
  TINY SNN tree and of all ten archs' reduced trees, on fake meshes of
  (16, 16), (4, 2), (2, 16, 16) with a 'pod' axis and {"data": 2};
- `quantize_error_feedback` and `compressed_psum` on 4 ranks: bit for bit
  (the same fp32 operations in the same order; int8 counts add exactly),
  and the reference test's bars (rel < 0.02, per channel < 0.005, the tiny
  channel > 0.05 per tensor, every residual within half an LSB);
- the compressed step on 4 ranks, 2 steps of the reference test's dense
  config: on JAX's per-shard gradients the compressed mean and residuals
  bit for bit; end to end the loss within 1e-5 and each parameter leaf
  within 1e-4 relative L2 (a gradient within 1e-6 of JAX's can cross a
  rounding boundary and move one int8 count, which the next AdamW step
  turns into a visible difference), residuals non-zero, parameters bit for
  bit equal across ranks;
- the plain data-parallel step on 2 and 4 ranks against the reference's
  step under ``compute_mesh(make_host_mesh())``: the loss, each AdamW
  moment leaf and the parameter tree of one AdamW step within 1e-5
  relative (L2), each parameter within 2·lr (an entry whose gradient is
  within rounding of 0 may take the first AdamW update, lr·g/(|g|+eps),
  either way);
- the MoE's data branch under meshes of 2 and 4: y within 1e-5, aux within
  1e-6, and a capacity drop that moves with the split;
- a compressed 2-rank run's checkpoint readable by JAX's `restore`
  against its ``stack_error_state(state, 2)`` template, crash -> resume bit
  for bit, and the launcher under torchrun within 1e-4 of the reference
  launcher's per-step losses on carried weights and batches.
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_dist_cases import collect, run_cases
from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.configs import vgg9_snn as jax_vgg9_snn
from repro.dist import sharding as jshd
from repro.dist.compression import quantize_error_feedback as jax_quantize
from repro.launch import train as jax_launch
from repro.models import transformer as jax_tf
from repro.models.vgg9 import init_vgg9 as jax_init_vgg9
from repro.train import checkpoint as jax_ckpt
from repro.train import optim as jax_optim
from repro.train import train_step as jax_train_step
from repro_torch import configs
from repro_torch.configs import vgg9_snn
from repro_torch.dist import sharding as shd
from repro_torch.dist.compression import quantize_error_feedback
from repro_torch.dist.context import compute_mesh
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import DataMesh, make_data_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.vgg9 import init_vgg9
from repro_torch.train import optim
from repro_torch.train.tree import keystr, tree_leaves_with_path
from test_torch_lm_train import _reduce, _rel_l2
from torch_dist_workers import run_ranks, torchrun

ARCHS = sorted(jax_all_archs())
DENSE = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             head_dim=8, d_ff=64, vocab=64, dtype="float32", remat="none", q_chunk=8,
             kv_chunk=8)


class FakeMesh:
    """A mesh for the rules: axis names and sizes, no devices."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


MESHES = {"16x16": FakeMesh(data=16, model=16), "4x2": FakeMesh(data=4, model=2),
          "pod": FakeMesh(pod=2, data=16, model=16), "data2": FakeMesh(data=2)}


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _batches(vocab, n, rows=8, seq=16, seed=7):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (rows, seq)).astype(np.int32),
             "labels": rng.integers(0, vocab, (rows, seq)).astype(np.int32)}
            for _ in range(n)]


# ---------------------------------------------------------------------------
# The JAX side, started once for the whole file (2 and 4 host devices)
# ---------------------------------------------------------------------------

GRANITE = _fields(_reduce(jax_get_arch("granite-moe-3b-a800m")))
PSUM_SHAPES = {"w": (64, 8), "b": (48,), "stack": (3, 32, 16), "zero": (8, 4)}
LAUNCH_ARGV = ["--device", "cpu", "--steps", "3", "--seq", "32", "--batch", "4",
               "--compress-grads"]


def _psum_inputs(n=4):
    """Per-rank gradients and residuals: random leaves, an all-zero leaf
    (amax 0), the reference test's ``arange`` leaf and its data-parallel
    ``big`` leaf (a shared signal, a channel 1000x below the others, small
    per-rank noise)."""
    rng = np.random.default_rng(0)
    grads = {k: rng.normal(size=(n,) + s).astype(np.float32) for k, s in PSUM_SHAPES.items()}
    grads["zero"][:] = 0.0
    grads["arange"] = np.arange(n * 4, dtype=np.float32).reshape(n, 1, 4)
    base = rng.normal(size=(64, 8)).astype(np.float32)
    base[:, 3] *= 1e-3
    grads["big"] = (base[None] * np.ones((n, 1, 1), np.float32)
                    + 0.01 * np.abs(base)[None] * rng.normal(size=(n, 64, 8)).astype(np.float32))
    err = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32) for k, v in grads.items()}
    for k in ("zero", "arange", "big"):
        err[k][:] = 0.0
    return {"grads": grads, "err": err}


@pytest.fixture(scope="module")
def jax_side():
    launch_args = launch.parse_args(LAUNCH_ARGV)
    jcfg = jax_launch.reduce_cfg(jax_get_arch(launch_args.arch), launch_args)
    launch_batches = [jax.tree.map(np.asarray, jax_train_step_batch(jcfg, launch_args, i))
                      for i in range(launch_args.steps)]
    psum = _psum_inputs()
    x_moe = np.random.default_rng(4).normal(size=(8, 6, 16)).astype(np.float32)
    four = [("psum", dict(psum, per_channel=False, key="psum_tensor")),
            ("psum", dict(psum, per_channel=True, key="psum_channel")),
            ("compressed_step", dict(cfg=DENSE, batches=_batches(64, 2), lr=1e-2)),
            ("plain_step", dict(cfg=DENSE, batch=_batches(64, 1)[0], lr=1e-3,
                                key="plain_dense")),
            ("plain_step", dict(cfg=GRANITE, batch=_batches(GRANITE["vocab"], 1)[0], lr=1e-3,
                                key="plain_granite")),
            ("moe", dict(x=x_moe, n_shards=2, capacity_factor=1.25, key="moe2")),
            ("moe", dict(x=x_moe, n_shards=4, capacity_factor=1.25, key="moe4")),
            ("moe", dict(x=x_moe * np.linspace(0.2, 3, 16, dtype=np.float32), n_shards=2,
                         capacity_factor=0.5, key="moe2_drop"))]
    two = [("plain_step", dict(cfg=DENSE, batch=_batches(64, 1)[0], lr=1e-3,
                               key="plain_dense")),
           ("plain_step", dict(cfg=GRANITE, batch=_batches(GRANITE["vocab"], 1)[0], lr=1e-3,
                               key="plain_granite")),
           ("launcher", dict(cfg=_fields(jcfg), batches=launch_batches, lr=launch_args.lr,
                             steps=launch_args.steps))]
    # three processes side by side: 4 devices (two halves) and 2 devices
    procs = [(4, run_cases([c for c in four if c[0] != "plain_step"], 4)),
             (4, run_cases([c for c in four if c[0] == "plain_step"], 4)),
             (2, run_cases(two, 2))]
    out = {2: {}, 4: {}}
    for n, proc in procs:
        out[n].update(collect(proc))
    out["psum_inputs"] = psum
    out["moe_x"] = {"moe2": x_moe, "moe4": x_moe,
                    "moe2_drop": x_moe * np.linspace(0.2, 3, 16, dtype=np.float32)}
    out["launch"] = (jcfg, launch_batches)
    return out


def jax_train_step_batch(jcfg, args, i):
    from repro.data.synthetic import token_batch
    return token_batch(args.seed, i, args.batch, args.seq, jcfg.vocab)


# ---------------------------------------------------------------------------
# Sharding rules (pure logic: fake meshes)
# ---------------------------------------------------------------------------

def _jax_specs(tree) -> dict:
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    return {jax.tree_util.keystr(p): tuple(s)
            for p, s in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]}


def _specs(tree) -> dict:
    out = {keystr(p): s for p, s in tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, shd.PartitionSpec))}
    assert all(isinstance(s, shd.PartitionSpec) for s in out.values())
    return {k: tuple(s) for k, s in out.items()}


TREES = ARCHS + ["vgg9-TINY"]


@pytest.fixture(scope="module")
def trees():
    """{name: (jax shapes, port params)} for the ten reduced archs and TINY."""
    cache = {}

    def get(name):
        if name not in cache:
            if name == "vgg9-TINY":
                jshapes = jax.eval_shape(lambda: jax_init_vgg9(jax.random.PRNGKey(0),
                                                               jax_vgg9_snn.TINY))
                params = init_vgg9(torch.Generator().manual_seed(0), vgg9_snn.TINY, "cpu")
            else:
                jcfg = _reduce(jax_get_arch(name))
                jshapes = jax.eval_shape(lambda: jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
                params = tf.init_params(torch.Generator().manual_seed(0),
                                        _reduce(configs.get_arch(name)), "cpu")
            cache[name] = (jshapes, params)
        return cache[name]
    return get


@pytest.mark.parametrize("name", TREES)
def test_param_specs_match_reference(trees, name):
    jshapes, params = trees(name)
    for mesh in MESHES.values():
        for fsdp in (False, True):
            ours = _specs(shd.param_specs(params, mesh, fsdp_experts=fsdp))
            assert ours == _jax_specs(jshd.param_specs(jshapes, mesh, fsdp_experts=fsdp))


@pytest.mark.parametrize("name", TREES)
def test_zero1_opt_specs_match_reference(trees, name):
    """Over the AdamW and the Adafactor state of the tree."""
    jshapes, params = trees(name)
    for opt_name in ("adamw", "adafactor"):
        jstate = jax.eval_shape(jax_optim.make_optimizer(opt_name).init, jshapes)
        state = optim.make_optimizer(opt_name).init(params)
        for mesh in MESHES.values():
            ours = _specs(shd.zero1_opt_specs(state, shd.param_specs(params, mesh), mesh))
            ref = _jax_specs(jshd.zero1_opt_specs(jstate, jshd.param_specs(jshapes, mesh),
                                                  mesh))
            assert ours == ref, opt_name


@pytest.mark.parametrize("name", TREES)
def test_zero1_spec_matches_reference(trees, name):
    """The one-leaf rule, for every leaf with its parameter spec."""
    jshapes, params = trees(name)
    for mesh in MESHES.values():
        specs = shd.param_specs(params, mesh)
        leaves = tree_leaves_with_path(specs, is_leaf=lambda x: isinstance(x, shd.PartitionSpec))
        by_key = {keystr(p): x.shape for p, x in tree_leaves_with_path(params)}
        data = mesh.shape.get("data", 1)
        for path, spec in leaves:
            shape = by_key[keystr(path)]
            ours = optim.zero1_spec(spec, shape, data_size=data)
            ref = jax_optim.zero1_spec(jax.sharding.PartitionSpec(*spec), shape, data_size=data)
            assert isinstance(ours, shd.PartitionSpec) and tuple(ours) == tuple(ref), path


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch", [4, 32])
def test_cache_specs_match_reference(arch, batch):
    jcfg, cfg = _reduce(jax_get_arch(arch)), _reduce(configs.get_arch(arch))
    jshapes = jax.eval_shape(lambda: jax_tf.init_cache(jcfg, batch, 16))
    cache = tf.init_cache(cfg, batch, 16, "cpu")
    for mesh in MESHES.values():
        assert _specs(shd.cache_specs(cache, mesh)) == _jax_specs(jshd.cache_specs(jshapes, mesh))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_matches_reference(mesh):
    m = MESHES[mesh]
    shapes = {"images": (4, 16, 16, 3), "odd": (3, 16, 16, 3), "tokens": (32, 128),
              "scalar": (), "labels": (64, 8)}
    ours = shd.batch_spec({k: torch.zeros(s) for k, s in shapes.items()}, m)
    ref = jshd.batch_spec({k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()},
                          m)
    assert {k: tuple(v) for k, v in ours.items()} == {k: tuple(v) for k, v in ref.items()}
    assert all(isinstance(v, shd.PartitionSpec) for v in ours.values())


def test_reference_rule_cases():
    """The JAX tests' own cases: the 49155-vocab repair, a stacked period
    axis, norms, conv kernels, the SNN tree on a data mesh, odd batches."""
    P = shd.PartitionSpec
    mesh = MESHES["16x16"]
    assert shd.param_spec(("embed", "w_tok"), torch.zeros(49155, 1536), mesh) == P(None, "model")
    assert shd.param_spec(("attn", "wq"), torch.zeros(1536, 1536), mesh) == P(None, "model")
    assert shd.param_spec(("attn", "wq"), torch.zeros(24, 1536, 1536), mesh) == \
        P(None, None, "model")
    assert shd.param_spec(("norm1",), torch.zeros(1536), None) == P()
    tp = FakeMesh(data=2, model=2)
    assert shd.param_spec(("conv1", "w"), torch.zeros(3, 3, 8, 12), tp) == P()
    assert shd.param_spec(("lif", "theta"), torch.zeros(12), None) == P()
    snn = init_vgg9(torch.Generator().manual_seed(0), vgg9_snn.TINY, "cpu")
    for spec in _specs(shd.param_specs(snn, MESHES["data2"])).values():
        assert spec in ((), (None,) * len(spec))
    specs = shd.batch_spec({"images": torch.zeros(4, 16, 16, 3)}, MESHES["data2"])
    assert specs["images"] == P(("data",), None, None, None) == P("data", None, None, None)
    assert shd.batch_spec({"images": torch.zeros(3, 16, 16, 3)}, MESHES["data2"])["images"] == P()
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


def test_shard_cotangents_and_placements():
    """`shard_cotangents` is the identity on plain tensors, with or without
    a 'model' axis > 1; under one, a DTensor leaf keeps its value and its
    gradient is held to the leaf's placements (a cotangent that arrives
    replicated comes back laid out as the leaf); `to_placements` on a
    1-rank gloo DeviceMesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    tree = {"w": torch.ones(4, 4)}
    assert shd.shard_cotangents(tree) is tree
    with compute_mesh(FakeMesh(data=2, model=1)):
        assert shd.shard_cotangents(tree) is tree
    with compute_mesh(MESHES["4x2"]):
        assert shd.shard_cotangents(tree)["w"] is tree["w"]
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh("cpu")
        assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 1}
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh("cpu", (1, 1), mesh_dim_names=mesh.axis_names)
        P = shd.PartitionSpec
        assert shd.to_placements(P("data", "model"), dm) == [Shard(0), Shard(1)]
        assert shd.to_placements(P(None, "model"), dm) == [Replicate(), Shard(1)]
        assert shd.to_placements(P(("pod", "data"), None), dm) == [Shard(0), Replicate()]
        assert shd.to_placements(P(), dm) == [Replicate(), Replicate()]
        w = DTensor.from_local(torch.arange(8.0).reshape(2, 4), dm, [Replicate(), Shard(1)],
                               run_check=False).requires_grad_()
        with compute_mesh(MESHES["4x2"]):
            held = shd.shard_cotangents({"w": w})["w"]
        assert torch.equal(held.to_local(), w.to_local())
        (held.to_local(grad_placements=[Replicate(), Replicate()]) ** 2).sum().backward()
        assert tuple(w.grad.placements) == (Replicate(), Shard(1))
        assert torch.equal(w.grad.to_local(), 2 * w.to_local())
        mesh.close()
        assert dist.is_initialized()              # a group it did not start stays up
    finally:
        dist.destroy_process_group()


def test_meshes():
    mesh = make_data_mesh(3, "cpu")
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 3}
    assert mesh.devices == (torch.device("cpu"),) * 3
    params = {"w": torch.ones(2)}
    assert mesh.replicate(params, torch.device("cpu")) is params
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_data_mesh(2, "cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            DataMesh(["cuda:0"])


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, -1, 0])
def test_quantize_error_feedback_matches_reference(axis):
    """Against the reference under ``jit``, as its train step runs it (XLA
    multiplies by float32(1/127) and fuses the residual into one FMA)."""
    jquantize = jax.jit(jax_quantize, static_argnames=("axis",))
    rng = np.random.default_rng(1)
    cases = [rng.normal(size=(128, 8)).astype(np.float32), rng.normal(size=(64,)),
             rng.normal(size=(3, 16, 8)), np.zeros((4, 4))]
    cases[0][:, 3] *= 1e-3
    for g in cases:
        g = np.asarray(g, np.float32)
        e = (rng.normal(size=g.shape) * 1e-2).astype(np.float32)
        q, scale, new_err = quantize_error_feedback(torch.from_numpy(g), torch.from_numpy(e),
                                                    axis=axis)
        jq, jscale, jerr = jquantize(jnp.asarray(g), jnp.asarray(e), axis=axis)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        np.testing.assert_array_equal(new_err.numpy(), np.asarray(jerr))
        np.testing.assert_allclose((q.float() * scale + new_err).numpy(), g + e, atol=1e-6)


@pytest.fixture(scope="module")
def psum_ranks(jax_side):
    inputs = jax_side["psum_inputs"]
    return {mode: run_ranks("psum", 4, dict(inputs, per_channel=mode == "channel"))
            for mode in ("tensor", "channel")}


@pytest.mark.parametrize("mode", ["tensor", "channel"])
def test_compressed_psum_four_ranks_bit_identical_to_reference(jax_side, psum_ranks, mode):
    ref = jax_side[4][f"psum_{mode}"]
    for r, out in enumerate(psum_ranks[mode]):
        for k in out["mean"]:
            np.testing.assert_array_equal(out["mean"][k], ref["mean"][k][r], err_msg=k)
            np.testing.assert_array_equal(out["err"][k], ref["err"][k][r], err_msg=k)


def test_compressed_psum_meets_reference_bars(jax_side, psum_ranks):
    """`tests/test_dist.py`'s bars, on 4 ranks."""
    grads = jax_side["psum_inputs"]["grads"]
    got = psum_ranks["tensor"][0]["mean"]["arange"][0]
    expect = grads["arange"][:, 0].mean(0)
    assert np.abs(got - expect).max() / np.abs(expect).max() < 0.02
    big = grads["big"]
    expect2 = big.mean(0)
    got2 = psum_ranks["channel"][0]["mean"]["big"]
    rel_ch = np.abs(got2 - expect2).max(axis=0) / np.abs(expect2).max(axis=0)
    assert rel_ch.max() < 0.005, rel_ch
    got_t = psum_ranks["tensor"][0]["mean"]["big"]
    rel_t = np.abs(got_t - expect2).max(axis=0) / np.abs(expect2).max(axis=0)
    assert rel_t[3] > 0.05
    lsb = np.abs(big).max(axis=(0, 1)) / 127.0
    res = np.stack([out["err"]["big"] for out in psum_ranks["channel"]])
    assert (np.abs(res).max(axis=(0, 1)) <= lsb * 0.5 + 1e-7).all()
    for mode in ("tensor", "channel"):
        means = [out["mean"] for out in psum_ranks[mode]]
        for k in means[0]:
            assert all(np.array_equal(m[k], means[0][k]) for m in means), k
        assert not psum_ranks[mode][0]["mean"]["zero"].any()


def test_spike_stats_cross_replica_sum():
    """Every field summed over 3 ranks (the reference's psum over the data
    axes); each rank's own stats left as they were."""
    rng = np.random.default_rng(2)
    spikes = {"conv1": (rng.random((3, 2, 8, 8, 4)) < 0.2).astype(np.float32),
              "fc0": (rng.random((3, 2, 16)) < 0.5).astype(np.float32)}
    outs = run_ranks("spike_stats", 3, {"spikes": spikes})
    for r, out in enumerate(outs):
        for name, sp in spikes.items():
            assert out["counts"][name] == np.float32((sp != 0).sum())
            assert out["sizes"][name] == np.float32(sp.size)
            assert out["own"][name] == np.float32((sp[r] != 0).sum())


# ---------------------------------------------------------------------------
# The compressed train step
# ---------------------------------------------------------------------------

def test_compressed_step_on_reference_gradients_bit_identical(jax_side):
    """JAX's per-shard gradients and residuals after 2 steps, carried in:
    the compressed mean and the new residuals bit for bit JAX's."""
    ref = jax_side[4]["compressed_step"]
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(x)  # noqa: E731
                      for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
    outs = run_ranks("psum", 4, {"grads": flat(ref["grads"]), "err": flat(ref["err_in"]),
                                 "per_channel": False})
    mean, new_err = flat(ref["mean"]), flat(ref["new_err"])
    for r, out in enumerate(outs):
        for k in mean:
            np.testing.assert_array_equal(out["mean"][k], mean[k][r], err_msg=k)
            np.testing.assert_array_equal(out["err"][k], new_err[k][r], err_msg=k)


def test_compressed_step_matches_reference(jax_side):
    """4 ranks, 2 steps from JAX's init on the same global batches."""
    ref = jax_side[4]["compressed_step"]
    outs = run_ranks("train", 4, {"cfg": DENSE, "params": ref["params"], "opt": "adamw",
                                  "opt_kw": {"weight_decay": 0.0}, "lr": 1e-2,
                                  "batches": _batches(64, 2), "compress": True})
    np.testing.assert_allclose(outs[0]["losses"], ref["losses"], rtol=1e-5)
    refp = {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(ref["state"]["params"])[0]}
    for r, out in enumerate(outs):
        ours = {keystr(p): x for p, x in tree_leaves_with_path(out["state"]["params"])}
        assert list(ours) == list(refp)
        for k, v in refp.items():
            assert _rel_l2(ours[k], v) <= 1e-4, (k, _rel_l2(ours[k], v))
            np.testing.assert_array_equal(ours[k], {keystr(p): x for p, x in tree_leaves_with_path(
                outs[0]["state"]["params"])}[k])
        err = sum(float(np.abs(e).sum()) for _, e in tree_leaves_with_path(out["state"]["grad_err"]))
        assert err > 0.0
        assert all(e.shape[0] == 1 for _, e in tree_leaves_with_path(out["state"]["grad_err"]))
        for (_, a), (_, b) in zip(tree_leaves_with_path(out["state"]["opt"]),
                                  tree_leaves_with_path(outs[0]["state"]["opt"])):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The plain data-parallel step
# ---------------------------------------------------------------------------

def _flat(tree, jax_tree=False) -> dict:
    if jax_tree:
        return {jax.tree_util.keystr(p): np.asarray(x)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {keystr(p): x for p, x in tree_leaves_with_path(tree)}


def _tree_rel_l2(a: dict, b: dict) -> float:
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in b)
    den = sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in b)
    return (num / den) ** 0.5


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model", ["dense", "granite"])
def test_plain_data_parallel_step_matches_reference(jax_side, n, model):
    """n ranks against the reference's step under compute_mesh(make_host_mesh())
    on n devices (granite-moe: each shard's rows routed on their own). The
    loss, each AdamW moment leaf and the parameter tree within 1e-5
    relative; each parameter within 2·lr (the first AdamW update is
    lr·g/(|g|+eps): an entry whose gradient is within rounding of 0 may
    move by up to lr either way; the reference's own 4-device and 1-device
    steps differ by 2.5e-5 relative on the dense config's embedding). On
    every rank the same bits."""
    lr = 1e-3
    ref = jax_side[n][f"plain_{model}"]
    cfg = DENSE if model == "dense" else GRANITE
    outs = run_ranks("train", n, {"cfg": cfg, "params": ref["params"], "opt": "adamw",
                                  "opt_kw": {"weight_decay": 0.0}, "lr": lr,
                                  "batches": [_batches(cfg["vocab"], 1)[0]]})
    assert abs(outs[0]["losses"][0] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    refs, ours = _flat(ref["state"], jax_tree=True), _flat(outs[0]["state"])
    assert list(ours) == list(refs)
    params = [k for k in refs if k.startswith("['params']")]
    for k in refs:
        if k.startswith("['opt']['m']") or k.startswith("['opt']['v']"):
            assert _rel_l2(ours[k], refs[k]) <= 1e-5, (k, _rel_l2(ours[k], refs[k]))
        elif k in params:
            np.testing.assert_allclose(ours[k], refs[k], rtol=0, atol=2 * lr, err_msg=k)
    assert _tree_rel_l2({k: ours[k] for k in params}, {k: refs[k] for k in params}) <= 1e-5
    for out in outs[1:]:
        assert out["losses"] == outs[0]["losses"]
        for (_, a), (_, b) in zip(tree_leaves_with_path(out["state"]),
                                  tree_leaves_with_path(outs[0]["state"])):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The MoE's data branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["moe2", "moe4", "moe2_drop"])
def test_moe_data_branch_matches_reference(jax_side, key):
    ref = jax_side[4][key]
    x = torch.from_numpy(jax_side["moe_x"][key])
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref["p"])
    kw = dict(top_k=2, act="swiglu", n_experts=8,
              capacity_factor=0.5 if key == "moe2_drop" else 1.25)
    n = 4 if key == "moe4" else 2
    with compute_mesh(make_data_mesh(n, "cpu")):
        y, aux = moe.moe_apply(p, x, **kw)
    y0, aux0 = moe.moe_apply(p, x, **kw)
    np.testing.assert_allclose(y.numpy(), ref["y"], rtol=0, atol=1e-5)
    assert abs(float(aux) - ref["aux"]) <= 1e-6
    np.testing.assert_allclose(y0.numpy(), ref["y_unsharded"], rtol=0, atol=1e-5)
    if key == "moe2_drop":
        # capacity is counted over each block's rows: the split moves drops
        moved = np.abs(ref["y"] - ref["y_unsharded"]).max()
        assert moved > 1e-3 and np.abs(y.numpy() - y0.numpy()).max() > 1e-3
    with compute_mesh(make_data_mesh(3, "cpu")):             # 3 does not divide B = 8
        y3, _ = moe.moe_apply(p, x, **kw)
    assert torch.equal(y3, y0)


# ---------------------------------------------------------------------------
# The loop's checkpoints and the launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_run(jax_side, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_loop"))
    ref = jax_side[4]["compressed_step"]
    outs = run_ranks("loop", 2, {"cfg": DENSE, "params": ref["params"], "opt": "adamw",
                                 "lr": 1e-2, "batches": _batches(64, 4, seed=11),
                                 "fail_at": 3, "root": root})
    return root, ref["params"], outs


def test_crash_resume_of_compressed_run_is_bit_identical(loop_run):
    _, _, outs = loop_run
    for out in outs:
        assert out["failed"] and out["start"] == 2 and out["checks"] == 4
        assert out["resumed_losses"] == out["clean_losses"][2:]
        for (pa, a), (pb, b) in zip(tree_leaves_with_path(out["clean"]),
                                    tree_leaves_with_path(out["resumed"])):
            assert pa == pb
            np.testing.assert_array_equal(a, b, err_msg=keystr(pa))


def test_compressed_checkpoint_restores_in_reference(loop_run):
    """Rank 0's checkpoint holds grad_err stacked [2, ...] (every rank's
    residual in rank order) and restores with JAX's `checkpoint.restore`
    against ``stack_error_state(state, 2)``."""
    root, jparams, outs = loop_run
    ckpt_dir = os.path.join(root, "clean")
    opt = jax_optim.make_optimizer("adamw")
    template = jax.eval_shape(lambda: jax_train_step.stack_error_state(
        jax_train_step.init_train_state(jax.tree.map(jnp.asarray, jparams), opt, compress=True),
        2))
    restored = jax_ckpt.restore(ckpt_dir, 4, template)
    assert int(restored["step"]) == 4
    ref = {jax.tree_util.keystr(p): np.asarray(x)
           for p, x in jax.tree_util.tree_flatten_with_path(restored)[0]}
    for r, out in enumerate(outs):
        for path, x in tree_leaves_with_path(out["clean"]):
            key = keystr(path)
            want = ref[key][r:r + 1] if key.startswith("['grad_err']") else ref[key]
            np.testing.assert_array_equal(x, want, err_msg=key)


def test_torchrun_launcher_matches_reference_launcher(jax_side):
    """``torchrun --nproc-per-node 2 launch.train --compress-grads`` on the
    reference's init and batches: every step's loss within 1e-4 of the
    reference launcher's compressed loop on 2 devices."""
    ref = jax_side[2]["launcher"]
    _, batches = jax_side["launch"]
    out, proc = torchrun(LAUNCH_ARGV, {"params": ref["params"], "batches": batches})
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-4)
    assert "data-parallel training: 2 ranks, gloo on cpu" in proc.stdout
    assert "replicas agree: parameter and optimizer fingerprints equal on all 2 ranks after " \
           "each of 3 steps, every bit after the last" in proc.stdout
    residuals = re.findall(r"rank (\d): residual \|grad_err\| sum (\S+)\n", proc.stdout)
    assert sorted(r for r, _ in residuals) == ["0", "1"]
    assert all(float(v) > 0 for _, v in residuals)


def test_launcher_refuses_a_batch_that_does_not_divide():
    """``--batch`` must divide by the world size, as the reference asserts."""
    out, proc = torchrun(["--device", "cpu", "--steps", "1", "--batch", "3", "--seq", "16"],
                         {"params": None, "batches": None}, check=False)
    assert out is None and proc.returncode != 0
    assert "--batch 3 must divide by the world size (2)" in proc.stderr
