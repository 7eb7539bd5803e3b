"""The JAX package's side of the port's distribution tests, on N host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=N \\
        python tests/jax_dist_cases.py IN OUT

``IN`` pickles ``{"cases": [(name, kwargs), ...]}``; each case runs the
reference (``shard_map``, its GSPMD step under ``compute_mesh``, its data
mesh, its CLI) and the results are pickled to ``OUT`` as ``{name: ...}``,
numpy only. `run_cases` starts it from a test. Multi-device JAX needs its
own process: the test process keeps its single-device view, as in
`tests/test_dist.py`.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def run_cases(cases, n_dev: int, timeout: int = 600) -> subprocess.Popen:
    """Start the cases on ``n_dev`` devices -> a handle for `collect`."""
    tmp = tempfile.mkdtemp(prefix="jaxcases")
    inp, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
    with open(inp, "wb") as f:
        pickle.dump({"cases": cases}, f)
    # one intra-op thread per device: the cases are small, and the test
    # workers beside this process need the cores
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n_dev} "
               "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
               PYTHONPATH=os.path.abspath(os.path.join(HERE, "..", "src")),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), inp, out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.out_path, proc.timeout = out, timeout
    return proc


def collect(proc) -> dict:
    stdout, stderr = proc.communicate(timeout=proc.timeout)
    assert proc.returncode == 0, stderr[-4000:]
    with open(proc.out_path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def _np(tree):
    import jax
    import numpy as np
    return jax.tree.map(np.asarray, tree)


def _stacked_map(fn, mesh, n_in, n_out):
    """``shard_map`` of ``fn`` over 'data', every input and output carrying
    a leading [n] device axis (each shard sees its own row)."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.dist import compat  # noqa: F401

    def local(*args):
        out = fn(*jax.tree.map(lambda x: x[0], args))
        return jax.tree.map(lambda x: x[None], out)
    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=tuple([P("data")] * n_in),
                                 out_specs=tuple([P("data")] * n_out), check_vma=False))


def case_psum(grads, err, per_channel):
    """`compressed_psum` of row d of ``grads`` / ``err`` on device d."""
    import jax
    from repro.dist.compression import compressed_psum
    mesh = jax.make_mesh((len(jax.devices()),), ("data",))
    f = _stacked_map(lambda g, e: compressed_psum(g, e, "data", per_channel=per_channel),
                     mesh, 2, 2)
    mean, new_err = f(grads, err)
    return {"mean": _np(mean), "err": _np(new_err)}


def _arch(cfg):
    from repro.configs.base import ArchConfig
    return ArchConfig(**cfg)


def case_compressed_step(cfg, batches, lr, per_channel=False):
    """`shard_map_compressed_step` on every device for len(batches) steps,
    then each shard's gradients at the final params on the last batch and
    their `compressed_psum` with the final residuals."""
    import jax
    import jax.numpy as jnp
    from repro.dist.compression import compressed_psum
    from repro.models import transformer as tf
    from repro.train.optim import adamw
    from repro.train.schedule import constant
    from repro.train.train_step import (init_train_state, make_train_step,
                                        shard_map_compressed_step, stack_error_state)
    cfg = _arch(cfg)
    n = len(jax.devices())
    mesh = jax.make_mesh((n,), ("data",))
    opt = adamw(weight_decay=0.0)
    inner = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt, constant(lr),
                            compress_axis="data", compress_per_channel=per_channel)
    step = jax.jit(shard_map_compressed_step(inner, mesh))
    params = tf.init_params(jax.random.PRNGKey(0), cfg)
    state = stack_error_state(init_train_state(params, opt, compress=True), n)
    losses = []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))

    def grads_and_psum(p, err, tokens, labels):
        g = jax.grad(tf.train_loss)(p, {"tokens": tokens, "labels": labels}, cfg)
        mean, new_err = compressed_psum(g, err, "data", per_channel=per_channel)
        return g, mean, new_err

    last = batches[-1]
    rows = last["tokens"].shape[0] // n
    f = _stacked_map(grads_and_psum, mesh, 4, 3)
    p_stack = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (n,) + x.shape),
                           state["params"])
    g, mean, new_err = f(p_stack, state["grad_err"],
                         jnp.asarray(last["tokens"]).reshape(n, rows, -1),
                         jnp.asarray(last["labels"]).reshape(n, rows, -1))
    return {"params": _np(params), "losses": losses, "state": _np(state),
            "grads": _np(g), "err_in": _np(state["grad_err"]), "mean": _np(mean),
            "new_err": _np(new_err)}


def case_plain_step(cfg, batch, lr):
    """The reference's step under ``compute_mesh(make_host_mesh())`` on
    every device: one AdamW step on the global batch."""
    import jax
    import jax.numpy as jnp
    from repro.dist.context import compute_mesh
    from repro.launch.mesh import make_host_mesh
    from repro.models import transformer as tf
    from repro.train.optim import adamw
    from repro.train.schedule import constant
    from repro.train.train_step import init_train_state, make_train_step
    cfg = _arch(cfg)
    opt = adamw(weight_decay=0.0)
    step = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt, constant(lr))
    mesh = make_host_mesh()
    with mesh, compute_mesh(mesh):
        params = tf.init_params(jax.random.PRNGKey(0), cfg)
        state = init_train_state(params, opt)
        state2, m = jax.jit(step)(state, jax.tree.map(jnp.asarray, batch))
        loss = float(m["loss"])
    return {"params": _np(params), "loss": loss, "state": _np(state2)}


def case_moe(x, n_shards, capacity_factor, top_k=2, n_experts=8, d_ff=32, act="swiglu"):
    """`moe_apply` under ``make_data_mesh(n_shards)`` and without a mesh."""
    import jax
    import jax.numpy as jnp
    from repro.dist.context import compute_mesh
    from repro.launch.mesh import make_data_mesh
    from repro.models.moe import moe_apply, moe_init
    d = x.shape[-1]
    p = moe_init(jax.random.PRNGKey(3), d, n_experts, d_ff, act, jnp.float32)
    kw = dict(top_k=top_k, act=act, n_experts=n_experts, capacity_factor=capacity_factor)
    fn = jax.jit(lambda p_, x_: moe_apply(p_, x_, **kw))
    y0, aux0 = fn(p, jnp.asarray(x))
    with compute_mesh(make_data_mesh(n_shards)):
        y, aux = jax.jit(lambda p_, x_: moe_apply(p_, x_, **kw))(p, jnp.asarray(x))
    return {"p": _np(p), "y": _np(y), "aux": float(aux), "y_unsharded": _np(y0),
            "aux_unsharded": float(aux0)}


def case_launcher(cfg, batches, lr, steps, per_channel=False):
    """The reference launcher's compressed loop on every device: its init
    (``PRNGKey(0)``), the given batches, every step's loss."""
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import make_host_mesh
    from repro.models import transformer as tf
    from repro.train.optim import make_optimizer
    from repro.train.schedule import warmup_cosine
    from repro.train.train_step import (init_train_state, make_train_step,
                                        shard_map_compressed_step, stack_error_state)
    cfg = _arch(cfg)
    mesh = make_host_mesh()
    n = int(mesh.shape["data"])
    opt = make_optimizer(cfg.optimizer)
    inner = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                            warmup_cosine(lr, 10, steps), compress_axis="data",
                            compress_per_channel=per_channel)
    step = jax.jit(shard_map_compressed_step(inner, mesh))
    with mesh:
        params = tf.init_params(jax.random.PRNGKey(0), cfg)
        state = stack_error_state(init_train_state(params, opt, compress=True), n)
        losses = []
        for b in batches:
            state, m = step(state, jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
    return {"params": _np(params), "losses": losses}


def case_snn_engine(n_images=6, slots=4):
    """`tests/test_dist_snn.py`'s engine: TINY, its weights and images,
    served under a 2-device data mesh; every request's outputs and stats."""
    import jax
    from repro.configs import vgg9_snn
    from repro.dist.context import compute_mesh
    from repro.launch.mesh import make_data_mesh
    from repro.models.vgg9 import init_vgg9
    from repro.serve.api import EngineConfig
    from repro.serve.core import EngineCore
    from repro.serve.runners.snn import SNNRunner
    cfg = vgg9_snn.TINY
    params = init_vgg9(jax.random.PRNGKey(0), cfg)
    keys = jax.random.split(jax.random.PRNGKey(1), n_images)
    imgs = [jax.random.uniform(k, (cfg.img_hw, cfg.img_hw, cfg.in_ch)) for k in keys]
    imgs[1] = imgs[1] * 0.01
    core = EngineCore(SNNRunner(cfg, params, interpret=True), EngineConfig(slots=slots))
    ids = [core.submit(im) for im in imgs]
    with compute_mesh(make_data_mesh(2)):
        results = core.run_until_complete()
    keep = ("spike_total", "out_spikes", "in_spikes", "skip_rate", "energy_j")
    return {"params": _np(params), "images": _np(imgs),
            "results": [(_np(results[i].outputs), {k: results[i].stats[k] for k in keep})
                        for i in ids]}


def case_snn_layout(batch=4):
    """`vgg9_infer_hybrid_sharded`'s outputs on a 2-device mesh, as shapes."""
    import jax
    from repro.configs import vgg9_snn
    from repro.launch.mesh import make_data_mesh
    from repro.models.vgg9 import init_vgg9, vgg9_infer_hybrid_sharded
    out = {}
    for name in ("TINY", "TINY_INT4"):
        cfg = getattr(vgg9_snn, name)
        params = init_vgg9(jax.random.PRNGKey(0), cfg)
        images = jax.random.uniform(jax.random.PRNGKey(1),
                                    (batch, cfg.img_hw, cfg.img_hw, cfg.in_ch))
        logits, counts, stats = vgg9_infer_hybrid_sharded(
            params, images, cfg, mesh=make_data_mesh(2), return_stats=True)
        out[name] = jax.tree.map(lambda x: tuple(x.shape), (logits, counts, stats))
    return out


def case_snn_cli(argv):
    """The reference CLI (``launch.serve.main``) on these argv: its stdout,
    and the weights and images it drew."""
    import contextlib
    import io
    import jax
    from repro.configs import vgg9_snn
    from repro.launch import serve
    from repro.models.vgg9 import init_vgg9
    buf = io.StringIO()
    sys.argv = ["serve"] + list(argv)
    with contextlib.redirect_stdout(buf):
        serve.main()
    args = dict(zip(argv[::2], argv[1::2]))
    seed, n = int(args.get("--seed", 0)), int(args.get("--requests", 4))
    cfg = vgg9_snn.TINY
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), n)
    return {"stdout": buf.getvalue(),
            "params": _np(init_vgg9(jax.random.PRNGKey(seed), cfg)),
            "images": [_np(jax.random.uniform(k, (cfg.img_hw, cfg.img_hw, cfg.in_ch)))
                       for k in keys]}


def _tp_mesh():
    import jax
    return jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def case_tp_step(cfg, params, batch, lr, ckpt_dir=""):
    """The reference's GSPMD step on a (2, 2) ``('data', 'model')`` mesh,
    as `tests/test_dist.py`'s sharded case runs it, on carried weights (laid
    out by `param_specs`) and a global batch over 'data': the loss and
    gradients, and one AdamW step; the new state written to ``ckpt_dir``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.dist import sharding as shd
    from repro.dist.context import compute_mesh
    from repro.models import transformer as tf
    from repro.train import checkpoint as ckpt
    from repro.train.optim import adamw
    from repro.train.schedule import constant
    from repro.train.train_step import init_train_state, make_train_step
    cfg = _arch(cfg)
    mesh = _tp_mesh()
    opt = adamw(weight_decay=0.0)
    loss_fn = lambda p, b: tf.train_loss(p, b, cfg)  # noqa: E731
    with mesh, compute_mesh(mesh):
        p = jax.tree.map(jnp.asarray, params)
        specs = shd.param_specs(jax.eval_shape(lambda: p), mesh, fsdp_experts=cfg.fsdp_experts)
        p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), p, specs,
                         is_leaf=lambda x: isinstance(x, P))
        bs = NamedSharding(mesh, P("data", None))
        b = jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), bs), batch)
        step = make_train_step(loss_fn, opt, constant(lr))

        def grads_and_step(p, b):
            return jax.value_and_grad(loss_fn)(p, b), step(init_train_state(p, opt), b)
        (loss, grads), (state2, m) = jax.jit(grads_and_step)(p, b)
        state2 = jax.device_get(state2)
    if ckpt_dir:
        ckpt.save(ckpt_dir, 1, state2)
    return {"loss": float(loss), "grads": _np(grads), "state": _np(state2),
            "step_loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def case_tp_batch(batch):
    """Each device's rows of ``batch`` under ``NamedSharding(mesh,
    P('data', None))`` on the (2, 2) mesh, keyed by its flat mesh position
    (row-major: data * 2 + model)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = _tp_mesh()
    out = {}
    for key, x in batch.items():
        arr = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None)))
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for pos, dev in enumerate(mesh.devices.flat):
            out.setdefault(pos, {})[key] = by_dev[dev]
    return out


CASES = {k[5:]: v for k, v in dict(globals()).items() if k.startswith("case_")}


def main(inp_path, out_path):
    with open(inp_path, "rb") as f:
        cases = pickle.load(f)["cases"]
    out = {}
    for name, kw in cases:
        key = kw.pop("key", name)
        out[key] = CASES[name](**kw)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.abspath(os.path.join(HERE, "..", "src")))
    main(*sys.argv[1:])
