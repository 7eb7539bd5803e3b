"""State, batch and cache builders for the dry run, with no allocation.

The reference builds ``ShapeDtypeStruct`` trees with ``jax.eval_shape``;
the port builds the same trees as fake tensors: call these under a
``torch._subclasses.fake_tensor.FakeTensorMode``, where ``init_params``
draws its random weights as shapes only, so 34B-400B parameter trees never
materialize. Layouts come from the port's `dist.sharding` rules; on a
mesh with a model axis wider than 1 the state is placed as the step takes
it (DTensors, `dist.sharding.place`). Token ids are int64, the dtype the
port's steps take (`data.synthetic.token_batch`), where the reference's
are int32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..dist import sharding as shd
from ..models import transformer as tf
from ..train.optim import make_optimizer
from ..train.schedule import warmup_cosine
from ..train.train_step import init_train_state, make_train_step
from ..train.tree import keystr, tree_leaves_with_path, tree_map


def batch_shapes(cfg: ArchConfig, shape: ShapeConfig, device="cuda") -> Dict[str, torch.Tensor]:
    """The step's global batch as zero tensors (fake under a fake mode)."""
    b = shape.global_batch
    ids = dict(dtype=torch.int64, device=device)
    if shape.kind == "decode":
        return {"tokens": torch.zeros((b, 1), **ids)}
    s_tok = shape.seq_len - (cfg.n_frontend_tokens if cfg.frontend else 0)
    specs = {"tokens": torch.zeros((b, s_tok), **ids)}
    if shape.kind == "train":
        specs["labels"] = torch.zeros((b, s_tok), **ids)
    if cfg.frontend:
        specs["frontend_embeds"] = torch.zeros((b, cfg.n_frontend_tokens, cfg.d_frontend),
                                               dtype=getattr(torch, cfg.dtype), device=device)
    return specs


def param_shapes(cfg: ArchConfig, device="cuda"):
    """The init tree (`models.transformer.init_params`, seed 0)."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(0)
    return tf.init_params(gen, cfg, device)


def count_params(cfg: ArchConfig, device="cpu") -> Tuple[int, int]:
    """(total, active) parameter counts; active discounts unrouted experts.
    Builds the tree on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        shapes = param_shapes(cfg, device)
    total = active = 0
    for path, leaf in tree_leaves_with_path(shapes):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
        key = keystr(path)
        if "experts" in key and cfg.n_experts:
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n
    return int(total), int(active)


def _place(tree, mesh, fsdp_experts: bool = False):
    """``tree`` as the step takes it on ``mesh``: placed under a model axis
    wider than 1, else as it is."""
    if getattr(mesh, "device_mesh", None) is None:
        return tree
    return shd.place(tree, mesh, fsdp_experts)


def placed_by(tree, spec_tree, mesh):
    """``tree`` (whole tensors) laid out leaf by leaf by ``spec_tree``:
    DTensors under a model axis wider than 1, else as it is."""
    if getattr(mesh, "device_mesh", None) is None:
        return tree
    dm = mesh.device_mesh
    return tree_map(lambda x, s: x if x.ndim == 0 else shd._from_full(
        x, dm, shd.to_placements(s, dm)), tree, spec_tree)


def make_train_objects(cfg: ArchConfig, shape: ShapeConfig, mesh, device="cuda"):
    """(step_fn, state, batch, state_specs, batch_specs): the train step
    (donating its state, as the reference's dry run compiles it), the
    fake state laid out on ``mesh``, the global batch, and their
    `dist.sharding` specs (``params`` by `param_specs`, ``opt`` by
    `zero1_opt_specs`, ``step`` replicated)."""
    opt = make_optimizer(cfg.optimizer)
    lr_fn = warmup_cosine(3e-4, 200, 10_000)
    p_shapes = param_shapes(cfg, device)
    p_part = shd.param_specs(p_shapes, mesh, cfg.fsdp_experts)
    opt_part = shd.zero1_opt_specs(opt.init(p_shapes), p_part, mesh)
    state = init_train_state(_place(p_shapes, mesh, cfg.fsdp_experts), opt)
    del p_shapes
    b_specs = batch_shapes(cfg, shape, device)
    grad_sh = (shd.placements(state["params"], mesh, cfg.fsdp_experts)
               if getattr(mesh, "device_mesh", None) is not None else None)
    step_fn = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt, lr_fn,
                              grad_shardings=grad_sh, grad_dtype=cfg.grad_dtype, donate=True)
    state_part = {"params": p_part, "opt": opt_part, "step": shd.P()}
    return step_fn, state, b_specs, state_part, shd.batch_spec(b_specs, mesh)


def make_decode_objects(cfg: ArchConfig, shape: ShapeConfig, mesh, device="cuda"):
    """(step_fn, (params, cache, batch, pos), (their specs)). The decode
    step writes its cache in place (`models.transformer.decode_step`): the
    port's counterpart of the reference's ``donate_argnums=(1,)``."""
    p_shapes = param_shapes(cfg, device)
    p_part = shd.param_specs(p_shapes, mesh, cfg.fsdp_experts)
    params = _place(p_shapes, mesh, cfg.fsdp_experts)
    del p_shapes
    cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len, device)
    cache_part = shd.cache_specs(cache, mesh)
    cache = placed_by(cache, cache_part, mesh)
    b_specs = batch_shapes(cfg, shape, device)
    pos = shape.seq_len - 1

    def step_fn(params, cache, batch, pos):
        with torch.no_grad():
            return tf.decode_step(params, cache, batch, pos, cfg)

    return (step_fn, (params, cache, b_specs, pos),
            (p_part, cache_part, shd.batch_spec(b_specs, mesh), shd.P()))


def make_prefill_objects(cfg: ArchConfig, shape: ShapeConfig, mesh, device="cuda"):
    """(step_fn, (params, batch), (their specs))."""
    p_shapes = param_shapes(cfg, device)
    p_part = shd.param_specs(p_shapes, mesh, cfg.fsdp_experts)
    params = _place(p_shapes, mesh, cfg.fsdp_experts)
    del p_shapes
    b_specs = batch_shapes(cfg, shape, device)

    def step_fn(params, batch):
        with torch.no_grad():
            return tf.prefill_step(params, batch, cfg)

    return step_fn, (params, b_specs), (p_part, shd.batch_spec(b_specs, mesh))
