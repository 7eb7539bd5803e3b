"""Train-step builder: loss -> grads -> clip -> schedule -> optimizer update.

Features: microbatch gradient accumulation, global-norm clipping, pluggable
optimizer and schedule. Gradients come from autograd through the surrogate
spike and the QAT straight-through estimator. What the JAX package adds for
distribution (gradient shardings, gradient dtype casts before the
all-reduce, error-feedback int8 compression) arrives with distribution:
asking for it raises `NotImplementedError`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from .optim import Optimizer, apply_updates, clip_by_global_norm
from .tree import tree_leaves_with_path, tree_map


def init_train_state(params: Any, opt: Optimizer, *, compress: bool = False) -> Dict[str, Any]:
    """Train state: ``{"params", "opt", "step"}`` (``step`` an int32 0-d tensor
    on the params' device)."""
    if compress:
        raise NotImplementedError("gradient compression arrives with distribution")
    device = tree_leaves_with_path(params)[0][1].device
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def value_and_grad(loss_fn: Callable[[Any, Dict], torch.Tensor]):
    """``loss_fn(params, batch) -> scalar`` as ``(params, batch) -> (loss, grads)``,
    the loss detached and ``grads`` a tree like ``params`` (zeros where the
    loss does not depend on a leaf). ``params`` themselves are not modified."""
    def fn(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = loss_fn(leaves, batch)
            paths = tree_leaves_with_path(leaves)
            grads = torch.autograd.grad(loss, [leaf for _, leaf in paths], allow_unused=True)
        by_id = {id(leaf): g if g is not None else torch.zeros_like(leaf)
                 for (_, leaf), g in zip(paths, grads)}
        return loss.detach(), tree_map(lambda leaf: by_id[id(leaf)], leaves)
    return fn


def make_train_step(
    loss_fn: Callable[[Any, Dict], torch.Tensor],
    opt: Optimizer,
    lr_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    accum_steps: int = 1,
    clip_norm: float = 1.0,
    grad_shardings: Any = None,
    grad_dtype: str = "",
    compress_axis: str = "",
    compress_per_channel: bool = False,
) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """loss_fn(params, batch) -> scalar. With ``accum_steps`` > 1 the batch's
    leading dim is split into that many microbatches, whose gradients and
    losses are averaged in float32 (one backward each, so memory holds one
    microbatch's graph). The returned step is ``(state, batch) -> (state,
    metrics)`` and leaves its input state unchanged."""
    if grad_shardings is not None or grad_dtype or compress_axis or compress_per_channel:
        raise NotImplementedError(
            "grad_shardings / grad_dtype / compress_axis arrive with distribution")
    grad_fn = value_and_grad(loss_fn)

    def compute_grads(params, batch):
        if accum_steps == 1:
            return grad_fn(params, batch)

        def micro(i):
            return {k: (x.reshape((accum_steps, x.shape[0] // accum_steps) + x.shape[1:])[i]
                        if hasattr(x, "shape") and x.ndim > 0 else x)
                    for k, x in batch.items()}

        loss = torch.zeros((), dtype=torch.float32)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(accum_steps):
            loss_i, grads_i = grad_fn(params, micro(i))
            grads = tree_map(lambda a, g: a + g.to(torch.float32) / accum_steps, grads, grads_i)
            loss = loss.to(loss_i.device) + loss_i / accum_steps
        return loss, grads

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        loss, grads = compute_grads(state["params"], batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            lr = lr_fn(state["step"])
            updates, new_opt = opt.update(grads, state["opt"], state["params"], lr)
            new_params = apply_updates(state["params"], updates)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step
