"""Train-step builder: loss -> grads -> clip -> schedule -> optimizer update.

Features: microbatch gradient accumulation, global-norm clipping, pluggable
optimizer and schedule, a gradient dtype cast before the reduction, and
data parallelism over a ``torch.distributed`` process group
(`launch.mesh.ProcessMesh`), in two forms:

* plain: under an ambient process-group mesh (``compute_mesh``) whose
  ``'data'`` axis has n > 1 ranks, the step takes the *global* batch, keeps
  this rank's rows, and averages gradients and loss in fp32 over the axis
  before clipping, summing the ranks' values in rank order — the
  reduction the reference's GSPMD step under ``compute_mesh(make_host_mesh())``
  leaves implicit;
* compressed: ``make_train_step(compress_axis=...)`` reduces with the
  error-feedback int8 ``dist.compression.compressed_psum`` and threads each
  rank's residual through ``state['grad_err']``;
  `shard_map_compressed_step` wraps it to take the global batch.

Either way every rank ends a step with the same parameter and optimizer
bits.

Tensor parallelism: under a ``(data, model)`` mesh with more than one
model rank (`launch.mesh.make_process_mesh`), the state holds the placed
tree (`dist.sharding.place`: parameters and their SGD / AdamW moments as
DTensors, each rank its `param_spec` shards). The step takes the global
batch (or a `data.pipeline.DataPipeline` batch of this rank's rows), the
model computes on the shards (`models.transformer`), each gradient comes
back as its parameter's shard (held to ``grad_shardings`` where given),
the gradients and loss are averaged over the ``'data'`` group in rank
order as above, the global norm counts each shard once, and the
optimizer updates each shard. The data replicas of every shard end the
step with the same bits; shards of different model ranks differ by
design.

Steps run under `deterministic`: the same state and batch give
bit-identical parameters and optimizer state run to run on the card too
(cuDNN's default weight-gradient algorithms sum in a run-dependent order),
so a crash -> resume replays the clean run bit for bit.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..dist.context import compute_mesh, current_mesh
from ..dist.sharding import local
from ..launch.mesh import ProcessMesh
from .optim import Optimizer, apply_updates, clip_by_global_norm
from .tree import tree_leaves_with_path, tree_map, tree_map_with_path


@contextlib.contextmanager
def deterministic() -> Iterator[None]:
    """Run the body with deterministic algorithms only: cuDNN's
    deterministic convolutions without autotuning, and
    ``torch.use_deterministic_algorithms`` (an op with no deterministic
    implementation raises instead of running). cuBLAS also needs a fixed
    workspace, which importing `repro_torch` sets
    (``CUBLAS_WORKSPACE_CONFIG``). The previous settings are restored on
    exit, so serving keeps its own."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:]


def init_train_state(params: Any, opt: Optimizer, *, compress: bool = False) -> Dict[str, Any]:
    """Train state: ``{"params", "opt", "step"}`` (``step`` an int32 0-d tensor
    on the params' device). With ``compress=True`` it also carries
    ``grad_err``, zero float32 residuals shaped like ``params``: the
    rank-local error-feedback state a ``compress_axis`` step consumes."""
    device = tree_leaves_with_path(params)[0][1].device
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if compress:
        from ..dist.compression import init_error_state
        state["grad_err"] = init_error_state(params)
    return state


def data_mesh() -> Optional[ProcessMesh]:
    """The ambient process-group mesh when its 'data' axis has more than
    one rank, else None."""
    mesh = current_mesh()
    return mesh if isinstance(mesh, ProcessMesh) and mesh.shape["data"] > 1 else None


def tp_mesh() -> Optional[ProcessMesh]:
    """The ambient process-group mesh when its 'model' axis has more than
    one rank, else None."""
    mesh = current_mesh()
    return mesh if isinstance(mesh, ProcessMesh) and mesh.device_mesh is not None else None


def _rewrap(new, like):
    """``new`` (a local shard) as a DTensor laid out as ``like``; plain
    tensors pass."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor):
        return new
    return DTensor.from_local(new, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def _hold(g, placements):
    """A DTensor gradient relaid to ``placements`` where it differs."""
    from torch.distributed.tensor import DTensor
    from ..dist.sharding import _from_full, full_tensor
    if placements is None or not isinstance(g, DTensor) \
            or tuple(g.placements) == tuple(placements):
        return g
    return _from_full(full_tensor(g), g.device_mesh, placements)


def _batch_rows(batch: Dict, mesh: ProcessMesh) -> Dict:
    """This rank's rows: a `DataPipeline` batch on a mesh already is (its
    DTensor leaves' local shards), a global batch is cut by data rank."""
    from torch.distributed.tensor import DTensor
    leaves = [x for _, x in tree_leaves_with_path(batch)]
    if any(isinstance(x, DTensor) for x in leaves):
        return tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x, batch)
    if mesh.shape["data"] == 1:
        return batch
    return local_rows(batch, mesh.data_rank, mesh.shape["data"])


def local_rows(batch: Dict, rank: int, n: int) -> Dict:
    """Rank ``rank``'s contiguous rows of every leaf with a leading dim
    (the reference's ``P('data')`` batch layout); 0-d leaves pass."""
    def rows(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} does not divide over {n} ranks")
        b = x.shape[0] // n
        return x[rank * b:(rank + 1) * b]
    return tree_map(rows, batch)


def gather_rows(flat: torch.Tensor, group=None) -> torch.Tensor:
    """``[n, *flat.shape]``: every rank's ``flat`` in rank order, the same
    bits on every rank. One ``all_reduce(SUM)`` of a stack holding this
    rank's row and zeros elsewhere (adding zeros is exact, up to the sign
    of a zero), which both NCCL and gloo (CUDA tensors included) take; it
    moves n times the bytes of one buffer."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    rows = torch.zeros((n,) + tuple(flat.shape), dtype=flat.dtype, device=flat.device)
    rows[r] = flat
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    return rows


def rank_order_mean(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The fp32 mean of each tensor over ``group``'s ranks, summed in rank
    order (((x0 + x1) + x2) + ...) / n, cast back to its dtype: one fixed
    order, so every rank gets the same bits. Two ranks' sum is one
    addition per element, the same either way round, so there it is a
    plain ``all_reduce(SUM)`` (half the bytes of the stack of rows)."""
    flat = torch.cat([t.to(torch.float32).reshape(-1) for t in tensors])
    n = dist.get_world_size(group)
    if n == 2:
        total = flat
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    else:
        rows = gather_rows(flat, group)
        total = rows[0].clone()
        for row in rows[1:]:
            total += row
    total = total / torch.tensor(float(n), dtype=torch.float32, device=total.device)
    out, at = [], 0
    for t in tensors:
        out.append(total[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def _axis_group(axis: str):
    mesh = current_mesh()
    if isinstance(mesh, ProcessMesh) and axis in mesh.axis_names:
        return mesh.group(axis)
    raise RuntimeError(
        f"compress_axis={axis!r} reduces over a process group: run the step under "
        "compute_mesh(launch.mesh.make_host_mesh()) or through shard_map_compressed_step")


def value_and_grad(loss_fn: Callable[[Any, Dict], torch.Tensor]):
    """``loss_fn(params, batch) -> scalar`` as ``(params, batch) -> (loss, grads)``,
    the loss detached and ``grads`` a tree like ``params`` (zeros where the
    loss does not depend on a leaf). ``params`` themselves are not modified.
    Runs under `deterministic`."""
    def fn(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad(), deterministic():
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
    metrics)`` and leaves its input state unchanged; it runs under
    `deterministic`.

    grad_dtype: cast each gradient to this dtype (e.g. "bfloat16") before
    the cross-rank reduction, as the reference does.

    compress_axis: the mesh axis whose process group the error-feedback
    int8 `dist.compression.compressed_psum` reduces over, under an ambient
    `launch.mesh.ProcessMesh`. The state must come from
    ``init_train_state(compress=True)`` and holds this rank's residual; the
    batch is this rank's rows (`shard_map_compressed_step` takes the global
    batch instead). The loss metric is averaged over the axis.
    ``compress_per_channel`` takes one scale per last-axis channel.

    Without ``compress_axis``, under an ambient process-group mesh with more
    than one 'data' rank, the step is the plain data-parallel one; with
    more than one 'model' rank, the tensor-parallel one (module docstring).

    grad_shardings: a tree like the parameters of DTensor placements
    (`dist.sharding.placements`; None entries: as computed): each DTensor
    gradient is held to its entry's layout (relaid where it differs), and
    the update then uses its parameter's. Plain-tensor gradients (one
    device, a data-parallel mesh) have no layout to hold."""
    if compress_per_channel and not compress_axis:
        raise ValueError("compress_per_channel needs compress_axis")
    value_grad = value_and_grad(loss_fn)
    dtype = getattr(torch, grad_dtype) if grad_dtype else None

    def grad_fn(params, batch):
        loss, grads = value_grad(params, batch)
        if grad_shardings is not None:
            grads = tree_map(_hold, grads, grad_shardings)
        # the update's layout is the parameter's; the optimizer runs on shards
        grads = tree_map(lambda g, p: _hold(g, getattr(p, "placements", None)), grads, params)
        grads = local(grads)
        if dtype is not None:
            grads = tree_map(lambda g: g.to(dtype), grads)
        return loss, grads

    def compute_grads(params, batch):
        if accum_steps == 1:
            return grad_fn(params, batch)

        def micro(i):
            return {k: (x.reshape((accum_steps, x.shape[0] // accum_steps) + x.shape[1:])[i]
                        if hasattr(x, "shape") and x.ndim > 0 else x)
                    for k, x in batch.items()}

        loss = torch.zeros((), dtype=torch.float32)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), local(params))
        for i in range(accum_steps):
            loss_i, grads_i = grad_fn(params, micro(i))
            grads = tree_map(lambda a, g: a + g.to(torch.float32) / accum_steps, grads, grads_i)
            loss = loss.to(loss_i.device) + loss_i / accum_steps
        return loss, grads

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        tp = None if compress_axis else tp_mesh()
        if tp is not None:
            return _tp_step(state, batch, tp)
        with deterministic():
            mesh = None if compress_axis else data_mesh()
            if mesh is not None:
                batch = local_rows(batch, mesh.data_rank, mesh.shape["data"])
            loss, grads = compute_grads(state["params"], batch)
            new_err = None
            with torch.no_grad():
                if compress_axis:
                    from ..dist.compression import compressed_psum
                    group = _axis_group(compress_axis)
                    grads, new_err = compressed_psum(grads, state["grad_err"], group,
                                                     per_channel=compress_per_channel)
                    loss, = rank_order_mean([loss], group)
                elif mesh is not None:
                    paths = [p for p, _ in tree_leaves_with_path(grads)]
                    loss, *means = rank_order_mean(
                        [loss] + [g for _, g in tree_leaves_with_path(grads)], mesh.group())
                    by_path = dict(zip(paths, means))
                    grads = tree_map_with_path(lambda p, _: by_path[p], grads)
                grads, gnorm = clip_by_global_norm(grads, clip_norm)
                lr = lr_fn(state["step"])
                updates, new_opt = opt.update(grads, state["opt"], state["params"], lr)
                new_params = apply_updates(state["params"], updates)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        if new_err is not None:
            new_state["grad_err"] = new_err
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    def _tp_step(state: Dict, batch: Dict, mesh: ProcessMesh) -> Tuple[Dict, Dict]:
        from torch.distributed.tensor import DTensor, Shard
        params, opt_state = state["params"], state["opt"]
        for path, x in tree_leaves_with_path(opt_state):
            if x.ndim and not isinstance(x, DTensor):
                raise NotImplementedError(
                    f"optimizer leaf {path} is not laid out like a parameter: under tensor "
                    "parallelism the step updates SGD and AdamW state (elementwise moments), "
                    "not Adafactor's factored rows and columns")
        with deterministic():
            loss, grads = compute_grads(params, _batch_rows(batch, mesh))
            with torch.no_grad():
                # which groups each leaf is split over; a leaf split over
                # 'data' (FSDP experts) had its gradient averaged there in
                # the backward, every other one is averaged here
                shards = tree_map(lambda p: tuple(
                    mesh.group(name) for name, pl in zip(p.device_mesh.mesh_dim_names,
                                                         p.placements)
                    if isinstance(pl, Shard)) if isinstance(p, DTensor) else (), params)
                data_split = tree_map(lambda p: isinstance(p, DTensor) and isinstance(
                    p.placements[0], Shard), params)
                if mesh.shape["data"] > 1:
                    # leaf by leaf (the same bits as one buffer: the mean is
                    # elementwise), so the rows in flight are one leaf's
                    group = mesh.group("data")
                    loss, = rank_order_mean([loss], group)
                    grads = tree_map(lambda g, split: g if split
                                     else rank_order_mean([g], group)[0], grads, data_split)
                grads, gnorm = clip_by_global_norm(grads, clip_norm, shards)
                lr = lr_fn(state["step"])
                by_path = dict(tree_leaves_with_path(grads))
                del grads                    # each gradient is released once used
                new_params, new_opt = _update_by_leaf(opt, by_path, local(opt_state),
                                                      local(params), lr)
        new_state = {"params": tree_map(_rewrap, new_params, params),
                     "opt": tree_map(_rewrap, new_opt, opt_state), "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def _update_by_leaf(opt: Optimizer, g_by: Dict, opt_state: Dict, params: Any, lr
                    ) -> Tuple[Any, Dict]:
    """``opt.update`` and `apply_updates` one parameter leaf at a time ->
    (new params, new optimizer state): the same numbers as one call over
    the trees (an SGD or AdamW update is elementwise within a leaf, given
    the step's scalars), with one leaf's temporaries alive at a time.
    ``g_by`` maps each parameter's path to its gradient, and each is
    popped (released) once used. The optimizer state's entries that mirror
    the parameters (``m`` / ``v``, ``mu``) are cut per leaf; the others
    (``t``) are passed whole."""
    paths = [p for p, _ in tree_leaves_with_path(params)]
    mirrors = [k for k, v in opt_state.items() if isinstance(v, (dict, tuple, list))]
    by_key = {k: dict(tree_leaves_with_path(opt_state[k])) for k in mirrors}
    scalars = {k: v for k, v in opt_state.items() if k not in mirrors}
    p_by = dict(tree_leaves_with_path(params))
    new_p, new_s, rest = {}, {k: {} for k in mirrors}, scalars
    for path in paths:
        leaf_state = dict(scalars, **{k: by_key[k][path] for k in mirrors})
        upd, leaf_new = opt.update(g_by.pop(path), leaf_state, p_by[path], lr)
        new_p[path] = apply_updates(p_by[path], upd)
        for k in mirrors:
            new_s[k][path] = leaf_new[k]
        rest = {k: v for k, v in leaf_new.items() if k not in mirrors}
    new_opt = dict(rest, **{k: tree_map_with_path(lambda p, _: new_s[k][p], opt_state[k])
                            for k in mirrors})
    return tree_map_with_path(lambda p, _: new_p[p], params), new_opt


def stack_error_state(state: Dict, n_shards: int) -> Dict:
    """``state`` with zero ``grad_err`` leaves of the reference's stacked
    layout: a leading ``[n_shards]`` rank axis (row r is rank r's residual).
    `shard_map_compressed_step` takes it; checkpoints store it."""
    return dict(state, grad_err=tree_map(
        lambda e: torch.zeros((n_shards,) + tuple(e.shape), dtype=e.dtype, device=e.device),
        state["grad_err"]))


def shard_map_compressed_step(step, mesh: ProcessMesh, data_axis: str = "data"):
    """Run a ``compress_axis`` step data-parallel over ``mesh``'s process group.

    The wrapped step takes the *global* batch and keeps this rank's rows,
    and takes ``grad_err`` either in the stacked ``[n, ...]`` layout
    (`stack_error_state`, e.g. a fresh or restored state: this rank uses
    row ``rank``) or as this rank's ``[1, ...]`` block, which is what it
    returns. The compressed reduction gives every rank the same mean
    gradients, so params and optimizer state stay bit-identical across
    ranks. The step runs with ``mesh`` as the ambient compute mesh.
    """
    n = int(mesh.shape[data_axis])

    def local_block(e):
        if e.shape[0] == n:
            return e[mesh.rank]
        if e.shape[0] == 1:
            return e[0]
        raise ValueError(f"grad_err leading dim {e.shape[0]}: expected {n} (stacked) or 1")

    def wrapped(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        state = dict(state, grad_err=tree_map(local_block, state["grad_err"]))
        with compute_mesh(mesh):
            new_state, metrics = step(state, local_rows(batch, mesh.rank, n))
        new_state["grad_err"] = tree_map(lambda e: e[None], new_state["grad_err"])
        return new_state, metrics

    return wrapped


def gather_error_state(state: Dict, mesh: ProcessMesh, data_axis: str = "data") -> Dict:
    """``state`` with ``grad_err`` in the stacked ``[n, ...]`` layout, every
    rank's ``[1, ...]`` block gathered in rank order (the same on every
    rank); a state already stacked, or one without residuals, is returned
    as it is."""
    n = int(mesh.shape[data_axis])
    if "grad_err" not in state:
        return state
    leaves = tree_leaves_with_path(state["grad_err"])
    if leaves[0][1].shape[0] == n:
        return state
    rows = gather_rows(torch.cat([e.reshape(-1) for _, e in leaves]), mesh.group(data_axis))
    by_path, at = {}, 0
    for path, e in leaves:
        by_path[path] = rows[:, at:at + e.numel()].reshape((n,) + tuple(e.shape[1:]))
        at += e.numel()
    return dict(state, grad_err=tree_map_with_path(lambda p, _: by_path[p], state["grad_err"]))
