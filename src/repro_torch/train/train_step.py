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
model rank (`launch.mesh.make_process_mesh`; ``(pod, data, model)`` for
the dry run's production mesh), the state holds the placed tree
(`dist.sharding.place`: parameters and their SGD / AdamW moments as
DTensors, each rank its `param_spec` shards; Adafactor's moments laid out
by `dist.sharding.zero1_opt_specs`, `init_train_state`). The step takes
the global batch (or a `data.pipeline.DataPipeline` batch of this rank's
rows), the model computes on the shards (`models.transformer`), each
gradient comes back as its parameter's shard (held to ``grad_shardings``
where given), the gradients and loss are averaged over the data-parallel
axes' group (``('pod', 'data')``) in rank order as above, the global norm
counts each shard once, and the optimizer updates each shard; Adafactor
takes its row, column and RMS means over whole leaves (`_ShardMeans`).
The data replicas of every shard end the step with the same bits; shards
of different model ranks differ by design.

``make_train_step(donate=True)`` is the counterpart of the reference's
donated step: each new leaf is written into the input state's buffer as
it is computed (`_update_by_leaf`), with the functional step's bits.

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
from .optim import LeafMeans, Optimizer, apply_updates, clip_by_global_norm, clip_scale
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
    rank-local error-feedback state a ``compress_axis`` step consumes.

    From placed parameters (`dist.sharding.place`), SGD's and AdamW's
    moments are laid out as their parameters, and Adafactor's moments
    (``s``: per parameter ``vr`` / ``vc``, or ``v``) as
    `dist.sharding.zero1_opt_specs` gives them: on their own shapes, the
    first divisible dim over ``'data'``."""
    device = tree_leaves_with_path(params)[0][1].device
    state = {"params": params, "opt": _place_factored(opt.init(params), params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if compress:
        from ..dist.compression import init_error_state
        state["grad_err"] = init_error_state(params)
    return state


def _place_factored(opt_state: Dict, params) -> Dict:
    """Adafactor's ``s`` moments placed by `zero1_opt_specs` where the
    parameters are DTensors; any other state as it is."""
    from torch.distributed.tensor import DTensor
    from ..dist.sharding import _from_full, full_tensor, to_placements, zero1_opt_specs
    leaves = [x for _, x in tree_leaves_with_path(params)]
    dtensors = [x for x in leaves if isinstance(x, DTensor)]
    if not dtensors or "s" not in opt_state:
        return opt_state
    dm = dtensors[0].device_mesh

    class _View:                          # the rules read axis names and sizes
        axis_names = tuple(dm.mesh_dim_names)
        shape = {n: dm.size(i) for i, n in enumerate(dm.mesh_dim_names)}

    specs = zero1_opt_specs(opt_state["s"], {}, _View)
    placed = tree_map(lambda x, spec: _from_full(full_tensor(x), dm, to_placements(spec, dm)),
                      opt_state["s"], specs)
    return dict(opt_state, s=placed)


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
    tensors, and DTensors already, pass."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor) or isinstance(new, DTensor):
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
    DTensor leaves' local shards), a global batch is cut by the rank's
    place on the data-parallel axes (``('pod', 'data')``)."""
    from torch.distributed.tensor import DTensor
    leaves = [x for _, x in tree_leaves_with_path(batch)]
    if any(isinstance(x, DTensor) for x in leaves):
        return tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x, batch)
    if mesh.dp_size == 1:
        return batch
    return local_rows(batch, mesh.dp_rank, mesh.dp_size)


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


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _unstack(x):
    """A stacked ``[n_periods, ...]`` leaf as a tuple of its periods
    (views; a DTensor's periods as DTensors of its layout less dim 0). A
    leaf the rules shard along its period axis (a stacked 1-D leaf whose
    width the axis does not divide, where it divides the periods) is
    gathered over that axis first, its periods replicated there."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from ..dist.tensor_parallel import all_gather
    if not isinstance(x, DTensor):
        return tuple(x[i] for i in range(x.shape[0]))
    loc, pls = x.to_local(), list(x.placements)
    for i, (name, pl) in enumerate(zip(x.device_mesh.mesh_dim_names, pls)):
        if isinstance(pl, Shard) and pl.dim == 0:
            loc, pls[i] = all_gather(loc, 0, x.device_mesh.get_group(name)), Replicate()
    pls = [Shard(pl.dim - 1) if isinstance(pl, Shard) else pl for pl in pls]
    shape = x.shape[1:]
    return tuple(DTensor.from_local(loc[i], x.device_mesh, pls, run_check=False, shape=shape,
                                    stride=_contiguous_stride(shape))
                 for i in range(x.shape[0]))


def _restack(parts, like):
    """The periods' gradients ``parts`` as one leaf laid out as ``like``
    (along a sharded period axis, this rank's periods of the complete
    gradients)."""
    from torch.distributed.tensor import DTensor, Shard
    from ..dist.tensor_parallel import chunk
    if not isinstance(like, DTensor):
        return torch.stack(list(parts))
    stacked = torch.stack([g.to_local() for g in parts])
    mesh = like.device_mesh
    for i, pl in enumerate(like.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            stacked = chunk(stacked, 0, mesh.size(i), mesh.get_local_rank(i)).contiguous()
    return DTensor.from_local(stacked, mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def value_and_grad(loss_fn: Callable[[Any, Dict], torch.Tensor]):
    """``loss_fn(params, batch) -> scalar`` as ``(params, batch) -> (loss, grads)``,
    the loss detached and ``grads`` a tree like ``params`` (zeros where the
    loss does not depend on a leaf). ``params`` themselves are not modified.
    Runs under `deterministic`.

    An LM tree's stacked period leaves (``params['periods']``) reach the
    loss as tuples of per-period views, each its own autograd leaf, and
    each gradient is stacked once at the end: indexing a stacked leaf that
    requires grad would make every period's backward write a zero-filled
    gradient of the whole stack and sum them (traffic quadratic in the
    depth). The gradients' values are the same."""
    def fn(params, batch):
        stacked = isinstance(params, dict) and isinstance(params.get("periods"), dict)
        detached = tree_map(lambda p: p.detach(), params)
        if stacked:
            detached = dict(detached, periods=tree_map(_unstack, detached["periods"]))
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), detached)
        with torch.enable_grad(), deterministic():
            loss = loss_fn(leaves, batch)
            paths = tree_leaves_with_path(leaves)
            grads = torch.autograd.grad(loss, [leaf for _, leaf in paths], allow_unused=True)
        by_id = {id(leaf): g if g is not None else torch.zeros_like(leaf)
                 for (_, leaf), g in zip(paths, grads)}
        del grads
        out = tree_map(lambda leaf: by_id.pop(id(leaf)), leaves)
        if stacked:                  # each leaf's periods released once stacked
            periods = out.pop("periods")
            out["periods"] = tree_map_with_path(
                lambda path, like: _restack(_subtree(periods, path[:-1]).pop(path[-1]), like),
                params["periods"])
        return loss.detach(), out
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
    donate: bool = False,
) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """loss_fn(params, batch) -> scalar. With ``accum_steps`` > 1 the batch's
    leading dim is split into that many microbatches, whose gradients and
    losses are averaged in float32 (one backward each, so memory holds one
    microbatch's graph). The returned step is ``(state, batch) -> (state,
    metrics)``; it runs under `deterministic`.

    donate: False (the default) leaves the input state unchanged and
    returns a new one. True is the counterpart of the reference's
    ``jax.jit(step, donate_argnums=(0,))``: the step writes each new
    parameter and optimizer leaf into the input state's buffer as soon as
    that leaf's update is computed (one leaf's temporaries alive at a time,
    never a second copy of the state), writes the optimizer's counters and
    the step counter last, and returns the input state object itself. The
    arithmetic is the functional step's, in its order: the bits are the
    same.

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
    device, a data-parallel mesh) have no layout to hold.

    The step's second half is exposed as ``step.apply_grads(state, loss,
    grads)``: from gradients as the backward leaves them (before their
    layouts are held) to the new state and metrics, ``loss`` None for a
    part of a model that has none. `launch.costing` builds its pieces
    from it."""
    if compress_per_channel and not compress_axis:
        raise ValueError("compress_per_channel needs compress_axis")
    value_grad = value_and_grad(loss_fn)
    dtype = getattr(torch, grad_dtype) if grad_dtype else None

    def prepare(grads, params):
        if grad_shardings is not None:
            grads = tree_map(_hold, grads, grad_shardings)
        # the update's layout is the parameter's; the optimizer runs on shards
        grads = tree_map(lambda g, p: _hold(g, getattr(p, "placements", None)), grads, params)
        grads = local(grads)
        if dtype is not None:
            grads = tree_map(lambda g: g.to(dtype), grads)
        return grads

    def grad_fn(params, batch):
        loss, grads = value_grad(params, batch)
        return loss, prepare(grads, params)

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
        with deterministic():
            if tp is not None:
                batch = _batch_rows(batch, tp)
            else:
                mesh = None if compress_axis else data_mesh()
                if mesh is not None:
                    batch = local_rows(batch, mesh.data_rank, mesh.shape["data"])
            loss, grads = compute_grads(state["params"], batch)
            # handed over in a box, so that no caller's frame keeps the
            # gradients alive while the update releases them leaf by leaf
            box = [grads]
            del grads
            return finish(state, loss, box, tp)

    def apply_grads(state: Dict, loss, grads) -> Tuple[Dict, Dict]:
        tp = None if compress_axis else tp_mesh()
        with deterministic():
            return finish(state, loss, [prepare(grads, state["params"])], tp)

    def finish(state, loss, box, tp):
        with torch.no_grad():
            if tp is not None:
                return _tp_finish(state, loss, box, tp)
            grads = box.pop()
            mesh = None if compress_axis else data_mesh()
            new_err = None
            if compress_axis:
                from ..dist.compression import compressed_psum
                group = _axis_group(compress_axis)
                grads, new_err = compressed_psum(grads, state["grad_err"], group,
                                                 per_channel=compress_per_channel)
                loss, = rank_order_mean([loss], group)
            elif mesh is not None:
                paths = [p for p, _ in tree_leaves_with_path(grads)]
                means = rank_order_mean(([] if loss is None else [loss])
                                        + [g for _, g in tree_leaves_with_path(grads)],
                                        mesh.group())
                if loss is not None:
                    loss, means = means[0], means[1:]
                by_path = dict(zip(paths, means))
                grads = tree_map_with_path(lambda p, _: by_path[p], grads)
            if donate:
                scale, gnorm = clip_scale(grads, clip_norm)
                lr = lr_fn(state["step"])
                by_path = dict(tree_leaves_with_path(grads))
                del grads
                _update_by_leaf(opt, by_path, state["opt"], state["params"], lr, donate=True,
                                scale=scale)
                if new_err is not None:
                    tree_map(lambda old, new: old.copy_(new), state["grad_err"], new_err)
                state["step"].add_(1)
                return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            lr = lr_fn(state["step"])
            updates, new_opt = opt.update(grads, state["opt"], state["params"], lr)
            new_params = apply_updates(state["params"], updates)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        if new_err is not None:
            new_state["grad_err"] = new_err
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    def _tp_finish(state: Dict, loss, box, mesh: ProcessMesh) -> Tuple[Dict, Dict]:
        from torch.distributed.tensor import DTensor, Shard
        params, opt_state = state["params"], state["opt"]
        grads = box.pop()
        for path, x in tree_leaves_with_path(opt_state):
            if x.ndim and not isinstance(x, DTensor):
                raise ValueError(f"optimizer leaf {path} is not placed on the mesh: build the "
                                 "state with init_train_state from placed parameters")
        # which groups each leaf is split over; a leaf split over 'data'
        # (FSDP experts) had its gradient averaged there in the backward,
        # every other one is averaged here over the data-parallel axes
        shards = tree_map(lambda p: tuple(
            mesh.group(name) for name, pl in zip(p.device_mesh.mesh_dim_names, p.placements)
            if isinstance(pl, Shard)) if isinstance(p, DTensor) else (), params)
        data_split = tree_map(lambda p: isinstance(p, DTensor) and any(
            name == "data" and isinstance(pl, Shard)
            for name, pl in zip(p.device_mesh.mesh_dim_names, p.placements)), params)
        if mesh.dp_size > 1:
            # leaf by leaf (the same bits as one buffer: the mean is
            # elementwise), so the rows in flight are one leaf's
            group = mesh.group("dp")
            if loss is not None:
                loss, = rank_order_mean([loss], group)
            pods = mesh.group("pod") if "pod" in mesh.shape else None
            grads = tree_map(lambda g, split: (g if pods is None else rank_order_mean(
                [g], pods)[0]) if split else rank_order_mean([g], group)[0], grads, data_split)
        if donate:                   # each gradient scaled as the update takes it
            scale, gnorm = clip_scale(grads, clip_norm, shards)
        else:
            scale = None
            grads, gnorm = clip_by_global_norm(grads, clip_norm, shards)
        lr = lr_fn(state["step"])
        by_path = dict(tree_leaves_with_path(grads))
        del grads                    # each gradient is released once used
        factored = opt.name == "adafactor"
        opt_local = _adafactor_aligned(opt_state, params) if factored else local(opt_state)
        means = tree_map(lambda p: _ShardMeans.of(p, mesh), params) if factored else None
        new_params, new_opt = _update_by_leaf(opt, by_path, opt_local, local(params), lr,
                                              donate=donate, means=means, scale=scale)
        if factored:
            new_opt = _adafactor_stored(new_opt, opt_state, params, donate)
        if donate:
            state["step"].add_(1)
            return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}
        new_state = {"params": tree_map(_rewrap, new_params, params),
                     "opt": tree_map(_rewrap, new_opt, opt_state), "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    train_step.apply_grads = apply_grads
    return train_step


def _subtree(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# elements per piece of a leaf that a donated SGD / AdamW update takes at once
_CHUNK = 1 << 26


def _rows_of(n_rows: int, row_numel: int):
    """Slices of a leaf's dim 0, each at most `_CHUNK` elements (one row
    at least)."""
    per = max(1, _CHUNK // max(row_numel, 1))
    return [slice(i, min(i + per, n_rows)) for i in range(0, n_rows, per)]


def _update_by_leaf(opt: Optimizer, g_by: Dict, opt_state: Dict, params: Any, lr,
                    donate: bool = False, means: Any = None, scale=None
                    ) -> Tuple[Any, Dict]:
    """``opt.update`` and `apply_updates` one parameter leaf at a time ->
    (new params, new optimizer state): the same numbers as one call over
    the trees (an SGD, AdamW or Adafactor update is leafwise, given the
    step's scalars), with one leaf's temporaries alive at a time.
    ``g_by`` maps each parameter's path to its gradient, and each is
    popped (released) once used; with ``scale`` (the clip's factor) each
    is multiplied by it first, as `optim.clip_by_global_norm` would. The
    optimizer state's entries that mirror the parameters (``m`` / ``v``,
    ``mu``, Adafactor's ``s``: per parameter a tensor or a dict of them)
    are cut per parameter; the others (``t``) are passed whole.

    With ``donate`` each new leaf is written into the old one's buffer at
    once, the counters last, and the input trees are returned; an SGD or
    AdamW update, elementwise, then runs over slices of the leaf's dim 0
    (`_rows_of`), so a stacked leaf's temporaries are a slice's. ``means``
    (Adafactor): a tree like ``params`` of the leaf means its update takes
    (`optim.LeafMeans`)."""
    paths = [p for p, _ in tree_leaves_with_path(params)]
    mirrors = [k for k, v in opt_state.items() if isinstance(v, (dict, tuple, list))]
    scalars = {k: v for k, v in opt_state.items() if k not in mirrors}
    p_by = dict(tree_leaves_with_path(params))
    m_by = dict(tree_leaves_with_path(means)) if means is not None else {}
    elementwise = opt.name in ("sgd", "adamw")
    new_p, new_s, rest = {}, {k: {} for k in mirrors}, scalars
    for path in paths:
        old = {k: _subtree(opt_state[k], path) for k in mirrors}
        g, p = g_by.pop(path), p_by[path]
        if scale is not None:
            g = g * scale
        kw = {"mean": m_by[path]} if path in m_by else {}
        if donate and elementwise and p.ndim:
            for rows in _rows_of(p.shape[0], p[0].numel()):
                part = dict(scalars, **{k: old[k][rows] for k in mirrors})
                upd, leaf_new = opt.update(g[rows], part, p[rows], lr)
                p[rows].copy_(apply_updates(p[rows], upd))
                del upd
                for k in mirrors:
                    old[k][rows].copy_(leaf_new[k])
            rest = {k: v for k, v in leaf_new.items() if k not in mirrors}
            del g
            continue
        upd, leaf_new = opt.update(g, dict(scalars, **old), p, lr, **kw)
        del g
        new = apply_updates(p, upd)
        del upd
        if donate:
            p.copy_(new)
            for k in mirrors:
                tree_map(lambda o, n: o.copy_(n), old[k], leaf_new[k])
        else:
            new_p[path] = new
            for k in mirrors:
                new_s[k][path] = leaf_new[k]
        rest = {k: v for k, v in leaf_new.items() if k not in mirrors}
    if donate:
        for k, v in rest.items():
            opt_state[k].copy_(v)
        return params, opt_state
    new_opt = dict(rest, **{k: tree_map_with_path(lambda p, _: new_s[k][p], params)
                            for k in mirrors})
    return tree_map_with_path(lambda p, _: new_p[p], params), new_opt


# ---------------------------------------------------------------------------
# Adafactor under tensor parallelism
# ---------------------------------------------------------------------------

class _ShardMeans(LeafMeans):
    """`optim.LeafMeans` over a whole leaf of which this rank holds a
    shard: a partial sum on the shard, all-reduced over the groups that
    split the reduced dims, divided by the whole extent. A replicated leaf
    takes the plain means (`of` returns None)."""

    def __init__(self, groups: Dict[int, list], extents: Tuple[int, ...]):
        self.groups, self.extents = groups, extents

    @staticmethod
    def of(p, mesh):
        from torch.distributed.tensor import DTensor, Shard
        if not isinstance(p, DTensor):
            return None
        groups: Dict[int, list] = {}
        for name, pl in zip(p.device_mesh.mesh_dim_names, p.placements):
            if isinstance(pl, Shard):
                groups.setdefault(pl.dim - p.ndim, []).append(mesh.group(name))
        return _ShardMeans(groups, tuple(p.shape)) if groups else None

    def _sum(self, x, dims, keepdim=False):
        from ..dist.tensor_parallel import all_reduce
        s = torch.sum(x, dim=dims, keepdim=keepdim) if dims else torch.sum(x)
        n = 1
        for d in (dims or range(-len(self.extents), 0)):
            for group in self.groups.get(d, ()):
                s = all_reduce(s, group)
            n *= self.extents[d]
        return s / n

    def row(self, g2):
        return self._sum(g2, (-1,))

    def col(self, g2):
        return self._sum(g2, (-2,))

    def row_mean(self, vr):
        # vr's last dim is the leaf's dim -2
        from ..dist.tensor_parallel import all_reduce
        s = torch.sum(vr, dim=-1, keepdim=True)
        for group in self.groups.get(-2, ()):
            s = all_reduce(s, group)
        return s / self.extents[-2]

    def all(self, u2):
        return self._sum(u2, ())


def _reduced_placements(placements, ndim: int, drop: int):
    """A leaf's placements on the tensor left when its dim ``drop``
    (negative) is reduced away: that dim's shards become replicas, later
    dims shift down."""
    from torch.distributed.tensor import Replicate, Shard
    drop %= ndim
    out = []
    for pl in placements:
        if isinstance(pl, Shard):
            out.append(Replicate() if pl.dim == drop else
                       Shard(pl.dim - 1) if pl.dim > drop else pl)
        else:
            out.append(pl)
    return out


def _moment_placements(name: str, p):
    """The placements Adafactor's moment ``name`` takes in the update: its
    parameter's shards on the dims it keeps (``vr`` drops dim -1, ``vc``
    dim -2, ``v`` none)."""
    if name == "v":
        return list(p.placements)
    return _reduced_placements(p.placements, p.ndim, -1 if name == "vr" else -2)


def _adafactor_aligned(opt_state: Dict, params) -> Dict:
    """Adafactor's state with each moment as the local tensor its update
    needs: the stored ZeRO-1 layout gathered whole (exact) and cut as its
    parameter's shard (`_moment_placements`); counters as they are."""
    from torch.distributed.tensor import DTensor
    from ..dist.sharding import _from_full, full_tensor

    def leaf(p, s):
        if not isinstance(p, DTensor):
            return {k: (v.to_local() if isinstance(v, DTensor) else v) for k, v in s.items()}
        return {k: _from_full(full_tensor(v), p.device_mesh,
                              _moment_placements(k, p)).to_local() for k, v in s.items()}
    return dict({k: v for k, v in opt_state.items() if k != "s"},
                s=tree_map(leaf, params, opt_state["s"]))


def _adafactor_stored(new_opt: Dict, opt_state: Dict, params, donate: bool) -> Dict:
    """The updated moments (local, as `_adafactor_aligned` cut them) back in
    their stored ZeRO-1 layout: gathered whole and cut as the stored
    DTensor is; with ``donate`` written into its buffer."""
    from torch.distributed.tensor import DTensor
    from ..dist.sharding import _from_full, full_tensor

    def leaf(p, new, old):
        out = {}
        for k, v in new.items():
            store = old[k]
            if isinstance(p, DTensor):
                whole = full_tensor(DTensor.from_local(
                    v, p.device_mesh, _moment_placements(k, p), run_check=False,
                    shape=store.shape, stride=store.stride()))
                v = _from_full(whole, store.device_mesh, store.placements).to_local()
            if donate:
                (store.to_local() if isinstance(store, DTensor) else store).copy_(v)
                out[k] = store
            else:
                out[k] = _rewrap(v, store)
        return out
    s = tree_map(leaf, params, new_opt["s"], opt_state["s"])
    if donate:
        return opt_state
    return dict({k: v for k, v in new_opt.items() if k != "s"}, s=s)


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
