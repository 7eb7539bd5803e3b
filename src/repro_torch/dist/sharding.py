"""Sharding rules: parameter partitioning, ZeRO-1, batch/cache specs.

The JAX package's dist/sharding.py as pure functions over shapes. Rules
*propose* axes and ``_repair`` keeps only the feasible ones (an axis the
mesh lacks, of size 1, or whose size does not divide the dimension is
dropped), so every helper degrades to replicated when mesh axes are absent
or dims don't divide. A mesh is anything with ``axis_names`` and a
``shape`` mapping: either kind of `launch.mesh`, or a stand-in.

Parameter rules (``param_spec``), Megatron-style:

* 1-D tensors (norm gains, biases) and conv kernels replicate — the SNN's
  conv weights are served data-parallel (the batch shards, the weights
  ride along on every device).
* matmul weights are the *last two* dims; any leading dims (the period
  stack, the expert stack) replicate. Default is column-parallel: the
  output dim shards over ``'model'``. Embeddings propose the vocab dim
  first; row-parallel names (``wo``, ``w_out``, ``w_down``, ``w2``)
  propose the input dim.
* divisibility repair: a proposed axis that doesn't divide is dropped, then
  the rule falls back to sharding the right-most divisible matrix dim over
  ``'model'`` (an odd vocab moves the embedding shard to d_model).
* FSDP-experts mode additionally shards the expert-stack axis over
  ``'data'``.

ZeRO-1 (``zero1_opt_specs``): optimizer-state leaves inherit their
parameter's spec and additionally shard the first unsharded divisible axis
over ``'data'``.

Specs are the port's `PartitionSpec`: a tuple with one entry per dim
(``None`` unsharded, an axis name, or a tuple of names), ``PartitionSpec()``
for replicated; a one-name tuple entry reads as the bare name, as JAX
normalizes it, so ``tuple(spec)`` equals ``tuple`` of the JAX package's
spec for the same rule. `to_placements` maps one onto a
``torch.distributed`` ``DeviceMesh`` as DTensor placements.

Applying them (a `launch.mesh.make_process_mesh` mesh): `place` turns a
parameter tree, or a state tree that mirrors it, into DTensors on the
mesh's ``DeviceMesh``, each leaf this rank's shard of its `param_spec`;
`placements` gives the same layout as a tree of placements (what
``make_train_step(grad_shardings=)`` and ``checkpoint.restore(shardings=)``
take); `full_tensor` and `gather` undo it (a collective on every rank);
`shard_cotangents` holds each gradient to its parameter's layout. The
model computes on the local shards (`dist.tensor_parallel`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..train.tree import keystr, tree_leaves_with_path, tree_map, tree_map_with_path
from .context import current_mesh

# last-two-dims matrices whose *input* dim shards over 'model' (row-parallel:
# their producer is already model-sharded, so the matmul contracts locally)
_ROW_PARALLEL = ("wo", "w_out", "w_down", "w2")
# embedding tables: propose the vocab dim first
_EMBED = ("w_tok",)


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, an axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel mesh axes, outermost first."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh, name: str) -> int:
    return int(mesh.shape[name]) if name in mesh.axis_names else 0


def _repair(axes: Sequence, shape: Tuple[int, ...], mesh) -> Tuple:
    """Drop sharding axes that the mesh lacks or that don't divide the dim."""
    out = []
    for ax, dim in zip(axes, shape):
        if ax is None or ax not in mesh.axis_names or mesh.shape[ax] <= 1 or dim % mesh.shape[ax]:
            out.append(None)
        else:
            out.append(ax)
    out.extend([None] * (len(shape) - len(out)))
    return tuple(out[: len(shape)])


def _path_key(path) -> str:
    """'embed/w_tok'-style key from a tree path of dict keys and indices."""
    return "/".join(str(k) for k in path)


def param_spec(path, leaf, mesh, fsdp_experts: bool = False) -> PartitionSpec:
    """PartitionSpec for one parameter leaf (see the module docstring).

    Args:
        path: tree path (tuple of dict keys / indices) of the leaf.
        leaf: anything with ``.shape``.
        mesh: the target mesh; ``None`` replicates.
        fsdp_experts: shard the expert-stack axis of ``experts/*`` leaves
            over the data axis.
    """
    shape = tuple(leaf.shape)
    if len(shape) <= 1 or mesh is None:
        return P()                       # norms/biases/scalars: replicated
    key = _path_key(path)
    name = key.rsplit("/", 1)[-1]

    if len(shape) == 4 and name == "w":
        return P()                       # conv kernels (SNN): replicated

    n_stack = len(shape) - 2             # scanned periods / expert stacks
    lead: list = [None] * n_stack
    if fsdp_experts and "experts" in key and n_stack >= 1:
        lead[-1] = "data"                # expert axis: FSDP over DP replicas

    mat = shape[-2:]
    if name in _EMBED or name in _ROW_PARALLEL:
        prop = ("model", None)           # vocab-sharded / row-parallel
    else:
        prop = (None, "model")           # column-parallel default

    spec = list(_repair(tuple(lead) + prop, shape, mesh))
    if "model" not in spec:
        # fallback: right-most divisible matrix dim takes the model axis
        tp = _axis_size(mesh, "model")
        for i in (len(shape) - 1, len(shape) - 2):
            if tp > 1 and spec[i] is None and mat[i - n_stack] % tp == 0:
                spec[i] = "model"
                break
    return P(*spec)


def param_specs(shapes, mesh, fsdp_experts: bool = False):
    """PartitionSpecs for a whole parameter tree (`param_spec` per leaf)."""
    return tree_map_with_path(lambda path, leaf: param_spec(path, leaf, mesh, fsdp_experts),
                              shapes)


def shard_cotangents(tree):
    """Identity on the values; the gradient of each leaf is held to its
    parameter's layout.

    Under a mesh whose ``'model'`` axis is larger than 1, each DTensor leaf
    passes through an identity whose backward redistributes the arriving
    cotangent to the leaf's placements (gradients that come back through
    ``to_local`` already have them, so this is then a check that costs
    nothing). Plain tensors, and any tree without such a mesh, pass as they
    are: the reference's constraint is a GSPMD layout hint."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh()
    if mesh is None or _axis_size(mesh, "model") <= 1:
        return tree
    return tree_map(lambda x: _HoldLayout.apply(x) if isinstance(x, DTensor) else x, tree)


class _HoldLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return _from_full(full_tensor(g), g.device_mesh, ctx.placements)


def zero1_opt_specs(opt_shapes, param_part, mesh):
    """ZeRO-1 optimizer-state specs: parameter layout + data-axis partition.

    Each optimizer leaf inherits the spec of the parameter it mirrors
    (matched by key-path suffix: ``opt['m'][...path] <- params[...path]``),
    then the first axis that is still unsharded and divisible by the
    data-axis size additionally shards over ``'data'``. Leaves with no
    matching parameter (step counters, Adafactor's factored rows)
    partition on their own shape.
    """
    data = _axis_size(mesh, "data")
    flat_param = [(keystr(path), spec)
                  for path, spec in tree_leaves_with_path(param_part, is_leaf=_is_spec)]

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        key = keystr(path)
        base: Sequence = ()
        for pkey, pspec in flat_param:
            if pkey and key.endswith(pkey):
                base = tuple(pspec)
                break
        entries = list(base) + [None] * (len(shape) - len(base))
        if data > 1:
            for i, (e, dim) in enumerate(zip(entries, shape)):
                if e is None and dim % data == 0 and dim >= data:
                    entries[i] = "data"
                    break
        return P(*entries)

    return tree_map_with_path(one, opt_shapes)


def batch_spec(b_specs, mesh):
    """Shard the leading (batch) dim over the data axes when they divide it."""
    dp = dp_axes(mesh)
    ndp = 1
    for a in dp:
        ndp *= mesh.shape[a]

    def spec(leaf):
        if dp and leaf.shape and leaf.shape[0] % ndp == 0:
            return P(dp, *([None] * (len(leaf.shape) - 1)))
        return P()

    return tree_map(spec, b_specs)


def cache_spec(path, leaf, mesh):
    """Spec for one decode-cache leaf: batch-sharded over the data axes.

    Stacked period caches are [n_periods, B, ...] (their tree path goes
    through 'periods'); unstacked tail caches are [B, ...] — the path, not
    the shape, decides which axis is the batch.
    """
    dp = dp_axes(mesh)
    ndp = 1
    for a in dp:
        ndp *= mesh.shape[a]
    key = keystr(path) if path else ""
    axis = 1 if "periods" in key else 0
    if (dp and len(leaf.shape) > axis
            and leaf.shape[axis] % ndp == 0 and leaf.shape[axis] >= ndp):
        axes = [None] * len(leaf.shape)
        axes[axis] = dp
        return P(*axes)
    return P()


def cache_specs(cache_shapes, mesh):
    """Specs for a whole decode-cache tree."""
    return tree_map_with_path(lambda path, leaf: cache_spec(path, leaf, mesh), cache_shapes)


def to_placements(spec: PartitionSpec, device_mesh) -> list:
    """DTensor placements of ``spec`` on a ``torch.distributed``
    ``DeviceMesh`` with named dims: per mesh dim, ``Shard(d)`` for the
    tensor dim ``d`` whose entry names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in device_mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


# ---------------------------------------------------------------------------
# Applying the rules: DTensor leaves on a process-group mesh
# ---------------------------------------------------------------------------

def _from_full(full, device_mesh, placements):
    """``full`` (the same on every rank) as a DTensor: this rank's slice of
    each sharded dim, a copy of its own."""
    from torch.distributed.tensor import DTensor, Shard
    local = full
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = device_mesh.size(i)
            r = device_mesh.get_local_rank(i)
            size = local.shape[pl.dim] // n
            local = local.narrow(pl.dim, r * size, size)
    return DTensor.from_local(local.contiguous().clone(), device_mesh, list(placements),
                              run_check=False, shape=full.shape, stride=full.stride())


def _leaf_placements(path, leaf, mesh, fsdp_experts):
    if not leaf.shape:
        return None                      # 0-d counters stay plain tensors
    return tuple(to_placements(param_spec(path, leaf, mesh, fsdp_experts), mesh.device_mesh))


def placements(tree, mesh, fsdp_experts: bool = False):
    """Per leaf, the DTensor placements of its `param_spec` on ``mesh``'s
    ``DeviceMesh`` (one per mesh dim, ``('data', 'model')``); None for 0-d
    leaves. ``tree`` may be a parameter tree or one that mirrors it (an
    optimizer state: ``['opt']['m'][...]`` takes the parameter's rule)."""
    return tree_map_with_path(lambda path, leaf: _leaf_placements(path, leaf, mesh,
                                                                  fsdp_experts), tree)


def place(tree, mesh, fsdp_experts: bool = False):
    """``tree`` (whole tensors, the same on every rank) as DTensors laid out
    by `placements`; 0-d leaves stay plain tensors."""
    return tree_map(lambda leaf, pl: leaf if pl is None
                    else _from_full(leaf, mesh.device_mesh, pl),
                    tree, placements(tree, mesh, fsdp_experts))


def full_tensor(x):
    """The whole tensor of a DTensor leaf, gathered in mesh order over each
    mesh dim it is sharded on (one all-reduce per dim, exact; a collective
    on every rank of those groups); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Shard
    from .tensor_parallel import all_gather
    if not isinstance(x, DTensor):
        return x
    t = x.to_local()
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            t = all_gather(t, pl.dim, x.device_mesh.get_group(name))
    return t


def gather(tree):
    """`full_tensor` of every leaf."""
    return tree_map(full_tensor, tree)


def local(tree):
    """Each DTensor leaf's local shard (``to_local``); plain tensors pass."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x, tree)
