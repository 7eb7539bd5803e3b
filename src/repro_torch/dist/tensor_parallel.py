"""Tensor parallelism over the ``'model'`` axis: collectives and local leaves.

The reference lays tensors out over ``'model'`` with sharding annotations
and lets GSPMD insert the collectives. The port writes them out in the
Megatron form: each model rank holds a parameter as the shard its DTensor
placement gives (`dist.sharding.place`), the model runs on those local
shards, and the collectives are autograd functions over the model axis's
process group. Convention: a *replicated* activation holds the same value
on every model rank, and so does its gradient (each rank's is complete);
a *sharded* one holds this rank's slice. The primitives and their
backwards:

============  ===========================  ==================================
primitive     forward                      backward
============  ===========================  ==================================
``copy``      identity                     all-reduce (the ranks' partial
                                           gradients of a replicated input
                                           used rank by rank)
``reduce``    all-reduce (partial sums of  identity
              a row-parallel product)
``gather``    all-gather along a dim       this rank's slice; with
              (equal slices, or the        ``partial=True`` the all-reduced
              ranks' `span` s)             slice (a rank-specific use)
``split``     this rank's slice            all-gather
============  ===========================  ==================================

Every collective is one ``all_reduce(SUM)``: an all-gather sums a stack
that holds this rank's slice and zeros elsewhere, which is exact and which
gloo takes for CUDA tensors too (ranks that share one card use gloo).
16-bit tensors travel as float32.

In a forward under a ``(data, model)`` mesh (`launch.mesh.make_process_mesh`)
the model's parameter tree holds `TPLeaf` s: a local shard and the dim it
is sharded along over ``'model'`` (and over ``'data'``, for the experts of
``fsdp_experts``). `TPAxis.param` turns one into the layout a block needs
(its storage layout when that is the one, else gathered and re-split),
`TPAxis.full` into the whole tensor.

Heads and channels split over the model ranks in contiguous ranges,
whether or not the axis divides them, as GSPMD pads them: rank r of m
holds `TPAxis.span` ``[lo, hi)`` of n units, ``ceil(n / m)`` on the
first ``n % m`` ranks and ``floor(n / m)`` on the others (none where n <
m; rank 0 always holds the most). Where m divides n that is the equal
shard. The storage layouts stay `dist.sharding.param_spec` 's; a block
takes its range of a leaf with `TPAxis.part`, which is the local shard
itself where the storage shard is that range, else cut from the whole
leaf (`TPAxis.whole`: gathered with ``partial=True``, or a replicated
leaf through ``copy``, so that the backward sums the ranks' partial
gradients and returns this rank's storage shard). Every rank runs the
same collectives in the same order, a rank with an empty range
included: it computes its zero heads with the same operations, so each
fetched weight reaches its (zero-width) output and autograd runs the
same backward collectives on every rank.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .context import current_mesh


class TPLeaf:
    """A parameter's local shard under tensor parallelism: ``t`` the local
    tensor, ``dim`` the (negative) dim sharded over ``'model'`` or None,
    ``data_dim`` the (negative) dim sharded over ``'data'`` or None.
    Indexing takes one period of a stacked leaf."""

    __slots__ = ("t", "dim", "data_dim")

    def __init__(self, t: torch.Tensor, dim: Optional[int] = None,
                 data_dim: Optional[int] = None):
        self.t, self.dim, self.data_dim = t, dim, data_dim

    def __getitem__(self, i: int) -> "TPLeaf":
        return TPLeaf(self.t[i], self.dim, self.data_dim)


def _transport(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy to reduce: 16-bit floats as float32."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.to(torch.float32)
    return x.contiguous().clone()


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """SUM over ``group``, out of place."""
    y = _transport(x)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, dim: int, group,
               sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (exact).
    ``sizes``: each rank's extent along ``dim`` where they differ (each
    ``x`` travels padded to the largest)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    shape = list(x.shape)
    if sizes is not None:
        shape[dim] = max(sizes)
    rows = torch.zeros([n] + shape, dtype=_transport(x[:0]).dtype, device=x.device)
    rows[r].narrow(dim, 0, x.shape[dim]).copy_(x)
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    parts = rows.to(x.dtype).unbind(0)
    if sizes is not None:
        parts = [t.narrow(dim, 0, k) for t, k in zip(parts, sizes)]
    return torch.cat(parts, dim=dim)


def chunk(x: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    """Slice ``r`` of ``n`` equal slices of ``x`` along ``dim``."""
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, partial, sizes):
        ctx.dim, ctx.group, ctx.partial, ctx.sizes = dim, group, partial, sizes
        return all_gather(x, dim, group, sizes)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = all_reduce(g, ctx.group)
        r = dist.get_rank(ctx.group)
        g = g.narrow(ctx.dim, sum(ctx.sizes[:r]), ctx.sizes[r])
        return g.contiguous(), None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return chunk(x, dim, n, r).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.group), None, None


class _GatherMean(torch.autograd.Function):
    """All-gather over the data axis (an FSDP parameter); backward: the
    ranks' gradients averaged, then this rank's slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        mean = all_reduce(g, ctx.group) / n
        return chunk(mean, ctx.dim, n, r).contiguous(), None, None


class TPAxis:
    """The model axis of the ambient process-group mesh: its group, size
    and this rank's index, and the primitives of the module docstring."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.group("model")
        self.size = int(mesh.shape["model"])
        self.rank = int(mesh.model_rank)

    def divides(self, *dims: int) -> bool:
        return all(d % self.size == 0 for d in dims)

    def extent(self, leaf: TPLeaf, dim: int) -> int:
        """The whole extent of ``leaf``'s (negative) dim ``dim``."""
        return leaf.t.shape[dim] * (self.size if leaf.dim == dim else 1)

    def span(self, n: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """``rank`` 's (default: this rank's) contiguous range ``[lo, hi)``
        of ``n`` heads or channels (module docstring)."""
        r = self.rank if rank is None else rank
        q, extra = divmod(n, self.size)
        lo = r * q + min(r, extra)
        return lo, lo + q + (r < extra)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int, partial: bool = False,
               n: Optional[int] = None) -> torch.Tensor:
        """All-gather along ``dim`` of each rank's `span` of ``n``, the
        whole extent (default: equal slices)."""
        n = x.shape[dim] * self.size if n is None else n
        sizes = [b - a for a, b in (self.span(n, r) for r in range(self.size))]
        return _Gather.apply(x, dim, self.group, partial, sizes)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Split.apply(x, dim, self.group)

    def _data_full(self, leaf: TPLeaf) -> TPLeaf:
        if leaf.data_dim is None:
            return leaf
        return TPLeaf(_GatherMean.apply(leaf.t, leaf.data_dim, self.mesh.group("data")),
                      leaf.dim)

    def param(self, leaf, want: Optional[int]) -> torch.Tensor:
        """``leaf`` (a `TPLeaf`, or a plain tensor: replicated) sharded
        along ``want`` over ``'model'`` (None: whole). The backward returns
        the gradient in the storage layout; a whole tensor's users must be
        the same computation on every rank (else wrap it in `copy`)."""
        if not isinstance(leaf, TPLeaf):
            leaf = TPLeaf(leaf)
        leaf = self._data_full(leaf)
        t, have = leaf.t, leaf.dim
        if have is not None and want is not None and have % t.ndim == want % t.ndim:
            return t
        if have is not None:
            t = self.gather(t, have)
        return t if want is None else self.split(t, want)

    def whole(self, leaf) -> torch.Tensor:
        """``leaf`` whole for a use that differs by rank: gathered with
        ``partial=True`` (sharded) or through `copy` (replicated), so that
        the backward sums the ranks' partial gradients and returns this
        rank's storage shard."""
        leaf = self._data_full(leaf if isinstance(leaf, TPLeaf) else TPLeaf(leaf))
        if leaf.dim is None:
            return self.copy(leaf.t)
        return self.gather(leaf.t, leaf.dim, partial=True)

    def part(self, leaf, dim: int, lo: int, hi: int) -> torch.Tensor:
        """Indices ``[lo, hi)`` of ``leaf`` 's (negative) dim ``dim`` for
        this rank's own use: the local shard where the storage shard is
        that range (its gradient this rank's alone), else cut from
        `whole`."""
        leaf = self._data_full(leaf if isinstance(leaf, TPLeaf) else TPLeaf(leaf))
        own = leaf.t.shape[dim]
        if leaf.dim == dim and lo == self.rank * own and hi - lo == own:
            return leaf.t
        return self.whole(leaf).narrow(dim, lo, hi - lo)

    def full(self, tree: Any) -> Any:
        """Every `TPLeaf` of ``tree`` (a leaf or a dict / tuple of them) whole."""
        if isinstance(tree, TPLeaf):
            return self.param(tree, None)
        if isinstance(tree, dict):
            return {k: self.full(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.full(v) for v in tree)
        return tree


def tp_axis() -> Optional[TPAxis]:
    """The ambient mesh's model axis when it has more than one rank (a
    `launch.mesh.make_process_mesh` mesh under ``compute_mesh``), else None."""
    mesh = current_mesh()
    if mesh is None or getattr(mesh, "device_mesh", None) is None \
            or int(mesh.shape.get("model", 1)) <= 1:
        return None
    return TPAxis(mesh)


def unwrap(tree: Any) -> Any:
    """A placed tree (DTensor leaves, `dist.sharding.place`) as `TPLeaf` s:
    each leaf's local shard (``to_local``, through which gradients flow back
    as DTensors of the same placements) and its sharded dims. Plain tensors
    become replicated leaves."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(tree, dict):
        return {k: unwrap(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(unwrap(v) for v in tree)
    if isinstance(tree, TPLeaf):
        return tree
    if not isinstance(tree, DTensor):
        return TPLeaf(tree)
    dims = {}
    for name, pl in zip(tree.device_mesh.mesh_dim_names, tree.placements):
        if isinstance(pl, Shard):
            dims[name] = pl.dim - tree.ndim
    return TPLeaf(tree.to_local(), dims.get("model"), dims.get("data"))
