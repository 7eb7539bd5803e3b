"""Cost accounting for the dry run: per-chip FLOPs, bytes and wire bytes.

The reference lowers each piece with XLA and reads ``cost_analysis()`` and
the partitioned HLO text. The port runs a step, or a piece of one, on fake
tensors (``torch._subclasses.fake_tensor.FakeTensorMode``: shapes, no
storage) over a fake process group (`launch.mesh.make_production_mesh`),
under one ``TorchDispatchMode``, `CostMode`, that sees every aten op and
every ``c10d`` collective this rank would run:

* ``flops``: ``torch.utils.flop_counter``'s formulas (matmuls, batched
  matmuls, convolutions, attention), on each op's local shapes;
* ``bytes``: for every op that is not a view, the bytes of its tensor
  inputs and outputs (in-place ops count; views, which move nothing, do
  not; nor do 0-d tensors, the step's scalars: the loss, norms, counters
  and schedule values). Every eager op is counted, before any fusion;
* ``coll_bytes``: each collective's wire bytes by `parse_collective_bytes`,
  from its tensor's bytes and its process group's size (0-d collectives,
  the norm's scalars, are not counted);
* with ``track_memory``, the bytes of the storages the run allocates, live
  at once: each output storage counted when it first appears and released
  when it dies (a weakref finalizer), and the peak kept.

Pieces (`train_pieces`, `serve_pieces`, `_slstm_correction`) keep the
reference's names and multipliers,

    total = stem + n_periods * period + sum(tail blocks) + slstm corrections

In eager PyTorch no loop body is hidden, so a whole step traced on fake
tensors counts every op; the pieces are kept because a fake trace of the
sLSTM's Python loop over 32k positions costs minutes where one step costs
milliseconds. They are built from the step itself: the stem is the real
train (prefill, decode) step of the model with no periods and no tail;
a period is one period's blocks, forward and backward (checkpointed as
``cfg.remat`` says) with the step's own gradient handling and update
(`train.train_step`'s ``apply_grads``) on its parameters, its gradients
restacked as the step restacks every period's; under a model axis wider
than 1 a piece runs the tensor-parallel blocks (`transformer._blocks_tp`,
``_embed_tp``, ``_unembed_tp``) on its rank's shards. Where that holds,
the pieces compose to the whole step's counts exactly (FLOPs, bytes and
wire bytes; `tests/test_torch_dryrun.py`). Two places where they do not:

* the sLSTM: a period is measured with the loop cut to its first step
  (`models.xlstm.TRACE_STEPS`) and ``slstm_step`` (one step forward and
  backward, every input differentiated, forward twice under remat) counts
  the other S - 1 per layer. FLOPs and wire bytes compose exactly; bytes
  do not (the cut loop's repeated last output and the gradients summed
  over steps are laid out differently);
* tails under a model axis: the stem gathers the sequence-split stream
  before its norm, where the step's first tail block gathers it instead.

`roofline` turns the totals into times on one H100 (`RooflineTerms`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import ArchConfig, ShapeConfig
from ..dist import sharding as shd
from ..dist.context import compute_mesh
from ..train.tree import tree_leaves_with_path, tree_map
from . import specs

# ---------------------------------------------------------------------------
# Roofline on one H100
# ---------------------------------------------------------------------------

# NVIDIA's H100 SXM data sheet, at its 700 W limit: dense bf16 tensor-core
# FLOP/s, HBM3 bytes/s, NVLink 4 bytes/s each way
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 450e9


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Per-chip step times (s) on an H100: compute, memory, collectives.

    The constants are data-sheet peaks (dense bf16 989 TFLOP/s, HBM
    3.35 TB/s, NVLink 450 GB/s each way), not measurements. ``t_coll``
    takes every collective over NVLink; a 16-wide ``'model'`` axis spans
    more than one 8-card NVLink host, so over the production mesh it is a
    lower bound. No TPU constant is carried over."""

    t_comp: float
    t_mem: float
    t_coll: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem, "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def bound(self) -> float:
        """Roofline step time lower bound (s), assuming perfect overlap."""
        return max(self.t_comp, self.t_mem, self.t_coll)

    def as_dict(self) -> Dict[str, Any]:
        return {"t_comp_s": self.t_comp, "t_mem_s": self.t_mem, "t_coll_s": self.t_coll,
                "dominant": self.dominant, "bound_s": self.bound}


def roofline(flops: float, bytes_hbm: float, coll_bytes: float, chips: int) -> RooflineTerms:
    """Terms in seconds. Pass chips=1 when the inputs are already per-chip
    quantities (the dry run's are: one rank's view)."""
    return RooflineTerms(t_comp=flops / (chips * H100_BF16_FLOPS),
                         t_mem=bytes_hbm / (chips * H100_HBM_BYTES_PER_S),
                         t_coll=coll_bytes / (chips * H100_NVLINK_BYTES_PER_S))


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

def parse_collective_bytes(kind: str, nbytes: float, group_size: int) -> float:
    """Per-chip wire bytes of one collective with the reference's ring
    factors: ``nbytes`` is the reduced buffer (all-reduce), the gathered
    output (all-gather), the scattered output (reduce-scatter) or the
    buffer (all-to-all, collective-permute); ``group_size`` its group's."""
    g = max(int(group_size), 1)
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}")


# c10d / functional-collective op names -> (kind, which operand's bytes)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", "in"), "all_reduce": ("all-reduce", "in"),
    "allgather_": ("all-gather", "out"), "_allgather_base_": ("all-gather", "out"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "reduce_scatter_": ("reduce-scatter", "out"), "_reduce_scatter_base_": ("reduce-scatter", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "alltoall_": ("all-to-all", "in"), "alltoall_base_": ("all-to-all", "in"),
    "all_to_all_single": ("all-to-all", "in"),
    "send": ("collective-permute", "in"), "recv_": ("collective-permute", "in"),
    "broadcast_": ("collective-permute", "in"),
}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return 0 if t.ndim == 0 else t.numel() * t.element_size()


def _group_size(args, kwargs) -> int:
    from torch._C._distributed_c10d import ProcessGroup
    for a in list(args) + list((kwargs or {}).values()):
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue
    for a in args:                      # functional collectives name their group
        if isinstance(a, str):
            from torch.distributed.distributed_c10d import _resolve_process_group
            return _resolve_process_group(a).size()
    raise RuntimeError("a collective without a process group")


def _storage_key(t: torch.Tensor):
    return _local(t).untyped_storage()._cdata


class CostMode(TorchDispatchMode):
    """Counts ``flops``, ``bytes`` and collective wire bytes (module
    docstring) of everything run under it; with ``track_memory`` also the
    peak bytes of storages allocated under it and alive at once
    (``peak_bytes``). ``paused()`` stops counting for a scope."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, float] = {}
        self.track_memory = track_memory
        self.live = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}
        self._paused = 0

    def costs(self) -> Dict[str, Any]:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll_bytes": float(sum(self.coll.values())), "coll_detail": dict(self.coll)}

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def hold(self, tree) -> None:
        """Count ``tree``'s storages as already allocated (the arguments):
        they are never new, and they die with their owner, not here."""
        for _, t in tree_leaves_with_path(tree):
            if isinstance(t, torch.Tensor):
                self._seen.setdefault(_storage_key(t), -1)

    def _free(self, key: int, n: int) -> None:
        if self._seen.pop(key, None) is not None:
            self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = _local(t).untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        if self.track_memory:
            self._track(out)
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional") and name in _COLLECTIVES:
            kind, which = _COLLECTIVES[name]
            # c10d's first operand is the buffer (its outputs, for a gather
            # or a scatter); a functional collective returns its output
            buf = _tensors(args[0]) if ns == "c10d" or which == "in" else _tensors(out)
            nb = sum(_nbytes(t) for t in buf)
            if nb:
                self.coll[kind] = self.coll.get(kind, 0.0) + parse_collective_bytes(
                    kind, nb, _group_size(args, kwargs))
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        if packet in flop_registry:
            loc = lambda x: _local(x) if isinstance(x, torch.Tensor) else x  # noqa: E731
            out_val = type(out)(loc(o) for o in out) if isinstance(out, (tuple, list)) \
                else loc(out)
            self.flops += flop_registry[packet](
                *[loc(a) for a in args], **{k: loc(v) for k, v in kwargs.items()},
                out_val=out_val)
        returns = func._schema.returns
        writes = any(r.alias_info is not None and r.alias_info.is_write for r in returns)
        views = any(r.alias_info is not None and not r.alias_info.is_write for r in returns)
        if views and not writes:
            return
        ins = _tensors(list(args)) + _tensors(list(kwargs.values()))
        outs = _tensors(out)
        if not outs:
            return                              # reads metadata (prim.device, sizes)
        if not writes:
            keys = {_storage_key(t) for t in ins}
            if all(_storage_key(t) in keys for t in outs):
                return                          # returns an input's storage: a view
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


def step_costs(fn: Callable, *args) -> Tuple[Dict[str, Any], Any]:
    """``fn(*args)`` under a `CostMode` -> ({flops, bytes, coll_bytes,
    coll_detail}, its result)."""
    with CostMode() as mode:
        out = fn(*args)
    return mode.costs(), out


# ---------------------------------------------------------------------------
# Cost pieces
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Piece:
    name: str
    fn: Callable
    arg_specs: Tuple
    in_shardings: Tuple
    mult: float


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _tp(mesh):
    from ..dist.tensor_parallel import TPAxis
    return TPAxis(mesh) if getattr(mesh, "device_mesh", None) is not None else None


def _stem_cfg(cfg: ArchConfig) -> ArchConfig:
    """The model with no periods and no tail: the stem's own step."""
    return cfg.with_(n_layers=0, tail=())


def _stem_shapes(cfg: ArchConfig, device):
    params = specs.param_shapes(cfg.with_(n_layers=len(cfg.pattern), tail=()), device)
    return {k: v for k, v in params.items() if k in ("embed", "final_norm", "lm_head")}


def _single_period_shapes(cfg: ArchConfig, device):
    """Per-period (unstacked) block params."""
    from ..models import transformer as tf
    gen = _generator(device)
    return {f"slot{si}": tf.init_block(gen, cfg, kind, device)
            for si, kind in enumerate(cfg.pattern)}


def _period_layout(pp_shapes, cfg: ArchConfig, mesh):
    """Each period leaf's layout in the step: its stacked ``[n_periods,
    ...]`` leaf's `param_spec` less the period dim (a stacked norm gain is
    a matrix to the rules, so it is split where one period's would not
    be). The pieces' ``in_shardings`` keep the reference's per-period
    specs."""
    class _Stacked:
        def __init__(self, shape):
            self.shape = (cfg.n_periods,) + tuple(shape)
    return shd.tree_map_with_path(lambda path, x: shd.P(*shd.param_spec(
        ("periods",) + path, _Stacked(x.shape), mesh, cfg.fsdp_experts)[1:]), pp_shapes)


def _generator(device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(0)


def _dp(mesh) -> int:
    n = 1
    for a in shd.dp_axes(mesh):
        n *= int(mesh.shape[a])
    return n


def _x_part(mesh, batch: int = 0) -> shd.PartitionSpec:
    dp = shd.dp_axes(mesh)
    if batch and batch % _dp(mesh) != 0:
        return shd.P()
    return shd.P(dp, None, None)


def _x_arg(cfg, shape, mesh, decode: bool, device, seq_split: bool):
    """The residual stream entering a period: [B, S, d] whole, laid out
    over the data axes (rows) and, under a model axis where it divides, the
    sequence (`transformer._forward_tp`). Returns (arg, spec)."""
    b = shape.global_batch
    s = 1 if decode else shape.seq_len
    x = torch.zeros((b, s, cfg.d_model), dtype=_dtype(cfg), device=device)
    spec = _x_part(mesh, b)
    tp = _tp(mesh)
    if tp is None:
        return _rows(x, mesh), spec
    entries = list(spec) + [None] * (3 - len(spec))
    if seq_split and s % tp.size == 0:
        entries[1] = "model"
    return specs.placed_by(x, shd.P(*entries), mesh), spec


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a whole tensor on a mesh without a model axis."""
    n = _dp(mesh)
    if n == 1 or x.shape[0] % n:
        return x
    r = getattr(mesh, "dp_rank", 0)
    return x[r * (x.shape[0] // n):(r + 1) * (x.shape[0] // n)]


def _leaf_grads(out, leaves, cotangents):
    """Gradients of ``out`` with respect to ``leaves`` given ``cotangents``
    (made uncounted by the caller)."""
    pairs = [(o, c) for o, c in zip(out, cotangents) if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs], leaves, [c for _, c in pairs],
                                allow_unused=True)
    return [g if g is not None else torch.zeros_like(x) for g, x in zip(grads, leaves)]


def _stack_share(g):
    """A period's share of the step's restacking of its gradients: a stack
    of one, read back as the period's slice."""
    from torch.distributed.tensor import DTensor
    if not isinstance(g, DTensor):
        return torch.stack([g])[0]
    loc = torch.stack([g.to_local()])[0]
    return DTensor.from_local(loc, g.device_mesh, g.placements, run_check=False,
                              shape=g.shape, stride=g.stride())


def _block_grads(run, params, x, mode_ref, stacked: bool):
    """``run(leaves, x_leaf) -> (y, aux)`` differentiated with respect to
    the block parameters and ``x`` -> (grads tree like ``params``, dx)."""
    from ..train.train_step import deterministic
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    xl = x.to_local() if hasattr(x, "to_local") else x
    xl = xl.detach().requires_grad_(True)
    with torch.enable_grad(), deterministic():
        y, aux = run(leaves, xl)
        flat = [p for _, p in tree_leaves_with_path(leaves)]
        with _paused(mode_ref):
            dy = torch.ones_like(y)
            da = torch.ones_like(aux)
        grads = _leaf_grads((y, aux), flat + [xl], (dy, da))
    by_id = {id(p): g for p, g in zip(flat, grads)}
    out = tree_map(lambda p: by_id[id(p)], leaves)
    if stacked:
        out = tree_map(_stack_share, out)
    return out, grads[-1]


@contextlib.contextmanager
def _paused(mode_ref) -> Iterator[None]:
    mode = mode_ref()
    if mode is None:
        yield
        return
    with mode.paused():
        yield


_CURRENT: List[CostMode] = []


def _current_mode() -> Optional[CostMode]:
    return _CURRENT[-1] if _CURRENT else None


def _make_step(cfg: ArchConfig, opt, lr_fn):
    """The dry run's train step (`specs.make_train_objects`'): donated."""
    from ..models import transformer as tf
    from ..train.train_step import make_train_step
    return make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt, lr_fn,
                           grad_dtype=cfg.grad_dtype, donate=True)


def _opt_state(params, opt):
    from ..train.train_step import init_train_state
    return init_train_state(params, opt)["opt"]


def train_pieces(cfg: ArchConfig, shape: ShapeConfig, mesh, device="cuda") -> List[Piece]:
    """The reference's train pieces (module docstring), built on fake
    tensors under a ``FakeTensorMode``; their updates donate as the step
    they stand for does (`specs.make_train_objects`)."""
    from ..models import transformer as tf
    from ..train.optim import make_optimizer
    from ..train.schedule import warmup_cosine
    opt = make_optimizer(cfg.optimizer)
    lr_fn = warmup_cosine(3e-4, 200, 10_000)
    tp = _tp(mesh)
    pieces = []

    # --- stem: the step of the model with no periods and no tail ---
    stem_cfg = _stem_cfg(cfg)
    sp_shapes = _stem_shapes(cfg, device)
    sp_part = shd.param_specs(sp_shapes, mesh)
    b_specs = specs.batch_shapes(cfg, dataclasses.replace(shape, kind="train"), device)
    if "labels" not in b_specs:
        b_specs = dict(b_specs, labels=torch.zeros_like(b_specs["tokens"]))
    b_part = shd.batch_spec(b_specs, mesh)
    stem_step = _make_step(stem_cfg, opt, lr_fn)

    def stem_fn(sp, so, batch):
        state = {"params": dict(sp, periods={}, tail=()), "opt": so,
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        return stem_step(state, batch)

    sp = specs.placed_by(sp_shapes, sp_part, mesh)
    so = _opt_state(dict(sp, periods={}, tail=()), opt)
    so_part = shd.zero1_opt_specs(opt.init(sp_shapes), sp_part, mesh)
    pieces.append(Piece("stem", stem_fn, (sp, so, b_specs), (sp_part, so_part, b_part), 1.0))

    # --- one period: forward + backward (checkpointed under remat) + update ---
    pp_shapes = _single_period_shapes(cfg, device)
    pp_part = shd.param_specs(pp_shapes, mesh, cfg.fsdp_experts)
    po_part = shd.zero1_opt_specs(opt.init(pp_shapes), pp_part, mesh)
    pp_layout = _period_layout(pp_shapes, cfg, mesh)
    period_step = _make_step(cfg, opt, lr_fn)
    remat = cfg.remat == "full"

    def period_apply(pp, x):
        def body(x, aux, slots):
            if tp is not None:
                return tf._blocks_tp(tp, cfg, x, aux, cfg.pattern,
                                     [slots[f"slot{si}"] for si in range(len(cfg.pattern))],
                                     _seq_split(cfg, shape, tp), True)
            for si, kind in enumerate(cfg.pattern):
                x, a = tf._apply_block(kind, slots[f"slot{si}"], x, cfg)
                aux = aux + a
            return x, aux
        aux = torch.zeros((), device=x.device)
        slots = _unwrap(shd.shard_cotangents(pp), tp)
        if remat:
            from torch.utils.checkpoint import checkpoint
            return checkpoint(body, x, aux, slots, use_reentrant=False)
        return body(x, aux, slots)

    def period_fn(pp, po, x):
        grads, dx = _block_grads(period_apply, pp, x, _current_mode, stacked=True)
        state = {"params": pp, "opt": po,
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        new, _ = period_step.apply_grads(state, None, grads)
        return new, dx

    pp = specs.placed_by(pp_shapes, pp_layout, mesh)
    po = _opt_state(pp, opt)
    x_arg, x_spec = _x_arg(cfg, shape, mesh, False, device, seq_split=True)
    pieces.append(Piece("period", period_fn, (pp, po, x_arg), (pp_part, po_part, x_spec),
                        float(cfg.n_periods)))

    # --- tail blocks ---
    for ti, kind in enumerate(cfg.tail):
        t_shapes = tf.init_block(_generator(device), cfg, kind, device)
        t_part = shd.param_specs(t_shapes, mesh)
        to_part = shd.zero1_opt_specs(opt.init(t_shapes), t_part, mesh)

        def tail_apply(tparams, x, kd=kind):
            aux = torch.zeros((), device=x.device)
            if tp is not None:
                return tf._blocks_tp(tp, cfg, x, aux, (kd,),
                                     [_unwrap(shd.shard_cotangents(tparams), tp)], False, False)
            return tf._apply_block(kd, tparams, x, cfg)

        def tail_fn(tparams, to, x, run=tail_apply):
            grads, dx = _block_grads(run, tparams, x, _current_mode, stacked=False)
            state = {"params": tparams, "opt": to,
                     "step": torch.zeros((), dtype=torch.int32, device=device)}
            new, _ = period_step.apply_grads(state, None, grads)
            return new, dx

        tparams = specs.placed_by(t_shapes, t_part, mesh)
        to = _opt_state(tparams, opt)
        tx, t_spec = _x_arg(cfg, shape, mesh, False, device, seq_split=False)
        pieces.append(Piece(f"tail{ti}_{kind}", tail_fn, (tparams, to, tx),
                            (t_part, to_part, t_spec), 1.0))

    pieces.extend(_slstm_correction(cfg, shape, mesh, train=True, device=device))
    return pieces


def _seq_split(cfg: ArchConfig, shape: ShapeConfig, tp) -> bool:
    """Whether the step splits the stream along the sequence (`_forward_tp`:
    the frontend's positions and the tokens', ``seq_len`` in all)."""
    return shape.seq_len % tp.size == 0


def serve_pieces(cfg: ArchConfig, shape: ShapeConfig, mesh, decode: bool,
                 device="cuda") -> List[Piece]:
    """The reference's prefill / decode pieces (module docstring)."""
    from ..models import transformer as tf
    tp = _tp(mesh)
    pieces = []
    b_specs = specs.batch_shapes(cfg, shape, device)
    b_part = shd.batch_spec(b_specs, mesh)
    stem_cfg = _stem_cfg(cfg)
    sp_shapes = _stem_shapes(cfg, device)
    sp_part = shd.param_specs(sp_shapes, mesh)
    pos = shape.seq_len - 1

    if decode:
        def stem_fn(sp, batch):
            with torch.no_grad():
                return tf.decode_step(dict(sp, periods={}, tail=()),
                                      {"periods": {}, "tail": ()}, batch, pos, stem_cfg)[0]
    else:
        def stem_fn(sp, batch):
            with torch.no_grad():
                return tf.prefill_step(dict(sp, periods={}, tail=()), batch, stem_cfg)[0]

    pieces.append(Piece("stem", stem_fn, (specs.placed_by(sp_shapes, sp_part, mesh), b_specs),
                        (sp_part, b_part), 1.0))

    pp_shapes = _single_period_shapes(cfg, device)
    pp_part = shd.param_specs(pp_shapes, mesh, cfg.fsdp_experts)
    pp = specs.placed_by(pp_shapes, _period_layout(pp_shapes, cfg, mesh), mesh)
    x_arg, x_spec = _x_arg(cfg, shape, mesh, decode, device, seq_split=not decode)

    def local_x(x):
        return x.to_local() if hasattr(x, "to_local") else x

    if decode:
        dt = _dtype(cfg)
        cache_one = {f"slot{si}": tf._init_block_cache(kind, cfg, shape.global_batch,
                                                       shape.seq_len, dt, device)
                     for si, kind in enumerate(cfg.pattern)}
        cache_part = shd.cache_specs(cache_one, mesh)

        def period_fn(pp, cache, x):
            with torch.no_grad(), compute_mesh(None):     # as `decode_step`
                x = local_x(x)
                cache = shd.local(cache)
                full = tp.full if tp is not None else (lambda t: t)
                slots = _unwrap(pp, tp)
                for si, kind in enumerate(cfg.pattern):
                    x, cache[f"slot{si}"] = tf._decode_block(
                        kind, full(slots[f"slot{si}"]), x, cache[f"slot{si}"], pos, cfg)
                return x, cache

        pieces.append(Piece("period", period_fn,
                            (pp, specs.placed_by(cache_one, cache_part, mesh), x_arg),
                            (pp_part, cache_part, x_spec), float(cfg.n_periods)))
    else:
        def period_fn(pp, x):
            with torch.no_grad():
                x = local_x(x)
                aux = torch.zeros((), device=x.device)
                if tp is not None:
                    return tf._blocks_tp(tp, cfg, x, aux, cfg.pattern,
                                         [_unwrap(pp, tp)[f"slot{si}"]
                                          for si in range(len(cfg.pattern))],
                                         _seq_split(cfg, shape, tp), True)[0]
                for si, kind in enumerate(cfg.pattern):
                    x, _ = tf._apply_block(kind, pp[f"slot{si}"], x, cfg)
                return x

        pieces.append(Piece("period", period_fn, (pp, x_arg), (pp_part, x_spec),
                            float(cfg.n_periods)))

    for ti, kind in enumerate(cfg.tail):
        t_shapes = tf.init_block(_generator(device), cfg, kind, device)
        t_part = shd.param_specs(t_shapes, mesh)
        tparams = specs.placed_by(t_shapes, t_part, mesh)
        tx, t_spec = _x_arg(cfg, shape, mesh, decode, device, seq_split=False)
        if decode:
            tc = tf._init_block_cache(kind, cfg, shape.global_batch, shape.seq_len,
                                      _dtype(cfg), device)
            tc_part = shd.cache_specs(tc, mesh)

            def tail_fn(tparams, cache, x, kd=kind):
                with torch.no_grad(), compute_mesh(None):
                    full = tp.full if tp is not None else (lambda t: t)
                    return tf._decode_block(kd, full(_unwrap(tparams, tp)), local_x(x),
                                            shd.local(cache), pos, cfg)

            pieces.append(Piece(f"tail{ti}_{kind}", tail_fn,
                                (tparams, specs.placed_by(tc, tc_part, mesh), tx),
                                (t_part, tc_part, t_spec), 1.0))
        else:
            def tail_fn(tparams, x, kd=kind):
                with torch.no_grad():
                    x = local_x(x)
                    if tp is not None:
                        return tf._blocks_tp(tp, cfg, x, torch.zeros((), device=x.device),
                                             (kd,), [_unwrap(tparams, tp)], False, False)[0]
                    return tf._apply_block(kd, tparams, x, cfg)[0]

            pieces.append(Piece(f"tail{ti}_{kind}", tail_fn, (tparams, tx), (t_part, t_spec),
                                1.0))

    if not decode:
        pieces.extend(_slstm_correction(cfg, shape, mesh, train=False, device=device))
    return pieces


def _unwrap(tree, tp):
    if tp is None:
        return tree
    from ..dist.tensor_parallel import unwrap
    return unwrap(tree)


def _slstm_correction(cfg: ArchConfig, shape: ShapeConfig, mesh, train: bool,
                      device="cuda") -> List[Piece]:
    """(S-1) more sLSTM steps per slstm layer: a period is measured with
    the loop cut to one step (`models.xlstm.TRACE_STEPS`)."""
    from ..models import xlstm as xl
    n_slstm = sum(1 for k in cfg.pattern if k == "slstm") * cfg.n_periods \
        + sum(1 for k in cfg.tail if k == "slstm")
    if n_slstm == 0 or shape.kind == "decode":
        return []
    b, d = shape.global_batch, cfg.d_model
    tp = _tp(mesh)
    p_shapes = xl.slstm_init(_generator(device), d, cfg.n_heads, _dtype(cfg), device)
    p_part = shd.param_specs(p_shapes, mesh, cfg.fsdp_experts)
    heads = cfg.n_heads
    if tp is not None:                                  # a rank runs its heads' steps
        lo, hi = tp.span(cfg.n_heads)
        heads = hi - lo
    carry = tuple(torch.zeros((b, d), dtype=torch.float32, device=device) for _ in range(4))
    wx = torch.zeros((b, 4 * d), dtype=torch.float32, device=device)
    remat = train and cfg.remat == "full"

    def mine(p, carry, wx):
        """What one loop step takes on this rank: its heads' recurrent
        weights and bias, its rows of the carry and its heads' columns of
        the input projection (`xlstm.slstm_block_tp`; cut uncounted: the
        period pays for them once)."""
        rows = lambda t: _rows(t, mesh) if tp is None else t[  # noqa: E731
            mesh.dp_rank * (b // _dp(mesh)):(mesh.dp_rank + 1) * (b // _dp(mesh))] \
            if b % _dp(mesh) == 0 else t
        carry, wx = tuple(rows(c) for c in carry), rows(wx)
        if tp is None:
            return p, carry, wx
        own, cols, (c0, c1) = xl.slstm_heads_tp(tp, _unwrap(p, tp), d, cfg.n_heads,
                                                wx.device)
        return own, tuple(c[:, c0:c1] for c in carry), wx[:, cols]

    def step_fn(p, carry, wx):
        with _paused(_current_mode):
            p, carry, wx = mine(p, carry, wx)
        if not train:
            with torch.no_grad():
                return xl._slstm_step(p, heads, carry, wx)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
        ins = [t.detach().requires_grad_(True) for t in carry + (wx,)]
        if remat:                        # the checkpointed forward, then its recompute
            with torch.no_grad():
                xl._slstm_step(leaves, heads, tuple(ins[:4]), ins[4])
        with torch.enable_grad():
            out = xl._slstm_step(leaves, heads, tuple(ins[:4]), ins[4])
            with _paused(_current_mode):
                cot = tuple(torch.ones_like(o) for o in out)
            flat = [t for _, t in tree_leaves_with_path(leaves)]
            return _leaf_grads(out, flat + ins, cot)

    mult = float(n_slstm * (shape.seq_len - 1))
    xp = _x_part(mesh, b)
    dp = xp[0] if len(xp) else None
    return [Piece("slstm_step", step_fn,
                  (specs.placed_by(p_shapes, p_part, mesh), carry, wx),
                  (p_part, tuple(shd.P(dp, None) for _ in range(4)), shd.P(dp, None)), mult)]


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counting(mode: CostMode) -> Iterator[CostMode]:
    """Run under ``mode``, reachable by the pieces (to pause it)."""
    _CURRENT.append(mode)
    try:
        with mode:
            yield mode
    finally:
        _CURRENT.pop()


def measure_pieces(pieces: List[Piece], mesh) -> Dict[str, Any]:
    """Each piece's per-chip costs, and the totals weighted by ``mult``.
    Call under the ``FakeTensorMode`` the pieces were built in; ``mesh``
    is installed as the ambient mesh for the run."""
    from ..models import xlstm as xl
    per_piece = {}
    totals = {"flops": 0.0, "bytes": 0.0, "coll_bytes": 0.0}
    saved = xl.TRACE_STEPS
    xl.TRACE_STEPS = 1
    try:
        with compute_mesh(mesh):
            for pc in pieces:
                with counting(CostMode()) as mode:
                    pc.fn(*pc.arg_specs)
                costs = mode.costs()
                costs["mult"] = pc.mult
                per_piece[pc.name] = costs
                for k in totals:
                    totals[k] += costs[k] * pc.mult
    finally:
        xl.TRACE_STEPS = saved
    return {"pieces": per_piece, "totals": totals}
