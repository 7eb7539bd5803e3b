"""Meshes for the port: an in-process data mesh and a process-group mesh.

The JAX package has one kind of mesh: a single-controller program spans the
devices of a ``jax.sharding.Mesh``, and ``shard_map`` / GSPMD split work
over its axes. PyTorch splits that in two, and so does the port:

1. **In-process data mesh** (`DataMesh`, `make_data_mesh`; serving). The
   counterpart of ``make_data_mesh(n)`` + ``shard_map``: one process, one
   host thread, ``n`` shards along a ``'data'`` axis, each with its own
   ``torch.device``. A sharded call scatters its rows over the shards and
   gathers the results, as ``torch.nn.DataParallel`` does, with the
   parameters copied once per *distinct* device and cached. Installed with
   ``dist.context.compute_mesh``, it makes `serve.runners.snn.SNNRunner`
   and `models.moe.moe_apply` split their rows; `EngineCore` is unchanged.
   On the CPU its ``n`` shards all live on the host (what JAX's
   ``--xla_force_host_platform_device_count`` gives); on the card it takes
   the first ``n`` cards and raises when fewer are visible. A mesh built
   from an explicit device list may put several shards on one card
   (``DataMesh(["cuda:0", "cuda:0"])``): the numbers are the same, but the
   shards then share the card's time.
2. **Process-group mesh** (`ProcessMesh`; training). One process per
   rank, joined by ``torch.distributed`` (started from ``torchrun``'s
   environment when ``WORLD_SIZE`` is set, world size 1 otherwise), with
   axes ``('data', 'model')``. `make_host_mesh` is the counterpart of the
   reference's ``make_host_mesh()`` (+ ``shard_map_compressed_step``):
   ``(world, 1)``, data-parallel only. `make_process_mesh(data, model)`
   is the counterpart of ``jax.make_mesh((data, model), ('data',
   'model'))``: rank r sits at ``(r // model, r % model)``, as
   ``jax.make_mesh`` orders devices, and the mesh carries a
   ``torch.distributed`` ``DeviceMesh`` with those dim names (DTensor
   layouts: `dist.sharding.place`) and one process group per axis
   (``group('data')``: the ranks of this rank's model index, over which
   gradients are averaged; ``group('model')``: the ranks of its data
   index, over which tensor-parallel activations are reduced). NCCL
   carries CUDA tensors and gloo CPU tensors; NCCL refuses two ranks on
   one card, so ranks that share a card use gloo for their CUDA tensors,
   which stages every reduction through the host.

Both expose ``axis_names`` and a ``shape`` mapping, so the sharding rules
(`dist.sharding`) take either. The reference's ``make_production_mesh``
(16x16 / 2x16x16) belongs to launch/costing, which is not ported yet.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..train.tree import tree_leaves, tree_map


class DataMesh:
    """One process's ``('data',)`` mesh: one `torch.device` per shard."""

    axis_names = ("data",)

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a data mesh needs at least one device")
        devs = [resolve_device(d) for d in devices]
        self.devices = tuple(torch.device("cuda", torch.cuda.current_device())
                             if d.type == "cuda" and d.index is None else d for d in devs)
        self.shape: Dict[str, int] = {"data": len(self.devices)}
        self._copies: Dict[int, tuple] = {}

    def replicate(self, tree, device: torch.device):
        """``tree`` (a tree of tensors) on ``device``: itself where its
        leaves already live there, else a copy made once per tree and
        device and kept."""
        if all(x.device == device for x in tree_leaves(tree)):
            return tree
        held, copies = self._copies.get(id(tree), (None, {}))
        if held is not tree:                         # a new tree (or an id reused)
            copies = {}
            self._copies[id(tree)] = (tree, copies)
        if device not in copies:
            copies[device] = tree_map(lambda x: x.to(device), tree)
        return copies[device]


def make_data_mesh(n: int = 0, device="cuda") -> DataMesh:
    """``('data',)`` mesh of ``n`` shards (0: every card on "cuda", one
    shard on "cpu"). On "cpu" all shards are the host; on "cuda" shard ``d``
    is card ``d``, and asking for more cards than are visible raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return DataMesh(["cpu"] * (n or 1))
    have = torch.cuda.device_count()
    n = n or have
    if n > have:
        raise ValueError(f"a data mesh of {n} shards needs that many devices "
                         f"(have {have} visible CUDA device(s))")
    return DataMesh([f"cuda:{i}" for i in range(n)])


class ProcessMesh:
    """``('data', 'model')`` over a ``torch.distributed`` group.

    ``device`` is this rank's device, ``backend`` the group's, ``rank`` its
    rank in the default group and ``data_rank`` / ``model_rank`` its
    coordinates on the mesh. Built by `make_host_mesh` it is ``(world,
    1)``: the data axis is the default group and nothing crosses the model
    axis. Built by `make_process_mesh` it carries ``device_mesh`` (a
    ``DeviceMesh`` named ``('data', 'model')``) and a process group per
    axis.
    """

    axis_names = ("data", "model")

    def __init__(self, device: torch.device, owns_group: bool = False, model: int = 1):
        world = dist.get_world_size()
        if model < 1 or world % model:
            raise ValueError(f"a model axis of {model} does not divide {world} ranks")
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.data_rank, self.model_rank = divmod(self.rank, model)
        self.shape: Dict[str, int] = {"data": world // model, "model": model}
        self._owns_group = owns_group
        self.device_mesh = None
        self._groups = {"data": dist.group.WORLD}
        if model > 1:
            from torch.distributed.device_mesh import DeviceMesh
            self.device_mesh = DeviceMesh(device.type, torch.arange(world).reshape(
                world // model, model), mesh_dim_names=self.axis_names)
            self._groups = {a: self.device_mesh.get_group(a) for a in self.axis_names}

    def group(self, axis: str = "data"):
        """The process group of this rank's line along ``axis``."""
        if axis not in self._groups:
            raise ValueError(f"this mesh has no process group for the {axis!r} axis "
                             f"(a model axis of 1 has none; see make_process_mesh)")
        return self._groups[axis]

    def close(self) -> None:
        """Destroy the process group if `make_host_mesh` started it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False


def _backend(device: torch.device, local_world: int) -> str:
    """NCCL for CUDA tensors unless ranks must share a card (NCCL refuses
    two ranks on one GPU): then gloo, as for CPU tensors."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_host_mesh(device="cuda") -> ProcessMesh:
    """This process's rank of the data mesh, starting the default process
    group if none is running: from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) when ``WORLD_SIZE``
    is set, else as a group of one. On "cuda" rank r runs on card
    ``LOCAL_RANK % device_count``. The backend is NCCL for CUDA tensors,
    gloo for CPU ones and where ranks share a card."""
    dev = resolve_device(device)
    running = dist.is_initialized()
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if running else 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not running:
        backend = _backend(dev, local_world)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return ProcessMesh(dev, owns_group=not running)


def make_process_mesh(data: int, model: int, device="cuda") -> ProcessMesh:
    """A ``('data', 'model') == (data, model)`` mesh over the default
    process group (started as in `make_host_mesh` when none is running),
    which must have ``data * model`` ranks; rank r at ``(r // model, r %
    model)``. Every rank calls it: building the axes' groups is
    collective."""
    mesh = make_host_mesh(device)
    world = mesh.shape["data"]
    if data * model != world:
        mesh.close()
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks, not {world}")
    if model == 1:
        return mesh
    return ProcessMesh(mesh.device, owns_group=mesh._owns_group, model=model)
