"""Deterministic, prefetching data pipeline: the JAX package's
data/pipeline.py.

Batches are pure functions of (seed, step) (see synthetic.py), generated on
the host. Because generation is stateless, a restart reproduces the exact
data order from the step counter alone: no data-loader checkpointing
needed.

A small background thread prefetches: it makes the next batches (in page-
locked memory when they go to the card) while the device computes, and the
consumer places each one. With ``mesh`` and ``batch_spec`` (the
reference's arguments: a `dist.sharding.PartitionSpec` for every leaf) on
a `launch.mesh.make_process_mesh` mesh, a batch becomes DTensors of that
layout on the mesh: this rank holds the rows its data coordinate gives
(what the reference's ``NamedSharding`` gives the device at that
coordinate), replicated over ``'model'``, on its device; the train step
takes them as this rank's rows. The data-parallel step on a ``(world,
1)`` mesh (`launch.mesh.make_host_mesh`) takes the global batch instead,
from a pipeline with a ``device``. Without a mesh, ``device`` names the
one target, and without either a batch stays where ``make_batch`` put it.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from ..device import resolve_device
from ..train.tree import tree_map


class DataPipeline:
    def __init__(self, make_batch: Callable[[int], Dict], mesh=None, batch_spec=None,
                 prefetch: int = 2, device=None):
        """make_batch: step -> host batch tree (tensors). ``mesh`` /
        ``batch_spec``: where batches go on a process-group mesh (module
        docstring); ``device``: where they go without one (None: left where
        they are made)."""
        if mesh is not None and (device is not None
                                 or getattr(mesh, "device_mesh", None) is None):
            raise ValueError("a mesh places each rank's rows on its own device: give a "
                             "make_process_mesh mesh and no device (a data-parallel step "
                             "takes the global batch: give a device)")
        self.make_batch = make_batch
        self.mesh = mesh
        self.batch_spec = batch_spec
        self.device = mesh.device if mesh is not None else (
            None if device is None else resolve_device(device))
        self.prefetch = prefetch

    def _host(self, step: int) -> Dict:
        batch = self.make_batch(step)
        if self.device is not None and self.device.type == "cuda":
            batch = tree_map(lambda x: x.pin_memory(), batch)
        return batch

    def _place(self, batch: Dict) -> Dict:
        if self.device is None:
            return batch
        batch = tree_map(lambda x: x.to(self.device, non_blocking=True), batch)
        if self.mesh is None:
            return batch
        from ..dist.sharding import PartitionSpec, _from_full, to_placements
        placements = to_placements(self.batch_spec or PartitionSpec(), self.mesh.device_mesh)
        return tree_map(lambda x: _from_full(x, self.mesh.device_mesh, placements), batch)

    def __call__(self, start_step: int = 0) -> Iterator[Tuple[int, Dict]]:
        """(step, batch) from ``start_step`` on, in order, until the
        consumer stops iterating: closing the iterator stops and joins the
        thread. An error in ``make_batch`` is raised to the consumer."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    item = (step, self._host(step))
                except Exception as exc:      # handed to the consumer, raised there
                    item = (step, exc)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if isinstance(item[1], Exception):
                    return
                step += 1

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                step, batch = q.get()
                if isinstance(batch, Exception):
                    raise batch
                yield step, self._place(batch)
        finally:
            stop.set()
            thread.join(timeout=10)
