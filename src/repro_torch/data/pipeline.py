"""Deterministic, prefetching data pipeline: the JAX package's
data/pipeline.py without the mesh.

Batches are pure functions of (seed, step) (see synthetic.py), generated on
the host. Because generation is stateless, a restart reproduces the exact
data order from the step counter alone: no data-loader checkpointing
needed.

A small background thread prefetches: it makes the next batches (in page-
locked memory when they go to the card) while the device computes, and the
consumer copies each onto ``device`` with ``non_blocking=True``. Here
``device`` names the one target, and without one a batch stays where
``make_batch`` put it. Data-parallel training needs no placement: every
rank makes the same global batch and its train step keeps its own rows
(`train.train_step`). The reference's placement onto a mesh (``mesh`` /
``batch_spec``) waits for the tensor-parallel slice (ROADMAP, queue 1).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from ..device import resolve_device
from ..train.tree import tree_map


class DataPipeline:
    def __init__(self, make_batch: Callable[[int], Dict], device=None, prefetch: int = 2):
        """make_batch: step -> host batch tree (tensors). ``device``: where
        batches go (None: left where they are made)."""
        self.make_batch = make_batch
        self.device = None if device is None else resolve_device(device)
        self.prefetch = prefetch

    def _host(self, step: int) -> Dict:
        batch = self.make_batch(step)
        if self.device is not None and self.device.type == "cuda":
            batch = tree_map(lambda x: x.pin_memory(), batch)
        return batch

    def _place(self, batch: Dict) -> Dict:
        if self.device is None:
            return batch
        return tree_map(lambda x: x.to(self.device, non_blocking=True), batch)

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
