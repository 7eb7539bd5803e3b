"""Fault-tolerant training loop: checkpoint/restart, preemption handling.

The loop is restart-idempotent: state (params/opt/step) round-trips through
checkpoints, and batches are keyed by step, so `run()` after a crash
resumes bit-identically (tested). A preemption signal (SIGTERM) triggers a
final checkpoint before exit.

Under an ambient process-group mesh (`launch.mesh.ProcessMesh`, installed
with ``dist.context.compute_mesh``) every rank runs the loop: rank 0 alone
writes each checkpoint, behind a barrier, with the error-feedback residuals
(``grad_err``) gathered into the reference's stacked ``[n_data, ...]``
layout; a resume reads it on every rank and hands each rank its row. With
more than one rank the loop also checks that all ranks hold the same
parameters and optimizer state (`replicas_agree`: a fingerprint after
every step, every bit after the last), and raises if they do not. On a
tensor-parallel mesh (`launch.mesh.make_process_mesh`) the state is
placed (DTensor leaves): every rank joins the gather of each checkpoint,
and the check compares the data replicas of each shard (ranks of one
model index); shards of different model ranks differ by design.
"""
from __future__ import annotations

import signal
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..dist.context import current_mesh
from ..launch.mesh import ProcessMesh
from . import checkpoint as ckpt
from .train_step import data_mesh, gather_error_state, gather_rows
from .tree import tree_leaves, tree_map

_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _host(metrics: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def _process_mesh() -> Optional[ProcessMesh]:
    mesh = current_mesh()
    return mesh if isinstance(mesh, ProcessMesh) else None


def replicas_agree(state: Dict, mesh: ProcessMesh, exact: bool = False) -> bool:
    """Whether every rank of ``mesh``'s data group holds the same params,
    optimizer state and step (residuals, ``grad_err``, are rank-local and
    not compared; of a placed state, each rank's shards); the same answer
    on every rank. A fingerprint by default: per leaf, the int64 sum
    of its bit patterns (a float leaf viewed as the integer of its width),
    gathered in rank order and compared with rank 0's. ``exact``: every
    bit, as the elementwise ``MAX`` and ``MIN`` of the bit patterns over
    the ranks being equal (two all-reduces per leaf, so no more than one
    leaf's copies are in flight)."""
    from torch.distributed.tensor import DTensor, Shard
    leaves = [x.to_local() if isinstance(x, DTensor) else x
              for x in tree_leaves({k: v for k, v in state.items() if k != "grad_err"})
              # an FSDP leaf is split over 'data': it has no replicas there
              if not (isinstance(x, DTensor) and isinstance(x.placements[0], Shard))]
    bits = [x.contiguous().view(_BITS[x.element_size()]).reshape(-1) for x in leaves]
    if not exact:
        rows = gather_rows(torch.stack([b.to(torch.int64).sum() for b in bits]), mesh.group())
        return bool((rows == rows[0]).all())
    agree = True
    for b in bits:
        hi = b.to(torch.int64 if b.element_size() == 8 else torch.int32).clone()
        lo = hi.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group())
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group())
        agree &= torch.equal(hi, lo)
    return agree


class TrainLoop:
    def __init__(
        self,
        train_step: Callable,
        make_batch: Callable[[int], Dict],
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        keep: int = 3,
        log_every: int = 10,
        log_fn: Callable[[int, Dict], None] = None,
    ):
        self.train_step = train_step
        self.make_batch = make_batch
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.log_every = log_every
        self.log_fn = log_fn or (lambda step, m: print(
            f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in m.items())))
        self._preempted = False

    def _install_signal_handler(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def maybe_restore(self, state_template: Any):
        """Resume from the latest checkpoint if one exists -> (state or None, step).

        Under a process-group mesh the template's ``grad_err`` is in the
        stacked ``[n_data, ...]`` layout (``stack_error_state``) and each
        rank gets back its own ``[1, ...]`` row."""
        if not self.ckpt_dir:
            return None, 0
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return None, 0
        state = ckpt.restore(self.ckpt_dir, step, state_template)
        mesh = _process_mesh()
        if mesh is not None and "grad_err" in state:
            state["grad_err"] = tree_map(lambda e: e[mesh.rank:mesh.rank + 1].clone(),
                                         state["grad_err"])
        return state, step

    def _save(self, step: int, state: Any) -> None:
        mesh = _process_mesh()
        if mesh is None:
            ckpt.save(self.ckpt_dir, step, state, keep=self.keep)
            return
        tree = gather_error_state(state, mesh)
        if mesh.rank == 0 or ckpt._has_dtensor(tree):      # a placed tree: every rank gathers
            ckpt.save(self.ckpt_dir, step, tree, keep=self.keep)
        dist.barrier()

    def run(self, state: Any, num_steps: int, start_step: int = 0,
            fail_at_step: Optional[int] = None) -> Any:
        """Run to `num_steps` total steps. `fail_at_step` simulates a node
        failure (raises) for the fault-tolerance tests."""
        self._install_signal_handler()
        metrics_hist = []
        self.replica_checks = 0
        for step in range(start_step, num_steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"simulated node failure at step {step}")
            batch = self.make_batch(step)
            state, metrics = self.train_step(state, batch)
            mesh = data_mesh()
            if mesh is not None:
                if not replicas_agree(state, mesh):
                    raise RuntimeError(f"step {step}: the ranks' parameters or optimizer "
                                       "state differ")
                self.replica_checks += 1
            if step % self.log_every == 0 or step == num_steps - 1:
                metrics = _host(metrics)
                self.log_fn(step, metrics)
                metrics_hist.append((step, metrics))
            if self.ckpt_dir and ((step + 1) % self.ckpt_every == 0 or self._preempted
                                  or step == num_steps - 1):
                self._save(step + 1, state)
                if self._preempted:
                    break
        mesh = data_mesh()
        if mesh is not None and not replicas_agree(state, mesh, exact=True):
            raise RuntimeError("the ranks' parameters or optimizer state differ")
        self.history = metrics_hist
        return state
