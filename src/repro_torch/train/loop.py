"""Fault-tolerant training loop: checkpoint/restart, preemption handling.

The loop is restart-idempotent: state (params/opt/step) round-trips through
checkpoints, and batches are keyed by step, so `run()` after a crash
resumes bit-identically (tested). A preemption signal (SIGTERM) triggers a
final checkpoint before exit.
"""
from __future__ import annotations

import signal
from typing import Any, Callable, Dict, Optional

from . import checkpoint as ckpt


def _host(metrics: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


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
        """Resume from the latest checkpoint if one exists -> (state or None, step)."""
        if not self.ckpt_dir:
            return None, 0
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return None, 0
        return ckpt.restore(self.ckpt_dir, step, state_template), step

    def run(self, state: Any, num_steps: int, start_step: int = 0,
            fail_at_step: Optional[int] = None) -> Any:
        """Run to `num_steps` total steps. `fail_at_step` simulates a node
        failure (raises) for the fault-tolerance tests."""
        self._install_signal_handler()
        metrics_hist = []
        for step in range(start_step, num_steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"simulated node failure at step {step}")
            batch = self.make_batch(step)
            state, metrics = self.train_step(state, batch)
            if step % self.log_every == 0 or step == num_steps - 1:
                metrics = _host(metrics)
                self.log_fn(step, metrics)
                metrics_hist.append((step, metrics))
            if self.ckpt_dir and ((step + 1) % self.ckpt_every == 0 or self._preempted
                                  or step == num_steps - 1):
                ckpt.save(self.ckpt_dir, step + 1, state, keep=self.keep)
                if self._preempted:
                    break
        self.history = metrics_hist
        return state
