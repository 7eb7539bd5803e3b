"""Rank programs for the port's distribution tests: one process per rank.

    python tests/torch_dist_workers.py CASE RANK WORLD STORE IN OUT DEVICE

Each rank joins a gloo group through the file store ``STORE``, reads the
case's inputs from the pickle ``IN``, runs ``CASE`` on ``DEVICE`` ("cpu",
or "cuda": CUDA tensors over gloo) and pickles what it computed to ``OUT``.
`run_ranks` starts all ranks of one case and returns their outputs in rank
order. Under ``torchrun`` (``python -m torch.distributed.run ... launch IN
OUT``) the ``launch`` case runs `repro_torch.launch.train.main` on carried
weights and batches instead. Imports torch and the port only.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


def _env():
    """The ranks' environment: the port on the path, one intra-op thread
    each (their models are tiny; more threads would only crowd the other
    tests' workers)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def run_ranks(case: str, world: int, inputs: dict, device: str = "cpu", timeout: int = 120):
    """Run ``case`` on ``world`` gloo ranks -> [each rank's outputs]."""
    with tempfile.TemporaryDirectory(prefix="ranks") as tmp:
        inp = os.path.join(tmp, "in.pkl")
        with open(inp, "wb") as f:
            pickle.dump(inputs, f)
        outs = [os.path.join(tmp, f"out{r}.pkl") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
             os.path.join(tmp, "store"), inp, outs[r], device],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=timeout)
                errs.append((p.returncode, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        bad = [(r, rc, err[-3000:]) for r, (rc, err) in enumerate(errs) if rc != 0]
        assert not bad, bad
        result = []
        for path in outs:
            with open(path, "rb") as f:
                result.append(pickle.load(f))
        return result


def torchrun(args, inputs: dict, nproc: int = 2, timeout: int = 240, check: bool = True):
    """``python -m torch.distributed.run --nproc-per-node nproc`` of this
    file's ``launch`` case -> (rank 0's outputs, completed process); with
    ``check=False`` a failing run returns (None, process)."""
    with tempfile.TemporaryDirectory(prefix="torchrun") as tmp:
        inp, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump(dict(inputs, args=args), f)
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
             "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
             os.path.abspath(__file__), "launch", inp, out],
            env=_env(), capture_output=True, text=True, timeout=timeout)
        if not check and proc.returncode != 0:
            return None, proc
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(out, "rb") as f:
            return pickle.load(f), proc


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# cases: (rank, world, inputs, device) -> outputs
# ---------------------------------------------------------------------------

def _numpy(tree):
    from repro_torch.train.tree import tree_map
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def _tensors(tree, device):
    """numpy -> tensors on ``device``; integer arrays (token ids) as int64."""
    import numpy as np
    import torch
    from repro_torch.train.tree import tree_map
    return tree_map(lambda x: torch.from_numpy(
        np.array(x, dtype=np.int64) if np.asarray(x).dtype.kind in "iu" else np.array(x)
    ).to(device), tree)


def case_psum(rank, world, inp, device):
    """`compressed_psum` of this rank's row of ``grads`` / ``err``."""
    from repro_torch.dist.compression import compressed_psum
    grads = _tensors({k: v[rank] for k, v in inp["grads"].items()}, device)
    err = _tensors({k: v[rank] for k, v in inp["err"].items()}, device)
    mean, new_err = compressed_psum(grads, err, per_channel=inp["per_channel"])
    return {"mean": _numpy(mean), "err": _numpy(new_err)}


def _lm(inp, device):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import transformer as tf
    cfg = ArchConfig(**inp["cfg"])
    return cfg, tf.params_from_numpy(inp["params"], device)


def case_train(rank, world, inp, device):
    """``inp['steps']`` train steps over the process group on the global
    batches: plain data-parallel (`make_train_step` under the ambient
    process-group mesh) or compressed (`shard_map_compressed_step`)."""
    from repro_torch.dist.context import compute_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train import optim, schedule
    from repro_torch.train.train_step import (init_train_state, make_train_step,
                                              shard_map_compressed_step, stack_error_state)
    cfg, params = _lm(inp, device)
    opt = optim.make_optimizer(inp["opt"], **inp.get("opt_kw", {}))
    mesh = make_host_mesh(device)
    compress = inp.get("compress", False)
    step = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                           schedule.constant(inp["lr"]), compress_axis="data" if compress else "",
                           compress_per_channel=inp.get("per_channel", False))
    state = init_train_state(params, opt, compress=compress)
    if compress:
        step = shard_map_compressed_step(step, mesh)
        state = stack_error_state(state, world)
    losses = []
    with compute_mesh(mesh):
        for batch in inp["batches"]:
            state, m = step(state, _tensors(batch, device))
            losses.append(float(m["loss"]))
    return {"losses": losses, "state": _numpy(state)}


def case_loop(rank, world, inp, device):
    """A compressed `TrainLoop` with a checkpoint every 2 steps: a clean
    run, then one that fails at ``inp['fail_at']`` and resumes from its
    latest checkpoint (written by rank 0 into ``inp['root']``)."""
    from repro_torch.dist.context import compute_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train import optim, schedule
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.train_step import (init_train_state, make_train_step,
                                              shard_map_compressed_step, stack_error_state)
    cfg, params = _lm(inp, device)
    opt = optim.make_optimizer(inp["opt"])
    mesh = make_host_mesh(device)
    steps = len(inp["batches"])
    state0 = stack_error_state(init_train_state(params, opt, compress=True), world)

    def loop(name):
        step = shard_map_compressed_step(make_train_step(
            lambda p, b: tf.train_loss(p, b, cfg), opt, schedule.warmup_cosine(
                inp["lr"], 2, steps), compress_axis="data"), mesh)
        return TrainLoop(step, lambda i: _tensors(inp["batches"][i], device),
                         ckpt_dir=os.path.join(inp["root"], name), ckpt_every=2, log_every=1,
                         log_fn=lambda *a: None)

    with compute_mesh(mesh):
        clean = loop("clean")
        final = clean.run(state0, steps)
        crash = loop("crash")
        try:
            crash.run(state0, steps, fail_at_step=inp["fail_at"])
            failed = False
        except RuntimeError:
            failed = True
        restored, start = crash.maybe_restore(state0)
        resumed = crash.run(restored, steps, start_step=start)
    return {"clean": _numpy(final), "resumed": _numpy(resumed), "failed": failed,
            "start": start, "clean_losses": [m["loss"] for _, m in clean.history],
            "resumed_losses": [m["loss"] for _, m in crash.history],
            "checks": clean.replica_checks}


def case_spike_stats(rank, world, inp, device):
    """`SpikeStats.cross_replica_sum` of this rank's row of spikes."""
    from repro_torch.core.sparsity import SpikeStats
    stats = SpikeStats.empty()
    for name, spikes in inp["spikes"].items():
        stats = stats.record(name, _tensors(spikes[rank], device))
    summed = stats.cross_replica_sum()
    return {"counts": _numpy(summed.counts), "sizes": _numpy(summed.sizes),
            "own": _numpy(stats.counts)}


CASES = {"psum": case_psum, "train": case_train, "loop": case_loop,
         "spike_stats": case_spike_stats}


def launch_main(inp_path, out_path):
    """Under torchrun: `launch.train.main(args)` with the init and the
    batches replaced by the carried ones, as the one-process launcher test
    carries them; rank 0 writes every step's loss."""
    import torch
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_step import make_train_step
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    tf.init_params = lambda gen, cfg, device: tf.params_from_numpy(inp["params"], device)
    launch.token_batch = lambda seed, i, b, s, vocab, device: _tensors(inp["batches"][i], device)
    losses = []

    def recording(*a, **kw):
        step = make_train_step(*a, **kw)

        def run(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m
        return run
    launch.make_train_step = recording
    history = launch.main(inp["args"])
    if int(os.environ["RANK"]) == 0:
        with open(out_path, "wb") as f:
            pickle.dump({"losses": losses, "history": history,
                         "torch": torch.__version__}, f)


def main(argv):
    if argv[0] == "launch":
        launch_main(argv[1], argv[2])
        return
    case, rank, world, store, inp_path, out_path, device = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = CASES[case](rank, world, inp, device)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.abspath(SRC))
    main(sys.argv[1:])
