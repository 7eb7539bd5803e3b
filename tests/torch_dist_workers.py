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


def _layouts(tree):
    """{key: (placements, local shape, global shape)} of a placed tree's
    DTensor leaves."""
    from torch.distributed.tensor import DTensor
    from repro_torch.train.tree import keystr, tree_leaves_with_path
    return {keystr(p): (tuple(str(pl) for pl in x.placements), tuple(x.to_local().shape),
                        tuple(x.shape))
            for p, x in tree_leaves_with_path(tree) if isinstance(x, DTensor)}


def _tp_grads(mesh, placed, batch, cfg):
    """`train_loss` and its gradients on this rank's rows of ``batch``
    under ``mesh``, averaged over the data ranks in rank order as the
    step averages them -> (loss, whole gradients, the gradients' layouts)."""
    from torch.distributed.tensor import Shard
    from repro_torch.dist import sharding as shd
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_step import local_rows, rank_order_mean, value_and_grad
    from repro_torch.train.tree import tree_leaves_with_path, tree_map_with_path
    rows = local_rows(batch, mesh.data_rank, mesh.shape["data"])
    loss, grads = value_and_grad(lambda p, b: tf.train_loss(p, b, cfg))(placed, rows)
    layouts = _layouts(grads)
    full = dict(tree_leaves_with_path(shd.gather(grads)))
    # an FSDP leaf's gradient was averaged over 'data' in its backward
    paths = [p for p, g in tree_leaves_with_path(grads) if not isinstance(g.placements[0], Shard)]
    loss, *means = rank_order_mean([loss] + [full[p] for p in paths], mesh.group("data"))
    full.update(zip(paths, means))
    return float(loss), _numpy(tree_map_with_path(lambda p, _: full[p], grads)), layouts


def case_tp(rank, world, inp, device):
    """Tensor parallelism on a (2, 2) mesh of the 4 ranks, every case of
    ``tests/test_torch_tp.py`` in one group: per ``inp['steps']`` config,
    the placed tree's gradients and one AdamW step (global batch, carried
    weights), layouts, replica agreement, a rerun; per ``inp['losses']``
    config, `train_loss` and its gradients with the whole batch on every
    data rank (each model pair does a (1, 2) mesh's work); the elastic
    checkpoint (written here on (2, 2), restored onto (2, 2), (4, 1) and one
    process) and the reference's (2, 2) checkpoint restored onto (2, 2);
    the rows a `DataPipeline` on the mesh hands this rank."""
    import time
    from repro_torch.configs.base import ArchConfig
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.context import compute_mesh
    from repro_torch.launch.mesh import make_host_mesh, make_process_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optim, schedule
    from repro_torch.train.loop import replicas_agree
    from repro_torch.train.train_step import init_train_state, make_train_step, value_and_grad
    from repro_torch.train.tree import tree_leaves_with_path
    from repro_torch.launch.costing import CostMode, counting
    mesh = make_process_mesh(2, 2, device)
    out = {"coords": (mesh.data_rank, mesh.model_rank), "steps": {}, "losses": {}}
    for name, case in inp["steps"].items():
        cfg = ArchConfig(**case["cfg"])
        opt = optim.make_optimizer(case.get("opt", "adamw"), weight_decay=0.0)
        params = tf.params_from_numpy(case["params"], device)
        batch = _tensors(case["batch"], device)
        placed = shd.place(params, mesh, cfg.fsdp_experts)
        state = init_train_state(placed, opt)
        step = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                               schedule.constant(case["lr"]),
                               grad_shardings=shd.placements(params, mesh, cfg.fsdp_experts))
        with compute_mesh(mesh):
            loss, grads, grad_layouts = _tp_grads(mesh, placed, batch, cfg)
            with counting(CostMode()) as costs:
                new, metrics = step(state, batch)
            again, _ = step(state, batch)
            agree = replicas_agree(new, mesh, exact=True)
            whole = _numpy(shd.gather(new))
        out["steps"][name] = {
            "loss": loss, "grads": grads, "step_loss": float(metrics["loss"]), "state": whole,
            "grad_norm": float(metrics["grad_norm"]),
            "layouts": {"params": _layouts(placed), "grads": grad_layouts,
                        "opt": _layouts(new["opt"]), "new_params": _layouts(new["params"])},
            "local": _numpy(shd.local(new["params"])), "agree": agree,
            "costs": costs.costs(),
            "rerun_equal": all(torch_equal(a, b) for (_, a), (_, b) in zip(
                tree_leaves_with_path(shd.local(new)), tree_leaves_with_path(shd.local(again))))}
        if name == inp["elastic"]:
            root = inp["root"]
            with compute_mesh(mesh):
                ckpt.save(root, 1, new)
            torch_barrier()
            back = ckpt.restore(root, 1, new)           # onto the template's own layout
            template = shd.gather(new)
            host = make_host_mesh(device)
            with compute_mesh(host):
                onto41 = ckpt.restore(root, 1, template)
            out["elastic"] = {
                "onto22_equal": all(torch_equal(a, b) for (_, a), (_, b) in zip(
                    tree_leaves_with_path(shd.local(back)),
                    tree_leaves_with_path(shd.local(new)))),
                "onto22_layouts": _layouts(back), "onto41": _numpy(onto41),
                "one_process": _numpy(ckpt.restore(root, 1, template)) if rank == 0 else None}
    out["donate"] = _donated_steps(mesh, inp["donate"], device)
    for name, case in inp["losses"].items():
        cfg = ArchConfig(**case["cfg"])
        params = tf.params_from_numpy(case["params"], device)
        placed = shd.place(params, mesh)
        with compute_mesh(mesh):
            loss, grads = value_and_grad(lambda p, b: tf.train_loss(p, b, cfg))(
                placed, _tensors(case["batch"], device))
            out["losses"][name] = {"loss": float(loss), "grads": _numpy(shd.gather(grads))}
    # the reference's checkpoint, written on its (2, 2) mesh beside these ranks
    jax_dir, deadline = inp["jax_ckpt"], time.time() + 300
    while not os.path.exists(os.path.join(jax_dir, "step_00000001", "manifest.json")):
        if time.time() > deadline:
            raise TimeoutError(f"no reference checkpoint in {jax_dir}")
        time.sleep(0.2)
    case = inp["steps"][inp["elastic"]]
    cfg = ArchConfig(**case["cfg"])
    template = init_train_state(shd.place(tf.params_from_numpy(case["params"], device), mesh),
                                optim.adamw(weight_decay=0.0))
    with compute_mesh(mesh):
        from_jax = ckpt.restore(jax_dir, 1, template, shardings=shd.placements(template, mesh))
        out["from_jax"] = {"state": _numpy(shd.gather(from_jax)), "layouts": _layouts(from_jax)}
    from repro_torch.dist.sharding import PartitionSpec as P
    pipe = DataPipeline(lambda step: _tensors(inp["pipeline"], device), mesh,
                        P("data", None))
    it = pipe(start_step=0)
    _, placed_batch = next(it)
    it.close()
    out["pipeline"] = {k: (v.to_local().cpu().numpy(), tuple(str(p) for p in v.placements))
                       for k, v in placed_batch.items()}
    return out


def donation_check(step_fn, state, batch, clone):
    """One functional and one donated step of ``step_fn(donate)`` from
    ``state`` -> {the donated state is the input object, every leaf keeps
    its buffer, every leaf's bits equal the functional step's, the loss
    too, the functional step left its input unchanged}. ``clone`` copies a
    state tree."""
    import torch
    from repro_torch.dist.sharding import local
    from repro_torch.train.tree import tree_leaves_with_path
    keep = clone(state)
    functional, m_f = step_fn(False)(state, batch)
    unchanged = all(torch_equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_path(local(state)), tree_leaves_with_path(local(keep))))
    ptrs = [x.data_ptr() for _, x in tree_leaves_with_path(local(state))]
    donated, m_d = step_fn(True)(state, batch)
    return {"same_object": donated is state,
            "same_buffers": ptrs == [x.data_ptr() for _, x in
                                     tree_leaves_with_path(local(donated))],
            "bits": all(torch_equal(a, b) for (_, a), (_, b) in zip(
                tree_leaves_with_path(local(functional)), tree_leaves_with_path(local(donated)))),
            "loss": torch_equal(m_f["loss"], m_d["loss"]), "unchanged": unchanged}


def _donated_steps(mesh, case, device):
    """`donation_check` on the mesh for SGD, AdamW and Adafactor."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.context import compute_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train import optim, schedule
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.train.tree import tree_map
    cfg = ArchConfig(**case["cfg"])
    batch = _tensors(case["batch"], device)
    out = {}
    for name in ("sgd", "adamw", "adafactor"):
        opt = optim.make_optimizer(name)
        placed = shd.place(tf.params_from_numpy(case["params"], device), mesh, cfg.fsdp_experts)
        state = init_train_state(placed, opt)

        def step_fn(donate, opt=opt):
            return make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                                   schedule.constant(case["lr"]), donate=donate)
        with compute_mesh(mesh):
            out[name] = donation_check(step_fn, state, batch, lambda s: tree_map(
                lambda x: shd._from_full(shd.full_tensor(x), x.device_mesh, x.placements)
                if hasattr(x, "device_mesh") else x.clone(), s))
    return out


def case_tp_step(rank, world, inp, device):
    """One AdamW step of ``inp['cfg']`` on a (1, world) mesh (every rank a
    model rank) from the carried weights: the loss, the gradient norm, the
    whole new state and its layouts."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.context import compute_mesh
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train import optim, schedule
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = ArchConfig(**inp["cfg"])
    mesh = make_process_mesh(1, world, device)
    opt = optim.adamw(weight_decay=0.0)
    state = init_train_state(shd.place(tf.params_from_numpy(inp["params"], device), mesh), opt)
    step = make_train_step(lambda p, b: tf.train_loss(p, b, cfg), opt,
                           schedule.constant(inp["lr"]))
    with compute_mesh(mesh):
        new, metrics = step(state, _tensors(inp["batch"], device))
        whole = _numpy(shd.gather(new))
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "state": whole, "layouts": _layouts(new)}


def torch_equal(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def torch_barrier():
    import torch.distributed as dist
    dist.barrier()


CASES = {"psum": case_psum, "train": case_train, "loop": case_loop,
         "spike_stats": case_spike_stats, "tp": case_tp, "tp_step": case_tp_step}


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
