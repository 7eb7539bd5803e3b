"""LM training launcher for the port: the JAX package's launch/train.py.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --steps 50 \\
        --d-model 64 --n-layers 4 --vocab 512 --seq 128 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5
    # an arch at its full config (bf16, remat="full"; the card):
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --full-size

    # data-parallel over 2 ranks, with error-feedback int8 gradient compression:
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --steps 10 --compress-grads

Trains any registered arch on synthetic token streams
(`data.synthetic.token_batch`, with synthesized frontend embeddings where
the arch has a frontend) with the config's optimizer, a warmup-cosine
schedule (10 warmup steps) and `models.transformer.train_loss`, through
`train.loop.TrainLoop` (checkpoints every ``--ckpt-every`` steps into
``--ckpt-dir``, resuming from the newest one there). Without
``--full-size`` the arch is cut by `reduce_cfg` (float32, no remat, the
flags' width, depth and vocab). Runs on the card unless ``--device cpu`` is
given; asking for the card without one raises.

Data parallelism (`launch.mesh.make_host_mesh`): started by ``torchrun``
(``python -m torch.distributed.run``), every rank joins the process group
from its environment; started plainly, the run is a group of one. Every
rank draws the same global batch from (seed, step) and the step keeps its
own rows (``--batch`` must divide by the world size). Without
``--compress-grads`` the step is the plain data-parallel one (gradients and
loss averaged in fp32 over the ranks); with it, the error-feedback int8
reduction (`train_step.shard_map_compressed_step`), whose residuals the
checkpoints hold in the reference's stacked ``[n_data, ...]`` layout. Rank
0 prints and writes the checkpoints. On the card, ranks that share a card
reduce over gloo (NCCL refuses two ranks on one GPU); a run of one rank per
card uses NCCL.
"""
from __future__ import annotations

import argparse
import functools
import sys
from typing import List, Optional

import torch

from ..configs import get_arch
from ..data.synthetic import _generator, token_batch
from ..device import resolve_device
from ..dist.context import compute_mesh
from ..models import transformer as tf
from ..models.frontends import synth_frontend
from ..train.loop import TrainLoop
from ..train.optim import make_optimizer
from ..train.schedule import warmup_cosine
from ..train.train_step import (init_train_state, make_train_step,
                                shard_map_compressed_step, stack_error_state)
from ..train.tree import tree_leaves
from .mesh import make_host_mesh


def reduce_cfg(cfg, args):
    """The JAX package's `launch.train.reduce_cfg`: float32 weights, no
    remat, and width, depth and vocab cut to the flags (0 keeps the
    config's own); more than 8 experts become 8 at top-k <= 2, frontends
    8 tokens of width 16."""
    kw = {"dtype": "float32", "remat": "none"}
    if args.d_model:
        hd = max(args.d_model // cfg.n_heads, 8)
        kw.update(d_model=args.d_model, head_dim=hd,
                  d_ff=0 if cfg.d_ff == 0 else 2 * args.d_model,
                  moe_d_ff=min(cfg.moe_d_ff, args.d_model) if cfg.moe_d_ff else 0,
                  d_rnn=args.d_model if cfg.d_rnn else 0)
    if args.n_layers:
        period = len(cfg.pattern)
        n = max(period, (args.n_layers // period) * period)
        kw.update(n_layers=n + len(cfg.tail))
    if args.vocab:
        kw.update(vocab=args.vocab)
    if cfg.n_frontend_tokens:
        kw.update(n_frontend_tokens=min(cfg.n_frontend_tokens, 8), d_frontend=16)
    if cfg.n_experts > 8:
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), n_experts_padded=0,
                  fsdp_experts=False)
    return cfg.with_(**kw)


def make_batch_fn(cfg, seed: int, batch: int, seq: int, device="cpu"):
    """The reference launcher's ``make_batch``: step -> {tokens, labels} of
    ``seq`` positions in all (frontend tokens included), plus
    ``frontend_embeds`` where the arch has a frontend; drawn on the host
    from (seed, step) and moved to ``device``."""
    s_tok = seq - (cfg.n_frontend_tokens if cfg.frontend else 0)

    def make_batch(i: int):
        b = token_batch(seed, i, batch, s_tok, cfg.vocab, device=device)
        if cfg.frontend:
            b["frontend_embeds"] = synth_frontend(_generator(seed, i), cfg, batch,
                                                  "cpu").to(device)
        return b
    return make_batch


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-size", action="store_true",
                    help="use the arch's full config (bf16, remat; the card)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where training runs (default: the card)")
    ap.add_argument("--compress-grads", action="store_true",
                    help="error-feedback int8 gradient all-reduce over the data "
                         "axis (dist.compression; shard_map_compressed_step)")
    ap.add_argument("--compress-per-channel", action="store_true",
                    help="with --compress-grads: per-channel (last-axis) "
                         "quantization scales instead of one per-tensor scale")
    args = ap.parse_args(argv)
    if args.compress_per_channel and not args.compress_grads:
        ap.error("--compress-per-channel requires --compress-grads")
    return args


def main(argv: Optional[List[str]] = None) -> list:
    """Train; returns the loop's history [(step, metrics)]."""
    args = parse_args(argv)
    resolve_device(args.device)
    mesh = make_host_mesh(args.device)
    try:
        with compute_mesh(mesh):
            return _train(args, mesh)
    finally:
        mesh.close()


def _train(args, mesh) -> list:
    dev, n_data, rank = mesh.device, int(mesh.shape["data"]), mesh.rank
    if args.batch % n_data:
        sys.exit(f"--batch {args.batch} must divide by the world size ({n_data})")
    say = print if rank == 0 else (lambda *a, **k: None)
    if n_data > 1:
        say(f"data-parallel training: {n_data} ranks, {mesh.backend} on {dev.type}"
            + (" (ranks share a card: gloo stages every reduction through the host)"
               if dev.type == "cuda" and mesh.backend == "gloo" else ""))
    cfg = get_arch(args.arch)
    if not args.full_size:
        cfg = reduce_cfg(cfg, args)

    opt = make_optimizer(cfg.optimizer)
    lr_fn = warmup_cosine(args.lr, 10, args.steps)
    loss_fn = functools.partial(tf.train_loss, cfg=cfg)
    if args.compress_grads:
        step = shard_map_compressed_step(
            make_train_step(loss_fn, opt, lr_fn, compress_axis="data",
                            compress_per_channel=args.compress_per_channel), mesh)
    else:
        step = make_train_step(loss_fn, opt, lr_fn)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg, dev)
    state = init_train_state(params, opt, compress=args.compress_grads)
    if args.compress_grads:
        state = stack_error_state(state, n_data)
    loop = TrainLoop(step, make_batch_fn(cfg, args.seed, args.batch, args.seq, dev),
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=5,
                     log_fn=lambda i, m: say(f"step {i}: " + " ".join(
                         f"{k}={v:.4g}" for k, v in m.items())))
    restored, start = loop.maybe_restore(state)
    if restored is not None:
        state = restored
        say(f"resumed from step {start}")
    state = loop.run(state, args.steps, start_step=start)
    if n_data > 1:
        say(f"replicas agree: parameter and optimizer fingerprints equal on all {n_data} "
            f"ranks after each of {loop.replica_checks} steps, every bit after the last")
    if args.compress_grads:
        err = sum(float(e.abs().sum()) for e in tree_leaves(state["grad_err"]))
        # one write of the whole line: every rank prints it to one stream
        sys.stdout.write(f"rank {rank}: residual |grad_err| sum {err:.6g}\n")
        sys.stdout.flush()
    say("final loss:", float(loop.history[-1][1]["loss"]))
    return loop.history


if __name__ == "__main__":
    main()
