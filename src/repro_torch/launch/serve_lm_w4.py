"""Serve an LM with fp32 and with int4-weight numerics, then run the W4A16 kernel.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm_w4 --arch qwen1.5-4b
    PYTHONPATH=src python -m repro_torch.launch.serve_lm_w4 --device cpu --tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve_lm_w4 --full     # qwen's real widths
    PYTHONPATH=src python -m repro_torch.launch.serve_lm_w4 --arch granite-moe-3b-a800m --full

The port of the JAX package's examples/serve_lm_w4.py, for every
registered architecture. The architecture is cut to the example's size (2
periods, d_model 64, head_dim 16, d_ff 128, vocab 257, 8 experts of
moe_d_ff 32 at top-k <= 2, d_rnn 64), or with ``--full`` keeps its own
widths and vocab at the same depth (the 8-expert cut stays). The model is
served through `EngineCore` + `LMRunner` with fp32 weights and with their
int4 fake-quant view (4 slots, max_seq 64, the example's four prompts);
then the int4 matmul (`w4a16_linear`) runs on operands drawn as the
example draws them (numpy ``default_rng(0)`` weights, the first 256 of
``vocab - 1`` columns, and ``default_rng(1)`` activations for 4 rows), so
its output compares with the JAX example's. Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_arch
from ..core.quant import quantize_int4
from ..device import resolve_device
from ..kernels.int4_matmul.ops import w4a16_linear
from ..kernels.int4_matmul.ref import int4_matmul_ref
from ..models import transformer as tf
from ..serve.api import EngineConfig
from ..serve.core import EngineCore
from ..serve.runners.lm import LMRunner

PROMPTS = ([1, 2, 3], [9, 8], [5], [12, 13, 14])


def example_cfg(arch: str, full: bool = False):
    """The example's cut of ``arch``: 2 periods and no tail, fp32, no
    frontend, 8 experts (where the arch has experts), top-k at most 2, no
    expert padding or FSDP; with small widths (d_model 64, head_dim 16,
    d_ff 128, vocab 257, moe_d_ff 32, d_rnn 64) unless ``full``, which keeps
    the arch's widths and vocab but still takes the expert-count cut, as
    the JAX example cuts experts whatever the widths."""
    base = get_arch(arch)
    cfg = base.with_(n_layers=2 * len(base.pattern), tail=(), dtype="float32",
                     remat="none", frontend="", n_experts=8 if base.n_experts else 0,
                     n_experts_padded=0, top_k=min(base.top_k, 2), fsdp_experts=False)
    if full:
        return cfg
    return cfg.with_(d_model=64, head_dim=16, d_ff=128, vocab=257, q_chunk=16, kv_chunk=16,
                     moe_d_ff=32 if base.moe_d_ff else 0, d_rnn=64 if base.d_rnn else 0)


def kernel_operands(d_model: int, vocab: int, device):
    """x [4, d_model] and the int4 weights [d_model, 256] of the example:
    the first 256 columns of a ``default_rng(0)`` normal [d_model, vocab - 1]
    matrix, drawn a block of rows at a time (the same values as one draw)
    so that a large vocab never holds the whole matrix."""
    rng, rows = np.random.default_rng(0), max(1, (1 << 24) // max(vocab - 1, 1))
    w = np.concatenate([rng.normal(size=(min(rows, d_model - r), vocab - 1))[:, :256]
                        for r in range(0, d_model, rows)]).astype("float32")
    qt = quantize_int4(torch.from_numpy(w).to(device))
    x = np.random.default_rng(1).normal(size=(4, d_model)).astype("float32")
    return torch.from_numpy(x).to(device), qt


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--full", action="store_true", help="keep the architecture's widths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model and the kernel run (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = example_cfg(args.arch, args.full)
    params = tf.init_params(torch.Generator(device=device).manual_seed(args.seed), cfg, device)
    print(f"arch={cfg.name} ({'full width' if args.full else 'reduced'}, "
          f"{cfg.n_layers} layers), serving fp32 vs int4-weight numerics on {device}")
    streams = {}
    for bits in (0, 4):
        runner = LMRunner(cfg, params, max_seq=64, quant_bits=bits, device=device)
        core = EngineCore(runner, EngineConfig(slots=4))
        ids = [core.submit(p, max_new_tokens=args.tokens) for p in PROMPTS]
        results = core.run_until_complete()
        streams[bits] = [results[i].outputs[-args.tokens:] for i in ids]
        print(f"  w{bits or 16}: {streams[bits]}")
        del runner, core

    # the production-path kernel: packed int4 weights, unpacked in the kernel
    x, qt = kernel_operands(cfg.d_model, cfg.vocab, device)
    y = w4a16_linear(x, qt)
    err = float((y - int4_matmul_ref(x, qt)).abs().max())
    print(f"int4_matmul kernel: x{tuple(x.shape)} @ packed{tuple(qt.packed.shape)} "
          f"-> {tuple(y.shape)}; max|y - dequantized reference| = {err:.3e}; "
          f"weight bytes = {qt.nbytes_logical} (4x less than bf16)")
    return {"cfg": cfg, "streams": streams, "x": x, "qt": qt, "y": y, "err": err}


if __name__ == "__main__":
    main()
