"""Serve an LM with fp32 and with int4-weight numerics, then run the W4A16 kernel.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm_w4 --arch qwen1.5-4b
    PYTHONPATH=src python -m repro_torch.launch.serve_lm_w4 --device cpu --tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve_lm_w4 --full     # qwen's real widths

The port of the JAX package's examples/serve_lm_w4.py. The architecture is
cut to the example's size (2 periods, d_model 64, head_dim 16, d_ff 128,
vocab 257), or with ``--full`` keeps its own widths and vocab at the same
depth. The model is served through `EngineCore` + `LMRunner` with fp32
weights and with their int4 fake-quant view (4 slots, max_seq 64, the
example's four prompts); then the int4 matmul (`w4a16_linear`) runs on
operands drawn as the example draws them (numpy ``default_rng(0)`` weights,
the first 256 of ``vocab - 1`` columns, and ``default_rng(1)`` activations
for 4 rows), so its output compares with the JAX example's. Runs on the
card unless ``--device cpu`` is given.
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
    """The example's cut of ``arch``: 2 periods, fp32; small widths unless
    ``full``. (The JAX example also cuts MoE and recurrent widths; those
    block kinds are not ported yet.)"""
    base = get_arch(arch)
    cfg = base.with_(n_layers=2 * len(base.pattern), tail=(), dtype="float32",
                     remat="none", frontend="")
    if full:
        return cfg
    return cfg.with_(d_model=64, head_dim=16, d_ff=128, vocab=257, q_chunk=16, kv_chunk=16)


def kernel_operands(d_model: int, vocab: int, device):
    """x [4, d_model] and the int4 weights [d_model, 256] of the example."""
    w = np.random.default_rng(0).normal(size=(d_model, vocab - 1)).astype("float32")
    qt = quantize_int4(torch.from_numpy(np.ascontiguousarray(w[:, :256])).to(device))
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
    return {"cfg": cfg, "streams": streams, "y": y, "err": err}


if __name__ == "__main__":
    main()
