#!/usr/bin/env python3
"""Time hand kernels of several checkouts in turns.

    python3 tools/compare_kernels.py [--kernels NAME[,NAME...]] ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (for a comparison,
list them as parent, change, change, parent). For each one in turn, in a
process of its own so that each imports its own `repro_torch`, it builds
that checkout's kernels and times them with this checkout's
`chip_smoke.py` helpers (shapes, seeded operands, CUDA-event timing), on
the same operands for every root:

- ``spike_matmul`` (the default): the unfused pipeline's six per-timestep
  shapes at `chip_smoke.DENSITIES`, CUDA-event ms per call;
- ``lif_epilogue_scan``: the eight epilogues of a CIFAR10 serving step (8
  slots, T = 2), CUDA-event ms per call (eager, the host path included),
  device ms per call from CUDA-graph replays on the same operands
  (`graph_ms`, which stay in the L2 cache where they fit), and device ms
  per call from graph replays that rotate over copies of the operands
  (`cold_graph_ms`, see `cold_graph_ms`);
- ``dense_conv_lif``: the input layer of that step, the same three times.

It prints one JSON line per root with the per-shape and summed times and a
digest of each kernel's outputs, and exits non-zero if the digests differ
between roots (each kernel's sum order is fixed, so every version must give
the same bits) or if there is no CUDA device. Needs one NVIDIA GPU.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("spike_matmul", "lif_epilogue_scan", "dense_conv_lif")
# bytes the cold timing rotates through: three times the H100's 50 MB L2
COLD_BYTES = 150 * 2**20
MAX_COPIES = 4096


def cold_graph_ms(torch, cs, fn, operands) -> float:
    """Device ms per call of ``fn(*operands)`` from CUDA-graph replays of
    calls on copies of the operands, each call with outputs of its own: with
    operands and outputs of all copies over ``COLD_BYTES`` (up to
    ``MAX_COPIES`` copies), a call's data has left the L2 cache before its
    turn comes again, so it reads and writes HBM, as the byte bound counts."""
    out = fn(*operands)
    moved = sum(t.nbytes for t in (*operands, *(out if isinstance(out, tuple) else (out,))))
    copies = max(2, min(MAX_COPIES, -(-COLD_BYTES // moved)))
    sets = [tuple(t.clone() for t in operands) for _ in range(copies)]
    return cs.graph_ms(torch, lambda: [fn(*ops) for ops in sets], calls=1) / copies


def epilogue_operands(torch, i, steps, rows, n):
    gen = torch.Generator(device="cuda").manual_seed(200 + i)
    cur = torch.randn((steps, rows, n), device="cuda", generator=gen) * 0.6
    bias = torch.randn((n,), device="cuda", generator=gen) * 0.1
    return cur, bias


def dense_operands(torch, m, k, n):
    gen = torch.Generator(device="cuda").manual_seed(300)
    patches = torch.rand((m, k), device="cuda", generator=gen)
    w2d = torch.randn((k, n), device="cuda", generator=gen) * (2.0 / k) ** 0.5
    bias = torch.randn((n,), device="cuda", generator=gen) * 0.1
    return patches, w2d, bias


def child(root: str, kernels) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path[:0] = [os.path.join(os.path.abspath(root), "src"), REPO]
    import chip_smoke as cs
    from repro_torch.configs import vgg9_snn

    cfg = vgg9_snn.CIFAR10
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    digests = {}
    if "spike_matmul" in kernels:
        from repro_torch.kernels.spike_conv import ops as sc
        digest = hashlib.sha256()
        times = {}
        for d_i, density in enumerate(cs.DENSITIES):
            row = []
            for s_i, shape in enumerate(cs.unfused_shapes(cfg, cs.SLOTS)[0]):
                gen = torch.Generator(device="cuda").manual_seed(100 * d_i + s_i)
                patches, w2d = cs.served_gated_operands(torch, shape, gen, density)
                digest.update(sc.spike_matmul(patches, w2d).cpu().numpy().tobytes())
                row.append(cs.cuda_ms(torch, lambda: sc.spike_matmul(patches, w2d)))
            times[str(density)] = row
        out["spike_matmul"] = {"ms": times, "sum_ms": {d: sum(v) for d, v in times.items()}}
        digests["spike_matmul"] = digest.hexdigest()
    dense_shape, _, epilogues = cs.main_path_shapes(cfg, cs.SLOTS)
    timed = {}
    if "lif_epilogue_scan" in kernels:
        from repro_torch.kernels.lif_step import ops as lif
        epilogue = lambda cur, bias: lif.lif_epilogue_scan(cur, bias, beta=cs.BETA,
                                                           theta=cs.THETA)
        timed["lif_epilogue_scan"] = [
            (name, epilogue, epilogue_operands(torch, i, cfg.timesteps, rows, n))
            for i, (name, rows, n) in enumerate(epilogues)]
    if "dense_conv_lif" in kernels:
        from repro_torch.kernels.dense_conv_lif import ops as dense
        timed["dense_conv_lif"] = [("conv0", lambda patches, w2d, bias: dense.dense_conv_lif(
            patches, w2d, bias, num_steps=cfg.timesteps, beta=cs.BETA, theta=cs.THETA),
            dense_operands(torch, *dense_shape))]
    for kname, runs in timed.items():
        digest = hashlib.sha256()
        rows = {}
        for name, fn, operands in runs:
            result = fn(*operands)
            for t in (result if isinstance(result, tuple) else (result,)):
                digest.update(t.cpu().numpy().tobytes())
            run = lambda: fn(*operands)
            rows[name] = {"ms": cs.cuda_ms(torch, run), "graph_ms": cs.graph_ms(torch, run),
                          "cold_graph_ms": cold_graph_ms(torch, cs, fn, operands)}
        out[kname] = {"shapes": rows, **{f"sum_{key}": sum(r[key] for r in rows.values())
                                         for key in ("ms", "graph_ms", "cold_graph_ms")}}
        digests[kname] = digest.hexdigest()
    out["digests"] = digests
    return out


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1], argv[2].split(","))))
        return 0
    kernels = ["spike_matmul"]
    if argv[:1] == ["--kernels"]:
        kernels, argv = argv[1].split(","), argv[2:]
    if not argv or any(k not in KERNELS for k in kernels):
        print(__doc__)
        return 2
    results = []
    for root in argv:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                              ",".join(kernels)], capture_output=True, text=True)
        if out.returncode != 0:
            print(f"FAIL: {root}: {out.stderr.strip()[-2000:]}", flush=True)
            return 1
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    same = {k: len({r["digests"][k] for r in results}) == 1 for k in kernels}
    print(f"outputs bit-identical across roots: {same}")
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
