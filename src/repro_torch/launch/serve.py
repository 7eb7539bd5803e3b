"""Serving driver for the port: the spiking VGG9 behind one EngineCore.

    PYTHONPATH=src python -m repro_torch.launch.serve --workload snn --requests 6 --int4
    PYTHONPATH=src python -m repro_torch.launch.serve --workload snn --scheduler sparsity --mixed-trace
    PYTHONPATH=src python -m repro_torch.launch.serve --workload snn --device cpu --requests 3

Runs on the card unless ``--device cpu`` is given; asking for the card
without one raises. The LM workload and the fleet, precision, data-shard
and metrics flags of the JAX driver are not ported yet and exit with a
message saying so.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

import torch

from ..configs import vgg9_snn
from ..device import resolve_device
from ..models.vgg9 import init_vgg9
from ..serve.api import EngineConfig
from ..serve.core import EngineCore
from ..serve.runners.snn import SNNRunner

#: flags of the JAX driver that this port does not serve yet: (flag, test)
NOT_PORTED = (
    ("--workload lm", lambda a: a.workload == "lm"),
    ("--replicas", lambda a: a.replicas != 1),
    ("--workers", lambda a: a.workers != 0),
    ("--fault-plan", lambda a: bool(a.fault_plan)),
    ("--precision", lambda a: bool(a.precision)),
    ("--data-shard", lambda a: a.data_shard > 1),
    ("--metrics", lambda a: bool(a.metrics)),
)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=("lm", "snn"), default="snn")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--img-hw", type=int, default=0, help="SNN image size override")
    ap.add_argument("--int4", action="store_true", help="int4-weight numerics")
    ap.add_argument("--scheduler",
                    choices=("fifo", "sparsity", "slo", "slo:fifo", "slo:sparsity"),
                    default="fifo", help="batch-composition policy (serve.scheduler)")
    ap.add_argument("--admission", choices=("continuous", "batch"),
                    default="continuous",
                    help="step-level admission vs run-to-completion batching")
    ap.add_argument("--mixed-trace", action="store_true",
                    help="alternate near-silent and dense requests")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pipeline runs (default: the card)")
    # flags of the JAX driver, accepted so that they can be refused clearly
    ap.add_argument("--replicas", type=int, default=1, help="not ported yet")
    ap.add_argument("--workers", type=int, default=0, help="not ported yet")
    ap.add_argument("--fault-plan", default="", help="not ported yet")
    ap.add_argument("--precision", default="", help="not ported yet")
    ap.add_argument("--data-shard", type=int, default=0, help="not ported yet")
    ap.add_argument("--metrics", default="", help="not ported yet")
    return ap.parse_args(argv)


def serve_snn(args) -> None:
    device = resolve_device(args.device)
    cfg = vgg9_snn.TINY_INT4 if args.int4 else vgg9_snn.TINY
    if args.img_hw:
        cfg = dataclasses.replace(cfg, img_hw=args.img_hw)
    params = init_vgg9(torch.Generator().manual_seed(args.seed), cfg, device)
    core = EngineCore(SNNRunner(cfg, params, device=device),
                      EngineConfig(slots=args.slots, admission=args.admission,
                                   scheduler=args.scheduler))

    gen = torch.Generator().manual_seed(args.seed + 1)
    shape = (cfg.img_hw, cfg.img_hw, cfg.in_ch)
    ids = []
    for i in range(args.requests):
        img = torch.rand(shape, generator=gen)
        if args.mixed_trace and i % 2 == 0:
            # alternate near-silent requests: the mixed-sparsity trace the
            # sparsity-aware scheduler separates from the dense stream
            ids.append(core.submit(img * 0.02, source="sparse"))
        else:
            ids.append(core.submit(img, source="dense"))
    results = core.run_until_complete()
    for rid in ids:
        res = results[rid]
        pred = int(res.outputs.argmax())
        skip = {k: round(v, 3) for k, v in res.stats["skip_rate"].items()}
        print(f"req{rid}: class={pred} spikes={res.stats['spike_total']:.0f} "
              f"skip={skip} precision={res.stats['precision']} "
              f"energy={res.stats['energy_j']:.3e} J "
              f"served={res.stats['served_energy_j']:.3e} J "
              f"(analytical {res.stats['served_energy_analytical_j']:.3e} J)")
    print(f"engine: {core.stats()}")
    print(f"admissions: {core.admission_log}")


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    refused = [flag for flag, used in NOT_PORTED if used(args)]
    if refused:
        sys.exit(f"not ported yet: {', '.join(refused)} (the PyTorch port "
                 "serves the SNN workload on one engine)")
    serve_snn(args)


if __name__ == "__main__":
    main()
