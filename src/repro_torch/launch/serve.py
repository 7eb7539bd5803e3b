"""Serving CLI for the port: the decoder LM or the spiking VGG9 behind one EngineCore.

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --arch qwen1.5-4b --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --device cpu \\
        --prefill-chunk 4 --speculate 4 --temperature 0.8 --top-p 0.95 --seed 7
    # qwen1.5-4b at its full width and depth (fp32 weights, 15.8 GB; the card):
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --d-model 0 --n-layers 0 --vocab 0 --seq 512 --int4
    PYTHONPATH=src python -m repro_torch.launch.serve --workload snn --requests 6 --int4
    PYTHONPATH=src python -m repro_torch.launch.serve --workload snn --device cpu --mixed-trace

Runs on the card unless ``--device cpu`` is given; asking for the card
without one raises. The LM is cut to ``--d-model`` / ``--n-layers`` /
``--vocab`` as the JAX package's CLI cuts it (0 keeps the architecture's
own). The fleet, precision, data-shard, SLO and metrics flags of that CLI
are not ported yet and exit with a message saying so.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

import torch

from ..configs import get_arch, vgg9_snn
from ..device import resolve_device
from ..models import transformer as tf
from ..models.vgg9 import init_vgg9
from ..serve.api import EngineConfig
from ..serve.core import EngineCore
from ..serve.runners.lm import LMRunner
from ..serve.runners.snn import SNNRunner

#: flags of the JAX CLI that this port does not serve yet: (flag, test)
NOT_PORTED = (
    ("--replicas", lambda a: a.replicas != 1),
    ("--workers", lambda a: a.workers != 0),
    ("--fault-plan", lambda a: bool(a.fault_plan)),
    ("--precision", lambda a: bool(a.precision)),
    ("--data-shard", lambda a: a.data_shard > 1),
    ("--metrics", lambda a: bool(a.metrics)),
    ("--slo-ms", lambda a: a.slo_ms > 0),
)


def _sampling(a) -> bool:
    return a.temperature > 0 or a.top_k > 0 or a.top_p < 1.0


#: the JAX CLI's rules (`FLAG_RULES`) that bind the flags ported here
FLAG_RULES = (
    (lambda a: (a.speculate or _sampling(a)) and a.workload != "lm",
     "--speculate/--temperature/--top-k/--top-p are LM-only"),
    (lambda a: (a.speculate or _sampling(a)) and a.admission == "batch",
     "--speculate and sampling need --admission continuous "
     "(the run-to-completion batch path is greedy-only)"),
)


def reduce_cfg(cfg, args):
    """The JAX package's `launch.train.reduce_cfg`: float32 weights, and
    width, depth and vocab cut to the flags (0 keeps the config's own)."""
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


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=("lm", "snn"), default="lm")
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--tokens", type=int, default=16, help="LM: new tokens per request")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=64, help="LM width (0 = the arch's)")
    ap.add_argument("--n-layers", type=int, default=4, help="LM depth (0 = the arch's)")
    ap.add_argument("--vocab", type=int, default=512, help="LM vocab (0 = the arch's)")
    ap.add_argument("--seq", type=int, default=64, help="LM: KV cache length (max_seq)")
    ap.add_argument("--img-hw", type=int, default=0, help="SNN image size override")
    ap.add_argument("--int4", action="store_true", help="int4-weight numerics")
    ap.add_argument("--scheduler",
                    choices=("fifo", "sparsity", "slo", "slo:fifo", "slo:sparsity"),
                    default="fifo", help="batch-composition policy (serve.scheduler)")
    ap.add_argument("--admission", choices=("continuous", "batch"),
                    default="continuous",
                    help="step-level admission vs run-to-completion batching")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="LM continuous admission: prompt tokens a joining request "
                         "prefills per engine step (outputs are bit-identical)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="LM: draft up to K tokens per decode row (n-gram prompt "
                         "lookup) and verify them in one launch")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="LM sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="LM: sample from the k highest logits (0 = all)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="LM: nucleus sampling mass (1.0 = all)")
    ap.add_argument("--mixed-trace", action="store_true",
                    help="SNN: alternate near-silent and dense requests")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: the card)")
    # flags of the JAX CLI, accepted so that they can be refused clearly
    ap.add_argument("--replicas", type=int, default=1, help="not ported yet")
    ap.add_argument("--workers", type=int, default=0, help="not ported yet")
    ap.add_argument("--fault-plan", default="", help="not ported yet")
    ap.add_argument("--precision", default="", help="not ported yet")
    ap.add_argument("--data-shard", type=int, default=0, help="not ported yet")
    ap.add_argument("--metrics", default="", help="not ported yet")
    ap.add_argument("--slo-ms", type=float, default=0.0, help="not ported yet")
    return ap.parse_args(argv)


def engine_config(args) -> EngineConfig:
    return EngineConfig(slots=args.slots, admission=args.admission,
                        scheduler=args.scheduler, prefill_chunk=args.prefill_chunk)


def serve_lm(args) -> None:
    device = resolve_device(args.device)
    cfg = reduce_cfg(get_arch(args.arch), args).with_(frontend="", n_frontend_tokens=0)
    params = tf.init_params(torch.Generator(device=device).manual_seed(args.seed), cfg, device)
    runner = LMRunner(cfg, params, max_seq=args.seq, quant_bits=4 if args.int4 else 0,
                      speculate_k=args.speculate, device=device)
    core = EngineCore(runner, engine_config(args))

    sampling_opts = {}
    if _sampling(args):
        sampling_opts = {"temperature": args.temperature,
                         "top_k": args.top_k, "top_p": args.top_p}
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompts = []
    for _ in range(args.requests):
        length = int(torch.randint(1, 6, (), generator=gen))
        prompts.append(torch.randint(1, cfg.vocab, (length,), generator=gen).tolist())
    # per-request seed: each request gets its own stream, deterministic
    # across runs for a fixed --seed
    ids = [core.submit(p, max_new_tokens=args.tokens,
                       **(dict(sampling_opts, seed=args.seed + i) if sampling_opts else {}))
           for i, p in enumerate(prompts)]
    results = core.run_until_complete()
    for i, rid in enumerate(ids):
        res = results[rid]
        print(f"req{rid}: prompt={prompts[i]} -> {res.outputs[len(prompts[i]):]} "
              f"status={res.status} stats={dict(res.stats)}")
    stats = core.stats()
    if args.speculate > 0 and stats.get("drafted_tokens"):
        print(f"speculative: drafted={stats['drafted_tokens']} "
              f"accepted={stats['accepted_tokens']} "
              f"accept_rate={stats['accept_rate']:.3f} "
              f"goodput={stats['goodput_decode_tok_per_step']:.2f} tok/step")
    print(f"engine: {stats}")


def serve_snn(args) -> None:
    device = resolve_device(args.device)
    cfg = vgg9_snn.TINY_INT4 if args.int4 else vgg9_snn.TINY
    if args.img_hw:
        cfg = dataclasses.replace(cfg, img_hw=args.img_hw)
    params = init_vgg9(torch.Generator().manual_seed(args.seed), cfg, device)
    core = EngineCore(SNNRunner(cfg, params, device=device), engine_config(args))

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
                 "serves the LM and SNN workloads on one engine)")
    for broken, message in FLAG_RULES:
        if broken(args):
            sys.exit(message)
    if args.workload == "snn":
        serve_snn(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
