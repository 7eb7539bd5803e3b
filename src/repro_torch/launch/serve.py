"""Serving CLI for the port: the decoder LM or the spiking VGG9 behind one EngineCore.

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --arch qwen1.5-4b --tokens 16
    # any of the ten registered archs, e.g. MoE or recurrent (reduced):
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --device cpu \\
        --arch granite-moe-3b-a800m --prefill-chunk 4
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --device cpu \\
        --prefill-chunk 4 --speculate 4 --temperature 0.8 --top-p 0.95 --seed 7
    # qwen1.5-4b at its full width and depth (fp32 weights, 15.8 GB; the card):
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --d-model 0 --n-layers 0 --vocab 0 --seq 512 --int4
    PYTHONPATH=src python -m repro_torch.launch.serve --workload snn --requests 6 --int4
    PYTHONPATH=src python -m repro_torch.launch.serve --workload snn --device cpu --mixed-trace

    # chunked prefill + latency SLOs (budgeted-session serving):
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --prefill-chunk 8 --scheduler slo --slo-ms 3000

    # adaptive-precision serving: fp32+int4 variants behind one engine, the
    # controller picking per request from the sparsity scheduler's EWMAs,
    # with the observability plane's metrics printed at exit:
    PYTHONPATH=src python -m repro_torch.launch.serve --workload snn \\
        --scheduler sparsity --mixed-trace --precision adaptive --metrics prom

    # fault-tolerant fleet: 3 replicas behind the supervised router, with
    # an injected wedge on replica 0 (one slot each, so that replica 0
    # still holds a request when the wedge starts):
    PYTHONPATH=src python -m repro_torch.launch.serve --workload snn --slots 1 \\
        --replicas 3 --fault-plan '0=wedge@1'

    # multi-process fleet: 2 worker subprocesses (one EngineCore + runner
    # each) supervised over the versioned wire protocol:
    PYTHONPATH=src python -m repro_torch.launch.serve --workload snn --workers 2

Runs on the card unless ``--device cpu`` is given; asking for the card
without one raises. The LM is cut to ``--d-model`` / ``--n-layers`` /
``--vocab`` as the JAX package's CLI cuts it (0 keeps the architecture's
own; archs with more than 8 experts keep 8 at top-k <= 2, frontends are
dropped). ``--speculate`` on an arch with recurrent or ring-buffer state
(recurrentgemma-2b, xlstm-125m) is refused with the reference's
AssertionError. ``--workers N`` serves through N worker subprocesses on the
same device, each building its runner from the same seeded spec. The
data-shard flag of that CLI (`NOT_PORTED`) is not ported yet and exits
with a message saying so.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, List, Optional

import torch

from ..configs import get_arch, vgg9_snn
from ..device import resolve_device
from ..models import transformer as tf
from ..models.vgg9 import init_vgg9
from ..serve.api import EngineConfig, Request, StepBudget
from ..serve.core import EngineCore
from ..serve.runners.lm import LMRunner
from ..serve.runners.snn import SNNRunner

#: flags of the JAX CLI that this port does not serve yet: (flag, test)
NOT_PORTED = (
    ("--data-shard", lambda a: a.data_shard > 1),
)


@dataclasses.dataclass(frozen=True)
class FlagRule:
    """One CLI compatibility constraint: ``when(args)`` true => reject the
    invocation with ``error``. `FLAG_RULES` below is the compatibility
    policy as data, as in the JAX package's CLI."""

    name: str
    when: Callable
    error: str


def _sampling(a) -> bool:
    return a.temperature > 0 or a.top_k > 0 or a.top_p < 1.0


#: the JAX CLI's rules whose flags are all ported, with its names and
#: messages; its rule on --data-shard joins when that flag does
FLAG_RULES = (
    FlagRule("replicas-range", lambda a: a.replicas < 1,
             "--replicas must be >= 1"),
    FlagRule("workers-range", lambda a: a.workers < 0,
             "--workers must be >= 0 (0 = in-process serving)"),
    FlagRule("slo-needs-continuous",
             lambda a: a.slo_ms > 0 and a.admission == "batch",
             "--slo-ms requires --admission continuous "
             "(deadlines are step-level; the batch path ignores them)"),
    FlagRule("slo-vs-fleet",
             lambda a: a.slo_ms > 0 and (a.replicas > 1 or a.fault_plan),
             "--slo-ms is a wall-clock SLO; the replica router runs on "
             "a deterministic tick clock (drop --replicas/--fault-plan, "
             "or use deadline-free requests with the fleet)"),
    FlagRule("precision-vs-int4", lambda a: a.precision and a.int4,
             "--int4 pins numerics at runner construction; with "
             "--precision the engine holds both variants (use "
             "--precision int4 for a pinned int4 fleet)"),
    FlagRule("precision-vs-fleet",
             lambda a: a.precision and (a.replicas > 1 or a.fault_plan),
             "--precision builds a single controller-bound engine; "
             "drop --replicas/--fault-plan"),
    FlagRule("lm-only-knobs",
             lambda a: (a.speculate or _sampling(a)) and a.workload != "lm",
             "--speculate/--temperature/--top-k/--top-p are LM-only"),
    FlagRule("sampling-needs-continuous",
             lambda a: (a.speculate or _sampling(a))
             and a.admission == "batch",
             "--speculate and sampling need --admission continuous "
             "(the run-to-completion batch path is greedy-only)"),
    FlagRule("speculate-vs-precision",
             lambda a: a.speculate and a.precision,
             "--speculate drafts against one resident KV cache; the "
             "--precision variant registry swaps runners per request "
             "(drop one of the two)"),
    FlagRule("workers-vs-replicas",
             lambda a: a.workers > 0 and a.replicas > 1,
             "--workers and --replicas are both fleet sizes (subprocess "
             "vs in-process replicas); pick one"),
    FlagRule("workers-vs-fault-plan",
             lambda a: a.workers > 0 and bool(a.fault_plan),
             "--fault-plan injects faults into in-process replicas; "
             "subprocess workers are chaos-tested by killing the process, "
             "not by injection"),
    FlagRule("workers-vs-precision",
             lambda a: a.workers > 0 and bool(a.precision),
             "--precision builds a single controller-bound engine; it "
             "does not serve through subprocess workers"),
    FlagRule("workers-vs-slo",
             lambda a: a.workers > 0 and a.slo_ms > 0,
             "--slo-ms deadlines are stamped on each worker's own wall "
             "clock at submit; cross-process SLO accounting is not "
             "supported (drop one of the two)"),
)


def check_flags(args) -> List[FlagRule]:
    """Every violated `FlagRule` for this namespace (empty = accepted)."""
    return [rule for rule in FLAG_RULES if rule.when(args)]


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
    ap.add_argument("--precision", choices=("fp32", "int4", "adaptive"),
                    default="",
                    help="precision-controlled serving (serve.precision): "
                         "both fp32 and int4 variants behind one engine. "
                         "'fp32'/'int4' pin every unpinned request; "
                         "'adaptive' picks per request from EWMA sparsity "
                         "estimates, SLO slack and the accuracy budget. "
                         "Pair with --scheduler sparsity to close the "
                         "quantization->sparsity feedback loop online")
    ap.add_argument("--scheduler",
                    choices=("fifo", "sparsity", "slo", "slo:fifo", "slo:sparsity"),
                    default="fifo", help="batch-composition policy (serve.scheduler)")
    ap.add_argument("--admission", choices=("continuous", "batch"),
                    default="continuous",
                    help="step-level admission vs run-to-completion batching")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="LM continuous admission: prompt tokens a joining request "
                         "prefills per engine step (outputs are bit-identical)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="LM: per-request latency SLO in milliseconds "
                         "(wall clock); expired requests surface "
                         "status='expired'. Pair with --scheduler slo")
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
    ap.add_argument("--metrics", choices=("json", "prom"), default="",
                    help="attach the observability plane (repro_torch.obs): "
                         "per-request trace spans, typed metrics and a "
                         "flight recorder on the engine, exported at exit "
                         "as JSON or Prometheus text. Outputs stay "
                         "bit-identical with it on or off")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: the card)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a supervised router over N engine "
                         "replicas (heartbeat + numerics probe; wedged or "
                         "poisoned replicas drain, in-flight requests "
                         "re-route by deterministic replay)")
    ap.add_argument("--fault-plan", default="",
                    help="fault-injection schedule per replica, e.g. "
                         "'0=wedge@4,1=nan@6:slot=0' (kinds: wedge, slow, "
                         "raise, nan, flood). Implies the router path even "
                         "with --replicas 1")
    ap.add_argument("--workers", type=int, default=0, metavar="N",
                    help="serve through N worker *subprocesses* (one "
                         "EngineCore + runner each, supervised over the "
                         "versioned wire protocol; a killed worker's "
                         "in-flight requests replay elsewhere "
                         "bit-identically). 0 serves in-process")
    # a flag of the JAX CLI, accepted so that it can be refused clearly
    ap.add_argument("--data-shard", type=int, default=0, help="not ported yet")
    return ap.parse_args(argv)


def engine_config(args) -> EngineConfig:
    return EngineConfig(slots=args.slots, admission=args.admission,
                        scheduler=args.scheduler, prefill_chunk=args.prefill_chunk,
                        precision=args.precision)


def make_obs(args):
    """One `Observability` bundle when --metrics asked for one, else None
    (detached serving is the default and is bit-identical by contract)."""
    if not args.metrics:
        return None
    from ..obs import Observability
    return Observability()


def precision_engine(runner_factory, pricer, args):
    """Precision-capable single engine: fp32+int4 variant registry behind a
    `PrecisionRunner`, pre-warmed, with the controller bound to the sparsity
    scheduler's prediction/observation stream when one is in play."""
    from ..serve.precision import (PrecisionController, PrecisionRunner,
                                   bind_controller)
    from ..serve.scheduler import SparsityAwareScheduler, make_scheduler

    registry = runner_factory()
    controller = PrecisionController(
        pricer=pricer,
        slo_tight_s=args.slo_ms / 1000.0 if args.slo_ms > 0 else None)
    runner = PrecisionRunner(registry, controller, mode=args.precision)
    registry.prewarm(args.slots)
    scheduler = make_scheduler(args.scheduler)
    inner = getattr(scheduler, "inner", scheduler)
    if isinstance(inner, SparsityAwareScheduler):
        bind_controller(inner, controller)
    core = EngineCore(runner, engine_config(args), scheduler=scheduler,
                      obs=make_obs(args))
    return core, controller


def build_engine(runner, args):
    """One `EngineCore`, or a supervised `Router` fleet when --replicas > 1.

    Any --fault-plan also routes through the fleet path so a single replica
    can be chaos-tested; the router runs on a shared deterministic tick
    clock, which is why --slo-ms (wall clock) is rejected alongside it.
    """
    if args.replicas > 1 or args.fault_plan:
        from ..serve.faults import parse_fleet_plan
        from ..serve.router import make_router
        plans = parse_fleet_plan(args.fault_plan) if args.fault_plan else None
        return make_router(runner, max(1, args.replicas),
                           engine_config(args), plans=plans,
                           obs=bool(args.metrics))
    return EngineCore(runner, engine_config(args), obs=make_obs(args))


def print_fleet_report(core) -> None:
    print(f"engine: {core.stats()}")
    for entry in getattr(core, "drain_log", []):
        step, idx, condition, rerouted = entry[:4]
        detail = entry[4] if len(entry) > 4 else {}
        extra = (f"; marker={detail.get('marker')} "
                 f"cost_finite={detail.get('cost_finite')}")
        dump = detail.get("dump")
        if dump:
            extra += f" recorder_frames={len(dump.get('frames', []))}"
        print(f"drain @step {step}: replica {idx} condemned ({condition}), "
              f"re-routed requests {rerouted}{extra}")


def print_observability(core, fmt: str) -> None:
    """--metrics export: the run's metrics snapshot (JSON or Prometheus
    text) plus a one-line trace / flight-recorder summary. Routers merge
    replica telemetry; a lone engine exports its own bundle."""
    from ..obs import to_prometheus
    if hasattr(core, "telemetry"):              # router fleet: merged view
        tel = core.telemetry()
    elif getattr(core, "obs", None) is not None:
        tel = core.obs.snapshot()
    else:
        return
    snap = tel.get("metrics", {})
    if fmt == "prom":
        print(to_prometheus(snap), end="")
    else:
        print("METRICS_JSON " + json.dumps(snap, sort_keys=True))
    print(f"trace: {len(tel.get('trace', []))} spans; "
          f"recorder dumps: {len(tel.get('dumps', []))}")


def warm_slo(runner, prompts, args) -> None:
    """Wall-clock SLOs start at submit(): run this trace once, then every
    pow2 chunk width up to the SLO scheduler's boost cap, so that the
    kernels' build and the first library calls on the card land before any
    deadline (the budget split can boost a prefill chunk past
    --prefill-chunk mid-deadline)."""
    from ..serve.scheduler import SLOScheduler
    warm = EngineCore(runner, engine_config(args))
    for p in prompts:
        warm.submit(p, max_new_tokens=args.tokens)
    warm.run_until_complete()
    w, cap = 2, SLOScheduler.DEFAULT_BOOST_CAP
    while w <= cap and w // 2 < args.seq - 2:
        plen = min(w + 1, args.seq - 2)
        sess = runner.open_session(args.slots)
        sess.admit(0, Request(-1, [1] * plen, {"max_new_tokens": 1}))
        sess.step(StepBudget(chunk=w))
        w *= 2


def serve_lm(args) -> None:
    device = resolve_device(args.device)
    cfg = reduce_cfg(get_arch(args.arch), args).with_(frontend="", n_frontend_tokens=0)
    controller, runner = None, None
    if args.workers > 0:
        from ..serve.router import make_worker_fleet
        from ..serve.worker import lm_spec
        # every worker rebuilds params from the same wire-encodable spec
        # (seed and device included), so re-routes after a worker death
        # replay bit-identically and the parent never materialises the model
        spec = lm_spec(cfg, seed=args.seed, max_seq=args.seq,
                       quant_bits=4 if args.int4 else 0,
                       speculate_k=args.speculate, device=device.type)
        core = make_worker_fleet(spec, args.workers, engine_config(args),
                                 obs=bool(args.metrics))
    else:
        params = tf.init_params(torch.Generator(device=device).manual_seed(args.seed), cfg,
                                device)
        if args.precision:
            from ..serve.precision import make_lm_variants
            core, controller = precision_engine(
                lambda: make_lm_variants(cfg, params, max_seq=args.seq, device=device),
                None, args)
        else:
            runner = LMRunner(cfg, params, max_seq=args.seq, quant_bits=4 if args.int4 else 0,
                              speculate_k=args.speculate, device=device)
            core = build_engine(runner, args)

    sampling_opts = {}
    if _sampling(args):
        sampling_opts = {"temperature": args.temperature,
                         "top_k": args.top_k, "top_p": args.top_p}
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompts = []
    for _ in range(args.requests):
        length = int(torch.randint(1, 6, (), generator=gen))
        prompts.append(torch.randint(1, cfg.vocab, (length,), generator=gen).tolist())
    deadline = args.slo_ms / 1000.0 if args.slo_ms > 0 else None
    if deadline is not None and runner is not None:
        # (the --precision path warms both variants in VariantRegistry.prewarm)
        warm_slo(runner, prompts, args)
    # per-request seed: each request gets its own stream, deterministic
    # across runs for a fixed --seed
    ids = [core.submit(p, max_new_tokens=args.tokens, deadline_s=deadline,
                       **(dict(sampling_opts, seed=args.seed + i) if sampling_opts else {}))
           for i, p in enumerate(prompts)]
    results = core.run_until_complete()
    for i, rid in enumerate(ids):
        res = results[rid]
        # expired-in-queue requests never produced outputs
        new = res.outputs[len(prompts[i]):] if res.outputs is not None else None
        print(f"req{rid}: prompt={prompts[i]} -> {new} "
              f"status={res.status} stats={dict(res.stats)}")
    stats = core.stats()
    if args.speculate > 0 and stats.get("drafted_tokens"):
        print(f"speculative: drafted={stats['drafted_tokens']} "
              f"accepted={stats['accepted_tokens']} "
              f"accept_rate={stats['accept_rate']:.3f} "
              f"goodput={stats['goodput_decode_tok_per_step']:.2f} tok/step")
    print_fleet_report(core)
    if controller is not None:
        print(f"precision controller: {controller.summary()}")
    if args.metrics:
        print_observability(core, args.metrics)
    if hasattr(core, "close"):                  # worker fleets need a reap
        core.close()


def serve_snn(args) -> None:
    device = resolve_device(args.device)
    cfg = vgg9_snn.TINY_INT4 if args.int4 else vgg9_snn.TINY
    if args.img_hw:
        cfg = dataclasses.replace(cfg, img_hw=args.img_hw)
    controller = None
    if args.workers > 0:
        from ..serve.router import make_worker_fleet
        from ..serve.worker import snn_spec
        core = make_worker_fleet(snn_spec(cfg, seed=args.seed, device=device.type),
                                 args.workers, engine_config(args),
                                 obs=bool(args.metrics))
    else:
        params = init_vgg9(torch.Generator().manual_seed(args.seed), cfg, device)
        if args.precision:
            from ..serve.precision import make_snn_pricer, make_snn_variants
            core, controller = precision_engine(
                lambda: make_snn_variants(cfg, params, device=device),
                make_snn_pricer(cfg), args)
        else:
            core = build_engine(SNNRunner(cfg, params, device=device), args)

    gen = torch.Generator().manual_seed(args.seed + 1)
    shape = (cfg.img_hw, cfg.img_hw, cfg.in_ch)
    ids = []
    for i in range(args.requests):
        img = torch.rand(shape, generator=gen)
        opts = {}
        if args.precision and i % 3 == 0:
            # exercise the never-switch invariant from the CLI: every third
            # request is accuracy-pinned to fp32 regardless of controller
            opts["pin_precision"] = "fp32"
        if args.mixed_trace and i % 2 == 0:
            # alternate near-silent requests: the mixed-sparsity trace the
            # sparsity-aware scheduler separates from the dense stream
            ids.append(core.submit(img * 0.02, source="sparse", **opts))
        else:
            ids.append(core.submit(img, source="dense", **opts))
    results = core.run_until_complete()
    for rid in ids:
        res = results[rid]
        if res.outputs is None:                 # failed or shed by the fleet
            print(f"req{rid}: status={res.status}")
            continue
        pred = int(res.outputs.argmax())
        skip = {k: round(v, 3) for k, v in res.stats["skip_rate"].items()}
        print(f"req{rid}: class={pred} spikes={res.stats['spike_total']:.0f} "
              f"skip={skip} precision={res.stats['precision']} "
              f"energy={res.stats['energy_j']:.3e} J "
              f"served={res.stats['served_energy_j']:.3e} J "
              f"(analytical {res.stats['served_energy_analytical_j']:.3e} J) "
              f"status={res.status}")
    print_fleet_report(core)
    if controller is not None:
        print(f"precision controller: {controller.summary()}")
    if args.metrics:
        print_observability(core, args.metrics)
    if hasattr(core, "admission_log"):          # single engine, not a fleet
        print(f"admissions: {core.admission_log}")
    if hasattr(core, "close"):                  # worker fleets need a reap
        core.close()


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    refused = [flag for flag, used in NOT_PORTED if used(args)]
    if refused:
        sys.exit(f"not ported yet: {', '.join(refused)} (the PyTorch port "
                 "serves on one device, not over a data mesh)")
    for rule in check_flags(args):
        sys.exit(rule.error)
    if args.workload == "snn":
        serve_snn(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
