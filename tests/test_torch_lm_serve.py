"""The port's LM serving stack against the JAX package's, plus its entry points.

The same weights (a JAX parameter tree carried across) and the same trace go
through both packages' `EngineCore` + `LMRunner`: greedy streams must be
equal token for token in fp32 and int4, under batch and continuous
admission, with ``prefill_chunk`` 1 and 4; sampled streams too (the numpy
sampling layer is seeded per request and generation index, and picks off
logits within 1e-4 of each other). Within the port, speculative serving,
mid-stream admission and slot reuse are held bit for bit against plain,
solo serving.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.core.quant import quantize_int4 as jax_quantize_int4
from repro.kernels.int4_matmul.ops import w4a16_linear as jax_w4a16
from repro.models import transformer as jax_tf
from repro.serve.api import EngineConfig as JaxEngineConfig
from repro.serve.core import EngineCore as JaxEngineCore
from repro.serve.runners.lm import LMRunner as JaxLMRunner
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import serve as cli
from repro_torch.launch import serve_lm_w4
from repro_torch.models import transformer as tf
from repro_torch.serve.api import EngineConfig, Request, StepBudget
from repro_torch.serve.core import EngineCore
from repro_torch.serve.runners.lm import LMRunner

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the reduced qwen of examples/serve_lm_w4.py, and a GQA variant
QWEN = dict(name="qwen-small", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, head_dim=16, d_ff=128, vocab=257, qkv_bias=True,
            dtype="float32", remat="none", q_chunk=16, kv_chunk=16)
GQA = dict(QWEN, name="gqa-small", n_kv_heads=2, qkv_bias=False)
SEQ = 48
TOKENS = 8
PROMPTS = ([1, 2, 3], [9, 8], [], [12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25],
           [5], [7, 8, 9, 7, 8, 9, 7, 8])
REPETITIVE = [4, 5, 6, 4, 5, 6, 4, 5, 6, 4, 5]


@pytest.fixture(scope="module")
def weights():
    """{name: (jax params, port params)} from one JAX init each."""
    out = {}
    for kw in (QWEN, GQA):
        jp = jax_tf.init_params(jax.random.PRNGKey(0), jax_base.ArchConfig(**kw))
        out[kw["name"]] = (jp, tf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return out


def _serve(core, prompts, **opts):
    ids = [core.submit(list(p), max_new_tokens=TOKENS, **opts) for p in prompts]
    results = core.run_until_complete()
    return [results[i] for i in ids]


def _port_core(kw, params, slots=3, speculate_k=0, **engine):
    runner = LMRunner(ArchConfig(**kw), params, max_seq=SEQ, device="cpu",
                      speculate_k=speculate_k, quant_bits=engine.pop("quant_bits", 0))
    return EngineCore(runner, EngineConfig(slots=slots, **engine))


@pytest.mark.parametrize("kw,bits,admission,chunk", [
    (QWEN, 0, "continuous", 1), (QWEN, 0, "continuous", 4), (QWEN, 0, "batch", 1),
    (QWEN, 4, "continuous", 1), (QWEN, 4, "continuous", 4), (QWEN, 4, "batch", 1),
    (GQA, 0, "continuous", 4)], ids=lambda v: str(v.get("name") if isinstance(v, dict) else v))
def test_greedy_streams_equal_reference(weights, kw, bits, admission, chunk):
    jp, tp = weights[kw["name"]]
    jcore = JaxEngineCore(JaxLMRunner(jax_base.ArchConfig(**kw), jp, max_seq=SEQ,
                                      quant_bits=bits),
                          JaxEngineConfig(slots=3, admission=admission, prefill_chunk=chunk))
    core = _port_core(kw, tp, quant_bits=bits, admission=admission, prefill_chunk=chunk)
    ref, out = _serve(jcore, PROMPTS), _serve(core, PROMPTS)
    assert [r.outputs for r in out] == [r.outputs for r in ref]
    assert [r.stats for r in out] == [r.stats for r in ref]
    assert core.admission_log == jcore.admission_log
    assert all(len(r.outputs) == len(p) + TOKENS for r, p in zip(out, PROMPTS))


def test_sampled_streams_and_logprobs_equal_reference(weights):
    jp, tp = weights["qwen-small"]
    opts = dict(temperature=0.8, top_p=0.9, top_k=50, seed=3, logprobs=True)
    jcore = JaxEngineCore(JaxLMRunner(jax_base.ArchConfig(**QWEN), jp, max_seq=SEQ),
                          JaxEngineConfig(slots=3, prefill_chunk=4))
    ref = _serve(jcore, PROMPTS, **opts)
    out = _serve(_port_core(QWEN, tp, prefill_chunk=4), PROMPTS, **opts)
    assert [r.outputs for r in out] == [r.outputs for r in ref]
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.stats["logprobs"], b.stats["logprobs"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("opts", [{}, dict(temperature=0.8, top_p=0.9, seed=0)],
                         ids=["greedy", "sampled"])
def test_speculative_serving_is_bit_identical_to_plain(weights, opts):
    _, tp = weights["qwen-small"]
    prompts = PROMPTS + (REPETITIVE,)
    plain = _serve(_port_core(QWEN, tp, prefill_chunk=4), prompts, **opts)
    core = _port_core(QWEN, tp, speculate_k=4, prefill_chunk=4)
    spec = _serve(core, prompts, **opts)
    assert [r.outputs for r in spec] == [r.outputs for r in plain]
    assert core.stats()["drafted_tokens"] > 0
    for r in spec:
        s = r.stats
        assert s["accepted_tokens"] + s["rejected_tokens"] == s["drafted_tokens"]


def test_mid_stream_admission_equals_solo_serving(weights):
    _, tp = weights["gqa-small"]
    batch = _serve(_port_core(GQA, tp, slots=2, prefill_chunk=4), PROMPTS)
    for prompt, res in zip(PROMPTS, batch):
        solo = _serve(_port_core(GQA, tp, slots=1, prefill_chunk=4), [prompt])[0]
        assert solo.outputs == res.outputs


def test_cancelled_slot_is_reset_for_its_next_occupant(weights):
    _, tp = weights["qwen-small"]
    runner = LMRunner(ArchConfig(**QWEN), tp, max_seq=SEQ, device="cpu")
    sess = runner.open_session(2)
    sess.admit(0, Request(0, REPETITIVE, {"max_new_tokens": TOKENS}))
    for _ in range(3):
        sess.step(StepBudget(chunk=4))
    assert sess.cancel(0).status == "cancelled"
    sess.admit(0, Request(1, PROMPTS[3], {"max_new_tokens": TOKENS}))
    done = {}
    while not done:
        done = sess.step(StepBudget(chunk=4)).finished
    solo = _serve(_port_core(QWEN, tp, slots=2, prefill_chunk=4), [PROMPTS[3]])[0]
    assert done[0].outputs == solo.outputs
    # the fresh tree was only ever read
    for leaf, _ in tf._leaves(sess._fresh):
        assert not leaf.any()


class _WrongDrafts:
    """Drafts the token after the last one, k times: mostly rejected."""

    def propose(self, history, k):
        return [(history[-1] + 1) % QWEN["vocab"]] * k


def test_rollback_leaves_the_plain_sessions_cache(weights):
    _, tp = weights["qwen-small"]
    caches, outputs = [], []
    for k in (0, 4):
        runner = LMRunner(ArchConfig(**QWEN), tp, max_seq=SEQ, device="cpu", speculate_k=k,
                          proposer=_WrongDrafts())
        sess = runner.open_session(1)
        sess.admit(0, Request(0, REPETITIVE, {"max_new_tokens": TOKENS}))
        done = {}
        while not done:
            done = sess.step(StepBudget(chunk=4)).finished
        caches.append([leaf for leaf, _ in tf._leaves(sess.cache)])
        outputs.append(done[0].outputs)
        if k:
            assert done[0].stats["rejected_tokens"] > 0
    assert outputs[0] == outputs[1]
    for a, b in zip(*caches):
        assert torch.equal(a, b)


def test_batch_path_is_greedy_only_and_speculation_needs_kv_rollback(weights):
    _, tp = weights["qwen-small"]
    runner = LMRunner(ArchConfig(**QWEN), tp, max_seq=SEQ, device="cpu")
    with pytest.raises(ValueError, match="greedy-only"):
        runner.run([Request(0, [1, 2], {"max_new_tokens": 2, "temperature": 0.5})])
    local = ArchConfig(**dict(QWEN, pattern=("local_attn",), window=4))
    with pytest.raises(AssertionError, match="roll back"):
        LMRunner(local, tp, max_seq=SEQ, device="cpu", speculate_k=2)


def test_cli_serves_lm_on_cpu(capsys):
    cli.main(["--workload", "lm", "--device", "cpu", "--prefill-chunk", "4",
              "--speculate", "4", "--temperature", "0.8", "--top-p", "0.95", "--seed", "7",
              "--tokens", "6"])
    out = capsys.readouterr().out
    assert sum(line.startswith("req") for line in out.splitlines()) == 4
    assert "'requests_done': 4" in out and "'decode_tokens': 24" in out


@pytest.mark.parametrize("flags,message", [
    (["--speculate", "2", "--admission", "batch"], "need --admission continuous"),
    (["--workload", "snn", "--temperature", "0.5"], "LM-only")])
def test_cli_applies_the_reference_flag_rules(flags, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(flags + ["--device", "cpu"])


@pytest.mark.parametrize("module,args", [
    ("repro_torch.launch.serve", ["--workload", "lm", "--tokens", "4", "--int4"]),
    ("repro_torch.launch.serve_lm_w4", ["--tokens", "4"])])
def test_entry_points_exit_zero_on_cpu(module, args):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-m", module, *args, "--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "req" in out.stdout or "int4_matmul kernel" in out.stdout


def test_serve_lm_w4_kernel_output_matches_the_reference_example(capsys):
    res = serve_lm_w4.main(["--device", "cpu", "--tokens", "3"])
    cfg = res["cfg"]
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (2, 64, 257)
    assert all(len(s) == 3 for bits in (0, 4) for s in res["streams"][bits])
    # the example's operands, through the JAX kernel in interpret mode
    w = np.random.default_rng(0).normal(size=(cfg.d_model, cfg.vocab - 1)).astype("float32")
    x = np.random.default_rng(1).normal(size=(4, cfg.d_model)).astype("float32")
    ref = jax_w4a16(jnp.asarray(x), jax_quantize_int4(jnp.asarray(w[:, :256])), interpret=True)
    np.testing.assert_allclose(res["y"].numpy(), np.asarray(ref), rtol=1e-4, atol=1e-3)
    assert "int4_matmul kernel: x(4, 64) @ packed(64, 128) -> (4, 256)" in capsys.readouterr().out
