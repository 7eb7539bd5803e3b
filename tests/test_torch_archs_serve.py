"""Every registered LM architecture served by the port against the JAX package, on the CPU.

The archs are reduced and initialized as in `tests/test_torch_archs.py`
(its helpers). Served greedy streams must be equal token for token: through
`EngineCore` + `LMRunner` at 2 slots with re-admission (so a freed slot's
recurrent state is reset for its next occupant), and through
`launch/serve_lm_w4.py` against the JAX example `examples/serve_lm_w4.py`
run on the same weights.
"""
import ast
import dataclasses
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest

from repro.models import transformer as jax_tf
from repro.serve.api import EngineConfig as JaxEngineConfig
from repro.serve.core import EngineCore as JaxEngineCore
from repro.serve.runners.lm import LMRunner as JaxLMRunner
from repro_torch import configs
from repro_torch.launch import serve_lm_w4
from repro_torch.models import transformer as tf
from repro_torch.serve.api import EngineConfig
from repro_torch.serve.core import EngineCore
from repro_torch.serve.runners.lm import LMRunner
from test_torch_archs import ARCHS, SEQ, model  # noqa: F401  (the fixture)

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "serve_lm_w4.py")
PROMPTS = ([1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2, 1], [], [12, 13, 14, 15], [5])


def _serve(core, prompts):
    ids = [core.submit(list(p), max_new_tokens=4) for p in prompts]
    results = core.run_until_complete()
    return [results[i] for i in ids]


def test_greedy_streams_with_readmission_equal_reference(model):
    """2 slots, 5 requests: freed slots are re-admitted, so recurrent state
    must be reset for each next occupant."""
    jcfg, cfg, jp, tp = model
    jcore = JaxEngineCore(JaxLMRunner(jcfg, jp, max_seq=SEQ),
                          JaxEngineConfig(slots=2, prefill_chunk=4))
    core = EngineCore(LMRunner(cfg, tp, max_seq=SEQ, device="cpu"),
                      EngineConfig(slots=2, prefill_chunk=4))
    ref, out = _serve(jcore, PROMPTS), _serve(core, PROMPTS)
    assert [r.outputs for r in out] == [r.outputs for r in ref]
    assert core.admission_log == jcore.admission_log
    assert all(len(r.outputs) == len(p) + 4 for r, p in zip(out, PROMPTS))


def _reference_example(arch, monkeypatch, capsys):
    """Run examples/serve_lm_w4.py (JAX) for ``arch``; returns its config,
    its parameter tree and the streams it prints."""
    seen = {}
    init = jax_tf.init_params

    def spy(key, cfg):
        seen["cfg"], seen["params"] = cfg, init(key, cfg)
        return seen["params"]
    monkeypatch.setattr(jax_tf, "init_params", spy)
    monkeypatch.setattr(sys, "argv", ["serve_lm_w4.py", "--arch", arch, "--tokens", "3"])
    spec = importlib.util.spec_from_file_location("reference_serve_lm_w4", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main()
    monkeypatch.setattr(jax_tf, "init_params", init)
    streams = {}
    for line in capsys.readouterr().out.splitlines():
        for bits, tag in ((0, "w16: "), (4, "w4: ")):
            if line.strip().startswith(tag):
                streams[bits] = ast.literal_eval(line.strip()[len(tag):])
    return seen["cfg"], seen["params"], streams


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_w4_streams_equal_the_reference_example(arch, monkeypatch, capsys):
    ref_cfg, ref_params, ref_streams = _reference_example(arch, monkeypatch, capsys)
    assert dataclasses.asdict(serve_lm_w4.example_cfg(arch)) == dataclasses.asdict(ref_cfg)
    carried = tf.params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    monkeypatch.setattr(tf, "init_params", lambda gen, cfg, device: carried)
    res = serve_lm_w4.main(["--device", "cpu", "--arch", arch, "--tokens", "3"])
    assert res["streams"] == ref_streams and set(ref_streams) == {0, 4}
    full = serve_lm_w4.example_cfg(arch, full=True)
    base = configs.get_arch(arch)
    assert (full.d_model, full.d_ff, full.moe_d_ff, full.d_rnn, full.vocab, full.n_heads) == \
        (base.d_model, base.d_ff, base.moe_d_ff, base.d_rnn, base.vocab, base.n_heads)
    assert full.n_experts == (8 if base.n_experts else 0) and full.n_layers == 2 * len(base.pattern)
