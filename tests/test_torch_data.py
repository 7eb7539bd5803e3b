"""The port's data path (`data/synthetic.py::token_batch`, `data/pipeline.py`)
against the JAX package's, on the CPU.

The two packages' generators differ, so `token_batch` is held to the
reference's construction and properties rather than its numbers: shapes,
range, a pure function of (seed, step), labels the tokens shifted by one,
each row an affine walk with stride in [1, 7) up to 5 % uniform noise.
`DataPipeline` yields the reference pipeline's (step, batch) sequence for
the same ``make_batch``, prefetches at most its bound ahead, stops its
thread when the consumer closes it, and places batches on ``device``.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataPipeline as JaxDataPipeline
from repro.data.synthetic import token_batch as jax_token_batch
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import token_batch

CASES = [(0, 0, 4, 16, 97), (1, 5, 8, 128, 512), (7, 3, 2, 64, 49408)]


@pytest.mark.parametrize("seed,step,batch,seq,vocab", CASES)
def test_token_batch_shapes_and_range_as_the_reference(seed, step, batch, seq, vocab):
    ours = token_batch(seed, step, batch, seq, vocab)
    ref = jax_token_batch(seed, step, batch, seq, vocab)
    for key in ("tokens", "labels"):
        assert tuple(ours[key].shape) == ref[key].shape == (batch, seq)
        assert ours[key].dtype == torch.int64
        assert 0 <= int(ours[key].min()) and int(ours[key].max()) < vocab


@pytest.mark.parametrize("seed,step,batch,seq,vocab", CASES)
def test_token_batch_is_keyed_by_seed_and_step(seed, step, batch, seq, vocab):
    a, b = (token_batch(seed, step, batch, seq, vocab) for _ in range(2))
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(token_batch(seed, step + 1, batch, seq, vocab)["tokens"], a["tokens"])
    assert not torch.equal(token_batch(seed + 1, step, batch, seq, vocab)["tokens"], a["tokens"])


@pytest.mark.parametrize("seed,step,batch,seq,vocab", CASES)
def test_labels_are_the_next_tokens(seed, step, batch, seq, vocab):
    b = token_batch(seed, step, batch, seq, vocab)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("make", [token_batch, jax_token_batch], ids=["port", "reference"])
def test_rows_are_noisy_affine_walks(make):
    """In both packages: each row's most common step is its stride, in
    [1, 7), and about 5 % of positions are noise (a noisy position breaks
    at most two steps)."""
    seq, vocab = 512, 4099
    b = make(3, 2, 16, seq, vocab)
    stream = np.concatenate([np.asarray(b["tokens"]), np.asarray(b["labels"])[:, -1:]], axis=1)
    steps = (stream[:, 1:] - stream[:, :-1]) % vocab
    for row in steps:
        stride = np.bincount(row).argmax()
        assert 1 <= stride < 7
        broken = float(np.mean(row != stride))
        assert broken < 0.2, broken


def _make(step):
    return {"v": torch.tensor(step), "x": torch.full((3,), float(step))}


def test_pipeline_order_equals_the_reference():
    it, ref = DataPipeline(_make, prefetch=2)(start_step=3), \
        JaxDataPipeline(lambda s: {"v": jnp.asarray(s)}, prefetch=2)(start_step=3)
    got = [next(it) for _ in range(5)]
    want = [next(ref) for _ in range(5)]
    it.close()
    ref.close()
    assert [s for s, _ in got] == [s for s, _ in want] == [3, 4, 5, 6, 7]
    assert [int(b["v"]) for _, b in got] == [int(b["v"]) for _, b in want]
    assert all(torch.equal(b["x"], torch.full((3,), float(s))) for s, b in got)


def test_pipeline_prefetches_ahead_and_no_further():
    made = []
    pipe = DataPipeline(lambda s: made.append(s) or _make(s), prefetch=2)
    it = pipe(start_step=0)
    assert next(it)[0] == 0
    deadline = time.monotonic() + 5
    while len(made) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    # one batch consumed, two queued, one made and waiting for a free slot
    assert made == [0, 1, 2, 3]
    it.close()


def test_pipeline_stops_its_thread_when_closed():
    before = set(threading.enumerate())
    made = []
    it = DataPipeline(lambda s: made.append(s) or _make(s), prefetch=2)(start_step=0)
    next(it)
    started = [t for t in threading.enumerate() if t not in before]
    assert len(started) == 1 and started[0].is_alive()
    it.close()
    assert not started[0].is_alive()
    n = len(made)
    time.sleep(0.6)
    assert len(made) == n


def test_pipeline_raises_the_producers_error():
    def make(step):
        if step == 2:
            raise ValueError("bad step")
        return _make(step)
    it = DataPipeline(make)(start_step=0)
    assert [next(it)[0] for _ in range(2)] == [0, 1]
    with pytest.raises(ValueError, match="bad step"):
        next(it)


def test_pipeline_places_batches_on_its_device():
    batch = _make(0)
    it = DataPipeline(lambda s: batch)(start_step=0)
    _, same = next(it)
    it.close()
    assert same is batch                       # no device: left where it was made
    it = DataPipeline(lambda s: _make(s), device="cpu")(start_step=4)
    step, placed = next(it)
    it.close()
    assert step == 4 and placed["x"].device.type == "cpu" and int(placed["v"]) == 4


def test_pipeline_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DataPipeline(_make, device="cuda")
