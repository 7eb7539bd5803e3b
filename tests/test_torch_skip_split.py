"""The runner's per-request occupancy split (`serve/runners/snn.py`) against
the per-slot host loop it replaced, kept here as the oracle.

`_split_occupancy` reduces each occupancy map on its own device to integer
counts and forms the rates on the host; the oracle gathers each request's
rows with a boolean mask and re-tiles them in numpy. The two must agree
with ``==``: the JAX-parity serving tests compare ``skip_rate`` and
``ts_occupancy`` exactly. This file imports neither JAX nor the JAX package;
its card case runs with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_skip_split.py
"""
import numpy as np
import pytest
import torch

from repro_torch.serve.runners.snn import _split_occupancy


def _oracle_skip(row_occ: np.ndarray, block_m: int, rows: int,
                 rows_per_slice: int, batch: int) -> np.ndarray:
    kt = row_occ.shape[1]
    owner = (np.arange(rows) // rows_per_slice) % batch
    skip = np.zeros(batch)
    for b in range(batch):
        rb = row_occ[:rows][owner == b]
        pad = (-len(rb)) % block_m
        if pad:
            rb = np.concatenate([rb, np.zeros((pad, kt), rb.dtype)])
        occ = rb.reshape(-1, block_m, kt).any(axis=1)
        skip[b] = 1.0 - occ.sum() / occ.size
    return skip


def _oracle_ts(row_occ: np.ndarray, rows: int, rows_per_slice: int,
               batch: int) -> np.ndarray:
    active = row_occ[:rows].any(axis=1).astype(np.float64)
    t = rows // (batch * rows_per_slice)
    return active.reshape(t, batch, rows_per_slice).mean(axis=2)


def _row_occ(seed, t, batch, rps, kt, extra_rows, density, silent_dense):
    """int8 [t*batch*rps + extra_rows, kt]; the pad rows past ``rows`` are
    all ones, so counting them would show."""
    rng = np.random.default_rng(seed)
    rows = t * batch * rps
    occ = (rng.random((rows + extra_rows, kt)) < density).astype(np.int8)
    occ[rows:] = 1
    if silent_dense:                      # request 0 silent, request 1 dense
        folded = occ[:rows].reshape(t, batch, rps, kt)
        folded[:, 0] = 0
        folded[:, 1] = 1
    return occ, rows


def _split(occ, rows, block_m, rps, batch, t, shards, device="cpu"):
    """The runner's split of ``occ``, as one map or cut into ``shards``
    per-shard maps the way `_run_sharded` hands them over."""
    if shards == 1:
        maps = [("l", torch.from_numpy(occ).to(device), rows, block_m, rps, 0)]
    else:
        b = batch // shards
        folded = occ[:rows].reshape(t, batch, rps, -1)
        maps = [("l", torch.from_numpy(np.ascontiguousarray(
                     folded[:, d * b:(d + 1) * b].reshape(t * b * rps, -1))).to(device),
                 t * b * rps, block_m, rps, d * b) for d in range(shards)]
    skip, ts = _split_occupancy(maps, batch, t)
    return skip["l"], ts["l"]


def _oracle(occ, rows, block_m, rps, batch, t, shards):
    if shards == 1:
        return (_oracle_skip(occ, block_m, rows, rps, batch),
                _oracle_ts(occ, rows, rps, batch))
    b = batch // shards
    folded = occ[:rows].reshape(t, batch, rps, -1)
    parts = [np.ascontiguousarray(folded[:, d * b:(d + 1) * b].reshape(t * b * rps, -1))
             for d in range(shards)]
    return (np.concatenate([_oracle_skip(p, block_m, t * b * rps, rps, b) for p in parts]),
            np.concatenate([_oracle_ts(p, t * b * rps, rps, b) for p in parts], axis=1))


CASES = {
    # (T, batch, rows_per_slice, block_m, k tiles, rows past `rows`, density, silent+dense, shards)
    "block_m_divides_rps": (2, 4, 256, 128, 3, 0, 0.004, False, 1),
    "tile_straddles_timesteps": (2, 6, 64, 128, 5, 0, 0.004, False, 1),
    "padding_needed": (3, 5, 100, 64, 4, 0, 0.01, False, 1),
    "pad_rows_do_not_count": (2, 3, 48, 128, 2, 80, 0.005, False, 1),
    "silent_next_to_dense": (2, 4, 64, 128, 3, 64, 0.005, True, 1),
    "batch_1": (2, 1, 1024, 128, 5, 0, 0.002, False, 1),
    "batch_256": (2, 256, 64, 128, 16, 0, 0.003, False, 1),
    "two_shards": (2, 8, 48, 128, 3, 0, 0.005, True, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_equals_per_slot_loop(case):
    t, batch, rps, block_m, kt, extra, density, silent_dense, shards = CASES[case]
    occ, rows = _row_occ(7, t, batch, rps, kt, extra, density, silent_dense)
    skip, ts = _split(occ, rows, block_m, rps, batch, t, shards)
    want_skip, want_ts = _oracle(occ, rows, block_m, rps, batch, t, shards)
    assert skip.dtype == ts.dtype == np.float64
    assert skip.shape == (batch,) and ts.shape == (t, batch)
    assert (skip == want_skip).all() and (ts == want_ts).all()
    assert ((0.0 < skip) & (skip < 1.0)).any()        # some requests skip some tiles
    if silent_dense:
        assert skip[0] == 1.0 and (ts[:, 0] == 0.0).all()
        assert skip[1] == 0.0 and (ts[:, 1] == 1.0).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rps,kt", [(1024, 5), (64, 36)])   # conv1 and conv6 at 256 slots
def test_split_on_card_equals_cpu(cuda, rps, kt):
    t, batch, block_m = 2, 256, 128
    occ, rows = _row_occ(11, t, batch, rps, kt, 0, 0.0005, True)
    got = _split(occ, rows, block_m, rps, batch, t, 1, device=cuda)
    cpu = _split(occ, rows, block_m, rps, batch, t, 1)
    want = _oracle(occ, rows, block_m, rps, batch, t, 1)
    for g, c, w in zip(got, cpu, want):
        assert (g == c).all() and (g == w).all()
