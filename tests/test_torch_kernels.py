"""The port's kernel modules against the JAX kernels, and each CUDA kernel
against its plain PyTorch version.

CPU tests hand the same numpy inputs (made from a seed) to the JAX kernels
in interpret mode and to the port's wrappers on CPU tensors, which take the
plain versions. The hand kernels themselves are compared with their plain
versions on the card in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dense_conv_lif import ops as jax_dense
from repro.kernels.lif_step.ops import lif_epilogue as jax_lif_epilogue
from repro.kernels.spike_conv import ops as jax_sc
from repro.kernels.spike_conv.ref import im2col as jax_im2col
from repro_torch.kernels import CUDA_LAUNCHES, _build
from repro_torch.kernels.dense_conv_lif import ops as dense_ops
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.spike_conv import ops as sc_ops
from repro_torch.kernels.spike_conv.ref import im2col

BETA, THETA = 0.15, 0.5


def _spikes(seed, shape, density=0.1):
    return (np.random.default_rng(seed).random(shape) < density).astype(np.float32)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _assert_stats_equal(st, ref):
    assert set(st) == set(ref)
    for k, v in ref.items():
        a, b = np.asarray(v), st[k].numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, (k, b.dtype, a.dtype)
        np.testing.assert_array_equal(b, a, err_msg=k)


# ---------------------------------------------------------------------------
# im2col / occupancy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_im2col_exact(padding):
    x = _normal(0, (2, 7, 5, 3))
    ref = np.asarray(jax_im2col(jnp.asarray(x), 3, 3, padding))
    np.testing.assert_array_equal(im2col(torch.from_numpy(x), 3, 3, padding).numpy(), ref)


def test_occupancy_map_matches_reference():
    p = np.zeros((512, 256), np.float32)
    p[0, 0] = p[300, 200] = 1.0
    ref = np.asarray(jax_sc.occupancy_map(jnp.asarray(p), 256, 128))
    out = sc_ops.occupancy_map(torch.from_numpy(p), 256, 128).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == np.int32


# ---------------------------------------------------------------------------
# spike_conv2d_mapped
# ---------------------------------------------------------------------------

def _both_mapped(spikes, w, **kw):
    ref_out, ref_st = jax_sc.spike_conv2d_mapped(jnp.asarray(spikes), jnp.asarray(w),
                                                 interpret=True, **kw)
    out, st = sc_ops.spike_conv2d_mapped(torch.from_numpy(spikes), torch.from_numpy(w), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    _assert_stats_equal(st, ref_st)
    return out, st


@pytest.mark.parametrize("shape,cout,kw", [
    ((4, 16, 16, 8), 12, dict(block_m=128)),
    ((4, 8, 8, 12), 16, dict(block_m=128, block_k=128, block_n=128)),
    ((3, 6, 6, 16), 16, dict(block_m=256)),                 # M not a tile multiple
    ((2, 16, 16, 8), 12, dict(block_m=128, gate=False)),
])
def test_spike_conv2d_mapped_matches_reference(shape, cout, kw):
    spikes = _spikes(1, shape)
    spikes[0] = 0.0                                          # a silent image
    w = _normal(2, (3, 3, shape[-1], cout))
    _both_mapped(spikes, w, **kw)


def test_known_empty_tiles_report_expected_skip_rate():
    """Image 0 all-zero, image 1 all-one: its 256 im2col rows fill exactly
    two 128-row tiles, so the occupancy map must skip exactly half."""
    spikes = np.concatenate([np.zeros((1, 16, 16, 8), np.float32),
                             np.ones((1, 16, 16, 8), np.float32)])
    out, st = _both_mapped(spikes, _normal(3, (3, 3, 8, 16)), block_m=128)
    assert float(st["tiles_total"]) == 4.0
    assert float(st["tiles_occupied"]) == 2.0
    assert float(st["skip_rate"]) == 0.5
    assert float(out[0].abs().max()) == 0.0


def test_all_empty_input_skips_everything():
    spikes = np.zeros((1, 16, 16, 8), np.float32)
    out, st = _both_mapped(spikes, _normal(4, (3, 3, 8, 16)))
    assert float(st["skip_rate"]) == 1.0
    assert float(out.abs().max()) == 0.0


def test_mapped_wrapper_counts_calls_not_cuda_launches():
    sc_ops.reset_launch_counts()
    before = dict(CUDA_LAUNCHES)
    sc_ops.spike_conv2d_mapped(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 8))
    assert sc_ops.launch_counts() == {"spike_matmul_mapped": 1}
    assert dict(CUDA_LAUNCHES) == before                   # the plain path ran


def test_build_covers_every_counted_kernel():
    assert sorted(p.name for p in _build.sources()) == [
        "dense_conv_lif.cu", "lif_epilogue_scan.cu", "spike_matmul_mapped.cu"]
    assert set(CUDA_LAUNCHES) == {p.stem for p in _build.sources()}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_failure_carries_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()
    assert not list((tmp_path / "build").rglob(_build.LIB_NAME))


def test_cuda_operand_checks_refuse_host_tensors():
    with pytest.raises(ValueError, match="not a CUDA device"):
        _build.check_cuda_operands("k", x=torch.zeros(4))


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty((128, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sc_ops.spike_matmul_mapped(meta, meta, block_m=128, block_k=128)
    with pytest.raises(ValueError, match="no kernel"):
        lif_ops.lif_epilogue_scan(torch.empty((2, 4, 8), device="meta"),
                                  torch.empty((8,), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        dense_ops.dense_conv_lif(torch.empty((8, 27), device="meta"),
                                 torch.empty((27, 8), device="meta"),
                                 torch.empty((8,), device="meta"),
                                 num_steps=2, beta=BETA, theta=THETA)


# ---------------------------------------------------------------------------
# LIF epilogue
# ---------------------------------------------------------------------------

def test_lif_epilogue_step_bit_exact():
    u, cur = _normal(5, (96, 40)), _normal(6, (96, 40))
    s = _spikes(7, (96, 40), 0.3)
    b = _normal(8, (40,), 0.1)
    ju, js = jax_lif_epilogue(*map(jnp.asarray, (u, cur, s, b)), beta=BETA, theta=THETA,
                              interpret=True)
    tu, ts = lif_ops.lif_epilogue(*map(torch.from_numpy, (u, cur, s, b)),
                                  beta=BETA, theta=THETA)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("steps,rows,n", [(2, 64, 24), (4, 37, 130)])
def test_lif_epilogue_scan_matches_lax_scan(steps, rows, n):
    cur = _normal(9, (steps, rows, n), 0.6)
    b = _normal(10, (n,), 0.1)
    bias = jnp.asarray(b)

    def step(carry, c):
        u, s = jax_lif_epilogue(carry[0], c, carry[1], bias, beta=BETA, theta=THETA,
                                interpret=True)
        return (u, s), s

    zeros = jnp.zeros((rows, n), jnp.float32)
    _, ref = jax.lax.scan(step, (zeros, zeros), jnp.asarray(cur))
    out = lif_ops.lif_epilogue_scan(torch.from_numpy(cur), torch.from_numpy(b),
                                    beta=BETA, theta=THETA)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# Dense core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hw,cout,blocks", [(2, 16, 8, (256, 128)), (3, 5, 64, (128, 128))])
def test_input_layer_conv_lif_matches_reference(b, hw, cout, blocks):
    img = np.random.default_rng(11).random((b, hw, hw, 3)).astype(np.float32)
    w = _normal(12, (3, 3, 3, cout), 0.5)
    bias = _normal(13, (cout,), 0.1)
    block_m, block_n = blocks
    jax_dense.reset_launch_counts()
    dense_ops.reset_launch_counts()
    js, ju = jax_dense.input_layer_conv_lif(
        *map(jnp.asarray, (img, w, bias)), num_steps=2, beta=BETA, theta=THETA,
        block_m=block_m, block_n=block_n, interpret=True)
    ts, tu = dense_ops.input_layer_conv_lif(
        *map(torch.from_numpy, (img, w, bias)), num_steps=2, beta=BETA, theta=THETA,
        block_m=block_m, block_n=block_n)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-5)
    assert dense_ops.LAUNCH_LOG == jax_dense.LAUNCH_LOG
    assert dense_ops.launch_counts() == jax_dense.launch_counts() == {"dense_conv_lif": 1}
