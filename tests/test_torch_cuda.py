"""The port's hand CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips (in a fixture) where there is
no CUDA device. This file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bars: the gated matmul's occupancy maps exactly equal and currents within
1e-4 * max(1, max|ref|) (0/1 inputs make every product exact; only the
order of the fp32 sum differs); the LIF epilogue bit-identical; the dense
core's u within 1e-5 and its spikes equal wherever u is clear of theta.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import vgg9_snn
from repro_torch.kernels import CUDA_LAUNCHES, reset_cuda_launches
from repro_torch.kernels.dense_conv_lif import ops as dense_ops
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.spike_conv import ops as sc_ops
from repro_torch.models import vgg9

BETA, THETA = 0.15, 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spikes(seed, shape, density=0.1):
    return torch.from_numpy(
        (np.random.default_rng(seed).random(shape) < density).astype(np.float32))


def _normal(seed, shape, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,block_m", [(16384, 640, 128, 128), (1024, 4608, 640, 128),
                                           (512, 256, 128, 256)])
def test_spike_matmul_mapped_matches_plain(cuda, m, k, n, block_m):
    patches = _spikes(14, (m, k)).to(cuda)
    patches[:block_m] = 0.0                                  # an all-zero tile row
    w2d = _normal(15, (k, n)).to(cuda)
    before = CUDA_LAUNCHES["spike_matmul_mapped"]
    out, occ, row_occ = sc_ops.spike_matmul_mapped(patches, w2d, block_m=block_m,
                                                   block_k=128)
    torch.cuda.synchronize()
    assert CUDA_LAUNCHES["spike_matmul_mapped"] == before + 1
    ref, ref_occ, ref_row = sc_ops.spike_matmul_mapped_plain(patches, w2d,
                                                             block_m=block_m, block_k=128)
    assert torch.equal(occ, ref_occ) and torch.equal(row_occ, ref_row)
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert out[:block_m].abs().max().item() == 0.0


@pytest.mark.cuda
def test_spike_conv2d_mapped_stats_match_cpu(cuda):
    spikes = _spikes(21, (4, 16, 16, 24))
    spikes[1] = 0.0
    w = _normal(22, (3, 3, 24, 40))
    out, st = sc_ops.spike_conv2d_mapped(spikes.to(cuda), w.to(cuda), block_m=128)
    ref, ref_st = sc_ops.spike_conv2d_mapped(spikes, w, block_m=128)
    assert (out.cpu() - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    for key, v in ref_st.items():
        assert torch.equal(st[key].cpu(), v), key


@pytest.mark.cuda
@pytest.mark.parametrize("steps,rows,n", [(2, 8192, 112), (2, 8, 1064), (3, 100, 37)])
def test_lif_epilogue_scan_bit_identical(cuda, steps, rows, n):
    cur = _normal(16, (steps, rows, n), 0.6).to(cuda)
    bias = _normal(17, (n,), 0.1).to(cuda)
    out = lif_ops.lif_epilogue_scan(cur, bias, beta=BETA, theta=THETA)
    ref = lif_ops.lif_epilogue_scan_plain(cur, bias, beta=BETA, theta=THETA)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_dense_conv_lif_matches_plain(cuda):
    patches = torch.from_numpy(np.random.default_rng(18).random((8192, 27))
                               .astype(np.float32)).to(cuda)
    w2d = _normal(19, (27, 64), 0.3).to(cuda)
    bias = _normal(20, (64,), 0.1).to(cuda)
    s, u = dense_ops.dense_conv_lif(patches, w2d, bias, num_steps=2, beta=BETA, theta=THETA)
    rs, ru = dense_ops.dense_conv_lif_plain(patches, w2d, bias, num_steps=2,
                                            beta=BETA, theta=THETA)
    assert (u - ru).abs().max().item() <= 1e-5
    for t in range(2):                   # spikes agree wherever u_t is clear of theta
        _, u_t = dense_ops.dense_conv_lif_plain(patches, w2d, bias, num_steps=t + 1,
                                                beta=BETA, theta=THETA)
        clear = (u_t - THETA).abs() > 1e-5
        assert torch.equal(s[t][clear], rs[t][clear])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["TINY", "TINY_INT4"])
def test_pipeline_matches_cpu(cuda, name):
    """The card's pipeline (three hand kernels) against the CPU's plain one."""
    cfg = getattr(vgg9_snn, name)
    params = vgg9.init_vgg9(torch.Generator().manual_seed(0), cfg, "cpu")
    imgs = torch.rand((4, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    imgs[1] = 0.0
    cpu = vgg9.vgg9_infer_hybrid(params, imgs, cfg, device="cpu", return_stats=True)
    gpu_params = {k: {kk: v.to(cuda) for kk, v in leaf.items()} for k, leaf in params.items()}
    reset_cuda_launches()
    gpu = vgg9.vgg9_infer_hybrid(gpu_params, imgs, cfg, device="cuda", return_stats=True)
    assert dict(CUDA_LAUNCHES) == {"dense_conv_lif": 1, "spike_matmul_mapped": 3,
                                   "lif_epilogue_scan": 5}
    assert (gpu[0].cpu() - cpu[0]).abs().max().item() <= 1e-5
    for k in cpu[1]:
        assert int(gpu[1][k]) == int(cpu[1][k]), k
    for layer, st in cpu[2].items():
        for key, v in st.items():
            assert torch.equal(gpu[2][layer][key].cpu(), v), (layer, key)
