"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Skips without a CUDA device.  Imports neither JAX nor the JAX package, so
it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from amcontrast3d_tpu_torch import ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


def _cloud(rng, b, n, clustered):
    if not clustered:
        return (rng.rand(b, n, 3) * 4).astype(np.float32)
    centres = rng.rand(b, 16, 3) * 4
    pts = np.take_along_axis(centres, rng.randint(0, 16, (b, n))[..., None], 1)
    return (pts + 0.05 * rng.randn(b, n, 3)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("clustered", [False, True])
def test_kernels_match_plain(cuda_device, clustered):
    rng = np.random.RandomState(12)
    xyz = torch.from_numpy(_cloud(rng, 4, 6000, clustered)).to(cuda_device)
    idx = ops.furthest_point_sample(xyz, 1500)
    np.testing.assert_array_equal(
        idx.cpu().numpy(), ops.furthest_point_sample_plain(xyz, 1500).cpu().numpy())
    q = ops.gather_points(xyz, idx).contiguous()
    for r, k in ((0.2, 32), (0.4, 32), (1.6, 40)):
        np.testing.assert_array_equal(
            ops.ball_query(xyz, q, r, k).cpu().numpy(),
            ops.ball_query_plain(xyz, q, r, k).cpu().numpy())
    for c in (3, 96, 200):      # C below, at and above the block width
        f = torch.from_numpy(rng.randn(4, 1500, c).astype(np.float32)).to(cuda_device)
        got = ops.three_interpolation(xyz, q, f)
        want = ops.three_interpolation_plain(xyz, q, f)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * (1 + want.abs().max().item())


@pytest.mark.cuda
def test_kernels_small_and_ragged(cuda_device):
    """k > N, fewer queries than a block, and N not a multiple of a tile."""
    rng = np.random.RandomState(13)
    sup = torch.from_numpy(_cloud(rng, 2, 4, False)).to(cuda_device)
    np.testing.assert_array_equal(
        ops.ball_query(sup, sup, 1.6, 32).cpu().numpy(),
        ops.ball_query_plain(sup, sup, 1.6, 32).cpu().numpy())
    xyz = torch.from_numpy(_cloud(rng, 3, 1030, False)).to(cuda_device)
    np.testing.assert_array_equal(
        ops.furthest_point_sample(xyz, 257).cpu().numpy(),
        ops.furthest_point_sample_plain(xyz, 257).cpu().numpy())
    q = xyz[:, :5].contiguous()
    f = torch.from_numpy(rng.randn(3, 5, 7).astype(np.float32)).to(cuda_device)
    got = ops.three_interpolation(xyz, q, f)
    want = ops.three_interpolation_plain(xyz, q, f)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * (1 + want.abs().max().item())
