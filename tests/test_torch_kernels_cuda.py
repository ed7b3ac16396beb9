"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (skips elsewhere: a CUDA kernel has no CPU mode) and no
JAX, so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance: both sides are fp32 and take the alpha gate identically; the
kernel sums serially where the plain version uses cumprod/einsum, so values
agree to 1e-4 absolute (features, alpha, depths of tens of metres: 1e-4
relative). The lidar median compares equal except where a running weight sum
lies within rounding of the half-way mark, which these inputs avoid.
"""

import numpy as np
import pytest
import torch

from neurad_tpu_torch.ops import tile_composite as TC

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(seed, t, p, k, n, c, lidar):
    rng = np.random.default_rng(seed)
    centre = np.array([175.0, 0.0]) if lidar else np.array([20.0, 20.0])
    spread = 20.0
    means = centre + rng.uniform(-spread, spread, (n, 2))
    vel = rng.normal(size=(n, 2))
    s = rng.uniform(1.0, 4.0, (n, 2))
    conics = np.stack([1 / s[:, 0] ** 2, rng.uniform(-0.2, 0.2, n) / (s[:, 0] * s[:, 1]), 1 / s[:, 1] ** 2], -1)
    cols = [means, vel, conics, rng.uniform(0.05, 0.99, (n, 1)), rng.uniform(2, 60, (n, 1)),
            rng.normal(size=(n, 1)), rng.uniform(size=(n, c))]
    table = np.concatenate(cols, -1).astype(np.float32)
    tile_gauss = rng.integers(-3, n + 3, (t, k)).astype(np.int32)  # out-of-range entries are clamped
    tile_valid = (rng.uniform(size=(t, k)) > 0.2).astype(np.float32)
    xy = centre + rng.uniform(-spread, spread, (t, p, 2))
    if lidar:
        xy[..., 0] = (xy[..., 0] + 180.0) % 360.0 - 180.0
        pts = np.concatenate([xy, rng.uniform(2, 60, (t, p, 1)), rng.uniform(-0.05, 0.05, (t, p, 1))], -1)
        vmask = (rng.uniform(size=(t, p)) > 0.3).astype(np.float32)
        arrays = (table, tile_gauss, tile_valid, pts.astype(np.float32), vmask)
    else:
        times = rng.uniform(-0.05, 0.05, (t, p, 1)).astype(np.float32)
        arrays = (table, tile_gauss, tile_valid, xy.astype(np.float32), times)
    return [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 16, 32])
@pytest.mark.parametrize("k", [40, 300])
def test_camera_kernel_matches_plain(cuda, c, k):
    args = _inputs(0, t=20, p=100, k=k, n=500, c=c, lidar=False)
    before = TC.camera_launches
    got = TC.tile_composite_camera(*args)
    torch.cuda.synchronize()
    assert TC.camera_launches == before + 1
    for g, r in zip(got, TC.tile_composite_camera_plain(*args)):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 16, 32])
@pytest.mark.parametrize("k", [40, 300])
@pytest.mark.parametrize("wrap", [True, False])
def test_lidar_kernel_matches_plain(cuda, c, k, wrap):
    args = _inputs(1, t=20, p=100, k=k, n=500, c=c, lidar=True)
    before = TC.lidar_launches
    got = TC.tile_composite_lidar(*args, wrap, 0.4, True)
    torch.cuda.synchronize()
    assert TC.lidar_launches == before + 1
    for g, r in zip(got, TC.tile_composite_lidar_plain(*args, wrap, 0.4, True)):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda):
    args = _inputs(2, t=2, p=32, k=8, n=20, c=4, lidar=False)
    args[0] = args[0].cpu()
    with pytest.raises(ValueError, match="several devices"):
        TC.tile_composite_camera(*args)
