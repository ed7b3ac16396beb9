"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (skips elsewhere: a CUDA kernel has no CPU mode) and no
JAX, so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance: both sides are fp32 and take the alpha gate identically; the
kernel sums serially where the plain version uses cumprod/einsum, so values
agree to 1e-4 absolute (features, alpha, depths of tens of metres: 1e-4
relative). The lidar median compares equal except where a running weight sum
lies within rounding of the half-way mark, which these inputs avoid.

The backward kernels (K3, K5) are reached through the autograd functions and
held against the plain backward versions. They sum a tile's pixels by warp
shuffles and atomics (an order that changes from run to run) where the plain
version uses einsum/cumsum, and divide by 1 - alpha >= 0.001, so each entry
of the table's gradient is held to BWD_TOL times the sum of the absolute
values of its per-pixel terms (the plain version's `magnitude`): a row with a
small gradient is held as tightly as one with a large gradient.
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
@pytest.mark.parametrize("c", [8, 16, 32])
def test_camera_kernel_on_gated_tiles_and_the_image_edge(cuda, c):
    """K2 (two pixels a thread, warps that skip slots whose alpha is zero for
    all their pixels) on tiles binned from projected gaussians: the image's
    last tile row half outside it (height 40), one tile whose 256 slots are
    all valid and all gate to zero (a gaussian far from its pixels), C = 8, 16
    and 32."""
    from neurad_tpu_torch.ops import gaussians as G
    from neurad_tpu_torch.ops.gaussian_rasterize import camera_tile_inputs

    width, height, n = 96, 40, 3000
    rng = np.random.default_rng(20 + c)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).cuda()
    means = rng.normal(size=(n, 3)) * np.array([3.0, 1.5, 2.0]) + np.array([0.0, 0.0, 8.0])
    covar6 = G.quat_scale_to_covar6(t(rng.normal(size=(n, 4))), t(np.exp(rng.uniform(-4.0, -1.0, size=(n, 3)))))
    K = torch.tensor([[0.7 * width, 0, width / 2], [0, 0.7 * width, height / 2], [0, 0, 1.0]], device="cuda")
    proj = G.project_gaussians_camera(t(means), covar6, torch.eye(4, device="cuda"), K, width, height,
                                      velocities=t(rng.normal(size=(n, 3))))
    binning, table, tile_valid, pix, times = camera_tile_inputs(
        proj, t(rng.uniform(size=(n, c))), t(rng.uniform(0.05, 0.99, n)), width, height, tile_size=16,
        max_per_tile=256, rolling_shutter_time=0.03)
    tile_gauss = binning.tile_gauss
    assert pix.shape[1:] == (256, 2) and bool((pix[..., 1] > height).any()), "the last tile row leaves the image"
    # tile 0: every slot valid, all on one gaussian far to the right of its pixels
    far = table[:1].clone()
    far[0, 0:2] = torch.tensor([500.0, 8.0])
    table = torch.cat([table, far])
    tile_gauss[0] = table.shape[0] - 1
    tile_valid[0] = 1.0
    args = (table.contiguous(), tile_gauss.contiguous(), tile_valid.contiguous(), pix, times)
    assert float((tile_valid[1:] > 0).float().mean()) > 0.05
    before = TC.camera_launches
    got = TC.tile_composite_camera(*args)
    torch.cuda.synchronize()
    assert TC.camera_launches == before + 1
    want = TC.tile_composite_camera_plain(*args)
    assert float(want[2].max()) > 0.5, "the picture is not empty"
    assert all(float(g[0].abs().max()) == 0.0 for g in got), "a tile gated to zero composites nothing"
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda):
    args = _inputs(2, t=2, p=32, k=8, n=20, c=4, lidar=False)
    args[0] = args[0].cpu()
    with pytest.raises(ValueError, match="several devices"):
        TC.tile_composite_camera(*args)


def _cotangents(seed, t, p, c, n_extra):
    rng = np.random.default_rng(seed)
    shapes = [(t, p, c)] + [(t, p, 1)] * n_extra
    cots = [rng.normal(size=shape).astype(np.float32) for shape in shapes]
    for x in cots:
        x[-1] = 0.0  # a tile outside the image: zero cotangents
    return [torch.from_numpy(x).cuda() for x in cots]


BWD_TOL = 1e-5


def _assert_columns_close(got, plain_fn):
    want, magnitude = plain_fn(), plain_fn(magnitude=True)
    assert bool(torch.isfinite(got).all())
    assert bool((want.abs().amax(dim=0) > 0).all()), "every column must get a gradient"
    ratio = float(((got - want).abs() / magnitude.clamp_min(1e-30)).max())
    print(f"largest error over the sum of an entry's absolute terms: {ratio:.2e}")
    assert ratio <= BWD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 16, 32])
@pytest.mark.parametrize("k,p", [(40, 100), (300, 100), (40, 300)])
def test_camera_bwd_kernel_matches_plain(cuda, c, k, p):
    args = _inputs(3, t=20, p=p, k=k, n=500, c=c, lidar=False)
    cots = _cotangents(4, 20, p, c, 2)
    table = args[0].clone().requires_grad_(True)
    before = (TC.camera_launches, TC.camera_bwd_launches)
    outs = TC.tile_composite_camera(table, *args[1:])
    (got,) = torch.autograd.grad(outs, table, cots)
    torch.cuda.synchronize()
    assert (TC.camera_launches, TC.camera_bwd_launches) == (before[0] + 1, before[1] + 1)
    _assert_columns_close(got, lambda **kw: TC.tile_composite_camera_bwd_plain(*args, *cots, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [40, 300])
def test_camera_bwd_kernel_on_opaque_empty_and_masked_tiles(cuda, k):
    """K3 takes G from the forward's outputs: held against the plain backward
    that sums G itself, at P = 256 (300 slots: three rounds of the stage), on
    a near-opaque tile (every pixel's alpha above 0.99), a tile whose slots
    all lie far from its pixels (alpha 0 everywhere) and a tile whose slots
    are all invalid."""
    t, p, n, c = 20, 256, 500, 16
    args = _inputs(7, t=t, p=p, k=k, n=n, c=c, lidar=False)
    table, tile_gauss, tile_valid, pix, times = args
    rng = np.random.default_rng(8)
    front = np.zeros((16, table.shape[1]), np.float32)  # wide, dense, in front of every other slot
    front[:, 0:2] = pix[0].mean(0).cpu().numpy() + 0.37 + rng.uniform(-0.5, 0.5, (16, 2))
    front[:, 4] = front[:, 6] = 1.0 / 30.0**2
    front[:, 7] = rng.uniform(0.85, 0.95, 16)
    front[:, 8] = np.linspace(1.0, 1.9, 16)
    front[:, 10:] = rng.uniform(size=(16, c))
    # tiles 1 and 2 get rows of their own (copies of others), so that what they add shows
    own = torch.arange(n + 16, n + 16 + 2 * k, dtype=torch.int32, device="cuda").reshape(2, k)
    table = torch.cat([table, torch.from_numpy(front).cuda(), table[tile_gauss[1:3].clamp(0, n - 1).long().reshape(-1)]])
    tile_gauss[0, :16] = torch.arange(n, n + 16, dtype=torch.int32, device="cuda")
    tile_valid[0, :16] = 1.0
    tile_gauss[1:3] = own
    pix[1] = pix[1] + 1e4  # tile 1: no slot reaches its pixels
    tile_valid[2] = 0.0  # tile 2: every slot invalid
    args = [table, tile_gauss, tile_valid, pix, times]
    cots = _cotangents(9, t, p, c, 2)
    leaf = table.clone().requires_grad_(True)
    outs = TC.tile_composite_camera(leaf, *args[1:])
    acc = outs[2].detach()
    assert float(acc[0].min()) > 0.99 and float(acc[1].abs().max()) == 0.0 and float(acc[2].max()) == 0.0
    (got,) = torch.autograd.grad(outs, leaf, cots)
    torch.cuda.synchronize()
    _assert_columns_close(got, lambda **kw: TC.tile_composite_camera_bwd_plain(*args, *cots, **kw))
    assert float(got[n + 16:].abs().max()) == 0.0, "the empty and the masked tile add nothing"


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 16, 32])
@pytest.mark.parametrize("k", [40, 300])
@pytest.mark.parametrize("wrap", [True, False])
def test_lidar_bwd_kernel_matches_plain(cuda, c, k, wrap):
    args = _inputs(5, t=20, p=100, k=k, n=500, c=c, lidar=True)
    cots = _cotangents(6, 20, 100, c, 3)
    table = args[0].clone().requires_grad_(True)
    before = (TC.lidar_launches, TC.lidar_bwd_launches)
    outs = TC.tile_composite_lidar(table, *args[1:], wrap, 0.4, True)
    assert not outs[4].requires_grad
    (got,) = torch.autograd.grad(outs[:4], table, cots)
    torch.cuda.synchronize()
    assert (TC.lidar_launches, TC.lidar_bwd_launches) == (before[0] + 1, before[1] + 1)
    _assert_columns_close(got, lambda **kw: TC.tile_composite_lidar_bwd_plain(*args, wrap, 0.4, *cots, **kw))


def _lidar_layout_inputs(seed, k, c):
    """The main path's layout (`lidar_tile_inputs`): valid gaussian and query
    slots fill each tile from slot 0 up, the query slots to about 14% of P =
    128 (18 of them). Beside those: tile 1 holds 70 valid query slots at random
    places (three rounds of 32), tile 2 none, and tile 3's queries lie far
    from every gaussian with its raw slot 0 invalid (every weight sum 0: the
    median is raw slot 0's depth)."""
    t, p, n = 8, 128, 500
    table, tile_gauss, tile_valid, pts, vmask = _inputs(seed, t=t, p=p, k=k, n=n, c=c, lidar=True)
    rng = np.random.default_rng(seed + 1)
    tile_gauss = tile_gauss.clamp(0, n - 1)
    counts = rng.integers(k // 2, k + 1, t)
    tile_valid = (torch.arange(k)[None, :] < torch.from_numpy(counts)[:, None]).float().cuda()
    vmask = torch.zeros((t, p), device="cuda")
    vmask[:, :18] = 1.0
    vmask[1] = 0.0
    vmask[1, torch.from_numpy(rng.choice(p, 70, replace=False)).cuda()] = 1.0
    vmask[2] = 0.0
    tile_valid[3, 0] = 0.0
    pts[3, :, 0] = -5.0  # 150 degrees and more from every gaussian (azimuths 155 .. 195)
    return [table, tile_gauss.contiguous(), tile_valid, pts.contiguous(), vmask]


@pytest.mark.cuda
@pytest.mark.parametrize("compute_until", [True, False])
@pytest.mark.parametrize("c", [3, 16, 32])
@pytest.mark.parametrize("k", [40, 300])
def test_lidar_kernels_on_the_main_paths_layout(cuda, k, c, compute_until):
    """K4 and K5 (a warp a tile over its compacted query slots, in rounds of
    32) against their plain versions: prefix-filled slots at 14% query
    occupancy, a tile with more than 32 valid query slots, one with none, one
    whose weights all sum to zero over an invalid raw slot 0, K above one stage
    chunk of 32, C = 3, 16, 32; without the line-of-sight sum the caller gets
    zeros for it while its cotangent still enters the gradient; two K5
    launches agree within the atomics' order."""
    args = _lidar_layout_inputs(11, k, c)
    table, tile_gauss, tile_valid, pts, vmask = args
    got = TC.tile_composite_lidar(*args, True, 0.4, compute_until)
    want = TC.tile_composite_lidar_plain(*args, True, 0.4, compute_until)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
    feat, depth, acc, until, med = got
    assert float(acc[0].max()) > 0.0 and float(acc[1].max()) > 0.0, "the tiles composite something"
    assert float(acc[2].abs().max()) == 0.0 and float(acc[3].abs().max()) == 0.0
    slot0 = table[tile_gauss[:, 0].long()]
    depth0 = slot0[:, None, 8:9] + slot0[:, None, 9:10] * pts[..., 3:4]
    assert torch.equal(med[2:4], depth0[2:4]), "where the weights sum to zero the median is raw slot 0's depth"
    masked = vmask == 0
    assert torch.equal(med[masked], depth0[masked]) and float(feat[masked].abs().max()) == 0.0
    if not compute_until:
        assert float(until.abs().max()) == 0.0

    cots = _cotangents(12, 8, 128, c, 3)
    leaf = table.clone().requires_grad_(True)
    outs = TC.tile_composite_lidar(leaf, tile_gauss, tile_valid, pts, vmask, True, 0.4, compute_until)
    before = TC.lidar_bwd_launches
    (grad,) = torch.autograd.grad(outs[:4], leaf, cots, retain_graph=True)
    (again,) = torch.autograd.grad(outs[:4], leaf, cots)
    torch.cuda.synchronize()
    assert TC.lidar_bwd_launches == before + 2
    plain = lambda **kw: TC.tile_composite_lidar_bwd_plain(*args, True, 0.4, *cots, **kw)
    _assert_columns_close(grad, plain)
    ratio = float(((grad - again).abs() / plain(magnitude=True).clamp_min(1e-30)).max())
    assert ratio <= BWD_TOL, f"two K5 launches differ by {ratio:.2e} of an entry's terms' magnitude"


# ---------------------------------------------------------------------------
# hash-grid lookup (K1 forward) and the gather probes (P1, P2, P5): gathers and
# fixed-order sums without atomics, so the kernels are held to the plain
# versions bit for bit, in the fp32 and the bf16 read mode alike.
# ---------------------------------------------------------------------------

from neurad_tpu_torch.benchmarks import gather_microbench as GM  # noqa: E402
from neurad_tpu_torch.ops import hash_encoding as HE  # noqa: E402


def _grid(d, f, cell_packed, force_hash, seed, levels=4, max_rows=2**12):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scales = HE.level_scales(levels, 4, 96 if d == 3 else 24)
    _, dense, packs = HE.level_layout(scales, d, max_rows, cell_packed, force_hash)
    tables = HE.init_hash_tables(gen, scales, d, max_rows, f, scale=1.0, cell_packed=cell_packed,
                                 force_hash=force_hash)
    return scales, dense, packs, tables, gen


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 4])
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("cell_packed", [True, False])
@pytest.mark.parametrize("read_bf16", [True, False])
def test_hash_grid_kernel_equals_plain(cuda, d, f, cell_packed, read_bf16):
    scales, dense, packs, tables, gen = _grid(d, f, cell_packed, False, seed=d * 10 + f)
    assert any(r is not None for r in dense) and any(r is None for r in dense), "dense and hashed levels"
    n = 5000
    pos = torch.rand((n, d), generator=gen, device="cuda")
    pos[:64] = torch.round(pos[:64] * 8) / 8  # on cell faces of the coarse levels
    pos[64:72] = torch.tensor([0.0, 1.0] * 4, device="cuda")[:, None]  # the box's faces
    std = torch.rand((n,), generator=gen, device="cuda") * 0.05
    buckets = [t.shape[0] * pk for t, pk in zip(tables, packs)]
    args = (tables, [float(s) for s in scales], buckets, dense, f, read_bf16, cell_packed)
    for stds in (std, None):
        before = HE.hash_grid_launches
        got = HE.hash_grid_encode(pos, stds, *args)
        torch.cuda.synchronize()
        assert HE.hash_grid_launches == before + 1
        want = HE.hash_grid_encode_plain(pos, stds, *args)
        assert got.shape == want.shape == (n, len(tables) * f)
        assert bool(want.abs().max() > 0)
        assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_hash_grid_kernel_bucket_packing_and_legacy_array(cuda):
    # a level above 2^18 buckets is stored two buckets a row; the lookup addresses the logical bucket
    gen = torch.Generator(device="cuda").manual_seed(3)
    scales = np.array([16.0, 300.0], np.float32)
    _, dense, packs = HE.level_layout(scales, 3, 2**19, True)
    assert packs == (1, 2) and dense == (17, None)
    tables = HE.init_hash_tables(gen, scales, 3, 2**19, 4, scale=1.0, cell_packed=True)
    assert tables[1].shape == (2**18, 64)
    pos = torch.rand((4096, 1, 3), generator=gen, device="cuda")
    std = torch.full((4096, 1, 1), 0.002, device="cuda")
    got = HE.hash_encode_gaussians(pos, std, tables, scales, cell_packed=True, dense_res=dense, bucket_pack=packs)
    want = HE.hash_grid_encode_plain(pos.reshape(-1, 3), std.reshape(-1), tables, [16.0, 300.0], [17**3, 2**19], dense,
                                     4, True, True)
    assert torch.equal(got, want)
    # the legacy layout: one array for all levels, hashed, a row per corner
    table = HE.init_hash_table(gen, 3, 1024, 2, scale=1.0)
    scales = HE.level_scales(3, 8, 64)
    got = HE.hash_encode(pos[:, 0], table, scales, table_size=1024, gather_dtype=None)
    want = HE.hash_grid_encode_plain(pos[:, 0], None, [table[i * 1024:(i + 1) * 1024] for i in range(3)],
                                     [float(s) for s in scales], [1024] * 3, [None] * 3, 2, False, False)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_hash_grid_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    scales, dense, packs, tables, gen = _grid(3, 4, True, False, seed=1)
    buckets = [t.shape[0] * pk for t, pk in zip(tables, packs)]
    args = ([float(s) for s in scales], buckets, dense, 4, True, True)
    pos = torch.rand((16, 3), device="cuda")
    with pytest.raises(ValueError, match="device"):
        HE.hash_grid_encode(pos, None, [t.cpu() for t in tables], *args)
    with pytest.raises(ValueError, match="float32"):
        HE.hash_grid_encode(pos.double(), None, tables, *args)
    leaf = [t.clone().requires_grad_(True) for t in tables]
    with torch.no_grad():
        assert HE.hash_grid_encode(pos, None, leaf, *args).shape == (16, 16)
    # under grad the lookup is the autograd function: forward and backward kernel, no plain fallback
    before = (HE.hash_grid_launches, HE.hash_grid_bwd_launches)
    out = HE.hash_grid_encode(pos, None, leaf, *args)
    assert out.requires_grad
    out.sum().backward()
    torch.cuda.synchronize()
    assert (HE.hash_grid_launches, HE.hash_grid_bwd_launches) == (before[0] + 1, before[1] + 1)
    assert all(t.grad is not None and t.grad.device.type == "cuda" for t in leaf)
    with pytest.raises(ValueError, match="g must be"):
        HE.hash_grid_encode_bwd(pos, None, tables, *args, torch.zeros((16, 16), device="cuda").double())


# the lookup's read modes: (bf16 reads, from the bf16 copy)
HASH_MODES = {"bf16_copy": (True, True), "bf16_master": (True, False), "fp32": (False, False)}


def _lookup_positions(gen, kind, n, d, scale0):
    """Positions as a chunk's rays give them (32 samples a ray along a
    segment of the unit cube, ray-major, sorted along it; D = 4: one actor
    coordinate a ray), all in one cell of the coarsest level (every lane of a
    warp on one row there), or uniform with N not a multiple of 32."""
    if kind == "rays":
        rays = n // 32
        a = torch.rand((rays, 1, 3), generator=gen, device="cuda")
        b = torch.rand((rays, 1, 3), generator=gen, device="cuda")
        pos = a + (b - a) * torch.rand((rays, 32, 1), generator=gen, device="cuda").sort(dim=1).values
        if d == 4:
            pos = torch.cat([pos, torch.rand((rays, 1, 1), generator=gen, device="cuda").expand(rays, 32, 1)], -1)
        return pos.reshape(-1, d).contiguous()
    if kind == "hot_cell":
        cell = torch.randint(0, int(scale0), (d,), generator=gen, device="cuda")
        return ((cell + torch.rand((n, d), generator=gen, device="cuda")) / scale0).contiguous()
    return torch.rand((n + 13, d), generator=gen, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(HASH_MODES))
@pytest.mark.parametrize("kind", ["rays", "hot_cell", "ragged"])
@pytest.mark.parametrize("d,cell_packed", [(3, True), (4, True), (3, False)], ids=["static", "actor", "unpacked"])
def test_hash_grid_kernel_on_rays_hot_cells_and_ragged_n(cuda, d, cell_packed, kind, mode):
    """K1f (a warp a level of 32 samples, one fetch a distinct row) where
    lanes share rows: ray-ordered positions, one hot cell, and a last block
    of 13 samples; every read mode; the D = 4 actor grid and the unpacked
    layout. Equal to the plain version on the fp32 master, bit for bit."""
    read_bf16, from_copy = HASH_MODES[mode]
    scales, dense, packs, tables, gen = _grid(d, 4, cell_packed, False, seed=40 + d)
    pos = _lookup_positions(gen, kind, 32 * 160, d, float(scales[0]))
    std = torch.rand((pos.shape[0],), generator=gen, device="cuda") * 0.05
    layout = ([float(s) for s in scales], [t.shape[0] * pk for t, pk in zip(tables, packs)], dense, 4, read_bf16,
              cell_packed)
    before = HE.hash_grid_launches
    with torch.no_grad():
        got = HE.hash_grid_encode(pos, std, tables, *layout, copies=HE.Bf16Copies() if from_copy else None)
    torch.cuda.synchronize()
    assert HE.hash_grid_launches == before + 1
    want = HE.hash_grid_encode_plain(pos, std, tables, *layout)
    assert bool(want.abs().max() > 0)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(HASH_MODES))
@pytest.mark.parametrize("levels,f", [(3, 1), (12, 4), (16, 2)])
def test_hash_grid_kernel_level_counts(cuda, levels, f, mode):
    """Blocks of two groups of 3 levels (an output row of 3 floats, copied out
    float by float), of 12 and of 16 levels (one warp a level)."""
    read_bf16, from_copy = HASH_MODES[mode]
    scales, dense, packs, tables, gen = _grid(3, f, True, False, seed=levels, levels=levels)
    pos = torch.rand((2000, 3), generator=gen, device="cuda")
    layout = ([float(s) for s in scales], [t.shape[0] * pk for t, pk in zip(tables, packs)], dense, f, read_bf16, True)
    with torch.no_grad():
        got = HE.hash_grid_encode(pos, None, tables, *layout, copies=HE.Bf16Copies() if from_copy else None)
    assert torch.equal(got, HE.hash_grid_encode_plain(pos, None, tables, *layout))


@pytest.mark.cuda
def test_hash_grid_wrapper_refuses_unaligned_cell_packed_tables(cuda):
    scales, dense, packs, tables, gen = _grid(3, 4, True, False, seed=2)
    shifted = torch.empty(tables[0].numel() + 1, device="cuda")[1:].view(tables[0].shape)
    shifted.copy_(tables[0])
    layout = ([float(s) for s in scales], [t.shape[0] * pk for t, pk in zip(tables, packs)], dense, 4, False, True)
    with pytest.raises(ValueError, match="16-byte boundary"):
        HE.hash_grid_encode(torch.rand((64, 3), device="cuda"), None, [shifted] + list(tables[1:]), *layout)


SPREADS = ["uniform", "one_bucket", "one_row"]


def _probe_indices(gen, n, t_rows, spread):
    """n int32 indices into t_rows rows: uniform (the last row among them),
    all in the table's last bucket of GM.BUCKET_ROWS rows (cut short where
    t_rows is not a multiple of it), or all one row."""
    if spread == "uniform":
        idx = torch.randint(0, t_rows, (n,), generator=gen, device="cuda", dtype=torch.int32)
        idx[:1] = t_rows - 1
    elif spread == "one_bucket":
        first = (t_rows - 1) // GM.BUCKET_ROWS * GM.BUCKET_ROWS
        idx = torch.randint(first, t_rows, (n,), generator=gen, device="cuda", dtype=torch.int32)
    else:
        idx = torch.full((n,), t_rows // 3, dtype=torch.int32, device="cuda")
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("t_rows,f", [(4096, 8), (4096, 16), (8192, 32), (1000, 32), (30000, 16)])
@pytest.mark.parametrize("n", [0, 1, 200, 4099])
@pytest.mark.parametrize("spread", SPREADS)
def test_gather_probes_equal_plain(cuda, t_rows, f, n, spread):
    gen = torch.Generator(device="cuda").manual_seed(n)
    table = torch.randn((t_rows, f), generator=gen, device="cuda").to(torch.bfloat16)
    idx = _probe_indices(gen, n, t_rows, spread)
    want = GM.gather_rows_plain(table, idx)
    before = (GM.coalesced_launches, GM.onehot_launches, GM.serial_launches)
    assert torch.equal(GM.gather_rows_coalesced(table, idx), want)
    assert torch.equal(GM.gather_rows_serial(table, idx), want)
    onehot = GM.gather_rows_onehot(table, idx)
    torch.cuda.synchronize()
    assert onehot.dtype == torch.float32 and torch.equal(onehot, want.float())
    assert (GM.coalesced_launches, GM.onehot_launches, GM.serial_launches) == tuple(b + (n > 0) for b in before)


@pytest.mark.cuda
@pytest.mark.parametrize("t_rows,f", GM.TABLE_SHAPES)
@pytest.mark.parametrize("n", [0, 1, 255, 257, 1 << 20])
def test_serial_gather_at_the_probe_shapes(cuda, t_rows, f, n):
    """P5 (a thread a row, a block's tile staged and written whole, a
    persistent grid that walks blocks of 256 queries) equals table[idx] bit
    for bit at every table shape of the probe run: no query, one, a block's
    ragged edge, and 2^20 (more blocks of queries than the grid holds), with
    indices at row 0 and row T - 1 among them."""
    gen = torch.Generator(device="cuda").manual_seed(n + t_rows)
    table = torch.randn((t_rows, f), generator=gen, device="cuda").to(torch.bfloat16)
    idx = torch.randint(0, t_rows, (n,), generator=gen, device="cuda", dtype=torch.int32)
    idx[: n // 2: 2] = 0
    idx[1: n // 2: 2] = t_rows - 1
    before = GM.serial_launches
    got = GM.gather_rows_serial(table, idx)
    torch.cuda.synchronize()
    assert got.shape == (n, f) and torch.equal(got, GM.gather_rows_plain(table, idx))
    assert GM.serial_launches == before + (n > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [24, 48, 64, 128])
def test_serial_gather_at_other_row_widths(cuda, f):
    """Rows of 3, 6, 8 and 16 pieces: one piece at a time, three passes of
    two, one pass of eight, two passes of eight."""
    gen = torch.Generator(device="cuda").manual_seed(f)
    table = torch.randn((3000, f), generator=gen, device="cuda").to(torch.bfloat16)
    idx = torch.randint(0, 3000, (70001,), generator=gen, device="cuda", dtype=torch.int32)
    idx[:2] = torch.tensor([0, 2999], dtype=torch.int32)
    assert torch.equal(GM.gather_rows_serial(table, idx), GM.gather_rows_plain(table, idx))


@pytest.mark.cuda
def test_gather_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    table = torch.zeros((64, 8), dtype=torch.bfloat16, device="cuda")
    idx = torch.zeros((4,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        GM.gather_rows_coalesced(table.float(), idx)
    with pytest.raises(ValueError, match="int32"):
        GM.gather_rows_serial(table, idx.long())
    with pytest.raises(ValueError, match="device"):
        GM.gather_rows_onehot(table, idx.cpu())
    with pytest.raises(ValueError, match="16 bytes"):
        GM.gather_rows_coalesced(torch.zeros((64, 4), dtype=torch.bfloat16, device="cuda"), idx)


# ---------------------------------------------------------------------------
# the lookup's backward (K1b) and the scatter-add probes (P3, P4, P6): sums in
# another order than the plain versions' (an order that atomics choose anew at
# every launch, or for P3 the fixed order of its sort and products), so each
# entry is held to BWD_TOL_SUM times the sum of the absolute values of its
# terms (the plain versions' `magnitude`); two launches of K1b, P4 or P6 may
# differ in the last bits, two of P3 may not.
# ---------------------------------------------------------------------------

BWD_TOL_SUM = 1e-5


def _close_to_terms(got, want, magnitude, what):
    if got is None or want is None:
        assert got is None and want is None, what
        return
    err = (got - want).abs()
    assert bool((err <= BWD_TOL_SUM * magnitude + 1e-30).all()), (what, float((err / (magnitude + 1e-30)).max()))


def _bwd_case(d, f, cell_packed, read_bf16, seed, force_hash=False, n=5000, levels=4, max_rows=2**12,
              positions="mixed"):
    """positions: "mixed" (random, on cell faces, on the box's faces, 128 in
    one point), "one_cell" (every position in one cell of the coarsest
    level) or "rays" (rays of 32 consecutive samples, a train chunk's order)."""
    scales, dense, packs, tables, gen = _grid(d, f, cell_packed, force_hash, seed, levels=levels, max_rows=max_rows)
    if positions == "one_cell":
        cell = torch.randint(0, int(scales[0]), (d,), generator=gen, device="cuda")
        pos = (cell + torch.rand((n, d), generator=gen, device="cuda")) / float(scales[0])
    elif positions == "rays":
        n_rays = -(-n // 32)
        direction = torch.randn((n_rays, 1, d), generator=gen, device="cuda")
        direction = direction / direction.norm(dim=-1, keepdim=True)
        t = torch.rand((n_rays, 32, 1), generator=gen, device="cuda").sort(dim=1).values * 0.3
        pos = (0.35 + 0.3 * torch.rand((n_rays, 1, d), generator=gen, device="cuda") + t * direction).reshape(-1, d)[:n]
    else:
        pos = torch.rand((n, d), generator=gen, device="cuda")
        pos[:64] = torch.round(pos[:64] * 8) / 8  # on cell faces of the coarse levels
        pos[64:72] = torch.tensor([0.0, 1.0] * 4, device="cuda")[:, None]  # the box's faces
        pos[72:200] = pos[72:73]  # one hot cell: many atomics on the same rows
    std = torch.rand((n,), generator=gen, device="cuda") * (4.0 / float(scales[0]))  # clamped and not
    g = torch.randn((n, len(tables) * f), generator=gen, device="cuda")
    buckets = [t.shape[0] * pk for t, pk in zip(tables, packs)]
    layout = ([float(s) for s in scales], buckets, dense, f, read_bf16, cell_packed)
    return pos, std, tables, layout, g


def _check_bwd(pos, std, tables, layout, g, **need):
    before = HE.hash_grid_bwd_launches
    got = HE.hash_grid_encode_bwd(pos, std, tables, *layout, g, **need)
    again = HE.hash_grid_encode_bwd(pos, std, tables, *layout, g, **need)
    torch.cuda.synchronize()
    assert HE.hash_grid_bwd_launches == before + 2
    want = HE.hash_grid_encode_bwd_plain(pos, std, tables, *layout, g, **need)
    mag = HE.hash_grid_encode_bwd_plain(pos, std, tables, *layout, g, magnitude=True, **need)
    for what, a, b, w, m in zip(("tables", "positions", "stds"), got, again, want, mag):
        if what == "tables":
            for l, (ta, tb, tw, tm) in enumerate(zip(a, b, w, m)):
                _close_to_terms(ta, tw, tm, f"table {l}")
                _close_to_terms(tb, tw, tm, f"table {l}, second launch")
                _close_to_terms(ta, tb, tm, f"table {l}, one launch against the other")
        else:
            _close_to_terms(a, w, m, what)
            # summed over the levels in level order, without atomics: the same bits at every launch
            assert (a is None and b is None) or torch.equal(a, b), f"{what}: two launches differ"
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 4])
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("cell_packed", [True, False])
@pytest.mark.parametrize("read_bf16", [True, False])
def test_hash_grid_bwd_kernel_matches_plain(cuda, d, f, cell_packed, read_bf16):
    pos, std, tables, layout, g = _bwd_case(d, f, cell_packed, read_bf16, seed=d * 10 + f)
    got, want = _check_bwd(pos, std, tables, layout, g)
    assert all(float(t.abs().max()) > 0 for t in want[0]) and float(want[1].abs().max()) > 0
    assert bool((want[2] == 0).any()) and bool((want[2] != 0).any()), "clamped and unclamped level weights"
    _check_bwd(pos, None, tables, layout, g)  # no level weight


@pytest.mark.cuda
@pytest.mark.parametrize("positions", ["one_cell", "rays"])
@pytest.mark.parametrize("d", [3, 4])
@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("cell_packed", [True, False])
@pytest.mark.parametrize("read_bf16", [True, False])
def test_hash_grid_bwd_kernel_on_hot_cells(cuda, positions, d, f, cell_packed, read_bf16):
    """The warps' pre-reduction of equal rows where it does the most: every
    position in one coarse cell, and rays of 32 samples; N = 4,999 leaves the
    last warp part-empty."""
    pos, std, tables, layout, g = _bwd_case(d, f, cell_packed, read_bf16, seed=100 + d * 10 + f, n=4999,
                                            positions=positions)
    got, want = _check_bwd(pos, std, tables, layout, g)
    assert float(want[1].abs().max()) > 0 and all(float(t.abs().max()) > 0 for t in want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("read_bf16", [True, False])
def test_hash_grid_bwd_kernel_packing_legacy_and_skipped_gradients(cuda, read_bf16):
    # a level stored two buckets a row (D = 3 and 4)
    for d in (3, 4):
        pos, std, tables, layout, g = _bwd_case(d, 1, True, read_bf16, seed=d, levels=2, max_rows=2**19)
        assert 2 in [t.shape[1] // (2**d) for t in tables]
        _check_bwd(pos, std, tables, layout, g)
    # the legacy single array: views into one array, one row per corner, hashed
    table = HE.init_hash_table(torch.Generator(device="cuda").manual_seed(5), 3, 1024, 2, scale=1.0)
    scales = HE.level_scales(3, 8, 64)
    views = [table[i * 1024:(i + 1) * 1024] for i in range(3)]
    layout = ([float(s) for s in scales], [1024] * 3, [None] * 3, 2, read_bf16, False)
    pos = torch.rand((3000, 3), device="cuda")
    g = torch.randn((3000, 6), device="cuda")
    _check_bwd(pos, None, views, layout, g)
    # gradients not asked for are skipped: no table gradient for level 0, no position gradient (no row re-read)
    pos, std, tables, layout, g = _bwd_case(3, 4, True, read_bf16, seed=7)
    got, _ = _check_bwd(pos, std, tables, layout, g, tables_grad=[False, True, True, True], positions_grad=False)
    assert got[0][0] is None and got[1] is None and got[2] is not None
    got, _ = _check_bwd(pos, std, tables, layout, g, positions_grad=False, stds_grad=False)
    assert got[1] is None and got[2] is None


@pytest.mark.cuda
def test_hash_grid_autograd_function_runs_both_kernels(cuda):
    pos, std, tables, layout, g = _bwd_case(3, 4, True, True, seed=11)
    leaf = [t.clone().requires_grad_(True) for t in tables]
    p = pos.clone().requires_grad_(True)
    s = std.clone().requires_grad_(True)
    before = (HE.hash_grid_launches, HE.hash_grid_bwd_launches)
    HE.hash_grid_encode(p, s, leaf, *layout).backward(g)
    torch.cuda.synchronize()
    assert (HE.hash_grid_launches, HE.hash_grid_bwd_launches) == (before[0] + 1, before[1] + 1)
    want = HE.hash_grid_encode_bwd_plain(pos, std, tables, *layout, g)
    mag = HE.hash_grid_encode_bwd_plain(pos, std, tables, *layout, g, magnitude=True)
    for t, w, m in zip(leaf, want[0], mag[0]):
        _close_to_terms(t.grad, w, m, "table")
    _close_to_terms(p.grad, want[1], mag[1], "positions")
    _close_to_terms(s.grad, want[2], mag[2], "stds")


@pytest.mark.cuda
@pytest.mark.parametrize("t_rows,f", [(4096, 8), (4096, 16), (8192, 32), (1000, 32), (30000, 8)])
@pytest.mark.parametrize("n", [0, 1, 200, 40099])
@pytest.mark.parametrize("spread", SPREADS)
def test_scatter_probes_match_plain(cuda, t_rows, f, n, spread):
    """The one-hot scatter has one owner per output row and no atomics: a
    second launch on the same inputs gives the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(n + f)
    idx = _probe_indices(gen, n, t_rows, spread)
    g = torch.randn((n, f), generator=gen, device="cuda")
    magnitude = GM.scatter_rows_plain(idx, g.abs(), t_rows)
    before = (GM.scatter_onehot_launches, GM.scatter_blocked_launches, GM.scatter_serial_launches)
    for fn, rounded in ((GM.scatter_rows_onehot, True), (GM.scatter_rows_blocked, False),
                        (GM.scatter_rows_serial, False)):
        got = fn(idx, g, t_rows)
        torch.cuda.synchronize()
        want = GM.scatter_rows_plain(idx, g, t_rows, round_bf16=rounded)
        assert got.dtype == torch.float32 and got.shape == (t_rows, f)
        _close_to_terms(got, want, magnitude, fn.__name__)
    assert (GM.scatter_onehot_launches, GM.scatter_blocked_launches, GM.scatter_serial_launches) == tuple(
        b + (n > 0) for b in before)
    first = GM.scatter_rows_onehot(idx, g, t_rows)
    assert torch.equal(GM.scatter_rows_onehot(idx, g, t_rows), first)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [8, 32])
@pytest.mark.parametrize("spread", SPREADS + ["skewed"])
def test_blocked_scatter_probe_where_spans_cut_buckets(cuda, f, spread):
    """The blocked scatter walks the sorted updates in spans of BLOCKED_SPAN:
    at 2,000 rows (16 buckets) 5 spans and a bit hold buckets that lie wholly
    inside a span (stored) and buckets cut by a span's edge (reduced); one
    bucket or one row is cut over six spans; the skewed indices put half the
    updates in one row. The serial scatter runs beside it."""
    t_rows, n = 2000, 5 * GM.BLOCKED_SPAN + 3
    gen = torch.Generator(device="cuda").manual_seed(f)
    idx = (GM.skewed_indices(n, t_rows, gen, "cuda") if spread == "skewed"
           else _probe_indices(gen, n, t_rows, spread))
    g = torch.randn((n, f), generator=gen, device="cuda")
    magnitude = GM.scatter_rows_plain(idx, g.abs(), t_rows)
    want = GM.scatter_rows_plain(idx, g, t_rows)
    for fn in (GM.scatter_rows_blocked, GM.scatter_rows_serial):
        got = fn(idx, g, t_rows)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (t_rows, f)
        _close_to_terms(got, want, magnitude, fn.__name__)
    if spread == "uniform":
        counts = torch.bincount(idx.long() // GM.BUCKET_ROWS, minlength=16).cpu()
        starts = torch.cumsum(counts, 0) - counts
        whole = (starts // GM.BLOCKED_SPAN) == ((starts + counts - 1) // GM.BLOCKED_SPAN)
        assert bool(whole.any()) and not bool(whole.all()), "some buckets whole in a span, some cut"


@pytest.mark.cuda
def test_scatter_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    idx = torch.zeros((4,), dtype=torch.int32, device="cuda")
    g = torch.zeros((4, 8), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        GM.scatter_rows_serial(idx, g.to(torch.bfloat16), 16)
    with pytest.raises(ValueError, match="int32"):
        GM.scatter_rows_blocked(idx.long(), g, 16)
    with pytest.raises(ValueError, match="device"):
        GM.scatter_rows_onehot(idx.cpu(), g, 16)
    with pytest.raises(ValueError, match="columns"):
        GM.scatter_rows_onehot(idx, torch.zeros((4, 4), device="cuda"), 16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        GM.scatter_rows_onehot(idx, torch.zeros((4 * 8 + 1,), device="cuda")[1:].view(4, 8), 16)
    with pytest.raises(ValueError, match="T <="):
        GM.scatter_rows_onehot(idx, g, 51200 * GM.BUCKET_ROWS + 1)
    # the blocked scatter: the bucketing pass's limits, its widths, 16-byte rows
    with pytest.raises(ValueError, match="T <="):
        GM.scatter_rows_blocked(idx, g, 51200 * GM.BUCKET_ROWS + 1)
    big = 1 << 25  # a sorted entry packs the update with its 7-bit row
    with pytest.raises(ValueError, match="N < 2\\^25"):
        GM.scatter_rows_blocked(torch.zeros((big,), dtype=torch.int32, device="cuda"),
                                torch.empty((big, 8), device="cuda"), 16)
    with pytest.raises(ValueError, match="columns"):
        GM.scatter_rows_blocked(idx, torch.zeros((4, 12), device="cuda"), 16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        GM.scatter_rows_blocked(idx, torch.zeros((4 * 8 + 1,), device="cuda")[1:].view(4, 8), 16)
    # the serial scatter: F a multiple of 4, 16-byte rows
    with pytest.raises(ValueError, match="multiple of 4"):
        GM.scatter_rows_serial(idx, torch.zeros((4, 6), device="cuda"), 16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        GM.scatter_rows_serial(idx, torch.zeros((4 * 8 + 1,), device="cuda")[1:].view(4, 8), 16)
    # what they do take: F = 12 for the serial scatter, one update
    out = GM.scatter_rows_serial(idx[:1] + 3, torch.ones((1, 12), device="cuda"), 16)
    assert float(out[3].sum()) == 12.0 and float(out.sum()) == 12.0


# ---------------------------------------------------------------------------
# eval metrics on the card: the metric functions compute where their inputs
# lie, and both pipelines' eval renders run the ported kernels
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_eval_metrics_on_cuda_tensors_stay_on_the_card(cuda, monkeypatch):
    """LPIPS (exact and VGG19 fallback), Inception pool3 and the chamfer
    distance on CUDA tensors return CUDA tensors, and no tensor is copied to
    the host on the way."""
    import math
    import warnings

    from neurad_tpu_torch.core.math_utils import chamfer_distance
    from neurad_tpu_torch.model_components import inception, lpips_exact
    from neurad_tpu_torch.model_components.perceptual import load_vgg19_params
    from neurad_tpu_torch.utils import eval_metrics as EM

    for env in ("NEURAD_TPU_LPIPS_WEIGHTS", "NEURAD_TPU_INCEPTION_WEIGHTS"):
        monkeypatch.delenv(env, raising=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    conv = lambda o, i, kh, kw: torch.randn((o, i, kh, kw), generator=gen, device="cuda") * math.sqrt(2 / (i * kh * kw))
    lp = {"convs": [(conv(o, i, 3, 3), torch.zeros(o, device="cuda")) for _, i, o in lpips_exact._VGG16_CONVS],
          "heads": [torch.rand(c, generator=gen, device="cuda") for c in lpips_exact._HEAD_CH]}
    inc = {name: (conv(o, i, *k), torch.zeros(o, device="cuda")) for name, i, o, k, _s, _p in inception.conv_specs()}
    vgg = load_vgg19_params(torch.Generator().manual_seed(0), device="cuda")
    a, b = (torch.rand((2, 64, 48, 3), generator=gen, device="cuda") for _ in range(2))
    pts, other = (torch.randn((n, 3), generator=gen, device="cuda") for n in (5000, 3000))

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was copied to the host")

    with monkeypatch.context() as m, warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the fallback's warning
        m.setattr(torch.Tensor, "cpu", refuse)
        m.setattr(torch.Tensor, "numpy", refuse)
        outs = [EM.lpips(vgg, a, b), lpips_exact.lpips_exact(lp, a, b), inception.inception_pool3(inc, a[:1]),
                chamfer_distance(pts, other, pts[:, 0] > 0, other[:, 1] > 0)]
    torch.cuda.synchronize()
    assert outs[2].shape == (1, 2048)
    assert all(o.device.type == "cuda" and bool(torch.isfinite(o).all()) for o in outs)


@pytest.mark.cuda
def test_both_pipelines_score_their_eval_split_on_the_card(cuda):
    """`eval_metrics` of the tiny presets on the card: finite values for the
    JAX package's keys, the eval renders through the tile composites and the
    hash-grid lookup."""
    import warnings

    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline

    outputs = SyntheticDataParserConfig(num_frames=8, train_split_fraction=0.75, image_height=72,
                                        image_width=96).setup().get_dataparser_outputs()
    c0, l0, h0 = TC.camera_launches, TC.lidar_launches, HE.hash_grid_launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the LPIPS and FID fallbacks' warning
        splat = SplatADPipeline(outputs, METHODS["splatad-tiny"]().pipeline, device="cuda")
        ms = splat.eval_metrics()
        fs = splat.eval_fid_suite(max_images=2)
        neurad = ADPipeline(outputs, METHODS["neurad-tiny"]().pipeline, device="cuda")
        mn = neurad.eval_metrics()
    assert set(ms) == {"psnr", "ssim", "depth_median_l2", "depth_mean_rel_l2"}
    always = set(ms) | {"lpips", "intensity_rmse", "ray_drop_accuracy", "chamfer_distance"}
    assert always <= set(mn) <= always | {"actor_psnr", "actor_coverage"}  # the actor's metrics where it is in view
    assert len(fs) == 5 and all(np.isfinite(v) for d in (ms, mn, fs) for v in d.values())
    assert TC.camera_launches - c0 >= 2 + 14 and TC.lidar_launches - l0 >= 2 and HE.hash_grid_launches > h0
