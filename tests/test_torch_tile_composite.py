"""Port tile composites (K2 camera, K4 lidar) against the JAX package.

The plain PyTorch versions run here; the JAX side runs the Pallas kernels in
interpret mode (`_run_fwd`, `run_lidar_fwd`), as tests/ops/test_pallas_composite.py
does, at <= 64 tiles. Both sides are fp32; the JAX kernels take the
transmittance product and the running sums in Hillis-Steele order, the plain
versions with cumprod/cumsum, so values agree to a few fp32 ulps of the
largest term: features/alpha to 1e-5 absolute, depths (tens of metres) to
1e-5 relative. The CUDA kernels are held against the plain versions on the
card in tests/test_torch_kernels_cuda.py (no JAX there, so it runs where the
card is).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.ops import gaussian_rasterize as JGR
from neurad_tpu.ops import gaussians as JG
from neurad_tpu.ops.pallas_composite import _run_fwd, run_lidar_fwd
from neurad_tpu_torch.ops import gaussian_rasterize as TGR
from neurad_tpu_torch.ops import gaussians as TG
from neurad_tpu_torch.ops import tile_composite as TC

torch.set_num_threads(1)

ATOL = 1e-5
RTOL_DEPTH = 1e-5


def _table(rng, n, c, centre, spread, con_scale):
    """Packed per-gaussian table [n, 10 + c] with positive-definite conics."""
    means = centre + rng.uniform(-spread, spread, (n, 2))
    vel = rng.normal(size=(n, 2)) * 3.0
    sx, sy = rng.uniform(0.5, 1.0, n) * con_scale, rng.uniform(0.5, 1.0, n) * con_scale
    rho = rng.uniform(-0.6, 0.6, n)
    det = (1 - rho**2) * sx**2 * sy**2
    conics = np.stack([sy**2 / det, -rho * sx * sy / det, sx**2 / det], -1)
    opac = rng.uniform(0.05, 0.99, n)
    depth = rng.uniform(2.0, 60.0, n)
    dvel = rng.normal(size=n) * 2.0
    feats = rng.uniform(size=(n, c))
    cols = [means, vel, conics, opac[:, None], depth[:, None], dvel[:, None], feats]
    return np.concatenate(cols, -1).astype(np.float32)


def _slots(rng, t, k, n, invalid_frac=0.25):
    tile_gauss = rng.integers(0, n, (t, k)).astype(np.int32)
    tile_valid = (rng.uniform(size=(t, k)) > invalid_frac).astype(np.float32)
    return tile_gauss, tile_valid


def _gathered(table, tile_gauss):
    g = table[tile_gauss]
    return g[..., 0:2], g[..., 2:4], g[..., 4:7], g[..., 7], g[..., 10:], g[..., 8], g[..., 9]


def _camera_case(seed=0, t=12, side=8, k=48, n=200, c=8):
    rng = np.random.default_rng(seed)
    table = _table(rng, n, c, centre=np.array([side * 2.0, side * 1.5]), spread=side * 2.5, con_scale=2.0)
    tile_gauss, tile_valid = _slots(rng, t, k, n)
    ntx = 4
    ty, tx = np.divmod(np.arange(t), ntx)
    py, px = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    local = np.stack([px.ravel() + 0.5, py.ravel() + 0.5], -1)
    pix = (np.stack([tx, ty], -1)[:, None, :] * side + local[None]).astype(np.float32)  # [T, P, 2]
    times = rng.uniform(-0.05, 0.05, (t, side * side, 1)).astype(np.float32)  # rolling shutter
    return table, tile_gauss, tile_valid, pix, times


def test_camera_plain_matches_pallas_fwd():
    table, tile_gauss, tile_valid, pix, times = _camera_case()
    means, vel, con, opac, feats, depth, dvel = _gathered(table, tile_gauss)
    jf, jd, ja = _run_fwd(
        jnp.asarray(pix), jnp.asarray(times), jnp.asarray(means), jnp.asarray(vel), jnp.asarray(con),
        jnp.asarray(opac[..., None]), jnp.asarray(feats), jnp.asarray(depth[..., None]),
        jnp.asarray(dvel[..., None]), jnp.asarray(tile_valid[..., None]),
    )
    tf, td, ta = TC.tile_composite_camera_plain(*map(torch.from_numpy, (table, tile_gauss, tile_valid, pix, times)))
    assert float(np.asarray(ja).max()) > 0.3, "the case must composite something"
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL_DEPTH, atol=ATOL)


def _lidar_case(seed, wrap, t=18, p=32, k=40, n=240, c=8):
    rng = np.random.default_rng(seed)
    # azimuths near the +-180 seam when wrapping, so the wrap changes numbers
    centre = np.array([175.0 if wrap else 0.0, -5.0])
    table = _table(rng, n, c, centre=centre, spread=12.0, con_scale=3.0)
    tile_gauss, tile_valid = _slots(rng, t, k, n)
    tile_valid[3] = 0.0  # a tile with no gaussians: zero accumulation, median from slot 0
    az = (centre[0] + rng.uniform(-15.0, 15.0, (t, p)) + 180.0) % 360.0 - 180.0
    el = centre[1] + rng.uniform(-12.0, 12.0, (t, p))
    gt = rng.uniform(2.0, 60.0, (t, p))
    tm = rng.uniform(-0.05, 0.05, (t, p))
    pts_slot = np.stack([az, el, gt, tm], -1).astype(np.float32)
    vmask = (rng.uniform(size=(t, p)) > 0.2).astype(np.float32)
    return table, tile_gauss, tile_valid, pts_slot, vmask


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("compute_until", [True, False])
def test_lidar_plain_matches_pallas_fwd(wrap, compute_until):
    table, tile_gauss, tile_valid, pts_slot, vmask = _lidar_case(1, wrap)
    means, vel, con, opac, feats, depth, dvel = _gathered(table, tile_gauss)
    jout = run_lidar_fwd(
        wrap, 0.4, compute_until, jnp.asarray(pts_slot), jnp.asarray(vmask), jnp.asarray(means),
        jnp.asarray(vel), jnp.asarray(con), jnp.asarray(opac), jnp.asarray(feats), jnp.asarray(depth),
        jnp.asarray(dvel), jnp.asarray(tile_valid),
    )
    tout = TC.tile_composite_lidar_plain(
        *map(torch.from_numpy, (table, tile_gauss, tile_valid, pts_slot, vmask)), wrap, 0.4, compute_until
    )
    jf, jd, jacc, ju, jmed = (np.asarray(x) for x in jout)
    tf, td, tacc, tu, tmed = (x.numpy() for x in tout)
    assert float(jacc.max()) > 0.3 and float(jacc[3].max()) == 0.0
    if compute_until:
        assert float(ju.max()) > 0.05
    np.testing.assert_allclose(tf, jf, atol=ATOL)
    np.testing.assert_allclose(tacc, jacc, atol=ATOL)
    np.testing.assert_allclose(tu, ju, atol=ATOL)
    np.testing.assert_allclose(td, jd, rtol=RTOL_DEPTH, atol=ATOL)
    # median: K4's relative-to-total crossing, slot 0's depth where acc == 0
    np.testing.assert_allclose(tmed, jmed, rtol=RTOL_DEPTH, atol=ATOL)
    np.testing.assert_allclose(tmed[3, :, 0], depth[3, 0] + dvel[3, 0] * pts_slot[3, :, 3], rtol=1e-6)


def test_wrap_is_jnp_mod():
    """The azimuth wrap is jnp.mod's floored modulo, including where
    torch.remainder rounds differently."""
    x = np.array([-540.5, -0.0, 359.99997, -1e-8, 725.0, -180.0, 179.99998], np.float32)
    got = TC.floored_mod(torch.from_numpy(x), 360.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.mod(jnp.asarray(x), 360.0)))


def test_wrappers_dispatch_cpu_to_plain_and_check_inputs():
    args = tuple(map(torch.from_numpy, _camera_case(seed=2, t=4, k=16, n=50)))
    before = TC.camera_launches
    for got, ref in zip(TC.tile_composite_camera(*args), TC.tile_composite_camera_plain(*args)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert TC.camera_launches == before, "no kernel launch on CPU tensors"
    table, tile_gauss, tile_valid, pix, times = args
    with pytest.raises(ValueError, match="float32"):
        TC.tile_composite_camera(table.double(), tile_gauss, tile_valid, pix, times)
    with pytest.raises(ValueError, match="int32"):
        TC.tile_composite_camera(table, tile_gauss.long(), tile_valid, pix, times)
    with pytest.raises(ValueError, match="shape"):
        TC.tile_composite_camera(table, tile_gauss, tile_valid, pix, times[:, :5])
    with pytest.raises(ValueError, match="contiguous"):
        TC.tile_composite_camera(table, tile_gauss, tile_valid, pix.transpose(0, 1).contiguous().transpose(0, 1),
                                 times)
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="cpu or cuda"):
        TC.tile_composite_camera(*meta)


def _projected_camera(seed, n=300, w=96, h=80):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(size=(n, 2)) * 4, rng.uniform(4, 30, (n, 1))], -1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 0.8, (n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1.0]], np.float32)
    c6 = JG.quat_scale_to_covar6(jnp.asarray(quats), jnp.asarray(scales))
    proj = JG.project_gaussians_camera(jnp.asarray(means), covar6=c6, viewmat=jnp.eye(4), K=jnp.asarray(K),
                                       width=w, height=h, velocities=jnp.asarray(vel))
    feats = rng.uniform(size=(n, 5)).astype(np.float32)
    opac = rng.uniform(0.1, 0.95, n).astype(np.float32)
    return proj, feats, opac


def _to_torch(proj):
    return TG.Projected(*(torch.from_numpy(np.array(x)) for x in proj))


def test_rasterize_camera_matches_jax_pallas():
    proj, feats, opac = _projected_camera(3)
    kw = dict(width=96, height=80, tile_size=16, max_per_tile=32, rolling_shutter_time=0.05)  # 6x5 tiles
    j = JGR.rasterize_camera(proj, jnp.asarray(feats), jnp.asarray(opac), backend="pallas", return_binning=True,
                             **kw)
    t = TGR.rasterize_camera(_to_torch(proj), torch.from_numpy(feats), torch.from_numpy(opac),
                             return_binning=True, **kw)
    assert int(j[3].dropped_pairs) > 0, "the per-tile cap must bind in this case"
    for name in ("dropped_pairs", "cropped_gaussians", "culled_visible"):
        assert int(getattr(t[3], name)) == int(getattr(j[3], name)), name
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=ATOL)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), atol=ATOL)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=RTOL_DEPTH, atol=1e-4)


def test_rasterize_lidar_tiled_matches_jax_pallas():
    rng = np.random.default_rng(4)
    n, m = 400, 1500
    means = (rng.normal(size=(n, 3)) * np.array([12.0, 12.0, 2.0])).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.1, 1.5, (n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    c6 = JG.quat_scale_to_covar6(jnp.asarray(quats), jnp.asarray(scales))
    proj = JG.project_gaussians_lidar(jnp.asarray(means), covar6=c6, viewmat=jnp.eye(4), velocities=jnp.asarray(vel))
    feats = rng.uniform(size=(n, 6)).astype(np.float32)
    opac = rng.uniform(0.1, 0.95, n).astype(np.float32)
    pts = np.stack([rng.uniform(-180, 180, m), rng.uniform(-25, 15, m), rng.uniform(2, 30, m),
                    rng.uniform(-0.05, 0.05, m)], -1).astype(np.float32)
    # 18 x 3 = 54 tiles keeps JAX on the Pallas kernel (it switches to XLA above 64)
    kw = dict(elev_range=(-26.0, 16.0), tile_size_azim=20.0, tile_size_elev=14.0, max_per_tile=24,
              pts_per_tile=32)
    j = JGR.rasterize_lidar_points_tiled(proj, jnp.asarray(feats), jnp.asarray(opac), jnp.asarray(pts),
                                         backend="pallas", **kw)
    t = TGR.rasterize_lidar_points_tiled(_to_torch(proj), torch.from_numpy(feats), torch.from_numpy(opac),
                                         torch.from_numpy(pts), **kw)
    assert int(j["points_overflowed"]) > 0 and int(j["binning_dropped_pairs"]) > 0, "caps must bind"
    for key in ("points_overflowed", "binning_dropped_pairs", "binning_cropped_gaussians"):
        assert int(t[key]) == int(j[key]), key
    for key in ("features", "alpha", "alpha_sum_until_points"):
        np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), atol=ATOL, err_msg=key)
    for key in ("depth", "median_depth"):
        np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), rtol=RTOL_DEPTH, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("backend", ["hybrid", "xla"])
def test_xla_backends_raise_on_the_cpu(backend):
    """JAX computes a bf16 XLA composite for "hybrid" and "xla"; the port has
    only the fp32 Pallas composite, so both entry points refuse them on the
    CPU, as on CUDA, rather than compute another function."""
    proj, feats, opac = _projected_camera(5, n=50)
    args = (_to_torch(proj), torch.from_numpy(feats), torch.from_numpy(opac))
    with pytest.raises(NotImplementedError, match="not ported"):
        TGR.rasterize_camera(*args, width=96, height=80, backend=backend)
    with pytest.raises(NotImplementedError, match="not ported"):
        TGR.rasterize_lidar_points_tiled(*args, torch.zeros((16, 4)), backend=backend)
    with pytest.raises(ValueError, match="unknown rasterize backend"):
        TGR.rasterize_camera(*args, width=96, height=80, backend=backend + "_tpu")
