"""Port backward tile composites (K3 camera, K5 lidar) against the JAX package.

The plain PyTorch backward versions run here; the JAX side runs the fused
Pallas backward kernels in interpret mode (`_run_bwd`, `run_lidar_bwd`), whose
per-tile `[T, K, .]` gradients are scatter-added with numpy into the packed
table's layout `[N, 10 + C]`, which is what the port's backward returns.

Tolerance: both sides are fp32 and evaluate the same formula,
`dL/da_k = T_k g_k - (G - P_k) / (1 - a_k)`, but sum in other orders (the JAX
kernel's MXU contractions and loop-carried prefix, the plain version's
einsum/cumsum, numpy's scatter), and the division by `1 - a_k >= 0.001`
amplifies the rounding of `G - P_k`. Gradients are held to 2e-5 of the
largest entry of their column plus 1e-4 relative. Inputs keep every alpha
away from the 1/255 gate by a margin (pairs within 2% of it are moved), since
a pair on the other side of the step is a different function; one case sits
pairs right at the gate and shows that backward and forward take the same side.
The same plain backward is held against torch.autograd through the plain
forward, where only the order of sums differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.ops import gaussian_rasterize as JGR
from neurad_tpu.ops.pallas_composite import _run_bwd, run_lidar_bwd
from neurad_tpu_torch.ops import tile_composite as TC

from test_torch_tile_composite import _camera_case, _gathered, _lidar_case

torch.set_num_threads(1)

ATOL_OF_MAX, RTOL = 2e-5, 1e-4


def _away_from_gate(table, tile_gauss, tile_valid, x, y, t, wrap, margin=0.02):
    """Invalidate slots that put any pixel's alpha within `margin` (relative) of
    the 1/255 gate or of the 0.999 / sigma clips' edges."""
    g = torch.from_numpy(table)[torch.from_numpy(tile_gauss).long()]
    valid = torch.ones(tile_gauss.shape, dtype=torch.bool)
    _, _, sigma_raw, _, alpha_pre, _, _ = TC._alpha_terms(
        g, valid, torch.from_numpy(x)[..., None], torch.from_numpy(y)[..., None], torch.from_numpy(t)[..., None], wrap
    )
    near = ((alpha_pre * 255.0 - 1.0).abs() < margin) | ((alpha_pre - 0.999).abs() < 1e-3) | (sigma_raw.abs() < 1e-4)
    out = tile_valid.copy()
    out[near.any(dim=1).numpy()] = 0.0
    return out


def _scatter(table_shape, tile_gauss, tile_valid, grads):
    """JAX's per-tile grads (d_means, d_vel, d_con, d_opac, d_feats, d_depth,
    d_dvel) -> the packed table's layout, as the gather's transpose does."""
    d_means, d_vel, d_con, d_opac, d_feats, d_depth, d_dvel = (np.asarray(x, np.float64) for x in grads)
    col = lambda x: x if x.ndim == 3 else x[..., None]
    slots = np.concatenate([d_means, d_vel, d_con, col(d_opac), col(d_depth), col(d_dvel), d_feats], -1)
    out = np.zeros(table_shape, np.float64)
    keep = tile_valid > 0
    np.add.at(out, tile_gauss[keep], slots[keep])
    return out


def _assert_grads_close(got, want, names=TC.PACKED_COLUMNS):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    for col in range(want.shape[1]):
        name = names[col] if col < len(names) else f"feature_{col - len(names)}"
        scale = np.abs(want[:, col]).max()
        assert scale > 0, f"{name}: the case must give this column a gradient"
        np.testing.assert_allclose(got[:, col], want[:, col], atol=ATOL_OF_MAX * scale, rtol=RTOL, err_msg=name)


def _cotangents(rng, t, p, c, n_extra):
    g_feat = rng.normal(size=(t, p, c)).astype(np.float32)
    extra = [rng.normal(size=(t, p, 1)).astype(np.float32) for _ in range(n_extra)]
    g_feat[-1] = 0.0  # a tile whose pixels lie outside the image: zero cotangents
    for e in extra:
        e[-1] = 0.0
    return [g_feat] + extra


def _camera_bwd_case(seed=0):
    table, tile_gauss, tile_valid, pix, times = _camera_case(seed)
    tile_valid = _away_from_gate(table, tile_gauss, tile_valid, pix[..., 0], pix[..., 1], times[..., 0], False)
    rng = np.random.default_rng(seed + 100)
    cots = _cotangents(rng, pix.shape[0], pix.shape[1], table.shape[1] - TC.ATTR, 2)
    return (table, tile_gauss, tile_valid, pix, times), cots


def _pallas_camera_bwd(table, tile_gauss, tile_valid, pix, times, gf, gd, ga):
    """JAX's K3 in interpret mode, scattered into the packed table's layout."""
    means, vel, con, opac, feats, depth, dvel = _gathered(table, tile_gauss)
    j = _run_bwd(
        jnp.asarray(pix), jnp.asarray(times), jnp.asarray(means), jnp.asarray(vel), jnp.asarray(con),
        jnp.asarray(opac[..., None]), jnp.asarray(feats), jnp.asarray(depth[..., None]),
        jnp.asarray(dvel[..., None]), jnp.asarray(tile_valid[..., None]),
        jnp.asarray(gf), jnp.asarray(gd), jnp.asarray(ga),
    )
    return _scatter(table.shape, tile_gauss, tile_valid, j)


def test_camera_bwd_plain_matches_pallas_bwd():
    (table, tile_gauss, tile_valid, pix, times), (gf, gd, ga) = _camera_bwd_case()
    want = _pallas_camera_bwd(table, tile_gauss, tile_valid, pix, times, gf, gd, ga)
    got = TC.tile_composite_camera_bwd_plain(
        *map(torch.from_numpy, (table, tile_gauss, tile_valid, pix, times, gf, gd, ga))
    )
    _assert_grads_close(got.numpy(), want)


def _opaque_tile(table, tile_gauss, tile_valid, pix, seed, n_front=16):
    """Put n_front wide, dense gaussians in front of tile 0's slots, centred
    near the tile's middle (off the pixel centres): every pixel of the tile
    ends with an accumulated alpha above 0.99."""
    rng = np.random.default_rng(seed)
    centre = pix[0].mean(0)
    rows = np.zeros((n_front, table.shape[1]), np.float32)
    rows[:, 0:2] = centre + 0.37 + rng.uniform(-0.5, 0.5, (n_front, 2))
    rows[:, 2:4] = rng.normal(size=(n_front, 2))
    rows[:, 4] = rows[:, 6] = 1.0 / 20.0**2
    rows[:, 5] = rng.uniform(-0.2, 0.2, n_front) / 20.0**2
    rows[:, 7] = rng.uniform(0.85, 0.95, n_front)
    rows[:, 8] = np.linspace(1.0, 1.9, n_front)  # in front of every other slot (depths from 2 m)
    rows[:, 9] = rng.normal(size=n_front)
    rows[:, TC.ATTR:] = rng.uniform(size=(n_front, table.shape[1] - TC.ATTR))
    table = np.concatenate([table, rows])
    tile_gauss, tile_valid = tile_gauss.copy(), tile_valid.copy()
    tile_gauss[0, :n_front] = np.arange(n_front) + table.shape[0] - n_front
    tile_valid[0, :n_front] = 1.0
    return table, tile_gauss, tile_valid


@pytest.mark.parametrize("tiles", ["random", "opaque"])
def test_camera_bwd_plain_with_total_from_outputs_matches_pallas_bwd(tiles):
    """K3 takes G = sum_k w_k g_k from the forward's outputs: the plain
    backward given them equals the plain backward that sums G itself (to 1e-5
    of each entry's terms' magnitude, the card's tolerance) and JAX's kernel,
    also where a tile's pixels are near-opaque (the cancellation in G - P_k
    behind the opaque front is rounding of the same terms)."""
    (table, tile_gauss, tile_valid, pix, times), (gf, gd, ga) = _camera_bwd_case(9)
    if tiles == "opaque":
        table, tile_gauss, tile_valid = _opaque_tile(table, tile_gauss, tile_valid, pix, 10)
        tile_valid = _away_from_gate(table, tile_gauss, tile_valid, pix[..., 0], pix[..., 1], times[..., 0], False)
    args = list(map(torch.from_numpy, (table, tile_gauss, tile_valid, pix, times)))
    cots = list(map(torch.from_numpy, (gf, gd, ga)))
    outputs = TC.tile_composite_camera_plain(*args)
    if tiles == "opaque":
        assert float(outputs[2][0].min()) >= 0.99, "tile 0 is near-opaque"
    got = TC.tile_composite_camera_bwd_plain(*args, *cots, outputs=outputs)
    own = TC.tile_composite_camera_bwd_plain(*args, *cots)
    mag = TC.tile_composite_camera_bwd_plain(*args, *cots, magnitude=True)
    assert float(((got - own).abs() / mag.clamp_min(1e-30)).max()) <= 1e-5
    _assert_grads_close(got.numpy(), _pallas_camera_bwd(table, tile_gauss, tile_valid, pix, times, gf, gd, ga))


def _lidar_bwd_case(seed, wrap, until_cotangent):
    table, tile_gauss, tile_valid, pts_slot, vmask = _lidar_case(seed, wrap)
    tile_valid = _away_from_gate(table, tile_gauss, tile_valid, pts_slot[..., 0], pts_slot[..., 1], pts_slot[..., 3],
                                 wrap)
    rng = np.random.default_rng(seed + 100)
    gf, gd, ga, gu = _cotangents(rng, pts_slot.shape[0], pts_slot.shape[1], table.shape[1] - TC.ATTR, 3)
    if not until_cotangent:
        gu[:] = 0.0
    return (table, tile_gauss, tile_valid, pts_slot, vmask), (gf, gd, ga, gu)


def _pallas_lidar_bwd(table, tile_gauss, tile_valid, pts_slot, vmask, wrap, gf, gd, ga, gu):
    """JAX's K5 in interpret mode, scattered into the packed table's layout."""
    means, vel, con, opac, feats, depth, dvel = _gathered(table, tile_gauss)
    j = run_lidar_bwd(
        wrap, 0.4, jnp.asarray(pts_slot), jnp.asarray(vmask), jnp.asarray(means), jnp.asarray(vel),
        jnp.asarray(con), jnp.asarray(opac), jnp.asarray(feats), jnp.asarray(depth), jnp.asarray(dvel),
        jnp.asarray(tile_valid), jnp.asarray(gf), jnp.asarray(gd), jnp.asarray(ga), jnp.asarray(gu),
    )
    return _scatter(table.shape, tile_gauss, tile_valid, j)


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("until_cotangent", [True, False])
def test_lidar_bwd_plain_matches_pallas_bwd(wrap, until_cotangent):
    """K5 in interpret mode: azimuth wrap on/off, the line-of-sight cotangent
    zero/non-zero, invalid gaussian slots, masked query slots, an empty tile."""
    (table, tile_gauss, tile_valid, pts_slot, vmask), (gf, gd, ga, gu) = _lidar_bwd_case(1, wrap, until_cotangent)
    assert (tile_valid == 0).any() and (vmask == 0).any() and (tile_valid[3] == 0).all()
    want = _pallas_lidar_bwd(table, tile_gauss, tile_valid, pts_slot, vmask, wrap, gf, gd, ga, gu)
    got = TC.tile_composite_lidar_bwd_plain(
        *map(torch.from_numpy, (table, tile_gauss, tile_valid, pts_slot, vmask)), wrap, 0.4,
        *map(torch.from_numpy, (gf, gd, ga, gu)),
    )
    _assert_grads_close(got.numpy(), want)
    if wrap:  # the wrap changes numbers: without it the seam-crossing pairs vanish
        no_wrap = TC.tile_composite_lidar_bwd_plain(
            *map(torch.from_numpy, (table, tile_gauss, tile_valid, pts_slot, vmask)), False, 0.4,
            *map(torch.from_numpy, (gf, gd, ga, gu)),
        )
        assert float((no_wrap - got).abs().max()) > 1e-3


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("until_cotangent", [True, False])
def test_lidar_bwd_plain_with_total_from_outputs_matches_pallas_bwd(wrap, until_cotangent):
    """K5 takes G = sum_k w_k g_k from the forward's outputs, the line-of-sight
    sum's included: the plain backward given them equals the one that sums G
    itself (to 1e-5 of each entry's terms' magnitude, the card's tolerance)
    and JAX's kernel, whose loop sums G."""
    arrays, cots = _lidar_bwd_case(2, wrap, until_cotangent)
    args, cot = list(map(torch.from_numpy, arrays)), list(map(torch.from_numpy, cots))
    outputs = TC.tile_composite_lidar_plain(*args, wrap, 0.4, True)[:4]
    got = TC.tile_composite_lidar_bwd_plain(*args, wrap, 0.4, *cot, outputs=outputs)
    own = TC.tile_composite_lidar_bwd_plain(*args, wrap, 0.4, *cot)
    mag = TC.tile_composite_lidar_bwd_plain(*args, wrap, 0.4, *cot, magnitude=True)
    assert float(((got - own).abs() / mag.clamp_min(1e-30)).max()) <= 1e-5
    _assert_grads_close(got.numpy(), _pallas_lidar_bwd(*arrays, wrap, *cots))


@pytest.mark.parametrize("wrap", [True, False])
def test_lidar_bwd_plain_with_total_from_outputs_matches_autograd_of_plain_forward(wrap):
    arrays, cots = _lidar_bwd_case(5, wrap, True)
    table, tile_gauss, tile_valid, pts_slot, vmask = map(torch.from_numpy, arrays)
    gf, gd, ga, gu = map(torch.from_numpy, cots)
    leaf = table.clone().requires_grad_(True)
    outs = TC.tile_composite_lidar_plain(leaf, tile_gauss, tile_valid, pts_slot, vmask, wrap, 0.4, True)
    (want,) = torch.autograd.grad(outs[:4], leaf, (gf, gd, ga, gu))
    got = TC.tile_composite_lidar_bwd_plain(table, tile_gauss, tile_valid, pts_slot, vmask, wrap, 0.4, gf, gd, ga, gu,
                                            outputs=[x.detach() for x in outs[:4]])
    _assert_grads_close(got.numpy(), want.numpy())


def _jax_lidar_composite(arrays, wrap, compute_until, cots):
    """JAX's full-Pallas lidar composite (interpret mode): its outputs and, by
    jax.vjp, its gradient for cotangents (gf, gd, ga, gu) and none on the
    median, scattered into the packed table's layout."""
    table, tile_gauss, tile_valid, pts_slot, vmask = arrays
    prims = [jnp.asarray(x) for x in _gathered(table, tile_gauss)]
    fn = lambda *g: JGR._pallas_lidar_composite(wrap, 0.4, compute_until, 512, jnp.asarray(pts_slot),
                                                jnp.asarray(vmask), *g, jnp.asarray(tile_valid))
    out, vjp = jax.vjp(fn, *prims)
    grads = vjp(tuple(jnp.asarray(x) for x in cots) + (jnp.zeros_like(out[4]),))
    return out, _scatter(table.shape, tile_gauss, tile_valid, grads)


@pytest.mark.parametrize("wrap", [True, False])
def test_lidar_function_without_the_until_sum_gives_jaxs_gradient(wrap):
    """`compute_until=False`: the caller gets zeros for the line-of-sight sum,
    as from JAX, yet that sum's cotangent still enters the gradient, as JAX's
    backward folds it in whatever `compute_until` says; the autograd function
    takes G from the sum it saved, computed all the same. CPU tensors reach
    the plain versions: no kernel is launched."""
    arrays, cots = _lidar_bwd_case(12, wrap, True)
    assert np.abs(cots[3]).max() > 0.0
    out, want = _jax_lidar_composite(arrays, wrap, False, cots)
    before = (TC.lidar_launches, TC.lidar_bwd_launches)
    leaf = torch.from_numpy(arrays[0]).requires_grad_(True)
    rest = list(map(torch.from_numpy, arrays[1:]))
    outs = TC.tile_composite_lidar(leaf, *rest, wrap, 0.4, False)
    assert float(np.abs(np.asarray(out[3])).max()) == 0.0 and float(outs[3].detach().abs().max()) == 0.0
    (got,) = torch.autograd.grad(outs[:4], leaf, tuple(map(torch.from_numpy, cots)))
    assert (TC.lidar_launches, TC.lidar_bwd_launches) == before
    _assert_grads_close(got.numpy(), want)
    no_until = [torch.from_numpy(x) for x in cots[:3]] + [torch.zeros_like(torch.from_numpy(cots[3]))]
    outs = TC.tile_composite_lidar(leaf, *rest, wrap, 0.4, False)
    (without,) = torch.autograd.grad(outs[:4], leaf, tuple(no_until))
    assert float((without - got).abs().max()) > 1e-4 * float(got.abs().max()), "the until cotangent matters"


def test_camera_bwd_plain_matches_autograd_of_plain_forward():
    arrays, cots = _camera_bwd_case(3)
    table, tile_gauss, tile_valid, pix, times = map(torch.from_numpy, arrays)
    gf, gd, ga = map(torch.from_numpy, cots)
    leaf = table.clone().requires_grad_(True)
    outs = TC.tile_composite_camera_plain(leaf, tile_gauss, tile_valid, pix, times)
    (want,) = torch.autograd.grad(outs, leaf, (gf, gd, ga))
    got = TC.tile_composite_camera_bwd_plain(table, tile_gauss, tile_valid, pix, times, gf, gd, ga)
    _assert_grads_close(got.numpy(), want.numpy())


@pytest.mark.parametrize("wrap", [True, False])
def test_lidar_bwd_plain_matches_autograd_of_plain_forward(wrap):
    arrays, cots = _lidar_bwd_case(4, wrap, True)
    table, tile_gauss, tile_valid, pts_slot, vmask = map(torch.from_numpy, arrays)
    gf, gd, ga, gu = map(torch.from_numpy, cots)
    leaf = table.clone().requires_grad_(True)
    outs = TC.tile_composite_lidar_plain(leaf, tile_gauss, tile_valid, pts_slot, vmask, wrap, 0.4, True)
    (want,) = torch.autograd.grad(outs[:4], leaf, (gf, gd, ga, gu))  # the median carries no gradient
    got = TC.tile_composite_lidar_bwd_plain(table, tile_gauss, tile_valid, pts_slot, vmask, wrap, 0.4, gf, gd, ga, gu)
    _assert_grads_close(got.numpy(), want.numpy())


def test_functions_route_cpu_tensors_to_the_plain_backward():
    """`tile_composite_camera/lidar` are differentiable in the table only, give
    the plain backward on CPU tensors (given G from the forward's outputs, as
    K3 and K5 take it) and launch no kernel there."""
    arrays, cots = _camera_bwd_case(5)
    table, tile_gauss, tile_valid, pix, times = map(torch.from_numpy, arrays)
    before = (TC.camera_bwd_launches, TC.lidar_bwd_launches)
    leaf = table.clone().requires_grad_(True)
    pix_leaf = pix.clone().requires_grad_(True)
    outs = TC.tile_composite_camera(leaf, tile_gauss, tile_valid, pix_leaf, times)
    d_table, d_pix = torch.autograd.grad(outs, (leaf, pix_leaf), tuple(map(torch.from_numpy, cots)), allow_unused=True)
    assert d_pix is None
    fwd = TC.tile_composite_camera_plain(table, tile_gauss, tile_valid, pix, times)
    want = TC.tile_composite_camera_bwd_plain(table, tile_gauss, tile_valid, pix, times, *map(torch.from_numpy, cots),
                                              outputs=fwd)
    torch.testing.assert_close(d_table, want, rtol=0, atol=0)

    arrays, cots = _lidar_bwd_case(6, True, True)
    table, tile_gauss, tile_valid, pts_slot, vmask = map(torch.from_numpy, arrays)
    leaf = table.clone().requires_grad_(True)
    outs = TC.tile_composite_lidar(leaf, tile_gauss, tile_valid, pts_slot, vmask, True, 0.4, True)
    assert not outs[4].requires_grad, "the median depth carries no gradient"
    (d_table,) = torch.autograd.grad(outs[:4], leaf, tuple(map(torch.from_numpy, cots)))
    fwd = TC.tile_composite_lidar_plain(table, tile_gauss, tile_valid, pts_slot, vmask, True, 0.4, True)
    want = TC.tile_composite_lidar_bwd_plain(table, tile_gauss, tile_valid, pts_slot, vmask, True, 0.4,
                                             *map(torch.from_numpy, cots), outputs=fwd[:4])
    torch.testing.assert_close(d_table, want, rtol=0, atol=0)
    assert (TC.camera_bwd_launches, TC.lidar_bwd_launches) == before


def test_clamped_and_invalid_slots_add_nothing():
    arrays, cots = _camera_bwd_case(7)
    table, tile_gauss, tile_valid, pix, times = arrays
    n = table.shape[0]
    tile_gauss = tile_gauss.copy()
    tile_gauss[:, 0], tile_gauss[:, 1] = -2, n + 5  # composited through the clamped rows 0 and n - 1
    base_valid = tile_valid.copy()
    base_valid[:, :2] = 0.0
    tensors = lambda tv: map(torch.from_numpy, (table, tile_gauss, tv, pix, times, *cots))
    got = TC.tile_composite_camera_bwd_plain(*tensors(tile_valid))
    rows = torch.from_numpy(tile_gauss[:, 2:][tile_valid[:, 2:] > 0]).long().unique()
    untouched = torch.ones(n, dtype=torch.bool)
    untouched[rows] = False
    assert float(got[untouched].abs().max()) == 0.0
    # the clamped slots still stand in front of the others: without them the gradients change
    assert float((got - TC.tile_composite_camera_bwd_plain(*tensors(base_valid))).abs().max()) > 1e-4


def test_backward_takes_the_forwards_side_of_the_gate():
    """Pairs placed within an ulp or two of alpha = 1/255: the plain backward
    gives a gradient exactly to the pairs the plain forward composites."""
    rng = np.random.default_rng(8)
    n, c, p = 64, 4, 16
    table = np.zeros((n, TC.ATTR + c), np.float32)
    table[:, 0:2] = 5.0  # every mean at (5, 5)
    table[:, 4], table[:, 6] = 1.0, 1.0  # unit conic
    table[:, 7] = 0.9
    table[:, 8] = np.linspace(2.0, 30.0, n)
    table[:, TC.ATTR:] = rng.uniform(size=(n, c))
    # radius at which 0.9 exp(-r^2/2) = 1/255, then pixels a few ulps either side of it
    r_gate = np.sqrt(2.0 * np.log(0.9 * 255.0))
    radii = np.float32(r_gate) + np.arange(-p // 2, p // 2) * np.spacing(np.float32(r_gate)) * 4
    pix = np.zeros((n, p, 2), np.float32)
    pix[..., 0], pix[..., 1] = 5.0 + radii[None, :], 5.0
    times = np.zeros((n, p, 1), np.float32)
    tile_gauss = np.arange(n, dtype=np.int32)[:, None]  # one tile per gaussian, one slot
    tile_valid = np.ones((n, 1), np.float32)
    tensors = list(map(torch.from_numpy, (table, tile_gauss, tile_valid, pix, times)))
    _, _, alpha = TC.tile_composite_camera_plain(*tensors)
    on = alpha[..., 0] > 0
    assert on.any() and (~on).any(), "pixels on both sides of the gate"
    # cotangent on alpha only, one pixel at a time: d opacity is non-zero exactly where the forward composited
    for q in range(p):
        ga = torch.zeros((n, p, 1))
        ga[:, q] = 1.0
        d = TC.tile_composite_camera_bwd_plain(*tensors, torch.zeros((n, p, c)), torch.zeros((n, p, 1)), ga)
        assert torch.equal(d[:, 7] != 0, on[:, q])
