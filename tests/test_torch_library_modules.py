"""The library modules of the last slice against the JAX package, each on
seeded numpy inputs: renderers, scene colliders, ray generators; the pixel
samplers, data utilities and datasets; the occupancy grid; the extra
encodings; the NeuS sampler and the sorted merge; the depth-ranking and URF
losses and four math utilities; the batch-norm RGB decoder; the per-point
lidar rasterizer.

Tolerances, per test: bit-equal where both packages run the same host numpy
(samplers, data utilities, datasets, bases); 1e-6 relative (plus 1e-7
absolute) for fp32 arithmetic that XLA and torch may order or fuse
differently (renderers, colliders, rays, losses, math, encodings); the
samplers' bin edges to 1e-5 (an inverse CDF through fp32 cumulative sums,
sigmoids and exponentials); the batch norm to 1e-5 (flax's fast variance
against the same formula in torch; the running averages after an update
too); the per-point lidar rasterizer against JAX's at the bounds of
`tests/ops/test_gaussians.py::test_lidar_tiled_matches_pointwise` (2e-3
absolute, 2e-2 relative), and against the port's tiled path (the lidar
composite) at those bounds too.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.core import math_utils as TMU
from neurad_tpu_torch.core.structs import RayBundle as TBundle
from neurad_tpu_torch.data import data_utils as TDU
from neurad_tpu_torch.data import datasets as TDS
from neurad_tpu_torch.data import pixel_samplers as TPS
from neurad_tpu_torch.fields import extra_encodings as TEE
from neurad_tpu_torch.model_components import losses as TL
from neurad_tpu_torch.model_components import occupancy_grid as TOG
from neurad_tpu_torch.model_components import ray_generators as TRG
from neurad_tpu_torch.model_components import ray_samplers as TRS
from neurad_tpu_torch.model_components import renderers as TR
from neurad_tpu_torch.model_components import scene_colliders as TSC

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _bundles(n=6, seed=0, nears=True):
    """The same rays in both packages' RayBundle."""
    from neurad_tpu.core.structs import RayBundle as JBundle

    rng = np.random.default_rng(seed)
    o = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    area = np.full((n, 1), 1e-4, np.float32)
    kw = dict(nears=np.full((n, 1), 0.5, np.float32), fars=np.full((n, 1), 10.0, np.float32)) if nears else {}
    jb = JBundle(origins=jnp.asarray(o), directions=jnp.asarray(d), pixel_area=jnp.asarray(area),
                 **{k: jnp.asarray(v) for k, v in kw.items()})
    tb = TBundle(origins=_t(o), directions=_t(d), pixel_area=_t(area), **{k: _t(v) for k, v in kw.items()})
    return jb, tb


# ----------------------------------------------------------------------------
# renderers, scene colliders, ray generators
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["features", "rgb", "rgb_bg", "accumulation", "depth_median", "depth_expected",
                                  "normals", "sh", "uncertainty", "semantics"])
def test_renderers_match_jax(name):
    from neurad_tpu.model_components import renderers as JR

    rng = np.random.default_rng(1)
    w = rng.uniform(0, 0.2, (5, 8, 1)).astype(np.float32)
    vals = rng.normal(0, 1, (5, 8, 3)).astype(np.float32)
    steps = np.sort(rng.uniform(1, 9, (5, 8, 1)).astype(np.float32), axis=1)
    sh = rng.normal(0, 0.3, (5, 8, 9 * 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (5, 3)).astype(np.float32)  # one direction a ray
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    bg = np.array([0.2, 0.4, 0.9], np.float32)
    cases = {
        "features": lambda M, A: M.render_features(A(w), A(vals)),
        "rgb": lambda M, A: M.render_rgb(A(w), A(vals)),
        "rgb_bg": lambda M, A: M.render_rgb(A(w), A(vals), background_color=A(bg)),
        "accumulation": lambda M, A: M.render_accumulation(A(w)),
        "depth_median": lambda M, A: M.render_depth(A(w * 4), A(steps), "median"),
        "depth_expected": lambda M, A: M.render_depth(A(w), A(steps), "expected"),
        "normals": lambda M, A: M.render_normals(A(w), A(vals)),
        "sh": lambda M, A: M.render_sh(A(w), A(sh), A(dirs), 3),
        "uncertainty": lambda M, A: M.render_uncertainty(A(w), A(vals[..., :1])),
        "semantics": lambda M, A: M.render_semantics(A(w), A(vals)),
    }
    _close(cases[name](TR, _t), cases[name](JR, jnp.asarray), what=name)
    with pytest.raises(ValueError, match="unknown depth method"):
        TR.render_depth(_t(w), _t(steps), "mode")


@pytest.mark.parametrize("collider", ["near_far", "aabb", "sphere"])
def test_scene_colliders_match_jax(collider):
    from neurad_tpu.model_components import scene_colliders as JSC

    jb, tb = _bundles(nears=False)
    aabb = np.array([[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]], np.float32)
    center = np.array([0.5, 0.0, 0.2], np.float32)
    calls = {
        "near_far": lambda M, b, A: M.near_far_collider(b, 0.3, 7.0),
        "aabb": lambda M, b, A: M.aabb_box_collider(b, A(aabb), near_plane=0.1),
        "sphere": lambda M, b, A: M.sphere_collider(b, A(center), 1.5, near_plane=0.05),
    }
    got, want = calls[collider](TSC, tb, _t), calls[collider](JSC, jb, jnp.asarray)
    _close(got.nears, want.nears, what="nears")
    _close(got.fars, want.fars, what="fars")


def test_ray_generators_match_jax():
    from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
    from neurad_tpu.model_components import ray_generators as JRG
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth

    scene = dict(num_frames=3, image_height=16, image_width=24, lidar_channels=4, lidar_azimuths=12)
    jo, to = JSynth(**scene).setup().get_dataparser_outputs(), TSynth(**scene).setup().get_dataparser_outputs()
    rng = np.random.default_rng(2)
    idx = np.stack([rng.integers(0, 3, 20), rng.integers(0, 16, 20), rng.integers(0, 24, 20)], -1).astype(np.int32)
    jr, tr = JRG.ray_generator(jo.cameras, jnp.asarray(idx)), TRG.ray_generator(to.cameras, _t(idx))
    for f in ("origins", "directions", "pixel_area"):
        _close(getattr(tr, f), getattr(jr, f), rtol=1e-5, atol=1e-6, what=f)
    pts = np.asarray(jo.point_clouds[0][:10], np.float32)
    scans = np.zeros(10, np.int32)
    jl = JRG.lidar_ray_generator(jo.lidars, jnp.asarray(scans), jnp.asarray(pts))
    tl = TRG.lidar_ray_generator(to.lidars, _t(scans), _t(pts))
    for f in ("origins", "directions"):
        _close(getattr(tl, f), getattr(jl, f), rtol=1e-5, atol=1e-6, what=f)
    _close(tl.metadata["directions_norm"], jl.metadata["directions_norm"], rtol=1e-5, what="ranges")


# ----------------------------------------------------------------------------
# pixel samplers, data utilities, datasets (the same host numpy: bit-equal)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["uniform", "patch", "scaled", "scaled_scores", "lidar", "pair"])
def test_pixel_samplers_draw_jax_indices(name):
    from neurad_tpu.data import pixel_samplers as JPS

    scores = np.random.default_rng(9).uniform(size=(2, 20, 30))
    calls = {
        "uniform": lambda M, r: M.sample_uniform_pixels(r, 50, 3, 20, 30),
        "patch": lambda M, r: M.sample_patch_pixels(r, 3, 4, 3, 20, 30),
        "scaled": lambda M, r: M.sample_scaled_patches(r, 3, 2, 3, 2, 20, 30),
        "scaled_scores": lambda M, r: M.sample_scaled_patches(r, 3, 2, 3, 2, 20, 30, scores=scores),
        "lidar": lambda M, r: M.sample_lidar_points(r, 200, np.array([100, 300, 7])),
        "pair": lambda M, r: M.sample_pair_pixels(r, 20, 3, 20, 30, radius=2),
    }
    got = calls[name](TPS, np.random.default_rng(4))
    want = calls[name](JPS, np.random.default_rng(4))
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


def test_data_utils_and_datasets_match_jax():
    from neurad_tpu.data import data_utils as JDU
    from neurad_tpu.data import datasets as JDS
    from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth

    rng = np.random.default_rng(5)
    pts = rng.uniform(-5, 5, (400, 3))
    box = np.eye(4)
    box[:3, :3] = np.array([[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]])
    box[:3, 3] = [1.0, 0.5, 0.0]
    np.testing.assert_array_equal(TDU.points_in_box(pts, box, np.array([3.0, 2.0, 2.0])),
                                  JDU.points_in_box(pts, box, np.array([3.0, 2.0, 2.0])))
    scene = dict(num_frames=4, image_height=12, image_width=16, lidar_channels=4, lidar_azimuths=30)
    jo, to = JSynth(**scene).setup().get_dataparser_outputs(), TSynth(**scene).setup().get_dataparser_outputs()
    l2ws = [np.asarray(x) for x in jo.lidars.lidar_to_worlds]
    stamps = [float(t) for t in np.asarray(jo.lidars.times)[:, 0]]
    for traj in jo.trajectories:
        traj["stationary"] = False
    got = TDU.remove_dynamic_points(jo.point_clouds, l2ws, stamps, jo.trajectories, extra_padding=0.5)
    want = JDU.remove_dynamic_points(jo.point_clouds, l2ws, stamps, jo.trajectories, extra_padding=0.5)
    assert sum(len(p) for p in got) < sum(len(p) for p in jo.point_clouds), "some points fell in an actor's box"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for split in (None, [2, 0]):
        ti, ji = TDS.InputDataset(to, split), JDS.InputDataset(jo, split)
        assert len(ti) == len(ji)
        for i in range(len(ti)):
            np.testing.assert_array_equal(ti.get_image_float32(i), ji.get_image_float32(i))
            np.testing.assert_array_equal(ti.get_image_uint8(i), ji.get_image_uint8(i))
            assert ti[i]["image_idx"] == ji[i]["image_idx"]
        tl, jl = TDS.LidarDataset(to, split), JDS.LidarDataset(jo, split)
        assert len(tl) == len(jl)
        for i in range(len(tl)):
            np.testing.assert_array_equal(tl[i]["lidar"], jl[i]["lidar"])
            assert tl[i]["lidar_idx"] == jl[i]["lidar_idx"]


# ----------------------------------------------------------------------------
# occupancy grid, NeuS sampler, sorted merge
# ----------------------------------------------------------------------------


def _ball_density(xp):
    """A dense ball of radius 2 at (5, 0, 0) (tests/model_components/test_occupancy_grid.py)."""
    def fn(pos):
        inside = xp.linalg.norm(pos - xp.asarray(np.array([5.0, 0.0, 0.0], np.float32)), axis=-1) < 2.0
        return xp.where(inside, xp.asarray(np.float32(10.0)), xp.asarray(np.float32(0.0)))
    return fn


def _grids():
    from neurad_tpu.model_components import occupancy_grid as JOG

    aabb = np.array([[-10.0, -10.0, -10.0], [10.0, 10.0, 10.0]], np.float32)
    key = jax.random.PRNGKey(0)
    jgrid = JOG.update_occupancy_grid(JOG.init_occupancy_grid(jnp.asarray(aabb), 16), _ball_density(jnp), key)
    jitter = np.array(jax.random.uniform(key, (16**3, 3)))
    tgrid = TOG.update_occupancy_grid(TOG.init_occupancy_grid(_t(aabb), 16), _ball_density(torch), _t(jitter))
    return JOG, jgrid, tgrid


def test_occupancy_grid_update_and_lookup_match_jax():
    _, jgrid, tgrid = _grids()
    np.testing.assert_array_equal(tgrid.densities.numpy(), np.asarray(jgrid.densities))
    assert tgrid.densities.sum() > 0
    q = np.random.default_rng(6).uniform(-12, 12, (200, 3)).astype(np.float32)
    from neurad_tpu.model_components.occupancy_grid import occupancy_at

    np.testing.assert_array_equal(TOG.occupancy_at(tgrid, _t(q)).numpy(), np.asarray(occupancy_at(jgrid, jnp.asarray(q))))


@pytest.mark.parametrize("mode", ["march", "resample"])
def test_volumetric_sampler_matches_jax(mode):
    JOG, jgrid, tgrid = _grids()
    jb, tb = _bundles(n=4, seed=3)
    jb = jb.replace(origins=jnp.zeros((4, 3)), directions=jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), (4, 3)))
    tb = tb.replace(origins=torch.zeros((4, 3)), directions=torch.tensor([1.0, 0.0, 0.0]).expand(4, 3))
    key = jax.random.PRNGKey(1)
    js, jocc = JOG.volumetric_sampler(jb, jgrid, num_samples=16, key=key, mode=mode, march_candidates=128)
    jitter = _t(np.array(jax.random.uniform(key, (4, 17)))) if mode == "resample" else None
    ts, tocc = TOG.volumetric_sampler(tb, tgrid, num_samples=16, jitter=jitter, mode=mode, march_candidates=128)
    _close(ts.frustums.starts, js.frustums.starts, rtol=1e-5, atol=1e-5, what="starts")
    _close(ts.frustums.ends, js.frustums.ends, rtol=1e-5, atol=1e-5, what="ends")
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    assert tocc.float().mean() > 0.5


def test_merge_ray_samples_sorted_matches_jax():
    from neurad_tpu.model_components import ray_samplers as JRS

    jb, tb = _bundles(n=4, seed=7)
    key = jax.random.PRNGKey(2)
    ja = JRS.spaced_sampler(jb, 8, JRS.UNIFORM, key=key)
    jc = JRS.spaced_sampler(jb, 5, JRS.UNIFORM)
    ta = TRS.spaced_sampler(tb, 8, TRS.UNIFORM, jitter=_t(np.array(jax.random.uniform(key, (4, 9)))))
    tc = TRS.spaced_sampler(tb, 5, TRS.UNIFORM)
    jm, tm = JRS.merge_ray_samples_sorted(ja, jc), TRS.merge_ray_samples_sorted(ta, tc)
    for f in ("starts", "ends"):
        _close(getattr(tm.frustums, f), getattr(jm.frustums, f), what=f)
    _close(tm.deltas, jm.deltas, atol=1e-6, what="deltas")
    _close(tm.spacing_starts, jm.spacing_starts, what="spacing")
    assert (np.diff(tm.frustums.starts[..., 0].numpy(), axis=-1) >= 0).all()


@pytest.mark.parametrize("jittered", [False, True], ids=["centres", "jittered"])
def test_neus_sampler_matches_jax(jittered):
    from neurad_tpu.model_components import ray_samplers as JRS

    jb, tb = _bundles(n=4, seed=8)
    jb = jb.replace(origins=jnp.zeros((4, 3)), directions=jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), (4, 3)))
    tb = tb.replace(origins=torch.zeros((4, 3)), directions=torch.tensor([1.0, 0.0, 0.0]).expand(4, 3))

    def sdf(xp):
        return lambda s: xp.linalg.norm(s.frustums.get_positions() - xp.asarray(np.array([5.0, 0, 0], np.float32)),
                                        axis=-1, keepdims=True) - 1.0

    key = jax.random.PRNGKey(3) if jittered else None
    run = jax.jit(lambda b: JRS.neus_sampler(b, sdf(jnp), num_samples=16, num_samples_importance=16,
                                             num_upsample_steps=4, key=key, single_jitter=True))
    js = run(jb)
    jitters = None
    if jittered:  # the JAX sampler's draws: the key for the first round, its splits for the upsampling rounds
        keys = jax.random.split(key, 4)
        jitters = [_t(np.array(jax.random.uniform(key, (4, 1))))] + [
            _t(np.array(jax.random.uniform(k, (4, 1)))) for k in keys]
    ts = TRS.neus_sampler(tb, sdf(torch), num_samples=16, num_samples_importance=16, num_upsample_steps=4,
                          jitters=jitters)
    assert ts.frustums.starts.shape == (4, 32, 1)
    _close(ts.frustums.starts, js.frustums.starts, rtol=1e-5, atol=1e-5, what="starts")
    _close(ts.frustums.ends, js.frustums.ends, rtol=1e-5, atol=1e-5, what="ends")


# ----------------------------------------------------------------------------
# extra encodings
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("covs", [False, True], ids=["plain", "integrated"])
def test_ff_encoding_and_bases_match_jax(covs):
    from neurad_tpu.fields import extra_encodings as JEE

    assert TEE.rff_basis(3, 8, 2.0, seed=1) == JEE.rff_basis(3, 8, 2.0, seed=1)
    assert TEE.octahedron_basis() == JEE.octahedron_basis()
    basis = JEE.rff_basis(3, 4, 1.0)
    x = np.random.default_rng(10).uniform(-1, 1, (6, 3)).astype(np.float32)
    c = (np.eye(3, dtype=np.float32)[None] * np.random.default_rng(11).uniform(0.01, 0.2, (6, 1, 1))).astype(np.float32)
    jenc = JEE.FFEncoding(basis=basis, num_frequencies=3, max_freq_exp=3.0, include_input=True)
    tenc = TEE.FFEncoding(basis, num_frequencies=3, max_freq_exp=3.0, include_input=True)
    want = jenc.apply({}, jnp.asarray(x), jnp.asarray(c) if covs else None)
    got = tenc(_t(x), _t(c) if covs else None)
    assert got.shape == want.shape == (6, tenc.out_dim)
    _close(got, want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("name", ["cp", "vm", "triplane", "triplane_product", "kplanes"])
def test_tensor_encodings_match_jax(name):
    """Forward and the coefficients' gradients, the flax parameters carried across."""
    from neurad_tpu.fields import extra_encodings as JEE

    dims = 4 if name == "kplanes" else 3
    x = np.random.default_rng(12).uniform(-1.1, 1.1, (9, dims)).astype(np.float32)  # a few beyond the border
    pairs = {"cp": (JEE.TensorCPEncoding(resolution=8, num_components=3), TEE.TensorCPEncoding(8, 3)),
             "vm": (JEE.TensorVMEncoding(resolution=8, num_components=3), TEE.TensorVMEncoding(8, 3)),
             "triplane": (JEE.TriplaneEncoding(resolution=8, num_components=3), TEE.TriplaneEncoding(8, 3)),
             "triplane_product": (JEE.TriplaneEncoding(resolution=8, num_components=3, reduce="product"),
                                  TEE.TriplaneEncoding(8, 3, reduce="product")),
             "kplanes": (JEE.KPlanesEncoding(in_dim=4, resolution=6, num_components=3),
                         TEE.KPlanesEncoding(4, 6, 3))}
    jenc, tenc = pairs[name]
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    res = tenc.load_state_dict(bridge.extra_encoding_params_from_flax(jax.tree.map(np.asarray, params)))
    assert not res.missing_keys and not res.unexpected_keys
    want = jenc.apply(params, jnp.asarray(x))
    got = tenc(_t(x))
    assert got.shape == want.shape == (9, tenc.out_dim)
    _close(got, want, atol=1e-7)
    jgrads = bridge.extra_encoding_params_from_flax(jax.tree.map(
        np.asarray, jax.grad(lambda p: jnp.sum(jenc.apply(p, jnp.asarray(x)) ** 2))(params)))
    torch.sum(tenc(_t(x)) ** 2).backward()
    for k, p in tenc.named_parameters():
        _close(p.grad, jgrads[k], rtol=1e-5, atol=1e-6, what=k)


# ----------------------------------------------------------------------------
# losses and math
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["depth_ranking", "depth_ranking_odd", "urf", "intersect_obb", "erf_approx",
                                  "expected_sin", "depth_scale_and_shift", "depth_scale_and_shift_singular"])
def test_losses_and_math_match_jax(name):
    from neurad_tpu.core import math_utils as JMU
    from neurad_tpu.model_components import losses as JL

    rng = np.random.default_rng(13)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    depth_r, depth_g = np.abs(f(11, 1)) + 1, np.abs(f(11, 1)) + 1
    w, steps = np.abs(f(7, 6, 1)) * 0.2, np.sort(np.abs(f(7, 6, 1)) * 5, axis=1)
    term = np.abs(f(7, 1)) * 4
    term[2] = 0.0  # a ray without a return
    rot = np.linalg.qr(f(3, 3))[0].astype(np.float32)
    o, d = f(10, 3) * 3, f(10, 3)
    pred, target, mask = f(2, 5, 6), f(2, 5, 6), (rng.uniform(size=(2, 5, 6)) > 0.3).astype(np.float32)
    cases = {
        "depth_ranking": lambda M, A: M.depth_ranking_loss(A(depth_r[:10]), A(depth_g[:10])),
        "depth_ranking_odd": lambda M, A: M.depth_ranking_loss(A(depth_r), A(depth_g)),
        "urf": lambda M, A: M.urban_radiance_field_depth_loss(A(w), A(term), A(np.abs(f(7, 1)) * 4), A(steps),
                                                              A(np.float32(0.3))),
        "intersect_obb": lambda M, A: M.intersect_obb(A(o), A(d), A(rot), A(np.array([0.5, -0.2, 0.1], np.float32)),
                                                      A(np.array([2.0, 1.0, 3.0], np.float32))),
        "erf_approx": lambda M, A: M.erf_approx(A(f(20))),
        "expected_sin": lambda M, A: M.expected_sin(A(f(20)), A(np.abs(f(20)))),
        "depth_scale_and_shift": lambda M, A: M.normalized_depth_scale_and_shift(A(pred), A(target), A(mask)),
        "depth_scale_and_shift_singular": lambda M, A: M.normalized_depth_scale_and_shift(
            A(pred), A(target), A(np.zeros_like(mask))),
    }
    module = {"depth_ranking": (TL, JL), "depth_ranking_odd": (TL, JL), "urf": (TL, JL)}.get(name, (TMU, JMU))
    state = rng.bit_generator.state
    got = cases[name](module[0], _t)
    rng.bit_generator.state = state  # the same draws for both packages
    want = cases[name](module[1], jnp.asarray)
    for g, wv in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        _close(g, wv, rtol=2e-6, atol=1e-6, what=name)


# ----------------------------------------------------------------------------
# the batch-norm RGB decoder
# ----------------------------------------------------------------------------


def test_batch_norm_decoder_matches_flax_in_train_and_eval():
    """`rgb_decoder_norm="batch"`: the decoder with the flax parameters and
    batch statistics carried across; in train mode it normalises by the
    batch and moves its running averages as flax does with
    `mutable=["batch_stats"]` (momentum 0.99, the biased variance); in eval
    mode it normalises by them. JAX's own apply without that mutable
    collection refuses the train mode."""
    from neurad_tpu.model_components import cnns as JC
    from neurad_tpu_torch.model_components import cnns as TC

    x = np.random.default_rng(14).normal(0, 1, (3, 4, 4, 6)).astype(np.float32)
    jdec = JC.RGBDecoderCNN(hidden_dim=16, upsample_factor=2, norm="batch", compute_dtype=None)
    variables = jdec.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    stats = jax.tree.map(lambda s: s + 0.3, variables["batch_stats"])  # running averages other than the init's
    variables = {"params": variables["params"], "batch_stats": stats}
    tdec = TC.RGBDecoderCNN(6, hidden_dim=16, upsample_factor=2, norm="batch", compute_dtype=None)
    sd = bridge.neurad_decoder_from_flax("", jax.tree.map(np.asarray, variables["params"]))
    sd.update(bridge.batch_stats_from_flax("", jax.tree.map(np.asarray, stats)))
    res = tdec.load_state_dict({k[1:]: v for k, v in sd.items()})
    assert not res.missing_keys and not res.unexpected_keys

    _close(tdec(_t(x)), jdec.apply(variables, jnp.asarray(x), False), rtol=1e-5, atol=1e-5, what="eval")
    want, updated = jdec.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    _close(tdec(_t(x), train=True), want, rtol=1e-5, atol=1e-5, what="train")
    new = bridge.batch_stats_from_flax("", jax.tree.map(np.asarray, updated["batch_stats"]))
    for k, v in tdec.state_dict().items():
        if "running" in k:
            _close(v, new["." + k], rtol=1e-5, atol=1e-6, what=k)
    with pytest.raises(Exception, match="batch_stats"):
        jdec.apply(variables, jnp.asarray(x), True)


def test_neurad_builds_with_a_batch_norm_decoder_and_trains_its_averages():
    from neurad_tpu_torch.configs.method_configs import neurad_tiny_overrides
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline, ADPipelineConfig

    outputs = TSynth(num_frames=2, lidar_channels=4, lidar_azimuths=12).setup().get_dataparser_outputs()
    from neurad_tpu_torch.data.datamanager import ADDataManagerConfig

    cfg = ADPipelineConfig(datamanager=ADDataManagerConfig(num_cam_patches=2, patch_size=4, num_lidar_rays=64),
                           model_overrides={**neurad_tiny_overrides(), "rgb_decoder_norm": "batch"})
    pipe = ADPipeline(outputs, cfg, device="cpu")
    before = {k: v.clone() for k, v in pipe.model.state_dict().items() if "running" in k}
    assert before
    rgb, _ = pipe.render_eval_camera(0)
    assert np.isfinite(rgb).all()
    assert all(torch.equal(v, pipe.model.state_dict()[k]) for k, v in before.items()), "eval keeps the averages"
    state = pipe.init_state()
    pipe.train_step(state, *pipe.datamanager.next_train())
    assert any(not torch.equal(v, pipe.model.state_dict()[k]) for k, v in before.items()), "a train step moves them"


# ----------------------------------------------------------------------------
# the per-point lidar rasterizer
# ----------------------------------------------------------------------------


def lidar_points_agree(points: dict, tiled: dict) -> float:
    """The share of query points where the per-point path and the tiled path
    (the lidar composite) agree within 2e-3 + 2e-2 |x| in features, depth,
    alpha and the alpha before the return. They differ in precision: the
    per-point path takes the quadratic form in bf16, as XLA does in the JAX
    package, the composite in fp32, so a slot near the 1/255 alpha gate may
    fall on either side; and in the median (the composite's is the first
    slot reaching half the accumulation, ROADMAP.md section 3), not compared."""
    ok = torch.ones(points["alpha"].shape[0], dtype=torch.bool)
    for k in ("features", "depth", "alpha", "alpha_sum_until_points"):
        a, b = points[k].detach(), tiled[k].detach()
        ok &= ((a - b).abs() <= 2e-3 + 2e-2 * b.abs()).all(dim=-1)
    return float(ok.float().mean())


def _lidar_scene():
    """The scene of tests/ops/test_gaussians.py::test_lidar_tiled_matches_pointwise, in both packages."""
    from neurad_tpu.ops import gaussians as JG
    from neurad_tpu_torch.ops import gaussians as TG

    key = jax.random.PRNGKey(11)
    ks = jax.random.split(key, 6)
    n, m = 400, 300
    means = jnp.stack([jax.random.uniform(ks[0], (n,), minval=5, maxval=40),
                       jax.random.uniform(ks[1], (n,), minval=-20, maxval=20),
                       jax.random.uniform(ks[2], (n,), minval=-2, maxval=5)], axis=-1)
    quats = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0, 0.0]), (n, 4))
    jproj = JG.project_gaussians_lidar(means, JG.quat_scale_to_covariance(quats, jnp.full((n, 3), 0.8)), jnp.eye(4))
    feats = jax.random.normal(ks[3], (n, 5))
    opac = jax.nn.sigmoid(jax.random.normal(ks[4], (n,)))
    pts = jnp.stack([jax.random.uniform(ks[5], (m,), minval=-179, maxval=179),
                     jax.random.uniform(ks[5], (m,), minval=-20, maxval=10),
                     jax.random.uniform(ks[5], (m,), minval=3, maxval=50),
                     jax.random.uniform(ks[5], (m,), minval=-0.05, maxval=0.05)], axis=-1)
    tproj = TG.Projected(**{f: _t(np.asarray(getattr(jproj, f))) for f in TG.Projected._fields})
    return jproj, feats, opac, pts, tproj


@pytest.mark.parametrize("point_chunk", [0, 128], ids=["whole", "chunked"])
def test_pointwise_lidar_rasterizer_matches_jax_and_the_tiled_path(point_chunk):
    from neurad_tpu.ops import gaussian_rasterize as JGR
    from neurad_tpu_torch.ops import gaussian_rasterize as TGR

    jproj, feats, opac, pts, tproj = _lidar_scene()
    kw = dict(max_per_tile=32, max_tiles_per_gaussian=16)
    jrun = jax.jit(lambda op: JGR.rasterize_lidar_points(jproj, feats, op, pts, **kw))
    want = jrun(opac)
    t_opac = _t(np.asarray(opac)).requires_grad_(True)
    got = TGR.rasterize_lidar_points(tproj, _t(np.asarray(feats)), t_opac, _t(np.asarray(pts)), point_chunk=point_chunk,
                                     **kw)
    tiled = TGR.rasterize_lidar_points_tiled(tproj, _t(np.asarray(feats)), _t(np.asarray(opac)), _t(np.asarray(pts)),
                                             pts_per_tile=16, **kw)
    assert int(tiled["points_overflowed"]) == 0
    for k in ("features", "depth", "alpha", "alpha_sum_until_points", "median_depth"):
        _close(got[k], want[k], rtol=2e-2, atol=2e-3, what=k)
    assert lidar_points_agree(got, tiled) >= 0.98
    assert float(got["alpha"].max()) > 0.1
    g_want = jax.jit(jax.grad(lambda op: jnp.sum(jrun(op)["features"] ** 2) + jnp.sum(jrun(op)["alpha_sum_until_points"])))(
        opac)
    (torch.sum(got["features"] ** 2) + torch.sum(got["alpha_sum_until_points"])).backward()
    scale = float(np.abs(np.asarray(g_want)).max())
    _close(t_opac.grad, g_want, rtol=2e-2, atol=2e-3 * scale, what="opacity gradient")


def test_splatad_lidar_step_in_points_mode():
    """`lidar_raster_mode="points"` trains: the model's lidar outputs match the
    tiled mode's on the same parameters, and a lidar step runs."""
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
    from neurad_tpu_torch.data.full_image_datamanager import FullImageLidarDataManagerConfig
    from neurad_tpu_torch.models.splatad import SplatADConfig
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig

    outputs = TSynth(num_frames=3, image_height=16, image_width=24, lidar_channels=8,
                     lidar_azimuths=60).setup().get_dataparser_outputs()
    model = dict(num_downscales=0, feature_dim=8, appearance_dim=4, max_per_tile=64, lidar_max_per_tile=32)
    pipes = {mode: SplatADPipeline(outputs, SplatADPipelineConfig(
        model=SplatADConfig(**model, lidar_raster_mode=mode), cap_max=512,
        datamanager=FullImageLidarDataManagerConfig(max_lidar_points=256)), device="cpu")
        for mode in ("tiled", "points")}
    pipes["points"].model.load_state_dict(pipes["tiled"].model.state_dict())
    s = pipes["tiled"].datamanager._lidar_sample(pipes["tiled"].datamanager.train_lidars[0])
    with torch.no_grad():
        outs = {mode: p.model.get_lidar_outputs(s.l2w, s.raster_pts, s.time, s.sensor_idx) for mode, p in pipes.items()}
    for k in ("depth", "alpha", "intensity"):
        _close(outs["points"][k], outs["tiled"][k], rtol=2e-2, atol=2e-3, what=k)
    state = pipes["points"].init_state()
    state, metrics = pipes["points"].train_step(state, s)
    assert state.step == 1 and np.isfinite(float(metrics["total_loss"]))
    with pytest.raises(ValueError, match="lidar_raster_mode"):
        SplatADPipeline(outputs, SplatADPipelineConfig(model=SplatADConfig(**model, lidar_raster_mode="mesh"),
                                                       cap_max=512), device="cpu")
