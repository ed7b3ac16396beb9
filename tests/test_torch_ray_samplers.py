"""The port's ray generation, samplers and volume-rendering primitives against
the JAX package's, same numpy inputs. Everything here is fp32 elementwise
arithmetic on both sides (sin / cos / pow differ in the last ulp between XLA
and torch): 1e-6 absolute on unit directions, 2e-5 relative on distances and
evenly spaced sample positions, exact on integer and boolean metadata. After
an inverse-CDF resampling the bins in spacing units [0, 1] are held to 5e-6 (the
interpolation divides by a CDF step that the cumulative sums leave a few ulps
apart; measured 3.2e-6);
the power spacing maps them to distances over a 1e6 range with a slope that
grows without bound towards 1, so a last-ulp difference in a bin moves a far
sample by up to 1e-4 of its distance: distances are held to 2e-4 relative and
a bin's width to 2e-4 of its far edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.cameras import cameras as JC
from neurad_tpu.cameras import lidars as JL
from neurad_tpu.core import math_utils as JMU
from neurad_tpu.core.structs import RayBundle as JBundle
from neurad_tpu.model_components import ray_samplers as JRS
from neurad_tpu.ops import rendering as JR
from neurad_tpu_torch.cameras import cameras as TC
from neurad_tpu_torch.cameras import lidars as TL
from neurad_tpu_torch.core import math_utils as TMU
from neurad_tpu_torch.core.structs import RayBundle as TBundle
from neurad_tpu_torch.model_components import ray_samplers as TRS
from neurad_tpu_torch.ops import rendering as TR

torch.set_num_threads(1)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _close(got, want, atol=1e-6, rtol=2e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _cameras(cam_type, rolling_shutter, distortion, n=3, seed=0):
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0].astype(np.float32)
    c2w = np.concatenate([q, rng.normal(size=(n, 3, 1)).astype(np.float32) * 5], -1)
    fields = dict(
        camera_to_worlds=c2w, fx=np.full((n, 1), 50.0, np.float32), fy=np.full((n, 1), 55.0, np.float32),
        cx=np.full((n, 1), 36.0, np.float32), cy=np.full((n, 1), 24.0, np.float32),
        width=np.full((n, 1), 72, np.int32), height=np.full((n, 1), 48, np.int32),
        camera_type=np.full((n, 1), int(cam_type), np.int32),
        times=rng.uniform(0, 2, (n, 1)).astype(np.float32),
    )
    if distortion:
        fields["distortion_params"] = rng.normal(size=(n, 6)).astype(np.float32) * 0.02
    metadata = {"sensor_idxs": np.arange(n, dtype=np.int32)[:, None]}
    if rolling_shutter is not None:
        metadata.update(velocities=rng.normal(size=(n, 3)).astype(np.float32),
                        rolling_shutter_time=np.full((n, 1), 0.03, np.float32),
                        time_to_center_pixel=np.full((n, 1), 0.01, np.float32),
                        rs_direction=np.full((n, 1), int(rolling_shutter), np.int32))
    jcams = JC.Cameras(**{k: jnp.asarray(v) for k, v in fields.items()},
                       metadata={k: jnp.asarray(v) for k, v in metadata.items()})
    tcams = TC.Cameras(**{k: _t(v) for k, v in fields.items()}, metadata={k: _t(v) for k, v in metadata.items()})
    return jcams, tcams


def _compare_bundles(tb, jb):
    _close(tb.origins, jb.origins)
    _close(tb.directions, jb.directions, rtol=0)
    _close(tb.pixel_area, jb.pixel_area, atol=0, rtol=5e-4)  # a difference of nearly equal unit vectors
    _close(tb.times, jb.times)
    _close(tb.fars, jb.fars)
    np.testing.assert_array_equal(tb.camera_indices.numpy(), np.asarray(jb.camera_indices))
    assert set(tb.metadata) == set(jb.metadata)
    for key, value in jb.metadata.items():
        if np.asarray(value).dtype.kind in "biu":
            np.testing.assert_array_equal(tb.metadata[key].numpy(), np.asarray(value))
        else:
            _close(tb.metadata[key], value)


@pytest.mark.parametrize("cam_type", [JC.CameraType.PERSPECTIVE, JC.CameraType.FISHEYE, JC.CameraType.EQUIRECTANGULAR,
                                      JC.CameraType.ORTHOPHOTO], ids=lambda t: t.name.lower())
@pytest.mark.parametrize("distortion", [False, True], ids=["plain", "distorted"])
def test_generate_rays_matches_per_camera_type(cam_type, distortion):
    jcams, tcams = _cameras(cam_type, None, distortion)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 3, 200).astype(np.int32)
    coords = (rng.uniform(0, 1, (200, 2)) * [48, 72]).astype(np.float32)
    jb = JC.generate_rays(jcams, jnp.asarray(idx), jnp.asarray(coords))
    tb = TC.generate_rays(tcams, _t(idx), _t(coords))
    _compare_bundles(tb, jb)
    assert int(TC.CameraType(int(cam_type))) == int(cam_type)


@pytest.mark.parametrize("direction", list(JC.RollingShutterDirection), ids=lambda d: d.name.lower())
def test_generate_rays_matches_with_rolling_shutter(direction):
    jcams, tcams = _cameras(JC.CameraType.PERSPECTIVE, direction, False)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 3, 150).astype(np.int32)
    coords = (rng.uniform(0, 1, (150, 2)) * [48, 72]).astype(np.float32)
    corr = np.concatenate([np.linalg.qr(rng.normal(size=(150, 3, 3)))[0], rng.normal(size=(150, 3, 1)) * 0.1], -1)
    corr = corr.astype(np.float32)
    jb = JC.generate_rays(jcams, jnp.asarray(idx), jnp.asarray(coords), camera_opt_to_camera=jnp.asarray(corr))
    tb = TC.generate_rays(tcams, _t(idx), _t(coords), camera_opt_to_camera=_t(corr))
    _compare_bundles(tb, jb)
    assert float(np.abs(np.asarray(jb.times) - np.asarray(jcams.times)[idx]).max()) > 1e-3, "times are offset per pixel"
    assert "rolling_shutter_time" not in tb.metadata and "velocities" in tb.metadata
    np.testing.assert_array_equal(TC.full_image_coords(5, 7).numpy(), np.asarray(JC.full_image_coords(5, 7)))


@pytest.mark.parametrize("ego_compensated", [True, False])
@pytest.mark.parametrize("columns", [4, 5, 6])
def test_generate_lidar_rays_matches(ego_compensated, columns):
    rng = np.random.default_rng(3)
    n = 4
    l2w = np.concatenate([np.linalg.qr(rng.normal(size=(n, 3, 3)))[0], rng.normal(size=(n, 3, 1)) * 5], -1).astype(np.float32)
    fields = dict(lidar_to_worlds=l2w, lidar_type=np.full((n, 1), 5, np.int32),
                  times=rng.uniform(0, 2, (n, 1)).astype(np.float32))
    metadata = dict(velocities=rng.normal(size=(n, 3)).astype(np.float32), sensor_idxs=np.ones((n, 1), np.int32))
    kw = dict(assume_ego_compensated=ego_compensated, valid_lidar_distance_threshold=40.0)
    jl = JL.Lidars(**{k: jnp.asarray(v) for k, v in fields.items()}, metadata={k: jnp.asarray(v) for k, v in metadata.items()}, **kw)
    tl = TL.Lidars(**{k: _t(v) for k, v in fields.items()}, metadata={k: _t(v) for k, v in metadata.items()}, **kw)
    pts = (rng.normal(size=(300, columns)) * [30, 30, 3, 1, 0.05, 1][:columns]).astype(np.float32)
    idx = rng.integers(0, n, 300).astype(np.int32)
    jb = JL.generate_lidar_rays_from_points(jl, jnp.asarray(idx), jnp.asarray(pts))
    tb = TL.generate_lidar_rays_from_points(tl, _t(idx), _t(pts))
    _compare_bundles(tb, jb)
    assert tb.metadata["did_return"].dtype == torch.bool and 0 < float(tb.metadata["did_return"].float().mean()) < 1
    pose = l2w[0]
    _close(TL.transform_points(_t(pts[:, :3]), _t(pose)), JL.transform_points(jnp.asarray(pts[:, :3]), jnp.asarray(pose)), atol=1e-5)
    _close(TL.transform_points_pairwise(_t(pts[:, :3]), _t(l2w[idx])),
           JL.transform_points_pairwise(jnp.asarray(pts[:, :3]), jnp.asarray(l2w[idx])), atol=1e-5)


def _bundles(r, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    fields = dict(origins=rng.normal(size=(r, 3)).astype(np.float32), directions=d / np.linalg.norm(d, axis=-1, keepdims=True),
                  pixel_area=np.full((r, 1), 1e-5, np.float32), nears=rng.uniform(0, 1, (r, 1)).astype(np.float32),
                  fars=rng.uniform(50, 1000, (r, 1)).astype(np.float32), times=rng.uniform(0, 1, (r, 1)).astype(np.float32),
                  camera_indices=rng.integers(0, 3, (r, 1)).astype(np.int32))
    return (JBundle(**{k: jnp.asarray(v) for k, v in fields.items()}, metadata={"x": jnp.ones((r, 1))}),
            TBundle(**{k: _t(v) for k, v in fields.items()}, metadata={"x": torch.ones(r, 1)}))


def _compare_samples(ts, js, resampled=False):
    for name in ("origins", "directions", "pixel_area"):
        _close(getattr(ts.frustums, name), getattr(js.frustums, name), atol=1e-5)
    for name in ("starts", "ends"):
        _close(getattr(ts.frustums, name), getattr(js.frustums, name), atol=1e-5, rtol=2e-4 if resampled else 2e-5)
    for name in ("spacing_starts", "spacing_ends", "times"):
        _close(getattr(ts, name), getattr(js, name), atol=5e-6 if resampled else 2e-6, rtol=0)
    if resampled:
        assert (np.abs(ts.deltas.numpy() - np.asarray(js.deltas)) <= 2e-4 * np.asarray(js.frustums.ends) + 1e-5).all()
    else:
        _close(ts.deltas, js.deltas, atol=1e-5)
    np.testing.assert_array_equal(ts.camera_indices.numpy(), np.asarray(js.camera_indices))
    assert set(ts.metadata) == set(js.metadata)


SPACINGS = ["UNIFORM", "LIN_DISP", "SQRT", "LOG", "UNIFORM_LIN_DISP_PIECEWISE", "power"]


def _spacing(mod, name):
    return mod.power_spacing(-1.0, 0.1) if name == "power" else getattr(mod, name)


@pytest.mark.parametrize("name", SPACINGS)
def test_spaced_sampler_matches(name):
    jb, tb = _bundles(30, 4)
    if name == "LOG":  # log(0) at a zero near
        jb, tb = jb.replace(nears=jb.nears + 0.1), tb.replace(nears=tb.nears + 0.1)
    _compare_samples(TRS.spaced_sampler(tb, 12, _spacing(TRS, name)), JRS.spaced_sampler(jb, 12, _spacing(JRS, name)))
    # explicit shared draws: the JAX side draws from its key, the port is handed the same numbers
    for single in (True, False):
        key = jax.random.PRNGKey(3)
        js = JRS.spaced_sampler(jb, 12, _spacing(JRS, name), key=key, single_jitter=single)
        draws = np.array(jax.random.uniform(key, (30, 1) if single else (30, 13)))
        _compare_samples(TRS.spaced_sampler(tb, 12, _spacing(TRS, name), jitter=_t(draws)), js)
    # the gaussian approximation of the frustums
    for m in (1, 3):
        jg = JRS.spaced_sampler(jb, 12, _spacing(JRS, name)).frustums.get_fast_isotropic_gaussian(m)
        tg = TRS.spaced_sampler(tb, 12, _spacing(TRS, name)).frustums.get_fast_isotropic_gaussian(m)
        _close(tg.mean, jg.mean, atol=1e-4)
        _close(tg.std, jg.std, atol=1e-7, rtol=1e-4)


def test_power_fns_and_aabb_match():
    x = np.random.default_rng(5).uniform(0, 50, 200).astype(np.float32)
    for lam in (-1.5, -1.0, 0, 1, 0.5, 2e10, -2e10):
        xs = x / 100 if abs(lam) > 1e10 else x
        _close(TMU.power_fn(_t(xs), lam), JMU.power_fn(jnp.asarray(xs), lam))
        _close(TMU.inv_power_fn(_t(xs / 60), lam), JMU.inv_power_fn(jnp.asarray(xs / 60), lam))
    rng = np.random.default_rng(6)
    o, d = rng.normal(size=(100, 3)).astype(np.float32) * 3, rng.normal(size=(100, 3)).astype(np.float32)
    d[:5, 0] = 0.0
    aabb = np.array([-1, -2, -1, 2, 2, 3], np.float32)
    want = JMU.intersect_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb))
    got = TMU.intersect_aabb(_t(o), _t(d), _t(aabb))
    _close(got[0], want[0])
    _close(got[1], want[1])
    v = rng.normal(size=(10, 3)).astype(np.float32)
    v[0] = 0
    _close(TMU.safe_normalize(_t(v)), JMU.safe_normalize(jnp.asarray(v)))


def test_searchsorted_and_gather_equal_the_dense_forms():
    """`torch.searchsorted(right=True)` and `torch.gather` against the JAX
    package's dense comparison forms, ties and out-of-range queries included."""
    rng = np.random.default_rng(7)
    a = np.sort(rng.uniform(0, 1, (20, 17)).astype(np.float32), -1)
    a[:, 5] = a[:, 4]  # ties
    v = rng.uniform(-0.1, 1.1, (20, 9)).astype(np.float32)
    v[:, 0] = a[:, 4]
    v[:, 1] = a[:, 0]
    v[:, 2] = a[:, -1]
    for side, right in (("right", True), ("left", False)):
        want = np.asarray(JMU.searchsorted_dense(jnp.asarray(a), jnp.asarray(v), side=side))
        np.testing.assert_array_equal(torch.searchsorted(_t(a), _t(v), right=right).numpy(), want)
    idx = rng.integers(0, 17, (20, 9))
    want = np.asarray(JMU.take_along_small(jnp.asarray(a), jnp.asarray(idx)))
    np.testing.assert_array_equal(torch.gather(_t(a), -1, _t(idx)).numpy(), want)


@pytest.mark.parametrize("include_original", [False, True])
def test_pdf_sampler_matches_on_identical_weights(include_original):
    jb, tb = _bundles(40, 8)
    spacing_j, spacing_t = JRS.power_spacing(-1.0, 0.1), TRS.power_spacing(-1.0, 0.1)
    js0, ts0 = JRS.spaced_sampler(jb, 16, spacing_j), TRS.spaced_sampler(tb, 16, spacing_t)
    w = np.random.default_rng(9).uniform(0, 1, (40, 16, 1)).astype(np.float32) ** 4
    w[0] = 0.0  # an empty histogram
    w[1, 3:] = 0.0
    for key, single in ((None, False), (jax.random.PRNGKey(1), True), (jax.random.PRNGKey(2), False)):
        js = JRS.pdf_sampler(jb, js0, jnp.asarray(w), 10, spacing_j, key=key, single_jitter=single,
                             include_original=include_original)
        draws = None if key is None else _t(np.array(jax.random.uniform(key, (40, 1) if single else (40, 11))))
        ts = TRS.pdf_sampler(tb, ts0, _t(w), 10, spacing_t, jitter=draws, include_original=include_original)
        _compare_samples(ts, js, resampled=True)
        assert not ts.spacing_starts.requires_grad


def test_proposal_sampler_matches():
    jb, tb = _bundles(25, 10)
    jdens = lambda s: 0.05 + jnp.sin(s.frustums.starts * 0.3) ** 2 * (1.0 + s.times[..., :1])
    tdens = lambda s: 0.05 + torch.sin(s.frustums.starts * 0.3) ** 2 * (1.0 + s.times[..., :1])
    for key in (None, jax.random.PRNGKey(4)):
        js, jw, jl = JRS.proposal_sampler(jb, [jdens, jdens], (16, 12), 8, spacing=JRS.power_spacing(-1.0, 0.1), key=key)
        jitters = None
        if key is not None:
            keys = jax.random.split(key, 3)
            jitters = [_t(np.array(jax.random.uniform(k, (25, 1)))) for k in keys]
        ts, tw, tl = TRS.proposal_sampler(tb, [tdens, tdens], (16, 12), 8, spacing=TRS.power_spacing(-1.0, 0.1),
                                          jitters=jitters)
        _compare_samples(ts, js, resampled=True)
        assert len(tw) == len(tl) == 2 and ts.deltas.shape == (25, 8, 1)
        for a, b in zip(tw, jw):
            _close(a, b, atol=2e-5, rtol=1e-3)
        for a, b in zip(tl, jl):
            _compare_samples(a, b, resampled=True)
        _close(ts.get_weights(tdens(ts)), js.get_weights(jdens(js)), atol=2e-5, rtol=1e-3)


def test_rendering_matches():
    rng = np.random.default_rng(11)
    alphas = rng.uniform(0, 1, (30, 12, 1)).astype(np.float32) ** 2
    dens = rng.uniform(0, 3, (30, 12, 1)).astype(np.float32)
    dens[0] = np.inf  # nan_to_num path
    deltas = rng.uniform(0.1, 2, (30, 12, 1)).astype(np.float32)
    vals = rng.normal(size=(30, 12, 5)).astype(np.float32)
    steps = np.cumsum(deltas, 1)
    jw, jt = JR.render_weights_from_alpha(jnp.asarray(alphas))
    tw, tt = TR.render_weights_from_alpha(_t(alphas))
    _close(tw, jw)
    _close(tt, jt)
    jw2, tw2 = JR.render_weights_from_density(jnp.asarray(dens), jnp.asarray(deltas)), TR.render_weights_from_density(_t(dens), _t(deltas))
    _close(tw2, jw2)
    _close(TR.accumulate_along_rays(tw, _t(vals)), JR.accumulate_along_rays(jw, jnp.asarray(vals)), atol=1e-5)
    _close(TR.accumulate_along_rays(tw), JR.accumulate_along_rays(jw))
    _close(TR.render_depth_expected(tw, _t(steps)), JR.render_depth_expected(jw, jnp.asarray(steps)), atol=1e-5)
    tw[1] = 0.0
    jw = jw.at[1].set(0.0)  # no crossing: the last step
    _close(TR.render_depth_median(tw, _t(steps)), JR.render_depth_median(jw, jnp.asarray(steps)))
    from neurad_tpu.core.structs import RaySamples as JSamples
    from neurad_tpu_torch.core.structs import RaySamples as TSamples
    jw3, jt3 = JSamples.get_weights_and_transmittance_from_alphas(jnp.asarray(alphas))
    tw3, tt3 = TSamples.get_weights_and_transmittance_from_alphas(_t(alphas))
    _close(tw3, jw3)
    _close(tt3, jt3)
