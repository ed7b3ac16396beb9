"""NeuRAD's loss terms in the port against the JAX package's, same numpy
inputs: the histogram losses (ZipNeRF interlevel per ray and mean,
MipNeRF-360 interlevel and distortion), the carving mask, `compute_losses`
(every key, and its gradient with respect to the outputs), the VGG
perceptual loss with the JAX package's arrays carried across, and the
`searchsorted` the port uses where the JAX package has `searchsorted_dense`.

Tolerances: fp32 on both sides in another order of operations: 1e-5 relative
for values and 1e-5 of the largest entry for gradients (measured 1e-6); the
VGG stack's thirteen convolutions sum 9 * C terms each in another order: 1e-4
relative (measured 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.core.math_utils import searchsorted_dense
from neurad_tpu.core.structs import Frustums as JFrustums
from neurad_tpu.core.structs import RaySamples as JRaySamples
from neurad_tpu.model_components import losses as JL
from neurad_tpu.model_components import perceptual as JP
from neurad_tpu.model_components.dynamic_actors import empty_actor_data as j_empty
from neurad_tpu.models import neurad as JM
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.core.structs import Frustums as TFrustums
from neurad_tpu_torch.core.structs import RaySamples as TRaySamples
from neurad_tpu_torch.model_components import losses as TL
from neurad_tpu_torch.model_components import perceptual as TP
from neurad_tpu_torch.model_components.dynamic_actors import empty_actor_data as t_empty
from neurad_tpu_torch.models import neurad as TM

torch.set_num_threads(1)

RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _histograms(seed, r=40, sizes=(12, 8, 6)):
    """Per round: sorted bin edges [R, S + 1] in [0, 1] and weights [R, S, 1]
    (the field's round sums to below 1, some bins empty)."""
    rng = np.random.default_rng(seed)
    sdists, weights = [], []
    for s in sizes:
        edges = np.sort(rng.uniform(0.0, 1.0, (r, s + 1)), axis=-1).astype(np.float32)
        edges[:, 0], edges[:, -1] = 0.0, 1.0
        w = rng.uniform(0.0, 1.0, (r, s)).astype(np.float32) * (rng.uniform(size=(r, s)) > 0.2)
        w = (w / w.sum(-1, keepdims=True) * rng.uniform(0.5, 1.0, (r, 1))).astype(np.float32)
        sdists.append(edges)
        weights.append(w[..., None])
    return sdists, weights


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * max(float(np.abs(want).max()), 1e-12))


@pytest.mark.parametrize("per_ray", [True, False], ids=["per_ray", "mean"])
def test_zipnerf_interlevel_loss_and_its_gradient_match(per_ray):
    sdists, weights = _histograms(0)

    def jloss(w0, w1):
        return jnp.sum(JL.zipnerf_interlevel_loss([w0, w1, jnp.asarray(weights[2])], [jnp.asarray(s) for s in sdists],
                                                  per_ray=per_ray))

    want = JL.zipnerf_interlevel_loss([jnp.asarray(w) for w in weights], [jnp.asarray(s) for s in sdists],
                                      per_ray=per_ray)
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(weights[0]), jnp.asarray(weights[1]))
    tw = [_t(w).requires_grad_(i < 2) for i, w in enumerate(weights)]
    got = TL.zipnerf_interlevel_loss(tw, [_t(s) for s in sdists], per_ray=per_ray)
    assert got.shape == ((40,) if per_ray else ()) and float(got.detach().sum()) > 0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=1e-9)
    got.sum().backward()
    for t, g in zip(tw[:2], jg):
        _grad_close(t.grad.numpy(), g)


def test_interlevel_and_distortion_losses_match():
    sdists, weights = _histograms(1)
    jw, js = [jnp.asarray(w) for w in weights], [jnp.asarray(s) for s in sdists]
    tw, ts = [_t(w).requires_grad_(True) for w in weights], [_t(s) for s in sdists]
    want = JL.interlevel_loss(jw, js)
    got = TL.interlevel_loss(tw, ts)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    assert float(got.detach()) > 0
    np.testing.assert_allclose(TL.lossfun_distortion(ts[-1], tw[-1][..., 0]).detach().numpy(),
                               np.asarray(JL.lossfun_distortion(js[-1], jw[-1][..., 0])), rtol=RTOL)
    np.testing.assert_allclose(float(TL.distortion_loss(tw, ts)), float(JL.distortion_loss(jw, js)), rtol=RTOL)
    # gradients: of the interlevel loss into the proposal weights, of the distortion into the field's
    (got + TL.distortion_loss(tw, ts)).backward()
    jg = jax.grad(lambda w: JL.interlevel_loss(w, js) + JL.distortion_loss(w, js))(jw)
    for t, g in zip(tw, jg):
        _grad_close(t.grad.numpy(), g)
    sp = np.sort(np.random.default_rng(2).uniform(size=(5, 7, 1)), axis=1).astype(np.float32)
    np.testing.assert_array_equal(TL.ray_samples_to_sdist(_t(sp[:, :-1]), _t(sp[:, 1:])).numpy(),
                                  np.asarray(JL.ray_samples_to_sdist(jnp.asarray(sp[:, :-1]), jnp.asarray(sp[:, 1:]))))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_matches_the_dense_form(side):
    """The port's `_searchsorted` counts what `searchsorted_dense` counts, ties
    and exact hits included, on sorted input (where it is torch.searchsorted)
    and on the unsorted edges the ZipNeRF loss searches (0 before -r, 1 after
    1 + r), where torch.searchsorted's binary search answers otherwise."""
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 20, (30, 16)).astype(np.float32), axis=-1)  # repeated edges
    v = np.concatenate([rng.uniform(-1, 21, (30, 10)), a[:, ::3]], axis=-1).astype(np.float32)
    want = np.asarray(searchsorted_dense(jnp.asarray(a), jnp.asarray(v), side=side))
    got = TL._searchsorted(_t(a), _t(v), side=side).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got == 16).any()
    np.testing.assert_array_equal(torch.searchsorted(_t(a), _t(v), right=side == "right").numpy(), want)
    edges = np.sort(rng.uniform(0, 1, (30, 8)), axis=-1).astype(np.float32)
    unsorted = np.concatenate([np.zeros((30, 1)), edges - 0.03, edges + 0.03, np.ones((30, 1))], -1).astype(np.float32)
    unsorted[:, 1:-1] = np.sort(unsorted[:, 1:-1], axis=-1)
    q = rng.uniform(-0.05, 1.05, (30, 12)).astype(np.float32)
    want = np.asarray(searchsorted_dense(jnp.asarray(unsorted), jnp.asarray(q), side=side))
    np.testing.assert_array_equal(TL._searchsorted(_t(unsorted), _t(q), side=side).numpy(), want)
    assert (torch.searchsorted(_t(unsorted), _t(q), right=side == "right").numpy() != want).any()


def _samples(seed, r=30, s=9):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0.0, 200.0, (r, s, 1)), axis=1).astype(np.float32)
    ends = (starts + rng.uniform(0.01, 0.3, (r, s, 1))).astype(np.float32)
    origins = np.zeros((r, s, 3), np.float32)
    dirs = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (r, s, 1))
    area = np.full((r, s, 1), 1e-4, np.float32)
    deltas = ends - starts
    jsmp = JRaySamples(frustums=JFrustums(origins=jnp.asarray(origins), directions=jnp.asarray(dirs),
                                          starts=jnp.asarray(starts), ends=jnp.asarray(ends),
                                          pixel_area=jnp.asarray(area)), deltas=jnp.asarray(deltas))
    tsmp = TRaySamples(frustums=TFrustums(origins=_t(origins), directions=_t(dirs), starts=_t(starts), ends=_t(ends),
                                          pixel_area=_t(area)), deltas=_t(deltas))
    mids = (starts + ends)[..., 0] / 2
    ranges = mids[np.arange(r), rng.integers(0, s, r)][:, None] + rng.uniform(-0.05, 0.05, (r, 1)).astype(np.float32)
    return jsmp, tsmp, ranges.astype(np.float32), rng


def test_carving_mask_matches():
    jsmp, tsmp, ranges, rng = _samples(4)
    is_lidar = rng.uniform(size=30) > 0.3
    did_return = rng.uniform(size=(30, 1)) > 0.3
    jmodel = JM.NeuRADModel(actor_data=j_empty(), static_scale=10.0)
    tmodel = TM.NeuRADModel(actor_data=t_empty(), static_scale=10.0, **_tiny())
    for dr in (did_return, None):
        want = jmodel.apply({}, jsmp, jnp.asarray(is_lidar), jnp.asarray(ranges),
                            None if dr is None else jnp.asarray(dr), method=JM.NeuRADModel._carving_mask)
        got = tmodel._carving_mask(tsmp, _t(is_lidar), _t(ranges), None if dr is None else _t(dr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert bool(got.any()) and not bool(got.all())


def _tiny():
    from neurad_tpu_torch.configs.method_configs import neurad_tiny_overrides

    return neurad_tiny_overrides()


def _outputs_and_batch(seed, n_cam_patches=2, d=4, n_lidar=50, rounds=2):
    rng = np.random.default_rng(seed)
    n_cam = n_cam_patches * d * d
    r = n_cam + n_lidar
    dist = rng.uniform(2.0, 60.0, (n_lidar, 1)).astype(np.float32)
    out = {
        "rgb": rng.uniform(0, 1, (n_cam_patches, 3 * d, 3 * d, 3)).astype(np.float32),
        "depth": rng.uniform(1.0, 80.0, (r, 1)).astype(np.float32),
        "intensity": rng.uniform(0, 1, (n_lidar, 1)).astype(np.float32),
        "ray_drop_logits": rng.normal(size=(n_lidar, 1)).astype(np.float32),
        "carving_per_ray": rng.uniform(0, 0.1, r).astype(np.float32),
        "interlevel_per_ray": rng.uniform(0, 0.1, r).astype(np.float32),
        "distortion_per_ray": rng.uniform(0, 0.1, r).astype(np.float32),
        "accumulation": rng.uniform(0, 1, (r, 1)).astype(np.float32),
    }
    for i in range(rounds):
        out[f"prop_depth_{i}"] = rng.uniform(1.0, 80.0, (r, 1)).astype(np.float32)
        out[f"prop_carving_per_ray_{i}"] = rng.uniform(0, 0.1, r).astype(np.float32)
    did_return = rng.uniform(size=(n_lidar, 1)) > 0.2
    batch = {
        "image": rng.uniform(0, 1, (n_cam_patches, 3 * d, 3 * d, 3)).astype(np.float32),
        "distance": dist, "did_return": did_return,
        "intensity": rng.uniform(0, 1, (n_lidar, 1)).astype(np.float32),
    }
    return out, batch, n_cam


def test_compute_losses_matches_every_key_and_gradient():
    out, batch, n_cam = _outputs_and_batch(5)
    jmodel = JM.NeuRADModel(actor_data=j_empty(), static_scale=10.0)
    tmodel = TM.NeuRADModel(actor_data=t_empty(), static_scale=10.0, **dict(_tiny(), loss=TM.LossSettings()))
    diff_keys = ("rgb", "depth", "intensity", "ray_drop_logits", "carving_per_ray", "interlevel_per_ray",
                 "distortion_per_ray", "prop_depth_0", "prop_depth_1", "prop_carving_per_ray_1")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(diff):
        o = {k: jnp.asarray(v) for k, v in out.items()}
        o.update(diff)
        return jmodel.apply({}, o, jb, n_cam, method=JM.NeuRADModel.compute_losses)

    (jtotal, jmetrics), jgrads = jax.value_and_grad(jloss, has_aux=True)({k: jnp.asarray(out[k]) for k in diff_keys})
    tout = {k: _t(v).requires_grad_(k in diff_keys) for k, v in out.items()}
    ttotal, tmetrics = tmodel.compute_losses(tout, {k: _t(v) for k, v in batch.items()}, n_cam)
    assert set(tmetrics) == set(jmetrics) and len(tmetrics) == 16
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=RTOL)
    for key, value in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[key]), float(value), rtol=RTOL, atol=1e-9, err_msg=key)
    ttotal.backward()
    for key in diff_keys:
        assert tout[key].grad is not None, key
        _grad_close(tout[key].grad.numpy(), jgrads[key])


def test_vgg_perceptual_loss_matches_with_carried_arrays():
    rng = np.random.default_rng(6)
    jparams = JP.load_vgg19_params(jax.random.PRNGKey(0), sample_hw=24)
    vgg = TP.Vgg19Slices()
    vgg.load_state_dict(bridge.vgg_params_from_flax(jax.tree.map(np.asarray, jparams)))
    pred = rng.uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
    want, jg = jax.value_and_grad(lambda p: JP.vgg_perceptual_loss(jparams, p, jnp.asarray(target)))(jnp.asarray(pred))
    tp = _t(pred).requires_grad_(True)
    got = TP.vgg_perceptual_loss(vgg, tp, _t(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    got.backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-4 * float(np.abs(jg).max()))
    # the five slices' shapes, NHWC, pooling stopping at 1 px
    feats = vgg(_t(pred))
    assert [tuple(f.shape) for f in feats] == [(2, 24, 24, 64), (2, 12, 12, 128), (2, 6, 6, 256), (2, 3, 3, 512),
                                               (2, 1, 1, 512)]
    tiny = vgg(torch.rand(1, 2, 2, 3))
    assert tiny[-1].shape == (1, 1, 1, 512) and bool(torch.isfinite(tiny[-1]).all())


def test_vgg_random_fallback_draws_flax_default_init():
    """Without pretrained weights the network is flax's default conv init
    (truncated normal at two standard deviations, variance 1 / fan-in, zero
    bias), drawn from the generator it is given."""
    a = TP.load_vgg19_params(torch.Generator().manual_seed(1234))
    b = TP.load_vgg19_params(torch.Generator().manual_seed(1234))
    c = TP.load_vgg19_params(torch.Generator().manual_seed(5))
    jparams = JP.load_vgg19_params(jax.random.PRNGKey(1234), sample_hw=24)["params"]
    for i in range(13):
        w = getattr(a, f"conv_{i}").weight.detach()
        assert torch.equal(w, getattr(b, f"conv_{i}").weight) and not torch.equal(w, getattr(c, f"conv_{i}").weight)
        jw = np.asarray(jparams[f"conv_{i}"]["kernel"])
        std = np.sqrt(1.0 / (9 * w.shape[1]))
        assert abs(float(w.std()) / std - 1.0) < 0.05 and abs(float(jw.std()) / std - 1.0) < 0.05
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
        assert float(getattr(a, f"conv_{i}").bias.abs().max()) == 0.0
    assert not any(p.requires_grad for p in a.parameters())
