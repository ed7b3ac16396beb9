"""The port's generative guidance (`neurad_tpu_torch/generative/`) against
the JAX package's, case by case as `tests/test_generative.py` runs it: the
noise schedule, `add_noise`, classifier-free guidance, the SDS loss and its
gradient, the gate on `diffusers`, and the positional prompt embeddings
(discrete, interpolated, off, validation).

Inputs are numpy arrays from a fixed seed, fed to both packages. Tolerances:
the schedule to 1e-5 relative (a cumulative product of up to 1000 fp32
factors, which XLA and torch round differently; `tests/test_generative.py`
holds JAX's to the float64 product at the same bound); the noised latents to
1e-6 relative; the SDS loss and its gradient
(`torch.autograd` against `jax.grad`) to 1e-5 relative; CFG and the
embeddings' selections and blends to 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.generative import PositionalTextEmbeddings as JPositional
from neurad_tpu.generative import stable_diffusion as JSD
from neurad_tpu_torch.generative import PositionalTextEmbeddings, StableDiffusionGuidance, scaled_linear_alphas_cumprod
from neurad_tpu_torch.generative import stable_diffusion as TSD

torch.set_num_threads(1)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _latents(seed=0, shape=(2, 4, 8, 8)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("steps", [100, 1000])
def test_schedule_matches_jax(steps):
    got = scaled_linear_alphas_cumprod(steps)
    want = JSD.scaled_linear_alphas_cumprod(steps)
    assert got.shape == (steps,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    assert np.all(np.diff(_np(got)) < 0) and 0.0 < float(got[-1]) < 1.0
    # the closed form, as the JAX test holds it
    betas = np.linspace(0.00085**0.5, 0.012**0.5, steps) ** 2
    np.testing.assert_allclose(_np(got), np.cumprod(1 - betas), rtol=1e-5)


@pytest.mark.parametrize("t", [0, 37, 99])
def test_add_noise_matches_jax(t):
    lat, noise, _ = _latents(1)
    a_t, a_j = scaled_linear_alphas_cumprod(100), JSD.scaled_linear_alphas_cumprod(100)
    got = TSD.add_noise(torch.from_numpy(lat), torch.from_numpy(noise), a_t, t)
    want = JSD.add_noise(jnp.asarray(lat), jnp.asarray(noise), a_j, jnp.asarray(t))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    # the endpoints of the JAX test: t = 0 keeps the latents nearly clean
    if t == 0:
        assert float((got - torch.from_numpy(lat)).abs().max()) < 0.15


def test_cfg_matches_jax():
    text, uncond, _ = _latents(2, (3, 5))
    got = TSD.classifier_free_guidance(torch.from_numpy(text), torch.from_numpy(uncond), 7.5)
    want = JSD.classifier_free_guidance(jnp.asarray(text), jnp.asarray(uncond), 7.5)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    small = TSD.classifier_free_guidance(torch.tensor([1.0, 2.0]), torch.tensor([0.5, 1.0]), 10.0)
    np.testing.assert_allclose(_np(small), [6.0, 12.0])


@pytest.mark.parametrize("t", [20, 500, 980])
def test_sds_loss_and_gradient_match_jax(t):
    """The loss and d loss / d latents = w(t) (noise_pred - noise) / B, by
    torch.autograd against jax.grad; no gradient reaches noise_pred."""
    lat, noise, pred = _latents(3)
    a_t, a_j = scaled_linear_alphas_cumprod(1000), JSD.scaled_linear_alphas_cumprod(1000)
    lat_t = torch.from_numpy(lat).requires_grad_(True)
    pred_t = torch.from_numpy(pred).requires_grad_(True)
    loss = TSD.sds_loss(lat_t, torch.from_numpy(noise), pred_t, a_t, t)
    loss.backward()
    j_loss, j_grad = jax.value_and_grad(lambda l: JSD.sds_loss(l, jnp.asarray(noise), jnp.asarray(pred), a_j,
                                                               jnp.asarray(t)))(jnp.asarray(lat))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(_np(lat_t.grad), np.asarray(j_grad), rtol=1e-5, atol=1e-7)
    w = 1.0 - float(a_t[t])
    np.testing.assert_allclose(_np(lat_t.grad), w * (pred - noise) / lat.shape[0], rtol=1e-5, atol=1e-7)
    assert pred_t.grad is None


def test_sds_loss_zeroes_nan_scores_as_jax_does():
    lat, noise, pred = _latents(4, (1, 4, 2, 2))
    pred[0, 1, 0, 0] = np.nan
    a_t, a_j = scaled_linear_alphas_cumprod(1000), JSD.scaled_linear_alphas_cumprod(1000)
    lat_t = torch.from_numpy(lat).requires_grad_(True)
    TSD.sds_loss(lat_t, torch.from_numpy(noise), torch.from_numpy(pred), a_t, 300).backward()
    j_grad = jax.grad(lambda l: JSD.sds_loss(l, jnp.asarray(noise), jnp.asarray(pred), a_j, jnp.asarray(300)))(
        jnp.asarray(lat))
    assert float(lat_t.grad[0, 1, 0, 0]) == 0.0
    np.testing.assert_allclose(_np(lat_t.grad), np.asarray(j_grad), rtol=1e-5, atol=1e-7)


def test_sds_loss_for_image_draws_from_the_callers_generator():
    """`sds_loss_for_image` with the UNet replaced by a fixed function (no
    backbone here): t and the noise come from the generator, so the same
    seed gives the same loss, and the gradient is the SDS one for that noise."""
    guidance = object.__new__(StableDiffusionGuidance)  # without __post_init__: no diffusers, no weights
    guidance.min_step, guidance.max_step = 20, 980
    guidance.alphas_cumprod = scaled_linear_alphas_cumprod(1000)
    guidance.predict_noise = lambda noisy, t, emb: (0.5 * noisy, 2.0 * noisy)
    lat = torch.from_numpy(_latents(5, (1, 4, 8, 8))[0]).requires_grad_(True)
    losses = [guidance.sds_loss_for_image(torch.Generator().manual_seed(7), lat, None, guidance_scale=3.0)
              for _ in range(2)]
    assert losses[0].item() == losses[1].item()
    gen = torch.Generator().manual_seed(7)
    t = int(torch.randint(20, 981, (), generator=gen))
    noise = torch.randn(lat.shape, generator=gen)
    assert 20 <= t <= 980
    noisy = TSD.add_noise(lat.detach(), noise, guidance.alphas_cumprod, t)
    pred = TSD.classifier_free_guidance(2.0 * noisy, 0.5 * noisy, 3.0)
    losses[0].backward()
    w = 1.0 - guidance.alphas_cumprod[t]
    np.testing.assert_allclose(_np(lat.grad), _np(w * (pred - noise)), rtol=1e-5, atol=1e-7)


def test_backbone_is_gated_on_diffusers():
    with pytest.raises(ImportError, match="diffusers"):
        StableDiffusionGuidance()
    with pytest.raises(ImportError, match="diffusers"):
        JSD.StableDiffusionGuidance()
    assert (TSD.IMG_DIM, TSD.CONST_SCALE, TSD.SD_IDENTIFIERS) == (JSD.IMG_DIM, JSD.CONST_SCALE, JSD.SD_IDENTIFIERS)


def _embeds(seed=6):
    rng = np.random.default_rng(seed)
    keys = ("base", "top", "side", "back", "front")
    return {k: rng.standard_normal((2, 4, 8)).astype(np.float32) for k in keys}


ANGLES = [(20.0, 0.0), (80.0, 0.0), (80.0, 45.0), (80.0, 46.0), (80.0, 90.0), (80.0, 135.0), (80.0, 180.0),
          (80.0, 225.0), (80.0, 270.0), (80.0, 315.0), (80.0, 359.0), (80.0, -90.0), (80.0, 725.0), (40.0, 100.0),
          (90.0, 45.0), (0.0, 45.0), (-10.0, 200.0), (63.0, 301.5)]


@pytest.mark.parametrize("mode", ["discrete", "interpolated", "off"])
def test_positional_embeddings_match_jax(mode):
    e = _embeds()
    port = PositionalTextEmbeddings({k: torch.from_numpy(v) for k, v in e.items()}, mode)
    ref = JPositional({k: jnp.asarray(v) for k, v in e.items()}, mode)
    for vert, horiz in ANGLES:
        np.testing.assert_allclose(_np(port(vert, horiz)), np.asarray(ref(vert, horiz)), rtol=1e-6, atol=1e-6,
                                   err_msg=f"{mode} at ({vert}, {horiz})")


def test_positional_discrete_picks_the_views_of_the_jax_test():
    e = {k: torch.full((2, 4, 8), float(i)) for i, k in enumerate(("base", "top", "side", "back", "front"))}
    p = PositionalTextEmbeddings(e, "discrete")
    picks = [float(p(v, h)[0, 0, 0]) for v, h in [(20.0, 0.0), (80.0, 0.0), (80.0, 90.0), (80.0, 180.0),
                                                  (80.0, 270.0), (80.0, 359.0), (80.0, -90.0)]]
    assert picks == [1.0, 4.0, 2.0, 3.0, 2.0, 4.0, 2.0]
    q = PositionalTextEmbeddings(e, "interpolated")
    assert float(q(90.0, 45.0)[0, 0, 0]) == pytest.approx(0.5 * 4.0 + 0.5 * 2.0)
    assert float(q(0.0, 45.0)[0, 0, 0]) == pytest.approx(1.0)


def test_positional_validation_matches_jax():
    e = {k: torch.from_numpy(v) for k, v in _embeds().items()}
    assert float(PositionalTextEmbeddings(e, "off")(10.0, 10.0)[0, 0, 0]) == float(e["base"][0, 0, 0])
    for cls, embeds in ((PositionalTextEmbeddings, e), (JPositional, {k: jnp.asarray(v) for k, v in _embeds().items()})):
        with pytest.raises(ValueError, match="missing"):
            cls({"base": embeds["base"]}, "off")
        with pytest.raises(ValueError, match="unknown"):
            cls(embeds, "nope")
