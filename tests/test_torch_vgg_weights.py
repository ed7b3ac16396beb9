"""The VGG19 both packages fall back on, loaded from one weight file.

Without NEURAD_TPU_VGG19_WEIGHTS each package draws its VGG19 from its own
generator (JAX: `jax.random.PRNGKey(1234)` for the perceptual loss and
`PRNGKey(0)` for the FID fallback; the port: torch's generator from the same
seeds), and the two networks differ: the packages' perceptual losses, fallback
LPIPS and fallback FID are not comparable then. With one seeded `.npz` (keys
of torchvision's `vgg19.features`) through that variable, both load the same
network and agree: the perceptual loss, the fallback LPIPS and the fallback
FID to 1e-5 relative (fp32 convolutions on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.model_components import perceptual as JP
from neurad_tpu.utils import eval_metrics as JE
from neurad_tpu_torch.model_components import perceptual as TP
from neurad_tpu_torch.utils import eval_metrics as TE

torch.set_num_threads(1)


@pytest.fixture
def vgg_file(tmp_path, monkeypatch):
    """A seeded VGG19 in torchvision's layout, named by NEURAD_TPU_VGG19_WEIGHTS
    (the exact-LPIPS and Inception files unset: the fallbacks run)."""
    rng = np.random.default_rng(0)
    shapes = {k: tuple(v.shape) for k, v in TP.Vgg19Slices(torch.Generator().manual_seed(0)).state_dict().items()}
    arrays = {}
    for i, li in enumerate(TP._TORCHVISION_IDX):
        w = shapes[f"conv_{i}.weight"]
        arrays[f"features.{li}.weight"] = (rng.normal(size=w) * np.sqrt(2.0 / np.prod(w[1:]))).astype(np.float32)
        arrays[f"features.{li}.bias"] = rng.normal(0, 0.01, size=shapes[f"conv_{i}.bias"]).astype(np.float32)
    path = tmp_path / "vgg19.npz"
    np.savez(path, **arrays)
    monkeypatch.setenv("NEURAD_TPU_VGG19_WEIGHTS", str(path))
    monkeypatch.delenv("NEURAD_TPU_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("NEURAD_TPU_INCEPTION_WEIGHTS", raising=False)
    return path


def _images(seed, n=2, h=40, w=56):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    return base, np.clip(base + rng.normal(0, 0.1, base.shape), 0, 1).astype(np.float32)


def test_seeded_networks_differ_without_the_file(monkeypatch):
    monkeypatch.delenv("NEURAD_TPU_VGG19_WEIGHTS", raising=False)
    jw = np.asarray(JP.load_vgg19_params(jax.random.PRNGKey(1234))["params"]["conv_0"]["kernel"])
    tw = TP.load_vgg19_params(torch.Generator().manual_seed(1234)).conv_0.weight.detach().numpy()
    assert jw.transpose(3, 2, 0, 1).shape == tw.shape and not np.allclose(jw.transpose(3, 2, 0, 1), tw)


def test_one_weight_file_gives_both_packages_the_same_network(vgg_file):
    jv = JP.load_vgg19_params(jax.random.PRNGKey(1234))
    tv = TP.load_vgg19_params(torch.Generator().manual_seed(1234))
    raw = np.load(vgg_file)
    np.testing.assert_array_equal(tv.conv_0.weight.detach().numpy(), raw["features.0.weight"])
    np.testing.assert_array_equal(np.asarray(jv["params"]["conv_12"]["kernel"]).transpose(3, 2, 0, 1),
                                  tv.conv_12.weight.detach().numpy())

    pred, target = _images(1)
    want = float(JP.vgg_perceptual_loss(jv, jnp.asarray(pred), jnp.asarray(target)))
    got = float(TP.vgg_perceptual_loss(tv, torch.from_numpy(pred), torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, rtol=1e-5)

    with pytest.warns(UserWarning, match="VGG19"):
        want = float(JE.lpips(jv, jnp.asarray(pred), jnp.asarray(target)))
    with pytest.warns(UserWarning, match="VGG19") as caught:
        got = float(TE.lpips(tv, torch.from_numpy(pred), torch.from_numpy(target)))
    assert not any("not the JAX package's network" in str(w.message) for w in caught), "the file is set"
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got > 0


def test_fallback_fid_agrees_through_the_file(vgg_file):
    real, fake = _images(2, n=3)
    with pytest.warns(UserWarning):
        want = JE.fid(list(real), list(fake))
    with pytest.warns(UserWarning):
        got = TE.fid(list(real), list(fake), device="cpu")
    assert np.isfinite(want) and want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_the_warning_says_the_seeded_network_is_not_jaxs(monkeypatch):
    monkeypatch.delenv("NEURAD_TPU_VGG19_WEIGHTS", raising=False)
    monkeypatch.delenv("NEURAD_TPU_LPIPS_WEIGHTS", raising=False)
    pred, target = _images(3, n=1)
    with pytest.warns(UserWarning, match="not the JAX package's network"):
        TE.lpips(TP.load_vgg19_params(torch.Generator().manual_seed(0)), torch.from_numpy(pred),
                 torch.from_numpy(target))
