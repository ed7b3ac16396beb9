"""The port's eval metrics (`neurad_tpu_torch/utils/eval_metrics.py`, the
exact LPIPS and Inception graphs, the weight converter, `chamfer_distance`)
against the JAX package's, on the same numpy inputs and the same seeded
weights. The weight files are written once by the port's converter and read by
both packages' loaders."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.core import math_utils as jmath
from neurad_tpu.model_components import inception as jinception
from neurad_tpu.model_components import lpips_exact as jlpips
from neurad_tpu.model_components.perceptual import load_vgg19_params as jax_vgg19
from neurad_tpu.scripts import convert_perceptual_weights as jconvert
from neurad_tpu.utils import eval_metrics as jem
from neurad_tpu_torch.core import math_utils as tmath
from neurad_tpu_torch.model_components import inception as tinception
from neurad_tpu_torch.model_components import lpips_exact as tlpips
from neurad_tpu_torch.model_components.perceptual import Vgg19Slices
from neurad_tpu_torch.params_from_jax import vgg_params_from_flax
from neurad_tpu_torch.scripts import convert_perceptual_weights as tconvert
from neurad_tpu_torch.utils import eval_metrics as tem

torch.set_num_threads(1)

# fp32 graphs of 13 (VGG16) and 94 (InceptionV3) convolutions, summed in other
# orders by XLA and by PyTorch's CPU kernels
LPIPS_TOL = dict(rtol=1e-4, atol=1e-6)
POOL3_TOL = dict(rtol=2e-3, atol=2e-4)  # as tests/model_components/test_perceptual_exact.py holds JAX to torch
# the Frechet distance takes the matrix root of a covariance of a few images:
# rank-deficient, so feature differences of 1e-6 move it more than the features
FID_TOL = dict(rtol=1e-3, atol=1e-4)


def _normal(rng, *shape, scale=0.1):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _conv_weight(rng, out_ch, in_ch, kh, kw):
    """He-scaled (std sqrt(2 / fan-in)), as trained networks keep their
    activations: at a fixed 0.1 the 94 Inception layers grow the pool3
    features to 1e9, where fp32 sums in another order differ by more than
    the tolerance without any fault."""
    return _normal(rng, out_ch, in_ch, kh, kw, scale=np.sqrt(2.0 / (in_ch * kh * kw)))


def _lpips_state(seed=0):
    rng = np.random.default_rng(seed)
    state = {}
    for fi, in_ch, out_ch in tlpips._VGG16_CONVS:
        state[f"features.{fi}.weight"] = _conv_weight(rng, out_ch, in_ch, 3, 3)
        state[f"features.{fi}.bias"] = _normal(rng, out_ch)
    for i, c in enumerate(tlpips._HEAD_CH):
        state[f"lin{i}.model.1.weight"] = np.abs(_normal(rng, 1, c, 1, 1))  # non-negative heads
    return state


def _inception_state(seed=0):
    rng = np.random.default_rng(seed)
    state = {}
    for name, in_ch, out_ch, k, _s, _p in tinception.conv_specs():
        state[f"{name}.conv.weight"] = _conv_weight(rng, out_ch, in_ch, k[0], k[1])
        state[f"{name}.bn.weight"] = 1.0 + _normal(rng, out_ch)
        state[f"{name}.bn.bias"] = _normal(rng, out_ch)
        state[f"{name}.bn.running_mean"] = _normal(rng, out_ch)
        state[f"{name}.bn.running_var"] = np.abs(1.0 + _normal(rng, out_ch))
    return state


def _vgg19_state(seed=0):
    rng = np.random.default_rng(seed)
    state, in_ch = {}, 3
    for idx, ch in zip(tconvert._VGG19_IDX, tconvert._VGG19_CH):
        state[f"features.{idx}.weight"] = _normal(rng, ch, in_ch, 3, 3)
        state[f"features.{idx}.bias"] = _normal(rng, ch)
        in_ch = ch
    return state


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The seeded LPIPS and Inception weights as .npz files written by the
    port's converter."""
    d = tmp_path_factory.mktemp("perceptual")
    np.savez(d / "lpips.npz", **tconvert.convert_lpips(_lpips_state()))
    np.savez(d / "inception.npz", **tconvert.convert_inception(_inception_state()))
    return {"lpips": str(d / "lpips.npz"), "inception": str(d / "inception.npz")}


@pytest.fixture
def no_weights(monkeypatch):
    for env in ("NEURAD_TPU_LPIPS_WEIGHTS", "NEURAD_TPU_INCEPTION_WEIGHTS", "NEURAD_TPU_VGG19_WEIGHTS"):
        monkeypatch.delenv(env, raising=False)


@pytest.fixture(scope="module")
def module_vggs():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("NEURAD_TPU_VGG19_WEIGHTS", raising=False)
        jv = jax_vgg19(jax.random.PRNGKey(0), sample_hw=16)
    tv = Vgg19Slices()
    tv.load_state_dict(vgg_params_from_flax(jv))
    return jv, tv.requires_grad_(False)


@pytest.fixture
def vggs(no_weights, module_vggs):
    """JAX's VGG19 fallback network from PRNGKey(0) and the port's with its
    weights carried across."""
    return module_vggs


def _images(seed, n, h, w):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------------------
# converters and loaders


@pytest.mark.parametrize("kind,state", [("vgg19", _vgg19_state), ("lpips", _lpips_state),
                                        ("inception", _inception_state)])
def test_converters_write_what_the_jax_converters_write(kind, state):
    s = state()
    mine, theirs = tconvert.CONVERTERS[kind](s), jconvert.CONVERTERS[kind](s)
    assert set(mine) == set(theirs)
    for k in mine:
        assert mine[k].dtype == np.float32 and np.array_equal(mine[k], theirs[k]), k


@pytest.mark.parametrize("kind,state,key,match", [
    ("vgg19", _vgg19_state, "features.5.weight", "vgg19 features.5"),
    ("lpips", _lpips_state, "features.0.weight", "features.0"),
    ("lpips", _lpips_state, "lin2.model.1.weight", "lin2"),
    ("inception", _inception_state, "Mixed_5b.branch1x1.conv.weight", "Mixed_5b.branch1x1"),
])
def test_converters_reject_bad_shapes(kind, state, key, match):
    s = state()
    s[key] = s[key][:, :-1]
    with pytest.raises(ValueError, match=match):
        tconvert.CONVERTERS[kind](s)


def test_lpips_converter_takes_the_lpips_package_layout():
    """The lpips package nests the backbone as net.slice{1..5}.<features index>."""
    flat = _lpips_state(3)
    nested = {f"net.slice{1 + sum(int(k.split('.')[1]) > b for b in (3, 8, 15, 22))}.{k[len('features.'):]}": v
              for k, v in flat.items() if k.startswith("features.")}
    nested.update({k: v for k, v in flat.items() if k.startswith("lin")})
    a, b = tconvert.convert_lpips(flat), tconvert.convert_lpips(nested)
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_lpips_loader_reads_what_jax_reads(weights):
    mine, theirs = tlpips.load_lpips_params(weights["lpips"]), jlpips.load_lpips_params(weights["lpips"])
    assert len(mine["convs"]) == len(theirs["convs"]) == 13
    for (w, b), (jw, jb) in zip(mine["convs"], theirs["convs"]):
        assert np.array_equal(w.permute(2, 3, 1, 0).numpy(), np.asarray(jw)) and np.array_equal(b.numpy(), jb)
    for h, jh in zip(mine["heads"], theirs["heads"]):
        assert np.array_equal(h.numpy(), np.asarray(jh))


def test_inception_loader_folds_batch_norm_as_jax(weights):
    mine, theirs = tinception.load_inception_params(weights["inception"]), \
        jinception.load_inception_params(weights["inception"])
    assert set(mine) == set(theirs) and len(mine) == len(tinception.conv_specs()) == 94
    for name, (w, b) in mine.items():
        jw, jb = theirs[name]
        np.testing.assert_allclose(w.permute(2, 3, 1, 0).numpy(), np.asarray(jw), rtol=1e-6, atol=0)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)


def test_loaders_check_shapes(tmp_path):
    s = tconvert.convert_lpips(_lpips_state())
    s["lin4.model.1.weight"] = s["lin4.model.1.weight"][:, :100]
    np.savez(tmp_path / "bad.npz", **s)
    with pytest.raises(ValueError, match="lin4"):
        tlpips.load_lpips_params(str(tmp_path / "bad.npz"))
    s = tconvert.convert_inception(_inception_state())
    s["Conv2d_1a_3x3.conv.weight"] = s["Conv2d_1a_3x3.conv.weight"][:16]
    np.savez(tmp_path / "bad_inc.npz", **s)
    with pytest.raises(ValueError, match="Conv2d_1a_3x3"):
        tinception.load_inception_params(str(tmp_path / "bad_inc.npz"))


# ---------------------------------------------------------------------------
# the exact graphs


@pytest.mark.parametrize("shape", [(2, 64, 48, 3), (40, 32, 3)])
def test_lpips_exact_matches_jax(weights, shape):
    rng = np.random.default_rng(1)
    pred, target = rng.uniform(0, 1, shape).astype(np.float32), rng.uniform(0, 1, shape).astype(np.float32)
    want = float(jlpips.lpips_exact(jlpips.load_lpips_params(weights["lpips"]), jnp.asarray(pred),
                                    jnp.asarray(target)))
    got = float(tlpips.lpips_exact(tlpips.load_lpips_params(weights["lpips"]), torch.from_numpy(pred),
                                   torch.from_numpy(target)))
    assert want > 0
    np.testing.assert_allclose(got, want, **LPIPS_TOL)


@pytest.mark.parametrize("hw,resize", [((299, 299), False), ((96, 128), True)])
def test_inception_pool3_matches_jax(weights, hw, resize):
    img = np.random.default_rng(7).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    want = np.asarray(jinception.inception_pool3(jinception.load_inception_params(weights["inception"]),
                                                 jnp.asarray(img), resize=resize))
    with torch.no_grad():
        got = tinception.inception_pool3(tinception.load_inception_params(weights["inception"]),
                                         torch.from_numpy(img), resize=resize).numpy()
    assert got.shape == want.shape == (1, 2048)
    np.testing.assert_allclose(got, want, **POOL3_TOL)


def _recording_frechet(monkeypatch, module):
    """Replace `module.frechet_distance` by a recorder of its four inputs
    (the matrix root of a 2048 x 2048 covariance takes seconds, and both
    packages take it with the same scipy call, held apart below)."""
    seen = []
    monkeypatch.setattr(module, "frechet_distance", lambda *stats: seen.append(stats) or 0.0)
    return seen


def test_exact_paths_match_jax_and_do_not_warn(weights, monkeypatch):
    """With both files named, `lpips` and `fid` take the exact graphs in both
    packages (no warning): the same LPIPS, and the same pool3 means and
    covariances handed to the Frechet distance. The port keeps one load per
    file and device."""
    monkeypatch.setenv("NEURAD_TPU_LPIPS_WEIGHTS", weights["lpips"])
    monkeypatch.setenv("NEURAD_TPU_INCEPTION_WEIGHTS", weights["inception"])
    a, b = _images(0, 2, 48, 64)
    reals, fakes = _images(1, 2, 24, 32), _images(2, 2, 24, 32)
    mine, theirs = _recording_frechet(monkeypatch, tem), _recording_frechet(monkeypatch, jem)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got_lpips = float(tem.lpips(None, torch.from_numpy(a), torch.from_numpy(b)))
        want_lpips = float(jem.lpips(None, jnp.asarray(a), jnp.asarray(b)))
        tem.fid(reals, fakes, device="cpu")
        jem.fid(reals, fakes)
        assert tem._exact_lpips_params(torch.device("cpu")) is tem._exact_lpips_params(torch.device("cpu"))
    np.testing.assert_allclose(got_lpips, want_lpips, **LPIPS_TOL)
    (mu1, s1, mu2, s2), (jmu1, js1, jmu2, js2) = mine[0], theirs[0]
    assert mu1.shape == (2048,) and s1.shape == (2048, 2048) and np.isfinite(s1).all()
    for got, want in ((mu1, jmu1), (mu2, jmu2)):
        np.testing.assert_allclose(got, want, **POOL3_TOL)
    for got, want in ((s1, js1), (s2, js2)):  # products of two features: twice their tolerance
        np.testing.assert_allclose(got, want, rtol=2 * POOL3_TOL["rtol"], atol=2 * POOL3_TOL["atol"] * np.abs(want).max())


# ---------------------------------------------------------------------------
# the fallbacks (VGG19 statistics) and the Frechet distance


def test_fallback_lpips_matches_jax_and_warns(vggs):
    jv, tv = vggs
    a, b = _images(3, 2, 32, 40)
    with pytest.warns(UserWarning, match="RELATIVE-ONLY"):
        got = float(tem.lpips(tv, torch.from_numpy(a), torch.from_numpy(b)))
    with pytest.warns(UserWarning, match="RELATIVE-ONLY"):
        want = float(jem.lpips(jv, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, **LPIPS_TOL)


def test_fallback_fid_matches_jax_and_warns(vggs, monkeypatch):
    """With the caller's VGG19 and with the fallback network (the port's of
    seed 0 replaced by JAX's PRNGKey(0) network carried across)."""
    jv, tv = vggs
    reals, fakes = _images(4, 3, 32, 40), _images(5, 3, 32, 40)
    with pytest.warns(UserWarning, match="RELATIVE-ONLY"):
        got = tem.fid(reals, fakes, vgg=tv, device="cpu")
    with pytest.warns(UserWarning, match="RELATIVE-ONLY"):
        want = jem.fid(reals, fakes, vgg_params=jv)
    np.testing.assert_allclose(got, want, **FID_TOL)
    monkeypatch.setattr(tem, "_fallback_vgg", lambda device: tv)
    with pytest.warns(UserWarning, match="RELATIVE-ONLY"):
        assert tem.fid(reals, fakes, device="cpu") == got


def test_fid_features_match_jax(vggs):
    jv, tv = vggs
    imgs = _images(6, 2, 32, 40)
    with torch.no_grad():
        got = tem._features_for_fid(tv, imgs, torch.device("cpu"))
    want = jem._features_for_fid(jv, imgs)
    assert got.shape == want.shape == (2, 512)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_fallback_vgg_is_drawn_once_per_device(no_weights):
    a = tem._fallback_vgg(torch.device("cpu"))
    assert a is tem._fallback_vgg(torch.device("cpu")) and not any(p.requires_grad for p in a.parameters())


def test_no_inception_weights_means_no_exact_fid(no_weights):
    assert tem._inception_params(torch.device("cpu")) is None
    assert tem._exact_lpips_params(torch.device("cpu")) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_frechet_distance_equals_jax(seed):
    rng = np.random.default_rng(seed)
    f1, f2 = rng.normal(size=(6, 8)), rng.normal(size=(6, 8)) + 0.5
    stats = lambda f: (f.mean(0), np.cov(f, rowvar=False) + 1e-6 * np.eye(8))
    (m1, s1), (m2, s2) = stats(f1), stats(f2)
    got = tem.frechet_distance(m1, s1, m2, s2)
    assert got == jem.frechet_distance(m1, s1, m2, s2) and got > 0
    assert tem.frechet_distance(m1, s1, m1, s1) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("sign", [1, -1])
def test_fid_suite_shifts_equal_jax(sign):
    assert tem.fid_suite_shifts(sign) == jem.fid_suite_shifts(sign)


def test_fid_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tem.fid(_images(0, 2, 8, 8), _images(1, 2, 8, 8))


# ---------------------------------------------------------------------------
# chamfer distance


@pytest.mark.parametrize("masks", ["none", "pred", "both", "no_valid_gt"])
def test_chamfer_distance_matches_jax(masks):
    rng = np.random.default_rng(9)
    pred, gt = _normal(rng, 150, 3, scale=5.0), _normal(rng, 97, 3, scale=5.0)
    pm = rng.uniform(size=150) < 0.7 if masks != "none" else None
    gm = {"none": None, "pred": None, "both": rng.uniform(size=97) < 0.6, "no_valid_gt": np.zeros(97, bool)}[masks]
    to_t = lambda x: None if x is None else torch.from_numpy(x)
    to_j = lambda x: None if x is None else jnp.asarray(x)
    got = float(tmath.chamfer_distance(to_t(pred), to_t(gt), to_t(pm), to_t(gm), chunk=64))
    want = float(jmath.chamfer_distance(to_j(pred), to_j(gt), to_j(pm), to_j(gm), chunk=64))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the chunk size does not change the result
    assert float(tmath.chamfer_distance(to_t(pred), to_t(gt), to_t(pm), to_t(gm))) == pytest.approx(got, rel=1e-6)
