"""The eval slice of SplatAD: the port's `SplatADPipeline.eval_metrics`,
`eval_fid_suite` and `render_virtual_lidar` against the JAX package's on a
synthetic scene with an actor and two eval frames. NeuRAD's are in
tests/test_torch_eval_neurad.py, the eval script and the train loop's
periodic eval in tests/test_torch_eval_script.py; the helpers here serve all
three.

Size: a 64 x 64 camera (16 tiles: the JAX side runs its Pallas kernels in
interpret mode), 3000 gaussians, the serving tests' `SMALL` tiles, fp32
decoders on both sides (the JAX module patched as in
tests/test_torch_splatad_train.py). Parameters go across with
`params_from_jax`, and so does the VGG19 network of the FID fallback (JAX's
PRNGKey(0) network).

Tolerances. The renders agree to 1e-5 (fp32), so PSNR and SSIM are held to
1e-4 relative. The depth metrics are squared errors of depths held to 1e-5
relative, averaged or their median taken: 1e-3 relative. FID: the Frechet
distance of two images' features takes the matrix root of a rank-1
covariance (plus 1e-6 on the diagonal), which magnifies the features'
last-bit differences: 2e-2 relative.
"""

import functools
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
from neurad_tpu.data.full_image_datamanager import FullImageLidarDataManagerConfig as JFDMC
from neurad_tpu.model_components.perceptual import load_vgg19_params as jax_vgg19
from neurad_tpu.models import splatad as JS
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipeline as JSPipe
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipelineConfig as JSCfg
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.data.full_image_datamanager import FullImageLidarDataManagerConfig as TFDMC
from neurad_tpu_torch.model_components.perceptual import Vgg19Slices
from neurad_tpu_torch.models import splatad as TS
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline as TSPipe
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipelineConfig as TSCfg
from neurad_tpu_torch.utils import eval_metrics as tem

from test_torch_splatad import SMALL

torch.set_num_threads(1)

METRIC_RTOL = 1e-4
DEPTH_RTOL = 1e-3
FID_RTOL = 2e-2
WEIGHT_FILES = ("NEURAD_TPU_LPIPS_WEIGHTS", "NEURAD_TPU_INCEPTION_WEIGHTS", "NEURAD_TPU_VGG19_WEIGHTS")
# 8 frames, the last 2 held out: two eval cameras and scans (the FID of one image is NaN in both packages)
SPLIT = dict(num_frames=8, train_split_fraction=0.75)
SPLAT_SCENE = dict(SPLIT, image_height=64, image_width=64, focal=45.0, lidar_channels=16, lidar_azimuths=180)
# what JAX's SplatAD eval returns on a scene with eval cameras, scans and an actor (held below)
SPLATAD_EVAL_KEYS = {"psnr", "ssim", "depth_median_l2", "depth_mean_rel_l2"}
SPLATAD_FID_KEYS = {"fid_actor_shift_rot", "fid_actor_shift_trans", "fid_lane_shift_2m", "fid_lane_shift_3m",
                    "fid_vertical_shift_1m"}


def torch_vgg(tree):
    vgg = Vgg19Slices()
    vgg.load_state_dict(bridge.vgg_params_from_flax(tree))
    return vgg.requires_grad_(False)


def jax_vgg(seed):
    """JAX's fallback VGG19 network of PRNGKey(seed) (no weight file) and the
    port's copy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("NEURAD_TPU_VGG19_WEIGHTS", raising=False)
        tree = jax_vgg19(jax.random.PRNGKey(seed))
    return tree, torch_vgg(tree)


@pytest.fixture(scope="module")
def fid_vgg():
    return jax_vgg(0)[1]


@pytest.fixture
def no_weight_files(monkeypatch):
    """No weight files: the metrics take their VGG19 fallbacks, whose warning
    (at every call) is silenced."""
    for env in WEIGHT_FILES:
        monkeypatch.delenv(env, raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield


@pytest.fixture
def fallbacks(monkeypatch, no_weight_files, fid_vgg):
    """No weight files; the port's FID fallback network is JAX's PRNGKey(0)
    network carried across."""
    monkeypatch.setattr(tem, "_fallback_vgg", lambda device: fid_vgg)


def check_metrics(got, want, drop_atol=0.0):
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        assert np.isfinite(g), k
        if k.startswith("fid"):
            tol = dict(rtol=FID_RTOL)
        elif k.startswith("depth"):
            tol = dict(rtol=DEPTH_RTOL)
        elif k == "ray_drop_accuracy":
            tol = dict(atol=drop_atol)
        else:
            tol = dict(rtol=METRIC_RTOL, atol=1e-6)
        np.testing.assert_allclose(g, w, err_msg=k, **tol)


@pytest.fixture(scope="module")
def splatad():
    mp = pytest.MonkeyPatch()  # fp32 decoders in the JAX model (no switch; flax builds them at every apply)
    mp.setattr(JS, "RGBDecoderCNN", functools.partial(JS.RGBDecoderCNN, compute_dtype=jnp.float32))
    mp.setattr(JS, "MLP", functools.partial(JS.MLP, compute_dtype=jnp.float32))
    jp = JSPipe(JSynth(**SPLAT_SCENE).setup().get_dataparser_outputs(),
                JSCfg(model=JS.SplatADConfig(**SMALL), cap_max=3000, datamanager=JFDMC(max_lidar_points=4096)))
    params = jax.jit(lambda key: jp.model.init(key, method=JS.SplatADModel.init_all))(jax.random.PRNGKey(0))
    tp = TSPipe(TSynth(**SPLAT_SCENE).setup().get_dataparser_outputs(),
                TSCfg(model=TS.SplatADConfig(**SMALL), cap_max=3000, datamanager=TFDMC(max_lidar_points=4096)),
                device="cpu")
    tp.model.load_state_dict(bridge.splatad_params_from_flax(jax.tree.map(np.asarray, params)))
    for module in tp.model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.float32
    yield jp, types.SimpleNamespace(params=params), tp
    mp.undo()


def test_splatad_eval_metrics_match_jax(splatad):
    jp, state, tp = splatad
    assert tp.outputs.eval_camera_indices == (6, 7) and tp.model.actor_data.n_actors == 1
    want, got = jp.eval_metrics(state), tp.eval_metrics()
    assert set(want) == SPLATAD_EVAL_KEYS
    check_metrics(got, want)


def test_splatad_fid_suite_matches_jax(splatad, fallbacks):
    jp, state, tp = splatad
    want, got = jp.eval_fid_suite(state, max_images=2), tp.eval_fid_suite(max_images=2)
    assert set(want) == SPLATAD_FID_KEYS
    check_metrics(got, want)
    assert tp.eval_fid_suite(max_images=0) == {}


def test_splatad_virtual_lidar_matches_jax(splatad):
    jp, state, tp = splatad
    origin, edits = np.array([4.0, 0.5, 1.5]), [0.5, 0.0, 0.3, 0.0]
    want = jp.render_virtual_lidar(state.params, origin, 1.3, channels=8, azim_res_deg=4.0, edits_vec=edits)
    got = tp.render_virtual_lidar(origin, 1.3, channels=8, azim_res_deg=4.0, edits_vec=edits)
    assert got.shape == want.shape and got.shape[1] == 4 and got.shape[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
