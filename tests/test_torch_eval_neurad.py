"""The eval slice of NeuRAD: the port's `ADPipeline.eval_metrics`,
`eval_fid_suite` and `_actor_pixel_mask` against the JAX package's on a
synthetic scene with an actor and two eval frames.

Size: tests/test_torch_neurad.py's `neurad-tiny` widths with fp32 reads and
MLP proposals, tables livened and the actor 1.5 m ahead, as there.
Parameters go across with `params_from_jax`, and so do the VGG19 networks of
the LPIPS and FID fallbacks (JAX's PRNGKey(1234) and PRNGKey(0) networks).

Tolerances: the renders agree to 3e-6 (fp32, MLP proposals), the metrics as
in tests/test_torch_eval_pipelines.py (1e-4 relative; depth metrics 1e-3;
FID 2e-2, for the matrix root of a rank-1 covariance); LPIPS of VGG19
features 1e-4. The ray-drop accuracy counts rays whose logit passes 0, so it
is held to one ray of the scan. The actor mask is host numpy on both sides:
bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.data.datamanager import ADDataManagerConfig as JDMC
from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
from neurad_tpu.fields import neurad_encoding as JE
from neurad_tpu.models import neurad as JM
from neurad_tpu.pipelines.ad_pipeline import ADPipeline as JADPipe
from neurad_tpu.pipelines.ad_pipeline import ADPipelineConfig as JADCfg
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.fields import neurad_encoding as TE
from neurad_tpu_torch.models import neurad as TM
from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline as TADPipe
from neurad_tpu_torch.pipelines.ad_pipeline import ADPipelineConfig as TADCfg

from test_torch_eval_pipelines import SPLIT, check_metrics, fallbacks, fid_vgg, jax_vgg, no_weight_files  # noqa: F401
from test_torch_neurad import _overrides, _scaled

torch.set_num_threads(1)

NEURAD_SCENE = dict(SPLIT, image_height=36, image_width=48, lidar_channels=8, lidar_azimuths=60)
CHUNK = 128


def _port_config(**kw):
    return TADCfg(eval_chunk=CHUNK, model_overrides=_overrides(TE, TM, loss=TM.LossSettings(vgg_mult=0.0),
                                                               compute_fp32=True, **kw))


@pytest.fixture(scope="module")
def neurad():
    jout = JSynth(**NEURAD_SCENE).setup().get_dataparser_outputs()
    tout = TSynth(**NEURAD_SCENE).setup().get_dataparser_outputs()
    for out in (jout, tout):  # the actor rides 1.5 m ahead of the ego vehicle, as in test_torch_neurad.py
        traj = out.trajectories[0]
        ts = np.asarray(traj["timestamps"])
        traj["poses"] = np.array(traj["poses"])
        traj["poses"][:, :3, 3] = np.stack([2.0 * ts + 1.5, np.full(len(ts), 0.1), np.full(len(ts), 1.5)], -1)
        traj["dims"] = np.array([1.2, 1.2, 1.2], np.float32)
    jcfg = JADCfg(datamanager=JDMC(num_cam_patches=2, patch_size=4, num_lidar_rays=64), eval_chunk=CHUNK,
                  eval_shard=False, model_overrides=_overrides(JE, JM, loss=JM.LossSettings(vgg_mult=0.0),
                                                               proposal_mode="mlp", compute_fp32=True))
    jp = JADPipe(jout, jcfg)
    jstate, _ = jp.init_state()
    tree = _scaled(jstate.params)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, tree))
    tp = TADPipe(tout, _port_config(proposal_mode="mlp"), device="cpu")
    tp.model.load_state_dict(bridge.neurad_params_from_flax(tree, tp.model.state_dict()))
    jp.vgg_params, tp.vgg = jax_vgg(1234)  # what each eval_metrics draws (from seed 1234) when unset
    return jp, jstate, tp


def test_neurad_eval_metrics_match_jax(neurad, fallbacks):
    jp, state, tp = neurad
    want, got = jp.eval_metrics(state), tp.eval_metrics()
    assert set(want) == {"psnr", "ssim", "lpips", "actor_psnr", "actor_coverage", "depth_median_l2",
                         "depth_mean_rel_l2", "intensity_rmse", "ray_drop_accuracy", "chamfer_distance"}
    assert want["actor_coverage"] > 0, "the actor is in view"
    check_metrics(got, want, drop_atol=1.0 / (NEURAD_SCENE["lidar_channels"] * NEURAD_SCENE["lidar_azimuths"]) + 1e-9)


def test_neurad_fid_suite_matches_jax(neurad, fallbacks):
    jp, state, tp = neurad
    want, got = jp.eval_fid_suite(state, max_images=2), tp.eval_fid_suite(max_images=2)
    assert set(want) == {"fid_actor_shift_rot", "fid_actor_shift_trans", "fid_lane_shift_2m", "fid_lane_shift_3m",
                         "fid_vertical_shift_1m"}
    check_metrics(got, want)


def test_neurad_eval_without_actors_or_eval_split(fallbacks):
    """A scene without actors has no actor mask and no actor metrics; one
    without eval cameras or scans scores nothing."""
    out = TSynth(**NEURAD_SCENE).setup().get_dataparser_outputs()
    p = TADPipe(dataclasses.replace(out, trajectories=[], eval_camera_indices=(7,), eval_lidar_indices=()),
                _port_config(), device="cpu")
    assert p._actor_pixel_mask(7, 12, 16) is None
    m = p.eval_metrics()
    assert set(m) == {"psnr", "ssim", "lpips"} and all(np.isfinite(v) for v in m.values())
    p.outputs = dataclasses.replace(p.outputs, eval_camera_indices=())
    assert p.eval_metrics() == {} and p.eval_fid_suite() == {}


@pytest.mark.parametrize("hw", [(12, 16), (36, 48), (7, 30)])
def test_actor_pixel_mask_equals_jax(neurad, hw):
    jp, _, tp = neurad
    for ci in range(NEURAD_SCENE["num_frames"]):
        want = jp._actor_pixel_mask(ci, *hw)
        got = tp._actor_pixel_mask(ci, *hw)
        assert got.dtype == bool and np.array_equal(got, want), ci
    assert any(tp._actor_pixel_mask(ci, *hw).any() for ci in range(NEURAD_SCENE["num_frames"]))
