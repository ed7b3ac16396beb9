"""The NeuRAD serving slice as a whole: the port's `ADPipeline` eval renders,
viewer renders and closed-loop server against the JAX package's on the
synthetic scene, at `neurad-tiny` widths, parameters carried across by
`neurad_params_from_flax`.

Both packages initialise hash tables at 1e-3; the carried tables are scaled by
300 so that the fields' features are O(0.3), and the SDF head's bias is set to
0.08 so that a sample's alpha is about 0.03-0.6 (at a zero bias the first
sample of every ray is nearly opaque): geometry, actors and samplers then all
matter to the picture. An untrained proposal field has density 1 per metre, so
the samples of a ray gather in its first 2.5 m; the scene's actor is therefore
moved to 1.5 m in front of the camera (0.6 m boxes), where samples hit it.

Tolerances. `compute_fp32=True` (fp32 table reads, fp32 MLPs and decoders):
both sides do the same fp32 arithmetic up to summation order, but a resampled
sample can move by an ulp and cross a cell face of a cell-packed level, where
features jump, and the decoder's GroupNorm spreads one changed ray over the
image; rgb is held to 5e-4 on 99% of the values and 5e-3 everywhere (measured
<= 1.5e-4 with hash-grid proposals, 3e-6 with MLP proposals), depth to 5e-4
relative on 99% of the rays and 2e-2 everywhere (measured 1e-4, and 3.8e-3 on
the one ray of the shared-proposal case whose sample crossed a face), lidar
intensity and ray-drop logits to 5e-4. At the bf16 default XLA and torch round the
lookups, MLPs and convolutions at different points: rgb, intensity and ray-drop
logits within 4e-2 everywhere and rgb within 1.5e-2 on 98% of the values
(measured max 1.4e-2); depth within 5% everywhere and within 1% on 98% of the
rays (measured max 0.13%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.data.datamanager import ADDataManagerConfig as JDMC
from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
from neurad_tpu.fields import neurad_encoding as JE
from neurad_tpu.model_components.cnns import RGBDecoderCNN as JDecoder
from neurad_tpu.model_components.dynamic_actors import ActorEdits as JEdits
from neurad_tpu.models import neurad as JM
from neurad_tpu.pipelines.ad_pipeline import ADPipeline as JPipe
from neurad_tpu.pipelines.ad_pipeline import ADPipelineConfig as JPipeCfg
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.cameras.camera_optimizers import CameraOptimizer as TCamOpt
from neurad_tpu_torch.core.structs import RayBundle as TBundle
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.fields import neurad_encoding as TE
from neurad_tpu_torch.model_components.cnns import RGBDecoderCNN as TDecoder
from neurad_tpu_torch.model_components.dynamic_actors import ActorEdits as TEdits
from neurad_tpu_torch.models import neurad as TM
from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline as TPipe
from neurad_tpu_torch.pipelines.ad_pipeline import ADPipelineConfig as TPipeCfg
from neurad_tpu_torch.scripts import closed_loop as TCL

torch.set_num_threads(1)

TABLE_GAIN = 300.0
SDF_BIAS = 0.08
SCENE = dict(num_frames=3, image_height=36, image_width=48, lidar_channels=8, lidar_azimuths=60)
CHUNK = 128  # 12 x 16 = 192 camera rays: two chunks, the second padded


def _overrides(E, M, **kw):
    prop = E.StaticSettings(num_levels=2, base_res=16, max_res=128, log2_hashmap_size=11, hashgrid_dim=1)
    d = dict(
        sampling=M.SamplingSettings(num_proposal_samples=(24, 16), num_nerf_samples=16, sky_distance=1000.0),
        field_static=E.StaticSettings(num_levels=4, base_res=16, max_res=256, log2_hashmap_size=13, hashgrid_dim=4),
        field_actor=E.ActorSettings(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=11, hashgrid_dim=4),
        proposal_static=(prop, prop),
        proposal_actor=E.ActorSettings(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=9, hashgrid_dim=1),
        appearance_dim=4, max_actors_per_ray=1,
    )
    d.update(kw)
    return d


def _scaled(tree):
    def walk(node):
        if isinstance(node, dict):
            return {k: (tuple(np.asarray(t) * TABLE_GAIN for t in v) if k.endswith("hash_table") else walk(v))
                    for k, v in node.items()}
        return np.asarray(node)
    out = walk(jax.tree.map(np.asarray, tree))
    bias = np.array(out["params"]["field"]["mlp_geo"]["output"]["bias"])
    bias[0] = SDF_BIAS
    out["params"]["field"]["mlp_geo"]["output"]["bias"] = bias
    return out


_CACHE = {}


def _pipelines(mode, fp32):
    """(JAX pipeline, its state with scaled tables, the port's pipeline with the same parameters)."""
    if (mode, fp32) not in _CACHE:
        jout = JSynth(**SCENE).setup().get_dataparser_outputs()
        tout = TSynth(**SCENE).setup().get_dataparser_outputs()
        for out in (jout, tout):  # the actor rides 1.5 m ahead of the ego vehicle (which drives +x at 2 m/s)
            traj = out.trajectories[0]
            traj["poses"] = np.array(traj["poses"])
            traj["poses"][:, :3, 3] = np.stack([2.0 * np.asarray(traj["timestamps"]) + 1.5,
                                                np.full(len(traj["timestamps"]), 0.1), np.full(len(traj["timestamps"]), 1.5)], -1)
            traj["dims"] = np.array([1.2, 1.2, 1.2], np.float32)
        jcfg = JPipeCfg(datamanager=JDMC(num_cam_patches=2, patch_size=4, num_lidar_rays=64), eval_chunk=CHUNK,
                        eval_shard=False, model_overrides=_overrides(JE, JM, loss=JM.LossSettings(vgg_mult=0.0),
                                                                     proposal_mode=mode, compute_fp32=fp32))
        jp = JPipe(jout, jcfg)
        state, _ = jp.init_state()
        tree = _scaled(state.params)
        state = state.replace(params=jax.tree.map(jnp.asarray, tree))
        tp = TPipe(tout, TPipeCfg(eval_chunk=CHUNK, model_overrides=_overrides(TE, TM, proposal_mode=mode,
                                                                              compute_fp32=fp32)), device="cpu")
        missing = tp.model.load_state_dict(bridge.neurad_params_from_flax(tree, tp.model.state_dict()))
        assert not missing.missing_keys and not missing.unexpected_keys
        _CACHE[(mode, fp32)] = (jp, state, tp)
    return _CACHE[(mode, fp32)]


def _check_rgb(got, want, fp32):
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    if fp32:
        assert diff.max() <= 5e-3 and (diff > 5e-4).mean() <= 0.01, (diff.max(), (diff > 5e-4).mean())
    else:
        assert diff.max() <= 4e-2 and (diff > 1.5e-2).mean() <= 0.02, (diff.max(), (diff > 1.5e-2).mean())


def _check_depth(got, want, fp32):
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    if fp32:
        assert rel.max() <= 2e-2 and (rel > 5e-4).mean() <= 0.01, (rel.max(), (rel > 5e-4).mean())
    else:
        assert rel.max() <= 0.05 and (rel > 0.01).mean() <= 0.02, (rel.max(), (rel > 0.01).mean())


@pytest.mark.parametrize("mode,fp32", [("mlp", True), ("hashgrid", True), ("mlp", False), ("hashgrid", False),
                                       ("hashgrid-shared", True)],
                         ids=["fp32-mlp", "fp32-hashgrid", "bf16-mlp", "bf16-hashgrid", "fp32-hashgrid-shared"])
def test_render_eval_camera_and_lidar_match(mode, fp32):
    jp, state, tp = _pipelines(mode, fp32)
    want, jgt = jp.render_eval_camera(state, 1)
    got, tgt = tp.render_eval_camera(1)
    assert got.shape == (36, 48, 3) and want.std() > 0.02, "the picture is not flat"
    np.testing.assert_array_equal(tgt, jgt)
    _check_rgb(got, want, fp32)

    jl, tl = jp.render_eval_lidar(state, 2), tp.render_eval_lidar(2)
    assert set(jl) == set(tl) and tl["depth"].shape[0] == jp.outputs.point_clouds[2].shape[0] > CHUNK
    for key in ("gt_distance", "gt_intensity", "did_return", "origins", "directions"):
        np.testing.assert_allclose(tl[key], np.asarray(jl[key]), atol=1e-6)
    _check_depth(tl["depth"], jl["depth"], fp32)
    tol = 5e-4 if fp32 else 4e-2
    np.testing.assert_allclose(tl["intensity"], jl["intensity"], atol=tol)
    np.testing.assert_allclose(tl["ray_drop_logits"], jl["ray_drop_logits"], atol=tol)
    assert float(np.std(jl["depth"])) > 0.02, float(np.std(jl["depth"]))


def test_actor_edits_and_viewer_renders_match():
    jp, state, tp = _pipelines("mlp", True)
    edit = dict(lateral=1.0, longitudinal=-2.0, rotation=0.4, height=0.2)
    want, _ = jp.render_eval_camera(state, 0, edits=JEdits(**edit))
    got, _ = tp.render_eval_camera(0, edits=TEdits(**edit))
    _check_rgb(got, want, True)
    assert np.abs(got - tp.render_eval_camera(0)[0]).max() > 1e-3, "the edit shows"

    c2w = np.asarray(jp.outputs.cameras.camera_to_worlds[1])
    ev = [0.5, 0.0, -0.3, 0.0, 9.0]  # a fifth element (another model's) is ignored
    want = jp.render_viewer_image(state.params, c2w, 10, 8, 0.7, ev)
    got = tp.render_viewer_image(c2w, 10, 8, 0.7, ev)
    assert got.shape == (24, 30, 3)
    _check_rgb(got, want, True)

    origin = np.array([2.0, 0.0, 2.0], np.float32)
    want = jp.render_virtual_lidar(state.params, origin, 0.5, channels=4, azim_res_deg=15.0, drop_threshold=0.6)
    got = tp.render_virtual_lidar(origin, 0.5, channels=4, azim_res_deg=15.0, drop_threshold=0.6)
    assert got.shape == want.shape and got.shape[0] > 10
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-4)


def test_query_geometry_and_model_outputs_match():
    jp, state, tp = _pipelines("hashgrid", True)
    pts = np.random.default_rng(0).uniform(-5, 30, (50, 3)).astype(np.float32)
    want = jp.model.apply(state.params, jnp.asarray(pts), 0.4, method=JM.NeuRADModel.query_geometry)
    with torch.no_grad():
        got = tp.model.query_geometry(torch.from_numpy(pts), 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # a mixed batch: 2 camera patches of 4 x 4 rays, then lidar rays, through get_outputs
    jb, _ = jp.datamanager.next_train()
    arrays = jax.tree.map(np.array, jb)
    tb = TBundle(origins=torch.from_numpy(arrays.origins), directions=torch.from_numpy(arrays.directions),
                 pixel_area=torch.from_numpy(arrays.pixel_area),
                 camera_indices=torch.from_numpy(arrays.camera_indices).long(),
                 nears=torch.from_numpy(arrays.nears), fars=torch.from_numpy(arrays.fars),
                 times=torch.from_numpy(arrays.times),
                 metadata={k: torch.from_numpy(v) for k, v in arrays.metadata.items()})
    want = jp.model.apply(state.params, jb, (4, 4), 32, method=JM.NeuRADModel.get_outputs)
    with torch.no_grad():
        got = tp.model.get_outputs(tb, (4, 4), 32)
    assert set(got) == set(want) and got["rgb"].shape == (2, 12, 12, 3) and got["intensity"].shape == (64, 1)
    for key in want:
        if "depth" in key:
            _check_depth(got[key].numpy(), np.asarray(want[key]), True)
        else:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=5e-4, err_msg=key)


def test_closed_loop_render_with_moved_pose_and_updated_actors():
    from neurad_tpu.scripts import closed_loop as JCL

    jp, state, tp = _pipelines("mlp", True)
    jstate = JCL.ClosedLoopState.__new__(JCL.ClosedLoopState)  # the JAX server loads a run directory; build it by hand
    import threading
    jstate.pipeline, jstate.state, jstate.render_lock, jstate.time_offset = jp, state, threading.Lock(), 0.0
    tstate = TCL.ClosedLoopState(tp, device="cpu")
    cams0_j, cams0_t = jp.outputs.cameras, tp.outputs.cameras
    try:
        pose = np.eye(4, dtype=np.float32)
        pose[:3] = np.asarray(cams0_j.camera_to_worlds[0])
        pose[:3, 3] += pose[:3, 0] * 1.5 + pose[:3, 1] * 0.3
        want = jstate.render_image(pose.tolist(), 0.8, "front_camera")
        got = tstate.render_image(pose.tolist(), 0.8, "front_camera")
        _check_rgb(got, np.asarray(want), True)
        assert np.isfinite(tstate.last_render_seconds)

        actors = tstate.get_actors()
        assert len(actors) == 1 and actors == jstate.get_actors()
        moved = np.asarray(actors[0]["poses"], np.float32)
        moved[:, 1, 3] += 2.5
        moved[:, 0, 3] -= 1.0
        actors[0]["poses"] = moved.tolist()
        jstate.update_actors(actors)
        tstate.update_actors(actors)
        want2 = jstate.render_image(pose.tolist(), 0.8, "front_camera")
        got2 = tstate.render_image(pose.tolist(), 0.8, "front_camera")
        _check_rgb(got2, np.asarray(want2), True)
        assert np.abs(got2 - got).max() > 1e-3, "the moved actor shows"
    finally:  # the pipelines are shared with the other tests
        _CACHE.clear()


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_rgb_decoder_cnn_matches(fp32):
    """1x1 stem, four 7x7 blocks around a stride-3 transposed convolution whose
    flax kernel the bridge flips, fp32 1x1 head. bf16: 2e-2 (XLA and torch round
    bf16 convolutions at different points); fp32: 1e-5."""
    x = np.random.default_rng(0).normal(size=(2, 5, 6, 20)).astype(np.float32)
    jdec = JDecoder(hidden_dim=16, upsample_factor=3, compute_dtype=None if fp32 else jnp.bfloat16)
    params = jax.tree.map(np.asarray, jdec.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tdec = TDecoder(20, hidden_dim=16, upsample_factor=3, compute_dtype=None if fp32 else torch.bfloat16)
    sd = bridge.neurad_decoder_from_flax("", params["params"])
    tdec.load_state_dict({k[1:]: v for k, v in sd.items()})
    want = np.asarray(jdec.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tdec(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 15, 18, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5 if fp32 else 2e-2)
    assert want.std() > 0.01


def test_camera_optimizer_apply_to_raybundle_matches():
    from neurad_tpu.cameras.camera_optimizers import CameraOptimizer as JCamOpt
    from neurad_tpu.core.structs import RayBundle as JBundle

    rng = np.random.default_rng(1)
    o, d = rng.normal(size=(20, 3)).astype(np.float32), rng.normal(size=(20, 3)).astype(np.float32)
    idx = rng.integers(0, 4, (20, 1)).astype(np.int32)
    adj = (rng.normal(size=(4, 6)) * 0.1).astype(np.float32)
    for mode in ("off", "SO3xR3", "SE3"):
        jopt = JCamOpt(num_cameras=4, mode=mode)
        jb = JBundle(origins=jnp.asarray(o), directions=jnp.asarray(d), pixel_area=jnp.ones((20, 1)),
                     camera_indices=jnp.asarray(idx))
        params = {"params": {"pose_adjustment": jnp.asarray(adj)}} if mode != "off" else {}
        want = jopt.apply(params, jb, method=JCamOpt.apply_to_raybundle)
        topt = TCamOpt(4, mode=mode)
        if mode != "off":
            topt.load_state_dict({"pose_adjustment": torch.from_numpy(adj)})
        tb = TBundle(origins=torch.from_numpy(o), directions=torch.from_numpy(d), pixel_area=torch.ones(20, 1),
                     camera_indices=torch.from_numpy(idx).long())
        with torch.no_grad():
            got = topt.apply_to_raybundle(tb)
        np.testing.assert_allclose(got.origins.numpy(), np.asarray(want.origins), atol=1e-6)
        np.testing.assert_allclose(got.directions.numpy(), np.asarray(want.directions), atol=1e-6)
        assert (got is tb) == (mode == "off")
