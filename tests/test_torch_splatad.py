"""Port SplatAD serving path against the JAX package: seeding, the synthetic
scene, the decoders, the model's camera/lidar outputs with bridged params, the
pipeline renders and the closed-loop server.

Tolerances: the compositors are fp32 on both sides (the JAX side runs the
Pallas kernels in interpret mode at <= 64 tiles), so accumulation is held to
1e-5 and depths to 1e-5 relative. The RGB CNN and lidar MLP run in bf16 by
default on both sides, and XLA and torch round bf16 convolutions and matmuls
at different points: decoded outputs (rgb, intensity, ray-drop logits) are
held to 1e-2. At compute_dtype=fp32 the decoders are held to 1e-5.
"""

import threading
import types
from http.server import ThreadingHTTPServer
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
from neurad_tpu.data.full_image_datamanager import FullImageLidarDataManager as JDM
from neurad_tpu.data.full_image_datamanager import FullImageLidarDataManagerConfig as JDMC
from neurad_tpu.fields.mlp import MLP as JMLP
from neurad_tpu.model_components.cnns import BasicBlock as JBlock
from neurad_tpu.model_components.dynamic_actors import ActorEdits as JEdits
from neurad_tpu.models import splatad as JS
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipeline as JPipe
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipelineConfig as JPipeCfg
from neurad_tpu.scripts import closed_loop as JCL
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.data.full_image_datamanager import FullImageLidarDataManager as TDM
from neurad_tpu_torch.data.full_image_datamanager import FullImageLidarDataManagerConfig as TDMC
from neurad_tpu_torch.fields.mlp import MLP as TMLP
from neurad_tpu_torch.model_components.cnns import BasicBlock as TBlock
from neurad_tpu_torch.model_components.dynamic_actors import ActorEdits as TEdits
from neurad_tpu_torch.models import splatad as TS
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline as TPipe
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipelineConfig as TPipeCfg
from neurad_tpu_torch.scripts import closed_loop as TCL

torch.set_num_threads(1)

TIGHT, RTOL_DEPTH, DECODED = 1e-5, 1e-5, 1e-2
# <= 64 tiles on both sensors so the JAX side runs its Pallas kernels:
# 128x128 camera = 8x8 tiles; lidar 20 x 14 degree tiles = 18x3 tiles. The
# 2 m near plane culls gaussians right in front of the camera: one 0.6 m away
# spans ~10,000 px with a near-degenerate conic whose quadratic form cancels,
# so XLA's and torch's last-bit differences in the projection move its alpha by
# several percent over hundreds of pixels (a property of the function, not of
# either implementation).
SMALL = dict(max_per_tile=256, near_plane=2.0, lidar_tile_azim=20.0, lidar_tile_elev=14.0, lidar_max_per_tile=32,
             lidar_pts_per_tile=64)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _traj():
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    poses[:, :3, 3] = [[10.0, 2.0, 1.0], [16.0, 2.0, 1.0]]
    return {
        "poses": poses, "timestamps": np.array([0.0, 2.0]), "dims": np.array([2.0, 4.0, 1.5]),
        "symmetric": True, "deformable": False,
        "linear_velocities_global": np.tile(np.array([[3.0, 0.0, 0.0]], np.float32), (2, 1)),
        "angular_velocities_local": np.tile(np.array([[0.0, 0.0, 0.2]], np.float32), (2, 1)),
    }


def _seed_points():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(size=(800, 3)) * 10 + [15, 0, 0], rng.uniform(size=(800, 1))], -1)
    pts[:60, :3] = np.array([10.0, 2.0, 1.0]) + rng.normal(size=(60, 3)) * 0.4  # inside the actor box
    return pts.astype(np.float32)


def test_seed_gaussians_identical():
    pts = _seed_points()
    rgb_time = np.concatenate([pts, np.random.default_rng(1).uniform(size=(800, 4)).astype(np.float32)], -1)
    for points in (pts, rgb_time):
        j = JS.seed_gaussians(points, [_traj()], 1500, feature_dim=16, n_far_points=200, seed=3)
        t = TS.seed_gaussians(points, [_traj()], 1500, feature_dim=16, n_far_points=200, seed=3)
        for name, a, b in zip(JS.GaussianInit._fields, j, t):
            np.testing.assert_array_equal(b, a, err_msg=name)
        assert (t.ids == 0).sum() > 0


def test_synthetic_scene_and_samples_identical():
    kw = dict(num_frames=3, image_height=24, image_width=40, focal=20.0, lidar_channels=8, lidar_azimuths=60)
    j, t = JSynth(**kw).setup().get_dataparser_outputs(), TSynth(**kw).setup().get_dataparser_outputs()
    for a, b in zip(j.images + j.point_clouds, t.images + t.point_clouds):
        np.testing.assert_array_equal(b, a)
    for field in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height", "camera_type", "times"):
        np.testing.assert_array_equal(_np(getattr(t.cameras, field)), np.asarray(getattr(j.cameras, field)), field)
    for field in ("lidar_to_worlds", "lidar_type", "times"):
        np.testing.assert_array_equal(_np(getattr(t.lidars, field)), np.asarray(getattr(j.lidars, field)), field)
    for key in ("velocities", "sensor_idxs"):
        np.testing.assert_array_equal(_np(t.lidars.metadata[key]), np.asarray(j.lidars.metadata[key]))
    np.testing.assert_array_equal(_np(t.scene_box.aabb), np.asarray(j.scene_box.aabb))
    assert (t.eval_camera_indices, t.sensor_idx_to_name) == (j.eval_camera_indices, j.sensor_idx_to_name)
    for ta, ja in zip(t.trajectories, j.trajectories):
        assert ta.keys() == ja.keys()
        for key in ta:
            np.testing.assert_array_equal(np.asarray(ta[key]), np.asarray(ja[key]), key)

    jdm, tdm = JDM(j, JDMC(max_lidar_points=300)), TDM(t, TDMC(max_lidar_points=300))
    np.testing.assert_array_equal(tdm.all_seed_points(), jdm.all_seed_points())
    for a, b in zip(vars(jdm._camera_sample(2)).values(), vars(tdm._camera_sample(2)).values()):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    for idx in (0, 1):  # scan 1 holds more points than max_lidar_points: the seeded subsample
        for a, b in zip(vars(jdm._lidar_sample(idx)).values(), vars(tdm._lidar_sample(idx)).values()):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("norm", ["none", "group"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_basic_block(norm, dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 10, 12, 24)).astype(np.float32)
    jb = JBlock(32, 3, norm=norm, compute_dtype=getattr(jnp, dtype))
    params = jb.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tb = TBlock(24, 32, 3, norm=norm, compute_dtype=getattr(torch, dtype))
    tb.load_state_dict({k[2:]: v for k, v in bridge._basic_block("b", jax.tree.map(np.asarray, params["params"])).items()})
    tol = TIGHT if dtype == "float32" else DECODED
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.apply(params, jnp.asarray(x))), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(50, 27)).astype(np.float32)
    jm = JMLP(out_dim=2, num_layers=3, layer_width=32, compute_dtype=getattr(jnp, dtype))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = TMLP(27, 2, num_layers=3, layer_width=32, compute_dtype=getattr(torch, dtype))
    sd = {}
    for name, layer in jax.tree.map(np.asarray, params["params"]).items():
        sd.update(bridge._dense(name, layer))
    tm.load_state_dict(sd)
    tol = TIGHT if dtype == "float32" else DECODED
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(params, jnp.asarray(x))), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgb_decoder_cnn(dtype):
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(9, 14, 24)).astype(np.float32)
    dirs = rng.normal(size=(9, 14, 3)).astype(np.float32)
    jd = JS.RGBDecoderCNN(compute_dtype=getattr(jnp, dtype))
    params = jd.init(jax.random.PRNGKey(2), jnp.asarray(feats), jnp.asarray(dirs))
    p = jax.tree.map(np.asarray, params["params"])
    # the decoder's head is initialised at 1e-4 scale; a larger head makes the test see it
    p["Conv_0"]["kernel"] = rng.normal(size=p["Conv_0"]["kernel"].shape).astype(np.float32) * 0.1
    td = TS.RGBDecoderCNN(24, compute_dtype=getattr(torch, dtype))
    sd = {}
    for i, name in enumerate(("BasicBlock_0", "BasicBlock_1")):
        sd.update(bridge._basic_block(f"blocks.{i}", p[name]))
    sd.update(bridge._conv("head", p["Conv_0"]))
    td.load_state_dict(sd)
    tol = TIGHT if dtype == "float32" else DECODED
    with torch.no_grad():
        got = td(torch.from_numpy(feats), torch.from_numpy(dirs)).numpy()
    want = np.asarray(jd.apply({"params": p}, jnp.asarray(feats), jnp.asarray(dirs)))
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


SCENE = dict(num_frames=4, image_height=128, image_width=128, focal=90.0, lidar_channels=16, lidar_azimuths=180)


@pytest.fixture(scope="module")
def pipelines():
    jp = JPipe(JSynth(**SCENE).setup().get_dataparser_outputs(),
               JPipeCfg(model=JS.SplatADConfig(**SMALL), cap_max=3000, datamanager=JDMC(max_lidar_points=4096)))
    params = jp.model.init(jax.random.PRNGKey(0), method=JS.SplatADModel.init_all)
    tp = TPipe(TSynth(**SCENE).setup().get_dataparser_outputs(),
               TPipeCfg(model=TS.SplatADConfig(**SMALL), cap_max=3000, datamanager=TDMC(max_lidar_points=4096)),
               device="cpu")
    tp.model.load_state_dict(bridge.splatad_params_from_flax(jax.tree.map(np.asarray, params)))
    return jp, types.SimpleNamespace(params=params), tp


@pytest.fixture(scope="module")
def models(pipelines):
    jp, state, tp = pipelines
    return jp.model, state.params, tp.model


@pytest.mark.parametrize("edits", [None, dict(lateral=0.5, rotation=0.3)])
def test_model_camera_outputs(models, edits):
    jm, params, tm = models
    K = np.array([[90.0, 0, 64], [0, 90.0, 64], [0, 0, 1.0]], np.float32)
    c2w = np.array([[0, 0, -1, 4.0], [-1, 0, 0, 0.5], [0, 1, 0, 1.5]], np.float32)  # looking along +x
    vel = np.array([2.0, 0.0, 0.0], np.float32)
    j = jm.apply(params, jnp.asarray(c2w), jnp.asarray(K), 128, 128, jnp.asarray(1.3), jnp.asarray(0),
                 jnp.asarray(0), cam_linear_vel=jnp.asarray(vel), rolling_shutter_time=0.05,
                 edits=JEdits(**edits) if edits else None, method=JS.SplatADModel.get_camera_outputs)
    with torch.no_grad():
        t = tm.get_camera_outputs(c2w, K, 128, 128, 1.3, 0, 0, cam_linear_vel=vel, rolling_shutter_time=0.05,
                                  edits=TEdits(**edits) if edits else None)
    assert float(np.asarray(j["accumulation"]).max()) > 0.2
    np.testing.assert_array_equal(_np(t["radii"]), np.asarray(j["radii"]))
    for key in ("binning_dropped_pairs", "binning_cropped_gaussians", "binning_culled_visible"):
        assert int(t[key]) == int(j[key]), key
    np.testing.assert_allclose(_np(t["accumulation"]), np.asarray(j["accumulation"]), atol=TIGHT)
    np.testing.assert_allclose(_np(t["depth"]), np.asarray(j["depth"]), rtol=RTOL_DEPTH, atol=1e-4)
    np.testing.assert_allclose(_np(t["rgb"]), np.asarray(j["rgb"]), atol=DECODED)


def test_model_lidar_outputs(models):
    jm, params, tm = models
    rng = np.random.default_rng(7)
    m = 3000
    rp = np.stack([rng.uniform(-180, 180, m), rng.uniform(-25, 14, m), rng.uniform(3, 40, m),
                   rng.uniform(-0.05, 0.05, m), rng.uniform(0, 1, m)], -1).astype(np.float32)
    l2w = np.eye(4, dtype=np.float32)[:3]
    l2w[:, 3] = [1.0, 0.0, 2.0]
    vel = np.array([2.0, 0.0, 0.0], np.float32)
    j = jm.apply(params, jnp.asarray(l2w), jnp.asarray(rp), jnp.asarray(1.0), jnp.asarray(1),
                 lidar_linear_vel=jnp.asarray(vel), method=JS.SplatADModel.get_lidar_outputs)
    with torch.no_grad():
        t = tm.get_lidar_outputs(l2w, rp, 1.0, 1, lidar_linear_vel=vel)
    assert float(np.asarray(j["alpha"]).max()) > 0.3
    for key in ("binning_dropped_pairs", "binning_cropped_gaussians", "points_overflowed"):
        assert int(t[key]) == int(j[key]), key
    for key in ("features", "alpha", "alpha_sum_until_points"):
        np.testing.assert_allclose(_np(t[key]), np.asarray(j[key]), atol=TIGHT, err_msg=key)
    for key in ("depth", "median_depth"):
        np.testing.assert_allclose(_np(t[key]), np.asarray(j[key]), rtol=RTOL_DEPTH, atol=1e-4, err_msg=key)
    for key in ("intensity", "ray_drop_logits"):
        np.testing.assert_allclose(_np(t[key]), np.asarray(j[key]), atol=DECODED, err_msg=key)


def test_pipeline_render_eval(pipelines):
    jp, state, tp = pipelines
    j_rgb, j_gt = jp.render_eval_camera(state, 3)
    t_rgb, t_gt = tp.render_eval_camera(3)
    np.testing.assert_array_equal(t_gt, j_gt)
    assert float(np.abs(j_rgb - np.asarray(TS.BACKGROUND)).max()) > 0.1, "not all background"
    np.testing.assert_allclose(t_rgb, j_rgb, atol=DECODED)
    jl, tl = jp.render_eval_lidar(state, 3), tp.render_eval_lidar(3)
    assert jl.keys() == tl.keys()
    for key in ("gt_distance", "gt_intensity", "did_return", "origins"):
        np.testing.assert_array_equal(tl[key], jl[key], err_msg=key)
    np.testing.assert_allclose(tl["directions"], jl["directions"], atol=1e-6)
    np.testing.assert_allclose(tl["depth"], jl["depth"], rtol=RTOL_DEPTH, atol=1e-4)
    for key in ("intensity", "ray_drop_logits"):
        np.testing.assert_allclose(tl[key], jl[key], atol=DECODED, err_msg=key)


def test_pipeline_render_viewer_image(pipelines):
    """Viewer render at an arbitrary pose with actor edits and a rolling-shutter
    time (the JAX side jits it)."""
    jp, state, tp = pipelines
    c2w = np.array([[0, 0, -1, 4.0], [-1, 0, 0, 0.5], [0, 1, 0, 1.5]], np.float32)
    edits = [0.5, 0.0, 0.3, 0.0, 0.02]  # lateral, longitudinal, rotation, height, rolling shutter
    want = jp.render_viewer_image(state.params, c2w, 128, 96, 1.3, edits)
    got = tp.render_viewer_image(c2w, 128, 96, 1.3, edits)
    assert got.shape == (96, 128, 3)
    np.testing.assert_allclose(got, want, atol=DECODED)


def test_closed_loop_server(pipelines):
    jp, state, tp = pipelines
    jstate = JCL.ClosedLoopState.__new__(JCL.ClosedLoopState)  # its constructor loads a run dir
    jstate.pipeline, jstate.state, jstate.render_lock, jstate.time_offset = jp, state, threading.Lock(), 0.0
    server = ThreadingHTTPServer(("127.0.0.1", 0), TCL.make_handler(TCL.ClosedLoopState(tp, device="cpu")))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        pose = np.eye(4, dtype=np.float32)
        pose[:3] = np.asarray(jp.outputs.cameras.camera_to_worlds[1])
        pose[:3, 3] += pose[:3, 0] * 1.5  # lane shift
        body = json.dumps({"pose": pose.tolist(), "timestamp": 2.2, "camera_name": "front_camera"}).encode()
        req = urllib.request.Request(url + "/render_image", data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            image = np.asarray(json.loads(resp.read())["image"], np.float32)
        with urllib.request.urlopen(url + "/get_actors", timeout=30) as resp:
            actors = json.loads(resp.read())["actors"]
        with urllib.request.urlopen(url + "/start_time", timeout=30) as resp:
            start = json.loads(resp.read())["start_time"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    want = jstate.render_image(pose.tolist(), 2.2, "front_camera")
    assert image.shape == (128, 128, 3)
    np.testing.assert_allclose(image, np.asarray(want), atol=DECODED)
    assert actors == json.loads(json.dumps(jstate.get_actors()))
    assert start == jstate.time_offset
