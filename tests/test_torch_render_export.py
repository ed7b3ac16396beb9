"""Slice 10 of the port: render and export (`scripts/render.py`,
`scripts/export.py`, `exporter/{tsdf,poisson}.py`, `cameras/camera_utils.py`,
`utils/colormaps.py`) against the JAX package's.

Host numpy (colormaps, the numpy parts of camera_utils, TSDF fusion,
marching tetrahedra, the Poisson solve, depth normals, the PLY writers) is
held bit for bit on the same inputs (the JAX tests' sphere and wall cases,
tests/exporter/); `get_interpolated_poses` and `auto_orient_and_center_poses`
compose in float32 through each package's pose module: 1e-6.

With the pipelines, parameters carried from JAX (`params_from_jax`): SplatAD
is `splatad-tiny` at 24x32 with fp32 decoders on both sides (the JAX module
patched as in tests/test_torch_eval_pipelines.py), whose renders are held
to 1e-4 (measured 1.6e-5 after a lane shift; tests/test_torch_splatad.py
holds them to 1e-2 with the default bf16 decoders); NeuRAD is tests/test_torch_neurad.py's fp32 model with MLP proposals,
held by its `_check_rgb` / `_check_depth` and, for `query_geometry`, 1e-5.
A render's PNG levels are at most one apart. The entry points run on both
packages' pipelines, each script's `load_run` handing back the module's
pipeline: the file names are the same, the gaussian-splat PLY and the
camera-poses JSON byte-equal (their values are carried exactly).

The port's own entry points then run on CPU run directories of its train
script. Size: the JAX side's Pallas kernels run in interpret mode; the
tiny scenes keep them short.
"""

import contextlib
import dataclasses
import functools
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.cameras import camera_utils as JCU
from neurad_tpu.configs import method_configs as JMC
from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
from neurad_tpu.exporter import poisson as JPoisson
from neurad_tpu.exporter import tsdf as JTsdf
from neurad_tpu.models import splatad as JS
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipeline as JSPipe
from neurad_tpu.scripts import eval as JEval
from neurad_tpu.scripts import export as JExport
from neurad_tpu.scripts import render as JRender
from neurad_tpu.utils import colormaps as JColormaps
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.cameras import camera_utils as TCU
from neurad_tpu_torch.configs import method_configs as TMC
from neurad_tpu_torch.data.png import quantise
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.exporter import poisson as TPoisson
from neurad_tpu_torch.exporter import tsdf as TTsdf
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline as TSPipe
from neurad_tpu_torch.scripts import export as TExport
from neurad_tpu_torch.scripts import render as TRender
from neurad_tpu_torch.scripts import train as TTrain
from neurad_tpu_torch.utils import colormaps as TColormaps

from test_torch_eval_pipelines import SPLIT
from test_torch_neurad import _check_depth, _check_rgb, _pipelines

torch.set_num_threads(1)

TINY = dict(SPLIT, image_height=24, image_width=32)
SPLAT_RGB_TOL = 1e-4  # fp32 decoders (measured 1.6e-5)
SPLAT_DEPTH = dict(rtol=1e-5, atol=1e-4)  # tests/test_torch_splatad.py
GEOMETRY_TOL = 1e-5  # query_geometry (tests/test_torch_neurad.py)


# ---------------------------------------------------------------------------
# host numpy, bit for bit
# ---------------------------------------------------------------------------


def test_colormaps_are_bit_equal():
    rng = np.random.default_rng(0)
    v = rng.uniform(-0.2, 1.2, (7, 9, 1))
    assert np.array_equal(TColormaps.apply_colormap(v), JColormaps.apply_colormap(v))
    depth = rng.uniform(1.0, 80.0, (12, 16, 1)).astype(np.float32)
    depth[0, 0] = np.nan
    acc = rng.random((12, 16, 1)).astype(np.float32)
    for kw in ({}, {"accumulation": acc}, {"near_plane": 2.0, "far_plane": 50.0}, {"near_plane": 5.0, "far_plane": 5.0}):
        got, want = TColormaps.apply_depth_colormap(depth, **kw), JColormaps.apply_depth_colormap(depth, **kw)
        assert np.array_equal(got, want, equal_nan=True), kw


def _random_pose(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    return np.concatenate([q, rng.normal(size=(3, 1))], axis=1).astype(np.float32)


def test_camera_utils_numpy_parts_are_bit_equal():
    rng = np.random.default_rng(1)
    assert np.array_equal(TCU.get_distortion_params(0.1, -0.02, 0.003, 0.0, 1e-3, -2e-3),
                          JCU.get_distortion_params(0.1, -0.02, 0.003, 0.0, 1e-3, -2e-3))
    for a, b in [(rng.normal(size=3), rng.normal(size=3)) for _ in range(4)] + [
            (np.array([0.0, 0, 2]), np.array([0.0, 0, 1])), (np.array([0.0, 0, 1]), np.array([0.0, 0, -3]))]:
        assert np.array_equal(TCU.rotation_matrix_between(a, b), JCU.rotation_matrix_between(a, b))
    for _ in range(3):
        lookat, up, pos = rng.normal(size=(3, 3))
        assert np.array_equal(TCU.viewmatrix(lookat, up, pos), JCU.viewmatrix(lookat, up, pos))


@pytest.mark.parametrize("method,center", [("up", "poses"), ("none", "poses"), ("up", "none")])
def test_auto_orient_and_center_poses_match(method, center):
    rng = np.random.default_rng(2)
    poses = np.stack([_random_pose(rng) for _ in range(6)])
    got, got_t = TCU.auto_orient_and_center_poses(poses, method, center)
    want, want_t = JCU.auto_orient_and_center_poses(poses, method, center)
    assert np.array_equal(got_t, want_t) and got.dtype == np.asarray(want).dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("steps", [2, 7])
def test_interpolated_poses_match(steps):
    rng = np.random.default_rng(3)
    for _ in range(4):
        a, b = _random_pose(rng), _random_pose(rng)
        got, want = TCU.get_interpolated_poses(a, b, steps), JCU.get_interpolated_poses(a, b, steps)
        assert got.shape == want.shape == (steps, 3, 4) and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    same = TCU.get_interpolated_poses(a, a, 3)  # parallel quaternions take the lerp branch
    np.testing.assert_allclose(same, JCU.get_interpolated_poses(a, a, 3), rtol=0, atol=1e-6)


def _sphere_sdf(r=32, radius=0.6):
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, r)] * 3, indexing="ij"), axis=-1)
    return np.linalg.norm(grid, axis=-1) - radius


@pytest.mark.parametrize("masked", [False, True])
def test_marching_tetrahedra_is_bit_equal(masked, tmp_path):
    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])
    vol = _sphere_sdf()
    mask = vol < 0.5 if masked else None
    got, want = TTsdf.marching_tetrahedra(vol, aabb, mask=mask), JTsdf.marching_tetrahedra(vol, aabb, mask=mask)
    assert len(want[1]) > 50 and all(np.array_equal(g, w) for g, w in zip(got, want))
    TTsdf.write_mesh_ply(tmp_path / "t.ply", *got)
    JTsdf.write_mesh_ply(tmp_path / "j.ply", *want)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    empty = TTsdf.marching_tetrahedra(np.ones((4, 4, 4)), aabb)
    assert all(np.array_equal(g, w) for g, w in zip(empty, JTsdf.marching_tetrahedra(np.ones((4, 4, 4)), aabb)))


def test_tsdf_fuse_wall_is_bit_equal():
    h, w = 32, 32
    K = np.array([[30.0, 0, 16.0], [0, 30.0, 16.0], [0, 0, 1]])
    depth = np.full((h, w), 2.0, dtype=np.float32)
    depth[:, :5] = 0.0  # unobserved columns
    c2ws = [np.eye(4)[:3], np.concatenate([np.eye(3), [[0.1], [0.0], [0.2]]], axis=1)]
    aabb = np.array([[-1.0, -1.0, -3.0], [1.0, 1.0, -1.0]])
    got = TTsdf.tsdf_fuse([depth, depth * 1.1], [K, K], c2ws, aabb, resolution=32, trunc=0.3)
    want = JTsdf.tsdf_fuse([depth, depth * 1.1], [K, K], c2ws, aabb, resolution=32, trunc=0.3)
    assert all(np.array_equal(g, w) for g, w in zip(got, want)) and want[1].max() > 0


@pytest.mark.parametrize("case", ["sphere", "off_center"])
def test_poisson_reconstruct_is_bit_equal(case):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(20000, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    if case == "sphere":
        args, kw = (v, v), dict(resolution=48)
    else:
        args = (v * 0.5 + np.array([0.3, -0.2, 0.1]), v)
        kw = dict(resolution=48, aabb=np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]), smooth_sigma=0.0)
    (gc, gi, ga), (wc, wi, wa) = TPoisson.poisson_reconstruct(*args, **kw), JPoisson.poisson_reconstruct(*args, **kw)
    assert np.array_equal(gc, wc) and gi == wi and np.array_equal(ga, wa)


def test_normals_from_depth_are_bit_equal():
    rng = np.random.default_rng(4)
    xs, ys = np.meshgrid(np.linspace(-1, 1, 16), np.linspace(-1, 1, 12))
    positions = np.stack([xs, ys, 2.0 + 0.1 * rng.random(xs.shape)], axis=-1)
    positions[3, 3] = positions[3, 4]  # a degenerate pixel
    for center in (np.zeros(3), np.array([0.0, 0.0, 5.0])):
        got, want = TPoisson.normals_from_depth(positions, center), JPoisson.normals_from_depth(positions, center)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_write_ply_is_byte_equal(tmp_path):
    rng = np.random.default_rng(5)
    fields = {"x": rng.normal(size=50), "y": rng.normal(size=50).astype(np.float32), "red": rng.random(50)}
    TExport.write_ply(tmp_path / "t.ply", fields)
    JExport.write_ply(tmp_path / "j.ply", fields)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_load_camera_path_matches(tmp_path):
    frames = [{"camera_to_world": np.eye(4).reshape(-1).tolist(), "render_time": 0.25},
              {"camera_to_world": (np.eye(4) * 2).reshape(-1).tolist(), "render_time": 0.5}]
    for name, data in (("timed", {"camera_path": frames, "fov": 50}),
                       ("untimed", {"camera_path": [{"camera_to_world": f["camera_to_world"]} for f in frames]}),
                       ("empty", {})):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(data))
        (gp, gf, gt), (wp, wf, wt) = TRender.load_camera_path(path), JRender.load_camera_path(path)
        assert gf == wf and gt == wt and len(gp) == len(wp)
        assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(gp, wp))


# ---------------------------------------------------------------------------
# with the pipelines
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _JState:
    """The part of JAX's TrainState the render and export functions use."""

    params: dict

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _tiny_splatad_config(pipeline_cfg):
    """splatad-tiny with tests/test_torch_splatad.py's lidar tiles (20 x 14
    degrees): the scan's tiles stay within the 64 that JAX composites with its
    Pallas kernel in interpret mode (above that it takes XLA's bf16 path)."""
    lidar = dict(lidar_tile_azim=20.0, lidar_tile_elev=14.0, lidar_pts_per_tile=64)
    return dataclasses.replace(pipeline_cfg, model=dataclasses.replace(pipeline_cfg.model, **lidar))


@pytest.fixture(scope="module")
def splatad():
    """splatad-tiny at 24x32 in both packages, fp32 decoders, JAX's
    PRNGKey(0) parameters carried across."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JS, "RGBDecoderCNN", functools.partial(JS.RGBDecoderCNN, compute_dtype=jnp.float32))
    mp.setattr(JS, "MLP", functools.partial(JS.MLP, compute_dtype=jnp.float32))
    jp = JSPipe(JSynth(**TINY).setup().get_dataparser_outputs(),
                _tiny_splatad_config(JMC.get_method_config("splatad-tiny").pipeline))
    params = jax.jit(lambda key: jp.model.init(key, method=JS.SplatADModel.init_all))(jax.random.PRNGKey(0))
    tp = TSPipe(TSynth(**TINY).setup().get_dataparser_outputs(),
                _tiny_splatad_config(TMC.METHODS["splatad-tiny"]().pipeline), device="cpu")
    tp.model.load_state_dict(bridge.splatad_params_from_flax(jax.tree.map(np.asarray, params)))
    for module in tp.model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.float32
    yield jp, _JState(params), tp
    mp.undo()


@pytest.fixture(scope="module")
def neurad():
    """tests/test_torch_neurad.py's fp32 NeuRAD with MLP proposals (livened
    tables, the actor 1.5 m ahead)."""
    jp, state, tp = _pipelines("mlp", True)
    return jp, _JState(state.params), tp


@pytest.fixture
def models(request, splatad, neurad):
    return {"splatad": splatad, "neurad": neurad}[request.param]


@contextlib.contextmanager
def _restored(jp, tp):
    """Both pipelines' cameras, the JAX model (a removal replaces it) and the
    port model's parameters and buffers as they were."""
    jcams, tcams, jmodel = jp.outputs.cameras, tp.outputs.cameras, jp.model
    saved = {k: v.clone() for k, v in tp.model.state_dict(keep_vars=False).items()}
    present, data = tp.model.actors.present.clone(), tp.model.actors.data
    try:
        yield
    finally:
        jp.outputs.cameras = jp.datamanager.outputs.cameras = jcams
        tp.outputs.cameras = tcams
        jp.model = jmodel
        tp.model.load_state_dict(saved)
        tp.model.actors.present.copy_(present)
        tp.model.actors.data = data
        if hasattr(tp.model, "actor_data"):
            tp.model.actor_data = data


def _levels_close(got, want):
    q = lambda x: (np.clip(x, 0, 1) * 255).astype(np.int16)
    assert np.abs(q(got) - q(want)).max() <= 1


def _check_render(name, got, want):
    if name == "splatad":
        np.testing.assert_allclose(got, want, rtol=0, atol=SPLAT_RGB_TOL)
    else:
        _check_rgb(got, np.asarray(want), True)
    _levels_close(got, np.asarray(want))


EDITS = {"shift": dict(shift=[1.0, -0.5, 0.25]), "stop": dict(stop_time=0.3),
         "remove": dict(removal_time=0.2), "all": dict(shift=[0.5, 0.0, 0.0], stop_time=0.35, removal_time=0.4,
                                                        indices=[0])}


@pytest.mark.parametrize("models", ["splatad", "neurad"], indirect=True)
@pytest.mark.parametrize("edit", list(EDITS))
def test_modify_actors_matches_jax(models, edit):
    jp, state, tp = models
    with _restored(jp, tp):
        new = JRender.modify_actors(jp, state, **EDITS[edit])
        TRender.modify_actors(tp, **EDITS[edit])
        want = new.params["params"]["actors"]
        actors = tp.model.actors
        assert np.array_equal(actors.actor_positions.detach().numpy(), np.asarray(want["actor_positions"]))
        assert np.array_equal(actors.actor_rotations_6d.detach().numpy(), np.asarray(want["actor_rotations_6d"]))
        want_present = np.asarray(jp.model.actor_data.present)
        assert np.array_equal(actors.present.numpy(), want_present)
        assert np.array_equal(actors.data.present, want_present)
        if "removal_time" in EDITS[edit]:
            assert not want_present.all()


def test_modify_actors_of_a_static_model_exits():
    from neurad_tpu_torch.pipelines.splatfacto_pipeline import SplatfactoPipeline

    tp = SplatfactoPipeline(TSynth(**TINY).setup().get_dataparser_outputs(),
                            TMC.METHODS["splatfacto"]().pipeline.__class__(capacity=64, num_init=32), device="cpu")
    with pytest.raises(SystemExit, match="dynamic-actor model"):
        TRender.modify_actors(tp, shift=[1.0, 0.0, 0.0])


@pytest.mark.parametrize("models", ["splatad", "neurad"], indirect=True)
def test_render_pose_matches_jax(models, request):
    jp, state, tp = models
    name = request.node.callspec.params["models"]
    base = list(tp.outputs.eval_camera_indices or [0])[0]
    pose = tp.outputs.cameras.camera_to_worlds[base].numpy().copy()
    pose[:3, 3] += pose[:3, 0] * 0.4 - pose[:3, 2] * 0.3
    parsed = tp.outputs.cameras
    with _restored(jp, tp):
        want = JRender.render_pose(jp, state, pose, base, time=0.2)
        got = TRender.render_pose(tp, pose, base, time=0.2)
        _check_render(name, got, want)
        assert tp.outputs.cameras is parsed, "the port puts the camera back"
        assert np.abs(got - tp.render_eval_camera(base)[0]).max() > 1e-3, "the pose shows"


def _run_entry(module, jax_side, argv, pipeline, state, tmp_path, monkeypatch):
    """A render or export entry point of either package on the module's
    pipeline (its `load_run` patched), the images it saves captured by file
    name."""
    saved = {}
    run_dir = tmp_path / ("jax_run" if jax_side else "torch_run")
    (run_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
    (run_dir / "checkpoints" / "step-000000002.pt").touch()
    if jax_side:
        monkeypatch.setattr(JEval, "load_run", lambda d: (pipeline, state, 2))
    else:
        monkeypatch.setattr(TTrain, "load_run", lambda d, device="cuda", with_state=False: (pipeline, None))
    if hasattr(module, "_save_image"):
        monkeypatch.setattr(module, "_save_image",
                            lambda path, img, *write: saved.__setitem__(path.name, np.asarray(img)))
    out = tmp_path / ("jax_out" if jax_side else "torch_out")
    if module in (JExport, TExport):  # argv: the mode, then flags
        cmd = argv[:1] + [str(run_dir)] + argv[1:]
    else:
        cmd = [str(run_dir)] + argv + ["--output-dir", str(out)]
    module.entrypoint(cmd + ([] if jax_side else ["--device", "cpu"]))
    return saved, out


@pytest.mark.parametrize("models", ["splatad", "neurad"], indirect=True)
def test_lane_shift_render_matches_jax(models, request, tmp_path, monkeypatch):
    jp, state, tp = models
    name = request.node.callspec.params["models"]
    argv = ["--shift", "1.0", "--shift-time", "0.3"]
    with _restored(jp, tp):
        want, _ = _run_entry(JRender, True, argv, jp, state, tmp_path, monkeypatch)
        unshifted = tp.render_eval_camera(list(tp.outputs.eval_camera_indices)[0])[0]
        got, _ = _run_entry(TRender, False, argv, tp, None, tmp_path, monkeypatch)
    assert sorted(got) == sorted(want) and len(got) == 2 * len(tp.outputs.eval_camera_indices)
    for fname in want:
        if fname.endswith("_gt.png"):
            assert np.array_equal(got[fname], want[fname]), fname
        else:
            _check_render(name, got[fname], want[fname])
    first = f"camera_{list(tp.outputs.eval_camera_indices)[0]:04d}.png"
    assert np.abs(got[first] - unshifted).max() > 1e-3, "the lane shift shows"


def test_splatad_script_renders_match_jax(splatad, tmp_path, monkeypatch):
    """Interpolated path, lidar .npz and BEV images, an actor shift."""
    jp, state, tp = splatad
    argv = ["--interpolate", "2", "--lidar", "--lidar-bev", "--actor-shift", "0.5,0,0"]
    with _restored(jp, tp):
        want, jout = _run_entry(JRender, True, argv, jp, state, tmp_path, monkeypatch)
        got, tout = _run_entry(TRender, False, argv, tp, None, tmp_path, monkeypatch)
    assert sorted(got) == sorted(want) and "path_00001.png" in got
    assert sorted(p.name for p in tout.iterdir()) == sorted(p.name for p in jout.iterdir())
    for fname in want:
        if fname.endswith("_bev.png"):  # points within the depth tolerance land on the same pixels, bar a few
            assert (got[fname] != want[fname]).any(-1).mean() <= 1e-3 and got[fname].max() > 0
        elif fname.endswith("_gt.png"):
            assert np.array_equal(got[fname], want[fname])
        else:
            _check_render("splatad", got[fname], want[fname])
    for npz in tout.glob("*.npz"):
        g, w = np.load(npz), np.load(jout / npz.name)
        assert sorted(g.files) == sorted(w.files)
        np.testing.assert_allclose(g["depth"], w["depth"], **SPLAT_DEPTH)
        for key in ("gt_distance", "gt_intensity", "did_return", "origins"):
            assert np.array_equal(g[key], w[key]), key


def test_save_lidar_bev_image_matches(splatad, tmp_path, monkeypatch):
    _, _, tp = splatad
    out = tp.render_eval_lidar(list(tp.outputs.eval_lidar_indices)[0])
    pts = out["origins"] + out["directions"] * out["depth"] - out["origins"][0]
    images = {}
    for mod, key in ((TRender, "torch"), (JRender, "jax")):
        monkeypatch.setattr(mod, "_save_image", lambda path, img, key=key: images.__setitem__(key, img))
        mod.save_lidar_bev(tmp_path / f"{key}.png", pts, out["intensity"][:, 0], extent=20.0, px=64)
    assert np.array_equal(images["torch"], images["jax"]) and images["torch"].max() > 0
    monkeypatch.undo()
    TRender.save_lidar_bev(tmp_path / "bev.png", pts, None, extent=20.0, px=64)
    from neurad_tpu_torch.data.png import read_png

    assert read_png(tmp_path / "bev.png").shape == (64, 64, 3)


@pytest.mark.parametrize("mode", ["gaussian-splat", "camera-poses"])
def test_exports_are_byte_equal(splatad, mode, tmp_path, monkeypatch):
    jp, state, tp = splatad
    outs = []
    for module, pipeline, jax_side in ((JExport, jp, True), (TExport, tp, False)):
        path = tmp_path / f"{'jax' if jax_side else 'torch'}.ply"
        argv = [mode, "--output", str(path)]
        _run_entry(module, jax_side, argv, pipeline, state, tmp_path, monkeypatch)
        outs.append(path.with_suffix(".json") if mode == "camera-poses" else path)
    assert outs[1].read_bytes() == outs[0].read_bytes() and outs[0].stat().st_size > 100


def _ply_vertices(path):
    data = path.read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode().splitlines()
    n = int(next(line for line in header if line.startswith("element vertex")).split()[-1])
    props = [line.split()[-1] for line in header if line.startswith("property float")]
    return props, np.frombuffer(data[end:end + 4 * n * len(props)], "<f4").reshape(n, len(props))


def test_pointcloud_export_matches_jax(splatad, tmp_path, monkeypatch):
    jp, state, tp = splatad
    paths = {}
    for module, pipeline, side in ((JExport, jp, "jax"), (TExport, tp, "torch")):
        paths[side] = tmp_path / f"{side}.ply"
        argv = ["pointcloud", "--output", str(paths[side])]
        _run_entry(module, side == "jax", argv, pipeline, state, tmp_path, monkeypatch)
    (gp, got), (wp, want) = _ply_vertices(paths["torch"]), _ply_vertices(paths["jax"])
    assert gp == wp == ["x", "y", "z", "red", "green", "blue"] and got.shape == want.shape and len(got) > 100
    np.testing.assert_allclose(got[:, :3], want[:, :3], **SPLAT_DEPTH)
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=0, atol=SPLAT_RGB_TOL)


def test_field_mesh_matches_jax(neurad, tmp_path, monkeypatch):
    """The field's geometry on JAX's r = 24 grid (one chunk, padded) within
    the query_geometry tolerance; the mesh of one shared volume identical."""
    jp, state, tp = neurad
    captured = {}
    real = JTsdf.marching_tetrahedra

    def capture(vol, aabb, iso=0.0, mask=None):
        captured.update(vol=np.asarray(vol), aabb=aabb, iso=iso)
        return real(vol, aabb, iso=iso, mask=mask)

    monkeypatch.setattr(JTsdf, "marching_tetrahedra", capture)
    JExport.export_field_mesh(jp, state, tmp_path / "jax.ply", resolution=24, time=0.3, chunk=8192)
    got = TExport.field_volume(tp, 24, time=0.3, chunk=8192)
    assert got.shape == captured["vol"].shape == (24, 24, 24) and got.dtype == captured["vol"].dtype
    np.testing.assert_allclose(got, captured["vol"], rtol=0, atol=GEOMETRY_TOL)
    assert captured["vol"].min() < 0 < captured["vol"].max(), "the livened field has a surface in the box"
    shared = TTsdf.marching_tetrahedra(captured["vol"], captured["aabb"], iso=captured["iso"])
    want = real(captured["vol"], captured["aabb"], iso=captured["iso"])
    assert len(want[1]) > 0 and all(np.array_equal(g, w) for g, w in zip(shared, want))
    TTsdf.write_mesh_ply(tmp_path / "torch.ply", *shared)
    assert (tmp_path / "torch.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def test_poisson_export_matches_jax(neurad, tmp_path, monkeypatch):
    """The oriented points the Poisson solve gets from the eval cameras' depth
    renders within the depth tolerance (the same points kept); the solve and
    the mesh on them as in JAX."""
    jp, state, tp = neurad
    inputs = {}

    def capturing(side, real):
        def solve(points, normals, **kw):
            inputs[side] = (points, normals)
            return real(points, normals, **kw)
        return solve

    monkeypatch.setattr(JPoisson, "poisson_reconstruct", capturing("jax", JPoisson.poisson_reconstruct))
    monkeypatch.setattr(TExport, "poisson_reconstruct", capturing("torch", TExport.poisson_reconstruct))
    JExport.export_poisson_mesh(jp, state, tmp_path / "jax.ply", resolution=32)
    TExport.export_poisson_mesh(tp, tmp_path / "torch.ply", resolution=32)
    (gp, gn), (wp, wn) = inputs["torch"], inputs["jax"]
    assert gp.shape == wp.shape and len(wp) > 100
    # the points' offsets over their distance from the world origin, as _check_depth holds depths (fp32)
    rel = np.linalg.norm(gp - wp, axis=-1) / np.maximum(np.linalg.norm(wp, axis=-1), 1.0)
    assert rel.max() <= 2e-2 and (rel > 5e-4).mean() <= 0.01, (rel.max(), (rel > 5e-4).mean())
    assert (np.abs(gn - wn).max(-1) > 1e-2).mean() <= 0.02
    chi = TPoisson.poisson_reconstruct(wp, wn, resolution=32)
    want = JPoisson.poisson_reconstruct(wp, wn, resolution=32)
    assert np.array_equal(chi[0], want[0]) and chi[1] == want[1]


def test_nerfacto_run_raises_not_implemented(tmp_path):
    """A nerfacto run renders nothing: the port's renders raise as the JAX
    package's pipeline fails on one."""
    dp = [a for k, v in TINY.items() for a in ("--dp-set", f"{k}={v}")]
    TTrain.entrypoint(["nerfacto", "--device", "cpu", "--max-iterations", "0", "--output-dir", str(tmp_path),
                       "--experiment-name", "n"] + dp)
    with pytest.raises(NotImplementedError, match="cannot evaluate or render"):
        TRender.entrypoint([str(tmp_path / "n"), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="cannot evaluate or render"):
        TExport.entrypoint(["pointcloud", str(tmp_path / "n"), "--device", "cpu"])


# ---------------------------------------------------------------------------
# the port's entry points on its own run directories
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    dp = [a for k, v in TINY.items() for a in ("--dp-set", f"{k}={v}")]
    for method in ("splatad-tiny", "neurad-tiny"):
        TTrain.entrypoint([method, "--device", "cpu", "--max-iterations", "2", "--output-dir", str(root),
                           "--experiment-name", method] + dp)
    return root


def test_render_script_writes_the_jax_file_names(run_dirs, tmp_path):
    run = run_dirs / "splatad-tiny"
    path = tmp_path / "path.json"
    path.write_text(json.dumps({"camera_path": [{"camera_to_world": np.eye(4).reshape(-1).tolist(),
                                                 "render_time": 0.1}] * 2}))
    TRender.entrypoint([str(run), "--device", "cpu", "--cameras", "all", "--lidar", "--lidar-bev", "--interpolate",
                        "2", "--camera-path", str(path), "--actor-shift", "1,0,0", "--actor-removal-time", "0.5",
                        "--actor-indices", "0"])
    names = sorted(p.name for p in (run / "renders").iterdir())
    n = TINY["num_frames"]
    want = ([f"camera_{i:04d}{s}.png" for i in range(n) for s in ("", "_gt")] + ["campath_00000.png",
            "campath_00001.png"] + [f"path_{f:05d}.png" for f in range(2 * (n - 1))]
            + [f"lidar_{s:04d}{e}" for s in (6, 7) for e in (".npz", "_pred_bev.png", "_gt_bev.png")])
    assert names == sorted(want)
    from neurad_tpu_torch.data.png import read_png

    assert read_png(run / "renders" / "camera_0006.png").shape == (24, 32, 3)


def test_render_script_bounds_the_frames_waiting_for_their_write(run_dirs, tmp_path, monkeypatch):
    """With one write thread and slow writes, at most 2 frames hold a slot,
    so at most 3 are quantised and not yet written (the third waits for a
    slot), whatever the number of frames; each is written as its uint8
    levels."""
    live, most, written, lock = [0], [0], {}, threading.Lock()
    quantise = TRender.quantise

    def counted(img):
        with lock:
            live[0] += 1
            most[0] = max(most[0], live[0])
        return quantise(img)

    def slow_write(path, image):
        time.sleep(0.02)
        written[path.name] = image
        with lock:
            live[0] -= 1

    monkeypatch.setattr(TRender.os, "cpu_count", lambda: 1)
    monkeypatch.setattr(TRender, "quantise", counted)
    monkeypatch.setattr(TRender, "write_png", slow_write)
    TRender.entrypoint([str(run_dirs / "splatad-tiny"), "--device", "cpu", "--cameras", "all", "--interpolate", "3",
                        "--output-dir", str(tmp_path)])
    n = TINY["num_frames"]
    assert len(written) == 2 * n + 3 * (n - 1) and live[0] == 0
    assert most[0] == 3, most[0]
    assert all(img.dtype == np.uint8 for img in written.values())


def test_quantise_is_the_jax_scripts_policy():
    x = np.random.default_rng(0).normal(0.5, 0.6, (40, 30, 3)).astype(np.float32)
    assert np.array_equal(quantise(x), (np.clip(x, 0, 1) * 255).astype(np.uint8))


@pytest.mark.parametrize("mode,run", [("pointcloud", "splatad-tiny"), ("gaussian-splat", "splatad-tiny"),
                                      ("camera-poses", "splatad-tiny"), ("field-mesh", "neurad-tiny"),
                                      ("tsdf-mesh", "neurad-tiny"), ("poisson", "neurad-tiny")])
def test_export_script_writes_the_jax_file_names(run_dirs, mode, run):
    out = TExport.entrypoint([mode, str(run_dirs / run), "--device", "cpu", "--resolution", "12"])
    suffix = ".json" if mode == "camera-poses" else ".ply"
    assert out == run_dirs / run / f"export_{mode}{suffix}" and out.stat().st_size > 0
    if suffix == ".ply":
        assert out.read_bytes().startswith(b"ply\nformat binary_little_endian 1.0\nelement vertex ")
    else:
        frames = json.loads(out.read_text())["frames"]
        assert len(frames) == TINY["num_frames"] and {f["split"] for f in frames} == {"train", "eval"}


def test_scripts_need_cuda_unless_asked_for_cpu(run_dirs):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRender.entrypoint([str(run_dirs / "splatad-tiny")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TExport.entrypoint(["pointcloud", str(run_dirs / "splatad-tiny")])
