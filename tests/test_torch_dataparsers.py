"""The port's dataparsers against the JAX package's, on the same on-disk
scenes: PandaSet, KITTI-MOT, Argoverse 2, nuScenes and Waymo (v2 parquet).

Each scene is written once to disk (the layouts of tests/data/test_pandaset.py,
test_kitti_argoverse.py and test_nuscenes.py; KITTI-MOT by the port's
`make_kittimot_fixture`; Waymo's v2 tables here, as no JAX test writes one) and
parsed by both packages, then every output array is compared: cameras, lidars,
point clouds, images, scene box, trajectories and their velocities, splits and
metadata.

Tolerances. Both sides run the same numpy for the sensors, the splits, the
scene box and the point clouds: those are held exactly. Actor tracks are
resampled at the lidar times in float32 on both sides (JAX `jnp`, the port
torch): their poses are held to 1e-5 relative and 1e-4 m, their
finite-difference velocities (over 0.1-0.5 s) to 2e-3 (m/s, rad/s) plus 1e-4
relative. The missing-point synthesis is compared once with
`add_missing_points=False` (exact), then bin by bin: the JAX package bins with
its C++ `bin_points` (float32, `atan2f`), the port in numpy float32, and as in
tests/test_native.py the two may put a boundary point in the neighbouring
azimuth bin: the missing bins may differ in < 1e-3 of the grid.
"""

import io
import json

import imageio.v2 as imageio
import numpy as np
import pandas as pd
import pytest
import torch

import neurad_tpu.data.dataparsers.pandaset as jps
import neurad_tpu_torch.data.dataparsers.pandaset as tps
from neurad_tpu.data.dataparsers.argoverse2 import Argoverse2DataParserConfig as JAV2
from neurad_tpu.data.dataparsers.kitti import KittiMotDataParserConfig as JKitti
from neurad_tpu.data.dataparsers.nuscenes import NuScenesDataParserConfig as JNus
from neurad_tpu.data.dataparsers.waymo import WaymoDataParserConfig as JWaymo
from neurad_tpu.data.lidar_elevation_mappings import AZIMUTH_RESOLUTION, ELEVATION_MAPPINGS
from neurad_tpu_torch.configs.method_configs import get_dataparser
from neurad_tpu_torch.data.dataparsers.ad_dataparser import DUMMY_DISTANCE_VALUE
from neurad_tpu_torch.data.dataparsers.fixtures import make_kittimot_fixture

torch.set_num_threads(1)

N = 4
POSE_RTOL, POSE_ATOL = 1e-5, 1e-4
VEL_ATOL, VEL_RTOL = 2e-3, 1e-4
BIN_FRACTION = 1e-3


# ---------------------------------------------------------------------------
# scenes on disk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pandaset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pandaset")
    seq = root / "001"
    t0 = 1_600_000_000.0
    cam_dir = seq / "camera" / "front_camera"
    cam_dir.mkdir(parents=True)
    poses = [{"position": {"x": 2.0 * i, "y": 0.1 * i * i, "z": 1.5},
              "heading": {"w": np.cos(0.02 * i), "x": 0.0, "y": 0.0, "z": np.sin(0.02 * i)}} for i in range(N)]
    (cam_dir / "poses.json").write_text(json.dumps(poses))
    (cam_dir / "intrinsics.json").write_text(json.dumps({"fx": 100.0, "fy": 100.0, "cx": 16.0, "cy": 12.0}))
    (cam_dir / "timestamps.json").write_text(json.dumps([t0 + 0.1 * i for i in range(N)]))
    rng = np.random.default_rng(0)
    for i in range(N):
        imageio.imwrite(cam_dir / f"{i:02d}.jpg", rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    lid_dir = seq / "lidar"
    lid_dir.mkdir(parents=True)
    (lid_dir / "poses.json").write_text(json.dumps(poses))
    (lid_dir / "timestamps.json").write_text(json.dumps([t0 + 0.1 * i for i in range(N)]))
    for i in range(N):
        n = 400
        world = rng.normal(size=(n, 3)) * 10 + np.array([2.0 * i, 0, 1.5])
        pd.DataFrame({"x": world[:, 0], "y": world[:, 1], "z": world[:, 2],
                      "i": rng.integers(0, 255, n).astype(np.float64),
                      "t": t0 + 0.1 * i + rng.uniform(-0.04, 0.04, n),
                      "d": rng.integers(0, 2, n).astype(np.float64)}).to_pickle(lid_dir / f"{i:02d}.pkl.gz")
    cub_dir = seq / "annotations" / "cuboids"
    cub_dir.mkdir(parents=True)
    for i in range(N):
        pd.DataFrame({
            "uuid": ["actor-1", "actor-2", "actor-3"], "label": ["Car", "Pedestrian", "Bus"],
            "yaw": [0.1 * i, 0.0, 0.3], "stationary": [False, False, True],
            "position.x": [5.0 + i, -3.0 + 0.4 * i, 9.0], "position.y": [2.0, 1.0, -4.0],
            "position.z": [1.0, 1.0, 1.5], "dimensions.x": [2.0, 0.8, 2.5], "dimensions.y": [4.5, 0.8, 11.0],
            "dimensions.z": [1.6, 1.8, 3.0], "cuboids.sensor_id": [-1, -1, -1],
            "cuboids.sibling_id": [None, None, None],
        }).to_pickle(cub_dir / f"{i:02d}.pkl.gz")
    return root


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    make_kittimot_fixture(str(root), seq="0006", n_frames=8, height=40, width=120, azimuth_stride=24, seed=3)
    return root


@pytest.fixture(scope="module")
def argoverse_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("av2")
    log = root / "log-abc"
    (log / "calibration").mkdir(parents=True)
    (log / "sensors" / "cameras" / "ring_front_center").mkdir(parents=True)
    (log / "sensors" / "lidar").mkdir(parents=True)
    t0 = 1_000_000_000_000_000_000
    pd.DataFrame([{"timestamp_ns": t0 + i * 100_000_000, "qw": 1.0, "qx": 0.0, "qy": 0.0, "qz": 0.0,
                   "tx_m": 2.0 * i, "ty_m": 0.0, "tz_m": 0.0} for i in range(N)]
                 ).to_feather(log / "city_SE3_egovehicle.feather")
    pd.DataFrame([{"sensor_name": "ring_front_center", "qw": 0.5, "qx": -0.5, "qy": 0.5, "qz": -0.5,
                   "tx_m": 1.6, "ty_m": 0.0, "tz_m": 1.4}]).to_feather(log / "calibration" / "egovehicle_SE3_sensor.feather")
    pd.DataFrame([{"sensor_name": "ring_front_center", "fx_px": 100.0, "fy_px": 100.0, "cx_px": 16.0,
                   "cy_px": 12.0, "width_px": 32, "height_px": 24, "k1": 0.0, "k2": 0.0, "k3": 0.0}]
                 ).to_feather(log / "calibration" / "intrinsics.feather")
    rng = np.random.default_rng(1)
    for i in range(N):
        t_ns = t0 + i * 100_000_000
        imageio.imwrite(log / "sensors" / "cameras" / "ring_front_center" / f"{t_ns}.jpg",
                        rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
        pd.DataFrame({
            "x": rng.normal(size=160).astype(np.float32) * 10, "y": rng.normal(size=160).astype(np.float32) * 10,
            "z": rng.normal(size=160).astype(np.float32) * 3, "intensity": rng.uniform(0, 255, 160).astype(np.float32),
            "laser_number": rng.integers(0, 32, 160).astype(np.uint8),
            "offset_ns": rng.integers(0, 100_000_000, 160).astype(np.int64),
        }).to_feather(log / "sensors" / "lidar" / f"{t_ns}.feather")
    pd.DataFrame([{"timestamp_ns": t0 + i * 100_000_000, "track_uuid": "actor-1", "category": "REGULAR_VEHICLE",
                   "length_m": 4.5, "width_m": 2.0, "height_m": 1.6, "qw": np.cos(0.05 * i), "qx": 0.0, "qy": 0.0,
                   "qz": np.sin(0.05 * i), "tx_m": 10.0 + i, "ty_m": 2.0, "tz_m": 0.8, "num_interior_pts": 50}
                  for i in range(N)]).to_feather(log / "annotations.feather")
    return root


@pytest.fixture(scope="module")
def nuscenes_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("nuscenes")
    tdir = root / "v1.0-mini"
    tdir.mkdir()
    t0 = 1_500_000_000_000_000
    scene = [{"token": "sc0", "name": "scene-0001", "first_sample_token": "s0", "last_sample_token": f"s{N - 1}",
              "nbr_samples": N, "log_token": "l0", "description": ""}]
    samples, sample_data, ego_poses, annotations = [], [], [], []
    for i in range(N):
        samples.append({"token": f"s{i}", "timestamp": t0 + i * 500_000, "scene_token": "sc0",
                        "prev": f"s{i - 1}" if i else "", "next": f"s{i + 1}" if i < N - 1 else ""})
        for kind in ("cam", "lid"):
            ego_poses.append({"token": f"ep_{kind}{i}", "translation": [2.0 * i, 0.1 * i, 0.0],
                              "rotation": [1.0, 0.0, 0.0, 0.0], "timestamp": t0 + i * 500_000})
        sample_data.append({"token": f"sd_cam{i}", "sample_token": f"s{i}", "ego_pose_token": f"ep_cam{i}",
                            "calibrated_sensor_token": "cs_cam", "timestamp": t0 + i * 500_000, "fileformat": "jpg",
                            "is_key_frame": True, "height": 24, "width": 32,
                            "filename": f"samples/CAM_FRONT/{i}.jpg", "prev": "", "next": ""})
        sample_data.append({"token": f"sd_lid{i}", "sample_token": f"s{i}", "ego_pose_token": f"ep_lid{i}",
                            "calibrated_sensor_token": "cs_lid", "timestamp": t0 + i * 500_000, "fileformat": "pcd",
                            "is_key_frame": True, "height": 0, "width": 0,
                            "filename": f"samples/LIDAR_TOP/{i}.pcd.bin", "prev": "", "next": ""})
        annotations.append({"token": f"a{i}", "sample_token": f"s{i}", "instance_token": "inst0",
                            "translation": [10.0 + i, 2.0, 1.0], "size": [2.0, 4.5, 1.6],
                            "rotation": [np.cos(0.05 * i), 0.0, 0.0, np.sin(0.05 * i)], "prev": "", "next": "",
                            "visibility_token": "4", "attribute_tokens": [], "num_lidar_pts": 50, "num_radar_pts": 0})
    calibrated = [
        {"token": "cs_cam", "sensor_token": "sens_cam", "translation": [1.5, 0.0, 1.5],
         "rotation": [0.5, -0.5, 0.5, -0.5], "camera_intrinsic": [[100.0, 0, 16.0], [0, 100.0, 12.0], [0, 0, 1]]},
        {"token": "cs_lid", "sensor_token": "sens_lid", "translation": [0.9, 0.0, 1.8],
         "rotation": [1.0, 0.0, 0.0, 0.0], "camera_intrinsic": []},
    ]
    sensors = [{"token": "sens_cam", "channel": "CAM_FRONT", "modality": "camera"},
               {"token": "sens_lid", "channel": "LIDAR_TOP", "modality": "lidar"}]
    categories = [{"token": "cat_car", "name": "vehicle.car", "description": ""}]
    instances = [{"token": "inst0", "category_token": "cat_car", "nbr_annotations": N,
                  "first_annotation_token": "a0", "last_annotation_token": f"a{N - 1}"}]
    for name, rows in [("scene", scene), ("sample", samples), ("sample_data", sample_data), ("ego_pose", ego_poses),
                       ("calibrated_sensor", calibrated), ("sensor", sensors), ("instance", instances),
                       ("sample_annotation", annotations), ("category", categories)]:
        (tdir / f"{name}.json").write_text(json.dumps(rows))
    rng = np.random.default_rng(0)
    (root / "samples" / "CAM_FRONT").mkdir(parents=True)
    (root / "samples" / "LIDAR_TOP").mkdir(parents=True)
    for i in range(N):
        imageio.imwrite(root / "samples" / "CAM_FRONT" / f"{i}.jpg", rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
        raw = np.concatenate([rng.normal(size=(200, 3)).astype(np.float32) * 10,
                              rng.uniform(0, 255, (200, 1)).astype(np.float32),
                              rng.integers(0, 32, (200, 1)).astype(np.float32)], axis=-1)
        raw.tofile(root / "samples" / "LIDAR_TOP" / f"{i}.pcd.bin")
    return root


def _flat(m) -> list:
    return [float(v) for v in np.asarray(m, dtype=np.float64).reshape(-1)]


@pytest.fixture(scope="module")
def waymo_dir(tmp_path_factory):
    """The v2 ("modular") parquet tables of one segment: two cameras' frames
    (JPEG bytes), calibrations, vehicle poses, TOP-lidar range images with
    their calibration, and lidar boxes of a moving vehicle, a pedestrian and a
    parked vehicle."""
    root = tmp_path_factory.mktemp("waymo")
    split = root / "training"
    seg = "seg-0001"
    rng = np.random.default_rng(2)
    times = [1_550_000_000_000_000 + 100_000 * i for i in range(N)]
    poses = []
    for i in range(N):
        m = np.eye(4)
        c, s = np.cos(0.03 * i), np.sin(0.03 * i)
        m[:2, :2] = [[c, -s], [s, c]]
        m[:3, 3] = [1.5 * i, 0.2 * i, 0.1]
        poses.append(m)
    tables = {
        "vehicle_pose": pd.DataFrame({"key.segment_context_name": seg, "key.frame_timestamp_micros": times,
                                      "[VehiclePoseComponent].world_from_vehicle.transform": [_flat(m) for m in poses]}),
        "camera_calibration": pd.DataFrame({
            "key.segment_context_name": seg, "key.camera_name": [1, 2],
            "[CameraCalibrationComponent].intrinsic.f_u": [120.0, 110.0],
            "[CameraCalibrationComponent].intrinsic.f_v": [121.0, 111.0],
            "[CameraCalibrationComponent].intrinsic.c_u": [20.0, 19.0],
            "[CameraCalibrationComponent].intrinsic.c_v": [12.0, 11.0],
            "[CameraCalibrationComponent].width": [40, 40], "[CameraCalibrationComponent].height": [24, 24],
            "[CameraCalibrationComponent].extrinsic.transform": [
                _flat([[1, 0, 0, 1.5], [0, 1, 0, 0], [0, 0, 1, 2.0], [0, 0, 0, 1]]),
                _flat([[0.9, -0.436, 0, 1.4], [0.436, 0.9, 0, 0.3], [0, 0, 1, 2.0], [0, 0, 0, 1]])]}),
    }
    rows = []
    for cam in (1, 2):
        for t in times:
            buf = io.BytesIO()
            imageio.imwrite(buf, rng.integers(0, 255, (24, 40, 3), dtype=np.uint8), format="jpg")
            rows.append({"key.segment_context_name": seg, "key.frame_timestamp_micros": t, "key.camera_name": cam,
                         "[CameraImageComponent].image": buf.getvalue()})
    tables["camera_image"] = pd.DataFrame(rows)
    h, w = 8, 64
    lid_rows = []
    for t in times:
        ri = np.zeros((h, w, 4), np.float32)
        ri[..., 0] = rng.uniform(3.0, 40.0, (h, w)) * (rng.uniform(size=(h, w)) > 0.1)
        ri[..., 1] = rng.uniform(0.0, 2.0, (h, w))
        lid_rows.append({"key.segment_context_name": seg, "key.frame_timestamp_micros": t, "key.laser_name": 1,
                         "[LiDARComponent].range_image_return1.values": ri.reshape(-1).tolist(),
                         "[LiDARComponent].range_image_return1.shape": [h, w, 4]})
    tables["lidar"] = pd.DataFrame(lid_rows)
    tables["lidar_calibration"] = pd.DataFrame({
        "key.segment_context_name": seg, "key.laser_name": [1],
        "[LiDARCalibrationComponent].extrinsic.transform": [_flat([[np.cos(0.1), -np.sin(0.1), 0, 1.4],
                                                                   [np.sin(0.1), np.cos(0.1), 0, 0.0],
                                                                   [0, 0, 1, 2.2], [0, 0, 0, 1]])],
        "[LiDARCalibrationComponent].beam_inclination.min": [-0.3],
        "[LiDARCalibrationComponent].beam_inclination.max": [0.05]})
    boxes = []
    for i, t in enumerate(times):
        for oid, otype, cx, cy, heading in (("veh-1", 1, 10.0 + 1.2 * i, 3.0, 0.1 * i), ("ped-1", 2, 6.0, -3.0 + 0.3 * i, 1.5),
                                            ("veh-2", 1, 20.0, -5.0, 0.0)):
            boxes.append({"key.segment_context_name": seg, "key.frame_timestamp_micros": t, "key.laser_object_id": oid,
                          "[LiDARBoxComponent].type": otype, "[LiDARBoxComponent].box.heading": heading,
                          "[LiDARBoxComponent].box.center.x": cx, "[LiDARBoxComponent].box.center.y": cy,
                          "[LiDARBoxComponent].box.center.z": 0.8, "[LiDARBoxComponent].box.size.x": 4.5,
                          "[LiDARBoxComponent].box.size.y": 2.0, "[LiDARBoxComponent].box.size.z": 1.6})
    tables["lidar_box"] = pd.DataFrame(boxes)
    for name, df in tables.items():
        (split / name).mkdir(parents=True)
        df.to_parquet(split / name / f"{seg}.parquet")
    return root


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def _np(x):
    return None if x is None else (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _same(got, want, msg):
    got, want = _np(got), _np(want)
    if want is None:
        assert got is None, msg
        return
    assert got.shape == want.shape, f"{msg}: shape {got.shape} != {want.shape}"
    assert got.dtype == want.dtype or (got.dtype.kind == want.dtype.kind), f"{msg}: dtype {got.dtype} vs {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _assert_outputs(t, j, missing_points: bool = False):
    """Every output of the port's parse against the JAX package's."""
    for f in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height", "camera_type", "distortion_params",
              "times"):
        _same(getattr(t.cameras, f), getattr(j.cameras, f), f"cameras.{f}")
    assert t.cameras.metadata.keys() == j.cameras.metadata.keys()
    for k in j.cameras.metadata:
        _same(t.cameras.metadata[k], j.cameras.metadata[k], f"cameras.metadata[{k}]")
    for f in ("lidar_to_worlds", "lidar_type", "times"):
        _same(getattr(t.lidars, f), getattr(j.lidars, f), f"lidars.{f}")
    assert t.lidars.metadata.keys() == j.lidars.metadata.keys()
    for k in j.lidars.metadata:
        _same(t.lidars.metadata[k], j.lidars.metadata[k], f"lidars.metadata[{k}]")
    assert len(t.images) == len(j.images)
    for a, b in zip(t.images, j.images):
        _same(a, b, "image")
    _same(t.scene_box.aabb, j.scene_box.aabb, "scene_box.aabb")
    assert t.duration == j.duration and t.sensor_idx_to_name == j.sensor_idx_to_name
    assert t.eval_camera_indices == j.eval_camera_indices and t.eval_lidar_indices == j.eval_lidar_indices
    assert t.metadata.keys() == j.metadata.keys()
    for k, v in j.metadata.items():
        if isinstance(v, np.ndarray):
            _same(t.metadata[k], v, f"metadata[{k}]")
        else:
            assert t.metadata[k] == v, k
    assert len(t.point_clouds) == len(j.point_clouds)
    if not missing_points:
        for a, b in zip(t.point_clouds, j.point_clouds):
            _same(a, b, "point cloud")
    assert len(t.trajectories) == len(j.trajectories) > 0
    for a, b in zip(t.trajectories, j.trajectories):
        assert a.keys() == b.keys()
        for k, want in b.items():
            if k in ("poses", "timestamps"):
                np.testing.assert_allclose(a[k], want, rtol=POSE_RTOL, atol=POSE_ATOL, err_msg=k)
                assert np.asarray(a[k]).dtype == np.asarray(want).dtype, k
            elif k in ("linear_velocities_global", "angular_velocities_local"):
                np.testing.assert_allclose(a[k], want, rtol=VEL_RTOL, atol=VEL_ATOL, err_msg=k)
            elif isinstance(want, np.ndarray):
                _same(a[k], want, k)
            else:
                assert a[k] == want, k


def _missing_grid(pc, n_real, lidar):
    """(channel, azimuth bin) occupancy of the synthesised points of a scan."""
    elevs, res = ELEVATION_MAPPINGS[lidar], AZIMUTH_RESOLUTION[lidar]
    n_azim = int(round(360.0 / res))
    pts = pc[n_real:, :3].astype(np.float64)
    assert np.allclose(np.linalg.norm(pts, axis=-1), DUMMY_DISTANCE_VALUE, rtol=1e-5)
    elev = np.rad2deg(np.arctan2(pts[:, 2], np.linalg.norm(pts[:, :2], axis=-1)))
    ch = np.abs(elev[:, None] - elevs[None, :]).argmin(-1)
    az = np.round((np.rad2deg(np.arctan2(pts[:, 1], pts[:, 0])) + 180.0 - res / 2) / res).astype(int) % n_azim
    grid = np.zeros((len(elevs), n_azim), bool)
    grid[ch, az] = True
    return grid


def _assert_missing_points(t_miss, j_miss, t_plain, lidar):
    """The synthesised points bin by bin: the real points first and equal,
    then the missing bins' grids differ in < BIN_FRACTION of the grid."""
    for tm, jm, plain in zip(t_miss.point_clouds, j_miss.point_clouds, t_plain.point_clouds):
        n = plain.shape[0]
        np.testing.assert_array_equal(tm[:n], plain)
        np.testing.assert_array_equal(jm[:n], plain)
        assert tm.shape[0] > n and jm.shape[0] > n, "missing points were added"
        gt, gj = _missing_grid(tm, n, lidar), _missing_grid(jm, n, lidar)
        assert (gt != gj).mean() < BIN_FRACTION, f"{(gt != gj).sum()} of {gt.size} bins differ"
        assert abs(tm.shape[0] - jm.shape[0]) <= BIN_FRACTION * gt.size


def _parse_both(jcfg_cls, name, miss=False, **kw):
    j = jcfg_cls(add_missing_points=miss, **kw).setup().get_dataparser_outputs()
    t = get_dataparser(name, add_missing_points=miss, **kw).get_dataparser_outputs()
    return t, j


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


@pytest.fixture
def pandaset_len(monkeypatch):
    monkeypatch.setattr(jps, "PANDASET_SEQ_LEN", N)
    monkeypatch.setattr(tps, "PANDASET_SEQ_LEN", N)


def test_pandaset_matches_jax(pandaset_dir, pandaset_len):
    kw = dict(data=str(pandaset_dir), sequence="001", train_split_fraction=0.5)
    t, j = _parse_both(jps.PandaSetDataParserConfig, "pandaset", **kw)
    _assert_outputs(t, j)
    assert {tr["label"] for tr in t.trajectories} == {"Car", "Pedestrian"}
    assert "rolling_shutter_time" in t.cameras.metadata and t.images[0].dtype == np.uint8
    tm, jm = _parse_both(jps.PandaSetDataParserConfig, "pandaset", miss=True, **kw)
    _assert_outputs(tm, jm, missing_points=True)
    _assert_missing_points(tm, jm, t, "PANDAR64")


def test_kitti_fixture_matches_jax(kitti_dir):
    """The JAX parser reads `make_kittimot_fixture`'s sequence as the port's
    parser does (the port decodes the PNGs with its own reader)."""
    kw = dict(data=str(kitti_dir), sequence="0006", train_split_fraction=0.75)
    t, j = _parse_both(JKitti, "kitti", **kw)
    _assert_outputs(t, j)
    assert sorted(tr["label"] for tr in t.trajectories) == ["Car", "Car", "Pedestrian"]
    assert t.images[0].shape == (40, 120, 3) and t.images[0].dtype == np.uint8
    tm, jm = _parse_both(JKitti, "kitti", miss=True, **kw)
    _assert_outputs(tm, jm, missing_points=True)
    _assert_missing_points(tm, jm, t, "VELODYNE64E")


def test_argoverse2_matches_jax(argoverse_dir):
    kw = dict(data=str(argoverse_dir), sequence="log-abc", train_split_fraction=0.5)
    t, j = _parse_both(JAV2, "argoverse2", **kw)
    _assert_outputs(t, j)
    tm, jm = _parse_both(JAV2, "argoverse2", miss=True, **kw)
    _assert_outputs(tm, jm, missing_points=True)
    _assert_missing_points(tm, jm, t, "ARGOVERSE2_VLP32C")


def test_nuscenes_matches_jax(nuscenes_dir):
    kw = dict(data=str(nuscenes_dir), sequence="scene-0001", train_split_fraction=0.5)
    t, j = _parse_both(JNus, "nuscenes", **kw)
    _assert_outputs(t, j)
    tm, jm = _parse_both(JNus, "nuscenes", miss=True, **kw)
    _assert_outputs(tm, jm, missing_points=True)
    _assert_missing_points(tm, jm, t, "VELODYNE_HDL32E")


def test_waymo_matches_jax(waymo_dir):
    kw = dict(data=str(waymo_dir), sequence="seg-0001", cameras=("1", "2"), train_split_fraction=0.5)
    t, j = _parse_both(JWaymo, "waymo", **kw)
    _assert_outputs(t, j)
    assert {tr["label"] for tr in t.trajectories} == {"Vehicle", "Pedestrian"}
    assert len(t.images) == 2 * N and np.unique(t.cameras.metadata["sensor_idxs"].numpy()).tolist() == [0, 1]
    tm, jm = _parse_both(JWaymo, "waymo", miss=True, **kw)
    _assert_outputs(tm, jm, missing_points=True)
    _assert_missing_points(tm, jm, t, "WOD64")


def test_zod_needs_its_devkit():
    with pytest.raises(ImportError, match="zod"):
        get_dataparser("zod", data="no-such-dir")
