"""Synthetic on-disk sequences in real dataset layouts.

`make_pandaset_fixture` writes a PandaSet-layout sequence (a copy of the JAX
package's `neurad_tpu/data/dataparsers/fixtures.py`: random-content JPEGs,
gaussian-blob scans, cuboid annotations; it needs imageio and pandas).
`make_kittimot_fixture` writes a KITTI-MOT tracking sequence with numpy, zlib
and the port's PNG writer only: camera frames at the sensor's size, HDL-64E
scans ray-cast against a ground plane and two walls, OXTS poses, a calibration
file and tracked moving cars. Both serve tests and the chip smoke run; neither
is an entry point of its own.

Layouts written:
  <root>/<seq>/camera/<cam>_camera/{NN.jpg, poses.json, intrinsics.json, timestamps.json}
  <root>/<seq>/lidar/{NN.pkl.gz, poses.json, timestamps.json}
  <root>/<seq>/annotations/cuboids/{NN.pkl.gz}

  <root>/training/image_02/<seq>/NNNNNN.png
  <root>/training/velodyne/<seq>/NNNNNN.bin
  <root>/training/{oxts,calib,label_02}/<seq>.txt
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Sequence

import numpy as np

def make_pandaset_fixture(
    root: str,
    seq: str = "001",
    n_frames: int = 80,
    cameras: Sequence[str] = ("front",),
    height: int = 1080,
    width: int = 1920,
    points_per_scan: int = 100_000,
    n_actors: int = 8,
    seed: int = 0,
) -> Path:
    """Write a synthetic PandaSet-layout sequence; returns the dataset root.

    Images are smooth gradients + low-amplitude noise (jpg-compressible, so an
    80-frame 1080p sequence stays ~100 MB); scans are gaussian blobs around the
    ego path at realistic point counts.
    """
    import imageio.v2 as imageio
    import pandas as pd

    rng = np.random.default_rng(seed)
    root_p = Path(root)
    seq_dir = root_p / seq
    t0 = 1_600_000_000.0
    times = [t0 + 0.1 * i for i in range(n_frames)]
    poses = [
        {
            "position": {"x": 2.0 * i, "y": 0.0, "z": 1.5},
            "heading": {"w": 1.0, "x": 0.0, "y": 0.0, "z": 0.0},
        }
        for i in range(n_frames)
    ]

    # smooth base image reused with per-frame shifts: fast to generate, and jpg
    # compresses it well while still exercising full decode cost at load time
    yy, xx = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
    base = np.stack([yy, xx, 0.5 * (xx + yy)], axis=-1)

    for cam in cameras:
        cam_dir = seq_dir / "camera" / f"{cam}_camera"
        cam_dir.mkdir(parents=True, exist_ok=True)
        (cam_dir / "poses.json").write_text(json.dumps(poses))
        (cam_dir / "intrinsics.json").write_text(
            json.dumps({"fx": 0.8 * width, "fy": 0.8 * width, "cx": width / 2, "cy": height / 2})
        )
        (cam_dir / "timestamps.json").write_text(json.dumps(times))
        for i in range(n_frames):
            # zlib.crc32, not hash(): PYTHONHASHSEED randomizes str hash per
            # process, which would make fixture content irreproducible across
            # runs (a benchmark reusing --keep vs regenerating differs)
            img = base * (0.6 + 0.4 * np.sin(0.3 * i + zlib.crc32(cam.encode()) % 7))
            img = img + rng.uniform(0, 0.08, size=(height, width, 1))
            imageio.imwrite(cam_dir / f"{i:02d}.jpg", (np.clip(img, 0, 1) * 255).astype(np.uint8))

    lid_dir = seq_dir / "lidar"
    lid_dir.mkdir(parents=True, exist_ok=True)
    (lid_dir / "poses.json").write_text(json.dumps(poses))
    (lid_dir / "timestamps.json").write_text(json.dumps(times))
    for i in range(n_frames):
        n = points_per_scan
        world = rng.normal(size=(n, 3)) * np.array([30.0, 12.0, 2.0]) + np.array([2.0 * i, 0.0, 1.5])
        df = pd.DataFrame(
            {
                "x": world[:, 0],
                "y": world[:, 1],
                "z": world[:, 2],
                "i": rng.integers(0, 255, n).astype(np.float64),
                "t": t0 + 0.1 * i + rng.uniform(-0.04, 0.04, n),
                "d": np.zeros(n),
            }
        )
        df.to_pickle(lid_dir / f"{i:02d}.pkl.gz")

    cub_dir = seq_dir / "annotations" / "cuboids"
    cub_dir.mkdir(parents=True, exist_ok=True)
    labels = ["Car", "Pedestrian", "Pickup Truck", "Bicycle"]
    for i in range(n_frames):
        rows = {
            "uuid": [f"actor-{a}" for a in range(n_actors)],
            "label": [labels[a % len(labels)] for a in range(n_actors)],
            "yaw": [0.05 * i * ((a % 3) - 1) for a in range(n_actors)],
            "stationary": [False] * n_actors,
            "position.x": [2.0 * i + 8.0 + 3.0 * a for a in range(n_actors)],
            "position.y": [(-1) ** a * (2.0 + a) for a in range(n_actors)],
            "position.z": [1.0] * n_actors,
            "dimensions.x": [2.0] * n_actors,
            "dimensions.y": [4.5] * n_actors,
            "dimensions.z": [1.6] * n_actors,
            "cuboids.sensor_id": [-1] * n_actors,
            "cuboids.sibling_id": [None] * n_actors,
        }
        pd.DataFrame(rows).to_pickle(cub_dir / f"{i:02d}.pkl.gz")

    return root_p


# A KITTI calibration (sequence 0006's P2; the velodyne -> camera and IMU ->
# velodyne transforms with their small rotations rounded away)
KITTI_P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728], [0.0, 721.5377, 172.854, 0.2163791],
                     [0.0, 0.0, 1.0, 0.002745884]])
KITTI_VELO_TO_CAM = np.array([[0.0, -1.0, 0.0, -0.004069766], [0.0, 0.0, -1.0, -0.07631618],
                              [1.0, 0.0, 0.0, -0.2717806]])
KITTI_IMU_TO_VELO = np.array([[1.0, 0.0, 0.0, -0.8086759], [0.0, 1.0, 0.0, 0.3195559], [0.0, 0.0, 1.0, -0.7997231]])
IMU_HEIGHT = 0.93  # metres above the road
EGO_SPEED, WALL_OFFSET, MAX_RANGE, DROP_FRACTION = 10.0, 8.0, 120.0, 0.05  # m/s, m, m, share of beams


def _hdl64e_directions() -> np.ndarray:
    """Unit beam directions [64 * A, 3] of one HDL-64E revolution in the sensor
    frame: the beam table's elevations, azimuth steps at the bin centres of
    its 0.1728 degree resolution."""
    from neurad_tpu_torch.data.lidar_elevation_mappings import AZIMUTH_RESOLUTION, ELEVATION_MAPPINGS

    res = AZIMUTH_RESOLUTION["VELODYNE64E"]
    n_azim = int(round(360.0 / res))
    elev = np.deg2rad(ELEVATION_MAPPINGS["VELODYNE64E"].astype(np.float64))
    azim = np.deg2rad(-180.0 + (np.arange(n_azim) + 0.5) * res)
    el, az = np.meshgrid(elev, azim, indexing="ij")
    return np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1).reshape(-1, 3)


def make_kittimot_fixture(
    root: str,
    seq: str = "0006",
    n_frames: int = 20,
    height: int = 375,
    width: int = 1242,
    azimuth_stride: int = 1,
    seed: int = 0,
) -> Path:
    """Write a KITTI-MOT-layout sequence at 10 Hz; returns the dataset root.

    The ego drives east at 10 m/s on a flat road between two walls 8 m to
    either side. Each scan holds every HDL-64E beam that meets the road or a
    wall within 120 m, less a random 5% (about 120,000 points); reflectance 0.2-0.4
    on the road, 0.5-0.7 on the walls; `azimuth_stride` keeps every so many
    azimuth steps (small scans for tests). Frames are smooth gradients with
    noise and stripes below the horizon; the intrinsics are P2's, scaled to
    `height` x `width`.
    label_02 holds two cars driving in the lanes beside the ego (one each way),
    a parked van and a pedestrian crossing, as rectified-camera boxes.
    """
    from neurad_tpu_torch.data.dataparsers.kitti import EARTH_RADIUS, FRAME_RATE, _oxts_to_pose
    from neurad_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    train = Path(root) / "training"
    for sub in (f"image_02/{seq}", f"velodyne/{seq}", "label_02", "oxts", "calib"):
        (train / sub).mkdir(parents=True, exist_ok=True)

    # OXTS: lat lon alt roll pitch yaw, then 24 rates and accuracies
    lat0, lon0, alt = 49.011, 8.4227, 112.8
    scale = np.cos(np.deg2rad(lat0))
    times = np.arange(n_frames) / FRAME_RATE
    lon = lon0 + np.rad2deg(EGO_SPEED * times / (scale * EARTH_RADIUS))
    oxts = np.zeros((n_frames, 30))
    oxts[:, 0], oxts[:, 1], oxts[:, 2] = lat0, lon, alt
    oxts[:, 8] = EGO_SPEED  # forward velocity
    np.savetxt(train / "oxts" / f"{seq}.txt", oxts, fmt="%.10g")

    r_rect = np.eye(3)
    p2 = KITTI_P2 * np.array([[width / 1242.0], [height / 375.0], [1.0]])
    calib = [f"P{i}: " + " ".join(f"{v:.12e}" for v in p2.reshape(-1)) for i in range(4)]
    calib += ["R_rect " + " ".join(f"{v:.12e}" for v in r_rect.reshape(-1)),
              "Tr_velo_cam " + " ".join(f"{v:.12e}" for v in KITTI_VELO_TO_CAM.reshape(-1)),
              "Tr_imu_velo " + " ".join(f"{v:.12e}" for v in KITTI_IMU_TO_VELO.reshape(-1))]
    (train / "calib" / f"{seq}.txt").write_text("\n".join(calib) + "\n")

    # the parser's poses: IMU -> world with the first frame at the origin
    imu = np.stack([_oxts_to_pose(row, scale) for row in np.loadtxt(train / "oxts" / f"{seq}.txt").reshape(-1, 30)])
    imu = np.linalg.inv(imu[0])[None] @ imu
    to4 = lambda m: np.concatenate([m, [[0.0, 0.0, 0.0, 1.0]]])
    velo = imu @ np.linalg.inv(to4(KITTI_IMU_TO_VELO))[None]
    cam = imu @ np.linalg.inv(to4(KITTI_VELO_TO_CAM) @ to4(KITTI_IMU_TO_VELO))[None]

    dirs = _hdl64e_directions().reshape(64, -1, 3)[:, ::azimuth_stride].reshape(-1, 3)
    ground_z = -IMU_HEIGHT
    for i in range(n_frames):
        origin, rot = velo[i, :3, 3], velo[i, :3, :3]
        d = dirs @ rot.T
        with np.errstate(divide="ignore", invalid="ignore"):
            t_ground = np.where(d[:, 2] < -1e-9, (ground_z - origin[2]) / d[:, 2], np.inf)
            t_left = np.where(d[:, 1] > 1e-9, (WALL_OFFSET - origin[1]) / d[:, 1], np.inf)
            t_right = np.where(d[:, 1] < -1e-9, (-WALL_OFFSET - origin[1]) / d[:, 1], np.inf)
        t = np.minimum(t_ground, np.minimum(t_left, t_right))
        keep = (t < MAX_RANGE) & (rng.uniform(size=t.shape) >= DROP_FRACTION)
        on_ground = t_ground <= np.minimum(t_left, t_right)
        refl = np.where(on_ground, rng.uniform(0.2, 0.4, t.shape), rng.uniform(0.5, 0.7, t.shape))
        pts = np.concatenate([dirs[keep] * t[keep, None], refl[keep, None]], axis=-1).astype(np.float32)
        pts.tofile(train / "velodyne" / seq / f"{i:06d}.bin")

    yy, xx = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
    base = np.stack([yy, xx, 0.5 * (xx + yy)], axis=-1)
    for i in range(n_frames):
        img = base * (0.6 + 0.4 * np.sin(0.3 * i)) + rng.uniform(0, 0.08, size=(height, width, 1))
        # slanted stripes below the horizon, so that `write_png` (libpng's
        # filter heuristic) writes Sub, Up, Average and Paeth rows
        img += 0.2 * ((np.sin(xx * 300 + 40 * yy + i) > 0) & (yy > 0.5))[..., None]
        write_png(train / "image_02" / seq / f"{i:06d}.png", (np.clip(img, 0, 1) * 255).astype(np.uint8), level=1)

    # actors in the world: (track id, class, h w l, start xy, velocity xy)
    actors = [(0, "Car", (1.5, 1.7, 4.2), (12.0, 3.5), (14.0, 0.0)),
              (1, "Car", (1.6, 1.8, 4.5), (70.0, -3.5), (-9.0, 0.0)),
              (2, "Van", (2.2, 1.9, 5.0), (30.0, 6.0), (0.0, 0.0)),
              (3, "Pedestrian", (1.75, 0.6, 0.8), (25.0, -6.0), (0.0, 1.4))]
    lines = []
    for i in range(n_frames):
        w2c = np.linalg.inv(cam[i])
        for tid, cls, (h, w, l), start, vel in actors:
            centre = np.array([start[0] + vel[0] * times[i], start[1] + vel[1] * times[i], ground_z + h / 2.0, 1.0])
            heading = np.arctan2(vel[1], vel[0]) if any(vel) else 0.0
            c = w2c @ centre
            f = w2c[:3, :3] @ np.array([np.cos(heading), np.sin(heading), 0.0])
            ry = np.arctan2(-f[2], f[0])
            if c[2] < 1.0:
                continue  # behind the camera
            lines.append(f"{i} {tid} {cls} 0 0 0.0 0 0 0 0 {h:.4f} {w:.4f} {l:.4f} "
                         f"{c[0]:.4f} {c[1] + h / 2.0:.4f} {c[2]:.4f} {ry:.4f}")
    (train / "label_02" / f"{seq}.txt").write_text("\n".join(lines) + "\n")
    return Path(root)
