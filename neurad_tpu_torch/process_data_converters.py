"""Capture-app → transforms.json converters (Polycam, Record3D,
RealityCapture, Metashape, ODM, COLMAP): the port's copy of
`neurad_tpu/process_data_converters.py` (host numpy, the same JSON).

Counterparts of `nerfstudio/process_data/{polycam,record3d,realitycapture,
metashape,odm}_utils.py`: each converter is pure metadata munging — read the
app's pose/intrinsics export, convert to the nerfstudio-convention
transforms.json this framework's `process_data.load_transforms_json` ingests
(OpenGL c2w, +x right / +y up / -z forward, world-axis permutation as noted
per format). No image IO; callers copy/organize images themselves.
"""

from __future__ import annotations

import csv
import json
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def _write(output_dir: Path, data: dict) -> Path:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    out = output_dir / "transforms.json"
    out.write_text(json.dumps(data, indent=2))
    return out


def quat_xyzw_to_matrix(q: np.ndarray) -> np.ndarray:
    """Scalar-last (x, y, z, w) unit quaternions [N, 4] -> rotations [N, 3, 3]
    (Record3D's convention, `record3d_utils.py:46-49`)."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack(
        [
            np.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x**2 + y**2)], -1),
        ],
        axis=-2,
    )


def rodrigues_to_matrix(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle vector -> rotation matrix (ODM shot rotations,
    `odm_utils.py:29-46`)."""
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


# --------------------------------------------------------------------------
# COLMAP sparse-reconstruction parsing (binary + text model formats)
# Reference: `nerfstudio/data/utils/colmap_parsing_utils.py` (COLMAP's own
# read_write_model.py) + `process_data/colmap_utils.py:187-470`. Formats per
# https://colmap.github.io/format.html.
# --------------------------------------------------------------------------

_COLMAP_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def read_colmap_cameras(path: Path) -> Dict[int, dict]:
    """cameras.bin or cameras.txt -> {camera_id: {model, width, height, params}}."""
    import struct

    path = Path(path)
    cams = {}
    if path.suffix == ".txt":
        for line in path.read_text().splitlines():
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cams[int(parts[0])] = {
                "model": parts[1], "width": int(parts[2]), "height": int(parts[3]),
                "params": [float(x) for x in parts[4:]],
            }
        return cams
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = _COLMAP_MODELS[model_id]
            params = struct.unpack(f"<{np_}d", f.read(8 * np_))
            cams[cam_id] = {"model": name, "width": w, "height": h, "params": list(params)}
    return cams


def read_colmap_images(path: Path) -> Dict[int, dict]:
    """images.bin or images.txt -> {image_id: {qvec wxyz, tvec, camera_id, name}}."""
    import struct

    path = Path(path)
    imgs = {}
    if path.suffix == ".txt":
        lines = [l for l in path.read_text().splitlines() if l and not l.startswith("#")]
        for meta in lines[::2]:  # every other line is the 2D-point list
            p = meta.split()
            imgs[int(p[0])] = {
                "qvec": np.array([float(x) for x in p[1:5]]),
                "tvec": np.array([float(x) for x in p[5:8]]),
                "camera_id": int(p[8]), "name": p[9],
            }
        return imgs
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (image_id,) = struct.unpack("<i", f.read(4))
            q = struct.unpack("<4d", f.read(32))
            t = struct.unpack("<3d", f.read(24))
            (camera_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = struct.unpack("<Q", f.read(8))
            f.read(24 * n_pts)  # skip (x, y, point3D_id) triplets
            imgs[image_id] = {
                "qvec": np.array(q), "tvec": np.array(t),
                "camera_id": camera_id, "name": name.decode("utf-8"),
            }
    return imgs


def _qvec_wxyz_to_matrix(q: np.ndarray) -> np.ndarray:
    """COLMAP scalar-FIRST quaternion -> rotation matrix."""
    w, x, y, z = q / np.linalg.norm(q)
    return quat_xyzw_to_matrix(np.array([[x, y, z, w]]))[0]


def _colmap_intrinsics(cam: dict) -> dict:
    m, p = cam["model"], cam["params"]
    out = {"w": cam["width"], "h": cam["height"], "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0}
    if m in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL", "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
        if m in ("SIMPLE_RADIAL", "SIMPLE_RADIAL_FISHEYE"):
            out["k1"] = p[3]
        elif m in ("RADIAL", "RADIAL_FISHEYE"):
            out["k1"], out["k2"] = p[3], p[4]
    elif m in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV"):
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
        if m == "OPENCV":
            out["k1"], out["k2"], out["p1"], out["p2"] = p[4:8]
        elif m == "OPENCV_FISHEYE":
            out["k1"], out["k2"] = p[4], p[5]
            out["k3"], out["k4"] = p[6], p[7]
        elif m == "FULL_OPENCV":
            out["k1"], out["k2"], out["p1"], out["p2"] = p[4:8]
            out["k3"], out["k4"] = p[8], p[9]
    else:
        raise ValueError(f"unsupported COLMAP camera model {m!r}")
    out["camera_model"] = "OPENCV_FISHEYE" if "FISHEYE" in m else "OPENCV"
    return out


def colmap_to_transforms(recon_dir: Path, output_dir: Path) -> dict:
    """COLMAP sparse model dir (cameras/images .bin or .txt) -> transforms.json
    (`colmap_utils.py:404-480` colmap_to_json): w2c inverted to OpenGL c2w,
    world rows permuted (0, 2, 1) with the new z row negated."""
    recon_dir = Path(recon_dir)
    def find(stem):
        for ext in (".bin", ".txt"):
            if (recon_dir / f"{stem}{ext}").exists():
                return recon_dir / f"{stem}{ext}"
        raise FileNotFoundError(f"no {stem}.bin/.txt under {recon_dir}")

    cams = read_colmap_cameras(find("cameras"))
    imgs = read_colmap_images(find("images"))
    if len(set(i["camera_id"] for i in imgs.values())) > 1:
        raise ValueError("only a single shared camera is supported (like the reference)")
    intr = _colmap_intrinsics(next(iter(cams.values())))

    frames = []
    for im_id, im in sorted(imgs.items()):
        w2c = np.eye(4)
        w2c[:3, :3] = _qvec_wxyz_to_matrix(im["qvec"])
        w2c[:3, 3] = im["tvec"]
        c2w = np.linalg.inv(w2c)
        c2w[0:3, 1:3] *= -1  # OpenCV -> OpenGL camera axes
        c2w = c2w[np.array([0, 2, 1, 3]), :]  # gravity-aligned world
        c2w[2, :] *= -1
        frames.append({
            "file_path": f"./images/{im['name']}",
            "transform_matrix": c2w.tolist(),
            "colmap_im_id": im_id,
        })
    data = {**intr, "frames": frames}
    _write(output_dir, data)
    return data


def polycam_to_transforms(
    cameras_dir: Path,
    image_names: List[str],
    output_dir: Path,
    min_blur_score: float = 0.0,
    crop_border_pixels: int = 0,
) -> dict:
    """Polycam keyframes (one JSON per image, row-major t_ij pose entries) ->
    transforms.json (`polycam_utils.py:28-100`). Polycam's world axes are
    permuted (z, x, y) relative to nerfstudio's convention."""
    frames, skipped = [], 0
    for i, name in enumerate(image_names):
        stem = Path(name).stem
        fj = json.loads((Path(cameras_dir) / f"{stem}.json").read_text())
        if fj.get("blur_score", np.inf) < min_blur_score:
            skipped += 1
            continue
        c = crop_border_pixels
        rows = [[fj[f"t_{r}{j}"] for j in range(4)] for r in range(3)]
        # world-axis permutation: nerfstudio rows are polycam rows (2, 0, 1)
        tm = [rows[2], rows[0], rows[1], [0.0, 0.0, 0.0, 1.0]]
        frames.append(
            {
                "fl_x": fj["fx"],
                "fl_y": fj["fy"],
                "cx": fj["cx"] - c,
                "cy": fj["cy"] - c,
                "w": fj["width"] - 2 * c,
                "h": fj["height"] - 2 * c,
                "file_path": f"./images/frame_{i + 1:05d}{Path(name).suffix}",
                "transform_matrix": tm,
            }
        )
    data = {"camera_model": "OPENCV", "orientation_override": "none", "frames": frames,
            "skipped_frames": skipped}
    _write(output_dir, data)
    return data


def record3d_to_transforms(
    metadata_path: Path,
    image_names: List[str],
    output_dir: Path,
    indices: Optional[np.ndarray] = None,
) -> dict:
    """Record3D metadata.json (poses = [qx qy qz qw tx ty tz], column-major K)
    -> transforms.json (`record3d_utils.py:28-96`)."""
    md = json.loads(Path(metadata_path).read_text())
    poses = np.asarray(md["poses"], np.float64)  # [N, 7]
    if indices is None:
        indices = np.arange(len(image_names))
    rot = quat_xyzw_to_matrix(poses[:, :4])
    c2w = np.concatenate([rot, poses[:, 4:, None]], axis=-1)[np.asarray(indices)]
    frames = [
        {"file_path": name, "transform_matrix": np.vstack([m, [0, 0, 0, 1]]).tolist()}
        for name, m in zip(image_names, c2w)
    ]
    K = np.asarray(md["K"], np.float64).reshape(3, 3).T  # stored column-major
    data = {
        "fl_x": float(K[0, 0]),
        "fl_y": float(K[0, 0]),
        "cx": md["w"] / 2.0,
        "cy": md["h"] / 2.0,
        "w": md["w"],
        "h": md["h"],
        "camera_model": "OPENCV",
        "frames": frames,
    }
    _write(output_dir, data)
    return data


def realitycapture_to_transforms(
    csv_path: Path,
    image_sizes: Dict[str, tuple],
    output_dir: Path,
) -> dict:
    """RealityCapture CSV export (name, x, y, alt, heading, pitch, roll, f in
    35mm-equivalent mm, px/py, k1..k4, t1, t2) -> transforms.json
    (`realitycapture_utils.py:29-128`). image_sizes: basename -> (h, w)."""
    rows = list(csv.DictReader(open(csv_path, encoding="utf-8")))
    frames, missing = [], 0
    for row in rows:
        basename = row["#name"].rpartition(".")[0]
        if basename not in image_sizes:
            missing += 1
            continue
        h, w = image_sizes[basename]
        yaw, pitch, roll = -float(row["heading"]), float(row["pitch"]), float(row["roll"])
        sy, cy_ = np.sin(np.deg2rad(yaw)), np.cos(np.deg2rad(yaw))
        sp, cp = np.sin(np.deg2rad(pitch)), np.cos(np.deg2rad(pitch))
        sr, cr = np.sin(np.deg2rad(roll)), np.cos(np.deg2rad(roll))
        rot_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        rot_y = np.array([[cr, 0, sr], [0, 1, 0], [-sr, 0, cr]])
        rot_z = np.array([[cy_, -sy, 0], [sy, cy_, 0], [0, 0, 1]])
        tm = np.eye(4)
        tm[:3, :3] = rot_z @ rot_x @ rot_y
        tm[:3, 3] = [float(row["x"]), float(row["y"]), float(row["alt"])]
        frames.append(
            {
                "h": int(h),
                "w": int(w),
                "file_path": f"./images/{row['#name']}",
                # 35mm-film-equivalent focal length -> pixels
                "fl_x": float(row["f"]) * max(w, h) / 36.0,
                "fl_y": float(row["f"]) * max(w, h) / 36.0,
                "cx": float(row["px"]) / 36.0 + w / 2.0,
                "cy": float(row["py"]) / 36.0 + h / 2.0,
                "k1": float(row.get("k1", 0)),
                "k2": float(row.get("k2", 0)),
                "p1": float(row.get("t1", 0)),
                "p2": float(row.get("t2", 0)),
                "transform_matrix": tm.tolist(),
            }
        )
    data = {"camera_model": "OPENCV", "orientation_override": "none", "frames": frames,
            "missing_images": missing}
    _write(output_dir, data)
    return data


def metashape_to_transforms(xml_path: Path, output_dir: Path) -> dict:
    """Agisoft Metashape camera XML -> transforms.json
    (`metashape_utils.py:35-201`): per-sensor calibration (f, cx/cy offsets
    from center, k1..k3/p1/p2), optional chunk-component transforms, world
    rows permuted (2, 0, 1) with the y/z columns negated."""
    root = ET.parse(xml_path).getroot()
    chunk = root[0]

    def children(tag):
        el = chunk.find(tag)
        return [] if el is None else list(el)

    sensors = {}
    for sensor in children("sensors"):
        calib = sensor.find("calibration")
        res = sensor.find("resolution")
        if calib is None or res is None:
            continue
        w, h = int(res.get("width")), int(res.get("height"))
        def p(name, default=0.0):
            el = calib.find(name)
            return float(el.text) if el is not None and el.text else default
        sensors[sensor.get("id")] = {
            "w": w, "h": h,
            "fl_x": p("f"), "fl_y": p("f"),
            "cx": p("cx") + w / 2.0, "cy": p("cy") + h / 2.0,
            "k1": p("k1"), "k2": p("k2"), "k3": p("k3"),
            "p1": p("p1"), "p2": p("p2"),
        }
    components = {}
    for comp in children("components"):
        tr = comp.find("transform")
        if tr is None:
            continue
        r = tr.find("rotation")
        t = tr.find("translation")
        s = tr.find("scale")
        m = np.eye(4)
        if r is not None:
            m[:3, :3] = np.fromstring(r.text, sep=" ").reshape(3, 3)
        if t is not None:
            m[:3, 3] = np.fromstring(t.text, sep=" ") / (float(s.text) if s is not None else 1.0)
        components[comp.get("id")] = m

    frames, skipped = [], 0
    for camera in children("cameras"):
        sensor = sensors.get(camera.get("sensor_id"))
        tr = camera.find("transform")
        if sensor is None or tr is None or not tr.text:
            skipped += 1
            continue
        m = np.fromstring(tr.text, sep=" ").reshape(4, 4)
        comp = components.get(camera.get("component_id"))
        if comp is not None:
            m = comp @ m
        m = m[[2, 0, 1, 3], :]
        m[:, 1:3] *= -1
        frames.append({"file_path": f"./images/{camera.get('label')}",
                       **sensor, "transform_matrix": m.tolist()})
    data = {"camera_model": "OPENCV", "frames": frames, "skipped_frames": skipped}
    _write(output_dir, data)
    return data


def odm_to_transforms(
    cameras_path: Path,
    shots_path: Path,
    output_dir: Path,
) -> dict:
    """OpenDroneMap cameras.json + shots.geojson -> transforms.json
    (`odm_utils.py:81-190`): normalized focal * max(w, h), principal point
    offset from center, per-shot Rodrigues world->cam inverted to OpenGL c2w."""
    camera = list(json.loads(Path(cameras_path).read_text()).values())[0]
    w, h = int(camera["width"]), int(camera["height"])
    intr = {
        "w": w, "h": h,
        "fl_x": camera.get("focal_x", camera.get("focal")) * max(w, h),
        "fl_y": camera.get("focal_y", camera.get("focal")) * max(w, h),
        "cx": camera.get("c_x", 0.0) + (w - 1) / 2.0,
        "cy": camera.get("c_y", 0.0) + (h - 1) / 2.0,
    }
    for k in ("k1", "k2", "p1", "p2", "k3"):
        if k in camera:
            intr[k] = camera[k]
    proj = camera.get("projection_type", "perspective")
    model = {"brown": "OPENCV", "perspective": "OPENCV", "fisheye": "OPENCV_FISHEYE",
             "fisheye_opencv": "OPENCV_FISHEYE", "spherical": "EQUIRECTANGULAR",
             "equirectangular": "EQUIRECTANGULAR"}[proj]

    frames = []
    shots = json.loads(Path(shots_path).read_text())["features"]
    for shot in shots:
        props = shot["properties"]
        rot = rodrigues_to_matrix(-np.asarray(props["rotation"], np.float64))
        m = np.eye(4)
        m[:3, :3] = rot
        m[:3, 3] = np.asarray(props["translation"], np.float64)
        m[0:3, 1:3] *= -1  # OpenCV -> OpenGL
        frames.append({"file_path": f"./images/{props['filename']}",
                       **intr, "transform_matrix": m.tolist()})
    data = {"camera_model": model, "frames": frames}
    _write(output_dir, data)
    return data
