"""Data ingestion: images/video -> trainable dataset (torch port of
`neurad_tpu/process_data.py`; counterpart of `nerfstudio/process_data/` (COLMAP/video/polycam
ingestion, 3312 LoC — "mostly irrelevant for AD" per SURVEY.md §1). Like the
reference, SfM shells out to the `colmap` binary and frame extraction to
`ffmpeg` (gated: helpful errors when absent). A pure-python path ingests the
nerfstudio `transforms.json` convention directly, and the capture-app
converters (`process_data_converters.py`) write one.

    python -m neurad_tpu_torch.process_data transforms data/scene/transforms.json --device cpu
    python -m neurad_tpu_torch.process_data polycam data/polycam_export --output-dir data/processed

Runs on a CUDA device unless `--device cpu` is given: the transforms mode
loads the cameras there. Images are read through `data/png.read_png` (PNG
only: the card's machine has no image library).
"""

from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path
import numpy as np

from neurad_tpu_torch import resolve_device


def require_tool(name: str) -> str:
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(
            f"`{name}` is required for this ingestion path but is not installed. "
            f"Install it or provide a pre-computed transforms.json."
        )
    return path


def extract_frames(video: str, out_dir: str, fps: float = 2.0) -> int:
    """Video -> frames via ffmpeg (`process_data/process_data_utils.py`)."""
    ffmpeg = require_tool("ffmpeg")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [ffmpeg, "-i", video, "-vf", f"fps={fps}", str(out / "frame_%05d.png")], check=True
    )
    return len(list(out.glob("frame_*.png")))


def run_colmap(image_dir: str, workspace: str) -> None:
    """SfM via the colmap CLI (`process_data/colmap_utils.py`)."""
    colmap = require_tool("colmap")
    ws = Path(workspace)
    ws.mkdir(parents=True, exist_ok=True)
    db = ws / "database.db"
    subprocess.run([colmap, "feature_extractor", "--database_path", db, "--image_path", image_dir], check=True)
    subprocess.run([colmap, "exhaustive_matcher", "--database_path", db], check=True)
    sparse = ws / "sparse"
    sparse.mkdir(exist_ok=True)
    subprocess.run(
        [colmap, "mapper", "--database_path", db, "--image_path", image_dir, "--output_path", sparse],
        check=True,
    )


def load_transforms_json(path: str, device="cuda"):
    """nerfstudio-convention transforms.json -> (Cameras on `device`, images list).

    The pure-python ingestion path: frames with `transform_matrix` (OpenGL c2w)
    and shared or per-frame intrinsics.
    """
    import torch

    from neurad_tpu_torch.cameras.cameras import CameraType, Cameras
    from neurad_tpu_torch.data.png import read_png

    dev = resolve_device(device)
    meta = json.loads(Path(path).read_text())
    root = Path(path).parent
    frames = meta["frames"]
    poses, fx, fy, cx, cy, w, h, images = [], [], [], [], [], [], [], []
    for f in frames:
        m = np.asarray(f["transform_matrix"], dtype=np.float32)
        poses.append(m[:3, :4])
        fx.append(f.get("fl_x", meta.get("fl_x")))
        fy.append(f.get("fl_y", meta.get("fl_y")))
        cx.append(f.get("cx", meta.get("cx")))
        cy.append(f.get("cy", meta.get("cy")))
        w.append(int(f.get("w", meta.get("w"))))
        h.append(int(f.get("h", meta.get("h"))))
        images.append(read_png(root / f["file_path"]))
    n = len(frames)
    column = lambda v, dtype: torch.as_tensor(np.asarray(v, dtype)[:, None], device=dev)
    cameras = Cameras(
        camera_to_worlds=torch.as_tensor(np.stack(poses), device=dev),
        fx=column(fx, np.float32),
        fy=column(fy, np.float32),
        cx=column(cx, np.float32),
        cy=column(cy, np.float32),
        width=column(w, np.int32),
        height=column(h, np.int32),
        camera_type=torch.full((n, 1), int(CameraType.PERSPECTIVE), dtype=torch.int32, device=dev),
        times=column(np.linspace(0.0, 1.0, n), np.float32),
        metadata={"sensor_idxs": torch.zeros((n, 1), dtype=torch.int32, device=dev)},
    )
    return cameras, images


def equirect_to_perspective(
    img, fov_deg: float, theta_deg: float, phi_deg: float, out_h: int, out_w: int
):
    """Extract a pinhole view from an equirectangular panorama.

    Counterpart of `process_data/equirect_utils.py:86-160` (equirect2persp):
    pinhole rays rotated by yaw theta / pitch phi, mapped to (lon, lat), the
    panorama sampled bilinearly with horizontal wrap. img [H, W, C] float/uint8.
    """

    img = np.asarray(img)
    h, w = img.shape[:2]
    f = 0.5 * out_w / np.tan(np.deg2rad(fov_deg) / 2.0)
    ys, xs = np.meshgrid(np.arange(out_h) + 0.5, np.arange(out_w) + 0.5, indexing="ij")
    # camera rays: +x forward, +y right, +z up
    d = np.stack(
        [np.full_like(xs, f), xs - out_w / 2.0, -(ys - out_h / 2.0)], axis=-1
    )
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    th, ph = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    rot_yaw = np.array([
        [np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]
    ])
    rot_pitch = np.array([
        [np.cos(ph), 0.0, -np.sin(ph)], [0.0, 1.0, 0.0], [np.sin(ph), 0.0, np.cos(ph)]
    ])
    d = d @ (rot_yaw @ rot_pitch).T
    lon = np.arctan2(d[..., 1], d[..., 0])  # [-pi, pi]
    lat = np.arcsin(np.clip(d[..., 2], -1.0, 1.0))  # [-pi/2, pi/2]
    # equirect pixel coords (lon wraps, lat clamps)
    u = (lon / (2 * np.pi) + 0.5) * w - 0.5
    v = (0.5 - lat / np.pi) * h - 0.5
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu, fv = u - u0, v - v0
    u0m, u1m = u0 % w, (u0 + 1) % w
    v0c, v1c = np.clip(v0, 0, h - 1), np.clip(v0 + 1, 0, h - 1)
    imgf = img.astype(np.float32)
    out = (
        imgf[v0c, u0m] * ((1 - fu) * (1 - fv))[..., None]
        + imgf[v0c, u1m] * (fu * (1 - fv))[..., None]
        + imgf[v1c, u0m] * ((1 - fu) * fv)[..., None]
        + imgf[v1c, u1m] * (fu * fv)[..., None]
    )
    return out.astype(img.dtype) if img.dtype == np.uint8 else out


def generate_planar_projections(
    img, fov_deg: float = 90.0, yaw_steps: int = 4, pitches=(0.0,), out_size=(480, 640)
):
    """Equirectangular panorama -> list of (crop, c2w [3,4]) pinhole views
    (`equirect_utils.py:233-320` generate_planar_projections_from_equirectangular,
    minus the disk walking). The c2w uses the same +x-forward camera frame as
    `equirect_to_perspective`."""

    out_h, out_w = out_size
    views = []
    for phi in pitches:
        for i in range(yaw_steps):
            theta = 360.0 * i / yaw_steps
            crop = equirect_to_perspective(img, fov_deg, theta, phi, out_h, out_w)
            th, ph = np.deg2rad(theta), np.deg2rad(phi)
            rot_yaw = np.array([
                [np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]
            ])
            rot_pitch = np.array([
                [np.cos(ph), 0.0, -np.sin(ph)], [0.0, 1.0, 0.0], [np.sin(ph), 0.0, np.cos(ph)]
            ])
            c2w = np.zeros((3, 4), np.float32)
            c2w[:3, :3] = rot_yaw @ rot_pitch
            views.append((crop, c2w))
    return views


def entrypoint(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Ingest captures into a dataset")
    parser.add_argument(
        "mode",
        choices=["video", "images", "transforms", "colmap", "polycam", "record3d", "metashape", "odm"],
    )
    parser.add_argument("source")
    parser.add_argument("--output-dir", default="data/processed")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.mode == "video":
        n = extract_frames(args.source, args.output_dir + "/images")
        print(f"extracted {n} frames; run colmap via mode=images next")
    elif args.mode == "images":
        run_colmap(args.source, args.output_dir + "/colmap")
        print("colmap sparse reconstruction complete")
    elif args.mode == "transforms":
        cams, imgs = load_transforms_json(args.source, device=device)
        print(f"loaded {len(imgs)} frames from {args.source}")
    else:
        # capture-app converters (`nerfstudio/process_data/*_utils.py`)
        import os

        from neurad_tpu_torch import process_data_converters as C

        src = args.source
        if args.mode == "colmap":
            data = C.colmap_to_transforms(src, args.output_dir)
        elif args.mode == "polycam":
            imgs = sorted(os.listdir(os.path.join(src, "keyframes", "images")))
            data = C.polycam_to_transforms(
                os.path.join(src, "keyframes", "cameras"), imgs, args.output_dir
            )
        elif args.mode == "record3d":
            imgs = sorted(os.listdir(os.path.join(src, "rgb")))
            data = C.record3d_to_transforms(
                os.path.join(src, "metadata.json"), imgs, args.output_dir
            )
        elif args.mode == "metashape":
            data = C.metashape_to_transforms(src, args.output_dir)
        else:  # odm
            data = C.odm_to_transforms(
                os.path.join(src, "cameras.json"),
                os.path.join(src, "odm_report", "shots.geojson"),
                args.output_dir,
            )
        print(f"[nt-process-data] wrote {len(data['frames'])} frames to {args.output_dir}/transforms.json")


if __name__ == "__main__":
    entrypoint()
