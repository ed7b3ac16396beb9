"""Render eval sensors, camera paths and actor edits of a trained run (torch
port of `neurad_tpu/scripts/render.py`; counterpart of
`nerfstudio/scripts/render.py`: dataset rendering 415-861, AD actor-edit
extras 729-791, lidar point-cloud outputs 1190+).

    python -m neurad_tpu_torch.scripts.render outputs/<run> --device cpu
    python -m neurad_tpu_torch.scripts.render outputs/<run> --lidar --lidar-bev --interpolate 5
    python -m neurad_tpu_torch.scripts.render outputs/<run> --camera-path path.json --actor-shift 1,0,0

Runs on a CUDA device unless `--device cpu` is given. Writes into
`--output-dir` (default `<run_dir>/renders`): `camera_<i>.png` and
`camera_<i>_gt.png` per camera of the `--cameras` split, `campath_<k>.png`
per pose of a nerfstudio camera-path JSON, `path_<k>.png` per pose of the
interpolated path, `lidar_<i>.npz` and `lidar_<i>_{pred,gt}_bev.png` per eval
scan. PNGs go through `data/png.py`, encoded in a pool of threads while the
device renders the next frame (a 1080p frame's encode takes tens of its
renders). A frame is quantised to uint8 before it queues, and at most twice
as many frames as there are threads wait, so the host holds a bounded number
of frames however many the run renders; the script returns when every file
is written.

The pipeline owns its parameters (the JAX script passes a TrainState): actor
edits change the model's `actor_positions` / `actor_rotations_6d` and the
actors' `present` mask in place. A camera-path pose is rendered at the first
eval camera's intrinsics, and that camera's pose is put back after the
render (the JAX script leaves the last path pose in it, so its
`camera_<i>.png` of that camera shows that pose). `--shift` moves each
rendered camera as the JAX script does and leaves it moved, so an
`--interpolate` path runs between the shifted cameras. A nerfacto run raises
NotImplementedError at its first render, as the port's renders do.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.cameras.camera_utils import get_interpolated_poses
from neurad_tpu_torch.data.png import quantise, write_png


def _save_image(path: Path, img: np.ndarray, write=None):
    """Quantise the float image `img` and hand it to `write(path, image)`
    (default: `write_png` here)."""
    (write or write_png)(path, quantise(img))


@contextlib.contextmanager
def _cameras(pipeline, cameras):
    """Render with `cameras` in place of the parsed ones, then put them back
    (the datamanager holds the same outputs object)."""
    saved = pipeline.outputs.cameras
    pipeline.outputs.cameras = cameras
    try:
        yield
    finally:
        pipeline.outputs.cameras = saved


@torch.no_grad()
def modify_actors(pipeline, shift=None, removal_time=None, stop_time=None, indices=None) -> None:
    """Actor trajectory edits for renders (`render.py:729-747` modify_actors):
    shift positions, remove actors after a time, or freeze them at a time.
    The model's trajectory parameters and the actors' presence mask change in
    place (the edits are the JAX script's numpy operations)."""
    actors = getattr(pipeline.model, "actors", None)
    if actors is None:
        raise SystemExit("actor edits need a dynamic-actor model (neurad/splatad), not splatfacto")
    ad = actors.data
    if ad.n_actors == 0:
        return
    idx = np.asarray(indices if indices is not None else np.arange(ad.n_actors), dtype=np.int64)

    pos = actors.actor_positions.detach().cpu().numpy().copy()
    rot = actors.actor_rotations_6d.detach().cpu().numpy().copy()
    if shift is not None:
        pos[:, idx, :] += np.asarray(shift, dtype=np.float32)
    if stop_time is not None:
        ts = np.asarray(ad.unique_timestamps)
        si = int(np.searchsorted(ts, stop_time))
        si = min(si, pos.shape[0] - 1)
        pos[si:, idx] = pos[si, idx][None]
        rot[si:, idx] = rot[si, idx][None]
    actors.actor_positions.copy_(torch.from_numpy(pos))
    actors.actor_rotations_6d.copy_(torch.from_numpy(rot))

    if removal_time is not None:
        present = np.asarray(ad.present).copy()
        mask = np.asarray(ad.unique_timestamps) > removal_time
        present[np.ix_(mask, idx)] = False
        actors.present.copy_(torch.from_numpy(present))
        actors.data = dataclasses.replace(ad, present=present)
        if hasattr(pipeline.model, "actor_data"):
            pipeline.model.actor_data = actors.data


def load_camera_path(path):
    """Minimal nerfstudio camera-path JSON reader (`render.py:73-170`): returns
    (list of 3x4 c2w, fov_deg or None, times or None)."""
    data = json.loads(Path(path).read_text())
    poses, times = [], []
    for frame in data.get("camera_path", []):
        c2w = np.asarray(frame["camera_to_world"], dtype=np.float32).reshape(4, 4)[:3]
        poses.append(c2w)
        if "render_time" in frame:
            times.append(float(frame["render_time"]))
    fov_deg = float(data.get("fov", 0)) or None
    return poses, fov_deg, (times if times else None)


def render_pose(pipeline, pose_c2w, base_cam_idx, time=None) -> np.ndarray:
    """Render an arbitrary pose using base_cam_idx's intrinsics (and, with
    `time`, at that time)."""
    cams = pipeline.outputs.cameras
    c2w = cams.camera_to_worlds.clone()
    c2w[base_cam_idx] = torch.as_tensor(np.asarray(pose_c2w, dtype=np.float32), dtype=c2w.dtype, device=c2w.device)
    patched = dataclasses.replace(cams, camera_to_worlds=c2w)
    if time is not None and cams.times is not None:
        t = cams.times.clone()
        t[base_cam_idx] = time
        patched = dataclasses.replace(patched, times=t)
    with _cameras(pipeline, patched):
        pred, _ = pipeline.render_eval_camera(base_cam_idx)
    return pred


def save_lidar_bev(path, pts, intensity=None, extent=60.0, px=800):
    """Top-down (BEV) lidar point-cloud plot (`render.py:1190+` point-cloud
    outputs): numpy rasterization, no plotting deps needed on the hot path."""
    img = np.zeros((px, px, 3), dtype=np.float32)
    x, y = pts[:, 0], pts[:, 1]
    keep = (np.abs(x) < extent) & (np.abs(y) < extent)
    xi = ((x[keep] + extent) / (2 * extent) * (px - 1)).astype(int)
    yi = ((extent - y[keep]) / (2 * extent) * (px - 1)).astype(int)
    v = intensity[keep] if intensity is not None else np.ones(keep.sum())
    v = np.clip(v, 0.05, 1.0)
    img[yi, xi, 1] = np.maximum(img[yi, xi, 1], v)  # green channel = intensity
    img[yi, xi, 0] = 0.3 * img[yi, xi, 1]
    _save_image(Path(path), img)


def entrypoint(argv=None):
    parser = argparse.ArgumentParser(description="Render a trained neurad_tpu_torch run")
    parser.add_argument("run_dir")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--cameras", default="eval", choices=["eval", "train", "all"])
    parser.add_argument("--lidar", action="store_true", help="also render lidar point clouds (.npz)")
    parser.add_argument("--shift", type=float, default=0.0, help="lateral ray-origin shift in meters (FID-style lane shift)")
    parser.add_argument("--interpolate", type=int, default=0,
                        help="render an interpolated path with N steps between consecutive train cameras")
    parser.add_argument("--camera-path", default=None, help="nerfstudio camera-path JSON to render")
    parser.add_argument("--actor-shift", default=None, help="dx,dy,dz actor position shift in meters")
    parser.add_argument("--actor-removal-time", type=float, default=None, help="remove actors after this time (s)")
    parser.add_argument("--actor-stop-time", type=float, default=None, help="freeze actors at this time (s)")
    parser.add_argument("--actor-indices", default=None, help="comma-separated actor indices for edits (default all)")
    parser.add_argument("--shift-time", type=float, default=None,
                        help="with --shift: apply the lateral shift only after this time (smooth ramp)")
    parser.add_argument("--lidar-bev", action="store_true", help="also write top-down lidar plots (.png)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from neurad_tpu_torch.scripts.train import load_run

    pipeline, _ = load_run(args.run_dir, device=device)
    step = int(pipeline.latest_checkpoint(Path(args.run_dir) / "checkpoints").stem.split("-")[1])
    out_dir = Path(args.output_dir or (Path(args.run_dir) / "renders"))
    out_dir.mkdir(parents=True, exist_ok=True)
    workers = min(8, os.cpu_count() or 1)
    slots = threading.BoundedSemaphore(2 * workers)  # frames queued or encoding
    with ThreadPoolExecutor(max_workers=workers) as pool:
        writes = []

        def write(path, image):
            slots.acquire()  # waits while 2 x workers frames are not yet written
            writes.append(pool.submit(write_png, path, image))
            writes[-1].add_done_callback(lambda _: slots.release())

        cam_indices = _render(args, pipeline, out_dir, lambda path, img: _save_image(path, img, write))
        for w in writes:
            w.result()  # a failed write raises here
    print(f"[render] wrote {len(cam_indices)} camera renders to {out_dir} (ckpt step {step})")


def _render(args, pipeline, out_dir: Path, save):
    """The entry point's renders, each image handed to `save(path, rgb)`;
    -> the rendered camera indices."""
    if args.actor_shift or args.actor_removal_time is not None or args.actor_stop_time is not None:
        shift = [float(v) for v in args.actor_shift.split(",")] if args.actor_shift else None
        indices = [int(v) for v in args.actor_indices.split(",")] if args.actor_indices else None
        modify_actors(pipeline, shift=shift, removal_time=args.actor_removal_time, stop_time=args.actor_stop_time,
                      indices=indices)

    if args.camera_path:
        poses, _fov, times = load_camera_path(args.camera_path)
        base = (list(pipeline.outputs.eval_camera_indices) or [0])[0]
        for i, pose in enumerate(poses):
            t = times[i] if times else None
            img = render_pose(pipeline, pose, base, time=t)
            save(out_dir / f"campath_{i:05d}.png", img)
        print(f"[render] wrote {len(poses)} camera-path frames")

    outputs = pipeline.outputs
    if args.cameras == "eval":
        cam_indices = list(outputs.eval_camera_indices)
    elif args.cameras == "train":
        ev = set(outputs.eval_camera_indices)
        cam_indices = [i for i in range(len(outputs.images)) if i not in ev]
    else:
        cam_indices = list(range(len(outputs.images)))

    for ci in cam_indices:
        skip_shift = False
        if args.shift_time is not None and outputs.cameras.times is not None:
            # shifted-path mode (`render.py:749-791`): shift only after shift_time
            skip_shift = float(outputs.cameras.times[ci].reshape(-1)[0]) <= args.shift_time
        if args.shift != 0.0 and not skip_shift:
            # shift the camera origin laterally (lane-shift render, `render.py:749-791`)
            cams = outputs.cameras
            c2w = cams.camera_to_worlds.clone()
            c2w[ci, :3, 3] += c2w[ci, :3, 0] * args.shift
            outputs.cameras = dataclasses.replace(cams, camera_to_worlds=c2w)
        pred, gt = pipeline.render_eval_camera(ci)
        save(out_dir / f"camera_{ci:04d}.png", pred)
        save(out_dir / f"camera_{ci:04d}_gt.png", gt)

    if args.interpolate > 0:
        # smooth interpolated camera path (`render.py:415-550` interpolated mode)
        cams = outputs.cameras
        c2w = cams.camera_to_worlds
        frame = 0
        for a, b in zip(cam_indices[:-1], cam_indices[1:]):
            path = get_interpolated_poses(c2w[a].cpu().numpy(), c2w[b].cpu().numpy(), steps=args.interpolate)
            for pose in path:
                patched = c2w.clone()
                patched[a] = torch.as_tensor(pose, dtype=c2w.dtype, device=c2w.device)
                with _cameras(pipeline, dataclasses.replace(cams, camera_to_worlds=patched)):
                    pred, _ = pipeline.render_eval_camera(a)
                save(out_dir / f"path_{frame:05d}.png", pred)
                frame += 1
        print(f"[render] wrote {frame} path frames")

    if args.lidar or args.lidar_bev:
        for si in outputs.eval_lidar_indices:
            out = pipeline.render_eval_lidar(si)
            if args.lidar:
                np.savez(out_dir / f"lidar_{si:04d}.npz", **out)
            if args.lidar_bev:
                # predicted point cloud (model returns) and GT, top-down
                ret = out["did_return"][:, 0]
                drop = 1.0 / (1.0 + np.exp(-out["ray_drop_logits"][:, 0])) > 0.5
                pred_pts = out["origins"] + out["directions"] * out["depth"]
                gt_pts = out["origins"] + out["directions"] * out["gt_distance"]
                org = out["origins"][0]
                save_lidar_bev(out_dir / f"lidar_{si:04d}_pred_bev.png", (pred_pts - org)[~drop],
                               out["intensity"][~drop, 0])
                save_lidar_bev(out_dir / f"lidar_{si:04d}_gt_bev.png", (gt_pts - org)[ret],
                               out["gt_intensity"][ret, 0])
    return cam_indices


if __name__ == "__main__":
    entrypoint()
