"""Export point clouds, gaussian splats, camera poses and meshes from a
trained run (torch port of `neurad_tpu/scripts/export.py`; counterpart of
`nerfstudio/scripts/exporter.py`: pointcloud 50-200, gaussian splat PLY
500-608, Poisson 261-380).

    python -m neurad_tpu_torch.scripts.export pointcloud outputs/<run> --device cpu
    python -m neurad_tpu_torch.scripts.export field-mesh outputs/<run> --resolution 128

Runs on a CUDA device unless `--device cpu` is given. Writes `--output`
(default `<run_dir>/export_<mode>.ply`; camera-poses writes the `.json`
beside it) in the JAX script's formats: binary little-endian PLY (vertex
float properties; meshes add `vertex_indices` faces), the camera poses as
transforms-style JSON. The renders and field queries run on the device
(`_chunked_nff`, `query_geometry`: the hash-grid lookup); TSDF fusion, the
Poisson solve and marching tetrahedra are host numpy (`exporter/`).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.exporter.poisson import normals_from_depth, poisson_reconstruct
from neurad_tpu_torch.exporter.tsdf import marching_tetrahedra, tsdf_fuse, write_mesh_ply


def write_ply(path: Path, fields: dict):
    """Minimal binary-little-endian PLY writer (vertex elements only)."""
    names = list(fields)
    n = len(next(iter(fields.values())))
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name in names:
        header.append(f"property float {name}")
    header.append("end_header")
    arr = np.stack([np.asarray(fields[k], dtype="<f4") for k in names], axis=-1)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(arr.tobytes())


def export_pointcloud(pipeline, out_path: Path):
    """Render eval lidar scans and dump predicted points (`exporter.py:50-200`).
    Works for both pipeline families via the shared render_eval_lidar keys."""
    if not hasattr(pipeline, "render_eval_lidar"):
        raise SystemExit(
            "pointcloud export renders eval lidar scans — use a lidar-capable "
            "method (neurad/splatad); for splatfacto use `gaussian-splat`"
        )
    pts, cols = [], []
    for si in pipeline.outputs.eval_lidar_indices:
        out = pipeline.render_eval_lidar(si)
        xyz = np.asarray(out["origins"]) + np.asarray(out["directions"]) * np.asarray(out["depth"])
        keep = out["depth"][:, 0] < 1e3
        pts.append(xyz[keep])
        cols.append(np.repeat(out["intensity"][keep], 3, axis=-1))
    pts = np.concatenate(pts) if pts else np.zeros((0, 3))
    cols = np.concatenate(cols) if cols else np.zeros((0, 3))
    write_ply(out_path, {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                         "red": cols[:, 0], "green": cols[:, 1], "blue": cols[:, 2]})
    return len(pts)


def export_gaussian_splat(model, out_path: Path):
    """Dump the model's gaussians as a 3DGS-convention PLY
    (`exporter.py:500-608`). Handles both parameter schemas: SplatAD
    ('features') and splatfacto ('sh_dc'/'sh_rest')."""
    p = {name: value.detach().cpu().numpy() for name, value in model.named_parameters()}
    means = p["means"]
    scales = p["scales"]
    quats = p["quats"]
    op = p["opacities"]
    if "features" in p:
        feats = p["features"]
    else:
        feats = np.concatenate([p["sh_dc"], p["sh_rest"]], axis=-1)
    fields = {
        "x": means[:, 0], "y": means[:, 1], "z": means[:, 2],
        "scale_0": scales[:, 0], "scale_1": scales[:, 1], "scale_2": scales[:, 2],
        "rot_0": quats[:, 0], "rot_1": quats[:, 1], "rot_2": quats[:, 2], "rot_3": quats[:, 3],
        "opacity": op,
    }
    for i in range(min(feats.shape[1], 16)):
        fields[f"f_dc_{i}" if i < 3 else f"f_rest_{i-3}"] = feats[:, i]
    write_ply(out_path, fields)
    return means.shape[0]


def _eval_depth(pipeline, ci):
    """An eval camera's depth render on the feature-field chunks -> (bundle,
    depth [H', W'] numpy, (H', W'))."""
    bundle, _, (hs, ws) = pipeline.datamanager.eval_camera_bundle(ci)
    nff = pipeline._chunked_nff(bundle, all_camera=True)
    return bundle, nff["depth"].cpu().numpy().reshape(hs, ws), (hs, ws)


def export_tsdf_mesh(pipeline, out_path: Path, resolution: int = 128):
    """Render eval-camera depths, TSDF-fuse, marching-tetrahedra mesh
    (`exporter.py` tsdf path)."""
    depths, Ks, c2ws = [], [], []
    cams = pipeline.outputs.cameras
    for ci in pipeline.outputs.eval_camera_indices:
        _, depth, _ = _eval_depth(pipeline, ci)
        depths.append(depth)
        up = pipeline.config.datamanager.rgb_upsample_factor
        Ks.append(
            np.array(
                [
                    [float(cams.fx[ci, 0]) / up, 0, float(cams.cx[ci, 0]) / up],
                    [0, float(cams.fy[ci, 0]) / up, float(cams.cy[ci, 0]) / up],
                    [0, 0, 1],
                ]
            )
        )
        c2ws.append(cams.camera_to_worlds[ci].cpu().numpy())
    aabb = pipeline.outputs.scene_box.aabb.cpu().numpy()
    tsdf, weights = tsdf_fuse(depths, Ks, c2ws, aabb, resolution=resolution)
    verts, faces = marching_tetrahedra(tsdf, aabb, mask=weights > 0)
    write_mesh_ply(out_path, verts, faces)
    return len(verts), len(faces)


def export_poisson_mesh(pipeline, out_path: Path, resolution: int = 192, num_points: int = 500_000):
    """Depth-render eval cameras -> oriented point cloud -> Poisson surface
    reconstruction -> mesh (`exporter.py:261-380` ExportPoissonMesh; open3d's
    screened Poisson replaced by the FFT indicator solve in
    `exporter/poisson.py`)."""
    pts, nrms = [], []
    for ci in pipeline.outputs.eval_camera_indices:
        bundle, depth, (hs, ws) = _eval_depth(pipeline, ci)
        depth = depth.reshape(hs, ws, 1)
        origins = bundle.origins.cpu().numpy().reshape(hs, ws, 3)
        dirs = bundle.directions.cpu().numpy().reshape(hs, ws, 3)
        positions = origins + dirs * depth
        normals, valid = normals_from_depth(positions, cam_center=origins[0, 0])
        keep = valid & (depth[..., 0] < 1e3)
        pts.append(positions[keep])
        nrms.append(normals[keep])
    pts = np.concatenate(pts) if pts else np.zeros((0, 3))
    nrms = np.concatenate(nrms) if nrms else np.zeros((0, 3))
    if len(pts) > num_points:
        sel = np.random.default_rng(0).choice(len(pts), num_points, replace=False)
        pts, nrms = pts[sel], nrms[sel]
    chi, iso, aabb = poisson_reconstruct(pts, nrms, resolution=resolution)
    verts, faces = marching_tetrahedra(-chi, aabb, iso=-iso)
    write_mesh_ply(out_path, verts, faces)
    return len(verts), len(faces)


@torch.no_grad()
def field_volume(pipeline, resolution: int, time: float = 0.0, chunk: int = 131072) -> np.ndarray:
    """The model's geometry (`query_geometry`: SDF or density) on the r^3 grid
    spanning the scene box -> [r, r, r]. Queried `chunk` points at a time on
    the model's device, the last chunk padded with zeros to full size."""
    aabb = pipeline.outputs.scene_box.aabb.cpu().numpy()
    r = resolution
    grid = np.stack(
        np.meshgrid(*[np.linspace(aabb[0, i], aabb[1, i], r) for i in range(3)], indexing="ij"),
        axis=-1,
    ).reshape(-1, 3).astype(np.float32)
    vals = []
    pad = (-len(grid)) % chunk
    gpad = np.concatenate([grid, np.zeros((pad, 3), np.float32)]) if pad else grid
    for i in range(0, len(gpad), chunk):
        pts = torch.from_numpy(gpad[i:i + chunk]).to(pipeline.device)
        vals.append(pipeline.model.query_geometry(pts, time).float().cpu().numpy())
    return np.concatenate(vals)[: len(grid)].reshape(r, r, r)


def export_field_mesh(pipeline, out_path: Path, resolution: int = 256, time: float = 0.0, chunk: int = 131072):
    """Direct field iso-surface: evaluate the model's SDF (or density) on a
    dense grid and mesh the zero/threshold level set with marching tetrahedra.

    Counterpart of the reference's marching-cubes export
    (`exporter.py` ExportMarchingCubesMesh + `exporter/marching_cubes.py`
    multi-res evaluation); iso-extraction is marching tetrahedra (no 256-case
    tables; same surface family). Grid evaluation is chunked so any resolution
    fits device memory.
    """
    aabb = pipeline.outputs.scene_box.aabb.cpu().numpy()
    vol = field_volume(pipeline, resolution, time=time, chunk=chunk)
    use_sdf = getattr(pipeline.model, "use_sdf", True)
    iso = 0.0 if use_sdf else float(np.quantile(vol, 0.98))
    # marching_tetrahedra treats vals < iso as inside; SDF is negative inside,
    # density is LARGE inside -> negate for the density path
    verts, faces = marching_tetrahedra(vol if use_sdf else -vol, aabb, iso=iso if use_sdf else -iso)
    write_mesh_ply(out_path, verts, faces)
    return len(verts), len(faces)


def camera_poses(pipeline) -> dict:
    """The cameras as transforms-style JSON (`exporter.py` ExportCameraPoses)."""
    cams = pipeline.outputs.cameras
    eval_set = set(pipeline.outputs.eval_camera_indices)
    frames = []
    for i in range(cams.camera_to_worlds.shape[0]):
        value = lambda field: field[i].reshape(-1)[0].item()
        frames.append({
            "camera_to_world": cams.camera_to_worlds[i].cpu().numpy().tolist(),
            "fx": float(value(cams.fx)),
            "fy": float(value(cams.fy)),
            "cx": float(value(cams.cx)),
            "cy": float(value(cams.cy)),
            "w": int(value(cams.width)),
            "h": int(value(cams.height)),
            "time": float(value(cams.times)) if cams.times is not None else None,
            "split": "eval" if i in eval_set else "train",
        })
    return {"frames": frames}


def entrypoint(argv=None):
    parser = argparse.ArgumentParser(description="Export from a trained neurad_tpu_torch run")
    parser.add_argument(
        "mode",
        choices=["pointcloud", "gaussian-splat", "camera-poses", "tsdf-mesh", "field-mesh", "poisson"],
    )
    parser.add_argument("run_dir")
    parser.add_argument("--output", default=None)
    parser.add_argument("--resolution", type=int, default=128)
    parser.add_argument("--time", type=float, default=0.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from neurad_tpu_torch.scripts.train import load_run

    pipeline, _ = load_run(args.run_dir, device=device)
    out = Path(args.output or (Path(args.run_dir) / f"export_{args.mode}.ply"))

    if args.mode == "pointcloud":
        n = export_pointcloud(pipeline, out)
        print(f"[export] wrote {n} points to {out}")
    elif args.mode == "tsdf-mesh":
        nv, nf = export_tsdf_mesh(pipeline, out, resolution=args.resolution)
        print(f"[export] wrote mesh with {nv} verts / {nf} faces to {out}")
    elif args.mode == "field-mesh":
        nv, nf = export_field_mesh(pipeline, out, resolution=args.resolution, time=args.time)
        print(f"[export] wrote field mesh with {nv} verts / {nf} faces to {out}")
    elif args.mode == "poisson":
        nv, nf = export_poisson_mesh(pipeline, out, resolution=args.resolution)
        print(f"[export] wrote poisson mesh with {nv} verts / {nf} faces to {out}")
    elif args.mode == "gaussian-splat":
        n = export_gaussian_splat(pipeline.model, out)
        print(f"[export] wrote {n} gaussians to {out}")
    else:  # camera-poses (transforms.json-style, `exporter.py` ExportCameraPoses)
        data = camera_poses(pipeline)
        out = out.with_suffix(".json")
        out.write_text(json.dumps(data, indent=1))
        print(f"[export] wrote {len(data['frames'])} camera poses to {out}")
    return out


if __name__ == "__main__":
    entrypoint()
