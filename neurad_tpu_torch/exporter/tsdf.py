"""TSDF fusion + marching-tetrahedra mesh extraction: the port's copy of
`neurad_tpu/exporter/tsdf.py` (host numpy; the same outputs bit for bit).

Counterpart of `nerfstudio/exporter/tsdf_utils.py` (TSDF fusion from
rendered depths) + the mesh path of `scripts/exporter.py`. No skimage/open3d in
this image, so iso-surface extraction uses marching TETRAHEDRA (each voxel cube
split into 6 tets; per-tet surface cases are derivable from first principles,
unlike marching cubes' 256-case tables).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# cube corners (unit offsets) and the standard 6-tetrahedra decomposition
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]]
)
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])


def tsdf_fuse(
    depths: List[np.ndarray],
    intrinsics: List[np.ndarray],
    c2ws: List[np.ndarray],
    aabb: np.ndarray,
    resolution: int = 128,
    trunc: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse depth maps into a truncated signed distance volume.

    depths: [H, W] metric depth per view; intrinsics: [3,3]; c2ws: [3,4] OpenGL.
    Returns (tsdf [R,R,R], voxel world coords origin/scale as aabb copy).
    """
    r = resolution
    grid = np.stack(
        np.meshgrid(*[np.linspace(aabb[0, i], aabb[1, i], r) for i in range(3)], indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    tsdf = np.ones(grid.shape[0], dtype=np.float32)
    weights = np.zeros(grid.shape[0], dtype=np.float32)
    trunc_world = trunc * float(np.max(aabb[1] - aabb[0]))

    for depth, K, c2w in zip(depths, intrinsics, c2ws):
        h, w = depth.shape[:2]
        # world -> camera (OpenGL): x right, y up, -z forward
        r_wc = c2w[:3, :3].T
        t_wc = -r_wc @ c2w[:3, 3]
        cam = grid @ r_wc.T + t_wc
        z = -cam[:, 2]  # positive depth along view
        valid = z > 1e-3
        u = K[0, 0] * (cam[:, 0] / np.where(valid, z, 1.0)) + K[0, 2]
        v = -K[1, 1] * (cam[:, 1] / np.where(valid, z, 1.0)) + K[1, 2]
        ui = np.round(u).astype(np.int64)
        vi = np.round(v).astype(np.int64)
        inside = valid & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        d_obs = np.where(inside, depth[np.clip(vi, 0, h - 1), np.clip(ui, 0, w - 1)].reshape(-1), 0.0)
        sdf = d_obs - z
        update = inside & (d_obs > 0) & (sdf > -trunc_world)
        sdf_t = np.clip(sdf / trunc_world, -1.0, 1.0)
        w_new = weights + update
        tsdf = np.where(update, (tsdf * weights + sdf_t) / np.clip(w_new, 1, None), tsdf)
        weights = w_new

    return tsdf.reshape(r, r, r), weights.reshape(r, r, r)


def marching_tetrahedra(volume: np.ndarray, aabb: np.ndarray, iso: float = 0.0, mask: np.ndarray = None):
    """Extract the iso-surface as (vertices [V,3], faces [F,3]).

    mask (e.g. TSDF weights > 0) excludes cells touching unobserved voxels —
    otherwise the truncation boundary of unobserved space produces phantom
    back-surfaces.

    Host memory: the (r-1)^3 x 8 x 3 int64 corner indices of every cell are
    built at once, about 0.4 GB at r = 128 and 3.2 GB at r = 256 (the JAX
    package's algorithm, kept so the mesh is the same).
    """
    r = volume.shape[0]
    scale = (aabb[1] - aabb[0]) / (r - 1)

    cells = np.stack(np.meshgrid(*[np.arange(r - 1)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)
    corner_idx = cells[:, None, :] + _CORNERS[None, :, :]  # [C, 8, 3]
    vals = volume[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]  # [C, 8]
    # skip cells with no sign change
    has_surface = (vals.min(1) < iso) & (vals.max(1) > iso)
    if mask is not None:
        observed = mask[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]].all(1)
        has_surface = has_surface & observed
    cells, corner_idx, vals = cells[has_surface], corner_idx[has_surface], vals[has_surface]

    verts_list, faces_list = [], []
    n_verts = 0
    for tet in _TETS:
        tv = vals[:, tet]  # [C, 4]
        tp = corner_idx[:, tet].astype(np.float64) * scale + aabb[0]  # [C, 4, 3]
        inside = tv < iso  # [C, 4]
        count = inside.sum(1)

        def edge_point(pa, pb, va, vb):
            t = (iso - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
            return pa + t[:, None] * (pb - pa)

        for case_count, flip in ((1, False), (3, True)):
            sel = count == case_count
            if not sel.any():
                continue
            ins = inside[sel] if not flip else ~inside[sel]
            one = np.argmax(ins, axis=1)
            # the three vertices not selected
            all_idx = np.tile(np.arange(4), (ins.shape[0], 1))
            rest = all_idx[all_idx != one[:, None]].reshape(-1, 3)
            p_one = tp[sel][np.arange(sel.sum()), one]
            v_one = tv[sel][np.arange(sel.sum()), one]
            tri = []
            for k in range(3):
                p_k = tp[sel][np.arange(sel.sum()), rest[:, k]]
                v_k = tv[sel][np.arange(sel.sum()), rest[:, k]]
                tri.append(edge_point(p_one, p_k, v_one, v_k))
            tri = np.stack(tri, axis=1)  # [n, 3, 3]
            verts_list.append(tri.reshape(-1, 3))
            faces_list.append(np.arange(tri.shape[0] * 3).reshape(-1, 3) + n_verts)
            n_verts += tri.shape[0] * 3

        # two-inside case: quad -> two triangles
        sel = count == 2
        if sel.any():
            ins = inside[sel]
            n = sel.sum()
            order = np.argsort(~ins, axis=1)
            a, b = order[:, 0], order[:, 1]  # inside
            c, d = order[:, 2], order[:, 3]  # outside
            gi = np.arange(n)
            pa, pb, pc, pd = (tp[sel][gi, x] for x in (a, b, c, d))
            va, vb, vc, vd = (tv[sel][gi, x] for x in (a, b, c, d))

            def ep(p1, p2, v1, v2):
                t = (iso - v1) / np.where(np.abs(v2 - v1) < 1e-12, 1e-12, v2 - v1)
                return p1 + t[:, None] * (p2 - p1)

            e_ac, e_ad, e_bc, e_bd = ep(pa, pc, va, vc), ep(pa, pd, va, vd), ep(pb, pc, vb, vc), ep(pb, pd, vb, vd)
            quad_tris = np.concatenate(
                [np.stack([e_ac, e_ad, e_bd], axis=1), np.stack([e_ac, e_bd, e_bc], axis=1)]
            )
            verts_list.append(quad_tris.reshape(-1, 3))
            faces_list.append(np.arange(quad_tris.shape[0] * 3).reshape(-1, 3) + n_verts)
            n_verts += quad_tris.shape[0] * 3

    if not verts_list:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    return np.concatenate(verts_list), np.concatenate(faces_list)


def write_mesh_ply(path, vertices: np.ndarray, faces: np.ndarray):
    """Binary PLY with vertex + face elements."""
    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(vertices)}",
        "property float x", "property float y", "property float z",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(vertices.astype("<f4").tobytes())
        face_block = np.empty((len(faces), 13), dtype=np.uint8)
        face_block[:, 0] = 3
        face_block[:, 1:] = faces.astype("<i4").view(np.uint8).reshape(len(faces), 12)
        f.write(face_block.tobytes())
