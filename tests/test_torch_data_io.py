"""The port's host-side data helpers against the JAX package's and against
imageio: the PNG reader and writer, the lidar binning of the missing-point
synthesis, the quaternion and trajectory interpolation the parsers resample
actor tracks with, the beam tables, and the PandaSet fixture writer.

Tolerances: `read_png` is bit-equal to `imageio.v2.imread` (PNG is lossless).
`bin_points` is held to `neurad_tpu.native.bin_points` (its C++ build, float32
`atan2f`) with tests/test_native.py's bounds: channels equal, azimuth bins and
occupancy differing in < 1e-3 of the points and of the grid. The rotation and
interpolation helpers run float32 on both sides: 1e-6 absolute on unit
quaternions and rotations, 1e-5 relative on positions.
"""

import json
import struct
import zlib

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import neurad_tpu.data.lidar_elevation_mappings as jlem
import neurad_tpu.native as native
from neurad_tpu.core import poses as jposes
from neurad_tpu.data.dataparsers.fixtures import make_pandaset_fixture as j_make_pandaset
from neurad_tpu_torch.core import poses as tposes
from neurad_tpu_torch.data import lidar_elevation_mappings as tlem
from neurad_tpu_torch.data.dataparsers.fixtures import make_pandaset_fixture as t_make_pandaset
from neurad_tpu_torch.data.native_ops import bin_points
from neurad_tpu_torch.data.png import read_png, read_png_size, write_png

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _images(rng):
    """Noise, gradients and mixtures at each channel count, odd sizes too."""
    out = []
    for h, w in ((24, 32), (37, 51), (5, 3)):
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        for ch in (None, 2, 3, 4):
            shape = (h, w) if ch is None else (h, w, ch)
            smooth = (yy * 7 + xx * 3) if ch is None else (yy * 7 + xx * 3)[..., None] + np.arange(ch) * 40
            noise = rng.integers(0, 255, shape)
            for img in (noise, smooth, smooth + noise // 16, (np.sin(xx / 3.0) * 90 + 100)[..., None] * np.ones(ch or 1)):
                img = np.asarray(img) % 256
                out.append(img.reshape(shape).astype(np.uint8))
    return out


def _filters_of(path):
    data = path.read_bytes()
    pos, idat, width, height, bpp = 8, b"", 0, 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            width, height = struct.unpack(">II", body[:8])
            bpp = {0: 1, 4: 2, 2: 3, 6: 4}[body[9]]
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, width * bpp + 1)[:, 0].tolist())


def test_read_png_is_bit_equal_to_imageio(tmp_path):
    """PNGs written by imageio (its encoder picks a filter per row) and by
    `write_png`, at every channel count the reader takes."""
    rng = np.random.default_rng(0)
    filters, our_filters = set(), set()
    for i, img in enumerate(_images(rng)):
        theirs, ours = tmp_path / f"i{i}.png", tmp_path / f"o{i}.png"
        imageio.imwrite(theirs, img)
        filters |= _filters_of(theirs)
        got, want = read_png(theirs), np.asarray(imageio.imread(theirs))
        assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        write_png(ours, img)
        our_filters |= _filters_of(ours)
        np.testing.assert_array_equal(np.asarray(imageio.imread(ours)), img)
        np.testing.assert_array_equal(read_png(ours), img)
        assert read_png_size(ours) == read_png_size(theirs) == img.shape[:2]
    assert {0, 1, 2, 4} <= filters, f"imageio's encoder used filters {sorted(filters)}"
    assert {1, 2, 3, 4} <= our_filters, f"write_png used filters {sorted(our_filters)}"


def test_write_png_writes_a_camera_frame_in_every_filter(tmp_path):
    """A 1242x375 frame of the KITTI fixture's kind: `write_png` picks Sub,
    Up, Average and Paeth rows, as libpng would, and the reader undoes them
    (the wavefront from the first Average or Paeth row on) bit-equal to
    imageio."""
    rng = np.random.default_rng(3)
    yy, xx = np.meshgrid(np.linspace(0, 1, 375), np.linspace(0, 1, 1242), indexing="ij")
    img = np.stack([yy, xx, 0.5 * (xx + yy)], axis=-1) * 0.8 + rng.uniform(0, 0.08, size=(375, 1242, 1))
    img += 0.2 * ((np.sin(xx * 300 + 40 * yy) > 0) & (yy > 0.5))[..., None]
    img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    path = tmp_path / "frame.png"
    write_png(path, img, level=1)
    assert {1, 2, 3, 4} <= _filters_of(path)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)
    np.testing.assert_array_equal(read_png(path), img)


def _encode_filtered(img, kind):
    """A PNG of `img` ([H, W, C] uint8) with row filter `kind` on every row,
    filtered byte by byte as the PNG specification writes it."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        prior = rows[y - 1] if y else np.zeros(w * c, np.int64)
        out = []
        for x in range(w * c):
            a = rows[y, x - c] if x >= c else 0
            b = prior[x]
            cc = prior[x - c] if x >= c else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            out.append((rows[y, x] - pred) % 256)
        raw += bytes([kind]) + bytes(out)
    chunk = lambda k, body: struct.pack(">I", len(body)) + k + body + struct.pack(">I", zlib.crc32(k + body))
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_read_png_undoes_every_row_filter(tmp_path, kind):
    rng = np.random.default_rng(kind)
    for c in (1, 3, 4):
        img = ((np.arange(9 * 13 * c).reshape(9, 13, c) * 5 + rng.integers(0, 60, (9, 13, c))) % 256).astype(np.uint8)
        path = tmp_path / f"f{kind}_{c}.png"
        path.write_bytes(_encode_filtered(img, kind))
        np.testing.assert_array_equal(np.asarray(imageio.imread(path)).reshape(img.shape), img)
        np.testing.assert_array_equal(read_png(path).reshape(img.shape), img)


# ---------------------------------------------------------------------------
# lidar binning and beam tables
# ---------------------------------------------------------------------------


def _native_bins(pts, elevs, res, n_azim):
    native._load()
    assert native._LIB is not None, "the JAX package's C++ bin_points builds here (g++)"
    return native.bin_points(pts, elevs, res, n_azim)


@pytest.mark.parametrize("case", ["gaussian", "hdl64e"])
def test_bin_points_matches_the_native_binning(case):
    rng = np.random.default_rng(1)
    if case == "gaussian":  # tests/test_native.py's input
        pts = (rng.normal(size=(20000, 3)) * 20).astype(np.float32)
        elevs, res, n_azim = np.linspace(-25, 15, 64).astype(np.float32), 0.5, 720
    else:  # the HDL-64E's table, points on its beams at random azimuths and ranges
        elevs, res = tlem.ELEVATION_MAPPINGS["VELODYNE64E"], tlem.AZIMUTH_RESOLUTION["VELODYNE64E"]
        n_azim = int(round(360.0 / res))
        el = np.deg2rad(elevs[rng.integers(0, 64, 50000)] + rng.normal(0, 0.02, 50000))
        az = rng.uniform(-np.pi, np.pi, 50000)
        r = rng.uniform(2.0, 120.0, 50000)
        pts = (np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1) * r[:, None]
               ).astype(np.float32)
    occ_n, ch_n, ab_n = _native_bins(pts, elevs, res, n_azim)
    occ, ch, ab = bin_points(pts, elevs, res, n_azim)
    assert occ.shape == occ_n.shape and occ.dtype == bool and ch.dtype == ab.dtype == np.int64
    np.testing.assert_array_equal(ch, ch_n)
    assert (ab != ab_n).mean() < 1e-3
    assert (occ != occ_n).mean() < 1e-3
    assert occ.sum() > 0.1 * min(occ.size, len(pts))


def test_beam_tables_are_the_jax_packages():
    assert tlem.ELEVATION_MAPPINGS.keys() == jlem.ELEVATION_MAPPINGS.keys()
    for k, v in jlem.ELEVATION_MAPPINGS.items():
        np.testing.assert_array_equal(tlem.ELEVATION_MAPPINGS[k], v, err_msg=k)
        assert tlem.ELEVATION_MAPPINGS[k].dtype == v.dtype
    assert tlem.AZIMUTH_RESOLUTION == jlem.AZIMUTH_RESOLUTION
    pts = np.random.default_rng(2).normal(size=(500, 3)).astype(np.float32)
    np.testing.assert_array_equal(tlem.assign_channels(pts, tlem.PANDAR64_ELEVATIONS),
                                  jlem.assign_channels(pts, jlem.PANDAR64_ELEVATIONS))


# ---------------------------------------------------------------------------
# rotations and trajectory interpolation
# ---------------------------------------------------------------------------


def _rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r = np.array(jposes.quat_to_rotmat(jnp.asarray(q)))
    # the four branches of the conversion: identity-like, and 180-degree turns about each axis
    r[:4] = [np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])]
    return q, r.astype(np.float32)


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(3)
    q, r = _rotations(rng, 200)
    np.testing.assert_allclose(tposes.rotmat_to_quat(torch.from_numpy(r)).numpy(),
                               np.asarray(jposes.rotmat_to_quat(jnp.asarray(r))), atol=1e-6)
    np.testing.assert_allclose(tposes.quat_to_rotmat(torch.from_numpy(q)).numpy(),
                               np.asarray(jposes.quat_to_rotmat(jnp.asarray(q))), atol=1e-6)
    q1 = q[::-1].copy()
    q1[:3] = q[:3] + 1e-7  # nearly parallel pairs take the lerp
    frac = rng.uniform(-0.5, 1.5, 200).astype(np.float32)
    np.testing.assert_allclose(tposes.quat_slerp(torch.from_numpy(q), torch.from_numpy(q1), torch.from_numpy(frac)).numpy(),
                               np.asarray(jposes.quat_slerp(jnp.asarray(q), jnp.asarray(q1), jnp.asarray(frac))),
                               atol=1e-6)


@pytest.mark.parametrize("clamp_frac", [True, False])
def test_interpolate_trajectories_matches_jax(clamp_frac):
    rng = np.random.default_rng(4)
    t_n, a_n = 7, 3
    _, r = _rotations(rng, t_n * a_n)
    poses = np.concatenate([r.reshape(t_n, a_n, 3, 3), rng.normal(size=(t_n, a_n, 3, 1)) * 20], -1).astype(np.float32)
    times = np.cumsum(rng.uniform(0.05, 0.2, t_n)).astype(np.float32)
    query = rng.uniform(times[0] - 0.3, times[-1] + 0.3, 40).astype(np.float32)
    got = tposes.interpolate_trajectories(torch.from_numpy(poses), torch.from_numpy(times), torch.from_numpy(query),
                                          clamp_frac)
    want, _ = jposes.interpolate_trajectories(jnp.asarray(poses), jnp.asarray(times), jnp.asarray(query),
                                              clamp_frac=clamp_frac)
    want = np.asarray(want)
    np.testing.assert_allclose(got[..., :3].numpy(), want[..., :3], atol=1e-6)
    np.testing.assert_allclose(got[..., 3].numpy(), want[..., 3], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fixture writer
# ---------------------------------------------------------------------------


def test_pandaset_fixture_writes_the_jax_packages_files(tmp_path):
    kw = dict(seq="002", n_frames=3, cameras=("front", "left"), height=16, width=24, points_per_scan=300, n_actors=3,
              seed=5)
    a, b = t_make_pandaset(str(tmp_path / "t"), **kw), j_make_pandaset(str(tmp_path / "j"), **kw)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file()) and len(files) == 2 * (3 + 3) + (3 + 2) + 3
    for rel in files:
        if rel.suffix == ".gz":  # gzip headers carry the write time
            pd.testing.assert_frame_equal(pd.read_pickle(a / rel), pd.read_pickle(b / rel))
        elif rel.suffix == ".json":
            assert json.loads((a / rel).read_text()) == json.loads((b / rel).read_text())
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
