"""The port's data ingestion (`neurad_tpu_torch/process_data.py`,
`process_data_converters.py`) against the JAX package's: every capture-app
converter on tests/data/test_process_data_converters.py's synthetic exports
gives the same transforms.json dict, the panorama crops are bit-equal, and
`load_transforms_json` gives JAX's cameras and images (read through the
port's PNG reader; JAX's through imageio).

Tolerances: everything is host numpy on both sides and compared bit for bit,
but the cameras' `times`: JAX's `jnp.linspace` divides in XLA, whose float32
quotient is not always the correctly rounded one the port's numpy linspace
gives; they are held to one float32 ulp of 1.0.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from neurad_tpu import process_data as JP
from neurad_tpu import process_data_converters as JC
from neurad_tpu_torch import process_data as TP
from neurad_tpu_torch import process_data_converters as TC
from neurad_tpu_torch.data.png import write_png

torch.set_num_threads(1)

ULP1 = float(np.finfo(np.float32).eps)


def _write_colmap_bin(recon, qvec, tvec):
    """A COLMAP binary model of one OPENCV camera and one image (the JAX test's writer)."""
    import struct

    with open(recon / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 4, 640, 480))
        f.write(struct.pack("<8d", 500.0, 510.0, 320.0, 240.0, 0.1, 0.01, 0.001, 0.002))
    with open(recon / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<i", 7))
        f.write(struct.pack("<4d", *qvec))
        f.write(struct.pack("<3d", *tvec))
        f.write(struct.pack("<i", 1))
        f.write(b"im0.jpg\x00")
        f.write(struct.pack("<Q", 2))  # two 2D points (skipped by the parser)
        f.write(struct.pack("<2dq", 1.0, 2.0, -1) + struct.pack("<2dq", 3.0, 4.0, 5))


def _same(got, want):
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def _both(tmp_path, fn, *args, **kw):
    """The JAX converter's dict and transforms.json, then the port's, each in its own directory."""
    out = []
    for name, mod in (("jax", JC), ("torch", TC)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        data = getattr(mod, fn)(*args, d, **kw)
        out.append((data, json.loads((d / "transforms.json").read_text())))
    (jd, jf), (td, tf) = out
    _same(td, jd)
    _same(tf, jf)
    return td


def test_rotation_helpers_are_bit_equal():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(16, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    assert np.array_equal(TC.quat_xyzw_to_matrix(q), JC.quat_xyzw_to_matrix(q))
    for rvec in (np.zeros(3), np.array([0.0, 0.0, np.pi / 2]), rng.normal(size=3)):
        assert np.array_equal(TC.rodrigues_to_matrix(rvec), JC.rodrigues_to_matrix(rvec))
    assert np.array_equal(TC._qvec_wxyz_to_matrix(q[0]), JC._qvec_wxyz_to_matrix(q[0]))


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_colmap_matches_jax(tmp_path, fmt):
    src = tmp_path / "recon"
    src.mkdir()
    if fmt == "bin":
        _write_colmap_bin(src, qvec=(0.9, 0.1, -0.2, 0.3), tvec=(1.0, 2.0, 3.0))
    else:
        (src / "cameras.txt").write_text("# comment\n1 SIMPLE_RADIAL 640 480 500 320 240 0.05\n")
        (src / "images.txt").write_text("# comment\n7 1 0 0 0 0.5 0.5 0.5 1 im1.jpg\n1.0 2.0 -1\n")
    ext = f".{fmt}"
    assert TC.read_colmap_cameras(src / f"cameras{ext}") == JC.read_colmap_cameras(src / f"cameras{ext}")
    t_imgs, j_imgs = TC.read_colmap_images(src / f"images{ext}"), JC.read_colmap_images(src / f"images{ext}")
    assert t_imgs.keys() == j_imgs.keys()
    for k in j_imgs:
        assert all(np.array_equal(t_imgs[k][f], j_imgs[k][f]) for f in ("qvec", "tvec"))
        assert (t_imgs[k]["camera_id"], t_imgs[k]["name"]) == (j_imgs[k]["camera_id"], j_imgs[k]["name"])
    data = _both(tmp_path, "colmap_to_transforms", src)
    assert len(data["frames"]) == 1


def test_polycam_matches_jax(tmp_path):
    cams = tmp_path / "cameras"
    cams.mkdir()
    pose = {f"t_{r}{c}": float(np.eye(4)[r, c]) for r in range(3) for c in range(4)}
    pose["t_03"] = 5.0
    for stem, blur in (("a", 100.0), ("b", 1.0)):
        (cams / f"{stem}.json").write_text(json.dumps({
            "fx": 500.0, "fy": 500.0, "cx": 320.0, "cy": 240.0, "width": 640, "height": 480, "blur_score": blur, **pose,
        }))
    data = _both(tmp_path, "polycam_to_transforms", cams, ["a.jpg", "b.jpg"], min_blur_score=10.0,
                 crop_border_pixels=4)
    assert data["skipped_frames"] == 1


def test_record3d_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(3, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    md = {"poses": np.concatenate([q, rng.normal(size=(3, 3))], -1).tolist(),
          "K": np.array([[500.0, 0, 0], [0, 500.0, 0], [320.0, 240.0, 1]]).reshape(-1).tolist(), "w": 640, "h": 480}
    (tmp_path / "metadata.json").write_text(json.dumps(md))
    data = _both(tmp_path, "record3d_to_transforms", tmp_path / "metadata.json", ["0.jpg", "1.jpg"],
                 indices=np.array([0, 2]))
    assert len(data["frames"]) == 2


def test_realitycapture_matches_jax(tmp_path):
    csv_path = tmp_path / "poses.csv"
    csv_path.write_text(
        "#name,x,y,alt,heading,pitch,roll,f,px,py,k1,k2,k3,k4,t1,t2\n"
        "img1.jpg,1,2,3,10,-5,3,36,0.5,-0.25,0.01,0,0,0,0.001,0\n"
        "missing.jpg,0,0,0,0,0,0,36,0,0,0,0,0,0,0,0\n"
    )
    data = _both(tmp_path, "realitycapture_to_transforms", csv_path, {"img1": (480, 640)})
    assert data["missing_images"] == 1


def test_metashape_matches_jax(tmp_path):
    xml = """<document><chunk>
      <sensors>
        <sensor id="0" type="frame">
          <resolution width="640" height="480"/>
          <calibration><f>500</f><cx>2</cx><cy>-3</cy><k1>0.1</k1></calibration>
        </sensor>
      </sensors>
      <components>
        <component id="0"><transform>
          <rotation>0 -1 0 1 0 0 0 0 1</rotation>
          <translation>1 2 3</translation><scale>2</scale>
        </transform></component>
      </components>
      <cameras>
        <camera sensor_id="0" component_id="0" label="im0.jpg">
          <transform>1 0 0 0.5 0 1 0 0 0 0 1 0.25 0 0 0 1</transform>
        </camera>
        <camera sensor_id="0" label="no_pose.jpg"/>
      </cameras>
    </chunk></document>"""
    (tmp_path / "cams.xml").write_text(xml)
    data = _both(tmp_path, "metashape_to_transforms", tmp_path / "cams.xml")
    assert data["skipped_frames"] == 1


def test_odm_matches_jax(tmp_path):
    (tmp_path / "cameras.json").write_text(json.dumps({
        "v2 cam": {"projection_type": "brown", "width": 640, "height": 480, "focal_x": 0.8, "focal_y": 0.8,
                   "c_x": 0.01, "c_y": -0.02, "k1": 0.1, "k2": 0.01}}))
    shots = {"features": [{"properties": {"filename": "im0.jpg", "rotation": [0.1, -0.2, 0.3],
                                          "translation": [4.0, 5.0, 6.0]}}]}
    (tmp_path / "shots.geojson").write_text(json.dumps(shots))
    data = _both(tmp_path, "odm_to_transforms", tmp_path / "cameras.json", tmp_path / "shots.geojson")
    assert data["camera_model"] == "OPENCV"


def _panorama(dtype):
    h, w = 64, 128
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = np.linspace(0, 1, w)[None, :]
    img[..., 1] = np.linspace(0, 1, h)[:, None]
    img[..., 2] = np.random.default_rng(0).random((h, w))
    return (img * 255).astype(np.uint8) if dtype == np.uint8 else img


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_equirect_crops_are_bit_equal(dtype):
    img = _panorama(dtype)
    for args in ((60.0, 0.0, 0.0, 33, 33), (60.0, 90.0, 0.0, 33, 33), (60.0, 0.0, 30.0, 17, 25), (90.0, 180.0, 0.0, 33, 33)):
        got, want = TP.equirect_to_perspective(img, *args), JP.equirect_to_perspective(img, *args)
        assert got.dtype == want.dtype and np.array_equal(got, want), args
    got = TP.generate_planar_projections(img, fov_deg=90.0, yaw_steps=3, pitches=(0.0, 30.0), out_size=(24, 32))
    want = JP.generate_planar_projections(img, fov_deg=90.0, yaw_steps=3, pitches=(0.0, 30.0), out_size=(24, 32))
    assert len(got) == len(want) == 6
    for (gc, gp), (wc, wp) in zip(got, want):
        assert np.array_equal(gc, wc) and np.array_equal(gp, wp)


def _transforms_scene(tmp_path, n=5):
    rng = np.random.default_rng(2)
    (tmp_path / "images").mkdir()
    frames = []
    for i in range(n):
        m = np.eye(4)
        m[:3, 3] = rng.normal(size=3)
        frame = {"file_path": f"images/{i}.png", "transform_matrix": m.tolist()}
        if i == 2:  # per-frame intrinsics override the shared ones
            frame.update(fl_x=310.5, cx=15.5, w=32, h=24)
        frames.append(frame)
        write_png(tmp_path / frame["file_path"], rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    meta = {"fl_x": 300.0, "fl_y": 301.0, "cx": 16.0, "cy": 12.0, "w": 32, "h": 24, "frames": frames}
    path = tmp_path / "transforms.json"
    path.write_text(json.dumps(meta))
    return path


@pytest.mark.parametrize("n", [5, 8])
def test_load_transforms_json_matches_jax(tmp_path, n):
    path = _transforms_scene(tmp_path, n)
    jcams, jimgs = JP.load_transforms_json(str(path))
    tcams, timgs = TP.load_transforms_json(str(path), device="cpu")
    assert len(timgs) == len(jimgs) == n
    assert all(np.array_equal(t, j) for t, j in zip(timgs, jimgs))
    for field in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height", "camera_type"):
        got, want = getattr(tcams, field), np.asarray(getattr(jcams, field))
        assert got.device.type == "cpu" and got.numpy().dtype == want.dtype, field
        assert np.array_equal(got.numpy(), want), field
    assert np.array_equal(tcams.metadata["sensor_idxs"].numpy(), np.asarray(jcams.metadata["sensor_idxs"]))
    np.testing.assert_allclose(tcams.times.numpy(), np.asarray(jcams.times), rtol=0, atol=ULP1)


def test_entrypoint_matches_jax(tmp_path, capsys):
    path = _transforms_scene(tmp_path)
    TP.entrypoint(["transforms", str(path), "--device", "cpu"])
    assert "loaded 5 frames" in capsys.readouterr().out
    src = tmp_path / "polycam"
    (src / "keyframes" / "cameras").mkdir(parents=True)
    (src / "keyframes" / "images").mkdir()
    for stem in ("a", "b"):
        (src / "keyframes" / "images" / f"{stem}.jpg").write_bytes(b"")
        (src / "keyframes" / "cameras" / f"{stem}.json").write_text(json.dumps({
            "fx": 500.0, "fy": 500.0, "cx": 320.0, "cy": 240.0, "width": 640, "height": 480,
            **{f"t_{r}{c}": float(np.eye(4)[r, c]) + r for r in range(3) for c in range(4)}}))
    JP.entrypoint(["polycam", str(src), "--output-dir", str(tmp_path / "jax")])
    TP.entrypoint(["polycam", str(src), "--output-dir", str(tmp_path / "torch"), "--device", "cpu"])
    assert (tmp_path / "torch" / "transforms.json").read_text() == (tmp_path / "jax" / "transforms.json").read_text()


def test_missing_tools_and_cuda_are_refused(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError) as want:
        JP.require_tool("colmap")
    with pytest.raises(RuntimeError) as got:
        TP.require_tool("colmap")
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="is required"):
        TP.extract_frames("clip.mp4", "frames")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TP.entrypoint(["transforms", "transforms.json"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TP.load_transforms_json("transforms.json")
