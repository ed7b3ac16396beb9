"""The port's browser viewer (`viewer/server.py`, `scripts/viewer.py`) and the
train loop's live viewer (`engine/trainer.Trainer.viewer`, the train script's
`--viewer`): the JAX viewer tests of tests/test_servers.py on the port's
server, a tiny pipeline's renders and virtual lidar through HTTP equal to
the direct calls, a raising render failing its request, and the Trainer's
gate, pause, stats and lock.

Servers bind a free port (port 0 asked of the OS, then passed in), never the
JAX tests' fixed ports. Images: the PNG a request returns, decoded by the
port's reader, equals `(clip(rgb, 0, 1) * 255).astype(uint8)` of the direct
render, bit for bit (the same CPU pipeline renders both).
"""

import base64
import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from neurad_tpu_torch.configs import method_configs as TMC
from neurad_tpu_torch.data.datamanager import ADDataManagerConfig
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.data.png import read_png
from neurad_tpu_torch.engine.trainer import Trainer, TrainerConfig
from neurad_tpu_torch.fields.neurad_encoding import NeuRADHashEncoding
from neurad_tpu_torch.ops.hash_encoding import Bf16Copies
from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline, ADPipelineConfig
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline
from neurad_tpu_torch.scripts import train as TTrain
from neurad_tpu_torch.scripts import viewer as TViewer
from neurad_tpu_torch.viewer.server import ViewerServer

torch.set_num_threads(1)

TINY = dict(num_frames=4, image_height=24, image_width=32, lidar_channels=8, lidar_azimuths=60)
FAILED_REQUEST = (urllib.error.URLError, http.client.RemoteDisconnected, ConnectionError)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _png(reply, tmp_path):
    path = tmp_path / "reply.png"
    path.write_bytes(base64.b64decode(reply["png"]))
    return read_png(path)


def _quantise(rgb):
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


class _Served:
    """A started `ViewerServer` on a free port; stopped on exit."""

    def __init__(self, render_fn, **kw):
        self.port = free_port()
        self.server = ViewerServer(render_fn, port=self.port, **kw)
        self.url = f"http://127.0.0.1:{self.port}"

    def __enter__(self):
        self.server.start(background=True)
        return self

    def __exit__(self, *exc):
        self.server.stop()


@pytest.fixture(scope="module")
def pipelines():
    """The port's tiny SplatAD (`splatad-tiny`) and NeuRAD (`neurad-tiny`
    widths) pipelines on the CPU."""
    out = TSynth(**TINY).setup().get_dataparser_outputs()
    splatad = SplatADPipeline(out, TMC.METHODS["splatad-tiny"]().pipeline, device="cpu")
    neurad = ADPipeline(TSynth(**TINY).setup().get_dataparser_outputs(),
                        ADPipelineConfig(datamanager=ADDataManagerConfig(num_cam_patches=2, patch_size=4,
                                                                         num_lidar_rays=64),
                                         model_overrides=TMC.neurad_tiny_overrides(), eval_chunk=256), device="cpu")
    return {"splatad": splatad, "neurad": neurad}


def test_viewer_server_renders():
    """tests/test_servers.py's page, render, lidar and export round trips."""
    calls = {}

    def render_fn(pose, w, h, t01, edits=None):
        calls["pose"] = np.asarray(pose)
        calls["edits"] = edits
        return np.full((h, w, 3), 0.5, dtype=np.float32)

    def lidar_fn(t01, channels, azim_res, drop_threshold, edits=None):
        calls["lidar"] = (t01, channels, azim_res, drop_threshold)
        return np.zeros((5, 4), dtype=np.float32)

    def export_fn():
        calls["export"] = True
        return "fake.ply"

    with _Served(render_fn, lidar_fn=lidar_fn, export_fn=export_fn) as s:
        with urllib.request.urlopen(s.url + "/", timeout=10) as r:
            assert b"neurad_tpu viewer" in r.read()
        pose = np.eye(4)[:3].tolist()
        out = _post(s.url + "/render", {"pose": pose, "quality": "low", "t01": 0.2, "edits": {"lateral": 1.0}})
        assert "png" in out and len(out["png"]) > 100 and out["status"] == "96x64"
        assert calls["pose"].shape == (3, 4) and calls["edits"] == {"lateral": 1.0}
        out = _post(s.url + "/lidar", {"t01": 0.5, "channels": 16, "azim_res": 2.0, "drop_threshold": 0.4})
        assert len(out["pts"]) == 5 and calls["lidar"] == (0.5, 16, 2.0, 0.4)
        out = _post(s.url + "/export", {})
        assert out["path"] == "fake.ply" and calls.get("export")


def test_viewer_without_lidar_or_export_hooks():
    with _Served(lambda pose, w, h, t01, edits=None: np.zeros((h, w, 3), np.float32)) as s:
        assert _post(s.url + "/lidar", {}) == {"pts": []}
        assert _post(s.url + "/export", {}) == {"path": None}


def test_viewer_caps_the_lidar_payload():
    pts = np.arange(50_000 * 4, dtype=np.float32).reshape(-1, 4) / 7.0
    with _Served(lambda *a, **k: None, lidar_fn=lambda *a: pts) as s:
        out = _post(s.url + "/lidar", {})
    want = np.round(pts[:: pts.shape[0] // 20000 + 1], 3).tolist()
    assert out["pts"] == want and len(want) <= 20000


def test_viewer_train_control_and_per_client_state():
    """tests/test_servers.py's /train pause and util, the throttle of
    `train_gate`, and the per-client stale drop."""

    def render_fn(pose, w, h, t01, edits=None):
        return np.full((h, w, 3), 0.5, dtype=np.float32)

    with _Served(render_fn) as s:
        server = s.server
        st = _post(s.url + "/train", {})
        assert st["paused"] is False and st["train_util"] == 0.9
        server.update_train_stats(120, loss=0.42, steps_per_sec=1.5)
        st = _post(s.url + "/train", {"paused": True, "train_util": 0.5})
        assert st["paused"] and st["train_util"] == 0.5
        assert st["step"] == 120 and abs(st["loss"] - 0.42) < 1e-9 and st["steps_per_sec"] == 1.5
        assert _post(s.url + "/train", {"train_util": 7.0})["train_util"] == 1.0  # clamped to [0.05, 1]
        assert _post(s.url + "/train", {"train_util": 0.0})["train_util"] == 0.05

        done = []
        t = threading.Thread(target=lambda: (server.train_gate(), done.append(True)), daemon=True)
        t.start()
        time.sleep(0.15)
        assert not done, "train_gate must block while paused"
        _post(s.url + "/train", {"paused": False})
        t.join(timeout=5)
        assert done

        _post(s.url + "/train", {"train_util": 0.5})
        server.train_gate()
        time.sleep(0.1)  # "busy" training for 100 ms
        t0 = time.perf_counter()
        server.train_gate()  # sleeps ~100 ms at util 0.5
        slept = time.perf_counter() - t0
        assert 0.04 < slept < 0.6, f"expected ~0.1s throttle sleep, got {slept:.3f}"

        pose = np.eye(4)[:3].tolist()
        assert "png" in _post(s.url + "/render", {"pose": pose, "client": "c1", "seq": 5})
        assert _post(s.url + "/render", {"pose": pose, "client": "c1", "seq": 3}).get("stale") is True
        assert "png" in _post(s.url + "/render", {"pose": pose, "client": "c2", "seq": 1})


def test_stale_drop_evicts_the_least_recently_seen_client():
    server = ViewerServer(lambda *a, **k: None, port=0)
    for i in range(64):
        server._register_seq(f"c{i}", 10)
    server._register_seq("c0", 11)  # c0 seen again: c1 is now the least recent
    server._register_seq("new", 1)
    assert "c1" not in server._client_seq and server._is_stale("c0", 10) and not server._is_stale("c1", 0)
    assert len(server._client_seq) == 64


@pytest.mark.parametrize("name", ["splatad", "neurad"])
def test_pipeline_renders_over_http_equal_the_direct_calls(pipelines, name, tmp_path):
    """Both qualities of SplatAD; NeuRAD's 96x64 (its 384x256 frame is the
    same code at 16 times the rays, seconds on the CPU)."""
    pipeline = pipelines[name]
    render_fn, lidar_fn = TViewer.viewer_fns(pipeline)
    pose = pipeline.outputs.cameras.camera_to_worlds[1].numpy()
    edits = {"lateral": 0.5, "rotation": 0.2}
    t01 = 0.4
    with _Served(render_fn, lidar_fn=lidar_fn) as s:
        qualities = (("low", (96, 64)), ("high", (384, 256)))[: 2 if name == "splatad" else 1]
        for quality, (w, h) in qualities:
            reply = _post(s.url + "/render", {"pose": pose.tolist(), "quality": quality, "t01": t01, "edits": edits})
            assert reply["status"] == f"{w}x{h}"
            direct = pipeline.render_viewer_image(pose, w, h, t01 * pipeline.outputs.duration,
                                                  TViewer.edits_vec(edits))
            got = _png(reply, tmp_path)
            assert got.shape == direct.shape and np.array_equal(got, _quantise(direct)), quality
        lidar = {"t01": t01, "channels": 8, "azim_res": 6.0, "drop_threshold": 0.7, "edits": edits}
        pts = _post(s.url + "/lidar", lidar)["pts"]
    origin = pipeline.outputs.cameras.camera_to_worlds[:, :3, 3].numpy().mean(0)
    origin[2] += 0.5
    direct = pipeline.render_virtual_lidar(origin, t01 * pipeline.outputs.duration, channels=8, azim_res_deg=6.0,
                                           drop_threshold=0.7, edits_vec=TViewer.edits_vec(edits))
    assert pts == np.round(direct, 3).tolist()


def test_a_raising_render_fails_its_request(tmp_path):
    calls = []

    def render_fn(pose, w, h, t01, edits=None):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("render failed")
        return np.full((h, w, 3), 0.25, np.float32)

    def lidar_fn(*a):
        raise RuntimeError("scan failed")

    with _Served(render_fn, lidar_fn=lidar_fn) as s:
        pose = np.eye(4)[:3].tolist()
        with pytest.raises(FAILED_REQUEST):
            _post(s.url + "/render", {"pose": pose})
        with pytest.raises(FAILED_REQUEST):
            _post(s.url + "/lidar", {})
        assert not s.server.train_lock.locked(), "the failed requests released the lock"
        reply = _post(s.url + "/render", {"pose": pose})  # the server goes on serving
        assert np.array_equal(_png(reply, tmp_path), np.full((64, 96, 3), 63, np.uint8))


class _FakePipeline:
    """The least a Trainer drives: a train step (which can hold it for a
    while) and no eval."""

    device = torch.device("cpu")

    def __init__(self, step_s=0.0):
        self.step_s, self.started = step_s, threading.Event()
        self.ends = []

    def train_step(self, state, *args):
        self.started.set()
        time.sleep(self.step_s)
        state.step += 1
        self.ends.append(time.perf_counter())
        return state, {"total_loss": torch.tensor(0.5 / state.step)}

    def eval_metrics(self):
        return {}


class _State:
    step = 0


def _batches():
    while True:
        yield (), 128


def test_trainer_gates_each_step_pauses_and_shows_its_stats():
    server = ViewerServer(lambda *a, **k: None, port=0)
    gates = []
    gate = server.train_gate
    server.train_gate = lambda: (gates.append(1), gate())
    server._train_ctl({"train_util": 1.0})
    trainer = Trainer(_FakePipeline(), _State(), TrainerConfig(max_num_iterations=5, steps_per_log=2),
                      batches=_batches())
    trainer.viewer = server
    trainer.train(save_at_end=False)
    assert trainer.state.step == 5 and len(gates) == 5
    st = server._train_ctl({})
    assert st["step"] == 4 and st["loss"] == pytest.approx(0.1) and st["steps_per_sec"] > 0

    server._train_ctl({"paused": True})
    run = threading.Thread(target=lambda: trainer.train(8, save_at_end=False), daemon=True)
    run.start()
    time.sleep(0.2)
    assert trainer.state.step == 5, "a paused viewer holds the loop before its next step"
    server._train_ctl({"paused": False})
    run.join(timeout=10)
    assert trainer.state.step == 8 and len(gates) == 8


def test_a_render_waits_for_the_step_holding_the_lock():
    pipeline = _FakePipeline(step_s=0.3)
    rendered = []

    def render_fn(pose, w, h, t01, edits=None):
        rendered.append(time.perf_counter())
        return np.zeros((h, w, 3), np.float32)

    with _Served(render_fn) as s:
        trainer = Trainer(pipeline, _State(), TrainerConfig(max_num_iterations=1), batches=_batches())
        trainer.viewer = s.server
        run = threading.Thread(target=lambda: trainer.train(save_at_end=False), daemon=True)
        run.start()
        assert pipeline.started.wait(10)
        assert s.server.train_lock.locked(), "the step holds the viewer's lock"
        t0 = time.perf_counter()
        _post(s.url + "/render", {"pose": np.eye(4)[:3].tolist()})
        run.join(timeout=10)
    assert rendered and rendered[0] >= pipeline.ends[0], "the render ran after the step released the lock"
    assert rendered[0] - t0 > 0.1


@pytest.mark.parametrize("name", ["splatad", "neurad"])
def test_train_render_from_another_thread_train(pipelines, name):
    """A render from a second thread between train steps (the viewer's
    renders run under no_grad or inference_mode in their own thread) leaves
    nothing that breaks the next step's autograd."""
    pipeline = pipelines[name]
    state = pipeline.init_state()
    trainer = Trainer(pipeline, state, TrainerConfig(steps_per_log=10**9, steps_per_eval_batch=10**9))
    server = ViewerServer(lambda *a, **k: None, port=0)
    trainer.viewer = server
    render_fn, lidar_fn = TViewer.viewer_fns(pipeline)
    trainer.train(1, save_at_end=False)
    out, errors = [], []

    def view():
        try:
            with server.train_lock:
                pose = pipeline.outputs.cameras.camera_to_worlds[0].numpy()
                out.append(render_fn(pose, 32, 24, 0.3, {"lateral": 0.5}))
                out.append(lidar_fn(0.3, 8, 6.0, 0.5))
        except Exception as e:  # reported below, with the main thread's assertion
            errors.append(e)

    thread = threading.Thread(target=view)
    thread.start()
    thread.join()
    assert not errors and len(out) == 2 and np.isfinite(out[0]).all()
    before = {n: p.detach().clone() for n, p in pipeline.model.named_parameters()}
    trainer.train(3, save_at_end=False)
    assert trainer.state.step == 3
    assert any(not torch.equal(before[n], p) for n, p in pipeline.model.named_parameters())


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """Runs of the port's train script on the CPU (2 steps): `splatad-tiny`,
    and `neurad-tiny` with the live viewer on, which answers a render and an
    export while it trains."""
    root = tmp_path_factory.mktemp("runs")
    dp = [a for k, v in TINY.items() for a in ("--dp-set", f"{k}={v}")]
    TTrain.entrypoint(["splatad-tiny", "--device", "cpu", "--max-iterations", "2", "--output-dir", str(root),
                       "--experiment-name", "splatad"] + dp)
    served = {}
    real = TTrain._start_viewer

    def start(pipeline, run_dir, port):
        server = real(pipeline, run_dir, port)
        url = f"http://127.0.0.1:{port}"
        served["render"] = _post(url + "/render", {"pose": np.eye(4)[:3].tolist(), "quality": "low"})
        served["export"] = _post(url + "/export", {})
        served["server"] = server
        return server

    port = free_port()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TTrain, "_start_viewer", start)
        TTrain.entrypoint(["neurad-tiny", "--device", "cpu", "--max-iterations", "2", "--output-dir", str(root),
                           "--experiment-name", "neurad", "--viewer", "--viewer-port", str(port)] + dp)
    return {"splatad": root / "splatad", "neurad": root / "neurad", "served": served}


def test_train_script_serves_the_live_viewer(run_dirs):
    served = run_dirs["served"]
    assert "png" in served["render"] and served["render"]["status"] == "96x64"
    assert served["export"]["path"] == str(run_dirs["neurad"] / "viewer_export_pointcloud.ply")
    assert (run_dirs["neurad"] / "viewer_export_pointcloud.ply").stat().st_size > 0
    assert served["server"]._server.socket.fileno() == -1, "the server stopped with the run"


@pytest.mark.parametrize("name", ["splatad", "neurad"])
def test_serve_run_renders_the_run(run_dirs, name, tmp_path):
    port = free_port()
    server, pipeline = TViewer.serve_run(run_dirs[name], port=port, device="cpu")
    assert server.port == port and server.export_fn is None and pipeline.device.type == "cpu"
    grids = [g for m in pipeline.model.modules() if isinstance(m, NeuRADHashEncoding)
             for g in (m.static_grid, m.actor_grid)]
    assert all(isinstance(g.copies, Bf16Copies) for g in grids) and bool(grids) == (name == "neurad")
    server.start(background=True)
    try:
        pose = pipeline.outputs.cameras.camera_to_worlds[0].numpy()
        reply = _post(f"http://127.0.0.1:{port}/render", {"pose": pose.tolist(), "quality": "low", "t01": 0.5})
    finally:
        server.stop()
    direct = pipeline.render_viewer_image(pose, 96, 64, 0.5 * pipeline.outputs.duration, None)
    assert np.array_equal(_png(reply, tmp_path), _quantise(direct))
