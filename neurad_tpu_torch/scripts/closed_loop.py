"""Closed-loop simulation server: render-by-pose HTTP API (torch port of
`neurad_tpu/scripts/closed_loop.py`). The same JSON API on the stdlib
http.server (threaded; renders run under a lock):

  POST /render_image   {pose: [[...4x4...]], timestamp: float, camera_name: str}
                       -> {image: [[...]]} (H x W x 3 floats)
  GET  /get_actors     -> {actors: [{poses, timestamps, dims}]}
  POST /update_actors  {actors: [...]} -> swap trajectories live
  GET  /start_time     -> {start_time: float}

`ClosedLoopState` serves a pipeline (a `SplatADPipeline` or an `ADPipeline`
with a NeuRAD model, whose hash grids then read bf16 copies of their tables)
and, optionally, a state dict for its model (for example one bridged from JAX
params by `params_from_jax`);
`ClosedLoopState.from_run_dir` rebuilds the pipeline of a training run
(`scripts/train.py`, SplatAD or NeuRAD) and loads its newest checkpoint.

    python -m neurad_tpu_torch.scripts.closed_loop --port 8000 [--method splatad|neurad|neurad-parity|neurad-tiny]
        [--load-dir outputs/<run>] [--state-dict model.pt] [--seed 0] [--device cuda]

serves the run's scene, or the synthetic scene without `--load-dir` (a NeuRAD
model then drawn from `--seed`).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union

import numpy as np
import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.configs.method_configs import METHODS, neurad_tiny_overrides
from neurad_tpu_torch.core import poses as pose_utils
from neurad_tpu_torch.fields.neurad_encoding import keep_bf16_copies
from neurad_tpu_torch.model_components.dynamic_actors import actor_data_from_trajectories
from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline, ADPipelineConfig
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline


class ClosedLoopState:
    """Holds the pipeline + live-editable actor trajectories."""

    def __init__(self, pipeline: Union[SplatADPipeline, ADPipeline], state_dict: Optional[dict] = None, device="cuda"):
        dev = resolve_device(device)
        if pipeline.device != dev:
            raise ValueError(f"pipeline lives on {pipeline.device}, the server was asked for {dev}")
        self.pipeline = pipeline
        if state_dict is not None:
            pipeline.model.load_state_dict(state_dict)
        keep_bf16_copies(pipeline.model)  # made at the first render, anew after a table is loaded or changed
        self.render_lock = threading.Lock()
        self.time_offset = float((pipeline.outputs.metadata or {}).get("time_offset", 0.0))
        self.last_render_seconds = float("nan")  # render + copy to host of the last image

    @classmethod
    def from_run_dir(cls, run_dir, device="cuda") -> "ClosedLoopState":
        """The server state of a training run: its scene and pipeline rebuilt
        from `config.json`, its model loaded from the newest checkpoint."""
        from neurad_tpu_torch.scripts.train import load_run

        dev = resolve_device(device)
        pipeline, _ = load_run(run_dir, device=dev)
        return cls(pipeline, device=dev)

    def render_image(self, pose_4x4, timestamp: float, camera_name: str = "front") -> np.ndarray:
        outputs = self.pipeline.outputs
        cams = outputs.cameras
        names = {v: k for k, v in outputs.sensor_idx_to_name.items()}
        sensor = names.get(camera_name, 0)
        cam_idx = 0
        if "sensor_idxs" in cams.metadata:
            matches = np.nonzero(cams.metadata["sensor_idxs"][:, 0].numpy() == sensor)[0]
            cam_idx = int(matches[0]) if len(matches) else 0

        pose = torch.as_tensor(np.asarray(pose_4x4, dtype=np.float32)[:3, :4])
        c2w = cams.camera_to_worlds.clone()
        c2w[cam_idx] = pose
        times = cams.times.clone() if cams.times is not None else None
        if times is not None:
            times[cam_idx] = timestamp
        patched = cams.replace(camera_to_worlds=c2w, times=times)
        with self.render_lock:
            self.pipeline.outputs.cameras = patched
            self.pipeline.datamanager.outputs.cameras = patched
            start = time.perf_counter()
            pred, _ = self.pipeline.render_eval_camera(cam_idx)
            self.last_render_seconds = time.perf_counter() - start
        return pred

    def get_actors(self):
        return [
            {
                "poses": np.asarray(t["poses"]).tolist(),
                "timestamps": np.asarray(t["timestamps"]).tolist(),
                "dims": np.asarray(t["dims"]).tolist(),
            }
            for t in self.pipeline.outputs.trajectories
        ]

    @torch.no_grad()
    def update_actors(self, actors):
        """Replace actor trajectories live: rebuild the actor data and
        overwrite only the trajectory parameters."""
        trajs = [
            {
                "poses": np.asarray(a["poses"], dtype=np.float32),
                "timestamps": np.asarray(a["timestamps"]),
                "dims": np.asarray(a["dims"], dtype=np.float32),
                "symmetric": a.get("symmetric", True),
                "deformable": a.get("deformable", False),
            }
            for a in actors
        ]
        data = actor_data_from_trajectories(trajs)
        act = self.pipeline.model.actors
        poses = torch.from_numpy(data.poses).to(act.actor_positions.device)
        with self.render_lock:
            act.actor_positions.copy_(poses[..., :3, 3])
            act.actor_rotations_6d.copy_(pose_utils.rotmat_to_6d(poses[..., :3, :3]))
            act.actor_vel_linear.copy_(torch.from_numpy(data.vel_linear))
            act.actor_vel_angular.copy_(torch.from_numpy(data.vel_angular))


def make_handler(cls_state: ClosedLoopState):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, payload, code=200):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/get_actors":
                self._json({"actors": cls_state.get_actors()})
            elif self.path == "/start_time":
                self._json({"start_time": cls_state.time_offset})
            else:
                self._json({"error": "unknown endpoint"}, 404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/render_image":
                img = cls_state.render_image(
                    req["pose"], float(req.get("timestamp", 0.0)), req.get("camera_name", "front")
                )
                self._json({"image": img.tolist()})
            elif self.path == "/update_actors":
                cls_state.update_actors(req["actors"])
                self._json({"status": "ok"})
            else:
                self._json({"error": "unknown endpoint"}, 404)

        def log_message(self, *args):
            pass

    return Handler


def build_state(method: str = "splatad", device="cuda", seed: int = 0, outputs=None) -> ClosedLoopState:
    """A server state on the synthetic scene (or `outputs`) with a model drawn
    from `seed`: method "splatad", "neurad" or "neurad-parity" (the presets'
    full width: `neurad-parity`'s grids read their fp32 tables, so its state
    keeps no bf16 copies) or "neurad-tiny"."""
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig

    device = resolve_device(device)
    if outputs is None:
        outputs = SyntheticDataParserConfig().setup().get_dataparser_outputs()
    if method == "splatad":
        pipeline = SplatADPipeline(outputs, device=device)
    elif method in ("neurad", "neurad-parity"):
        cfg = METHODS[method]().pipeline
        cfg.seed = seed
        pipeline = ADPipeline(outputs, cfg, device=device)
    elif method == "neurad-tiny":
        pipeline = ADPipeline(outputs, ADPipelineConfig(model_overrides=neurad_tiny_overrides(), seed=seed),
                              device=device)
    else:
        raise ValueError(f"unknown method {method!r}")
    return ClosedLoopState(pipeline, device=device)


def state_from_args(argv=None):
    """(the server state the command line asks for, the port to serve it on)."""
    parser = argparse.ArgumentParser(description="Closed-loop render server (synthetic scene)")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--method", default="splatad", choices=("splatad", "neurad", "neurad-parity", "neurad-tiny"))
    parser.add_argument("--seed", type=int, default=0, help="seed of a NeuRAD state's weights")
    parser.add_argument("--state-dict", default=None, help="torch.save'd state dict for the model")
    parser.add_argument("--load-dir", default=None, help="run directory of scripts/train.py to serve")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.load_dir:
        state = ClosedLoopState.from_run_dir(args.load_dir, device=device)
    else:
        state = build_state(args.method, device=device, seed=args.seed)
    if args.state_dict:
        state.pipeline.model.load_state_dict(torch.load(args.state_dict, map_location=device))
    return state, args.port


def entrypoint(argv=None):
    state, port = state_from_args(argv)
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(state))
    print(f"[closed-loop] serving on :{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    entrypoint()
