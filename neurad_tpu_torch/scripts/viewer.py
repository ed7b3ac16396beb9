"""Interactive browser viewer for a trained run (torch port of
`neurad_tpu/scripts/viewer.py`; counterpart of `ns-viewer`,
`nerfstudio/scripts/viewer/run_viewer.py`).

    python -m neurad_tpu_torch.scripts.viewer outputs/<run> --port 7007 [--device cpu]

Runs on a CUDA device unless `--device cpu` is given. Works for the three
pipeline families: NeuRAD (chunked feature-field render; its hash grids read
bf16 copies of their tables, as the closed-loop server's do), SplatAD (direct
rasterization) and splatfacto (camera renders only). Each exposes
`render_viewer_image`; the first two also `render_virtual_lidar`, with the
viewer's actor-edit values.
"""

from __future__ import annotations

import argparse
from typing import TYPE_CHECKING, Tuple

import numpy as np

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.fields.neurad_encoding import keep_bf16_copies
from neurad_tpu_torch.viewer.server import ViewerServer

if TYPE_CHECKING:  # the train script imports this module
    from neurad_tpu_torch.scripts.train import Pipeline


def edits_vec(edits):
    """The viewer's actor-edit sliders -> (lateral, longitudinal, rotation,
    height, rolling shutter), or None without edits."""
    if not edits:
        return None
    return np.asarray(
        [
            edits.get("lateral", 0.0), edits.get("longitudinal", 0.0),
            edits.get("rotation", 0.0), edits.get("height", 0.0),
            edits.get("rs", 0.0),  # rolling-shutter slider (splatad only)
        ],
        dtype=np.float32,
    )


def viewer_fns(pipeline):
    """(render_fn, lidar_fn or None) for `ViewerServer` on the pipeline's
    current parameters (`neurad_tpu/scripts/viewer.py:24-57`). The virtual
    lidar sits 0.5 m above the mean train-camera position."""
    duration = pipeline.outputs.duration

    def render_fn(c2w, width, height, t01, edits=None):
        return pipeline.render_viewer_image(c2w, width, height, t01 * duration, edits_vec(edits))

    lidar_fn = None
    if hasattr(pipeline, "render_virtual_lidar"):

        def lidar_fn(t01, channels, azim_res, drop_threshold, edits=None):
            origin = pipeline.outputs.cameras.camera_to_worlds[:, :3, 3].cpu().numpy().mean(0)
            origin[2] += 0.5
            return pipeline.render_virtual_lidar(
                origin, t01 * duration,
                channels=channels, azim_res_deg=azim_res,
                drop_threshold=drop_threshold, edits_vec=edits_vec(edits),
            )

    return render_fn, lidar_fn


def serve_run(run_dir, port: int = 7007, device="cuda") -> Tuple[ViewerServer, Pipeline]:
    """A `ViewerServer` (not started) for the run directory's newest
    checkpoint, and the pipeline it renders."""
    from neurad_tpu_torch.scripts.train import load_run

    pipeline, _ = load_run(run_dir, device=resolve_device(device))
    keep_bf16_copies(pipeline.model)  # a NeuRAD model's grids: made at the first render
    render_fn, lidar_fn = viewer_fns(pipeline)
    return ViewerServer(render_fn, port=port, lidar_fn=lidar_fn), pipeline


def entrypoint(argv=None):
    parser = argparse.ArgumentParser(description="Interactive viewer for a neurad_tpu_torch run")
    parser.add_argument("run_dir")
    parser.add_argument("--port", type=int, default=7007)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    server, _ = serve_run(args.run_dir, port=args.port, device=device)
    server.start(background=False)


if __name__ == "__main__":
    entrypoint()
