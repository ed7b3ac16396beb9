"""Rules of the PyTorch port: it imports neither JAX, flax, optax nor the JAX
package, and its entry points run on CUDA unless the caller asks for the CPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import neurad_tpu_torch
from neurad_tpu_torch.configs.method_configs import neurad_tiny_overrides
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig
from neurad_tpu_torch.scripts import closed_loop, train
from neurad_tpu_torch.scripts import eval as eval_script

torch.set_num_threads(1)

PKG = Path(neurad_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "neurad_tpu")
# file-format libraries the dataparsers import inside the functions that read those formats
FORMAT_LIBS = ("pandas", "imageio", "pyarrow", "yaml", "zod")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], prefix="neurad_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "neurad_tpu_torch.scripts.closed_loop" in mods and "neurad_tpu_torch.ops.tile_composite" in mods
    assert {"neurad_tpu_torch.engine.optimizers", "neurad_tpu_torch.scripts.train",
            "neurad_tpu_torch.model_components.strategy"} <= set(mods)
    assert {"neurad_tpu_torch.ops.hash_encoding", "neurad_tpu_torch.ops.rendering",
            "neurad_tpu_torch.ops.spherical_harmonics", "neurad_tpu_torch.core.structs",
            "neurad_tpu_torch.core.math_utils", "neurad_tpu_torch.fields.activations",
            "neurad_tpu_torch.fields.spatial_distortions", "neurad_tpu_torch.fields.neurad_encoding",
            "neurad_tpu_torch.fields.neurad_field", "neurad_tpu_torch.model_components.ray_samplers",
            "neurad_tpu_torch.models.neurad", "neurad_tpu_torch.data.datamanager",
            "neurad_tpu_torch.pipelines.ad_pipeline", "neurad_tpu_torch.benchmarks.gather_microbench"} <= set(mods)
    assert {"neurad_tpu_torch.configs.method_configs", "neurad_tpu_torch.model_components.perceptual"} <= set(mods)
    assert {"neurad_tpu_torch.utils.eval_metrics", "neurad_tpu_torch.model_components.lpips_exact",
            "neurad_tpu_torch.model_components.inception", "neurad_tpu_torch.scripts.convert_perceptual_weights",
            "neurad_tpu_torch.scripts.eval"} <= set(mods)
    assert {"neurad_tpu_torch.data.png", "neurad_tpu_torch.data.native_ops",
            "neurad_tpu_torch.data.lidar_elevation_mappings", "neurad_tpu_torch.data.dataparsers.ad_dataparser",
            "neurad_tpu_torch.data.dataparsers.kitti", "neurad_tpu_torch.data.dataparsers.pandaset",
            "neurad_tpu_torch.data.dataparsers.nuscenes", "neurad_tpu_torch.data.dataparsers.argoverse2",
            "neurad_tpu_torch.data.dataparsers.waymo", "neurad_tpu_torch.data.dataparsers.zod",
            "neurad_tpu_torch.data.dataparsers.fixtures", "neurad_tpu_torch.models.splatfacto",
            "neurad_tpu_torch.pipelines.splatfacto_pipeline"} <= set(mods)
    assert {"neurad_tpu_torch.models.nerfacto", "neurad_tpu_torch.fields.encodings",
            "neurad_tpu_torch.fields.density_fields", "neurad_tpu_torch.fields.nerfacto_field",
            "neurad_tpu_torch.engine.trainer", "neurad_tpu_torch.engine.callbacks",
            "neurad_tpu_torch.utils.writer", "neurad_tpu_torch.utils.profiler",
            "neurad_tpu_torch.plugins.registry", "neurad_tpu_torch.configs.external_methods"} <= set(mods)
    assert {"neurad_tpu_torch.utils.colormaps", "neurad_tpu_torch.cameras.camera_utils",
            "neurad_tpu_torch.exporter.tsdf", "neurad_tpu_torch.exporter.poisson", "neurad_tpu_torch.scripts.render",
            "neurad_tpu_torch.scripts.export", "neurad_tpu_torch.viewer.server", "neurad_tpu_torch.scripts.viewer",
            "neurad_tpu_torch.process_data", "neurad_tpu_torch.process_data_converters"} <= set(mods)
    assert {"neurad_tpu_torch.parallel", "neurad_tpu_torch.parallel.sharding", "neurad_tpu_torch.data.pixel_samplers",
            "neurad_tpu_torch.data.data_utils", "neurad_tpu_torch.data.datasets",
            "neurad_tpu_torch.model_components.ray_generators", "neurad_tpu_torch.model_components.scene_colliders",
            "neurad_tpu_torch.model_components.occupancy_grid", "neurad_tpu_torch.model_components.renderers",
            "neurad_tpu_torch.fields.extra_encodings"} <= set(mods)
    assert {"neurad_tpu_torch.generative", "neurad_tpu_torch.generative.stable_diffusion",
            "neurad_tpu_torch.generative.positional_text_embeddings"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN + FORMAT_LIBS!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_file_imports_jax():
    """No `import x` / `from x import`, at any indentation, and no
    `importlib.import_module("x")` / `__import__("x")` of jax, flax, optax,
    orbax, chex or the JAX package, in the port or in chip_smoke.py."""
    assert {"jax", "flax", "optax", "neurad_tpu"} <= set(FORBIDDEN)
    static = re.compile(r"^\s*(?:import|from)\s+(\w+)", re.MULTILINE)
    dynamic = re.compile(r"(?:import_module|__import__)\(\s*[\"'](\w+)")
    paths = list(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(paths) > 45 and PKG / "benchmarks" / "gather_microbench.py" in paths
    for path in paths:
        text = path.read_text()
        roots = set(static.findall(text)) | set(dynamic.findall(text))
        assert not roots & set(FORBIDDEN), f"{path} imports {roots & set(FORBIDDEN)}"
    # the card's machine has none of the file-format libraries: chip_smoke.py reaches none on any path
    smoke = (PKG.parent / "chip_smoke.py").read_text()
    roots = set(static.findall(smoke)) | set(dynamic.findall(smoke))
    assert not roots & set(FORMAT_LIBS), f"chip_smoke.py imports {roots & set(FORMAT_LIBS)}"


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    outputs = SyntheticDataParserConfig(num_frames=2, image_height=16, image_width=24).setup().get_dataparser_outputs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SplatADPipeline(outputs, SplatADPipelineConfig(cap_max=500))
    pipeline = SplatADPipeline(outputs, SplatADPipelineConfig(cap_max=500), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        closed_loop.ClosedLoopState(pipeline)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        closed_loop.entrypoint(["--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.entrypoint(["splatad-tiny", "--max-iterations", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        closed_loop.ClosedLoopState.from_run_dir("no-such-run")  # refused before the run is read
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_script.entrypoint(["no-such-run"])  # refused before the run is read
    assert closed_loop.ClosedLoopState(pipeline, device="cpu").pipeline is pipeline


def test_train_and_run_dir_entry_points_need_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    argv = ["splatad-tiny", "--max-iterations", "1", "--output-dir", str(tmp_path), "--experiment-name", "r"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.entrypoint(argv)
    assert not (tmp_path / "r").exists(), "refused before anything was written"
    pipeline, state = train.entrypoint(argv + ["--device", "cpu"])
    assert state.step == 1 and pipeline.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        closed_loop.ClosedLoopState.from_run_dir(tmp_path / "r")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.load_run(tmp_path / "r")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        closed_loop.entrypoint(["--port", "0", "--load-dir", str(tmp_path / "r")])
    assert closed_loop.ClosedLoopState.from_run_dir(tmp_path / "r", device="cpu").pipeline.device.type == "cpu"


def test_render_export_viewer_and_process_data_need_cuda_unless_asked_for_cpu(tmp_path):
    """The slice-10 entry points refuse without CUDA before they read
    anything, unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from neurad_tpu_torch import process_data
    from neurad_tpu_torch.scripts import export, render, viewer

    for refused in (lambda: render.entrypoint(["no-such-run"]), lambda: export.entrypoint(["pointcloud", "no-such-run"]),
                    lambda: viewer.entrypoint(["no-such-run", "--port", "0"]),
                    lambda: viewer.serve_run("no-such-run", port=0),
                    lambda: process_data.entrypoint(["transforms", "no-such.json"]),
                    lambda: process_data.load_transforms_json("no-such.json")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            refused()
    with pytest.raises(FileNotFoundError):  # asked for the CPU, it goes on to read the run
        render.entrypoint([str(tmp_path / "no-such-run"), "--device", "cpu"])


def test_neurad_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from neurad_tpu_torch.benchmarks import gather_microbench
    from neurad_tpu_torch.data.datamanager import ADDataManager
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline, ADPipelineConfig

    outputs = SyntheticDataParserConfig(num_frames=2, image_height=12, image_width=18, lidar_channels=4,
                                        lidar_azimuths=12).setup().get_dataparser_outputs()
    cfg = ADPipelineConfig(model_overrides=neurad_tiny_overrides())
    for refused in (lambda: ADPipeline(outputs, cfg), lambda: ADDataManager(outputs),
                    lambda: closed_loop.build_state("neurad-tiny", outputs=outputs),
                    lambda: closed_loop.entrypoint(["--port", "0", "--method", "neurad-tiny"]),
                    lambda: gather_microbench.run(queries=8), lambda: gather_microbench.entrypoint(["--queries", "8"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            refused()
    pipeline = ADPipeline(outputs, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        closed_loop.ClosedLoopState(pipeline)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ADPipeline(outputs, ADPipelineConfig(model="nerfacto"))
    with pytest.raises(NotImplementedError, match="cannot evaluate"):  # as in the JAX package, which fails there
        ADPipeline(outputs, ADPipelineConfig(model="nerfacto"), device="cpu").eval_metrics()
    with pytest.raises(ValueError, match="unknown model"):
        ADPipeline(outputs, ADPipelineConfig(model="no-such-model"), device="cpu")
    state, port = closed_loop.state_from_args(["--port", "0", "--method", "neurad-tiny", "--device", "cpu", "--seed", "3"])
    assert port == 0
    assert state.pipeline.device.type == "cpu" and state.pipeline.config.seed == 3
    image = state.render_image(torch.eye(4).tolist(), 0.5, "front_camera")
    assert image.shape == (48, 72, 3)
    # the seed decides the weights
    again = closed_loop.build_state("neurad-tiny", device="cpu", seed=3).pipeline.model.state_dict()
    other = closed_loop.build_state("neurad-tiny", device="cpu", seed=4).pipeline.model.state_dict()
    mine = state.pipeline.model.state_dict()
    assert all(torch.equal(mine[k], again[k]) for k in mine)
    assert any(not torch.equal(mine[k], other[k]) for k in mine if "hash_table" in k)
    assert not any(k.count("actors.") > 1 or ".hashgrid.actors." in k for k in mine), "actors are registered once"


def test_neurad_train_entry_points_need_cuda_unless_asked_for_cpu(tmp_path):
    """The NeuRAD train path: the train script, `load_run` and the server of a
    NeuRAD run refuse without CUDA unless asked for the CPU; the backward of
    a lookup on CPU tensors is the plain version (no kernel launch)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from neurad_tpu_torch.model_components.perceptual import load_vgg19_params
    from neurad_tpu_torch.ops import hash_encoding as HE

    argv = ["neurad-tiny", "--max-iterations", "1", "--output-dir", str(tmp_path), "--experiment-name", "r",
            "--dp-set", "num_frames=2", "--dp-set", "image_height=18", "--dp-set", "image_width=24"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.entrypoint(argv)
    assert not (tmp_path / "r").exists(), "refused before anything was written"
    HE.reset_launch_counts()
    pipeline, state = train.entrypoint(argv + ["--device", "cpu"])
    assert state.step == 1 and pipeline.device.type == "cpu" and pipeline.datamanager.device.type == "cpu"
    assert (HE.hash_grid_launches, HE.hash_grid_bwd_launches) == (0, 0)
    for refused in (lambda: train.load_run(tmp_path / "r"), lambda: closed_loop.ClosedLoopState.from_run_dir(tmp_path / "r"),
                    lambda: closed_loop.entrypoint(["--port", "0", "--load-dir", str(tmp_path / "r")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            refused()
    assert closed_loop.ClosedLoopState.from_run_dir(tmp_path / "r", device="cpu").pipeline.device.type == "cpu"
    assert next(load_vgg19_params().parameters()).device.type == "cpu"


def test_data_parallel_ranks_need_their_device_unless_asked_for_cpu(tmp_path, monkeypatch):
    """The train script's ranks run on `cuda:<LOCAL_RANK>` unless asked for
    the CPU: under torchrun's environment it refuses without CUDA before it
    joins the world or writes anything, `--multihost` refuses without that
    environment, a world over several hosts refuses without `--multihost`
    (JAX's meaning), and a local rank beyond the visible GPUs raises (the caller
    passing a device, as a gloo world of ranks on one GPU does, is the
    exception). Nothing here starts a world."""
    from neurad_tpu_torch.parallel import sharding

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    argv = ["splatad-tiny", "--max-iterations", "1", "--output-dir", str(tmp_path), "--experiment-name", "r"]
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        train.entrypoint(argv + ["--multihost", "--device", "cpu"])
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="spans several hosts.*--multihost"):
        train.entrypoint(argv + ["--device", "cpu"])
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.entrypoint(argv)
    with pytest.raises(SystemExit, match="--no-mesh"):
        train.entrypoint(argv + ["--no-mesh", "--device", "cpu"])
    assert not (tmp_path / "r").exists(), "refused before anything was written"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharding.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="local rank 1 has no GPU: 1 visible"):
        sharding.make_mesh()
    assert not torch.distributed.is_initialized()
