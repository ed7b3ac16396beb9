"""Rules of the PyTorch port: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import neurad_tpu_torch
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig
from neurad_tpu_torch.scripts import closed_loop

torch.set_num_threads(1)

PKG = Path(neurad_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "neurad_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], prefix="neurad_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "neurad_tpu_torch.scripts.closed_loop" in mods and "neurad_tpu_torch.ops.tile_composite" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(?:import|from)\s+(\w+)", re.MULTILINE)
    for path in PKG.rglob("*.py"):
        roots = set(pattern.findall(path.read_text()))
        assert not roots & set(FORBIDDEN), f"{path} imports {roots & set(FORBIDDEN)}"


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
    assert closed_loop.ClosedLoopState(pipeline, device="cpu").pipeline is pipeline
