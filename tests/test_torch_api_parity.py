"""The port offers every public name of the JAX package.

The test parses both packages with `ast` (it imports neither, so it runs no
JAX and takes well under a second). A public name is a module-level function,
class or UPPER_CASE constant whose name does not start with "_", or a public
method of such a class. Each must have a counterpart of the same name in the
port's module of the same relative path, unless one of two tables says
otherwise:

- `MOVED`: the port has it under another module or name (the table names
  where; the test checks that the target exists);
- `NOT_PORTED`: the port has no counterpart, for the reason given (the same
  reasons as `ROADMAP.md` §1 "Not to be ported").

A public name added to the JAX package, or one removed from the port, fails
the test until it is ported or listed.
"""

import ast
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "neurad_tpu"
PORT_PKG = ROOT / "neurad_tpu_torch"

# flax builds a module's submodules in `setup`; a torch module builds them in `__init__`
_FLAX_SETUP = {
    f"{module}:{cls}.setup": (module, f"{cls}.__init__")
    for module, cls in (
        ("cameras/camera_optimizers.py", "CameraOptimizer"),
        ("cameras/camera_optimizers.py", "CameraVelocityOptimizer"),
        ("fields/density_fields.py", "HashMLPDensityField"),
        ("fields/encodings.py", "HashEncoding"),
        ("fields/nerfacto_field.py", "NerfactoField"),
        ("fields/neurad_encoding.py", "NeuRADHashEncoding"),
        ("fields/neurad_field.py", "MLPProposalField"),
        ("fields/neurad_field.py", "NeuRADField"),
        ("fields/neurad_field.py", "NeuRADProposalField"),
        ("model_components/dynamic_actors.py", "DynamicActors"),
        ("models/nerfacto.py", "NerfactoModel"),
        ("models/neurad.py", "NeuRADModel"),
        ("models/splatad.py", "SplatADModel"),
        ("models/splatfacto.py", "SplatfactoModel"),
    )
}

# "jax module:name" -> (port module, name)
MOVED = {
    **_FLAX_SETUP,
    "engine/optimizers.py:build_optimizer": ("engine/optimizers.py", "Optimizers"),
    "engine/trainer.py:TrainState": ("pipelines/ad_pipeline.py", "TrainState"),
    "engine/trainer.py:make_train_step": ("pipelines/ad_pipeline.py", "ADPipeline.train_step"),
    "pipelines/ad_pipeline.py:ADPipeline.make_train_step": ("pipelines/ad_pipeline.py", "ADPipeline.train_step"),
    "parallel/sharding.py:make_sharded_train_step": ("pipelines/ad_pipeline.py", "ADPipeline.make_sharded_train_step"),
    "models/splatad.py:SplatADModel.init_all": ("models/splatad.py", "SplatADModel.__init__"),
    "model_components/perceptual.py:vgg19_slices_apply": ("model_components/perceptual.py", "Vgg19Slices.forward"),
    "native/__init__.py:bin_points": ("data/native_ops.py", "bin_points"),
    "native/__init__.py:extract_patches": ("data/datamanager.py", "extract_patches"),
    "ops/pallas_composite.py:pallas_tile_composite": ("ops/tile_composite.py", "tile_composite_camera"),
    "ops/pallas_composite.py:run_lidar_fwd": ("ops/tile_composite.py", "tile_composite_lidar"),
    "ops/pallas_composite.py:run_lidar_bwd": ("ops/tile_composite.py", "TileCompositeLidar.backward"),
    "scripts/eval.py:load_run": ("scripts/train.py", "load_run"),
}

_TPU_FAST_PATH = "TPU fast paths; the port gathers"
_TREE_HELPERS = "pytree helpers of flax structs; `map_tensors` does their work"
_TABLE_LAYOUT = "TPU orders of the backward's sum and an XLA layout repair; the JAX defaults do not use them"
_FETCHES = "it fetches datasets; nothing is downloaded"

# "jax module:name" -> reason
NOT_PORTED = {
    "core/math_utils.py:searchsorted_dense": _TPU_FAST_PATH,
    "core/math_utils.py:take_along_small": _TPU_FAST_PATH,
    "core/structs.py:tree_cat": _TREE_HELPERS,
    "core/structs.py:tree_flatten_batch": _TREE_HELPERS,
    "core/structs.py:tree_getitem": _TREE_HELPERS,
    "core/structs.py:tree_reshape": _TREE_HELPERS,
    "core/structs.py:tree_size": _TREE_HELPERS,
    "ops/chunking.py:chunked_map": "the port's chunk loops are Python loops",
    "ops/hash_encoding.py:HashEncodingSpec": "no path builds one",
    "ops/hash_encoding.py:HashEncodingSpec.init": "no path builds one",
    "ops/hash_encoding.py:HashEncodingSpec.out_dim": "no path builds one",
    "ops/hash_encoding.py:flatten_tables": _TABLE_LAYOUT,
    "ops/hash_encoding.py:unflatten_tables": _TABLE_LAYOUT,
    "ops/pallas_composite.py:hybrid_tile_composite": "XLA's bf16 composite, a TPU trade-off",
    "scripts/download_data.py:DATASETS": _FETCHES,
    "scripts/download_data.py:entrypoint": _FETCHES,
    "scripts/download_data.py:validate": _FETCHES,
}


def _is_constant(name: str) -> bool:
    return name.isupper() and not name.startswith("_")


def public_names(pkg: Path) -> dict:
    """{relative module path: set of public names} of every module of `pkg`;
    a method is "Class.method", a class's `__init__` is listed as such."""
    out = {}
    for path in sorted(pkg.rglob("*.py")):
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
                names.add(node.name)
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                names.add(node.name)
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                            not sub.name.startswith("_") or sub.name == "__init__"):
                        names.add(f"{node.name}.{sub.name}")
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                names |= {t.id for t in targets if isinstance(t, ast.Name) and _is_constant(t.id)}
        out[path.relative_to(pkg).as_posix()] = names
    return out


@pytest.fixture(scope="module")
def packages():
    return public_names(JAX_PKG), public_names(PORT_PKG)


def _jax_public(jax_names: dict) -> set:
    """Every public name of the JAX package as "module:name" (a class's
    `__init__` is not a name to port: its counterpart is the class)."""
    return {f"{m}:{n}" for m, names in jax_names.items() for n in names if not n.endswith(".__init__")}


def test_every_public_name_of_the_jax_package_has_a_counterpart(packages):
    jax_names, port_names = packages
    missing = []
    for key in sorted(_jax_public(jax_names)):
        module, name = key.split(":")
        if key in MOVED or key in NOT_PORTED:
            continue
        if name not in port_names.get(module, set()):
            missing.append(key)
    assert not missing, f"public names of neurad_tpu with no counterpart in neurad_tpu_torch: {missing}"


def test_moved_names_exist_in_the_port(packages):
    jax_names, port_names = packages
    jax_public = _jax_public(jax_names)
    for key, (module, name) in sorted(MOVED.items()):
        assert key in jax_public, f"MOVED lists {key}, which the JAX package no longer has"
        assert name in port_names.get(module, set()), f"{key} moved to {module}:{name}, which does not exist"


def test_not_ported_names_are_real_and_absent_from_the_port(packages):
    """Each NOT_PORTED entry names a public name the JAX package has and the
    port has not (a name that gets ported leaves the table), with a reason."""
    jax_names, port_names = packages
    jax_public = _jax_public(jax_names)
    for key, reason in sorted(NOT_PORTED.items()):
        module, name = key.split(":")
        assert key in jax_public, f"NOT_PORTED lists {key}, which the JAX package no longer has"
        assert name not in port_names.get(module, set()), f"{key} is ported: take it out of NOT_PORTED"
        assert reason.strip(), key
    assert not set(MOVED) & set(NOT_PORTED)


def test_the_walk_sees_the_names_of_this_slice(packages):
    """The walk itself: it finds the methods, constants and classes that the
    last slice ported, in both packages."""
    jax_names, port_names = packages
    expected = {
        "generative/stable_diffusion.py": {"IMG_DIM", "CONST_SCALE", "SD_IDENTIFIERS", "sds_loss", "add_noise",
                                           "StableDiffusionGuidance.sds_loss_for_image"},
        "generative/positional_text_embeddings.py": {"PositionalTextEmbeddings"},
        "model_components/cnns.py": {"BottleneckBlock", "BasicBlock"},
        "core/scene_box.py": {"OrientedBox", "OrientedBox.within", "SceneBox.within"},
        "core/poses.py": {"inverse", "normalize", "rotation_difference", "transform_points"},
        "core/structs.py": {"Frustums.get_start_positions", "RayBundle.reshape", "RayBundle.flatten"},
        "configs/method_configs.py": {"MethodConfig.build_pipeline", "all_methods"},
        "engine/optimizers.py": {"learning_rates_at"},
        "models/neurad.py": {"NeuRADModel.num_proposal_rounds"},
    }
    for module, names in expected.items():
        assert names <= jax_names[module], (module, names - jax_names[module])
        assert names <= port_names[module], (module, names - port_names[module])
    assert len(_jax_public(jax_names)) > 500
