"""Build and load the port's CUDA kernels.

Each source under `neurad_tpu_torch/csrc/` is compiled at first use with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared` into a shared library
with a plain C interface, loaded with ctypes. Libraries land in
`neurad_tpu_torch/_build/` under a name that carries the hash of the source
and of the headers (`*.cuh`) beside it, so an edited source is rebuilt and an
unchanged one is reused. `build_all()` starts
one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# library name -> (source file, {C function: argument types})
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
LIBRARIES = {
    "tile_composite": (
        "tile_composite.cu",
        {
            "tile_composite_camera_fwd": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
            "tile_composite_lidar_fwd": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P],
        },
    ),
    "tile_composite_bwd": (
        "tile_composite_bwd.cu",
        {
            "tile_composite_camera_bwd": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
            "tile_composite_lidar_bwd": [
                _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            ],
        },
    ),
    "hash_grid": (
        "hash_grid.cu",
        {
            "hash_grid_fwd": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P],
            "hash_grid_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
        },
    ),
    "gather_probes": (
        "gather_probes.cu",
        {
            "gather_rows_coalesced": [_P, _P, _P, _L, _I, _I, _P],
            "onehot_scratch_ints": [_L, _I],
            "gather_rows_onehot": [_P, _P, _P, _L, _I, _I, _P, _P],
            "gather_rows_serial": [_P, _P, _P, _L, _I, _I, _P],
            "scatter_rows_onehot": [_P, _P, _P, _L, _I, _I, _P, _P],
            "scatter_rows_blocked": [_P, _P, _P, _L, _I, _I, _P, _P],
            "scatter_rows_serial": [_P, _P, _P, _L, _I, _I, _P],
        },
    ),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return str(cand)


def library_path(name: str) -> Path:
    src = CSRC / LIBRARIES[name][0]
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> Dict[str, Path]:
    """Compile every library that is missing, one nvcc each, in parallel.
    Raises with the compiler's output if any build fails. ptxas's register and
    shared-memory report goes to `_build/<name>.log`."""
    names = list(LIBRARIES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas=-v",
            "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(CSRC / LIBRARIES[name][0]),
        ]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    errors = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library `name`, with every C function's argtypes declared."""
    with _lock:
        if name not in _loaded:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in LIBRARIES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]
