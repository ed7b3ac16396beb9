"""PyTorch + CUDA port of `neurad_tpu` (the JAX package stays the reference).

Ported so far: the SplatAD serving path (closed-loop camera renders and lidar
scans) and SplatAD training (camera step, lidar step, MCMC and Default
densification, checkpoints, `scripts/train.py`), with the four tile composites
(camera and lidar, forward and fused backward) as hand-written Hopper kernels
(`ops/tile_composite.py`, `csrc/tile_composite.cu`, `csrc/tile_composite_bwd.cu`).
The module layout mirrors `neurad_tpu/` so each counterpart is easy to find.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; a missing card
    raises instead of falling back to the CPU, which runs only when asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
