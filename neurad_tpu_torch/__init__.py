"""PyTorch + CUDA port of `neurad_tpu` (the JAX package stays the reference).

Ported so far: the SplatAD serving path (closed-loop camera renders and lidar
scans) and SplatAD training (camera step, lidar step, MCMC and Default
densification, checkpoints, `scripts/train.py`), with the four tile composites
(camera and lidar, forward and fused backward) as hand-written Hopper kernels
(`ops/tile_composite.py`, `csrc/tile_composite.cu`, `csrc/tile_composite_bwd.cu`);
the NeuRAD serving path (full-image camera renders and lidar scans through
the hash-grid field, the closed-loop server's `--method neurad`) and NeuRAD
training (ray batches, losses, VGG, five Adam groups, checkpoints, the presets
of `configs/method_configs.py`), with the fused hash-grid lookup and its
backward as hand-written kernels (`ops/hash_encoding.py`, `csrc/hash_grid.cu`)
and three row-gather and three row-scatter probes
(`benchmarks/gather_microbench.py`, `csrc/gather_probes.cu`); eval and
metrics of both models (`eval_metrics`, the novel-view FID suite,
`utils/eval_metrics.py`, `scripts/eval.py`).
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
