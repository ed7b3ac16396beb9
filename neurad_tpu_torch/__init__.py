"""PyTorch + CUDA port of `neurad_tpu` (the JAX package stays the reference).

Ported: everything the JAX package does, bar what ROADMAP.md lists as not
to be ported. The SplatAD, NeuRAD, splatfacto and nerfacto models, their
training (`engine/trainer.py`, every preset of `configs/method_configs.py`),
serving (`scripts/closed_loop.py`), eval and metrics, render, export and the
viewer, the dataparsers of logged drives, and data-parallel training over
`torch.distributed` (`parallel/sharding.py`; the train script joins
torchrun's world or spawns one rank per visible GPU). The TPU kernels are
hand-written Hopper kernels: the four tile composites (camera and lidar,
forward and fused backward; `ops/tile_composite.py`, `csrc/tile_composite*.cu`),
the fused hash-grid lookup and its backward (`ops/hash_encoding.py`,
`csrc/hash_grid.cu`) and three row-gather and three row-scatter probes
(`benchmarks/gather_microbench.py`, `csrc/gather_probes.cu`). The library
modules that no path of the JAX package imports (pixel samplers, datasets,
renderers, colliders, the occupancy grid, the extra encodings, the NeuS
sampler) are ported too, and so is the generative guidance
(`generative/`: the SDS math and the view-conditioned prompt embeddings;
the Stable Diffusion backbone needs the optional `diffusers`).
`tests/test_torch_api_parity.py` holds the port's public names to the JAX
package's.
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
