"""Data-parallel training over `torch.distributed` (torch port of
`neurad_tpu/parallel/sharding.py`).

The JAX package runs one process per host with a jit over its device mesh;
PyTorch's idiom is one process per GPU, a rank. The ranks keep the JAX
package's multi-host semantics, which are also nerfstudio's DDP semantics:

- parameters and optimizer state are replicated: `replicate` broadcasts rank
  0's and checks that every rank holds the same bits;
- each rank trains on its own share of the batch, and the gradients are
  averaged over the ranks before every optimizer update
  (`all_reduce_gradients`: flat buckets in a fixed order over every optimizer
  group, summed, then divided by the world size; JAX's psum);
- a NeuRAD rank samples its own full ray batch, seeded `host_local_seed`, and
  the loss is the loss of the global batch `[cam_0 .. cam_{w-1} | lidar_0 ..
  lidar_{w-1}]` (`train_batch_rows` places a rank's rows in it);
- a SplatAD or splatfacto rank takes sample `rank` of one list drawn from a
  generator that every rank holds alike.

Every collective here is built from `broadcast` and `all_reduce`, the two that
torch's documentation lists for gloo on CUDA tensors as well as for NCCL: a
gather is an all-reduce (sum) of a zero-filled buffer that each rank fills with
its own block. So the same code runs on NCCL (one rank a GPU) and on gloo (the
CPU, or several ranks on one GPU, which NCCL refuses).

The reduce is explicit, after the step's backward, rather than a
`DistributedDataParallel` wrapper: a step calls several model methods, and a
SplatAD step leaves the other modality's parameters without gradients, which
`Optimizers.step` fills with zeros anyway. Nothing falls back: a collective
that fails raises, a rank whose device does not exist raises, and a rank that
falls out of step (another modality, other parameters) raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from neurad_tpu_torch.model_components.losses import masked_quantile

# elements of one flat gradient bucket (fp32: 100 MiB)
BUCKET_ELEMS = 1 << 25


@dataclasses.dataclass
class Mesh:
    """A data-parallel world as one rank sees it: the process group (None:
    the default group), this rank, the world size, this rank's device and the
    backend."""

    group: Optional[Any]
    rank: int
    world_size: int
    device: torch.device
    backend: str


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None or value == "" else int(value)


def in_launched_world() -> bool:
    """Whether the process was started by a launcher (torchrun) that describes
    a world in the environment."""
    return _env_int("RANK") is not None and _env_int("WORLD_SIZE") is not None


def spans_hosts() -> bool:
    """Whether torchrun's world has ranks on other hosts than this one (more
    ranks in the world than `LOCAL_WORLD_SIZE` here)."""
    world, local = _env_int("WORLD_SIZE"), _env_int("LOCAL_WORLD_SIZE")
    return world is not None and local is not None and world > local


def make_mesh(device=None, rank: Optional[int] = None, world_size: Optional[int] = None,
              init_method: Optional[str] = None, backend: Optional[str] = None) -> Mesh:
    """Join (or start) a data-parallel world and describe it.

    Without arguments the world is torchrun's (`RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`), or a world of one on a free
    local port when the environment names none. An initialized default group
    is taken as it is. The device is `cuda:<LOCAL_RANK>` unless the caller
    passes one: a local rank beyond the visible GPUs raises, and so does a
    machine without CUDA. The backend is NCCL on CUDA and gloo on the CPU
    unless given (gloo on CUDA tensors runs several ranks on one GPU)."""
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        env_rank, env_world = _env_int("RANK"), _env_int("WORLD_SIZE")
        if rank is None:
            rank = env_rank if env_rank is not None else 0
        if world_size is None:
            world_size = env_world if env_world is not None else 1
        if init_method is None:
            if env_world is not None:
                init_method = "env://"
            elif world_size == 1:
                init_method = f"tcp://127.0.0.1:{free_port()}"
            else:
                raise ValueError("a world of more than one rank needs an init_method or torchrun's environment")
    if device is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank} has no GPU: {torch.cuda.device_count()} visible")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return Mesh(group=None, rank=rank, world_size=world_size, device=device, backend=dist.get_backend())


def host_local_seed(seed: int, rank: int) -> int:
    """A rank's sampler seed: each rank samples different rays (its share of
    the global batch) while the model's seeds stay the same on every rank
    (nerfstudio's `seed + global_rank`)."""
    return seed + 7919 * rank


# ----------------------------------------------------------------------------
# the two collectives, on the mesh's device
# ----------------------------------------------------------------------------


def _on_device(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """`t` where the backend can reduce it: NCCL takes CUDA tensors only."""
    if mesh.backend == "nccl" and t.device.type != "cuda":
        return t.to(mesh.device)
    return t


def all_reduce_(mesh: Mesh, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t`."""
    work = _on_device(mesh, t)
    dist.all_reduce(work, op=op, group=mesh.group)
    if work is not t:
        t.copy_(work)
    return t


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """In-place broadcast of rank `src`'s `t`."""
    work = _on_device(mesh, t)
    dist.broadcast(work, src=src, group=mesh.group)
    if work is not t:
        t.copy_(work)
    return t


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes the run's files: one process, or rank 0."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (an all-reduce of one number)."""
    all_reduce_(mesh, torch.zeros(1, device=mesh.device))


def same_on_every_rank(mesh: Mesh, value: float, what: str) -> None:
    """Raise unless every rank passes the same number (the ranks would
    otherwise fall out of step: another modality, another image shape)."""
    t = torch.tensor([value, -value], dtype=torch.float64, device=mesh.device)
    all_reduce_(mesh, t, op=dist.ReduceOp.MAX)
    if float(t[0]) != value or float(-t[1]) != value:
        raise RuntimeError(f"the ranks are out of step: {what} differs (rank {mesh.rank}: {value})")


# ----------------------------------------------------------------------------
# gathers: an all-reduce of a zero-filled buffer, each rank filling its block
# ----------------------------------------------------------------------------


def gather_rows(mesh: Mesh, local: torch.Tensor, rows: torch.Tensor, n_global: int) -> torch.Tensor:
    """The global [n_global, ...] tensor whose `rows` are each rank's `local`
    rows (no autograd; bool tensors travel as int32)."""
    dtype = torch.int32 if local.dtype == torch.bool else local.dtype
    buf = torch.zeros((n_global,) + tuple(local.shape[1:]), dtype=dtype, device=local.device)
    buf[rows.to(local.device)] = local.to(dtype)
    all_reduce_(mesh, buf)
    return buf.to(local.dtype) if dtype != local.dtype else buf


class _GatherRows(torch.autograd.Function):
    """`gather_rows` with a backward: every rank computes the same loss of the
    global tensor, so a rank's rows take the global gradient of its own rows,
    times the world size, which `all_reduce_gradients`' division undoes."""

    @staticmethod
    def forward(ctx, local, rows, n_global, mesh):
        ctx.rows, ctx.world = rows, mesh.world_size
        return gather_rows(mesh, local, rows, n_global)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows.to(grad.device)] * ctx.world, None, None, None


def gather_rows_with_grad(mesh: Mesh, local: torch.Tensor, rows: torch.Tensor, n_global: int) -> torch.Tensor:
    return _GatherRows.apply(local, rows, n_global, mesh)


class _SumOverRanks(torch.autograd.Function):
    """An all-reduce (sum) whose backward is one too: a rank's part takes
    the sum of every rank's gradient of the sum. Where every rank scores the
    sum alike (a loss term) that is the world size times its gradient, which
    `all_reduce_gradients`' division undoes; where each rank uses it on its
    own rows (a batch norm's statistics) it gathers what every rank's rows
    owe it, as a synchronised batch norm does."""

    @staticmethod
    def forward(ctx, local, mesh):
        ctx.mesh = mesh
        return all_reduce_(mesh, local.detach().clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(ctx.mesh, grad.contiguous().clone()), None


def sum_over_ranks(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    return _SumOverRanks.apply(local, mesh)


class GlobalBatchTerms:
    """A NeuRAD loss's terms over a world's global batch, each rank reducing
    its own rows (`models/neurad.py`'s `compute_losses`; the one-process
    reductions are `losses.BatchTerms`). A mean over rows whose count is
    equal on every rank (camera patches, lidar rays) is the mean of the
    ranks' means; a masked mean sums the numerators and the counts over the
    ranks (the valid lidar returns differ by rank); a quantile gathers the
    values in the global batch's order (its threshold takes no gradient).
    Every rank gets the same value, and its rows take the value's gradient
    times the world size (`sum_over_ranks`), so that the averaged parameter
    gradients are the global batch's. In a world of one each term is the
    one-process term bit for bit."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def of_mean(self, value: torch.Tensor) -> torch.Tensor:
        return sum_over_ranks(self.mesh, value) / self.mesh.world_size

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return self.of_mean(torch.mean(x))

    def ratio(self, total: torch.Tensor, count: float) -> torch.Tensor:
        return sum_over_ranks(self.mesh, total) / (count * self.mesh.world_size)

    def masked_mean(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        denom = sum_over_ranks(self.mesh, mask.sum()).clamp_min(1.0)
        return sum_over_ranks(self.mesh, torch.where(mask, x, torch.zeros_like(x)).sum()) / denom

    def masked_quantile(self, x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
        n, mesh = x.shape[0], self.mesh
        rows = torch.arange(mesh.rank * n, (mesh.rank + 1) * n)
        return masked_quantile(gather_rows(mesh, x.detach(), rows, n * mesh.world_size),
                               gather_rows(mesh, mask, rows, n * mesh.world_size), q)

    def psnr(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        return 10.0 * torch.log10(1.0 / self.mean((pred - gt) ** 2).clamp_min(1e-12))


def train_batch_rows(rank: int, world_size: int, num_cam_rays: int, num_lidar_rays: int) -> torch.Tensor:
    """The rows of rank `rank`'s `[cam_r | lidar_r]` batch in the global train
    batch `[cam_0 .. cam_{w-1} | lidar_0 .. lidar_{w-1}]` (the layout of the
    JAX package's `assemble_global_train_batch`)."""
    cam = torch.arange(rank * num_cam_rays, (rank + 1) * num_cam_rays)
    lidar = world_size * num_cam_rays + torch.arange(rank * num_lidar_rays, (rank + 1) * num_lidar_rays)
    return torch.cat([cam, lidar])


def assemble_global_train_batch(mesh: Mesh, bundle, batch: Dict[str, torch.Tensor], num_cam_rays: int):
    """The global structured train batch from every rank's local one: the
    bundle's mixed-modality leaves in the `[all cam | all lidar]` layout, the
    ground truth's single-modality leaves (image patches, lidar returns) as
    rank blocks."""
    from neurad_tpu_torch.core.structs import map_tensors

    n_local = bundle.origins.shape[0]
    rows = train_batch_rows(mesh.rank, mesh.world_size, num_cam_rays, n_local - num_cam_rays)
    n_global = n_local * mesh.world_size
    return map_tensors(lambda x: gather_rows(mesh, x, rows, n_global), bundle), gather_blocks(mesh, batch)


def gather_blocks(mesh: Mesh, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every rank's leaves concatenated in rank order (single-modality rows:
    image patches, lidar returns)."""
    def cat(v):
        n = v.shape[0]
        return gather_rows(mesh, v, torch.arange(mesh.rank * n, (mesh.rank + 1) * n), n * mesh.world_size)

    return {k: cat(v) for k, v in tree.items()}


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous row block of every leaf of a host-identical
    tree (arrays, tensors, dicts, lists) whose leading dimension the world
    size divides; other leaves stay whole (the JAX package replicates them)."""
    def take(x):
        n = x.shape[0] if getattr(x, "ndim", 0) else 0
        if n == 0 or n % mesh.world_size:
            return x
        per = n // mesh.world_size
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return take(tree)
    return tree


def gather_objects(mesh: Mesh, obj) -> List[Any]:
    """Every rank's JSON-serialisable `obj`, in rank order."""
    data = json.dumps(obj, default=int).encode()
    size = torch.tensor([len(data)], dtype=torch.int64, device=mesh.device)
    all_reduce_(mesh, size, op=dist.ReduceOp.MAX)
    buf = torch.zeros((mesh.world_size, int(size)), dtype=torch.int32, device=mesh.device)
    buf[mesh.rank, :len(data)] = torch.tensor(list(data), dtype=torch.int32, device=mesh.device)
    all_reduce_(mesh, buf)
    rows = buf.cpu().numpy().astype(np.uint8)
    return [json.loads(bytes(r).rstrip(b"\0").decode()) for r in rows]


def broadcast_object(mesh: Mesh, obj, src: int = 0):
    """Rank `src`'s JSON-serialisable `obj` on every rank."""
    return gather_objects(mesh, obj if mesh.rank == src else None)[src]


# ----------------------------------------------------------------------------
# replicated parameters and averaged gradients
# ----------------------------------------------------------------------------


def _fingerprint(t: torch.Tensor) -> torch.Tensor:
    """An int64 hash of a tensor's bits (a sum of the bits weighted by
    position): equal tensors give equal hashes, and any flipped bit changes it."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.dtype == torch.bool:
        bits = flat.to(torch.int64)
    elif flat.element_size() == 8:
        bits = flat.view(torch.int64)
    elif flat.element_size() == 4:
        bits = flat.view(torch.int32).to(torch.int64)
    elif flat.element_size() == 2:
        bits = flat.view(torch.int16).to(torch.int64)
    else:
        bits = flat.view(torch.uint8).to(torch.int64)
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    step = 1 << 24
    for start in range(0, bits.numel(), step):
        idx = torch.arange(start, min(start + step, bits.numel()), device=flat.device, dtype=torch.int64)
        total += (bits[start:start + step] * ((idx * 2654435761) % 2147483647 + 1)).sum()
    return total


def check_replicated(mesh: Mesh, tensors: Sequence[torch.Tensor], what: str = "parameters") -> None:
    """Raise unless every rank holds the same bits in every tensor."""
    if mesh.world_size == 1:
        return
    prints = torch.stack([_fingerprint(t).to(mesh.device) for t in tensors]) if tensors else \
        torch.zeros(1, dtype=torch.int64, device=mesh.device)
    hi, lo = prints.clone(), -prints
    all_reduce_(mesh, hi, op=dist.ReduceOp.MAX)
    all_reduce_(mesh, lo, op=dist.ReduceOp.MAX)
    bad = torch.nonzero((hi != prints) | (-lo != prints)).reshape(-1).tolist()
    if bad:
        raise RuntimeError(f"the ranks hold different {what}: {len(bad)} of {len(tensors)} tensors differ")


def optimizer_tensors(optimizers) -> List[torch.Tensor]:
    """The optimizer state's tensors (moments, step counts, accumulators) of
    an `Optimizers`, in a fixed order."""
    out = []
    for g, opt in optimizers.optimizers.items():
        for p in optimizers.params[g]:
            state = opt.state.get(p, {})
            out.extend(state[k] for k in sorted(state) if torch.is_tensor(state[k]))
        out.extend(optimizers.accum.get(g, []))
    return out


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module, optimizers=None) -> None:
    """Broadcast rank 0's parameters and buffers (and, given, the optimizer
    state) to every rank, then check that the ranks agree."""
    tensors = [p.data for p in module.parameters()] + list(module.buffers())
    if optimizers is not None:
        tensors += optimizer_tensors(optimizers)
    if mesh.world_size > 1:
        for t in tensors:
            broadcast_(mesh, t)
    check_replicated(mesh, tensors)


@torch.no_grad()
def all_reduce_gradients(mesh: Mesh, params: Iterable[torch.nn.Parameter], bucket_elems: int = BUCKET_ELEMS) -> None:
    """Average the parameters' gradients over the ranks: a missing gradient
    becomes zeros (as `Optimizers.step` would make it), the gradients go into
    flat buckets of one dtype in the order given, each bucket is summed over
    the ranks and divided by the world size, and the result is copied back."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    bucket: List[torch.nn.Parameter] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if bucket:
            flat = torch.cat([p.grad.reshape(-1) for p in bucket])
            all_reduce_(mesh, flat)
            flat /= mesh.world_size
            start = 0
            for p in bucket:
                n = p.grad.numel()
                p.grad.copy_(flat[start:start + n].view_as(p.grad))
                start += n
        bucket, size = [], 0

    for p in params:
        if bucket and (p.grad.dtype != bucket[0].grad.dtype or p.grad.device != bucket[0].grad.device
                       or size + p.grad.numel() > bucket_elems):
            flush()
        bucket.append(p)
        size += p.grad.numel()
    flush()


def optimizer_params(optimizers) -> List[torch.nn.Parameter]:
    """Every parameter of an `Optimizers`, group by group (the reduce's fixed order)."""
    return [p for g in optimizers.params for p in optimizers.params[g]]


def reduce_metrics(mesh: Mesh, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean of each scalar metric over the ranks (one all-reduce)."""
    if not metrics:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()).to(mesh.device) for k in keys])
    all_reduce_(mesh, flat)
    flat /= mesh.world_size
    return {k: flat[i] for i, k in enumerate(keys)}

