"""Piecewise CUDA-graph replay of a NeuRAD model's feature-field render of
one chunk without autograd (`get_nff_outputs`, as `ADPipeline._chunked_nff`
calls it for a full-sensor render).

Eagerly, the host takes about as long to dispatch a chunk's ~800 small
kernels as the card takes to run them, and the card waits. A CUDA graph
launches a captured sequence of kernels at once. The hash-grid lookups stay
eager calls between the graphs: each goes through `hash_grid_encode` as the
eager render's does, so a table's bf16 copy is made anew after the table
changes and every lookup kernel is still a call of
`ops.hash_encoding._forward`. A chunk's render is therefore captured as
pieces cut at its lookups (`hash_encoding.cut_at_lookups`): piece, lookup,
piece, ..., piece. The `neurad-parity` preset's chunk has 6 lookups (two
proposal rounds and the field, a static and an actor lookup each) and 7
pieces; the MLP proposals of `neurad` look nothing up, leaving the field's 2
lookups and 3 pieces.

Which renders (`engages`): a NeuRAD model's, on a CUDA device, without
autograd and without actor edits (Python values a graph would keep). The
sharded eval renders eagerly.

Key (`key_of`): the padded chunk's rows, the rays that are camera rays, the
ray bundle's fields (shapes, dtypes, metadata keys) and the data pointers of
the model's parameters and buffers. A key is rendered eagerly the first time
it is seen (the kernels load and the libraries set up their handles) and is
captured the second time. An in-place change of a tensor (an optimizer step,
`update_actors`, `load_state_dict`) keeps the key, since a replay reads the
tensor's memory; a replaced tensor changes it, and the graphs of the old
tensors are dropped.

Memory: a key's pieces are captured in order into one private pool, so the
pool holds what one eager chunk holds. After the capture no tensor in the
pool is kept: the lookups' inputs and outputs and the render's outputs are
addressed through tensors that do not own their memory (`_Memory`), which
later pieces reuse where the eager render would reuse it. This is sound
because every replay runs the pieces and lookups in capture order on one
stream, and no later capture allocates from the pool. So the pool counts as
reserved, not allocated, memory (cuBLAS's workspace of the capture stream
too: `_drop_blas_workspaces`). The rays are copied into buffers the key
owns (padding rows zero-filled). The outputs are valid until the next
replay.

Counters and spans: the capture counts into a block of its own, so that the
actor counters are computed inside the graphs, and adds it to the current
block after each replay (`profiler.Counters.count_again`). Each piece and
lookup is replayed inside the last span the model opened before it ended
(`profiler.spans_opened`). Counters `nff.chunks_replayed` and `nff.captures`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import warnings
from typing import Dict, List, Optional

import torch

from neurad_tpu_torch.core.structs import RayBundle, map_tensors
from neurad_tpu_torch.models.neurad import NeuRADModel
from neurad_tpu_torch.ops import hash_encoding as he
from neurad_tpu_torch.utils import profiler

def engages(model, device: torch.device, edits) -> bool:
    """Whether a chunk render of `model` on `device` is replayed (module
    docstring)."""
    return (isinstance(model, NeuRADModel) and device.type == "cuda" and not torch.is_grad_enabled()
            and edits is None)


def _ray_tensors(bundle: RayBundle) -> List[torch.Tensor]:
    """The bundle's tensors in a fixed order: the fields, then the metadata by key."""
    fields = [getattr(bundle, f.name) for f in dataclasses.fields(bundle) if f.name != "metadata"]
    return [t for t in fields + [bundle.metadata[k] for k in sorted(bundle.metadata)] if torch.is_tensor(t)]


def key_of(model, piece: RayBundle, rows: int, num_cam_rays: int) -> tuple:
    """The key of the graphs that render `piece` padded to `rows` rays, of
    which the first `num_cam_rays` are camera rays (module docstring)."""

    def signature(x):
        return None if x is None else (tuple(x.shape[1:]), x.dtype)

    fields = tuple((f.name, signature(getattr(piece, f.name))) for f in dataclasses.fields(piece)
                   if f.name != "metadata")
    metadata = tuple(sorted((k, signature(v)) for k, v in piece.metadata.items()))
    tensors = tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers()))
    return rows, num_cam_rays, fields, metadata, tensors


def _drop_blas_workspaces() -> None:
    """cuBLAS keeps a workspace for each stream it ran on; the capture
    stream's was allocated in the capture's pool and would stay allocated
    beside the default stream's. Dropping cuBLAS's hold on them frees that
    one back to the pool, which the graphs keep reserved and nothing else
    allocates from, as the pool's other blocks; the default stream's is made
    anew at its next use. (PyTorch's own CUDA-graph trees do the same.)"""
    drop = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if drop is not None:
        drop()


class _Memory:
    """Where a tensor lies, to be addressed after the tensor is gone:
    `tensor()` is a tensor on the same memory that does not own it (it is
    made through the CUDA array interface)."""

    def __init__(self, t: torch.Tensor):
        if t.dtype != torch.float32:  # the lookups' inputs and outputs and the render's outputs are
            raise ValueError(f"a {t.dtype} tensor crosses a piece of a captured render")
        self.__cuda_array_interface__ = {"shape": tuple(t.shape), "typestr": "<f4", "data": (t.data_ptr(), False),
                                         "strides": tuple(4 * s for s in t.stride()), "version": 2}
        self.device = t.device

    def tensor(self) -> torch.Tensor:
        return torch.as_tensor(self, device=self.device)


class _Lookup:
    """A lookup between two pieces: its inputs, written by the piece before
    it, and its output, read by the pieces after it."""

    def __init__(self, positions, stds, tables, layout, copies, out):
        self.positions, self.stds, self.out = positions, stds, out
        self.tables, self.layout, self.copies = tuple(tables), layout, copies

    def resolve(self) -> "_Lookup":
        """The lookup with its inputs and output as tensors (after the capture)."""
        self.positions, self.out = self.positions.tensor(), self.out.tensor()
        self.stds = None if self.stds is None else self.stds.tensor()
        return self

    def replay(self) -> None:
        self.out.copy_(he.hash_grid_encode(self.positions, self.stds, self.tables, *self.layout, copies=self.copies))


class _Capture:
    """The capture of one chunk render as CUDA graphs cut at its lookups:
    `steps` [(span, graph or lookup)] in order."""

    def __init__(self, pool, opened: List[str]):
        self.pool, self.opened = pool, opened
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.steps: list = []

    def _span(self) -> Optional[str]:
        return self.opened[-1] if self.opened else None

    def begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self) -> None:
        graph, self.graph = self.graph, None
        graph.capture_end()
        self.steps.append((self._span(), graph))

    def cut(self, positions, stds, tables, layout, copies) -> torch.Tensor:
        """A lookup: the piece ends, the lookup's output is allocated where
        the eager lookup allocates it, and the next piece begins."""
        f = layout[3]
        out = torch.empty((positions.shape[0], len(tables) * f), dtype=torch.float32, device=positions.device)
        lookup = _Lookup(_Memory(positions), None if stds is None else _Memory(stds), tables, layout, copies,
                         _Memory(out))
        self.end()
        self.steps.append((self._span(), lookup))
        self.begin()
        return out

    def abort(self) -> None:
        """End a capture that failed; its error is reported by the caller."""
        graph, self.graph = self.graph, None
        if graph is not None:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()


class _Replay:
    """One key's captured render: its ray buffers, its pieces and lookups
    grouped by span, its outputs and its counts."""

    def __init__(self, inputs: RayBundle):
        self.inputs = inputs
        self._buffers = _ray_tensors(inputs)
        self._filled = 0  # the rows the last `load` wrote; the rest are zero
        self.blocks: list = []  # [(span or None, [graph or lookup])]
        self.outputs: Dict[str, torch.Tensor] = {}
        self.counted: Optional[profiler.Counters] = None

    def load(self, piece: RayBundle) -> None:
        m = piece.origins.shape[0]
        for buffer, x in zip(self._buffers, _ray_tensors(piece)):
            buffer[:m].copy_(x)
            if m < self._filled:
                buffer[m:self._filled].zero_()
        self._filled = m

    def finish(self, capture: _Capture, outputs: Dict[str, torch.Tensor], counted: profiler.Counters) -> None:
        for name, step in capture.steps:
            step = step.resolve() if isinstance(step, _Lookup) else step
            if self.blocks and self.blocks[-1][0] == name:
                self.blocks[-1][1].append(step)
            else:
                self.blocks.append((name, [step]))
        self.outputs = {k: _Memory(v).tensor() for k, v in outputs.items()}
        self.counted = counted

    def replay(self, piece: RayBundle) -> Dict[str, torch.Tensor]:
        self.load(piece)
        for name, steps in self.blocks:
            with profiler.span(name) if name is not None else contextlib.nullcontext():
                for step in steps:
                    step.replay()
        self.counted.count_again()
        return self.outputs


class NFFGraphs:
    """The captured chunk renders of one model, by key (module docstring)."""

    def __init__(self, model):
        self.model = model
        self._seen: set = set()  # keys rendered eagerly once
        self._runs: Dict[tuple, Optional[_Replay]] = {}  # None: the capture failed, the key renders eagerly
        self._tensors: Optional[tuple] = None  # the data pointers the graphs were captured on
        self._stream: Optional[torch.cuda.Stream] = None

    def render(self, piece: RayBundle, rows: int, num_cam_rays: int) -> Optional[Dict[str, torch.Tensor]]:
        """The render of the chunk `piece` (padded with zero rays to `rows`)
        by replay: its outputs, `rows` long, valid until the next call. None
        where the caller renders the chunk eagerly: the first time its key is
        seen, and where its capture failed."""
        key = key_of(self.model, piece, rows, num_cam_rays)
        if key[-1] != self._tensors:  # a tensor was replaced: the graphs would read memory no longer the model's
            self._seen.clear()
            self._runs.clear()
            self._tensors = key[-1]
        if key not in self._runs:
            if key not in self._seen:
                self._seen.add(key)
                return None
            self._runs[key] = self._capture(piece, rows, num_cam_rays)
        run = self._runs[key]
        if run is None:
            return None
        profiler.count("nff.chunks_replayed", 1)
        return run.replay(piece)

    def _capture(self, piece: RayBundle, rows: int, num_cam_rays: int) -> Optional[_Replay]:
        run = _Replay(map_tensors(lambda x: x.new_zeros((rows,) + x.shape[1:]), piece))
        run.load(piece)
        if self._stream is None:
            self._stream = torch.cuda.Stream(piece.origins.device)
        self._stream.wait_stream(torch.cuda.current_stream())
        with profiler.spans_opened() as opened:
            capture = _Capture(torch.cuda.graph_pool_handle(), opened)
            try:
                with torch.cuda.stream(self._stream), profiler.counting() as counted, \
                        he.cut_at_lookups(capture.cut):
                    capture.begin()
                    outputs = self.model.get_nff_outputs(run.inputs, num_cam_rays)
                    capture.end()
                run.finish(capture, outputs, counted)
            except (RuntimeError, ValueError) as err:
                capture.abort()
                warnings.warn(f"a chunk render could not be captured as CUDA graphs and is rendered eagerly: {err}")
                return None
            finally:
                _drop_blas_workspaces()
        torch.cuda.current_stream().wait_stream(self._stream)
        profiler.count("nff.captures", 1)
        return run
