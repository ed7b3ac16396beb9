"""Multi-resolution hash encoding (iNGP), 3D and 4D (torch port of
`neurad_tpu/ops/hash_encoding.py`), with the lookup as a hand-written CUDA
kernel (`csrc/hash_grid.cu`) and its plain PyTorch version beside it.

  hash_grid_encode      <- `_interp_gather_cp_impl` (cell-packed rows), and
                           the same family for the other layouts
                           (`_gather_levels_multi_impl`, `_gather_levels_impl`),
                           with the index and weight code of `hash_encode`
                           around them and `gaussian_level_weights`
  hash_grid_encode_bwd  <- `_interp_gather_cp_bwd` (K1b), `_gather_levels_multi_bwd`,
                           `_gather_levels_bwd`, with the autodiff of that code

The kernels' boundary (and the plain versions'): positions [N, D] in [0, 1]^D,
optionally one std per position, the per-level tables -> [N, L * F] fp32, and
back: the output's gradient -> the tables', the positions' and the stds'
gradients. One launch does every level of an encoding. Under autograd the
lookup is the `HashGridLookup` function: on CUDA tensors the forward and the
backward kernel, on CPU tensors the two plain versions. It saves only its
inputs; the backward recomputes indices and weights and re-reads the rows a
position or std gradient needs (the JAX VJP saves the gathered rows instead).

Table layouts (parameters are carried across from the JAX package in these):
a level's table is [rows, pk * row_width] fp32, pk logical buckets a physical
row (`level_layout`), row_width = 2^D * F when `cell_packed` (one row holds a
cell's corner features) and F otherwise (one row per grid corner). Its
row-major memory is also [rows * pk, row_width]: the lookup addresses that
view by the logical bucket, so `pk` only sets the hash's modulus. The legacy
layout is one [L * table_size, F] array for all levels. The JAX package
stores tables as 1-D leaves (an XLA layout repair); here they are 2-D
parameters and the parameter bridge reshapes.

Reads in bf16 (`gather_dtype`) round the fp32 master table to bf16 (round
to nearest even), round the corner weights to bf16, and interpolate in bf16:
each product and each addition, corners in order, rounds to bf16. A lookup
that builds no graph may read a bf16 copy of each table instead (the master
rounded once: the same bits, half the bytes). The copies belong to the
tables' owner (`Bf16Copies`, which a serving state switches on), are made
once and made anew when a table changes; a lookup under autograd (training,
where the tables change every step) rounds the master at the read. The
backward builds the table update from the bf16 weight and gradient
(`round(round(w) * round(g * level weight))`) as the JAX backward does and
accumulates it in fp32 (the JAX package accumulates a level whose fp32
gradient exceeds 32 MiB in bf16); d w is summed in fp32 from the rows in the
read type. Launches are counted in `hash_grid_launches` and
`hash_grid_bwd_launches`.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from neurad_tpu_torch.ops import _build

# Spatial-hash primes (the fourth is tiny-cuda-nn's, for 4D grids).
_PRIMES = (1, 2654435761, 805459861, 3674653429)
_MASK32 = 0xFFFFFFFF

# Levels with more buckets than this pack `bucket_pack` buckets per physical
# row. The threshold was chosen for another accelerator's gather; it is kept
# because it fixes the table LAYOUT that parameters are carried across in, not
# for any property of this card.
_FAST_GATHER_MAX_ROWS = 2**18

MAX_LEVELS = 16  # of one launch (csrc/hash_grid.cu)
hash_grid_launches = 0
hash_grid_bwd_launches = 0


def reset_launch_counts() -> None:
    global hash_grid_launches, hash_grid_bwd_launches
    hash_grid_launches = hash_grid_bwd_launches = 0


# ---------------------------------------------------------------------------
# layout (numpy, static)
# ---------------------------------------------------------------------------


def level_scales(num_levels: int, min_res: int, max_res: int) -> np.ndarray:
    """Per-level grid resolutions: floor(min_res * growth^level)."""
    if num_levels > 1:
        growth = np.exp((np.log(max_res) - np.log(min_res)) / (num_levels - 1))
    else:
        growth = 1.0
    return np.floor(min_res * growth ** np.arange(num_levels)).astype(np.float32)


def level_rows(
    scales: np.ndarray, d: int, max_rows: int, cell_packed: bool
) -> Tuple[Tuple[int, ...], Tuple[Optional[int], ...]]:
    """Per-level table sizing: a level whose dense grid fits under `max_rows`
    gets exactly (res + pad)^d rows and collision-free linear indexing; finer
    levels hash into `max_rows` rows. `cell_packed` rows index cells (res + 1
    per dimension), unpacked rows index grid corners (res + 2). Returns
    (rows_per_level, dense_res_per_level); dense_res is None for hashed levels."""
    rows, dense = [], []
    for s in np.asarray(scales):
        res = int(np.floor(float(s))) + (1 if cell_packed else 2)
        if res**d <= max_rows:
            rows.append(res**d)
            dense.append(res)
        else:
            rows.append(max_rows)
            dense.append(None)
    return tuple(rows), tuple(dense)


def level_layout(
    scales: np.ndarray, d: int, max_rows: int, cell_packed: bool, force_hash: bool = False
) -> Tuple[Tuple[int, ...], Tuple[Optional[int], ...], Tuple[int, ...]]:
    """Per-level (buckets, dense_res, bucket_pack). `force_hash` hashes every
    level into `max_rows` entries with no bucket packing (the reference-faithful
    layout)."""
    if force_hash:
        return (max_rows,) * len(scales), (None,) * len(scales), (1,) * len(scales)
    rows, dense = level_rows(scales, d, max_rows, cell_packed)
    packs = []
    for r in rows:
        pack = 1
        while r // pack > _FAST_GATHER_MAX_ROWS:
            pack *= 2
        packs.append(pack)
    return rows, dense, tuple(packs)


def table_physical_shapes(
    scales: np.ndarray, d: int, max_rows: int, features_per_level: int, cell_packed: bool = False,
    force_hash: bool = False,
) -> Tuple[Tuple[int, int], ...]:
    """Per-level physical [rows, f_row] shapes matching `init_hash_tables`."""
    rows, _, packs = level_layout(scales, d, max_rows, cell_packed, force_hash)
    f_row = features_per_level * ((2**d) if cell_packed else 1)
    return tuple((-(-r // p), f_row * p) for r, p in zip(rows, packs))


def init_hash_tables(
    generator: torch.Generator, scales: np.ndarray, d: int, max_rows: int, features_per_level: int,
    scale: float = 0.001, cell_packed: bool = False, force_hash: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Per-level tables, uniform(-1, 1) * scale, as a tuple of [rows_l, f_row_l]
    fp32 tensors on the generator's device."""
    shapes = table_physical_shapes(scales, d, max_rows, features_per_level, cell_packed, force_hash)
    return tuple(
        (torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32) * 2.0 - 1.0) * scale
        for shape in shapes
    )


def init_hash_table(
    generator: torch.Generator, num_levels: int, table_size: int, features_per_level: int, scale: float = 0.001,
    corners_packed: int = 1,
) -> torch.Tensor:
    """The legacy single array [num_levels * table_size, F * corners_packed]."""
    shape = (num_levels * table_size, features_per_level * corners_packed)
    return (torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32) * 2.0 - 1.0) * scale


def _corner_offsets(d: int) -> np.ndarray:
    """[2^D, D] binary corner offsets: corner c has bit i set for dimension i."""
    corners = np.arange(2**d)
    return np.stack([(corners >> i) & 1 for i in range(d)], axis=-1).astype(np.int32)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Spatial hash of integer coords [..., D] -> [...] int64 in [0, table_size):
    uint32 products with wraparound, xor, modulo. int64 arithmetic masked to 32
    bits after each product (torch has no uint32 multiply)."""
    c = coords.to(torch.int64) & _MASK32
    h = None
    for i in range(coords.shape[-1]):
        x = (c[..., i] * _PRIMES[i]) & _MASK32
        h = x if h is None else h ^ x
    return h % table_size


def _dense_index(coords: torch.Tensor, res: int) -> torch.Tensor:
    """Collision-free row-major index of a dense level (dimension 0 slowest);
    coordinates are clipped to [0, res - 1]."""
    c = coords.to(torch.int64).clamp(0, res - 1)
    idx = c[..., 0]
    for i in range(1, coords.shape[-1]):
        idx = idx * res + c[..., i]
    return idx


def _corner_weights(offset: torch.Tensor) -> torch.Tensor:
    """[N, D] offsets in [0, 1) -> [N, 2^D] D-linear weights; each is the product
    over the dimensions in order of (offset if the corner's bit else 1 - offset)."""
    d = offset.shape[-1]
    one_minus = 1.0 - offset
    cols = []
    for bits in _corner_offsets(d):
        w = offset[:, 0] if bits[0] else one_minus[:, 0]
        for i in range(1, d):
            w = w * (offset[:, i] if bits[i] else one_minus[:, i])
        cols.append(w)
    return torch.stack(cols, dim=-1)


def level_index(
    positions: torch.Tensor, scale: float, n_buckets: int, dense_res: Optional[int], cell_packed: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level's logical bucket indices and in-cell offsets for positions
    [N, D]: (bucket [N] of the cell when `cell_packed`, else [N, 2^D] of its
    corners; offset [N, D] in [0, 1))."""
    d = positions.shape[1]
    scaled = positions * float(scale)
    floor = torch.floor(scaled)
    offset = scaled - floor
    cell = floor.to(torch.int64)
    if not cell_packed:
        cell = cell[:, None, :] + torch.from_numpy(_corner_offsets(d)).to(positions.device).to(torch.int64)
    bucket = _dense_index(cell, dense_res) if dense_res else _hash(cell, n_buckets)
    return bucket, offset


def hash_grid_encode_plain(
    positions: torch.Tensor, stds: Optional[torch.Tensor], tables: Sequence[torch.Tensor], scales: Sequence[float],
    buckets: Sequence[int], dense_res: Sequence[Optional[int]], f: int, read_bf16: bool, cell_packed: bool,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, op by op in the kernel's order.
    positions [N, D], stds [N] or None, tables[l] any shape whose row-major
    memory is [buckets_l, row_width] (fp32, or with bf16 reads their bf16
    copies: the same result) -> [N, L * f] fp32."""
    n, d = positions.shape
    n_corners = 2**d
    row_width = f * (n_corners if cell_packed else 1)
    outs = []
    for tbl, scale, n_buckets, res in zip(tables, scales, buckets, dense_res):
        bucket, offset = level_index(positions, scale, n_buckets, res, cell_packed)
        rows = tbl.reshape(-1, row_width)[bucket].reshape(n, n_corners, f)
        w = _corner_weights(offset)
        if read_bf16:
            rows, w = rows.to(torch.bfloat16), w.to(torch.bfloat16)
        o = rows[:, 0] * w[:, 0:1]
        for c in range(1, n_corners):
            o = o + rows[:, c] * w[:, c : c + 1]
        o = o.float()
        if stds is not None:
            o = o * torch.reciprocal(torch.clamp_min(stds * (2.0 * float(scale)), 1.0))[:, None]
        outs.append(o)
    return torch.cat(outs, dim=-1)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def hash_grid_encode_bwd_plain(
    positions: torch.Tensor, stds: Optional[torch.Tensor], tables: Sequence[torch.Tensor], scales: Sequence[float],
    buckets: Sequence[int], dense_res: Sequence[Optional[int]], f: int, read_bf16: bool, cell_packed: bool,
    g: torch.Tensor, tables_grad: Sequence[bool] = None, positions_grad: bool = True, stds_grad: bool = True,
    magnitude: bool = False,
) -> Tuple[Tuple[Optional[torch.Tensor], ...], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward kernel's function in plain PyTorch, op by op in the
    kernel's order: g [N, L * f], the gradient of `hash_grid_encode_plain`'s
    output -> (the tables' gradients, each of its table's shape, fp32; d
    positions [N, D]; d stds [N]). A gradient is None where it is not asked
    for (`tables_grad` per level, all by default; `stds_grad` needs stds).

    `magnitude`: return instead, for each entry, the sum of the absolute
    values of the terms it adds (a scale for the error of a sum taken in
    another order)."""
    n, d = positions.shape
    n_corners = 2**d
    row_width = f * (n_corners if cell_packed else 1)
    tables_grad = [True] * len(tables) if tables_grad is None else list(tables_grad)
    need_rows = positions_grad or (stds_grad and stds is not None)
    as_term = (lambda x: x.abs()) if magnitude else (lambda x: x)
    dpos = positions.new_zeros((n, d)) if positions_grad else None
    dstd = positions.new_zeros((n,)) if (stds_grad and stds is not None) else None
    dtables = []
    corner_bits = _corner_offsets(d)
    for l, (tbl, scale, n_buckets, res) in enumerate(zip(tables, scales, buckets, dense_res)):
        bucket, offset = level_index(positions, scale, n_buckets, res, cell_packed)
        gl = g[:, l * f : (l + 1) * f]
        if stds is not None:
            x = stds * (2.0 * float(scale))
            gp = gl * torch.reciprocal(torch.clamp_min(x, 1.0))[:, None]
        else:
            gp = gl
        w = _corner_weights(offset)  # [n, C] fp32
        if read_bf16:
            gp, w_r = _round_bf16(gp), _round_bf16(w)
        else:
            w_r = w
        if tables_grad[l]:
            upd = w_r[:, :, None] * gp[:, None, :]  # [n, C, f]
            if read_bf16:
                upd = _round_bf16(upd)
            upd = as_term(upd)
            dt = torch.zeros((n_buckets, row_width), dtype=torch.float32, device=positions.device)
            if cell_packed:
                dt.index_add_(0, bucket, upd.reshape(n, row_width))
            else:
                dt.index_add_(0, bucket.reshape(-1), upd.reshape(n * n_corners, f))
            dtables.append(dt.reshape(tbl.shape))
        else:
            dtables.append(None)
        if not need_rows:
            continue
        rows = tbl.reshape(-1, row_width)[bucket].reshape(n, n_corners, f)
        if read_bf16:
            rows = _round_bf16(rows)
        dw = as_term(rows[:, :, 0] * gp[:, None, 0])  # [n, C], j in order
        for j in range(1, f):
            dw = dw + as_term(rows[:, :, j] * gp[:, None, j])
        if dpos is not None:
            one_minus = 1.0 - offset
            for i in range(d):
                doff = None
                for c, bits in enumerate(corner_bits):
                    p = None
                    for k in range(d):
                        if k != i:
                            fk = offset[:, k] if bits[k] else one_minus[:, k]
                            p = fk if p is None else p * fk
                    term = as_term(dw[:, c] * p)
                    if doff is None:
                        doff = term if (bits[i] or magnitude) else -term
                    else:
                        doff = doff + term if (bits[i] or magnitude) else doff - term
                dpos[:, i] = dpos[:, i] + as_term(doff * float(scale))
        if dstd is not None:
            o = rows[:, 0] * w_r[:, 0:1]
            if read_bf16:
                o = _round_bf16(o)
            o = as_term(o)
            for c in range(1, n_corners):
                term = rows[:, c] * w_r[:, c : c + 1]
                if read_bf16:
                    term = _round_bf16(term)
                o = o + as_term(term)
                if read_bf16:
                    o = _round_bf16(o)
            dlw = as_term(o[:, 0] * gl[:, 0])
            for j in range(1, f):
                dlw = dlw + as_term(o[:, j] * gl[:, j])
            dx = as_term(-dlw / (x * x) * (2.0 * float(scale)))
            dstd = dstd + torch.where(x > 1.0, dx, torch.zeros_like(dx))
    return tuple(dtables), dpos, dstd


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------


def _check(positions, stds, tables, scales, buckets, dense_res, f, cell_packed) -> None:
    n_levels = len(tables)
    if not (len(scales) == len(buckets) == len(dense_res) == n_levels):
        raise ValueError("one scale, bucket count and dense resolution per table")
    if positions.dim() != 2 or positions.shape[1] not in (3, 4) or positions.dtype != torch.float32:
        raise ValueError(f"positions must be [N, 3 or 4] float32, got {tuple(positions.shape)} {positions.dtype}")
    n, d = positions.shape
    if stds is not None and (stds.shape != (n,) or stds.dtype != torch.float32 or stds.device != positions.device):
        raise ValueError("stds must be [N] float32 on the positions' device")
    row_width = f * ((2**d) if cell_packed else 1)
    for tbl, n_buckets in zip(tables, buckets):
        if tbl.dtype != torch.float32 or tbl.device != positions.device or not tbl.is_contiguous():
            raise ValueError("tables must be contiguous float32 tensors on the positions' device")
        if tbl.numel() != n_buckets * row_width:
            raise ValueError(f"a table of {tbl.numel()} entries does not hold {n_buckets} rows of {row_width}")
    if positions.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {positions.device}")
    if positions.device.type == "cuda" and (f not in (1, 2, 4) or not 1 <= n_levels <= MAX_LEVELS):
        raise ValueError(f"the kernel takes 1, 2 or 4 features a level and up to {MAX_LEVELS} levels")


def _level_args(tables, buckets, dense_res, scales):
    """The per-level host arrays of the kernels' C interface."""
    n_levels = len(tables)
    as_p = lambda arr: ctypes.cast(arr, ctypes.c_void_p)
    return (
        as_p((ctypes.c_void_p * n_levels)(*[t.data_ptr() for t in tables])),
        as_p((ctypes.c_int * n_levels)(*[int(b) for b in buckets])),
        as_p((ctypes.c_int * n_levels)(*[int(r or 0) for r in dense_res])),
        as_p((ctypes.c_float * n_levels)(*[float(s) for s in scales])),
    )


class Bf16Copies:
    """bf16 copies of one owner's tables, held by that owner (a grid whose
    lookups serve renders: `neurad_encoding.keep_bf16_copies`). A copy is the
    master rounded to bf16 once (round to nearest even: the bits a bf16 read of
    the fp32 master gives) and is made anew when its table is replaced or
    changed in place (an optimizer step or a state-dict load bumps the
    tensor's `_version`), so a stale copy is never read."""

    def __init__(self):
        self._held = []  # per table: (weak reference to it, its version, its data pointer, the copy)

    def of(self, tables: Sequence[torch.Tensor]) -> Optional[list]:
        """The copies of `tables`, in order; None where a table is an
        inference tensor (it keeps no version to check a copy against)."""
        if any(t.is_inference() for t in tables):
            return None
        if len(self._held) != len(tables):
            self._held = [None] * len(tables)
        for i, t in enumerate(tables):
            held = self._held[i]
            if held is None or held[0]() is not t or held[1] != t._version or held[2] != t.data_ptr():
                self._held[i] = None  # free the stale copy before the new one is made
                self._held[i] = (weakref.ref(t), t._version, t.data_ptr(), t.detach().to(torch.bfloat16))
        return [held[3] for held in self._held]


def _forward(positions, stds, tables, scales, buckets, dense_res, f, read_bf16, cell_packed,
             copies=None) -> torch.Tensor:
    """The lookup without autograd. `copies` (with bf16 reads): the tables'
    bf16 copies, read instead of the fp32 masters (the same result)."""
    from_copy = copies is not None and read_bf16
    if from_copy:
        tables = copies
    if positions.device.type == "cpu":
        return hash_grid_encode_plain(positions, stds, tables, scales, buckets, dense_res, f, read_bf16, cell_packed)
    if cell_packed and any(t.data_ptr() % 16 for t in tables):
        raise ValueError("the kernels read cell-packed rows in 16-byte pieces: tables must start on a 16-byte boundary")
    n, d = positions.shape
    positions = positions.contiguous()
    stds = None if stds is None else stds.contiguous()
    out = torch.empty((n, len(tables) * f), dtype=torch.float32, device=positions.device)
    lib = _build.load("hash_grid")
    global hash_grid_launches
    with torch.cuda.device(positions.device):
        err = lib.hash_grid_fwd(
            positions.data_ptr(), None if stds is None else stds.data_ptr(),
            *_level_args(tables, buckets, dense_res, scales), out.data_ptr(), n, len(tables), d, f, int(read_bf16),
            int(cell_packed), int(from_copy), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_grid_fwd failed with CUDA error {err}")
    hash_grid_launches += 1
    return out


def hash_grid_encode_bwd(
    positions: torch.Tensor, stds: Optional[torch.Tensor], tables: Sequence[torch.Tensor], scales: Sequence[float],
    buckets: Sequence[int], dense_res: Sequence[Optional[int]], f: int, read_bf16: bool, cell_packed: bool,
    g: torch.Tensor, tables_grad: Sequence[bool] = None, positions_grad: bool = True, stds_grad: bool = True,
) -> Tuple[Tuple[Optional[torch.Tensor], ...], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The lookup's backward (arguments and result as
    `hash_grid_encode_bwd_plain`): CPU tensors go to the plain version, CUDA
    tensors to the kernel; anything the kernel does not take raises."""
    _check(positions, stds, tables, scales, buckets, dense_res, f, cell_packed)
    n, d = positions.shape
    if g.shape != (n, len(tables) * f) or g.dtype != torch.float32 or g.device != positions.device:
        raise ValueError(f"g must be [{n}, {len(tables) * f}] float32 on the positions' device")
    if positions.device.type == "cpu":
        return hash_grid_encode_bwd_plain(positions, stds, tables, scales, buckets, dense_res, f, read_bf16,
                                          cell_packed, g, tables_grad, positions_grad, stds_grad)
    if cell_packed and any(t.data_ptr() % 16 for t in tables):
        raise ValueError("the kernels read cell-packed rows in 16-byte pieces: tables must start on a 16-byte boundary")
    tables_grad = [True] * len(tables) if tables_grad is None else list(tables_grad)
    positions, g = positions.contiguous(), g.contiguous()
    stds = None if stds is None else stds.contiguous()
    dtables = tuple(torch.zeros_like(t) if want else None for t, want in zip(tables, tables_grad))
    dpos = torch.empty_like(positions) if positions_grad else None
    dstd = torch.empty_like(stds) if (stds_grad and stds is not None) else None
    ptr = lambda t: None if t is None else t.data_ptr()
    dptrs = ctypes.cast((ctypes.c_void_p * len(tables))(*[ptr(t) for t in dtables]), ctypes.c_void_p)
    lib = _build.load("hash_grid")
    global hash_grid_bwd_launches
    with torch.cuda.device(positions.device):
        err = lib.hash_grid_bwd(
            positions.data_ptr(), ptr(stds), *_level_args(tables, buckets, dense_res, scales), g.data_ptr(), dptrs,
            ptr(dpos), ptr(dstd), n, len(tables), d, f, int(read_bf16), int(cell_packed),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_grid_bwd failed with CUDA error {err}")
    hash_grid_bwd_launches += 1
    return dtables, dpos, dstd


class HashGridLookup(torch.autograd.Function):
    """The lookup under autograd: forward kernel and backward kernel on CUDA
    tensors, the two plain versions on CPU tensors. Saves only its inputs."""

    @staticmethod
    def forward(ctx, positions, stds, layout, *tables):
        ctx.layout = layout
        ctx.save_for_backward(positions, stds, *tables)
        return _forward(positions, stds, tables, *layout)

    @staticmethod
    def backward(ctx, g):
        positions, stds, *tables = ctx.saved_tensors
        need = ctx.needs_input_grad
        dtables, dpos, dstd = hash_grid_encode_bwd(
            positions, stds, tables, *ctx.layout, g.contiguous(), tables_grad=need[3:], positions_grad=need[0],
            stds_grad=need[1] and stds is not None,
        )
        return (dpos, dstd, None) + tuple(dtables)


def hash_grid_encode(
    positions: torch.Tensor, stds: Optional[torch.Tensor], tables: Sequence[torch.Tensor], scales: Sequence[float],
    buckets: Sequence[int], dense_res: Sequence[Optional[int]], f: int, read_bf16: bool, cell_packed: bool,
    copies: Optional[Bf16Copies] = None,
) -> torch.Tensor:
    """Every level of one encoding: positions [N, D] (D = 3 or 4) in [0, 1]^D,
    stds [N] or None (no level weight), L tables -> [N, L * f] fp32.

    tables[l] is an fp32 tensor whose row-major memory is [buckets_l,
    row_width] (see the module note); a view into a larger array serves the
    legacy layout. CPU tensors go to the plain versions, CUDA tensors to the
    kernels; anything the kernels do not take raises. Differentiable in the
    positions, the stds and the tables. `copies`: the owner's bf16 copies of
    these tables; a lookup with bf16 reads and without autograd reads them
    instead of the masters (the same bits, half the bytes)."""
    _check(positions, stds, tables, scales, buckets, dense_res, f, cell_packed)
    layout = (tuple(float(s) for s in scales), tuple(int(b) for b in buckets), tuple(dense_res), f, bool(read_bf16),
              bool(cell_packed))
    inputs = (positions, stds, *tables)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return HashGridLookup.apply(positions, stds, layout, *tables)
    return _forward(positions, stds, tables, *layout,
                    copies=copies.of(tables) if copies is not None and read_bf16 else None)


# ---------------------------------------------------------------------------
# the JAX package's functional interface
# ---------------------------------------------------------------------------


def gaussian_level_weights(std: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Per-level downweighting by gaussian std: 1 / clamp(res * 2 * std, 1, inf).
    std [..., 1], scales [L] -> [..., L]."""
    return 1.0 / torch.clamp_min(std * (2.0 * scales), 1.0)


def _encode(positions, stds, table, scales, table_size, gather_dtype, cell_packed, dense_res, bucket_pack,
            copies=None):
    scales = [float(s) for s in np.asarray(scales, dtype=np.float32)]
    num_levels = len(scales)
    d = positions.shape[-1]
    n_corners = 2**d
    multi = isinstance(table, (tuple, list, torch.nn.ParameterList))
    if bucket_pack is None:
        bucket_pack = (1,) * num_levels
    if dense_res is None:
        dense_res = (None,) * num_levels
    if multi:
        tables = list(table)
        f_row = tables[0].shape[-1] // bucket_pack[0]
        buckets = [t.shape[0] * pk for t, pk in zip(tables, bucket_pack)]
    else:
        if any(r is not None for r in dense_res) or any(pk != 1 for pk in bucket_pack):
            raise ValueError("dense levels and bucket packing need per-level tables")
        tables = [table[l * table_size : (l + 1) * table_size] for l in range(num_levels)]
        copies = None  # the views are new every call: nothing to keep a copy of
        f_row = table.shape[-1]
        buckets = [table_size] * num_levels
    f = f_row // (n_corners if cell_packed else 1)
    flat = positions.reshape(-1, d)
    out = hash_grid_encode(
        flat, None if stds is None else stds.reshape(-1), tables, scales, buckets, dense_res, f,
        read_bf16=gather_dtype is not None, cell_packed=cell_packed, copies=copies,
    )
    return out.reshape(positions.shape[:-1] + (num_levels * f,)), f


def hash_encode(
    positions: torch.Tensor,
    table,
    scales,
    table_size: int = 0,
    level_weights: Optional[torch.Tensor] = None,
    gather_dtype: Optional[torch.dtype] = torch.bfloat16,
    cell_packed: bool = False,
    dense_res: Optional[Tuple[Optional[int], ...]] = None,
    bucket_pack: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """Multi-level hash lookup with D-linear interpolation.

    positions [..., D] in [0, 1]^D (D = 3 or 4); table: a sequence of per-level
    [rows_l, F_row] tables or the legacy [num_levels * table_size, F] array;
    scales [L]; level_weights: optional [..., L] per-level downweighting,
    applied after the lookup; gather_dtype: torch.bfloat16 (reads and
    interpolation in bf16) or None (fp32). Returns [..., L * F] fp32."""
    if gather_dtype not in (None, torch.bfloat16):
        raise ValueError("gather_dtype is torch.bfloat16 or None")
    out, f = _encode(positions, None, table, scales, table_size, gather_dtype, cell_packed, dense_res, bucket_pack)
    if level_weights is not None:
        out = out * torch.repeat_interleave(level_weights, f, dim=-1)
    return out


def hash_encode_gaussians(
    gauss_mean: torch.Tensor,
    gauss_std: torch.Tensor,
    table,
    scales,
    table_size: int = 0,
    cell_packed: bool = False,
    dense_res: Optional[Tuple[Optional[int], ...]] = None,
    bucket_pack: Optional[Tuple[int, ...]] = None,
    gather_dtype: Optional[torch.dtype] = torch.bfloat16,
    copies: Optional[Bf16Copies] = None,
) -> torch.Tensor:
    """Encode multisampled gaussians, weight each level by the gaussian's std
    (inside the lookup) and average over the multisamples: gauss_mean
    [..., M, D], gauss_std [..., M, 1] -> [..., L * F]. `copies`: the
    owner's bf16 copies of the per-level tables (see `hash_grid_encode`)."""
    if gather_dtype not in (None, torch.bfloat16):
        raise ValueError("gather_dtype is torch.bfloat16 or None")
    feats, _ = _encode(gauss_mean, gauss_std, table, scales, table_size, gather_dtype, cell_packed, dense_res,
                       bucket_pack, copies)
    if feats.shape[-2] == 1:  # the mean of one multisample is that multisample
        return feats[..., 0, :]
    return feats.mean(dim=-2)

