"""Row-gather and row-scatter probes on the card, each by three hand-written
mechanisms (`csrc/gather_probes.cu`): the port's counterpart of
`benchmarks/pallas_gather_microbench.py` and
`benchmarks/pallas_gather_microbench2.py`. They answer the hash-grid lookup's
design questions on this card, forward (a gather: one thread per row, lanes
across a row, or the tensor cores) and backward (a scatter-add: atomics per
row, a resident accumulator per range of rows, or the tensor cores).

  gather_rows_coalesced  <- `make_vmem_gather`        lanes across a row, a block of queries at once
  gather_rows_onehot     <- `make_onehot_gather`      onehot(idx) @ table on the tensor cores, fp32 result
  gather_rows_serial     <- `make_scalar_gather`      one thread copies one row
  scatter_rows_onehot    <- `make_onehot_scatter`     onehot(idx)^T @ bf16(g) on the tensor cores, fp32 sum
  scatter_rows_blocked   <- `make_vmem_scatter_probe` a shared-memory accumulator per range of rows, fed its own updates
  scatter_rows_serial    <- `make_scalar_scatter`     one update at a time, its row added as vector reductions

The two one-hot probes first sort the indices by range of `BUCKET_ROWS` rows
(a counting sort in three hand-written launches) and multiply each range of
the table (or of the output) only with the queries (or updates) that name it:
the one-hot product on the tensor cores that the TPU kernels compute, without
the products over rows no query names. The one-hot scatter has one owner per
output row and no atomics: two launches on the same inputs give the same bits.
The blocked scatter runs the same sort, then walks the sorted updates in spans
of `BLOCKED_SPAN`, adding each range's updates into an fp32 accumulator of
`BUCKET_ROWS` rows in shared memory and flushing it: every update is read a
fixed number of times, whatever T. The serial scatter adds each update's row
alone, F/4 lanes with one 16-byte vector reduction each.

The gathers share one plain version, `gather_rows_plain` (`table[idx]`), the
scatter-adds another, `scatter_rows_plain` (`index_add_` in fp32; with the
one-hot product's bf16 rounding of g for P3), taken for CPU tensors; CUDA
tensors go to the kernels or raise. The coalesced and serial gathers equal
their plain version bit for bit, the one-hot gather equals it as fp32; the
scatter-adds sum in another order (atomics, or the product's), and are held
to 1e-5 of the sum of the absolute values of an entry's terms. No query or
update (N = 0) launches nothing. Launches are counted in `coalesced_launches`, `onehot_launches`, `serial_launches`,
`scatter_onehot_launches`, `scatter_blocked_launches`,
`scatter_serial_launches`.

    python -m neurad_tpu_torch.benchmarks.gather_microbench [--device cuda] [--queries 1048576]

prints, per table shape (T rows x F columns: bf16 for the gathers, fp32 for
the scatter-adds' output; the scatter-adds once more at `SKEWED_SHAPE` on
`skewed_indices`), each kernel's time as a call (CUDA events: median of 10
calls after 2 warm-ups, the wrapper's host time included) and as device time
(`device_ms`: a CUDA graph of 10 calls replayed between events, median of 3)
and its rate in M rows/s, beside `torch.index_select`
and `index_add_` (yardsticks that no path of the port calls) and the least
time the card could take for the function (its bytes over the memory rate:
neither function needs arithmetic to speak of). The one-hot products' own
2 * N * BUCKET_ROWS * F operations over the bf16 tensor-core rate are printed
beside them as `mechanism_ops_ms` (the cost of that mechanism, not of the
function), with the bucketing pass's scratch in bytes.
On the CPU (`--device cpu`) the plain versions run, timed on the host clock.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.ops import _build

# (rows, bf16 columns): 256 KB, 4 MB, 8 MB and 32 MB tables
TABLE_SHAPES = ((16384, 8), (65536, 32), (131072, 32), (524288, 32))
NUM_QUERIES = 1 << 20
BUCKET_ROWS = 128  # rows of a bucket of the bucketed probes' counting sort (`R` in csrc/gather_probes.cu)
BLOCKED_SPAN = 1024  # sorted updates a span of the blocked scatter (`SPAN` in csrc/gather_probes.cu)
SKEWED_SHAPE = (131072, 32)  # the table shape at which the scatter-adds also run on skewed indices
# H100 SXM data-sheet peaks: HBM3 bandwidth, dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12
PEAK_BF16_OPS = 989e12

SCATTER_TOL = 1e-5  # of the sum of the absolute values of an output entry's terms

coalesced_launches = 0
onehot_launches = 0
serial_launches = 0
scatter_onehot_launches = 0
scatter_blocked_launches = 0
scatter_serial_launches = 0


def reset_launch_counts() -> None:
    global coalesced_launches, onehot_launches, serial_launches
    global scatter_onehot_launches, scatter_blocked_launches, scatter_serial_launches
    coalesced_launches = onehot_launches = serial_launches = 0
    scatter_onehot_launches = scatter_blocked_launches = scatter_serial_launches = 0


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [T, F], idx [N] integer -> table[idx] [N, F]."""
    return table[idx.long()]


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.bfloat16 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous [T, F] bfloat16 tensor, got {tuple(table.shape)} {table.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous() or idx.device != table.device:
        raise ValueError("idx must be a contiguous [N] int32 tensor on the table's device")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")


def _launch(fn_name: str, table: torch.Tensor, idx: torch.Tensor, out: torch.Tensor, *extra) -> torch.Tensor:
    """Launch `fn_name` on the current stream; nothing for N = 0. `extra`:
    pointers passed after the shape (the one-hot gather's scratch)."""
    if idx.shape[0] == 0:
        return out
    lib = _build.load("gather_probes")
    with torch.cuda.device(table.device):
        err = getattr(lib, fn_name)(table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], table.shape[0],
                                    table.shape[1], *extra, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {err} (T={table.shape[0]}, F={table.shape[1]})")
    return out


@functools.lru_cache(maxsize=64)
def onehot_scratch_ints(n: int, t_rows: int) -> int:
    """The int32s of scratch the bucketed probes' (P2, P3, P4) sort needs at N = n
    queries against t_rows rows (its offsets table and permutation), from the
    built library: the layout is the kernel's."""
    ints = _build.load("gather_probes").onehot_scratch_ints(n, t_rows)
    if ints < 0:
        raise ValueError(f"the bucketed probes take 1 <= N < 2^25 and T <= {51200 * BUCKET_ROWS} rows, "
                         f"got N={n}, T={t_rows}")
    return ints


def _onehot_scratch(n: int, t_rows: int, device: torch.device) -> torch.Tensor:
    return torch.empty((onehot_scratch_ints(n, t_rows),), dtype=torch.int32, device=device)


def gather_rows_coalesced(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with neighbouring lanes on neighbouring 16-byte pieces of a
    row. F must be a multiple of 8 (16 bytes of bf16)."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.shape[1] % 8:
        raise ValueError("rows must be a multiple of 16 bytes (8 bf16 columns)")
    global coalesced_launches
    out = _launch("gather_rows_coalesced", table, idx, torch.empty((idx.shape[0], table.shape[1]),
                                                                   dtype=table.dtype, device=table.device))
    coalesced_launches += int(idx.shape[0] > 0)
    return out


def gather_rows_serial(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with one thread copying one row. F must be a multiple of 8."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.shape[1] % 8:
        raise ValueError("rows must be a multiple of 16 bytes (8 bf16 columns)")
    global serial_launches
    out = _launch("gather_rows_serial", table, idx, torch.empty((idx.shape[0], table.shape[1]),
                                                                dtype=table.dtype, device=table.device))
    serial_launches += int(idx.shape[0] > 0)
    return out


def gather_rows_onehot(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] as onehot(idx) @ table on the tensor cores, range of
    `BUCKET_ROWS` rows by range after a counting sort of idx: bf16 inputs, fp32
    sum and result [N, F]. F is 8, 16 or 32. The scratch of the sort is
    allocated here."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx).float()
    if table.shape[1] not in (8, 16, 32):
        raise ValueError("the one-hot gather takes 8, 16 or 32 columns")
    if table.data_ptr() % 16:
        raise ValueError("the one-hot gather copies 16-byte pieces: the table must start on a 16-byte boundary")
    global onehot_launches
    n = idx.shape[0]
    out = torch.empty((n, table.shape[1]), dtype=torch.float32, device=table.device)
    if n:
        scratch = _onehot_scratch(n, table.shape[0], table.device)
        _launch("gather_rows_onehot", table, idx, out, scratch.data_ptr())
        onehot_launches += 1
    return out


def scatter_rows_plain(idx: torch.Tensor, g: torch.Tensor, t_rows: int, round_bf16: bool = False) -> torch.Tensor:
    """out [t_rows, F] fp32 = 0; out[idx[i]] += g[i] (`index_add_`), with g
    rounded to bf16 first when `round_bf16` (the one-hot product's inputs)."""
    if round_bf16:
        g = g.to(torch.bfloat16).float()
    return torch.zeros((t_rows, g.shape[1]), dtype=torch.float32, device=g.device).index_add_(0, idx.long(), g)


def _check_scatter(idx: torch.Tensor, g: torch.Tensor, t_rows: int) -> None:
    if g.dim() != 2 or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous [N, F] float32 tensor, got {tuple(g.shape)} {g.dtype}")
    if idx.shape != (g.shape[0],) or idx.dtype != torch.int32 or not idx.is_contiguous() or idx.device != g.device:
        raise ValueError("idx must be a contiguous [N] int32 tensor on g's device")
    if t_rows < 1:
        raise ValueError("t_rows must be positive")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {g.device}")


def _launch_scatter(fn_name: str, idx: torch.Tensor, g: torch.Tensor, t_rows: int, *extra) -> torch.Tensor:
    """Launch `fn_name` (N >= 1) into a new [t_rows, F] fp32 tensor, which the
    kernels write whole (the one-hot scatter) or zero-fill first (the others).
    `extra`: pointers passed after the shape."""
    out = torch.empty((t_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    lib = _build.load("gather_probes")
    with torch.cuda.device(g.device):
        err = getattr(lib, fn_name)(idx.data_ptr(), g.data_ptr(), out.data_ptr(), idx.shape[0], t_rows, g.shape[1],
                                    *extra, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {err} (T={t_rows}, F={g.shape[1]})")
    return out


def _check_vector_rows(g: torch.Tensor, what: str) -> None:
    if g.data_ptr() % 16:
        raise ValueError(f"the {what} reads 16-byte pieces of g: g must start on a 16-byte boundary")


def scatter_rows_onehot(idx: torch.Tensor, g: torch.Tensor, t_rows: int) -> torch.Tensor:
    """P3: onehot(idx)^T @ bf16(g) on the tensor cores, range of `BUCKET_ROWS`
    output rows by range after a counting sort of idx, fp32 sum -> [t_rows,
    F]. F is 8, 16 or 32. One owner per output row, no atomics: the same
    inputs give the same bits. The kernel writes every row, so `out` is not
    zero-filled; the scratch of the sort is allocated here."""
    _check_scatter(idx, g, t_rows)
    if g.device.type == "cpu":
        return scatter_rows_plain(idx, g, t_rows, round_bf16=True)
    if g.shape[1] not in (8, 16, 32):
        raise ValueError("the one-hot scatter takes 8, 16 or 32 columns")
    _check_vector_rows(g, "one-hot scatter")
    global scatter_onehot_launches
    n = idx.shape[0]
    if n == 0:
        return torch.zeros((t_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    scratch = _onehot_scratch(n, t_rows, g.device)  # held until the launch is enqueued
    out = _launch_scatter("scatter_rows_onehot", idx, g, t_rows, scratch.data_ptr())
    scatter_onehot_launches += 1
    return out


def scatter_rows_blocked(idx: torch.Tensor, g: torch.Tensor, t_rows: int) -> torch.Tensor:
    """P4: a resident fp32 accumulator per range of `BUCKET_ROWS` rows in
    shared memory, fed only its own updates -> [t_rows, F] fp32. The updates
    are sorted by range first (the one-hot probes' counting sort); spans of
    `BLOCKED_SPAN` sorted updates are spread over the card, each adding its
    updates range by range with shared-memory atomics and flushing the range's
    rows with plain stores (a range wholly inside the span) or vector
    reductions (a range cut by the span's edge) into the zero-filled output.
    F is 8, 16 or 32; 1 <= N < 2^25 and T <= 51200 * BUCKET_ROWS, as for the
    one-hot probes. The sums' order changes from launch to launch (atomics).
    A call is five launches (the zero-fill, the sort's three, the
    accumulate); `scatter_blocked_launches` counts calls."""
    _check_scatter(idx, g, t_rows)
    if g.device.type == "cpu":
        return scatter_rows_plain(idx, g, t_rows)
    if g.shape[1] not in (8, 16, 32):
        raise ValueError("the blocked scatter takes 8, 16 or 32 columns")
    _check_vector_rows(g, "blocked scatter")
    global scatter_blocked_launches
    n = idx.shape[0]
    if n == 0:
        return torch.zeros((t_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    scratch = _onehot_scratch(n, t_rows, g.device)  # held until the launch is enqueued
    out = _launch_scatter("scatter_rows_blocked", idx, g, t_rows, scratch.data_ptr())
    scatter_blocked_launches += 1
    return out


def scatter_rows_serial(idx: torch.Tensor, g: torch.Tensor, t_rows: int) -> torch.Tensor:
    """P6: one update at a time, its row added as one row-wide vector add:
    F/4 neighbouring lanes, each with one 16-byte reduction
    (`red.global.add.v4.f32`) into the zero-filled output -> [t_rows, F] fp32.
    Nothing combines updates. F is a multiple of 4 and g starts on a 16-byte
    boundary. A call is two launches (the zero-fill, the adds);
    `scatter_serial_launches` counts calls."""
    _check_scatter(idx, g, t_rows)
    if g.device.type == "cpu":
        return scatter_rows_plain(idx, g, t_rows)
    if g.shape[1] % 4:
        raise ValueError("the serial scatter adds 16-byte pieces: F must be a multiple of 4 columns")
    _check_vector_rows(g, "serial scatter")
    global scatter_serial_launches
    if idx.shape[0] == 0:
        return torch.zeros((t_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    out = _launch_scatter("scatter_rows_serial", idx, g, t_rows)
    scatter_serial_launches += 1
    return out


def _time_ms(fn: Callable[[], torch.Tensor], device: torch.device, warmup: int = 2, reps: int = 10) -> float:
    """Median time of fn(): CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn: Callable[[], torch.Tensor], device: torch.device, reps: int = 10) -> Optional[float]:
    """Device time of fn() on the card: `reps` calls captured in one CUDA
    graph, the graph replayed between CUDA events (no host time between the
    launches), the median of 3 replays over `reps`. None on the CPU, which has
    no device time."""
    if device.type != "cuda":
        return None
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def bounds_ms(n: int, t_rows: int, f: int) -> Dict[str, Tuple[float, str]]:
    """The least time an H100 SXM could take for each probe's function, and
    what sets it: the indices and the rows they name read once (at most the
    whole table), the result written once (bf16 for the copies, fp32 for the
    one-hot gather). The function is a gather whatever the mechanism, so all
    three are bound by bytes."""
    read = n * 4 + min(n, t_rows) * f * 2
    copy = (read + n * f * 2) / PEAK_BYTES * 1e3
    onehot = (read + n * f * 4) / PEAK_BYTES * 1e3
    return {"coalesced": (copy, "bytes"), "serial": (copy, "bytes"), "onehot": (onehot, "bytes")}


def scatter_bound_ms(n: int, t_rows: int, f: int) -> Tuple[float, str]:
    """The least time an H100 SXM could take for a scatter-add's function: the
    indices and the updates read once, the fp32 output written once
    (N * 4 + N * F * 4 + T * F * 4 bytes). Bound by bytes, whatever the
    mechanism."""
    return (n * 4 + n * f * 4 + t_rows * f * 4) / PEAK_BYTES * 1e3, "bytes"


def onehot_mechanism_ops_ms(n: int, f: int) -> float:
    """What a one-hot probe's mechanism (gather or scatter) costs at the least:
    the bucketed product's 2 * N * BUCKET_ROWS * F operations (each query or
    update against the rows of its bucket) at the bf16 tensor-core peak. Not
    the function's bound (`bounds_ms`, `scatter_bound_ms`): the function needs
    none of them."""
    return 2.0 * n * BUCKET_ROWS * f / PEAK_BF16_OPS * 1e3


def skewed_indices(n: int, t_rows: int, gen: torch.Generator, device) -> torch.Tensor:
    """n int32 indices into t_rows rows: half of them row t_rows // 3, a
    quarter uniform in the last 16 rows, the rest uniform; shuffled."""
    idx = torch.randint(0, t_rows, (n,), generator=gen, device=device, dtype=torch.int32)
    idx[: n // 2] = t_rows // 3
    idx[n // 2: 3 * n // 4] = torch.randint(max(0, t_rows - 16), t_rows, (3 * n // 4 - n // 2,), generator=gen,
                                            device=device, dtype=torch.int32)
    return idx[torch.randperm(n, generator=gen, device=device)]


def run(device="cuda", queries: int = NUM_QUERIES, shapes=TABLE_SHAPES, seed: int = 0, reps: int = 10,
        log: Optional[Callable[[str], None]] = print) -> List[dict]:
    """Check and time every probe at every table shape, and the scatter-adds
    once more at `SKEWED_SHAPE` on `skewed_indices`. Returns one record per
    (shape, probe, skew): name, T, F, skew ("uniform" or "hot"), ms (a call), device_ms (`device_ms`; None on
    the CPU), rows_per_s, max_abs_err against the plain version, plain_ms, library_ms and library_device_ms
    (`torch.index_select` for the gathers, `index_add_` for the scatter-adds), bound_ms, bound_by; the one-hot probes'
    records also hold mechanism_ops_ms and, on the card, scratch_bytes (the
    bucketing pass's); the scatter-adds' hold max_rel_err (error over the sum
    of the absolute values of the entry's terms) and relaunch_equal (a second
    launch on the same inputs gave the same bits). Raises where a probe
    disagrees with its plain version, or the one-hot scatter with itself."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    probes = (("coalesced", gather_rows_coalesced), ("onehot", gather_rows_onehot), ("serial", gather_rows_serial))
    records = []
    for t_rows, f in shapes:
        table = torch.randn((t_rows, f), generator=gen, device=dev).to(torch.bfloat16)
        idx = torch.randint(0, t_rows, (queries,), generator=gen, device=dev, dtype=torch.int32)
        ref = gather_rows_plain(table, idx)
        plain_ms = _time_ms(lambda: gather_rows_plain(table, idx), dev, 1, 3)
        idx64 = idx.long()
        library_ms = _time_ms(lambda: torch.index_select(table, 0, idx64), dev, 2, reps)
        library_device_ms = device_ms(lambda: torch.index_select(table, 0, idx64), dev)
        bound = bounds_ms(queries, t_rows, f)
        if log:
            log(f"[gather] T={t_rows} F={f} N={queries}: table[idx] {plain_ms:.4f} ms, index_select {library_ms:.4f} ms"
                + _device_note(library_device_ms))
        for name, fn in probes:
            got = fn(table, idx)
            want = ref.float() if name == "onehot" else ref
            if got.dtype != want.dtype or got.shape != want.shape:
                raise RuntimeError(f"{name} gather returned {got.dtype} {tuple(got.shape)}")
            err = float((got.float() - want.float()).abs().max()) if queries else 0.0
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} gather differs from table[idx] at T={t_rows}, F={f}: max abs err {err}")
            ms = _time_ms(lambda: fn(table, idx), dev, 2, reps)
            rec = dict(name=name, T=t_rows, F=f, N=queries, skew="uniform", ms=ms,
                       device_ms=device_ms(lambda: fn(table, idx), dev),
                       rows_per_s=queries / (ms * 1e-3) if ms else 0.0,
                       max_abs_err=err, plain_ms=plain_ms, library_ms=library_ms,
                       library_device_ms=library_device_ms, bound_ms=bound[name][0], bound_by=bound[name][1])
            if name == "onehot":
                rec["mechanism_ops_ms"] = onehot_mechanism_ops_ms(queries, f)
                rec["scratch_bytes"] = _scratch_bytes(queries, t_rows, dev)
            records.append(rec)
            if log:
                log(f"[gather]   {name:10s} {ms:10.4f} ms  {rec['rows_per_s'] / 1e6:10.1f} M rows/s  "
                    f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})" + _device_note(rec["device_ms"])
                    + (_onehot_note(rec) if name == "onehot" else "")
                    + "  exact")
        records += _run_scatter(dev, gen, idx, t_rows, f, reps, log)
        if (t_rows, f) == SKEWED_SHAPE:
            records += _run_scatter(dev, gen, skewed_indices(queries, t_rows, gen, dev), t_rows, f, reps, log, "hot")
    return records


def _device_note(ms: Optional[float]) -> str:
    return "" if ms is None else f", device {ms:.4f} ms"


def _scratch_bytes(n: int, t_rows: int, device: torch.device) -> Optional[int]:
    """The one-hot probes' scratch on the card; None where the plain versions run."""
    return 4 * onehot_scratch_ints(n, t_rows) if device.type == "cuda" and n else None


def _onehot_note(rec: dict) -> str:
    note = f", its bucketed product's operations {rec['mechanism_ops_ms']:.4f} ms"
    return note + (f", scratch {rec['scratch_bytes']} bytes" if rec["scratch_bytes"] is not None else "")


def _run_scatter(dev, gen, idx, t_rows, f, reps, log, skew="uniform") -> List[dict]:
    """The scatter-add probes at one table shape on the indices `idx` (the
    gathers', or skewed ones)."""
    n = idx.shape[0]
    g = torch.randn((n, f), generator=gen, device=dev)
    idx64 = idx.long()
    plain_ms = _time_ms(lambda: scatter_rows_plain(idx, g, t_rows), dev, 1, 3)
    library = lambda: torch.zeros((t_rows, f), dtype=torch.float32, device=dev).index_add_(0, idx64, g)
    library_ms = _time_ms(library, dev, 2, reps)
    library_device_ms = device_ms(library, dev)
    magnitude = scatter_rows_plain(idx, g.abs(), t_rows)
    bound = scatter_bound_ms(n, t_rows, f)
    if log:
        log(f"[scatter] T={t_rows} F={f} N={n} ({skew} indices): plain {plain_ms:.4f} ms, "
            f"index_add_ {library_ms:.4f} ms" + _device_note(library_device_ms))
    probes = (("scatter_onehot", scatter_rows_onehot), ("scatter_blocked", scatter_rows_blocked),
              ("scatter_serial", scatter_rows_serial))
    records = []
    for name, fn in probes:
        want = scatter_rows_plain(idx, g, t_rows, round_bf16=name == "scatter_onehot")
        got = fn(idx, g, t_rows)
        again = fn(idx, g, t_rows)  # the first warm-up launch
        relaunch_equal = torch.equal(got, again)
        if got.dtype != torch.float32 or got.shape != want.shape:
            raise RuntimeError(f"{name} returned {got.dtype} {tuple(got.shape)}")
        diff = (got - want).abs()
        err = float(diff.max()) if n else 0.0
        rel = float((diff / (magnitude + 1e-30)).max()) if n else 0.0
        if not bool((diff <= SCATTER_TOL * magnitude).all()):
            raise RuntimeError(f"{name} differs from its plain version at T={t_rows}, F={f} ({skew} indices): max "
                               f"error over the magnitude of the entry's terms {rel:.3e}")
        if name == "scatter_onehot" and not relaunch_equal:
            raise RuntimeError(f"{name} gave other bits on a second launch at T={t_rows}, F={f} ({skew} indices)")
        ms = _time_ms(lambda: fn(idx, g, t_rows), dev, 1, reps)
        rec = dict(name=name, T=t_rows, F=f, N=n, skew=skew, ms=ms, device_ms=device_ms(lambda: fn(idx, g, t_rows), dev),
                   rows_per_s=n / (ms * 1e-3) if ms else 0.0, max_abs_err=err, max_rel_err=rel,
                   relaunch_equal=relaunch_equal, plain_ms=plain_ms, library_ms=library_ms,
                   library_device_ms=library_device_ms, bound_ms=bound[0], bound_by=bound[1])
        if name == "scatter_onehot":
            rec["mechanism_ops_ms"] = onehot_mechanism_ops_ms(n, f)
            rec["scratch_bytes"] = _scratch_bytes(n, t_rows, dev)
        records.append(rec)
        if log:
            log(f"[scatter]  {name:16s} {skew:7s} {ms:10.4f} ms  {rec['rows_per_s'] / 1e6:10.1f} M rows/s  "
                f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})" + _device_note(rec["device_ms"])
                + (_onehot_note(rec) if name == "scatter_onehot" else "")
                + f"  max err {rel:.2e} of the terms' magnitude, "
                + ("bit-equal on a second launch" if relaunch_equal else "other bits on a second launch"))
    return records


def profile_bucketed(device="cuda", queries: int = NUM_QUERIES, shapes=TABLE_SHAPES, seed: int = 0, reps: int = 5,
                     log: Optional[Callable[[str], None]] = print) -> List[dict]:
    """Where a bucketed probe's time goes (P2, P3, P4), per call, at every
    table shape: the device time of each of its kernels (P4's zero-fill, the
    bucketing pass's count, scan and place, then the product or the
    accumulate) from torch.profiler over `reps` calls, and the host time a
    call takes to return (checks, allocations, launches; no synchronisation),
    the median of 20. Card only: it reads device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_bucketed reads device time: it needs the card")
    gen = torch.Generator(device=dev).manual_seed(seed)
    records = []
    for t_rows, f in shapes:
        table = torch.randn((t_rows, f), generator=gen, device=dev).to(torch.bfloat16)
        idx = torch.randint(0, t_rows, (queries,), generator=gen, device=dev, dtype=torch.int32)
        g = torch.randn((queries, f), generator=gen, device=dev)
        for name, call in (("onehot", lambda: gather_rows_onehot(table, idx)),
                           ("scatter_onehot", lambda: scatter_rows_onehot(idx, g, t_rows)),
                           ("scatter_blocked", lambda: scatter_rows_blocked(idx, g, t_rows))):
            call()
            torch.cuda.synchronize()
            enqueue = []
            for _ in range(20):
                t0 = time.perf_counter()
                call()
                enqueue.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    call()
                torch.cuda.synchronize()
            device_ms = {}
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA:
                    m = re.search(r"(\w+_kernel)(<\d+>)?", e.key)
                    key = m[1] if m else e.key[:60]
                    device_ms[key] = device_ms.get(key, 0.0) + e.self_device_time_total / 1e3 / reps
            rec = dict(name=name, T=t_rows, F=f, N=queries, enqueue_ms=statistics.median(enqueue),
                       device_ms=device_ms, device_total_ms=sum(device_ms.values()))
            records.append(rec)
            if log:
                log(f"[profile] {name:15s} T={t_rows} F={f}: device {rec['device_total_ms']:.4f} ms a call ("
                    + ", ".join(f"{k} {v:.4f}" for k, v in device_ms.items())
                    + f"), host {rec['enqueue_ms']:.4f} ms to return")
    return records


def entrypoint(argv=None) -> List[dict]:
    parser = argparse.ArgumentParser(description="Row-gather and scatter-add probes (coalesced or blocked, one-hot "
                                                 "on the tensor cores, serial)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--queries", type=int, default=NUM_QUERIES)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", default=None, help="write the records to this file")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"[gather] {torch.cuda.get_device_name(device)}")
    records = run(device, args.queries, seed=args.seed)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(records, fh, indent=1)
    return records


if __name__ == "__main__":
    entrypoint()
