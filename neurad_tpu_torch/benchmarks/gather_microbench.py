"""Row-gather probes on the card: `out[i, :] = table[idx[i], :]` by three
hand-written mechanisms (`csrc/gather_probes.cu`), the port's counterpart of
the gather half of `benchmarks/pallas_gather_microbench.py` and
`benchmarks/pallas_gather_microbench2.py`. They answer the hash-grid lookup's
design question on this card: one thread per row, lanes across a row, or the
tensor cores.

  gather_rows_coalesced  <- `make_vmem_gather`   lanes across a row, a block of queries at once
  gather_rows_onehot     <- `make_onehot_gather` onehot(idx) @ table on the tensor cores, fp32 result
  gather_rows_serial     <- `make_scalar_gather` one thread copies one row

All three share one plain version, `gather_rows_plain` (`table[idx]`), taken
for CPU tensors; CUDA tensors go to the kernels or raise. The coalesced and
serial gathers equal the plain version bit for bit, the one-hot gather equals
it as fp32. Launches are counted in `coalesced_launches`, `onehot_launches`,
`serial_launches`.

    python -m neurad_tpu_torch.benchmarks.gather_microbench [--device cuda] [--queries 1048576]

prints, per table shape (T rows x F bf16 columns), each kernel's time (CUDA
events: median of 10 launches after 2 warm-ups) and rate in M rows/s, beside
`torch.index_select` (a yardstick that no path of the port calls) and the
least time the card could take for the function (its bytes over the memory
rate, for all three: a gather does no arithmetic). The one-hot product's own
2 * N * T * F operations over the bf16 tensor-core rate are printed beside it
as `mechanism_ops_ms`: the cost of that mechanism, not of the function. On the
CPU (`--device cpu`) the plain version runs, timed on the host clock.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.ops import _build

# (rows, bf16 columns): 256 KB, 4 MB, 8 MB and 32 MB tables
TABLE_SHAPES = ((16384, 8), (65536, 32), (131072, 32), (524288, 32))
NUM_QUERIES = 1 << 20
ONEHOT_MAX_ROWS = 131072  # the dense product's cost grows with T: larger tables are left out
# H100 SXM data-sheet peaks: HBM3 bandwidth, dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12
PEAK_BF16_OPS = 989e12

coalesced_launches = 0
onehot_launches = 0
serial_launches = 0


def reset_launch_counts() -> None:
    global coalesced_launches, onehot_launches, serial_launches
    coalesced_launches = onehot_launches = serial_launches = 0


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


def _launch(fn_name: str, table: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    lib = _build.load("gather_probes")
    with torch.cuda.device(table.device):
        err = getattr(lib, fn_name)(table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], table.shape[0],
                                    table.shape[1], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {err} (T={table.shape[0]}, F={table.shape[1]})")
    return out


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
    coalesced_launches += 1
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
    serial_launches += 1
    return out


def gather_rows_onehot(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] as onehot(idx) @ table on the tensor cores: bf16 inputs, fp32
    sum and result [N, F]. F is 8, 16 or 32."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx).float()
    if table.shape[1] not in (8, 16, 32):
        raise ValueError("the one-hot gather takes 8, 16 or 32 columns")
    global onehot_launches
    out = _launch("gather_rows_onehot", table, idx, torch.empty((idx.shape[0], table.shape[1]),
                                                                dtype=torch.float32, device=table.device))
    onehot_launches += 1
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


def onehot_mechanism_ops_ms(n: int, t_rows: int, f: int) -> float:
    """What the one-hot gather's mechanism costs at the least: the dense
    product's 2 * N * T * F operations at the bf16 tensor-core peak. Not the
    function's bound (`bounds_ms`): the function needs none of them."""
    return 2.0 * n * t_rows * f / PEAK_BF16_OPS * 1e3


def run(device="cuda", queries: int = NUM_QUERIES, shapes=TABLE_SHAPES, seed: int = 0, reps: int = 10,
        log: Optional[Callable[[str], None]] = print) -> List[dict]:
    """Check and time every probe at every table shape. Returns one record per
    (shape, probe): name, T, F, ms, rows_per_s, max_abs_err against the plain
    version, plain_ms, library_ms (`torch.index_select`), bound_ms, bound_by;
    the one-hot gather's records also hold mechanism_ops_ms."""
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
        bound = bounds_ms(queries, t_rows, f)
        if log:
            log(f"[gather] T={t_rows} F={f} N={queries}: table[idx] {plain_ms:.4f} ms, index_select {library_ms:.4f} ms")
        for name, fn in probes:
            if name == "onehot" and t_rows > ONEHOT_MAX_ROWS:
                continue
            got = fn(table, idx)
            want = ref.float() if name == "onehot" else ref
            if got.dtype != want.dtype or got.shape != want.shape:
                raise RuntimeError(f"{name} gather returned {got.dtype} {tuple(got.shape)}")
            err = float((got.float() - want.float()).abs().max()) if queries else 0.0
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} gather differs from table[idx] at T={t_rows}, F={f}: max abs err {err}")
            ms = _time_ms(lambda: fn(table, idx), dev, 2, reps)
            rec = dict(name=name, T=t_rows, F=f, N=queries, ms=ms, rows_per_s=queries / (ms * 1e-3) if ms else 0.0,
                       max_abs_err=err, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound[name][0],
                       bound_by=bound[name][1])
            if name == "onehot":
                rec["mechanism_ops_ms"] = onehot_mechanism_ops_ms(queries, t_rows, f)
            records.append(rec)
            if log:
                log(f"[gather]   {name:10s} {ms:10.4f} ms  {rec['rows_per_s'] / 1e6:10.1f} M rows/s  "
                    f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                    + (f", its dense product's operations {rec['mechanism_ops_ms']:.4f} ms" if name == "onehot" else "")
                    + "  exact")
    return records


def entrypoint(argv=None) -> List[dict]:
    parser = argparse.ArgumentParser(description="Row-gather probes (coalesced, one-hot on tensor cores, serial)")
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
