"""The benchmark of `neurad_tpu_torch`, the PyTorch and CUDA port, on NVIDIA GPUs.

One command runs one cell once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

and prints, as the last line of its standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics`, `device` (and `breakdown` with
`--trace 1`). With `--trace 0` the metrics are the cell's end-to-end metrics
(`BENCHMARK.json`'s `end_to_end`), with `--trace 1` its per-layer metrics
(`per_layer`), read from a `torch.profiler` trace of the measured window. The
numbers that decide `correct` come last in the line (`checks`), each beside
its limit, and again as the last lines of standard error.

Cells (`BENCHMARK.json`'s `workloads`), one GPU each:

    neurad.sim-camera    NeuRAD (the `neurad-parity` preset) served to a closed-loop simulator, 1920x1080 frames
    neurad.train         NeuRAD trained on the published batches of 57,344 rays, from step 0
    splatad.sim-camera   SplatAD at 5,000,000 gaussians served, the same traffic as neurad.sim-camera

Without a CUDA device, or with fewer devices than the cell asks for, the
command prints no result and exits with a code other than 0: it never falls
back to the CPU.

Everything is found by name, so a cell, a configuration, a traffic mix or a
metric is added with files and entries, without editing a file that is here:

    portbench/configs/<config>.json     a model configuration: its `family`
                                        (a module `portbench/families/<family>.py`
                                        that builds the port's system and the
                                        plain reference), the preset, the scene,
                                        the widths its FLOPs are counted from and
                                        the weights' recipe
    portbench/traffic/<traffic>.json    a traffic mix: its `kind` (a driver
                                        `portbench/drivers/<kind>.py`:
                                        `closed_loop`, `train`) and its parameters
    portbench/limits/<cell>.json        the limit of each number the cell's
                                        `correct` compares
    portbench/metrics/<metric>.py       a per-layer metric: `read(trace)` returns
                                        its value, or None where the trace holds
                                        nothing for it; `install(records)`, where
                                        present, wraps what it counts before the
                                        window opens (traced runs only). A metric
                                        `<name>.<part>` without a file of its own
                                        is read by `<name>.py`, and an end-to-end
                                        metric `<name>.<part>` takes the driver's
                                        `<name>` (one entry, with its own bound,
                                        for each family's cells)
    portbench/tests/by_family/<family>.py
                                        the family's part of the CPU tests:
                                        `tiny(config)` (the configuration at a
                                        size a CPU runs in seconds), `LIMITS`
                                        ({cell: {number: limit}} where the full
                                        size's do not hold there) and the port
                                        faults the tests plant, functions of
                                        pytest's `monkeypatch`: `answer_altered`
                                        for a family that serves,
                                        `step_unchanged` and `half_batch` for
                                        one that trains; a cell whose family
                                        lacks one fails the tests

A family that trains provides the entry points that `drivers/train.py`'s
docstring lists. The reference that its `reference_train` returns has
`step(sampler_state, generator_state)`, `first_moments()` and `changes()`,
and honours `fault = "half"` (the mean loss of half the batch), which the
driver's `FAULTS` puts in the port's place in the control's readings.

A cell is an entry of `workloads` that names a configuration and a traffic
mix; a metric is an entry of `end_to_end` or `per_layer`. The plain
reference that decides `correct` lives in `portbench/reference/` and imports
nothing of the port (`portbench/tests/test_portbench_witness.py` holds it
against the JAX package on the CPU; no run imports that file); `portbench/controls/readings.py` reads the program's and
the control's numbers that each limit was set from (on the GPU), and
`portbench/tests/` holds the CPU tests (`python3 -m pytest portbench/tests`).
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()  # set-up is timed from the start of the process

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3  # glibc's mallopt parameters
HEAP_MMAP_THRESHOLD = 32 * 2**20  # glibc's largest on 64 bits; a 1920x1080 fp32 frame (25 MB) lies under it
HEAP_TRIM_THRESHOLD = 2**30


def steady_host_heap() -> bool:
    """One allocation policy of glibc's for the whole run: blocks under 32 MiB
    come from the heap, and the heap keeps what is freed (up to 1 GiB at its
    top). Left alone, glibc moves both thresholds with the first large block a
    process frees, so whether a served frame's host copy reused memory (2.2-2.6
    ms for 25 MB on the H100's host) or got new memory (11-13 ms) was settled
    per process, and the p90 of a run sat on one of two levels. False where the
    C library takes no such setting (not glibc)."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
        return bool(libc.mallopt(M_MMAP_THRESHOLD, HEAP_MMAP_THRESHOLD)
                    and libc.mallopt(M_TRIM_THRESHOLD, HEAP_TRIM_THRESHOLD))
    except (OSError, AttributeError):
        return False


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no library loads JAX; the
    host heap's policy fixed before anything is allocated."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    steady_host_heap()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run one cell of the port's benchmark once")
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json's workloads")
    parser.add_argument("--seed", type=int, required=True, help="seeds the traffic and the weights")
    parser.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: per-layer metrics from a trace")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    _environment()
    from portbench.harness import cell

    return cell.main(args, started=STARTED)


if __name__ == "__main__":
    sys.exit(main())
