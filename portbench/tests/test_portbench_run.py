"""The command's behaviour without a card, the correctness check at a tiny
size on the CPU, and the check failing where the timed path is broken."""

from __future__ import annotations

import subprocess
import sys
import time

import pytest

from portbench.controls import readings as R
from portbench.harness import cell as C
from portbench.harness import spec as S
from portbench.tests import tiny

CELLS = [w["name"] for w in S.benchmark()["workloads"]]
SERVE = [c for c in CELLS if S.load(c).traffic["kind"] == "closed_loop"]
TRAIN = [c for c in CELLS if S.load(c).traffic["kind"] == "train"]
SEED = 2**31 + 11  # seeds may pass 32 signed bits


def _run(workload: str, seed: int = SEED, seconds: float = 0.6):
    return C.run_cell(tiny.cell(workload), seed=seed, seconds=seconds, trace=False, device="cpu",
                      started=time.perf_counter())


def _correct(cell, outcome) -> bool:
    return C.result_line(cell, outcome, False, {})["correct"]


def test_without_a_card_the_command_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=S.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_an_unknown_cell_fails():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nothing.here", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=S.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_passes_at_a_tiny_size(workload):
    outcome = _run(workload)
    assert outcome["attempted"] > 0 and outcome["failed"] == 0
    reported = {m["name"] for m in S.load(workload).end_to_end}
    assert all(S.driver_value(outcome["end_to_end"], name) is not None for name in reported)
    assert _correct(tiny.cell(workload), outcome), outcome["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_a_tiny_size(workload):
    """The control (the reference one precision down) and each planted fault
    in the port's place read above a limit; the port reads below them all."""
    cell = tiny.cell(workload)
    out = R.readings(cell, [SEED, 3], 1, 0.4, "cpu", log=lambda _: None)
    limits = cell.limits
    assert all(out["lower"][n] <= limits[n] for n in limits)
    for upper in out["upper"].values():
        assert any(upper[n] > limits[n] for n in limits)


@pytest.mark.parametrize("workload", SERVE)
def test_an_answer_altered_where_it_is_produced_fails(workload, monkeypatch):
    """The pipeline's render returns an image with one block of pixels wrong
    (the family's `answer_altered`)."""
    tiny.fault(workload, "answer_altered")(monkeypatch)
    assert not _correct(tiny.cell(workload), _run(workload))


@pytest.mark.parametrize("workload", SERVE)
def test_actors_left_unmoved_fail(workload, monkeypatch):
    """The server takes `update_actors` and leaves the actors where they were:
    the pixels in the actors' boxes (`actor_rgb_rmse`) of the window's last
    request that moved them differ."""
    from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState

    monkeypatch.setattr(ClosedLoopState, "update_actors", lambda self, actors: None)
    assert not _correct(tiny.cell(workload), _run(workload))


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_returns_its_state_unchanged_fails(workload, monkeypatch):
    """The step computes its loss and leaves the parameters as they were (the
    family's `step_unchanged`)."""
    tiny.fault(workload, "step_unchanged")(monkeypatch)
    assert not _correct(tiny.cell(workload), _run(workload))


@pytest.mark.parametrize("workload", TRAIN)
def test_half_of_the_batch_left_out_fails(workload, monkeypatch):
    """The step takes the mean loss of half of the batch (the family's
    `half_batch`)."""
    tiny.fault(workload, "half_batch")(monkeypatch)
    assert not _correct(tiny.cell(workload), _run(workload))


def test_a_traced_run_reads_its_layers_on_the_cpu():
    """The traced path end to end; the CPU has no device operations, so the
    device's readers report nothing there but the spans are counted."""
    outcome = C.run_cell(tiny.cell(CELLS[0]), seed=SEED, seconds=0.4, trace=True, device="cpu",
                         started=time.perf_counter())
    assert outcome["window_s"] > 0 and "breakdown" in outcome
    assert set(outcome["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_on_the_card(workload):
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(SEED),
                          "--seconds", "5", "--trace", "0"], cwd=S.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
