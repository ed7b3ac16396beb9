"""The command's behaviour without a card, the correctness check at a tiny
size on the CPU, and the check failing where the timed path is broken."""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

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
    """The pipeline's render returns an image with one block of pixels wrong."""
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline

    for cls in (ADPipeline, SplatADPipeline):
        original = cls.render_eval_camera

        def altered(self, *args, _original=original, **kwargs):
            rgb, gt = _original(self, *args, **kwargs)
            rgb = np.array(rgb)
            rgb[:16, :16] = 1.0 - rgb[:16, :16]
            return rgb, gt

        monkeypatch.setattr(cls, "render_eval_camera", altered)
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
    """The step computes its loss and leaves the parameters as they were."""
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline

    def unchanged(self, state, bundle, batch, draws=None):
        draws = self.draw(state.generator, bundle.origins.shape[0]) if draws is None else draws
        total, metrics = self.loss_fn(bundle, batch, draws)
        state.step += 1
        return state, dict(metrics, total_loss=total.detach())

    monkeypatch.setattr(ADPipeline, "train_step", unchanged)
    assert not _correct(tiny.cell(workload), _run(workload))


@pytest.mark.parametrize("workload", TRAIN)
def test_half_of_the_batch_left_out_fails(workload, monkeypatch):
    """The step takes the loss of the first half of the camera patches and of
    the lidar rays, the mean over them."""
    from neurad_tpu_torch.core.structs import map_tensors
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline

    original = ADPipeline.train_step

    def half(self, state, bundle, batch, draws=None):
        n_cam, n, per = self.num_cam_rays, bundle.origins.shape[0], self.patch_size[0] * self.patch_size[1]
        cam, lid = n_cam // 2 // per * per, (n - n_cam) // 2
        rows = torch.cat([torch.arange(cam), torch.arange(n_cam, n_cam + lid)])
        bundle = map_tensors(lambda x: x[rows], bundle)
        batch = {k: (v[: cam // per] if k == "image" else v[:lid]) for k, v in batch.items()}
        full, self.num_cam_rays = self.num_cam_rays, cam
        try:
            return original(self, state, bundle, batch)
        finally:
            self.num_cam_rays = full

    monkeypatch.setattr(ADPipeline, "train_step", half)
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
