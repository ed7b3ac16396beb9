"""Family `splatad` in the CPU tests: its tiny sizes, and the serve fault
planted in `SplatADPipeline`. The full size's limits hold at the tiny one."""

from __future__ import annotations

from portbench.tests.by_family import invert_block


def tiny(c: dict) -> dict:
    """4,096 gaussians, 64 slots a tile."""
    c["serve"] = {"cap_max": 4096, "model": {"max_per_tile": 64}}
    return c


LIMITS: dict = {}


def answer_altered(monkeypatch) -> None:
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline

    invert_block(monkeypatch, SplatADPipeline)
