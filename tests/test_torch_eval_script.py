"""The port's eval script (`scripts/eval.py`) on a run directory of its
train script, and the train loop's periodic eval (`steps_per_eval_batch`,
as in the JAX presets)."""

import json

import numpy as np
import pytest
import torch

from neurad_tpu.configs import method_configs as JMC
from neurad_tpu_torch.configs import method_configs as TMC
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline as TSPipe
from neurad_tpu_torch.scripts import eval as TEval
from neurad_tpu_torch.scripts import train as TTrain

from test_torch_eval_pipelines import SPLATAD_EVAL_KEYS, SPLATAD_FID_KEYS, SPLIT, no_weight_files  # noqa: F401

torch.set_num_threads(1)

TINY = dict(SPLIT, image_height=24, image_width=32)


def test_presets_take_the_jax_eval_intervals():
    for name in TMC.METHODS:
        assert TMC.METHODS[name]().trainer.steps_per_eval_batch == \
            JMC.get_method_config(name).trainer.steps_per_eval_batch, name


def test_eval_script_on_a_run_directory(tmp_path, no_weight_files):
    """On a CPU run directory written by the train script the JSON holds the
    checkpoint's step and the result keys of JAX's SplatAD `eval_metrics`
    (and, with --fid, of its FID suite; both held in
    tests/test_torch_eval_pipelines.py)."""
    argv = ["splatad-tiny", "--device", "cpu", "--max-iterations", "2", "--output-dir", str(tmp_path),
            "--experiment-name", "r"] + [a for k, v in TINY.items() for a in ("--dp-set", f"{k}={v}")]
    TTrain.entrypoint(argv)
    res = TEval.entrypoint([str(tmp_path / "r"), "--device", "cpu"])
    assert json.loads((tmp_path / "r" / "eval.json").read_text()) == res
    assert res["checkpoint_step"] == 2 and set(res["results"]) == SPLATAD_EVAL_KEYS
    assert all(np.isfinite(v) for v in res["results"].values())
    out = tmp_path / "with_fid.json"
    res = TEval.entrypoint([str(tmp_path / "r"), "--device", "cpu", "--fid", "--fid-max-images", "2",
                            "--output", str(out)])
    assert json.loads(out.read_text()) == res and set(res["results"]) == SPLATAD_EVAL_KEYS | SPLATAD_FID_KEYS


def test_eval_script_needs_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEval.entrypoint([str(tmp_path / "no-such-run")])


def test_train_loop_runs_the_eval_every_steps_per_eval_batch(tmp_path, monkeypatch, no_weight_files):
    cfg = TMC.METHODS["splatad-tiny"]()
    tp = TSPipe(TSynth(**TINY).setup().get_dataparser_outputs(), cfg.pipeline, device="cpu")
    calls = []
    real = tp.eval_metrics
    monkeypatch.setattr(tp, "eval_metrics", lambda: calls.append(1) or real())
    trainer = TMC.TrainerConfig(max_num_iterations=5, steps_per_save=10**9, steps_per_log=10**9,
                                steps_per_eval_batch=2)
    state, history = TTrain.train_loop(tp, tp.init_state(), trainer, tmp_path)
    assert state.step == 5 and len(calls) == 2  # steps 2 and 4, not 0
    evals = [h for h in history if any(k.startswith("eval/") for k in h)]
    assert len(evals) == 2 and all(set(h) == {f"eval/{k}" for k in SPLATAD_EVAL_KEYS} for h in evals)
    assert len(history) == 4  # steps 0 and 4 (the first and the last), and the two evals
