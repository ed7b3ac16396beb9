"""The training front end of the port (`engine/{trainer,callbacks,schedulers,
optimizers}.py`, `utils/{writer,profiler}.py`, `plugins/registry.py`,
`configs/{method_configs,external_methods}.py`, `scripts/train.py`) against
the JAX package's: the schedules and `optax.MultiSteps` on the same numbers,
the trainer's cases as `tests/engine/test_trainer.py` has them, the plugin
registry as `tests/plugins/test_registry.py` has it, and every preset's
trainer, optimizer-group and datamanager values.

Tolerances: schedules to 1e-6 relative (the port computes in double, optax in
fp32); parameters after `optax.MultiSteps` to 1e-6 relative plus 1e-7
absolute (optax takes Adam's bias corrections in fp32, torch in double).
"""

import copy
import dataclasses
import itertools
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurad_tpu.configs import method_configs as JMC
from neurad_tpu.engine import optimizers as JO
from neurad_tpu.engine import schedulers as JS
from neurad_tpu_torch.configs import method_configs as TMC
from neurad_tpu_torch.engine import optimizers as TO
from neurad_tpu_torch.engine import schedulers as TS
from neurad_tpu_torch.engine.callbacks import TrainingCallback, TrainingCallbackLocation
from neurad_tpu_torch.engine.trainer import MetricTracker, MetricTrackerConfig, Trainer, TrainerConfig
from neurad_tpu_torch.plugins import registry
from neurad_tpu_torch.scripts import train as TTrain
from neurad_tpu_torch.utils import profiler, writer

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("multistep_schedule", dict(lr_init=1e-2, milestones=(10, 50, 200), gamma=0.33)),
    ("multistep_schedule", dict(lr_init=5e-3)),
    ("cosine_decay_schedule", dict(lr_init=1e-2, warm_up_end=20, learning_rate_alpha=0.05, max_steps=300)),
    ("cosine_decay_schedule", dict(lr_init=3e-4, warm_up_end=0, max_steps=100)),
    ("exponential_decay_schedule", dict(lr_init=1e-2, lr_final=1e-4, max_steps=300, warmup_steps=20)),
])
def test_schedules_match_jax(name, args):
    want, got = getattr(JS, name)(**args), getattr(TS, name)(**args)
    for step in [0, 1, 5, 9, 10, 11, 19, 20, 21, 49, 50, 150, 199, 200, 299, 300, 400, 10**7]:
        w, g = float(want(step)), got(step)
        assert isinstance(g, float)
        assert abs(g - w) <= 1e-6 * abs(w) + 1e-12, (name, step, g, w)


class _TwoGroups(torch.nn.Module):
    def __init__(self, fields, camera):
        super().__init__()
        self.fields = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.from_numpy(fields.copy()))})
        self.camera_opt = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.from_numpy(camera.copy()))})


@pytest.mark.parametrize("k", [2, 3])
def test_accum_steps_match_optax_multisteps(k):
    """The camera group accumulates k gradients (with AdamW decay, clipping
    and a warm-up schedule inside); the fields group steps every call. Over
    2k steps of the same gradients the parameters match optax's."""
    rng = np.random.default_rng(k)
    fields, camera = rng.normal(size=(5,)).astype(np.float32), rng.normal(size=(4, 6)).astype(np.float32)
    groups = dict(fields=dict(lr=1e-2, warmup_steps=0),
                  camera_opt=dict(lr=5e-3, lr_final=1e-4, max_steps=10, warmup_steps=2, weight_decay=1e-2,
                                  max_norm=0.5, accum_steps=k))
    rules = (("camera_opt", "camera_opt"),)
    jparams = {"fields": {"w": jnp.asarray(fields)}, "camera_opt": {"w": jnp.asarray(camera)}}
    tx, st = JO.build_optimizer(jparams, {g: JO.OptimizerGroupConfig(**v) for g, v in groups.items()}, rules=rules)
    module = _TwoGroups(fields, camera)
    opt = TO.Optimizers(module.named_parameters(), {g: TO.OptimizerGroupConfig(**v) for g, v in groups.items()},
                        rules)
    assert opt.labels == {"fields.w": "fields", "camera_opt.w": "camera_opt"}
    update = jax.jit(tx.update)
    for step in range(2 * k):
        gf, gc = rng.normal(size=fields.shape).astype(np.float32), rng.normal(size=camera.shape).astype(np.float32)
        updates, st = update({"fields": {"w": jnp.asarray(gf)}, "camera_opt": {"w": jnp.asarray(gc)}}, st, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = module.camera_opt["w"].detach().clone()
        opt.zero_grad()
        module.fields["w"].grad, module.camera_opt["w"].grad = torch.from_numpy(gf), torch.from_numpy(gc)
        opt.step()
        moved = not torch.equal(before, module.camera_opt["w"].detach())
        assert moved == ((step + 1) % k == 0), step  # the group moves on every k-th call only
        for got, want in ((module.fields["w"], jparams["fields"]["w"]), (module.camera_opt["w"], jparams["camera_opt"]["w"])):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert opt.count == 2 * k and opt.updates == {"fields": 2 * k, "camera_opt": 2}
    lrs = opt.learning_rates()
    assert lrs["camera_opt"] == TO.OptimizerGroupConfig(**groups["camera_opt"]).schedule()(2)

    # the accumulator rides the state dict: a copy loaded mid-window goes on exactly as the original
    opt.zero_grad()
    module.fields["w"].grad, module.camera_opt["w"].grad = torch.ones(5), torch.ones(4, 6)
    opt.step()
    twin = _TwoGroups(module.fields["w"].detach().numpy(), module.camera_opt["w"].detach().numpy())
    topt = TO.Optimizers(twin.named_parameters(), {g: TO.OptimizerGroupConfig(**v) for g, v in groups.items()},
                         rules)
    topt.load_state_dict(copy.deepcopy(opt.state_dict()))  # as a checkpoint holds it: no shared tensors
    for m, o in ((module, opt), (twin, topt)):
        for _ in range(k - 1):
            o.zero_grad()
            m.fields["w"].grad, m.camera_opt["w"].grad = torch.full((5,), 0.5), torch.full((4, 6), -0.5)
            o.step()
    torch.testing.assert_close(twin.camera_opt["w"], module.camera_opt["w"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the trainer (cases of tests/engine/test_trainer.py)
# ---------------------------------------------------------------------------


class FakePipeline:
    """A pipeline's interface to the trainer: a quadratic in one parameter,
    checkpoints as files holding the step and the parameter."""

    device = torch.device("cpu")

    def __init__(self, evals=None):
        self.w = torch.nn.Parameter(torch.ones(2))
        self.evals = evals

    def train_step(self, state, *args):
        loss = torch.sum(self.w**2)
        self.w.grad = None
        loss.backward()
        with torch.no_grad():
            self.w -= 0.1 * self.w.grad
        state.step += 1
        return state, {"total_loss": loss.detach()}

    def eval_metrics(self):
        return next(self.evals)

    def save_checkpoint(self, state, checkpoint_dir):
        path = Path(checkpoint_dir) / f"step-{state.step:09d}.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"step": state.step, "w": self.w.detach().clone()}, path)
        return path

    def load_checkpoint(self, checkpoint_dir, state):
        ckpt = torch.load(sorted(Path(checkpoint_dir).glob("step-*.pt"))[-1], weights_only=True)
        with torch.no_grad():
            self.w.copy_(ckpt["w"])
        state.step = ckpt["step"]
        return state


def _batches(n_rays=4):
    return itertools.repeat(((), n_rays))


def test_trainer_loop_and_checkpoint(tmp_path):
    cfg = TrainerConfig(max_num_iterations=20, steps_per_eval_batch=10**9, steps_per_save=10, steps_per_log=5,
                        checkpoint_dir=str(tmp_path / "ckpts"))
    p = FakePipeline()
    trainer = Trainer(p, types.SimpleNamespace(step=0), cfg, batches=_batches())
    metrics = trainer.train()
    assert "total_loss" in metrics and metrics["train_rays_per_sec"] > 0
    assert len(trainer.history) == 5  # steps 0, 5, 10, 15 and the last, 19
    assert sorted(f.name for f in (tmp_path / "ckpts").iterdir()) == ["step-000000011.pt", "step-000000020.pt"]
    fresh = FakePipeline()
    t2 = Trainer(fresh, types.SimpleNamespace(step=0), cfg, batches=_batches())
    t2.load_checkpoint()
    assert t2.state.step == 20
    torch.testing.assert_close(fresh.w, p.w, rtol=0, atol=0)


def test_metric_tracker_semantics():
    t = MetricTracker(MetricTrackerConfig(metric="psnr", higher_is_better=True, margin=0.1))
    t.update({"psnr": 20.0})
    assert not t.did_degrade()
    t.update({"psnr": 19.0})  # within 10% of the best, 20
    assert not t.did_degrade()
    t.update({"psnr": 15.0})  # below 18
    assert t.did_degrade()
    t.update({"psnr": 25.0})  # a new best
    assert not t.did_degrade()
    t2 = MetricTracker(MetricTrackerConfig(metric="loss", higher_is_better=False, margin=0.1))
    t2.update({"loss": 1.0})
    t2.update({"loss": 1.05})
    assert not t2.did_degrade()
    t2.update({"loss": 1.5})
    assert t2.did_degrade()
    off = MetricTracker(MetricTrackerConfig())
    off.update({"psnr": 1.0})
    assert off.latest is None and not off.did_degrade() and off.did_degrade(fallback=True)


def test_early_stopping_and_gated_checkpoints(tmp_path):
    """Evals at 5 (20.0), 10 (5.0: degraded once), 15 (5.0: twice) -> stop at
    15 with a save; the periodic save at 10, after a degraded eval, is
    skipped."""
    evals = itertools.chain([{"psnr": 20.0}], itertools.repeat({"psnr": 5.0}))
    cfg = TrainerConfig(max_num_iterations=100, steps_per_eval_batch=5, steps_per_save=5, steps_per_log=50,
                        checkpoint_dir=str(tmp_path), keep_last_n_checkpoints=5,
                        save_only_on_improvement_tracker=MetricTrackerConfig(metric="psnr", margin=0.1),
                        early_stopping_tracker=MetricTrackerConfig(metric="psnr", margin=0.1),
                        early_stop_patience=2)
    tr = Trainer(FakePipeline(evals), types.SimpleNamespace(step=0), cfg, batches=_batches())
    metrics = tr.train()
    assert metrics["early_stopped_at"] == 15.0 and metrics["eval/psnr"] == 5.0
    assert tr.state.step == 16
    # saves: step 5 (after a good eval), not 10 (degraded), the forced one at 15 (state.step 16)
    assert sorted(f.name for f in tmp_path.iterdir()) == ["step-000000006.pt", "step-000000016.pt"]


def test_keep_last_n_checkpoints(tmp_path):
    cfg = TrainerConfig(max_num_iterations=7, steps_per_eval_batch=10**9, steps_per_save=1, steps_per_log=100,
                        checkpoint_dir=str(tmp_path), keep_last_n_checkpoints=3)
    Trainer(FakePipeline(), types.SimpleNamespace(step=0), cfg, batches=_batches()).train()
    assert sorted(f.name for f in tmp_path.iterdir()) == [f"step-00000000{i}.pt" for i in (5, 6, 7)]


def test_training_callbacks_locations():
    calls = []
    cbs = [
        TrainingCallback((TrainingCallbackLocation.BEFORE_TRAIN_ITERATION,), lambda s, i: calls.append(("b", i)),
                         update_every_num_iters=2),
        TrainingCallback((TrainingCallbackLocation.AFTER_TRAIN_ITERATION,), lambda s, i: calls.append(("a", i)),
                         iters=(1, 3)),
        TrainingCallback((TrainingCallbackLocation.AFTER_TRAIN,), lambda s, i: calls.append(("e", i))),
        # a callback may hand back a new state
        TrainingCallback((TrainingCallbackLocation.AFTER_TRAIN_ITERATION,),
                         lambda s, i: types.SimpleNamespace(step=s.step, seen=i), iters=(2,)),
    ]
    cfg = TrainerConfig(max_num_iterations=4, steps_per_log=100, steps_per_save=10**9)
    tr = Trainer(FakePipeline(), types.SimpleNamespace(step=0), cfg, eval_fn=None, callbacks=cbs, batches=_batches())
    tr.train()
    assert ("b", 0) in calls and ("b", 2) in calls and ("b", 1) not in calls
    assert ("a", 1) in calls and ("a", 3) in calls and ("a", 0) not in calls
    assert ("e", 4) in calls and tr.state.seen == 2 and tr.state.step == 4


def test_checkpoint_roundtrip_with_rng_and_host_state(tmp_path):
    """The train script's run on the CPU through `Trainer`, nerfacto-lidar at
    a few rays a batch: checkpoints every step, two kept; a resume from the
    run directory continues with the sampler and the step generator where
    they stopped, to the parameters of an uninterrupted run. The batches come
    from `next_train` (prefetch 0): the sampler threads' batches arrive in
    the order the threads finish them, which no run repeats."""
    narrow = ["--device", "cpu", "--output-dir", str(tmp_path), "--set", "trainer.steps_per_save=1",
              "--set", "trainer.steps_per_log=1", "--set", "pipeline.datamanager.num_cam_patches=1",
              "--set", "pipeline.datamanager.num_lidar_rays=16", "--set", "pipeline.datamanager.prefetch=0",
              "--dp-set", "num_frames=3", "--dp-set", "image_height=24", "--dp-set", "image_width=36"]
    _, state = TTrain.entrypoint(["nerfacto-lidar", "--max-iterations", "3", "--experiment-name", "run", *narrow])
    run = tmp_path / "run"
    assert state.step == 3
    assert sorted(f.name for f in (run / "checkpoints").iterdir()) == ["step-000000002.pt", "step-000000003.pt"]
    assert list((run / "tb").iterdir()), "TensorBoard event files"
    # the run directory rebuilds the pipeline; the trainer's settings come from the command line
    resumed, rstate = TTrain.entrypoint(["nerfacto-lidar", "--device", "cpu", "--load-dir", str(run),
                                         "--max-iterations", "5", "--set", "trainer.steps_per_save=1"])
    straight, sstate = TTrain.entrypoint(["nerfacto-lidar", "--max-iterations", "5", "--experiment-name", "straight",
                                          *narrow])
    assert rstate.step == sstate.step == 5
    assert sorted(f.name for f in (run / "checkpoints").iterdir()) == ["step-000000004.pt", "step-000000005.pt"]
    for (name, p), q in zip(straight.model.named_parameters(), resumed.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------------------
# writers and profiler
# ---------------------------------------------------------------------------


def test_writers(tmp_path, capsys):
    local = writer.LocalWriter()
    local.write_scalars(3, {"loss": 0.25, "n": 7, "_hidden": 1.0})
    assert capsys.readouterr().out == "[train] step=3 loss=0.25 n=7\n"
    tb = writer.TensorboardWriter(str(tmp_path / "tb"))
    multi = writer.MultiWriter([writer.LocalWriter(keys=["loss"]), tb])
    multi.write_scalars(4, {"loss": 0.5, "psnr": 20.0})
    multi.write_image(4, "rgb", np.zeros((4, 5, 3), np.float32))
    multi.close()
    assert capsys.readouterr().out == "[train] step=4 loss=0.5\n"
    assert len(list((tmp_path / "tb").glob("events.out.tfevents.*"))) == 1
    with pytest.raises(NotImplementedError):
        writer.Writer().write_scalars(0, {})


def test_train_script_says_when_tensorboard_does_not_import(tmp_path, monkeypatch, capsys):
    def refuse(log_dir):
        raise ImportError("No module named 'tensorboard'")

    monkeypatch.setattr(TTrain, "TensorboardWriter", refuse)
    w = TTrain.make_writer(tmp_path)
    assert [type(x) for x in w.writers] == [writer.LocalWriter]
    assert "TensorBoard is not written" in capsys.readouterr().out


def test_profiler(tmp_path):
    @profiler.time_function
    def f(x):
        return x + 1

    f(1), f(2)
    with profiler.time_function(name="block"):
        pass
    means = profiler.flush_profiler()
    assert means["test_profiler.<locals>.f"] >= 0 and "block" in means
    with profiler.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").exists() and prof.key_averages()
    json.loads((tmp_path / "trace" / "trace.json").read_text())


# ---------------------------------------------------------------------------
# plugins (cases of tests/plugins/test_registry.py)
# ---------------------------------------------------------------------------


def test_env_var_discovery(monkeypatch):
    mod = types.ModuleType("fake_torch_plugin_mod")
    mod.make_config = lambda: "fake-method-config"
    monkeypatch.setitem(sys.modules, "fake_torch_plugin_mod", mod)
    monkeypatch.setenv(registry.METHOD_ENV_VAR, "my-method=fake_torch_plugin_mod:make_config")
    assert registry.METHOD_ENV_VAR == "NEURAD_TPU_TORCH_METHOD_CONFIGS"
    methods = registry.discover_methods()
    assert methods["my-method"]() == "fake-method-config"


def test_bad_env_spec_does_not_crash(monkeypatch, capsys):
    monkeypatch.setenv(registry.METHOD_ENV_VAR, "broken=not_a_module:nope, ,also-broken=json:no_such_function")
    methods = registry.discover_methods()
    assert "broken" not in methods and "also-broken" not in methods
    assert capsys.readouterr().out.count("[plugins] failed to load") == 2
    assert registry.discover_dataparsers() == {}


def test_register_into_main_registry(monkeypatch):
    mod = types.ModuleType("fake_torch_plugin_mod2")

    def factory():
        cfg = TMC.get_method_config("splatad-tiny")
        cfg.method_name = "plugin-method"
        return cfg

    mod.factory = factory
    monkeypatch.setitem(sys.modules, "fake_torch_plugin_mod2", mod)
    monkeypatch.setenv(registry.METHOD_ENV_VAR, "plugin-method=fake_torch_plugin_mod2:factory")
    registry.register_discovered_methods()
    try:
        assert TMC.get_method_config("plugin-method").method_name == "plugin-method"
    finally:
        TMC.METHODS.pop("plugin-method")


def test_external_methods_give_install_instructions():
    with pytest.raises(KeyError, match="pip install git\\+https://github.com/carlinds/unisim"):
        TMC.get_method_config("unisim")
    with pytest.raises(KeyError, match="unknown method 'no-such-method'"):
        TMC.get_method_config("no-such-method")
    with pytest.raises(SystemExit, match="external method"):
        TTrain.entrypoint(["unisim++", "--device", "cpu"])


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------


# the JAX package's settings fields that choose TPU orders of the table gradient's sum (not ported)
_TPU_ONLY = ("run_dedup", "segsum_grad_rows")


def _plain(value):
    """Settings tuples and dataclasses as plain nested dicts and tuples; a
    TPU-only field is dropped where it holds its default."""
    if hasattr(value, "_asdict"):
        defaults = type(value)._field_defaults
        return {k: _plain(v) for k, v in value._asdict().items() if not (k in _TPU_ONLY and v == defaults[k])}
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, (tuple, list)):
        return tuple(_plain(v) for v in value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def test_the_port_has_every_jax_preset_with_its_values():
    assert set(TMC.METHODS) == set(JMC._REGISTRY) and len(TMC.METHODS) == 13
    for name in JMC._REGISTRY:
        want, got = JMC.get_method_config(name), TMC.get_method_config(name)
        assert (got.method_name, got.pipeline_type, got.dataparser) == (want.method_name, want.pipeline_type,
                                                                       want.dataparser), name
        assert _plain(got.trainer) == _plain(want.trainer), name
        if hasattr(want.pipeline, "datamanager"):  # splatfacto samples its cameras itself
            assert _plain(got.pipeline.datamanager) == _plain(want.pipeline.datamanager), name
        if got.pipeline_type == "ad":
            assert got.pipeline.model == want.pipeline.model, name
            assert _plain(got.pipeline.optimizer_groups) == _plain(want.pipeline.optimizer_groups), name
            assert _plain(got.pipeline.model_overrides) == _plain(want.pipeline.model_overrides), name
    scaleopt = TMC.get_method_config("neurad-scaleopt").pipeline.model_overrides
    assert scaleopt["camera_opt_mode"] == "SO3xR3" and scaleopt["camera_opt_trans_penalty"] == (1e-2, 1e-2, 1e-3)
    paper = TMC.get_method_config("neurad-paper")
    assert paper.trainer.max_num_iterations == 80001 and paper.pipeline.optimizer_groups["fields"].max_steps == 80001


def test_camera_exp_maps_have_a_finite_gradient_at_zero():
    """`neurad-scaleopt` optimises the cameras from zero adjustments. There the
    JAX package's exp maps have a NaN gradient (the Taylor branch's `where`
    also differentiates the division by the angle), which its first step
    would write into the camera group; the port's is finite. Elsewhere both
    agree in value and gradient."""
    from neurad_tpu.core import lie as JLie

    from neurad_tpu_torch.core import lie as TLie

    rng = np.random.default_rng(5)
    tangents = rng.normal(size=(4, 6)).astype(np.float32) * 0.3
    tangents[0] = 0.0
    tangents[1] = 0.0
    tangents[1, 3:] = 1e-6  # inside the Taylor branch
    w = rng.normal(size=(4, 3, 4)).astype(np.float32)
    w[1] = w[0]
    for name in ("exp_map_SO3xR3", "exp_map_SE3"):
        jf, tf = getattr(JLie, name), getattr(TLie, name)
        want, jgrad = jax.value_and_grad(lambda t: jnp.sum(jf(t) * w))(jnp.asarray(tangents))
        t = torch.from_numpy(tangents).requires_grad_(True)
        got = torch.sum(tf(t) * torch.from_numpy(w))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
        jgrad = np.asarray(jgrad)
        assert np.isnan(jgrad[0, 3:]).all() and np.isfinite(t.grad.numpy()).all(), name
        np.testing.assert_allclose(t.grad.numpy()[1:], jgrad[1:], rtol=1e-5, atol=1e-6)
        # at zero the gradient is the small-angle branch's, as at 1e-6
        np.testing.assert_allclose(t.grad.numpy()[0, 3:], t.grad.numpy()[1, 3:], atol=1e-4)
