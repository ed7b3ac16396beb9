"""The port's schedules and per-group optimizers against the JAX package
(optax): schedule values, group labels, and three Adam / AdamW updates on a
small tree that includes a parameter whose gradient is zero (optax updates it
all the same; torch.optim would skip a `.grad is None` parameter, so the port
fills in zeros) and a clipped group.

Tolerance: the schedule is float32 in JAX and a Python float in the port
(1e-6 relative). optax takes Adam's bias corrections `1 - b^count` in float32,
torch.optim in double: at count 1..3, `1 - 0.999^count` cancels to ~0.001 and
carries a relative error of up to ~5e-5 in float32, so an update (about one
learning rate in size) differs by up to ~1e-4 of the learning rate. Parameters
after each update are held to 1e-4 * lr plus 3e-7 (a few ulps of a parameter
near 1) plus 1e-6 relative.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurad_tpu.engine import optimizers as JO
from neurad_tpu.engine.schedulers import exponential_decay_schedule as j_schedule
from neurad_tpu.pipelines import splatad_pipeline as JP
from neurad_tpu_torch.engine import optimizers as TO
from neurad_tpu_torch.engine.schedulers import exponential_decay_schedule as t_schedule
from neurad_tpu_torch.pipelines import splatad_pipeline as TP

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(lr_init=1e-3, lr_final=1e-4, max_steps=20001, warmup_steps=2500),
    dict(lr_init=1.6e-4, lr_final=1.6e-6, max_steps=30000),
    dict(lr_init=5e-2),
    dict(lr_init=1e-2, lr_final=1e-3, max_steps=100, warmup_steps=10, ramp="linear"),
])
def test_exponential_decay_schedule(kw):
    js, ts = j_schedule(**kw), t_schedule(**kw)
    warm, end = kw.get("warmup_steps", 0), kw.get("max_steps", 100000)
    for step in (0, 1, warm // 2, max(warm - 1, 0), warm, warm + 1, end // 2, end - 1, end, end + 500):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, err_msg=str(step))
    if warm:
        assert ts(0) == pytest.approx(1e-8) and ts(warm) == pytest.approx(kw["lr_init"])


def test_presets_and_labels_match():
    assert TP.SPLATAD_GROUP_RULES == JP.SPLATAD_GROUP_RULES
    assert TP.SPLATAD_OPTIMIZER_GROUPS.keys() == JP.SPLATAD_OPTIMIZER_GROUPS.keys()
    for name, cfg in JP.SPLATAD_OPTIMIZER_GROUPS.items():
        assert vars(TP.SPLATAD_OPTIMIZER_GROUPS[name]) == vars(cfg), name
    names = ["means", "opacities", "actors.actor_vel_linear", "camera_optimizer.pose_adjustment",
             "rgb_decoder.blocks.0.conv1.weight", "camera_velocity_optimizer.time_to_center_pixel_adjustment"]
    labels = TO.label_params(names, TP.SPLATAD_GROUP_RULES)
    assert [labels[n] for n in names] == ["means", "opacities", "trajectory_opt", "camera_opt", "fields", "camera_opt"]
    with pytest.raises(NotImplementedError, match="accum_steps"):
        TO.OptimizerGroupConfig(accum_steps=4).build([torch.nn.Parameter(torch.zeros(2))])


def test_three_updates_match_optax():
    rng = np.random.default_rng(0)
    shapes = {"means": (40, 3), "opacities": (40,), "decoder_kernel": (6, 5), "unused_bias": (7,),
              "pose_adjustment": (4, 6)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    groups = {
        "means": dict(lr=1.6e-4, lr_final=1.6e-6, max_steps=30),
        "opacities": dict(lr=5e-2),
        "fields": dict(lr=1e-3, weight_decay=1e-2),  # decoder_kernel and unused_bias: AdamW
        "camera_opt": dict(lr=1e-2, lr_final=1e-3, warmup_steps=2, max_norm=0.5),
    }
    rules = (("means", "means"), ("opacities", "opacities"), ("pose_adjustment", "camera_opt"))
    grads = [{k: (rng.normal(size=s) * (10.0 if k == "pose_adjustment" else 1.0)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    for g in grads:
        g["unused_bias"][:] = 0.0  # JAX: a zero gradient; the port: no gradient at all

    jparams = {"params": {k: jnp.asarray(v) for k, v in init.items()}}
    tx, opt_state = JO.build_optimizer(jparams, {g: JO.OptimizerGroupConfig(**kw) for g, kw in groups.items()}, rules)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = TO.Optimizers(tparams.items(), {g: TO.OptimizerGroupConfig(**kw) for g, kw in groups.items()}, rules)
    assert opt.labels["unused_bias"] == "fields" and opt.labels["pose_adjustment"] == "camera_opt"

    for step, g in enumerate(grads):
        updates, opt_state = tx.update({"params": {k: jnp.asarray(v) for k, v in g.items()}}, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for k, p in tparams.items():
            if k != "unused_bias":
                p.grad = torch.from_numpy(g[k].copy())
        assert tparams["unused_bias"].grad is None
        opt.step()
        assert opt.count == step + 1
        for k in shapes:
            lr = groups[opt.labels[k]]["lr"]
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams["params"][k]), rtol=1e-6,
                                       atol=1e-4 * lr + 3e-7, err_msg=f"{k} after update {step}")
    # the parameter without a gradient moved all the same: AdamW's decay applied three times
    assert float((tparams["unused_bias"].detach() - torch.from_numpy(init["unused_bias"])).abs().max()) > 1e-6
    # and its step count advanced with the others
    state = opt.optimizers["fields"].state[tparams["unused_bias"]]
    assert int(state["step"]) == 3 and float(state["exp_avg"].abs().max()) == 0.0
    # the clipped group really was clipped (its gradients' norm is far above 0.5)
    assert float(np.sqrt((grads[0]["pose_adjustment"] ** 2).sum())) > 5.0

    # state dict round trip: a fresh Optimizers continues identically
    fresh_params = {k: torch.nn.Parameter(p.detach().clone()) for k, p in tparams.items()}
    fresh = TO.Optimizers(fresh_params.items(), {g: TO.OptimizerGroupConfig(**kw) for g, kw in groups.items()}, rules)
    fresh.load_state_dict(copy.deepcopy(opt.state_dict()))  # torch shares state tensors on load otherwise
    for params, o in ((tparams, opt), (fresh_params, fresh)):
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[0][k].copy())
        o.step()
    for k in shapes:
        torch.testing.assert_close(fresh_params[k], tparams[k], rtol=0, atol=0)
    assert fresh.learning_rates() == opt.learning_rates()
