"""The port's densification strategies against the JAX package, with JAX's
random draws handed to both sides: `compute_relocation`, `mcmc_relocate`,
`mcmc_add_noise`, `should_refine`, `alive_mask` / `kill_slots`,
`reset_opacities`, `should_refine_default` and `default_refine`.

Everything is fp32 and elementwise apart from `compute_relocation`'s
[N, 51] x [51, 51] product and the 3x3 covariances: values to 1e-5 relative
(the binomial sum alternates in sign, so its rounding is amplified; 2e-4 there
for counts up to 51), selections (which slot is dead, split, granted) exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.model_components import strategy as JSt
from neurad_tpu_torch.model_components import strategy as TSt

torch.set_num_threads(1)


def _gauss(seed, n=400, n_actors=2, dead_frac=0.2):
    rng = np.random.default_rng(seed)
    p = {
        "means": rng.normal(size=(n, 3)) * 2.0,
        "scales": rng.normal(size=(n, 3)) * 0.5 - 1.5,
        "quats": rng.normal(size=(n, 4)),
        "opacities": rng.normal(size=n) * 1.5,
        "features": rng.uniform(size=(n, 5)),
    }
    p["opacities"][rng.uniform(size=n) < dead_frac] = -7.0  # sigmoid < 0.005: dead
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p["id"] = rng.integers(0, n_actors + 1, n).astype(np.int32)  # n_actors marks static
    return p


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _assert_params(t_out, j_out, rtol=1e-5, atol=1e-6):
    assert t_out.keys() == j_out.keys()
    for k in j_out:
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]), rtol=rtol, atol=atol, err_msg=k)


def test_compute_relocation():
    rng = np.random.default_rng(0)
    n = 300
    op = rng.uniform(0.01, 0.99, n).astype(np.float32)
    scales = np.exp(rng.normal(size=(n, 3))).astype(np.float32)
    counts = rng.integers(1, 70, n).astype(np.int32)  # above 51 is clipped
    jo, js = JSt.compute_relocation(jnp.asarray(op), jnp.asarray(scales), jnp.asarray(counts))
    to, ts = TSt.compute_relocation(torch.from_numpy(op), torch.from_numpy(scales), torch.from_numpy(counts))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-4, atol=1e-6)
    one = counts == 1
    np.testing.assert_allclose(to.numpy()[one], op[one], rtol=1e-6)


@pytest.mark.parametrize("with_actors", [True, False])
def test_mcmc_relocate_with_shared_targets(with_actors):
    p = _gauss(1)
    cfg = dict(cap_max=400, min_opacity=0.005)
    bounds = np.array([[1.0, 2.0, 0.8], [0.9, 1.8, 0.7]], np.float32) if with_actors else None
    n_actors = 2 if with_actors else 0
    # JAX's own draw of the targets, handed to both
    rng = jax.random.PRNGKey(3)
    rng_t, _ = jax.random.split(rng)
    op = jax.nn.sigmoid(jnp.asarray(p["opacities"]))
    probs = jnp.where(op < 0.005, 0.0, op)
    targets = np.asarray(jax.random.choice(rng_t, 400, shape=(400,), p=probs / probs.sum()))
    moments = {"mu": {"means": np.ones((400, 3), np.float32)}, "nu": {"opacities": np.ones(400, np.float32)}}
    j_new, j_mom = JSt.mcmc_relocate(rng, _j(p), jax.tree.map(jnp.asarray, moments), JSt.MCMCStrategyConfig(**cfg),
                                     None if bounds is None else jnp.asarray(bounds), n_actors)
    t_mom_in = {k: _t(v) for k, v in moments.items()}
    t_new, t_mom = TSt.mcmc_relocate(None, _t(p), t_mom_in, TSt.MCMCStrategyConfig(**cfg),
                                     None if bounds is None else torch.from_numpy(bounds), n_actors,
                                     targets=torch.from_numpy(targets.copy()))
    dead = 1 / (1 + np.exp(-p["opacities"])) < 0.005
    assert 20 < dead.sum() < 200
    _assert_params(t_new, j_new)
    assert not np.array_equal(t_new["means"].numpy()[dead], p["means"][dead]), "dead slots moved"
    np.testing.assert_array_equal(t_mom["mu"]["means"].numpy(), np.asarray(j_mom["mu"]["means"]))
    np.testing.assert_array_equal(t_mom["nu"]["opacities"].numpy()[dead], 0.0)
    if with_actors:
        actor = t_new["id"].numpy() < 2
        assert (np.abs(t_new["means"].numpy()[actor]) <= bounds[t_new["id"].numpy()[actor]] + 1e-6).all()


def test_mcmc_relocate_draws_live_targets_from_its_generator():
    p = _gauss(2)
    gen = torch.Generator().manual_seed(0)
    new, _ = TSt.mcmc_relocate(gen, _t(p), None, TSt.MCMCStrategyConfig(cap_max=400))
    again, _ = TSt.mcmc_relocate(torch.Generator().manual_seed(0), _t(p), None, TSt.MCMCStrategyConfig(cap_max=400))
    for k in new:
        torch.testing.assert_close(new[k], again[k], rtol=0, atol=0)
    dead = torch.sigmoid(torch.from_numpy(p["opacities"])) < 0.005
    # every relocated slot now sits on a live gaussian's mean
    live_means = {tuple(m) for m in p["means"][~dead.numpy()].round(5)}
    assert all(tuple(m) in live_means for m in new["means"][dead].numpy().round(5))


def test_mcmc_add_noise_with_shared_draws():
    p = _gauss(3)
    rng = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(rng, (400, 3)))
    cfg = dict(cap_max=400, noise_lr=5e4)
    j_new = JSt.mcmc_add_noise(rng, _j(p), 1.6e-4, JSt.MCMCStrategyConfig(**cfg))
    t_new = TSt.mcmc_add_noise(None, _t(p), 1.6e-4, TSt.MCMCStrategyConfig(**cfg), eps=torch.from_numpy(eps.copy()))
    _assert_params(t_new, j_new)
    moved = np.abs(t_new["means"].numpy() - p["means"]).max(-1)
    dead = 1 / (1 + np.exp(-p["opacities"])) < 0.005
    assert moved[dead].mean() > 10 * moved[~dead & (p["opacities"] > 0)].mean(), "near-dead gaussians wander more"
    own = TSt.mcmc_add_noise(torch.Generator().manual_seed(1), _t(p), 1.6e-4, TSt.MCMCStrategyConfig(**cfg))
    assert float((own["means"] - torch.from_numpy(p["means"])).abs().max()) > 0


def test_refine_schedules():
    jm, tm = JSt.MCMCStrategyConfig(), TSt.MCMCStrategyConfig()
    assert vars(jm) == vars(tm)
    jd, td = JSt.DefaultStrategyConfig(pause_refine_after_reset=150), TSt.DefaultStrategyConfig(pause_refine_after_reset=150)
    assert vars(jd) == vars(td)
    for step in (0, 100, 500, 600, 650, 3000, 3100, 3200, 14900, 15000, 24900, 25000):
        assert TSt.should_refine(step, tm) == JSt.should_refine(step, jm), step
        assert TSt.should_refine_default(step, td) == JSt.should_refine_default(step, jd), step


def test_alive_kill_and_reset_opacities():
    p = _gauss(4)
    dead = np.random.default_rng(5).uniform(size=400) < 0.3
    j_killed, t_killed = JSt.kill_slots(_j(p), jnp.asarray(dead)), TSt.kill_slots(_t(p), torch.from_numpy(dead))
    _assert_params(t_killed, j_killed, rtol=0, atol=0)
    np.testing.assert_array_equal(TSt.alive_mask(t_killed).numpy(), np.asarray(JSt.alive_mask(j_killed)))
    np.testing.assert_array_equal(TSt.alive_mask(t_killed).numpy(), ~dead)
    j_reset = JSt.reset_opacities(j_killed, JSt.DefaultStrategyConfig())
    t_reset = TSt.reset_opacities(t_killed, TSt.DefaultStrategyConfig())
    _assert_params(t_reset, j_reset, rtol=1e-6, atol=0)
    assert float(torch.sigmoid(t_reset["opacities"][~torch.from_numpy(dead)]).max()) <= 0.01 + 1e-6
    np.testing.assert_array_equal(t_reset["opacities"].numpy()[dead], TSt.DEAD_OPACITY)


@pytest.mark.parametrize("revised_opacity", [False, True])
@pytest.mark.parametrize("step", [1000, 4000])
def test_default_refine_with_shared_draws(step, revised_opacity):
    """Prune (opacity, size after the first reset, actor box), the keep-half
    rule for an actor that would be wiped out, duplicate and split, the grow
    cap, with JAX's uniform and normal draws handed to both."""
    n, n_actors = 400, 2
    p = _gauss(6, n=n, n_actors=n_actors, dead_frac=0.1)
    rng_np = np.random.default_rng(7)
    p["scales"][:40] = TSt.DEAD_SCALE  # free capacity
    p["opacities"][:40] = TSt.DEAD_OPACITY
    p["scales"][40:60] = np.log(3.0)  # larger than prune_scale3d * scene_scale
    p["means"][p["id"] == 1] = 50.0  # every gaussian of actor 1 outside its box: the keep-half rule
    grad = rng_np.uniform(0, 6e-4, n).astype(np.float32)
    cfg = dict(max_grow_per_refine=64, revised_opacity=revised_opacity)
    bounds = np.array([[3.0, 4.0, 2.5], [2.0, 3.0, 2.0]], np.float32)
    scene_scale = 10.0

    rng = jax.random.PRNGKey(11)
    rng_a, r_keep = jax.random.split(rng)
    keep_u = np.array(jax.random.uniform(r_keep, (n,)))
    _, r1, r2 = jax.random.split(rng_a, 3)
    eps = (np.array(jax.random.normal(r1, (64, 3))), np.array(jax.random.normal(r2, (64, 3))))
    moments = {"mu": np.ones((n, 3), np.float32)}

    j_new, j_mom = JSt.default_refine(rng, _j(p), jnp.asarray(grad), JSt.DefaultStrategyConfig(**cfg), scene_scale,
                                      step, jnp.asarray(bounds), n_actors, jax.tree.map(jnp.asarray, moments))
    t_new, t_mom = TSt.default_refine(None, _t(p), torch.from_numpy(grad), TSt.DefaultStrategyConfig(**cfg),
                                      scene_scale, step, torch.from_numpy(bounds), n_actors, _t(moments),
                                      keep_u=torch.from_numpy(keep_u), split_eps=tuple(map(torch.from_numpy, eps)))
    _assert_params(t_new, j_new, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t_mom["mu"].numpy(), np.asarray(j_mom["mu"]))
    alive_before, alive_after = TSt.alive_mask(_t(p)).numpy(), TSt.alive_mask(t_new).numpy()
    assert (alive_before & ~alive_after).sum() > 20, "pruned"
    assert (~alive_before & alive_after).sum() > 20, "grown into free slots"
    actor1 = p["id"] == 1
    assert 0 < (alive_after & actor1).sum() < (alive_before & actor1).sum(), "actor 1 kept about half"
    # the 20 oversized gaussians go only after the first reset (their freed slots may be reused at once)
    # (those of actor 1 aside, which the keep-half rule may spare)
    still_big = np.isclose(t_new["scales"].numpy()[40:60], np.log(3.0)).all(-1) & ~actor1[40:60]
    assert still_big.any() == (step <= 3000), "size pruning starts after the first reset"


def test_default_refine_draws_from_its_generator():
    p = _gauss(8)
    grad = np.random.default_rng(9).uniform(0, 6e-4, 400).astype(np.float32)
    p["scales"][:40], p["opacities"][:40] = TSt.DEAD_SCALE, TSt.DEAD_OPACITY
    args = (torch.from_numpy(grad), TSt.DefaultStrategyConfig(max_grow_per_refine=32), 10.0, 1000,
            torch.tensor([[3.0, 4.0, 2.5], [2.0, 3.0, 2.0]]), 2)
    a, _ = TSt.default_refine(torch.Generator().manual_seed(2), _t(p), *args)
    b, _ = TSt.default_refine(torch.Generator().manual_seed(2), _t(p), *args)
    c, _ = TSt.default_refine(torch.Generator().manual_seed(3), _t(p), *args)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert float((a["means"] - c["means"]).abs().max()) > 0
