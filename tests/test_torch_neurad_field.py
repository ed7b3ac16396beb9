"""The port's NeuRAD encoding and fields against the JAX package's: same numpy
rays, parameters carried across by `params_from_jax`.

Hash tables are initialised at 1e-3 by both packages; the carried tables are
scaled by 500 so that features are O(0.5) and a wrong row, actor or frame
shows. Tolerances: with fp32 table reads (`gather_f32=True`) and fp32 MLPs the
two sides do the same fp32 arithmetic up to summation order (matmuls, norms):
features 2e-6 absolute, directions 1e-6. With the bf16 defaults both the lookup
(see test_torch_hash_encoding.py) and the MLPs round at different points in
XLA and torch: encodings are held to 2^-6 of their magnitude bound (tables are
at most 0.5, so a feature is at most 0.5), MLP outputs to 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.core.structs import Frustums as JFrustums
from neurad_tpu.core.structs import GaussiansStd as JG
from neurad_tpu.core.structs import RaySamples as JRaySamples
from neurad_tpu.fields import neurad_encoding as JE
from neurad_tpu.fields import neurad_field as JF
from neurad_tpu.fields.spatial_distortions import scaled_scene_contraction_gaussian as j_contract
from neurad_tpu.fields.spatial_distortions import scene_contraction as j_scene_contraction
from neurad_tpu.model_components import dynamic_actors as JA
from neurad_tpu.ops.spherical_harmonics import components_from_spherical_harmonics as j_sh
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.core.structs import Frustums as TFrustums
from neurad_tpu_torch.core.structs import GaussiansStd as TG
from neurad_tpu_torch.core.structs import RaySamples as TRaySamples
from neurad_tpu_torch.fields import neurad_encoding as TE
from neurad_tpu_torch.fields import neurad_field as TF
from neurad_tpu_torch.fields.activations import trunc_exp
from neurad_tpu_torch.fields.spatial_distortions import scaled_scene_contraction_gaussian as t_contract
from neurad_tpu_torch.fields.spatial_distortions import scene_contraction as t_scene_contraction
from neurad_tpu_torch.model_components import dynamic_actors as TA
from neurad_tpu_torch.ops.spherical_harmonics import components_from_spherical_harmonics as t_sh

torch.set_num_threads(1)

TABLE_GAIN = 500.0
STATIC = dict(num_levels=4, base_res=16, max_res=128, log2_hashmap_size=12, hashgrid_dim=4)
ACTOR = dict(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=10, hashgrid_dim=4)
FP32_TOL, BF16_TOL, MLP_BF16_TOL = 2e-6, 0.5 * 2.0**-6, 3e-2


def _traj(x, y, z, dims=(2.0, 2.0, 2.0), yaw=0.0, velocity=(0.0, 0.0, 0.0)):
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    c, s = np.cos(yaw), np.sin(yaw)
    poses[:, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    poses[0, :3, 3] = [x, y, z]
    poses[1, :3, 3] = np.array([x, y, z]) + 10.0 * np.asarray(velocity)
    return {"poses": poses, "timestamps": np.array([0.0, 10.0]), "dims": np.array(dims, np.float32),
            "symmetric": False, "deformable": False}


def _actor_data(trajs):
    if not trajs:
        return JA.empty_actor_data(), TA.empty_actor_data()
    return JA.actor_data_from_trajectories(trajs), TA.actor_data_from_trajectories(trajs)


def _rays(seed, r, s, through=None):
    """[r, s, 3] sample positions along rays; rays listed in `through` pass
    through that point half way."""
    rng = np.random.default_rng(seed)
    origins = rng.normal(size=(r, 3)).astype(np.float32) * 2.0
    targets = rng.normal(size=(r, 3)).astype(np.float32) * 6.0 + np.array([8.0, 0.0, 0.0], np.float32)
    for i, point in enumerate(through or []):
        targets[i] = 2.0 * np.asarray(point, np.float32) - origins[i]
    t = np.linspace(0.0, 1.0, s, dtype=np.float32)[None, :, None]
    pts = origins[:, None] + (targets - origins)[:, None] * t
    dirs = (targets - origins) / np.linalg.norm(targets - origins, axis=-1, keepdims=True)
    return pts.astype(np.float32), np.broadcast_to(dirs[:, None], pts.shape).astype(np.float32).copy()


def _scaled(tree):
    """The flax tree as numpy, hash tables (1-D tuple leaves) scaled up."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (tuple(np.asarray(t) * TABLE_GAIN for t in v) if k.endswith("hash_table") else walk(v))
                    for k, v in node.items()}
        return np.asarray(node)
    return walk(jax.tree.map(np.asarray, tree))


def _encodings(trajs, fp32=True, **kw):
    jdata, tdata = _actor_data(trajs)
    extra = dict(gather_f32=fp32)
    jenc = JE.NeuRADHashEncoding(actors=JA.DynamicActors(data=jdata), static_scale=20.0,
                                 static=JE.StaticSettings(**STATIC, **extra), actor=JE.ActorSettings(**ACTOR, **extra),
                                 **kw)
    tenc = TE.NeuRADHashEncoding(TA.DynamicActors(tdata), 20.0, static=TE.StaticSettings(**STATIC, **extra),
                                 actor=TE.ActorSettings(**ACTOR, **extra), **kw)
    return jenc, tenc


def _run_encoding(jenc, tenc, pts, dirs, times, std=0.01, edits=None, flip=None):
    r, s = pts.shape[:2]
    mean = pts[:, :, None, :]
    stds = np.full((r, s, 1, 1), std, np.float32)
    jg = JG(mean=jnp.asarray(mean), std=jnp.asarray(stds))
    jdirs = None if dirs is None else jnp.asarray(dirs)
    params = _scaled(jenc.init(jax.random.PRNGKey(0), jg, jnp.asarray(times), jdirs))
    sd = bridge.hash_tables_from_flax("", params["params"], {"." + k: v for k, v in tenc.state_dict().items()})
    tenc.load_state_dict({k[1:]: v for k, v in sd.items()})
    t_actors = tenc.actors
    if "actors" in params["params"]:
        t_actors.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params["params"]["actors"].items()})
    jedits = None if edits is None else JA.ActorEdits(**edits)
    tedits = None if edits is None else TA.ActorEdits(**edits)
    if flip is None:
        jf, jd = jenc.apply(params, jg, jnp.asarray(times), jdirs, edits=jedits)
    else:  # the JAX side draws from a key; the port is handed the same uniform draws
        key = jax.random.PRNGKey(5)
        jf, jd = jenc.apply(params, jg, jnp.asarray(times), jdirs, True, key, edits=jedits)
        flip = torch.from_numpy(np.array(jax.random.uniform(key, (r,))))
    with torch.no_grad():
        tf, td = tenc(TG(mean=torch.from_numpy(mean), std=torch.from_numpy(stds)), torch.from_numpy(times),
                      None if dirs is None else torch.from_numpy(dirs), flip_draw=flip, edits=tedits)
    return np.asarray(jf), (None if jd is None else np.asarray(jd)), tf.numpy(), (None if td is None else td.numpy())


@pytest.mark.parametrize("n_actors", [0, 1, 3])
@pytest.mark.parametrize("compaction", [0, 8])
@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_encoding_matches(n_actors, compaction, fp32):
    trajs = [_traj(5.0, 0.0, 0.0, velocity=(0.3, 0.0, 0.0)), _traj(9.0, 2.0, 0.5, dims=(2.0, 4.0, 1.5), yaw=0.7),
             _traj(3.0, -3.0, 0.0, yaw=-0.4)][:n_actors]
    jenc, tenc = _encodings(trajs, fp32=fp32, actor_compaction=compaction, max_actors_per_ray=2)
    r, s = 24, 16  # 384 samples: the compacted path needs more than 256
    pts, dirs = _rays(1, r, s, through=[t["poses"][0, :3, 3] for t in trajs] * 3)
    times = np.random.default_rng(2).uniform(0.0, 1.0, (r, 1)).astype(np.float32)
    jf, jd, tf, td = _run_encoding(jenc, tenc, pts, dirs, times)
    assert jf.shape == tf.shape == (r, s, 16) and np.abs(jf).max() > 0.1
    np.testing.assert_allclose(tf, jf, atol=FP32_TOL if fp32 else BF16_TOL, rtol=0)
    np.testing.assert_allclose(td, jd, atol=1e-6, rtol=0)
    if n_actors:
        changed = np.abs(td - dirs).max(-1) > 1e-3  # rays through rotated or moving boxes change frame
        in_box = (np.abs(jf[..., 8:]).max(-1) == 0)  # actor features are zero-padded from 8 to 16
        assert in_box.sum() >= 3 * n_actors and (in_box | ~changed).all()


def test_sample_inside_two_boxes_takes_the_first_candidate():
    """Two overlapping boxes: samples inside both take the nearer actor to the
    ray (the first candidate), on both sides."""
    trajs = [_traj(5.0, 0.0, 0.0, dims=(3.0, 3.0, 3.0)), _traj(5.8, 0.3, 0.0, dims=(3.0, 3.0, 3.0), yaw=0.5)]
    jenc, tenc = _encodings(trajs, actor_compaction=0, max_actors_per_ray=2)
    pts, dirs = _rays(3, 6, 24, through=[(5.4, 0.1, 0.0)] * 6)
    jf, jd, tf, td = _run_encoding(jenc, tenc, pts, dirs, np.zeros((6, 1), np.float32))
    np.testing.assert_allclose(tf, jf, atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(td, jd, atol=1e-6, rtol=0)
    with torch.no_grad():
        b2w, _ = tenc.actors.get_boxes2world(torch.zeros(6))
        local = torch.einsum("raij,rsj->rsai", b2w[..., :3, :3].transpose(-1, -2),
                             torch.from_numpy(pts)) - torch.einsum("raij,raj->rai", b2w[..., :3, :3].transpose(-1, -2),
                                                                   b2w[..., :3, 3])[:, None]
        in_both = (local.abs() < tenc.actors.actor_bounds()).all(-1).all(-1)
    assert int(in_both.sum()) >= 6, "the case must have samples inside both boxes"


def test_compaction_overflow_keeps_the_first_hits_in_flat_order():
    """More samples hit a box than the compacted lookup holds (cap = max(128,
    R*S // 8)): the first `cap` in flat order keep actor features, the rest
    keep static ones, as `jax.lax.top_k` on the 0/1 hit vector breaks its ties."""
    trajs = [_traj(6.0, 0.0, 0.0, dims=(30.0, 30.0, 30.0))]  # nearly everything is inside
    jenc, tenc = _encodings(trajs, actor_compaction=8)
    r, s = 40, 16
    pts, dirs = _rays(4, r, s)
    jf, jd, tf, td = _run_encoding(jenc, tenc, pts, dirs, np.zeros((r, 1), np.float32))
    actor_rows = (np.abs(tf[..., 8:]).max(-1) == 0).reshape(-1)  # actor features are zero-padded from 8 to 16
    cap = max(128, r * s // 8)
    # the dense lookup gives every hit its actor features: that is the hit mask
    jenc_d, tenc_d = _encodings(trajs, actor_compaction=0)
    hits = np.flatnonzero((np.abs(_run_encoding(jenc_d, tenc_d, pts, dirs, np.zeros((r, 1), np.float32))[2][..., 8:])
                           .max(-1) == 0).reshape(-1))
    assert cap == 128 and len(hits) > 3 * cap, "the case must overflow the capacity"
    np.testing.assert_array_equal(np.flatnonzero(actor_rows), hits[:cap])
    np.testing.assert_allclose(tf, jf, atol=FP32_TOL, rtol=0)
    # torch.topk would be free to pick any `cap` of the tied hits; the stable sort is not
    flags = torch.tensor([0, 1, 1, 0, 1, 1, 0, 1], dtype=torch.bool)
    assert TE.first_k_set(flags, 3).tolist() == [1, 2, 4]
    assert TE.first_k_set(flags, 7).tolist() == [1, 2, 4, 5, 7, 0, 3]
    assert TE.first_k_set(flags, 7).tolist() == np.asarray(jax.lax.top_k(jnp.asarray(flags.numpy(), jnp.float32), 7)[1]).tolist()


def test_ineligible_candidates_never_leak():
    """With fewer eligible actors than candidates a ray's spare candidates are
    ties at -inf, which the two frameworks may order differently; `cand_ok`
    masks them, so no output depends on which actor fills a spare slot."""
    trajs = [_traj(5.0, 0.0, 0.0), _traj(50.0, 40.0, 0.0), _traj(-40.0, 30.0, 0.0), _traj(45.0, -45.0, 3.0)]
    jenc, tenc = _encodings(trajs, actor_compaction=0, max_actors_per_ray=3)
    pts, dirs = _rays(5, 8, 12, through=[(5.0, 0.0, 0.0)] * 4)
    jf, jd, tf, td = _run_encoding(jenc, tenc, pts, dirs, np.zeros((8, 1), np.float32))
    np.testing.assert_allclose(tf, jf, atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(td, jd, atol=1e-6, rtol=0)
    # the far actors' poses do not matter: move them and nothing changes
    with torch.no_grad():
        tenc.actors.actor_positions[:, 1:] += 3.0
        mean = torch.from_numpy(pts[:, :, None, :])
        tf2, _ = tenc(TG(mean=mean, std=torch.full(mean.shape[:-1] + (1,), 0.01)), torch.zeros(8, 1),
                      torch.from_numpy(dirs))
    np.testing.assert_array_equal(tf2.numpy(), tf)


@pytest.mark.parametrize("compaction", [0, 8])
def test_edits_and_flip_match(compaction):
    trajs = [_traj(5.0, 0.0, 0.0, yaw=0.3)]
    jenc, tenc = _encodings(trajs, actor_compaction=compaction)
    r, s = 20, 16
    shifted = (5.0 - 1.5 * np.sin(0.3), 1.5 * np.cos(0.3), 0.0)  # 1.5 m along the box's y axis
    pts, dirs = _rays(6, r, s, through=[shifted] * 10)
    times = np.zeros((r, 1), np.float32)
    edits = dict(lateral=0.0, longitudinal=1.5, rotation=0.2, height=0.0)
    jf, jd, tf, td = _run_encoding(jenc, tenc, pts, dirs, times, edits=edits)
    np.testing.assert_allclose(tf, jf, atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(td, jd, atol=1e-6, rtol=0)
    jf0, _, tf0, _ = _run_encoding(jenc, tenc, pts, dirs, times)
    assert np.abs(tf - tf0).max() > 0.05, "the edit moves the box"
    jf1, jd1, tf1, td1 = _run_encoding(jenc, tenc, pts, dirs, times, flip=True)
    np.testing.assert_allclose(tf1, jf1, atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(td1, jd1, atol=1e-6, rtol=0)
    assert np.abs(td1 - _run_encoding(jenc, tenc, pts, dirs, times)[3]).max() > 0.1, "some ray was flipped"


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------


def _samples(seed, r, s, through):
    rng = np.random.default_rng(seed)
    pts, dirs = _rays(seed, r, s + 1, through=through)
    origins, direction = pts[:, 0], dirs[:, 0]
    length = np.linalg.norm(pts[:, -1] - pts[:, 0], axis=-1, keepdims=True)
    edges = np.linspace(0.0, 1.0, s + 1, dtype=np.float32)[None] * length  # [r, s+1]
    arrays = dict(
        origins=np.broadcast_to(origins[:, None], (r, s, 3)).copy(),
        directions=np.broadcast_to(direction[:, None], (r, s, 3)).copy(),
        starts=edges[:, :-1, None].copy(), ends=edges[:, 1:, None].copy(),
        pixel_area=np.full((r, s, 1), 1e-5, np.float32),
    )
    times = np.broadcast_to(rng.uniform(0, 1, (r, 1, 1)).astype(np.float32), (r, s, 1)).copy()
    deltas = arrays["ends"] - arrays["starts"]
    jrs = JRaySamples(frustums=JFrustums(**{k: jnp.asarray(v) for k, v in arrays.items()}), deltas=jnp.asarray(deltas),
                      times=jnp.asarray(times))
    trs = TRaySamples(frustums=TFrustums(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                      deltas=torch.from_numpy(deltas), times=torch.from_numpy(times))
    return jrs, trs


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("use_sdf", [True, False], ids=["sdf", "density"])
def test_neurad_field_matches(fp32, use_sdf):
    trajs = [_traj(5.0, 0.0, 0.0, yaw=0.4)]
    jdata, tdata = _actor_data(trajs)
    kw = dict(use_sdf=use_sdf, max_actors_per_ray=1)
    jfield = JF.NeuRADField(actors=JA.DynamicActors(data=jdata), static_scale=20.0,
                            static=JE.StaticSettings(**STATIC, gather_f32=fp32),
                            actor=JE.ActorSettings(**ACTOR, gather_f32=fp32, flip_prob=0.25),
                            compute_dtype=None if fp32 else jnp.bfloat16, **kw)
    t_actors = TA.DynamicActors(tdata)
    tfield = TF.NeuRADField(t_actors, 20.0, static=TE.StaticSettings(**STATIC, gather_f32=fp32),
                            actor=TE.ActorSettings(**ACTOR, gather_f32=fp32, flip_prob=0.25),
                            compute_dtype=None if fp32 else torch.bfloat16, **kw)
    jrs, trs = _samples(7, 20, 16, through=[(5.0, 0.0, 0.0)] * 8)
    params = _scaled(jfield.init(jax.random.PRNGKey(1), jrs))["params"]
    sd = bridge.hash_tables_from_flax("hashgrid", params["hashgrid"], tfield.state_dict())
    sd.update(bridge.mlp_from_flax("mlp_geo", params["mlp_geo"]))
    sd.update(bridge.mlp_from_flax("mlp_feature", params["mlp_feature"]))
    if use_sdf:
        sd["sdf_to_alpha.beta"] = torch.from_numpy(np.array(params["sdf_to_alpha"]["beta"]))
    tfield.load_state_dict(sd)
    t_actors.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params["actors"].items()})
    want = jfield.apply({"params": params}, jrs)
    with torch.no_grad():
        got = tfield(trs)
    tol = 1e-5 if fp32 else MLP_BF16_TOL
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), atol=tol, rtol=0)
    for name in ("sdf", "alphas") if use_sdf else ("density",):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=tol, rtol=tol)
    assert (got.density is None) == use_sdf and np.abs(np.asarray(want.features)).max() > 0.01


def test_mlp_proposal_field_matches():
    """sin / cos of x * 2^9 * pi in fp32 feed a bf16 MLP (always bf16) with an
    fp32 density head: densities are held to 3e-2 relative."""
    jfield = JF.MLPProposalField(static_scale=20.0, hidden_dim=32)
    tfield = TF.MLPProposalField(20.0, hidden_dim=32)
    jrs, trs = _samples(8, 12, 10, through=[])
    params = jax.tree.map(np.asarray, jfield.init(jax.random.PRNGKey(2), jrs))["params"]
    params["density_decoder"]["kernel"] = params["density_decoder"]["kernel"] * 3000.0  # init is 1e-4
    sd = bridge.mlp_from_flax("mlp", params["mlp"])
    sd["density_decoder.weight"] = torch.from_numpy(np.array(params["density_decoder"]["kernel"])).T.contiguous()
    tfield.load_state_dict(sd)
    want = np.asarray(jfield.apply({"params": params}, jrs))
    with torch.no_grad():
        got = tfield(trs).numpy()
    assert want.shape == got.shape == (12, 10, 1) and want.max() / want.min() > 1.5
    np.testing.assert_allclose(got, want, rtol=MLP_BF16_TOL, atol=0)


@pytest.mark.parametrize("n_actors", [0, 1])
def test_hashgrid_proposal_field_matches(n_actors):
    trajs = [_traj(5.0, 0.0, 0.0)][:n_actors]
    jdata, tdata = _actor_data(trajs)
    static = dict(num_levels=3, base_res=16, max_res=64, log2_hashmap_size=10, hashgrid_dim=1)
    actor = dict(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=9, hashgrid_dim=1)
    jfield = JF.NeuRADProposalField(actors=JA.DynamicActors(data=jdata), static_scale=20.0,
                                    static=JE.StaticSettings(**static, gather_f32=True),
                                    actor=JE.ActorSettings(**actor, gather_f32=True))
    t_actors = TA.DynamicActors(tdata)
    tfield = TF.NeuRADProposalField(t_actors, 20.0, static=TE.StaticSettings(**static, gather_f32=True),
                                    actor=TE.ActorSettings(**actor, gather_f32=True))
    jrs, trs = _samples(9, 20, 16, through=[(5.0, 0.0, 0.0)] * 8)
    params = _scaled(jfield.init(jax.random.PRNGKey(3), jrs))["params"]
    sd = bridge.hash_tables_from_flax("hashgrid", params["hashgrid"], tfield.state_dict())
    sd["density_decoder.weight"] = torch.from_numpy(np.array(params["density_decoder"]["kernel"])).T.contiguous()
    tfield.load_state_dict(sd)
    if n_actors:
        t_actors.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params["actors"].items()})
    want = np.asarray(jfield.apply({"params": params}, jrs))
    with torch.no_grad():
        got = tfield(trs).numpy()
    assert want.max() / want.min() > 1.05
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_sigmoid_density_sh_contraction_and_trunc_exp_match():
    rng = np.random.default_rng(10)
    sdf = rng.normal(size=(50, 1)).astype(np.float32)
    for learnable in (True, False):
        jmod = JF.SigmoidDensity(init_beta=12.0, learnable_beta=learnable)
        params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(sdf))
        tmod = TF.SigmoidDensity(init_beta=12.0, learnable_beta=learnable)
        assert len(list(tmod.parameters())) == int(learnable)
        np.testing.assert_allclose(tmod(torch.from_numpy(sdf)).detach().numpy(),
                                   np.asarray(jmod.apply(params, jnp.asarray(sdf))), atol=1e-6)
    dirs = rng.normal(size=(40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for levels in range(1, 6):
        np.testing.assert_allclose(t_sh(levels, torch.from_numpy(dirs)).numpy(), np.asarray(j_sh(levels, jnp.asarray(dirs))),
                                   atol=1e-6)
    pos = (rng.normal(size=(60, 2, 3)) * 30.0).astype(np.float32)
    std = rng.uniform(0.01, 1.0, (60, 2, 1)).astype(np.float32)
    for order in (float("inf"), 2):
        np.testing.assert_allclose(t_scene_contraction(torch.from_numpy(pos / 20), order).numpy(),
                                   np.asarray(j_scene_contraction(jnp.asarray(pos / 20), order)), atol=1e-6)
        jg = j_contract(JG(mean=jnp.asarray(pos), std=jnp.asarray(std)), 20.0, order)
        tg = t_contract(TG(mean=torch.from_numpy(pos), std=torch.from_numpy(std)), 20.0, order)
        np.testing.assert_allclose(tg.mean.numpy(), np.asarray(jg.mean), atol=1e-6)
        np.testing.assert_allclose(tg.std.numpy(), np.asarray(jg.std), rtol=1e-5)
        assert tg.mean.min() >= 0 and tg.mean.max() <= 1
    x = torch.tensor([-20.0, 0.0, 3.0, 20.0], requires_grad=True)
    y = trunc_exp(x)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.exp(x.detach().numpy()), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.exp(np.clip(x.detach().numpy(), -15, 15)), rtol=1e-6)
    jgrad = jax.grad(lambda v: jnp.sum(JFact(v)))(jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-6)


from neurad_tpu.fields.activations import trunc_exp as JFact  # noqa: E402
