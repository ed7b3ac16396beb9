"""The rest of the JAX package's public API in the port, held against the
JAX functions on the same seeded numpy inputs: `BottleneckBlock` (flax
parameters carried across by `params_from_jax`), the scene-box and
oriented-box masks, the pose helpers, the ray-structure helpers, the
method configs' descriptions, `all_methods` and `build_pipeline`, and
`learning_rates_at`.

Tolerances: `BottleneckBlock` in fp32 to 1e-5 (outputs and, with batch
norm in train mode, the updated running averages); the masks bit-equal, but
for a rotated box points within 1e-6 of a face (where XLA's and torch's
fp32 products may round a point to either side; counted and reported, not
moved); the poses to 1e-6; the structs and the learning rates to 1e-6
relative (the schedules are float32 in JAX, Python floats in the port).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.configs import method_configs as JMC
from neurad_tpu.core import poses as JP
from neurad_tpu.core import scene_box as JSB
from neurad_tpu.core import structs as JS
from neurad_tpu.engine import optimizers as JO
from neurad_tpu.model_components.cnns import BottleneckBlock as JBottleneck
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.configs import method_configs as TMC
from neurad_tpu_torch.core import poses as TP
from neurad_tpu_torch.core import scene_box as TSB
from neurad_tpu_torch.core import structs as TS
from neurad_tpu_torch.engine import optimizers as TO
from neurad_tpu_torch.model_components.cnns import BasicBlock, BottleneckBlock

torch.set_num_threads(1)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol=1e-6, atol=1e-6, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


def _poses(rng, n, scale=5.0):
    t = rng.uniform(-scale, scale, (n, 3, 1)).astype(np.float32)
    return np.concatenate([_rotations(rng, n), t], axis=-1)


# --------------------------------------------------------------------------- BottleneckBlock


@pytest.mark.parametrize("norm", ["group", "batch", "none"])
@pytest.mark.parametrize("dim,mult,in_dim", [(8, 1, 8), (16, 2, 16), (16, 1, 8), (8, 2, 16)])
def test_bottleneck_block_matches_flax(norm, dim, mult, in_dim):
    """Eval mode, and for batch norm train mode with the updated
    `batch_stats` (momentum 0.99, biased variance), to 1e-5 in fp32."""
    rng = np.random.default_rng(dim * 10 + mult + in_dim)
    x = rng.standard_normal((2, 7, 9, in_dim)).astype(np.float32)
    block = JBottleneck(dim, kernel_size=3, channel_multiplier=mult, norm=norm)
    variables = jax.tree.map(np.asarray, block.init(jax.random.PRNGKey(dim + mult), jnp.asarray(x)))
    variables = jax.tree.map(lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32), variables)
    port = BottleneckBlock(dim, kernel_size=3, channel_multiplier=mult, norm=norm, in_dim=in_dim)
    port.load_state_dict(bridge.bottleneck_block_params_from_flax(variables))

    _close(port(torch.from_numpy(x)), block.apply(variables, jnp.asarray(x)), rtol=1e-5, atol=1e-5, what="eval")
    if norm != "batch":
        return
    want, updated = block.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    _close(port(torch.from_numpy(x), train=True), want, rtol=1e-5, atol=1e-5, what="train")
    got_stats = {k: v for k, v in port.state_dict().items() if "running" in k}
    want_stats = bridge.bottleneck_block_params_from_flax({"params": variables["params"], **updated})
    assert set(got_stats) == {f"norm{i}.running_{s}" for i in (1, 2, 3) for s in ("mean", "var")}
    for k, v in got_stats.items():
        _close(v, want_stats[k], rtol=1e-5, atol=1e-6, what=k)
    # and eval mode by the updated running averages
    _close(port(torch.from_numpy(x)), block.apply({"params": variables["params"], **updated}, jnp.asarray(x)),
           rtol=1e-5, atol=1e-5, what="eval after the update")


def test_bottleneck_block_is_fp32_and_shaped_as_the_basic_block():
    x = torch.randn(1, 6, 10, 32)
    out = BottleneckBlock(32)(x)
    assert out.dtype == torch.float32 and out.shape == x.shape and bool((out >= 0).all())
    assert BasicBlock(32, 32)(x).shape == x.shape
    with pytest.raises(ValueError, match="unknown norm"):
        BottleneckBlock(8, norm="layer")


# --------------------------------------------------------------------------- masks


def test_scene_box_within_matches_jax_with_points_on_the_faces():
    rng = np.random.default_rng(11)
    aabb = np.array([[-1.0, -2.0, -0.5], [1.0, 2.0, 1.5]], np.float32)
    pts = rng.uniform(-2.5, 2.5, (4000, 3)).astype(np.float32)
    on_face = pts[:600].copy()
    for i in range(600):  # a point on a face, the other coordinates inside or outside
        on_face[i, i % 3] = aabb[(i // 3) % 2, i % 3]
    pts = np.concatenate([pts, on_face, aabb, aabb.mean(0, keepdims=True)])
    got = TSB.SceneBox(torch.from_numpy(aabb)).within(torch.from_numpy(pts))
    want = np.asarray(JSB.SceneBox(jnp.asarray(aabb)).within(jnp.asarray(pts)))
    assert got.dtype == torch.bool and np.array_equal(_np(got), want)
    assert not _np(got)[4000:4602].any(), "a point on a face is outside in both"
    assert _np(got)[-1] and 0 < want.sum() < len(pts)


@pytest.mark.parametrize("rotated", [False, True])
def test_oriented_box_within_matches_jax(rotated, capsys):
    rng = np.random.default_rng(12 + rotated)
    R = _rotations(rng, 1)[0] if rotated else np.eye(3, dtype=np.float32)
    T = np.array([0.5, -1.0, 2.0], np.float32)
    S = np.array([2.0, 4.0, 1.0], np.float32)
    local = rng.uniform(-1.5, 1.5, (20000, 3)).astype(np.float32) * S
    # points on the faces of the box, in its frame
    local[:3000, np.arange(3000) % 3] = np.where(np.arange(3000) % 2 == 0, 0.5, -0.5) * S[np.arange(3000) % 3]
    pts = (local @ R.T + T).astype(np.float32)
    got = _np(TSB.OrientedBox(*(torch.from_numpy(a) for a in (R, T, S))).within(torch.from_numpy(pts)))
    want = np.asarray(JSB.OrientedBox(jnp.asarray(R), jnp.asarray(T), jnp.asarray(S)).within(jnp.asarray(pts)))
    if not rotated:
        assert np.array_equal(got, want)
        assert not got[:3000].any(), "a point on a face is outside in both"
        return
    exact = (pts.astype(np.float64) - T) @ R.astype(np.float64)
    near_face = np.any(np.abs(np.abs(exact) - S / 2.0) < 1e-6, axis=-1)
    differ = got != want
    assert not (differ & ~near_face).any(), "masks differ away from the faces"
    with capsys.disabled():
        print(f"\n[oriented box] {int(near_face.sum())} of {len(pts)} points within 1e-6 of a face; "
              f"masks differ on {int(differ.sum())}")
    assert 0 < got[3000:].sum() < len(pts) - 3000


# --------------------------------------------------------------------------- poses


def test_pose_inverse_normalize_and_transform_match_jax():
    rng = np.random.default_rng(13)
    poses = _poses(rng, 8)
    _close(TP.inverse(torch.from_numpy(poses)), JP.inverse(jnp.asarray(poses)))
    _close(TP.multiply(torch.from_numpy(poses), TP.inverse(torch.from_numpy(poses))),
           np.broadcast_to(np.eye(3, 4, dtype=np.float32), poses.shape), atol=1e-5)
    for p in (poses, np.stack([TP.to4x4(torch.from_numpy(poses)).numpy()] * 2)):
        got = TP.normalize(torch.from_numpy(p))
        _close(got, JP.normalize(jnp.asarray(p)))
        assert float(got[..., :3, 3].abs().max()) == pytest.approx(1.0)
    pts = rng.standard_normal((8, 5, 3)).astype(np.float32)
    _close(TP.transform_points(torch.from_numpy(pts), torch.from_numpy(poses)),
           JP.transform_points(jnp.asarray(pts), jnp.asarray(poses)), atol=1e-5)


def test_rotation_difference_matches_jax():
    """Random pairs, the case of `tests/core/test_poses.py::test_rotation_difference`,
    theta = 0, theta = pi and pi - 1e-3, to 1e-6."""
    rng = np.random.default_rng(14)
    r1, r2 = _rotations(rng, 64), _rotations(rng, 64)
    _close(TP.rotation_difference(torch.from_numpy(r1), torch.from_numpy(r2)),
           JP.rotation_difference(jnp.asarray(r1), jnp.asarray(r2)))

    c, s = np.cos(0.3), np.sin(0.3)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    case = TP.rotation_difference(torch.from_numpy(r1[0]), torch.from_numpy(r1[0] @ rz))
    _close(case, JP.rotation_difference(jnp.asarray(r1[0]), jnp.asarray(r1[0] @ rz)))
    assert float(torch.linalg.norm(case)) == pytest.approx(0.3, abs=1e-4)

    same = TP.rotation_difference(torch.from_numpy(r1), torch.from_numpy(r1))
    _close(same, JP.rotation_difference(jnp.asarray(r1), jnp.asarray(r1)))
    eye = torch.eye(3)
    assert torch.equal(TP.rotation_difference(eye, eye), torch.zeros(3))

    for eps in (0.0, 1e-3):  # theta = pi - eps about a random axis
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        theta = np.pi - eps
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        rot = (np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * k @ k).astype(np.float32)
        got = TP.rotation_difference(eye, torch.from_numpy(rot))
        _close(got, JP.rotation_difference(jnp.eye(3), jnp.asarray(rot)), what=f"pi - {eps}")
        # at pi the skew part vanishes and both packages return 0; just below, the angle
        assert float(torch.linalg.norm(got)) == (0.0 if eps == 0.0 else pytest.approx(theta, abs=1e-3))


def test_rotation_difference_has_a_finite_gradient_at_zero():
    """At theta = 0 JAX's gradient is NaN (arccos at 1); the port's is finite."""
    r = torch.eye(3, requires_grad=True)
    TP.rotation_difference(r, torch.eye(3)).sum().backward()
    assert torch.isfinite(r.grad).all()
    j_grad = jax.grad(lambda m: jnp.sum(JP.rotation_difference(m, jnp.eye(3))))(jnp.eye(3))
    assert not np.isfinite(np.asarray(j_grad)).all()
    # away from 0 and pi the gradients agree
    rng = np.random.default_rng(15)
    r1, r2 = _rotations(rng, 4), _rotations(rng, 4)
    r1_t = torch.from_numpy(r1).requires_grad_(True)
    TP.rotation_difference(r1_t, torch.from_numpy(r2)).sum().backward()
    j_grad = jax.grad(lambda m: jnp.sum(JP.rotation_difference(m, jnp.asarray(r2))))(jnp.asarray(r1))
    _close(r1_t.grad, j_grad, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- structs


def _bundle_arrays(rng, shape):
    return dict(
        origins=rng.standard_normal(shape + (3,)).astype(np.float32),
        directions=rng.standard_normal(shape + (3,)).astype(np.float32),
        pixel_area=rng.uniform(0.0, 1e-4, shape + (1,)).astype(np.float32),
        camera_indices=rng.integers(0, 3, shape + (1,)).astype(np.int32),
        nears=rng.uniform(0.0, 1.0, shape + (1,)).astype(np.float32),
        fars=rng.uniform(1.0, 9.0, shape + (1,)).astype(np.float32),
        times=rng.uniform(0.0, 1.0, shape + (1,)).astype(np.float32),
        metadata={"is_lidar": rng.integers(0, 2, shape + (1,)).astype(bool),
                  "directions_norm": rng.uniform(0.5, 2.0, shape + (1,)).astype(np.float32)},
    )


def test_frustum_start_positions_and_bundle_reshape_match_jax():
    rng = np.random.default_rng(16)
    f = {k: rng.standard_normal((4, 6, 3 if k in ("origins", "directions") else 1)).astype(np.float32)
         for k in ("origins", "directions", "starts", "ends", "pixel_area")}
    _close(TS.Frustums(**{k: torch.from_numpy(v) for k, v in f.items()}).get_start_positions(),
           JS.Frustums(**{k: jnp.asarray(v) for k, v in f.items()}).get_start_positions())

    arrays = _bundle_arrays(rng, (4, 6))
    to_t = lambda d: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in d.items()}
    to_j = lambda d: {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in d.items()}
    port, ref = TS.RayBundle(**to_t(arrays)), JS.RayBundle(**to_j(arrays))
    for got, want, shape in ((port.flatten(), ref.flatten(), (24,)), (port.reshape((3, 8)), ref.reshape((3, 8)), (3, 8)),
                             (port.flatten().reshape((2, 2, 6)), ref.flatten().reshape((2, 2, 6)), (2, 2, 6))):
        assert got.shape == shape and len(got) == int(np.prod(shape))
        for field in ("origins", "directions", "pixel_area", "camera_indices", "nears", "fars", "times"):
            assert getattr(got, field).dtype == getattr(port, field).dtype
            np.testing.assert_array_equal(_np(getattr(got, field)), np.asarray(getattr(want, field)), err_msg=field)
        for key in arrays["metadata"]:
            np.testing.assert_array_equal(_np(got.metadata[key]), np.asarray(want.metadata[key]), err_msg=key)


# --------------------------------------------------------------------------- configs, optimizer, NeuRAD


def _groups(cfg):
    """A preset's optimizer groups: the pipeline's, or splatfacto's per-group learning rates."""
    p = cfg.pipeline
    if hasattr(p, "optimizer_groups"):
        return p.optimizer_groups
    return {f.name[3:]: getattr(p, f.name) for f in dataclasses.fields(p) if f.name.startswith("lr_")}


@pytest.mark.parametrize("name", sorted(JMC._REGISTRY))
def test_learning_rates_at_match_jax(name):
    jcfg, tcfg = JMC.get_method_config(name), TMC.get_method_config(name)
    jg, tg = _groups(jcfg), _groups(tcfg)
    assert set(jg) == set(tg)
    if not isinstance(next(iter(tg.values())), TO.OptimizerGroupConfig):  # splatfacto: constant learning rates
        jg = {k: JO.OptimizerGroupConfig(lr=v) for k, v in jg.items()}
        tg = {k: TO.OptimizerGroupConfig(lr=v) for k, v in tg.items()}
    last = tcfg.trainer.max_num_iterations - 1
    assert last == jcfg.trainer.max_num_iterations - 1
    for step in (0, 1, 500, last):
        got, want = TO.learning_rates_at(tg, step), JO.learning_rates_at(jg, step)
        assert set(got) == set(want) and all(isinstance(v, float) for v in got.values())
        for g in want:
            np.testing.assert_allclose(got[g], want[g], rtol=1e-6, err_msg=f"{name} {g} at {step}")


def test_all_methods_match_jax():
    got = TMC.all_methods()
    assert got == JMC.all_methods() and len(got) == 13
    assert all(TMC.get_method_config(n).description == d for n, d in got.items())
    TMC.register_method("plugin-method", lambda: dataclasses.replace(TMC.get_method_config("splatad-tiny"),
                                                                     method_name="plugin-method",
                                                                     description="a plugin's method"))
    try:
        assert TMC.all_methods()["plugin-method"] == "a plugin's method"
    finally:
        del TMC.METHODS["plugin-method"]


def test_build_pipeline_gives_each_preset_its_pipeline():
    """Every preset's `pipeline_type` is JAX's and names the same pipeline
    class; the tiny presets' pipelines are built (on the CPU)."""
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig

    for name in sorted(JMC._REGISTRY):
        jcfg, tcfg = JMC.get_method_config(name), TMC.get_method_config(name)
        assert tcfg.pipeline_type == jcfg.pipeline_type, name
        assert TMC.PIPELINES[tcfg.pipeline_type].__name__ == {
            "ad": "ADPipeline", "splatad": "SplatADPipeline", "splatfacto": "SplatfactoPipeline"}[jcfg.pipeline_type]
        assert type(tcfg.pipeline).__name__ == type(jcfg.pipeline).__name__, name
    outputs = SyntheticDataParserConfig(num_frames=2, image_height=12, image_width=18, lidar_channels=4,
                                        lidar_azimuths=12).setup().get_dataparser_outputs()
    for name, cls in (("neurad-tiny", "ADPipeline"), ("splatad-tiny", "SplatADPipeline")):
        cfg = TMC.get_method_config(name)
        pipeline = cfg.build_pipeline(outputs, device="cpu")
        assert type(pipeline).__name__ == cls and pipeline.config is cfg.pipeline and pipeline.device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cfg.build_pipeline(outputs)


def test_train_and_eval_scripts_build_pipelines_through_build_pipeline():
    """The scripts have one way to build a pipeline: `MethodConfig.build_pipeline`."""
    import inspect

    from neurad_tpu_torch.scripts import eval as eval_script
    from neurad_tpu_torch.scripts import train

    source = inspect.getsource(train)
    assert "build_pipeline(" in source and "PIPELINES" not in source
    assert "Pipeline(" not in source.replace("build_pipeline(", "")
    assert "load_run(" in inspect.getsource(eval_script)


def test_num_proposal_rounds_matches_jax():
    """The property of both models on the same sampling settings, and on a
    built `neurad-tiny` model."""
    from types import SimpleNamespace

    from neurad_tpu.models.neurad import NeuRADModel as JModel
    from neurad_tpu.models.neurad import SamplingSettings as JSampling
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.models.neurad import NeuRADModel, SamplingSettings

    for counts in ((128, 64), (32,), (12, 8, 4)):
        port = NeuRADModel.num_proposal_rounds.fget(SimpleNamespace(sampling=SamplingSettings(num_proposal_samples=counts)))
        ref = JModel.num_proposal_rounds.fget(SimpleNamespace(sampling=JSampling(num_proposal_samples=counts)))
        assert port == ref == len(counts)
    outputs = SyntheticDataParserConfig(num_frames=2, image_height=12, image_width=18, lidar_channels=4,
                                        lidar_azimuths=12).setup().get_dataparser_outputs()
    model = TMC.get_method_config("neurad-tiny").build_pipeline(outputs, device="cpu").model
    assert model.num_proposal_rounds == len(model.sampling.num_proposal_samples) == 2
