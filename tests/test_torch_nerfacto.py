"""The nerfacto slice: the port's encodings, MLP, proposal density field,
nerfacto field, nerfacto models, their two new losses and the AD pipeline's
nerfacto train step against the JAX package's, same numpy inputs and
parameters (carried across by `nerfacto_params_from_flax`, hash tables scaled
by 100 so that the grids matter).

The random draws are the JAX package's: the sampler's key is split into one
key a round (`ray_samplers.py:239`) and each round's single jitter drawn with
`jax.random.uniform(key, (R, 1))`; the tests hand the numbers to the port.

Tolerances.
 * fp32: both sides compute in fp32. The JAX modules' MLPs are made fp32 by
   patching `MLP` in `fields/nerfacto_field.py` and `fields/density_fields.py`
   with `compute_dtype=None`, and their lookups by patching the `hash_encode`
   they call with fp32 reads; the port's modules get `compute_dtype=None` and
   `gather_dtype=None`. Outputs, losses and metrics to 1e-4 relative (of the
   output's largest entry; measured <= 7.2e-7). Gradients per tensor to
   1e-3 of the tensor's largest entry (measured 2.4e-4, in the finest hashed
   levels: an entry there is a sum of a few cancelling terms, taken in
   another order by XLA's scatter-add and the port's `index_add_`; the
   largest entry of the first MLP layer's weights, 1.7e-4, the same).
 * fp32, the pipeline's first step: the rays have no far bound, so the
   samples reach 1000 m, where the sampler's lin-disp spacing turns the
   spacing coordinates' fp32 agreement (5e-7) into centimetres: a far
   sample's rows in the fine levels may be other rows. Losses and metrics to
   1e-4 relative (measured 2.8e-7); each gradient tensor to 0.15 of its norm
   in the L2 norm of the difference (measured 0.071, the field's finest
   levels; the JAX package's own jitted and eager gradients differ by 0.011
   there).
 * fp32, the same step with the rays' far bound at the scene's farthest lidar
   return (FAR_M, 14 m; the cause above removed): each gradient per entry to
   FP32_GRAD of the tensor's largest entry, as the model alone is held
   (measured 4.4e-4, both variants, the field's finest level). The error
   left grows with the samples' reach: 6.9e-4 / 1.13e-3 (nerfacto /
   lidar-nerfacto) with the far bound at 30 m, 4.0e-4 / 8.4e-4 at 60 m, 0.42
   without one.
 * bf16 (the defaults: bf16 table reads and interpolation, bf16 MLPs), the
   pipeline's first step: JAX sums an unpacked level's corners in one fp32
   sum where the port rounds each partial sum (2^-6, `ROADMAP.md` §3); a
   linear layer's bf16 output rounds the same fp32 sum on both sides, but
   XLA on the CPU takes a bf16 bias gradient's sum over the samples in bf16
   where torch accumulates it in fp32; the proposal sampler then places the
   next round's samples by the rounded weights. Losses and metrics to 1e-4
   relative (measured 1.7e-5); each gradient tensor to 0.25 of its norm in
   the L2 norm of the difference (measured 0.14: the mlp_head biases, whose
   JAX gradients are bf16 sums of 256 terms, and the finest levels).
 * the hash encoding alone (`test_hash_encoding_matches_jax`): forward and
   backward per entry against the sum of the absolute values of its terms,
   1e-6 in fp32, 2^-6 (outputs) and 2^-7 (gradients) in bf16, as
   `tests/test_torch_hash_encoding{,_bwd}.py` hold the lookup.
"""

import contextlib
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.core.structs import GaussiansStd as JGaussians
from neurad_tpu.core.structs import RayBundle as JBundle
from neurad_tpu.data.datamanager import ADDataManagerConfig as JDMC
from neurad_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JSynth
from neurad_tpu.fields import density_fields as JDF
from neurad_tpu.fields import encodings as JEnc
from neurad_tpu.fields import mlp as JMLP
from neurad_tpu.fields import nerfacto_field as JNF
from neurad_tpu.model_components import losses as JL
from neurad_tpu.models.nerfacto import NerfactoModel as JModel
from neurad_tpu.ops import hash_encoding as JH
from neurad_tpu.pipelines.ad_pipeline import ADPipeline as JPipe
from neurad_tpu.pipelines.ad_pipeline import ADPipelineConfig as JPipeCfg
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.configs.method_configs import METHODS
from neurad_tpu_torch.core.structs import GaussiansStd, RayBundle
from neurad_tpu_torch.data.datamanager import ADDataManagerConfig as TDMC
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig as TSynth
from neurad_tpu_torch.engine import optimizers as TO
from neurad_tpu_torch.fields import encodings as TEnc
from neurad_tpu_torch.fields.density_fields import HashMLPDensityField
from neurad_tpu_torch.fields.mlp import MLP
from neurad_tpu_torch.fields.nerfacto_field import NerfactoField
from neurad_tpu_torch.model_components import losses as TL
from neurad_tpu_torch.models.nerfacto import NerfactoModel
from neurad_tpu_torch.ops import hash_encoding as TH
from neurad_tpu_torch.pipelines import ad_pipeline as TP

torch.set_num_threads(1)

AABB = ((-10.0, -10.0, -10.0), (10.0, 10.0, 10.0))
SMALL = dict(num_proposal_samples=(12, 8), num_nerf_samples=8, appearance_embedding_dim=4)
FP32 = 1e-4
FP32_GRAD = 1e-3
BF16_LOSS = 1e-4
BF16_GRAD_L2 = 0.25
FP32_PIPE_GRAD_L2 = 0.15
FAR_M = 14.0  # the synthetic scene's farthest lidar return: 13.8 m
TABLE_SCALE = 100.0


def _t(x):
    return torch.from_numpy(np.array(x))


@contextlib.contextmanager
def _jax_fp32():
    """The JAX nerfacto modules with fp32 MLPs and fp32 table reads (patched
    in the test's scope only)."""
    mp = pytest.MonkeyPatch()
    fp32_mlp = functools.partial(JMLP.MLP, compute_dtype=None)
    mp.setattr(JNF, "MLP", fp32_mlp)
    mp.setattr(JDF, "MLP", fp32_mlp)
    he = types.SimpleNamespace(**{k: getattr(JH, k) for k in dir(JH) if not k.startswith("__")})
    he.hash_encode = functools.partial(JH.hash_encode, gather_dtype=None)
    he.hash_encode_gaussians = functools.partial(JH.hash_encode_gaussians, gather_dtype=None)
    mp.setattr(JEnc, "he", he)
    try:
        yield
    finally:
        mp.undo()


def _port_fp32(module: torch.nn.Module) -> None:
    for m in module.modules():
        if isinstance(m, MLP):
            m.compute_dtype = None
        if isinstance(m, TEnc.HashEncoding):
            m.gather_dtype = None


def _scaled(tree):
    """numpy copy of a flax tree with every hash table times TABLE_SCALE."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (tuple(np.asarray(t) * TABLE_SCALE for t in v) if k == "hash_table" else walk(v))
                    for k, v in node.items()}
        return np.asarray(node)
    return walk(jax.tree.map(np.asarray, tree))


def _load(module, jparams):
    sd = bridge.nerfacto_params_from_flax(jparams, module.state_dict())
    res = module.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys and not [k for k in res.missing_keys if not k.endswith("aabb")], res


def _close(got, want, rel, what, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + 1e-9, (what, err, scale)
    return err / max(scale, 1e-12)


def _bundle(n, seed, camera_indices=True):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    arrays = dict(origins=rng.normal(size=(n, 3)) * 0.1, directions=dirs, pixel_area=np.full((n, 1), 1e-5),
                  nears=np.full((n, 1), 0.1), fars=np.full((n, 1), 30.0))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    cams = rng.integers(0, 2, (n, 1)).astype(np.int32) if camera_indices else None
    jb = JBundle(**{k: jnp.asarray(v) for k, v in arrays.items()},
                 camera_indices=None if cams is None else jnp.asarray(cams))
    tb = RayBundle(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                   camera_indices=None if cams is None else torch.from_numpy(cams).long())
    return jb, tb


def _jitters(key, n_rays, rounds=3):
    """The JAX sampler's draws for `key`, as the port's jitters."""
    return tuple(_t(jax.random.uniform(k, (n_rays, 1))) for k in jax.random.split(key, rounds))


# ---------------------------------------------------------------------------
# encodings and MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("read_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("gaussians", [False, True], ids=["points", "gaussians"])
def test_hash_encoding_matches_jax(monkeypatch, read_bf16, gaussians):
    """4 levels of 2 features from 2^12 buckets, with the bucket-packing
    threshold lowered to 2^11 rows in both packages: a dense level of one
    bucket a row, and hashed levels of two buckets a row."""
    monkeypatch.setattr(JH, "_FAST_GATHER_MAX_ROWS", 2**11)
    monkeypatch.setattr(TH, "_FAST_GATHER_MAX_ROWS", 2**11)
    kw = dict(num_levels=4, min_res=8, max_res=64, log2_hashmap_size=12, features_per_level=2)
    jenc = JEnc.HashEncoding(**kw)
    tenc = TEnc.HashEncoding(**kw)
    tenc.gather_dtype = torch.bfloat16 if read_bf16 else None
    assert tenc.dense_res[0] == 10 and tenc.dense_res[-1] is None and tenc.bucket_pack == (1, 2, 2, 2)
    assert tuple(t.shape for t in tenc.hash_table) == ((1000, 2), (2048, 4), (2048, 4), (2048, 4))
    assert tenc.out_dim == jenc.out_dim == 8
    rng = np.random.default_rng(0)
    n, m = 400, 2
    pos = rng.uniform(0.02, 0.98, (n, m, 3)).astype(np.float32)
    std = rng.uniform(0.0, 0.05, (n, m, 1)).astype(np.float32)
    g = rng.normal(size=(n, 8) if gaussians else (n, m, 8)).astype(np.float32)
    jin = JGaussians(mean=jnp.asarray(pos), std=jnp.asarray(std)) if gaussians else jnp.asarray(pos)
    jparams = _scaled(jenc.init(jax.random.PRNGKey(0), jin))
    tenc.load_state_dict({f"hash_table.{i}": _t(t).reshape(tenc.hash_table[i].shape)
                          for i, t in enumerate(jparams["params"]["hash_table"])})

    patch = contextlib.nullcontext() if read_bf16 else _jax_fp32()
    with patch:
        def f(params, p, s):
            x = JGaussians(mean=p, std=s) if gaussians else p
            return jenc.apply(params, x)

        jout, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, jparams), jnp.asarray(pos), jnp.asarray(std))
        jgp, jgpos, jgstd = vjp(jnp.asarray(g))
    tpos = torch.from_numpy(pos).requires_grad_(True)
    tstd = torch.from_numpy(std).requires_grad_(True)
    tout = tenc(GaussiansStd(mean=tpos, std=tstd) if gaussians else tpos)
    (tout * torch.from_numpy(g)).sum().backward()

    # the sum of |terms| of each output and gradient entry: the port's fp32 lookup on |tables| and |g|
    mag_enc = TEnc.HashEncoding(**kw)
    mag_enc.gather_dtype = None
    with torch.no_grad():
        for dst, src in zip(mag_enc.hash_table, tenc.hash_table):
            dst.copy_(src.abs())
    mpos = torch.from_numpy(pos).requires_grad_(True)
    mag = mag_enc(GaussiansStd(mean=mpos, std=torch.from_numpy(std)) if gaussians else mpos)
    (mag * torch.from_numpy(np.abs(g))).sum().backward()
    tol_out, tol_grad = (2.0**-6, 2.0**-7) if read_bf16 else (1e-6, 1e-6)
    err = np.abs(tout.detach().numpy() - np.asarray(jout))
    assert (err <= tol_out * mag.detach().numpy() + 1e-7).all(), float(err.max())
    assert float(np.abs(np.asarray(jout)).max()) > 1e-2
    jtables = jgp["params"]["hash_table"]
    for level, (tp, jt, mt) in enumerate(zip(tenc.hash_table, jtables, mag_enc.hash_table)):
        want = np.asarray(jt).reshape(tp.shape)
        assert (np.abs(tp.grad.numpy() - want) <= tol_grad * mt.grad.numpy() + 1e-7).all(), level
        assert np.abs(want).max() > 0


def test_sh_and_nerf_encodings_match_jax():
    rng = np.random.default_rng(1)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for levels in (1, 2, 3, 4, 5):
        want = np.asarray(JEnc.SHEncoding(levels=levels).apply({}, jnp.asarray(dirs)))
        enc = TEnc.SHEncoding(levels=levels)
        assert enc.out_dim == levels**2 == want.shape[-1]
        np.testing.assert_allclose(enc(torch.from_numpy(dirs)).numpy(), want, rtol=0, atol=1e-6)
    x = rng.uniform(-1, 1, (20, 7, 3)).astype(np.float32)
    for kw in (dict(), dict(num_frequencies=4, min_freq_exp=1.0, max_freq_exp=3.0, include_input=True)):
        jenc = JEnc.NeRFEncoding(**kw)
        want = np.asarray(jenc.apply({}, jnp.asarray(x)))
        enc = TEnc.NeRFEncoding(**kw)
        got = enc(torch.from_numpy(x)).numpy()
        assert enc.out_dim == jenc.out_dim == got.shape[-1]
        # sin and cos of arguments up to 2 pi 2^8 |x|: an fp32 ulp of the argument
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_mlp_with_skip_connections_and_out_activation_matches_jax(compute):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 10)).astype(np.float32)
    jdt, tdt = (None, None) if compute == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jm = JMLP.MLP(out_dim=3, num_layers=4, layer_width=16, skip_connections=(0, 2), out_activation=jax.nn.sigmoid,
                  compute_dtype=jdt)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    assert params["params"]["hidden_2"]["kernel"].shape == (26, 16)  # skip input at layer 2 only (never 0)
    tm = MLP(10, 3, num_layers=4, layer_width=16, compute_dtype=tdt, skip_connections=(0, 2),
             out_activation=torch.sigmoid)
    tm.load_state_dict({k[1:]: v for k, v in bridge.mlp_from_flax("", params["params"]).items()})
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and (got > 0).all() and (got < 1).all()
    # bf16: XLA and torch round a bf16 linear layer's sum differently (measured: 3.9e-3 after the sigmoid)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if compute == "fp32" else 1e-2)


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------


def _samples(n_rays, n_samples, seed):
    """(JAX RaySamples, port RaySamples) of `n_rays` rays with the same bins."""
    jb, tb = _bundle(n_rays, seed)
    rng = np.random.default_rng(seed + 1)
    edges = np.sort(rng.uniform(0.2, 25.0, (n_rays, n_samples + 1)), axis=-1).astype(np.float32)
    js = jb.get_ray_samples(jnp.asarray(edges[:, :-1, None]), jnp.asarray(edges[:, 1:, None]))
    ts = tb.get_ray_samples(torch.from_numpy(edges[:, :-1, None]), torch.from_numpy(edges[:, 1:, None]))
    return js, ts


@pytest.mark.parametrize("use_linear", [False, True], ids=["mlp_head", "linear_head"])
def test_density_field_matches_jax(use_linear):
    js, ts = _samples(24, 10, 4)
    with _jax_fp32():
        jf = JDF.HashMLPDensityField(aabb=AABB, max_res=128, log2_hashmap_size=17, use_linear=use_linear)
        jparams = _scaled(jf.init(jax.random.PRNGKey(5), js))
        want = np.asarray(jf.apply(jax.tree.map(jnp.asarray, jparams), js))
    tf = HashMLPDensityField(aabb=AABB, max_res=128, log2_hashmap_size=17, use_linear=use_linear)
    _port_fp32(tf)
    sd = bridge._hash_encoding("encoding", jparams["params"]["encoding"], tf.state_dict())
    head = jparams["params"]["head"]
    sd.update(bridge._dense("head", head) if use_linear else bridge.mlp_from_flax("head", head))
    tf.load_state_dict(sd)
    got = tf.get_density(ts).detach().numpy()
    assert got.shape == (24, 10, 1)
    _close(got, want, FP32, "density")


@pytest.mark.parametrize("camera_indices", [True, False], ids=["per_image", "mean_embedding"])
def test_nerfacto_field_matches_jax(camera_indices):
    js, ts = _samples(16, 6, 6)
    if not camera_indices:
        js, ts = js.replace(camera_indices=None), ts.replace(camera_indices=None)
    with _jax_fp32():
        jf = JNF.NerfactoField(aabb=AABB, num_images=2, appearance_embedding_dim=4)
        jparams = _scaled(jf.init(jax.random.PRNGKey(7), js))
        want = jf.apply(jax.tree.map(jnp.asarray, jparams), js)
    tf = NerfactoField(aabb=AABB, num_images=2, appearance_embedding_dim=4)
    _port_fp32(tf)
    assert tf.encoding.bucket_pack.count(2) == 11 and tf.encoding.hash_table[-1].shape == (2**18, 4)
    p = jparams["params"]
    sd = bridge._hash_encoding("encoding", p["encoding"], tf.state_dict())
    sd.update(bridge.mlp_from_flax("mlp_base", p["mlp_base"]))
    sd.update(bridge.mlp_from_flax("mlp_head", p["mlp_head"]))
    sd["appearance_embedding.weight"] = _t(p["appearance_embedding"]["embedding"])
    tf.load_state_dict(sd)
    got = tf(ts)
    _close(got.density.detach().numpy(), np.asarray(want.density), FP32, "density")
    _close(got.rgb.detach().numpy(), np.asarray(want.rgb), FP32, "rgb")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def test_new_losses_and_their_gradients_match_jax():
    rng = np.random.default_rng(8)
    r, s = 12, 9
    w = rng.uniform(0, 0.3, (r, s, 1)).astype(np.float32)
    steps = np.sort(rng.uniform(0.5, 10, (r, s, 1)), axis=1).astype(np.float32)
    depth = rng.uniform(0.5, 10, (r, 1)).astype(np.float32)
    depth[:3] = 0.0  # rays without a return: no depth loss
    lengths = rng.uniform(0.1, 1.0, (r, s, 1)).astype(np.float32)
    sigma = 0.5
    jf = lambda w_, st: JL.ds_nerf_depth_loss(w_, jnp.asarray(depth), st, jnp.asarray(lengths), jnp.asarray(sigma))
    jloss, (jgw, jgs) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(steps))
    tw, ts = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(steps).requires_grad_(True)
    tloss = TL.ds_nerf_depth_loss(tw, torch.from_numpy(depth), ts, torch.from_numpy(lengths), torch.tensor(sigma))
    tloss.backward()
    _close(float(tloss.detach()), float(jloss), 1e-6, "ds-nerf loss", scale=abs(float(jloss)))
    _close(tw.grad.numpy(), np.asarray(jgw), 1e-6, "d weights")
    _close(ts.grad.numpy(), np.asarray(jgs), 1e-5, "d steps")
    assert float(np.abs(np.asarray(jgw)[:3]).max()) == 0.0

    values = rng.normal(size=(r, s, 3)).astype(np.float32)
    dist = rng.uniform(0.0, 2.0, (r, s, 1)).astype(np.float32)
    cot = rng.normal(size=(r, s, 3)).astype(np.float32)
    jout, vjp = jax.vjp(lambda v: JL.gradient_scaling_by_distance_squared(v, jnp.asarray(dist)), jnp.asarray(values))
    tv = torch.from_numpy(values).requires_grad_(True)
    tout = TL.gradient_scaling_by_distance_squared(tv, torch.from_numpy(dist))
    tout.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tv.grad.numpy(), cot * np.clip(dist**2, 0, 1), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["nerfacto", "lidar-nerfacto"])
def test_model_outputs_losses_and_gradients_match_jax(variant):
    """fp32 on both sides. The lidar variant also scales the gradients by
    distance and takes a depth per ray."""
    lidar = variant == "lidar-nerfacto"
    n = 24
    jb, tb = _bundle(n, 9)
    extra = dict(use_lidar_losses=True, use_gradient_scaling=True, depth_sigma=0.5) if lidar else {}
    rng = np.random.default_rng(10)
    batch = {"image": rng.uniform(size=(n, 3)).astype(np.float32)}
    if lidar:
        batch["distance"] = rng.uniform(0.5, 12.0, (n, 1)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    with _jax_fp32():
        jm = JModel(aabb=AABB, num_images=2, **SMALL, **extra)
        jparams = _scaled(jm.init(jax.random.PRNGKey(0), jb, True, jax.random.PRNGKey(1)))

        def loss(params):
            out = jm.apply(params, jb, True, key)
            total, metrics = jm.apply(params, out, {k: jnp.asarray(v) for k, v in batch.items()},
                                      method=JModel.compute_losses)
            return total, (metrics, out)

        (jtotal, (jmetrics, jout)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree.map(jnp.asarray, jparams))
    tm = NerfactoModel(aabb=AABB, num_images=2, **SMALL, **extra)
    _port_fp32(tm)
    _load(tm, jparams)
    tout = tm.get_outputs(tb, train=True, jitters=_jitters(key, n))
    ttotal, tmetrics = tm.compute_losses(tout, {k: torch.from_numpy(v) for k, v in batch.items()})
    ttotal.backward()

    keys = {"rgb", "accumulation", "depth", "prop_depth_0", "prop_depth_1", "weights_list", "sdist_list"}
    assert keys | ({"weights", "ray_samples_mids"} if lidar else set()) == set(tout) == set(jout)
    for k in ("rgb", "accumulation", "depth", "prop_depth_0", "prop_depth_1"):
        _close(tout[k].detach().numpy(), jout[k], FP32, k)
    for i, (tw, jw) in enumerate(zip(tout["weights_list"], jout["weights_list"])):
        _close(tw.detach().numpy(), jw, FP32, f"weights {i}")
    assert set(tmetrics) == set(jmetrics) == ({"psnr", "rgb_loss", "interlevel_loss", "distortion_loss"}
                                              | ({"depth_loss"} if lidar else set()))
    _close(float(ttotal.detach()), float(jtotal), FP32, "total", scale=abs(float(jtotal)))
    for k, v in jmetrics.items():
        _close(float(tmetrics[k]), float(v), FP32, k, scale=abs(float(v)))
    if lidar:
        assert float(jmetrics["depth_loss"]) > 1e-6
    want = bridge.nerfacto_params_from_flax(jax.tree.map(np.asarray, jgrads), tm.state_dict())
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), FP32_GRAD, name)
        assert float(want[name].abs().max()) > 0, name


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

SCENE = dict(num_frames=3, image_height=24, image_width=36, lidar_channels=4, lidar_azimuths=30)
BATCH = dict(num_cam_patches=2, patch_size=4, rgb_upsample_factor=1)  # 32 camera rays, one a pixel
LIDAR_RAYS = 32


def _dm(cls, variant):
    return cls(**BATCH, num_lidar_rays=LIDAR_RAYS if variant == "lidar-nerfacto" else 0)


_JAX = {}


def _jax_pipeline(variant):
    """(JAX pipeline with its tables scaled, its state); built once a variant,
    the datamanager put back to the batch after `init_state`'s each call."""
    if variant not in _JAX:
        cfg = JPipeCfg(datamanager=_dm(JDMC, variant), model=variant, eval_shard=False, model_overrides=dict(SMALL))
        jp = JPipe(JSynth(**SCENE).setup().get_dataparser_outputs(), cfg)
        state, _ = jp.init_state()
        state = state.replace(params=jax.tree.map(jnp.asarray, _scaled(state.params)))
        _JAX[variant] = (jp, state, jp.datamanager.rng_state())
    jp, state, rng_state = _JAX[variant]
    jp.datamanager.set_rng_state(rng_state)
    return jp, state


def _port_pipeline(variant, jparams):
    cfg = TP.ADPipelineConfig(datamanager=_dm(TDMC, variant), model=variant, model_overrides=dict(SMALL))
    tp = TP.ADPipeline(TSynth(**SCENE).setup().get_dataparser_outputs(), cfg, device="cpu")
    _load(tp.model, jax.tree.map(np.asarray, jparams))
    return tp, tp.init_state()


def _jax_lidar_loss(jp):
    """The JAX model's loss as the port's pipeline takes it: the camera rays'
    rgb, the lidar rays' weights for the depth loss."""
    n_cam = jp.num_cam_rays

    def loss(params, bundle, batch, rng):
        out = jp.model.apply(params, bundle, True, rng)
        nb = dict(batch, image=batch["image"].reshape(-1, 3)[:n_cam])
        out = dict(out, rgb=out["rgb"][:n_cam], weights=out["weights"][n_cam:],
                   ray_samples_mids=out["ray_samples_mids"][n_cam:])
        return jp.model.apply(params, out, nb, method=JModel.compute_losses)

    return loss


@pytest.mark.parametrize("numerics", ["fp32", "fp32-far14m", "bf16"])
@pytest.mark.parametrize("variant", ["nerfacto", "lidar-nerfacto"])
def test_pipeline_first_step_matches_jax(variant, numerics):
    """The batch after `init_state`'s, the JAX step's key and draws: the loss
    dict and every parameter's gradient, in fp32 (also with the rays' far
    bound at FAR_M) and in the default (bf16) numerics. The lidar variant is held against the JAX model's loss taken
    on the lidar rays (`_jax_lidar_loss`): the JAX pipeline's own `loss_fn`
    fails on a batch with lidar rays
    (`test_jax_lidar_nerfacto_step_fails_on_lidar_rays`)."""
    lidar = variant == "lidar-nerfacto"
    jp, jstate = _jax_pipeline(variant)
    tp, tstate = _port_pipeline(variant, jstate.params)
    fp32 = numerics.startswith("fp32")
    if fp32:
        _port_fp32(tp.model)
    jb, jbatch = jp.datamanager.next_train()
    tb, tbatch = tp.datamanager.next_train()
    np.testing.assert_array_equal(tb.origins.numpy(), np.asarray(jb.origins))
    if numerics == "fp32-far14m":
        jb = jb.replace(fars=jnp.full_like(jb.pixel_area, FAR_M))
        tb = tb.replace(fars=torch.full_like(tb.pixel_area, FAR_M))
    assert tb.origins.shape[0] == 32 + (LIDAR_RAYS if lidar else 0)
    _, step_rng = jax.random.split(jstate.rng)
    loss_fn = _jax_lidar_loss(jp) if lidar else jp.loss_fn
    with _jax_fp32() if fp32 else contextlib.nullcontext():
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params, jb, jbatch,
                                                                                       step_rng)
    draws = [TP.ChunkDraws(_jitters(step_rng, tb.origins.shape[0]), None)]
    tloss, tmetrics = tp.loss_fn(tb, tbatch, draws)
    tloss.backward()
    assert set(tmetrics) == set(jmetrics)
    assert ("depth_loss" in tmetrics) == lidar
    loss_tol = FP32 if fp32 else BF16_LOSS
    _close(float(tloss.detach()), float(jloss), loss_tol, "total", scale=abs(float(jloss)))
    for k, v in jmetrics.items():
        _close(float(tmetrics[k]), float(v), loss_tol, k, scale=abs(float(v)))
    want = bridge.nerfacto_params_from_flax(jax.tree.map(np.asarray, jgrads), tp.model.state_dict())
    labels = TO.label_params(want, TO.DEFAULT_GROUP_RULES)
    assert set(labels.values()) == {"fields", "hashgrids"}
    for name, p in tp.model.named_parameters():
        got, w = p.grad.numpy(), want[name].numpy()
        assert np.abs(w).max() > 0, name
        if numerics == "fp32-far14m":
            _close(got, w, FP32_GRAD, name)
            continue
        bound = FP32_PIPE_GRAD_L2 if numerics == "fp32" else BF16_GRAD_L2
        assert np.linalg.norm(got - w) <= bound * np.linalg.norm(w), name

    # one step of the port's own: draws from its generator, the step counted
    tp.model.zero_grad()
    tstate, metrics = tp.train_step(tstate, tb, tbatch)
    assert tstate.step == 1 and tstate.optimizers.count == 1 and math.isfinite(float(metrics["total_loss"]))


def test_jax_lidar_nerfacto_step_fails_on_lidar_rays():
    """The fault the port's pipeline repairs: JAX's `loss_fn` hands the model
    the weights of every ray and the distances of the lidar rays only, and
    the DS-NeRF loss cannot broadcast them."""
    jp, jstate = _jax_pipeline("lidar-nerfacto")
    jb, jbatch = jp.datamanager.next_train()
    with pytest.raises(TypeError, match="broadcast"):  # raised while tracing, as the JAX train step traces it
        jax.jit(jp.loss_fn)(jstate.params, jb, jbatch, jax.random.PRNGKey(0))


def test_nerfacto_eval_and_renders_raise_in_the_port():
    """The JAX package cannot evaluate a nerfacto model (AttributeError in its
    renders); the port raises NotImplementedError at the same calls."""
    jp, jstate = _jax_pipeline("nerfacto")
    with pytest.raises(AttributeError):
        jp.eval_metrics(jstate)
    tp, _ = _port_pipeline("nerfacto", jstate.params)
    for call in (tp.eval_metrics, lambda: tp.eval_fid_suite(max_images=1), lambda: tp.render_eval_camera(0),
                 lambda: tp.render_eval_lidar(0), lambda: tp.render_viewer_image(np.eye(4)[:3], 8, 6, 0.0),
                 lambda: tp.render_virtual_lidar(np.zeros(3), 0.0)):
        with pytest.raises(NotImplementedError, match="JAX package cannot evaluate"):
            call()


def test_presets_build_the_nerfacto_pipelines():
    for name, lidar in (("nerfacto", False), ("nerfacto-lidar", True)):
        cfg = METHODS[name]()
        dm = cfg.pipeline.datamanager
        assert cfg.pipeline.model == ("lidar-nerfacto" if lidar else "nerfacto")
        assert (dm.num_cam_patches, dm.patch_size, dm.rgb_upsample_factor) == (64, 8, 1)
        assert dm.num_lidar_rays == (4096 if lidar else 0)
