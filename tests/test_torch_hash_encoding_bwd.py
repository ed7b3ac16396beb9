"""The hash-grid lookup's backward (`hash_grid_encode_bwd_plain`, the plain
version of the K1b kernel, and the `HashGridLookup` autograd function around
it) against `jax.grad` of the JAX package's `hash_encode_gaussians` /
`hash_encode`, same numpy positions, stds, tables and output gradient.

Tolerances, each relative to the sum of the absolute values of the terms an
entry adds (`magnitude=True`), since the two sides sum in different orders:
 * fp32 reads: 1e-5 for every gradient. Both sides form the same fp32 terms;
   XLA orders the product rule of the corner weights (a `jnp.prod`) and the sum
   over levels and multisamples otherwise.
 * bf16 reads, table gradients: 2^-8, one bf16 rounding of an update. Both
   sides build the update as round(round(w) * round(g * level weight)) and add
   it in fp32, so they agree much closer. The legacy single-array layout of
   the JAX package interpolates in fp32 after its bf16 read and builds fp32
   updates, where the port rounds w, g' and their product (three roundings):
   2^-6 there.
 * bf16 reads, position and std gradients: 2^-7. In the cell-packed layout
   both sides sum d w in fp32 from bf16 rows; in the unpacked layout JAX's
   autodiff sums it in bf16 (and with the legacy array, from the unrounded
   gradient), the port in fp32.
 * the hot-cell cases (`HOT_CASES`), bf16 reads, table gradients: 2^-7 +
   2^-8. XLA's fused offsets and weights may differ from the port's op-by-op
   fp32 ones by an ulp, and a weight within an ulp of a bf16 rounding tie then
   rounds to the neighbouring bf16 value on one side: one bf16 ulp of the
   weight (up to 2^-7 of it), plus each side's rounding of the product (2^-9
   each), in every update built from it. In a hot cell few samples make a
   row, so one such weight can be all of it (seen: a corner weight one fp32
   ulp below the tie, 0.80% of its row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.ops import hash_encoding as JH
from neurad_tpu_torch.ops import hash_encoding as TH

torch.set_num_threads(1)

CASES = {
    # name: (d, f, levels (n, min, max), max_rows, cell_packed, force_hash)
    "cell_packed_3d": (3, 4, (4, 8, 128), 2**12, True, False),
    "cell_packed_4d": (4, 4, (3, 4, 24), 2**12, True, False),
    "cell_packed_3d_pk2": (3, 1, (2, 16, 300), 2**19, True, False),
    "cell_packed_4d_pk2": (4, 1, (2, 4, 40), 2**19, True, False),
    "unpacked_3d": (3, 2, (4, 8, 128), 2**14, False, False),
    "unpacked_4d_hashed": (4, 4, (3, 4, 24), 2**13, False, True),
    "legacy_3d": (3, 2, (3, 8, 64), 2**11, False, None),
    "legacy_4d": (4, 2, (3, 8, 64), 2**11, False, None),
}
TOL = {False: (1e-5, 1e-5), True: (2.0**-8, 2.0**-7)}  # read_bf16 -> (tables, positions and stds)
# hot cells, as the card's backward meets them: "<layout>@one_cell" puts every
# position in one cell of the coarsest level, "<layout>@rays" lays them out as
# rays of 32 consecutive samples (a train chunk's order)
HOT_CASES = [f"{name}@{kind}" for name in ("cell_packed_3d", "cell_packed_4d", "unpacked_3d", "legacy_3d")
             for kind in ("one_cell", "rays")]


def _positions(seed, n, d, scales, kind="uniform"):
    """[n, d] in [0, 1), at least 1e-3 of a cell away from every level's faces:
    uniform, in one cell of the coarsest level (`one_cell`), or along rays of
    32 samples in order (`rays`; a dropped sample shortens its ray)."""
    rng = np.random.default_rng(seed)
    if kind == "one_cell":
        cell = rng.integers(0, int(scales[0]), d)
        pos = (cell + rng.uniform(0.05, 0.95, (8 * n, d))) / scales[0]
    elif kind == "rays":
        n_rays = -(-8 * n // 32)
        origin = rng.uniform(0.35, 0.65, (n_rays, 1, d))
        direction = rng.normal(size=(n_rays, 1, d))
        direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
        t = np.sort(rng.uniform(0.0, 0.3, (n_rays, 32, 1)), axis=1)
        pos = (origin + t * direction).reshape(-1, d)
    else:
        pos = rng.uniform(0.0, 1.0, (8 * n, d))
    pos = pos.astype(np.float32)
    frac = np.stack([(pos * s) % 1.0 for s in scales], 0)
    keep = np.all((frac > 1e-3) & (frac < 1 - 1e-3), axis=(0, 2))
    assert keep.sum() >= n
    return pos[keep][:n]


class Case:
    """One layout: the JAX and the port's arguments, and the port's flat layout."""

    def __init__(self, name, n=300, m=2):
        name, _, kind = name.partition("@")
        d, f, (nl, lo, hi), max_rows, cell_packed, force_hash = CASES[name]
        self.d, self.f, self.cell_packed, self.legacy = d, f, cell_packed, force_hash is None
        self.scales = JH.level_scales(nl, lo, hi)
        key = jax.random.PRNGKey(len(name))
        if self.legacy:
            self.table_size = max_rows
            table = np.asarray(JH.init_hash_table(key, nl, max_rows, f, scale=0.5))
            self.jtab = jnp.asarray(table)
            self.ttab = torch.from_numpy(table.copy())
            self.dense, self.packs = (None,) * nl, (1,) * nl
            self.flat_tables = lambda t: [t[l * max_rows:(l + 1) * max_rows] for l in range(nl)]
            self.buckets = [max_rows] * nl
        else:
            self.table_size = 0
            _, self.dense, self.packs = JH.level_layout(self.scales, d, max_rows, cell_packed, force_hash)
            tabs = JH.init_hash_tables(key, self.scales, d, max_rows, f, scale=0.5, cell_packed=cell_packed,
                                       force_hash=force_hash)
            self.jtab = tuple(tabs)
            self.ttab = [torch.from_numpy(np.array(t)) for t in tabs]
            self.flat_tables = lambda t: list(t)
            self.buckets = [t.shape[0] * pk for t, pk in zip(self.ttab, self.packs)]
        if name.endswith("pk2"):
            assert 2 in self.packs
        self.n, self.m, self.nl = n, m, nl
        self.pos = _positions(len(name) + 1, n * m, d, self.scales, kind or "uniform").reshape(n, m, d)
        rng = np.random.default_rng(len(name) + 2)
        # stds from 0 (every level weight clamped to 1) to past the coarsest cell
        self.std = rng.uniform(0.0, 2.0 / float(self.scales[0]), (n, m, 1)).astype(np.float32)
        self.g = rng.normal(size=(n, nl * f)).astype(np.float32)

    def kw(self):
        return dict(table_size=self.table_size, cell_packed=self.cell_packed, dense_res=self.dense,
                    bucket_pack=self.packs)

    def jax_grads(self, read_bf16, with_std):
        gd = jnp.bfloat16 if read_bf16 else None
        scales = jnp.asarray(self.scales)

        def loss(pos, std, tab):
            if with_std:
                out = JH.hash_encode_gaussians(pos, std, tab, scales, gather_dtype=gd, **self.kw())
            else:
                out = JH.hash_encode(pos[:, 0], tab, scales, gather_dtype=gd, **self.kw())
            return jnp.sum(out * jnp.asarray(self.g))

        dpos, dstd, dtab = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(self.pos), jnp.asarray(self.std), self.jtab)
        dtab = [np.asarray(dtab)] if self.legacy else [np.asarray(t) for t in dtab]
        return np.asarray(dpos), np.asarray(dstd), dtab

    def torch_grads(self, read_bf16, with_std):
        pos = torch.from_numpy(self.pos).requires_grad_(True)
        std = torch.from_numpy(self.std).requires_grad_(True)
        tab = self.ttab.clone() if self.legacy else [t.clone() for t in self.ttab]
        for t in ([tab] if self.legacy else tab):
            t.requires_grad_(True)
        gd = torch.bfloat16 if read_bf16 else None
        if with_std:
            out = TH.hash_encode_gaussians(pos, std, tab, self.scales, gather_dtype=gd, **self.kw())
        else:
            out = TH.hash_encode(pos[:, 0], tab, self.scales, gather_dtype=gd, **self.kw())
        (out * torch.from_numpy(self.g)).sum().backward()
        dtab = [tab.grad.numpy()] if self.legacy else [t.grad.numpy() for t in tab]
        return pos.grad.numpy(), (std.grad.numpy() if with_std else None), dtab

    def magnitudes(self, read_bf16, with_std):
        """Sum of |terms| of each gradient entry, in the JAX gradients' shapes."""
        m = self.m if with_std else 1
        pos = torch.from_numpy(self.pos[:, :m].reshape(-1, self.d))
        std = torch.from_numpy(self.std[:, :m].reshape(-1)) if with_std else None
        g = torch.from_numpy(np.repeat(self.g, m, axis=0) / m)
        tabs = self.flat_tables(self.ttab)
        dt, dp, ds = TH.hash_grid_encode_bwd_plain(pos, std, tabs, [float(s) for s in self.scales], self.buckets,
                                                   self.dense, self.f, read_bf16, self.cell_packed, g, magnitude=True)
        dt = [torch.cat([t.reshape(-1, t.shape[-1]) for t in dt]).numpy()] if self.legacy else [t.numpy() for t in dt]
        dp = dp.numpy().reshape(self.n, m, self.d)
        ds = ds.numpy().reshape(self.n, m, 1) if with_std else None
        return dp, ds, dt


def _close(got, want, mag, rel, what):
    err = np.abs(got - want)
    bound = rel * mag + 1e-9
    assert (err <= bound).all(), (what, float((err / (mag + 1e-9)).max()))


@pytest.mark.parametrize("read_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES) + HOT_CASES)
def test_plain_backward_matches_jax_grad(case, read_bf16):
    c = Case(case)
    want_p, want_s, want_t = c.jax_grads(read_bf16, True)
    got_p, got_s, got_t = c.torch_grads(read_bf16, True)
    mag_p, mag_s, mag_t = c.magnitudes(read_bf16, True)
    tol_t, tol_p = TOL[read_bf16]
    if read_bf16 and case in HOT_CASES:
        tol_t = 2.0**-7 + 2.0**-8
    if c.legacy and read_bf16:
        tol_t = 2.0**-6
    assert len(got_t) == len(want_t)
    for l, (gt, wt, mt) in enumerate(zip(got_t, want_t, mag_t)):
        assert gt.shape == wt.shape
        _close(gt, wt, mt.reshape(gt.shape), tol_t, f"table {l}")
    assert np.abs(want_p).max() > 1e-2 and np.abs(want_s).max() > 1e-3, "the gradients are not trivial"
    _close(got_p, want_p, mag_p, tol_p, "positions")
    _close(got_s, want_s, mag_s, tol_p, "stds")
    assert (want_s[c.std * 2 * c.scales[-1] <= 1.0] == 0).all() and (want_s == 0).any(), "clamped weights: no gradient"


@pytest.mark.parametrize("read_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["cell_packed_3d", "cell_packed_4d", "unpacked_3d", "legacy_3d"])
def test_plain_backward_without_stds_matches_jax_grad(case, read_bf16):
    c = Case(case)
    want_p, _, want_t = c.jax_grads(read_bf16, False)
    got_p, _, got_t = c.torch_grads(read_bf16, False)
    mag_p, _, mag_t = c.magnitudes(read_bf16, False)
    tol_t, tol_p = TOL[read_bf16]
    if c.legacy and read_bf16:
        tol_t = 2.0**-6
    for gt, wt, mt in zip(got_t, want_t, mag_t):
        _close(gt, wt, mt.reshape(gt.shape), tol_t, "table")
    assert (got_p[:, 1] == 0).all() and (want_p[:, 1] == 0).all()
    _close(got_p[:, :1], want_p[:, :1], mag_p, tol_p, "positions")


@pytest.mark.parametrize("read_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["cell_packed_3d", "cell_packed_4d_pk2", "unpacked_4d_hashed", "legacy_4d"])
def test_autograd_function_on_cpu_is_the_plain_backward(case, read_bf16):
    """Bit for bit: on CPU tensors `HashGridLookup.backward` is the plain
    backward. Only the inputs that require grad get a gradient."""
    c = Case(case, n=120, m=1)
    pos = torch.from_numpy(c.pos[:, 0]).requires_grad_(True)
    std = torch.from_numpy(c.std[:, 0, 0])
    tabs = [t.clone().requires_grad_(i != 0) for i, t in enumerate(c.flat_tables(c.ttab))] if not c.legacy else None
    if c.legacy:
        base = c.ttab.clone().requires_grad_(True)
        tabs = c.flat_tables(base)
    layout = ([float(s) for s in c.scales], c.buckets, c.dense, c.f, read_bf16, c.cell_packed)
    g = torch.from_numpy(c.g)
    out = TH.hash_grid_encode(pos, std, tabs, *layout)
    out.backward(g)
    want_t, want_p, want_s = TH.hash_grid_encode_bwd_plain(
        pos.detach(), std, [t.detach() for t in tabs], *layout, g, tables_grad=[t.requires_grad for t in tabs],
        positions_grad=True, stds_grad=False)
    assert want_s is None and std.grad is None
    torch.testing.assert_close(pos.grad, want_p, rtol=0, atol=0)
    if c.legacy:
        torch.testing.assert_close(base.grad, torch.cat([t.reshape(-1, t.shape[-1]) for t in want_t]), rtol=0, atol=0)
    else:
        assert tabs[0].grad is None and want_t[0] is None
        for t, w in zip(tabs[1:], want_t[1:]):
            torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


@pytest.mark.parametrize("read_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["cell_packed_3d", "unpacked_3d", "cell_packed_4d"])
def test_plain_backward_matches_autograd_of_the_plain_forward(case, read_bf16):
    """torch autograd through `hash_grid_encode_plain`: the same table update
    (its bf16 products round as the plain backward rounds them); d w, which
    autograd sums in bf16 from bf16 products, within 2^-7 of the magnitude."""
    c = Case(case, n=200, m=1)
    layout = ([float(s) for s in c.scales], c.buckets, c.dense, c.f, read_bf16, c.cell_packed)
    pos = torch.from_numpy(c.pos[:, 0]).requires_grad_(True)
    std = torch.from_numpy(c.std[:, 0, 0]).requires_grad_(True)
    tabs = [t.clone().requires_grad_(True) for t in c.ttab]
    g = torch.from_numpy(c.g)
    TH.hash_grid_encode_plain(pos, std, tabs, *layout).backward(g)
    got_t, got_p, got_s = TH.hash_grid_encode_bwd_plain(pos.detach(), std.detach(), [t.detach() for t in tabs],
                                                         *layout, g)
    mag_t, mag_p, mag_s = TH.hash_grid_encode_bwd_plain(pos.detach(), std.detach(), [t.detach() for t in tabs],
                                                        *layout, g, magnitude=True)
    tol = 2.0**-7 if read_bf16 else 1e-5
    for t, gt, mt in zip(tabs, got_t, mag_t):
        _close(gt.numpy(), t.grad.numpy(), mt.numpy(), 1e-6, "table")
    _close(got_p.numpy(), pos.grad.numpy(), mag_p.numpy(), tol, "positions")
    _close(got_s.numpy(), std.grad.numpy(), mag_s.numpy(), tol, "stds")


@pytest.mark.parametrize("cell_packed", [True, False], ids=["cell_packed", "unpacked"])
def test_positions_on_cell_faces_get_the_same_rows_and_gradients(cell_packed):
    """Positions on grid lines, on the box's faces 0 and 1, and one ulp either
    side of a face: the backward scatters into the rows the forward read, and
    both packages agree on them and on the position gradient there."""
    scales = JH.level_scales(3, 8, 64)
    max_rows = 2**12
    _, dense, packs = JH.level_layout(scales, 3, max_rows, cell_packed)
    jtabs = JH.init_hash_tables(jax.random.PRNGKey(10), scales, 3, max_rows, 4, scale=0.5, cell_packed=cell_packed)
    rng = np.random.default_rng(11)
    grid = rng.integers(0, 9, (200, 3)).astype(np.float32) / 8.0
    near = np.concatenate([np.nextafter(grid[:60], 0).astype(np.float32), np.nextafter(grid[:60], 2).astype(np.float32)])
    pos = np.clip(np.concatenate([grid, near]), 0.0, 1.0)
    g = rng.normal(size=(pos.shape[0], 12)).astype(np.float32)
    kw = dict(cell_packed=cell_packed, dense_res=dense, bucket_pack=packs, gather_dtype=None)

    def loss(p, tab):
        return jnp.sum(JH.hash_encode(p, tab, jnp.asarray(scales), **kw) * jnp.asarray(g))

    want_p, want_t = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pos), tuple(jtabs))
    tp = torch.from_numpy(pos).requires_grad_(True)
    ttabs = [torch.from_numpy(np.array(t)).requires_grad_(True) for t in jtabs]
    (TH.hash_encode(tp, ttabs, scales, **kw) * torch.from_numpy(g)).sum().backward()
    for t, w in zip(ttabs, want_t):
        w = np.asarray(w)
        # the same rows (XLA flushes subnormal products to zero, torch keeps them)
        normal = np.finfo(np.float32).tiny
        np.testing.assert_array_equal(np.abs(t.grad.numpy()) >= normal, np.abs(w) >= normal)
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_p), atol=2e-4 * float(scales[-1]) / 64, rtol=1e-5)


def test_backward_wrapper_checks_its_arguments_and_counts_no_cpu_launch():
    c = Case("cell_packed_3d", n=20, m=1)
    pos = torch.from_numpy(c.pos[:, 0])
    layout = ([float(s) for s in c.scales], c.buckets, c.dense, c.f, True, True)
    before = TH.hash_grid_bwd_launches
    dt, dp, ds = TH.hash_grid_encode_bwd(pos, None, c.ttab, *layout, torch.from_numpy(c.g), stds_grad=True)
    assert ds is None and dp.shape == pos.shape and [t.shape for t in dt] == [t.shape for t in c.ttab]
    assert TH.hash_grid_bwd_launches == before, "the CPU path launches no kernel"
    with pytest.raises(ValueError, match="g must be"):
        TH.hash_grid_encode_bwd(pos, None, c.ttab, *layout, torch.from_numpy(c.g[:5]))
    with pytest.raises(ValueError, match="g must be"):
        TH.hash_grid_encode_bwd(pos, None, c.ttab, *layout, torch.from_numpy(c.g).double())


BIG_MAX_ROWS = 2**19  # one hashed cell-packed level: 2^19 buckets x 8 corners x 4 features, fp32: 64 MiB


@pytest.mark.parametrize("read_bf16", [False, True], ids=["fp32", "bf16"])
def test_plain_backward_matches_jax_above_the_fp32_accumulation_limit(read_bf16):
    """A table gradient above `_FP32_ACCUM_MAX_BYTES` (32 MiB): JAX's
    `_interp_gather_cp_bwd` then adds the level's updates into a bf16
    accumulator, one bf16 rounding a term, where the port adds in fp32.

    Bound, per entry, relative to the sum of the absolute values of its terms
    (`magnitude=True`): the bf16 recursive sum of an entry's k terms is within
    gamma_k = k * 2^-8 / (1 - k * 2^-8) of it (k - 1 rounded additions of unit
    roundoff 2^-8, and with fp32 reads one more rounding of each term to
    bf16), plus 2^-7 + 2^-8 for a corner weight within an ulp of a bf16
    rounding tie (bf16 reads; as in the hot-cell cases above). Hot rows are in
    the case: 32 cells of 32 positions each (a ray's samples in one cell)
    beside 3072 uniform positions."""
    d, f = 3, 4
    scales = JH.level_scales(1, 96, 96)
    _, dense, packs = JH.level_layout(scales, d, BIG_MAX_ROWS, True)
    assert dense == (None,) and packs == (2,)
    (jtab,) = JH.init_hash_tables(jax.random.PRNGKey(7), scales, d, BIG_MAX_ROWS, f, scale=0.5, cell_packed=True)
    assert jtab.size * 4 > JH._FP32_ACCUM_MAX_BYTES, "JAX accumulates this level's gradient in bf16"
    rng = np.random.default_rng(8)
    cells = rng.integers(0, 96, (32, 1, d))
    hot = (cells + rng.uniform(0.05, 0.95, (32, 32, d))) / scales[0]
    pos = np.concatenate([rng.uniform(0.0, 1.0, (3072, d)), hot.reshape(-1, d)]).astype(np.float32)
    g = rng.normal(size=(pos.shape[0], f)).astype(np.float32)

    kw = dict(cell_packed=True, dense_res=dense, bucket_pack=packs, gather_dtype=jnp.bfloat16 if read_bf16 else None)
    _, vjp = jax.vjp(lambda t: JH.hash_encode(jnp.asarray(pos), (t,), jnp.asarray(scales), **kw), jtab)
    want = np.asarray(vjp(jnp.asarray(g))[0])

    ttab = torch.from_numpy(np.array(jtab))
    buckets = ttab.shape[0] * packs[0]
    layout = ([float(scales[0])], [buckets], list(dense), f, read_bf16, True)
    tpos, tg = torch.from_numpy(pos), torch.from_numpy(g)
    (got,), _, _ = TH.hash_grid_encode_bwd_plain(tpos, None, [ttab], *layout, tg, positions_grad=False)
    (mag,), _, _ = TH.hash_grid_encode_bwd_plain(tpos, None, [ttab], *layout, tg, positions_grad=False,
                                                 magnitude=True)
    bucket, _ = TH.level_index(tpos, float(scales[0]), buckets, None, True)
    terms = np.repeat(np.bincount(bucket.numpy(), minlength=buckets), 2**d * f).reshape(got.shape)
    assert terms.max() >= 32 and terms.max() * 2.0**-8 < 0.5
    gamma = terms * 2.0**-8 / (1.0 - terms * 2.0**-8)
    err, mag = np.abs(got.numpy() - want), mag.numpy()
    assert got.shape == want.shape and ((terms == 0) == (mag == 0)).all()
    assert (err <= (gamma + 2.0**-7 + 2.0**-8) * mag + 1e-9).all(), float((err / (mag + 1e-30)).max())
    shared = terms >= 2
    assert (err[shared] > 2.0**-12 * mag[shared]).any(), "JAX's bf16 sums differ from fp32 ones where rows meet"
    ratio = err / np.maximum(mag, 1e-30)
    print(f"bf16 against fp32 table-gradient sums (read_bf16={read_bf16}): at most {ratio[shared].max():.2e} of the "
          f"terms' magnitude where rows meet (up to {terms.max()} terms), {ratio[terms == 1].max():.2e} on one-term rows")
