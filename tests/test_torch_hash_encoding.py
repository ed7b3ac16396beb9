"""The port's hash encoding (`neurad_tpu_torch/ops/hash_encoding.py`, on the CPU
its plain version) against the JAX package's, same numpy positions and tables.

Tolerances. With fp32 reads both sides do the same fp32 arithmetic on the same
rows, up to the order of the corner weights' product and of the corner sum:
1e-6 absolute on features of magnitude <= 1. With bf16 reads XLA may keep
excess precision between the fused bf16 multiplies and adds where torch rounds
after every operation, so an output is held to 2^-7 of the sum of the absolute
values of its terms (two bf16 ulps of the largest partial sum) in the
cell-packed layout, whose corner sum both sides take in order. In the unpacked
layout the JAX package sums the corners with one `jnp.sum` (XLA accumulates it
in fp32 and rounds once) where the port rounds each of the up to 15 partial
sums: 2^-6 there (measured: up to 0.009). Positions are
drawn away from cell faces where the point is the arithmetic (a position that
scales to within rounding of an integer may floor differently under XLA's and
torch's multiply only if they differed, which they do not: the faces test
checks exactly that, in fp32, to the same tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurad_tpu.ops import hash_encoding as JH
from neurad_tpu_torch.ops import hash_encoding as TH

torch.set_num_threads(1)

FP32_TOL = 1e-6
BF16_REL = {True: 2.0**-7, False: 2.0**-6}  # by cell_packed


def _tables(seed, scales, d, max_rows, f, cell_packed, force_hash=False, scale=0.5):
    tabs = JH.init_hash_tables(jax.random.PRNGKey(seed), scales, d, max_rows, f, scale=scale, cell_packed=cell_packed,
                               force_hash=force_hash)
    return tabs, tuple(torch.from_numpy(np.array(t)) for t in tabs)


def _positions(seed, n, d, scales):
    """[n, d] in [0, 1), at least 1e-3 of a cell away from every level's faces."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (4 * n, d)).astype(np.float32)
    frac = np.stack([(pos * s) % 1.0 for s in scales], 0)
    keep = np.all((frac > 1e-3) & (frac < 1 - 1e-3), axis=(0, 2))
    assert keep.sum() >= n
    return pos[keep][:n]


def _magnitude(pos, ttabs, scales, dense, packs, f, cell_packed):
    """Sum over corners of |row| * w per output, from the plain version on |tables|."""
    buckets = [t.shape[0] * pk for t, pk in zip(ttabs, packs)]
    return TH.hash_grid_encode_plain(torch.from_numpy(pos), None, [t.abs() for t in ttabs],
                                     [float(s) for s in scales], buckets, dense, f, False, cell_packed).numpy()


@pytest.mark.parametrize("num_levels,min_res,max_res", [(8, 32, 8192), (4, 64, 1024), (6, 128, 4096), (1, 16, 16),
                                                        (4, 16, 256)])
def test_level_scales_identical(num_levels, min_res, max_res):
    np.testing.assert_array_equal(TH.level_scales(num_levels, min_res, max_res),
                                  JH.level_scales(num_levels, min_res, max_res))


@pytest.mark.parametrize("d,max_rows,cell_packed,force_hash", [
    (3, 2**22 // 8, True, False), (4, 2**17 // 16, True, False), (3, 2**22, False, False), (3, 2**22, False, True),
    (3, 2**20 // 8, True, False), (4, 2**15, False, True), (3, 2**13 // 8, True, False),
])
def test_layout_functions_identical(d, max_rows, cell_packed, force_hash):
    scales = JH.level_scales(8 if d == 3 else 4, 32 if d == 3 else 64, 8192 if d == 3 else 1024)
    assert TH.level_rows(scales, d, max_rows, cell_packed) == JH.level_rows(scales, d, max_rows, cell_packed)
    assert (TH.level_layout(scales, d, max_rows, cell_packed, force_hash)
            == JH.level_layout(scales, d, max_rows, cell_packed, force_hash))
    shapes = TH.table_physical_shapes(scales, d, max_rows, 4, cell_packed, force_hash)
    assert shapes == JH.table_physical_shapes(scales, d, max_rows, 4, cell_packed, force_hash)
    if max_rows <= 2**15:
        gen = torch.Generator().manual_seed(0)
        tabs = TH.init_hash_tables(gen, scales, d, max_rows, 4, cell_packed=cell_packed, force_hash=force_hash)
        assert tuple(tuple(t.shape) for t in tabs) == shapes
        assert all(t.dtype == torch.float32 and float(t.abs().max()) <= 1e-3 for t in tabs)
    np.testing.assert_array_equal(TH._corner_offsets(d), JH._corner_offsets(d))


def test_full_width_field_layout():
    """The `neurad` preset's static grid: two dense levels (the second, 71^3 = 357,911 buckets, stored two a
    row like the hashed ones) and six hashed levels of 2^19 buckets stored two a row."""
    scales = TH.level_scales(8, 32, 8192)
    rows, dense, packs = TH.level_layout(scales, 3, 2**22 // 8, True)
    assert rows == (33**3, 71**3) + (2**19,) * 6 and dense == (33, 71) + (None,) * 6 and packs == (1,) + (2,) * 7
    shapes = TH.table_physical_shapes(scales, 3, 2**19, 4, True)
    assert shapes[1] == (178956, 64) and shapes[2] == (2**18, 64)


@pytest.mark.parametrize("d", [3, 4])
def test_hash_matches_on_overflowing_products(d):
    rng = np.random.default_rng(d)
    coords = np.concatenate([rng.integers(0, 2**31 - 1, (4000, d)), rng.integers(0, 9000, (4000, d)),
                             rng.integers(-5, 5, (200, d))]).astype(np.int32)
    for size in (2**19, 2**22, 1000003, 1):
        want = np.asarray(JH._hash(jnp.asarray(coords), size))
        got = TH._hash(torch.from_numpy(coords), size).numpy()
        np.testing.assert_array_equal(got, want)
    # products do exceed 32 bits
    assert (coords[:, 1].astype(np.int64) * 2654435761 > 2**40).any()


def test_dense_index_matches_and_clips():
    coords = np.random.default_rng(0).integers(-3, 40, (500, 3)).astype(np.int32)
    want = np.asarray(JH._dense_index(jnp.asarray(coords), 33))
    np.testing.assert_array_equal(TH._dense_index(torch.from_numpy(coords), 33).numpy(), want)


CASES = {
    # name: (d, f, levels (n, min, max), max_rows, cell_packed, force_hash)
    "cell_packed_dense_and_hashed_3d": (3, 4, (4, 8, 128), 2**12, True, False),
    "cell_packed_4d": (4, 4, (3, 4, 24), 2**12, True, False),
    "cell_packed_one_feature": (3, 1, (4, 8, 128), 2**12, True, False),
    "unpacked_3d": (3, 2, (4, 8, 128), 2**14, False, False),
    "unpacked_4d": (4, 4, (3, 4, 24), 2**13, False, False),
    "unpacked_all_hashed": (3, 4, (4, 8, 128), 2**12, False, True),
}


@pytest.mark.parametrize("read_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_hash_encode_gaussians_matches(case, read_bf16):
    d, f, (nl, lo, hi), max_rows, cell_packed, force_hash = CASES[case]
    scales = JH.level_scales(nl, lo, hi)
    _, dense, packs = JH.level_layout(scales, d, max_rows, cell_packed, force_hash)
    if not force_hash:
        assert any(r is not None for r in dense) and any(r is None for r in dense)
    jtabs, ttabs = _tables(1, scales, d, max_rows, f, cell_packed, force_hash)
    n, m = 600, 2
    pos = _positions(2, n * m, d, scales).reshape(n, m, d)
    std = np.random.default_rng(3).uniform(0.0, 0.05, (n, m, 1)).astype(np.float32)
    kw = dict(cell_packed=cell_packed, dense_res=dense, bucket_pack=packs)
    want = np.asarray(JH.hash_encode_gaussians(jnp.asarray(pos), jnp.asarray(std), jtabs, jnp.asarray(scales),
                                               gather_dtype=jnp.bfloat16 if read_bf16 else None, **kw))
    got = TH.hash_encode_gaussians(torch.from_numpy(pos), torch.from_numpy(std), ttabs, scales,
                                   gather_dtype=torch.bfloat16 if read_bf16 else None, **kw).numpy()
    assert got.shape == want.shape == (n, nl * f) and np.abs(want).max() > 0.05
    if read_bf16:
        mag = _magnitude(pos.reshape(-1, d), ttabs, scales, dense, packs, f, cell_packed).reshape(n, m, -1).mean(1)
        assert (np.abs(got - want) <= BF16_REL[cell_packed] * mag + 1e-7).all(), float((np.abs(got - want) / (mag + 1e-7)).max())
    else:
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)


def test_level_weights_match():
    scales = JH.level_scales(4, 8, 128)
    std = np.random.default_rng(0).uniform(0, 0.2, (50, 2, 1)).astype(np.float32)
    want = np.asarray(JH.gaussian_level_weights(jnp.asarray(std), jnp.asarray(scales)))
    got = TH.gaussian_level_weights(torch.from_numpy(std), torch.from_numpy(scales)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7)
    assert got.min() < 0.5 and got.max() == 1.0
    # an explicit level_weights argument weights each level's features after the lookup, as in JAX
    jtabs, ttabs = _tables(4, scales, 3, 2**12, 2, True)
    _, dense, packs = JH.level_layout(scales, 3, 2**12, True)
    pos = _positions(5, 50, 3, scales)
    lw = np.random.default_rng(6).uniform(0.1, 1.0, (50, 4)).astype(np.float32)
    kw = dict(cell_packed=True, dense_res=dense, bucket_pack=packs, gather_dtype=None)
    want = np.asarray(JH.hash_encode(jnp.asarray(pos), jtabs, jnp.asarray(scales), level_weights=jnp.asarray(lw), **kw))
    got = TH.hash_encode(torch.from_numpy(pos), ttabs, scales, level_weights=torch.from_numpy(lw), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("read_bf16", [False, True], ids=["fp32", "bf16"])
def test_bucket_packed_level_matches(read_bf16):
    """A level above 2^18 buckets is stored two buckets a physical row
    (`bucket_pack` = 2); one feature a level keeps the table at 16 MB."""
    scales = np.array([16.0, 300.0], np.float32)
    max_rows = 2**19
    rows, dense, packs = JH.level_layout(scales, 3, max_rows, True)
    assert packs == (1, 2) and dense == (17, None) and TH.level_layout(scales, 3, max_rows, True)[2] == packs
    jtabs, ttabs = _tables(7, scales, 3, max_rows, 1, True)
    assert ttabs[1].shape == (2**18, 16)
    pos = _positions(8, 800, 3, scales)
    kw = dict(cell_packed=True, dense_res=dense, bucket_pack=packs)
    want = np.asarray(JH.hash_encode(jnp.asarray(pos), jtabs, jnp.asarray(scales),
                                     gather_dtype=jnp.bfloat16 if read_bf16 else None, **kw))
    got = TH.hash_encode(torch.from_numpy(pos), ttabs, scales, gather_dtype=torch.bfloat16 if read_bf16 else None,
                         **kw).numpy()
    if read_bf16:
        mag = _magnitude(pos, ttabs, scales, dense, packs, 1, True)
        assert (np.abs(got - want) <= BF16_REL[True] * mag + 1e-7).all()
    else:
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)
    # both buckets of a physical row are reached
    bucket = TH._hash(torch.floor(torch.from_numpy(pos) * 300.0).long(), 2**19)
    assert set((bucket % 2).tolist()) == {0, 1}


@pytest.mark.parametrize("d", [3, 4])
def test_legacy_single_array_matches(d):
    nl, size, f = 3, 2048, 2
    scales = JH.level_scales(nl, 8, 64)
    table = JH.init_hash_table(jax.random.PRNGKey(0), nl, size, f, scale=0.5)
    pos = _positions(9, 500, d, scales)
    want = np.asarray(JH.hash_encode(jnp.asarray(pos), table, jnp.asarray(scales), table_size=size, gather_dtype=None))
    got = TH.hash_encode(torch.from_numpy(pos), torch.from_numpy(np.array(table)), scales, table_size=size,
                         gather_dtype=None).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)
    gen = torch.Generator().manual_seed(0)
    assert TH.init_hash_table(gen, nl, size, f).shape == table.shape


@pytest.mark.parametrize("cell_packed", [True, False], ids=["cell_packed", "unpacked"])
def test_positions_on_cell_faces_take_the_same_rows(cell_packed):
    """Positions exactly on grid lines, on the box's faces 0 and 1, and one ulp
    either side of a face: a different floor would fetch another row, and with
    per-cell corner features the result would jump."""
    scales = JH.level_scales(3, 8, 64)
    max_rows = 2**12
    _, dense, packs = JH.level_layout(scales, 3, max_rows, cell_packed)
    jtabs, ttabs = _tables(10, scales, 3, max_rows, 4, cell_packed)
    rng = np.random.default_rng(11)
    grid = rng.integers(0, 9, (300, 3)).astype(np.float32) / 8.0  # on faces of the coarsest level, 0 and 1 included
    near = np.concatenate([np.nextafter(grid[:100], 0).astype(np.float32), np.nextafter(grid[:100], 2).astype(np.float32)])
    pos = np.clip(np.concatenate([grid, near, (rng.integers(0, 65, (300, 3)) / 64.0).astype(np.float32)]), 0.0, 1.0)
    kw = dict(cell_packed=cell_packed, dense_res=dense, bucket_pack=packs, gather_dtype=None)
    want = np.asarray(JH.hash_encode(jnp.asarray(pos), jtabs, jnp.asarray(scales), **kw))
    got = TH.hash_encode(torch.from_numpy(pos), ttabs, scales, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)


def test_bf16_interpolation_rounds_after_every_operation():
    """The plain version's bf16 mode against an independent numpy model of it:
    table and weights rounded to bf16, every product and partial sum rounded."""
    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()

    scales = np.array([8.0], np.float32)
    gen = torch.Generator().manual_seed(0)
    (table,) = TH.init_hash_tables(gen, scales, 3, 2**12, 4, scale=1.0, cell_packed=True)
    pos = _positions(12, 200, 3, scales)
    got = TH.hash_encode(torch.from_numpy(pos), (table,), scales, cell_packed=True, dense_res=(9,)).numpy()
    scaled = pos * np.float32(8.0)
    cell = np.floor(scaled)
    off = scaled - cell
    idx = ((cell[:, 0] * 9 + cell[:, 1]) * 9 + cell[:, 2]).astype(np.int64)
    rows = bf16(table.numpy()[idx]).reshape(-1, 8, 4)
    acc = None
    for c in range(8):
        w = np.ones(len(pos), np.float32)
        for i in range(3):
            w = w * (off[:, i] if (c >> i) & 1 else np.float32(1.0) - off[:, i])
        term = bf16(rows[:, c] * bf16(w)[:, None])
        acc = term if acc is None else bf16(acc + term)
    np.testing.assert_array_equal(got, acc)


def test_wrapper_checks_its_arguments():
    scales = TH.level_scales(2, 8, 16)
    gen = torch.Generator().manual_seed(0)
    tabs = TH.init_hash_tables(gen, scales, 3, 2**12, 4, cell_packed=True)
    _, dense, _ = TH.level_layout(scales, 3, 2**12, True)
    assert dense == (9, None)
    args = ([8.0, 16.0], [t.shape[0] for t in tabs], dense, 4, True, True)
    pos = torch.rand(10, 3)
    assert TH.hash_grid_encode(pos, None, tabs, *args).shape == (10, 8)
    with pytest.raises(ValueError, match="float32"):
        TH.hash_grid_encode(pos.double(), None, tabs, *args)
    with pytest.raises(ValueError, match=r"\[N, 3 or 4\]"):
        TH.hash_grid_encode(torch.rand(10, 2), None, tabs, *args)
    with pytest.raises(ValueError, match="stds"):
        TH.hash_grid_encode(pos, torch.rand(9), tabs, *args)
    with pytest.raises(ValueError, match="does not hold"):
        TH.hash_grid_encode(pos, None, tabs, [8.0, 16.0], [5, 5], dense, 4, True, True)
    with pytest.raises(ValueError, match="gather_dtype"):
        TH.hash_encode(pos, tabs, scales, gather_dtype=torch.float16)
    before = TH.hash_grid_launches
    TH.hash_grid_encode(pos, None, tabs, *args)
    assert TH.hash_grid_launches == before, "the CPU path launches no kernel"


def test_cpu_path_is_differentiable():
    """On the CPU autograd differentiates the plain version (tables and positions)."""
    scales = TH.level_scales(2, 8, 16)
    gen = torch.Generator().manual_seed(0)
    tabs = [t.requires_grad_(True) for t in TH.init_hash_tables(gen, scales, 3, 2**12, 2, scale=1.0, cell_packed=True)]
    pos = torch.from_numpy(_positions(13, 40, 3, scales)).requires_grad_(True)
    out = TH.hash_encode(pos, tabs, scales, cell_packed=True, dense_res=(9, None), gather_dtype=None)
    out.square().sum().backward()
    assert all(t.grad is not None and float(t.grad.abs().sum()) > 0 for t in tabs)
    assert pos.grad is not None and bool(torch.isfinite(pos.grad).all()) and float(pos.grad.abs().sum()) > 0


@pytest.mark.parametrize("case", ["cell_packed_dense_and_hashed_3d", "cell_packed_4d", "unpacked_3d",
                                  "cell_packed_one_feature"])
def test_plain_on_the_bf16_copy_equals_bf16_reads_of_the_master(case):
    """bf16 reads of the fp32 master round each value to bf16 (nearest even);
    the bf16 copy holds those values, so the plain lookup on the copy gives the
    same bits, and both match the JAX package's bf16 lookup."""
    d, f, (nl, lo, hi), max_rows, cell_packed, force_hash = CASES[case]
    scales = JH.level_scales(nl, lo, hi)
    _, dense, packs = JH.level_layout(scales, d, max_rows, cell_packed, force_hash)
    jtabs, ttabs = _tables(14, scales, d, max_rows, f, cell_packed, force_hash)
    pos = _positions(15, 700, d, scales)
    std = np.random.default_rng(16).uniform(0.0, 0.05, 700).astype(np.float32)
    buckets = [t.shape[0] * pk for t, pk in zip(ttabs, packs)]
    args = ([float(s) for s in scales], buckets, dense, f, True, cell_packed)
    tpos, tstd = torch.from_numpy(pos), torch.from_numpy(std)
    master = TH.hash_grid_encode_plain(tpos, tstd, ttabs, *args)
    holder = TH.Bf16Copies()
    copies = holder.of(ttabs)
    assert all(c.dtype == torch.bfloat16 and torch.equal(c, t.to(torch.bfloat16)) for c, t in zip(copies, ttabs))
    assert torch.equal(TH.hash_grid_encode_plain(tpos, tstd, copies, *args), master)
    # the lookup without autograd reads the copies it is given: the same bits again
    assert torch.equal(TH.hash_grid_encode(tpos, tstd, ttabs, *args, copies=holder), master)
    want = np.asarray(JH.hash_encode_gaussians(jnp.asarray(pos[:, None]), jnp.asarray(std[:, None, None]), jtabs,
                                               jnp.asarray(scales), gather_dtype=jnp.bfloat16,
                                               cell_packed=cell_packed, dense_res=dense, bucket_pack=packs))
    mag = _magnitude(pos, ttabs, scales, dense, packs, f, cell_packed)
    assert (np.abs(master.numpy() - want) <= BF16_REL[cell_packed] * mag + 1e-7).all()


def test_bf16_copy_is_kept_until_the_table_changes():
    """The owner's copy is made once per table and reused while the table is
    unchanged; an in-place update (an optimizer step bumps `_version`) makes
    the next call convert afresh, a table put in its place gets its own copy,
    and a stale copy is let go. A lookup under autograd reads the master and
    leaves the copies alone."""
    import weakref

    gen = torch.Generator().manual_seed(0)
    table = torch.nn.Parameter(torch.rand((64, 32), generator=gen))
    holder = TH.Bf16Copies()
    first = holder.of([table])[0]
    assert holder.of([table])[0] is first and torch.equal(first, table.detach().to(torch.bfloat16))
    with torch.no_grad():
        table.add_(0.25)
    fresh = holder.of([table])[0]
    assert fresh is not first and torch.equal(fresh, table.detach().to(torch.bfloat16))
    assert not torch.equal(fresh, first)
    assert holder.of([table])[0] is fresh
    other = table.detach().clone()
    again = holder.of([other])[0]
    assert again is not fresh and torch.equal(again, fresh)
    stale = weakref.ref(fresh)
    del first, fresh
    assert stale() is None, "the copy of a table that was replaced is not kept"
    with torch.inference_mode():
        assert TH.Bf16Copies().of([torch.rand(4, 4)]) is None  # an inference tensor keeps no version: no copy
    # a lookup under no_grad fills the holder; one under autograd reads the master and leaves it alone
    scales = TH.level_scales(2, 8, 16)
    tabs = [torch.nn.Parameter(t) for t in TH.init_hash_tables(gen, scales, 3, 2**12, 4, scale=1.0, cell_packed=True)]
    _, dense, _ = TH.level_layout(scales, 3, 2**12, True)
    pos = torch.from_numpy(_positions(17, 50, 3, scales))
    args = ([8.0, 16.0], [t.shape[0] for t in tabs], dense, 4, True, True)
    holder = TH.Bf16Copies()
    graph = TH.hash_grid_encode(pos, None, tabs, *args, copies=holder)
    assert graph.requires_grad and holder._held == []
    with torch.no_grad():
        assert torch.equal(TH.hash_grid_encode(pos, None, tabs, *args, copies=holder), graph.detach())
    assert len(holder._held) == 2 and all(torch.equal(h[3], t.detach().to(torch.bfloat16))
                                          for h, t in zip(holder._held, tabs))


def test_a_serving_state_reads_bf16_copies_of_its_tables():
    """The closed-loop server state switches its model's hash grids to bf16
    copies of their tables: a render makes them, gives the image a render from
    the masters gives, and a model outside a server state keeps none."""
    from neurad_tpu_torch.configs.method_configs import neurad_tiny_overrides
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.fields.neurad_encoding import HashGrid
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline, ADPipelineConfig
    from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState

    outputs = SyntheticDataParserConfig(num_frames=2, image_height=12, image_width=18, lidar_channels=4,
                                        lidar_azimuths=12).setup().get_dataparser_outputs()
    pipeline = ADPipeline(outputs, ADPipelineConfig(model_overrides=neurad_tiny_overrides()), device="cpu")
    grids = [g for m in pipeline.model.modules() for g in vars(m).values() if isinstance(g, HashGrid)]
    assert grids and all(g.copies is None for g in grids)
    state = ClosedLoopState(pipeline, device="cpu")
    assert all(isinstance(g.copies, TH.Bf16Copies) for g in grids)
    pose = outputs.cameras.camera_to_worlds[0].tolist() + [[0.0, 0.0, 0.0, 1.0]]
    image = state.render_image(pose, 0.5, "front_camera")
    read = [g for g in grids if g.gather_dtype is not None]
    assert read and all(len(g.copies._held) > 0 for g in read)
    for g in grids:
        g.copies = None
    np.testing.assert_array_equal(state.render_image(pose, 0.5, "front_camera"), image)
