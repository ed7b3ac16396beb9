"""The gather and scatter-add probes on the CPU: the shared plain versions,
the wrappers' argument checks, the bounds' arithmetic and the script's
`--device cpu` run at a tiny size, and every probe's plain version against
the JAX package's Pallas kernel itself (`benchmarks/pallas_gather_microbench.py`
and `benchmarks/pallas_gather_microbench2.py`, run in interpret mode). The
kernels themselves run only on the card (`tests/test_torch_kernels_cuda.py`)."""

import importlib.util
import json
import re
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neurad_tpu_torch.benchmarks import gather_microbench as GM

torch.set_num_threads(1)


def _case(t_rows, f, n, seed=0):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(t_rows, f)).astype(np.float32)).to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, t_rows, n).astype(np.int32))
    return table, idx


@pytest.mark.parametrize("t_rows,f", [(64, 8), (256, 32), (100, 16)])
def test_plain_version_is_a_row_gather(t_rows, f):
    table, idx = _case(t_rows, f, 300)
    want = table.float().numpy()[idx.numpy()]
    np.testing.assert_array_equal(GM.gather_rows_plain(table, idx).float().numpy(), want)
    for fn in (GM.gather_rows_coalesced, GM.gather_rows_serial):
        out = fn(table, idx)
        assert out.dtype == torch.bfloat16 and torch.equal(out, table[idx.long()])
    out = GM.gather_rows_onehot(table, idx)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), want)
    # the one-hot product it stands for: one non-zero term per output, exact in fp32
    onehot = torch.nn.functional.one_hot(idx.long(), t_rows).float()
    np.testing.assert_array_equal((onehot @ table.float()).numpy(), want)


def test_cpu_tensors_launch_no_kernel_and_bad_arguments_raise():
    table, idx = _case(64, 8, 10)
    GM.reset_launch_counts()
    GM.gather_rows_coalesced(table, idx), GM.gather_rows_serial(table, idx), GM.gather_rows_onehot(table, idx)
    assert (GM.coalesced_launches, GM.onehot_launches, GM.serial_launches) == (0, 0, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        GM.gather_rows_coalesced(table.float(), idx)
    with pytest.raises(ValueError, match="int32"):
        GM.gather_rows_serial(table, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        GM.gather_rows_onehot(table[:, ::2], idx)
    with pytest.raises(ValueError, match="int32"):
        GM.gather_rows_onehot(table, idx[:, None])


def test_bounds_are_the_functions_bytes_and_the_dense_products_operations_stand_apart():
    b = GM.bounds_ms(1 << 20, 131072, 32)
    assert b["coalesced"] == b["serial"] and b["coalesced"][1] == "bytes"
    # indices + the whole table + the result, over 3.35 TB/s
    assert b["coalesced"][0] == pytest.approx(((1 << 20) * 4 + 131072 * 64 + (1 << 20) * 64) / 3.35e12 * 1e3)
    # the one-hot gather is the same function with an fp32 result: bytes too, not its product's operations
    assert b["onehot"][1] == "bytes"
    assert b["onehot"][0] == pytest.approx(((1 << 20) * 4 + 131072 * 64 + (1 << 20) * 128) / 3.35e12 * 1e3)
    # the bucketed product: each query against the 128 rows of its bucket, whatever T
    assert GM.BUCKET_ROWS == 128
    assert GM.onehot_mechanism_ops_ms(1 << 20, 32) == pytest.approx(2 * (1 << 20) * 128 * 32 / 989e12 * 1e3)
    assert GM.onehot_mechanism_ops_ms(1 << 20, 32) < b["onehot"][0] / 4, "the bytes, not the product, bound it"
    small = GM.bounds_ms(16, 64, 8)  # fewer queries than rows: only the rows named are read
    assert small["serial"][0] == pytest.approx((16 * 4 + 16 * 16 + 16 * 16) / 3.35e12 * 1e3)
    assert [s for s in GM.TABLE_SHAPES] == [(16384, 8), (65536, 32), (131072, 32), (524288, 32)]


def test_script_runs_on_the_cpu_at_a_tiny_size(tmp_path, capsys):
    out = tmp_path / "gather.json"
    records = GM.entrypoint(["--device", "cpu", "--queries", "64", "--json", str(out)])
    names = [(r["name"], r["T"]) for r in records]
    assert len(records) == 27, "six probes at four shapes, the three scatter-adds once more on skewed indices"
    assert ("onehot", 524288) in names and ("onehot", 131072) in names and ("serial", 524288) in names
    assert ("scatter_onehot", 524288) in names and ("scatter_onehot", 131072) in names
    assert ("scatter_blocked", 524288) in names and ("scatter_serial", 524288) in names
    hot = [r for r in records if r["skew"] == "hot"]
    assert sorted(r["name"] for r in hot) == ["scatter_blocked", "scatter_onehot", "scatter_serial"]
    assert all((r["T"], r["F"]) == GM.SKEWED_SHAPE for r in hot)
    assert all(r["skew"] == "uniform" for r in records if r not in hot)
    for r in records:
        assert r["max_abs_err"] == 0.0 and r["ms"] > 0 and r["library_ms"] > 0 and r["bound_by"] == "bytes"
        assert r["device_ms"] is None and r["library_device_ms"] is None, "the CPU has no device time"
        assert ("mechanism_ops_ms" in r) == (r["name"] in ("onehot", "scatter_onehot"))
        assert ("relaunch_equal" in r) == r["name"].startswith("scatter_")
        if r["name"] in ("onehot", "scatter_onehot"):
            assert r["scratch_bytes"] is None, "the plain versions need no scratch"
    assert json.loads(out.read_text())[0]["name"] == "coalesced"
    assert "M rows/s" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GM.entrypoint(["--queries", "64"])
    with pytest.raises(RuntimeError, match="needs the card"):
        GM.profile_bucketed("cpu", queries=64)


@pytest.mark.parametrize("t_rows,f", [(64, 8), (256, 32), (100, 16), (7, 1)])
def test_scatter_plain_version_is_a_row_scatter_add(t_rows, f):
    rng = np.random.default_rng(t_rows)
    idx = rng.integers(0, t_rows, 500).astype(np.int32)
    g = rng.normal(size=(500, f)).astype(np.float32)
    want = np.zeros((t_rows, f), np.float64)
    np.add.at(want, idx, g.astype(np.float64))
    ti, tg = torch.from_numpy(idx), torch.from_numpy(g)
    got = GM.scatter_rows_plain(ti, tg, t_rows)
    assert got.dtype == torch.float32 and got.shape == (t_rows, f)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # the one-hot product's inputs are bf16: g is rounded before the fp32 sum
    g16 = tg.to(torch.bfloat16).float().numpy()
    assert np.abs(g16 - g).max() > 0
    want16 = np.zeros((t_rows, f), np.float64)
    np.add.at(want16, idx, g16.astype(np.float64))
    np.testing.assert_allclose(GM.scatter_rows_plain(ti, tg, t_rows, round_bf16=True).numpy(), want16, atol=1e-5,
                               rtol=1e-5)
    if f in (8, 16, 32):
        onehot = torch.nn.functional.one_hot(ti.long(), t_rows).float()
        np.testing.assert_allclose((onehot.T @ torch.from_numpy(g16)).numpy(), want16, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(GM.scatter_rows_onehot(ti, tg, t_rows),
                                   GM.scatter_rows_plain(ti, tg, t_rows, round_bf16=True), rtol=0, atol=0)
        torch.testing.assert_close(GM.scatter_rows_blocked(ti, tg, t_rows), got, rtol=0, atol=0)
    torch.testing.assert_close(GM.scatter_rows_serial(ti, tg, t_rows), got, rtol=0, atol=0)


def test_scatter_wrappers_launch_nothing_on_the_cpu_and_check_arguments():
    idx = torch.zeros(10, dtype=torch.int32)
    g = torch.ones((10, 8))
    GM.reset_launch_counts()
    out = [fn(idx, g, 4) for fn in (GM.scatter_rows_onehot, GM.scatter_rows_blocked, GM.scatter_rows_serial)]
    assert all(float(o[0, 0]) == 10.0 and float(o[1:].abs().sum()) == 0.0 for o in out)
    assert (GM.scatter_onehot_launches, GM.scatter_blocked_launches, GM.scatter_serial_launches) == (0, 0, 0)
    with pytest.raises(ValueError, match="float32"):
        GM.scatter_rows_serial(idx, g.double(), 4)
    with pytest.raises(ValueError, match="int32"):
        GM.scatter_rows_blocked(idx.long(), g, 4)
    with pytest.raises(ValueError, match="int32"):
        GM.scatter_rows_onehot(idx[:5], g, 4)
    with pytest.raises(ValueError, match="positive"):
        GM.scatter_rows_serial(idx, g, 0)


def test_scatter_bound_is_the_functions_bytes():
    ms, by = GM.scatter_bound_ms(1 << 20, 131072, 32)
    assert by == "bytes"
    assert ms == pytest.approx(((1 << 20) * 4 + (1 << 20) * 32 * 4 + 131072 * 32 * 4) / 3.35e12 * 1e3)
    assert GM.scatter_bound_ms(16, 64, 8)[0] == pytest.approx((64 + 16 * 32 + 64 * 32) / 3.35e12 * 1e3)
    # the one-hot scatter's own product is the gather's transposed: the same operation count, below the bound
    assert GM.onehot_mechanism_ops_ms(1 << 20, 32) < ms / 4


def test_no_queries_give_empty_and_zero_results_and_launch_nothing():
    table, _ = _case(64, 8, 1)
    idx = torch.zeros((0,), dtype=torch.int32)
    g = torch.zeros((0, 8))
    GM.reset_launch_counts()
    for fn in (GM.gather_rows_coalesced, GM.gather_rows_serial, GM.gather_rows_onehot):
        assert fn(table, idx).shape == (0, 8)
    for fn in (GM.scatter_rows_onehot, GM.scatter_rows_blocked, GM.scatter_rows_serial):
        out = fn(idx, g, 64)
        assert out.shape == (64, 8) and float(out.abs().sum()) == 0.0
    assert (GM.coalesced_launches, GM.onehot_launches, GM.serial_launches, GM.scatter_onehot_launches,
            GM.scatter_blocked_launches, GM.scatter_serial_launches) == (0,) * 6


def test_skewed_indices_put_half_in_one_row_and_a_quarter_in_the_last_16():
    gen = torch.Generator().manual_seed(3)
    idx = GM.skewed_indices(4096, 1000, gen, "cpu")
    assert idx.dtype == torch.int32 and idx.shape == (4096,)
    assert int((idx == 1000 // 3).sum()) >= 2048
    assert int((idx >= 1000 - 16).sum()) >= 1024 and int(idx.max()) < 1000 and int(idx.min()) >= 0
    assert int((idx[:2048] == 1000 // 3).sum()) < 2048, "shuffled"


def test_python_constants_match_the_kernel_source():
    """The wrappers' and the benchmark's arithmetic uses the kernels' bucket
    rows and span; the source is the authority."""
    src = (Path(GM.__file__).resolve().parent.parent / "csrc" / "gather_probes.cu").read_text()
    assert 1 << int(re.search(r"constexpr int R_SHIFT = (\d+);", src)[1]) == GM.BUCKET_ROWS
    assert int(re.search(r"constexpr int SPAN = (\d+);", src)[1]) == GM.BLOCKED_SPAN


# ---------------------------------------------------------------------------
# the JAX package's probes (P1-P6) themselves, in interpret mode

JAX_QUERIES = 1024  # the modules' N (queries per call), cut from 2^20


def _load_by_path(name):
    path = Path(__file__).resolve().parent.parent / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def pallas_probes(monkeypatch):
    """`benchmarks/pallas_gather_microbench.py` (`vmem`) and
    `benchmarks/pallas_gather_microbench2.py` (`scalar`), imported by path,
    with N cut to JAX_QUERIES and every `pl.pallas_call` run in interpret
    mode. `made` holds each `pl.pallas_call` product, in order: the scalar
    probes' `run` returns a chained scalar, so their tests call the product."""
    vmem, scalar = _load_by_path("pallas_gather_microbench"), _load_by_path("pallas_gather_microbench2")
    made = []
    real = vmem.pl.pallas_call

    def interpret_call(*args, **kwargs):
        made.append(real(*args, interpret=True, **kwargs))
        return made[-1]

    for mod in (vmem, scalar):
        monkeypatch.setattr(mod, "N", JAX_QUERIES)
    monkeypatch.setattr(vmem.pl, "pallas_call", interpret_call)
    return types.SimpleNamespace(vmem=vmem, scalar=scalar, made=made)


def _probe_inputs(seed, t_rows, f, hot):
    """Seeded table (bf16), indices and updates; `hot` puts half the indices
    in one row and a quarter in the table's last 16 rows."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(t_rows, f)).astype(np.float32)
    idx = rng.integers(0, t_rows, JAX_QUERIES).astype(np.int32)
    if hot:
        idx[: JAX_QUERIES // 2] = t_rows // 3
        idx[JAX_QUERIES // 2: 3 * JAX_QUERIES // 4] = rng.integers(t_rows - 16, t_rows, JAX_QUERIES // 4)
        rng.shuffle(idx)
    g = rng.normal(size=(JAX_QUERIES, f)).astype(np.float32)
    return torch.from_numpy(table).to(torch.bfloat16), idx, g


@pytest.mark.parametrize("t_rows,f,hot", [(64, 8, False), (64, 8, True), (128, 32, False)])
def test_onehot_gather_plain_equals_the_jax_pallas_kernel(pallas_probes, t_rows, f, hot):
    """P2: the TPU kernel's one-hot product has one non-zero term per output,
    so it equals the bf16 row exactly, as the plain version does: bit for bit."""
    table, idx, _ = _probe_inputs(t_rows + f, t_rows, f, hot)
    jtable = jax.numpy.asarray(table.float().numpy()).astype(jax.numpy.bfloat16)
    want = np.asarray(pallas_probes.vmem.make_onehot_gather(t_rows, f, 256, 32)(jtable, jax.numpy.asarray(idx)))
    got = GM.gather_rows_onehot(table, torch.from_numpy(idx))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t_rows,f,hot", [(64, 8, False), (64, 8, True), (128, 32, False)])
def test_onehot_scatter_plain_matches_the_jax_pallas_kernel(pallas_probes, t_rows, f, hot):
    """P3: the TPU kernel rounds g to bf16 and sums onehot^T @ g in fp32 on its
    matrix unit, in another order than `index_add_`: within SCATTER_TOL of the
    sum of the absolute values of an entry's terms."""
    _, idx, g = _probe_inputs(t_rows + f + 1, t_rows, f, hot)
    want = np.asarray(pallas_probes.vmem.make_onehot_scatter(t_rows, f, 256, 32)(jax.numpy.asarray(idx),
                                                                                jax.numpy.asarray(g)))
    ti, tg = torch.from_numpy(idx), torch.from_numpy(g)
    got = GM.scatter_rows_onehot(ti, tg, t_rows).numpy()
    magnitude = GM.scatter_rows_plain(ti, tg.abs(), t_rows).numpy()
    assert want.shape == got.shape == (t_rows, f)
    assert (np.abs(got - want) <= GM.SCATTER_TOL * magnitude).all(), float(np.abs(got - want).max())
    if hot:
        assert magnitude[t_rows // 3].min() > 100 * np.median(magnitude), "one row holds half the updates"


PROBE_CASES = [(64, 8, False), (64, 8, True), (128, 32, False)]


def _jax_table(table):
    return jax.numpy.asarray(table.float().numpy()).astype(jax.numpy.bfloat16)


def _assert_scatter_close(got, want, idx, g, t_rows, hot):
    magnitude = GM.scatter_rows_plain(torch.from_numpy(idx), torch.from_numpy(g).abs(), t_rows).numpy()
    assert want.dtype == np.float32 and want.shape == got.shape == (t_rows, g.shape[1])
    assert (np.abs(got - want) <= GM.SCATTER_TOL * magnitude).all(), float(np.abs(got - want).max())
    assert (idx == t_rows // 3).sum() >= (JAX_QUERIES // 2 if hot else 0), "one row holds half the updates"


@pytest.mark.parametrize("t_rows,f,hot", PROBE_CASES)
def test_coalesced_gather_plain_equals_the_jax_pallas_kernel(pallas_probes, t_rows, f, hot):
    """P1: the TPU kernel gathers the block's rows from the VMEM-resident
    table (`take_along_axis`): bf16 rows, bit for bit."""
    table, idx, _ = _probe_inputs(t_rows + f + 2, t_rows, f, hot)
    want = pallas_probes.vmem.make_vmem_gather(t_rows, f, 256, jax.numpy.bfloat16)(_jax_table(table),
                                                                                    jax.numpy.asarray(idx))
    got = GM.gather_rows_coalesced(table, torch.from_numpy(idx))
    assert want.dtype == jax.numpy.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jax.numpy.float32)))


@pytest.mark.parametrize("t_rows,f,hot", PROBE_CASES)
def test_serial_gather_plain_equals_the_jax_pallas_kernel(pallas_probes, t_rows, f, hot):
    """P5: the TPU kernel copies one row at a time in a scalar loop: bf16
    rows, bit for bit."""
    table, idx, _ = _probe_inputs(t_rows + f + 3, t_rows, f, hot)
    pallas_probes.scalar.make_scalar_gather(t_rows, f, 256, 8)
    want = pallas_probes.made[-1](jax.numpy.asarray(idx), _jax_table(table))
    got = GM.gather_rows_serial(table, torch.from_numpy(idx))
    assert want.dtype == jax.numpy.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jax.numpy.float32)))


@pytest.mark.parametrize("t_rows,f,hot", PROBE_CASES)
def test_blocked_scatter_plain_matches_the_jax_pallas_kernel(pallas_probes, t_rows, f, hot):
    """P4: the TPU kernel adds each block's `zeros.at[idx].add(g)` into its
    resident fp32 accumulator, in another order than `index_add_`: within
    SCATTER_TOL of the sum of the absolute values of an entry's terms."""
    _, idx, g = _probe_inputs(t_rows + f + 4, t_rows, f, hot)
    want = np.asarray(pallas_probes.vmem.make_vmem_scatter_probe(t_rows, f, 256)(jax.numpy.asarray(idx),
                                                                               jax.numpy.asarray(g)))
    got = GM.scatter_rows_blocked(torch.from_numpy(idx), torch.from_numpy(g), t_rows).numpy()
    _assert_scatter_close(got, want, idx, g, t_rows, hot)


@pytest.mark.parametrize("t_rows,f,hot", PROBE_CASES)
def test_serial_scatter_plain_matches_the_jax_pallas_kernel(pallas_probes, t_rows, f, hot):
    """P6: the TPU kernel adds one update's row at a time in a scalar loop,
    in fp32: within SCATTER_TOL of the sum of the absolute values of an
    entry's terms."""
    _, idx, g = _probe_inputs(t_rows + f + 5, t_rows, f, hot)
    pallas_probes.scalar.make_scalar_scatter(t_rows, f, 256, 8)
    want = np.asarray(pallas_probes.made[-1](jax.numpy.asarray(idx), jax.numpy.asarray(g)))
    got = GM.scatter_rows_serial(torch.from_numpy(idx), torch.from_numpy(g), t_rows).numpy()
    _assert_scatter_close(got, want, idx, g, t_rows, hot)
