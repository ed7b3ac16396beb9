"""The gather and scatter-add probes on the CPU: the shared plain versions,
the wrappers' argument checks, the bounds' arithmetic and the script's
`--device cpu` run at a tiny size. The kernels themselves run only on the card
(`tests/test_torch_kernels_cuda.py`)."""

import json

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
    assert GM.onehot_mechanism_ops_ms(1 << 20, 131072, 32) == pytest.approx(2 * (1 << 20) * 131072 * 32 / 989e12 * 1e3)
    assert GM.onehot_mechanism_ops_ms(1 << 20, 131072, 32) > 100 * b["onehot"][0]
    small = GM.bounds_ms(16, 64, 8)  # fewer queries than rows: only the rows named are read
    assert small["serial"][0] == pytest.approx((16 * 4 + 16 * 16 + 16 * 16) / 3.35e12 * 1e3)
    assert [s for s in GM.TABLE_SHAPES] == [(16384, 8), (65536, 32), (131072, 32), (524288, 32)]


def test_script_runs_on_the_cpu_at_a_tiny_size(tmp_path, capsys):
    out = tmp_path / "gather.json"
    records = GM.entrypoint(["--device", "cpu", "--queries", "64", "--json", str(out)])
    names = [(r["name"], r["T"]) for r in records]
    assert len(records) == 22, "six probes at four shapes, the one-hot products left out above 131072 rows"
    assert ("onehot", 524288) not in names and ("onehot", 131072) in names and ("serial", 524288) in names
    assert ("scatter_onehot", 524288) not in names and ("scatter_onehot", 131072) in names
    assert ("scatter_blocked", 524288) in names and ("scatter_serial", 524288) in names
    for r in records:
        assert r["max_abs_err"] == 0.0 and r["ms"] > 0 and r["library_ms"] > 0 and r["bound_by"] == "bytes"
        assert ("mechanism_ops_ms" in r) == (r["name"] in ("onehot", "scatter_onehot"))
    assert json.loads(out.read_text())[0]["name"] == "coalesced"
    assert "M rows/s" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GM.entrypoint(["--queries", "64"])


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
    # the one-hot scatter's own product is the gather's transposed: the same operation count, far above the bound
    assert GM.onehot_mechanism_ops_ms(1 << 20, 131072, 32) > 100 * ms
