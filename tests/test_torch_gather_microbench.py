"""The gather probes on the CPU: the shared plain version, the wrappers'
argument checks and the script's `--device cpu` run at a tiny size. The
kernels themselves run only on the card (`tests/test_torch_kernels_cuda.py`)."""

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
    assert len(records) == 11, "three probes at four shapes, the one-hot product left out above 131072 rows"
    assert ("onehot", 524288) not in names and ("onehot", 131072) in names and ("serial", 524288) in names
    for r in records:
        assert r["max_abs_err"] == 0.0 and r["ms"] > 0 and r["library_ms"] > 0 and r["bound_by"] == "bytes"
        assert ("mechanism_ops_ms" in r) == (r["name"] == "onehot")
    assert json.loads(out.read_text())[0]["name"] == "coalesced"
    assert "M rows/s" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GM.entrypoint(["--queries", "64"])
