"""BENCHMARK.json against the contract's shapes, and a cell added from files alone."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from pathlib import Path

import pytest

from portbench.harness import cell as C
from portbench.harness import spec as S
from portbench.tests import tiny

BENCH = S.benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert S.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert S.UNIT.match(e["unit"]), e["unit"]
        for key in ("config", "traffic"):
            if key in e:
                assert S.NAME.match(e[key])
        for key in e.get("reduced", []):
            assert S.NAME.match(key)
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(workload):
    cell = S.load(workload)
    assert cell.chips == 1
    assert (S.PKG / "families" / f"{cell.config['family']}.py").exists()
    assert (S.PKG / "drivers" / f"{cell.traffic['kind']}.py").exists()
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert hasattr(C.load_reader(m["name"]), "read")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_a_metric_its_cells_report(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
        assert any(c["name"] == cell for c in BENCH["workloads"])
        assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


def test_result_line_keys():
    cell = S.load(BENCH["workloads"][0]["name"])
    outcome = {"attempted": 3, "failed": 0, "end_to_end": {"setup_s": 1.0}, "per_layer": {},
               "checks": {"rgb_rmse": (0.001, 0.01)}, "memory_peak_bytes": 1, "breakdown": {}}
    for trace in (False, True):
        line = C.result_line(cell, outcome, trace, {"platform": "gpu"})
        keys = list(line)
        assert keys[-1] == "checks"  # the numbers compared, each beside its limit, come last
        assert set(keys[:-1]) == {"correct", "attempted", "failed", "metrics", "device"} | ({"breakdown"} if trace else set())
        assert line["correct"] is True
    outcome["checks"] = {"rgb_rmse": (0.1, 0.01)}
    assert C.result_line(cell, outcome, False, {})["correct"] is False


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_are_added_from_files_alone(tmp_path):
    shutil.copy(S.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(S.PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "portbench")
    pkg = tmp_path / "portbench"
    config = json.loads((pkg / "configs" / "splatad.json").read_text())
    config["serve"]["cap_max"] = 1_000_000
    (pkg / "configs" / "splatad-1m.json").write_text(json.dumps(config))
    traffic = json.loads((pkg / "traffic" / "sim-camera.json").read_text())
    traffic["time_step_s"] = 0.05
    (pkg / "traffic" / "sim-camera-20hz.json").write_text(json.dumps(traffic))
    (pkg / "metrics" / "window_s.serve.py").write_text("def read(trace):\n    return trace.window_s\n")
    (pkg / "limits" / "splatad-1m.sim-camera-20hz.json").write_text(json.dumps({"rgb_rmse": 0.01}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "splatad-1m", "source": "https://arxiv.org/abs/2411.16816",
                             "file": "portbench/configs/splatad-1m.json", "reduced": [], "why": "a million"})
    bench["workloads"].append({"name": "splatad-1m.sim-camera-20hz", "config": "splatad-1m",
                               "traffic": "sim-camera-20hz", "chips": 1, "why": "more gaussians, 20 Hz"})
    bench["per_layer"].append({"name": "window_s.serve", "unit": "s", "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "frames_per_s",
                               "workloads": ["splatad-1m.sim-camera-20hz"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = S.load("splatad-1m.sim-camera-20hz", root=tmp_path)
    assert cell.config["serve"]["cap_max"] == 1_000_000 and cell.traffic["time_step_s"] == 0.05
    assert cell.limits == {"rgb_rmse": 0.01}
    assert [m["name"] for m in cell.per_layer] == ["window_s.serve"]
    reader = C.load_reader("window_s.serve", root=tmp_path)
    assert reader.read(type("T", (), {"window_s": 2.5})()) == 2.5
    after = _digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before, "no file that was there changed"


_STUB_TESTS = '''
def tiny(c):
    c["train"]["batch_rays"] = 64
    return c


LIMITS = {"stub.train": {"loss_rel": 0.25}}


def step_unchanged(monkeypatch):
    monkeypatch.setenv("PORTBENCH_STUB_FAULT", "step_unchanged")


def half_batch(monkeypatch):
    monkeypatch.setenv("PORTBENCH_STUB_FAULT", "half_batch")
'''


def _train_entry_points() -> list:
    """The entry points a family that trains provides, as the train driver's
    docstring lists them."""
    from portbench.drivers import train

    doc = train.__doc__
    return re.findall(r"`(\w+)`", doc[doc.index("A family that trains provides"):].split("\n\n")[0])


def _add_stub_family(tmp_path: Path, tests_module) -> dict:
    """A copy of the benchmark with a training cell `stub.train` of a new
    family `stub` added from new files and entries alone (`tests_module`: its
    test-side module, None for none); the digests of the copy's files as
    they were before."""
    shutil.copy(S.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(S.PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    pkg = tmp_path / "portbench"
    before = _digest(pkg)
    (pkg / "families" / "stub.py").write_text("".join(
        f"def {name}(*args, **kwargs):\n    raise NotImplementedError\n\n\n" for name in _train_entry_points()))
    if tests_module is not None:
        (pkg / "tests" / "by_family" / "stub.py").write_text(tests_module)
    config = {"family": "stub", "preset": "stub", "control": "tf32", "train": {"batch_rays": 65536},
              "weights": {"rules": []}}
    (pkg / "configs" / "stub.json").write_text(json.dumps(config))
    (pkg / "limits" / "stub.train.json").write_text(json.dumps({"loss_rel": 4e-6}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub", "source": "https://arxiv.org/abs/2411.16816",
                             "file": "portbench/configs/stub.json", "reduced": [], "why": "a family that trains"})
    bench["workloads"].append({"name": "stub.train", "config": "stub", "traffic": "train", "chips": 1,
                               "why": "the stub family trained"})
    bench["end_to_end"].append({"name": "train_rays_per_s.stub", "unit": "rays/s", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": ["stub.train"]})
    bench["per_layer"].append({"name": "mfu.train.stub", "unit": "%", "better": "higher", "source": "device_trace",
                               "layer": "model", "moves": "train_rays_per_s.stub", "workloads": ["stub.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return before


def test_a_training_cell_of_a_new_family_is_added_from_files_alone(tmp_path, monkeypatch):
    before = _add_stub_family(tmp_path, _STUB_TESTS)
    full = S.load("stub.train", root=tmp_path)
    assert full.traffic["kind"] == "train" and full.limits == {"loss_rel": 4e-6}
    assert {m["name"] for m in full.end_to_end} == {"train_rays_per_s.stub", "peak_mem_gib", "setup_s"}
    assert S.driver_value({"train_rays_per_s": 1.5}, "train_rays_per_s.stub") == 1.5
    assert [m["name"] for m in full.per_layer] == ["mfu.train.stub"]
    assert hasattr(C.load_reader("mfu.train.stub", root=tmp_path), "read")
    assert {"build_train", "train_step", "reference_train"} <= set(_train_entry_points())

    cell = tiny.cell("stub.train", root=tmp_path)
    assert cell.config["train"]["batch_rays"] == 64 and cell.config["scene"] == tiny.SCENE
    assert cell.limits == {"loss_rel": 0.25}
    for name in ("step_unchanged", "half_batch"):
        tiny.fault("stub.train", name, root=tmp_path)(monkeypatch)
        assert os.environ["PORTBENCH_STUB_FAULT"] == name
    after = _digest(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before, "no file that was there changed"


@pytest.mark.parametrize("tests_module, missing", [
    (None, "has no test-side module: add portbench/tests/by_family/stub.py"),
    ("def tiny(c):\n    return c\n", "to portbench/tests/by_family/stub.py"),
], ids=["no-module", "no-faults"])
def test_a_family_without_its_faults_fails_loudly(tmp_path, tests_module, missing):
    _add_stub_family(tmp_path, tests_module)
    for name in ("step_unchanged", "half_batch"):
        with pytest.raises(LookupError, match=re.escape(missing)) as err:
            tiny.fault("stub.train", name, root=tmp_path)
        assert tests_module is None or f"`def {name}(monkeypatch)`" in str(err.value)
