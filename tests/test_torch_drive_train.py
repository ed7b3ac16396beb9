"""The slice as a whole: training from a logged drive.

A tiny PandaSet-layout scene (`make_pandaset_fixture`) is parsed by both
packages; `splatad-tiny`-sized SplatAD pipelines are built from the two parses,
JAX's parameters carried across, and one camera step and one lidar step are
held against JAX: loss, every metric, every parameter's gradient, and the
parameters after the update, to tests/test_torch_splatad_train.py's
tolerances (fp32 decoders on both sides: losses and metrics 2e-5 relative,
gradients 2e-4 of their largest entry plus 1e-3 relative).

Then the train script on parsed drives, on the CPU: each of `neurad-tiny`,
`splatad-tiny` and `splatfacto` (narrowed by `--set`) on the PandaSet scene and
on a `make_kittimot_fixture` sequence trains, resumes from its run directory,
and `load_run` and `scripts.eval` accept the run.
"""

import json

import jax
import numpy as np
import pytest
import torch

import neurad_tpu.data.dataparsers.pandaset as jps
import neurad_tpu_torch.data.dataparsers.pandaset as tps
from neurad_tpu.data.full_image_datamanager import FullImageLidarDataManagerConfig as JDMC
from neurad_tpu.model_components.strategy import MCMCStrategyConfig as JMCMC
from neurad_tpu.models import splatad as JS
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipeline as JPipe
from neurad_tpu.pipelines.splatad_pipeline import SplatADPipelineConfig as JPipeCfg
from neurad_tpu_torch import params_from_jax as bridge
from neurad_tpu_torch.configs.method_configs import get_dataparser
from neurad_tpu_torch.data.dataparsers.fixtures import make_kittimot_fixture, make_pandaset_fixture
from neurad_tpu_torch.data.full_image_datamanager import CameraSample as TCameraSample
from neurad_tpu_torch.data.full_image_datamanager import FullImageLidarDataManagerConfig as TDMC
from neurad_tpu_torch.model_components.strategy import MCMCStrategyConfig as TMCMC
from neurad_tpu_torch.models import splatad as TS
from neurad_tpu_torch.pipelines import splatad_pipeline as TP
from neurad_tpu_torch.scripts import eval as eval_script
from neurad_tpu_torch.scripts import train as TTrain

from test_torch_splatad_train import (  # noqa: F401  (fp32_decoders is a fixture)
    MODEL,
    _assert_grads,
    _assert_metrics,
    _assert_updated,
    _j_loss_and_grads,
    _t_loss_and_grads,
    fp32_decoders,
)

torch.set_num_threads(1)

N_FRAMES = 4
CAP = 3000
MCMC = dict(cap_max=CAP, refine_start_iter=100, refine_every=100)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """The PandaSet scene on disk, with the sequence length patched to its 4
    frames in both packages' parsers for the module's tests."""
    root = tmp_path_factory.mktemp("drive")
    make_pandaset_fixture(str(root), n_frames=N_FRAMES, height=24, width=32, points_per_scan=3000, n_actors=2, seed=1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jps, "PANDASET_SEQ_LEN", N_FRAMES)
    mp.setattr(tps, "PANDASET_SEQ_LEN", N_FRAMES)
    yield root
    mp.undo()


@pytest.fixture(scope="module")
def run(drive, fp32_decoders):
    kw = dict(data=str(drive), sequence="001", train_split_fraction=0.75)
    jout = jps.PandaSetDataParserConfig(**kw).setup().get_dataparser_outputs()
    tout = get_dataparser("pandaset", **kw).get_dataparser_outputs()
    assert len(tout.trajectories) == 2 and tout.point_clouds[0].shape[0] > 3000, "actors and missing points parsed"
    jp = JPipe(jout, JPipeCfg(model=JS.SplatADConfig(**MODEL), mcmc=JMCMC(**MCMC), cap_max=CAP,
                              datamanager=JDMC(max_lidar_points=4096)))
    tp = TP.SplatADPipeline(tout, TP.SplatADPipelineConfig(model=TS.SplatADConfig(**MODEL), mcmc=TMCMC(**MCMC),
                                                           cap_max=CAP, datamanager=TDMC(max_lidar_points=4096)),
                            device="cpu")
    for module in tp.model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.float32
    jstate = jp.init_state()
    tp.model.load_state_dict(bridge.splatad_params_from_flax(jax.tree.map(np.asarray, jstate.params)))
    return dict(jp=jp, jstate=jstate, tp=tp, tstate=tp.init_state())


@pytest.mark.parametrize("camera", [True, False], ids=["camera", "lidar"])
def test_one_step_on_a_parsed_drive_matches_jax(run, camera):
    jp, tp, tstate = run["jp"], run["tp"], run["tstate"]
    while True:  # the next sample of the wanted kind, the same on both sides
        js, ts = jp.datamanager.next_train(), tp.datamanager.next_train()
        assert type(js).__name__ == type(ts).__name__
        if isinstance(ts, TCameraSample) == camera:
            break
    if camera:
        assert ts.rolling_shutter_time > 0 and float(np.abs(ts.linear_velocity).max()) > 0, "the drive's metadata"
    else:
        assert not ts.did_return[ts.valid].all(), "the scan holds the synthesised missing points"
    step = tstate.step
    j_loss, j_metrics, j_grads = _j_loss_and_grads(jp, run["jstate"].params, js)
    t_loss, t_metrics, t_grads = _t_loss_and_grads(tp, ts)
    _assert_metrics(t_loss, t_metrics, j_loss, j_metrics, rtol=2e-5)
    assert _assert_grads(t_grads, j_grads) >= 10, "gaussians, actors, decoders and embedding reached"
    old = {n: p.detach().clone() for n, p in tp.model.named_parameters()}
    run["jstate"], j_step = jp.train_step(run["jstate"], js)
    tstate, t_step = tp.train_step(tstate, ts)
    np.testing.assert_allclose(float(t_step["total_loss"]), float(j_step["total_loss"]), rtol=2e-5)
    _assert_updated(tp, tstate, run["jstate"], old, j_grads, step)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    make_kittimot_fixture(str(root), n_frames=6, height=48, width=96, azimuth_stride=32, seed=2)
    return root


NARROW = {"splatfacto": ["--set", "pipeline.capacity=2000", "--set", "pipeline.num_init=600"],
          "neurad-tiny": ["--dp-set", "add_missing_points=false"], "splatad-tiny": []}


@pytest.mark.parametrize("dataparser", ["pandaset", "kitti"])
@pytest.mark.parametrize("method", ["neurad-tiny", "splatad-tiny", "splatfacto"])
def test_train_script_on_a_parsed_drive(drive, kitti, tmp_path, method, dataparser):
    data = {"pandaset": drive, "kitti": kitti}[dataparser]
    argv = [method, "--dataparser", dataparser, "--data", str(data), "--device", "cpu", "--max-iterations", "3",
            "--output-dir", str(tmp_path), "--experiment-name", "r", "--dp-set", "train_split_fraction=0.75",
            "--set", "trainer.steps_per_log=1"] + NARROW[method]
    if dataparser == "kitti":
        argv += ["--sequence", "0006"]
    pipeline, state = TTrain.entrypoint(argv)
    run_dir = tmp_path / "r"
    meta = json.loads((run_dir / "config.json").read_text())
    assert meta["dataparser"] == dataparser and meta["dataparser_config"]["data"] == str(data)
    assert state.step == 3 and len(pipeline.outputs.trajectories) > 0
    _, resumed = TTrain.entrypoint([method, "--load-dir", str(run_dir), "--device", "cpu", "--max-iterations", "4"])
    assert resumed.step == 4
    loaded, _ = TTrain.load_run(run_dir, device="cpu")
    assert type(loaded) is type(pipeline) and loaded.outputs.sensor_idx_to_name == pipeline.outputs.sensor_idx_to_name
    res = eval_script.entrypoint([str(run_dir), "--device", "cpu"])
    assert res["checkpoint_step"] == 4 and res["results"] and all(np.isfinite(v) for v in res["results"].values())
