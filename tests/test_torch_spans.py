"""The port's spans and counters (`utils/profiler.py`): free with the
profiler and the counters off, the documented span tree of a NeuRAD and a
SplatAD closed-loop request and of a NeuRAD train step with the profiler on,
and the counters against hand counts on tiny inputs."""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from neurad_tpu_torch.configs.method_configs import neurad_tiny_overrides
from neurad_tpu_torch.core.structs import GaussiansStd
from neurad_tpu_torch.data.datamanager import ADDataManagerConfig
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
from neurad_tpu_torch.fields import neurad_encoding as E
from neurad_tpu_torch.model_components import dynamic_actors as A
from neurad_tpu_torch.ops import gaussian_rasterize as GR
from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline, ADPipelineConfig
from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig
from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState
from neurad_tpu_torch.utils import profiler as P

torch.set_num_threads(1)

LAYERS = ("closed_loop.", "pipeline.", "model.", "train.")
BENCHMARK_NAMES = {"window", "render_image", "update_actors", "train_step", "next(batches)"}
NFF = ("model.proposals", "model.field", "model.weights")
MARK = "test.mark"


class _Ops(TorchDispatchMode):
    """The names of the ops dispatched while entered."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def scene():
    return SyntheticDataParserConfig(num_frames=2, image_height=24, image_width=36).setup().get_dataparser_outputs()


@pytest.fixture(scope="module")
def neurad(scene):
    cfg = ADPipelineConfig(model_overrides=neurad_tiny_overrides(), eval_chunk=64, train_ray_chunk=32,
                           datamanager=ADDataManagerConfig(num_cam_patches=2, patch_size=4, num_lidar_rays=64))
    return ADPipeline(scene, cfg, device="cpu")


@pytest.fixture(scope="module")
def splatad(scene):
    return SplatADPipeline(scene, SplatADPipelineConfig(cap_max=500), device="cpu")


def _traced(fn):
    """fn() under the profiler -> (its result, the span tree of the program's
    spans: [(name, [children])]), checking that every span ran on the thread
    of the caller and nests inside its parent."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(MARK):
            out = fn()
    events = [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    names = {e.name() for e in events}
    assert not names & BENCHMARK_NAMES
    thread = next(e.start_thread_id() for e in events if e.name() == MARK)
    spans = sorted(((e.start_ns(), -e.duration_ns(), e.name(), e.start_thread_id()) for e in events
                    if e.name().startswith(LAYERS)))
    root = ("", [])
    stack = [(float("-inf"), float("inf"), root)]
    for start, neg, name, tid in spans:
        assert tid == thread, f"{name} ran on another thread"
        end = start - neg
        while stack[-1][1] <= start:
            stack.pop()
        assert end <= stack[-1][1], f"{name} ends after its parent {stack[-1][2][0]}"
        node = (name, [])
        stack[-1][2][1].append(node)
        stack.append((start, end, node))
    return out, root[1]


def _names(nodes):
    return [n for n, _ in nodes]


def test_with_the_profiler_off_a_span_is_one_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert P.span("model.field") is P.span("pipeline.chunk", index=3)
    with P.span("model.field") as inside:
        assert inside is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert P.span("model.field") is not P.span("model.field")


def test_a_request_opens_no_range_with_the_profiler_off(neurad, scene, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    state = ClosedLoopState(neurad, device="cpu")
    assert state.render_image(scene.cameras.camera_to_worlds[0].numpy(), 0.1).shape == (24, 36, 3)


def test_a_counter_outside_counting_dispatches_no_op():
    value = torch.tensor(3)
    assert not P.is_counting()
    with _Ops() as ops:
        P.count("tiles.slots_valid", value)
        P.count("datamanager.gets", 1)
    assert ops.names == []
    with P.counting() as counters:
        assert P.is_counting()
        with _Ops() as ops:
            for _ in range(5):
                P.count("tiles.slots_valid", value)  # a device value joins a list: no op until it is read
        assert ops.names == []
        P.count("datamanager.gets", 2)
    assert not P.is_counting()
    assert P.counter_values(counters) == {"tiles.slots_valid": 15, "datamanager.gets": 2}


def test_device_values_fold_into_one_accumulator():
    n = 2 * P.Counters.FOLD + 7
    with P.counting() as counters:
        for k in range(n):
            P.count("actor.samples_hit", torch.tensor(k % 5))
            P.count("actor.samples_dropped", torch.tensor(k % 5), above=2)
            P.count("tiles.pairs_dropped", torch.tensor(1, dtype=torch.int32))
        P.count("actor.capacity", 3, above=1)
        P.count("actor.capacity", 3, above=5)
        assert len(counters.device["actor.samples_hit"]) <= P.Counters.FOLD + 1
    assert P.counter_values(counters) == {"actor.samples_hit": sum(k % 5 for k in range(n)),
                                          "actor.samples_dropped": sum(max(k % 5 - 2, 0) for k in range(n)),
                                          "tiles.pairs_dropped": n, "actor.capacity": 2}


def test_time_function_opens_a_span_of_its_name():
    @P.time_function
    def timed():
        return torch.ones(2).sum()

    def f():
        with P.time_function(name="pipeline.block"):
            return timed()

    _, tree = _traced(f)
    assert tree == [("pipeline.block", [])]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timed()
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    assert names == [timed.__qualname__]


def test_neurad_request_span_tree(neurad, scene):
    state = ClosedLoopState(neurad, device="cpu")
    pose = scene.cameras.camera_to_worlds[0].numpy()
    state.render_image(pose, 0.0)
    image, tree = _traced(lambda: state.render_image(pose, 0.1))
    assert image.shape == (24, 36, 3)
    assert _names(tree) == ["closed_loop.request"]
    children = tree[0][1]
    chunks = [c for c in children if c[0] == "pipeline.chunk"]
    assert len(chunks) == 2  # 8 x 12 rays in chunks of 64
    assert _names(children) == ["closed_loop.patch_cameras", "pipeline.rays", "pipeline.chunk", "pipeline.chunk",
                                "model.decode", "pipeline.to_host"]
    for chunk in chunks:
        assert _names(chunk[1]) == list(NFF)


def test_splatad_request_span_tree(splatad, scene):
    state = ClosedLoopState(splatad, device="cpu")
    pose = scene.cameras.camera_to_worlds[0].numpy()
    state.render_image(pose, 0.0)
    _, tree = _traced(lambda: state.render_image(pose, 0.1))
    assert _names(tree) == ["closed_loop.request"]
    children = tree[0][1]
    assert _names(children) == ["closed_loop.patch_cameras", "pipeline.rays", "model.project", "model.bin",
                                "model.composite", "model.decode", "pipeline.to_host", "pipeline.rays"]
    assert children[2][1] == [("model.actor_means", [])]


def test_neurad_train_step_span_tree(neurad):
    state = neurad.init_state()
    bundle, batch = neurad.datamanager.next_train()
    _, tree = _traced(lambda: neurad.train_step(state, bundle, batch))
    assert _names(tree) == ["train.forward", "train.backward", "train.optimizer"]
    forward = tree[0][1]
    assert _names(forward) == ["pipeline.chunk"] * 3 + ["model.losses"]  # 96 rays in chunks of 32
    assert all(_names(c[1]) == list(NFF) for c in forward[:3])
    assert forward[3][1] == [("model.decode", [])]


def _actor_encoding():
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    poses[:, :3, 3] = [6.0, 0.0, 0.0]
    trajs = [{"poses": poses, "timestamps": np.array([0.0, 10.0]), "dims": np.array([30.0, 30.0, 30.0], np.float32),
              "symmetric": False, "deformable": False}]
    settings = dict(num_levels=2, base_res=16, max_res=64, log2_hashmap_size=10, hashgrid_dim=4)
    enc = E.NeuRADHashEncoding(A.DynamicActors(A.actor_data_from_trajectories(trajs)), 20.0,
                               static=E.StaticSettings(**settings), actor=E.ActorSettings(**settings),
                               actor_compaction=8)
    rng = np.random.default_rng(4)
    r, s = 40, 16
    origins = rng.normal(size=(r, 3)).astype(np.float32) * 2.0
    targets = rng.normal(size=(r, 3)).astype(np.float32) * 6.0 + np.array([8.0, 0.0, 0.0], np.float32)
    t = np.linspace(0.0, 1.0, s, dtype=np.float32)[None, :, None]
    pts = torch.from_numpy(origins[:, None] + (targets - origins)[:, None] * t)[:, :, None, :]
    positions = GaussiansStd(mean=pts, std=torch.full((r, s, 1, 1), 0.01))
    return enc, positions, torch.zeros((r, 1))


def test_actor_counters_equal_the_hit_mask(monkeypatch):
    """Most samples fall in one big box: the hits overflow the compacted
    lookup's capacity (max(128, R*S // 8) = 128)."""
    enc, positions, times = _actor_encoding()
    masks = []
    original = E.first_k_set

    def keep(flags, k):
        masks.append((flags.clone(), k))
        return original(flags, k)

    monkeypatch.setattr(E, "first_k_set", keep)
    with torch.no_grad():
        with _Ops() as off:
            enc(positions, times)
        with P.counting() as counters, _Ops() as on:
            enc(positions, times)
    hits, cap = int(masks[1][0].sum()), masks[1][1]
    assert cap == 128 and hits > 3 * cap
    assert P.counter_values(counters) == {"actor.samples_hit": hits, "actor.capacity": cap,
                                          "actor.samples_dropped": hits - cap}
    extra = list(on.names)
    for name in off.names:
        extra.remove(name)
    assert extra == ["sum"]  # what the counters launch with counting on, and nothing off


def test_tile_counters_equal_the_binning(splatad, monkeypatch):
    """`max_per_tile` shrunk until tiles overflow; the dropped pairs counted
    by hand from a binning that holds every pair."""
    calls = []
    original = GR.camera_tile_inputs

    def keep(*args):
        out = original(*args)
        calls.append((args, out[0]))
        return out

    monkeypatch.setattr(GR, "camera_tile_inputs", keep)
    model = splatad.model
    monkeypatch.setattr(model, "config", dataclasses.replace(model.config, max_per_tile=4))
    with P.counting() as counters:
        splatad.render_eval_camera(0)
    (args, binning), = calls
    valid = binning.tile_valid
    full = original(*args[:6], 1024, *args[7:])[0].tile_valid.sum(-1)
    dropped = int((full - 4).clamp_min(0).sum())
    assert dropped > 0, "the case must overflow a tile"
    assert P.counter_values(counters) == {"tiles.slots": valid.numel(), "tiles.slots_valid": int(valid.sum()),
                                          "tiles.pairs_dropped": dropped}


def test_datamanager_counts_the_gets_that_waited(neurad, monkeypatch):
    """The first get finds the queue empty (the sampler held back), the
    second a full queue."""
    dm = neurad.datamanager
    gate = threading.Event()
    original = dm._sample_with_rng

    def held(rng):
        gate.wait(timeout=30)
        return original(rng)

    monkeypatch.setattr(dm, "_sample_with_rng", held)
    feed = dm.iter_train()
    try:
        with P.counting() as counters:
            threading.Timer(0.2, gate.set).start()
            next(feed)
            for _ in range(300):
                if dm._queue.full():
                    break
                threading.Event().wait(0.01)
            assert dm._queue.full()
            next(feed)
    finally:
        gate.set()
        dm.close()
    assert P.counter_values(counters) == {"datamanager.gets": 2, "datamanager.gets_waited": 1}
