"""The serving render's CUDA-graph replay (`models/nff_graphs.py`): when it
engages, its key, the lookups a capture is cut at, the profiler's part, and
the chunked render it serves. The CPU tests hold the structure; the tests
marked `cuda` replay on the card against the eager render, bit for bit:

    python -m pytest --noconftest -m cuda tests/test_torch_nff_graphs.py
"""

import inspect
from types import SimpleNamespace

import pytest
import torch
from torch import nn

from neurad_tpu_torch.configs.method_configs import neurad_tiny_overrides
from neurad_tpu_torch.core.structs import map_tensors
from neurad_tpu_torch.data.datamanager import ADDataManagerConfig
from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
from neurad_tpu_torch.model_components.dynamic_actors import ActorEdits
from neurad_tpu_torch.models import nff_graphs
from neurad_tpu_torch.ops import hash_encoding as he
from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline, ADPipelineConfig
from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState
from neurad_tpu_torch.utils import profiler as P

torch.set_num_threads(1)

CHUNK = 40  # a 24 x 36 frame is 8 x 12 = 96 camera rays: chunks of 40, 40 and 16 padded to 40


def _scene():
    return SyntheticDataParserConfig(num_frames=3, image_height=24, image_width=36, lidar_channels=4,
                                     lidar_azimuths=25).setup().get_dataparser_outputs()


def _overrides(parity: bool) -> dict:
    """The tiny preset's widths; `parity`: as the `neurad-parity` preset,
    hash-grid proposals and fp32 reads of hashed, unpacked tables."""
    o = neurad_tiny_overrides()
    if parity:
        flat = dict(cell_packed=False, parity=True)
        o.update(proposal_mode="hashgrid", compute_fp32=True,
                 field_static=o["field_static"]._replace(**flat), field_actor=o["field_actor"]._replace(**flat),
                 proposal_static=tuple(s._replace(**flat) for s in o["proposal_static"]),
                 proposal_actor=o["proposal_actor"]._replace(**flat))
    return o


def _pipeline(device="cpu", parity=True, model="neurad") -> ADPipeline:
    cfg = ADPipelineConfig(model=model, model_overrides=_overrides(parity) if model == "neurad" else {},
                           eval_chunk=CHUNK, datamanager=ADDataManagerConfig(num_cam_patches=2, patch_size=4,
                                                                             num_lidar_rays=64))
    return ADPipeline(_scene(), cfg, device=device)


@pytest.fixture(scope="module")
def parity():
    return _pipeline(parity=True)


@pytest.fixture(scope="module")
def tiny():
    return _pipeline(parity=False)


def _camera(pipe):
    return pipe.datamanager.eval_camera_bundle(pipe.outputs.eval_camera_indices[0])[0]


def _lidar(pipe):
    return pipe.datamanager.eval_lidar_bundle(pipe.outputs.eval_lidar_indices[0])[0]


def _chunked_before(pipe, bundle, all_camera):
    """The chunked render as it was before the graphs: each chunk eagerly,
    the last padded with zero rays, the trimmed outputs concatenated."""
    chunk, n = pipe.config.eval_chunk, bundle.origins.shape[0]
    outs = []
    for start in range(0, n, chunk):
        piece = map_tensors(lambda x: x[start:start + chunk], bundle)
        m = piece.origins.shape[0]
        if m < chunk:
            piece = map_tensors(lambda x: torch.cat([x, x.new_zeros((chunk - m,) + x.shape[1:])], dim=0), piece)
        out = pipe.model.get_nff_outputs(piece, chunk if all_camera else 0)
        outs.append({k: v[:m] for k, v in out.items()})
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


# ----------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["serving", "grad", "edits", "cpu", "sharded", "nerfacto"])
def test_the_graphs_engage_only_in_an_unedited_no_grad_neurad_render_on_cuda(case, parity, monkeypatch):
    pipe = _pipeline(model="nerfacto") if case == "nerfacto" else parity
    if case == "sharded":
        monkeypatch.setattr(pipe, "mesh", SimpleNamespace(world_size=2, rank=0))
    device = torch.device("cpu" if case == "cpu" else "cuda")
    edits = ActorEdits(lateral=1.0) if case == "edits" else None
    with torch.set_grad_enabled(case == "grad"):
        assert pipe._replays_nff(device, edits) == (case == "serving")


@pytest.mark.parametrize("preset", ["parity", "tiny"])
@pytest.mark.parametrize("all_camera", [True, False])
def test_the_chunked_render_on_the_cpu_gives_what_it_gave_before(preset, all_camera, parity, tiny, monkeypatch):
    pipe = parity if preset == "parity" else tiny

    def refuse(*args):
        raise AssertionError("a CPU render replayed graphs")

    monkeypatch.setattr(pipe.nff_graphs, "render", refuse)
    bundle = _camera(pipe) if all_camera else _lidar(pipe)
    assert bundle.origins.shape[0] % CHUNK, "the last chunk is padded"
    with torch.no_grad():
        want = _chunked_before(pipe, bundle, all_camera)
        with P.counting() as counters:
            got = pipe._chunked_nff(bundle, all_camera)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    chunks = -(-bundle.origins.shape[0] // CHUNK)
    assert P.counter_values(counters)["nff.chunks"] == chunks
    assert "nff.chunks_replayed" not in P.counter_values(counters)


@pytest.mark.parametrize("change, same", [("copy_", True), ("load_state_dict", True), ("update_actors", True),
                                          ("replaced", False), ("rows", False), ("lidar", False)])
def test_the_key_survives_in_place_changes_and_not_a_replaced_tensor(change, same, monkeypatch):
    pipe = _pipeline()
    model = pipe.model
    piece = map_tensors(lambda x: x[:CHUNK], _camera(pipe))
    before = nff_graphs.key_of(model, piece, CHUNK, CHUNK)
    rows, cam = CHUNK, CHUNK
    layer = model.field.mlp_geo.output
    if change == "copy_":
        with torch.no_grad():
            layer.weight.copy_(layer.weight * 2.0)
    elif change == "load_state_dict":
        model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()})
    elif change == "update_actors":
        state = ClosedLoopState(pipe, device="cpu")
        state.update_actors(state.get_actors())
    elif change == "replaced":
        monkeypatch.setattr(layer, "weight", nn.Parameter(layer.weight.detach().clone()))
    elif change == "rows":
        rows = 2 * CHUNK
    else:
        piece, cam = map_tensors(lambda x: x[:CHUNK], _lidar(pipe)), 0
    assert (nff_graphs.key_of(model, piece, rows, cam) == before) == same


def test_the_lookup_kernel_entry_keeps_its_parameters():
    """The benchmark's K1f recorder wraps `_forward` and takes its parameters."""
    params = inspect.signature(he._forward).parameters
    assert list(params) == ["positions", "stds", "tables", "scales", "buckets", "dense_res", "f", "read_bf16",
                            "cell_packed", "copies"]
    assert params["copies"].default is None


@pytest.mark.parametrize("preset, lookups", [
    ("parity", [("model.proposals", 3, 1), ("model.proposals", 4, 1)] * 2 + [("model.field", 3, 4),
                                                                             ("model.field", 4, 4)]),
    ("tiny", [("model.field", 3, 4), ("model.field", 4, 4)]),
])
def test_a_capture_is_cut_at_each_lookup_of_a_chunk(preset, lookups, parity, tiny):
    """What a capture sees of a chunk's render: the lookups it is cut at, in
    order, each in its span, with D and F; the render with the cut's lookups
    is the render. With autograd on, no lookup is cut."""
    pipe = parity if preset == "parity" else tiny
    piece = map_tensors(lambda x: x[:CHUNK], _camera(pipe))
    seen = []

    def cut(positions, stds, tables, layout, copies):
        seen.append((opened[-1], positions.shape[1], layout[3]))
        return he._forward(positions, stds, tables, *layout, copies=None if copies is None else copies.of(tables))

    with torch.no_grad():
        want = pipe.model.get_nff_outputs(piece, CHUNK)
        with P.spans_opened() as opened, he.cut_at_lookups(cut):
            got = pipe.model.get_nff_outputs(piece, CHUNK)
    assert seen == lookups
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with he.cut_at_lookups(cut):
        pipe.model.get_nff_outputs(piece, CHUNK, train=True)
    assert len(seen) == len(lookups)


def test_spans_opened_lists_the_spans_of_its_block():
    with P.spans_opened() as outer:
        with P.span("model.proposals"):
            pass
        with P.spans_opened() as inner:
            with P.span("model.field"), P.span("model.weights"):
                pass
        with P.span("model.decode"):
            pass
    assert outer == ["model.proposals", "model.decode"]
    assert inner == ["model.field", "model.weights"]
    with P.span("model.field"):
        pass
    assert outer == ["model.proposals", "model.decode"]


def test_count_again_adds_a_block_with_its_device_values_cloned():
    """A capture's counts, added after each replay: the value the graph
    holds is cloned once however many counters read it, so the next replay's
    write does not reach the counts already added."""
    hits = torch.tensor(7)
    with P.counting() as captured:
        P.count("actor.samples_hit", hits)
        P.count("actor.capacity", 5)
        P.count("actor.samples_dropped", hits, above=5)
    captured.count_again()  # outside counting: nothing, and no error
    with P.counting() as window:
        captured.count_again()
        hits.fill_(3)  # the next replay
        captured.count_again()
    assert P.counter_values(window) == {"actor.samples_hit": 10, "actor.capacity": 10,
                                        "actor.samples_dropped": 2}
    assert len({id(v) for v in window.device["actor.samples_hit"]}) == 2
    assert window.device["actor.samples_hit"][0] is window.device["actor.samples_dropped"][0]


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the lookup kernel have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _eager(pipe, monkeypatch, fn):
    with monkeypatch.context() as m:
        m.setattr(pipe, "_replays_nff", lambda *args: False)
        return fn()


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _counted(fn):
    with P.counting() as counters:
        out = fn()
    return out, P.counter_values(counters)


@pytest.mark.cuda
@pytest.mark.parametrize("parity_preset", [True, False])
def test_replayed_chunks_equal_the_eager_chunks_bit_for_bit(cuda, parity_preset, monkeypatch):
    """Camera and lidar keys, the last chunk padded; the first render of a
    key renders its first chunk eagerly and captures at the second."""
    pipe = _pipeline("cuda", parity=parity_preset)
    for all_camera, bundle in ((True, _camera(pipe)), (False, _lidar(pipe))):
        chunks = -(-bundle.origins.shape[0] // CHUNK)
        with torch.no_grad():
            want = _eager(pipe, monkeypatch, lambda: pipe._chunked_nff(bundle, all_camera))
            first, n1 = _counted(lambda: pipe._chunked_nff(bundle, all_camera))
            again, n2 = _counted(lambda: pipe._chunked_nff(bundle, all_camera))
        _equal(first, want)
        _equal(again, want)
        assert n1["nff.chunks"] == chunks and n1["nff.chunks_replayed"] == chunks - 1 and n1["nff.captures"] == 1
        assert n2["nff.chunks"] == n2["nff.chunks_replayed"] == chunks and "nff.captures" not in n2


def _actor_ahead(pipe) -> None:
    """Move the actor, in place, to 6 m ahead of the eval camera."""
    state = ClosedLoopState(pipe, device=pipe.device)
    c2w = pipe.outputs.cameras.camera_to_worlds[pipe.outputs.eval_camera_indices[0]].numpy()
    ahead = c2w[:, 3] - 6.0 * c2w[:, 2]  # the camera looks down -z
    actors = state.get_actors()
    for a in actors:
        for pose in a["poses"]:
            pose[0][3], pose[1][3] = float(ahead[0]), float(ahead[1])
    state.update_actors(actors)


@pytest.mark.cuda
def test_a_replay_after_update_actors_renders_the_moved_actor(cuda, monkeypatch):
    """The replay renders what the eager render renders after the actor
    moved, and that differs from before."""
    pipe = _pipeline("cuda")
    bundle = _camera(pipe)
    with torch.no_grad():
        pipe._chunked_nff(bundle, True)
        before = pipe._chunked_nff(bundle, True)
    _actor_ahead(pipe)
    with torch.no_grad():
        want = _eager(pipe, monkeypatch, lambda: pipe._chunked_nff(bundle, True))
        got, counts = _counted(lambda: pipe._chunked_nff(bundle, True))
    _equal(got, want)
    assert any(not torch.equal(want[k], before[k]) for k in want), "the move shows"
    assert counts["nff.chunks_replayed"] == counts["nff.chunks"] and "nff.captures" not in counts


@pytest.mark.cuda
def test_each_lookup_kernel_is_an_eager_call_in_eager_order(cuda, monkeypatch):
    """A recorder around `_forward`, as the benchmark's K1f recorder is: 6
    calls a chunk of the parity preset, with the eager render's inputs."""
    pipe = _pipeline("cuda")
    bundle = _camera(pipe)
    calls = []
    original = he._forward

    def recorder(positions, stds, tables, *args, **kwargs):
        calls.append((positions.detach().clone(), tuple(t.data_ptr() for t in tables)))
        return original(positions, stds, tables, *args, **kwargs)

    with torch.no_grad():
        pipe._chunked_nff(bundle, True)
        pipe._chunked_nff(bundle, True)
        monkeypatch.setattr(he, "_forward", recorder)
        _eager(pipe, monkeypatch, lambda: pipe._chunked_nff(bundle, True))
        eager, calls = calls, []
        launches = he.hash_grid_launches
        pipe._chunked_nff(bundle, True)
    chunks = -(-bundle.origins.shape[0] // CHUNK)
    assert len(calls) == len(eager) == 6 * chunks
    assert he.hash_grid_launches - launches == 6 * chunks
    for (p, t), (q, u) in zip(calls, eager):
        assert t == u and torch.equal(p, q)


@pytest.mark.cuda
def test_replayed_actor_counters_equal_the_eager_counters(cuda, monkeypatch):
    pipe = _pipeline("cuda")
    _actor_ahead(pipe)
    bundle = _camera(pipe)
    with torch.no_grad():
        pipe._chunked_nff(bundle, True)
        pipe._chunked_nff(bundle, True)
        _, eager = _counted(lambda: _eager(pipe, monkeypatch, lambda: pipe._chunked_nff(bundle, True)))
        _, replayed = _counted(lambda: pipe._chunked_nff(bundle, True))
    actor = {k: v for k, v in eager.items() if k.startswith("actor.")}
    assert actor["actor.samples_hit"] > 0, "the samples reach the actor"
    assert {k: v for k, v in replayed.items() if k.startswith("actor.")} == actor


@pytest.mark.cuda
def test_the_graphs_keep_only_their_ray_buffers_allocated(cuda, monkeypatch):
    """After the capture the pool's blocks are free (reserved, not
    allocated): what stays allocated is the ray buffers and the counted
    values."""
    pipe = _pipeline("cuda")
    bundle = _camera(pipe)
    with torch.no_grad():
        _eager(pipe, monkeypatch, lambda: pipe._chunked_nff(bundle, True))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        pipe._chunked_nff(bundle, True)
        pipe._chunked_nff(bundle, True)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    piece = map_tensors(lambda x: x[:CHUNK], bundle)
    buffers = sum(512 * -(-x.numel() * x.element_size() // 512) for x in nff_graphs._ray_tensors(piece))
    assert after - before <= buffers + 16 * 512
