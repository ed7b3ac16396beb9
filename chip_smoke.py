#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`neurad_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

`--parent DIR`: another checkout of this repository (say, the parent commit
unpacked with `git archive`). First, TURN_ROUNDS rounds of the `neurad`
preset's training, that checkout's and this tree's, each run in a fresh
process that imports its own tree's package (`turn_run`), the order
alternating (parent, change; change, parent; ...): 1 + TURN_STEPS train
steps on the drive phase's KITTI-MOT sequence (`next_train` batches, the
median step), then 1 + TURN_STEPS steps of the train script's loop
(`train_loop`, the preset's sampler threads) on the synthetic scene (rays/s
over the steps after the first); per metric, the pairs the change won and
each side's median and quartiles. Then its hash-grid lookup, tile composite and
gather-probe wrappers are imported from it, with its own build module and C
interface, their libraries built from its own sources, and its entries
(`hash_grid_encode`, `tile_composite_camera`, `tile_composite_lidar`, the
lidar backward's `_lidar_backward`, the coalesced and serial gathers P1 and
P5 at every probe table shape) timed in turns with this tree's (parent,
change, change, parent), as a call and as device time, their outputs
compared bit for bit (the lidar backward's, whose atomics add in no fixed
order, within BWD_TOL of each entry's terms' magnitude).

1. Builds every CUDA kernel from `neurad_tpu_torch/csrc/` (nvcc, sm_90a; one
   nvcc per source, started together) and prints ptxas's report of every
   kernel instantiation (registers, stack frame, spills, static shared
   memory); the lookup's backward must keep no stack frame, the lookup's
   forward, the tile composites (bar the camera backward) and the serial
   gather probe neither stack nor spill.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the full-width shapes of the main paths (camera tile composite and
   its backward: T=8160 tiles x P=256 pixels x K=256 slots, C=16; lidar tile
   composite and its backward: T=3780 x P=128 x K=128, C=16, azimuth wrap on),
   on inputs projected and binned from 500,000 seeded gaussians and, for the
   backwards, seeded cotangents that are zero on the rows outside the image,
   and times both with CUDA events (and every composite's device time,
   the backwards' with their d_table fill, from a CUDA graph); the bounds of the camera
   composite and of both lidar kernels count the least work (the plain
   version's alpha terms, counted on the card): the quadratic form alone for
   pairs beyond the far cut, the gated alpha for the other valid pairs, the
   feature work only for pairs whose alpha passes the gate; the lidar's only
   over valid query slots, whose share it reports with the share of pairs and
   of (warp, slot) steps beyond the far cut. After the SplatAD serving phase, so that
   that phase meets the card as it always did: the hash-grid lookup at the
   NeuRAD field's full width (static grid: N=1,048,576 samples, 8 levels, D=3,
   4 features, the preset's tables, on uniform positions and on a serving
   chunk's ray-ordered ones from the scene's cameras; a train chunk's
   N=262,144; the unpacked layout of `neurad-parity`; actor grid: N=131,072,
   D=4, 4 levels; the `neurad-parity` preset's proposal grids at F = 1, fp32
   reads: 6 levels of 2^20 on a proposal round's 8,192 x 128 positions, and
   its actor proposal grid, D = 4, 4 levels of 2^15, N=131,072), in each read mode (bf16 reads of the bf16 copy, bf16 reads
   of the fp32 master, fp32 reads), must equal its plain version on the fp32
   master bit for bit; its bytes bound counts rows in the bytes of the type it
   reads, and the copy's conversion is timed apart. The six gather and
   scatter-add probes run through their own entry point at every table shape
   against table[idx] (bit for bit) and index_add_ (1e-5 of the terms'
   magnitude), beside torch.index_select and index_add_, and the three
   scatter-adds once more at (131072, 32) on skewed indices (half in one row,
   a quarter in the last 16); the bucketed one-hot scatter must give the same
   bits on a second launch; every probe and yardstick is timed as a call and
   as device time (a CUDA graph of 10 calls). Then the bucketed probes' (P2,
   P3, P4) device time kernel by kernel and their host time before the first
   launch.
3. Serving phase: builds the SplatAD pipeline on the synthetic scene at
   1920x1080 with 500,000 gaussians and a 64x1024-beam lidar, starts the
   closed-loop HTTP server on localhost, answers two /render_image requests at
   different poses and timestamps, renders five more warm requests without
   the JSON round trip (two of them from a new thread, as the server gives
   every request one) and the lidar scan three times, checks the
   outputs and that both forward kernels were launched on that path, then
   renders one more request and one more warm scan under torch.profiler
   (device time by kernel).
4. Train phase (run after the NeuRAD phases): trains SplatAD through `SplatADPipeline.init_state`,
   `datamanager.next_train` and `train_step` on the same scene at full
   resolution (`num_downscales=0`), at least three camera and three lidar
   steps with MCMC refines among them, checks the losses, that every parameter
   group moved and that the backward kernels were launched once per step,
   profiles one step of each kind, writes a checkpoint into a run directory and
   serves a request from a `ClosedLoopState` loaded from it. One more camera
   step runs at the default schedule's first resolution (480x270).
5. NeuRAD serving phase: the `neurad` preset's model at full width (2^22
   static slots x 8 levels x 4 features, 2^17 actor slots, MLP proposals
   128/64, 32 field samples, 32 + 16 features, CNN hidden 32, upsample 3),
   weights from seed 0, on the same scene: the closed-loop server answers two
   1920x1080 camera requests (cold and warm timed apart) and /update_actors,
   the pipeline renders the 64x1024-beam scan twice, one warm request runs
   under torch.profiler; the lookup kernel must launch twice per chunk of
   32,768 rays. Before it, the lookup's backward (K1b) at a train chunk's full
   width (static grid: 8,192 rays x 32 samples from the scene's cameras, bf16
   and fp32 reads; the same N in one cell of the coarsest level; actor grid:
   N=32,768, D=4; the unpacked layout of `neurad-parity`; the parity
   preset's two F = 1 proposal grids at the forward's shapes) is held against its
   plain version and timed as a call and as device time, and the probe run includes the three scatter-add probes
   beside index_add_.
6. NeuRAD train phase: the `neurad` preset at full width (57,344 rays a batch
   in 7 chunks of 8,192, VGG on, five Adam groups), livened weights, 5 steps
   through `ADPipeline.train_step` (K1f and K1b twice a chunk), 4 more through
   the train script's loop with the preset's sampler threads, one profiled
   step, a checkpoint and a 1080p request served from it.
7. Eval: `eval_metrics` of the pipelines the two train phases trained (the
   scene's eval camera at 1920x1080 and its 64x1024-beam scan; NeuRAD's once
   more under torch.profiler), timed, finite, through K2 and K4 (SplatAD) and
   K1f (NeuRAD); `python -m neurad_tpu_torch.scripts.eval` in process on the
   SplatAD train phase's run directory; `eval_fid_suite(max_images=2)` of both
   models at full width on the scene cut to 8 frames with 2 held out.
8. Splatfacto: the `splatfacto` preset at full width (100,000 slots, 30,000
   gaussians at the start, SH degree 3, 16-px tiles, 256 slots a tile) on the
   synthetic 1080p scene, six steps through `SplatfactoPipeline.train_step`
   with two Default-strategy refines (cut from the preset's start at 500 and
   every 100), one profiled step, `eval_metrics`; then the camera composite
   and its backward at C = 3 (their CMAX = 8 form) held against their plain
   versions on the inputs of a real step, timed as the kernel phase's C = 16
   cases are.
9. Drive: a logged drive in the KITTI-MOT layout written by
   `make_kittimot_fixture` (image_02 at 1242x375, about 120,000 HDL-64E
   returns a scan, OXTS, calibration, tracked cars; 20 frames, cut from a
   real sequence's hundreds) and parsed by the port's `KittiMotDataParser`
   with the missing-point synthesis on (timed, the points it adds counted;
   the frames carry libpng's mix of row filters, and `read_png` is timed
   alone on five of them);
   the `neurad` preset trains 3 steps on it (57,344 rays a batch, one more
   profiled) and the `splatad` preset at least three camera and three lidar
   steps with MCMC refines (one of each kind profiled); both run
   `eval_metrics`, and the trained SplatAD serves a closed-loop camera
   request and renders a scan. The counters must show K1f, K1b, K2, K3, K4
   and K5 launched in this phase.
10. Nerfacto: the `nerfacto` and `nerfacto-lidar` presets at full
   width (4,096 camera rays in 64 patches of 8x8, plus 4,096 lidar rays;
   proposal samples 256 and 96, 48 field samples; 16 levels of 2 features
   in 2^19 buckets, proposals 5 levels in 2^17) on the synthetic 1080p scene
   through `engine/trainer.Trainer`, 7 steps each (callbacks time every step)
   and one profiled; K1f and K1b three times a step. Then K1f and K1b at the
   three grids on the positions of a real `nerfacto` step (4,096 rays x 48,
   256 and 96 samples; F = 2, one row a grid corner, bucket_pack 2 on the
   hashed levels): K1f equal to its plain version bit for bit, K1b within
   BWD_TOL of each entry's terms, timed as a call and as device time beside
   their bytes bounds. The drive phase trains `nerfacto-lidar` 3 steps on
   the KITTI-MOT sequence. The presets phase checks `neurad-paper`,
   `neurader` and `neuradest` (trainer and schedule lengths) and takes one
   full-width step of `neurad-scaleopt` (SO3xR3 camera optimisation).
11. Checks the card's renders (SplatAD and NeuRAD) and one train step's
   gradients of each model against the CPU path on small scenes, and the
   metric functions (exact LPIPS and Inception pool3 from seeded weights
   written by the port's converter, the VGG19 fallback LPIPS, the chamfer
   distance) on the card against the CPU on the same inputs.

12. Render, export and view the trained runs (after the SplatAD train
   phase; the run directories of both train phases live in a temporary
   directory deleted at the end, each loaded once): `scripts.render` on the
   SplatAD and the NeuRAD run (every camera, a camera-path JSON of 3 poses,
   an interpolated path, the lidar as .npz and BEV PNGs, an actor shift,
   then a lane shift), every camera PNG equal to the quantised
   `render_eval_camera`, a 1080p frame split into render, copy and PNG
   encode; `scripts.export` in all six modes at --resolution 128 (device
   and host seconds, peak memory; the field mesh's K1f launches, the splat
   PLY read back); `scripts.viewer.serve_run` of both runs on a free port
   (/render low and high equal to the direct `render_viewer_image`, /lidar,
   /export, /train, the stale drop), then SplatAD through `Trainer` with
   and without the train script's live viewer while a client posts
   renders, each inside the lock. K2, K4 and K1f must launch on each path,
   counted over the scripts' own runs and the HTTP requests only (`Counted`),
   not over the reference renders, timings and profiles beside them.

13. Data-parallel training over `torch.distributed` (`data_parallel_phase`,
   after the presets phase): (a) an NCCL world of 1 in this process runs a
   SplatAD camera and lidar step, a splatfacto step and a NeuRAD step at
   full width through the pipelines' `make_sharded_train_step` and the
   plain `train_step` (twice) from the same state and inputs: losses bit for
   bit; each tensor's gradient within 4x the two plain steps' distance (at
   least 2.5e-3 of its largest entry and 2.5e-4 of its optimizer group's)
   of a plain step's (K1b, K3, K5 and
   cuDNN's backwards add in no fixed order, so no two steps are bit-equal
   there); parameters within 2 lr; (b) a gloo
   world of 2 ranks on
   this card, spawned (`_dp_rank`): SplatAD at full width for 3 MCMC steps
   (camera, lidar with a refine, camera) and a Default-strategy camera step,
   splatfacto 2 steps (SGD for both), the `neurad` preset 2 steps; rank 0
   holds each step's averaged gradients against the one-process batched
   step's (the global batch's for NeuRAD), the parameters are checked bit
   for bit across the ranks after every step, and every rank must launch
   K1f, K1b and K2-K5 (`data_parallel_launches`); (c) the train script
   under `python -m torch.distributed.run --standalone --nproc_per_node 1`
   trains the `splatad` preset at full width 3 steps (one checkpoint), and
   its entry point resumes from it to a fourth in (a)'s NCCL world; (d)
   NeuRAD's sharded eval render and `eval_metrics` in the gloo world equal
   the one-process ones. Reported: each step's seconds by backend, the
   all-reduce's share, peak memory per rank.
14. Library (`library_phase`): one SplatAD lidar step at full width with
   `lidar_raster_mode="points"` (per-point gathers, plain PyTorch), its
   outputs and opacity gradients against the tiled path's (K4, K5) on the
   same scan, the points beside the azimuth's wrap apart, its time and peak
   beside a tiled step's; one NeuRAD request with `rgb_decoder_norm="batch"`.
15. API (`api_phase`, after the drive phase): the rest of the JAX package's
   public API, each piece on the card against the same function on the CPU:
   the SDS loss and its gradient at Stable Diffusion's latent size over the
   guidance's t range, classifier-free guidance, the positional prompt
   embeddings in their three modes at SD 1.5's [2, 77, 768],
   `BottleneckBlock` (group norm; batch norm in train and eval mode) on
   [1, 32, 360, 640] fp32 with its forward timed beside `BasicBlock`'s, the
   scene-box and oriented-box masks on 1,000,000 points, the pose inverse,
   normalisation and rotation difference on the drive's poses (cameras,
   lidar, actors; the rotation difference between every pair); and
   `StableDiffusionGuidance()` must raise ImportError without `diffusers`.

16. The `neurad-parity` preset (`parity_phase`, after the presets phase):
   hash-grid proposal fields (6 levels of 2^20 at F = 1, actor proposals 4
   of 2^15), every table hashed at every level and unpacked, fp32 reads,
   MLPs and decoder, at full width (the table shapes, the parameter count
   and every grid's fp32 reads checked), served through
   `closed_loop.build_state("neurad-parity")`: a cold and three warm 1080p
   requests and two scans, K1f six times a chunk (the field's static and
   actor grids, then each proposal round's), one profiled request; trained
   on the same pipeline: `init_state`, 4 steps of 57,344 rays in 7 chunks,
   2 more through `train_loop`, K1f and K1b six times a chunk, every group
   and every proposal field's tables moved, one profiled step, a checkpoint
   served by `ClosedLoopState.from_run_dir`; then one train chunk of 1,024
   rays on the card against the CPU with the same weights, batch and draws
   (the loss within PARITY_LOSS_TOL, each gradient within PARITY_GRAD_TOL of
   its parameter's largest entry). Its K1f and K1b launches are the
   `parity_launches` of the lookup's entries in the `kernels` line.

Prints the card's name and power limit, one JSON line with the twelve
kernels' numbers, and as its last line {"ok": true, "device": {...}}. Any failure raises
and exits non-zero. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"  # the report, and the train phase's run directory while it runs
sys.path.insert(0, str(ROOT))

# H100 SXM data-sheet peaks (dense): fp32 outside the tensor cores, HBM3 bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
N_GAUSS = 500_000
MIN_STEPS_PER_KIND = 3
BWD_TOL = 1e-5  # backward kernels: error of an entry over the sum of its per-pixel terms' absolute values
WIDTH, HEIGHT = 1920, 1080
LIDAR_BEAMS = (64, 1024)  # channels x azimuth steps: 65,536 beams
SCENE = dict(num_frames=3, image_height=HEIGHT, image_width=WIDTH, focal=0.7 * WIDTH, lidar_channels=LIDAR_BEAMS[0],
             lidar_azimuths=LIDAR_BEAMS[1])
SEED = 0
DEVICE = "cuda"
NEURAD_CHUNK = 1 << 15  # rays per chunk of a NeuRAD render (ADPipelineConfig.eval_chunk)
NEURAD_SAMPLES = 32  # field samples per ray
HASH_KERNEL = "hash_grid_fwd_kernel"
HASH_BWD_KERNEL = "hash_grid_bwd_kernel"
CAMERA_KERNEL = "camera_fwd_kernel"
LIDAR_KERNEL = "lidar_fwd_kernel"
LIDAR_BWD_KERNEL = "lidar_bwd_kernel"
SERIAL_GATHER_KERNEL = "gather_serial_kernel"
NEURAD_TRAIN_STEPS = 5  # the first apart, then the warm ones
NEURAD_LOOP_STEPS = 4  # then through the train script's loop and sampler threads, the first apart
SPLATAD_EVAL_KEYS = {"psnr", "ssim", "depth_median_l2", "depth_mean_rel_l2"}
NEURAD_EVAL_KEYS = SPLATAD_EVAL_KEYS | {"lpips", "actor_psnr", "actor_coverage", "intensity_rmse",
                                        "ray_drop_accuracy", "chamfer_distance"}
FID_KEYS = {"fid_actor_shift_rot", "fid_actor_shift_trans", "fid_lane_shift_2m", "fid_lane_shift_3m",
            "fid_vertical_shift_1m"}
FID_SCENE = dict(SCENE, num_frames=8, train_split_fraction=0.75)  # the last 2 frames held out: two eval cameras
FID_IMAGES = 2
DRIVE_SEQ = "0006"
DRIVE_FRAMES = 20  # a KITTI-MOT sequence cut to 20 frames (0006 has 270)
DRIVE_SPLIT = 0.9  # linspaced split: 18 train frames, 2 eval frames
DECODE_FRAMES = 5  # frames whose `read_png` is timed alone, after the parse
DRIVE_NEURAD_STEPS = 3  # the first apart
SPLATFACTO_STEPS = 6
NERFACTO_STEPS = 6  # warm steps through Trainer, after the first
NERFACTO_DRIVE_STEPS = 3
SPLATFACTO_REFINE = (2, 3)  # refine_start_iter, refine_every (the preset's: 500, 100): refines after steps 3 and 6
LPIPS_TOL = 1e-4  # metric functions, card against CPU (fp32, TF32 off): relative
POOL3_TOL = dict(rtol=2e-3, atol=2e-4)  # as the CPU tests hold the pool3 features to JAX's
CHAMFER_TOL = 1e-5  # relative
K1B_RAYS = 8192  # one train chunk (ADPipelineConfig.train_ray_chunk) of the `neurad` preset ...
K1B_SAMPLES = 32  # ... times its field samples: the static lookup's N in a train step
TURN_ROUNDS = 10  # `--parent`: rounds of two fresh-process runs, the parent's and this tree's
TURN_STEPS = 10  # timed steps a run and metric, after the first
REPORT = {}
PARENT = {}  # `--parent DIR`: the lookup and composite libraries built from that checkout's sources
RUNS = None  # a temporary directory (deleted at the end) holding the train phases' run directories
RENDER_POSES = 3  # poses of the render phase's camera-path JSON
INTERPOLATE = 2  # --interpolate steps between consecutive cameras
EXPORT_RESOLUTION = 128  # --resolution of the field-mesh, tsdf-mesh and poisson exports
VIEWER_TRAIN_STEPS = 6


def _sync() -> None:
    import torch

    if DEVICE != "cpu":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def load_parent(tree):
    """Import the lookup and composite wrappers and the gather probes of another checkout of this
    repository (`--parent DIR`), each with that checkout's own build module and
    C interface, under this tree's package name and without replacing this
    tree's modules, so that its kernels and this tree's run in turns on one
    card through their public entries. Returns that checkout's build module:
    its `build_all` builds its libraries from its own sources."""
    import importlib

    prefix = "neurad_tpu_torch"
    ours = lambda: [k for k in sys.modules if k == prefix or k.startswith(prefix + ".")]
    saved, saved_path = {k: sys.modules.pop(k) for k in ours()}, list(sys.path)
    sys.path.insert(0, str(Path(tree).resolve()))
    try:
        PARENT.update(hash_encoding=importlib.import_module(prefix + ".ops.hash_encoding"),
                      tile_composite=importlib.import_module(prefix + ".ops.tile_composite"),
                      gather_microbench=importlib.import_module(prefix + ".benchmarks.gather_microbench"),
                      tree=str(tree))
        return importlib.import_module(prefix + ".ops._build")
    finally:
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)
        sys.path[:] = saved_path


def turn_run() -> None:
    """One run of `--parent`'s turns, in a fresh process whose `sys.path`
    puts the checkout under test first (`parent_turns`): that checkout's
    kernels built, the `neurad` preset trained 1 + TURN_STEPS steps on the
    drive phase's sequence (`drive_outputs`; `next_train` batches outside the
    clock, each step synchronised and timed), then 1 + TURN_STEPS steps of its
    train script's loop (`train_loop`, the preset's sampler threads) on the
    synthetic scene, livened as in the NeuRAD train phase. Only entries that
    checkouts since the KITTI-MOT fixture have. Prints one line `TURN {...}`."""
    import torch

    import neurad_tpu_torch
    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.ops import _build
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline
    from neurad_tpu_torch.scripts.train import train_loop

    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = dict(package=str(Path(neurad_tpu_torch.__file__).resolve().parent.parent))
    with tempfile.TemporaryDirectory() as tmp:
        outputs = drive_outputs(tmp)[0]
    cfg = METHODS["neurad"]().pipeline
    cfg.seed = SEED
    pipeline = ADPipeline(outputs, cfg, device=DEVICE)
    state = pipeline.init_state()
    ms = []
    for _ in range(TURN_STEPS + 1):
        batch = pipeline.datamanager.next_train()
        _sync()
        t0 = time.perf_counter()
        state, _ = pipeline.train_step(state, *batch)
        _sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    res.update(drive_first_ms=ms[0], drive_ms=ms[1:], drive_median_ms=statistics.median(ms[1:]))
    del pipeline, state
    torch.cuda.empty_cache()

    pipeline = ADPipeline(SyntheticDataParserConfig(**SCENE).setup().get_dataparser_outputs(), cfg, device=DEVICE)
    _liven(pipeline.model)
    state = pipeline.init_state()
    n_rays = pipeline.num_cam_rays + cfg.datamanager.num_lidar_rays
    trainer = METHODS["neurad"]().trainer
    trainer.max_num_iterations, trainer.steps_per_log, trainer.steps_per_save = TURN_STEPS + 1, 1, 10**9
    with tempfile.TemporaryDirectory() as tmp:
        state, history = train_loop(pipeline, state, trainer, Path(tmp))
    rates = [h["train_rays_per_sec"] for h in history]
    res.update(loop_rays_per_s_by_step=rates,
               loop_rays_per_s=n_rays * (len(rates) - 1) / sum(n_rays / r for r in rates[1:]))
    print("TURN " + json.dumps(res), flush=True)


def parent_turns(parent) -> dict:
    """`--parent`: TURN_ROUNDS rounds of `turn_run`, the parent checkout's
    run and this tree's, each in a fresh process, the order alternating
    (parent, change; then change, parent; ...). Host-clock step times differ
    more between processes than within one, so the two trees are compared
    across runs: per metric (the drive's median step, lower is better; the
    synthetic loop's rays/s, higher is better) the pairs the change won (ties
    count for neither), each side's median, and the parent's quartiles."""
    trees = {"parent": str(Path(parent).resolve()), "change": str(ROOT)}
    runs = {name: [] for name in trees}
    for r in range(TURN_ROUNDS):
        for name in (("parent", "change") if r % 2 == 0 else ("change", "parent")):
            code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
                    f"sys.path.insert(0, {trees[name]!r}); chip_smoke.turn_run()")
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
            line = [x for x in out.stdout.splitlines() if x.startswith("TURN ")]
            require(out.returncode == 0 and bool(line), f"turn {r + 1}, {name}: {out.stderr[-2000:]}")
            run = json.loads(line[0][len("TURN "):])
            require(run["package"] == trees[name], f"turn {r + 1}, {name}: ran {run['package']}'s package")
            runs[name].append(run)
            log(f"[turns] round {r + 1}, {name} ({time.perf_counter() - t0:.0f} s): drive first "
                f"{run['drive_first_ms']:.1f} ms, median {run['drive_median_ms']:.1f} ms "
                f"({', '.join(f'{m:.1f}' for m in run['drive_ms'])}); train_loop {run['loop_rays_per_s']:.0f} rays/s")
    summary = {}
    for metric, lower_better in (("drive_median_ms", True), ("loop_rays_per_s", False)):
        par, chg = [r[metric] for r in runs["parent"]], [r[metric] for r in runs["change"]]
        wins = sum((c < p) if lower_better else (c > p) for p, c in zip(par, chg))
        losses = sum((c > p) if lower_better else (c < p) for p, c in zip(par, chg))
        q = statistics.quantiles(par, n=4)
        summary[metric] = dict(parent=par, change=chg, change_wins=wins, change_losses=losses, pairs=len(par),
                               parent_median=statistics.median(par), change_median=statistics.median(chg),
                               parent_quartiles=[q[0], q[2]])
        log(f"[turns] {metric}: change won {wins}, lost {losses} of {len(par)} pairs; median parent "
            f"{statistics.median(par):.1f}, change {statistics.median(chg):.1f}; parent quartiles {q[0]:.1f}-{q[2]:.1f}"
            f" (spread {q[2] - q[0]:.1f})")
    return dict(runs=runs, summary=summary)


def turns(label, parent_fn, fn):
    """The parent checkout's kernel and this tree's timed in turns on one card:
    parent, change, change, parent, each as a call (median of CUDA-event
    timings: the wrapper's host time before the launch included) and as
    device time (`device_ms`)."""
    t = [cuda_time_ms(parent_fn), cuda_time_ms(fn), cuda_time_ms(fn), cuda_time_ms(parent_fn)]
    dev = [device_ms(parent_fn), device_ms(fn), device_ms(fn), device_ms(parent_fn)]
    log(f"[parent] {label}: call parent {t[0]:.4f}, change {t[1]:.4f}, change {t[2]:.4f}, parent {t[3]:.4f} ms; device "
        f"parent {dev[0]:.4f}, change {dev[1]:.4f}, change {dev[2]:.4f}, parent {dev[3]:.4f} ms")
    return dict(parent_ms=[t[0], t[3]], change_ms=[t[1], t[2]], parent_device_ms=[dev[0], dev[3]],
                change_device_ms=[dev[1], dev[2]])


def device_ms(fn, reps: int = 10) -> float:
    """Device time a call: `reps` calls captured in one CUDA graph, the graph
    replayed between CUDA events (no host time between the launches), the
    median of 3 replays over `reps` (`gather_microbench.device_ms`)."""
    import torch

    from neurad_tpu_torch.benchmarks.gather_microbench import device_ms as graph_device_ms

    return graph_device_ms(fn, torch.device("cuda"), reps)


def cuda_time_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def _random_gaussians(rng, n, centre_dist, spread):
    """Seeded 3D gaussians: means, covar6, velocities, features, opacities."""
    import numpy as np
    import torch

    from neurad_tpu_torch.ops import gaussians as G

    means = rng.normal(size=(n, 3)).astype(np.float32) * spread + centre_dist
    scales = np.exp(rng.uniform(np.log(0.03), np.log(0.8), size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    feats = rng.uniform(size=(n, 16)).astype(np.float32)
    opac = rng.uniform(0.05, 0.99, size=n).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(DEVICE)
    covar6 = G.quat_scale_to_covar6(t(quats), t(scales))
    return t(means), covar6, t(vel), t(feats), t(opac)


def camera_inputs(rng):
    """Full-width camera composite inputs from 500k gaussians in front of a
    1920x1080 camera (projected and binned by the port's own code)."""
    import numpy as np
    import torch

    from neurad_tpu_torch.ops import gaussians as G
    from neurad_tpu_torch.ops.gaussian_rasterize import camera_tile_inputs

    means, covar6, vel, feats, opac = _random_gaussians(rng, N_GAUSS, np.array([0, 0, 30.0], np.float32),
                                                        np.array([25.0, 14.0, 20.0], np.float32))
    w, h = WIDTH, HEIGHT
    K = torch.tensor([[0.7 * w, 0, w / 2], [0, 0.7 * w, h / 2], [0, 0, 1.0]], device=DEVICE)
    proj = G.project_gaussians_camera(means, covar6, torch.eye(4, device=DEVICE), K, w, h, velocities=vel)
    binning, table, tile_valid, pix, times = camera_tile_inputs(
        proj, feats, opac, w, h, tile_size=16, max_per_tile=256, rolling_shutter_time=0.03
    )
    return (table, binning.tile_gauss, tile_valid, pix, times)


def lidar_inputs(rng):
    """Full-width lidar composite inputs: 500k gaussians around the sensor, a
    64 x 1024 beam pattern over (-25, 15) degrees of elevation, 2x2 degree
    tiles over 360 x (-26, 16) degrees (circular azimuth)."""
    import numpy as np
    import torch

    from neurad_tpu_torch.ops import gaussians as G
    from neurad_tpu_torch.ops.gaussian_rasterize import lidar_tile_inputs

    means, covar6, vel, feats, opac = _random_gaussians(rng, N_GAUSS, np.zeros(3, np.float32),
                                                        np.array([30.0, 30.0, 3.0], np.float32))
    proj = G.project_gaussians_lidar(means, covar6, torch.eye(4, device=DEVICE), velocities=vel)
    el, az = np.meshgrid(np.linspace(-25.0, 15.0, LIDAR_BEAMS[0]),
                         np.linspace(-180.0, 180.0, LIDAR_BEAMS[1], endpoint=False),
                         indexing="ij")
    m = el.size
    pts = np.stack([az.ravel(), el.ravel(), rng.uniform(2.0, 80.0, m), rng.uniform(-0.05, 0.05, m)], -1)
    ti = lidar_tile_inputs(proj, feats, opac, torch.from_numpy(pts.astype(np.float32)).to(DEVICE),
                           elev_range=(-26.0, 16.0), max_per_tile=128, pts_per_tile=128)
    require(ti["wrap"], "lidar grid must wrap in azimuth")
    return (ti["table"], ti["binning"].tile_gauss, ti["tile_valid"], ti["pts_slot"], ti["valid_slot"])


def _row_bytes(table, tile_gauss, tile_valid):
    """Bytes of the table rows the valid slots reference (each read once)."""
    import torch

    used = torch.unique(tile_gauss[tile_valid > 0])
    return used.numel() * table.shape[1] * 4


def _gate_counts(table, tile_gauss, tile_valid, pix, times, tile_chunk=128):
    """By the plain version's alpha terms, over the camera composite's valid
    (pixel, slot) pairs: those whose gated alpha is positive, and those beyond
    the far cut (sigma_raw > 5.6 of a slot whose opacity is at most 1: alpha
    is 0 whatever the exp gives); and over the valid (8x4-pixel patch, slot)
    pairs of 16x16 tiles (a warp's vote in K2), those whose pixels all lie
    beyond the far cut (no exp) and those with a positive alpha somewhere (the
    sums run) -> (nonzero pairs, far pairs, valid patch pairs, far patch
    pairs, patch pairs with a positive alpha)."""
    from neurad_tpu_torch.ops import tile_composite as TC

    nonzero = far_pairs = patches = far = lit = 0
    for s in range(0, pix.shape[0], tile_chunk):
        e = min(pix.shape[0], s + tile_chunk)
        valid = tile_valid[s:e] > 0
        g = TC._gather(table, tile_gauss[s:e])
        terms = TC._alpha_terms(g, valid, pix[s:e, :, 0:1], pix[s:e, :, 1:2], times[s:e], False)
        sigma_raw, alpha = terms[2], terms[5]
        nonzero += int((alpha > 0).sum())
        beyond = (sigma_raw > 5.6) & (valid & (g[..., 7] <= 1.0))[:, None, :]
        far_pairs += int(beyond.sum())
        if pix.shape[1] == 256:
            patch = lambda x: x.reshape(e - s, 4, 4, 2, 8, -1)  # tile, row block, row, column block, column, slot
            valid_p = valid[:, None, None, :]
            patches += int(valid_p.expand(e - s, 4, 2, -1).sum())
            far += int((patch(sigma_raw > 5.6).all(2).all(3) & valid_p).sum())
            lit += int((patch(alpha > 0).any(2).any(3) & valid_p).sum())
    return nonzero, far_pairs, patches, far, lit


def _bound(bytes_moved, ops):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FP32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _cotangents(rng, t_total, p, c, n_extra, outside=None):
    """Seeded cotangents [T, P, C] and n_extra x [T, P, 1]; zero where
    `outside` [T, P] is set (pixels of the last tile row beyond the image)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    cots = [torch.randn((t_total, p, c), generator=gen, device=DEVICE)]
    cots += [torch.randn((t_total, p, 1), generator=gen, device=DEVICE) for _ in range(n_extra)]
    if outside is not None:
        cots = [torch.where(outside[..., None], torch.zeros_like(x), x) for x in cots]
    return cots


def backward_check(label, table, outs, cots, plain_fn, valid_slots, pairs, input_bytes, c, extra_ops=0, least=None,
                   zero_columns=()):
    """Hold a backward kernel (reached through its autograd function: `outs`
    were computed from `table`, which requires grad) against its plain version
    and time both (`least`: (operations, bytes) of the least work, the bound
    reported where given, the formula below on every valid pair with the
    atomic traffic beside it). Tolerance per entry of the table's gradient: BWD_TOL times
    the sum of the absolute values of the entry's per-pixel terms (the plain
    version's `magnitude`), so that a gaussian with a small gradient is held as
    tightly as one with a large gradient. The kernel adds a warp's pixels by
    shuffles and the warps and tiles by global atomics, in an order that
    changes from run to run, and the plain version with einsum / cumsum /
    index_add_; both divide by 1 - alpha >= 0.001, which amplifies the rounding
    of the suffix sum it divides. Every column must get a gradient, bar
    `zero_columns`, whose gradient must be zero on both sides (a static
    scene's velocity columns at zero pixel times)."""
    import torch

    from neurad_tpu_torch.ops import tile_composite as TC

    grad = lambda: torch.autograd.grad(outs, table, cots, retain_graph=True)[0]
    got = grad()
    _sync()
    again = grad()
    ref = plain_fn()
    mag = plain_fn(magnitude=True)
    scale = ref.abs().amax(dim=0)
    err = (got - ref).abs()
    col_err = err.amax(dim=0)
    rel_col = (col_err / scale.clamp_min(1e-30)).tolist()
    to_mag = (err / mag.clamp_min(1e-30)).amax(dim=0).tolist()
    rows_off = float(((err > 1e-3 * ref.abs()).any(dim=1)).float().mean())
    run_to_run = float(((got - again).abs().amax(dim=0) / scale.clamp_min(1e-30)).max())
    names = list(TC.PACKED_COLUMNS) + [f"feature_{i}" for i in range(c)]
    log(f"[kernels] {label}: max abs err {float(err.max()):.3e}; per column, relative to the column's largest entry: "
        + ", ".join(f"{n} {r:.1e}" for n, r in zip(names, rel_col)))
    log(f"[kernels] {label}: largest error of an entry over the sum of its terms' absolute values, per column: "
        + ", ".join(f"{n} {r:.1e}" for n, r in zip(names, to_mag))
        + f"; rows with an entry off by more than 1e-3 of itself: {rows_off:.2e}")
    log(f"[kernels] {label}: two launches on the same inputs differ by at most {run_to_run:.1e} of a column's "
        f"largest entry (atomics)")
    require(bool(torch.isfinite(got).all()), f"{label} output is finite")
    zero = torch.tensor([n in zero_columns for n in names], device=scale.device)
    require(bool(((scale > 0) | zero).all()), f"{label}: every column gets a gradient")
    require(not bool(zero.any()) or float((got[:, zero].abs().max())) == 0.0 == float(scale[zero].max()),
            f"{label}: the columns {zero_columns} get no gradient on either side")
    require(max(to_mag) <= BWD_TOL, f"{label}: every entry within {BWD_TOL} of the sum of its terms' absolute values")
    ms = cuda_time_ms(grad)
    plain_ms = cuda_time_ms(plain_fn, warmup=1, reps=3)
    width = table.shape[1]
    # per valid pair, what the function needs: alpha (~30) and the payload gradient (2c + 4), the gradient
    # terms (~45 + c) and the sum over a tile's pixels of the 10 + c terms
    ops = pairs * ((34 + 2 * c) + 45 + c + width + extra_ops)
    atomic_bytes = valid_slots * width * 4 * 2  # each valid slot's row of d_table read and written
    bytes_moved = input_bytes + sum(x.numel() * 4 for x in cots) + table.numel() * 4 + atomic_bytes
    bound_ms, bound_by = _bound(bytes_moved, ops)
    out = dict(max_abs_err=float(err.max()), max_rel_err=max(rel_col), rel_err_by_column=dict(zip(names, rel_col)),
               max_err_over_term_sum=max(to_mag), err_over_term_sum_by_column=dict(zip(names, to_mag)),
               rows_off_1e3_relative=rows_off, run_to_run=run_to_run,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, pairs=pairs, ops=ops,
               bytes=bytes_moved, atomic_bytes=atomic_bytes)
    note = f" of which {atomic_bytes:.3e} atomic traffic"
    if least is not None:
        out.update(bound_every_pair_ms=bound_ms, ops_every_pair=ops, bytes_every_pair=bytes_moved)
        ops, bytes_moved = least
        bound_ms, bound_by = _bound(bytes_moved, ops)
        out.update(bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=bytes_moved)
        note = f"; {out['bound_every_pair_ms']:.4f} ms on every valid pair with the atomic traffic"
    log(f"[kernels] {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{ops:.3e} ops, {bytes_moved:.3e} bytes{note})")
    return out


def camera_fwd_check(label, args):
    """K2 held against its plain version on `args` (`camera_tile_inputs`'
    outputs), timed as a call and as device time beside the plain version,
    and its least-work bound -> (record, the kernel's outputs)."""
    import torch

    from neurad_tpu_torch.ops import tile_composite as TC

    table, tile_gauss, tile_valid, pix, times = args
    t_total, p, k, c = tile_gauss.shape[0], pix.shape[1], tile_gauss.shape[1], table.shape[1] - TC.ATTR
    got = TC.tile_composite_camera(*args)
    _sync()
    ref = TC.tile_composite_camera_plain(*args)
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    log(f"[kernels] {label} T={t_total} P={p} K={k} C={c}: valid slots {float((tile_valid > 0).float().mean()):.3f}, "
        f"max abs err feat/depth/alpha = {errs}")
    require(all(math.isfinite(e) for e in errs), f"{label} kernel output is finite")
    require(errs[0] <= 1e-4 and errs[2] <= 1e-4, f"{label} kernel features/alpha within 1e-4 of the plain version")
    require(errs[1] <= 1e-4 * float(ref[1].abs().max()) + 1e-4, f"{label} kernel depth within 1e-4 relative")
    del ref
    ms = cuda_time_ms(lambda: TC.tile_composite_camera(*args))
    dev_ms = device_ms(lambda: TC.tile_composite_camera(*args))
    plain_ms = cuda_time_ms(lambda: TC.tile_composite_camera_plain(*args), warmup=1, reps=3)
    n_valid = int((tile_valid > 0).sum())
    pairs = n_valid * p
    # the least work: a valid pair beyond the far cut needs its quadratic form (15 operations) and the
    # comparison with the cut, any other valid pair its gated alpha (32), and a pair whose alpha passes the gate
    # the feature, depth and alpha sums and the transmittance (2 (c + 2)); the earlier bound counted the alpha
    # and the feature work on every valid pair
    nonzero, far_pairs, patch_pairs, far_patches, lit_patches = _gate_counts(*args)
    ops = far_pairs * 16 + (pairs - far_pairs) * 32 + nonzero * 2 * (c + 2)
    ops_every_pair = pairs * (32 + 2 * c)
    bytes_moved = (tile_gauss.numel() * 4 + tile_valid.numel() * 4 + pix.numel() * 4 + times.numel() * 4
                   + _row_bytes(table, tile_gauss, tile_valid) + t_total * p * (c + 2) * 4)
    bound_ms, bound_by = _bound(bytes_moved, ops)
    bound_every_pair_ms, _ = _bound(bytes_moved, ops_every_pair)
    record = dict(max_abs_err=max(errs), ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by,
                  pairs=pairs, nonzero_pairs=nonzero, far_pairs=far_pairs, ops=ops, bytes=bytes_moved,
                  errs=errs, channels=c, valid_slots=n_valid,
                  bound_every_pair_ms=bound_every_pair_ms, patch_pairs=patch_pairs,
                  far_patch_pairs=far_patches, lit_patch_pairs=lit_patches)
    log(f"[kernels] {label}: {nonzero} of {pairs} valid pairs ({nonzero / pairs:.3f}) pass the alpha gate, "
        f"{far_pairs} ({far_pairs / pairs:.3f}) lie beyond the far cut; kernel "
        f"{ms:.4f} ms a call ({dev_ms:.4f} ms on the device), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {ops:.3e} ops, {bytes_moved:.3e} "
        f"bytes; {bound_every_pair_ms:.4f} ms counting the feature work on every valid pair); of {patch_pairs} valid "
        f"(8x4 patch, slot) pairs {far_patches / max(patch_pairs, 1):.3f} lie wholly beyond the far cut, "
        f"{lit_patches / max(patch_pairs, 1):.3f} have a positive alpha")
    return record, got


def camera_bwd_check(label, args, rng, width, height, zero_columns=()):
    """K3 held against its plain version on `args` with seeded cotangents
    (zero on the pixels beyond a `width` x `height` image), timed as a call
    and as device time (K3 with its d_table fill, a CUDA graph of 10 calls)."""
    from neurad_tpu_torch.ops import tile_composite as TC

    table, tile_gauss, tile_valid, pix, times = args
    t_total, p, c = tile_gauss.shape[0], pix.shape[1], table.shape[1] - TC.ATTR
    outside = (pix[..., 0] > width) | (pix[..., 1] > height)
    cots = _cotangents(rng, t_total, p, c, 2, outside if bool(outside.any()) else None)
    leaf = table.clone().requires_grad_(True)
    outs = TC.tile_composite_camera(leaf, tile_gauss, tile_valid, pix, times)
    input_bytes = (tile_gauss.numel() * 4 + tile_valid.numel() * 4 + pix.numel() * 4 + times.numel() * 4
                   + _row_bytes(table, tile_gauss, tile_valid))
    record = backward_check(
        label, leaf, outs, cots,
        lambda **kw: TC.tile_composite_camera_bwd_plain(table, tile_gauss, tile_valid, pix, times, *cots, **kw),
        int((tile_valid > 0).sum()), int((tile_valid > 0).sum()) * p, input_bytes, c, zero_columns=zero_columns)
    fwd = [x.detach() for x in outs]
    record["device_ms"] = device_ms(lambda: TC._camera_backward(*args, *fwd, *cots))
    record["channels"] = c
    log(f"[kernels] {label}: {record['device_ms']:.4f} ms on the device (the d_table fill included)")
    return record


def kernel_phase(rng):
    import torch

    from neurad_tpu_torch.ops import tile_composite as TC

    results = {}
    # --- camera (K2) ---
    args = camera_inputs(rng)
    table, tile_gauss, tile_valid, pix, times = args
    results["camera"], got = camera_fwd_check("camera", args)
    if PARENT:
        parent_k2 = lambda: PARENT["tile_composite"].tile_composite_camera(*args)
        prev = parent_k2()
        _sync()
        equal = [bool(torch.equal(a, b)) for a, b in zip(got, prev)]
        diff = [float((a - b).abs().max()) for a, b in zip(got, prev)]
        log(f"[parent] camera: this tree's outputs against the parent's, equal (feat, depth, alpha) {equal}, max abs "
            f"difference {diff}")
        results["camera"]["parent"] = dict(turns("camera composite (K2)", parent_k2,
                                                 lambda: TC.tile_composite_camera(*args)),
                                           equal=equal, max_diff=diff)
        del prev

    # --- camera backward (K3) ---
    require(bool(((pix[..., 0] > WIDTH) | (pix[..., 1] > HEIGHT)).any()), "the last tile row reaches beyond the image")
    results["camera_bwd"] = camera_bwd_check("camera backward", args, rng, WIDTH, HEIGHT)
    del args, got, table, tile_gauss, tile_valid, pix, times

    # --- lidar (K4) ---
    args = lidar_inputs(rng)
    table, tile_gauss, tile_valid, pts_slot, vmask = args
    t_total, p, k, c = tile_gauss.shape[0], pts_slot.shape[1], tile_gauss.shape[1], table.shape[1] - TC.ATTR
    eps = 0.4
    got = TC.tile_composite_lidar(*args, True, eps, True)
    _sync()
    ref = TC.tile_composite_lidar_plain(*args, True, eps, True)
    errs = [float((a - b).abs().max()) for a, b in zip(got[:4], ref[:4])]
    # the median picks the first slot whose running weight sum reaches half the
    # total; where a running sum lies within rounding of that mark, the kernel's
    # serial sum and the plain version's cumsum may pick neighbouring slots
    ambiguous = torch.zeros_like(vmask, dtype=torch.bool)
    for s, e, _g, w, _gd in TC._lidar_plain_chunks(*args, True, 128):
        acc = w.sum(-1, keepdim=True)
        cum = torch.cumsum(w, -1)
        ambiguous[s:e] = ((cum - 0.5 * acc).abs() <= 1e-5 * acc + 1e-12).any(-1) & (acc[..., 0] > 0)
    med_diff = (got[4] - ref[4]).abs()[..., 0]
    med_err = float(torch.where(ambiguous, torch.zeros_like(med_diff), med_diff).max())
    n_ambiguous = int(ambiguous.sum())
    errs.append(med_err)
    log(f"[kernels] lidar T={t_total} P={p} K={k} C={c}: valid slots {float((tile_valid > 0).float().mean()):.3f}, "
        f"valid query slots {float((vmask > 0).float().mean()):.3f}, max abs err feat/depth/acc/until/median = "
        f"{errs} ({n_ambiguous} median slots at a rounding tie excluded)")
    require(all(math.isfinite(e) for e in errs), "lidar kernel output is finite")
    require(errs[0] <= 1e-4 and errs[2] <= 1e-4 and errs[3] <= 1e-4, "lidar features/acc/until within 1e-4")
    require(errs[1] <= 1e-4 * float(ref[1].abs().max()) + 1e-4, "lidar depth within 1e-4 relative")
    require(med_err <= 1e-4 * float(ref[4].abs().max()) + 1e-4, "lidar median depth within 1e-4 relative")
    require(n_ambiguous <= 1e-3 * vmask.numel(), "few median ties")
    del ref
    k4 = lambda: TC.tile_composite_lidar(*args, True, eps, True)
    ms, dev_ms = cuda_time_ms(k4), device_ms(k4)
    plain_ms = cuda_time_ms(lambda: TC.tile_composite_lidar_plain(*args, True, eps, True), warmup=1, reps=3)
    n = _lidar_counts(*args)
    pairs, far, lit = n["pairs"], n["far_pairs"], n["lit_pairs"]
    # the least work: a valid (query, slot) pair beyond the far cut needs its quadratic form with the wrap (20
    # operations), any other valid pair its gated alpha (36), a pair whose alpha passes the gate the feature and
    # depth sums, acc, the line-of-sight and running sums and the transmittance (2 (c + 2) + 3); the median a
    # search (not counted). Bytes: the index lists and validity, vmask and every query slot's time (a masked
    # slot's median is raw slot 0's depth at that time), the rest of a valid query's point, the rows the valid
    # slots use, and the outputs of every query slot
    ops = far * 20 + (pairs - far) * 36 + lit * (2 * (c + 2) + 3)
    list_bytes = tile_gauss.numel() * 4 + tile_valid.numel() * 4 + vmask.numel() * 4
    row_bytes = _row_bytes(table, tile_gauss, tile_valid)
    bytes_moved = (list_bytes + vmask.numel() * 4 + n["queries"] * 12  # every query slot's time, the rest valid ones'
                   + row_bytes + t_total * p * (c + 4) * 4)
    bound_ms, bound_by = _bound(bytes_moved, ops)
    # the bound earlier runs reported: every query slot's point read, the alpha and sums on every valid pair
    bound_all_slots_ms, _ = _bound(bytes_moved - vmask.numel() * 4 - n["queries"] * 12 + pts_slot.numel() * 4,
                                   pairs * (39 + 2 * c))
    results["lidar"] = dict(max_abs_err=max(errs), ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, bound_all_slots_ms=bound_all_slots_ms, ops=ops, bytes=bytes_moved,
                            errs=errs, median_ties=n_ambiguous, **n)
    log(f"[kernels] lidar: {n['queries']} valid query slots of {vmask.numel()} ({n['queries'] / vmask.numel():.3f}); "
        f"of {pairs} valid (query, slot) pairs {lit / pairs:.3f} pass the alpha gate, {far / pairs:.3f} lie beyond the "
        f"far cut; of {n['warp_slots']} (warp, slot) steps {n['far_warp_slots'] / n['warp_slots']:.3f} lie wholly "
        f"beyond it, {n['lit_warp_slots'] / n['warp_slots']:.3f} have a positive alpha; kernel {ms:.4f} ms a call "
        f"({dev_ms:.4f} ms on the device), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {ops:.3e} "
        f"ops, {bytes_moved:.3e} bytes; {bound_all_slots_ms:.4f} ms with every query slot's inputs)")
    # latency or throughput: the first four tiles an SM (a block an SM, a warp a scheduler) against all of them
    few = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    part = [table] + [x[:few] for x in args[1:]]
    results["lidar"].update(few_tiles=few, few_tiles_device_ms=device_ms(
        lambda: TC.tile_composite_lidar(*part, True, eps, True)))
    log(f"[kernels] lidar: the first {few} tiles alone (a warp a scheduler) "
        f"{results['lidar']['few_tiles_device_ms']:.4f} ms on the device, all {t_total} {dev_ms:.4f} ms")
    if PARENT:
        ptc = PARENT["tile_composite"]
        parent_k4 = lambda: ptc.tile_composite_lidar(*args, True, eps, True)
        prev = parent_k4()
        _sync()
        equal = [bool(torch.equal(a, b)) for a, b in zip(got, prev)]
        diff = [float((a - b).abs().max()) for a, b in zip(got, prev)]
        log(f"[parent] lidar: this tree's outputs against the parent's, equal (feat, depth, acc, until, median) "
            f"{equal}, max abs difference {diff}")
        require(all(equal), "the lidar composite's outputs equal the parent's bit for bit")
        results["lidar"]["parent"] = dict(turns("lidar composite (K4)", parent_k4, k4), equal=equal, max_diff=diff)
        del prev

    # --- lidar backward (K5): cotangents on features, depth, accumulation and the line-of-sight sum ---
    cots = _cotangents(rng, t_total, p, c, 3)
    leaf = table.clone().requires_grad_(True)
    outs = TC.tile_composite_lidar(leaf, tile_gauss, tile_valid, pts_slot, vmask, True, eps, True)[:4]
    # the least work: the alpha of every valid pair as above, and for a pair past the gate the payload gradient
    # (2c + 4 + 2), the gradient terms (~45 + c) and the sum over the tile's queries of the 10 + c terms. Bytes:
    # the index lists, vmask, a valid query's point, forward outputs and cotangents, the rows the valid slots use,
    # the table's gradient written once
    width = table.shape[1]
    ops = far * 20 + (pairs - far) * 36 + lit * ((2 * c + 6) + 45 + c + width)
    bytes_moved = list_bytes + n["queries"] * (16 + 2 * (c + 3) * 4) + row_bytes + table.numel() * 4
    results["lidar_bwd"] = backward_check(
        "lidar backward", leaf, outs, cots,
        lambda **kw: TC.tile_composite_lidar_bwd_plain(table, tile_gauss, tile_valid, pts_slot, vmask, True, eps, *cots,
                                                       **kw),
        int((tile_valid > 0).sum()), pairs, list_bytes + pts_slot.numel() * 4 + row_bytes, c, extra_ops=2,
        least=(ops, bytes_moved))
    fwd = [x.detach() for x in outs]
    k5 = _lidar_bwd_call(TC, args, fwd, cots, eps)
    results["lidar_bwd"]["device_ms"] = device_ms(k5)
    results["lidar_bwd"]["few_tiles_device_ms"] = device_ms(
        _lidar_bwd_call(TC, part, [x[:few] for x in fwd], [x[:few] for x in cots], eps))
    log(f"[kernels] lidar backward: {results['lidar_bwd']['device_ms']:.4f} ms on the device (the d_table fill "
        f"included); the first {few} tiles alone {results['lidar_bwd']['few_tiles_device_ms']:.4f} ms")
    if PARENT:
        ptc = PARENT["tile_composite"]
        pleaf = table.clone().requires_grad_(True)
        pouts = ptc.tile_composite_lidar(pleaf, tile_gauss, tile_valid, pts_slot, vmask, True, eps, True)[:4]
        (prev,) = torch.autograd.grad(pouts, pleaf, cots)
        (mine,) = torch.autograd.grad(outs, leaf, cots)
        mag = TC.tile_composite_lidar_bwd_plain(table, tile_gauss, tile_valid, pts_slot, vmask, True, eps, *cots,
                                                magnitude=True)
        to_mag = float(((mine - prev).abs() / mag.clamp_min(1e-30)).max())
        log(f"[parent] lidar backward: this tree's gradient against the parent's, largest difference over an "
            f"entry's terms' magnitude {to_mag:.2e}")
        require(to_mag <= BWD_TOL, f"the lidar backward within {BWD_TOL} of the parent's")
        results["lidar_bwd"]["parent"] = dict(turns("lidar backward (K5)", _lidar_bwd_call(ptc, args, fwd, cots, eps),
                                                    k5), err_over_term_sum=to_mag)
        del prev, mine, mag, pouts
    return results


def _lidar_bwd_call(tc, args, outs, cots, eps):
    """One call of a checkout's lidar backward through its module's wrapper
    (`_lidar_backward`: K5 and the zero-fill of d_table), given the forward's
    outputs where that backward takes them."""
    import inspect

    if "feat" in inspect.signature(tc._lidar_backward).parameters:
        return lambda: tc._lidar_backward(*args, *outs, True, eps, *cots)
    return lambda: tc._lidar_backward(*args, True, eps, *cots)


def _lidar_counts(table, tile_gauss, tile_valid, pts_slot, vmask, tile_chunk=128):
    """By the plain version's alpha terms, over the lidar composite's valid
    (query, slot) pairs (valid query slot, valid gaussian slot): all of them,
    those whose gated alpha is positive and those beyond the far cut
    (sigma_raw > 5.6 of a slot whose opacity is at most 1); over the (tile,
    valid slot) steps of tiles with a valid query (a warp's in K4 and K5 where
    a tile holds at most 32), those whose queries all lie beyond the far cut
    and those with a positive alpha somewhere; and the valid query slots."""
    from neurad_tpu_torch.ops import tile_composite as TC

    n = dict(queries=int((vmask > 0).sum()), pairs=0, lit_pairs=0, far_pairs=0, warp_slots=0, far_warp_slots=0,
             lit_warp_slots=0)
    for s in range(0, pts_slot.shape[0], tile_chunk):
        e = min(pts_slot.shape[0], s + tile_chunk)
        valid, on = tile_valid[s:e] > 0, vmask[s:e] > 0
        g = TC._gather(table, tile_gauss[s:e])
        pts = pts_slot[s:e]
        terms = TC._alpha_terms(g, valid, pts[..., 0:1], pts[..., 1:2], pts[..., 3:4], True)
        pair = valid[:, None, :] & on[:, :, None]
        lit = (terms[5] > 0) & pair
        far = (terms[2] > 5.6) & (g[..., 7] <= 1.0)[:, None, :] & pair
        n["pairs"] += int(pair.sum())
        n["lit_pairs"] += int(lit.sum())
        n["far_pairs"] += int(far.sum())
        steps = valid & on.any(1, keepdim=True)
        n["warp_slots"] += int(steps.sum())
        n["far_warp_slots"] += int(((far | ~on[:, :, None]).all(1) & steps).sum())
        n["lit_warp_slots"] += int((lit.any(1) & steps).sum())
    return n


def ptxas_report():
    """ptxas's report of every kernel instantiation, from the build logs in
    `_build/<library>.log`: [{library, kernel (name<template arguments>),
    registers, stack, spill_stores, spill_loads, smem}] (smem: static shared
    memory; dynamic shared memory is set at the launch)."""
    import re

    from neurad_tpu_torch.ops import _build

    rows = []
    for lib in sorted(_build.LIBRARIES):
        path = _build.BUILD_DIR / f"{lib}.log"
        if not path.exists():
            continue
        cur = None
        for line in path.read_text().splitlines():
            m = re.search(r"Compiling entry function '\w*?_cu_[0-9a-f]{8}(\d+)(\w+)'", line)
            if m:
                name, rest = m[2][:int(m[1])], m[2][int(m[1]):]
                targs = rest.split("EEv")[0] if rest.startswith("I") else ""
                args = re.findall(r"L[ib](\d+)E", targs + "E")
                if "__nv_bfloat16" in targs:  # a type argument: the table's element type
                    args.append("bf16")
                elif targs.endswith("Ef"):
                    args.append("float")
                cur = dict(library=lib, kernel=f"{name}<{','.join(args)}>" if args else name)
                rows.append(cur)
            elif cur is not None:
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    cur.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    smem = re.search(r"(\d+) bytes smem", line)
                    cur.update(registers=int(m[1]), smem=int(smem[1]) if smem else 0)
    return rows


# the lookup's read modes: (name, bf16 reads, from the bf16 copy). A serving state's lookups read the copy; a
# train step's (under autograd) round the fp32 master at the read, as the lookup without copies does.
HASH_MODES = (("bf16", True, True), ("bf16_master", True, False), ("fp32", False, False))


def _hash_grid_case(label, settings, d, pos, std, gen, results, modes=HASH_MODES):
    """One full-width lookup through `hash_grid_encode` without autograd: the
    grid of `settings` with random O(1) tables, the given positions and stds,
    kernel against plain (must be equal) in each read mode, times (beside the
    parent's in turns with `--parent`, through its own `hash_grid_encode`), and
    the bytes bound from the rows these positions touch, in the bytes of the
    mode's read type; the bf16 copy's conversion is timed apart."""
    import torch

    from neurad_tpu_torch.fields.neurad_encoding import HashGrid
    from neurad_tpu_torch.ops import hash_encoding as HE

    grid = HashGrid(settings, d)
    tables = HE.init_hash_tables(gen, grid.scales, d, grid.table_size, grid.features, scale=1.0,
                                 cell_packed=grid.cell_packed, force_hash=grid.force_hash)
    scales = [float(s) for s in grid.scales]
    buckets = [t.shape[0] * pk for t, pk in zip(tables, grid.pack)]
    n, f, n_levels = pos.shape[0], grid.features, len(tables)
    row_values = (2**d if grid.cell_packed else 1) * f
    touched = sum(int(torch.unique(HE.level_index(pos, s, b, r, grid.cell_packed)[0]).numel())
                  for s, b, r in zip(scales, buckets, grid.dense_res))
    reads = n * n_levels * (1 if grid.cell_packed else 2**d)
    ops = n * n_levels * ((2**d) * (d + 2 * f) + 6 * d + 8)
    log(f"[kernels] {label}: N={n} L={n_levels} D={d} F={f} cell_packed={grid.cell_packed}, tables "
        f"{[tuple(t.shape) for t in tables]} ({sum(t.numel() for t in tables) * 4 / 2**20:.0f} MiB), "
        f"{touched} of {reads} row reads are distinct rows")
    for mode, read_bf16, from_copy in modes:
        layout = (scales, buckets, grid.dense_res, f, read_bf16, grid.cell_packed)
        copies = HE.Bf16Copies() if from_copy else None

        @torch.no_grad()
        def lookup():
            return HE.hash_grid_encode(pos, std, tables, *layout, copies=copies)

        before = HE.hash_grid_launches
        got = lookup()
        _sync()
        require(DEVICE == "cpu" or HE.hash_grid_launches == before + 1, f"{label}: the wrapper launched its kernel")
        want = HE.hash_grid_encode_plain(pos, std, tables, *layout)
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0.1, f"{label}: finite, non-trivial output")
        require(torch.equal(got, want), f"{label} ({mode} reads): kernel equals the plain version on the fp32 master bit "
                                        f"for bit (max abs err {err:.3e})")
        ms = cuda_time_ms(lookup)
        dev_ms = device_ms(lookup)
        plain_ms = cuda_time_ms(lambda: HE.hash_grid_encode_plain(pos, std, tables, *layout), warmup=1, reps=3)
        # positions, stds and output once, each distinct row once in the bytes of the type the kernel reads
        bytes_moved = touched * row_values * (2 if from_copy else 4) + (pos.numel() + std.numel() + n * n_levels * f) * 4
        bound_ms, bound_by = _bound(bytes_moved, ops)
        key = f"{label}_{mode}"
        results[key] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, n=n,
                            levels=n_levels, bytes=bytes_moved, ops=ops, distinct_rows=touched, row_reads=reads)
        note = ""
        if from_copy:
            results[key]["copy_ms"] = cuda_time_ms(lambda: [t.to(torch.bfloat16) for t in tables])
            note = f"; the tables' bf16 conversion {results[key]['copy_ms']:.4f} ms, apart"
        log(f"[kernels] {key}: equal to the plain version; kernel {ms:.4f} ms a call ({dev_ms:.4f} ms on the device), plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {bytes_moved:.3e} bytes, {ops:.3e} ops){note}")
        if PARENT:
            parent_k1f = torch.no_grad()(lambda: PARENT["hash_encoding"].hash_grid_encode(pos, std, tables, *layout))
            require(torch.equal(parent_k1f(), got), f"{key}: the parent's kernel gives the same bits")
            results[key]["parent"] = turns(f"lookup (K1f) {key}", parent_k1f, lookup)
        del got, want, copies


def hash_grid_phase(outputs, rng):
    """K1 forward at the NeuRAD field's full width: the static grid on a
    serving chunk's N = NEURAD_CHUNK * NEURAD_SAMPLES positions drawn uniformly
    and ray-ordered (an approximation of a serving chunk: rays through random
    pixels of the scene's cameras, samples spread over 1-80 m, where a render
    chunk's rays are neighbours and its samples the proposal's; the profiled
    NeuRAD request measures the path itself), on a train chunk's ray-ordered
    positions (where a train step's lookup runs), the actor grid (D = 4),
    the unpacked layout of `neurad-parity` and that preset's two F = 1
    proposal grids (`_proposal_round_inputs`)."""
    import torch

    from neurad_tpu_torch.fields.neurad_encoding import ActorSettings, StaticSettings

    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    results = {}
    n_static = NEURAD_CHUNK * NEURAD_SAMPLES
    pos = torch.rand((n_static, 3), generator=gen, device=DEVICE)
    std = torch.rand((n_static,), generator=gen, device=DEVICE) * 2e-3  # the finest levels get a weight below 1
    _hash_grid_case("hash_grid_static", StaticSettings(), 3, pos, std, gen, results)
    pos, std = _train_chunk_gaussians(outputs, gen, NEURAD_CHUNK)
    _hash_grid_case("hash_grid_static_rays", StaticSettings(), 3, pos, std, gen, results)
    _hash_grid_case("hash_grid_unpacked_rays", StaticSettings(cell_packed=False, parity=True), 3, pos, std, gen,
                    results, modes=HASH_MODES[2:])
    train_pos, train_std = _train_chunk_gaussians(outputs, gen, K1B_RAYS)
    _hash_grid_case("hash_grid_static_train_chunk", StaticSettings(), 3, train_pos, train_std, gen, results,
                    modes=HASH_MODES[:2])
    n_actor = n_static // 8
    pos4 = torch.rand((n_actor, 4), generator=gen, device=DEVICE)
    _hash_grid_case("hash_grid_actor", ActorSettings(flip_prob=0.25), 4, pos4, std[:n_actor].contiguous(), gen, results)
    prop, prop_actor, pos, std, pos4 = _proposal_round_inputs(outputs, gen)
    _hash_grid_case("hash_grid_parity_proposal", prop, 3, pos, std, gen, results, modes=HASH_MODES[2:])
    _hash_grid_case("hash_grid_parity_actor_proposal", prop_actor, 4, pos4, std[:pos4.shape[0]].contiguous(), gen,
                    results, modes=HASH_MODES[2:])
    return results


def _proposal_round_inputs(outputs, gen):
    """The `neurad-parity` preset's proposal grids (D = 3: 6 levels of 2^20,
    base 128, max 4096; D = 4: 4 levels of 2^15; F = 1, hashed, unpacked,
    fp32 reads) and the first proposal round's lookup inputs in a train chunk:
    8,192 rays x 128 samples from the scene's cameras, and the compacted
    actor lookup's capacity (an eighth of them) inside actor 0's box ->
    (static settings, actor settings, positions [N, 3], stds [N], positions
    [N / 8, 4])."""
    import torch

    from neurad_tpu_torch.configs.method_configs import METHODS

    over = METHODS["neurad-parity"]().pipeline.model_overrides
    samples = over["sampling"].num_proposal_samples[0]
    pos, std = _train_chunk_gaussians(outputs, gen, K1B_RAYS, samples)
    n_actor = pos.shape[0] // 8
    pos4 = torch.cat([0.35 + 0.3 * torch.rand((n_actor, 3), generator=gen, device=DEVICE),
                      torch.zeros((n_actor, 1), device=DEVICE)], dim=-1)
    return over["proposal_static"][0], over["proposal_actor"], pos, std, pos4


def _train_chunk_gaussians(outputs, gen, n_rays=K1B_RAYS, samples=K1B_SAMPLES):
    """The static field's lookup inputs in one chunk of rays (a train chunk's
    K1B_RAYS by default): rays through random pixels of the scene's cameras,
    `samples` each (the field's K1B_SAMPLES by default) spread over 1-80 m,
    ray-major, contracted into the grid's [0, 1]^3 with their cone radii as
    stds -> (positions [N, 3], stds [N])."""
    import math

    import torch

    from neurad_tpu_torch.cameras.cameras import generate_rays
    from neurad_tpu_torch.core.structs import GaussiansStd
    from neurad_tpu_torch.fields.spatial_distortions import scaled_scene_contraction_gaussian

    n = n_rays
    hw = torch.tensor([HEIGHT, WIDTH], dtype=torch.float32, device=DEVICE)
    idx = torch.randint(0, len(outputs.images), (n,), generator=gen, device=DEVICE)
    bundle = generate_rays(outputs.cameras, idx, torch.rand((n, 2), generator=gen, device=DEVICE) * hw)
    t = torch.exp(torch.rand((n, samples), generator=gen, device=DEVICE) * math.log(80.0)).sort(dim=-1).values
    mean = bundle.origins[:, None, :] + bundle.directions[:, None, :] * t[..., None]
    std = torch.sqrt(bundle.pixel_area * 9.0) * t  # a camera ray covers upsample^2 = 9 pixels
    scale = float(outputs.scene_box.aabb.abs().max())
    g = scaled_scene_contraction_gaussian(GaussiansStd(mean=mean.reshape(-1, 1, 3), std=std.reshape(-1, 1, 1)), scale)
    return g.mean.reshape(-1, 3).contiguous(), g.std.reshape(-1).contiguous()


def _hash_grid_bwd_case(label, settings, d, pos, std, gen, results, modes=(True, False)):
    """K1b at one full-width lookup: the grid of `settings` with random O(1)
    tables, the given positions and stds, a random output gradient; kernel
    against the plain backward per entry (BWD_TOL of the sum of the absolute
    values of the entry's terms), two launches against each other, times, the
    zero-fill of the table gradient apart, and the bound."""
    import torch

    from neurad_tpu_torch.fields.neurad_encoding import HashGrid
    from neurad_tpu_torch.ops import hash_encoding as HE

    grid = HashGrid(settings, d)
    tables = HE.init_hash_tables(gen, grid.scales, d, grid.table_size, grid.features, scale=1.0,
                                 cell_packed=grid.cell_packed, force_hash=grid.force_hash)
    scales = [float(s) for s in grid.scales]
    buckets = [t.shape[0] * pk for t, pk in zip(tables, grid.pack)]
    n, f, n_levels = pos.shape[0], grid.features, len(tables)
    g = torch.randn((n, n_levels * f), generator=gen, device=DEVICE)
    c = 2**d
    row_bytes = (c if grid.cell_packed else 1) * f * 4
    touched = sum(int(torch.unique(HE.level_index(pos, s, b, r, grid.cell_packed)[0]).numel())
                  for s, b, r in zip(scales, buckets, grid.dense_res))
    table_bytes = sum(t.numel() for t in tables) * 4
    # inputs read once (positions, stds, g, the rows the position gradient needs), outputs written once (the
    # dense table gradient, positions' and stds' gradients)
    bytes_moved = 2 * (pos.numel() + std.numel()) * 4 + g.numel() * 4 + touched * row_bytes + table_bytes
    ops = n * n_levels * (c * (2 * d + 4 * f) + 2 * d * c + 20)
    bound_ms, bound_by = _bound(bytes_moved, ops)
    log(f"[k1b] {label}: N={n} L={n_levels} D={d} F={f} cell_packed={grid.cell_packed}, tables "
        f"{table_bytes / 2**20:.0f} MiB, {touched} distinct rows read for the position gradient")
    for read_bf16 in modes:
        layout = (scales, buckets, grid.dense_res, f, read_bf16, grid.cell_packed)
        before = HE.hash_grid_bwd_launches
        got = HE.hash_grid_encode_bwd(pos, std, tables, *layout, g)
        again = HE.hash_grid_encode_bwd(pos, std, tables, *layout, g)
        _sync()
        require(DEVICE == "cpu" or HE.hash_grid_bwd_launches == before + 2, f"{label}: the wrapper launched K1b")
        want = HE.hash_grid_encode_bwd_plain(pos, std, tables, *layout, g)
        mag = HE.hash_grid_encode_bwd_plain(pos, std, tables, *layout, g, magnitude=True)
        errs, runs, abs_err = [], [], 0.0
        for a, b, w, m in zip(list(got[0]) + [got[1], got[2]], list(again[0]) + [again[1], again[2]],
                              list(want[0]) + [want[1], want[2]], list(mag[0]) + [mag[1], mag[2]]):
            errs.append(float(((a - w).abs() / (m + 1e-30)).max()))
            runs.append(float(((a - b).abs() / (m + 1e-30)).max()))
            abs_err = max(abs_err, float((a - w).abs().max()))
        err, run_diff = max(errs), max(runs)
        mode = "bf16" if read_bf16 else "fp32"
        require(all(bool(torch.isfinite(t).all()) for t in list(got[0]) + [got[1], got[2]]), f"{label}: finite")
        require(float(got[1].abs().max()) > 0 and all(float(t.abs().max()) > 0 for t in got[0]),
                f"{label}: non-trivial gradients")
        require(err <= BWD_TOL, f"{label} ({mode}): K1b matches the plain backward to {BWD_TOL:g} of the terms' "
                                f"magnitude (got {err:.3e})")
        ms = cuda_time_ms(lambda: HE.hash_grid_encode_bwd(pos, std, tables, *layout, g))
        dev_ms = device_ms(lambda: HE.hash_grid_encode_bwd(pos, std, tables, *layout, g))
        zero_ms = cuda_time_ms(lambda: [torch.zeros_like(t) for t in tables])
        plain_ms = cuda_time_ms(lambda: HE.hash_grid_encode_bwd_plain(pos, std, tables, *layout, g), warmup=1, reps=3)
        key = f"{label}_{mode}"
        results[key] = dict(max_abs_err=abs_err, max_rel_err=err, run_to_run=run_diff, ms=ms, device_ms=dev_ms,
                            zero_fill_ms=zero_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, n=n, levels=n_levels,
                            bytes=bytes_moved, ops=ops, distinct_rows=touched, table_mib=table_bytes / 2**20)
        log(f"[k1b] {key}: error {err:.2e} of the terms' magnitude (two launches differ by {run_diff:.2e}); "
            f"K1b with its zero-filled gradient {ms:.4f} ms a call, {dev_ms:.4f} ms on the device (the zero-fill "
            f"alone {zero_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {bytes_moved:.3e} bytes, {ops:.3e} ops)")
        del got, again, want, mag


def hash_grid_bwd_phase(outputs, rng):
    """K1b at a train chunk's full width: the `neurad` preset's static grid on
    positions from the scene's cameras (bf16 and fp32 reads) and on as many
    positions in one cell of its coarsest level (bf16: every update of a
    level lands on one row), its actor grid (N = the compacted lookup's
    capacity, D = 4), the unpacked layout of `neurad-parity` (fp32
    reads), and that preset's two F = 1 proposal grids at the forward's
    shapes."""
    import torch

    from neurad_tpu_torch.fields.neurad_encoding import ActorSettings, HashGrid, StaticSettings

    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    pos, std = _train_chunk_gaussians(outputs, gen)
    require(bool(((pos >= 0) & (pos <= 1)).all()), "contracted positions lie in [0, 1]^3")
    results = {}
    _hash_grid_bwd_case("hash_grid_bwd_static", StaticSettings(), 3, pos, std, gen, results)
    scale0 = float(HashGrid(StaticSettings(), 3).scales[0])
    cell = torch.randint(0, int(scale0), (3,), generator=gen, device=DEVICE)
    hot = (cell + torch.rand(pos.shape, generator=gen, device=DEVICE)) / scale0
    _hash_grid_bwd_case("hash_grid_bwd_hot_cell", StaticSettings(), 3, hot, std, gen, results, modes=(True,))
    n_actor = pos.shape[0] // 8
    pos4 = torch.cat([0.35 + 0.3 * torch.rand((n_actor, 3), generator=gen, device=DEVICE),
                      torch.zeros((n_actor, 1), device=DEVICE)], dim=-1)  # inside an actor's box, actor 0
    _hash_grid_bwd_case("hash_grid_bwd_actor", ActorSettings(flip_prob=0.25), 4, pos4, std[:n_actor].contiguous(),
                        gen, results)
    _hash_grid_bwd_case("hash_grid_bwd_unpacked", StaticSettings(cell_packed=False, parity=True), 3, pos, std, gen,
                        results, modes=(False,))
    prop, prop_actor, pos, std, pos4 = _proposal_round_inputs(outputs, gen)
    _hash_grid_bwd_case("hash_grid_bwd_parity_proposal", prop, 3, pos, std, gen, results, modes=(False,))
    _hash_grid_bwd_case("hash_grid_bwd_parity_actor_proposal", prop_actor, 4, pos4, std[:pos4.shape[0]].contiguous(),
                        gen, results, modes=(False,))
    return results


def probe_phase():
    """The gather and scatter-add probes through their own entry point: every
    table shape, and the scatter-adds on skewed indices at GM.SKEWED_SHAPE,
    each kernel against its plain version (the run raises on any difference
    beyond the scatter-adds' SCATTER_TOL, and on a one-hot scatter that gives
    other bits on a second launch), times beside torch.index_select and
    index_add_, the bucketed probes' scratch. The counts are read around this
    one run; then the bucketed probes' device time by kernel
    (`GM.profile_bucketed`)."""
    from neurad_tpu_torch.benchmarks import gather_microbench as GM

    GM.reset_launch_counts()
    records = GM.entrypoint(["--device", DEVICE])
    launches = {"coalesced": GM.coalesced_launches, "onehot": GM.onehot_launches, "serial": GM.serial_launches,
                "scatter_onehot": GM.scatter_onehot_launches, "scatter_blocked": GM.scatter_blocked_launches,
                "scatter_serial": GM.scatter_serial_launches}
    log(f"[gather] kernel launches in the run: {launches}")
    gathers = [r for r in records if not r["name"].startswith("scatter_")]
    scatters = [r for r in records if r["name"].startswith("scatter_")]
    require(all(r["max_abs_err"] == 0.0 for r in gathers), "every gather probe equals table[idx]")
    require(all(r["max_rel_err"] <= GM.SCATTER_TOL for r in scatters), "every scatter-add probe matches index_add_")
    names = {(r["name"], r["T"], r["F"]) for r in records}
    require(names >= {(n, t, f) for t, f in GM.TABLE_SHAPES
                      for n in ("coalesced", "serial", "scatter_blocked", "scatter_serial")},
            "the copies and the atomic scatter-adds ran at every table shape")
    require(names >= {(n, t, f) for t, f in GM.TABLE_SHAPES for n in ("onehot", "scatter_onehot")},
            "the bucketed one-hot products ran at every table shape")
    require({(r["name"], r["skew"]) for r in scatters if (r["T"], r["F"]) == GM.SKEWED_SHAPE} ==
            {(n, s) for n in ("scatter_onehot", "scatter_blocked", "scatter_serial") for s in ("uniform", "hot")},
            "the three scatter-adds ran on uniform and on skewed indices at (131072, 32)")
    require(all(r["relaunch_equal"] for r in scatters if r["name"] == "scatter_onehot" and (r["T"], r["F"]) ==
                GM.SKEWED_SHAPE), "the one-hot scatter gave the same bits on a second launch at (131072, 32), "
            "uniform and skewed")
    for r in records:
        if r["name"] in ("onehot", "scatter_onehot"):
            log(f"[gather] {r['name']} T={r['T']} F={r['F']} ({r['skew']} indices): the bucketing pass's scratch "
                f"{r['scratch_bytes']} bytes")
    # after the counts: where a bucketed probe's time goes, kernel by kernel
    return dict(records=records, launches=launches, bucketed_profile=GM.profile_bucketed(DEVICE, log=log),
                parent=_parent_gathers(GM))


def _parent_gathers(GM):
    """`--parent`: the parent checkout's coalesced and serial gathers (P1,
    P5) and this tree's on the same inputs at every table shape, outputs
    bit for bit, then timed in turns (call and device time)."""
    import torch

    if "gather_microbench" not in PARENT:
        return {}
    PGM = PARENT["gather_microbench"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    for t_rows, f in GM.TABLE_SHAPES:
        table = torch.randn((t_rows, f), generator=gen, device=DEVICE).to(torch.bfloat16)
        idx = torch.randint(0, t_rows, (GM.NUM_QUERIES,), generator=gen, device=DEVICE, dtype=torch.int32)
        for key in ("coalesced", "serial"):
            ours, theirs = getattr(GM, f"gather_rows_{key}"), getattr(PGM, f"gather_rows_{key}")
            require(torch.equal(ours(table, idx), theirs(table, idx)),
                    f"the {key} gather equals the parent's at T={t_rows}, F={f}")
            out[f"{key}_{t_rows}x{f}"] = turns(f"{key} gather T={t_rows} F={f}",
                                               lambda fn=theirs: fn(table, idx), lambda fn=ours: fn(table, idx))
    return out


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def slice_phase():
    import numpy as np
    import torch

    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.models.splatad import BACKGROUND
    from neurad_tpu_torch.ops import tile_composite as TC
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig
    from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState, make_handler
    from http.server import ThreadingHTTPServer

    w, h = WIDTH, HEIGHT
    t0 = time.perf_counter()
    outputs = SyntheticDataParserConfig(**SCENE).setup().get_dataparser_outputs()
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipeline = SplatADPipeline(outputs, SplatADPipelineConfig(cap_max=N_GAUSS, seed=SEED), device=DEVICE)
    _sync()
    t_pipe = time.perf_counter() - t0
    log(f"[slice] synthetic scene {t_data:.1f} s, pipeline ({pipeline.model.means.shape[0]} gaussians) {t_pipe:.1f} s")
    require(pipeline.model.means.shape[0] == N_GAUSS, "500,000 gaussians")

    state = ClosedLoopState(pipeline, device=DEVICE)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    requests = []
    try:
        start_time = _get(url + "/start_time")["start_time"]
        actors = _get(url + "/get_actors")["actors"]
        require(len(actors) == 1, "one actor served by /get_actors")
        c2w_all = outputs.cameras.camera_to_worlds.numpy()
        times = outputs.cameras.times[:, 0].numpy()
        TC.reset_launch_counts()
        for i, lateral in enumerate((0.0, 1.5)):
            pose = np.eye(4, dtype=np.float32)
            pose[:3] = c2w_all[i]
            pose[:3, 3] += pose[:3, 0] * lateral  # lane shift along the camera's right axis
            t_req = time.perf_counter()
            resp = _post(url + "/render_image", {"pose": pose.tolist(), "timestamp": float(times[i]) + 0.1 * i,
                                                  "camera_name": "front_camera"})
            round_trip = time.perf_counter() - t_req
            img = np.asarray(resp["image"], dtype=np.float32)
            render_s = state.last_render_seconds
            log(f"[slice] /render_image {i}: render {render_s * 1e3:.1f} ms (synchronised, incl. copy to host), "
                f"HTTP+JSON round trip {round_trip:.2f} s")
            require(img.shape == (h, w, 3), f"image shape {img.shape}")
            require(bool(np.isfinite(img).all()), "image finite")
            require(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, "image in [0, 1]")
            off_background = float((np.abs(img - np.asarray(BACKGROUND, np.float32)).max(-1) > 1e-3).mean())
            require(off_background > 0.05, f"image not all background ({off_background:.3f} of pixels differ)")
            requests.append(dict(render_ms=render_s * 1e3, round_trip_s=round_trip, off_background=off_background))
        # further warm requests at the second pose, through the server state without the JSON round trip: two
        # from this thread, two from one new thread (the server gives every request a thread of its own, so
        # what it answers is a thread's first render), one more from this thread
        warm_ms = []

        def render(count=1):
            for _ in range(count):
                state.render_image(pose.tolist(), float(times[1]) + 0.1, "front_camera")
                warm_ms.append(state.last_render_seconds * 1e3)

        render(2)
        worker = threading.Thread(target=render, args=(2,))
        worker.start()
        worker.join()
        render()
        log(f"[slice] five more warm requests without HTTP: render {', '.join(f'{t:.1f}' for t in warm_ms)} ms "
            f"(the third and fourth are a new thread's first and second)")
        scan = 0
        lidar_times = []
        for _ in range(3):  # the process's first scan apart from two warm ones
            _sync()
            t_l = time.perf_counter()
            lid = pipeline.render_eval_lidar(scan)
            lidar_times.append((time.perf_counter() - t_l) * 1e3)
        lidar_s = lidar_times[1] * 1e-3
        launches = {"camera": TC.camera_launches, "lidar": TC.lidar_launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    n_pts = int(outputs.point_clouds[scan].shape[0])
    log(f"[slice] lidar scan: {n_pts} returns of {LIDAR_BEAMS[0] * LIDAR_BEAMS[1]} beams, {lid['depth'].shape[0]} query points, "
        f"render cold {lidar_times[0]:.1f} ms, warm {lidar_times[1]:.1f} and {lidar_times[2]:.1f} ms (synchronised, "
        f"incl. copy to host)")
    for key in ("depth", "intensity", "ray_drop_logits"):
        require(bool(np.isfinite(lid[key]).all()), f"lidar {key} finite")
    log(f"[slice] kernel launches on the serving path: {launches}")
    require(launches["camera"] >= 2, "camera kernel launched for every request")
    require(launches["lidar"] >= 3, "lidar kernel launched for every scan")
    profile = {
        "camera": profiled("camera request", lambda: state.render_image(pose.tolist(), float(times[1]), "front_camera"),
                           match=CAMERA_KERNEL),
        "lidar": profiled("lidar scan", lambda: pipeline.render_eval_lidar(scan), match=LIDAR_KERNEL),
    }
    log(f"[slice] profiled camera request: the camera composite {profile['camera']['matched_ms']:.3f} ms in "
        f"{profile['camera']['matched_launches']} launch(es); profiled warm lidar scan: the lidar composite "
        f"{profile['lidar']['matched_ms']:.3f} ms in {profile['lidar']['matched_launches']} launch(es)")
    require(profile["camera"]["matched_launches"] == 1, "the profiled request launched the camera composite once")
    require(profile["lidar"]["matched_launches"] == 1, "the profiled scan launched the lidar composite once")

    # one camera train step with the default configuration: the coarse-to-fine schedule starts at a quarter
    # of the resolution
    sample = pipeline.datamanager._camera_sample(pipeline.datamanager.train_cams[0])
    tstate, metrics = pipeline.train_step(pipeline.init_state(), sample)
    _sync()
    coarse = pipeline._downscale_sample(sample, 0)
    log(f"[slice] one camera train step at the default schedule's first resolution {coarse.width}x{coarse.height}: "
        f"total loss {float(metrics['total_loss']):.4f}, psnr {float(metrics['psnr']):.2f}")
    require((coarse.width, coarse.height) == (w // 4, h // 4), "default schedule starts at a quarter resolution")
    require(math.isfinite(float(metrics["total_loss"])) and tstate.step == 1, "coarse train step finite")
    return dict(requests=requests, warm_render_ms=warm_ms, lidar_ms=lidar_s * 1e3, lidar_cold_ms=lidar_times[0], lidar_warm_ms=lidar_times[1:],
                lidar_returns=n_pts, launches=launches,
                start_time=start_time, scene_s=t_data, pipeline_s=t_pipe, profile=profile,
                coarse_step=dict(width=coarse.width, height=coarse.height, total_loss=float(metrics["total_loss"]))), outputs


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------


def train_phase(outputs):
    """SplatAD training at full width through the pipeline's entry points; its
    run directory (in RUNS) serves the render, export and viewer phases."""
    import numpy as np
    import torch

    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.data.full_image_datamanager import CameraSample
    from neurad_tpu_torch.model_components.strategy import MCMCStrategyConfig, should_refine
    from neurad_tpu_torch.models.splatad import SplatADConfig
    from neurad_tpu_torch.ops import tile_composite as TC
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig
    from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState
    from neurad_tpu_torch.scripts.train import write_run_config

    cfg = SplatADPipelineConfig(
        cap_max=N_GAUSS, seed=SEED, model=SplatADConfig(num_downscales=0),
        mcmc=MCMCStrategyConfig(cap_max=N_GAUSS, refine_start_iter=1, refine_every=3),
    )
    pipeline = SplatADPipeline(outputs, cfg, device=DEVICE)
    state = pipeline.init_state()
    model = pipeline.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()

    steps = {"camera": [], "lidar": []}
    by_frame = {}
    refines = 0
    TC.reset_launch_counts()
    while min(len(v) for v in steps.values()) < MIN_STEPS_PER_KIND:
        require(state.step < 40, "both kinds of sample drawn within 40 steps")
        sample = pipeline.datamanager.next_train()
        kind = "camera" if isinstance(sample, CameraSample) else "lidar"
        _sync()
        t0 = time.perf_counter()
        state, metrics = pipeline.train_step(state, sample)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        refined = should_refine(state.step, cfg.mcmc)
        refines += refined
        loss = float(metrics["total_loss"])
        require(math.isfinite(loss), f"step {state.step} loss finite")
        steps[kind].append(dict(step=state.step, ms=ms, refined=bool(refined), total_loss=loss))
        if kind == "camera":
            require((sample.width, sample.height) == (WIDTH, HEIGHT), "camera steps run at full resolution")
            by_frame.setdefault(sample.cam_idx, []).append(float(metrics["main_loss"]))
            detail = f"frame {sample.cam_idx} main_loss {float(metrics['main_loss']):.5f} psnr {float(metrics['psnr']):.2f}"
        else:
            detail = (f"scan {sample.scan_idx} depth_loss {float(metrics['depth_loss']):.4f} "
                      f"overflowed points {int(metrics['points_overflowed'])}")
        log(f"[train] step {state.step} {kind}: {ms:.1f} ms (synchronised{', incl. a refine' if refined else ''}), "
            f"total loss {loss:.5f}, {detail}")
    launches = {"camera": TC.camera_launches, "lidar": TC.lidar_launches, "camera_bwd": TC.camera_bwd_launches,
                "lidar_bwd": TC.lidar_bwd_launches}
    n_cam, n_lid = len(steps["camera"]), len(steps["lidar"])
    log(f"[train] {n_cam} camera steps, {n_lid} lidar steps, {refines} refines; kernel launches {launches}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(launches == {"camera": n_cam, "lidar": n_lid, "camera_bwd": n_cam, "lidar_bwd": n_lid},
            "every step launched its forward and its backward kernel once")
    require(refines >= 1, "at least one MCMC refine")
    repeated = {k: v for k, v in by_frame.items() if len(v) >= 2}
    require(bool(repeated), "a camera frame was drawn twice")
    require(all(v[-1] < v[0] for v in repeated.values()), f"main loss of every repeated frame falls: {repeated}")

    moved = {}
    for name, p in model.named_parameters():
        group = state.optimizers.labels[name]
        moved[group] = max(moved.get(group, 0.0), float((p.detach() - before[name]).abs().max()))
        require(bool(torch.isfinite(p).all()), f"{name} finite after training")
    log(f"[train] largest parameter change by group: {moved}")
    require(all(v > 0 for v in moved.values()), "every parameter group moved")

    cam_sample = pipeline.datamanager._camera_sample(pipeline.datamanager.train_cams[0])
    lid_sample = pipeline.datamanager._lidar_sample(pipeline.datamanager.train_lidars[0])
    profile = {}
    for kind, sample in (("camera", cam_sample), ("lidar", lid_sample)):
        while should_refine(state.step + 1, cfg.mcmc):  # keep the refine out of the profiled step
            state, _ = pipeline.train_step(state, sample)
        bwd_kernel = f"{kind}_bwd_kernel"
        profile[kind] = profiled(f"{kind} train step", lambda: pipeline.train_step(state, sample), rows=22,
                                 match=bwd_kernel)
        fwd_kernel = f"{kind}_fwd_kernel"
        profile[kind]["fwd_ms"] = sum(ms for name, ms, _ in profile[kind]["all"] if fwd_kernel in name)
        log(f"[train] profiled {kind} step: {bwd_kernel} {profile[kind]['matched_ms']:.3f} ms in "
            f"{profile[kind]['matched_launches']} launch(es), {fwd_kernel} {profile[kind]['fwd_ms']:.3f} ms, of "
            f"{profile[kind]['device_busy_ms']:.2f} ms busy")
        require(profile[kind]["matched_launches"] == 1, f"the profiled {kind} step launched its backward kernel once")

    evaluated = eval_metrics_check("splatad", pipeline, SPLATAD_EVAL_KEYS, {"camera": 1, "lidar": 1})

    run_dir = write_run_config(RUNS / "splatad", "splatad", SyntheticDataParserConfig(**SCENE), cfg, SEED)
    ckpt = pipeline.save_checkpoint(state, run_dir / "checkpoints")
    size_mb = ckpt.stat().st_size / 2**20
    step = state.step
    del pipeline, state, before
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served = ClosedLoopState.from_run_dir(run_dir, device=DEVICE)
    load_s = time.perf_counter() - t0
    evaluated["script"] = eval_script_check(run_dir, step, SPLATAD_EVAL_KEYS)
    pose = np.eye(4, dtype=np.float32)
    pose[:3] = outputs.cameras.camera_to_worlds[0].numpy()
    pose[:3, 3] += pose[:3, 0] * 1.0
    img = served.render_image(pose.tolist(), float(outputs.cameras.times[0, 0]), "front_camera")
    log(f"[train] checkpoint {ckpt.name} ({size_mb:.0f} MiB); ClosedLoopState.from_run_dir in {load_s:.1f} s; "
        f"its render {served.last_render_seconds * 1e3:.1f} ms")
    require(img.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(img).all()), "the loaded run renders a finite image")
    for name, p in served.pipeline.model.named_parameters():
        require(torch.equal(p.detach(), dict(model.named_parameters())[name].detach()), f"{name} loaded as trained")
    return dict(steps=steps, refines=refines, launches=launches, moved=moved, profile=profile,
                repeated_frames=repeated, checkpoint_mib=size_mb, load_run_s=load_s,
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30, eval=evaluated, run_dir=str(run_dir))


# ---------------------------------------------------------------------------
# NeuRAD serving phase
# ---------------------------------------------------------------------------


def _liven(model) -> None:
    """Make a freshly drawn NeuRAD model's picture depend on its hash grids and
    actors: both packages draw hash tables at 1e-3, where features vanish next
    to the MLPs' biases and every ray's first sample is nearly opaque. Tables
    are scaled by 300 (features O(0.3)) and the SDF head's bias set to 0.08 (a
    sample's alpha about 0.03-0.6). Still random weights from the seed."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if "hash_table" in name:
                p.mul_(300.0)
        model.field.mlp_geo.output.bias[0] = 0.08


def neurad_phase(outputs):
    """NeuRAD serving at the `neurad` preset's full width through the
    closed-loop server state and the pipeline's eval renders."""
    import numpy as np
    import torch

    from http.server import ThreadingHTTPServer

    from neurad_tpu_torch.fields.neurad_encoding import HashGrid
    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline
    from neurad_tpu_torch.scripts.closed_loop import build_state, make_handler

    w, h = WIDTH, HEIGHT
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30  # what earlier phases left allocated
    t0 = time.perf_counter()
    state = build_state("neurad", device=DEVICE, seed=SEED, outputs=outputs)
    pipeline = state.pipeline
    _sync()
    t_pipe = time.perf_counter() - t0
    model = pipeline.model
    _liven(model)
    require(isinstance(pipeline, ADPipeline) and pipeline.config.eval_chunk == NEURAD_CHUNK, "the preset's chunk size")
    static, actor = model.field.hashgrid.static_hash_table, model.field.hashgrid.actor_hash_table
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[neurad] pipeline in {t_pipe:.1f} s: {n_params / 1e6:.1f} M parameters; static tables "
        f"{[tuple(t.shape) for t in static]}, actor tables {[tuple(t.shape) for t in actor]}")
    require(sum(t.numel() for t in static) >= 0.9 * 8 * 2**22 and len(static) == 8, "2^22 static slots x 8 levels")
    require(len(actor) == 4 and actor[0].shape == (2**17 // 16, 64), "2^17 actor slots, 4 levels")
    require(model.sampling.num_proposal_samples == (128, 64) and model.sampling.num_nerf_samples == NEURAD_SAMPLES,
            "128/64 proposal samples, 32 field samples")
    require(model.rgb_decoder.stem.in_channels == 48 and model.rgb_decoder.upsample.stride == (3, 3),
            "32 + 16 features into the decoder, upsample 3")

    hs, ws = h // 3, w // 3
    cam_chunks = -(-(hs * ws) // NEURAD_CHUNK)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    c2w_all = outputs.cameras.camera_to_worlds.numpy()
    times = outputs.cameras.times[:, 0].numpy()
    requests, images = [], []
    try:
        HE.reset_launch_counts()
        for i, lateral in enumerate((0.0, 1.5)):
            pose = np.eye(4, dtype=np.float32)
            pose[:3] = c2w_all[i]
            pose[:3, 3] += pose[:3, 0] * lateral
            before = HE.hash_grid_launches
            img = state.render_image(pose.tolist(), float(times[i]) + 0.1 * i, "front_camera")
            launched = HE.hash_grid_launches - before
            log(f"[neurad] camera request {i} ({'cold' if i == 0 else 'warm'}): render "
                f"{state.last_render_seconds * 1e3:.1f} ms (synchronised, incl. copy to host), {hs * ws} rays in "
                f"{cam_chunks} chunks, {launched} lookup launches")
            require(img.shape == (h, w, 3) and bool(np.isfinite(img).all()), f"image shape {img.shape}, finite")
            require(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, "image in [0, 1]")
            require(launched == 2 * cam_chunks, "the lookup kernel launched twice per chunk (static + actor grid)")
            requests.append(dict(render_ms=state.last_render_seconds * 1e3, launches=launched))
            images.append(img)
        actors = _get(url + "/get_actors")["actors"]
        moved = np.asarray(actors[0]["poses"], np.float32)
        moved[:, :3, 3] = c2w_all[1][:3, 3] + c2w_all[1][:3, :3] @ np.array([0.0, -0.3, -2.5], np.float32)  # 2.5 m ahead
        actors[0]["poses"] = moved.tolist()
        require(_post(url + "/update_actors", {"actors": actors})["status"] == "ok", "/update_actors answered")
        img = state.render_image(pose.tolist(), float(times[1]) + 0.1, "front_camera")
        changed = float((np.abs(img - images[1]).max(-1) > 1e-3).mean())
        log(f"[neurad] camera request after /update_actors: render {state.last_render_seconds * 1e3:.1f} ms, "
            f"{changed:.4f} of the pixels changed")
        require(changed > 0.001, "the moved actor changes the image")
        requests.append(dict(render_ms=state.last_render_seconds * 1e3, launches=2 * cam_chunks, after_update=True))
        camera_launches = HE.hash_grid_launches

        scan = 0
        n_pts = int(outputs.point_clouds[scan].shape[0])
        lidar_chunks = -(-n_pts // NEURAD_CHUNK)
        lidar_times = []
        for _ in range(2):
            before = HE.hash_grid_launches
            _sync()
            t_l = time.perf_counter()
            lid = pipeline.render_eval_lidar(scan)
            lidar_times.append((time.perf_counter() - t_l) * 1e3)
            require(HE.hash_grid_launches - before == 2 * lidar_chunks, "the lookup kernel launched twice per lidar chunk")
        launches = HE.hash_grid_launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"[neurad] lidar scan: {n_pts} returns of {LIDAR_BEAMS[0] * LIDAR_BEAMS[1]} beams in {lidar_chunks} chunks, render "
        f"cold {lidar_times[0]:.1f} ms, warm {lidar_times[1]:.1f} ms (synchronised, incl. copy to host)")
    for key in ("depth", "intensity", "ray_drop_logits"):
        require(lid[key].shape == (n_pts, 1) and bool(np.isfinite(lid[key]).all()), f"lidar {key} finite, one per point")
    peak = torch.cuda.max_memory_allocated() / 2**30
    grids = [g for m in model.modules() for g in vars(m).values() if isinstance(g, HashGrid) and g.copies is not None]
    copies_gib = sum(held[3].numel() * 2 for g in grids for held in g.copies._held) / 2**30
    require(copies_gib > 0, "the serving state's hash grids read bf16 copies of their tables")
    log(f"[neurad] lookup launches on the serving path: {launches} ({camera_launches} for three camera requests); peak "
        f"device memory {peak:.2f} GiB ({resident:.2f} GiB of it left allocated by earlier phases; the tables' bf16 "
        f"copies {copies_gib:.2f} GiB)")
    prof = profiled("neurad camera request", lambda: state.render_image(pose.tolist(), float(times[1]), "front_camera"),
                    rows=18, match=HASH_KERNEL)
    k1_ms, k1_n = prof["matched_ms"], prof["matched_launches"]
    log(f"[neurad] profiled request: the lookup kernel {k1_ms:.3f} ms in {k1_n} launches, "
        f"{100 * k1_ms / prof['device_busy_ms']:.1f}% of the device's busy time")
    require(k1_n == 2 * cam_chunks and k1_ms > 0, "the profile shows the lookup kernel's launches")
    return dict(requests=requests, lidar_ms=lidar_times, lidar_returns=n_pts, launches={"hash_grid": launches},
                camera_chunks=cam_chunks, lidar_chunks=lidar_chunks, pipeline_s=t_pipe, parameters=n_params,
                peak_memory_gib=peak, resident_gib=resident, bf16_copies_gib=copies_gib, profile=prof,
                hash_grid_profile_ms=k1_ms)


def neurad_reference_phase():
    """The card's NeuRAD renders (lookup kernel) against the CPU path (plain
    version) on a small scene at small widths, same parameters, livened as in
    the serving phase, the actor placed 1.5 m ahead of the camera. Matmuls and transcendentals round differently on the
    two devices, and a resampled sample that crosses a cell face changes its
    features: with fp32 reads and decoders rgb within 1e-4 on 99% of the values
    (measured: 2e-6 at most) and 2e-2 everywhere (room for a sample that crosses
    a face); at the bf16 default within 1e-2 on 99% and 3e-2 everywhere
    (measured: 8e-3 at most), on a picture whose values have a standard
    deviation above 0.02 (printed)."""
    import numpy as np
    import torch

    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline, ADPipelineConfig
    from neurad_tpu_torch.scripts.closed_loop import neurad_tiny_overrides

    outputs = SyntheticDataParserConfig(num_frames=3).setup().get_dataparser_outputs()
    traj = outputs.trajectories[0]
    stamps = np.asarray(traj["timestamps"])
    traj["poses"] = np.array(traj["poses"])
    traj["poses"][:, :3, 3] = np.stack([2.0 * stamps + 1.5, np.full(len(stamps), 0.1), np.full(len(stamps), 1.5)], -1)
    traj["dims"] = np.array([1.2, 1.2, 1.2], np.float32)
    result = {}
    for fp32 in (True, False):
        cfg = ADPipelineConfig(model_overrides=dict(neurad_tiny_overrides(), compute_fp32=fp32), eval_chunk=1024,
                               seed=SEED)
        gpu, cpu = ADPipeline(outputs, cfg, device="cuda"), ADPipeline(outputs, cfg, device="cpu")
        _liven(gpu.model)
        cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
        before = HE.hash_grid_launches
        a, _ = gpu.render_eval_camera(1)
        require(HE.hash_grid_launches - before == 2 * -(-(16 * 24) // 1024), "the card's render went through the kernel")
        b, _ = cpu.render_eval_camera(1)
        diff = np.abs(a - b)
        la, lb = gpu.render_eval_lidar(1), cpu.render_eval_lidar(1)
        rel = np.abs(la["depth"] - lb["depth"]) / np.maximum(np.abs(lb["depth"]), 1.0)
        tight, loose = (1e-4, 2e-2) if fp32 else (1e-2, 3e-2)
        name = "fp32" if fp32 else "bf16"
        result[name] = dict(rgb_max_err=float(diff.max()), rgb_share_off=float((diff > tight).mean()),
                            depth_max_rel_err=float(rel.max()), depth_share_off=float((rel > tight).mean()),
                            intensity_max_err=float(np.abs(la["intensity"] - lb["intensity"]).max()))
        log(f"[reference] NeuRAD card vs CPU path, 72x48 scene, {name}: {result[name]} (picture std {b.std():.3f})")
        require(b.std() > 0.02, "the picture is not flat")
        require(diff.max() <= loose and (diff > tight).mean() <= 0.01, f"NeuRAD rgb agrees ({name})")
        require((rel > tight).mean() <= 0.02 and result[name]["intensity_max_err"] <= loose, f"NeuRAD lidar agrees ({name})")
    return result


def neurad_train_phase(outputs):
    """NeuRAD training at the `neurad` preset's full width (57,344 rays a batch
    in 7 chunks of 8,192, VGG on) through `ADPipeline.init_state`,
    `datamanager.next_train` and `train_step`, weights from the seed, livened;
    then a few steps through the train script's loop (`train_loop`, batches
    from the preset's sampler threads), one profiled step, a checkpoint and a
    1080p request served from it by `ClosedLoopState.from_run_dir`. The run
    directory (in RUNS) serves the render, export and viewer phases."""
    import numpy as np
    import torch

    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline
    from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState
    from neurad_tpu_torch.scripts.train import train_loop, write_run_config

    cfg = METHODS["neurad"]().pipeline
    cfg.seed = SEED
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30  # what earlier phases left allocated
    t0 = time.perf_counter()
    pipeline = ADPipeline(outputs, cfg, device=DEVICE)
    model = pipeline.model
    _liven(model)
    state = pipeline.init_state()
    _sync()
    t_pipe = time.perf_counter() - t0
    n_rays = pipeline.num_cam_rays + cfg.datamanager.num_lidar_rays
    n_chunks = -(-n_rays // cfg.train_ray_chunk)
    groups = sorted(set(state.optimizers.labels.values()))
    log(f"[neurad-train] pipeline + state in {t_pipe:.1f} s: {n_rays} rays a batch ({pipeline.num_cam_rays} camera "
        f"rays in {cfg.datamanager.num_cam_patches} patches of {cfg.datamanager.patch_size}^2, "
        f"{cfg.datamanager.num_lidar_rays} lidar rays), {n_chunks} chunks of {cfg.train_ray_chunk}; VGG "
        f"{'on' if pipeline.vgg is not None else 'off'}; optimizer groups {sorted(cfg.optimizer_groups)}, "
        f"with parameters {groups}")
    require(n_rays == 57344 and n_chunks == 7, "57,344 rays a batch in 7 chunks of 8,192")
    require(pipeline.vgg is not None and model.loss.vgg_mult > 0, "VGG perceptual loss on")
    require(len(cfg.optimizer_groups) == 5, "five Adam groups")
    before = {n: p.detach().clone() for n, p in model.named_parameters() if "hash_table" not in n}
    table_before = [t.detach()[:4096].clone() for t in model.field.hashgrid.static_hash_table]

    steps = []
    fwd = bwd = 0
    HE.reset_launch_counts()
    for i in range(NEURAD_TRAIN_STEPS):
        bundle, batch = pipeline.datamanager.next_train()
        f0, b0 = HE.hash_grid_launches, HE.hash_grid_bwd_launches
        _sync()
        t0 = time.perf_counter()
        state, metrics = pipeline.train_step(state, bundle, batch)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        fwd, bwd = HE.hash_grid_launches - f0, HE.hash_grid_bwd_launches - b0
        loss = float(metrics["total_loss"])
        require(math.isfinite(loss), f"step {state.step} loss finite")
        steps.append(dict(step=state.step, ms=ms, total_loss=loss, rgb_loss=float(metrics["rgb_loss"]),
                          vgg_loss=float(metrics["vgg_loss"]), depth_loss=float(metrics["depth_loss"]),
                          k1f=fwd, k1b=bwd))
        log(f"[neurad-train] step {state.step}: {ms:.1f} ms (synchronised{', the first' if i == 0 else ''}), total "
            f"loss {loss:.5f}, rgb {float(metrics['rgb_loss']):.5f}, vgg {float(metrics['vgg_loss']):.5f}, depth "
            f"{float(metrics['depth_loss']):.4f}, psnr {float(metrics['psnr']):.2f}; K1f {fwd}, K1b {bwd} launches")
        require(fwd == bwd == 2 * n_chunks, "K1f and K1b launched twice per chunk (static + actor grid)")
    warm = [s["ms"] for s in steps[1:]]
    rays_per_s = n_rays * len(warm) / (sum(warm) / 1e3)

    # the train script's loop as `scripts.train neurad` runs it: the preset's sampler threads build the next
    # batches on the card while a step runs; a log line (and a synchronisation) every step
    dm_cfg = pipeline.datamanager.config
    b0 = HE.hash_grid_bwd_launches
    trainer = METHODS["neurad"]().trainer
    trainer.max_num_iterations, trainer.steps_per_log, trainer.steps_per_save = (
        state.step + NEURAD_LOOP_STEPS, 1, 10**9)
    state, history = train_loop(pipeline, state, trainer, OUT_DIR)
    loop_rates = [h["train_rays_per_sec"] for h in history]
    loop_rays_per_s = n_rays * (len(loop_rates) - 1) / sum(n_rays / r for r in loop_rates[1:])
    require(len(history) == NEURAD_LOOP_STEPS and all(math.isfinite(h["total_loss"]) for h in history),
            "the train loop logs every step with a finite loss")
    require(HE.hash_grid_bwd_launches - b0 == 2 * n_chunks * NEURAD_LOOP_STEPS, "the train loop's steps ran K1b")
    require(pipeline.datamanager._threads is None, "the train loop stopped its sampler threads")
    launches = {"hash_grid": HE.hash_grid_launches, "hash_grid_bwd": HE.hash_grid_bwd_launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[neurad-train] first step {steps[0]['ms']:.1f} ms, warm {min(warm):.1f}-{max(warm):.1f} ms: "
        f"{rays_per_s:.0f} train rays/s over the warm steps with batches from next_train outside the clock; "
        f"train_loop with {dm_cfg.num_workers} sampler threads and prefetch {dm_cfg.prefetch}: "
        f"{', '.join(f'{r:.0f}' for r in loop_rates)} rays/s a step, {loop_rays_per_s:.0f} over its warm steps; "
        f"peak device memory {peak:.2f} GiB ({resident:.2f} GiB of it left allocated by earlier phases)")

    moved = {}
    for name, p in model.named_parameters():
        if name in before:
            moved[state.optimizers.labels[name]] = max(moved.get(state.optimizers.labels[name], 0.0),
                                                       float((p.detach() - before[name]).abs().max()))
        require(bool(torch.isfinite(p).all()), f"{name} finite after training")
    moved["hashgrids"] = max(float((t.detach()[:4096] - b).abs().max())
                             for t, b in zip(model.field.hashgrid.static_hash_table, table_before))
    log(f"[neurad-train] largest parameter change by group: {moved}")
    require(all(v > 0 for v in moved.values()) and set(moved) == set(groups), "every group with parameters moved")

    # what the dense per-chunk table gradient costs a step: its zero-fill in each chunk's backward, and the
    # add of all but the first chunk's into .grad
    tables = [t for t in model.parameters() if t.dim() == 2 and t.numel() > 2**20]
    zero_ms = cuda_time_ms(lambda: [torch.zeros_like(t) for t in tables])
    add_ms = cuda_time_ms(lambda: [t.grad.add_(t.grad) for t in tables if t.grad is not None])
    dense_grad_ms = n_chunks * zero_ms + (n_chunks - 1) * add_ms
    log(f"[neurad-train] dense table gradients ({sum(t.numel() for t in tables) * 4 / 2**20:.0f} MiB): zero-fill "
        f"{zero_ms:.4f} ms and add {add_ms:.4f} ms a chunk, {dense_grad_ms:.2f} ms a step")

    prof = profiled("neurad train step", lambda: pipeline.train_step(state, *pipeline.datamanager.next_train()),
                    rows=25, match=HASH_BWD_KERNEL)
    k1b_ms, k1b_n = prof["matched_ms"], prof["matched_launches"]
    k1f_ms = sum(ms for name, ms, _ in prof["all"] if HASH_KERNEL in name)
    log(f"[neurad-train] profiled step: K1b {k1b_ms:.3f} ms in {k1b_n} launches ({100 * k1b_ms / prof['device_busy_ms']:.1f}% "
        f"of the busy time), K1f {k1f_ms:.3f} ms; the device idles "
        f"{100 - 100 * prof['device_busy_ms'] / prof['host_ms']:.0f}% of the step (profiler on)")
    require(k1b_n == 2 * n_chunks and k1b_ms > 0, "the profile shows K1b's launches")

    evaluated = eval_metrics_check("neurad", pipeline, NEURAD_EVAL_KEYS, {"hash_grid": 1}, profile=True)

    run_dir = write_run_config(RUNS / "neurad", "neurad", SyntheticDataParserConfig(**SCENE), cfg, SEED)
    ckpt = pipeline.save_checkpoint(state, run_dir / "checkpoints")
    size_mb = ckpt.stat().st_size / 2**20
    trained = {n: p.detach().cpu() for n, p in model.named_parameters() if "hash_table" not in n}
    del pipeline, state, model, before, table_before, tables
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served = ClosedLoopState.from_run_dir(run_dir, device=DEVICE)
    load_s = time.perf_counter() - t0
    pose = np.eye(4, dtype=np.float32)
    pose[:3] = outputs.cameras.camera_to_worlds[1].numpy()
    img = served.render_image(pose.tolist(), float(outputs.cameras.times[1, 0]), "front_camera")
    render_ms = served.last_render_seconds * 1e3
    log(f"[neurad-train] checkpoint {ckpt.name} ({size_mb:.0f} MiB); ClosedLoopState.from_run_dir in {load_s:.1f} s; "
        f"its 1080p render {render_ms:.1f} ms")
    require(img.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(img).all()), "the loaded run renders a finite image")
    for name, p in served.pipeline.model.named_parameters():
        if name in trained:
            require(torch.equal(p.detach().cpu(), trained[name]), f"{name} loaded as trained")
    del served
    torch.cuda.empty_cache()
    return dict(steps=steps, rays=n_rays, chunks=n_chunks, train_rays_per_s=rays_per_s,
                loop_rays_per_s_by_step=loop_rates, loop_train_rays_per_s=loop_rays_per_s, peak_memory_gib=peak,
                resident_gib=resident, launches=launches, k1f_per_step=fwd, k1b_per_step=bwd, moved=moved,
                dense_grad_ms=dense_grad_ms,
                zero_fill_ms=zero_ms, add_ms=add_ms, profile={k: v for k, v in prof.items() if k != "all"},
                k1b_profile_ms=k1b_ms, k1f_profile_ms=k1f_ms, checkpoint_mib=size_mb, load_run_s=load_s,
                served_render_ms=render_ms, eval=evaluated, run_dir=str(run_dir))


# ---------------------------------------------------------------------------
# drive phase: a logged drive in the KITTI-MOT layout, parsed and trained on
# ---------------------------------------------------------------------------


def _train_steps(pipeline, state, label, kinds, min_steps, refine_due, max_steps=40):
    """SplatAD steps from `datamanager.next_train` until each kind in `kinds`
    has `min_steps` steps: each timed on the host clock, synchronised, its loss
    finite -> (state, {kind: [records]}, refines)."""
    from neurad_tpu_torch.data.full_image_datamanager import CameraSample

    steps = {k: [] for k in kinds}
    refines = 0
    while min(len(v) for v in steps.values()) < min_steps:
        require(state.step < max_steps, f"{label}: both kinds of sample drawn within {max_steps} steps")
        sample = pipeline.datamanager.next_train()
        kind = "camera" if isinstance(sample, CameraSample) else "lidar"
        _sync()
        t0 = time.perf_counter()
        state, metrics = pipeline.train_step(state, sample)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        refined = bool(refine_due(state.step))
        refines += refined
        loss = float(metrics["total_loss"])
        require(math.isfinite(loss), f"{label}: step {state.step} loss finite")
        steps[kind].append(dict(step=state.step, ms=ms, refined=refined, total_loss=loss))
        log(f"[{label}] step {state.step} {kind}: {ms:.1f} ms (synchronised{', incl. a refine' if refined else ''}), "
            f"total loss {loss:.5f}")
    return state, steps, refines


def _png_decode_times(paths):
    """Row-filter counts over `paths` (None, Sub, Up, Average, Paeth) and the
    host time of `read_png` on each, in ms."""
    import zlib

    import numpy as np

    from neurad_tpu_torch.data import png

    counts, times = [0] * 5, []
    for path in paths:
        data = path.read_bytes()
        idat = b"".join(body for kind, body in png._chunks(data) if kind == b"IDAT")
        height, width = png.read_png_size(path)
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, -1)
        for k in rows[:, 0].tolist():
            counts[k] += 1
        t0 = time.perf_counter()
        png.read_png(path)
        times.append((time.perf_counter() - t0) * 1e3)
    return counts, times


def drive_outputs(tmp):
    """The drive: the KITTI-MOT sequence written by `make_kittimot_fixture`
    into `tmp` and parsed by `KittiMotDataParser`, missing-point synthesis
    on -> (outputs, seconds to write, seconds to parse)."""
    from neurad_tpu_torch.data.dataparsers.fixtures import make_kittimot_fixture
    from neurad_tpu_torch.data.dataparsers.kitti import KittiMotDataParserConfig

    t0 = time.perf_counter()
    make_kittimot_fixture(tmp, seq=DRIVE_SEQ, n_frames=DRIVE_FRAMES, seed=SEED)
    t1 = time.perf_counter()
    outputs = KittiMotDataParserConfig(data=tmp, sequence=DRIVE_SEQ, train_split_fraction=DRIVE_SPLIT
                                       ).setup().get_dataparser_outputs()
    return outputs, t1 - t0, time.perf_counter() - t1


def drive_phase():
    """Train both models on a logged drive: a KITTI-MOT sequence written by
    `make_kittimot_fixture` at the sensors' sizes (image_02 at 1242x375, about
    120,000 HDL-64E returns a scan at 10 Hz, OXTS, calibration, tracked cars;
    DRIVE_FRAMES frames), parsed by the port's `KittiMotDataParser` with the
    missing-point synthesis on. Then the `neurad` preset (57,344 rays a batch)
    and the `splatad` preset (500,000 gaussians, MCMC refines) train on it at
    full width, each scores its eval split with `eval_metrics`, and the trained
    SplatAD serves a closed-loop camera request and renders a scan. Then the
    `nerfacto-lidar` preset takes NERFACTO_DRIVE_STEPS steps (K1f and K1b three
    times a step). The counters must show K1f, K1b, K2, K3, K4 and K5
    launched in this phase."""
    import numpy as np
    import torch

    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.data.dataparsers.ad_dataparser import DUMMY_DISTANCE_VALUE
    from neurad_tpu_torch.model_components.strategy import MCMCStrategyConfig, should_refine
    from neurad_tpu_torch.models.splatad import SplatADConfig
    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.ops import tile_composite as TC
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig
    from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        outputs, res["write_s"], res["parse_s"] = drive_outputs(tmp)
        raw = [int(np.fromfile(f, np.float32).size // 4)
               for f in sorted((Path(tmp) / "training" / "velodyne" / DRIVE_SEQ).glob("*.bin"))]
        frames = sorted((Path(tmp) / "training" / "image_02" / DRIVE_SEQ).glob("*.png"))
        res["row_filters"], res["decode_ms"] = _png_decode_times(frames[:DECODE_FRAMES])
    missing = [int((np.linalg.norm(pc[:, :3], axis=-1) > 0.99 * DUMMY_DISTANCE_VALUE).sum()) for pc in outputs.point_clouds]
    h, w = outputs.images[0].shape[:2]
    res.update(frames=len(outputs.images), image_hw=[h, w], raw_points=raw, missing_points=missing,
               trajectories=len(outputs.trajectories), labels=sorted(t["label"] for t in outputs.trajectories),
               eval_cameras=list(outputs.eval_camera_indices))
    log(f"[drive] KITTI-MOT sequence {DRIVE_SEQ}: {len(outputs.images)} frames at {w}x{h}, written in "
        f"{res['write_s']:.1f} s, parsed in {res['parse_s']:.2f} s; {min(raw)}-{max(raw)} returns a scan, "
        f"{min(missing)}-{max(missing)} missing points added a scan ({sum(missing)} in all); "
        f"{len(outputs.trajectories)} actor tracks {res['labels']}; eval cameras {res['eval_cameras']}")
    log(f"[drive] image_02 row filters (None, Sub, Up, Average, Paeth) {res['row_filters']}; read_png "
        f"{', '.join(f'{m:.1f}' for m in res['decode_ms'])} ms a frame ({DECODE_FRAMES} frames)")
    require(res["row_filters"][3] + res["row_filters"][4] > 0, "the frames hold Average or Paeth rows")
    require((h, w) == (375, 1242) and len(outputs.images) == DRIVE_FRAMES, "image_02 frames at 1242x375")
    require(min(raw) >= 100_000, "about 120,000 returns a scan")
    require(all(m > 0 for m in missing), "the lidar scans hold DUMMY_DISTANCE points")
    require(sum(lab == "Car" for lab in res["labels"]) >= 2, "two moving cars tracked")

    HE.reset_launch_counts()
    TC.reset_launch_counts()
    counts = lambda: {"hash_grid": HE.hash_grid_launches, "hash_grid_bwd": HE.hash_grid_bwd_launches,
                      "camera": TC.camera_launches, "camera_bwd": TC.camera_bwd_launches,
                      "lidar": TC.lidar_launches, "lidar_bwd": TC.lidar_bwd_launches}

    # --- NeuRAD at the `neurad` preset's full width ---
    cfg = METHODS["neurad"]().pipeline
    cfg.seed = SEED
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipeline = ADPipeline(outputs, cfg, device=DEVICE)
    state = pipeline.init_state()
    _sync()
    n_rays = pipeline.num_cam_rays + cfg.datamanager.num_lidar_rays
    n_chunks = -(-n_rays // cfg.train_ray_chunk)
    require(n_rays == 57344, "57,344 rays a batch")
    log(f"[drive] neurad pipeline + state in {time.perf_counter() - t0:.1f} s")
    steps = []
    for i in range(DRIVE_NEURAD_STEPS):
        bundle, batch = pipeline.datamanager.next_train()
        f0, b0 = HE.hash_grid_launches, HE.hash_grid_bwd_launches
        _sync()
        t0 = time.perf_counter()
        state, metrics = pipeline.train_step(state, bundle, batch)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        loss = float(metrics["total_loss"])
        require(math.isfinite(loss), f"drive neurad step {state.step} loss finite")
        require(HE.hash_grid_launches - f0 == HE.hash_grid_bwd_launches - b0 == 2 * n_chunks,
                "K1f and K1b twice a chunk (static + actor grid)")
        steps.append(dict(step=state.step, ms=ms, total_loss=loss, rgb_loss=float(metrics["rgb_loss"]),
                          depth_loss=float(metrics["depth_loss"])))
        log(f"[drive] neurad step {state.step}: {ms:.1f} ms (synchronised{', the first' if i == 0 else ''}), total "
            f"loss {loss:.5f}, rgb {steps[-1]['rgb_loss']:.5f}, depth {steps[-1]['depth_loss']:.4f}")
    warm = [s["ms"] for s in steps[1:]]
    prof = profiled("drive neurad train step", lambda: pipeline.train_step(state, *pipeline.datamanager.next_train()),
                    rows=12, match=HASH_BWD_KERNEL)
    evaluated = eval_metrics_check("drive neurad", pipeline, NEURAD_EVAL_KEYS, {"hash_grid": 1})
    res["neurad"] = dict(steps=steps, rays=n_rays, train_rays_per_s=n_rays * len(warm) / (sum(warm) / 1e3),
                         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                         profile={k: v for k, v in prof.items() if k != "all"},
                         busy_share=prof["device_busy_ms"] / prof["host_ms"], eval=evaluated)
    log(f"[drive] neurad: first step {steps[0]['ms']:.1f} ms, warm {min(warm):.1f}-{max(warm):.1f} ms "
        f"({res['neurad']['train_rays_per_s']:.0f} rays/s); the profiled step busy "
        f"{100 * res['neurad']['busy_share']:.0f}%; peak device memory {res['neurad']['peak_memory_gib']:.2f} GiB")
    del pipeline, state, prof
    gc.collect()
    torch.cuda.empty_cache()

    # --- SplatAD at the `splatad` preset's full width ---
    scfg = SplatADPipelineConfig(cap_max=N_GAUSS, seed=SEED, model=SplatADConfig(num_downscales=0),
                                 mcmc=MCMCStrategyConfig(cap_max=N_GAUSS, refine_start_iter=1, refine_every=3))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipeline = SplatADPipeline(outputs, scfg, device=DEVICE)
    state = pipeline.init_state()
    _sync()
    log(f"[drive] splatad pipeline + state in {time.perf_counter() - t0:.1f} s "
        f"({pipeline.datamanager.all_seed_points().shape[0]} seed points)")
    state, ssteps, refines = _train_steps(pipeline, state, "drive", ("camera", "lidar"), MIN_STEPS_PER_KIND,
                                          lambda step: should_refine(step, scfg.mcmc))
    require(refines >= 1, "at least one MCMC refine on the drive")
    profile = {}
    samples = {"camera": pipeline.datamanager._camera_sample(pipeline.datamanager.train_cams[0]),
               "lidar": pipeline.datamanager._lidar_sample(pipeline.datamanager.train_lidars[0])}
    for kind, sample in samples.items():
        while should_refine(state.step + 1, scfg.mcmc):  # keep the refine out of the profiled step
            state, _ = pipeline.train_step(state, sample)
        prof = profiled(f"drive splatad {kind} step", lambda: pipeline.train_step(state, sample), rows=10,
                        match=f"{kind}_bwd_kernel")
        profile[kind] = {k: v for k, v in prof.items() if k != "all"}
        profile[kind]["busy_share"] = prof["device_busy_ms"] / prof["host_ms"]
    sevaluated = eval_metrics_check("drive splatad", pipeline, SPLATAD_EVAL_KEYS, {"camera": 1, "lidar": 1})
    served = ClosedLoopState(pipeline, device=DEVICE)
    ci = outputs.eval_camera_indices[0]
    pose = np.eye(4, dtype=np.float32)
    pose[:3] = outputs.cameras.camera_to_worlds[ci].numpy()
    pose[:3, 3] += pose[:3, 0] * 1.0  # a metre to the side
    img = served.render_image(pose.tolist(), float(outputs.cameras.times[ci, 0]), "image_02")
    require(img.shape == (375, 1242, 3) and bool(np.isfinite(img).all()), "the trained SplatAD serves a finite image")
    scan = pipeline.render_eval_lidar(outputs.eval_lidar_indices[0])
    require(all(bool(np.isfinite(scan[k]).all()) for k in ("depth", "intensity", "ray_drop_logits")), "a finite scan")
    cam_ms = [r["ms"] for r in ssteps["camera"]]
    lid_ms = [r["ms"] for r in ssteps["lidar"]]
    res["splatad"] = dict(steps=ssteps, refines=refines, profile=profile, eval=sevaluated,
                          served_render_ms=served.last_render_seconds * 1e3,
                          peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[drive] splatad: camera steps {', '.join(f'{m:.1f}' for m in cam_ms)} ms, lidar steps "
        f"{', '.join(f'{m:.1f}' for m in lid_ms)} ms ({refines} refines); profiled camera step busy "
        f"{100 * profile['camera']['busy_share']:.0f}%, lidar {100 * profile['lidar']['busy_share']:.0f}%; closed-loop "
        f"render {res['splatad']['served_render_ms']:.1f} ms; peak device memory "
        f"{res['splatad']['peak_memory_gib']:.2f} GiB")
    del served, state, pipeline
    gc.collect()
    torch.cuda.empty_cache()

    # --- nerfacto-lidar at its preset's width (4,096 camera + 4,096 lidar rays) ---
    ncfg = METHODS["nerfacto-lidar"]().pipeline
    ncfg.seed = SEED
    pipeline = ADPipeline(outputs, ncfg, device=DEVICE)
    state = pipeline.init_state()
    f0, b0 = HE.hash_grid_launches, HE.hash_grid_bwd_launches
    nsteps = []
    for i in range(NERFACTO_DRIVE_STEPS):
        bundle, batch = pipeline.datamanager.next_train()
        _sync()
        t0 = time.perf_counter()
        state, metrics = pipeline.train_step(state, bundle, batch)
        _sync()
        nsteps.append(dict(step=state.step, ms=(time.perf_counter() - t0) * 1e3,
                           **{k: float(metrics[k]) for k in ("total_loss", "rgb_loss", "depth_loss")}))
        require(all(math.isfinite(v) for v in nsteps[-1].values()), f"drive nerfacto-lidar step {state.step} finite")
    nl = {"hash_grid": HE.hash_grid_launches - f0, "hash_grid_bwd": HE.hash_grid_bwd_launches - b0}
    require(nl == {"hash_grid": 3 * NERFACTO_DRIVE_STEPS, "hash_grid_bwd": 3 * NERFACTO_DRIVE_STEPS},
            f"drive nerfacto-lidar: K1f and K1b three times a step ({nl})")
    res["nerfacto_lidar"] = dict(steps=nsteps, launches=nl, rays=int(bundle.origins.shape[0]))
    step_ms = ", ".join(f"{r['ms']:.1f}" for r in nsteps)
    losses = ", ".join(f"{r['total_loss']:.4f}" for r in nsteps)
    log(f"[drive] nerfacto-lidar ({res['nerfacto_lidar']['rays']} rays a batch): steps {step_ms} ms (the first, then "
        f"warm), losses {losses}, depth {nsteps[-1]['depth_loss']:.3g}; launches {nl}")
    res["launches"] = counts()
    log(f"[drive] kernel launches in this phase: {res['launches']}")
    require(all(v > 0 for v in res["launches"].values()), "the drive phase launched K1f, K1b, K2, K3, K4 and K5")
    # every pose of the drive, [N, 3, 4]: the cameras', the lidar's and each tracked actor's at every frame
    scene = dict(poses=torch.cat([outputs.cameras.camera_to_worlds, outputs.lidars.lidar_to_worlds] +
                                 [torch.as_tensor(t["poses"][:, :3]).float() for t in outputs.trajectories]),
                 aabb=outputs.scene_box.aabb.clone())
    del pipeline, state, outputs
    gc.collect()
    torch.cuda.empty_cache()
    return res, scene


# ---------------------------------------------------------------------------
# splatfacto phase
# ---------------------------------------------------------------------------


def splatfacto_phase(outputs, rng):
    """The `splatfacto` preset at full width (100,000 slots, 30,000 alive at the
    start, SH degree 3, 16-px tiles, 256 slots a tile) on the synthetic 1080p
    scene: steps through `SplatfactoPipeline.train_step` across Default-strategy
    refines (timed with and without), `eval_metrics`, and K2 and K3 at C = 3 held
    against their plain versions on the inputs of a real step (the model's
    projection and SH colours at a train camera)."""
    import torch

    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.model_components.strategy import DefaultStrategyConfig, should_refine_default
    from neurad_tpu_torch.models.splatad import viewmat_from_c2w_opengl
    from neurad_tpu_torch.ops import gaussians as G
    from neurad_tpu_torch.ops import tile_composite as TC
    from neurad_tpu_torch.ops.gaussian_rasterize import camera_tile_inputs
    from neurad_tpu_torch.pipelines.splatfacto_pipeline import SplatfactoPipeline

    cfg = METHODS["splatfacto"]().pipeline
    cfg.seed = SEED
    cfg.strategy = DefaultStrategyConfig(refine_start_iter=SPLATFACTO_REFINE[0], refine_every=SPLATFACTO_REFINE[1])
    require((cfg.capacity, cfg.num_init, cfg.model.sh_degree, cfg.model.tile_size, cfg.model.max_per_tile)
            == (100_000, 30_000, 3, 16, 256), "the splatfacto preset's widths")
    torch.cuda.reset_peak_memory_stats()
    pipeline = SplatfactoPipeline(outputs, cfg, device=DEVICE)
    state = pipeline.init_state()
    TC.reset_launch_counts()
    steps, alive = [], [pipeline.num_alive()]
    for _ in range(SPLATFACTO_STEPS):
        _sync()
        t0 = time.perf_counter()
        state, metrics = pipeline.train_step(state)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        refined = should_refine_default(state.step, cfg.strategy)
        loss = float(metrics["total_loss"])
        require(math.isfinite(loss), f"splatfacto step {state.step} loss finite")
        alive.append(pipeline.num_alive())
        if refined:
            require(int(pipeline._count.sum()) == 0, "the refine used and reset the absgrad sums")
        steps.append(dict(step=state.step, ms=ms, refined=refined, total_loss=loss, psnr=float(metrics["psnr"]),
                          alive=alive[-1]))
        log(f"[splatfacto] step {state.step}: {ms:.1f} ms (synchronised{', incl. a refine' if refined else ''}), "
            f"loss {loss:.5f}, psnr {float(metrics['psnr']):.2f}, {alive[-1]} gaussians alive")
    launches = {"camera": TC.camera_launches, "camera_bwd": TC.camera_bwd_launches}
    require(launches == {"camera": SPLATFACTO_STEPS, "camera_bwd": SPLATFACTO_STEPS},
            "every splatfacto step launched K2 and K3 once")
    require(sum(s["refined"] for s in steps) == 2, "two Default refines ran")
    prof = profiled("splatfacto train step", lambda: pipeline.train_step(state, pipeline.train_indices[0]), rows=10,
                    match="camera_bwd_kernel")
    evaluated = eval_metrics_check("splatfacto", pipeline, {"psnr", "ssim", "num_gaussians"}, {"camera": 1})
    peak = torch.cuda.max_memory_allocated() / 2**30

    # K2 and K3 at C = 3 on a real step's inputs
    model = pipeline.model
    c2w, K, img = pipeline._camera(pipeline.train_indices[0])
    h, w = img.shape[:2]
    with torch.no_grad():
        c2w_t = torch.as_tensor(c2w, device=DEVICE)
        proj = G.project_gaussians_camera(
            model.means, G.quat_scale_to_covar6(model.quats, torch.exp(model.scales)), viewmat_from_c2w_opengl(c2w_t),
            torch.as_tensor(K, device=DEVICE), w, h, near_plane=cfg.model.near_plane, eps2d=cfg.model.eps2d)
        binning, table, tile_valid, pix, times = camera_tile_inputs(
            proj, model._sh_colors(c2w_t[:3, 3]), torch.sigmoid(model.opacities), w, h, cfg.model.tile_size,
            cfg.model.max_per_tile, cfg.model.max_tiles_per_gaussian)
    args = (table.contiguous(), binning.tile_gauss, tile_valid, pix, times)
    require(table.shape[1] - TC.ATTR == 3, "the splatfacto composite carries C = 3 channels")
    k2, _ = camera_fwd_check("camera C=3 (splatfacto)", args)
    # a static scene without a rolling shutter: no velocities, every pixel's time 0
    k3 = camera_bwd_check("camera backward C=3 (splatfacto)", args, rng, w, h,
                          zero_columns=("vel_x", "vel_y", "depth_vel"))
    warm = [s["ms"] for s in steps[1:] if not s["refined"]]
    with_refine = [s["ms"] for s in steps if s["refined"]]
    log(f"[splatfacto] steps without a refine {', '.join(f'{m:.1f}' for m in warm)} ms, with "
        f"{', '.join(f'{m:.1f}' for m in with_refine)} ms; profiled step busy "
        f"{100 * prof['device_busy_ms'] / prof['host_ms']:.0f}%, K3 {prof['matched_ms']:.3f} ms; peak device memory "
        f"{peak:.2f} GiB")
    del pipeline, state, model, args, table
    torch.cuda.empty_cache()
    return dict(steps=steps, launches=launches, alive=alive, profile={k: v for k, v in prof.items() if k != "all"},
                eval=evaluated, peak_memory_gib=peak, k2=k2, k3=k3)


# ---------------------------------------------------------------------------
# nerfacto and the long NeuRAD presets
# ---------------------------------------------------------------------------


def _nerfacto_lookup_case(label, enc, pos, gen, results):
    """K1f and K1b at one of nerfacto's grids (16 or 5 levels, F = 2, one row
    a grid corner, hashed levels two buckets a row) on the positions a real
    nerfacto step looked up, random O(1) tables of the grid's shapes: K1f with
    bf16 reads of the fp32 master (the train step's read) equal to its plain
    version bit for bit, K1b (table gradients only, as in the step) within
    BWD_TOL of each entry's terms; calls, device times (a CUDA graph of 10
    calls), plain times and the bytes bounds from the rows these positions
    touch."""
    import torch

    from neurad_tpu_torch.ops import hash_encoding as HE

    tables = HE.init_hash_tables(gen, enc.scales, 3, enc.table_size, enc.features_per_level, scale=1.0)
    scales = [float(s) for s in enc.scales]
    buckets = [t.shape[0] * pk for t, pk in zip(tables, enc.bucket_pack)]
    n, f, n_levels = pos.shape[0], enc.features_per_level, len(tables)
    layout = (scales, buckets, enc.dense_res, f, True, False)
    touched = sum(int(torch.unique(HE.level_index(pos, s, b, r, False)[0]).numel())
                  for s, b, r in zip(scales, buckets, enc.dense_res))
    table_bytes = sum(t.numel() for t in tables) * 4
    log(f"[nerfacto] {label}: N={n} L={n_levels} F={f} unpacked, bucket_pack {enc.bucket_pack}, tables "
        f"{table_bytes / 2**20:.1f} MiB, {touched} distinct rows of {n * n_levels * 8} row reads")

    @torch.no_grad()
    def lookup():
        return HE.hash_grid_encode(pos, None, tables, *layout)

    before = HE.hash_grid_launches
    got = lookup()
    _sync()
    require(DEVICE == "cpu" or HE.hash_grid_launches == before + 1, f"{label}: the wrapper launched K1f")
    want = HE.hash_grid_encode_plain(pos, None, tables, *layout)
    require(bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0.1, f"{label}: finite, non-trivial output")
    require(torch.equal(got, want), f"{label}: K1f equals its plain version bit for bit "
                                    f"(max abs err {float((got - want).abs().max()):.3e})")
    fwd_bytes = touched * f * 4 + (pos.numel() + n * n_levels * f) * 4
    fwd_bound, fwd_by = _bound(fwd_bytes, n * n_levels * (8 * (3 + 2 * f) + 6 * 3 + 8))
    fwd = dict(max_abs_err=float((got - want).abs().max()), ms=cuda_time_ms(lookup), device_ms=device_ms(lookup),
               plain_ms=cuda_time_ms(lambda: HE.hash_grid_encode_plain(pos, None, tables, *layout), warmup=1, reps=3),
               bound_ms=fwd_bound, bound_by=fwd_by, bytes=fwd_bytes, distinct_rows=touched, n=n, levels=n_levels)

    g = torch.randn((n, n_levels * f), generator=gen, device=DEVICE)
    bwd_call = lambda: HE.hash_grid_encode_bwd(pos, None, tables, *layout, g, positions_grad=False)
    before = HE.hash_grid_bwd_launches
    dts, again = bwd_call()[0], bwd_call()[0]
    _sync()
    require(DEVICE == "cpu" or HE.hash_grid_bwd_launches == before + 2, f"{label}: the wrapper launched K1b")
    want_t = HE.hash_grid_encode_bwd_plain(pos, None, tables, *layout, g, positions_grad=False)[0]
    mag_t = HE.hash_grid_encode_bwd_plain(pos, None, tables, *layout, g, positions_grad=False, magnitude=True)[0]
    err = max(float(((a - w).abs() / (m + 1e-30)).max()) for a, w, m in zip(dts, want_t, mag_t))
    run = max(float(((a - b).abs() / (m + 1e-30)).max()) for a, b, m in zip(dts, again, mag_t))
    abs_err = max(float((a - w).abs().max()) for a, w in zip(dts, want_t))
    require(all(bool(torch.isfinite(t).all()) and float(t.abs().max()) > 0 for t in dts), f"{label}: K1b finite")
    require(err <= BWD_TOL, f"{label}: K1b within {BWD_TOL:g} of the terms' magnitude (got {err:.3e})")
    # g and the positions read once, the dense table gradient written once
    bwd_bytes = (pos.numel() + g.numel()) * 4 + table_bytes
    bwd_bound, bwd_by = _bound(bwd_bytes, n * n_levels * (8 * (3 + 4 * f) + 6 * 3 + 8))
    bwd = dict(max_abs_err=abs_err, max_rel_err=err, run_to_run=run, ms=cuda_time_ms(bwd_call),
               device_ms=device_ms(bwd_call),
               plain_ms=cuda_time_ms(lambda: HE.hash_grid_encode_bwd_plain(pos, None, tables, *layout, g,
                                                                            positions_grad=False), warmup=1, reps=3),
               bound_ms=bwd_bound, bound_by=bwd_by, bytes=bwd_bytes, table_mib=table_bytes / 2**20, n=n,
               levels=n_levels)
    results[label] = dict(fwd=fwd, bwd=bwd)
    for kind, r in (("K1f", fwd), ("K1b", bwd)):
        log(f"[nerfacto] {label} {kind}: {r['ms']:.4f} ms a call, {r['device_ms']:.4f} ms on the device, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes']:.3e} bytes)"
            + (f"; error {err:.2e} of the terms' magnitude, two launches {run:.2e}" if kind == "K1b" else ""))
    del got, want, dts, again, want_t, mag_t


def _nerfacto_run(outputs, name):
    """A nerfacto preset at full width through `Trainer`: NERFACTO_STEPS + 1
    steps (each timed by callbacks around it, the batch's wait included),
    three K1f and three K1b launches a step, then one profiled step."""
    import dataclasses

    import torch

    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.engine.callbacks import TrainingCallback, TrainingCallbackLocation
    from neurad_tpu_torch.engine.trainer import Trainer
    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline

    cfg = METHODS[name]()
    cfg.pipeline.seed = SEED
    steps = NERFACTO_STEPS + 1
    require(cfg.trainer.steps_per_eval_batch > steps, f"{name}: no eval in the run (the JAX package has none)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipeline = ADPipeline(outputs, cfg.pipeline, device=DEVICE)
    state = pipeline.init_state()
    _sync()
    build_s = time.perf_counter() - t0
    n_rays = pipeline.num_cam_rays + cfg.pipeline.datamanager.num_lidar_rays
    times = []

    def start(s, i):
        _sync()
        times.append(time.perf_counter())

    def stop(s, i):
        _sync()
        times[-1] = (time.perf_counter() - times[-1]) * 1e3

    callbacks = [TrainingCallback((TrainingCallbackLocation.BEFORE_TRAIN_ITERATION,), start),
                 TrainingCallback((TrainingCallbackLocation.AFTER_TRAIN_ITERATION,), stop)]
    HE.reset_launch_counts()
    trainer = Trainer(pipeline, state, dataclasses.replace(cfg.trainer, steps_per_log=1, checkpoint_dir=None),
                      callbacks=callbacks)
    trainer.train(num_iterations=steps, save_at_end=False)
    launches = {"hash_grid": HE.hash_grid_launches, "hash_grid_bwd": HE.hash_grid_bwd_launches}
    require(trainer.state.step == steps and len(trainer.history) == steps, f"{name}: {steps} steps logged")
    require(all(math.isfinite(h["total_loss"]) for h in trainer.history), f"{name}: finite losses")
    require(("depth_loss" in trainer.history[-1]) == (name == "nerfacto-lidar"), f"{name}: the depth loss")
    require(launches == {"hash_grid": 3 * steps, "hash_grid_bwd": 3 * steps},
            f"{name}: K1f and K1b three times a step (field, two proposals): {launches}")
    warm = times[1:]
    prof = profiled(f"{name} train step", lambda: pipeline.train_step(trainer.state, *pipeline.datamanager.next_train()),
                    rows=10, match=HASH_BWD_KERNEL)
    in_path = {k: sum(ms for key, ms, _ in prof["all"] if k in key) for k in (HASH_KERNEL, HASH_BWD_KERNEL)}
    res = dict(rays=n_rays, build_s=build_s, step_ms=times, loss=[h["total_loss"] for h in trainer.history],
               train_rays_per_s=n_rays * len(warm) / (sum(warm) / 1e3), launches=launches,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               profile={k: v for k, v in prof.items() if k != "all"},
               busy_share=prof["device_busy_ms"] / prof["host_ms"], k1f_in_step_ms=in_path[HASH_KERNEL],
               k1b_in_step_ms=in_path[HASH_BWD_KERNEL])
    log(f"[nerfacto] {name}: {n_rays} rays a batch; built in {build_s:.1f} s; steps through Trainer "
        f"{', '.join(f'{m:.1f}' for m in times)} ms (the first, then warm: {res['train_rays_per_s']:.0f} rays/s); "
        f"losses {res['loss'][0]:.4f} -> {res['loss'][-1]:.4f}; launches {launches}; profiled step host "
        f"{prof['host_ms']:.1f} ms, busy {100 * res['busy_share']:.0f}%, K1f {in_path[HASH_KERNEL]:.3f} ms, K1b "
        f"{in_path[HASH_BWD_KERNEL]:.3f} ms; peak device memory {res['peak_memory_gib']:.2f} GiB")
    return pipeline, trainer.state, res


def nerfacto_phase(outputs, rng):
    """The `nerfacto` and `nerfacto-lidar` presets at full width on the
    synthetic 1080p scene through `Trainer` (NERFACTO_STEPS warm steps each,
    one profiled), then K1f and K1b at nerfacto's three grids on the positions
    of a real `nerfacto` step: the field's 16 levels on 4,096 x 48 samples,
    proposal 0's 5 levels on 4,096 x 256 and proposal 1's on 4,096 x 96."""
    import torch

    res = {}
    pipeline, state, res["nerfacto"] = _nerfacto_run(outputs, "nerfacto")
    model = pipeline.model
    grids = {"field": model.field.encoding, "proposal_0": model.proposal_0.encoding,
             "proposal_1": model.proposal_1.encoding}
    require(len(grids["field"].hash_table) == 16 and grids["field"].bucket_pack.count(2) == 11 and
            all(len(grids[p].hash_table) == 5 for p in ("proposal_0", "proposal_1")),
            "nerfacto's grids: 16 levels (eleven of 2^19 buckets, two a row) and two of 5")
    captured = {}
    hooks = [enc.register_forward_pre_hook(lambda m, args, key=key: captured.__setitem__(
        key, args[0].detach().reshape(-1, 3).contiguous())) for key, enc in grids.items()]
    pipeline.train_step(state, *pipeline.datamanager.next_train())
    for h in hooks:
        h.remove()
    n_rays = pipeline.num_cam_rays
    require({k: v.shape[0] for k, v in captured.items()} == {"field": n_rays * 48, "proposal_0": n_rays * 256,
                                                            "proposal_1": n_rays * 96} and n_rays == 4096,
            "the step looked up 4,096 rays x 48, 256 and 96 samples")
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    res["lookups"] = {}
    for key, enc in grids.items():
        _nerfacto_lookup_case(f"nerfacto_{key}", enc, captured[key], gen, res["lookups"])
    del pipeline, state, model, grids, captured
    torch.cuda.empty_cache()
    pipeline, state, res["nerfacto_lidar"] = _nerfacto_run(outputs, "nerfacto-lidar")
    del pipeline, state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def presets_phase(outputs):
    """The four long NeuRAD presets: `neurad-paper`, `neurader` and
    `neuradest` are `neurad` trained 4x, 2x and 0.25x as long (iterations,
    eval and save cadences, every group's schedule length; nothing else
    differs, so they take no step); `neurad-scaleopt` optimises the cameras
    (SO3xR3, per-axis weights and translation penalties) and takes one train
    step at full width, in which its camera group moves."""
    import dataclasses

    import torch

    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline

    base = METHODS["neurad"]()
    res = {}
    for name, scale in (("neurad-paper", 4.0), ("neurader", 2.0), ("neuradest", 0.25)):
        cfg = METHODS[name]()
        t, b = cfg.trainer, base.trainer
        want = (int((b.max_num_iterations - 1) * scale + 1), int(b.steps_per_eval_batch * scale),
                int(b.steps_per_save * scale))
        got = (t.max_num_iterations, t.steps_per_eval_batch, t.steps_per_save)
        groups = cfg.pipeline.optimizer_groups
        require(got == want and t.steps_per_log == b.steps_per_log, f"{name}: trainer {got}, expected {want}")
        require(all(groups[g] == dataclasses.replace(c, max_steps=int((c.max_steps - 1) * scale + 1))
                    for g, c in base.pipeline.optimizer_groups.items()) and set(groups) ==
                set(base.pipeline.optimizer_groups), f"{name}: every group's schedule {scale}x as long")
        require(cfg.pipeline.model_overrides == base.pipeline.model_overrides, f"{name}: neurad's model")
        res[name] = dict(trainer=list(got), max_steps={g: c.max_steps for g, c in groups.items()})
        log(f"[presets] {name}: {got[0]} iterations, eval every {got[1]}, save every {got[2]}; group schedules "
            f"{res[name]['max_steps']}")
    cfg = METHODS["neurad-scaleopt"]()
    over = cfg.pipeline.model_overrides
    require(over["camera_opt_mode"] == "SO3xR3" and over["camera_opt_weights"] == (0.01, 0.01, 0.01, 1.0, 1.0, 1.0)
            and over["camera_opt_trans_penalty"] == (1e-2, 1e-2, 1e-3) and cfg.trainer == base.trainer,
            "neurad-scaleopt: SO3xR3 with per-axis weights and penalties, neurad's trainer")
    cfg.pipeline.seed = SEED
    torch.cuda.reset_peak_memory_stats()
    pipeline = ADPipeline(outputs, cfg.pipeline, device=DEVICE)
    _liven(pipeline.model)
    state = pipeline.init_state()
    before = pipeline.model.camera_optimizer.pose_adjustment.detach().clone()
    _sync()
    t0 = time.perf_counter()
    state, metrics = pipeline.train_step(state, *pipeline.datamanager.next_train())
    _sync()
    ms = (time.perf_counter() - t0) * 1e3
    moved = float((pipeline.model.camera_optimizer.pose_adjustment.detach() - before).abs().max())
    require(math.isfinite(float(metrics["total_loss"])) and "camera_opt_regularizer" in metrics and moved > 0,
            "neurad-scaleopt: a finite step with the camera regulariser, the camera group moved")
    res["neurad-scaleopt"] = dict(step_ms=ms, total_loss=float(metrics["total_loss"]), camera_moved=moved,
                                  peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[presets] neurad-scaleopt: one full-width step {ms:.1f} ms (the first), loss "
        f"{res['neurad-scaleopt']['total_loss']:.4f}, camera adjustments moved by up to {moved:.2e}; peak "
        f"{res['neurad-scaleopt']['peak_memory_gib']:.2f} GiB")
    del pipeline, state
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the `neurad-parity` preset
# ---------------------------------------------------------------------------

PARITY_REQUESTS = 4  # 1080p camera requests: a cold one, then warm ones
PARITY_SCANS = 2
PARITY_TRAIN_STEPS = 4  # on `next_train` batches, the first apart
PARITY_LOOP_STEPS = 2  # then through the train script's loop
PARITY_K1 = 6  # K1f (and K1b) launches a chunk: the field's static and actor grids, then two proposal rounds' each
PARITY_REF = dict(num_cam_patches=1, patch_size=16, num_lidar_rays=768)  # one train chunk of 1,024 rays
PARITY_LOSS_TOL = 1e-5  # card against CPU, relative
# card against CPU, each gradient: the largest entry's error over the parameter's largest entry (floored at 1e-3
# of its optimizer group's largest entry, for a parameter whose gradient is that small). Matmuls, reductions and
# K1b's atomics sum in other orders on the two devices, and the finest levels amplify position rounding: a
# sample one ulp (6e-8) apart moves its corner weights at resolution 8,192 by about 5e-4. Measured: 7.5e-4 in
# the field's two finest static tables, 4.7e-4 in the actor positions, the loss 1.6e-6.
PARITY_GRAD_TOL = 1e-3


def parity_phase(outputs):
    """The `neurad-parity` preset at full width: hash-grid proposal fields (F =
    1), every table hashed at every level and unpacked, fp32 reads, MLPs and
    decoder. Serving through `closed_loop.build_state("neurad-parity")`
    (livened): a cold and three warm 1080p requests and two scans, K1f six
    times a chunk, one profiled request; training on the same pipeline:
    `init_state`, PARITY_TRAIN_STEPS steps of 57,344 rays in 7 chunks, then
    PARITY_LOOP_STEPS through `train_loop`, K1f and K1b six times a chunk,
    every group moved (the proposal tables too), one profiled step, a
    checkpoint served by `ClosedLoopState.from_run_dir`; then one train
    chunk of 1,024 rays on the card against the CPU with the same weights,
    batch and draws."""
    import dataclasses

    import numpy as np
    import torch

    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.core.structs import map_tensors
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.engine.optimizers import DEFAULT_GROUP_RULES, label_params
    from neurad_tpu_torch.fields.neurad_encoding import NeuRADHashEncoding
    from neurad_tpu_torch.fields.neurad_field import NeuRADProposalField
    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline, ChunkDraws
    from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState, build_state
    from neurad_tpu_torch.scripts.train import train_loop, write_run_config

    res = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = build_state("neurad-parity", device=DEVICE, seed=SEED, outputs=outputs)
    pipeline, model = state.pipeline, state.pipeline.model
    _liven(model)
    _sync()
    res["pipeline_s"] = time.perf_counter() - t0

    # ---- the preset's grids ----
    shapes = lambda tables: [tuple(t.shape) for t in tables]
    field = model.field.hashgrid
    props = list(model.proposal_fields)
    require(shapes(field.static_hash_table) == [(2**22, 4)] * 8, "field static: 8 levels of 2^22 hashed slots, F = 4")
    require(shapes(field.actor_hash_table) == [(2**17, 4)] * 4, "field actor: 4 levels of 2^17 hashed slots, F = 4")
    require(len(props) == 2 and all(isinstance(f, NeuRADProposalField) for f in props), "two hash proposal fields")
    for f in props:
        require(shapes(f.hashgrid.static_hash_table) == [(2**20, 1)] * 6, "proposal: 6 levels of 2^20 slots, F = 1")
        require(shapes(f.hashgrid.actor_hash_table) == [(2**15, 1)] * 4, "actor proposal: 4 levels of 2^15, F = 1")
    grids = [g for m in model.modules() if isinstance(m, NeuRADHashEncoding) for g in (m.static_grid, m.actor_grid)]
    require(len(grids) == 6 and all(g.gather_dtype is None and g.force_hash and not g.cell_packed for g in grids),
            "every grid hashed at every level, unpacked, read in fp32")
    require(all(g.copies is None for g in grids), "the serving state keeps no bf16 copy of fp32 tables")
    table_entries = sum(p.numel() for n, p in model.named_parameters() if "hash_table" in n)
    n_params = sum(p.numel() for p in model.parameters())
    require(table_entries == 8 * 2**22 * 4 + 4 * 2**17 * 4 + 2 * (6 * 2**20 + 4 * 2**15), "the tables' entries")
    require(model.field.mlp_geo.compute_dtype is None and model.rgb_decoder.compute_dtype == torch.float32,
            "fp32 field MLPs and decoder")
    res.update(parameters=n_params, table_entries=table_entries)
    log(f"[parity] pipeline in {res['pipeline_s']:.1f} s: {n_params / 1e6:.1f} M parameters, {table_entries / 1e6:.1f} M "
        f"of them in 2 x 6 + 12 fp32 tables ({table_entries * 4 / 2**20:.0f} MiB)")

    # ---- serving: a cold and warm 1080p requests, scans ----
    hs, ws = HEIGHT // 3, WIDTH // 3
    cam_chunks = -(-(hs * ws) // NEURAD_CHUNK)
    c2w_all = outputs.cameras.camera_to_worlds.numpy()
    times = outputs.cameras.times[:, 0].numpy()
    requests = []
    HE.reset_launch_counts()
    for i in range(PARITY_REQUESTS):
        pose = np.eye(4, dtype=np.float32)
        pose[:3] = c2w_all[i % len(c2w_all)]
        pose[:3, 3] += pose[:3, 0] * 0.5 * i
        before = HE.hash_grid_launches
        img = state.render_image(pose.tolist(), float(times[i % len(times)]) + 0.05 * i, "front_camera")
        launched = HE.hash_grid_launches - before
        require(img.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(img).all()) and 0.0 <= float(img.min())
                and float(img.max()) <= 1.0, "a finite 1080p image in [0, 1]")
        require(launched == PARITY_K1 * cam_chunks, f"K1f launched {PARITY_K1} times a chunk ({launched} in "
                                                     f"{cam_chunks} chunks)")
        requests.append(dict(render_ms=state.last_render_seconds * 1e3, launches=launched, std=float(img.std())))
        log(f"[parity] camera request {i} ({'cold' if i == 0 else 'warm'}): {requests[-1]['render_ms']:.1f} ms "
            f"(synchronised, incl. copy to host), {launched} K1f launches in {cam_chunks} chunks, image std "
            f"{img.std():.3f}")
    require(requests[-1]["std"] > 0.02, "the picture is not flat")
    n_pts = int(outputs.point_clouds[0].shape[0])
    lidar_chunks = -(-n_pts // NEURAD_CHUNK)
    scans = []
    for _ in range(PARITY_SCANS):
        before = HE.hash_grid_launches
        _sync()
        t_l = time.perf_counter()
        lid = pipeline.render_eval_lidar(0)
        scans.append((time.perf_counter() - t_l) * 1e3)
        require(HE.hash_grid_launches - before == PARITY_K1 * lidar_chunks, "K1f six times a lidar chunk")
        require(all(lid[k].shape == (n_pts, 1) and bool(np.isfinite(lid[k]).all())
                    for k in ("depth", "intensity", "ray_drop_logits")), "finite lidar outputs, one per point")
    serve_k1f = HE.hash_grid_launches
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[parity] scan: {n_pts} returns in {lidar_chunks} chunks, {', '.join(f'{t:.1f}' for t in scans)} ms; K1f "
        f"launches on the serving path {serve_k1f}; peak device memory {serve_peak:.2f} GiB")
    prof = profiled("parity camera request", lambda: state.render_image(pose.tolist(), float(times[1]), "front_camera"),
                    rows=18, match=HASH_KERNEL)
    require(prof["matched_launches"] == PARITY_K1 * cam_chunks, "the profile shows K1f's launches")
    res["serve"] = dict(requests=requests, scan_ms=scans, lidar_returns=n_pts, camera_chunks=cam_chunks,
                        lidar_chunks=lidar_chunks, k1f_per_chunk=PARITY_K1, launches=serve_k1f, peak_memory_gib=serve_peak,
                        busy_share=prof["device_busy_ms"] / prof["host_ms"], k1f_profile_ms=prof["matched_ms"],
                        profile={k: v for k, v in prof.items() if k != "all"})
    log(f"[parity] profiled request: K1f {prof['matched_ms']:.3f} ms in {prof['matched_launches']} launches, the "
        f"device busy {100 * res['serve']['busy_share']:.0f}% (profiler on)")

    # ---- training on the same pipeline ----
    cfg = pipeline.config
    torch.cuda.reset_peak_memory_stats()
    tstate = pipeline.init_state()
    n_rays = pipeline.num_cam_rays + cfg.datamanager.num_lidar_rays
    n_chunks = -(-n_rays // cfg.train_ray_chunk)
    require(n_rays == 57344 and n_chunks == 7 and pipeline.vgg is not None, "57,344 rays in 7 chunks, VGG on")
    groups = sorted(set(tstate.optimizers.labels.values()))
    require("camera_opt" not in groups, "the camera optimizer is off")
    # the field's 512 MiB of static tables compared on their first rows, every other parameter whole
    head = lambda n, p: p.detach()[:4096] if n.startswith("field.hashgrid.static") else p.detach()
    before = {n: head(n, p).clone() for n, p in model.named_parameters()}
    steps = []
    HE.reset_launch_counts()
    for i in range(PARITY_TRAIN_STEPS):
        bundle, batch = pipeline.datamanager.next_train()
        f0, b0 = HE.hash_grid_launches, HE.hash_grid_bwd_launches
        _sync()
        t1 = time.perf_counter()
        tstate, metrics = pipeline.train_step(tstate, bundle, batch)
        _sync()
        ms = (time.perf_counter() - t1) * 1e3
        fwd, bwd = HE.hash_grid_launches - f0, HE.hash_grid_bwd_launches - b0
        loss = float(metrics["total_loss"])
        require(math.isfinite(loss), f"parity step {tstate.step}: a finite loss")
        require(fwd == bwd == PARITY_K1 * n_chunks, f"K1f and K1b {PARITY_K1} times a chunk ({fwd}, {bwd})")
        steps.append(dict(step=tstate.step, ms=ms, total_loss=loss, k1f=fwd, k1b=bwd,
                          interlevel_loss=float(metrics["interlevel_loss"])))
        log(f"[parity] train step {tstate.step}: {ms:.1f} ms (synchronised{', the first' if i == 0 else ''}), loss "
            f"{loss:.5f}, interlevel {steps[-1]['interlevel_loss']:.5f}; K1f {fwd}, K1b {bwd}")
    warm = [st["ms"] for st in steps[1:]]
    trainer = METHODS["neurad-parity"]().trainer
    trainer.max_num_iterations, trainer.steps_per_log, trainer.steps_per_save = (
        tstate.step + PARITY_LOOP_STEPS, 1, 10**9)
    tstate, history = train_loop(pipeline, tstate, trainer, OUT_DIR)
    require(len(history) == PARITY_LOOP_STEPS and all(math.isfinite(h["total_loss"]) for h in history),
            "the train loop's steps have finite losses")
    train_launches = {"hash_grid": HE.hash_grid_launches, "hash_grid_bwd": HE.hash_grid_bwd_launches}
    require(train_launches["hash_grid_bwd"] == PARITY_K1 * n_chunks * (PARITY_TRAIN_STEPS + PARITY_LOOP_STEPS),
            "every step of the loop ran K1b six times a chunk")
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    moved = {}
    for n, p in model.named_parameters():
        now = head(n, p)
        label = tstate.optimizers.labels[n]
        moved[label] = max(moved.get(label, 0.0), float((now - before[n]).abs().max()))
        require(bool(torch.isfinite(p).all()), f"{n} finite after training")
    prop_moved = [float((p.detach() - before[n]).abs().max()) for n, p in model.named_parameters()
                  if n.startswith("proposal_fields.") and "hash_table" in n]
    require(all(v > 0 for v in moved.values()) and set(moved) == set(groups), f"every group moved: {moved}")
    require(min(prop_moved[:6]) > 0 and min(prop_moved[10:16]) > 0, "every proposal field's static tables moved")
    loop_rates = [h["train_rays_per_sec"] for h in history]
    log(f"[parity] warm steps {min(warm):.1f}-{max(warm):.1f} ms ({n_rays * len(warm) / (sum(warm) / 1e3):.0f} rays/s), "
        f"train_loop {', '.join(f'{r:.0f}' for r in loop_rates)} rays/s; peak {train_peak:.2f} GiB; largest change by "
        f"group {moved}")
    prof = profiled("parity train step", lambda: pipeline.train_step(tstate, *pipeline.datamanager.next_train()),
                    rows=25, match=HASH_BWD_KERNEL)
    k1f_ms = sum(ms for name, ms, _ in prof["all"] if HASH_KERNEL in name)
    require(prof["matched_launches"] == PARITY_K1 * n_chunks, "the profile shows K1b's launches")
    res["train"] = dict(steps=steps, rays=n_rays, chunks=n_chunks, warm_rays_per_s=n_rays * len(warm) / (sum(warm) / 1e3),
                        loop_rays_per_s=loop_rates, peak_memory_gib=train_peak,
                        launches=train_launches, moved=moved, busy_share=prof["device_busy_ms"] / prof["host_ms"],
                        k1b_profile_ms=prof["matched_ms"], k1f_profile_ms=k1f_ms,
                        profile={k: v for k, v in prof.items() if k != "all"})
    log(f"[parity] profiled step: K1b {prof['matched_ms']:.3f} ms in {prof['matched_launches']}, K1f {k1f_ms:.3f} ms; "
        f"the device busy {100 * res['train']['busy_share']:.0f}% (profiler on)")
    res["launches"] = {"hash_grid": serve_k1f + train_launches["hash_grid"],
                       "hash_grid_bwd": train_launches["hash_grid_bwd"]}

    run_dir = write_run_config(RUNS / "parity", "neurad-parity", SyntheticDataParserConfig(**SCENE), cfg, SEED)
    ckpt = pipeline.save_checkpoint(tstate, run_dir / "checkpoints")
    trained = {n: p.detach().cpu() for n, p in model.named_parameters() if n.startswith("proposal_fields.")}
    del state, pipeline, model, tstate, before
    gc.collect()
    torch.cuda.empty_cache()
    served = ClosedLoopState.from_run_dir(run_dir, device=DEVICE)
    pose = np.eye(4, dtype=np.float32)
    pose[:3] = c2w_all[1]
    img = served.render_image(pose.tolist(), float(times[1]), "front_camera")
    require(img.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(img).all()), "the checkpoint serves a finite image")
    require(all(torch.equal(p.detach().cpu(), trained[n]) for n, p in served.pipeline.model.named_parameters()
                if n in trained), "the checkpoint holds the trained proposal fields")
    res["checkpoint"] = dict(mib=ckpt.stat().st_size / 2**20, served_render_ms=served.last_render_seconds * 1e3)
    log(f"[parity] checkpoint {ckpt.name} ({res['checkpoint']['mib']:.0f} MiB) served: 1080p render "
        f"{res['checkpoint']['served_render_ms']:.1f} ms")
    del served, trained
    gc.collect()
    torch.cuda.empty_cache()

    # ---- one train chunk on the card against the CPU ----
    ref_cfg = METHODS["neurad-parity"]().pipeline
    ref_cfg.seed = SEED
    ref_cfg.datamanager = dataclasses.replace(ref_cfg.datamanager, **PARITY_REF)
    ref_cfg.train_ray_chunk = 1024
    gpu, cpu = ADPipeline(outputs, ref_cfg, device=DEVICE), ADPipeline(outputs, ref_cfg, device="cpu")
    _liven(gpu.model)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    bundle_c, batch_c = cpu.datamanager.next_train()
    n_ref = bundle_c.origins.shape[0]
    require(n_ref == 1024 and len(cpu._chunks(n_ref)) == 1, "one train chunk of 1,024 rays")
    draws = cpu.draw(torch.Generator().manual_seed(SEED), n_ref)
    inputs = {"cuda": (map_tensors(lambda x: x.to(DEVICE), bundle_c), {k: v.to(DEVICE) for k, v in batch_c.items()},
                       [ChunkDraws(tuple(j.to(DEVICE) for j in d.jitters), d.flip.to(DEVICE)) for d in draws]),
              "cpu": (bundle_c, batch_c, draws)}
    losses, grads = {}, {}
    for dev, pipe in (("cuda", gpu), ("cpu", cpu)):
        pipe.model.zero_grad()
        f0, b0 = HE.hash_grid_launches, HE.hash_grid_bwd_launches
        total, _ = pipe.loss_fn(*inputs[dev])
        total.backward()
        if dev == "cuda":
            _sync()
            require((HE.hash_grid_launches - f0, HE.hash_grid_bwd_launches - b0) == (PARITY_K1, PARITY_K1),
                    "the card's chunk went through K1f and K1b six times each")
        losses[dev] = float(total.detach())
        grads[dev] = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                      for n, p in pipe.model.named_parameters()}
    labels = label_params(grads["cpu"], DEFAULT_GROUP_RULES)
    group_max = {}
    for n, g in grads["cpu"].items():
        group_max[labels[n]] = max(group_max.get(labels[n], 0.0), float(g.abs().max()))
    rel = {}
    for n, g in grads["cpu"].items():
        scale = max(float(g.abs().max()), 1e-3 * group_max[labels[n]])
        if scale > 0:
            rel[n] = float((grads["cuda"][n] - g).abs().max()) / scale
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    worst = sorted(rel, key=rel.get)[-3:]
    res["reference"] = dict(losses=losses, loss_rel_err=loss_err, grad_rel_err=rel, grad_tol=PARITY_GRAD_TOL)
    log(f"[parity] one chunk of {n_ref} rays, card against CPU: losses {losses['cuda']:.7f} / {losses['cpu']:.7f} "
        f"(relative {loss_err:.2e}); largest gradient errors over their parameters' largest entries: "
        f"{', '.join(f'{n} {rel[n]:.2e}' for n in worst)}; the tables' largest "
        f"{max(v for n, v in rel.items() if 'hash_table' in n):.2e}")
    require(loss_err <= PARITY_LOSS_TOL, f"the card's loss within {PARITY_LOSS_TOL:g} of the CPU's")
    require(all(bool(torch.isfinite(g).all()) for g in grads["cuda"].values()), "finite gradients on the card")
    require(all(v <= PARITY_GRAD_TOL for v in rel.values()),
            f"every gradient within {PARITY_GRAD_TOL:g} of its parameter's largest entry: {rel}")
    del gpu, cpu, grads, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# eval phase
# ---------------------------------------------------------------------------


def eval_metrics_check(label, pipeline, keys, kernels, profile=False):
    """`pipeline.eval_metrics()` on a pipeline a train phase trained (the
    scene's eval camera and scan): timed on the host clock, synchronised,
    twice (the first apart), every value finite, the expected keys, and its
    renders through the ported kernels (`kernels`: the least launches of
    each counter, in the ops module that counts it); with `profile`, once
    more under torch.profiler."""
    import torch

    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.ops import tile_composite as TC

    counts = lambda: {"camera": TC.camera_launches, "lidar": TC.lidar_launches, "hash_grid": HE.hash_grid_launches}
    before = counts()
    times, metrics = [], None
    for _ in range(2):
        _sync()
        t0 = time.perf_counter()
        metrics = pipeline.eval_metrics()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    launched = {k: (v - before[k]) // 2 for k, v in counts().items() if k in kernels}
    log(f"[eval] {label} eval_metrics: first {times[0]:.1f} ms, then {times[1]:.1f} ms (synchronised); kernel launches "
        f"a call {launched}; " + ", ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items())))
    require(set(metrics) == keys and all(math.isfinite(v) for v in metrics.values()),
            f"{label} eval_metrics gives finite values for {sorted(keys)}")
    require(all(launched[k] >= n for k, n in kernels.items()), f"{label} eval renders ran the ported kernels")
    out = dict(metrics=metrics, first_ms=times[0], ms=times[1], launches=launched)
    if profile:
        prof = profiled(f"{label} eval_metrics", pipeline.eval_metrics, rows=20)
        out["profile"] = {k: v for k, v in prof.items() if k != "all"}
    torch.cuda.empty_cache()
    return out


def eval_script_check(run_dir, step, keys):
    """`python -m neurad_tpu_torch.scripts.eval <run_dir>`, in process through
    its entry point: the JSON it writes holds the checkpoint's step and
    finite results with the expected keys."""
    from neurad_tpu_torch.scripts import eval as eval_script

    t0 = time.perf_counter()
    res = eval_script.entrypoint([str(run_dir)])
    seconds = time.perf_counter() - t0
    written = json.loads((Path(run_dir) / "eval.json").read_text())
    log(f"[eval] scripts.eval on the run directory: {seconds:.1f} s (the pipeline's build and load included), "
        f"checkpoint step {written['checkpoint_step']}")
    require(written == res and written["checkpoint_step"] == step and set(written["results"]) == keys and
            all(math.isfinite(v) for v in written["results"].values()),
            "scripts.eval wrote the checkpoint's step and finite results")
    return dict(seconds=seconds, json=written)


# ---------------------------------------------------------------------------
# render, export and viewer phases: the train phases' runs through the scripts
# ---------------------------------------------------------------------------


class RunCache:
    """`scripts.train.load_run` while the render, export and viewer phases
    run: a run directory's first load is the real one (timed); later entry
    points get the same pipeline back, so each run loads once and the written
    files are checked against the pipeline that wrote them."""

    def __init__(self):
        from neurad_tpu_torch.scripts import train

        self.train, self.real = train, train.load_run
        self.pipelines, self.load_s = {}, {}

    def __enter__(self):
        self.train.load_run = self.load
        return self

    def __exit__(self, *exc):
        self.train.load_run = self.real
        self.pipelines.clear()

    def load(self, run_dir, device="cuda", with_state=False):
        key = str(Path(run_dir).resolve())
        if key not in self.pipelines:
            t0 = time.perf_counter()
            self.pipelines[key] = self.real(run_dir, device=device)[0]
            _sync()
            self.load_s[key] = time.perf_counter() - t0
        return self.pipelines[key], None


def _launch_counts():
    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.ops import tile_composite as TC

    return {"camera": TC.camera_launches, "lidar": TC.lidar_launches, "hash_grid": HE.hash_grid_launches}


def _reset_launch_counts():
    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.ops import tile_composite as TC

    TC.reset_launch_counts()
    HE.reset_launch_counts()


class Counted:
    """The K1f, K2 and K4 launches of a path's own calls: every count is set
    to 0 as a `with` block opens and read as it closes, and `counts` sums the
    blocks. Calls outside a block (the checks' reference renders, timings,
    profiles) are not counted."""

    def __init__(self):
        self.counts = {"camera": 0, "lidar": 0, "hash_grid": 0}

    def __enter__(self):
        _reset_launch_counts()
        return self

    def __exit__(self, *exc):
        for k, v in _launch_counts().items():
            self.counts[k] += v


def _ply_header(path):
    """(element counts {name: n}, property names of the vertex element, byte offset of the data) of a PLY."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    counts, props, element = {}, [], None
    for line in data[:end].decode().splitlines():
        parts = line.split()
        if parts[0] == "element":
            element = parts[1]
            counts[element] = int(parts[2])
        elif parts[0] == "property" and element == "vertex":
            props.append(parts[-1])
    return counts, props, end


def _frame_split(pipeline, cam_idx, png_path, reps=2, memory=False):
    """A 1080p eval frame's time split on the host clock, synchronised:
    render on the device, the copy to the host, PNG encode and write
    (`scripts.render._save_image`); the medians of `reps` warm frames, ms.
    With `memory`, the host memory of `scripts.render`'s PNG writes at this
    frame size (numpy's allocations, traced): the peak of quantising a frame
    on the main thread and of encoding one in a write thread, and the most
    the writes hold at once, which is the same for any number of frames: the
    float frame and its quantising, 2 x workers queued uint8 frames, and
    workers encodes."""
    import os
    import tracemalloc

    import torch

    from neurad_tpu_torch.data.png import quantise, write_png
    from neurad_tpu_torch.scripts import render

    parts = {"render": [], "to_host": [], "png": []}
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            rgb = pipeline._render_camera(cam_idx)
        rgb = rgb[0] if isinstance(rgb, tuple) else rgb
        _sync()
        t1 = time.perf_counter()
        host = rgb.cpu().numpy()
        t2 = time.perf_counter()
        render._save_image(png_path, host)
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(dt * 1e3)
    out = {k: statistics.median(v) for k, v in parts.items()}
    out["shape"] = list(host.shape)
    if memory:
        tracemalloc.start()
        image = quantise(host)
        quantise_peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        write_png(png_path, image)
        encode_peak = tracemalloc.get_traced_memory()[1] - base
        tracemalloc.stop()
        workers = min(8, os.cpu_count() or 1)
        out["host_memory_mib"] = dict(
            frame_f32=host.nbytes / 2**20, quantise_peak=quantise_peak / 2**20, frame_u8=image.nbytes / 2**20,
            encode_peak=encode_peak / 2**20, workers=workers,
            writes_most=(host.nbytes + quantise_peak + 2 * workers * image.nbytes + workers * encode_peak) / 2**20)
    return out


def render_phase(cache, runs):
    """`scripts.render` on the SplatAD and NeuRAD runs of the train phases
    (full width, 1920x1080 cameras, the 64x1024-beam scan): every camera of
    the scene, the lidar as .npz and BEV PNGs, an interpolated path
    (INTERPOLATE steps a pair of cameras), a camera-path JSON of RENDER_POSES
    poses and an actor shift of 1 m; then a lane shift of 1 m. Every camera
    PNG, decoded by `read_png`, equals the quantised `render_eval_camera` of
    the pipeline that wrote it; the actor and lane shifts change the eval
    camera's image; the counters show K2 and K4 (SplatAD) and K1f (NeuRAD)."""
    import numpy as np
    import torch

    from neurad_tpu_torch.data.png import quantise, read_png
    from neurad_tpu_torch.scripts import render

    results = {}
    for name, run_dir in runs.items():
        pipeline = cache.load(run_dir, device=DEVICE)[0]
        outputs, parsed = pipeline.outputs, pipeline.outputs.cameras
        n_cams, eval_ci = len(outputs.images), list(outputs.eval_camera_indices)[0]
        c2w = np.eye(4)
        c2w[:3] = parsed.camera_to_worlds[eval_ci].numpy()
        if name == "neurad":  # the scene's actor is out of the NeuRAD field's sight: 2.5 m ahead, as neurad_phase puts it
            ahead = c2w[:3, 3] + c2w[:3, :3] @ np.array([0.0, -0.3, -2.5])
            with torch.no_grad():
                pipeline.model.actors.actor_positions[:] = torch.as_tensor(ahead, dtype=torch.float32)
        unedited = quantise(pipeline.render_eval_camera(eval_ci)[0])
        frames = []
        for k in range(RENDER_POSES):  # forward along the camera's view, 0.5 m a pose
            pose = c2w.copy()
            pose[:3, 3] -= pose[:3, 2] * 0.5 * k
            frames.append({"camera_to_world": pose.reshape(-1).tolist(), "render_time": float(parsed.times[eval_ci, 0])})
        path_json = RUNS / f"{name}_camera_path.json"
        path_json.write_text(json.dumps({"camera_path": frames}))
        out_dir, shift_dir = RUNS / f"{name}_renders", RUNS / f"{name}_renders_shift"
        counted, shift_counted = Counted(), Counted()
        t0 = time.perf_counter()
        with counted:
            render.entrypoint([str(run_dir), "--device", DEVICE, "--output-dir", str(out_dir), "--cameras", "all",
                               "--lidar", "--lidar-bev", "--interpolate", str(INTERPOLATE), "--camera-path",
                               str(path_json), "--actor-shift", "1,0,0"])
            _sync()
        seconds = time.perf_counter() - t0
        n_path = (n_cams - 1) * INTERPOLATE
        written = sorted(p.name for p in out_dir.iterdir())
        want = ([f"camera_{i:04d}{s}.png" for i in range(n_cams) for s in ("", "_gt")]
                + [f"campath_{k:05d}.png" for k in range(RENDER_POSES)] + [f"path_{f:05d}.png" for f in range(n_path)]
                + [f"lidar_{s:04d}{e}" for s in outputs.eval_lidar_indices
                   for e in (".npz", "_pred_bev.png", "_gt_bev.png")])
        require(written == sorted(want), f"{name}: scripts.render wrote {written}")
        for ci in range(n_cams):
            got = read_png(out_dir / f"camera_{ci:04d}.png")
            require(np.array_equal(got, quantise(pipeline.render_eval_camera(ci)[0])),
                    f"{name}: camera_{ci:04d}.png equals the quantised render_eval_camera")
        edited = read_png(out_dir / f"camera_{eval_ci:04d}.png")
        actor_px = int((edited != unedited).any(-1).sum())
        require(actor_px > 0, f"{name}: the actor shift changes the eval camera's image")
        scan = np.load(out_dir / f"lidar_{outputs.eval_lidar_indices[0]:04d}.npz")
        require(bool(np.isfinite(scan["depth"]).all()), f"{name}: the scan's depths are finite")

        with shift_counted:
            render.entrypoint([str(run_dir), "--device", DEVICE, "--output-dir", str(shift_dir), "--shift", "1.0"])
        shifted = read_png(shift_dir / f"camera_{eval_ci:04d}.png")
        require(np.array_equal(shifted, quantise(pipeline.render_eval_camera(eval_ci)[0])),
                f"{name}: the lane-shifted PNG equals the quantised render of the shifted camera")
        require(not np.array_equal(shifted, edited), f"{name}: the lane shift changes the image")
        launched = {k: counted.counts[k] + shift_counted.counts[k] for k in counted.counts}
        pipeline.outputs.cameras = parsed  # the parsed cameras back (the lane shift leaves its cameras moved)
        split = _frame_split(pipeline, eval_ci, RUNS / f"{name}_frame.png", memory=name == "splatad")
        log(f"[render] {name}: scripts.render ({n_cams} cameras, {RENDER_POSES} path poses, {n_path} interpolated, "
            f"lidar + BEV, actor shift) {seconds:.1f} s after a load of {cache.load_s[str(Path(run_dir).resolve())]:.1f} s; "
            f"the actor shift changed {actor_px} pixels; a {split['shape'][1]}x{split['shape'][0]} frame: render "
            f"{split['render']:.1f} ms, copy to host {split['to_host']:.1f} ms, PNG encode + write {split['png']:.1f} ms; "
            f"launches of the two scripts.render runs {launched} (the first {counted.counts})"
            + (f"; host memory of the PNG writes (MiB) {split['host_memory_mib']}" if "host_memory_mib" in split else ""))
        results[name] = dict(seconds=seconds, load_s=cache.load_s[str(Path(run_dir).resolve())], files=len(written),
                             actor_shift_pixels=actor_px, frame_ms=split, launches=launched)
    by_run = {name: r["launches"] for name, r in results.items()}
    require(by_run["splatad"]["camera"] > 0 and by_run["splatad"]["lidar"] > 0,
            f"the SplatAD run's scripts.render ran K2 and K4 ({by_run['splatad']})")
    require(by_run["neurad"]["hash_grid"] > 0, f"the NeuRAD run's scripts.render ran K1f ({by_run['neurad']})")
    return dict(runs=results, launches={k: sum(r[k] for r in by_run.values()) for k in by_run["neurad"]})


def _device_timed(obj, name, box):
    """Put a wrapper of `obj.<name>` on the instance that adds the call's
    synchronised host time to box["s"] and the K1f launches of each call to
    box["k1f"]; undone by deleting the attribute."""
    fn = getattr(obj, name)

    def wrapper(*a, **k):
        _sync()
        t0, f0 = time.perf_counter(), _launch_counts()["hash_grid"]
        out = fn(*a, **k)
        _sync()
        box["s"] += time.perf_counter() - t0
        box.setdefault("k1f", []).append(_launch_counts()["hash_grid"] - f0)
        return out

    object.__setattr__(obj, name, wrapper)


def export_phase(cache, runs):
    """`scripts.export` in every mode on the train phases' runs: field-mesh,
    tsdf-mesh and poisson at --resolution EXPORT_RESOLUTION on the NeuRAD run
    (the field's geometry on the r^3 grid in chunks of 131,072 points; depth
    renders of the eval camera), pointcloud, gaussian-splat and camera-poses
    on the SplatAD run. Per mode: seconds, of them the device's (renders and
    field queries, synchronised) and the host's (fusion, FFT, marching
    tetrahedra, writing), peak device memory. The field mesh's K1f launches
    equal its chunks times the lookups of a query (static and actor grid);
    the splat PLY read back equals the model's parameters; each mesh has
    vertices and faces."""
    import numpy as np
    import torch

    from neurad_tpu_torch.scripts import export

    modes = (("field-mesh", "neurad"), ("tsdf-mesh", "neurad"), ("poisson", "neurad"), ("pointcloud", "splatad"),
             ("gaussian-splat", "splatad"), ("camera-poses", "splatad"))
    results, by_run = {}, {"splatad": Counted(), "neurad": Counted()}
    for mode, name in modes:
        pipeline = cache.load(runs[name], device=DEVICE)[0]
        box = {"s": 0.0}
        hooks = [(pipeline.model, "query_geometry")] if mode == "field-mesh" else [
            (pipeline, "_chunked_nff")] if mode in ("tsdf-mesh", "poisson") else [
            (pipeline, "render_eval_lidar")] if mode == "pointcloud" else []
        for obj, attr in hooks:
            _device_timed(obj, attr, box)
        torch.cuda.reset_peak_memory_stats()
        out = RUNS / f"export_{mode}.ply"
        t0 = time.perf_counter()
        try:
            with by_run[name]:
                written = export.entrypoint([mode, str(runs[name]), "--device", DEVICE, "--output", str(out),
                                             "--resolution", str(EXPORT_RESOLUTION)])
        finally:
            for obj, attr in hooks:
                object.__delattr__(obj, attr)
        seconds = time.perf_counter() - t0
        rec = dict(seconds=seconds, device_s=box["s"], host_s=seconds - box["s"], bytes=written.stat().st_size,
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        if mode == "camera-poses":
            frames = json.loads(written.read_text())["frames"]
            require(len(frames) == len(pipeline.outputs.images), "camera-poses: a frame a camera")
        else:
            counts, props, offset = _ply_header(written)
            rec["elements"] = counts
            if mode.endswith("mesh") or mode == "poisson":
                require(counts.get("vertex", 0) > 0 and counts.get("face", 0) > 0, f"{mode}: the mesh has vertices "
                        f"and faces ({counts})")
            else:
                require(counts["vertex"] > 0, f"{mode}: points written")
        if mode == "field-mesh":
            r = EXPORT_RESOLUTION
            n_chunks = -(-r**3 // 131072)
            per_query = 1 + (pipeline.model.actors.n_actors > 0)
            rec.update(chunks=n_chunks, k1f_per_query=box["k1f"])
            require(len(box["k1f"]) == n_chunks and sum(box["k1f"]) == n_chunks * per_query,
                    f"field-mesh: K1f launched {box['k1f']}, {per_query} a query of each of {n_chunks} chunks")
            lo, hi = pipeline.outputs.scene_box.aabb.to(DEVICE)
            pts = lo + (hi - lo) * torch.rand((131072, 3), generator=torch.Generator(DEVICE).manual_seed(SEED),
                                              device=DEVICE)
            with torch.no_grad():
                prof = profiled("field-mesh query chunk", lambda: pipeline.model.query_geometry(pts, 0.0),
                                match=HASH_KERNEL, rows=8)
            rec["query_profile"] = {k: v for k, v in prof.items() if k != "all"}
        if mode == "gaussian-splat":
            data = np.frombuffer(written.read_bytes()[offset:], dtype="<f4").reshape(counts["vertex"], len(props))
            params = {n: p.detach().cpu().numpy() for n, p in pipeline.model.named_parameters()}
            cols = dict(zip(props, data.T))
            want = np.concatenate([params["means"], params["scales"], params["quats"], params["opacities"][:, None],
                                   params["features"][:, :16]], axis=1)
            got = np.stack([cols[p] for p in props], axis=1)
            require(got.shape == want.shape and np.array_equal(got, want.astype(np.float32)),
                    "the splat PLY read back equals the model's parameters")
        log(f"[export] {mode} ({name}): {seconds:.2f} s, device {box['s']:.2f} s, host {seconds - box['s']:.2f} s, "
            f"{rec['bytes'] / 2**20:.1f} MiB, peak device memory {rec['peak_memory_gib']:.2f} GiB"
            + (f", {rec['elements']}" if "elements" in rec else ""))
        results[mode] = rec
    require(by_run["neurad"].counts["hash_grid"] > 0 and by_run["splatad"].counts["lidar"] > 0,
            f"the exports ran K1f (NeuRAD: {by_run['neurad'].counts}) and K4 (SplatAD: {by_run['splatad'].counts})")
    return dict(modes=results, launches={k: sum(c.counts[k] for c in by_run.values()) for k in by_run["neurad"].counts},
                by_run={n: c.counts for n, c in by_run.items()})


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post_png(url, payload):
    """POST a viewer render -> (reply, decoded image or None, seconds)."""
    import base64
    from neurad_tpu_torch.data.png import read_png

    t0 = time.perf_counter()
    out = _post(url, payload)
    seconds = time.perf_counter() - t0
    if "png" not in out:
        return out, None, seconds
    with tempfile.NamedTemporaryFile(suffix=".png") as f:
        f.write(base64.b64decode(out["png"]))
        f.flush()
        return out, read_png(f.name), seconds


def viewer_phase(cache, runs):
    """The viewer on the train phases' runs (`scripts.viewer.serve_run`:
    NeuRAD with bf16 table copies) on a free port: /render low (96x64) and
    high (384x256) equal the quantised direct `render_viewer_image`, the
    round trips timed (each request has its own server thread; the first
    request of a server apart), /lidar, /export and /train answer, and an
    older request of one client is dropped. Then SplatAD trains
    VIEWER_TRAIN_STEPS steps through `Trainer` without a viewer and as many
    with the train script's live viewer (`_start_viewer`, util 0.9) while a
    client thread posts renders: every step runs, every render completes
    inside the lock and outside a step."""
    import threading

    import numpy as np
    import torch

    from neurad_tpu_torch.data.png import quantise
    from neurad_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from neurad_tpu_torch.scripts import train as train_script
    from neurad_tpu_torch.scripts import viewer

    results, by_run = {}, {"splatad": Counted(), "neurad": Counted()}
    edits = {"lateral": 0.5}
    for name in ("splatad", "neurad"):
        counted = by_run[name]  # the HTTP requests' renders only, not the direct ones beside them
        port = _free_port()
        server, pipeline = viewer.serve_run(runs[name], port=port, device=DEVICE)
        server.start(background=True)
        url = f"http://127.0.0.1:{port}"
        cams = pipeline.outputs.cameras
        pose = cams.camera_to_worlds[0].numpy()
        t = 0.3
        rec = {}
        try:
            seq = 0
            for quality, (w, h) in (("low", (96, 64)), ("high", (384, 256))):
                trips = []
                for _ in range(4):
                    seq += 1
                    with counted:
                        reply, img, s = _post_png(url + "/render", {"pose": pose.tolist(), "quality": quality,
                                                                    "t01": t, "edits": edits, "client": "smoke",
                                                                    "seq": seq})
                    require(img is not None and reply["status"] == f"{w}x{h}", f"{name} {quality}: a PNG came back")
                    trips.append(s * 1e3)
                direct = pipeline.render_viewer_image(pose, w, h, t * pipeline.outputs.duration, viewer.edits_vec(edits))
                require(np.array_equal(img, quantise(direct)),
                        f"{name} {quality}: the viewer's PNG equals the quantised direct render_viewer_image")
                direct_ms = []
                for _ in range(3):
                    _sync()
                    t0 = time.perf_counter()
                    pipeline.render_viewer_image(pose, w, h, t * pipeline.outputs.duration, viewer.edits_vec(edits))
                    _sync()
                    direct_ms.append((time.perf_counter() - t0) * 1e3)
                rec[quality] = dict(first_ms=trips[0], warm_ms=trips[1:], direct_ms=direct_ms, shape=list(img.shape))
                if quality == "high":
                    kernel = HASH_KERNEL if name == "neurad" else CAMERA_KERNEL
                    prof = profiled(f"{name} viewer {w}x{h}", lambda: pipeline.render_viewer_image(
                        pose, w, h, t * pipeline.outputs.duration, viewer.edits_vec(edits)), match=kernel, rows=8)
                    rec[quality]["profile"] = {k: v for k, v in prof.items() if k != "all"}
                log(f"[viewer] {name} {quality} {w}x{h} -> {img.shape[1]}x{img.shape[0]} PNG: round trip first "
                    f"{trips[0]:.1f} ms, then {', '.join(f'{v:.1f}' for v in trips[1:])} ms; direct render (warm, "
                    f"synchronised) {', '.join(f'{v:.1f}' for v in direct_ms)} ms")
            # drop threshold 1: every beam's point comes back (random weights may predict every beam dropped)
            with counted:
                t0 = time.perf_counter()
                pts = _post(url + "/lidar", {"t01": t, "channels": 32, "azim_res": 1.0, "drop_threshold": 1.0})["pts"]
                rec["lidar_ms"] = (time.perf_counter() - t0) * 1e3
                exported = _post(url + "/export", {})
                stats = _post(url + "/train", {})
                newer, _, _ = _post_png(url + "/render", {"pose": pose.tolist(), "client": "c", "seq": 100})
                older, _, _ = _post_png(url + "/render", {"pose": pose.tolist(), "client": "c", "seq": 99})
            require(len(pts) > 0 and all(len(p) == 4 for p in pts[:10]), f"{name}: /lidar gave points")
            require(exported == {"path": None}, f"{name}: /export without an export hook")
            require(stats["paused"] is False and stats["train_util"] == 0.9, f"{name}: /train answers")
            require("png" in newer and older.get("stale") is True, f"{name}: the older request of a client is dropped")
            log(f"[viewer] {name}: /lidar {len(pts)} points in {rec['lidar_ms']:.1f} ms; /export, /train and the stale "
                f"drop answered")
        finally:
            server.stop()
        rec["launches"] = counted.counts
        results[name] = rec
    require(by_run["splatad"].counts["camera"] > 0 and by_run["splatad"].counts["lidar"] > 0
            and by_run["neurad"].counts["hash_grid"] > 0,
            f"the viewer's requests ran K2, K4 (SplatAD: {by_run['splatad'].counts}) and K1f "
            f"(NeuRAD: {by_run['neurad'].counts})")
    launches = {k: sum(c.counts[k] for c in by_run.values()) for k in by_run["neurad"].counts}

    # SplatAD training with the live viewer: steps without it, then with it and a client posting renders
    pipeline = cache.load(runs["splatad"], device=DEVICE)[0]
    state = pipeline.init_state()
    cfg = TrainerConfig(steps_per_log=1, steps_per_eval_batch=10**9, steps_per_save=10**9)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(pipeline, state, cfg)
    trainer.train(1, save_at_end=False)  # the first step apart
    t0 = time.perf_counter()
    trainer.train(1 + VIEWER_TRAIN_STEPS, save_at_end=False)
    _sync()
    off_s = time.perf_counter() - t0
    in_step, bad, renders, stop = [False], [], [], threading.Event()
    step_fn = pipeline.train_step

    def step(*a, **k):
        in_step[0] = True
        try:
            return step_fn(*a, **k)
        finally:
            in_step[0] = False

    pipeline.train_step = step
    port = _free_port()
    server = train_script._start_viewer(pipeline, RUNS / "splatad", port)
    render_fn = server.render_fn

    def checked_render(*a, **k):
        if not server.train_lock.locked() or in_step[0]:
            bad.append(len(renders))
        out = render_fn(*a, **k)
        renders.append(1)
        return out

    server.render_fn = checked_render
    url = f"http://127.0.0.1:{port}"

    def client():
        seq = 0
        while not stop.is_set():
            seq += 1
            _post(url + "/render", {"pose": pose.tolist(), "quality": "low", "t01": 0.1, "client": "train", "seq": seq})

    trainer.viewer = server
    thread = threading.Thread(target=client, daemon=True)
    try:
        thread.start()
        t0 = time.perf_counter()
        trainer.train(1 + 2 * VIEWER_TRAIN_STEPS, save_at_end=False)
        _sync()
        on_s = time.perf_counter() - t0
        stop.set()
        thread.join(timeout=60)
        exported = _post(url + "/export", {})["path"]
        stats = _post(url + "/train", {})
    finally:
        stop.set()
        server.stop()
        del pipeline.train_step
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(trainer.state.step == 1 + 2 * VIEWER_TRAIN_STEPS and len(trainer.history) == 1 + 2 * VIEWER_TRAIN_STEPS,
            "every step ran and logged, with the viewer on as without it")
    require(renders and not bad, f"every render during training completed inside the lock, outside a step "
            f"({len(renders)} renders, {len(bad)} not)")
    require(exported and Path(exported).stat().st_size > 0 and stats["step"] == 2 * VIEWER_TRAIN_STEPS,
            "the training viewer's /export wrote the splat PLY and /train shows the last step")
    train_rec = dict(steps=VIEWER_TRAIN_STEPS, off_steps_per_s=VIEWER_TRAIN_STEPS / off_s,
                     on_steps_per_s=VIEWER_TRAIN_STEPS / on_s, renders_during_training=len(renders),
                     peak_memory_gib=peak)
    log(f"[viewer] SplatAD through Trainer: {train_rec['off_steps_per_s']:.2f} steps/s without the viewer, "
        f"{train_rec['on_steps_per_s']:.2f} with it (util 0.9) and {len(renders)} renders from a client thread; "
        f"peak device memory {peak:.2f} GiB")
    results["train"] = train_rec
    return dict(servers=results, launches=launches)


def fid_phase():
    """`eval_fid_suite(max_images=FID_IMAGES)` of both models at full width on
    the scene cut to 8 frames, the last 2 held out (the FID of one image is
    NaN): SplatAD at 500,000 gaussians from the seed, NeuRAD at the `neurad`
    preset, livened. Timed, every value finite."""
    import torch

    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig

    outputs = SyntheticDataParserConfig(**FID_SCENE).setup().get_dataparser_outputs()
    require(len(outputs.eval_camera_indices) >= FID_IMAGES, f"the FID scene holds {FID_IMAGES} eval cameras")
    res = {}
    for label in ("splatad", "neurad"):
        if label == "splatad":
            pipeline = SplatADPipeline(outputs, SplatADPipelineConfig(cap_max=N_GAUSS, seed=SEED), device=DEVICE)
        else:
            cfg = METHODS["neurad"]().pipeline
            cfg.seed = SEED
            pipeline = ADPipeline(outputs, cfg, device=DEVICE)
            _liven(pipeline.model)
        _sync()
        t0 = time.perf_counter()
        fids = pipeline.eval_fid_suite(max_images=FID_IMAGES)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        log(f"[eval] {label} eval_fid_suite(max_images={FID_IMAGES}) at {WIDTH}x{HEIGHT}: {ms:.1f} ms; "
            + ", ".join(f"{k}={v:.5g}" for k, v in sorted(fids.items())))
        require(set(fids) == FID_KEYS and all(math.isfinite(v) for v in fids.values()),
                f"{label} eval_fid_suite gives finite values for {sorted(FID_KEYS)}")
        res[label] = dict(ms=ms, fid=fids)
        del pipeline
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _seeded_state(kind, rng):
    """A state dict (numpy) of the LPIPS (VGG16 + heads) or Inception network,
    He-scaled convolutions, batch norm near identity."""
    from neurad_tpu_torch.model_components import inception, lpips_exact

    conv = lambda o, i, kh, kw: (rng.normal(size=(o, i, kh, kw)) * math.sqrt(2.0 / (i * kh * kw))).astype("float32")
    small = lambda *shape: (rng.normal(size=shape) * 0.1).astype("float32")
    state = {}
    if kind == "lpips":
        for fi, i, o in lpips_exact._VGG16_CONVS:
            state[f"features.{fi}.weight"], state[f"features.{fi}.bias"] = conv(o, i, 3, 3), small(o)
        for i, c in enumerate(lpips_exact._HEAD_CH):
            state[f"lin{i}.model.1.weight"] = abs(small(1, c, 1, 1))
    else:
        for name, i, o, k, _s, _p in inception.conv_specs():
            state[f"{name}.conv.weight"] = conv(o, i, k[0], k[1])
            state[f"{name}.bn.weight"], state[f"{name}.bn.bias"] = 1.0 + small(o), small(o)
            state[f"{name}.bn.running_mean"], state[f"{name}.bn.running_var"] = small(o), abs(1.0 + small(o))
    return state


def metrics_reference_phase():
    """The metric functions on the card against the CPU on the same numpy
    inputs: the exact LPIPS (135x240 images) and the Inception pool3 features (299x299, and
    the resize path from 270x480) with seeded weights that the port's
    converter writes to .npz files, the VGG19 fallback LPIPS (seed 0) and the
    chamfer distance with masks. TF32 off; tolerances LPIPS_TOL, POOL3_TOL,
    CHAMFER_TOL."""
    import numpy as np
    import torch

    from neurad_tpu_torch.core.math_utils import chamfer_distance
    from neurad_tpu_torch.model_components import inception, lpips_exact
    from neurad_tpu_torch.model_components.perceptual import load_vgg19_params
    from neurad_tpu_torch.scripts import convert_perceptual_weights as convert
    from neurad_tpu_torch.utils.eval_metrics import lpips

    rng = np.random.default_rng(SEED)
    res = {}
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        np.savez(Path(tmp) / "lpips.npz", **convert.convert_lpips(_seeded_state("lpips", rng)))
        np.savez(Path(tmp) / "inception.npz", **convert.convert_inception(_seeded_state("inception", rng)))
        lp = {d: lpips_exact.load_lpips_params(str(Path(tmp) / "lpips.npz"), d) for d in ("cpu", DEVICE)}
        inc = {d: inception.load_inception_params(str(Path(tmp) / "inception.npz"), d) for d in ("cpu", DEVICE)}
    a, b = (rng.uniform(0, 1, (1, 135, 240, 3)).astype(np.float32) for _ in range(2))
    on = lambda x, d: torch.from_numpy(x).to(d)
    with torch.no_grad():
        got, want = (float(lpips_exact.lpips_exact(lp[d], on(a, d), on(b, d))) for d in (DEVICE, "cpu"))
        res["lpips_exact"] = dict(card=got, cpu=want, rel_err=abs(got - want) / abs(want))
        for name, hw, resize in (("pool3_299", (299, 299), False), ("pool3_resized", (270, 480), True)):
            img = rng.uniform(0, 1, (1, *hw, 3)).astype(np.float32)
            g, w = (inception.inception_pool3(inc[d], on(img, d), resize=resize).cpu().numpy() for d in (DEVICE, "cpu"))
            require(bool(np.allclose(g, w, **POOL3_TOL)), f"{name} features on the card match the CPU's")
            res[name] = dict(max_abs_err=float(np.abs(g - w).max()), max_abs=float(np.abs(w).max()))
        vgg = {d: load_vgg19_params(torch.Generator().manual_seed(0), device=d) for d in ("cpu", DEVICE)}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # the fallback's warning
            got, want = (float(lpips(vgg[d], on(a[0], d), on(b[0], d))) for d in (DEVICE, "cpu"))
        res["lpips_vgg19"] = dict(card=got, cpu=want, rel_err=abs(got - want) / abs(want))
        pred, gt = rng.normal(size=(8192, 3)).astype(np.float32) * 10, rng.normal(size=(6000, 3)).astype(np.float32) * 10
        pm, gm = rng.uniform(size=8192) < 0.8, rng.uniform(size=6000) < 0.7
        got, want = (float(chamfer_distance(on(pred, d), on(gt, d), on(pm, d), on(gm, d))) for d in (DEVICE, "cpu"))
        res["chamfer_distance"] = dict(card=got, cpu=want, rel_err=abs(got - want) / abs(want))
    log("[eval-ref] card vs CPU: " + "; ".join(f"{k} {v}" for k, v in res.items()))
    require(res["lpips_exact"]["rel_err"] <= LPIPS_TOL and res["lpips_vgg19"]["rel_err"] <= LPIPS_TOL,
            f"LPIPS (exact and VGG19 fallback) on the card within {LPIPS_TOL} of the CPU's")
    require(res["chamfer_distance"]["rel_err"] <= CHAMFER_TOL, f"chamfer distance within {CHAMFER_TOL}")
    return res


def neurad_train_reference_phase():
    """One `neurad-tiny` train step (fp32 reads, MLPs and decoders) on the card
    (K1f, K1b) against the CPU path (the plain versions) on a small scene, same
    parameters (livened), same batch and draws: the losses to 1e-4 relative;
    every gradient entry within 1e-3 of the largest entry of its tensor (or,
    for a tensor whose gradient is below 1e-3 of its group's largest, of the
    group's), and a hash table's (K1b's output) within 1e-4: matmuls,
    reductions and atomics sum in other orders on the two devices (measured
    at most 5.2e-5, a proposal field's cancelling terms; 5.4e-6 in the
    tables), and no entry may be off."""
    import numpy as np
    import torch

    from neurad_tpu_torch.configs.method_configs import neurad_tiny_overrides
    from neurad_tpu_torch.data.datamanager import ADDataManagerConfig
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline, ADPipelineConfig, ChunkDraws

    outputs = SyntheticDataParserConfig(num_frames=3).setup().get_dataparser_outputs()
    traj = outputs.trajectories[0]
    stamps = np.asarray(traj["timestamps"])
    traj["poses"] = np.array(traj["poses"])
    traj["poses"][:, :3, 3] = np.stack([2.0 * stamps + 1.5, np.full(len(stamps), 0.1), np.full(len(stamps), 1.5)], -1)
    traj["dims"] = np.array([1.2, 1.2, 1.2], np.float32)
    cfg = ADPipelineConfig(datamanager=ADDataManagerConfig(num_cam_patches=2, patch_size=4, num_lidar_rays=64),
                           model_overrides=dict(neurad_tiny_overrides(), compute_fp32=True), train_ray_chunk=40,
                           seed=SEED)
    gpu, cpu = ADPipeline(outputs, cfg, device="cuda"), ADPipeline(outputs, cfg, device="cpu")
    _liven(gpu.model)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    labels = gpu.init_state().optimizers.labels
    cpu.init_state()
    bundle_g, batch_g = gpu.datamanager.next_train()
    bundle_c, batch_c = cpu.datamanager.next_train()
    draws = cpu.draw(torch.Generator().manual_seed(SEED), bundle_c.origins.shape[0])
    draws_g = [ChunkDraws(tuple(j.cuda() for j in d.jitters), d.flip.cuda()) for d in draws]
    losses, grads = [], []
    for pipe, bundle, batch, dr in ((gpu, bundle_g, batch_g, draws_g), (cpu, bundle_c, batch_c, draws)):
        pipe.model.zero_grad()
        before = HE.hash_grid_bwd_launches
        total, _ = pipe.loss_fn(bundle, batch, dr)
        total.backward()
        if pipe is gpu:
            torch.cuda.synchronize()
            require(HE.hash_grid_bwd_launches - before == 2 * len(dr), "the card's backward went through K1b")
        losses.append(float(total.detach()))
        grads.append({n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                      for n, p in pipe.model.named_parameters()})
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    group_max = {}
    for name, g in grads[1].items():
        group_max[labels[name]] = max(group_max.get(labels[name], 0.0), float(g.abs().max()))
    rel = {}
    for name, g_cpu in grads[1].items():
        scale = max(float(g_cpu.abs().max()), 1e-3 * group_max[labels[name]])
        if scale > 0:
            rel[name] = float((grads[0][name] - g_cpu).abs().max()) / scale
    worst = max(rel, key=rel.get)
    log(f"[reference] one neurad-tiny train step, card vs CPU: losses {losses[0]:.6f} / {losses[1]:.6f} (relative "
        f"difference {loss_err:.2e}); largest gradient difference over its tensor's scale, worst of {len(rel)} "
        f"tensors: {worst} {rel[worst]:.2e}")
    require(loss_err <= 1e-4, "NeuRAD train losses agree to 1e-4 relative")
    tol = {name: 1e-4 if "hash_table" in name else 1e-3 for name in rel}
    require(all(v <= tol[name] for name, v in rel.items()),
            f"every NeuRAD gradient entry agrees to 1e-3 of its scale, 1e-4 in the hash tables: {rel}")
    return dict(losses=losses, loss_rel_err=loss_err, grad_max_rel_err=rel)


DP_WORLD = 2  # the gloo world's ranks, both on cuda:0 (NCCL refuses two ranks on one GPU)
DP_SPLAT_LR = 1e-2  # plain SGD in the SplatAD and splatfacto comparisons with the batched steps
# NeuRAD's gradients against the global batch's: the noise floor of `_noise_ratio`, of a tensor's largest entry. A
# rank's partial weight gradient of a bf16 MLP is rounded to bf16 before the sum over the ranks, the one-process
# gradient once; the compacted actor lookup's capacity is a rank's chunk's (ROADMAP.md section 3)
DP_NEURAD_FLOOR = 2.5e-3
# the noise floor of every tensor, of the largest gradient entry in its optimizer group: a tensor whose two
# reference gradients are exactly zero (a sum that cancels) while the other path's carries rounding noise is
# held to this (`_noise_ratio`)
DP_GROUP_FLOOR = 2.5e-4
DP_NEURAD_STEPS = 2
# the points-mode lidar outputs against the tiled path's: the bound of every valid point beyond 2e-2 |x| (the
# largest gap read in the earlier runs, 0.048 in alpha, with room; the depth in units of the point's range)
POINTS_GAP = 6e-2
DP_SCRIPT_STEPS = 3


class _SGD:
    """Plain SGD in the place of `Optimizers` for the data-parallel
    comparisons: a parameter's step is lr times its (averaged) gradient, so
    the gradients are compared rather than Adam's sign-like first update."""

    def __init__(self, module, lr=DP_SPLAT_LR):
        self.params = {"all": list(module.parameters())}
        self.optimizers, self.accum, self.lr = {}, {}, lr

    def zero_grad(self):
        for p in self.params["all"]:
            p.grad = None

    def step(self):
        import torch

        with torch.no_grad():
            for p in self.params["all"]:
                if p.grad is not None:
                    p -= self.lr * p.grad


def _noise_ratio(got, a, b, floor_frac=2.5e-3, groups=None):
    """Per tensor, got's largest distance to two references computed alike
    (a and b) over their own distance, that floored at `floor_frac` of the
    tensor's largest entry (two samples' noise is a poor estimate of its
    scale: two launches may even agree by chance, and bf16 convolutions'
    backward, whose algorithms cuDNN may pick anew, rounds at 2^-9) and at
    `DP_GROUP_FLOOR` of the largest entry of the tensor's optimizer group
    (`groups`: tensor name -> group; None: one group), so that a tensor
    whose two references are exactly zero is judged against a scale too.
    Returns dict(worst: the worst ratio, tensor: its tensor, exact: the
    number of tensors where a and b agree bit for bit, zero_refs: for each
    tensor whose references are both zero, got's largest entry over its
    group's largest reference entry)."""
    groups = groups or {}
    scale = {n: float(a[n].abs().max()) for n in got}
    group_max = {}
    for n in got:
        g = groups.get(n, "")
        group_max[g] = max(group_max.get(g, 0.0), scale[n])
    worst, worst_name, exact, zero_refs = 0.0, None, 0, {}
    for n in got:
        d_ab = float((a[n] - b[n]).abs().max())
        d = max(float((got[n] - a[n]).abs().max()), float((got[n] - b[n]).abs().max()))
        g_max = group_max[groups.get(n, "")]
        floor = max(d_ab, floor_frac * scale[n], DP_GROUP_FLOOR * g_max)
        ratio = d / floor if floor > 0 else (0.0 if d == 0 else math.inf)
        exact += d_ab == 0
        if scale[n] == 0 and d_ab == 0:
            zero_refs[n] = d / g_max if g_max > 0 else d
        if ratio > worst:
            worst, worst_name = ratio, n
    return dict(worst=worst, tensor=worst_name, exact=exact, zero_refs=zero_refs)


def _grads(model):
    import torch

    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
            for n, p in model.named_parameters()}


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _dp_counts():
    from neurad_tpu_torch.ops import hash_encoding as HE
    from neurad_tpu_torch.ops import tile_composite as TC

    return {"camera": TC.camera_launches, "lidar": TC.lidar_launches, "camera_bwd": TC.camera_bwd_launches,
            "lidar_bwd": TC.lidar_bwd_launches, "hash_grid": HE.hash_grid_launches,
            "hash_grid_bwd": HE.hash_grid_bwd_launches}


class _DPCounted:
    """The six main-path kernels' launches of the data-parallel calls inside
    `with` blocks only (counts set to 0 as a block opens, added as it closes):
    the one-process reference steps beside them are not counted."""

    def __init__(self):
        self.counts = dict.fromkeys(_dp_counts(), 0)

    def __enter__(self):
        from neurad_tpu_torch.ops import hash_encoding as HE
        from neurad_tpu_torch.ops import tile_composite as TC

        TC.reset_launch_counts()
        HE.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        for k, v in _dp_counts().items():
            self.counts[k] += v


def _dp_pick(dm, want_camera, rank):
    """The next `DP_WORLD` same-modality samples of the wanted kind; rank 0
    builds them all (its one-process reference takes them), the others their own."""
    for _ in range(64):
        samples = dm.next_train_batch(DP_WORLD, rank=None if rank == 0 else rank)
        if (type(samples[rank]).__name__ == "CameraSample") == want_camera:
            return samples
    raise RuntimeError("check failed: the wanted modality within 64 draws")


def _dp_rank(rank, workdir, device):
    """One rank of the gloo world on `device` (cuda:0; spawned by `data_parallel_phase`):
    SplatAD (MCMC, a refine at step 2; then one Default-strategy camera
    step), splatfacto and NeuRAD at full width through the pipelines'
    `make_sharded_train_step`, each step's averaged gradients held on rank 0
    against the one-process batched step's (the global batch's, for NeuRAD)
    computed twice: as close as the two are (`_noise_ratio`, 4x), the
    parameters checked bit for bit across the ranks after every step;
    then NeuRAD's sharded eval against its one-process eval. Writes
    rank<r>.json into `workdir`."""
    import dataclasses

    import torch

    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.model_components.strategy import MCMCStrategyConfig, should_refine
    from neurad_tpu_torch.models.splatad import SplatADConfig
    from neurad_tpu_torch.parallel import sharding
    from neurad_tpu_torch.pipelines import splatad_pipeline as SP
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline
    from neurad_tpu_torch.pipelines.splatfacto_pipeline import SplatfactoPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = sharding.make_mesh(device=device, rank=rank, world_size=DP_WORLD,
                              init_method=f"file://{workdir}/rendezvous", backend="gloo")
    res = {"rank": rank, "backend": mesh.backend, "steps": []}
    reduce_s = [0.0]
    real_reduce = sharding.all_reduce_gradients

    def timed_reduce(*a, **k):  # the all-reduce's share of a step
        _sync()
        t = time.perf_counter()
        real_reduce(*a, **k)
        _sync()
        reduce_s[0] += time.perf_counter() - t

    sharding.all_reduce_gradients = timed_reduce
    counted = _DPCounted()
    outputs = SyntheticDataParserConfig(**SCENE).setup().get_dataparser_outputs()

    def step(label, model, fn):
        """A data-parallel step, timed and counted; the parameters checked
        bit for bit across the ranks."""
        reduce_s[0] = 0.0
        torch.cuda.reset_peak_memory_stats()
        _sync()
        t0 = time.perf_counter()
        with counted:
            out = fn()
        _sync()
        s = time.perf_counter() - t0
        sharding.check_replicated(mesh, list(model.state_dict().values()), f"{label}: parameters")
        rec = dict(label=label, seconds=s, allreduce_seconds=reduce_s[0], allreduce_share=reduce_s[0] / s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        res["steps"].append(rec)
        return out, rec

    # ---- SplatAD: MCMC camera, lidar, camera (refine after step 2), under SGD ----
    cfg = SP.SplatADPipelineConfig(cap_max=N_GAUSS, seed=SEED, model=SplatADConfig(num_downscales=0),
                                   mcmc=MCMCStrategyConfig(cap_max=N_GAUSS, refine_start_iter=1, refine_every=2))
    pipe = SP.SplatADPipeline(outputs, cfg, device=device, mesh=mesh)
    state = pipe.init_state()
    labels = state.optimizers.labels  # the optimizer groups of the noise floors
    state.optimizers = _SGD(pipe.model)
    sharding.replicate(mesh, pipe.model)
    run = pipe.make_sharded_train_step()
    refines = 0
    for want_camera, strategy in ((True, "mcmc"), (False, "mcmc"), (True, "mcmc"), (True, "default")):
        if strategy == "default":  # the absgrad statistics, summed over the ranks
            pipe.config = dataclasses.replace(cfg, strategy="default")
            pipe._grad2d_sum = pipe._count = None
        samples = _dp_pick(pipe.datamanager, want_camera, rank)
        before = _snapshot(pipe.model) if rank == 0 else None
        (state, metrics), rec = step(f"splatad_{strategy}_{'camera' if want_camera else 'lidar'}", pipe.model,
                                     lambda: run(state, samples))
        rec.update(loss=float(metrics["total_loss"]), refined=bool(strategy == "mcmc" and should_refine(state.step, cfg.mcmc)))
        refines += rec["refined"]
        if rank == 0:  # the one-process batched step from the same parameters and samples, twice
            got = _grads(pipe.model)
            after = _snapshot(pipe.model)
            sums = (pipe._grad2d_sum.clone(), pipe._count.clone()) if strategy == "default" else None
            refs = []
            for _ in range(2):
                pipe.model.load_state_dict(before)
                ref_state = SP.TrainState(step=state.step - 1, optimizers=_SGD(pipe.model), generator=state.generator)
                _, ref_metrics, (g2d, count) = pipe._step_batched(ref_state, samples)
                refs.append((_grads(pipe.model), {"g2d": g2d.clone()}, count.clone()))
            pipe.model.load_state_dict(after)
            noise = _noise_ratio(got, refs[0][0], refs[1][0], groups=labels)
            worst, name = noise["worst"], noise["tensor"]
            rec.update(grad_worst_over_noise=worst, grad_worst_tensor=name,
                       tensors_bit_equal_between_refs=noise["exact"],
                       zero_ref_tensors=noise["zero_refs"], batched_loss=float(ref_metrics["total_loss"]))
            require(worst <= 4.0, f"{rec['label']}: the averaged gradients are the batched step's, as close as two "
                                  f"batched steps are ({name}: {worst:.3g}x)")
            require(abs(rec["loss"] - rec["batched_loss"]) <= 1e-5 * abs(rec["batched_loss"]),
                    f"{rec['label']}: the mean loss is the batched step's")
            if sums is not None:
                require(torch.equal(sums[1], refs[0][2]), "the Default strategy's visibility counts are the batched "
                                                          "step's")
                rec["absgrad_over_noise"] = _noise_ratio({"g2d": sums[0]}, refs[0][1], refs[1][1])["worst"]
                require(rec["absgrad_over_noise"] <= 4.0, f"the absgrad sums are the batched step's "
                                                          f"({rec['absgrad_over_noise']:.3g}x)")
        log(f"[dp rank {rank}] {rec}")
    require(refines >= 1, "an MCMC refine ran in the gloo world")
    del pipe, state, run
    torch.cuda.empty_cache()

    # ---- splatfacto: two steps, under SGD ----
    fcfg = METHODS["splatfacto"]().pipeline
    fcfg.seed = SEED
    pipe = SplatfactoPipeline(outputs, fcfg, device=device, mesh=mesh)
    state = pipe.init_state()
    state.optimizers = _SGD(pipe.model)
    sharding.replicate(mesh, pipe.model)
    run = pipe.make_sharded_train_step()
    for i in range(2):
        order = pipe.rng_state()
        before = _snapshot(pipe.model) if rank == 0 else None
        (state, metrics), rec = step(f"splatfacto_{i}", pipe.model, lambda: run(state))
        rec["loss"] = float(metrics["total_loss"])
        if rank == 0:
            got = _grads(pipe.model)
            after, now = _snapshot(pipe.model), pipe.rng_state()
            pipe.set_rng_state(order)
            idxs = pipe._draw_cameras(DP_WORLD)
            pipe.set_rng_state(now)
            sums = (pipe._grad2d_sum.clone(), pipe._count.clone())
            refs = []
            for _ in range(2):
                pipe.model.load_state_dict(before)
                pipe._step_batched(type(state)(step=0, optimizers=_SGD(pipe.model), generator=state.generator), idxs)
                refs.append(_grads(pipe.model))
            pipe.model.load_state_dict(after)
            pipe._grad2d_sum, pipe._count = sums
            noise = _noise_ratio(got, *refs)
            worst, name = noise["worst"], noise["tensor"]
            rec.update(grad_worst_over_noise=worst, grad_worst_tensor=name,
                       tensors_bit_equal_between_refs=noise["exact"],
                       zero_ref_tensors=noise["zero_refs"], cameras=idxs)
            require(worst <= 4.0, f"{rec['label']}: the averaged gradients are the batched step's, as close as two "
                                  f"batched steps are ({name}: {worst:.3g}x)")
        log(f"[dp rank {rank}] {rec}")
    del pipe, state, run
    torch.cuda.empty_cache()

    # ---- NeuRAD: the global batch's step, then the sharded eval ----
    ncfg = METHODS["neurad"]().pipeline
    ncfg.seed = SEED
    pipe = ADPipeline(outputs, ncfg, device=device, mesh=mesh)
    _liven(pipe.model)
    state = pipe.init_state()
    sharding.replicate(mesh, pipe.model, state.optimizers)
    run = pipe.make_sharded_train_step()
    n_cam = pipe.num_cam_rays
    for i in range(DP_NEURAD_STEPS):
        bundle, batch = pipe.datamanager.next_train()
        n_global = bundle.origins.shape[0] * DP_WORLD
        draws = pipe.draw(state.generator, n_global)
        before = _snapshot(pipe.model) if rank == 0 else None
        (state, metrics), rec = step(f"neurad_{i}", pipe.model, lambda: run(state, bundle, batch, draws))
        rec.update(loss=float(metrics["total_loss"]), rays_per_rank=bundle.origins.shape[0])
        global_bundle, global_batch = sharding.assemble_global_train_batch(mesh, bundle, batch, n_cam)
        if rank == 0:  # the one-process loss of the global batch, from the parameters before the step, twice
            got = _grads(pipe.model)
            after = _snapshot(pipe.model)
            refs = []
            for _ in range(2):
                pipe.model.load_state_dict(before)
                pipe.model.zero_grad(set_to_none=True)
                total, _m = pipe._loss_of_outputs(pipe._ray_outputs(global_bundle, draws, DP_WORLD * n_cam),
                                                  global_batch, DP_WORLD * n_cam)
                total.backward()
                refs.append(_grads(pipe.model))
                rec["global_loss"] = float(total.detach())
                del total, _m
            pipe.model.load_state_dict(after)
            noise = _noise_ratio(got, *refs, floor_frac=DP_NEURAD_FLOOR, groups=state.optimizers.labels)
            worst, name = noise["worst"], noise["tensor"]
            rec.update(grad_worst_over_noise=worst, grad_worst_tensor=name,
                       tensors_bit_equal_between_refs=noise["exact"],
                       zero_ref_tensors=noise["zero_refs"])
            require(abs(rec["loss"] - rec["global_loss"]) <= 1e-3 * abs(rec["global_loss"]),
                    f"{rec['label']}: the loss is the global batch's")
            require(worst <= 4.0, f"{rec['label']}: the averaged gradients are the one-process gradients of the "
                                  f"global batch, as close as two one-process steps are ({name}: {worst:.3g}x)")
        del global_bundle, global_batch
        sharding.barrier(mesh)
        torch.cuda.empty_cache()
        log(f"[dp rank {rank}] {rec}")

    pipe.config.eval_shard = True
    cam = outputs.eval_camera_indices[0] if outputs.eval_camera_indices else 0
    evals = {}
    for shard in (True, False):
        pipe.config.eval_shard = shard
        _sync()
        t0 = time.perf_counter()
        if shard:
            with counted:
                rgb, _gt = pipe.render_eval_camera(cam)
                metrics = pipe.eval_metrics()
        else:
            rgb, _gt = pipe.render_eval_camera(cam)
            metrics = pipe.eval_metrics()
        _sync()
        evals["sharded" if shard else "alone"] = dict(seconds=time.perf_counter() - t0, rgb=rgb, metrics=metrics)
    s, a = evals["sharded"], evals["alone"]
    res["eval"] = dict(sharded_seconds=s["seconds"], alone_seconds=a["seconds"], metrics=s["metrics"],
                       render_equal=bool((s["rgb"] == a["rgb"]).all()),
                       metrics_equal=s["metrics"] == a["metrics"],
                       metrics_max_rel=max(abs(s["metrics"][k] - a["metrics"][k]) / max(abs(a["metrics"][k]), 1e-12)
                                           for k in a["metrics"]))
    require(res["eval"]["render_equal"], "the sharded eval render is the one-process render, bit for bit")
    require(res["eval"]["metrics_max_rel"] <= 1e-6, f"the sharded eval_metrics are the one-process ones: {res['eval']}")
    res["launches"] = counted.counts
    require(all(v > 0 for v in counted.counts.values()),
            f"rank {rank} launched K1f, K1b and K2-K5 on the data-parallel paths: {counted.counts}")
    (Path(workdir) / f"rank{rank}.json").write_text(json.dumps(res))
    del pipe, state, run
    torch.distributed.destroy_process_group()


def data_parallel_phase(outputs):
    """Data-parallel training and eval over `torch.distributed`:
    (a) an NCCL world of 1 in this process: a SplatAD camera and lidar step,
        a splatfacto step and a NeuRAD step through the data-parallel steps
        against the plain `train_step` from the same state and inputs;
    (b) a gloo world of 2 ranks on cuda:0, spawned (`_dp_rank`);
    (c) the train script at full width (the `splatad` preset, 500,000
        gaussians, this run's scene): under `python -m torch.distributed.run
        --standalone --nproc_per_node 1` for 3 steps (a checkpoint by rank 0),
        then a resume from it to step 4 through the same entry point in (a)'s
        NCCL world of 1 (`train.entrypoint(argv, mesh=...)`: a second
        launcher process would add its start, not another path);
    (d) NeuRAD's sharded eval in the gloo world (in `_dp_rank`)."""
    import torch
    import torch.multiprocessing as mp

    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.models.splatad import SplatADConfig
    from neurad_tpu_torch.parallel import sharding
    from neurad_tpu_torch.pipelines import splatad_pipeline as SP
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline
    from neurad_tpu_torch.pipelines.splatfacto_pipeline import SplatfactoPipeline

    res = {"nccl_world_of_1": {}}
    t_phase = time.perf_counter()
    mesh = sharding.make_mesh(device=DEVICE, rank=0, world_size=1)  # NCCL on the card
    require(mesh.backend == "nccl", "the world of 1 runs on NCCL")

    def pair(label, pipe, make_state, sharded_call, plain_call, lrs, groups=None):
        """The data-parallel step and two plain steps from the same parameters
        and inputs: the loss bit for bit (the forward kernels are
        deterministic); per tensor, the gradient as close to each plain
        step's as the two plain steps are to each other (at most 4x that
        distance, or of 2.5e-3 of the tensor's largest entry or 2.5e-4 of its
        optimizer group's where that is larger): K1b, K3 and K5 and PyTorch's own atomic
        backwards add in no fixed order, so no two steps are bit-equal there;
        the parameters within 2 lr (Adam's sign-like first update) and 2 ulps."""
        before = _snapshot(pipe.model)
        grads = lambda: _grads(pipe.model)
        _sync()
        t0 = time.perf_counter()
        _, m_dp = sharded_call(make_state())
        _sync()
        t_dp = time.perf_counter() - t0
        g_dp, p_dp = grads(), {n: p.detach().clone() for n, p in pipe.model.named_parameters()}
        runs = []
        for _ in range(2):
            pipe.model.load_state_dict(before)
            _, m_plain = plain_call(make_state())
            runs.append((float(m_plain["total_loss"]), grads()))
        (loss_a, g_a), (loss_b, g_b) = runs
        noise = _noise_ratio(g_dp, g_a, g_b, groups=groups)
        worst, worst_name = noise["worst"], noise["tensor"]
        # Adam's first update is about lr * sign(g): 2 lr apart where a gradient's sign differs, plus the rounding
        # of parameters whose ulp exceeds a small lr (2 ulps)
        dp_far = max(float(((p_dp[n] - p.detach()).abs() - 2.4e-7 * p.detach().abs()).max()) / lrs(n)
                     for n, p in pipe.model.named_parameters())
        rec = dict(loss_dp=float(m_dp["total_loss"]), loss_plain=loss_a, seconds=t_dp, grad_worst_over_noise=worst,
                   grad_worst_tensor=worst_name, tensors_bit_equal_between_plain_steps=noise["exact"],
                   zero_ref_tensors=noise["zero_refs"], tensors=len(g_dp), params_max_over_lr=dp_far)
        log(f"[dp nccl] {label}: {rec}")
        require(rec["loss_dp"] == loss_a == loss_b, f"{label}: the NCCL world's loss is the plain step's, bit for bit")
        require(worst <= 4.0, f"{label}: the NCCL world's gradients are as close to a plain step's as two plain steps "
                              f"are ({worst_name}: {worst:.3g}x)")
        require(dp_far <= 2.001, f"{label}: the parameters within 2 lr of the plain step's")
        res["nccl_world_of_1"][label] = rec
        pipe.model.load_state_dict(before)

    cfg = SP.SplatADPipelineConfig(cap_max=N_GAUSS, seed=SEED, model=SplatADConfig(num_downscales=0))
    pipe = SP.SplatADPipeline(outputs, cfg, device=DEVICE, mesh=mesh)
    lr_of = lambda st: (lambda n: st.optimizers.schedules[st.optimizers.labels[n]](0))
    probe = pipe.init_state()
    for want_camera in (True, False):
        sample = next(s for s in iter(lambda: pipe.datamanager.next_train_batch(1), None)
                      if (type(s[0]).__name__ == "CameraSample") == want_camera)
        pair(f"splatad_{'camera' if want_camera else 'lidar'}", pipe, pipe.init_state,
             lambda st: pipe.make_sharded_train_step(mesh)(st, sample), lambda st: pipe.train_step(st, sample[0]),
             lr_of(probe), probe.optimizers.labels)
    del pipe, probe
    torch.cuda.empty_cache()

    fcfg = METHODS["splatfacto"]().pipeline
    fcfg.seed = SEED
    pipe = SplatfactoPipeline(outputs, fcfg, device=DEVICE, mesh=mesh)
    order = pipe.rng_state()

    def facto_dp(st):
        pipe.set_rng_state(order)
        return pipe.make_sharded_train_step(mesh)(st)

    def facto_plain(st):
        pipe.set_rng_state(order)
        return pipe.train_step(st, pipe._draw_cameras(1)[0])

    pair("splatfacto", pipe, pipe.init_state, facto_dp, facto_plain, lambda n: pipe._lrs()[n])
    del pipe
    torch.cuda.empty_cache()

    ncfg = METHODS["neurad"]().pipeline
    ncfg.seed = SEED
    pipe = ADPipeline(outputs, ncfg, device=DEVICE, mesh=mesh)
    _liven(pipe.model)
    probe = pipe.init_state()
    bundle, batch = pipe.datamanager.next_train()
    draws = pipe.draw(probe.generator, bundle.origins.shape[0])
    pair("neurad", pipe, pipe.init_state, lambda st: pipe.make_sharded_train_step(mesh)(st, bundle, batch, draws),
         lambda st: pipe.train_step(st, bundle, batch, draws), lr_of(probe), probe.optimizers.labels)
    del pipe, probe, bundle, batch, draws
    gc.collect()
    torch.cuda.empty_cache()
    res["nccl_seconds"] = time.perf_counter() - t_phase

    # (c): the train script at full width under torchrun, a world of 1 on NCCL; the resume in this NCCL world
    from neurad_tpu_torch.scripts import train as TTrain

    t0 = time.perf_counter()
    out_dir = RUNS / "dp_script"
    device_args = [] if DEVICE == "cuda" else ["--device", DEVICE]
    argv = ["splatad", "--output-dir", str(out_dir), "--experiment-name", "r", "--max-iterations",
            str(DP_SCRIPT_STEPS), *[a for k, v in SCENE.items() for a in ("--dp-set", f"{k}={v}")], *device_args]
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                           "-m", "neurad_tpu_torch.scripts.train", *argv], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=600)
    launch_log = proc.stdout[-2000:] + proc.stderr[-2000:]
    require(proc.returncode == 0, f"the train script under torchrun: {launch_log}")
    require("rank 0 of 1 (nccl)" in proc.stdout, "the train script joined torchrun's world of 1 on NCCL")
    first = sorted(p.name for p in (out_dir / "r" / "checkpoints").iterdir())
    t_launch = time.perf_counter() - t0
    t1 = time.perf_counter()
    pipe, state = TTrain.entrypoint(["splatad", "--load-dir", str(out_dir / "r"), "--max-iterations",
                                     str(DP_SCRIPT_STEPS + 1), *device_args], mesh=mesh)
    resumed_step, n_gauss = state.step, int(pipe.model.means.shape[0])
    del pipe, state
    gc.collect()
    torch.cuda.empty_cache()
    files = sorted(p.name for p in (out_dir / "r" / "checkpoints").iterdir())
    res["script"] = dict(seconds=time.perf_counter() - t0, torchrun_seconds=t_launch,
                         resume_seconds=time.perf_counter() - t1, first=first, files=files, gaussians=n_gauss,
                         scene=SCENE)
    require(first == [f"step-{DP_SCRIPT_STEPS:09d}.pt"], f"one checkpoint after {DP_SCRIPT_STEPS} steps: {first}")
    require(resumed_step == DP_SCRIPT_STEPS + 1 and files == [f"step-{DP_SCRIPT_STEPS:09d}.pt",
                                                              f"step-{DP_SCRIPT_STEPS + 1:09d}.pt"],
            f"the resume trained on from it: step {resumed_step}, {files}")
    log(f"[dp script] torchrun splatad, then the resume in process: {res['script']}")
    torch.distributed.destroy_process_group()

    # (b), (d): the gloo world of 2 on this card
    t0 = time.perf_counter()
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=RUNS))
    mp.start_processes(_dp_rank, args=(str(workdir), "cuda:0" if DEVICE == "cuda" else DEVICE), nprocs=DP_WORLD,
                       start_method="spawn")
    ranks = [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(DP_WORLD)]
    res["gloo"] = dict(seconds=time.perf_counter() - t0, ranks=ranks)
    res["launches"] = {k: min(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    log(f"[dp gloo] {DP_WORLD} ranks in {res['gloo']['seconds']:.1f} s; launches on every rank {res['launches']}; "
        f"eval {ranks[0]['eval']}")

    return res


def library_phase(outputs):
    """The last slice's library at full width: one SplatAD lidar step with
    `lidar_raster_mode="points"` (per-point gathers in plain PyTorch), its
    outputs and opacity gradients held against the tiled path's (K4, K5) on
    the same parameters and scan at `test_lidar_tiled_matches_pointwise`'s
    bounds (99% of the points within 2e-3 + 2e-2 |x|, every point within
    `POINTS_GAP` + 2e-2 |x|, the points beside the azimuth's wrap alike; 99%
    of the gaussians' gradients within 5e-2 + 5e-2 |g|, every one within
    that + 1e-3 of the largest; the median is left out, its two
    definitions differ: ROADMAP.md section 3), timed and its peak memory
    beside a tiled step; one NeuRAD serving request with
    `rgb_decoder_norm="batch"` (eval mode, running averages)."""
    import dataclasses

    import numpy as np
    import torch

    from neurad_tpu_torch.configs.method_configs import METHODS
    from neurad_tpu_torch.models.splatad import SplatADConfig
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig
    from neurad_tpu_torch.scripts.closed_loop import ClosedLoopState
    from neurad_tpu_torch.pipelines.ad_pipeline import ADPipeline

    res = {}
    cfg = SplatADPipelineConfig(cap_max=N_GAUSS, seed=SEED, model=SplatADConfig(num_downscales=0,
                                                                                 lidar_raster_mode="points"))
    pipe = SplatADPipeline(outputs, cfg, device=DEVICE)
    dm = pipe.datamanager
    sample = dm._lidar_sample(dm.train_lidars[0])
    model = pipe.model
    points_cfg = model.config
    tiled_cfg = dataclasses.replace(points_cfg, lidar_raster_mode="tiled")
    valid = torch.as_tensor(sample.valid, device=model.device)
    azim = torch.as_tensor(sample.raster_pts[:, 0], device=model.device)
    seam = valid & (azim.abs() >= 180.0 - points_cfg.lidar_tile_azim)  # the tiles beside the azimuth's wrap
    keys = ("features", "depth", "alpha", "alpha_sum_until_points")
    outs, grads = {}, {}
    for mode, mcfg in (("points", points_cfg), ("tiled", tiled_cfg)):
        # JAX's test loss, sum(features^2) + sum(alpha_sum_until_points) over the scan's points, and its
        # gradient with respect to the opacities (the model's logits' gradient over the sigmoid's slope)
        model.config = mcfg
        model.zero_grad(set_to_none=True)
        out = model.get_lidar_outputs(sample.l2w, sample.raster_pts, sample.time, sample.sensor_idx)
        loss = (out["features"][valid] ** 2).sum() + out["alpha_sum_until_points"][valid].sum()
        loss.backward()
        sig = torch.sigmoid(model.opacities.detach())
        grads[mode] = (model.opacities.grad / (sig * (1.0 - sig))).reshape(-1)
        outs[mode] = {k: out[k].detach().reshape(out[k].shape[0], -1) for k in keys}
        del out, loss
    model.config = points_cfg
    model.zero_grad(set_to_none=True)
    # a point's excess over the relative part of `test_lidar_tiled_matches_pointwise`'s bound (2e-2 |x|), per
    # output its largest over the channels; the every-point bound takes the depth (an alpha-weighted sum of
    # distances) in units of the point's range, the other outputs as they are
    rng = torch.as_tensor(sample.raster_pts[:, 2], device=model.device).clamp_min(1.0)
    excess = {k: ((outs["points"][k] - outs["tiled"][k]).abs() - 2e-2 * outs["tiled"][k].abs()).amax(-1)
              for k in keys}
    ok = torch.stack([excess[k] for k in keys]).amax(0) <= 2e-3
    gap = torch.stack([excess[k] / rng if k == "depth" else excess[k] for k in keys]).amax(0)
    g_p, g_t = grads["points"], grads["tiled"]
    # where the 1/255 alpha gate keeps a gaussian at a point in one path and drops it in the other (bf16 against
    # fp32 quadratic forms) its gradient differs by that point's share: JAX's test allows 5e-2 on its toy scene,
    # 2% of its largest gradient; a full-width scan's gradients reach a hundred times more, so beside the share
    # within the test's bound every gaussian is held to it plus 1e-3 of the largest gradient
    g_max = float(g_t.abs().max())
    g_excess = (g_p - g_t).abs() - 5e-2 * g_t.abs()
    gated = (g_p == 0) != (g_t == 0)  # kept at every point in one path, at none in the other
    with_grad = (g_p != 0) | (g_t != 0)
    res["points_vs_tiled"] = dict(
        agree_share=float(ok[valid].float().mean()), valid_points=int(valid.sum()),
        seam_points=int(seam.sum()), seam_agree_share=float(ok[seam].float().mean()),
        largest_gap=float(gap[valid].max()), seam_largest_gap=float(gap[seam].max()),
        largest_excess={k: float(excess[k][valid].max()) for k in keys},
        depth_largest_excess_over_range=float((excess["depth"] / rng)[valid].max()),
        opacity_grad_agree_share=float((g_excess <= 5e-2)[with_grad].float().mean()),
        opacity_grad_largest_excess=float(g_excess.max()), opacity_grad_max_abs=g_max,
        gaussians_with_grad=int(with_grad.sum()), gaussians_gated_apart=int(gated.sum()))
    log(f"[library] points vs tiled lidar outputs and opacity gradients: {res['points_vs_tiled']}")
    pv = res["points_vs_tiled"]
    require(pv["agree_share"] >= 0.99, "99% of the scan's points agree with the tiled path within 2e-3 + 2e-2 |x| "
                                       "(features, depth, alpha, alpha before the return)")
    require(pv["largest_gap"] <= POINTS_GAP,
            f"every valid point agrees with the tiled path within {POINTS_GAP} + 2e-2 |x| (the depth in units of its "
            f"range; {pv['largest_gap']:.3g})")
    require(pv["seam_points"] > 0 and pv["seam_agree_share"] >= 0.99 and pv["seam_largest_gap"] <= POINTS_GAP,
            "the points beside the azimuth's wrap agree with the tiled path as the others do")
    require(pv["opacity_grad_agree_share"] >= 0.99 and pv["opacity_grad_largest_excess"] <= 5e-2 + 1e-3 * g_max,
            f"99% of the gaussians' opacity gradients agree with the tiled path's within 5e-2 + 5e-2 |g| "
            f"(test_lidar_tiled_matches_pointwise's bound), every one within that + 1e-3 of the largest "
            f"({pv['opacity_grad_largest_excess']:.3g} against {5e-2 + 1e-3 * g_max:.3g})")
    del outs, grads, g_p, g_t, g_excess
    steps = {}
    for mode, mcfg in (("points", points_cfg), ("tiled", tiled_cfg)):
        model.config = mcfg
        state = pipe.init_state()
        for i in range(2):  # the first apart
            torch.cuda.reset_peak_memory_stats()
            _sync()
            t0 = time.perf_counter()
            state, metrics = pipe.train_step(state, sample)
            _sync()
            steps.setdefault(mode, []).append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                                   loss=float(metrics["total_loss"])))
        require(all(math.isfinite(s["loss"]) for s in steps[mode]), f"{mode} lidar steps' losses finite")
    res["lidar_step"] = steps
    log(f"[library] lidar steps (the first apart): {steps}")
    del pipe, model, state
    gc.collect()
    torch.cuda.empty_cache()

    ncfg = METHODS["neurad"]().pipeline
    ncfg.seed = SEED
    ncfg.model_overrides = {**ncfg.model_overrides, "rgb_decoder_norm": "batch"}
    t0 = time.perf_counter()
    npipe = ADPipeline(outputs, ncfg, device=DEVICE)
    _liven(npipe.model)
    require(any("running_mean" in k for k in npipe.model.state_dict()), "the decoder normalises by batch norm")
    cl = ClosedLoopState(npipe, device=DEVICE)
    t_build = time.perf_counter() - t0
    c2w = outputs.cameras.camera_to_worlds[0].numpy()
    pose = np.eye(4)
    pose[:3] = c2w
    times = []
    for _ in range(2):  # cold, warm
        _sync()
        t0 = time.perf_counter()
        img = cl.render_image(pose.tolist(), float(outputs.cameras.times[0, 0]), outputs.sensor_idx_to_name[0])
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    require(np.isfinite(np.asarray(img)).all(), "the batch-norm decoder's request is finite")
    res["batch_norm_request"] = dict(build_s=t_build, ms=times, shape=list(np.asarray(img).shape))
    log(f"[library] NeuRAD request with a batch-norm decoder: {res['batch_norm_request']}")
    del npipe, cl
    gc.collect()
    torch.cuda.empty_cache()
    return res


API_T_STRIDE = 48  # sds_loss is checked at every API_T_STRIDE-th step of the guidance's t range
API_POINTS = 1_000_000  # seeded points of the box masks
API_TOL = 1e-6  # card against CPU, fp32: the SDS math, CFG, the prompt embeddings, the poses (relative)
API_BLOCK_TOL = 1e-4  # the bottleneck block card against CPU (fp32 convolutions and norms over 230,400 pixels)
API_FACE = 1e-5  # a rotated box's points this close to a face (float64, the box's frame) may fall either side


def _rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want| (the largest |got - want| where want is all zero)."""
    want = want.to(got.device, got.dtype)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    return err / scale if scale > 0 else err


def api_phase(drive_scene):
    """The rest of the JAX package's public API (slice 13), each piece on the
    card against the same function on the CPU: `sds_loss` and its gradient
    at Stable Diffusion's latent size ([1, 4, 64, 64] for IMG_DIM = 512) at
    t over the guidance's t range; `classifier_free_guidance`;
    `PositionalTextEmbeddings` in all three modes on SD 1.5's text-encoder
    shape [2, 77, 768]; `BottleneckBlock` (group norm, batch norm in train
    and eval mode) on the NeuRAD decoder's pre-upsample map of a 1920x1080
    frame, [1, 32, 360, 640] fp32, its forward timed beside `BasicBlock`'s;
    `SceneBox.within` and `OrientedBox.within` on API_POINTS seeded points
    around the drive's scene box; `inverse`, `normalize` and
    `rotation_difference` on the drive's poses (cameras, lidar, actors; the
    rotation difference between every pair); and
    `StableDiffusionGuidance()`'s ImportError without `diffusers`."""
    import copy
    import dataclasses

    import torch

    from neurad_tpu_torch.core import poses as P
    from neurad_tpu_torch.core.scene_box import OrientedBox, SceneBox
    from neurad_tpu_torch.generative import PositionalTextEmbeddings, StableDiffusionGuidance
    from neurad_tpu_torch.generative import stable_diffusion as SD
    from neurad_tpu_torch.model_components.cnns import BasicBlock, BottleneckBlock

    res = {}
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED)

    # --- the SDS math at SD's latent size ---
    d = SD.IMG_DIM // 8
    lat, noise, pred_text, pred_uncond = (torch.randn((1, 4, d, d), generator=gen) for _ in range(4))
    alphas = SD.scaled_linear_alphas_cumprod(1000)
    lo, hi = int(1000 * 0.02), int(1000 * 0.98)  # the guidance's default t_range, as its min_step and max_step
    require(_rel_err(SD.scaled_linear_alphas_cumprod(1000, device=DEVICE), alphas) <= 1e-5,
            "the noise schedule on the card")
    cfg_err = _rel_err(SD.classifier_free_guidance(pred_text.to(DEVICE), pred_uncond.to(DEVICE), 100.0),
                       SD.classifier_free_guidance(pred_text, pred_uncond, 100.0))
    pred = SD.classifier_free_guidance(pred_text, pred_uncond, 100.0)
    worst = dict(loss=0.0, grad=0.0, noisy=0.0, score=0.0)
    ts = list(range(lo, hi + 1, API_T_STRIDE)) + [hi]
    for t in ts:
        outs = {}
        for dev in (DEVICE, cpu):
            x = lat.to(dev, copy=True).requires_grad_(True)
            a = alphas.to(dev)
            loss = SD.sds_loss(x, noise.to(dev), pred.to(dev), a, t)
            loss.backward()
            outs[dev] = (loss.detach(), x.grad, SD.add_noise(lat.to(dev), noise.to(dev), a, t))
        (loss_c, grad_c, noisy_c), (loss_r, grad_r, noisy_r) = outs[DEVICE], outs[cpu]
        score = (1.0 - alphas[t]) * (pred - noise) / lat.shape[0]  # the gradient: DreamFusion's score, over B
        for key, got, want in (("loss", loss_c, loss_r), ("grad", grad_c, grad_r), ("noisy", noisy_c, noisy_r),
                               ("score", grad_c, score)):
            worst[key] = max(worst[key], _rel_err(got, want))
    res["sds"] = dict(shape=list(lat.shape), t=[ts[0], ts[-1], len(ts)], cfg_rel_err=cfg_err, **worst)
    log(f"[api] sds_loss at {list(lat.shape)}, t in {lo}..{hi} ({len(ts)} values), card against CPU: {res['sds']}")
    require(max(worst.values()) <= 1e-5 and cfg_err <= API_TOL,
            "sds_loss, its gradient (the score), add_noise and CFG agree with the CPU within 1e-5 relative")

    # --- view-conditioned prompt embeddings on SD 1.5's text-encoder shape ---
    embeds = {k: torch.randn((2, 77, 768), generator=gen) for k in ("base", "top", "side", "back", "front")}
    angles = [(v, h) for v in (20.0, 45.0, 80.0) for h in range(-30, 400, 15)]
    pte = {}
    for mode in ("discrete", "interpolated", "off"):
        on_card = PositionalTextEmbeddings({k: e.to(DEVICE) for k, e in embeds.items()}, mode)
        on_cpu = PositionalTextEmbeddings(embeds, mode)
        pte[mode] = max(_rel_err(on_card(v, h), on_cpu(v, h)) for v, h in angles)
    res["positional_text_embeddings"] = dict(angles=len(angles), rel_err=pte)
    log(f"[api] PositionalTextEmbeddings at [2, 77, 768], {len(angles)} camera angles: largest error {pte}")
    require(max(pte.values()) <= API_TOL, "the prompt embeddings agree with the CPU in every mode")

    # --- BottleneckBlock on the decoder's pre-upsample map of a 1080p frame ---
    x = torch.randn((1, 360, 640, 32), generator=gen)
    x_card = x.to(DEVICE)
    blocks = {}
    for norm in ("group", "batch"):
        torch.manual_seed(SEED)
        block = BottleneckBlock(32, kernel_size=3, norm=norm)
        with torch.no_grad():  # norms that are not the identity, running averages that are not 0 and 1
            for m in (block.norm1, block.norm2, block.norm3):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                if norm == "batch":
                    m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
        card = copy.deepcopy(block).to(DEVICE)
        rec = {}
        for mode in (("eval", "train", "eval_after") if norm == "batch" else ("eval",)):
            train = mode == "train"
            with torch.no_grad():
                got, want = card(x_card, train=train), block(x, train=train)
            require(got.dtype == torch.float32 and got.shape == (1, 360, 640, 32), f"bottleneck {norm}: fp32 NHWC")
            rec[mode] = _rel_err(got, want)
            if train:
                rec["running_stats"] = max(_rel_err(bc, bb) for bc, bb in zip(card.buffers(), block.buffers()))
        with torch.no_grad():
            rec["ms"] = cuda_time_ms(lambda: card(x_card))
        blocks[norm] = rec
        del card, block
    with torch.no_grad():
        for label, dtype in (("basic_bf16_k7", torch.bfloat16), ("basic_fp32_k7", torch.float32)):
            torch.manual_seed(SEED)
            basic = BasicBlock(32, 32, 7, "group", compute_dtype=dtype).to(DEVICE)
            blocks[label] = dict(ms=cuda_time_ms(lambda: basic(x_card)))
            del basic
    res["bottleneck_block"] = blocks
    log(f"[api] BottleneckBlock at [1, 32, 360, 640] fp32, card against CPU (largest error over the largest entry) "
        f"and forward ms (warm, CUDA events, median of 10) beside BasicBlock's: {blocks}")
    require(all(v <= API_BLOCK_TOL for norm in ("group", "batch") for k, v in blocks[norm].items() if k != "ms"),
            f"the bottleneck block (group norm; batch norm in train and eval mode, its running averages) agrees "
            f"with the CPU within {API_BLOCK_TOL} of the largest entry")
    del x_card
    torch.cuda.empty_cache()

    # --- the box masks ---
    aabb = drive_scene["aabb"].float()
    lo3, hi3 = aabb[0], aabb[1]
    centre, size = (lo3 + hi3) / 2.0, hi3 - lo3
    pts = centre + (torch.rand((API_POINTS, 3), generator=gen) - 0.5) * 1.5 * size
    pts[: API_POINTS // 20, 0] = lo3[0]  # 5% on a face of the scene box: outside on both
    cos, sin = math.cos(0.6), math.sin(0.6)
    rot = torch.tensor([[cos, -sin, 0.0], [sin, cos, 0.0], [0.0, 0.0, 1.0]])
    # the oriented boxes: half the scene box's size about its centre, axis-aligned and turned 0.6 rad about z
    boxes = {"scene_box": SceneBox(aabb), "oriented_box_axis_aligned": OrientedBox(torch.eye(3), centre, size / 2),
             "oriented_box_rotated": OrientedBox(rot, centre, size / 2)}
    pts_card = pts.to(DEVICE)
    masks = {}
    for name, box in boxes.items():
        on_card = dataclasses.replace(box, **{f.name: getattr(box, f.name).to(DEVICE)
                                              for f in dataclasses.fields(box)})
        on_card.within(pts_card)  # warm: the timing below is a warm call's
        _sync()
        t0 = time.perf_counter()
        got = on_card.within(pts_card)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        want = box.within(pts)
        differ = got.cpu() != want
        if name == "oriented_box_rotated":
            local = (pts.double() - centre.double()) @ rot.double()
            near = ((local.abs() - size.double() / 4).abs() < API_FACE).any(-1)
        else:
            near = torch.zeros_like(differ)
        masks[name] = dict(inside=int(want.sum()), differ=int(differ.sum()), near_face=int(near.sum()),
                           differ_away_from_faces=int((differ & ~near).sum()), ms=ms)
    res["masks"] = dict(points=API_POINTS, **masks)
    log(f"[api] box masks on {API_POINTS} points, card against CPU: {res['masks']}")
    require(masks["scene_box"]["differ"] == 0 and masks["oriented_box_axis_aligned"]["differ"] == 0,
            "the scene-box and axis-aligned oriented-box masks are bit-equal to the CPU's")
    require(masks["oriented_box_rotated"]["differ_away_from_faces"] == 0,
            f"the rotated box's mask equals the CPU's but for points within {API_FACE} of a face")
    require(0 < masks["scene_box"]["inside"] < API_POINTS, "the scene box holds some of the points")

    # --- the pose helpers on the drive's poses (cameras, lidar, actors) ---
    drive = drive_scene["poses"]
    drive_card = drive.to(DEVICE)
    poses = dict(n_poses=int(drive.shape[0]), inverse=_rel_err(P.inverse(drive_card), P.inverse(drive)),
                 normalize=_rel_err(P.normalize(drive_card), P.normalize(drive)))
    # rotation_difference between every pair of the drive's rotations. arccos turns a few ulps of the cosine
    # (tr(R1^T R2) - 1) / 2 into 1e-6 / sin(theta) of the angle (and of the axis, the skew part over
    # 2 sin(theta)): each pair is held to 1e-6 + 1e-6 / sin(theta), theta the CPU's
    rots = drive[:, :3, :3]
    want = P.rotation_difference(rots[:, None], rots[None, :])
    err = (P.rotation_difference(drive_card[:, None, :3, :3], drive_card[None, :, :3, :3]).cpu() - want).abs().amax(-1)
    theta = torch.linalg.norm(want, dim=-1)
    worst = float((err / (1e-6 + 1e-6 / torch.sin(theta).clamp_min(1e-12))).max())
    poses["rotation_difference"] = dict(pairs=int(theta.numel()), abs_err=float(err.max()), err_over_bound=worst,
                                        angles=sorted({round(float(a), 4) for a in theta.flatten()}))
    res["poses"] = poses
    log(f"[api] pose helpers on the drive's {drive.shape[0]} poses (cameras, lidar, actors), card against CPU: "
        f"{poses}")
    require(poses["inverse"] <= API_TOL and poses["normalize"] <= API_TOL,
            "the pose inverse and normalisation agree with the CPU")
    require(worst <= 1.0, "rotation_difference agrees with the CPU within 1e-6 + 1e-6 / sin(theta)")

    # --- the diffusion backbone is gated on `diffusers` ---
    try:
        StableDiffusionGuidance()
        raised = None
    except ImportError as e:
        raised = str(e)
    res["guidance_import_error"] = raised
    log(f"[api] StableDiffusionGuidance(): ImportError {raised!r}")
    require(raised is not None and "diffusers" in raised,
            "StableDiffusionGuidance() raises ImportError naming diffusers on this machine, which has none")
    return res


def profiled(label, fn, rows=15, match=None):
    """Run fn once more under torch.profiler: device time by kernel, and the
    device's busy share of the host-clock interval (profiler on). `match`: also
    sum the time and launches of the kernels whose name contains it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        _sync()
        host_ms = (time.perf_counter() - start) * 1e3
    # device-side events only (kernels, copies): operator events repeat their
    # kernels' time
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {label}: host {host_ms:.1f} ms, device busy {busy_ms:.2f} ms ({100 * busy_ms / host_ms:.0f}%)")
    top = [(e.key[:100], e.self_device_time_total / 1e3, e.count) for e in kernels[:rows]]
    for name, ms, n in top:
        log(f"[profile] {label}: {ms:8.3f} ms x{n:<3d} {name}")
    out = dict(host_ms=host_ms, device_busy_ms=busy_ms, top=top,
               all=[(e.key, e.self_device_time_total / 1e3, e.count) for e in kernels])
    if match is not None:
        out["matched_ms"] = sum(e.self_device_time_total for e in kernels if match in e.key) / 1e3
        out["matched_launches"] = sum(e.count for e in kernels if match in e.key)
    return out


def reference_phase():
    """The card's renders against the CPU path (plain versions) on a small scene."""
    import numpy as np
    import torch

    from neurad_tpu_torch.data.dataparsers.synthetic import SyntheticDataParserConfig
    from neurad_tpu_torch.pipelines.splatad_pipeline import SplatADPipeline, SplatADPipelineConfig

    outputs = SyntheticDataParserConfig(num_frames=4).setup().get_dataparser_outputs()
    cfg = SplatADPipelineConfig(cap_max=20_000, seed=SEED)
    gpu = SplatADPipeline(outputs, cfg, device="cuda")
    cpu = SplatADPipeline(outputs, cfg, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    errs, off = {}, {}

    def compare(name, a, b, tol):
        diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        errs[name], off[name] = float(diff.max()), float((diff > tol).mean())

    with torch.inference_mode():
        s = gpu.datamanager._camera_sample(3)
        args = (s.c2w, s.K, s.width, s.height, s.time, s.sensor_idx, s.cam_idx)
        kw = dict(cam_linear_vel=s.linear_velocity, rolling_shutter_time=0.04)
        og, oc = gpu.model.get_camera_outputs(*args, **kw), cpu.model.get_camera_outputs(*args, **kw)
        compare("camera_rgb", og["rgb"].cpu(), oc["rgb"], 2e-2)
        compare("camera_depth", og["depth"].cpu(), oc["depth"], 1e-3)
        compare("camera_accumulation", og["accumulation"].cpu(), oc["accumulation"], 1e-4)
        lg, lc = gpu.render_eval_lidar(3), cpu.render_eval_lidar(3)
        compare("lidar_depth", lg["depth"], lc["depth"], 1e-3)
        compare("lidar_intensity", lg["intensity"], lc["intensity"], 2e-2)
    log(f"[reference] card vs CPU path on a 72x48 scene: max abs err {errs}, share of values off {off}")
    # The two devices project the gaussians with differently rounded matmuls,
    # so a pair can land on the other side of the 1/255 alpha gate and move one
    # pixel's accumulation by up to 1/255 (and its depth, or its fill-in depth
    # where accumulation reaches 0, by metres). Every value within its
    # tolerance (accumulation 1e-4, depths 1e-3 m, decoded rgb/intensity 2e-2,
    # bf16 decoders on cuDNN vs the CPU) except at most 1% of them, and no
    # accumulation off by more than one gate step.
    require(all(v <= 0.01 for v in off.values()), f"card and CPU path agree on 99% of values: {off}")
    require(errs["camera_accumulation"] <= 1.0 / 255.0 + 1e-4, "accumulation off by at most one alpha-gate step")
    require(errs["camera_rgb"] <= 5e-2 and errs["lidar_intensity"] <= 2e-2, "decoded outputs agree")

    # One train step's loss and gradients, card (backward kernels) against the CPU (plain backward), with
    # fp32 decoders on both so that the comparison is about the composites. A gradient entry counts as off
    # when it differs by more than 1e-3 of its tensor's largest entry; pairs that land on the other side of
    # the alpha gate on the two devices move a few entries, so up to 1% may be off, and the losses agree to 1e-3.
    for pipe in (gpu, cpu):
        for module in pipe.model.modules():
            if hasattr(module, "compute_dtype"):
                module.compute_dtype = torch.float32
    grad_off, loss_err = {}, {}
    for kind, sample in (("camera", gpu.datamanager._camera_sample(1)), ("lidar", gpu.datamanager._lidar_sample(1))):
        grads, losses = [], []
        for pipe in (gpu, cpu):
            model = pipe.model
            model.zero_grad()
            if kind == "camera":
                out = model.get_camera_outputs(sample.c2w, sample.K, sample.width, sample.height, sample.time,
                                               sample.sensor_idx, sample.cam_idx, cam_linear_vel=sample.linear_velocity,
                                               rolling_shutter_time=0.04)
                total, _ = model.camera_loss(out, sample.image)
            else:
                out = model.get_lidar_outputs(sample.l2w, sample.raster_pts, sample.time, sample.sensor_idx,
                                              lidar_linear_vel=sample.linear_velocity)
                total, _ = model.lidar_loss(out, sample.raster_pts, sample.did_return, sample.valid)
            total.backward()
            losses.append(float(total.detach()))
            grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None})
        require(grads[0].keys() == grads[1].keys(), "the same parameters get gradients on both devices")
        loss_err[kind] = abs(losses[0] - losses[1]) / abs(losses[1])
        for name, g_cpu in grads[1].items():
            scale = float(g_cpu.abs().max())
            if scale > 0:
                grad_off[f"{kind}:{name}"] = float(((grads[0][name] - g_cpu).abs() > 1e-3 * scale).float().mean())
    worst = max(grad_off, key=grad_off.get)
    log(f"[reference] one train step, card vs CPU: relative loss difference {loss_err}; share of gradient entries "
        f"off by more than 1e-3 of their tensor's largest, worst of {len(grad_off)} tensors: {worst} {grad_off[worst]:.4f}")
    require(all(v <= 1e-3 for v in loss_err.values()), "train losses agree to 1e-3 relative")
    require(all(v <= 0.01 for v in grad_off.values()), f"gradients agree on 99% of entries: {grad_off}")
    return {"max_abs_err": errs, "share_off": off, "train_loss_rel_err": loss_err, "grad_share_off": grad_off}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port on one NVIDIA GPU.")
    parser.add_argument("--parent", default=None,
                        help="another checkout of this repository (an unpacked parent commit): the neurad preset's "
                             "training in turns with this tree's, fresh processes; its hash-grid lookup, composites "
                             "and gather probes built and timed in turns with this tree's")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    global RUNS
    RUNS = Path(tempfile.mkdtemp(prefix="chip_smoke_runs_"))
    if args.parent:
        t0 = time.perf_counter()
        REPORT["parent_turns"] = parent_turns(args.parent)
        log(f"[time] parent turns: {time.perf_counter() - t0:.1f} s")
    from neurad_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t_start = t0 = time.perf_counter()
    if args.parent:  # the parent's two libraries build beside this tree's
        parent_build, parent_built = load_parent(args.parent), []
        parent_thread = threading.Thread(
            target=lambda: parent_built.append(parent_build.build_all(
                ["hash_grid", "tile_composite", "tile_composite_bwd", "gather_probes"])),
            daemon=True)
        parent_thread.start()
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    if args.parent:
        parent_thread.join()
        require(bool(parent_built), f"the parent checkout {args.parent} built its lookup, composites and probes")
        log(f"[build] the parent's hash_grid, tile_composite, tile_composite_bwd and gather_probes from {args.parent} "
            f"in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report()
    for r in ptxas:
        log(f"[ptxas] {r['library']}: {r['kernel']}: {r.get('registers')} registers, {r.get('stack')} bytes stack "
            f"frame, {r.get('spill_stores')}/{r.get('spill_loads')} bytes spill stores/loads, {r.get('smem')} bytes "
            f"static shared memory")
    k1b_ptxas = [r for r in ptxas if r["kernel"].startswith(HASH_BWD_KERNEL + "<")]
    require(len(k1b_ptxas) == 24 and all(r.get("stack") == 0 for r in k1b_ptxas),
            "every instantiation of the lookup's backward (D, F, read type, layout) keeps no stack frame")
    k1f_ptxas = [r for r in ptxas if r["kernel"].startswith(HASH_KERNEL + "<")]
    k2_ptxas = [r for r in ptxas if r["kernel"].startswith(CAMERA_KERNEL + "<")]
    require(len(k1f_ptxas) == 36 and len(k2_ptxas) == 3 and
            all(r.get("stack") == 0 and r.get("spill_stores") == 0 for r in k1f_ptxas + k2_ptxas),
            "every instantiation of the lookup's forward (D, F, read mode, layout) and of the camera composite keeps "
            "no stack frame and spills nothing")
    k45_ptxas = [r for r in ptxas if r["kernel"].split("<")[0] in (LIDAR_KERNEL, LIDAR_BWD_KERNEL)]
    require(len(k45_ptxas) == 6 and all(r.get("stack") == 0 and r.get("spill_stores") == 0 for r in k45_ptxas),
            "every instantiation of the lidar composite and its backward keeps no stack frame and spills nothing")
    p5_ptxas = [r for r in ptxas if r["kernel"].startswith(SERIAL_GATHER_KERNEL + "<")]
    require(len(p5_ptxas) == 4 and all(r.get("stack") == 0 and r.get("spill_stores") == 0 for r in p5_ptxas),
            "every instantiation of the serial gather probe (1, 2, 4, 8 pieces a pass) keeps no stack frame and "
            "spills nothing")

    phase_s = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        log(f"[time] {name} phase: {phase_s[name]:.1f} s")
        return out

    rng = np.random.default_rng(SEED)
    kernels = timed("kernel", kernel_phase, rng)
    torch.cuda.empty_cache()
    OUT_DIR.mkdir(exist_ok=True)
    slice_res, outputs = timed("slice", slice_phase)
    torch.cuda.empty_cache()
    hash_kernels = timed("hash_grid", hash_grid_phase, outputs, rng)
    torch.cuda.empty_cache()
    hash_bwd = timed("hash_grid_bwd", hash_grid_bwd_phase, outputs, rng)
    torch.cuda.empty_cache()
    probes = timed("probe", probe_phase)
    torch.cuda.empty_cache()
    neurad_res = timed("neurad", neurad_phase, outputs)
    gc.collect()  # the serving state's reference cycles (server, handler) go with their tables and copies
    torch.cuda.empty_cache()
    neurad_train_res = timed("neurad_train", neurad_train_phase, outputs)
    torch.cuda.empty_cache()
    train_res = timed("train", train_phase, outputs)
    torch.cuda.empty_cache()
    runs = {"splatad": Path(train_res["run_dir"]), "neurad": Path(neurad_train_res["run_dir"])}
    with RunCache() as cache:
        render_res = timed("render", render_phase, cache, runs)
        export_res = timed("export", export_phase, cache, runs)
        viewer_res = timed("viewer", viewer_phase, cache, runs)
    gc.collect()  # the viewers' handler classes close over their pipelines
    torch.cuda.empty_cache()
    splatfacto_res = timed("splatfacto", splatfacto_phase, outputs, rng)
    torch.cuda.empty_cache()
    nerfacto_res = timed("nerfacto", nerfacto_phase, outputs, rng)
    presets_res = timed("presets", presets_phase, outputs)
    gc.collect()
    torch.cuda.empty_cache()
    parity_res = timed("parity", parity_phase, outputs)
    gc.collect()
    torch.cuda.empty_cache()
    dp_res = timed("data_parallel", data_parallel_phase, outputs)
    library_res = timed("library", library_phase, outputs)
    del outputs
    torch.cuda.empty_cache()
    drive_res, drive_scene = timed("drive", drive_phase)
    api_res = timed("api", api_phase, drive_scene)
    fid_res = timed("fid", fid_phase)
    ref = timed("reference", reference_phase)
    ref["neurad"] = timed("neurad_reference", neurad_reference_phase)
    ref["neurad_train"] = timed("neurad_train_reference", neurad_train_reference_phase)
    ref["metrics"] = timed("metrics_reference", metrics_reference_phase)

    # name, source, the TPU kernel it replaces, and the main path whose launches are reported: the SplatAD
    # serving path for the forward composites (the train path launches them too: "train_launches"), the train
    # path for the backward composites, the NeuRAD serving path for the hash-grid lookup, the gather
    # microbenchmark's own run for the probes
    fwd, bwd = "neurad_tpu_torch/csrc/tile_composite.cu", "neurad_tpu_torch/csrc/tile_composite_bwd.cu"
    names = {"camera": ("tile_composite_camera_fwd", fwd, "neurad_tpu/ops/pallas_composite.py:54", slice_res),
             "camera_bwd": ("tile_composite_camera_bwd", bwd, "neurad_tpu/ops/pallas_composite.py:129", train_res),
             "lidar": ("tile_composite_lidar_fwd", fwd, "neurad_tpu/ops/pallas_composite.py:377", slice_res),
             "lidar_bwd": ("tile_composite_lidar_bwd", bwd, "neurad_tpu/ops/pallas_composite.py:467", train_res)}
    line = {"kernels": [
        {"name": names[key][0], "route": "cuda", "source": names[key][1],
         "replaces": names[key][2], "launches": names[key][3]["launches"][key],
         "train_launches": train_res["launches"][key], "drive_launches": drive_res["launches"][key],
         "data_parallel_launches": dp_res["launches"][key],
         # max_rel_err (backward kernels): the largest error of a column of the table's gradient over that
         # column's largest entry; their absolute errors are large because the gradients are (up to 1e11)
         "max_abs_err": r["max_abs_err"], "max_rel_err": r.get("max_rel_err"), "ms": r["ms"],
         "device_ms": r.get("device_ms"), "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
        for key, r in kernels.items()
    ]}
    # the camera composite and its backward at C = 3 (the CMAX = 8 form) on a splatfacto step's inputs
    for entry, key in zip(line["kernels"][:2], ("k2", "k3")):
        r = splatfacto_res[key]
        entry["splatfacto_launches"] = splatfacto_res["launches"][entry["name"].replace("tile_composite_", "").replace(
            "_fwd", "")]
        entry["c3"] = {m: r.get(m) for m in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                                             "max_rel_err")}
    # the lookup's line entry is the static grid at a serving chunk's N on uniform positions with bf16 reads of
    # the fp32 master, the case earlier runs reported; the serving state's case (ray-ordered positions, bf16
    # reads of the copy) and the others ride along
    main_k1 = "hash_grid_static_bf16_master"
    k1 = hash_kernels[main_k1]
    line["kernels"].append({
        "name": "hash_grid_fwd", "route": "cuda", "source": "neurad_tpu_torch/csrc/hash_grid.cu",
        "replaces": "neurad_tpu/ops/hash_encoding.py:492", "launches": neurad_res["launches"]["hash_grid"],
        "drive_launches": drive_res["launches"]["hash_grid"],
        "data_parallel_launches": dp_res["launches"]["hash_grid"],
        "parity_launches": parity_res["launches"]["hash_grid"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "device_ms": k1["device_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None, "parent": k1.get("parent"),
        "nerfacto_launches": nerfacto_res["nerfacto"]["launches"]["hash_grid"],
        "nerfacto": {k: v["fwd"] for k, v in nerfacto_res["lookups"].items()},
        "other_shapes": {k: {m: v.get(m) for m in ("ms", "device_ms", "plain_ms", "bound_ms", "max_abs_err", "parent")}
                         for k, v in hash_kernels.items() if k != main_k1}})
    # K1b's entry is the static grid of a train chunk with bf16 reads (the `neurad` preset's launch); its launches
    # are the NeuRAD train phase's
    k1b = hash_bwd["hash_grid_bwd_static_bf16"]
    line["kernels"].append({
        "name": "hash_grid_bwd", "route": "cuda", "source": "neurad_tpu_torch/csrc/hash_grid.cu",
        "replaces": "neurad_tpu/ops/hash_encoding.py:531", "launches": neurad_train_res["launches"]["hash_grid_bwd"],
        "drive_launches": drive_res["launches"]["hash_grid_bwd"],
        "data_parallel_launches": dp_res["launches"]["hash_grid_bwd"],
        "parity_launches": parity_res["launches"]["hash_grid_bwd"],
        "max_abs_err": k1b["max_abs_err"], "max_rel_err": k1b["max_rel_err"], "ms": k1b["ms"],
        "device_ms": k1b["device_ms"], "plain_ms": k1b["plain_ms"], "bound_ms": k1b["bound_ms"], "bound_by": k1b["bound_by"], "library_ms": None,
        "nerfacto_launches": nerfacto_res["nerfacto"]["launches"]["hash_grid_bwd"],
        "nerfacto": {k: v["bwd"] for k, v in nerfacto_res["lookups"].items()},
        "other_shapes": {k: {m: v[m] for m in ("ms", "device_ms", "plain_ms", "bound_ms", "max_rel_err")}
                         for k, v in hash_bwd.items() if k != "hash_grid_bwd_static_bf16"}})
    # the probes' line entries are the (131072, 32) table on uniform indices, the scatter-adds' with their
    # reading on skewed ones; every shape is in the report
    probe_names = {"coalesced": ("gather_rows_coalesced", "benchmarks/pallas_gather_microbench.py:54"),
                   "onehot": ("gather_rows_onehot", "benchmarks/pallas_gather_microbench.py:91"),
                   "serial": ("gather_rows_serial", "benchmarks/pallas_gather_microbench2.py:100"),
                   "scatter_onehot": ("scatter_rows_onehot", "benchmarks/pallas_gather_microbench.py:124"),
                   "scatter_blocked": ("scatter_rows_blocked", "benchmarks/pallas_gather_microbench.py:166"),
                   "scatter_serial": ("scatter_rows_serial", "benchmarks/pallas_gather_microbench2.py:134")}
    for key, (name, replaces) in probe_names.items():
        at = {r["skew"]: r for r in probes["records"] if r["name"] == key and (r["T"], r["F"]) == (131072, 32)}
        r = at["uniform"]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": "neurad_tpu_torch/csrc/gather_probes.cu", "replaces": replaces,
            "launches": probes["launches"][key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "library_device_ms": r["library_device_ms"],
            "table": [r["T"], r["F"]], "queries": r["N"]})
        if f"{key}_131072x32" in probes["parent"]:
            line["kernels"][-1]["parent"] = probes["parent"][f"{key}_131072x32"]
        if "hot" in at:
            line["kernels"][-1]["skewed"] = {m: at["hot"][m] for m in ("ms", "library_ms", "max_rel_err")}
    # the render, export and viewer paths of the trained runs: K2 and K4 (SplatAD), K1f (NeuRAD)
    by_name = {k["name"]: k for k in line["kernels"]}
    for name, key in (("tile_composite_camera_fwd", "camera"), ("tile_composite_lidar_fwd", "lidar"),
                      ("hash_grid_fwd", "hash_grid")):
        for path, res in (("render", render_res), ("export", export_res), ("viewer", viewer_res)):
            by_name[name][f"{path}_launches"] = res["launches"][key]
    runs_kernels = [(n, p) for n in ("tile_composite_camera_fwd", "tile_composite_lidar_fwd", "hash_grid_fwd")
                    for p in ("render", "viewer")] + [("tile_composite_lidar_fwd", "export"), ("hash_grid_fwd", "export")]
    require(all(by_name[n][f"{p}_launches"] > 0 for n, p in runs_kernels),
            "the render and viewer paths ran K2, K4 and K1f, the exports K4 and K1f")
    require(all(k["launches"] > 0 for k in line["kernels"]) and len(line["kernels"]) == 12,
            "all twelve kernels were launched on their main path")
    require(all(by_name[n]["data_parallel_launches"] > 0 for n in (
        "tile_composite_camera_fwd", "tile_composite_camera_bwd", "tile_composite_lidar_fwd", "tile_composite_lidar_bwd",
        "hash_grid_fwd", "hash_grid_bwd")), "the data-parallel paths ran K2-K5, K1f and K1b on every rank")
    require(by_name["hash_grid_fwd"]["parity_launches"] > 0 and by_name["hash_grid_bwd"]["parity_launches"] > 0,
            "the neurad-parity preset's serving and training ran K1f and K1b")
    REPORT.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi, kernels=kernels, hash_grid=hash_kernels,
                  hash_grid_bwd=hash_bwd, gather_probes=probes, slice=slice_res, neurad=neurad_res, ptxas=ptxas,
                  neurad_train=neurad_train_res, train=train_res, splatfacto=splatfacto_res, drive=drive_res,
                  nerfacto=nerfacto_res, presets=presets_res, parity=parity_res, render=render_res, export=export_res,
                  viewer=viewer_res, data_parallel=dp_res, library=library_res, api=api_res,
                  fid=fid_res, reference=ref, phase_seconds=phase_s,
                  seconds=time.perf_counter() - t_start)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1))
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        if RUNS is not None:
            shutil.rmtree(RUNS, ignore_errors=True)
    sys.exit(code)
