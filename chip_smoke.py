#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`neurad_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

`--parent DIR`: another checkout of this repository (say, the parent commit
unpacked with `git archive`); its hash-grid lookup, tile composite and
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
   and times both with CUDA events (and the forwards' and the lidar
   backward's device time from a CUDA graph); the bounds of the camera
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
   D=4, 4 levels), in each read mode (bf16 reads of the bf16 copy, bf16 reads
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
   N=32,768, D=4; the unpacked layout of `neurad-parity`) is held against its
   plain version, and the probe run includes the three scatter-add probes
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
8. Checks the card's renders (SplatAD and NeuRAD) and one train step's
   gradients of each model against the CPU path on small scenes, and the
   metric functions (exact LPIPS and Inception pool3 from seeded weights
   written by the port's converter, the VGG19 fallback LPIPS, the chamfer
   distance) on the card against the CPU on the same inputs.

Prints the card's name and power limit, one JSON line with the twelve
kernels' numbers, and as its last line {"ok": true, "device": {...}}. Any failure raises
and exits non-zero. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
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
LPIPS_TOL = 1e-4  # metric functions, card against CPU (fp32, TF32 off): relative
POOL3_TOL = dict(rtol=2e-3, atol=2e-4)  # as the CPU tests hold the pool3 features to JAX's
CHAMFER_TOL = 1e-5  # relative
K1B_RAYS = 8192  # one train chunk (ADPipelineConfig.train_ray_chunk) of the `neurad` preset ...
K1B_SAMPLES = 32  # ... times its field samples: the static lookup's N in a train step
REPORT = {}
PARENT = {}  # `--parent DIR`: the lookup and composite libraries built from that checkout's sources


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


def backward_check(label, table, outs, cots, plain_fn, valid_slots, pairs, input_bytes, c, extra_ops=0, least=None):
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
    of the suffix sum it divides."""
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
    require(bool((scale > 0).all()), f"{label}: every column gets a gradient")
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


def kernel_phase(rng):
    import torch

    from neurad_tpu_torch.ops import tile_composite as TC

    results = {}
    # --- camera (K2) ---
    args = camera_inputs(rng)
    table, tile_gauss, tile_valid, pix, times = args
    t_total, p, k, c = tile_gauss.shape[0], pix.shape[1], tile_gauss.shape[1], table.shape[1] - TC.ATTR
    got = TC.tile_composite_camera(*args)
    _sync()
    ref = TC.tile_composite_camera_plain(*args)
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    log(f"[kernels] camera T={t_total} P={p} K={k} C={c}: valid slots {float((tile_valid > 0).float().mean()):.3f}, "
        f"max abs err feat/depth/alpha = {errs}")
    require(all(math.isfinite(e) for e in errs), "camera kernel output is finite")
    require(errs[0] <= 1e-4 and errs[2] <= 1e-4, "camera kernel features/alpha within 1e-4 of the plain version")
    require(errs[1] <= 1e-4 * float(ref[1].abs().max()) + 1e-4, "camera kernel depth within 1e-4 relative")
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
    results["camera"] = dict(max_abs_err=max(errs), ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by,
                             pairs=pairs, nonzero_pairs=nonzero, far_pairs=far_pairs, ops=ops, bytes=bytes_moved,
                             errs=errs,
                             bound_every_pair_ms=bound_every_pair_ms, patch_pairs=patch_pairs,
                             far_patch_pairs=far_patches, lit_patch_pairs=lit_patches)
    log(f"[kernels] camera: {nonzero} of {pairs} valid pairs ({nonzero / pairs:.3f}) pass the alpha gate, "
        f"{far_pairs} ({far_pairs / pairs:.3f}) lie beyond the far cut; kernel "
        f"{ms:.4f} ms a call ({dev_ms:.4f} ms on the device), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {ops:.3e} ops, {bytes_moved:.3e} "
        f"bytes; {bound_every_pair_ms:.4f} ms counting the feature work on every valid pair); of {patch_pairs} valid "
        f"(8x4 patch, slot) pairs {far_patches / max(patch_pairs, 1):.3f} lie wholly beyond the far cut, "
        f"{lit_patches / max(patch_pairs, 1):.3f} have a positive alpha")
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
    outside = (pix[..., 0] > WIDTH) | (pix[..., 1] > HEIGHT)
    require(bool(outside.any()), "the last tile row reaches beyond the image")
    cots = _cotangents(rng, t_total, p, c, 2, outside)
    leaf = table.clone().requires_grad_(True)
    outs = TC.tile_composite_camera(leaf, tile_gauss, tile_valid, pix, times)
    results["camera_bwd"] = backward_check(
        "camera backward", leaf, outs, cots,
        lambda **kw: TC.tile_composite_camera_bwd_plain(table, tile_gauss, tile_valid, pix, times, *cots, **kw),
        n_valid, pairs, bytes_moved - t_total * p * (c + 2) * 4, c)
    del args, got, ref, table, tile_gauss, tile_valid, pix, times, cots, leaf, outs

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
    positions (where a train step's lookup runs), the actor grid (D = 4) and
    the unpacked layout of `neurad-parity`."""
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
    return results


def _train_chunk_gaussians(outputs, gen, n_rays=K1B_RAYS):
    """The static field's lookup inputs in one chunk of rays (a train chunk's
    K1B_RAYS by default): rays through random pixels of the scene's cameras,
    K1B_SAMPLES samples each spread over 1-80 m, ray-major, contracted into the
    grid's [0, 1]^3 with their cone radii as stds -> (positions [N, 3], stds
    [N])."""
    import math

    import torch

    from neurad_tpu_torch.cameras.cameras import generate_rays
    from neurad_tpu_torch.core.structs import GaussiansStd
    from neurad_tpu_torch.fields.spatial_distortions import scaled_scene_contraction_gaussian

    n = n_rays
    hw = torch.tensor([HEIGHT, WIDTH], dtype=torch.float32, device=DEVICE)
    idx = torch.randint(0, len(outputs.images), (n,), generator=gen, device=DEVICE)
    bundle = generate_rays(outputs.cameras, idx, torch.rand((n, 2), generator=gen, device=DEVICE) * hw)
    t = torch.exp(torch.rand((n, K1B_SAMPLES), generator=gen, device=DEVICE) * math.log(80.0)).sort(dim=-1).values
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
        zero_ms = cuda_time_ms(lambda: [torch.zeros_like(t) for t in tables])
        plain_ms = cuda_time_ms(lambda: HE.hash_grid_encode_bwd_plain(pos, std, tables, *layout, g), warmup=1, reps=3)
        key = f"{label}_{mode}"
        results[key] = dict(max_abs_err=abs_err, max_rel_err=err, run_to_run=run_diff, ms=ms, zero_fill_ms=zero_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, n=n, levels=n_levels,
                            bytes=bytes_moved, ops=ops, distinct_rows=touched, table_mib=table_bytes / 2**20)
        log(f"[k1b] {key}: error {err:.2e} of the terms' magnitude (two launches differ by {run_diff:.2e}); "
            f"K1b with its zero-filled gradient {ms:.4f} ms (the zero-fill alone {zero_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {bytes_moved:.3e} bytes, {ops:.3e} ops)")
        del got, again, want, mag


def hash_grid_bwd_phase(outputs, rng):
    """K1b at a train chunk's full width: the `neurad` preset's static grid on
    positions from the scene's cameras (bf16 and fp32 reads) and on as many
    positions in one cell of its coarsest level (bf16: every update of a
    level lands on one row), its actor grid (N = the compacted lookup's
    capacity, D = 4), and the unpacked layout of `neurad-parity` (fp32
    reads)."""
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
    """SplatAD training at full width through the pipeline's entry points."""
    import tempfile

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

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        run_dir = write_run_config(Path(tmp) / "run", "splatad", SyntheticDataParserConfig(**SCENE), cfg, SEED)
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
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30, eval=evaluated)


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
    1080p request served from it by `ClosedLoopState.from_run_dir`."""
    import tempfile

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

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        run_dir = write_run_config(Path(tmp) / "run", "neurad", SyntheticDataParserConfig(**SCENE), cfg, SEED)
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
                served_render_ms=render_ms, eval=evaluated)


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
    import tempfile

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
                        help="another checkout of this repository (an unpacked parent commit): its hash-grid lookup "
                             "and camera composite are built and timed in turns with this tree's")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
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
    del outputs
    torch.cuda.empty_cache()
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
         "train_launches": train_res["launches"][key],
         # max_rel_err (backward kernels): the largest error of a column of the table's gradient over that
         # column's largest entry; their absolute errors are large because the gradients are (up to 1e11)
         "max_abs_err": r["max_abs_err"], "max_rel_err": r.get("max_rel_err"), "ms": r["ms"],
         "device_ms": r.get("device_ms"), "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
        for key, r in kernels.items()
    ]}
    # the lookup's line entry is the static grid at a serving chunk's N on uniform positions with bf16 reads of
    # the fp32 master, the case earlier runs reported; the serving state's case (ray-ordered positions, bf16
    # reads of the copy) and the others ride along
    main_k1 = "hash_grid_static_bf16_master"
    k1 = hash_kernels[main_k1]
    line["kernels"].append({
        "name": "hash_grid_fwd", "route": "cuda", "source": "neurad_tpu_torch/csrc/hash_grid.cu",
        "replaces": "neurad_tpu/ops/hash_encoding.py:492", "launches": neurad_res["launches"]["hash_grid"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "device_ms": k1["device_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None, "parent": k1.get("parent"),
        "other_shapes": {k: {m: v.get(m) for m in ("ms", "device_ms", "plain_ms", "bound_ms", "max_abs_err", "parent")}
                         for k, v in hash_kernels.items() if k != main_k1}})
    # K1b's entry is the static grid of a train chunk with bf16 reads (the `neurad` preset's launch); its launches
    # are the NeuRAD train phase's
    k1b = hash_bwd["hash_grid_bwd_static_bf16"]
    line["kernels"].append({
        "name": "hash_grid_bwd", "route": "cuda", "source": "neurad_tpu_torch/csrc/hash_grid.cu",
        "replaces": "neurad_tpu/ops/hash_encoding.py:531", "launches": neurad_train_res["launches"]["hash_grid_bwd"],
        "max_abs_err": k1b["max_abs_err"], "max_rel_err": k1b["max_rel_err"], "ms": k1b["ms"],
        "plain_ms": k1b["plain_ms"], "bound_ms": k1b["bound_ms"], "bound_by": k1b["bound_by"], "library_ms": None,
        "other_shapes": {k: {m: v[m] for m in ("ms", "plain_ms", "bound_ms", "max_rel_err")}
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
    require(all(k["launches"] > 0 for k in line["kernels"]) and len(line["kernels"]) == 12,
            "all twelve kernels were launched on their main path")
    REPORT.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi, kernels=kernels, hash_grid=hash_kernels,
                  hash_grid_bwd=hash_bwd, gather_probes=probes, slice=slice_res, neurad=neurad_res, ptxas=ptxas,
                  neurad_train=neurad_train_res, train=train_res, fid=fid_res, reference=ref, phase_seconds=phase_s,
                  seconds=time.perf_counter() - t_start)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1))
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
