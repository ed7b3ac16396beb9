#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`neurad_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every CUDA kernel from `neurad_tpu_torch/csrc/` (nvcc, sm_90a; one
   nvcc per source, started together).
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the full-width shapes of the main paths (camera tile composite and
   its backward: T=8160 tiles x P=256 pixels x K=256 slots, C=16; lidar tile
   composite and its backward: T=3780 x P=128 x K=128, C=16, azimuth wrap on),
   on inputs projected and binned from 500,000 seeded gaussians and, for the
   backwards, seeded cotangents that are zero on the rows outside the image,
   and times both with CUDA events.
3. Serving phase: builds the SplatAD pipeline on the synthetic scene at
   1920x1080 with 500,000 gaussians and a 64x1024-beam lidar, starts the
   closed-loop HTTP server on localhost, answers two /render_image requests at
   different poses and timestamps plus one lidar scan render, checks the
   outputs and that both forward kernels were launched on that path, then
   renders one more request under torch.profiler (device time by kernel).
4. Train phase: trains SplatAD through `SplatADPipeline.init_state`,
   `datamanager.next_train` and `train_step` on the same scene at full
   resolution (`num_downscales=0`), at least three camera and three lidar
   steps with MCMC refines among them, checks the losses, that every parameter
   group moved and that the backward kernels were launched once per step,
   profiles one step of each kind, writes a checkpoint into a run directory and
   serves a request from a `ClosedLoopState` loaded from it. One more camera
   step runs at the default schedule's first resolution (480x270).
5. Checks the card's renders and one train step's gradients against the CPU
   path on a small scene.

Prints the card's name and power limit, one JSON line with every kernel's
numbers, and as its last line {"ok": true, "device": {...}}. Any failure raises
and exits non-zero. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
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
REPORT = {}


def _sync() -> None:
    import torch

    if DEVICE != "cpu":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


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


def backward_check(label, table, outs, cots, plain_fn, valid_slots, pairs, input_bytes, c, extra_ops=0):
    """Hold a backward kernel (reached through its autograd function: `outs`
    were computed from `table`, which requires grad) against its plain version
    and time both. Tolerance per entry of the table's gradient: BWD_TOL times
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
    # per valid pair, what the function needs: alpha (~30) and the payload gradient (2c + 4) once, the gradient
    # terms (~45 + c) and the sum over a tile's pixels of the 10 + c terms. (The kernel evaluates alpha and the
    # payload gradient a second time, in its first pass: that is its overhead, not part of the bound.)
    ops = pairs * ((34 + 2 * c) + 45 + c + width + extra_ops)
    atomic_bytes = valid_slots * width * 4 * 2  # each valid slot's row of d_table read and written
    bytes_moved = input_bytes + sum(x.numel() * 4 for x in cots) + table.numel() * 4 + atomic_bytes
    bound_ms, bound_by = _bound(bytes_moved, ops)
    log(f"[kernels] {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{ops:.3e} ops, {bytes_moved:.3e} bytes of which {atomic_bytes:.3e} atomic traffic)")
    return dict(max_abs_err=float(err.max()), max_rel_err=max(rel_col), rel_err_by_column=dict(zip(names, rel_col)),
                max_err_over_term_sum=max(to_mag), err_over_term_sum_by_column=dict(zip(names, to_mag)),
                rows_off_1e3_relative=rows_off, run_to_run=run_to_run,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, pairs=pairs, ops=ops,
                bytes=bytes_moved, atomic_bytes=atomic_bytes)


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
    plain_ms = cuda_time_ms(lambda: TC.tile_composite_camera_plain(*args), warmup=1, reps=3)
    n_valid = int((tile_valid > 0).sum())
    pairs = n_valid * p
    ops = pairs * (32 + 2 * c)
    bytes_moved = (tile_gauss.numel() * 4 + tile_valid.numel() * 4 + pix.numel() * 4 + times.numel() * 4
                   + _row_bytes(table, tile_gauss, tile_valid) + t_total * p * (c + 2) * 4)
    bound_ms, bound_by = _bound(bytes_moved, ops)
    results["camera"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             pairs=pairs, ops=ops, bytes=bytes_moved, errs=errs)
    log(f"[kernels] camera: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{ops:.3e} ops, {bytes_moved:.3e} bytes)")

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
    med_pairs = 0
    for s, e, _g, w, _gd in TC._lidar_plain_chunks(*args, True, 128):
        acc = w.sum(-1, keepdim=True)
        cum = torch.cumsum(w, -1)
        ambiguous[s:e] = ((cum - 0.5 * acc).abs() <= 1e-5 * acc + 1e-12).any(-1) & (acc[..., 0] > 0)
        idx = TC.median_index(w, acc)[..., 0]
        med_pairs += int(((idx + 1) * (vmask[s:e] > 0)).sum())
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
    ms = cuda_time_ms(lambda: TC.tile_composite_lidar(*args, True, eps, True))
    plain_ms = cuda_time_ms(lambda: TC.tile_composite_lidar_plain(*args, True, eps, True), warmup=1, reps=3)
    # pass 1 needs every valid (query slot, gaussian slot) pair; the median pass
    # walks each valid query slot's list up to its crossing
    valid_per_tile = (tile_valid > 0).sum(1).to(torch.float64)
    queries_per_tile = (vmask > 0).sum(1).to(torch.float64)
    pairs = int((valid_per_tile * queries_per_tile).sum())
    ops = pairs * (39 + 2 * c) + med_pairs * 35
    bytes_moved = (tile_gauss.numel() * 4 + tile_valid.numel() * 4 + pts_slot.numel() * 4 + vmask.numel() * 4
                   + _row_bytes(table, tile_gauss, tile_valid) + t_total * p * (c + 4) * 4)
    bound_ms, bound_by = _bound(bytes_moved, ops)
    results["lidar"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            pairs=pairs, median_pairs=med_pairs, ops=ops, bytes=bytes_moved, errs=errs,
                            median_ties=n_ambiguous)
    log(f"[kernels] lidar: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{ops:.3e} ops, {bytes_moved:.3e} bytes)")

    # --- lidar backward (K5): cotangents on features, depth, accumulation and the line-of-sight sum ---
    cots = _cotangents(rng, t_total, p, c, 3)
    leaf = table.clone().requires_grad_(True)
    outs = TC.tile_composite_lidar(leaf, tile_gauss, tile_valid, pts_slot, vmask, True, eps, True)[:4]
    results["lidar_bwd"] = backward_check(
        "lidar backward", leaf, outs, cots,
        lambda **kw: TC.tile_composite_lidar_bwd_plain(table, tile_gauss, tile_valid, pts_slot, vmask, True, eps, *cots,
                                                       **kw),
        int((tile_valid > 0).sum()), pairs, bytes_moved - t_total * p * (c + 4) * 4, c, extra_ops=2)
    return results


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
        scan = 0
        _sync()
        t_l = time.perf_counter()
        lid = pipeline.render_eval_lidar(scan)
        lidar_s = time.perf_counter() - t_l
        launches = {"camera": TC.camera_launches, "lidar": TC.lidar_launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    n_pts = int(outputs.point_clouds[scan].shape[0])
    log(f"[slice] lidar scan: {n_pts} returns of {LIDAR_BEAMS[0] * LIDAR_BEAMS[1]} beams, {lid['depth'].shape[0]} query points, "
        f"render {lidar_s * 1e3:.1f} ms (synchronised, incl. copy to host)")
    for key in ("depth", "intensity", "ray_drop_logits"):
        require(bool(np.isfinite(lid[key]).all()), f"lidar {key} finite")
    log(f"[slice] kernel launches on the serving path: {launches}")
    require(launches["camera"] >= 2, "camera kernel launched for every request")
    require(launches["lidar"] >= 1, "lidar kernel launched for the scan")
    profile = {
        "camera": profiled("camera request", lambda: state.render_image(pose.tolist(), float(times[1]), "front_camera")),
    }

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
    return dict(requests=requests, lidar_ms=lidar_s * 1e3, lidar_returns=n_pts, launches=launches,
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
        profile[kind] = profiled(f"{kind} train step", lambda: pipeline.train_step(state, sample), rows=22)

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        run_dir = write_run_config(Path(tmp) / "run", "splatad", SyntheticDataParserConfig(**SCENE), cfg, SEED)
        ckpt = pipeline.save_checkpoint(state, run_dir / "checkpoints")
        size_mb = ckpt.stat().st_size / 2**20
        del pipeline, state, before
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        served = ClosedLoopState.from_run_dir(run_dir, device=DEVICE)
        load_s = time.perf_counter() - t0
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
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)


def profiled(label, fn, rows=15):
    """Run fn once more under torch.profiler: device time by kernel, and the
    device's busy share of the host-clock interval (profiler on)."""
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
    return dict(host_ms=host_ms, device_busy_ms=busy_ms, top=top)


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


def main() -> int:
    import torch

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
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        log_path = _build.BUILD_DIR / f"{name}.log"
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    kernels = kernel_phase(rng)
    torch.cuda.empty_cache()
    OUT_DIR.mkdir(exist_ok=True)
    slice_res, outputs = slice_phase()
    torch.cuda.empty_cache()
    train_res = train_phase(outputs)
    del outputs
    torch.cuda.empty_cache()
    ref = reference_phase()

    # name, source, the TPU kernel it replaces, and the main path whose launches are reported: the serving
    # path for the forward composites (the train path launches them too: "train_launches"), the train path
    # for the backward composites
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
         "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
        for key, r in kernels.items()
    ]}
    require(all(k["launches"] > 0 for k in line["kernels"]) and len(line["kernels"]) == 4,
            "all four kernels were launched on their main path")
    REPORT.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi, kernels=kernels, slice=slice_res,
                  train=train_res, reference=ref, seconds=time.perf_counter() - t_start)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1))
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
