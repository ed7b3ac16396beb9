"""Traffic kind `closed_loop`: simulators that each ask for the next camera
frame as soon as the last one came back (no think time), through the port's
`ClosedLoopState.render_image`, with the actors moved through
`ClosedLoopState.update_actors` every so many requests.

The traffic file's parameters:

    camera                 the sensor a request renders (`render_image`'s camera_name)
    time_step_s            scene time between a client's requests, cycling over the scene's duration
    lateral_shifts_m       the ego's lateral offsets from the logged trajectory, one a request
    actor_update_every     requests between `update_actors` calls
    actor_ahead_m          [lo, hi]: each update moves each actor's trajectory along its heading so that, at
                           the update's scene time, the actor is this far ahead of the requested camera
    actor_shift_across_m   [lo, hi]: ... and across its heading, in the ground plane
    warmup_requests        requests (the first after an `update_actors`) served before the window
    check_requests         requests kept, at random from the seed, for the check against the reference,
                           beside the window's last request and its last request that moved the actors

Every seed serves the same work in another order: each run of
len(lateral_shifts_m) requests takes every shift once, and each run of
`PLACEMENTS` updates every one of that many evenly spaced distances ahead
and across once (the two in independent orders); the seed picks the orders
and the scene time the stream starts at.
"""

from __future__ import annotations

import dataclasses
import gc
import random
import time
from types import SimpleNamespace
from typing import List, Optional

import numpy as np

from portbench.reference.common import camera_index

SPANS = ("render_image", "update_actors")
PLACEMENTS = 10  # evenly spaced actor placements a block of updates takes, each once
FAULTS = ("stale_actors",)  # planted faults that stand in for the port in the control's readings


def variants(cell) -> tuple:
    """What stands in for the port in the control's readings: the control
    (the reference one precision below the configuration's, `control` in its
    file), then the planted faults: "stale_actors", the reference rendering
    every request with the actors where the scene logged them (a server that
    ignores `update_actors`)."""
    return (cell.config["control"],) + FAULTS


@dataclasses.dataclass
class Request:
    index: int
    pose: np.ndarray  # [4, 4] camera to world (OpenGL)
    time: float
    actors: Optional[List[dict]]  # trajectories to send with update_actors before the render, None: no update
    lateral: float = 0.0  # the ego's lateral offset (m)
    moved: tuple = ()  # the last update's shift of each actor (along, across; m)


class Requests:
    """The deterministic request stream of one seed over a scene's camera
    trajectory and actors (numpy arrays as the port's scene holds them)."""

    def __init__(self, traffic: dict, c2w: np.ndarray, times: np.ndarray, trajectories: List[dict], seed: int):
        self.t = traffic
        order = np.argsort(times)
        self.c2w, self.times = np.asarray(c2w, np.float64)[order], np.asarray(times, np.float64)[order]
        self.trajectories = trajectories
        self.rng = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), 0x7AFF1C]))
        span = float(self.times[-1] - self.times[0])
        self.steps = max(1, int(round(span / float(traffic["time_step_s"]))))
        self.offset = int(self.rng.integers(self.steps))
        self.moved: list = []
        self._shifts: list = []
        self._places: list = []

    def _lateral(self) -> float:
        """The next lateral shift: every shift once in each block, in the seed's order."""
        if not self._shifts:
            self._shifts = list(self.rng.permutation(np.asarray(self.t["lateral_shifts_m"], np.float64)))
        return float(self._shifts.pop())

    def _placement(self) -> tuple:
        """(ahead, across) of the next actor: fractions (k + 0.5) / PLACEMENTS of
        each range, every one once in each block, in two orders of the seed's."""
        if not self._places:
            levels = (np.arange(PLACEMENTS) + 0.5) / PLACEMENTS
            self._places = list(zip(self.rng.permutation(levels), self.rng.permutation(levels)))
        return self._places.pop()

    def pose_at(self, t: float) -> np.ndarray:
        """The logged camera's pose at scene time t: positions interpolated
        linearly, the rotation of the nearest frame before t."""
        i = int(np.clip(np.searchsorted(self.times, t, side="right") - 1, 0, len(self.times) - 2))
        t0, t1 = self.times[i], self.times[i + 1]
        a = 0.0 if t1 <= t0 else float(np.clip((t - t0) / (t1 - t0), 0.0, 1.0))
        pose = np.eye(4)
        pose[:3, :4] = self.c2w[i, :3, :4]
        pose[:3, 3] = (1 - a) * self.c2w[i, :3, 3] + a * self.c2w[i + 1, :3, 3]
        return pose

    def moved_actors(self, camera: np.ndarray, t: float) -> List[dict]:
        """The actors' trajectories moved for an update at scene time t, the
        requested camera at `camera` (a world position)."""
        lo_a, hi_a = self.t["actor_ahead_m"]
        lo_c, hi_c = self.t["actor_shift_across_m"]
        out, self.moved = [], []
        for traj in self.trajectories:
            frac_ahead, frac_across = self._placement()
            poses = np.array(traj["poses"], dtype=np.float32)
            heading = poses[-1, :3, 3] - poses[0, :3, 3]
            heading[2] = 0.0
            n = float(np.linalg.norm(heading))
            heading = heading / n if n > 1e-6 else poses[0, :3, 0] * np.array([1, 1, 0], np.float32)
            across = np.array([-heading[1], heading[0], 0.0], np.float32)
            stamps = np.asarray(traj["timestamps"], np.float64)
            now = np.array([np.interp(t, stamps, poses[:, k, 3]) for k in range(3)])
            along = lo_a + (hi_a - lo_a) * frac_ahead - float(np.dot(now - camera, heading))
            side = lo_c + (hi_c - lo_c) * frac_across
            self.moved.append((round(along, 2), round(side, 2)))
            shift = heading * along + across * side
            poses[:, :3, 3] += shift.astype(np.float32)
            out.append(dict(traj, poses=poses))
        return out

    def request(self, i: int, update: bool) -> Request:
        step = (self.offset + i) % (self.steps + 1)
        t = float(self.times[0] + step * float(self.t["time_step_s"]))
        pose = self.pose_at(t)
        lateral = self._lateral()
        pose[:3, 3] += pose[:3, 0] * lateral
        actors = self.moved_actors(pose[:3, 3], t) if update else None
        return Request(index=i, pose=pose.astype(np.float32), time=t, actors=actors, lateral=lateral,
                       moved=tuple(self.moved))


def _as_list(actors: List[dict]) -> List[dict]:
    return [{k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v) for k, v in a.items()} for a in actors]


def run(ctx):
    """Set up the cell's system, warm it, serve the window, check a sample of
    what it served against the reference."""
    cell, traffic = ctx.cell, ctx.cell.traffic
    t_build = time.perf_counter()
    system = ctx.family.build(cell.config, ctx.seed, ctx.device)
    t_built = time.perf_counter()
    state = system.state
    outputs = system.outputs
    logged = SimpleNamespace(cameras=outputs.cameras, trajectories=list(outputs.trajectories))  # before any request
    cam_idx = camera_index(outputs, traffic["camera"])
    frames = _frames_of(outputs, cam_idx)
    c2w = outputs.cameras.camera_to_worlds.numpy()[frames]
    times = outputs.cameras.times[frames, 0].numpy()
    stream = Requests(traffic, c2w, times, outputs.trajectories, ctx.seed)
    warm = Requests(traffic, c2w, times, outputs.trajectories, ctx.seed ^ 0x5A5A)
    every = int(traffic["actor_update_every"])

    actors = list(outputs.trajectories)  # the trajectories the server holds
    for i in range(int(traffic["warmup_requests"])):
        req = warm.request(i, update=i == 0)
        if req.actors is not None:
            actors = req.actors
            state.update_actors(_as_list(actors))
        state.render_image(req.pose, req.time, traffic["camera"])
    ctx.sync()
    setup_s = time.perf_counter() - ctx.started
    stages = ", ".join(f"{k} {v:.2f}" for k, v in system.setup.items())
    ctx.log(f"set-up {setup_s:.2f} s: before the build {t_build - ctx.started:.2f}, build {t_built - t_build:.2f} "
            f"({stages}), warm-up {time.perf_counter() - t_built:.2f}")

    gc.collect()
    gc.freeze()  # set-up's objects stay out of the collector's scans during the window, as in a long-lived server
    keep = random.Random(ctx.seed ^ 0xC4EC)
    kept, n_keep = [], int(traffic["check_requests"])
    latencies: List[float] = []
    failed, last, last_update = 0, None, None
    with ctx.window():
        start = time.perf_counter()
        deadline = start + ctx.seconds
        i = 0
        while time.perf_counter() < deadline:
            req = stream.request(i, update=i % every == 0)
            if req.actors is not None:
                actors = req.actors
                with ctx.tracer.span("update_actors"):
                    state.update_actors(_as_list(actors))
            with ctx.tracer.span("render_image"):
                t0 = time.perf_counter()
                try:
                    image = state.render_image(req.pose, req.time, traffic["camera"])
                except RuntimeError as err:  # a request that fails counts, and the run goes on
                    failed += 1
                    ctx.log(f"request {i} failed: {err}")
                    image = None
                latencies.append(time.perf_counter() - t0)
            served = (req, actors, image)
            if len(kept) < n_keep:  # a uniform sample of the window's requests (reservoir)
                kept.append(served)
            else:
                j = keep.randrange(i + 1)
                if j < n_keep:
                    kept[j] = served
            last = served
            if req.actors is not None:
                last_update = served
            i += 1
        elapsed = time.perf_counter() - start
    gc.unfreeze()
    memory_peak = ctx.memory_peak()
    n = len(latencies)
    ms = np.asarray(latencies) * 1e3
    end_to_end = {
        "request_p90_ms": float(np.percentile(ms, 90)) if n else float("nan"),
        "frames_per_s": n / elapsed,
        "peak_mem_gib": memory_peak / 2**30,
        "setup_s": setup_s,
    }
    per_layer = ctx.read_trace(span_names=SPANS)
    for extra in (last_update, last):
        if extra is not None and all(k[0].index != extra[0].index for k in kept):
            kept.append(extra)
    del state, outputs
    ctx.family.free_system(system)
    ctx.system, ctx.kept, ctx.logged = system, kept, logged  # for the control's readings (portbench/controls)
    t_check = time.perf_counter()
    checks = check(ctx, system, kept, logged)
    ctx.log(f"window {elapsed:.2f} s, {n} requests; the check of {len(kept)} against the reference "
            f"{time.perf_counter() - t_check:.2f} s")
    return dict(attempted=n, failed=failed, end_to_end=end_to_end,
                per_layer=per_layer, checks=checks, memory_peak_bytes=memory_peak)


def control(ctx, variant: str, scene=None) -> dict:
    """The check's readings with `variant` (of `variants`) in the port's place,
    on the last run's kept requests."""
    return check(ctx, ctx.system, ctx.kept, ctx.logged, served_by=variant, scene=scene)


def check(ctx, system, kept, logged, served_by: Optional[str] = None, scene=None) -> dict:
    """{name: (worst reading over the kept requests, limit)}: each kept
    image against the reference's render of the same request. `logged`: the
    port's scene as it was built (its cameras and actors must be the
    reference's). `served_by` a precision ("tf32", "fp8") or a fault
    ("stale_actors"): the images that the control or the planted fault
    renders for the kept requests stand in for the port's (their readings)."""
    from portbench.families.common import check_same_scene

    ref, scene = ctx.family.reference(ctx.cell.config, system, ctx.seed, ctx.device, "stated", scene)
    ctx.scene = scene
    check_same_scene(logged, scene)
    control = None
    if served_by is not None and served_by not in FAULTS:
        control, _ = ctx.family.reference(ctx.cell.config, system, ctx.seed, ctx.device, served_by, scene)
    worst = {}
    camera = ctx.cell.traffic["camera"]
    cam_idx = camera_index(scene, camera)
    for req, actors, image in kept:
        want = ref.render(req.pose, req.time, camera, _as_list(actors))
        if control is not None:
            image = control.render(req.pose, req.time, camera, _as_list(actors))
        elif served_by == "stale_actors":
            image = ref.render(req.pose, req.time, camera, _as_list(list(scene.trajectories)))
        mask = actor_mask(scene.cameras, cam_idx, req.pose, req.time, actors, want.shape[:2])
        read = readings(image, want, mask)
        ctx.log(f"request {req.index} (time {req.time:.1f}, lateral {req.lateral:+.0f} m, "
                f"actors moved {req.moved}, {int(mask.sum())} pixels in their boxes; "
                f"the reference's rms {float(np.sqrt(np.mean(want ** 2))):.4f}): {read}")
        for name, value in read.items():
            worst[name] = max(worst.get(name, 0.0), value)
    del ref, control
    limits = ctx.cell.limits
    return {name: (worst.get(name, float("inf")), float(limits[name])) for name in limits}


def actor_mask(cameras, cam_idx: int, pose: np.ndarray, time: float, actors: List[dict], shape) -> np.ndarray:
    """[H, W] bool: the pixels inside the image rectangle that bounds each
    actor's box (posed at `time`: positions interpolated, the rotation of the
    nearest earlier pose) as the camera `cam_idx`, at `pose` (OpenGL camera
    to world), sees it; empty where no box is in front of the camera."""
    h, w = shape
    fx, fy = float(cameras.fx[cam_idx, 0]), float(cameras.fy[cam_idx, 0])
    cx, cy = float(cameras.cx[cam_idx, 0]), float(cameras.cy[cam_idx, 0])
    scale_r, scale_c = h / float(cameras.height[cam_idx, 0]), w / float(cameras.width[cam_idx, 0])
    pose = np.asarray(pose, np.float64)
    rot, origin = pose[:3, :3], pose[:3, 3]
    grid = np.stack(np.meshgrid(*[np.linspace(-0.5, 0.5, 9)] * 3, indexing="ij"), -1).reshape(-1, 3)
    mask = np.zeros((h, w), dtype=bool)
    for actor in actors:
        poses = np.asarray(actor["poses"], np.float64)
        stamps = np.asarray(actor["timestamps"], np.float64)
        if not stamps[0] <= time <= stamps[-1]:
            continue
        k = int(np.clip(np.searchsorted(stamps, time, side="right") - 1, 0, len(stamps) - 1))
        centre = np.array([np.interp(time, stamps, poses[:, j, 3]) for j in range(3)])
        world = centre + (grid * np.asarray(actor["dims"], np.float64)) @ poses[k, :3, :3].T
        cam = (world - origin) @ rot  # camera frame: x right, y up, z backwards
        ahead = cam[:, 2] < -1e-3
        if not ahead.any():
            continue
        cam = cam[ahead]
        cols = (cx + fx * cam[:, 0] / -cam[:, 2]) * scale_c
        rows = (cy - fy * cam[:, 1] / -cam[:, 2]) * scale_r
        r0, r1 = int(np.clip(np.floor(rows.min()), 0, h)), int(np.clip(np.ceil(rows.max()), 0, h))
        c0, c1 = int(np.clip(np.floor(cols.min()), 0, w)), int(np.clip(np.ceil(cols.max()), 0, w))
        mask[r0:r1, c0:c1] = True
    return mask


def readings(got: np.ndarray, want: np.ndarray, mask: Optional[np.ndarray] = None) -> dict:
    """The numbers one served image is judged by: the largest absolute
    difference of a channel, the root of the mean squared difference, and
    that root over the pixels in the actors' boxes (`mask`; 0 where none is
    in view). A request that failed reads infinite."""
    if got is None or got.shape != want.shape or not np.isfinite(got).all():
        return {"rgb_max_abs": float("inf"), "rgb_rmse": float("inf"), "actor_rgb_rmse": float("inf")}
    d = got.astype(np.float64) - want.astype(np.float64)
    inside = d[mask] if mask is not None and mask.any() else np.zeros((1, 3))
    return {"rgb_max_abs": float(np.abs(d).max()), "rgb_rmse": float(np.sqrt(np.mean(d * d))),
            "actor_rgb_rmse": float(np.sqrt(np.mean(inside * inside)))}


def _frames_of(outputs, cam_idx: int) -> np.ndarray:
    """Indices of the camera frames of the same sensor as `cam_idx` (its logged trajectory)."""
    md = outputs.cameras.metadata
    n = outputs.cameras.camera_to_worlds.shape[0]
    if "sensor_idxs" not in md:
        return np.arange(n)
    sensors = md["sensor_idxs"][:, 0].numpy()
    return np.nonzero(sensors == sensors[cam_idx])[0]
