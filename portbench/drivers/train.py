"""Traffic kind `train`: a configuration's training step driven as the
trainer drives it, through the family's feed (`Trainer.train`'s batches:
the datamanager's sampler threads and prefetch queue) and `train_step`, one
step after another, with no eval and no checkpoint in the window.

The traffic file's parameters:

    checked_steps   the first steps of the set-up, through the window's own feed and call, that the
                    reference follows (their losses, the first step's gradients, the parameters'
                    change after them); the window goes on from the same state

A family that trains provides `build_train`, `reseed_train`, `batches`,
`sampler_states` (the batch sampler's state before each checked batch, from
which the reference draws the batch again), `train_step`, `generator_state`,
`named_parameters`, `optimizers`, `reference_train` and `step_flops`.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict

import torch

from portbench.harness import weights as W

SPANS = ("next(batches)", "train_step")
FAULTS = ("half",)  # planted faults that stand in for the port in the control's readings


def variants(cell) -> tuple:
    """What stands in for the port in the control's readings: the control
    (the reference one precision below the configuration's, `control` in its
    file), then the planted faults."""
    return (cell.config["control"],) + FAULTS


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.detach().float().norm()) for n, t in tensors.items()}


def adam_gradients(named_parameters, optimizers: dict) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient as its optimizer got it, worked out from the
    optimizer's state after one step: Adam's first moment over (1 - beta1)."""
    names = {id(p): n for n, p in named_parameters}
    out = {}
    for opt in optimizers.values():
        for group in opt.param_groups:
            for p in group["params"]:
                state = opt.state.get(p, {})
                if "exp_avg" in state:
                    out[names[id(p)]] = state["exp_avg"] / (1.0 - group["betas"][0])
    return out


def run(ctx):
    """Set up the training state, drive its first steps through the feed
    (recorded for the check), train for the window, check the recorded
    steps against the reference."""
    cell, family = ctx.cell, ctx.family
    config, checked = cell.config, int(cell.traffic["checked_steps"])
    t_build = time.perf_counter()
    system = family.build_train(config, ctx.seed, ctx.device)
    t_built = time.perf_counter()
    feed = family.batches(system)
    recorded, losses, grads = [], [], {}
    with family.sampler_states(system) as states:
        for k in range(checked):
            args, _ = next(feed)
            recorded.append((states.of(args), family.generator_state(system)))
            losses.append(float(family.train_step(system, args)["total_loss"]))
            if k == 0:
                grads = _norms(adam_gradients(family.named_parameters(system), family.optimizers(system)))
    del states
    initial = W.draw(system.shapes, config["weights"]["rules"], ctx.seed, ctx.device)
    initial.update(system.own)
    changes = {n: float((p.detach() - initial[n]).float().norm()) for n, p in family.named_parameters(system)}
    del initial
    ctx.sync()
    setup_s = time.perf_counter() - ctx.started
    stages = ", ".join(f"{k} {v:.2f}" for k, v in system.setup.items())
    ctx.log(f"set-up {setup_s:.2f} s: before the build {t_build - ctx.started:.2f}, build {t_built - t_build:.2f} "
            f"({stages}), {checked} recorded steps {time.perf_counter() - t_built:.2f}; losses {losses}")

    gc.collect()
    gc.freeze()  # set-up's objects stay out of the collector's scans during the window
    rays = steps = 0
    try:
        with ctx.window():
            start = time.perf_counter()
            deadline = start + ctx.seconds
            while time.perf_counter() < deadline:
                with ctx.tracer.span("next(batches)"):
                    args, n_rays = next(feed)
                with ctx.tracer.span("train_step"):
                    family.train_step(system, args)
                rays += n_rays
                steps += 1
            ctx.sync()
            elapsed = time.perf_counter() - start
    finally:
        gc.unfreeze()
        feed.close()  # stops the sampler threads
    memory_peak = ctx.memory_peak()
    end_to_end = {"train_rays_per_s": rays / elapsed, "peak_mem_gib": memory_peak / 2**30, "setup_s": setup_s}
    per_layer = ctx.read_trace(span_names=SPANS)
    program = {"losses": losses, "grads": grads, "changes": changes}
    shapes = system.shapes
    del system, feed, args
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ctx.recorded, ctx.program, ctx.shapes = recorded, program, shapes  # for the control's readings
    t_check = time.perf_counter()
    checks = check(ctx, shapes, recorded, program)
    ctx.log(f"window {elapsed:.2f} s, {steps} steps; the check of {checked} steps against the reference "
            f"{time.perf_counter() - t_check:.2f} s")
    return dict(attempted=steps, failed=0, end_to_end=end_to_end, per_layer=per_layer, checks=checks,
                memory_peak_bytes=memory_peak)


def follow(ctx, shapes, recorded, precision: str = "stated", fault: str = "", scene=None) -> dict:
    """The reference (or the control, or a planted fault) through the
    recorded steps -> its losses, first gradients and changes."""
    ref, scene = ctx.family.reference_train(ctx.cell.config, shapes, ctx.seed, ctx.device, precision, scene)
    ref.fault = fault
    losses, grads = [], {}
    for k, (sampler_state, generator_state) in enumerate(recorded):
        losses.append(ref.step(sampler_state, generator_state))
        if k == 0:
            grads = _norms(ref.first_moments())
    out = {"losses": losses, "grads": grads, "changes": _norms(ref.changes()), "scene": scene}
    del ref
    return out


def readings(program: dict, ref: dict) -> Dict[str, float]:
    """The numbers a training run is judged by: the largest relative gap of a
    step's loss; of the worst leaf, the gap between the norms of the first
    gradient, and of the parameters' change after the recorded steps, each
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose reference gradient is under a
    thousandth of the median leaf's (nought to rounding) are left out."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(program["losses"], ref["losses"]))
    med_g = statistics.median(ref["grads"].values())
    leaves = [n for n, g in ref["grads"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["changes"][n] for n in leaves)

    def gap(key: str, name: str, med: float) -> float:
        return abs(program[key].get(name, 0.0) - ref[key][name]) / max(ref[key][name], med)

    return {"loss_rel": loss, "grad_gap": max(gap("grads", n, med_g) for n in leaves),
            "change_gap": max(gap("changes", n, med_c) for n in leaves)}


def control(ctx, variant: str, scene=None) -> dict:
    """The check's readings with `variant` (of `variants`) in the port's place,
    on the last run's recorded steps."""
    return check(ctx, ctx.shapes, ctx.recorded, ctx.program, served_by=variant, scene=scene)


def check(ctx, shapes, recorded, program: dict, served_by: str = "", scene=None) -> dict:
    """{name: (reading, limit)}. `served_by` a precision ("tf32", "fp8") or a
    fault ("half"): the control or the planted fault stands in for the port
    (their readings)."""
    ref = follow(ctx, shapes, recorded, scene=scene)
    ctx.scene = ref["scene"]
    if served_by in FAULTS:
        program = follow(ctx, shapes, recorded, fault=served_by, scene=ref["scene"])
    elif served_by:
        program = follow(ctx, shapes, recorded, precision=served_by, scene=ref["scene"])
    read = readings(program, ref)
    ctx.log(f"losses: port {program['losses']}, reference {ref['losses']}; readings {read}")
    limits = ctx.cell.limits
    return {name: (read.get(name, float("inf")), float(limits[name])) for name in limits}
