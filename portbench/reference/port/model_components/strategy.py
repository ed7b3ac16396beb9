"""Gaussian densification strategies at fixed capacity (torch port of
`neurad_tpu/model_components/strategy.py`).

The gaussian count is pinned at the capacity from initialisation. The MCMC
strategy relocates dead gaussians (opacity below a minimum) onto samples of
live ones; the Default strategy (absgrad grow/split/prune) encodes free slots
in-band as zero-radius, zero-opacity gaussians, so the arrays never change
shape. Every function is a pure update on a dict of tensors (`means` [N, 3],
`scales` log [N, 3], `quats` [N, 4], `opacities` logit [N], feature arrays
[N, ...], `id` [N]).

Random draws come from a `torch.Generator`; each function also takes its draws
as explicit tensors, so a test can hand the same numbers to both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from portbench.reference.port.ops.gaussians import quat_scale_to_covariance

_N_BINOM = 51  # max relocations per target, as in gsplat's compute_relocation


def _binom_table(n_max: int = _N_BINOM) -> np.ndarray:
    table = np.zeros((n_max, n_max), dtype=np.float32)
    for n in range(n_max):
        for k in range(n + 1):
            table[n, k] = math.comb(n, k)
    return table


_BINOMS = _binom_table()


def compute_relocation(
    opacities: torch.Tensor, scales: torch.Tensor, counts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """New (opacity, scales) when `counts` gaussians land on each target
    (Eq. 9 of 3DGS-MCMC). opacities [N] in (0, 1); scales [N, 3] linear;
    counts [N] >= 1."""
    n = counts.clamp(1, _N_BINOM)
    new_opacity = 1.0 - (1.0 - opacities) ** (1.0 / n.to(opacities.dtype))

    # denom = sum_{i=1..n} sum_{k=0..i-1} C(i-1, k) (-1)^k / sqrt(k+1) new_o^(k+1); scale *= old_o / denom
    k = torch.arange(_N_BINOM, dtype=opacities.dtype, device=opacities.device)
    a = ((-1.0) ** k / torch.sqrt(k + 1.0))[None, :] * new_opacity[:, None] ** (k + 1.0)  # [G, K]
    binoms = torch.from_numpy(_BINOMS).to(opacities.device)  # [I, K] with binoms[i-1, k] = C(i-1, k)
    s = a @ binoms.T  # [G, I]: s[:, i-1] = inner sum for i
    cum = torch.cumsum(s, dim=-1)
    denom = torch.gather(cum, -1, (n - 1).long()[:, None])[:, 0]
    coeff = opacities / torch.where(denom.abs() < 1e-12, torch.ones_like(denom), denom)
    return new_opacity, scales * coeff[:, None]


@dataclasses.dataclass(frozen=True)
class MCMCStrategyConfig:
    cap_max: int = 1_000_000
    noise_lr: float = 5e4
    min_opacity: float = 0.005
    refine_start_iter: int = 500
    refine_stop_iter: int = 25_000
    refine_every: int = 100


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[N] mask shaped to broadcast over `like` [N, ...]."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(1e-6, 1 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def _map_moments(moments: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    if isinstance(moments, dict):
        return {k: _map_moments(v, fn) for k, v in moments.items()}
    if isinstance(moments, (list, tuple)):
        return type(moments)(_map_moments(v, fn) for v in moments)
    return fn(moments)


@torch.no_grad()
def mcmc_relocate(
    generator: Optional[torch.Generator],
    params: Dict[str, torch.Tensor],
    opt_state_moments: Optional[Any],
    config: MCMCStrategyConfig,
    actor_bounds: Optional[torch.Tensor] = None,
    n_actors: int = 0,
    targets: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], Optional[Any]]:
    """Relocate dead gaussians onto opacity-weighted samples of live ones.

    Actor-aware: a relocated actor gaussian outside its actor box is clamped
    inside. opt_state_moments: optional nest of per-gaussian moment tensors to
    zero at relocated slots. targets [N]: the sampled live slot of every slot
    (drawn from `generator` when not given)."""
    op = torch.sigmoid(params["opacities"])
    n = op.shape[0]
    dead = op < config.min_opacity
    if targets is None:
        alive_probs = torch.where(dead, torch.zeros_like(op), op)
        alive_probs = alive_probs / alive_probs.sum().clamp_min(1e-12)
        targets = torch.multinomial(alive_probs, n, replacement=True, generator=generator)
    targets = targets.long()

    # per-target landing counts: itself + the dead slots pointing at it
    landed = torch.zeros(n, dtype=torch.int64, device=op.device).index_add_(0, targets, dead.to(torch.int64))
    counts = 1 + landed
    scales_lin = torch.exp(params["scales"])
    new_op_all, new_scales_all = compute_relocation(op, scales_lin, counts)

    new_params = {k: torch.where(_rows(dead, v), v[targets], v) for k, v in params.items()}
    # a target's updated opacity / scale apply to the target and to its clones
    upd_op = torch.where(landed > 0, new_op_all, op)
    upd_scales = torch.where((landed > 0)[:, None], new_scales_all, scales_lin)
    op_final = torch.where(dead, new_op_all[targets], upd_op)
    scales_final = torch.where(dead[:, None], new_scales_all[targets], upd_scales)
    new_params["opacities"] = _logit(op_final)
    new_params["scales"] = torch.log(scales_final.clamp_min(1e-12))

    if actor_bounds is not None and n_actors > 0:
        ids = new_params["id"].long().reshape(-1)
        bounds = actor_bounds[ids.clamp(0, max(n_actors - 1, 0))]
        clamped = torch.minimum(torch.maximum(new_params["means"], -bounds), bounds)
        new_params["means"] = torch.where((ids < n_actors)[:, None], clamped, new_params["means"])

    if opt_state_moments is not None:
        opt_state_moments = _map_moments(
            opt_state_moments, lambda m: torch.where(_rows(dead, m), torch.zeros_like(m), m)
        )
    return new_params, opt_state_moments


@torch.no_grad()
def mcmc_add_noise(
    generator: Optional[torch.Generator],
    params: Dict[str, torch.Tensor],
    lr_means: float,
    config: MCMCStrategyConfig,
    eps: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """SGLD-style exploration noise on the means: N(0, cov) * noise_lr * lr,
    gated so near-dead gaussians wander and confident ones stay. eps [N, 3]:
    the standard-normal draws (from `generator` when not given)."""
    means = params["means"]
    op = torch.sigmoid(params["opacities"])
    gate = torch.sigmoid(-(op - config.min_opacity) * 100.0)
    cov = quat_scale_to_covariance(params["quats"], torch.exp(params["scales"]))
    if eps is None:
        eps = torch.randn(means.shape, generator=generator, device=means.device, dtype=means.dtype)
    noise = torch.einsum("nij,nj->ni", cov, eps) * (gate * config.noise_lr * lr_means)[:, None]
    return {**params, "means": means + noise}


def should_refine(step: int, config: MCMCStrategyConfig) -> bool:
    return config.refine_start_iter < step < config.refine_stop_iter and step % config.refine_every == 0


# ---------------------------------------------------------------------------
# Default strategy (absgrad grow / split / prune) at fixed capacity. Dead slots
# are zero-radius, zero-opacity gaussians (log-scale DEAD_SCALE, opacity logit
# DEAD_OPACITY): the rasterizer's radius > 0 and alpha >= 1/255 gates skip
# them, so rendering needs no alive mask. Grow allocates from dead slots by
# gradient priority; prune returns slots to the dead pool.
# ---------------------------------------------------------------------------

DEAD_SCALE = -20.0  # log-scale of a dead slot (its radius underflows to 0)
DEAD_OPACITY = -15.0  # opacity logit of a dead slot (sigmoid ~ 3e-7)
_ALIVE_SCALE_THRESH = -19.0


@dataclasses.dataclass(frozen=True)
class DefaultStrategyConfig:
    prune_opa: float = 0.005
    grow_grad2d: float = 0.0002
    grow_scale3d: float = 0.01
    prune_scale3d: float = 0.1
    refine_start_iter: int = 500
    refine_stop_iter: int = 15_000
    reset_every: int = 3_000
    refine_every: int = 100
    pause_refine_after_reset: int = 0
    max_grow_per_refine: int = 1 << 16  # cap on grows per refine
    revised_opacity: bool = False


def alive_mask(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[N] bool: which capacity slots hold real gaussians."""
    return params["scales"].max(dim=-1).values > _ALIVE_SCALE_THRESH


def kill_slots(params: Dict[str, torch.Tensor], dead: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mark `dead` slots as free capacity (in-band encoding)."""
    p = dict(params)
    p["scales"] = torch.where(dead[:, None], torch.full_like(params["scales"], DEAD_SCALE), params["scales"])
    p["opacities"] = torch.where(dead, torch.full_like(params["opacities"], DEAD_OPACITY), params["opacities"])
    return p


def should_refine_default(step: int, config: DefaultStrategyConfig) -> bool:
    return (
        config.refine_start_iter < step < config.refine_stop_iter
        and step % config.refine_every == 0
        and step % config.reset_every >= config.pause_refine_after_reset
    )


@torch.no_grad()
def reset_opacities(params: Dict[str, torch.Tensor], config: DefaultStrategyConfig) -> Dict[str, torch.Tensor]:
    """Every reset_every steps: clamp live opacities to 2 * prune_opa."""
    cap = math.log(2.0 * config.prune_opa) - math.log1p(-2.0 * config.prune_opa)
    new_op = params["opacities"].clamp_max(cap)
    return {**params, "opacities": torch.where(alive_mask(params), new_op, params["opacities"])}


def _first_k_descending(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries, ties broken by the lower index (XLA's top_k order)."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


@torch.no_grad()
def default_refine(
    generator: Optional[torch.Generator],
    params: Dict[str, torch.Tensor],
    grad2d_avg: torch.Tensor,
    config: DefaultStrategyConfig,
    scene_scale: float,
    step: int,
    actor_bounds: Optional[torch.Tensor] = None,
    n_actors: int = 0,
    opt_state_moments: Optional[Any] = None,
    keep_u: Optional[torch.Tensor] = None,
    split_eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], Optional[Any]]:
    """One grow + prune refine with every shape static. grad2d_avg [N]: running
    mean of screen-space positional gradient norms (the absgrad criterion).
    Draws (from `generator` when not given): keep_u [N] uniform (which gaussians
    of an actor that would be wiped out survive), split_eps two [K, 3]
    standard-normal arrays (the two halves' offsets), K = min(max_grow, N)."""
    means = params["means"]
    dev = means.device
    n = means.shape[0]
    alive = alive_mask(params)
    op = torch.sigmoid(params["opacities"])
    scales_max = torch.exp(params["scales"]).max(dim=-1).values

    # ---- prune
    prune = alive & (op < config.prune_opa)
    if step > config.reset_every:
        prune = prune | (alive & (scales_max > config.prune_scale3d * scene_scale))

    ids = params["id"].long().reshape(-1)
    if actor_bounds is not None and n_actors > 0:
        is_actor = ids < n_actors
        seg = ids.clamp(0, n_actors - 1)
        outside = (means.abs() > actor_bounds[seg]).any(dim=-1)
        prune = prune | (is_actor & alive & outside)

        # never cull an actor to zero: where every live gaussian of an actor
        # would go, keep a random half (at least one) of them
        def per_actor_count(mask):
            return torch.zeros(n_actors, dtype=torch.int64, device=dev).index_add_(0, seg, mask.to(torch.int64))

        wiped = (per_actor_count(alive & ~prune & is_actor) == 0) & (per_actor_count(alive & is_actor) > 0)
        if keep_u is None:
            keep_u = torch.rand(n, generator=generator, device=dev)
        u = torch.where(alive & is_actor, keep_u, torch.full_like(keep_u, -1.0))
        u_max = torch.full((n_actors,), -float("inf"), device=dev).scatter_reduce(0, seg, u, reduce="amax")
        keep = wiped[seg] & alive & is_actor & ((u > 0.5) | (u >= u_max[seg]))
        prune = prune & ~keep

    new_alive = alive & ~prune
    p = kill_slots(params, prune)

    # ---- grow: duplicate small / split big high-gradient gaussians
    candidate = new_alive & (grad2d_avg > config.grow_grad2d)
    small = scales_max <= config.grow_scale3d * scene_scale
    is_split_all = candidate & ~small

    k = min(config.max_grow_per_refine, n)
    scores = torch.where(candidate, grad2d_avg, torch.full_like(grad2d_avg, -float("inf")))
    grow_scores, src = _first_k_descending(scores, k)
    free_flag, free_idx = _first_k_descending((~new_alive).to(torch.float32), k)
    n_free = (~new_alive).sum()
    grant = torch.isfinite(grow_scores) & (torch.arange(k, device=dev) < n_free) & (free_flag > 0.5)

    # writes that are not granted go to a sacrificial padding row (index n)
    dst = torch.where(grant, free_idx, torch.full_like(free_idx, n))
    is_split = is_split_all[src] & grant
    src_w = torch.where(is_split, src, torch.full_like(src, n))

    # split samples ~ N(mean, cov), scales / 1.6
    cov = quat_scale_to_covariance(p["quats"][src], torch.exp(p["scales"][src]))
    chol = torch.linalg.cholesky(cov + 1e-12 * torch.eye(3, device=dev))
    if split_eps is None:
        split_eps = tuple(torch.randn((k, 3), generator=generator, device=dev) for _ in range(2))
    off1 = torch.einsum("kij,kj->ki", chol, split_eps[0])
    off2 = torch.einsum("kij,kj->ki", chol, split_eps[1])
    split_scale = p["scales"][src] - math.log(1.6)

    new_params = dict(p)
    for key, arr in p.items():
        src_vals = arr[src]
        sel = _rows(is_split, src_vals)
        if key == "means":
            dst_vals = torch.where(sel, src_vals + off2, src_vals)
            upd_src = torch.where(sel, src_vals + off1, src_vals)
        elif key == "scales":
            dst_vals = upd_src = torch.where(sel, split_scale, src_vals)
        elif key == "opacities" and config.revised_opacity:
            # revised: 1 - sqrt(1 - o) for both halves
            rev = _logit(1.0 - torch.sqrt((1.0 - torch.sigmoid(src_vals)).clamp(0.0, 1.0)))
            dst_vals = upd_src = torch.where(sel, rev, src_vals)
        else:
            dst_vals = upd_src = src_vals
        arr_pad = torch.cat([arr, torch.zeros_like(arr[:1])], dim=0)
        arr_pad[src_w] = upd_src
        arr_pad[dst] = dst_vals
        new_params[key] = arr_pad[:n]

    # zero optimizer moments at every written slot
    if opt_state_moments is not None:
        written = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        written[dst] = True
        written[src_w] = True
        written = written[:n] | prune
        opt_state_moments = _map_moments(
            opt_state_moments, lambda m: torch.where(_rows(written, m), torch.zeros_like(m), m)
        )
    return new_params, opt_state_moments
