"""Per-parameter-group optimizers (torch port of `neurad_tpu/engine/optimizers.py`).

One `torch.optim.Adam` (or `AdamW` where the group has weight decay) per
group; a parameter's group is the first rule whose needle occurs in its name.
What the JAX package's optax chain does, and this module keeps:

- `eps` (1e-15) is added outside the square root;
- AdamW's decay is `-lr * weight_decay * p`, added to the Adam update;
- the schedule is read at the count before the update (the first step uses
  `schedule(0)`);
- every parameter is updated every step. optax sees a zero gradient where
  torch leaves `.grad` as None (a camera step gives the lidar decoder no
  gradient): its moments decay, its step count advances and its weight decay
  applies. `torch.optim` would skip such a parameter, so `step()` fills
  missing gradients with zeros first;
- `max_norm` clips a group's gradients by their global norm, as
  `optax.clip_by_global_norm` does (no epsilon in the divisor);
- `accum_steps` = k > 1 is `optax.MultiSteps(every_k_schedule=k)` around the
  group's clip and Adam: the group's gradients are averaged over k calls (a
  running mean, as optax takes it), its optimizer and schedule step on every
  k-th call with that mean, and its parameters do not move in between.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from neurad_tpu_torch.engine.schedulers import exponential_decay_schedule

DEFAULT_GROUP = "fields"

# Parameter name -> group for the ray-based models, first match wins: hash tables -> "hashgrids", actor
# trajectories -> "trajectory_opt", camera adjustments -> "camera_opt", the RGB decoder -> "cnn", the rest (the
# field and proposal MLPs, the lidar decoder, the appearance embedding) -> "fields". The port's parameter names
# carry the same substrings as the JAX package's flax paths, so the rules are the same.
DEFAULT_GROUP_RULES: Tuple[Tuple[str, str], ...] = (
    ("hash_table", "hashgrids"),
    ("actor_positions", "trajectory_opt"),
    ("actor_rotations_6d", "trajectory_opt"),
    ("actor_vel_", "trajectory_opt"),
    ("pose_adjustment", "camera_opt"),
    ("velocity_adjustment", "camera_opt"),
    ("time_to_center_pixel_adjustment", "camera_opt"),
    ("rgb_decoder", "cnn"),
)


@dataclasses.dataclass(frozen=True)
class OptimizerGroupConfig:
    """One parameter group's optimizer and schedule."""

    lr: float = 1e-3
    eps: float = 1e-15
    weight_decay: float = 0.0
    max_norm: Optional[float] = None  # gradient clipping per group
    accum_steps: int = 1
    lr_final: Optional[float] = None
    max_steps: int = 20001
    warmup_steps: int = 0
    lr_pre_warmup: float = 1e-8

    def schedule(self) -> Callable[[int], float]:
        return exponential_decay_schedule(self.lr, self.lr_final, self.max_steps, self.warmup_steps, self.lr_pre_warmup)

    def build(self, params: Sequence[torch.nn.Parameter]) -> torch.optim.Optimizer:
        if self.weight_decay > 0.0:
            return torch.optim.AdamW(params, lr=self.lr, eps=self.eps, weight_decay=self.weight_decay)
        return torch.optim.Adam(params, lr=self.lr, eps=self.eps)


# NeuRAD's optimizer preset: five groups.
NEURAD_OPTIMIZER_GROUPS: Dict[str, OptimizerGroupConfig] = {
    "trajectory_opt": OptimizerGroupConfig(lr=1e-3, lr_final=1e-4, warmup_steps=2500),
    "cnn": OptimizerGroupConfig(lr=1e-3, lr_final=1e-4, warmup_steps=2500, weight_decay=1e-6),
    "fields": OptimizerGroupConfig(lr=1e-2, lr_final=1e-3, warmup_steps=500, weight_decay=1e-7),
    "hashgrids": OptimizerGroupConfig(lr=1e-2, lr_final=1e-3, warmup_steps=500),
    "camera_opt": OptimizerGroupConfig(lr=1e-4, lr_final=1e-5, warmup_steps=2500),
}


def label_params(
    names: Iterable[str], rules: Sequence[Tuple[str, str]], default: str = DEFAULT_GROUP
) -> Dict[str, str]:
    """Parameter name -> group: the first rule whose needle occurs in the name."""
    return {name: next((group for needle, group in rules if needle in name), default) for name in names}


def learning_rates_at(groups: Dict[str, OptimizerGroupConfig], step: int) -> Dict[str, float]:
    """Each group's learning rate at `step`, for logging (`nerfstudio/engine/optimizers.py:198-202`)."""
    return {g: float(cfg.schedule()(step)) for g, cfg in groups.items()}


def _clip_by_global_norm(params: Sequence[torch.nn.Parameter], max_norm: float) -> None:
    norm = torch.sqrt(sum(torch.sum(p.grad.float() ** 2) for p in params))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for p in params:
        p.grad.mul_(scale)


class Optimizers:
    """The groups' optimizers over a module's named parameters."""

    def __init__(
        self,
        named_params: Iterable[Tuple[str, torch.nn.Parameter]],
        groups: Dict[str, OptimizerGroupConfig],
        rules: Sequence[Tuple[str, str]],
    ):
        named = list(named_params)
        self.labels = label_params((name for name, _ in named), rules)
        self.params: Dict[str, list] = {}
        for name, p in named:
            self.params.setdefault(self.labels[name], []).append(p)
        # a group without an explicit config falls back to the default group's
        fallback = groups.get(DEFAULT_GROUP, OptimizerGroupConfig())
        self.configs = {g: groups.get(g, fallback) for g in self.params}
        self.schedules = {g: cfg.schedule() for g, cfg in self.configs.items()}
        self.optimizers = {g: self.configs[g].build(ps) for g, ps in self.params.items()}
        self.count = 0  # calls of `step` so far
        self.updates = {g: 0 for g in self.params}  # each group's optimizer steps (fewer where it accumulates)
        # accumulating groups: the running mean of the gradients since the group's last update, and its length
        self.accum = {g: [torch.zeros_like(p) for p in ps] for g, ps in self.params.items()
                      if self.configs[g].accum_steps > 1}
        self.mini = {g: 0 for g in self.accum}

    def start_at(self, step: int) -> None:
        """Put the schedules at `step` of training, as a checkpoint of that
        step restores them: `count`, and each group's `updates` (one a window
        where it accumulates); the moments and the accumulators as they are
        (zero for fresh optimizers)."""
        state = self.state_dict()
        state.update(count=int(step), updates={g: int(step) // self.configs[g].accum_steps for g in self.params})
        self.load_state_dict(state)

    def learning_rates(self, step: Optional[int] = None) -> Dict[str, float]:
        """Each group's learning rate at `step` (default: at its next update)."""
        return {g: sched(self.updates[g] if step is None else step) for g, sched in self.schedules.items()}

    def zero_grad(self) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for g, opt in self.optimizers.items():
            for p in self.params[g]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if g in self.accum:
                n, acc = self.mini[g], self.accum[g]
                for p, a in zip(self.params[g], acc):
                    a.add_((p.grad - a) / (n + 1))
                self.mini[g] = (n + 1) % self.configs[g].accum_steps
                if self.mini[g] != 0:
                    continue
                for p, a in zip(self.params[g], acc):
                    p.grad.copy_(a)
                    a.zero_()
            if self.configs[g].max_norm is not None:
                _clip_by_global_norm(self.params[g], self.configs[g].max_norm)
            for group in opt.param_groups:
                group["lr"] = self.schedules[g](self.updates[g])
            opt.step()
            self.updates[g] += 1
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "updates": dict(self.updates), "mini": dict(self.mini),
                "accum": {g: [a.clone() for a in acc] for g, acc in self.accum.items()},
                "groups": {g: opt.state_dict() for g, opt in self.optimizers.items()}}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.updates = {g: int(state.get("updates", {}).get(g, self.count)) for g in self.params}
        for g, acc in self.accum.items():
            self.mini[g] = int(state["mini"][g])
            for a, saved in zip(acc, state["accum"][g]):
                a.copy_(saved)
        for g, opt in self.optimizers.items():
            opt.load_state_dict(state["groups"][g])
