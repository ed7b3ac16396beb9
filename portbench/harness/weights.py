"""Weights drawn from the seed on the device, by a configuration's recipe.

A recipe (`weights.rules` of a configuration's file) is a list of rules, the
first whose `match` (a regular expression, searched in the parameter's name)
fits a parameter decides how it is drawn:

    keep     not drawn: the value the model derives from the scene (actor trajectories)
    const    every entry `value`
    uniform  U(lo, hi) from `range` [lo, hi]; lo and hi may be lists over the last axis
    boxes    rows uniform in boxes: `ranges` a list of [lo, hi] (lists over the last axis), `shares`
             the share of the rows in each, in order (the first rows in the first box)
    normal   N(0, std)
    fan_in   U(-1 / sqrt(fan_in), 1 / sqrt(fan_in)), fan_in the product of the shape but its first axis
    zeros    0

`set` ({flat index: value}) overwrites single entries after the draw. All
uniform draws come from one `torch.rand` and all normal draws from one
`torch.randn` of a generator on the device seeded with the seed, so the same
seed and the same list of shapes give the same weights, and set-up makes
them in two large calls.
"""

from __future__ import annotations

import itertools
import math
import re
from typing import Dict, List, Sequence, Tuple

import torch

Shapes = List[Tuple[str, Tuple[int, ...]]]
_SALT = 0x5EED_0F_3E1


def _rule(name: str, rules: Sequence[dict]) -> dict:
    for r in rules:
        if re.search(r["match"], name):
            return r
    raise KeyError(f"no weight rule matches parameter {name!r}")


def draw(shapes: Shapes, rules: Sequence[dict], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor} for every parameter of `shapes` whose rule is not `keep`."""
    plan = [(name, tuple(shape), _rule(name, rules)) for name, shape in shapes]
    sizes = {kind: sum(math.prod(s) for _, s, r in plan if r["init"] in kinds)
             for kind, kinds in (("rand", ("uniform", "fan_in", "boxes")), ("randn", ("normal",)))}
    gen = torch.Generator(device=device).manual_seed((int(seed) ^ _SALT) % 2**63)
    pools = {
        "rand": torch.rand(sizes["rand"], generator=gen, device=device),
        "randn": torch.randn(sizes["randn"], generator=gen, device=device),
    }
    offsets = {"rand": 0, "randn": 0}

    def take(pool: str, shape) -> torch.Tensor:
        n = math.prod(shape)
        out = pools[pool][offsets[pool]: offsets[pool] + n].view(shape)
        offsets[pool] += n
        return out

    out = {}
    for name, shape, r in plan:
        kind = r["init"]
        if kind == "keep":
            continue
        if kind == "const":
            w = torch.full(shape, float(r["value"]), device=device)
        elif kind == "zeros":
            w = torch.zeros(shape, device=device)
        elif kind == "uniform":
            lo = torch.as_tensor(r["range"][0], dtype=torch.float32, device=device)
            hi = torch.as_tensor(r["range"][1], dtype=torch.float32, device=device)
            w = lo + (hi - lo) * take("rand", shape)
        elif kind == "boxes":
            ends = [round(c * shape[0]) for c in itertools.accumulate(float(x) for x in r["shares"])]
            if ends[-1] != shape[0]:
                raise ValueError(f"{name}: the shares of its boxes do not add up to 1")
            counts = torch.tensor([b - a for a, b in zip([0] + ends[:-1], ends)], device=device)
            lo = torch.tensor([b[0] for b in r["ranges"]], dtype=torch.float32, device=device)
            hi = torch.tensor([b[1] for b in r["ranges"]], dtype=torch.float32, device=device)
            lo, hi = lo.repeat_interleave(counts, dim=0), hi.repeat_interleave(counts, dim=0)
            w = lo + (hi - lo) * take("rand", shape)
        elif kind == "fan_in":
            bound = 1.0 / math.sqrt(max(1, math.prod(shape[1:])))
            w = (2.0 * take("rand", shape) - 1.0) * bound
        elif kind == "normal":
            w = take("randn", shape) * float(r["std"])
        else:
            raise ValueError(f"unknown init {kind!r} for {name!r}")
        for index, value in r.get("set", {}).items():
            w.view(-1)[int(index)] = float(value)
        out[name] = w.contiguous()
    return out


def undrawn(shapes: Shapes, rules: Sequence[dict]) -> set:
    """The names of `shapes` whose rule keeps the model's own value."""
    return {name for name, _ in shapes if _rule(name, rules)["init"] == "keep"}


def shapes_of(module: torch.nn.Module) -> Shapes:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


@torch.no_grad()
def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `module`'s parameters of the same names; raises
    where a name is unknown or a shape differs."""
    params = dict(module.named_parameters())
    unknown = sorted(set(weights) - set(params))
    if unknown:
        raise KeyError(f"weights for parameters the model lacks: {unknown[:5]}")
    for name, w in weights.items():
        p = params[name]
        if tuple(p.shape) != tuple(w.shape):
            raise ValueError(f"{name}: the model holds {tuple(p.shape)}, the recipe drew {tuple(w.shape)}")
        p.copy_(w)
