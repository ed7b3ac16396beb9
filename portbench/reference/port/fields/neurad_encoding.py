"""NeuRAD hash encoding: static world grid + 4D dynamic-actor grid, merged per
sample (torch port of `neurad_tpu/fields/neurad_encoding.py`).

The association keeps the JAX package's fixed-capacity, dense design, so both
give the same features for the same inputs:

1. Per ray, line-to-actor-centre distance over all actors [R, A]; eligible =
   (distance < actor radius) & present at the ray's time.
2. The K = max_actors_per_ray nearest eligible actors per ray [R, K].
3. Every sample is tested against its ray's K candidate boxes; the first hit
   wins.
4. Actor features are looked up in the chosen actor's frame (4D grid: actor id /
   n_actors as 4th coordinate), either densely for all samples or, with
   `actor_compaction`, only for a fixed-capacity subset of the samples that hit
   a box, and merged into the static features on the hit mask.

Ties are broken as `jax.lax.top_k` breaks them, by lowest index (stable
descending sorts): when more samples hit a box than the compacted lookup
holds, the first `cap` in flat order keep actor features and the rest keep
static ones. `torch.topk` promises no order among ties.

The two hash tables are `nn.ParameterList`s of 2-D per-level tables
(`ops/hash_encoding.py` has the layouts). The actors module is shared with the
model that owns it and is not registered here a second time. A model that
serves renders keeps bf16 copies of its tables (`keep_bf16_copies`): its
lookups without autograd then read half the bytes for the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.port.core.structs import GaussiansStd
from portbench.reference.port.fields.spatial_distortions import scaled_scene_contraction_gaussian
from portbench.reference.port.model_components.dynamic_actors import ActorEdits, DynamicActors
from portbench.reference.port.ops import hash_encoding as he

EPS = 1.0e-7


def first_k_set(flags: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first `k` entries of a flat bool vector in the order
    (set entries by index, then unset entries by index): `jax.lax.top_k` of
    the 0/1 vector, which breaks its ties by lowest index."""
    return torch.sort(flags.to(torch.uint8), descending=True, stable=True).indices[:k]


def _compact_merge(features_flat, sel_feats, top_idx, flat_hit):
    """Merge compacted actor features back into the dense feature array:
    out[i] = sel_feats[j] (zero-padded to the static width) where
    top_idx[j] == i and flat_hit[i], else features_flat[i]. `top_idx` is
    injective, so the merge is one narrow scatter (the inverse index map) and a
    gather from the small [cap, Fa] table."""
    n, f_out = features_flat.shape
    cap, f_a = sel_feats.shape
    assert f_a <= f_out, (
        f"actor feature width {f_a} exceeds static width {f_out}: "
        "configure the actor grid with num_levels*hashgrid_dim <= the static grid's"
    )
    slots = torch.arange(cap, device=top_idx.device)
    slot = torch.where(flat_hit[top_idx], slots, torch.full_like(slots, cap))
    inv = torch.full((n,), cap, dtype=torch.long, device=top_idx.device)
    inv[top_idx] = slot
    table = torch.cat([sel_feats, sel_feats.new_zeros((1, f_a))], dim=0)
    actor_rows = torch.index_select(table, 0, inv)  # [n, f_a]; most rows pick the zero row (atomic backward)
    if f_out > f_a:
        actor_rows = F.pad(actor_rows, (0, f_out - f_a))
    return torch.where((inv < cap)[:, None], actor_rows.to(features_flat.dtype), features_flat)


class StaticSettings(NamedTuple):
    """Static-world grid settings. `cell_packed` stores a cell's 8 corner
    features in one table row (corner features become per-cell). `parity`
    hashes every level into 2^log2_hashmap_size entries (no dense sizing, no
    bucket packing) with fp32 reads; `gather_f32` keeps the layout and reads
    fp32. (The JAX package's `run_dedup` and `segsum_grad_rows` choose orders
    of its backward's sum and have no counterpart here.)"""

    hashgrid_dim: int = 4
    num_levels: int = 8
    base_res: int = 32
    max_res: int = 8192
    log2_hashmap_size: int = 22
    cell_packed: bool = True
    parity: bool = False
    gather_f32: bool = False


class ActorSettings(NamedTuple):
    """Actor grid settings."""

    flip_prob: float = 0.5
    actor_scale: float = 10.0
    hashgrid_dim: int = 4
    num_levels: int = 4
    base_res: int = 64
    max_res: int = 1024
    log2_hashmap_size: int = 17
    cell_packed: bool = True
    parity: bool = False
    gather_f32: bool = False


class HashGrid:
    """Static layout of one grid: scales, dense resolutions, bucket packing."""

    def __init__(self, settings, d: int):
        self.cell_packed = settings.cell_packed
        self.force_hash = settings.parity
        self.features = settings.hashgrid_dim
        # log2_hashmap_size counts feature-slot capacity; cell packing widens rows
        # by 2^D, so the entry count divides by 2^D to keep table bytes constant
        self.table_size = max(2**settings.log2_hashmap_size // ((2**d) if settings.cell_packed else 1), 1)
        self.scales = he.level_scales(settings.num_levels, settings.base_res, settings.max_res)
        _, self.dense_res, self.pack = he.level_layout(self.scales, d, self.table_size, self.cell_packed,
                                                       self.force_hash)
        self.gather_dtype = None if (settings.parity or settings.gather_f32) else torch.bfloat16
        self.d = d
        self.copies: Optional[he.Bf16Copies] = None  # set by `keep_bf16_copies`

    def init(self, generator: torch.Generator) -> nn.ParameterList:
        tables = he.init_hash_tables(generator, self.scales, self.d, self.table_size, self.features,
                                     cell_packed=self.cell_packed, force_hash=self.force_hash)
        return nn.ParameterList([nn.Parameter(t) for t in tables])

    def encode(self, tables, g: GaussiansStd) -> torch.Tensor:
        return he.hash_encode_gaussians(g.mean, g.std, tables, self.scales, cell_packed=self.cell_packed,
                                        dense_res=self.dense_res, bucket_pack=self.pack,
                                        gather_dtype=self.gather_dtype, copies=self.copies)


def keep_bf16_copies(model: nn.Module) -> None:
    """Give every hash grid in `model` bf16 copies of its tables: a serving
    state's choice. A lookup with bf16 reads that builds no graph then reads
    the copy (the same bits, half the bytes); the first such lookup after a
    table changes makes the copy anew. They cost half the tables' bytes of
    device memory and are not worth making where the tables change every
    step. A grid that reads fp32 (`parity`, `gather_f32`) reads its masters
    and gets none."""
    for module in model.modules():
        if isinstance(module, NeuRADHashEncoding):
            for grid in (module.static_grid, module.actor_grid):
                if grid.gather_dtype is not None:
                    grid.copies = he.Bf16Copies()


class NeuRADHashEncoding(nn.Module):
    """Merged static + actor hash encoding. Call with gaussians
    [R, S, M(multisample), 3]-mean / [R, S, M, 1]-std, times [R, 1] (or
    [R, S, 1]), optional directions [R, S, 3]. Returns (features [R, S, F],
    directions, in the actor's frame where a sample hit a box).

    `flip_draw` [R]: uniform draws of the training-time actor flip (the x axis
    of positions and directions is mirrored on rays whose draw is below
    `actor.flip_prob`); None, the eval path, flips nothing."""

    def __init__(
        self,
        actors: DynamicActors,
        static_scale: float,
        static: StaticSettings = StaticSettings(),
        actor: ActorSettings = ActorSettings(),
        disable_actors: bool = False,
        require_actor_grad: bool = True,
        max_actors_per_ray: int = 4,
        actor_compaction: int = 8,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.__dict__["actors"] = actors  # shared with its owner; not registered again
        self.static_scale = static_scale
        self.static = static
        self.actor = actor
        self.disable_actors = disable_actors
        self.require_actor_grad = require_actor_grad
        self.max_actors_per_ray = max_actors_per_ray
        self.actor_compaction = actor_compaction
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.static_grid = HashGrid(static, 3)
        self.actor_grid = HashGrid(actor, 4)
        self.static_hash_table = self.static_grid.init(generator)
        self.actor_hash_table = self.actor_grid.init(generator)

    @property
    def out_dim(self) -> int:
        return self.static.num_levels * self.static.hashgrid_dim

    def forward(
        self,
        positions: GaussiansStd,
        times: torch.Tensor,
        directions: Optional[torch.Tensor] = None,
        flip_draw: Optional[torch.Tensor] = None,
        edits: Optional[ActorEdits] = None,
        actor_to_id: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        # ---- static world features ----
        static_g = scaled_scene_contraction_gaussian(positions, self.static_scale)
        features = self.static_grid.encode(self.static_hash_table, static_g)  # [R, S, L*F]

        actors = self.actors
        if self.disable_actors or actors.n_actors == 0:
            return features, directions

        # ---- actor association ----
        ray_times = times.reshape(times.shape[0], -1)[:, 0].contiguous()  # a ray's time is its first sample's
        boxes2world, valid = actors.get_boxes2world(ray_times, edits=edits)  # [R, A, 4, 4], [R, A]
        if not self.require_actor_grad:
            boxes2world = boxes2world.detach()

        bounds = actors.actor_bounds()  # [A, 3]
        radii = torch.linalg.norm(bounds, dim=-1)  # [A]
        sample_pos = positions.mean.mean(-2)  # [R, S, 3] multisample average

        p0 = sample_pos[:, 0, :]  # [R, 3]
        line_dir = sample_pos[:, -1, :] - p0
        # + EPS keeps the zero-direction rays that pad a chunk finite
        line_dir = line_dir / (torch.linalg.norm(line_dir, dim=-1, keepdim=True) + EPS)
        vec = boxes2world[..., :3, 3] - p0[:, None, :]  # [R, A, 3]
        dist_to_line = torch.linalg.norm(torch.linalg.cross(vec, line_dir[:, None, :].expand_as(vec), dim=-1), dim=-1)
        eligible = (dist_to_line < radii[None, :]) & valid

        k = min(self.max_actors_per_ray, actors.n_actors)
        score = torch.where(eligible, -dist_to_line, torch.full_like(dist_to_line, float("-inf")))
        order = torch.sort(score, dim=-1, descending=True, stable=True)
        top_score, cand_idx = order.values[:, :k], order.indices[:, :k]  # [R, K]
        cand_ok = torch.isfinite(top_score)

        cand_b2w = torch.gather(boxes2world, 1, cand_idx[:, :, None, None].expand(-1, -1, 4, 4))  # [R, K, 4, 4]
        # rigid inverse: R^T, -R^T t
        rot_t = cand_b2w[..., :3, :3].transpose(-1, -2)  # [R, K, 3, 3]
        inv_t = -torch.einsum("rkij,rkj->rki", rot_t, cand_b2w[..., :3, 3])

        # positions in every candidate's frame; the winner is selected by a one-hot contraction over K
        pos_km = torch.einsum("rkij,rsmj->rskmi", rot_t, positions.mean) + inv_t[:, None, :, None, :]  # [R,S,K,M,3]
        pos_in_box = pos_km.mean(-2)  # [R, S, K, 3]
        cand_bounds = bounds[cand_idx]  # [R, K, 3]
        inside = torch.all(pos_in_box.abs() < cand_bounds[:, None], dim=-1)  # [R, S, K]
        inside = inside & cand_ok[:, None, :]

        hit = inside.any(dim=-1)  # [R, S]
        first = inside.to(torch.uint8).argmax(dim=-1)  # [R, S] first candidate hit
        sample_actor = torch.gather(cand_idx, 1, first)  # [R, S]
        onehot = F.one_hot(first, k).to(pos_km.dtype)  # [R, S, K]

        # ---- transform to the actor's frame (+ random flip) ----
        pos_actor = torch.einsum("rsk,rskmi->rsmi", onehot, pos_km)  # [R, S, M, 3]
        dirs_actor = None
        if directions is not None:
            dirs_k = torch.einsum("rkij,rsj->rski", rot_t, directions)  # [R, S, K, 3]
            dirs_actor = torch.einsum("rsk,rski->rsi", onehot, dirs_k)
            dirs_actor = dirs_actor / (torch.linalg.norm(dirs_actor, dim=-1, keepdim=True) + EPS)

        if flip_draw is not None and self.actor.flip_prob > EPS:
            ray_flip = torch.where(flip_draw < self.actor.flip_prob, -1.0, 1.0).to(pos_actor.dtype)
            pos_actor = torch.cat([pos_actor[..., :1] * ray_flip[:, None, None, None], pos_actor[..., 1:]], dim=-1)
            if dirs_actor is not None:
                dirs_actor = torch.cat([dirs_actor[..., :1] * ray_flip[:, None, None], dirs_actor[..., 1:]], dim=-1)

        if dirs_actor is not None:
            directions = torch.where(hit[..., None], dirs_actor, directions)

        # ---- 4D actor grid lookup ----
        actor_g = scaled_scene_contraction_gaussian(
            GaussiansStd(mean=pos_actor, std=positions.std), self.actor.actor_scale
        )
        actor_ids = sample_actor if actor_to_id is None else actor_to_id[sample_actor]
        id_coord = actor_ids.to(features.dtype) / actors.n_actors  # [R, S]
        mean4 = torch.cat(
            [actor_g.mean, id_coord[..., None, None].expand(actor_g.mean.shape[:-1] + (1,))], dim=-1
        )
        r, s = hit.shape
        if self.actor_compaction > 0 and r * s > 256:
            # compacted lookup: gather the (at most) capacity samples that hit an actor box, encode only
            # those, merge the features back densely. Beyond the capacity, samples keep static features.
            cap = max(128, (r * s) // self.actor_compaction)
            flat_hit = hit.reshape(-1)
            flat_mean4 = mean4.reshape(r * s, *mean4.shape[2:])
            flat_std = actor_g.std.reshape(r * s, *actor_g.std.shape[2:])
            top_idx = first_k_set(flat_hit, cap)
            sel = GaussiansStd(mean=torch.index_select(flat_mean4, 0, top_idx),
                               std=torch.index_select(flat_std, 0, top_idx))
            sel_feats = self.actor_grid.encode(self.actor_hash_table, sel)  # [cap, La*Fa]
            merged = _compact_merge(features.reshape(r * s, features.shape[-1]), sel_feats, top_idx, flat_hit)
            return merged.reshape(r, s, -1), directions

        actor_feats = self.actor_grid.encode(self.actor_hash_table, GaussiansStd(mean=mean4, std=actor_g.std))
        pad = self.out_dim - actor_feats.shape[-1]
        if pad > 0:
            actor_feats = F.pad(actor_feats, (0, pad))
        features = torch.where(hit[..., None], actor_feats, features)
        return features, directions
