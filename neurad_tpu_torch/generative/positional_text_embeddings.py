"""Position-conditioned text embeddings for generative 3D guidance (torch
port of `neurad_tpu/generative/positional_text_embeddings.py`).

Reference: `nerfstudio/generative/positional_text_embeddings.py`, the
DreamFusion trick of picking or blending "front/side/back/top view of ..."
prompts by the camera's angles. Tensor math over precomputed embeddings, so
it works with any backbone or with plain test tensors."""

from __future__ import annotations

from typing import Dict

import torch

_VIEWS = ("base", "top", "side", "back", "front")


class PositionalTextEmbeddings:
    """Select or blend view-dependent prompt embeddings.

    embeds: {base, top, side, back, front}, each [2, L, D] (uncond, cond),
    from `StableDiffusionGuidance.get_text_embeds` or any tensors.
    `positional_prompting` (`positional_text_embeddings.py:29-35`):
    "discrete" (the nearest view's prompt), "interpolated" (an angular
    blend) or "off" (the base prompt)."""

    def __init__(self, embeds: Dict[str, torch.Tensor], positional_prompting: str = "discrete"):
        missing = set(_VIEWS) - set(embeds)
        if missing:
            raise ValueError(f"missing prompt embeddings: {sorted(missing)}")
        self.embeds = {k: torch.as_tensor(v) for k, v in embeds.items()}
        if positional_prompting not in ("discrete", "interpolated", "off"):
            raise ValueError(f"unknown positional_prompting {positional_prompting!r}")
        self.positional_prompting = positional_prompting

    def __call__(self, vertical_angle: float, horizontal_angle: float) -> torch.Tensor:
        """The embedding for a camera at (vertical, horizontal) degrees
        (`positional_text_embeddings.py:78-121`); the horizontal angle wraps
        into [0, 360)."""
        e = self.embeds
        if self.positional_prompting == "off":
            return e["base"]
        horiz = float(horizontal_angle) % 360.0
        vert = float(vertical_angle)

        if self.positional_prompting == "discrete":
            if vert < 40.0:
                return e["top"]
            if horiz > 315.0 or horiz <= 45.0:
                return e["front"]
            if 135.0 < horiz <= 225.0:
                return e["back"]
            return e["side"]

        # interpolated: blend around the horizontal circle, then toward the top
        v = max(vert, 0.0)
        if horiz <= 90.0:
            blend = horiz * e["side"] + (90.0 - horiz) * e["front"]
        elif horiz <= 180.0:
            blend = (horiz - 90.0) * e["back"] + (180.0 - horiz) * e["side"]
        elif horiz <= 270.0:
            blend = (horiz - 180.0) * e["side"] + (270.0 - horiz) * e["back"]
        else:
            blend = (horiz - 270.0) * e["front"] + (360.0 - horiz) * e["side"]
        return (v * (blend / 90.0) + (90.0 - v) * e["top"]) / 90.0
