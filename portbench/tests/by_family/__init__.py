"""Each family's own part of the CPU tests, one module a family, found by the
configuration's `family` (`portbench/tests/tiny.py`):

    tiny(config)     the configuration at a size a CPU runs in seconds
    LIMITS           {cell: {number compared: limit}} where the full size's limits do not hold
    answer_altered   (a family that serves) patches, through pytest's `monkeypatch`, the
                     family's render so that one block of the served image is wrong
    step_unchanged   (a family that trains) patches its step so that it computes the loss
                     and leaves the parameters as they were
    half_batch       (a family that trains) patches its step so that it takes the mean loss
                     of half of the batch

What the families' modules share is here."""

from __future__ import annotations

import numpy as np


def invert_block(monkeypatch, pipeline) -> None:
    """`pipeline.render_eval_camera` returns the image with its top left
    16 x 16 pixels inverted."""
    original = pipeline.render_eval_camera

    def altered(self, *args, **kwargs):
        rgb, gt = original(self, *args, **kwargs)
        rgb = np.array(rgb)
        rgb[:16, :16] = 1.0 - rgb[:16, :16]
        return rgb, gt

    monkeypatch.setattr(pipeline, "render_eval_camera", altered)
