"""Metric writers: the console, TensorBoard, Weights & Biases (torch port of
`neurad_tpu/utils/writer.py`). The trainer calls `write_scalars(step, dict)`
at each log line and eval. `TensorboardWriter` needs the `tensorboard`
package and `WandbWriter` the `wandb` package; each raises ImportError at
construction without it.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class Writer:
    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        raise NotImplementedError

    def write_image(self, step: int, name: str, image) -> None:
        pass

    def close(self) -> None:
        pass


class LocalWriter(Writer):
    """One console line a call: `[train] step=<step> key=value ...` (all
    keys, or `keys` in order; names starting with `_` are left out)."""

    def __init__(self, keys: Optional[List[str]] = None):
        self.keys = keys

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        keys = self.keys or [k for k in scalars if not k.startswith("_")]
        parts = [f"step={step}"]
        for k in keys:
            if k in scalars:
                v = scalars[k]
                parts.append(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}")
        print("[train] " + " ".join(parts), flush=True)


class TensorboardWriter(Writer):
    """TensorBoard event files under `log_dir`."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter  # needs the tensorboard package

        self._writer = SummaryWriter(log_dir=log_dir)

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        for k, v in scalars.items():
            self._writer.add_scalar(k, v, step)

    def write_image(self, step: int, name: str, image) -> None:
        import numpy as np

        self._writer.add_image(name, np.asarray(image), step, dataformats="HWC")

    def close(self) -> None:
        self._writer.close()


class WandbWriter(Writer):
    """A Weights & Biases run."""

    def __init__(self, project: str = "neurad-tpu", name: Optional[str] = None, **kwargs):
        import wandb  # optional package

        self._run = wandb.init(project=project, name=name, **kwargs)

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        self._run.log(scalars, step=step)

    def close(self) -> None:
        self._run.finish()


class MultiWriter(Writer):
    def __init__(self, writers: List[Writer]):
        self.writers = writers

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        for w in self.writers:
            w.write_scalars(step, scalars)

    def write_image(self, step: int, name: str, image) -> None:
        for w in self.writers:
            w.write_image(step, name, image)

    def close(self) -> None:
        for w in self.writers:
            w.close()
