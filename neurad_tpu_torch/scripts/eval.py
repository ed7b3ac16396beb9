"""Evaluate a trained run: load its newest checkpoint, compute the pipeline's
eval metrics and, with `--fid`, the novel-view FID suite, and write them as
JSON (torch port of `neurad_tpu/scripts/eval.py`).

    python -m neurad_tpu_torch.scripts.eval outputs/<run> --device cpu
    python -m neurad_tpu_torch.scripts.eval outputs/<run> --fid --fid-max-images 4

Runs on a CUDA device unless `--device cpu` is given. Writes
{"checkpoint_step": ..., "results": {...}} to `--output` (default
`<run_dir>/eval.json`) and prints it.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from neurad_tpu_torch import resolve_device
from neurad_tpu_torch.scripts.train import load_run


def entrypoint(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Evaluate a trained neurad_tpu_torch run")
    parser.add_argument("run_dir", help="the train script's run directory")
    parser.add_argument("--output", default=None, help="JSON output path (default: <run_dir>/eval.json)")
    parser.add_argument("--fid", action="store_true",
                        help="also run the novel-view FID suite (lane and vertical shifts, actor edits)")
    parser.add_argument("--fid-max-images", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    pipeline, _ = load_run(args.run_dir, device=device)
    step = int(pipeline.latest_checkpoint(Path(args.run_dir) / "checkpoints").stem.split("-")[1])
    metrics = pipeline.eval_metrics()
    if args.fid:
        metrics.update(pipeline.eval_fid_suite(max_images=args.fid_max_images))
    result = {"checkpoint_step": step, "results": metrics}
    out_path = Path(args.output or (Path(args.run_dir) / "eval.json"))
    out_path.write_text(json.dumps(result, indent=2))
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    entrypoint()
