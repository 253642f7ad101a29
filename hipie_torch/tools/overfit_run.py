"""The overfit recipe (configs/overfit_tiny.yaml) through the port's entry
points, and its summary: the port's quality check on a fixture the repository
makes itself.

    python -m hipie_torch.tools.overfit_run --work DIR [--device cuda|cpu]
        [--max-iter N] [KEY VALUE ...]

1. ``make_tiny_coco --root DIR/data --n-train 6 --refcoco`` (512x512 PNGs);
2. ``train_net --config-file configs/overfit_tiny.yaml output_dir DIR/run``
   (with the data root set to DIR/data), every step logged;
3. ``eval_net`` with DIR/run/model_<max_iter>.pth on coco_panoptic_train and
   on refcoco-unc-val.

It writes DIR/history.json (every step's metrics, task, data and step time,
and the inline evaluations) and prints, as its last line, one JSON object: the
medians of the losses over the step windows TRAINLOG.md reports for the JAX
package's run (1-100, 401-600, 901-1100, 1301-1500), the inline evaluations,
both eval_net results, the median data and step times and the data time's
share of the step, and the card (``nvidia-smi`` name and power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from pathlib import Path

import numpy as np

CONFIG = str(Path(__file__).resolve().parents[2] / "configs" / "overfit_tiny.yaml")
WINDOWS = ((1, 100), (401, 600), (901, 1100), (1301, 1500))
LOSSES = ("total_loss", "loss_ce", "loss_dice", "loss_dice_maskdino")


def window_medians(history, windows=WINDOWS):
    """Median of each loss over each window of 1-based steps, over all steps
    and, for the total, over each task's steps."""
    out = {}
    for lo, hi in windows:
        rows = [h for h in history if lo <= h["iter"] <= hi]
        if not rows:
            continue
        w = {k: float(np.median([h[k] for h in rows if k in h])) for k in LOSSES
             if any(k in h for h in rows)}
        for task in sorted({h["task"] for h in rows}):
            w[f"total_loss_{task}"] = float(np.median(
                [h["total_loss"] for h in rows if h["task"] == task]))
        out[f"{lo}-{hi}"] = w
    return out


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def main(argv=None):
    p = argparse.ArgumentParser(description="Run the overfit recipe and summarise it.")
    p.add_argument("--work", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--config-file", default=CONFIG)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--max-iter", type=int, default=0, help="0: the config's")
    p.add_argument("opts", nargs="*", default=[])
    args = p.parse_args(argv)

    data, run = os.path.join(args.work, "data"), os.path.join(args.work, "run")
    os.environ["HIPIE_DATASETS"] = data
    from hipie_torch.tools import eval_net, make_tiny_coco, train_net

    if not os.path.exists(data):
        make_tiny_coco.main(["--root", data, "--n-train", "6", "--size", str(args.size),
                             "--refcoco"])
    opts = ["output_dir", run, *args.opts]
    if args.max_iter:
        opts += ["solver.max_iter", str(args.max_iter)]
    trainer = train_net.main(["--config-file", args.config_file, "--device", args.device,
                              "--log-period", "1", *opts])
    history = trainer.history
    with open(os.path.join(args.work, "history.json"), "w") as f:
        json.dump(history, f)
    max_iter = trainer.state.step
    del trainer
    weights = os.path.join(run, f"model_{max_iter:07d}.pth")
    evals = {name: eval_net.main(["--config-file", args.config_file, "--dataset", name,
                                  "--weights", weights, "--device", args.device])
             for name in ("coco_panoptic_train", "refcoco-unc-val")}
    data_ms = [1e3 * h["data_time_s"] for h in history[1:]]
    step_ms = [1e3 * h["time_s"] for h in history[1:]]
    summary = {
        "steps": max_iter, "tasks": {t: sum(h["task"] == t for h in history)
                                     for t in sorted({h["task"] for h in history})},
        "loss_medians": window_medians(history),
        "inline_eval": {h["iter"]: h["eval"] for h in history if "eval" in h},
        "eval_net": evals,
        "median_data_ms": float(np.median(data_ms)) if data_ms else None,
        "median_step_ms": float(np.median(step_ms)) if step_ms else None,
        "data_share": float(sum(data_ms) / (sum(data_ms) + sum(step_ms))) if step_ms else None,
        "first_step_ms": 1e3 * history[0]["time_s"],
        "first_data_ms": 1e3 * history[0]["data_time_s"],
        "card": card(),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
