"""Evaluation CLI: run a dataset through the predictor and print its metrics.

The port's twin of tools/eval_net.py (reference train_net.py --eval-only:
Trainer.test + inference_on_dataset + the evaluator zoo):

    python -m hipie_torch.tools.eval_net --config-file configs/overfit_tiny.yaml \\
        --weights run/model_0001500.pth --dataset coco_panoptic_train [--device cpu]

The model is HIPIEModel(cfg.model) with random weights from ``cfg.seed``,
then ``--weights`` (a HIPIE state_dict under the reference's names, or a
train_net checkpoint) through ``resume_or_load``; it runs in f32 on the card
unless ``--device cpu`` is given (without a card the default raises).
RefCOCO splits give oIoU, sem-seg datasets mIoU, the rest box and mask AP
and, for panoptic datasets, PQ.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description="Evaluate HIPIE (PyTorch port).")
    p.add_argument("--dataset", default="coco_2017_val")
    p.add_argument("--preset", default="r50_coco_panoptic")
    p.add_argument("--config-file", default="", help="YAML config (overrides --preset)")
    p.add_argument("--weights", default="")
    p.add_argument("--vocab", default="")
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--tasks", default="bbox,segm")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from hipie_torch.data.datasets import DATASET_METADATA, get_dataset
    from hipie_torch.evaluation.evaluator import (evaluate_detection_dataset,
                                                  evaluate_refcoco_dataset,
                                                  evaluate_semseg_dataset)
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.predictor import HIPIEPredictor
    from hipie_torch.tools.train_net import build_config, build_tokenizer
    from hipie_torch.train.checkpoint import resume_or_load
    from hipie_torch.train.step import TrainState, _device_of
    from hipie_torch.utils.weights import random_init_

    dev = _device_of(args.device)
    cfg = build_config(args.config_file, args.preset, ())
    tok = build_tokenizer(args.vocab)
    with torch.device(dev):
        model = HIPIEModel(cfg.model).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(cfg.seed))
    if args.weights:
        resume_or_load("", TrainState(model, None), args.weights, resume=False)
    predictor = HIPIEPredictor(cfg, model, tok, device=dev)

    records = get_dataset(args.dataset)
    max_images = args.max_images or None
    metadata = DATASET_METADATA.get(args.dataset, {})
    ev_type = metadata.get("evaluator_type", "coco")
    if "refcoco" in args.dataset:
        results = evaluate_refcoco_dataset(predictor, records, max_images)
    elif ev_type == "sem_seg":
        results = evaluate_semseg_dataset(predictor, records, metadata, max_images)
    else:
        meta = records[0]
        tasks = args.tasks.split(",")
        if ev_type == "panoptic" and "panoptic" not in tasks:
            tasks = tasks + ["panoptic"]
        results = evaluate_detection_dataset(
            predictor, records, len(meta["class_names"]), meta["class_is_thing"],
            tasks=tasks, max_images=max_images)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
