"""Evaluation CLI: run a dataset through the predictor and print its metrics.

The port's twin of tools/eval_net.py (reference train_net.py --eval-only:
Trainer.test + inference_on_dataset + the evaluator zoo):

    python -m hipie_torch.tools.eval_net --config-file configs/overfit_tiny.yaml \\
        --weights run/model_0001500.pth --dataset coco_panoptic_train [--device cpu] \\
        [--num-gpus N] [--tp T] [--dist-url tcp://host:port] [model.clip.enabled True ...]

The model is HIPIEModel(cfg.model) with random weights from ``cfg.seed``,
then ``--weights`` (a HIPIE state_dict under the reference's names, or a
train_net checkpoint) through ``resume_or_load``; it runs in f32 on the card
unless ``--device cpu`` is given (without a card the default raises).
RefCOCO splits give oIoU, sem-seg datasets mIoU, the rest box and mask AP
and, for panoptic datasets, PQ.

``--num-gpus N`` (or torchrun) shards the dataset over N ranks, as train_net
does: each predicts every N-th image and every rank computes the metrics of
one process from the gathered predictions (hipie_torch/evaluation/
evaluator.py); rank 0 prints them. ``--tp T`` shards the model over T
adjacent ranks, which predict the same images (hipie_torch/parallel/
tensor.py); the images are shared over the N / T data ranks.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate HIPIE (PyTorch port).")
    p.add_argument("--dataset", default="coco_2017_val")
    p.add_argument("--preset", default="r50_coco_panoptic")
    p.add_argument("--config-file", default="", help="YAML config (overrides --preset)")
    p.add_argument("--weights", default="")
    p.add_argument("--vocab", default="")
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--tasks", default="bbox,segm")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("opts", nargs="*", default=[], help="config overrides: key value ...")
    from hipie_torch.tools.train_net import add_launch_args

    add_launch_args(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Evaluate as the arguments say; returns the metrics (None where the ranks
    ran in processes of their own)."""
    from hipie_torch.parallel.mesh import launch
    from hipie_torch.tools.train_net import check_launch
    from hipie_torch.train.step import _device_of

    args = parse_args(argv)
    check_launch(args)
    _device_of(args.device)
    return launch(evaluate, args.num_gpus, args.dist_url, args.device, args)


def evaluate(args: argparse.Namespace, dev) -> Dict[str, float]:
    """The metrics of ``parse_args``'s arguments on ``dev``, as this rank of
    the process group if one is initialised (its share of the images)."""
    import torch

    from hipie_torch.data.datasets import DATASET_METADATA, get_dataset
    from hipie_torch.evaluation.evaluator import (evaluate_detection_dataset,
                                                  evaluate_refcoco_dataset,
                                                  evaluate_semseg_dataset)
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.parallel.mesh import create_mesh
    from hipie_torch.parallel.multihost import is_main_process
    from hipie_torch.predictor import HIPIEPredictor
    from hipie_torch.tools.train_net import build_config, build_tokenizer
    from hipie_torch.train.checkpoint import resume_or_load
    from hipie_torch.train.step import TrainState, _device_of
    from hipie_torch.utils.weights import random_init_

    create_mesh(tp=args.tp)
    dev = _device_of(dev)
    cfg = build_config(args.config_file, args.preset, args.opts)
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
    if is_main_process():
        print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
