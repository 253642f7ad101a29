"""Demo CLI: panoptic or referring segmentation of one image, drawn to files.

The port's twin of tools/demo.py (reference projects/HIPIE/demo.py +
predictor.py VisualizationDemo), with the same flags plus ``--device`` and, as
train_net and eval_net take it, ``--config-file``:

    python -m hipie_torch.tools.demo --input img.jpg [--task detection|grounding]
        [--expression "the dog"] [--categories person,car,sky:stuff,road:stuff]
        [--preset r50_coco_panoptic | --config-file cfg.yaml] [--weights model.pth]
        [--vocab vocab.txt] [--confidence 0.5] [--output out.jpg] [--device cuda|cpu]

The image is read by ``image_io.load_image`` (PNG, and JPEG by the port's own
decoder). The model is HIPIEModel(cfg.model) with random weights from a seed of
0, then ``--weights`` through ``resume_or_load``; ``HIPIEPredictor`` runs it on
the card unless ``--device cpu`` is given (without a card the default raises).
It writes the instance masks blended over the image as ``<input>_vis.jpg``
(or ``--output``; ``image_io.write_jpeg``) and, where the result has one, the
panoptic map in ``colorize``'s palette as ``<output stem>_pan.png``
(``image_io.write_png``), with the JAX tool's colours.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np


def colorize(seg: np.ndarray) -> np.ndarray:
    rng = np.random.RandomState(0)
    palette = rng.randint(0, 255, (seg.max() + 2, 3), np.uint8)
    palette[0] = 0
    return palette[seg]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="HIPIE demo (PyTorch port).")
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="")
    p.add_argument("--task", default="detection", choices=["detection", "grounding"])
    p.add_argument("--expression", default="")
    p.add_argument("--categories", default="person,car,sky:stuff,road:stuff",
                   help="comma-separated, ':stuff' suffix for stuff classes")
    p.add_argument("--preset", default="r50_coco_panoptic")
    p.add_argument("--config-file", default="", help="YAML config (overrides --preset)")
    p.add_argument("--weights", default="")
    p.add_argument("--vocab", default="")
    p.add_argument("--confidence", type=float, default=0.5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the demo; returns the predictor's result and the paths written."""
    import torch

    from hipie_torch.data.image_io import load_image, write_jpeg, write_png
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.predictor import HIPIEPredictor
    from hipie_torch.tools.train_net import build_config, build_tokenizer
    from hipie_torch.train.checkpoint import resume_or_load
    from hipie_torch.train.step import TrainState, _device_of
    from hipie_torch.utils.weights import random_init_

    args = parse_args(argv)
    dev = _device_of(args.device)
    cfg = build_config(args.config_file, args.preset, ())
    tok = build_tokenizer(args.vocab)
    with torch.device(dev):
        model = HIPIEModel(cfg.model).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(0))
    if args.weights:
        resume_or_load("", TrainState(model, None), args.weights, resume=False)
    predictor = HIPIEPredictor(cfg, model, tok, device=dev)

    img = load_image(args.input)
    if args.task == "grounding":
        res = predictor(img, task="grounding", expressions=args.expression, score_thresh=-1)
    else:
        res = predictor(img, test_categories=args.categories.split(","),
                        score_thresh=args.confidence)

    vis = img.copy().astype(np.float32)
    for i, m in enumerate(res["instances"]["masks"]):
        color = np.random.RandomState(i).randint(0, 255, 3)
        vis[m] = 0.5 * vis[m] + 0.5 * color
    out_path = args.output or os.path.splitext(args.input)[0] + "_vis.jpg"
    write_jpeg(out_path, vis.astype(np.uint8))
    print(f"wrote {out_path}; {len(res['instances']['scores'])} instances")
    written = {"vis": out_path}
    if "panoptic_seg" in res:
        pan, segs = res["panoptic_seg"]
        pan_path = os.path.splitext(out_path)[0] + "_pan.png"
        write_png(pan_path, colorize(np.asarray(pan)))
        print(f"wrote {pan_path}; {len(segs)} segments")
        written["pan"] = pan_path
    return {"result": res, "written": written}


if __name__ == "__main__":
    main()
