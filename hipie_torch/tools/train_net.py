"""Training CLI: dataset -> mapper -> loader -> train steps -> checkpoints,
with evaluation every ``test.eval_period`` steps.

The port's twin of tools/train_net.py (reference projects/HIPIE/train_net.py):

    python -m hipie_torch.tools.train_net --config-file configs/overfit_tiny.yaml \\
        [--resume] [--weights model.pth] [--device cuda|cpu] [KEY VALUE ...]

It builds ``create_train_state`` -> one ``make_train_step`` per task in the
training mix -> ``Trainer`` over a ``TrainLoader`` of batch
``solver.ims_per_batch``, and an inline evaluation of ``data.test_dataset``
(unless ``--no-eval`` or ``test.eval_period`` 0). It runs on the card unless
``--device cpu`` is given; without a card the default raises. The JAX tool's
``--tp`` (XLA tensor-parallel sharding) is not taken; ``--tensorboard`` raises
(not ported).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Train HIPIE (PyTorch port).")
    p.add_argument("--config-file", default="")
    p.add_argument("--preset", default="r50_coco_panoptic")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--weights", default="")
    p.add_argument("--vocab", default="", help="bert vocab.txt path")
    p.add_argument("--log-period", type=int, default=20)
    p.add_argument("--no-eval", action="store_true",
                   help="disable eval-during-training (EvalHook)")
    p.add_argument("--tensorboard", action="store_true", help="not ported: raises")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("opts", nargs="*", default=[])
    return p.parse_args(argv)


def build_config(config_file: str, preset: str, opts: Sequence[str]):
    """A config from a YAML file (or a preset) with KEY VALUE overrides."""
    from hipie_torch import presets
    from hipie_torch.config import apply_overrides, load_config

    cfg = load_config(config_file) if config_file else getattr(presets, preset)()
    overrides = dict(zip(opts[::2], opts[1::2]))
    return apply_overrides(cfg, overrides) if overrides else cfg


def build_tokenizer(vocab: str):
    from hipie_torch.models.text.tokenizer import WordPieceTokenizer

    return WordPieceTokenizer.from_vocab_file(vocab) if vocab else WordPieceTokenizer.toy()


def build_trainer(argv: Optional[Sequence[str]] = None):
    """The Trainer the arguments describe (state, steps, loader, eval), before
    any resume or step; returns (trainer, parsed arguments)."""
    args = parse_args(argv)
    if args.tensorboard:
        raise NotImplementedError("--tensorboard is not ported")
    if args.eval_only:
        raise SystemExit("use hipie_torch.tools.eval_net for evaluation")
    from hipie_torch.data.loader import TrainLoader
    from hipie_torch.data.mapper import HIPIEMapper
    from hipie_torch.evaluation.evaluator import make_inline_eval_fn
    from hipie_torch.train.step import _device_of, create_train_state, make_train_step
    from hipie_torch.train.trainer import Trainer

    dev = _device_of(args.device)
    cfg = build_config(args.config_file, args.preset, args.opts)
    tok = build_tokenizer(args.vocab)
    mapper = HIPIEMapper(cfg.data, tok, is_train=True, max_gt=cfg.model.max_insts_num,
                         seed=cfg.seed)
    loader = TrainLoader(cfg.data, mapper, cfg.solver.ims_per_batch, seed=cfg.seed)
    state = create_train_state(cfg, seed=cfg.seed, device=dev)
    # one step per task in the training mix: batches are dataset-homogeneous,
    # so each batch has one task (reference train_net.py routes by dataset)
    steps = {t: make_train_step(cfg, state, task=t, device=dev)
             for t in sorted(set(loader.tasks))}
    eval_fn = (make_inline_eval_fn(cfg, state.model, tok, device=dev)
               if cfg.test.eval_period > 0 and not args.no_eval else None)
    trainer = Trainer(cfg, state, steps, loader, eval_fn=eval_fn, log_period=args.log_period,
                      device=dev)
    return trainer, args


def main(argv: Optional[Sequence[str]] = None):
    """Train as the arguments say; returns the Trainer."""
    trainer, args = build_trainer(argv)
    trainer.resume_or_load(args.weights or None, resume=args.resume)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
