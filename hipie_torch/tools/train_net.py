"""Training CLI: dataset -> mapper -> loader -> train steps -> checkpoints,
with evaluation every ``test.eval_period`` steps.

The port's twin of tools/train_net.py (reference projects/HIPIE/train_net.py):

    python -m hipie_torch.tools.train_net --config-file configs/overfit_tiny.yaml \\
        [--resume] [--weights model.pth] [--device cuda|cpu] [--num-gpus N] [--tp T]
        [--dist-url tcp://host:port] [KEY VALUE ...]
    torchrun --nproc-per-node N -m hipie_torch.tools.train_net ...

It builds ``create_train_state`` -> one ``make_train_step`` per task in the
training mix -> ``Trainer`` over a ``TrainLoader``, and an inline evaluation of
``data.test_dataset`` (unless ``--no-eval`` or ``test.eval_period`` 0). It runs
on the card unless ``--device cpu`` is given; without a card the default
raises.

``--num-gpus N`` trains data-parallel on N ranks of this machine, one card
each over NCCL (``--device cpu``: N gloo ranks on the host), as the reference's
launch.py does; under torchrun each process is one rank. ``--dist-url`` is the
ranks' rendezvous (default: a free localhost port). Each rank takes
``max(solver.ims_per_batch // N, 1)`` images a step (JAX's tools/train_net.py
rule), from its shard of the loader; the step is the global batch's
(hipie_torch/train/step.py). More ranks than cards raise. ``--tp T`` shards
the model over T adjacent ranks (hipie_torch/parallel/tensor.py), JAX's
``--tp``: the N ranks form a (N / T, T) grid, data-parallel over N / T, and
each rank takes ``max(solver.ims_per_batch // (N / T), 1)`` images; a T that
does not divide N raises.
``--tensorboard`` mirrors the scalars to TensorBoard under ``<output_dir>/tb``
where torch.utils.tensorboard imports, and says so in one line where it does not.
"""

from __future__ import annotations

import argparse
import sys
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
    p.add_argument("--tensorboard", action="store_true",
                   help="mirror scalars to TensorBoard (<output_dir>/tb)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_launch_args(p)
    p.add_argument("opts", nargs="*", default=[])
    return p.parse_args(argv)


def add_launch_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--num-gpus", type=int, default=1,
                   help="data-parallel ranks on this machine, one card each")
    p.add_argument("--dist-url", default="", help="the ranks' rendezvous (default: a free "
                   "localhost port)")
    p.add_argument("--tp", type=int, default=1, help="tensor parallelism: ranks a model is "
                   "sharded over (divides the ranks; data parallelism over the rest)")


def check_launch(args) -> None:
    """Raise, before any rank starts, where --tp does not divide the ranks."""
    import os

    from hipie_torch.parallel.mesh import check_grid

    check_grid(int(os.environ.get("WORLD_SIZE", args.num_gpus)), args.tp)


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


def build_trainer(argv: Optional[Sequence[str]] = None, device=None):
    """The Trainer the arguments describe (state, steps, loader, eval), before
    any resume or step, on ``device`` (default ``--device``), as this rank of
    the process group if one is initialised; returns (trainer, parsed
    arguments)."""
    args = parse_args(argv)
    if args.eval_only:
        raise SystemExit("use hipie_torch.tools.eval_net for evaluation")
    from hipie_torch.data.loader import TrainLoader
    from hipie_torch.data.mapper import HIPIEMapper
    from hipie_torch.evaluation.evaluator import make_inline_eval_fn
    from hipie_torch.parallel.mesh import create_mesh, data_rank, data_size
    from hipie_torch.train.step import _device_of, create_train_state, make_train_step
    from hipie_torch.train.trainer import Trainer

    create_mesh(tp=args.tp)
    dev = _device_of(device if device is not None else args.device)
    cfg = build_config(args.config_file, args.preset, args.opts)
    tok = build_tokenizer(args.vocab)
    rank, n = data_rank(), data_size()
    # each rank its own augmentation stream (the reference seeds seed + rank)
    mapper = HIPIEMapper(cfg.data, tok, is_train=True, max_gt=cfg.model.max_insts_num,
                         seed=cfg.seed + rank)
    loader = TrainLoader(cfg.data, mapper, max(cfg.solver.ims_per_batch // n, 1), seed=cfg.seed,
                         shard_rank=rank, num_shards=n)
    state = create_train_state(cfg, seed=cfg.seed, device=dev)
    # one step per task in the training mix: batches are dataset-homogeneous,
    # so each batch has one task (reference train_net.py routes by dataset)
    steps = {t: make_train_step(cfg, state, task=t, device=dev)
             for t in sorted(set(loader.tasks))}
    eval_fn = (make_inline_eval_fn(cfg, state.model, tok, device=dev)
               if cfg.test.eval_period > 0 and not args.no_eval else None)
    trainer = Trainer(cfg, state, steps, loader, eval_fn=eval_fn, log_period=args.log_period,
                      device=dev)
    if args.tensorboard:
        trainer.storage.enable_tensorboard()
        if trainer.storage._tb is None:     # JAX's storage turns it off silently
            print("[train_net] --tensorboard: torch.utils.tensorboard does not import; "
                  "training without it")
    return trainer, args


def _train(argv, device):
    trainer, args = build_trainer(argv, device)
    trainer.resume_or_load(args.weights or None, resume=args.resume)
    trainer.train()
    return trainer


def main(argv: Optional[Sequence[str]] = None):
    """Train as the arguments say; returns the Trainer (None where the ranks
    ran in processes of their own)."""
    from hipie_torch.parallel.mesh import launch
    from hipie_torch.train.step import _device_of

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    check_launch(args)
    _device_of(args.device)
    return launch(_train, args.num_gpus, args.dist_url, args.device, argv)


if __name__ == "__main__":
    main()
