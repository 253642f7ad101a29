"""Training/eval data loaders with multi-dataset ratio sampling.

The port's copy of hipie_tpu/data/loader.py: the same sampler draws, the same
per-dataset buffers and thread prefetch; ``collate_train`` builds the port's
``TrainBatch`` and ``Targets`` as CPU torch tensors (the trainer moves each
batch to the card with ``TrainBatch.to``).

Behavioral parity target: reference hipie/data/custom_dataset_dataloader.py —
MultiDatasetSampler (:195-266, ratio-weighted infinite sampling with optional
repeat-factor upweighting) and MDAspectRatioGroupedDataset (:268-307, batches
grouped by dataset x aspect so every batch is single-dataset/single-task).

Batches carry static shapes: LSJ crops pad to one (crop, crop) bucket. One
worker thread prefetches batches.
"""

from __future__ import annotations

import threading
from queue import Queue
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hipie_torch.config import DataConfig
from hipie_torch.data.datasets import get_dataset, materialize_record
from hipie_torch.data.mapper import HIPIEMapper, MapperOutput
from hipie_torch.losses.criterion import Targets
from hipie_torch.train.step import TrainBatch


def rfs_repeat_factors(records: Sequence[Dict[str, Any]],
                       repeat_threshold: float = 0.001) -> np.ndarray:
    """LVIS repeat-factor sampling weights (reference wraps d2's
    RepeatFactorTrainingSampler, custom_dataset_dataloader.py:62-70):
      f(c) = fraction of images containing category c
      r(c) = max(1, sqrt(t / f(c)))
      r(img) = max over categories in the image.
    """
    n = len(records)
    cat_count: Dict[int, int] = {}
    img_cats = []
    for rec in records:
        cats = {int(a["category_id"]) for a in rec.get("annotations", [])}
        img_cats.append(cats)
        for c in cats:
            cat_count[c] = cat_count.get(c, 0) + 1
    rep = {c: max(1.0, float(np.sqrt(repeat_threshold / (cnt / n))))
           for c, cnt in cat_count.items()}
    return np.asarray(
        [max([rep[c] for c in cats], default=1.0) for cats in img_cats],
        np.float64)


class MultiDatasetSampler:
    """Infinite index stream: (dataset_idx, record_idx) with dataset ratios and
    optional per-dataset repeat-factor upweighting.

    One process (``num_shards`` 1) draws both from RandomState(seed), as JAX's
    sampler does. Data-parallel shards draw the dataset, hence the batch's task
    and size, from RandomState(seed), which every shard shares, and the
    record from RandomState(seed + shard_rank), so that all ranks take one
    task a step. (JAX's sampler seeds both from seed + shard_rank, so its
    hosts would take different tasks at one step.)"""

    def __init__(self, sizes: Sequence[int], ratios: Sequence[float],
                 seed: int = 0, shard_rank: int = 0, num_shards: int = 1,
                 repeat_factors: Optional[Sequence[Optional[np.ndarray]]] = None):
        self.sizes = list(sizes)
        p = np.asarray(ratios, np.float64)
        self.p = p / p.sum()
        self.rng = np.random.RandomState(seed + shard_rank)
        self.task_rng = self.rng if num_shards == 1 else np.random.RandomState(seed)
        self.shard_rank = shard_rank
        self.num_shards = num_shards
        self.within: List[Optional[np.ndarray]] = []
        for k, size in enumerate(self.sizes):
            rf = repeat_factors[k] if repeat_factors else None
            if rf is not None:
                rf = np.asarray(rf, np.float64)
                self.within.append(rf / rf.sum())
            else:
                self.within.append(None)

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        while True:
            d = int(self.task_rng.choice(len(self.sizes), p=self.p))
            w = self.within[d]
            if w is None:
                i = int(self.rng.randint(self.sizes[d]))
            else:
                i = int(self.rng.choice(self.sizes[d], p=w))
            yield d, i


def collate_train(outs: List[MapperOutput]) -> TrainBatch:
    """Stack mapper outputs (same bucket) into a TrainBatch of CPU tensors."""
    stack = lambda name: torch.from_numpy(np.stack([getattr(o, name) for o in outs]))
    t = Targets(
        labels=stack("labels"),
        boxes=stack("boxes"),
        masks=stack("masks"),
        positive_map=stack("positive_map"),
        is_thing=stack("is_thing"),
        valid=stack("valid"),
    )
    return TrainBatch(
        images=stack("image"),
        pad_mask=stack("pad_mask"),
        input_ids=stack("input_ids"),
        lang_mask=stack("attention_mask"),
        image_sizes=torch.from_numpy(np.asarray([o.image_size for o in outs], np.int32)),
        targets=t,
    )


class TrainLoader:
    """Ratio-sampled, dataset-homogeneous, bucket-padded infinite batches.

    Yields (task, TrainBatch) pairs; `task` is the emitting dataset's task
    ("detection"/"grounding"/...), constant within a batch by construction.
    Under data parallelism each rank's loader is shard ``shard_rank`` of
    ``num_shards`` with its share of the batch: every rank yields the same
    task at each step (``MultiDatasetSampler``)."""

    def __init__(self, cfg: DataConfig, mapper: HIPIEMapper,
                 batch_size: int, seed: int = 0,
                 shard_rank: int = 0, num_shards: int = 1,
                 prefetch: int = 2):
        self.cfg = cfg
        self.mapper = mapper
        self.batch_size = batch_size
        self.datasets = [get_dataset(n) for n in cfg.train_datasets]
        # per-dataset task (reference train_net.py:110-164 routes the loss/
        # forward task by dataset; batches are dataset-homogeneous so every
        # batch has exactly one task). Records carry "task"; default detection.
        self.tasks = [
            (ds[0].get("task", "detection") if len(ds) else "detection")
            for ds in self.datasets]
        self._buffers: Dict[int, List[MapperOutput]] = {}
        rfs_flags = cfg.dataset_use_rfs or (False,) * len(self.datasets)
        repeat = [rfs_repeat_factors(ds, cfg.rfs_repeat_threshold)
                  if use else None
                  for ds, use in zip(self.datasets, rfs_flags)]
        self.sampler = MultiDatasetSampler(
            [len(d) for d in self.datasets], cfg.dataset_ratios, seed,
            shard_rank, num_shards, repeat_factors=repeat)
        # per-dataset batch sizes (USE_DIFF_BS_SIZE): batches stay
        # dataset-homogeneous, each dataset at its own static batch size.
        if cfg.use_diff_bs_size and cfg.dataset_batch_sizes:
            self.batch_sizes = list(cfg.dataset_batch_sizes)
        else:
            self.batch_sizes = [batch_size] * len(self.datasets)
        self.bucket = (cfg.crop_size, cfg.crop_size) if cfg.lsj_crop else None
        self._queue: Queue = Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False

    def _make_batch(self, it):
        """Per-dataset buffers, reference MDAspectRatioGroupedDataset
        (:268-307): consume (dataset, index) pairs from the sampler — each
        index was drawn for ITS dataset, honoring size/RFS weights — and emit
        as soon as one dataset's buffer reaches its batch size. Batches stay
        dataset-homogeneous."""
        while True:
            d, i = next(it)
            buf = self._buffers.setdefault(d, [])
            buf.append(self.mapper(materialize_record(self.datasets[d][i]),
                                   bucket=self.bucket))
            if len(buf) >= self.batch_sizes[d]:
                self._buffers[d] = []
                return self.tasks[d], collate_train(buf)

    def _worker(self):
        it = iter(self.sampler)
        while True:
            self._queue.put(self._make_batch(it))

    def __iter__(self):
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            yield self._queue.get()


def test_loader(dataset_name: str, mapper: HIPIEMapper,
                bucket: Optional[Tuple[int, int]] = None):
    """bs=1 eval iterator (reference build_detection_test_loader)."""
    records = get_dataset(dataset_name)
    for r in records:
        yield mapper(materialize_record(r), bucket=bucket), r
