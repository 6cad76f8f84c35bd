"""Host-side data loader: sharded sampling + threaded prefetch.

Copy of `grove_tpu/data/loader.py` (the reference's torch DataLoader +
DistributedSampler, `train.py:452-463`): per-process index sharding and a
thread pool that overlaps video decode / preprocess with device compute
(the native decoder and numpy release the GIL). The process's rank and
the world size come from the arguments, else from `torch.distributed`
when it is initialized, else 0 and 1 (JAX asks `jax.process_index()` /
`process_count()`, `loader.py:40-43`).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from ..config import GroveConfig
from .collate import build_batch


def process_rank_world():
    """(rank, world size) of `torch.distributed` when it is initialized,
    else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class GroundingLoader:
    def __init__(self, dataset, tokenizer, cfg: GroveConfig,
                 batch_size: int = 1, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0,
                 with_labels: bool = True, drop_last: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 question_templates=None):
        from ..text.prompts import VIDEO_GROUNDING_QUESTIONS
        self.question_templates = (question_templates
                                   or VIDEO_GROUNDING_QUESTIONS)
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.with_labels = with_labels
        self.drop_last = drop_last
        rank, world = process_rank_world()
        self.rank = process_index if process_index is not None else rank
        self.world = process_count if process_count is not None else world
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # per-process shard (DistributedSampler semantics: pad to equal len)
        per = -(-n // self.world)
        padded = np.concatenate([idx, idx[:per * self.world - n]])
        return padded[self.rank::self.world]

    def __len__(self):
        per = len(self._indices())
        return per // self.batch_size if self.drop_last \
            else -(-per // self.batch_size)

    def __iter__(self) -> Iterator:
        idx = self._indices()
        rng = np.random.default_rng(self.seed * 1000 + self.epoch)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        def load_one(i):
            return self.dataset[int(i)]

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # prefetch up to 2 batches ahead
            pending = []
            it = iter(batches)
            def submit_next():
                try:
                    b = next(it)
                except StopIteration:
                    return False
                pending.append([pool.submit(load_one, i) for i in b])
                return True

            for _ in range(2):
                submit_next()
            while pending:
                futs = pending.pop(0)
                submit_next()
                samples = [f.result() for f in futs]
                yield build_batch(samples, self.tokenizer, self.cfg, rng,
                                  with_labels=self.with_labels,
                                  question_templates=self.question_templates)
