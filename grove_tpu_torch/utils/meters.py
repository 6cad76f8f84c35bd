"""Metric meters (reference `utils/utils.py:35-133`).

Counterpart of `grove_tpu/utils/meters.py`: `AverageMeter.all_reduce` sums
(sum, count) over `torch.distributed` when it is initialized (the
reference's `dist.all_reduce`), where JAX gathers them across hosts with
`multihost_utils`; alone it only recomputes the average.
"""

from __future__ import annotations

import time
from enum import Enum
from typing import List

import torch


class Summary(Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f",
                 summary_type: Summary = Summary.AVERAGE):
        self.name = name
        self.fmt = fmt
        self.summary_type = summary_type
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def all_reduce(self):
        """Sum (sum, count) across processes (reference `utils.py:56-77`)."""
        import torch.distributed as dist
        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            # the reduction lives where the backend can reach it
            device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
            total = torch.tensor([self.sum, float(self.count)],
                                 dtype=torch.float64, device=device)
            dist.all_reduce(total)
            self.sum = float(total[0])
            self.count = int(total[1])
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    def __init__(self, num_batches: int, meters: List[AverageMeter],
                 prefix: str = ""):
        self.batch_fmtstr = self._get_batch_fmtstr(num_batches)
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries), flush=True)

    @staticmethod
    def _get_batch_fmtstr(num_batches: int):
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"


class Timer:
    def __init__(self):
        self.t = time.time()

    def tick(self) -> float:
        now = time.time()
        dt = now - self.t
        self.t = now
        return dt
