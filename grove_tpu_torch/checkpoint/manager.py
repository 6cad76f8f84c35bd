"""Training checkpoints with the reference's best / latest / auto-resume
semantics (`train.py:489-501,685-702`).

Counterpart of `grove_tpu/checkpoint/orbax_io.py:18-87`, with the same
layout under a run's log directory:

* `ckpt_model/<step>/`: the parameters (the model's whole `state_dict()`,
  buffers included), the optimizer state and any extras of one step; the
  `max_to_keep` latest steps are kept (Orbax's `CheckpointManagerOptions(
  max_to_keep=2)`);
* `ckpt_model_best/params/`: the parameters of the best validation so far,
  with a marker file `epoch_{e}_val_{metric_name}_{value:.4f}.marker`
  beside it, which `best_metric_from_marker` parses.

Each checkpoint is one `torch.save` file (`STATE_FILE`) of CPU tensors,
ints and floats, read back with `weights_only=True`. The JAX package's
Orbax checkpoints of the same run layout (`ckpt_model/<step>/default`,
`ckpt_model_best/params`) are steps and best parameters too:
`latest_step`, `restore` and `restore_best` see them beside the port's own,
and restore them in the port's layout through `checkpoint.orbax_read`
(which needs `tensorstore`; without it they raise ImportError naming the
conversion to the port's layout). A save writes into a
hidden temporary directory and renames it into place, so a save killed
midway leaves no step that `latest_step` would pick. Restores come back on
the CPU, memory-mapped; the caller copies them onto its tensors.

Under `torch.distributed` every rank calls `save` / `save_best`: a
sharded tensor (a DTensor parameter or moment) is gathered whole first,
which takes every rank; rank 0 alone writes, and the others wait for it.
The files equal an unsharded run's.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional

import torch

from .orbax_read import ITEM, is_orbax
from .orbax_read import restore as orbax_restore

STATE_FILE = "state.pt"
_MARKER = re.compile(r"epoch_\d+_val_.+_([-\d.]+)\.marker")


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def to_cpu(tree):
    """A nest of dicts and tensors with every tensor detached on the CPU (a
    CPU tensor is cloned, so later in-place steps leave it alone; a DTensor
    is gathered whole, on every rank)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.clone() if t.device.type == "cpu" else t.to("cpu")
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree


def _write_dir(path: str, state: Dict[str, Any]) -> None:
    """`state` into `path/STATE_FILE`, published as `publish_dir` does."""
    publish_dir(path, lambda tmp: torch.save(
        state, os.path.join(tmp, STATE_FILE)))


def publish_dir(path: str, fill: Callable[[str], Any]) -> Any:
    """`fill(tmp)` writes a hidden temporary directory beside `path`, which
    is then renamed to `path` (an old `path` is replaced), so that a write
    killed midway publishes nothing. Returns what `fill` returns."""
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp-", dir=parent)
    try:
        out = fill(tmp)
        old = None
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=".old-", dir=parent)
            os.replace(path, os.path.join(old, "x"))
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return out


def _readable(path: str, item: str = ITEM) -> bool:
    """Whether `path` holds a checkpoint: the port's `STATE_FILE`, or an
    Orbax checkpoint (in its `item` subdirectory for a step)."""
    return (os.path.isfile(os.path.join(path, STATE_FILE))
            or is_orbax(os.path.join(path, item)))


def _read_dir(path: str, item: str = ITEM) -> Dict[str, Any]:
    """The port's `STATE_FILE` of `path`, else its Orbax checkpoint in the
    port's layout (`orbax_read.restore`)."""
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        return torch.load(os.path.join(path, STATE_FILE),
                          map_location="cpu", weights_only=True, mmap=True)
    return orbax_restore(os.path.join(path, item))


class CheckpointManager:
    def __init__(self, log_dir: str, max_to_keep: int = 2):
        self.log_dir = os.path.abspath(log_dir)
        self.ckpt_dir = os.path.join(self.log_dir, "ckpt_model")
        self.best_dir = os.path.join(self.log_dir, "ckpt_model_best")
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def steps(self):
        """The saved steps, ascending: the published directories of the
        port's saves and the JAX package's Orbax steps."""
        return sorted(int(d) for d in os.listdir(self.ckpt_dir)
                      if d.isdigit() and _readable(
                          os.path.join(self.ckpt_dir, d)))

    def save(self, step: int, params, opt_state=None,
             extra: Optional[Dict[str, Any]] = None):
        """Save one step, then drop all but the `max_to_keep` latest."""
        state = {"params": to_cpu(params)}
        if opt_state is not None:
            state["opt_state"] = to_cpu(opt_state)
        if extra:
            state["extra"] = to_cpu(extra)
        if _rank() == 0:
            _write_dir(os.path.join(self.ckpt_dir, str(step)), state)
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.ckpt_dir, str(old)))
        _barrier()

    def save_best(self, epoch: int, params, metric_name: str,
                  metric_value: float):
        """Best-checkpoint save + the reference-style marker file."""
        state = {"params": to_cpu(params)}
        if _rank() == 0:
            _write_dir(os.path.join(self.best_dir, "params"), state)
            for f in os.listdir(self.best_dir):
                if f.endswith(".marker"):
                    os.remove(os.path.join(self.best_dir, f))
            marker = os.path.join(
                self.best_dir,
                f"epoch_{epoch}_val_{metric_name}_{metric_value:.4f}.marker")
            open(marker, "w").close()
        _barrier()

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None):
        """{"params", "opt_state"?, "extra"?} of `step` (the latest by
        default), or None when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return _read_dir(os.path.join(self.ckpt_dir, str(step)))

    def restore_best(self):
        """{"params"} of the best checkpoint, or None."""
        path = os.path.join(self.best_dir, "params")
        if not _readable(path, item=""):
            return None
        return _read_dir(path, item="")

    def best_metric_from_marker(self) -> Optional[float]:
        if not os.path.isdir(self.best_dir):
            return None
        for f in os.listdir(self.best_dir):
            m = _MARKER.match(f)
            if m:
                return float(m.group(1))
        return None

    def close(self):
        """Saves are synchronous: nothing is left to wait for."""
