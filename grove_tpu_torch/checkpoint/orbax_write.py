"""Write the port's training runs as the JAX package's Orbax runs, with
numpy and json alone: the save half of `grove_tpu/checkpoint/orbax_io.py`
(`CheckpointManager.save` / `save_best`, `:29-64`), so that a run trained
on the card resumes under the JAX driver (`grove_tpu/train/driver.py:
373-384`, `ckpt.restore(latest, {"params", "opt_state"})`) and its best
parameters load into the JAX tools.

The layout is Orbax's own without OCDBT and without compression, which
needs no tensorstore (the card's machine has none) and which Orbax and
tensorstore read as they read their own:

* `ckpt_model/<step>/default/_METADATA`: JSON, every leaf's key path with
  its key types (2 a dict key or a named field, 1 a sequence index) and
  its value type ("jax.Array" with its `write_shape`, "scalar" for a
  Python number, "None" for an empty state or a frozen parameter's hole,
  "Tuple" for an empty tuple), with `use_ocdbt` and `use_zarr3` false;
* one zarr v2 directory per array leaf, named by its dotted key path:
  `.zarray` (`compressor` null, one chunk of the whole shape, C order) and
  that chunk's raw bytes in one file (`0.0` for a 2-D leaf, `0` for a
  scalar);
* `ckpt_model/<step>/_CHECKPOINT_METADATA` naming the item's handler, so
  that a restore without a template works too; `ckpt_model_best/params/`
  (of `{"params"}`, as `StandardCheckpointer` saves it) and the marker
  `epoch_{e}_val_{name}_{value:.4f}.marker` beside it.

`checkpoint.orbax_read.read_tree` reads this layout back with numpy alone.

The state: the parameters under their JAX paths in the JAX layouts
(`checkpoint.convert._jax_entry`, the map of `jax_tree_from_model`: the
copied converter's transposes, the ConvTranspose flip), each float leaf in
the dtype the port holds it (a bf16 leaf restores into the JAX driver's
fp32 template by Orbax's cast, exactly); the optimizer state as the JAX
driver's optimizer lays it out (`grove_tpu/train/step.py:121-135`), from
the port's optimizer config, since the chain's structure is not in the
port's state: optax's `chain(clip_by_global_norm, adamw)` or
`lowmem.adamw_bf16` (`grove_tpu/train/lowmem.py:86`), inside
`optax.MultiSteps` (`grove_tpu/train/driver.py:327`) when the port's
state is `train.step.MultiSteps`'. Each moment and accumulated gradient
goes under its parameter's JAX path in its layout, a frozen parameter's
under a "None" hole; the count goes into every count node of the chain,
the schedule's included. Each tensor is streamed to its chunk file in
pieces, from the card or the CPU; nothing stages the whole state in host
memory. A step is written into a hidden directory and published by a
rename (`manager.publish_dir`); the `max_to_keep` latest steps are kept.

    python -m grove_tpu_torch.checkpoint.orbax_write SRC DST [driver flags]

rewrites the port run at SRC (its steps, best parameters and marker) as a
JAX run at DST; the training driver's flags that the run was trained with
(`--model_size`, `--moment_dtype`, `--grad_clip`, ...) give the config.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from .convert import _jax_entry, _nest, jax_entries
from .manager import CheckpointManager, publish_dir
from .orbax_read import ITEM, METADATA, ZARR_DTYPES

CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
PIECE_BYTES = 64 << 20        # a tensor goes to its file in pieces of this
_ZARR_OF = {dt: name for name, dt in ZARR_DTYPES.items()}
_DICT, _SEQ = 2, 1            # Orbax's key types


class Fields:
    """A named tuple of the JAX state (an optax state): its fields in
    order, each a key of type 2 (a dict's keys are sorted instead)."""

    def __init__(self, **fields):
        self.items = list(fields.items())


def _flat(node, keys: Tuple[str, ...] = (), types: Tuple[int, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], Tuple[int, ...], object]]:
    """(key path, key types, leaf) in JAX's flatten order: dict keys
    sorted, named fields and tuple items in order. Leaves: tensors, Python
    numbers, None (an empty state or a hole) and the empty tuple."""
    if isinstance(node, Fields):
        items, kind = node.items, _DICT
    elif isinstance(node, dict):
        items, kind = sorted(node.items()), _DICT
    elif isinstance(node, tuple) and node:
        items, kind = [(str(i), v) for i, v in enumerate(node)], _SEQ
    else:
        yield keys, types, node
        return
    for k, v in items:
        yield from _flat(v, keys + (k,), types + (kind,))


def _value_metadata(leaf) -> Dict:
    if leaf is None:
        return {"value_type": "None", "skip_deserialize": True}
    if isinstance(leaf, tuple):
        return {"value_type": "Tuple", "skip_deserialize": True}
    if isinstance(leaf, torch.Tensor):
        return {"value_type": "jax.Array", "skip_deserialize": False,
                "write_shape": list(leaf.shape)}
    if isinstance(leaf, (bool, int, float)):
        return {"value_type": "scalar", "skip_deserialize": False}
    raise TypeError(f"orbax_write: a leaf of type {type(leaf).__name__}")


def _scalar_tensor(x) -> torch.Tensor:
    """A Python number as Orbax writes it: int64 or float64, 0-d."""
    return torch.tensor(x, dtype=torch.float64 if isinstance(x, float)
                        else torch.int64)


def _write_chunk(path: str, t: torch.Tensor, bounce: List) -> int:
    """`t`'s bytes in C order into `path`, PIECE_BYTES at a time (a CUDA
    tensor through one pinned host buffer, `bounce`, made at first use).
    Returns the bytes written."""
    t = t.detach()
    if not t.is_contiguous():
        t = t.contiguous()
    raw = t.reshape(-1).view(torch.uint8)
    with open(path, "wb") as f:
        for i in range(0, raw.numel(), PIECE_BYTES):
            piece = raw[i:i + PIECE_BYTES]
            if piece.is_cuda:
                if not bounce:
                    bounce.append(torch.empty(PIECE_BYTES, dtype=torch.uint8,
                                              pin_memory=True))
                host = bounce[0][:piece.numel()]
                host.copy_(piece)
                piece = host
            f.write(memoryview(piece.numpy()))
    return raw.numel()


def _write_array(root: str, keys: Tuple[str, ...], t: torch.Tensor,
                 bounce: List) -> int:
    """One leaf as a zarr v2 array of one uncompressed chunk."""
    if t.dtype not in _ZARR_OF:
        raise TypeError(f"orbax_write: {'.'.join(keys)} is {t.dtype}")
    if 0 in t.shape:
        raise ValueError(f"orbax_write: {'.'.join(keys)} is empty "
                         f"{tuple(t.shape)}")
    d = os.path.join(root, ".".join(keys))
    os.makedirs(d)
    zarray = {"chunks": list(t.shape), "compressor": None,
              "dimension_separator": ".", "dtype": _ZARR_OF[t.dtype],
              "fill_value": None, "filters": None, "order": "C",
              "shape": list(t.shape), "zarr_format": 2}
    with open(os.path.join(d, ".zarray"), "w") as f:
        json.dump(zarray, f)
    chunk = ".".join(["0"] * max(t.dim(), 1))
    return _write_chunk(os.path.join(d, chunk), t, bounce)


def _write_tree(root: str, tree) -> int:
    """`tree` (see `_flat`) as an Orbax checkpoint directory at `root`:
    its arrays, then `_METADATA`. Returns the bytes written."""
    os.makedirs(root, exist_ok=True)
    meta, written, bounce = {}, 0, []
    for keys, types, leaf in _flat(tree):
        meta[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": t}
                             for k, t in zip(keys, types)],
            "value_metadata": _value_metadata(leaf)}
        if isinstance(leaf, (bool, int, float)):
            leaf = _scalar_tensor(leaf)
        if isinstance(leaf, torch.Tensor):
            written += _write_array(root, keys, leaf, bounce)
    text = json.dumps({"tree_metadata": meta, "use_ocdbt": False,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None})
    with open(os.path.join(root, METADATA), "w") as f:
        f.write(text)
    return written + len(text)


def _checkpoint_metadata(path: str, handlers, started: int) -> None:
    with open(os.path.join(path, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": handlers, "metrics": {},
                   "performance_metrics": {},
                   "init_timestamp_nsecs": started,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


# ---------------------------------------------------------------------------
# the JAX trees
# ---------------------------------------------------------------------------

def _model_state(params, cfg):
    """(state dict, config) of a model or of a state dict and `cfg`."""
    if isinstance(params, nn.Module):
        return params.state_dict(), cfg if cfg is not None else params.cfg
    if cfg is None:
        raise ValueError("orbax_write: a state dict needs its GroveConfig "
                         "(cfg=)")
    return params, cfg


def _params(entries: Dict[str, Tuple[str, torch.Tensor]]) -> Dict:
    """The JAX parameter tree of `convert.jax_entries`' entries."""
    return _nest(dict(entries.values()))


def _holed(named: Dict[str, torch.Tensor], entries, cfg, what: str) -> Dict:
    """A tree of the parameters' JAX paths holding `named`'s tensors (by
    port name, in the JAX layout of their parameter) and None under every
    other parameter: optax's state over the trainable subtree."""
    unknown = sorted(set(named) - set(entries))
    if unknown:
        raise ValueError(f"orbax_write: {what} of {unknown[:4]}, which the "
                         "parameters lack")
    return _nest({path: (_jax_entry(name, named[name], cfg)[1]
                         if name in named else None)
                  for name, (path, _) in entries.items()})


def _count(n: int) -> torch.Tensor:
    return torch.tensor(int(n), dtype=torch.int32)


def jax_opt_state(opt: Dict, entries, cfg, opt_cfg):
    """The port's optimizer `state_dict()` as the JAX driver's optimizer
    state (see the module docstring), from `opt_cfg` (the port's
    `train.step.OptimizerConfig`)."""
    if "mini_step" in opt:                      # optax.MultiSteps
        return Fields(
            mini_step=_count(opt["mini_step"]),
            gradient_step=_count(opt["gradient_step"]),
            inner_opt_state=jax_opt_state(opt["inner_opt_state"], entries,
                                          cfg, opt_cfg),
            acc_grads=_holed(opt["acc_grads"], entries, cfg, "acc_grads"),
            skip_state=())
    count = _count(opt["count"])
    mu = _holed(opt["mu"], entries, cfg, "mu")
    nu = _holed(opt["nu"], entries, cfg, "nu")
    schedule = Fields(count=count)
    if opt_cfg.moment_dtype == "f32":
        # chain(clip_by_global_norm, adamw(scale_by_adam,
        # add_decayed_weights, scale_by_learning_rate(schedule)))
        return (None, (Fields(count=count, mu=mu, nu=nu), None, schedule))
    if opt_cfg.moment_dtype == "bf16":
        # adamw_bf16: [clip], scale_by_adam_compact, [add_decayed_weights],
        # scale_by_learning_rate(schedule)
        parts = [None] if opt_cfg.grad_clip else []
        parts.append(Fields(count=count, mu=mu, nu=nu))
        if opt_cfg.weight_decay:
            parts.append(None)
        return tuple(parts + [schedule])
    raise ValueError(f"orbax_write: no JAX optimizer for moment_dtype "
                     f"{opt_cfg.moment_dtype!r} (the JAX driver builds "
                     "'f32' and 'bf16')")


def _extra(tree):
    if isinstance(tree, dict):
        return {str(k): _extra(v) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, bool, int, float)):
        return tree
    raise TypeError(f"orbax_write: an extra of type {type(tree).__name__}")


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def save_step(log_dir: str, step: int, params,
              opt_state: Optional[Dict] = None, extra: Optional[Dict] = None,
              opt_cfg=None, *, cfg=None, max_to_keep: int = 2) -> int:
    """Write `ckpt_model/<step>/` of the JAX run at `log_dir`: `params` (a
    port model, or its state dict with `cfg`), the optimizer's
    `state_dict()` as the JAX driver's optimizer state for `opt_cfg` (the
    port's `OptimizerConfig`, its defaults when None), and `extra`. Then
    keep the `max_to_keep` latest steps. Returns the bytes written."""
    from ..train.step import OptimizerConfig
    state, cfg = _model_state(params, cfg)
    entries = jax_entries(state, cfg)
    tree = {"params": _params(entries)}
    if opt_state is not None:
        tree["opt_state"] = jax_opt_state(opt_state, entries, cfg,
                                          opt_cfg or OptimizerConfig())
    if extra:
        tree["extra"] = _extra(extra)
    mgr = CheckpointManager(log_dir, max_to_keep=max_to_keep)
    started = time.time_ns()

    def fill(tmp):
        n = _write_tree(os.path.join(tmp, ITEM), tree)
        _checkpoint_metadata(tmp, {ITEM: HANDLER}, started)
        return n
    written = publish_dir(os.path.join(mgr.ckpt_dir, str(step)), fill)
    for old in mgr.steps()[:-max_to_keep]:
        shutil.rmtree(os.path.join(mgr.ckpt_dir, str(old)))
    return written


def _write_best(log_dir: str, state, cfg) -> Tuple[str, int]:
    """`ckpt_model_best/params/` of {"params"}: (the best directory, the
    bytes written)."""
    best = CheckpointManager(log_dir).best_dir
    started = time.time_ns()

    def fill(tmp):
        n = _write_tree(tmp, {"params": _params(jax_entries(state, cfg))})
        _checkpoint_metadata(tmp, HANDLER, started)
        return n
    return best, publish_dir(os.path.join(best, "params"), fill)


def _replace_marker(best: str, marker: str) -> None:
    for f in os.listdir(best):
        if f.endswith(".marker"):
            os.remove(os.path.join(best, f))
    open(os.path.join(best, marker), "w").close()


def save_best(log_dir: str, epoch: int, params, metric_name: str,
              metric_value: float, *, cfg=None) -> int:
    """Write `ckpt_model_best/params/` (of {"params"}) and its marker,
    after removing the old marker. Returns the bytes written."""
    best, written = _write_best(log_dir, *_model_state(params, cfg))
    _replace_marker(best, f"epoch_{epoch}_val_{metric_name}_"
                          f"{metric_value:.4f}.marker")
    return written


def convert_run(src: str, dst: str, cfg, opt_cfg) -> Dict:
    """Rewrite the port run at log directory `src` (its steps, best
    parameters and marker) as a JAX run at `dst`, for the model config
    `cfg` and the port's `OptimizerConfig` `opt_cfg`. Returns {"steps":
    [...], "best": bool}."""
    mgr = CheckpointManager(src)
    steps = mgr.steps()
    for step in steps:
        got = mgr.restore(step)
        save_step(dst, step, got["params"], got.get("opt_state"),
                  got.get("extra"), opt_cfg, cfg=cfg,
                  max_to_keep=len(steps))
        del got
    best = mgr.restore_best()
    if best is not None:
        dst_best, _ = _write_best(dst, best["params"], cfg)
        for f in os.listdir(mgr.best_dir):
            if f.endswith(".marker"):
                _replace_marker(dst_best, f)
    if not steps and best is None:
        raise FileNotFoundError(f"{src}: no checkpoint under ckpt_model/ "
                                "or ckpt_model_best/")
    return {"steps": steps, "best": best is not None}


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        description="Rewrite a PyTorch port training run as the JAX "
                    "package's Orbax run (no tensorstore needed); the "
                    "training driver's flags give the config",
        usage="%(prog)s SRC DST [training driver flags]")
    p.add_argument("src", help="the port run's log directory")
    p.add_argument("dst", help="the JAX run's log directory to write")
    args, rest = p.parse_known_args(argv)
    from ..train import driver
    dargs = driver.parse_args(rest)
    done = convert_run(args.src, args.dst, driver.build_config(dargs),
                       driver.optimizer_config(dargs))
    print(f"converted steps {done['steps']}"
          f"{' and the best parameters' if done['best'] else ''} of "
          f"{args.src} into the Orbax run {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
