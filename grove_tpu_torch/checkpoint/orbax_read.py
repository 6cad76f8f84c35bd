"""Read the JAX package's Orbax training runs into the port's layout, and
convert a run into the port's `CheckpointManager` layout.

The JAX package's `checkpoint/orbax_io.py` saves, under a run's log
directory, `ckpt_model/<step>/default` (Orbax's `StandardSave` of
`{"params", "opt_state", "extra"?}`) and `ckpt_model_best/params` (of
`{"params"}`) beside the marker `epoch_{e}_val_{name}_{value}.marker`.
Each is a directory with `_METADATA` (JSON: every leaf's key path and
value type) and the arrays in zarr under an OCDBT key-value store, whose
manifest and b-tree nodes are zstd-compressed: they are read through
`tensorstore`, imported inside `read_tree` only. The layout that
`checkpoint.orbax_write` writes (no OCDBT, each array one uncompressed
zarr chunk) is read with numpy alone, on any machine. On a machine
without tensorstore (the card's) a read of any other layout raises
ImportError naming the conversion, to be run on a host that has it:

    python -m grove_tpu_torch.checkpoint.orbax_read SRC DST

rewrites the run at log directory SRC into DST in the port's layout
(`ckpt_model/<step>/state.pt`, `ckpt_model_best/params/state.pt`, the
marker), which `from_pretrained(DST)` and the driver's `--auto_resume`
read anywhere.

The mapping (`restore`): the parameters through
`checkpoint.convert.jax_state_dict` (the copied converter's layouts, the
mask decoder's ConvTranspose kernels flipped); the optimizer state of
the JAX driver (`grove_tpu/train/step.py:121-135`: optax's
`chain(clip_by_global_norm, adamw)` or `lowmem.adamw_bf16`, either inside
`optax.MultiSteps` with `--grad_accumulation_steps` > 1) to the port's
`train.step.AdamW.state_dict()` `{"count", "mu", "nu"}` (and `MultiSteps`'
`{"mini_step", "gradient_step", "inner_opt_state", "acc_grads"}`), each
moment under its parameter's name and in its parameter's layout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from .convert import _leaf_tensor, jax_state_dict

METADATA = "_METADATA"
ITEM = "default"              # the CheckpointManager's one item
CONVERT_CMD = "python -m grove_tpu_torch.checkpoint.orbax_read SRC DST"


def is_orbax(path: str) -> bool:
    """Whether `path` is an Orbax checkpoint directory (its `_METADATA`)."""
    return os.path.isfile(os.path.join(path, METADATA))


def _tensorstore(path: str):
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            f"{path} is an Orbax checkpoint of the JAX package; reading it "
            "needs the tensorstore package, which this machine lacks. "
            "Convert the run on a host that has it: `" + CONVERT_CMD + "` "
            "(SRC the run's log directory), and read DST here") from e
    return tensorstore


# the zarr v2 dtypes of the uncompressed layout, both ways (numpy reads
# bfloat16 as int16, viewed as torch's)
ZARR_DTYPES = {"<f4": torch.float32, "<f8": torch.float64,
               "<f2": torch.float16, "<i4": torch.int32, "<i8": torch.int64,
               "<i2": torch.int16, "|i1": torch.int8, "|u1": torch.uint8,
               "|b1": torch.bool, "bfloat16": torch.bfloat16}
_MMAP_BYTES = 1 << 20         # arrays from this size are memory-mapped


def _read_plain(path: str, name: str):
    """The zarr v2 array `name` of the checkpoint at `path` when it is
    stored as one uncompressed, unfiltered C-order chunk (what
    `orbax_write` and Orbax without compression write), read with numpy:
    an array (memory-mapped copy-on-write from _MMAP_BYTES), a bf16 one as
    a torch.bfloat16 tensor over it; None for any other storage."""
    d = os.path.join(path, name)
    try:
        with open(os.path.join(d, ".zarray")) as f:
            z = json.load(f)
    except FileNotFoundError:
        return None
    shape = tuple(z.get("shape", ()))
    if (z.get("zarr_format") != 2 or z.get("compressor") is not None
            or z.get("filters") or z.get("order", "C") != "C"
            or tuple(z.get("chunks", ())) != shape
            or z.get("dtype") not in ZARR_DTYPES):
        return None
    sep = z.get("dimension_separator", ".")
    chunk = os.path.join(d, sep.join(["0"] * max(len(shape), 1)))
    if not os.path.isfile(chunk):
        return None
    dtype = np.dtype("<i2" if z["dtype"] == "bfloat16" else z["dtype"])
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if os.path.getsize(chunk) != nbytes:
        raise ValueError(f"{chunk}: {os.path.getsize(chunk)} bytes, not "
                         f"the {nbytes} of {z['dtype']}{list(shape)}")
    if nbytes >= _MMAP_BYTES:
        arr = np.memmap(chunk, dtype=dtype, mode="c", shape=shape)
    else:
        arr = np.fromfile(chunk, dtype=dtype).reshape(shape)
    if z["dtype"] == "bfloat16":
        return torch.from_numpy(arr).view(torch.bfloat16)
    return arr


def read_tree(path: str) -> Dict:
    """The nested dict an Orbax checkpoint directory holds: arrays (bf16
    ones as tensorstore's bfloat16 numpy type, or as torch.bfloat16
    tensors where numpy reads them), Python scalars for Orbax's scalar
    leaves; None leaves (optax's empty states, the frozen parameters'
    holes) left out. Without OCDBT, an array stored as one uncompressed
    chunk (`orbax_write`'s layout) is read with numpy; anything else
    through tensorstore."""
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    plain = not meta.get("use_ocdbt", True) and not meta.get("use_zarr3")
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    base = os.path.abspath(path)
    ts = None
    out: Dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        if value.get("skip_deserialize") or value["value_type"] == "None":
            continue
        if value["value_type"] not in ("jax.Array", "np.ndarray", "scalar"):
            raise ValueError(f"{path}: leaf {'.'.join(keys)} of type "
                             f"{value['value_type']} is not an array")
        name = ".".join(keys)
        arr = _read_plain(base, name) if plain else None
        if arr is None:
            ts = ts or _tensorstore(path)
            kvstore = ({"driver": "ocdbt", "base": f"file://{base}/",
                        "path": name} if meta.get("use_ocdbt", True)
                       else {"driver": "file",
                             "path": os.path.join(base, name)})
            arr = ts.open({"driver": driver, "kvstore": kvstore},
                          open=True).result().read().result()
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = (arr.item() if value["value_type"] == "scalar"
                          else arr)
    return out


def _dicts(tree) -> Iterator[Mapping]:
    if isinstance(tree, Mapping):
        yield tree
        for v in tree.values():
            yield from _dicts(v)


def port_opt_state(opt: Mapping) -> Dict:
    """The JAX driver's optimizer state (read by `read_tree`) as the
    port's optimizer `state_dict()` (see the module docstring). The Adam
    state is the one node holding `count`, `mu` and `nu`; every count of
    the chain (Adam's, the schedule's) must agree."""
    if "mini_step" in opt:                    # optax.MultiSteps
        return {"mini_step": int(opt["mini_step"]),
                "gradient_step": int(opt["gradient_step"]),
                "inner_opt_state": port_opt_state(opt["inner_opt_state"]),
                "acc_grads": jax_state_dict(opt.get("acc_grads", {}))}
    adam = [d for d in _dicts(opt) if {"count", "mu", "nu"} <= set(d)]
    if len(adam) != 1:
        raise ValueError(f"optimizer state: {len(adam)} Adam states, "
                         "not 1")
    counts = {int(np.asarray(d["count"])) for d in _dicts(opt)
              if "count" in d}
    if len(counts) != 1:
        raise ValueError(f"optimizer state: the chain's counts differ: "
                         f"{sorted(counts)}")
    return {"count": counts.pop(), "mu": jax_state_dict(adam[0]["mu"]),
            "nu": jax_state_dict(adam[0]["nu"])}


def _extra(tree):
    if isinstance(tree, Mapping):
        return {k: _extra(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return _leaf_tensor(tree)
    return tree


def restore(path: str) -> Dict:
    """An Orbax checkpoint directory of the JAX package
    (`ckpt_model/<step>/default` or `ckpt_model_best/params`) in the
    port's layout: {"params": {port name: CPU tensor}, "opt_state"?,
    "extra"?}, as the port's `CheckpointManager` restores its own."""
    tree = read_tree(path)
    out = {"params": jax_state_dict(tree["params"])}
    if "opt_state" in tree:
        out["opt_state"] = port_opt_state(tree["opt_state"])
    if "extra" in tree:
        out["extra"] = _extra(tree["extra"])
    return out


def _contiguous(tree):
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    return tree.contiguous() if isinstance(tree, torch.Tensor) else tree


def convert_run(src: str, dst: str) -> Dict:
    """Rewrite the JAX run at log directory `src` into `dst` in the
    port's `CheckpointManager` layout: every Orbax step, the best
    parameters and their marker. Returns {"steps": [...], "best": bool}."""
    from .manager import CheckpointManager, _write_dir
    mgr = CheckpointManager(dst)
    ckpt = os.path.join(src, "ckpt_model")
    steps = sorted(int(d) for d in (os.listdir(ckpt) if os.path.isdir(ckpt)
                                    else [])
                   if d.isdigit() and is_orbax(os.path.join(ckpt, d, ITEM)))
    for step in steps:
        _write_dir(os.path.join(mgr.ckpt_dir, str(step)), _contiguous(
            restore(os.path.join(ckpt, str(step), ITEM))))
    best_src = os.path.join(src, "ckpt_model_best")
    best = is_orbax(os.path.join(best_src, "params"))
    if best:
        _write_dir(os.path.join(mgr.best_dir, "params"), _contiguous(
            {"params": restore(os.path.join(best_src, "params"))["params"]}))
        for f in os.listdir(best_src):
            if f.endswith(".marker"):
                shutil.copyfile(os.path.join(best_src, f),
                                os.path.join(mgr.best_dir, f))
    if not steps and not best:
        raise FileNotFoundError(f"{src}: no Orbax checkpoint under "
                                "ckpt_model/ or ckpt_model_best/")
    return {"steps": steps, "best": best}


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        description="Rewrite a JAX package training run (Orbax, read with "
                    "tensorstore) into the PyTorch port's checkpoint layout")
    p.add_argument("src", help="the JAX run's log directory")
    p.add_argument("dst", help="the port's log directory to write")
    args = p.parse_args(argv)
    done = convert_run(args.src, args.dst)
    print(f"converted steps {done['steps']}"
          f"{' and the best parameters' if done['best'] else ''} of "
          f"{args.src} into {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
