"""Multi-process dry run of the parallel paths on the CPU.

Counterpart of `__graft_entry__.dryrun_multichip` (`__graft_entry__.py:
127-260`): `dryrun_multichip(n)` starts n gloo processes on the CPU
(`parallel.launch`) and each runs, at `GroveConfig.tiny()` in fp32:

* a ("data", "model") mesh with model = 2 where n is even and at least 4,
  else 1;
* one full train step with the tensor-parallel rules, FSDP over "data"
  (`min_size = 1 << 8`) and sequence parallelism, on a dummy batch of one
  row a data rank; its loss must be finite;
* the 2-stage pipelined full step (`train.step.make_pipelined_train_step`,
  both stages on the CPU) on the whole dummy batch;
* the DDP inference leg: greedy decode and `ground` over each data rank's
  two clips, then `infer.drivers.gather_outputs` with clip 0 reported by
  every rank, which must merge to 2 x data clips.

Rank 0 prints the JAX dry run's summary line. A rank that fails fails the
run (`launch` raises).

    python -m grove_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as pmesh

TIMEOUT_S = 600


def dummy_batch(cfg, batch: int, rng) -> Dict[str, np.ndarray]:
    """The JAX dry run's `_dummy_batch` (`__graft_entry__.py:74-105`): normal
    frames (taken as normalized), random ids around the video slots, one
    [DET] and one valid phrase a row."""
    t = cfg.num_frames
    nv = cfg.num_video_tokens
    length = nv + 32
    ids = rng.integers(3, min(1000, cfg.llama.vocab_size),
                       size=(batch, length)).astype(np.int32)
    ids[:, 0] = cfg.tokens.bos
    ids[:, 2:2 + nv] = 0
    ids[:, length - 2] = cfg.tokens.det
    labels = ids.copy()
    labels[:, :2 + nv] = -100
    det_pos = np.full((batch, cfg.max_phrases), length - 3, np.int32)
    pm = np.zeros((batch, cfg.max_phrases), np.float32)
    pm[:, 0] = 1.0
    c, s = cfg.clip.image_size, cfg.sam_enc.img_size
    return {
        "frames_clip": rng.normal(size=(batch, t, c, c, 3)).astype(
            np.float32),
        "frames_sam": rng.normal(size=(batch, t, s, s, 3)).astype(
            np.float32),
        "input_ids": ids,
        "video_start": np.full((batch,), 2, np.int32),
        "labels": labels,
        "det_positions": det_pos,
        "phrase_mask": pm,
        "gt_boxes": rng.uniform(0.3, 0.6, size=(
            batch, t, cfg.max_phrases, 4)).astype(np.float32),
        "gt_objectness": (np.ones((batch, t, cfg.max_phrases), np.float32)
                          * pm[:, None]),
    }


def _rows(batch, rows):
    return {k: v[rows] for k, v in batch.items()}


def run_worker(n: int) -> str:
    """One rank of the dry run; returns rank 0's summary line."""
    from torch.distributed.fsdp import FSDPModule

    from ..config import GroveConfig
    from ..infer.drivers import gather_outputs
    from ..infer.generate import greedy_decode
    from ..models.grove import init_grove_params
    from ..train.step import (OptimizerConfig, batch_to_device,
                              make_optimizer, make_pipelined_train_step,
                              make_train_step, partition_params,
                              trainable_mask)
    from .pipeline import make_pipe_mesh, place_stages
    from .sharding import shard_pytree

    model_par = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = pmesh.make_mesh(data=n // model_par, model=model_par,
                           device_type="cpu")
    dp, d_rank = pmesh.axis_size(mesh, "data"), pmesh.axis_rank(mesh, "data")
    cfg = GroveConfig.tiny()
    model = init_grove_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                              llm_act_sharding=mesh if model_par > 1
                              else None)
    ocfg = OptimizerConfig(total_steps=10, warmup_steps=2)
    mask = trainable_mask(model, ocfg)
    partition_params(model, mask)
    # TP rules + ZeRO-3-style FSDP over "data" + sequence parallelism
    shard_pytree(model, mesh, fsdp=True, min_size=1 << 8)
    params = {k: p for k, p in model.named_parameters() if mask[k]}
    step = make_train_step(model, make_optimizer(params, ocfg), mesh)
    rng = np.random.default_rng(0)
    batch = dummy_batch(cfg, dp, rng)
    metrics = step(batch_to_device(_rows(batch, [d_rank]), "cpu"))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss

    # the full step with the LLaMA stack GPipe-pipelined over 2 stages (an
    # unsharded model of the same seed, the whole batch)
    base = init_grove_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    base_params = partition_params(base, trainable_mask(base, ocfg))
    pipe = make_pipe_mesh(2, ["cpu", "cpu"])
    place_stages(base.model, pipe)
    n_micro = 2 if dp % 2 == 0 else 1
    pp_step = make_pipelined_train_step(
        base, make_optimizer(base_params, ocfg), pipe, n_micro)
    pp_loss = float(pp_step(batch_to_device(batch, "cpu"))["loss"])
    assert np.isfinite(pp_loss), pp_loss

    # the DDP inference leg: each data rank generates and grounds its two
    # clips; the per-rank results, each with clip 0 (an overlapping shard),
    # merge first-seen-wins through the driver's gather
    ib = 2 * dp
    ibatch = dummy_batch(cfg, ib, rng)
    mine = [2 * d_rank, 2 * d_rank + 1]
    local = batch_to_device(_rows(ibatch, mine), "cpu")
    fsdp = isinstance(model, FSDPModule)
    if fsdp:
        model.unshard()
    with torch.inference_mode():
        ve, _ = model.encode_video(local["frames_clip"])
        ie = model.encode_grounding(local["frames_sam"])
        gen, hidden = greedy_decode(
            model, local["input_ids"], ve, local["video_start"],
            max_new_tokens=4, eos_id=cfg.tokens.eos, pad_id=cfg.tokens.pad,
            early_exit=False)
        boxes, _ = model.ground(hidden, local["det_positions"], ie)
    if fsdp:
        model.reshard()
    assert tuple(gen.shape) == (2, 4), gen.shape
    assert bool(torch.isfinite(boxes).all())
    boxes = boxes.numpy()
    mine_out = {f"clip_{i}": {"boxes": boxes[j]} for j, i in enumerate(mine)}
    # a rank past the first re-reports clip 0 with other numbers: the
    # merge keeps rank 0's
    mine_out.setdefault("clip_0", {"boxes": np.full_like(boxes[0], 7.0)})
    merged = gather_outputs(mine_out)
    assert len(merged) == ib, (len(merged), ib)
    assert not np.all(merged["clip_0"]["boxes"] == 7.0)
    shape = {"data": dp, "model": model_par}
    return (f"dryrun_multichip({n}): mesh={shape} loss={loss:.4f} "
            f"pp(2-stage full step)={pp_loss:.4f} OK "
            f"infer(ddp generate b{ib}/dp{dp} + gather-merge) OK")


def dryrun_multichip(n: int, timeout: float = TIMEOUT_S) -> str:
    """Run the dry run on n CPU processes; returns rank 0's summary
    line."""
    from .launch import launch
    outs = launch(["-m", "grove_tpu_torch.parallel.dryrun", "--worker",
                   str(n)], n, timeout=timeout)
    line = next((ln for ln in outs[0].splitlines()
                 if ln.startswith("dryrun_multichip(")), None)
    if line is None or not line.endswith("OK"):
        raise RuntimeError(f"dryrun_multichip({n}): rank 0 printed no "
                           f"summary\n{outs[0][-3000:]}")
    return line


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        torch.set_num_threads(1)
        pmesh.init_distributed("cpu")
        try:
            line = run_worker(int(argv[1]))
            if dist.get_rank() == 0:
                print(line, flush=True)
        finally:
            dist.destroy_process_group()
        return
    print(dryrun_multichip(int(argv[0]) if argv else 4))


if __name__ == "__main__":
    main()
