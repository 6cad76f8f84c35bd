"""Multi-process streaming-training demonstration.

Counterpart of `grove_tpu/tools/multihost_demo.py`: N processes form a
`torch.distributed` group (`parallel.launch` gives each torchrun's
environment, with a rendezvous on 127.0.0.1 at a free port); rank 0 builds
the synthetic HowTo set and its manifest and publishes them through an
atomic marker file; every rank reads its own strided shard of the
manifest (`data/index.py`, the DistributedSampler counterpart of
`train.py:452-463`) through `HowTo100MDataset` and the production
`GroundingLoader`, and the ranks run one data-parallel step a step over
the global batch (`train.step.make_train_step(mesh=)`: the local batches
are the global batch's shards, the loss counts, gradients and losses are
summed across ranks).

Workers run on the card unless `--device cpu` is passed; on one card every
rank sits on `cuda:0` and the group runs gloo (NCCL refuses two ranks on
one device). JAX's `--local_devices` (virtual devices per process) has no
counterpart: torch runs one device per process.

    python -m grove_tpu_torch.tools.multihost_demo --num_processes 2 \\
        --steps 3 [--device cpu]

Each worker prints machine-checkable lines:
    DEMO rank=<r> world=<w> devices=<w> shard=<k1,k2,...>
    DEMO rank=<r> step=<s> loss=<f> global_batch=<n>
The parent checks that the shards are disjoint and that every rank reports
the same loss (within 1e-6) at every step: the loss is the global batch's,
all-reduced.
"""

from __future__ import annotations

import argparse
import os
import time


def run_worker(args) -> None:
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..config import GroveConfig
    from ..data.datasets.howto100m import HowTo100MDataset
    from ..data.index import build_manifest
    from ..data.loader import GroundingLoader
    from ..data.video import open_video
    from ..models.grove import init_grove_params
    from ..parallel import mesh as pmesh
    from ..text.mock_tokenizer import MockTokenizer
    from ..text.tokenizer import special_token_ids_from
    from ..train.step import (OptimizerConfig, make_optimizer,
                              make_train_step, partition_params,
                              trainable_mask)

    torch.set_num_threads(1)
    device = pmesh.init_distributed(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        # -- data: rank 0 builds, the others wait for the marker ----------
        root = args.workdir
        marker = os.path.join(root, "DATA_READY")
        manifest = os.path.join(root, "manifest.txt")
        if rank == 0:
            from ..data.synthetic import make_synthetic_howto_dataset
            ann_dir, video_dir, _ = make_synthetic_howto_dataset(
                root, num_videos=args.num_videos)
            build_manifest(ann_dir, manifest)
            # atomic publish: a poller never sees a partial marker
            with open(marker + ".tmp", "w") as f:
                f.write(f"{ann_dir}\n{video_dir}\n")
            os.replace(marker + ".tmp", marker)
        deadline = time.time() + 120
        while not os.path.exists(marker):
            if time.time() > deadline:
                raise TimeoutError("rank 0 never published the dataset")
            time.sleep(0.2)
        with open(marker) as f:
            ann_dir, video_dir = f.read().splitlines()[:2]

        tok = MockTokenizer()
        cfg = GroveConfig.tiny()
        cfg = dataclasses.replace(cfg, tokens=special_token_ids_from(tok))

        # -- this rank's shard of the manifest -> the production loader ----
        ds = HowTo100MDataset(ann_dir=ann_dir, video_dir=video_dir,
                              validation=False, manifest=manifest,
                              shard_rank=rank, shard_world=world,
                              decoder_factory=open_video,
                              num_frames=cfg.num_frames,
                              clip_size=cfg.clip.image_size,
                              sam_size=cfg.sam_enc.img_size,
                              max_phrases=cfg.max_phrases)
        print(f"DEMO rank={rank} world={world} devices={world} "
              f"shard={','.join(ds.keys)}", flush=True)
        loader = GroundingLoader(ds, tok, cfg, batch_size=args.local_batch,
                                 num_workers=1, seed=7, process_index=0,
                                 process_count=1)

        # -- the ("data", "model") mesh over every rank; replicated params --
        mesh = pmesh.make_mesh(device_type=device.type)
        model = init_grove_params(cfg, device=device, dtype=torch.float32,
                                  seed=0)
        ocfg = OptimizerConfig(total_steps=max(args.steps, 2),
                               warmup_steps=1)
        params = partition_params(model, trainable_mask(model, ocfg))
        step_fn = make_train_step(model, make_optimizer(params, ocfg), mesh)

        it = iter(loader)
        for step in range(args.steps):
            try:
                batch, _ = next(it)
            except StopIteration:
                loader.set_epoch(step)
                it = iter(loader)
                batch, _ = next(it)
            gb = pmesh.global_batch_size(batch, mesh)
            metrics = step_fn(pmesh.globalize_batch(batch, mesh, device))
            loss = float(metrics["loss"])
            assert np.isfinite(loss), loss
            print(f"DEMO rank={rank} step={step} loss={loss:.6f} "
                  f"global_batch={gb}", flush=True)
        print(f"DEMO rank={rank} done", flush=True)
    finally:
        dist.destroy_process_group()


def check(outs, num_processes: int, steps: int) -> dict:
    """Parse the workers' DEMO lines; assert disjoint shards and one loss
    (within 1e-6) on every rank at every step (`multihost_demo.py:
    152-223`)."""
    shards, losses = {}, {}
    for out in outs:
        for line in out.splitlines():
            if not line.startswith("DEMO rank="):
                continue
            kv = dict(tok.split("=", 1) for tok in line.split()[1:]
                      if "=" in tok)
            r = int(kv["rank"])
            if "shard" in kv:
                shards[r] = set(kv["shard"].split(","))
                assert int(kv["devices"]) == num_processes, (
                    "global device count mismatch", kv["devices"])
            elif "loss" in kv:
                losses.setdefault(int(kv["step"]), {})[r] = float(kv["loss"])
    assert len(shards) == num_processes, shards
    for a in shards:
        for b in shards:
            if a < b:
                assert not (shards[a] & shards[b]), ("shards overlap",
                                                     shards)
    assert len(losses) == steps, losses
    for step, by_rank in losses.items():
        vals = list(by_rank.values())
        assert len(by_rank) == num_processes, (step, by_rank)
        assert max(vals) - min(vals) < 1e-6, (
            "all-reduced loss differs across ranks", step, by_rank)
    return {"shards": {k: sorted(v) for k, v in shards.items()},
            "losses": losses}


def run_parent(args) -> dict:
    import tempfile

    from ..parallel.launch import launch

    if args.num_videos < args.num_processes * args.local_batch:
        raise ValueError(f"--num_videos {args.num_videos}: each of the "
                         f"{args.num_processes} shards needs a full batch "
                         f"of {args.local_batch}")
    workdir = args.workdir or tempfile.mkdtemp(prefix="grove_multihost_")
    os.makedirs(workdir, exist_ok=True)
    outs = launch(["-m", "grove_tpu_torch.tools.multihost_demo", "--worker",
                   "--workdir", workdir, "--steps", str(args.steps),
                   "--local_batch", str(args.local_batch),
                   "--num_videos", str(args.num_videos),
                   "--device", args.device],
                  args.num_processes, timeout=args.timeout)
    result = check(outs, args.num_processes, args.steps)
    print(f"multihost demo OK: {args.num_processes} processes on "
          f"{args.device}, {args.steps} steps, identical global loss on "
          f"every rank (step0 loss={result['losses'][0][0]:.4f})")
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--worker", action="store_true")
    p.add_argument("--num_processes", default=2, type=int)
    p.add_argument("--workdir", default=None)
    p.add_argument("--steps", default=3, type=int)
    p.add_argument("--local_batch", default=2, type=int)
    p.add_argument("--num_videos", default=4, type=int)
    p.add_argument("--timeout", default=900, type=float)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.worker:
        run_worker(args)
        return None
    return run_parent(args)


if __name__ == "__main__":
    main()
