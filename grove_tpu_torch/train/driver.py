"""Training driver: CLI, epoch loop, validation, checkpointing, logging.

Counterpart of `grove_tpu/train/driver.py` (the reference `train.py`):

* the same flags and defaults (`driver.py:43-122`), plus `--device`
  (default `cuda`; there is no fallback to the CPU: `--device cuda` without
  a card raises);
* the model in fp32 for `tiny`, bf16 otherwise (`:298`), built directly on
  the device from `--seed` (`models.grove.init_grove_params`); a `--version`
  `.bin` loaded the JAX way (`:304-315`): PEFT names normalized, SAM's
  tables resized to the model's grid, matching tensors copied, the missing
  and mismatched ones counted;
* the trainable set of `OptimizerConfig` (`train.step.trainable_mask`),
  AdamW (`--moment_dtype bf16`: `train.lowmem.adamw_bf16`), LoRA on the
  LLaMA with `--lora_r`, and `--grad_accumulation_steps` through
  `train.step.MultiSteps` (`optax.MultiSteps`, `:325-328`);
* epochs of `--steps_per_epoch` steps over `data.loader.GroundingLoader`,
  the loader re-armed when it runs out (`:422-428`), per-step meters with
  `data_secs`, TensorBoard scalars where `torch.utils.tensorboard` imports
  (`:366-372`), and a `torch.profiler` trace of steps 2-4 with
  `--profile_dir` (JAX: `jax.profiler`);
* `validate` after each epoch (giou mode: the mean GIoU over visible
  phrase-frames and the objectness accuracy; loss mode: the mean loss,
  `:228-277`), `save_best` on improvement, `save` at each epoch's end, and
  `--auto_resume` from `latest_step() // steps_per_epoch` (`:375-384`)
  through `checkpoint.manager.CheckpointManager`;
* `--max_restarts` in-process restarts with auto-resume (`:486-503`).

Parallel training (`parallel/`, `driver.py:281-360, 425-440`):

* `--multihost`: join torchrun's process group (`parallel.mesh.
  init_distributed`); every data rank reads its own shard through the
  loader, and the step is the global batch's (`make_train_step(mesh=)`:
  global loss normalizers, gradients summed over the ranks);
* `--mesh_model N > 1`: tensor parallelism over N ranks of the
  ("data", "model") mesh with the rules of `parallel.sharding` (run
  under torchrun with a world divisible by N; implies `--multihost`);
* `--pipeline_stages N > 1` with `--pipeline_microbatches`: the GPipe step
  (`make_pipelined_train_step`). In one process, its stages on one card
  each where there are N cards, else all on `--device`. With
  `--multihost`, one stage a rank (`parallel.pipeline.RankPipe`) in a
  world of N processes: each rank holds its stage's layers and the rest
  of the model, and reads its shard of the data (`--batch_size` rows a
  step, as a data-parallel rank reads it); the step is the global
  batch's of N x `--batch_size` rows, and validation runs through the
  same forward. A world that is not N is refused (JAX's layout of data
  over every device, piped over the first N, has no counterpart here);
  not with `--mesh_model > 1`.

Rank 0 alone writes logs and checkpoints; a checkpoint holds whole
tensors (sharded parameters and moments gathered first, and every
pipeline stage's layers), equal to an unsharded run's.

`--synthetic` builds the synthetic dataset of `data.synthetic` (`.npy`
clips, readable without libav).

    python -m grove_tpu_torch.train.driver --synthetic --model_size tiny \\
        --device cpu --epochs 1 --steps_per_epoch 2
    torchrun --nproc_per_node 2 -m grove_tpu_torch.train.driver \\
        --multihost --mesh_model 2 --synthetic --model_size small
    torchrun --nproc_per_node 4 -m grove_tpu_torch.train.driver \\
        --multihost --pipeline_stages 4 --pipeline_microbatches 4 \\
        --synthetic --model_size full
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..config import GroveConfig
from ..data.loader import GroundingLoader, process_rank_world
from ..data.video import open_video
from ..models.grove import init_grove_params
from ..parallel import mesh as pmesh
from ..parallel import pipeline as ppipe
from ..utils.meters import AverageMeter, ProgressMeter
from .step import (MultiSteps, OptimizerConfig, batch_to_device,
                   make_optimizer, make_pipelined_train_step,
                   make_train_step, partition_params, trainable_mask)


def parse_args(args=None):
    p = argparse.ArgumentParser(description="GROVE training (PyTorch)")
    # model
    p.add_argument("--model_size", default="tiny",
                   choices=["tiny", "small", "full"])
    p.add_argument("--version", default=None,
                   help="torch .bin checkpoint to load")
    p.add_argument("--model_max_length", default=None, type=int)
    p.add_argument("--num_frames", default=None, type=int)
    p.add_argument("--train_mask_decoder", action="store_true", default=True)
    p.add_argument("--out_dim", default=None, type=int)
    p.add_argument("--ce_loss_weight", default=1.0, type=float)
    p.add_argument("--giou_loss_weight", default=1.0, type=float)
    p.add_argument("--temp_objectness_loss_weight", default=1.0, type=float)
    # data
    p.add_argument("--dataset", default="HowToGround",
                   choices=["HowToGround", "VidSTG", "ActivityNetEntities"])
    p.add_argument("--frame_timestamps", default=None,
                   help="frame-timestamps json for ActivityNetEntities")
    p.add_argument("--max_restarts", default=0, type=int,
                   help="in-process elastic restarts on failure "
                        "(torchrun --max_restarts equivalent)")
    p.add_argument("--ann_dir", default=None)
    p.add_argument("--manifest", default=None,
                   help="prebuilt key manifest (data.index.build_manifest) "
                        "for streaming-scale startup; shards the index "
                        "across processes instead of listing ann_dir")
    p.add_argument("--video_dir", default=None)
    p.add_argument("--val_ann_dir", default=None)
    p.add_argument("--val_video_dir", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic dataset (no real data needed)")
    p.add_argument("--num_workers", default=4, type=int)
    # optimization
    p.add_argument("--epochs", default=2, type=int)
    p.add_argument("--steps_per_epoch", default=10, type=int)
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--grad_accumulation_steps", default=1, type=int)
    p.add_argument("--lr", default=5e-5, type=float)
    p.add_argument("--beta1", default=0.9, type=float)
    p.add_argument("--beta2", default=0.95, type=float)
    p.add_argument("--warmup_steps", default=100, type=int)
    p.add_argument("--grad_clip", default=1.0, type=float)
    p.add_argument("--moment_dtype", default="f32",
                   choices=["f32", "bf16"],
                   help="Adam moment storage (bf16: train/lowmem.py)")
    p.add_argument("--no_train_embeddings", action="store_true",
                   help="freeze lm_head + embed_tokens (the reference "
                        "trains them)")
    p.add_argument("--no_freeze", action="store_true",
                   help="train all params (reference trains adapters/heads)")
    p.add_argument("--lora_r", default=0, type=int)
    p.add_argument("--lora_alpha", default=16.0, type=float)
    # parallelism
    p.add_argument("--mesh_model", default=1, type=int)
    p.add_argument("--pipeline_stages", default=0, type=int)
    p.add_argument("--pipeline_microbatches", default=4, type=int)
    # logging / checkpointing
    p.add_argument("--log_base_dir", default="./runs", type=str)
    p.add_argument("--exp_name", default="grove_tpu", type=str)
    p.add_argument("--print_freq", default=1, type=int)
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--val_mode", default="giou", choices=["loss", "giou"])
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler trace of steps 2-4 here")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize LLM blocks (activation checkpointing)")
    p.add_argument("--train_clip_adapters", action="store_true",
                   help="let the CLIP tower's video adapters train (the "
                        "reference's @torch.no_grad quirk freezes them)")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda or cpu)")
    return p.parse_args(args)


def build_config(args) -> GroveConfig:
    cfg = {"tiny": GroveConfig.tiny, "small": GroveConfig.small,
           "full": GroveConfig}[args.model_size]()
    overrides = {}
    if args.model_max_length:
        overrides["max_seq_len"] = args.model_max_length
    if args.out_dim:
        overrides["out_dim"] = args.out_dim
    overrides["ce_loss_weight"] = args.ce_loss_weight
    overrides["giou_loss_weight"] = args.giou_loss_weight
    overrides["temp_objectness_loss_weight"] = args.temp_objectness_loss_weight
    if getattr(args, "train_clip_adapters", False):
        overrides["train_clip_adapters"] = True
    if getattr(args, "lora_r", 0):
        overrides["llama"] = dataclasses.replace(
            cfg.llama, lora_r=args.lora_r, lora_alpha=args.lora_alpha)
    # objectness head only trains on HowToGround (`train.py:205`)
    if getattr(args, "dataset", "HowToGround") != "HowToGround":
        overrides["use_temp_objectness"] = False
        overrides["sam_dec"] = dataclasses.replace(
            cfg.sam_dec, use_temp_objectness=False)
    return dataclasses.replace(cfg, **overrides)


def optimizer_config(args) -> OptimizerConfig:
    """The optimizer config of the flags
    (`grove_tpu/train/driver.py:317-323`)."""
    return OptimizerConfig(
        lr=args.lr, betas=(args.beta1, args.beta2),
        warmup_steps=args.warmup_steps,
        total_steps=args.epochs * args.steps_per_epoch,
        grad_clip=args.grad_clip, train_mask_decoder=args.train_mask_decoder,
        freeze=not args.no_freeze, moment_dtype=args.moment_dtype,
        train_embeddings=not args.no_train_embeddings)


def build_tokenizer(args, cfg):
    if args.synthetic or args.version is None:
        from ..text.mock_tokenizer import MockTokenizer
        return MockTokenizer(model_max_length=cfg.max_seq_len)
    import transformers
    tok = transformers.AutoTokenizer.from_pretrained(
        args.version, model_max_length=cfg.max_seq_len, padding_side="right",
        use_fast=False)
    tok.pad_token = tok.unk_token
    from ..text.constants import GROVE_EXTRA_TOKENS
    tok.add_tokens(list(GROVE_EXTRA_TOKENS), special_tokens=True)
    return tok


def build_datasets(args, cfg, data_rank: int = 0, data_size: int = 1):
    if args.synthetic:
        import tempfile
        root = tempfile.mkdtemp(prefix="grove_synth_")
        if args.dataset == "VidSTG":
            from ..data.synthetic import make_synthetic_vidstg
            ann, video_dir = make_synthetic_vidstg(
                root, num_videos=max(4, args.batch_size * 2))
            args.ann_dir = args.val_ann_dir = ann
        else:
            from ..data.synthetic import make_synthetic_howto_dataset
            ann, video_dir, _ = make_synthetic_howto_dataset(
                root, num_videos=max(4, args.batch_size * 2))
            args.ann_dir = args.val_ann_dir = ann
            args.dataset = "HowToGround"
        args.video_dir = args.val_video_dir = video_dir
    common = dict(decoder_factory=open_video, num_frames=cfg.num_frames,
                  clip_size=cfg.clip.image_size,
                  sam_size=cfg.sam_enc.img_size,
                  max_phrases=cfg.max_phrases)
    if args.dataset == "VidSTG":
        from ..data.datasets.vidstg import VidSTGDataset
        train_ds = VidSTGDataset(ann_path=args.ann_dir,
                                 video_dir=args.video_dir,
                                 validation=False, **common)
        val_ds = (VidSTGDataset(ann_path=args.val_ann_dir,
                                video_dir=args.val_video_dir,
                                validation=True, **common)
                  if args.val_ann_dir else None)
    elif args.dataset == "ActivityNetEntities":
        import json
        from ..data.datasets.anet_entities import ActivityNetEntitiesDataset
        with open(args.frame_timestamps) as f:
            fts = json.load(f)
        anet_common = dict(frame_timestamps=fts, **common)
        train_ds = ActivityNetEntitiesDataset(
            args.ann_dir, args.video_dir, validation=False, **anet_common)
        val_ds = (ActivityNetEntitiesDataset(
            args.val_ann_dir, args.val_video_dir, validation=True,
            **anet_common) if args.val_ann_dir else None)
    else:
        from ..data.datasets.howto100m import HowTo100MDataset
        shard = {}
        if getattr(args, "manifest", None):
            # streaming-scale: pre-shard the index across the data ranks;
            # the loader then must not shard again (see _run)
            shard = dict(manifest=args.manifest, shard_rank=data_rank,
                         shard_world=data_size)
        train_ds = HowTo100MDataset(ann_dir=args.ann_dir,
                                    video_dir=args.video_dir,
                                    validation=False, **shard, **common)
        val_ds = (HowTo100MDataset(ann_dir=args.val_ann_dir,
                                   video_dir=args.val_video_dir,
                                   validation=True, **common)
                  if args.val_ann_dir else None)
    return train_ds, val_ds


def validate(model, loader, cfg, args):
    """bbox-mode validation: mean GIoU + objectness accuracy
    (`train.py:797-875`); loss-mode: mean val loss (`train.py:876-916`).
    `model` is a GroveModel (or anything with its `forward_boxes` /
    `forward_train`), on `args.device`."""
    from ..ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou

    giou_m = AverageMeter("giou", ":.4f")
    acc_m = AverageMeter("obj_acc", ":.4f")
    loss_m = AverageMeter("loss", ":.4f")

    for batch, meta in loader:
        tb = batch_to_device(batch, args.device)
        with torch.inference_mode():
            if args.val_mode == "loss":
                out = model.forward_train(tb)
                loss_m.update(float(out["loss"]), len(batch["input_ids"]))
                continue
            out = model.forward_boxes(tb)
        pred = out["pred_boxes"].float().cpu().numpy()
        obj_logits = (out["objectness_logits"].float().cpu().numpy()
                      if out["objectness_logits"] is not None else None)
        gt = batch["gt_boxes"]
        gt_obj = batch["gt_objectness"]
        pm = batch["phrase_mask"][:, None, :]
        mask = (gt_obj * pm).astype(bool)
        if mask.any():
            g = generalized_box_iou(
                box_cxcywh_to_xyxy(torch.from_numpy(pred[mask])),
                box_cxcywh_to_xyxy(torch.from_numpy(
                    np.asarray(gt[mask], np.float32)))).numpy()
            giou_m.update(float(g.mean()), int(mask.sum()))
        if obj_logits is not None:
            vm = np.broadcast_to(pm, gt_obj.shape).astype(bool)
            if vm.any():
                pred_obj = (obj_logits > 0)[vm]
                acc_m.update(
                    float((pred_obj == gt_obj[vm].astype(bool)).mean()),
                    int(vm.sum()))
    for m in (giou_m, acc_m, loss_m):
        m.all_reduce()
    if args.val_mode == "loss":
        return {"val_loss": loss_m.avg, "key_metric": -loss_m.avg}
    return {"val_giou": giou_m.avg, "val_obj_acc": acc_m.avg,
            "key_metric": giou_m.avg}


def load_version(model, path: str):
    """Overlay a reference torch `.bin` onto `model` the JAX driver's way
    (`driver.py:304-315`): every tensor to fp32 numpy, PEFT names
    normalized, SAM's tables on another grid resized; each key the model
    has at the same shape is copied, the others are counted. Returns
    (copied, missing keys, mismatched (key, want, got))."""
    from ..api.model import read_checkpoint
    from ..checkpoint.convert import _SKIP, resize_sam_grids
    sd = {k: torch.from_numpy(v) for k, v in read_checkpoint(path).items()
          if not _SKIP.search(k)}
    sd = resize_sam_grids(sd, model.cfg)
    own = model.state_dict()
    missing, mismatched, copied = [], [], 0
    with torch.no_grad():
        for key, val in sd.items():
            if key not in own:
                missing.append(key)
            elif tuple(own[key].shape) != tuple(val.shape):
                mismatched.append((key, tuple(own[key].shape),
                                   tuple(val.shape)))
            else:
                own[key].copy_(val)
                copied += 1
    return copied, missing, mismatched


def model_dtype(model_size: str) -> torch.dtype:
    """fp32 for `tiny`, bf16 otherwise (`driver.py:298`)."""
    return torch.float32 if model_size == "tiny" else torch.bfloat16


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def _profiler(profile_dir: str):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _pipe_devices(device: torch.device, n_stages: int):
    """One card per stage where there are `n_stages` cards, else every
    stage on `device`."""
    if device.type == "cuda" and torch.cuda.device_count() >= n_stages:
        return [torch.device("cuda", i) for i in range(n_stages)]
    return [device] * n_stages


def _pipeline_checks(args, cfg) -> None:
    """JAX's asserts on the pipeline flags (`driver.py:346-352`)."""
    if cfg.llama.num_layers % args.pipeline_stages:
        raise ValueError(f"--pipeline_stages {args.pipeline_stages} "
                         f"does not divide {cfg.llama.num_layers} layers")
    if args.batch_size % args.pipeline_microbatches:
        raise ValueError(f"--batch_size {args.batch_size} does not "
                         f"divide into {args.pipeline_microbatches} "
                         "microbatches")


def _whole(tree, pipe, num_layers: int):
    """A state to save: with one pipeline stage a rank, every stage's
    entries gathered on rank 0 (`parallel.pipeline.gather_stages`; {} on
    the other ranks)."""
    if pipe is None:
        return tree
    return ppipe.gather_stages(tree, pipe, num_layers) or {}


def _run(args):
    if args.pipeline_stages > 1 and args.mesh_model != 1:
        raise ValueError("--pipeline_stages and --mesh_model > 1 are "
                         "mutually exclusive")
    parallel = args.multihost or args.mesh_model > 1
    if parallel:
        device = pmesh.init_distributed(args.device)
    else:
        device = _device(args.device)
    args.device = str(device)
    # one pipeline stage a rank
    pipe = (ppipe.make_rank_pipe(args.pipeline_stages, device)
            if args.multihost and args.pipeline_stages > 1 else None)
    np.random.seed(args.seed)

    cfg = build_config(args)
    tokenizer = build_tokenizer(args, cfg)
    # special-token ids must come from the ACTUAL tokenizer (the config
    # defaults assume the published 32000-base vocab)
    from ..text.tokenizer import special_token_ids_from
    cfg = dataclasses.replace(cfg, tokens=special_token_ids_from(tokenizer))
    if args.pipeline_stages > 1:
        _pipeline_checks(args, cfg)
    mesh = (pmesh.make_mesh(model=args.mesh_model, device_type=device.type)
            if parallel and pipe is None else None)
    # a pipeline rank reads its shard of the data, as a "data" rank does
    data_rank, data_size = ((pipe.stage, pipe.n_stages) if pipe else
                            (pmesh.axis_rank(mesh, "data"),
                             pmesh.axis_size(mesh, "data")))
    train_ds, val_ds = build_datasets(args, cfg, data_rank, data_size)

    layers = (ppipe.stage_layers(cfg.llama.num_layers, pipe.n_stages,
                                 pipe.stage) if pipe else None)
    model = init_grove_params(cfg, device=device,
                              dtype=model_dtype(args.model_size),
                              seed=args.seed, remat=args.remat, layers=layers)
    if args.version and os.path.exists(args.version):
        copied, missing, mismatched = load_version(model, args.version)
        print(f"loaded {copied} tensors from {args.version}; "
              f"missing={len(missing)} mismatched={len(mismatched)}")

    opt_cfg = optimizer_config(args)
    mask = trainable_mask(model, opt_cfg)
    partition_params(model, mask)
    if args.mesh_model > 1:
        from ..parallel.sharding import shard_pytree
        shard_pytree(model, mesh)
    # a pipeline rank holds its own stage's layers only
    params = {n: p for n, p in model.named_parameters()
              if mask[n] and not p.is_meta}
    optimizer = make_optimizer(params, opt_cfg)
    if args.grad_accumulation_steps > 1:
        optimizer = MultiSteps(optimizer, args.grad_accumulation_steps)
    n_train = sum(p.numel() for n, p in model.named_parameters() if mask[n])
    n_total = sum(p.numel() for p in model.parameters())
    print(f"trainable params: {n_train/1e6:.1f}M / {n_total/1e6:.1f}M")
    if pipe is not None:
        print(f"pipeline-parallel LLM: {args.pipeline_stages} stages x "
              f"{len(layers)} layers, one a rank (this rank: stage "
              f"{pipe.stage}, layers {layers.start}-{layers.stop - 1} on "
              f"{device}) over {pipe.transport}, "
              f"{args.pipeline_microbatches} microbatches of the global "
              f"batch of {args.batch_size * pipe.n_stages} rows")
        train_step = make_pipelined_train_step(model, optimizer, pipe,
                                               args.pipeline_microbatches)
    elif args.pipeline_stages > 1:
        from ..parallel.pipeline import make_pipe_mesh, place_stages
        stages = make_pipe_mesh(args.pipeline_stages,
                                _pipe_devices(device, args.pipeline_stages))
        place_stages(model.model, stages)
        print(f"pipeline-parallel LLM: {args.pipeline_stages} stages x "
              f"{cfg.llama.num_layers // args.pipeline_stages} layers on "
              f"{[str(d) for d in stages.devices]}, "
              f"{args.pipeline_microbatches} microbatches")
        train_step = make_pipelined_train_step(model, optimizer, stages,
                                               args.pipeline_microbatches)
    elif mesh is None:
        train_step = make_train_step(model, optimizer)
    else:
        train_step = make_train_step(model, optimizer, mesh)

    rank, _ = process_rank_world()
    log_dir = os.path.join(args.log_base_dir, args.exp_name)
    os.makedirs(log_dir, exist_ok=True)
    writer = None
    if rank == 0:
        try:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(log_dir)
        except Exception:
            writer = None
    ckpt = CheckpointManager(log_dir)

    start_epoch = 0
    if args.auto_resume:
        latest = ckpt.latest_step()
        if latest is not None:
            from ..parallel.sharding import load_full_state_dict
            restored = ckpt.restore(latest)
            load_full_state_dict(model, restored["params"])
            opt_state = restored["opt_state"]
            if pipe is not None:
                opt_state = ppipe.local_entries(opt_state,
                                                optimizer.state_dict())
            optimizer.load_state_dict(opt_state)
            del restored
            start_epoch = latest // args.steps_per_epoch
            print(f"resumed from step {latest} (epoch {start_epoch})")

    from ..text.prompts import (VIDEO_GROUNDING_QUESTIONS,
                                VIDEO_STG_QUESTIONS)
    qts = (VIDEO_STG_QUESTIONS if args.dataset == "VidSTG"
           else VIDEO_GROUNDING_QUESTIONS)
    # every rank of one "data" index reads the same shard; with a manifest
    # the dataset is already sharded by data rank: the loader must not
    # stride it again (shuffle then happens shard-locally, the
    # streaming-scale recipe; see data/index.py)
    shard = (dict(process_index=0, process_count=1)
             if getattr(args, "manifest", None)
             else dict(process_index=data_rank, process_count=data_size))
    loader = GroundingLoader(train_ds, tokenizer, cfg,
                             batch_size=args.batch_size,
                             num_workers=args.num_workers, seed=args.seed,
                             question_templates=qts, **shard)
    val_loader = None
    if val_ds is not None:
        val_loader = GroundingLoader(val_ds, tokenizer, cfg,
                                     batch_size=args.batch_size,
                                     shuffle=False, drop_last=False,
                                     num_workers=args.num_workers,
                                     question_templates=qts,
                                     process_index=data_rank,
                                     process_count=data_size)

    best_metric = ckpt.best_metric_from_marker() or -1e9
    L = cfg.llama.num_layers
    global_step = start_epoch * args.steps_per_epoch
    prof = None
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        meters = {k: AverageMeter(k, ":.4f") for k in
                  ("loss", "ce_loss", "giou_loss", "l1_loss",
                   "temp_objectness_loss")}
        bt = AverageMeter("secs/batch", ":.2f")
        dt = AverageMeter("data_secs", ":.2f")
        progress = ProgressMeter(
            args.steps_per_epoch,
            [bt, dt] + list(meters.values()), prefix=f"Epoch[{epoch}]")

        it = iter(loader)
        t_end = time.time()
        for step in range(args.steps_per_epoch):
            try:
                batch, meta = next(it)
            except StopIteration:
                loader.set_epoch(epoch * 1000 + step)
                it = iter(loader)
                batch, meta = next(it)
            dt.update(time.time() - t_end)
            if args.profile_dir and global_step == 2:
                prof = _profiler(args.profile_dir)
            metrics = train_step(
                batch_to_device(batch, device) if pipe is not None else
                pmesh.globalize_batch(batch, mesh, device))
            loss = float(metrics["loss"])
            if prof is not None and global_step == 4:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof.stop()
                prof.export_chrome_trace(os.path.join(
                    args.profile_dir, f"trace_rank{rank}.json"))
                prof = None
            for k, m in meters.items():
                if k in metrics:
                    m.update(float(metrics[k]))
            bt.update(time.time() - t_end)
            t_end = time.time()
            global_step += 1
            if step % args.print_freq == 0:
                progress.display(step)
            if writer:
                writer.add_scalar("train/loss", loss, global_step)
                for k, m in meters.items():
                    writer.add_scalar(f"train/{k}", m.val, global_step)
                writer.add_scalar("metrics/total_secs_per_batch", bt.val,
                                  global_step)
                writer.add_scalar("metrics/data_secs_per_batch", dt.val,
                                  global_step)

        if val_loader is not None:
            val_metrics = validate(
                model if pipe is None else ppipe.RankPipelineModel(
                    model, pipe, args.pipeline_microbatches),
                val_loader, cfg, args)
            print(f"epoch {epoch} val: "
                  + " ".join(f"{k}={v:.4f}" for k, v in val_metrics.items()))
            if writer:
                for k, v in val_metrics.items():
                    if k != "key_metric":
                        writer.add_scalar(f"val/{k}", v, global_step)
            if val_metrics["key_metric"] > best_metric:
                best_metric = val_metrics["key_metric"]
                ckpt.save_best(epoch, _whole(model.state_dict(), pipe, L),
                               "metric", best_metric)
        ckpt.save(global_step, _whole(model.state_dict(), pipe, L),
                  _whole(optimizer.state_dict(), pipe, L))

    if prof is not None:
        prof.stop()
    ckpt.close()
    if writer:
        writer.close()
    print(f"training done: {global_step} steps, best={best_metric:.4f}")
    return best_metric


def main(args=None):
    """Entry with in-process elastic restarts (reference torchrun
    `--max_restarts`, `train_scripts/train_howtoground.sh:21-29`)."""
    import torch.distributed as dist
    parsed = parse_args(args)
    owned = not dist.is_initialized()
    attempt = 0
    try:
        while True:
            try:
                return _run(parsed)
            except KeyboardInterrupt:
                raise
            except Exception as e:
                if attempt >= parsed.max_restarts:
                    raise
                attempt += 1
                print(f"training failed ({type(e).__name__}: {e}); "
                      f"restart {attempt}/{parsed.max_restarts} with "
                      f"auto_resume", flush=True)
                parsed.auto_resume = True
    finally:
        # a process group this run joined is left with it
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
