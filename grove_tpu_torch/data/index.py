"""Manifest-based sharded dataset index for streaming-scale training.

Copy of `grove_tpu/data/index.py` (numpy only; the port imports nothing of
the JAX package), held equal to it by `tests/test_torch_data.py`.

The reference globs per-video annotation pickles at dataset init
(`dataset/video_grounding_datasets/HowTo100M.py:57-60` via the annotation
dir listing) — fine at iGround scale, pathological at HowToGround1M scale
(~1M files: a multi-minute listdir on network filesystems, repeated on every
host at every restart). TPU-native replacement:

  * `build_manifest` runs ONCE (tools/build_index.py) and writes a plain
    text manifest — one key per line, `#count=N` header — so startup is a
    single sequential file read instead of a directory walk;
  * `ShardedKeyIndex` gives each host its strided shard of the manifest
    (`rank::world`, DistributedSampler semantics with pad-to-equal-length so
    every host runs the same number of steps) while holding only `1/world`
    of the keys in memory;
  * per-epoch shuffling is shard-local from a deterministic
    `(seed, epoch)` stream — the grain/tf.data "shard-then-shuffle" recipe,
    which avoids materializing a global permutation of 1M entries per host.

Shard-local shuffling is a deliberate delta from DistributedSampler's
global-shuffle-then-shard: at streaming scale the global permutation buys
nothing (the strided shard assignment is already an interleave over the
manifest order) and costs O(N) memory per host.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

import numpy as np

MANIFEST_HEADER = "#count="


def build_manifest(ann_dir: str, out_path: str,
                   suffix: str = ".pkl") -> int:
    """Scan `ann_dir` once and write the key manifest. Returns the count."""
    keys = sorted(os.path.splitext(f)[0]
                  for f in os.listdir(ann_dir) if f.endswith(suffix))
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{MANIFEST_HEADER}{len(keys)}\n")
        for k in keys:
            f.write(k + "\n")
    os.replace(tmp, out_path)  # atomic publish for concurrent readers
    return len(keys)


def read_manifest(path: str, rank: int = 0, world: int = 1,
                  pad_to_equal: bool = True) -> List[str]:
    """Read this host's strided shard (`rank::world`) of the manifest.

    With `pad_to_equal`, short shards wrap around to the front keys so all
    hosts see ceil(N/world) entries (DistributedSampler padding,
    `train.py:452-461` semantics via torch's sampler).
    """
    if world <= 0 or not (0 <= rank < world):
        raise ValueError(f"bad shard spec rank={rank} world={world}")
    shard: List[str] = []
    extra: List[str] = []
    with open(path) as f:
        head = f.readline().strip()
        if not head.startswith(MANIFEST_HEADER):
            raise ValueError(f"{path}: missing '{MANIFEST_HEADER}' header")
        n = int(head[len(MANIFEST_HEADER):])
        per = -(-n // world)
        pad = per * world - n   # wrapped indices n..per*world-1 reuse keys 0..pad-1
        for i, line in enumerate(f):
            if i >= n:
                raise ValueError(f"{path}: more lines than header count {n}")
            if i % world == rank:
                shard.append(line.rstrip("\n"))
            if pad_to_equal and i < pad and (n + i) % world == rank:
                extra.append(line.rstrip("\n"))
    if pad_to_equal:
        shard.extend(extra)
        if len(shard) != per:
            raise ValueError(
                f"{path}: shard {rank}/{world} got {len(shard)} != {per}")
    return shard


class ShardedKeyIndex:
    """Host-local view of a manifest with deterministic per-epoch shuffling.

    Usage:
        idx = ShardedKeyIndex(manifest, rank=jax.process_index(),
                              world=jax.process_count(), seed=42)
        keys = idx.epoch_keys(epoch)     # shuffled shard for this epoch
    """

    def __init__(self, manifest_path: str, rank: int = 0, world: int = 1,
                 seed: int = 0, shuffle: bool = True):
        self.keys = read_manifest(manifest_path, rank, world)
        self.rank = rank
        self.world = world
        self.seed = seed
        self.shuffle = shuffle

    def __len__(self) -> int:
        return len(self.keys)

    def epoch_keys(self, epoch: int) -> List[str]:
        if not self.shuffle:
            return list(self.keys)
        order = np.arange(len(self.keys))
        # rank-dependent stream: shards draw DIFFERENT permutations, which
        # is fine (the shard assignment itself is fixed and disjoint)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, self.rank]))
        rng.shuffle(order)
        return [self.keys[i] for i in order]
