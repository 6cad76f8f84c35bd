"""Vocab-embedding export (counterpart of `grove_tpu/tools/embed_tokens.py`,
the reference `embed_tokens.py`).

The reference precomputes a (V, 4096) table of token embeddings for its
generation path (`embed_tokens.py:66-79`). Here the table is a weight of
the model, so this tool exports it to .npz (fp32, key `token_embeddings`):
from a torch `.bin` (`--version`, PEFT names normalized as
`from_pretrained` reads it), else the table `init_grove_params` draws from
`--seed` (the first draw of its generator, so the rest of the model is not
built). `--device` (default `cuda`) is where the table is made.

    python -m grove_tpu_torch.tools.embed_tokens --version ckpt.bin \\
        --model_size full --output token_embeddings.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def random_table(cfg, seed: int, device) -> torch.Tensor:
    """The embedding table of `init_grove_params(cfg, seed=seed)` in fp32:
    `model.embed_tokens.weight` is the first parameter `init_params_` fills
    from its generator, N(0, 0.02)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.llama.padded_vocab_size, cfg.llama.hidden_size)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * 0.02


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--version", default=None,
                   help="torch .bin checkpoint (optional)")
    p.add_argument("--model_size", default="tiny",
                   choices=["tiny", "small", "full"])
    p.add_argument("--output", default="token_embeddings.npz")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..config import GroveConfig
    cfg = {"tiny": GroveConfig.tiny, "small": GroveConfig.small,
           "full": GroveConfig}[args.model_size]()
    shape = (cfg.llama.padded_vocab_size, cfg.llama.hidden_size)
    if args.version and os.path.exists(args.version):
        from ..api.model import read_checkpoint
        sd = read_checkpoint(args.version)
        table = sd.get("model.embed_tokens.weight")
        if table is None or table.shape != shape:
            raise ValueError(
                f"{args.version}: model.embed_tokens.weight is "
                f"{None if table is None else table.shape}, the "
                f"{args.model_size} model's table is {shape}")
        table = torch.from_numpy(table).to(args.device)
    else:
        table = random_table(cfg, args.seed, args.device)
    table = table.cpu().numpy()
    np.savez(args.output, token_embeddings=table)
    print(f"wrote ({table.shape[0]}, {table.shape[1]}) embedding table "
          f"to {args.output}")
    return table


if __name__ == "__main__":
    main()
