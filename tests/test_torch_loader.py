"""The port's loader (`GroveForCausalLM.from_pretrained`) against the JAX
package's, on the CPU at GroveConfig.tiny() in fp32.

* `tokenizer=`: a `MockTokenizer` whose special ids differ from the
  defaults, and a SentencePiece `.model` written by
  `sentencepiece.serialize_model` and read by `load_grove_tokenizer`, give
  the config the JAX entry point's `tokens`.
* A `.bin` with PEFT names (`base_model.model.` prefixes, `.base_layer.`
  bases, `.default.` adapters) and LoRA pairs, some tensors in bf16, loads
  to the numbers of JAX's loader (its `normalize_peft_state_dict` merge,
  then `convert_state_dict`), read back through `to_torch_state_dict`:
  bit-equal, since both merge in fp32 numpy with the same code.
* A tree whose SAM was built on another grid (pos_embed and every
  rel_pos table resized by JAX's converter: bicubic and linear
  `jax.image.resize`) loads to JAX's numbers within LOAD_TOL of each
  tensor's max-abs (fp32 on both sides; the port's dense products sum in
  another order than XLA's), downscaled as a 1024 SAM is to 512 and
  upscaled; and the resize alone at the reference's grids (64 -> 32 for
  pos_embed, 127 -> 63 rows of a global table).
* The loader stays strict: an unknown key, a missing key and any other
  shape mismatch raise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.api.model import GroveForCausalLM as JaxLM  # noqa: E402
from grove_tpu.checkpoint import torch_convert  # noqa: E402
from grove_tpu.config import GroveConfig  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.text import sentencepiece as jsp  # noqa: E402
from grove_tpu.text.mock_tokenizer import MockTokenizer as JaxTok  # noqa
from grove_tpu.text.tokenizer import load_grove_tokenizer as jax_load  # noqa
from grove_tpu_torch.api import GroveForCausalLM as PortLM  # noqa: E402
from grove_tpu_torch.checkpoint import convert  # noqa: E402
from grove_tpu_torch.text.mock_tokenizer import MockTokenizer as PortTok  # noqa
from grove_tpu_torch.text.tokenizer import (  # noqa: E402
    load_grove_tokenizer as port_load)

LOAD_TOL = 1e-5          # resized SAM tables, of each tensor's max-abs
SAM = "model.grounding_encoder.image_encoder."


@pytest.fixture(scope="module")
def tree():
    """The tiny JAX parameters with every all-zero leaf refilled from a
    seed, and their reference-named state dict."""
    cfg = GroveConfig.tiny()
    _, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                     dtype=jnp.float32)
    rng = np.random.default_rng(0)

    def fill(x):
        x = np.asarray(x)
        return x if np.any(x != 0) else (
            rng.normal(size=x.shape) * 0.05).astype(x.dtype)
    params = jax.tree_util.tree_map(fill, variables["params"])
    return cfg, torch_convert.to_torch_state_dict(params, cfg)


def _both(path, **kw):
    """(the port's state dict, JAX's read back in the reference names) of
    `path` loaded by each package's `from_pretrained` at tiny size."""
    port = PortLM.from_pretrained(str(path), "tiny", dtype=torch.float32,
                                  device="cpu", **kw)
    jax_lm = JaxLM.from_pretrained(str(path), "tiny", dtype=jnp.float32,
                                   **kw)
    want = torch_convert.to_torch_state_dict(jax_lm.variables["params"],
                                             jax_lm.cfg)
    got = port.model.state_dict()
    assert set(got) == set(want)
    return got, want


def _save(sd, path, bf16=()):
    torch.save({k: (torch.from_numpy(np.array(v)).to(torch.bfloat16)
                    if k in bf16 else torch.from_numpy(np.array(v)))
                for k, v in sd.items()}, path)


def _sp_model_file(path):
    """A unigram SentencePiece model with byte fallback, written with the
    pure-Python writer (no asset, no wheel)."""
    pieces = ([("<unk>", 0.0, jsp.UNKNOWN), ("<s>", 0.0, jsp.CONTROL),
               ("</s>", 0.0, jsp.CONTROL)]
              + [(f"<0x{b:02X}>", 0.0, jsp.BYTE) for b in range(256)]
              + [("▁the", -1.0, jsp.NORMAL), ("▁cat", -2.0, jsp.NORMAL),
                 ("a", -4.5, jsp.NORMAL), ("t", -5.0, jsp.NORMAL)])
    model = jsp.SpModel(pieces, model_type=jsp.UNIGRAM, byte_fallback=True)
    path.write_bytes(jsp.serialize_model(model))
    return path


@pytest.mark.parametrize("kind", ["mock", "sentencepiece"])
def test_from_pretrained_takes_the_tokenizers_ids(kind, tmp_path):
    """`from_pretrained(tokenizer=)` puts the tokenizer's special ids into
    the config, as the JAX entry point does; they differ from the
    defaults."""
    if kind == "mock":
        jtok, ptok = JaxTok(base_vocab_size=300), PortTok(base_vocab_size=300)
    else:
        path = _sp_model_file(tmp_path / "tokenizer.model")
        jtok, ptok = jax_load(str(path)), port_load(str(path))
    port = PortLM.from_pretrained(None, "tiny", tokenizer=ptok,
                                  dtype=torch.float32, device="cpu")
    want = JaxLM.from_pretrained(None, "tiny", tokenizer=jtok,
                                 dtype=jnp.float32).cfg.tokens
    got = dataclasses.asdict(port.cfg.tokens)
    assert got == dataclasses.asdict(want)
    assert got != dataclasses.asdict(PortLM.from_pretrained(
        None, "tiny", dtype=torch.float32, device="cpu").cfg.tokens)
    assert port.model.cfg.tokens == port.cfg.tokens


def _peft(sd, rng, targets):
    """`sd` under PEFT names: every key behind `base_model.model.`, each
    target's weight as `.base_layer.weight` beside a rank-8 LoRA pair
    under `.default.`."""
    out = {}
    for k, v in sd.items():
        base = k[:-len(".weight")]
        if base in targets:
            out[f"base_model.model.{base}.base_layer.weight"] = v
            n_out, n_in = v.shape
            out[f"base_model.model.{base}.lora_A.default.weight"] = (
                rng.normal(size=(8, n_in)) * 0.1).astype(np.float32)
            out[f"base_model.model.{base}.lora_B.default.weight"] = (
                rng.normal(size=(n_out, 8)) * 0.1).astype(np.float32)
        else:
            out[f"base_model.model.{k}"] = v
    return out


def test_peft_checkpoint_loads_like_jax(tree, tmp_path):
    """A PEFT-named `.bin` with LoRA pairs on q_proj and v_proj of every
    layer, some base tensors in bf16, loads bit-equal to JAX's numbers, and
    the merge moved the targets."""
    cfg, sd = tree
    targets = {f"model.layers.{i}.self_attn.{p}_proj"
               for i in range(cfg.llama.num_layers) for p in ("q", "v")}
    peft = _peft(sd, np.random.default_rng(1), targets)
    path = tmp_path / "peft.bin"
    _save(peft, path, bf16={k for k in peft if "mlp" in k})
    got, want = _both(path)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)
    for base in targets:
        assert not np.allclose(want[base + ".weight"], sd[base + ".weight"])


@pytest.mark.parametrize("grid,rel_len", [(5, 9), (1, 2)])
def test_sam_grid_checkpoint_loads_like_jax(tree, tmp_path, grid, rel_len):
    """A tree whose SAM has a pos_embed on a grid x grid grid and rel_pos
    tables of rel_len rows (tiny's are 2 x 2 and 3 rows: 5 -> 2 and 9 -> 3
    downscale with the antialias, 1 -> 2 and 2 -> 3 upscale) loads to JAX's
    numbers within LOAD_TOL of each tensor's max-abs; every other tensor
    bit-equal."""
    cfg, sd = tree
    rng = np.random.default_rng(2)
    sd = dict(sd)
    c = cfg.sam_enc.embed_dim
    sd[SAM + "pos_embed"] = rng.normal(size=(1, grid, grid, c)).astype(
        np.float32)
    resized = [SAM + "pos_embed"]
    for key in [k for k in sd if k.endswith(("rel_pos_h", "rel_pos_w"))]:
        sd[key] = rng.normal(size=(rel_len, sd[key].shape[1])).astype(
            np.float32)
        resized.append(key)
    path = tmp_path / "grid.bin"
    _save(sd, path)
    got, want = _both(path)
    for key in want:
        if key in resized:
            err = np.abs(got[key].numpy() - want[key]).max()
            assert err <= LOAD_TOL * np.abs(want[key]).max(), (key, err)
        else:
            np.testing.assert_array_equal(got[key].numpy(), want[key], key)


class _Enc:
    grid, window_size, global_attn_indexes = 32, 14, (7,)


@pytest.mark.parametrize("grid0", [64, 24])
def test_sam_grid_resize_at_the_reference_grids(grid0):
    """`resize_sam_grids` == the JAX converter's `resize_abs_pos` and
    `resize_rel_pos` at SAM ViT-H's widths cut to a few channels: a
    pos_embed of a 1024 (64 x 64) or a 384 (24 x 24) build to the 512 grid
    of 32, a global block's table of 2 grid0 - 1 rows to 63, a windowed
    block's 27 rows (window 14 both ways) unchanged."""
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(1, grid0, grid0, 16)).astype(np.float32)
    glob = rng.normal(size=(2 * grid0 - 1, 8)).astype(np.float32)
    win = rng.normal(size=(27, 8)).astype(np.float32)
    sd = {SAM + "pos_embed": pos, SAM + "blocks.7.attn.rel_pos_h": glob,
          SAM + "blocks.0.attn.rel_pos_w": win}
    got = convert.resize_sam_grids(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        type("Cfg", (), {"sam_enc": _Enc}))
    want_pos = torch_convert.resize_abs_pos(pos, 32)[None]
    want_glob = torch_convert.resize_rel_pos(glob, 63)
    for key, want in ((SAM + "pos_embed", want_pos),
                      (SAM + "blocks.7.attn.rel_pos_h", want_glob)):
        assert got[key].shape == want.shape
        err = np.abs(got[key].numpy() - want).max()
        assert err <= LOAD_TOL * np.abs(want).max(), (key, err)
    np.testing.assert_array_equal(got[SAM + "blocks.0.attn.rel_pos_w"], win)


@pytest.mark.parametrize("fault", ["unknown key", "missing key",
                                   "pos_embed channels"])
def test_loader_stays_strict(tree, tmp_path, fault):
    """After the PEFT names are stripped and the SAM grid is resized, a key
    the model lacks, a key the file lacks and any other shape mismatch
    raise."""
    cfg, sd = tree
    sd = {f"base_model.model.{k}": v for k, v in sd.items()}
    if fault == "unknown key":
        sd["base_model.model.model.layers.0.self_attn.extra.weight"] = \
            np.ones((2, 2), np.float32)
        match = "Unexpected key"
    elif fault == "missing key":
        del sd["base_model.model.model.norm.weight"]
        match = "Missing key"
    else:
        sd[f"base_model.model.{SAM}pos_embed"] = np.ones(
            (1, 4, 4, cfg.sam_enc.embed_dim + 1), np.float32)
        match = "size mismatch"
    path = tmp_path / "bad.bin"
    _save(sd, path)
    with pytest.raises(RuntimeError, match=match):
        PortLM.from_pretrained(str(path), "tiny", dtype=torch.float32,
                               device="cpu")
