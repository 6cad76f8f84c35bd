"""The JAX package's model directories in the port, on the CPU at tiny():
`checkpoint.flax_msgpack` (the msgpack reader and writer),
`checkpoint.convert.load_jax_tree` / `jax_tree_from_model` and
`GroveForCausalLM.from_pretrained(dir)`.

* The JAX `save_pretrained` of six models (float fp32 and bf16; W4A8 with
  W8A8 towers, calibrated; fused; fused after quantize; LoRA) loads with
  `from_pretrained(dir, device="cpu")`: the port's state bit-equal to a
  port model filled from the same tree by JAX's own `to_torch_state_dict`,
  its unfuse and the port's existing loaders (`load_jax_quantized_llama`,
  `load_jax_quantized_towers`, `jax_lora_state_dict`), with the mask
  decoder's ConvTranspose kernels flipped (`tests/test_torch_region.py`);
  greedy tokens identical to JAX's `generate_grounded`, boxes, objectness
  and the masks of `segment` within 2e-3 (1e-2 in bf16, a bf16 ULP at 0.5
  being 3.9e-3; the masks only agree with the flip).
* The port's `save_jax_pretrained` writes a directory that JAX's
  `from_pretrained` reads back bit-equal to the tree the port loaded.
* The writer's bytes equal `flax.serialization.to_bytes` for the same
  dict; chunked leaves (flax's `MAX_CHUNK_SIZE` lowered by monkeypatch)
  read and write; truncated and malformed files raise ValueError naming
  the file and the byte offset.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from grove_tpu.api.model import GroveForCausalLM as JaxLM  # noqa: E402
from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.config import GroveConfig  # noqa: E402
from grove_tpu.models.fuse import unfuse_llama_projections  # noqa: E402
from grove_tpu.models.grove import GroveModel as JaxGrove  # noqa: E402
from grove_tpu.text.mock_tokenizer import MockTokenizer  # noqa: E402
from grove_tpu_torch.api import GroveForCausalLM  # noqa: E402
from grove_tpu_torch.checkpoint import flax_msgpack  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    jax_lora_state_dict, jax_tree_from_model, load_jax_quantized_llama,
    load_jax_quantized_towers)
from grove_tpu_torch.models.fuse import fuse_llama_projections  # noqa
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from test_torch_parity import (TOL, _frames, _perturb_zeros,  # noqa: E402
                               _prompt, port_config)
from test_torch_region import _prompts, flip_conv_transpose  # noqa: E402

KINDS = ["fp32", "bf16", "w4a8_static", "fused", "quant_fused", "lora"]
NEW_TOKENS = 8
# bf16 on both sides: the outputs are bf16 values, one ULP of which is
# 3.9e-3 at 0.5 (measured: 3.9e-3, one ULP, on a quarter of the boxes)
BF16_TOL = 1e-2


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


@pytest.fixture(scope="module")
def jax_models():
    """{kind: (JAX LM, dtype of both sides)}, from one seeded tiny tree
    (zero leaves refilled) and one clip to calibrate on."""
    cfg = GroveConfig.tiny()
    base = JaxLM.from_pretrained(None, "tiny", dtype=jnp.float32)
    params = _perturb_zeros(base.variables["params"],
                            np.random.default_rng(0))
    base = JaxLM(cfg, base.model, {"params": params})
    fc, fs = _frames(cfg, np.random.default_rng(11), 1)
    quant = base.quantize(vision=True, bits=4, act_quant=True).calibrate(
        jnp.asarray(fc), jnp.asarray(fs))
    # LoRA leaves as `LoraDelta` names them (`models/llama.py:160-166`),
    # seeded: the JAX model of the LoRA config takes the tree as it is
    lora_cfg = dataclasses.replace(
        cfg, llama=dataclasses.replace(cfg.llama, lora_r=4))
    rng = np.random.default_rng(2)
    lora_params = jax.tree.map(lambda x: x, params)
    for layer in range(cfg.llama.num_layers):
        attn = lora_params["llama"][f"layers_{layer}"]["self_attn"]
        for proj in ("q_proj", "v_proj"):
            k, n = attn[proj]["kernel"].shape
            attn[f"{proj}_lora"] = {
                "lora_A": {"kernel": rng.normal(size=(k, 4)).astype(
                    np.float32) * 0.1},
                "lora_B": {"kernel": rng.normal(size=(4, n)).astype(
                    np.float32) * 0.1}}
    lora = JaxLM(lora_cfg, JaxGrove(lora_cfg, dtype=jnp.float32),
                 {"params": lora_params})
    bf16 = JaxLM(cfg, JaxGrove(cfg, dtype=jnp.bfloat16), {"params": params})
    return {"fp32": (base, torch.float32), "bf16": (bf16, torch.bfloat16),
            "w4a8_static": (quant, torch.float32),
            "fused": (base.fuse(), torch.float32),
            "quant_fused": (quant.fuse(), torch.float32),
            "lora": (lora, torch.float32)}


def _reference(jlm, dtype):
    """A port model of the JAX LM's config filled by the existing pieces:
    JAX's `to_torch_state_dict` (of the unfused tree, the port's fuse
    after), the ConvTranspose flip, the LoRA and quantized loaders."""
    cfg, params = jlm.cfg, jlm.variables["params"]
    ref = GroveModel(port_config(cfg), device="cpu", dtype=dtype)
    tree = (unfuse_llama_projections(params, cfg.llama)
            if cfg.llama.fused_qkv else params)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in flip_conv_transpose(
        to_torch_state_dict(tree, cfg)).items()}
    sd.update(jax_lora_state_dict(params))
    if cfg.llama.fused_qkv:
        sd = fuse_llama_projections(sd)
    own = ref.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(v)
    if cfg.llama.weight_quant:
        load_jax_quantized_llama(ref, params)
    if cfg.clip.quant_w8a8:
        load_jax_quantized_towers(ref, params)
    return ref.eval()


@pytest.fixture(scope="module")
def loaded(jax_models, tmp_path_factory):
    """{kind: (JAX LM, the port's from_pretrained of its directory)}."""
    out = {}
    for kind, (jlm, dtype) in jax_models.items():
        d = str(tmp_path_factory.mktemp(kind))
        jlm.save_pretrained(d)
        assert sorted(os.listdir(d)) == ["config.json", "flax_model.msgpack"]
        out[kind] = (jlm, GroveForCausalLM.from_pretrained(
            d, dtype=dtype, device="cpu"))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_state_equals_the_existing_loaders(loaded, jax_models, kind):
    jlm, lm = loaded[kind]
    assert lm.cfg.to_dict() == port_config(jlm.cfg).to_dict()
    want = _reference(jlm, jax_models[kind][1]).state_dict()
    got = lm.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert not lm.model.training


def _jax_generate(jlm, cfg, ids, vs, fc, fs):
    from grove_tpu.infer.generate import generate_grounded
    return generate_grounded(jlm.model, jlm.variables, cfg, MockTokenizer(),
                             ids.astype(np.int32), vs.astype(np.int32),
                             jnp.asarray(fc), jnp.asarray(fs),
                             max_new_tokens=NEW_TOKENS,
                             cache_dtype=jnp.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_outputs_match_jax(loaded, kind):
    """Greedy tokens identical to JAX's, boxes and objectness within
    2e-3, and `segment`'s masks and IoU predictions within 2e-3 (bf16:
    both sides compute in bf16, the tokens still identical, the rest
    within BF16_TOL)."""
    from grove_tpu_torch.infer.generate import generate_grounded
    jlm, lm = loaded[kind]
    cfg = jlm.cfg
    rng = np.random.default_rng(5)
    fc, fs = _frames(cfg, rng, 1)
    ids, vs, _ = _prompt(cfg, rng, 1)
    want = _jax_generate(jlm, cfg, ids, vs, fc, fs)
    got = generate_grounded(lm.model, lm.cfg, MockTokenizer(), ids, vs,
                            torch.from_numpy(fc), torch.from_numpy(fs),
                            max_new_tokens=NEW_TOKENS,
                            cache_dtype=torch.float32)
    np.testing.assert_array_equal(got["generated_ids"],
                                  want["generated_ids"])
    tol = TOL if kind != "bf16" else BF16_TOL
    for key in ("pred_boxes", "objectness_logits"):
        np.testing.assert_allclose(np.asarray(got[key], np.float32),
                                   np.asarray(want[key], np.float32),
                                   rtol=tol, atol=tol, err_msg=key)
    g = cfg.sam_dec.image_embedding_size
    emb = rng.normal(size=(2, g * g, cfg.sam_dec.embed_dim)).astype(
        np.float32)
    prompts = _prompts(cfg, rng, 2, ("points", "boxes"))
    jw = jlm.model.apply(jlm.variables, jnp.asarray(emb),
                         method=JaxGrove.segment,
                         **{k: jnp.asarray(v) for k, v in prompts.items()})
    with torch.inference_mode():
        tw = lm.model.segment(
            torch.from_numpy(emb).to(lm.model.dtype),
            **{k: torch.from_numpy(v) for k, v in prompts.items()})
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("kind", KINDS)
def test_writer_reads_back_in_jax(loaded, tmp_path, kind):
    """`save_jax_pretrained` of the loaded model: the JAX package reads
    every leaf back bit-equal to the tree the port loaded (in the port's
    dtype: a bf16 model writes bf16 leaves, which JAX casts to its fp32
    template), and the port reads it back bit-equal too. The W4A8 model
    goes through JAX's `from_pretrained` itself; the others through its
    two reading steps, `GroveConfig.load_json` and `serialization.
    from_bytes` onto the JAX tree of the same config as the template
    (what its `init_grove_params` builds, without the init)."""
    jlm, lm = loaded[kind]
    n = flax_msgpack.save_jax_pretrained(lm, str(tmp_path))
    assert n == os.path.getsize(tmp_path / "flax_model.msgpack")
    assert GroveConfig.load_json(str(tmp_path / "config.json")) == jlm.cfg
    if kind == "w4a8_static":
        back = JaxLM.from_pretrained(str(tmp_path), dtype=jnp.float32)
        assert back.cfg == jlm.cfg
        got = dict(_flat(back.variables["params"]))
    else:
        with open(tmp_path / "flax_model.msgpack", "rb") as f:
            got = dict(_flat(serialization.from_bytes(
                jlm.variables["params"], f.read())))
    want = dict(_flat(jlm.variables["params"]))
    assert set(got) == set(want)
    for path, v in want.items():
        v = np.asarray(v)
        g = np.asarray(got[path]).astype(v.dtype)
        if lm.model.dtype == torch.bfloat16 and v.dtype == np.float32:
            v = np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
        assert np.array_equal(g, v), path
    again = GroveForCausalLM.from_pretrained(str(tmp_path),
                                             dtype=lm.model.dtype,
                                             device="cpu")
    for k, v in lm.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k


def test_tree_from_model_is_the_exact_inverse(loaded):
    """`jax_tree_from_model` of each loaded model has the JAX tree's paths,
    shapes and values (fp32 models) leaf for leaf."""
    for kind in ("fp32", "w4a8_static", "quant_fused", "lora"):
        jlm, lm = loaded[kind]
        got = dict(_flat(jax_tree_from_model(lm.model)))
        want = dict(_flat(jlm.variables["params"]))
        assert set(got) == set(want), kind
        for path, v in want.items():
            g = got[path].contiguous()
            assert tuple(g.shape) == np.shape(v), path
            assert np.array_equal(g.numpy(), np.asarray(v)), path


def test_writer_bytes_equal_flax(jax_models):
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": np.arange(300, dtype=np.int64),
                  "d": np.zeros((0, 2), np.int8), "e": np.float32(1.5),
                  "f": np.bool_(True), "g": np.ones((2, 2), np.float16),
                  "h": np.asarray(jnp.asarray(rng.normal(size=(5,)),
                                              jnp.bfloat16))},
            "i": "x" * 40, "j": "é" * 200, "k": [1, -5, 200, -200, 70000,
                                                 -70000, 2 ** 40, -2 ** 40],
            "l": 1.25, "m": None, "n": True, "o": b"xy" * 200, "p": 1 + 2j,
            "q": {str(i): np.float64(i) for i in range(20)}, "r": {}}
    tree["k"] = {str(i): v for i, v in enumerate(tree["k"])}
    want = serialization.to_bytes(tree)
    assert flax_msgpack.dumps(tree) == want
    # a torch bf16 tensor writes as JAX's bf16 array
    tree["b"]["h"] = torch.from_numpy(
        tree["b"]["h"].view(np.int16).copy()).view(torch.bfloat16)
    assert flax_msgpack.dumps(tree) == want
    back = flax_msgpack.loads(want)
    assert torch.equal(back["b"]["h"], tree["b"]["h"])
    ref = serialization.msgpack_restore(want)
    for path, v in _flat(ref):
        g = dict(_flat(back))[path]
        if path == "b/h":
            continue
        if isinstance(v, np.ndarray):
            assert g.dtype == v.dtype and np.array_equal(g, v), path
        else:
            assert type(g) is type(v) and g == v, path
    # the JAX tree itself
    params = jax.tree.map(np.asarray,
                          jax_models["w4a8_static"][0].variables["params"])
    assert flax_msgpack.dumps(params) == serialization.to_bytes(params)


def test_chunked_leaves(monkeypatch, jax_models, tmp_path):
    """With flax's MAX_CHUNK_SIZE lowered to 4 KiB, JAX writes its large
    leaves chunked: the port reads the directory to the same state as the
    unchunked one, and its writer's bytes equal flax's with its own limit
    lowered alike."""
    jlm, _ = jax_models["fp32"]
    flat = GroveForCausalLM.from_pretrained(
        _saved(jlm, tmp_path / "plain"), dtype=torch.float32, device="cpu")
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 4096)
    path = _saved(jlm, tmp_path / "chunked")
    raw = flax_msgpack.load(os.path.join(path, "flax_model.msgpack"))
    emb = raw["embed_tokens"]["embedding"]
    assert isinstance(emb, np.ndarray) and emb.nbytes > 4096
    chunked = GroveForCausalLM.from_pretrained(path, dtype=torch.float32,
                                               device="cpu")
    for k, v in flat.model.state_dict().items():
        assert torch.equal(chunked.model.state_dict()[k], v), k
    tree = jax.tree.map(np.asarray, jlm.variables["params"])
    assert flax_msgpack.dumps(tree) == serialization.to_bytes(tree)
    bf = {"w": torch.arange(5000, dtype=torch.float32).bfloat16()}
    back = flax_msgpack.loads(flax_msgpack.dumps(bf))
    assert torch.equal(back["w"], bf["w"])


def _saved(jlm, d):
    jlm.save_pretrained(str(d))
    return str(d)


def test_truncated_and_malformed_files_raise(jax_models, tmp_path):
    jlm, _ = jax_models["fp32"]
    path = os.path.join(_saved(jlm, tmp_path / "m"), "flax_model.msgpack")
    data = open(path, "rb").read()
    for cut in (1, 100, len(data) // 2, len(data) - 1):
        with pytest.raises(ValueError, match=r"truncated.* at byte \d+"):
            flax_msgpack.loads(data[:cut], path)
    for bad, what in ((b"\xc1", "type byte 0xc1"),
                      (b"\x81\xa1a\xc7\x01\x05\x00", "ext type 5"),
                      (data + b"\x00", "trailing bytes")):
        with pytest.raises(ValueError, match=what):
            flax_msgpack.loads(bad, path)
    with open(path, "wb") as f:
        f.write(data[:len(data) // 3])
    with pytest.raises(ValueError, match=f"{path}: truncated"):
        GroveForCausalLM.from_pretrained(os.path.dirname(path), "tiny",
                                         device="cpu")
    open(path, "wb").close()
    with pytest.raises(ValueError, match="at byte 0"):
        flax_msgpack.load(path)


def test_a_leaf_without_a_place_raises(jax_models):
    """`load_jax_tree` is strict both ways."""
    from grove_tpu_torch.checkpoint.convert import load_jax_tree
    jlm, _ = jax_models["fp32"]
    params = jax.tree.map(np.asarray, jlm.variables["params"])
    model = GroveModel(port_config(jlm.cfg), device="cpu",
                       dtype=torch.float32)
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray"):
        load_jax_tree(model, extra)
    short = dict(params)
    del short["lm_head"]
    with pytest.raises(ValueError, match="no leaf for.*lm_head"):
        load_jax_tree(model, short)
    wrong = jax.tree.map(lambda x: x, params)
    wrong["llama"]["norm"]["weight"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="llama/norm/weight"):
        load_jax_tree(model, wrong)
