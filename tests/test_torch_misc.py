"""grove_tpu_torch: copied host code, import hygiene, small ops against the
JAX package, and the parts of the slice that raise until they are ported."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grove_tpu.config import GroveConfig, LlamaConfig  # noqa: E402
from grove_tpu_torch.models import layers as tlayers  # noqa: E402
from grove_tpu_torch.models import llama as tllama  # noqa: E402


@pytest.mark.parametrize("n,seg", [(24, 8), (8, 8), (29, 8), (6, 2),
                                   (3, 8)])
def test_sampling_copies_equal_originals(n, seg):
    from grove_tpu.data import sampling as jsamp
    from grove_tpu_torch.data import sampling as tsamp
    want = jsamp.sliding_segment_with_mask(n, seg)
    assert tsamp.sliding_segment_with_mask(n, seg) == want
    assert (tsamp.center_window_index(want[1])
            == jsamp.center_window_index(want[1]))


def test_normalization_constants_equal_originals():
    from grove_tpu.data import preprocess as jpre
    from grove_tpu_torch.data import preprocess as tpre
    for name in ("CLIP_MEAN", "CLIP_STD", "SAM_MEAN", "SAM_STD"):
        np.testing.assert_array_equal(getattr(tpre, name),
                                      getattr(jpre, name))


def test_import_leaves_jax_and_pil_out():
    code = ("import sys, grove_tpu_torch, grove_tpu_torch.infer.sliding, "
            "grove_tpu_torch.checkpoint.convert, grove_tpu_torch._kernels, "
            "grove_tpu_torch.api, grove_tpu_torch.api.processor, "
            "grove_tpu_torch.ops.quant, grove_tpu_torch.ops.fused_ln, "
            "grove_tpu_torch.ops.int8_matmul, grove_tpu_torch.profile_towers; "
            "print(sorted(m for m in ('jax', 'PIL', 'flax') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_adaptive_pool_matches_jax():
    from grove_tpu.models.layers import adaptive_avg_pool_3d as jpool
    x = np.random.default_rng(0).normal(size=(2, 8, 24, 24, 5)).astype(
        np.float32)
    want = jpool(jnp.asarray(x), (8, 8, 9))
    got = tlayers.adaptive_avg_pool_3d(torch.from_numpy(x), (8, 8, 9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_rope_matches_jax():
    from grove_tpu.models.llama import apply_rope, rope_angles
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 600, size=(2, 7))
    jc, js = rope_angles(jnp.asarray(pos), 16, 10000.0)
    tc, ts = tllama.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    got = tllama.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(apply_rope(jnp.asarray(x), jc, js)),
                               rtol=1e-5, atol=1e-5)


def test_window_partition_round_trip_matches_jax():
    from grove_tpu.models.sam_encoder import window_partition as jpart
    from grove_tpu_torch.models.sam_encoder import (window_partition,
                                                    window_unpartition)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 4)).astype(
        np.float32)
    want, want_hw = jpart(jnp.asarray(x), 14)
    got, hw = window_partition(torch.from_numpy(x), 14)
    assert hw == want_hw == (42, 42) and got.shape[0] == 2 * 9
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = window_unpartition(got, 14, hw, (32, 32))
    np.testing.assert_array_equal(back.numpy(), x)


def test_video_adapter_matches_jax():
    import jax
    from grove_tpu.checkpoint.torch_convert import _inv_conv3d
    from grove_tpu.models.layers import SpatioTemporalConvAdapter as JAd
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 4, 5, 6, 8)).astype(np.float32)
    jmod = JAd(dtype=jnp.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"alpha": np.array([0.7], np.float32),
              "conv3d": {"kernel": np.asarray(params["conv3d"]["kernel"]),
                         "bias": rng.normal(size=8).astype(np.float32)}}
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tlayers.SpatioTemporalConvAdapter(8)
    tmod.load_state_dict({
        "alpha": torch.tensor([0.7]),
        "conv3d.weight": torch.from_numpy(
            _inv_conv3d(params["conv3d"]["kernel"])),
        "conv3d.bias": torch.from_numpy(params["conv3d"]["bias"])})
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_skip_patterns_copy_equals_original():
    from grove_tpu.checkpoint import torch_convert
    from grove_tpu_torch.checkpoint import convert
    assert convert.SKIP_PATTERNS == torch_convert.SKIP_PATTERNS


@pytest.mark.parametrize("key", [None, "bf16", "bfloat16", "int8", "fp32",
                                 "float32"])
def test_decode_kwargs_table_equals_original(key):
    """The port's copy of `api/processor.py:_decode_kwargs` maps each
    kv_cache_dtype to the same dtype and builds the same other options."""
    from grove_tpu.api.processor import _decode_kwargs as jkw
    from grove_tpu_torch.api.processor import _decode_kwargs as tkw
    want, got = jkw(key, True), tkw(key, True)
    assert set(got) == set(want)
    assert str(got.pop("cache_dtype")).split(".")[-1] == \
        jnp.dtype(want.pop("cache_dtype")).name
    assert got == want


def test_decode_kwargs_rejects_like_original():
    from grove_tpu.api.processor import _decode_kwargs as jkw
    from grove_tpu_torch.api.processor import _decode_kwargs as tkw
    for args, kw in ((("int4", True), {}), (("int8", True),
                                            {"num_beams": 2}),
                     ((None, True), {"top_k": 3})):
        for fn in (jkw, tkw):
            with pytest.raises(ValueError):
                fn(*args, **kw)


@pytest.mark.parametrize("field", ["act_quant", "fused_qkv", "lora_r"])
def test_unported_llama_options_raise(field):
    value = 8 if field == "lora_r" else True
    cfg = dataclasses.replace(LlamaConfig.tiny(), **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        tllama.LlamaModel(cfg, device="meta")


def _tiny_model():
    from grove_tpu_torch.models.grove import init_grove_params
    return init_grove_params(GroveConfig.tiny(), device="cpu",
                             dtype=torch.float32, seed=0)


def test_unported_paths_raise():
    from grove_tpu_torch.infer.generate import greedy_decode
    model = _tiny_model()
    cfg = model.cfg
    raw = torch.zeros(1, 2, 40, 30, 3, dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="raw-frame"):
        model.encode_video(raw)
    with pytest.raises(NotImplementedError, match="raw-frame"):
        model.encode_grounding(torch.zeros(1, 2, 48, 40, dtype=torch.uint8))
    with pytest.raises(NotImplementedError, match="region encoder"):
        model.encode_regions((), torch.zeros(1, 4), torch.zeros(1))
    pe = model.model.grounding_encoder.prompt_encoder
    with pytest.raises(NotImplementedError, match="mask path"):
        pe(points=torch.zeros(1, 1, 2))
    with pytest.raises(NotImplementedError, match="mask path"):
        model.model.grounding_encoder.mask_decoder.predict_masks()
    ids = torch.ones(1, 10, dtype=torch.long)
    feats = torch.zeros(1, cfg.num_video_tokens, cfg.llama.hidden_size)
    with pytest.raises(NotImplementedError, match="sampled decoding"):
        greedy_decode(model, ids, feats, [-1], max_new_tokens=2, eos_id=2,
                      temperature=0.7)
    with pytest.raises(ValueError, match="KV cache dtype"):
        tllama.init_kv_caches(cfg.llama, 1, 4, dtype=torch.int16,
                              device="cpu")


def test_calibrate_requires_quantized_towers():
    """`calibrate` on a model whose towers are float, or whose LLM alone
    was quantized, raises and leaves the model as it was
    (`api/model.py:150-151` asserts the same)."""
    from grove_tpu_torch.api import GroveForCausalLM
    lm = GroveForCausalLM.from_pretrained(None, "tiny", dtype=torch.float32,
                                          seed=0)
    frames = torch.zeros(1, 2, 28, 28, 3, dtype=torch.uint8)
    sam = torch.zeros(1, 2, 32, 32, 3, dtype=torch.uint8)
    for step in (lambda: None, lambda: lm.quantize(bits=4)):
        step()
        with pytest.raises(ValueError, match="quantize\\(vision=True\\)"):
            lm.calibrate(frames, sam)
        assert not lm.cfg.clip.quant_w8a8
        assert not lm.cfg.sam_enc.quant_static_act


def test_random_init_is_seeded_and_sane():
    """init_grove_params fills every parameter from the seed: two builds
    agree, another seed differs, and norms / gates get their set values."""
    a, b = _tiny_model(), _tiny_model()
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    from grove_tpu_torch.models.grove import init_grove_params
    c = init_grove_params(GroveConfig.tiny(), device="cpu",
                          dtype=torch.float32, seed=1)
    assert not torch.equal(a.lm_head.weight, c.lm_head.weight)
    enc = a.model.grounding_encoder.image_encoder
    assert torch.all(enc.blocks[0].norm1.weight == 1)
    assert torch.all(enc.adapters[0].alpha == 0.1)
    assert torch.all(a.model.norm.weight == 1)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_package(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result where there is no
    CUDA device (this machine's torch has none), and where it is run from a
    directory holding it and nothing else of the repo."""
    import shutil
    from pathlib import Path
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
    assert "chip_smoke FAILED" in out.stderr


def test_profile_towers_fails_without_card():
    """The towers' profiling script exits non-zero, having printed nothing
    on its standard output, where there is no CUDA device."""
    from pathlib import Path
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "grove_tpu_torch.profile_towers"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "needs an NVIDIA GPU" in out.stderr
