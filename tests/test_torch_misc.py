"""grove_tpu_torch: copied host code, import hygiene, small ops against the
JAX package, and the parts of the slice that raise until they are ported."""

import ast
import dataclasses
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grove_tpu import config as jconfig  # noqa: E402
from grove_tpu_torch import config as tconfig  # noqa: E402
from grove_tpu_torch.config import GroveConfig  # noqa: E402
from grove_tpu_torch.models import layers as tlayers  # noqa: E402
from grove_tpu_torch.models import llama as tllama  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIG_CLASSES = ("ClipVisionConfig", "SamEncoderConfig", "SamDecoderConfig",
                  "LlamaConfig", "SpecialTokenIds", "GroveConfig")


@pytest.mark.parametrize("n,seg", [(24, 8), (8, 8), (29, 8), (6, 2),
                                   (3, 8)])
def test_sampling_copies_equal_originals(n, seg):
    from grove_tpu.data import sampling as jsamp
    from grove_tpu_torch.data import sampling as tsamp
    want = jsamp.sliding_segment_with_mask(n, seg)
    assert tsamp.sliding_segment_with_mask(n, seg) == want
    assert (tsamp.center_window_index(want[1])
            == jsamp.center_window_index(want[1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_collate_copy_equals_original(seed):
    """The port's `data/collate.py` gives the JAX package's conversations
    and batches: the same random question per seed, a caption whose last
    phrase falls past the text budget, and a sample without one."""
    from grove_tpu.data import collate as jcol
    from grove_tpu.text.mock_tokenizer import MockTokenizer as JTok
    from grove_tpu_torch.data import collate as tcol
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer as TTok
    rng = np.random.default_rng(seed)
    jcfg, tcfg = jconfig.GroveConfig.tiny(), tconfig.GroveConfig.tiny()
    t, p = jcfg.num_frames, jcfg.max_phrases
    caption = "a man slices bread " * 50 + "on a board"
    samples = [{"frames_clip": rng.integers(0, 256, (t, 4, 4, 3)),
                "frames_sam": rng.integers(0, 256, (t, 4, 4, 3)),
                "caption": caption,
                "tokens_positive": [(0, 5), (13, 18), (len(caption) - 7,
                                                       len(caption))],
                "gt_boxes": rng.uniform(size=(t, p, 4)),
                "gt_objectness": np.ones((t, p), np.float32)},
               {"frames_clip": np.zeros((t, 4, 4, 3)),
                "frames_sam": np.zeros((t, 4, 4, 3)), "caption": "nothing",
                "tokens_positive": [], "gt_boxes": np.zeros((t, p, 4)),
                "gt_objectness": np.zeros((t, p), np.float32)}]
    assert (tcol.conversation_for_sample(samples[0],
                                         np.random.default_rng(seed))
            == jcol.conversation_for_sample(samples[0],
                                            np.random.default_rng(seed)))
    want, wmeta = jcol.build_batch(samples, JTok(), jcfg,
                                   np.random.default_rng(seed))
    got, gmeta = tcol.build_batch(samples, TTok(), tcfg,
                                  np.random.default_rng(seed))
    assert set(got) == set(want) and gmeta == wmeta
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert want["phrase_mask"][0].sum() == 2


def test_normalization_constants_equal_originals():
    """The towers' pixel statistics and the BT.601 YUV matrices."""
    from grove_tpu.data import preprocess as jpre
    from grove_tpu_torch.data import preprocess as tpre
    for name in ("CLIP_MEAN", "CLIP_STD", "SAM_MEAN", "SAM_STD",
                 "YUV_OFFSET", "RGB_TO_YUV", "YUV_TO_RGB"):
        np.testing.assert_array_equal(getattr(tpre, name),
                                      getattr(jpre, name))


def test_synthetic_video_copy_equals_original():
    """The port's copy of `SyntheticVideo` gives the original's frames, RGB
    and YUV420."""
    from grove_tpu.data import video as jvideo
    from grove_tpu_torch.data import video as tvideo
    kw = dict(num_frames=7, width=40, height=30, fps=5.0, seed=3)
    got, want = tvideo.SyntheticVideo(**kw), jvideo.SyntheticVideo(**kw)
    ts = [0.0, 0.3, 1.1, 9.0]
    np.testing.assert_array_equal(got.decode_at(ts), want.decode_at(ts))
    np.testing.assert_array_equal(got.decode_at_yuv(ts),
                                  want.decode_at_yuv(ts))
    np.testing.assert_array_equal(got.decode_fps(2.5), want.decode_fps(2.5))
    with got as same:
        assert same is got


def test_import_leaves_jax_and_pil_out():
    """Importing every module of the port loads no jax, flax or PIL, no
    module of the JAX package `grove_tpu`, and neither `msgpack`, `orbax`
    nor `tensorstore` (the card's machine has none: the flax reader and
    the Orbax writer are the port's own, and tensorstore is imported
    inside the Orbax read of a layout numpy does not read)."""
    mods = sorted("grove_tpu_torch." + ".".join(
        p.relative_to(ROOT / "grove_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "grove_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys, grove_tpu_torch, " + ", ".join(mods) + "; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'PIL', 'flax', 'grove_tpu', 'msgpack', 'orbax', "
            "'tensorstore')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=ROOT)
    assert "grove_tpu_torch.models.fuse" in mods
    assert {"grove_tpu_torch.checkpoint.torch_convert",
            "grove_tpu_torch.checkpoint.flax_msgpack",
            "grove_tpu_torch.checkpoint.orbax_read",
            "grove_tpu_torch.checkpoint.orbax_write"} <= set(mods)
    assert {"grove_tpu_torch.train.step", "grove_tpu_torch.train.lowmem",
            "grove_tpu_torch.ops.boxes",
            "grove_tpu_torch.ops.losses",
            "grove_tpu_torch.ops.sam_attention_bwd",
            "grove_tpu_torch.ops.window_ops",
            "grove_tpu_torch.data.collate", "grove_tpu_torch.data.video",
            "grove_tpu_torch.data.preprocess",
            "grove_tpu_torch.api.processor", "grove_tpu_torch.infer.beam",
            "grove_tpu_torch.serve.server",
            "grove_tpu_torch.serve.continuous",
            "grove_tpu_torch.serve.__main__",
            "grove_tpu_torch.infer.drivers",
            "grove_tpu_torch.tools.run_experiment",
            "grove_tpu_torch.tools.merge_lora",
            "grove_tpu_torch.tools.embed_tokens",
            "grove_tpu_torch.tools.preprocess_annotations",
            "grove_tpu_torch.tools.build_index",
            "grove_tpu_torch.utils.visualize",
            "grove_tpu_torch.ops.roi_align",
            "grove_tpu_torch.parallel.mesh",
            "grove_tpu_torch.parallel.sharding",
            "grove_tpu_torch.parallel.pipeline",
            "grove_tpu_torch.parallel.launch",
            "grove_tpu_torch.parallel.workers",
            "grove_tpu_torch.parallel.dryrun",
            "grove_tpu_torch.tools.multihost_demo"} <= set(mods)
    assert {f"grove_tpu_torch.evals.{m}" for m in (
        "anet", "captions", "iground", "lemma", "meteor", "pointing", "ptb",
        "run_all", "run_iground", "spice", "textsim", "vidstg")} <= set(mods)
    assert out.stdout.strip() == "[]"


def test_chip_smoke_up_to_its_exit_leaves_jax_package_out():
    """chip_smoke.py run where there is no card, up to its exit, has loaded
    no module of jax, flax, PIL or the JAX package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code = ("import runpy, sys\n"
            "sys.argv = ['chip_smoke.py']\n"
            "try:\n"
            "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    code = e.code\n"
            "print('EXIT', code, sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'PIL', 'flax', 'grove_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "EXIT 1 []"


def _imports(path: Path):
    """Every module name an import statement of `path` names."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", ["chip_smoke.py", "grove_tpu_torch"])
def test_port_imports_nothing_of_the_jax_package(where):
    """No import statement of chip_smoke.py or of the port names
    `grove_tpu` or one of its submodules."""
    path = ROOT / where
    files = [path] if path.is_file() else sorted(path.rglob("*.py"))
    found = [(f.name, m) for f in files for m in _imports(f)
             if m.split(".")[0] in ("grove_tpu", "jax", "flax", "PIL")]
    assert files and not found


def test_from_pretrained_defaults_to_the_card():
    """The entry point builds on the card unless the caller asks for the
    CPU (the tests always pass device="cpu")."""
    from grove_tpu_torch.api import GroveForCausalLM
    sig = inspect.signature(GroveForCausalLM.from_pretrained)
    assert sig.parameters["device"].default == "cuda"


def test_parallel_entry_points_default_to_the_card():
    """The parallel entry points run on the card unless the caller asks
    for the CPU: `init_distributed`, the multi-host demo's workers, the
    pipe mesh (one card a stage), and no CPU fallback without a card."""
    from grove_tpu_torch.parallel import mesh, pipeline
    from grove_tpu_torch.tools import multihost_demo
    sig = inspect.signature(mesh.init_distributed)
    assert sig.parameters["device"].default == "cuda"
    src = inspect.getsource(multihost_demo.main)
    assert 'p.add_argument("--device", default="cuda"' in src
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.init_distributed()
        with pytest.raises(ValueError, match="CUDA devices"):
            pipeline.make_pipe_mesh(2)


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_copies_equal_originals(name):
    """Every config class of the port's copy holds the JAX package's
    fields and values at its defaults and at `tiny()` / `small()` where it
    has them, and the JSON helpers round-trip the same dicts."""
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    for ctor in ("__call__", "tiny", "small"):
        if not hasattr(jcls, ctor):
            assert not hasattr(tcls, ctor)
            continue
        make = (lambda c: c()) if ctor == "__call__" else (
            lambda c: getattr(c, ctor)())
        assert dataclasses.asdict(make(tcls)) == dataclasses.asdict(
            make(jcls)), ctor
    if name == "GroveConfig":
        small = jcls.small()
        assert tcls.from_dict(small.to_dict()).to_dict() == small.to_dict()
        assert tcls.small().llama.head_dim == small.llama.head_dim
        assert tcls.tiny().num_video_tokens == jcls.tiny().num_video_tokens


def test_text_copies_equal_originals():
    """The port's copies of the prompt, packing and tagging host code give
    the JAX package's results on sample inputs."""
    from grove_tpu.text import constants as jconst
    from grove_tpu.text import conversation as jconv
    from grove_tpu.text import packing as jpack
    from grove_tpu.text import prompts as jprompts
    from grove_tpu.text import tagging as jtag
    from grove_tpu.text.mock_tokenizer import MockTokenizer as JTok
    from grove_tpu_torch.text import constants as tconst
    from grove_tpu_torch.text import conversation as tconv
    from grove_tpu_torch.text import packing as tpack
    from grove_tpu_torch.text import prompts as tprompts
    from grove_tpu_torch.text import tagging as ttag
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer as TTok
    assert {k: v for k, v in vars(tconst).items() if k.isupper()} == \
        {k: v for k, v in vars(jconst).items() if k.isupper()}
    jt, tt = JTok(), TTok()
    text = "a <p> man </p> [DET] slices <p> bread </p> [DET] ."
    assert tt(text).input_ids == jt(text).input_ids
    assert tt.decode(jt(text).input_ids) == jt.decode(jt(text).input_ids)
    assert tt.token_id("[DET]") == jt.token_id("[DET]")
    assert tconv.build_prompt("hi", "there") == jconv.build_prompt("hi",
                                                                    "there")
    for q in (None, "What happens?"):
        prompt = tprompts.grounding_prompt(q, answer=text)
        assert prompt == jprompts.grounding_prompt(q, answer=text)
        ids = tprompts.tokenize_with_video(prompt, tt)
        assert ids == jprompts.tokenize_with_video(prompt, jt)
    kw = dict(num_video_tokens=6, max_spliced_len=128,
              det_token_id=jt.token_id("[DET]"), max_phrases=4,
              pad_id=jt.pad_token_id)
    jp = jpack.pack_text(ids, prompt, jt, **kw)
    tp = tpack.pack_text(ids, prompt, tt, **kw)
    for field in dataclasses.fields(jp):
        np.testing.assert_array_equal(getattr(tp, field.name),
                                      getattr(jp, field.name))
    np.testing.assert_array_equal(
        tpack.det_gather_positions(jp.input_ids, kw["det_token_id"], 4),
        jpack.det_gather_positions(jp.input_ids, kw["det_token_id"], 4))
    for out in (text, "<p> a dog [DET] runs", "no tags at all", ""):
        assert ttag.parse_generation(out) == jtag.parse_generation(out)
        assert ttag.strip_tags(out) == jtag.strip_tags(out)
    assert ttag.tag_caption("a man cuts bread", [(2, 5), (11, 16)]) == \
        jtag.tag_caption("a man cuts bread", [(2, 5), (11, 16)])


@pytest.mark.parametrize("name", ["tokenizer.py", "sentencepiece.py"])
def test_tokenizer_copies_equal_originals(name):
    """The port's tokenizer loaders are the JAX package's files byte for
    byte: their imports are relative (`..config`, `.constants`,
    `.sentencepiece`) and resolve inside the port."""
    assert ((ROOT / "grove_tpu_torch" / "text" / name).read_bytes()
            == (ROOT / "grove_tpu" / "text" / name).read_bytes())


def test_tokenizer_copies_give_the_originals_ids():
    """The copied SentencePiece reader, writer and HF-protocol wrapper give
    the original's model, ids and special-token ids."""
    from grove_tpu.text import sentencepiece as jsp
    from grove_tpu.text.tokenizer import special_token_ids_from as jids
    from grove_tpu_torch.text import sentencepiece as tsp
    from grove_tpu_torch.text.constants import GROVE_EXTRA_TOKENS
    from grove_tpu_torch.text.tokenizer import special_token_ids_from as tids
    pieces = ([("<unk>", 0.0, tsp.UNKNOWN), ("<s>", 0.0, tsp.CONTROL),
               ("</s>", 0.0, tsp.CONTROL)]
              + [(f"<0x{b:02X}>", 0.0, tsp.BYTE) for b in range(256)]
              + [("▁the", -1.0, tsp.NORMAL), ("▁cat", -2.0, tsp.NORMAL),
                 ("▁ca", -3.5, tsp.NORMAL), ("t", -5.0, tsp.NORMAL)])
    data = tsp.serialize_model(tsp.SpModel(pieces, model_type=tsp.UNIGRAM,
                                           byte_fallback=True))
    assert data == jsp.serialize_model(jsp.SpModel(
        pieces, model_type=jsp.UNIGRAM, byte_fallback=True))
    toks = [m.SentencePieceTokenizer(m.parse_model(data)) for m in (tsp, jsp)]
    for tok in toks:
        tok.add_tokens(list(GROVE_EXTRA_TOKENS), special_tokens=True)
    text = "<vid_start>the cat [DET] caté<vid_end>"
    assert toks[0](text).input_ids == toks[1](text).input_ids
    assert dataclasses.asdict(tids(toks[0])) == dataclasses.asdict(
        jids(toks[1]))


def test_peft_copy_equals_original():
    """`checkpoint.peft.normalize_peft_state_dict` is the JAX tool's
    function, source and results: prefixes stripped, a LoRA pair merged
    into its `.base_layer.` base as W + B A alpha / r, and unmerged when
    asked."""
    from grove_tpu.tools import merge_lora
    from grove_tpu_torch.checkpoint import peft
    assert (inspect.getsource(peft.normalize_peft_state_dict)
            == inspect.getsource(merge_lora.normalize_peft_state_dict))
    rng = np.random.default_rng(0)
    sd = {"base_model.model.a.q_proj.base_layer.weight": rng.normal(
              size=(6, 4)),
          "base_model.model.a.q_proj.lora_A.default.weight": rng.normal(
              size=(8, 4)),
          "base_model.model.a.q_proj.lora_B.default.weight": rng.normal(
              size=(6, 8)),
          "base_model.model.b.default.bias": rng.normal(size=3)}
    for kw in ({}, {"merge": False}, {"alpha": 32.0, "r": 4}):
        got = peft.normalize_peft_state_dict(sd, **kw)
        want = merge_lora.normalize_peft_state_dict(sd, **kw)
        assert set(got) == set(want) == {"a.q_proj.weight", "b.bias"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


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


# the training data pipeline's copies (the datasets' parsers, the index,
# sparse sampling, the loader's sharding and prefetch, the meters), held to
# their originals' source; their results are held equal in
# tests/test_torch_data.py and tests/test_torch_driver.py
TRAIN_DATA_COPIES = [
    ("data.sampling", "sparse_sample"),
    ("data.index", "build_manifest"), ("data.index", "read_manifest"),
    ("data.index", "ShardedKeyIndex"),
    ("data.datasets.base", "ClipAnnotation"),
    ("data.datasets.base", "phrase_spans_from_tagged"),
    ("data.datasets.base", "sort_phrases_by_span"),
    ("data.datasets.base", "GroundingVideoDataset"),
    ("data.datasets.howto100m", "parse_howto_annotation"),
    ("data.datasets.howto100m", "HowTo100MDataset"),
    ("data.datasets.vidstg", "parse_vidstg_video"),
    ("data.datasets.vidstg", "VidSTGDataset"),
    ("data.datasets.anet_entities", "find_first_occurrences"),
    ("data.datasets.anet_entities", "compute_midpoint_timestamps"),
    ("data.datasets.anet_entities", "ActivityNetEntitiesDataset.__init__"),
    ("data.datasets.anet_entities",
     "ActivityNetEntitiesDataset.parse_segment"),
    ("data.datasets.anet_entities",
     "ActivityNetEntitiesDataset.sample_timestamps"),
    ("data.datasets.anet_entities",
     "ActivityNetEntitiesDataset.decode_frames"),
    ("data.loader", "GroundingLoader._indices"),
    ("data.loader", "GroundingLoader.__iter__"),
    ("utils.meters", "ProgressMeter"), ("utils.meters", "Timer"),
    ("utils.meters", "AverageMeter.update"),
    # the makers write `.npy` clips where the originals write `.gif`
    ("data.synthetic", "make_synthetic_howto_dataset"),
    ("data.synthetic", "make_synthetic_vidstg"),
    ("data.synthetic", "make_synthetic_pointing"),
    ("data.synthetic", "make_synthetic_anet"),
]


@pytest.mark.parametrize("module,name", TRAIN_DATA_COPIES)
def test_train_data_copies_equal_originals(module, name):
    import functools
    import importlib
    got, want = (inspect.getsource(functools.reduce(
        getattr, name.split("."), importlib.import_module(f"{pkg}.{module}")))
        for pkg in ("grove_tpu_torch", "grove_tpu"))
    if module == "data.synthetic":     # (and a line broken differently)
        got, want = (" ".join(src.split()) for src in (
            got, want.replace('.gif"', '{CLIP_EXT}"')))
    assert got == want


def test_synthetic_constants_equal_originals():
    from grove_tpu.data import synthetic as jsyn
    from grove_tpu_torch.data import synthetic as tsyn
    assert (tsyn._OBJECTS, tsyn._VERBS) == (jsyn._OBJECTS, jsyn._VERBS)


def test_skip_patterns_copy_equals_original():
    from grove_tpu.checkpoint import torch_convert
    from grove_tpu_torch.checkpoint import convert
    assert convert.SKIP_PATTERNS == torch_convert.SKIP_PATTERNS


# grove_tpu_torch/checkpoint/torch_convert.py: the functions copied as their
# text; `resize_abs_pos` and `resize_rel_pos` resize with the port's
# `_resize_axes` where the original calls `jax.image.resize`, and
# `merge_into` copies the nested dicts itself where the original maps with
# `jax.tree.map` and unfreezes with flax (held to the originals' results
# below); the original's `cast_params` (a `jax.tree.map`) has no copy
TORCH_CONVERT_COPIES = ("_t", "_conv2d", "_conv3d", "_convT2d", "_ident",
                        "_rules", "convert_state_dict", "_flatten",
                        "_inv_linear", "_inv_conv2d", "_inv_conv3d",
                        "to_torch_state_dict")


@pytest.mark.parametrize("name", TORCH_CONVERT_COPIES)
def test_torch_convert_copies_equal_originals(name):
    from grove_tpu.checkpoint import torch_convert as original
    from grove_tpu_torch.checkpoint import torch_convert as copy
    assert (inspect.getsource(getattr(copy, name))
            == inspect.getsource(getattr(original, name)))
    assert copy.SKIP_PATTERNS == original.SKIP_PATTERNS


def test_torch_convert_rewritten_functions_match_originals():
    """The three functions whose text differs give the originals' results:
    the resizes within 1e-5 of jax.image.resize's (up and down, and the
    no-op at the same size), `convert_state_dict` of a state dict on
    another SAM grid likewise, and `merge_into` the same tree, casts and
    reports."""
    from grove_tpu.checkpoint import torch_convert as original
    from grove_tpu_torch.checkpoint import torch_convert as copy
    rng = np.random.default_rng(4)
    for shape, grid in (((1, 8, 8, 6), 5), ((6, 6, 4), 9), ((4, 4, 3), 4)):
        pos = rng.normal(size=shape).astype(np.float32)
        want = original.resize_abs_pos(pos, grid)
        got = copy.resize_abs_pos(pos, grid)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for rows, target in ((27, 9), (7, 13), (9, 9)):
        rel = rng.normal(size=(rows, 5)).astype(np.float32)
        np.testing.assert_allclose(copy.resize_rel_pos(rel, target),
                                   original.resize_rel_pos(rel, target),
                                   rtol=1e-5, atol=1e-5)
    jcfg = jconfig.GroveConfig.tiny()
    g = jcfg.sam_enc.grid
    sd = {"model.grounding_encoder.image_encoder.pos_embed":
          rng.normal(size=(1, 2 * g, 2 * g, 32)).astype(np.float32),
          "model.grounding_encoder.image_encoder.blocks.0.attn.rel_pos_h":
          rng.normal(size=(31, 8)).astype(np.float32),
          "model.layers.0.mlp.up_proj.weight":
          rng.normal(size=(64, 32)).astype(np.float32),
          "model.norm.weight": np.ones(32, np.float32), "unknown.key":
          np.zeros(2, np.float32),
          "model.vision_tower.vision_tower.vision_model.post_layernorm."
          "weight": np.ones(4, np.float32)}
    got, got_report = copy.convert_state_dict(sd, tconfig.GroveConfig.tiny())
    want, want_report = original.convert_state_dict(sd, jcfg)
    assert got_report == want_report
    got, want = dict(copy._flatten(got)), dict(original._flatten(want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    template = {"a": {"w": np.zeros((2, 3), np.float32),
                      "b": np.zeros(3, np.int32)}, "c": np.ones(4)}
    converted = {"a": {"w": np.arange(6.0).reshape(2, 3), "b": np.ones(3),
                       "x": np.ones(1)}, "c": np.ones(5), "d": {"e": 1}}
    got = copy.merge_into(template, converted)
    want = original.merge_into(template, converted)
    assert got[1:] == want[1:]
    for path, w in original._flatten(want[0]).items():
        v = copy._flatten(got[0])[path]
        assert v.dtype == w.dtype and np.array_equal(v, w), path
    assert template["a"]["w"].sum() == 0          # the template is left


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


def _tiny_model():
    from grove_tpu_torch.models.grove import init_grove_params
    return init_grove_params(GroveConfig.tiny(), device="cpu",
                             dtype=torch.float32, seed=0)


def test_unported_paths_raise(tmp_path):
    model = _tiny_model()
    cfg = model.cfg
    with pytest.raises(ValueError, match="KV cache dtype"):
        tllama.init_kv_caches(cfg.llama, 1, 4, dtype=torch.int16,
                              device="cpu")
    # the training driver's multi-process flags run since item 16 was
    # ported (tests/test_torch_distributed_driver.py); outside torchrun's
    # environment their rendezvous raises instead of training alone
    from grove_tpu_torch.train import driver
    for argv in (["--multihost"], ["--mesh_model", "2"]):
        with pytest.raises(ValueError, match="env://"):
            driver.main(["--device", "cpu", "--synthetic"] + argv)
    # a model directory the JAX package's save_pretrained writes loads
    # (held in full by tests/test_torch_jax_dirs.py); an empty model file
    # raises, naming it
    from grove_tpu.api.model import GroveForCausalLM as JaxLM
    from grove_tpu.checkpoint.torch_convert import to_torch_state_dict
    from grove_tpu_torch.api import GroveForCausalLM
    jlm = JaxLM.from_pretrained(None, "tiny", dtype=jnp.float32)
    jlm.save_pretrained(str(tmp_path))
    lm = GroveForCausalLM.from_pretrained(str(tmp_path), "tiny",
                                          dtype=torch.float32, device="cpu")
    want = to_torch_state_dict(jlm.variables["params"], jlm.cfg)
    got = lm.model.state_dict()
    assert set(got) == set(want)
    for k in ("lm_head.weight", "model.embed_tokens.weight",
              "model.layers.1.mlp.down_proj.weight"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    (tmp_path / "flax_model.msgpack").write_bytes(b"")
    with pytest.raises(ValueError, match="flax_model.msgpack: truncated"):
        GroveForCausalLM.from_pretrained(str(tmp_path), "tiny",
                                         device="cpu")
    (tmp_path / "flax_model.msgpack").unlink()
    with pytest.raises(FileNotFoundError, match="config.json without"):
        GroveForCausalLM.from_pretrained(str(tmp_path), "tiny",
                                         device="cpu")


def test_calibrate_requires_quantized_towers():
    """`calibrate` on a model whose towers are float, or whose LLM alone
    was quantized, raises and leaves the model as it was
    (`api/model.py:150-151` asserts the same)."""
    from grove_tpu_torch.api import GroveForCausalLM
    lm = GroveForCausalLM.from_pretrained(None, "tiny", dtype=torch.float32,
                                          seed=0, device="cpu")
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
