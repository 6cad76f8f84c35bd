"""The port's tools and box visualizer against the JAX package's, on the CPU.

* `tools.merge_lora`: on a tiny fp32 model with LoRA (the JAX tree's zero
  leaves refilled), the merged weights equal the JAX function's on the
  same LoRA values (1e-6), from the model and from a state dict, and the
  merged model's `lm_forward` equals the unmerged one with its adapters
  (2e-3, the parity tolerance); int4 and fused projections raise.
* `tools.embed_tokens`: the same `.npz` as the JAX CLI from one `.bin`
  written by `to_torch_state_dict`; without `--version`, the table of
  `init_grove_params` for the seed.
* `tools.preprocess_annotations`, `tools.build_index`: the same files as
  the JAX CLIs, their `main` the originals' source.
* `utils.visualize`: `draw_boxes` pixel-equal to the JAX function's PIL
  drawing without labels, `render_grounded_clip` the same array, and its
  GIF read back by PIL frame for frame.
"""

import dataclasses
import inspect
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.config import GroveConfig  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.tools import build_index as jbuild  # noqa: E402
from grove_tpu.tools import embed_tokens as jembed  # noqa: E402
from grove_tpu.tools import merge_lora as jmerge  # noqa: E402
from grove_tpu.tools import preprocess_annotations as jprep  # noqa: E402
from grove_tpu.utils import visualize as jvis  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    jax_lora_state_dict, load_reference_state_dict)
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from grove_tpu_torch.tools import build_index as tbuild  # noqa: E402
from grove_tpu_torch.tools import embed_tokens as tembed  # noqa: E402
from grove_tpu_torch.tools import merge_lora as tmerge  # noqa: E402
from grove_tpu_torch.tools import preprocess_annotations as tprep  # noqa
from grove_tpu_torch.utils import visualize as tvis  # noqa: E402

from test_torch_parity import _close, _perturb_zeros, port_config  # noqa

LORA_R = 4
WEIGHT_TOL = 1e-6


# ---------------------------------------------------------------------------
# merge_lora
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lora():
    base = GroveConfig.tiny()
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, lora_r=LORA_R))
    _, variables = init_grove_params(cfg, jax.random.PRNGKey(3),
                                     dtype=jnp.float32)
    params = jax.tree.map(np.asarray, _perturb_zeros(
        variables["params"], np.random.default_rng(3)))
    sd = {**to_torch_state_dict(params, cfg), **jax_lora_state_dict(params)}
    merged = to_torch_state_dict(jmerge.merge_lora_params(
        params, cfg.llama.lora_alpha, LORA_R), cfg)
    return cfg, sd, merged


def _lora_port(cfg, sd):
    model = GroveModel(port_config(cfg), device="cpu", dtype=torch.float32)
    load_reference_state_dict(model, sd)
    return model.eval()


def _adapted_keys(cfg):
    return [f"model.layers.{i}.self_attn.{p}_proj.weight"
            for i in range(cfg.llama.num_layers) for p in ("q", "v")]


def test_merge_lora_model_matches_jax(lora):
    cfg, sd, want = lora
    model = _lora_port(cfg, sd)
    rng = np.random.default_rng(4)
    nv = cfg.num_video_tokens
    ids = torch.from_numpy(rng.integers(3, 100, size=(2, nv + 9)))
    feats = torch.from_numpy(rng.normal(
        size=(2, nv, cfg.llama.hidden_size)).astype(np.float32))
    with torch.inference_mode():
        before = model.lm_forward(ids, feats, [2, 2])
    assert tmerge.merge_lora_params(model) is model
    assert not any("_lora" in n for n, _ in model.named_parameters())
    assert model.cfg.llama.lora_r == 0
    assert model.model.layers[0].self_attn.cfg.lora_r == 0
    got = model.state_dict()
    assert set(got) == set(want)
    for key in _adapted_keys(cfg):
        assert not np.allclose(sd[key], want[key])    # the delta is there
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=WEIGHT_TOL, err_msg=key)
    with torch.inference_mode():
        after = model.lm_forward(ids, feats, [2, 2])
    for a, b in zip(after, before):
        _close(a, b)


def test_merge_lora_state_dict_matches_jax(lora):
    cfg, sd, want = lora
    got = tmerge.merge_lora_params(sd, cfg.llama.lora_alpha, LORA_R)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]), want[key], rtol=0,
                                   atol=WEIGHT_TOL, err_msg=key)
    with pytest.raises(ValueError, match="alpha and r"):
        tmerge.merge_lora_params(sd)


@pytest.mark.parametrize("form", ["int4", "fused", "state_dict"])
def test_merge_lora_refuses_quantized_and_fused(lora, form):
    cfg, sd, _ = lora
    if form == "state_dict":
        sd = dict(sd)
        del sd["model.layers.0.self_attn.q_proj.weight"]
        with pytest.raises(ValueError, match="no float base weight"):
            tmerge.merge_lora_params(sd, 16.0, LORA_R)
        return
    model = _lora_port(cfg, sd)
    if form == "int4":
        from grove_tpu_torch.ops.quant import quantize_llama_
        quantize_llama_(model, 4)
    else:
        from grove_tpu_torch.models.fuse import fuse_llama_
        fuse_llama_(model)
    with pytest.raises(ValueError, match="float nn.Linear only"):
        tmerge.merge_lora_params(model)


def test_peft_normalizer_is_reexported():
    from grove_tpu_torch.checkpoint import peft
    assert tmerge.normalize_peft_state_dict is peft.normalize_peft_state_dict


# ---------------------------------------------------------------------------
# embed_tokens, preprocess_annotations, build_index
# ---------------------------------------------------------------------------

def test_embed_tokens_cli_matches_jax(tmp_path):
    cfg = GroveConfig.tiny()
    _, variables = init_grove_params(cfg, jax.random.PRNGKey(7),
                                     dtype=jnp.float32)
    sd = to_torch_state_dict(variables["params"], cfg)
    path = tmp_path / "ckpt.bin"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)
    jout, tout = tmp_path / "jax.npz", tmp_path / "port.npz"
    jembed.main(["--version", str(path), "--output", str(jout)])
    tembed.main(["--version", str(path), "--output", str(tout), "--device",
                 "cpu"])
    want = np.load(jout)["token_embeddings"]
    got = np.load(tout)["token_embeddings"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sd["model.embed_tokens.weight"])


def test_embed_tokens_random_table_is_the_models(tmp_path):
    from grove_tpu_torch.config import GroveConfig as TConfig
    from grove_tpu_torch.models.grove import init_grove_params as tinit
    model = tinit(TConfig.tiny(), device="cpu", dtype=torch.float32, seed=9)
    out = tmp_path / "t.npz"
    got = tembed.main(["--seed", "9", "--output", str(out), "--device",
                       "cpu"])
    np.testing.assert_array_equal(
        got, model.model.embed_tokens.weight.detach().numpy())
    np.testing.assert_array_equal(np.load(out)["token_embeddings"], got)
    # a table of another width is refused, not dropped
    path = tmp_path / "other.bin"
    torch.save({"model.embed_tokens.weight": torch.zeros(3, 5)}, path)
    with pytest.raises(ValueError, match="embed_tokens"):
        tembed.main(["--version", str(path), "--device", "cpu"])


@pytest.mark.parametrize("jmod,tmod", [(jprep, tprep), (jbuild, tbuild)],
                         ids=["preprocess_annotations", "build_index"])
def test_cli_copies_equal_originals(jmod, tmod):
    assert inspect.getsource(tmod.main) == inspect.getsource(jmod.main)


def test_preprocess_annotations_matches_jax(tmp_path):
    anns = {f"vid{i}": {"caption": f"a cat {i}", "boxes": np.arange(i + 1)}
            for i in range(4)}
    src = tmp_path / "all.pkl"
    with open(src, "wb") as f:
        pickle.dump(anns, f)
    for mod, out in ((jprep, "jax"), (tprep, "port")):
        mod.main(["--input", str(src), "--output_dir", str(tmp_path / out)])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == [f"vid{i}.pkl" for i in range(4)]
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def test_build_index_matches_jax(tmp_path):
    ann = tmp_path / "ann"
    ann.mkdir()
    for name in ("b.pkl", "a.pkl", "c.txt", "d.pkl"):
        (ann / name).write_bytes(b"x")
    for mod, out in ((jbuild, "jax.txt"), (tbuild, "port.txt")):
        mod.main(["--ann_dir", str(ann), "--output", str(tmp_path / out)])
    got = (tmp_path / "port.txt").read_text()
    assert got == (tmp_path / "jax.txt").read_text()
    assert got.split() == ["#count=3", "a", "b", "d"]


# ---------------------------------------------------------------------------
# the visualizer
# ---------------------------------------------------------------------------

def _boxes(rng, k, h, w):
    """Boxes inside, straddling and beyond the frame, tiny and wide."""
    lo = rng.uniform([-8, -8], [w + 4, h + 4], size=(k, 2))
    hi = lo + rng.uniform(0, [w / 2, h / 2], size=(k, 2))
    return np.concatenate([lo, hi], 1).astype(np.float32)


@pytest.mark.parametrize("width", [1, 2, 3, 6])
def test_draw_boxes_pixel_equal_to_pil(width):
    rng = np.random.default_rng(width)
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(6, 48, size=2))
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        boxes = _boxes(rng, int(rng.integers(1, 10)), h, w)
        want = jvis.draw_boxes(frame, boxes, None, width)
        got = tvis.draw_boxes(frame, boxes, None, width)
        assert got.dtype == np.uint8 and got.shape == frame.shape
        np.testing.assert_array_equal(got, want)


def test_draw_boxes_inverted_box_raises_like_pil():
    frame = np.zeros((8, 8, 3), np.uint8)
    for box in ([5.0, 1.0, 2.0, 4.0], [1.0, 5.0, 4.0, 2.0]):
        for fn in (jvis.draw_boxes, tvis.draw_boxes):
            with pytest.raises(ValueError, match="must be greater"):
                fn(frame, np.array([box]))


def test_draw_boxes_labels_in_the_bitmap_font():
    """Labels are drawn in the box's colour below its top-left corner (the
    port's 3 x 5 font; the JAX function uses PIL's default font)."""
    frame = np.zeros((40, 60, 3), np.uint8)
    box = np.array([[4.0, 4.0, 50.0, 30.0]], np.float32)
    plain = tvis.draw_boxes(frame, box)
    got = tvis.draw_boxes(frame, box, ["cat 1?"])
    text = np.any(got != plain, axis=-1)
    ys, xs = np.nonzero(text)
    assert ys.min() >= 6 and ys.max() < 11 and xs.min() >= 6
    assert xs.max() < 6 + 4 * 6
    assert np.all(got[text] == tvis._COLORS[0])


def _result(rng, t, h, w, labels):
    idx = [0, 2, 3, t + 1]                     # the last is past the clip
    return {"frame_indices": idx,
            "bboxes": [_boxes(rng, 2, h, w) for _ in idx],
            "labels_per_frame": [(["a", "b"] if labels else [])
                                 for _ in idx]}


def test_render_grounded_clip_matches_jax_and_gif_reads_back(tmp_path):
    rng = np.random.default_rng(11)
    t, h, w = 5, 30, 44
    palette = rng.integers(0, 256, (6, 3), dtype=np.uint8)
    frames = palette[rng.integers(0, 6, (t, h, w))]
    frames[3] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    result = _result(rng, t, h, w, labels=False)
    want = jvis.render_grounded_clip(frames, result)
    path = tmp_path / "clip.gif"
    got = tvis.render_grounded_clip(frames, result, out_path=str(path))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, h, w, 3)
    im = Image.open(path)
    assert im.n_frames == 3
    assert im.info["duration"] == 200 and im.info["loop"] == 0
    for i in range(3):
        im.seek(i)
        back = np.asarray(im.convert("RGB"))
        pal, idx = tvis.gif_palette(got[i])
        np.testing.assert_array_equal(back, pal[idx].reshape(h, w, 3))
        if i < 2:                       # few colours: the frame exactly
            np.testing.assert_array_equal(back, got[i])
    # no frame in range: the frames come back as they are
    none = {"frame_indices": [t], "bboxes": [np.zeros((1, 4))],
            "labels_per_frame": [[]]}
    np.testing.assert_array_equal(tvis.render_grounded_clip(frames, none),
                                  frames)
