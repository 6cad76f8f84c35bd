"""The port's region encoder, RoIAlign and SAM mask path against the JAX
package, in fp32 on the CPU.

Inputs come from numpy seeds and go through both packages. `roi_align`
is held to 1e-5 absolute; the modules and model methods to rtol = atol =
2e-3, the parity tolerance of `tests/test_parity_reference.py`;
`splice_regions` exactly.

Weights: a JAX tree with its zero leaves refilled (`_perturb_zeros` of
`tests/test_torch_parity.py`), exported with `to_torch_state_dict` and
loaded strictly into the port. The mask path's two transposed
convolutions are the one exception: the JAX package loads the reference's
(in, out, kh, kw) weights into flax's `nn.ConvTranspose` with a plain
transpose, and flax does not flip the kernel as torch's ConvTranspose2d
does, so on one checkpoint the two packages compute different masks. The
port keeps torch's semantics (a reference checkpoint computes as the
reference does); to hold it to the JAX function the tests flip the 2x2
kernels in both spatial axes when they carry a JAX tree over
(`flip_conv_transpose`), and `test_jax_conv_transpose_is_flipped` pins
the difference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.config import GroveConfig  # noqa: E402
from grove_tpu.models import region as jregion  # noqa: E402
from grove_tpu.models.grove import GroveModel as JaxGrove  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.ops.roi_align import roi_align as jax_roi_align  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    load_reference_state_dict)
from grove_tpu_torch.models import region as tregion  # noqa: E402
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from grove_tpu_torch.ops.roi_align import roi_align  # noqa: E402

from test_torch_parity import (TOL, _close, _perturb_zeros,  # noqa: E402
                               port_config)

ROI_TOL = 1e-5
UPSCALING = tuple(f"model.grounding_encoder.mask_decoder.output_upscaling."
                  f"{i}.weight" for i in (0, 3))


def flip_conv_transpose(sd):
    """A state dict exported from a JAX tree, with the mask path's
    transposed-convolution kernels flipped in both spatial axes: the
    weights under which torch's ConvTranspose2d computes what the JAX
    package's `nn.ConvTranspose` computes on the unflipped ones."""
    out = dict(sd)
    for key in UPSCALING:
        out[key] = np.ascontiguousarray(np.asarray(sd[key])[:, :, ::-1, ::-1])
    return out


def _port(cfg, sd):
    model = GroveModel(port_config(cfg), device="cpu", dtype=torch.float32)
    load_reference_state_dict(model, sd)
    return model.eval()


@pytest.fixture(scope="module")
def models():
    """(cfg, JAX model, variables, the port with the flipped kernels, the
    port on the plain export)."""
    cfg = GroveConfig.tiny()
    jmodel, variables = init_grove_params(cfg, jax.random.PRNGKey(1),
                                          dtype=jnp.float32)
    params = _perturb_zeros(variables["params"], np.random.default_rng(1))
    sd = to_torch_state_dict(params, cfg)
    return (cfg, jmodel, {"params": params}, _port(cfg, flip_conv_transpose(
        sd)), _port(cfg, sd))


def _apply(jmodel, variables, fn, *args):
    return jmodel.apply(variables, *args, method=fn)


# ---------------------------------------------------------------------------
# RoIAlign and the resize
# ---------------------------------------------------------------------------

def _rois(h, w, scale):
    """RoIs in image coordinates (feature coordinates / scale) over a
    (3, h, w) batch, unsorted batch indices: inside the map, straddling
    its edge, partly outside the [-1, size] band, wholly outside it, tiny
    and inverted (x2 < x1)."""
    s = 1.0 / scale
    return np.array([
        [2, 1.0 * s, 2.0 * s, 7.5 * s, 6.0 * s],
        [0, -0.7 * s, 1.0 * s, 4.0 * s, 8.5 * s],
        [1, 6.0 * s, -2.5 * s, (w + 0.6) * s, 3.0 * s],
        [0, (w - 3.0) * s, (h - 2.0) * s, (w + 4.0) * s, (h + 3.0) * s],
        [2, (w + 2.0) * s, 1.0 * s, (w + 6.0) * s, 4.0 * s],
        [1, 3.3 * s, 3.3 * s, 3.4 * s, 3.45 * s],
        [0, 5.0 * s, 4.0 * s, 2.0 * s, 1.0 * s],
    ], np.float32)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("ratio", [1, 2])
def test_roi_align_matches_jax(aligned, ratio):
    rng = np.random.default_rng(0)
    b, h, w, c, scale = 3, 9, 11, 5, 0.5
    feat = rng.normal(size=(b, h, w, c)).astype(np.float32)
    rois = _rois(h, w, scale)
    want = np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(rois), 4,
                                    scale, ratio, aligned))
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 4,
                    scale, ratio, aligned)
    assert got.dtype == torch.float32 and got.shape == (len(rois), 4, 4, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROI_TOL)
    # the RoI wholly outside the band samples nothing
    assert not got[4].any()


def test_roi_align_bf16_map_gathers_as_fp32():
    """A bf16 map gives what its fp32 cast gives: the corners are gathered
    in the map's dtype, then cast."""
    rng = np.random.default_rng(1)
    feat = torch.from_numpy(rng.normal(size=(3, 9, 11, 5)).astype(
        np.float32)).bfloat16()
    rois = torch.from_numpy(_rois(9, 11, 0.5))
    got = roi_align(feat, rois, 4, 0.5)
    want = roi_align(feat.float(), rois, 4, 0.5)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("size", [(3, 3), (6, 6), (12, 12), (24, 24),
                                  (6, 10), (2, 2)])
def test_bilinear_resize_matches_jax(size):
    """x1, x2, x4, x8 (the pyramid), a non-square output and a downscale
    (the fuse's lower levels), align_corners=True."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 3, 4)).astype(np.float32)
    want = np.asarray(jregion._bilinear_resize(jnp.asarray(x), size))
    got = tregion._bilinear_resize(
        torch.from_numpy(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the region encoder
# ---------------------------------------------------------------------------

def _mlvl(rng, levels, b=2, g=3, c=32):
    return [rng.normal(size=(b, g * g, c)).astype(np.float32)
            for _ in range(levels)]


def _region_rois(rng, n, b):
    lo = rng.uniform(-0.1, 0.7, size=(n, 2))
    hi = lo + rng.uniform(0.05, 0.6, size=(n, 2))
    rois = np.concatenate([lo, hi], 1).astype(np.float32)
    return rois, rng.integers(0, b, size=n).astype(np.int64)


@pytest.mark.parametrize("levels", [1, 3, 4])
def test_query_module_matches_jax(levels):
    """`MLVLROIQueryModule` on carried-over weights: the pyramid, five
    fuse rounds over `levels` levels, RoIAlign per level and the query
    head (RoIs partly outside the image among them)."""
    rng = np.random.default_rng(10 + levels)
    c, out = 32, 48
    mlvl = _mlvl(rng, levels, c=c)
    rois, bidx = _region_rois(rng, 5, 2)
    jmod = jregion.MLVLROIQueryModule(embed_dims=c, out_dims=out,
                                      dtype=jnp.float32)
    args = ([jnp.asarray(f) for f in mlvl], jnp.asarray(rois),
            jnp.asarray(bidx, jnp.int32))
    params = jmod.init(jax.random.PRNGKey(levels), *args)["params"]
    params = _perturb_zeros(params, rng)
    want = jmod.apply({"params": params}, *args)
    prefix = "model.region_encoder."
    sd = {k[len(prefix):]: torch.from_numpy(np.array(v))
          for k, v in to_torch_state_dict({"region_encoder": params},
                                          GroveConfig.tiny()).items()}
    tmod = tregion.MLVLROIQueryModule(c, out, levels, dtype=torch.float32)
    tmod.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = tmod([torch.from_numpy(f) for f in mlvl],
                   torch.from_numpy(rois), torch.from_numpy(bidx))
    assert got.shape == (5, out)
    _close(got, want)


def test_norm_epsilons_are_flax_defaults():
    mod = tregion.MLVLROIQueryModule(32, 48, 4)
    eps = {type(m).__name__: m.eps for m in mod.modules()
           if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm))}
    assert eps == {"GroupNorm": 1e-6, "LayerNorm": 1e-6}


def test_encode_regions_matches(models):
    """`GroveModel.encode_regions` on the CLIP levels of `encode_video`."""
    cfg, jmodel, variables, tmodel, _ = models
    rng = np.random.default_rng(3)
    b = 2
    fc = rng.integers(0, 256, (b, cfg.num_frames, cfg.clip.image_size,
                               cfg.clip.image_size, 3), dtype=np.uint8)
    _, mlvl = _apply(jmodel, variables, JaxGrove.encode_video,
                     jnp.asarray(fc))
    rois, bidx = _region_rois(rng, 6, b * cfg.num_frames)
    want = _apply(jmodel, variables, JaxGrove.encode_regions,
                  mlvl, jnp.asarray(rois), jnp.asarray(bidx, jnp.int32))
    with torch.inference_mode():
        _, tmlvl = tmodel.encode_video(torch.from_numpy(fc))
        got = tmodel.encode_regions(tmlvl, torch.from_numpy(rois),
                                    torch.from_numpy(bidx))
    assert got.shape == (6, cfg.llama.hidden_size)
    _close(got, want)


@pytest.mark.parametrize("case", ["more_tokens_than_rows", "rows_without",
                                  "one_each"])
def test_splice_regions_matches(models, case):
    """Exact: the k-th `<bbox>` of each row takes row k, clamped to the
    last row when a prompt has more `<bbox>` tokens than rows; a row
    without `<bbox>` keeps its embeddings."""
    cfg, jmodel, variables, tmodel, _ = models
    rng = np.random.default_rng(4)
    bbox = cfg.tokens.bbox
    ids = rng.integers(3, 100, size=(3, 12)).astype(np.int64)
    if case == "more_tokens_than_rows":
        ids[0, [1, 4, 7, 9]] = bbox
        ids[1, [2, 3, 11]] = bbox
        r = 2
    elif case == "rows_without":
        ids[1, [5, 6]] = bbox
        r = 2
    else:
        ids[:, 6] = bbox
        r = 1
    d = cfg.llama.hidden_size
    embeds = rng.normal(size=(3, 12, d)).astype(np.float32)
    regions = rng.normal(size=(3, r, d)).astype(np.float32)
    want = np.asarray(_apply(jmodel, variables, JaxGrove.splice_regions,
                             jnp.asarray(embeds), jnp.asarray(ids, jnp.int32),
                             jnp.asarray(regions)))
    got = tmodel.splice_regions(torch.from_numpy(embeds),
                                torch.from_numpy(ids),
                                torch.from_numpy(regions)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "rows_without":
        np.testing.assert_array_equal(got[[0, 2]], embeds[[0, 2]])
    if case == "more_tokens_than_rows":
        np.testing.assert_array_equal(got[0, 9], regions[0, 1])


# ---------------------------------------------------------------------------
# the prompt encoder and the mask path
# ---------------------------------------------------------------------------

def _prompts(cfg, rng, n, kinds):
    """Seeded prompts of `kinds` for n instances, as numpy arrays."""
    size = cfg.sam_dec.input_image_size
    g = cfg.sam_dec.image_embedding_size
    out = {}
    if "text" in kinds:
        out["text_embeds"] = rng.normal(size=(n, 1, cfg.out_dim)).astype(
            np.float32)
    if "points" in kinds:
        out["points"] = rng.uniform(0, size, size=(n, 3, 2)).astype(
            np.float32)
        out["point_labels"] = np.array([[1, 0, -1], [0, 1, 1],
                                        [-1, 1, 0]][:n], np.int32)
    if "boxes" in kinds:
        lo = rng.uniform(0, size / 2, size=(n, 2))
        out["boxes"] = np.concatenate(
            [lo, lo + rng.uniform(1, size / 2, size=(n, 2))], 1).astype(
                np.float32)
    if "masks" in kinds:
        out["masks"] = rng.normal(size=(n, 4 * g, 4 * g, 1)).astype(
            np.float32)
    return out


MIXES = [("text",), ("points",), ("boxes",), ("points", "boxes"),
         ("points", "masks"), ("boxes", "masks"),
         ("text", "points", "boxes", "masks")]


def _prompt_encoder_jax(jmodel, variables, prompts):
    kw = {k: jnp.asarray(v) for k, v in prompts.items()}
    return jmodel.apply(variables, method=lambda m: m.prompt_encoder(**kw))


def _prompt_encoder_port(tmodel, prompts):
    pe = tmodel.model.grounding_encoder.prompt_encoder
    with torch.inference_mode():
        return tuple(t.detach() for t in pe(**{
            k: torch.from_numpy(v) for k, v in prompts.items()}))


@pytest.mark.parametrize("mix", MIXES, ids="+".join)
def test_prompt_encoder_matches(models, mix):
    """Every prompt mix: points padded with a not-a-point when no box
    follows, labels -1 / 0 / 1, box corners, the mask input's downscaling
    convs; the sparse and dense embeddings."""
    cfg, jmodel, variables, tmodel, _ = models
    prompts = _prompts(cfg, np.random.default_rng(5), 3, mix)
    ws, wd = _prompt_encoder_jax(jmodel, variables, prompts)
    gs, gd = _prompt_encoder_port(tmodel, prompts)
    k = (3 + ("boxes" not in mix)) * ("points" in mix) + 2 * (
        "boxes" in mix) + ("text" in mix)
    assert gs.shape == (3, k, cfg.sam_dec.embed_dim)
    _close(gs, ws)
    g = cfg.sam_dec.image_embedding_size
    assert gd.shape == ((3, g, g, cfg.sam_dec.embed_dim) if "masks" in mix
                        else (g, g, cfg.sam_dec.embed_dim))
    _close(gd, wd)


def test_prompt_encoder_needs_a_sparse_prompt(models):
    pe = models[3].model.grounding_encoder.prompt_encoder
    with pytest.raises(ValueError, match="text, points or boxes"):
        pe(masks=torch.zeros(1, 8, 8, 1))


def _embeddings(cfg, rng, n):
    g = cfg.sam_dec.image_embedding_size
    return rng.normal(size=(n, g * g, cfg.sam_dec.embed_dim)).astype(
        np.float32)


@pytest.mark.parametrize("multimask", [False, True])
@pytest.mark.parametrize("mix", [("text",), ("points", "boxes", "masks")],
                         ids="+".join)
def test_predict_masks_matches(models, multimask, mix):
    """`GroveBoxDecoder.predict_masks`: the masks (N, 1 or 3, 4g, 4g) and
    the IoU predictions, on the JAX prompt encoder's embeddings."""
    cfg, jmodel, variables, tmodel, _ = models
    rng = np.random.default_rng(6)
    n = 3
    emb = _embeddings(cfg, rng, n)
    sparse, dense = _prompt_encoder_jax(jmodel, variables,
                                        _prompts(cfg, rng, n, mix))
    want = jmodel.apply(variables, method=lambda m: m.box_decoder.
                        predict_masks(jnp.asarray(emb), m.dense_pe(), sparse,
                                      dense, jnp.arange(n),
                                      multimask_output=multimask))
    dec = tmodel.model.grounding_encoder.mask_decoder
    with torch.inference_mode():
        got = dec.predict_masks(torch.from_numpy(emb), tmodel.dense_pe(),
                                torch.from_numpy(np.asarray(sparse)),
                                torch.from_numpy(np.asarray(dense)),
                                multimask_output=multimask)
    m = 3 if multimask else 1
    g4 = 4 * cfg.sam_dec.image_embedding_size
    assert got[0].shape == (n, m, g4, g4) and got[1].shape == (n, m)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("multimask", [False, True])
@pytest.mark.parametrize("mix", [("points",), ("boxes",),
                                 ("points", "boxes"), ("points", "masks")],
                         ids="+".join)
def test_segment_matches(models, multimask, mix):
    """`GroveModel.segment` on `encode_grounding`'s embeddings."""
    cfg, jmodel, variables, tmodel, _ = models
    rng = np.random.default_rng(7)
    s = cfg.sam_enc.img_size
    fs = rng.integers(0, 256, (1, cfg.num_frames, s, s, 3), dtype=np.uint8)
    emb = _apply(jmodel, variables, JaxGrove.encode_grounding,
                 jnp.asarray(fs))
    n = emb.shape[0]
    prompts = _prompts(cfg, rng, n, mix)
    if "masks" in prompts:
        prompts["mask_inputs"] = prompts.pop("masks")
    want = jmodel.apply(variables, emb, method=JaxGrove.segment,
                        multimask_output=multimask,
                        **{k: jnp.asarray(v) for k, v in prompts.items()})
    with torch.inference_mode():
        temb = tmodel.encode_grounding(torch.from_numpy(fs))
        got = tmodel.segment(temb, multimask_output=multimask,
                             **{k: torch.from_numpy(v)
                                for k, v in prompts.items()})
    _close(temb, emb)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_jax_conv_transpose_is_flipped(models):
    """On the plain export of one JAX tree (the reference layout), the
    port's masks differ from the JAX package's: flax's ConvTranspose does
    not flip the kernel as torch's does. The IoU head does not pass
    through the upscaling and agrees either way."""
    cfg, jmodel, variables, flipped, plain = models
    rng = np.random.default_rng(8)
    emb = _embeddings(cfg, rng, 2)
    prompts = _prompts(cfg, rng, 2, ("points",))
    want = jmodel.apply(variables, jnp.asarray(emb),
                        method=JaxGrove.segment,
                        **{k: jnp.asarray(v) for k, v in prompts.items()})
    with torch.inference_mode():
        got_plain = plain.segment(torch.from_numpy(emb),
                                  **{k: torch.from_numpy(v)
                                     for k, v in prompts.items()})
        got_flipped = flipped.segment(torch.from_numpy(emb),
                                      **{k: torch.from_numpy(v)
                                         for k, v in prompts.items()})
    _close(got_flipped[0], want[0])
    _close(got_plain[1], want[1])
    diff = float(np.abs(got_plain[0].numpy() - np.asarray(want[0])).max())
    assert diff > 10 * TOL, diff
