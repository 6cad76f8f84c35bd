"""The port (grove_tpu_torch) against the JAX package at GroveConfig.tiny()
in fp32, on the same weights and the same inputs.

Weights: `init_grove_params` builds the JAX tree; every parameter the init
leaves at zero (biases, rel-pos tables, SAM pos_embed, adapter gates) is
refilled from a numpy seed so those paths carry signal; the tree is
exported with `to_torch_state_dict` and loaded into the port strictly.
Inputs: uint8 frames and token ids from numpy seeds, handed to both.

Modules: rtol = atol = 2e-3, the tolerance of the JAX <-> reference parity
tests (`tests/test_parity_reference.py`). The slice: identical greedy ids,
boxes and objectness within 2e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.config import GroveConfig  # noqa: E402
from grove_tpu.models.grove import GroveModel as JaxGrove  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.text.mock_tokenizer import MockTokenizer  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    load_reference_state_dict)
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402

TOL = 2e-3


def _perturb_zeros(tree, rng):
    """Refill all-zero leaves so biases, rel-pos, pos_embed and adapter
    gates are exercised (the flax init leaves them at zero)."""
    def f(path, x):
        x = np.asarray(x)
        if np.any(x != 0):
            return x
        name = jax.tree_util.keystr(path)
        if "alpha" in name:
            return np.full_like(x, 0.5)
        return (rng.normal(size=x.shape) * 0.05).astype(x.dtype)
    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def models():
    cfg = GroveConfig.tiny()
    jmodel, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32)
    params = _perturb_zeros(variables["params"], np.random.default_rng(0))
    tmodel = GroveModel(cfg, device="cpu", dtype=torch.float32).eval()
    load_reference_state_dict(tmodel, to_torch_state_dict(params, cfg))
    return cfg, jmodel, {"params": params}, tmodel


def _frames(cfg, rng, b, t=None):
    t = t or cfg.num_frames
    c, s = cfg.clip.image_size, cfg.sam_enc.img_size
    return (rng.integers(0, 256, (b, t, c, c, 3), dtype=np.uint8),
            rng.integers(0, 256, (b, t, s, s, 3), dtype=np.uint8))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _jax(jmodel, variables, method, *args):
    return jax.jit(lambda v, *a: jmodel.apply(v, *a, method=method))(
        variables, *args)


def test_strict_load_names_every_parameter(models):
    cfg, _, variables, tmodel = models
    sd = to_torch_state_dict(variables["params"], cfg)
    assert set(sd) == set(tmodel.state_dict())
    del sd[next(iter(sd))]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_state_dict(
            GroveModel(cfg, device="cpu", dtype=torch.float32), sd)


def test_strict_load_drops_reference_only_keys(models, tmp_path):
    """A reference checkpoint's `vision_model.post_layernorm.*` and
    `rotary_emb.inv_freq` keys are dropped (the JAX converter's
    SKIP_PATTERNS); any other unknown key still raises."""
    cfg, _, variables, _ = models
    sd = to_torch_state_dict(variables["params"], cfg)
    tower = "model.vision_tower.vision_tower.vision_model."
    d = cfg.clip.hidden_size
    sd[tower + "post_layernorm.weight"] = np.ones(d, np.float32)
    sd[tower + "post_layernorm.bias"] = np.zeros(d, np.float32)
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(
        cfg.llama.head_dim // 2, np.float32)
    model = GroveModel(cfg, device="cpu", dtype=torch.float32)
    load_reference_state_dict(model, sd)
    # the same file through the API entry point
    from grove_tpu_torch.api import GroveForCausalLM
    path = tmp_path / "grove.bin"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)
    lm = GroveForCausalLM.from_pretrained(str(path), "tiny",
                                          dtype=torch.float32)
    for k, v in model.state_dict().items():
        assert torch.equal(lm.model.state_dict()[k], v), k
    sd["model.layers.0.self_attn.unknown.weight"] = np.ones(2, np.float32)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference_state_dict(model, sd)


def test_clip_encode_video_matches(models):
    cfg, jmodel, variables, tmodel = models
    fc, _ = _frames(cfg, np.random.default_rng(1), 2)
    want, wmlvl = _jax(jmodel, variables, JaxGrove.encode_video,
                       jnp.asarray(fc))
    with torch.inference_mode():
        got, gmlvl = tmodel.encode_video(torch.from_numpy(fc))
    _close(got, want)
    assert len(gmlvl) == len(wmlvl)
    for g, w in zip(gmlvl, wmlvl):
        _close(g, w)


def test_sam_encode_grounding_matches(models):
    cfg, jmodel, variables, tmodel = models
    _, fs = _frames(cfg, np.random.default_rng(2), 2)
    valid = np.array([[32, 32], [20, 27]], np.int32)
    want = _jax(jmodel, variables, JaxGrove.encode_grounding,
                jnp.asarray(fs), jnp.asarray(valid))
    with torch.inference_mode():
        got = tmodel.encode_grounding(torch.from_numpy(fs),
                                      torch.from_numpy(valid))
        chunked = tmodel.encode_grounding_auto(
            torch.from_numpy(fs), torch.from_numpy(valid),
            max_frames=cfg.num_frames)
    _close(got, want)
    _close(chunked, got, 1e-6)


def _prompt(cfg, rng, b):
    nv = cfg.num_video_tokens
    ids = rng.integers(3, 100, size=(b, nv + 9)).astype(np.int64)
    ids[:, 0] = cfg.tokens.bos
    ids[:, 2:2 + nv] = 0
    feats = rng.normal(size=(b, nv, cfg.llama.hidden_size)).astype(np.float32)
    return ids, np.full((b,), 2, np.int64), feats


def test_llama_lm_forward_matches(models):
    cfg, jmodel, variables, tmodel = models
    ids, vs, feats = _prompt(cfg, np.random.default_rng(3), 2)
    vs[1] = -1                                    # one row without video
    wh, wl = _jax(jmodel, variables, JaxGrove.lm_forward,
                  jnp.asarray(ids, jnp.int32), jnp.asarray(feats),
                  jnp.asarray(vs, jnp.int32))
    with torch.inference_mode():
        gh, gl = tmodel.lm_forward(torch.from_numpy(ids),
                                   torch.from_numpy(feats), vs)
    _close(gh, wh)
    _close(gl, wl)


def test_llama_prefill_decode_with_left_pad_matches(models):
    """bf16-cache path with a left-padded row: prefill hidden/logits and
    two decode steps equal the JAX ones (the cache layout is the same)."""
    from grove_tpu.models.llama import init_kv_caches as jinit
    from grove_tpu_torch.models.llama import init_kv_caches as tinit
    cfg, jmodel, variables, tmodel = models
    ids, vs, feats = _prompt(cfg, np.random.default_rng(4), 2)
    pad = np.array([0, 3], np.int64)
    ids[1, :3] = cfg.tokens.pad
    vs[1] += 3
    ids[1, 3] = cfg.tokens.bos
    ls = ids.shape[1]
    jc = jinit(cfg.llama, 2, ls + 2, dtype=jnp.float32)
    tc = tinit(cfg.llama, 2, ls + 2, dtype=torch.float32, device="cpu")
    pad_t = torch.from_numpy(pad)
    wh, wl, jc = _jax(jmodel, variables, JaxGrove.prefill,
                      jnp.asarray(ids, jnp.int32), jnp.asarray(feats),
                      jnp.asarray(vs, jnp.int32), jc,
                      jnp.asarray(pad, jnp.int32))
    with torch.inference_mode():
        gh, gl, tc = tmodel.prefill(torch.from_numpy(ids),
                                    torch.from_numpy(feats), vs, tc, pad_t)
    _close(gh, wh)
    _close(gl, wl)
    tok = np.argmax(np.asarray(wl)[:, -1], -1)[:, None]
    for i in range(2):
        wh, wl, jc = _jax(
            jmodel, variables,
            lambda m, t, c, p: m.decode_step(t, ls + i, c, p),
            jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pad, jnp.int32))
        with torch.inference_mode():
            gh, gl, tc = tmodel.decode_step(torch.from_numpy(tok), ls + i,
                                            tc, pad_t)
        _close(gh, wh)
        _close(gl, wl)
        _close(tc[0]["k"], jc[0]["k"])
        tok = np.argmax(np.asarray(wl)[:, -1], -1)[:, None]


def test_sam_decoder_ground_matches(models):
    cfg, jmodel, variables, tmodel = models
    rng = np.random.default_rng(5)
    b, t = 2, cfg.num_frames
    hidden = rng.normal(size=(b, 30, cfg.llama.hidden_size)).astype(
        np.float32)
    det = rng.integers(0, 30, size=(b, cfg.max_phrases)).astype(np.int64)
    g = cfg.sam_dec.image_embedding_size
    img = rng.normal(size=(b * t, g * g, cfg.sam_dec.embed_dim)).astype(
        np.float32)
    wb, wo = _jax(jmodel, variables, JaxGrove.ground, jnp.asarray(hidden),
                  jnp.asarray(det, jnp.int32), jnp.asarray(img))
    with torch.inference_mode():
        gb, go = tmodel.ground(torch.from_numpy(hidden),
                               torch.from_numpy(det), torch.from_numpy(img))
    assert gb.shape == (b, t, cfg.max_phrases, 4)
    _close(gb, wb)
    _close(go, wo)


def test_forward_boxes_matches(models):
    cfg, jmodel, variables, tmodel = models
    rng = np.random.default_rng(6)
    fc, fs = _frames(cfg, rng, 2)
    ids, vs, _ = _prompt(cfg, rng, 2)
    ids = np.pad(ids, ((0, 0), (0, 64 - ids.shape[1] % 64)))
    det = np.tile(np.array([[ids.shape[1] - 60, 20, 0, 0]]), (2, 1))
    batch = {"frames_clip": fc, "frames_sam": fs, "input_ids": ids,
             "video_start": vs, "det_positions": det}
    want = _jax(jmodel, variables, JaxGrove.forward_boxes,
                {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got = tmodel.forward_boxes({k: (torch.from_numpy(v)
                                        if k != "video_start" else v)
                                    for k, v in batch.items()})
    _close(got["pred_boxes"], want["pred_boxes"])
    _close(got["objectness_logits"], want["objectness_logits"])


# ---------------------------------------------------------------------------
# the slice: sliding-window inference end to end
# ---------------------------------------------------------------------------

def _clips(cfg, seed, n=2, t_total=6):
    rng = np.random.default_rng(seed)
    fc, fs = _frames(cfg, rng, n, t_total)
    return [{"frames_clip": fc[i], "frames_sam": fs[i],
             "original_size": (64, 48)} for i in range(n)]


def _assert_clip_outputs_match(got, want, keys):
    assert set(got) == set(want) == keys
    for key in keys:
        g, w = got[key], want[key]
        if key in ("bboxes", "probs_temp_objectness"):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                # pixel boxes: 2e-3 of the normalized box x (w, h) <= 64
                tol = TOL * (64 if key == "bboxes" else 1)
                np.testing.assert_allclose(a, b, rtol=TOL, atol=tol)
        else:
            assert g == w, key


def test_generate_grounded_matches(models):
    """Center-window generation: identical greedy ids, boxes and
    objectness within 2e-3."""
    from grove_tpu.infer.generate import generate_grounded as jgen
    from grove_tpu_torch.infer.generate import generate_grounded as tgen
    cfg, jmodel, variables, tmodel = models
    tok = MockTokenizer()
    rng = np.random.default_rng(7)
    fc, fs = _frames(cfg, rng, 2)
    ids, vs, _ = _prompt(cfg, rng, 2)
    want = jgen(jmodel, variables, cfg, tok, ids.astype(np.int32),
                vs.astype(np.int32), jnp.asarray(fc), jnp.asarray(fs),
                max_new_tokens=12)
    got = tgen(tmodel, cfg, tok, ids, vs, torch.from_numpy(fc),
               torch.from_numpy(fs), max_new_tokens=12)
    np.testing.assert_array_equal(got["generated_ids"],
                                  want["generated_ids"])
    np.testing.assert_array_equal(got["det_positions"],
                                  want["det_positions"])
    _close(got["pred_boxes"], want["pred_boxes"])
    _close(got["objectness_logits"], want["objectness_logits"])
    assert got["parsed"] == want["parsed"]


def test_infer_clips_batched_matches(models):
    from grove_tpu.infer import sliding as jsl
    from grove_tpu_torch.infer import sliding as tsl
    cfg, jmodel, variables, tmodel = models
    tok = MockTokenizer()
    clips = _clips(cfg, 8)
    want = jsl.infer_clips_batched(jmodel, variables, cfg, tok, clips,
                                   max_new_tokens=12)
    got = tsl.infer_clips_batched(tmodel, cfg, tok, clips,
                                  max_new_tokens=12)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_clip_outputs_match(g, w, set(w))


def test_finish_clip_teacher_forced_windows_match(models):
    """`_finish_clip` with a caption that has [DET]s (random weights rarely
    emit one): the batched teacher-forced pass over the other windows."""
    from grove_tpu.infer import sliding as jsl
    from grove_tpu.text import tagging
    from grove_tpu_torch.infer import sliding as tsl
    cfg, jmodel, variables, tmodel = models
    tok = MockTokenizer()
    clip = _clips(cfg, 9, n=1, t_total=8)[0]
    windows, masks = tsl.sliding_segment_with_mask(8, cfg.num_frames)
    ci = tsl.center_window_index(masks)
    text = "<p> a man </p> [DET] cuts <p> bread </p> [DET] ."
    parsed = tagging.parse_generation(text)

    def run(mod, *model_args):
        # the center window's entries come from the caller: empty ones here
        center = [[np.zeros((0, 4), np.float32)] * cfg.num_frames,
                  [[]] * cfg.num_frames, [np.zeros(0)] * cfg.num_frames]
        return mod._finish_clip(
            *model_args, cfg, tok, clip["frames_clip"], clip["frames_sam"],
            clip["original_size"], windows, masks, ci, windows[ci], text,
            parsed, parsed["phrases"], 2, 0.5, None, *center)

    want = run(jsl, jmodel, variables)
    with torch.inference_mode():
        got = run(tsl, tmodel)
    assert len(windows) == 4
    _assert_clip_outputs_match(got, want, set(want))


def test_ground_clip_with_caption_matches(models):
    from grove_tpu.infer import sliding as jsl
    from grove_tpu_torch.infer import sliding as tsl
    cfg, jmodel, variables, tmodel = models
    tok = MockTokenizer()
    clip = _clips(cfg, 10, n=1)[0]
    args = (cfg, tok, clip["frames_clip"], clip["frames_sam"],
            clip["original_size"])
    kw = dict(caption="a dog runs", use_objectness=True, threshold=0.3)
    want = jsl.ground_clip_with_caption(jmodel, variables, *args, **kw)
    got = tsl.ground_clip_with_caption(tmodel, *args, **kw)
    _assert_clip_outputs_match(got, want, set(want))
