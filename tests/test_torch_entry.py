"""The main path's entry in the port against the JAX package, on the CPU.

* The host transforms (`data.preprocess`, numpy) bit-equal to the JAX
  package's, which resize with PIL, on odd, non-square and upscaled sizes.
* The native decoder's bindings (`data.video`) bit-equal to JAX's on a GIF
  and on a YUV4MPEG2 clip from `chip_smoke.py`'s writer.
* The in-graph raw and YUV420 normalizers (`GroveModel._norm_clip` /
  `_norm_sam`) against JAX's `jax.image.resize` path at `GroveConfig.tiny()`:
  the resize within 5e-3 levels (of 0-255) before rounding (the two sum in
  other orders in fp32), at most 1 level apart on at most 0.5% of the
  values after (a sum within float noise of a .5 rounds either way), the
  SAM pad exactly 0.
* `GroveProcessor.generate` / `generate_batch`, JAX and port on the same
  weights, one decoded clip: identical text and tokens, boxes within 2e-3
  (the tolerance of `tests/test_torch_parity.py`).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.data import preprocess as jpre  # noqa: E402
from grove_tpu.data import video as jvideo  # noqa: E402
from grove_tpu.models.grove import GroveModel as JaxGrove  # noqa: E402
from grove_tpu_torch.data import preprocess as tpre  # noqa: E402
from grove_tpu_torch.data import video as tvideo  # noqa: E402
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from test_torch_parity import (_assert_clip_outputs_match,  # noqa: E402
                               models, port_config)

ROOT = Path(__file__).resolve().parents[1]
LEVEL_TOL = 5e-3          # levels of 0-255, before rounding
FLIP_SHARE = 5e-3         # values one level apart after rounding
SIZES = [(97, 61), (61, 97), (427, 240), (336, 336), (512, 288), (40, 30)]
TRANSFORMS = ["clip_preprocess", "sam_preprocess", "clip_resize_uint8",
              "sam_resize_uint8"]

assert models  # the module-scoped fixture, shared with the parity tests


def _frame(w, h, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


# ---------------------------------------------------------------------------
# host transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", TRANSFORMS)
@pytest.mark.parametrize("w,h", SIZES)
def test_transform_bit_equal_to_pil(w, h, fn):
    f = _frame(w, h, seed=w * h)
    for size in (336, 512, 28):
        want = getattr(jpre, fn)(f, size)
        got = getattr(tpre, fn)(f, size)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{fn} {size}")


def test_batch_transforms_bit_equal_to_pil():
    frames = np.stack([_frame(97, 61, seed=i) for i in range(3)])
    for got, want in zip(tpre.preprocess_frames(frames, 28, 32),
                         jpre.preprocess_frames(frames, 28, 32)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tpre.preprocess_frames_uint8(frames, 28, 32),
                         jpre.preprocess_frames_uint8(frames, 28, 32)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cpus", [1, 4, 64])
def test_frame_chunks_bit_equal_to_pil(monkeypatch, cpus):
    """The transforms split a clip into one chunk of frames per CPU: any
    split, uneven ones included, gives PIL's bytes at the towers' sizes."""
    monkeypatch.setattr(tpre, "_CPUS", cpus)
    frames = np.stack([_frame(160, 90, seed=i) for i in range(11)])
    for got, want in zip(tpre.preprocess_frames(frames),
                         jpre.preprocess_frames(frames)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tpre.preprocess_frames_uint8(frames, 28, 32),
                         jpre.preprocess_frames_uint8(frames, 28, 32)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,h", [(96, 64), (640, 360), (2, 2)])
def test_yuv420_round_trips_equal_jax(w, h):
    frames = np.stack([_frame(w, h, seed=i) for i in range(2)])
    packed = tpre.rgb_to_yuv420(frames)
    np.testing.assert_array_equal(packed, jpre.rgb_to_yuv420(frames))
    np.testing.assert_array_equal(tpre.yuv420_to_rgb(packed),
                                  jpre.yuv420_to_rgb(packed))


# ---------------------------------------------------------------------------
# the native decoder
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """A GIF of the JAX package's synthetic dataset and a .y4m clip from
    chip_smoke.py's writer (with the packed frames it wrote)."""
    from grove_tpu.data.synthetic import make_synthetic_howto_dataset
    why = tvideo.probe_library()
    if why is not None:
        pytest.skip(f"the native decoder does not load here: {why}")
    root = tmp_path_factory.mktemp("entry")
    _, video_dir, keys = make_synthetic_howto_dataset(
        str(root), num_videos=2, num_frames=12)
    y4m = root / "clip.y4m"
    packed = _chip_smoke().y4m_clip(y4m, seed=1, frames=10, width=96,
                                    height=64)
    return [f"{video_dir}/{k}.gif" for k in keys], str(y4m), packed


@pytest.mark.parametrize("which", ["gif", "y4m"])
def test_video_decoder_bit_equal_to_jax(clips, which):
    gifs, y4m, _ = clips
    path = gifs[0] if which == "gif" else y4m
    ts = [0.0, 0.45, 1.0, 1.65]
    with tvideo.VideoDecoder(path) as got, jvideo.VideoDecoder(path) as want:
        assert (got.fps, got.duration, got.width, got.height) == (
            want.fps, want.duration, want.width, want.height)
        for call in (lambda d: d.decode_at(ts),
                     lambda d: d.decode_at(ts, out_size=(48, 30)),
                     lambda d: d.decode_at_yuv(ts),
                     lambda d: d.decode_fps(5.0),
                     lambda d: d.decode_fps(2.5, out_size=(32, 20))):
            a, b = call(got), call(want)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_y4m_decodes_to_the_frames_written(clips):
    _, y4m, packed = clips
    with tvideo.VideoDecoder(y4m) as d:
        assert (d.width, d.height, d.fps) == (96, 64, 5.0)
        got = d.decode_at_yuv([i / 5.0 for i in range(len(packed))])
    np.testing.assert_array_equal(got, packed)


def test_decode_at_yuv_raises_on_odd_sizes(clips):
    """The JAX decoder asserts even sizes; the port raises ValueError."""
    _, y4m, _ = clips
    with tvideo.VideoDecoder(y4m) as d:
        with pytest.raises(ValueError, match="even"):
            d.decode_at_yuv([0.0], out_size=(95, 64))
        assert d.decode_at([0.0], out_size=(95, 63)).shape == (1, 63, 95, 3)


# ---------------------------------------------------------------------------
# in-graph raw and YUV420 input
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def normalizers():
    """JAX's and the port's `_norm_clip` / `_norm_sam` at tiny in fp32
    (they read no parameter: the port's model lives on the meta device)."""
    from grove_tpu.config import GroveConfig
    cfg = GroveConfig.tiny()
    jmodel = JaxGrove(cfg, dtype=jnp.float32)
    tmodel = GroveModel(port_config(cfg), device="meta", dtype=torch.float32)

    def jax_norm(method, frames):
        return np.asarray(jax.jit(lambda x: jmodel.apply(
            {}, x, method=getattr(JaxGrove, method)))(jnp.asarray(frames)))

    def port_norm(method, frames):
        return getattr(tmodel, method)(torch.from_numpy(frames)).numpy()
    return cfg, jax_norm, port_norm


def _levels(x, method):
    """Normalized values back to levels of 0-255."""
    if method == "_norm_clip":
        return (x * tpre.CLIP_STD + tpre.CLIP_MEAN) * 255.0
    return x * tpre.SAM_STD + tpre.SAM_MEAN


@pytest.mark.parametrize("w,h,mode", [(97, 61, "raw"), (64, 96, "raw"),
                                      (640, 360, "raw"), (64, 96, "yuv"),
                                      (640, 360, "yuv")])
@pytest.mark.parametrize("method", ["_norm_clip", "_norm_sam"])
def test_raw_normalizers_match_jax(normalizers, method, w, h, mode):
    """Raw RGB frames (5-D) and packed YUV420P (4-D, even sizes only)."""
    cfg, jax_norm, port_norm = normalizers
    frames = np.stack([np.stack([_frame(w, h, seed=10 * i + j)
                                 for j in range(2)]) for i in range(2)])
    if mode == "yuv":
        frames = np.stack([tpre.rgb_to_yuv420(f) for f in frames])
    want, got = jax_norm(method, frames), port_norm(method, frames)
    assert got.shape == want.shape and got.dtype == np.float32
    lw = np.round(_levels(want, method))
    lg = np.round(_levels(got, method))
    diff = np.abs(lg - lw)
    assert diff.max() <= 1 and (diff > 0).mean() <= FLIP_SHARE
    same = diff == 0
    np.testing.assert_allclose(got[same], want[same], rtol=1e-5, atol=1e-5)
    if method == "_norm_sam":
        size = cfg.sam_enc.img_size
        scale = size / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        assert np.all(got[:, :, nh:] == 0) and np.all(got[:, :, :, nw:] == 0)


@pytest.mark.parametrize("shape,method", [
    ((61, 97, 28, 44), "bicubic"), ((360, 640, 336, 597), "bicubic"),
    ((360, 640, 288, 512), "bilinear"), ((30, 40, 48, 64), "bicubic"),
    ((96, 64, 32, 21), "bilinear")])
def test_device_resize_matches_jax_image_resize(shape, method):
    """`_resize_frames` (the normalizers' resize, before rounding) against
    `jax.image.resize` on the same float frames."""
    from grove_tpu_torch.models.grove import _resize_frames
    h, w, nh, nw = shape
    frames = np.random.default_rng(h + w).integers(
        0, 256, (1, 2, h, w, 3), dtype=np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(frames, jnp.float32),
                                       (1, 2, nh, nw, 3), method=method))
    got = _resize_frames(torch.from_numpy(frames), (nh, nw), method).numpy()
    assert np.abs(got - want).max() <= LEVEL_TOL
    top, left, size = (nh - 16) // 2, (nw - 16) // 2, 16
    crop = _resize_frames(torch.from_numpy(frames), (nh, nw), method,
                          crop=(top, left, size)).numpy()
    np.testing.assert_allclose(
        crop, got[:, :, top:top + size, left:left + size], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# GroveProcessor
# ---------------------------------------------------------------------------

def test_processor_generate_matches_jax(models, clips):
    from grove_tpu.api.processor import GroveProcessor as JProc
    from grove_tpu.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.api import GroveProcessor
    cfg, jmodel, variables, tmodel = models
    gifs, _, _ = clips
    tok = MockTokenizer()
    want = JProc(tok, cfg).generate(jmodel, variables, gifs[0],
                                    max_new_tokens=8)
    got = GroveProcessor(tok, tmodel.cfg).generate(tmodel, gifs[0],
                                                   max_new_tokens=8)
    assert got["frame_indices"] == list(range(12))
    _assert_clip_outputs_match(got, want, set(want))


def test_processor_generate_batch_matches_jax(models, clips):
    from grove_tpu.api.processor import GroveProcessor as JProc
    from grove_tpu.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.api import GroveProcessor
    cfg, jmodel, variables, tmodel = models
    gifs, _, _ = clips
    tok = MockTokenizer()
    ins = ["describe briefly", "describe every object you can see"]
    want = JProc(tok, cfg).generate_batch(jmodel, variables, gifs,
                                          instructions=ins, max_new_tokens=6)
    got = GroveProcessor(tok, tmodel.cfg).generate_batch(
        tmodel, gifs, instructions=ins, max_new_tokens=6)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_clip_outputs_match(g, w, set(w))


def test_processor_on_synthetic_video_and_the_api_surface(models):
    """`decoder_factory` takes any decoder (here `SyntheticVideo`, through
    a lambda); `generate_with_backend` with a greedy backend equals
    `generate`; `GroveForCausalLM`'s wrappers equal the model methods."""
    from grove_tpu_torch.infer.generate import generate_grounded
    from grove_tpu_torch.api import GroveForCausalLM, GroveProcessor
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    _, _, _, tmodel = models
    tok = MockTokenizer()
    proc = GroveProcessor(tok, tmodel.cfg, decoder_factory=lambda p: (
        tvideo.SyntheticVideo(num_frames=6, width=40, height=30, seed=4)))
    out = proc.generate(tmodel, "unused", max_new_tokens=3)
    assert out["frame_indices"] == list(range(6))
    assert out["original_size"] == (40, 30)
    backend = (lambda ids, start, fc, fs: generate_grounded(
        tmodel, tmodel.cfg, tok, ids[None], [start], fc, fs,
        max_new_tokens=3))
    assert proc.generate_with_backend(tmodel, "unused", backend)["text"] \
        == out["text"]
    lm = GroveForCausalLM(tmodel.cfg, tmodel)
    frames = np.random.default_rng(5).integers(0, 256, (1, 2, 28, 28, 3),
                                               dtype=np.uint8)
    with torch.inference_mode():
        want, _ = tmodel.encode_video(torch.from_numpy(frames))
        pe = tmodel.dense_pe()
    got, _ = lm.encode_images(frames)
    assert torch.equal(got, want) and torch.equal(lm.get_dense_pe(), pe)
    sam = np.random.default_rng(6).integers(0, 256, (1, 2, 32, 32, 3),
                                            dtype=np.uint8)
    emb = lm.get_grounding_encoder_embs(sam)
    assert emb.shape[0] == 2 and torch.isfinite(emb).all()


# ---------------------------------------------------------------------------
# raw mode uploads each window once
# ---------------------------------------------------------------------------

def test_raw_mode_window_batch_uploads_once():
    from grove_tpu_torch.infer.sliding import _window_batch

    class _Ap:
        input_ids = np.zeros(8, np.int64)
        video_start = 1
        det_positions = np.zeros(2, np.int64)

    class _Model:
        device = torch.device("cpu")

    raw = np.zeros((6, 40, 30, 3), np.uint8)
    batch = _window_batch(_Model(), raw, raw, [[0, 1], [2, 3]], _Ap())
    assert batch["frames_sam"] is batch["frames_clip"]
    assert tuple(batch["frames_clip"].shape) == (2, 2, 40, 30, 3)
    other = _window_batch(_Model(), raw, raw.copy(), [[0, 1]], _Ap())
    assert other["frames_sam"] is not other["frames_clip"]


def test_raw_mode_clip_matches_jax(models):
    """`infer_clips_batched` with one raw stack passed as both towers'
    frames (the device resizes it), JAX and port on the same weights."""
    from grove_tpu.infer import sliding as jsl
    from grove_tpu.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.infer import sliding as tsl
    cfg, jmodel, variables, tmodel = models
    raw = np.random.default_rng(7).integers(0, 256, (6, 40, 56, 3),
                                            dtype=np.uint8)
    clips = [{"frames_clip": raw, "frames_sam": raw,
              "original_size": (56, 40)}]
    tok = MockTokenizer()
    want = jsl.infer_clips_batched(jmodel, variables, cfg, tok, clips,
                                   max_new_tokens=6)
    got = tsl.infer_clips_batched(tmodel, tmodel.cfg, tok, clips,
                                  max_new_tokens=6)
    _assert_clip_outputs_match(got[0], want[0], set(want[0]))
