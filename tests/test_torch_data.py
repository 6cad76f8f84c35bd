"""The port's training data pipeline (grove_tpu_torch.data) against the JAX
package's on the CPU, at tiny sizes:

* `sparse_sample` in both modes over a grid of (T, segments, seed);
* the key manifest, its shards and `ShardedKeyIndex`;
* the synthetic makers: the same annotations for a seed (the clip files
  end in `.npy` where JAX's end in `.gif`) and the same frames before the
  GIF palette;
* the `.npy` clip decoder against the native libav decoder on a GIF of
  constant-colour frames written here (its palette holds each colour
  exactly);
* the three datasets handed one numpy `decoder_factory` over the same
  annotations, and `GroundingLoader`'s batches over two epochs and over
  the ranks of a world of 2: frames, indices and token ids bit-equal,
  boxes and objectness within 1e-6.
"""

import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grove_tpu import config as jconfig  # noqa: E402
from grove_tpu.data import index as jindex  # noqa: E402
from grove_tpu.data import sampling as jsamp  # noqa: E402
from grove_tpu.data import synthetic as jsyn  # noqa: E402
from grove_tpu_torch import config as tconfig  # noqa: E402
from grove_tpu_torch.data import index as tindex  # noqa: E402
from grove_tpu_torch.data import sampling as tsamp  # noqa: E402
from grove_tpu_torch.data import synthetic as tsyn  # noqa: E402
from grove_tpu_torch.data import video as tvideo  # noqa: E402

BOX_TOL = 1e-6


@pytest.mark.parametrize("mode", ["random", "center"])
@pytest.mark.parametrize("t,seg", [(8, 8), (16, 8), (29, 8), (100, 8),
                                   (7, 3), (40, 10)])
def test_sparse_sample_equals_original(mode, t, seg):
    for seed in range(3):
        got = tsamp.sparse_sample(t, seg, mode, np.random.default_rng(seed))
        want = jsamp.sparse_sample(t, seg, mode, np.random.default_rng(seed))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_manifest_shards_and_index_equal_original(tmp_path):
    ann = tmp_path / "ann"
    ann.mkdir()
    for i in (5, 1, 3, 0, 4, 2, 6):
        (ann / f"k{i:02d}.pkl").write_bytes(b"")
    (ann / "notes.txt").write_text("")
    for mod, name in ((tindex, "t.txt"), (jindex, "j.txt")):
        assert mod.build_manifest(str(ann), str(tmp_path / name)) == 7
    assert ((tmp_path / "t.txt").read_bytes()
            == (tmp_path / "j.txt").read_bytes())
    path = str(tmp_path / "t.txt")
    for world in (1, 2, 3, 4):
        for rank in range(world):
            for pad in (True, False):
                assert (tindex.read_manifest(path, rank, world, pad)
                        == jindex.read_manifest(path, rank, world, pad))
            got = tindex.ShardedKeyIndex(path, rank, world, seed=5)
            want = jindex.ShardedKeyIndex(path, rank, world, seed=5)
            assert len(got) == len(want)
            for epoch in range(3):
                assert got.epoch_keys(epoch) == want.epoch_keys(epoch)
    with pytest.raises(ValueError):
        tindex.read_manifest(path, 2, 2)


def _record_frames(monkeypatch):
    """Capture the frames the JAX makers hand PIL, in order."""
    frames = []
    real = jsyn.Image.fromarray

    def fromarray(a, *args, **kw):
        frames.append(np.array(a))
        return real(a, *args, **kw)
    monkeypatch.setattr(jsyn.Image, "fromarray", fromarray)
    return frames


def _same_frames(jframes, paths, num_frames):
    assert len(jframes) == len(paths) * num_frames
    for i, path in enumerate(paths):
        want = np.stack(jframes[i * num_frames:(i + 1) * num_frames])
        with tvideo.NpyVideo(path) as dec:
            got = dec.decode_at(np.arange(num_frames) / dec.fps)
        np.testing.assert_array_equal(got, want)


def _strip_ext(x):
    """Every clip name with its extension dropped."""
    if isinstance(x, dict):
        return {k: _strip_ext(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_strip_ext(v) for v in x]
    if isinstance(x, str) and x.endswith((".gif", ".npy", ".mp4")):
        return x[:-4]
    return x


@pytest.mark.parametrize("maker", ["howto", "vidstg", "anet", "pointing"])
def test_synthetic_makers_equal_original(tmp_path, monkeypatch, maker):
    """The same annotations for a seed (clip names aside) and the same
    frames as the JAX makers before the GIF palette."""
    kw = dict(seed=3, width=40, height=24, num_frames={
        "howto": 6, "vidstg": 7, "anet": 9, "pointing": 5}[maker])
    clips = _record_frames(monkeypatch)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    if maker == "howto":
        (jann, jvid, jkeys) = jsyn.make_synthetic_howto_dataset(
            str(jdir), num_videos=3, **kw)
        (tann, tvid, tkeys) = tsyn.make_synthetic_howto_dataset(
            str(tdir), num_videos=3, **kw)
        assert tkeys == jkeys
        for key in jkeys:
            with open(os.path.join(jann, f"{key}.pkl"), "rb") as f:
                want = pickle.load(f)
            with open(os.path.join(tann, f"{key}.pkl"), "rb") as f:
                got = pickle.load(f)
            assert got["video_fname"] == f"{key}.npy"
            assert _strip_ext(got) == _strip_ext(want)
        paths = [os.path.join(tvid, f"{k}.npy") for k in tkeys]
    elif maker == "vidstg":
        jpath, _ = jsyn.make_synthetic_vidstg(str(jdir), num_videos=3, **kw)
        tpath, tvid = tsyn.make_synthetic_vidstg(str(tdir), num_videos=3,
                                                 **kw)
        got, want = (json.load(open(p)) for p in (tpath, jpath))
        assert _strip_ext(got) == _strip_ext(want)
        paths = [os.path.join(tvid, v["video_path"]) for v in got["videos"]]
    elif maker == "anet":
        jpath, _, jts = jsyn.make_synthetic_anet(str(jdir), num_videos=2,
                                                 **kw)
        tpath, tvid, tts = tsyn.make_synthetic_anet(str(tdir), num_videos=2,
                                                    **kw)
        assert tts == jts
        assert json.load(open(tpath)) == json.load(open(jpath))
        paths = [os.path.join(tvid, f"{v}.npy") for v in sorted(tts)]
    else:
        jpath, _, jgt = jsyn.make_synthetic_pointing(str(jdir), num_clips=2,
                                                     **kw)
        tpath, tvid, tgt = tsyn.make_synthetic_pointing(str(tdir),
                                                        num_clips=2, **kw)
        assert tgt == jgt
        got, want = (pickle.load(open(p, "rb")) for p in (tpath, jpath))
        assert _strip_ext(got) == _strip_ext(want)
        paths = [os.path.join(tvid, a["video_fname"]) for a in got]
    assert all(p.endswith(".npy") for p in paths)
    _same_frames(clips, paths, kw["num_frames"])


@pytest.fixture(scope="module")
def gif_and_npy(tmp_path_factory):
    """The same 60 constant-colour frames at 25 fps as a GIF (PIL, here)
    and as a `.npy` clip."""
    from PIL import Image
    if tvideo.probe_library() is not None:
        pytest.skip(f"libav decoder unavailable: {tvideo.probe_library()}")
    d = tmp_path_factory.mktemp("clip")
    t, fps = 60, 25.0
    frames = np.stack([np.full((16, 24, 3), (7 * i % 256, (50 + 3 * i) % 256,
                                             (200 - 2 * i) % 256), np.uint8)
                       for i in range(t)])
    ims = [Image.fromarray(f) for f in frames]
    gif = str(d / "c.gif")
    ims[0].save(gif, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)
    npy = str(d / "c.npy")
    tvideo.write_npy_clip(npy, frames, fps)
    return gif, npy, frames, fps


@pytest.mark.parametrize("where", ["exact", "between"])
def test_npy_decoder_matches_libav(gif_and_npy, where):
    """Exact frame times (where `int(t * fps)` falls short on frames 29,
    57, 58, ...) and times between frames give the native decoder's
    pixels; so does `decode_fps`."""
    gif, npy, frames, fps = gif_and_npy
    t = len(frames)
    ts = ([i / fps for i in range(t)] if where == "exact"
          else [(i + 0.5) / fps for i in range(t - 1)])
    if where == "exact":
        assert [int(x * fps) for x in ts] != list(range(t))
    with tvideo.VideoDecoder(gif) as dec, tvideo.open_video(npy) as mine:
        assert isinstance(mine, tvideo.NpyVideo)
        assert (mine.width, mine.height, mine.fps) == (dec.width, dec.height,
                                                       dec.fps)
        np.testing.assert_array_equal(mine.decode_at(ts), dec.decode_at(ts))
    for rate in (10.0, 25.0):
        with tvideo.VideoDecoder(gif) as dec, tvideo.NpyVideo(npy) as mine:
            np.testing.assert_array_equal(mine.decode_fps(rate),
                                          dec.decode_fps(rate))


def test_npy_decoder_past_the_end(gif_and_npy):
    """A timestamp past the last frame gets the last frame, the rule of
    `native/video_decoder.cc`'s padding (`VideoDecoder._decode`). The
    native sweep itself emits an unfilled frame there (zeros: it scales
    the frame of a failed decode), a fault recorded in ROADMAP Queue 3;
    the datasets never ask past the end."""
    gif, npy, frames, fps = gif_and_npy
    ts = [0.1, (len(frames) - 1) / fps + 0.01, len(frames) / fps + 0.5]
    got = tvideo.NpyVideo(npy).decode_at(ts)
    np.testing.assert_array_equal(got, frames[[3, -1, -1]])
    with tvideo.VideoDecoder(gif) as dec:
        native = dec.decode_at(ts)
    np.testing.assert_array_equal(native[0], got[0])
    assert not native[1:].any()
    yuv = tvideo.NpyVideo(npy).decode_at_yuv(ts)
    assert yuv.shape == (3, 24, 24)
    with pytest.raises(ValueError, match="even"):
        tvideo.NpyVideo(npy).decode_at_yuv(ts, out_size=(23, 16))


class _Frames:
    """A numpy clip decoder for both packages' datasets: frames made from
    the file's name without its extension (the JAX ActivityNet dataset,
    finding no clip of its extensions, names an `.mp4`) and the
    timestamps, no file read."""

    def __init__(self, path, width=40, height=24, fps=5.0):
        self.width, self.height, self.fps = width, height, fps
        name = os.path.splitext(os.path.basename(path))[0]
        self.seed = sum(name.encode())

    def decode_at(self, timestamps, out_size=None):
        w, h = out_size or (self.width, self.height)
        out = []
        for t in sorted(timestamps):
            rng = np.random.default_rng([self.seed, int(round(t * 1000))])
            out.append(rng.integers(0, 256, (h, w, 3), np.uint8))
        return np.stack(out)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


def _cfgs():
    return jconfig.GroveConfig.tiny(), tconfig.GroveConfig.tiny()


def _ds_kw(cfg, validation):
    return dict(decoder_factory=_Frames, num_frames=cfg.num_frames,
                clip_size=cfg.clip.image_size, sam_size=cfg.sam_enc.img_size,
                max_phrases=cfg.max_phrases, validation=validation)


def _same_sample(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key in ("gt_boxes", "gt_objectness"):
            np.testing.assert_allclose(g, w, rtol=0, atol=BOX_TOL,
                                       err_msg=key)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert _strip_ext(g) == _strip_ext(w), key


def _datasets(kind, tmp_path, validation):
    """(port dataset, JAX dataset) over the port maker's annotations."""
    jcfg, tcfg = _cfgs()
    if kind == "howto":
        from grove_tpu.data.datasets.howto100m import HowTo100MDataset as J
        from grove_tpu_torch.data.datasets.howto100m import (
            HowTo100MDataset as T)
        ann, vid, _ = tsyn.make_synthetic_howto_dataset(
            str(tmp_path), num_videos=3, num_frames=16, width=40, height=24)
        return (T(ann, vid, **_ds_kw(tcfg, validation)),
                J(ann, vid, **_ds_kw(jcfg, validation)))
    if kind == "vidstg":
        from grove_tpu.data.datasets.vidstg import VidSTGDataset as J
        from grove_tpu_torch.data.datasets.vidstg import VidSTGDataset as T
        ann, vid = tsyn.make_synthetic_vidstg(str(tmp_path), num_videos=3,
                                              width=40, height=24)
        return (T(ann, vid, **_ds_kw(tcfg, validation)),
                J(ann, vid, **_ds_kw(jcfg, validation)))
    from grove_tpu.data.datasets.anet_entities import (
        ActivityNetEntitiesDataset as J)
    from grove_tpu_torch.data.datasets.anet_entities import (
        ActivityNetEntitiesDataset as T)
    ann, vid, fts = tsyn.make_synthetic_anet(str(tmp_path), num_videos=2,
                                             width=40, height=24)
    kw = dict(frame_timestamps=fts, target_width=48)
    return (T(ann, vid, **kw, **_ds_kw(tcfg, validation)),
            J(ann, vid, **kw, **_ds_kw(jcfg, validation)))


@pytest.mark.parametrize("validation", [False, True])
@pytest.mark.parametrize("kind", ["howto", "vidstg", "anet"])
def test_datasets_equal_original(tmp_path, kind, validation):
    got_ds, want_ds = _datasets(kind, tmp_path, validation)
    assert len(got_ds) == len(want_ds) > 0
    for rep in range(2):                    # the seeded draws go on
        for i in range(len(want_ds)):
            _same_sample(got_ds[i], want_ds[i])


def test_dataset_parsers_equal_original():
    from grove_tpu.data.datasets import anet_entities as janet
    from grove_tpu.data.datasets import base as jbase
    from grove_tpu_torch.data.datasets import anet_entities as tanet
    from grove_tpu_torch.data.datasets import base as tbase
    cap = "a man cuts the bread while the man smiles"
    tagged = "<p>a man</p> cuts <p>the bread</p> while the man smiles"
    for phrases in (["a man", "the bread"], ["the bread", "a man"],
                    ["the man", "nothing"]):
        spans = tbase.phrase_spans_from_tagged(cap, tagged, phrases)
        assert spans == jbase.phrase_spans_from_tagged(cap, tagged, phrases)
        assert (tbase.sort_phrases_by_span(phrases, spans)
                == jbase.sort_phrases_by_span(phrases, spans))
    for labels in (["man", "bread"], ["smile", "man", "man"], ["dog"]):
        assert (tanet.find_first_occurrences(cap, labels)
                == janet.find_first_occurrences(cap, labels))
    np.testing.assert_array_equal(
        tanet.compute_midpoint_timestamps(0.5, 7.25, 10),
        janet.compute_midpoint_timestamps(0.5, 7.25, 10))
    xyxy = np.array([[3.0, 4.5, 20.25, 11.0], [0.0, 0.0, 40.0, 24.0]],
                    np.float32)
    from grove_tpu.ops import boxes as jboxes
    got = tbase.normalize_boxes(tbase.box_xyxy_to_cxcywh(xyxy), 40, 24)
    want = np.asarray(jboxes.normalize_boxes(
        jboxes.box_xyxy_to_cxcywh(xyxy), 40, 24))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", [1, 2])
def test_loader_batches_equal_original(tmp_path, world):
    """`GroundingLoader` over two epochs (and each rank of a world of 2):
    bit-equal batches."""
    from grove_tpu.data.loader import GroundingLoader as JLoader
    from grove_tpu.text.mock_tokenizer import MockTokenizer as JTok
    from grove_tpu_torch.data.loader import GroundingLoader as TLoader
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer as TTok
    got_ds, want_ds = _datasets("howto", tmp_path, False)
    jcfg, tcfg = _cfgs()
    for rank in range(world):
        kw = dict(batch_size=2, num_workers=1, seed=7, process_index=rank,
                  process_count=world, drop_last=False)
        mine = TLoader(got_ds, TTok(), tcfg, **kw)
        ref = JLoader(want_ds, JTok(), jcfg, **kw)
        assert len(mine) == len(ref)
        for epoch in range(2):
            mine.set_epoch(epoch)
            ref.set_epoch(epoch)
            pairs = list(zip(mine, ref, strict=True))
            assert pairs
            for (gb, gm), (wb, wm) in pairs:
                assert gm["conversations"] == wm["conversations"]
                _same_sample(gb, wb)


def test_loader_rank_from_torch_distributed(monkeypatch):
    """Without arguments the loader takes rank and world from an
    initialized `torch.distributed`, else 0 and 1."""
    from grove_tpu_torch.data import loader as tloader
    assert tloader.process_rank_world() == (0, 1)
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    got = tloader.GroundingLoader(list(range(7)), None,
                                  tconfig.GroveConfig.tiny(), shuffle=False)
    assert (got.rank, got.world) == (1, 3)
    np.testing.assert_array_equal(got._indices(), [1, 4, 0])
