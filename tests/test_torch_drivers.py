"""The port's batch inference drivers (`grove_tpu_torch.infer.drivers`) and
experiment runner against the JAX package's, at GroveConfig.tiny() in fp32.

Weights: `test_torch_parity`'s `models` fixture (one JAX tree, exported to
the port). Data: one synthetic set per task made by the JAX package's makers
(GIF clips), read by both packages through the repo's native decoder
(`native/libgrove_video.so`, which both load). Tolerance: `TOL` = 2e-3 of
`tests/test_torch_parity.py` for boxes (times the frame's larger side, as
boxes are in pixels) and objectness probabilities; token ids, text, phrases
and frame indices equal. Both drivers decode with the kwargs their `main`
builds (`_decode_kwargs(None, True)`: a bf16 KV cache).

Then the port alone: `center_stacks` + `infer_clips_batched(preloaded=)`
against the inline upload, `gather_outputs` in two gloo processes, the flag
errors and the missing `--version`, `main` for each task on its own
synthetic set (`.npy` clips), and the port's mirrors of
`tests/test_infer_tasks.py` and `tests/test_run_experiment.py`.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grove_tpu.api.processor import _decode_kwargs as jax_decode_kwargs  # noqa
from grove_tpu.data import synthetic as jsyn  # noqa: E402
from grove_tpu.infer import drivers as jd  # noqa: E402
from grove_tpu.text.mock_tokenizer import MockTokenizer  # noqa: E402
from grove_tpu_torch.api.processor import (  # noqa: E402
    _decode_kwargs as port_decode_kwargs)
from grove_tpu_torch.infer import drivers as td  # noqa: E402
from grove_tpu_torch.infer import sliding as tsl  # noqa: E402

from test_torch_parity import TOL, models  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
NEW = 8          # new tokens of the generating tasks
BOX_KEYS = ("pred_bboxes", "boxes", "final_boxes", "pts_to_bbox",
            "bbox_for_all_frames")
# the keys of each task's pickle entries (`grove_tpu/infer/drivers.py`)
ENTRY_KEYS = {
    "iground": {"pred_bboxes", "pred_labels", "pred_phrases", "pred_text",
                "pred_text_tagged", "probs_temp_objectness", "original_size",
                "frame_indices"},
    "vidstg": {"frame_ids", "boxes", "qtype"},
    "groundingyoutube": {"pts_to_bbox", "final_boxes", "selected_pts"},
    "youcookinteractions": {"pts_to_bbox", "final_boxes", "selected_pts"},
    "anet": {"clss", "idx_in_sent", "bbox_for_all_frames", "pred_text"},
}
POINTING = ("groundingyoutube", "youcookinteractions")


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """One synthetic set per task, written once by the JAX package's
    makers: {task: (annotations, video dir, frame timestamps or None)}."""
    root = tmp_path_factory.mktemp("sets")
    out = {}
    ann, videos, _ = jsyn.make_synthetic_howto_dataset(
        str(root / "iground"), num_videos=5, num_frames=6)
    out["iground"] = (ann, videos, None)
    out["vidstg"] = jsyn.make_synthetic_vidstg(
        str(root / "vidstg"), num_videos=2, num_frames=8) + (None,)
    for task in POINTING:
        key, secs = td.pointing_keys(task)
        ann, videos, _ = jsyn.make_synthetic_pointing(
            str(root / task), num_clips=2, num_frames=7, segment_key=key,
            secs_key=secs)
        out[task] = (ann, videos, None)
    out["anet"] = jsyn.make_synthetic_anet(str(root / "anet"))
    return out


def _datasets(task, sets, jcfg, tcfg):
    """The task's dataset in each package, on the same files."""
    ann, videos, fts = sets[task]
    if task == "iground":
        return (jd.FullClipIGroundDataset(ann, videos, jcfg),
                td.FullClipIGroundDataset(ann, videos, tcfg))
    if task == "vidstg":
        return (jd.FullClipVidSTGDataset(ann, videos, jcfg),
                td.FullClipVidSTGDataset(ann, videos, tcfg))
    if task == "anet":
        return (jd.FullClipANetDataset(ann, videos, fts, jcfg,
                                       target_width=96),
                td.FullClipANetDataset(ann, videos, fts, tcfg,
                                       target_width=96))
    key, secs = td.pointing_keys(task)
    return (jd.FullClipPointingDataset(ann, videos, jcfg, segment_key=key,
                                       secs_key=secs),
            td.FullClipPointingDataset(ann, videos, tcfg, segment_key=key,
                                       secs_key=secs))


def _run(task, models, sets, clip_batch=4, timing=None, main_kwargs=True):
    """The task's run_* function of each package -> (JAX, port); iground
    with `main_kwargs=False` passes no decode kwargs (each function's
    default cache dtype)."""
    cfg, jmodel, variables, tmodel = models
    tok = MockTokenizer()
    jds, tds = _datasets(task, sets, cfg, tmodel.cfg)
    jkw = dict(progress=False)
    tkw = dict(progress=False)
    if task == "iground":
        jt, tt = (timing or ([], []))
        jdk, tdk = ((jax_decode_kwargs(None, True),
                     port_decode_kwargs(None, True)) if main_kwargs
                    else (None, None))
        return (jd.run_inference(jds, jmodel, variables, cfg, tok,
                                 max_new_tokens=NEW, clip_batch=clip_batch,
                                 decode_kwargs=jdk, timing=jt, **jkw),
                td.run_inference(tds, tmodel, tmodel.cfg, tok,
                                 max_new_tokens=NEW, clip_batch=clip_batch,
                                 decode_kwargs=tdk, timing=tt, **tkw))
    if task == "anet":
        return (jd.run_anet_inference(
                    jds, jmodel, variables, cfg, tok, max_new_tokens=NEW,
                    decode_kwargs=jax_decode_kwargs(None, True), **jkw),
                td.run_anet_inference(
                    tds, tmodel, tmodel.cfg, tok, max_new_tokens=NEW,
                    decode_kwargs=port_decode_kwargs(None, True), **tkw))
    return (jd.run_caption_grounding(jds, jmodel, variables, cfg, tok,
                                     task=task, **jkw),
            td.run_caption_grounding(tds, tmodel, tmodel.cfg, tok,
                                     task=task, **tkw))


def _same_tree(got, want, tol, where="outputs"):
    """Equal structure and values; floats and arrays within `tol`
    (relative and absolute), everything else equal."""
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _same_tree(got[k], want[k], tol, f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, float, np.floating)):
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, where
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=tol, atol=tol,
                                   err_msg=where)
    else:
        assert got == want, where


def _assert_outputs_match(got, want, task, sizes):
    """One task's outputs: per entry the JAX keys; boxes within TOL of the
    frame's larger side (`sizes[entry]`), the rest within TOL or equal."""
    assert list(got) == list(want)
    for uid in want:
        g, w = got[uid], want[uid]
        if task == "anet":
            assert list(g) == list(w)
            for seg in w:
                _assert_entry(g[seg], w[seg], task, sizes[uid])
        else:
            _assert_entry(g, w, task, sizes[uid])


def _assert_entry(got, want, task, side):
    assert set(want) == ENTRY_KEYS[task]
    assert list(got) == list(want)
    for key in want:
        tol = TOL * side if key in BOX_KEYS else TOL
        _same_tree(got[key], want[key], tol, key)


def _sizes(task, dataset):
    """Each entry's frame size's larger side, by the entry's id."""
    out = {}
    for i in range(len(dataset)):
        s = dataset[i]
        uid = (f"{s['video_id']}_{s['clip_id']}" if task == "iground"
               else s["video_id"])
        out[uid] = max(s["original_size"])
    return out


def test_chip_smoke_entry_keys_are_these():
    """chip_smoke.py's phase 10 requires the entries these tests hold to
    the JAX driver's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.INFER_ENTRY_KEYS == ENTRY_KEYS
    assert set(chip_smoke.INFER_TASKS) == set(td.TASKS)


@pytest.mark.parametrize("task", list(ENTRY_KEYS))
def test_datasets_equal_originals(task, models, sets):
    """Both packages' datasets give the same samples from the same files
    (the native decoder, the numpy host transforms bit-equal to PIL)."""
    cfg, _, _, tmodel = models
    jds, tds = _datasets(task, sets, cfg, tmodel.cfg)
    assert len(jds) == len(tds) > 0
    for i in range(len(jds)):
        want, got = jds[i], tds[i]
        want.pop("ann", None)
        got.pop("ann", None)
        assert list(got) == list(want)
        for key in want:
            if isinstance(want[key], np.ndarray):
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
            else:
                assert got[key] == want[key], key


@pytest.mark.parametrize("clip_batch", [1, 4])
def test_run_inference_matches(clip_batch, models, sets):
    """iground: 5 clips in groups of `clip_batch` (4: a group of 4 and one
    of 1, both through the prefetch thread), with the timing dict."""
    timing = ([], [])
    want, got = _run("iground", models, sets, clip_batch, timing)
    cfg, _, _, tmodel = models
    _assert_outputs_match(got, want, "iground", _sizes(
        "iground", td.FullClipIGroundDataset(*sets["iground"][:2],
                                             tmodel.cfg)))
    groups = -(-5 // clip_batch)
    assert len(timing[0]) == len(timing[1]) == groups
    for jt, tt in zip(*timing):
        assert list(tt) == list(jt) == ["wait_s", "load_s", "upload_s",
                                        "model_s"]
        assert all(v >= 0 for v in tt.values())


def test_run_inference_default_cache_dtype_matches(models, sets):
    """No decode kwargs on either side: the port's default KV cache is
    bf16, as the JAX package's (`generate.py:204`), so the tiny fp32 model
    picks the JAX tokens on all 5 clips (a model-dtype cache took other
    tokens on 2 of them, at a near-tie that the bf16 rounding decides)."""
    want, got = _run("iground", models, sets, main_kwargs=False)
    cfg, _, _, tmodel = models
    assert len(want) == 5
    for uid in want:
        assert got[uid]["pred_text"] == want[uid]["pred_text"], uid
    _assert_outputs_match(got, want, "iground", _sizes(
        "iground", td.FullClipIGroundDataset(*sets["iground"][:2],
                                             tmodel.cfg)))


@pytest.mark.parametrize("task", ["vidstg", *POINTING])
def test_run_caption_grounding_matches(task, models, sets):
    want, got = _run(task, models, sets)
    cfg, _, _, tmodel = models
    _assert_outputs_match(got, want, task, _sizes(
        task, _datasets(task, sets, cfg, tmodel.cfg)[1]))
    if task != "vidstg":
        for entry in got.values():
            assert len(entry["final_boxes"]) == 2   # two target seconds


def _anet_sizes(sets, models):
    cfg, _, _, tmodel = models
    tds = _datasets("anet", sets, cfg, tmodel.cfg)[1]
    return {tds[i]["video_id"]: max(tds[i]["original_size"])
            for i in range(len(tds))}


def test_run_anet_inference_matches(models, sets):
    want, got = _run("anet", models, sets)
    _assert_outputs_match(got, want, "anet", _anet_sizes(sets, models))


TAGGED = "<p> a man </p> [DET] cuts <p> the bread </p> [DET] ."


def _forced_generation(monkeypatch, module, tok):
    """Make `module.generate_grounded` report a generation of TAGGED (two
    [DET]s), which random weights do not emit, so that ANet's
    teacher-forced windows [1, 9) and [2, 10) run."""
    real = module.generate_grounded

    def gen(*args, **kw):
        out = dict(real(*args, **kw))
        ids = np.asarray(tok(TAGGED, add_special_tokens=False).input_ids)
        out["generated_ids"] = ids[None]
        mask = np.zeros_like(out["phrase_mask"])
        mask[:, :2] = True
        out["phrase_mask"] = mask
        return out
    monkeypatch.setattr(module, "generate_grounded", gen)


def test_anet_teacher_forced_frames_match(models, sets, monkeypatch):
    """ANet with a tagged generation: the teacher-forced pass gets JAX's
    batch (the frames of windows [1, 9) and [2, 10), the answer's ids and
    [DET] positions; random weights give near-equal boxes on neighbouring
    frames, so the batch is compared itself), and frames 8 and 9, `clss`,
    `idx_in_sent` and the 10-frame box lists equal JAX's."""
    from grove_tpu.infer import generate as jgen
    from grove_tpu.infer import jit_utils
    from grove_tpu_torch.infer import generate as tgen
    tok = MockTokenizer()
    _forced_generation(monkeypatch, jgen, tok)
    _forced_generation(monkeypatch, tgen, tok)
    _, _, _, tmodel = models
    batches = {"jax": [], "port": []}
    real_apply, real_boxes = jit_utils.apply_jit, tmodel.forward_boxes

    def jax_apply(model, variables, *args, method):
        if method == "forward_boxes":
            batches["jax"].append(args[0])
        return real_apply(model, variables, *args, method=method)

    def port_boxes(batch):
        batches["port"].append(batch)
        return real_boxes(batch)
    monkeypatch.setattr(jit_utils, "apply_jit", jax_apply)
    monkeypatch.setattr(tmodel, "forward_boxes", port_boxes)
    want, got = _run("anet", models, sets)
    assert len(batches["jax"]) == len(batches["port"]) == 2
    for jb, tb in zip(batches["jax"], batches["port"]):
        for key in ("frames_clip", "frames_sam", "input_ids", "video_start",
                    "det_positions"):
            g = tb[key]
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            np.testing.assert_array_equal(g, np.asarray(jb[key]),
                                          err_msg=key)
    _assert_outputs_match(got, want, "anet", _anet_sizes(sets, models))
    for segs in got.values():
        for entry in segs.values():
            assert len(entry["clss"]) == 2
            assert all(len(boxes) == 10
                       for boxes in entry["bbox_for_all_frames"])


@pytest.mark.parametrize("caption,phrases", [
    ("a man cuts the bread", ["a man", "the bread"]),
    ("Someone slices tomatoes", ["tomatoes", "knife", ""]),
    ("", ["cup"]),
])
def test_phrase_word_indices_equal_original(caption, phrases):
    assert (td._phrase_word_indices(caption, phrases)
            == jd._phrase_word_indices(caption, phrases))


def _clip_samples(cfg, seed, n=3, t_total=6, valid=True, raw=False):
    rng = np.random.default_rng(seed)
    c, s = cfg.clip.image_size, cfg.sam_enc.img_size
    out = []
    for _ in range(n):
        fc = rng.integers(0, 256, (t_total, c, c, 3), dtype=np.uint8)
        sample = {"frames_clip": fc,
                  "frames_sam": fc if raw else rng.integers(
                      0, 256, (t_total, s, s, 3), dtype=np.uint8),
                  "original_size": (64, 48)}
        if valid:
            sample["sam_valid_hw"] = np.array([s - 8, s], np.int32)
        out.append(sample)
    return out


def _bitwise(got, want):
    """Equal structure, arrays bit for bit."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _bitwise(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _bitwise(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


def test_center_stacks_equal_jax(models):
    """The port's `center_stacks` stacks what JAX's does: the same windows,
    masks and center, the same frames and valid sizes."""
    from grove_tpu.infer import sliding as jsl
    cfg, _, _, _ = models
    samples = _clip_samples(cfg, 3)
    jm, jfc, jfs, jvalid = jsl.center_stacks(samples, cfg.num_frames)
    got = tsl.center_stacks(samples, cfg.num_frames, "cpu")
    assert [m[:3] for m in jm] == got.metas
    np.testing.assert_array_equal(got.frames_clip.numpy(), np.asarray(jfc))
    np.testing.assert_array_equal(got.frames_sam.numpy(), np.asarray(jfs))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(jvalid))
    assert got.ready is None and got.take() is got


@pytest.mark.parametrize("raw", [False, True])
def test_preloaded_equals_inline(raw, models):
    """`infer_clips_batched(preloaded=center_stacks(...))` gives the
    inline upload's outputs bit for bit; in raw mode one stack serves both
    towers."""
    cfg, _, _, tmodel = models
    tok = MockTokenizer()
    samples = _clip_samples(cfg, 4, valid=not raw, raw=raw)
    pre = tsl.center_stacks(samples, cfg.num_frames, "cpu")
    assert (pre.frames_sam is pre.frames_clip) == raw
    kw = dict(max_new_tokens=NEW,
              decode_kwargs=port_decode_kwargs(None, True))
    got = tsl.infer_clips_batched(tmodel, tmodel.cfg, tok, samples,
                                  preloaded=pre, **kw)
    want = tsl.infer_clips_batched(tmodel, tmodel.cfg, tok, samples, **kw)
    _bitwise(got, want)


def test_center_stacks_refuse_mixed_valid(models):
    cfg, _, _, tmodel = models
    samples = _clip_samples(cfg, 5, n=2)
    del samples[1]["sam_valid_hw"]
    with pytest.raises(ValueError, match="sam_valid_hw"):
        tsl.center_stacks(samples, cfg.num_frames, "cpu")
    pre = tsl.center_stacks(samples[:1], cfg.num_frames, "cpu")
    with pytest.raises(ValueError, match="preloaded"):
        tsl.infer_clips_batched(tmodel, tmodel.cfg, MockTokenizer(),
                                samples, preloaded=pre)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_and_sort_equals_original(seed):
    rng = np.random.default_rng(seed)
    gathered = [{f"v{int(k)}": {"rank": r, "x": float(rng.uniform())}
                 for k in rng.integers(0, 8, 5)} for r in range(3)]
    want = jd.update_and_sort_video_outputs(gathered)
    got = td.update_and_sort_video_outputs(gathered)
    assert list(got.items()) == list(want.items())


GATHER_RANK = textwrap.dedent("""
    import pickle, sys
    import torch.distributed as dist
    sys.path.insert(0, {root!r})
    from grove_tpu_torch.infer.drivers import gather_outputs
    rank = int(sys.argv[1])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    mine = {{f"clip{{i}}_0": {{"rank": rank, "i": i}}
             for i in range(rank, rank + 3)}}
    out = gather_outputs(mine)
    with open(sys.argv[2], "wb") as f:
        pickle.dump((mine, out), f)
    dist.destroy_process_group()
""")


def test_gather_outputs_two_gloo_processes(tmp_path):
    """`gather_outputs` across two CPU processes (gloo): every rank gets
    the first-occurrence merge of both ranks' dicts, in rank order."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = GATHER_RANK.format(root=str(ROOT), port=port)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(tmp_path / f"rank{r}.pkl")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    results = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    want = jd.update_and_sort_video_outputs([mine for mine, _ in results])
    for _, out in results:
        assert list(out.items()) == list(want.items())
    assert want["clip1_0"]["rank"] == 0 and want["clip3_0"]["rank"] == 1


FLAG_ERRORS = ([["--task", t] + flags for t in td.CAPTION_TASKS
                for flags in (["--num_beams", "2"], ["--temperature", "0.7"],
                              ["--kv_cache_dtype", "int8"],
                              ["--no_early_stop"])]
               + [["--top_k", "3"], ["--top_p", "0.5"],
                  ["--kv_cache_dtype", "int8", "--num_beams", "2"],
                  ["--temperature", "0.5", "--num_beams", "2"],
                  ["--task", "anet", "--num_beams", "17"]])


@pytest.mark.parametrize("flags", FLAG_ERRORS, ids=" ".join)
def test_flag_errors_like_original(flags, monkeypatch, capsys):
    """Each flag combination the JAX driver refuses (`drivers.py:414-428`)
    the port refuses with the same message (argparse's exit 2). The JAX
    model build is stubbed: it runs before the JAX checks."""
    import grove_tpu.models.grove as jgrove
    monkeypatch.setattr(jgrove, "init_grove_params",
                        lambda *a, **k: (None, {"params": {}}))
    messages = []
    for main in (jd.main, td.main):
        with pytest.raises(SystemExit) as e:
            main(flags + ["--device", "cpu"] if main is td.main else flags)
        assert e.value.code == 2
        messages.append(capsys.readouterr().err.splitlines()[-1]
                        .split("error: ")[-1])
    assert messages[0] == messages[1]


def test_missing_version_raises(tmp_path):
    """A `--version` path that does not exist raises (the JAX driver skips
    it and runs on random weights, `drivers.py:401`)."""
    with pytest.raises(FileNotFoundError, match="missing.bin"):
        td.main(["--task", "vidstg", "--synthetic", "--device", "cpu",
                 "--version", str(tmp_path / "missing.bin"),
                 "--output", str(tmp_path / "p.pkl")])
    assert not (tmp_path / "p.pkl").exists()


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        td.main(["--task", "vidstg", "--synthetic",
                 "--output", str(tmp_path / "p.pkl")])


def test_version_loads_reference_bin(models, tmp_path, capsys):
    """`build_model` lays a reference-named `.bin` over the seeded weights
    (every tensor of the model, bit for bit), and names what the `.bin`
    leaves missing or mismatched."""
    import argparse
    from grove_tpu.checkpoint.torch_convert import to_torch_state_dict
    cfg, _, variables, tmodel = models
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in to_torch_state_dict(variables["params"], cfg).items()}
    torch.save(sd, tmp_path / "full.bin")
    args = argparse.Namespace(model_size="tiny", seed=3,
                              version=str(tmp_path / "full.bin"))
    model = td.build_model(args, tmodel.cfg, torch.device("cpu"))
    assert "missing 0: []; mismatched 0: []" in capsys.readouterr().out
    want = tmodel.state_dict()
    for key, val in model.state_dict().items():
        assert torch.equal(val, want[key]), key
    name = "model.mm_projector.0.bias"
    sd[name] = torch.zeros(3)
    sd["model.not_a_layer.weight"] = torch.zeros(2)
    torch.save(sd, tmp_path / "odd.bin")
    args.version = str(tmp_path / "odd.bin")
    td.build_model(args, tmodel.cfg, torch.device("cpu"))
    out = capsys.readouterr().out
    assert "missing 1: ['model.not_a_layer.weight']" in out
    assert f"mismatched 1: [('{name}'" in out


@pytest.mark.parametrize("task", list(ENTRY_KEYS))
def test_main_synthetic_on_cpu(task, tmp_path):
    """`main --synthetic --model_size tiny --device cpu` for each task
    writes a pickle with the JAX driver's entries."""
    out = tmp_path / "preds.pkl"
    ret = td.main(["--task", task, "--synthetic", "--model_size", "tiny",
                   "--device", "cpu", "--output", str(out),
                   "--max_new_tokens", str(NEW)])
    with open(out, "rb") as f:
        preds = pickle.load(f)
    assert preds.keys() == ret.keys() and len(preds) >= 2
    entries = ([e for segs in preds.values() for e in segs.values()]
               if task == "anet" else list(preds.values()))
    for entry in entries:
        assert set(entry) == ENTRY_KEYS[task]


def test_yuv_on_an_odd_size_raises(tmp_path):
    """iground's YUV mode on an odd-sized source raises the decoder's
    ValueError (JAX asserts); the RGB mode serves one raw stack to both
    towers."""
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.data.synthetic import make_synthetic_howto_dataset
    ann, videos, _ = make_synthetic_howto_dataset(
        str(tmp_path), num_videos=1, num_frames=4, width=95, height=63)
    cfg = GroveConfig.tiny()
    with pytest.raises(ValueError, match="95x63"):
        td.FullClipIGroundDataset(ann, videos, cfg,
                                  device_preprocess="yuv")[0]
    s = td.FullClipIGroundDataset(ann, videos, cfg, device_preprocess=True)[0]
    assert s["frames_clip"] is s["frames_sam"]
    assert s["frames_clip"].shape == (4, 63, 95, 3)


# ---------------------------------------------------------------------------
# the port's mirrors of tests/test_infer_tasks.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_tiny():
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.models.grove import init_grove_params
    cfg = GroveConfig.tiny()
    return cfg, init_grove_params(cfg, device="cpu", dtype=torch.float32,
                                  seed=5)


def test_vidstg_infer_and_eval(port_tiny, tmp_path):
    from grove_tpu_torch.data.synthetic import make_synthetic_vidstg
    from grove_tpu_torch.evals.vidstg import evaluate_vidstg
    cfg, model = port_tiny
    ann_path, video_dir = make_synthetic_vidstg(str(tmp_path), num_videos=2,
                                                num_frames=12)
    ds = td.FullClipVidSTGDataset(ann_path, video_dir, cfg)
    outputs = td.run_caption_grounding(ds, model, cfg, MockTokenizer(),
                                       task="vidstg", progress=False)
    assert len(outputs) == 2
    for data in outputs.values():
        assert len(data["boxes"]) == len(data["frame_ids"])
        assert data["qtype"] in ("declarative", "interrogative")
    with open(ann_path) as f:
        anns = json.load(f)
    gt = {}
    for v in anns["videos"]:
        traj = anns["trajectories"][v["original_video_id"]]["1"]
        fids = outputs[str(v["video_id"])]["frame_ids"]
        boxes = []
        for fid in fids:
            rec = traj.get(str(fid))
            if rec:
                x, y, w, h = rec["bbox"]
                boxes.append([x, y, x + w, y + h])
            else:
                boxes.append([])
        gt[str(v["video_id"])] = {"frame_ids": fids, "boxes": boxes}
    metrics = evaluate_vidstg(outputs, gt)
    assert "declarative_gt_viou" in metrics
    assert "interrogative_gt_viou" in metrics


def test_pointing_infer_and_eval(port_tiny, tmp_path):
    from grove_tpu_torch.data.synthetic import make_synthetic_pointing
    from grove_tpu_torch.evals.pointing import pointing_accuracy
    cfg, model = port_tiny
    ann_path, video_dir, gt_data = make_synthetic_pointing(
        str(tmp_path), num_clips=2, num_frames=12)
    ds = td.FullClipPointingDataset(ann_path, video_dir, cfg)
    outputs = td.run_caption_grounding(ds, model, cfg, MockTokenizer(),
                                       task="groundingyoutube",
                                       progress=False)
    assert len(outputs) == 2
    for data in outputs.values():
        assert len(data["final_boxes"]) == 2
    for g in gt_data:
        g["segment_groundingyoutube_idx"] = g["segment_idx"]
    acc, correct, valid = pointing_accuracy(
        outputs, gt_data, segment_key="segment_groundingyoutube_idx")
    assert valid == 4
    assert 0.0 <= acc <= 100.0


def test_anet_infer_and_eval(port_tiny, tmp_path):
    from grove_tpu_torch.data.synthetic import make_synthetic_anet
    from grove_tpu_torch.evals.anet import (gen_grounding_f1,
                                            gt_localization_accuracy)
    cfg, model = port_tiny
    ann_path, video_dir, frame_ts = make_synthetic_anet(str(tmp_path))
    ds = td.FullClipANetDataset(ann_path, video_dir, frame_ts, cfg,
                                target_width=96)
    assert len(ds) == 2
    outputs = td.run_anet_inference(ds, model, cfg, MockTokenizer(),
                                    max_new_tokens=6, progress=False)
    assert len(outputs) == 2
    for segs in outputs.values():
        for data in segs.values():
            assert "clss" in data and "bbox_for_all_frames" in data
            for obj_boxes in data["bbox_for_all_frames"]:
                assert len(obj_boxes) == 10
    with open(ann_path) as f:
        ref = json.load(f)
    m = gt_localization_accuracy(outputs, ref)
    assert 0.0 <= m["localization_accuracy"] <= 1.0
    assert m["num_classes"] >= 1
    f1 = gen_grounding_f1(outputs, ref)
    assert set(f1) == {"precision_all", "recall_all", "f1_all"}


def test_anet_train_dataset(port_tiny, tmp_path):
    from grove_tpu_torch.data.datasets.anet_entities import (
        ActivityNetEntitiesDataset)
    from grove_tpu_torch.data.synthetic import make_synthetic_anet
    from grove_tpu_torch.data.video import open_video
    cfg, _ = port_tiny
    ann_path, video_dir, frame_ts = make_synthetic_anet(str(tmp_path))
    ds = ActivityNetEntitiesDataset(
        ann_path, video_dir, frame_ts, open_video,
        num_frames=cfg.num_frames, clip_size=cfg.clip.image_size,
        sam_size=cfg.sam_enc.img_size, max_phrases=cfg.max_phrases,
        validation=True, target_width=96)
    assert len(ds) == 2
    s = ds[0]
    assert s["frames_clip"].shape[0] == cfg.num_frames
    assert s["gt_boxes"].shape == (cfg.num_frames, cfg.max_phrases, 4)
    for (a, b), ph in zip(s["tokens_positive"], s["phrases"]):
        assert ph in s["caption"][a:b] or s["caption"][a:b] in ph \
            or ph in s["caption"]


# ---------------------------------------------------------------------------
# the port's mirrors of tests/test_run_experiment.py
# ---------------------------------------------------------------------------

def test_all_reference_tasks_offered():
    from grove_tpu.tools import run_experiment as jrun
    from grove_tpu_torch.tools.run_experiment import TASKS
    assert set(TASKS) == {"iground", "vidstg", "anet", "groundingyoutube",
                          "youcookinteractions"} == set(jrun.TASKS)
    assert set(td.TASKS) == set(TASKS)


def test_anet_dag_synthetic(tmp_path):
    from grove_tpu_torch.tools.run_experiment import main
    metrics = main(["--task", "anet", "--synthetic", "--model_size", "tiny",
                    "--device", "cpu", "--workdir", str(tmp_path),
                    "--max_new_tokens", "6"])
    assert metrics is not None
    assert 0.0 <= metrics["localization_accuracy"] <= 1.0
    assert {"precision_all", "recall_all", "f1_all"} <= set(metrics)
    assert (tmp_path / "anet_predictions.pkl").exists()


def test_pointing_dag_synthetic(tmp_path):
    from grove_tpu_torch.tools.run_experiment import main
    metrics = main(["--task", "groundingyoutube", "--synthetic",
                    "--model_size", "tiny", "--device", "cpu", "--workdir",
                    str(tmp_path)])
    assert metrics is not None
    assert 0.0 <= metrics["pointing_accuracy"] <= 100.0


def test_iground_dag_synthetic(tmp_path):
    from grove_tpu_torch.tools.run_experiment import main
    metrics = main(["--task", "iground", "--synthetic", "--model_size",
                    "tiny", "--device", "cpu", "--workdir", str(tmp_path),
                    "--max_new_tokens", "6"])
    assert {"AP", "mIoU_video", "recall_video", "CIDEr"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values()
               if isinstance(v, float))


def test_serve_module_help_runs():
    """`python -m grove_tpu_torch.serve --help` exits 0 with the server's
    flags."""
    out = subprocess.run([sys.executable, "-m", "grove_tpu_torch.serve",
                          "--help"], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--model_size" in out.stdout and "--device" in out.stdout
