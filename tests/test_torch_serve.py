"""The port's serving layer (`grove_tpu_torch.serve`) on a tiny fp32 model
on the CPU: the counterparts of `tests/test_serve.py` and
`tests/test_continuous.py`.

* `validate_payload` and `BatchingEngine._knob_key` give the JAX package's
  verdicts and keys over one table of payloads;
* HTTP: healthz, a round trip whose response equals `generate_batch`
  called directly, concurrent micro-batching, the error paths, unhashable
  knobs, a JSON null as the default, a bad request that does not poison
  its batch, beams with an int8 cache rejected, `pad_batches`;
* the continuous engine: staggered admissions give the tokens of an
  offline `greedy_decode` exactly, in the float and the int8 cache
  layouts, and those of the JAX package's `ContinuousEngine` on the same
  weights and schedule; capacity and free slots; a custom capacity; the service
  against the batch engine; the capacity check;
* `generate_with_backend` and `infer_clip(decode_backend=)` with a greedy
  backend equal `generate`; `server.build` from the command-line flags.

Every wait has its own timeout; every thread and server is closed in
teardown.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grove_tpu.serve import server as jserver  # noqa: E402
from grove_tpu_torch.api import GroveProcessor  # noqa: E402
from grove_tpu_torch.config import GroveConfig  # noqa: E402
from grove_tpu_torch.data.synthetic import _make_clip  # noqa: E402
from grove_tpu_torch.data.video import open_video  # noqa: E402
from grove_tpu_torch.infer.generate import greedy_decode  # noqa: E402
from grove_tpu_torch.models.grove import init_grove_params  # noqa: E402
from grove_tpu_torch.serve import server as tserver  # noqa: E402
from grove_tpu_torch.serve.continuous import (ContinuousEngine,  # noqa
                                              ContinuousService)
from grove_tpu_torch.text.mock_tokenizer import MockTokenizer  # noqa: E402
from grove_tpu_torch.text.packing import det_gather_positions  # noqa: E402
from test_torch_parity import TOL as PARITY_TOL  # noqa: E402
from test_torch_parity import models  # noqa: E402

assert models  # the module-scoped fixture of the parity tests

WAIT = 120            # seconds, every join and request
MAX_NEW = 6


@pytest.fixture(scope="module")
def model():
    return init_grove_params(GroveConfig.tiny(), device="cpu",
                             dtype=torch.float32, seed=0).eval()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    paths = []
    for i in range(3):
        p = str(root / f"clip{i}.npy")
        _make_clip(p, 6, 40, 32, 5.0, np.random.default_rng(i))
        paths.append(p)
    return paths


def _proc(model):
    return GroveProcessor(MockTokenizer(), model.cfg,
                          decoder_factory=open_video)


@pytest.fixture(scope="module")
def server(model, clips):
    srv, engine = tserver.serve(_proc(model), model, port=0, max_batch=4,
                                batch_timeout_ms=150.0,
                                model_name="grove-tiny")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address[:2]
    yield f"http://{host}:{port}", engine, clips
    srv.shutdown()
    srv.server_close()
    engine.close()
    t.join(WAIT)
    assert not t.is_alive() and not engine._thread.is_alive()


def _post(base, payload):
    req = urllib.request.Request(
        f"{base}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())


def _code(base, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, payload)
    return e.value.code


def _run_threads(fns):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)


# ---------------------------------------------------------------------------
# payload checks and knob keys against the JAX package
# ---------------------------------------------------------------------------

PAYLOADS = [
    {}, {"video_path": 3}, {"video_path": "a"},
    {"video_path": "a", "max_new_tokens": 0},
    {"video_path": "a", "max_new_tokens": 513},
    {"video_path": "a", "max_new_tokens": True},
    {"video_path": "a", "max_new_tokens": 8, "top_p": 1, "top_k": 0},
    {"video_path": "a", "temperature": 0.7, "seed": 3},
    {"video_path": "a", "temperature": 0.0, "seed": 3},
    {"video_path": "a", "temperature": None, "top_p": None},
    {"video_path": "a", "top_k": True},
    {"video_path": "a", "top_k": [1, 2]},
    {"video_path": "a", "top_k": 5},
    {"video_path": "a", "temperature": 1, "top_k": 5, "top_p": 0.9},
    {"video_path": "a", "top_p": 0.0, "temperature": 1.0},
    {"video_path": "a", "temperature": -1.0},
    {"video_path": "a", "num_beams": 2, "kv_cache_dtype": "int8"},
    {"video_path": "a", "num_beams": 2, "temperature": 0.5},
    {"video_path": "a", "num_beams": 17},
    {"video_path": "a", "num_beams": 4, "length_penalty": 2},
    {"video_path": "a", "kv_cache_dtype": "int4"},
    {"video_path": "a", "kv_cache_dtype": "bf16", "early_stop": False},
    {"video_path": "a", "early_stop": 1},
    {"video_path": "a", "instruction": 5},
    {"video_path": "a", "instruction": "describe",
     "temp_objectness_threshold": 0.3},
]


def _verdict(fn, payload):
    try:
        fn(payload)
    except ValueError:
        return "ValueError"
    return "ok"


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_payload_verdicts_and_keys_equal_jax(i):
    payload = PAYLOADS[i]
    got = _verdict(tserver.validate_payload, payload)
    assert got == _verdict(jserver.validate_payload, payload)
    if got == "ok":
        assert (tserver.BatchingEngine._knob_key(payload)
                == jserver.BatchingEngine._knob_key(payload))


# ---------------------------------------------------------------------------
# HTTP and the batching engine
# ---------------------------------------------------------------------------

def test_healthz(server):
    base, _, _ = server
    with urllib.request.urlopen(f"{base}/healthz", timeout=WAIT) as r:
        out = json.loads(r.read())
    assert out["status"] == "ok" and out["model"] == "grove-tiny"
    assert {"batches_run", "requests_served"} <= set(out)


def test_roundtrip_equals_generate_batch(server, model):
    base, _, clips = server
    out = _post(base, {"video_path": clips[0], "max_new_tokens": 4})
    want = _proc(model).generate_batch(model, [clips[0]], max_new_tokens=4)
    assert out == tserver._jsonable(want[0])
    assert len(out["bboxes"]) == len(out["frame_indices"])
    beams = _post(base, {"video_path": clips[0], "max_new_tokens": 4,
                         "num_beams": 2})
    want = _proc(model).generate_batch(model, [clips[0]], max_new_tokens=4,
                                       num_beams=2)
    assert beams == tserver._jsonable(want[0])


def test_concurrent_requests_micro_batch(server):
    _, engine, clips = server
    before = engine.batches_run, engine.requests_served
    results, errors = [None] * 4, []

    def call(i):
        try:
            results[i] = engine.submit({"video_path": clips[i % 3],
                                        "max_new_tokens": 4}, timeout=WAIT)
        except Exception as e:                            # noqa: BLE001
            errors.append(e)
    _run_threads([lambda i=i: call(i) for i in range(4)])
    assert not errors and all(r is not None for r in results)
    assert engine.requests_served - before[1] == 4
    assert engine.batches_run - before[0] <= 3


def test_error_paths(server):
    base, _, clips = server
    assert _code(base, {}) == 400
    assert _code(base, {"video_path": clips[0],
                        "kv_cache_dtype": "int4"}) == 400
    assert _code(base, {"video_path": "/nonexistent/clip.npy"}) in (400,
                                                                    500)
    req = urllib.request.Request(f"{base}/nowhere", data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=WAIT)
    assert e.value.code == 404


def test_batcher_survives_unhashable_knobs(server):
    base, _, clips = server
    assert _code(base, {"video_path": clips[0], "top_k": [1, 2],
                        "max_new_tokens": 4}) in (400, 500)
    out = _post(base, {"video_path": clips[0], "max_new_tokens": 4})
    assert isinstance(out["text"], str)


def test_json_null_knob_is_default(server):
    base, _, clips = server
    ref = _post(base, {"video_path": clips[0], "max_new_tokens": 4})
    out = _post(base, {"video_path": clips[0], "max_new_tokens": 4,
                       "temperature": None, "top_p": None})
    assert out["text"] == ref["text"]


def test_bad_request_does_not_poison_batch(server):
    base, _, clips = server
    results = {}

    def call(name, payload):
        try:
            results[name] = ("ok", _post(base, payload))
        except urllib.error.HTTPError as e:
            results[name] = ("err", e.code)
    _run_threads([
        lambda: call("good", {"video_path": clips[0], "max_new_tokens": 4}),
        lambda: call("bad", {"video_path": "/nonexistent.npy",
                             "max_new_tokens": 4})])
    assert results["good"][0] == "ok" and results["bad"][0] == "err"


def test_beams_with_int8_rejected(server):
    base, _, clips = server
    assert _code(base, {"video_path": clips[0], "num_beams": 2,
                        "kv_cache_dtype": "int8"}) == 400


def test_pad_batches_pads_to_max_and_trims():
    calls = []

    class StubProcessor:
        def generate_batch(self, model, paths, instructions=None, **kw):
            calls.append((list(paths), instructions))
            return [{"text": f"out:{p}"} for p in paths]

    engine = tserver.BatchingEngine(StubProcessor(), None, max_batch=4,
                                    pad_batches=True)
    try:
        group = [tserver._Pending({"video_path": "a.npy"}),
                 tserver._Pending({"video_path": "b.npy",
                                   "instruction": "describe"})]
        engine._run_group(group)
        paths, instructions = calls[0]
        assert paths == ["a.npy", "b.npy", "b.npy", "b.npy"]
        assert instructions == [None, "describe", "describe", "describe"]
        assert group[0].result == {"text": "out:a.npy"}
        assert group[1].result == {"text": "out:b.npy"}
        assert all(p.event.is_set() for p in group)
        calls.clear()
        engine._run_group([tserver._Pending({"video_path": f"{i}.npy"})
                           for i in range(4)])
        assert len(calls[0][0]) == 4
    finally:
        engine.close()
    assert not engine._thread.is_alive()


# ---------------------------------------------------------------------------
# the continuous engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def requests(model):
    cfg = model.cfg
    rng = np.random.default_rng(7)
    nv, t = cfg.num_video_tokens, cfg.num_frames
    hw = cfg.sam_enc.grid ** 2

    def make(extra):
        ids = rng.integers(3, 100, size=(nv + 4 + extra,))
        ids[2:2 + nv] = 0
        return {"ids": ids, "vstart": 2,
                "ve": torch.from_numpy(rng.normal(
                    size=(1, nv, cfg.llama.hidden_size)).astype(np.float32)),
                "img": torch.from_numpy(rng.normal(
                    size=(t, hw, cfg.sam_dec.embed_dim)).astype(np.float32))}
    return [make(k) for k in (0, 3, 7)]


def _offline(model, req, cache_dtype):
    cfg = model.cfg
    gen, hidden = greedy_decode(model, req["ids"][None], req["ve"],
                                [req["vstart"]], max_new_tokens=MAX_NEW,
                                eos_id=cfg.tokens.eos, pad_id=cfg.tokens.pad,
                                cache_dtype=cache_dtype, early_exit=False)
    gen = gen[0].numpy()
    det, _ = det_gather_positions(np.concatenate([req["ids"], gen]),
                                  cfg.tokens.det, cfg.max_phrases)
    with torch.inference_mode():
        boxes, _ = model.ground(hidden, torch.from_numpy(det[None]),
                                req["img"])
    return gen, boxes[0].numpy()


def _admit(eng, rid, req):
    return eng.admit(rid, req["ids"], req["ve"], req["vstart"], req["img"])


def _check_offline(model, eng, reqs, cache_dtype):
    for rid, req in enumerate(reqs):
        res = eng.pop_result(rid)
        assert res is not None, rid
        ref_gen, ref_boxes = _offline(model, req, cache_dtype)
        steps = res["steps"]
        np.testing.assert_array_equal(res["generated_ids"], ref_gen[:steps],
                                      err_msg=f"request {rid}")
        assert np.all(ref_gen[steps:] == model.cfg.tokens.pad)
        np.testing.assert_allclose(res["pred_boxes"], ref_boxes, rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.int8])
def test_staggered_admissions_match_offline(model, requests, cache_dtype):
    eng = ContinuousEngine(model, model.cfg, n_slots=2,
                           max_new_tokens=MAX_NEW, prompt_bucket=16,
                           cache_dtype=cache_dtype)
    _admit(eng, 0, requests[0])
    for _ in range(2):
        eng.tick()                                  # r0 mid-decode
    _admit(eng, 1, requests[1])                     # joins the loop
    finished = eng.run_until_idle()
    _admit(eng, 2, requests[2])                     # after the rewind
    finished += eng.run_until_idle()
    assert sorted(finished) == [0, 1, 2]
    _check_offline(model, eng, requests, cache_dtype)


def _staggered(eng, admit):
    """Request 0, two ticks, request 1 joins; after the rewind, request
    2. Returns the finished request ids in order."""
    admit(eng, 0)
    for _ in range(2):
        eng.tick()
    admit(eng, 1)
    finished = eng.run_until_idle()
    admit(eng, 2)
    return finished + eng.run_until_idle()


@pytest.mark.parametrize("layout", ["float", "int8"])
def test_staggered_admissions_match_jax_engine(models, requests, layout):
    """The JAX package's ContinuousEngine and the port's on the same tiny
    fp32 weights and the same staggered schedule: identical tokens and
    steps, boxes and objectness within the parity tolerance.

    The int8 layout takes 128-column prompt buckets: the JAX engine
    writes the whole (1, H, Cpad, D) prefill slab, padded to 128 columns,
    with `dynamic_update_slice` at column col - Lb, which clamps the start
    where col - Lb + Cpad passes the cache's width; under a bucket off a
    multiple of 128 its slab then lands at the wrong columns and it leaves
    its own offline `greedy_decode` (ROADMAP "Known faults"). The port
    copies the Lb columns alone (`test_staggered_admissions_match_offline`
    holds it at 16-column buckets)."""
    import jax.numpy as jnp

    from grove_tpu.serve.continuous import ContinuousEngine as JaxEngine
    cfg, jmodel, variables, tmodel = models
    jdtype, tdtype, bucket = {"float": (jnp.float32, torch.float32, 16),
                              "int8": (jnp.int8, torch.int8, 128)}[layout]
    kw = dict(n_slots=2, max_new_tokens=MAX_NEW, prompt_bucket=bucket)
    jeng = JaxEngine(jmodel, variables, cfg, cache_dtype=jdtype, **kw)
    teng = ContinuousEngine(tmodel, tmodel.cfg, cache_dtype=tdtype, **kw)
    want_order = _staggered(jeng, lambda e, r: e.admit(
        r, requests[r]["ids"], jnp.asarray(requests[r]["ve"].numpy()),
        requests[r]["vstart"], jnp.asarray(requests[r]["img"].numpy())))
    got_order = _staggered(teng, lambda e, r: _admit(e, r, requests[r]))
    assert got_order == want_order and sorted(got_order) == [0, 1, 2]
    for rid in range(len(requests)):
        want, got = jeng.pop_result(rid), teng.pop_result(rid)
        assert want is not None and got is not None, rid
        assert got["steps"] == want["steps"]
        for key in ("generated_ids", "full_ids", "phrase_mask"):
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"request {rid} {key}")
        for key in ("pred_boxes", "objectness_logits"):
            np.testing.assert_allclose(got[key], want[key], rtol=PARITY_TOL,
                                       atol=PARITY_TOL,
                                       err_msg=f"request {rid} {key}")


def test_capacity_and_free_slots(model, requests):
    eng = ContinuousEngine(model, model.cfg, n_slots=1,
                           max_new_tokens=MAX_NEW, prompt_bucket=16,
                           cache_dtype=torch.float32)
    assert eng.capacity == model.cfg.spliced_seq_len + 4 * MAX_NEW
    assert eng.free_slots() == [0]
    _admit(eng, 0, requests[0])
    assert not eng.free_slots()
    with pytest.raises(RuntimeError):
        _admit(eng, 1, requests[1])
    eng.run_until_idle()
    assert eng.free_slots() == [0] and eng.col == eng.start_col


def test_custom_capacity_matches_offline(model, requests):
    cap = 32 + 4 * MAX_NEW                  # prompt bucket + horizon
    eng = ContinuousEngine(model, model.cfg, n_slots=2,
                           max_new_tokens=MAX_NEW, prompt_bucket=16,
                           cache_dtype=torch.float32, capacity=cap)
    assert eng.capacity == cap and eng.col == cap - 4 * MAX_NEW
    for rid, req in enumerate(requests):
        if not eng.free_slots():
            eng.run_until_idle()
        _admit(eng, rid, req)
    eng.run_until_idle()
    _check_offline(model, eng, requests, torch.float32)


def test_capacity_without_admission_window_raises(model):
    """The JAX engine accepts capacity <= 4 * max_new_tokens and then
    fails every admission (`grove_tpu/serve/continuous.py:116`); the port
    raises when the engine is built."""
    for cap in (4 * MAX_NEW, 4 * MAX_NEW - 1):
        with pytest.raises(ValueError, match="admission window"):
            ContinuousEngine(model, model.cfg, max_new_tokens=MAX_NEW,
                             capacity=cap)
    ContinuousEngine(model, model.cfg, max_new_tokens=MAX_NEW,
                     capacity=4 * MAX_NEW + 1)


def test_service_matches_batch_engine(model, clips):
    proc = _proc(model)
    batch = tserver.BatchingEngine(proc, model)
    svc = ContinuousService(proc, model, n_slots=2, max_new_tokens=MAX_NEW,
                            prompt_bucket=16)
    try:
        want = [batch.submit({"video_path": c, "max_new_tokens": MAX_NEW},
                             timeout=WAIT) for c in clips[:2]]
        got = [None, None]

        def run(i):
            got[i] = svc.submit({"video_path": clips[i],
                                 "max_new_tokens": MAX_NEW}, timeout=WAIT)
        _run_threads([lambda i=i: run(i) for i in range(2)])
        for w, g in zip(want, got):
            assert g is not None and g["text"] == w["text"]
            assert g["frame_indices"] == w["frame_indices"]
            for a, b in zip(g["bboxes"], w["bboxes"]):
                np.testing.assert_allclose(np.asarray(a, np.float32),
                                           np.asarray(b, np.float32),
                                           rtol=2e-3, atol=2e-3)
        assert svc.requests_served == 2 and svc.batches_run >= MAX_NEW
        with pytest.raises(ValueError, match="greedy decode only"):
            svc.submit({"video_path": clips[0], "temperature": 0.7})
        with pytest.raises(ValueError, match="admission window"):
            small = ContinuousService(proc, model, max_new_tokens=MAX_NEW,
                                      prompt_bucket=16,
                                      capacity=16 + 4 * MAX_NEW)
            try:
                small.submit({"video_path": clips[0]}, timeout=WAIT)
            finally:
                small.close()
    finally:
        svc.close()
        batch.close()
    assert not svc._thread.is_alive() and not batch._thread.is_alive()


# ---------------------------------------------------------------------------
# the decode backend and the command line
# ---------------------------------------------------------------------------

def test_generate_with_backend_equals_generate(model, clips):
    from grove_tpu_torch.infer.generate import generate_grounded
    from grove_tpu_torch.infer.sliding import infer_clip
    proc = _proc(model)
    seen = []

    def backend(spliced_ids, video_start, fc, fs):
        seen.append((len(spliced_ids), tuple(fc.shape)))
        return generate_grounded(model, model.cfg, proc.tokenizer,
                                 spliced_ids[None], [video_start], fc, fs,
                                 max_new_tokens=MAX_NEW)
    want = proc.generate(model, clips[1], instruction="describe it",
                         max_new_tokens=MAX_NEW)
    got = proc.generate_with_backend(model, clips[1], backend,
                                     instruction="describe it")
    assert tserver._jsonable(got) == tserver._jsonable(want)
    s = proc._sample(clips[1])
    direct = infer_clip(model, model.cfg, proc.tokenizer, s["frames_clip"],
                        s["frames_sam"], s["original_size"],
                        instruction="describe it", decode_backend=backend)
    assert tserver._jsonable(direct) == tserver._jsonable(want)
    assert seen[0][1][:2] == (1, model.cfg.num_frames)


def test_build_from_flags(tmp_path, models):
    """`server.build` from flags: the batch and continuous servers answer
    /healthz; `--version` serves a model directory the JAX package's
    `save_pretrained` wrote (its weights as the port loads a JAX tree: the
    exported state, the ConvTranspose kernels flipped)."""
    from grove_tpu.api.model import GroveForCausalLM as JaxLM
    from test_torch_region import UPSCALING, flip_conv_transpose
    cfg, jmodel, variables, tmodel = models
    jax_dir = tmp_path / "jax"
    JaxLM(cfg, jmodel, variables).save_pretrained(str(jax_dir))
    for extra in ([], ["--continuous", "--n_slots", "2"],
                  ["--version", str(jax_dir)]):
        srv, engine = tserver.build(["--model_size", "tiny", "--device",
                                     "cpu", "--port", "0"] + extra)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            host, port = srv.server_address[:2]
            with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                        timeout=WAIT) as r:
                out = json.loads(r.read())
            assert out["model"] == ("grove-tiny-continuous"
                                    if "--continuous" in extra
                                    else "grove-tiny")
            if "--version" in extra:
                want = tmodel.state_dict()
                flipped = flip_conv_transpose(
                    {k: want[k].numpy() for k in UPSCALING})
                got = engine.model.state_dict()
                assert set(got) == set(want)
                for k, v in want.items():
                    v = torch.from_numpy(flipped[k]) if k in flipped else v
                    assert torch.equal(got[k], v.to(got[k].dtype)), k
        finally:
            srv.shutdown()
            srv.server_close()
            engine.close()
            t.join(WAIT)
        assert not t.is_alive()
    # a model file cut short raises, naming the file
    (jax_dir / "flax_model.msgpack").write_bytes(b"\x81")
    with pytest.raises(ValueError, match="flax_model.msgpack: truncated"):
        tserver.build(["--model_size", "tiny", "--device", "cpu",
                       "--version", str(jax_dir)])
