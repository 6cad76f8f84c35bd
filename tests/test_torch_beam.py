"""Beam search in the port (`grove_tpu_torch.infer.beam`) against the JAX
package's `beam_decode` at `GroveConfig.tiny()` in fp32, on the same
weights (the parity tests' fixture).

* ids identical, scores within 1e-5, the winner's hidden states within
  2e-3, with `early_exit` on and off; `num_beams=1` equals greedy;
* a beam that emits EOS is frozen (pad after it), with EOS forced to a
  token the model generates early;
* a left-padded batch equals the per-sample runs;
* scores are the exact sums of the teacher-forced log-probs;
* an int8 cache raises the JAX error;
* `generate_grounded(num_beams=2)`: ids identical, boxes and objectness
  within 2e-3 of JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grove_tpu.infer import beam as jbeam  # noqa: E402
from grove_tpu.infer import generate as jgen  # noqa: E402
from grove_tpu.text.mock_tokenizer import MockTokenizer  # noqa: E402
from grove_tpu_torch.infer import beam as tbeam  # noqa: E402
from grove_tpu_torch.infer import generate as tgen  # noqa: E402
from test_torch_parity import (_close, _frames, _prompt,  # noqa: E402
                               models)

assert models  # the module-scoped fixture of the parity tests

SCORE_TOL = 1e-5
HIDDEN_TOL = 2e-3
MAX_NEW = 6


def _inputs(cfg, seed, b=2):
    ids, vs, feats = _prompt(cfg, np.random.default_rng(seed), b)
    return ids, vs, feats


def _jax_beam(models, ids, vs, feats, **kw):
    cfg, jmodel, variables, _ = models
    kw.setdefault("max_new_tokens", MAX_NEW)
    kw.setdefault("eos_id", cfg.tokens.eos)
    ids_j, hid, scores = jbeam.beam_decode(
        jmodel, variables, jnp.asarray(ids, jnp.int32), jnp.asarray(feats),
        jnp.asarray(vs, jnp.int32), cache_dtype=jnp.float32, **kw)
    return np.asarray(ids_j), np.asarray(hid), np.asarray(scores)


def _port_beam(models, ids, vs, feats, **kw):
    cfg, _, _, tmodel = models
    kw.setdefault("max_new_tokens", MAX_NEW)
    kw.setdefault("eos_id", cfg.tokens.eos)
    got = tbeam.beam_decode(tmodel, ids, torch.from_numpy(feats), vs,
                            cache_dtype=torch.float32, **kw)
    return tuple(t.numpy() for t in got)


def _forced_eos(models, ids, vs, feats):
    """A token the model emits second in a greedy decode of row 0."""
    cfg, _, _, tmodel = models
    g, _ = tgen.greedy_decode(tmodel, ids, torch.from_numpy(feats), vs,
                              max_new_tokens=MAX_NEW, eos_id=cfg.tokens.eos,
                              cache_dtype=torch.float32)
    return int(g[0, 1])


@pytest.mark.parametrize("early_exit", [True, False])
def test_beam_matches_jax(models, early_exit):
    ids, vs, feats = _inputs(models[0], 21)
    want = _jax_beam(models, ids, vs, feats, num_beams=3,
                     early_exit=early_exit)
    got = _port_beam(models, ids, vs, feats, num_beams=3,
                     early_exit=early_exit)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=HIDDEN_TOL,
                               atol=HIDDEN_TOL)


def test_beam1_equals_greedy(models):
    cfg, _, _, tmodel = models
    ids, vs, feats = _inputs(cfg, 22)
    g, hg = tgen.greedy_decode(tmodel, ids, torch.from_numpy(feats), vs,
                               max_new_tokens=MAX_NEW, eos_id=cfg.tokens.eos,
                               cache_dtype=torch.float32, early_exit=False)
    b1, hb, _ = _port_beam(models, ids, vs, feats, num_beams=1)
    np.testing.assert_array_equal(b1, g.numpy())
    np.testing.assert_allclose(hb, hg.numpy(), rtol=1e-5, atol=1e-5)


def test_eos_freezes_a_beam_and_early_exit_equals_the_scan(models):
    cfg = models[0]
    ids, vs, feats = _inputs(cfg, 23)
    eos = _forced_eos(models, ids, vs, feats)
    want = _jax_beam(models, ids, vs, feats, num_beams=2, eos_id=eos)
    got = _port_beam(models, ids, vs, feats, num_beams=2, eos_id=eos)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    assert (got[0] == eos).any()
    for row in got[0].tolist():
        if eos in row:
            assert all(t == cfg.tokens.pad
                       for t in row[row.index(eos) + 1:]), row
    scan = _port_beam(models, ids, vs, feats, num_beams=2, eos_id=eos,
                      early_exit=False)
    np.testing.assert_array_equal(scan[0], got[0])
    np.testing.assert_array_equal(scan[2], got[2])


def test_left_padded_batch_equals_per_sample(models):
    cfg = models[0]
    nv = cfg.num_video_tokens
    rng = np.random.default_rng(24)
    base = rng.integers(3, 100, size=(nv + 8,))
    base[0] = cfg.tokens.bos
    base[2:2 + nv] = 0
    prompts = [base.tolist(), base[:nv + 5].tolist()]
    pids, pvs, plens = tgen.left_pad_prompts(prompts, [2, 2])
    feats = rng.normal(size=(2, nv, cfg.llama.hidden_size)).astype(
        np.float32)
    kw = dict(num_beams=3, max_new_tokens=4)
    want = _jax_beam(models, pids, pvs, feats, pad_lens=plens, **kw)
    got = _port_beam(models, pids, pvs, feats, pad_lens=plens, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    for i, p in enumerate(prompts):
        one = _port_beam(models, np.asarray([p]), np.asarray([2]),
                         feats[i:i + 1], **kw)
        assert got[0][i].tolist() == one[0][0].tolist(), i


def test_scores_are_exact_logprob_sums(models):
    cfg, _, _, tmodel = models
    ids, vs, feats = _inputs(cfg, 25, b=1)
    best, _, scores = _port_beam(models, ids, vs, feats, num_beams=1,
                                 max_new_tokens=4)
    full = np.concatenate([ids[0], best[0]])[None]
    with torch.inference_mode():
        _, logits = tmodel.lm_forward(torch.from_numpy(full),
                                      torch.from_numpy(feats), vs)
    logits = logits[0].double().numpy()
    ls, lp_sum, n = ids.shape[1], 0.0, 0
    for s, tok in enumerate(best[0]):
        if tok == cfg.tokens.pad:
            break
        row = logits[ls - 1 + s] - logits[ls - 1 + s].max()
        lp_sum += row[tok] - np.log(np.exp(row).sum())
        n += 1
    assert abs(float(scores[0, 0]) - lp_sum / max(n, 1)) < 2e-5


def test_int8_cache_raises(models):
    cfg, _, _, tmodel = models
    ids, vs, feats = _inputs(cfg, 26)
    with pytest.raises(ValueError, match="reorderable KV cache"):
        tbeam.beam_decode(tmodel, ids, torch.from_numpy(feats), vs,
                          max_new_tokens=2, eos_id=2, num_beams=2,
                          cache_dtype=torch.int8)


def test_generate_grounded_beams_match_jax(models):
    cfg, jmodel, variables, tmodel = models
    tok = MockTokenizer()
    rng = np.random.default_rng(27)
    fc, fs = _frames(cfg, rng, 2)
    ids, vs, _ = _prompt(cfg, rng, 2)
    want = jgen.generate_grounded(
        jmodel, variables, cfg, tok, ids.astype(np.int32),
        vs.astype(np.int32), jnp.asarray(fc), jnp.asarray(fs),
        max_new_tokens=MAX_NEW, num_beams=2, cache_dtype=jnp.float32)
    got = tgen.generate_grounded(
        tmodel, tmodel.cfg, tok, ids, vs, torch.from_numpy(fc),
        torch.from_numpy(fs), max_new_tokens=MAX_NEW, num_beams=2,
        cache_dtype=torch.float32)
    np.testing.assert_array_equal(got["generated_ids"],
                                  want["generated_ids"])
    np.testing.assert_array_equal(got["det_positions"],
                                  want["det_positions"])
    _close(got["pred_boxes"], want["pred_boxes"])
    _close(got["objectness_logits"], want["objectness_logits"])
    assert got["parsed"] == want["parsed"]
