"""Seeded sampling in the port (`grove_tpu_torch.infer.generate`) against the
JAX package's sampler (`grove_tpu/infer/generate.py:_make_sampler`).

* The filter and the Gumbel-max draw on fp32 logits, JAX's own noise
  (`gumbel(fold_in(key, step), (B, V), float32)`, what `jax.random.
  categorical` adds) fed to the port through `_noise`: identical tokens over
  a grid of temperature, top-k and top-p, on logits with many ties. No
  `cum - probs` of JAX's nucleus lies within 1e-6 of `top_p`, so that the
  order of a reduction cannot decide a case.
* `greedy_decode` sampling at `GroveConfig.tiny()` in fp32, JAX's noise fed
  step by step: identical ids, hidden states within 2e-3.
* The same seed gives the same tokens under a `torch.Generator`; 20 000
  draws at a fixed seed pass a chi-square test against
  softmax(filter_logits(...)).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.infer import generate as jgen  # noqa: E402
from grove_tpu_torch.infer import generate as tgen  # noqa: E402
from test_torch_parity import _prompt, models  # noqa: E402

assert models  # the module-scoped fixture of the parity tests

HIDDEN_TOL = 2e-3
MARGIN = 1e-6
B, V, STEPS = 4, 96, 6


def _jax_noise(key, b, v):
    return lambda step: np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, step), (b, v), jnp.float32))


def _logits(seed):
    """Rows of plain normal logits, and rows rounded to halves (many
    ties, ties at the k-th value included) below a unique top logit (two
    tied tops would put `cum - probs` at exactly top_p = 0.5)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, V)).astype(np.float32) * 2
    x[B // 2:] = np.round(x[B // 2:] * 2) / 2
    rows = np.arange(B // 2, B)
    x[rows, x[rows].argmax(-1)] += 0.25
    return x


def _nucleus_margin(logits, temperature, top_k, top_p):
    """min |cum - probs - top_p| of JAX's own nucleus arithmetic, past the
    top token (always kept, its cum - probs is 0)."""
    l = jnp.asarray(logits) / temperature
    if top_k > 0:
        kth = jax.lax.top_k(l, top_k)[0][..., -1:]
        l = jnp.where(l < kth, -jnp.inf, l)
    probs = jax.nn.softmax(jnp.sort(l, axis=-1)[..., ::-1], axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    return float(jnp.min(jnp.abs(cum - probs - top_p)[..., 1:]))


@pytest.mark.parametrize("top_p", [1e-6, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("top_k", [0, 1, 5, V])
@pytest.mark.parametrize("temperature", [0.3, 1.0, 2.0])
def test_filter_and_draw_match_jax(temperature, top_k, top_p):
    pick = jgen._make_sampler(temperature, top_k, top_p)
    key = jax.random.PRNGKey(int(temperature * 10) + top_k)
    for seed in range(2):
        logits = _logits(seed)
        if top_p < 1.0:
            assert _nucleus_margin(logits, temperature, top_k,
                                   top_p) > MARGIN
        noise = _jax_noise(key, B, V)
        for step in range(STEPS):
            want = np.asarray(pick(jnp.asarray(logits), key, step))
            got = tgen.next_tokens(torch.from_numpy(logits), step,
                                   temperature, top_k, top_p, _noise=noise)
            np.testing.assert_array_equal(got.numpy(), want)
        # every pick lies in the filtered support
        kept = torch.isfinite(tgen.filter_logits(torch.from_numpy(logits),
                                                 temperature, top_k, top_p))
        assert bool(kept.gather(1, got[:, None]).all())


def test_filter_support_matches_jax_rules():
    """top-k keeps ties with the k-th value; top-p always keeps the top
    token and thresholds at the smallest kept logit."""
    l = torch.tensor([[3.0, 1.0, 1.0, 1.0, -2.0]])
    kept = torch.isfinite(tgen.filter_logits(l, 1.0, top_k=2))
    assert kept.tolist() == [[True, True, True, True, False]]
    kept = torch.isfinite(tgen.filter_logits(l, 1.0, top_p=1e-6))
    assert kept.tolist() == [[True, False, False, False, False]]
    assert torch.isfinite(tgen.filter_logits(l, 0.5, top_k=9)).all()
    g = tgen.gumbel_noise((1000, 64), torch.Generator().manual_seed(3),
                          "cpu")
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("knobs,left_pad", [
    ((0.8, 20, 0.9), False), ((1.3, 0, 1.0), True), ((0.5, 5, 1.0), False)])
def test_greedy_decode_sampling_matches_jax(models, knobs, left_pad):
    cfg, jmodel, variables, tmodel = models
    temperature, top_k, top_p = knobs
    ids, vs, feats = _prompt(cfg, np.random.default_rng(11), 2)
    pad = None
    if left_pad:
        pad = np.array([0, 3], np.int64)
        ids[1, :3] = cfg.tokens.pad
        ids[1, 3] = cfg.tokens.bos
        vs[1] += 3
    key = jax.random.PRNGKey(5)
    kw = dict(max_new_tokens=8, eos_id=cfg.tokens.eos, pad_id=cfg.tokens.pad,
              early_exit=False, temperature=temperature, top_k=top_k,
              top_p=top_p)
    want_ids, want_hidden = jgen.greedy_decode(
        jmodel, variables, jnp.asarray(ids, jnp.int32), jnp.asarray(feats),
        jnp.asarray(vs, jnp.int32), cache_dtype=jnp.float32, rng_key=key,
        pad_lens=pad, **kw)
    v = cfg.llama.padded_vocab_size
    got_ids, got_hidden = tgen.greedy_decode(
        tmodel, ids, torch.from_numpy(feats), vs, cache_dtype=torch.float32,
        pad_lens=pad, _noise=_jax_noise(key, 2, v), **kw)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_hidden.numpy(), np.asarray(want_hidden),
                               rtol=HIDDEN_TOL, atol=HIDDEN_TOL)


def test_same_seed_same_tokens(models):
    from grove_tpu_torch.api.processor import _decode_kwargs
    cfg, _, _, tmodel = models
    ids, vs, feats = _prompt(cfg, np.random.default_rng(12), 2)
    kw = dict(max_new_tokens=8, eos_id=cfg.tokens.eos,
              cache_dtype=torch.float32, temperature=1.5, top_k=40,
              top_p=0.95)

    def run(seed):
        g = _decode_kwargs(None, True, 1.5, 40, 0.95, seed)["generator"]
        return tgen.greedy_decode(tmodel, ids, torch.from_numpy(feats), vs,
                                  generator=g, **kw)[0]
    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # no generator: seed 0, as JAX's PRNGKey(0) default
    d = tgen.greedy_decode(tmodel, ids, torch.from_numpy(feats), vs, **kw)[0]
    assert torch.equal(d, run(0))
    # a seed without sampling is dropped
    assert "generator" not in _decode_kwargs(None, True, 0.0, 0, 1.0, 3)


def test_draws_follow_the_filtered_softmax():
    """20 000 draws of one row at a fixed seed: chi-square against
    softmax(filter_logits(...)) over the support, p > 1e-3."""
    from scipy import stats
    logits = torch.from_numpy(_logits(4)[:1])
    n = 20_000
    f = tgen.filter_logits(logits, 0.7, 12, 0.9)[0]
    support = torch.isfinite(f)
    probs = torch.softmax(f.double(), -1)[support].numpy()
    toks = tgen.next_tokens(logits.expand(n, -1), 0, 0.7, 12, 0.9,
                            generator=torch.Generator().manual_seed(0))
    counts = torch.bincount(toks, minlength=V)
    assert int(counts[~support].sum()) == 0
    chi2, p = stats.chisquare(counts[support].numpy(), probs * n)
    assert int(support.sum()) >= 3 and p > 1e-3, (chi2, p)
