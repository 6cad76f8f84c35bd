"""The launch plans and the arithmetic of K7c (`int4_requant_int8`,
`csrc/int4_requant.cu`) and K8c (`add_rmsnorm_quant_dyn`,
`csrc/rmsnorm_quant.cu`) on the CPU.

K7c: `ops.int4_matmul._requant_plan` sizes the launch of persistent CTAs
over tiles of 128 (or 64) packed rows of one super-group by 128 (or a
last 64) columns. Checked at every int4 LLaMA projection of `GroveConfig()`,
`small()` and `tiny()`, the fused widths and the edges `chip_smoke.py`
holds the kernel at: the tiles cover the (K/2, N) bytes once, each inside
one super-group; the CTAs walk every tile once; a CTA fits 227 KB of shared
memory. A numpy model of the kernel body (`_requant_model`: the 16-byte
copies into the swizzled stage, the nibble planes by LOP3 and dp2a, the
PRMT gather that transposes 4 x 4 bytes, the swizzled staging tile, the
128-byte runs, tile by tile in each CTA's order) writes every output byte
exactly once and is bit-equal to the Pallas `int4_requant_int8` in
interpret mode and to `int4_requant_int8_torch`.

K8c: `ops.fused_ln._rms_plan` takes each row once and fits shared memory;
a torch model of the kernel's reduction order (`_rms_model`: each thread's
sum of squares over its 16-byte pieces, interleaved across the block, in
element order, a warp's by a butterfly of shuffles, the warps' in
warp order) lies within
the stated tolerances of the Pallas `add_rmsnorm_quant_dyn` (int8 at most
1 LSB off on at most 0.1%, sx within 1e-6 relative, the residual sum
bit-equal), in fp32 and bf16, with and without the residual.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grove_tpu.ops import fused_ln as jfln  # noqa: E402
from grove_tpu.ops import int4_matmul as jint4  # noqa: E402
from grove_tpu_torch.config import GroveConfig  # noqa: E402
from grove_tpu_torch.ops import fused_ln as tfln  # noqa: E402
from grove_tpu_torch.ops import int4_matmul as tint4  # noqa: E402
from grove_tpu_torch.ops.quant import int4_group  # noqa: E402

SMS = 132                    # an H100's SMs
SMEM_227KB = 232448          # shared bytes a block can use on sm_90
SMEM_SM = 233472             # shared bytes an SM holds
LSB_SHARE = 1e-3             # K8c: int8 outputs 1 LSB apart on at most 0.1%
SX_TOL = 1e-6                # K8c: per-token scales, relative

CONFIGS = {"full": GroveConfig().llama, "small": GroveConfig.small().llama,
           "tiny": GroveConfig.tiny().llama}


def _projections(cfg):
    """(name, K, N, G) of every int4 projection of a LLaMA config, the fused
    ones included, with the group `quantize_kernel_int4` takes."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {"q/k/v/o": (h, h), "gate/up": (h, f), "down": (f, h),
              "qkv fused": (h, 3 * h), "gate_up fused": (h, 2 * f)}
    return [(name, k, n, int4_group(k, cfg.quant_group))
            for name, (k, n) in shapes.items()]


SHAPES = [(f"{c} {name}", k, n, g) for c, cfg in CONFIGS.items()
          for name, k, n, g in _projections(cfg) if g % 64 == 0]
# chip_smoke.py's K7c edges (K, N, G): fewer tiles than CTAs, G = 256 and
# 64 (64-row tiles), N % 128 == 64 (a last tile of 64 columns), G = 192
# (three 64-row tiles a super-group), a tile count off the grid's multiple
EDGES = [(512, 256, 128), (1024, 384, 256), (768, 128, 64), (1024, 320, 128),
         (1024, 192, 64), (768, 256, 192), (4096, 2176, 128)]
SHAPES += [(f"edge {e}", *e) for e in EDGES]


# ---------------------------------------------------------------------------
# K7c: the plan
# ---------------------------------------------------------------------------

def _tile_box(p, kh, n, g, t):
    """(first packed row, rows, first column, columns, super-group) of tile
    t, as the kernel computes them."""
    rt, ct = divmod(t, p.tiles_n)
    r0, n0 = rt * p.rows, ct * tint4.REQUANT_TILE_N
    return r0, p.rows, n0, min(tint4.REQUANT_TILE_N, n - n0), r0 // g


@pytest.mark.parametrize("label,k,n,g", SHAPES, ids=[s[0] for s in SHAPES])
def test_requant_plan_covers_each_byte_once(label, k, n, g):
    """The tiles partition the (K/2, N) packed bytes, each inside one
    super-group, and the CTAs walk every tile exactly once."""
    kh = k // 2
    p = tint4._requant_plan(kh, n, g, SMS)
    cover = np.zeros((kh, n), np.int32)
    for t in range(p.tiles):
        r0, rows, n0, cols, sg = _tile_box(p, kh, n, g, t)
        assert cols in (64, 128) and rows in (64, 128)
        assert (r0 + rows - 1) // g == sg
        cover[r0:r0 + rows, n0:n0 + cols] += 1
    assert (cover == 1).all()
    walked = sorted(t for b in range(p.ctas)
                    for t in range(b, p.tiles, p.ctas))
    assert walked == list(range(p.tiles))


@pytest.mark.parametrize("label,k,n,g", SHAPES, ids=[s[0] for s in SHAPES])
def test_requant_plan_fits_shared_memory(label, k, n, g):
    p = tint4._requant_plan(k // 2, n, g, SMS)
    assert p.smem <= SMEM_227KB
    assert tint4.REQUANT_PER_SM * (p.smem + 1024) <= SMEM_SM
    assert p.ctas == min(p.tiles, tint4.REQUANT_PER_SM * SMS)
    assert p.rows == (128 if g % 128 == 0 else 64)


def test_requant_plans_at_full_width():
    """LLaMA-7B's three prefill weights: 512 / 1376 / 1376 tiles of
    128 x 128 on 264 CTAs (two an SM); the fused widths 1536 and 2752."""
    want = {(4096, 4096): 512, (4096, 11008): 1376, (11008, 4096): 1376,
            (4096, 12288): 1536, (4096, 22016): 2752}
    for (k, n), tiles in want.items():
        p = tint4._requant_plan(k // 2, n, 128, SMS)
        assert (p.rows, p.tiles, p.ctas) == (128, tiles, 264)
        assert p.smem == 4 * (16384 + 1024) + 32768
    assert tint4._requant_plan(1024, 4096, 128, SMS) is \
        tint4._requant_plan(1024, 4096, 128, SMS)


@pytest.mark.parametrize("kh,n,g", [(64, 64, 32), (128, 96, 64),
                                    (192, 128, 128), (16, 64, 16)])
def test_requant_plan_refuses_what_the_kernel_does_not_take(kh, n, g):
    """G or N off a multiple of 64 (tiny's groups of 16 and 32), or K / 2
    off a multiple of G: ValueError, as the wrapper raised before."""
    with pytest.raises(ValueError, match="multiples of 64"):
        tint4._requant_plan(kh, n, g, SMS)


def test_tiny_projections_are_refused():
    """tiny()'s groups (16, 32) are below the kernel's 64, so no tiny
    projection reaches K7c on the card (nor the TPU kernel, G % 128)."""
    for name, k, n, g in _projections(CONFIGS["tiny"]):
        with pytest.raises(ValueError):
            tint4._requant_plan(k // 2, n, g, SMS)


# ---------------------------------------------------------------------------
# K7c: a numpy model of the kernel body
# ---------------------------------------------------------------------------

def _u32(x):
    return np.asarray(x, np.uint64) & 0xFFFFFFFF


def _byte_perm(x, y, sel):
    """PRMT (`__byte_perm`) without the sign mode: byte i of the result is
    byte (sel >> 4i) & 7 of the 8 bytes y:x."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _dp2a(a, b, c, hi):
    """dp2a.lo / .hi, unsigned: c + a.h0 * b.byte(2hi) + a.h1 * b.byte(2hi
    + 1), mod 2^32."""
    s = 16 if hi else 0
    return _u32(c + (a & 0xFFFF) * ((b >> s) & 0xFF)
                + (a >> 16) * ((b >> (s + 8)) & 0xFF))


def _gather(v):
    lo = _byte_perm(v[0], v[1], 0x0051)
    hi = _byte_perm(v[2], v[3], 0x0051)
    return _byte_perm(lo, hi, 0x5410)


def _in_off(row, ch):
    return row * 128 + ((ch ^ (((row >> 4) & 3) << 1)) << 4)


def _out_off(plane, col, t):
    return (plane * tint4.REQUANT_TILE_N + col) * 128 + \
        ((t ^ ((col >> 2) & 7)) << 4)


BYTES = np.arange(16)


def _requant_model(wp, mult):
    """K7c's body, in numpy, tile by tile in each CTA's order: returns the
    (N, K) output bytes and how many times each was written."""
    kh, n = wp.shape
    g = 2 * kh // mult.shape[0]
    p = tint4._requant_plan(kh, n, g, SMS)
    tn = tint4.REQUANT_TILE_N
    in_bytes = 128 * tn
    wpb = wp.view(np.uint8)
    multb = mult.astype(np.int32).view(np.uint8).reshape(mult.shape[0], -1)
    out = np.zeros((n, 2 * kh), np.uint8)
    writes = np.zeros((n, 2 * kh), np.uint8)
    tid = np.arange(256)
    lane, warp = tid & 31, tid >> 5
    x, y = lane >> 3, lane & 7
    cq = 8 * (warp & 3) + y
    s = 4 * (warp >> 2) + x
    for b in range(p.ctas):
        for t in range(b, p.tiles, p.ctas):
            r0, rows, n0, tw, sg = _tile_box(p, kh, n, g, t)
            i0 = r0 - sg * g
            # the stage: rows by 16-byte chunks, then the multipliers
            st = np.zeros(in_bytes + 2 * tn * 4, np.uint8)
            row = np.arange(rows)[:, None]
            ch = np.arange(tw // 16)[None, :]
            st[_in_off(row, ch)[..., None] + BYTES] = wpb[
                r0 + row[..., None], n0 + 16 * ch[..., None] + BYTES]
            for plane in range(2):
                o = in_bytes + plane * 4 * tn
                st[o:o + 4 * tw] = multb[2 * sg + plane, 4 * n0:
                                         4 * (n0 + tw)]
            staging = np.full(2 * tn * 128, -1, np.int16)
            act = (s < rows // 16) & (4 * cq < tw)
            ts, tcq = s[act], cq[act]
            words = st.view(np.uint32)
            mw = words[(in_bytes // 4):].reshape(2, tn)
            a, c = [], []
            for plane in range(2):
                ms = [_u32(mw[plane, 4 * tcq + e].astype(np.int64))
                      for e in range(4)]
                a.append([(m << 16) & 0xFFFFFFFF if e & 1 else m & 0xFFFF
                          for e, m in enumerate(ms)])
                c.append([_u32(128 - 8 * m.astype(np.int64))
                          for m in ms])
            o = [[[None] * 4 for _ in range(4)] for _ in range(2)]
            for bb in range(4):
                v = [[[None] * 4 for _ in range(4)] for _ in range(2)]
                for j in range(4):
                    row = 16 * ts + 4 * bb + j
                    r = _u32(words[(_in_off(row, tcq >> 2)
                                    + (tcq & 3) * 4) // 4])
                    u = [(r ^ 0x08080808) & 0x0F0F0F0F,
                         ((r >> 4) ^ 0x08080808) & 0x0F0F0F0F]
                    for plane in range(2):
                        for e in range(4):
                            v[plane][e][j] = _dp2a(a[plane][e], u[plane],
                                                   c[plane][e], e >= 2)
                for plane in range(2):
                    for e in range(4):
                        o[plane][e][bb] = _gather(v[plane][e])
            for plane in range(2):
                for e in range(4):
                    chunk = np.stack(o[plane][e], -1).astype(np.uint32)
                    offs = _out_off(plane, 4 * tcq + e, ts)
                    staging[offs[:, None] + BYTES] = \
                        chunk.view(np.uint8).reshape(-1, 16)
            per = rows // 16                    # 16-byte chunks of a run
            idx = np.arange(2 * tw * per)
            ch, run = idx % per, idx // per
            plane = (run >= tw).astype(np.int64)
            col = run - plane * tw
            pieces = staging[_out_off(plane, col, ch)[:, None] + BYTES]
            assert (pieces >= 0).all(), "a staged chunk never written"
            k0 = (2 * sg + plane) * g + i0 + 16 * ch
            at = ((n0 + col)[:, None] + 0 * BYTES, k0[:, None] + BYTES)
            out[at] = pieces.astype(np.uint8)
            np.add.at(writes, at, 1)
    return out, writes


def _int4_inputs(rng, k, n, g):
    wp = rng.integers(-128, 128, (k // 2, n), dtype=np.int8)
    scale = rng.uniform(0.001, 0.02, (k // g, n)).astype(np.float32)
    _, mult = tint4.requant_multipliers(torch.from_numpy(scale))
    return wp, mult.numpy()


@pytest.mark.parametrize("k,n,g", [(512, 256, 128), (1024, 384, 256),
                                   (1024, 320, 128), (4096, 11008, 128)])
def test_requant_model_matches_pallas(k, n, g):
    """The model writes each output byte once and equals the Pallas kernel
    (interpret mode) and the plain twin bit for bit."""
    wp, mult = _int4_inputs(np.random.default_rng(k + n), k, n, g)
    out, writes = _requant_model(wp, mult)
    assert (writes == 1).all()
    got = out.view(np.int8).T                          # the (K, N) view
    twin = tint4.int4_requant_int8_torch(torch.from_numpy(wp),
                                         torch.from_numpy(mult))
    np.testing.assert_array_equal(got, twin.numpy())
    del twin
    want = np.asarray(jint4.int4_requant_int8(jnp.asarray(wp),
                                              jnp.asarray(mult)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,n,g", [(768, 128, 64), (1024, 192, 64),
                                   (768, 256, 192)])
def test_requant_model_matches_twin_at_64_row_tiles(k, n, g):
    """G % 128 == 64 (the TPU kernel asserts G % 128 == 0): 64-row tiles,
    every byte once, bit-equal to the plain twin."""
    wp, mult = _int4_inputs(np.random.default_rng(g + n), k, n, g)
    out, writes = _requant_model(wp, mult)
    assert (writes == 1).all()
    twin = tint4.int4_requant_int8_torch(torch.from_numpy(wp),
                                         torch.from_numpy(mult))
    np.testing.assert_array_equal(out.view(np.int8).T, twin.numpy())


def test_requant_dp2a_is_exact_for_any_multiplier():
    """(q4 + 8) * (mult mod 2^16) + (128 - 8 mult) agrees with
    q4 * mult + 128 in bits 8..15 for every q4 and multipliers across the
    int32 range (the kernel keeps mult's low 16 bits in a dp2a half)."""
    q = np.arange(-8, 8)
    m = np.array([0, 1, 255, 256, 4645, 32767, 32768, 65535, 65536, 123457,
                  -1, -4645, 2**31 - 1, -2**31])
    want = ((q[:, None] * m[None, :] + 128) >> 8) & 0xFF
    u = _u32((q[:, None] & 0xF) ^ 8)
    a = _u32(m[None, :]) & 0xFFFF
    c = _u32(128 - 8 * m[None, :])
    got = (_dp2a(a, u, c, False) >> 8) & 0xFF
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# K8c: the plan
# ---------------------------------------------------------------------------

RMS_CASES = [(rows, c, e, add) for rows, c in ((1280, 4096), (300, 256),
                                               (37, 768), (5, 8192),
                                               (997, 4096), (3, 4096),
                                               (1000, 8192))
             for e in (2, 4) for add in (False, True)]


@pytest.mark.parametrize("rows,c,e,add", RMS_CASES)
def test_rms_plan_takes_each_row_once(rows, c, e, add):
    p = tfln._rms_plan(rows, c, SMS, e, add)
    taken = sorted(r for b in range(p.ctas) for r in range(b, rows, p.ctas))
    assert taken == list(range(rows))
    assert 1 <= p.ctas <= rows and p.ctas <= p.per_sm * SMS
    assert p.slots == tfln.RMS_MAX_SLOTS
    assert p.smem <= SMEM_227KB
    assert p.per_sm * (p.smem + 64 + 1024) <= SMEM_SM
    assert p.smem >= p.slots * (2 if add else 1) * c * e


def test_rms_plans_at_the_prefill():
    """The W4A8 prefill's norm sites, 1280 bf16 rows of 4096: two row slots,
    three CTAs an SM (the C = 4096 instantiation's register cap), 396
    CTAs each taking 3 or 4 rows; fp32 rows of 8192 with
    the add: one CTA an SM (128 KB of ring)."""
    p = tfln._rms_plan(1280, 4096, SMS, 2, True)
    assert (p.slots, p.smem, p.per_sm, p.ctas) == (2, 2 * 16384 + 16, 3, 396)
    assert {len(range(b, 1280, p.ctas)) for b in range(p.ctas)} == {3, 4}
    p = tfln._rms_plan(1280, 4096, SMS, 2, False)
    assert (p.slots, p.smem, p.per_sm, p.ctas) == (2, 2 * 8192 + 16, 3, 396)
    p = tfln._rms_plan(64, 8192, SMS, 4, True)
    assert (p.slots, p.per_sm, p.ctas) == (2, 1, 64)
    assert tfln._rms_plan(5, 768, SMS, 2, True).ctas == 5


@pytest.mark.parametrize("c", [64, 200, 8320])
def test_rms_plan_refuses_what_the_kernel_does_not_take(c):
    with pytest.raises(ValueError, match="multiple of 128"):
        tfln._rms_plan(10, c, SMS)


# ---------------------------------------------------------------------------
# K8c: a torch model of the kernel's reduction order
# ---------------------------------------------------------------------------

def _rms_model(a, b, w, eps, threads=256):
    """K8c's arithmetic in the kernel's order: resid = a + b in a's dtype;
    thread t's 16-byte pieces k (E = 8 bf16 or 4 fp32 elements from
    (k * threads + t) * E); its sum of squares over its pieces' elements
    in order (fp32, each square rounded, then each sum); the warp's by a
    butterfly of shuffles; the warps' in warp order;
    r = 1 / sqrt(sum / C + eps); y = (x * r) * w; sx = max(max|y|, 1e-9) *
    fp32(1 / 127); q = clip(rint(y * (1 / sx)))."""
    resid = a if b is None else a + b.to(a.dtype)
    x = resid.float()
    rows, c = x.shape
    e_len = 16 // a.element_size()
    pieces = -(-c // (e_len * threads))
    acc = torch.zeros((rows, threads), dtype=torch.float32)
    for k in range(pieces):
        for e in range(e_len):
            idx = (torch.arange(threads) + k * threads) * e_len + e
            live = idx < c
            xe = torch.zeros((rows, threads), dtype=torch.float32)
            xe[:, live] = x[:, idx[live]]
            acc = acc + xe * xe
    lanes = acc.view(rows, threads // 32, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ o]
    red = lanes[..., 0]
    tot = red[:, 0]
    for k in range(1, threads // 32):
        tot = tot + red[:, k]
    var = tot / torch.tensor(float(c), dtype=torch.float32)
    r = torch.tensor(1.0, dtype=torch.float32) / torch.sqrt(
        var + torch.tensor(eps, dtype=torch.float32))
    y = (x * r[:, None]) * w.float()
    amax = y.abs().amax(-1, keepdim=True)
    sx = torch.clamp_min(amax, 1e-9) * torch.tensor(1.0 / 127.0,
                                                    dtype=torch.float32)
    inv = torch.tensor(1.0, dtype=torch.float32) / sx
    q = torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8)
    return resid, q, sx


def _assert_int8_close(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= LSB_SHARE, (d.max(),
                                                          (d > 0).mean())


@pytest.mark.parametrize("rows,c", [(300, 256), (37, 768), (70, 4096)])
@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_model_matches_pallas(rows, c, add, dtype):
    """The model within the limits of the Pallas kernel (interpret mode).
    In bf16 with the residual, XLA on the CPU folds the kernel's bf16
    rounding of a + b into the fp32 norm (the residual it writes is
    rounded, the norm reads the fp32 sum); the card's kernel and the plain
    twin norm the rounded residual, as the TPU kernel's bf16 `r` says. So
    there the model is held to the Pallas plain entry on the Pallas
    residual, and, fed the unrounded sum, to the Pallas add entry."""
    rng = np.random.default_rng(rows + c + add)
    a32 = (rng.normal(size=(rows, c)) * 2 + 0.3).astype(np.float32)
    b32 = rng.normal(size=(rows, c)).astype(np.float32) if add else None
    w = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    ta = torch.from_numpy(a32).to(getattr(torch, dtype))
    tb = None if b32 is None else torch.from_numpy(b32).to(ta.dtype)
    tw = torch.from_numpy(w)
    # the same rounded values on both sides
    ja = jnp.asarray(ta.float().numpy()).astype(getattr(jnp, dtype))
    jb = None if tb is None else jnp.asarray(tb.float().numpy()).astype(
        ja.dtype)
    jr, jq, js = jfln.add_rmsnorm_quant_dyn(ja, jb, jnp.asarray(w))
    tr, tq, ts = _rms_model(ta, tb, tw, 1e-6)
    np.testing.assert_array_equal(tr.float().numpy(),
                                  np.asarray(jr.astype(jnp.float32)))
    if add and dtype == "bfloat16":
        _, uq, us = _rms_model(ta.float() + tb.float(), None, tw, 1e-6)
        _assert_int8_close(uq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(us.numpy(), np.asarray(js), rtol=SX_TOL,
                                   atol=0)
        _, jq, js = jfln.add_rmsnorm_quant_dyn(jr, None, jnp.asarray(w))
    _assert_int8_close(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SX_TOL,
                               atol=0)


def test_rms_model_near_the_twin_at_full_width():
    """At the prefill's (1280, 4096) in bf16, the model's order and the
    plain twin's (torch's mean) agree within the same limits."""
    g = torch.Generator().manual_seed(0)
    a = (torch.randn((1280, 4096), generator=g) * 2 + 0.3).bfloat16()
    b = torch.randn((1280, 4096), generator=g).bfloat16()
    w = 0.5 + torch.rand((4096,), generator=g)
    mr, mq, ms = _rms_model(a, b, w, 1e-6)
    tr, tq, ts = tfln.add_rmsnorm_quant_dyn_torch(a, b, w, 1e-6)
    assert torch.equal(mr, tr)
    _assert_int8_close(mq.numpy(), tq.numpy())
    np.testing.assert_allclose(ms.numpy(), ts.numpy(), rtol=SX_TOL, atol=0)
