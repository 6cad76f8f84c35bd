"""The launch plan of K7a and K7b (`grove_tpu_torch.ops.int4_matmul._plan`)
on the CPU.

Their CUDA kernel template (`csrc/int4_matmul.cuh`, instantiated for K7a
in `int4_matmul.cu` and for K7b in `int4_matmul_a8.cu`) splits the K / 2G
super-groups of a projection over the CTAs of one thread-block cluster and
adds the ranks' partial sums in rank order; `_plan` chooses that split and
sizes the launch for an H100's 132 SMs (K7b: one byte of x). Checked
here for every int4 LLaMA projection of `GroveConfig()` (q/k/v/o, gate/up,
down, and the fused qkv and gate_up widths), of `small()` and `tiny()`,
and at the edge shapes `chip_smoke.py` holds the kernel at:

* each super-group belongs to exactly one rank, and every rank has one;
* the cluster has at most 8 CTAs and a CTA at most 227 KB of shared memory;
* the split of K is a function of K and G alone, so a fused projection's
  partition equals its unfused parts' (the kernel's per-column arithmetic
  does not depend on the column's place, so fused and unfused sum in one
  order: `chip_smoke.py` checks that bit for bit on the card);
* the three decode shapes get the launch PERF.md reports.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from grove_tpu_torch.config import GroveConfig  # noqa: E402
from grove_tpu_torch.ops import int4_matmul as tint4  # noqa: E402
from grove_tpu_torch.ops.quant import int4_group  # noqa: E402

SMS = 132                    # an H100's SMs
SMEM_227KB = 232448          # shared bytes a block can use on sm_90
ROWS = (1, 2, 8, 37, 63)     # decode and the prefill chunks under 64 rows


def _projections(cfg):
    """(name, K, N, G) of every int4 projection of a LLaMA config, fused
    ones included, with the group `quantize_kernel_int4` takes."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {"q/k/v/o": (h, h), "gate/up": (h, f), "down": (f, h),
              "qkv fused": (h, 3 * h), "gate_up fused": (h, 2 * f)}
    return [(name, k, n, int4_group(k, cfg.quant_group))
            for name, (k, n) in shapes.items()]


CONFIGS = {"full": GroveConfig().llama, "small": GroveConfig.small().llama,
           "tiny": GroveConfig.tiny().llama}
SHAPES = [(f"{c} {name}", k, n, g) for c, cfg in CONFIGS.items()
          for name, k, n, g in _projections(cfg) if g % 32 == 0]
# chip_smoke.py's K7a edge shapes (M, K, N, G), fp32 and bf16, and the two
# whose K range reads x from global memory (fp32 at 7 rows and K = 12288,
# bf16 at 24576)
EDGES = [(1, 512, 384, 128), (5, 512, 384, 128), (37, 768, 256, 32),
         (3, 1024, 68, 64), (3, 256, 96, 128)]
FROM_GLOBAL = [((7, 12288, 64, 128), 4), ((7, 24576, 64, 128), 2)]
SHAPES += [(f"edge {e}", *e[1:]) for e in EDGES]


@pytest.mark.parametrize("label,k,n,g", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_covers_each_super_group_once(label, k, n, g):
    supers = k // (2 * g)
    for m in ROWS:
        p = tint4._plan(m, k, n, g, SMS)
        assert len(p.ranges) == p.cluster
        assert [r for a, b in p.ranges for r in range(a, b)] == \
            list(range(supers))
        assert all(b > a for a, b in p.ranges)
        assert p.ranges[0][0] == 0 and p.ranges[-1][1] == supers


@pytest.mark.parametrize("label,k,n,g", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_fits_a_cluster_and_shared_memory(label, k, n, g):
    for m in ROWS:
        p = tint4._plan(m, k, n, g, SMS)
        assert 1 <= p.cluster <= 8
        assert p.smem <= SMEM_227KB
        assert p.mt in (1, 2, 4, 8) and p.mt * p.row_blocks >= m
        assert p.tiles * tint4.TILE_N >= n
        assert p.vec in (4, 16) and p.staged
        assert p.vec == (16 if n % 16 == 0 else 4)
        assert p.per_sm == -(-p.ctas // SMS)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("fused,parts", [("qkv fused", ["q/k/v/o"] * 3),
                                         ("gate_up fused", ["gate/up"] * 2)])
def test_fused_partition_equals_unfused(config, fused, parts):
    shapes = {name: (k, n, g) for name, k, n, g in
              _projections(CONFIGS[config])}
    k, n, g = shapes[fused]
    assert sum(shapes[p][1] for p in parts) == n
    if g % 32:                 # tiny: G = 16, refused fused and unfused
        for width in (n, shapes[parts[0]][1]):
            with pytest.raises(ValueError, match="multiple of 32"):
                tint4._plan(2, k, width, g, SMS)
        return
    for m in ROWS:
        whole = tint4._plan(m, k, n, g, SMS)
        for part in parts:
            pk, pn, pg = shapes[part]
            assert (pk, pg) == (k, g)
            one = tint4._plan(m, pk, pn, pg, SMS)
            assert (one.cluster, one.ranges) == (whole.cluster, whole.ranges)
            assert one.mt == whole.mt


@pytest.mark.parametrize("k,n,g", [(4096, 4096, 128), (11008, 4096, 128),
                                   (768, 256, 32), (512, 384, 128)])
def test_split_depends_on_k_and_g_alone(k, n, g):
    """The partition of one K does not move with N, M or the SM count."""
    want = tint4._plan(2, k, n, g, SMS).ranges
    for m in ROWS:
        for width in (4, 68, n, 3 * n, 22016):
            for sms in (1, 132, 1000):
                assert tint4._plan(m, k, width, g, sms).ranges == want


@pytest.mark.parametrize("k,n,want", [
    # (mt, tiles, cluster, per-rank super-groups, smem bytes, CTAs, per SM)
    (4096, 4096, (2, 64, 2, {8}, 49664, 128, 1)),
    (4096, 11008, (2, 172, 2, {8}, 49664, 344, 3)),
    (11008, 4096, (2, 64, 2, {21, 22}, 64000, 128, 1))])
def test_decode_plans(k, n, want):
    """M = 2, G = 128, bf16 x: LLaMA-7B's three decode shapes. 128 CTAs,
    one an SM, at 4096 -> 4096 and 11008 -> 4096; 344 at 4096 -> 11008,
    three an SM (TcDot's two-row budget lets three be resident)."""
    p = tint4._plan(2, k, n, 128, SMS)
    got = (p.mt, p.tiles, p.cluster, {b - a for a, b in p.ranges}, p.smem,
           p.ctas, p.per_sm)
    assert got == want
    assert p.vec == 16 and p.staged


def test_plan_is_memoised():
    """The wrapper asks for the same few plans on every decode step."""
    assert tint4._plan(2, 4096, 4096, 128, SMS) is \
        tint4._plan(2, 4096, 4096, 128, SMS)


def test_plan_narrows_copies_off_16_bytes():
    """N % 16 != 0, or weights or scales off a 16-byte boundary, take the
    instantiation with 4-byte copies; the split of K stays."""
    wide = tint4._plan(2, 4096, 4096, 128, SMS)
    for p in (tint4._plan(2, 4096, 4100, 128, SMS),
              tint4._plan(2, 4096, 4096, 128, SMS, aligned=False)):
        assert p.vec == 4 and p.staged
        assert p.ranges == wide.ranges


def test_plan_reads_x_from_global_when_its_k_range_does_not_fit():
    """A K range too long for shared memory beside the ring (at 8 bf16 rows
    of x and G = 128, K past about 23 K) reads x from global memory, with
    the same split of K."""
    k = 2 * 2 * 128 * 800                       # 800 super-groups a rank
    p = tint4._plan(8, k, 4096, 128, SMS)
    assert not p.staged and p.vec == 4
    assert p.smem <= SMEM_227KB
    assert {b - a for a, b in p.ranges} == {800}
    assert tint4._plan(8, 16384, 4096, 128, SMS).staged
    assert not tint4._plan(8, 16384, 4096, 128, SMS, x_bytes=4).staged


@pytest.mark.parametrize("g,n", [(16, 64), (48, 64), (32, 66)])
def test_plan_refuses_what_the_kernel_does_not_take(g, n):
    """G off a multiple of 32 (tiny's hidden width 32 gives G = 16) or N off
    a multiple of 4: ValueError, as the wrapper raised before."""
    with pytest.raises(ValueError, match="multiple of 32"):
        tint4._plan(2, 4 * g, n, g, SMS)


def test_tiny_projections_cover_both_group_sizes():
    """tiny()'s projections are G = 16 (K = 32, refused on the card) and
    G = 32 (K = 64, the down projection, planned)."""
    groups = {name: g for name, k, n, g in _projections(CONFIGS["tiny"])}
    assert groups["down"] == 32 and groups["q/k/v/o"] == 16
    assert any(label.startswith("tiny down") for label, *_ in SHAPES)


@pytest.mark.parametrize("m,x_bytes,mt", [(1, 4, 1), (1, 2, 2), (2, 2, 2),
                                          (3, 4, 4), (5, 2, 8), (63, 2, 8)])
def test_plan_rows_of_x(m, x_bytes, mt):
    """A CTA takes up to 8 rows of x, a power of two; the tensor-core
    instantiation (bf16 x) at least 2, so one row takes the two-row one."""
    p = tint4._plan(m, 4096, 4096, 128, SMS, x_bytes)
    assert (p.mt, p.row_blocks) == (mt, -(-m // mt))


@pytest.mark.parametrize("shape,x_bytes", FROM_GLOBAL)
def test_edges_reach_x_from_global_memory(shape, x_bytes):
    """chip_smoke.py's edges that hold the instantiation reading x from
    global memory on the card reach it, in its dtype; at half the K they
    would be staged."""
    m, k, n, g = shape
    p = tint4._plan(m, k, n, g, SMS, x_bytes)
    assert not p.staged and p.vec == 4 and p.cluster == 2
    assert p.smem <= SMEM_227KB
    assert tint4._plan(m, k // 2, n, g, SMS, x_bytes).staged


@pytest.mark.parametrize("x_bytes", [2, 4])
def test_edge_reaches_a_cluster_of_one(x_bytes):
    """K = 2G, one super-group: a cluster of one CTA, which reduces alone."""
    p = tint4._plan(3, 256, 96, 128, SMS, x_bytes)
    assert (p.cluster, p.ranges, p.vec, p.staged) == (1, ((0, 1),), 16, True)


# ---------------------------------------------------------------------------
# K7b: the same plan for one byte of x (int8 activations)
# ---------------------------------------------------------------------------

# chip_smoke.py's K7b edges (M, K, N, G): one row, 5 rows, 37 rows at G 32,
# N % 16 != 0 at G 64 (4-byte copies), K = 2G (a cluster of one), and a K
# range too long for shared memory at 7 rows (x read from global memory)
A8_EDGES = [(1, 512, 384, 128), (5, 512, 384, 128), (37, 768, 256, 32),
            (3, 1024, 68, 64), (3, 256, 96, 128)]
A8_FROM_GLOBAL = (7, 49152, 64, 128)


@pytest.mark.parametrize("label,k,n,g", SHAPES, ids=[s[0] for s in SHAPES])
def test_a8_plan_covers_each_super_group_once_and_fits(label, k, n, g):
    """K7b's plan: every super-group in one rank, a cluster of at most 8,
    shared memory within 227 KB, 2 to 8 rows of x a CTA (the int8 tensor
    cores' B operand holds 8), x staged, and K split as K7a splits it."""
    supers = k // (2 * g)
    for m in ROWS:
        p = tint4._plan(m, k, n, g, SMS, 1)
        assert [r for a, b in p.ranges for r in range(a, b)] == \
            list(range(supers))
        assert all(b > a for a, b in p.ranges)
        assert 1 <= p.cluster <= 8 and p.smem <= SMEM_227KB
        assert p.mt in (2, 4, 8) and p.mt * p.row_blocks >= m
        assert p.staged and p.vec == (16 if n % 16 == 0 else 4)
        assert p.ranges == tint4._plan(m, k, n, g, SMS).ranges


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("fused,parts", [("qkv fused", ["q/k/v/o"] * 3),
                                         ("gate_up fused", ["gate/up"] * 2)])
def test_a8_fused_partition_equals_unfused(config, fused, parts):
    """The W4A8 fused widths (qkv, gate_up) partition K as their parts do,
    at every row count: K7b's per-column arithmetic does not depend on the
    column's place, so fused and unfused sum each column in one order
    (`chip_smoke.py` checks that bit for bit on the card)."""
    shapes = {name: (k, n, g) for name, k, n, g in
              _projections(CONFIGS[config])}
    k, n, g = shapes[fused]
    if g % 32:
        with pytest.raises(ValueError, match="multiple of 32"):
            tint4._plan(2, k, n, g, SMS, 1)
        return
    for m in ROWS:
        whole = tint4._plan(m, k, n, g, SMS, 1)
        for part in parts:
            pk, pn, pg = shapes[part]
            one = tint4._plan(m, pk, pn, pg, SMS, 1)
            assert (one.cluster, one.ranges, one.mt) == \
                (whole.cluster, whole.ranges, whole.mt)


@pytest.mark.parametrize("k,n,g", [(4096, 4096, 128), (11008, 4096, 128),
                                   (768, 256, 32), (1024, 68, 64)])
def test_a8_split_depends_on_k_and_g_alone(k, n, g):
    want = tint4._plan(2, k, n, g, SMS, 1).ranges
    for m in ROWS:
        for width in (4, 68, n, 12288, 22016):
            for sms in (1, 132, 1000):
                assert tint4._plan(m, k, width, g, sms, 1).ranges == want


@pytest.mark.parametrize("k,n,want", [
    # (mt, tiles, cluster, per-rank super-groups, smem bytes, CTAs, per SM)
    (4096, 4096, (2, 64, 2, {8}, 45568, 128, 1)),
    (4096, 11008, (2, 172, 2, {8}, 45568, 344, 3)),
    (11008, 4096, (2, 64, 2, {21, 22}, 52736, 128, 1))])
def test_a8_decode_plans(k, n, want):
    """M = 2, G = 128, int8 x: the three decode shapes take K7a's grid,
    with x's K range in a quarter of K7a's bytes (40960 of ring, 2 rows
    of xq, the 2 x 64 fp32 tile)."""
    p = tint4._plan(2, k, n, 128, SMS, 1)
    got = (p.mt, p.tiles, p.cluster, {b - a for a, b in p.ranges}, p.smem,
           p.ctas, p.per_sm)
    assert got == want
    assert p.vec == 16 and p.staged


@pytest.mark.parametrize("shape", A8_EDGES)
def test_a8_edges_reach_each_instantiation(shape):
    """K7b's edges: 16-byte and 4-byte copies, a cluster of one at K = 2G,
    rows of x from 1 to 37."""
    m, k, n, g = shape
    p = tint4._plan(m, k, n, g, SMS, 1)
    assert p.staged and p.vec == (16 if n % 16 == 0 else 4)
    assert p.cluster == min(2, k // (2 * g))
    kinds = {(q.vec, q.cluster, q.mt) for q in
             (tint4._plan(*e, SMS, 1) for e in A8_EDGES)}
    assert {v for v, _, _ in kinds} == {4, 16}
    assert {c for _, c, _ in kinds} == {1, 2}
    assert {t for _, _, t in kinds} == {2, 4, 8}


def test_a8_edge_reaches_x_from_global_memory():
    """At 7 rows and K = 49152 xq's K range (8 x 24576 bytes) does not fit
    beside the ring: K7b reads it from global memory, with 4-byte copies;
    at half the K it is staged."""
    m, k, n, g = A8_FROM_GLOBAL
    p = tint4._plan(m, k, n, g, SMS, 1)
    assert not p.staged and p.vec == 4 and p.cluster == 2
    assert p.smem <= SMEM_227KB
    assert tint4._plan(m, k // 2, n, g, SMS, 1).staged


@pytest.mark.parametrize("g,n", [(16, 64), (48, 64), (32, 66)])
def test_a8_plan_refuses_what_the_kernel_does_not_take(g, n):
    """G off a multiple of 32 or N off a multiple of 4: ValueError."""
    with pytest.raises(ValueError, match="multiple of 32"):
        tint4._plan(2, 4 * g, n, g, SMS, 1)
