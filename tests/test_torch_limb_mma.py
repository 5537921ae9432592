"""The tensor-core integer kernels' own arithmetic, emulated on the CPU.

``csrc/kom_matmul.cu`` and ``csrc/implicit_conv.cu`` run their int8
passes as ``mma.sync`` over digit planes that ``csrc/limb_mma.cuh`` splits
two int16 lanes at a time and transposes with byte permutes; the limb GEMM
splits K across blocks by :func:`kom_split_k`, the conv walks the K steps
of :func:`implicit_k_steps`.  None of that runs here, so these tests
emulate each piece in numpy or PyTorch and hold it bit for bit against the
plain versions (which ``tests/test_torch_kernels.py`` holds against the JAX
reference) and, for the split GEMM, against the reference's Pallas kernel
in interpret mode.  ``tests/test_torch_cuda.py`` holds the kernels
themselves against the plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.kom_matmul import ops as rkom  # noqa: E402
from repro_torch.core import substrate as psub  # noqa: E402
from repro_torch.kernels.conv2d import implicit_gemm as pimp  # noqa: E402
from repro_torch.kernels.kom_matmul import ops as pkom  # noqa: E402

torch.set_num_threads(2)

SPECS = [("karatsuba", 7), ("schoolbook", 8)]
#: granite-3-2b's decode projections (k, n): q, k, v, o, gate, up, down,
#: the tied head.
GRANITE = [(2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
           (2048, 8192), (2048, 8192), (8192, 2048), (2048, 49408)]


# ---------------------------------------------------------------------------
# The digit split of limb_mma.cuh (split2, quad_of_row, quads_of_cols).
# ---------------------------------------------------------------------------

def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on int64 arrays holding 32-bit words."""
    src = [(a >> (8 * i)) & 0xff for i in range(4)] \
        + [(b >> (8 * i)) & 0xff for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _split2(w, b):
    """limb_mma.cuh split2<true>: (hi, lo, hi + lo) bytes at 0 and 2."""
    h = 1 << (b - 1)
    half2, mask2 = h * 0x00010001, ((1 << b) - 1) * 0x00010001
    bias2 = (256 - h) * 0x00010001
    lo = (((w & mask2) ^ half2) + bias2) & 0xffffffff
    hi = ((w + (w & half2)) & 0xffffffff) >> b
    return hi, lo, ((hi & 0x00ff00ff) + lo) & 0xffffffff


def _lanes(x0, x1):
    return (x0 & 0xffff) | ((x1 & 0xffff) << 16)


def _bytes(word):
    """The four bytes of 32-bit words, (..., 4)."""
    return np.stack([(word >> (8 * i)) & 0xff for i in range(4)], -1)


@pytest.mark.parametrize("base_bits", [2, 4, 6, 7, 8])
def test_packed_digit_split_is_the_balanced_split(base_bits):
    """Every |x| <= qmax, in either int16 lane, beside a random partner:
    the packed bytes are the balanced digits (and their sum) mod 256."""
    rng = np.random.default_rng(base_bits)
    qmax = psub.kom_qmax(base_bits)
    x = np.arange(-qmax, qmax + 1, dtype=np.int64)
    other = rng.integers(-qmax, qmax + 1, x.size)
    hi_t, lo_t = psub.balanced_split(torch.from_numpy(x), base_bits)
    hi_t, lo_t = hi_t.numpy().astype(np.int64), lo_t.numpy().astype(np.int64)
    for lane, w in ((0, _lanes(x, other)), (1, _lanes(other, x))):
        parts = _split2(w, base_bits)
        for got, want in zip(parts, (hi_t, lo_t, hi_t + lo_t)):
            np.testing.assert_array_equal((got >> (16 * lane)) & 0xff,
                                          want & 0xff)


def test_byte_transposes_pack_k_quads():
    """quad_of_row packs a row's four K entries; quads_of_cols turns four
    rows of (n, n+1) pairs into the K-quads of columns n and n+1."""
    rng = np.random.default_rng(0)
    v = rng.integers(0, 256, (4, 2, 500))
    words = v[:, 0] | (v[:, 1] << 16)                   # row j: (n, n+1)
    p01 = _byte_perm(words[0], words[1], 0x6240)
    p23 = _byte_perm(words[2], words[3], 0x6240)
    col_n = _byte_perm(p01, p23, 0x5410)
    col_n1 = _byte_perm(p01, p23, 0x7632)
    for col, want in ((col_n, v[:, 0]), (col_n1, v[:, 1])):
        np.testing.assert_array_equal(_bytes(col), want.T)
    row = _byte_perm(words[0], words[1], 0x6420)        # (k0, k1), (k2, k3)
    np.testing.assert_array_equal(
        _bytes(row), np.stack([v[0, 0], v[0, 1], v[1, 0], v[1, 1]], -1))


def _rn32(x):
    """Round an exact rational to the nearest float32 (ties to even)."""
    from fractions import Fraction
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.uint32)) & 1))


def test_quantize_by_reciprocal_is_the_ieee_quotient():
    """limb_mma.cuh quantize_rcp: q = RN(x * RN(1/s)), then Markstein's
    RN(q + RN(x - q s) RN(1/s)) -- emulated in exact rationals -- is the
    correctly rounded x / s, so its clip(rint()) is the plain version's
    quantize_values, also at quotients a few ulps from k + 1/2."""
    from fractions import Fraction
    rng = np.random.default_rng(11)
    xs, ss = [], []
    for i in range(1500):
        s = np.float32(2.0 ** rng.uniform(-50, 8) * rng.uniform(1, 2))
        if i % 2:     # a quotient within 3 ulps of a half-integer
            x = np.float32((rng.integers(0, 32639) + 0.5) * float(s))
            x = (x.view(np.int32) + rng.integers(-3, 4)).astype(
                np.int32).view(np.float32)
        else:
            x = np.float32(float(s) * rng.uniform(-8200, 8200))
        xs.append(np.float32(x))
        ss.append(s)
    got = []
    for x, s in zip(xs, ss):
        fx, fs = Fraction(float(x)), Fraction(float(s))
        rc = _rn32(1 / fs)
        q = np.float32(x * rc)
        e = _rn32(fx - fs * Fraction(float(q)))
        got.append(_rn32(Fraction(float(e)) * Fraction(float(rc))
                         + Fraction(float(q))))
    for qmax in (8127, 32639):
        want = psub.quantize_values(torch.tensor(xs), torch.tensor(ss),
                                    qmax)
        mine = torch.clamp(torch.round(torch.tensor(got)), -qmax, qmax).to(
            torch.int32)
        assert torch.equal(mine, want)
    assert torch.equal(torch.tensor(got), torch.tensor(xs) / torch.tensor(ss))


# ---------------------------------------------------------------------------
# The limb GEMM's K split.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 2048, 2048), (4, 8192, 2048),
                                   (16, 9216, 4096), (17, 9216, 130),
                                   (48400, 363, 96), (4, 5, 3), (8, 0, 3),
                                   (3, 4097, 1000)])
def test_split_plan_covers_k_in_order(m, k, n):
    plan = pkom.kom_split_k(m, k, n)
    bounds = plan["bounds"]
    assert plan["splits"] == len(bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0 and a1 - a0 == plan["group_k"]
    assert plan["group_k"] % pkom.KOM_CHUNK_K == 0
    assert plan["m_tile"] >= min(m, 16)
    assert plan["ldb"] % 8 == 0 and 0 <= plan["ldb"] - n < 8
    assert plan["lda"] % 8 == 0 and 0 <= plan["lda"] - k < 8
    assert (plan["scratch"] is None) == (plan["splits"] == 1)


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n", GRANITE)
def test_split_plan_fills_the_card_at_granite_decode_shapes(m, k, n):
    plan = pkom.kom_split_k(m, k, n)
    assert plan["blocks"] >= pkom.KOM_TARGET_BLOCKS
    # No group length reaches the target with fewer splits.
    tiles = plan["blocks"] // plan["splits"]
    chunks = -(-k // pkom.KOM_CHUNK_K)
    for group in range(1, chunks + 1):
        splits = -(-chunks // group)
        if tiles * splits >= pkom.KOM_TARGET_BLOCKS:
            assert splits >= plan["splits"]


@pytest.mark.parametrize("m,k,n", [(4, 2048, 49408), (48400, 363, 96),
                                   (401408, 27, 64)])
def test_split_plan_keeps_one_split_when_the_grid_is_full(m, k, n):
    plan = pkom.kom_split_k(m, k, n)
    assert plan["splits"] == 1 and plan["scratch"] is None
    assert plan["blocks"] >= pkom.KOM_TARGET_BLOCKS


def _split_emulation(a, b, plan, variant, base_bits, rs, cs, bias):
    """The kernel's order: each split's int32 limb partials, added in
    int32 by the combine kernel, one recombine, the epilogue."""
    tot = None
    for k0, k1 in plan["bounds"]:
        parts = psub.limb_partials(a[:, k0:k1], b[k0:k1], variant=variant,
                                   base_bits=base_bits)
        tot = parts if tot is None else tuple(
            t + p for t, p in zip(tot, parts))
    raw = psub.limb_recombine(*tot, base_bits=base_bits)
    return psub.dequant_epilogue(raw, rs[:, None] * cs[None, :], bias)


@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("m,k,n", [(1, 300, 40), (4, 300, 40),
                                   (4, 2100, 70)])
def test_split_emulation_equals_plain_version(variant, base_bits, m, k, n):
    rng = np.random.default_rng(m + k)
    qmax = psub.kom_qmax(base_bits)
    a = torch.from_numpy(rng.integers(-qmax, qmax + 1, (m, k)).astype(
        np.int16))
    b = torch.from_numpy(rng.integers(-qmax, qmax + 1, (k, n)).astype(
        np.int16))
    rs = torch.from_numpy(rng.random(m).astype(np.float32) * 1e-3)
    cs = torch.from_numpy(rng.random(n).astype(np.float32) * 1e-3)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    plan = pkom.kom_split_k(m, k, n)
    assert plan["splits"] > 1          # a split boundary is crossed
    got = _split_emulation(a, b, plan, variant, base_bits, rs, cs, bias)
    want = pkom.kom_matmul_int_plain(a, b, variant=variant,
                                     base_bits=base_bits, row_scale=rs,
                                     col_scale=cs, bias=bias)
    assert torch.equal(got, want)
    if (m, k) == (4, 300):             # and the reference's Pallas kernel
        raw = rkom.kom_matmul_int(jnp.asarray(a.numpy()),
                                  jnp.asarray(b.numpy()),
                                  base_bits=base_bits, variant=variant,
                                  interpret=True)
        np.testing.assert_array_equal(
            _split_emulation(a, b, plan, variant, base_bits, torch.ones(m),
                             torch.ones(n), None).numpy(), np.asarray(raw))


def test_split_emulation_wraps_like_the_plain_version():
    """Karatsuba's digit-sum pass past 2^31: the int32 split sums wrap as
    the plain version's do (and the three partials stay exact mod 2^32)."""
    k, n = 140000, 8
    a = torch.full((1, k), -8127, dtype=torch.int16)
    b = torch.full((k, n), -8127, dtype=torch.int16)
    _, al = psub.balanced_split(a[:1, :1], 7)
    assert abs(int(k * (2 * int(al) - 1) ** 2)) > 2 ** 31  # digit sums
    plan = pkom.kom_split_k(1, k, n)
    got = _split_emulation(a, b, plan, "karatsuba", 7, torch.ones(1),
                           torch.ones(n), None)
    want = pkom.kom_matmul_int_plain(a, b)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The integer conv's K walk.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("handoff", [False, True])
@pytest.mark.parametrize("k,cin,span_c", [(3, 100, 40), (3, 37, 8),
                                          (5, 96, 96), (3, 512, 512),
                                          (1, 70, 33)])
def test_conv_steps_never_cross_a_group(handoff, k, cin, span_c):
    steps = pimp.implicit_k_steps(k, k, cin, span_c, handoff=handoff)
    spans = pimp.group_spans(cin, span_c, 1)
    seen = []
    for tap, c0, c1, _ in steps:
        assert 0 < c1 - c0 <= pimp.IMPLICIT_STEP_C
        assert any(g0 <= c0 and c1 <= g1 for g0, g1 in spans)
        seen += [(tap, c) for c in range(c0, c1)]
    assert sorted(seen) == [(t, c) for t in range(k * k) for c in range(cin)]
    folds = [s for s in steps if s[3]]
    assert len(folds) == len(spans) * (k * k if handoff else 1)
    assert steps[-1][3]


def _conv_emulation(x, w, ascale, wscale, bias, *, pad, span_c, variant,
                    base_bits):
    """The kernel's walk for a stride-1 SAME conv: int32 limb partials of
    each K step, one f32 recombine per fold, then the epilogue."""
    n, h, wd, cin = x.shape
    kh, kw = w.shape[:2]
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    s4 = ascale[..., None]
    qmax = psub.kom_qmax(base_bits)
    acc = torch.zeros((n, h, wd, w.shape[3]), dtype=torch.float32)
    part = None
    for tap, c0, c1, folds in pimp.implicit_k_steps(kh, kw, cin, span_c,
                                                    handoff=False):
        dy, dx = divmod(tap, kw)
        q = psub.quantize_values(xp[:, dy:dy + h, dx:dx + wd, c0:c1], s4,
                                 qmax)
        p = psub.limb_partials(q, w[dy, dx, c0:c1], variant=variant,
                               base_bits=base_bits)
        part = p if part is None else tuple(a + b for a, b in zip(part, p))
        if folds:
            acc = acc + psub.limb_recombine(*part, base_bits=base_bits)
            part = None
    return psub.dequant_epilogue(acc, s4 * wscale, bias)


def _handoff_emulation(q, grid, w, wscale, bias, *, bk, variant, base_bits):
    n, hp, wp, cin = q.shape
    ho, wo = hp - 2, wp - 2
    cells = pimp.cell_scales(grid, hp, wp)
    acc = torch.zeros((n, ho, wo, w.shape[3]), dtype=torch.float32)
    part = None
    for tap, c0, c1, folds in pimp.implicit_k_steps(3, 3, cin, bk,
                                                    handoff=True):
        dy, dx = divmod(tap, 3)
        p = psub.limb_partials(q[:, dy:dy + ho, dx:dx + wo, c0:c1],
                               w[dy, dx, c0:c1], variant=variant,
                               base_bits=base_bits)
        part = p if part is None else tuple(a + b for a, b in zip(part, p))
        if folds:
            rec = psub.limb_recombine(*part, base_bits=base_bits)
            acc = acc + cells[:, dy:dy + ho, dx:dx + wo, None] * rec
            part = None
    return psub.dequant_epilogue(acc, wscale, bias)


@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("cin,span_c", [(70, 40), (37, 20), (50, 50)])
def test_conv_step_emulation_equals_plain_version(variant, base_bits, cin,
                                                  span_c):
    """span_c not a multiple of the 32-channel step: the walk cuts steps
    at each group's end and folds where the plain version does."""
    rng = np.random.default_rng(cin)
    n, h, k, cout = 2, 6, 3, 8
    x = torch.from_numpy(np.maximum(rng.standard_normal(
        (n, h, h, cin)), 0).astype(np.float32))
    w = psub.quantize_weight(torch.from_numpy(rng.standard_normal(
        (k, k, cin, cout)).astype(np.float32)), base_bits=base_bits).values
    ascale = torch.from_numpy(rng.random((n, h, h)).astype(np.float32)
                              * 1e-2 + 1e-3)
    wscale = torch.from_numpy(rng.random(cout).astype(np.float32) * 1e-3)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    kw_ = dict(span_c=span_c, variant=variant, base_bits=base_bits)
    got = _conv_emulation(x, w, ascale, wscale, bias, pad=1, **kw_)
    want = pimp.conv2d_implicit_raw_plain(x, w, ascale, wscale, bias,
                                          stride=1, pads=(1, 1),
                                          out_hw=(h, h), **kw_)
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("cin,bk", [(70, 40), (37, 8), (40, 40)])
def test_handoff_step_emulation_equals_plain_version(variant, base_bits, cin,
                                                     bk):
    from repro_torch.kernels.conv2d.ops import handoff_quantize

    rng = np.random.default_rng(cin + bk)
    n, h, cout = 2, 7, 8
    x = torch.from_numpy(np.maximum(rng.standard_normal(
        (n, h, h, cin)), 0).astype(np.float32))
    qa = handoff_quantize(x, base_bits=base_bits)
    w = psub.quantize_weight(torch.from_numpy(rng.standard_normal(
        (3, 3, cin, cout)).astype(np.float32)), base_bits=base_bits).values
    wscale = torch.from_numpy(rng.random(cout).astype(np.float32) * 1e-3)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    kw_ = dict(bk=bk, variant=variant, base_bits=base_bits)
    got = _handoff_emulation(qa.values, qa.scale, w, wscale, bias, **kw_)
    want = pimp.conv2d_implicit_handoff_plain(qa.values, qa.scale, w,
                                              wscale, bias, **kw_)
    assert torch.equal(got, want)
