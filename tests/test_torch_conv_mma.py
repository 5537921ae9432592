"""The systolic conv's and integer Winograd's tensor-core walks, emulated on
the CPU.

``csrc/systolic_conv.cu`` runs the systolic engine as an implicit GEMM over
the batch-flattened output pixels: K steps of 64 channels of one tap (or of
the flat (tap, channel) index where cin is not a multiple of 8), split over
grid.z where the grid is smaller than the card, the splits' int32 sums
added as integers (:func:`systolic_plan`, :func:`systolic_k_steps`).
``csrc/winograd.cu`` splits every transformed plane once more into two
balanced int8 sub-digits of base 2^7 and folds each point's contraction
over a 32-channel chunk into the inverse transform in int32, the chunks
split over grid.z where that fills the card better (:func:`winograd_plan`,
by the same rule, :func:`grid_k_splits`).  None of that
runs here, so these tests emulate each piece in numpy or PyTorch and hold
it bit for bit against the plain versions (which
``tests/test_torch_kernels.py`` and ``tests/test_torch_systolic.py`` hold
against the JAX reference) and against the reference's Pallas kernels in
interpret mode.  ``tests/test_torch_cuda.py`` holds the kernels themselves
against the plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import substrate as rsub  # noqa: E402
from repro.kernels.conv2d import conv2d as rconv  # noqa: E402
from repro.kernels.conv2d import ops as rops  # noqa: E402
from repro_torch.core import substrate as psub  # noqa: E402
from repro_torch.kernels.conv2d import conv2d as pconv  # noqa: E402
from repro_torch.kernels.conv2d import ops as pops  # noqa: E402
from repro_torch.kernels.conv2d import winograd as pwin  # noqa: E402
from repro_torch.models.cnn import VGG16, cnn_conv_geometries  # noqa: E402

torch.set_num_threads(2)

SPECS = [("karatsuba", 7), ("schoolbook", 8)]
H100_SMS = 132


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _wrap32(v):
    """int64 values reduced to two's-complement int32, as the MMA's
    accumulators and the kernels' unsigned int32 arithmetic keep them."""
    return ((np.asarray(v, dtype=np.int64) + 2**31) % 2**32) - 2**31


# ---------------------------------------------------------------------------
# Winograd's sub-digit split and its shift recombine.
# ---------------------------------------------------------------------------

def _plane_bounds(variant, base_bits):
    """|entry| bounds of the planes each side of the contraction reaches:
    the transformed limb planes (|V| <= 4h, |U| <= 9h) and, for Karatsuba,
    their digit sums (8h, 18h)."""
    h = 1 << (base_bits - 1)
    a, b = [4 * h], [9 * h]
    if variant == "karatsuba":
        a.append(8 * h)
        b.append(18 * h)
    return a, b


def _sub_split(x):
    return psub.balanced_split(torch.as_tensor(x), pwin.WINOGRAD_SUB_BITS)


@pytest.mark.parametrize("variant,base_bits", SPECS)
def test_sub_digit_split_covers_every_plane_value(variant, base_bits):
    """Every value of every plane's range: X = 2^7 X1 + X0 with |X0| <= 64
    and |X1| <= 9, both int8 (what the packed quads hold)."""
    a_bounds, b_bounds = _plane_bounds(variant, base_bits)
    for bound in a_bounds + b_bounds:
        x = torch.arange(-bound, bound + 1, dtype=torch.int32)
        x1, x0 = _sub_split(x)
        assert torch.equal(x1 * 128 + x0, x)
        assert int(x0.min()) >= -64 and int(x0.max()) <= 63
        assert int(x1.abs().max()) <= 9
        for d in (x1, x0):
            assert torch.equal(d.to(torch.int8).to(torch.int32), d)


@pytest.mark.parametrize("variant,base_bits", SPECS)
def test_sub_digit_products_recombine_by_shifts(variant, base_bits):
    """Every pair of the widest A and B planes' values: the four int8
    products (X1Y1, X1Y0 + X0Y1, X0Y0), recombined as (s11 << 14) +
    (s1x << 7) + s00, give the int16-level product."""
    a_bounds, b_bounds = _plane_bounds(variant, base_bits)
    a = np.arange(-a_bounds[-1], a_bounds[-1] + 1, dtype=np.int64)
    b = np.arange(-b_bounds[-1], b_bounds[-1] + 1, dtype=np.int64)
    a1, a0 = (t.numpy().astype(np.int64) for t in _sub_split(a))
    b1, b0 = (t.numpy().astype(np.int64) for t in _sub_split(b))
    got = (np.outer(a1, b1) << 14) + ((np.outer(a1, b0) + np.outer(a0, b1))
                                      << 7) + np.outer(a0, b0)
    np.testing.assert_array_equal(got, np.outer(a, b))


def test_sub_digit_recombine_wraps_like_the_partial():
    """A contraction whose shifted sub-accumulator 2^14 * s11 passes 2^31
    while the partial does not: the int32 arithmetic, exact mod 2^32, still
    gives the partial."""
    k = 4000
    a = np.full(k, 448, dtype=np.int64)     # X1 = 4,  X0 = -64
    b = np.full(k, 1088, dtype=np.int64)    # X1 = 9,  X0 = -64 (|U| <= 1152)
    a1, a0 = (t.numpy().astype(np.int64) for t in _sub_split(a))
    b1, b0 = (t.numpy().astype(np.int64) for t in _sub_split(b))
    s11, s1x = _wrap32(a1 @ b1), _wrap32(a1 @ b0 + a0 @ b1)
    s00 = _wrap32(a0 @ b0)
    assert (s11 << 14) >= 2**31                # the shifted term wraps
    exact = int(a @ b)
    assert abs(exact) < 2**31                  # the partial does not
    got = _wrap32(_wrap32(s11 << 14) + _wrap32(s1x << 7) + s00)
    assert int(got) == exact


# ---------------------------------------------------------------------------
# Winograd's K/point walk.
# ---------------------------------------------------------------------------

#: (A outer plane, B outer plane, limb it feeds, sign) per pass: outer
#: planes h = 0, l = 1, h + l = 2; limbs hh = 0, mid = 1, ll = 2.
_WINOGRAD_PASSES = {
    "karatsuba": ((0, 0, 0, 1), (0, 0, 1, -1), (1, 1, 2, 1), (1, 1, 1, -1),
                  (2, 2, 1, 1)),
    "schoolbook": ((0, 0, 0, 1), (1, 1, 2, 1), (0, 1, 1, 1), (1, 0, 1, 1)),
}


def _winograd_walk(x, uh, ul, s_tile, wscale4, bias, *, pads, out_hw,
                   variant, base_bits, sms=H100_SMS):
    """The kernel's arithmetic: per split of :func:`winograd_plan` and per
    chunk of WINOGRAD_CHUNK channels and point, the sub-digit products of
    each pass recombined by shifts in int32, folded at once into the split's
    inverse-transform int32 sums with the AT coefficients; the splits' sums
    added in int32; one f32 recombine and the epilogue at the end."""
    n, h, w, cin = x.shape
    cout = uh.shape[3]
    ho, wo = out_hw
    th, tw = s_tile.shape[1:]
    pad_t, pad_l = pads
    xp = torch.nn.functional.pad(
        x, (0, 0, pad_l, max(2 * tw + 2 - w - pad_l, 0),
            pad_t, max(2 * th + 2 - h - pad_t, 0)))
    x4 = torch.stack([torch.stack([
        xp[:, u:u + 2 * th - 1:2, v:v + 2 * tw - 1:2] for v in range(4)])
        for u in range(4)])
    q4 = psub.quantize_values(x4, s_tile[..., None],
                              psub.kom_qmax(base_bits))
    vh, vl = pwin.winograd_input_planes(q4, base_bits)
    m = n * th * tw
    va = [t.reshape(16, m, cin) for t in (vh, vl, vh + vl)]
    ub = [t.to(torch.int32).reshape(16, cin, cout) for t in (uh, ul)]
    ub.append(ub[0] + ub[1])
    subs = lambda t: [d.numpy().astype(np.int64) for d in _sub_split(t)]
    va, ub = [subs(t) for t in va], [subs(t) for t in ub]
    plan = pwin.winograd_plan(m, cin, cout, sms=sms)
    y = np.zeros((3, 4, m, cout), dtype=np.int64)
    for z in range(plan["splits"]):
        ys = np.zeros_like(y)
        first = z * plan["per_split"]
        for chunk in range(first, min(first + plan["per_split"],
                                      plan["chunks"])):
            c0 = chunk * pwin.WINOGRAD_CHUNK
            ch = slice(c0, c0 + pwin.WINOGRAD_CHUNK)
            for p in range(16):
                u, v = divmod(p, 4)
                for oa, ob, limb, sign in _WINOGRAD_PASSES[variant]:
                    (a1, a0), (b1, b0) = va[oa], ub[ob]
                    dot = lambda s, t: _wrap32(s[p][:, ch] @ t[p][ch])
                    r = _wrap32((dot(a1, b1) << 14)
                                + (_wrap32(dot(a1, b0) + dot(a0, b1)) << 7)
                                + dot(a0, b0))
                    for o in range(4):
                        c = sign * pwin.AT[o // 2][u] * pwin.AT[o % 2][v]
                        ys[limb, o] = _wrap32(ys[limb, o] + c * r)
        y = _wrap32(y + ys)
    y = torch.from_numpy(y.astype(np.int32)).reshape(3, 2, 2, n, th, tw,
                                                      cout)
    raw = psub.limb_recombine(*y, base_bits=base_bits)
    raw = raw.permute(2, 3, 0, 4, 1, 5).reshape(n, 2 * th, 2 * tw, cout)
    t = pwin.tile_scales_upsampled(s_tile, ho, wo)[..., None] * wscale4
    return psub.dequant_epilogue(raw[:, :ho, :wo], t, bias)


def _winograd_operands(rng, n, h, cin, cout, base_bits, padding="SAME"):
    """The ops wrapper's operands for a random layer: input, weight planes,
    tile scales, the 1/4-folded channel scales, pads and output size."""
    x = np.maximum(rng.standard_normal((n, h, h, cin)), 0).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    qw = psub.quantize_weight(_t(w), base_bits=base_bits)
    ho, wo, pads = psub.conv_pads(h, h, 3, 3, 1, padding)
    s_tile = pwin.tile_scales_from_cmax(
        pops._padded_cmax(_t(x), pads), psub.kom_qmax(base_bits),
        -(-ho // 2), -(-wo // 2))
    uh, ul = pwin.winograd_weight_planes(qw.values, base_bits)
    wscale4 = qw.scale * float(np.float32(1 / pwin.WINOGRAD_OUTPUT_SCALE))
    return x, w, _t(x), uh, ul, s_tile, wscale4, (pads[0][0], pads[1][0]), \
        (ho, wo)


@pytest.mark.parametrize("tiles,cin,cout,splits", [
    (784, 256, 384, 4), (784, 384, 384, 4), (784, 384, 256, 4),  # AlexNet
    (49, 256, 384, 4), (4096, 256, 256, 1), (2112, 64, 128, 1),
    (40, 40, 9, 2), (16, 3, 4, 1)])
def test_winograd_plan_splits_chunks(tiles, cin, cout, splits):
    """AlexNet conv3-5 at batch 16: 147, 147 and 98 blocks on 132 SMs, so
    two waves, two and one; four splits bring them to 1.25, 1.25 and 0.75
    waves per unit of work."""
    plan = pwin.winograd_plan(tiles, cin, cout, sms=H100_SMS)
    assert plan["splits"] == splits
    assert plan["chunks"] == -(-cin // pwin.WINOGRAD_CHUNK)
    assert (plan["splits"] - 1) * plan["per_split"] < plan["chunks"] \
        <= plan["splits"] * plan["per_split"]


@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("n,h,cin,cout,padding,sms", [
    (2, 7, 40, 9, "SAME", H100_SMS),  # two chunks in two splits; odd map
    (2, 7, 40, 9, "SAME", 1),         # the same, one split
    (1, 10, 70, 5, "VALID", H100_SMS),  # three chunks in three splits
    (3, 5, 3, 4, "SAME", H100_SMS),   # the stem's 3 channels in one chunk
])
def test_winograd_walk_equals_plain_version(variant, base_bits, n, h, cin,
                                            cout, padding, sms):
    rng = np.random.default_rng(h * cin + cout)
    _, _, x, uh, ul, s_tile, ws4, pads, out_hw = _winograd_operands(
        rng, n, h, cin, cout, base_bits, padding)
    bias = _t(rng.standard_normal(cout).astype(np.float32))
    kw_ = dict(pads=pads, out_hw=out_hw, variant=variant,
               base_bits=base_bits)
    tiles = n * s_tile.shape[1] * s_tile.shape[2]
    assert (pwin.winograd_plan(tiles, cin, cout, sms=sms)["splits"] > 1) \
        == (sms == H100_SMS and cin > pwin.WINOGRAD_CHUNK)
    got = _winograd_walk(x, uh, ul, s_tile, ws4, bias, sms=sms, **kw_)
    want = pwin.conv2d_winograd_raw_plain(x, uh, ul, s_tile, ws4, bias,
                                          **kw_)
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant,base_bits", SPECS)
def test_winograd_walk_equals_reference_kernel(variant, base_bits):
    """Two chunks and an odd map against the reference's Pallas
    ``_winograd_kernel`` in interpret mode."""
    rng = np.random.default_rng(17)
    xn, w, x, uh, ul, s_tile, ws4, pads, out_hw = _winograd_operands(
        rng, 1, 7, 40, 8, base_bits)
    got = _winograd_walk(x, uh, ul, s_tile, ws4, None, pads=pads,
                         out_hw=out_hw, variant=variant, base_bits=base_bits)
    want = rops.conv2d_winograd(
        jnp.asarray(xn), rsub.quantize_weight(jnp.asarray(w),
                                              base_bits=base_bits),
        variant=variant, base_bits=base_bits, block=(1, 8),
        use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The systolic conv's plan and K walk.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,hw,k,cin,cout,vector", [
    (8, 224, 3, 3, 64, False), (8, 224, 3, 64, 64, True),
    (8, 56, 3, 256, 256, True), (8, 14, 3, 512, 512, True),
    (1, 14, 3, 512, 512, True), (3, 9, 5, 40, 70, True),
    (2, 13, 3, 37, 130, False), (16, 27, 5, 96, 256, True)])
def test_systolic_plan_walks_k_once(n, hw, k, cin, cout, vector):
    plan = pconv.systolic_plan(n, hw, hw, k, k, cin, cout, vector=vector,
                               sms=H100_SMS)
    assert plan["flat"] == (not vector)
    assert (plan["bm"], plan["bn"]) == ((128, 64) if cout <= 64
                                        else (64, 128))
    splits = pconv.systolic_k_steps(plan, cin)
    assert len(splits) == plan["splits"] <= pconv.SYSTOLIC_MAX_SPLITS
    assert all(0 < len(s) <= plan["per_split"] for s in splits)
    seen = [kk for s in splits for k0, k1 in s for kk in range(k0, k1)]
    assert sorted(seen) == list(range(k * k * cin))
    for s in splits:
        for k0, k1 in s:
            assert 0 < k1 - k0 <= pconv.SYSTOLIC_STEP_K
            if not plan["flat"]:   # a step stays within one tap
                assert k0 // cin == (k1 - 1) // cin
    if plan["tiles"] >= H100_SMS:
        assert plan["splits"] == 1


def test_systolic_plan_splits_only_the_small_vgg16_grids():
    """At batch 8 only the 14 x 14 layers have fewer tiles than SMs; their
    split brings the waves per unit of work from 1 to 0.8 (the other
    layers' grids are whole waves, or within 3% of them)."""
    for g in cnn_conv_geometries(VGG16):
        plan = pconv.systolic_plan(8, g["h"], g["h"], 3, 3, g["cin"],
                                   g["cout"], vector=g["cin"] % 8 == 0,
                                   sms=H100_SMS)
        assert plan["flat"] == (g["cin"] == 3)
        assert (plan["splits"] > 1) == (g["h"] == 14), g
        if g["h"] == 14:
            assert plan["tiles"] == 100 and plan["splits"] == 5


def _systolic_walk(xq, wq, scale, bias, *, stride, pads, out_hw, variant,
                   base_bits, sms):
    """The kernel's arithmetic: per split, the int32 limb partials of its K
    steps (ranges of the flat (tap, channel) index); the splits' sums added
    in int32; one recombine; the epilogue fl(fl(raw * scale) + b)."""
    n, h, wd, cin = xq.shape
    kh, kw, _, cout = wq.shape
    ho, wo = out_hw
    pad_t, pad_l = pads
    xp = torch.nn.functional.pad(
        xq.to(torch.int32),
        (0, 0, pad_l, max((wo - 1) * stride + kw - wd - pad_l, 0),
         pad_t, max((ho - 1) * stride + kh - h - pad_t, 0)))
    patches = torch.cat([
        xp[:, dy:dy + (ho - 1) * stride + 1:stride,
           dx:dx + (wo - 1) * stride + 1:stride]
        for dy in range(kh) for dx in range(kw)], dim=3)
    patches = patches.reshape(n * ho * wo, kh * kw * cin)
    wf = wq.to(torch.int32).reshape(kh * kw * cin, cout)
    plan = pconv.systolic_plan(n, ho, wo, kh, kw, cin, cout,
                               vector=cin % 8 == 0, sms=sms)
    total = None
    for split in pconv.systolic_k_steps(plan, cin):
        part = None
        for k0, k1 in split:
            p = psub.limb_partials(patches[:, k0:k1], wf[k0:k1],
                                   variant=variant, base_bits=base_bits)
            part = p if part is None else tuple(a + b for a, b in
                                                zip(part, p))
        total = part if total is None else tuple(
            a + b for a, b in zip(total, part))
    raw = psub.limb_recombine(*total, base_bits=base_bits).reshape(
        n, ho, wo, cout)
    if scale is None:
        return raw if bias is None else raw + bias
    return pconv.systolic_epilogue(raw, scale[:, None, None, :], bias)


@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("n,h,cin,k,cout,stride,padding,sms,split", [
    (2, 9, 3, 3, 7, 1, "SAME", H100_SMS, False),   # the stem: one flat step
    (2, 9, 3, 5, 7, 1, "SAME", H100_SMS, True),    # two flat steps, split
    (2, 10, 16, 3, 70, 1, "SAME", H100_SMS, True),  # taps, 64 x 128 tiles
    (1, 11, 12, 5, 6, 2, "VALID", H100_SMS, True),  # flat, stride 2, VALID
    (2, 8, 72, 3, 130, 1, "SAME", H100_SMS, True),  # 64 + 8 channels a tap
    (2, 8, 72, 3, 130, 1, "SAME", 1, False),        # the same, one split
])
def test_systolic_walk_equals_plain_version(variant, base_bits, n, h, cin,
                                            k, cout, stride, padding, sms,
                                            split):
    rng = np.random.default_rng(h * cin + k + cout)
    qmax = psub.kom_qmax(base_bits)
    xq = _t(rng.integers(-qmax, qmax + 1, (n, h, h, cin)).astype(np.int16))
    wq = _t(rng.integers(-qmax, qmax + 1, (k, k, cin, cout)).astype(
        np.int16))
    scale = _t((rng.random((n, cout)) * 1e-4).astype(np.float32))
    bias = _t(rng.standard_normal(cout).astype(np.float32))
    ho, wo, pads = psub.conv_pads(h, h, k, k, stride, padding)
    kw_ = dict(stride=stride, pads=(pads[0][0], pads[1][0]),
               out_hw=(ho, wo), variant=variant, base_bits=base_bits)
    plan = pconv.systolic_plan(n, ho, wo, k, k, cin, cout,
                               vector=cin % 8 == 0, sms=sms)
    assert (plan["splits"] > 1) == split
    got = _systolic_walk(xq, wq, scale, bias, sms=sms, **kw_)
    want = pconv.conv2d_systolic_raw_plain(xq, wq, scale, bias, **kw_)
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("cin", [12, 16])   # flat walk, tap walk
def test_systolic_walk_equals_reference_kernel(variant, base_bits, cin):
    """Split K steps against ``conv2d_systolic_raw`` (the reference's Pallas
    ``_conv_kernel`` in interpret mode) on the padded input, with and
    without the (n, cout) scale."""
    rng = np.random.default_rng(cin)
    qmax = psub.kom_qmax(base_bits)
    xq = rng.integers(-qmax, qmax + 1, (2, 10, 10, cin)).astype(np.int16)
    wq = rng.integers(-qmax, qmax + 1, (3, 3, cin, 8)).astype(np.int16)
    sc = (rng.random((2, 8)) * 1e-4).astype(np.float32)
    # The reference wants a spare halo row block: 8 output rows in blocks
    # of 4 read 12 padded rows (10 + 1 top + 1 bottom).
    xp = np.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)))
    for scale in (sc, None):
        want = np.asarray(rconv.conv2d_systolic_raw(
            jnp.asarray(xp), jnp.asarray(wq), out_h=8, block_h=4,
            block_c=8, variant=variant, base_bits=base_bits,
            scale=None if scale is None else jnp.asarray(scale),
            interpret=True))
        got = _systolic_walk(
            _t(xq), _t(wq), None if scale is None else _t(scale), None,
            stride=1, pads=(1, 1), out_hw=(10, 10), variant=variant,
            base_bits=base_bits, sms=H100_SMS)
        np.testing.assert_array_equal(got.numpy()[:, :8], want)
