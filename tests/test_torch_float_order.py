"""The float conv kernel's own sum order, emulated on the CPU.

``csrc/implicit_conv_float.cu`` cannot run here, so its f32 arithmetic is
replayed step by step (:data:`~repro_torch.kernels.conv2d.implicit_gemm.
FLOAT_CHUNK`, ``FLOAT_MMA_K``) on one 64 x 64 output slice and held
against the plain version, each schedule's exact value rounded once
(which ``tests/test_torch_float.py`` holds against the JAX reference):
within ``1e-6 * max|plain|``, while the neighbouring schedule's plain value
must miss that tolerance.  Two shapes: VGG16's deepest K (3 x 3 x 512, tap
outer) and the stem's folded K (3 x 3 x 3 = 27 flat entries).

* ``native`` (SIMT): one f32 FMA per product into a chunk partial, the
  chunk added into the total.
* ``bf16x3`` / ``bf16x6`` (tensor cores): per k16 step a fragment from
  zero takes the schedule's limb pairs in the kernel's order, each an MMA
  whose sum of exact products the tensor core rounds its own way; the
  fragment is added into a chunk partial, the chunk into the total.  Two
  models of the MMA, both pessimistic against what the card's probe
  measured (``repro_torch.analysis.mma_probe``): the exact sum rounded
  toward zero once per MMA (``rtz``), and each addend first cut toward zero
  to the largest addend's f32 grid (``align``).
"""
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis.mma_probe import align_rtz, rtz_f32  # noqa: E402
from repro_torch.core import karatsuba as pkar  # noqa: E402
from repro_torch.kernels.conv2d.implicit_gemm import (  # noqa: E402
    FLOAT_CHUNK, FLOAT_MMA_K, conv2d_implicit_float_plain)

TOL = 1e-6
NEIGHBOUR = {"native": "bf16x3", "bf16x3": "native", "bf16x6": "bf16x3"}
#: The kernel's limbs and limb pairs, in its order (the reference's
#: ``_BF16_PAIRS``; ``BF16X6_TAP`` in ``csrc/float_tile.cuh``).
MMA_PAIRS = {"bf16x3": (2, ((0, 0), (0, 1), (1, 0))),
             "bf16x6": (3, ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1),
                            (2, 0)))}


def _f32(t):
    """Round to f32, kept as f64 for the next exact step."""
    return t.to(torch.float32).to(torch.float64)


def _inputs(cin):
    """An 8 x 8 map (64 output pixels) and 64 output channels, 3 x 3 SAME:
    the patch matrix (64, 9 * cin) in the kernel's (tap, channel) order,
    the weight (9 * cin, 64), and the plain version's args."""
    g = torch.Generator().manual_seed(cin)
    x = torch.randn((1, 8, 8, cin), generator=g)
    if cin > 3:
        x = torch.relu(x)  # a ReLU'd activation, as inside VGG16
    w = torch.randn((3, 3, cin, 64), generator=g) * (9 * cin) ** -0.5
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    a = torch.cat([xp[:, dy:dy + 8, dx:dx + 8] for dy in range(3)
                   for dx in range(3)], dim=-1).reshape(64, 9 * cin)
    return a, w.reshape(9 * cin, 64), (x, w)


def _plain(args, variant):
    x, w = args
    return conv2d_implicit_float_plain(
        x, w, None, stride=1, pads=(1, 1), out_hw=(8, 8),
        variant=variant).reshape(64, 64).double()


def _closes_chunk(k_end, cin, ktot, chunk):
    """Whether the K entries before ``k_end`` close a partial: per tap where
    the kernel walks the taps (cin 512), over the flat K where it folds them
    (the stem's cin 3)."""
    if cin > 3:
        c_end = (k_end - 1) % cin + 1
        return c_end % chunk == 0 or c_end == cin
    return k_end % chunk == 0 or k_end >= ktot


def _by_groups(group_sum, ktot, groups):
    """The tap groups' totals (each over ``ktot / groups`` K entries, whole
    taps) added in order, as the kernel's second pass adds them."""
    span = ktot // groups
    total = None
    for g in range(groups):
        t = group_sum(g * span, (g + 1) * span)
        total = t if total is None else _f32(total + t)
    return total


def simt_order(a, b, cin, groups=1):
    """native: ``part = fma(a, b, part)`` per K entry (the f64 product of
    two f32 is exact), ``acc += part`` at each chunk's end, per tap
    group."""
    a, b = a.double(), b.double()
    ktot = a.shape[1]

    def group_sum(k0, k1):
        part = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64)
        acc = torch.zeros_like(part)
        for kk in range(k0, k1):
            part = _f32(part + a[:, kk, None] * b[None, kk, :])
            if _closes_chunk(kk + 1, cin, ktot, FLOAT_CHUNK["simt"]):
                acc, part = _f32(acc + part), torch.zeros_like(part)
        return acc
    return _by_groups(group_sum, ktot, groups)


def mma_order(a, b, cin, variant, model, groups=1):
    """bf16x3/bf16x6 on the tensor cores, per k16 step: a fragment from
    zero takes each limb pair as one MMA (``model``: ``rtz`` or
    ``align``), then ``part += frag``; ``acc += part`` at each chunk's
    end, per tap group.  The folded K is zero-padded to whole k16 steps."""
    limbs, pairs = MMA_PAIRS[variant]
    ktot = a.shape[1]
    kpad = -(-ktot // FLOAT_MMA_K) * FLOAT_MMA_K
    la = [F.pad(t.double(), (0, kpad - ktot))
          for t in pkar.float_split(a, limbs)]
    lb = [F.pad(t.double(), (0, 0, 0, kpad - ktot))
          for t in pkar.float_split(b, limbs)]

    def group_sum(k0, k1):
        part = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64)
        acc = torch.zeros_like(part)
        for s0 in range(k0, k1, FLOAT_MMA_K):
            ks = slice(s0, s0 + FLOAT_MMA_K)
            frag = torch.zeros_like(part)
            for i, j in pairs:
                if model == "rtz":
                    frag = rtz_f32(frag + la[i][:, ks] @ lb[j][ks])
                else:
                    prods = la[i][:, ks, None] * lb[j][None, ks, :]
                    frag = align_rtz(torch.cat([prods.permute(0, 2, 1),
                                                frag[..., None]], dim=-1))
            part = _f32(part + frag)
            if _closes_chunk(min(s0 + FLOAT_MMA_K, ktot), cin, ktot,
                             FLOAT_CHUNK["mma"]):
                acc, part = _f32(acc + part), torch.zeros_like(part)
        return acc
    return _by_groups(group_sum, kpad if groups == 1 else ktot, groups)


def _held(got, args, variant):
    want = _plain(args, variant)
    peak = float(want.abs().max())
    err = float((got - want).abs().max()) / peak
    gap = float((_plain(args, NEIGHBOUR[variant]) - want).abs().max()) / peak
    assert err <= TOL, (variant, err)
    assert gap > TOL, (variant, gap)


#: (label, cin, tap groups): the folded stem never splits; the deepest K
#: runs whole or in the 3 or 9 groups of VGG16's 28 x 28 and 14 x 14
#: layers at batch 8.
CASES = [("stem", 3, 1), ("deepest", 512, 1), ("deepest", 512, 3),
         ("deepest", 512, 9)]


@pytest.mark.parametrize("label,cin,groups", CASES)
def test_native_simt_order_stays_within_float_tol(label, cin, groups):
    a, b, args = _inputs(cin)
    _held(simt_order(a, b, cin, groups), args, "native")


@pytest.mark.parametrize("model", ["rtz", "align"])
@pytest.mark.parametrize("variant", ["bf16x3", "bf16x6"])
@pytest.mark.parametrize("label,cin,groups", CASES)
def test_bf16_mma_order_stays_within_float_tol(label, cin, groups, variant,
                                               model):
    a, b, args = _inputs(cin)
    _held(mma_order(a, b, cin, variant, model, groups), args, variant)


def test_chunks_close_at_tap_and_chunk_ends():
    """The per-tap path closes a partial every FLOAT_CHUNK channels and at
    each tap's end; the folded path over the flat K."""
    ends = [k for k in range(1, 9 * 512 + 1)
            if k % FLOAT_MMA_K == 0 and _closes_chunk(k, 512, 9 * 512, 128)]
    assert ends == list(range(128, 9 * 512 + 1, 128))
    assert [k for k in range(1, 28) if _closes_chunk(k, 3, 27, 128)] == [27]
    assert _closes_chunk(96, 96, 864, 512) and \
        not _closes_chunk(64, 96, 864, 512)


def test_mma_models_bound_their_error():
    """``rtz`` rounds toward zero, to the f32 next to the exact sum;
    ``align`` cuts each of the 17 addends by less than one unit of the top
    addend's f32 grid, then rounds toward zero."""
    g = torch.Generator().manual_seed(0)
    terms = torch.randn((512, 17), generator=g, dtype=torch.float64)
    exact = terms.sum(dim=-1)
    got = rtz_f32(exact)
    grid = torch.exp2(torch.floor(torch.log2(terms.abs().amax(dim=-1))) - 23)
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs())) - 23)
    assert bool(((got - exact) * exact.sign() <= 0).all())
    assert bool(((got - exact).abs() < ulp).all())
    assert bool(((align_rtz(terms) - exact).abs() <= 17 * grid + ulp).all())
