"""The port's kernel modules held bit for bit against the JAX reference.

Each module that holds a CUDA kernel (limb GEMM, implicit-GEMM conv,
Winograd conv) is checked through its plain PyTorch version -- what a CPU
tensor runs -- against the reference: the Pallas kernel in interpret mode
where it is cheap, otherwise the reference's own bitwise lax mirror under
``jax.jit``.  Tolerance 0 everywhere.  ``tests/test_torch_cuda.py`` holds
each CUDA kernel against these plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import substrate as rsub  # noqa: E402
from repro.kernels.conv2d import conv2d as rconv  # noqa: E402
from repro.kernels.conv2d import implicit_gemm as rimp  # noqa: E402
from repro.kernels.conv2d import ops as rops  # noqa: E402
from repro.kernels.conv2d import winograd as rwin  # noqa: E402
from repro.kernels.kom_matmul import ops as rkom  # noqa: E402
from repro_torch.core import substrate as psub  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.conv2d import conv2d as pconv  # noqa: E402
from repro_torch.kernels.conv2d import implicit_gemm as pimp  # noqa: E402
from repro_torch.kernels.conv2d import ops as pops  # noqa: E402
from repro_torch.kernels.conv2d import winograd as pwin  # noqa: E402
from repro_torch.kernels.kom_matmul import (kom_matmul_int,  # noqa: E402
                                            kom_matmul_int_plain)

torch.set_num_threads(2)

SPECS = [("karatsuba", 7), ("schoolbook", 8)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(rng, n, h, cin, k, cout, bb):
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    return x, w, b, rsub.quantize_weight(jnp.asarray(w), base_bits=bb), \
        psub.quantize_weight(_t(w), base_bits=bb)


# ---------------------------------------------------------------------------
# Limb GEMM.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,base_bits", SPECS)
def test_kom_matmul_int_matches_pallas_interpret(variant, base_bits):
    """Raw limb GEMM == the Pallas ``_int_kernel`` in interpret mode."""
    rng = np.random.default_rng(0)
    qmax = psub.kom_qmax(base_bits)
    a = rng.integers(-qmax, qmax + 1, (40, 200)).astype(np.int16)
    b = rng.integers(-qmax, qmax + 1, (200, 30)).astype(np.int16)
    want = rkom.kom_matmul_int(jnp.asarray(a), jnp.asarray(b),
                               base_bits=base_bits, variant=variant,
                               interpret=True)
    got = kom_matmul_int(_t(a), _t(b), variant=variant, base_bits=base_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kom_matmul_cpu_tensor_runs_plain_version():
    rng = np.random.default_rng(1)
    a = _t(rng.integers(-100, 100, (5, 9)).astype(np.int16))
    b = _t(rng.integers(-100, 100, (9, 3)).astype(np.int16))
    before = build.launch_counts()
    got = kom_matmul_int(a, b, variant="karatsuba", base_bits=7)
    assert build.launch_counts() == before
    np.testing.assert_array_equal(
        got.numpy(), kom_matmul_int_plain(a, b).numpy())
    np.testing.assert_array_equal(
        got.numpy(), (a.numpy().astype(np.int64) @ b.numpy()).astype(
            np.float32))
    with pytest.raises(ValueError):
        kom_matmul_int(a, b, row_scale=torch.ones(5))
    with pytest.raises(ValueError):
        kom_matmul_int(a, b, variant="karatsuba", base_bits=8)


# ---------------------------------------------------------------------------
# Schedules, bounds, scale plans, transforms.
# ---------------------------------------------------------------------------

def test_schedules_and_bounds_match_reference():
    for variant, bb in SPECS:
        kw = dict(variant=variant, base_bits=bb)
        assert pconv.limb_term_bound(variant, bb) \
            == rconv.limb_term_bound(variant, bb)
        for k in (1, 3, 5, 11):
            assert pimp.max_cin_block(k, k, **kw) \
                == rimp.max_cin_block(k, k, **kw)
            for cin in (3, 96, 512, 4000, 100000):
                assert pconv.int_accum_bound(k, k, cin, **kw) \
                    == rconv.int_accum_bound(k, k, cin, **kw)
                for bk in (1, 8, 64, 512):
                    try:
                        want = rimp.recombine_schedule(k, k, cin, bk, **kw)
                    except ValueError:
                        with pytest.raises(ValueError):
                            pimp.recombine_schedule(k, k, cin, bk, **kw)
                        continue
                    assert pimp.recombine_schedule(k, k, cin, bk, **kw) \
                        == want
                    assert pimp.group_spans(cin, bk, want) \
                        == rimp.group_spans(cin, bk, want)
        for cin in (3, 16, 384, 1820, 1821, 2427, 2428):
            assert pwin.winograd_accum_bound(cin, **kw) \
                == rwin.winograd_accum_bound(cin, **kw)
            for k, s in ((3, 1), (3, 2), (5, 1)):
                assert pwin.winograd_scale_eligible(k, k, s, cin, **kw) \
                    == rwin.winograd_scale_eligible(k, k, s, cin, **kw)
        for kdim in (3, 16, 170, 384, 512, 2000):
            assert pwin.mirror_schedule(kdim, bb) \
                == rwin._mirror_schedule(kdim, bb)


@pytest.mark.parametrize("base_bits", [7, 8])
def test_winograd_transforms_match_reference(base_bits):
    rng = np.random.default_rng(2)
    qmax = psub.kom_qmax(base_bits)
    w = rng.integers(-qmax, qmax + 1, (3, 3, 6, 5)).astype(np.int16)
    for r, p in zip(rwin.winograd_weight_planes(jnp.asarray(w), base_bits),
                    pwin.winograd_weight_planes(_t(w), base_bits)):
        assert p.dtype == torch.int16
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    q4 = rng.integers(-qmax, qmax + 1, (4, 4, 2, 3, 7)).astype(np.int32)
    for r, p in zip(rwin.winograd_input_planes(jnp.asarray(q4), base_bits),
                    pwin.winograd_input_planes(_t(q4), base_bits)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    m = [rng.integers(-2**26, 2**26, (4, 4, 3, 5)).astype(np.int32)
         for _ in range(3)]
    want = rwin.winograd_inverse(*(jnp.asarray(v) for v in m),
                                 base_bits=base_bits)
    got = pwin.winograd_inverse(*(_t(v) for v in m), base_bits=base_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scale_plans_match_jitted_reference():
    rng = np.random.default_rng(3)
    xp = rng.standard_normal((2, 15, 17, 5)).astype(np.float32)
    for bb in (7, 8):
        qmax = psub.kom_qmax(bb)
        want = jax.jit(lambda v: rwin.tile_scale_grid(v, qmax, 7, 8))(
            jnp.asarray(xp))
        got = pwin.tile_scale_grid(_t(xp), qmax, 7, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            pwin.tile_scales_upsampled(got, 13, 15).numpy(),
            np.asarray(rwin.tile_scales_upsampled(want, 13, 15)))
        for k, s in ((5, 1), (3, 2), (11, 4)):
            want = jax.jit(lambda v: rops._patch_scales(v, k, k, s, qmax))(
                jnp.asarray(xp))
            got = pops.patch_scales(pwin.channel_absmax(_t(xp)), k, k, s,
                                    qmax)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Conv engines: port (plain version) vs jitted reference, bias included.
# ---------------------------------------------------------------------------

IMPLICIT_CASES = [
    # (h, cin, cout, k, stride, padding, block, fold_every)
    (9, 24, 20, 5, 1, "SAME", (8, 128, 24), None),
    (15, 20, 12, 3, 2, "VALID", (8, 128, 20), None),
    (19, 16, 8, 7, 4, "VALID", (8, 128, 16), None),
    (12, 32, 16, 3, 1, "SAME", (8, 128, 8), 2),   # 2 recombine groups
    (9, 24, 16, 3, 2, "SAME", (8, 128, 8), 1),    # 3 recombine groups
]


@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("case", IMPLICIT_CASES)
def test_conv2d_implicit_matches_jitted_reference(variant, base_bits, case):
    h, cin, cout, k, s, pad, block, fold = case
    rng = np.random.default_rng(4)
    x, _, b, rw, pw = _case(rng, 2, h, cin, k, cout, base_bits)
    fn = jax.jit(lambda v, q, c: rops.conv2d_implicit(
        v, q, stride=s, padding=pad, variant=variant, base_bits=base_bits,
        bias=c, activation="relu", block=block, fold_every=fold))
    want = np.asarray(fn(jnp.asarray(x), rw, jnp.asarray(b)))
    got = pops.conv2d_implicit(_t(x), pw, stride=s, padding=pad,
                               variant=variant, base_bits=base_bits,
                               bias=_t(b), activation="relu", block=block,
                               fold_every=fold)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant,base_bits", SPECS)
def test_conv2d_implicit_matches_pallas_interpret(variant, base_bits):
    """Without a bias (the Pallas kernel's own output, fl(raw * t)), the
    port equals ``_implicit_kernel`` run in interpret mode."""
    rng = np.random.default_rng(5)
    x, _, _, rw, pw = _case(rng, 1, 9, 16, 5, 8, base_bits)
    want = rops.conv2d_implicit(jnp.asarray(x), rw, variant=variant,
                                base_bits=base_bits, block=(8, 128, 16),
                                use_pallas=True, interpret=True)
    got = pops.conv2d_implicit(_t(x), pw, variant=variant,
                               base_bits=base_bits, block=(8, 128, 16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("h,cin,cout,n", [(13, 16, 24, 2), (7, 24, 8, 1),
                                          (8, 32, 16, 2)])
def test_conv2d_winograd_matches_jitted_reference(variant, base_bits, h,
                                                  cin, cout, n):
    rng = np.random.default_rng(6)
    x, _, b, rw, pw = _case(rng, n, h, cin, 3, cout, base_bits)
    fn = jax.jit(lambda v, q, c: rops.conv2d_winograd(
        v, q, variant=variant, base_bits=base_bits, bias=c,
        activation="relu"))
    want = np.asarray(fn(jnp.asarray(x), rw, jnp.asarray(b)))
    got = pops.conv2d_winograd(_t(x), pw, variant=variant,
                               base_bits=base_bits, bias=_t(b),
                               activation="relu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant,base_bits", SPECS)
def test_conv2d_winograd_matches_pallas_interpret(variant, base_bits):
    rng = np.random.default_rng(7)
    x, _, _, rw, pw = _case(rng, 1, 6, 16, 3, 8, base_bits)
    want = rops.conv2d_winograd(jnp.asarray(x), rw, variant=variant,
                                base_bits=base_bits, block=(1, 8),
                                use_pallas=True, interpret=True)
    got = pops.conv2d_winograd(_t(x), pw, variant=variant,
                               base_bits=base_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("policy", ["kom_int14", "schoolbook_int16"])
@pytest.mark.parametrize("k,s,pad,h", [(11, 4, "VALID", 35),
                                       (3, 1, "SAME", 12)])
def test_im2col_stem_matches_jitted_reference(policy, k, s, pad, h):
    """The RGB stem: patch columns in (cin, kh, kw) order, per-row scales
    (or the shared tile scales on the 3x3/s1 stem), bias in the FMA."""
    bb = psub.INT_POLICY_SPECS[policy][1]
    rng = np.random.default_rng(8)
    x, _, b, rw, pw = _case(rng, 2, h, 3, k, 12, bb)
    fn = jax.jit(lambda v, q, c: rsub.conv2d(
        v, q, stride=s, padding=pad, policy=policy, path="im2col", bias=c,
        activation="relu"))
    want = np.asarray(fn(jnp.asarray(x), rw, jnp.asarray(b)))
    got = psub.conv2d(_t(x), pw, stride=s, padding=pad, policy=policy,
                      path="im2col", bias=_t(b), activation="relu")
    np.testing.assert_array_equal(got.numpy(), want)
