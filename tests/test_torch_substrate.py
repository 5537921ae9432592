"""The port's limb substrate held bit for bit against the JAX reference.

Same inputs (seeded numpy) through ``repro.core.substrate`` and
``repro_torch.core.substrate``; tolerance 0 everywhere: quantized integers,
int32 limb partials and dequantized outputs must be equal.  The reference
runs on the CPU (``JAX_PLATFORMS=cpu``) and, where the serving forward is
jitted, under ``jax.jit`` -- the regime whose rounding the port reproduces.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import substrate as ref  # noqa: E402
from repro_torch.core import substrate as port  # noqa: E402

torch.set_num_threads(2)

SPECS = [("karatsuba", 7), ("schoolbook", 8)]
POLICIES = ["kom_int14", "schoolbook_int16"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ints(rng, shape, qmax):
    return rng.integers(-qmax, qmax + 1, shape).astype(np.int32)


@pytest.mark.parametrize("base_bits", [7, 8])
def test_balanced_split_matches_reference(base_bits):
    rng = np.random.default_rng(0)
    qmax = port.kom_qmax(base_bits)
    assert qmax == ref.kom_qmax(base_bits)
    x = _ints(rng, (4096,), qmax)
    x[:4] = [qmax, -qmax, 0, -1]
    rh, rl = (np.asarray(v) for v in ref.balanced_split(jnp.asarray(x),
                                                        base_bits))
    ph, pl = (v.numpy() for v in port.balanced_split(_t(x), base_bits))
    np.testing.assert_array_equal(ph, rh)
    np.testing.assert_array_equal(pl, rl)
    half = 1 << (base_bits - 1)
    assert pl.min() >= -half and pl.max() <= half - 1
    assert ph.min() >= -half and ph.max() <= half - 1


@pytest.mark.parametrize("variant,base_bits", SPECS)
def test_limb_partials_and_dot_match_reference(variant, base_bits):
    """int32 partials equal the reference's int8-pass partials; the
    recombine equals the reference in f32 and numpy int64 in int64."""
    rng = np.random.default_rng(1)
    qmax = port.kom_qmax(base_bits)
    a, b = _ints(rng, (24, 1500), qmax), _ints(rng, (1500, 20), qmax)
    rp = ref.limb_partials(jnp.asarray(a), jnp.asarray(b),
                           variant=variant, base_bits=base_bits)
    pp = port.limb_partials(_t(a), _t(b), variant=variant,
                            base_bits=base_bits)
    for r, p in zip(rp, pp):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    rd = ref.limb_dot_general(jnp.asarray(a), jnp.asarray(b),
                              variant=variant, base_bits=base_bits)
    pd = port.limb_dot_general(_t(a), _t(b), variant=variant,
                               base_bits=base_bits)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    exact = port.limb_recombine(*pp, base_bits=base_bits, dtype=torch.int64)
    np.testing.assert_array_equal(exact.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_exact_int_matmul_chunks_past_f32_range():
    """Partial sums far beyond 2^24 stay exact through the chunked f32 GEMMs."""
    rng = np.random.default_rng(2)
    a = rng.integers(-128, 128, (8, 5000)).astype(np.int32)
    b = rng.integers(-128, 128, (5000, 6)).astype(np.int32)
    got = port.exact_int_matmul(_t(a), _t(b), term_bound=128 * 128)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)


@pytest.mark.parametrize("base_bits", [7, 8])
def test_quantize_weight_matches_eager_reference(base_bits):
    """Weight scales are a TRUE division (engine build runs eagerly)."""
    rng = np.random.default_rng(3)
    for shape in ((40, 24), (3, 3, 8, 16), (11, 11, 3, 12)):
        w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        rw = ref.quantize_weight(jnp.asarray(w), base_bits=base_bits)
        pw = port.quantize_weight(_t(w), base_bits=base_bits)
        assert pw.values.dtype == torch.int16
        np.testing.assert_array_equal(pw.values.numpy(),
                                      np.asarray(rw.values))
        np.testing.assert_array_equal(pw.scale.numpy(), np.asarray(rw.scale))


@pytest.mark.parametrize("base_bits", [7, 8])
def test_activation_scale_is_the_jitted_reciprocal_multiply(base_bits):
    """Under jit XLA turns ``max(amax, 1e-12) / qmax`` into a multiply by
    float32(1/qmax); the port's activation scales follow the jitted rule
    (which differs from a true division on many entries)."""
    rng = np.random.default_rng(4)
    qmax = port.kom_qmax(base_bits)
    x = (rng.standard_normal((2000, 33)) * 3).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes the 1e-12 floor
    rq = jax.jit(lambda v: ref.quantize_symmetric(
        v, base_bits=base_bits, axis=0))(jnp.asarray(x))
    pq = port.quantize_symmetric(_t(x), base_bits=base_bits, axis=0)
    np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(rq.scale))
    np.testing.assert_array_equal(pq.values.numpy(), np.asarray(rq.values))
    amax = np.abs(x).max(1, keepdims=True)
    true_div = np.maximum(amax, np.float32(1e-12)) / np.float32(qmax)
    assert (true_div != pq.scale.numpy()).any()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_prequant_dot_general_matches_jitted_reference(policy, with_bias):
    """The FC path: per-row quantize, limb GEMM, dequant, and the bias fused
    the way ``jax.jit`` fuses ``prequant_dot_general(x, w) + b`` (one FMA)."""
    variant, bb = port.INT_POLICY_SPECS[policy]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((37, 300)).astype(np.float32)
    w = (rng.standard_normal((300, 45)) * 0.05).astype(np.float32)
    b = rng.standard_normal((45,)).astype(np.float32)
    rw = ref.quantize_weight(jnp.asarray(w), base_bits=bb)
    pw = port.quantize_weight(_t(w), base_bits=bb)
    if with_bias:
        fn = jax.jit(lambda v, q, c: ref.prequant_dot_general(
            v, q, variant=variant) + c)
        want = np.asarray(fn(jnp.asarray(x), rw, jnp.asarray(b)))
    else:
        fn = jax.jit(lambda v, q: ref.prequant_dot_general(
            v, q, variant=variant))
        want = np.asarray(fn(jnp.asarray(x), rw))
    got = port.prequant_dot_general(_t(x), pw, variant=variant,
                                    bias=_t(b) if with_bias else None)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("policy", POLICIES)
def test_prequant_row_scale_matches_jitted_reference(policy):
    variant, bb = port.INT_POLICY_SPECS[policy]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((30, 64)).astype(np.float32)
    rs = (np.abs(rng.standard_normal((30, 1))) * 1e-3 + 1e-4).astype(
        np.float32)
    w = (rng.standard_normal((64, 8)) * 0.05).astype(np.float32)
    rw = ref.quantize_weight(jnp.asarray(w), base_bits=bb)
    want = jax.jit(lambda v, q, s: ref.prequant_dot_general(
        v, q, variant=variant, row_scale=s))(jnp.asarray(x), rw,
                                             jnp.asarray(rs))
    got = port.prequant_dot_general(
        _t(x), port.quantize_weight(_t(w), base_bits=bb), variant=variant,
        row_scale=_t(rs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dequant_epilogue_is_one_fma():
    """fma(raw, t, b) rounds once: it differs from fl(fl(raw*t) + b)."""
    rng = np.random.default_rng(7)
    raw = rng.integers(-2**24, 2**24, 4096).astype(np.float32)
    t = (rng.random(4096) * 1e-5).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    got = port.dequant_epilogue(_t(raw), _t(t), _t(b)).numpy()
    exact = raw.astype(np.float64) * t.astype(np.float64) + b
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    assert (got != (raw * t) + b).any()


def test_prequant_is_inference_only():
    pw = port.quantize_weight(torch.randn(16, 4), base_bits=7)
    x = torch.randn(3, 16, requires_grad=True)
    out = port.prequant_dot_general(x, pw)
    with pytest.raises(NotImplementedError, match="inference-only"):
        out.sum().backward()


def test_capability_tables_match_reference():
    pols = ["native_bf16", "bf16x3", "bf16x6", "kom_int14",
            "schoolbook_int16", "fp32"]
    for path in ("auto", "im2col", "systolic", "implicit", "winograd"):
        for pol in pols:
            assert port.path_supports_policy(path, pol) \
                == ref.path_supports_policy(path, pol), (path, pol)
        for fusion in ref.FUSIONS:
            assert port.path_supports_fusion(path, fusion) \
                == ref.path_supports_fusion(path, fusion), (path, fusion)
    assert port.INT_POLICY_SPECS == ref.INT_POLICY_SPECS


def test_conv_pads_and_dispatch_match_reference():
    """Off the TPU, with the thin-stem threshold 16, the port's path rule is
    the reference's."""
    for k in (1, 3, 5, 7, 11):
        for s in (1, 2, 4):
            for pad in ("SAME", "VALID"):
                for h in (13, 27, 32):
                    if pad == "VALID" and h < k:
                        continue
                    assert port.conv_pads(h, h, k, k, s, pad) \
                        == ref.conv_pads(h, h, k, k, s, pad)
                for cin in (3, 16, 64, 512, 3000):
                    for pol in POLICIES + ["fp32", "native_bf16"]:
                        for cached in (False, True):
                            kw = dict(kh=k, kw=k, stride=s, cin=cin,
                                      cout=128, policy=pol,
                                      cached_weight=cached, padding=pad)
                            assert port.select_conv_path(**kw) == \
                                ref.select_conv_path(on_tpu=False,
                                                     stem_cin=16, **kw), kw
