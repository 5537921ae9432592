"""The port's systolic conv engine held bit for bit against the JAX reference.

The integer variants of the systolic kernel's plain version (what a CPU
tensor runs) against the reference's ``conv2d_systolic`` with its Pallas
``_conv_kernel`` in interpret mode, and reduced AlexNet/VGG16/VGG19 with
``conv_path="systolic"`` under both integer policies against
``jax.jit(cnn_forward)``: tolerance 0.  The epilogue's rounding
(``fl(fl(raw * t) + b)``, no FMA) is pinned by a mutant that contracts it
and must then disagree with the reference under ``schoolbook_int16``.
``tests/test_torch_cuda.py`` holds the CUDA kernel against the plain
version on the card.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import substrate as rsub  # noqa: E402
from repro.core.precision import MatmulPolicy as RefPolicy  # noqa: E402
from repro.kernels.conv2d import conv2d as rconv  # noqa: E402
from repro.kernels.conv2d import conv2d_systolic as ref_systolic  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import substrate as psub  # noqa: E402
from repro_torch.core.precision import MatmulPolicy  # noqa: E402
from repro_torch.kernels.conv2d import conv2d as pconv  # noqa: E402
from repro_torch.kernels.conv2d import ops as pops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.serving.cnn_engine import (CNNServeEngine,  # noqa: E402
                                            ImageRequest)
from test_torch_refcache import (cached, cnn_init_numpy,  # noqa: E402
                                 digest, refcache_session)  # noqa: F401

torch.set_num_threads(2)

SPECS = [("karatsuba", 7), ("schoolbook", 8)]
POLICIES = ["kom_int14", "schoolbook_int16"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (n, h, cin, k, cout, stride, padding): strides 1/2/4, SAME and VALID, odd
# maps, kernels 1/3/5/11 (the 11x11/s4 VALID stem of AlexNet included).
CASES = [
    (2, 9, 5, 3, 7, 1, "SAME"),
    (2, 11, 4, 5, 6, 2, "VALID"),
    (1, 23, 3, 11, 5, 4, "VALID"),
    (2, 8, 6, 1, 3, 1, "SAME"),
    (2, 13, 20, 3, 9, 2, "SAME"),
]


@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("case", CASES)
def test_systolic_plain_equals_reference_interpret(variant, base_bits, case):
    """conv2d_systolic (per-sample quant, bias, ReLU) == the reference's
    Pallas kernel in interpret mode, for a float weight and a QWeight."""
    n, h, cin, k, cout, s, pad = case
    rng = np.random.default_rng(h * cin + k)
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    x[-1] *= 7.0  # per-sample scales differ across the batch
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    kw = dict(stride=s, padding=pad, variant=variant, base_bits=base_bits,
              activation="relu")
    want = np.asarray(ref_systolic(
        jnp.asarray(x), rsub.quantize_weight(jnp.asarray(w),
                                             base_bits=base_bits),
        bias=jnp.asarray(b), interpret=True, **kw))
    for wp in (_t(w), psub.quantize_weight(_t(w), base_bits=base_bits)):
        got = pops.conv2d_systolic(_t(x), wp, bias=_t(b), **kw).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant,base_bits", SPECS)
def test_systolic_raw_equals_reference_kernel(variant, base_bits):
    """The raw kernel function: pre-quantized int16 in, (n, cout) scale,
    == ``conv2d_systolic_raw`` (Pallas interpret) on the padded input; and
    without a scale, the raw recombined sums."""
    rng = np.random.default_rng(3)
    qmax = psub.kom_qmax(base_bits)
    xq = rng.integers(-qmax, qmax + 1, (2, 10, 10, 12)).astype(np.int16)
    wq = rng.integers(-qmax, qmax + 1, (3, 3, 12, 8)).astype(np.int16)
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
        got = pconv.conv2d_systolic_raw(
            _t(xq), _t(wq), None if scale is None else _t(scale),
            stride=1, pads=(1, 1), out_hw=(10, 10), variant=variant,
            base_bits=base_bits)
        np.testing.assert_array_equal(got.numpy()[:, :8], want)


def test_systolic_request_independent_of_batch_mates():
    """Per-SAMPLE scales: an image's output does not depend on the rest of
    its batch (whose amax is far larger here)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 9, 9, 6)).astype(np.float32)
    x[1:] *= 50.0
    w = psub.quantize_weight(_t(rng.standard_normal((3, 3, 6, 4))
                                .astype(np.float32)))
    kw = dict(variant="karatsuba", activation="relu")
    alone = pops.conv2d_systolic(_t(x[:1]), w, **kw)
    batch = pops.conv2d_systolic(_t(x), w, **kw)
    assert torch.equal(alone[0], batch[0])


def test_int_accum_bound_reroutes_to_implicit():
    """kh*kw*cin past 87,381 (kom_int14) cannot accumulate in one int32:
    both packages reroute the layer to their implicit engine.  Its
    recombine groups follow each package's own Cin block (the reference's
    TPU tile model picks 512 here, the port the widest wrap-free chunk),
    so the bitwise check hands the reference the port's block."""
    from repro.kernels.conv2d import conv2d_implicit as ref_implicit
    from repro_torch.kernels.conv2d.implicit_gemm import max_cin_block

    cin = 9712
    assert pconv.int_accum_bound(3, 3, cin, variant="karatsuba",
                                 base_bits=7) >= 2**31
    assert rconv.int_accum_bound(3, 3, cin, variant="karatsuba",
                                 base_bits=7) >= 2**31
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 7, 7, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, 4)) * 0.01).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    kw = dict(variant="karatsuba", base_bits=7, activation="relu")
    args = (jnp.asarray(x), rsub.quantize_weight(jnp.asarray(w)),
            jnp.asarray(b))
    # Under jit, as the serving forward runs it: the implicit layer's
    # epilogue contracts into one FMA there (ROADMAP.md, Queue 3).
    ref_sys = np.asarray(jax.jit(lambda v, qw, bias: ref_systolic(
        v, qw, bias=bias, interpret=True, **kw))(*args))
    ref_imp = np.asarray(jax.jit(lambda v, qw, bias: ref_implicit(
        v, qw, bias=bias, **kw))(*args))
    np.testing.assert_array_equal(ref_sys, ref_imp)
    bk = max_cin_block(3, 3, variant="karatsuba", base_bits=7)
    want = np.asarray(jax.jit(lambda v, qw, bias: ref_implicit(
        v, qw, bias=bias, block=(8, 8, bk), **kw))(*args))
    qw = psub.quantize_weight(_t(w))
    got = pops.conv2d_systolic(_t(x), qw, bias=_t(b), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, pops.conv2d_implicit(_t(x), qw, bias=_t(b),
                                                 **kw))
    with pytest.raises(ValueError, match="overflow"):
        pconv.conv2d_systolic_raw_plain(
            torch.zeros((1, 7, 7, cin), dtype=torch.int16), qw.values,
            stride=1, pads=(1, 1), out_hw=(7, 7), variant="karatsuba")


def test_native_variant_refuses_a_qweight():
    w = psub.quantize_weight(torch.randn(3, 3, 4, 2))
    with pytest.raises(TypeError, match="QWeight"):
        pops.conv2d_systolic(torch.randn(1, 5, 5, 4), w, variant="native")


# ---------------------------------------------------------------------------
# Whole models with every conv pinned to the systolic engine.
# ---------------------------------------------------------------------------

def _ref_params(ref_cfg, seed):
    params = cnn_init_numpy(ref_cfg, seed)
    rng = np.random.default_rng(seed)
    for p in params:
        if "b" in p:
            p["b"] = (rng.standard_normal(p["b"].shape) * 0.1).astype(
                np.float32)
    return params


def _images(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _model_case(arch, policy):
    """(port cfg, port QWeight params, images, jitted reference logits);
    the reference's logits once per run (``test_torch_refcache``)."""
    ref_cfg = ref_reduced(ref_get_config(arch)).replace(
        policy=RefPolicy(policy), conv_path="systolic")
    cfg = reduced(get_config(arch)).replace(policy=MatmulPolicy(policy),
                                            conv_path="systolic")
    params = _ref_params(ref_cfg, seed=0)
    x = _images(cfg, 2, seed=1)

    def reference():
        qp_ref = ref_cnn.cnn_quantize_params(
            [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
            ref_cfg)
        return np.asarray(jax.jit(lambda p, v: ref_cnn.cnn_forward(
            p, ref_cfg, v))(qp_ref, jnp.asarray(x)))
    want = cached("systolic-logits", (arch, policy, digest(params, x)),
                  reference)
    qp = cnn.cnn_quantize_params(params_from_numpy(params, device="cpu"),
                                 cfg)
    return cfg, qp, x, want


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["alexnet", "vgg16", "vgg19"])
def test_systolic_models_equal_jitted_reference(arch, policy):
    cfg, qp, x, want = _model_case(arch, policy)
    got = cnn.cnn_forward(qp, cfg, torch.from_numpy(x)).numpy()
    assert got.shape == (2, cfg.n_classes)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["alexnet", "vgg16", "vgg19"])
def test_fma_epilogue_mutant_disagrees_with_reference(arch, monkeypatch):
    """Contracting the systolic epilogue into one FMA breaks the bitwise
    model contract: the reference rounds fl(raw * t) before the bias add."""
    cfg, qp, x, want = _model_case(arch, "schoolbook_int16")
    monkeypatch.setattr(
        pconv, "systolic_epilogue",
        lambda raw, t, b: psub.dequant_epilogue(
            raw, t, None if b is None else b.to(torch.float32)))
    got = cnn.cnn_forward(qp, cfg, torch.from_numpy(x)).numpy()
    assert not np.array_equal(got, want)


def test_systolic_engine_serves_batch_invariant_logits():
    """CNNServeEngine with conv_path="systolic": padded microbatch logits
    == the image served alone, bitwise; and == the reference's forward."""
    cfg, qp, x, want = _model_case("vgg16", "kom_int14")
    eng = CNNServeEngine(cfg, qp, buckets=(1, 4), device="cpu")
    for uid, img in enumerate(x):
        eng.submit(ImageRequest(uid=uid, image=img))
    done = eng.run()
    for uid in range(len(x)):
        np.testing.assert_array_equal(done[uid].logits, want[uid])
        solo = eng.forward(torch.from_numpy(x[uid][None])).numpy()[0]
        np.testing.assert_array_equal(done[uid].logits, solo)
    with pytest.raises(ValueError, match="mutually exclusive"):
        from repro_torch.core.planner import heuristic_plan
        CNNServeEngine(cfg, qp, device="cpu",
                       plan=heuristic_plan(cfg.replace(conv_path="auto"),
                                           backend="cpu"))


def test_serve_launcher_conv_path(capsys):
    """--conv-path serves a pinned engine, and refuses what the reference
    launcher refuses: a pinned path with --plan/--explore, and a path that
    cannot run the policy exactly."""
    from repro_torch.launch.serve import main
    rc = main(["--arch", "vgg16", "--reduced", "--device", "cpu",
               "--requests", "2", "--buckets", "1,2", "--policy",
               "kom_int14", "--conv-path", "systolic"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "vgg16/kom_int14/systolic on cpu" in out and "2 images" in out
    for bad in (["--conv-path", "systolic", "--explore", "--model-only"],
                ["--conv-path", "implicit", "--plan", "plans.json"],
                ["--conv-path", "systolic", "--policy", "bf16x3"],
                ["--conv-path", "winograd", "--policy", "fp32"],
                ["--conv-path", "implicit", "--policy", "native_bf16"]):
        with pytest.raises(SystemExit) as e:
            main(["--arch", "alexnet", "--reduced", "--device", "cpu"] + bad)
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "pins ONE engine" in err and "cannot run policy" in err
