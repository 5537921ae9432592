"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

The CUDA kernels have no interpret mode, so every test here is marked
``cuda`` and skips without an NVIDIA GPU.  On a machine with one (and
``nvcc``), run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``:
this file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.  Tolerance 0 for the integer kernels: they and
the plain versions compute the same integers and the same f32 roundings.
The float kernels (systolic ``native``, the implicit float variants, the
bf16-limb GEMM) are held to ``max|kernel - plain| <= 1e-6 * max|plain|``:
their plain versions are the schedules' exact values, so what is left is
the kernels' own f32 accumulation error, and the plain value of the
neighbouring schedule on the same inputs must miss that tolerance.
"""
import contextlib
import importlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.kom_float_weights import FLOAT_WEIGHTS_TOL  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import substrate as sub  # noqa: E402
from repro_torch.core.precision import MatmulPolicy  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.conv2d import ops  # noqa: E402
from repro_torch.kernels.kom_matmul import kom_matmul_int  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.serving.cnn_engine import params_to  # noqa: E402

SPECS = [("karatsuba", 7), ("schoolbook", 8)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _same_as_plain(run, launches=1):
    """Run the kernel (counting its launches), then the plain version."""
    build.reset_launches()
    got = run()
    torch.cuda.synchronize()
    assert sum(build.launch_counts().values()) == launches
    with build.plain_versions():
        want = run()
    assert got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("m,k,n", [(70, 300, 90), (1, 5, 1), (129, 2049, 65),
                                   (16, 9216, 130)])
def test_limb_gemm_equals_plain(dev, variant, base_bits, m, k, n):
    g = torch.Generator().manual_seed(m + k + n)
    qmax = sub.kom_qmax(base_bits)
    a = torch.randint(-qmax, qmax + 1, (m, k), generator=g).to(dev)
    b = torch.randint(-qmax, qmax + 1, (k, n), generator=g).to(dev)
    rs = (torch.rand(m, generator=g) * 1e-3).to(dev)
    cs = (torch.rand(n, generator=g) * 1e-3).to(dev)
    bias = torch.randn(n, generator=g).to(dev)
    kw = dict(variant=variant, base_bits=base_bits)
    _same_as_plain(lambda: kom_matmul_int(a, b, **kw))
    _same_as_plain(lambda: kom_matmul_int(a, b, row_scale=rs, col_scale=cs,
                                          **kw))
    _same_as_plain(lambda: kom_matmul_int(a, b, row_scale=rs, col_scale=cs,
                                          bias=bias, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1280, 1280), (1280, 5120), (5120, 1280)])
def test_limb_gemm_at_encoder_rows_with_bias_equals_plain(dev, k, n):
    """whisper-large-v3's encoder products under kom_int14: m = 4 x 1500
    rows (64-row tiles, ragged at the end) with row and column scales
    and a bias, as ``kom_q_dot`` calls the kernel."""
    g = torch.Generator().manual_seed(k + n)
    qmax = sub.kom_qmax(7)
    a = torch.randint(-qmax, qmax + 1, (6000, k), generator=g).to(dev)
    b = torch.randint(-qmax, qmax + 1, (k, n), generator=g).to(dev)
    rs = (torch.rand(6000, generator=g) * 1e-3).to(dev)
    cs = (torch.rand(n, generator=g) * 1e-3).to(dev)
    bias = torch.randn(n, generator=g).to(dev)
    _same_as_plain(lambda: kom_matmul_int(a, b, variant="karatsuba",
                                          base_bits=7, row_scale=rs,
                                          col_scale=cs, bias=bias))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("h,cin,cout,k,s,pad,block,fold", [
    (13, 40, 70, 5, 1, "SAME", None, None),
    (13, 40, 70, 5, 1, "SAME", (8, 128, 8), 2),     # 3 recombine groups
    (35, 3, 20, 11, 4, "VALID", None, None),
    (16, 37, 33, 3, 2, "SAME", None, None),
    (12, 24, 64, 3, 1, "SAME", None, None),         # shared tile scales
])
def test_implicit_conv_equals_plain(dev, variant, base_bits, h, cin, cout,
                                    k, s, pad, block, fold):
    g = torch.Generator().manual_seed(h * cin + k)
    x = torch.randn((3, h, h, cin), generator=g).to(dev)
    w = sub.quantize_weight(torch.randn((k, k, cin, cout), generator=g),
                            base_bits=base_bits).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    _same_as_plain(lambda: ops.conv2d_implicit(
        x, w, stride=s, padding=pad, variant=variant, bias=bias,
        activation="relu", block=block, fold_every=fold))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("h,cin,cout,n", [(13, 40, 70, 2), (7, 3, 5, 1),
                                          (8, 256, 130, 3), (27, 96, 64, 2)])
def test_winograd_equals_plain(dev, variant, base_bits, h, cin, cout, n):
    g = torch.Generator().manual_seed(h * cin + n)
    x = torch.relu(torch.randn((n, h, h, cin), generator=g)).to(dev)
    w = sub.quantize_weight(torch.randn((3, 3, cin, cout), generator=g),
                            base_bits=base_bits).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    _same_as_plain(lambda: ops.conv2d_winograd(
        x, w, variant=variant, bias=bias, activation="relu"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
@pytest.mark.parametrize("policy", ["kom_int14", "schoolbook_int16"])
def test_reduced_model_on_card_equals_plain_on_cpu(dev, arch, policy):
    """The kernels on the card give the CPU plain versions' logits, which
    ``tests/test_torch_cnn.py`` holds against the JAX reference."""
    cfg = reduced(get_config(arch)).replace(policy=MatmulPolicy(policy))
    gen = torch.Generator().manual_seed(0)
    params = cnn.cnn_quantize_params(cnn.cnn_init(cfg, gen, device="cpu"),
                                     cfg)
    for p in params:
        if "b" in p:
            p["b"] = 0.1 * torch.randn(p["b"].shape, generator=gen)
    x = torch.randn((3, cfg.img_size, cfg.img_size, 3), generator=gen)
    with torch.inference_mode():
        want = cnn.cnn_forward(params, cfg, x)
        build.reset_launches()
        got = cnn.cnn_forward(params_to(params, dev), cfg, x.to(dev)).cpu()
    assert build.launch_counts()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("h,cin,cout,k,s,pool,block,fold", [
    (27, 40, 70, 5, 1, (2, 2), None, None),         # odd map: 27 -> 13
    (9, 37, 33, 3, 1, (2, 2), None, None),          # Cin not a multiple of 32
    (16, 24, 64, 3, 2, (2, 2), None, None),         # strided conv, then pool
    (12, 24, 64, 3, 1, (2, 2), None, None),         # shared tile scales
    (13, 40, 70, 5, 1, (2, 2), (8, 128, 8), 2),     # 3 recombine groups
    (9, 24, 16, 3, 1, (2, 2, "SAME"), None, None),  # pools after the core
    (11, 24, 16, 3, 1, (3, 2), None, None),         # pools after the core
])
def test_implicit_conv_pooled_equals_plain(dev, variant, base_bits, h, cin,
                                           cout, k, s, pool, block, fold):
    g = torch.Generator().manual_seed(h * cin + k + 1)
    x = torch.randn((2, h, h, cin), generator=g).to(dev)
    w = sub.quantize_weight(torch.randn((k, k, cin, cout), generator=g),
                            base_bits=base_bits).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    _same_as_plain(lambda: ops.conv2d_implicit(
        x, w, stride=s, variant=variant, bias=bias, activation="relu",
        block=block, fold_every=fold, pool=pool))
    if tuple(pool[:2]) == (2, 2) and len(pool) == 2:
        assert build.launch_counts() == {"implicit_conv_pool": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("h,cin,cout,bk,pool", [
    (13, 40, 70, None, None),       # a 13x13 consumer, one chunk
    (13, 100, 70, 64, None),        # bk wider than the kernel's BK = 32
    (7, 37, 33, 8, None),           # bk narrower; Cin not a multiple of 32
    (13, 256, 130, None, None),     # AlexNet conv3's depth
    (12, 24, 64, 24, (2, 2)),       # consumer that also pools
    (9, 24, 16, 16, (2, 2)),        # odd consumer map, pooled
])
def test_implicit_conv_handoff_equals_plain(dev, variant, base_bits, h, cin,
                                            cout, bk, pool):
    g = torch.Generator().manual_seed(h * cin + cout)
    x = torch.relu(torch.randn((2, h, h, cin), generator=g)).to(dev)
    qa = ops.handoff_quantize(x, base_bits=base_bits)
    w = sub.quantize_weight(torch.randn((3, 3, cin, cout), generator=g),
                            base_bits=base_bits).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    block = None if bk is None else (64, 64, bk)
    _same_as_plain(lambda: ops.conv2d_implicit(
        qa, w, variant=variant, bias=bias, activation="relu", block=block,
        pool=pool))
    assert build.launch_counts() == {"implicit_conv_handoff": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["alexnet", "vgg16", "vgg19"])
@pytest.mark.parametrize("policy", ["kom_int14", "schoolbook_int16"])
def test_reduced_model_fused_plan_on_card_equals_plain_on_cpu(dev, arch,
                                                              policy):
    """Under the explorer's requant plan: pooled and handoff kernels on the
    card give the CPU plain versions' logits."""
    import dataclasses

    from repro_torch.core.planner import explore

    cfg = reduced(get_config(arch)).replace(policy=MatmulPolicy(policy))
    plan = explore(cfg, model_only=True, requant=True, backend="cpu")
    assert {"pool", "pool_quant"} <= {e.fusion for e in plan.entries}
    gen = torch.Generator().manual_seed(3)
    params = cnn.cnn_quantize_params(cnn.cnn_init(cfg, gen, device="cpu"),
                                     cfg)
    for p in params:
        if "b" in p:
            p["b"] = 0.1 * torch.randn(p["b"].shape, generator=gen)
    x = torch.randn((2, cfg.img_size, cfg.img_size, 3), generator=gen)
    with torch.inference_mode():
        want = cnn.cnn_forward(params, cfg, x, plan=plan)
        build.reset_launches()
        got = cnn.cnn_forward(params_to(params, dev), cfg, x.to(dev),
                              plan=dataclasses.replace(plan, backend="cuda"))
    counts = build.launch_counts()
    assert counts.get("implicit_conv_pool", 0) >= 1
    assert counts.get("implicit_conv_handoff", 0) >= 1
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# The tensor-core limb GEMM and integer implicit conv (csrc/limb_mma.cuh):
# small-M and 64-row tiles, K splits, ragged K / N, every conv mode.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("m", [1, 4, 16, 17, 64])
@pytest.mark.parametrize("k,n", [(300, 90), (2100, 70), (4096, 1000),
                                 (363, 96), (300, 16900)])
def test_limb_gemm_tiles_equal_plain(dev, variant, base_bits, m, k, n):
    """k off the 32-entry chunk (300, 2100, 363: odd, element loads), n off
    8 (90, 70, 16900: the padded weight) and off the 64-column tile; m in
    the 8-, 16- and 64-row tiles; the plan splits K at every shape but the
    last, whose 265 column tiles fill the grid."""
    from repro_torch.kernels.kom_matmul import kom_split_k
    g = torch.Generator().manual_seed(m * k + n)
    qmax = sub.kom_qmax(base_bits)
    a = torch.randint(-qmax, qmax + 1, (m, k), generator=g).to(dev)
    b = torch.randint(-qmax, qmax + 1, (k, n), generator=g).to(dev)
    rs = (torch.rand(m, generator=g) * 1e-3).to(dev)
    cs = (torch.rand(n, generator=g) * 1e-3).to(dev)
    bias = torch.randn(n, generator=g).to(dev)
    kw = dict(variant=variant, base_bits=base_bits)
    assert (kom_split_k(m, k, n)["splits"] == 1) == (n == 16900)
    _same_as_plain(lambda: kom_matmul_int(a, b, **kw))
    _same_as_plain(lambda: kom_matmul_int(a, b, row_scale=rs, col_scale=cs,
                                          bias=bias, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("m,k,n", [
    (4, 31, 512), (4, 32, 512), (4, 33, 512),      # one split | two
    (4, 64, 16896), (4, 64, 16832),                # 264 tiles | 263: two
])
def test_limb_gemm_either_side_of_a_split_boundary(dev, variant, base_bits,
                                                   m, k, n):
    from repro_torch.kernels.kom_matmul import kom_split_k
    g = torch.Generator().manual_seed(k + n)
    qmax = sub.kom_qmax(base_bits)
    a = torch.randint(-qmax, qmax + 1, (m, k), generator=g).to(dev)
    b = torch.randint(-qmax, qmax + 1, (k, n), generator=g).to(dev)
    rs = (torch.rand(m, generator=g) * 1e-3).to(dev)
    cs = (torch.rand(n, generator=g) * 1e-3).to(dev)
    assert kom_split_k(m, k, n)["splits"] == (1 if (k, n) in (
        (31, 512), (32, 512), (64, 16896)) else 2)
    _same_as_plain(lambda: kom_matmul_int(a, b, variant=variant,
                                          base_bits=base_bits, row_scale=rs,
                                          col_scale=cs))


@pytest.mark.cuda
def test_limb_gemm_digit_sum_pass_wraps_like_plain(dev):
    """Karatsuba's digit-sum pass past 2^31 at k = 140000: the s32 MMA
    accumulators and the split sums wrap as the plain version's int32."""
    a = torch.full((1, 140000), -8127, dtype=torch.int16, device=dev)
    b = torch.full((140000, 8), -8127, dtype=torch.int16, device=dev)
    _same_as_plain(lambda: kom_matmul_int(a, b, variant="karatsuba",
                                          base_bits=7))


def _implicit_case(dev, g, mode, n, h, k, cin, cout, base_bits):
    """Inputs for one raw implicit call: (run, launch-counter name)."""
    from repro_torch.kernels.conv2d.implicit_gemm import (
        conv2d_implicit_handoff_raw, conv2d_implicit_raw)
    qmax = sub.kom_qmax(base_bits)
    x = torch.relu(torch.randn((n, h, h, cin), generator=g)).to(dev)
    wv = torch.randint(-qmax, qmax + 1, (k, k, cin, cout),
                       generator=g).to(torch.int16).to(dev)
    ws = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    pool = (2, 2) if "pool" in mode else None
    if "handoff" in mode:
        qa = ops.handoff_quantize(x, base_bits=base_bits)
        return lambda span, v: conv2d_implicit_handoff_raw(
            qa.values, qa.scale, wv, ws, bias, bk=span, variant=v,
            base_bits=base_bits, pool=pool), "implicit_conv_handoff"
    asc = (torch.rand((n, h, h), generator=g) * 0.02 + 1e-3).to(dev)
    return lambda span, v: conv2d_implicit_raw(
        x, wv, asc, ws, bias, stride=1, pads=(k // 2, k // 2),
        out_hw=(h, h), span_c=span, variant=v, base_bits=base_bits,
        pool=pool), "implicit_conv_pool" if pool else "implicit_conv"


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("mode", ["plain", "pool", "handoff",
                                  "pool_handoff"])
@pytest.mark.parametrize("n,h,k,cin,cout,span", [
    (2, 15, 3, 70, 200, 40),   # odd map; cin, span off the 32-channel
                               # step; 2 groups; cout off the 128 tile
    (1, 9, 3, 37, 33, 37),     # cin, cout unaligned: element loads
    (2, 8, 3, 64, 64, 64),     # cout 64: half the tile's warps idle
    (3, 14, 3, 256, 130, 256), # a VGG-like depth, one group
])
def test_implicit_conv_modes_equal_plain(dev, variant, base_bits, mode, n, h,
                                         k, cin, cout, span):
    g = torch.Generator().manual_seed(h * cin + cout)
    run, name = _implicit_case(dev, g, mode, n, h, k, cin, cout, base_bits)
    build.reset_launches()
    _same_as_plain(lambda: run(span, variant))
    assert build.launch_counts() == {name: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("mode", ["plain", "pool"])
def test_implicit_conv_alexnet_conv2_equals_plain(dev, variant, base_bits,
                                                  mode):
    """AlexNet conv2: 5 x 5, 96 -> 256 at 27 x 27, batch 4."""
    g = torch.Generator().manual_seed(27)
    run, _ = _implicit_case(dev, g, mode, 4, 27, 5, 96, 256, base_bits)
    _same_as_plain(lambda: run(96, variant))


@pytest.mark.cuda
def test_integer_kernels_issue_int8_mma(dev):
    """All four integer libraries -- the limb GEMM, the implicit, systolic
    and Winograd convs -- run their passes as int8 MMAs (IMMA in the
    SASS)."""
    for name in ("kom_matmul", "implicit_conv", "systolic_conv", "winograd"):
        assert build.sass_count(name, "IMMA") > 0, name


@pytest.mark.cuda
def test_float_kernels_issue_tensor_core_mma(dev):
    """The bf16 attention kernel runs wgmma (HGMMA), its dh-128 kernel fed
    by TMA (UTMALDG); the f32 attention kernel and the mLSTM kernels run
    three TF32 passes on mma.sync (HMMA), as do the float conv's bf16
    schedules."""
    assert build.sass_count("flash_attention", "HGMMA") > 0
    assert build.sass_count("flash_attention", "UTMALDG") > 0
    for name in ("flash_attention", "mlstm_chunk", "implicit_conv_float"):
        assert build.sass_count(name, "HMMA") > 0, name


@pytest.mark.cuda
def test_tf32_split_on_card_matches_the_cpu_emulation(dev):
    """The split the f32 attention and mLSTM kernels run (cvt.rna.tf32.f32,
    low bits cleared) equals the emulation of tests/test_torch_tf32.py bit
    for bit: ties, signs, subnormals and random bit patterns."""
    from repro_torch.analysis.tf32_probe import (probe_values, split,
                                                 split_on_card)
    x = probe_values(20000, 0)
    big, small = split_on_card(x)
    want_big, want_small = split(x)
    assert torch.equal(big.view(torch.int32), want_big.view(torch.int32))
    assert torch.equal(small.view(torch.int32), want_small.view(torch.int32))


@pytest.mark.cuda
def test_wrappers_refuse_bad_input_on_the_card(dev):
    a = torch.zeros((4, 8), dtype=torch.int16, device=dev)
    b = torch.zeros((8, 3), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):
        kom_matmul_int(a, b, variant="karatsuba", base_bits=8)
    with pytest.raises(ValueError):
        kom_matmul_int(a, b[:5])
    with pytest.raises(ValueError):
        kom_matmul_int(a, b, row_scale=torch.ones(4, device=dev))


# ---------------------------------------------------------------------------
# The systolic conv, the float implicit variants and the bf16-limb GEMM.
# Integer kernels: tolerance 0.  Float kernels against their plain versions
# (each schedule's exact value, rounded once): max|kernel - plain| <= 1e-6 *
# max|plain|, while the plain version of the neighbouring schedule on the
# same inputs misses it (the schedules lie ~3e-6 apart), so the check tells
# a bf16x3 kernel from a native or bf16x6 one.
# ---------------------------------------------------------------------------

FLOAT_TOL = 1e-6
#: Each float schedule -> the neighbouring one its check must tell it from.
NEIGHBOUR = {"native": "bf16x3", "bf16x3": "native", "bf16x6": "bf16x3"}


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _close_to_plain(run, name, neighbour):
    """The kernel within FLOAT_TOL of its plain version, the neighbouring
    schedule's plain version (``neighbour()``) not."""
    build.reset_launches()
    got = run()
    torch.cuda.synchronize()
    assert build.launch_counts() == {name: 1}
    with build.plain_versions():
        want, other = run(), neighbour()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _rel(got, want) <= FLOAT_TOL, _rel(got, want)
    assert _rel(other, want) > FLOAT_TOL, _rel(other, want)


SYSTOLIC_CASES = [  # h, cin, cout, k, stride, padding
    (13, 40, 70, 5, 1, "SAME"),
    (35, 3, 20, 11, 4, "VALID"),
    (16, 37, 33, 3, 2, "SAME"),
    (9, 64, 130, 3, 1, "SAME"),
    (8, 6, 3, 1, 1, "SAME"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("h,cin,cout,k,s,pad", SYSTOLIC_CASES)
def test_systolic_conv_equals_plain(dev, variant, base_bits, h, cin, cout,
                                    k, s, pad):
    g = torch.Generator().manual_seed(h * cin + k + 7)
    x = torch.randn((3, h, h, cin), generator=g).to(dev)
    w = sub.quantize_weight(torch.randn((k, k, cin, cout), generator=g),
                            base_bits=base_bits).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    _same_as_plain(lambda: ops.conv2d_systolic(
        x, w, stride=s, padding=pad, variant=variant, bias=bias,
        activation="relu"))
    assert build.launch_counts() == {"systolic_conv": 1}


def _systolic_raw_case(dev, g, n, h, cin, k, cout, stride, padding,
                       base_bits):
    """The raw wrapper's operands: per-sample int16 values, an int16
    weight, the (n, cout) scale and a bias."""
    from repro_torch.kernels.conv2d.conv2d import conv2d_systolic_raw
    qmax = sub.kom_qmax(base_bits)
    xq = torch.randint(-qmax, qmax + 1, (n, h, h, cin), generator=g).to(
        torch.int16).to(dev)
    wq = torch.randint(-qmax, qmax + 1, (k, k, cin, cout), generator=g).to(
        torch.int16).to(dev)
    scale = (torch.rand((n, cout), generator=g) * 1e-4).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    ho, wo, pads = sub.conv_pads(h, h, k, k, stride, padding)
    return lambda v: conv2d_systolic_raw(
        xq, wq, scale, bias, stride=stride, pads=(pads[0][0], pads[1][0]),
        out_hw=(ho, wo), variant=v, base_bits=base_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("n,h,cin,k,cout,s,pad", [
    (1, 14, 512, 3, 512, 1, "SAME"),   # VGG16 conv5 alone: K split
    (8, 14, 512, 3, 512, 1, "SAME"),   # ... at batch 8: five splits
    (8, 30, 3, 3, 64, 1, "SAME"),      # the stem: flat K, 128 x 64 tiles
    (8, 56, 64, 3, 64, 1, "SAME"),     # 196 tiles: two splits
    (8, 64, 64, 3, 64, 1, "SAME"),     # 256 tiles, whole waves: one split
    (1, 17, 24, 3, 200, 2, "VALID"),   # stride 2, VALID, cout off 128
    (2, 9, 37, 3, 130, 1, "SAME"),     # cin off 8: flat K, split
])
def test_systolic_conv_tiles_equal_plain(dev, variant, base_bits, n, h, cin,
                                         k, cout, s, pad):
    g = torch.Generator().manual_seed(n * h + cin + cout)
    run = _systolic_raw_case(dev, g, n, h, cin, k, cout, s, pad, base_bits)
    _same_as_plain(lambda: run(variant))
    assert build.launch_counts() == {"systolic_conv": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
def test_systolic_conv_is_the_same_from_run_to_run(dev, variant, base_bits):
    """The split K steps add their int32 sums by atomics, in no fixed
    order: integers, so the bits never change."""
    g = torch.Generator().manual_seed(5)
    run = _systolic_raw_case(dev, g, 2, 14, 256, 3, 256, 1, "SAME",
                             base_bits)
    first = run(variant)
    for _ in range(3):
        assert torch.equal(run(variant), first)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("n,h,cin,cout,pad", [
    (2, 9, 40, 70, "VALID"),    # odd tile grid: a ragged last row, column
    (1, 11, 24, 16, "SAME"),    # odd map, ragged tiles; one chunk
    (1, 6, 512, 64, "SAME"),    # cin 512: deep, within the int32 bound
    (2, 13, 64, 384, "SAME"),   # cout 384: three column blocks
])
def test_winograd_shapes_equal_plain(dev, variant, base_bits, n, h, cin,
                                     cout, pad):
    g = torch.Generator().manual_seed(h * cin + cout)
    x = torch.relu(torch.randn((n, h, h, cin), generator=g)).to(dev)
    w = sub.quantize_weight(torch.randn((3, 3, cin, cout), generator=g),
                            base_bits=base_bits).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    _same_as_plain(lambda: ops.conv2d_winograd(
        x, w, padding=pad, variant=variant, bias=bias))
    assert build.launch_counts() == {"winograd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("variant,base_bits", SPECS)
def test_winograd_is_the_same_from_run_to_run(dev, variant, base_bits):
    """Four chunk splits add their int32 sums by atomics, in no fixed
    order: integers, so the bits never change."""
    g = torch.Generator().manual_seed(6)
    x = torch.relu(torch.randn((4, 13, 13, 128), generator=g)).to(dev)
    w = sub.quantize_weight(torch.randn((3, 3, 128, 256), generator=g),
                            base_bits=base_bits).to(dev)
    first = ops.conv2d_winograd(x, w, variant=variant)
    for _ in range(3):
        assert torch.equal(ops.conv2d_winograd(x, w, variant=variant), first)


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout,k,s,pad", SYSTOLIC_CASES)
def test_systolic_native_equals_plain(dev, h, cin, cout, k, s, pad):
    g = torch.Generator().manual_seed(h * cin + k + 8)
    x = torch.randn((3, h, h, cin), generator=g).to(dev)
    w = torch.randn((k, k, cin, cout), generator=g).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    _close_to_plain(lambda: ops.conv2d_systolic(
        x, w, stride=s, padding=pad, variant="native", bias=bias),
        "systolic_conv_native", lambda: ops.conv2d_implicit(
            x, w, stride=s, padding=pad, variant="bf16x3", bias=bias))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["native", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("h,cin,cout,k,s,pad", SYSTOLIC_CASES)
def test_implicit_float_equals_plain(dev, variant, h, cin, cout, k, s, pad):
    g = torch.Generator().manual_seed(h * cin + k + 9)
    x = torch.randn((3, h, h, cin), generator=g).to(dev)
    w = torch.randn((k, k, cin, cout), generator=g).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    run = (lambda v: lambda: ops.conv2d_implicit(
        x, w, stride=s, padding=pad, variant=v, bias=bias))
    _close_to_plain(run(variant), f"implicit_conv_{variant}",
                    run(NEIGHBOUR[variant]))


# The float conv kernel's paths, tiles and tap groups
# (csrc/implicit_conv_float.cu): the folded-K generic path (cin 3, the
# stem; cin 16; cout 70, not a multiple of 4), the 32-channel cp.async path
# on both tiles (256 x 64 for cout <= 64, else 128 x 128) with 1, 3 and 9
# tap groups (by the grid's size on an H100's 132 SMs), a cout and an
# n*ho*wo that 128 does not divide, stride 2 and asymmetric pads.
FLOAT_RAW_CASES = [  # n, h, w, cin, cout, k, stride, pads, out_hw
    (2, 17, 19, 3, 64, 3, 1, (1, 1), (17, 19)),      # stem, SAME
    (1, 23, 21, 3, 70, 3, 2, (0, 1), (11, 10)),      # stem, s2, asymmetric
    (3, 15, 13, 32, 200, 3, 2, (0, 1), (7, 7)),      # 9 groups
    (2, 20, 20, 64, 64, 3, 1, (1, 1), (20, 20)),     # 256 x 64, 9 groups
    (8, 47, 47, 16, 136, 3, 1, (1, 0), (46, 47)),    # generic, 128 x 128
    (8, 28, 28, 256, 512, 3, 1, (1, 1), (28, 28)),   # VGG16 conv4_1, 3
    (2, 14, 14, 512, 512, 3, 1, (1, 1), (14, 14)),   # VGG16 conv5, 9
    (8, 60, 60, 64, 256, 3, 1, (1, 1), (60, 60)),    # one group
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["native", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("n,h,w,cin,cout,k,s,pads,out_hw", FLOAT_RAW_CASES)
def test_implicit_float_tiles_equal_plain(dev, variant, n, h, w, cin, cout,
                                          k, s, pads, out_hw):
    from repro_torch.kernels.conv2d.implicit_gemm import (
        conv2d_implicit_float_raw)
    g = torch.Generator().manual_seed(h * cin + cout + k)
    x = torch.relu(torch.randn((n, h, w, cin), generator=g)).to(dev)
    wt = (torch.randn((k, k, cin, cout), generator=g)
          * (k * k * cin) ** -0.5).to(dev)
    bias = (0.1 * torch.randn(cout, generator=g)).to(dev)
    run = (lambda v: lambda: conv2d_implicit_float_raw(
        x, wt, bias, stride=s, pads=pads, out_hw=out_hw, variant=v))
    _close_to_plain(run(variant), f"implicit_conv_{variant}",
                    run(NEIGHBOUR[variant]))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["native", "bf16x3", "bf16x6"])
def test_implicit_float_is_the_same_from_run_to_run(dev, variant):
    """No atomics: every output is one thread's fixed-order sum."""
    from repro_torch.kernels.conv2d.implicit_gemm import (
        conv2d_implicit_float_raw)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 28, 28, 256), generator=g).to(dev)
    wt = (torch.randn((3, 3, 256, 512), generator=g) * 0.02).to(dev)
    run = lambda: conv2d_implicit_float_raw(
        x, wt, None, stride=1, pads=(1, 1), out_hw=(28, 28), variant=variant)
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)


@pytest.mark.cuda
def test_mma_probe_stays_within_the_emulated_bound(dev):
    """One MMA's sum on the card (the probe of ``analysis/mma_probe``)
    lies within 17 units of the largest addend's f32 grid of the exact
    sum: the bound of the ``align`` model the CPU tests emulate (each of
    the 16 products and C cut by less than one unit)."""
    from repro_torch.analysis import mma_probe
    for case in mma_probe.run(count=512).values():
        assert case["max_err_grid"] <= 17, case


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [3, 4, 6])
@pytest.mark.parametrize("m,k,n", [
    (8, 2000, 300), (1, 37, 33), (37, 129, 65), (16, 4096, 1000),
    (1, 25088, 136), (4, 25088, 136), (8, 25088, 136),   # fc6's K: 25 groups
    (20, 5000, 130),    # K not a multiple of the group, two m tiles
])
def test_bf16_gemm_equals_plain(dev, passes, m, k, n):
    from repro_torch.core.karatsuba import schedule_dot
    from repro_torch.kernels.kom_matmul import bf16x3_matmul
    g = torch.Generator().manual_seed(m + k + n + passes)
    a = torch.randn((m, k), generator=g).to(dev)
    b = (torch.randn((k, n), generator=g) * 1e-2).to(dev)
    nb = {3: 1, 4: 3, 6: 3}[passes]          # native f32, bf16x3, bf16x3
    _close_to_plain(lambda: bf16x3_matmul(a, b, passes=passes),
                    "bf16_matmul",
                    lambda: schedule_dot(a, b, passes=nb).float())


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [3, 6])
def test_bf16_gemm_split_k_is_the_same_from_run_to_run(dev, passes):
    """The group sums are added in a fixed order (no float atomics), so the
    split-K result is bitwise equal from run to run."""
    from repro_torch.kernels.kom_matmul import bf16x3_matmul
    g = torch.Generator().manual_seed(passes)
    a = torch.randn((8, 25088), generator=g).to(dev)
    b = (torch.randn((25088, 520), generator=g) * 1e-2).to(dev)
    first = bf16x3_matmul(a, b, passes=passes)
    for _ in range(3):
        assert torch.equal(bf16x3_matmul(a, b, passes=passes), first)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["alexnet", "vgg16", "vgg19"])
@pytest.mark.parametrize("policy,path", [
    ("kom_int14", "systolic"), ("schoolbook_int16", "systolic"),
    ("fp32", "systolic"), ("fp32", "implicit"), ("bf16x3", "implicit"),
    ("bf16x6", "implicit")])
def test_reduced_model_pinned_path_on_card_matches_cpu(dev, arch, policy,
                                                       path):
    """Every conv on one engine: the integer systolic kernels on the card
    give the CPU plain versions' logits bit for bit; fp32 and bf16x6 within
    FLOAT_TOL, which the CPU's bf16x3 logits miss; bf16x3 within 1e-5 (it
    amplifies ulp-level differences between layers: tests/test_torch_float.py
    says why)."""
    cfg = reduced(get_config(arch)).replace(policy=MatmulPolicy(policy),
                                            conv_path=path)
    gen = torch.Generator().manual_seed(4)
    params = cnn.cnn_quantize_params(cnn.cnn_init(cfg, gen, device="cpu"),
                                     cfg)
    for p in params:
        if "b" in p:
            p["b"] = 0.1 * torch.randn(p["b"].shape, generator=gen)
    x = torch.randn((2, cfg.img_size, cfg.img_size, 3), generator=gen)
    with torch.inference_mode():
        want = cnn.cnn_forward(params, cfg, x)
        build.reset_launches()
        got = cnn.cnn_forward(params_to(params, dev), cfg, x.to(dev)).cpu()
    counts = build.launch_counts()
    n_conv = sum(1 for s in cfg.layers if s[0] == "conv")
    if path == "systolic":
        name = "systolic_conv" if policy != "fp32" else "systolic_conv_native"
    else:
        name = "implicit_conv_" + ("native" if policy == "fp32" else policy)
    assert counts[name] == n_conv
    if policy in ("kom_int14", "schoolbook_int16"):
        assert counts["kom_matmul"] == 3
        assert torch.equal(got, want)
    else:
        if policy != "fp32":
            assert counts["bf16_matmul"] == 3
        if policy == "bf16x3":
            assert _rel(got, want) <= 1e-5, _rel(got, want)
        else:
            assert _rel(got, want) <= FLOAT_TOL, _rel(got, want)
            with torch.inference_mode():
                other = cnn.cnn_forward(params, cfg.replace(
                    policy=MatmulPolicy.BF16X3, conv_path="implicit"), x)
            assert _rel(other, want) > FLOAT_TOL, _rel(other, want)


# -- attention kernels ---------------------------------------------------------
#
# f32 inputs: the kernels and their plain versions sum the same products in
# other orders, so max|kernel - plain| <= ATTN_TOL_F32 (the reference's own
# kernel-vs-oracle tolerance, outputs are O(1)); bf16 outputs may round one
# bf16 ulp apart: ATTN_TOL_BF16.  Every f32 check also runs the plain version
# with its mask mutated -- causal ``>`` for ``>=`` (attention), ``<`` for
# ``<=`` (decode) -- and requires it to MISS ATTN_TOL_F32.

ATTN_TOL_F32 = 2e-5
ATTN_TOL_BF16 = 2e-2
# bf16 attention also row by row: max|kernel - plain| in a row over the
# row's max|plain|, two bf16 ulps (an ulp is at most 2^-7 of a value).
# ATTN_TOL_BF16 is one ulp of the largest outputs, many of a late row's;
# a plain version that skips one of the kernel's middle key tiles must
# miss this limit.
ATTN_ROW_TOL_BF16 = 2.0 ** -6


def _strict_causal(orig):
    def live(q_pos, k_pos, *, causal, window):
        m = orig(q_pos, k_pos, causal=causal, window=window)
        return m & (q_pos[:, None] != k_pos[None, :]) if causal else m
    return live


@contextlib.contextmanager
def _mutated(module: str, name: str, make):
    """``module.name`` replaced by ``make(original)`` inside the block."""
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _skip_keys(first, count):
    def make(orig):
        def live(q_pos, k_pos, *, causal, window):
            m = orig(q_pos, k_pos, causal=causal, window=window)
            return m & ~((k_pos >= first) & (k_pos < first + count))[None, :]
        return live
    return make


def _row_err(got, want):
    got, want = got.float(), want.float()
    den = want.abs().amax(-1).clamp_min(1e-30)
    return float(((got - want).abs().amax(-1) / den).max())


FA_MOD = "repro_torch.kernels.flash_attention.flash_attention"
FD_MOD = "repro_torch.kernels.flash_decode.flash_decode"


def _bf16_rows_vs_plain(q, k, v, *, causal=True, window=None, q_offset=0):
    """bf16 flash attention within ATTN_ROW_TOL_BF16 of its plain version
    row by row; where the last row's live keys span three of the kernel's
    key tiles (``bf16_key_tile``: 128 keys at dh 128, 32 at dh 256, else
    64), the plain version skipping the middle one must miss that limit."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.flash_attention import (
        bf16_key_tile)
    run = lambda: fa(q, k, v, causal=causal, window=window,
                     q_offset=q_offset)
    got = run()
    with build.plain_versions():
        want = run()
    err = _row_err(got, want)
    assert err <= ATTN_ROW_TOL_BF16, err
    sq, skv, tile = q.shape[2], k.shape[2], bf16_key_tile(q.shape[3])
    last = min(sq - 1 + q_offset, skv - 1) if causal else skv - 1
    lo = max(0, last - window + 1) if window is not None else 0
    if last // tile - lo // tile >= 2:
        first = (lo // tile + last // tile) // 2 * tile
        with _mutated(FA_MOD, "live_mask", _skip_keys(first, tile)), \
                build.plain_versions():
            miss = _row_err(got, run())
        assert miss > ATTN_ROW_TOL_BF16, miss


def _attn_inputs(shape_q, shape_kv, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).to(dev)
            for s in (shape_q, shape_kv, shape_kv)]


def _kernel_vs_plain(run, name, tol, mutant=None):
    """The kernel within ``tol`` of its plain version; the plain version
    under ``mutant`` (a context manager) not."""
    build.reset_launches()
    got = run()
    torch.cuda.synchronize()
    assert build.launch_counts() == {name: 1}
    with build.plain_versions():
        want = run()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, err
    if mutant is not None:
        with mutant, build.plain_versions():
            bad = run()
        miss = float((got.float() - bad.float()).abs().max())
        assert miss > tol, miss


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,off,window", [
    (2, 4, 4, 64, 64, 64, 0, None),
    (1, 8, 2, 1, 128, 64, 127, None),          # sq = 1 (a decode row)
    (1, 4, 4, 100, 300, 64, 200, None),        # skv not a block multiple
    (1, 32, 1, 129, 129, 128, 0, None),        # group 32, dh 128, ragged
    (2, 4, 4, 200, 200, 16, 0, 48),            # window, dh 16
    (1, 6, 2, 256, 2048, 64, 1792, 512),       # q_offset + window
    (1, 2, 1, 40, 40, 32, 0, None),            # dh 32, one short block
])
def test_flash_attention_kernel_equals_plain(dev, b, hq, hkv, sq, skv, d,
                                             off, window):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q, k, v = _attn_inputs((b, hq, sq, d), (b, hkv, skv, d), torch.float32,
                           dev, b + hq + sq + skv + d)
    _kernel_vs_plain(lambda: fa(q, k, v, causal=True, window=window,
                                q_offset=off),
                     "flash_attention", ATTN_TOL_F32,
                     _mutated(FA_MOD, "live_mask", _strict_causal))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    _kernel_vs_plain(lambda: fa(qb, kb, vb, causal=True, window=window,
                                q_offset=off),
                     "flash_attention", ATTN_TOL_BF16,
                     _mutated(FA_MOD, "live_mask", _strict_causal))
    _bf16_rows_vs_plain(qb, kb, vb, window=window, q_offset=off)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,skv,off,window", [
    (1, 2, 2, 2048, 2048, 0, None),      # olmoe's layer cut to 2 heads
    (1, 8, 2, 640, 640, 0, None),        # GQA 4:1 over five tiles
    (1, 4, 4, 300, 1300, 1000, 512),     # window 512 with a q_offset
    (2, 4, 4, 1, 130, 129, None),        # sq = 1
    (1, 2, 1, 333, 333, 0, None),        # skv ragged (padded to 384)
    (2, 48, 8, 384, 384, 0, None),       # internvl2's heads: GQA 6:1
])
def test_flash_attention_dh128_kernels_equal_plain(dev, b, hq, hkv, sq, skv,
                                                   off, window):
    """Head dim 128: the warp-specialized bf16 kernel (TMA, 128-key tiles,
    ping-pong warpgroups) and the f32 kernel's 8-warp configuration, each
    within its tolerance of the plain version, with the strict-causal
    mutant required to miss; bf16 also row by row, where a skipped middle
    key tile must miss."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q, k, v = _attn_inputs((b, hq, sq, 128), (b, hkv, skv, 128),
                           torch.float32, dev, b + hq + sq + skv + 128)
    for dtype, tol in ((torch.float32, ATTN_TOL_F32),
                       (torch.bfloat16, ATTN_TOL_BF16)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        _kernel_vs_plain(lambda: fa(qq, kk, vv, causal=True, window=window,
                                    q_offset=off),
                         "flash_attention", tol,
                         _mutated(FA_MOD, "live_mask", _strict_causal))
    _bf16_rows_vs_plain(qq, kk, vv, window=window, q_offset=off)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,skv,off,window,causal", [
    (1, 16, 1, 512, 512, 0, 256, True),     # recurrentgemma's MQA, window
    (1, 16, 1, 300, 1300, 1000, 512, True),  # q_offset + window, ragged
    (2, 2, 1, 1, 130, 129, None, True),      # sq = 1
    (1, 4, 2, 200, 384, 0, None, False),     # non-causal, GQA 2:1
    (1, 2, 1, 100, 384, 300, 4, True),       # rows with no live key
])
def test_flash_attention_dh256_kernels_equal_plain(dev, b, hq, hkv, sq, skv,
                                                   off, window, causal):
    """Head dim 256 (recurrentgemma-9b): the bf16 kernel's 32-key tiles and
    the f32 kernel's 64-row blocks of 16-key tiles, each within its
    tolerance of the plain version (the strict-causal mutant must miss
    where the kernel is causal); bf16 also row by row, where a skipped
    middle key tile must miss."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q, k, v = _attn_inputs((b, hq, sq, 256), (b, hkv, skv, 256),
                           torch.float32, dev, b + hq + sq + skv + 256)
    for dtype, tol in ((torch.float32, ATTN_TOL_F32),
                       (torch.bfloat16, ATTN_TOL_BF16)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        _kernel_vs_plain(lambda: fa(qq, kk, vv, causal=causal,
                                    window=window, q_offset=off),
                         "flash_attention", tol,
                         _mutated(FA_MOD, "live_mask", _strict_causal)
                         if causal else None)
    _bf16_rows_vs_plain(qq, kk, vv, causal=causal, window=window,
                        q_offset=off)


@pytest.mark.cuda
def test_flash_attention_dh128_noncausal_and_unlive_rows(dev):
    """Head dim 128, both dtypes: non-causal over several key tiles, and
    rows with no live key (window 4 ending before the cache), which walk
    every tile and average the values."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q, k, v = _attn_inputs((1, 4, 200, 128), (1, 2, 384, 128),
                           torch.float32, dev, 12)
    for dtype, tol in ((torch.float32, ATTN_TOL_F32),
                       (torch.bfloat16, ATTN_TOL_BF16)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        _kernel_vs_plain(lambda: fa(qq, kk, vv, causal=False),
                         "flash_attention", tol)
        _kernel_vs_plain(lambda: fa(qq, kk, vv, causal=True, window=4,
                                    q_offset=300), "flash_attention", tol)
    _bf16_rows_vs_plain(qq, kk, vv, causal=False)
    _bf16_rows_vs_plain(qq, kk, vv, window=4, q_offset=300)


@pytest.mark.cuda
def test_flash_attention_kernel_noncausal_and_unlive_rows(dev):
    """Non-causal (no padding), and rows with NO live key (a window that
    ends before the cache): the kernel walks every block for them and
    averages the values, as the reference's -1e30 arithmetic does."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q, k, v = _attn_inputs((1, 4, 64, 64), (1, 2, 128, 64), torch.float32,
                           dev, 11)
    _kernel_vs_plain(lambda: fa(q, k, v, causal=False), "flash_attention",
                     ATTN_TOL_F32)
    _kernel_vs_plain(lambda: fa(q, k, v, causal=True, window=4,
                                q_offset=300), "flash_attention",
                     ATTN_TOL_F32)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    _kernel_vs_plain(lambda: fa(qb, kb, vb, causal=False),
                     "flash_attention", ATTN_TOL_BF16)
    _kernel_vs_plain(lambda: fa(qb, kb, vb, causal=True, window=4,
                                q_offset=300), "flash_attention",
                     ATTN_TOL_BF16)
    _bf16_rows_vs_plain(qb, kb, vb, causal=False)
    _bf16_rows_vs_plain(qb, kb, vb, window=4, q_offset=300)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,S,dh,pos", [
    (2, 4, 4, 256, 64, 0),          # pos = 0
    (1, 8, 2, 512, 64, 511),        # pos = S - 1
    (1, 4, 1, 300, 128, 7),         # S not a block multiple, dh 128
    (2, 32, 1, 1000, 64, 999),      # group 32, padded, pos = S - 1
    (1, 4, 4, 4096, 16, 2500),      # many splits, dh 16
])
def test_flash_decode_kernel_equals_plain(dev, b, hq, hkv, S, dh, pos):
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v = _attn_inputs((b, hq, 1, dh), (b, hkv, S, dh), torch.float32,
                           dev, b + hq + S + dh + pos)
    _kernel_vs_plain(lambda: flash_decode(q, k, v, pos), "flash_decode",
                     ATTN_TOL_F32,
                     _mutated(FD_MOD, "valid_keys",
                              lambda orig: lambda kp, p: kp < p))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    _kernel_vs_plain(lambda: flash_decode(qb, kb, vb, pos), "flash_decode",
                     ATTN_TOL_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,S,dh,pos", [
    (2, 8, 2, 700, 64, -1),        # pos < 0: every key masked, all walked
    (3, 4, 4, 1000, 32, 999),      # g = 1; S no split divides
    (2, 8, 8, 4160, 64, "split"),  # pos on the first key of split 1
    (1, 8, 1, 5000, 128, 4999),    # g = 8: two 4-head groups, dh 128
])
def test_flash_decode_kernel_splits_equal_plain(dev, b, hq, hkv, S, dh, pos):
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode.flash_decode import (
        flash_decode_splits)
    if pos == "split":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        pos = flash_decode_splits(S, b, hkv, sms=sms)[0]
    q, k, v = _attn_inputs((b, hq, 1, dh), (b, hkv, S, dh), torch.float32,
                           dev, b + hq + S + dh)
    mutant = None if pos < 0 else _mutated(
        FD_MOD, "valid_keys", lambda orig: lambda kp, p: kp < p)
    _kernel_vs_plain(lambda: flash_decode(q, k, v, pos), "flash_decode",
                     ATTN_TOL_F32, mutant)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    _kernel_vs_plain(lambda: flash_decode(qb, kb, vb, pos), "flash_decode",
                     ATTN_TOL_BF16)


@pytest.mark.cuda
def test_flash_decode_bf16_mutant_misses_at_a_small_pos(dev):
    """At pos 3 the key at pos carries a quarter of the weight, so the
    ``<`` mutant moves a bf16 output by more than ATTN_TOL_BF16."""
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v = _attn_inputs((8, 32, 1, 64), (8, 8, 4096, 64), torch.bfloat16,
                           dev, 3)
    _kernel_vs_plain(lambda: flash_decode(q, k, v, 3), "flash_decode",
                     ATTN_TOL_BF16,
                     _mutated(FD_MOD, "valid_keys",
                              lambda orig: lambda kp, p: kp < p))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_is_the_same_from_run_to_run(dev, dtype):
    """The block and split combines run in a fixed order (no atomics)."""
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v = _attn_inputs((8, 32, 1, 64), (8, 8, 4096, 64), dtype, dev, 4)
    first = flash_decode(q, k, v, 4095)
    for _ in range(3):
        assert torch.equal(flash_decode(q, k, v, 4095), first)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-7b"])
def test_reduced_lm_flash_forward_on_card_matches_cpu(dev, arch):
    """A reduced LM's prefill with the flash kernel on the card (one launch
    per layer) within 1e-5 of max|logit| of the CPU plain versions under
    fp32 (f32 compute; the projections' sums differ in order too)."""
    from repro_torch.models import transformer
    cfg = reduced(get_config(arch)).replace(
        policy=MatmulPolicy.FP32, compute_dtype="float32",
        use_flash_kernel=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(2),
                                     device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(3))
    want, _ = transformer.forward(params, cfg, {"tokens": tokens})
    build.reset_launches()
    got, _ = transformer.forward(transformer.params_to(params, dev), cfg,
                                 {"tokens": tokens.to(dev)})
    assert build.launch_counts() == {"flash_attention": cfg.n_layers}
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-5, err


# The chunkwise mLSTM kernels against their plain version (the model's
# chunk loop, f32); one counted launch per call (the state walk and the
# outputs).  Both run f32 arithmetic with sums in other orders; the
# plain version is the noisier of the two (on an H100 at 4 x 2048, dh 384
# it lies ~9e-6 of max|y| from an f64 run, the kernel ~3e-6), so the
# kernel is held to max|kernel - plain| <= MLSTM_TOL * max|plain|, which
# the plain version with the causal mask's diagonal dropped, or with the
# state written without the input gate, must miss.  bf16 inputs are cast
# to f32 exactly on both sides and the output is f32, so the same
# tolerance holds.

MLSTM_TOL = 2e-5
SSM_MOD = "repro_torch.models.ssm"


def _mlstm_inputs(b, h, s, dh, dev, seed, strong=False, zero_ig=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, h, s, dh), generator=g)
    k = torch.randn((b, h, s, dh), generator=g) * 0.3
    v = torch.randn((b, h, s, dh), generator=g)
    lf = torch.log(torch.rand((b, h, s), generator=g) * 0.29 + 0.7)
    if strong:      # cumulative decays pass the -60 clip within a chunk
        lf = lf - 5.0
    ig = torch.rand((b, h, s), generator=g) * 0.8 + 0.1
    if zero_ig:
        ig[:, :, ::3] = 0.0
    return [t.to(dev) for t in (q, k, v, lf, ig)]


def _mlstm_vs_plain(run, mutants=()):
    build.reset_launches()
    got = run()
    torch.cuda.synchronize()
    assert build.launch_counts() == {"mlstm_chunk": 1}
    with build.plain_versions():
        want = run()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= MLSTM_TOL, err
    for mutant in mutants:
        with mutant, build.plain_versions():
            bad = run()
        miss = float((got - bad).abs().max() / bad.abs().max())
        assert miss > MLSTM_TOL, miss


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,dh,chunk,kw", [
    (2, 2, 64, 16, 16, {}),
    (1, 4, 128, 32, 64, {}),
    (1, 2, 100, 16, 32, {}),                  # padded
    (2, 1, 32, 64, 8, {}),                    # chunk 8
    (1, 2, 200, 128, 64, {}),                 # padded, dh 128
    (1, 2, 17, 384, 64, {}),                  # s < chunk: one chunk of 17
    (2, 4, 300, 384, 64, {"strong": True}),   # decays past the clip
    (2, 2, 256, 96, 64, {"zero_ig": True}),   # a ragged dv tile, i = 0 rows
    (1, 1, 64, 512, 32, {}),                  # the largest dh
    (1, 3, 416, 80, 32, {}),                  # 13 chunks, dh 64 + 16
    (1, 4, 32768, 32, 64, {}),                # 512 chunks (prefill_32k)
])
def test_mlstm_kernel_equals_plain(dev, b, h, s, dh, chunk, kw):
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    q, k, v, lf, ig = _mlstm_inputs(b, h, s, dh, dev, b + h + s + dh, **kw)
    mutants = (
        _mutated(SSM_MOD, "causal_mask", lambda orig: lambda c, d: torch.tril(
            torch.ones((c, c), dtype=torch.bool, device=d), diagonal=-1)),
        _mutated(SSM_MOD, "state_write_weights",
                 lambda orig: lambda ltot, lcum, i: orig(ltot, lcum,
                                                         torch.ones_like(i))))
    _mlstm_vs_plain(lambda: mlstm_chunk(q, k, v, lf, ig, chunk=chunk),
                    mutants if s > chunk else mutants[:1])
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    _mlstm_vs_plain(lambda: mlstm_chunk(qb, kb, vb, lf, ig, chunk=chunk))


@pytest.mark.cuda
def test_mlstm_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk_raw
    q, k, v, lf, ig = _mlstm_inputs(1, 1, 128, 16, dev, 0)
    with pytest.raises(ValueError, match="chunk <= 64"):
        mlstm_chunk_raw(q, k, v, lf, ig, chunk=128)
    with pytest.raises(ValueError, match="f32 or bf16"):
        mlstm_chunk_raw(q.half(), k.half(), v.half(), lf, ig, chunk=64)
    with pytest.raises(ValueError, match="f32 gates"):
        mlstm_chunk_raw(q, k, v, lf.double(), ig, chunk=64)
    q, k, v, lf, ig = _mlstm_inputs(1, 1, 8, 520, dev, 0)
    with pytest.raises(ValueError, match="dh <= 512"):
        mlstm_chunk_raw(q, k, v, lf, ig, chunk=8)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp32", "kom_int14",
                                    "kom_int14-float_weights"])
def test_reduced_xlstm_on_card_matches_cpu(dev, policy):
    """Reduced xlstm-125m: the forward and four decode steps on the card
    within 1e-5 (fp32) / 2e-3 (kom_int14: an ulp can move a 14-bit level)
    of max|logit| of the CPU plain versions.  ``kom_int14``: the weights
    quantized once, as the serving engine quantizes them.
    ``kom_int14-float_weights``: float weights, so every projection
    quantizes both operands per tensor (``kom_q_dot``), within
    FLOAT_WEIGHTS_TOL; the same forward quantized with
    ``base_bits=6`` on the card must miss it."""
    from repro_torch.analysis.kom_float_weights import base_bits, run_logits
    from repro_torch.models import transformer
    from repro_torch.serving.weight_quant import quantize_params_inline
    float_weights = policy.endswith("float_weights")
    cfg = reduced(get_config("xlstm-125m")).replace(
        policy=MatmulPolicy(policy.split("-")[0]), compute_dtype="float32")
    tol = 1e-5 if policy == "fp32" else \
        FLOAT_WEIGHTS_TOL if float_weights else 2e-3
    params = transformer.init_params(cfg, torch.Generator().manual_seed(2),
                                     device="cpu")
    if policy == "kom_int14":
        params = quantize_params_inline(params)
    gp = transformer.params_to(params, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(3))
    want = run_logits(params, cfg, tokens)
    got = run_logits(gp, cfg, tokens)
    for g, w in zip(got, want):     # the forward, then four decode steps
        assert _rel(g, w) <= tol, _rel(g, w)
    if float_weights:
        with base_bits(6):
            bad = run_logits(gp, cfg, tokens)
        assert max(_rel(g, w) for g, w in zip(bad, want)) > tol
