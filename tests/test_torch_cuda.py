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
import pytest

torch = pytest.importorskip("torch")

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


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [3, 4, 6])
@pytest.mark.parametrize("m,k,n", [(8, 2000, 300), (1, 37, 33),
                                   (37, 129, 65), (16, 4096, 1000)])
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
