"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

The CUDA kernels have no interpret mode, so every test here is marked
``cuda`` and skips without an NVIDIA GPU.  On a machine with one (and
``nvcc``), run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``:
this file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.  Tolerance 0: the kernels and the plain versions
compute the same integers and the same f32 roundings.
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
